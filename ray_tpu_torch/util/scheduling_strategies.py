"""Scheduling strategies (parity: python/ray/util/scheduling_strategies.py:15).
Ported from ``ray_tpu/util/scheduling_strategies.py``.

The cluster runtime reads these by their fields
(``ClusterRuntime._strategy_dict``): a placement group's id and bundle
index, a node id, or a domain topology. ``SliceSchedulingStrategy`` keeps
the JAX name; here it pins a task or an actor to the hosts of one NVLink
domain (``gpu/topology.py``), where the JAX one pins to a TPU ICI slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "PlacementGroup"  # noqa: F821
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclass
class SliceSchedulingStrategy:
    """Gang-place onto one NVLink domain: every bundle of the backing
    placement group maps to hosts of the same domain, so the NCCL
    program's collectives ride NVLink, not the network."""
    topology: str = ""              # e.g. "h100-8"; "" = any domain
    placement_group: Optional["PlacementGroup"] = None  # noqa: F821
    placement_group_bundle_index: int = -1
