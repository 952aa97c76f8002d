"""Scheduling strategies (parity: python/ray/util/scheduling_strategies.py:15).
Ported from ``ray_tpu/util/scheduling_strategies.py``.

The cluster runtime reads these by their fields
(``ClusterRuntime._strategy_dict``): a placement group's id and bundle
index, or a node id. The JAX package's ``SliceSchedulingStrategy`` is not
carried over: the port has no slice placement (ROADMAP.md C).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "PlacementGroup"  # noqa: F821
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False
