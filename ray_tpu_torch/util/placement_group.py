"""Placement groups (parity: python/ray/util/placement_group.py:33/:136).
Ported from ``ray_tpu/util/placement_group.py``.

Bundles are reserved across node daemons with 2PC prepare/commit
(``cluster/conductor.py``, reference gcs_placement_group_scheduler.h:265),
through ``ClusterRuntime.create_placement_group``, ``pg_ready`` and
``remove_placement_group``. A bundle may hold ``"GPU"``: a worker placed in
it leases whole cards or shares of one as any other (``num_gpus``).

Where the port differs from the JAX module: the strategies are ``PACK``,
``SPREAD``, ``STRICT_PACK`` and ``STRICT_SPREAD``. ``"SLICE"`` (and its
``slice_topology``) gang-places on the hosts of one TPU ICI slice; the port
has no slice placement, so it raises ``ValueError``. Placement groups need
the cluster runtime (``init(address=...)``): the in-process runtime has no
bundles to reserve, and ``placement_group`` raises ``ValueError`` there.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.exceptions import GetTimeoutError
from ray_tpu_torch.core.ids import PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[Dict[str, float]], strategy: str,
                 name: str = ""):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy
        self.name = name

    def ready(self, timeout: Optional[float] = None):
        """Block until all bundles are reserved; returns self (the reference
        returns an ObjectRef; here readiness is a control-plane wait)."""
        rt = _cluster_runtime()
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = 5.0 if deadline is None else max(
                0.0, deadline - time.monotonic())
            info = rt.pg_ready(self.id.binary(), timeout=min(step, 5.0))
            if info["state"] == "CREATED":
                return self
            if deadline is not None and time.monotonic() >= deadline:
                raise GetTimeoutError(
                    f"placement group {self.id.hex()} not ready "
                    f"(state={info['state']})")

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        try:
            self.ready(timeout=timeout_seconds)
            return True
        except GetTimeoutError:
            return False

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundle_specs, self.strategy,
                                 self.name))


def _cluster_runtime():
    from ray_tpu_torch.core.api import _global_runtime
    rt = _global_runtime()
    if not hasattr(rt, "create_placement_group"):
        raise ValueError(
            "placement groups need the cluster runtime: start it with "
            "ray_tpu_torch.init(address=...) (the in-process runtime has no "
            "bundles to reserve)")
    return rt


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK", name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    """Reserve bundles across the cluster under ``strategy``."""
    if strategy == "SLICE":
        raise ValueError(
            "strategy 'SLICE' places a gang on one TPU ICI slice; the port "
            "has no slice placement (use PACK, SPREAD, STRICT_PACK or "
            "STRICT_SPREAD)")
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy!r}; "
                         f"one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty "
                         "resource dicts")
    for b in bundles:
        if any(v < 0 for v in b.values()):
            raise ValueError("bundle resources must be non-negative")
    rt = _cluster_runtime()
    pg_id = PlacementGroupID.from_random()
    rt.create_placement_group(pg_id.binary(), bundles, strategy, name)
    return PlacementGroup(pg_id, bundles, strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    _cluster_runtime().remove_placement_group(pg.id.binary())


def placement_group_table() -> List[dict]:
    return _cluster_runtime().conductor.call("list_placement_groups")
