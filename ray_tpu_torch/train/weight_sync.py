"""Learner -> workers weight broadcast over the object plane. Ported from
``ray_tpu/train/weight_sync.py``.

Role parity: python/ray/util/collective broadcast used by Train/RLlib for
weight sync: the learner publishes one weight object and a broadcast tree
moves it to every worker host, instead of each worker pulling its own copy
through the learner's NIC (N serial transfers for N workers).

``broadcast_to_actors`` puts the value once, then pre-places the object on
every distinct node hosting a consumer actor through
``ObjectPlane.broadcast_object`` (rounds of coordinated pulls, each fresh
holder serving the next wave). Consumers ``rt.get`` the returned ref and
hit their LOCAL store.

Everything here is best-effort: a failed (or skipped) broadcast leaves
consumers on the directory-driven pull path: slower, never wrong. A tensor
goes through the store on the host (ROADMAP.md C, "Tensors across
processes come back on the host").
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional

logger = logging.getLogger(__name__)


def member_nodes(actors, conductor, timeout: float = 30.0) -> List[dict]:
    """Distinct live nodes hosting ``actors``, as broadcast member
    descriptors ({"node_id", "address"} of each node's daemon)."""
    infos = conductor.call(
        "get_actor_infos",
        actor_ids=[a.actor_id.binary() for a in actors],
        wait_alive_timeout=timeout)
    node_ids = {i["node_id"] for i in infos if i.get("node_id")}
    return [{"node_id": n["node_id"], "address": n["address"]}
            for n in conductor.call("get_nodes")
            if n.get("alive") and n["node_id"] in node_ids]


def broadcast_to_actors(value: Any, actors, timeout: float = 30.0):
    """Put ``value`` once and pre-place it on every node hosting one of
    ``actors``; returns the ObjectRef to pass to the consumers. The
    transfer rides the object plane's broadcast tree on the cluster
    runtime; on the in-process runtime the ref alone is returned (every
    consumer shares its store)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.api import _global_runtime

    ref = rt.put(value)
    runtime = _global_runtime()
    plane = getattr(runtime, "plane", None)
    conductor = getattr(runtime, "conductor", None)
    if plane is None or conductor is None or not actors:
        return ref
    try:
        members = member_nodes(actors, conductor, timeout=timeout)
        if members:
            plane.broadcast_object(ref.id, members)
    except Exception:  # noqa: BLE001 - pre-placement only, never fatal
        logger.warning("weight broadcast pre-placement failed; consumers "
                       "fall back to on-demand pulls", exc_info=True)
    return ref


def fetch_weights(ref, timeout: Optional[float] = 60.0):
    """Consumer-side half: resolve a broadcast ref to its value from the
    local store (``rt.get``)."""
    import ray_tpu_torch as rt
    return rt.get(ref, timeout=timeout)
