"""State API implementation over the conductor tables. Ported from
``ray_tpu/state/api.py``: it needs a runtime that holds a conductor
connection (``init()`` or ``init(address=...)``), and raises
``RuntimeError`` on the in-process runtime and on a ``client://`` one."""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional


def _conductor():
    from ray_tpu_torch.core.api import _global_runtime
    rt = _global_runtime()
    conductor = getattr(rt, "conductor", None)
    if conductor is None:
        raise RuntimeError("state API requires the cluster runtime (the "
                           "in-process runtime keeps no cluster tables, and "
                           "a client:// driver holds no conductor "
                           "connection)")
    return conductor


def node_rows(conductor) -> List[dict]:
    """The node table over a conductor client (``list_nodes`` and the
    dashboard's ``/api/nodes``)."""
    return [{
        "node_id": n["node_id"].hex(),
        "state": "ALIVE" if n["alive"] else "DEAD",
        "is_head_node": n["is_head"],
        "resources_total": n["resources_total"],
        "resources_available": n["resources_available"],
        "address": n["address"],
    } for n in conductor.call("get_nodes")]


def list_nodes() -> List[dict]:
    return node_rows(_conductor())


def list_actors(state: Optional[str] = None) -> List[dict]:
    out = _conductor().call("list_actors")
    if state:
        out = [a for a in out if a["state"] == state]
    return out


def list_tasks(limit: int = 1000) -> List[dict]:
    events = _conductor().call("get_task_events")
    return [{
        "task_id": e["task_id"], "name": e["name"], "type": e["kind"],
        "state": "FAILED" if e["error"] else "FINISHED",
        "start_time_s": e["start"], "end_time_s": e["end"],
        "duration_s": e["end"] - e["start"],
        "node_id": e["node_id"], "worker_pid": e["pid"],
        "error_message": e["error"],
    } for e in events[-limit:]]


def store_rows(conductor) -> List[dict]:
    """Each live node's store stats over a conductor client."""
    from ray_tpu_torch.cluster.protocol import get_client
    out = []
    for n in conductor.call("get_nodes"):
        if not n["alive"]:
            continue
        try:
            stats = get_client(n["address"]).call("store_stats")
        except Exception:
            continue
        out.append({"node_id": n["node_id"].hex(), **stats})
    return out


def list_objects() -> List[dict]:
    """Per-node store contents (store stats + object list via daemons)."""
    return store_rows(_conductor())


def list_placement_groups() -> List[dict]:
    return _conductor().call("list_placement_groups")


def summarize_tasks() -> Dict[str, dict]:
    """Group task events by name (parity: `ray summary tasks`)."""
    events = _conductor().call("get_task_events")
    agg: Dict[str, dict] = defaultdict(
        lambda: {"count": 0, "failed": 0, "total_time_s": 0.0})
    for e in events:
        row = agg[e["name"]]
        row["count"] += 1
        row["failed"] += 1 if e["error"] else 0
        row["total_time_s"] += e["end"] - e["start"]
    for row in agg.values():
        row["mean_time_s"] = row["total_time_s"] / max(1, row["count"])
    return dict(agg)


def list_cluster_events(limit: int = 1000, source: Optional[str] = None,
                        severity: Optional[str] = None,
                        event_type: Optional[str] = None) -> List[dict]:
    """Structured cluster events (parity: `ray list cluster-events` /
    dashboard ClusterEvents): node membership, actor FSM transitions, OOM
    kills, job state changes."""
    return _conductor().call("list_events", limit=limit, source=source,
                             severity=severity, event_type=event_type)


def list_spans(trace_id: Optional[str] = None) -> List[dict]:
    """Task-path spans (util/tracing.py; enable with
    _system_config={"tracing_enabled": True}). Parity role:
    util/tracing/tracing_helper.py span export."""
    return _conductor().call("get_spans", trace_id=trace_id)


def profile_on(conductor, pid: int, duration_s: float = 1.0,
               interval_s: float = 0.01,
               node_id: Optional[str] = None) -> Optional[str]:
    """The collapsed stacks of the worker with this pid over a conductor
    client, or None when no live node (whose id starts with ``node_id``)
    has it."""
    from ray_tpu_torch.cluster.protocol import get_client
    for n in conductor.call("get_nodes"):
        if not n["alive"]:
            continue
        if node_id and not n["node_id"].hex().startswith(node_id):
            continue
        try:
            dump = get_client(n["address"]).call(
                "profile_worker", pid=pid, duration_s=duration_s,
                interval_s=interval_s, _timeout=duration_s + 60.0)
        except Exception:
            continue
        if dump is not None:
            return dump
    return None


def profile_worker(pid: int, duration_s: float = 1.0,
                   interval_s: float = 0.01,
                   node_id: Optional[str] = None) -> str:
    """Sample a worker's Python stacks anywhere in the cluster ->
    collapsed-stack text (flamegraph.pl / speedscope input). Parity:
    `ray stack` / the dashboard's py-spy trigger. ``node_id`` (hex
    prefix) scopes the probe to one node — pids are per-host."""
    dump = profile_on(_conductor(), pid, duration_s, interval_s, node_id)
    if dump is None:
        where = f" on node {node_id}" if node_id else " in the cluster"
        raise ValueError(f"no live worker with pid {pid}{where}")
    return dump


def list_ring_events(limit: int = 0, kind: Optional[str] = None
                     ) -> List[dict]:
    """Flight-recorder events shipped to the conductor's ring store
    (util/events.py). ``kind`` filters by exact kind or dotted prefix
    ("pull" matches "pull.chunk"). Parity role: `ray list task-events`
    over GcsTaskManager's buffered task events."""
    return _conductor().call("get_ring_events", limit=limit, kind=kind)


def debug_state() -> dict:
    """Cluster-wide debug-state dump: the conductor's table sizes plus
    every live node daemon's (raylet debug_state.txt parity, one JSON
    document instead of per-node text files)."""
    return debug_rows(_conductor())


def debug_rows(conductor) -> dict:
    """``debug_state`` over a conductor client."""
    from ray_tpu_torch.cluster.protocol import get_client
    out = {"conductor": conductor.call("debug_state"), "nodes": {}}
    for n in conductor.call("get_nodes"):
        if not n["alive"]:
            continue
        hexid = n["node_id"].hex()
        try:
            out["nodes"][hexid] = get_client(
                n["address"]).call("debug_state")
        except Exception as e:  # noqa: BLE001 - per-node best effort
            out["nodes"][hexid] = {"error": repr(e)}
    return out
