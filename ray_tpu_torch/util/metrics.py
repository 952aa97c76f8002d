"""User-defined metrics: Counter / Gauge / Histogram.

Role parity: python/ray/util/metrics.py (Cython metric.pxi + OpenCensus
export behind it). Metrics register in a per-process registry; a background
flusher ships them to the conductor KV under the "metrics" namespace, and
``prometheus_text()`` renders the cluster-wide scrape payload (the role of
the per-node MetricsAgent -> Prometheus pipeline,
_private/metrics_agent.py:375).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

_registry: Dict[str, "Metric"] = {}
_registry_lock = threading.Lock()
_flusher_started = False
_node_hex = ""   # set by events.configure; disambiguates the KV key


def set_node(node_hex: str) -> None:
    """Bind this process's metrics snapshots to a node identity. The KV
    key must be unique per (node, pid): two workers on different nodes
    can share an OS pid, and a bare ``proc-{pid}`` key made them
    overwrite each other's snapshots."""
    global _node_hex
    _node_hex = node_hex


def _kv_key() -> bytes:
    return f"proc-{_node_hex}-{os.getpid()}".encode()


_builtin_lock = threading.Lock()

# Canonical registry of built-in runtime metric names (the ``rt_`` prefix
# is reserved). ``builtin()`` refuses unminted rt_* names, and rtcheck's
# name-drift checker enforces the same invariant statically: every rt_*
# literal in the tree must appear here, and every entry here must be
# referenced somewhere outside this module.
METRICS: Dict[str, str] = {
    # task plane
    "rt_tasks_submitted_total": "tasks submitted by this driver",
    "rt_tasks_executed_total": "tasks executed by this worker",
    "rt_task_exec_s": "task execution wall time",
    "rt_task_replies_total": "task replies observed by the driver",
    "rt_task_retries_total": "task retries scheduled after failures",
    "rt_lease_latency_s": "worker-lease grant latency",
    "rt_actor_push_window": "actor ordered-push window occupancy",
    # rpc plane
    "rt_rpc_frame_latency_s": "rpc frame round-trip latency",
    "rt_rpc_frames_total": "rpc frames sent",
    "rt_rpc_frame_bytes_total": "rpc frame payload bytes",
    "rt_rpc_inflight": "rpc requests currently in flight",
    "rt_rpc_channels": "open rpc channels in this process",
    # object plane
    "rt_pull_windows_total": "pull windows granted",
    "rt_pull_bytes_total": "bytes fetched by pulls",
    "rt_pull_failovers_total": "pull chunk failovers to another source",
    "rt_pull_shm_direct_total": "pulls satisfied shm-direct (same host)",
    "rt_pull_inflight_bytes": "bytes currently in flight across pulls",
    "rt_pull_budget_waiters": "pulls waiting on the inflight budget",
    "rt_push_bytes_total": "bytes pushed by the push manager",
    "rt_put_backpressure_total": "puts delayed by store backpressure",
    "rt_inline_cache_hits_total": "inline (small-object) cache hits",
    "rt_inline_cache_misses_total": "inline cache misses",
    "rt_inline_cache_entries": "inline cache entries resident",
    "rt_inline_cache_bytes": "inline cache bytes resident",
    "rt_inline_pending_returns": "inline returns awaiting seal",
    "rt_inline_seals_total": "inline returns sealed",
    "rt_location_batch_backlog": "location-update batches queued",
    # device-native array objects (r16)
    "rt_array_puts_total": "array objects stored via the zero-copy path",
    "rt_array_put_bytes_total": "bytes stored via the array fast path",
    "rt_array_pins_live": "read-only array views pinning shm mappings",
    "rt_bcast_total": "collective-backed object broadcasts completed",
    "rt_bcast_legs_total": "broadcast tree legs completed",
    "rt_bcast_bytes_total": "bytes moved by broadcast tree legs",
    "rt_bcast_fallback_total": "broadcast members re-striped onto the "
                               "classic pull path",
    # spill / evict tier
    "rt_spill_objects_total": "primaries spilled to the durable tier",
    "rt_spill_bytes_total": "bytes spilled to the durable tier",
    "rt_spill_restores_total": "objects restored from spill",
    "rt_spill_restore_bytes_total": "bytes restored from spill",
    "rt_spill_restored_objects": "objects currently restored from spill",
    "rt_spill_restored_bytes": "bytes currently restored from spill",
    "rt_evict_objects_total": "shm copies evicted after spill",
    "rt_evict_bytes_total": "shm bytes evicted after spill",
    # compiled graphs
    "rt_cgraph_executes_total": "compiled-graph executions",
    "rt_cgraph_slot_writes_total": "compiled-graph channel slot writes",
    "rt_cgraph_slot_write_s": "channel slot write latency",
    "rt_cgraph_slot_wait_s": "channel slot wait (reader blocked)",
    # train pipeline
    "rt_pipeline_steps_total": "pipeline steps completed",
    "rt_pipeline_stage_ops_total": "pipeline stage ops executed",
    "rt_pipeline_stage_op_s": "pipeline stage op wall time",
    "rt_pipeline_efficiency": "pipeline efficiency (busy/total)",
    # serve ingress
    "rt_serve_requests_total": "serve requests admitted",
    "rt_serve_request_s": "serve request end-to-end latency",
    "rt_serve_shed_total": "serve requests shed (503)",
    "rt_serve_timeout_total": "serve requests timed out",
    "rt_serve_retries_total": "serve handle retries",
    "rt_serve_drains_total": "replica graceful drains",
    "rt_serve_batch_size": "adaptive-batch flush size",
    "rt_serve_batch_window_ms": "adaptive-batch window",
    "rt_serve_p99_ms": "proxy-observed p99 latency",
    "rt_serve_queued": "proxy requests queued",
    "rt_serve_ongoing": "proxy requests ongoing",
    "rt_serve_replica_ongoing": "per-replica ongoing requests",
    # infrastructure
    "rt_faults_fired_total": "fault-plane rules fired",
    "rt_events_dropped_total": "flight-recorder events dropped",
    # lock sanitizer
    "rt_lock_cycles_total": "lock-order cycles detected by lockcheck",
    "rt_lock_long_holds_total": "lock holds past lockcheck_hold_s",
}


def builtin(cls, name: str, description: str = "", **kwargs) -> "Metric":
    """Get-or-create a built-in runtime metric by name (the flight
    recorder folds ring events into these off the hot path). rt_* names
    must be minted in ``METRICS`` — drift between emit sites and the
    registry is exactly what this and rtcheck's name-drift pass catch."""
    m = _registry.get(name)
    if m is None:
        if name.startswith("rt_") and name not in METRICS:
            raise ValueError(
                f"built-in metric {name!r} is not minted in "
                f"metrics.METRICS (rt_* names are reserved)")
        with _builtin_lock:
            m = _registry.get(name)
            if m is None:
                m = cls(name, description or METRICS.get(name, ""),
                        **kwargs)
    return m


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        if not name.replace("_", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry[name] = self
        _ensure_flusher()

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _tag_tuple(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return tuple((k, merged.get(k, "")) for k in self.tag_keys)

    def _points(self) -> List[Tuple[Tuple, float]]:
        with self._lock:
            return list(self._values.items())

    kind = "gauge"


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        key = self._tag_tuple(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._tag_tuple(tags)] = float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1, 10, 100])
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = self._tag_tuple(tags)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            idx = len(self.boundaries)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    idx = i
                    break
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._values[key] = value  # last observation (gauge view)

    def _hist_points(self):
        with self._lock:
            return ({k: list(v) for k, v in self._counts.items()},
                    dict(self._sums))


def _snapshot() -> dict:
    out = {}
    with _registry_lock:
        metrics = list(_registry.values())
    for m in metrics:
        entry = {"kind": m.kind, "description": m.description,
                 "points": [(list(k), v) for k, v in m._points()]}
        if isinstance(m, Histogram):
            counts, sums = m._hist_points()
            # Keep the tag tuples structured (not stringified): the
            # exposition renderer needs them back as label pairs.
            entry["histogram"] = {
                "boundaries": m.boundaries,
                "series": [(list(k), v, sums.get(k, 0.0))
                           for k, v in counts.items()],
            }
        out[m.name] = entry
    return out


def _flush_once() -> None:
    import pickle
    try:
        from ray_tpu_torch.core.api import _global_runtime, is_initialized
        if not is_initialized():
            return
        rt = _global_runtime()
        conductor = getattr(rt, "conductor", None)
        if conductor is None:
            return
        conductor.call("kv_put", ns="metrics", key=_kv_key(),
                       value=pickle.dumps(_snapshot(), protocol=5))
    except Exception:
        pass


def _ensure_flusher() -> None:
    global _flusher_started
    if _flusher_started:
        return
    _flusher_started = True

    def loop():
        from ray_tpu_torch import config
        while True:
            time.sleep(config.get("metrics_export_period_s"))
            _flush_once()

    threading.Thread(target=loop, daemon=True, name="metrics-flush").start()


def prometheus_text() -> str:
    """Render every process's shipped metrics in Prometheus exposition
    format (scrape endpoint payload)."""
    import pickle
    from ray_tpu_torch.core.api import _global_runtime
    rt = _global_runtime()
    conductor = rt.conductor
    _flush_once()
    lines: List[str] = []
    seen_help = set()
    for key in conductor.call("kv_keys", ns="metrics"):
        blob = conductor.call("kv_get", ns="metrics", key=key)
        if blob is None:
            continue
        snap = pickle.loads(blob)
        for name, entry in snap.items():
            if name not in seen_help:
                lines.append(f"# HELP {name} {entry['description']}")
                lines.append(f"# TYPE {name} {entry['kind']}")
                seen_help.add(name)
            hist = entry.get("histogram")
            if hist and "series" in hist:
                # Proper histogram exposition: cumulative _bucket lines
                # per le boundary (+Inf last), then _sum and _count —
                # the last-observation gauge view is NOT rendered (one
                # name must expose one type).
                bounds = hist["boundaries"]
                for tags, counts, total in hist["series"]:
                    base = [f'{k}="{v}"' for k, v in tags]
                    cum = 0
                    for b, c in zip(list(bounds) + ["+Inf"], counts):
                        cum += c
                        label = ",".join(base + [f'le="{b}"'])
                        lines.append(f'{name}_bucket{{{label}}} {cum}')
                    label = "{" + ",".join(base) + "}" if base else ""
                    lines.append(f"{name}_sum{label} {total}")
                    lines.append(f"{name}_count{label} {cum}")
                continue
            for tags, value in entry["points"]:
                label = ",".join(f'{k}="{v}"' for k, v in tags)
                label = "{" + label + "}" if label else ""
                lines.append(f"{name}{label} {value}")
    return "\n".join(lines) + "\n"
