"""Flight-recorder event ring: near-free lifecycle events on every plane.

Role parity: task_event_buffer.h:188 (bounded, buffered, asynchronously
shipped task events) + profile_event.h (compact per-process profile
events merged into one cluster timeline). Every plane calls

    events.emit("pull.chunk", ident=oid_hex, value=nbytes)

and pays one cached-flag check, a tuple build, and a ring-slot store —
no RPC, no allocation growth (the ring is preallocated and overwrites
the oldest entry when full, counting what it dropped). A background
flusher ships ring deltas — and any buffered tracing spans — to the
conductor in batches, so NOTHING on the submit/execute/pull hot paths
performs a synchronous conductor RPC (the pre-r10 ``tracing.flush``
calls did exactly that and halved the task fast path when enabled).
Processes that already run a periodic conductor RPC (the node daemon's
heartbeat) piggyback their delta on it via ``heartbeat_payload()``
instead of paying a second connection.

Event shape (a plain tuple — cheapest thing that pickles):

    (ts, kind, ident, value, attrs)

``kind`` is a dotted event name ("task.submit", "rpc.frame", ...),
``ident`` an optional correlation id (task id hex, object id hex),
``value`` a number whose meaning the kind fixes (latency seconds,
bytes, window occupancy), ``attrs`` an optional small dict.

On top of the ring:

- the flusher folds drained events into the built-in per-plane metrics
  registry (util/metrics.py) — counters/histograms update in batch off
  the hot path (metrics_agent role);
- ``register_probe`` lets planes expose point-in-time gauges (RPC
  in-flight, cache sizes) sampled once per flush instead of per call;
- a slow-op watchdog (``watch_begin``/``watch_end``) reports any
  task/pull/RPC outliving ``slow_op_threshold_s`` to the conductor as
  a structured cluster event carrying the surrounding ring context.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch import config

# Canonical registry of flight-recorder event kinds: every
# ``emit("…")`` literal in the tree must be minted here (rtcheck's
# name-drift checker enforces both directions; ``test.*`` kinds used by
# the test suite live outside the scanned tree). The doc states what
# ``value`` means for the kind.
EVENT_KINDS: Dict[str, str] = {
    # task plane
    "task.submit": "value unused; ident = task id",
    "task.exec": "value = execution seconds",
    "task.reply": "value = end-to-end seconds",
    "task.retry": "value = retries remaining",
    "lease.grant": "value = lease latency seconds",
    "actor.window": "value = ordered-push window occupancy",
    "inline.seal": "value = sealed inline bytes",
    # rpc plane
    "rpc.frame": "value = frame round-trip seconds; attrs carry bytes",
    # object plane
    "pull.window": "value = window bytes granted",
    "pull.chunk": "value = chunk bytes fetched",
    "pull.done": "value = total pulled bytes",
    "pull.failover": "value = failed-source ordinal",
    "pull.shm_direct": "value = bytes served shm-direct",
    "push.chunk": "value = chunk bytes pushed",
    "object.put.backpressure": "value = delay seconds",
    "inline.hit": "value = inline bytes served from cache",
    "inline.miss": "value unused; ident = object id",
    # device-native array objects (r16)
    "object.array.put": "value = array blob bytes stored zero-copy",
    "object.bcast.leg": "value = bytes moved by one broadcast tree leg",
    "object.bcast.done": "value = broadcast seconds; attrs carry "
                         "members/bytes/fallback",
    "object.bcast.fallback": "value = members re-striped onto the "
                             "classic pull path",
    # spill / evict tier
    "object.spill.write": "value = bytes spilled",
    "object.spill.restore": "value = bytes restored",
    "object.evict": "value = shm bytes evicted",
    # compiled graphs
    "cgraph.execute": "value = execution seconds",
    "cgraph.slot.write": "value = slot write seconds",
    "cgraph.slot.wait": "value = reader-blocked seconds",
    "pipeline.stage.op": "value = stage op seconds",
    "pipeline.step": "value = step seconds",
    # serve ingress
    "serve.request": "value = request seconds",
    "serve.shed": "value unused; attrs carry reason",
    "serve.timeout": "value = deadline seconds",
    "serve.retry": "value = attempt ordinal",
    "serve.drain": "value = drained ongoing count",
    "serve.batch.flush": "value = batch size; attrs carry window",
    # infrastructure
    "fault.fired": "value unused; ident = site, attrs carry action",
    "lock.cycle": "value unused; attrs carry the lock cycle",
    "lock.long_hold": "value = hold seconds; ident = lock name",
}

_lock = threading.Lock()
_buf: List[Any] = []
_cap = 0
_seq = 0          # next write position (monotonic over process life)
_cursor = 0       # first event not yet shipped
_dropped = 0      # overwritten-before-shipping count

_enabled_gen: Optional[int] = None
_enabled_v = False

_node_hex = ""
_conductor_addr: Optional[str] = None
_flusher: Optional[threading.Thread] = None
_flusher_lock = threading.Lock()
_flush_stop = threading.Event()

# Drained-but-unacked delta: drain() advances the cursor before the ship
# RPC, so a failed push must park its events here for the next tick or a
# busy conductor silently loses them (metrics are folded exactly once, on
# the first attempt).
_ship_lock = threading.Lock()
_unshipped: List[tuple] = []
_unshipped_dropped = 0

# slow-op watchdog: token -> (kind, ident, start_ts)
_watch_lock = threading.Lock()
_watch: Dict[int, Tuple[str, Optional[str], float]] = {}
_watch_next = 0
_watch_reported: set = set()

# point-in-time gauge probes: name -> fn() -> {metric_name: value}
_probes: Dict[str, Callable[[], Dict[str, float]]] = {}

# in-flight op scans for the watchdog: name -> fn() -> [(kind, ident,
# elapsed_s)]. Planes that already track their in-flight work (the
# pipelined RPC channels' meta sidecars) expose it here instead of
# paying per-op watch_begin/watch_end registration.
_inflight_scans: Dict[str, Callable[[], List[tuple]]] = {}
_scan_reported: set = set()


def enabled() -> bool:
    """Cached flag read (config.get walks os.environ — too hot for a
    per-event call; same pattern as tracing.enabled)."""
    global _enabled_gen, _enabled_v
    if _enabled_gen != config.generation:
        _refresh()
    return _enabled_v


def _refresh() -> None:
    global _enabled_gen, _enabled_v, _buf, _cap
    _enabled_v = bool(config.get("events_enabled"))
    _enabled_gen = config.generation
    if _enabled_v and not _cap:
        with _lock:
            if not _cap:
                cap = max(64, int(config.get("event_ring_size")))
                _buf = [None] * cap
                _cap = cap


def emit(kind: str, ident: Optional[str] = None, value: float = 0.0,
         attrs: Optional[dict] = None) -> None:
    """Append one event to the ring. O(1), never blocks on I/O."""
    if not enabled():
        return
    global _seq
    ev = (time.time(), kind, ident, value, attrs)
    with _lock:
        _buf[_seq % _cap] = ev
        _seq += 1


def snapshot(limit: int = 0) -> List[tuple]:
    """Current ring contents, oldest first (debug dumps / watchdog
    context). Does not move the flush cursor."""
    with _lock:
        if not _cap or _seq == 0:
            return []
        start = max(0, _seq - _cap)
        evs = [_buf[i % _cap] for i in range(start, _seq)]
    return evs[-limit:] if limit and limit < len(evs) else evs


def drain() -> Tuple[List[tuple], int]:
    """Events appended since the last drain (oldest first) plus how many
    were overwritten before they could ship."""
    global _cursor, _dropped
    with _lock:
        if not _cap:
            return [], 0
        end = _seq
        start = _cursor
        if end - start > _cap:
            _dropped += (end - _cap) - start
            start = end - _cap
        evs = [_buf[i % _cap] for i in range(start, end)]
        _cursor = end
        d, _dropped = _dropped, 0
    return evs, d


# ----------------------------------------------------------------------
# slow-op watchdog
# ----------------------------------------------------------------------
def watch_begin(kind: str, ident: Optional[str] = None) -> Optional[int]:
    """Register an in-flight op with the watchdog. Returns a token for
    watch_end, or None when events are disabled (watch_end(None) is a
    no-op, so call sites need no branching)."""
    if not enabled():
        return None
    global _watch_next
    with _watch_lock:
        token = _watch_next
        _watch_next += 1
        _watch[token] = (kind, ident, time.time())
    return token


def watch_end(token: Optional[int]) -> None:
    if token is None:
        return
    with _watch_lock:
        _watch.pop(token, None)
        _watch_reported.discard(token)


def _check_slow_ops(cli) -> None:
    thr = float(config.get("slow_op_threshold_s"))
    if thr <= 0:
        return
    now = time.time()
    with _watch_lock:
        slow = [(tok, k, i, now - t0)
                for tok, (k, i, t0) in _watch.items()
                if now - t0 > thr and tok not in _watch_reported]
        for tok, *_ in slow:
            _watch_reported.add(tok)
    # Registration-free ops (RPC frames): scan, dedup on approximate
    # start time (the same stuck op reports once across sweeps), prune
    # keys whose op finished.
    live = set()
    for fn in list(_inflight_scans.values()):
        try:
            for kind, ident, elapsed in fn():
                key = (kind, ident, round(now - elapsed, 1))
                live.add(key)
                if elapsed > thr and key not in _scan_reported:
                    _scan_reported.add(key)
                    slow.append((key, kind, ident, elapsed))
        except Exception:
            pass
    _scan_reported.intersection_update(live)
    for tok, kind, ident, elapsed in slow:
        try:
            cli.call(
                "report_event", severity="WARNING",
                source=f"events-{_node_hex[:8]}-{os.getpid()}",
                event_type="SLOW_OPERATION",
                message=f"{kind} {ident or ''} in flight for "
                        f"{elapsed:.1f}s (> {thr}s)",
                metadata={"kind": kind, "ident": ident,
                          "elapsed_s": round(elapsed, 3),
                          "pid": os.getpid(),
                          "ring_tail": snapshot(limit=50)})
        except Exception:
            if isinstance(tok, int):
                with _watch_lock:
                    _watch_reported.discard(tok)  # retry next sweep
            else:
                _scan_reported.discard(tok)


# ----------------------------------------------------------------------
# gauge probes (sampled once per flush, zero hot-path cost)
# ----------------------------------------------------------------------
def register_probe(name: str,
                   fn: Callable[[], Dict[str, float]]) -> None:
    """Register a callable returning {metric_name: value} gauges,
    sampled by the flusher (RPC in-flight, cache sizes, store usage)."""
    _probes[name] = fn


def unregister_probe(name: str,
                     fn: Optional[Callable[[], Dict[str, float]]] = None
                     ) -> None:
    """Drop the probe registered under ``name`` (only if it is ``fn``,
    when given): a closed owner must not be sampled, nor kept alive."""
    if fn is None or _probes.get(name) == fn:
        _probes.pop(name, None)


def register_inflight_scan(name: str,
                           fn: Callable[[], List[tuple]]) -> None:
    """Register a callable returning [(kind, ident, elapsed_s)] for ops
    currently in flight. The watchdog sweeps these alongside
    watch_begin-registered ops — the zero-hot-path-cost alternative for
    planes that already track their outstanding work."""
    _inflight_scans[name] = fn


def _sample_probes() -> None:
    from ray_tpu_torch.util import metrics as _metrics
    for fn in list(_probes.values()):
        try:
            for name, value in fn().items():
                _metrics.builtin(_metrics.Gauge, name).set(value)
        except Exception:
            pass


# ----------------------------------------------------------------------
# event -> built-in metrics folding (runs in the flusher, not inline)
# ----------------------------------------------------------------------
def _fold_metrics(evs: List[tuple], dropped: int) -> None:
    from ray_tpu_torch.util import metrics as m
    C, H = m.Counter, m.Histogram
    for ev in evs:
        kind, value, attrs = ev[1], ev[3], ev[4]
        if kind == "task.submit":
            m.builtin(C, "rt_tasks_submitted_total").inc()
        elif kind == "task.exec":
            m.builtin(C, "rt_tasks_executed_total").inc()
            m.builtin(H, "rt_task_exec_s").observe(value)
        elif kind == "task.reply":
            m.builtin(C, "rt_task_replies_total").inc()
        elif kind == "task.retry":
            m.builtin(C, "rt_task_retries_total").inc()
        elif kind == "lease.grant":
            m.builtin(H, "rt_lease_latency_s",
                      boundaries=[0.001, 0.005, 0.02, 0.1, 0.5, 2, 10]
                      ).observe(value)
        elif kind == "rpc.frame":
            # One event covers attrs["frames"] frames (channel-side
            # aggregation); value is the triggering frame's latency.
            a = attrs or {}
            t = a.get("transport", "")
            m.builtin(H, "rt_rpc_frame_latency_s", tag_keys=("transport",),
                      boundaries=[0.0002, 0.001, 0.005, 0.02, 0.1, 1]
                      ).observe(value, tags={"transport": t})
            m.builtin(C, "rt_rpc_frames_total",
                      tag_keys=("transport",)).inc(
                a.get("frames", 1), tags={"transport": t})
            m.builtin(C, "rt_rpc_frame_bytes_total",
                      tag_keys=("transport",)).inc(
                a.get("bytes", 0), tags={"transport": t})
        elif kind == "pull.window":
            m.builtin(C, "rt_pull_windows_total").inc()
        elif kind == "pull.chunk":
            m.builtin(C, "rt_pull_bytes_total").inc(value)
        elif kind == "pull.failover":
            m.builtin(C, "rt_pull_failovers_total").inc()
        elif kind == "pull.shm_direct":
            m.builtin(C, "rt_pull_shm_direct_total").inc()
            m.builtin(C, "rt_pull_bytes_total").inc(value)
        elif kind == "push.chunk":
            m.builtin(C, "rt_push_bytes_total").inc(value)
        elif kind == "object.spill.write":
            m.builtin(C, "rt_spill_objects_total").inc()
            m.builtin(C, "rt_spill_bytes_total").inc(value)
        elif kind == "object.spill.restore":
            m.builtin(C, "rt_spill_restores_total").inc()
            m.builtin(C, "rt_spill_restore_bytes_total").inc(value)
        elif kind == "object.evict":
            m.builtin(C, "rt_evict_objects_total").inc()
            m.builtin(C, "rt_evict_bytes_total").inc(value)
        elif kind == "object.put.backpressure":
            m.builtin(C, "rt_put_backpressure_total").inc()
        elif kind == "object.array.put":
            m.builtin(C, "rt_array_puts_total").inc()
            m.builtin(C, "rt_array_put_bytes_total").inc(value)
        elif kind == "object.bcast.leg":
            m.builtin(C, "rt_bcast_legs_total").inc()
            m.builtin(C, "rt_bcast_bytes_total").inc(value)
        elif kind == "object.bcast.done":
            m.builtin(C, "rt_bcast_total").inc()
        elif kind == "object.bcast.fallback":
            m.builtin(C, "rt_bcast_fallback_total").inc(value or 1)
        elif kind == "inline.hit":
            m.builtin(C, "rt_inline_cache_hits_total").inc(value or 1)
        elif kind == "inline.miss":
            m.builtin(C, "rt_inline_cache_misses_total").inc(value or 1)
        elif kind == "inline.seal":
            m.builtin(C, "rt_inline_seals_total").inc(value)
        elif kind == "actor.window":
            m.builtin(m.Gauge, "rt_actor_push_window").set(value)
        elif kind == "fault.fired":
            m.builtin(C, "rt_faults_fired_total").inc()
        elif kind == "cgraph.execute":
            m.builtin(C, "rt_cgraph_executes_total").inc()
        elif kind == "cgraph.slot.write":
            m.builtin(C, "rt_cgraph_slot_writes_total").inc()
            m.builtin(H, "rt_cgraph_slot_write_s",
                      boundaries=[0.00005, 0.0002, 0.001, 0.005, 0.02, 0.1]
                      ).observe(value)
        elif kind == "cgraph.slot.wait":
            m.builtin(H, "rt_cgraph_slot_wait_s",
                      boundaries=[0.00005, 0.0002, 0.001, 0.005, 0.02, 0.1,
                                  1, 10]).observe(value)
        elif kind == "pipeline.stage.op":
            a = attrs or {}
            k = a.get("kind", "")
            m.builtin(C, "rt_pipeline_stage_ops_total",
                      tag_keys=("kind",)).inc(tags={"kind": k})
            m.builtin(H, "rt_pipeline_stage_op_s", tag_keys=("kind",),
                      boundaries=[0.0002, 0.001, 0.005, 0.02, 0.1, 0.5, 2]
                      ).observe(value, tags={"kind": k})
        elif kind == "pipeline.step":
            m.builtin(C, "rt_pipeline_steps_total").inc()
            a = attrs or {}
            eff = a.get("efficiency")
            if eff is not None:
                m.builtin(m.Gauge, "rt_pipeline_efficiency").set(eff)
        elif kind == "serve.request":
            # value = request latency (s); attrs carry the HTTP code.
            a = attrs or {}
            code = str(a.get("code", ""))
            m.builtin(C, "rt_serve_requests_total",
                      tag_keys=("code",)).inc(tags={"code": code})
            m.builtin(H, "rt_serve_request_s",
                      boundaries=[0.001, 0.005, 0.02, 0.1, 0.5, 2, 10, 60]
                      ).observe(value)
        elif kind == "serve.shed":
            m.builtin(C, "rt_serve_shed_total").inc(value or 1)
        elif kind == "serve.timeout":
            m.builtin(C, "rt_serve_timeout_total").inc(value or 1)
        elif kind == "serve.retry":
            m.builtin(C, "rt_serve_retries_total").inc(value or 1)
        elif kind == "serve.drain":
            m.builtin(C, "rt_serve_drains_total").inc(value or 1)
        elif kind == "lock.cycle":
            m.builtin(C, "rt_lock_cycles_total").inc()
        elif kind == "lock.long_hold":
            m.builtin(C, "rt_lock_long_holds_total").inc()
        elif kind == "serve.batch.flush":
            # value = batch size; attrs carry the adaptive-window state.
            a = attrs or {}
            m.builtin(H, "rt_serve_batch_size",
                      boundaries=[1, 2, 4, 8, 16, 32, 64, 128]
                      ).observe(value)
            if a.get("window_ms") is not None:
                m.builtin(m.Gauge, "rt_serve_batch_window_ms").set(
                    a["window_ms"])
            if a.get("p99_ms") is not None:
                m.builtin(m.Gauge, "rt_serve_p99_ms").set(a["p99_ms"])
    if dropped:
        m.builtin(C, "rt_events_dropped_total").inc(dropped)


# ----------------------------------------------------------------------
# shipping
# ----------------------------------------------------------------------
def configure(node_id, conductor_address: str,
              start_flusher: bool = True) -> None:
    """Bind this process's ring to a cluster identity and (optionally)
    start the background flusher. Idempotent; a later call with
    start_flusher=True upgrades a piggyback-only process (head mode:
    daemon and driver share one process)."""
    global _node_hex, _conductor_addr, _flusher
    _node_hex = (node_id.hex() if isinstance(node_id, (bytes, bytearray))
                 else str(node_id))
    _conductor_addr = conductor_address
    from ray_tpu_torch.util import metrics as _metrics
    _metrics.set_node(_node_hex)
    if not start_flusher:
        return
    with _flusher_lock:
        if _flusher is None or not _flusher.is_alive():
            _flush_stop.clear()
            _flusher = threading.Thread(target=_flush_loop, daemon=True,
                                        name="events-flush")
            _flusher.start()


def heartbeat_payload() -> Optional[dict]:
    """Drain for piggybacking on an already-periodic conductor RPC (the
    daemon heartbeat): None when there is nothing to ship."""
    global _unshipped, _unshipped_dropped
    evs, dropped = drain()
    if evs or dropped:
        try:
            _fold_metrics(evs, dropped)
        except Exception:
            pass
    with _ship_lock:
        if _unshipped or _unshipped_dropped:
            evs = _unshipped + evs
            dropped += _unshipped_dropped
            _unshipped, _unshipped_dropped = [], 0
    if not evs and not dropped:
        return None
    return {"pid": os.getpid(), "events": evs, "dropped": dropped}


def flush_now() -> None:
    """One flush pass: ship the ring delta + any buffered tracing spans
    to the conductor, fold metrics, sample probes."""
    global _unshipped, _unshipped_dropped
    addr = _conductor_addr
    if addr is None:
        return
    from ray_tpu_torch.cluster.protocol import get_client
    cli = get_client(addr)
    evs, dropped = drain()
    if evs or dropped:
        try:
            _fold_metrics(evs, dropped)
        except Exception:
            pass
    with _ship_lock:
        if _unshipped or _unshipped_dropped:
            evs = _unshipped + evs
            dropped += _unshipped_dropped
            _unshipped, _unshipped_dropped = [], 0
    if evs or dropped:
        try:
            cli.call("push_ring_events", node_id=_node_hex, pid=os.getpid(),
                     events=evs, dropped=dropped)
        except Exception:
            with _ship_lock:
                keep = max(64, _cap or 16384)
                merged = evs + _unshipped
                _unshipped = merged[-keep:]
                _unshipped_dropped += dropped + max(0, len(merged) - keep)
            raise
    from ray_tpu_torch.util import tracing
    if tracing.enabled():
        tracing.flush(cli)   # async replacement for the old inline flush
    _sample_probes()
    _check_slow_ops(cli)


def _flush_loop() -> None:
    while True:
        period = 0.5
        try:
            period = float(config.get("event_flush_period_s"))
        except Exception:
            pass
        if _flush_stop.wait(max(0.05, period)):
            return
        try:
            flush_now()
        except Exception:
            pass  # conductor down/restarting: next tick retries


def stop() -> None:
    """Stop the flusher (driver shutdown); best-effort final flush."""
    _flush_stop.set()
    try:
        flush_now()
    except Exception:
        pass


def reset_for_tests() -> None:
    """Forget ring + watchdog state (unit tests)."""
    global _buf, _cap, _seq, _cursor, _dropped, _enabled_gen
    global _watch_next, _unshipped, _unshipped_dropped
    _flush_stop.set()
    with _lock:
        _buf, _cap, _seq, _cursor, _dropped = [], 0, 0, 0, 0
        _enabled_gen = None
    with _ship_lock:
        _unshipped, _unshipped_dropped = [], 0
    with _watch_lock:
        _watch.clear()
        _watch_reported.clear()
        _watch_next = 0
    _scan_reported.clear()
