"""Runtime configuration flag registry. Ported from ``ray_tpu/config.py``.

Every flag is declared once with a type and default; ``RT_<NAME>`` env vars
override; ``init(_system_config={...})`` overrides both for the session and
is propagated to spawned daemons and workers through their environment.
The flags are the JAX package's, under the same names, types and defaults.
The propagated blob travels in ``RT_TORCH_SYSTEM_CONFIG_JSON`` (the JAX
package uses ``RT_SYSTEM_CONFIG_JSON``), so a process of one package never
loads the other's overrides.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RT_"
_SYSTEM_CONFIG_ENV = "RT_TORCH_SYSTEM_CONFIG_JSON"


@dataclass
class _Flag:
    name: str
    type: Callable[[Any], Any]
    default: Any
    doc: str


_REGISTRY: Dict[str, _Flag] = {}
_overrides: Dict[str, Any] = {}
# Bumped on every override change: hot paths (per-RPC flag checks) cache a
# flag's resolved value against this generation instead of re-reading
# os.environ on each call (measured: ~4 environ lookups per task).
generation = 0


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


def define(name: str, type_: Callable, default: Any, doc: str = "") -> None:
    if type_ is bool:
        type_ = _parse_bool
    _REGISTRY[name] = _Flag(name, type_, default, doc)


def get(name: str) -> Any:
    flag = _REGISTRY[name]
    if name in _overrides:
        return _overrides[name]
    env = os.environ.get(_ENV_PREFIX + name.upper())
    if env is not None:
        return flag.type(env)
    return flag.default


def set_system_config(cfg: Dict[str, Any]) -> None:
    """Apply a session-level override dict (validated against the registry)."""
    global generation
    for k, v in cfg.items():
        if k not in _REGISTRY:
            raise ValueError(f"Unknown system config flag: {k!r}")
        _overrides[k] = _REGISTRY[k].type(v)
    generation += 1


def set_override(name: str, value: Any) -> None:
    """Set one override (tests/chaos hooks). Bumps the generation so
    per-RPC cached flag reads observe the change."""
    global generation
    if name not in _REGISTRY:
        raise ValueError(f"Unknown system config flag: {name!r}")
    _overrides[name] = _REGISTRY[name].type(value)
    generation += 1


def clear_override(name: str) -> None:
    global generation
    _overrides.pop(name, None)
    generation += 1


def load_from_env() -> None:
    """Pick up a propagated system-config blob (set by the parent process)."""
    blob = os.environ.get(_SYSTEM_CONFIG_ENV)
    if blob:
        set_system_config(json.loads(blob))


def serialized_overrides() -> str:
    return json.dumps(_overrides)


def propagation_env() -> Dict[str, str]:
    """Env vars a child daemon/worker needs to see the same config."""
    env = {}
    if _overrides:
        env[_SYSTEM_CONFIG_ENV] = serialized_overrides()
    return env


def all_flags() -> Dict[str, Any]:
    return {name: get(name) for name in _REGISTRY}


# --------------------------------------------------------------------------
# Flag definitions. Grouped by subsystem.
# --------------------------------------------------------------------------

# Object store
define("object_store_memory_mb", int, 2048, "Per-node shm object store capacity.")
define("max_inline_object_bytes", int, 100 * 1024,
       "THE single small-object threshold (reference: "
       "max_direct_call_object_size). Values at or below this size travel "
       "inline everywhere: store puts/gets use the one-round-trip inline "
       "ops (ObjectPlane.put_value/put_blob, get_inline), task returns ride "
       "the push reply (reply-carried results, sealed lazily), and task "
       "args ship inside the task spec instead of put+pin+dependency-gate.")
define("task_inline_returns", bool, True,
       "Serialize task/actor results <= max_inline_object_bytes straight "
       "into the push_task/push_actor_task reply; the caller seeds its "
       "inline cache from the reply so get() touches no store/conductor. "
       "The worker still seals the value into the store lazily so remote "
       "pulls, wait() and lineage reconstruction keep working.")
define("task_inline_args", bool, True,
       "Ship top-level ObjectRef args whose serialized value is <= "
       "max_inline_object_bytes inside the task spec (reference: in-spec "
       "small args), skipping the dependency gate and the worker-side "
       "store fetch for them.")
define("inline_cache_max_bytes", int, 64 * 1024 * 1024,
       "Byte budget of the caller-side LRU cache of reply-carried inline "
       "results; entries are dropped when the local refcount hits zero.")
define("object_spill_dir", str, "",
       "Coordinated-spill backend root: a directory path or a storage URI "
       "(mock://, fsspec gs:// / s3://) handed to workflow.storage. '' = "
       "node-local <session_dir>/spill-coord. A SHARED root (NFS dir, "
       "bucket) is what lets spill copies outlive the node that wrote "
       "them: on holder death the conductor still advertises the URL and "
       "any node restores from it (local_object_manager.h role).")
define("object_store_spill_threshold", float, 0.8,
       "Store-usage fraction past which the node daemon proactively "
       "spills cold unreferenced sealed primaries through the spill "
       "backend (write URL -> report rpc_add_spilled -> evict shm copy), "
       "ahead of put demand. 0 disables coordinated spilling (puts then "
       "fail hard on ST_OOM as before).")
define("object_spill_put_timeout_s", float, 30.0,
       "Put-side backpressure window: a create that hits ST_OOM asks the "
       "local daemon to spill-then-admit and retries for up to this long "
       "before surfacing ObjectStoreFullError (0 = fail immediately, the "
       "pre-tiering behavior).")
define("object_spill_reconstruct_min_bytes", int, 0,
       "Restore-vs-reconstruct cost knob: when an object is both spilled "
       "and lineage-recoverable, objects at least this large prefer "
       "lineage re-execution over restoring the spilled bytes (restore "
       "cost scales with size; re-execution does not). 0 = always "
       "restore when a spill copy exists.")

# Device-native array objects (r16)
define("array_zero_copy_enabled", bool, True,
       "Serialize top-level numpy/jax arrays as a tiny RTAR header plus "
       "the raw buffer (exported zero-copy via dlpack/PickleBuffer) "
       "instead of pickling the payload; gets return read-only array "
       "views over the pinned shm mapping. Off = the classic pickle-5 "
       "path, byte-identical to pre-r16 blobs (regression baseline).")
define("array_bcast_min_bytes", int, 1 << 20,
       "Objects at least this large take the collective broadcast tree "
       "(ObjectPlane.broadcast_object); smaller ones fall back to plain "
       "consumer pulls — the tree's per-leg RPC coordination costs more "
       "than it saves below this size.")
define("array_bcast_fanout", int, 2,
       "Branching factor of the broadcast tree: each round, every holder "
       "feeds up to this many new members (2 = binomial tree). Higher "
       "fanout shortens the tree but concentrates load on early holders.")
define("array_bcast_leg_timeout_s", float, 60.0,
       "Deadline for one broadcast-tree leg (a member daemon's "
       "coordinated pull). An expired or failed leg is dropped from the "
       "tree and its member falls back to the classic pull path on "
       "first get (zero loss; the directory still advertises holders).")

# Scheduling
define("worker_pool_min_size", int, 0, "Workers prestarted per node at boot.")
define("worker_pool_max_size", int, 8, "Max concurrent leased workers per node.")
define("worker_idle_timeout_s", float, 60.0, "Idle worker reap timeout.")
define("memory_usage_threshold", float, 0.95,
       "Node memory fraction above which the daemon OOM-kills a worker "
       "(memory_monitor.h:52 role; 0 disables).")
define("memory_monitor_refresh_ms", int, 250,
       "OOM monitor sampling period.")
define("max_concurrent_pull_bytes", int, 256 * 1024 * 1024,
       "Byte budget for concurrent remote-object pulls per process "
       "(pull_manager.h:52 admission control role).")
define("object_pull_window", int, 4,
       "Chunks kept in flight per pull: the puller pipelines this many "
       "fetch_chunk RPCs on one channel and writes completions into the "
       "store out of order, so transfer bandwidth is not round-trip-bound "
       "(parity: object_manager max_chunks_in_flight).")
define("object_push_window", int, 4,
       "Chunks kept in flight per push (push_manager.h chunk window role); "
       "the receiver accepts out-of-order chunk offsets within a stream.")
define("object_stripe_min_bytes", int, 16 * 1024 * 1024,
       "Pulls of objects at least this large stripe their chunk ranges "
       "across multiple advertised holders; smaller transfers use one "
       "least-loaded holder (the striping setup costs a probe per holder).")
define("object_pull_max_sources", int, 4,
       "Max holders one striped pull reads from concurrently.")
define("object_transfer_chunk_bytes", int, 8 * 1024 * 1024,
       "Pull-side chunk size for node-to-node object transfer (parity: "
       "object_manager_default_chunk_size). Tests shrink it to exercise "
       "many-chunk windows on small objects.")
define("object_pull_shm_direct", bool, True,
       "When a holder's segment file is visible on this host's /dev/shm "
       "(daemons sharing a machine), pull by pinning the remote segment "
       "and copying mapping-to-mapping instead of streaming chunks over "
       "TCP (parity: plasma same-node zero-copy sharing). Tests that "
       "exercise the chunked TCP path disable this.")
define("lease_reuse_enabled", bool, True,
       "Reuse a granted worker lease for queued tasks with the same scheduling "
       "key (the reference's lease-reuse fast path, direct_task_transport.cc). "
       "Off = every task pays a fresh grant; kept as the no-reuse "
       "regression baseline for benchmarks.")
define("max_pending_lease_requests", int, 10, "In-flight lease requests per key.")
define("actor_start_pool_size", int, 8,
       "Bounded pool of concurrent actor bring-ups per node daemon: a wave "
       "spawns this many workers at once instead of one thread per actor "
       "(unbounded concurrent boots thrash small hosts).")
define("actor_worker_recycle", bool, True,
       "Return the worker of a cleanly killed sync actor to the idle pool "
       "instead of killing the process; the next actor creation then skips "
       "fork+boot entirely (the dominant cost of an actor wave).")
define("actor_recycle_pool_cap", int, 128,
       "Idle-pool cap applied when recycling actor workers (the task "
       "pool's worker_pool_max_size stays the spawn-side cap).")
define("control_plane_batching", bool, True,
       "Batch control-plane RPCs (register_actors waves, shared actor "
       "resolution, multi-lease grants). Off = serialized per-actor "
       "round-trips; kept as the regression baseline for benchmarks.")
define("lease_multi_grant", int, 4,
       "Max leases granted per request_leases round-trip when a deep task "
       "queue needs pool growth (1 = single-grant behavior).")

# Health / fault tolerance
define("health_check_period_s", float, 0.5,
       "Node -> conductor heartbeat period (node_daemon._heartbeat_loop); "
       "also the retry backoff when the conductor is unreachable.")
define("health_check_timeout_s", float, 10.0,
       "Silence window after which the conductor marks a node dead "
       "(Conductor health_timeout_s default; callers may override per "
       "instance).")
define("task_max_retries_default", int, 3, "Default retries for idempotent tasks.")
define("max_lineage_bytes", int, 256 * 1024 * 1024,
       "Byte budget for retained task lineage (args blobs) per submitter; "
       "done+unreferenced records evict first (ray_config_def.h "
       "max_lineage_bytes role).")
define("worker_fetch_timeout_s", float, 120.0,
       "Executor-side bound on fetching a task argument; a freed/lost dep "
       "fails the task instead of hanging the worker.")
define("actor_max_restarts_default", int, 0, "Default actor restarts.")
define("testing_rpc_delay_us", str, "",
       "Deterministic delay injected before serving matching RPCs; format "
       "'method:us' pairs comma-separated, or bare int for all methods "
       "(reference: RAY_testing_asio_delay_us). Subsumed by the fault "
       "plane (cluster/fault_plane.py) as delay rules on "
       "rpc.server.dispatch; kept for compatibility.")
define("fault_plan", str, "",
       "JSON list of fault-injection rules evaluated at named fault "
       "points (cluster/fault_plane.py). Empty = every fault point is a "
       "no-op. Propagates to spawned daemons/workers like any override.")
define("fault_seed", int, 0,
       "Base seed for probabilistic fault-plan rules (per-rule 'seed' "
       "overrides). Chaos tests print it so failures replay exactly.")

# Transport
define("rpc_connect_timeout_s", float, 10.0, "Client connect timeout.")
define("rpc_same_host_uds", bool, True,
       "Mirror every RPC listener on a Unix socket and let loopback "
       "clients use it instead of TCP (cheaper send syscalls on the task "
       "push ping-pong). Off forces pure-TCP transport everywhere.")
define("gcs_rpc_reconnect_s", float, 5.0,
       "Seconds drivers/planes retry conductor calls across a failover "
       "window (0 disables; parity gcs_rpc_server_reconnect_timeout_s).")
define("log_to_driver", bool, True,
       "Stream worker stdout/stderr lines to connected drivers "
       "(log_monitor.py role).")
define("conductor_persist", bool, False,
       "Journal durable conductor tables (gcs_table_storage.h role). Off "
       "for ephemeral in-process heads (their temp session dir can't be "
       "found again); `ray_tpu_torch start --head` and explicit "
       "Conductor(persist_dir=...) enable real restart recovery against a "
       "stable path.")
define("rpc_message_max_bytes", int, 512 * 1024 * 1024, "Max framed message size.")

# Serve ingress (serve/http_proxy.py admission control + serve/api.py
# handle routing + serve/controller.py drain)
define("serve_max_queued_requests", int, 200,
       "Per-deployment proxy-side queue budget: requests waiting for an "
       "ongoing slot past this depth are shed with 503 + Retry-After "
       "instead of queueing unboundedly (parity: serve "
       "max_queued_requests proxy backpressure).")
define("serve_max_ongoing_requests", int, 8,
       "Per-replica in-flight request cap (parity: serve "
       "max_ongoing_requests). The handle routes only to replicas under "
       "the cap and the proxy bounds dispatched work to "
       "replicas x cap; deployments override with "
       "@serve.deployment(max_ongoing_requests=N).")
define("serve_request_timeout_s", float, 30.0,
       "End-to-end deadline for one ingress request (queue wait + replica "
       "call). Expiry answers 504 and cancels the in-flight call instead "
       "of leaking it (parity: RAY_SERVE_REQUEST_PROCESSING_TIMEOUT_S).")
define("serve_drain_timeout_s", float, 10.0,
       "Graceful-drain window on scale-down/delete: a DRAINING replica "
       "leaves the routing table immediately (generation bump) and gets "
       "this long to finish in-flight requests before the kill (parity: "
       "serve graceful_shutdown_timeout_s).")

# Observability
define("task_event_buffer_size", int, 100_000,
       "Task lifecycle events the conductor retains (oldest dropped "
       "first; state.list_tasks / dashboard timeline source).")
define("tracing_enabled", bool, False,
       "Record OTel-style spans around task submit/execute "
       "(util/tracing.py; read via state.list_spans).")
define("metrics_export_period_s", float, 5.0, "Metrics flush period.")
define("events_enabled", bool, True,
       "Flight-recorder event ring (util/events.py): per-process "
       "lifecycle events across all planes, shipped to the conductor in "
       "background batches. Always-on by design — the hot-path cost is "
       "one cached flag check plus a ring-slot store.")
define("event_ring_size", int, 16384,
       "Flight-recorder ring capacity per process; overwrites oldest "
       "(dropped counts ship with the next batch).")
define("event_flush_period_s", float, 0.5,
       "Background flush period for the event ring (and buffered "
       "tracing spans) to the conductor.")
define("slow_op_threshold_s", float, 30.0,
       "Slow-op watchdog: a task/pull/RPC in flight longer than this "
       "emits a SLOW_OPERATION cluster event carrying the surrounding "
       "ring context. 0 disables.")
define("lockcheck_enabled", bool, False,
       "Lock-order sanitizer (util/lockcheck.py): named control-plane "
       "locks record acquisition-order edges, flag cycles (potential "
       "deadlock) and holds past lockcheck_hold_s into the flight "
       "recorder. Disabled cost is one generation compare per acquire "
       "(the fault_plane pattern); armed by conftest for the "
       "conductor/daemon/serve test modules.")
define("lockcheck_hold_s", float, 1.0,
       "Lock-hold threshold for the sanitizer: a named lock held longer "
       "than this emits a lock.long_hold event. 0 disables hold "
       "tracking.")
