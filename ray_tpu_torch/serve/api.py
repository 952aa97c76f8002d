"""Public serve API: @deployment / run / handles / @batch. Ported from
``ray_tpu/serve/api.py``.

Role parity: serve/api.py + handle.py:78 (DeploymentHandle -> Router) +
batching (serve/batching.py). Handle routing is queue-length-aware
power-of-two-choices over replica actors (parity: router.py:263 picks the
replica with fewest in-flight), hardened with dead-replica eviction and
one retry on a different replica (parity: router's
ActorReplicaWrapper failure handling + request retries).

Serve runs on both of the port's runtimes. On a ``ClusterRuntime``
(``init(address=...)``) the controller, the HTTP proxy and every replica
are worker processes, as in the JAX package; ``run(..., compile=True)``
gives the compiled handle, whose requests ride a compiled one-step graph
(``dag/``) on each replica's worker, and falls back to the task path when
compiling fails or a request's error has poisoned the graph. On the
in-process runtime nothing compiles, so that handle uses the task path.

Where the port differs from the JAX module (ROADMAP.md C):
- The deployment's target and init args go to the controller as one blob
  of the port's pickler on a cluster (a function or class by import path,
  so one defined inside another raises ``TypeError`` at ``serve.run``),
  and by reference on the in-process runtime. Request args go as the
  actor call's own args, through the same pickler, where the JAX handle
  cloudpickles them.
- ``@serve.batch`` keeps one queue per replica instance (and one for a
  plain function), where the JAX module keeps one per process, which its
  in-process runtime shares between the replicas of a deployment.
- A handle counts a task-path call as finished through the runtime's
  ``on_resolved`` callback, where the JAX handle starts a thread that
  polls ``rt.wait``: on the card, that poller took the GIL from the
  replica's host-bound decode loop (PERF.md §6; ``chip_serve_probe.py``
  measures it). A compiled call counts as in flight while its graph holds
  it (executed, not yet read). The handle's lock is lockcheck's named
  lock ``serve.handle``, as in the JAX module.
"""

from __future__ import annotations

import collections
import functools
import random
import threading
import time
import uuid
import weakref
from typing import Any, Dict, List, Optional

from ray_tpu_torch import config
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.exceptions import (ActorError, GetTimeoutError,
                                           ObjectLostError,
                                           WorkerCrashedError)
from ray_tpu_torch.core.refs import ChannelResolvedRef
from ray_tpu_torch.serve.controller import ReplicaBusyError, ServeController
from ray_tpu_torch.util import events, lockcheck


def _get_controller(create: bool = True):
    try:
        return core_api.get_actor(ServeController.CONTROLLER_NAME)
    except ValueError:
        if not create:
            raise
        cls = core_api.remote(ServeController)
        return cls.options(name=ServeController.CONTROLLER_NAME,
                           lifetime="detached", max_concurrency=32,
                           get_if_exists=True).remote()


def _retryable(exc: BaseException) -> bool:
    """True when a failed call may be retried on ANOTHER replica: the
    replica died / it shed the call at its in-flight cap. User exceptions
    (TaskError wrapping application code) are not retried — re-running
    user code on failure is an application policy."""
    kinds = (ActorError, WorkerCrashedError, ObjectLostError,
             ReplicaBusyError, ConnectionError)
    seen = 0
    while exc is not None and seen < 8:
        if isinstance(exc, kinds):
            return True
        exc = getattr(exc, "cause", None)
        seen += 1
    return False


def _emit(kind: str, ident: str, value: float = 1.0, **attrs) -> None:
    try:
        events.emit(kind, ident, value=value, attrs=attrs or None)
    except Exception:
        pass   # the flight recorder never fails a request


def _in_process() -> bool:
    """True on the in-process runtime, which has no conductor."""
    return getattr(core_api._global_runtime(), "conductor", None) is None


class ServeCallRef(ChannelResolvedRef):
    """Ref returned by DeploymentHandle.remote(): resolves through the
    handle so a call that died with its replica (or was shed at the
    replica's in-flight cap) is retried ONCE on a different replica,
    transparently to get()/wait(). Timeouts cancel the in-flight actor
    task instead of leaking it."""

    __slots__ = ("_handle", "_inner", "_key", "_call", "_method",
                 "_retried")

    def __init__(self, handle: "DeploymentHandle", inner, key,
                 method: str, call: tuple):
        super().__init__(inner.id)
        self._handle = handle
        self._inner = inner
        self._key = key
        self._method = method
        self._call = call
        self._retried = False

    def _resolve(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None else \
                max(0.0, deadline - time.monotonic())
            try:
                return core_api.get(self._inner, timeout=remaining)
            except GetTimeoutError:
                # Deadline: the caller gets the timeout, the replica gets
                # a cancel — the call must not keep a slot occupied (and
                # the proxy must not leak work for clients that are gone).
                try:
                    core_api.cancel(self._inner)
                except Exception:
                    pass   # the runtime is gone: nothing left to cancel
                _emit("serve.timeout", self._handle.name)
                raise
            except Exception as e:  # noqa: BLE001
                if self._retried or not _retryable(e):
                    raise
                self._retried = True
                wait_s = 2.0 if deadline is None else \
                    max(0.0, deadline - time.monotonic())
                inner = self._handle._resubmit(
                    self._key, self._method, self._call,
                    wait_s=min(wait_s, 30.0))
                if inner is None:
                    raise
                _emit("serve.retry", self._handle.name)
                self._inner = inner
                self._key = None  # key travels with the new submission

    def _is_ready(self) -> bool:
        done, _ = core_api.wait([self._inner], num_returns=1, timeout=0)
        return bool(done)


class DeploymentHandle:
    """Client-side router over a deployment's replicas."""

    def __init__(self, name: str, method: str = "__call__"):
        self.name = name
        self.method = method
        self._replicas: List[Any] = []
        self._generation = -1
        self._max_ongoing = 0
        self._ts = 0.0
        self._lock = lockcheck.named_lock("serve.handle")
        self._inflight: Dict[Any, int] = {}
        # Evicted-replica quarantine: actor_id -> routing generation at
        # eviction time. The controller's table lags a death by up to a
        # reconcile period; without this a refresh at the SAME generation
        # would re-admit the corpse and a retry could land right back on
        # it. A generation bump (the controller noticed) lifts the
        # quarantine.
        self._suspects: Dict[Any, int] = {}
        self._closed = False
        # Opt-in compiled fast path (serve.run(..., compile=True)): one
        # compiled one-step graph per replica; requests ride a persistent
        # shm channel instead of a task submission per call.
        self._compile = False
        self._cgraphs: Dict[Any, Any] = {}

    def options(self, method_name: str) -> "DeploymentHandle":
        return DeploymentHandle(self.name, method_name)

    def __reduce__(self):
        # Handles travel into replica __init__ args (deployment graphs):
        # the receiving process builds a fresh one (locks do not ship).
        return (DeploymentHandle, (self.name, self.method))

    def _refresh(self, force: bool = False):
        with self._lock:
            if not force and time.monotonic() - self._ts < 1.0 \
                    and self._replicas:
                return
        # The routing fetch is a controller round-trip and must NOT run
        # under the handle lock: concurrent requests keep routing on the
        # previous table instead of convoying behind one refresher.
        controller = _get_controller(create=False)
        routing = core_api.get(
            controller.get_routing.remote(self.name), timeout=30)
        with self._lock:
            gen = routing["generation"]
            self._suspects = {k: g for k, g in self._suspects.items()
                              if g == gen}
            self._replicas = [r for r in routing["replicas"]
                              if r._rt_actor_id not in self._suspects]
            self._max_ongoing = routing["max_ongoing"]
            dead_graphs = []
            if gen != self._generation:
                # Membership changed: drop in-flight book entries for
                # replicas that left (DRAINING/dead) so p2c never favors a
                # ghost, and tear down any compiled graph pinned to one.
                self._generation = gen
                live = {r._rt_actor_id for r in self._replicas}
                for k in [k for k in self._inflight if k not in live]:
                    self._inflight.pop(k, None)
                dead_graphs = [self._cgraphs.pop(k) for k in
                               list(self._cgraphs) if k not in live]
            self._ts = time.monotonic()
        _teardown(*dead_graphs)

    def _evict(self, key) -> None:
        """Forget a replica that failed a submission mid-window — the
        controller will reap it on its own schedule; this handle must stop
        routing to it NOW."""
        with self._lock:
            self._replicas = [r for r in self._replicas
                              if r._rt_actor_id != key]
            self._suspects[key] = self._generation
            self._inflight.pop(key, None)
            cg = self._cgraphs.pop(key, None)
            self._ts = 0.0   # next pick re-fetches the routing table
        _teardown(cg)

    def _load(self, key) -> int:
        """Calls in flight on a replica: task-path calls not finished yet
        plus compiled executions its graph holds. Caller holds the lock."""
        cg = self._cgraphs.get(key)
        return self._inflight.get(key, 0) + (cg._inflight if cg else 0)

    def _pick(self, exclude=frozenset(), enforce_cap: bool = False):
        """Power-of-two-choices on locally tracked in-flight counts."""
        self._refresh()
        with self._lock:
            candidates = [r for r in self._replicas
                          if r._rt_actor_id not in exclude]
            if enforce_cap and self._max_ongoing > 0:
                candidates = [
                    r for r in candidates
                    if self._load(r._rt_actor_id) < self._max_ongoing]
        if not candidates:
            if not self._replicas:
                raise RuntimeError(
                    f"deployment {self.name!r} has no replicas")
            raise ReplicaBusyError(
                f"all replicas of {self.name!r} at in-flight cap")
        if len(candidates) == 1:
            return candidates[0]
        a, b = random.sample(candidates, 2)
        with self._lock:
            return a if self._load(a._rt_actor_id) <= \
                self._load(b._rt_actor_id) else b

    def _submit(self, replica, call: tuple):
        key = replica._rt_actor_id
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1
        ref = replica.handle_request.remote(self.method, call)
        # Decrement when the request actually completes: the runtime calls
        # back when the ref's object is stored (no thread polls for it).
        core_api._global_runtime().on_resolved(
            ref, lambda: self._finished(key))
        return ref, key

    def _finished(self, key) -> None:
        with self._lock:
            self._inflight[key] = max(0, self._inflight.get(key, 1) - 1)

    def _resubmit(self, failed_key, method: str, call: tuple,
                  wait_s: float = 0.0):
        """Retry path for ServeCallRef: evict the failed replica, pick a
        DIFFERENT one, submit there. The pick honors the per-replica
        in-flight cap — a retry dumped onto a saturated replica would be
        shed a second time and surface as a hard failure — waiting up to
        ``wait_s`` for a slot. None when no alternative exists."""
        if failed_key is not None:
            self._evict(failed_key)
        exclude = frozenset() if failed_key is None \
            else frozenset({failed_key})
        deadline = time.monotonic() + wait_s
        while True:
            try:
                replica = self._pick(exclude=exclude, enforce_cap=True)
                break
            except ReplicaBusyError:
                if time.monotonic() >= deadline:
                    return None
                time.sleep(0.005)
            except Exception:
                return None
        ref, _ = self._submit(replica, call)
        return ref

    def remote(self, *args, **kwargs):
        replica = self._pick()
        call = (args, kwargs)
        if self._compile:
            ref = self._remote_compiled(replica, call)
            if ref is not None:
                return ref
        ref, key = self._submit(replica, call)
        return ServeCallRef(self, ref, key, self.method, call)

    def call(self, *args, timeout: Optional[float] = None, **kwargs):
        """Blocking call with deadline + capacity backpressure: waits for
        a replica slot (per-replica in-flight cap), submits, resolves with
        the one-retry policy. Raises ReplicaBusyError when no capacity
        frees up in time, GetTimeoutError past the deadline. This is the
        proxy's dispatch path."""
        if timeout is None:
            timeout = float(config.get("serve_request_timeout_s"))
        deadline = time.monotonic() + timeout
        call = (args, kwargs)
        while True:
            try:
                replica = self._pick(enforce_cap=True)
                break
            except ReplicaBusyError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.005)
        ref, key = self._submit(replica, call)
        sref = ServeCallRef(self, ref, key, self.method, call)
        return sref._resolve(max(0.0, deadline - time.monotonic()))

    def _remote_compiled(self, replica, call: tuple):
        """Submit through the replica's compiled graph; None means the
        caller should fall back to the classic task path (compile failed,
        or a prior request's exception poisoned the graph — that failed
        request still raises its own error at get())."""
        key = replica._rt_actor_id
        try:
            with self._lock:
                cg = self._cgraphs.get(key)
            if cg is None:
                from ray_tpu_torch.dag.compiled import compile_actor_method
                cg = compile_actor_method(
                    replica, "handle_request", const_args=(self.method,),
                    max_in_flight=8)
                with self._lock:
                    self._cgraphs[key] = cg
                    _compiled_handles.add(self)
            return cg.execute(call)
        except Exception:
            with self._lock:
                cg = self._cgraphs.pop(key, None)
            _teardown(cg)
            return None

    def teardown_compiled(self) -> None:
        """Tear down this handle's compiled replica graphs (restores the
        replicas to classic task service; safe to call repeatedly)."""
        with self._lock:
            graphs, self._cgraphs = list(self._cgraphs.values()), {}
            self._compile = False
        _teardown(*graphs)

    def close(self) -> None:
        """Drop the compiled graphs and mark the handle closed: the
        proxy's cache makes a fresh one. serve.shutdown() closes the
        cached ones."""
        self.teardown_compiled()
        self._closed = True


def _teardown(*graphs) -> None:
    for cg in graphs:
        if cg is None:
            continue
        try:
            cg.teardown()
        except Exception:
            pass   # a dead replica's loop is gone with its worker


# Handles that compiled a replica graph: serve.shutdown() tears them down
# before the replicas die.
_compiled_handles: "weakref.WeakSet" = weakref.WeakSet()


class Deployment:
    """Result of @serve.deployment: holds the target + config, bindable."""

    def __init__(self, target, name: str, num_replicas: int = 1,
                 ray_actor_options: Optional[dict] = None,
                 user_config=None, route_prefix: Optional[str] = None,
                 max_concurrent_queries: int = 100,
                 autoscaling_config: Optional[dict] = None,
                 init_grace_s: float = 120.0,
                 max_ongoing_requests: int = 0):
        self._target = target
        self.name = name
        self.num_replicas = num_replicas
        self.ray_actor_options = ray_actor_options or {}
        self.user_config = user_config
        self.route_prefix = route_prefix if route_prefix is not None \
            else f"/{name}"
        self.max_concurrent_queries = max_concurrent_queries
        self.autoscaling_config = autoscaling_config
        # How long a spawned replica may stay silent while __init__ runs
        # (model loads) before an unanswered health ping means death.
        self.init_grace_s = init_grace_s
        # Per-replica in-flight cap (0 = the serve_max_ongoing_requests
        # config default). Past the cap a replica sheds instead of queues.
        self.max_ongoing_requests = max_ongoing_requests
        self._init_args = ((), {})

    def options(self, **updates) -> "Deployment":
        d = Deployment(self._target, updates.pop("name", self.name),
                       self.num_replicas, dict(self.ray_actor_options),
                       self.user_config, self.route_prefix,
                       self.max_concurrent_queries, self.autoscaling_config,
                       self.init_grace_s, self.max_ongoing_requests)
        for k, v in updates.items():
            setattr(d, k, v)
        d._init_args = self._init_args
        return d

    def bind(self, *args, **kwargs) -> "Application":
        """Bind init args — which may include other bound Applications:
        ``Ensemble.bind(ModelA.bind(), ModelB.bind())`` builds a deployment
        GRAPH (parity: the serve DAG API, serve/api.py build/run). At
        serve.run the graph deploys bottom-up and each nested Application
        arrives in __init__ as a live DeploymentHandle."""
        d = self.options()
        d._init_args = (args, kwargs)
        return Application(d)

    def deploy(self, *init_args, **init_kwargs) -> DeploymentHandle:
        payload = (self._target, (init_args, init_kwargs))
        if not _in_process():
            # By value for the replicas' processes, pickled here so that a
            # target that cannot ship raises in the caller's process.
            payload = serialization.dumps(payload)
        controller = _get_controller()
        core_api.get(controller.deploy.remote(
            self.name, payload, self.num_replicas, self.ray_actor_options,
            self.user_config, self.route_prefix, self.max_concurrent_queries,
            self.autoscaling_config, self.init_grace_s,
            self.max_ongoing_requests), timeout=300)
        return DeploymentHandle(self.name)


class Application:
    def __init__(self, deployment: Deployment):
        self.deployment = deployment


def deployment(target=None, *, name: Optional[str] = None, **options):
    """@serve.deployment decorator over a class or function."""
    def wrap(t):
        return Deployment(t, name or t.__name__, **options)
    if target is not None:
        return wrap(target)
    return wrap


def _deploy_graph(app: "Application",
                  _seen: Optional[dict] = None) -> DeploymentHandle:
    """Deploy an application graph bottom-up: nested bound Applications in
    the init args deploy first and are replaced by their handles. Shared
    nodes (diamond DAGs) deploy exactly once (memoized by identity)."""
    if _seen is None:
        _seen = {}
    if id(app) in _seen:
        return _seen[id(app)]
    d = app.deployment
    args, kwargs = d._init_args

    def resolve(v):
        if isinstance(v, Application):
            return _deploy_graph(v, _seen)
        if isinstance(v, Deployment):
            return _deploy_graph(v.bind(), _seen)
        if isinstance(v, (list, tuple)):
            return type(v)(resolve(x) for x in v)
        if isinstance(v, dict):
            return {k: resolve(x) for k, x in v.items()}
        return v

    args = tuple(resolve(a) for a in args)
    kwargs = {k: resolve(v) for k, v in kwargs.items()}
    handle = d.deploy(*args, **kwargs)
    _seen[id(app)] = handle
    return handle


def run(app, *, http_host: Optional[str] = None,
        http_port: int = 0, compile: bool = False) -> DeploymentHandle:
    """Deploy an Application (parity: serve.run), including DAGs built
    with nested ``.bind()`` calls; with ``http_host`` also start the HTTP
    proxy (its port is the returned handle's ``http_port``).
    ``compile=True`` routes the RETURNED handle's requests over compiled
    execution graphs (dag/compiled.py): per-replica persistent shm
    channels instead of a task submission per request. Handles nested
    inside the graph stay on the classic path."""
    if isinstance(app, Deployment):
        app = app.bind()
    handle = _deploy_graph(app)
    handle._compile = bool(compile)
    if http_host is not None:
        controller = _get_controller()
        port = core_api.get(
            controller.start_http.remote(http_host, http_port), timeout=120)
        handle.http_port = port
    # wait for replicas to come up
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            handle._refresh()
            if handle._replicas:
                break
        except Exception:
            pass   # the controller is still deploying: poll again
        time.sleep(0.2)
    return handle


def get_deployment_handle(name: str, method: str = "__call__"
                          ) -> DeploymentHandle:
    return DeploymentHandle(name, method)


# Proxy-side handle cache: ONE handle per deployment per process. A fresh
# handle per request would spawn a drainer thread each (leak) and reset
# the in-flight book the p2c router and the capacity caps depend on.
_handles: Dict[str, DeploymentHandle] = {}
_handles_lock = threading.Lock()


def _handle_for(name: str) -> DeploymentHandle:
    with _handles_lock:
        h = _handles.get(name)
        if h is None or h._closed:
            h = _handles[name] = DeploymentHandle(name)
        return h


def status() -> Dict[str, dict]:
    return core_api.get(_get_controller(create=False).status.remote(),
                        timeout=30)


def delete(name: str) -> None:
    core_api.get(_get_controller(create=False).delete_deployment.remote(
        name), timeout=60)


def shutdown() -> None:
    """Tear down every compiled replica graph, delete every deployment
    (replicas drain, then die), close the HTTP proxy and the proxy's
    handles, and kill the controller. The runtime stays up."""
    with _handles_lock:
        stale = list(_handles.values())
        _handles.clear()
    for h in stale + list(_compiled_handles):
        h.close()
    if not core_api.is_initialized():
        return
    try:
        controller = _get_controller(create=False)
    except ValueError:
        return
    try:
        core_api.get(controller.graceful_shutdown.remote(), timeout=60)
    except Exception:
        pass   # kill the controller all the same
    try:
        core_api.kill(controller)
    except Exception:
        pass


# Batching state, one queue per (decorated function, replica instance);
# the key's second part is None for a plain function.
_batch_states: Dict[tuple, dict] = {}
_batch_states_lock = threading.Lock()


def _batch_state(key: tuple, window_s: float) -> dict:
    with _batch_states_lock:
        st = _batch_states.get(key)
        if st is None:
            st = _batch_states[key] = {
                "lock": threading.Lock(), "pending": [],
                # Adaptive window state: current flush window plus the
                # recent per-request latencies the controller law reads.
                "window": window_s,
                "lat": collections.deque(maxlen=256),
            }
        return st


def _adapt_window(st: dict, target_p99_ms: float, base_window_s: float,
                  batch_size: int) -> None:
    """AIMD-flavored window law keyed off observed request p99: grow the
    flush window multiplicatively while comfortably under the SLO target
    (bigger batches amortize one forward over more requests), halve it the
    moment p99 breaches (latency recovers within a flush or two). Bounds
    keep a misconfigured target from freezing (window->0 busy-flush) or
    stalling (window >> SLO) the pipeline. The flush's size, window and
    p99 go to the ring as ``serve.batch.flush``."""
    lat = sorted(st["lat"])
    if not lat:
        return
    p99_ms = lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1000.0
    lo, hi = base_window_s / 10.0, base_window_s * 10.0
    if p99_ms > target_p99_ms:
        st["window"] = max(lo, st["window"] * 0.5)
    elif p99_ms < 0.8 * target_p99_ms:
        st["window"] = min(hi, st["window"] * 1.25)
    _emit("serve.batch.flush", "batch", value=float(batch_size),
          window_ms=st["window"] * 1000.0, p99_ms=p99_ms)


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01,
          target_p99_ms: Optional[float] = None):
    """Dynamic request batching (parity: serve/batching.py @serve.batch):
    concurrent single calls coalesce into one list-call of the wrapped
    function — one batched forward on the card for many requests.

    With ``target_p99_ms`` set the flush window ADAPTS instead of staying
    fixed: it grows while observed p99 sits under the SLO target and
    halves on breach, so batch size tracks offered load without trading
    away the latency budget. ``batch_wait_timeout_s`` is then the initial
    window and anchors the adaptation bounds (x0.1 .. x10)."""
    def wrap(fn):
        state_key = uuid.uuid4().hex

        def flush(key):
            st = _batch_state(key, batch_wait_timeout_s)
            with st["lock"]:
                batch_items = st["pending"][:]
                st["pending"].clear()
            if not batch_items:
                return
            items = [it[0] for it in batch_items]
            self_obj = batch_items[0][2]
            try:
                outs = fn(self_obj, items) if self_obj is not None \
                    else fn(items)
                if len(outs) != len(items):
                    raise ValueError(
                        f"@serve.batch fn returned {len(outs)} results "
                        f"for {len(items)} inputs")
                for (_, slot, _, _), out in zip(batch_items, outs):
                    slot["result"] = out
                    slot["event"].set()
            except BaseException as e:  # noqa: BLE001 - each caller re-raises
                for _, slot, _, _ in batch_items:
                    slot["error"] = e
                    slot["event"].set()
            finally:
                if target_p99_ms is not None:
                    done = time.monotonic()
                    with st["lock"]:
                        st["lat"].extend(done - it[3]
                                         for it in batch_items)
                        _adapt_window(st, target_p99_ms,
                                      batch_wait_timeout_s,
                                      len(batch_items))

        @functools.wraps(fn)
        def wrapper(*call_args):
            if len(call_args) == 2:
                self_obj, item = call_args
            else:
                self_obj, item = None, call_args[0]
            key = (state_key, None if self_obj is None else id(self_obj))
            slot = {"event": threading.Event(), "result": None,
                    "error": None}
            st = _batch_state(key, batch_wait_timeout_s)
            do_flush = False
            with st["lock"]:
                st["pending"].append((item, slot, self_obj,
                                      time.monotonic()))
                if len(st["pending"]) >= max_batch_size:
                    do_flush = True
                window = st["window"]
            if do_flush:
                flush(key)
            else:
                timer = threading.Timer(window, flush, args=(key,))
                timer.name, timer.daemon = "serve-batch-window", True
                timer.start()
            if not slot["event"].wait(timeout=120):
                raise TimeoutError("@serve.batch: no flush within 120 s")
            if slot["error"] is not None:
                raise slot["error"]
            return slot["result"]

        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
