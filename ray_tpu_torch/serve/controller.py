"""Serve control plane: controller + replica actors + router. Ported from
``ray_tpu/serve/controller.py``.

Role parity: serve/controller.py:73 (ServeController reconcile loop),
_private/deployment_state.py (target vs running replicas FSM + DRAINING
state on scale-down), _private/replica.py (replica actor wrapping the
user callable, per-replica in-flight cap), _private/router.py:263
(queue-length-aware replica choice over a generation-stamped replica
list), _private/autoscaling_policy.py (replicas from in-flight load).

Where the port differs from the JAX module (ROADMAP.md C):
- A replica takes the deployment's class or function, its init args and
  each request's args by reference: the in-process runtime pickles
  nothing, so no ``cloudpickle`` blob is made.
- No fault-plane sites, ring events or occupancy gauge: the modules
  came with the cluster runtime (``cluster/fault_plane.py``,
  ``util/events.py``, ``util/metrics.py``), but serve's replicas are not
  worker processes yet (ROADMAP.md A.5(b)). The controller's two locks are
  lockcheck's named locks ``serve.controller`` and ``serve.reconcile``,
  as in the JAX module.
- Liveness comes from the runtime's own actor state and load from the
  replicas' ``queue_len``, where the JAX controller reads the conductor's
  actor table and metrics KV.
- ``ray_actor_options`` take ``num_gpus`` for ``num_tpus``.
- ``graceful_shutdown`` closes the HTTP proxy (joining its threads) before
  killing it, and joins the reconciler thread, which also stops once the
  runtime that started it is shut down.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch import config
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core.exceptions import GetTimeoutError
from ray_tpu_torch.util import lockcheck


class ReplicaBusyError(Exception):
    """A replica past its per-request in-flight cap rejected the call
    instead of queueing it; the handle retries on another replica."""


class Replica:
    """Actor wrapping one instance of the user's deployment callable."""

    def __init__(self, target, init_args: tuple, deployment: str = "",
                 max_ongoing: int = 0):
        args, kwargs = init_args
        if isinstance(target, type):
            self.callable = target(*args, **kwargs)
        else:
            self.callable = target
        self._inflight = 0
        self._deployment = deployment
        self._max_ongoing = int(max_ongoing)
        self._inflight_lock = threading.Lock()

    def handle_request(self, method: str, call: tuple):
        """Run ``method`` of the deployment on ``call``, an (args, kwargs)
        pair."""
        with self._inflight_lock:
            if self._max_ongoing and self._inflight >= self._max_ongoing:
                # Reject past the cap instead of queueing: the handle sees
                # ReplicaBusyError and re-picks — backpressure propagates
                # replica -> handle -> proxy instead of hiding in an
                # unbounded actor mailbox.
                raise ReplicaBusyError(
                    f"replica of {self._deployment!r} at in-flight cap "
                    f"({self._max_ongoing})")
            self._inflight += 1
        args, kwargs = call
        try:
            fn = self.callable if method == "__call__" else \
                getattr(self.callable, method)
            if not callable(fn):
                raise AttributeError(f"deployment has no method {method!r}")
            out = fn(*args, **kwargs)
            if inspect.isawaitable(out):
                # Replica methods run on pool threads (max_concurrency>1):
                # drive the coroutine on a fresh loop, not a thread-global.
                loop = asyncio.new_event_loop()
                try:
                    out = loop.run_until_complete(out)
                finally:
                    loop.close()
            return out
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def queue_len(self) -> int:
        return self._inflight

    def reconfigure(self, user_config) -> bool:
        hook = getattr(self.callable, "reconfigure", None)
        if hook is not None:
            hook(user_config)
        return True

    def check_health(self) -> bool:
        hook = getattr(self.callable, "check_health", None)
        if hook is not None:
            hook()
        return True


class ServeController:
    """Singleton named actor reconciling deployment specs to replicas."""

    CONTROLLER_NAME = "RTPU_SERVE_CONTROLLER"

    def __init__(self, http_port: int = 0):
        self.deployments: Dict[str, dict] = {}   # name -> spec
        self.replicas: Dict[str, List[Any]] = {}  # name -> RUNNING handles
        # DRAINING replicas: name -> [{"handle", "deadline", "zero_polls"}].
        # Out of the routing table (generation bumped when they leave
        # ``replicas``), killed once idle or past serve_drain_timeout_s.
        self._draining: Dict[str, List[dict]] = {}
        # Routing-table generation per deployment: bumped on ANY membership
        # change of the RUNNING list so handles detect staleness cheaply.
        self._generation: Dict[str, int] = {}
        # Replica lifecycle for the init-grace window: actor_id -> spawn
        # time; ids that have answered >=1 health ping.
        self._replica_started: Dict[Any, float] = {}
        self._replica_ready: set = set()
        self._lock = lockcheck.named_lock("serve.controller")
        # serializes reconcile passes (deploy() and the loop both enter;
        # the controller actor itself runs with max_concurrency > 1)
        self._reconcile_lock = lockcheck.named_lock("serve.reconcile")
        self._runtime = core_api._global_runtime()
        self._stop = threading.Event()
        self.http_port = http_port
        self.http_actor = None
        self._reconciler = threading.Thread(target=self._reconcile_loop,
                                            daemon=True,
                                            name="serve-reconciler")
        self._reconciler.start()

    # -- deployment management ------------------------------------------
    def deploy(self, name: str, target, init_args: tuple,
               num_replicas: int, ray_actor_options: dict,
               user_config=None, route_prefix: Optional[str] = None,
               max_concurrent_queries: int = 100,
               autoscaling: Optional[dict] = None,
               init_grace_s: float = 120.0,
               max_ongoing_requests: int = 0) -> bool:
        with self._lock:
            self.deployments[name] = {
                "name": name, "target": target, "init_args": init_args,
                "num_replicas": num_replicas,
                "ray_actor_options": ray_actor_options or {},
                "user_config": user_config,
                "route_prefix": route_prefix,
                "max_concurrent_queries": max_concurrent_queries,
                "autoscaling": autoscaling,
                "init_grace_s": init_grace_s,
                "max_ongoing_requests": max_ongoing_requests,
            }
        self._reconcile_once()
        return True

    @staticmethod
    def _resolved_max_ongoing(spec: dict) -> int:
        cap = int(spec.get("max_ongoing_requests") or 0)
        if cap <= 0:
            cap = int(config.get("serve_max_ongoing_requests"))
        return max(1, cap)

    def _bump_gen(self, name: str) -> None:
        self._generation[name] = self._generation.get(name, 0) + 1

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            self.deployments.pop(name, None)
        # Spec removed (route disappears at the next proxy refresh), then
        # replicas leave the routing table and drain instead of dying with
        # requests still on board.
        with self._reconcile_lock:
            current = self.replicas.pop(name, [])
            if current:
                self._bump_gen(name)
            for a in current:
                self._start_drain(name, a)
            self._drain_tick()
        return True

    def _start_drain(self, name: str, handle) -> None:
        self._draining.setdefault(name, []).append({
            "handle": handle,
            "deadline": time.time() + float(
                config.get("serve_drain_timeout_s")),
            "zero_polls": 0,
        })

    def _drain_tick(self) -> None:
        """Poll DRAINING replicas; kill the idle and the overdue ones."""
        for name in list(self._draining):
            keep = []
            for rec in self._draining[name]:
                done = time.time() > rec["deadline"]
                if not done:
                    try:
                        qlen = core_api.get(rec["handle"].queue_len.remote(),
                                            timeout=5)
                        # Two consecutive idle polls: a request the handle
                        # submitted just before the generation bump may not
                        # have STARTED yet (inflight still 0 in the gap
                        # between mailbox and execution).
                        rec["zero_polls"] = rec["zero_polls"] + 1 \
                            if qlen == 0 else 0
                        done = rec["zero_polls"] >= 2
                    except Exception:
                        done = True   # unreachable/dead: nothing to drain
                if done:
                    self._kill_replica(rec["handle"])
                else:
                    keep.append(rec)
            if keep:
                self._draining[name] = keep
            else:
                del self._draining[name]

    def _kill_replica(self, handle) -> None:
        try:
            core_api.kill(handle)
        except Exception:
            pass
        self._replica_started.pop(handle._rt_actor_id, None)
        self._replica_ready.discard(handle._rt_actor_id)

    def _actor_dead(self, handle) -> bool:
        """Authoritative liveness from the runtime's actor state — a
        replica that is DEAD must be replaced immediately even inside the
        init-grace window (a stuck ping is ambiguous; DEAD is not)."""
        return self._runtime.actor_dead(handle._rt_actor_id)

    def _spawn_replica(self, spec: dict):
        opts = dict(spec["ray_actor_options"])
        max_ongoing = self._resolved_max_ongoing(spec)
        cls = core_api.remote(Replica)
        handle = cls.options(
            num_cpus=opts.get("num_cpus", 1),
            num_gpus=opts.get("num_gpus", 0),
            resources=opts.get("resources", {}),
            # Concurrency must exceed the in-flight cap so the over-cap
            # rejection path can actually run (a saturated thread pool
            # would queue the probe call behind the work it should shed).
            max_concurrency=max(spec["max_concurrent_queries"],
                                max_ongoing + 2),
        ).remote(spec["target"], spec["init_args"], spec["name"],
                 max_ongoing)
        self._replica_started[handle._rt_actor_id] = time.time()
        if spec.get("user_config") is not None:
            # The reconfigure wait covers __init__ too, so its deadline is
            # the deployment's OWN init grace.
            core_api.get(handle.reconfigure.remote(spec["user_config"]),
                         timeout=float(spec.get("init_grace_s", 120.0)))
        return handle

    def _reconcile_once(self) -> None:
        with self._reconcile_lock:
            self._reconcile_locked()
            self._drain_tick()

    def _reconcile_locked(self) -> None:
        with self._lock:
            specs = dict(self.deployments)
        for name, spec in specs.items():
            current = self.replicas.setdefault(name, [])
            # Replace dead replicas (health check by ping). A replica whose
            # __init__ is still running answers nothing yet: give it an
            # initialization GRACE window before a failed ping is treated
            # as death.
            grace = float(spec.get("init_grace_s", 120.0))
            alive = []
            for a in current:
                try:
                    core_api.get(a.check_health.remote(), timeout=10)
                    self._replica_ready.add(a._rt_actor_id)
                    alive.append(a)
                except GetTimeoutError:
                    # ONLY a silent ping (no answer yet) earns the grace;
                    # a replica that ANSWERED with an error is unhealthy
                    # and replaced immediately (the except below).
                    started = self._replica_started.get(a._rt_actor_id, 0.0)
                    initializing = (a._rt_actor_id not in
                                    self._replica_ready and
                                    time.time() - started < grace and
                                    not self._actor_dead(a))
                    if initializing:
                        alive.append(a)   # still booting — keep waiting
                        continue
                    self._kill_replica(a)
                except Exception:
                    self._kill_replica(a)
            if len(alive) != len(current):
                self._bump_gen(name)
            current[:] = alive
            target = spec["num_replicas"]
            if len(current) != target:
                self._bump_gen(name)
            while len(current) < target:
                current.append(self._spawn_replica(spec))
            # Scale-down: newest replicas drain gracefully — they leave
            # the routing table NOW (generation bumped above) but keep
            # serving their in-flight requests until idle or the drain
            # deadline.
            while len(current) > target:
                self._start_drain(name, current.pop())
        # Lifecycle maps only ever track LIVE handles.
        live = {a._rt_actor_id for rs in self.replicas.values() for a in rs}
        live |= {rec["handle"]._rt_actor_id
                 for recs in self._draining.values() for rec in recs}
        for aid in [k for k in self._replica_started if k not in live]:
            self._replica_started.pop(aid, None)
        self._replica_ready &= live

    def _reconcile_loop(self) -> None:
        # Two cadences: drain polling is latency-sensitive (an idle
        # DRAINING replica should die within ~a second so scale-downs and
        # deletes settle fast), while full reconcile + autoscale carry
        # health-ping fan-out and stay coarse.
        tick = 0
        while not self._stop.wait(0.5):
            if core_api._runtime is not self._runtime:
                return   # the runtime that owns the replicas is gone
            tick += 1
            try:
                if tick % 4 == 0:
                    self._reconcile_once()   # includes a drain tick
                    self._autoscale()
                else:
                    with self._reconcile_lock:
                        self._drain_tick()
            except Exception:
                pass   # the next tick retries; a dead replica is replaced

    # -- autoscaling ------------------------------------------------------
    def _autoscale(self) -> None:
        """Queue-length autoscaling (parity: autoscaling_policy.py — scale
        to total_ongoing / target_ongoing_requests, clamped). Load is the
        sum of the replicas' ``queue_len``."""
        with self._lock:
            specs = dict(self.deployments)
        for name, spec in specs.items():
            cfg = spec.get("autoscaling")
            if not cfg:
                continue
            replicas = self.replicas.get(name, [])
            if not replicas:
                continue
            try:
                total = sum(core_api.get(
                    [r.queue_len.remote() for r in replicas], timeout=15))
            except Exception:
                continue
            target_ongoing = cfg.get("target_num_ongoing_requests", 2)
            desired = max(cfg.get("min_replicas", 1),
                          min(cfg.get("max_replicas", 10),
                              -(-int(total) // target_ongoing) or 1))
            if desired != spec["num_replicas"]:
                with self._lock:
                    if name in self.deployments:
                        self.deployments[name]["num_replicas"] = desired

    # -- routing ---------------------------------------------------------
    def get_routing(self, name: str) -> dict:
        """Routing view for handles: RUNNING replicas only (DRAINING ones
        are already gone), the table generation (staleness check), and the
        per-replica in-flight cap."""
        with self._lock:
            spec = self.deployments.get(name)
        max_ongoing = self._resolved_max_ongoing(spec) if spec else 0
        return {
            "replicas": list(self.replicas.get(name, [])),
            "generation": self._generation.get(name, 0),
            "max_ongoing": max_ongoing,
        }

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return {spec["route_prefix"] or f"/{name}": name
                    for name, spec in self.deployments.items()}

    def draining_count(self) -> int:
        return sum(len(v) for v in self._draining.values())

    def status(self) -> Dict[str, dict]:
        with self._lock:
            out = {name: {
                "num_replicas_target": spec["num_replicas"],
                "num_replicas_running": len(self.replicas.get(name, [])),
                "num_replicas_draining": len(self._draining.get(name, [])),
                "route_prefix": spec["route_prefix"],
            } for name, spec in self.deployments.items()}
        # Deleted deployments linger while replicas drain (their spec is
        # gone but the drain records are not) — status must show them
        # until they disappear for real.
        for name, recs in self._draining.items():
            if name not in out and recs:
                out[name] = {
                    "num_replicas_target": 0,
                    "num_replicas_running": 0,
                    "num_replicas_draining": len(recs),
                    "route_prefix": None,
                }
        return out

    def start_http(self, host: str, port: int) -> int:
        from ray_tpu_torch.serve.http_proxy import HTTPProxy
        if self.http_actor is None:
            cls = core_api.remote(HTTPProxy)
            self.http_actor = cls.options(
                num_cpus=0.5, max_concurrency=64).remote(host, port)
            self.http_port = core_api.get(self.http_actor.port.remote(),
                                          timeout=60)
        return self.http_port

    def http_stats(self) -> dict:
        if self.http_actor is None:
            return {}
        return core_api.get(self.http_actor.stats.remote(), timeout=30)

    def http_reconfigure(self, overrides: dict) -> dict:
        """Forward live config overrides to the proxy (value None clears);
        admission reads config at request time."""
        if self.http_actor is None:
            return {}
        return core_api.get(
            self.http_actor.reconfigure.remote(dict(overrides)), timeout=30)

    def graceful_shutdown(self) -> bool:
        self._stop.set()
        for name in list(self.deployments):
            self.delete_deployment(name)
        # Bounded wait for drains to settle, then force whatever is left.
        deadline = time.time() + 15.0
        while self.draining_count() and time.time() < deadline:
            time.sleep(0.2)
            with self._reconcile_lock:
                self._drain_tick()
        for recs in self._draining.values():
            for rec in recs:
                self._kill_replica(rec["handle"])
        self._draining.clear()
        if self.http_actor is not None:
            try:
                core_api.get(self.http_actor.close.remote(), timeout=60)
            except Exception:
                pass   # the kill below still takes the actor down
            try:
                core_api.kill(self.http_actor)
            except Exception:
                pass
            self.http_actor = None
        self._reconciler.join(timeout=30)
        return True
