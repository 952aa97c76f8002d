"""Public core API: init/shutdown/get/put/wait/remote and friends. Ported
from ``ray_tpu/core/api.py``.

Role parity: python/ray/_private/worker.py (init:1115, get:2405, put, wait)
and the @ray.remote decorator. The module holds the process-global runtime.

- ``init()`` starts a head in this process (a conductor and the head
  node's daemon, ``ClusterRuntime(address=None)``) and connects to it, as
  the JAX package's ``init()`` does: tasks and actors run in worker
  processes, objects live in the node's shm store, and the card counts as
  ``"GPU"``.
- ``init(address="host:port")`` connects a ``ClusterRuntime`` to a running
  conductor (a head started by ``init()``, by ``python -m ray_tpu_torch
  start --head`` or a ``cluster_utils.Cluster``).
- ``init(local_mode=True)`` and ``init(address="local")`` start the
  in-process runtime: actors are threads of this process.
- ``init("client://host:port")`` connects a ``ClientRuntime`` to a client
  proxy (``python -m ray_tpu_torch client-server``).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch import config
from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.actor import method as method  # re-export
from ray_tpu_torch.core.options import make_actor_options, make_task_options
from ray_tpu_torch.core.refs import ChannelResolvedRef, ObjectRef
from ray_tpu_torch.core.remote_function import RemoteFunction

_runtime = None
_runtime_lock = threading.Lock()


def init(address: Optional[str] = None, *,
         local_mode: bool = False,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: Optional[str] = None,
         _system_config: Optional[dict] = None,
         ignore_reinit_error: bool = False):
    """Start or connect this process's runtime.

    - ``address=None``: start a head (conductor and head node daemon) in
      this process and connect to it.
    - ``address="local"`` or ``local_mode=True``: the in-process thread
      runtime.
    - ``address="host:port"``: connect to an existing conductor.
    - ``address="client://host:port"``: a thin client over a client proxy.

    Nothing falls back to the in-process runtime: a head that cannot start,
    or a cluster or proxy that cannot be reached, raises.
    """
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            if ignore_reinit_error:
                return _runtime
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True to ignore.")
        if _system_config:
            config.set_system_config(_system_config)
        if local_mode or address == "local":
            from ray_tpu_torch.core.runtime_local import LocalRuntime
            _runtime = LocalRuntime(num_cpus=num_cpus, num_gpus=num_gpus,
                                    resources=resources)
        elif address and address.startswith("client://"):
            # Thin client over an in-cluster proxy (parity: ray://).
            from ray_tpu_torch.client.runtime import ClientRuntime
            _runtime = ClientRuntime(address, namespace=namespace)
        else:
            from ray_tpu_torch.core.runtime_cluster import ClusterRuntime
            _runtime = ClusterRuntime(address=address, num_cpus=num_cpus,
                                      num_gpus=num_gpus,
                                      resources=resources,
                                      namespace=namespace)
        return _runtime


def shutdown() -> None:
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def is_initialized() -> bool:
    return _runtime is not None


def in_process_runtime() -> bool:
    """Whether the API's runtime is the in-process one
    (``init(local_mode=True)``): actors are threads of this process, not
    worker processes. With no runtime yet it is False, as the head an
    implicit ``init()`` would start is not; asking starts none."""
    from ray_tpu_torch.core.runtime_local import LocalRuntime
    return isinstance(_runtime, LocalRuntime)


def _global_runtime():
    global _runtime
    if _runtime is None:
        # Implicit init (reference parity: ray.get before ray.init starts a
        # head) — but only from the MAIN thread. A background thread
        # reaching here is a straggler touching the API after shutdown();
        # silently booting a fresh head from it leaks a runtime the real
        # driver then trips over ("init called twice") and burns CPU behind
        # the user's back.
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "ray_tpu_torch is not initialized (implicit init is "
                "main-thread-only; was the API called from a background "
                "thread after shutdown()?)")
        init()
    return _runtime


# ---------------------------------------------------------------------------
# Object API
# ---------------------------------------------------------------------------

def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed.")
    return _global_runtime().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    single = isinstance(refs, ObjectRef)
    try:
        ref_list = [refs] if single else list(refs)
    except TypeError:
        raise TypeError(
            f"get() expects an ObjectRef or a sequence of ObjectRefs, got "
            f"{type(refs).__name__}") from None
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r).__name__}")
    if not any(isinstance(r, ChannelResolvedRef) for r in ref_list):
        values = _global_runtime().get(ref_list, timeout=timeout)
        return values[0] if single else values
    # Mixed/channel-resolved path: channel refs (serve's call refs) resolve
    # through their own subsystem; plain ones still go through the runtime
    # in one batch, under the same overall deadline.
    deadline = None if timeout is None else time.monotonic() + timeout

    def _left():
        if deadline is None:
            return None
        return max(0.0, deadline - time.monotonic())

    plain = [r for r in ref_list if not isinstance(r, ChannelResolvedRef)]
    plain_vals = iter(_global_runtime().get(plain, timeout=timeout)
                      if plain else [])
    values = [r._resolve(timeout=_left())
              if isinstance(r, ChannelResolvedRef) else next(plain_vals)
              for r in ref_list]
    return values[0] if single else values


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None,
         fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError(f"num_returns={num_returns} > len(refs)={len(refs)}")
    if len(set(refs)) != len(refs):
        raise ValueError("wait() requires a list of unique ObjectRefs.")
    if not any(isinstance(r, ChannelResolvedRef) for r in refs):
        return _global_runtime().wait(refs, num_returns, timeout)
    # Channel-resolved refs poll their subsystem (_is_ready); plain refs
    # keep the runtime's batched readiness check. Order within each output
    # list follows the input order (wait() contract).
    deadline = None if timeout is None else time.monotonic() + timeout
    rt = _global_runtime()
    plain = [r for r in refs if not isinstance(r, ChannelResolvedRef)]
    while True:
        ready_set = set()
        if plain:
            done, _ = rt.wait(plain, len(plain), 0.0)
            ready_set.update(done)
        for r in refs:
            if isinstance(r, ChannelResolvedRef) and r._is_ready():
                ready_set.add(r)
        if len(ready_set) >= num_returns or (
                deadline is not None and time.monotonic() >= deadline):
            ready = [r for r in refs if r in ready_set][:num_returns]
            chosen = set(ready)
            return ready, [r for r in refs if r not in chosen]
        time.sleep(0.001)   # the runtime's own wait polls at this cadence


async def _async_get(ref: ObjectRef):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, lambda: get(ref))


def _ref_future(ref: ObjectRef):
    import concurrent.futures
    fut: concurrent.futures.Future = concurrent.futures.Future()

    def run():
        try:
            fut.set_result(get(ref))
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True, name="rt-torch-ref-future").start()
    return fut


# ---------------------------------------------------------------------------
# remote decorator
# ---------------------------------------------------------------------------

def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_gpus=..., ...)`` for
    functions and classes."""
    if len(args) == 1 and not kwargs and callable(args[0]):
        return _make_remote(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")
    return lambda target: _make_remote(target, kwargs)


def _make_remote(target, opts: dict):
    if inspect.isclass(target):
        return ActorClass(target, make_actor_options(None, **opts))
    return RemoteFunction(target, make_task_options(None, **opts))


# ---------------------------------------------------------------------------
# Actors / control
# ---------------------------------------------------------------------------

def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    _global_runtime().kill_actor(actor, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    _global_runtime().cancel(ref, force=force)


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    return _global_runtime().get_actor(name, namespace)


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def nodes() -> List[dict]:
    return _global_runtime().nodes()


def cluster_resources() -> Dict[str, float]:
    return _global_runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    return _global_runtime().available_resources()


def timeline(filename: Optional[str] = None):
    """Dump a chrome://tracing timeline of task events (parity:
    python/ray/_private/state.py chrome_tracing_dump). The in-process
    runtime records none, so the list is empty."""
    rt = _global_runtime()
    events = getattr(rt, "timeline_events", lambda: [])()
    if filename:
        import json
        with open(filename, "w") as f:
            json.dump(events, f)
        return None
    return events


class RuntimeContext:
    def __init__(self, rt):
        self._rt = rt

    @property
    def job_id(self):
        return self._rt.job_id

    @property
    def node_id(self):
        return self._rt.node_id

    def get(self):  # legacy-style dict
        return {"job_id": self.job_id, "node_id": self.node_id}


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_global_runtime())
