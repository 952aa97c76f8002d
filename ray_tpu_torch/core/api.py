"""Public core API: init/shutdown/get/put/wait/remote and friends. Ported
from ``ray_tpu/core/api.py``.

Role parity: python/ray/_private/worker.py (init:1115, get:2405, put, wait)
and the @ray.remote decorator. The module holds the process-global runtime.
The port has the in-process runtime only: ``init()`` and
``init(local_mode=True)`` start it, where the JAX package's ``init()``
tries its cluster runtime first. An address (``"host:port"``,
``client://``) raises ``NotImplementedError``: the cluster and client
runtimes are still to port (ROADMAP.md A.5).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch import config
from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.actor import method as method  # re-export
from ray_tpu_torch.core.options import make_actor_options, make_task_options
from ray_tpu_torch.core.refs import ObjectRef
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
    """Start this process's runtime.

    - ``address=None``, ``address="local"`` or ``local_mode=True``: the
      in-process thread runtime.
    - any other address raises ``NotImplementedError``; nothing falls back
      to the in-process runtime.
    """
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            if ignore_reinit_error:
                return _runtime
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True to ignore.")
        if address not in (None, "local") and not local_mode:
            raise NotImplementedError(
                f"ray_tpu_torch.init(address={address!r}): the port has the "
                "in-process runtime only; the cluster and client runtimes "
                "are still to port (ROADMAP.md A.5). Call init() or "
                "init(local_mode=True).")
        if _system_config:
            config.set_system_config(_system_config)
        from ray_tpu_torch.core.runtime_local import LocalRuntime
        _runtime = LocalRuntime(num_cpus=num_cpus, num_gpus=num_gpus,
                                resources=resources)
        return _runtime


def shutdown() -> None:
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None


def is_initialized() -> bool:
    return _runtime is not None


def _global_runtime():
    global _runtime
    if _runtime is None:
        # Implicit init (reference parity: ray.get before ray.init starts a
        # runtime) — but only from the MAIN thread. A background thread
        # reaching here is a straggler touching the API after shutdown();
        # silently booting a fresh runtime from it leaks a runtime the real
        # driver then trips over ("init called twice").
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
    values = _global_runtime().get(ref_list, timeout=timeout)
    return values[0] if single else values


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None,
         fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError(f"num_returns={num_returns} > len(refs)={len(refs)}")
    if len(set(refs)) != len(refs):
        raise ValueError("wait() requires a list of unique ObjectRefs.")
    return _global_runtime().wait(refs, num_returns, timeout)


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
