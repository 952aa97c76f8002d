"""In-process runtime (local mode). Ported from
``ray_tpu/core/runtime_local.py``.

Executes tasks on a thread pool and actors on dedicated threads/event loops,
with an in-process object table. Semantics match the distributed runtime:
top-level ObjectRef args are resolved before execution, exceptions are
captured and re-raised at the get() site, actor calls are ordered per caller,
num_returns unpacking, named/detached actors.

Divergence (documented, same caveat as the reference's local mode): objects
are stored by reference, not serialized, so mutating an argument in a task
is visible to other holders, and a torch tensor comes back as the same
tensor on its device. Functions and actor classes are held by reference too
(nothing is pickled).

Where the port differs from the JAX module: the accelerator resource is
``"GPU"`` (``num_gpus``), and ``shutdown`` waits for the runtime's threads:
it fails every unresolved object, cancels queued calls, lets running ones
return and joins every task, actor and event-loop thread, so that no thread
of the runtime (and no actor holding CUDA tensors) outlives it.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
import concurrent.futures as futures
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch import config
from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.core.exceptions import (ActorDiedError, GetTimeoutError,
                                           RayTpuError, TaskError)
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch.core.options import ActorOptions, TaskOptions
from ray_tpu_torch.core.refs import ObjectRef
from ray_tpu_torch.core.task_spec import FunctionDescriptor, resolve_task_args

# Every thread the runtime starts is named with this prefix.
THREAD_PREFIX = "rt-torch"


class _ActorState:
    def __init__(self, actor_id: ActorID, instance: Any, opts: ActorOptions,
                 is_async: bool, methods: Dict[str, dict]):
        self.actor_id = actor_id
        self.instance = instance
        self.opts = opts
        self.is_async = is_async
        self.methods = methods
        self.dead = False
        self.death_reason = ""
        # ObjectIDs of in-flight calls, failed with ActorDiedError on kill.
        self.pending_returns: set = set()
        self.pending_lock = threading.Lock()
        name = f"{THREAD_PREFIX}-actor-{actor_id.hex()[:8]}"
        if is_async:
            self.loop = asyncio.new_event_loop()
            # the off-loop arg resolution runs here, on threads of our own
            self.args_pool = ThreadPoolExecutor(
                thread_name_prefix=f"{name}-args")
            self.loop.set_default_executor(self.args_pool)
            self.sem: Optional[asyncio.Semaphore] = None  # created on the loop
            self.thread = threading.Thread(
                target=self.loop.run_forever, daemon=True, name=name)
            self.thread.start()
            self.pool = None
        else:
            # One thread => per-actor call ordering; max_concurrency>1 uses a
            # wider pool (ordering then only guaranteed per method queue).
            self.pool = ThreadPoolExecutor(
                max_workers=max(1, opts.max_concurrency),
                thread_name_prefix=name)
            self.loop = None

    def stop(self) -> None:
        """Cancel queued calls and stop the loop; running calls go on."""
        if self.pool:
            self.pool.shutdown(wait=False, cancel_futures=True)
        if self.loop:
            self.loop.call_soon_threadsafe(self.loop.stop)

    def join(self) -> None:
        """Wait for the running calls, then for the threads to end."""
        if self.pool:
            self.pool.shutdown(wait=True)
        if self.loop:
            self.thread.join()
            self.args_pool.shutdown(wait=True)
            self.loop.close()
        self.instance = None


class LocalRuntime:
    """Single-process runtime backing the public API in local mode."""

    def __init__(self, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None):
        self.job_id = JobID.from_random()
        self.node_id = NodeID.from_random()
        self._objects: Dict[ObjectID, Future] = {}
        self._objects_lock = threading.Lock()
        # set by shutdown(): every object asked for from then on is failed
        self._closed_error: Optional[TaskError] = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, config.get("worker_pool_max_size")),
            thread_name_prefix=f"{THREAD_PREFIX}-task")
        self._actors: Dict[ActorID, _ActorState] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._fn_cache: Dict[str, Any] = {}
        self._lock = threading.Lock()
        import multiprocessing
        ncpu = num_cpus if num_cpus is not None else multiprocessing.cpu_count()
        ngpu = num_gpus if num_gpus is not None else 0
        self._total_resources = {"CPU": float(ncpu), **(resources or {})}
        if ngpu:
            self._total_resources["GPU"] = float(ngpu)
        self.address = "local"

    # ----- object table ---------------------------------------------------
    def _future_for(self, oid: ObjectID) -> Future:
        with self._objects_lock:
            fut = self._objects.get(oid)
            if fut is None:
                fut = Future()
                if self._closed_error is not None:
                    fut.set_result(self._closed_error)
                self._objects[oid] = fut
        return fut

    def _store(self, oid: ObjectID, value: Any) -> None:
        fut = self._future_for(oid)
        if fut.done():
            return  # lost the race with kill()/cancel() failing this object
        try:
            fut.set_result(value)
        except futures.InvalidStateError:
            pass

    def put(self, value: Any) -> ObjectRef:
        oid = ObjectID.from_random()
        self._store(oid, value)
        return ObjectRef(oid, owner=self.address)

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for ref in refs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            fut = self._future_for(ref.id)
            try:
                value = fut.result(timeout=remaining)
            except futures.TimeoutError:
                raise GetTimeoutError(
                    f"Get timed out after {timeout}s waiting for {ref}")
            if isinstance(value, TaskError):
                raise value
            out.append(value)
        return out

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            done = [r for r in refs if self._future_for(r.id).done()]
            if len(done) >= num_returns:
                ready = done[:num_returns]
                break
            if deadline is not None and time.monotonic() >= deadline:
                ready = done
                break
            time.sleep(0.001)
        ready_set = set(ready)
        return ready, [r for r in refs if r not in ready_set]

    # ----- task execution -------------------------------------------------
    def _resolve_args(self, args, kwargs):
        return resolve_task_args(args, kwargs,
                                 lambda ref: self.get([ref])[0])

    def _fn_from(self, desc: FunctionDescriptor, fn):
        return self._fn_cache.setdefault(desc.function_id, fn)

    def _store_returns(self, task_id: TaskID, num_returns: int, result: Any) -> None:
        oids = [task_id.object_id_for_return(i) for i in range(num_returns)]
        if num_returns == 1:
            self._store(oids[0], result)
        else:
            vals = list(result)
            if len(vals) != num_returns:
                err = TaskError.from_exception(
                    ValueError(f"Task declared num_returns={num_returns} but "
                               f"returned {len(vals)} values"))
                for oid in oids:
                    self._store(oid, err)
                return
            for oid, v in zip(oids, vals):
                self._store(oid, v)

    def submit_task(self, desc: FunctionDescriptor, fn, args, kwargs,
                    opts: TaskOptions) -> List[ObjectRef]:
        task_id = TaskID.from_random()
        num_returns = opts.num_returns
        fn = self._fn_from(desc, fn)

        def run():
            try:
                rargs, rkwargs = self._resolve_args(args, kwargs)
                result = fn(*rargs, **rkwargs)
                self._store_returns(task_id, num_returns, result)
            except BaseException as e:  # noqa: BLE001 - captured for the caller
                err = (e if isinstance(e, TaskError)
                       else TaskError.from_exception(e, desc.repr_name()))
                for i in range(num_returns):
                    self._store(task_id.object_id_for_return(i), err)

        self._pool.submit(run)
        return [ObjectRef(task_id.object_id_for_return(i), owner=self.address)
                for i in range(num_returns)]

    # ----- actors ---------------------------------------------------------
    def create_actor(self, desc: FunctionDescriptor, cls, args, kwargs,
                     opts: ActorOptions, methods: Dict[str, dict],
                     is_async: bool) -> ActorHandle:
        key = (opts.namespace or "default", opts.name)
        actor_id = ActorID.from_random()
        if opts.name:
            # Check-and-reserve under one lock so concurrent same-name
            # creations cannot both win.
            with self._lock:
                existing = self._named_actors.get(key)
                if existing is None:
                    self._named_actors[key] = actor_id
            if existing is not None:
                if opts.get_if_exists:
                    st = self._await_actor_state(existing)
                    return ActorHandle(existing, desc.repr_name(), st.methods,
                                       st.is_async)
                raise ValueError(f"Actor name {opts.name!r} already taken in "
                                 f"namespace {key[0]!r}")
        cls = self._fn_from(desc, cls)
        try:
            rargs, rkwargs = self._resolve_args(args, kwargs)
            instance = cls(*rargs, **rkwargs)
        except BaseException:  # noqa: BLE001 - undo name registration, then re-raised below
            if opts.name:
                with self._lock:
                    if self._named_actors.get(key) == actor_id:
                        del self._named_actors[key]
            raise
        state = _ActorState(actor_id, instance, opts, is_async, methods)
        with self._lock:
            self._actors[actor_id] = state
        return ActorHandle(actor_id, desc.repr_name(), methods, is_async)

    def _await_actor_state(self, actor_id: ActorID,
                           timeout: float = 30.0) -> _ActorState:
        """Wait for a reserved-but-still-constructing actor to appear.

        The name is reserved in _named_actors before the user __init__ runs,
        so a concurrent lookup can observe the reservation before the state
        is inserted into _actors.
        """
        deadline = time.monotonic() + timeout
        while True:
            st = self._actors.get(actor_id)
            if st is not None:
                return st
            if time.monotonic() >= deadline:
                raise ValueError("actor is still being constructed")
            time.sleep(0.001)

    def get_actor(self, name: str, namespace: str = "") -> ActorHandle:
        key = (namespace or "default", name)
        with self._lock:
            actor_id = self._named_actors.get(key)
            if actor_id is None:
                raise ValueError(f"No actor named {name!r} in namespace {key[0]!r}")
        st = self._await_actor_state(actor_id)
        return ActorHandle(actor_id, type(st.instance).__name__, st.methods,
                           st.is_async)

    def submit_actor_task(self, handle: ActorHandle, method_name: str, args,
                          kwargs, opts: TaskOptions) -> List[ObjectRef]:
        task_id = TaskID.from_random()
        num_returns = opts.num_returns
        state = self._actors.get(handle.actor_id)
        refs = [ObjectRef(task_id.object_id_for_return(i), owner=self.address)
                for i in range(num_returns)]
        if state is None or state.dead:
            reason = state.death_reason if state else "actor not found"
            err = TaskError.from_exception(
                ActorDiedError(handle._rt_class_name, reason))
            for r in refs:
                self._store(r.id, err)
            return refs

        with state.pending_lock:
            state.pending_returns.update(r.id for r in refs)

        def finish(store_fn):
            store_fn()
            with state.pending_lock:
                for r in refs:
                    state.pending_returns.discard(r.id)

        def run_sync():
            try:
                rargs, rkwargs = self._resolve_args(args, kwargs)
                m = getattr(state.instance, method_name)
                result = m(*rargs, **rkwargs)
                finish(lambda: self._store_returns(task_id, num_returns, result))
            except BaseException as e:  # noqa: BLE001
                finish(lambda: self._fail_returns(
                    task_id, num_returns, e,
                    f"{handle._rt_class_name}.{method_name}"))

        async def run_async():
            try:
                if state.sem is None:
                    state.sem = asyncio.Semaphore(
                        max(1, state.opts.max_concurrency))
                async with state.sem:
                    # Resolve refs off-loop: a blocking get() here would wedge
                    # the loop (and deadlock on refs this actor produces).
                    loop = asyncio.get_running_loop()
                    rargs, rkwargs = await loop.run_in_executor(
                        None, lambda: self._resolve_args(args, kwargs))
                    m = getattr(state.instance, method_name)
                    result = m(*rargs, **rkwargs)
                    if inspect.isawaitable(result):
                        result = await result
                finish(lambda: self._store_returns(task_id, num_returns, result))
            except BaseException as e:  # noqa: BLE001
                finish(lambda: self._fail_returns(
                    task_id, num_returns, e,
                    f"{handle._rt_class_name}.{method_name}"))

        try:
            if state.is_async:
                asyncio.run_coroutine_threadsafe(run_async(), state.loop)
            else:
                state.pool.submit(run_sync)
        except RuntimeError:
            # pool/loop shut down by a concurrent kill()
            state.dead = True
        # kill() may have drained pending_returns between our registration
        # and scheduling; make sure these refs resolve either way.
        if state.dead:
            err = TaskError.from_exception(
                ActorDiedError(handle._rt_class_name,
                               state.death_reason or "killed"))
            with state.pending_lock:
                for r in refs:
                    state.pending_returns.discard(r.id)
            for r in refs:
                fut = self._future_for(r.id)
                if not fut.done():
                    try:
                        fut.set_result(err)
                    except futures.InvalidStateError:
                        pass
        return refs

    def _fail_returns(self, task_id, num_returns, exc, desc):
        err = (exc if isinstance(exc, TaskError)
               else TaskError.from_exception(exc, desc))
        for i in range(num_returns):
            self._store(task_id.object_id_for_return(i), err)

    def kill_actor(self, handle: ActorHandle, no_restart: bool = True) -> None:
        state = self._actors.get(handle.actor_id)
        if state is None:
            return
        state.dead = True
        state.death_reason = "killed via kill()"
        state.stop()
        # Fail every in-flight call so holders of its refs don't hang.
        err = TaskError.from_exception(
            ActorDiedError(handle._rt_class_name, state.death_reason))
        with state.pending_lock:
            pending = list(state.pending_returns)
            state.pending_returns.clear()
        for oid in pending:
            fut = self._future_for(oid)
            if not fut.done():
                fut.set_result(err)
        with self._lock:
            self._named_actors = {k: v for k, v in self._named_actors.items()
                                  if v != handle.actor_id}

    # ----- misc -----------------------------------------------------------
    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        # Best-effort: running threads are not interrupted (parity caveat of
        # local mode); pending futures get a cancellation error.
        fut = self._future_for(ref.id)
        if not fut.done():
            fut.set_result(TaskError.from_exception(
                asyncio.CancelledError("task cancelled")))

    def cluster_resources(self) -> Dict[str, float]:
        return dict(self._total_resources)

    def available_resources(self) -> Dict[str, float]:
        return dict(self._total_resources)

    def nodes(self) -> List[dict]:
        return [{
            "NodeID": self.node_id.hex(),
            "Alive": True,
            "Resources": dict(self._total_resources),
            "address": self.address,
            "is_head": True,
        }]

    def shutdown(self) -> None:
        actors = list(self._actors.values())
        for st in actors:
            st.dead = True
            st.death_reason = st.death_reason or "runtime shut down"
            st.stop()
        # Wake every caller blocked on an object that will never be made
        # (a queued producer is cancelled below), and fail every object
        # asked for from now on, so running calls return.
        err = TaskError.from_exception(RayTpuError("runtime shut down"))
        with self._objects_lock:
            self._closed_error = err
            pending = [f for f in self._objects.values() if not f.done()]
        for fut in pending:
            try:
                fut.set_result(err)
            except futures.InvalidStateError:
                pass
        self._pool.shutdown(wait=True, cancel_futures=True)
        for st in actors:
            st.join()
        self._actors.clear()
        self._named_actors.clear()
        self._fn_cache.clear()
        self._objects.clear()
