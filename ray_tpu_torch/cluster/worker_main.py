"""Worker process: executes tasks and hosts actors.

Role parity: the core worker's execution half — HandlePushTask
(core_worker.cc:2925) -> ExecuteTask (:2525) -> the Python trampoline
(_raylet.pyx:718 execute_task), plus the receiver-side scheduling queues
(transport/actor_scheduling_queue.h: per-caller sequence-number ordering,
out-of-order mode for max_concurrency>1, asyncio actors standing in for the
boost::fiber loop of fiber.h) and the per-worker main loop
(default_worker.py:258 / core_worker_process.cc:63 RunTaskExecutionLoop).

One worker process == one lease at a time (normal tasks execute serially)
or one dedicated actor. Workers are also full API clients: user code running
here can submit nested tasks/actors through the same ClusterRuntime.
"""

from __future__ import annotations

import argparse
import asyncio
import inspect
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from ray_tpu_torch.cluster import fault_plane, object_client
from ray_tpu_torch.cluster.object_plane import ObjectPlane
from ray_tpu_torch.cluster.protocol import RpcServer, get_client
from ray_tpu_torch.core import serialization, task_spec
from ray_tpu_torch.core import refs as _refs_mod
from ray_tpu_torch.core.exceptions import (GetTimeoutError, ObjectLostError,
                                     TaskError)
from ray_tpu_torch.core.ids import ObjectID, TaskID, WorkerID, store_key
from ray_tpu_torch.util import events as _events


class _LazySealer:
    """Deferred store seal of reply-carried (inline) returns.

    The push reply carries the serialized result; the caller is already
    unblocked, so the store write is pure backstop work — it is what makes
    the object visible to remote pulls, wait(), and lineage reconstruction
    (the reference keeps small direct-call returns owner-memory-only; we
    diverge by sealing lazily so the rest of the object plane needs no
    special inline-object protocol). Runs on one background thread; a
    short defer lets the ack win the race to the wire and lets a burst of
    task results coalesce."""

    _DEFER_S = 0.001

    def __init__(self, plane: ObjectPlane):
        self.plane = plane
        self._q = deque()
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lazy-seal")
        self._thread.start()

    def enqueue(self, jobs) -> None:
        """jobs: iterable of (ObjectID, serialized blob)."""
        with self._cv:
            self._q.extend(jobs)
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._q:
                    self._cv.wait()
                jobs = list(self._q)
                self._q.clear()
            time.sleep(self._DEFER_S)
            batch = []
            for oid, blob in jobs:
                try:
                    # Fault point: the reply->seal gap. A "crash" rule here
                    # kills the worker AFTER the caller cached the value
                    # but BEFORE any store copy exists — the window where
                    # remote consumers must get a lost verdict (probe miss
                    # on the pre-registered location) and recover via
                    # lineage instead of hanging.
                    fault_plane.fire("task.return.seal", oid=oid.hex())
                    batch.append((oid, blob))
                except Exception:
                    pass  # fault rule raised: skip this seal
            try:
                # One pipelined store burst for the coalesced backlog
                # (every blob here is reply-sized, i.e. <= the inline cap).
                self.plane.put_blobs_inline(batch)
            except Exception:
                # Store gone (shutdown) or a mid-batch error: fall back to
                # per-object puts so one bad blob can't strand the rest.
                for oid, blob in batch:
                    try:
                        self.plane.put_blob(oid, blob)
                    except Exception:
                        pass
            if batch:
                _events.emit("inline.seal", value=float(len(batch)))


class TaskEventLog:
    """Buffered task-event shipping (parity: task_event_buffer.h:188)."""

    def __init__(self, conductor_address: str, node_id: bytes, pid: int):
        self._events = []
        self._lock = threading.Lock()
        self._cli = get_client(conductor_address)
        self._node_hex = node_id.hex()
        self._pid = pid
        self._flusher = threading.Thread(target=self._loop, daemon=True,
                                         name="task-event-flusher")
        self._flusher.start()

    def record(self, task_id: bytes, name: str, kind: str,
               start: float, end: float, error: str = "") -> None:
        with self._lock:
            self._events.append({
                "task_id": task_id.hex(), "name": name, "kind": kind,
                "start": start, "end": end, "node_id": self._node_hex,
                "pid": self._pid, "error": error,
            })

    def _loop(self) -> None:
        while True:
            time.sleep(1.0)
            self.flush()

    def flush(self) -> None:
        with self._lock:
            events, self._events = self._events, []
        if events:
            try:
                self._cli.call("push_task_events", events=events)
            except Exception:
                pass


class WorkerService:
    """The worker's RPC surface (tasks pushed directly by submitters)."""

    # Pipelined frames dispatch INLINE on the channel's reader thread
    # (protocol._Handler.handle) instead of through the per-connection
    # executor. Safe here — and only here — because every pipelined
    # caller of this service is strictly request-at-a-time per channel:
    # the task submitter keeps one in-flight push per leased worker, and
    # actor pushers serialize on seqno. Control frames that must never
    # queue behind a running task (ping, cancel_task, kill_actor) arrive
    # classic on separate connections. Conductor/daemon services must NOT
    # set this: their channels carry long-polls that would head-of-line
    # block everything behind them.
    rpc_inline_pipelined = True

    def __init__(self, conductor_address: str, daemon_address: str,
                 store_socket: str, store_prefix: str, node_id: bytes):
        self.worker_id = WorkerID.from_random()
        self.conductor_address = conductor_address
        self.daemon_address = daemon_address
        self.node_id = node_id
        self.store = object_client.ShmClient(store_socket, store_prefix)
        self.plane = ObjectPlane(self.store, node_id, conductor_address,
                                 daemon_address=daemon_address)
        self._sealer = _LazySealer(self.plane)
        self._ilim_gen = None       # inline-return limit, config-cached
        self._ilim_v = -1
        self._ftmo_gen = None       # arg-fetch timeout, config-cached
        self._ftmo_v = 30.0
        self.events = TaskEventLog(conductor_address, node_id, os.getpid())
        self._fn_cache: Dict[str, Any] = {}
        self._exec_lock = threading.Lock()   # serial normal-task execution
        self._cancelled: set = set()
        # --- actor state (one dedicated actor per worker) ---
        self.actor_id: Optional[bytes] = None
        self.actor_instance: Any = None
        self.actor_class_name = ""
        self.actor_is_async = False
        self.actor_max_concurrency = 1
        self.actor_loop: Optional[asyncio.AbstractEventLoop] = None
        self.actor_pool = None
        # per-caller ordering (parity: actor_scheduling_queue.h)
        self._seq_lock = threading.Lock()
        self._seq_cv = threading.Condition(self._seq_lock)
        self._next_seq: Dict[bytes, int] = {}
        self._active_calls = 0   # in-flight pushes; gates process recycling
        # Pins taken over from callers for not-yet-run enqueued actor work;
        # released on kill/exit so a dead actor doesn't leak its arguments.
        self._taken_pins: Dict[bytes, int] = {}
        # Resident compiled-graph loops (dag/compiled.py) keyed by graph id.
        self._cgraph_loops: Dict[bytes, Any] = {}
        self._cgraph_lock = threading.Lock()
        self._shutdown = threading.Event()
        # Orphan watchdog: a worker whose NODE DAEMON is gone (daemon
        # process SIGKILLed, chaos test, host teardown race) must exit
        # rather than linger — an orphan herd's doomed reconnect loops
        # measurably tax the host, and nothing will ever lease it again.
        threading.Thread(target=self._daemon_watchdog, daemon=True,
                         name="daemon-watchdog").start()

    def _daemon_watchdog(self) -> None:
        misses = 0
        while not self._shutdown.wait(5.0):
            try:
                get_client(self.daemon_address).call("ping", _timeout=5.0)
                misses = 0
            except Exception:
                misses += 1
                if misses >= 3:
                    os._exit(1)

    # ------------------------------------------------------------------
    def _load_fn(self, function_id: str, blob: Optional[bytes]):
        fn = self._fn_cache.get(function_id)
        if fn is None:
            if blob is None:
                from ray_tpu_torch import config
                blob = get_client(
                    self.conductor_address,
                    reconnect_s=config.get("gcs_rpc_reconnect_s")).call(
                    "get_function", function_id=function_id)
                if blob is None:
                    raise RuntimeError(
                        f"function {function_id} not found in function table")
            fn = serialization.loads(blob)
            self._fn_cache[function_id] = fn
        return fn

    def _fetch_timeout(self) -> float:
        # Bounded fetch: a dependency that was GC-freed or lost without
        # lineage must fail the task (visible to the caller) rather than
        # hang this worker forever. Cached against the config generation
        # (config.get walks os.environ; this sits on every task).
        from ray_tpu_torch import config
        if self._ftmo_gen != config.generation:
            self._ftmo_v = config.get("worker_fetch_timeout_s")
            self._ftmo_gen = config.generation
        return self._ftmo_v

    def _resolve(self, args_blob: bytes,
                 inline_args: Optional[dict] = None):
        args, kwargs = serialization.loads(args_blob)
        if not args and not kwargs:
            return args, kwargs
        timeout = self._fetch_timeout()

        def rv(ref):
            if inline_args:
                # In-spec small arg (submit-side inliner): the serialized
                # value rode the task spec — no store fetch, no pin.
                blob = inline_args.get(store_key(ref.id.binary()))
                if blob is not None:
                    return serialization.deserialize(memoryview(blob))
            try:
                return self.plane.get_value(ref.id, timeout=timeout)
            except GetTimeoutError:
                raise ObjectLostError(
                    ref.id.hex(), f"task argument unavailable after "
                    f"{timeout}s (freed or lost)") from None

        # Shared rule with the submit side (task_spec.top_level_ref_args):
        # only TOP-LEVEL ref args resolve by value.
        return task_spec.resolve_task_args(args, kwargs, rv)

    def _flush_refs(self) -> None:
        """Ship this process's pending refcount events to the conductor
        BEFORE acking a push RPC — the submitter releases its in-flight
        argument pins on the ack, so any +1 this execution produced (user
        code keeping a borrowed ref) must be in the ledger first
        (core/refcount.py ordering protocol)."""
        t = _refs_mod._tracker
        if t is not None:
            t.flush()

    def _inline_limit(self) -> int:
        """Reply-carried return size cap (-1 = feature off); cached against
        the config generation (this sits on every task return)."""
        from ray_tpu_torch import config
        if self._ilim_gen != config.generation:
            self._ilim_v = (int(config.get("max_inline_object_bytes"))
                            if config.get("task_inline_returns") else -1)
            self._ilim_gen = config.generation
        return self._ilim_v

    def _emit_return(self, oid: ObjectID, value: Any, collect) -> None:
        """Store one return value. With ``collect`` (reply-carried mode),
        results at or below max_inline_object_bytes ride the push reply as
        {"data": blob} entries and seal into the store lazily; larger ones
        seal now and reply {"stored": True}. collect=None keeps the
        classic store-now behavior (async/pool actor paths, whose acks
        predate execution)."""
        if collect is None:
            self.plane.put_value(oid, value)
            return
        limit = self._inline_limit()
        total, segments, refs = serialization.serialize_segments(value)
        if limit < 0 or total > limit:
            self.plane.put_segments(oid, total, segments, refs)
            collect.append({"stored": True})
            return
        blob = segments[0] if len(segments) == 1 else b"".join(segments)
        if refs:
            t = _refs_mod._tracker
            if t is not None:
                # flush=False: _flush_refs() runs before the ack AND before
                # the seal enqueue, so the children's +1s are durable
                # before the parent becomes readable anywhere — the same
                # invariant add_children's default sync flush upholds,
                # batched into one pre-ack RPC instead of one per return.
                t.add_children(self.plane._key(oid),
                               [store_key(r.id.binary()) for r in refs],
                               flush=False)
        # Fault point: the inlining decision (a "raise" rule fails the
        # task through the normal error path; see also task.return.seal).
        fault_plane.fire("task.reply.inline", oid=oid.hex())
        collect.append({"data": blob, "_oid": oid})

    def _store_returns(self, task_id: bytes, num_returns: int, result: Any,
                       collect=None):
        tid = TaskID(task_id)
        if num_returns == 1:
            self._emit_return(tid.object_id_for_return(0), result, collect)
            return
        vals = list(result)
        if len(vals) != num_returns:
            err = TaskError.from_exception(ValueError(
                f"Task declared num_returns={num_returns} but returned "
                f"{len(vals)} values"))
            if collect is not None:
                collect[:] = []
            for i in range(num_returns):
                self._emit_return(tid.object_id_for_return(i), err, collect)
            return
        for i, v in enumerate(vals):
            self._emit_return(tid.object_id_for_return(i), v, collect)

    def _fail_returns(self, task_id: bytes, num_returns: int, exc, desc: str,
                      collect=None):
        err = exc if isinstance(exc, TaskError) else TaskError.from_exception(
            exc, desc)
        tid = TaskID(task_id)
        for i in range(num_returns):
            try:
                self._emit_return(tid.object_id_for_return(i), err, collect)
            except BaseException:  # noqa: BLE001 - fallback error report; caller must unblock
                # The error object itself failed to serialize/store: fall
                # back to a bare TaskError so the caller still unblocks.
                self._emit_return(tid.object_id_for_return(i),
                                  TaskError(repr(err), desc), collect)

    def _queue_seals(self, per_task_entries) -> None:
        """Strip the private _oid markers from reply entries and hand the
        (oid, blob) pairs to the lazy sealer. Called AFTER _flush_refs():
        a remotely-readable (sealed) parent must never precede its
        children's durable +1s."""
        seals = []
        for entries in per_task_entries:
            for e in entries:
                oid = e.pop("_oid", None)
                if oid is not None:
                    seals.append((oid, e["data"]))
        if seals:
            self._sealer.enqueue(seals)

    # ------------------------------------------------------------------
    # normal tasks
    # ------------------------------------------------------------------
    def _exec_one(self, task_id: bytes, function_id: str,
                  function_blob: Optional[bytes], args_blob: bytes,
                  num_returns: int, name: str,
                  trace_ctx: Optional[dict] = None,
                  inline_args: Optional[dict] = None,
                  collect=None) -> None:
        """Execute one task body; returns are stored (or collected into the
        push reply) before this returns. Caller holds _exec_lock (serial
        normal-task execution)."""
        start = time.time()
        if task_id in self._cancelled:
            self._cancelled.discard(task_id)
            from ray_tpu_torch.core.exceptions import TaskCancelledError
            self._fail_returns(task_id, num_returns,
                               TaskCancelledError("task cancelled"), name,
                               collect)
            return
        error = ""
        try:
            # Fault point: mid-task kill. A "crash" rule here os._exit()s
            # between dequeue and result-store — the window where only
            # lineage reconstruction (or task retries) can save the caller.
            fault_plane.fire("worker.task.exec", name=name)
            fn = self._load_fn(function_id, function_blob)
            args, kwargs = self._resolve(args_blob, inline_args)
            result = fn(*args, **kwargs)
            self._store_returns(task_id, num_returns, result, collect)
        except BaseException as e:  # noqa: BLE001 - delivered via refs
            error = repr(e)
            # A partially-collected reply must not misalign the entry list
            # (one entry per return, in order).
            if collect is not None:
                collect[:] = []
            try:
                self._fail_returns(task_id, num_returns, e, name, collect)
            except BaseException:  # noqa: BLE001 - injected double fault
                if collect is not None:
                    collect[:] = []
        end = time.time()
        self.events.record(task_id, name, "task", start, end, error)
        _events.emit("task.exec", task_id.hex(), value=end - start,
                     attrs={"task": name, "error": error} if error
                     else {"task": name})
        if trace_ctx is not None:
            from ray_tpu_torch.util import tracing
            ctx = tracing.new_context(parent=trace_ctx)
            attrs = {"task": name, "worker_pid": os.getpid()}
            if error:
                attrs["error"] = error
            tracing.record("task.execute", start, end, ctx, attrs)

    def rpc_push_task(self, task_id: bytes, function_id: str,
                      function_blob: Optional[bytes], args_blob: bytes,
                      num_returns: int, name: str = "") -> dict:
        """Single-task compat shim over the batch path."""
        return self.rpc_push_task_batch([{
            "task_id": task_id, "function_id": function_id,
            "function_blob": function_blob, "args_blob": args_blob,
            "num_returns": num_returns, "name": name}])

    def rpc_push_task_batch(self, tasks: list) -> dict:
        """Execute a coalesced batch serially; one ack for all (the
        submitter batches deep queues — core/runtime_cluster.py _pump).
        The reply carries each task's small returns inline ({"data": blob}
        per return, in return order) — the caller seeds its object plane
        from them and never touches the store; the worker seals the same
        blobs lazily (_LazySealer) so the objects stay full citizens."""
        returns: Dict[bytes, list] = {}
        with self._exec_lock:
            for t in tasks:
                entries: list = []
                self._exec_one(t["task_id"], t["function_id"],
                               t.get("function_blob"), t["args_blob"],
                               t["num_returns"], t.get("name", ""),
                               trace_ctx=t.get("trace_ctx"),
                               inline_args=t.get("inline_args"),
                               collect=entries)
                returns[t["task_id"]] = entries
        self._flush_refs()
        self._queue_seals(returns.values())
        # Traced spans ship via the background event flusher (events.py) —
        # the old synchronous tracing.flush here put a conductor RPC on
        # every traced batch ack.
        return {"ok": True, "node_id": self.node_id, "returns": returns}

    def rpc_cancel_task(self, task_id: bytes) -> None:
        self._cancelled.add(task_id)

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    def rpc_create_actor(self, actor_id: bytes, spec: dict,
                         incarnation: int) -> dict:
        start = time.time()
        try:
            cls = self._load_fn(spec["function_id"], spec.get("class_blob"))
            args, kwargs = self._resolve(spec["args_blob"])
            instance = cls(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            import pickle
            try:
                blob = pickle.dumps(TaskError.from_exception(
                    e, spec.get("class_name", "") + ".__init__"))
            except Exception:
                blob = pickle.dumps(TaskError(repr(e), ""))
            get_client(self.conductor_address).call(
                "actor_creation_failed", actor_id=actor_id,
                incarnation=incarnation, error_blob=blob)
            return {"ok": False}
        self.actor_id = actor_id
        self.actor_instance = instance
        self.actor_class_name = spec.get("class_name", "")
        self.actor_is_async = spec.get("is_async", False)
        self.actor_max_concurrency = spec["opts"].get("max_concurrency", 1)
        if self.actor_is_async:
            self.actor_loop = asyncio.new_event_loop()
            threading.Thread(target=self.actor_loop.run_forever,
                             daemon=True, name="actor-loop").start()
        elif self.actor_max_concurrency > 1:
            from concurrent.futures import ThreadPoolExecutor
            self.actor_pool = ThreadPoolExecutor(
                max_workers=self.actor_max_concurrency,
                thread_name_prefix="actor")
        get_client(self.conductor_address).call(
            "actor_started", actor_id=actor_id, address=self.address,
            node_id=self.node_id, incarnation=incarnation)
        self.events.record(actor_id + b"\x00" * 4,
                           self.actor_class_name + ".__init__",
                           "actor_creation", start, time.time())
        return {"ok": True}

    def _wait_turn(self, caller_id: bytes, seqno: int) -> bool:
        """Block until this seqno's turn. Returns False for a duplicate:
        a caller that lost the push reply resends the same seqno, which by
        then has already executed (its returns are sealed in the store) —
        re-executing would double-apply side effects and waiting would
        deadlock (next_seq has moved past it)."""
        with self._seq_cv:
            while self._next_seq.get(caller_id, 0) < seqno:
                self._seq_cv.wait(1.0)
            return self._next_seq.get(caller_id, 0) == seqno

    def _done_turn(self, caller_id: bytes, seqno: int) -> None:
        with self._seq_cv:
            nxt = self._next_seq.get(caller_id, 0)
            if seqno >= nxt:
                self._next_seq[caller_id] = seqno + 1
            self._seq_cv.notify_all()

    def rpc_push_actor_task(self, task_id: bytes, caller_id: bytes,
                            seqno: int, method_name: str, args_blob: bytes,
                            num_returns: int,
                            arg_pins: Optional[list] = None,
                            actor_id: Optional[bytes] = None,
                            inline_args: Optional[dict] = None) -> dict:
        """Ordered actor call (per-caller seqno; see class docstring).
        ``actor_id`` guards against a stale address: a recycled worker may
        host a DIFFERENT actor at the address a slow caller cached, and a
        push for the dead tenant must fail, not hit the new instance."""
        if actor_id is not None and actor_id != self.actor_id:
            raise RuntimeError("actor no longer hosted on this worker "
                               "(stale address after recycle)")
        if self.actor_instance is None:
            raise RuntimeError("no actor hosted on this worker")
        with self._seq_lock:
            self._active_calls += 1
        try:
            return self._push_actor_task(task_id, caller_id, seqno,
                                         method_name, args_blob,
                                         num_returns, arg_pins, inline_args)
        finally:
            with self._seq_lock:
                self._active_calls -= 1

    def _push_actor_task(self, task_id: bytes, caller_id: bytes,
                         seqno: int, method_name: str, args_blob: bytes,
                         num_returns: int,
                         arg_pins: Optional[list] = None,
                         inline_args: Optional[dict] = None) -> dict:
        name = f"{self.actor_class_name}.{method_name}"
        start = time.time()
        error = ""

        def unpin_args():
            if not arg_pins:
                return
            t = _refs_mod._tracker
            if t is not None:
                t.unpin_all(arg_pins)
            with self._seq_lock:
                for k in arg_pins:
                    if self._taken_pins.get(k, 0) > 1:
                        self._taken_pins[k] -= 1
                    else:
                        self._taken_pins.pop(k, None)

        def run_sync(collect=None):
            err = ""
            if task_id in self._cancelled:
                # Cancelled before execution started (rt.cancel on an
                # actor-task ref — e.g. a serve deadline): store the
                # cancellation error, never run user code.
                self._cancelled.discard(task_id)
                from ray_tpu_torch.core.exceptions import TaskCancelledError
                self._fail_returns(task_id, num_returns,
                                   TaskCancelledError("actor task cancelled"),
                                   name, collect)
                return "cancelled"
            try:
                # Fault point: kill/fail mid-actor-task — after the seqno
                # turn was taken, before the result stores. Exercises the
                # restart FSM + max_task_retries resubmission. ``method``
                # is the bare method name (``name`` is module-qualified,
                # unwieldy for match filters).
                fault_plane.fire("worker.actor.exec", name=name,
                                 method=method_name)
                args, kwargs = self._resolve(args_blob, inline_args)
                m = getattr(self.actor_instance, method_name)
                result = m(*args, **kwargs)
                self._store_returns(task_id, num_returns, result, collect)
            except BaseException as e:  # noqa: BLE001
                err = repr(e)
                if collect is not None:
                    collect[:] = []
                try:
                    self._fail_returns(task_id, num_returns, e, name,
                                       collect)
                except BaseException:  # noqa: BLE001 - injected dbl fault
                    if collect is not None:
                        collect[:] = []
            return err

        def take_over_pins():
            """Enqueue-ack paths: the caller unpins its in-flight argument
            pins when this RPC returns, but execution happens later — take
            the pins over HERE (flushed before the ack) so the argument
            objects survive the gap (core/refcount.py ordering). Tracked in
            _taken_pins so a kill before execution releases them."""
            if not arg_pins:
                return
            t = _refs_mod._tracker
            if t is not None:
                t.pin_all(arg_pins)
            with self._seq_lock:
                for k in arg_pins:
                    self._taken_pins[k] = self._taken_pins.get(k, 0) + 1

        if self.actor_is_async:
            # Ordered start, concurrent awaits (parity: async actors).
            async def run_async():
                err = ""
                if task_id in self._cancelled:
                    self._cancelled.discard(task_id)
                    from ray_tpu_torch.core.exceptions import TaskCancelledError
                    self._fail_returns(
                        task_id, num_returns,
                        TaskCancelledError("actor task cancelled"), name)
                    unpin_args()
                    return "cancelled"
                try:
                    loop = asyncio.get_running_loop()
                    args, kwargs = await loop.run_in_executor(
                        None, lambda: self._resolve(args_blob, inline_args))
                    m = getattr(self.actor_instance, method_name)
                    result = m(*args, **kwargs)
                    if inspect.isawaitable(result):
                        result = await result
                    self._store_returns(task_id, num_returns, result)
                except BaseException as e:  # noqa: BLE001
                    err = repr(e)
                    self._fail_returns(task_id, num_returns, e, name)
                finally:
                    unpin_args()
                return err

            if not self._wait_turn(caller_id, seqno):
                return {"ok": True, "duplicate": True}
            take_over_pins()
            asyncio.run_coroutine_threadsafe(run_async(), self.actor_loop)
            self._done_turn(caller_id, seqno)
            # Ack on enqueue: concurrent awaits must overlap, so completion
            # is observed through the object store, not this reply.
            return {"ok": True, "enqueued": True}
        elif self.actor_pool is not None:
            # max_concurrency > 1: out-of-order execution is allowed
            # (parity: out_of_order_actor_scheduling_queue.h).
            if not self._wait_turn(caller_id, seqno):
                return {"ok": True, "duplicate": True}
            take_over_pins()

            def run_and_unpin():
                try:
                    run_sync()
                finally:
                    unpin_args()

            self.actor_pool.submit(run_and_unpin)
            self._done_turn(caller_id, seqno)
            return {"ok": True, "enqueued": True}
        else:
            # Sync actors ack AFTER execution, so the reply can carry the
            # small returns inline (same contract as push_task_batch); the
            # caller's call_async future completes with the value in hand.
            # enqueued/duplicate acks above carry NO returns — the caller
            # falls back to observing the store.
            if not self._wait_turn(caller_id, seqno):
                return {"ok": True, "duplicate": True}
            entries: list = []
            try:
                error = run_sync(entries)
            finally:
                self._done_turn(caller_id, seqno)
            self._flush_refs()
            self._queue_seals([entries])
        self.events.record(task_id, name, "actor_task", start, time.time(),
                           error)
        return {"ok": True, "node_id": self.node_id, "returns": entries}

    def _release_taken_pins(self) -> None:
        t = _refs_mod._tracker
        with self._seq_lock:
            pins, self._taken_pins = self._taken_pins, {}
        if t is not None and pins:
            for k, n in pins.items():
                t.unpin_all([k] * n)
            t.flush()

    def _recyclable(self) -> bool:
        """A process may be returned to the daemon's idle pool only when
        nothing of the dead actor can leak into the next tenant: sync-only
        (an event loop / thread pool may still be running user coroutines),
        and no push in flight."""
        from ray_tpu_torch import config
        if not config.get("actor_worker_recycle"):
            return False
        if self.actor_is_async or self.actor_pool is not None:
            return False
        with self._seq_lock:
            return self._active_calls == 0

    def _reset_actor_state(self) -> None:
        self._stop_cgraph_loops()   # loops hold the dying actor instance
        with self._seq_lock:
            self.actor_id = None
            self.actor_instance = None
            self.actor_class_name = ""
            self.actor_is_async = False
            self.actor_max_concurrency = 1
            self._next_seq.clear()   # new tenant's callers restart at seqno 0
            self._taken_pins.clear()
            self._cancelled.clear()
            self._seq_cv.notify_all()

    def rpc_kill_actor(self, actor_id: bytes) -> dict:
        if actor_id != self.actor_id:
            # Previous tenant (recycled away) or duplicate kill retry after
            # the state was already reset: nothing to do, and killing the
            # process now could take down an innocent new tenant.
            return {"ok": True, "stale": True}
        self.events.flush()
        self._stop_cgraph_loops()
        self._release_taken_pins()
        recycled = False
        if self._recyclable():
            # Reset BEFORE offering the process back: the daemon may hand
            # this worker to a new create_actor the instant it pools it.
            self._reset_actor_state()
            try:
                resp = get_client(self.daemon_address).call(
                    "actor_exited", actor_id=actor_id, recycle=True)
                recycled = bool(resp and resp.get("recycled"))
            except Exception:
                recycled = False
        else:
            try:
                get_client(self.daemon_address).call("actor_exited",
                                                     actor_id=actor_id)
            except Exception:
                pass
        if recycled:
            return {"ok": True, "recycled": True}
        self._shutdown.set()
        threading.Timer(0.1, lambda: os._exit(0)).start()
        return {"ok": True}

    def rpc_ping(self) -> str:
        return "pong"

    # -- compiled execution graphs (dag/compiled.py) ---------------------

    def rpc_install_cgraph_loop(self, graph_id: bytes, plan: dict) -> dict:
        """Install a resident compiled-graph loop on this actor worker.
        Creates the actor's input rings (consumer-side ownership) and
        starts the loop thread; normal .remote() task service continues to
        run alongside it."""
        if self.actor_instance is None:
            return {"ok": False, "error": "no actor hosted on this worker"}
        from ray_tpu_torch.dag.compiled import (CGraphWorkerLoop,
                                                ScheduledWorkerLoop)
        cls = (ScheduledWorkerLoop if plan.get("mode") == "schedule"
               else CGraphWorkerLoop)
        with self._cgraph_lock:
            if graph_id in self._cgraph_loops:
                return {"ok": True, "dup": True}
            loop = cls(self, graph_id, plan)
            self._cgraph_loops[graph_id] = loop
        loop.start()
        return {"ok": True}

    def rpc_teardown_cgraph_loop(self, graph_id: bytes) -> dict:
        with self._cgraph_lock:
            loop = self._cgraph_loops.pop(graph_id, None)
        if loop is None:
            return {"ok": True, "stale": True}
        loop.stop()
        return {"ok": True}

    def _stop_cgraph_loops(self) -> None:
        with self._cgraph_lock:
            loops, self._cgraph_loops = list(self._cgraph_loops.values()), {}
        for loop in loops:
            try:
                loop.stop(join_timeout=1.0)
            except Exception:
                pass

    def rpc_debug_state(self) -> dict:
        """Structured debug-state dump (the worker's share of raylet
        debug_state.txt: execution queues, actor tenancy, seal backlog)."""
        with self._seq_lock:
            active = self._active_calls
            taken_pins = len(self._taken_pins)
            ordered_callers = len(self._next_seq)
            actor_id = self.actor_id
        with self._sealer._cv:
            seal_backlog = len(self._sealer._q)
        return {
            "role": "worker",
            "worker_id": self.worker_id.binary().hex(),
            "node_id": self.node_id.hex(),
            "pid": os.getpid(),
            "actor": {
                "actor_id": actor_id.hex() if actor_id else None,
                "class_name": self.actor_class_name,
                "is_async": self.actor_is_async,
                "max_concurrency": self.actor_max_concurrency,
                "active_calls": active,
                "ordered_callers": ordered_callers,
                "taken_pins": taken_pins,
            },
            "cancelled_pending": len(self._cancelled),
            "cgraph_loops": [lp.debug_state()
                             for lp in self._cgraph_loops.values()],
            "fn_cache_entries": len(self._fn_cache),
            "lazy_seal_backlog": seal_backlog,
            "object_plane": self.plane.debug_state(),
        }

    def rpc_profile(self, duration_s: float = 1.0,
                    interval_s: float = 0.01) -> str:
        """On-demand sampling profile of this worker -> collapsed stacks
        (util/profiler.py; parity: reporter/profile_manager.py py-spy)."""
        from ray_tpu_torch.util.profiler import collect
        return collect(duration_s=min(float(duration_s), 30.0),
                       interval_s=max(float(interval_s), 0.001))

    def rpc_exit(self) -> dict:
        self._stop_cgraph_loops()
        self._release_taken_pins()
        self._shutdown.set()
        threading.Timer(0.05, lambda: os._exit(0)).start()
        return {"ok": True}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--conductor", required=True)
    ap.add_argument("--daemon", required=True)
    ap.add_argument("--store-socket", required=True)
    ap.add_argument("--store-prefix", required=True)
    ap.add_argument("--node-id", required=True)
    ap.add_argument("--token", required=True)
    args = ap.parse_args()
    # Adopt the parent's system-config overrides (RT_SYSTEM_CONFIG_JSON):
    # flag changes — including a loaded fault plan — follow the spawn.
    from ray_tpu_torch import config
    try:
        config.load_from_env()
    except Exception:
        pass  # an unknown flag from a mismatched parent must not kill boot
    prof = os.environ.get("RTPT_WORKER_STARTUP_PROF")
    marks = [("start", time.perf_counter())]
    node_id = bytes.fromhex(args.node_id)
    svc = WorkerService(args.conductor, args.daemon, args.store_socket,
                        args.store_prefix, node_id)
    marks.append(("service", time.perf_counter()))
    server = RpcServer(svc)
    svc.address = server.address
    marks.append(("rpc_server", time.perf_counter()))
    # Connect the in-process public API so user code can submit nested work.
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.runtime_cluster import ClusterRuntime
    marks.append(("runtime_import", time.perf_counter()))
    api._runtime = ClusterRuntime.for_worker(
        conductor_address=args.conductor, daemon_address=args.daemon,
        store=svc.store, plane=svc.plane, node_id=node_id)
    marks.append(("for_worker", time.perf_counter()))
    get_client(args.daemon).call(
        "register_worker", token=args.token,
        worker_id=svc.worker_id.binary(), address=server.address,
        pid=os.getpid())
    marks.append(("registered", time.perf_counter()))
    if prof:
        base = marks[0][1]
        print("STARTUP " + " ".join(
            f"{k}={1000 * (ts - base):.1f}ms" for k, ts in marks[1:]),
            flush=True)
    svc._shutdown.wait()
    try:
        svc.plane.stop()   # drain batched location registrations
    except Exception:
        pass


if __name__ == "__main__":
    main()
