"""Client proxy server — remote drivers without a full runtime. Ported from
``ray_tpu/client/server.py``.

Role parity: python/ray/util/client/server/server.py (RayletServicer) — the
reference's "Ray client" runs a gRPC proxy inside the cluster; thin clients
drive the cluster through it. Here the proxy wraps a full ``ClusterRuntime``
driver connection and exposes a small simple-typed RPC surface over the
standard frame protocol, for the thin Python client
(``ray_tpu_torch/client/runtime.py``, ``init("client://host:port")``).

Sessions pin every ObjectRef/ActorHandle that crosses the boundary in a
per-session table (the cluster-side anchor for the distributed refcount,
reference role: util/client/server/server.py object ownership); clients
release ids explicitly (batched) and everything drops on disconnect.

Every RPC returns a plain dict ``{"ok": bool, ...}`` and never raises;
Python clients get the original exception back via ``exc`` (pickled) for
faithful re-raise.

Where the port differs: a task's function or an actor's class arrives as
the client's blob, pickled by import path (``core/serialization.py``), and
goes on to the workers as it came. The proxy never loads it, so it never
imports the client's code; its descriptor is keyed on the blob's hash, as
the JAX package keys a function on its cloudpickle's.

A task or an actor may instead name its target as ``import_path=
"pkg.module:attr"`` (what a client in another language sends, such as the
JAX package's C++ worker API). The proxy imports that target, pickles it
as the port's serializer pickles any module-level callable, and from there
on treats it as a client's blob: the workers receive what a Python client
would have sent them.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import pickle
import threading
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.client import common
from ray_tpu_torch.cluster.protocol import RpcServer
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.ids import ActorID, ObjectID
from ray_tpu_torch.core.options import (ActorOptions, TaskOptions,
                                        make_actor_options, make_task_options)
from ray_tpu_torch.core.refs import ObjectRef
from ray_tpu_torch.core.task_spec import FunctionDescriptor


def _blob_descriptor(desc: FunctionDescriptor, blob: bytes
                     ) -> FunctionDescriptor:
    """The client's descriptor keyed on the blob: its id names an object of
    the client's process, which two clients can share."""
    return FunctionDescriptor(function_id=hashlib.sha1(blob).hexdigest(),
                              module=desc.module, qualname=desc.qualname)


def _import_path(path: str):
    """Resolve "pkg.module:attr" (cross-language task/actor target)."""
    import importlib
    mod_name, _, attr = path.partition(":")
    if not attr:
        raise ValueError(f"import path {path!r} must be 'module:attr'")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _import_path_blob(path: str):
    """(target, desc, blob) for ``path``: the target behind an ``@remote``
    wrapper, pickled by import path as a Python client pickles it."""
    target = serialization._unwrap(_import_path(path))
    return (target, FunctionDescriptor.for_callable(target),
            serialization.dumps(target))


class _Session:
    def __init__(self, session_id: str, meta: dict):
        self.id = session_id
        self.meta = meta
        self.refs: Dict[bytes, ObjectRef] = {}
        self.actors: Dict[bytes, ActorHandle] = {}
        # submission_id -> cached response (or in-progress Event): makes
        # cp_put/cp_task/cp_actor_create/cp_actor_task idempotent under the
        # RPC layer's at-least-once delivery (a retried submission whose
        # reply was lost must not mint a second object / run the task
        # twice). The Event covers the race where the retry arrives while
        # the original is STILL EXECUTING: the duplicate blocks until the
        # first attempt's response is recorded. Bounded FIFO.
        self.seen: Dict[str, Any] = {}
        self._settled: "deque[str]" = deque()  # eviction order, O(1)
        self.lock = threading.Lock()

    def begin(self, submission_id: Optional[str]
              ) -> Tuple[Optional[dict], bool]:
        """-> (cached_response, is_owner). Owner executes and must record();
        a duplicate waits for the owner's response and replays it."""
        if submission_id is None:
            return None, True
        with self.lock:
            cur = self.seen.get(submission_id)
            if cur is None:
                self.seen[submission_id] = threading.Event()
                return None, True
        if isinstance(cur, threading.Event):
            cur.wait(timeout=600.0)
            with self.lock:
                cur = self.seen.get(submission_id)
            if isinstance(cur, threading.Event) or cur is None:
                return {"ok": False,
                        "error": "duplicate submission still in progress"}, \
                    False
        return cur, False

    def record(self, submission_id: Optional[str], resp: dict) -> dict:
        if submission_id is not None:
            with self.lock:
                prev = self.seen.get(submission_id)
                self.seen[submission_id] = resp
                self._settled.append(submission_id)
                # Evict oldest settled entries; pending Events are never in
                # _settled and so survive until their owner records.
                while len(self.seen) > 4096 and self._settled:
                    old = self._settled.popleft()
                    if not isinstance(self.seen.get(old), threading.Event):
                        self.seen.pop(old, None)
            if isinstance(prev, threading.Event):
                prev.set()
        return resp

    def clear(self) -> None:
        with self.lock:
            self.refs.clear()
            self.actors.clear()


class ClientProxy:
    """Serves ``rpc_cp_*`` methods; one instance per hosting driver, whose
    runtime is a ``ClusterRuntime``."""

    def __init__(self, runtime, host: str = "127.0.0.1", port: int = 0):
        self._rt = runtime
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()
        self._server = RpcServer(self, host=host, port=port)
        self.address = self._server.address

    def stop(self) -> None:
        with self._lock:
            sessions, self._sessions = dict(self._sessions), {}
        for s in sessions.values():
            s.clear()
        self._server.stop()

    # -- session codec -----------------------------------------------------
    def _session(self, session: str) -> _Session:
        s = self._sessions.get(session)
        if s is None:
            raise KeyError(f"unknown client session {session!r}")
        return s

    def _enc(self, s: _Session, obj: Any) -> bytes:
        def pid(o):
            m = common.marker_for(o)
            if m is not None and m[0] == "ref":
                with s.lock:
                    s.refs.setdefault(m[1], o)   # pin for the client
            elif m is not None and m[0] == "actor":
                with s.lock:
                    s.actors.setdefault(m[1], o)
            return m
        return common.dumps(obj, pid)

    def _dec(self, s: _Session, blob: bytes) -> Any:
        def pload(pid):
            kind = pid[0]
            if kind == "ref":
                with s.lock:
                    ref = s.refs.get(pid[1])
                    if ref is None:
                        # Ref minted by another session/driver: materialize
                        # (registers with this driver's tracker) and pin.
                        ref = ObjectRef(ObjectID(pid[1]), owner=pid[2])
                        s.refs[pid[1]] = ref
                return ref
            if kind == "actor":
                with s.lock:
                    h = s.actors.get(pid[1])
                    if h is None:
                        h = ActorHandle(ActorID(pid[1]), pid[2], pid[3],
                                        pid[4])
                        s.actors[pid[1]] = h
                return h
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        return common.loads(blob, pload)

    def _refs_of(self, s: _Session, oids: List[bytes]) -> List[ObjectRef]:
        with s.lock:
            return [s.refs.get(oid) or ObjectRef(ObjectID(oid))
                    for oid in oids]

    @staticmethod
    def _fail(e: BaseException) -> dict:
        try:
            exc = pickle.dumps(e, protocol=5)
        except Exception:
            exc = None
        return {"ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc(), "exc": exc}

    def _guarded(self, session: str, body) -> dict:
        """Session lookup around ``body(s) -> resp``; a failure becomes the
        ``{"ok": False}`` reply."""
        try:
            return body(self._session(session))
        except BaseException as e:  # noqa: BLE001
            return self._fail(e)

    def _idempotent(self, session: str, submission_id: Optional[str],
                    body) -> dict:
        """Session lookup + begin/record dedupe around ``body(s) -> resp``.
        Failures are recorded too: a retried submission replays the
        original attempt's error instead of executing a second time."""
        try:
            s = self._session(session)
        except BaseException as e:  # noqa: BLE001
            return self._fail(e)
        cached, owner = s.begin(submission_id)
        if not owner:
            return cached
        try:
            resp = body(s)
        except BaseException as e:  # noqa: BLE001
            resp = self._fail(e)
        return s.record(submission_id, resp)

    # -- lifecycle ---------------------------------------------------------
    def rpc_cp_connect(self, meta: Optional[dict] = None) -> dict:
        session_id = os.urandom(8).hex()
        with self._lock:
            self._sessions[session_id] = _Session(session_id, meta or {})
        return {"ok": True, "session": session_id,
                "address": getattr(self._rt, "address", None),
                "namespace": getattr(self._rt, "namespace", "")}

    def rpc_cp_disconnect(self, session: str) -> dict:
        with self._lock:
            s = self._sessions.pop(session, None)
        if s is not None:
            s.clear()
        return {"ok": True}

    def rpc_cp_release(self, session: str, oids: List[bytes]) -> dict:
        def body(s):
            with s.lock:
                for oid in oids:
                    s.refs.pop(oid, None)
            return {"ok": True}
        return self._guarded(session, body)

    # -- objects -----------------------------------------------------------
    def rpc_cp_put(self, session: str, blob: bytes,
                   put_id: Optional[str] = None) -> dict:
        def body(s):
            ref = self._rt.put(self._dec(s, blob))
            return {"ok": True, "ref": self._enc(s, ref)}
        return self._idempotent(session, put_id, body)

    def rpc_cp_get(self, session: str, oids: List[bytes],
                   timeout: Optional[float] = None) -> dict:
        def body(s):
            vals = self._rt.get(self._refs_of(s, oids), timeout=timeout)
            return {"ok": True, "values": [self._enc(s, v) for v in vals]}
        return self._guarded(session, body)

    def rpc_cp_wait(self, session: str, oids: List[bytes], num_returns: int,
                    timeout: Optional[float] = None) -> dict:
        def body(s):
            ready, rest = self._rt.wait(self._refs_of(s, oids),
                                        num_returns=num_returns,
                                        timeout=timeout)
            return {"ok": True,
                    "ready": [r.id.binary() for r in ready],
                    "not_ready": [r.id.binary() for r in rest]}
        return self._guarded(session, body)

    # -- tasks -------------------------------------------------------------
    def rpc_cp_task(self, session: str, desc: Optional[FunctionDescriptor],
                    blob: Optional[bytes], args_blob: bytes,
                    opts: Optional[TaskOptions] = None,
                    import_path: Optional[str] = None,
                    submission_id: Optional[str] = None) -> dict:
        def body(s):
            d, b = desc, blob
            if import_path is not None:
                _, d, b = _import_path_blob(import_path)
            topts = (opts if isinstance(opts, TaskOptions)
                     else make_task_options(None, **(opts or {})))
            args, kwargs = self._dec(s, args_blob)
            refs = self._rt.submit_task(_blob_descriptor(d, b), b,
                                        args, kwargs, topts)
            return {"ok": True, "refs": self._enc(s, refs)}
        return self._idempotent(session, submission_id, body)

    # -- actors ------------------------------------------------------------
    def rpc_cp_actor_create(self, session: str,
                            desc: Optional[FunctionDescriptor],
                            blob: Optional[bytes], args_blob: bytes,
                            opts: Optional[ActorOptions] = None,
                            methods: Optional[dict] = None,
                            is_async: bool = False,
                            import_path: Optional[str] = None,
                            submission_id: Optional[str] = None) -> dict:
        def body(s):
            d, b, m, asy = desc, blob, methods, is_async
            if import_path is not None:
                cls, d, b = _import_path_blob(import_path)
                m = ActorClass._scan_methods(cls)
                asy = any(inspect.iscoroutinefunction(getattr(cls, name))
                          for name in m)
            aopts = (opts if isinstance(opts, ActorOptions)
                     else make_actor_options(None, **(opts or {})))
            args, kwargs = self._dec(s, args_blob)
            handle = self._rt.create_actor(_blob_descriptor(d, b), b, args,
                                           kwargs, aopts, m or {}, asy)
            return {"ok": True, "actor": self._enc(s, handle)}
        return self._idempotent(session, submission_id, body)

    def rpc_cp_actor_task(self, session: str, actor_id: bytes,
                          method_name: str, args_blob: bytes,
                          opts: Optional[TaskOptions] = None,
                          submission_id: Optional[str] = None) -> dict:
        def body(s):
            with s.lock:
                handle = s.actors.get(actor_id)
            if handle is None:
                raise ValueError(
                    f"actor {actor_id.hex()[:8]} not known to this session")
            topts = (opts if isinstance(opts, TaskOptions)
                     else make_task_options(None, **(opts or {})))
            args, kwargs = self._dec(s, args_blob)
            refs = self._rt.submit_actor_task(handle, method_name, args,
                                              kwargs, topts)
            return {"ok": True, "refs": self._enc(s, refs)}
        return self._idempotent(session, submission_id, body)

    def rpc_cp_actor_kill(self, session: str, actor_id: bytes,
                          no_restart: bool = True) -> dict:
        def body(s):
            with s.lock:
                handle = s.actors.get(actor_id)
            if handle is None:
                handle = ActorHandle(ActorID(actor_id), "", {}, False)
            self._rt.kill_actor(handle, no_restart=no_restart)
            return {"ok": True}
        return self._guarded(session, body)

    def rpc_cp_get_actor(self, session: str, name: str,
                         namespace: str = "") -> dict:
        return self._guarded(session, lambda s: {
            "ok": True,
            "actor": self._enc(s, self._rt.get_actor(name, namespace))})

    def rpc_cp_cancel(self, session: str, oid: bytes,
                      force: bool = False) -> dict:
        def body(s):
            self._rt.cancel(self._refs_of(s, [oid])[0], force=force)
            return {"ok": True}
        return self._guarded(session, body)

    # -- cluster introspection --------------------------------------------
    _INFO = ("nodes", "cluster_resources", "available_resources")

    def rpc_cp_cluster_info(self, session: str, kind: str) -> dict:
        try:
            if kind == "timeline":
                return {"ok": True, "value": self._rt.timeline_events()}
            if kind not in self._INFO:
                raise ValueError(f"unknown cluster_info kind {kind!r}")
            return {"ok": True, "value": getattr(self._rt, kind)()}
        except BaseException as e:  # noqa: BLE001
            return self._fail(e)


def serve_proxy(address: Optional[str] = None, host: str = "127.0.0.1",
                port: int = 0) -> ClientProxy:
    """Start a proxy, connecting a driver runtime to ``address`` if this
    process hasn't already got one (CLI: ``python -m ray_tpu_torch
    client-server``)."""
    from ray_tpu_torch.core import api
    if api.is_initialized():
        rt = api._global_runtime()
    else:
        rt = api.init(address=address)
    return ClientProxy(rt, host=host, port=port)
