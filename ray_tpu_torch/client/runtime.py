"""Thin client runtime — ``init("client://host:port")``. Ported from
``ray_tpu/client/runtime.py``.

Role parity: python/ray/util/client/worker.py (Worker) + api.py — a driver
that holds NO cluster runtime: every operation is an RPC to a ClientProxy
(``ray_tpu_torch/client/server.py``) running inside the cluster. The public
API (@remote, .remote(), get/put/wait, actors) works unchanged because this
class implements the runtime interface ``ClusterRuntime`` does.

Ref lifetime: the proxy pins every ref that crosses the boundary in the
session table. Client-side, a lightweight tracker counts live ObjectRef
handles per oid and batches release RPCs when the last local handle drops —
the client half of the distributed refcount (reference role:
util/client/common.py ClientObjectRef __del__ → ReleaseObject).

A remote function or actor class goes to the proxy pickled by import path
(``core/serialization.py``), as it goes to worker processes (ROADMAP.md C,
"Callables go to worker processes by import path"): define it at module
level in a file the workers can import. A lambda, a closure or a function
of a ``python -c`` body raises the pickler's ``TypeError`` here, in the
client, before any RPC; the JAX client cloudpickles it.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.client import common
from ray_tpu_torch.cluster import protocol
from ray_tpu_torch.core import refs as refs_mod
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.core.refs import ObjectRef


class _ClientRefTracker:
    """Counts live local handles; ships batched releases to the proxy."""

    def __init__(self, release_fn):
        self._release = release_fn
        self._counts: Dict[bytes, int] = {}
        self._pending: List[bytes] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._flush_loop, daemon=True,
            name="rt-torch-client-ref-flush")
        self._thread.start()

    def handle_created(self, oid: bytes) -> None:
        with self._lock:
            self._counts[oid] = self._counts.get(oid, 0) + 1

    def handle_dropped(self, oid: bytes) -> None:
        with self._lock:
            n = self._counts.get(oid, 0) - 1
            if n > 0:
                self._counts[oid] = n
            else:
                self._counts.pop(oid, None)
                self._pending.append(oid)

    def drain(self) -> List[bytes]:
        with self._lock:
            batch, self._pending = self._pending, []
        return batch

    def _flush_loop(self) -> None:
        while not self._stop.wait(0.2):
            batch = self.drain()
            if batch:
                try:
                    self._release(batch)
                except Exception:
                    pass  # proxy gone; disconnect cleans up server-side

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


class ClientRuntime:
    """Runtime-interface implementation over the client proxy protocol."""

    def __init__(self, address: str, namespace: Optional[str] = None):
        if refs_mod._tracker is not None:
            # Checked BEFORE cp_connect so a refused init doesn't leak a
            # never-disconnected proxy session.
            raise RuntimeError(
                "client runtime cannot coexist with a cluster runtime "
                "in one process")
        if address.startswith("client://"):
            address = address[len("client://"):]
        self._proxy_addr = address
        self._client = protocol.RpcClient(address, reconnect_s=5.0)
        try:
            resp = self._client.call("cp_connect",
                                     meta={"namespace": namespace})
        except BaseException:  # noqa: BLE001 - close the client then re-raise
            self._client.close()
            raise
        if not resp.get("ok"):
            self._client.close()
            raise ConnectionError(resp.get("error", "client connect failed"))
        self._session = resp["session"]
        self.address = resp.get("address") or address
        self.namespace = namespace or resp.get("namespace") or ""
        self.job_id = f"client-{self._session}"
        self.node_id = None
        self._shutdown = False
        self._fn_blobs: Dict[str, bytes] = {}   # function_id -> blob
        self._tracker = _ClientRefTracker(self._release)
        refs_mod._tracker = self._tracker

    # -- plumbing ----------------------------------------------------------
    def _call(self, method: str, **kwargs) -> dict:
        resp = self._client.call(method, session=self._session, **kwargs)
        if resp.get("ok"):
            return resp
        exc = resp.get("exc")
        if exc is not None:
            try:
                # Unpickling can fail for cluster-only exception classes
                # (ModuleNotFoundError etc.) — fall back to the error string.
                e = pickle.loads(exc)
            except Exception:
                e = None
            if isinstance(e, BaseException):
                raise e
        raise protocol.RpcError(resp.get("error", "client call failed"))

    def _release(self, oids: List[bytes]) -> None:
        if not self._shutdown:
            self._client.call("cp_release", session=self._session, oids=oids)

    def _enc(self, obj: Any) -> bytes:
        return common.dumps(obj, common.marker_for)

    def _dec(self, blob: bytes) -> Any:
        return common.loads(blob, common.handle_from_marker)

    def _blob(self, desc, target) -> bytes:
        """``target`` pickled by import path, once per descriptor
        (``TypeError`` for a lambda, a closure or a ``-c`` body)."""
        blob = self._fn_blobs.get(desc.function_id)
        if blob is None:
            blob = self._fn_blobs.setdefault(desc.function_id,
                                             serialization.dumps(target))
        return blob

    @staticmethod
    def _sid() -> str:
        """Fresh submission id: lets the proxy dedupe a resend of the same
        logical call (at-least-once RPC delivery) without double-executing."""
        return os.urandom(8).hex()

    # -- objects -----------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        return self._dec(self._call("cp_put", blob=self._enc(value),
                                    put_id=self._sid())["ref"])

    def get(self, refs: List[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        oids = [r.id.binary() for r in refs]
        resp = self._call("cp_get", oids=oids, timeout=timeout,
                          _timeout=None if timeout is None else timeout + 30)
        return [self._dec(b) for b in resp["values"]]

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float] = None
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        by_oid = {r.id.binary(): r for r in refs}
        resp = self._call("cp_wait", oids=list(by_oid), num_returns=num_returns,
                          timeout=timeout)
        return ([by_oid[o] for o in resp["ready"]],
                [by_oid[o] for o in resp["not_ready"]])

    # -- tasks / actors ----------------------------------------------------
    def submit_task(self, desc, fn, args, kwargs, opts) -> List[ObjectRef]:
        blob = self._blob(desc, fn)
        resp = self._call("cp_task", desc=desc, blob=blob,
                          args_blob=self._enc((list(args), dict(kwargs))),
                          opts=opts, submission_id=self._sid())
        return self._dec(resp["refs"])

    def create_actor(self, desc, cls, args, kwargs, opts, methods,
                     is_async) -> ActorHandle:
        blob = self._blob(desc, cls)
        resp = self._call("cp_actor_create", desc=desc, blob=blob,
                          args_blob=self._enc((list(args), dict(kwargs))),
                          opts=opts, methods=methods, is_async=is_async,
                          submission_id=self._sid())
        return self._dec(resp["actor"])

    def submit_actor_task(self, handle: ActorHandle, method_name: str, args,
                          kwargs, opts) -> List[ObjectRef]:
        resp = self._call("cp_actor_task",
                          actor_id=handle._rt_actor_id.binary(),
                          method_name=method_name,
                          args_blob=self._enc((list(args), dict(kwargs))),
                          opts=opts, submission_id=self._sid())
        return self._dec(resp["refs"])

    def kill_actor(self, handle: ActorHandle, no_restart: bool = True) -> None:
        self._call("cp_actor_kill", actor_id=handle._rt_actor_id.binary(),
                   no_restart=no_restart)

    def get_actor(self, name: str, namespace: str = "") -> ActorHandle:
        resp = self._call("cp_get_actor", name=name,
                          namespace=namespace or self.namespace)
        return self._dec(resp["actor"])

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        self._call("cp_cancel", oid=ref.id.binary(), force=force)

    # -- introspection -----------------------------------------------------
    def _info(self, kind: str):
        return self._call("cp_cluster_info", kind=kind)["value"]

    def nodes(self) -> List[dict]:
        return self._info("nodes")

    def cluster_resources(self) -> Dict[str, float]:
        return self._info("cluster_resources")

    def available_resources(self) -> Dict[str, float]:
        return self._info("available_resources")

    def timeline_events(self) -> List[dict]:
        return self._info("timeline")

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        if refs_mod._tracker is self._tracker:
            refs_mod._tracker = None
        self._tracker.stop()
        # Final synchronous release so the proxy drops pins promptly.
        batch = self._tracker.drain()
        try:
            if batch:
                self._client.call("cp_release", session=self._session,
                                  oids=batch)
            self._client.call("cp_disconnect", session=self._session)
        except Exception:
            pass
        self._client.close()
