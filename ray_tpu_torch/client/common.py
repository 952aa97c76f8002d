"""Client⇄proxy value codec. Ported from ``ray_tpu/client/common.py``.

Role parity: python/ray/util/client/client_pickler.py — values crossing the
client boundary are pickled with persistent-id hooks so ObjectRefs and
ActorHandles travel as small markers instead of live runtime objects. The
proxy side resolves markers against (and registers new refs into) the
session's pin table, which is what keeps client-held objects alive in the
cluster's distributed refcount while the thin client holds only ids.

Marker forms (the persistent id tuples):
  ("ref", oid_bytes, owner_str_or_None)
  ("actor", actor_id_bytes, class_name, methods_dict, is_async)

The pickler is the port's (``core/serialization.py``), where the JAX module
uses the stdlib's: a function or class inside a value goes by import path,
and a CUDA tensor is copied to the host first.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Callable, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.actor import ActorHandle
from ray_tpu_torch.core.ids import ActorID, ObjectID
from ray_tpu_torch.core.refs import ObjectRef


class _Pickler(serialization._Pickler):
    def __init__(self, file, persistent_id: Callable[[Any], Optional[tuple]]):
        super().__init__(file, buffer_callback=None)
        self._marker = persistent_id

    def persistent_id(self, obj):
        return self._marker(obj)


def dumps(obj: Any, persistent_id: Callable[[Any], Optional[tuple]]) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, persistent_id).dump(obj)
    return buf.getvalue()


def loads(data: bytes, persistent_load: Callable[[tuple], Any]) -> Any:
    up = pickle.Unpickler(io.BytesIO(data))
    up.persistent_load = persistent_load  # type: ignore[assignment]
    return up.load()


def marker_for(obj: Any) -> Optional[tuple]:
    """Shared persistent_id: handles → markers; everything else inline."""
    if isinstance(obj, ObjectRef):
        return ("ref", obj.id.binary(), obj.owner_address)
    if isinstance(obj, ActorHandle):
        return ("actor", obj.actor_id.binary(), obj._rt_class_name,
                obj._rt_method_options, obj._rt_is_async)
    return None


def handle_from_marker(pid: tuple) -> Any:
    """Shared persistent_load for processes with a live refs tracker: simply
    materialize the handle (ObjectRef.__init__ registers with the tracker)."""
    kind = pid[0]
    if kind == "ref":
        return ObjectRef(ObjectID(pid[1]), owner=pid[2])
    if kind == "actor":
        return ActorHandle(ActorID(pid[1]), pid[2], pid[3], pid[4])
    raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
