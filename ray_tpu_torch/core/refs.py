"""ObjectRef — the distributed future handle. Ported from
``ray_tpu/core/refs.py``.

Role parity: python/ray/includes/object_ref.pxi:38 — a typed handle to an
object; awaiting/getting goes through the process's runtime. The JAX
package's reference-count hooks and channel-resolved refs belong to its
cluster runtime and compiled graphs, which the port does not have yet.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core.ids import ObjectID


class ObjectRef:
    __slots__ = ("_id", "_owner", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional[str] = None):
        self._id = object_id
        # Owner address string: the runtime that created the object.
        self._owner = owner

    @property
    def id(self) -> ObjectID:
        return self._id

    @property
    def owner_address(self) -> Optional[str]:
        return self._owner

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self):
        return hash(self._id)

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        return (ObjectRef, (self._id, self._owner))

    def __await__(self):
        from ray_tpu_torch.core.api import _async_get
        return _async_get(self).__await__()

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        from ray_tpu_torch.core.api import _ref_future
        return _ref_future(self)
