"""ObjectRef — the distributed future handle. Ported from
``ray_tpu/core/refs.py``.

Role parity: python/ray/includes/object_ref.pxi:38 — a typed handle to an
object; awaiting/getting goes through the process's runtime. Under the
cluster runtime refs are owner-tracked: the process that created the
object (by put or by task return) owns it and its reference count
(reference_count.h:61), through the ``_tracker`` hooks below.
``ChannelResolvedRef`` is copied: serve's call refs
(``serve/api.py:ServeCallRef``) resolve through it.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core.ids import ObjectID

# Installed by ClusterRuntime._finish_init; None under the in-process
# runtime / no runtime. Every ObjectRef created (including by
# deserialization in a borrowing worker) registers here, and deregisters
# on GC — the distributed refcount (reference_count.h:61) is driven
# entirely by these two hooks plus the submitter's explicit in-flight-arg
# pins (core/refcount.py).
_tracker = None

class ObjectRef:
    __slots__ = ("_id", "_owner", "_tracked", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional[str] = None):
        self._id = object_id
        # Owner address string ("host:port" of the owning worker/driver) —
        # lets any holder resolve the object's location via the owner.
        self._owner = owner
        t = _tracker
        self._tracked = t is not None
        if t is not None:
            t.handle_created(object_id.binary())

    def __del__(self):
        if self._tracked:
            t = _tracker
            if t is not None:
                try:
                    t.handle_dropped(self._id.binary())
                except Exception:
                    pass  # interpreter teardown

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


class ChannelResolvedRef(ObjectRef):
    """An ObjectRef whose value arrives through a subsystem resolver instead
    of the object table: serve's call refs, which retry a failed call on
    another replica (``serve/api.py:ServeCallRef``). get()/wait() dispatch
    to ``_resolve``/``_is_ready`` (core/api.py), so these refs compose with
    plain ones in the public API.
    """

    __slots__ = ()

    def __init__(self, object_id: ObjectID):
        # Deliberately skips the tracker hooks: a value delivered by its
        # subsystem has no store entry for the conductor ledger to count.
        self._id = object_id
        self._owner = None
        self._tracked = False

    def _resolve(self, timeout: Optional[float] = None):
        """Block until the value is available; return it (or raise the
        propagated error)."""
        raise NotImplementedError

    def _is_ready(self) -> bool:
        """Non-blocking readiness probe for wait()."""
        raise NotImplementedError

    def __reduce__(self):
        raise TypeError(
            "channel-resolved refs cannot be serialized; get() the value "
            "and pass that instead")
