"""Strongly-typed binary IDs. Ported from ``ray_tpu/core/ids.py``.

Role parity: src/ray/common/id.h — every entity (object, task, actor, node,
worker, job, placement group) gets a fixed-width random ID with a typed
wrapper so they cannot be mixed up.
"""

from __future__ import annotations

import hashlib
import itertools
import os

# Per-(process, type) id generator state: (pid, random prefix, counter).
# The pid is part of the state so a forked child (worker zygote) re-rolls
# its prefix instead of colliding with the parent's sequence.
_id_state: dict = {}


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes",)

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}")
        self._bytes = binary

    @classmethod
    def from_random(cls):
        # blake2b(process nonce + counter) instead of a urandom syscall
        # per id (~15us each — measurable on the submit hot path; the
        # short hash is ~1us). Same uniqueness story as the reference's
        # ids (id.h: a unique-per-process component plus an index), but
        # hashed so every BYTE of the id is pseudorandom — subsystems
        # truncate ids (e.g. the store prefix uses node_id[:4]), and a
        # raw nonce+counter layout would make all ids minted by one
        # process collide under truncation.
        pid = os.getpid()
        st = _id_state.get(cls)
        if st is None or st[0] != pid:
            st = _id_state[cls] = (pid, os.urandom(16), itertools.count(1))
        return cls(hashlib.blake2b(
            st[1] + next(st[2]).to_bytes(8, "little"),
            digest_size=cls.SIZE).digest())

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self):
        return hash((type(self).__name__, self._bytes))

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    SIZE = 20


class TaskID(BaseID):
    SIZE = 16

    def object_id_for_return(self, index: int) -> ObjectID:
        """Deterministically derive the i-th return ObjectID of this task."""
        return ObjectID(self._bytes + index.to_bytes(4, "little"))


class ActorID(BaseID):
    SIZE = 12


class NodeID(BaseID):
    SIZE = 12


class WorkerID(BaseID):
    SIZE = 12


class JobID(BaseID):
    SIZE = 8


class PlacementGroupID(BaseID):
    SIZE = 12


_sk_cache: dict = {}


def store_key(oid_binary: bytes) -> bytes:
    """16-byte shm-store / directory key for a 20-byte ObjectID.

    Every subsystem that names an object outside this process (shm store,
    conductor object directory, reference ledger) uses this one mapping.
    Memoized: hot paths map the same oid several times per task (pending
    marks, seeds, ref events); the cache is bounded and simply cleared
    when full (a pure function needs no eviction order).
    """
    k = _sk_cache.get(oid_binary)
    if k is None:
        if len(_sk_cache) >= 8192:
            _sk_cache.clear()
        k = _sk_cache[oid_binary] = hashlib.blake2b(
            oid_binary, digest_size=16).digest()
    return k
