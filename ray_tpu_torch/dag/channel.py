"""Compiled-graph channels: rings of preallocated shm slots. Ported from
``ray_tpu/dag/channel.py``: the same header and slot layout, flags and
nonce guard, in segments of the port's store (``rtpt-`` names). The port's
channel keys carry their own marker (``CHANNEL_KEY_MARK`` below), so that
neither package's leak probe counts the other's live rings when both run
on one host.

Role parity: python/ray/experimental/channel/shared_memory_channel.py —
a single-producer single-consumer ring of ``nslots`` fixed-size slots
backed by one named shm segment. The segment is a regular store object
(created + sealed through the node's shmstored, so hygiene, accounting
and same-host attach-by-path all reuse the r08/r09 machinery), but its
contents are MUTABLE after seal: both endpoints map the segment
read-write and synchronize through per-slot state bytes plus header
seq/ack counters — no futex, no store round trip, no RPC on the steady
path.

Slot protocol (one writer, one reader, execution ``seq`` maps to slot
``seq % nslots``):

    writer: spin/sleep until slot state == EMPTY   (ring backpressure)
            write seq, flags, len, payload
            state = FULL        (single-byte store publishes the slot)
            header.write_seq += 1
    reader: spin/sleep until slot state == FULL
            copy payload out
            state = EMPTY       (ack frees the slot for seq + nslots)
            header.ack_seq += 1

The payload is written before the one-byte state store that publishes
it, which is ordered on every architecture CPython runs the store on
(the reader only dereferences the payload after observing FULL).

Cross-host channels keep the same reader-side ring: the writer sends
``channel_write`` frames over the pipelined RPC layer to the READER
host's node daemon, whose channel forwarder attaches the local segment
and performs the shm write (large payloads ride the r08 zero-copy
out-of-band frame path).

The reader CREATES its segment (channels are owned by their consumer);
writers attach by store key with a bounded retry, so install order at
compile time does not matter.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional, Tuple

# 4-byte ascii marker prefixing every channel's 16-byte store key: makes
# channel segments recognizable in /dev/shm (hex "43475054") for the
# teardown-hygiene leak check without touching data-object names. The JAX
# package's marker is b"CGCH", and its probe globs every store prefix.
CHANNEL_KEY_MARK = b"CGPT"

_MAGIC = b"RTCH\x01\x00\x00\x00"
_HDR = 64                 # magic(8) nslots(4) slot_bytes(4) wseq(8) aseq(8) closed(1) pad(7) nonce(8)
_OFF_NSLOTS = 8
_OFF_SLOT_BYTES = 12
_OFF_WRITE_SEQ = 16
_OFF_ACK_SEQ = 24
_OFF_CLOSED = 32
_OFF_NONCE = 40

_SLOT_HDR = 16            # state(1) flags(1) pad(2) len(4) seq(8)
_EMPTY = 0
_FULL = 1

# slot flags
FLAG_POISON = 1           # payload is a serialized error; the graph unwinds
FLAG_SPILL = 2            # payload is a 20-byte ObjectID (value > slot_bytes)
FLAG_ARRAY = 4            # payload is an RTAR array blob (r16): the reader
                          # rebuilds the value as an ndarray view with no
                          # pickle program on either side
FLAG_SHARED = 8           # with FLAG_SPILL: several channels read the
                          # object, so no reader deletes it

_SPIN = 64                # polls before the first sleep


class ChannelError(RuntimeError):
    """Channel-layer failure (sever, closed ring, attach/write deadline)."""


class ChannelTimeout(ChannelError):
    """A bounded channel wait expired."""


def make_channel_id() -> bytes:
    """Mint a 16-byte channel store key (CGCH marker + 12 random bytes)."""
    return CHANNEL_KEY_MARK + os.urandom(12)


def _poll_sleep_s() -> float:
    from ray_tpu_torch import config
    return max(1, int(config.get("cgraph_poll_us"))) / 1e6


def ring_bytes(nslots: int, slot_bytes: int) -> int:
    return _HDR + nslots * (_SLOT_HDR + slot_bytes)


def _slot_off(idx: int, slot_bytes: int) -> int:
    return _HDR + idx * (_SLOT_HDR + slot_bytes)


class _Ring:
    """Shared slot arithmetic over one writable mapping."""

    def __init__(self, mv: memoryview, nslots: int, slot_bytes: int,
                 nonce: Optional[bytes] = None):
        self.mv = mv
        self.nslots = nslots
        self.slot_bytes = slot_bytes
        # Writer-side identity check: the nonce captured at attach time.
        # If the store recycles the segment file for a NEW ring while an
        # old writer still holds a mapping, the old writer's next write
        # would silently corrupt the new ring — the fresh nonce turns that
        # into a deterministic ChannelError instead.
        self.nonce = nonce

    def closed(self) -> bool:
        return self.mv[_OFF_CLOSED] != 0

    def mark_closed(self) -> None:
        self.mv[_OFF_CLOSED] = 1

    def counters(self) -> Tuple[int, int]:
        wseq = struct.unpack_from("<Q", self.mv, _OFF_WRITE_SEQ)[0]
        aseq = struct.unpack_from("<Q", self.mv, _OFF_ACK_SEQ)[0]
        return wseq, aseq

    def _wait_state(self, off: int, want: int, deadline: Optional[float],
                    stop) -> None:
        mv = self.mv
        for _ in range(_SPIN):
            if mv[off] == want:
                return
        sleep_s = _poll_sleep_s()
        while mv[off] != want:
            if self.closed():
                raise ChannelError("channel closed by peer")
            if stop is not None and stop.is_set():
                raise ChannelError("channel shut down")
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeout(
                    f"channel slot wait expired ({'FULL' if want else 'EMPTY'})")
            time.sleep(sleep_s)

    def write(self, seq: int, payload, flags: int,
              deadline: Optional[float], stop=None) -> None:
        # ``payload`` may be a list/tuple of buffer parts (r16 array
        # values: [header, raw array buffer, pad]) — written back to back
        # into the slot, so an array travels writer-memory -> slot in ONE
        # copy with no intermediate join.
        parts = payload if isinstance(payload, (list, tuple)) else (payload,)
        views = [memoryview(p) for p in parts]
        nbytes = sum(v.nbytes for v in views)
        if nbytes > self.slot_bytes:
            raise ChannelError(
                f"payload {nbytes}B exceeds slot capacity "
                f"{self.slot_bytes}B (raise cgraph_slot_bytes)")
        if self.nonce is not None and \
                bytes(self.mv[_OFF_NONCE:_OFF_NONCE + 8]) != self.nonce:
            raise ChannelError(
                "channel segment recycled under this writer "
                "(ring nonce mismatch — stale attach)")
        if self.closed():
            # _wait_state only notices `closed` while polling; an EMPTY
            # slot would otherwise accept a write into a ring whose reader
            # already left (and whose segment may be deleted).
            raise ChannelError("channel closed by peer")
        off = _slot_off(seq % self.nslots, self.slot_bytes)
        self._wait_state(off, _EMPTY, deadline, stop)
        mv = self.mv
        struct.pack_into("<Q", mv, off + 8, seq)
        struct.pack_into("<I", mv, off + 4, nbytes)
        mv[off + 1] = flags
        cur = off + _SLOT_HDR
        for v in views:
            mv[cur:cur + v.nbytes] = v
            cur += v.nbytes
        mv[off] = _FULL    # publish: the payload stores precede this byte
        struct.pack_into("<Q", mv, _OFF_WRITE_SEQ,
                         struct.unpack_from("<Q", mv, _OFF_WRITE_SEQ)[0] + 1)

    def peek(self, seq: int) -> bool:
        """Non-destructive readiness probe: is ``seq``'s slot published?"""
        off = _slot_off(seq % self.nslots, self.slot_bytes)
        mv = self.mv
        return (mv[off] == _FULL and
                struct.unpack_from("<Q", mv, off + 8)[0] == seq)

    def read(self, seq: int, deadline: Optional[float],
             stop=None) -> Tuple[bytes, int]:
        off = _slot_off(seq % self.nslots, self.slot_bytes)
        self._wait_state(off, _FULL, deadline, stop)
        mv = self.mv
        got_seq = struct.unpack_from("<Q", mv, off + 8)[0]
        if got_seq != seq:
            raise ChannelError(
                f"slot sequence mismatch: expected {seq}, found {got_seq}")
        ln = struct.unpack_from("<I", mv, off + 4)[0]
        flags = mv[off + 1]
        # Copy out before the ack: the slot is reused for seq + nslots the
        # instant the writer observes EMPTY.
        blob = bytes(mv[off + _SLOT_HDR:off + _SLOT_HDR + ln])
        mv[off] = _EMPTY
        struct.pack_into("<Q", mv, _OFF_ACK_SEQ,
                         struct.unpack_from("<Q", mv, _OFF_ACK_SEQ)[0] + 1)
        return blob, flags


def _map_rw(path: str) -> memoryview:
    import mmap
    fd = os.open(path, os.O_RDWR)
    try:
        size = os.fstat(fd).st_size
        mm = mmap.mmap(fd, size)
    finally:
        os.close(fd)
    return memoryview(mm)


class ShmChannelReader:
    """Consumer endpoint; creates (and owns) the ring segment."""

    def __init__(self, store, chan_id: bytes, nslots: int, slot_bytes: int):
        self.store = store
        self.chan_id = chan_id
        total = ring_bytes(nslots, slot_bytes)
        mv = store.create(chan_id, total)
        mv[:_HDR] = b"\x00" * _HDR
        # The store may hand back a RECYCLED segment: stale slot headers
        # would read as FULL/POISON slots. Zero every slot header too.
        for i in range(nslots):
            off = _slot_off(i, slot_bytes)
            mv[off:off + _SLOT_HDR] = b"\x00" * _SLOT_HDR
        mv[0:8] = _MAGIC
        struct.pack_into("<I", mv, _OFF_NSLOTS, nslots)
        struct.pack_into("<I", mv, _OFF_SLOT_BYTES, slot_bytes)
        mv[_OFF_NONCE:_OFF_NONCE + 8] = os.urandom(8)   # ring identity
        store.seal(chan_id)   # visibility barrier: writers may now attach
        # Hold a store reference for the channel's lifetime so eviction /
        # recycling cannot unlink a live ring (released in close()).
        self._pinned = store.get(chan_id, timeout=5.0) is not None
        self.ring = _Ring(mv, nslots, slot_bytes)
        self._closed = False

    def read(self, seq: int, timeout: Optional[float] = None,
             stop=None) -> Tuple[bytes, int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        return self.ring.read(seq, deadline, stop)

    def ready(self, seq: int) -> bool:
        return self.ring.peek(seq)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.ring.mark_closed()   # wake blocked writers with ChannelError
        except Exception:
            pass
        try:
            if self._pinned:
                self.store.release(self.chan_id)
        except Exception:
            pass
        try:
            self.store.delete(self.chan_id)
        except Exception:
            pass


class ShmChannelWriter:
    """Same-host producer endpoint; attaches the reader-created segment."""

    def __init__(self, store, chan_id: bytes,
                 attach_timeout: Optional[float] = None):
        from ray_tpu_torch import config
        self.store = store
        self.chan_id = chan_id
        timeout = (config.get("cgraph_attach_timeout_s")
                   if attach_timeout is None else attach_timeout)
        deadline = time.monotonic() + timeout
        self._pinned = False
        while True:
            # The store get doubles as the attach barrier (sealed == header
            # initialized) and as the lifetime pin.
            view = store.get(chan_id, timeout=max(0.05, deadline -
                                                  time.monotonic()))
            if view is not None:
                self._pinned = True
                break
            if time.monotonic() > deadline:
                raise ChannelTimeout(
                    f"channel {chan_id.hex()} not created within {timeout}s")
        mv = _map_rw(store._shm_path(chan_id))
        if bytes(mv[0:8]) != _MAGIC:
            raise ChannelError(f"bad channel magic for {chan_id.hex()}")
        nslots = struct.unpack_from("<I", mv, _OFF_NSLOTS)[0]
        slot_bytes = struct.unpack_from("<I", mv, _OFF_SLOT_BYTES)[0]
        self.ring = _Ring(mv, nslots, slot_bytes,
                          nonce=bytes(mv[_OFF_NONCE:_OFF_NONCE + 8]))
        self._closed = False

    def write(self, seq: int, payload, flags: int = 0,
              timeout: Optional[float] = None, stop=None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        self.ring.write(seq, payload, flags, deadline, stop)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._pinned:
                self.store.release(self.chan_id)
        except Exception:
            pass


class RpcChannelWriter:
    """Cross-host producer endpoint: ships slots to the reader host's node
    daemon, whose channel forwarder performs the local shm write. Rides
    the PIPELINED path of the shared pooled client — consecutive slot
    writes overlap on one socket, payloads ≥ the out-of-band threshold go
    as zero-copy iovec segments, and a severed channel fails every
    in-flight write fast (single-attempt: a channel write retried blind
    could double-fill a ring slot)."""

    def __init__(self, chan_id: bytes, daemon_address: str):
        from ray_tpu_torch.cluster.protocol import get_client
        self.chan_id = chan_id
        self.daemon_address = daemon_address
        self._cli = get_client(daemon_address)
        self._closed = False

    def write(self, seq: int, payload, flags: int = 0,
              timeout: Optional[float] = None, stop=None) -> None:
        from ray_tpu_torch import config
        from ray_tpu_torch.cluster.protocol import oob
        if timeout is None:
            timeout = config.get("cgraph_write_timeout_s")
        if isinstance(payload, (list, tuple)):
            # Multi-part array payloads join here: the RPC frame needs one
            # contiguous out-of-band segment (the remote forwarder's shm
            # write is the single data copy either way).
            payload = b"".join(memoryview(p).cast("B") if not
                               isinstance(p, (bytes, bytearray)) else p
                               for p in payload)
        try:
            fut = self._cli.call_async(
                "channel_write", chan_id=self.chan_id, seq=seq,
                data=oob(payload), flags=flags, timeout=timeout)
            resp = fut.result(timeout=timeout + 10.0)
        except ChannelError:
            raise
        except Exception as e:
            raise ChannelError(
                f"cross-host channel write failed: {e!r}") from e
        if not resp or not resp.get("ok"):
            raise ChannelError(
                f"channel forwarder rejected write: {resp!r}")

    def sever(self) -> None:
        """Honors a fault-plane "sever" action: kill the underlying RPC
        connection so in-flight and subsequent writes fail fast."""
        try:
            self._cli.sever_pipe()
        except Exception:
            pass

    def close(self, notify: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        if notify:
            try:
                self._cli.call("channel_close", chan_id=self.chan_id,
                               _timeout=5.0)
            except Exception:
                pass


def leaked_segments(prefixes=None) -> list:
    """Paths of the port's compiled-graph channel segments still present in
    /dev/shm (``rtpt-`` store prefixes only; with ``prefixes``, only those
    stores' segments) — the teardown-hygiene gate's probe."""
    import glob
    found = glob.glob(f"/dev/shm/rtpt-*{CHANNEL_KEY_MARK.hex()}*")
    if prefixes is not None:
        found = [f for f in found
                 if any(os.path.basename(f).startswith(p) for p in prefixes)]
    return sorted(found)
