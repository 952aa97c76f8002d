"""Client for the shmstore daemon (``cluster/native/shmstore.cc``, the
port's own copy of the JAX package's ``native/shmstore/shmstore.cc``).

Zero-copy reads: the daemon backs each object with a POSIX shm segment; the
client mmaps /dev/shm/<prefix><oid> directly and hands out memoryviews, so a
100 GiB numpy array is never copied through a socket (parity with the
reference's plasma get path, reference core_worker.cc:1307 -> plasma mmap).

Write path: puts go through pwrite() into the shm file between CREATE and
SEAL (plasma's create->write->seal, reference plasma/store.h:55) — on tmpfs
a syscall write into fresh pages is ~2.5x faster than a first-touch mmap
store (no per-page zero-fill fault storm), and into daemon-recycled pages
it is a straight memcpy.

Ref lifetime: `get_pinned` holds the store-side reference until the LAST
user view of the mapping is garbage collected (weakref.finalize on the
mmap), which is what makes the daemon's page recycling safe — a numpy array
backed by the mapping pins the object exactly like a plasma buffer pins its
arena slice. Releases are queued and piggybacked on the next store call
(finalizers may fire at arbitrary GC points where taking the socket lock
could deadlock or interleave frames).

Thread-safe: one lock around the request/response socket; data-plane reads
go straight to shared memory without holding it.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import socket
import struct
import subprocess
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

OP_CREATE, OP_SEAL, OP_GET, OP_RELEASE, OP_DELETE, OP_CONTAINS, OP_STATS, \
    OP_LIST, OP_GET_COPY, OP_PUT_INLINE, OP_GET_COPY_BATCH, \
    OP_CONTAINS_BATCH, OP_SPILL_CANDIDATES, OP_EVICT = range(1, 15)
ST_OK, ST_NOT_FOUND, ST_EXISTS, ST_OOM, ST_TIMEOUT, ST_ERR, ST_NOT_SEALED, \
    ST_BUSY = range(8)


def _default_inline_max() -> int:
    """Inline-get size cap = the system-wide small-object threshold
    (config max_inline_object_bytes); the daemon has no server-side cap —
    the client's max_bytes alone decides inline vs zero-copy."""
    from ray_tpu_torch import config
    return int(config.get("max_inline_object_bytes"))

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "shmstore.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "ray_tpu_torch")
CXX_FLAGS = ["-O2", "-std=c++17", "-Wall"]


class ObjectStoreError(Exception):
    pass


class ObjectStoreFullError(ObjectStoreError):
    pass


def _target() -> str:
    """The binary's path, keyed by a hash of the source and the flags, so
    an edited source never starts a daemon built from an older one."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"shmstored-{h.hexdigest()[:16]}")


def ensure_built() -> str:
    """Build the daemon from the port's source unless this source's binary
    exists (``g++``, the flags of the JAX package's ``native/Makefile``),
    into ``build/ray_tpu_torch/`` at the root of the checkout. Writes a
    temporary name and renames it, so concurrent builds never expose a
    half-written binary. A failed build raises with the compiler's
    output."""
    target = _target()
    if not os.path.exists(target):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        cxx = os.environ.get("CXX", "g++")
        try:
            out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC, "-lrt"],
                                 capture_output=True, text=True)
        except OSError as e:
            raise ObjectStoreError(
                f"cannot build shmstored: {cxx} failed to start: {e}")
        if out.returncode != 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise ObjectStoreError(
                f"shmstored build failed ({cxx} exit {out.returncode}):\n"
                + (out.stdout + out.stderr)[-4000:])
        os.replace(tmp, target)
    return target


def start_store(sock_path: str, capacity: int, prefix: str,
                spill_dir: Optional[str] = None) -> subprocess.Popen:
    """Launch shmstored; waits for its READY line."""
    args = [ensure_built(), sock_path, str(capacity), prefix]
    if spill_dir:
        args.append(spill_dir)
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline()
    if not line.startswith("READY"):
        proc.kill()
        raise ObjectStoreError(f"shmstored failed to start: {line!r}")
    return proc


class _MapCache:
    """Per-process cache of writable mappings over recycled shm segments.

    The daemon recycles retired segments (same inode comes back for the
    next same-sized create, via rename). A mapping whose page tables are
    already populated turns a 100MB fill into a plain memcpy (~2x over
    pwrite, ~6x over a fresh-page mmap store). Identity is (st_dev,
    st_ino); each entry KEEPS ITS FD OPEN, which pins the inode so the
    inode number cannot be recycled for an unrelated file while cached —
    that's what makes the (dev, ino) check sound. Bounded by entries and
    bytes; LRU."""

    _MAX_ENTRIES = 8
    _MAX_BYTES = 512 << 20
    _MIN_SIZE = 1 << 20  # small objects gain nothing from mapping reuse

    def __init__(self):
        self._entries: "Dict[Tuple[int, int], Tuple[int, mmap.mmap, int]]" \
            = {}  # (dev, ino) -> (kept_fd, mmap, size)
        self._order: "deque[Tuple[int, int]]" = deque()
        self._bytes = 0
        self._last_sweep = 0.0
        self._lock = threading.Lock()

    def lookup(self, fd: int, size: int) -> Optional[mmap.mmap]:
        if size < self._MIN_SIZE:
            return None
        st = os.fstat(fd)
        key = (st.st_dev, st.st_ino)
        with self._lock:
            # Sweep from the read path too (rate-limited): a process that
            # stops WRITING must still drop pins on segments the store
            # already unlinked, or its cached fd+mmap keep tmpfs pages
            # resident that the store's accounting says are free.
            now = time.monotonic()
            if now - self._last_sweep > 0.5:
                self._last_sweep = now
                self._sweep_unlinked_locked()
            ent = self._entries.get(key)
            if ent is not None and ent[2] == size:
                self._order.remove(key)
                self._order.append(key)
                return ent[1]
        return None

    def _sweep_unlinked_locked(self) -> None:
        """Drop entries whose inode the store already unlinked (evicted
        pool segment): st_nlink==0 means OUR fd+mmap are the only thing
        keeping those tmpfs pages resident — memory the store believes it
        freed. Caller holds the lock; a handful of fstats."""
        for key in list(self._entries):
            kfd, _kmm, ksize = self._entries[key]
            try:
                alive = os.fstat(kfd).st_nlink > 0
            except OSError:
                alive = False
            if not alive:
                self._order.remove(key)
                kfd, _kmm, ksize = self._entries.pop(key)
                self._bytes -= ksize
                os.close(kfd)  # mmap ref dropped; GC unmaps when unused

    def sweep(self) -> None:
        """Periodic-timer entry point (ShmClient's 1Hz drain loop): drop
        pins on store-unlinked segments even when this process has gone
        idle on the put path."""
        with self._lock:
            self._sweep_unlinked_locked()

    def insert(self, fd: int, size: int) -> None:
        """Map (unfaulted; faults resolve on first cached write) and keep a
        dup'd fd so the inode stays pinned."""
        if size < self._MIN_SIZE or size > self._MAX_BYTES:
            return
        st = os.fstat(fd)
        key = (st.st_dev, st.st_ino)
        with self._lock:
            self._sweep_unlinked_locked()
            if key in self._entries:
                return
            keep = os.dup(fd)
            try:
                mm = mmap.mmap(keep, size)
            except (OSError, ValueError):
                os.close(keep)
                return
            self._entries[key] = (keep, mm, size)
            self._order.append(key)
            self._bytes += size
            while (len(self._entries) > self._MAX_ENTRIES or
                   self._bytes > self._MAX_BYTES):
                old = self._order.popleft()
                kfd, kmm, ksize = self._entries.pop(old)
                self._bytes -= ksize
                # Do NOT kmm.close(): a concurrent ShmWriter that got this
                # mapping from lookup() may be mid-copy, and closing under
                # it turns its next slice-assign into a hard error. Drop
                # the reference — GC unmaps once the last writer lets go.
                del kmm
                os.close(kfd)


_map_cache = _MapCache()


class ShmWriter:
    """Filler for a CREATED object (close(), then seal()).

    Fast paths, in order: a cached mapping of a recycled segment (pure
    memcpy — page tables already populated), else pwrite() (skips the
    per-4KB fault+zero-fill storm a fresh-page mmap store pays, ~2.5x on a
    100MB put)."""

    _WRITE_CHUNK = 32 << 20  # cap single pwrite size (signed-int syscalls)

    def __init__(self, fd: int, size: int):
        self._fd = fd
        self.size = size
        self._mm = _map_cache.lookup(fd, size) if fd >= 0 else None

    def write_at(self, offset: int, data) -> int:
        m = memoryview(data)
        if m.format != "B":
            m = m.cast("B")
        if m.nbytes and not m.contiguous:
            m = memoryview(bytes(m))
        n = m.nbytes
        if self._mm is not None:
            self._mm[offset:offset + n] = m
            return n
        off = 0
        while off < n:
            off += os.pwrite(self._fd, m[off:off + self._WRITE_CHUNK],
                             offset + off)
        return n

    def close(self) -> None:
        if self._fd >= 0:
            if self._mm is None:
                # Populate the cache so the NEXT same-sized recycle of this
                # segment writes through the mapping.
                _map_cache.insert(self._fd, self.size)
            self._mm = None
            os.close(self._fd)
            self._fd = -1

    def __del__(self):
        self.close()


class ShmClient:
    """Connection to one node's shmstored."""

    def __init__(self, sock_path: str, prefix: str):
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(sock_path)
        self._prefix = prefix
        self._lock = threading.Lock()
        self._maps: Dict[bytes, Tuple[mmap.mmap, int]] = {}
        # Releases queued by mmap finalizers (get_pinned): flushed on the
        # next store call under the socket lock. A finalizer must never
        # touch the socket itself — it can fire mid-_call on this very
        # thread (GC during allocation) and would deadlock or corrupt the
        # frame stream. A background drain covers the idle case: a process
        # that stops calling the store must still drop its pins, or the
        # daemon can never delete/evict those objects (deferred-delete +
        # recycling both key off refcount 0).
        self._deferred_releases: "deque[bytes]" = deque()
        self._closed = False
        threading.Thread(target=self._release_drain_loop, daemon=True,
                         name="shm-release-drain").start()

    def _queue_release(self, oid: bytes) -> None:
        # Append ONLY — a finalizer may fire inside any lock/Event
        # critical section on this very thread; deque.append is the one
        # operation that is safe everywhere.
        self._deferred_releases.append(oid)

    def _release_drain_loop(self) -> None:
        # 1Hz poll (not event-driven: finalizers can't safely signal an
        # Event). Cheap — one wakeup/sec/client, and _call() drains
        # eagerly in active processes anyway.
        while not self._closed:
            time.sleep(1.0)
            if self._closed:
                return
            _map_cache.sweep()
            if not self._deferred_releases:
                continue
            try:
                self._drain_releases()
            except Exception:
                return  # socket gone; the daemon reaps on disconnect

    def _drain_releases(self) -> None:
        # _lock IS the wire lock: it exists to serialize request/reply
        # framing on this store socket, so socket I/O under it is the
        # design, not a hazard (local unix socket, store replies are µs).
        with self._lock:
            while self._deferred_releases:
                oid = self._deferred_releases.popleft()
                self._sock.sendall(struct.pack(     # rtcheck: allow-blocking(wire lock: serializes framing on the local store socket)
                    "<IB16s", 17, OP_RELEASE, oid))
                self._read_frame()

    # --- framing ---------------------------------------------------------
    def _call(self, payload: bytes) -> bytes:
        with self._lock:
            while self._deferred_releases:
                oid = self._deferred_releases.popleft()
                self._sock.sendall(struct.pack(     # rtcheck: allow-blocking(wire lock: serializes framing on the local store socket)
                    "<IB16s", 17, OP_RELEASE, oid))
                self._read_frame()
            self._sock.sendall(struct.pack("<I", len(payload)) + payload)  # rtcheck: allow-blocking(wire lock: serializes framing on the local store socket)
            return self._read_frame()

    def _read_frame(self) -> bytes:
        hdr = self._recv_exact(4)
        (length,) = struct.unpack("<I", hdr)
        return self._recv_exact(length)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ObjectStoreError("store connection closed")
            buf += chunk
        return buf

    # --- object ops ------------------------------------------------------
    def _shm_path(self, oid: bytes) -> str:
        return f"/dev/shm/{self._prefix}{oid.hex()}"

    def _create_rpc(self, oid: bytes, size: int) -> None:
        deadline = time.monotonic() + 5.0
        while True:
            resp = self._call(struct.pack("<B16sQ", OP_CREATE, oid, size))
            st = resp[0]
            if st == ST_BUSY:
                # Previous incarnation of this id is pending_delete with
                # live reader pins; the name frees once they drain. Retry
                # briefly rather than mis-reporting "already exists".
                if time.monotonic() < deadline:
                    time.sleep(0.002)
                    continue
                raise ObjectStoreError(
                    f"object {oid.hex()} stuck pending delete (pinned)")
            if st == ST_OOM:
                raise ObjectStoreFullError(
                    f"object of {size} bytes doesn't fit")
            if st == ST_EXISTS:
                raise ObjectStoreError(f"object {oid.hex()} already exists")
            if st != ST_OK:
                raise ObjectStoreError(f"create failed: status {st}")
            return

    def create(self, oid: bytes, size: int) -> memoryview:
        """Reserve an object and return a writable view; seal() when done."""
        self._create_rpc(oid, size)
        fd = os.open(self._shm_path(oid), os.O_RDWR)
        try:
            mm = mmap.mmap(fd, size) if size else mmap.mmap(-1, 1)
        finally:
            os.close(fd)
        return memoryview(mm)[:size] if size else memoryview(b"")

    def create_writer(self, oid: bytes, size: int) -> "ShmWriter":
        """Reserve an object for pwrite()-based filling (the fast put path:
        no page-fault storm on fresh tmpfs pages, straight memcpy into
        daemon-recycled ones). seal() when done."""
        self._create_rpc(oid, size)
        fd = os.open(self._shm_path(oid), os.O_RDWR) if size else -1
        return ShmWriter(fd, size)

    def seal(self, oid: bytes) -> None:
        resp = self._call(struct.pack("<B16s", OP_SEAL, oid))
        if resp[0] != ST_OK:
            raise ObjectStoreError(f"seal failed: status {resp[0]}")

    def put(self, oid: bytes, data) -> None:
        data = memoryview(data)
        w = self.create_writer(oid, data.nbytes)
        try:
            w.write_at(0, data)
        finally:
            w.close()
        self.seal(oid)

    def get(self, oid: bytes, timeout: Optional[float] = None
            ) -> Optional[memoryview]:
        """Blocking get -> zero-copy readonly view; None when the object is
        not available (timeout, not created yet, or writer has not sealed).
        Pair with an explicit release() once done reading (and do not
        retain views past it — use get_pinned for that)."""
        got = self._get_map(oid, timeout)
        if got is None:
            return None
        mm, size = got
        if mm is None:
            return memoryview(b"")
        self._maps[oid] = (mm, size)
        return memoryview(mm)

    def get_pinned(self, oid: bytes, timeout: Optional[float] = None
                   ) -> Optional[memoryview]:
        """Zero-copy get whose store reference lives exactly as long as the
        mapping: released (via the deferred queue) when the LAST view —
        e.g. a numpy array deserialized over it — is garbage collected. No
        explicit release; this is what makes daemon page recycling safe."""
        got = self._get_map(oid, timeout)
        if got is None:
            return None
        mm, _size = got
        if mm is None:
            # Zero-byte objects have no mapping to pin; drop the ref now.
            self._queue_release(bytes(oid))
            return memoryview(b"")
        weakref.finalize(mm, self._queue_release, bytes(oid))
        return memoryview(mm)

    def _get_map(self, oid: bytes, timeout: Optional[float]):
        """Shared get machinery -> None (unavailable) | (mmap|None, size);
        the store ref is held — the caller decides release discipline."""
        timeout_ms = -1 if timeout is None else int(timeout * 1000)
        resp = self._call(struct.pack("<B16sq", OP_GET, oid, timeout_ms))
        st = resp[0]
        if st in (ST_TIMEOUT, ST_NOT_FOUND, ST_NOT_SEALED):
            # NOT_SEALED: a writer is mid-create; readers retry like not-yet-
            # created (sealing is the visibility barrier, plasma semantics).
            return None
        if st != ST_OK:
            raise ObjectStoreError(f"get failed: status {st}")
        (size,) = struct.unpack("<Q", resp[1:9])
        if size == 0:
            return (None, 0)
        fd = os.open(self._shm_path(oid), os.O_RDONLY)
        try:
            return (mmap.mmap(fd, size, prot=mmap.PROT_READ), size)
        finally:
            os.close(fd)

    def put_inline(self, oid: bytes, data) -> bool:
        """Small-object put: create+copy+seal in ONE store round trip (the
        write path analog of get_inline). False when the object already
        exists (same no-op semantics as the create path)."""
        m = memoryview(data)
        if m.format != "B":
            m = m.cast("B")
        resp = self._call(struct.pack("<B16s", OP_PUT_INLINE, oid) +
                          bytes(m))
        st = resp[0]
        if st == ST_EXISTS:
            return False
        if st == ST_OOM:
            raise ObjectStoreFullError(
                f"object of {m.nbytes} bytes doesn't fit")
        if st != ST_OK:
            raise ObjectStoreError(f"put_inline failed: status {st}")
        return True

    def put_inline_batch(self, items) -> int:
        """Pipelined small-object puts: every OP_PUT_INLINE frame hits the
        wire before the first reply is read (the daemon serves one
        connection's requests serially and in order, so replies match
        request order). One send/recv burst per batch instead of a store
        round trip per object — this is the lazy sealer's backstop write
        load, stolen from the task ping-pong on small hosts.

        ``items``: iterable of (oid16, bytes-like). Per-object failures
        (exists/OOM) are tolerated — returns the count actually written.
        """
        frames = []
        for oid, data in items:
            m = memoryview(data)
            if m.format != "B":
                m = m.cast("B")
            payload = struct.pack("<B16s", OP_PUT_INLINE, oid) + bytes(m)
            frames.append(struct.pack("<I", len(payload)) + payload)
        if not frames:
            return 0
        wrote = 0
        with self._lock:
            while self._deferred_releases:
                oid = self._deferred_releases.popleft()
                self._sock.sendall(struct.pack("<IB16s", 17, OP_RELEASE, oid))  # rtcheck: allow-blocking(wire lock: serializes framing on the local store socket)
                self._read_frame()
            self._sock.sendall(b"".join(frames))  # rtcheck: allow-blocking(wire lock: serializes framing on the local store socket)
            for _ in frames:
                if self._read_frame()[0] == ST_OK:
                    wrote += 1
        return wrote

    # Oids per OP_GET_COPY_BATCH round trip: bounds the daemon's reply
    # buffer (~100MB worst case at the default 100KB inline cap — raise
    # max_inline_object_bytes past ~4MB and this needs revisiting) and
    # keeps the reply length far from u32 framing limits.
    _GET_BATCH = 1024

    def get_inline_batch(self, oids: List[bytes],
                         max_bytes: Optional[int] = None
                         ) -> List[Optional[bytes]]:
        """Inline-get MANY objects in few round trips; None per miss
        (absent / unsealed / larger than max_bytes — callers fall back to
        the zero-copy path for those). max_bytes defaults to the config's
        max_inline_object_bytes."""
        if max_bytes is None:
            max_bytes = _default_inline_max()
        out: List[Optional[bytes]] = []
        for start in range(0, len(oids), self._GET_BATCH):
            chunk = oids[start:start + self._GET_BATCH]
            payload = struct.pack("<B16sIQ", OP_GET_COPY_BATCH, b"\0" * 16,
                                  len(chunk), max_bytes) + b"".join(chunk)
            resp = self._call(payload)
            if resp[0] != ST_OK:
                raise ObjectStoreError(
                    f"get_inline_batch failed: status {resp[0]}")
            pos = 1
            for _ in chunk:
                st = resp[pos]
                (size,) = struct.unpack_from("<Q", resp, pos + 1)
                pos += 9
                if st == ST_OK:
                    out.append(resp[pos:pos + size])
                    pos += size
                else:
                    out.append(None)
        return out

    def get_inline(self, oid: bytes,
                   max_bytes: Optional[int] = None) -> Optional[bytes]:
        """Small-object fast path (OP_GET_COPY): the sealed payload comes
        back INLINE in one round trip — no refcount, no mmap, no release.
        Returns None when the object is missing, unsealed, or larger than
        max_bytes (callers fall back to the zero-copy get/release path).
        max_bytes defaults to the config's max_inline_object_bytes.
        """
        if max_bytes is None:
            max_bytes = _default_inline_max()
        resp = self._call(struct.pack("<B16sQ", OP_GET_COPY, oid, max_bytes))
        st = resp[0]
        if st != ST_OK:
            return None
        (size,) = struct.unpack("<Q", resp[1:9])
        return resp[9:9 + size]

    def release(self, oid: bytes) -> None:
        mm = self._maps.pop(oid, None)
        self._call(struct.pack("<B16s", OP_RELEASE, oid))
        # the mmap view may still be referenced by user numpy arrays; let GC
        # close it (mmap keeps the pages alive independently of the store)

    def delete(self, oid: bytes) -> None:
        self._call(struct.pack("<B16s", OP_DELETE, oid))

    def contains(self, oid: bytes) -> bool:
        resp = self._call(struct.pack("<B16s", OP_CONTAINS, oid))
        return resp[0] == ST_OK

    def contains_batch(self, oids: List[bytes]) -> List[bool]:
        """Existence of MANY objects in few round trips — same sealed-and-
        visible predicate as contains(). Turns a wait() over 1k refs into
        one store round trip instead of 1k."""
        out: List[bool] = []
        for start in range(0, len(oids), self._GET_BATCH):
            chunk = oids[start:start + self._GET_BATCH]
            payload = struct.pack("<BI", OP_CONTAINS_BATCH,
                                  len(chunk)) + b"".join(chunk)
            resp = self._call(payload)
            if resp[0] != ST_OK:
                raise ObjectStoreError(
                    f"contains_batch failed: status {resp[0]}")
            out.extend(b != 0 for b in resp[1:1 + len(chunk)])
        return out

    def spill_candidates(self, max_bytes: int = 0
                         ) -> List[Tuple[bytes, int]]:
        """Cold unreferenced SEALED primaries worth spilling, coldest
        first, totalling at least ``max_bytes`` (0 = every candidate).
        Read-only: the spill coordinator copies the bytes out through its
        backend, then calls evict() per object."""
        resp = self._call(struct.pack("<BQ", OP_SPILL_CANDIDATES, max_bytes))
        if resp[0] != ST_OK:
            raise ObjectStoreError(
                f"spill_candidates failed: status {resp[0]}")
        body = resp[1:]
        out: List[Tuple[bytes, int]] = []
        for i in range(0, len(body), 24):
            oid = bytes(body[i:i + 16])
            (size,) = struct.unpack_from("<Q", body, i + 16)
            out.append((oid, size))
        return out

    def evict(self, oid: bytes) -> Optional[int]:
        """Evict-with-report: drop this object's store copy NOW (the caller
        holds a durable copy elsewhere). Returns bytes freed, or None when
        the store refused — pinned by a reader (ST_BUSY), unsealed, or
        already gone; refusal means the copy stays and the caller simply
        keeps both."""
        resp = self._call(struct.pack("<B16s", OP_EVICT, oid))
        if resp[0] != ST_OK:
            return None
        (freed,) = struct.unpack("<Q", resp[1:9])
        return freed

    def stats(self) -> dict:
        import json
        resp = self._call(struct.pack("<B", OP_STATS))
        return json.loads(resp[1:].decode())

    def list_objects(self) -> List[bytes]:
        resp = self._call(struct.pack("<B", OP_LIST))
        body = resp[1:]
        return [bytes(body[i:i + 16]) for i in range(0, len(body), 16)]

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
