"""Object plane: local shm store + remote pull + location directory.

Role parity: the core worker's plasma provider + PullManager
(core_worker.cc:1307 Get -> plasma -> raylet pull, pull_manager.h:52).
Shared by the driver runtime and by worker processes: values are serialized
with out-of-band buffers (core/serialization.py), stored in the node's
shmstored, registered in the conductor's object directory, and pulled
node-to-node in chunks when non-local.
"""

from __future__ import annotations

import logging
import mmap
import os
import random
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import FIRST_COMPLETED
from concurrent.futures import TimeoutError as _FutureTimeout
from concurrent.futures import wait as _futures_wait
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.cluster import fault_plane, object_client
from ray_tpu_torch.cluster.protocol import ConnectionLost, RpcError, get_client
from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.exceptions import GetTimeoutError, ObjectLostError
from ray_tpu_torch.core.ids import ObjectID, store_key
from ray_tpu_torch.util import events as _events
from ray_tpu_torch.util import lockcheck
from ray_tpu_torch.util.broadcast_schedule import broadcast_rounds

# Batch-get miss marker (a stored value may legitimately be None).
MISS = object()

logger = logging.getLogger(__name__)

_loc_dropped_counter = None


def _count_dropped_registrations(n: int) -> None:
    global _loc_dropped_counter
    if _loc_dropped_counter is None:
        from ray_tpu_torch.util.metrics import Counter
        _loc_dropped_counter = Counter(
            "location_registrations_dropped",
            "Object-location registrations discarded because the batcher's "
            "buffer overflowed during a conductor outage.")
    _loc_dropped_counter.inc(n)


class _ByteBudget:
    """Admission control for concurrent pulls (pull_manager.h:52 role):
    bounds total in-flight pull bytes so N parallel fetches of large
    objects can't blow the local store. An oversized single request is
    admitted alone (never deadlocks).

    Waiters admit in FIFO order: only the head of the queue may take
    budget, so a large pull gets the next big-enough window instead of
    being starved forever by a stream of small requests slipping past it.
    """

    def __init__(self, cap: int):
        self.cap = cap
        self._used = 0
        self._cv = threading.Condition(
            lockcheck.named_lock("plane.pull_budget"))
        self._queue: "deque[object]" = deque()

    def acquire(self, n: int) -> None:
        ticket = object()
        with self._cv:
            self._queue.append(ticket)
            while self._queue[0] is not ticket or \
                    (self._used > 0 and self._used + n > self.cap):
                self._cv.wait(1.0)
            self._queue.popleft()
            self._used += n
            self._cv.notify_all()  # the next head may also fit

    def release(self, n: int) -> None:
        with self._cv:
            self._used -= n
            self._cv.notify_all()


class _InlineCache:
    """Caller-side cache of reply-carried small results (the reference's
    "direct call" objects, transport/direct_actor_transport.cc role).

    A push reply can carry a return value before the producing worker has
    sealed it into the store; the owner parks getters on the PENDING table
    and completes them straight from the reply — no store round trip, no
    conductor locate. Entries are serialized blobs (each get deserializes a
    fresh copy, same isolation as a store read), LRU-bounded by byte
    budget, and dropped eagerly when the local refcount hits zero."""

    def __init__(self, max_bytes: int):
        self._cv = threading.Condition()
        self.max_bytes = max_bytes
        self._blobs: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._nbytes = 0
        self._pending: set = set()

    # -- pending returns (futures completed by the push reply) ---------
    def add_pending(self, keys) -> None:
        with self._cv:
            self._pending.update(keys)

    def resolve(self, key: bytes) -> None:
        """The reply said this return is store-backed (or terminal): stop
        parking getters on the reply and let them take the store path."""
        with self._cv:
            if key in self._pending:
                self._pending.discard(key)
                self._cv.notify_all()

    def is_pending(self, key: bytes) -> bool:
        with self._cv:
            return key in self._pending

    def wait_resolved(self, key: bytes, timeout: float) -> bool:
        """Park until ``key`` leaves the pending state (seeded from a
        reply, resolved to store-backed, or dropped). False on timeout."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while key in self._pending:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    # -- blob cache ----------------------------------------------------
    def seed(self, key: bytes, blob: bytes) -> None:
        with self._cv:
            old = self._blobs.pop(key, None)
            if old is not None:
                self._nbytes -= len(old)
            self._blobs[key] = blob
            self._nbytes += len(blob)
            while self._nbytes > self.max_bytes and self._blobs:
                _, v = self._blobs.popitem(last=False)
                self._nbytes -= len(v)
            self._pending.discard(key)
            self._cv.notify_all()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._cv:
            blob = self._blobs.get(key)
            if blob is not None:
                self._blobs.move_to_end(key)
            return blob

    def has(self, key: bytes) -> bool:
        with self._cv:
            return key in self._blobs

    def drop(self, key: bytes) -> None:
        with self._cv:
            blob = self._blobs.pop(key, None)
            if blob is not None:
                self._nbytes -= len(blob)
            self._pending.discard(key)
            self._cv.notify_all()


class _LocationBatcher:
    """Coalesces add_object_location registrations into one conductor RPC
    per ~5ms burst window. A task-result-heavy worker was spending a
    synchronous conductor round trip PER RESULT — at thousands of results/s
    that RPC dominates completion throughput. Registration becomes eventual
    (bounded by the flush window): same-node readers never notice (they hit
    the local store directly) and cross-node readers long-poll the
    directory anyway.

    Entries may target a node OTHER than our own: a caller that received a
    reply-carried inline result pre-registers the PRODUCER's node as the
    location so remote consumers can discover the (lazily sealed) copy —
    or get a deterministic probe-miss -> lost verdict if the producer died
    before sealing."""

    # 5ms: matches the refcount stream's flush cadence — one background
    # conductor RPC per window from each plane, not one per 2ms (measured
    # against the task ping-pong on a 1-CPU head: the conductor handler
    # work comes straight out of the driver/worker's cycle budget).
    _WINDOW_S = 0.005

    def __init__(self, conductor, node_id: bytes):
        self._conductor = conductor
        self._node_id = node_id
        self._buf: list = []    # (node_id, key) pairs, arrival order
        self._lock = lockcheck.named_lock("plane.loc_batch")
        self._event = threading.Event()
        self._stopped = False
        self._drop_logged = False
        self.dropped_total = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="loc-batch")
        self._thread.start()

    _MAX_BUFFER = 262_144  # registrations kept across a conductor outage

    def add(self, key: bytes, node_id: Optional[bytes] = None,
            device: str = "") -> None:
        with self._lock:
            self._buf.append((node_id or self._node_id, key, device))
        self._event.set()

    def _send(self, batch: list) -> None:
        by_node: Dict[bytes, list] = {}
        for nid, key, device in batch:
            by_node.setdefault(nid, []).append((key, device))
        for nid, entries in by_node.items():
            keys = [k for k, _ in entries]
            if any(d for _, d in entries):
                self._conductor.call(
                    "add_object_locations", oids=keys, node_id=nid,
                    devices=[d for _, d in entries])
            else:
                self._conductor.call("add_object_locations", oids=keys,
                                     node_id=nid)

    def _loop(self) -> None:
        backoff = self._WINDOW_S
        while not self._stopped:
            # Event-driven: block until the FIRST add (zero idle wakeups —
            # a polling loop here costs real throughput on small hosts),
            # then sleep one short window so followers coalesce.
            self._event.wait()
            if self._stopped:
                return
            time.sleep(backoff)
            self._event.clear()
            with self._lock:
                batch, self._buf = self._buf, []
            if not batch:
                continue
            try:
                self._send(batch)
                backoff = self._WINDOW_S
            except Exception:
                # Conductor unreachable (failover window): back off up to
                # 1s instead of hammering at the burst cadence, and bound
                # the buffer — after reconnection the daemon re-advertises
                # its whole store inventory anyway, so dropped entries are
                # recovered by that replay. Dropping is still an eventual-
                # consistency gamble (a driver-side plane has no inventory
                # replay), so it must be observable, not silent.
                backoff = min(backoff * 4, 1.0)
                with self._lock:
                    keep = (batch + self._buf)[-self._MAX_BUFFER:]
                    dropped = len(batch) + len(self._buf) - len(keep)
                    self._buf = keep
                if dropped > 0:
                    self.dropped_total += dropped
                    _count_dropped_registrations(dropped)
                    if not self._drop_logged:
                        self._drop_logged = True
                        logger.warning(
                            "location batcher buffer overflow: dropped %d "
                            "object-location registration(s) while the "
                            "conductor was unreachable (buffer cap %d); "
                            "counting further drops in the "
                            "location_registrations_dropped metric",
                            dropped, self._MAX_BUFFER)
                self._event.set()

    def flush(self) -> None:
        """Synchronous drain (shutdown; tests)."""
        with self._lock:
            batch, self._buf = self._buf, []
        if batch:
            try:
                self._send(batch)
            except Exception:
                pass

    def stop(self) -> None:
        self._stopped = True
        self._event.set()
        self.flush()


class ObjectPlane:
    def __init__(self, store: object_client.ShmClient, node_id: bytes,
                 conductor_address: str,
                 daemon_address: Optional[str] = None):
        from ray_tpu_torch import config
        self.store = store
        self.node_id = node_id
        self.conductor = get_client(
            conductor_address,
            reconnect_s=config.get("gcs_rpc_reconnect_s"))
        # Local daemon (when co-resident with one): the put-side
        # backpressure target — an ST_OOM create asks it to
        # spill-then-admit instead of failing the put.
        self.daemon_address = daemon_address
        # Optional callable key -> bool set by the task runtime: True
        # when the object is lineage-recoverable (feeds the
        # restore-vs-reconstruct cost choice for spilled objects).
        self.lineage_hint = None
        self._restored_objects = 0
        self._restored_bytes = 0
        self._pull_locks: Dict[bytes, threading.Lock] = {}
        self._pull_guard = threading.Lock()
        self._pull_budget = _ByteBudget(
            config.get("max_concurrent_pull_bytes"))
        self._loc_batcher = _LocationBatcher(self.conductor, node_id)
        self._inline = _InlineCache(
            int(config.get("inline_cache_max_bytes")))
        self._inline_gen = None
        self._inline_max_v = 64 << 10

    def _inline_max(self) -> int:
        """The single small-object threshold (max_inline_object_bytes),
        cached against the config generation — this sits on every put/get.
        """
        from ray_tpu_torch import config
        if self._inline_gen != config.generation:
            self._inline_max_v = int(config.get("max_inline_object_bytes"))
            self._inline_gen = config.generation
        return self._inline_max_v

    # -- write ----------------------------------------------------------
    def put_value(self, oid: ObjectID, value: Any) -> int:
        """Serialize + store, copying large buffers once (straight into the
        shm mapping). Contained ObjectRefs are registered as children so
        the stored object keeps them alive (reference_count.h nested refs).
        """
        total, segments, refs = serialization.serialize_segments(value)
        return self.put_segments(oid, total, segments, refs)

    def put_segments(self, oid: ObjectID, total: int, segments: list,
                     refs: list) -> int:
        """Store an already-serialized value (the worker return path
        serializes once to decide inline-vs-store and lands here for the
        store-backed half)."""
        key = self._key(oid)
        if refs:
            from ray_tpu_torch.core import refs as _refs_mod
            t = _refs_mod._tracker
            if t is not None:
                t.add_children(key, [store_key(r.id.binary()) for r in refs])
        try:
            if total <= self._inline_max():
                # One store round trip (vs create+seal, plus the client's
                # open/pwrite/close) — task results are overwhelmingly
                # this shape.
                blob = segments[0] if len(segments) == 1 else \
                    b"".join(bytes(memoryview(s).cast("B"))
                             for s in segments)
                self._with_put_backpressure(
                    total, lambda: self.store.put_inline(key, blob))
            else:
                def _create():
                    w = self.store.create_writer(key, total)
                    try:
                        off = 0
                        for seg in segments:
                            off += w.write_at(off, seg)
                    finally:
                        w.close()
                    self.store.seal(key)
                self._with_put_backpressure(total, _create)
        except object_client.ObjectStoreError as e:
            if "already exists" not in str(e):
                raise
        device = ""
        if segments and serialization.is_array_blob(segments[0]):
            hdr = serialization.array_header(segments[0])
            device = hdr["device"] if hdr else ""
            _events.emit("object.array.put", key.hex(), value=float(total))
        self._loc_batcher.add(key, device=device)
        return total

    def put_blob(self, oid: ObjectID, blob: bytes) -> int:
        key = self._key(oid)
        try:
            if len(blob) <= self._inline_max():
                # Same one-round-trip create+copy+seal fast path as
                # put_value (raw puts and spill restores are often small).
                self._with_put_backpressure(
                    len(blob), lambda: self.store.put_inline(key, blob))
            else:
                def _create():
                    w = self.store.create_writer(key, len(blob))
                    try:
                        w.write_at(0, blob)
                    finally:
                        w.close()
                    self.store.seal(key)
                self._with_put_backpressure(len(blob), _create)
        except object_client.ObjectStoreError as e:
            if "already exists" not in str(e):
                raise
        self._loc_batcher.add(key)
        return len(blob)

    def _with_put_backpressure(self, nbytes: int, attempt):
        """Run a store-create closure with spill-then-admit backpressure:
        a create that hits ST_OOM asks the co-resident daemon to spill
        cold objects and retries within object_spill_put_timeout_s,
        instead of failing a put the store could admit after spilling
        (the create-retry half of local_object_manager.h's role)."""
        from ray_tpu_torch import config
        try:
            return attempt()
        except object_client.ObjectStoreFullError:
            window = float(config.get("object_spill_put_timeout_s"))
            if window <= 0 or not self.daemon_address:
                raise
        deadline = time.monotonic() + window
        _events.emit("object.put.backpressure", value=float(nbytes))
        while True:
            freed = self._request_spill(nbytes)
            try:
                return attempt()
            except object_client.ObjectStoreFullError:
                if time.monotonic() >= deadline:
                    raise
                if not freed:
                    # Nothing spillable right now (everything pinned or
                    # below threshold granularity): wait for refs to drop.
                    time.sleep(0.05)

    def _request_spill(self, nbytes: int) -> int:
        """Ask the local daemon to spill at least nbytes now. Returns
        bytes actually freed (0 on any failure — caller backs off)."""
        try:
            resp = get_client(self.daemon_address).call(
                "spill_request", want_bytes=int(nbytes))
            return int(resp.get("freed", 0))
        except Exception:
            return 0

    def put_blobs_inline(self, jobs) -> None:
        """Batched seal of small blobs: one pipelined store burst for the
        whole batch (``jobs``: list of (ObjectID, blob), each blob at most
        the inline cap — the lazy sealer's coalesced backlog)."""
        keyed = [(self._key(oid), blob) for oid, blob in jobs]
        self.store.put_inline_batch(keyed)
        for key, _ in keyed:
            self._loc_batcher.add(key)

    # -- reply-carried inline results -----------------------------------
    def add_pending(self, keys) -> None:
        """Register return keys whose values may arrive in the push reply;
        getters park on the reply instead of polling the store."""
        self._inline.add_pending(keys)

    def is_pending(self, key: bytes) -> bool:
        return self._inline.is_pending(key)

    def wait_inline(self, key: bytes, timeout: float) -> bool:
        """True once ``key`` is not (or no longer) reply-pending."""
        return self._inline.wait_resolved(key, timeout)

    def seed_inline(self, key: bytes, blob: bytes,
                    producer_node: Optional[bytes] = None) -> None:
        """Cache a reply-carried result and wake parked getters. The
        producer's node is pre-registered in the object directory so
        remote consumers discover the lazily-sealed copy (or get a
        deterministic lost verdict if the producer dies before sealing)."""
        self._inline.seed(key, blob)
        if producer_node:
            self._loc_batcher.add(key, producer_node)

    def resolve_pending(self, key: bytes) -> None:
        self._inline.resolve(key)

    def inline_blob(self, key: bytes) -> Optional[bytes]:
        return self._inline.get(key)

    def drop_inline(self, key: bytes) -> None:
        self._inline.drop(key)

    def add_remote_location(self, key: bytes, node_id: bytes) -> None:
        self._loc_batcher.add(key, node_id)

    # -- read -----------------------------------------------------------
    def _key(self, oid: ObjectID) -> bytes:
        # shmstored keys are 16 bytes; ObjectIDs are 20 (task id + index).
        return store_key(oid.binary())

    def contains(self, oid: ObjectID) -> bool:
        return self.contains_key(self._key(oid))

    def contains_key(self, key: bytes) -> bool:
        if self._inline.has(key):
            return True
        try:
            return self.store.contains(key)
        except (BrokenPipeError, ConnectionError, OSError):
            # The store daemon is gone (runtime shutting down, or a chaos
            # test killed it): "not present locally" is the right answer —
            # readers fall back to the object directory / recovery.
            return False

    def contains_batch(self, oids: List[ObjectID]) -> List[bool]:
        """Readiness of many refs in ONE store round trip (the wait() fast
        path), OR-ed with the inline cache (a reply-carried result is
        gettable before its lazy seal); falls back per-ref against a
        daemon that predates the op."""
        keys = [self._key(o) for o in oids]
        try:
            present = self.store.contains_batch(keys)
        except (object_client.ObjectStoreError, BrokenPipeError,
                ConnectionError, OSError):
            present = [False] * len(keys)
            for i, k in enumerate(keys):
                try:
                    present[i] = self.store.contains(k)
                except (BrokenPipeError, ConnectionError, OSError):
                    pass
        return [p or self._inline.has(k) for p, k in zip(present, keys)]

    def get_values_local_inline(self, oids: List[ObjectID]) -> List[Any]:
        """Batch fast path for ray_tpu_torch.get() over many refs: the inline
        cache resolves reply-carried results with no store traffic, then
        ONE store round trip resolves every LOCAL sealed small object;
        misses come back as the MISS sentinel (a stored value may
        legitimately be None) and take the per-object path (remote /
        large / unsealed)."""
        keys = [self._key(o) for o in oids]
        out: List[Any] = [MISS] * len(oids)
        need: List[int] = []
        for i, k in enumerate(keys):
            blob = self._inline.get(k)
            if blob is not None:
                out[i] = serialization.deserialize(memoryview(blob))
            else:
                need.append(i)
        if _events.enabled():
            hits = len(keys) - len(need)
            if hits:
                _events.emit("inline.hit", value=float(hits))
            if need:
                _events.emit("inline.miss", value=float(len(need)))
        if need:
            blobs = self.store.get_inline_batch(
                [keys[i] for i in need], max_bytes=self._inline_max())
            for i, b in zip(need, blobs):
                if b is not None:
                    out[i] = serialization.deserialize(memoryview(b))
        return out

    def get_value(self, oid: ObjectID, timeout: Optional[float] = None) -> Any:
        key = self._key(oid)
        # Reply-carried result still (or only) in the inline cache: zero
        # store/conductor round trips.
        blob = self._inline.get(key)
        if blob is not None:
            _events.emit("inline.hit")
            return serialization.deserialize(memoryview(blob))
        _events.emit("inline.miss")
        # Small sealed LOCAL objects come back inline in ONE store round
        # trip (no get+release pair, no mmap) — the dominant pattern when
        # ray_tpu_torch.get() collects many small task results.
        data = self.store.get_inline(key, max_bytes=self._inline_max())
        if data is not None:
            return serialization.deserialize(memoryview(data))
        view = self.get_view(oid, timeout=timeout)
        value = serialization.deserialize(view)
        # Buffer-backed values (numpy arrays) stay zero-copy views over the
        # shm mapping; the PINNED ref (get_view -> get_pinned) keeps the
        # object alive in the store until those views are GC'd, so the
        # daemon can never recycle pages under a live array.
        return value

    def get_view(self, oid: ObjectID,
                 timeout: Optional[float] = None) -> memoryview:
        """Zero-copy view, pinned: the store ref drops when the view (and
        every value deserialized over it) is garbage collected."""
        key = self._key(oid)
        # Fast path: local.
        view = self._get_pinned_tolerant(key)
        if view is not None:
            return view
        deadline = None if timeout is None else time.monotonic() + timeout
        # Loss detection: once a locate round ADVERTISED holders and every
        # pull from them failed definitively (holder unreachable or it
        # denied having the object), a later round with no live holders
        # means the object is gone, not merely not-yet-computed — raise
        # ObjectLostError so callers engage lineage recovery (or surface
        # the loss) instead of spinning until (or past) their deadline.
        holders_failed = False
        while True:
            remaining = 2.0 if deadline is None else deadline - time.monotonic()
            if remaining <= 0:
                if holders_failed:
                    raise ObjectLostError(
                        oid.hex(), "all advertised holders unreachable")
                raise GetTimeoutError(
                    f"timed out waiting for object {oid.hex()}")
            loc = self.conductor.call("locate_object", oid=key,
                                      timeout=min(remaining, 2.0))
            view = self._get_pinned_tolerant(key)
            if view is not None:
                return view
            nodes = [n for n in loc["nodes"]
                     if n["node_id"] != self.node_id]
            if loc.get("lost") and not nodes and not loc.get("spilled"):
                # The directory itself declared the object lost: every
                # registered copy died with its node (or was removed by a
                # failed-pull report) and there is no spill. Deterministic
                # — no need to wait for our own pulls to fail.
                raise ObjectLostError(
                    oid.hex(), "directory reports all object copies lost "
                    "(holder nodes died, no spill copy)")
            if nodes:
                # ONE striped/windowed pull covers every advertised holder
                # (probe, pick sources, fail over internally).
                outcome = self._pull_from(key, nodes)
                if outcome == "ok":
                    view = self._get_pinned_tolerant(key)
                    if view is not None:
                        return view
                elif outcome in ("missing", "unreachable"):
                    # Every probed holder failed definitively.
                    holders_failed = True
            if loc.get("spilled") and (not nodes or holders_failed):
                # Third source tier: no live shm copy is reachable but a
                # durable spill copy exists — restore it instead of
                # declaring the object lost. When lineage could ALSO
                # recover it, a cost heuristic may prefer re-execution
                # (Ownership-paper recovery-cost argument).
                size = int(loc.get("spilled_size") or 0)
                if self._should_reconstruct(oid, size):
                    raise ObjectLostError(
                        oid.hex(), "spill copy bypassed: lineage "
                        "reconstruction preferred by cost heuristic")
                if self._restore_spilled(key, loc["spilled"], size):
                    view = self._get_pinned_tolerant(key)
                    if view is not None:
                        return view
                else:
                    # Unreadable spill URL (a node-local spill dir died
                    # with its node): scrub the directory entry so the
                    # next locate round sees lost / reconstructs.
                    try:
                        self.conductor.call("remove_spilled", oid=key,
                                            url=loc["spilled"])
                    except Exception:
                        pass
                    holders_failed = True
            elif not nodes and not loc.get("spilled") and holders_failed:
                # Every holder we were pointed at failed AND the directory
                # (now scrubbed of them by the pull's removal reports)
                # lists none: fully lost. A reconstruction that re-creates
                # the object registers a new location and wakes the locate
                # long-poll above before this branch can trigger.
                raise ObjectLostError(
                    oid.hex(), "object has no live holders and no spill "
                    "copy (all advertised replicas failed)")
            # No location known yet (still being computed) -> loop.

    def _get_pinned_tolerant(self, key: bytes) -> Optional[memoryview]:
        """get_pinned that treats a store-side error as not-yet-available.
        Under heavy overcommit a native spill-restore can fail transiently
        (every resident byte pinned by readers): the getter should retry
        within its own deadline — refs drop and space frees — rather than
        surface a hard store error for an object that still exists."""
        try:
            return self.store.get_pinned(key, timeout=0.0)
        except object_client.ObjectStoreError:
            return None

    def _should_reconstruct(self, oid: ObjectID, size: int) -> bool:
        """Restore-vs-reconstruct cost choice for a spilled object:
        restore costs ~size bytes of backend I/O, re-execution costs one
        task. With the default knob (0) restore always wins; when
        object_spill_reconstruct_min_bytes is set, objects at least that
        large prefer lineage re-execution — IF the runtime actually holds
        lineage for the object (the lineage_hint callback)."""
        from ray_tpu_torch import config
        floor = int(config.get("object_spill_reconstruct_min_bytes"))
        if floor <= 0 or (size and size < floor):
            return False
        hint = self.lineage_hint
        try:
            return bool(hint is not None and hint(oid))
        except Exception:
            return False

    def _restore_spilled(self, key: bytes, url: str, size: int) -> bool:
        """Restore one spilled object into local shm from its URL (the
        third tier of get_view). Admitted through the same pull byte
        budget as remote pulls; single-flight per object."""
        from ray_tpu_torch.cluster import spill as _spill
        with self._pull_guard:
            lock = self._pull_locks.setdefault(key, threading.Lock())
        with lock:
            if self.store.contains(key):
                return True
            admitted = max(size, 1)
            self._pull_budget.acquire(admitted)
            t0 = time.monotonic()
            try:
                fault_plane.fire("object.spill.restore", oid=key, url=url)
                data = _spill.read_url(url)
                try:
                    if len(data) <= self._inline_max():
                        self._with_put_backpressure(
                            len(data),
                            lambda: self.store.put_inline(key, data))
                    else:
                        def _create():
                            w = self.store.create_writer(key, len(data))
                            try:
                                w.write_at(0, data)
                            finally:
                                w.close()
                            self.store.seal(key)
                        self._with_put_backpressure(len(data), _create)
                except object_client.ObjectStoreError as e:
                    if "already exists" not in str(e):
                        raise
            except Exception:
                self._discard_partial(key)
                return False
            finally:
                self._pull_budget.release(admitted)
            self._restored_objects += 1
            self._restored_bytes += len(data)
            self._loc_batcher.add(key)
            _events.emit("object.spill.restore", key.hex(),
                         value=float(len(data)),
                         attrs={"secs": time.monotonic() - t0})
            return True

    def _pull(self, key: bytes, remote_addr: str,
              holder_id: Optional[bytes] = None) -> str:
        """Single-source pull (compat shim over _pull_from): one holder,
        no striping. Benchmarks use it to measure the raw per-link path."""
        return self._pull_from(
            key, [{"address": remote_addr, "node_id": holder_id}])

    def _pull_from(self, key: bytes, nodes: List[dict]) -> str:
        """Windowed, multi-source chunked pull of one object into local shm
        (pull_manager.h chunk-window + location-striping roles).

        ``nodes`` are the advertised non-local holders ({"node_id",
        "address"}). Single-flight per object: concurrent getters wait on
        the same pull. Probes every holder concurrently (object_info
        doubles as liveness check and load report), stripes the chunk
        ranges across up to object_pull_max_sources of the least-loaded
        holders for large objects, keeps object_pull_window fetch_chunk
        futures pipelined, writes completions out of order, and reassigns
        a failed holder's remaining chunks to the survivors.

        Returns "ok", or a failure class: "missing" (holders deny having
        it), "unreachable" (holder connections dead), "error"
        (local/other). missing/unreachable holders are reported to the
        directory (remove_object_location) so locate rounds — ours and
        every other node's — stop retrying replicas that cannot serve.
        """
        with self._pull_guard:
            lock = self._pull_locks.setdefault(key, threading.Lock())
        with lock:
            if self.store.contains(key):
                return "ok"
            _events.emit("pull.window", key.hex(), value=float(len(nodes)))
            watch = _events.watch_begin("pull", key.hex())
            t_pull = time.monotonic()
            admitted = 0
            created = False
            try:
                fault_plane.fire("object.pull", oid=key)
                holders, size, any_unreachable = self._probe_holders(
                    key, nodes)
                if not holders:
                    return "unreachable" if any_unreachable else "missing"
                sources = self._select_sources(holders, size)
                self._pull_budget.acquire(size)
                admitted = size
                # Backpressured create: a pull into a full store spills
                # cold locals to make room instead of erroring the get.
                w = self._with_put_backpressure(
                    size, lambda: self.store.create_writer(key, size))
                created = True
                try:
                    if self._shm_direct(key, w, size, holders):
                        outcome = "ok"
                    else:
                        outcome = self._run_transfer(key, w, size, sources)
                finally:
                    w.close()
                if outcome != "ok":
                    self._discard_partial(key)
                    return outcome
                self.store.seal(key)
            except object_client.ObjectStoreError as e:
                if "already exists" in str(e):
                    return "ok"
                if created:
                    self._discard_partial(key)
                raise
            except (ConnectionError, ConnectionLost, OSError, RpcError):
                if created:
                    self._discard_partial(key)
                return "unreachable"
            except Exception:
                if created:
                    self._discard_partial(key)
                return "error"
            finally:
                if admitted:
                    self._pull_budget.release(admitted)
                _events.watch_end(watch)
            self._loc_batcher.add(key)
            _events.emit("pull.done", key.hex(),
                         value=time.monotonic() - t_pull)
            return "ok"

    def _probe_holders(self, key: bytes, nodes: List[dict]):
        """Concurrent object_info probe of every advertised holder ->
        ([(node, client, transfer load)], size, any_unreachable). Holders
        that deny the object or whose connection is dead are reported to
        the directory."""
        probes = []
        for node in nodes:
            cli = get_client(node["address"])
            try:
                # _retry=True: one immediate fresh-channel resend if the
                # cached pipelined channel went stale (same at-least-once
                # contract as call(); object_info is a pure read).
                fut = cli.call_async("object_info", oid=key, _retry=True)
            except Exception:  # noqa: BLE001 - connect failed
                fut = None
            probes.append((node, cli, fut))
        holders = []
        size = 0
        any_unreachable = False
        for node, cli, fut in probes:
            try:
                if fut is None:
                    raise ConnectionLost("connect failed")
                info = fut.result(timeout=10.0)
            except (ConnectionError, ConnectionLost, OSError, RpcError,
                    _FutureTimeout):
                any_unreachable = True
                self._drop_location(key, node["node_id"])
                continue
            if not info.get("found"):
                self._drop_location(key, node["node_id"])
                continue
            size = info["size"]
            holders.append((node, cli, info.get("transfers", 0),
                            info.get("shm_path")))
        return holders, size, any_unreachable

    def _select_sources(self, holders: list, size: int) -> list:
        """Least-loaded holder choice with random tie-break (load-spread:
        a broadcast wave fans out over fresh copies instead of piling on
        the origin); large objects take several sources for striping."""
        from ray_tpu_torch import config
        random.shuffle(holders)
        holders.sort(key=lambda h: h[2])  # stable: ties stay shuffled
        if size >= int(config.get("object_stripe_min_bytes")) \
                and len(holders) > 1:
            return holders[:max(1, int(config.get(
                "object_pull_max_sources")))]
        return holders[:1]

    def _shm_direct(self, key: bytes, w: object_client.ShmWriter,
                    size: int, holders: list) -> bool:
        """Same-host fast path: when a holder daemon shares this machine,
        its segment file is visible in our /dev/shm — pin it remotely,
        then copy mapping-to-mapping (one memcpy at memory bandwidth,
        ~4x the TCP chunk path on loopback). The pin keeps the segment
        from being deleted or recycled under the copy; any failure falls
        back to the chunked transfer. Parity: plasma's same-node
        zero-copy sharing (Ray never streams between co-located object
        managers)."""
        from ray_tpu_torch import config
        if size == 0 or not config.get("object_pull_shm_direct"):
            return False
        for node, cli, _load, path in holders:
            if not path:
                continue
            try:
                if os.stat(path).st_size != size:
                    continue  # another host's coincidental segment name
            except OSError:
                continue
            pinned = False
            fd = -1
            try:
                if not cli.call("pin_object", oid=key).get("ok"):
                    continue
                pinned = True
                fd = os.open(path, os.O_RDONLY)
                if os.fstat(fd).st_size != size:
                    continue
                mm = mmap.mmap(fd, size, prot=mmap.PROT_READ)
                mv = memoryview(mm)
                try:
                    w.write_at(0, mv)
                finally:
                    mv.release()
                    mm.close()
                _events.emit("pull.shm_direct", key.hex(),
                             value=float(size),
                             attrs={"holder": node["address"]})
                return True
            except Exception:  # noqa: BLE001 - fall back to chunked pull
                continue
            finally:
                if fd >= 0:
                    os.close(fd)
                if pinned:
                    try:
                        cli.call("unpin_object", oid=key)
                    except Exception:
                        pass
        return False

    def _run_transfer(self, key: bytes, w: object_client.ShmWriter,
                      size: int, sources: list) -> str:
        """Windowed multi-source chunk loop -> "ok" | failure class.

        Chunk offsets are striped round-robin across the sources; up to
        object_pull_window fetch_chunk futures stay in flight on the
        pipelined channels and completions land in the writer OUT OF
        ORDER (write_at takes any offset). When a source fails its queued
        chunks re-stripe over the survivors; with no survivors the pull
        fails with the strongest failure class seen."""
        from ray_tpu_torch import config
        if size == 0:
            return "ok"
        ring = _events.enabled()
        key_hex = key.hex()
        chunk_bytes = max(1, int(config.get("object_transfer_chunk_bytes")))
        window = max(1, int(config.get("object_pull_window")))
        live = {i: src for i, src in enumerate(sources)}
        pending: Dict[int, deque] = {i: deque() for i in live}
        for j, off in enumerate(range(0, size, chunk_bytes)):
            pending[j % len(sources)].append(off)
        inflight: Dict[Any, Tuple[int, int]] = {}  # future -> (src, offset)
        remaining = sum(len(q) for q in pending.values())
        any_unreachable = any_missing = False

        def _kill_source(i: int, exc: Optional[BaseException]) -> None:
            nonlocal any_unreachable, any_missing
            node, _cli, _load, _path = live.pop(i)
            if isinstance(exc, (ConnectionError, ConnectionLost, OSError,
                                RpcError, _FutureTimeout)):
                any_unreachable = True
            elif isinstance(exc, KeyError):
                any_missing = True  # holder dropped the object mid-pull
            self._drop_location(key, node["node_id"])
            orphans = pending.pop(i, deque())
            _events.emit("pull.failover", key.hex(),
                         value=float(len(orphans)),
                         attrs={"holder": node["address"]})
            if live:
                order = list(live)
                for j, off in enumerate(orphans):
                    pending[order[j % len(order)]].append(off)

        def _issue_one() -> bool:
            # Round-robin over live sources with queued work; False when
            # nothing is issuable (window fills stop at remaining work).
            for i in sorted(live, key=lambda i: len(pending[i]),
                            reverse=True):
                if not pending[i]:
                    continue
                off = pending[i].popleft()
                node, cli, _load, _path = live[i]
                try:
                    fault_plane.fire("object.pull.chunk", oid=key,
                                     offset=off)
                    act = fault_plane.fire(
                        "object.pull.window", oid=key, offset=off,
                        holder=node["address"])
                    if act == "sever":
                        cli.sever_pipe()
                    fut = cli.call_async(
                        "fetch_chunk", oid=key, offset=off,
                        size=min(chunk_bytes, size - off))
                except BaseException as e:  # noqa: BLE001
                    pending[i].appendleft(off)
                    _kill_source(i, e)
                    return bool(live)
                inflight[fut] = (i, off)
                return True
            return False

        while remaining:
            while len(inflight) < window and _issue_one():
                pass
            if not inflight:
                # Sources exhausted with chunks still owed.
                break
            done, _ = _futures_wait(inflight, timeout=30.0,
                                    return_when=FIRST_COMPLETED)
            if not done:
                return "error"  # stalled transfer: no completion in 30s
            for fut in done:
                i, off = inflight.pop(fut)
                try:
                    chunk = fut.result()
                except BaseException as e:  # noqa: BLE001
                    if i in live:
                        _kill_source(i, e)
                    if live:
                        order = sorted(live, key=lambda k: len(pending[k]))
                        pending[order[0]].append(off)
                    continue
                w.write_at(off, chunk)
                if ring:
                    _events.emit("pull.chunk", key_hex,
                                 value=float(len(chunk)))
                remaining -= 1
        if remaining:
            if any_unreachable:
                return "unreachable"
            return "missing" if any_missing else "error"
        return "ok"

    def _discard_partial(self, key: bytes) -> None:
        # A failed pull must not leave a CREATED (unsealed) object behind:
        # the next attempt's create would report "already exists" (mapped
        # to "ok") while readers spin on an object nobody is filling.
        try:
            self.store.delete(key)
        except Exception:
            pass

    def _drop_location(self, key: bytes, holder_id: Optional[bytes]) -> None:
        if holder_id is None:
            return
        try:
            self.conductor.call("remove_object_location", oid=key,
                                node_id=holder_id)
        except Exception:
            pass  # directory unreachable; the next locate retries anyway

    def free(self, oid: ObjectID) -> None:
        self.conductor.call("free_object", oid=self._key(oid))

    # -- collective-backed broadcast (r16) -------------------------------
    def broadcast_object(self, oid: ObjectID, members: List[dict]) -> dict:
        """Spread one local object to ``members`` (daemon descriptors
        {"node_id", "address"}) via a tree of coordinated pulls — the
        gloo-style CPU-host collective over the pipelined RPC layer
        (on-TPU meshes broadcast in-program via collectives.broadcast_from
        and never hit this path). Each round every holder serves up to
        ``array_bcast_fanout`` new members, so aggregate bandwidth scales
        with the number of fresh copies instead of serializing N pulls
        through the origin's NIC (reference: collective-backed GPU object
        broadcast, python/ray/util/collective).

        A member whose tree leg fails (injected sever, daemon hiccup) is
        re-striped onto the classic directory-driven pull path — zero
        loss, degraded speed. Returns
        {"ok": [...], "fallback": [...], "failed": [...], "skipped": bool}
        of member node_ids.
        """
        from ray_tpu_torch import config

        key = self._key(oid)
        members = [m for m in members if m["node_id"] != self.node_id]
        result = {"ok": [], "fallback": [], "failed": [], "skipped": False}
        if not members:
            return result
        view = self._get_pinned_tolerant(key)
        if view is None:
            raise ObjectLostError(
                oid.hex(), "broadcast root does not hold the object")
        size = view.nbytes
        del view
        # Make sure the directory already knows the root's copy before any
        # member's pull (or its classic fallback) does a locate round.
        self._loc_batcher.flush()
        if size < int(config.get("array_bcast_min_bytes")) \
                or not self.daemon_address:
            # Too small for tree coordination to beat N direct pulls (or
            # no co-resident daemon to serve as rank-0 source): classic.
            result["skipped"] = True
            _events.emit("object.bcast.fallback", key.hex(),
                         value=float(len(members)))
            for m in members:
                if self._bcast_member_pull(key, m, None):
                    result["ok"].append(m["node_id"])
                else:
                    result["failed"].append(m["node_id"])
            return result
        leg_timeout = float(config.get("array_bcast_leg_timeout_s"))
        fanout = int(config.get("array_bcast_fanout"))
        # Rank 0 is the root (this plane's co-resident daemon shares its
        # store, so it can serve the object); ranks 1..n are the members.
        ranks = [{"node_id": self.node_id, "address": self.daemon_address}]
        ranks.extend(members)
        t0 = time.monotonic()
        reached: Dict[int, bool] = {0: True}
        fallback: List[int] = []
        for legs in broadcast_rounds(len(ranks), fanout=fanout):
            threads = []
            outcomes: Dict[int, bool] = {}

            def _leg(src: int, dst: int) -> None:
                ok = False
                try:
                    cli = get_client(ranks[dst]["address"])
                    # Legs ride the pipelined channel (call_async, single
                    # attempt): a severed channel fails the future FAST
                    # and the member re-stripes, instead of the pooled
                    # call path's transparent reconnect masking the cut.
                    fut = cli.call_async("pull_object", oid=key,
                                         sources=[ranks[src]])
                    act = fault_plane.fire(
                        "object.collective.bcast", oid=key,
                        src=ranks[src]["address"],
                        dst=ranks[dst]["address"])
                    if act == "sever":
                        cli.sever_pipe()
                    resp = fut.result(timeout=leg_timeout)
                    ok = bool(resp.get("ok"))
                except Exception:  # noqa: BLE001 - leg re-stripes below
                    ok = False
                outcomes[dst] = ok
                if ok:
                    _events.emit("object.bcast.leg", key.hex(),
                                 value=float(size))

            for src, dst in legs:
                if not reached.get(src):
                    # Upstream leg failed: this subtree re-stripes onto
                    # the classic path instead of pulling from a source
                    # that never got the object.
                    outcomes[dst] = False
                    continue
                t = threading.Thread(target=_leg, args=(src, dst),
                                     name="bcast-leg", daemon=True)
                threads.append(t)
                t.start()
            for t in threads:
                t.join()
            for src, dst in legs:
                if outcomes.get(dst):
                    reached[dst] = True
                else:
                    fallback.append(dst)
        for r, ok in reached.items():
            if r and ok:
                result["ok"].append(ranks[r]["node_id"])
        if fallback:
            _events.emit("object.bcast.fallback", key.hex(),
                         value=float(len(fallback)))
            for r in fallback:
                if self._bcast_member_pull(key, ranks[r], None):
                    result["fallback"].append(ranks[r]["node_id"])
                else:
                    result["failed"].append(ranks[r]["node_id"])
        _events.emit("object.bcast.done", key.hex(),
                     value=time.monotonic() - t0,
                     attrs={"members": len(members), "bytes": size,
                            "fallback": len(fallback)})
        return result

    def _bcast_member_pull(self, key: bytes, member: dict,
                           sources: Optional[list]) -> bool:
        """One member's directory-driven (classic) pull — the re-stripe
        target for failed tree legs. Its own connection may be the severed
        one, so retry once on a fresh channel before giving up."""
        from ray_tpu_torch import config
        timeout = float(config.get("array_bcast_leg_timeout_s"))
        for _ in range(2):
            try:
                resp = get_client(member["address"]).call(
                    "pull_object", oid=key, sources=sources,
                    _timeout=timeout)
                if resp.get("ok"):
                    return True
            except Exception:  # noqa: BLE001
                continue
        return False

    # -- introspection ---------------------------------------------------
    def metrics_probe(self) -> Dict[str, float]:
        """Point-in-time gauges for the event flusher (registered via
        events.register_probe — sampled once per flush period, never on
        the put/get hot path)."""
        inline = self._inline
        with inline._cv:
            cache_entries = len(inline._blobs)
            cache_bytes = inline._nbytes
            pending = len(inline._pending)
        budget = self._pull_budget
        with budget._cv:
            pull_used = budget._used
            pull_waiters = len(budget._queue)
        with self._loc_batcher._lock:
            loc_backlog = len(self._loc_batcher._buf)
        return {
            "rt_inline_cache_entries": float(cache_entries),
            "rt_inline_cache_bytes": float(cache_bytes),
            "rt_inline_pending_returns": float(pending),
            "rt_pull_inflight_bytes": float(pull_used),
            "rt_pull_budget_waiters": float(pull_waiters),
            "rt_location_batch_backlog": float(loc_backlog),
            "rt_spill_restored_objects": float(self._restored_objects),
            "rt_spill_restored_bytes": float(self._restored_bytes),
            "rt_array_pins_live": float(serialization.live_array_pins()),
        }

    def debug_state(self) -> dict:
        """Table sizes + budgets for debug-state dumps (the ObjectManager
        / PullManager sections of raylet's debug_state.txt)."""
        inline = self._inline
        with inline._cv:
            inline_state = {
                "cache_entries": len(inline._blobs),
                "cache_bytes": inline._nbytes,
                "cache_max_bytes": inline.max_bytes,
                "pending_returns": len(inline._pending),
            }
        budget = self._pull_budget
        with budget._cv:
            pull_state = {"budget_cap": budget.cap,
                          "budget_used": budget._used,
                          "budget_waiters": len(budget._queue),
                          "locks": len(self._pull_locks)}
        with self._loc_batcher._lock:
            batcher_state = {
                "backlog": len(self._loc_batcher._buf),
                "dropped_total": self._loc_batcher.dropped_total,
            }
        return {"inline_cache": inline_state, "pulls": pull_state,
                "location_batcher": batcher_state,
                "Restored": self._restored_objects,
                "restored_bytes": self._restored_bytes}

    def stop(self) -> None:
        self._loc_batcher.stop()
