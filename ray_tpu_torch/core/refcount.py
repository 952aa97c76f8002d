"""Process-local reference ledger + batched updates to the conductor.

Role parity: src/ray/core_worker/reference_count.h:61 — the reference
counter that keeps an object alive while any handle, in-flight task
argument, or containing object can still reach it, and frees its store
copies when the count drops to zero. The reference keeps the ledger on the
object's owner worker; here ownership is centralized on the conductor
(matching the centralized object directory), so every process ships an
ORDERED stream of count events and the conductor applies them in order:

- ``handle_created`` / ``handle_dropped``: an ``ObjectRef`` instance was
  created/garbage-collected in this process. Only the 0<->1 transitions of
  the process-local count become events.
- ``pin`` / ``unpin``: an explicit +1/-1 (in-flight task arguments between
  submit and execution-ack; recovery pins).
- ``add_children``: a stored object contains serialized ObjectRefs — the
  children must outlive the parent (reference_count.h nested-ref tracking);
  the conductor +1s each child and -1s them when the parent is freed.

Ordering is what makes the protocol race-free without per-borrower state:
within one process, events flush in program order; across the task-arg
handoff, the executing worker flushes its events BEFORE acking the push
RPC, and the submitter unpins only AFTER the ack — so a borrower's +1
always reaches the conductor before the submitter's balancing -1.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import store_key

# Coalescing window between the first buffered event and the flush RPC
# (the flusher is otherwise parked — no idle wakeups). Kept short because
# garbage lag bounds how fast the store's segment-recycle pool refills
# under put-heavy loops: a 100MB put is ~10ms, so a 50ms lag would leave
# every iteration allocating fresh zero-fill pages and pressure-evicting.
_FLUSH_INTERVAL_S = 0.005
_FLUSH_BATCH = 2000


class RefTracker:
    def __init__(self, conductor_client):
        self._cli = conductor_client
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # Optional hook fired (outside the lock) with the 16B store key
        # when the process-local handle count for an object hits zero —
        # the runtime wires it to the object plane's inline-cache eviction
        # so reply-carried results are dropped as soon as the owner stops
        # referencing them (no leak when the ref dies before lazy seal).
        self.on_zero = None
        # oid binary (20B) -> number of live ObjectRef handles here
        self._local: Dict[bytes, int] = {}
        # store key (16B) -> live explicit pins from this process (kept so
        # a conductor-failover resync can replay this process's full truth)
        self._pins: Dict[bytes, int] = {}
        # ordered outbound events: (key16, ±1) or (key16, [child keys])
        self._events: List[Tuple[bytes, object]] = []
        self._epoch: Optional[str] = None   # last seen conductor epoch
        self._pending_batch: Optional[Tuple[str, list]] = None
        self._stopped = False
        self._flush_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ref-flush")
        self._thread.start()

    def _append_event(self, ev) -> None:
        """Caller holds self._lock. Wakes the parked flusher on the FIRST
        buffered event (it coalesces a burst before shipping)."""
        self._events.append(ev)
        if len(self._events) == 1 or len(self._events) >= _FLUSH_BATCH:
            self._cv.notify()

    # -- handle lifecycle (called from ObjectRef __init__/__del__) ------
    def handle_created(self, oid: bytes) -> None:
        with self._cv:
            c = self._local.get(oid, 0)
            self._local[oid] = c + 1
            if c == 0:
                self._append_event((store_key(oid), 1))

    def handle_dropped(self, oid: bytes) -> None:
        zero = False
        with self._cv:
            c = self._local.get(oid, 0) - 1
            if c <= 0:
                self._local.pop(oid, None)
                self._append_event((store_key(oid), -1))
                zero = True
            else:
                self._local[oid] = c
        if zero:
            cb = self.on_zero
            if cb is not None:
                try:
                    cb(store_key(oid))
                except Exception:
                    pass  # may run from __del__ during interpreter teardown

    def holds(self, oid: bytes) -> bool:
        """True while this process has live handles to ``oid`` (used by the
        lineage evictor: records for still-referenced objects must stay)."""
        with self._lock:
            return self._local.get(oid, 0) > 0

    # -- explicit pins (submitter-side in-flight task args) -------------
    def pin_all(self, keys: List[bytes], flush: bool = True) -> None:
        """Pin keys and (by default) flush SYNCHRONOUSLY. The flush is what
        upholds the cross-process invariant: a ref may only leave this
        process (task args, stored containers) once this process's +1s are
        durable at the conductor — otherwise a borrower's transient +1/-1
        pair can transit the count through zero and free a live object."""
        with self._lock:
            for k in keys:
                self._pins[k] = self._pins.get(k, 0) + 1
                self._append_event((k, 1))
        if flush:
            self.flush()

    def pins_need_sync(self, keys: List[bytes]) -> bool:
        """Whether pinning ``keys`` must flush synchronously before the
        refs travel. The sync flush in pin_all exists to make this
        process's +1s durable before a borrower's transient +1/-1 pair can
        reach the conductor; when NO buffered/unacked event touches these
        keys, their handle-created +1s (the caller provably holds a live
        handle per arg ref) are already durable, so the count can never
        transit zero and the pin may ride the ordered 5ms stream instead
        of paying a conductor round trip per call."""
        # An in-flight flush has MOVED events out of the buffer without
        # them being durable yet — holding _flush_lock for the check rules
        # that window out (same lock order as flush: _flush_lock, _lock).
        if not self._flush_lock.acquire(blocking=False):
            return True
        try:
            with self._lock:
                if self._pending_batch is not None or \
                        self._epoch == "force-resync":
                    return True
                if not self._events:
                    return False
                ks = set(keys)
                for k, v in self._events:
                    if k in ks:
                        return True
                    if isinstance(v, list) and not ks.isdisjoint(v):
                        return True
            return False
        finally:
            self._flush_lock.release()

    def unpin_all(self, keys: List[bytes]) -> None:
        with self._lock:
            for k in keys:
                c = self._pins.get(k, 0) - 1
                if c <= 0:
                    self._pins.pop(k, None)
                else:
                    self._pins[k] = c
                self._append_event((k, -1))

    def add_children(self, parent_key: bytes, child_keys: List[bytes],
                     flush: bool = True) -> None:
        """Register parent->children containment. Flushed synchronously by
        default for the same reason as pin_all: the children's +1s must be
        durable before the parent object becomes readable (a getter could
        otherwise deserialize + drop child handles whose net-zero event
        pair outruns this registration)."""
        with self._lock:
            self._append_event((parent_key, list(child_keys)))
        if flush:
            self.flush()

    # -- flushing -------------------------------------------------------
    def _snapshot_events(self) -> List[Tuple[bytes, object]]:
        """This process's full current truth as +1 events (used to rebuild
        the conductor's volatile ledger after failover). Caller holds
        self._lock."""
        snap: List[Tuple[bytes, object]] = []
        for oid, c in self._local.items():
            if c > 0:
                snap.append((store_key(oid), 1))
        for k, c in self._pins.items():
            snap.extend([(k, 1)] * c)
        return snap

    def flush(self) -> None:
        """Ship buffered events, preserving order. Safe to call from any
        thread; the executing-worker ack path calls this synchronously.

        Failover: each update carries the last seen conductor epoch. On an
        epoch mismatch the conductor rejects (volatile ledger was lost) and
        this tracker replays a snapshot of its full local truth instead —
        buffered transitions are folded into that snapshot."""
        with self._flush_lock:  # one flusher at a time keeps the order
            import uuid
            # Retry a previously-failed batch under its ORIGINAL batch_id
            # (the id is what makes at-least-once delivery idempotent: if
            # the connection died after the conductor applied it, the
            # resend is deduped server-side instead of double-counting).
            if self._pending_batch is not None:
                batch_id, events = self._pending_batch
            else:
                with self._lock:
                    events, self._events = self._events, []
                    # A forced resync must go out even with an empty
                    # buffer: the sentinel epoch is rejected server-side,
                    # which is what routes us into the snapshot replay.
                    need_resync = self._epoch == "force-resync"
                if not events and not need_resync:
                    return
                batch_id = uuid.uuid4().hex
            with self._lock:
                epoch = self._epoch
            try:
                resp = self._cli.call("ref_update", deltas=events,
                                      epoch=epoch, batch_id=batch_id)
            except Exception:
                # Conductor unreachable (shutdown / failover window):
                # retain the batch for the next attempt. A batch too big
                # to retain must NOT silently diverge the ledger — force a
                # full resync instead (the sentinel never matches a real
                # epoch, so the next flush is rejected into the resync
                # path and replays this process's whole truth).
                if len(events) <= 100_000:
                    self._pending_batch = (batch_id, events)
                else:
                    with self._lock:
                        self._epoch = "force-resync"
                        # children registrations aren't reconstructable
                        # from local truth — keep those for the resync
                        self._events = [e for e in events
                                        if isinstance(e[1], list)] + \
                            self._events
                # Wake a parked flusher into its retry timer: this flush
                # may have been called from a NON-loop thread (pin with
                # flush=True during a conductor outage), and without a
                # notify the buffered deltas strand until some unrelated
                # ref event arrives.
                with self._cv:
                    self._cv.notify()
                return
            self._pending_batch = None
            if resp.get("resync"):
                with self._lock:
                    new_epoch = resp["epoch"]
                    # ±1 transitions (rejected batch AND buffer) are
                    # already folded into the truth the snapshot captures —
                    # clear them all, or they'd re-apply on the new epoch.
                    # Children registrations are not part of the truth;
                    # carry them explicitly.
                    children = [e for e in events + self._events
                                if isinstance(e[1], list)]
                    snap = self._snapshot_events() + children
                    self._events = []
                try:
                    # batch_id: the reconnecting client retries at-least-
                    # once; without dedup a lost response would double the
                    # whole baseline. Epoch commits only AFTER the replay
                    # lands — a failed replay re-resyncs next flush.
                    self._cli.call("ref_update", deltas=snap,
                                   epoch=new_epoch,
                                   batch_id=uuid.uuid4().hex)
                    with self._lock:
                        self._epoch = new_epoch
                except Exception:
                    with self._lock:
                        self._events = children + self._events
            else:
                with self._lock:
                    self._epoch = resp.get("epoch")

    def _loop(self) -> None:
        while True:
            with self._cv:
                # Event-driven: park until the FIRST buffered event (no
                # idle wakeups — N processes polling at the flush interval
                # measurably tax a small host), then sleep one interval so
                # a burst coalesces into a single RPC. A failed batch
                # (_pending_batch) must keep retrying on a timer though —
                # parking would strand its -1 deltas until some unrelated
                # ref event happened to arrive.
                while not self._events and not self._stopped and \
                        self._pending_batch is None and \
                        self._epoch != "force-resync":
                    self._cv.wait()
                if self._stopped and not self._events:
                    return
                retrying = (self._pending_batch is not None or
                            self._epoch == "force-resync") and \
                    not self._events
            time.sleep(0.5 if retrying else _FLUSH_INTERVAL_S)
            self.flush()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self.flush()
