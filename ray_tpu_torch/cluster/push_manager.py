"""Sender-initiated object push.

Role parity: src/ray/object_manager/push_manager.h — when the owner learns a
task's destination node, it proactively streams the task's argument objects
there instead of waiting for the destination worker to discover and pull
them (saves the locate round-trip and overlaps transfer with worker
checkout). Push is best-effort: the destination's pull path remains the
correctness backstop, so any push failure is simply dropped.

Dedup and flow control follow the reference: one in-flight push per
(object, destination), a recently-pushed TTL cache so hot args aren't
re-sent to the same node, and a global in-flight byte cap (push_manager.h
chunk window role).
"""

from __future__ import annotations

import pickle
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

from ray_tpu_torch.cluster import fault_plane
from ray_tpu_torch.cluster.protocol import get_client
from ray_tpu_torch.util import events as _events

PUSH_CHUNK = 1 << 20          # bytes per push_chunk RPC
_RECENT_TTL_S = 30.0          # don't re-push same (oid, target) within this
_MAX_INFLIGHT_BYTES = 256 << 20


class PushManager:
    def __init__(self, store, self_daemon_address: str):
        self.store = store
        self.self_daemon = self_daemon_address
        self._inflight: Dict[Tuple[bytes, str], float] = {}
        self._recent: Dict[Tuple[bytes, str], float] = {}
        self._lock = threading.Lock()
        self._bytes = 0
        self._pool = ThreadPoolExecutor(max_workers=4,
                                        thread_name_prefix="obj-push")

    def maybe_push(self, key: bytes, target_daemon: str) -> bool:
        """Queue a best-effort push of a LOCAL object to target_daemon.
        Returns True if a push was scheduled."""
        if target_daemon == self.self_daemon:
            return False
        ident = (key, target_daemon)
        now = time.monotonic()
        with self._lock:
            if ident in self._inflight:
                return False
            ts = self._recent.get(ident)
            if ts is not None and now - ts < _RECENT_TTL_S:
                return False
            if self._bytes >= _MAX_INFLIGHT_BYTES:
                return False  # saturated: destination pull is the backstop
            self._inflight[ident] = now
            if len(self._recent) > 4096:
                cutoff = now - _RECENT_TTL_S
                self._recent = {k: v for k, v in self._recent.items()
                                if v > cutoff}
        self._pool.submit(self._push, ident)
        return True

    def _push(self, ident: Tuple[bytes, str]) -> None:
        key, target = ident
        admitted = 0
        try:
            view = self.store.get(key, timeout=0.0)
            if view is None:
                return  # not local (or evicted since) — nothing to push
            try:
                size = view.nbytes
                with self._lock:
                    self._bytes += size
                admitted = size
                from ray_tpu_torch import config
                cli = get_client(target)
                # Per-push stream id: lets the receiver tell this push's
                # chunks apart from a competing sender's (node_daemon
                # rpc_push_chunk rejects cross-stream chunks instead of
                # destroying the in-progress entry).
                import os as _os
                stream = _os.urandom(8).hex()
                # Windowed pipelined sends (push_manager.h chunk window):
                # keep object_push_window chunk RPCs in flight on one
                # channel; the receiver accepts out-of-order offsets within
                # a stream. PickleBuffer chunks ride the RPC frame's
                # out-of-band path — sent straight from the shm mapping,
                # never copied into a bytes().
                window = max(1, int(config.get("object_push_window")))
                futs: deque = deque()

                def _acked_terminal() -> bool:
                    # Bounded per-chunk wait: a hung destination must not
                    # pin this pool thread / the in-flight byte budget.
                    resp = futs.popleft().result(timeout=30.0)
                    # done/reject: destination has it / is pulling it.
                    return bool(resp.get("done") or resp.get("reject"))

                done = False
                off = 0
                while off < size and not done:
                    n = min(PUSH_CHUNK, size - off)
                    act = fault_plane.fire("object.push.chunk", oid=key,
                                           offset=off, target=target)
                    if act == "sever":
                        cli.sever_pipe()
                    _events.emit("push.chunk", key.hex(), value=float(n),
                                 attrs={"target": target})
                    futs.append(cli.call_async(
                        "push_chunk", oid=key, offset=off, total=size,
                        chunk=pickle.PickleBuffer(view[off:off + n]),
                        stream=stream))
                    off += n
                    while len(futs) >= window and not done:
                        done = _acked_terminal()
                while futs and not done:
                    done = _acked_terminal()
            finally:
                self.store.release(key)
        except Exception:
            pass  # best-effort: destination pull path covers it
        finally:
            with self._lock:
                if admitted:
                    self._bytes -= admitted
                self._inflight.pop(ident, None)
                self._recent[ident] = time.monotonic()

    def stats(self) -> dict:
        with self._lock:
            return {"inflight": len(self._inflight),
                    "inflight_bytes": self._bytes,
                    "recent": len(self._recent)}
