"""Durable control-plane state: snapshot + append-only journal.

Role parity: src/ray/gcs/gcs_server/gcs_table_storage.h (per-table durable
writes), store_client/redis_store_client.h (the backing store; here a local
file pair in the session dir — the conductor is single-node the way a
one-replica Redis is), and gcs_init_data.h (bulk load on restart).

Only DURABLE tables are journaled: nodes, actors, placement groups, KV,
function table, job counter. Volatile state (object directory, reference
counts, task events) is rebuilt after failover: node daemons re-advertise
their store contents when they observe a new conductor epoch, and ref
trackers resync their full ledger (core/refcount.py).

Format: files opening with the ``RTJ2`` magic hold [4B little-endian
length][4B CRC32][pickle(kind, data)] frames; files without it are the
legacy CRC-less [4B length][pickle] layout (still readable). The CRC
catches the failure the length prefix can't: a torn WRITE (power loss
mid-frame where the length landed but the body is short or garbage) that
still happens to parse — without it a half-written pickle can replay as a
wrong-but-valid mutation and silently poison recovery. ``load`` stops at
the first bad frame AND truncates the log back to the last good one, so
appends after restart never land beyond garbage the next reader would
stop at (orphaning everything after the tear).
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
import zlib
from typing import Any, List, Optional, Tuple

_MAGIC = b"RTJ2"


def _scan(path: str) -> Tuple[List[Tuple[str, Any]], int]:
    """Parse every valid frame; returns (records, end offset of the last
    good frame — the truncation point for a torn/corrupt tail)."""
    records: List[Tuple[str, Any]] = []
    if not os.path.exists(path):
        return records, 0
    with open(path, "rb") as f:
        data = f.read()
    crc_mode = data[:4] == _MAGIC
    off = 4 if crc_mode else 0
    hdr = 8 if crc_mode else 4
    good = off
    while off + hdr <= len(data):
        if crc_mode:
            length, crc = struct.unpack_from("<II", data, off)
        else:
            (length,) = struct.unpack_from("<I", data, off)
            crc = None
        body = data[off + hdr:off + hdr + length]
        if len(body) < length:
            break  # torn tail: crash mid-append
        if crc is not None and zlib.crc32(body) != crc:
            break  # torn write: full-length but corrupt body
        try:
            records.append(pickle.loads(body))
        except Exception:
            break
        off += hdr + length
        good = off
    return records, good


def _file_crc_mode(path: str) -> bool:
    """Whether an existing journal file uses CRC framing (empty/missing
    files adopt it)."""
    try:
        with open(path, "rb") as f:
            head = f.read(4)
    except OSError:
        return True
    return len(head) < 4 or head == _MAGIC


class StateJournal:
    """Append-mutations / snapshot-compaction pair for one conductor."""

    COMPACT_EVERY = 5000  # mutations between snapshots

    def __init__(self, prefix: str):
        self.snap_path = prefix + ".snap"
        self.log_path = prefix + ".log"
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._log_file = None
        self._log_crc = True  # framing of the OPEN log file
        self._appended = 0
        self._closed = False

    # -- load -----------------------------------------------------------
    def load(self) -> Tuple[Optional[dict], List[Tuple[str, Any]]]:
        """Returns (snapshot or None, ordered mutation records). Truncates
        the log's torn tail so post-restore appends extend the good
        prefix instead of landing after garbage no reader reaches."""
        snapshot = None
        snap_records, _ = _scan(self.snap_path)
        for kind, data in snap_records:
            if kind == "snapshot":
                snapshot = data
        records, good_end = _scan(self.log_path)
        with self._lock:
            try:
                if os.path.exists(self.log_path) and \
                        os.path.getsize(self.log_path) > good_end and \
                        self._log_file is None and not self._closed:
                    with open(self.log_path, "r+b") as f:  # rtcheck: allow-blocking(journal lock serializes disk writes; no RPC under it)
                        f.truncate(good_end)
            except OSError:
                pass
        return snapshot, records

    # -- write ----------------------------------------------------------
    def _frame(self, kind: str, data: Any, crc_framed: bool = True) -> bytes:
        body = pickle.dumps((kind, data), protocol=5)
        if crc_framed:
            return struct.pack("<II", len(body), zlib.crc32(body)) + body
        return struct.pack("<I", len(body)) + body

    def append(self, kind: str, data: Any) -> bool:
        """Append one mutation. Returns True when a compaction is due."""
        with self._lock:
            if self._closed:
                return False
            if self._log_file is None:
                # Match the framing already on disk: mixing CRC frames
                # into a legacy-framed log would desync its reader.
                self._log_crc = _file_crc_mode(self.log_path)
                self._log_file = open(self.log_path, "ab")  # rtcheck: allow-blocking(journal lock serializes disk writes; no RPC under it)
                if self._log_crc and self._log_file.tell() == 0:
                    self._log_file.write(_MAGIC)
            self._log_file.write(self._frame(kind, data, self._log_crc))
            self._log_file.flush()
            self._appended += 1
            return self._appended >= self.COMPACT_EVERY

    def snapshot(self, state: dict) -> None:
        """Write a full snapshot and truncate the journal."""
        tmp = self.snap_path + ".tmp"
        with self._lock:
            if self._closed:
                # a stopped conductor must never truncate files a same-dir
                # successor may already be journaling into
                return
            with open(tmp, "wb") as f:  # rtcheck: allow-blocking(journal lock serializes disk writes; no RPC under it)
                f.write(_MAGIC)
                f.write(self._frame("snapshot", state))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            if self._log_file is not None:
                self._log_file.close()
            self._log_file = open(self.log_path, "wb")  # rtcheck: allow-blocking(journal lock serializes disk writes; no RPC under it)
            self._log_file.write(_MAGIC)
            self._log_crc = True
            self._appended = 0

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._log_file is not None:
                try:
                    self._log_file.close()
                except OSError:
                    pass
                self._log_file = None
