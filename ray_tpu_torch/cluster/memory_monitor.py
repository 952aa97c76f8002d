"""Node memory monitor + worker-killing policy.

Role parity: src/ray/common/memory_monitor.h:52 (periodic usage sampling
against a threshold, cgroup/procfs-based) and
src/ray/raylet/worker_killing_policy.h:34 (pick a victim worker when the
node is over the threshold: prefer retriable work, then the most recently
started — the reference's group-by-retriable-then-LIFO policy).

The daemon kills the victim's worker process; the submitter observes the
dead lease/actor and retries through the normal fault-tolerance path, so
an OOM-killed retriable task re-runs instead of taking the daemon down
with it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional


def system_memory_usage_fraction() -> float:
    """Fraction of system memory in use, from /proc/meminfo (the reference
    reads the same, memory_monitor.cc GetMemoryBytes)."""
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0.0
    if not total:
        return 0.0
    return 1.0 - (avail or 0) / total


def process_rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


class WorkerKillingPolicy:
    """Choose a victim among candidate workers (worker_killing_policy.h:34).

    Candidates are dicts: {"pid", "retriable" (bool), "started_at" (float),
    "worker": opaque}. Preference: retriable first; within a group, the
    LAST started dies first (its work is cheapest to redo)."""

    @staticmethod
    def pick(candidates: List[dict]) -> Optional[dict]:
        if not candidates:
            return None
        return sorted(
            candidates,
            key=lambda c: (not c.get("retriable", True),
                           -(c.get("started_at") or 0.0)))[0]


class MemoryMonitor:
    """Periodic sampler; fires ``on_over_threshold`` when usage crosses the
    configured fraction. ``usage_fn`` is injectable for tests."""

    def __init__(self, threshold: float,
                 on_over_threshold: Callable[[float], None],
                 usage_fn: Callable[[], float] = system_memory_usage_fraction,
                 period_s: float = 0.25):
        self.threshold = threshold
        self._cb = on_over_threshold
        self._usage_fn = usage_fn
        self._period = period_s
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="memory-monitor")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stopped.wait(self._period):
            try:
                usage = self._usage_fn()
            except Exception:
                continue
            if usage >= self.threshold:
                try:
                    self._cb(usage)
                except Exception:
                    pass

    def stop(self) -> None:
        self._stopped.set()
