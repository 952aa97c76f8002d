"""Per-operator execution statistics. Ported from ``ray_tpu/data/stats.py``
as written.

Role parity: python/ray/data/_internal/stats.py (DatasetStats /
StatsManager) — after (or during) execution, ``Dataset.stats()`` returns a
per-operator summary: task counts, block counts, and task latency
min/mean/max, plus the operator's wall-clock span. Collected entirely at
the driver from submit/ready timestamps — no extra transfers and no
change to the block protocol.
"""

from __future__ import annotations

import time
from typing import List, Optional


class OpStats:
    def __init__(self, name: str):
        self.name = name
        self.tasks_submitted = 0
        self.blocks_out = 0
        self.task_latencies: List[float] = []
        self.first_submit: Optional[float] = None
        self.last_done: Optional[float] = None

    # -- recording hooks (called by the streaming operators) ------------
    def on_submit(self) -> float:
        now = time.perf_counter()
        self.tasks_submitted += 1
        if self.first_submit is None:
            self.first_submit = now
        return now

    def on_done(self, t_submit: Optional[float], n_blocks: int = 1) -> None:
        now = time.perf_counter()
        self.last_done = now
        self.blocks_out += n_blocks
        if t_submit is not None:
            self.task_latencies.append(now - t_submit)

    # -- reporting -------------------------------------------------------
    @property
    def wall_s(self) -> float:
        if self.first_submit is None or self.last_done is None:
            return 0.0
        return self.last_done - self.first_submit

    def summary(self) -> str:
        lat = self.task_latencies
        if lat:
            tl = (f"task latency min/mean/max "
                  f"{min(lat):.3f}s/{sum(lat) / len(lat):.3f}s/"
                  f"{max(lat):.3f}s")
        else:
            tl = "no tasks"
        return (f"Operator {self.name}: {self.tasks_submitted} tasks, "
                f"{self.blocks_out} blocks out, wall {self.wall_s:.3f}s, "
                f"{tl}")


class DatasetStats:
    """Aggregated view over one execution's operator chain."""

    def __init__(self, op_stats: List[OpStats]):
        self.ops = op_stats

    def summary(self) -> str:
        if not self.ops:
            return "Dataset executed with no operators (source blocks only)"
        lines = [s.summary() for s in self.ops]
        total = sum(s.wall_s for s in self.ops)
        lines.append(f"Total (sum of operator walls): {total:.3f}s")
        return "\n".join(lines)

    def __repr__(self):
        return self.summary()
