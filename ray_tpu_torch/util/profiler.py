"""In-process sampling profiler: flamegraph-able stack dumps on demand.

Role parity: dashboard/modules/reporter/profile_manager.py — the
reference shells out to py-spy to sample a worker. py-spy isn't in this
image, and a TPU worker's interesting stacks are PYTHON stacks (the
device work is asynchronous XLA); sampling ``sys._current_frames`` from
inside the target process gives the same flamegraph for zero
dependencies, triggered over the worker's existing RPC server — no
ptrace, works under any container seccomp policy.

Output format: collapsed stacks ("frame;frame;frame count" lines) —
feed straight to flamegraph.pl or speedscope.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter
from typing import Dict, Optional


def _format_frame(frame) -> str:
    code = frame.f_code
    return f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}"


def sample_once(exclude_thread: Optional[int] = None) -> Dict[str, int]:
    """One snapshot of every thread's stack -> {collapsed_stack: 1}."""
    out: Dict[str, int] = {}
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        if tid == exclude_thread:
            continue
        stack = []
        f = frame
        while f is not None:
            stack.append(_format_frame(f))
            f = f.f_back
        key = names.get(tid, str(tid)) + ";" + ";".join(reversed(stack))
        out[key] = out.get(key, 0) + 1
    return out


def collect(duration_s: float = 1.0, interval_s: float = 0.01) -> str:
    """Sample this process for ``duration_s``; returns collapsed-stack
    text. The sampling thread excludes itself."""
    counts: Counter = Counter()
    me = threading.get_ident()
    deadline = time.monotonic() + duration_s
    while time.monotonic() < deadline:
        counts.update(sample_once(exclude_thread=me))
        time.sleep(interval_s)
    return "\n".join(f"{stack} {n}" for stack, n in
                     sorted(counts.items(), key=lambda kv: -kv[1]))
