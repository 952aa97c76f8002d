"""Local GPU count and generation, for the cluster runtime's ``"GPU"``
resource. Takes the place of ``ray_tpu/tpu/topology.py:local_chip_count``.

The count must not initialise CUDA in the asking process: the head's
node daemon runs in the driver, and a process whose CUDA is initialised
cannot hand a working CUDA to a child it forks. So the answer comes from
the driver's own CUDA when that is already initialised, else from a
short-lived subprocess, and is cached for the life of the process. A host
with no NVIDIA driver node answers 0 without a probe. ``CUDA_VISIBLE_DEVICES``
is honoured as CUDA honours it. Slice-like groupings (NVLink peers) are
still to port (ROADMAP.md A.5).
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional, Tuple

_PROBE_SRC = (
    "import torch\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "cc = [torch.cuda.get_device_capability(i) for i in range(n)]\n"
    "print(n, *(f'{a}.{b}' for a, b in cc))\n")

_cache: Optional[Tuple[int, Tuple[str, ...]]] = None


def _driver_present() -> bool:
    return (os.path.exists("/proc/driver/nvidia/version")
            or os.path.exists("/dev/nvidia0"))


def _probe(timeout_s: float = 60.0) -> Tuple[int, Tuple[str, ...]]:
    if os.environ.get("CUDA_VISIBLE_DEVICES", None) == "":
        return 0, ()
    if not _driver_present():
        return 0, ()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        n = torch.cuda.device_count()
        return n, tuple("%d.%d" % torch.cuda.get_device_capability(i)
                        for i in range(n))
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE_SRC],
                             capture_output=True, text=True,
                             timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired):
        return 0, ()
    if out.returncode != 0:
        return 0, ()
    fields = out.stdout.split()
    return int(fields[0]), tuple(fields[1:])


def _info() -> Tuple[int, Tuple[str, ...]]:
    global _cache
    if _cache is None:
        _cache = _probe()
    return _cache


def local_gpu_count() -> int:
    """Cards this host offers to the runtime (0 without a driver)."""
    return _info()[0]


def is_sm90() -> bool:
    """True when every local card is compute capability 9.0 (Hopper)."""
    n, caps = _info()
    return n > 0 and all(c == "9.0" for c in caps)
