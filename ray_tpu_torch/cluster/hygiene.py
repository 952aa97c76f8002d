"""Stale-session sweeper: reclaim what crashed sessions left behind.

Role parity: the reference gets most of this for free from its process
model — plasma is one arena file whose pages die with the raylet
(plasma/store_runner.cc), and `ray stop` pkills the whole process family
(python/ray/scripts/scripts.py cleanup path). Our per-object shm segments
and Popen'd store/zygote daemons need an explicit reclaim path for the one
case no watchdog survives: SIGKILL of the whole tree.

Namespace swept (everything this framework creates is `rtpt-`-prefixed):
  /dev/shm/<prefix>*        — object segments; <prefix>owner names the
                              store pid (written by shmstored at startup)
  /tmp/rtpt-session-*       — session dirs; daemon.pid names the owner
  /tmp/rtpt-head-<port>     — CLI head session dirs (same pidfile)
  /tmp/rtpt-ckpt-*,
  /tmp/rtpt-algo-*          — checkpoint scratch; owner.pid or age-based

Ported from ``ray_tpu/cluster/hygiene.py`` with the port's own prefix
(``rtpt-`` where the JAX package has ``rtpu-``), so neither package's sweep
ever touches the other's live segments or sessions, and with the temporary
directory taken from ``tempfile.gettempdir()`` (``TMPDIR``) where the JAX
module lists ``/tmp``.

Safety: a group is reclaimed ONLY when its recorded owner pid is dead, or
when it has no owner record AND is old enough that no live session can
still be mid-creation (no pidfile yet). Live sessions are never touched.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
import time
from typing import List

SHM_DIR = "/dev/shm"
# rtpt-<8 hex>- : one group per shmstored instance (node_daemon.py
# store_prefix). The owner marker is <prefix>owner.
_SHM_GROUP = re.compile(r"^(rtpt-[0-9a-f]{8}-)")
_TMP_PATTERNS = ("rtpt-session-",)
# Checkpoint/algo scratch may legitimately outlive its creating process
# (Checkpoint dirs are handed across workers on the same host, and a
# 30h experiment's checkpoints are live user data regardless of age) —
# swept only on EXPLICIT teardown (`stop`), only when very old.
_SCRATCH_PATTERNS = ("rtpt-ckpt-", "rtpt-algo-")
_SCRATCH_MAX_AGE_S = 24 * 3600.0
# Grace before reclaiming anything that carries no owner record: covers
# the window between mkdtemp/shm_open and the pidfile/marker write.
_NO_OWNER_GRACE_S = 120.0


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def _read_pid(path: str) -> int:
    try:
        with open(path) as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return -1


def write_pidfile(directory: str) -> None:
    """Record this process as the directory's owner (read by the sweep)."""
    try:
        tmp = os.path.join(directory, ".pid.tmp")
        with open(tmp, "w") as f:
            f.write(f"{os.getpid()}\n")
        os.replace(tmp, os.path.join(directory, "daemon.pid"))
    except OSError:
        pass


def sweep_shm(now: float | None = None) -> List[str]:
    """Unlink /dev/shm segment groups whose owning store is dead."""
    removed: List[str] = []
    now = now or time.time()
    try:
        names = os.listdir(SHM_DIR)
    except OSError:
        return removed
    groups = {}
    for name in names:
        m = _SHM_GROUP.match(name)
        if m:
            groups.setdefault(m.group(1), []).append(name)
    for prefix, members in groups.items():
        owner = os.path.join(SHM_DIR, prefix + "owner")
        pid = _read_pid(owner)
        if pid > 0 and _pid_alive(pid):
            continue
        if pid <= 0:
            # No owner marker (pre-marker leak, or marker write raced):
            # only reclaim once the group is stale beyond doubt.
            try:
                age = now - max(os.path.getmtime(os.path.join(SHM_DIR, n))
                                for n in members)
            except OSError:
                age = _NO_OWNER_GRACE_S + 1
            if age < _NO_OWNER_GRACE_S:
                continue
        for n in members:
            try:
                os.unlink(os.path.join(SHM_DIR, n))
                removed.append(n)
            except OSError:
                pass
    return removed


def sweep_tmp(now: float | None = None,
              include_scratch: bool = False) -> List[str]:
    """Remove session dirs whose owner died; scratch only on request."""
    removed: List[str] = []
    now = now or time.time()
    tmp = tempfile.gettempdir()
    roots = []
    for name in _TMP_PATTERNS:
        try:
            roots += [os.path.join(tmp, d) for d in os.listdir(tmp)
                      if d.startswith(name)]
        except OSError:
            pass
    for d in roots:
        if not os.path.isdir(d):
            continue
        pid = _read_pid(os.path.join(d, "daemon.pid"))
        if pid > 0 and _pid_alive(pid):
            continue
        if pid <= 0:
            try:
                if now - os.path.getmtime(d) < _NO_OWNER_GRACE_S:
                    continue
            except OSError:
                pass
        shutil.rmtree(d, ignore_errors=True)
        removed.append(d)
    for name in _SCRATCH_PATTERNS if include_scratch else ():
        try:
            scratch = [os.path.join(tmp, x) for x in os.listdir(tmp)
                       if x.startswith(name)]
        except OSError:
            scratch = []
        for d in scratch:
            try:
                if now - os.path.getmtime(d) < _SCRATCH_MAX_AGE_S:
                    continue
            except OSError:
                continue
            shutil.rmtree(d, ignore_errors=True)
            removed.append(d)
    # CLI head sessions (/tmp/rtpt-head-<port>) persist the conductor
    # journal ON PURPOSE — a head restarted on the same port recovers from
    # it (gcs_init_data.h role). Reclaim only the ephemeral state of dead
    # sessions: spill files and stale sockets, never conductor/.
    try:
        heads = [d for d in os.listdir(tmp) if d.startswith("rtpt-head-")]
    except OSError:
        heads = []
    for name in heads:
        d = os.path.join(tmp, name)
        if not os.path.isdir(d):
            continue
        pid = _read_pid(os.path.join(d, "daemon.pid"))
        if pid > 0 and _pid_alive(pid):
            continue
        spill = os.path.join(d, "spill")
        if os.path.isdir(spill):
            shutil.rmtree(spill, ignore_errors=True)
            removed.append(spill)
        for f in os.listdir(d):
            if f.endswith(".sock"):
                try:
                    os.unlink(os.path.join(d, f))
                    removed.append(os.path.join(d, f))
                except OSError:
                    pass
    return removed


def sweep_stale(include_scratch: bool = False) -> List[str]:
    """Full sweep; returns what was reclaimed. Cheap when nothing is stale
    (a listdir + a few kill(pid, 0) probes) — safe to run at every session
    start, `stop`, and bench pre-flight. `include_scratch` (explicit
    teardown only) additionally ages out old checkpoint scratch."""
    return sweep_shm() + sweep_tmp(include_scratch=include_scratch)
