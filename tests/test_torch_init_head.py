"""``ray_tpu_torch.init()`` without an address starts a head, held to the JAX
package's ``ray_tpu.init()``.

- ``init()`` starts a conductor and the head node's daemon in this process
  (``ClusterRuntime(address=None)``): tasks run in worker processes, and
  ``cluster_resources()`` and ``nodes()`` carry the JAX head's keys and
  values (JAX's ``init(num_cpus=2)`` on the same host, run first in this
  process and shut down before the port's).
- The implicit ``init()`` of an API call does the same from the main
  thread, and raises from any other.
- ``in_process_runtime()`` is False with no runtime and for a head, and
  asking it starts none; ``init(local_mode=True)`` keeps the in-process
  runtime.
- ``shutdown()`` leaves no process of the head (store, zygote, workers)
  and no store segment; a driver process that exits without
  ``shutdown()`` leaves none either, within ``ORPHAN_LIMIT_S``.
- A driver that connects to the head, runs tasks and shuts down at once
  leaves none of its worker leases held (ROADMAP.md C, Closed).

Processes and segments are those of this test's head only (its store
prefix, the pids of its daemon's children): other tests' clusters may run
on the host at the same time.
"""

import os
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core.runtime_cluster import ClusterRuntime
from ray_tpu_torch.core.runtime_local import LocalRuntime

REPO = Path(__file__).resolve().parents[1]
# A head's workers and zygote watch their daemon; once it is gone they exit
# within a few of its health periods (about 15 s on an idle host, measured).
ORPHAN_LIMIT_S = 60.0


def worker_pid():
    return os.getpid()


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"
    except OSError:
        return False


def _segments(prefix):
    return [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


def _head_processes(rt):
    """The pids of the head's store, zygote and workers."""
    daemon = rt._owned_daemon
    pids = [daemon.store_proc.pid]
    zygote = daemon._zygote_proc
    if zygote not in (None, False):
        pids.append(zygote.pid)
    pids += [w.proc.pid for w in daemon._workers.values()]
    return pids


def _until(cond, limit_s):
    deadline = time.monotonic() + limit_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.2)
    return cond()


def _view(pkg):
    """``cluster_resources()`` and ``nodes()`` without the ids and
    addresses that differ between any two heads."""
    nodes = [{k: v for k, v in n.items() if k not in ("NodeID", "address")}
             for n in pkg.nodes()]
    return pkg.cluster_resources(), nodes, sorted(pkg.nodes()[0])


def test_init_without_an_address_starts_a_head():
    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=2)
    try:
        assert isinstance(rt, ClusterRuntime)
        assert rt._owned_conductor is not None and rt._owned_daemon is not None
        assert not core_api.in_process_runtime()
        pid = ray_tpu_torch.get(ray_tpu_torch.remote(worker_pid).remote(),
                                timeout=60)
        assert pid != os.getpid()
        prefix = rt._owned_daemon.store_prefix
        pids = _head_processes(rt)
        assert pid in pids and _segments(prefix)
    finally:
        ray_tpu_torch.shutdown()
    assert _until(lambda: not any(_alive(p) for p in pids), 30.0), \
        [p for p in pids if _alive(p)]
    assert _segments(prefix) == []


def test_head_resources_and_nodes_are_the_jax_heads():
    import ray_tpu
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=2)
    try:
        want = _view(ray_tpu)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        got = _view(ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
    assert got == want
    assert got[0] == {"CPU": 2.0}


def test_implicit_init_starts_a_head_from_the_main_thread_only():
    ray_tpu_torch.shutdown()
    errors = []

    def touch():
        try:
            ray_tpu_torch.put(1)
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=touch)
    t.start()
    t.join(timeout=10)
    assert errors and "main-thread-only" in errors[0]
    assert not ray_tpu_torch.is_initialized()
    try:
        ref = ray_tpu_torch.put(41)     # the implicit init()
        assert isinstance(core_api._runtime, ClusterRuntime)
        assert core_api._runtime._owned_conductor is not None
        assert ray_tpu_torch.get(ref) == 41
    finally:
        ray_tpu_torch.shutdown()


def test_in_process_runtime_only_under_local_mode():
    ray_tpu_torch.shutdown()
    assert core_api.in_process_runtime() is False
    assert not ray_tpu_torch.is_initialized()   # asking started none
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        assert isinstance(core_api._runtime, LocalRuntime)
        assert core_api.in_process_runtime() is True
    finally:
        ray_tpu_torch.shutdown()


_NO_SHUTDOWN = """
import os, sys
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt


def square(x):
    return x * x


if __name__ == "__main__":
    r = rt.init(num_cpus=2)
    assert sum(rt.get([rt.remote(square).remote(i) for i in range(4)],
                      timeout=60)) == 14
    d = r._owned_daemon
    pids = [d.store_proc.pid] + [w.proc.pid for w in d._workers.values()]
    if d._zygote_proc not in (None, False):
        pids.append(d._zygote_proc.pid)
    print("HEAD", d.store_prefix, *pids, flush=True)
    os._exit(0) if len(sys.argv) > 1 else None    # no shutdown(), no atexit
"""


@pytest.mark.parametrize("how", ["returns", "os_exit"])
def test_driver_that_exits_without_shutdown_leaves_nothing(tmp_path, how):
    script = tmp_path / "driver.py"
    script.write_text(textwrap.dedent(_NO_SHUTDOWN.format(repo=str(REPO))))
    argv = [sys.executable, str(script)] + (["x"] if how == "os_exit" else [])
    out = subprocess.run(argv, capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("HEAD"))
    prefix, *pids = line.split()[1:]
    pids = [int(p) for p in pids]
    assert len(pids) >= 2
    assert _until(lambda: not any(_alive(p) for p in pids)
                  and not _segments(prefix), ORPHAN_LIMIT_S), \
        ([p for p in pids if _alive(p)], _segments(prefix))


_BRIEF_DRIVER = """
import sys
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt


def square(x):
    return x * x


if __name__ == "__main__":
    rt.init(address=sys.argv[1])
    print("SUM", sum(rt.get([rt.remote(square).remote(i) for i in range(8)],
                            timeout=60)), flush=True)
    rt.shutdown()
"""


def test_a_brief_driver_returns_its_leases_at_shutdown(tmp_path):
    """Its last lease grants can arrive after its tasks are done; shutdown
    returns them, so the head's CPUs are all free again."""
    ray_tpu_torch.shutdown()
    rt = ray_tpu_torch.init(num_cpus=2)
    try:
        script = tmp_path / "brief.py"
        script.write_text(_BRIEF_DRIVER.format(repo=str(REPO)))
        for _ in range(2):
            out = subprocess.run([sys.executable, str(script), rt.address],
                                 capture_output=True, text=True,
                                 timeout=120, cwd=str(tmp_path))
            assert out.stdout.split() == ["SUM", "140"], out.stderr[-3000:]
        assert _until(lambda: ray_tpu_torch.available_resources().get("CPU")
                      == 2.0, 10.0), ray_tpu_torch.available_resources()
    finally:
        ray_tpu_torch.shutdown()
