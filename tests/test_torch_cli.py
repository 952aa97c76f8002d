"""``python -m ray_tpu_torch``: the port's CLI (``ray_tpu_torch/scripts.py``,
ported from ``ray_tpu/scripts.py``, which has no test of its own).

- A head from ``start --head --port 0`` with its own ``TMPDIR``; then
  ``status``, ``list actors``, ``job submit --follow``, ``client-server``
  with a ``client://`` driver, and ``stop``, which leaves no process of
  that head, no store segment and no address file. A sweep while the head
  lives takes none of its files.
- ``microbenchmark`` refuses ``--address`` (exits non-zero) and, without
  one, reaches ``cluster/microbench.py``'s ``main`` (monkeypatched here,
  so no suite runs).
- ``stop``'s patterns match the port's processes of its own temporary
  directory only: no JAX process, and no port process of another
  directory; the JAX ``stop``'s patterns match no port process.
"""

import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

from ray_tpu_torch import scripts

REPO = Path(__file__).resolve().parents[1]

_JOB = """
import os
import ray_tpu_torch as rt


def square(x):
    return x * x


if __name__ == "__main__":
    rt.init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])
    print("JOBSUM", sum(rt.get([rt.remote(square).remote(i)
                                for i in range(5)], timeout=60)), flush=True)
    rt.shutdown()
"""

_CLIENT = """
import sys
import ray_tpu_torch as rt


def plus(a, b):
    return a + b


if __name__ == "__main__":
    rt.init(address=sys.argv[1])
    print("CLIENT", rt.get(rt.remote(plus).remote(2, 3), timeout=60),
          rt.cluster_resources()["CPU"], flush=True)
    rt.shutdown()
"""


def _env(tmpdir):
    env = dict(os.environ)
    env["TMPDIR"] = str(tmpdir)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _cli(env, *argv, timeout=120):
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *argv],
                         env=env, capture_output=True, text=True,
                         timeout=timeout, cwd=env["TMPDIR"])
    assert out.returncode == 0, f"{argv}:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def _start(env, *argv):
    """A long-running CLI process and the first line of its output that
    holds ``want`` (``argv[-1]``)."""
    *argv, want = argv
    proc = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", *argv],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=env["TMPDIR"])
    lines = []
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if want in line:
            return proc, line
    proc.kill()
    raise AssertionError(f"{argv} printed no {want!r}:\n{''.join(lines)}")


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"
    except OSError:
        return False


def _matching(patterns):
    """Pids of live processes whose command line matches a pattern, as
    ``pkill -f`` matches it."""
    return sorted({int(p) for pat in patterns for p in subprocess.run(
        ["pgrep", "-f", pat], capture_output=True, text=True).stdout.split()
        if _alive(int(p))})


@pytest.fixture()
def cli_tmp():
    """A ``TMPDIR`` of the CLI's own, short: a session's socket paths
    under it must fit ``AF_UNIX``'s 108 bytes, which pytest's nested
    temporary paths can exceed."""
    path = tempfile.mkdtemp(prefix="rtcli")
    yield Path(path)
    shutil.rmtree(path, ignore_errors=True)


def test_head_status_list_job_client_and_stop(tmp_path, cli_tmp):
    tmp = cli_tmp
    env = _env(tmp)
    (tmp_path / "job.py").write_text(_JOB)
    (tmp_path / "client.py").write_text(_CLIENT)
    head, line = _start(env, "start", "--head", "--port", "0",
                        "--num-cpus", "2", "--dashboard-port", "0",
                        "Address:")
    proxy = None
    try:
        address = line.split("Address:")[1].strip()
        assert (tmp / scripts.ADDRESS_FILE).read_text() == address
        store_pid = int((tmp / scripts.PID_FILE).read_text().split()[1])
        status = _cli(env, "status")
        assert "Nodes: 1 alive / 1 total" in status and "CPU:" in status
        node = re.search(r"HEAD ALIVE ([0-9a-f]{12})", status).group(1)
        prefix = f"rtpt-{node[:8]}-"
        assert _cli(env, "list", "actors").strip() == "[]"
        job = _cli(env, "job", "submit", "--follow", "--", sys.executable,
                   str(tmp_path / "job.py"))
        assert "JOBSUM 30" in job and "SUCCEEDED" in job, job
        assert "SUCCEEDED" in _cli(env, "job", "list")
        proxy, line = _start(env, "client-server", "--port", "0",
                             "listening on")
        client = subprocess.run(
            [sys.executable, str(tmp_path / "client.py"),
             line.split("listening on")[1].strip()], env=env,
            capture_output=True, text=True, timeout=120)
        assert client.stdout.split() == ["CLIENT", "5", "2.0"], \
            client.stderr[-3000:]
        # a sweep while the head lives takes none of its files
        sweep = subprocess.run(
            [sys.executable, "-c", "from ray_tpu_torch.cluster import "
             "hygiene; print(hygiene.sweep_stale(include_scratch=True))"],
            env=env, capture_output=True, text=True, timeout=120)
        assert sweep.returncode == 0, sweep.stderr
        assert (tmp / scripts.ADDRESS_FILE).exists()
        assert (tmp / scripts.PID_FILE).exists()
        proxy.send_signal(signal.SIGTERM)
        assert proxy.wait(timeout=30) == 0
        ours = _matching(scripts.stop_patterns(str(tmp)))
        assert store_pid in ours
        out = _cli(env, "stop")
        assert out.startswith("stopped 2 processes"), out
        assert head.wait(timeout=30) == 0
    finally:
        for p in (proxy, head):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    assert not (tmp / scripts.ADDRESS_FILE).exists()
    assert not (tmp / scripts.PID_FILE).exists()
    assert [p for p in ours if _alive(p)] == []
    assert _matching(scripts.stop_patterns(str(tmp))) == []
    assert [f for f in os.listdir("/dev/shm") if f.startswith(prefix)] == []


def test_microbenchmark_subcommand_refuses_an_address(monkeypatch):
    """The suite owns its cluster: ``--address`` exits non-zero before
    anything runs (the JAX CLI prints a note and drops it)."""
    from ray_tpu_torch.cluster import microbench
    monkeypatch.setattr(microbench, "main", lambda argv=None: pytest.fail(
        "the suite ran although an address was given"))
    with pytest.raises(SystemExit) as e:
        scripts.main(["microbenchmark", "--address", "127.0.0.1:6380"])
    assert e.value.code and "drop --address" in str(e.value.code)


def test_microbenchmark_subcommand_runs_the_suite(monkeypatch):
    """Without an address the subcommand calls the suite's ``main`` with
    no arguments, as ``ray_tpu/scripts.py:214-220`` does, and a failing
    suite's code becomes the CLI's exit code."""
    from ray_tpu_torch.cluster import microbench
    calls = []
    monkeypatch.setattr(microbench, "main",
                        lambda argv=None: calls.append(argv) or 0)
    scripts.main(["microbenchmark"])
    assert calls == [[]]
    monkeypatch.setattr(microbench, "main", lambda argv=None: 3)
    with pytest.raises(SystemExit) as e:
        scripts.main(["microbenchmark"])
    assert e.value.code == 3


def _jax_stop_patterns():
    """The patterns of the JAX ``stop``, read from its source."""
    src = (REPO / "ray_tpu" / "scripts.py").read_text()
    body = src[src.index("def cmd_stop"):src.index("def _connect")]
    found = re.findall(r'"((?:ray_tpu\[\.\]|_native/)[^"]*)"', body)
    assert len(found) == 3, found
    return found


def _command_lines(tmp, other):
    """Command lines of each package's processes, in the forms the daemons
    start them with (``cluster/node_daemon.py``, ``object_client.py``)."""
    sess = f"{tmp}/rtpt-session-ab12cd34"
    port = [
        f"{sys.executable} -m ray_tpu_torch.cluster.worker_main --conductor "
        f"127.0.0.1:41000 --daemon 127.0.0.1:41001 --store-socket "
        f"{sess}/store-0a1b2c3d.sock --store-prefix rtpt-0a1b2c3d- --node-id "
        f"0a1b2c3d --token 99",
        f"{sys.executable} -m ray_tpu_torch.cluster.worker_zygote --socket "
        f"{sess}/zygote-0a1b2c3d.sock",
        f"{REPO}/build/ray_tpu_torch/shmstored-c4cf83e1604e9a09 "
        f"{sess}/store-0a1b2c3d.sock 1073741824 rtpt-0a1b2c3d- {sess}/spill"]
    jax_sess = f"{other}/rtpu-session-ab12cd34"
    jax = [
        f"{sys.executable} -m ray_tpu.cluster.worker_main --conductor "
        f"127.0.0.1:41000 --store-socket {jax_sess}/store-0a1b2c3d.sock",
        f"{sys.executable} -m ray_tpu.cluster.worker_zygote --socket "
        f"{jax_sess}/zygote-0a1b2c3d.sock",
        f"{REPO}/ray_tpu/_native/shmstored {jax_sess}/store-0a1b2c3d.sock "
        f"1073741824 rtpu-0a1b2c3d-"]
    return port, jax


def _grep(pattern, lines):
    """The lines an extended regular expression matches (pkill's dialect)."""
    out = subprocess.run(["grep", "-E", pattern], input="\n".join(lines)
                         + "\n", capture_output=True, text=True)
    return out.stdout.splitlines()


@pytest.mark.parametrize("tmp", ["/tmp", "/tmp/pytest-of-x/pytest-3/t.a+b0"])
def test_stop_patterns_match_neither_packages_other_processes(tmp):
    port, jax = _command_lines(tmp, tmp)
    other_port = _command_lines("/var/other", tmp)[0] + \
        _command_lines(f"/var{tmp}", tmp)[0]
    ours = scripts.stop_patterns(tmp)
    assert len(ours) == 3
    for pattern, line in zip(ours, port):
        assert _grep(pattern, port) == [line], pattern
        assert _grep(pattern, jax) == [], pattern
        assert _grep(pattern, other_port) == [], pattern
    for pattern, line in zip(_jax_stop_patterns(), jax):
        assert _grep(pattern, jax) == [line], pattern
        assert _grep(pattern, port) == [], pattern
