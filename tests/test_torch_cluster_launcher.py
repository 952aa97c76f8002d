"""The port's cluster launcher (``ray_tpu_torch/cluster_launcher.py``) and
its five CLI commands, the counterparts of ``tests/test_cluster_launcher.py``.

- ``up`` a spec with two ``min_workers`` nodes, run a job, ``exec``, then
  ``down``; ``down`` without ``up``; ``up`` over a stale state file
  (JAX: ``:37``, ``:85``, ``:90``). Every head takes port 0 (JAX's tests
  take 6397-6399).
- The same JSON spec through both packages' ``load_config`` gives equal
  dicts; a ``gcp_tpu`` provider raises naming ROADMAP.md A.5(d).
- ``up``, ``exec``, ``attach``, ``submit`` and ``down`` through ``python -m
  ray_tpu_torch``, with a head that has no card and a fake GPU node type
  that the autoscaler launches for a job's ``num_gpus=1`` task (the
  commands that ``scripts.DEFERRED`` listed until this module came).

Each test runs its launcher with a ``TMPDIR`` of its own, short: the
sessions' socket paths must fit ``AF_UNIX``'s 108 bytes.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

from ray_tpu_torch import cluster_launcher
from ray_tpu_torch.cluster.protocol import get_client

REPO = Path(__file__).resolve().parents[1]

_JOB = """
import os
import ray_tpu_torch as rt


def where():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


if __name__ == "__main__":
    rt.init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])
    gpus = rt.cluster_resources().get("GPU", 0.0)
    seen = rt.get(rt.remote(num_gpus=1)(where).remote(), timeout=120)
    print("JOBCARD", gpus, repr(seen), flush=True)
    rt.shutdown()
"""


@pytest.fixture()
def launcher_tmp(monkeypatch):
    """This test's ``TMPDIR``, for the launcher here and for the processes
    it starts."""
    path = tempfile.mkdtemp(prefix="rtl")
    monkeypatch.setenv("TMPDIR", path)
    monkeypatch.setattr(tempfile, "tempdir", path)
    yield Path(path)
    shutil.rmtree(path, ignore_errors=True)


def _spec(tmp, name, min_workers=2, **extra):
    cfg = {
        "cluster_name": name,
        "provider": {"type": "fake"},
        "head": {"port": 0, "resources": {"CPU": 1}},
        "node_types": {
            "worker": {"resources": {"CPU": 1},
                       "min_workers": min_workers, "max_workers": 4},
        },
        "max_workers": 6,
        "idle_timeout_minutes": 30,
        **extra,
    }
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _gone(pid, limit_s=15.0):
    deadline = time.time() + limit_s
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.2)
    return False


def test_up_job_exec_down(launcher_tmp):
    tmp = launcher_tmp
    cfg_path = _spec(tmp, "up")
    address = cluster_launcher.up(cfg_path, wait_s=90)
    state = cluster_launcher._read_state("up")
    try:
        # 1 head + 2 min workers registered and alive.
        nodes = [n for n in get_client(address).call("get_nodes")
                 if n["alive"]]
        assert len(nodes) >= 3
        assert Path(state["session_dir"]).parent == tmp
        # Idempotent up: second call reuses the live cluster.
        assert cluster_launcher.up(cfg_path) == address

        from ray_tpu_torch.job_submission import JobSubmissionClient
        client = JobSubmissionClient(address)
        sid = cluster_launcher.submit(
            cfg_path, f"{sys.executable} -c \"print('hello-from-job')\"",
            follow=False)
        deadline = time.time() + 60
        while time.time() < deadline:
            if client.get_job_status(sid) in ("SUCCEEDED", "FAILED"):
                break
            time.sleep(0.5)
        assert client.get_job_status(sid) == "SUCCEEDED"
        assert "hello-from-job" in client.get_job_logs(sid)

        # exec runs with RAY_TPU_TORCH_ADDRESS wired to the head.
        marker = tmp / "exec-out"
        rc = cluster_launcher.exec_cmd(
            cfg_path, f"echo -n $RAY_TPU_TORCH_ADDRESS > {marker}")
        assert rc == 0
        assert marker.read_text() == address
    finally:
        cluster_launcher.down(cfg_path)
    # State file gone, head process gone, session directory gone.
    assert cluster_launcher._read_state("up") is None
    assert _gone(state["pid"]), "head session survived `down`"
    assert not os.path.exists(state["session_dir"])


def test_down_without_up_is_clean(launcher_tmp):
    cfg_path = _spec(launcher_tmp, "never")
    cluster_launcher.down(cfg_path)  # no state: must not raise
    assert cluster_launcher._read_state("never") is None


def test_up_replaces_stale_state(launcher_tmp):
    """A stale launcher state file (dead pid) must not block `up`."""
    cfg_path = _spec(launcher_tmp, "stale", min_workers=0)
    dead = 4_200_000
    while True:
        try:
            os.kill(dead, 0)
            dead += 1
        except ProcessLookupError:
            break
    with open(cluster_launcher._state_path("stale"), "w") as f:
        json.dump({"pid": dead, "address": "127.0.0.1:1",
                   "cluster_name": "stale", "config_path": cfg_path}, f)
    address = cluster_launcher.up(cfg_path, wait_s=90)
    try:
        assert address != "127.0.0.1:1"
        assert get_client(address).call("get_nodes")
    finally:
        cluster_launcher.down(cfg_path)


def test_json_spec_loads_equal_through_both_packages(tmp_path):
    from ray_tpu import cluster_launcher as jax_launcher
    path = _spec(tmp_path, "both", dashboard=None)
    port = cluster_launcher.load_config(path)
    assert port == jax_launcher.load_config(path)
    assert port["provider"] == {"type": "fake"}
    # the JAX defaults for a spec that names only the cluster
    bare = tmp_path / "bare.json"
    bare.write_text('{"cluster_name": "bare"}')
    assert cluster_launcher.load_config(str(bare)) == \
        jax_launcher.load_config(str(bare))


def test_yaml_spec_loads_with_pyyaml(tmp_path):
    pytest.importorskip("yaml")
    path = tmp_path / "c.yaml"
    path.write_text("cluster_name: y\nhead:\n  resources: {CPU: 2}\n")
    cfg = cluster_launcher.load_config(str(path))
    assert cfg["head"] == {"resources": {"CPU": 2}}
    assert cfg["provider"] == {"type": "fake"} and cfg["node_types"] == {}


def test_gcp_tpu_provider_raises_naming_the_roadmap(tmp_path):
    path = tmp_path / "gcp.json"
    path.write_text(json.dumps({"cluster_name": "g",
                                "provider": {"type": "gcp_tpu"}}))
    with pytest.raises(NotImplementedError, match=r"A\.5\(d\)"):
        cluster_launcher.load_config(str(path))


def _cli(env, *argv, stdin=None, timeout=180):
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *argv],
                         env=env, input=stdin, capture_output=True,
                         text=True, timeout=timeout, cwd=env["TMPDIR"])
    assert out.returncode == 0, f"{argv}:\n{out.stdout}\n{out.stderr}"
    return out.stdout


def test_up_exec_attach_submit_down_through_the_cli(launcher_tmp):
    """The five launcher commands through ``python -m ray_tpu_torch``: a
    head with no card, a job whose ``num_gpus=1`` task makes the autoscaler
    launch the fake GPU node type (card index 0 in the task's worker), and a
    ``down`` that leaves no head session and no state file."""
    tmp = launcher_tmp
    env = dict(os.environ, TMPDIR=str(tmp), SHELL="/bin/sh",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    spec = _spec(tmp, "cli", min_workers=0,
                 node_types={"gpu_worker": {
                     "resources": {"CPU": 1, "GPU": 1},
                     "min_workers": 0, "max_workers": 1}})
    (tmp / "job.py").write_text(_JOB)
    out = _cli(env, "up", spec)
    address = out.split(" up at ")[1].split()[0]
    state = cluster_launcher._read_state("cli")
    try:
        assert state["address"] == address
        out = _cli(env, "exec", spec, "echo", "ADDR=$RAY_TPU_TORCH_ADDRESS")
        assert f"ADDR={address}" in out
        out = _cli(env, "attach", spec,
                   stdin="echo SHELL_ADDR=$RAY_TPU_TORCH_ADDRESS\nexit 0\n")
        assert f"SHELL_ADDR={address}" in out
        out = _cli(env, "submit", spec, "--", sys.executable,
                   str(tmp / "job.py"))
        assert "JOBCARD 0.0 '0'" in out and "SUCCEEDED" in out, out
        nodes = get_client(address).call("get_nodes")
        gpu_nodes = [n for n in nodes if n["resources_total"].get("GPU")]
        assert len(gpu_nodes) == 1          # the autoscaler's one launch
    finally:
        out = _cli(env, "down", spec)
    assert "cluster 'cli' down" in out
    assert cluster_launcher._read_state("cli") is None
    assert _gone(state["pid"])
    assert not os.path.exists(state["session_dir"])
