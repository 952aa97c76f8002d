"""Cluster launcher: bring a whole cluster up/down from a spec file.
Ported from ``ray_tpu/cluster_launcher.py``.

Role parity: `ray up/down/attach/exec/submit` (reference
python/ray/scripts/scripts.py:1223 up, :1522 submit; schema
python/ray/autoscaler/ray-schema.json). The monitor (autoscaler +
provider) runs inside the head session process (`python -m
ray_tpu_torch.cluster_launcher --head-session ...`), the same placement as
the reference's monitor.py on the head node.

Spec schema (subset):

    cluster_name: demo
    provider:
      type: fake
    head:
      port: 6380                # 0: any free port
      resources: {"CPU": 4}     # exactly the head's; no "GPU", no card
      dashboard_port: 8265      # optional, -1 disables
    node_types:
      gpu_worker:
        resources: {"CPU": 8, "GPU": 1}
        min_workers: 0
        max_workers: 4
    max_workers: 8
    idle_timeout_minutes: 5

Where the port differs from the JAX launcher:

- A spec whose text is JSON (which YAML reads too) is parsed with ``json``;
  any other spec needs PyYAML, imported in ``load_config`` only, and a
  missing PyYAML raises ``ImportError`` naming it.
- ``provider.type: gcp_tpu`` (TPU VMs through ``gcloud``) raises
  ``NotImplementedError``: a GPU-VM provider is still to design
  (ROADMAP.md A.5(d)). ``fake`` starts each node as a node daemon in the
  head session process.
- The state file is ``rtpt-launcher-<cluster_name>.json`` under
  ``tempfile.gettempdir()``, where the JAX launcher keeps
  ``/tmp/ray_tpu/launcher-<name>.json``, and each head session gets a fresh
  ``rtpt-session-*`` directory there (the JAX launcher reuses
  ``/tmp/ray_tpu/session-<port>`` and deletes its journal), which ``down``
  removes.
- ``exec`` and ``attach`` export ``RAY_TPU_TORCH_ADDRESS``, where the JAX
  launcher exports ``RAY_TPU_ADDRESS``.
- The head daemon gets exactly the spec's ``head.resources`` (without them,
  the host's CPU count and no card): a head that named no ``"GPU"`` leaves
  the cards to the node types, so a step that asks for one makes the
  autoscaler launch a GPU node.
"""

from __future__ import annotations

import json
import os
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

STATE_PREFIX = "rtpt-launcher-"
ADDRESS_VAR = "RAY_TPU_TORCH_ADDRESS"
# In-process `up` keeps its Popen handle here so `down` can reap the
# exited session (otherwise it lingers as a zombie of the calling
# process; CLI usage reparents to init and needs no reaping).
_SESSIONS: Dict[str, subprocess.Popen] = {}


def _state_path(cluster_name: str) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"{STATE_PREFIX}{cluster_name}.json")


def _parse_spec(text: str, path: str):
    try:
        return json.loads(text)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"{path}: a spec that is not JSON needs PyYAML, which is not "
            "installed; write the spec as JSON (YAML reads it too)") from e
    return yaml.safe_load(text)


def _check_provider(cfg: dict, path: str) -> None:
    ptype = cfg["provider"].get("type", "fake")
    if ptype == "gcp_tpu":
        raise NotImplementedError(
            f"{path}: provider type 'gcp_tpu' (TPU VMs) has no counterpart "
            "in the port yet; a GPU-VM provider is queued in ROADMAP.md "
            "A.5(d). Use provider type 'fake'")
    if ptype != "fake":
        raise ValueError(f"unknown provider type {ptype!r}")


def load_config(path: str) -> dict:
    with open(path) as f:
        cfg = _parse_spec(f.read(), path)
    if not isinstance(cfg, dict) or "cluster_name" not in cfg:
        raise ValueError(f"{path}: not a cluster config (cluster_name "
                         "missing)")
    cfg.setdefault("provider", {"type": "fake"})
    cfg.setdefault("head", {})
    cfg.setdefault("node_types", {})
    _check_provider(cfg, path)
    return cfg


def _read_state(cluster_name: str) -> Optional[dict]:
    try:
        with open(_state_path(cluster_name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _build_provider(cfg: dict, conductor_address: str):
    from ray_tpu_torch.autoscaler.autoscaler import FakeNodeProvider
    return FakeNodeProvider(conductor_address, cfg.get("node_types", {}))


# ---------------------------------------------------------------------------
# head session: conductor + head daemon + provider + autoscaler, one process


def run_head_session(config_path: str) -> None:
    """The long-lived head process `up` spawns (parity: head node =
    gcs + raylet + monitor). Exits cleanly on SIGTERM, terminating
    provider nodes on the way out."""
    from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
    from ray_tpu_torch.cluster.conductor import Conductor
    from ray_tpu_torch.cluster.node_daemon import NodeDaemon

    cfg = load_config(config_path)
    head = cfg.get("head", {})
    port = int(head.get("port", 6380))
    # A fresh session directory: every `up` is a NEW cluster, and a journal
    # of an earlier cluster would resurrect its dead nodes as briefly
    # "alive", handing `submit` a dead head address.
    session_dir = tempfile.mkdtemp(prefix="rtpt-session-")
    conductor = Conductor(host=head.get("host", "127.0.0.1"), port=port,
                          persist_dir=session_dir)
    daemon = NodeDaemon(conductor.address,
                        resources=head.get("resources"),
                        is_head=True, session_dir=session_dir,
                        object_store_bytes=int(
                            head.get("object_store_memory_mb", 512)) << 20)
    dash_port = int(head.get("dashboard_port", -1))
    dash = None
    if dash_port >= 0:
        from ray_tpu_torch.dashboard import Dashboard
        try:
            dash = Dashboard(conductor.address, port=dash_port)
        except OSError:
            pass
    provider = _build_provider(cfg, conductor.address)
    node_types = cfg.get("node_types", {})
    # Floor the cluster at min_workers per type before demand exists.
    for tname, tcfg in node_types.items():
        for _ in range(int(tcfg.get("min_workers", 0))):
            provider.create_node(tname)
    scaler = StandardAutoscaler(
        conductor.address, provider, node_types,
        idle_timeout_s=float(cfg.get("idle_timeout_minutes", 5)) * 60,
        max_workers=int(cfg.get("max_workers", 20)),
        min_per_type={t: int(c.get("min_workers", 0))
                      for t, c in node_types.items()})
    scaler.start()

    state = {"pid": os.getpid(), "address": conductor.address,
             "config_path": os.path.abspath(config_path),
             "cluster_name": cfg["cluster_name"],
             "session_dir": session_dir,
             "dashboard": dash.url if dash is not None else None}
    tmp = _state_path(cfg["cluster_name"]) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, _state_path(cfg["cluster_name"]))
    print(f"HEAD_READY {conductor.address}", flush=True)
    # The `up` CLI closes our pipe after HEAD_READY; route further output
    # to the session log so nothing ever hits a broken pipe.
    log_fd = os.open(os.path.join(session_dir, "launcher.log"),
                     os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
    os.dup2(log_fd, 1)
    os.dup2(log_fd, 2)
    os.close(log_fd)

    stop = {"flag": False}

    def on_term(sig, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    while not stop["flag"]:
        time.sleep(0.2)
    # Orderly teardown: provider nodes first (cloud cost), then local.
    t0 = time.monotonic()

    def _mark(msg):
        print(f"[teardown +{time.monotonic() - t0:.1f}s] {msg}",
              flush=True)

    scaler.stop()
    _mark("scaler stopped")
    for pid_, _t in provider.non_terminated_nodes():
        try:
            provider.terminate_node(pid_)
        except Exception:
            pass
        _mark(f"provider node {pid_} terminated")
    if dash is not None:
        dash.stop()
    daemon.stop()
    _mark("head daemon stopped")
    conductor.stop()
    _mark("conductor stopped")
    try:
        os.unlink(_state_path(cfg["cluster_name"]))
    except OSError:
        pass


# ---------------------------------------------------------------------------
# CLI verbs


def up(config_path: str, wait_s: float = 120.0) -> str:
    """Bring the cluster up; returns the head address. Idempotent: a
    live cluster with this name is left as-is."""
    cfg = load_config(config_path)
    st = _read_state(cfg["cluster_name"])
    if st is not None:
        try:
            os.kill(st["pid"], 0)
            print(f"cluster {cfg['cluster_name']!r} already up at "
                  f"{st['address']}")
            return st["address"]
        except ProcessLookupError:
            pass  # stale state; relaunch
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           "PYTHONPATH": pkg_parent + os.pathsep +
           os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.cluster_launcher",
         "--head-session", os.path.abspath(config_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, start_new_session=True)   # survives this CLI exiting
    deadline = time.monotonic() + wait_s
    address = None
    lines = []
    # Deadline-aware poll: a head session that wedges BEFORE printing
    # HEAD_READY (an import deadlock) keeps the pipe open and a bare
    # readline() would block this CLI forever.
    while time.monotonic() < deadline:
        remaining = deadline - time.monotonic()
        ready, _, _ = select.select([proc.stdout], [], [],
                                    max(0.0, min(remaining, 0.5)))
        if not ready:
            if proc.poll() is not None:
                break  # session died without HEAD_READY
            continue
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("HEAD_READY"):
            address = line.split()[1]
            break
        lines.append(line)
    if address is None:
        proc.terminate()
        proc.wait()
        raise RuntimeError(
            f"head session failed to come up within {wait_s}s:\n"
            + "".join(lines)[-3000:])
    proc.stdout.close()   # detach; the session runs on
    _SESSIONS[cfg["cluster_name"]] = proc
    print(f"cluster {cfg['cluster_name']!r} up at {address}", flush=True)
    min_total = sum(int(t.get("min_workers", 0))
                    for t in cfg.get("node_types", {}).values())
    if min_total:
        _wait_for_nodes(address, 1 + min_total, wait_s)
    return address


def _wait_for_nodes(address: str, n: int, wait_s: float) -> None:
    from ray_tpu_torch.cluster.protocol import get_client
    cli = get_client(address)
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            nodes = [x for x in cli.call("get_nodes")
                     if x.get("alive", True)]
            if len(nodes) >= n:
                return
        except Exception:
            pass
        time.sleep(0.5)
    print(f"warning: cluster has not reached {n} nodes within {wait_s}s",
          file=sys.stderr)


def down(config_path: str, wait_s: float = 60.0) -> None:
    """Tear the cluster down: SIGTERM the head session, which terminates
    the provider's nodes, then remove its session directory."""
    cfg = load_config(config_path)
    st = _read_state(cfg["cluster_name"])
    proc = _SESSIONS.pop(cfg["cluster_name"], None)
    if st is not None:
        try:
            os.kill(st["pid"], signal.SIGTERM)
        except ProcessLookupError:
            pass
    if proc is not None:
        # In-process `up`: wait on the handle (also reaps — a bare
        # kill(pid, 0) loop would see the zombie as alive forever).
        try:
            proc.wait(timeout=wait_s)
        except Exception:
            proc.kill()
            proc.wait()
    elif st is not None:
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            try:
                os.kill(st["pid"], 0)
            except ProcessLookupError:
                break
            time.sleep(0.2)
    if st is not None and st.get("session_dir"):
        shutil.rmtree(st["session_dir"], ignore_errors=True)
    try:
        os.unlink(_state_path(cfg["cluster_name"]))
    except OSError:
        pass
    from ray_tpu_torch.cluster import hygiene
    hygiene.sweep_stale()
    print(f"cluster {cfg['cluster_name']!r} down", flush=True)


def get_head_address(config_path: str) -> str:
    cfg = load_config(config_path)
    st = _read_state(cfg["cluster_name"])
    if st is None:
        raise SystemExit(f"cluster {cfg['cluster_name']!r} is not up "
                         "(no launcher state)")
    return st["address"]


def exec_cmd(config_path: str, command: str) -> int:
    """Run a shell command against the cluster (RAY_TPU_TORCH_ADDRESS
    set), parity: `ray exec`. Local head: direct subprocess."""
    address = get_head_address(config_path)
    env = {**os.environ, ADDRESS_VAR: address}
    return subprocess.call(command, shell=True, env=env)


def attach(config_path: str) -> int:
    """Interactive shell wired to the cluster (parity: `ray attach`)."""
    address = get_head_address(config_path)
    shell = os.environ.get("SHELL", "/bin/bash")
    env = {**os.environ, ADDRESS_VAR: address}
    print(f"attaching to {address} ({ADDRESS_VAR} set; exit to detach)",
          flush=True)
    return subprocess.call([shell], env=env)


def submit(config_path: str, entrypoint: str,
           working_dir: Optional[str] = None, follow: bool = True) -> str:
    """Submit a job to the cluster (parity: `ray submit` /
    `ray job submit`)."""
    from ray_tpu_torch.job_submission import JobSubmissionClient
    address = get_head_address(config_path)
    client = JobSubmissionClient(address)
    sid = client.submit_job(
        entrypoint=entrypoint,
        runtime_env={"working_dir": working_dir} if working_dir else None)
    print(f"submitted job {sid}", flush=True)
    if follow:
        for chunk in client.tail_job_logs(sid):
            sys.stdout.write(chunk)
            sys.stdout.flush()
        print(f"job {sid}: {client.get_job_status(sid)}", flush=True)
    return sid


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser("ray_tpu_torch.cluster_launcher")
    ap.add_argument("--head-session", metavar="CONFIG",
                    help="(internal) run the head session in-process")
    args = ap.parse_args(argv)
    if args.head_session:
        run_head_session(args.head_session)


if __name__ == "__main__":
    main()
