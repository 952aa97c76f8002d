"""CLI: cluster lifecycle + introspection. Ported from ``ray_tpu/scripts.py``.

Role parity: python/ray/scripts/scripts.py — `ray start/stop/status/
timeline/summary/list` (start:529) and `ray job ...`. Invoke as
``python -m ray_tpu_torch <cmd>``.

Where the port differs from the JAX CLI:

- ``--num-gpus`` stands for ``--num-tpus``; without it a node counts the
  host's cards (``gpu/topology.py``), as ``init()`` does.
- The address file, the pid file and the head's session directory live
  under ``tempfile.gettempdir()`` with the ``rtpt-`` prefix, where the JAX
  CLI uses ``/tmp/ray_tpu_last_address``, ``/tmp/ray_tpu_head_pids`` and
  ``/tmp/ray_tpu/session-<port>``: two CLIs with their own ``TMPDIR`` never
  read each other's head.
- A head ends on SIGTERM by stopping its dashboard, daemon (workers, zygote,
  store) and conductor. ``stop`` sends it SIGTERM, then pkills what is left
  of the port's process family (``worker_main``, ``worker_zygote`` and the
  port's ``shmstored``), but only the processes whose command line names
  this temporary directory's sessions, where the JAX ``stop`` kills every
  worker on the host.
- ``up``, ``down``, ``attach``, ``exec`` and ``submit`` drive
  ``cluster_launcher.py`` (its spec is JSON, or YAML with PyYAML
  installed). ``microbenchmark`` is not ported: it exits non-zero naming
  ROADMAP.md A.5(d).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

ADDRESS_FILE = "rtpt-cli-address"
PID_FILE = "rtpt-cli-pids"
HEAD_SESSION = "rtpt-head-"     # + port: a head on a fixed port's session

# The port's process family, each narrowed to the sessions under a
# temporary directory (``{tmp}``). Neither package's patterns match the
# other's processes: ``ray_tpu[.]cluster`` needs the dot right after
# ``ray_tpu``, and the JAX store runs from ``ray_tpu/_native/shmstored``.
STOP_PATTERNS = ("ray_tpu_torch[.]cluster[.]worker_main .* {tmp}/rtpt-",
                 "ray_tpu_torch[.]cluster[.]worker_zygote .* {tmp}/rtpt-",
                 "ray_tpu_torch/shmstored-[0-9a-f]+ {tmp}/rtpt-")

# Subcommands of the JAX CLI whose modules are still to port.
DEFERRED = {"microbenchmark": "cluster/microbench.py"}


def _tmp(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def _ere(text: str) -> str:
    """``text`` as a literal in a POSIX extended regular expression."""
    return "".join("\\" + c if c in ".[]()*+?{}|^$\\" else c for c in text)


def stop_patterns(tmp: str) -> list:
    return [p.format(tmp=_ere(tmp.rstrip("/"))) for p in STOP_PATTERNS]


def _write_state(address: str, pids) -> None:
    with open(_tmp(ADDRESS_FILE), "w") as f:
        f.write(address)
    with open(_tmp(PID_FILE), "a") as f:
        for p in pids:
            f.write(f"{p}\n")


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None)
    if addr:
        return addr
    path = _tmp(ADDRESS_FILE)
    if os.path.exists(path):
        with open(path) as f:
            return f.read().strip()
    raise SystemExit("no --address given and no running cluster found "
                     f"({path} missing)")


def _on_sigterm(signum, frame):
    raise SystemExit(0)


def cmd_start(args) -> None:
    from ray_tpu_torch.cluster.node_daemon import NodeDaemon
    from ray_tpu_torch.core.runtime_cluster import ClusterRuntime
    resources = ClusterRuntime._default_resources(args.num_cpus,
                                                  args.num_gpus, None)
    store_bytes = args.object_store_memory << 20
    signal.signal(signal.SIGTERM, _on_sigterm)
    conductor = dash = None
    owned_session = None
    if args.head:
        from ray_tpu_torch.cluster.conductor import Conductor
        if args.port:
            # Stable per-port session path: a head restarted on the same
            # port finds its journal and recovers (gcs_init_data.h role).
            session_dir = _tmp(f"{HEAD_SESSION}{args.port}")
            os.makedirs(session_dir, exist_ok=True)
        else:
            # An ephemeral port has no later head to recover it.
            session_dir = owned_session = tempfile.mkdtemp(
                prefix="rtpt-session-")
        conductor = Conductor(host=args.host, port=args.port,
                              persist_dir=session_dir)
        daemon = NodeDaemon(conductor.address, resources=resources,
                            is_head=True, session_dir=session_dir,
                            object_store_bytes=store_bytes)
        address = conductor.address
        _write_state(address, [os.getpid(), daemon.store_proc.pid])
        print(f"ray_tpu_torch head started. Address: {address}")
        if args.dashboard_port >= 0:
            from ray_tpu_torch.dashboard import Dashboard
            try:
                dash = Dashboard(address, host=args.host,
                                 port=args.dashboard_port)
            except OSError:
                # port taken (second head on one box): a random port
                # rather than aborting head startup
                dash = Dashboard(address, host=args.host, port=0)
            print(f"Dashboard: {dash.url}")
        print(f"Connect other nodes with:\n  python -m ray_tpu_torch start "
              f"--address {address}")
        print(f"Drive it with:\n  import ray_tpu_torch; "
              f"ray_tpu_torch.init(address='{address}')", flush=True)
    else:
        address = _resolve_address(args)
        daemon = NodeDaemon(address, resources=resources,
                            object_store_bytes=store_bytes)
        _write_state(address, [os.getpid(), daemon.store_proc.pid])
        print(f"node daemon joined {address} "
              f"(node_id={daemon.node_id.hex()[:12]})", flush=True)
    if not (args.block or args.head):
        return
    try:
        signal.pause()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        if dash is not None:
            dash.stop()
        daemon.stop()
        if conductor is not None:
            conductor.stop()
        if owned_session is not None:
            import shutil
            shutil.rmtree(owned_session, ignore_errors=True)


def _wait_gone(pids, limit_s: float) -> None:
    deadline = time.monotonic() + limit_s
    while pids and time.monotonic() < deadline:
        pids = [p for p in pids if _alive(p)]
        time.sleep(0.1)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:   # a zombie child of ours counts as gone
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"
    except OSError:
        return False


def cmd_stop(args) -> None:
    n, pids = 0, []
    pid_file = _tmp(PID_FILE)
    if os.path.exists(pid_file):
        with open(pid_file) as f:
            lines = f.read().split()
        for line in lines:
            try:
                os.kill(int(line), signal.SIGTERM)
                pids.append(int(line))
                n += 1
            except (ValueError, ProcessLookupError):
                pass
        os.remove(pid_file)
    # A head's SIGTERM handler stops its daemon, which ends its workers,
    # zygote and store; give it the time to, then kill what is left.
    _wait_gone(pids, 15.0)
    for pattern in stop_patterns(tempfile.gettempdir()):
        subprocess.run(["pkill", "-f", pattern], check=False)
    if os.path.exists(_tmp(ADDRESS_FILE)):
        os.remove(_tmp(ADDRESS_FILE))
    # Reclaim shm segments + session dirs the killed tree leaves behind.
    # Scratch (ckpt/algo dirs) is swept only here — an explicit teardown —
    # never at session start, where a live experiment may still hold them.
    time.sleep(0.5)  # let SIGTERM'd stores run their own cleanup first
    from ray_tpu_torch.cluster import hygiene
    removed = hygiene.sweep_stale(include_scratch=True)
    print(f"stopped {n} processes"
          + (f", swept {len(removed)} stale artifacts" if removed else ""))


def _connect(args):
    import ray_tpu_torch
    ray_tpu_torch.init(address=_resolve_address(args))
    return ray_tpu_torch


def cmd_status(args) -> None:
    rt = _connect(args)
    nodes = rt.nodes()
    total = rt.cluster_resources()
    avail = rt.available_resources()
    print(f"Nodes: {sum(1 for n in nodes if n['Alive'])} alive / "
          f"{len(nodes)} total")
    for n in nodes:
        mark = "HEAD" if n.get("is_head") else "    "
        state = "ALIVE" if n["Alive"] else "DEAD "
        print(f"  {mark} {state} {n['NodeID'][:12]} {n['address']} "
              f"{n['Resources']}")
    print("Resources (available / total):")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0):g} / {total[k]:g}")


def cmd_list(args) -> None:
    _connect(args)
    from ray_tpu_torch import state
    fn = {"actors": state.list_actors, "tasks": state.list_tasks,
          "nodes": state.list_nodes, "objects": state.list_objects,
          "placement-groups": state.list_placement_groups,
          "events": state.list_cluster_events,
          "ring-events": state.list_ring_events,
          "spans": state.list_spans}[args.entity]
    print(json.dumps(fn(), indent=2, default=str))


def cmd_profile(args) -> None:
    """`profile <pid>`: flamegraph-able stack dump of any live worker
    (parity: `ray stack` / dashboard py-spy trigger)."""
    _connect(args)
    from ray_tpu_torch import state
    dump = state.profile_worker(args.pid, duration_s=args.duration,
                                node_id=args.node_id)
    if args.output:
        with open(args.output, "w") as f:
            f.write(dump)
        print(f"collapsed stacks written to {args.output} "
              f"(feed to flamegraph.pl or speedscope)")
    else:
        print(dump)


def cmd_summary(args) -> None:
    _connect(args)
    from ray_tpu_torch import state
    print(json.dumps(state.summarize_tasks(), indent=2, default=str))


def cmd_timeline(args) -> None:
    rt = _connect(args)
    out = args.output or _tmp(f"rtpt-timeline-{int(time.time())}.json")
    rt.timeline(out)
    print(f"chrome://tracing timeline written to {out}")


def cmd_metrics(args) -> None:
    _connect(args)
    from ray_tpu_torch.util.metrics import prometheus_text
    print(prometheus_text())


def cmd_debug_state(args) -> None:
    """`debug-state`: one JSON document with the conductor's and every
    live daemon's internal table sizes (parity: the per-process
    debug_state.txt files `ray status -v` points at)."""
    _connect(args)
    from ray_tpu_torch import state
    print(json.dumps(state.debug_state(), indent=2, default=str))


def cmd_fault_sites(args) -> None:
    """`fault-sites`: the canonical fault-injection site registry
    (cluster/fault_plane.py SITES). Plans name these sites."""
    from ray_tpu_torch.cluster.fault_plane import SITES
    if args.json:
        print(json.dumps(SITES, indent=2, sort_keys=True))
        return
    width = max(len(s) for s in SITES)
    for site in sorted(SITES):
        print(f"{site:<{width}}  {SITES[site]}")
    print(f"{len(SITES)} fault sites (inject with "
          f"ray_tpu_torch.cluster.fault_plane.load_plan(rules))")


def cmd_deferred(args) -> None:
    raise SystemExit(
        f"python -m ray_tpu_torch {args.cmd}: not ported yet; it needs "
        f"{DEFERRED[args.cmd]}, which ROADMAP.md A.5(d) queues")


def cmd_up(args) -> None:
    """`up spec` (parity: scripts.py:1223 `ray up`)."""
    from ray_tpu_torch import cluster_launcher
    cluster_launcher.up(args.config)


def cmd_down(args) -> None:
    from ray_tpu_torch import cluster_launcher
    cluster_launcher.down(args.config)


def cmd_attach(args) -> None:
    from ray_tpu_torch import cluster_launcher
    raise SystemExit(cluster_launcher.attach(args.config))


def cmd_exec(args) -> None:
    from ray_tpu_torch import cluster_launcher
    raise SystemExit(cluster_launcher.exec_cmd(args.config,
                                               " ".join(args.command)))


def cmd_submit(args) -> None:
    from ray_tpu_torch import cluster_launcher
    entry = list(args.entrypoint)
    if entry and entry[0] == "--":
        entry = entry[1:]
    cluster_launcher.submit(args.config, " ".join(entry),
                            working_dir=args.working_dir,
                            follow=not args.no_wait)


def cmd_job(args) -> None:
    """`job submit/status/logs/list/stop` (parity: `ray job ...`,
    dashboard/modules/job/cli.py)."""
    from ray_tpu_torch.job_submission import JobSubmissionClient
    client = JobSubmissionClient(_resolve_address(args))
    if args.job_cmd == "submit":
        entry = list(args.entrypoint)
        if entry and entry[0] == "--":
            entry = entry[1:]
        sid = client.submit_job(
            entrypoint=" ".join(entry),
            submission_id=args.submission_id or None,
            runtime_env={"working_dir": args.working_dir}
            if args.working_dir else None)
        print(f"submitted job {sid}", flush=True)
        if args.follow:
            for chunk in client.tail_job_logs(sid):
                sys.stdout.write(chunk)
                sys.stdout.flush()
            print(f"job {sid}: {client.get_job_status(sid)}")
    elif args.job_cmd == "status":
        print(client.get_job_status(args.submission_id))
    elif args.job_cmd == "logs":
        if args.follow:
            for chunk in client.tail_job_logs(args.submission_id):
                sys.stdout.write(chunk)
                sys.stdout.flush()
        else:
            sys.stdout.write(client.get_job_logs(args.submission_id))
    elif args.job_cmd == "list":
        for j in client.list_jobs():
            print(f"{j.submission_id}  {j.status:10s}  {j.entrypoint}")
    elif args.job_cmd == "stop":
        ok = client.stop_job(args.submission_id)
        print("stopped" if ok else "not running")


def cmd_client_server(args) -> None:
    """`client-server` — run a client proxy so thin drivers can connect
    with init("client://host:port") (parity: `ray start
    --ray-client-server-port`, util/client/server)."""
    from ray_tpu_torch.client.server import serve_proxy
    signal.signal(signal.SIGTERM, _on_sigterm)
    proxy = serve_proxy(address=_resolve_address(args),
                        host=args.host, port=args.port)
    print(f"client proxy listening on client://{proxy.address}", flush=True)
    try:
        signal.pause()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        proxy.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "ray_tpu_torch",
        description="the PyTorch port's distributed runtime CLI")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head node or join a cluster")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6380,
                   help="the head's conductor port (0 = any free port)")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None,
                   help="cards to offer (default: the host's)")
    p.add_argument("--object-store-memory", type=int, default=1024,
                   help="MB of shm for the object store")
    p.add_argument("--dashboard-port", type=int, default=8265,
                   help="dashboard HTTP port (0 = random, -1 = disabled)")
    p.add_argument("--block", action="store_true")
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop this host's cluster processes "
                                    "of this temporary directory")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("up", help="bring up a cluster from a spec file")
    p.add_argument("config")
    p.set_defaults(fn=cmd_up)
    p = sub.add_parser("down", help="tear down a launched cluster")
    p.add_argument("config")
    p.set_defaults(fn=cmd_down)
    p = sub.add_parser("attach", help="shell with RAY_TPU_TORCH_ADDRESS set "
                                      "to the head")
    p.add_argument("config")
    p.set_defaults(fn=cmd_attach)
    p = sub.add_parser("exec", help="run a command against the cluster")
    p.add_argument("config")
    p.add_argument("command", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_exec)
    p = sub.add_parser("submit", help="submit a job to a launched cluster")
    p.add_argument("config")
    p.add_argument("entrypoint", nargs=argparse.REMAINDER)
    p.add_argument("--working-dir", default=None)
    p.add_argument("--no-wait", action="store_true")
    p.set_defaults(fn=cmd_submit)

    for name in DEFERRED:
        p = sub.add_parser(name, help=f"not ported yet ({DEFERRED[name]})")
        p.add_argument("rest", nargs=argparse.REMAINDER)
        p.set_defaults(fn=cmd_deferred)

    p = sub.add_parser("client-server",
                       help="run a client proxy for client:// drivers")
    p.add_argument("--address", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10001)
    p.set_defaults(fn=cmd_client_server)

    for name, fn in (("status", cmd_status), ("summary", cmd_summary),
                     ("timeline", cmd_timeline), ("metrics", cmd_metrics),
                     ("debug-state", cmd_debug_state)):
        p = sub.add_parser(name)
        p.add_argument("--address", default=None)
        if name == "timeline":
            p.add_argument("--output", default=None)
        p.set_defaults(fn=fn)

    p = sub.add_parser("fault-sites",
                       help="list registered fault-injection sites")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_fault_sites)

    p = sub.add_parser("job", help="submit and manage jobs")
    jsub = p.add_subparsers(dest="job_cmd", required=True)
    pj = jsub.add_parser("submit")
    pj.add_argument("entrypoint", nargs=argparse.REMAINDER,
                    help="command to run, e.g. -- python train.py")
    pj.add_argument("--address", default=None)
    pj.add_argument("--submission-id", default=None)
    pj.add_argument("--working-dir", default=None)
    pj.add_argument("--follow", action="store_true",
                    help="stream logs until the job finishes")
    pj.set_defaults(fn=cmd_job)
    for jname in ("status", "logs", "stop"):
        pj = jsub.add_parser(jname)
        pj.add_argument("submission_id")
        pj.add_argument("--address", default=None)
        if jname == "logs":
            pj.add_argument("--follow", action="store_true")
        pj.set_defaults(fn=cmd_job)
    pj = jsub.add_parser("list")
    pj.add_argument("--address", default=None)
    pj.set_defaults(fn=cmd_job)

    p = sub.add_parser("list", help="list cluster entities")
    p.add_argument("entity", choices=["actors", "tasks", "nodes", "objects",
                                      "placement-groups", "events",
                                      "ring-events", "spans"])
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("profile",
                       help="sample a worker's stacks (flamegraph input)")
    p.add_argument("pid", type=int)
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--node-id", default=None,
                   help="node-id hex prefix: scope the pid lookup to one "
                        "node (pids are per-host)")
    p.add_argument("--output", "-o", default=None)
    p.add_argument("--address", default=None)
    p.set_defaults(fn=cmd_profile)

    args = parser.parse_args(argv)
    try:
        args.fn(args)
    finally:
        import ray_tpu_torch
        ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
