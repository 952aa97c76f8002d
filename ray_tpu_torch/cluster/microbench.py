"""Scheduler/object-plane microbenchmarks (reference: `ray microbenchmark`,
python/ray/_private/ray_perf.py:93-240 — same op families, re-measured for
this runtime). Ported from ``ray_tpu/cluster/microbench.py``: the same
families under the same result names.

Runs against a real local cluster (conductor + node daemon + shm store +
spawned workers — NOT local_mode) so the numbers include the full RPC,
lease, serialization and shm paths. Writes MICROBENCH_r{N}.json when
--round N is given, else prints to stdout.

Where the port differs from the JAX module:

- The remote functions, actor classes and the serve deployment's function
  are defined at module level, and wrapped with ``remote`` and
  ``serve.deployment`` in ``main``: the port's pickler sends callables to
  workers by import path and refuses nested ones.
- The suite's head is given ``num_gpus=0``: a port node counts the host's
  cards unless told otherwise, and the suite measures the control plane,
  not the card. Nothing sets a platform variable.
- ``run_microbenchmark(address)`` raises on an address and the CLI passes
  its ``--address`` through, where the JAX CLI prints a note and drops it.
- ``--quick`` scales the pause between families (``settle``) with the
  timed windows, to 0.2 s; the JAX suite pauses 1 s whatever the scale.
  It also times one call past the warm-up where the full suite times at
  least two or three, and takes the best of 2 pulls, broadcasts and
  spills where the JAX suite's quick run takes the best of 5, 3 and 2.
- The results carry the JAX suite's names (``RESULT_NAMES``) but those in
  ``DIVERGENCES``, each with its reason. The output adds ``seconds``: the
  wall seconds each result took since the one before it.

Usage:
    python -m ray_tpu_torch.cluster.microbench [--round 2] [--quick]
    python -m ray_tpu_torch microbenchmark       # same suite via the CLI
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The result names of the JAX suite (ray_tpu/cluster/microbench.py), in the
# order it writes them.
RESULT_NAMES = (
    "rpc_roundtrip_per_sec", "rpc_roundtrip_1ms_per_sec",
    "rpc_pipelined_1ms_per_sec", "rtcheck_full_tree_per_sec",
    "lock_uncontended_per_sec", "put_1kb_per_sec", "get_1kb_per_sec",
    "put_get_100mb_gb_per_sec", "task_roundtrip_per_sec",
    "task_roundtrip_traced_per_sec", "task_roundtrip_events_off_per_sec",
    "task_roundtrip_inline_per_sec", "tasks_async_per_sec",
    "actor_call_sync_per_sec", "actor_call_inline_per_sec",
    "actor_calls_async_per_sec", "dag_classic_roundtrip_per_sec",
    "compiled_graph_roundtrip_per_sec", "channel_array_roundtrip_per_sec",
    "pipeline_stage_roundtrip_per_sec", "pipeline_1f1b_efficiency",
    "pipeline_1f1b_bubble_bound", "pipeline_vs_dp_step_speedup",
    "actor_creation_per_sec", "host_cpus",
    "actor_creation_wave_100_per_sec", "wait_1k_refs_per_sec",
    "queued_tasks_drained_per_sec", "serve_http_per_sec",
    "serve_shed_per_sec", "serve_batch_fixed_per_sec",
    "serve_batch_adaptive_per_sec", "pull_remote_100mb_gb_per_sec",
    "pull_remote_100mb_tcp_gb_per_sec",
    "pull_remote_100mb_serial_baseline_gb_per_sec",
    "broadcast_64mb_4way_gb_per_sec", "array_put_get_100mb_gb_per_sec",
    "array_put_get_100mb_classic_gb_per_sec",
    "device_broadcast_64mb_4way_gb_per_sec",
    "spill_restore_100mb_gb_per_sec", "put_under_pressure_gb_per_sec")

# Result names of the JAX suite this suite does not write, and why.
DIVERGENCES = {
    "pull_remote_100mb_serial_baseline_gb_per_sec":
        "a constant (0.45) measured once on the JAX package's host before "
        "its pull rebuild, not by this run; this suite writes only what it "
        "measures",
}


def timed(fn, *, min_time: float = 1.0, min_iters: int = 3):
    """Run fn() repeatedly until min_time elapsed; return (per_call_s, n)."""
    fn()  # warmup
    n, t0 = 0, time.perf_counter()
    while True:
        fn()
        n += 1
        dt = time.perf_counter() - t0
        if dt >= min_time and n >= min_iters:
            return dt / n, n


class _TimedResults(dict):
    """The results, and the wall seconds from the previous result to each
    one (``seconds``): what its family took, its settle included."""

    def __init__(self):
        super().__init__()
        self.seconds: dict = {}
        self._last = time.perf_counter()

    def __setitem__(self, name, value):
        now = time.perf_counter()
        self.seconds[name] = round(now - self._last, 3)
        self._last = now
        super().__setitem__(name, value)


def settle(seconds: float = 1.0) -> None:
    """Quiesce between op families: let the previous phase's GC backlog
    (refcount flushes, batched deletes, pool refills) drain so each family
    measures its own steady state, not the tail of its predecessor — the
    reference's ray_perf.py likewise measures op families in isolation."""
    import gc
    gc.collect()
    time.sleep(seconds)


def compare_results(old: dict, new: dict, tolerance: float) -> list:
    """Regression gate over two result dicts (or whole output files —
    either shape is accepted). Compares every metric PRESENT IN BOTH whose
    name marks it higher-is-better (``*_per_sec`` / ``*_gb_per_sec`` rates
    and ``*_efficiency`` fractions); metrics only one side has are
    skipped, so the gate survives suite growth. Returns the list of
    (name, old, new, ratio) regressions where ``new < tolerance * old``."""
    old = old.get("results", old)
    new = new.get("results", new)
    bad = []
    for name in sorted(set(old) & set(new)):
        if not (name.endswith("_per_sec") or name.endswith("_gb_per_sec")
                or name.endswith("_efficiency")):
            continue
        o, n = old[name], new[name]
        if not o:
            continue  # zero/absent baseline: no meaningful ratio
        ratio = n / o
        status = "ok" if n >= tolerance * o else "REGRESSED"
        print(f"  {name:45s} {o:>12} -> {n:>12}  x{ratio:.2f}  {status}")
        if status == "REGRESSED":
            bad.append((name, o, n, ratio))
    return bad


def run_compare(old_path: str, new_path: str, tolerance: float) -> int:
    with open(old_path) as f:
        old = json.load(f)
    with open(new_path) as f:
        new = json.load(f)
    print(f"compare: {old_path} -> {new_path} (tolerance {tolerance})")
    bad = compare_results(old, new, tolerance)
    if bad:
        print(f"{len(bad)} metric(s) below {tolerance}x of baseline")
        return 1
    print("no regressions")
    return 0


# -- the suite's remote functions, actor classes and serve function ------
# At module level: the port's workers import them by path.

def nop():
    return None


def echo(x):
    return x


class Counter:
    def __init__(self):
        self.x = 0

    def incr(self):
        self.x += 1
        return self.x


class Echo:
    def echo(self, x):
        return x


class Stage:
    def step(self, x):
        return x + 1


def bench_fn(x=0):
    return {"x": x}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--round", type=int, default=0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--compare", nargs=2, metavar=("OLD.json", "NEW.json"),
                    help="regression gate: compare two result files and "
                    "exit nonzero if any shared rate metric fell below "
                    "--tolerance x the old value (no benchmarks are run)")
    ap.add_argument("--tolerance", type=float, default=0.8,
                    help="--compare pass threshold as a fraction of the "
                    "old value (default 0.8; benchmarks on shared hosts "
                    "need slack for scheduler noise)")
    args = ap.parse_args(argv)
    if args.compare:
        return run_compare(args.compare[0], args.compare[1], args.tolerance)

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    # The callables by their importable module, not ``__main__`` (run as
    # ``python -m``): workers then import this module by name.
    from ray_tpu_torch.cluster.microbench import (Counter, Echo, Stage,
                                                  bench_fn, echo, nop)

    scale = 0.2 if args.quick else 1.0
    pause = scale   # the quiet second between families, shortened too
    # repeats of a family's longest calls: the best of 2, not of 3 or 5
    reps = 2 if args.quick else None

    def timed_(fn, seconds: float, min_iters: int = 3):
        # --quick: a fifth of the window, and one timed call past the
        # warm-up is enough
        return timed(fn, min_time=seconds * scale,
                     min_iters=1 if args.quick else min_iters)
    results = _TimedResults()

    # -- raw RPC framing: serialized vs pipelined frames --------------
    # Measured OUTSIDE the cluster so the number isolates the wire/frame
    # cost (one in-flight call per socket vs sequence-numbered frames).
    from ray_tpu_torch.cluster.protocol import RpcClient, RpcServer

    class _Echo:
        def rpc_echo(self, x):
            return x

        def rpc_echo_1ms(self, x):
            # Stand-in for real service time (lock contention, disk,
            # downstream RPC). Pipelining only pays off when the server
            # does WORK per call — on a zero-latency loopback the extra
            # executor handoff makes pipelined frames slower, so the
            # headline comparison injects 1ms.
            time.sleep(0.001)
            return x

    srv = RpcServer(_Echo())
    cli = RpcClient(srv.address)
    n_rpc = 200

    def rpc_serial():
        for _ in range(n_rpc):
            cli.call("echo", x=1)

    per, _ = timed_(rpc_serial, 1.0)
    results["rpc_roundtrip_per_sec"] = round(n_rpc / per, 1)

    def rpc_serial_1ms():
        for _ in range(n_rpc):
            cli.call("echo_1ms", x=1)

    per, _ = timed_(rpc_serial_1ms, 1.0)
    results["rpc_roundtrip_1ms_per_sec"] = round(n_rpc / per, 1)

    def rpc_pipelined_1ms():
        for f in [cli.call_async("echo_1ms", x=1) for _ in range(n_rpc)]:
            f.result()

    per, _ = timed_(rpc_pipelined_1ms, 1.0)
    results["rpc_pipelined_1ms_per_sec"] = round(n_rpc / per, 1)
    cli.close()
    srv.stop()

    # -- correctness tooling (r15): both measured without a cluster ---
    # rtcheck full-package scan: the tier-1 self-check runs this every
    # suite invocation, so its wall time is a gated budget (<10s).
    from ray_tpu_torch.devtools.rtcheck import run_tree

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def rtcheck_scan():
        run_tree([pkg_root])

    per, _ = timed_(rtcheck_scan, 1.0)
    results["rtcheck_full_tree_per_sec"] = round(1 / per, 2)

    # NamedLock with the sanitizer armed, uncontended: the overhead every
    # armed control-plane lock acquisition pays (held-stack push/pop).
    from ray_tpu_torch import config as _config
    from ray_tpu_torch.util import lockcheck

    lockcheck.reset()
    _config.set_override("lockcheck_enabled", True)
    try:
        bench_lock = lockcheck.named_lock("bench.uncontended")
        n_lock = 20000

        def lock_loop():
            for _ in range(n_lock):
                with bench_lock:
                    pass

        per, _ = timed_(lock_loop, 1.0)
    finally:
        _config.clear_override("lockcheck_enabled")
        lockcheck.reset()
    results["lock_uncontended_per_sec"] = round(n_lock / per, 1)

    # 1GB store: a realistic fraction of a TPU-host's RAM — the default
    # 256MB can hold only two 100MB bandwidth-test objects, so the loop
    # would measure spill I/O instead of the put path. 4 workers: enough
    # parallelism for the async families without drowning a small host in
    # context switches. No card: the suite measures the control plane.
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "num_gpus": 0,
                                "object_store_bytes": 1 << 30})
    ray_tpu_torch.init(address=c.address)
    try:
        # -- put/get small objects ------------------------------------
        def put_small():
            for _ in range(100):
                ray_tpu_torch.put(b"x" * 1024)

        per, _ = timed_(put_small, 1.0)
        results["put_1kb_per_sec"] = round(100 / per, 1)

        settle(pause)
        ref = ray_tpu_torch.put(b"y" * 1024)

        def get_small():
            for _ in range(100):
                ray_tpu_torch.get(ref)

        per, _ = timed_(get_small, 1.0)
        results["get_1kb_per_sec"] = round(100 / per, 1)

        # -- put/get bandwidth (100MB numpy, zero-copy shm path) ------
        settle(pause)
        big = np.zeros(100 * 1024 * 1024, dtype=np.uint8)

        def put_big():
            ray_tpu_torch.get(ray_tpu_torch.put(big))

        per, _ = timed_(put_big, 2.0, 2)
        results["put_get_100mb_gb_per_sec"] = round(0.1 / per, 2)

        # -- task submit+get roundtrip --------------------------------
        settle(pause)
        nop_r = ray_tpu_torch.remote(nop)

        def task_roundtrip():
            ray_tpu_torch.get(nop_r.remote())

        per, _ = timed_(task_roundtrip, 2.0)
        results["task_roundtrip_per_sec"] = round(1 / per, 1)

        # -- observability overhead (obs_overhead gate) ---------------
        # The same roundtrip with tracing + the event ring on: the
        # flight-recorder tax is ring appends and span buffering only
        # (all shipping is async), so this must stay within tolerance
        # of the plain rate under --compare. Also measured with the
        # ring disabled, pinning the cost of the enabled()-check path.
        settle(pause)
        _config.set_override("tracing_enabled", True)

        def task_roundtrip_traced():
            ray_tpu_torch.get(nop_r.remote())

        per, _ = timed_(task_roundtrip_traced, 2.0)
        results["task_roundtrip_traced_per_sec"] = round(1 / per, 1)
        _config.clear_override("tracing_enabled")

        settle(pause)
        _config.set_override("events_enabled", False)
        per, _ = timed_(task_roundtrip, 2.0)
        results["task_roundtrip_events_off_per_sec"] = round(1 / per, 1)
        _config.clear_override("events_enabled")

        # -- inline-return roundtrip (reply-carried 1KiB payload) -----
        # Exercises the execution-plane fast path end to end: the result
        # rides the push reply, the caller's get() is served from the
        # inline cache, and the store seal happens off the critical path.
        payload = b"p" * 1024
        echo_r = ray_tpu_torch.remote(echo)

        def task_roundtrip_inline():
            ray_tpu_torch.get(echo_r.remote(payload))

        per, _ = timed_(task_roundtrip_inline, 2.0)
        results["task_roundtrip_inline_per_sec"] = round(1 / per, 1)

        # -- async task throughput (pipelined submissions) ------------
        n_tasks = int(1000 * scale) or 100

        def task_async():
            ray_tpu_torch.get([nop_r.remote() for _ in range(n_tasks)])

        per, _ = timed_(task_async, 2.0, 2)
        results["tasks_async_per_sec"] = round(n_tasks / per, 1)

        # -- actor calls ----------------------------------------------
        settle(pause)
        CounterR = ray_tpu_torch.remote(Counter)
        a = CounterR.remote()
        ray_tpu_torch.get(a.incr.remote())

        def actor_sync():
            ray_tpu_torch.get(a.incr.remote())

        per, _ = timed_(actor_sync, 2.0)
        results["actor_call_sync_per_sec"] = round(1 / per, 1)

        # -- inline actor call (1KiB reply-carried result) ------------
        e = ray_tpu_torch.remote(Echo).remote()
        ray_tpu_torch.get(e.echo.remote(b""))

        def actor_call_inline():
            ray_tpu_torch.get(e.echo.remote(payload))

        per, _ = timed_(actor_call_inline, 2.0)
        results["actor_call_inline_per_sec"] = round(1 / per, 1)
        ray_tpu_torch.kill(e)

        n_calls = int(1000 * scale) or 100

        def actor_async():
            ray_tpu_torch.get([a.incr.remote() for _ in range(n_calls)])

        per, _ = timed_(actor_async, 2.0, 2)
        results["actor_calls_async_per_sec"] = round(n_calls / per, 1)

        # -- DAG roundtrips: classic lazy execute vs compiled graph ---
        # Same 2-actor chain both ways. Classic pays two task submissions
        # plus an owner-side get per execute; the compiled plan pays one
        # input-channel write and one leaf-channel read (the resident
        # loops never touch the scheduler).
        settle(pause)
        from ray_tpu_torch.dag import InputNode

        StageR = ray_tpu_torch.remote(Stage)
        s1, s2 = StageR.bind(), StageR.bind()
        with InputNode() as inp:
            chain = s2.step.bind(s1.step.bind(inp))

        def dag_classic():
            assert chain.execute(1) == 3

        per, _ = timed_(dag_classic, 2.0)
        results["dag_classic_roundtrip_per_sec"] = round(1 / per, 1)

        cg = chain.experimental_compile(max_in_flight=8)
        assert ray_tpu_torch.get(cg.execute(1), timeout=30) == 3  # warm

        def compiled_graph():
            assert ray_tpu_torch.get(cg.execute(1), timeout=30) == 3

        per, _ = timed_(compiled_graph, 2.0)
        results["compiled_graph_roundtrip_per_sec"] = round(1 / per, 1)

        # -- r16: array value through the same compiled chain ---------
        # A 512KB float32 rides each channel hop as an RTAR slot
        # (FLAG_ARRAY): header + raw buffer, no pickle on either side.
        arr512 = np.zeros(128 * 1024, dtype=np.float32)
        assert ray_tpu_torch.get(cg.execute(arr512),
                           timeout=30).nbytes == arr512.nbytes  # warm

        def compiled_graph_array():
            out = ray_tpu_torch.get(cg.execute(arr512), timeout=30)
            assert out.nbytes == arr512.nbytes

        per, _ = timed_(compiled_graph_array, 2.0)
        results["channel_array_roundtrip_per_sec"] = round(1 / per, 1)
        cg.teardown()
        for s in (s1, s2):
            ray_tpu_torch.kill(s._actor_handle)

        # -- MPMD pipeline schedules over cgraph channels (r13) -------
        # Three views of the same machinery: raw scheduled-step turnaround
        # with no compute (channel + program overhead), measured 1F1B
        # efficiency against the m/(m+s-1) bubble bound (sleep stages
        # overlap even on one core, so this gates the SCHEDULE, not the
        # host), and the speedup over running the identical per-microbatch
        # work as classic serial actor RPCs.
        settle(pause)
        from ray_tpu_torch.train.compiled_pipeline import (CompiledPipeline,
                                                           SleepStage)

        PipeStage = ray_tpu_torch.remote(SleepStage)

        # (a) zero-work scheduled-step roundtrip
        nul = [PipeStage.options(num_cpus=1).remote(0.0, 0.0)
               for _ in range(2)]
        ray_tpu_torch.get([a.ping.remote() for a in nul])
        pipe = CompiledPipeline(nul, num_microbatches=4, schedule="1f1b")
        payload = [b"x" * 64] * 4
        pipe.step(payload)  # warm

        def pipeline_step_nul():
            pipe.step(payload)

        per, _ = timed_(pipeline_step_nul, 2.0)
        results["pipeline_stage_roundtrip_per_sec"] = round(1 / per, 1)
        pipe.teardown()
        for a in nul:
            ray_tpu_torch.kill(a)

        # (b) measured 1F1B efficiency vs the bubble bound
        settle(pause)
        fwd_s, bwd_s, s_pp, m_pp = 0.01, 0.02, 3, 6
        stages = [PipeStage.options(num_cpus=1).remote(fwd_s, bwd_s)
                  for _ in range(s_pp)]
        ray_tpu_torch.get([a.ping.remote() for a in stages])
        pipe = CompiledPipeline(stages, num_microbatches=m_pp,
                                schedule="1f1b")
        payload = [b"x" * 64] * m_pp
        effs = []
        for i in range(5):
            r = pipe.step(payload)
            if i >= 1:              # step 0 has no inter-collect wall
                effs.append(r["efficiency"])
        effs.sort()
        results["pipeline_1f1b_efficiency"] = round(
            effs[len(effs) // 2], 4)
        results["pipeline_1f1b_bubble_bound"] = round(pipe.bound, 4)
        pipe.teardown()

        # (c) same per-microbatch work, serial classic RPCs (the DP/
        # sequential strawman: no microbatch overlap across stages)
        def dp_style_step():
            for _ in range(m_pp):
                for a in stages:
                    ray_tpu_torch.get(a.pipe_forward.remote(0, 0, b"x"))
                for a in reversed(stages):
                    ray_tpu_torch.get(a.pipe_backward.remote(0, 0, b"x"))

        per_dp, _ = timed_(dp_style_step, 2.0, 2)
        # pipelined wall per step, steady state
        pipe2 = CompiledPipeline(stages, num_microbatches=m_pp,
                                 schedule="1f1b")
        pipe2.step(payload)
        walls = []
        for _ in range(3):
            walls.append(pipe2.step(payload)["wall_s"])
        pipe2.teardown()
        results["pipeline_vs_dp_step_speedup"] = round(
            per_dp / min(walls), 2)
        for a in stages:
            ray_tpu_torch.kill(a)

        # -- actor creation throughput (zygote fork path) -------------
        # End-to-end: N actors created, first method call acked, killed.
        # Fractional CPUs so the 4-CPU cluster holds the whole cohort.
        settle(pause)
        LightCounter = CounterR.options(num_cpus=0.05)
        n_act = int(40 * scale) or 8

        def actor_create():
            actors = [LightCounter.remote() for _ in range(n_act)]
            ray_tpu_torch.get([x.incr.remote() for x in actors])
            for x in actors:
                ray_tpu_torch.kill(x)

        per, _ = timed_(actor_create, 2.0, 2)
        results["actor_creation_per_sec"] = round(n_act / per, 1)
        results["host_cpus"] = os.cpu_count()  # creation is CPU-bound:
        # fork + worker boot + RPCs parallelize across cores on real hosts

        # -- 100-actor wave (SCALE_r03 collapse scenario) -------------
        # One coalesced register_actors + one start_actors batch + shared
        # resolver long-poll; steady-state (recycled workers), like the
        # repeated-wave shape of real serving/training fan-outs.
        settle(pause)
        WaveCounter = CounterR.options(num_cpus=0.01)

        def actor_wave_100():
            actors = [WaveCounter.remote() for _ in range(100)]
            ray_tpu_torch.get([x.incr.remote() for x in actors])
            for x in actors:
                ray_tpu_torch.kill(x)

        per, _ = timed_(actor_wave_100, 2.0, 2)
        results["actor_creation_wave_100_per_sec"] = round(100 / per, 1)

        # -- wait over many refs --------------------------------------
        settle(pause)
        refs = [ray_tpu_torch.put(i) for i in range(1000)]

        def wait_1k():
            ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=30)

        per, _ = timed_(wait_1k, 1.0, 2)
        results["wait_1k_refs_per_sec"] = round(1 / per, 2)
        del refs

        # -- scheduler drain: queue 2k tasks at once ------------------
        settle(pause)
        n_q = int(2000 * scale) or 200
        t0 = time.perf_counter()
        ray_tpu_torch.get([nop_r.remote() for _ in range(n_q)])
        results["queued_tasks_drained_per_sec"] = round(
            n_q / (time.perf_counter() - t0), 1)

        # -- serve ingress (r14): HTTP end-to-end, shed fast path, ----
        # -- adaptive vs fixed batching -------------------------------
        # End-to-end RPS through the proxy (admission + routing + replica
        # call), the cost of REJECTING at the admission gate (shedding
        # must stay cheap under overload or the gate itself melts), and
        # @serve.batch throughput with a fixed window vs the p99-target
        # adaptive window growing it under light latency pressure.
        settle(pause)
        import urllib.request as _url
        from ray_tpu_torch import serve as _serve

        # Fractional CPUs: the 4-CPU bench cluster still hosts earlier
        # families' actors; controller + proxy + 2 replicas must fit.
        bench_dep = _serve.deployment(
            bench_fn, num_replicas=2, route_prefix="/bench",
            max_ongoing_requests=16, ray_actor_options={"num_cpus": 0.25})
        bh = _serve.run(bench_dep.bind(), http_host="127.0.0.1")
        bench_port = bh.http_port

        def http_once(i):
            req = _url.Request(
                f"http://127.0.0.1:{bench_port}/bench",
                data=json.dumps({"x": i}).encode(),
                headers={"Content-Type": "application/json"})
            return _url.urlopen(req, timeout=30).read()

        for i in range(10):
            http_once(i)   # warm routes cache + replica handles
        import concurrent.futures as _cf
        n_http = int(200 * scale) or 40
        pool8 = _cf.ThreadPoolExecutor(max_workers=8)

        def serve_http():
            list(pool8.map(http_once, range(n_http)))

        per, _ = timed_(serve_http, 1.0)
        results["serve_http_per_sec"] = round(n_http / per, 1)

        # Zero the queue budget IN THE PROXY PROCESS (a driver-local
        # set_override only reaches processes spawned afterwards) so
        # every request sheds at the admission gate.
        from ray_tpu_torch.serve.api import _get_controller
        _ctrl = _get_controller(create=False)
        ray_tpu_torch.get(_ctrl.http_reconfigure.remote(
            {"serve_max_queued_requests": 0}), timeout=30)

        def shed_once(i):
            try:
                http_once(i)
                return False
            except _url.HTTPError as e:
                return e.code == 503

        def serve_shed():
            assert all(pool8.map(shed_once, range(n_http)))

        per, _ = timed_(serve_shed, 1.0)
        results["serve_shed_per_sec"] = round(n_http / per, 1)
        ray_tpu_torch.get(_ctrl.http_reconfigure.remote(
            {"serve_max_queued_requests": None}), timeout=30)
        pool8.shutdown()
        _serve.shutdown()   # frees the replicas' CPUs for later families

        def bench_batch(deco):
            @deco
            def work(items):
                time.sleep(0.002)  # per-flush cost batching amortizes
                return list(items)

            n_b = int(400 * scale) or 80
            with _cf.ThreadPoolExecutor(max_workers=16) as ex:
                t0 = time.perf_counter()
                list(ex.map(work, range(n_b)))
                return n_b / (time.perf_counter() - t0)

        results["serve_batch_fixed_per_sec"] = round(bench_batch(
            _serve.batch(max_batch_size=32,
                         batch_wait_timeout_s=0.005)), 1)
        results["serve_batch_adaptive_per_sec"] = round(bench_batch(
            _serve.batch(max_batch_size=32, batch_wait_timeout_s=0.005,
                         target_p99_ms=50.0)), 1)

        # -- node-to-node pull bandwidth (100MB) ----------------------
        # LAST: these add peer nodes, which would change the placement
        # topology the families above are measured on.
        # A second node's ObjectPlane pulls a head-held object into its
        # own store: the full probe + windowed multi-chunk transfer path.
        # Reported twice: the default config (same-host daemons take the
        # shm-direct segment copy) and the chunked-TCP path that
        # cross-host pulls use (object_pull_shm_direct off).
        settle(pause)
        from ray_tpu_torch import config
        from ray_tpu_torch.core import api as core_api
        from ray_tpu_torch.cluster.object_plane import ObjectPlane

        rt = core_api._runtime
        peers = [c.add_node(num_cpus=1, object_store_bytes=512 << 20)
                 for _ in range(4)]
        c.wait_for_nodes(5)
        planes = [ObjectPlane(n.store, n.node_id, c.address,
                              daemon_address=n.address)
                  for n in peers]

        def pull_100mb_best() -> float:
            times = []
            for _ in range(reps or 5):
                ref = ray_tpu_torch.put(big)
                key = rt.plane._key(ref.id)
                t0 = time.perf_counter()
                out = planes[0]._pull(key, rt.daemon_address)
                times.append(time.perf_counter() - t0)
                assert out == "ok", out
                peers[0].store.delete(key)
                del ref
            return min(times)

        results["pull_remote_100mb_gb_per_sec"] = round(
            0.1 / pull_100mb_best(), 2)
        config.set_override("object_pull_shm_direct", False)
        results["pull_remote_100mb_tcp_gb_per_sec"] = round(
            0.1 / pull_100mb_best(), 2)
        config.clear_override("object_pull_shm_direct")
        # (The JAX suite writes a constant here, its r08 serial-loop
        # baseline: DIVERGENCES.)

        # -- 4-way broadcast (64MB to 4 nodes concurrently) -----------
        # Pullers locate via the directory; mid-transfer registration
        # lets late pullers read from early completers instead of all
        # four piling on the origin (implicit broadcast tree).
        settle(pause)
        big64 = np.zeros(64 * 1024 * 1024, dtype=np.uint8)

        def bcast_64mb():
            import threading as _threading
            ref = ray_tpu_torch.put(big64)
            views = [None] * len(planes)

            def one(i):
                views[i] = planes[i].get_view(ref.id, timeout=60)

            ts = [_threading.Thread(target=one, args=(i,),
                                    name=f"bench-pull-{i}", daemon=True)
                  for i in range(len(planes))]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            dt = time.perf_counter() - t0
            # views hold the serialized blob (header + buffer), so >= raw.
            assert all(v is not None and v.nbytes >= big64.nbytes
                       for v in views)
            key = rt.plane._key(ref.id)
            del views
            for n in peers:
                try:
                    n.store.delete(key)
                except Exception:
                    pass
            del ref
            return dt

        dt = min(bcast_64mb() for _ in range(reps or 3))
        results["broadcast_64mb_4way_gb_per_sec"] = round(
            len(planes) * 0.064 / dt, 2)

        # -- r16: device-native array plane ---------------------------
        # Same-host array put/get on the RTAR fast path (header + raw
        # buffer, single copy in, read-only view out) vs the classic
        # pickle-5 path measured back to back as the same-day control.
        settle(pause)

        def array_put_get():
            out = ray_tpu_torch.get(ray_tpu_torch.put(big))
            assert out.nbytes == big.nbytes

        per, _ = timed_(array_put_get, 2.0, 2)
        results["array_put_get_100mb_gb_per_sec"] = round(0.1 / per, 2)
        config.set_override("array_zero_copy_enabled", False)
        per, _ = timed_(array_put_get, 2.0, 2)
        results["array_put_get_100mb_classic_gb_per_sec"] = round(
            0.1 / per, 2)
        config.clear_override("array_zero_copy_enabled")

        # Coordinated broadcast tree (ObjectPlane.broadcast_object) to
        # the same 4 peers the directory-driven broadcast above used:
        # rounds of tree legs, each fresh holder serving the next wave.
        settle(pause)

        def device_bcast() -> float:
            ref = ray_tpu_torch.put(big64)
            members = [{"node_id": n.node_id, "address": n.address}
                       for n in peers]
            t0 = time.perf_counter()
            res = rt.plane.broadcast_object(ref.id, members)
            dt_ = time.perf_counter() - t0
            assert len(res["ok"]) + len(res["fallback"]) == len(peers), res
            key = rt.plane._key(ref.id)
            for n in peers:
                try:
                    n.store.delete(key)
                except Exception:
                    pass
            del ref
            return dt_

        dt = min(device_bcast() for _ in range(reps or 3))
        results["device_broadcast_64mb_4way_gb_per_sec"] = round(
            len(peers) * 0.064 / dt, 2)

        # -- object tiering: coordinated spill + restore (r12) --------
        # One 100MB primary is written through the node daemon's spill
        # backend, evicted from shm, and restored by the driver plane's
        # third-tier get — the full durable-copy round trip
        # (local_object_manager.h's spill and restore halves).
        settle(pause)
        from ray_tpu_torch.cluster.protocol import get_client as _get_client
        daemon_cli = _get_client(rt.daemon_address)

        def spill_restore_100mb() -> float:
            ref = ray_tpu_torch.put(big)
            key = rt.plane._key(ref.id)
            t0 = time.perf_counter()
            freed = daemon_cli.call("spill_request",
                                    want_bytes=1 << 40)["freed"]
            assert freed >= big.nbytes, f"spill only freed {freed}"
            view = rt.plane.get_view(ref.id, timeout=120)
            dt = time.perf_counter() - t0
            assert view.nbytes >= big.nbytes
            del view
            daemon_cli.call("delete_object", oid=key)
            del ref
            return dt

        dt = min(spill_restore_100mb() for _ in range(reps or 4))
        results["spill_restore_100mb_gb_per_sec"] = round(0.1 / dt, 2)

        # -- put throughput while overcommitted ------------------------
        # Sustained 100MB puts past store capacity: admission rides the
        # native LRU spill plus the daemon's coordinated spill manager
        # (put-side spill-then-admit backpressure instead of ST_OOM).
        settle(pause)
        n_press = 4 if args.quick else 12
        t0 = time.perf_counter()
        press_refs = [ray_tpu_torch.put(big) for _ in range(n_press)]
        dt = time.perf_counter() - t0
        results["put_under_pressure_gb_per_sec"] = round(
            n_press * 0.1 / dt, 2)
        del press_refs

    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()

    out = {
        "suite": "ray_tpu_torch microbenchmark",
        "reference_analog": "python/ray/_private/ray_perf.py:93",
        "mode": "cluster (conductor+daemon+shm store+spawned workers)",
        "results": dict(results),
        "seconds": results.seconds,
    }
    line = json.dumps(out, indent=2)
    if args.round:
        path = f"MICROBENCH_r{args.round:02d}.json"
        with open(path, "w") as f:
            f.write(line + "\n")
        print(f"wrote {path}")
    print(line)
    return 0


def run_microbenchmark(address=None) -> int:
    """CLI entry (`python -m ray_tpu_torch microbenchmark`): run the full
    suite.
    The suite OWNS its cluster so numbers are comparable run-to-run; a
    live-cluster --address is therefore rejected, not silently ignored."""
    if address:
        raise SystemExit(
            "microbenchmark always measures a fresh local cluster for "
            "comparable numbers; drop --address")
    return main([])


if __name__ == "__main__":
    sys.exit(main())
