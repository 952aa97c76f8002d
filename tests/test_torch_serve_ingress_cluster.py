"""The port's serve ingress on its cluster runtime, held to the JAX serve's
on a JAX ``Cluster``: the cases of ``tests/test_serve_ingress.py`` that
need worker processes, the fault plane or the metrics KV.

- ``test_stale_replica_retry_after_kill``: calls routed to a killed
  replica that the handle still lists retry on the survivor;
- ``test_chaos_slo_replica_kill_mid_traffic`` (marked ``chaos``, seeded by
  the ``chaos_seed`` fixture, the same seed for both stacks): the fault
  plane crashes replicas mid-traffic through ``serve.replica.call``;
- the admission-fault half of
  ``test_proxy_admission_fault_and_queue_full_shed``: a raised
  ``serve.proxy.admit`` fault sheds with 503 and ``Retry-After``, on a
  JAX proxy and a port proxy side by side with stand-in handles, as the
  JAX test runs it;
- ``test_overload_sheds_cleanly_and_bounds_queue``, with its
  ``rt_serve_shed_total`` check: the proxy's sheds reach the conductor's
  metrics KV.

Each cluster scenario runs on a fresh JAX ``Cluster`` and then on a fresh
port ``Cluster`` in the same test, as the JAX tests start one a test: the
config overrides and the fault plan must reach the controller, proxy and
replica processes, which take them at spawn. Timing decides which calls
shed or retry, so the stacks are compared on what the JAX test asserts,
not on counts. Port deployments are module-level (they ship by import
path); worker processes import this module by name, so it imports no JAX
at the top, and the JAX workers get its functions by value.
"""

import contextlib
import json
import os
import pickle
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from ray_tpu_torch import serve as tserve

TIMEOUT = 60


@contextlib.contextmanager
def _cluster(pkg, overrides=None, num_cpus=8):
    """A fresh cluster of ``pkg`` (``"ray_tpu"`` or ``"ray_tpu_torch"``)
    with ``overrides`` set first, its runtime installed; yields (rt, serve,
    fault_plane). Everything is torn down and cleared afterwards."""
    import importlib
    import sys
    rt = importlib.import_module(pkg)
    serve = importlib.import_module(pkg + ".serve")
    config = importlib.import_module(pkg + ".config")
    fault_plane = importlib.import_module(pkg + ".cluster.fault_plane")
    Cluster = importlib.import_module(
        pkg + ".cluster.cluster_utils").Cluster
    api = importlib.import_module(pkg + ".core.api")
    ClusterRuntime = importlib.import_module(
        pkg + ".core.runtime_cluster").ClusterRuntime
    by_value = pkg == "ray_tpu"
    if by_value:
        import cloudpickle
        cloudpickle.register_pickle_by_value(sys.modules[__name__])
    rt.shutdown()
    for k, v in (overrides or {}).items():
        config.set_override(k, v)
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": num_cpus})
    api._runtime = ClusterRuntime(address=c.address)
    try:
        yield rt, serve, fault_plane
    finally:
        try:
            serve.shutdown()
        except Exception:
            pass
        api._runtime.shutdown()
        api._runtime = None
        c.shutdown()
        for k in overrides or {}:
            config.clear_override(k)
        fault_plane.clear_plan()
        if by_value:
            cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


def _http(port, path, payload=None, timeout=30):
    """One request; returns (code, body_dict_or_None, retry_after)."""
    data = json.dumps(payload).encode() if payload is not None else b"{}"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.code, json.loads(resp.read()), None
    except urllib.error.HTTPError as e:
        return e.code, None, e.headers.get("Retry-After")


def _metric_total(rt, name):
    """Sum a counter/gauge across the snapshots in the conductor metrics
    KV of every process but this one (None if none has shipped it yet).
    This process's own registry may carry sheds of an in-process proxy of
    an earlier test, which its flusher ships to any conductor."""
    conductor = rt.core.api._global_runtime().conductor
    total, found = 0.0, False
    mine = f"-{os.getpid()}".encode()
    for key in conductor.call("kv_keys", ns="metrics"):
        if key.endswith(mine):
            continue
        blob = conductor.call("kv_get", ns="metrics", key=key)
        if blob is None:
            continue
        entry = pickle.loads(blob).get(name)
        if not entry:
            continue
        for _tags, value in entry["points"]:
            total += value
            found = True
    return total if found else None


def _wait_dead(rt, actor):
    """Until a killed actor stops answering (the kill is eventually
    consistent)."""
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            rt.get(actor.check_health.remote(), timeout=5)
            time.sleep(0.05)
        except Exception:
            return True
    return False


# ---------------------------------------------------------------------------
# the port's deployments (module level: they ship by import path)
# ---------------------------------------------------------------------------

@tserve.deployment(name="Echo", num_replicas=2)
class StaleEcho:
    def __call__(self, x):
        return x + 1


@tserve.deployment(name="Model", num_replicas=3, route_prefix="/model")
class ChaosModel:
    def __call__(self, x=0):
        time.sleep(0.05)
        return {"x": x, "pid": os.getpid()}

    def boom(self):
        return "unreachable"  # crash fires before user code


@tserve.deployment(name="SlowModel", num_replicas=1, route_prefix="/slow")
class OverloadModel:
    def __call__(self, x=0):
        time.sleep(0.1)
        return {"x": x}


# ---------------------------------------------------------------------------
# stale-replica routing: evict + retry on submission failure
# ---------------------------------------------------------------------------

def _stale_retry(rt, serve, deployment):
    handle = serve.run(deployment.bind())
    handle._refresh(force=True)
    n = len(handle._replicas)
    victim = handle._replicas[0]
    rt.kill(victim)
    dead = _wait_dead(rt, victim)
    # The handle's routing view still lists the corpse (no refresh since
    # the kill): roughly half of these route to it and must retry.
    refs = [handle.remote(i) for i in range(12)]
    outs = [rt.get(r, timeout=TIMEOUT) for r in refs]
    typed = all(isinstance(r, serve.ServeCallRef) for r in refs)
    handle._refresh(force=True)
    evicted = victim._rt_actor_id not in {
        r._rt_actor_id for r in handle._replicas}
    serve.delete("Echo")
    return n, dead, outs, typed, evicted


def test_stale_replica_retry_after_kill_like_jax():
    with _cluster("ray_tpu") as (rt, serve, _):
        @serve.deployment(num_replicas=2)
        class Echo:
            def __call__(self, x):
                return x + 1

        want = _stale_retry(rt, serve, Echo)
    with _cluster("ray_tpu_torch") as (rt, serve, _):
        got = _stale_retry(rt, serve, StaleEcho)
    assert got == want == (2, True, [i + 1 for i in range(12)], True, True)


# ---------------------------------------------------------------------------
# chaos SLO: replica killed mid open-loop traffic
# ---------------------------------------------------------------------------

CHAOS_OVERRIDES = {"serve_max_queued_requests": 4,
                   "serve_max_ongoing_requests": 2,
                   "serve_request_timeout_s": 15.0}


def _chaos(rt, serve, fault_plane, deployment, seed, call_args):
    """The JAX chaos test's traffic, kills and checks; returns each check's
    outcome and what it measured."""
    # Loaded BEFORE serve.run: controller, proxy, and every replica
    # (replacements included) inherit the plan at spawn.
    fault_plane.load_plan(
        [{"site": "serve.replica.call", "match": {"method": "boom"},
          "action": "crash", "every": 1}], seed=seed)
    handle = serve.run(deployment.bind(), http_host="127.0.0.1")
    port = handle.http_port
    results = []
    lock = threading.Lock()

    def open_loop(tid):
        for i in range(25):
            t0 = time.monotonic()
            code, body, retry_after = _http(
                port, "/model", {"x": tid * 100 + i}, timeout=25)
            with lock:
                results.append((code, body, retry_after,
                                time.monotonic() - t0))
            time.sleep(0.02)

    threads = [threading.Thread(target=open_loop, args=(t,))
               for t in range(6)]
    for t in threads:
        t.start()

    def kill_one():
        # Direct replica submission: the crash must hit exactly one LIVE
        # replica per shot.
        handle._refresh(force=True)
        for cand in handle._replicas:
            try:
                rt.get(cand.check_health.remote(), timeout=5)
            except Exception:
                continue
            cand.handle_request.remote("boom", call_args)
            return

    time.sleep(0.5)
    kill_one()
    time.sleep(1.0)
    kill_one()
    for t in threads:
        t.join()
    codes = {c for c, _, _, _ in results}
    clean = all(ra is not None for c, _, ra, _ in results if c == 503)
    bodies = all(b["x"] >= 0 for c, b, _, _ in results if c == 200)
    slowest = max(lat for _, _, _, lat in results)
    ok = [r for r in results if r[0] == 200]
    pids = {body["pid"] for _, body, _, _ in ok}
    deadline = time.time() + 60
    while time.time() < deadline:
        if serve.status()["Model"]["num_replicas_running"] == 3:
            break
        time.sleep(0.5)
    running = serve.status()["Model"]["num_replicas_running"]
    lat, recovered = [], []
    for i in range(20):
        t0 = time.monotonic()
        code, body, _ = _http(port, "/model", {"x": i})
        lat.append(time.monotonic() - t0)
        recovered.append(code)
        if code == 200:
            pids.add(body["pid"])
    serve.delete("Model")
    checks = {"answers": len(results) == 150,
              "codes": codes <= {200, 503}, "clean_sheds": clean,
              "bodies": bodies, "within_deadline": slowest < 20.0,
              "enough_ok": len(ok) >= 75, "reconverged": running == 3,
              "after": recovered == [200] * 20,
              "p99_recovered": max(lat) < 5.0,
              "replaced": len(pids) >= 4}
    return checks, {"ok": len(ok), "codes": sorted(codes),
                    "slowest_s": slowest, "pids": len(pids)}


@pytest.mark.chaos
def test_chaos_slo_replica_kill_mid_traffic_like_jax(chaos_seed):
    """Fault plane kills replicas mid-stream (crash on a matched
    serve.replica.call): every accepted request completes (retried to
    success on another replica), sheds are clean 503 + Retry-After, no
    request outlives the deadline, and p99 recovers after the controller
    reconverges. Seed printed by the fixture for replay."""
    import cloudpickle
    with _cluster("ray_tpu", CHAOS_OVERRIDES) as (rt, serve, fp):
        @serve.deployment(num_replicas=3, route_prefix="/model")
        class Model:
            def __call__(self, x=0):
                time.sleep(0.05)
                return {"x": x, "pid": os.getpid()}

            def boom(self):
                return "unreachable"

        want, jax_seen = _chaos(rt, serve, fp, Model, chaos_seed,
                                cloudpickle.dumps(((), {})))
    with _cluster("ray_tpu_torch", CHAOS_OVERRIDES) as (rt, serve, fp):
        got, port_seen = _chaos(rt, serve, fp, ChaosModel, chaos_seed,
                                ((), {}))
    assert all(want.values()), (want, jax_seen)
    assert got == want, (got, port_seen)


# ---------------------------------------------------------------------------
# the proxy's fault-plane admission site
# ---------------------------------------------------------------------------

class _FakeHandle:
    """Stands in for DeploymentHandle in in-process proxy tests."""
    _replicas = [object()]
    _max_ongoing = 4
    _closed = False

    def call(self, *args, timeout=None, **kwargs):
        return dict(kwargs) or {"ok": True}


def _post_raw(path, body=b"{}"):
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def _read_response(f):
    status = f.readline().decode("latin1")
    code = int(status.split(" ")[1])
    headers = {}
    while True:
        line = f.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin1").partition(":")
        headers[k.strip().lower()] = v.strip()
    f.read(int(headers.get("content-length", 0)))
    return code, headers.get("retry-after")


def _admission_fault(pkg, monkeypatch):
    """The admission-fault half of
    ``test_proxy_admission_fault_and_queue_full_shed`` on ``pkg``'s
    proxy: (code, Retry-After) with the fault, then without it, and the
    proxy's shed count."""
    import importlib
    api = importlib.import_module(pkg + ".serve.api")
    fault_plane = importlib.import_module(pkg + ".cluster.fault_plane")
    HTTPProxy = importlib.import_module(pkg + ".serve.http_proxy").HTTPProxy
    monkeypatch.setattr(api, "_handle_for", lambda name: _FakeHandle())
    p = HTTPProxy("127.0.0.1", 0)
    p._routes_cache = {"/echo": "echo"}
    p._routes_ts = time.monotonic() + 1e9
    out = []
    try:
        fault_plane.load_plan(
            [{"site": "serve.proxy.admit", "action": "raise", "every": 1}])
        for _ in range(2):
            s = socket.create_connection(("127.0.0.1", p.port()),
                                         timeout=10)
            s.sendall(_post_raw("/echo"))
            out.append(_read_response(s.makefile("rb")))
            s.close()
            fault_plane.clear_plan()
        out.append(p.stats()["shed"])
    finally:
        p.close()
        fault_plane.clear_plan()
    return out


def test_proxy_admission_fault_sheds_with_retry_after_like_jax(monkeypatch):
    from ray_tpu_torch.util import events
    want = _admission_fault("ray_tpu", monkeypatch)
    seq = len(events.snapshot())
    got = _admission_fault("ray_tpu_torch", monkeypatch)
    assert got == want == [(503, "1"), (200, None), 1]
    kinds = [e[1] for e in events.snapshot()[seq:]]
    assert kinds.count("serve.shed") == 1
    assert kinds.count("serve.request") == 2


# ---------------------------------------------------------------------------
# overload: bounded queue, clean sheds, accepted p99, the shed metric
# ---------------------------------------------------------------------------

OVERLOAD_OVERRIDES = {"serve_max_queued_requests": 6,
                      "serve_max_ongoing_requests": 2,
                      "serve_request_timeout_s": 30.0}


def _overload(rt, serve, deployment):
    """The JAX overload test's traffic; returns each check's outcome and
    the shed count."""
    handle = serve.run(deployment.bind(), http_host="127.0.0.1")
    port = handle.http_port
    unloaded, first_ok = [], True
    for i in range(10):
        t0 = time.monotonic()
        code, body, _ = _http(port, "/slow", {"x": i})
        unloaded.append(time.monotonic() - t0)
        first_ok &= code == 200 and body == {"x": i}
    p99_unloaded = sorted(unloaded)[-1]
    results = []
    res_lock = threading.Lock()
    stats_samples = []

    def one_request(i):
        t0 = time.monotonic()
        code, _, retry_after = _http(port, "/slow", {"x": i})
        with res_lock:
            results.append((code, time.monotonic() - t0, retry_after))

    threads = [threading.Thread(target=one_request, args=(i,))
               for i in range(60)]
    for t in threads:
        t.start()
    controller = serve.api._get_controller(create=False)
    for _ in range(6):
        time.sleep(0.05)
        stats_samples.append(
            rt.get(controller.http_stats.remote(), timeout=30))
    for t in threads:
        t.join()
    codes = [c for c, _, _ in results]
    shed = sum(1 for c in codes if c == 503)
    accepted = sorted(lat for c, lat, _ in results if c == 200)
    p99 = accepted[min(len(accepted) - 1, int(0.99 * len(accepted)))] \
        if accepted else float("inf")
    stats = rt.get(controller.http_stats.remote(), timeout=30)
    deadline = time.time() + 20
    while time.time() < deadline:
        if _metric_total(rt, "rt_serve_shed_total") == float(shed):
            break
        time.sleep(0.5)
    metric = _metric_total(rt, "rt_serve_shed_total")
    serve.delete("SlowModel")
    checks = {"unloaded": first_ok, "answers": len(results) == 60,
              "codes": set(codes) <= {200, 503}, "shed": shed > 0,
              "clean_sheds": all(ra is not None
                                 for c, _, ra in results if c == 503),
              "queue_bounded": max(s["queued"] for s in stats_samples) <= 6,
              "p99": p99 <= 5 * max(p99_unloaded, 0.15),
              "stats_shed": stats["shed"] == shed,
              "stats_served": stats["served"] == 60 + 10 - shed,
              "shed_metric": metric == float(shed)}
    return checks, shed


def test_overload_sheds_cleanly_and_counts_sheds_in_the_kv_like_jax():
    with _cluster("ray_tpu", OVERLOAD_OVERRIDES) as (rt, serve, _):
        @serve.deployment(num_replicas=1, route_prefix="/slow")
        class SlowModel:
            def __call__(self, x=0):
                time.sleep(0.1)
                return {"x": x}

        want, jax_shed = _overload(rt, serve, SlowModel)
    with _cluster("ray_tpu_torch", OVERLOAD_OVERRIDES) as (rt, serve, _):
        got, port_shed = _overload(rt, serve, OverloadModel)
    assert all(want.values()), [k for k, v in want.items() if not v]
    assert got == want, (got, port_shed, jax_shed)
