"""Port parity: the serve ingress of ray_tpu_torch against ray_tpu's.

The scenarios of ``tests/test_serve_ingress.py`` that run in one process:

- the proxy's HTTP/1.1 edges (pipelined keep-alive, ``Connection: close``,
  501 on a chunked request body, a bad ``Content-Length``, EOF in the
  headers, the queue-full 503 with ``Retry-After`` through the live
  reconfigure path, a hygienic ``close``), on a JAX proxy and a port proxy
  side by side, each with a stand-in handle, the same bytes sent to both
  and the same answers wanted back;
- ``@serve.batch``: ``_adapt_window`` bit for bit against JAX's on seeded
  latencies, and the flush window growing under its SLO, shrinking on a
  breach and fixed without a target, in both stacks;
- on each package's in-process runtime: overload shed cleanly with a
  bounded queue, the deadline's 504 with the replica call cancelled (its
  slot freed while the replica still runs), a graceful drain under traffic
  that loses no request, and a call routed to a killed replica retried on
  the survivor.

The JAX cases that need worker processes or the fault plane (a worker's
death, the fault plane's admission site, the chaos SLO run) wait for the
port's cluster runtime (ROADMAP.md A.5). No test starts a process or binds
a fixed port; each one shuts down both stacks and clears the config
overrides it set on either.
"""

import concurrent.futures
import contextlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import config as jconfig
from ray_tpu import serve as jserve
from ray_tpu.serve import api as japi
from ray_tpu.serve import http_proxy as jproxy
from ray_tpu_torch import config as tconfig
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.serve import api as tapi
from ray_tpu_torch.serve import http_proxy as tproxy

STACKS = {"jax": (ray_tpu, jserve, jconfig),
          "port": (ray_tpu_torch, tserve, tconfig)}
TIMEOUT = 60


@contextlib.contextmanager
def _stack(name, overrides=None):
    """One stack's runtime and serve with config ``overrides`` set, torn
    down (and the overrides cleared) whatever the body does."""
    rt, serve, config = STACKS[name]
    rt.shutdown()
    for k, v in (overrides or {}).items():
        config.set_override(k, v)
    if rt is ray_tpu:
        rt.init(local_mode=True, num_cpus=8)
    else:
        rt.init(local_mode=True, num_cpus=8)
    try:
        yield rt, serve
    finally:
        try:
            serve.shutdown()
        finally:
            for p in list(jproxy._live_proxies):
                p.close()
            rt.shutdown()
            for k in overrides or {}:
                config.clear_override(k)


def _on_both(scenario, overrides=None):
    out = {}
    for name in STACKS:
        with _stack(name, overrides) as (rt, serve):
            out[name] = scenario(rt, serve)
    return out["jax"], out["port"]


def _http(port, path, payload=None, timeout=TIMEOUT):
    """One request; returns (code, body_dict_or_None, retry_after)."""
    data = json.dumps(payload).encode() if payload is not None else b"{}"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.code, json.loads(resp.read()), None
    except urllib.error.HTTPError as e:
        return e.code, None, e.headers.get("Retry-After")


# ---------------------------------------------------------------------------
# The proxy's protocol edges, a JAX proxy and a port proxy side by side
# ---------------------------------------------------------------------------

class _FakeHandle:
    """Stands in for DeploymentHandle in the in-process proxy tests."""
    _replicas = [object()]
    _max_ongoing = 4
    _closed = False

    def call(self, *args, timeout=None, **kwargs):
        if args:
            return {"echo": list(args[0]) if isinstance(args[0], bytes)
                    else args[0]}
        return dict(kwargs) or {"ok": True}


@pytest.fixture
def proxies(monkeypatch):
    """{"jax": proxy, "port": proxy}, routes pinned to /echo."""
    out = {}
    try:
        for name, api, module in (("jax", japi, jproxy),
                                  ("port", tapi, tproxy)):
            monkeypatch.setattr(api, "_handle_for",
                                lambda _name: _FakeHandle())
            p = out[name] = module.HTTPProxy("127.0.0.1", 0)
            # Pin the routing table: no controller exists to refresh from.
            p._routes_cache = {"/echo": "echo"}
            p._routes_ts = time.monotonic() + 1e9
        yield out
    finally:
        for p in out.values():
            p.close()
        for config in (jconfig, tconfig):
            config.clear_override("serve_max_queued_requests")


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
    body = f.read(int(headers.get("content-length", 0)))
    return code, headers, body


def _exchange(port, payload: bytes, responses: int = 1, close_after=False):
    """Send ``payload`` on one connection; read ``responses`` answers, and
    whether the server closed the connection after them."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(payload)
        f = s.makefile("rb")
        out = [_read_response(f) for _ in range(responses)]
        if close_after:
            out.append(f.read(1) == b"")
        f.close()
        return out


def _both(proxies, *args, **kwargs):
    got = {name: _exchange(p.port(), *args, **kwargs)
           for name, p in proxies.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _post(path, body=b"{}", extra=""):
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\n{extra}"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


def test_proxy_pipelined_keepalive_matches_jax(proxies):
    (c1, _, b1), (c2, _, b2) = _both(
        proxies, _post("/echo", b'{"a": 1}') + _post("/echo", b'{"b": 2}'),
        responses=2)
    assert (c1, c2) == (200, 200)
    assert json.loads(b1) == {"a": 1}
    assert json.loads(b2) == {"b": 2}  # no desync across pipelining


def test_proxy_connection_close_matches_jax(proxies):
    (code, _, _), closed = _both(
        proxies, _post("/echo", extra="Connection: close\r\n"),
        close_after=True)
    assert code == 200 and closed


def test_proxy_chunked_request_501_closes_socket_like_jax(proxies):
    (code, _, _), closed = _both(
        proxies,
        b"POST /echo HTTP/1.1\r\nHost: x\r\n"
        b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n",
        close_after=True)
    # socket CLOSED: the unread chunk bytes must not desync a next request
    assert code == 501 and closed


def test_proxy_bad_content_length_matches_jax(proxies):
    [(code, _, body)] = _both(
        proxies,
        b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: abc\r\n\r\n")
    assert code == 400 and json.loads(body) == {"error": "bad Content-Length"}


def test_proxy_survives_eof_mid_headers_like_jax(proxies):
    for p in proxies.values():
        s = socket.create_connection(("127.0.0.1", p.port()), timeout=10)
        s.sendall(b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-")
        s.close()  # aborted mid-headers: dropped silently, server survives
    time.sleep(0.1)
    [(code, _, body)] = _both(proxies, _post("/echo", b'{"z": 9}'))
    assert code == 200 and json.loads(body) == {"z": 9}


def test_proxy_queue_full_shed_and_raw_body_match_jax(proxies):
    for p in proxies.values():
        # a zero queue budget (the live-reconfigure path the controller
        # forwards to the proxy) sheds every request
        assert p.reconfigure({"serve_max_queued_requests": 0}) == \
            {"serve_max_queued_requests": 0}
    [(code, headers, _)] = _both(proxies, _post("/echo"))
    assert code == 503 and headers.get("retry-after") == "1"
    for p in proxies.values():
        # value None clears the override: admission back to the default
        assert p.reconfigure({"serve_max_queued_requests": None}) == \
            {"serve_max_queued_requests": 200}
    # a body that is not JSON arrives as bytes
    [(code, _, body)] = _both(proxies, _post("/echo", b"\x01raw"))
    assert code == 200 and json.loads(body) == {"echo": [1, 114, 97, 119]}
    [(code, _, _)] = _both(proxies, _post("/elsewhere"))
    assert code == 404
    assert {n: p.stats() for n, p in proxies.items()}["port"] == \
        proxies["jax"].stats() == {"served": 1, "shed": 1, "timeouts": 0,
                                   "errors": 0, "queued": 0, "ongoing": 0}


def test_proxy_close_is_hygienic():
    before = set(threading.enumerate())
    p = tproxy.HTTPProxy("127.0.0.1", 0)
    assert any(q is p for q in tproxy._live_proxies)
    port = p.port()
    p.close()
    p.close()   # idempotent
    assert p.closed
    assert not any(q is p for q in tproxy._live_proxies)
    assert not [t for t in set(threading.enumerate()) - before
                if t.is_alive()]
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=2)
    # the JAX proxy's close, for comparison, leaves its executors' idle
    # threads to the process: the port's joins them
    q = jproxy.HTTPProxy("127.0.0.1", 0)
    q.close()
    assert q.closed and not any(r is q for r in jproxy._live_proxies)


# ---------------------------------------------------------------------------
# @serve.batch: the adaptive window
# ---------------------------------------------------------------------------

def _cases():
    rng = np.random.default_rng(11)
    out = []
    for i in range(12):
        n = int(rng.integers(1, 300))
        scale = float(rng.choice([1e-3, 1e-2, 1e-1]))
        lat = (rng.exponential(scale, n)).tolist()
        out.append((lat, float(rng.choice([5.0, 50.0, 500.0])),
                    float(rng.choice([0.005, 0.01, 0.03])),
                    float(rng.uniform(0.0005, 0.3))))
    out.append(([], 50.0, 0.01, 0.01))   # no latency yet: no change
    return out


@pytest.mark.parametrize("lat,target,base,window", _cases())
def test_adapt_window_is_jax_bit_for_bit(lat, target, base, window):
    import collections
    got = {"window": window, "lat": collections.deque(lat, maxlen=256)}
    want = {"window": window, "lat": collections.deque(lat, maxlen=256)}
    tapi._adapt_window(got, target, base, len(lat))
    japi._adapt_window(want, target, base, len(lat))
    assert got["window"] == want["window"]   # exact: the same float ops


def _drive_batch(fn, waves, wave_size, pause):
    outs = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=wave_size) as ex:
        for w in range(waves):
            futs = [ex.submit(fn, w * wave_size + i)
                    for i in range(wave_size)]
            outs.extend(f.result(timeout=30) for f in futs)
            time.sleep(pause)
    return outs


def _window_after(api, make, **drive):
    """Decorate with ``api``'s batch (via ``make``), drive it, and return
    (outputs, the state's final window)."""
    before = set(api._batch_states)
    fn = make(api.batch)
    outs = _drive_batch(fn, **drive)
    new = [k for k in api._batch_states if k not in before]
    assert len(new) == 1
    return sorted(outs), api._batch_states[new[0]]["window"]


def test_adaptive_batch_window_grows_under_slo_like_jax():
    def make(batch):
        @batch(max_batch_size=64, batch_wait_timeout_s=0.01,
               target_p99_ms=500.0)
        def fast(items):
            return [i * 2 for i in items]
        return fast

    for api in (japi, tapi):
        outs, window = _window_after(api, make, waves=4, wave_size=6,
                                     pause=0.05)
        assert outs == [i * 2 for i in range(24)]
        # p99 far under target: the window grew multiplicatively
        assert window > 0.012, api.__name__


def test_adaptive_batch_window_shrinks_on_breach_like_jax():
    def make(batch):
        @batch(max_batch_size=64, batch_wait_timeout_s=0.02,
               target_p99_ms=5.0)
        def slow(items):
            time.sleep(0.08)
            return list(items)
        return slow

    for api in (japi, tapi):
        outs, window = _window_after(api, make, waves=3, wave_size=4,
                                     pause=0.05)
        assert outs == list(range(12))
        # p99 (>80ms) breaches the 5ms target: window halved repeatedly
        assert window < 0.02, api.__name__


def test_fixed_batch_window_unchanged_without_target_like_jax():
    def make(batch):
        @batch(max_batch_size=8, batch_wait_timeout_s=0.03)
        def plain(items):
            time.sleep(0.05)
            return list(items)
        return plain

    for api in (japi, tapi):
        outs, window = _window_after(api, make, waves=2, wave_size=3,
                                     pause=0.04)
        assert outs == list(range(6))
        assert window == 0.03, api.__name__


def test_batch_errors_reach_every_caller_of_the_batch():
    @tserve.batch(max_batch_size=3, batch_wait_timeout_s=1.0)
    def short(items):
        return items[:-1]   # one result too few

    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(short, i) for i in range(3)]
        for f in futs:
            with pytest.raises(ValueError, match="2 results for 3"):
                f.result(timeout=30)


# ---------------------------------------------------------------------------
# On each package's in-process runtime
# ---------------------------------------------------------------------------

def test_overload_sheds_cleanly_and_bounds_queue_like_jax():
    overrides = {"serve_max_queued_requests": 6,
                 "serve_max_ongoing_requests": 2,
                 "serve_request_timeout_s": 30.0}

    def scenario(rt, serve):
        @serve.deployment(num_replicas=1, route_prefix="/slow")
        class SlowModel:
            def __call__(self, x=0):
                time.sleep(0.1)
                return {"x": x}

        handle = serve.run(SlowModel.bind(), http_host="127.0.0.1")
        port = handle.http_port
        unloaded = [_http(port, "/slow", {"x": i}) for i in range(3)]
        assert unloaded == [(200, {"x": i}, None) for i in range(3)]

        # 10x offered load over capacity (budget: 2 ongoing + 6 queued)
        results, lock, samples = [], threading.Lock(), []

        def one_request(i):
            code, body, retry_after = _http(port, "/slow", {"x": i})
            with lock:
                results.append((i, code, body, retry_after))

        threads = [threading.Thread(target=one_request, args=(i,))
                   for i in range(60)]
        for t in threads:
            t.start()
        controller = serve.api._get_controller(create=False)
        for _ in range(6):
            time.sleep(0.05)
            samples.append(rt.get(controller.http_stats.remote(),
                                  timeout=TIMEOUT))
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        stats = rt.get(controller.http_stats.remote(), timeout=TIMEOUT)
        codes = [c for _, c, _, _ in results]
        shed = codes.count(503)
        ok = all(body == {"x": i} for i, c, body, _ in results if c == 200)
        clean = all(ra == "1" for _, c, _, ra in results if c == 503)
        return (len(results), set(codes) <= {200, 503}, shed > 0, ok, clean,
                max(s["queued"] for s in samples) <= 6,
                stats["shed"] == shed, stats["served"] == 63 - shed)

    jax_out, port_out = _on_both(scenario, overrides)
    assert jax_out == port_out == (60, True, True, True, True, True, True,
                                   True)


def test_request_deadline_504_cancels_the_call_like_jax():
    """The replica sleeps past the 1 s deadline: 504 within the deadline,
    and the call's slot is given back at once (the handle's in-flight book
    empties and the proxy counts the timeout) while the replica still
    runs it."""
    overrides = {"serve_request_timeout_s": 1.0,
                 "serve_drain_timeout_s": 2.0}

    def scenario(rt, serve):
        @serve.deployment(num_replicas=1, route_prefix="/stuck")
        class Stuck:
            def __call__(self):
                time.sleep(2.5)
                return "late"

        handle = serve.run(Stuck.bind(), http_host="127.0.0.1")
        t0 = time.monotonic()
        code, body, _ = _http(handle.http_port, "/stuck")
        elapsed = time.monotonic() - t0
        proxy_handle = serve.api._handle_for("Stuck")
        deadline = time.monotonic() + 5
        while sum(proxy_handle._inflight.values()) and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        freed = sum(proxy_handle._inflight.values()) == 0
        handle._refresh(force=True)
        still_running = rt.get(handle._replicas[0].queue_len.remote(),
                               timeout=TIMEOUT)
        stats = rt.get(serve.api._get_controller(create=False)
                       .http_stats.remote(), timeout=TIMEOUT)
        return code, body, elapsed < 2.0, freed, still_running, \
            stats["timeouts"]

    jax_out, port_out = _on_both(scenario, overrides)
    assert jax_out == port_out == (504, None, True, True, 1, 1)


def test_graceful_drain_under_traffic_loses_nothing_like_jax():
    def scenario(rt, serve):
        @serve.deployment(num_replicas=3)
        class Steady:
            def __call__(self, x):
                time.sleep(0.15)
                return x * 2

        handle = serve.run(Steady.bind())
        results, errors = [], []
        stop, lock = threading.Event(), threading.Lock()

        def traffic():
            i = 0
            while not stop.is_set():
                try:
                    out = handle.call(i, timeout=30)
                    with lock:
                        results.append((i, out))
                except Exception as e:  # noqa: BLE001 - counted below
                    with lock:
                        errors.append(e)
                i += 1

        threads = [threading.Thread(target=traffic) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            time.sleep(1.0)
            controller = serve.api._get_controller(create=False)
            gen_before = rt.get(controller.get_routing.remote("Steady"),
                                timeout=TIMEOUT)["generation"]
            # Scale down under traffic: 2 replicas must DRAIN, not die.
            serve.run(Steady.options(num_replicas=1).bind())
            saw_draining = False
            deadline = time.time() + 30
            while time.time() < deadline:
                st = serve.status()["Steady"]
                saw_draining |= st["num_replicas_draining"] > 0
                if st["num_replicas_running"] == 1 and \
                        st["num_replicas_draining"] == 0 and saw_draining:
                    break
                time.sleep(0.2)
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=TIMEOUT)
        routing = rt.get(controller.get_routing.remote("Steady"),
                         timeout=TIMEOUT)
        handle._refresh(force=True)
        return (errors, all(out == i * 2 for i, out in results),
                len(results) > 20, saw_draining, serve.status()["Steady"],
                routing["generation"] > gen_before,
                len(routing["replicas"]), len(handle._replicas))

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (
        [], True, True, True,
        {"num_replicas_target": 1, "num_replicas_running": 1,
         "num_replicas_draining": 0, "route_prefix": "/Steady"},
        True, 1, 1)


def test_call_to_a_killed_replica_retries_on_the_survivor_like_jax():
    """Kill one of two replicas and call at once, while the handle's
    routing view still lists it: every call succeeds (the ref retries on
    the survivor) and the corpse is evicted from the handle's view."""
    def scenario(rt, serve):
        @serve.deployment(num_replicas=2)
        class Echo:
            def __call__(self, x):
                return x + 1

        handle = serve.run(Echo.bind())
        handle._refresh(force=True)
        assert len(handle._replicas) == 2
        victim = handle._replicas[0]
        rt.kill(victim)
        refs = [handle.remote(i) for i in range(12)]
        outs = [rt.get(r, timeout=TIMEOUT) for r in refs]
        retried = sum(r._retried for r in refs)
        handle._refresh(force=True)
        evicted = victim._rt_actor_id not in {
            r._rt_actor_id for r in handle._replicas}
        return (outs, all(isinstance(r, serve.ServeCallRef) for r in refs),
                retried > 0, evicted)

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == ([i + 1 for i in range(12)], True, True,
                                   True)
