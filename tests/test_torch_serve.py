"""Port parity: ray_tpu_torch.serve against ray_tpu.serve, each on its own
package's in-process runtime.

Each scenario of ``tests/test_serve.py``, ``tests/test_serve_dag_proxy.py``
and ``tests/test_serve_lm.py`` runs once on ``ray_tpu.init(local_mode=True)``
with ``ray_tpu.serve`` and once on ``ray_tpu_torch.init(local_mode=True)`` with
``ray_tpu_torch.serve``, in the same test and on the same inputs, and the
test compares what the two stacks answered: values, HTTP status codes and
bodies, batch sizes, and how many replicas were hit. No test starts a
process or binds a fixed port (every proxy binds port 0 on 127.0.0.1), and
each one shuts down both stacks' serve and runtime, closing the JAX proxy
that the JAX controller leaves open in local mode (its kill stops the actor,
not the proxy's own loop thread). Every HTTP call and ``get`` has its own
timeout. The LM is a small f32 model whose JAX weights go to the port
through ``params_from_jax``; prompts of one length keep each row
independent of its batch, so both servers give the same greedy tokens.
"""

import concurrent.futures
import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.serve import http_proxy as jproxy
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.serve import http_proxy as tproxy

STACKS = {"jax": (ray_tpu, jserve), "port": (ray_tpu_torch, tserve)}
TIMEOUT = 60


@contextlib.contextmanager
def _stack(name):
    """One stack's runtime and serve, torn down whatever the body does."""
    rt, serve = STACKS[name]
    rt.shutdown()
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


def _on_both(scenario):
    """``scenario(rt, serve)`` on the JAX stack, then on the port's."""
    out = {}
    for name in STACKS:
        with _stack(name) as (rt, serve):
            out[name] = scenario(rt, serve)
    return out["jax"], out["port"]


def _post(port, path, payload=None):
    """(code, json body) of one POST."""
    data = json.dumps(payload).encode() if payload is not None else b""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.code, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# tests/test_serve.py
# ---------------------------------------------------------------------------

def test_function_deployment_matches_jax():
    def scenario(rt, serve):
        @serve.deployment
        def echo(x=None):
            return {"echo": x}

        handle = serve.run(echo.bind())
        out = rt.get(handle.remote(41), timeout=TIMEOUT)
        serve.delete("echo")
        return out, sorted(serve.status())

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == ({"echo": 41}, ["echo"])


def test_class_deployment_with_state_matches_jax():
    def scenario(rt, serve):
        @serve.deployment(num_replicas=1)
        class Model:
            def __init__(self, scale):
                self.scale = scale

            def __call__(self, x):
                return x * self.scale

            def describe(self):
                return {"scale": self.scale}

        handle = serve.run(Model.bind(3))
        h2 = handle.options(method_name="describe")
        return (rt.get(handle.remote(5), timeout=TIMEOUT),
                rt.get(h2.remote(), timeout=TIMEOUT))

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (15, {"scale": 3})


def test_multi_replica_routing_hits_both_replicas():
    def scenario(rt, serve):
        @serve.deployment(num_replicas=2)
        class WhoAmI:
            def __call__(self):
                return id(self)

        handle = serve.run(WhoAmI.bind())
        hit = {rt.get(handle.remote(), timeout=TIMEOUT) for _ in range(12)}
        status = serve.status()["WhoAmI"]
        return len(hit), status["num_replicas_running"]

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (2, 2)


def test_http_ingress_and_404_match_jax():
    def scenario(rt, serve):
        @serve.deployment(route_prefix="/sum")
        def summer(a=0, b=0):
            return {"sum": a + b}

        handle = serve.run(summer.bind(), http_host="127.0.0.1")
        return (_post(handle.http_port, "/sum", {"a": 2, "b": 40}),
                _post(handle.http_port, "/nope"))

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (
        (200, {"sum": 42}), (404, {"error": "no matching route"}))


def test_batching_sizes_and_rows_match_jax():
    """Two waves of 4 calls against ``max_batch_size=4``: each wave is one
    batch of 4 (the window, 2 s, never flushes first), and every caller
    gets its own row back."""
    def scenario(rt, serve):
        @serve.deployment(max_concurrent_queries=16)
        class Batched:
            def __init__(self):
                self.batches = []

            @serve.batch(max_batch_size=4, batch_wait_timeout_s=2.0)
            def handle(self, items):
                self.batches.append(list(items))
                return [i * 2 for i in items]

            def __call__(self, x):
                return self.handle(x)

            def recorded(self):
                return self.batches

        handle = serve.run(Batched.bind())
        outs = []
        for wave in range(2):
            refs = [handle.remote(wave * 4 + i) for i in range(4)]
            outs += rt.get(refs, timeout=TIMEOUT)
        batches = rt.get(handle.options("recorded").remote(),
                         timeout=TIMEOUT)
        return outs, [sorted(b) for b in batches]

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (
        [2 * i for i in range(8)], [[0, 1, 2, 3], [4, 5, 6, 7]])


def test_user_config_and_autoscaling_match_jax():
    """``user_config`` reaches each replica's ``reconfigure`` before it
    serves, and 3 calls in flight on one replica move the autoscaler's
    target to 3 (one call a replica)."""
    def scenario(rt, serve):
        @serve.deployment(num_replicas=1, user_config={"scale": 3},
                          autoscaling_config={
                              "min_replicas": 1, "max_replicas": 3,
                              "target_num_ongoing_requests": 1})
        class Scaled:
            def __init__(self):
                self.scale = 1

            def reconfigure(self, cfg):
                self.scale = cfg["scale"]

            def __call__(self, x, hold=0.0):
                time.sleep(hold)
                return x * self.scale

        handle = serve.run(Scaled.bind())
        first = rt.get(handle.remote(5), timeout=TIMEOUT)
        refs = [handle.remote(i, hold=3.0) for i in range(3)]
        target, deadline = 1, time.time() + 10
        while target != 3 and time.time() < deadline:
            time.sleep(0.1)
            target = serve.status()["Scaled"]["num_replicas_target"]
        return first, target, rt.get(refs, timeout=TIMEOUT)

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (15, 3, [0, 3, 6])


def test_async_method_and_replica_cap_match_jax():
    """A coroutine method is driven to its value on the replica's thread,
    and a replica at its in-flight cap (1) sheds a second call with
    ReplicaBusyError, which the handle retries once and, with no other
    replica, gives back to the caller."""
    def scenario(rt, serve):
        @serve.deployment(num_replicas=1, max_ongoing_requests=1)
        class Capped:
            async def __call__(self, x):
                return x + 1

            def hold(self, s):
                time.sleep(s)
                return "held"

        handle = serve.run(Capped.bind())
        value = rt.get(handle.remote(1), timeout=TIMEOUT)
        held = handle.options("hold").remote(1.0)
        time.sleep(0.2)   # the first call is running: the replica is full
        shed = handle.options("hold").remote(0.0)
        try:
            rt.get(shed, timeout=TIMEOUT)
            cause = None
        except rt.TaskError as e:
            cause = type(e.cause).__name__
        return value, rt.get(held, timeout=TIMEOUT), cause, shed._retried

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (2, "held", "ReplicaBusyError", True)


def test_replica_recovery_after_kill_matches_jax():
    """The reconciler replaces a killed replica (a health ping to it
    fails) and the handle routes to the new one."""
    def scenario(rt, serve):
        @serve.deployment(num_replicas=1)
        class Fragile:
            def __call__(self):
                return "alive"

        handle = serve.run(Fragile.bind())
        first = rt.get(handle.remote(), timeout=TIMEOUT)
        handle._refresh(force=True)
        victim = handle._replicas[0]
        rt.kill(victim)
        deadline = time.time() + 45
        while time.time() < deadline:
            try:
                handle._ts = 0  # force refresh
                if rt.get(handle.remote(), timeout=15) == "alive":
                    break
            except Exception:
                time.sleep(0.25)
        else:
            raise AssertionError("replica was not recovered")
        handle._refresh(force=True)
        replaced = [r._rt_actor_id != victim._rt_actor_id
                    for r in handle._replicas]
        return first, replaced, serve.status()["Fragile"][
            "num_replicas_running"]

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == ("alive", [True], 1)


# ---------------------------------------------------------------------------
# tests/test_serve_dag_proxy.py
# ---------------------------------------------------------------------------

def test_deployment_graph_matches_jax():
    """Ensemble.bind(A.bind(), B.bind()): nested apps deploy bottom-up and
    arrive as live handles."""
    def scenario(rt, serve):
        @serve.deployment(ray_actor_options={"num_cpus": 0.1})
        class Doubler:
            def __call__(self, x):
                return x * 2

        @serve.deployment(ray_actor_options={"num_cpus": 0.1})
        class Adder:
            def __init__(self, offset):
                self.offset = offset

            def __call__(self, x):
                return x + self.offset

        @serve.deployment(ray_actor_options={"num_cpus": 0.1})
        class Ensemble:
            def __init__(self, doubler, adder):
                self.doubler = doubler
                self.adder = adder

            def __call__(self, x):
                d = rt.get(self.doubler.remote(x), timeout=TIMEOUT)
                return rt.get(self.adder.remote(d), timeout=TIMEOUT)

        handle = serve.run(Ensemble.bind(Doubler.bind(), Adder.bind(10)))
        return (rt.get(handle.remote(7), timeout=TIMEOUT),
                sorted(serve.status()))

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (24, ["Adder", "Doubler", "Ensemble"])


def test_proxy_json_body_and_keepalive_match_jax():
    def scenario(rt, serve):
        @serve.deployment(name="echo2", ray_actor_options={"num_cpus": 0.1})
        class Echo:
            def __call__(self, **kwargs):
                return {"got": kwargs}

        handle = serve.run(Echo.bind(), http_host="127.0.0.1")
        port = handle.http_port
        # a list body is one positional argument; a dict body, kwargs
        return [_post(port, "/echo2", {"a": 1}),
                _post(port, "/echo2/sub/path", {"b": [1, 2]}),
                _post(port, "/nope")]

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out
    assert port_out[0] == (200, {"got": {"a": 1}})
    assert port_out[1] == (200, {"got": {"b": [1, 2]}})
    assert port_out[2][0] == 404


def test_proxy_streaming_chunks_match_jax():
    def scenario(rt, serve):
        @serve.deployment(name="streamer",
                          ray_actor_options={"num_cpus": 0.1})
        class Streamer:
            def __call__(self):
                return serve.StreamingResponse(
                    [f"chunk-{i}\n" for i in range(5)] + [b"", b"end"])

        handle = serve.run(Streamer.bind(), http_host="127.0.0.1")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{handle.http_port}/streamer",
                timeout=TIMEOUT) as r:
            return (r.headers.get("Transfer-Encoding"),
                    r.headers.get("Content-Type"), r.read().decode())

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (
        "chunked", "text/plain",
        "".join(f"chunk-{i}\n" for i in range(5)) + "end")


def test_proxy_overlaps_concurrent_slow_calls():
    """A slow deployment must not serialize the proxy: 4 concurrent
    requests on 4 replicas finish in about one call's time."""
    def scenario(rt, serve):
        @serve.deployment(name="slowpoke", num_replicas=4,
                          ray_actor_options={"num_cpus": 0.1})
        class Slow:
            def __call__(self):
                time.sleep(0.8)
                return "ok"

        handle = serve.run(Slow.bind(), http_host="127.0.0.1")
        port = handle.http_port
        _post(port, "/slowpoke")   # warm-up
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            out = list(pool.map(lambda _: _post(port, "/slowpoke"),
                                range(4)))
        return out, time.perf_counter() - t0

    (jax_out, jax_dt), (port_out, port_dt) = _on_both(scenario)
    assert jax_out == port_out == [(200, "ok")] * 4
    # Serial execution would take >= 3.2 s.
    assert jax_dt < 3.0 and port_dt < 3.0, (jax_dt, port_dt)


# ---------------------------------------------------------------------------
# tests/test_serve_lm.py: the LM over HTTP, JAX weights in both servers
# ---------------------------------------------------------------------------

LM = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          max_seq=96, attn_impl="reference")
NEW_TOKENS = 8


def _jax_lm_server(serve):
    @serve.deployment(num_replicas=1, route_prefix="/generate")
    class LMServer:
        def __init__(self, weights):
            from functools import partial

            import jax
            import jax.numpy as jnp

            from ray_tpu.models import TransformerConfig, generate
            cfg = TransformerConfig(dtype=jnp.float32, **LM)
            self.jnp = jnp
            self.params = jax.tree.map(jnp.asarray, weights)
            self._gen = jax.jit(partial(
                generate, cfg=cfg, max_new_tokens=NEW_TOKENS,
                temperature=0.0))
            self.batches = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=1.0)
        def generate_batch(self, prompts):
            width = max(len(p) for p in prompts)
            arr = np.zeros((len(prompts), width), np.int32)
            for i, p in enumerate(prompts):
                arr[i, width - len(p):] = p
            self.batches.append(arr.tolist())
            out = np.asarray(self._gen(self.params, self.jnp.asarray(arr)))
            return [row.tolist() for row in out]

        def __call__(self, prompt=None):
            return {"tokens": self.generate_batch(prompt)}

        def recorded(self):
            return self.batches

    return LMServer


def _port_lm_server(serve):
    @serve.deployment(num_replicas=1, route_prefix="/generate")
    class LMServer:
        def __init__(self, weights):
            import torch

            from ray_tpu_torch.models import (TransformerConfig, generate,
                                              params_from_jax)
            self.torch = torch
            self.cfg = TransformerConfig(dtype=torch.float32, **LM)
            self.params = params_from_jax(weights, self.cfg, device="cpu")
            self.generate = generate
            self.batches = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=1.0)
        def generate_batch(self, prompts):
            width = max(len(p) for p in prompts)
            arr = np.zeros((len(prompts), width), np.int64)
            for i, p in enumerate(prompts):
                arr[i, width - len(p):] = p
            self.batches.append(arr.tolist())
            out = self.generate(self.params, self.torch.from_numpy(arr),
                                self.cfg, max_new_tokens=NEW_TOKENS,
                                device="cpu")
            return [row.tolist() for row in out]

        def __call__(self, prompt=None):
            return {"tokens": self.generate_batch(prompt)}

        def recorded(self):
            return self.batches

    return LMServer


def test_lm_over_http_matches_jax_greedy_tokens():
    import jax

    from ray_tpu.models import TransformerConfig, transformer_init
    jcfg = TransformerConfig(dtype=jax.numpy.float32, **LM)
    weights = jax.tree.map(np.array, transformer_init(
        jax.random.PRNGKey(0), jcfg))
    prompts = np.random.default_rng(7).integers(
        1, LM["vocab_size"], (4, 6)).tolist()

    def scenario(rt, serve):
        server = (_jax_lm_server if serve is jserve else _port_lm_server)(
            serve)
        handle = serve.run(server.bind(weights), http_host="127.0.0.1")
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            answers = list(pool.map(
                lambda p: _post(handle.http_port, "/generate",
                                {"prompt": p}), prompts))
        direct = rt.get(handle.options(method_name="generate_batch")
                        .remote(prompts[0]), timeout=TIMEOUT)
        batches = rt.get(handle.options("recorded").remote(),
                         timeout=TIMEOUT)
        return answers, direct, batches

    jax_out, port_out = _on_both(scenario)
    (jax_answers, jax_direct, jax_batches) = jax_out
    (port_answers, port_direct, port_batches) = port_out
    assert [c for c, _ in port_answers] == [200] * 4
    assert port_answers == jax_answers
    assert all(len(body["tokens"]) == NEW_TOKENS
               and all(0 <= t < LM["vocab_size"] for t in body["tokens"])
               for _, body in port_answers)
    # the handle path gives the HTTP path's tokens for the same prompt
    assert port_direct == jax_direct == port_answers[0][1]["tokens"]
    # every prompt went through a batch of the server, the last alone
    for batches in (jax_batches, port_batches):
        assert sorted(map(tuple, sum(batches[:-1], []))) == \
            sorted(map(tuple, prompts))
        assert batches[-1] == [prompts[0]]


# ---------------------------------------------------------------------------
# What only the port has
# ---------------------------------------------------------------------------

def test_serve_refs_mix_with_plain_refs_in_get_and_wait():
    with _stack("port") as (rt, serve):
        @serve.deployment
        def double(x):
            return 2 * x

        handle = serve.run(double.bind())
        refs = [handle.remote(i) for i in range(3)]
        assert all(isinstance(r, serve.ServeCallRef) for r in refs)
        plain = rt.put("plain")
        assert rt.get([refs[0], plain, refs[2]], timeout=TIMEOUT) == \
            [0, "plain", 4]
        ready, rest = rt.wait(refs + [plain], num_returns=4,
                              timeout=TIMEOUT)
        assert ready == refs + [plain] and rest == []
        with pytest.raises(TypeError, match="serialized"):
            refs[1].__reduce__()


def test_compiled_handle_on_the_in_process_runtime_matches_jax():
    """``serve.run(..., compile=True)`` on each package's in-process
    runtime: nothing compiles there (a compiled graph needs an actor's
    worker process), so the handle keeps ``_compile`` and answers every
    call on the task path, a bad call raising at its own get()."""
    def scenario(rt, serve):
        @serve.deployment(num_replicas=1)
        class Doubler:
            def __call__(self, x):
                return x * 2

        handle = serve.run(Doubler.bind(), compile=True)
        compiled = handle._compile
        outs = [rt.get(handle.remote(i), timeout=TIMEOUT) for i in range(4)]
        bad = handle.remote(1, 2, 3)
        try:
            rt.get(bad, timeout=TIMEOUT)
            raised = None
        except Exception as e:  # noqa: BLE001 - both stacks' TaskError
            raised = type(e.cause).__name__
        after = rt.get(handle.remote(7), timeout=TIMEOUT)
        graphs = len(handle._cgraphs)
        handle.teardown_compiled()
        return (compiled, outs, raised, after, graphs, handle._compile,
                rt.get(handle.remote(8), timeout=TIMEOUT))

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out == (True, [0, 2, 4, 6], "TypeError", 14, 0,
                                   False, 16)


def test_user_errors_are_not_retried_and_answer_500():
    with _stack("port") as (rt, serve):
        calls = []

        @serve.deployment(num_replicas=2)
        def boom(x=0):
            calls.append(x)
            raise ValueError("bad input")

        handle = serve.run(boom.bind(), http_host="127.0.0.1")
        with pytest.raises(ray_tpu_torch.TaskError) as ei:
            rt.get(handle.remote(1), timeout=TIMEOUT)
        assert isinstance(ei.value.cause, ValueError)
        code, body = _post(handle.http_port, "/boom", {"x": 2})
        assert code == 500 and "bad input" in body["error"]
        assert calls == [1, 2]   # one run each: user code is not retried


def test_shutdown_joins_every_serve_thread_and_kills_every_replica():
    from ray_tpu_torch.core import api as core_api
    from ray_tpu_torch.serve.controller import Replica
    with _stack("port") as (rt, serve):
        before = set(threading.enumerate())

        @serve.deployment(num_replicas=2)
        class Batched:
            @serve.batch(max_batch_size=2, batch_wait_timeout_s=0.05)
            def handle(self, items):
                return [i + 1 for i in items]

            def __call__(self, x):
                return self.handle(x)

        handle = serve.run(Batched.bind(), http_host="127.0.0.1")
        assert _post(handle.http_port, "/Batched", 1) == (200, 2)
        assert rt.get([handle.remote(i) for i in range(4)],
                      timeout=TIMEOUT) == [1, 2, 3, 4]
        assert [p for p in tproxy._live_proxies if not p.closed]
        serve.shutdown()
        assert not [p for p in tproxy._live_proxies if not p.closed]
        replicas = [st for st in core_api._runtime._actors.values()
                    if isinstance(st.instance, Replica)]
        assert len(replicas) == 2 and all(st.dead for st in replicas)
        # only the runtime's own threads (joined by its shutdown) may
        # remain; a batch timer is a daemon that ends with its window
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            left = [t for t in set(threading.enumerate()) - before
                    if t.is_alive() and not t.name.startswith("rt-torch")]
            if not left:
                break
            time.sleep(0.05)
        assert not left, [t.name for t in left]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("rt-torch")]


def test_named_locks_order_like_jax():
    """Both stacks with their lock-order sanitizer armed (util/lockcheck.py,
    as the conftest arms the JAX one for its serve tests): the same
    scenario takes the same named serve locks in the same order (the
    edges between ``serve.*`` locks), and neither finds a cycle."""
    from ray_tpu import config as jconfig
    from ray_tpu.util import lockcheck as jlock
    from ray_tpu_torch import config as tconfig
    from ray_tpu_torch.util import lockcheck as tlock

    def scenario(rt, serve):
        cfg, lock = ((jconfig, jlock) if rt is ray_tpu
                     else (tconfig, tlock))
        lock.reset()
        cfg.set_override("lockcheck_enabled", True)
        try:
            @serve.deployment(num_replicas=2)
            def echo(x=None):
                return x

            handle = serve.run(echo.bind())
            outs = [rt.get(handle.remote(i), timeout=TIMEOUT)
                    for i in range(4)]
            serve.delete("echo")
        finally:
            cfg.clear_override("lockcheck_enabled")
        edges = {(a, b) for a, bs in lock.edges().items() for b in bs
                 if a.startswith("serve.") and b.startswith("serve.")}
        cycles = lock.cycles()
        lock.reset()
        return outs, sorted(edges), cycles

    jax_out, port_out = _on_both(scenario)
    assert jax_out == port_out
    assert jax_out[0] == [0, 1, 2, 3] and jax_out[2] == []
    assert ("serve.reconcile", "serve.controller") in port_out[1]
