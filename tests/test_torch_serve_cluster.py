"""The port's serve on its cluster runtime, held to the JAX serve on a JAX
``Cluster``.

Counterparts of every test of ``tests/test_serve.py``,
``tests/test_serve_dag_proxy.py`` and ``tests/test_serve_lm.py``: each
scenario runs once on a JAX ``Cluster`` with ``ray_tpu.serve`` and once on
a port ``Cluster`` with ``ray_tpu_torch.serve``, on the same inputs, and
the test compares what came back: values, HTTP codes and bodies, batch
sizes, and how many replicas were hit. The controller, the HTTP proxy and
every replica are worker processes on both sides.

- The JAX scenarios are the JAX tests' own bodies (deployments defined
  inside them, cloudpickled). They run once per test run on one JAX
  cluster (``_once``: the xdist workers share one pickle of the results),
  before this module's port cluster starts in that process, with
  ``serve.shutdown()`` after each.
- The port pickles classes by import path, so every port deployment is a
  module-level ``@serve.deployment``. Worker processes import this module
  by name, so it imports no JAX at the top; the JAX workers get its
  functions by value (cloudpickle's pickle-by-value, registered for the
  JAX run only).
- The LM is a small f32 model whose JAX weights reach both servers as an
  init arg; the port's replica loads them through ``params_from_jax`` with
  ``device="cpu"``, and both give the same greedy tokens.

Then what only the port has to show here: ``ClusterRuntime.on_resolved``
(success, a task error, a killed actor, a resolved ref), the replicas'
``rt_serve_replica_ongoing`` gauge driving the controller's autoscaler
through the conductor's metrics KV, and serve's ring events in the
processes that emit them. After each test ``serve.shutdown()`` runs and
no compiled graph or channel segment of this module's cluster is left.
"""

import fcntl
import json
import os
import pickle
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.dag import channel, compiled

TIMEOUT = 60
LM = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
          max_seq=96, attn_impl="reference")
NEW_TOKENS = 8


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


def _recover(rt_, handle, want):
    """Call until the handle answers ``want`` again (45 s at most)."""
    deadline = time.time() + 45
    while time.time() < deadline:
        try:
            handle._ts = 0  # force refresh
            if rt_.get(handle.remote(), timeout=15) == want:
                return True
        except Exception:
            time.sleep(0.5)
    return False


# ---------------------------------------------------------------------------
# the port's deployments (module level: they ship by import path)
# ---------------------------------------------------------------------------

@serve.deployment
def echo(x=None):
    return {"echo": x}


@serve.deployment(num_replicas=1)
class Model:
    def __init__(self, scale):
        self.scale = scale

    def __call__(self, x):
        return x * self.scale

    def describe(self):
        return {"scale": self.scale}


@serve.deployment(num_replicas=2)
class PidServer:
    def __call__(self):
        return os.getpid()


@serve.deployment(route_prefix="/sum")
def summer(a=0, b=0):
    return {"sum": a + b}


@serve.deployment(max_concurrent_queries=16)
class Batched:
    def __init__(self):
        self.batch_sizes = []

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
    def handle(self, items):
        self.batch_sizes.append(len(items))
        return [i * 2 for i in items]

    def __call__(self, x):
        return self.handle(x)

    def sizes(self):
        return self.batch_sizes


@serve.deployment(num_replicas=1)
class Fragile:
    def __call__(self):
        return "alive"

    def die(self):
        os._exit(1)


@serve.deployment(num_replicas=1)
class Doubler:
    def __call__(self, x):
        return x * 2


@serve.deployment(name="Doubler", ray_actor_options={"num_cpus": 0.1})
class GraphDoubler:
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
        d = rt.get(self.doubler.remote(x))
        return rt.get(self.adder.remote(d))


@serve.deployment(name="echo2", ray_actor_options={"num_cpus": 0.1})
class Echo:
    def __call__(self, **kwargs):
        return {"got": kwargs}


@serve.deployment(name="streamer", ray_actor_options={"num_cpus": 0.1})
class Streamer:
    def __call__(self):
        return serve.StreamingResponse([f"chunk-{i}\n" for i in range(5)])


@serve.deployment(name="slowpoke", num_replicas=4,
                  ray_actor_options={"num_cpus": 0.1})
class Slow:
    def __call__(self):
        time.sleep(0.8)
        return "ok"


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

    @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
    def generate_batch(self, prompts):
        width = max(len(p) for p in prompts)
        arr = np.zeros((len(prompts), width), np.int64)
        for i, p in enumerate(prompts):
            arr[i, width - len(p):] = p
        out = self.generate(self.params, self.torch.from_numpy(arr),
                            self.cfg, max_new_tokens=NEW_TOKENS,
                            temperature=0.0, device="cpu")
        return [row.tolist() for row in out]

    def __call__(self, prompt=None):
        return {"tokens": self.generate_batch(prompt)}


@serve.deployment(num_replicas=1, autoscaling_config={
    "min_replicas": 1, "max_replicas": 3, "target_num_ongoing_requests": 1})
class Scaled:
    def __call__(self, x, hold=0.0):
        time.sleep(hold)
        return x


@serve.deployment(num_replicas=2, route_prefix="/flush",
                  max_concurrent_queries=16)
class Flusher:
    @serve.batch(max_batch_size=2, batch_wait_timeout_s=0.05,
                 target_p99_ms=1000.0)
    def handle(self, items):
        return [i + 1 for i in items]

    def __call__(self, x=0):
        return self.handle(x)

    def pid(self):
        return os.getpid()

    def hold(self, s):
        time.sleep(s)
        return s


class Probe:
    """A plain actor for ``on_resolved``."""

    def ok(self, x):
        return x

    def fail(self):
        raise ValueError("probe failure")

    def nap(self, s):
        time.sleep(s)
        return s


# ---------------------------------------------------------------------------
# the JAX scenarios (the JAX tests' bodies; each returns plain values)
# ---------------------------------------------------------------------------

def jax_function_deployment(rt_, serve_):
    @serve_.deployment
    def echo(x=None):
        return {"echo": x}

    handle = serve_.run(echo.bind())
    out = rt_.get(handle.remote(41), timeout=TIMEOUT)
    status = sorted(serve_.status())
    serve_.delete("echo")
    return out, status


def jax_class_with_state(rt_, serve_):
    @serve_.deployment(num_replicas=1)
    class Model:
        def __init__(self, scale):
            self.scale = scale

        def __call__(self, x):
            return x * self.scale

        def describe(self):
            return {"scale": self.scale}

    handle = serve_.run(Model.bind(3))
    h2 = handle.options(method_name="describe")
    return (rt_.get(handle.remote(5), timeout=TIMEOUT),
            rt_.get(h2.remote(), timeout=TIMEOUT))


def jax_multi_replica(rt_, serve_):
    @serve_.deployment(num_replicas=2)
    class PidServer:
        def __call__(self):
            import os
            return os.getpid()

    handle = serve_.run(PidServer.bind())
    pids = {rt_.get(handle.remote(), timeout=TIMEOUT) for _ in range(12)}
    return len(pids), serve_.status()["PidServer"]["num_replicas_running"]


def jax_http_ingress(rt_, serve_):
    @serve_.deployment(route_prefix="/sum")
    def summer(a=0, b=0):
        return {"sum": a + b}

    handle = serve_.run(summer.bind(), http_host="127.0.0.1")
    return (_post(handle.http_port, "/sum", {"a": 2, "b": 40}),
            _post(handle.http_port, "/nope"))


def jax_batching(rt_, serve_):
    @serve_.deployment(max_concurrent_queries=16)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve_.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
        def handle(self, items):
            self.batch_sizes.append(len(items))
            return [i * 2 for i in items]

        def __call__(self, x):
            return self.handle(x)

        def sizes(self):
            return self.batch_sizes

    handle = serve_.run(Batched.bind())
    outs = rt_.get([handle.remote(i) for i in range(8)], timeout=TIMEOUT)
    sizes = rt_.get(handle.options("sizes").remote(), timeout=TIMEOUT)
    return sorted(outs), sum(sizes), max(sizes) >= 2


def jax_replica_recovery(rt_, serve_):
    @serve_.deployment(num_replicas=1)
    class Fragile:
        def __call__(self):
            return "alive"

        def die(self):
            import os
            os._exit(1)

    handle = serve_.run(Fragile.bind())
    first = rt_.get(handle.remote(), timeout=TIMEOUT)
    try:
        rt_.get(handle.options("die").remote(), timeout=30)
        died = False
    except Exception:
        died = True
    return first, died, _recover(rt_, handle, "alive")


def jax_compiled_handle(rt_, serve_):
    @serve_.deployment(num_replicas=1)
    class Doubler:
        def __call__(self, x):
            return x * 2

    handle = serve_.run(Doubler.bind(), compile=True)
    return _compiled_scenario(rt_, handle)


def _compiled_scenario(rt_, handle):
    """``test_serve.py::test_compiled_handle`` as written, recording what
    it asserts."""
    out = [handle._compile, rt_.get(handle.remote(21), timeout=TIMEOUT),
           bool(handle._cgraphs)]
    out.append([rt_.get(handle.remote(i), timeout=TIMEOUT)
                for i in range(5)])
    refs = [handle.remote(i) for i in range(4)]
    out.append([rt_.get(r, timeout=TIMEOUT) for r in refs])
    bad = handle.remote(1, 2, 3)
    try:
        rt_.get(bad, timeout=TIMEOUT)
        out.append(None)
    except Exception as e:  # noqa: BLE001 - recorded, compared
        out.append(type(getattr(e, "cause", e)).__name__)
    out.append(rt_.get(handle.remote(7), timeout=TIMEOUT))
    handle.teardown_compiled()
    out.append(bool(handle._cgraphs))
    out.append(rt_.get(handle.remote(8), timeout=TIMEOUT))
    return out


def jax_deployment_graph(rt_, serve_):
    @serve_.deployment(ray_actor_options={"num_cpus": 0.1})
    class Doubler:
        def __call__(self, x):
            return x * 2

    @serve_.deployment(ray_actor_options={"num_cpus": 0.1})
    class Adder:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, x):
            return x + self.offset

    @serve_.deployment(ray_actor_options={"num_cpus": 0.1})
    class Ensemble:
        def __init__(self, doubler, adder):
            self.doubler = doubler
            self.adder = adder

        def __call__(self, x):
            import ray_tpu
            d = ray_tpu.get(self.doubler.remote(x))
            return ray_tpu.get(self.adder.remote(d))

    handle = serve_.run(Ensemble.bind(Doubler.bind(), Adder.bind(10)))
    return rt_.get(handle.remote(7), timeout=120), sorted(serve_.status())


def jax_proxy_json(rt_, serve_):
    @serve_.deployment(name="echo2", ray_actor_options={"num_cpus": 0.1})
    class Echo:
        def __call__(self, **kwargs):
            return {"got": kwargs}

    handle = serve_.run(Echo.bind(), http_host="127.0.0.1")
    return (_post(handle.http_port, "/echo2", {"a": 1}),
            _post(handle.http_port, "/nope"))


def _stream(port):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/streamer", timeout=TIMEOUT) as r:
        return r.headers.get("Transfer-Encoding"), r.read().decode()


def jax_streaming(rt_, serve_):
    @serve_.deployment(name="streamer", ray_actor_options={"num_cpus": 0.1})
    class Streamer:
        def __call__(self):
            return serve_.StreamingResponse(
                [f"chunk-{i}\n" for i in range(5)])

    handle = serve_.run(Streamer.bind(), http_host="127.0.0.1")
    return _stream(handle.http_port)


def _four_slow_calls(port):
    """(answers, seconds) of 4 concurrent calls after a warm one."""
    import concurrent.futures
    url = f"http://127.0.0.1:{port}/slowpoke"

    def hit():
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            return json.loads(r.read())

    hit()  # warm-up: replica cold-start must not count against the window
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        out = list(pool.map(lambda _: hit(), range(4)))
    return out, time.perf_counter() - t0


def jax_concurrent_slow(rt_, serve_):
    @serve_.deployment(name="slowpoke", num_replicas=4,
                       ray_actor_options={"num_cpus": 0.1})
    class Slow:
        def __call__(self):
            time.sleep(0.8)
            return "ok"

    handle = serve_.run(Slow.bind(), http_host="127.0.0.1")
    out, dt = _four_slow_calls(handle.http_port)
    return out, dt < 3.0


def _lm_weights():
    import jax

    from ray_tpu.models import TransformerConfig, transformer_init
    jcfg = TransformerConfig(dtype=jax.numpy.float32, **LM)
    return jax.tree.map(np.array, transformer_init(jax.random.PRNGKey(0),
                                                   jcfg))


def _lm_scenario(rt_, handle):
    """``test_serve_lm.py``'s calls: the handle path, the HTTP path, and
    the handle again on the HTTP prompt."""
    gen = handle.options(method_name="generate_batch")
    out = rt_.get(gen.remote([1, 2, 3]), timeout=120)
    code, body = _post(handle.http_port, "/generate", {"prompt": [5, 6, 7, 8]})
    again = rt_.get(gen.remote([5, 6, 7, 8]), timeout=120)
    return out, code, body["tokens"], again


def jax_lm(rt_, serve_):
    weights = _lm_weights()

    @serve_.deployment(num_replicas=1, route_prefix="/generate")
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

        @serve_.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def generate_batch(self, prompts):
            width = max(len(p) for p in prompts)
            arr = np.zeros((len(prompts), width), np.int32)
            for i, p in enumerate(prompts):
                arr[i, width - len(p):] = p
            out = np.asarray(self._gen(self.params, self.jnp.asarray(arr)))
            return [row.tolist() for row in out]

        def __call__(self, prompt=None):
            return {"tokens": self.generate_batch(prompt)}

    handle = serve_.run(LMServer.bind(weights), http_host="127.0.0.1")
    return _lm_scenario(rt_, handle)


JAX_SCENARIOS = {f.__name__[4:]: f for f in (
    jax_function_deployment, jax_class_with_state, jax_multi_replica,
    jax_http_ingress, jax_batching, jax_replica_recovery,
    jax_compiled_handle, jax_deployment_graph, jax_proxy_json,
    jax_streaming, jax_concurrent_slow, jax_lm)}


def _jax_run():
    import sys

    import cloudpickle

    import ray_tpu
    from ray_tpu import serve as jserve
    from ray_tpu.cluster.cluster_utils import Cluster as JaxCluster
    from ray_tpu.core import api
    from ray_tpu.core.runtime_cluster import ClusterRuntime
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    c = JaxCluster(initialize_head=True, head_node_args={"num_cpus": 8})
    out = {}
    try:
        api._runtime = ClusterRuntime(address=c.address)
        try:
            for name, scenario in JAX_SCENARIOS.items():
                try:
                    out[name] = ("value", scenario(ray_tpu, jserve))
                except Exception as e:  # noqa: BLE001 - compared
                    out[name] = ("raised", type(e).__name__, str(e)[:300])
                finally:
                    jserve.shutdown()
        finally:
            api._runtime.shutdown()
            api._runtime = None
    finally:
        c.shutdown()
        cloudpickle.unregister_pickle_by_value(module)
    return out


def _once(tmp_path_factory, name, compute):
    """``compute()`` once for the whole run, its result shared by the xdist
    workers through a pickle under the run's temporary root (a file lock
    lets one compute while the others wait)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            result = compute()
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

_CLUSTER = []


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return _once(tmp_path_factory, "torch_serve_cluster_jax", _jax_run)


@pytest.fixture(scope="module")
def cluster(jax_runs):
    rt.shutdown()    # whatever runtime an earlier module left in this worker
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 8})
    rt.init(address=c.address)
    _CLUSTER.append(c)
    yield c
    _CLUSTER.remove(c)
    try:
        serve.shutdown()
    finally:
        rt.shutdown()
        c.shutdown()


@pytest.fixture(autouse=True)
def _serve_hygiene():
    """serve.shutdown() after each test; then no live compiled graph of
    the port and no channel segment of this module's cluster."""
    yield
    if _CLUSTER:
        serve.shutdown()
    assert not compiled._live_graphs, (
        f"test leaked live compiled graphs: {compiled._live_graphs}")
    prefixes = [n.store_prefix for c in _CLUSTER for n in c.nodes]
    deadline = time.monotonic() + 2.0
    leaked = channel.leaked_segments(prefixes)
    while leaked and time.monotonic() < deadline:
        time.sleep(0.05)
        leaked = channel.leaked_segments(prefixes)
    assert not leaked, f"test leaked channel shm segments: {leaked}"


def _want(jax_runs, name):
    got = jax_runs[name]
    assert got[0] == "value", f"the JAX cluster raised: {got}"
    return got[1]


# ---------------------------------------------------------------------------
# tests/test_serve.py
# ---------------------------------------------------------------------------

def test_function_deployment_on_the_cluster(cluster, jax_runs):
    handle = serve.run(echo.bind())
    got = (rt.get(handle.remote(41), timeout=TIMEOUT), sorted(serve.status()))
    serve.delete("echo")
    assert got == _want(jax_runs, "function_deployment") == (
        {"echo": 41}, ["echo"])


def test_class_deployment_with_state_on_the_cluster(cluster, jax_runs):
    handle = serve.run(Model.bind(3))
    h2 = handle.options(method_name="describe")
    got = (rt.get(handle.remote(5), timeout=TIMEOUT),
           rt.get(h2.remote(), timeout=TIMEOUT))
    assert got == _want(jax_runs, "class_with_state") == (15, {"scale": 3})


def test_multi_replica_routing_on_the_cluster(cluster, jax_runs):
    handle = serve.run(PidServer.bind())
    pids = {rt.get(handle.remote(), timeout=TIMEOUT) for _ in range(12)}
    got = (len(pids), serve.status()["PidServer"]["num_replicas_running"])
    assert got == _want(jax_runs, "multi_replica") == (2, 2)
    assert os.getpid() not in pids   # replicas are worker processes


def test_http_ingress_on_the_cluster(cluster, jax_runs):
    handle = serve.run(summer.bind(), http_host="127.0.0.1")
    got = (_post(handle.http_port, "/sum", {"a": 2, "b": 40}),
           _post(handle.http_port, "/nope"))
    assert got == _want(jax_runs, "http_ingress") == (
        (200, {"sum": 42}), (404, {"error": "no matching route"}))


def test_batching_on_the_cluster(cluster, jax_runs):
    handle = serve.run(Batched.bind())
    outs = rt.get([handle.remote(i) for i in range(8)], timeout=TIMEOUT)
    sizes = rt.get(handle.options("sizes").remote(), timeout=TIMEOUT)
    got = (sorted(outs), sum(sizes), max(sizes) >= 2)
    assert got == _want(jax_runs, "batching") == (
        [0, 2, 4, 6, 8, 10, 12, 14], 8, True)


def test_replica_recovery_after_os_exit_on_the_cluster(cluster, jax_runs):
    handle = serve.run(Fragile.bind())
    first = rt.get(handle.remote(), timeout=TIMEOUT)
    handle._refresh(force=True)
    victim = handle._replicas[0]._rt_actor_id
    try:
        rt.get(handle.options("die").remote(), timeout=30)
        died = False
    except Exception:
        died = True
    got = (first, died, _recover(rt, handle, "alive"))
    assert got == _want(jax_runs, "replica_recovery") == ("alive", True, True)
    handle._refresh(force=True)
    assert [r._rt_actor_id != victim for r in handle._replicas] == [True]


def test_compiled_handle_on_the_cluster(cluster, jax_runs):
    handle = serve.run(Doubler.bind(), compile=True)
    got = _compiled_scenario(rt, handle)
    # compiled, then the poisoned graph gives way to the task path, and
    # teardown restores classic service
    assert got == _want(jax_runs, "compiled_handle") == [
        True, 42, True, [0, 2, 4, 6, 8], [0, 2, 4, 6], "TypeError", 14,
        False, 16]


# ---------------------------------------------------------------------------
# tests/test_serve_dag_proxy.py
# ---------------------------------------------------------------------------

def test_deployment_graph_on_the_cluster(cluster, jax_runs):
    handle = serve.run(Ensemble.bind(GraphDoubler.bind(), Adder.bind(10)))
    got = (rt.get(handle.remote(7), timeout=120), sorted(serve.status()))
    assert got == _want(jax_runs, "deployment_graph") == (
        24, ["Adder", "Doubler", "Ensemble"])


def test_proxy_json_and_keepalive_on_the_cluster(cluster, jax_runs):
    handle = serve.run(Echo.bind(), http_host="127.0.0.1")
    got = (_post(handle.http_port, "/echo2", {"a": 1}),
           _post(handle.http_port, "/nope"))
    assert got == _want(jax_runs, "proxy_json") == (
        (200, {"got": {"a": 1}}), (404, {"error": "no matching route"}))


def test_proxy_streaming_chunks_on_the_cluster(cluster, jax_runs):
    handle = serve.run(Streamer.bind(), http_host="127.0.0.1")
    got = _stream(handle.http_port)
    assert got == _want(jax_runs, "streaming") == (
        "chunked", "".join(f"chunk-{i}\n" for i in range(5)))


def test_proxy_concurrent_slow_calls_on_the_cluster(cluster, jax_runs):
    handle = serve.run(Slow.bind(), http_host="127.0.0.1")
    out, dt = _four_slow_calls(handle.http_port)
    # Serial execution would take >=3.2s; anything clearly under that
    # proves the proxy overlaps slow calls.
    assert (out, dt < 3.0) == _want(jax_runs, "concurrent_slow") == (
        ["ok"] * 4, True), f"{dt:.2f} s"


# ---------------------------------------------------------------------------
# tests/test_serve_lm.py
# ---------------------------------------------------------------------------

def test_lm_greedy_tokens_on_the_cluster_match_jax(cluster, jax_runs):
    handle = serve.run(LMServer.bind(_lm_weights()), http_host="127.0.0.1")
    out, code, body, again = _lm_scenario(rt, handle)
    assert code == 200
    assert len(out) == NEW_TOKENS and all(0 <= t < 256 for t in out)
    assert again == body   # greedy: the same tokens by both paths
    assert (out, code, body, again) == _want(jax_runs, "lm")


# ---------------------------------------------------------------------------
# what only the port has to show
# ---------------------------------------------------------------------------

def _on_resolved(ref):
    fired = threading.Event()
    core_api._global_runtime().on_resolved(ref, fired.set)
    return fired


@pytest.mark.parametrize("outcome", ["value", "task_error", "killed_actor",
                                     "already_resolved"])
def test_on_resolved_fires_on_every_outcome(cluster, outcome):
    """``ClusterRuntime.on_resolved`` calls back once the actor call has
    finished, whatever the outcome, and at once for a resolved ref."""
    actor = rt.remote(Probe).remote()
    try:
        if outcome == "value":
            ref = actor.ok.remote(3)
            fired = _on_resolved(ref)
            assert fired.wait(TIMEOUT) and rt.get(ref, timeout=TIMEOUT) == 3
        elif outcome == "task_error":
            ref = actor.fail.remote()
            fired = _on_resolved(ref)
            assert fired.wait(TIMEOUT)
            with pytest.raises(rt.TaskError, match="probe failure"):
                rt.get(ref, timeout=TIMEOUT)
        elif outcome == "killed_actor":
            rt.get(actor.ok.remote(0), timeout=TIMEOUT)
            ref = actor.nap.remote(30)
            fired = _on_resolved(ref)
            time.sleep(0.3)
            assert not fired.is_set()
            rt.kill(actor)
            assert fired.wait(TIMEOUT)
            with pytest.raises(rt.TaskError):
                rt.get(ref, timeout=TIMEOUT)
        else:
            ref = actor.ok.remote(5)
            assert rt.get(ref, timeout=TIMEOUT) == 5
            fired = _on_resolved(ref)
            assert fired.is_set()   # before on_resolved returned
    finally:
        rt.kill(actor)
    assert not core_api._global_runtime()._resolved_cbs


def _ongoing_gauges(name):
    """Sum of the ``rt_serve_replica_ongoing`` points of ``name`` in the
    conductor's metrics KV, and how many processes shipped one."""
    conductor = core_api._global_runtime().conductor
    total, procs = 0.0, 0
    for key in conductor.call("kv_keys", ns="metrics"):
        blob = conductor.call("kv_get", ns="metrics", key=key)
        entry = pickle.loads(blob).get("rt_serve_replica_ongoing") \
            if blob else None
        points = [v for tags, v in (entry or {}).get("points", [])
                  if dict(tags).get("deployment") == name]
        if points:
            total += sum(points)
            procs += 1
    return total, procs


def test_replica_gauge_drives_the_autoscaler_from_the_metrics_kv(cluster):
    """Three calls held in one replica: its gauge reaches the conductor's
    metrics KV, the controller's KV read sums it, and the autoscaler moves
    the target to 3 replicas (one call each)."""
    from ray_tpu_torch import config
    from ray_tpu_torch.serve.controller import ServeController
    config.set_override("metrics_export_period_s", 0.2)
    try:
        handle = serve.run(Scaled.bind())
        assert rt.get(handle.remote(5), timeout=TIMEOUT) == 5
        refs = [handle.remote(i, hold=4.0) for i in range(3)]
        deadline = time.time() + 10
        while _ongoing_gauges("Scaled")[0] < 3 and time.time() < deadline:
            time.sleep(0.05)
        total, procs = _ongoing_gauges("Scaled")
        reader = ServeController.__new__(ServeController)
        reader._conductor = core_api._global_runtime().conductor
        kv_total = reader._metrics_ongoing("Scaled")
        target = 1
        while target != 3 and time.time() < deadline:
            time.sleep(0.1)
            target = serve.status()["Scaled"]["num_replicas_target"]
        assert (total, procs, kv_total, target) == (3.0, 1, 3.0, 3)
        assert rt.get(refs, timeout=TIMEOUT) == [0, 1, 2]
    finally:
        config.clear_override("metrics_export_period_s")


def test_ring_events_of_serve_reach_the_processes_that_emit_them(
        cluster):
    """Each serve event kind in the ring of the process that emits it: the
    proxy's requests and sheds, the controller's drain and the replicas'
    batch flushes in the conductor's event store (from processes that are
    not the driver), the handle's retry and timeout in the driver's own
    ring. The replicas are every one the controller started, the
    replacement of the killed one too."""
    from ray_tpu_torch import config
    from ray_tpu_torch.util import events
    conductor = core_api._global_runtime().conductor
    t_start = time.time()   # the module's earlier proxies emitted too
    handle = serve.run(Flusher.bind(), http_host="127.0.0.1")
    assert _post(handle.http_port, "/flush", 1) == (200, 2)
    handle._refresh(force=True)
    replica_pids = {rt.get(r.handle_request.remote("pid", ((), {})),
                           timeout=TIMEOUT) for r in handle._replicas}
    # a shed: no queue budget at the proxy
    controller = serve.api._get_controller(create=False)
    rt.get(controller.http_reconfigure.remote(
        {"serve_max_queued_requests": 0}), timeout=TIMEOUT)
    assert _post(handle.http_port, "/flush", 1)[0] == 503
    rt.get(controller.http_reconfigure.remote(
        {"serve_max_queued_requests": None}), timeout=TIMEOUT)
    # a timeout in the driver: the replica holds the call past its get
    held = handle.options("hold").remote(1.0)
    with pytest.raises(rt.GetTimeoutError):
        rt.get(held, timeout=0.2)
    # retries in the driver: calls routed to a killed replica that the
    # handle's routing view still lists. The view is taken just before the
    # kill, and the calls go out on it: certifying the death can take
    # longer than the second a view counts as fresh, and a view fetched
    # after the controller's next reconcile (every 2 s) no longer lists the
    # victim, so no call would be retried.
    handle._refresh(force=True)
    victim = handle._replicas[0]
    rt.kill(victim)
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            rt.get(victim.check_health.remote(), timeout=5)
            time.sleep(0.05)
        except Exception:
            break
    handle._ts = time.monotonic()   # the pre-kill view counts as fresh
    assert victim._rt_actor_id in {r._rt_actor_id for r in handle._replicas}
    refs = [handle.remote(i) for i in range(12)]
    assert rt.get(refs, timeout=TIMEOUT) == [i + 1 for i in range(12)]
    assert any(r._retried for r in refs)
    # a retried call may reach the replica the controller started in the
    # victim's place: every replica it started may flush a batch
    handle._refresh(force=True)
    replica_pids |= {rt.get(r.handle_request.remote("pid", ((), {})),
                            timeout=TIMEOUT) for r in handle._replicas}
    serve.delete("Flusher")   # a drain in the controller
    mine = {e[1] for e in events.snapshot() if e[1].startswith("serve.")}
    kinds = {"serve.request", "serve.shed", "serve.drain",
             "serve.batch.flush"}
    deadline = time.monotonic() + 15
    while True:
        theirs = {}
        for e in conductor.call("get_ring_events", kind="serve"):
            if e["ts"] >= t_start:
                theirs.setdefault(e["kind"], set()).add(e["pid"])
        if kinds <= set(theirs) or time.monotonic() > deadline:
            break
        time.sleep(float(config.get("event_flush_period_s")))
    assert {"serve.retry", "serve.timeout"} <= mine
    assert kinds <= set(theirs), theirs
    me = os.getpid()
    assert theirs["serve.batch.flush"] <= replica_pids
    proxy = theirs["serve.request"]
    assert len(proxy) == 1 and proxy.isdisjoint(replica_pids | {me})
    assert theirs["serve.shed"] == proxy
    drain = theirs["serve.drain"]
    assert len(drain) == 1 and drain.isdisjoint(proxy | replica_pids | {me})
