"""Port parity: ray_tpu_torch's in-process runtime against ray_tpu's.

Each scenario of ``tests/test_core_basic.py`` and ``tests/test_core_actors.py``
runs once on each package, in that package's own in-process runtime (started
and shut down here, never through the conftest's ``local_rt``, which serves
``ray_tpu`` alone), with the same expected values. Then what only the port
has: a shutdown that joins its threads and wakes blocked getters, init with an
address that is not there refused, the torch tensor path of the serialization (numpy blobs
byte-identical to the JAX package's), the ``num_gpus`` checks mirrored on
``num_tpus``'s, the ``runtime_env`` key checks and the config registry.
"""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import config as jconfig
from ray_tpu.core import options as joptions
from ray_tpu.core import serialization as jser
from ray_tpu_torch import config as tconfig
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core import options as toptions
from ray_tpu_torch.core import refs as core_refs
from ray_tpu_torch.core import serialization as tser
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.runtime_cluster import ClusterRuntime
from ray_tpu_torch.core.runtime_local import THREAD_PREFIX, LocalRuntime

PACKAGES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


def _start(pkg):
    pkg.shutdown()
    pkg.init(local_mode=True, num_cpus=4)


@pytest.fixture(params=sorted(PACKAGES))
def rt(request):
    pkg = PACKAGES[request.param]
    _start(pkg)
    yield pkg
    pkg.shutdown()


@pytest.fixture
def trt():
    """The port's runtime alone."""
    _start(ray_tpu_torch)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _runtime_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX) and t.is_alive()]


# ---------------------------------------------------------------------------
# Scenarios of tests/test_core_basic.py and tests/test_core_actors.py
# ---------------------------------------------------------------------------

def put_get(rt):
    for value in [1, "x", [1, 2, {"a": (3, 4)}], None, b"bytes",
                  np.arange(10)]:
        out = rt.get(rt.put(value))
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(out, value)
        else:
            assert out == value


def task_submit(rt):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2)) == 3
    refs = [add.remote(i, i) for i in range(20)]
    assert rt.get(refs) == [2 * i for i in range(20)]


def ref_arg_resolution(rt):
    @rt.remote
    def double(x):
        return 2 * x

    @rt.remote
    def combine(a, b):
        return a + b

    r1 = double.remote(rt.put(10))   # top-level ref resolved to value
    assert rt.get(combine.remote(r1, 5)) == 25


def nested_refs(rt):
    @rt.remote
    def peek(d):
        return isinstance(d["ref"], rt.ObjectRef)

    assert rt.get(peek.remote({"ref": rt.put(1)}))


def num_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c]) == [1, 2, 3]


def error_propagation(rt):
    @rt.remote
    def boom():
        raise ValueError("kaboom")

    @rt.remote
    def consume(x):
        return x

    with pytest.raises(rt.TaskError) as ei:
        rt.get(boom.remote())
    assert "kaboom" in str(ei.value)
    assert isinstance(ei.value.cause, ValueError)
    with pytest.raises(rt.TaskError):
        rt.get(consume.remote(boom.remote()))


def wait(rt):
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(2.0)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, pending = rt.wait([f, s], num_returns=1, timeout=1.5)
    assert ready == [f] and pending == [s]
    ready, pending = rt.wait([s], num_returns=1, timeout=0.01)
    assert ready == [] and pending == [s]
    # the canonical drain loop works on the returned pending list
    ready, pending = rt.wait(pending, num_returns=1, timeout=5)
    assert ready == [s] and pending == []


def get_timeout(rt):
    @rt.remote
    def slow():
        time.sleep(5)

    with pytest.raises(rt.GetTimeoutError):
        rt.get(slow.remote(), timeout=0.05)


def options(rt):
    @rt.remote
    def one():
        return 1

    assert rt.get(one.options(name="renamed").remote()) == 1
    with pytest.raises(ValueError):
        one.options(bogus_option=1)
    with pytest.raises(TypeError):
        one()


def closures(rt):
    factor = 7

    @rt.remote
    def mul(x):
        return factor * x

    assert rt.get(mul.remote(6)) == 42


def actors_in_order(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, by=1):
            self.n += by
            return self.n

    @rt.remote
    class Log:
        def __init__(self):
            self.items = []

        def append(self, x):
            self.items.append(x)

        def get(self):
            return self.items

    c = Counter.remote(10)
    assert rt.get(c.inc.remote()) == 11
    assert rt.get(c.inc.remote(5)) == 16
    log = Log.remote()
    for i in range(50):
        log.append.remote(i)
    assert rt.get(log.get.remote()) == list(range(50))


def actor_error_and_handles(rt):
    @rt.remote
    class Bad:
        def boom(self):
            raise KeyError("nope")

        def ok(self):
            return 1

    @rt.remote
    class Store:
        def __init__(self):
            self.v = None

        def set(self, v):
            self.v = v

        def get(self):
            return self.v

    @rt.remote
    def writer(store, v):
        rt.get(store.set.remote(v))
        return True

    b = Bad.remote()
    with pytest.raises(rt.TaskError):
        rt.get(b.boom.remote())
    assert rt.get(b.ok.remote()) == 1    # the actor survives a method error
    s = Store.remote()
    assert rt.get(writer.remote(s, 42))
    assert rt.get(s.get.remote()) == 42


def async_actors(rt):
    @rt.remote
    class AsyncWorker:
        async def work(self, x):
            import asyncio
            await asyncio.sleep(0.01)
            return x * 2

    @rt.remote(max_concurrency=4)
    class Chain:
        async def produce(self):
            import asyncio
            await asyncio.sleep(0.05)
            return 7

        async def consume(self, x):
            return x + 1

    a = AsyncWorker.remote()
    assert rt.get([a.work.remote(i) for i in range(8)]) == \
        [2 * i for i in range(8)]
    ch = Chain.remote()     # a ref of its own earlier call: no deadlock
    assert rt.get(ch.consume.remote(ch.produce.remote()), timeout=10) == 8


def named_actors(rt):
    @rt.remote
    class Singleton:
        def ping(self):
            return "pong"

    Singleton.options(name="the-one").remote()
    assert rt.get(rt.get_actor("the-one").ping.remote()) == "pong"
    with pytest.raises(ValueError):
        Singleton.options(name="the-one").remote()
    h2 = Singleton.options(name="the-one", get_if_exists=True).remote()
    assert rt.get(h2.ping.remote()) == "pong"

    results = []

    def create():
        try:
            Singleton.options(name="racer").remote()
            results.append("ok")
        except ValueError:
            results.append("taken")

    ts = [threading.Thread(target=create) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert results.count("ok") == 1, results


def kill(rt):
    @rt.remote
    class Victim:
        def ping(self):
            return 1

    @rt.remote
    class Slow:
        def work(self):
            time.sleep(5)
            return 1

    v = Victim.remote()
    assert rt.get(v.ping.remote()) == 1
    rt.kill(v)
    with pytest.raises(rt.TaskError):
        rt.get(v.ping.remote())
    s = Slow.remote()
    r1 = s.work.remote()
    r2 = s.work.remote()   # queued behind r1
    time.sleep(0.1)
    rt.kill(s)
    for r in (r1, r2):
        with pytest.raises(rt.TaskError):
            rt.get(r, timeout=5)


def max_concurrency(rt):
    @rt.remote(max_concurrency=4)
    class Parallel:
        def slow(self):
            time.sleep(0.2)
            return 1

    @rt.remote
    class Multi:
        @rt.method(num_returns=2)
        def pair(self):
            return 1, 2

    p = Parallel.remote()
    t0 = time.monotonic()
    rt.get([p.slow.remote() for _ in range(4)])
    elapsed = time.monotonic() - t0
    assert elapsed < 0.7, f"calls did not overlap: {elapsed:.2f}s"
    a, b = Multi.remote().pair.remote()
    assert rt.get([a, b]) == [1, 2]


SCENARIOS = [put_get, task_submit, ref_arg_resolution, nested_refs,
             num_returns, error_propagation, wait, get_timeout, options,
             closures, actors_in_order, actor_error_and_handles,
             async_actors, named_actors, kill, max_concurrency]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario(rt, scenario):
    scenario(rt)


# ---------------------------------------------------------------------------
# What the port's runtime adds
# ---------------------------------------------------------------------------

def test_shutdown_joins_every_runtime_thread(trt):
    @trt.remote
    def task(x):
        return x

    @trt.remote
    class Sync:
        def __init__(self):
            self.t = torch.zeros(4)

        def get(self):
            return self.t

    @trt.remote(max_concurrency=2)
    class Async:
        async def echo(self, x):
            return x

    a, b, killed = Sync.remote(), Async.remote(), Sync.remote()
    assert trt.get(task.remote(trt.put(3))) == 3
    assert trt.get(b.echo.remote(trt.put(5))) == 5
    assert float(trt.get(a.get.remote()).sum()) == 0.0
    trt.get(killed.get.remote())
    trt.kill(killed)
    assert _runtime_threads()
    trt.shutdown()
    assert _runtime_threads() == []
    assert not trt.is_initialized()


def test_shutdown_wakes_a_task_blocked_on_a_missing_object(trt):
    never = trt.ObjectRef(ObjectID.from_random())

    @trt.remote
    def blocked(ref_holder):
        return trt.get(ref_holder[0])

    ref = blocked.remote([never])
    time.sleep(0.1)
    t0 = time.monotonic()
    trt.shutdown()
    assert time.monotonic() - t0 < 5
    assert _runtime_threads() == []
    del ref


def test_shutdown_fails_objects_asked_for_after_it_began(trt):
    errors = []

    @trt.remote
    def waiter():
        for _ in range(3):   # the first get is woken, the next ones fail
            try:
                trt.get(trt.ObjectRef(ObjectID.from_random()))
            except trt.TaskError as e:
                errors.append(str(e.cause))

    waiter.remote()
    time.sleep(0.1)
    t0 = time.monotonic()
    trt.shutdown()
    assert time.monotonic() - t0 < 5
    assert errors == ["runtime shut down"] * 3
    assert _runtime_threads() == []


def test_remote_lambda_needs_no_pickling(trt):
    square = trt.remote(lambda x: x * x)
    assert trt.get(square.remote(7)) == 49
    # pickling for another process goes by import path: no lambdas
    with pytest.raises(TypeError, match="module level"):
        tser.dumps(lambda x: x)


@pytest.mark.parametrize("address", ["127.0.0.1:1", "client://127.0.0.1:1"])
def test_init_with_an_address_is_refused(address, monkeypatch):
    """A conductor, or a client proxy, that is not there raises. Neither
    falls back to the in-process runtime."""
    ray_tpu_torch.shutdown()
    monkeypatch.setitem(tconfig._overrides, "gcs_rpc_reconnect_s", 0.5)
    with pytest.raises(ConnectionError):
        ray_tpu_torch.init(address)
    assert not ray_tpu_torch.is_initialized()
    assert core_refs._tracker is None


def test_init_forms_and_resources():
    """``init()`` starts a head (the cluster runtime, as the JAX ``init()``
    does); ``local_mode=True`` and ``address="local"`` the in-process
    runtime. Each counts the resources it is given."""
    ray_tpu_torch.shutdown()
    for kw, runtime in (({}, ClusterRuntime),
                        ({"local_mode": True}, LocalRuntime),
                        ({"address": "local"}, LocalRuntime)):
        ray_tpu_torch.init(num_cpus=2, num_gpus=1, **kw)
        try:
            assert type(core_api._runtime) is runtime
            assert ray_tpu_torch.cluster_resources() == {"CPU": 2.0,
                                                         "GPU": 1.0}
            assert ray_tpu_torch.nodes()[0]["Alive"]
            with pytest.raises(RuntimeError, match="twice"):
                ray_tpu_torch.init()
            assert ray_tpu_torch.init(ignore_reinit_error=True) is not None
        finally:
            ray_tpu_torch.shutdown()


def test_implicit_init_is_main_thread_only():
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
    assert not t.is_alive()
    assert errors and "main-thread-only" in errors[0]
    assert not ray_tpu_torch.is_initialized()


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

NUMPY_VALUES = {
    "c_order": np.arange(24, dtype=np.float32).reshape(4, 6),
    "f_order": np.asfortranarray(np.arange(24, dtype=np.int64).reshape(4, 6)),
    "zero_d": np.array(3.5),
    "empty": np.zeros((0, 3), np.float32),
    "bool_1d": np.array([True, False, True]),
}


@pytest.mark.parametrize("name", sorted(NUMPY_VALUES))
def test_numpy_blob_is_byte_identical_to_the_jax_package(name):
    value = NUMPY_VALUES[name]
    got, got_refs = tser.serialize(value)
    want, want_refs = jser.serialize(value)
    assert got == want and got_refs == want_refs == []
    out = tser.deserialize(got)
    assert out.dtype == value.dtype and out.shape == value.shape
    np.testing.assert_array_equal(out, value)
    assert not out.flags.writeable
    # and each package reads the other's blob
    np.testing.assert_array_equal(jser.deserialize(got), value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64,
                                   torch.float16, torch.bool])
def test_tensor_comes_back_as_host_numpy(dtype):
    t = (torch.arange(12) % 3).to(dtype).reshape(3, 4)
    for value in (t, t.t(), t[:, ::2]):
        blob, refs = tser.serialize(value)
        assert refs == []
        hdr = tser.array_header(blob)
        assert hdr["was_tensor"] and hdr["device"] == "cpu"
        out = tser.deserialize(blob)
        assert isinstance(out, np.ndarray) and not out.flags.writeable
        np.testing.assert_array_equal(out, value.numpy())
    # a numpy array sets no framework flag and records no device
    hdr = tser.array_header(tser.serialize(t.numpy())[0])
    assert not hdr["was_tensor"] and hdr["device"] == ""


def test_tensor_with_grad_and_zero_d():
    w = torch.ones(3, requires_grad=True) * 2
    np.testing.assert_array_equal(tser.deserialize(tser.serialize(w)[0]),
                                  np.full(3, 2.0, np.float32))
    out = tser.deserialize(tser.serialize(torch.tensor(7))[0])
    assert out.shape == () and int(out) == 7


def test_bf16_tensor_takes_the_pickle_path():
    t = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    blob, _ = tser.serialize(t)
    assert not tser.is_array_blob(blob)
    out = tser.deserialize(blob)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
    assert torch.equal(out, t)
    # nested tensors keep their type too
    nested = tser.deserialize(tser.serialize({"w": t, "n": 1})[0])
    assert torch.equal(nested["w"], t) and nested["n"] == 1


def test_refs_are_collected():
    ref = ray_tpu_torch.ObjectRef(ObjectID.from_random())
    blob, refs = tser.serialize({"nested": [ref, 1], "x": np.arange(3)})
    assert refs == [ref]
    out = tser.deserialize(blob)
    assert out["nested"][0] == ref
    np.testing.assert_array_equal(out["x"], np.arange(3))
    assert tser.collect_refs({"a": [ref, (ref,)], "b": 2}) == [ref, ref]


def test_zero_copy_flag_turns_the_array_path_off():
    value = np.arange(8, dtype=np.float32)
    tconfig.set_override("array_zero_copy_enabled", False)
    try:
        blob, _ = tser.serialize(value)
    finally:
        tconfig.clear_override("array_zero_copy_enabled")
    assert not tser.is_array_blob(blob)
    np.testing.assert_array_equal(tser.deserialize(blob), value)
    assert tser.is_array_blob(tser.serialize(value)[0])


# ---------------------------------------------------------------------------
# Options and config
# ---------------------------------------------------------------------------

RESOURCE_CASES = [0, 0.5, 1, 2, 1.5, 2.5, -1]


@pytest.mark.parametrize("kind", ["task", "actor"])
@pytest.mark.parametrize("amount", RESOURCE_CASES)
def test_num_gpus_checks_mirror_num_tpus(kind, amount):
    def outcome(make, **kw):
        try:
            make(None, **kw)
            return "ok"
        except ValueError:
            return "ValueError"

    tmake = getattr(toptions, f"make_{kind}_options")
    jmake = getattr(joptions, f"make_{kind}_options")
    assert outcome(tmake, num_gpus=amount) == outcome(jmake, num_tpus=amount)
    assert outcome(tmake, num_cpus=amount) == outcome(jmake, num_cpus=amount)
    with pytest.raises(ValueError):
        tmake(None, num_tpus=1)          # the port has no TPU option
    with pytest.raises(ValueError, match="num_gpus"):
        tmake(None, resources={"GPU": 1})
    with pytest.raises(ValueError):
        jmake(None, resources={"TPU": 1})


def test_runtime_env_key_checks_mirror_runtime_env(tmp_path):
    def outcome(make, env):
        try:
            return make(None, runtime_env=env).runtime_env
        except (TypeError, ValueError) as e:
            return type(e).__name__

    cases = [{"env_vars": {"A": "1"}}, {"env_vars": {"A": 1}},
             {"working_dir": str(tmp_path)},
             {"working_dir": str(tmp_path / "missing")},
             {"pip": ["numpy"]}, {"pip": []}, {"pip": "numpy"},
             {"pip": {"packages": ["x"], "find_links": str(tmp_path)}},
             {"pip": {"packages": ["x"], "find_links": str(tmp_path / "no")}},
             {"conda": "env"}, {"container": "img"}, {"bogus": 1}]
    for env in cases:
        got = outcome(toptions.make_task_options, env)
        want = outcome(joptions.make_task_options, env)
        assert got == want, env
    assert toptions.make_task_options(None).runtime_env is None


def test_config_flags_keep_the_jax_names_types_and_defaults(monkeypatch):
    for name, flag in tconfig._REGISTRY.items():
        assert name in jconfig._REGISTRY, name
        assert flag.default == jconfig._REGISTRY[name].default, name
        assert tconfig.get(name) == flag.default
    monkeypatch.setenv("RT_WORKER_POOL_MAX_SIZE", "3")
    assert tconfig.get("worker_pool_max_size") == 3
    tconfig.set_override("array_zero_copy_enabled", "false")
    try:
        assert tconfig.get("array_zero_copy_enabled") is False
    finally:
        tconfig.clear_override("array_zero_copy_enabled")
    with pytest.raises(ValueError, match="Unknown"):
        tconfig.set_system_config({"no_such_flag": 1})
    before = tconfig.generation
    tconfig.set_override("worker_pool_max_size", "5")
    try:
        assert tconfig.get("worker_pool_max_size") == 5
        assert tconfig.generation > before
    finally:
        tconfig.clear_override("worker_pool_max_size")


def test_init_applies_the_system_config():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True,
                       _system_config={"worker_pool_max_size": 3})
    try:
        assert tconfig.get("worker_pool_max_size") == 3
    finally:
        ray_tpu_torch.shutdown()
        tconfig.clear_override("worker_pool_max_size")
