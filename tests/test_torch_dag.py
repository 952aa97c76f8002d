"""The port's compiled graphs (``ray_tpu_torch.dag``) on its cluster runtime,
held to the JAX package's. The tests come in two groups.

- *Programs:* a fixed list of graph programs runs first on a JAX ``Cluster``
  (``ray_tpu``), which is then shut down, then on the port's module
  cluster. Each program returns plain values or an exception's class name,
  and the two must be equal. The JAX run happens once per test run
  (``_once``: the xdist workers share one pickle of its results), before
  any port cluster of this module starts in that process. Each JAX program
  tears its graph down within about a second, and the run waits for its
  rings to be gone before the next (``_settle_jax_rings``), so the JAX
  package's own hygiene probe, which sees every store's channel segments,
  never counts this file's rings through its 2 s grace.
- *Counterparts* of the 15 test functions of ``tests/test_compiled_dag.py``:
  the same inputs and assertions on the port. The port pickles classes by
  import path, so every actor class here is defined at module level (the
  JAX tests define some inside the test).
  ``test_classnode_refs_pass_to_the_actor`` holds ``test_classnode_passes_refs_through``'s assertions without
  running the JAX program, which fails in whole runs of the JAX package's
  tests (ROADMAP.md C, "Not queued").

The module's own hygiene fixture checks, after every test, that no
compiled graph of the port is alive in this process and that no channel
segment of this module's cluster is left (the port's probe,
``dag.channel.leaked_segments``, filtered to this cluster's stores, since
other test files' clusters may hold live rings at the same moment).

Worker processes import this module by name, so it imports no JAX at the
top; the JAX workers get its classes by value (cloudpickle's
pickle-by-value, registered for the JAX run only).
"""

import fcntl
import os
import pickle
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster import fault_plane
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core.exceptions import GetTimeoutError, TaskError
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.dag import channel, compiled

# ---------------------------------------------------------------------------
# plain classes and functions, wrapped by each package's ``remote``
# ---------------------------------------------------------------------------


class Worker:
    def __init__(self):
        self.calls = 0

    def double(self, x):
        self.calls += 1
        return x * 2

    def add(self, x, y=0):
        self.calls += 1
        return x + y

    def slow_double(self, x):
        time.sleep(0.5)
        return x * 2

    def nap_double(self, x):
        time.sleep(0.2)
        return x * 2

    def boom(self, x):
        if x == "boom":
            raise ValueError("kaboom")
        return x

    def total(self, x):
        return float(np.asarray(x).sum())

    def ncalls(self):
        return self.calls


class Holder:
    def __init__(self, x):
        self.x = x

    def get_x(self):
        return self.x


def seed_value():
    return 5


def plus_one(x):
    return x + 1


# ---------------------------------------------------------------------------
# the programs (each takes the package and returns plain values)
# ---------------------------------------------------------------------------


def _pkg(name):
    import importlib
    return (importlib.import_module(name),
            importlib.import_module(name + ".dag"))


def _kill(rt_, *nodes):
    for n in nodes:
        h = getattr(n, "_actor_handle", None)
        if h is not None:
            rt_.kill(h)


def prog_chain(name):
    rt_, dag = _pkg(name)
    node = rt_.remote(Worker).bind()
    with dag.InputNode() as inp:
        g = node.add.bind(node.double.bind(inp), y=1)
    cg = g.experimental_compile()
    try:
        out = [rt_.get(cg.execute(i), timeout=30) for i in range(5)]
    finally:
        cg.teardown()
    calls = rt_.get(node._actor_handle.ncalls.remote(), timeout=30)
    _kill(rt_, node)
    return [out, calls]


def prog_multi_output(name):
    rt_, dag = _pkg(name)
    a, b = rt_.remote(Worker).bind(), rt_.remote(Worker).bind()
    with dag.InputNode() as inp:
        g = dag.MultiOutputNode([a.double.bind(inp), b.add.bind(inp, y=10),
                                 a.double.bind(inp)])
    cg = g.experimental_compile()
    try:
        out = [rt_.get(cg.execute(i), timeout=30) for i in (7, 8)]
    finally:
        cg.teardown()
    _kill(rt_, a, b)
    return out


def prog_poison_then_teardown(name):
    rt_, dag = _pkg(name)
    node = rt_.remote(Worker).bind()
    with dag.InputNode() as inp:
        g = node.boom.bind(inp)
    cg = g.experimental_compile()
    out = []
    try:
        out.append(rt_.get(cg.execute("fine"), timeout=30))
        try:
            rt_.get(cg.execute("boom"), timeout=30)
        except Exception as e:  # noqa: BLE001
            out.append([type(e).__name__, type(e.cause).__name__,
                        "kaboom" in str(e)])
        try:
            cg.execute("fine")
        except Exception as e:  # noqa: BLE001
            out.append([type(e).__name__, "poisoned" in str(e)])
    finally:
        cg.teardown()
    try:
        cg.execute(1)
    except Exception as e:  # noqa: BLE001
        out.append([type(e).__name__, "torn down" in str(e)])
    out.append(rt_.get(node._actor_handle.double.remote(4), timeout=30))
    _kill(rt_, node)
    return out


def prog_backpressure(name):
    rt_, dag = _pkg(name)
    node = rt_.remote(Worker).bind()
    with dag.InputNode() as inp:
        g = node.nap_double.bind(inp)
    cg = g.experimental_compile(max_in_flight=2)
    out = []
    try:
        refs = [cg.execute(i) for i in (1, 2)]
        try:
            cg.execute(3, timeout=0.1)
        except Exception as e:  # noqa: BLE001
            out.append(type(e).__name__)
        out.append([rt_.get(r, timeout=30) for r in refs])
        ref = cg.execute(5)
        ready, _ = rt_.wait([ref], num_returns=1, timeout=30)
        out.append([len(ready), rt_.get(ref, timeout=30)])
        try:
            rt_.get(ref, timeout=5)
        except Exception as e:  # noqa: BLE001
            out.append([type(e).__name__, "already retrieved" in str(e)])
    finally:
        cg.teardown()
    _kill(rt_, node)
    return out


def prog_arrays(name):
    """A small array rides a slot (the array path), a 2 MiB one spills to
    the store: both reach the actor whole."""
    rt_, dag = _pkg(name)
    node = rt_.remote(Worker).bind()
    with dag.InputNode() as inp:
        g = node.total.bind(inp)
    cg = g.experimental_compile()
    small = np.arange(12, dtype=np.float32).reshape(3, 4)
    big = np.arange(1 << 18, dtype=np.float64)
    try:
        out = [rt_.get(cg.execute(x), timeout=30) for x in (small, big)]
    finally:
        cg.teardown()
    _kill(rt_, node)
    return out


def prog_classic_execute(name):
    rt_, dag = _pkg(name)
    a = rt_.remote(Worker).bind()
    with dag.InputNode() as inp:
        g = dag.MultiOutputNode([a.double.bind(inp), a.add.bind(inp, y=1)])
    multi = g.execute(5)
    f = rt_.remote(plus_one)
    with dag.InputNode() as inp:
        chain = f.bind(f.bind(inp))
    out = [multi, chain.execute(3)]
    _kill(rt_, a)
    return out


def prog_refused_graphs(name):
    rt_, dag = _pkg(name)
    node = rt_.remote(Worker).bind()
    out = []
    try:
        node.double.bind(3).experimental_compile()
    except Exception as e:  # noqa: BLE001
        out.append([type(e).__name__, "InputNode" in str(e)])
    with dag.InputNode() as inp:
        g = rt_.remote(plus_one).bind(inp)
    try:
        g.experimental_compile()
    except Exception as e:  # noqa: BLE001
        out.append(type(e).__name__)
    try:
        dag.MultiOutputNode([])
    except Exception as e:  # noqa: BLE001
        out.append(type(e).__name__)
    _kill(rt_, node)
    return out


PROGRAMS = {n[len("prog_"):]: fn for n, fn in sorted(globals().items())
            if n.startswith("prog_")}


def _run_all(name, settle=lambda: None):
    out = {}
    for key, prog in PROGRAMS.items():
        try:
            out[key] = ("value", prog(name))
        except Exception as e:  # noqa: BLE001
            out[key] = ("raised", type(e).__name__, str(e)[:300])
        settle()
    return out


def _settle_jax_rings(prefixes):
    """Wait until the JAX cluster's channel segments are gone, then a beat
    more. The JAX package's hygiene fixture (tests/conftest.py) counts
    every store's channel segments for 2 s after each of its own dag and
    pipeline tests, which may run meanwhile on another xdist worker; a
    moment with none of this run's rings lets its probe see them gone."""
    import glob

    from ray_tpu.dag.channel import CHANNEL_KEY_MARK
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and any(
            glob.glob(f"/dev/shm/{p}*{CHANNEL_KEY_MARK.hex()}*")
            for p in prefixes):
        time.sleep(0.02)
    time.sleep(0.25)


def _jax_run():
    import sys

    import cloudpickle

    from ray_tpu.cluster.cluster_utils import Cluster as JaxCluster
    from ray_tpu.core import api
    from ray_tpu.core.runtime_cluster import ClusterRuntime
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    c = JaxCluster(initialize_head=True, head_node_args={"num_cpus": 8})
    prefixes = [n.store_prefix for n in c.nodes]
    try:
        api._runtime = ClusterRuntime(address=c.address)
        try:
            return _run_all("ray_tpu",
                            settle=lambda: _settle_jax_rings(prefixes))
        finally:
            api._runtime.shutdown()
            api._runtime = None
    finally:
        c.shutdown()
        cloudpickle.unregister_pickle_by_value(module)


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
    return _once(tmp_path_factory, "torch_dag_jax_programs", _jax_run)


@pytest.fixture(scope="module")
def cluster(jax_runs):
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 16})
    rt.shutdown()    # whatever runtime an earlier module left in this worker
    rt.init(address=c.address)
    _CLUSTER.append(c)
    prefixes = set()
    yield c
    prefixes.update(n.store_prefix for n in c.nodes)
    _CLUSTER.remove(c)
    rt.shutdown()
    c.shutdown()
    deadline = time.monotonic() + 10.0
    while _store_files(prefixes) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _store_files(prefixes)


def _store_files(prefixes):
    return [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p) for p in prefixes)]


@pytest.fixture(autouse=True)
def _graph_hygiene():
    """No live compiled graph of the port and no channel segment of this
    module's cluster after a test."""
    yield
    assert not compiled._live_graphs, (
        f"test leaked live compiled graphs: {compiled._live_graphs}")
    prefixes = [n.store_prefix for c in _CLUSTER for n in c.nodes]
    deadline = time.monotonic() + 2.0
    leaked = channel.leaked_segments(prefixes)
    while leaked and time.monotonic() < deadline:
        time.sleep(0.05)
        leaked = channel.leaked_segments(prefixes)
    assert not leaked, f"test leaked channel shm segments: {leaked}"


def _reap(*nodes):
    """Free the test's actors (module-scoped cluster: CPUs must recycle)."""
    for n in nodes:
        h = getattr(n, "_actor_handle", None)
        if h is not None:
            try:
                rt.kill(h)
            except Exception:
                pass


RWorker = rt.remote(Worker)


# ---------------------------------------------------------------------------
# the programs against the JAX cluster's results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_graph_program_gives_the_jax_cluster_result(cluster, jax_runs,
                                                    program):
    want = jax_runs[program]
    assert want[0] == "value", f"the JAX cluster raised: {want}"
    got = ("value", PROGRAMS[program]("ray_tpu_torch"))
    assert got == want


def test_the_jax_programs_reached_the_paths_they_name(jax_runs):
    """The JAX results themselves: poison carries the worker's ValueError,
    backpressure times out, the refused graphs raise."""
    assert jax_runs["poison_then_teardown"][1] == [
        "fine", ["TaskError", "ValueError", True],
        ["RuntimeError", True], ["RuntimeError", True], 8]
    assert jax_runs["backpressure"][1][0] == "GetTimeoutError"
    assert jax_runs["refused_graphs"][1] == [["ValueError", True],
                                            "TypeError", "ValueError"]


# ---------------------------------------------------------------------------
# counterparts of tests/test_compiled_dag.py
# ---------------------------------------------------------------------------


def test_compile_execute_teardown(cluster):
    node = RWorker.bind()
    with InputNode() as inp:
        dag = node.add.bind(node.double.bind(inp), y=1)
    cg = dag.experimental_compile()
    try:
        for i in range(5):
            ref = cg.execute(i)
            assert rt.get(ref, timeout=30) == i * 2 + 1
    finally:
        cg.teardown()
    handle = node._actor_handle
    assert rt.get(handle.ncalls.remote(), timeout=30) == 10
    assert rt.get(handle.double.remote(21), timeout=30) == 42
    with pytest.raises(RuntimeError, match="torn down"):
        cg.execute(1)
    _reap(node)


def test_requires_input_node(cluster):
    node = RWorker.bind()
    dag = node.double.bind(3)
    with pytest.raises(ValueError, match="InputNode"):
        dag.experimental_compile()
    _reap(node)


def test_multi_output(cluster):
    a, b = RWorker.bind(), RWorker.bind()
    with InputNode() as inp:
        dag = MultiOutputNode([a.double.bind(inp), b.add.bind(inp, y=10)])
    cg = dag.experimental_compile()
    try:
        out = rt.get(cg.execute(7), timeout=30)
        assert out == [14, 17]
    finally:
        cg.teardown()
        _reap(a, b)


def test_multi_output_classic_execute(cluster):
    a = RWorker.bind()
    with InputNode() as inp:
        dag = MultiOutputNode([a.double.bind(inp), a.add.bind(inp, y=1)])
    assert dag.execute(5) == [10, 6]
    _reap(a)


def test_classnode_refs_pass_to_the_actor(cluster, monkeypatch):
    """``test_classnode_passes_refs_through``'s assertion (the classic
    execution gives the value the constructor's ref stood for), and that
    the ref reaches ``.remote()`` unresolved: the driver calls no get for
    it."""
    seed = rt.remote(seed_value)
    with InputNode():
        dag = rt.remote(Holder).bind(seed.bind()).get_x.bind()
    gets = []
    real_get = core_api.get

    def counting_get(refs, **kw):
        gets.append(refs)
        return real_get(refs, **kw)

    monkeypatch.setattr(core_api, "get", counting_get)
    monkeypatch.setattr(rt, "get", counting_get)
    assert dag.execute() == 5
    # one get: the root's result, none for the constructor's argument
    assert len(gets) == 1
    _reap(dag._class_node)


def test_max_in_flight_pipelining(cluster):
    node = RWorker.bind()
    with InputNode() as inp:
        dag = node.slow_double.bind(inp)
    cg = dag.experimental_compile(max_in_flight=4)
    try:
        t0 = time.monotonic()
        refs = [cg.execute(i) for i in range(4)]
        submit_s = time.monotonic() - t0
        assert submit_s < 0.4
        assert [rt.get(r, timeout=30) for r in refs] == [0, 2, 4, 6]
        for i in range(4):
            cg.execute(i)
        with pytest.raises(GetTimeoutError):
            cg.execute(99, timeout=0.3)
    finally:
        cg.teardown()
        _reap(node)


def test_wait_on_compiled_refs(cluster):
    node = RWorker.bind()
    with InputNode() as inp:
        dag = node.double.bind(inp)
    cg = dag.experimental_compile()
    try:
        refs = [cg.execute(i) for i in range(3)]
        ready, not_ready = rt.wait(refs, num_returns=3, timeout=30)
        assert len(ready) == 3 and not not_ready
        assert rt.get(ready[0], timeout=30) == 0
    finally:
        cg.teardown()
        _reap(node)


def test_result_consumed_destructively(cluster):
    node = RWorker.bind()
    with InputNode() as inp:
        dag = node.double.bind(inp)
    cg = dag.experimental_compile()
    try:
        ref = cg.execute(2)
        assert rt.get(ref, timeout=30) == 4
        with pytest.raises(ValueError, match="already retrieved"):
            rt.get(ref, timeout=5)
    finally:
        cg.teardown()
        _reap(node)


def test_exception_poisons_graph_and_teardown_recovers(cluster):
    node = RWorker.bind()
    with InputNode() as inp:
        dag = node.boom.bind(inp)
    cg = dag.experimental_compile()
    try:
        assert rt.get(cg.execute("fine"), timeout=30) == "fine"
        ref = cg.execute("boom")
        with pytest.raises(TaskError, match="kaboom"):
            rt.get(ref, timeout=30)
        with pytest.raises(RuntimeError, match="poisoned"):
            cg.execute("fine")
    finally:
        cg.teardown()
    handle = node._actor_handle
    assert rt.get(handle.double.remote(4), timeout=30) == 8
    _reap(node)


def test_cross_host_channel_path(cluster):
    cluster.add_node(num_cpus=2, resources={"island": 1.0})
    remote_node = RWorker.options(resources={"island": 1.0}).bind()
    local_node = RWorker.bind()
    with InputNode() as inp:
        # driver -> remote host -> (cross-host channel) -> local host
        dag = local_node.add.bind(remote_node.double.bind(inp), y=100)
    cg = dag.experimental_compile()
    try:
        for i in range(6):
            assert rt.get(cg.execute(i), timeout=60) == i * 2 + 100
    finally:
        cg.teardown()
        _reap(remote_node, local_node)


@pytest.mark.chaos
def test_chaos_sever_cross_host_channel(cluster):
    """Sever a cross-host channel mid-execution (seeded fault at
    cgraph.channel.write): the graph poisons, the failing execute raises
    within its deadline, and teardown() restores classic task service."""
    cluster.add_node(num_cpus=2, resources={"sever_isle": 1.0})
    node = RWorker.options(resources={"sever_isle": 1.0}).bind()
    with InputNode() as inp:
        dag = node.double.bind(inp)
    cg = dag.experimental_compile()
    try:
        assert rt.get(cg.execute(1), timeout=60) == 2
        fault_plane.load_plan([{"site": "cgraph.channel.write",
                                "action": "sever", "nth": 1}])
        t0 = time.monotonic()
        with pytest.raises(Exception, match="sever"):
            cg.execute(2)
        assert time.monotonic() - t0 < 10.0
        with pytest.raises(RuntimeError, match="poisoned"):
            cg.execute(3)
    finally:
        fault_plane.clear_plan()
        cg.teardown()
    handle = node._actor_handle
    assert rt.get(handle.double.remote(5), timeout=60) == 10
    _reap(node)


def test_debug_state_reports_loops(cluster):
    from ray_tpu_torch.cluster.protocol import get_client
    node = RWorker.bind()
    with InputNode() as inp:
        dag = node.double.bind(inp)
    cg = dag.experimental_compile()
    try:
        assert rt.get(cg.execute(3), timeout=30) == 6
        plan = cg._installed[0]
        st = get_client(plan.address).call("debug_state")
        loops = st.get("cgraph_loops", [])
        assert len(loops) == 1 and loops[0]["alive"]
    finally:
        cg.teardown()
        _reap(node)


def test_channel_backpressure_blocks_then_resumes(cluster):
    """A writer that laps the reader by a full ring blocks (bounded
    buffering IS the backpressure), then resumes the instant a slot is
    acked."""
    from ray_tpu_torch.dag.channel import (ChannelTimeout, ShmChannelReader,
                                           ShmChannelWriter, make_channel_id)
    store = core_api._runtime.store
    cid = make_channel_id()
    reader = ShmChannelReader(store, cid, nslots=2, slot_bytes=64)
    writer = ShmChannelWriter(store, cid)
    try:
        writer.write(0, b"a")
        writer.write(1, b"b")
        with pytest.raises(ChannelTimeout, match="EMPTY"):
            writer.write(2, b"c", timeout=0.2)
        unblocked = threading.Event()

        def _blocked_write():
            writer.write(2, b"c", timeout=10.0)
            unblocked.set()

        t = threading.Thread(target=_blocked_write, daemon=True)
        t.start()
        assert not unblocked.wait(0.2)
        assert reader.read(0, timeout=5.0)[0] == b"a"
        assert unblocked.wait(5.0), "ack did not release the writer"
        t.join(5.0)
        assert reader.read(1, timeout=5.0)[0] == b"b"
        assert reader.read(2, timeout=5.0)[0] == b"c"
    finally:
        writer.close()
        reader.close()


def test_channel_reader_close_wakes_blocked_writer(cluster):
    """close() on the consumer marks the ring closed: a writer stalled on
    a FULL slot fails fast instead of timing out."""
    from ray_tpu_torch.dag.channel import (ChannelError, ShmChannelReader,
                                           ShmChannelWriter, make_channel_id)
    store = core_api._runtime.store
    cid = make_channel_id()
    reader = ShmChannelReader(store, cid, nslots=2, slot_bytes=64)
    writer = ShmChannelWriter(store, cid)
    try:
        writer.write(0, b"a")
        writer.write(1, b"b")
        err = []

        def _blocked_write():
            try:
                writer.write(2, b"c", timeout=30.0)
            except ChannelError as e:
                err.append(e)

        t = threading.Thread(target=_blocked_write, daemon=True)
        t.start()
        time.sleep(0.1)
        reader.close()
        t.join(5.0)
        assert not t.is_alive(), "writer still blocked after reader close"
        assert err and "closed by peer" in str(err[0])
        with pytest.raises(ChannelError, match="closed by peer"):
            writer.write(2, b"c", timeout=1.0)
    finally:
        writer.close()
        reader.close()


def test_channel_recycled_segment_nonce_guard(cluster):
    """If the store recycles a segment for a NEW ring while an old writer
    still holds its mapping, the stale write fails deterministically
    instead of corrupting the new ring."""
    store = core_api._runtime.store
    cid = channel.make_channel_id()
    reader = channel.ShmChannelReader(store, cid, nslots=2, slot_bytes=64)
    writer = channel.ShmChannelWriter(store, cid)
    try:
        writer.write(0, b"a")
        assert reader.read(0, timeout=5.0)[0] == b"a"
        reader.ring.mv[channel._OFF_NONCE:channel._OFF_NONCE + 8] = bytes(8)
        with pytest.raises(channel.ChannelError, match="nonce mismatch"):
            writer.write(1, b"b", timeout=1.0)
    finally:
        writer.close()
        reader.close()


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_channel_layout_and_marker_are_the_jax_modules_but_the_mark():
    """Header and slot layout, flags and offsets equal the JAX module's;
    the key marker differs, so neither package's probe sees the other's
    rings."""
    from ray_tpu.dag import channel as jchannel
    for name in ("_HDR", "_OFF_NSLOTS", "_OFF_SLOT_BYTES", "_OFF_WRITE_SEQ",
                 "_OFF_ACK_SEQ", "_OFF_CLOSED", "_OFF_NONCE", "_SLOT_HDR",
                 "_EMPTY", "_FULL", "FLAG_POISON", "FLAG_SPILL",
                 "FLAG_ARRAY", "_MAGIC"):
        assert getattr(channel, name) == getattr(jchannel, name), name
    assert channel.ring_bytes(4, 256) == jchannel.ring_bytes(4, 256)
    assert channel.CHANNEL_KEY_MARK != jchannel.CHANNEL_KEY_MARK
    assert channel.make_channel_id()[:4] == channel.CHANNEL_KEY_MARK


def test_spilled_values_leave_no_store_object(cluster):
    """A value over the slot size spills to the store once, however many
    channels read it. The only reader of a spilled object deletes it once
    read: after a chain of such values the store holds as much as before.
    An object that two channels read is left to the store (FLAG_SHARED):
    one object a call, not one a reader."""
    a, b = RWorker.bind(), RWorker.bind()
    store = core_api._runtime.store
    big = np.ones(1 << 18, dtype=np.float64)       # 2 MiB > the 1 MiB slot
    with InputNode() as inp:
        chain = b.total.bind(a.double.bind(inp))
    cg = chain.experimental_compile()
    try:
        assert rt.get(cg.execute(big), timeout=30) == 2.0 ** 19
        used = store.stats().get("used", 0)
        for _ in range(4):
            assert rt.get(cg.execute(big), timeout=30) == 2.0 ** 19
        deadline = time.monotonic() + 5.0
        while (store.stats().get("used", 0) > used
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert store.stats().get("used", 0) <= used
    finally:
        cg.teardown()
    with InputNode() as inp:
        fan = MultiOutputNode([a.total.bind(inp), b.total.bind(inp)])
    cg = fan.experimental_compile()
    before = set(store.list_objects())
    try:
        for _ in range(3):
            assert rt.get(cg.execute(big), timeout=30) == [2.0 ** 18] * 2
        left = set(store.list_objects()) - before
        assert len(left) == 3
        for key in left:
            store.delete(key)
    finally:
        cg.teardown()
        _reap(a, b)


def test_compile_refuses_the_in_process_runtime(monkeypatch):
    """As in the JAX package, compiled graphs need the cluster runtime."""
    from ray_tpu_torch.core.runtime_local import LocalRuntime
    from ray_tpu_torch.dag.compiled import CompiledGraph
    local = LocalRuntime()
    monkeypatch.setattr(core_api, "_runtime", local)
    try:
        with InputNode() as inp:
            dag = RWorker.bind().double.bind(inp)
        with pytest.raises(RuntimeError, match="cluster mode"):
            CompiledGraph(dag)
    finally:
        local.shutdown()
