"""The port's cluster runtime (``ray_tpu_torch.core.runtime_cluster`` over
``ray_tpu_torch.cluster``), held to the JAX package's own cluster tests.

``TestClusterRuntimeCases`` are the counterparts of
``tests/test_cluster_runtime.py`` and ``TestRefcountCases`` those of
``tests/test_refcounting.py``: the same inputs and assertions, on real
worker processes and the port's own ``shmstored``. The port pickles
functions and classes by import path, so every remote function and actor
class here is defined at module level (the JAX tests define them inside the
test functions, which cloudpickle ships by value). Worker processes import
this module by name, so it imports no JAX.

Each class holds one runtime for its tests (class scope), so no two
clusters are alive at once in one process; its teardown reaps every
process it started and checks that no segment of the port's store prefix
is left.
"""

import gc
import os
import signal
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core.runtime_cluster import ClusterRuntime


def _segments(prefix: str):
    return [f for f in os.listdir("/dev/shm") if f.startswith(prefix)]


def _reap(prefixes):
    """Wait for every segment of ``prefixes`` to go (the store unlinks its
    segments when it exits)."""
    deadline = time.monotonic() + 10.0
    left = [s for p in prefixes for s in _segments(p)]
    while left and time.monotonic() < deadline:
        time.sleep(0.05)
        left = [s for p in prefixes for s in _segments(p)]
    assert not left, f"segments left behind: {left}"


# ---------------------------------------------------------------------------
# remote functions and actor classes (module level: shipped by import path)
# ---------------------------------------------------------------------------

@rt.remote
def add(a, b):
    return a + b


@rt.remote
def double(x):
    return x * 2


@rt.remote
def boom():
    raise ValueError("expected failure")


@rt.remote(num_returns=3)
def three():
    return 1, 2, 3


@rt.remote
def total(x):
    return float(x.sum())


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, k=1):
        self.n += k
        return self.n


@rt.remote
class Broken:
    def __init__(self):
        raise RuntimeError("cannot construct")

    def f(self):
        return 1


@rt.remote
class Store:
    def __init__(self):
        self.d = {}

    def set(self, k, v):
        self.d[k] = v
        return True

    def get(self, k):
        return self.d.get(k)


@rt.remote
class Victim:
    def ping(self):
        return "pong"


@rt.remote(max_restarts=1, max_task_retries=-1)
class Phoenix:
    def __init__(self):
        self.n = 0

    def inc(self):
        self.n += 1
        return self.n

    def getpid(self):
        return os.getpid()


@rt.remote
def inner(x):
    return x + 1


@rt.remote
def outer(x):
    import ray_tpu_torch as rt2
    return rt2.get(inner.remote(x)) + 10


@rt.remote
class AsyncWorker:
    async def work(self, t):
        import asyncio
        await asyncio.sleep(t)
        return t


@rt.remote
def slow(t):
    time.sleep(t)
    return t


@rt.remote(resources={"special": 1.0}, num_cpus=1)
def where():
    return os.getpid()


@rt.remote(resources={"island": 1.0}, num_cpus=1)
def remote_sum(x):
    return float(x.sum())


@rt.remote(max_retries=2)
def flaky(path):
    if not os.path.exists(path):
        open(path, "w").close()
        os._exit(1)  # kill the worker on first attempt
    return "recovered"


def visible_cards():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
class CardHolder:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
def blob():
    return np.ones(1 << 20, dtype=np.uint8)


@rt.remote
def consume(x, delay):
    time.sleep(delay)
    return int(x[0])


@rt.remote
class Holder:
    def __init__(self):
        self.ref = None

    def hold(self, ref):
        # ref arrives as an ObjectRef inside a container (not inlined)
        self.ref = ref[0]
        return True

    def read(self):
        return int(rt.get(self.ref)[0])


@rt.remote
def late():
    time.sleep(0.4)
    return np.zeros(1 << 20, dtype=np.uint8)


@rt.remote
def slow_one():
    time.sleep(0.3)
    return 1


# ---------------------------------------------------------------------------
# tests/test_cluster_runtime.py
# ---------------------------------------------------------------------------

class TestClusterRuntimeCases:
    @pytest.fixture(scope="class")
    def cluster(self):
        c = Cluster(initialize_head=True,
                    head_node_args={"num_cpus": 4,
                                    "resources": {"head": 1.0}})
        rt_ = ClusterRuntime(address=c.address)
        core_api._runtime = rt_
        prefixes = [n.store_prefix for n in c.nodes]
        yield c
        core_api._runtime = None
        rt_.shutdown()
        prefixes += [n.store_prefix for n in c.nodes]
        c.shutdown()
        _reap(prefixes)

    def test_put_get_roundtrip(self, cluster):
        ref = rt.put({"a": 1, "arr": np.arange(10)})
        out = rt.get(ref)
        assert out["a"] == 1
        np.testing.assert_array_equal(out["arr"], np.arange(10))

    def test_task_submit_and_get(self, cluster):
        assert rt.get(add.remote(1, 2)) == 3
        # lease reuse: a burst of tasks through the same worker(s)
        refs = [add.remote(i, i) for i in range(20)]
        assert rt.get(refs) == [2 * i for i in range(20)]

    def test_task_with_ref_args(self, cluster):
        r1 = double.remote(10)
        r2 = double.remote(r1)
        assert rt.get(r2) == 40

    def test_task_error_propagates(self, cluster):
        with pytest.raises(rt.TaskError, match="expected failure"):
            rt.get(boom.remote())

    def test_num_returns(self, cluster):
        a, b, c = three.remote()
        assert rt.get([a, b, c]) == [1, 2, 3]

    def test_large_object_zero_copy(self, cluster):
        arr = np.random.rand(1 << 20)  # 8 MB
        assert abs(rt.get(total.remote(arr)) - arr.sum()) < 1e-6

    def test_actor_basic(self, cluster):
        c = Counter.remote(10)
        refs = [c.inc.remote() for _ in range(5)]
        assert rt.get(refs) == [11, 12, 13, 14, 15]  # ordered execution
        rt.kill(c)

    def test_actor_creation_failure(self, cluster):
        b = Broken.remote()
        with pytest.raises((rt.TaskError, rt.ActorError)):
            rt.get(b.f.remote())

    def test_named_actor(self, cluster):
        s = Store.options(name="kvstore").remote()
        assert rt.get(s.set.remote("x", 42))
        s2 = rt.get_actor("kvstore")
        assert rt.get(s2.get.remote("x")) == 42
        rt.kill(s)

    def test_kill_actor(self, cluster):
        v = Victim.remote()
        assert rt.get(v.ping.remote()) == "pong"
        rt.kill(v)
        time.sleep(0.5)
        with pytest.raises((rt.TaskError, rt.ActorError, rt.ActorDiedError)):
            rt.get(v.ping.remote(), timeout=10)

    def test_actor_restart(self, cluster):
        # The actor process is killed EXTERNALLY; with max_task_retries=-1
        # in-flight idempotent calls retry onto the restarted incarnation.
        p = Phoenix.remote()
        assert rt.get(p.inc.remote()) == 1
        pid = rt.get(p.getpid.remote())
        os.kill(pid, signal.SIGKILL)
        # After restart state resets; calls work again.
        deadline = time.time() + 30
        while True:
            try:
                out = rt.get(p.inc.remote(), timeout=15)
                break
            except (rt.TaskError, rt.ActorError):
                if time.time() > deadline:
                    raise
                time.sleep(0.5)
        assert out >= 1
        rt.kill(p)

    def test_nested_tasks(self, cluster):
        assert rt.get(outer.remote(1), timeout=60) == 12

    def test_async_actor(self, cluster):
        a = AsyncWorker.options(max_concurrency=4).remote()
        rt.get(a.work.remote(0.0), timeout=30)  # warm: actor cold start
        start = time.time()
        refs = [a.work.remote(0.3) for _ in range(4)]
        assert rt.get(refs, timeout=30) == [0.3] * 4
        # Concurrent awaits: 4 x 0.3s sleeps overlap.
        assert time.time() - start < 1.1
        rt.kill(a)

    def test_wait(self, cluster):
        fast = slow.remote(0.05)
        slow_ref = slow.remote(5.0)
        ready, pending = rt.wait([fast, slow_ref], num_returns=1, timeout=10)
        assert ready == [fast]
        assert pending == [slow_ref]

    def test_custom_resources_spillback(self, cluster):
        """A task needing a custom resource only on node 2 must spill
        there."""
        node2 = cluster.add_node(num_cpus=2, resources={"special": 1.0})
        cluster.wait_for_nodes(2)
        try:
            pid = rt.get(where.remote(), timeout=60)
            assert isinstance(pid, int)
        finally:
            cluster.remove_node(node2, graceful=True)
        _reap([node2.store_prefix])

    def test_multinode_object_transfer(self, cluster):
        node2 = cluster.add_node(num_cpus=2, resources={"island": 1.0})
        cluster.wait_for_nodes(2)
        try:
            arr = np.arange(1 << 18, dtype=np.float64)  # 2 MB
            # arr is put on the head node store; the task runs on node2,
            # which must pull it across, then the result transfers back.
            assert rt.get(remote_sum.remote(rt.put(arr)),
                          timeout=60) == pytest.approx(arr.sum())
        finally:
            cluster.remove_node(node2, graceful=True)
        _reap([node2.store_prefix])

    def test_task_retry_on_worker_death(self, cluster):
        path = os.path.join(tempfile.mkdtemp(), "flaky-marker")
        assert rt.get(flaky.remote(path), timeout=60) == "recovered"

    def test_node_death_marks_dead(self, cluster):
        node2 = cluster.add_node(num_cpus=2)
        cluster.wait_for_nodes(2)
        n_before = len([n for n in rt.nodes() if n["Alive"]])
        cluster.remove_node(node2, graceful=True)
        time.sleep(0.5)
        n_after = len([n for n in rt.nodes() if n["Alive"]])
        assert n_after == n_before - 1
        _reap([node2.store_prefix])

    def test_gpu_leases_get_their_own_card_indices(self, cluster):
        """The head has no card: a ``num_gpus=1`` task waits. A node with
        two (faked) cards takes it; each GPU lease's worker sees only its
        card indices, and a task that leased none sees no card."""
        gpu_task = rt.remote(num_gpus=1)(visible_cards)
        ref = gpu_task.remote()
        ready, _ = rt.wait([ref], num_returns=1, timeout=1.0)
        assert ready == []
        assert rt.get(rt.remote(visible_cards).remote(), timeout=60) == ""
        node2 = cluster.add_node(num_cpus=2, num_gpus=2)
        cluster.wait_for_nodes(2)
        try:
            assert rt.get(ref, timeout=60) in ("0", "1")
            holders = [CardHolder.options(num_gpus=1).remote()
                       for _ in range(2)]
            seen = rt.get([h.visible.remote() for h in holders], timeout=60)
            assert sorted(seen) == ["0", "1"]
            for h in holders:
                rt.kill(h)
        finally:
            cluster.remove_node(node2, graceful=True)
        _reap([node2.store_prefix])

    def test_gpu_shares_go_to_a_card_that_holds_them(self, cluster):
        """Shares below one card (ROADMAP.md C.1) on a node with two faked
        cards: two 0.6 shares cannot share a card, so their workers see
        different cards; a whole card then waits (0.8 free in all, no card
        untouched), and so does a 0.5 share (0.4 free on each card). Once
        the 0.6 actors are gone, two 0.5 actors share one card."""
        node2 = cluster.add_node(num_cpus=4, num_gpus=2)
        cluster.wait_for_nodes(2)
        try:
            big = [CardHolder.options(num_gpus=0.6).remote()
                   for _ in range(2)]
            seen = rt.get([h.visible.remote() for h in big], timeout=60)
            assert sorted(seen) == ["0", "1"]
            whole = rt.remote(num_gpus=1)(visible_cards).remote()
            half = rt.remote(num_gpus=0.5)(visible_cards).remote()
            ready, _ = rt.wait([whole, half], num_returns=1, timeout=1.5)
            assert ready == []
            for h in big:
                rt.kill(h)
            assert rt.get(whole, timeout=60) in ("0", "1")
            assert rt.get(half, timeout=60) in ("0", "1")
            # the tasks' leases go back once the submitter lets them go
            _wait_until(lambda: node2._gpu_share == [1.0, 1.0], timeout=30,
                        msg="both cards free again")
            pair = [CardHolder.options(num_gpus=0.5).remote()
                    for _ in range(2)]
            seen = rt.get([h.visible.remote() for h in pair], timeout=60)
            assert seen[0] == seen[1] and seen[0] in ("0", "1")
            for h in pair:
                rt.kill(h)
        finally:
            cluster.remove_node(node2, graceful=True)
        _reap([node2.store_prefix])

    def test_gpu_share_actor_waits_for_a_card_that_holds_it(self, cluster):
        """Actors of 0.6, 0.6 and 0.5 on two faked cards: 0.8 is free in
        all but 0.4 on each card, so the third actor waits rather than
        being started on no card; it starts on the card that the first
        0.6 actor leaves, and every share comes back once all are gone."""
        node2 = cluster.add_node(num_cpus=4, num_gpus=2)
        cluster.wait_for_nodes(2)
        try:
            big = [CardHolder.options(num_gpus=0.6).remote()
                   for _ in range(2)]
            seen = rt.get([h.visible.remote() for h in big], timeout=60)
            assert sorted(seen) == ["0", "1"]
            third = CardHolder.options(num_gpus=0.5).remote()
            ref = third.visible.remote()
            ready, _ = rt.wait([ref], num_returns=1, timeout=1.5)
            assert ready == []
            rt.kill(big[0])
            assert rt.get(ref, timeout=60) == seen[0]
            for h in (big[1], third):
                rt.kill(h)
            _wait_until(lambda: node2._avail.get("GPU") == pytest.approx(2.0)
                        and node2._gpu_share == [1.0, 1.0], timeout=30,
                        msg="both cards free again")
        finally:
            cluster.remove_node(node2, graceful=True)
        _reap([node2.store_prefix])

    def test_cluster_resources(self, cluster):
        res = rt.cluster_resources()
        assert res.get("CPU", 0) >= 4
        assert res.get("head", 0) == 1.0


# ---------------------------------------------------------------------------
# tests/test_refcounting.py
# ---------------------------------------------------------------------------

def _store_used(rt_) -> int:
    return rt_.store.stats().get("used", 0)


def _wait_until(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


class TestRefcountCases:
    @pytest.fixture(scope="class")
    def head(self):
        """A head in this process (``ClusterRuntime(address=None)``, what
        the JAX ``ray_tpu.init()`` starts), shared by the class."""
        rt_ = ClusterRuntime(num_cpus=4)
        core_api._runtime = rt_
        prefix = rt_._owned_daemon.store_prefix
        yield rt_
        core_api._runtime = None
        rt_.shutdown()
        _reap([prefix])

    @pytest.fixture()
    def cluster_rt(self, head):
        yield head
        gc.collect()

    def test_put_refs_freed_on_drop(self, cluster_rt):
        rt_ = cluster_rt
        base = _store_used(rt_)
        refs = [rt.put(np.zeros(1 << 20, dtype=np.uint8)) for _ in range(16)]
        assert _store_used(rt_) >= base + 16 * (1 << 20)
        assert rt.get(refs[0])[0] == 0
        del refs
        gc.collect()
        _wait_until(lambda: _store_used(rt_) <= base + (1 << 20),
                    msg="store to return to baseline after refs dropped")

    def test_task_returns_freed_on_drop(self, cluster_rt):
        rt_ = cluster_rt
        base = _store_used(rt_)
        refs = [blob.remote() for _ in range(8)]
        vals = rt.get(refs)
        assert all(v[0] == 1 for v in vals)
        del refs, vals
        gc.collect()
        _wait_until(lambda: _store_used(rt_) <= base + (1 << 20),
                    msg="task returns freed after refs dropped")

    def test_no_premature_free_inflight_arg(self, cluster_rt):
        """Caller drops its handle right after submit; the in-flight pin
        keeps the argument alive until the task has consumed it."""
        big = rt.put(np.full(1 << 20, 7, dtype=np.uint8))
        out = consume.remote(big, 0.5)
        del big
        gc.collect()
        assert rt.get(out) == 7

    def test_borrower_keeps_object_alive(self, cluster_rt):
        """A worker that KEEPS a borrowed ref (stores it in an actor field)
        extends the object's life past the owner's drop."""
        h = Holder.remote()
        obj = rt.put(np.full(1 << 18, 9, dtype=np.uint8))
        assert rt.get(h.hold.remote([obj]))
        del obj
        gc.collect()
        time.sleep(0.5)  # owner's decref flushes; borrower's pin must hold
        assert rt.get(h.read.remote()) == 9
        rt.kill(h)

    def test_nested_object_pins_children(self, cluster_rt):
        rt_ = cluster_rt
        inner_ref = rt.put(np.full(1 << 20, 3, dtype=np.uint8))
        outer_ref = rt.put({"inner": inner_ref})
        del inner_ref
        gc.collect()
        time.sleep(0.3)
        loaded = rt.get(outer_ref)
        assert int(rt.get(loaded["inner"])[0]) == 3
        base_probe = _store_used(rt_)
        del loaded, outer_ref
        gc.collect()
        _wait_until(lambda: _store_used(rt_) < base_probe - (1 << 19),
                    msg="outer+inner freed after both dropped")

    def test_fire_and_forget_return_reclaimed(self, cluster_rt):
        """Return refs dropped before execution: the tombstone kills the
        stray seal instead of leaking it."""
        rt_ = cluster_rt
        base = _store_used(rt_)
        late.remote()  # ref dropped immediately
        gc.collect()
        _wait_until(lambda: True, timeout=0.1)
        time.sleep(1.0)  # let it execute + seal + tombstone-delete
        _wait_until(lambda: _store_used(rt_) <= base + (1 << 18),
                    msg="fire-and-forget return reclaimed")

    def test_wait_event_driven(self, cluster_rt):
        """wait() over 1k refs resolves in a handful of RPCs, not 1k
        probes."""
        refs = [rt.put(i) for i in range(1000)]
        t0 = time.perf_counter()
        ready, pending = rt.wait(refs, num_returns=1000, timeout=10)
        dt = time.perf_counter() - t0
        assert len(ready) == 1000 and not pending
        assert dt < 0.5, f"wait over 1k ready refs took {dt:.3f}s"

        r = slow_one.remote()
        ready, pending = rt.wait([r], num_returns=1, timeout=5)
        assert ready == [r]
