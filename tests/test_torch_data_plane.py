"""The port's data-plane fast path on a port ``Cluster``: the counterparts
of the 8 tests of ``tests/test_data_plane_fastpath.py``.

Windowed multi-source pull, same-host shm-direct copy, load-spread
broadcast, and the batched wait()/contains path of
``ray_tpu_torch/cluster/object_plane.py`` (ported from
``ray_tpu/cluster/object_plane.py``). Each test runs the JAX test's body
against the port's classes, with the same payloads and seeds.

The TCP-path tests disable object_pull_shm_direct: every daemon here
shares this host's /dev/shm, so the default config would satisfy pulls
with the segment-copy fast path and never touch the chunk window."""

import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import config
from ray_tpu_torch.cluster import fault_plane
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.cluster.object_plane import ObjectPlane, _ByteBudget
from ray_tpu_torch.cluster.protocol import get_client
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.runtime_cluster import ClusterRuntime


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "num_gpus": 0,
                                "object_store_bytes": 512 << 20})
    rt_ = ClusterRuntime(address=c.address)
    core_api._runtime = rt_
    yield c
    core_api._runtime = None
    rt_.shutdown()
    c.shutdown()


@pytest.fixture(autouse=True)
def _clean_overrides():
    yield
    for flag in ("object_pull_shm_direct", "object_transfer_chunk_bytes",
                 "object_stripe_min_bytes", "object_pull_window"):
        config.clear_override(flag)
    fault_plane.clear_plan()


def _head_node(runtime):
    return {"node_id": runtime.plane.node_id,
            "address": runtime.daemon_address}


def _store_bytes(store, key):
    view = store.get(key, timeout=5.0)
    assert view is not None
    try:
        return bytes(view)
    finally:
        store.release(key)


def _push_until_held(runtime, key, node, timeout=20.0):
    """Replicate a head-held object onto ``node`` via the push path."""
    assert runtime.push_mgr.maybe_push(key, node.address)
    deadline = time.time() + timeout
    while time.time() < deadline:
        if get_client(node.address).call("object_info", oid=key)["found"]:
            return
        time.sleep(0.05)
    raise AssertionError("push never landed on the replica node")


def test_windowed_pull_out_of_order_chunks(cluster):
    """A many-chunk pull (chunk size shrunk to 64KiB, window 4) must
    reassemble the exact payload even though completions land out of
    order via write_at."""
    runtime = core_api._runtime
    n2 = cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes(2)
    try:
        config.set_override("object_pull_shm_direct", False)
        config.set_override("object_transfer_chunk_bytes", 64 << 10)
        payload = np.random.default_rng(7).integers(
            0, 256, 1 << 20, dtype=np.uint8)
        ref = rt.put(payload)
        key = runtime.plane._key(ref.id)
        plane2 = ObjectPlane(n2.store, n2.node_id, cluster.address)
        assert plane2._pull(key, runtime.daemon_address) == "ok"
        assert _store_bytes(n2.store, key) == \
            _store_bytes(runtime.plane.store, key)
    finally:
        cluster.remove_node(n2, graceful=True)


def test_shm_direct_pull_skips_chunk_stream(cluster):
    """Same-host pull with the default config takes the segment-copy fast
    path: content is identical and the holder daemon serves ZERO chunks."""
    runtime = core_api._runtime
    n2 = cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes(2)
    try:
        payload = np.random.default_rng(11).integers(
            0, 256, 1 << 20, dtype=np.uint8)
        ref = rt.put(payload)
        key = runtime.plane._key(ref.id)
        head = get_client(runtime.daemon_address)
        served_before = head.call("object_info", oid=key)["served"]
        plane2 = ObjectPlane(n2.store, n2.node_id, cluster.address)
        assert plane2._pull(key, runtime.daemon_address) == "ok"
        assert _store_bytes(n2.store, key) == \
            _store_bytes(runtime.plane.store, key)
        assert head.call("object_info", oid=key)["served"] == served_before
    finally:
        cluster.remove_node(n2, graceful=True)


@pytest.mark.chaos
def test_striped_pull_survives_holder_sever(cluster, chaos_seed):
    """Mid-transfer sever of one of two stripe sources: the survivor
    absorbs the dead holder's remaining chunks and the pull completes
    without ObjectLostError."""
    runtime = core_api._runtime
    n2 = cluster.add_node(num_cpus=1)  # replica holder
    n3 = cluster.add_node(num_cpus=1)  # puller
    cluster.wait_for_nodes(3)
    try:
        config.set_override("object_pull_shm_direct", False)
        config.set_override("object_transfer_chunk_bytes", 64 << 10)
        config.set_override("object_stripe_min_bytes", 64 << 10)
        payload = np.random.default_rng(13).integers(
            0, 256, 1 << 20, dtype=np.uint8)
        ref = rt.put(payload)
        key = runtime.plane._key(ref.id)
        _push_until_held(runtime, key, n2)

        # Sever the head holder's pipe on its 2nd assigned chunk.
        fault_plane.load_plan(
            [{"site": "object.pull.window",
              "match": {"holder": runtime.daemon_address},
              "action": "sever", "nth": 2, "times": 1}],
            seed=chaos_seed)
        plane3 = ObjectPlane(n3.store, n3.node_id, cluster.address)
        outcome = plane3._pull_from(
            key, [_head_node(runtime),
                  {"node_id": n2.node_id, "address": n2.address}])
        assert outcome == "ok"
        assert fault_plane.stats().get("object.pull.window") == 1
        assert _store_bytes(n3.store, key) == \
            _store_bytes(runtime.plane.store, key)
    finally:
        cluster.remove_node(n3, graceful=True)
        cluster.remove_node(n2, graceful=True)


def test_broadcast_reads_from_multiple_sources(cluster):
    """4-node broadcast: once a replica registers, later pullers stripe
    across origin + replica — at least two distinct daemons serve chunks
    (the load-spread / implicit-tree property)."""
    runtime = core_api._runtime
    peers = [cluster.add_node(num_cpus=1) for _ in range(3)]
    cluster.wait_for_nodes(4)
    try:
        config.set_override("object_pull_shm_direct", False)
        config.set_override("object_transfer_chunk_bytes", 64 << 10)
        config.set_override("object_stripe_min_bytes", 64 << 10)
        payload = np.random.default_rng(17).integers(
            0, 256, 2 << 20, dtype=np.uint8)
        ref = rt.put(payload)
        key = runtime.plane._key(ref.id)
        planes = [ObjectPlane(n.store, n.node_id, cluster.address)
                  for n in peers]

        # First hop: one replica pulls, then registers its copy.
        view = planes[0].get_view(ref.id, timeout=30)
        assert view is not None
        deadline = time.time() + 10
        while time.time() < deadline:
            loc = runtime.plane.conductor.call("locate_object", oid=key)
            if len(loc["nodes"]) >= 2:
                break
            time.sleep(0.05)
        assert len(loc["nodes"]) >= 2, "replica never registered"

        # Second wave: the remaining peers pull concurrently; striping
        # spreads their chunk ranges across origin + replica.
        errs = []

        def one(p):
            try:
                assert p.get_view(ref.id, timeout=30) is not None
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=one, args=(p,), name=f"pull-{i}",
                               daemon=True)
              for i, p in enumerate(planes[1:])]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errs

        servers = 0
        for addr in [runtime.daemon_address, peers[0].address]:
            if get_client(addr).call("object_info", oid=key)["served"] > 0:
                servers += 1
        assert servers >= 2, "broadcast never spread beyond the origin"
    finally:
        for n in reversed(peers):
            cluster.remove_node(n, graceful=True)


def test_wait_batched_readiness(cluster):
    """wait() resolves many already-ready refs through the single
    contains_batch round trip."""
    refs = [rt.put(i) for i in range(300)]
    ready, pending = rt.wait(refs, num_returns=300, timeout=30)
    assert len(ready) == 300 and not pending
    ready1, pending1 = rt.wait(refs, num_returns=1, timeout=30)
    assert len(ready1) == 1 and len(pending1) == 299


def test_contains_batch_states(cluster):
    """contains_batch: sealed=True; unsealed (mid-create) and absent=False
    — sealing stays the visibility barrier, matching contains()."""
    runtime = core_api._runtime
    plane = runtime.plane
    sealed = rt.put(b"sealed-object")
    absent_key = os.urandom(16)
    unsealed_key = os.urandom(16)
    w = plane.store.create_writer(unsealed_key, 4)
    try:
        w.write_at(0, b"abcd")
        flags = plane.store.contains_batch(
            [plane._key(sealed.id), absent_key, unsealed_key])
        assert flags == [True, False, False]
    finally:
        w.close()
        plane.store.delete(unsealed_key)


def test_byte_budget_fifo_ordering():
    """acquire() wakes strictly in arrival order: a small late request
    cannot starve (or overtake) an earlier large one."""
    b = _ByteBudget(100)
    b.acquire(100)
    order = []

    def worker(name, n):
        b.acquire(n)
        order.append(name)
        time.sleep(0.05)
        b.release(n)

    t_big = threading.Thread(target=worker, args=("big", 100),
                             name="budget-big", daemon=True)
    t_big.start()
    time.sleep(0.15)  # big is parked at the queue head
    t_small = threading.Thread(target=worker, args=("small", 1),
                               name="budget-small", daemon=True)
    t_small.start()
    time.sleep(0.15)
    b.release(100)
    t_big.join(5.0)
    t_small.join(5.0)
    assert order == ["big", "small"]


def test_put_blob_inline_small(cluster):
    """put_blob takes the one-round-trip inline path for small blobs and
    the writer path for large ones; both read back identically."""
    runtime = core_api._runtime
    plane = runtime.plane
    small = os.urandom(1 << 10)
    large = os.urandom(256 << 10)
    sid = ObjectID(os.urandom(20))
    lid = ObjectID(os.urandom(20))
    plane.put_blob(sid, small)
    plane.put_blob(lid, large)
    assert _store_bytes(plane.store, plane._key(sid)) == small
    assert _store_bytes(plane.store, plane._key(lid)) == large
