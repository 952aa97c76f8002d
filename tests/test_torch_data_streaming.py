"""The port's streaming executor and push-based shuffle
(``ray_tpu_torch.data.streaming``, ``data/shuffle.py``) on its cluster
runtime, held to the JAX package's on a JAX ``Cluster``: the counterparts of
the 8 tests of ``tests/test_data_streaming.py``.

Each program takes a data package and a scratch directory and returns plain
values. The JAX programs run once per test run on a JAX ``Cluster``
(``_once``), before this module's port cluster starts in that process; each
test runs its program on the port and compares: rows in order (the
streaming order, the seeded shuffle's, the naive shuffle's), counts, block
counts and error classes. Timings are the port's own and are held to the
JAX test's bounds, not to the JAX run's numbers.

The data functions are module-level: the port's workers import this module
by name (so it imports no JAX at the top), the JAX workers get them by
value (cloudpickle's pickle-by-value, registered for the JAX run only).
"""

import fcntl
import functools
import importlib
import os
import pickle
import tempfile
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster.cluster_utils import Cluster

HEAD_CPUS = 8             # the JAX test's cluster
PER_TASK_S = 0.15

# ---------------------------------------------------------------------------
# data functions (run in the workers of either package)
# ---------------------------------------------------------------------------


def identity(b):
    return b


def slow(b):
    time.sleep(PER_TASK_S)
    return b


def triple_id(b):
    return {"id": b["id"] * 3}


def boom(b):
    raise RuntimeError("bad batch")


def touch(b, marker):
    with open(marker, "a") as f:
        f.write("x\n")
    return b


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------


def _ids(block):
    """A block's ids: a pyarrow Table's column or the port's array."""
    return np.asarray(block["id"]).tolist()


def prog_multi_stage_overlap(d, root):
    n_blocks = 8

    def plan():
        return d.range(n_blocks * 10, parallelism=n_blocks) \
            .map_batches(slow).map_batches(slow)

    # warm the worker pool with the same plan: the timing measures
    # PIPELINING, not cold-start process spawns and imports, which on a
    # loaded host take longer than the whole serial sum
    plan().count()
    ds = plan()
    t0 = time.perf_counter()
    count = ds.count()
    return {"count": count, "seconds": time.perf_counter() - t0,
            "serial": 2 * n_blocks * PER_TASK_S}


def prog_streaming_preserves_order(d, root):
    ds = d.range(64, parallelism=8).map_batches(triple_id)
    return [r["id"] for r in ds.take_all()]


def prog_streaming_error_propagates(d, root):
    ds = d.range(8, parallelism=2).map_batches(boom)
    try:
        ds.take_all()
    except Exception as e:  # noqa: BLE001
        return {"error": type(e).__name__, "bad_batch": "bad batch" in str(e)}
    return {"error": None}


def prog_limit_stops_consumption(d, root):
    return [r["id"] for r in d.range(1000, parallelism=20).limit(15)
            .take_all()]


def prog_abandoned_iterator_stops_plan(d, root):
    marker = os.path.join(tempfile.mkdtemp(dir=root), "touched")
    ds = d.range(400, parallelism=40).map_batches(
        functools.partial(touch, marker=marker))
    rows = ds.take(5)
    time.sleep(1.0)  # give a (wrongly) eager pump time to run everything
    with open(marker) as f:
        touched = len(f.readlines())
    return {"rows": [r["id"] for r in rows], "touched": touched}


def prog_push_shuffle_correct(d, root):
    rows = [r["id"] for r in d.range(200, parallelism=5)
            .random_shuffle(seed=7).take_all()]
    again = [r["id"] for r in d.range(200, parallelism=5)
             .random_shuffle(seed=7).take_all()]
    return {"rows": rows, "again": again}


def prog_repartition_push(d, root):
    ds = d.range(90, parallelism=3).repartition(6)
    return {"blocks": ds.num_blocks(),
            "rows": [r["id"] for r in ds.take_all()]}


def prog_push_vs_simple_shuffle_perf(d, root):
    pkg = d.__name__.split(".")[0]
    dataset = importlib.import_module(f"{pkg}.data.dataset")
    shuffle = importlib.import_module(f"{pkg}.data.shuffle")
    get = importlib.import_module(pkg).get
    refs = d.range(20_000, parallelism=16).materialize().materialize_refs()

    def submit(fn, *args):
        return dataset._remote_for(fn).remote(*args)

    # warm the worker pool so neither contender pays cold process spawns
    d.range(64, parallelism=16).map_batches(identity).count()
    t0 = time.perf_counter()
    simple = dataset._simple_shuffle(list(refs), submit, 16, 3)
    simple_blocks = get(simple, timeout=300)
    t_simple = time.perf_counter() - t0
    t0 = time.perf_counter()
    push = shuffle.push_based_shuffle(list(refs), submit, 16, 3)
    push_blocks = get(push, timeout=300)
    t_push = time.perf_counter() - t0
    return {"simple": [_ids(b) for b in simple_blocks],
            "push": [_ids(b) for b in push_blocks],
            "t_simple": t_simple, "t_push": t_push}


PROGRAMS = {name[len("prog_"):]: fn for name, fn in sorted(globals().items())
            if name.startswith("prog_")}


# ---------------------------------------------------------------------------
# running them
# ---------------------------------------------------------------------------


def _run_all(d, root):
    out = {}
    for name, prog in PROGRAMS.items():
        where = os.path.join(root, name)
        os.makedirs(where, exist_ok=True)
        try:
            out[name] = ("value", prog(d, where))
        except Exception as e:  # noqa: BLE001
            out[name] = ("raised", type(e).__name__, str(e)[:300])
    return out


def _jax_run(root):
    import sys

    import cloudpickle

    from ray_tpu.cluster.cluster_utils import Cluster as JaxCluster
    from ray_tpu.core import api
    from ray_tpu.core.runtime_cluster import ClusterRuntime
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    c = JaxCluster(initialize_head=True,
                   head_node_args={"num_cpus": HEAD_CPUS})
    try:
        api._runtime = ClusterRuntime(address=c.address)
        try:
            return _run_all(importlib.import_module("ray_tpu.data"), root)
        finally:
            api._runtime.shutdown()
            api._runtime = None
    finally:
        c.shutdown()
        cloudpickle.unregister_pickle_by_value(module)


def _once(tmp_path_factory, name, compute):
    """``compute(dir)`` once for the whole run, its result shared by the
    xdist workers through a pickle under the run's temporary root (a file
    lock lets one compute while the others wait)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            result = compute(str(tmp_path_factory.mktemp(name)))
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return _once(tmp_path_factory, "torch_data_streaming_jax", _jax_run)


@pytest.fixture(scope="module")
def cluster(jax_runs):
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": HEAD_CPUS})
    rt.shutdown()    # whatever runtime an earlier module left in this worker
    rt.init(address=c.address)
    prefixes = {n.store_prefix for n in c.nodes}
    yield c
    rt.shutdown()
    c.shutdown()
    deadline = time.monotonic() + 10.0
    while _store_files(prefixes) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _store_files(prefixes)


def _store_files(prefixes):
    return [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p) for p in prefixes)]


def _both(jax_runs, name, tmp_path):
    """(the port's value, the JAX value) of one program."""
    want = jax_runs[name]
    assert want[0] == "value", f"the JAX cluster raised: {want}"
    import ray_tpu_torch.data as d
    return PROGRAMS[name](d, str(tmp_path)), want[1]


# ---------------------------------------------------------------------------
# tests/test_data_streaming.py
# ---------------------------------------------------------------------------


def test_multi_stage_overlap(cluster, jax_runs, tmp_path):
    """Two slow map stages over 8 blocks: with cross-stage pipelining the
    wall clock is well under the serial sum."""
    got, want = _both(jax_runs, "multi_stage_overlap", tmp_path)
    assert got["count"] == want["count"] == 80
    print(f"port {got['seconds']:.2f}s, JAX {want['seconds']:.2f}s")
    assert got["seconds"] < got["serial"] * 0.8, (
        f"no pipeline overlap: {got['seconds']:.2f}s vs serial "
        f"{got['serial']:.2f}s")


def test_streaming_preserves_order(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "streaming_preserves_order", tmp_path)
    assert got == want == [3 * i for i in range(64)]


def test_streaming_error_propagates(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "streaming_error_propagates", tmp_path)
    assert got == want
    assert got["error"] is not None and got["bad_batch"]


def test_limit_stops_consumption(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "limit_stops_consumption", tmp_path)
    assert got == want == list(range(15))


def test_abandoned_iterator_stops_plan(cluster, jax_runs, tmp_path):
    """take(n) without limit(): abandoning the block iterator cancels the
    pump — the executor must not eagerly run the whole plan."""
    got, want = _both(jax_runs, "abandoned_iterator_stops_plan", tmp_path)
    assert got["rows"] == want["rows"] == list(range(5))
    assert got["touched"] < 40, f"plan ran eagerly: {got['touched']}/40"


def test_push_shuffle_correct(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "push_shuffle_correct", tmp_path)
    assert got == want
    rows = got["rows"]
    assert sorted(rows) == list(range(200))
    # byte-deterministic for a fixed seed: the EXACT row sequence repeats
    # (fold order follows map index, not completion order)
    assert got["again"] == rows
    assert rows != list(range(200))


def test_repartition_push(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "repartition_push", tmp_path)
    assert got == want
    assert got["blocks"] == 6
    assert sorted(got["rows"]) == list(range(90))


def test_push_vs_simple_shuffle_perf(cluster, jax_runs, tmp_path):
    """Both shuffles on the same data: the same rows in the same order as
    JAX's, and push-based not slower than the JAX test's bound."""
    got, want = _both(jax_runs, "push_vs_simple_shuffle_perf", tmp_path)
    assert got["push"] == want["push"]
    assert got["simple"] == want["simple"]
    push = sorted(i for b in got["push"] for i in b)
    assert push == sorted(i for b in got["simple"] for i in b)
    assert push == list(range(20_000))
    print(f"simple={got['t_simple']:.2f}s push={got['t_push']:.2f}s")
    assert got["t_push"] < 3.0 * got["t_simple"] + 2.0
