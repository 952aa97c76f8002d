"""The port's data library (``ray_tpu_torch.data``) on its cluster runtime,
held to the JAX package's on a JAX ``Cluster``: the counterparts of the 13
tests of ``tests/test_data.py``.

Each test's program takes a data package and a scratch directory and
returns plain values: rows (tensor cells flattened to lists), counts,
block counts, batch sizes and schema names and types. The JAX programs run
once per test run on a JAX ``Cluster`` (``_once``: the xdist workers share
one pickle), before this module's port cluster starts in that process; each
test runs its program on the port and compares. Rows must be equal and in
the same order wherever the JAX order is determined (map, filter,
flat_map, split, sort, seeded shuffle, repartition); groupby results are
compared sorted by key. Each test then holds the port to the JAX test's own
assertions.

The data functions are module-level: the port's workers import this module
by name (so it imports no JAX at the top), the JAX workers get them by
value (cloudpickle's pickle-by-value, registered for the JAX run only).
"""

import fcntl
import importlib
import os
import pickle
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster.cluster_utils import Cluster

HEAD_CPUS = 4

# ---------------------------------------------------------------------------
# data functions (run in the workers of either package)
# ---------------------------------------------------------------------------


def double_id(b):
    return {"id": b["id"] * 2}


def plus_one(b):
    return {"id": b["id"] + 1}


def item_doubled(r):
    return {"v": r["item"] * 2}


def item_is_even(r):
    return r["item"] % 2 == 0


def twice(r):
    return [r, r]


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------


def _cell(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return np.asarray(v).ravel().tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def plain_rows(rows):
    """Rows -> plain dicts (a tensor cell, a list in JAX and an ndarray in
    the port, becomes its flat list)."""
    return [{k: _cell(v) for k, v in r.items()} for r in rows]


_ARROW_TYPES = {"int64": "int64", "double": "float64", "string": "str",
                "bool": "bool"}


def plain_schema(schema):
    """A pyarrow schema or the port's ``{name: (dtype, shape)}`` ->
    ``[(name, type)]``."""
    if isinstance(schema, dict):
        return [(k, "str" if dt == object else str(dt))
                for k, (dt, _shape) in schema.items()]
    return [(f.name, _ARROW_TYPES.get(str(f.type), str(f.type)))
            for f in schema]


def prog_range_count_take(d, root):
    ds = d.range(100, parallelism=4)
    return {"count": ds.count(), "take": plain_rows(ds.take(3)),
            "blocks": ds.num_blocks()}


def prog_map_batches(d, root):
    return plain_rows(d.range(32, parallelism=2).map_batches(double_id)
                      .take_all())


def prog_map_filter_flatmap(d, root):
    ds = d.from_items([1, 2, 3, 4, 5, 6])
    return {"doubled": plain_rows(ds.map(item_doubled).take_all()),
            "evens": plain_rows(ds.filter(item_is_even).take_all()),
            "flat": plain_rows(ds.limit(2).flat_map(twice).take_all())}


def prog_repartition_and_shuffle(d, root):
    ds = d.range(64, parallelism=2).repartition(8)
    shuffled = d.range(64, parallelism=4).random_shuffle(seed=7)
    return {"blocks": ds.num_blocks(), "count": ds.count(),
            "repartitioned": [r["id"] for r in ds.take_all()],
            "shuffled": [r["id"] for r in shuffled.take_all()]}


def prog_sort(d, root):
    ds = d.from_items([{"k": v} for v in [5, 3, 9, 1, 7]])
    return {"asc": [r["k"] for r in ds.sort("k").take_all()],
            "desc": [r["k"] for r in ds.sort("k", descending=True)
                     .take_all()]}


def prog_groupby_agg(d, root):
    rows = [{"g": i % 3, "v": float(i)} for i in range(30)]
    out = d.from_items(rows).groupby("g").sum("v").take_all()
    return sorted(tuple(sorted(r.items())) for r in plain_rows(out))


def prog_iter_batches_sizes(d, root):
    ds = d.range(100, parallelism=5)
    return {"sizes": [len(b["id"]) for b in ds.iter_batches(batch_size=32)],
            "dropped": [len(b["id"]) for b in ds.iter_batches(
                batch_size=32, drop_last=True)],
            "ids": [np.asarray(b["id"]).tolist()
                    for b in ds.iter_batches(batch_size=32)]}


def prog_tensor_columns(d, root):
    imgs = np.random.default_rng(0).random((10, 4, 4)).astype(np.float32)
    batch = next(d.from_numpy(imgs, column="img").iter_batches(
        batch_size=10, batch_format="numpy"))
    return {"shape": list(batch["img"].shape),
            "dtype": str(batch["img"].dtype),
            "equal": bool(np.array_equal(batch["img"], imgs))}


def prog_parquet_roundtrip(d, root):
    path = os.path.join(root, "pq")
    d.range(50, parallelism=2).write_parquet(path)
    back = d.read_parquet(path)
    return {"count": back.count(), "ids": [r["id"] for r in back.take_all()],
            "files": sorted(os.listdir(path))}


def prog_csv_roundtrip(d, root):
    path = os.path.join(root, "csv")
    d.from_items([{"a": i, "b": i * 2} for i in range(10)]).write_csv(path)
    back = d.read_csv(path)
    return {"count": back.count(), "rows": plain_rows(back.take_all()),
            "schema": plain_schema(back.schema())}


def prog_split_and_union(d, root):
    ds = d.range(40, parallelism=4)
    parts = ds.split(2)
    u = parts[0].union(parts[1])
    return {"counts": [p.count() for p in parts],
            "parts": [[r["id"] for r in p.take_all()] for p in parts],
            "union": [r["id"] for r in u.take_all()]}


def prog_pipeline_repeat(d, root):
    pipe = d.range(8, parallelism=2).repeat(3)
    return [len(b["id"]) for b in pipe.iter_batches(batch_size=4)]


def prog_streaming_executes_lazily(d, root):
    mapped = d.range(10, parallelism=2).map_batches(plus_one)
    lazy = mapped._materialized is None
    return {"lazy": lazy, "first": plain_rows(mapped.take(1))}


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
    return _once(tmp_path_factory, "torch_data_jax", _jax_run)


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
# tests/test_data.py
# ---------------------------------------------------------------------------


def test_range_count_take(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "range_count_take", tmp_path)
    assert got == want
    assert got == {"count": 100, "take": [{"id": 0}, {"id": 1}, {"id": 2}],
                   "blocks": 4}


def test_map_batches(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "map_batches", tmp_path)
    assert got == want
    assert [r["id"] for r in got] == [2 * i for i in range(32)]


def test_map_filter_flatmap(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "map_filter_flatmap", tmp_path)
    assert got == want
    assert [r["v"] for r in got["doubled"]] == [2, 4, 6, 8, 10, 12]
    assert [r["item"] for r in got["evens"]] == [2, 4, 6]
    assert len(got["flat"]) == 4


def test_repartition_and_shuffle(cluster, jax_runs, tmp_path):
    """A seeded shuffle gives JAX's rows in JAX's order: the same seeded
    draws in the same order."""
    got, want = _both(jax_runs, "repartition_and_shuffle", tmp_path)
    assert got == want
    assert got["blocks"] == 8 and got["count"] == 64
    assert sorted(got["shuffled"]) == list(range(64))
    assert got["shuffled"] != list(range(64))


def test_sort(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "sort", tmp_path)
    assert got == want
    assert got == {"asc": [1, 3, 5, 7, 9], "desc": [9, 7, 5, 3, 1]}


def test_groupby_agg(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "groupby_agg", tmp_path)
    assert got == want
    expect = {}
    for i in range(30):
        expect[i % 3] = expect.get(i % 3, 0.0) + float(i)
    assert {dict(r)["g"]: dict(r)["v_sum"] for r in got} == expect


def test_iter_batches_sizes(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "iter_batches_sizes", tmp_path)
    assert got == want
    assert got["sizes"] == [32, 32, 32, 4]
    assert got["dropped"] == [32, 32, 32]


def test_tensor_columns(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "tensor_columns", tmp_path)
    assert got == want
    assert got == {"shape": [10, 4, 4], "dtype": "float32", "equal": True}


def test_parquet_roundtrip(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "parquet_roundtrip", tmp_path)
    assert got == want
    assert got["count"] == 50
    assert sorted(got["ids"]) == list(range(50))


def test_csv_roundtrip(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "csv_roundtrip", tmp_path)
    assert got == want
    assert got["count"] == 10
    assert got["schema"] == [("a", "int64"), ("b", "int64")]


def test_split_and_union(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "split_and_union", tmp_path)
    assert got == want
    assert sum(got["counts"]) == 40
    assert len(got["union"]) == 40


def test_pipeline_repeat(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "pipeline_repeat", tmp_path)
    assert got == want
    assert sum(got) == 24


def test_streaming_executes_lazily(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "streaming_executes_lazily", tmp_path)
    assert got == want
    assert got == {"lazy": True, "first": [{"id": 1}]}
