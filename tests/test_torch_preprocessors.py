"""The port's preprocessors (``ray_tpu_torch.data.preprocessors``) on its
cluster runtime, held to the JAX package's on a JAX ``Cluster``: the
counterparts of the 4 preprocessor tests of
``tests/test_dashboard_preprocessors.py``.

Each program takes a data package and returns plain values: fitted
statistics, transformed rows, classes, codes and error classes. The JAX
programs run once per test run on a JAX ``Cluster`` (``_once``), before
this module's port cluster starts in that process. Fitted statistics and
transformed values are float64 sums over the same rows in the same blocks,
held within ``STATS_TOL``; rows, classes and codes must be equal.

The port's fit functions are module-level ``functools.partial``s and its
``transform`` maps a bound method, so they reach the cluster's workers by
import path; nothing here is defined inside a test.
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
STATS_TOL = 1e-12       # float64 sums of the same values, the same order


def _cell(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return np.asarray(v).ravel().tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def plain_rows(rows):
    return [{k: _cell(v) for k, v in r.items()} for r in rows]


def _pre(d):
    return importlib.import_module(f"{d.__name__}.preprocessors")


def prog_standard_scaler(d, root):
    pre = _pre(d)
    rng = np.random.default_rng(0)
    vals = rng.normal(loc=5.0, scale=3.0, size=400)
    ds = d.from_items([{"x": float(v), "keep": i}
                       for i, v in enumerate(vals)])
    sc = pre.StandardScaler(columns=["x"]).fit(ds)
    out = [r["x"] for r in sc.transform(ds).take_all()]
    return {"stats": sc.stats_, "x": out, "mean": float(vals.mean()),
            "first": plain_rows(sc.transform(ds).take(1))}


def prog_minmax_imputer_chain(d, root):
    pre = _pre(d)
    rows = [{"x": float(i)} for i in range(10)]
    rows[3]["x"] = float("nan")
    ds = d.from_items(rows)
    chain = pre.Chain(pre.SimpleImputer(columns=["x"]),
                      pre.MinMaxScaler(columns=["x"])).fit(ds)
    out = [r["x"] for r in chain.transform(ds).take_all()]
    b = chain.transform_batch({"x": np.array([0.0, 9.0])})
    return {"x": out, "batch": b["x"].tolist(),
            "imputed": chain.stages[0].stats_,
            "minmax": chain.stages[1].stats_}


def prog_encoders_concatenator(d, root):
    pre = _pre(d)
    ds = d.from_items([{"color": c, "v": float(i)}
                       for i, c in enumerate(["r", "g", "b", "g", "r"])])
    le = pre.LabelEncoder("color").fit(ds)
    coded = [r["color"] for r in le.transform(ds).take_all()]
    oh = pre.OneHotEncoder(columns=["color"]).fit(ds)
    cat = pre.Concatenator(columns=["v"], output_column="features")
    return {"classes": le.classes_, "coded": coded,
            "onehot": plain_rows(oh.transform(ds).take_all()),
            "features": plain_rows(cat.transform(ds).take(2)),
            "feature_shape": list(np.asarray(
                cat.transform(ds).take(1)[0]["features"]).shape)}


def prog_unfit_transform_raises(d, root):
    pre = _pre(d)
    try:
        pre.StandardScaler(columns=["id"]).transform(d.range(4))
    except Exception as e:  # noqa: BLE001
        return {"error": type(e).__name__, "message": str(e)}
    return {"error": None}


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
    return _once(tmp_path_factory, "torch_preprocessors_jax", _jax_run)


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
# tests/test_dashboard_preprocessors.py
# ---------------------------------------------------------------------------


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=STATS_TOL, atol=STATS_TOL)


def test_standard_scaler(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "standard_scaler", tmp_path)
    for key in ("mean", "std", "min", "max"):
        _close(got["stats"]["x"][key], want["stats"]["x"][key])
    assert got["stats"]["x"]["count"] == want["stats"]["x"]["count"] == 400
    _close(got["x"], want["x"])
    assert got["first"][0]["keep"] == want["first"][0]["keep"] == 0
    assert abs(got["stats"]["x"]["mean"] - got["mean"]) < 1e-6
    out = np.array(got["x"])
    assert abs(out.mean()) < 1e-6 and abs(out.std() - 1.0) < 1e-2


def test_minmax_imputer_chain(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "minmax_imputer_chain", tmp_path)
    _close(got["x"], want["x"])
    assert got["batch"] == want["batch"] == [0.0, 1.0]
    _close(got["imputed"]["x"], want["imputed"]["x"])
    assert got["minmax"] == want["minmax"]
    assert min(got["x"]) == 0.0 and max(got["x"]) == 1.0
    assert not any(np.isnan(got["x"]))


def test_encoders_concatenator(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "encoders_concatenator", tmp_path)
    assert got == want
    assert got["classes"] == ["b", "g", "r"]
    assert got["coded"] == [2, 1, 0, 1, 2]
    row = got["onehot"][0]
    assert row["color_r"] == 1 and row["color_g"] == 0
    assert got["feature_shape"] == [1]


def test_unfit_transform_raises(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "unfit_transform_raises", tmp_path)
    assert got == want
    assert got["error"] == "RuntimeError" and "must be fit" in got["message"]
