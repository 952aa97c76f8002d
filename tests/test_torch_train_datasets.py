"""data -> train on the port: ``TorchTrainer``/``DataParallelTrainer``'s
``datasets=``, ``session.get_dataset_shard`` and the LM packing pipeline
(``ray_tpu_torch.data.llm``) on the port's cluster runtime, held to the JAX
package on a JAX ``Cluster``: the counterparts of the 4 tests of
``tests/test_train_datasets.py``.

- ``tokenize_and_pack`` gives the JAX package's packed rows bitwise.
- Two gloo workers (``use_gpu=False``) each get 20 of 40 rows, as the JAX
  trainer's two workers do; plain and equal splits give JAX's rows.
- The LM pipeline: text -> packed tokens -> a one-worker ``TorchTrainer``
  whose loop runs 3 steps of the port's ``make_lm_train_step(device="cpu")``
  on its shard's first batches (``iter_torch_batches``), from the JAX
  step's initial weights (``params_from_jax``). Its losses are within
  ``STEP_TOL`` of the JAX ``make_lm_train_step`` on the same batches
  (f32); the JAX test's own loop trains JAX in its worker, so the JAX side
  here is that step run in the driver on the JAX dataset's batches.

The loops and data functions are module-level: the port's workers import
this module by name (so it imports no JAX at the top), the JAX workers get
them by value (cloudpickle's pickle-by-value, registered for the JAX run
only). Each loop reads its package from ``config["pkg"]``.
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
STEP_TOL = 1e-4           # the port's train step against JAX's, f32
LM_CFG = dict(vocab_size=258, d_model=32, n_layers=1, n_heads=2, max_seq=32,
              attn_impl="reference")
LM_LR, LM_BATCH, LM_STEPS = 1e-2, 4, 3
DOCS = [{"text": "the quick brown fox jumps over the lazy dog. " * 3}
        for _ in range(8)]

# ---------------------------------------------------------------------------
# loops (run in the workers of either package)
# ---------------------------------------------------------------------------


def _session(config):
    return importlib.import_module(f"{config['pkg']}.air.session")


def loop_shard_rows(config):
    session = _session(config)
    shard = session.get_dataset_shard("train")
    xs = [row["x"] for row in shard.iter_rows()]
    session.report({"count": len(xs), "sum": float(sum(xs)), "xs": xs,
                    "rank": session.get_world_rank()})


def loop_lm_from_shard(config):
    """The port's LM step on the shard's first batches."""
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import transformer as ttf
    from ray_tpu_torch.train import make_lm_train_step
    torch.set_num_threads(1)
    cfg = ttf.TransformerConfig(dtype=torch.float32, **config["cfg"])
    init_fn, step_fn, place = make_lm_train_step(
        cfg, learning_rate=config["lr"], device="cpu")
    state = init_fn(convert.params_from_jax(config["params"], cfg,
                                            device="cpu"))
    shard = session.get_dataset_shard("train")
    losses, tokens = [], []
    for batch in shard.iter_torch_batches(batch_size=LM_BATCH,
                                          drop_last=True):
        if len(losses) == LM_STEPS:
            break
        state, m = step_fn(state, place({"tokens": batch["tokens"]}))
        losses.append(m["loss"].item())
        tokens.append(batch["tokens"].tolist())
    session.report({"losses": losses, "tokens": tokens,
                    "dtype": str(batch["tokens"].dtype)})


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------


def _train(d):
    return importlib.import_module(f"{d.__name__.split('.')[0]}.train")


def _scaling(d, **kw):
    pkg = d.__name__.split(".")[0]
    air = importlib.import_module(f"{pkg}.air.config")
    if pkg == "ray_tpu_torch":
        kw["use_gpu"] = False
    return air.ScalingConfig(**kw)


def _packed(d):
    return d.tokenize_and_pack(d.from_items(DOCS, parallelism=2),
                               seq_len=LM_CFG["max_seq"])


def prog_byte_tokenizer(d, root):
    tok = d.ByteTokenizer()
    ids = tok.encode("hello TPU é")
    return {"ids": ids, "back": tok.decode(ids), "vocab": tok.vocab_size}


def prog_tokenize_and_pack(d, root):
    docs = [{"text": "abcdefgh" * 4} for _ in range(6)]
    packed = d.tokenize_and_pack(d.from_items(docs, parallelism=2),
                                 seq_len=16)
    rows = packed.take_all()
    return {"rows": [np.asarray(r["tokens"]).tolist() for r in rows],
            "blocks": packed.num_blocks(),
            "lm_rows": [np.asarray(r["tokens"]).tolist()
                        for r in _packed(d).take_all()]}


def prog_trainer_dataset_shards(d, root):
    pkg = d.__name__.split(".")[0]
    ds = d.from_items([{"x": float(i)} for i in range(40)], parallelism=4)
    air = importlib.import_module(f"{pkg}.air.config")
    r = _train(d).DataParallelTrainer(
        loop_shard_rows, train_loop_config={"pkg": pkg},
        datasets={"train": ds},
        scaling_config=_scaling(d, num_workers=2,
                                resources_per_worker={"CPU": 1}),
        run_config=air.RunConfig(storage_path=root, name="shards")).fit()
    splits = ds.split(2)
    eq = ds.split(3, equal=True)
    return {"error": None if r.error is None else repr(r.error),
            "metrics": r.metrics,
            "splits": [[x["x"] for x in s.take_all()] for s in splits],
            "equal": [[x["x"] for x in s.take_all()] for s in eq],
            "equal_counts": [s.count() for s in eq]}


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


def _jax_lm(d):
    """The JAX step on build_mesh(MeshSpec(dp=1)) over the JAX dataset's
    first batches: its initial weights (numpy), the batches and losses."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtf
    from ray_tpu.parallel import MeshSpec, build_mesh
    from ray_tpu.train import make_lm_train_step
    cfg = jtf.TransformerConfig(dtype=jnp.float32, **LM_CFG)
    mesh = build_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    init_fn, step_fn, place = make_lm_train_step(cfg, mesh,
                                                 learning_rate=LM_LR)
    state = init_fn(jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, state.params)  # the step donates it
    losses, tokens = [], []
    for batch in _packed(d).iter_batches(batch_size=LM_BATCH,
                                         drop_last=True):
        if len(losses) == LM_STEPS:
            break
        state, m = step_fn(state, place({"tokens": batch["tokens"]}))
        losses.append(float(m["loss"]))
        tokens.append(np.asarray(batch["tokens"]).tolist())
    return {"params": init, "losses": losses, "tokens": tokens}


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
            d = importlib.import_module("ray_tpu.data")
            out = _run_all(d, root)
            out["_lm"] = _jax_lm(d)
            return out
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
    return _once(tmp_path_factory, "torch_train_datasets_jax", _jax_run)


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
# tests/test_train_datasets.py
# ---------------------------------------------------------------------------


def test_byte_tokenizer_roundtrip(jax_runs, tmp_path):
    got, want = _both(jax_runs, "byte_tokenizer", tmp_path)
    assert got == want
    ids = got["ids"]
    assert ids[0] == 256 and ids[-1] == 257
    assert got["back"] == "hello TPU é"
    assert max(ids) < got["vocab"]


def test_tokenize_and_pack(cluster, jax_runs, tmp_path):
    """The port packs JAX's rows bitwise."""
    got, want = _both(jax_runs, "tokenize_and_pack", tmp_path)
    assert got == want
    assert got["rows"], "packing produced no sequences"
    arr = np.asarray(got["rows"])
    assert arr.shape[1:] == (16,)
    assert (arr >= 0).all() and (arr < 258).all()
    import ray_tpu_torch.data as d
    packed = d.tokenize_and_pack(d.from_items(DOCS, parallelism=2),
                                 seq_len=16)
    assert next(packed.iter_batches(batch_size=2))["tokens"].dtype == \
        np.int32


def test_trainer_dataset_shards(cluster, jax_runs, tmp_path):
    got, want = _both(jax_runs, "trainer_dataset_shards", tmp_path)
    assert got == want
    assert got["error"] is None
    # EQUAL-row sharding: both ranks see exactly total//n rows (required
    # so collective-per-step loops run the same step count everywhere)
    assert got["metrics"]["count"] == 20
    assert got["metrics"]["xs"] == [float(i) for i in range(20)]
    assert sorted(x for s in got["splits"] for x in s) == \
        [float(i) for i in range(40)]
    # equal split with a remainder: 40 rows, 3 ways -> 13 each, 1 dropped
    assert got["equal_counts"] == [13, 13, 13]
    seen = sorted(x for s in got["equal"] for x in s)
    assert len(seen) == 39 and len(set(seen)) == 39


def test_lm_pipeline_to_train_step(cluster, jax_runs, tmp_path):
    """Text -> packed dataset -> shard -> the port's LM step in a
    TorchTrainer worker: within STEP_TOL of JAX's step on the same batches
    and weights, and the loss goes down."""
    import ray_tpu_torch.data as d
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    lm = jax_runs["_lm"]
    r = TorchTrainer(
        loop_lm_from_shard,
        train_loop_config={"cfg": LM_CFG, "lr": LM_LR,
                           "params": lm["params"]},
        datasets={"train": _packed(d)},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(storage_path=str(tmp_path), name="lm")).fit()
    assert r.error is None, r.error
    got = r.metrics
    assert got["dtype"] == "torch.int32"
    assert got["tokens"] == lm["tokens"]
    assert len(got["losses"]) == LM_STEPS
    np.testing.assert_allclose(got["losses"], lm["losses"], rtol=STEP_TOL)
    assert got["losses"][-1] < got["losses"][0]
