"""The port's ``air`` (``ScalingConfig`` and the run configs, ``Checkpoint``,
``Result``, the session) and its trainer on the in-process runtime, held to
the JAX package's ``ray_tpu.air``.

- Dict checkpoints of numpy values written by either package's
  ``to_directory`` load in the other, with equal values; the trainer's
  persisted-checkpoint layout and its restore fallback chain
  (``checkpoint_latest``, ``.tmp``, ``.old``, the ``_COMPLETE`` marker) give
  the JAX package's choices on the same directories.
- The configs have the JAX package's fields and defaults, but for the
  accelerator: ``use_gpu`` and ``gpus_per_worker`` (``None`` is one card a
  worker), ``topology`` refused. CPU configs ask for the JAX package's
  resources.
- A tensor in a dict checkpoint is a host copy, taken when the checkpoint
  is made.
- On the in-process runtime a one-rank gang runs (with ``TorchTrainer``, a
  one-rank gloo group that is gone afterwards) and a larger one raises.

No cluster runs here; the in-process tests swap the port's runtime in and
put back whatever runtime this worker held.
"""

import dataclasses
import functools
import os
import pickle

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.air import config as tconfig
from ray_tpu_torch.air import session as tsession
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.core import serialization
from ray_tpu_torch.train import torch_utils
from ray_tpu_torch.train import trainer as ttrainer


def _tree():
    rng = np.random.default_rng(0)
    return {"step": 7, "w": rng.normal(size=(3, 4)).astype(np.float32),
            "opt": {"mu": rng.normal(size=(4,)), "count": np.int64(3)},
            "names": ["a", "b"]}


def _assert_tree_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_dict_checkpoint_written_by_the_port_loads_in_jax(tmp_path):
    from ray_tpu.air.checkpoint import Checkpoint as JaxCheckpoint
    path = Checkpoint.from_dict(_tree()).to_directory(str(tmp_path / "c"))
    assert os.listdir(path) == ["_dict_checkpoint.pkl"]
    _assert_tree_equal(JaxCheckpoint.from_directory(path).to_dict(),
                       _tree())


def test_dict_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
    from ray_tpu.air.checkpoint import Checkpoint as JaxCheckpoint
    path = JaxCheckpoint.from_dict(_tree()).to_directory(str(tmp_path / "c"))
    _assert_tree_equal(Checkpoint.from_directory(path).to_dict(), _tree())


def test_directory_checkpoint_packs_its_files_like_jax(tmp_path):
    """A directory checkpoint pickles as a tar of its files, unpacked into
    a fresh directory on load; its raw files read back as bytes."""
    from ray_tpu.air.checkpoint import Checkpoint as JaxCheckpoint
    src = tmp_path / "d"
    src.mkdir()
    (src / "weights.bin").write_bytes(b"\x00\x01\x02")
    (src / "meta.txt").write_text("step=3")
    got = serialization.loads(serialization.dumps(
        Checkpoint.from_directory(str(src))))
    want = pickle.loads(pickle.dumps(JaxCheckpoint.from_directory(str(src))))
    assert got.path != str(src) and want.path != str(src)
    assert got.to_dict() == want.to_dict() == {
        "weights.bin": b"\x00\x01\x02", "meta.txt": b"step=3"}


def test_tensors_in_a_checkpoint_are_host_copies():
    w = torch.ones(3, requires_grad=True)
    b = torch.zeros(2, dtype=torch.bfloat16)
    ck = Checkpoint.from_dict({"params": {"w": w, "layers": [b]}})
    got = ck.to_dict()["params"]
    with torch.no_grad():
        w.add_(1.0)        # an optimizer's in-place update
        b.add_(1.0)
    assert got["w"].device.type == "cpu" and not got["w"].requires_grad
    assert torch.equal(got["w"], torch.ones(3))
    assert got["layers"][0].dtype == torch.bfloat16
    assert torch.equal(got["layers"][0], torch.zeros(2, dtype=torch.bfloat16))
    back = serialization.loads(serialization.dumps(ck)).to_dict()
    assert torch.equal(back["params"]["w"], torch.ones(3))


# ---------------------------------------------------------------------------
# the trainer's persisted checkpoints
# ---------------------------------------------------------------------------


def _layout(root, marked):
    """checkpoint_latest[.tmp|.old] directories; ``marked`` holds the ones
    with the _COMPLETE marker."""
    for name in ("checkpoint_latest", "checkpoint_latest.tmp",
                 "checkpoint_latest.old"):
        if name in marked or name + "?" in marked:
            d = root / name
            d.mkdir(parents=True)
            if name in marked:
                (d / "_COMPLETE").write_text("1")


@pytest.mark.parametrize("marked", [
    (), ("checkpoint_latest",), ("checkpoint_latest?",),
    ("checkpoint_latest?", "checkpoint_latest.tmp"),
    ("checkpoint_latest.tmp?", "checkpoint_latest.old"),
    ("checkpoint_latest.old",)])
def test_restore_fallback_chain_picks_what_jax_picks(tmp_path, marked):
    from ray_tpu.train import trainer as jtrainer
    _layout(tmp_path, marked)
    got = ttrainer._find_restorable_checkpoint(str(tmp_path))
    want = jtrainer._find_restorable_checkpoint(str(tmp_path))
    assert got == want


def test_persisted_checkpoint_layout_is_jax_s(tmp_path):
    from ray_tpu.air.checkpoint import Checkpoint as JaxCheckpoint
    from ray_tpu.train import trainer as jtrainer
    for step in (1, 2):
        ttrainer.BaseTrainer._persist_checkpoint(
            str(tmp_path / "port"), Checkpoint.from_dict({"step": step}))
        jtrainer.BaseTrainer._persist_checkpoint(
            str(tmp_path / "jax"), JaxCheckpoint.from_dict({"step": step}))
    for side in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / side)) == ["checkpoint_latest"]
        assert sorted(os.listdir(tmp_path / side / "checkpoint_latest")) == \
            ["_COMPLETE", "_dict_checkpoint.pkl"]
    got = Checkpoint.from_directory(str(tmp_path / "jax" /
                                        "checkpoint_latest")).to_dict()
    assert got == {"step": 2}


# ---------------------------------------------------------------------------
# configs, result, session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["FailureConfig", "CheckpointConfig",
                                  "RunConfig"])
def test_run_configs_have_the_jax_fields_and_defaults(name):
    from ray_tpu.air import config as jconfig
    got = [(f.name, f.default) for f in
           dataclasses.fields(getattr(tconfig, name))]
    want = [(f.name, f.default) for f in
            dataclasses.fields(getattr(jconfig, name))]
    assert got == want


def test_result_has_the_jax_fields_and_defaults():
    from ray_tpu.air.result import Result as JaxResult
    assert [f.name for f in dataclasses.fields(Result)] == \
        [f.name for f in dataclasses.fields(JaxResult)]
    got, want = Result(), JaxResult()
    assert (got.metrics, got.checkpoint, got.error, got.metrics_history,
            got.config, got.path, got.best_checkpoint) == \
        (want.metrics, want.checkpoint, want.error, want.metrics_history,
         want.config, want.path, want.best_checkpoint)


@pytest.mark.parametrize("kw", [
    dict(num_workers=2), dict(num_workers=3, cpus_per_worker=2.0),
    dict(resources_per_worker={"CPU": 1, "mem": 2.0}),
    dict(placement_strategy="SPREAD")])
def test_cpu_scaling_asks_for_the_jax_resources(kw):
    from ray_tpu.air.config import ScalingConfig as JaxScaling
    got = tconfig.ScalingConfig(use_gpu=False, **kw)
    want = JaxScaling(**kw)
    assert got.worker_resources() == want.worker_resources()
    assert (got.num_workers, got.placement_strategy) == \
        (want.num_workers, want.placement_strategy)


def test_scaling_config_gpu_rules():
    assert tconfig.ScalingConfig().worker_resources() == \
        {"CPU": 1.0, "GPU": 1.0}
    assert tconfig.ScalingConfig(use_gpu=True, gpus_per_worker=2) \
        .worker_resources() == {"CPU": 1.0, "GPU": 2.0}
    assert tconfig.ScalingConfig(gpus_per_worker=0.5) \
        .worker_resources()["GPU"] == 0.5
    with pytest.raises(ValueError, match="slice placement"):
        tconfig.ScalingConfig(topology="v4-8")
    with pytest.raises(ValueError, match="holds no card"):
        tconfig.ScalingConfig(use_gpu=False, gpus_per_worker=1)


def test_placement_group_factory_pickles_by_import_path():
    sc = tconfig.ScalingConfig(num_workers=2, use_gpu=False,
                               placement_strategy="SPREAD")
    factory = sc.as_placement_group_factory()
    assert isinstance(factory, functools.partial)
    assert factory.args == ([{"CPU": 1.0}, {"CPU": 1.0}],)
    assert factory.keywords == {"strategy": "SPREAD"}
    back = serialization.loads(serialization.dumps(factory))
    assert back.func is factory.func and back.args == factory.args


def test_session_calls_outside_a_loop_raise_as_in_jax():
    from ray_tpu.air import session as jsession
    for mod in (tsession, jsession):
        with pytest.raises(RuntimeError, match="No training session"):
            mod.report({"x": 1})
        with pytest.raises(RuntimeError, match="No training session"):
            mod.get_world_rank()


def test_datasets_raise_until_data_is_ported():
    """``data/`` is ported: outside a loop ``get_dataset_shard`` raises as
    the JAX session does, a session without that name raises the JAX
    ``KeyError``, and the trainer keeps its ``datasets=``."""
    from ray_tpu.air import session as jsession
    for mod in (tsession, jsession):
        with pytest.raises(RuntimeError, match="No training session"):
            mod.get_dataset_shard("train")
        mod._set_session(mod._Session(0, 1, 0, dataset_shards={"a": 1}))
        try:
            assert mod.get_dataset_shard("a") == 1
            with pytest.raises(KeyError, match="no dataset 'train'"):
                mod.get_dataset_shard("train")
        finally:
            mod._set_session(None)
    t = ttrainer.DataParallelTrainer(_report_rank, datasets={"train": [1]})
    assert t.datasets == {"train": [1]}


def test_as_trainable_is_a_module_level_partial():
    t = ttrainer.DataParallelTrainer(
        _report_rank, scaling_config=tconfig.ScalingConfig(use_gpu=False))
    trainable = t.as_trainable()
    assert isinstance(trainable, functools.partial)
    assert trainable.func is ttrainer._run_trainable
    serialization.dumps(trainable)


# ---------------------------------------------------------------------------
# the in-process runtime
# ---------------------------------------------------------------------------


def _report_rank(config):
    from ray_tpu_torch.air import session
    session.report({"rank": session.get_world_rank(),
                    "world": session.get_world_size(),
                    "device": str(torch_utils.get_device()),
                    "x": config.get("x")})


def _report_group(config):
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    t = torch.ones(2)
    dist.all_reduce(t)
    session.report({"backend": dist.get_backend(),
                    "world": dist.get_world_size(), "sum": t.tolist()})


@pytest.fixture
def in_process():
    saved, core_api._runtime = core_api._runtime, None
    rt.init(num_cpus=2)
    try:
        yield
    finally:
        rt.shutdown()
        core_api._runtime = saved


def test_one_rank_gang_runs_on_the_in_process_runtime(in_process,
                                                      tmp_path):
    r = ttrainer.DataParallelTrainer(
        _report_rank, train_loop_config={"x": 5},
        scaling_config=tconfig.ScalingConfig(use_gpu=False),
        run_config=tconfig.RunConfig(storage_path=str(tmp_path))).fit()
    assert r.error is None, r.error
    assert r.metrics == {"rank": 0, "world": 1, "device": "cpu", "x": 5}
    assert ttrainer.BaseTrainer.can_restore(r.path)


def test_one_rank_torch_trainer_starts_and_ends_a_gloo_group(in_process,
                                                             tmp_path):
    import torch.distributed as dist
    assert not dist.is_initialized()
    r = ttrainer.TorchTrainer(
        _report_group, scaling_config=tconfig.ScalingConfig(use_gpu=False),
        run_config=tconfig.RunConfig(storage_path=str(tmp_path))).fit()
    assert r.error is None, r.error
    assert r.metrics == {"backend": "gloo", "world": 1, "sum": [1.0, 1.0]}
    assert not dist.is_initialized()


def test_larger_gang_on_the_in_process_runtime_raises(in_process, tmp_path):
    for cls in (ttrainer.DataParallelTrainer, ttrainer.TorchTrainer):
        with pytest.raises(ValueError, match=r"init\(address"):
            cls(_report_rank, scaling_config=tconfig.ScalingConfig(
                num_workers=2, use_gpu=False),
                run_config=tconfig.RunConfig(
                    storage_path=str(tmp_path))).fit()
    assert core_api._runtime._actors == {}


def test_get_device_and_prepare_model_outside_a_gang(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_utils.get_device() == torch.device("cpu")
    model = torch.nn.Linear(2, 1)
    assert torch_utils.prepare_model(model) is model
    sess = tsession._Session(0, 1, 0, device="cuda:0")
    tsession._set_session(sess)
    try:
        assert torch_utils.get_device() == torch.device("cuda:0")
    finally:
        tsession._set_session(None)
