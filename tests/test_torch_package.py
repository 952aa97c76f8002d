"""The port's package rules: no JAX, no ray_tpu, no cloudpickle, no quiet CPU
fallback, and a kernel build keyed on its sources."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import models as tmodels
from ray_tpu_torch import ops as tops
from ray_tpu_torch import parallel as tparallel
from ray_tpu_torch import rl as trl
from ray_tpu_torch import serve as tserve
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.ops import _build
from ray_tpu_torch.models import transformer as ttransformer
from ray_tpu_torch.ops import pipeline as tpipeline
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.rl import offline as toffline
from ray_tpu_torch.rl import multi_agent as tmulti
from ray_tpu_torch.rl.algorithms import (MADDPG, QMIX, A2CConfig, APPOConfig,
                                         CQLConfig, DDPGConfig, DQNConfig,
                                         ESConfig, ImpalaConfig, MADDPGConfig,
                                         PPOConfig, QMIXConfig, SACConfig,
                                         TD3Config)
from ray_tpu_torch.rl.algorithms import appo as tappo
from ray_tpu_torch.rl.algorithms import dqn as tdqn
from ray_tpu_torch.rl.algorithms import sac as tsac
from ray_tpu_torch.rl.algorithms import td3 as ttd3
from ray_tpu_torch.train import pipeline as tpipetrain

REPO = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_ray_tpu(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "flax", "optax",
                                  "cloudpickle")]
    assert not bad, f"{path.name} imports {bad}"


def test_import_walk_covers_every_module_of_the_port():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for module in ("ray_tpu_torch/train/__init__.py",
                   "ray_tpu_torch/train/step.py",
                   "ray_tpu_torch/models/moe.py",
                   "ray_tpu_torch/models/vit.py",
                   "ray_tpu_torch/models/resnet.py",
                   "ray_tpu_torch/models/mlp.py",
                   "ray_tpu_torch/ops/flash.py",
                   "ray_tpu_torch/rl/__init__.py",
                   "ray_tpu_torch/rl/sample_batch.py",
                   "ray_tpu_torch/rl/env.py", "ray_tpu_torch/rl/module.py",
                   "ray_tpu_torch/rl/rollout.py",
                   "ray_tpu_torch/rl/learner.py",
                   "ray_tpu_torch/rl/algorithm.py",
                   "ray_tpu_torch/rl/algorithms/__init__.py",
                   "ray_tpu_torch/rl/algorithms/ppo.py",
                   "ray_tpu_torch/rl/vtrace.py",
                   "ray_tpu_torch/rl/replay_buffer.py",
                   "ray_tpu_torch/rl/offline.py",
                   "ray_tpu_torch/rl/algorithms/impala.py",
                   "ray_tpu_torch/rl/algorithms/appo.py",
                   "ray_tpu_torch/rl/algorithms/a2c.py",
                   "ray_tpu_torch/rl/algorithms/dqn.py",
                   "ray_tpu_torch/rl/algorithms/sac.py",
                   "ray_tpu_torch/rl/algorithms/td3.py",
                   "ray_tpu_torch/rl/algorithms/cql.py",
                   "ray_tpu_torch/rl/connectors.py",
                   "ray_tpu_torch/rl/multi_agent.py",
                   "ray_tpu_torch/rl/algorithms/qmix.py",
                   "ray_tpu_torch/rl/algorithms/maddpg.py",
                   "ray_tpu_torch/rl/algorithms/es.py",
                   "ray_tpu_torch/rl/algorithms/bandits.py",
                   "ray_tpu_torch/config.py",
                   "ray_tpu_torch/core/__init__.py",
                   "ray_tpu_torch/core/ids.py",
                   "ray_tpu_torch/core/exceptions.py",
                   "ray_tpu_torch/core/refs.py",
                   "ray_tpu_torch/core/options.py",
                   "ray_tpu_torch/core/serialization.py",
                   "ray_tpu_torch/core/task_spec.py",
                   "ray_tpu_torch/core/remote_function.py",
                   "ray_tpu_torch/core/actor.py",
                   "ray_tpu_torch/core/runtime_local.py",
                   "ray_tpu_torch/core/api.py",
                   "ray_tpu_torch/parallel/__init__.py",
                   "ray_tpu_torch/parallel/mesh.py",
                   "ray_tpu_torch/parallel/sharding.py",
                   "ray_tpu_torch/parallel/collectives.py",
                   "ray_tpu_torch/ops/ring_attention.py",
                   "ray_tpu_torch/ops/ulysses.py",
                   "ray_tpu_torch/ops/pipeline.py",
                   "ray_tpu_torch/serve/__init__.py",
                   "ray_tpu_torch/serve/api.py",
                   "ray_tpu_torch/serve/controller.py",
                   "ray_tpu_torch/serve/http_proxy.py",
                   "ray_tpu_torch/dag/__init__.py",
                   "ray_tpu_torch/dag/nodes.py",
                   "ray_tpu_torch/dag/schedule.py",
                   "ray_tpu_torch/dag/channel.py",
                   "ray_tpu_torch/dag/compiled.py",
                   "ray_tpu_torch/train/pipeline.py", "chip_smoke.py"):
        assert module in names


def test_importing_serve_loads_no_jax_ray_tpu_or_cloudpickle(monkeypatch):
    """The import walk reads the sources; this imports ``serve`` afresh and
    looks at what the import itself loaded."""
    import importlib
    import sys
    for name in [m for m in sys.modules if m == "ray_tpu_torch.serve"
                 or m.startswith("ray_tpu_torch.serve.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.delattr(ray_tpu_torch, "serve", raising=False)
    before = set(sys.modules)
    importlib.import_module("ray_tpu_torch.serve")
    new = set(sys.modules) - before
    assert {"ray_tpu_torch.serve.api", "ray_tpu_torch.serve.controller",
            "ray_tpu_torch.serve.http_proxy"} <= new
    bad = [m for m in new if m.split(".")[0] in
           ("jax", "jaxlib", "ray_tpu", "cloudpickle")]
    assert not bad, bad


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "transformer_init": lambda cfg: tmodels.transformer_init(
        torch.Generator(), cfg),
    "transformer_apply": lambda cfg: tmodels.transformer_apply(
        {}, torch.zeros(1, 4, dtype=torch.long), cfg),
    "prefill": lambda cfg: tmodels.prefill(
        {}, torch.zeros(1, 4, dtype=torch.long), cfg, 8),
    "decode_step": lambda cfg: tmodels.decode_step(
        {}, torch.zeros(1, dtype=torch.long), 4, {}, cfg),
    "generate": lambda cfg: tmodels.generate(
        {}, torch.zeros(1, 4, dtype=torch.long), cfg, max_new_tokens=2),
    "init_cache": lambda cfg: tmodels.init_cache(cfg, 1, 8),
    "params_from_jax": lambda cfg: tmodels.params_from_jax({}, cfg),
    "transformer_loss": lambda cfg: tmodels.transformer_loss(
        {}, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, cfg),
    "make_lm_train_step": lambda cfg: ttrain.make_lm_train_step(cfg),
    "moe_apply": lambda cfg: tmodels.moe_apply(
        dataclasses.replace(cfg, num_experts=4, expert_top_k=2), {},
        torch.zeros(1, 4, 32)),
    "vit_init": lambda cfg: tmodels.vit_init(torch.Generator(), VIT),
    "vit_apply": lambda cfg: tmodels.vit_apply(
        {}, torch.zeros(1, 32, 32, 3), VIT),
    "vit_loss": lambda cfg: tmodels.vit_loss(
        {}, {"image": torch.zeros(1, 32, 32, 3),
             "label": torch.zeros(1, dtype=torch.long)}, VIT),
    "vit_params_from_jax": lambda cfg: tmodels.vit_params_from_jax({}, VIT),
    "make_vit_train_step": lambda cfg: ttrain.make_vit_train_step(VIT),
    "resnet50_init": lambda cfg: tmodels.resnet50_init(torch.Generator()),
    "resnet50_apply": lambda cfg: tmodels.resnet50_apply(
        tmodels.resnet50(), {}, torch.zeros(1, 32, 32, 3)),
    "resnet_variables_from_jax": lambda cfg:
        tmodels.resnet_variables_from_jax({}),
    "make_resnet_train_step": lambda cfg: ttrain.make_resnet_train_step(),
    "mlp_init": lambda cfg: tmodels.mlp_init(torch.Generator(), [4, 2]),
    "mlp_apply": lambda cfg: tmodels.mlp_apply([], torch.zeros(1, 4)),
    "rl_module_init": lambda cfg: trl.make_module(RL_SPEC).init(
        torch.Generator()),
    "PPOLearner": lambda cfg: trl.PPOLearner(RL_SPEC),
    "RolloutWorker": lambda cfg: trl.RolloutWorker(
        "CartPole-v1", RL_SPEC, 4, 2, 0.99, 0.95),
    "rl_params_from_jax": lambda cfg: trl.rl_params_from_jax(
        {}, trl.make_module(RL_SPEC)),
    "PPOConfig.build": lambda cfg: PPOConfig().build(),
    "LearnerGroup": lambda cfg: trl.LearnerGroup(
        trl.PPOLearner, {"module_spec": RL_SPEC}),
    "LearnerGroup(remote=True)": lambda cfg: trl.LearnerGroup(
        trl.PPOLearner, {"module_spec": RL_SPEC}, remote=True),
    "APPOConfig.build": lambda cfg: APPOConfig().build(),
    "ImpalaConfig.build": lambda cfg: ImpalaConfig().build(),
    "ImpalaConfig.build(learner_remote=True)": lambda cfg:
        ImpalaConfig().resources(learner_remote=True).build(),
    "A2CConfig.build": lambda cfg: A2CConfig().build(),
    "DQNConfig.build": lambda cfg: DQNConfig().build(),
    "SACConfig.build": lambda cfg: SACConfig().build(),
    "TD3Config.build": lambda cfg: TD3Config().build(),
    "DDPGConfig.build": lambda cfg: DDPGConfig().build(),
    "BCConfig.build": lambda cfg: toffline.BCConfig().build(),
    "MARWILConfig.build": lambda cfg: toffline.MARWILConfig().build(),
    "CQLConfig.build": lambda cfg: CQLConfig().build(),
    "APPOLearner": lambda cfg: tappo.APPOLearner(RL_SPEC),
    "SACLearner": lambda cfg: tsac.SACLearner(RL_SPEC),
    "TD3Learner": lambda cfg: ttd3.TD3Learner(
        {"obs_dim": 3, "num_actions": -1}),
    "DQNCollector": lambda cfg: tdqn.DQNCollector(
        "CartPole-v1", RL_SPEC, 2),
    "TD3Collector": lambda cfg: ttd3.TD3Collector("Pendulum-v1", {}, 2),
    "rl_tree_from_jax": lambda cfg: trl.rl_tree_from_jax(
        {"q": []}, {"q": []}),
    "QMIX": lambda cfg: QMIX(QMIXConfig()),
    "MADDPG": lambda cfg: MADDPG(MADDPGConfig()),
    "ESConfig.build": lambda cfg: ESConfig().build(),
    "MultiAgentCollector": lambda cfg: tmulti.MultiAgentCollector(
        tmulti.TwoStepCoopEnv(), {"shared": trl.make_module(
            {"obs_dim": 2, "num_actions": 2})}, {}),
    "build_mesh": lambda cfg: tparallel.build_mesh(tparallel.MeshSpec()),
    "best_dp_fsdp_split": lambda cfg: tmesh.best_dp_fsdp_split(8, 1 << 30),
    "ring_attention": lambda cfg: tops.ring_attention(
        *_QKV, tparallel.build_mesh(tparallel.MeshSpec(sp=2))),
    "ulysses_attention": lambda cfg: tops.ulysses_attention(
        *_QKV, tparallel.build_mesh(tparallel.MeshSpec(sp=2))),
    "pipeline_apply": lambda cfg: tpipeline.pipeline_apply(
        lambda p, a: a, {}, torch.zeros(1, 1, 4),
        tparallel.build_mesh(tparallel.MeshSpec(pp=2))),
    "make_lm_train_step(mesh=)": lambda cfg: ttrain.make_lm_train_step(
        cfg, mesh=object()),
    "transformer_apply(mesh=)": lambda cfg: tmodels.transformer_apply(
        {}, torch.zeros(1, 4, dtype=torch.long), cfg, mesh=object()),
    "PPOLearner(mesh=)": lambda cfg: trl.PPOLearner(RL_SPEC, mesh=object()),
    "transformer_stage_forward": lambda cfg: ttransformer.
        transformer_stage_forward({}, torch.zeros(1, 4, dtype=torch.long),
                                  torch.zeros(1, 4, dtype=torch.long),
                                  cfg, part=0),
    "transformer_stage_loss": lambda cfg: ttransformer.transformer_stage_loss(
        {}, torch.zeros(1, 4, 32), torch.zeros(1, 4, dtype=torch.long), cfg),
    "PipelineStageActor": lambda cfg: tpipetrain.PipelineStageActor(cfg, [0]),
    "PipelineTrainer": lambda cfg: tpipetrain.PipelineTrainer(cfg),
    "TorchTrainer.fit": lambda cfg: ttrain.TorchTrainer(_loop).fit(),
    "DataParallelTrainer(ScalingConfig()).fit": lambda cfg:
        ttrain.DataParallelTrainer(
            _loop, scaling_config=ttrain.ScalingConfig()).fit(),
    # Not here: rl.algorithms.Bandit. Like the JAX package's, it skips the
    # base init and runs on the host only: it takes no device, so it has
    # nothing to refuse without a card (ROADMAP.md C).
    # Not here: serve (deployments, handles, the HTTP proxy). Serve holds no
    # tensor and takes no device; a deployment's model takes its own, and
    # its entry points are the rows above.
    # Not here: the launcher, the autoscaler, workflows and the pools, for
    # the same reason: a step, a pool's function or a job's model takes its
    # own device (their modules are in the import lists below).
}
RL_SPEC = {"obs_dim": 4, "num_actions": 2}


def _loop(config):
    """A train loop (module-level: the trainer sends loops by import
    path)."""


_QKV = [torch.zeros(1, 4, 2, 8)] * 3
VIT = tmodels.ViTConfig(image_size=32, patch_size=8, num_classes=10,
                        d_model=32, n_layers=1, n_heads=2)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_device_none_without_cuda_raises(monkeypatch, name):
    _no_cuda(monkeypatch)
    cfg = tmodels.TransformerConfig(vocab_size=16, d_model=32, n_layers=1,
                                    n_heads=2)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            ENTRY_POINTS[name](cfg)
        # the drivers raise before they create any actor
        assert core_api._runtime._actors == {}
    finally:
        ray_tpu_torch.shutdown()


def test_resolve_device(monkeypatch):
    assert ray_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    _no_cuda(monkeypatch)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ray_tpu_torch.resolve_device(dev)
    with pytest.raises(ValueError, match="unsupported"):
        ray_tpu_torch.resolve_device("meta")


def test_build_target_follows_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    first = _build._target(src)
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")
    assert _build._target(src) == first
    src.write_text("// v2\n")
    second = _build._target(src)
    assert second != first
    (tmp_path / "common.cuh").write_text("// header\n")
    assert _build._target(src) != second
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build._target(src) not in (first, second)


def test_build_targets_sm90a_into_ignored_dir():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert _build.BUILD_DIR == REPO / "build" / "ray_tpu_torch"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert sorted(p.name for p in _build.SRC_DIR.glob("*.cu")) == \
        ["flash_bwd.cu", "flash_fwd.cu"]


def test_kernel_source_calls_no_library_attention():
    # the CUDA runtime and bf16 headers, the driver API's header for the
    # CUtensorMap type of TMA, and the port's own shared headers
    allowed = {"<cuda_bf16.h>", "<cuda_runtime.h>", "<stdint.h>",
               "<cuda.h>", '"flash_common.cuh"', '"hopper.cuh"',
               '"tma_host.cuh"'}
    names = {"flash_fwd.cu": ["_fwd_kernel"],   # the TPU kernels replaced
             "flash_bwd.cu": ["_bwd_dkv_kernel", "_bwd_dq_kernel"],
             "flash_common.cuh": [], "hopper.cuh": [], "tma_host.cuh": []}
    assert sorted(p.name for p in _build.SRC_DIR.iterdir()) == sorted(names)
    for name, tpu_kernels in names.items():
        src = (_build.SRC_DIR / name).read_text()
        includes = {line.split()[1] for line in src.splitlines()
                    if line.startswith("#include")}
        assert includes <= allowed, name
        for kernel in tpu_kernels:
            assert kernel in src, name


_CLUSTER_MODULES = (
    "ray_tpu_torch/cluster/__init__.py", "ray_tpu_torch/cluster/protocol.py",
    "ray_tpu_torch/cluster/object_client.py",
    "ray_tpu_torch/cluster/hygiene.py",
    "ray_tpu_torch/cluster/memory_monitor.py",
    "ray_tpu_torch/cluster/persistence.py",
    "ray_tpu_torch/cluster/fault_plane.py",
    "ray_tpu_torch/cluster/conductor.py",
    "ray_tpu_torch/cluster/object_plane.py",
    "ray_tpu_torch/cluster/push_manager.py",
    "ray_tpu_torch/cluster/node_daemon.py",
    "ray_tpu_torch/cluster/worker_main.py",
    "ray_tpu_torch/cluster/worker_zygote.py",
    "ray_tpu_torch/cluster/spill.py",
    "ray_tpu_torch/cluster/cluster_utils.py",
    "ray_tpu_torch/core/refcount.py", "ray_tpu_torch/core/runtime_cluster.py",
    "ray_tpu_torch/util/__init__.py", "ray_tpu_torch/util/lockcheck.py",
    "ray_tpu_torch/util/events.py", "ray_tpu_torch/util/metrics.py",
    "ray_tpu_torch/util/tracing.py", "ray_tpu_torch/util/profiler.py",
    "ray_tpu_torch/runtime_env.py", "ray_tpu_torch/gpu/__init__.py",
    "ray_tpu_torch/gpu/topology.py")


_TRAINER_MODULES = (
    "ray_tpu_torch/air/__init__.py", "ray_tpu_torch/air/config.py",
    "ray_tpu_torch/air/checkpoint.py", "ray_tpu_torch/air/result.py",
    "ray_tpu_torch/air/session.py", "ray_tpu_torch/train/worker_group.py",
    "ray_tpu_torch/train/weight_sync.py",
    "ray_tpu_torch/train/backend_executor.py",
    "ray_tpu_torch/train/torch_utils.py", "ray_tpu_torch/train/trainer.py",
    "ray_tpu_torch/util/placement_group.py",
    "ray_tpu_torch/util/scheduling_strategies.py",
    "ray_tpu_torch/util/collective.py")


def test_import_walk_covers_the_trainer():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    missing = [m for m in _TRAINER_MODULES if m not in names]
    assert not missing, missing


_DATA_MODULES = tuple(f"ray_tpu_torch/data/{m}.py" for m in (
    "__init__", "block", "dataset", "datasource", "llm", "preprocessors",
    "shuffle", "stats", "streaming", "tensor_ext", "tfrecord"))


def test_import_walk_covers_the_data_library():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    missing = [m for m in _DATA_MODULES if m not in names]
    assert not missing, missing


_CONTROL_MODULES = (
    "ray_tpu_torch/client/__init__.py", "ray_tpu_torch/client/common.py",
    "ray_tpu_torch/client/server.py", "ray_tpu_torch/client/runtime.py",
    "ray_tpu_torch/job_submission.py", "ray_tpu_torch/state/__init__.py",
    "ray_tpu_torch/state/api.py", "ray_tpu_torch/dashboard.py",
    "ray_tpu_torch/scripts.py", "ray_tpu_torch/__main__.py")


def test_import_walk_covers_the_control_surface():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    missing = [m for m in _CONTROL_MODULES if m not in names]
    assert not missing, missing


_ELASTIC_MODULES = (
    "ray_tpu_torch/autoscaler/__init__.py",
    "ray_tpu_torch/autoscaler/autoscaler.py",
    "ray_tpu_torch/cluster_launcher.py", "ray_tpu_torch/tune/__init__.py",
    "ray_tpu_torch/tune/syncer.py", "ray_tpu_torch/workflow/__init__.py",
    "ray_tpu_torch/workflow/storage.py", "ray_tpu_torch/workflow/execution.py",
    "ray_tpu_torch/cluster/spill.py", "ray_tpu_torch/util/multiprocessing.py",
    "ray_tpu_torch/util/joblib_backend.py",
    "ray_tpu_torch/util/actor_pool.py", "ray_tpu_torch/util/queue.py")


def test_import_walk_covers_the_elastic_and_durable_runtime():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    missing = [m for m in _ELASTIC_MODULES if m not in names]
    assert not missing, missing


def test_import_walk_covers_the_cluster_runtime():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    missing = [m for m in _CLUSTER_MODULES if m not in names]
    assert not missing, missing


_FRESH_IMPORT = """
import sys
{body}
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu', 'cloudpickle'))
print('BAD', bad)
"""


def _fresh(body):
    import os
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _FRESH_IMPORT.format(
        body=body)], capture_output=True, text=True, env=env, cwd=str(REPO),
        timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("module", [
    "ray_tpu_torch.core.runtime_cluster", "ray_tpu_torch.cluster.worker_main",
    "ray_tpu_torch.cluster.worker_zygote", "ray_tpu_torch.train.trainer",
    "ray_tpu_torch.util.collective", "ray_tpu_torch.data",
    "ray_tpu_torch.serve", "ray_tpu_torch.client", "ray_tpu_torch.state",
    "ray_tpu_torch.job_submission", "ray_tpu_torch.dashboard",
    "ray_tpu_torch.scripts", "ray_tpu_torch.autoscaler",
    "ray_tpu_torch.cluster_launcher", "ray_tpu_torch.workflow",
    "ray_tpu_torch.tune.syncer", "ray_tpu_torch.util.multiprocessing",
    "ray_tpu_torch.util.joblib_backend"])
def test_cluster_modules_load_no_jax_ray_tpu_or_cloudpickle(module):
    """A fresh interpreter: the test process itself has JAX loaded."""
    out = _fresh(f"import {module}")
    assert "BAD []" in out, out


def test_train_worker_class_loads_without_torch():
    """A train worker that runs no step starts without loading torch: the
    actor class's module and the air session load none."""
    out = _fresh("import ray_tpu_torch.train.worker_group\n"
                 "import ray_tpu_torch.air.session\n"
                 "print('TORCH', 'torch' in sys.modules)")
    assert "TORCH False" in out and "BAD []" in out, out


def test_zygote_preimports_leave_cuda_uninitialised():
    """What the zygote imports before it forks must not initialise CUDA
    (a forked child could not use it), even with torch loaded after."""
    out = _fresh("from ray_tpu_torch.cluster import worker_zygote\n"
                 "worker_zygote.preimport()\n"
                 "print('TORCH_BEFORE', 'torch' in sys.modules)\n"
                 "import torch\n"
                 "print('CUDA_INIT', torch.cuda.is_initialized())")
    assert "TORCH_BEFORE False" in out and "CUDA_INIT False" in out, out
    assert "BAD []" in out, out


class _NotAtModuleLevel:
    pass


def test_remote_lambda_on_the_cluster_runtime_raises_type_error():
    """The cluster runtime ships callables by import path: a lambda or a
    nested function is refused at ``.remote()``, naming it, before anything
    reaches a worker. No cluster is needed to reach that check."""
    from ray_tpu_torch.core.runtime_cluster import ClusterRuntime

    class _Conductor:
        def call(self, *a, **k):
            raise AssertionError("nothing may reach the conductor")

    rt_ = ClusterRuntime.__new__(ClusterRuntime)
    import threading
    rt_._fn_lock = threading.Lock()
    rt_._fn_blobs = {}
    rt_._registered_fns = set()
    rt_.conductor = _Conductor()
    prev = core_api._runtime
    core_api._runtime = rt_
    try:
        with pytest.raises(TypeError, match="<lambda>.*module level"):
            ray_tpu_torch.remote(lambda x: x).remote(1)

        def nested(x):
            return x

        with pytest.raises(TypeError, match="nested.*module level"):
            ray_tpu_torch.remote(nested).remote(1)
    finally:
        core_api._runtime = prev


_BLOCKED_FORMATS = """
for name in ("pyarrow", "pandas", "PIL"):
    sys.modules[name] = None        # import raises ImportError
import tempfile

import numpy as np

import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
rt.init(local_mode=True, num_cpus=2)
ds = rd.range(64, parallelism=4).map_batches(
    lambda b: {"id": b["id"] * 2}).random_shuffle(seed=3)
batches = list(ds.iter_torch_batches(batch_size=16))
ids = sorted(int(i) for b in batches for i in b["id"])
print("TORCH", type(batches[0]["id"]).__module__, len(batches),
      ids == list(range(0, 128, 2)))
try:
    rd.read_parquet(tempfile.mkdtemp())
    print("PARQUET none")
except ImportError as e:
    print("PARQUET", "pyarrow" in str(e))
rt.shutdown()
print("LOADED", sorted(m for m in ("pyarrow", "pandas", "PIL")
                       if sys.modules.get(m) is not None))
"""


def test_data_runs_with_pyarrow_pandas_and_pil_blocked():
    """With pyarrow, pandas and PIL unimportable, ``data`` imports and
    runs range -> map_batches -> random_shuffle -> iter_torch_batches on
    the in-process runtime; parquet raises ImportError naming pyarrow."""
    out = _fresh(_BLOCKED_FORMATS)
    assert "TORCH torch 4 True" in out, out
    assert "PARQUET True" in out, out
    assert "LOADED []" in out and "BAD []" in out, out


_BLOCKED_SPEC_PACKAGES = """
for name in ("yaml", "joblib", "fsspec"):
    sys.modules[name] = None        # import raises ImportError
import json
import os
import tempfile

import ray_tpu_torch.autoscaler
import ray_tpu_torch.cluster_launcher as launcher
import ray_tpu_torch.tune.syncer as syncer
import ray_tpu_torch.util
import ray_tpu_torch.util.joblib_backend as jb
import ray_tpu_torch.util.multiprocessing
import ray_tpu_torch.workflow
from ray_tpu_torch.util import ActorPool, Queue
d = tempfile.mkdtemp()
spec = {"cluster_name": "blocked", "provider": {"type": "fake"},
        "head": {"resources": {"CPU": 1}}}
with open(os.path.join(d, "c.json"), "w") as f:
    json.dump(spec, f)
print("JSON", launcher.load_config(os.path.join(d, "c.json")) == dict(
    spec, node_types={}))
with open(os.path.join(d, "c.yaml"), "w") as f:
    f.write("cluster_name: blocked\\n")
for name, call in (("YAML", lambda: launcher.load_config(
        os.path.join(d, "c.yaml"))), ("JOBLIB", jb.register_ray_tpu_torch),
        ("FSSPEC", lambda: syncer.backend_for("s3://b/k").exists("s3://b/k"))):
    try:
        call()
        print(name, "none")
    except ImportError as e:
        print(name, str(e))
print("LOADED", sorted(m for m in ("yaml", "joblib", "fsspec")
                       if sys.modules.get(m) is not None))
"""


def test_elastic_runtime_imports_with_yaml_joblib_and_fsspec_blocked():
    """With PyYAML, joblib and fsspec unimportable, ``autoscaler``,
    ``cluster_launcher``, ``workflow``, ``tune.syncer`` and ``util`` import;
    a JSON spec loads, and a YAML spec, the joblib backend and an fsspec URI
    each raise ``ImportError`` naming the package they need."""
    out = _fresh(_BLOCKED_SPEC_PACKAGES)
    assert "JSON True" in out, out
    assert "YAML " in out and "PyYAML" in out.split("YAML ", 1)[1], out
    assert "joblib package" in out.split("JOBLIB ", 1)[1], out
    assert "fsspec package" in out.split("FSSPEC ", 1)[1], out
    assert "LOADED []" in out and "BAD []" in out, out


def test_lambda_data_function_on_the_cluster_runtime_raises_at_the_call():
    """The cluster runtime ships a data function by import path, so
    ``map_batches(lambda b: b)`` raises TypeError at the call, before any
    plan runs; the in-process runtime takes it."""
    from ray_tpu_torch.core.runtime_cluster import ClusterRuntime
    from ray_tpu_torch.data import Dataset

    rt_ = ClusterRuntime.__new__(ClusterRuntime)
    prev = core_api._runtime
    core_api._runtime = rt_
    try:
        ds = Dataset([])
        with pytest.raises(TypeError, match="<lambda>.*module level"):
            ds.map_batches(lambda b: b)
        with pytest.raises(TypeError, match="<lambda>.*module level"):
            ds.filter(lambda r: True)
        ds.map_batches(_module_level_batch_fn)
    finally:
        core_api._runtime = prev
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True, num_cpus=2)
    try:
        from ray_tpu_torch import data
        got = data.range(4).map_batches(lambda b: {"id": b["id"] + 1})
        assert [r["id"] for r in got.take_all()] == [1, 2, 3, 4]
    finally:
        ray_tpu_torch.shutdown()


def _module_level_batch_fn(batch):
    return batch


@tserve.deployment(num_replicas=2)
class ShippedModel:
    def __init__(self, scale):
        self.scale = scale

    def __call__(self, x):
        return x * self.scale


@tserve.deployment
def shipped_echo(x):
    return x


def test_module_level_deployment_round_trips_through_the_pickler():
    """A module-level ``@serve.deployment`` class or function ships by
    import path: its module attribute is the ``Deployment``, which the
    pickler resolves to the target behind it, as it does for ``@remote``
    wrappers."""
    from ray_tpu_torch.core import serialization
    payload = (ShippedModel._target, ((3,), {}))
    target, (args, kwargs) = serialization.loads(
        serialization.dumps(payload))
    assert target is ShippedModel._target and args == (3,)
    assert target(*args)(2) == 6
    assert serialization.loads(serialization.dumps(
        shipped_echo._target)) is shipped_echo._target
    copy = serialization.loads(serialization.dumps(ShippedModel))
    assert isinstance(copy, tserve.Deployment)
    assert copy._target is ShippedModel._target
    assert copy.num_replicas == 2 and copy.name == "ShippedModel"


def test_nested_deployment_raises_at_serve_run_on_a_port_cluster():
    """On the cluster runtime a deployment class defined inside a function
    cannot reach a replica's process: ``serve.run`` raises ``TypeError``
    in the driver, before the controller exists."""
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    ray_tpu_torch.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=c.address)
    try:
        @tserve.deployment
        class Nested:
            def __call__(self):
                return 1

        with pytest.raises(TypeError, match="define it at module level"):
            tserve.run(Nested.bind())
        with pytest.raises(ValueError):
            tserve.status()   # no controller was started
    finally:
        tserve.shutdown()
        ray_tpu_torch.shutdown()
        c.shutdown()
