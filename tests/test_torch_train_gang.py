"""The port's trainer (``ray_tpu_torch.train``: ``DataParallelTrainer``,
``TorchTrainer``, the worker gang, ``weight_sync``) on its cluster
runtime, held to the JAX package's trainer on a JAX ``Cluster``.

- *Programs:* the counterparts of ``tests/test_train_trainer.py`` (its six
  tests), ``tests/test_torch_trainer.py::test_torch_trainer_ddp``,
  ``test_experiment_restore.py::test_trainer_restore_resumes_from_checkpoint``,
  ``test_elastic_multislice.py::test_elastic_shrink_on_node_death``,
  ``test_chaos_plane.py::test_elastic_training_survives_rank_kill`` and
  ``test_device_object_plane.py::test_weight_broadcast_to_worker_gang``.
  Each program takes a package name and its cluster and returns plain
  values: a ``Result``'s error class, metrics, ``metrics_history``,
  checkpoint dict and config. The JAX programs run once per test run on a
  JAX ``Cluster`` (``_once``: the xdist workers share one pickle), before
  this module's port cluster starts in that process; each test runs its
  program on the port and compares. Where the two stacks compute with
  their own framework (the loop that trains, where the JAX test's loop is
  JAX and the port's is torch, on the same numpy data), values are held
  within a stated tolerance; elsewhere they must be equal.
- *A real step in a gang:* two gloo workers each run the port's
  ``make_lm_train_step(cfg, mesh)`` over ``MeshSpec(dp=2)`` on a small
  flagship configuration for 3 steps, from the JAX package's initial
  weights (``params_from_jax``); their losses and gradient norms must equal
  the JAX ``make_lm_train_step`` on ``build_mesh(MeshSpec(dp=1))`` over the
  whole batch within ``STEP_TOL`` (f32). The same for the ViT step
  (``make_vit_train_step(cfg, mesh)``, f32, losses within ``STEP_TOL``,
  accuracies equal) and the ResNet step (``make_resnet_train_step(mesh)``
  on a small ResNet computing in float64, as ``tests/test_torch_mesh_steps.py``
  holds it: losses within ``F64_LOSS_TOL`` and the final BatchNorm running
  variances of the first layer within ``F64_TOL``, which only BatchNorm
  over the global batch meets).
- *The port's own rules:* a gang left at ``use_gpu=None`` on a cluster
  without cards raises at ``fit()`` at once; workers take their cards from
  their bundles; an NCCL gang of two ranks on one card raises
  ``ValueError`` before any rank joins a process group.

The loops and helpers here are module-level: the port's workers import this
module by name (so it imports no JAX at the top), the JAX workers get them
by value (cloudpickle's pickle-by-value, registered for the JAX run only).
Each loop reads its package from ``config["pkg"]``, which the comparisons
leave out of ``Result.config``.
"""

import fcntl
import importlib
import os
import pickle
import signal
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster.cluster_utils import Cluster

HEAD_CPUS = 4
HEALTH_TIMEOUT_S = 2.0
STEP_TOL = 1e-4            # PR 12's tolerance for train steps, f32
LOOP_TOL = 1e-5            # the JAX loop against the torch loop, f32
DDP_TOL = 1e-6             # the same torch loop in both trainers
LM_CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=64, max_seq=32, attn_impl="reference")
LM_B, LM_S, LM_LR = 8, 16, 1e-3
F64_TOL = 1e-6             # the ResNet step computing in float64
F64_LOSS_TOL = 1e-5        # its losses (the third one near 4e-3)
VIT_CFG = dict(image_size=16, patch_size=4, num_classes=10, d_model=32,
               n_layers=2, n_heads=4)
RESNET_STAGES, RESNET_SIZE, RESNET_LR = (1, 1, 1, 1), 32, 0.01

# ---------------------------------------------------------------------------
# loops (run in the workers of either package)
# ---------------------------------------------------------------------------


def _air(config, name):
    return importlib.import_module(f"{config['pkg']}.air.{name}")


def loop_reports(config):
    session = _air(config, "session")
    for i in range(config["iters"]):
        session.report({"loss": 1.0 / (i + 1), "iter": i})


def loop_rank_metrics(config):
    session = _air(config, "session")
    session.report({"rank": session.get_world_rank(),
                    "world": session.get_world_size()})


def loop_checkpoints(config):
    session = _air(config, "session")
    Checkpoint = _air(config, "checkpoint").Checkpoint
    start = 0
    ck = session.get_checkpoint()
    if ck is not None:
        start = ck.to_dict()["step"]
    for i in range(start, start + 2):
        session.report({"step_done": i}, checkpoint=Checkpoint.from_dict(
            {"step": i + 1, "w": np.ones(4) * (i + 1)}))


def loop_forever(config):
    session = _air(config, "session")
    for i in range(1000):
        session.report({"i": i})


def _regression_data():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(4, 1)) * 0.1).astype(np.float32)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    return w, x, x @ np.ones((4, 1), np.float32)


def loop_trains(config):
    """20 steps of SGD(0.1) on a linear regression: with JAX and optax in
    the JAX package's worker (its test's loop), with torch in the port's,
    on the same numpy data and initial weights."""
    session = _air(config, "session")
    w0, x, y = _regression_data()
    losses = []
    if config["pkg"] == "ray_tpu":
        import jax
        import jax.numpy as jnp
        import optax
        tx = optax.sgd(0.1)
        w = jnp.asarray(w0)
        opt = tx.init(w)

        @jax.jit
        def step(w, opt):
            loss, g = jax.value_and_grad(
                lambda w: jnp.mean((x @ w - y) ** 2))(w)
            up, opt = tx.update(g, opt)
            return optax.apply_updates(w, up), opt, loss

        for _ in range(20):
            w, opt, loss = step(w, opt)
            losses.append(float(loss))
    else:
        import torch
        w = torch.tensor(w0, requires_grad=True)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        opt = torch.optim.SGD([w], lr=0.1)
        for _ in range(20):
            opt.zero_grad()
            loss = torch.mean((xt @ w - yt) ** 2)
            loss.backward()
            opt.step()
            losses.append(float(loss))
    session.report({"first_loss": losses[0], "last_loss": losses[-1]})


def loop_explodes(config):
    raise RuntimeError("user loop exploded")


def loop_ddp(config):
    """tests/test_torch_trainer.py's torch loop, on the package's
    torch_utils; it also reports the final parameters."""
    import torch
    import torch.distributed as dist
    session = _air(config, "session")
    torch_utils = importlib.import_module(
        f"{config['pkg']}.train.torch_utils")
    torch.set_num_threads(1)
    assert dist.is_initialized()
    world = dist.get_world_size()
    rank = session.get_world_rank()
    assert world == 2
    torch.manual_seed(0)  # identical init on every rank
    model = torch_utils.prepare_model(torch.nn.Linear(4, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    g = torch.Generator().manual_seed(123 + rank)  # per-rank data
    X = torch.randn(64, 4, generator=g)
    w_true = torch.tensor([[1.0, -2.0, 3.0, 0.5]]).T
    y = X @ w_true
    first = None
    for _ in range(30):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(X), y)
        loss.backward()   # DDP averages grads across ranks
        opt.step()
        if first is None:
            first = float(loss.detach())
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    gathered = [torch.zeros_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat)
    sync = float((gathered[0] - gathered[1]).abs().max())
    session.report({"loss": float(loss.detach()), "first_loss": first,
                    "param_sync_err": sync, "params": flat.tolist(),
                    "backend": dist.get_backend()})


def loop_resumes(config):
    session = _air(config, "session")
    Checkpoint = _air(config, "checkpoint").Checkpoint
    ckpt = session.get_checkpoint()
    start = 0 if ckpt is None else ckpt.to_dict()["step"] + 1
    for step in range(start, config["until"]):
        session.report({"step": step},
                       checkpoint=Checkpoint.from_dict({"step": step}))


def loop_steps_with_checkpoints(config):
    """The elastic and chaos tests' loop: a checkpoint each step, resumed
    after the last one; writes its pid where the chaos thread finds it."""
    session = _air(config, "session")
    Checkpoint = _air(config, "checkpoint").Checkpoint
    if config.get("pid_dir"):
        rank = session.get_world_rank()
        with open(os.path.join(config["pid_dir"], f"rank{rank}.pid"),
                  "w") as f:
            f.write(str(os.getpid()))
    start = 0
    ck = session.get_checkpoint()
    if ck is not None:
        start = ck.to_dict()["step"] + 1
    for step in range(start, config["steps"]):
        time.sleep(config["step_time"])
        session.report(
            {"step": step, "world_size": session.get_world_size()},
            checkpoint=Checkpoint.from_dict({"step": step}))


def loop_lm_mesh(config):
    """The port's LM train step over a dp mesh of the gang's ranks."""
    import logging

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import transformer as ttf
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train import make_lm_train_step
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    cfg = ttf.TransformerConfig(dtype=torch.float32, **config["cfg"])
    mesh = build_mesh(MeshSpec(dp=dist.get_world_size()), device="cpu")
    init_fn, step_fn, place = make_lm_train_step(
        cfg, mesh, learning_rate=config["lr"], device="cpu")
    state = init_fn(convert.params_from_jax(config["params"], cfg,
                                            device="cpu"))
    batch = place({"tokens": np.array(config["tokens"])})
    for _ in range(3):
        state, m = step_fn(state, batch)
        session.report({"loss": m["loss"].item(),
                        "grad_norm": m["grad_norm"].item(),
                        "step": int(m["step"]),
                        "backend": dist.get_backend(),
                        "world": dist.get_world_size()})


def loop_vision_mesh(config):
    """The port's ViT or ResNet train step (``config["model"]``) over a dp
    mesh of the gang's ranks."""
    import logging

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import ResNet, ViTConfig, convert
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train import make_resnet_train_step, make_vit_train_step
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    mesh = build_mesh(MeshSpec(dp=dist.get_world_size()), device="cpu")
    if config["model"] == "vit":
        cfg = ViTConfig(dtype=torch.float32, **VIT_CFG)
        init_fn, step_fn, place = make_vit_train_step(
            cfg, mesh, learning_rate=LM_LR, device="cpu")
        state = init_fn(convert.vit_params_from_jax(config["init"], cfg,
                                                    device="cpu"))
    else:
        init_fn, step_fn, place = make_resnet_train_step(
            mesh, num_classes=10, learning_rate=RESNET_LR,
            dtype=torch.float64, stage_sizes=RESNET_STAGES, device="cpu")
        state = init_fn(convert.resnet_variables_from_jax(
            config["init"], ResNet(RESNET_STAGES, 10), device="cpu"))
    batch = place({k: np.array(v) for k, v in config["batch"].items()})
    for _ in range(3):
        state, m = step_fn(state, batch)
        report = {"loss": m["loss"].item(), "accuracy": m["accuracy"].item(),
                  "step": int(m["step"]), "backend": dist.get_backend(),
                  "world": dist.get_world_size()}
        if config["model"] == "resnet":
            report["bn_init_var"] = state.params["batch_stats"]["bn_init"][
                "var"].full_tensor().tolist()
        session.report(report)


def loop_device(config):
    import os as os_

    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import torch_utils
    session.report({"device": str(torch_utils.get_device()),
                    "visible": os_.environ.get("CUDA_VISIBLE_DEVICES")})


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------


def _plain(value):
    """numpy values -> (dtype, list), so results compare with ==."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, np.ndarray):
        return (str(value.dtype), value.tolist())
    return value


def _summary(result):
    ck = result.checkpoint
    return {"error": None if result.error is None
            else type(result.error).__name__,
            "metrics": result.metrics, "history": result.metrics_history,
            "checkpoint": None if ck is None else _plain(ck.to_dict()),
            "config": {k: v for k, v in result.config.items()
                       if k != "pkg"}}


def _scaling(pkg, **kw):
    air = importlib.import_module(f"{pkg}.air.config")
    if pkg == "ray_tpu_torch":
        kw["use_gpu"] = False     # the JAX package's workers are CPU ones
    return air.ScalingConfig(**kw)


def _run_config(pkg, root, name, **kw):
    air = importlib.import_module(f"{pkg}.air.config")
    return air.RunConfig(storage_path=root, name=name, **kw)


def _trainer(pkg, loop, root, name, cls="DataParallelTrainer", config=None,
             scaling=None, **run_kw):
    train = importlib.import_module(f"{pkg}.train")
    return getattr(train, cls)(
        loop, train_loop_config={"pkg": pkg, **(config or {})},
        scaling_config=scaling or _scaling(pkg, num_workers=1),
        run_config=_run_config(pkg, root, name, **run_kw))


def prog_single_worker_loop_reports(pkg, cluster, root):
    r = _trainer(pkg, loop_reports, root, "t1", config={"iters": 3},
                 scaling=_scaling(pkg, num_workers=1,
                                  cpus_per_worker=1)).fit()
    return _summary(r)


def prog_two_worker_gang_rank_metrics(pkg, cluster, root):
    r = _trainer(pkg, loop_rank_metrics, root, "t2",
                 scaling=_scaling(pkg, num_workers=2,
                                  cpus_per_worker=1)).fit()
    return _summary(r)


def prog_checkpoint_roundtrip(pkg, cluster, root):
    r1 = _trainer(pkg, loop_checkpoints, root, "t3").fit()
    train = importlib.import_module(f"{pkg}.train")
    r2 = train.DataParallelTrainer(
        loop_checkpoints, train_loop_config={"pkg": pkg},
        scaling_config=_scaling(pkg, num_workers=1),
        run_config=_run_config(pkg, root, "t3b"),
        resume_from_checkpoint=r1.checkpoint).fit()
    return [_summary(r1), _summary(r2)]


def prog_stop_condition(pkg, cluster, root):
    r = _trainer(pkg, loop_forever, root, "t4",
                 stop={"training_iteration": 5}).fit()
    return {"error": _summary(r)["error"], "reports": len(r.metrics_history),
            "first": r.metrics_history[:5]}


def prog_loop_trains(pkg, cluster, root):
    r = _trainer(pkg, loop_trains, root, "t5",
                 scaling=_scaling(pkg, num_workers=1,
                                  cpus_per_worker=2)).fit()
    return _summary(r)


def prog_failure_surfaces(pkg, cluster, root):
    r = _trainer(pkg, loop_explodes, root, "t6").fit()
    return {**_summary(r), "exploded": "user loop exploded" in str(r.error)}


def prog_torch_trainer_ddp(pkg, cluster, root):
    r = _trainer(pkg, loop_ddp, root, "ddp", cls="TorchTrainer",
                 scaling=_scaling(pkg, num_workers=2,
                                  resources_per_worker={"CPU": 1})).fit()
    return _summary(r)


def prog_trainer_restore(pkg, cluster, root):
    train = importlib.import_module(f"{pkg}.train")
    t1 = _trainer(pkg, loop_resumes, root, "train_run", config={"until": 3},
                  scaling=_scaling(pkg, num_workers=2))
    r1 = t1.fit()
    trial_dir = os.path.join(root, "train_run")
    can = train.BaseTrainer.can_restore(trial_dir)
    t2 = train.DataParallelTrainer.restore(trial_dir)
    resumed_at = t2.resume_from_checkpoint.to_dict()["step"]
    t2.train_loop_config["until"] = 6
    r2 = t2.fit()
    return {"first": _summary(r1), "can_restore": can,
            "resumed_at": resumed_at, "second": _summary(r2)}


def _restarts(result):
    steps = [m["step"] for m in result.metrics_history]
    return sum(1 for i in range(1, len(steps)) if steps[i] <= steps[i - 1])


def prog_elastic_shrink_on_node_death(pkg, cluster, root):
    """test_elastic_shrink_on_node_death with workers of a head's worth of
    CPUs each (that test's head has 2 and its workers take 2), so the
    surviving head hosts one."""
    air = importlib.import_module(f"{pkg}.air.config")
    node_b = cluster.add_node(num_cpus=HEAD_CPUS)
    cluster.wait_for_nodes(2)
    trainer = _trainer(
        pkg, loop_steps_with_checkpoints, root, "elastic",
        config={"steps": 40, "step_time": 0.1},
        scaling=_scaling(pkg, num_workers=2,
                         cpus_per_worker=float(HEAD_CPUS),
                         placement_strategy="SPREAD"),
        failure_config=air.FailureConfig(max_failures=3, elastic=True))

    def chaos():
        # a few steps and checkpoints land first (the JAX test sleeps 2 s;
        # here the gang's start is waited for, however long it takes)
        ckpt = os.path.join(root, "elastic", "checkpoint_latest")
        deadline = time.time() + 60
        while not os.path.isdir(ckpt) and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)
        cluster.remove_node(node_b)

    killer = threading.Thread(target=chaos, daemon=True)
    killer.start()
    result = trainer.fit()
    killer.join(timeout=30)
    return {"error": None if result.error is None else str(result.error),
            "step": result.metrics.get("step"),
            "world_size": result.metrics.get("world_size"),
            "restarts_at_most_one": _restarts(result) <= 1,
            "resumed": result.metrics_history[0]["step"] > 0}


def prog_elastic_training_survives_rank_kill(pkg, cluster, root,
                                             seed=1234):
    air = importlib.import_module(f"{pkg}.air.config")
    pid_dir = os.path.join(root, "pids")
    os.makedirs(pid_dir, exist_ok=True)
    killed = {}

    def chaos():
        path = os.path.join(pid_dir, "rank1.pid")
        deadline = time.time() + 30
        while not os.path.exists(path) and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.5 + (seed % 100) / 100.0)  # seeded kill offset
        try:
            pid = int(open(path).read())
            os.kill(pid, signal.SIGKILL)
            killed["pid"] = pid
        except (ValueError, OSError):
            pass

    trainer = _trainer(
        pkg, loop_steps_with_checkpoints, root, "chaos",
        config={"steps": 25, "step_time": 0.1, "pid_dir": pid_dir},
        scaling=_scaling(pkg, num_workers=2, cpus_per_worker=1.0),
        failure_config=air.FailureConfig(max_failures=3))
    killer = threading.Thread(target=chaos, daemon=True)
    killer.start()
    result = trainer.fit()
    killer.join(timeout=60)
    return {"error": None if result.error is None else str(result.error),
            "step": result.metrics.get("step"),
            "world_size": result.metrics.get("world_size"),
            "killed": bool(killed.get("pid")),
            "restarts_at_most_one": _restarts(result) <= 1,
            "resumed": result.metrics_history[0]["step"] > 0}


def prog_weight_broadcast_to_worker_gang(pkg, cluster, root):
    wg_mod = importlib.import_module(f"{pkg}.train.worker_group")
    wg = wg_mod.WorkerGroup(num_workers=2, resources_per_worker={"CPU": 1.0})
    try:
        params = {"w": np.arange(1 << 16, dtype=np.float32),
                  "b": np.zeros(128, dtype=np.float32)}
        outs = wg.broadcast_weights(params)
        return [len(outs)] + [
            [bool(np.array_equal(got["w"], params["w"])),
             bool(np.array_equal(got["b"], params["b"]))] for got in outs]
    finally:
        wg.shutdown()


PROGRAMS = {name[len("prog_"):]: fn for name, fn in sorted(globals().items())
            if name.startswith("prog_")}


# ---------------------------------------------------------------------------
# running them
# ---------------------------------------------------------------------------


def _jax_lm_steps():
    """The JAX step on build_mesh(MeshSpec(dp=1)) over the whole batch:
    its initial weights (numpy), the tokens and 3 steps' metrics."""
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
    tokens = np.random.default_rng(1).integers(
        0, LM_CFG["vocab_size"], (LM_B, LM_S)).astype(np.int32)
    batch = place({"tokens": tokens})
    metrics = []
    for _ in range(3):
        state, m = step_fn(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
    return {"params": init, "tokens": tokens, "metrics": metrics}


def _vision_batch(size):
    rng = np.random.default_rng(2)
    return {"image": rng.standard_normal((LM_B, size, size, 3))
            .astype(np.float32),
            "label": rng.integers(0, 10, (LM_B,)).astype(np.int32)}


def _jax_vision_steps(model):
    """The JAX ViT or ResNet step on build_mesh(MeshSpec(dp=1)) over the
    whole batch: its initial weights (numpy), the batch and 3 steps'
    metrics (and, for the ResNet, the first BatchNorm's running
    variances). The ResNet is the small model computing in float64, its
    variables flax's tree filled with seeded values (flax's init zeroes
    each block's last BatchNorm scale), its state built as its init_fn
    builds it, without flax's eager init."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import resnet as jres
    from ray_tpu.models import vit as jvit
    from ray_tpu.parallel import MeshSpec, build_mesh
    from ray_tpu.parallel.sharding import replicated
    from ray_tpu.train import jax_step
    mesh = build_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    if model == "vit":
        init_fn, step_fn, place = jax_step.make_vit_train_step(
            jvit.ViTConfig(dtype=jnp.float32, **VIT_CFG), mesh,
            learning_rate=LM_LR)
        state = init_fn(jax.random.PRNGKey(0))
        init = jax.tree.map(np.array, state.params)  # the step donates it
        batch = _vision_batch(VIT_CFG["image_size"])
        return init, batch, _jax_vision_run(step_fn, state, place(batch))
    net = jres.ResNet(list(RESNET_STAGES), 10, jnp.float64)
    shapes = jax.eval_shape(lambda: net.clone(dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, RESNET_SIZE, RESNET_SIZE, 3)),
        train=True))
    rng = np.random.default_rng(4)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = 0.1 * rng.standard_normal(shape)
        return x.astype(np.float32)

    init = jax.tree_util.tree_map_with_path(fill, shapes)
    tx = optax.sgd(RESNET_LR, momentum=0.9, nesterov=True)
    build = jax_step.resnet50
    jax_step.resnet50 = lambda num_classes: net
    try:
        with jax.enable_x64(True):
            _, step_fn, place = jax_step.make_resnet_train_step(
                mesh, num_classes=10, image_size=RESNET_SIZE, tx=tx)
            variables = jax.device_put(init, replicated(mesh))
            state = jax_step.TrainState(
                variables, jax.jit(tx.init)(variables["params"]),
                jax.device_put(jnp.zeros((), jnp.int32), replicated(mesh)))
            batch = _vision_batch(RESNET_SIZE)
            return init, batch, _jax_vision_run(step_fn, state,
                                                place(batch))
    finally:
        jax_step.resnet50 = build


def _jax_vision_run(step_fn, state, batch):
    metrics = []
    for i in range(3):
        state, m = step_fn(state, batch)
        metrics.append((float(m["loss"]), float(m["accuracy"]), i + 1))
    stats = state.params.get("batch_stats") if isinstance(
        state.params, dict) else None
    return metrics, (None if not stats else
                     np.array(stats["bn_init"]["var"]).tolist())


def _jax_run(root):
    import sys

    import cloudpickle

    from ray_tpu.cluster.cluster_utils import Cluster as JaxCluster
    from ray_tpu.core import api
    from ray_tpu.core.runtime_cluster import ClusterRuntime
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    out = {"_lm": _jax_lm_steps(),
           "_vision": {m: _jax_vision_steps(m) for m in ("vit", "resnet")}}
    c = JaxCluster(initialize_head=True,
                   head_node_args={"num_cpus": HEAD_CPUS},
                   health_timeout_s=HEALTH_TIMEOUT_S)
    try:
        api._runtime = ClusterRuntime(address=c.address)
        try:
            for name, prog in PROGRAMS.items():
                where = os.path.join(root, name)
                os.makedirs(where, exist_ok=True)
                try:
                    out[name] = ("value", prog("ray_tpu", c, where))
                except Exception as e:  # noqa: BLE001
                    out[name] = ("raised", type(e).__name__, str(e)[:300])
        finally:
            api._runtime.shutdown()
            api._runtime = None
    finally:
        c.shutdown()
        cloudpickle.unregister_pickle_by_value(module)
    return out


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
    return _once(tmp_path_factory, "torch_train_gang_jax", _jax_run)


@pytest.fixture(scope="module")
def cluster(jax_runs):
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": HEAD_CPUS},
                health_timeout_s=HEALTH_TIMEOUT_S)
    rt.shutdown()    # whatever runtime an earlier module left in this worker
    rt.init(address=c.address)
    prefixes = {n.store_prefix for n in c.nodes}
    yield c
    prefixes.update(n.store_prefix for n in c.nodes)
    rt.shutdown()
    c.shutdown()
    deadline = time.monotonic() + 10.0
    while _store_files(prefixes) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _store_files(prefixes)


def _store_files(prefixes):
    return [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p) for p in prefixes)]


def _port(name, cluster, tmp_path):
    return PROGRAMS[name]("ray_tpu_torch", cluster, str(tmp_path))


def _want(jax_runs, name):
    want = jax_runs[name]
    assert want[0] == "value", f"the JAX cluster raised: {want}"
    return want[1]


def _no_live_groups():
    from ray_tpu_torch.util.placement_group import placement_group_table
    return [g for g in placement_group_table()
            if g["state"] in ("PENDING", "CREATED")]


@pytest.fixture(autouse=True)
def _gang_hygiene(request):
    """No placement group of a trainer is left after a test."""
    yield
    if "cluster" not in request.fixturenames:
        return
    deadline = time.monotonic() + 5.0
    while _no_live_groups() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _no_live_groups()


# ---------------------------------------------------------------------------
# tests/test_train_trainer.py
# ---------------------------------------------------------------------------


def test_single_worker_loop_reports(cluster, jax_runs, tmp_path):
    got = _port("single_worker_loop_reports", cluster, tmp_path)
    assert got == _want(jax_runs, "single_worker_loop_reports")
    assert got["error"] is None
    assert got["metrics"]["iter"] == 2
    assert len(got["history"]) == 3


def test_two_worker_gang_rank_metrics(cluster, jax_runs, tmp_path):
    got = _port("two_worker_gang_rank_metrics", cluster, tmp_path)
    assert got == _want(jax_runs, "two_worker_gang_rank_metrics")
    assert got["metrics"] == {"rank": 0, "world": 2}  # rank-0 metrics win


def test_checkpoint_roundtrip(cluster, jax_runs, tmp_path):
    got = _port("checkpoint_roundtrip", cluster, tmp_path)
    assert got == _want(jax_runs, "checkpoint_roundtrip")
    r1, r2 = got
    assert r1["checkpoint"]["step"] == 2
    assert r2["metrics"]["step_done"] == 3  # resumed from step 2
    assert r2["checkpoint"]["w"] == ("float64", [4.0] * 4)


def test_stop_condition(cluster, jax_runs, tmp_path):
    got = _port("stop_condition", cluster, tmp_path)
    want = _want(jax_runs, "stop_condition")
    assert got["error"] is None and want["error"] is None
    assert got["first"] == want["first"] == [{"i": i} for i in range(5)]
    assert got["reports"] <= 6 and want["reports"] <= 6


def test_loop_trains(cluster, jax_runs, tmp_path):
    """test_jax_loop_trains: the JAX package's loop trains with JAX, the
    port's with torch, on the same data; their losses agree to LOOP_TOL."""
    got = _port("loop_trains", cluster, tmp_path)
    want = _want(jax_runs, "loop_trains")
    assert got["error"] is None and want["error"] is None
    for key in ("first_loss", "last_loss"):
        assert got["metrics"][key] == pytest.approx(want["metrics"][key],
                                                    rel=LOOP_TOL)
    assert got["metrics"]["last_loss"] < got["metrics"]["first_loss"] * 0.2


def test_failure_surfaces(cluster, jax_runs, tmp_path):
    got = _port("failure_surfaces", cluster, tmp_path)
    assert got == _want(jax_runs, "failure_surfaces")
    assert got["error"] == "TrainingFailedError" and got["exploded"]


# ---------------------------------------------------------------------------
# tests/test_torch_trainer.py::test_torch_trainer_ddp
# ---------------------------------------------------------------------------


def test_torch_trainer_ddp(cluster, jax_runs, tmp_path):
    """The same torch loop in both packages' TorchTrainer over 2 gloo
    workers: the same final loss and parameters, ranks in sync."""
    got = _port("torch_trainer_ddp", cluster, tmp_path)
    want = _want(jax_runs, "torch_trainer_ddp")
    assert got["error"] is None and want["error"] is None
    g, w = got["metrics"], want["metrics"]
    assert g["backend"] == w["backend"] == "gloo"
    assert g["loss"] < g["first_loss"] * 0.2
    assert g["param_sync_err"] < 1e-6
    np.testing.assert_allclose(g["params"], w["params"], atol=DDP_TOL)
    for key in ("loss", "first_loss"):
        assert g[key] == pytest.approx(w[key], abs=DDP_TOL)


# ---------------------------------------------------------------------------
# restore, elastic shrink, rank kill, weight broadcast
# ---------------------------------------------------------------------------


def test_trainer_restore_resumes_from_checkpoint(cluster, jax_runs,
                                                 tmp_path):
    got = _port("trainer_restore", cluster, tmp_path)
    assert got == _want(jax_runs, "trainer_restore")
    assert got["first"]["metrics"]["step"] == 2 and got["can_restore"]
    assert got["resumed_at"] == 2
    # resumed at 3 (not 0) and ran through 5
    assert got["second"]["metrics"]["step"] == 5
    assert got["second"]["history"][0]["step"] == 3


def test_elastic_shrink_on_node_death(cluster, jax_runs, tmp_path):
    got = _port("elastic_shrink_on_node_death", cluster, tmp_path)
    assert got == _want(jax_runs, "elastic_shrink_on_node_death")
    assert got == {"error": None, "step": 39, "world_size": 1,
                   "restarts_at_most_one": True, "resumed": True}


def test_elastic_training_survives_rank_kill(cluster, jax_runs, tmp_path,
                                             chaos_seed):
    got = PROGRAMS["elastic_training_survives_rank_kill"](
        "ray_tpu_torch", cluster, str(tmp_path), seed=chaos_seed)
    assert got == _want(jax_runs, "elastic_training_survives_rank_kill")
    assert got == {"error": None, "step": 24, "world_size": 2,
                   "killed": True, "restarts_at_most_one": True,
                   "resumed": True}


def test_weight_broadcast_to_worker_gang(cluster, jax_runs, tmp_path):
    got = _port("weight_broadcast_to_worker_gang", cluster, tmp_path)
    assert got == _want(jax_runs, "weight_broadcast_to_worker_gang")
    assert got == [2, [True, True], [True, True]]


# ---------------------------------------------------------------------------
# a real step in a gang
# ---------------------------------------------------------------------------


def test_lm_step_in_a_two_rank_gang_matches_jax_dp1(cluster, jax_runs,
                                                    tmp_path):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    lm = jax_runs["_lm"]
    r = TorchTrainer(
        loop_lm_mesh,
        train_loop_config={"cfg": LM_CFG, "lr": LM_LR,
                           "params": lm["params"], "tokens": lm["tokens"]},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=_run_config("ray_tpu_torch", str(tmp_path), "lm")).fit()
    assert r.error is None, r.error
    got = [(m["loss"], m["grad_norm"], m["step"]) for m in r.metrics_history]
    want = lm["metrics"]
    assert [m[2] for m in got] == [m[2] for m in want] == [1, 2, 3]
    np.testing.assert_allclose([m[:2] for m in got], [m[:2] for m in want],
                               rtol=STEP_TOL)
    assert want[-1][0] < want[0][0]
    assert {m["backend"] for m in r.metrics_history} == {"gloo"}
    assert {m["world"] for m in r.metrics_history} == {2}


@pytest.mark.parametrize("model", ["vit", "resnet"])
def test_vision_step_in_a_two_rank_gang_matches_jax_dp1(cluster, jax_runs,
                                                        tmp_path, model):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    init, batch, (want, want_var) = jax_runs["_vision"][model]
    r = TorchTrainer(
        loop_vision_mesh,
        train_loop_config={"model": model, "init": init, "batch": batch},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=_run_config("ray_tpu_torch", str(tmp_path), model)).fit()
    assert r.error is None, r.error
    got = [(m["loss"], m["accuracy"], m["step"]) for m in r.metrics_history]
    assert [m[2] for m in got] == [m[2] for m in want] == [1, 2, 3]
    tol = STEP_TOL if model == "vit" else F64_LOSS_TOL
    np.testing.assert_allclose([m[0] for m in got], [m[0] for m in want],
                               rtol=tol)
    assert [m[1] for m in got] == [m[1] for m in want]
    assert want[-1][0] < want[0][0]
    if model == "resnet":
        np.testing.assert_allclose(r.metrics_history[-1]["bn_init_var"],
                                   want_var, rtol=F64_TOL)
    assert {m["backend"] for m in r.metrics_history} == {"gloo"}
    assert {m["world"] for m in r.metrics_history} == {2}


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


def test_gpu_gang_without_cards_raises_at_fit_at_once(cluster, tmp_path):
    """``use_gpu`` left at None asks a card a worker; the cluster counts
    none, so fit() raises before any placement group or worker exists."""
    from ray_tpu_torch.train import (DataParallelTrainer, ScalingConfig,
                                     TorchTrainer)
    for cls in (TorchTrainer, DataParallelTrainer):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(loop_reports, train_loop_config={"pkg": "ray_tpu_torch",
                                                 "iters": 1},
                scaling_config=ScalingConfig(num_workers=1),
                run_config=_run_config("ray_tpu_torch", str(tmp_path),
                                       "nocard")).fit()
        assert time.monotonic() - t0 < 5.0
    assert not _no_live_groups()


def test_workers_take_their_cards_from_their_bundles(cluster, tmp_path):
    """On a node that counts two cards (faked on the CPU), a gang left at
    use_gpu=None gets one card a worker through its bundles: each worker
    sees its own index, and get_device() gives its cuda:0."""
    from ray_tpu_torch.train import (DataParallelTrainer, ScalingConfig,
                                     backend_executor)
    from ray_tpu_torch.train.worker_group import WorkerGroup
    node = cluster.add_node(num_cpus=2, num_gpus=2)
    cluster.wait_for_nodes(2)
    try:
        wg = WorkerGroup(2, ScalingConfig(num_workers=2).worker_resources())
        try:
            cards = wg.execute(backend_executor._visible_card)
        finally:
            wg.shutdown()
        assert sorted(c[1] for c in cards) == ["0", "1"]
        r = DataParallelTrainer(
            loop_device, scaling_config=ScalingConfig(num_workers=2),
            run_config=_run_config("ray_tpu_torch", str(tmp_path),
                                   "cards")).fit()
        assert r.error is None, r.error
        assert r.metrics["device"] == "cuda:0"
        assert r.metrics["visible"] in ("0", "1")
    finally:
        cluster.remove_node(node, graceful=True)


def test_nccl_gang_of_two_on_one_card_raises_before_any_group(cluster,
                                                              tmp_path):
    """Two ranks of half a card each land on the same card: NCCL would
    put both on it, so the gang raises ValueError before any rank calls
    init_process_group, and leaves no placement group."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    node = cluster.add_node(num_cpus=2, num_gpus=1)
    cluster.wait_for_nodes(2)
    try:
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="distinct cards"):
            TorchTrainer(
                loop_ddp, train_loop_config={"pkg": "ray_tpu_torch"},
                scaling_config=ScalingConfig(num_workers=2,
                                             gpus_per_worker=0.5),
                run_config=_run_config("ray_tpu_torch", str(tmp_path),
                                       "nccl")).fit()
        assert time.monotonic() - t0 < 60.0
        assert not _no_live_groups()
    finally:
        cluster.remove_node(node, graceful=True)


def test_lambda_loop_raises_type_error_naming_module_level(cluster,
                                                           tmp_path):
    from ray_tpu_torch.train import DataParallelTrainer, ScalingConfig
    with pytest.raises(TypeError, match="module level"):
        DataParallelTrainer(
            lambda: None, scaling_config=ScalingConfig(use_gpu=False),
            run_config=_run_config("ray_tpu_torch", str(tmp_path),
                                   "lambda")).fit()
