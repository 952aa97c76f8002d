"""Port parity: the ViT and ResNet train steps on a mesh, and the MoE layer
with expert parallelism (the ``ep`` axis), ray_tpu_torch against the JAX
package on the same 4-way meshes.

- ViT: 3 AdamW steps of ``make_vit_train_step(cfg, mesh)`` on dp4,
  dp2-fsdp2 and fsdp2-tp2 against the JAX step on the same mesh.
- ResNet: 3 SGD steps of ``make_resnet_train_step(mesh)`` on dp4 and
  dp2-fsdp2 against the JAX step on the same mesh (the JAX step's code on
  a small model that computes in float64, as ``tests/test_torch_resnet.py``
  runs it), and against the port's one-device step on the whole batch:
  BatchNorm's statistics are those of the global batch, not of each rank's
  rows.
- MoE: the layer (``moe_apply``) on ep4, dp2-ep2 and ep2-tp2 with inputs
  leaned toward expert 0, so that the training capacity factor drops tokens,
  against the JAX layer, its output and every gradient, and with
  ``CommDebugMode`` counting its collectives (one all-reduce, no all-gather
  of an expert weight); the LM with 4 experts, top-2, on the same meshes,
  3 AdamW steps against the JAX step on the same mesh, the first loss also
  against the JAX loss on one device.

The JAX side runs on 4-device sub-meshes of the conftest's 8 host devices,
at f32; the port's side as four gloo ranks, started once for the file by
``torch.multiprocessing`` (spawn) over a ``file://`` store, each rank on
one intra-op thread, while the parent computes the JAX side. Weights are
the JAX package's (``vit_params_from_jax``, ``resnet_variables_from_jax``,
``params_from_jax``); the ResNet variables are flax's tree filled with
seeded values (flax's init zeroes each block's last BatchNorm scale, which
hides the branch); images, labels, tokens and the MoE inputs are seeded
numpy.

Tolerances: along the 3 steps at f32 the losses (and gradient norms)
1e-4 relative and every parameter 1e-4 absolute, as the LM's mesh steps in
``tests/test_torch_train_mesh.py``; accuracies equal. The ResNet computes
in float64 in both stacks (parameters, the head and the updates f32): its
last stage normalises 8 values a channel (batch 8 on 1x1 maps), where an
f32 variance is ill-conditioned, and at f32 the first SGD step (lr 0.01,
the loss falls from 3.0 to 0.08) already leaves the port's one-device step,
its mesh step and the JAX step 3e-3 apart in the second loss and 1e-3 in
the parameters; in float64 they agree to 2.4e-7 (one f32 rounding of a
parameter), so parameters and batch statistics are held to 1e-6 and the
losses to 1e-5 relative (the third loss, near 4e-3, moves by 4e-6 of itself
with that rounding).
The MoE layer's output and gradients 1e-5, the LM's first loss 1e-5 of
both JAX losses.
"""

import datetime
import fcntl
import logging
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import resnet as tres
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.parallel import mesh as tmesh

WORLD = 4
STEP_TOL = 1e-4
LOSS_TOL = 1e-5
F64_TOL = 1e-6
F64_LOSS_TOL = 1e-5
B = 8
VIT = dict(image_size=16, patch_size=4, num_classes=10, d_model=32,
           n_layers=2, n_heads=4)
VIT_SPECS = {"dp4": {"dp": 4}, "dp2-fsdp2": {"dp": 2, "fsdp": 2},
             "fsdp2-tp2": {"fsdp": 2, "tp": 2}}
SMALL = (1, 1, 1, 1)
RESNET = dict(num_classes=10, image_size=32, learning_rate=0.01)
RESNET_SPECS = {"dp4": {"dp": 4}, "dp2-fsdp2": {"dp": 2, "fsdp": 2}}
MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq=32, attn_impl="reference", num_experts=4,
           expert_top_k=2)
MOE_SPECS = {"ep4": {"ep": 4}, "dp2-ep2": {"dp": 2, "ep": 2},
             "ep2-tp2": {"ep": 2, "tp": 2}}
S = 16                   # the LM's tokens a row
LAYER = dict(b=4, s=32, d=32, e=4, f=48)   # the MoE layer's inputs
LR = 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _images(size, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((B, size, size, 3))
            .astype(np.float32),
            "label": rng.integers(0, 10, (B,)).astype(np.int32)}


def _tokens():
    return {"tokens": np.random.default_rng(1).integers(
        0, MOE["vocab_size"], (B, S)).astype(np.int32)}


def _layer_inputs():
    """The MoE layer's params, input and output cotangent, with every
    token leaned toward expert 0 (``tests/test_torch_moe.py``), so that at
    capacity factor 1.25 expert 0 overflows."""
    b, s, d, e, f = (LAYER[k] for k in "bsdef")
    rng = np.random.default_rng(0)
    params = {"router": rng.standard_normal((d, e)).astype(np.float32) * 0.5,
              "w1": rng.standard_normal((e, d, f)).astype(np.float32) * 0.2,
              "w3": rng.standard_normal((e, d, f)).astype(np.float32) * 0.2,
              "w2": rng.standard_normal((e, f, d)).astype(np.float32) * 0.2}
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    lean = params["router"][:, 0] / np.linalg.norm(params["router"][:, 0])
    cot = rng.standard_normal((b, s, d)).astype(np.float32)
    return params, h + 2.0 * lean, cot


def _layer_cfg():
    return ttf.TransformerConfig(dtype=torch.float32, d_model=LAYER["d"],
                                 num_experts=LAYER["e"], expert_top_k=2)


# ---------------------------------------------------------------------------
# the gloo world (runs in the spawned ranks; imports no JAX)
# ---------------------------------------------------------------------------

def _rank_main(rank, root, body):
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        with open(os.path.join(root, "inputs.pkl"), "rb") as f:
            out = body(rank, pickle.load(f))
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _full(tree):
    return {k: v.detach().full_tensor().numpy()
            for k, v in _flat(tree).items()}


def _steps(step_fn, state, batch, keys):
    metrics = []
    for _ in range(3):
        state, m = step_fn(state, batch)
        metrics.append(tuple(float(m[k]) for k in keys) + (m["step"],))
    return state, metrics


def _world_body(rank, inputs):
    from ray_tpu_torch.train import (make_lm_train_step,
                                     make_resnet_train_step,
                                     make_vit_train_step)
    meshes = {}

    def mesh_of(spec_kw):
        key = tuple(sorted(spec_kw.items()))
        if key not in meshes:
            meshes[key] = tmesh.build_mesh(tmesh.MeshSpec(**spec_kw),
                                           device="cpu")
        return meshes[key]

    out = {}
    vcfg = tvit.ViTConfig(dtype=torch.float32, **VIT)
    for name, spec_kw in VIT_SPECS.items():
        init_fn, step_fn, place = make_vit_train_step(
            vcfg, mesh_of(spec_kw), learning_rate=LR, device="cpu")
        state = init_fn(convert.vit_params_from_jax(inputs["vit"], vcfg,
                                                    device="cpu"))
        state, out[f"vit/{name}/metrics"] = _steps(
            step_fn, state, place(_images(VIT["image_size"], 2)),
            ("loss", "accuracy"))
        out[f"vit/{name}/params"] = _full(state.params)
    model = tres.ResNet(SMALL, RESNET["num_classes"], torch.float64)
    for name, spec_kw in RESNET_SPECS.items():
        init_fn, step_fn, place = make_resnet_train_step(
            mesh_of(spec_kw), dtype=torch.float64, stage_sizes=SMALL,
            device="cpu", **RESNET)
        state = init_fn(convert.resnet_variables_from_jax(
            inputs["resnet"], model, device="cpu"))
        state, out[f"resnet/{name}/metrics"] = _steps(
            step_fn, state, place(_images(RESNET["image_size"], 3)),
            ("loss", "accuracy"))
        out[f"resnet/{name}/variables"] = _full(state.params)
    mcfg = ttf.TransformerConfig(dtype=torch.float32, **MOE)
    for name, spec_kw in MOE_SPECS.items():
        mesh = mesh_of(spec_kw)
        out[f"layer/{name}"] = _layer_on_mesh(mesh)
        init_fn, step_fn, place = make_lm_train_step(
            mcfg, mesh, learning_rate=LR, device="cpu")
        state = init_fn(convert.params_from_jax(inputs["moe"], mcfg,
                                                device="cpu"))
        state, out[f"moe/{name}/metrics"] = _steps(
            step_fn, state, place(_tokens()), ("loss", "grad_norm"))
        out[f"moe/{name}/params"] = _full(state.params)
    return out


def _layer_on_mesh(mesh):
    """``moe_apply`` on the mesh, forward and backward under
    ``CommDebugMode`` -> (output, gradients, the collectives' counts)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from ray_tpu_torch.models.moe import moe_apply
    from ray_tpu_torch.parallel.sharding import (batch_sharding, place,
                                                 shard_pytree)
    cfg = _layer_cfg()
    params, h, cot = _layer_inputs()
    axes = {k: v[1:] for k, v in
            ttf.transformer_logical_axes(cfg)["layers"]["moe"].items()}
    params = shard_pytree({k: torch.from_numpy(v) for k, v in params.items()},
                          mesh, axes)
    h = place(torch.from_numpy(h), batch_sharding(mesh, 3))
    cot = place(torch.from_numpy(cot), batch_sharding(mesh, 3))
    for t in [h, *params.values()]:
        t.requires_grad_(True)
    with CommDebugMode() as comm:
        y = moe_apply(cfg, params, h, mesh=mesh, device="cpu")
        y.backward(cot)
    grads = {k: v.grad.full_tensor().numpy() for k, v in params.items()}
    grads["h"] = h.grad.full_tensor().numpy()
    return (y.detach().full_tensor().numpy(), grads,
            {str(op): n for op, n in comm.get_comm_counts().items()})


def _start_world(root, inputs):
    """The ranks run while the caller goes on (the JAX side)."""
    import torch.multiprocessing as mp
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return mp.spawn(_rank_main, args=(str(root), _world_body),
                    nprocs=WORLD, join=False)


def _join_world(ctx, root):
    while not ctx.join():
        pass
    out = []
    for r in range(WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the JAX side (the parent process)
# ---------------------------------------------------------------------------

def _np_tree(tree):
    import jax
    return jax.tree.map(np.array, tree)


def _jax_mesh(spec_kw):
    import jax
    from ray_tpu.parallel import MeshSpec, build_mesh
    return build_mesh(MeshSpec(**spec_kw), devices=jax.devices()[:WORLD])


def _jax_steps(make, state, batch, keys):
    """3 steps of ``make``'s step from ``state`` -> (metrics, final params
    numpy)."""
    _, step_fn, place = make
    batch = place(batch)
    metrics = []
    for i in range(3):
        state, m = step_fn(state, batch)
        metrics.append(tuple(float(m[k]) for k in keys) + (i + 1,))
    return metrics, _np_tree(state.params)


def _jax_state(make, init):
    """``make``'s init_fn's state with ``init`` (numpy) for its params."""
    import jax
    state = make[0](jax.random.PRNGKey(0))
    state.params = jax.device_put(init, jax.tree.map(
        lambda a: a.sharding, state.params))
    return state


def _jax_resnet_state(mesh, variables, tx):
    """The JAX ResNet step's state from ``variables`` (numpy), as its
    init_fn places it, without flax's eager init of the model."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.parallel.sharding import replicated
    from ray_tpu.train import jax_step
    variables = jax.device_put(variables, replicated(mesh))
    return jax_step.TrainState(
        variables, jax.jit(tx.init)(variables["params"]),
        jax.device_put(jnp.zeros((), jnp.int32), replicated(mesh)))


def _resnet_variables():
    """flax's tree of the small f32 ResNet filled with seeded values:
    kernels normal over sqrt(fan-in), scales and running variances in [0.5,
    1.5], biases and running means normal(0.1)."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import resnet as jres
    model = jres.ResNet(list(SMALL), RESNET["num_classes"], jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))
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

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_side(inputs):
    import jax
    import jax.numpy as jnp
    import optax
    from ray_tpu.models import moe as jmoe
    from ray_tpu.models import resnet as jres
    from ray_tpu.models import transformer as jtf
    from ray_tpu.models import vit as jvit
    from ray_tpu.train import jax_step
    out = {}
    vcfg = jvit.ViTConfig(dtype=jnp.float32, **VIT)
    for name, spec_kw in VIT_SPECS.items():
        make = jax_step.make_vit_train_step(vcfg, _jax_mesh(spec_kw),
                                            learning_rate=LR)
        out[f"vit/{name}"] = _jax_steps(
            make, _jax_state(make, inputs["vit"]),
            _images(VIT["image_size"], 2), ("loss", "accuracy"))
    # the JAX step builds resnet50() in bf16: the same step code on the
    # small model in float64
    build = jax_step.resnet50
    jax_step.resnet50 = lambda num_classes: jres.ResNet(
        list(SMALL), num_classes, jnp.float64)
    try:
        with jax.enable_x64(True):
            for name, spec_kw in RESNET_SPECS.items():
                mesh = _jax_mesh(spec_kw)
                # the step's own default, passed to build its state
                tx = optax.sgd(RESNET["learning_rate"], momentum=0.9,
                               nesterov=True)
                out[f"resnet/{name}"] = _jax_steps(
                    jax_step.make_resnet_train_step(mesh, tx=tx, **RESNET),
                    _jax_resnet_state(mesh, inputs["resnet"], tx),
                    _images(RESNET["image_size"], 3), ("loss", "accuracy"))
    finally:
        jax_step.resnet50 = build
    mcfg = jtf.TransformerConfig(dtype=jnp.float32, **MOE)
    for name, spec_kw in MOE_SPECS.items():
        make = jax_step.make_lm_train_step(mcfg, _jax_mesh(spec_kw),
                                           learning_rate=LR)
        out[f"moe/{name}"] = _jax_steps(
            make, _jax_state(make, inputs["moe"]), _tokens(),
            ("loss", "grad_norm"))
    out["moe/one_device_loss"] = float(jax.jit(
        lambda p, b: jtf.transformer_loss(p, b, mcfg))(inputs["moe"],
                                                       _tokens()))
    params, h, cot = _layer_inputs()
    lcfg = jtf.TransformerConfig(dtype=jnp.float32, d_model=LAYER["d"],
                                 num_experts=LAYER["e"], expert_top_k=2)

    def layer(p, h, c):
        y, vjp = jax.vjp(lambda p, h: jmoe.moe_apply(lcfg, p, h), p, h)
        return y, vjp(c)

    y, (dp, dh) = jax.jit(layer)(params, h, cot)
    out["layer"] = (np.asarray(y), {**_np_tree(dp), "h": np.asarray(dh)})
    return out


def _once(tmp_path_factory, name, compute):
    """``compute(directory)`` once for the whole run, its result shared by
    the xdist workers through a pickle under the run's temporary root (a
    file lock lets one compute while the others wait)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"{name}.pkl"
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            result = compute(tmp_path_factory.mktemp(name))
            with open(base / f"{name}.part", "wb") as f:
                pickle.dump(result, f)
            os.replace(base / f"{name}.part", path)
    with open(path, "rb") as f:
        return pickle.load(f)


def _compute(root):
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jtf
    from ray_tpu.models import vit as jvit
    inputs = {
        "vit": _np_tree(jvit.vit_init(jax.random.PRNGKey(0), jvit.ViTConfig(
            dtype=jnp.float32, **VIT))),
        "resnet": _np_tree(_resnet_variables()),
        "moe": _np_tree(jtf.transformer_init(
            jax.random.PRNGKey(5), jtf.TransformerConfig(dtype=jnp.float32,
                                                         **MOE))),
    }
    ctx = _start_world(root, inputs)
    want = _jax_side(inputs)
    return {"port": _join_world(ctx, root), "jax": want, "inputs": inputs}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case of the file: the port's in one world of 4 gloo ranks
    (``"port"``, a dict a rank), the JAX side's (``"jax"``) and the
    weights both started from (``"inputs"``)."""
    return _once(tmp_path_factory, "gloo_mesh_steps", _compute)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _assert_metrics(got, want, what, tol=STEP_TOL):
    assert [m[-1] for m in got] == [m[-1] for m in want] == [1, 2, 3], what
    np.testing.assert_allclose([m[0] for m in got], [m[0] for m in want],
                               rtol=tol, err_msg=what)


def _assert_params(got, want, what, tol=STEP_TOL):
    assert set(got) == set(want), what
    for path, value in got.items():
        np.testing.assert_allclose(value, want[path], atol=tol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", sorted(VIT_SPECS))
def test_vit_steps_match_jax_on_the_same_mesh(world, name):
    want, _ = world["jax"][f"vit/{name}"]
    for r in range(WORLD):
        got = world["port"][r][f"vit/{name}/metrics"]
        _assert_metrics(got, want, f"rank {r}")
        assert [m[1] for m in got] == [m[1] for m in want]   # accuracy
    assert want[-1][0] < want[0][0]


@pytest.mark.parametrize("name", sorted(VIT_SPECS))
def test_vit_step_params_match_jax_on_the_same_mesh(world, name):
    _, want = world["jax"][f"vit/{name}"]
    for r in range(WORLD):
        _assert_params(world["port"][r][f"vit/{name}/params"], _flat(want),
                       f"rank {r}")


def _resnet_port_layout(tree):
    model = tres.ResNet(SMALL, RESNET["num_classes"], torch.float32)
    return {k: v.numpy() for k, v in _flat(convert.resnet_variables_from_jax(
        tree, model, device="cpu")).items()}


@pytest.mark.parametrize("name", sorted(RESNET_SPECS))
def test_resnet_steps_match_jax_on_the_same_mesh(world, name):
    want, _ = world["jax"][f"resnet/{name}"]
    for r in range(WORLD):
        got = world["port"][r][f"resnet/{name}/metrics"]
        _assert_metrics(got, want, f"rank {r}", F64_LOSS_TOL)
        assert [m[1] for m in got] == [m[1] for m in want]   # accuracy
    assert want[-1][0] < want[0][0]


@pytest.mark.parametrize("name", sorted(RESNET_SPECS))
def test_resnet_params_and_batch_stats_match_jax_on_the_same_mesh(world,
                                                                  name):
    _, want = world["jax"][f"resnet/{name}"]
    want = _resnet_port_layout(want)
    assert any(k.startswith("batch_stats/") for k in want)
    for r in range(WORLD):
        _assert_params(world["port"][r][f"resnet/{name}/variables"], want,
                       f"rank {r}", F64_TOL)


@pytest.fixture(scope="module")
def one_device_resnet(world):
    """The port's one-device step on the whole batch, 3 steps from the same
    variables -> (metrics, variables)."""
    from ray_tpu_torch.train import make_resnet_train_step
    model = tres.ResNet(SMALL, RESNET["num_classes"], torch.float64)
    init_fn, step_fn, place = make_resnet_train_step(
        dtype=torch.float64, stage_sizes=SMALL, device="cpu", **RESNET)
    state = init_fn(convert.resnet_variables_from_jax(
        world["inputs"]["resnet"], model, device="cpu"))
    state, metrics = _steps(step_fn, state,
                            place(_images(RESNET["image_size"], 3)),
                            ("loss", "accuracy"))
    return metrics, {k: v.detach().numpy()
                     for k, v in _flat(state.params).items()}


@pytest.mark.parametrize("name", sorted(RESNET_SPECS))
def test_resnet_on_a_mesh_is_the_one_device_step_on_the_whole_batch(
        world, one_device_resnet, name):
    """Global BatchNorm: each rank's 2 rows normalised with the statistics
    of all 8, so the mesh step is the one-device step. Per-rank statistics
    (a DDP step) would move the first loss by 2.5e-3, far beyond the
    tolerance, which the one-device forward on each rank's rows shows."""
    want_metrics, want = one_device_resnet
    for r in range(WORLD):
        got = world["port"][r][f"resnet/{name}/metrics"]
        _assert_metrics(got, want_metrics, f"rank {r}", F64_LOSS_TOL)
        _assert_params(world["port"][r][f"resnet/{name}/variables"], want,
                       f"rank {r}", F64_TOL)
    model = tres.ResNet(SMALL, RESNET["num_classes"], torch.float64)
    variables = convert.resnet_variables_from_jax(
        world["inputs"]["resnet"], model, device="cpu")
    batch = _images(RESNET["image_size"], 3)
    n = B // WORLD      # the rows of each rank on either mesh
    per_rank = np.mean([tres.resnet_loss(tres.resnet50_apply(
        model, variables, torch.from_numpy(batch["image"][i:i + n]),
        device="cpu")[0], torch.from_numpy(batch["label"][i:i + n])).item()
        for i in range(0, B, n)])
    assert abs(per_rank - want_metrics[0][0]) > 1e3 * F64_TOL


@pytest.mark.parametrize("name", sorted(MOE_SPECS))
def test_moe_layer_on_the_ep_axis_matches_jax(world, name):
    want_y, want_grads = world["jax"]["layer"]
    for r in range(WORLD):
        y, grads, _ = world["port"][r][f"layer/{name}"]
        np.testing.assert_allclose(y, want_y, atol=LOSS_TOL, rtol=LOSS_TOL)
        assert set(grads) == set(want_grads)
        for k, g in grads.items():
            np.testing.assert_allclose(g, want_grads[k], atol=LOSS_TOL,
                                       rtol=LOSS_TOL, err_msg=k)


def test_the_moe_layer_inputs_drop_tokens():
    """At capacity factor 1.25 expert 0 overflows: fewer slots are taken
    than tokens times k."""
    from ray_tpu_torch.models.moe import route
    params, h, _ = _layer_inputs()
    cfg = _layer_cfg()
    _, dispatch, _ = route(cfg, torch.from_numpy(params["router"]),
                           torch.from_numpy(h))
    kept = dispatch.sum().item()
    assert kept < LAYER["b"] * LAYER["s"] * cfg.expert_top_k


@pytest.mark.parametrize("name", sorted(MOE_SPECS))
def test_moe_layer_gathers_no_expert_weight(world, name):
    """Expert parallelism, not a gather: the forward and the backward on
    the mesh run one all-reduce (the sum of the ranks' partial outputs over
    ep and tp) and no other collective."""
    for r in range(WORLD):
        _, _, counts = world["port"][r][f"layer/{name}"]
        assert not [op for op in counts if "gather" in op], counts
        assert sum(counts.values()) == 1, counts
        assert [n for op, n in counts.items() if "allreduce" in op] == [1]


@pytest.mark.parametrize("name", sorted(MOE_SPECS))
def test_moe_lm_steps_match_jax_on_the_same_mesh(world, name):
    want, _ = world["jax"][f"moe/{name}"]
    one_device = world["jax"]["moe/one_device_loss"]
    for r in range(WORLD):
        got = world["port"][r][f"moe/{name}/metrics"]
        _assert_metrics(got, want, f"rank {r}")
        np.testing.assert_allclose([m[1] for m in got],
                                   [m[1] for m in want], rtol=STEP_TOL)
        assert abs(got[0][0] - want[0][0]) <= LOSS_TOL
        assert abs(got[0][0] - one_device) <= LOSS_TOL
    assert want[-1][0] < want[0][0]


@pytest.mark.parametrize("name", sorted(MOE_SPECS))
def test_moe_lm_step_params_match_jax_on_the_same_mesh(world, name):
    _, want = world["jax"][f"moe/{name}"]
    for r in range(WORLD):
        _assert_params(world["port"][r][f"moe/{name}/params"], _flat(want),
                       f"rank {r}")
