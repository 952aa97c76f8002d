"""Port parity: ResNet and its train step, and the MLP, ray_tpu_torch against
``ray_tpu.models.resnet``, ``ray_tpu.train.make_resnet_train_step`` and
``ray_tpu.models.mlp`` on the CPU.

Variables are flax's tree filled with seeded numpy values (every BatchNorm
scale, bias and running statistic away from flax's init, which zeroes each
block's last scale and so hides its branch), or the JAX step's own init for
the trajectory; images and labels are seeded numpy. Small sizes: ``ResNet([1,
1, 1, 1], 10)`` at 32² and batch 4, whose last stage runs on 1x1 maps (4
values a channel: the unbiased variance would be 4/3 of flax's), and one
ResNet-50 forward at 64² and batch 2.

In train mode BatchNorm over a few values a channel is ill-conditioned:
rounding grows with depth. Both stacks then run in float64 (flax's ``dtype``
and the port's, parameters f32, the Dense head f32 as in both models) where
f32 or bf16 rounding would hide the comparison. Measured against float64,
flax's own f32 gradients of the small model are up to 1e-1 off (its E[x²] −
E[x]² variance cancels at the 1x1 stage), the port's 5e-5; flax's bf16
train-mode logits 8% off, the port's 11%.

Tolerances: SAME padding exact (integer-valued f32 inputs, so every sum is
exact); f32 logits 1e-4 (convolutions summed in another order over a few
layers); the small model's batch statistics 1e-5; float64 statistics 1e-6 and
logits 1e-5 (the f32 head sums 2048 products); bf16 eval-mode logits 2e-2 of their largest
magnitude (both stacks round every layer's output to bf16), and in train
mode the port's distance to the float64 logits at most twice flax's own;
float64 gradients 1e-6 and the port's f32 gradients 1e-4 of each leaf's
largest magnitude; along the 5-step SGD trajectory (lr 0.01, as the JAX
package's own ResNet step test) loss 1e-4 relative, accuracy exactly equal,
parameters and batch statistics 5e-5; the MLP 1e-6 (two f32 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from jax import lax

from ray_tpu.models import mlp as jmlp
from ray_tpu.models import resnet as jres
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import jax_step
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.models import resnet as tres
from ray_tpu_torch.train import TrainState, make_resnet_train_step

LOGIT_TOL = 1e-4
STATS_TOL = 1e-5
F64_TOL = 1e-6
F64_LOGIT_TOL = 1e-5
BF16_TOL = 2e-2
BF16_TRAIN_RATIO = 2.0
GRAD_TOL = 1e-4
TRAJ_TOL = 1e-4
PARAM_TOL = 5e-5

SMALL = (1, 1, 1, 1)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f64": (jnp.float64, torch.float64)}


def _models(stages=SMALL, num_classes=10, dtype="f32"):
    jd, td = DTYPES[dtype]
    return (jres.ResNet(list(stages), num_classes, jd),
            tres.ResNet(stages, num_classes, td))


def _jax_shapes(model, size=32):
    model = model.clone(dtype=jnp.float32)     # the same shapes in any dtype
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=True))


def _random_variables(model, seed=0):
    """flax's variable tree of ``model`` with seeded values: kernels normal
    over sqrt(fan-in), scales and running variances in [0.5, 1.5], biases and
    running means normal(0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = 0.1 * rng.standard_normal(shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, _jax_shapes(model))


def _images(b=4, size=32, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def _jax_apply(model, train):
    return jax.jit(lambda v, x: jres.resnet50_apply(model, v, x, train=train))


def _jax_apply64(model, train, variables, images):
    """``model`` applied in float64 (x64 on for the call), as numpy."""
    with jax.enable_x64(True):
        out = _jax_apply(model, train)(variables, images.astype(np.float64))
        return jax.tree.map(np.asarray, out)


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_tree_close(got, want, tol, what):
    """The port's tree against a JAX tree in the port's layout."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for name, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().float().numpy(),
                                   want[name].numpy(), atol=tol, rtol=tol,
                                   err_msg=f"{what} {name}")


def _to_port(tree, model):
    """A JAX variables tree in the port's layout, on the CPU."""
    return convert.resnet_variables_from_jax(
        jax.tree.map(np.array, tree), model, device="cpu")


@pytest.mark.parametrize("op", ["conv", "max_pool"])
@pytest.mark.parametrize("size", [112, 56, 15, 7])
def test_same_padding_matches_lax(op, size):
    pads = lax.padtype_to_pads((size,), (3,), (2,), "SAME")[0]
    assert tres.same_pads(size, 3, 2) == tuple(pads)
    rng = np.random.default_rng(size)
    x = rng.integers(-3, 4, (2, size, size, 4)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if op == "conv":
        k = rng.integers(-2, 3, (3, 3, 4, 5)).astype(np.float32)
        want = lax.conv_general_dilated(
            x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        kt = torch.from_numpy(k).permute(3, 2, 0, 1)
        got = tres.conv(xt, kt, 2)
        naive = F.conv2d(xt, kt, stride=2, padding=1)
    else:
        want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                           padding="SAME")
        got = tres.max_pool_same(xt)
        naive = F.max_pool2d(xt, 3, 2, padding=1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
    # the symmetric padding=1 has the right shape, and on an even map the
    # wrong windows
    assert naive.shape == got.shape
    assert np.array_equal(naive.numpy(), got.numpy()) == (size % 2 == 1)


@pytest.mark.parametrize("train", [True, False])
def test_small_resnet_logits_and_stats_match_jax(train):
    jmodel, tmodel = _models()
    jv = _random_variables(jmodel)
    tv = _to_port(jv, tmodel)
    images = _images()
    want = _jax_apply(jmodel, train)(jv, images)
    got = tres.resnet50_apply(tmodel, tv, torch.from_numpy(images),
                              train=train, device="cpu")
    if train:
        want, want_stats = want
        got, got_stats = got
        # the new statistics in the port's layout (they have no kernels)
        _assert_tree_close(got_stats, _to_port(
            {"params": jv["params"], "batch_stats": want_stats},
            tmodel)["batch_stats"], STATS_TOL, "batch_stats")
        moved = tv["batch_stats"]["BottleneckBlock_3"]["BatchNorm_2"]["var"]
        assert not torch.allclose(moved, got_stats["BottleneckBlock_3"][
            "BatchNorm_2"]["var"])
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("train", [True, False])
def test_small_resnet_bf16_logits_match_jax(train):
    jmodel, tmodel = _models(dtype="bf16")
    jv = _random_variables(jmodel, seed=2)
    tv = _to_port(jv, tmodel)
    images = _images(seed=3)
    want = _jax_apply(jmodel, train)(jv, images)
    got = tres.resnet50_apply(tmodel, tv, torch.from_numpy(images),
                              train=train, device="cpu")
    if not train:
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), np.asarray(want, np.float64)) <= BF16_TOL
        return
    exact = _jax_apply64(_models(dtype="f64")[0], True, jv, images)[0]
    jax_err = _rel(want[0], exact)
    port_err = _rel(got[0].numpy(), exact)
    assert port_err <= BF16_TRAIN_RATIO * jax_err, (port_err, jax_err)


@pytest.mark.parametrize("train,dtype", [(True, "f64"), (False, "f32")])
def test_resnet50_forward_matches_jax(train, dtype):
    jmodel, tmodel = _models((3, 4, 6, 3), 1000, dtype)
    jv = _random_variables(jmodel, seed=4)
    tv = _to_port(jv, tmodel)
    images = _images(b=2, size=64, seed=5)
    if dtype == "f64":
        want = _jax_apply64(jmodel, train, jv, images)
    else:
        want = _jax_apply(jmodel, train)(jv, images)
    got = tres.resnet50_apply(tmodel, tv, torch.from_numpy(images),
                              train=train, device="cpu")
    if train:
        (want, want_stats), (got, got_stats) = want, got
        _assert_tree_close(got_stats, _to_port(
            {"params": jv["params"], "batch_stats": want_stats},
            tmodel)["batch_stats"], F64_TOL, "batch_stats")
    tol = F64_LOGIT_TOL if dtype == "f64" else LOGIT_TOL
    assert got.shape == (2, 1000) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_loss_and_grads_match_jax():
    jmodel, _ = _models(dtype="f64")
    jv = _random_variables(jmodel, seed=6)
    images = _images(seed=7)
    labels = np.random.default_rng(7).integers(0, 10, (4,)).astype(np.int32)

    def jloss(params):
        logits, _ = jres.resnet50_apply(
            jmodel, {"params": params, "batch_stats": jv["batch_stats"]},
            images.astype(np.float64), train=True)
        return jres.resnet_loss(logits, labels)

    with jax.enable_x64(True):
        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
            jv["params"])
        want_grads = jax.tree.map(np.asarray, want_grads)
    for dtype, tol in (("f64", F64_TOL), ("f32", GRAD_TOL)):
        tmodel = _models(dtype=dtype)[1]
        tv = _to_port(jv, tmodel)
        want = _flat(_to_port({"params": want_grads,
                               "batch_stats": jv["batch_stats"]},
                              tmodel)["params"])
        leaves = _flat(tv["params"])
        for leaf in leaves.values():
            leaf.requires_grad_(True)
        logits, _ = tres.resnet50_apply(tmodel, tv, torch.from_numpy(images),
                                        device="cpu")
        loss = tres.resnet_loss(logits, torch.from_numpy(labels))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=tol)
        assert set(leaves) == set(want)
        for name, g in zip(leaves, grads):
            assert _rel(g.numpy(), want[name].numpy()) <= tol, (dtype, name)


def test_five_step_trajectory_matches_jax(monkeypatch):
    # the JAX step builds resnet50() in bf16; the same step code on the
    # small f32 model
    monkeypatch.setattr(jax_step, "resnet50", lambda num_classes: jres.ResNet(
        list(SMALL), num_classes, jnp.float32))
    mesh = build_mesh(MeshSpec(dp=1))
    j_init, j_step, j_place = jax_step.make_resnet_train_step(
        mesh, num_classes=10, image_size=32, learning_rate=0.01)
    jstate = j_init(jax.random.PRNGKey(8))
    _, tmodel = _models()
    t_init, t_step, t_place = make_resnet_train_step(
        num_classes=10, image_size=32, learning_rate=0.01,
        dtype=torch.float32, stage_sizes=SMALL, device="cpu")
    tstate = t_init(_to_port(jstate.params, tmodel))
    rng = np.random.default_rng(9)
    batch = {"image": _images(b=8, seed=9),
             "label": rng.integers(0, 10, (8,)).astype(np.int32)}
    jbatch = j_place({k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = t_place(batch)
    losses = []
    for step in range(1, 6):
        jstate, jm = j_step(jstate, jbatch)
        tstate, tm = t_step(tstate, tbatch)
        assert tm["step"] == step
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=TRAJ_TOL, err_msg=f"loss {step}")
        assert tm["accuracy"].item() == float(jm["accuracy"]), step
        losses.append(tm["loss"].item())
    assert losses[-1] < losses[0]
    _assert_tree_close(tstate.params, _to_port(jstate.params, tmodel),
                       PARAM_TOL, "after 5 steps")


def test_step_updates_in_place():
    init_fn, step_fn, place = make_resnet_train_step(
        num_classes=10, image_size=32, dtype=torch.float32,
        stage_sizes=SMALL, device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    assert isinstance(state, TrainState) and state.step == 0
    kernel = state.params["params"]["conv_init"]["kernel"]
    var = state.params["batch_stats"]["bn_init"]["var"]
    before = kernel.detach().clone()
    batch = place({"image": _images(b=8), "label": np.arange(8) % 10})
    losses = []
    for _ in range(3):
        state, metrics = step_fn(state, batch)
        assert set(metrics) == {"loss", "accuracy", "step"}
        losses.append(metrics["loss"].item())
    assert state.step == 3
    assert state.params["params"]["conv_init"]["kernel"] is kernel
    assert state.params["batch_stats"]["bn_init"]["var"] is var
    assert not torch.equal(kernel.detach(), before)
    assert not torch.equal(var, torch.ones_like(var))
    assert not var.requires_grad
    assert losses[-1] < losses[0]
    # optax.sgd(lr, momentum=0.9, nesterov=True)
    group = state.opt_state.param_groups[0]
    assert isinstance(state.opt_state, torch.optim.SGD)
    assert (group["lr"], group["momentum"], group["nesterov"],
            group["dampening"], group["weight_decay"]) == (0.1, 0.9, True,
                                                           0.0, 0.0)


@pytest.mark.parametrize("stages", [SMALL, (3, 4, 6, 3)])
def test_init_matches_jax_layout(stages):
    jmodel, tmodel = _models(stages, 1000, "bf16")
    want = {k: tuple(v.shape) for k, v in _flat(_to_port(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), _jax_shapes(jmodel)),
        tmodel)).items()}
    tv = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in _flat(tv).items()} == want
    p, s = tv["params"], tv["batch_stats"]
    # lecun_normal: truncated at two standard deviations, variance 1/fan-in
    for kernel, fan_in in ((p["conv_init"]["kernel"], 7 * 7 * 3),
                           (p["Dense_0"]["kernel"], p["Dense_0"]["kernel"]
                            .shape[0])):
        std = kernel.std().item() * fan_in ** 0.5
        assert 0.9 < std < 1.1
        assert kernel.abs().max().item() * fan_in ** 0.5 <= 2 / .8796
    block = p["BottleneckBlock_0"]
    assert torch.equal(block["BatchNorm_2"]["scale"], torch.zeros(256))
    assert torch.equal(block["norm_proj"]["scale"], torch.ones(256))
    assert torch.equal(p["bn_init"]["scale"], torch.ones(64))
    assert not p["Dense_0"]["bias"].any()
    assert not s["bn_init"]["mean"].any()
    assert torch.equal(s["bn_init"]["var"], torch.ones(64))
    assert all(v.dtype == torch.float32 for v in _flat(tv).values())


def test_resnet50_counts():
    model, tv = tres.resnet50_init(torch.Generator().manual_seed(0),
                                   device="cpu")
    assert model == tres.resnet50() and model.num_classes == 1000
    assert [name for name, _, _ in model.blocks()] == [
        f"BottleneckBlock_{i}" for i in range(16)]
    assert sum(v.numel() for v in _flat(tv["params"]).values()) == 25_557_032
    assert sum(v.numel() for v in _flat(tv["batch_stats"]).values()) == 53_120
    proj = [n for n, v in tv["params"].items() if "conv_proj" in v]
    assert proj == ["BottleneckBlock_0", "BottleneckBlock_3",
                    "BottleneckBlock_7", "BottleneckBlock_13"]


def test_converter_checks_the_model():
    jmodel, tmodel = _models()
    jv = jax.tree.map(np.asarray, _random_variables(jmodel))
    with pytest.raises(ValueError, match="stage_sizes=.3, 4, 6, 3."):
        convert.resnet_variables_from_jax(jv, device="cpu")
    with pytest.raises(ValueError, match="Dense_0/kernel: .2048, 10., want "
                                         ".2048, 12."):
        convert.resnet_variables_from_jax(
            jv, tres.ResNet(SMALL, 12), device="cpu")
    with pytest.raises(ValueError, match="BottleneckBlock_3/BatchNorm_0/mean: "
                                         ".512,., want .256,."):
        convert.resnet_variables_from_jax(
            jv, tres.ResNet((1, 1, 2, 1), 10), device="cpu")
    no_stats = {"params": jv["params"]}
    with pytest.raises(ValueError, match="BatchNorm_0/mean: missing"):
        convert.resnet_variables_from_jax(no_stats, tmodel, device="cpu")
    tv = convert.resnet_variables_from_jax(jv, tmodel, device="cpu")
    np.testing.assert_array_equal(
        tv["params"]["conv_init"]["kernel"].numpy(),
        jv["params"]["conv_init"]["kernel"].transpose(3, 2, 0, 1))
    assert tv["params"]["conv_init"]["kernel"].is_contiguous()


def test_resnet_apply_checks_the_device():
    _, tmodel = _models()
    tv = tmodel.init(torch.Generator().manual_seed(0), device="cpu")
    meta = {"params": {**tv["params"], "conv_init": {
        "kernel": tv["params"]["conv_init"]["kernel"].to("meta")}},
        "batch_stats": tv["batch_stats"]}
    with pytest.raises(ValueError, match="lie on"):
        tres.resnet50_apply(tmodel, meta, torch.zeros(1, 32, 32, 3),
                            device="cpu")


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_mlp_matches_jax(act):
    jp = jmlp.mlp_init(jax.random.PRNGKey(0), [4, 32, 32, 2])
    tp = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
          for layer in jp]
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    want = jmlp.mlp_apply(jp, jnp.asarray(x), getattr(jax.nn, act))
    got = tmlp.mlp_apply(tp, torch.from_numpy(x), getattr(torch, act),
                         device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_mlp_init_matches_jax_scales():
    sizes = [64, 256, 2]
    jp = jmlp.mlp_init(jax.random.PRNGKey(0), sizes)
    tp = tmlp.mlp_init(torch.Generator().manual_seed(0), sizes, device="cpu")
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in tp] \
        == [{k: tuple(v.shape) for k, v in layer.items()} for layer in jp]
    for layer, fan_in in zip(tp, sizes):
        std = layer["w"].std().item() / (2.0 / fan_in) ** 0.5
        assert 0.9 < std < 1.1
        assert not layer["b"].any() and layer["w"].dtype == torch.float32
