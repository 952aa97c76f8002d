"""Port parity: the ViT classifier and its train step, ray_tpu_torch against
``ray_tpu.models.vit`` and ``ray_tpu.train.make_vit_train_step`` on the CPU.

Weights come from the JAX ``vit_init`` through ``vit_params_from_jax``;
images and labels are made with numpy from a seed. Small configurations
(32² or 48² images, patch 8 or 16, d_model 64, 2 layers, 4 heads) at
float32. Tolerances: patchify exactly equal (a reshape and transpose);
logits 2e-4 (a few layers of float32 sums in another order, as the LM);
loss and gradients 2e-5; along the 5-step AdamW trajectory loss 1e-4
relative, accuracy exactly equal (the argmax of logits that agree to 2e-4
on these inputs) and parameters 5e-5 absolute, as for the LM.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import make_vit_train_step as jax_make_vit_train_step
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.train import TrainState, make_vit_train_step

LOGIT_TOL = 2e-4
GRAD_TOL = 2e-5
TRAJ_TOL = 1e-4
PARAM_TOL = 5e-5

SMALL = dict(image_size=32, patch_size=8, num_classes=10, d_model=64,
             n_layers=2, n_heads=4)


def _cfgs(**kw):
    base = {**SMALL, **kw}
    return (jvit.ViTConfig(dtype=jnp.float32, **base),
            tvit.ViTConfig(dtype=torch.float32, **base))


def _params(jcfg, tcfg, seed=0):
    jp = jvit.vit_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.vit_params_from_jax(jax.tree.map(np.array, jp), tcfg,
                                     device="cpu")
    return jp, tp


def _batch(cfg, b=4, seed=1):
    rng = np.random.default_rng(seed)
    s = cfg.image_size
    return {"image": rng.standard_normal((b, s, s, 3)).astype(np.float32),
            "label": rng.integers(0, cfg.num_classes, (b,)).astype(np.int32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


def test_patchify_matches_jax():
    images = np.random.default_rng(0).standard_normal(
        (2, 32, 48, 3)).astype(np.float32)
    want = np.asarray(jvit._patchify(jnp.asarray(images), 8))
    got = tvit._patchify(torch.from_numpy(images), 8)
    assert got.shape == (2, 24, 192)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [{}, {"remat": False},
                                {"image_size": 48, "patch_size": 16,
                                 "n_heads": 2}])
def test_vit_logits_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(jcfg)
    want = np.asarray(jvit.vit_apply(jp, jnp.asarray(batch["image"]), jcfg))
    got = tvit.vit_apply(tp, torch.from_numpy(batch["image"]), tcfg,
                         device="cpu")
    assert got.dtype == torch.float32 and got.shape == (4, jcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_vit_encoder_is_bidirectional():
    jcfg, tcfg = _cfgs()
    enc = tcfg.encoder_config()
    assert not enc.causal and enc.attn_impl == "auto"
    assert enc.max_seq == tcfg.seq_len == 17 and enc.head_dim == 16
    # the [CLS] logits see every patch: changing the last patch moves them
    _, tp = _params(jcfg, tcfg)
    images = torch.from_numpy(_batch(jcfg, b=1)["image"])
    moved = images.clone()
    moved[:, -8:, -8:] += 1.0
    a = tvit.vit_apply(tp, images, tcfg, device="cpu")
    b = tvit.vit_apply(tp, moved, tcfg, device="cpu")
    assert not torch.allclose(a, b)


def test_vit_loss_and_grads_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=2)
    batch = _batch(jcfg, b=6, seed=3)
    (want_loss, want_acc), want_grads = jax.value_and_grad(
        jvit.vit_loss, has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    leaves = _flat(tp)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss, acc = tvit.vit_loss(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                              tcfg, device="cpu")
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=GRAD_TOL)
    assert acc.item() == float(want_acc)
    want = {jax.tree_util.keystr(p): g for p, g in
            jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_vit_five_step_trajectory_matches_jax():
    jcfg, tcfg = _cfgs()
    mesh = build_mesh(MeshSpec(dp=1))
    j_init, j_step, j_place = jax_make_vit_train_step(jcfg, mesh)
    jstate = j_init(jax.random.PRNGKey(4))
    tp = convert.vit_params_from_jax(jax.tree.map(np.array, jstate.params),
                                     tcfg, device="cpu")
    t_init, t_step, t_place = make_vit_train_step(tcfg, device="cpu")
    tstate = t_init(tp)
    batch = _batch(jcfg, b=8, seed=5)
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
    want = {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    got = _flat(tstate.params)
    assert set(got) == set(want)
    for name, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(),
                                   np.asarray(want[name]), atol=PARAM_TOL,
                                   rtol=0, err_msg=name)


def test_vit_step_updates_in_place():
    _, tcfg = _cfgs()
    init_fn, step_fn, place = make_vit_train_step(tcfg, learning_rate=1e-3,
                                                  device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    assert isinstance(state, TrainState) and state.step == 0
    proj = state.params["patch_proj"]
    before = proj.detach().clone()
    batch = place(_batch(tcfg, b=8))
    assert batch["image"].device.type == "cpu"
    losses = []
    for _ in range(4):
        state, metrics = step_fn(state, batch)
        assert set(metrics) == {"loss", "accuracy", "step"}
        losses.append(metrics["loss"].item())
    assert state.step == 4 and state.params["patch_proj"] is proj
    assert not torch.equal(proj.detach(), before)
    assert losses[-1] < losses[0]
    # AdamW's weight decay is the JAX step's 0.05
    assert state.opt_state.param_groups[0]["weight_decay"] == 0.05


@pytest.mark.parametrize("cfg", [{}, {"image_size": 48, "patch_size": 16}])
def test_vit_init_matches_jax_layout(cfg):
    jcfg, tcfg = _cfgs(**cfg)
    jp = jvit.vit_init(jax.random.PRNGKey(0), jcfg)
    tp = tvit.vit_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    want = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {k: tuple(v.shape) for k, v in _flat(tp).items()}
    assert got == want
    patch_dim = tcfg.patch_size ** 2 * 3
    std = tp["patch_proj"].std().item() * patch_dim ** 0.5
    assert 0.9 < std < 1.1
    assert torch.equal(tp["ln_f"], torch.ones(tcfg.d_model))


def test_vit_params_from_jax_checks_the_config():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jvit.vit_init(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="patch_proj"):
        convert.vit_params_from_jax(
            jp, dataclasses.replace(tcfg, patch_size=16), device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        convert.vit_params_from_jax(
            jp, dataclasses.replace(tcfg, n_layers=3), device="cpu")


def test_vit_apply_checks_the_device():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, tcfg)
    meta = {**tp, "patch_proj": tp["patch_proj"].to("meta")}
    with pytest.raises(ValueError, match="lie on"):
        tvit.vit_apply(meta, torch.zeros(1, 32, 32, 3), tcfg, device="cpu")
