"""Port parity: training. ``transformer_loss`` and its gradients, remat, and
``make_lm_train_step`` of ray_tpu_torch against the JAX package's.

JAX params go through ``params_from_jax``; tokens and masks are made with
numpy from a seed and go through both stacks on the CPU at float32, on a
tiny model (vocab 128, d_model 64, 2 layers, 4 heads, 2 KV heads, S 32).

Tolerances: loss 2e-5 and gradients 2e-5 (float32 sums taken in another
order over a few layers); along the 5-step AdamW trajectory loss and
grad_norm 1e-4 relative and parameters 5e-5 absolute (each step's update is
lr * m / (sqrt(v) + eps), so a relative gradient difference of 1e-5 moves a
parameter by well under 3e-4 * 1e-5 per step, and parameters are ~0.02).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import make_lm_train_step as jax_make_lm_train_step
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.train import TrainState, make_lm_train_step

LOSS_TOL = 2e-5
GRAD_TOL = 2e-5
TRAJ_TOL = 1e-4
PARAM_TOL = 5e-5


def _cfgs(**kw):
    base = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=64, attn_impl="reference")
    base.update(kw)
    return (jtf.TransformerConfig(dtype=jnp.float32, **base),
            ttf.TransformerConfig(dtype=torch.float32, **base))


def _params(jcfg, tcfg, seed=0):
    jp = jtf.transformer_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.array, jp), tcfg,
                                 device="cpu")
    return jp, tp


def _batch(b=2, s=32, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 128, (b, s)).astype(np.int32)}
    if mask:
        batch["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


def _flat(tree, prefix=""):
    """{"['layers']['attn']['wq']": leaf, ...} for a dict tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


def _torch_value_and_grad(tp, batch, tcfg):
    leaves = _flat(tp)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = ttf.transformer_loss(tp, tbatch, tcfg, device="cpu")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, grads))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("mask", [False, True])
def test_loss_and_grads_match_jax(tied, impl, mask):
    jcfg, tcfg = _cfgs(tied_embeddings=tied, attn_impl=impl)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(mask=mask)
    # the JAX flash entry runs its blockwise form off the TPU
    want_loss, want_grads = jax.value_and_grad(jtf.transformer_loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, grads = _torch_value_and_grad(tp, batch, tcfg)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_TOL)
    want = {jax.tree_util.keystr(p): g for p, g in
            jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_masked_loss_is_mean_over_masked_in_targets():
    _, tcfg = _cfgs()
    tp = ttf.transformer_init(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    tokens = torch.from_numpy(_batch()["tokens"])
    full = ttf.transformer_loss(tp, {"tokens": tokens}, tcfg, device="cpu")
    ones = ttf.transformer_loss(tp, {"tokens": tokens,
                                     "mask": torch.ones(2, 32)},
                                tcfg, device="cpu")
    torch.testing.assert_close(ones, full)
    # an all-zero mask divides by max(0, 1), not by 0
    zero = ttf.transformer_loss(tp, {"tokens": tokens,
                                     "mask": torch.zeros(2, 32)},
                                tcfg, device="cpu")
    assert zero.item() == 0.0


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_remat_gives_identical_gradients(impl):
    jcfg, tcfg = _cfgs(attn_impl=impl)
    batch = _batch()
    results = []
    for remat in (True, False):
        _, tp = _params(jcfg, tcfg)
        cfg = ttf.TransformerConfig(**{**tcfg.__dict__, "remat": remat})
        results.append(_torch_value_and_grad(tp, batch, cfg))
    (loss_r, grads_r), (loss_n, grads_n) = results
    assert loss_r == loss_n
    for name in grads_r:
        assert torch.equal(grads_r[name], grads_n[name]), name


@pytest.mark.parametrize("tied", [False, True])
def test_five_step_trajectory_matches_jax(tied):
    jcfg, tcfg = _cfgs(tied_embeddings=tied, attn_impl="flash")
    mesh = build_mesh(MeshSpec(dp=1))
    j_init, j_step, j_place = jax_make_lm_train_step(jcfg, mesh)
    jstate = j_init(jax.random.PRNGKey(3))
    tp = convert.params_from_jax(jax.tree.map(np.array, jstate.params), tcfg,
                                 device="cpu")
    t_init, t_step, t_place = make_lm_train_step(tcfg, device="cpu")
    tstate = t_init(tp)
    batch = _batch(b=4, seed=2)
    jbatch = j_place({k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = t_place(batch)
    for step in range(1, 6):
        jstate, jm = j_step(jstate, jbatch)
        tstate, tm = t_step(tstate, tbatch)
        assert tm["step"] == step == int(jm["step"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=TRAJ_TOL, err_msg=f"{key} {step}")
    assert tm["loss"].item() < float(np.asarray(jm["loss"])) + 1.0
    want = {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    got = _flat(tstate.params)
    assert set(got) == set(want)
    for name, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(),
                                   np.asarray(want[name]), atol=PARAM_TOL,
                                   rtol=0, err_msg=name)


def test_step_updates_in_place_and_lowers_the_loss():
    _, tcfg = _cfgs(attn_impl="flash")
    init_fn, step_fn, place = make_lm_train_step(tcfg, learning_rate=1e-3,
                                                 device="cpu")
    state = init_fn(torch.Generator().manual_seed(0))
    assert isinstance(state, TrainState) and state.step == 0
    embed = state.params["embed"]
    before = embed.detach().clone()
    batch = place(_batch(b=4))
    assert batch["tokens"].device.type == "cpu"
    losses = []
    for _ in range(4):
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())
        assert set(metrics) == {"loss", "grad_norm", "step"}
        assert torch.isfinite(metrics["grad_norm"])
    assert state.step == 4 and state.params["embed"] is embed
    assert not torch.equal(embed.detach(), before)
    assert losses[-1] < losses[0]
    assert all(p.grad is None for p in _flat(state.params).values())
