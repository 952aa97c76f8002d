"""Port parity: the MoE layer and the flagship LM with experts, ray_tpu_torch
against the JAX package on the CPU.

Inputs are made with numpy from a seed; model weights come from the JAX
``transformer_init`` through ``params_from_jax``. Tolerances:

- ``moe_apply`` at float32 within 1e-5: the routing is the same exact
  arithmetic (softmax, argmax, a cumsum of ones), so only the order of the
  float32 sums in the products differs.
- ``moe_apply`` at bfloat16 within 2e-2 of the output's largest magnitude:
  both stacks round the router logits, the expert inputs and products to
  bfloat16 at the same places, so the routing agrees and the outputs differ
  by a few bf16 ulps (2^-8 relative) summed in another order.
- ``load_balance_loss`` within 1e-6 (a mean of float32 products).
- The model's logits, prefill and decode within 2e-4, the 5-step training
  trajectory as ``tests/test_torch_train.py`` (loss and grad_norm 1e-4
  relative, parameters 5e-5), as for the dense model.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import make_lm_train_step as jax_make_lm_train_step
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.train import make_lm_train_step

jgen = importlib.import_module("ray_tpu.models.generate")
tgen = importlib.import_module("ray_tpu_torch.models.generate")

MOE_TOL = 1e-5
MOE_BF16_REL = 2e-2
LOGIT_TOL = 2e-4
TRAJ_TOL = 1e-4
PARAM_TOL = 5e-5


def _cfgs(**kw):
    base = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=64, attn_impl="reference",
                num_experts=4, expert_top_k=2)
    base.update(kw)
    return (jtf.TransformerConfig(dtype=jnp.float32, **base),
            ttf.TransformerConfig(dtype=torch.float32, **base))


def _params(jcfg, tcfg, seed=0):
    jp = jtf.transformer_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.array, jp), tcfg,
                                 device="cpu")
    return jp, tp


def _moe_inputs(b=2, s=32, d=32, e=4, f=48, seed=0):
    rng = np.random.default_rng(seed)
    params = {"router": rng.standard_normal((d, e)).astype(np.float32) * 0.5,
              "w1": rng.standard_normal((e, d, f)).astype(np.float32) * 0.2,
              "w3": rng.standard_normal((e, d, f)).astype(np.float32) * 0.2,
              "w2": rng.standard_normal((e, f, d)).astype(np.float32) * 0.2}
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    # lean every token toward expert 0, so that at capacity factor 1.25 it
    # overflows and drops tokens at k 1 and 2
    lean = params["router"][:, 0] / np.linalg.norm(params["router"][:, 0])
    return params, h + 2.0 * lean


def _torch_moe(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 97, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("factor", [1.25, 1e9])
def test_moe_apply_matches_jax(k, factor):
    params, h = _moe_inputs()
    jcfg, tcfg = _cfgs(expert_top_k=k)
    want = np.asarray(jmoe.moe_apply(
        jcfg, jax.tree.map(jnp.asarray, params), jnp.asarray(h),
        capacity_factor=factor))
    th = torch.from_numpy(h)
    got = tmoe.moe_apply(tcfg, _torch_moe(params), th,
                         capacity_factor=factor, device="cpu")
    assert got.shape == h.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=MOE_TOL, rtol=MOE_TOL)
    _, dispatch, _ = tmoe.route(tcfg, _torch_moe(params)["router"], th,
                                capacity_factor=factor)
    kept = dispatch.sum().item()
    if factor == 1.25:
        # cap = int(1.25 * 32 * k / 4): some expert overflows and drops
        assert kept < h.shape[0] * h.shape[1] * k
    else:
        assert kept == h.shape[0] * h.shape[1] * k


def test_moe_capacity_resolution():
    _, tcfg = _cfgs()
    assert tmoe._capacity(tcfg, 32, None) == int(1.25 * 32 * 2 / 4)
    cfg = dataclasses.replace(tcfg, moe_capacity_factor=2.0)
    assert tmoe._capacity(cfg, 32, None) == 32
    assert tmoe._capacity(cfg, 32, 0.5) == 8
    assert tmoe._capacity(cfg, 32, 1e9) == 64        # min(s * k, ...)
    assert tmoe._capacity(cfg, 1, 0.01) == 1         # max(1, ...)


@pytest.mark.parametrize("factor", [1.25, 1e9])
def test_moe_apply_bf16_matches_jax(factor):
    params, h = _moe_inputs(seed=1)
    jcfg, tcfg = _cfgs()
    jh = jnp.asarray(h, jnp.bfloat16)
    want = np.asarray(jmoe.moe_apply(
        jcfg, jax.tree.map(jnp.asarray, params), jh,
        capacity_factor=factor), np.float32)
    th = torch.from_numpy(h).bfloat16()
    got = tmoe.moe_apply(tcfg, _torch_moe(params), th,
                         capacity_factor=factor, device="cpu")
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= MOE_BF16_REL, err


def test_route_dispatch_and_combine_are_consistent():
    params, h = _moe_inputs(seed=2)
    _, tcfg = _cfgs()
    gates, dispatch, combine = tmoe.route(
        tcfg, _torch_moe(params)["router"], torch.from_numpy(h))
    # a slot holds at most one token, a token at most k slots, one a expert
    assert dispatch.sum(1).max() <= 1
    assert dispatch.sum((2, 3)).max() <= tcfg.expert_top_k
    assert dispatch.sum(3).max() <= 1
    # combine is the dispatch weighted by the chosen experts' gates
    weights = (combine.sum(3) / dispatch.sum(3).clamp(min=1))
    mask = dispatch.sum(3) > 0
    torch.testing.assert_close(weights[mask], gates[mask])
    torch.testing.assert_close(gates.sum(-1), torch.ones(gates.shape[:2]))


def test_load_balance_loss_matches_jax():
    params, h = _moe_inputs(seed=3)
    _, tcfg = _cfgs()
    gates, dispatch, _ = tmoe.route(tcfg, _torch_moe(params)["router"],
                                    torch.from_numpy(h))
    want = float(jmoe.load_balance_loss(jnp.asarray(gates.numpy()),
                                        jnp.asarray(dispatch.numpy())))
    got = tmoe.load_balance_loss(gates, dispatch)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"expert_top_k": 1},
                                {"moe_capacity_factor": 1e9},
                                {"tied_embeddings": True,
                                 "attn_impl": "flash"}])
def test_moe_logits_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, tcfg)
    tokens = _tokens(2, 32, seed=1)
    want = np.asarray(jtf.transformer_apply(jp, jnp.asarray(tokens), jcfg))
    got = ttf.transformer_apply(tp, torch.from_numpy(tokens), tcfg,
                                device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_moe_prefill_and_decode_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=2)
    prompt = _tokens(2, 9, seed=3)
    want, jcache = jgen.prefill(jp, jnp.asarray(prompt), jcfg, max_len=12)
    got, tcache = tgen.prefill(tp, torch.from_numpy(prompt), tcfg,
                               max_len=12, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    token = np.asarray(want).argmax(-1).astype(np.int32)
    for pos in (9, 10):
        want, jcache = jgen.decode_step(jp, jnp.asarray(token), pos, jcache,
                                        jcfg)
        got, tcache = tgen.decode_step(tp, torch.from_numpy(token), pos,
                                       tcache, tcfg, device="cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        token = np.asarray(want).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("kw,b,s,n", [
    ({}, 2, 7, 8),
    ({"expert_top_k": 1, "n_kv_heads": 1}, 3, 5, 6),
    ({"tied_embeddings": True}, 2, 16, 6),
])
def test_moe_greedy_tokens_equal_jax(kw, b, s, n):
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, tcfg, seed=1)
    prompt = _tokens(b, s, seed=5)
    want = jgen.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=n,
                         temperature=0.0)
    got = tgen.generate(tp, torch.from_numpy(prompt), tcfg,
                        max_new_tokens=n, temperature=0.0, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_inference_cfg_is_dropless_for_moe_only():
    _, tcfg = _cfgs()
    assert tgen._inference_cfg(tcfg).moe_capacity_factor == 1e9
    fixed = dataclasses.replace(tcfg, moe_capacity_factor=2.0)
    assert tgen._inference_cfg(fixed) is fixed
    dense = dataclasses.replace(tcfg, num_experts=0)
    assert tgen._inference_cfg(dense) is dense


def test_moe_cached_decode_equals_uncached_forward():
    # generate routes dropless; the uncached reference must route the same
    # way (at the training default of 1.25 the full forward drops tokens)
    _, tcfg = _cfgs()
    tp = ttf.transformer_init(torch.Generator().manual_seed(4), tcfg,
                              device="cpu")
    prompt = torch.from_numpy(_tokens(2, 12, seed=6))
    got = tgen.generate(tp, prompt, tcfg, max_new_tokens=6, device="cpu")
    infer = tgen._inference_cfg(tcfg)
    toks = prompt.long()
    for _ in range(6):
        logits = ttf.transformer_apply(tp, toks, infer, device="cpu")
        toks = torch.cat([toks, logits[:, -1].argmax(-1)[:, None]], dim=1)
    np.testing.assert_array_equal(got.numpy(), toks[:, 12:].numpy())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}['{k}']"))
        else:
            out[f"{prefix}['{k}']"] = v
    return out


def test_moe_loss_and_grads_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=5)
    tokens = _tokens(2, 32, seed=7)
    want_loss, want_grads = jax.value_and_grad(jtf.transformer_loss)(
        jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    leaves = _flat(tp)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss = ttf.transformer_loss(tp, {"tokens": torch.from_numpy(tokens)},
                                tcfg, device="cpu")
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-5)
    want = {jax.tree_util.keystr(p): g for p, g in
            jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    assert set(grads) == set(want)
    assert "['layers']['moe']['router']" in grads
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_five_step_trajectory_matches_jax(k):
    jcfg, tcfg = _cfgs(expert_top_k=k, attn_impl="flash")
    mesh = build_mesh(MeshSpec(dp=1))
    j_init, j_step, j_place = jax_make_lm_train_step(jcfg, mesh)
    jstate = j_init(jax.random.PRNGKey(3))
    tp = convert.params_from_jax(jax.tree.map(np.array, jstate.params), tcfg,
                                 device="cpu")
    t_init, t_step, t_place = make_lm_train_step(tcfg, device="cpu")
    tstate = t_init(tp)
    batch = {"tokens": _tokens(4, 32, seed=2)}
    jbatch = j_place({k_: jnp.asarray(v) for k_, v in batch.items()})
    tbatch = t_place(batch)
    losses = []
    for step in range(1, 6):
        jstate, jm = j_step(jstate, jbatch)
        tstate, tm = t_step(tstate, tbatch)
        assert tm["step"] == step == int(jm["step"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=TRAJ_TOL, err_msg=f"{key} {step}")
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


def test_moe_remat_gives_identical_gradients():
    jcfg, tcfg = _cfgs()
    tokens = {"tokens": torch.from_numpy(_tokens(2, 32, seed=8))}
    results = []
    for remat in (True, False):
        _, tp = _params(jcfg, tcfg)
        cfg = dataclasses.replace(tcfg, remat=remat)
        leaves = list(_flat(tp).values())
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = ttf.transformer_loss(tp, tokens, cfg, device="cpu")
        results.append((loss, torch.autograd.grad(loss, leaves)))
    (loss_r, grads_r), (loss_n, grads_n) = results
    assert loss_r.item() == loss_n.item()
    for a, b in zip(grads_r, grads_n):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"tied_embeddings": True},
                                {"expert_top_k": 1, "d_ff": 40}])
def test_moe_init_and_num_params_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    assert ttf.transformer_num_params(tcfg) == \
        jtf.transformer_num_params(jcfg)
    jp = jtf.transformer_init(jax.random.PRNGKey(0), jcfg)
    tp = ttf.transformer_init(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    want = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {k: tuple(v.shape) for k, v in _flat(tp).items()}
    assert got == want and "['layers']['mlp']['w1']" not in got
    assert sum(v.numel() for v in _flat(tp).values()) == \
        ttf.transformer_num_params(tcfg)
    assert 0.018 < tp["layers"]["moe"]["w1"].std().item() < 0.022


def test_flagship_moe_num_params():
    # the card configuration: the flagship's widths and depth, 4 experts
    cfg = ttf.TransformerConfig(vocab_size=32768, d_model=2048, n_layers=10,
                                n_heads=16, n_kv_heads=16, d_ff=8192,
                                tied_embeddings=True, num_experts=4,
                                expert_top_k=2)
    assert ttf.transformer_num_params(cfg) == 2_248_271_872


def test_params_from_jax_checks_experts():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray,
                      jtf.transformer_init(jax.random.PRNGKey(0), jcfg))
    dense = dataclasses.replace(tcfg, num_experts=0)
    with pytest.raises(ValueError, match="num_experts"):
        convert.params_from_jax(jp, dense, device="cpu")
    tp = convert.params_from_jax(jp, tcfg, device="cpu")
    assert set(tp["layers"]["moe"]) == {"router", "w1", "w3", "w2"}
    assert tp["layers"]["moe"]["w2"].shape == (2, 4, 256, 64)


def test_moe_apply_checks_the_device():
    params, h = _moe_inputs()
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="lies on"):
        tmoe.moe_apply(tcfg, _torch_moe(params),
                       torch.from_numpy(h).to("meta"), device="cpu")
