"""Port parity: ray_tpu_torch.models.transformer against the JAX model.

JAX params from ``transformer_init`` go through ``params_from_jax``; the same
tokens, made with numpy from a seed, go through both stacks on the CPU.
Tolerances: logits 2e-4 at float32 (a few layers of float32 sums taken in
another order); at bfloat16 the norm and RoPE agree bit for bit, since both
stacks round at the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttf

LOGIT_TOL = 2e-4


def _cfgs(**kw):
    base = dict(vocab_size=97, d_model=64, n_layers=3, n_heads=4,
                n_kv_heads=2, max_seq=64, attn_impl="reference")
    base.update(kw)
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **base)
    tcfg = ttf.TransformerConfig(dtype=torch.float32, **base)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp = jtf.transformer_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jp, tp


@pytest.mark.parametrize("kw", [
    {},
    {"tied_embeddings": True},
    {"n_kv_heads": None, "attn_impl": "blockwise"},
    {"attn_impl": "flash", "d_model": 256, "n_heads": 4, "n_layers": 2},
    {"causal": False},
])
def test_logits_match_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(1).integers(0, 97, (2, 32)).astype(
        np.int32)
    # the JAX flash entry runs its blockwise form off the TPU
    want = np.asarray(jtf.transformer_apply(jp, jnp.asarray(tokens), jcfg))
    got = ttf.transformer_apply(tp, torch.from_numpy(tokens), tcfg,
                                device="cpu")
    assert got.dtype == torch.float32 and got.shape == (2, 32, 97)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_explicit_positions_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(2).integers(0, 97, (2, 8)).astype(np.int32)
    pos = np.tile(np.arange(5, 13), (2, 1)).astype(np.int32)
    want = np.asarray(jtf.transformer_apply(jp, jnp.asarray(tokens), jcfg,
                                            positions=jnp.asarray(pos)))
    got = ttf.transformer_apply(tp, torch.from_numpy(tokens), tcfg,
                                positions=torch.from_numpy(pos), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_rmsnorm_and_rope_match_jax_bitwise_at_bf16():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    pos = np.tile(np.arange(8), (2, 1)).astype(np.int32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    for want, got in [
        (jtf._rmsnorm(xj, jnp.asarray(scale)),
         ttf._rmsnorm(xt, torch.from_numpy(scale))),
        (jtf._rope(xj, jnp.asarray(pos), 10000.0),
         ttf._rope(xt, torch.from_numpy(pos), 10000.0)),
    ]:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_init_tree_matches_jax_layout():
    for kw in ({}, {"tied_embeddings": True}):
        jcfg, tcfg = _cfgs(**kw)
        jp = jtf.transformer_init(jax.random.PRNGKey(0), jcfg)
        tp = ttf.transformer_init(torch.Generator().manual_seed(0), tcfg,
                                  device="cpu")
        want = jax.tree_util.tree_flatten_with_path(jp)[0]
        want = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in want}
        got = {}

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}['{k}']")
                else:
                    got[f"{prefix}['{k}']"] = tuple(v.shape)
                    assert v.dtype == torch.float32
        walk(tp, "")
        assert got == want
        std = tp["layers"]["attn"]["wq"].std().item()
        assert 0.018 < std < 0.022


def test_num_params_matches_jax():
    for kw in ({}, {"tied_embeddings": True}):
        jcfg, tcfg = _cfgs(**kw)
        assert ttf.transformer_num_params(tcfg) == \
            jtf.transformer_num_params(jcfg)
        tp = ttf.transformer_init(torch.Generator().manual_seed(0), tcfg,
                                  device="cpu")
        total = 0
        stack = [tp]
        while stack:
            node = stack.pop()
            for v in node.values():
                if isinstance(v, dict):
                    stack.append(v)
                else:
                    total += v.numel()
        assert total == ttf.transformer_num_params(tcfg)


@pytest.mark.parametrize("kw", [{"attn_impl": "ring"},
                                {"attn_impl": "ulysses"}])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttf.TransformerConfig(**kw)


def test_params_from_jax_rejects_mismatched_head():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray,
                      jtf.transformer_init(jax.random.PRNGKey(0), jcfg))
    _, tied = _cfgs(tied_embeddings=True)
    with pytest.raises(ValueError, match="tied_embeddings"):
        convert.params_from_jax(jp, tied, device="cpu")
