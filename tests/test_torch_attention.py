"""Port parity: ray_tpu_torch.ops.attention against ray_tpu.ops.attention.

The same numpy inputs, made from a seed, go through the JAX function and its
PyTorch counterpart on the CPU at float32. Tolerances: 2e-5 on outputs
(float32 sums taken in another order), 2e-4 on gradients (as the JAX
package's own blockwise-vs-reference gradient test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash as tflash

OUT_TOL = 2e-5
GRAD_TOL = 2e-4

# (b, sq, sk, h, kvh, d): square, sq < sk (the causal diagonal is aligned
# by sk - sq), GQA
SHAPES = [(2, 64, 64, 4, 4, 16), (2, 32, 96, 4, 4, 16), (1, 64, 64, 8, 2, 16)]


def _qkv(b, sq, sk, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, sk, kvh, d), np.float32),
            rng.standard_normal((b, sk, kvh, d), np.float32))


def _both(fn_jax, fn_torch, arrays, **kw):
    want = np.asarray(fn_jax(*map(jnp.asarray, arrays), **kw))
    got = fn_torch(*map(torch.from_numpy, arrays), **kw).numpy()
    return want, got


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_jax(shape, causal):
    want, got = _both(jattn.attention_reference, tattn.attention_reference,
                      _qkv(*shape), causal=causal)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_jax(shape, causal):
    want, got = _both(jattn.blockwise_attention, tattn.blockwise_attention,
                      _qkv(*shape), causal=causal, block_size=32)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)


def test_blockwise_fully_masked_rows_are_zero_like_jax():
    # sq > sk under the causal mask: the first rows see no key at all. The
    # m_safe guard keeps them at 0, not nan, in both stacks.
    arrays = _qkv(1, 96, 32, 2, 2, 16, seed=3)
    want, got = _both(jattn.blockwise_attention, tattn.blockwise_attention,
                      arrays, causal=True, block_size=16)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, :64], 0.0)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)


def test_blockwise_rejects_ragged_block():
    arrays = [torch.from_numpy(a) for a in _qkv(1, 40, 40, 2, 2, 16)]
    with pytest.raises(ValueError, match="not divisible"):
        tattn.blockwise_attention(*arrays, block_size=16)


@pytest.mark.parametrize("impl", ["reference", "blockwise", "auto", "flash"])
def test_mha_dispatch_matches_jax_reference(impl):
    arrays = _qkv(*SHAPES[2], seed=1)
    want = np.asarray(jattn.attention_reference(*map(jnp.asarray, arrays),
                                                causal=True))
    got = tattn.mha(*map(torch.from_numpy, arrays), causal=True,
                    block_size=32, impl=impl).numpy()
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)


@pytest.mark.parametrize("sq", [64, 2048])
def test_mha_auto_matches_jax_auto(sq):
    # head_dim 32, which the kernel does not take: both stacks send it to
    # reference attention, or to blockwise at Sq >= 2048
    arrays = _qkv(1, sq, sq, 2, 2, 32, seed=6)
    want = np.asarray(jattn.mha(*map(jnp.asarray, arrays), causal=True,
                                impl="auto"))
    got = tattn.mha(*map(torch.from_numpy, arrays), causal=True,
                    impl="auto").numpy()
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)


def _empty(d, dtype, kv_dtype=None):
    kv_dtype = kv_dtype or dtype
    return (torch.empty(1, 4, 2, d, dtype=dtype),
            torch.empty(1, 4, 2, d, dtype=kv_dtype),
            torch.empty(1, 4, 2, d, dtype=kv_dtype))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_takes_its_head_dims_and_dtypes(d, dtype):
    assert tflash.kernel_takes(*_empty(d, dtype))


@pytest.mark.parametrize("d,dtype,kv_dtype", [
    (32, torch.bfloat16, None), (96, torch.bfloat16, None),
    (256, torch.bfloat16, None), (32, torch.float32, None),
    (128, torch.float16, None), (64, torch.float16, None),
    (128, torch.bfloat16, torch.float32),
])
def test_kernel_takes_refuses_other_shapes(d, dtype, kv_dtype):
    # what mha(impl="auto") sends elsewhere on the card, as the JAX auto
    # sends shapes its kernel cannot take to blockwise or reference
    assert not tflash.kernel_takes(*_empty(d, dtype, kv_dtype))


def test_mha_rejects_unknown_impl():
    arrays = [torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 16)]
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.mha(*arrays, impl="ring")


def test_gqa_is_repeat_interleave():
    # kv head j serves query heads j*rep .. j*rep+rep-1 (jnp.repeat), so
    # query heads 0 and 1 of a 4:2 model see the same keys
    q, k, v = _qkv(1, 8, 8, 4, 2, 16, seed=2)
    q[:, :, 1] = q[:, :, 0]
    out = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out[:, :, 0], out[:, :, 1], atol=1e-6)
    assert not np.allclose(out[:, :, 0], out[:, :, 2])


@pytest.mark.parametrize("fn,kw", [
    ("attention_reference", {}),
    ("blockwise_attention", {"block_size": 32}),
])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[2]])
def test_gradients_match_jax_grad(fn, kw, shape):
    arrays = _qkv(*shape, seed=4)
    w = np.random.default_rng(5).standard_normal(
        arrays[0].shape, np.float32)

    def loss_jax(q, k, v):
        return (getattr(jattn, fn)(q, k, v, causal=True, **kw) * w).sum()

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (getattr(tattn, fn)(*ts, causal=True, **kw)
     * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
