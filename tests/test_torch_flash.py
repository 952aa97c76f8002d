"""Port parity: ray_tpu_torch.ops.flash against the Pallas TPU kernel.

``flash_attention_plain`` is held against ``ray_tpu.ops.flash._flash_fwd``
itself, run on the CPU in Pallas interpret mode (``pallas_call`` is wrapped
with ``interpret=True`` for the test only), comparing O and the kernel's
log-sum-exp. The CUDA kernel is checked against the plain version on the
card by ``tests/test_torch_flash_cuda.py`` and ``chip_smoke.py``.

Tolerance: 2e-5 at float32 (the interpret-mode kernel sums kv blocks online,
the plain version in one pass).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import flash as jflash
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash as tflash

TOL = 2e-5


@pytest.fixture
def interpret_pallas(monkeypatch):
    if jflash.pl is None:
        pytest.skip("this jax has no pallas")
    monkeypatch.setattr(jflash.pl, "pallas_call", functools.partial(
        jflash.pl.pallas_call, interpret=True))


def _bh(bh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, sq, d), np.float32),
            rng.standard_normal((bh, sk, d), np.float32),
            rng.standard_normal((bh, sk, d), np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 256)])
def test_plain_matches_pallas_kernel_in_interpret_mode(interpret_pallas,
                                                       causal, sq, sk):
    q, k, v = _bh(2, sq, sk, 64)
    scale = 64 ** -0.5
    out_j, lse_j = jflash._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, block_q=128, block_k=128)
    out_t, lse_t = tflash.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale)
    assert lse_t.shape == (2, sq) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0],
                               atol=TOL, rtol=TOL)


# (b, sq, sk, h, kvh, d): ragged lengths, sq < sk, GQA
BSHD_SHAPES = [(1, 100, 100, 2, 2, 64), (2, 40, 72, 2, 2, 64),
               (1, 64, 64, 4, 2, 128)]


@pytest.mark.parametrize("shape", BSHD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_on_cpu_matches_jax_reference(shape, causal):
    b, sq, sk, h, kvh, d = shape
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, sk, kvh, d), np.float32)
    v = rng.standard_normal((b, sk, kvh, d), np.float32)
    want = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    out, lse = tflash.flash_fwd(*map(torch.from_numpy, (q, k, v)),
                                causal=causal)
    assert lse.shape == (b, h, sq)
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", BSHD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_non_default_scale_matches_jax_reference(shape, causal):
    # the kernels fold scale into their exp2; the plain versions they are
    # held against on the card must take it as the JAX reference does
    b, sq, sk, h, kvh, d = shape
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, sk, kvh, d), np.float32)
    v = rng.standard_normal((b, sk, kvh, d), np.float32)
    want = np.asarray(jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=0.07))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (tflash.flash_attention(tq, tk, tv, causal=causal,
                                       scale=0.07),
                tattn.attention_reference(tq, tk, tv, causal=causal,
                                          scale=0.07)):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    default = tflash.flash_attention(tq, tk, tv, causal=causal)
    assert not np.allclose(default.numpy(), want, atol=1e-3)


def test_plain_lse_is_logsumexp_of_scaled_logits():
    q, k, v = _bh(3, 48, 80, 64, seed=1)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    _, lse = tflash.flash_attention_plain(qt, kt, vt, True, 0.125)
    logits = qt @ kt.transpose(1, 2) * 0.125
    mask = torch.ones(48, 80, dtype=torch.bool).tril(80 - 48)
    want = torch.logsumexp(logits.masked_fill(~mask, -torch.inf), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=TOL,
                               rtol=TOL)


def test_plain_bf16_accumulates_in_f32_and_returns_input_dtype():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _bh(2, 64, 64, 64))
    out, lse = tflash.flash_attention_plain(q, k, v, True, 0.125)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, _ = tflash.flash_attention_plain(q.float(), k.float(), v.float(),
                                          True, 0.125)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


@pytest.mark.parametrize("bad,match", [
    ({"d": 32}, "head_dim"),
    ({"kvh": 3}, "do not divide"),
    ({"dtype": torch.float16}, "takes one of"),
])
def test_kernel_input_checks(bad, match):
    d, kvh = bad.get("d", 64), bad.get("kvh", 2)
    dtype = bad.get("dtype", torch.bfloat16)
    q = torch.zeros(1, 8, 4, d, dtype=dtype)
    k = torch.zeros(1, 8, kvh, d, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        tflash._check_inputs(q, k, k)


def test_grad_inputs_reach_the_function():
    # grad-enabled inputs go through the autograd Function (forward kernel,
    # then the backward); the raw forward records no gradient and says so
    q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    tflash._check_inputs(q, k, k)
    out = tflash.flash_attention(q, k, k)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.float().sum().backward()
    assert q.grad.shape == q.shape and q.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="records no gradient"):
        tflash.flash_fwd(q, k, k)
    with torch.no_grad():
        assert tflash.flash_attention(q, k, k).grad_fn is None


def test_unsupported_device_raises():
    q = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tflash.flash_fwd(q, q, q)


def test_cpu_call_launches_no_kernel():
    before = tflash.launches
    q = torch.zeros(1, 8, 2, 64)
    tflash.flash_attention(q, q, q)
    assert tflash.launches == before
