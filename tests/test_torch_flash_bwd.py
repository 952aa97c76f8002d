"""Port parity: the flash-attention backward of ray_tpu_torch.ops.flash
against the Pallas TPU kernels and against ``jax.grad``.

- ``flash_attention_bwd_plain`` is held against
  ``ray_tpu.ops.flash._flash_bwd`` itself (``_bwd_dkv_kernel`` and
  ``_bwd_dq_kernel``), run on the CPU in Pallas interpret mode
  (``pallas_call`` is wrapped with ``interpret=True`` for the test only),
  and ``bwd_delta`` against the Δ that ``_flash_bwd`` hands its kernels.
- The autograd Function (``mha(impl="flash")`` on CPU tensors, whose
  backward is ``flash_bwd``) is held against ``jax.grad`` of the JAX ``mha``
  on the same BSHD inputs.

The CUDA kernels are checked against the plain version on the card by
``tests/test_torch_flash_cuda.py`` and ``chip_smoke.py``.

Tolerances at float32: 2e-5 against the interpret-mode kernels (they sum
over 64- or 128-row blocks, the plain version in one product); 2e-4 on
gradients against ``jax.grad`` (as the slice-1 attention gradient tests).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import flash as jflash
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash as tflash

TOL = 2e-5
GRAD_TOL = 2e-4


@pytest.fixture
def interpret_pallas(monkeypatch):
    if jflash.pl is None:
        pytest.skip("this jax has no pallas")
    monkeypatch.setattr(jflash.pl, "pallas_call", functools.partial(
        jflash.pl.pallas_call, interpret=True))


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in shapes]


# (sq, sk, block): the TPU's 128-row blocks, and the 64-row tiles the CUDA
# kernels stream (64-row q tiles in dK/dV, kv tiles in dQ) at lengths that
# divide by 64 but not by 128
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,block", [
    pytest.param(256, 256, 128, id="256-256"),
    pytest.param(128, 256, 128, id="128-256"),
    pytest.param(192, 192, 64, id="192-192-block64"),
    pytest.param(64, 320, 64, id="64-320-block64")])
def test_plain_bwd_matches_pallas_kernels_in_interpret_mode(
        interpret_pallas, causal, sq, sk, block):
    bh, d = 2, 64
    scale = d ** -0.5
    q, k, v, g = _arrays([(bh, sq, d), (bh, sk, d), (bh, sk, d),
                          (bh, sq, d)], seed=0)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jflash._flash_fwd(jq, jk, jv, causal=causal, scale=scale,
                                 block_q=block, block_k=block)
    want = jflash._flash_bwd((jq, jk, jv, out, lse), jnp.asarray(g),
                             causal=causal, scale=scale, block_q=block,
                             block_k=block)
    got = tflash.flash_attention_bwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(out)),
        torch.from_numpy(np.array(lse)[..., 0]), torch.from_numpy(g),
        causal, scale)
    for name, t, j in zip(("dq", "dk", "dv"), got, want):
        assert t.dtype == torch.float32 and t.shape == j.shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL, err_msg=name)


@pytest.mark.parametrize("b,s,h,d", [(2, 128, 2, 64), (1, 192, 3, 128)])
def test_bwd_delta_matches_flash_bwd_delta_on_bf16(monkeypatch, b, s, h, d):
    # Δ as ``_flash_bwd`` computes it outside Pallas (ray_tpu/ops/flash.py,
    # the sum before its pallas_calls): their sixth operand, broadcast over
    # 128 lanes. The calls themselves are not run; they return zeros.
    if jflash.pl is None:
        pytest.skip("this jax has no pallas")
    seen = []

    def spy(kernel, *, out_shape, **kw):
        def call(*operands):
            seen.append(np.asarray(operands[5])[..., 0])
            if isinstance(out_shape, (list, tuple)):
                return [jnp.zeros(o.shape, o.dtype) for o in out_shape]
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return call

    monkeypatch.setattr(jflash.pl, "pallas_call", spy)
    # bf16 values, exact in both frameworks
    out, do = (torch.from_numpy(a).bfloat16() for a in _arrays(
        [(b, s, h, d)] * 2, seed=7))

    def to_jax(x):   # [B, S, H, D] -> [B*H, S, D] bf16
        x = x.float().transpose(1, 2).reshape(b * h, s, d).numpy()
        return jnp.asarray(x, dtype=jnp.bfloat16)

    lse = jnp.zeros((b * h, s, 128), jnp.float32)
    jout, jdo = to_jax(out), to_jax(do)
    jflash._flash_bwd((jout, jout, jout, jout, lse), jdo, causal=True,
                      scale=d ** -0.5, block_q=64, block_k=64)
    assert len(seen) == 2 and np.array_equal(seen[0], seen[1])
    want = seen[0].reshape(b, h, s)
    got = tflash.bwd_delta(out, do)
    assert got.dtype == torch.float32 and got.shape == (b, h, s)
    # the same exact f32 products, summed in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# (b, sq, sk, h, kvh, d): ragged lengths, Sq < Sk, GQA 4:2
BSHD_SHAPES = [(1, 100, 100, 2, 2, 64), (2, 40, 72, 2, 2, 64),
               (1, 64, 64, 4, 2, 128)]


@pytest.mark.parametrize("shape", BSHD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_function_gradients_match_jax_grad(shape, causal):
    _check_gradients_against_jax_grad(shape, causal, None)


@pytest.mark.parametrize("shape", BSHD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_function_gradients_with_scale_match_jax_grad(shape, causal):
    # 0.07 is not the default d^-0.5 (0.125 at D 64, 0.088 at D 128), which
    # the kernels fold into their exp2 in its place
    _check_gradients_against_jax_grad(shape, causal, 0.07)


def _check_gradients_against_jax_grad(shape, causal, scale):
    b, sq, sk, h, kvh, d = shape
    q, k, v, w = _arrays([(b, sq, h, d), (b, sk, kvh, d), (b, sk, kvh, d),
                          (b, sq, h, d)], seed=3)

    def loss_jax(q, k, v):
        return (jattn.mha(q, k, v, causal=causal, scale=scale,
                          impl="reference") * w).sum()

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tattn.mha(*ts, causal=causal, scale=scale, impl="flash")
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip(("dq", "dk", "dv"), ts, want):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_bshd_plain_sums_gqa_groups_like_repeated_heads():
    # dk of a kv head is the sum of the dk its query heads would get if the
    # kv head were repeated for each of them
    b, s, h, kvh, d = 1, 48, 4, 2, 64
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        [(b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d)], 5))
    out, lse = tflash.flash_fwd_plain(q, k, v, causal=True)
    dq, dk, dv = tflash.flash_bwd_plain(q, k, v, out, lse, do, causal=True)
    kr, vr = (x.repeat_interleave(2, dim=2) for x in (k, v))
    dq_r, dk_r, dv_r = tflash.flash_bwd_plain(q, kr, vr, out, lse, do,
                                              causal=True)
    assert dk.shape == k.shape and dv.shape == v.shape
    torch.testing.assert_close(dq, dq_r, atol=1e-6, rtol=0)
    for got, rep in ((dk, dk_r), (dv, dv_r)):
        want = rep.reshape(b, s, kvh, 2, d).sum(3)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_plain_bwd_bf16_returns_input_dtype_near_f32():
    bh, s, d = 2, 64, 64
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _arrays(
        [(bh, s, d)] * 4, seed=6))
    out, lse = tflash.flash_attention_plain(q, k, v, True, 0.125)
    got = tflash.flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                           0.125)
    ref = tflash.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                           out.float(), lse, do.float(), True,
                                           0.125)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        # P and dS are rounded to bf16 before their products, the outputs
        # once more: a few bf16 ulps of gradients of size ~1
        np.testing.assert_allclose(g.float().numpy(), r.numpy(), atol=5e-2)


def test_causal_backward_refuses_rows_that_see_no_key():
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 4, 2, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        tflash.flash_bwd(q, k, k, q, lse, q, causal=True)
    # without the causal mask every row sees every key
    dq, dk, dv = tflash.flash_bwd(q, k, k, q, lse, q, causal=False)
    assert dq.shape == q.shape and dk.shape == k.shape


def test_cpu_backward_launches_no_kernel():
    before = (tflash.launches, tflash.bwd_dkv_launches,
              tflash.bwd_dq_launches)
    q = torch.randn(1, 16, 2, 64, requires_grad=True)
    tflash.flash_attention(q, q, q).sum().backward()
    assert q.grad is not None
    assert (tflash.launches, tflash.bwd_dkv_launches,
            tflash.bwd_dq_launches) == before
