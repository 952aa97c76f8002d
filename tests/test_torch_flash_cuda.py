"""The flash-attention kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) against
their plain versions, on the card. Every test is marked ``cuda`` and skips
without an NVIDIA Hopper card. The file imports no JAX, so it runs where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_flash_cuda.py

Forward tolerances: 1e-4 at float32 (only the order of the f32 sums
differs); 2e-2 on O and 1e-3 on LSE at bfloat16 (P is rounded to bf16 per kv
tile against the running max in the kernel, once per row in the plain
version, and O is rounded to bf16).

Backward tolerances, on the largest error of dq, dk and dv relative to that
gradient's largest magnitude: 1e-4 at float32 (the order of the f32 sums);
2e-2 at bfloat16 (P and dS are rounded to bf16 in both versions, but from
f32 values summed in another order, so a few round the other way; the
outputs are rounded to bf16, 2^-8 of their size). The Δ pass: 1e-5 relative
to Δ's largest magnitude (the same exact products, summed in another order).
"""

import pytest
import torch

from ray_tpu_torch.models import (TransformerConfig, ViTConfig, prefill,
                                  transformer_init)
from ray_tpu_torch.ops import flash
from ray_tpu_torch.ops.attention import attention_reference, mha
from ray_tpu_torch.train import make_lm_train_step, make_vit_train_step

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, sq, sk, h, kvh, d, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, s, n, d, generator=gen, device=dev).to(dtype)
                 for s, n in ((sq, h), (sk, kvh), (sk, kvh)))


# (b, sq, sk, h, kvh, d): ragged lengths, sq < sk, sq > sk (rows that see
# no key), GQA, a tile-aligned case; one past the 128-row q tile (129) and
# three kv tiles through the two-stage K/V ring (257); S 2048 at D 64, where
# the ring wraps eight times; GQA 16:4 at S 1024
SHAPES = [(1, 100, 100, 2, 2, 64), (2, 40, 72, 2, 2, 64),
          (1, 90, 30, 2, 2, 128), (1, 64, 64, 4, 2, 128),
          (2, 256, 256, 4, 4, 128), (2, 129, 129, 2, 2, 128),
          (1, 257, 257, 2, 2, 128), (1, 2048, 2048, 2, 2, 64),
          (1, 1024, 1024, 16, 4, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, shape, causal, dtype):
    q, k, v = _qkv(cuda_device, *shape, dtype)
    before = flash.launches
    with torch.inference_mode():
        out, lse = flash.flash_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
    assert flash.launches == before + 1
    tol_out, tol_lse = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol_out,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=tol_lse, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,causal", [(130, 128, True), (300, 64, False),
                                        (1000, 128, True)])
def test_strided_inputs_match_plain(cuda_device, s, d, causal):
    # q, k, v as slices of one fused [B, S, 3, H, D] projection: the tensor
    # maps and loads follow the strides, no copy is made
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(2, s, 3, 4, d, generator=gen,
                      device=cuda_device).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and flash._vector_ready(q)
    with torch.inference_mode():
        out, lse = flash.flash_fwd(q, k, v, causal=causal)
        want, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 100, 4, 4, 128),
                                   (1, 90, 30, 2, 2, 64),
                                   (1, 257, 1, 2, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_that_see_no_key_are_exact(cuda_device, shape, dtype):
    # causal with Sq > Sk: the first Sq - Sk rows see no key. The plain
    # version gives them O = 0 and LSE = -1e30 + log(1e-30), which is -1e30
    # in f32; the kernel must write exactly that
    q, k, v = _qkv(cuda_device, *shape, dtype, seed=3)
    blind = shape[1] - shape[2]
    with torch.inference_mode():
        out, lse = flash.flash_fwd(q, k, v, causal=True)
        want, want_lse = flash.flash_fwd_plain(q, k, v, causal=True)
    assert bool((want_lse[:, :, :blind] == -1e30).all())
    assert bool((lse[:, :, :blind] == -1e30).all())
    assert bool((out[:, :blind] == 0).all())
    tol_out, tol_lse = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol_out,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=tol_lse, rtol=0)


# causal at D 128 and D 64 (GQA, Sq < Sk), for the non-default scale
SCALE_CASES = [(2, 300, 300, 4, 4, 128), (1, 200, 257, 4, 2, 64)]
SCALE = 0.07   # not d^-0.5 (0.088 at D 128, 0.125 at D 64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCALE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_with_scale_matches_plain(cuda_device, shape, dtype):
    # the kernel folds scale into its exp2 (scale·log2 e)
    q, k, v = _qkv(cuda_device, *shape, dtype, seed=4)
    with torch.inference_mode():
        out, lse = flash.flash_fwd(q, k, v, causal=True, scale=SCALE)
        want, want_lse = flash.flash_fwd_plain(q, k, v, causal=True,
                                               scale=SCALE)
        default, _ = flash.flash_fwd_plain(q, k, v, causal=True)
    tol_out, tol_lse = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol_out,
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=tol_lse, rtol=0)
    assert (default.float() - want.float()).abs().max() > 10 * tol_out


@pytest.mark.cuda
def test_mha_auto_sends_other_head_dims_to_reference(cuda_device):
    # head_dim 32 is not the kernel's: auto returns reference attention, as
    # the JAX auto does, and launches nothing; 'flash' still raises
    q, k, v = _qkv(cuda_device, 2, 70, 70, 4, 2, 32, torch.bfloat16)
    before = flash.launches
    with torch.inference_mode():
        got = mha(q, k, v, causal=True, impl="auto")
        want = attention_reference(q, k, v, causal=True)
        with pytest.raises(ValueError, match="head_dim"):
            mha(q, k, v, causal=True, impl="flash")
    assert flash.launches == before
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_misaligned_inputs_are_copied(cuda_device):
    # contiguous, but the base sits one element past a 16-byte boundary
    b, s, h, d = 1, 70, 2, 64
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    flat = torch.randn(b * s * h * d + 1, generator=gen,
                       device=cuda_device).bfloat16()
    q = flat[1:].view(b, s, h, d)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    with torch.inference_mode():
        out, _ = flash.flash_fwd(q, q, q, causal=True)
        want, _ = flash.flash_fwd_plain(q, q, q, causal=True)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=0)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _counts():
    """Launches so far: the forward, and the backward's dK/dV, dQ and Δ."""
    return (flash.launches, flash.bwd_dkv_launches, flash.bwd_dq_launches,
            flash.bwd_delta_launches)


@pytest.mark.cuda
def test_grad_inputs_reach_the_function(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 64, 64, 2, 2, 64, torch.bfloat16)
    q.requires_grad_()
    counts = _counts()
    out = flash.flash_attention(q, k, v)
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in counts)
    with torch.no_grad():
        o, lse = flash.flash_fwd_plain(q, k, v)
        want, _, _ = flash.flash_bwd_plain(q, k, v, o, lse, 2 * o.float()
                                           .bfloat16())
    assert _rel_err(q.grad, want) <= BWD_TOL[torch.bfloat16]
    with pytest.raises(ValueError, match="records no gradient"):
        flash.flash_fwd(q, k, v)


# (b, sq, sk, h, kvh, d): ragged lengths, sq < sk (the causal offset), GQA,
# tile-aligned; sq > sk only without the causal mask
BWD_CASES = [((1, 100, 100, 2, 2, 64), True), ((1, 100, 100, 2, 2, 64), False),
             ((2, 40, 72, 2, 2, 64), True), ((1, 90, 30, 2, 2, 128), False),
             ((1, 64, 200, 4, 2, 128), True), ((2, 130, 130, 8, 2, 128), True),
             ((2, 256, 256, 4, 4, 128), True),
             ((2, 256, 256, 4, 4, 128), False)]
# Lengths at the kernels' tile edges (64-row streamed tiles, 128-row owned
# tiles): Sk in {1, 63, 64, 65, 127, 128, 129}, causal with Sq = Sk at D 128
# and Sq < Sk at D 64, and without the mask Sq 65 against every Sk (Sq > Sk
# too); then GQA 2:1 and 4:1 at tile edges
EDGE_LENGTHS = (1, 63, 64, 65, 127, 128, 129)
BWD_CASES += [((1, sk, sk, 2, 2, 128), True) for sk in EDGE_LENGTHS]
BWD_CASES += [((1, max(1, sk - 62), sk, 2, 2, 64), True)
              for sk in EDGE_LENGTHS]
BWD_CASES += [((1, 65, sk, 2, 2, 64), False) for sk in EDGE_LENGTHS]
BWD_CASES += [((1, 63, 129, 4, 2, 128), True),
              ((2, 129, 129, 8, 2, 64), False),
              ((1, 127, 128, 8, 2, 128), True),
              ((1, 200, 257, 8, 2, 128), True)]


def _bwd_inputs(dev, shape, dtype, causal):
    q, k, v = _qkv(dev, *shape, dtype)
    gen = torch.Generator(device=dev).manual_seed(9)
    do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    with torch.inference_mode():
        out, lse = flash.flash_fwd(q, k, v, causal=causal)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_match_plain(cuda_device, shape, causal, dtype):
    q, k, v, out, lse, do = _bwd_inputs(cuda_device, shape, dtype, causal)
    before = _counts()
    with torch.inference_mode():
        got = flash.flash_bwd(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        want = flash.flash_bwd_plain(q, k, v, out, lse, do, causal=causal)
    assert _counts() == (before[0], before[1] + 1, before[2] + 1,
                         before[3] + 1)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        assert torch.isfinite(g).all(), name
        if shape[2] == 1 and name != "dv":
            # one key: every row's softmax is constant, so dq and dk are
            # exactly 0 and both versions hold rounding noise of dP - Δ
            # there; no relative error exists. Held to the tolerance
            # relative to dv's magnitude instead.
            scale = want[2].float().abs().max()
            assert g.float().abs().max() <= BWD_TOL[dtype] * scale, name
            continue
        assert _rel_err(g, w) <= BWD_TOL[dtype], (name, _rel_err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCALE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_with_scale_match_plain(cuda_device, shape, dtype):
    # the dK/dV and dQ kernels fold scale into exp2 and into dS
    q, k, v = _qkv(cuda_device, *shape, dtype, seed=5)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    do = torch.randn(q.shape, generator=gen, device=cuda_device).to(dtype)
    with torch.inference_mode():
        out, lse = flash.flash_fwd(q, k, v, causal=True, scale=SCALE)
        got = flash.flash_bwd(q, k, v, out, lse, do, causal=True,
                              scale=SCALE)
        torch.cuda.synchronize()
        want = flash.flash_bwd_plain(q, k, v, out, lse, do, causal=True,
                                     scale=SCALE)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= BWD_TOL[dtype], (name, _rel_err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,causal", [(130, 128, True), (300, 64, False),
                                        (1000, 128, True)])
def test_bwd_strided_inputs_match_plain(cuda_device, s, d, causal):
    # q, k, v as slices of one fused [B, S, 3, H, D] projection: the tensor
    # maps follow the strides, no copy is made
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    qkv = torch.randn(2, s, 3, 4, d, generator=gen,
                      device=cuda_device).bfloat16()
    q, k, v = qkv.unbind(2)
    do = torch.randn(2, s, 4, d, generator=gen, device=cuda_device).bfloat16()
    assert not q.is_contiguous() and flash._vector_ready(q)
    with torch.inference_mode():
        out, lse = flash.flash_fwd(q, k, v, causal=causal)
        got = flash.flash_bwd(q, k, v, out, lse, do, causal=causal)
        want = flash.flash_bwd_plain(q, k, v, out, lse, do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(g, w) <= BWD_TOL[torch.bfloat16], name


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 300, 300, 4, 2, 128), True),
                                          ((1, 512, 512, 4, 4, 64), False),
                                          ((1, 1024, 1024, 8, 8, 128), True)])
def test_bwd_is_bitwise_deterministic(cuda_device, shape, causal):
    # no atomics: two calls on the same inputs give the same bits, which a
    # race on the shared-memory ring would break
    q, k, v, out, lse, do = _bwd_inputs(cuda_device, shape, torch.bfloat16,
                                        causal)
    with torch.inference_mode():
        first = flash.flash_bwd(q, k, v, out, lse, do, causal=causal)
        second = flash.flash_bwd(q, k, v, out, lse, do, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(2, 100, 4, 128), (1, 129, 2, 64),
                                     (1, 64, 3, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_delta_pass_matches_plain(cuda_device, b, s, h, d, dtype):
    # Δ in f32 from one read of O and dO, against bwd_delta's f32 copies:
    # the same products, summed in another order (relative 1e-5). bf16 rows
    # are padded to a multiple of 64 with zeros, and carry LSE·log2 e
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    out, do = (torch.randn(b, s, h, d, generator=gen,
                           device=cuda_device).to(dtype) for _ in range(2))
    lse = torch.randn(b, h, s, generator=gen, device=cuda_device)
    before = flash.bwd_delta_launches
    with torch.inference_mode():
        lse_k, delta = flash.bwd_preprocess(out, do, lse)
        want = flash.bwd_delta(out, do)
    assert flash.bwd_delta_launches == before + 1
    rows = -(-s // 64) * 64 if dtype == torch.bfloat16 else s
    assert delta.shape == lse_k.shape == (b, h, rows)
    assert _rel_err(delta[..., :s], want) <= 1e-5
    assert bool((delta[..., s:] == 0).all())
    if dtype == torch.bfloat16:
        torch.testing.assert_close(lse_k[..., :s], lse * 1.4426950408889634,
                                   rtol=1e-6, atol=0)
        assert bool((lse_k[..., s:] == 0).all())
    else:
        assert lse_k is lse


@pytest.mark.cuda
def test_bwd_strided_grad_output_matches_plain(cuda_device):
    # dO as a transposed view (strides no 16-byte load can follow along D)
    q, k, v = _qkv(cuda_device, 1, 96, 96, 2, 2, 64, torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    do = torch.randn(1, 96, 64, 2, generator=gen,
                     device=cuda_device).bfloat16().transpose(2, 3)
    assert not do.is_contiguous()
    with torch.inference_mode():
        out, lse = flash.flash_fwd(q, k, v)
        got = flash.flash_bwd(q, k, v, out, lse, do)
        want = flash.flash_bwd_plain(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        assert _rel_err(g, w) <= BWD_TOL[torch.bfloat16]


@pytest.mark.cuda
def test_bwd_refuses_causal_rows_that_see_no_key(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 90, 30, 2, 2, 128, torch.bfloat16)
    with torch.inference_mode():
        out, lse = flash.flash_fwd(q, k, v, causal=True)
        with pytest.raises(ValueError, match="Sq <= Sk"):
            flash.flash_bwd(q, k, v, out, lse, out, causal=True)


@pytest.mark.cuda
def test_prefill_launches_kernel_once_per_layer(cuda_device):
    cfg = TransformerConfig(vocab_size=256, d_model=256, n_layers=3,
                            n_heads=2, n_kv_heads=1)
    params = transformer_init(torch.Generator(device=cuda_device)
                              .manual_seed(0), cfg)
    tokens = torch.randint(0, 256, (2, 50), device=cuda_device)
    flash.launches = 0
    with torch.inference_mode():
        logits, cache = prefill(params, tokens, cfg, 64)
    assert flash.launches == cfg.n_layers
    assert torch.isfinite(logits).all() and cache["k"].shape[2] == 64


@pytest.mark.cuda
def test_train_step_launches_each_kernel_per_layer(cuda_device):
    # remat: the forward kernel runs once per layer in the forward and once
    # more in the recompute; each backward kernel (Δ, dK/dV, dQ) once per
    # layer
    cfg = TransformerConfig(vocab_size=256, d_model=256, n_layers=3,
                            n_heads=2, n_kv_heads=1, attn_impl="flash")
    init_fn, step_fn, place = make_lm_train_step(cfg)
    state = init_fn(torch.Generator(device=cuda_device).manual_seed(0))
    batch = place({"tokens": torch.randint(0, 256, (2, 70))})
    flash.launches = flash.bwd_dkv_launches = flash.bwd_dq_launches = 0
    flash.bwd_delta_launches = 0
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    assert _counts() == (6, 3, 3, 3)
    assert torch.isfinite(metrics["loss"]) and metrics["step"] == 1


def _reset_counts():
    flash.launches = flash.bwd_dkv_launches = flash.bwd_dq_launches = 0
    flash.bwd_delta_launches = 0


@pytest.mark.cuda
def test_moe_train_step_launches_each_kernel_per_layer(cuda_device):
    # the MoE layer changes the MLP only: attention launches as dense
    cfg = TransformerConfig(vocab_size=256, d_model=256, n_layers=2,
                            n_heads=2, num_experts=4, expert_top_k=2)
    init_fn, step_fn, place = make_lm_train_step(cfg)
    state = init_fn(torch.Generator(device=cuda_device).manual_seed(1))
    batch = place({"tokens": torch.randint(0, 256, (2, 70))})
    _reset_counts()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    assert _counts() == (4, 2, 2, 2)
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(
        metrics["grad_norm"])


@pytest.mark.cuda
def test_vit_train_step_launches_each_kernel_per_layer(cuda_device):
    # bidirectional attention at head_dim 64 over 17 tokens goes to the
    # kernels under mha's auto
    cfg = ViTConfig(image_size=32, patch_size=8, num_classes=10,
                    d_model=128, n_layers=2, n_heads=2)
    init_fn, step_fn, place = make_vit_train_step(cfg)
    state = init_fn(torch.Generator(device=cuda_device).manual_seed(2))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    batch = place({"image": torch.randn(4, 32, 32, 3, generator=gen,
                                        device=cuda_device),
                   "label": torch.randint(0, 10, (4,), generator=gen,
                                          device=cuda_device)})
    _reset_counts()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    assert _counts() == (4, 2, 2, 2)
    assert torch.isfinite(metrics["loss"]) and metrics["step"] == 1
