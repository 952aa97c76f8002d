#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. Card and build: the card's name and power limit, then the build of every
   CUDA source of the port (nvcc for sm_90a, flash_fwd.cu and flash_bwd.cu
   in parallel), with its seconds and ptxas' register and spill report; for
   the bf16 forward, dK/dV and dQ kernels (TMA ring, warp-specialised,
   wgmma) also their registers at launch, local memory and dynamic shared
   memory. Any spill in those kernels fails the run.
2. Kernel against its plain version: the flash-attention forward kernel
   (csrc/flash_fwd.cu) and ``flash_fwd_plain`` on the same card tensors, at
   bf16 and f32, over the serving path's prefill shape, the flagship's
   max_seq, a ragged length, Sq < Sk, causal Sq > Sk (whose rows that see
   no key must hold exactly O = 0 and LSE = -1e30), q, k and v as strided
   views of one fused [B, S, 3, H, D] tensor, GQA, head_dim 64 and the ViT
   training shape (B 128, S 197, 6 heads of 64, not causal). O and LSE
   errors are printed beside their tolerances, with the kernel's time (CUDA
   events around the wrapper, and the kernel's own device time from
   torch.profiler), the plain version's, the least time the card could take
   (the bound) and, as a yardstick only, torch's
   scaled_dot_product_attention (the port never calls it).
2b. Backward kernels against their plain version: the Δ pass, dK/dV and dQ
   kernels (csrc/flash_bwd.cu) and ``flash_bwd_plain`` on the same card
   tensors with a random dO, at bf16 and f32, over the flagship's training
   shape, a non-causal case, a ragged length, Sq < Sk, GQA, head_dim 64 and
   the ViT training shape; errors relative to each gradient's largest
   magnitude, a second call that must give the same bits, each kernel's
   time (CUDA events and profiler device time) and share of its bound, the
   whole wrapper's time, the plain version's, the bound and, as a yardstick
   only, the backward of scaled_dot_product_attention.
3. Serving at full width: the flagship LM (vocab 32768, d_model 2048, 10
   layers, 16 heads, head_dim 128, d_ff 8192, tied embeddings; random
   weights from a seed) answers a batch of 8 prompts of 128 tokens with 256
   greedy tokens through ``generate``. The kernel must launch once per layer
   (the prefill). The prefill's last-position logits are held against the
   plain attention path; time to first token, decode ms a step, and the
   card's busy share and kernels a decode step (torch.profiler). Then a
   small model's logits on the card against the CPU.
4. Long prefill: batch 2 at S = 2048 (max_seq) through the kernel, against
   the plain path.
5. Training at full width: the flagship (bench.py's bench_lm configuration,
   remat on) takes 2 warm-up and 5 timed steps of ``make_lm_train_step`` on
   a fixed batch of 8 x 2048 tokens. Each step must launch the forward
   kernel 2 x n_layers times (forward and remat recompute) and each backward
   kernel (Δ, dK/dV, dQ) n_layers times, with finite metrics and a falling
   loss; the first step is held against the plain attention path. Step
   time, tokens/s, MFU, peak memory, and one profiled step's device time by
   kernel class (flash kernels, cuBLAS products, AdamW, element-wise).
6. A small f32 model takes one training step on the card (the kernels) and
   one on the CPU (the plain versions): loss, grad_norm and every updated
   parameter agree.
7. flagship-MoE serving: phase 3 with 4 experts, top-2, in every layer
   (2,248,271,872 parameters), routing dropless at inference. Routing flips
   between the kernel and the plain path (a token whose top-2 gates are
   within bf16 rounding) are counted; rows whose last position kept its
   experts are held to the logit tolerance. Also the MoE layer's device
   time at the decode shape, timed alone, against a decode step's.
8. flagship-MoE training: phase 5 with the same experts (capacity factor
   1.25), the routing flips of the first step counted, and the MoE layer's
   routing, dispatch, expert and combine products timed alone at one
   layer's training shape.
9. ViT training: ``ViTConfig()``'s defaults (224² images, patch 16, 6
   layers, 6 heads of 64, S 197, bidirectional, remat) at batch 128 on
   seeded random images: each step must launch the forward kernel 12 times
   and each backward kernel 6 times, with a falling loss; step time,
   images/s, peak memory and one profiled step.
10. A small f32 MoE LM and a small ViT on the card against the CPU: logits
   and one training step.
11. ResNet-50 training at bench.py's bench_resnet point: 1000 classes, 224²
   images, batch 256 of seeded normal images (NHWC) and labels, SGD at lr
   0.1 with Nesterov momentum 0.9 through ``make_resnet_train_step`` (bf16
   convolutions in cuDNN, channels_last, ``torch.backends.cudnn.benchmark``
   on for this phase only); 3 warm-up steps, then the best of two windows
   of 30 steps. No flash kernel runs on this path (the JAX ResNet runs no
   Pallas kernel): every count must stay 0. Step ms, images/s, the tensor
   cores' bound for the step's convolutions, peak memory, a falling and
   finite loss, batch statistics moved from their init, an eval-mode
   forward's finite logits, and one profiled step's device time by kernel
   class (convolutions, BatchNorm, element-wise, SGD, other).
12. A small f32 ResNet (stages 1, 1, 1, 1; 32² images, 10 classes) on the
   card with TF32 off against the CPU: logits in train and eval mode, then
   one training step's loss, updated parameters and batch statistics.
13. PPO on CartPole (``ray_tpu_torch.rl``) at the JAX package's learning
   gate (tests/test_rl.py): 2 in-process rollout workers x 16 envs x 64
   steps, hiddens (64, 64), lr 3e-4, 8 epochs of minibatch 256, entropy
   0.01, seed 0, 25 iterations in PPO.training_step's order (sample,
   concat, PPOLearner.update on the card, get_weights back to the
   workers). The best mean reward must reach 120. Env steps/s, sample and
   update ms of an iteration, SGD steps/s, and one profiled update's busy
   share and kernels a SGD step. Then the same with the workers on the CPU
   (as the JAX cluster places its rollout actors). No flash kernel runs on
   an RL path (the JAX RL stack reaches no Pallas kernel): every count must
   stay 0.
14. The PPO learner at Atari frame size: ConvRLModule on 84x84x4 frames, 4
   actions, one update of a seeded 5,000-frame batch at minibatch 500 for
   10 epochs, clip 0.1, entropy 0.01 (RLlib's atari-ppo batch settings):
   update ms, samples/s, peak memory, finite stats, a profiled update.
15. Small f32 RL modules (MLP, CNN, LSTM and GTrXL with dones) on the card
   (TF32 off) against the CPU: logits, values, final states, logp and
   entropy of fixed actions, one PPOLearner.update (MLP, CNN) or the
   gradients of a loss over a sequence (LSTM, GTrXL).

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}`` with the one card the run used.
Without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12      # outside the tensor cores: the f32 kernel's FMA
PEAK_BYTES = 3.35e12

# Tolerances, kernel against its plain version on the same card tensors.
# bf16: P is rounded to bf16 per kv tile against the running max in the
# kernel, once per row against the final max in the plain version, and O is
# rounded to bf16 (one ulp of a value near 1 is 2^-8); LSE is f32 in both.
# f32: only the order of the f32 sums differs.
TOL = {torch.bfloat16: {"out": 2e-2, "lse": 1e-3},
       torch.float32: {"out": 1e-4, "lse": 1e-4}}
# Flagship logits, kernel path against the plain attention path at bf16:
# both round every layer's activations to bf16, so the two drift apart by a
# few bf16 ulps of the logits (std ~1) over 10 layers.
LOGIT_TOL_BF16 = 0.25
# A small f32 model, card (kernel, cuBLAS) against CPU (plain path).
LOGIT_TOL_F32 = 1e-3
# Backward kernels against their plain version on the same card tensors, on
# the largest error of dq, dk and dv relative to that gradient's largest
# magnitude (bf16 gradients at S 2048 are far from 1). bf16: P and dS are
# rounded to bf16 in both versions, from f32 values summed in another order,
# and the outputs are rounded to bf16 (2^-8 of their size). f32: the order
# of the f32 sums.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# First training step of the flagship, kernel path against the plain
# attention path, both at bf16: the loss (~ln 32768 = 10.4 at random
# weights) is a mean over 16k tokens, so the per-logit drift of a few bf16
# ulps averages out to well under 1e-2; the gradient norm sums bf16 products
# of every layer, 2% relative. The same holds for flagship-MoE: a token whose
# top-2 flips between the paths (router logits within bf16 rounding of a
# tie) carries another hidden state into the later layers, so flips compound
# with depth, but each changes its own loss term by a random sign and the
# mean over 16k tokens stays far inside 1e-2.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GNORM_RTOL = 2e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10):
    """Mean milliseconds of device time of the kernels ``fn`` launches
    (torch.profiler's kernel intervals), free of the host's launch cost;
    None where the profiler records no device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    if not events:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / iters / 1e3


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _visible_pairs(sq, sk, causal):
    """(q, k) pairs the mask leaves, the diagonal offset by sk - sq."""
    if not causal:
        return sq * sk
    rows = np.arange(sq) + (sk - sq) + 1
    return int(np.clip(rows, 0, sk).sum())


def _bound(flops, nbytes, dtype):
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, sq, sk, h, kvh, d, causal, dtype):
    """Least milliseconds for the forward: each input byte read once, each
    output byte written once; operations 4*D per visible (q, k) pair."""
    es = torch.empty((), dtype=dtype).element_size()
    flops = 4.0 * b * h * d * _visible_pairs(sq, sk, causal)
    nbytes = (2 * b * sq * h * d + 2 * b * sk * kvh * d) * es + b * h * sq * 4
    return _bound(flops, nbytes, dtype)


def backward_bound(b, sq, sk, h, kvh, d, causal, dtype, part="all"):
    """Least milliseconds for the backward, or for one of its kernels.

    all: q, k, v, o, dO and LSE in, dq, dk, dv out; 10*D operations per
    visible pair (Q K^T, dV, dP, dK, dQ). dkv: q, k, v, dO, LSE and Delta
    in, dk, dv out; 8*D (Q K^T, dV, dP, dK). dq: the same in, dq out; 6*D
    (Q K^T, dP, dQ)."""
    es = torch.empty((), dtype=dtype).element_size()
    q_elems, kv_elems, stats = b * sq * h * d, b * sk * kvh * d, b * h * sq
    ops_per_d, ins, outs = {
        "all": (10, 3 * q_elems + 2 * kv_elems, q_elems + 2 * kv_elems),
        "dkv": (8, 2 * q_elems + 2 * kv_elems, 2 * kv_elems),
        "dq": (6, 2 * q_elems + 2 * kv_elems, q_elems),
    }[part]
    flops = ops_per_d * b * h * d * _visible_pairs(sq, sk, causal)
    nbytes = (ins + outs) * es + stats * 4 * (1 if part == "all" else 2)
    return _bound(flops, nbytes, dtype)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from ray_tpu_torch import require_sm90
    from ray_tpu_torch.ops import _build
    require_sm90(torch.device("cuda", 0))
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] seconds={time.perf_counter() - t0:.1f} (nvcc for every "
          f"stale source, in parallel) into {_build.BUILD_DIR}", flush=True)
    spills = {}
    for name in ("flash_fwd", "flash_bwd"):
        entry = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "spill stores" in line and "bf16_kernel" in entry:
                spills[f"{name}:{entry[-60:]}"] = line.strip()
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "C75" in line or "arning" in line):
                print(f"[build] {name}: {line.strip()}")
    from ray_tpu_torch.ops import flash
    attrs = {f"fwd_bf16_d{d}": flash.fwd_kernel_attributes(d)
             for d in (64, 128)}
    for d in (64, 128):
        for part, a in flash.bwd_kernel_attributes(d).items():
            attrs[f"bwd_{part}_bf16_d{d}"] = a
    for name, a in attrs.items():
        print(f"[build] {name}: {a['registers']} registers a thread at "
              f"launch (setmaxnreg then moves them: producer 24, consumers "
              f"240), {a['local_bytes']} bytes of local memory a thread, "
              f"{a['smem_bytes']} bytes of dynamic shared memory", flush=True)
    # the forward, dK/dV and dQ bf16 kernels at D 64 and 128
    check(len(spills) == 6 and all("0 bytes spill stores" in v
                                   for v in spills.values())
          and all(a["local_bytes"] == 0 for a in attrs.values()),
          f"bf16 flash kernels spill or are missing from ptxas' report: "
          f"{spills}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[setup] torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False: f32 products run in full "
          "f32", flush=True)
    return card, {"attributes": attrs, "ptxas_bf16_spills": spills}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

# name, (b, sq, sk, h, kvh, d), causal
CASES = [
    ("serve_prefill", (8, 128, 128, 16, 16, 128), True),
    ("max_seq_causal", (8, 2048, 2048, 16, 16, 128), True),
    ("max_seq_full", (8, 2048, 2048, 16, 16, 128), False),
    ("ragged", (2, 1000, 1000, 16, 16, 128), True),
    ("sq_lt_sk", (2, 300, 1000, 16, 16, 128), True),
    ("sq_gt_sk", (2, 300, 100, 16, 16, 128), True),
    ("fused_qkv_view", (2, 1000, 1000, 16, 16, 128), True),
    ("gqa", (2, 512, 512, 16, 4, 128), True),
    ("head_dim_64", (2, 777, 777, 8, 8, 64), True),
    ("vit_train", (128, 197, 197, 6, 6, 64), False),
]
# cases whose q, k and v are strided views of one [B, S, 3, H, D] tensor
FUSED = {"fused_qkv_view"}


def _case_inputs(name, shape, gen):
    """q, k, v maker for one case: fn(dtype) -> (q, k, v) on the card."""
    b, sq, sk, h, kvh, d = shape
    if name in FUSED:
        qkv = torch.randn(b, sq, 3, h, d, generator=gen, device="cuda")
        return lambda dtype: qkv.to(dtype).unbind(2)
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda")
    k = torch.randn(b, sk, kvh, d, generator=gen, device="cuda")
    v = torch.randn(b, sk, kvh, d, generator=gen, device="cuda")
    return lambda dtype: (q.to(dtype), k.to(dtype), v.to(dtype))


def _library_ms(q, k, v, causal):
    import torch.nn.functional as F
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = {"enable_gqa": k.shape[2] != q.shape[2]}
    if causal and sq != sk:   # bottom-right diagonal, as the kernel's
        kw["attn_mask"] = torch.ones(sq, sk, dtype=torch.bool,
                                     device=q.device).tril(sk - sq)
    else:
        kw["is_causal"] = causal

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    return cuda_ms(sdpa), device_ms(sdpa)


def phase_kernel_checks():
    from ray_tpu_torch.ops import flash
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, shape, causal in CASES:
        b, sq, sk, h, kvh, d = shape
        make = _case_inputs(name, shape, gen)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = make(dtype)
            with torch.inference_mode():
                out, lse = flash.flash_fwd(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
                err = (out.float() - want.float()).abs().max().item()
                lse_err = (lse - want_lse).abs().max().item()
                check(torch.isfinite(out).all().item(), f"{name}: non-finite O")
                exact = ""
                if causal and sq > sk:   # rows that see no key, exactly
                    blind = sq - sk
                    check(bool((lse[:, :, :blind] == -1e30).all())
                          and bool((out[:, :blind] == 0).all())
                          and bool((want_lse[:, :, :blind] == -1e30).all()),
                          f"{name}: rows that see no key are not exactly "
                          f"O = 0, LSE = -1e30")
                    exact = f" rows_without_key={blind}: O=0, LSE=-1e30 exact"

                def fn():
                    return flash.flash_fwd(q, k, v, causal=causal)

                ms, dev_ms = cuda_ms(fn), device_ms(fn)
                plain_ms = cuda_ms(lambda: flash.flash_fwd_plain(
                    q, k, v, causal=causal), iters=3, warmup=1)
                lib_ms, lib_dev_ms = _library_ms(q, k, v, causal)
            bound_ms, bound_by = attention_bound(b, sq, sk, h, kvh, d,
                                                 causal, dtype)
            tol = TOL[dtype]
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            print(f"[kernel] {name} {tag} b={b} sq={sq} sk={sk} h={h} "
                  f"kvh={kvh} d={d} causal={causal}"
                  f"{' fused-qkv strided views' if name in FUSED else ''}: "
                  f"max_abs_err O={err:.3e} (tol {tol['out']:.0e}) "
                  f"LSE={lse_err:.3e} (tol {tol['lse']:.0e}){exact} "
                  f"kernel_ms={ms:.4f} device_ms={_fmt(dev_ms)} "
                  f"plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"library_ms={lib_ms:.4f} library_device_ms="
                  f"{_fmt(lib_dev_ms)} bound/kernel={bound_ms / ms:.3f}",
                  flush=True)
            check(err <= tol["out"] and lse_err <= tol["lse"],
                  f"{name} {tag}: kernel disagrees with its plain version")
            results[(name, tag)] = dict(
                max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, shape=[b, sq, sk, h, kvh, d])
            del q, k, v
        del make
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 2b
# ---------------------------------------------------------------------------

# name, (b, sq, sk, h, kvh, d), causal
BWD_CASES = [
    ("train_causal", (8, 2048, 2048, 16, 16, 128), True),
    ("full", (2, 2048, 2048, 16, 16, 128), False),
    ("ragged", (2, 1000, 1000, 16, 16, 128), True),
    ("sq_lt_sk", (2, 300, 1000, 16, 16, 128), True),
    ("gqa", (2, 512, 512, 16, 4, 128), True),
    ("head_dim_64", (2, 777, 777, 8, 8, 64), True),
    ("vit_train", (128, 197, 197, 6, 6, 64), False),
]


def _library_bwd_ms(q, k, v, do, causal):
    """scaled_dot_product_attention's backward alone: its forward plus
    backward, less its forward (both recorded under autograd)."""
    import torch.nn.functional as F
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    kw = {"enable_gqa": k.shape[2] != q.shape[2]}
    if causal and sq != sk:
        kw["attn_mask"] = torch.ones(sq, sk, dtype=torch.bool,
                                     device=q.device).tril(sk - sq)
    else:
        kw["is_causal"] = causal

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    return cuda_ms(fwd_bwd) - cuda_ms(fwd)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def delta_bound(b, sq, h, d, dtype):
    """Least milliseconds for the Δ pass: O and dO read once, LSE read once
    and LSE·log2 e written (bf16 only), Δ written; 2*D operations a row on
    the FMA units."""
    es = torch.empty((), dtype=dtype).element_size()
    stats = b * h * sq * 4 * (3 if dtype == torch.bfloat16 else 1)
    nbytes = 2 * b * sq * h * d * es + stats
    t_ops = 2.0 * b * sq * h * d / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _share(bound, times):
    """Share of the bound reached: by device time where the profiler gave
    one, else by CUDA-event time."""
    ms_events, ms_device = times
    return bound / (ms_device if ms_device is not None else ms_events)


def phase_backward_checks():
    from ray_tpu_torch.ops import flash
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for name, (b, sq, sk, h, kvh, d), causal in BWD_CASES:
        q0 = torch.randn(b, sq, h, d, generator=gen, device="cuda")
        k0 = torch.randn(b, sk, kvh, d, generator=gen, device="cuda")
        v0 = torch.randn(b, sk, kvh, d, generator=gen, device="cuda")
        do0 = torch.randn(b, sq, h, d, generator=gen, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (x.to(dtype) for x in (q0, k0, v0, do0))
            scale = d ** -0.5
            with torch.inference_mode():
                out, lse = flash.flash_fwd(q, k, v, causal=causal)
                got = flash.flash_bwd(q, k, v, out, lse, do, causal=causal)
                torch.cuda.synchronize()
                again = flash.flash_bwd(q, k, v, out, lse, do, causal=causal)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                want = flash.flash_bwd_plain(q, k, v, out, lse, do,
                                             causal=causal)
                rel = [_rel_err(g, w) for g, w in zip(got, want)]
                abs_err = [(g.float() - w.float()).abs().max().item()
                           for g, w in zip(got, want)]
                check(all(torch.isfinite(g).all().item() for g in got),
                      f"{name}: non-finite gradient")
                check(same, f"{name}: two backward calls differ")
                lse_k, delta = flash.bwd_preprocess(out, do, lse)
                delta_want = flash.bwd_delta(out, do)
                delta_err = _rel_err(delta[..., :sq], delta_want)
                delta_abs = (delta[..., :sq] - delta_want).abs().max().item()
                args = (q, k, v, do, lse_k, delta,
                        *(torch.empty_like(g) for g in got), causal, scale)

                def run_delta():
                    flash.bwd_preprocess(out, do, lse)

                def run_dkv():
                    flash.bwd_dkv(*args)

                def run_dq():
                    flash.bwd_dq(*args)

                def run_all():
                    flash.flash_bwd(q, k, v, out, lse, do, causal=causal)

                times = {part: (cuda_ms(fn), device_ms(fn)) for part, fn in
                         (("delta", run_delta), ("dkv", run_dkv),
                          ("dq", run_dq), ("wrapper", run_all))}
                delta_plain_ms = cuda_ms(lambda: flash.bwd_delta(out, do))
                plain_ms = cuda_ms(lambda: flash.flash_bwd_plain(
                    q, k, v, out, lse, do, causal=causal), iters=3, warmup=1)
                del want, got, again
            lib_ms = _library_bwd_ms(q, k, v, do, causal)
            shape = (b, sq, sk, h, kvh, d, causal, dtype)
            bounds = {"wrapper": backward_bound(*shape),
                      "dkv": backward_bound(*shape, part="dkv"),
                      "dq": backward_bound(*shape, part="dq"),
                      "delta": delta_bound(b, sq, h, d, dtype)}
            tol = BWD_TOL[dtype]
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            timing = " ".join(
                f"{part}: ms={times[part][0]:.4f} device_ms="
                f"{_fmt(times[part][1])} bound_ms={bounds[part][0]:.4f} "
                f"({bounds[part][1]}) share="
                f"{_share(bounds[part][0], times[part]):.3f};"
                for part in ("delta", "dkv", "dq", "wrapper"))
            print(f"[backward] {name} {tag} b={b} sq={sq} sk={sk} h={h} "
                  f"kvh={kvh} d={d} causal={causal}: max_rel_err "
                  f"dq={rel[0]:.3e} dk={rel[1]:.3e} dv={rel[2]:.3e} "
                  f"(tol {tol:.0e}; max_abs_err dq={abs_err[0]:.3e} "
                  f"dk={abs_err[1]:.3e} dv={abs_err[2]:.3e}) delta_rel_err="
                  f"{delta_err:.3e} (tol 1e-5) bitwise_repeatable={same} | "
                  f"{timing} delta_plain_ms={delta_plain_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}",
                  flush=True)
            check(max(rel) <= tol and delta_err <= 1e-5,
                  f"{name} {tag}: backward kernels disagree with their "
                  f"plain version")
            results[(name, tag)] = dict(
                rel=rel, abs=abs_err, delta_err=delta_err,
                delta_abs=delta_abs, times=times,
                bounds=bounds, plain_ms=plain_ms,
                delta_plain_ms=delta_plain_ms, library_ms=lib_ms,
                shape=[b, sq, sk, h, kvh, d])
        del q0, k0, v0, do0
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 3, 4 and 7
# ---------------------------------------------------------------------------

def flagship_cfg(**kw):
    """bench.py's flagship decode configuration (the ~0.74B LM)."""
    from ray_tpu_torch.models import TransformerConfig
    return TransformerConfig(vocab_size=32768, d_model=2048, n_layers=10,
                             n_heads=16, n_kv_heads=16, d_ff=8192,
                             max_seq=2048, attn_impl="auto",
                             tied_embeddings=True, **kw)


def _prefill_logits(params, prompt, cfg, max_len):
    from ray_tpu_torch.models import prefill
    from ray_tpu_torch.models.generate import _cast_params
    with torch.inference_mode():
        logits, _ = prefill(_cast_params(params, cfg.dtype), prompt, cfg,
                            max_len)
    torch.cuda.synchronize()
    return logits


def moe_cfg(**kw):
    """flagship-MoE: the flagship's widths and depth with 4 experts, top-2
    (the repo's own MoE setting, tests/test_models_train_step.py)."""
    return flagship_cfg(num_experts=4, expert_top_k=2, **kw)


@contextlib.contextmanager
def _recorded_routing():
    """Within the block, every call of the MoE layer also records its
    tokens' top-k experts, sorted, as [B, S, k] on the host in call order
    (no flash kernel runs in the recording)."""
    from ray_tpu_torch.models import moe
    apply, calls = moe.moe_apply, []

    def recording(cfg, moe_params, h, **kw):
        with torch.no_grad():
            logits = torch.einsum("bsd,de->bse", h,
                                  moe_params["router"].to(h.dtype))
            top = torch.topk(logits.float().softmax(-1), cfg.expert_top_k,
                             dim=-1).indices
            calls.append(top.sort(-1).values.cpu())
        return apply(cfg, moe_params, h, **kw)

    moe.moe_apply = recording
    try:
        yield calls
    finally:
        moe.moe_apply = apply


def _routing_flips(got, want, layers):
    """[L, B, S] bool: where the first ``layers`` recorded calls of two runs
    chose different top-k experts."""
    return torch.stack([(a != b).any(-1) for a, b in
                        zip(got[:layers], want[:layers])])


def phase_serving(card, cfg, tag, seed):
    """Serve 8 prompts of 128 tokens with 256 greedy tokens each through
    ``generate``; ``tag`` names the path in the output and the counts."""
    from ray_tpu_torch.models import generate, transformer_init
    from ray_tpu_torch.models import transformer_num_params
    batch, prompt_len, new = 8, 128, 256
    params = transformer_init(torch.Generator(device="cuda").manual_seed(
        seed), cfg)
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len))).cuda()
    print(f"[{tag}] params={transformer_num_params(cfg)} "
          f"experts={cfg.num_experts} top_k={cfg.expert_top_k} "
          f"batch={batch} prompt={prompt_len} new={new}", flush=True)
    generate(params, prompt, cfg, max_new_tokens=4)   # warm-up
    torch.cuda.synchronize()

    _reset_launch_counts()
    t0 = time.perf_counter()
    tokens = generate(params, prompt, cfg, max_new_tokens=new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    check(launches == (cfg.n_layers, 0, 0, 0),
          f"{tag}: kernels launched {launches} times (fwd, dkv, dq, delta), "
          f"want ({cfg.n_layers}, 0, 0, 0)")
    check(tokens.shape == (batch, new), f"tokens shape {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "token out of range")
    tokens_per_s = batch * new / seconds
    print(f"[{tag}] generate: {tokens_per_s:.1f} tokens/s "
          f"({seconds:.3f} s for {batch}x{new} greedy tokens; "
          f"flash launches={launches[0]}) on {card}", flush=True)

    plain_cfg = dataclasses.replace(cfg, attn_impl="reference")
    with _recorded_routing() as kernel_routes:
        kernel = _prefill_logits(params, prompt, cfg, prompt_len + new)
    with _recorded_routing() as plain_routes:
        plain = _prefill_logits(params, prompt, plain_cfg, prompt_len + new)
    check(torch.isfinite(kernel).all().item(), "non-finite prefill logits")
    row_diff = (kernel - plain).abs().amax(-1)
    agree = (kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    checked = torch.ones(batch, dtype=torch.bool)
    flips = ""
    if cfg.num_experts:
        # A token whose top-k differs between the paths runs other experts,
        # which moves its own logits by O(1): a bf16 rounding flip, not a
        # fault. Flips at other positions reach the last one only through
        # attention, diluted over the prompt, so rows whose last position
        # kept its experts in every layer are held to the tolerance.
        f = _routing_flips(kernel_routes, plain_routes, cfg.n_layers)
        checked = ~f[:, :, -1].any(0)
        flips = (f" routing flips (token-layers whose top-{cfg.expert_top_k}"
                 f" differs) {int(f.sum())} of {f.numel()}, rows checked "
                 f"{int(checked.sum())} of {batch} (the rest flipped at the "
                 f"last position)")
        check(bool(checked.any()), "every row's last position flipped")
    diff = row_diff[checked.cuda()].max().item()
    print(f"[{tag}] prefill logits kernel vs plain path: max_abs_diff="
          f"{diff:.4e} (tol {LOGIT_TOL_BF16}; all rows "
          f"{row_diff.max().item():.4e}), logit std="
          f"{plain.std().item():.3f}, first-token agreement={agree:.3f}"
          f"{flips}", flush=True)
    check(diff <= LOGIT_TOL_BF16, "prefill logits: kernel path disagrees")
    breakdown = _serving_breakdown(params, prompt, cfg, prompt_len + new, tag)
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches[0], tokens_per_s=tokens_per_s,
                **breakdown)


def _device_kernels(prof):
    """The kernels of a torch.profiler trace: device events, less the
    ranges that annotate the device timeline (``Optimizer.step#...``)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _serving_breakdown(params, prompt, cfg, max_len, tag, steps=16):
    """Where a request's time goes: prefill against decode steps (host clock
    around work that ends in a synchronize), and the card's busy share over
    decode steps (torch.profiler's kernel intervals over the wall time).
    With experts, also the MoE layer's device time at the decode shape,
    timed alone (its routing, then its products) against a step's."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import decode_step, prefill
    from ray_tpu_torch.models.generate import _cast_params
    with torch.inference_mode():
        p16 = _cast_params(params, cfg.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(p16, prompt, cfg, max_len)
        token = logits.argmax(-1)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pos = prompt.shape[1]

        def run(n):
            nonlocal token, cache, pos
            for _ in range(n):
                logits, cache = decode_step(p16, token, pos, cache, cfg)
                token = logits.argmax(-1)
                pos += 1
            torch.cuda.synchronize()

        run(2)
        t0 = time.perf_counter()
        run(steps)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(steps)
            wall_us = (time.perf_counter() - t0) * 1e6
        moe = _moe_decode_ms(p16, prompt.shape[0], cfg) \
            if cfg.num_experts else None
    kernels = _device_kernels(prof)
    print(f"[{tag}] prefill (time to first token) {prefill_ms:.2f} ms "
          f"(batch {prompt.shape[0]} x {prompt.shape[1]}), decode "
          f"{step_ms:.3f} ms/step ({prompt.shape[0] / step_ms * 1e3:.1f} "
          f"tokens/s in steady decode)", flush=True)
    out = dict(prefill_ms=prefill_ms, decode_step_ms=step_ms)
    if not kernels:
        print(f"[{tag}] decode device busy share: not measured (the "
              f"profiler recorded no device events)", flush=True)
        return out
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out.update(busy_share=busy_us / wall_us, kernels_per_step=len(kernels)
               / steps, decode_device_ms=busy_us / steps / 1e3)
    print(f"[{tag}] decode device busy share {busy_us / wall_us:.3f} over "
          f"{steps} steps ({len(kernels) / steps:.0f} kernels/step, "
          f"{busy_us / steps / 1e3:.3f} ms device time/step)", flush=True)
    for name, us in top:
        print(f"[{tag}]   {us / steps / 1e3:.4f} ms/step  {name[:90]}")
    if moe is not None:
        step_dev = busy_us / steps / 1e3
        layer_ms, route_ms = moe
        out.update(moe_ms=layer_ms * cfg.n_layers,
                   moe_share=layer_ms * cfg.n_layers / step_dev,
                   moe_products_share=(layer_ms - route_ms) * cfg.n_layers
                   / step_dev)
        print(f"[{tag}] MoE layer at the decode shape, timed alone (device "
              f"time), x {cfg.n_layers} layers: {layer_ms * cfg.n_layers:.3f}"
              f" ms/step = {out['moe_share']:.3f} of a decode step's device "
              f"time; of which the routing {route_ms * cfg.n_layers:.3f} ms "
              f"and the dispatch, expert and combine einsums "
              f"{(layer_ms - route_ms) * cfg.n_layers:.3f} ms = "
              f"{out['moe_products_share']:.3f}", flush=True)
    return out


def _moe_decode_ms(p16, batch, cfg):
    """Device ms of one MoE layer (layer 0's cast weights) on a decode
    step's input [B, 1, D] under the inference config, and of its routing
    alone."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.models.generate import _inference_cfg
    icfg = _inference_cfg(cfg)
    layer = {k: v[0] for k, v in p16["layers"]["moe"].items()}
    h = torch.randn(batch, 1, cfg.d_model, device="cuda").to(cfg.dtype)
    layer_ms = device_ms(lambda: moe.moe_apply(icfg, layer, h))
    route_ms = device_ms(lambda: moe.route(icfg, layer["router"], h))
    return layer_ms or float("nan"), route_ms or float("nan")


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    return tree.cuda()


def phase_small_reference():
    """A small f32 model on the card (kernel) against the CPU (plain)."""
    from ray_tpu_torch.models import (TransformerConfig, prefill,
                                      transformer_init)
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=2, n_kv_heads=1, max_seq=256,
                            dtype=torch.float32)
    params = transformer_init(torch.Generator().manual_seed(1), cfg,
                              device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 200)))
    with torch.inference_mode():
        want, cache_cpu = prefill(params, prompt, cfg, 256, device="cpu")
        card = _to_card(params)
        got, cache = prefill(card, prompt, cfg, 256)
    diff = (got.cpu() - want).abs().max().item()
    kdiff = (cache["k"].cpu() - cache_cpu["k"]).abs().max().item()
    print(f"[reference] small f32 model (GQA 2:1, head_dim 128) card vs "
          f"CPU: logits max_abs_diff={diff:.3e}, cache k {kdiff:.3e} "
          f"(tol {LOGIT_TOL_F32})", flush=True)
    check(diff <= LOGIT_TOL_F32 and kdiff <= LOGIT_TOL_F32,
          "card disagrees with the CPU reference")


def phase_long_prefill():
    from ray_tpu_torch.models import transformer_init
    from ray_tpu_torch.ops import flash
    cfg = flagship_cfg()
    params = transformer_init(torch.Generator(device="cuda").manual_seed(2),
                              cfg)
    s = cfg.max_seq
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, s))).cuda()
    _prefill_logits(params, prompt, cfg, s)           # warm-up
    flash.launches = 0
    t0 = time.perf_counter()
    kernel = _prefill_logits(params, prompt, cfg, s)
    kernel_s = time.perf_counter() - t0
    check(flash.launches == cfg.n_layers,
          f"long prefill launched the kernel {flash.launches} times")
    plain_cfg = dataclasses.replace(cfg, attn_impl="reference")
    _prefill_logits(params, prompt, plain_cfg, s)
    t0 = time.perf_counter()
    plain = _prefill_logits(params, prompt, plain_cfg, s)
    plain_s = time.perf_counter() - t0
    check(torch.isfinite(kernel).all().item(), "non-finite logits")
    diff = (kernel - plain).abs().max().item()
    print(f"[prefill] batch 2 x {s}: kernel path {kernel_s * 1e3:.1f} ms, "
          f"plain path {plain_s * 1e3:.1f} ms, logits max_abs_diff="
          f"{diff:.4e} (tol {LOGIT_TOL_BF16})", flush=True)
    check(diff <= LOGIT_TOL_BF16, "long prefill: kernel path disagrees")


# ---------------------------------------------------------------------------
# phases 5, 6 and 8
# ---------------------------------------------------------------------------

def _launch_counts():
    from ray_tpu_torch.ops import flash
    return (flash.launches, flash.bwd_dkv_launches, flash.bwd_dq_launches,
            flash.bwd_delta_launches)


def _reset_launch_counts():
    from ray_tpu_torch.ops import flash
    flash.launches = flash.bwd_dkv_launches = flash.bwd_dq_launches = 0
    flash.bwd_delta_launches = 0


def _first_step(cfg, tokens, seed):
    """Loss and grad_norm of one training step from seeded weights, and the
    routing its forward recorded (empty without experts)."""
    from ray_tpu_torch.train import make_lm_train_step
    init_fn, step_fn, place = make_lm_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    with _recorded_routing() as routes:
        _, metrics = step_fn(state, place({"tokens": tokens}))
    return metrics["loss"].item(), metrics["grad_norm"].item(), routes


def _kernel_class(name):
    """Which part of a training step a kernel belongs to, by its name."""
    if "flash_" in name:
        return "flash"
    if "multi_tensor_apply" in name:     # AdamW's foreach updates
        return "adamw"
    if any(t in name.lower() for t in ("gemm", "sm90_", "xmma", "cutlass",
                                       "nvjet", "cublas")):
        return "products"
    return "elementwise"


def _profile_step(step_fn, state, data, tag):
    """One profiled training step: its kernels' device time by class (the
    flash kernels, AdamW, the cuBLAS products, and the element-wise and
    reduction kernels), against the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, data)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    if not kernels:
        print(f"[{tag}] device time breakdown: not measured (the profiler "
              f"recorded no device events)", flush=True)
        return state, None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    by_class = {}
    for n, us in by_name.items():
        by_class[_kernel_class(n)] = by_class.get(_kernel_class(n), 0.0) + us
    flash_us = {n: us for n, us in by_name.items() if "flash_" in n}
    bwd_us = sum(us for n, us in flash_us.items() if "flash_bwd" in n)
    print(f"[{tag}] profiled step: wall {wall_us / 1e3:.1f} ms, device "
          f"time {busy / 1e3:.1f} ms (busy share {busy / wall_us:.3f}, "
          f"{len(kernels)} kernels); " + ", ".join(
              f"{c} {by_class.get(c, 0.0) / 1e3:.2f} ms = "
              f"{by_class.get(c, 0.0) / busy:.4f}"
              for c in ("flash", "products", "adamw", "elementwise"))
          + f"; the flash backward (Δ, dK/dV, dQ) {bwd_us / 1e3:.2f} ms = "
          f"{bwd_us / busy:.4f}", flush=True)
    for n, us in sorted(flash_us.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   flash {us / 1e3:.3f} ms  {n[:90]}")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   top {us / 1e3:.3f} ms  {n[:90]}")
    return state, dict(
        wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
        busy_share=busy / wall_us, flash_ms=sum(flash_us.values()) / 1e3,
        flash_bwd_ms=bwd_us / 1e3, flash_bwd_share=bwd_us / busy,
        by_class_ms={c: us / 1e3 for c, us in by_class.items()})


def _moe_piece_ms(cfg, moe_params, b, s):
    """Milliseconds (CUDA events) of the MoE layer's pieces at one layer's
    training shape [B, S, D], timed alone: the forward, and the forward
    with its backward, of the routing (router product, softmax, top-k
    loop), the dispatch product, the expert products (SwiGLU) and the
    combine product. Under remat a step runs each piece's forward twice and
    its backward once per layer."""
    from ray_tpu_torch.models import moe
    dt = cfg.dtype
    gen = torch.Generator(device="cuda").manual_seed(9)
    leaf = {n: moe_params[n].detach().to(dt).requires_grad_()
            for n in ("router", "w1", "w3", "w2")}
    h = torch.randn(b, s, cfg.d_model, generator=gen,
                    device="cuda").to(dt).requires_grad_()
    with torch.no_grad():
        _, dispatch, combine = moe.route(cfg, leaf["router"], h)
        xs = torch.einsum("bsec,bsd->becd", dispatch.to(dt), h)
    xs.requires_grad_()
    ys = torch.randn_like(xs).requires_grad_()
    combine.requires_grad_()

    def experts():
        gate = torch.nn.functional.silu(
            torch.einsum("becd,edf->becf", xs, leaf["w1"]))
        up = torch.einsum("becd,edf->becf", xs, leaf["w3"])
        return torch.einsum("becf,efd->becd", gate * up, leaf["w2"])

    pieces = {
        "routing": (lambda: moe.route(cfg, leaf["router"], h)[2],
                    (leaf["router"], h)),
        "dispatch": (lambda: torch.einsum("bsec,bsd->becd", dispatch.to(dt),
                                          h), (h,)),
        "experts": (experts, (xs, leaf["w1"], leaf["w3"], leaf["w2"])),
        "combine": (lambda: torch.einsum("bsec,becd->bsd", combine.to(dt),
                                         ys), (combine, ys)),
    }
    out = {}
    for name, (fn, inputs) in pieces.items():
        with torch.no_grad():
            grad = torch.randn_like(fn())
        fwd = cuda_ms(lambda: fn(), iters=3, warmup=1)
        both = cuda_ms(lambda: torch.autograd.grad(fn(), inputs, grad),
                       iters=3, warmup=1)
        out[name] = (fwd, both)
        del grad
    return out


def phase_training(card, cfg, tag, seed):
    """Train at batch 8 x 2048 with remat: 2 warm-up steps counted step by
    step, the first held against the plain attention path, then 5 timed
    steps and one profiled step."""
    from ray_tpu_torch.models import transformer_num_params
    from ray_tpu_torch.train import make_lm_train_step
    batch, seq = 8, cfg.max_seq
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (batch, seq))
    n_params = transformer_num_params(cfg)
    L = cfg.n_layers
    per_step = (2 * L, L, L, L)   # forward + remat recompute, dK/dV, dQ, Δ

    plain = _first_step(dataclasses.replace(cfg, attn_impl="reference"),
                        tokens, seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    init_fn, step_fn, place = make_lm_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    data = place({"tokens": tokens})
    print(f"[{tag}] params={n_params} experts={cfg.num_experts} "
          f"top_k={cfg.expert_top_k} batch={batch} seq={seq} "
          f"remat={cfg.remat} attn_impl={cfg.attn_impl}", flush=True)
    losses, gnorms = [], []
    for i in range(2):                  # warm-up, counted step by step
        _reset_launch_counts()
        with _recorded_routing() as routes:
            state, metrics = step_fn(state, data)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        check(_launch_counts() == per_step,
              f"a training step launched {_launch_counts()}, want "
              f"{per_step} (forward, dK/dV, dQ, Δ)")
        if i == 0:
            first_routes = routes
    flips = ""
    if cfg.num_experts:
        # at bf16 a token whose top-k gates are within rounding of each
        # other may choose another expert on one path: expected noise
        f = _routing_flips(first_routes, plain[2], L)
        flips = (f", tokens whose top-{cfg.expert_top_k} differs between "
                 f"the paths {int(f.any(0).sum())} of {batch * seq} "
                 f"(token-layers {int(f.sum())} of {f.numel()}; by layer "
                 f"{f.sum((1, 2)).tolist()})")
    print(f"[{tag}] first step kernel path vs plain attention path: loss "
          f"{losses[0]:.6f} vs {plain[0]:.6f} (diff "
          f"{abs(losses[0] - plain[0]):.3e}, tol {TRAIN_LOSS_TOL}), "
          f"grad_norm {gnorms[0]:.6f} vs {plain[1]:.6f} (rel diff "
          f"{abs(gnorms[0] - plain[1]) / plain[1]:.3e}, tol "
          f"{TRAIN_GNORM_RTOL}){flips}", flush=True)
    check(abs(losses[0] - plain[0]) <= TRAIN_LOSS_TOL
          and abs(gnorms[0] - plain[1]) <= TRAIN_GNORM_RTOL * plain[1],
          f"first step: kernel path loss {losses[0]}, grad_norm "
          f"{gnorms[0]}; plain path {plain[:2]}")
    del plain, first_routes, routes

    steps = 5
    _reset_launch_counts()
    timed = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, data)
        timed.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    check(launches == tuple(steps * n for n in per_step),
          f"{steps} training steps launched {launches}")
    losses += [m["loss"].item() for m in timed]
    gnorms += [m["grad_norm"].item() for m in timed]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"non-finite metrics: loss {losses}, grad_norm {gnorms}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    step_ms = seconds / steps * 1e3
    tokens_per_s = batch * seq * steps / seconds
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mfu, mfu_text = None, "MFU not stated (6N counts every weight once)"
    if not cfg.num_experts:
        flops_per_token = 6 * n_params + 12 * L * cfg.d_model * seq
        mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
        mfu_text = (f"MFU {mfu:.4f} (6N + 12LdS = {flops_per_token:.4e} "
                    f"flop/token against 989 TFLOP/s)")
    print(f"[{tag}] losses {[round(x, 4) for x in losses]} grad_norms "
          f"{[round(x, 4) for x in gnorms]}", flush=True)
    print(f"[{tag}] {steps} timed steps: {step_ms:.1f} ms/step, "
          f"{tokens_per_s:.0f} tokens/s, {mfu_text}, peak memory "
          f"{peak_gb:.2f} GB, launches (fwd, dkv, dq, delta) {launches} on "
          f"{card}", flush=True)
    state, profile = _profile_step(step_fn, state, data, tag)
    pieces = None
    if cfg.num_experts:
        layer0 = {k: v[0].detach().clone()
                  for k, v in state.params["layers"]["moe"].items()}
        del state
        torch.cuda.empty_cache()
        raw = _moe_piece_ms(cfg, layer0, batch, seq)
        pieces = {name: L * (fwd + both) for name, (fwd, both) in raw.items()}
        print(f"[{tag}] MoE pieces timed alone at one layer's training "
              f"shape (CUDA events; forward, forward + backward ms): "
              + ", ".join(f"{n} {f:.3f}, {b:.3f}" for n, (f, b)
                          in raw.items())
              + f"; a step (x {L} layers, forward twice under remat): "
              + ", ".join(f"{n} {ms:.1f} ms = {ms / step_ms:.3f} of the "
                          f"step" for n, ms in pieces.items()), flush=True)
    else:
        del state
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, tokens_per_s=tokens_per_s,
                mfu=mfu, peak_gb=peak_gb, profile=profile, moe_pieces=pieces)


def _card_vs_cpu_step(make_step, cpu_params, batch):
    """One training step from the same f32 params on the CPU (the plain
    versions) and on the card (the kernels) -> (metric diffs, the largest
    difference of an updated parameter)."""
    card_params = _to_card(cpu_params)
    results = []
    for params, device in ((cpu_params, "cpu"), (card_params, None)):
        init_fn, step_fn, place = make_step(device)
        state, metrics = step_fn(init_fn(params), place(batch))
        results.append((state.params, metrics))
    (want, wm), (got, gm) = results
    diffs = {k: abs(gm[k].item() - wm[k].item())
             for k in wm if k != "step"}
    return diffs, _max_diff(got, want)


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _max_diff(card_tree, cpu_tree):
    """The largest difference of a leaf of ``card_tree`` from the same
    leaf of ``cpu_tree``."""
    cpu_leaves = dict(_named_leaves(cpu_tree))
    return max((v.detach().cpu() - cpu_leaves[k].detach()).abs().max()
               .item() for k, v in _named_leaves(card_tree))


def phase_small_training():
    """One f32 training step on the card (kernels) against the CPU (plain)."""
    from ray_tpu_torch.models import TransformerConfig, transformer_init
    from ray_tpu_torch.train import make_lm_train_step
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=2, n_kv_heads=1, max_seq=256,
                            dtype=torch.float32, attn_impl="flash")
    cpu_params = transformer_init(torch.Generator().manual_seed(4), cfg,
                                  device="cpu")
    batch = {"tokens": np.random.default_rng(4).integers(0, 512, (2, 200))}
    diffs, param_diff = _card_vs_cpu_step(
        lambda device: make_lm_train_step(cfg, device=device), cpu_params,
        batch)
    print(f"[reference] small f32 model (GQA 2:1, head_dim 128, S 200) one "
          f"training step card vs CPU: loss diff {diffs['loss']:.3e}, "
          f"grad_norm diff {diffs['grad_norm']:.3e}, updated params max "
          f"diff {param_diff:.3e} (tol {LOGIT_TOL_F32})", flush=True)
    check(max(*diffs.values(), param_diff) <= LOGIT_TOL_F32,
          "training step: card disagrees with the CPU reference")


# ---------------------------------------------------------------------------
# phases 9 and 10: ViT, and small f32 MoE and ViT models card vs CPU
# ---------------------------------------------------------------------------

def phase_vit_training(card):
    """ViTConfig()'s defaults (224² images, patch 16, d_model 384, 6 layers,
    6 heads of 64, 1000 classes, remat) at batch 128 on seeded random
    images and labels: 2 warm-up steps counted step by step, 5 timed."""
    from ray_tpu_torch.models import ViTConfig
    from ray_tpu_torch.train import make_vit_train_step
    from ray_tpu_torch.train.step import _leaves
    cfg = ViTConfig()
    batch, L = 128, cfg.n_layers
    per_step = (2 * L, L, L, L)
    gen = torch.Generator(device="cuda").manual_seed(11)
    data = {"image": torch.randn(batch, cfg.image_size, cfg.image_size, 3,
                                 generator=gen, device="cuda"),
            "label": torch.randint(0, cfg.num_classes, (batch,),
                                   generator=gen, device="cuda")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn, place = make_vit_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(12))
    n_params = sum(p.numel() for p in _leaves(state.params))
    data = place(data)
    print(f"[vit] params={n_params} image={cfg.image_size} patch="
          f"{cfg.patch_size} seq={cfg.seq_len} d_model={cfg.d_model} "
          f"layers={L} heads={cfg.n_heads} batch={batch} remat={cfg.remat}",
          flush=True)
    losses = []
    for _ in range(2):
        _reset_launch_counts()
        state, metrics = step_fn(state, data)
        losses.append(metrics["loss"].item())
        check(_launch_counts() == per_step,
              f"a ViT step launched {_launch_counts()}, want {per_step}")
    steps = 5
    _reset_launch_counts()
    timed = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, data)
        timed.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    check(launches == tuple(steps * n for n in per_step),
          f"{steps} ViT steps launched {launches}")
    losses += [m["loss"].item() for m in timed]
    accs = [m["accuracy"].item() for m in timed]
    check(all(np.isfinite(losses)), f"non-finite ViT loss {losses}")
    check(losses[-1] < losses[0], f"the ViT loss did not fall: {losses}")
    step_ms = seconds / steps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[vit] losses {[round(x, 4) for x in losses]} accuracy "
          f"{[round(x, 4) for x in accs]}", flush=True)
    print(f"[vit] {steps} timed steps: {step_ms:.2f} ms/step, "
          f"{batch * steps / seconds:.0f} images/s, peak memory "
          f"{peak_gb:.3f} GB, launches (fwd, dkv, dq, delta) {launches} on "
          f"{card}", flush=True)
    state, profile = _profile_step(step_fn, state, data, "vit")
    del state
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms,
                images_per_s=batch * steps / seconds, peak_gb=peak_gb,
                profile=profile)


def phase_small_moe_and_vit():
    """A small f32 MoE LM and a small ViT (head_dim 64, 17 tokens, not
    causal) on the card (the kernels) against the CPU (the plain versions):
    logits, then one training step."""
    from ray_tpu_torch.models import (TransformerConfig, ViTConfig, prefill,
                                      transformer_init, vit_apply, vit_init)
    from ray_tpu_torch.train import make_lm_train_step, make_vit_train_step
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=2, n_kv_heads=1, max_seq=256,
                            dtype=torch.float32, attn_impl="flash",
                            num_experts=4, expert_top_k=2)
    cpu_params = transformer_init(torch.Generator().manual_seed(13), cfg,
                                  device="cpu")
    rng = np.random.default_rng(13)
    prompt = torch.from_numpy(rng.integers(0, 512, (2, 200)))
    with torch.inference_mode():
        want, _ = prefill(cpu_params, prompt, cfg, 256, device="cpu")
        got, _ = prefill(_to_card(cpu_params), prompt, cfg, 256)
    logit_diff = (got.cpu() - want).abs().max().item()
    diffs, param_diff = _card_vs_cpu_step(
        lambda device: make_lm_train_step(cfg, device=device), cpu_params,
        {"tokens": rng.integers(0, 512, (2, 200))})
    print(f"[reference] small f32 MoE model (4 experts, top-2, GQA 2:1, "
          f"head_dim 128) card vs CPU: prefill logits max_abs_diff="
          f"{logit_diff:.3e}; one training step (capacity factor 1.25) loss "
          f"diff {diffs['loss']:.3e}, grad_norm diff "
          f"{diffs['grad_norm']:.3e}, updated params max diff "
          f"{param_diff:.3e} (tol {LOGIT_TOL_F32})", flush=True)
    check(max(logit_diff, *diffs.values(), param_diff) <= LOGIT_TOL_F32,
          "small MoE model: card disagrees with the CPU reference")

    vcfg = ViTConfig(image_size=64, patch_size=16, num_classes=10,
                     d_model=128, n_layers=2, n_heads=2, dtype=torch.float32)
    cpu_params = vit_init(torch.Generator().manual_seed(14), vcfg,
                          device="cpu")
    images = torch.from_numpy(rng.standard_normal((4, 64, 64, 3))
                              .astype(np.float32))
    with torch.inference_mode():
        want = vit_apply(cpu_params, images, vcfg, device="cpu")
        got = vit_apply(_to_card(cpu_params), images, vcfg)
    logit_diff = (got.cpu() - want).abs().max().item()
    diffs, param_diff = _card_vs_cpu_step(
        lambda device: make_vit_train_step(vcfg, device=device), cpu_params,
        {"image": images.numpy(), "label": rng.integers(0, 10, (4,))})
    print(f"[reference] small f32 ViT (head_dim 64, 17 tokens, not causal) "
          f"card vs CPU: logits max_abs_diff={logit_diff:.3e}; one training "
          f"step loss diff {diffs['loss']:.3e}, accuracy diff "
          f"{diffs['accuracy']:.3e}, updated params max diff "
          f"{param_diff:.3e} (tol {LOGIT_TOL_F32})", flush=True)
    check(max(logit_diff, *diffs.values(), param_diff) <= LOGIT_TOL_F32,
          "small ViT: card disagrees with the CPU reference")


# ---------------------------------------------------------------------------
# phases 11 and 12: ResNet-50
# ---------------------------------------------------------------------------

def resnet_train_flops(model, image_size, batch):
    """Tensor-core operations of one training step: 2 per multiply-add of
    every convolution and the Dense head, forward, weight gradient and input
    gradient (none for the first convolution: the images need none)."""
    size = (image_size + 2 * 3 - 7) // 2 + 1          # conv_init, 7x7/2
    stem = size * size * 64 * 3 * 49
    size = -(-size // 2)                              # max pool, SAME /2
    macs = 0
    for _, block, c_in in model.blocks():
        f, out = block.filters, -(-size // block.strides)
        macs += size * size * f * c_in + out * out * (f * f * 9 + 4 * f * f)
        if block.strides != 1 or c_in != 4 * f:
            macs += out * out * 4 * f * c_in
        size = out
    macs += math.prod(model.variable_shapes()["params"]["Dense_0"]["kernel"])
    return 2 * batch * (3 * macs + 2 * stem)


def _resnet_kernel_class(name):
    """Which part of a ResNet step a kernel belongs to, by its name."""
    low = name.lower()
    if "multi_tensor_apply" in low:          # SGD's foreach updates
        return "sgd"
    if "batch_norm" in low or "batchnorm" in low or "bn_" in low:
        return "batchnorm"
    if any(t in low for t in ("conv", "xmma", "implicit_gemm", "fprop",
                              "dgrad", "wgrad", "gemm", "sm90_", "cutlass",
                              "nvjet", "cudnn")):
        return "convolution"
    if "elementwise" in low or "threshold" in low or "clamp" in low:
        return "elementwise"
    return "other"


RESNET_CLASSES = ("convolution", "batchnorm", "elementwise", "sgd", "other")


def _profile_resnet_step(step_fn, state, data):
    """One profiled ResNet step: device time by kernel class against the
    wall time, and the largest kernels by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, data)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    if not kernels:
        print("[resnet] device time breakdown: not measured (the profiler "
              "recorded no device events)", flush=True)
        return state, None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    by_class = {}
    for n, us in by_name.items():
        c = _resnet_kernel_class(n)
        by_class[c] = by_class.get(c, 0.0) + us
    print(f"[resnet] profiled step: wall {wall_us / 1e3:.1f} ms, device "
          f"time {busy / 1e3:.1f} ms (busy share {busy / wall_us:.3f}, "
          f"{len(kernels)} kernels); " + ", ".join(
              f"{c} {by_class.get(c, 0.0) / 1e3:.2f} ms = "
              f"{by_class.get(c, 0.0) / busy:.4f}" for c in RESNET_CLASSES),
          flush=True)
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[resnet]   top {us / 1e3:.3f} ms  "
              f"({_resnet_kernel_class(n)}) {n[:90]}")
    return state, dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
                       busy_share=busy / wall_us, kernels=len(kernels),
                       by_class_ms={c: us / 1e3
                                    for c, us in by_class.items()})


def phase_resnet_training(card):
    """bench.py's bench_resnet point on one card: ResNet-50, 1000 classes,
    224² images, batch 256, SGD lr 0.1 with Nesterov momentum 0.9; 3
    warm-up steps, then the best of two windows of 30 steps, each ending in
    a synchronize."""
    from ray_tpu_torch.models import resnet50, resnet50_apply
    from ray_tpu_torch.train import make_resnet_train_step
    from ray_tpu_torch.train.step import _leaves
    batch, size, steps = 256, 224, 30
    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    print(f"[resnet] torch.backends.cudnn.benchmark=True for this phase "
          f"(cuDNN times its algorithms at each new convolution shape and "
          f"keeps the fastest); back to {prior} after it", flush=True)
    try:
        model = resnet50()
        rng = np.random.default_rng(0)       # bench_resnet's data
        host = {"image": rng.normal(size=(batch, size, size, 3))
                .astype(np.float32),
                "label": rng.integers(0, 1000, (batch,))}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init_fn, step_fn, place = make_resnet_train_step(
            num_classes=1000, image_size=size, learning_rate=0.1)
        state = init_fn(torch.Generator(device="cuda").manual_seed(0))
        stats0 = [t.clone() for t in _leaves(state.params["batch_stats"])]
        n_params = sum(t.numel() for t in _leaves(state.params["params"]))
        data = place(host)
        del host
        print(f"[resnet] params={n_params} batch_stats="
              f"{sum(t.numel() for t in stats0)} batch={batch} image={size} "
              f"dtype=bfloat16 channels_last", flush=True)
        metrics = []
        t0 = time.perf_counter()
        for _ in range(3):                   # warm-up (and cuDNN's search)
            state, m = step_fn(state, data)
            metrics.append(m)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        _reset_launch_counts()
        windows = []
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(steps):
                state, m = step_fn(state, data)
                metrics.append(m)
            torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
        launches = _launch_counts()
        check(launches == (0, 0, 0, 0),
              f"the ResNet step launched flash kernels {launches}")
        losses = [m["loss"].item() for m in metrics]
        accs = [m["accuracy"].item() for m in metrics]
        check(all(np.isfinite(losses)) and all(np.isfinite(accs)),
              f"non-finite ResNet metrics: loss {losses}, accuracy {accs}")
        check(losses[-1] < losses[0], f"the ResNet loss did not fall: "
                                      f"{losses}")
        best = min(windows)
        step_ms = best / steps * 1e3
        images_per_s = steps * batch / best
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        flops = resnet_train_flops(model, size, batch)
        bound_ms = flops / PEAK_BF16_FLOPS * 1e3
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(stats0, _leaves(state.params["batch_stats"])))
        check(moved == len(stats0) and all(
            torch.isfinite(t).all().item()
            for t in _leaves(state.params["batch_stats"])),
            f"{len(stats0) - moved} of {len(stats0)} batch statistics did "
            f"not move, or are not finite")
        with torch.inference_mode():
            logits = resnet50_apply(model, state.params, data["image"],
                                    train=False)
        check(logits.shape == (batch, 1000) and logits.dtype == torch.float32
              and torch.isfinite(logits).all().item(),
              "eval-mode logits are not finite [256, 1000] f32")
        print(f"[resnet] losses {[round(x, 4) for x in losses[:3]]} (warm-up)"
              f" ... {[round(x, 4) for x in losses[3::10]]} (every 10th "
              f"timed) ... {round(losses[-1], 4)} (last); accuracy "
              f"{round(accs[0], 4)} -> {round(accs[-1], 4)}; all finite; "
              f"{moved} of {len(stats0)} batch statistics moved from their "
              f"init; eval-mode logits finite, std "
              f"{logits.std().item():.4f}", flush=True)
        print(f"[resnet] warm-up 3 steps {warmup_s:.2f} s; windows of "
              f"{steps} steps {[round(w, 4) for w in windows]} s; best "
              f"{step_ms:.2f} ms/step, {images_per_s:.1f} images/s, peak "
              f"memory {peak_gb:.2f} GB; convolutions and head "
              f"{flops / 1e12:.3f} TFLOP a step, tensor-core bound "
              f"{bound_ms:.2f} ms at 989 TFLOP/s = {bound_ms / step_ms:.3f} "
              f"of the step; flash launches {launches} on {card}",
              flush=True)
        state, profile = _profile_resnet_step(step_fn, state, data)
        if profile is not None:
            profile["device_over_timed_step"] = profile["device_ms"] / step_ms
            print(f"[resnet] the profiled step's device time over the timed "
                  f"step: {profile['device_over_timed_step']:.3f} (the "
                  f"profiler's own cost is in its wall time)", flush=True)
        del state, data, logits
    finally:
        torch.backends.cudnn.benchmark = prior
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms,
                images_per_s=images_per_s, peak_gb=peak_gb,
                windows_s=windows, flops=flops, bound_ms=bound_ms,
                losses=[losses[0], losses[-1]], profile=profile)


@contextlib.contextmanager
def _tf32_off():
    """f32 convolutions and products in full f32 for the block (the
    library flips no global switch; this script does, for its own check)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _perturbed(variables, gen):
    """``variables`` with every BatchNorm scale and running variance in
    [0.5, 1.5) and every bias and running mean normal(0.1), from ``gen``:
    the init zeroes each block's last scale, which would hide its branch."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else 0.5 + torch.rand(v.shape, generator=gen)
                if k in ("scale", "var")
                else 0.1 * torch.randn(v.shape, generator=gen)
                if k in ("bias", "mean") else v
                for k, v in tree.items()}
    return walk(variables)


def phase_small_resnet():
    """A small f32 ResNet on the card (cuDNN, TF32 off) against the CPU:
    logits in train and eval mode, then one training step."""
    from ray_tpu_torch.models import ResNet, resnet50_apply
    from ray_tpu_torch.train import make_resnet_train_step
    model = ResNet((1, 1, 1, 1), 10, torch.float32)
    gen = torch.Generator().manual_seed(16)
    cpu_vars = _perturbed(model.init(gen, device="cpu"), gen)
    rng = np.random.default_rng(16)
    images = torch.from_numpy(rng.standard_normal((4, 32, 32, 3))
                              .astype(np.float32))
    with _tf32_off():
        print("[reference] small ResNet: cudnn.allow_tf32 and "
              "cuda.matmul.allow_tf32 False for this check", flush=True)
        diffs = {}
        with torch.inference_mode():
            card_vars = _to_card(cpu_vars)
            for train in (True, False):
                want = resnet50_apply(model, cpu_vars, images, train=train,
                                      device="cpu")
                got = resnet50_apply(model, card_vars, images, train=train)
                if train:
                    (want, want_stats), (got, got_stats) = want, got
                    diffs["batch_stats"] = _max_diff(got_stats, want_stats)
                diffs[f"logits_{'train' if train else 'eval'}"] = (
                    got.cpu() - want).abs().max().item()
        step_diffs, param_diff = _card_vs_cpu_step(
            lambda device: make_resnet_train_step(
                num_classes=10, image_size=32, dtype=torch.float32,
                stage_sizes=(1, 1, 1, 1), device=device), cpu_vars,
            {"image": images.numpy(), "label": rng.integers(0, 10, (4,))})
    print(f"[reference] small f32 ResNet (stages 1, 1, 1, 1; 32² images, "
          f"batch 4, 10 classes) card vs CPU: logits train "
          f"{diffs['logits_train']:.3e}, eval {diffs['logits_eval']:.3e}, "
          f"new batch statistics {diffs['batch_stats']:.3e}; one training "
          f"step loss diff {step_diffs['loss']:.3e}, accuracy diff "
          f"{step_diffs['accuracy']:.3e}, updated params and batch "
          f"statistics max diff {param_diff:.3e} (tol {LOGIT_TOL_F32})",
          flush=True)
    check(max(*diffs.values(), *step_diffs.values(), param_diff)
          <= LOGIT_TOL_F32, "small ResNet: card disagrees with the CPU")
    return dict(diffs, step_loss=step_diffs["loss"], step_params=param_diff)


# ---------------------------------------------------------------------------
# phases 13, 14 and 15: the RL stack (ray_tpu_torch.rl)
# ---------------------------------------------------------------------------

# The JAX package's PPO learning gate (tests/test_rl.py): 2 rollout workers x
# 16 CartPole envs x 64 steps, hiddens (64, 64), lr 3e-4, 8 SGD epochs of
# minibatch 256, entropy 0.01, clip 0.2, grad clip 0.5, seed 0; best mean
# reward >= 120 within 25 iterations. Workers seeded as WorkerSet seeds them.
PPO_SPEC = {"obs_dim": 4, "num_actions": 2, "hiddens": (64, 64)}
PPO_GATE, PPO_ITERS = 120.0, 25
# Small f32 RL models, card (TF32 off) against the CPU: the same products
# summed in another order, through at most 16 recurrent steps and 2 Adam
# steps.
RL_TOL_F32 = 1e-4


def _rl_profile(fn, sgd_steps, tag):
    """Device time, busy share and kernels a SGD step of ``fn`` (one
    learner update) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    if not kernels:
        print(f"[{tag}] busy share: not measured (the profiler recorded no "
              f"device events)", flush=True)
        return None
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
               busy_share=busy / wall_us, kernels=len(kernels),
               kernels_per_sgd_step=len(kernels) / sgd_steps)
    print(f"[{tag}] profiled update: wall {out['wall_ms']:.2f} ms, device "
          f"time {out['device_ms']:.2f} ms, busy share "
          f"{out['busy_share']:.4f}, {len(kernels)} kernels = "
          f"{out['kernels_per_sgd_step']:.1f} a SGD step; largest: " +
          "; ".join(f"{n[:60]} {us / 1e3:.2f} ms" for n, us in top),
          flush=True)
    return out


def _ppo_cartpole(worker_device, tag):
    """PPO.training_step's order with the workers in-process: sample on
    every worker, concat, PPOLearner.update on the card, get_weights back to
    the workers; PPO_ITERS iterations, each timed on the host clock (the
    learner's stats are floats, so an update ends in a sync)."""
    from ray_tpu_torch.rl import PPOLearner, RolloutWorker, SampleBatch
    learner = PPOLearner(PPO_SPEC, lr=3e-4, clip_param=0.2, grad_clip=0.5,
                         num_sgd_iter=8, sgd_minibatch_size=256,
                         entropy_coeff=0.01, seed=0)
    workers = [RolloutWorker("CartPole-v1", PPO_SPEC, 64, 16, 0.99, 0.95,
                             seed=1000 * (i + 1), device=worker_device)
               for i in range(2)]
    weights, rewards, sample_s, update_s, steps = \
        learner.get_weights(), [], [], [], 0
    _reset_launch_counts()
    for _ in range(PPO_ITERS):
        t0 = time.perf_counter()
        batch = SampleBatch.concat_samples([w.sample(weights)
                                            for w in workers])
        t1 = time.perf_counter()
        stats = learner.update(batch)
        weights = learner.get_weights()
        t2 = time.perf_counter()
        sample_s.append(t1 - t0)
        update_s.append(t2 - t1)
        steps += batch.count
        check(all(np.isfinite(v) for v in stats.values()),
              f"[{tag}] non-finite learner stats {stats}")
        means = [s["episode_reward_mean"] for s in
                 (w.episode_stats() for w in workers) if s["episodes"] > 0]
        rewards.append(float(np.mean(means)) if means else float("nan"))
    launches = _launch_counts()
    best = max((r for r in rewards if not np.isnan(r)), default=0.0)
    first = next((i + 1 for i, r in enumerate(rewards) if r >= PPO_GATE),
                 None)
    total = sum(sample_s) + sum(update_s)
    sgd_steps = 8 * (batch.count // 256)
    out = dict(launches=launches, worker_device=worker_device or "cuda",
               learner_device="cuda", iterations=PPO_ITERS, env_steps=steps,
               env_steps_per_s=steps / total,
               sample_env_steps_per_s=steps / sum(sample_s),
               sample_ms=1e3 * float(np.median(sample_s)),
               update_ms=1e3 * float(np.median(update_s)),
               sgd_steps_per_s=sgd_steps / float(np.median(update_s)),
               best_reward=best, gate_iteration=first,
               rewards=[round(r, 2) for r in rewards])
    print(f"[{tag}] workers on {out['worker_device']}, learner on the card: "
          f"{PPO_ITERS} iterations, {steps} env steps in {total:.2f} s = "
          f"{out['env_steps_per_s']:.1f} env steps/s (sampling alone "
          f"{out['sample_env_steps_per_s']:.1f}); median iteration: sample "
          f"{out['sample_ms']:.1f} ms, update {out['update_ms']:.1f} ms "
          f"({sgd_steps} SGD steps = {out['sgd_steps_per_s']:.1f} SGD "
          f"steps/s); mean reward by iteration {out['rewards']}; best "
          f"{best:.2f} (gate {PPO_GATE}, first reached at iteration "
          f"{first}); flash launches {launches}", flush=True)
    check(launches == (0, 0, 0, 0),
          f"[{tag}] PPO launched flash kernels {launches}")
    check(best >= PPO_GATE, f"[{tag}] PPO failed to learn CartPole within "
                            f"{PPO_ITERS} iterations: {rewards}")
    return out, learner, batch, sgd_steps


def phase_ppo_cartpole(card):
    """PPO on CartPole at the JAX package's learning-gate setting, first
    with the rollout workers on the card, then on the CPU (as the JAX
    cluster places its rollout actors) with the learner on the card."""
    run, learner, batch, sgd_steps = _ppo_cartpole(None, "ppo")
    run["profile"] = _rl_profile(lambda: learner.update(batch), sgd_steps,
                                 "ppo")
    cpu, _, _, _ = _ppo_cartpole("cpu", "ppo-cpu-workers")
    print(f"[ppo] env steps/s: workers on the card "
          f"{run['env_steps_per_s']:.1f}, workers on the CPU "
          f"{cpu['env_steps_per_s']:.1f} (learner on the card in both) on "
          f"{card}", flush=True)
    return run, cpu


def _atari_batch(count, obs_dim, seed):
    """A seeded train batch of synthetic frames (pixel values k / 255)."""
    from ray_tpu_torch.rl import SampleBatch
    from ray_tpu_torch.rl import sample_batch as sb
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (count, obs_dim), dtype=np.uint8)
    obs = obs.astype(np.float32) / np.float32(255)
    f32 = lambda x: x.astype(np.float32)
    vf = f32(rng.standard_normal(count))
    return SampleBatch({
        sb.OBS: obs, sb.ACTIONS: f32(rng.integers(0, 4, count)),
        sb.ACTION_LOGP: f32(np.log(0.25) + 0.1 *
                            rng.standard_normal(count)),
        sb.ADVANTAGES: f32(rng.standard_normal(count)),
        sb.VF_PREDS: vf, sb.VALUE_TARGETS: vf + f32(
            rng.standard_normal(count)),
    })


def phase_ppo_atari_learner(card):
    """The CNN learner at Atari frame size: ConvRLModule on 84x84x4 frames
    (filters (16, 3, 2), (32, 3, 2); hiddens (128,); 4 actions), one
    PPOLearner.update of a seeded 5,000-frame batch at minibatch 500 for 10
    epochs, clip 0.1, entropy 0.01 (RLlib's atari-ppo batch, minibatch and
    epochs). f32 with TF32 off (phase 1's setting). A first update warms
    up; the second is timed, the third profiled."""
    from ray_tpu_torch.rl import PPOLearner
    count, mb, epochs = 5000, 500, 10
    spec = {"encoder": "cnn", "obs_dim": 84 * 84 * 4, "num_actions": 4,
            "obs_shape": (84, 84, 4)}
    t0 = time.perf_counter()
    batch = _atari_batch(count, spec["obs_dim"], 14)
    make_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    learner = PPOLearner(spec, clip_param=0.1, entropy_coeff=0.01,
                         num_sgd_iter=epochs, sgd_minibatch_size=mb, seed=0)
    n_params = sum(p.numel() for p in learner._leaves)
    _reset_launch_counts()
    times, stats = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        stats.append(learner.update(batch))
        times.append(time.perf_counter() - t0)
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sgd_steps = epochs * (count // mb)
    check(all(np.isfinite(v) for s in stats for v in s.values()),
          f"[ppo-atari] non-finite learner stats {stats}")
    check(launches == (0, 0, 0, 0),
          f"[ppo-atari] the learner launched flash kernels {launches}")
    update_ms = times[1] * 1e3
    out = dict(launches=launches, params=n_params, batch=count,
               minibatch=mb, epochs=epochs, batch_bytes=batch["obs"].nbytes,
               update_ms=update_ms, first_update_ms=times[0] * 1e3,
               samples_per_s=count / times[1],
               sample_passes_per_s=count * epochs / times[1],
               sgd_steps_per_s=sgd_steps / times[1], peak_gb=peak_gb,
               total_loss=stats[1]["total_loss"], stats=stats[1])
    print(f"[ppo-atari] ConvRLModule 84x84x4, {n_params} params; batch "
          f"{count} frames ({batch['obs'].nbytes / 1e6:.1f} MB of f32 obs, "
          f"made in {make_s:.2f} s on the host), minibatch {mb}, {epochs} "
          f"epochs = {sgd_steps} SGD steps: update {update_ms:.1f} ms "
          f"(first {times[0] * 1e3:.1f} ms), {out['samples_per_s']:.1f} "
          f"train-batch samples/s ({out['sample_passes_per_s']:.1f} "
          f"sample passes/s, {out['sgd_steps_per_s']:.1f} SGD steps/s), "
          f"peak memory "
          f"{peak_gb:.3f} GB; stats {stats[1]}; flash launches {launches} "
          f"on {card}", flush=True)
    out["profile"] = _rl_profile(lambda: learner.update(batch), sgd_steps,
                                 "ppo-atari")
    del learner, batch
    torch.cuda.empty_cache()
    return out


RL_SMALL = {
    "mlp": {"obs_dim": 8, "num_actions": 4, "hiddens": (64, 64)},
    "cnn": {"encoder": "cnn", "obs_dim": 42 * 42 * 4, "num_actions": 4,
            "obs_shape": (42, 42, 4)},
    "lstm": {"encoder": "lstm", "obs_dim": 8, "num_actions": 4,
             "hidden_size": 64},
    "gtrxl": {"encoder": "gtrxl", "obs_dim": 8, "num_actions": 4,
              "hidden_size": 64, "num_layers": 2, "num_heads": 4,
              "memory_len": 8},
}


def _rl_card_vs_cpu(name, spec):
    """One small f32 module on the card and on the CPU from the same
    weights -> {check: largest difference}. Flat encoders: logits and
    values, logp_entropy on fixed actions, then one PPOLearner.update (2 SGD
    steps) from the same weights and seed. Sequence encoders (the JAX
    package has no logp_entropy for them, so no PPO learner): apply_seq with
    dones (logits, values, final state), the distribution's logp and
    entropy of fixed actions over those logits, and the gradients of a loss
    over them."""
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.models.convert import rl_params_to_numpy
    from ray_tpu_torch.rl import PPOLearner, SampleBatch, make_module
    from ray_tpu_torch.rl import sample_batch as sb
    from ray_tpu_torch.rl.learner import _named_leaves
    from ray_tpu_torch.rl.rollout import place_params

    def leaves(tree):
        return list(_named_leaves(tree).values())
    module = make_module(spec)
    rng = np.random.default_rng(15)
    cpu = module.init(torch.Generator().manual_seed(15), device="cpu")
    card = place_params(cpu, module, resolve_device(None))
    results = []
    if name in ("mlp", "cnn"):
        B = 64
        obs = rng.standard_normal((B, spec["obs_dim"])).astype(np.float32)
        actions = rng.integers(0, 4, B).astype(np.float32)
        batch = SampleBatch({
            sb.OBS: obs, sb.ACTIONS: actions,
            sb.ACTION_LOGP: (np.log(0.25) + 0.3 * rng.standard_normal(B))
            .astype(np.float32),
            sb.ADVANTAGES: rng.standard_normal(B).astype(np.float32),
            sb.VF_PREDS: rng.standard_normal(B).astype(np.float32),
            sb.VALUE_TARGETS: rng.standard_normal(B).astype(np.float32)})
        for params, dev in ((cpu, "cpu"), (card, None)):
            with torch.no_grad():
                out = {"logits_values": module.apply(params, obs),
                       "logp_entropy": module.logp_entropy(params, obs,
                                                           actions)}
            learner = PPOLearner(spec, num_sgd_iter=1, sgd_minibatch_size=32,
                                 seed=15, device=dev)
            learner.set_weights(rl_params_to_numpy(cpu))
            stats = learner.update(batch)
            out["update_stats"] = [torch.tensor(stats[k])
                                   for k in sorted(stats)]
            out["update_params"] = learner.params
            results.append(out)
    else:
        T, B = 16, 8
        obs = rng.standard_normal((T, B, spec["obs_dim"])).astype(np.float32)
        dones = (rng.random((T, B)) < 0.2).astype(np.float32)
        actions = rng.integers(0, 4, (T, B))
        for params, dev in ((cpu, "cpu"), (card, None)):
            trainable = leaves(params)
            for t in trainable:
                t.requires_grad_(True)
            logits, values, final = module.apply_seq(
                params, obs, module.initial_state(B, device=dev), dones)
            logp, ent = module.dist_logp_entropy(logits, actions)
            loss = -logp.mean() + values.square().mean() - 0.01 * ent.mean()
            results.append({"logits_values_state": (logits, values, final),
                            "logp_entropy": (logp, ent),
                            "grads": torch.autograd.grad(loss, trainable)})
    want, got = results
    diffs = {}
    for k in want:
        g, w = leaves(got[k]), leaves(want[k])
        check(len(g) == len(w), f"{name} {k}: the trees differ")
        diffs[k] = max((a.detach().cpu() - b.detach()).abs().max().item()
                       for a, b in zip(g, w))
    return diffs


def phase_small_rl():
    """Small f32 RL modules (MLP, CNN, LSTM and GTrXL with dones) on the
    card, TF32 off, against the CPU."""
    out = {}
    with _tf32_off():
        for name, spec in RL_SMALL.items():
            out[name] = _rl_card_vs_cpu(name, spec)
            print(f"[reference] small f32 {name} card vs CPU: " + ", ".join(
                f"{k} {v:.3e}" for k, v in out[name].items())
                + f" (tol {RL_TOL_F32})", flush=True)
    check(max(v for d in out.values() for v in d.values()) <= RL_TOL_F32,
          "small RL modules: card disagrees with the CPU")
    return out


def _paths(runs, part):
    """Launches of one kernel (index ``part`` of the counts) by path."""
    return {path: (r["launches"][part] if isinstance(r["launches"], tuple)
                   else (r["launches"] if part == 0 else 0))
            for path, r in runs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    card, build = phase_card_and_build()
    results = phase_kernel_checks()
    bwd = phase_backward_checks()
    runs = {"serve": phase_serving(card, flagship_cfg(), "serve", 0)}
    phase_small_reference()
    phase_long_prefill()
    runs["train"] = phase_training(card, flagship_cfg(remat=True), "train", 3)
    phase_small_training()
    runs["moe_serve"] = phase_serving(card, moe_cfg(), "moe-serve", 10)
    runs["moe_train"] = phase_training(card, moe_cfg(remat=True),
                                       "moe-train", 15)
    runs["vit_train"] = phase_vit_training(card)
    phase_small_moe_and_vit()
    runs["resnet_train"] = phase_resnet_training(card)
    runs["resnet_train"]["small_f32_vs_cpu"] = phase_small_resnet()
    runs["ppo_cartpole"], runs["ppo_cartpole_cpu_workers"] = \
        phase_ppo_cartpole(card)
    runs["ppo_atari_learner"] = phase_ppo_atari_learner(card)
    runs["ppo_cartpole"]["small_f32_vs_cpu"] = phase_small_rl()
    fwd_main = results[("serve_prefill", "bf16")]

    def at(result, keys):
        return {k: result[k] for k in keys}

    fwd_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "shape")
    fwd_launches = _paths(runs, 0)
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash.py:45",
        "launches": sum(fwd_launches.values()),
        "launches_by_path": fwd_launches,
        "max_abs_err": fwd_main["max_abs_err"],
        "tol": TOL[torch.bfloat16]["out"],
        "cases_passed": len(results),
        **at(fwd_main, fwd_keys),
        "train_shape": at(results[("max_seq_causal", "bf16")], fwd_keys),
        "vit_shape": at(results[("vit_train", "bf16")], fwd_keys),
        "build": build,
        "dtype": "bfloat16",
        "card": card,
    }]
    bwd_main = bwd[("train_causal", "bf16")]
    source = "ray_tpu_torch/ops/csrc/flash_bwd.cu"
    for name, replaces, part, index, errs in (
            ("flash_bwd_dkv", "ray_tpu/ops/flash.py:134", "dkv", 1,
             slice(1, 3)),
            ("flash_bwd_dq", "ray_tpu/ops/flash.py:176", "dq", 2,
             slice(0, 1)),
            ("flash_bwd_delta", "ray_tpu/ops/flash.py:219", "delta", 3,
             None)):
        ms, dev_ms = bwd_main["times"][part]
        launched = _paths(runs, index)

        def other(case):
            r = bwd[(case, "bf16")]
            plain = {"plain_ms": r["delta_plain_ms"], "library_ms": None} \
                if errs is None else {"plain_ms": r["plain_ms"],
                                      "library_ms": r["library_ms"]}
            return {"ms": r["times"][part][0],
                    "device_ms": r["times"][part][1],
                    "bound_ms": r["bounds"][part][0],
                    "bound_by": r["bounds"][part][1],
                    "wrapper_ms": r["times"]["wrapper"][0],
                    "shape": r["shape"], **plain}

        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(launched.values()),
            "launches_by_path": launched,
            "cases_passed": len(bwd),
            "ms": ms,
            "device_ms": dev_ms,
            "bound_ms": bwd_main["bounds"][part][0],
            "bound_by": bwd_main["bounds"][part][1],
            "share_of_bound": _share(bwd_main["bounds"][part][0],
                                     bwd_main["times"][part]),
            "full_shape": other("full"),
            "vit_shape": other("vit_train"),
            "shape": bwd_main["shape"],
            "dtype": "bfloat16",
            "card": card,
        }
        if errs is None:
            row.update({
                "replaces_what": "XLA's reduction for Delta in _flash_bwd",
                "max_abs_err": bwd_main["delta_abs"],
                "max_rel_err": bwd_main["delta_err"],
                "tol": 1e-5,
                "tol_on": "max_rel_err, relative to Delta's max magnitude",
                "plain_ms": bwd_main["delta_plain_ms"],
                "library_ms": None,
            })
        else:
            row.update({
                "max_abs_err": max(bwd_main["abs"][errs]),
                "max_rel_err": max(bwd_main["rel"][errs]),
                "tol": BWD_TOL[torch.bfloat16],
                "tol_on": "max_rel_err, relative to the gradient's max "
                          "magnitude",
                "plain_ms": bwd_main["plain_ms"],
                "plain_computes": "dq, dk and dv together",
                "library_ms": bwd_main["library_ms"],
                "library_computes": "scaled_dot_product_attention backward "
                                    "(dq, dk and dv)",
                "wrapper_ms": bwd_main["times"]["wrapper"][0],
                "wrapper_device_ms": bwd_main["times"]["wrapper"][1],
            })
        kernels.append(row)
    print(json.dumps({"paths": runs}))
    print(json.dumps({"kernels": kernels}))
    from ray_tpu_torch import device_name
    # the run used one card, whatever else the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
