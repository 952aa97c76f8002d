"""Attention primitives, ported from ``ray_tpu/ops/attention.py``.

All take [batch, seq, heads, head_dim] ("BSHD") q/k/v. ``blockwise_attention``
is the online-softmax form (the math under FlashAttention): kv is processed
in chunks with a running max and denominator. Everything here is plain
PyTorch and differentiable; the hand-written kernel lives in ``ops/flash.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _repeat_kv(k, v, heads: int):
    """GQA: repeat each kv head ``heads // kvh`` times in place order
    (``jnp.repeat`` semantics, i.e. ``repeat_interleave``, not ``repeat``)."""
    hk = k.shape[2]
    if hk != heads:
        rep = heads // hk
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def attention_reference(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None,
                        segment_ids=None):
    """Plain softmax attention. q,k,v: [B, S, H, D] (k/v may have fewer heads
    for GQA — heads must divide evenly).

    ``segment_ids=(seg_q [B, Sq], seg_k [B, Sk])`` masks packed sequences: a
    query sees only keys of its own segment (ANDed with the causal mask). A
    row masked everywhere softmaxes over ``NEG_INF`` alone, so it averages
    every value uniformly, as the JAX function does; it is not zeroed."""
    sq, hq, d = q.shape[1], q.shape[2], q.shape[3]
    sk = k.shape[1]
    k, v = _repeat_kv(k, v, hq)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = None
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
    if segment_ids is not None:
        seg_q, seg_k = segment_ids
        seg_mask = (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _block_step(q, kb, vb, acc, m, l, logits_bias, scale):
    """One online-softmax update: attend q block against one kv block.

    q: [B, Bq, H, D]; kb/vb: [B, Bk, H, D]; acc: [B, Bq, H, D] f32;
    m, l: [B, H, Bq] f32 running max / denominator.
    logits_bias: [Bq, Bk] additive mask bias (0 or NEG_INF) or None.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
    if logits_bias is not None:
        s = s + logits_bias
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows: keep m finite so exp() stays 0, not nan
    m_safe = torch.clamp(m_new, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(m - m_safe)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vb.dtype), vb).float()
    acc_new = acc * corr.transpose(1, 2)[..., None] + pv
    return acc_new, m_new, l_new


def blockwise_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None,
                        block_size: int = 512):
    """Memory-efficient attention, a loop over kv blocks. [B,S,H,D]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(k, v, h)
    scale = scale if scale is not None else d ** -0.5
    bk = min(block_size, sk)
    if sk % bk:
        raise ValueError(f"seq_k={sk} not divisible by block_size={bk}")
    dev = q.device
    q_pos = torch.arange(sq, device=dev) + (sk - sq)  # align causal diag
    acc = torch.zeros(b, sq, h, d, dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(b, h, sq, dtype=torch.float32, device=dev)
    for idx in range(sk // bk):
        kblk = k[:, idx * bk:(idx + 1) * bk]
        vblk = v[:, idx * bk:(idx + 1) * bk]
        bias = None
        if causal:
            kpos = idx * bk + torch.arange(bk, device=dev)
            bias = torch.where(q_pos[:, None] >= kpos[None, :], 0.0, NEG_INF)
        acc, m, l = _block_step(q, kblk, vblk, acc, m, l, bias, scale)
    l = torch.clamp(l, min=1e-30)
    out = acc / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def mha(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
        block_size: int = 512, impl: str = "auto"):
    """Dispatch: 'reference' | 'blockwise' | 'flash' | 'auto'.

    auto = the flash kernel for CUDA tensors it takes (``kernel_takes``: any
    sequence length, so the TPU's tile-alignment rule does not apply), else
    blockwise for long sequences, else reference. 'flash' on the card raises
    for inputs the kernel does not take.
    """
    if impl == "reference":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, scale=scale,
                                   block_size=block_size)
    if impl not in ("flash", "auto"):
        raise ValueError(f"unknown attention impl {impl!r}")
    from ray_tpu_torch.ops.flash import flash_attention, kernel_takes
    if impl == "flash" or (q.is_cuda and kernel_takes(q, k, v)):
        return flash_attention(q, k, v, causal=causal, scale=scale)
    if q.shape[1] >= 2048:
        return blockwise_attention(q, k, v, causal=causal, scale=scale,
                                   block_size=block_size)
    return attention_reference(q, k, v, causal=causal, scale=scale)
