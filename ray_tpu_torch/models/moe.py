"""Mixture-of-Experts layer, ported from ``ray_tpu/models/moe.py``.

Capacity-based top-k routing with einsum dispatch and combine tensors, as in
the JAX package: no dynamic shapes, and a token over its expert's capacity is
dropped from that expert (the residual path keeps it). The JAX package leaves
the router, dispatch, expert and combine products to XLA outside any Pallas
kernel, so here they are ``torch.einsum`` calls; there is no kernel to port.

Expert parallelism (the JAX package's "expert" axis over the mesh) is not
ported: the layer runs every expert on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device


def _capacity(cfg, s: int, capacity_factor) -> int:
    """Slots per expert and batch row: explicit factor, else
    ``cfg.moe_capacity_factor``, else 1.25 (the training default)."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor or 1.25
    k = cfg.expert_top_k
    return min(s * k, max(1, int(capacity_factor * s * k / cfg.num_experts)))


def route(cfg, router, h, *, capacity_factor=None):
    """Top-k capacity routing of h [B, S, D] with ``router`` [D, E] ->
    (gates [B, S, E] f32 softmax, dispatch [B, S, E, C] f32 0/1, combine
    [B, S, E, C] f32, dispatch weighted by each kept choice's gate).

    The iterative top-k of the JAX version: take the best remaining expert
    (ties to the lowest index, as ``argmax`` in both stacks), place each
    token at its position in that expert's buffer (a cumsum over the
    sequence after the slots earlier rounds used), keep it if the position
    is under capacity, then mask the expert out and repeat."""
    b, s, _ = h.shape
    e = cfg.num_experts
    cap = _capacity(cfg, s, capacity_factor)
    logits = torch.einsum("bsd,de->bse", h, router.to(h.dtype))
    gates = torch.softmax(logits.float(), dim=-1)

    dispatch = h.new_zeros((b, s, e, cap), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    remaining = gates
    used = torch.zeros((b, e), dtype=torch.float32, device=h.device)
    slots = torch.arange(cap, device=h.device)
    for _ in range(cfg.expert_top_k):
        gate_val = remaining.amax(dim=-1)                        # [B, S]
        idx = remaining.argmax(dim=-1)
        onehot = F.one_hot(idx, e).float()                       # [B, S, E]
        # f32 positions are exact far beyond any sequence length (2^24)
        pos = torch.cumsum(onehot, dim=1) - 1 + used[:, None, :]
        pos_tok = pos.gather(-1, idx[..., None])[..., 0].long()  # [B, S]
        keep = pos_tok < cap
        gv = torch.where(keep, gate_val, 0.0)
        # a dropped token's slot row is all zeros (jax.nn.one_hot of an
        # index out of range), which is how it leaves the dispatch
        pos_oh = (pos_tok[..., None] == slots).float()           # [B, S, C]
        slot = onehot[..., None] * pos_oh[:, :, None, :]         # [B,S,E,C]
        dispatch = dispatch + slot
        combine = combine + slot * gv[..., None, None]
        used = used + (onehot * keep[..., None]).sum(1)
        remaining = remaining * (1.0 - onehot)
    return gates, dispatch, combine


def moe_apply(cfg, moe_params, h, *, capacity_factor=None, device=None):
    """h [B, S, D] -> [B, S, D]: route each token to its top
    ``cfg.expert_top_k`` of ``cfg.num_experts`` SwiGLU experts
    (``moe_params``: router [D, E], w1 and w3 [E, D, F], w2 [E, F, D]) and
    sum their outputs weighted by the gates. Capacity: explicit argument >
    ``cfg.moe_capacity_factor`` > 1.25; inference passes a huge factor
    (dropless, ``generate._inference_cfg``). Products in h's dtype, routing
    in f32. ``h`` must lie on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    if h.device.type != dev.type:
        raise ValueError(f"h lies on {h.device}, the call asks for {dev}")
    dt = h.dtype
    _, dispatch, combine = route(cfg, moe_params["router"], h,
                                 capacity_factor=capacity_factor)
    xs = torch.einsum("bsec,bsd->becd", dispatch.to(dt), h)     # [B,E,C,D]
    w1, w3, w2 = (moe_params[n].to(dt) for n in ("w1", "w3", "w2"))
    gate = F.silu(torch.einsum("becd,edf->becf", xs, w1))
    up = torch.einsum("becd,edf->becf", xs, w3)
    ys = torch.einsum("becf,efd->becd", gate * up, w2)          # [B,E,C,D]
    return torch.einsum("bsec,becd->bsd", combine.to(dt), ys)


def load_balance_loss(gates, dispatch):
    """Switch-style auxiliary loss, which pushes toward uniform expert load.
    gates [B, S, E] softmax probabilities; dispatch [B, S, E, C]."""
    e = gates.shape[-1]
    frac_tokens = dispatch.sum((1, 3)) / torch.clamp(
        dispatch.sum((1, 2, 3))[:, None], min=1)
    frac_probs = gates.mean(1)
    return e * (frac_tokens * frac_probs).sum(-1).mean()
