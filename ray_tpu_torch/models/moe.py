"""Mixture-of-Experts layer, ported from ``ray_tpu/models/moe.py``.

Capacity-based top-k routing with einsum dispatch and combine tensors, as in
the JAX package: no dynamic shapes, and a token over its expert's capacity is
dropped from that expert (the residual path keeps it). The JAX package leaves
the router, dispatch, expert and combine products to XLA outside any Pallas
kernel, so here they are ``torch.einsum`` calls; there is no kernel to port.

On a mesh (``mesh=``) the layer is expert parallel, as the JAX package's
is under GSPMD: the expert weights are sharded on ``ep`` (``"expert"``) and
their hidden dim on ``tp`` (``"expert_mlp"``), and each rank runs the layer
on its local blocks (``shard_map``). The router is replicated, so every
``ep`` rank routes its whole batch rows over all the experts (the capacity
comes from the global expert count) and keeps the slots of its own experts;
no rank needs another's tokens. The combine then holds a partial sum of the
output on each ``ep`` and ``tp`` rank, and one all-reduce over those axes a
layer sums it. No expert weight is gathered.
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


def moe_apply(cfg, moe_params, h, *, capacity_factor=None, mesh=None,
              device=None):
    """h [B, S, D] -> [B, S, D]: route each token to its top
    ``cfg.expert_top_k`` of ``cfg.num_experts`` SwiGLU experts
    (``moe_params``: router [D, E], w1 and w3 [E, D, F], w2 [E, F, D]) and
    sum their outputs weighted by the gates. Capacity: explicit argument >
    ``cfg.moe_capacity_factor`` > 1.25; inference passes a huge factor
    (dropless, ``generate._inference_cfg``). Products in h's dtype, routing
    in f32. ``h`` must lie on ``device`` (``None``: the CUDA card). With
    ``mesh`` the arguments are DTensors (or tensors with the same value on
    every rank) and the layer is expert parallel (module docstring)."""
    dev = resolve_device(device)
    if h.device.type != dev.type:
        raise ValueError(f"h lies on {h.device}, the call asks for {dev}")
    if mesh is not None:
        return _moe_on_mesh(cfg, moe_params, h, capacity_factor, mesh)
    return _experts(cfg, moe_params, h, capacity_factor)


def _experts(cfg, moe_params, h, capacity_factor, first: int = 0):
    """The layer over the experts ``first ..`` that ``moe_params``' expert
    weights hold (all of them off a mesh), routed over all
    ``cfg.num_experts``: their share of the output."""
    dt = h.dtype
    _, dispatch, combine = route(cfg, moe_params["router"], h,
                                 capacity_factor=capacity_factor)
    w1, w3, w2 = (moe_params[n].to(dt) for n in ("w1", "w3", "w2"))
    held = slice(first, first + w1.shape[0])
    dispatch, combine = dispatch[:, :, held], combine[:, :, held]
    xs = torch.einsum("bsec,bsd->becd", dispatch.to(dt), h)     # [B,E,C,D]
    gate = F.silu(torch.einsum("becd,edf->becf", xs, w1))
    up = torch.einsum("becd,edf->becf", xs, w3)
    ys = torch.einsum("becf,efd->becd", gate * up, w2)          # [B,E,C,D]
    return torch.einsum("bsec,becd->bsd", combine.to(dt), ys)


def _moe_on_mesh(cfg, moe_params, h, capacity_factor, mesh):
    from ray_tpu_torch.parallel.collectives import allreduce_sum, axis_index
    from ray_tpu_torch.parallel.mesh import data_axes, mesh_sizes
    from ray_tpu_torch.parallel.sharding import shard_map
    sizes = mesh_sizes(mesh)
    if cfg.num_experts % sizes["ep"]:
        raise ValueError(f"num_experts={cfg.num_experts} does not split "
                         f"over ep={sizes['ep']}")
    # the output's partial sums: over ep (each rank's experts) and tp (each
    # rank's slice of the expert hidden dim)
    partial = tuple(a for a in ("ep", "tp") if sizes[a] > 1)

    def body(h, router, w1, w3, w2):
        y = _experts(cfg, {"router": router, "w1": w1, "w3": w3, "w2": w2},
                     h, capacity_factor, axis_index("ep") * w1.shape[0])
        return allreduce_sum(y, partial) if partial else y

    rows = (data_axes(), None, None)
    up, down = ("ep", None, "tp"), ("ep", "tp", None)
    return shard_map(body, mesh, (rows, (), up, up, down), rows)(
        h, moe_params["router"], moe_params["w1"], moe_params["w3"],
        moe_params["w2"])


def load_balance_loss(gates, dispatch):
    """Switch-style auxiliary loss, which pushes toward uniform expert load.
    gates [B, S, E] softmax probabilities; dispatch [B, S, E, C]."""
    e = gates.shape[-1]
    frac_tokens = dispatch.sum((1, 3)) / torch.clamp(
        dispatch.sum((1, 2, 3))[:, None], min=1)
    frac_probs = gates.mean(1)
    return e * (frac_tokens * frac_probs).sum(-1).mean()
