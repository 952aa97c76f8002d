"""Flagship decoder-only Transformer LM (llama-style), ported from
``ray_tpu/models/transformer.py``.

Parameters are a plain dict of tensors with the JAX pytree's keys and its
stacked-layer layout (``wq [L, d, h, hd]``, ``wo [L, h, hd, d]``, ...), so
each function here reads against its JAX counterpart. The ``lax.scan`` over
stacked layers is a Python loop over the layers, and ``jax.checkpoint``
(``cfg.remat``) is ``torch.utils.checkpoint``. Compute dtype bfloat16, params
float32, logits float32.

With ``num_experts > 0`` each layer's MLP is a Mixture-of-Experts layer
(``models/moe.py``), its weights in a stacked ``moe`` subtree (router
``[L, d, e]``, ``w1``/``w3 [L, e, d, f]``, ``w2 [L, e, f, d]``) in place of
``mlp``, as in the JAX package.

Not ported yet (ROADMAP.md): expert parallelism, ring/Ulysses attention,
pipeline stages (``pp_stages``, ``num_microbatches``) and
``transformer_logical_axes``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import moe
from ray_tpu_torch.ops.attention import mha


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None      # None -> = n_heads (MHA)
    d_ff: Optional[int] = None            # None -> 4 * d_model
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16           # compute dtype
    param_dtype: Any = torch.float32
    attn_impl: str = "auto"               # auto|reference|blockwise|flash
    causal: bool = True                   # False: bidirectional
    remat: bool = True                    # recompute layers in the backward
    # MoE (0 = dense)
    num_experts: int = 0
    # None -> moe_apply's training default (1.25); inference makes routing
    # dropless (generate._inference_cfg)
    moe_capacity_factor: Optional[float] = None
    expert_top_k: int = 1
    tied_embeddings: bool = False

    def __post_init__(self):
        if self.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r} (sequence parallelism) is not "
                "ported yet (ROADMAP.md, queue A)")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def transformer_init(generator: torch.Generator, cfg: TransformerConfig,
                     device=None) -> Dict[str, Any]:
    """Random params, normal(0.02) for matrices and ones for norm scales.

    ``generator`` must live on the target device (for example
    ``torch.Generator(device="cuda").manual_seed(0)``); its numbers differ
    from ``jax.random``'s, so parity tests convert JAX params instead
    (``models/convert.py``)."""
    dev = resolve_device(device)
    d, pd = cfg.d_model, cfg.param_dtype

    def normal(*shape):
        return torch.empty(shape, dtype=pd, device=dev).normal_(
            0.0, 0.02, generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    params = {
        "embed": normal(cfg.vocab_size, d),
        "layers": layers_init(normal, ones, cfg),
        "final_norm": ones(d),
    }
    if not cfg.tied_embeddings:
        params["lm_head"] = normal(d, cfg.vocab_size)
    return params


def layers_init(normal, ones, cfg: TransformerConfig) -> Dict[str, Any]:
    """The stacked layer tree: ``normal(*shape)`` for matrices, ``ones`` for
    norm scales, and a ``moe`` subtree in place of ``mlp`` when
    ``cfg.num_experts``."""
    L, d, h, hk, hd, f = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.kv_heads, cfg.head_dim, cfg.ff_dim)
    layers = {
        "attn": {"wq": normal(L, d, h, hd), "wk": normal(L, d, hk, hd),
                 "wv": normal(L, d, hk, hd), "wo": normal(L, h, hd, d)},
        "ln1": ones(L, d),
        "ln2": ones(L, d),
    }
    e = cfg.num_experts
    if e:
        layers["moe"] = {"router": normal(L, d, e), "w1": normal(L, e, d, f),
                         "w3": normal(L, e, d, f), "w2": normal(L, e, f, d)}
    else:
        layers["mlp"] = {"w1": normal(L, d, f), "w3": normal(L, d, f),
                         "w2": normal(L, f, d)}
    return layers


def unstack_layers(params) -> List[Dict[str, Any]]:
    """The stacked layer tree as one dict per layer, by ``unbind``: views, no
    copy. Under autograd each leaf's backward stacks the L layer gradients
    once; indexing layer ``i`` would instead add a full-size zero gradient
    per layer."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            return [{k: parts[k][i] for k in parts}
                    for i in range(len(next(iter(parts.values()))))]
        return tree.unbind(0)
    return split(params["layers"])


def check_device(params, dev: torch.device, key: str = "embed") -> None:
    """The params (their ``key`` leaf) must already lie on the resolved
    device."""
    have = params[key].device
    if have.type != dev.type:
        raise ValueError(f"params lie on {have}, the call asks for {dev}")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _rmsnorm(x, scale, eps=1e-6):
    # variance in f32; x * rsqrt promotes to f32 and is cast back to x's
    # dtype before the scale, as in the JAX version
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _rope(x, positions, theta: float):
    """x: [B, S, H, D]; rotate pairs (d, d + D/2) (halves, not interleaved)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (torch.log(torch.tensor(theta)) / half))
    angles = positions[:, :, None].float() * freqs              # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _mlp(cfg: TransformerConfig, layer, h):
    """The layer's feed-forward block: the MoE layer when
    ``cfg.num_experts``, else the dense SwiGLU MLP."""
    if cfg.num_experts:
        return moe.moe_apply(cfg, layer["moe"], h, device=h.device)
    dt = cfg.dtype
    m = layer["mlp"]
    gate = F.silu(h @ m["w1"].to(dt))
    up = h @ m["w3"].to(dt)
    return (gate * up) @ m["w2"].to(dt)


def _layer_apply(cfg: TransformerConfig, layer, x, positions,
                 return_kv: bool = False):
    dt = cfg.dtype
    h = _rmsnorm(x, layer["ln1"])
    a = layer["attn"]
    q = torch.einsum("bse,ehd->bshd", h, a["wq"].to(dt))
    k = torch.einsum("bse,ehd->bshd", h, a["wk"].to(dt))
    v = torch.einsum("bse,ehd->bshd", h, a["wv"].to(dt))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = mha(q, k, v, causal=cfg.causal, impl=cfg.attn_impl)
    o = torch.einsum("bshd,hde->bse", o, a["wo"].to(dt))
    x = x + o
    y = _mlp(cfg, layer, _rmsnorm(x, layer["ln2"]))
    if return_kv:
        # KV-cache prefill (models/generate.py): hand back the
        # already-computed rotated K and V instead of recomputing them.
        return x + y, (k, v)
    return x + y


def _stage_apply(cfg: TransformerConfig, layers, x, positions):
    """Apply the layers in order (the JAX version's ``lax.scan``). With
    ``cfg.remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint`` (``jax.checkpoint``): only its input is kept,
    and its forward runs again in the backward."""
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            x = checkpoint(_layer_apply, cfg, layer, x, positions,
                           use_reentrant=False)
        else:
            x = _layer_apply(cfg, layer, x, positions)
    return x


def _head(cfg: TransformerConfig, params, x):
    x = _rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return (x @ head.to(cfg.dtype)).float()


def transformer_apply(params, tokens, cfg: TransformerConfig, *,
                      positions=None, device=None):
    """tokens: [B, S] int -> logits [B, S, vocab] (compute in cfg.dtype,
    logits float32)."""
    dev = resolve_device(device)
    check_device(params, dev)
    tokens = tokens.to(dev)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=dev).expand(b, s)
    x = params["embed"].to(cfg.dtype)[tokens]
    x = _stage_apply(cfg, unstack_layers(params), x, positions)
    return _head(cfg, params, x)


def transformer_loss(params, batch, cfg: TransformerConfig, *, device=None):
    """batch: {"tokens": [B, S]} next-token cross-entropy on f32 logits, the
    mean over non-final positions; with ``batch["mask"]`` ([B, S]) the mean
    over the masked-in targets, ``(nll * mask[:, 1:]).sum() /
    max(mask[:, 1:].sum(), 1)``."""
    tokens = batch["tokens"]
    logits = transformer_apply(params, tokens, cfg, device=device)
    targets = tokens.to(logits.device)[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.to(logits.device)[:, 1:]
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def transformer_num_params(cfg: TransformerConfig) -> int:
    d, f, v = cfg.d_model, cfg.ff_dim, cfg.vocab_size
    per_layer = d * cfg.n_heads * cfg.head_dim * 2 \
        + d * cfg.kv_heads * cfg.head_dim * 2 + 2 * d
    if cfg.num_experts:
        per_layer += d * cfg.num_experts + cfg.num_experts * 3 * d * f
    else:
        per_layer += 3 * d * f
    total = v * d + cfg.n_layers * per_layer + d
    if not cfg.tied_embeddings:
        total += d * v
    return total
