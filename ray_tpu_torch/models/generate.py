"""Autoregressive generation with a KV cache, ported from
``ray_tpu/models/generate.py``.

- The KV cache is one stacked pair ``[L, B, T_max, KVH, D]`` matching the
  layer-stacked parameter layout.
- ``prefill`` runs the prompt through the trunk (its attention is the flash
  kernel on the card) and pads each layer's rotated K/V to ``max_len``.
- Decode steps attend over the whole cache with a position mask, in plain
  PyTorch: the JAX package has no kernel there either.
- Unlike the JAX version, ``decode_step`` writes the new K/V into the cache
  in place and returns the same tensors: JAX's arrays are immutable, here an
  update in place saves a copy of the cache per token.
- MoE models route without dropping at inference (``_inference_cfg``):
  a decode step at S 1 never drops a token, so the prefill must not either,
  or cached and uncached forward passes diverge.

``pp_stages`` does not exist in the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig, _head,
                                              _layer_apply, _mlp, _rmsnorm,
                                              _rope, check_device,
                                              unstack_layers)


def _inference_cfg(cfg: TransformerConfig) -> TransformerConfig:
    """Dropless MoE at inference: capacity dropping is a training
    throughput trade; S=1 decode never drops, so prefill must not either
    or cached and uncached passes diverge."""
    if cfg.num_experts and cfg.moe_capacity_factor is None:
        return dataclasses.replace(cfg, moe_capacity_factor=1e9)
    return cfg


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> Dict[str, torch.Tensor]:
    """[L, B, T, KVH, D] zeros pair (kv dtype = compute dtype)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _project_kv(cfg: TransformerConfig, layer, h, positions):
    a = layer["attn"]
    dt = cfg.dtype
    k = torch.einsum("bse,ehd->bshd", h, a["wk"].to(dt))
    v = torch.einsum("bse,ehd->bshd", h, a["wv"].to(dt))
    return _rope(k, positions, cfg.rope_theta), v


def _cached_attention(cfg: TransformerConfig, q, k_cache, v_cache, pos: int):
    """q [B, 1, H, D] against cache [B, T, KVH, D], positions <= pos."""
    b, _, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, d)
    # the division by sqrt(d) happens in q's dtype, before the f32 cast;
    # sqrt(d) is rounded to that dtype first, as jnp.sqrt(asarray(d, dtype))
    # is (taken on the host: a device scalar would cost a sync per layer)
    root_d = float(torch.tensor(d, dtype=q.dtype).sqrt())
    scores = torch.einsum("bokgd,btkd->bkgt", qg, k_cache) / root_d
    mask = torch.arange(t, device=q.device) <= pos
    scores = torch.where(mask, scores.float(), -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", w, v_cache)
    return o.reshape(b, 1, h, d)


def _decode_layer(cfg: TransformerConfig, layer, k_cache, v_cache, x,
                  pos: int):
    """One layer, one token: x [B, 1, E]; k/v_cache [B, T, KVH, D], updated
    in place at ``pos``."""
    dt = cfg.dtype
    h = _rmsnorm(x, layer["ln1"])
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q = torch.einsum("bse,ehd->bshd", h, layer["attn"]["wq"].to(dt))
    q = _rope(q, positions, cfg.rope_theta)
    k_new, v_new = _project_kv(cfg, layer, h, positions)
    k_cache[:, pos] = k_new[:, 0]
    v_cache[:, pos] = v_new[:, 0]
    o = _cached_attention(cfg, q, k_cache, v_cache, pos)
    o = torch.einsum("bshd,hde->bse", o, layer["attn"]["wo"].to(dt))
    x = x + o
    return x + _mlp(cfg, layer, _rmsnorm(x, layer["ln2"]))


def prefill(params, tokens, cfg: TransformerConfig, max_len: int,
            device=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt through the trunk, returning (last-position logits
    [B, vocab], filled cache). tokens [B, S], S <= max_len."""
    dev = resolve_device(device)
    check_device(params, dev)
    cfg = _inference_cfg(cfg)
    tokens = tokens.to(dev)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len}")
    positions = torch.arange(s, device=dev).expand(b, s)
    x = params["embed"].to(cfg.dtype)[tokens]
    cache = init_cache(cfg, b, max_len, device=dev)
    for i, layer in enumerate(unstack_layers(params)):
        # return_kv hands back the layer's already-computed rotated K/V
        x, (k, v) = _layer_apply(cfg, layer, x, positions, return_kv=True)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    logits = _head(cfg, params, x[:, -1:])
    return logits[:, 0], cache


def decode_step(params, token, pos: int, cache, cfg: TransformerConfig,
                device=None):
    """One token for the whole batch: token [B] int, pos an int.
    -> (logits [B, vocab], cache). The cache is updated in place."""
    dev = resolve_device(device)
    check_device(params, dev)
    cfg = _inference_cfg(cfg)
    x = params["embed"].to(cfg.dtype)[token.to(dev)][:, None, :]  # [B,1,E]
    for i, layer in enumerate(unstack_layers(params)):
        x = _decode_layer(cfg, layer, cache["k"][i], cache["v"][i], x, pos)
    logits = _head(cfg, params, x)
    return logits[:, 0], cache


def _sample(logits, generator: Optional[torch.Generator],
            temperature: float, top_k: Optional[int]):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < thresh, -1e30, logits)  # ties stay
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _cast_params(params, dtype):
    """Every weight (the ``moe`` subtree's too) is cast to the compute dtype
    where it is used; casting once per ``generate`` instead of once per
    token gives the same numbers."""
    if isinstance(params, dict):
        return {k: _cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype)


def generate(params, prompt, cfg: TransformerConfig, *,
             max_new_tokens: int, temperature: float = 0.0,
             top_k: Optional[int] = None, seed: int = 0,
             device=None) -> torch.Tensor:
    """prompt [B, S] int -> generated tokens [B, max_new_tokens] (int64).

    The prefill's sampled token comes first, then one token per decode step.
    Sampling draws from a ``torch.Generator`` seeded with ``seed``: the same
    seed repeats the same tokens, though not the JAX package's."""
    dev = resolve_device(device)
    check_device(params, dev)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be at least 1")
    cfg = _inference_cfg(cfg)
    with torch.inference_mode():
        params = _cast_params(params, cfg.dtype)
        b, s = prompt.shape
        gen = None
        if temperature != 0.0:
            gen = torch.Generator(device=dev).manual_seed(seed)
        logits, cache = prefill(params, prompt, cfg, s + max_new_tokens,
                                device=dev)
        token = _sample(logits, gen, temperature, top_k)
        out = [token]
        for pos in range(s, s + max_new_tokens - 1):
            logits, cache = decode_step(params, token, pos, cache, cfg,
                                        device=dev)
            token = _sample(logits, gen, temperature, top_k)
            out.append(token)
        return torch.stack(out, dim=1)
