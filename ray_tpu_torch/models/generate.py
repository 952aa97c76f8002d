"""Autoregressive generation with a KV cache, ported from
``ray_tpu/models/generate.py``.

- The KV cache is one stacked pair ``[L, B, T_max, KVH, D]`` matching the
  layer-stacked parameter layout.
- ``prefill`` runs the prompt through the trunk (its attention is the flash
  kernel on the card) and pads each layer's rotated K/V to ``max_len``.
- Decode steps attend over the whole cache with a position mask, in plain
  PyTorch: the JAX package has no kernel there either.
- The position is a 0-dim int64 tensor on the cache's device, as JAX's
  traced ``pos`` is: the cache write is an ``index_copy_`` at it (JAX's
  ``lax.dynamic_update_slice``), and no operation of a step reads a device
  value on the host.
- Unlike the JAX version, ``decode_step`` writes the new K/V into the cache
  in place and returns the same tensors: JAX's arrays are immutable, here an
  update in place saves a copy of the cache per token.
- The JAX ``generate`` runs its decode loop as one ``lax.scan`` inside jit.
  Here a decode step (every layer, the head and the sampling, advancing the
  position) is one function over static tensors. On the card ``generate``
  captures it once a call as a CUDA graph and replays the graph for each
  token: one launch a token, nothing read back until it returns. On the CPU
  the same function runs eagerly. ``_generate_eager`` keeps the loop of one
  eager ``decode_step`` a token, the plain version the card's checks hold
  the graph to.
- MoE models route without dropping at inference (``_inference_cfg``):
  a decode step at S 1 never drops a token, so the prefill must not either,
  or cached and uncached forward passes diverge.

``pp_stages`` does not exist in the port.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig, _head,
                                              _layer_apply, _mlp, _rmsnorm,
                                              _rope, check_device,
                                              unstack_layers)

# The card's decode graphs: captures made, replays launched (one a decode
# step), and the seconds of the last capture (its warm-up step included).
graph_captures = 0
graph_replays = 0
last_capture_s = 0.0

# One capture stream a thread and device: concurrent captures need streams
# of their own, and cuBLAS keeps a workspace for each stream it meets, so a
# fixed stream keeps memory flat over calls.
_streams = threading.local()


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


def _cached_attention(cfg: TransformerConfig, q, k_cache, v_cache, pos):
    """q [B, 1, H, D] against cache [B, T, KVH, D], positions <= pos (a
    0-dim tensor)."""
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


def _decode_layer(cfg: TransformerConfig, layer, k_cache, v_cache, x, pos):
    """One layer, one token: x [B, 1, E]; k/v_cache [B, T, KVH, D], updated
    in place at ``pos`` (a 0-dim int64 tensor)."""
    dt = cfg.dtype
    h = _rmsnorm(x, layer["ln1"])
    positions = pos.view(1, 1).expand(x.shape[0], 1)
    q = torch.einsum("bse,ehd->bshd", h, layer["attn"]["wq"].to(dt))
    q = _rope(q, positions, cfg.rope_theta)
    k_new, v_new = _project_kv(cfg, layer, h, positions)
    k_cache.index_copy_(1, pos.view(1), k_new)
    v_cache.index_copy_(1, pos.view(1), v_new)
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


def decode_step(params, token, pos, cache, cfg: TransformerConfig,
                device=None):
    """One token for the whole batch: token [B] int; pos an int or a 0-dim
    integer tensor on the device. -> (logits [B, vocab], cache). The cache
    is updated in place."""
    dev = resolve_device(device)
    check_device(params, dev)
    cfg = _inference_cfg(cfg)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=dev, dtype=torch.int64)
    else:
        pos = torch.full((), pos, dtype=torch.int64, device=dev)
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


def _start(params, prompt, cfg: TransformerConfig, max_new_tokens: int,
           temperature: float, top_k: Optional[int], seed: int, dev):
    """Prefill and the first token: -> (the decode state, the generator).
    The state holds the static tensors a decode step reads and writes:
    ``token`` [B], ``pos`` (0-dim), ``col`` [1] (out's next column), the
    cache and ``out`` [B, max_new_tokens] with the first token in column
    0. ``params`` are cast already, ``cfg`` is the inference config."""
    b, s = prompt.shape
    gen = None
    if temperature != 0.0:
        gen = torch.Generator(device=dev).manual_seed(seed)
    logits, cache = prefill(params, prompt, cfg, s + max_new_tokens,
                            device=dev)
    token = _sample(logits, gen, temperature, top_k)
    out = torch.zeros((b, max_new_tokens), dtype=torch.int64, device=dev)
    out[:, 0] = token
    state = {"token": token, "cache": cache, "out": out,
             "pos": torch.full((), s, dtype=torch.int64, device=dev),
             "col": torch.ones(1, dtype=torch.int64, device=dev)}
    return state, gen


def _step(params, cfg: TransformerConfig, state, gen, temperature: float,
          top_k: Optional[int]) -> None:
    """One decode step over ``state``, on the device alone: the next token
    goes into ``token`` and ``out``'s column ``col``, then ``pos`` and
    ``col`` advance. The function the card's graph captures."""
    logits, _ = decode_step(params, state["token"], state["pos"],
                            state["cache"], cfg, device=state["pos"].device)
    token = _sample(logits, gen, temperature, top_k)
    state["out"].index_copy_(1, state["col"], token[:, None])
    state["token"].copy_(token)
    state["pos"].add_(1)
    state["col"].add_(1)


def _capture_stream(dev) -> torch.cuda.Stream:
    by_device = getattr(_streams, "by_device", None)
    if by_device is None:
        by_device = _streams.by_device = {}
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    if index not in by_device:
        by_device[index] = torch.cuda.Stream(device=index)
    return by_device[index]


def _decode_graph(step, state, gen, dev) -> torch.cuda.CUDAGraph:
    """Capture ``step`` (a call of ``_step`` over ``state``) as a CUDA graph.

    One warm-up step runs first on the capture stream (the lazy set-up of
    cuBLAS and of the kernels must not happen inside a capture); the state
    and the generator are then put back, so the graph's first replay is the
    first decode step. The capture is thread-local: serve calls this from
    a thread while other threads of the process run CUDA work. A graph
    registers the sampling generator, so each replay draws as the eager
    step would. A failed capture raises."""
    global graph_captures, last_capture_s
    t0 = time.perf_counter()
    current = torch.cuda.current_stream(dev)
    stream = _capture_stream(dev)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        token = state["token"].clone()
        pos = state["pos"].clone()
        rng = gen.get_state() if gen is not None else None
        step()
        state["token"].copy_(token)
        state["pos"].copy_(pos)
        state["col"].fill_(1)
        if gen is not None:
            gen.set_state(rng)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            step()
        finally:
            graph.capture_end()
    current.wait_stream(stream)
    graph_captures += 1
    last_capture_s = time.perf_counter() - t0
    return graph


def _generate_loop(params, prompt, cfg: TransformerConfig,
                   max_new_tokens: int, temperature: float,
                   top_k: Optional[int], seed: int, dev):
    """generate's loop: -> (tokens [B, max_new_tokens], cache). On a CUDA
    device every decode step is a replay of one captured graph; on the CPU
    the same step function runs eagerly."""
    global graph_replays
    state, gen = _start(params, prompt, cfg, max_new_tokens, temperature,
                        top_k, seed, dev)

    def step():
        _step(params, cfg, state, gen, temperature, top_k)

    steps = max_new_tokens - 1
    if dev.type == "cuda" and steps:
        graph = _decode_graph(step, state, gen, dev)
        for _ in range(steps):
            graph.replay()
        graph_replays += steps
    else:
        for _ in range(steps):
            step()
    return state["out"], state["cache"]


def generate(params, prompt, cfg: TransformerConfig, *,
             max_new_tokens: int, temperature: float = 0.0,
             top_k: Optional[int] = None, seed: int = 0,
             device=None) -> torch.Tensor:
    """prompt [B, S] int -> generated tokens [B, max_new_tokens] (int64).

    The prefill's sampled token comes first, then one token per decode step.
    On the card the decode steps are replays of one CUDA graph (module
    docstring). Sampling draws from a ``torch.Generator`` seeded with
    ``seed``: the same seed repeats the same tokens, though not the JAX
    package's."""
    dev = resolve_device(device)
    check_device(params, dev)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be at least 1")
    cfg = _inference_cfg(cfg)
    with torch.inference_mode():
        tokens, _ = _generate_loop(_cast_params(params, cfg.dtype), prompt,
                                   cfg, max_new_tokens, temperature, top_k,
                                   seed, dev)
        return tokens


def _generate_eager(params, prompt, cfg: TransformerConfig, *,
                    max_new_tokens: int, temperature: float = 0.0,
                    top_k: Optional[int] = None, seed: int = 0,
                    device=None):
    """The plain version of ``generate``: one eager ``decode_step`` a token,
    the position a host int. -> (tokens, cache). ``generate`` never runs
    it; the checks that hold the graph path to it do."""
    dev = resolve_device(device)
    check_device(params, dev)
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
        return torch.stack(out, dim=1), cache
