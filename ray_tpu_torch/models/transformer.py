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

On a mesh (``mesh=`` a ``parallel.build_mesh`` mesh) the same code runs on
DTensors: ``transformer_logical_axes`` names every leaf's dims, the train
step places the params by those names (``parallel/sharding.py``), and
DTensor's sharding propagation inserts the collectives where GSPMD does in
the JAX package. Attention runs on each rank's local blocks
(``shard_map``): ``mha`` with the batch over the data axes and the heads
over ``tp``, or ring/Ulysses attention over ``sp``. With ``pp_stages > 1``
the layer tree is stacked ``[P, L/P, ...]`` and the layers run as a GPipe
pipeline over the ``pp`` axis (``ops/pipeline.py``). Expert parallelism (an
``ep`` axis above 1) is not ported yet (ROADMAP.md A.3); nor are the MPMD
stage functions (A.4).
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
from ray_tpu_torch.parallel.mesh import data_axes, mesh_sizes


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
    attn_impl: str = "auto"               # auto|reference|blockwise|flash|ring|ulysses
    causal: bool = True                   # False: bidirectional
    remat: bool = True                    # recompute layers in the backward
    pp_stages: int = 1                    # >1: split layers into pipeline stages
    num_microbatches: int = 1             # pipeline microbatches
    # MoE (0 = dense)
    num_experts: int = 0
    # None -> moe_apply's training default (1.25); inference makes routing
    # dropless (generate._inference_cfg)
    moe_capacity_factor: Optional[float] = None
    expert_top_k: int = 1
    tied_embeddings: bool = False

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def layers_per_stage(self) -> int:
        if self.n_layers % self.pp_stages:
            raise ValueError(f"n_layers={self.n_layers} does not split into "
                             f"pp_stages={self.pp_stages}")
        return self.n_layers // self.pp_stages


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

    layers = layers_init(normal, ones, cfg)
    if cfg.pp_stages > 1:
        layers = _map_tree(layers, lambda a: a.reshape(
            (cfg.pp_stages, cfg.layers_per_stage) + a.shape[1:]))
    params = {
        "embed": normal(cfg.vocab_size, d),
        "layers": layers,
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


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def transformer_logical_axes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Dict tree mirroring params: per-leaf logical dim names (see
    parallel/sharding.py DEFAULT_RULES)."""
    stage = ("stage", "layers") if cfg.pp_stages > 1 else ("layers",)

    def L(*axes):  # layer leaf: leading stacked dim(s)
        return stage + axes
    layer = {
        "attn": {
            "wq": L("embed", "heads", "kv"),
            "wk": L("embed", "heads", "kv"),
            "wv": L("embed", "heads", "kv"),
            "wo": L("heads", "kv", "embed"),
        },
        "ln1": L("embed"),
        "ln2": L("embed"),
    }
    if cfg.num_experts:
        layer["moe"] = {
            "router": L("embed", None),
            "w1": L("expert", "embed", "expert_mlp"),
            "w3": L("expert", "embed", "expert_mlp"),
            "w2": L("expert", "expert_mlp", "embed"),
        }
    else:
        layer["mlp"] = {
            "w1": L("embed", "mlp"),
            "w3": L("embed", "mlp"),
            "w2": L("mlp", "embed"),
        }
    axes = {
        "embed": ("vocab", "embed"),
        "layers": layer,
        "final_norm": ("embed",),
    }
    if not cfg.tied_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def unstack_layers(params) -> List[Dict[str, Any]]:
    """The stacked layer tree as one dict per layer, by ``unbind``: views, no
    copy. Under autograd each leaf's backward stacks the L layer gradients
    once; indexing layer ``i`` would instead add a full-size zero gradient
    per layer."""
    return _unstack(params["layers"])


def _unstack(tree):
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts}
                for i in range(len(next(iter(parts.values()))))]
    return tree.unbind(0)


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


def _attention(cfg: TransformerConfig, q, k, v, mesh=None):
    """The JAX ``_attention``'s dispatch: ring or Ulysses attention over the
    mesh's ``sp`` axis, else ``mha`` (on a mesh, on each rank's local
    blocks: batch over the data axes, heads over ``tp``; attention is local
    in both, so this is exact)."""
    impl = cfg.attn_impl
    if impl in ("ring", "ulysses"):
        if mesh is None:
            raise ValueError(f"attn_impl={impl!r} (sequence parallelism) "
                             "runs over a mesh's 'sp' axis: pass mesh=")
        from ray_tpu_torch.ops.ring_attention import ring_attention
        from ray_tpu_torch.ops.ulysses import ulysses_attention
        fn = ring_attention if impl == "ring" else ulysses_attention
        return fn(q, k, v, mesh, causal=cfg.causal)
    if mesh is None:
        return mha(q, k, v, causal=cfg.causal, impl=impl)
    from ray_tpu_torch.parallel.sharding import shard_map
    spec = (data_axes(), None, "tp", None)
    return shard_map(lambda q, k, v: mha(q, k, v, causal=cfg.causal,
                                         impl=impl),
                     mesh, (spec, spec, spec), spec)(q, k, v)


def _layer_apply(cfg: TransformerConfig, layer, x, positions,
                 return_kv: bool = False, mesh=None):
    if mesh is None:
        return _layer_body(cfg, layer, x, positions, return_kv, None)
    # DTensors: plain tensors made in the layer (RoPE's angles) count as
    # replicated. Entered here, not by the caller, so that a remat
    # recompute in the backward runs under it too.
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        return _layer_body(cfg, layer, x, positions, return_kv, mesh)


def _layer_body(cfg, layer, x, positions, return_kv, mesh):
    dt = cfg.dtype
    h = _rmsnorm(x, layer["ln1"])
    a = layer["attn"]
    q = torch.einsum("bse,ehd->bshd", h, a["wq"].to(dt))
    k = torch.einsum("bse,ehd->bshd", h, a["wk"].to(dt))
    v = torch.einsum("bse,ehd->bshd", h, a["wv"].to(dt))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = _attention(cfg, q, k, v, mesh)
    o = torch.einsum("bshd,hde->bse", o, a["wo"].to(dt))
    x = x + o
    y = _mlp(cfg, layer, _rmsnorm(x, layer["ln2"]))
    if return_kv:
        # KV-cache prefill (models/generate.py): hand back the
        # already-computed rotated K and V instead of recomputing them.
        return x + y, (k, v)
    return x + y


def _stage_apply(cfg: TransformerConfig, layers, x, positions, mesh=None):
    """Apply the layers in order (the JAX version's ``lax.scan``). With
    ``cfg.remat`` and grad enabled each layer runs under
    ``torch.utils.checkpoint`` (``jax.checkpoint``): only its input is kept,
    and its forward runs again in the backward."""
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            x = checkpoint(_layer_apply, cfg, layer, x, positions, False,
                           mesh, use_reentrant=False)
        else:
            x = _layer_apply(cfg, layer, x, positions, mesh=mesh)
    return x


def _head(cfg: TransformerConfig, params, x):
    x = _rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return (x @ head.to(cfg.dtype)).float()


def transformer_apply(params, tokens, cfg: TransformerConfig, *,
                      mesh=None, positions=None, device=None):
    """tokens: [B, S] int -> logits [B, S, vocab] (compute in cfg.dtype,
    logits float32). With ``mesh`` the params are DTensors (placed by
    ``transformer_logical_axes``), tokens a DTensor or the same tensor on
    every rank (placed with the batch over the data axes), and the logits a
    DTensor."""
    dev = resolve_device(device)
    check_device(params, dev)
    if mesh is not None:
        return _apply_on_mesh(params, tokens, cfg, mesh, positions, dev)
    if cfg.pp_stages > 1:
        raise ValueError("pp_stages>1 requires a mesh")
    tokens = tokens.to(dev)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=dev).expand(b, s)
    x = params["embed"].to(cfg.dtype)[tokens]
    x = _stage_apply(cfg, unstack_layers(params), x, positions)
    return _head(cfg, params, x)


def _batch_on_mesh(x, mesh, dev):
    """``x`` as a DTensor with its batch dim over the data axes (a DTensor
    stays as it is)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import batch_sharding, place
    if isinstance(x, DTensor):
        return x
    x = torch.as_tensor(x).to(dev)
    return place(x, batch_sharding(mesh, x.dim()))


def _apply_on_mesh(params, tokens, cfg, mesh, positions, dev):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from ray_tpu_torch.parallel.sharding import place, replicated
    if cfg.num_experts and mesh_sizes(mesh).get("ep", 1) > 1:
        raise NotImplementedError("expert parallelism (an 'ep' mesh axis "
                                  "above 1) is not ported yet (ROADMAP.md "
                                  "A.3)")
    tokens = _batch_on_mesh(tokens, mesh, dev)
    # plain params count as replicated, as unplaced arrays do under jit
    params = _map_tree(params, lambda a: a if isinstance(a, DTensor)
                       else place(a, replicated(mesh)))
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=dev).expand(b, s)
    with implicit_replication():
        # the lookup on a whole table (indexing has no sharding rule, and
        # F.embedding's for a vocab-sharded table fails on batch-sharded
        # tokens); the head's product below uses the sharded one
        table = params["embed"].redistribute(
            placements=replicated(mesh)[1])
        x = F.embedding(tokens, table.to(cfg.dtype))
        if cfg.pp_stages > 1:
            x = _pipeline(cfg, params["layers"], x, positions, mesh)
        else:
            # a DTensor, so that RoPE's cos and sin are too: the backward
            # of a product runs outside implicit_replication
            positions = place(positions, replicated(mesh))
            x = _stage_apply(cfg, unstack_layers(params), x, positions, mesh)
        return _head(cfg, params, x)


def _pipeline(cfg, layers, x, positions, mesh):
    """The JAX pipeline branch: microbatches of the batch through the
    stages over ``pp`` (``ops/pipeline.py``), each stage's layers applied
    on its ranks' local blocks."""
    from ray_tpu_torch.ops.pipeline import pipeline_apply
    m = cfg.num_microbatches
    b, s = x.shape[:2]
    if b % m:
        raise ValueError(f"batch {b} % microbatches {m} != 0")
    pp = mesh_sizes(mesh)["pp"]
    if pp != cfg.pp_stages:
        # the JAX function would apply only some stages (ROADMAP.md C)
        raise ValueError(f"pp_stages={cfg.pp_stages} needs a mesh whose "
                         f"'pp' axis has {cfg.pp_stages} ranks, not {pp}")
    xs = x.reshape(m, b // m, s, cfg.d_model)
    # positions are identical across batch rows; a [1, S] row broadcasts
    # against any local microbatch
    pos_s = positions[:1]

    def stage_fn(stage_layers, act):
        return _stage_apply(cfg, _unstack(stage_layers), act, pos_s)

    out = pipeline_apply(stage_fn, layers, xs, mesh, num_microbatches=m)
    return out.reshape(b, s, cfg.d_model)


def transformer_loss(params, batch, cfg: TransformerConfig, *, mesh=None,
                     device=None):
    """batch: {"tokens": [B, S]} next-token cross-entropy on f32 logits, the
    mean over non-final positions; with ``batch["mask"]`` ([B, S]) the mean
    over the masked-in targets, ``(nll * mask[:, 1:]).sum() /
    max(mask[:, 1:].sum(), 1)``. With ``mesh`` both are global: sums over
    every rank's rows, a 0-d DTensor."""
    tokens, mask = batch["tokens"], batch.get("mask")
    if mesh is None:
        logits = transformer_apply(params, tokens, cfg, device=device)
        return _nll(logits, tokens.to(logits.device),
                    None if mask is None else mask.to(logits.device))
    from torch.distributed.tensor.experimental import implicit_replication
    dev = resolve_device(device)
    tokens = _batch_on_mesh(tokens, mesh, dev)
    if mask is not None:
        mask = _batch_on_mesh(mask, mesh, dev)
    logits = transformer_apply(params, tokens, cfg, mesh=mesh, device=dev)
    with implicit_replication():
        return _nll(logits, tokens, mask)


def _nll(logits, tokens, mask):
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    if mask is not None:
        mask = mask[:, 1:]
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
