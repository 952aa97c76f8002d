"""Vision Transformer, ported from ``ray_tpu/models/vit.py``.

The image classifier on the flagship's transformer layers: patchify is a
reshape and transpose followed by one matmul (no convolution), a learned
[CLS] token and learned positions go in front, and the encoder is the LM's
own ``_stage_apply`` with bidirectional attention (RoPE included, as the JAX
layers apply it), then the final RMSNorm and the head on the [CLS] token.

Attention runs at head_dim 64 over S = patches + 1 (197 at 224² images,
patch 16) without the causal mask. ``mha(impl="auto")`` sends CUDA tensors
of that shape to the flash kernels (``ops/attention.py``), where the TPU's
``auto`` took the plain path: its flash kernel needs sequences and head_dim
in multiples of 128 (``ray_tpu/ops/attention.py``), the port's kernels take
any length.

On a mesh (``mesh=``, a ``parallel.build_mesh`` mesh) the params are
DTensors placed by ``vit_logical_axes`` and the batch is sharded over the
data axes. The patch embedding and the head run on each rank's local rows
(``shard_map``, with the fsdp-sharded projection, [CLS], positions and head
gathered, as the LM gathers its embedding table); the encoder is the LM's
mesh path, attention through the kernels on each rank's local blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig,
                                              _batch_on_mesh, _map_tree,
                                              _rmsnorm, _stage_apply,
                                              check_device, layers_init,
                                              transformer_logical_axes,
                                              unstack_layers)
from ray_tpu_torch.parallel.mesh import data_axes


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 384
    n_layers: int = 6
    n_heads: int = 6
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + [CLS]

    def encoder_config(self) -> TransformerConfig:
        """The shared transformer layers, configured for vision: full
        (non-causal) attention over the patches and the [CLS] token."""
        return TransformerConfig(
            vocab_size=1, d_model=self.d_model, n_layers=self.n_layers,
            n_heads=self.n_heads, max_seq=self.seq_len,
            attn_impl="auto", causal=False, dtype=self.dtype,
            param_dtype=self.param_dtype, remat=self.remat)


def vit_init(generator: torch.Generator, cfg: ViTConfig,
             device=None) -> Dict[str, Any]:
    """Random params with the JAX tree's keys and scales: the patch
    projection and the head normal over sqrt(fan-in), [CLS] and positions
    normal(0.02), the layers as ``transformer_init``'s. ``generator`` must
    live on the target device."""
    dev = resolve_device(device)
    pd, d = cfg.param_dtype, cfg.d_model
    patch_dim = cfg.patch_size * cfg.patch_size * 3

    def normal(*shape, std=0.02):
        return torch.empty(shape, dtype=pd, device=dev).normal_(
            0.0, std, generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    return {
        "patch_proj": normal(patch_dim, d, std=patch_dim ** -0.5),
        "cls": normal(1, 1, d),
        "pos": normal(1, cfg.seq_len, d),
        "layers": layers_init(normal, ones, cfg.encoder_config()),
        "ln_f": ones(d),
        "head": normal(d, cfg.num_classes, std=d ** -0.5),
    }


def _patchify(images, patch: int):
    """[B, H, W, 3] -> [B, N, patch*patch*3], the JAX version's order."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def vit_logical_axes(cfg: ViTConfig) -> Dict[str, Any]:
    """Per-leaf logical dim names of the params, the JAX ViT step's
    (``ray_tpu/train/jax_step.py``): the encoder's layers as the LM's."""
    return {
        "patch_proj": (None, "embed"),
        "cls": (None, None, "embed"),
        "pos": (None, None, "embed"),
        "layers": transformer_logical_axes(cfg.encoder_config())["layers"],
        "ln_f": (None,),
        "head": ("embed", None),
    }


def _embed(images, patch_proj, cls, pos, cfg: ViTConfig):
    """[B, H, W, 3] images -> [B, S, D] tokens: the patches' projection
    after the [CLS] token, plus the positions."""
    dt = cfg.dtype
    x = _patchify(images.to(dt), cfg.patch_size) @ patch_proj.to(dt)
    cls = cls.to(dt).expand(x.shape[0], 1, cfg.d_model)
    return torch.cat([cls, x], dim=1) + pos.to(dt)


def _classify(x, ln_f, head, cfg: ViTConfig):
    """The final norm and the head on the [CLS] token -> f32 logits."""
    x = _rmsnorm(x, ln_f)
    return (x[:, 0, :] @ head.to(cfg.dtype)).float()


def vit_apply(params, images, cfg: ViTConfig, *, mesh=None, device=None):
    """images: [B, H, W, 3] float -> logits [B, num_classes] f32. With
    ``mesh`` the params are DTensors (or tensors with the same value on
    every rank), the images a DTensor or the same tensor on every rank, and
    the logits a DTensor with the batch over the data axes."""
    dev = resolve_device(device)
    check_device(params, dev, key="patch_proj")
    enc = cfg.encoder_config()
    if mesh is not None:
        return _apply_on_mesh(params, images, cfg, mesh, dev)
    x = _embed(images.to(dev), params["patch_proj"], params["cls"],
               params["pos"], cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=dev).expand(b, s)
    x = _stage_apply(enc, unstack_layers(params), x, positions)
    return _classify(x, params["ln_f"], params["head"], cfg)


def _apply_on_mesh(params, images, cfg, mesh, dev):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from ray_tpu_torch.parallel.sharding import place, replicated, shard_map
    images = _batch_on_mesh(images, mesh, dev)
    # plain params count as replicated, as unplaced arrays do under jit
    params = _map_tree(params, lambda a: a if isinstance(a, DTensor)
                       else place(a, replicated(mesh)))
    rows = (data_axes(), None, None)
    x = shard_map(lambda im, w, c, p: _embed(im, w, c, p, cfg), mesh,
                  (rows + (None,), (), (), ()), rows)(
        images, params["patch_proj"], params["cls"], params["pos"])
    b, s = x.shape[:2]
    with implicit_replication():
        positions = place(torch.arange(s, device=dev).expand(b, s),
                          replicated(mesh))
        x = _stage_apply(cfg.encoder_config(), unstack_layers(params), x,
                         positions, mesh)
    return shard_map(lambda x, ln, w: _classify(x, ln, w, cfg), mesh,
                     (rows, (), ()), (data_axes(), None))(
        x, params["ln_f"], params["head"])


def vit_loss(params, batch, cfg: ViTConfig, *, mesh=None, device=None):
    """batch: {"image": [B, H, W, 3], "label": [B] int} -> (mean
    cross-entropy, accuracy), both f32 scalars; with ``mesh`` both are
    global, 0-d DTensors."""
    logits = vit_apply(params, batch["image"], cfg, mesh=mesh, device=device)
    labels = batch["label"]
    if mesh is None:
        return _loss_and_accuracy(logits, labels.to(logits.device))
    from torch.distributed.tensor.experimental import implicit_replication
    labels = _batch_on_mesh(labels, mesh, resolve_device(device))
    with implicit_replication():
        return _loss_and_accuracy(logits, labels)


def _loss_and_accuracy(logits, labels):
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc
