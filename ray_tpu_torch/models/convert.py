"""Weights from the JAX package into the port.

``params_from_jax`` takes the tree that ``ray_tpu.models.transformer_init``
returns (dense, or with the stacked ``moe`` subtree of an MoE model), and
``vit_params_from_jax`` the tree of ``ray_tpu.models.vit_init``, with every
leaf already turned into a numpy array by the caller (for example
``jax.tree.map(np.asarray, params)``). Each returns the port's dict: the same
keys and the same stacked layout, as torch tensors. Both stacks then compute
the same function. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig


def _convert(tree, dev: torch.device, dtype) -> Dict[str, Any]:
    if isinstance(tree, dict):
        return {k: _convert(v, dev, dtype) for k, v in tree.items()}
    # np.array copies: the caller's (possibly read-only) array is not shared
    # with the returned tensor
    return torch.from_numpy(np.array(tree)).to(device=dev, dtype=dtype)


def _check_layers(layers, cfg) -> None:
    if np.shape(layers["ln1"])[0] != cfg.n_layers:
        raise ValueError("params are not stacked [n_layers, ...] "
                         "(pipeline-staged trees are not supported)")
    if ("moe" in layers) != bool(cfg.num_experts):
        raise ValueError("num_experts does not match the tree's layers "
                         f"(keys {sorted(layers)})")


def params_from_jax(tree, cfg: TransformerConfig,
                    device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    _check_layers(tree["layers"], cfg)
    out = _convert(tree, dev, cfg.param_dtype)
    if cfg.tied_embeddings != ("lm_head" not in out):
        raise ValueError("tied_embeddings does not match the tree's lm_head")
    return out


def vit_params_from_jax(tree, cfg, device=None) -> Dict[str, Any]:
    """The ViT tree (``patch_proj``, ``cls``, ``pos``, the stacked dense
    ``layers``, ``ln_f``, ``head``) for ``cfg``, a ``models.vit.ViTConfig``."""
    dev = resolve_device(device)
    _check_layers(tree["layers"], cfg.encoder_config())
    want = (cfg.patch_size * cfg.patch_size * 3, cfg.d_model)
    if tuple(np.shape(tree["patch_proj"])) != want:
        raise ValueError(f"patch_proj is {np.shape(tree['patch_proj'])}, "
                         f"the config asks for {want}")
    return _convert(tree, dev, cfg.param_dtype)
