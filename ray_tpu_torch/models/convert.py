"""Weights from the JAX package into the port.

``params_from_jax`` takes the tree that ``ray_tpu.models.transformer_init``
returns (dense, or with the stacked ``moe`` subtree of an MoE model),
``vit_params_from_jax`` the tree of ``ray_tpu.models.vit_init`` and
``resnet_variables_from_jax`` the ``{"params", "batch_stats"}`` tree of a
flax ``ResNet`` and ``rl_params_from_jax`` the tree of an RL catalog
module (``ray_tpu.rl.module``), with every leaf already turned into a numpy
array by the caller (for example ``jax.tree.map(np.asarray, params)``).
Each returns the port's tree: the same keys, as torch tensors, in the same
layout except the conv kernels (HWIO to OIHW). Both stacks then compute the
same function. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.resnet import ResNet, resnet50
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


def _shapes(tree, shape=np.shape, path=""):
    """{"a/0/c": shape(leaf)} of a tree's leaves (dicts and lists)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_shapes(v, shape, f"{path}{k}/"))
        else:
            out[f"{path}{k}"] = tuple(shape(v))
    return out


def _shape_diff(have, want) -> str:
    diff = sorted(f"{k}: {have.get(k, 'missing')}, want {want.get(k, 'none')}"
                  for k in have.keys() | want.keys()
                  if have.get(k) != want.get(k))
    return "; ".join(diff[:6]) + (" ..." if len(diff) > 6 else "")


def resnet_variables_from_jax(variables, model: Optional[ResNet] = None,
                              device=None) -> Dict[str, Any]:
    """flax's ``{"params", "batch_stats"}`` tree of ``model`` (default
    ``resnet50()``: stages (3, 4, 6, 3), 1000 classes) -> the port's tree on
    the device, f32. Conv kernels go from HWIO to OIHW, once; the Dense
    kernel stays [in, out]. A tree of other stage sizes or another class
    count raises, naming the leaves that differ."""
    dev = resolve_device(device)
    model = resnet50() if model is None else model

    def to_port(tree):
        return {k: to_port(v) if isinstance(v, dict)
                else np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)))
                if k == "kernel" and np.ndim(v) == 4 else v
                for k, v in tree.items()}

    tree = to_port({k: variables.get(k, {}) for k in ("params",
                                                     "batch_stats")})
    diff = _shape_diff(_shapes(tree),
                       _shapes(model.variable_shapes(), shape=tuple))
    if diff:
        raise ValueError(
            f"the variables are not those of ResNet(stage_sizes="
            f"{model.stage_sizes}, num_classes={model.num_classes}): "
            + diff)
    return _convert(tree, dev, torch.float32)


def _map_rl(tree, fn, key=None):
    """``fn(key, leaf)`` over an RL params tree (dicts and lists), with the
    leaf's own key."""
    if isinstance(tree, dict):
        return {k: _map_rl(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_rl(v, fn, key) for v in tree]
    return fn(key, tree)


def _conv_kernel(key, leaf) -> bool:
    return key == "w" and np.ndim(leaf) == 4


def rl_params_from_jax(params, module, device=None):
    """The params tree of a ``ray_tpu.rl.module`` catalog module (numpy
    leaves, as ``ray_tpu.rl.learner.PPOLearner.get_weights`` returns it) ->
    the port's f32 tree for ``module`` (a ``ray_tpu_torch.rl.module`` module
    of the same sizes) on the device. The keys stay; the conv kernels go from
    HWIO to OIHW, once. The heads' first layer keeps its rows: the port's
    ``ConvRLModule`` flattens its features in the JAX module's NHWC order.
    A tree whose shapes do not fit the module raises, naming the leaves."""
    dev = resolve_device(device)
    tree = _map_rl(params, lambda k, v: np.ascontiguousarray(
        np.transpose(v, (3, 2, 0, 1))) if _conv_kernel(k, v)
        else np.asarray(v))
    want = _shapes(module.init(torch.Generator(), device="cpu"),
                   shape=lambda t: t.shape)
    diff = _shape_diff(_shapes(tree), want)
    if diff:
        raise ValueError(f"the params do not fit {type(module).__name__}: "
                         + diff)
    return _map_rl(tree, lambda k, v: torch.from_numpy(np.array(v)).to(
        device=dev, dtype=torch.float32))


def rl_params_to_numpy(params):
    """The port's RL params tree -> numpy leaves in the JAX package's layout
    (HWIO conv kernels): what ``rl_params_from_jax`` and the JAX package's
    ``set_weights`` take."""
    def leaf(k, v):
        a = v.detach().to("cpu", copy=True).numpy()   # never the live tensor
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0))) \
            if _conv_kernel(k, a) else a
    return _map_rl(params, leaf)


def rl_tree_from_jax(tree, like, device=None):
    """A plain params tree of a JAX RL learner (numpy leaves: SAC's ``{pi,
    q1, q2, log_alpha}``, TD3's ``{actor, q1, q2}``, CQL's ``{q}``, DQN's
    and the offline learners' module trees) -> the port's f32 tensors on
    the device, leaf for leaf. ``like`` is the port learner's own tree: every
    leaf's shape must fit it (a 0-d ``log_alpha`` too), or this raises,
    naming the leaves that do not."""
    dev = resolve_device(device)
    tree = _map_rl(tree, lambda _, v: np.asarray(v))
    diff = _shape_diff(_shapes(tree),
                       _shapes(like, shape=lambda t: tuple(t.shape)))
    if diff:
        raise ValueError(f"the tree does not fit the learner's: {diff}")
    return _map_rl(tree, lambda _, v: torch.from_numpy(
        np.array(v, dtype=np.float32)).to(dev))
