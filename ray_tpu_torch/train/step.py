"""The LM and ViT train steps, ported from ``ray_tpu/train/jax_step.py``.

``make_lm_train_step`` and ``make_vit_train_step`` return the JAX versions'
triple ``(init_fn, step_fn, place_batch)``. The LM step's metrics are
``{loss, grad_norm, step}``: the gradient of ``transformer_loss`` (attention
through the flash kernels on the card, each layer rematerialised when
``cfg.remat``; with ``cfg.num_experts`` each MLP is the MoE layer, and, as in
the JAX step, no load-balancing term is added to the loss), then AdamW as
``optax.adamw(learning_rate, weight_decay=weight_decay)``. The ViT step's
metrics are ``{loss, accuracy, step}``, from ``vit_loss`` and the same AdamW
at weight decay 0.05.

One device, no mesh. The JAX version places params, optimizer state and
batch on a mesh and lets XLA insert the collectives; sharding comes to the
port with its parallel slice (ROADMAP.md A.5), as does the ResNet step
(A.8).

The JAX step donates its state and returns a new one. Here the update is in
place: ``step_fn`` changes the params and the optimizer's moments it was
given and returns a ``TrainState`` over the same tensors, which saves a copy
of the model and its moments per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Union

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import (TransformerConfig, check_device,
                                              transformer_init,
                                              transformer_loss)
from ray_tpu_torch.models.vit import ViTConfig, vit_init, vit_loss


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]
    opt_state: torch.optim.Optimizer   # holds AdamW's moments and step count
    step: int


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree, in the tree's key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all elements of all tensors."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def _update(state: TrainState, leaves, grads) -> TrainState:
    """One AdamW update in place of ``leaves`` (``state``'s params) with
    ``grads``; returns the next state."""
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.grad = g
        state.opt_state.step()
        for p in leaves:
            p.grad = None
    return TrainState(state.params, state.opt_state, state.step + 1)


def _step_factory(init_params, check_key: str, learning_rate: float,
                  weight_decay: float, dev: torch.device):
    """``init_fn`` and ``place_batch`` of a train step: ``init_params(
    generator)`` makes fresh params on the device."""

    def init_fn(key: Union[torch.Generator, Dict[str, Any]]) -> TrainState:
        """From a ``torch.Generator`` on the device (as JAX's from a key), or
        from an existing params dict on the device, which is then trained in
        place (``convert`` gives one from JAX weights)."""
        if isinstance(key, torch.Generator):
            params = init_params(key)
        else:
            params = key
            check_device(params, dev, key=check_key)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the
        # square root, bias correction from step 1, decay on every leaf
        opt = torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=weight_decay)
        return TrainState(params, opt, 0)

    def place_batch(batch):
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(dev)
                for k, v in batch.items()}

    return init_fn, place_batch


def make_lm_train_step(cfg: TransformerConfig, *,
                       learning_rate: float = 3e-4,
                       weight_decay: float = 0.01, device=None):
    """Returns (init_fn(generator | params) -> TrainState,
    step_fn(state, batch) -> (state, metrics), place_batch(batch) -> batch
    on the device). A batch is ``{"tokens": [B, S] int}`` with an optional
    ``"mask"`` [B, S]."""
    dev = resolve_device(device)
    init_fn, place_batch = _step_factory(
        lambda gen: transformer_init(gen, cfg, device=dev), "embed",
        learning_rate, weight_decay, dev)

    def step_fn(state: TrainState, batch):
        leaves = _leaves(state.params)
        loss = transformer_loss(state.params, batch, cfg, device=dev)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = global_norm(grads)   # before the update, no clipping
        state = _update(state, leaves, grads)
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

    return init_fn, step_fn, place_batch


def make_vit_train_step(cfg: ViTConfig, *, learning_rate: float = 3e-4,
                        weight_decay: float = 0.05, device=None):
    """Returns (init_fn(generator | params) -> TrainState,
    step_fn(state, batch) -> (state, metrics), place_batch(batch) -> batch
    on the device). A batch is ``{"image": [B, H, W, 3] float, "label": [B]
    int}``; the metrics are ``{loss, accuracy, step}``."""
    dev = resolve_device(device)
    init_fn, place_batch = _step_factory(
        lambda gen: vit_init(gen, cfg, device=dev), "patch_proj",
        learning_rate, weight_decay, dev)

    def step_fn(state: TrainState, batch):
        leaves = _leaves(state.params)
        loss, acc = vit_loss(state.params, batch, cfg, device=dev)
        state = _update(state, leaves, torch.autograd.grad(loss, leaves))
        return state, {"loss": loss.detach(), "accuracy": acc,
                       "step": state.step}

    return init_fn, step_fn, place_batch
