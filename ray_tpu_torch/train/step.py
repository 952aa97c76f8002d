"""The LM, ViT and ResNet train steps, ported from
``ray_tpu/train/jax_step.py``.

``make_lm_train_step``, ``make_vit_train_step`` and
``make_resnet_train_step`` return the JAX versions' triple ``(init_fn,
step_fn, place_batch)``. The LM step's metrics are ``{loss, grad_norm,
step}``: the gradient of ``transformer_loss`` (attention through the flash
kernels on the card, each layer rematerialised when ``cfg.remat``; with
``cfg.num_experts`` each MLP is the MoE layer, and, as in the JAX step, no
load-balancing term is added to the loss), then AdamW as
``optax.adamw(learning_rate, weight_decay=weight_decay)``. The ViT step's
metrics are ``{loss, accuracy, step}``, from ``vit_loss`` and the same AdamW
at weight decay 0.05. The ResNet step's are ``{loss, accuracy, step}`` too,
from ``resnet_loss`` in train mode and SGD with Nesterov momentum; its state
holds the variables ``{"params", "batch_stats"}`` and each step replaces the
batch statistics with the forward's new ones.

With a mesh (``parallel.build_mesh``) each step is the JAX step on that
mesh, run by every rank of it with the same arguments and batch:
``place_batch`` shards the batch over the data axes, the params and the
optimizer's state are DTensors, and each gradient is redistributed to its
parameter's placements (the all-reduce over the data axes, a
reduce-scatter where fsdp shards the parameter). The metrics are global.

- ``make_lm_train_step(cfg, mesh)``: params and AdamW's moments placed by
  ``transformer_logical_axes`` and the rules; DTensor's sharding
  propagation inserts the collectives that XLA inserts (fsdp's gathers and
  reduce-scatters, tp's reductions), attention runs the kernels on each
  rank's local blocks, and the MoE layer is expert parallel over ``ep``.
- ``make_vit_train_step(cfg, mesh)``: the same, with the params placed by
  ``vit_logical_axes`` (the JAX step's axes tree).
- ``make_resnet_train_step(mesh)``: the variables replicated, as the JAX
  step's; the model runs on each rank's rows (``shard_map``) and
  BatchNorm's train-mode statistics are those of the global batch, as
  flax's under jit (``models/resnet.py``), so the new ``batch_stats`` are
  the same on every rank.

``mesh=None`` is one device.

The JAX step donates its state and returns a new one. Here the update is in
place: ``step_fn`` changes the params (and batch statistics) and the
optimizer's state it was given and returns a ``TrainState`` over the same
tensors, which saves a copy of the model and its moments per step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Union

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.resnet import ResNet, resnet50_apply, resnet_loss
from ray_tpu_torch.models.transformer import (TransformerConfig,
                                              _batch_on_mesh, _map_tree,
                                              transformer_init,
                                              transformer_logical_axes,
                                              transformer_loss)
from ray_tpu_torch.models.vit import (ViTConfig, vit_init, vit_logical_axes,
                                      vit_loss)
from ray_tpu_torch.parallel.mesh import data_axes
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, LogicalRules,
                                             batch_sharding, place,
                                             shard_map, shard_pytree)


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]
    opt_state: torch.optim.Optimizer   # AdamW's moments or SGD's momentum
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
    """One optimizer update in place of ``leaves`` (``state``'s trained
    tensors) with ``grads``; returns the next state."""
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.grad = g
        state.opt_state.step()
        for p in leaves:
            p.grad = None
    return TrainState(state.params, state.opt_state, state.step + 1)


def _adamw(learning_rate: float, weight_decay: float):
    # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the square
    # root, bias correction from step 1, decay on every leaf
    return lambda leaves: torch.optim.AdamW(
        leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay)


def _step_factory(init_params, optimizer, dev: torch.device,
                  trainable=lambda params: params):
    """``init_fn`` and ``place_batch`` of a train step: ``init_params(
    generator)`` makes fresh params on the device, and ``optimizer(leaves)``
    updates the leaves of ``trainable(params)``."""

    def init_fn(key: Union[torch.Generator, Dict[str, Any]]) -> TrainState:
        """From a ``torch.Generator`` on the device (as JAX's from a key), or
        from an existing params dict on the device, which is then trained in
        place (``convert`` gives one from JAX weights)."""
        params = init_params(key) if isinstance(key, torch.Generator) \
            else key
        leaves = _leaves(trainable(params))
        if leaves[0].device.type != dev.type:
            raise ValueError(f"params lie on {leaves[0].device}, the call "
                             f"asks for {dev}")
        for p in leaves:
            p.requires_grad_(True)
        return TrainState(params, optimizer(leaves), 0)

    def place_batch(batch):
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(dev)
                for k, v in batch.items()}

    return init_fn, place_batch


def make_lm_train_step(cfg: TransformerConfig, mesh=None, *,
                       learning_rate: float = 3e-4,
                       weight_decay: float = 0.01,
                       rules: LogicalRules = DEFAULT_RULES, device=None):
    """Returns (init_fn(generator | params) -> TrainState,
    step_fn(state, batch) -> (state, metrics), place_batch(batch) -> batch
    on the device). A batch is ``{"tokens": [B, S] int}`` with an optional
    ``"mask"`` [B, S]. With ``mesh`` (``parallel.build_mesh``, on the
    device's type) the step runs on every rank of it, each rank calling it
    with the same arguments and batch (module docstring)."""
    dev = resolve_device(device)
    if mesh is not None:
        return _mesh_lm_step(cfg, mesh, rules, learning_rate, weight_decay,
                             dev)
    init_fn, place_batch = _step_factory(
        lambda gen: transformer_init(gen, cfg, device=dev),
        _adamw(learning_rate, weight_decay), dev)

    def step_fn(state: TrainState, batch):
        leaves = _leaves(state.params)
        loss = transformer_loss(state.params, batch, cfg, device=dev)
        grads = torch.autograd.grad(loss, leaves)
        gnorm = global_norm(grads)   # before the update, no clipping
        state = _update(state, leaves, grads)
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

    return init_fn, step_fn, place_batch


def _mesh_factory(mesh, dev, init_params, axes_of, optimizer, rules,
                  trainable=lambda params: params):
    """``init_fn`` and ``place_batch`` of a step on ``mesh``: params from
    ``init_params(generator)`` or given, placed on the mesh by
    ``axes_of(params)`` (a logical axes tree) and the rules, and
    ``optimizer`` over the leaves of ``trainable(params)`` (its state
    placed alike)."""
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the call "
                         f"asks for {dev}")

    def init_fn(key) -> TrainState:
        """From a ``torch.Generator`` on the device, the same seed on every
        rank, or from a params dict (``convert`` gives one from JAX
        weights): placed on the mesh."""
        params = init_params(key) if isinstance(key, torch.Generator) \
            else key
        params = shard_pytree(params, mesh, axes_of(params), rules)
        leaves = _leaves(trainable(params))
        for p in leaves:
            p.requires_grad_(True)
        return TrainState(params, optimizer(leaves), 0)

    def place_batch(batch):
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v).to(dev)
            out[k] = place(v, batch_sharding(mesh, v.dim(), rules))
        return out

    return init_fn, place_batch


def _mesh_grads(loss, leaves):
    """The gradients of ``leaves``, each in its parameter's placements: the
    all-reduce over the data axes (a reduce-scatter where fsdp shards the
    parameter)."""
    grads = torch.autograd.grad(loss, leaves)
    return [g.redistribute(p.device_mesh, p.placements)
            for g, p in zip(grads, leaves)]


def _mesh_lm_step(cfg, mesh, rules, learning_rate, weight_decay, dev):
    axes = transformer_logical_axes(cfg)
    init_fn, place_batch = _mesh_factory(
        mesh, dev, lambda gen: transformer_init(gen, cfg, device=dev),
        lambda _: axes, _adamw(learning_rate, weight_decay), rules)

    def step_fn(state: TrainState, batch):
        leaves = _leaves(state.params)
        loss = transformer_loss(state.params, batch, cfg, mesh=mesh,
                                device=dev)
        grads = _mesh_grads(loss, leaves)
        gnorm = global_norm(grads).full_tensor()
        state = _update(state, leaves, grads)
        return state, {"loss": loss.detach().full_tensor(),
                       "grad_norm": gnorm, "step": state.step}

    return init_fn, step_fn, place_batch


def make_vit_train_step(cfg: ViTConfig, mesh=None, *,
                        learning_rate: float = 3e-4,
                        weight_decay: float = 0.05,
                        rules: LogicalRules = DEFAULT_RULES, device=None):
    """Returns (init_fn(generator | params) -> TrainState,
    step_fn(state, batch) -> (state, metrics), place_batch(batch) -> batch
    on the device). A batch is ``{"image": [B, H, W, 3] float, "label": [B]
    int}``; the metrics are ``{loss, accuracy, step}``. With ``mesh`` the
    step runs on every rank of it, the params placed by
    ``vit_logical_axes`` (module docstring)."""
    dev = resolve_device(device)
    adamw = _adamw(learning_rate, weight_decay)
    if mesh is not None:
        axes = vit_logical_axes(cfg)
        init_fn, place_batch = _mesh_factory(
            mesh, dev, lambda gen: vit_init(gen, cfg, device=dev),
            lambda _: axes, adamw, rules)
    else:
        init_fn, place_batch = _step_factory(
            lambda gen: vit_init(gen, cfg, device=dev), adamw, dev)

    def step_fn(state: TrainState, batch):
        leaves = _leaves(state.params)
        loss, acc = vit_loss(state.params, batch, cfg, mesh=mesh, device=dev)
        if mesh is None:
            grads = torch.autograd.grad(loss, leaves)
        else:
            grads = _mesh_grads(loss, leaves)
            loss, acc = loss.full_tensor(), acc.full_tensor()
        state = _update(state, leaves, grads)
        return state, {"loss": loss.detach(), "accuracy": acc,
                       "step": state.step}

    return init_fn, step_fn, place_batch


def _copy_tree_(dst, src) -> None:
    """Copy ``src``'s leaves into ``dst``'s tensors of the same keys."""
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_tree_(v, src[k])
        else:
            v.copy_(src[k])


def make_resnet_train_step(mesh=None, *, num_classes: int = 1000,
                           image_size: int = 224,
                           learning_rate: float = 0.1,
                           dtype=torch.bfloat16,
                           stage_sizes=(3, 4, 6, 3),
                           rules: LogicalRules = DEFAULT_RULES, device=None):
    """Returns (init_fn(generator | variables) -> TrainState,
    step_fn(state, batch) -> (state, metrics), place_batch(batch) -> batch
    on the device). A batch is ``{"image": [B, H, W, 3] float, "label": [B]
    int}``; the metrics are ``{loss, accuracy, step}``. ``state.params`` is
    the variables tree ``{"params", "batch_stats"}``; ``init_fn`` also takes
    one from ``convert.resnet_variables_from_jax``. ``image_size`` is the
    JAX signature's (the variables do not depend on it); ``stage_sizes``
    other than ResNet-50's make a smaller ResNet. With ``mesh`` the step
    runs on every rank of it, the variables replicated and BatchNorm's
    statistics global (module docstring).

    ``optax.sgd(learning_rate, momentum=0.9, nesterov=True)``
    (``jax_step.py:94``) is ``torch.optim.SGD`` with momentum 0.9, Nesterov,
    dampening 0 and no weight decay: both keep the trace t = g + 0.9 t from
    t = 0 (t = g at the first step) and step by -lr (g + 0.9 t)."""
    dev = resolve_device(device)
    model = ResNet(stage_sizes, num_classes, dtype)

    def sgd(leaves):
        return torch.optim.SGD(leaves, lr=learning_rate, momentum=0.9,
                               dampening=0.0, weight_decay=0.0, nesterov=True)

    if mesh is not None:
        return _mesh_resnet_step(model, mesh, sgd, rules, dev)
    init_fn, place_batch = _step_factory(
        lambda gen: model.init(gen, device=dev), sgd, dev,
        trainable=lambda variables: variables["params"])

    def step_fn(state: TrainState, batch):
        variables = state.params
        leaves = _leaves(variables["params"])
        logits, new_stats = resnet50_apply(model, variables, batch["image"],
                                           train=True, device=dev)
        labels = batch["label"].to(dev).long()
        loss = resnet_loss(logits, labels)
        grads = torch.autograd.grad(loss, leaves)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        state = _update(state, leaves, grads)
        with torch.no_grad():       # jax_step.py:124's new_vars
            _copy_tree_(variables["batch_stats"], new_stats)
        return state, {"loss": loss.detach(), "accuracy": acc,
                       "step": state.step}

    return init_fn, step_fn, place_batch


def _unflatten(ref, leaves):
    """A tree of ``ref``'s keys over ``leaves`` (in ``_leaves``' order)."""
    it = iter(leaves)

    def build(tree):
        return {k: build(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else next(it)
    return build(ref)


def _mesh_resnet_step(model, mesh, sgd, rules, dev):
    from torch.distributed.tensor.experimental import implicit_replication

    from ray_tpu_torch.parallel.collectives import axis_group
    init_fn, place_batch = _mesh_factory(
        mesh, dev, lambda gen: model.init(gen, device=dev),
        lambda variables: _map_tree(variables, lambda _: None), sgd, rules,
        trainable=lambda variables: variables["params"])
    rows = data_axes()

    def forward(variables, images):
        """-> (logits over the data axes, the new batch_stats' leaves)."""
        params, stats = variables["params"], variables["batch_stats"]
        n_params, n_stats = len(_leaves(params)), len(_leaves(stats))

        def body(images, *leaves):
            local = {"params": _unflatten(params, leaves[:n_params]),
                     "batch_stats": _unflatten(stats, leaves[n_params:])}
            x = images.to(model.dtype).permute(0, 3, 1, 2)
            logits, new = model(local, x, train=True,
                                group=axis_group(rows))
            return [logits] + _leaves_as(stats, new)

        out = shard_map(body, mesh,
                        [(rows, None, None, None)]
                        + [()] * (n_params + n_stats),
                        [(rows, None)] + [()] * n_stats)(
            images, *_leaves(params), *_leaves(stats))
        return out[0], out[1:]

    def step_fn(state: TrainState, batch):
        variables = state.params
        leaves = _leaves(variables["params"])
        logits, new_stats = forward(variables,
                                    _batch_on_mesh(batch["image"], mesh, dev))
        labels = _batch_on_mesh(batch["label"], mesh, dev).long()
        with implicit_replication():
            loss = resnet_loss(logits, labels)
            acc = (logits.detach().argmax(-1) == labels).float().mean()
        state = _update(state, leaves, _mesh_grads(loss, leaves))
        with torch.no_grad():       # jax_step.py:124's new_vars
            for dst, src in zip(_leaves(variables["batch_stats"]),
                                new_stats):
                dst.copy_(src)
        return state, {"loss": loss.detach().full_tensor(),
                       "accuracy": acc.full_tensor(), "step": state.step}

    return init_fn, step_fn, place_batch


def _leaves_as(ref, tree):
    """``tree``'s leaves in the key order of ``ref``."""
    if isinstance(ref, dict):
        return [leaf for k in ref for leaf in _leaves_as(ref[k], tree[k])]
    return [tree]
