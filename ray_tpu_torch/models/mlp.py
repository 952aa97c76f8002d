"""Tiny MLP, ported from ``ray_tpu/models/mlp.py``: the unit-test and
CartPole-policy workhorse. Params are a list of ``{"w": [in, out], "b":
[out]}`` dicts, as in the JAX package."""

from __future__ import annotations

from typing import Sequence

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import check_device


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float32, device=None):
    """sizes: [in, hidden..., out]. Weights normal with variance 2 / in (He),
    biases 0. ``generator`` must live on the target device."""
    dev = resolve_device(device)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.empty(a, b, dtype=dtype, device=dev).normal_(
            generator=generator) * (2.0 / a) ** 0.5
        params.append({"w": w, "b": torch.zeros(b, dtype=dtype, device=dev)})
    return params


def mlp_apply(params, x, activation=torch.relu, *, device=None):
    """x [..., in] -> [..., out]: ``activation`` after every layer but the
    last."""
    dev = resolve_device(device)
    if params:
        check_device(params[0], dev, key="w")
    x = x.to(dev)
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = activation(x)
    return x
