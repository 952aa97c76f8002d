"""The RLModule catalog (policy/value networks), ported from
``ray_tpu/rl/module.py``.

Functional like the JAX package: each module is a description (sizes) with
``init(generator, device=None)`` returning a params tree of tensors, key for
key the JAX tree (``pi``, ``vf``, ``conv``, ``lstm``, ``embed``, ``blocks``),
and pure forwards over it. A forward runs on the device its params lie on;
observations are moved there. Random draws come from the ``torch.Generator``
a caller passes, which must live on that device.

Encoders: ``RLModule`` (MLP towers), ``ConvRLModule`` (VALID convolutions
on NHWC observations, flattened in NHWC order), ``RecurrentRLModule``
(an LSTM cell stepped over T, carry zeroed after a done) and
``AttentionRLModule`` (GTrXL: norm-first one-query attention over a memory
of M past states, GRU-gated residuals). Distributions are categorical
(discrete) or diagonal gaussian (continuous; ``action_dim`` 1 squeezes to
[B]).

The MLP here is the JAX RL module's own (tanh, optional ``activate_last``),
not ``models/mlp.py``'s ReLU ``mlp_apply``; only the init is shared.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import mlp as _mlp

_LOG_2PI = math.log(2 * math.pi)


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             device=None) -> list:
    """[{"w": [in, out], "b": [out]}, ...] in f32: He-normal weights
    (variance 2 / in), zero biases, as ``ray_tpu.rl.module.mlp_init``."""
    return _mlp.mlp_init(generator, sizes, device=device)


def mlp_apply(params: list, x, activate_last: bool = False):
    """tanh after every layer but the last (and after the last too when
    ``activate_last``)."""
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1 or activate_last:
            x = torch.tanh(x)
    return x


def _normal(generator, shape, scale, dev):
    return torch.empty(shape, device=dev).normal_(generator=generator) * scale


def _first_leaf(tree):
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _as_input(params, x):
    """``x`` (numpy or tensor) as a tensor on the params' device, in their
    dtype."""
    leaf = _first_leaf(params)
    return torch.as_tensor(x).to(device=leaf.device, dtype=leaf.dtype)


class _Distribution:
    """Categorical (``num_actions`` > 0) or diagonal gaussian (``num_actions``
    -1, head [B, 2k] = mean and log-std) over a head's logits."""

    num_actions: int
    action_dim: int

    def _mean_logstd(self, logits):
        """Continuous head: [B, 2k] -> mean [B, k], log_std [B, k] (k=1
        squeezes to [B] to keep 1-D env arrays unchanged)."""
        k = self.action_dim
        mean, log_std = logits[..., :k], logits[..., k:]
        if k == 1:
            mean, log_std = mean[..., 0], log_std[..., 0]
        return mean, log_std

    def dist_sample(self, logits, generator):
        """-> (actions, logp): categorical by Gumbel-max (as
        ``jax.random.categorical``), gaussian by mean + std · N(0, 1)."""
        if self.num_actions > 0:
            # -log(E), E ~ Exp(1), is a standard Gumbel draw
            e = torch.empty_like(logits).exponential_(generator=generator)
            actions = torch.argmax(logits - e.log(), dim=-1)
            logp = torch.log_softmax(logits, -1).gather(
                -1, actions[..., None])[..., 0]
            return actions, logp
        mean, log_std = self._mean_logstd(logits)
        eps = torch.empty_like(mean).normal_(generator=generator)
        actions = mean + torch.exp(log_std) * eps
        logp = -0.5 * (eps ** 2 + 2 * log_std + _LOG_2PI)
        if logp.ndim > 1:
            logp = logp.sum(-1)    # diagonal: sum per-dim logps
        return actions, logp

    def dist_logp_entropy(self, logits, actions):
        """-> (logp, entropy) of ``actions`` under the head's logits."""
        if self.num_actions > 0:
            logp_all = torch.log_softmax(logits, -1)
            idx = torch.as_tensor(actions, device=logits.device).long()
            logp = logp_all.gather(-1, idx[..., None])[..., 0]
            entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
            return logp, entropy
        mean, log_std = self._mean_logstd(logits)
        actions = torch.as_tensor(actions, device=logits.device,
                                  dtype=logits.dtype)
        z = (actions - mean) / torch.exp(log_std)
        logp = -0.5 * (z ** 2 + 2 * log_std + _LOG_2PI)
        entropy = log_std + 0.5 * math.log(2 * math.pi * math.e)
        if logp.ndim > 1:
            logp = logp.sum(-1)
            entropy = entropy.sum(-1)
        return logp, entropy

    def dist_greedy(self, logits):
        if self.num_actions > 0:
            return torch.argmax(logits, dim=-1)
        return self._mean_logstd(logits)[0]


class RLModule(_Distribution):
    """Policy + value MLPs with shared-nothing towers."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), action_dim: int = 1):
        self.obs_dim = obs_dim
        self.num_actions = num_actions   # -1 => continuous gaussian
        self.action_dim = action_dim     # continuous dims (k); discrete: n/a
        self.hiddens = tuple(hiddens)
        self.out_dim = num_actions if num_actions > 0 else 2 * action_dim

    def _features(self, params, obs):
        return _as_input(params, obs)

    def _feature_dim(self) -> int:
        return self.obs_dim

    def init(self, generator: torch.Generator,
             device=None) -> Dict[str, Any]:
        dev = resolve_device(device)
        feat = self._feature_dim()
        return {
            "pi": mlp_init(generator, (feat, *self.hiddens, self.out_dim),
                           dev),
            "vf": mlp_init(generator, (feat, *self.hiddens, 1), dev),
        }

    def apply(self, params, obs):
        """-> (logits [B, A], value [B])."""
        feat = self._features(params, obs)
        logits = mlp_apply(params["pi"], feat)
        value = mlp_apply(params["vf"], feat)[..., 0]
        return logits, value

    def sample_actions(self, params, obs, generator: torch.Generator):
        """-> (actions, logp, value): one batched forward and draw."""
        logits, value = self.apply(params, obs)
        actions, logp = self.dist_sample(logits, generator)
        return actions, logp, value

    def logp_entropy(self, params, obs, actions):
        """-> (logp, entropy, value) for train-time evaluation."""
        logits, value = self.apply(params, obs)
        logp, entropy = self.dist_logp_entropy(logits, actions)
        return logp, entropy, value

    def greedy_actions(self, params, obs):
        logits, _ = self.apply(params, obs)
        return self.dist_greedy(logits)


class ConvRLModule(RLModule):
    """CNN-encoded policy/value. Obs arrive FLATTENED [B, H*W*C] (the
    vectorized env convention) and are read as NHWC, as in the JAX module.
    The convolutions run on the NCHW view of that tensor (``conv2d`` with
    OIHW kernels, VALID = no padding; channels_last in memory, so no copy),
    and the features are flattened after permuting back to NHWC: the heads'
    first layer sees the JAX module's feature order, and the converter
    leaves the head weights as they are.

    filters: sequence of (out_channels, kernel, stride)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 obs_shape: Sequence[int],
                 filters: Sequence[Sequence[int]] = ((16, 3, 2), (32, 3, 2)),
                 hiddens: Sequence[int] = (128,), action_dim: int = 1):
        if int(np.prod(obs_shape)) != obs_dim:
            raise ValueError(f"obs_shape {obs_shape} != obs_dim {obs_dim}")
        super().__init__(obs_dim, num_actions, hiddens, action_dim)
        self.obs_shape = tuple(obs_shape)          # (H, W, C)
        self.filters = tuple(tuple(f) for f in filters)

    def _conv_out_dim(self) -> int:
        h, w, c = self.obs_shape
        for (c_out, k, s) in self.filters:
            h = (h - k) // s + 1
            w = (w - k) // s + 1
            c = c_out
        return h * w * c

    _feature_dim = _conv_out_dim

    def init(self, generator: torch.Generator,
             device=None) -> Dict[str, Any]:
        dev = resolve_device(device)
        conv = []
        c_in = self.obs_shape[-1]
        for (c_out, k, _) in self.filters:
            conv.append({
                "w": _normal(generator, (c_out, c_in, k, k),
                             (2.0 / (k * k * c_in)) ** 0.5, dev),
                "b": torch.zeros(c_out, device=dev),
            })
            c_in = c_out
        return {"conv": conv, **super().init(generator, dev)}

    def _features(self, params, obs):
        x = _as_input(params, obs)
        x = x.reshape((x.shape[0],) + self.obs_shape).permute(0, 3, 1, 2)
        for layer, (_, _, s) in zip(params["conv"], self.filters):
            x = torch.relu(F.conv2d(x, layer["w"], layer["b"], stride=s))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order


def lstm_init(generator: torch.Generator, in_dim: int, hidden: int,
              device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    scale = (1.0 / hidden) ** 0.5
    return {"wx": _normal(generator, (in_dim, 4 * hidden), scale, dev),
            "wh": _normal(generator, (hidden, 4 * hidden), scale, dev),
            "b": torch.zeros(4 * hidden, device=dev)}


def lstm_step(params, carry, x):
    """One LSTM cell step: carry=(h, c), x [B, D]. Gates i, f, g, o from
    ``x@wx + h@wh + b``, the forget gate biased by +1 (not ``nn.LSTM``'s)."""
    h, c = carry
    gates = x @ params["wx"] + h @ params["wh"] + params["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def _prev_dones(dones_seq, ref):
    """dones[t] = 1 ends the episode AFTER obs[t]: the state is reset before
    step t + 1, never before step t. -> [T, B] masks 1 - dones[t - 1]."""
    d = torch.as_tensor(dones_seq).to(device=ref.device, dtype=ref.dtype)
    return 1.0 - torch.cat([torch.zeros_like(d[:1]), d[:-1]], dim=0)


class RecurrentRLModule(_Distribution):
    """LSTM policy/value. Sequence-first: ``apply_seq`` consumes [T, B, D]
    with an explicit carried state, stepping the cell over T (a cuDNN LSTM
    over the whole sequence could not zero the carry between steps).
    ``dones`` resets the carry mid-sequence."""

    def __init__(self, obs_dim: int, num_actions: int, hidden_size: int = 64,
                 action_dim: int = 1):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.action_dim = action_dim
        self.hidden_size = hidden_size
        self.out_dim = num_actions if num_actions > 0 else 2 * action_dim

    def init(self, generator: torch.Generator,
             device=None) -> Dict[str, Any]:
        dev = resolve_device(device)
        return {
            "lstm": lstm_init(generator, self.obs_dim, self.hidden_size, dev),
            "pi": mlp_init(generator, (self.hidden_size, self.out_dim), dev),
            "vf": mlp_init(generator, (self.hidden_size, 1), dev),
        }

    def initial_state(self, batch: int, device=None):
        z = torch.zeros(batch, self.hidden_size,
                        device=resolve_device(device))
        return (z, z)

    def apply_seq(self, params, obs_seq, state, dones_seq=None):
        """obs_seq [T, B, D], state (h, c) -> (logits [T, B, A],
        values [T, B], final_state)."""
        xs = _as_input(params, obs_seq)
        keep = None if dones_seq is None else _prev_dones(dones_seq, xs)
        carry, hs = tuple(state), []
        for t in range(xs.shape[0]):
            if keep is not None:
                m = keep[t][:, None]
                carry = (carry[0] * m, carry[1] * m)
            carry, h = lstm_step(params["lstm"], carry, xs[t])
            hs.append(h)
        hs = torch.stack(hs)
        logits = mlp_apply(params["pi"], hs)
        values = mlp_apply(params["vf"], hs)[..., 0]
        return logits, values, carry


def make_module(spec: Dict[str, Any]):
    """Module factory from a module_spec dict. encoder: "mlp" (default) |
    "cnn" | "lstm" | "gtrxl" (= "attention")."""
    spec = dict(spec)
    encoder = spec.pop("encoder", "mlp")
    if encoder == "mlp":
        return RLModule(**spec)
    if encoder == "cnn":
        return ConvRLModule(**spec)
    if encoder == "lstm":
        spec.pop("hiddens", None)
        return RecurrentRLModule(**spec)
    if encoder in ("gtrxl", "attention"):
        spec.pop("hiddens", None)
        return AttentionRLModule(**spec)
    raise ValueError(f"unknown encoder {encoder!r}")


# ---------------------------------------------------------------------------
# GTrXL: gated transformer-XL encoder (attention catalog entry)
# ---------------------------------------------------------------------------

def _gru_gate_init(generator: torch.Generator, dim: int,
                   device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    scale = (1.0 / dim) ** 0.5
    lin = {k: _normal(generator, (2 * dim, dim), scale, dev)
           for k in ("wr", "wz", "wh")}
    # bg > 0 biases the update gate toward IDENTITY at init (GTrXL,
    # arXiv:1910.06764 eq. 6): each block starts as a skip connection.
    return {**lin, "bg": torch.full((dim,), 2.0, device=dev)}


def _gru_gate(params, x, y):
    """GRU-style gating g(x, y): x = stream (skip), y = block output."""
    xy = torch.cat([x, y], dim=-1)
    r = torch.sigmoid(xy @ params["wr"])
    z = torch.sigmoid(xy @ params["wz"] - params["bg"])
    h = torch.tanh(torch.cat([r * x, y], dim=-1) @ params["wh"])
    return (1.0 - z) * x + z * h


class AttentionRLModule(_Distribution):
    """GTrXL-style policy/value net: L blocks of layer-norm-first attention
    over a sliding window of M past hidden states (the TrXL memory), each
    sublayer merged into the residual stream through a GRU gate biased to
    identity. ``apply_seq`` consumes [T, B, D] plus a memory [L, B, M, H]
    and returns (logits, values, new memory). The attention is one query
    against M + 1 rows with no mask (``torch.einsum``, as the JAX module's
    ``jnp.einsum``; the flash kernel does not run here)."""

    def __init__(self, obs_dim: int, num_actions: int, *,
                 hidden_size: int = 64, num_layers: int = 2,
                 num_heads: int = 4, memory_len: int = 16,
                 action_dim: int = 1):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.action_dim = action_dim
        self.h = hidden_size
        self.layers = num_layers
        self.heads = num_heads
        self.mem = memory_len
        self.out_dim = num_actions if num_actions > 0 else 2 * action_dim

    def init(self, generator: torch.Generator,
             device=None) -> Dict[str, Any]:
        dev = resolve_device(device)
        h, scale = self.h, (1.0 / self.h) ** 0.5
        params: Dict[str, Any] = {
            "embed": mlp_init(generator, (self.obs_dim, h), dev),
            "pi": mlp_init(generator, (h, self.out_dim), dev),
            "vf": mlp_init(generator, (h, 1), dev),
            "blocks": [],
        }
        for _ in range(self.layers):
            block = {k: _normal(generator, (h, h), scale, dev)
                     for k in ("wq", "wk", "wv", "wo")}
            block.update({
                "ff1": mlp_init(generator, (h, 4 * h), dev),
                "ff2": mlp_init(generator, (4 * h, h), dev),
                "gate_attn": _gru_gate_init(generator, h, dev),
                "gate_ff": _gru_gate_init(generator, h, dev),
            })
            params["blocks"].append(block)
        return params

    def initial_state(self, batch: int, device=None):
        return torch.zeros(self.layers, batch, self.mem, self.h,
                           device=resolve_device(device))

    @staticmethod
    def _norm(x):
        """Parameter-free layer norm: population variance, eps inside the
        sqrt."""
        mu = x.mean(-1, keepdim=True)
        sd = torch.sqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
        return (x - mu) / sd

    def _block(self, bp, x, mem_l):
        """x [B, H]; mem_l [B, M, H] (oldest..newest) -> (out, new_mem)."""
        B = x.shape[0]
        hd = self.h // self.heads
        ctx = torch.cat([mem_l, x[:, None, :]], dim=1)   # [B, M+1, H]
        xin = self._norm(x)
        cin = self._norm(ctx)
        q = (xin @ bp["wq"]).reshape(B, self.heads, hd)
        k = (cin @ bp["wk"]).reshape(B, -1, self.heads, hd)
        v = (cin @ bp["wv"]).reshape(B, -1, self.heads, hd)
        att = torch.einsum("bhd,bmhd->bhm", q, k) / math.sqrt(hd)
        att = torch.softmax(att, dim=-1)
        y = torch.einsum("bhm,bmhd->bhd", att, v).reshape(B, self.h)
        y = torch.relu(y @ bp["wo"])
        x = _gru_gate(bp["gate_attn"], x, y)
        f = mlp_apply(bp["ff2"], mlp_apply(bp["ff1"], self._norm(x),
                                           activate_last=True))
        x = _gru_gate(bp["gate_ff"], x, f)
        new_mem = torch.cat([mem_l[:, 1:], x[:, None, :]], dim=1)
        return x, new_mem

    def apply_seq(self, params, obs_seq, state, dones_seq=None):
        """obs_seq [T, B, D], state [L, B, M, H] -> (logits [T, B, A],
        values [T, B], final_state). dones zero an env's whole memory AFTER
        a terminal step (as RecurrentRLModule)."""
        xs = _as_input(params, obs_seq)
        keep = None if dones_seq is None else _prev_dones(dones_seq, xs)
        mem, hs = state, []
        for t in range(xs.shape[0]):
            if keep is not None:
                mem = mem * keep[t][None, :, None, None]
            h = mlp_apply(params["embed"], xs[t], activate_last=True)
            new_mem = []
            for li in range(self.layers):
                h, m = self._block(params["blocks"][li], h, mem[li])
                new_mem.append(m)
            mem = torch.stack(new_mem)
            hs.append(h)
        hs = torch.stack(hs)
        logits = mlp_apply(params["pi"], hs)
        values = mlp_apply(params["vf"], hs)[..., 0]
        return logits, values, mem
