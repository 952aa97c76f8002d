"""PPOLearner: the clipped-surrogate PPO update on one device. Ported from
``ray_tpu/rl/learner.py``.

The loss is the JAX learner's (ratio clip, clipped value loss, entropy
bonus, kl stat; advantages normalised per minibatch with the population
std). The optimizer is optax's ``chain(clip_by_global_norm, adam)``:
``clip_by_global_norm_`` below, then ``torch.optim.Adam`` (optax's adam:
betas (0.9, 0.999), eps 1e-8, no weight decay). Minibatches follow the JAX
learner's numpy ``default_rng(seed)``: one ``permutation`` an epoch, the
remainder dropped, so both learners given the same weights and seed see the
same rows in the same order. ``LearnerGroup`` and the learner's ``mesh``
wait for the port's runtime and parallel ops.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.module import make_module
from ray_tpu_torch.rl.rollout import place_params
from ray_tpu_torch.rl.sample_batch import SampleBatch

# the columns the loss reads: only these go to the device
LOSS_COLUMNS = (sb.OBS, sb.ACTIONS, sb.ACTION_LOGP, sb.ADVANTAGES,
                sb.VF_PREDS, sb.VALUE_TARGETS)


def _named_leaves(tree, prefix="") -> Dict[str, torch.Tensor]:
    """{"pi/0/w": leaf, ...}: leaves by path, so that two trees pair up by
    key whatever order their dicts hold."""
    if not isinstance(tree, (dict, list, tuple)):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_named_leaves(v, f"{prefix}/{k}"))
    return out


def ppo_loss(module, params, batch, *, clip_param: float,
             vf_clip_param: float, vf_loss_coeff: float,
             entropy_coeff: float):
    """-> (total loss, stats) of one minibatch (a dict of tensors)."""
    logp, entropy, value = module.logp_entropy(
        params, batch[sb.OBS], batch[sb.ACTIONS])
    adv = batch[sb.ADVANTAGES]
    # jnp's std is the population std (ddof 0), not torch.std's default
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ratio = torch.exp(logp - batch[sb.ACTION_LOGP])
    surr = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv)
    pi_loss = -surr.mean()
    vf_err = (value - batch[sb.VALUE_TARGETS]) ** 2
    vf_clipped = batch[sb.VF_PREDS] + torch.clamp(
        value - batch[sb.VF_PREDS], -vf_clip_param, vf_clip_param)
    vf_err2 = (vf_clipped - batch[sb.VALUE_TARGETS]) ** 2
    vf_loss = torch.maximum(vf_err, vf_err2).mean()
    ent = entropy.mean()
    total = pi_loss + vf_loss_coeff * vf_loss - entropy_coeff * ent
    return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                   "entropy": ent,
                   "kl": (batch[sb.ACTION_LOGP] - logp).mean()}


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: below ``max_norm`` the
    gradients stay as they are (scaled by exactly 1), else they are scaled
    by ``max_norm / norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6``). A handful of kernels and no host sync. -> the global
    norm."""
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class PPOLearner:
    """Minibatch-SGD PPO on one device (``None`` = the card)."""

    def __init__(self, module_spec: dict, *, lr: float = 3e-4,
                 clip_param: float = 0.2, vf_clip_param: float = 10.0,
                 vf_loss_coeff: float = 0.5, entropy_coeff: float = 0.0,
                 num_sgd_iter: int = 6, sgd_minibatch_size: int = 128,
                 grad_clip: float = 0.5, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.module = make_module(module_spec)
        self.num_sgd_iter = num_sgd_iter
        self.minibatch_size = sgd_minibatch_size
        self.grad_clip = grad_clip
        self.loss_kw = dict(clip_param=clip_param,
                            vf_clip_param=vf_clip_param,
                            vf_loss_coeff=vf_loss_coeff,
                            entropy_coeff=entropy_coeff)
        self._rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = self.module.init(gen, device=self.device)
        self._named = _named_leaves(self.params)
        self._leaves = list(self._named.values())
        for p in self._leaves:
            p.requires_grad_(True)
        self.opt = torch.optim.Adam(self._leaves, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=0.0)

    def sgd_step(self, minibatch) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on a minibatch of device tensors -> its
        stats as 0-d tensors (no host sync)."""
        loss, stats = ppo_loss(self.module, self.params, minibatch,
                               **self.loss_kw)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        clip_by_global_norm_([p.grad for p in self._leaves], self.grad_clip)
        self.opt.step()
        return {k: v.detach() for k, v in
                {**stats, "total_loss": loss}.items()}

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        """Minibatch-SGD epochs over one train batch -> the last
        minibatch's stats as floats ({} for an empty batch). The batch goes
        to the device once and is indexed there with the JAX learner's
        permutations."""
        if batch.count == 0:
            return {}     # faulted rollout round: nothing to learn from
        # 0 => whole batch; larger-than-batch clamps down (the JAX
        # minibatches() would yield nothing and silently skip the update)
        size = min(self.minibatch_size or batch.count, batch.count)
        cols = {k: torch.as_tensor(np.asarray(batch[k])).to(
            device=self.device, dtype=torch.float32) for k in LOSS_COLUMNS}
        stats = {}
        for _ in range(self.num_sgd_iter):
            perm = torch.from_numpy(
                self._rng.permutation(batch.count)).to(self.device)
            for start in range(0, batch.count - size + 1, size):
                idx = perm[start:start + size]
                stats = self.sgd_step({k: v[idx] for k, v in cols.items()})
        return {k: float(v) for k, v in stats.items()}

    def get_weights(self):
        """The weights on the host as numpy, in the JAX package's layout
        (HWIO conv kernels): what either stack's ``set_weights`` takes."""
        return rl_params_to_numpy(self.params)

    @torch.no_grad()
    def set_weights(self, params) -> bool:
        """Copy ``params`` (a numpy tree as ``get_weights`` of either stack
        returns, or the port's tensors) into the learner's; the optimizer's
        state stays, as in the JAX learner."""
        new = _named_leaves(place_params(params, self.module, self.device))
        for name, p in self._named.items():
            p.copy_(new[name])
        return True
