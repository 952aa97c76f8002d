"""PPOLearner: the clipped-surrogate PPO update on one device. Ported from
``ray_tpu/rl/learner.py``. Also the pieces every port learner shares: a
catalog module's weights with their optimizer (``ModuleLearner``, which the
APPO learner extends too), optax's ``adam``, and the plain-tree helpers the
off-policy and offline learners use (``trainable_``, ``clone_tree``,
``copy_tree_`` from a JAX numpy tree, ``polyak_`` and ``batch_to_device``).

The loss is the JAX learner's (ratio clip, clipped value loss, entropy
bonus, kl stat; advantages normalised per minibatch with the population
std). The optimizer is optax's ``chain(clip_by_global_norm, adam)``:
``clip_by_global_norm_`` below, then ``torch.optim.Adam`` (optax's adam:
betas (0.9, 0.999), eps 1e-8, no weight decay). Minibatches follow the JAX
learner's numpy ``default_rng(seed)``: one ``permutation`` an epoch, the
remainder dropped, so both learners given the same weights and seed see the
same rows in the same order. ``LearnerGroup`` holds one learner, in this
thread or as an actor of the port's runtime; the learner's ``mesh`` waits
for the port's parallel ops.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import (_map_rl, rl_params_to_numpy,
                                          rl_tree_from_jax)
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.module import _first_leaf, make_module
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


def trainable_(tree) -> list:
    """The leaves of a params tree, each set to require a gradient, in the
    tree's path order (what an optimizer over the tree takes)."""
    leaves = list(_named_leaves(tree).values())
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def seeded_init(init, seed: int, device):
    """``init(generator, "cpu")`` drawn from a CPU generator seeded ``seed``,
    then moved to ``device``: a seed gives the same initial weights on
    every device, as a JAX ``PRNGKey`` does on every backend (a generator on
    the card draws other numbers than one on the host)."""
    tree = init(torch.Generator().manual_seed(seed), "cpu")
    return _map_rl(tree, lambda _, t: t.to(device))


def clone_tree(tree):
    """A detached copy of a tree of tensors, on the same device."""
    return _map_rl(tree, lambda _, t: t.detach().clone())


@torch.no_grad()
def copy_tree_(dst, src) -> None:
    """Copy ``src`` (the port's tensors, or a numpy tree in the JAX layout
    that ``rl_tree_from_jax`` takes) into ``dst``'s tensors, leaf by path."""
    leaves = _named_leaves(dst)
    if not isinstance(_first_leaf(src), torch.Tensor):
        src = rl_tree_from_jax(src, dst, _first_leaf(dst).device)
    new = _named_leaves(src)
    for name, p in leaves.items():
        p.copy_(new[name])


@torch.no_grad()
def polyak_(target, online, tau: float) -> None:
    """``target <- target * (1 - tau) + online * tau`` leaf by path, the JAX
    learners' ``tree_map`` (rounded as it is: two products, then a sum)."""
    t, o = _named_leaves(target), _named_leaves(online)
    targets = list(t.values())
    torch._foreach_mul_(targets, 1.0 - tau)
    torch._foreach_add_(targets, torch._foreach_mul([o[k] for k in t], tau))


def adam(leaves, lr: float) -> torch.optim.Adam:
    """optax's ``adam(lr)``: betas (0.9, 0.999), eps 1e-8 outside the square
    root, no weight decay."""
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def batch_to_device(batch, keys, device) -> Dict[str, torch.Tensor]:
    """The columns ``keys`` of a host batch as tensors on ``device``: floats
    as f32 (the JAX package computes in f32), integers as they are (the
    discrete actions that index a Q row)."""
    out = {}
    for k in keys:
        a = np.asarray(batch[k])
        out[k] = torch.as_tensor(a).to(
            device=device,
            dtype=None if a.dtype.kind in "iu" else torch.float32)
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


class ModuleLearner:
    """A catalog module's weights and their optimizer on one device
    (``None`` = the card): optax's ``chain(clip_by_global_norm, adam)`` as
    ``clip_by_global_norm_`` and ``torch.optim.Adam``. The PPO and APPO
    learners add their losses."""

    def __init__(self, module_spec: dict, *, lr: float, grad_clip: float,
                 seed: int, device=None):
        self.device = resolve_device(device)
        self.module = make_module(module_spec)
        self.grad_clip = grad_clip
        self.params = seeded_init(self.module.init, seed, self.device)
        self._leaves = trainable_(self.params)
        self.opt = adam(self._leaves, lr)

    def clipped_step(self, loss, stats) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on ``loss`` -> ``stats`` and the loss as
        0-d tensors (no host sync)."""
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        clip_by_global_norm_([p.grad for p in self._leaves], self.grad_clip)
        self.opt.step()
        return {k: v.detach() for k, v in
                {**stats, "total_loss": loss}.items()}

    def get_weights(self):
        """The weights on the host as numpy, in the JAX package's layout
        (HWIO conv kernels): what either stack's ``set_weights`` takes."""
        return rl_params_to_numpy(self.params)

    def set_weights(self, params) -> bool:
        """Copy ``params`` (a numpy tree as ``get_weights`` of either stack
        returns, or the port's tensors) into the learner's; the optimizer's
        state stays, as in the JAX learner."""
        copy_tree_(self.params, place_params(params, self.module,
                                             self.device))
        return True


class PPOLearner(ModuleLearner):
    """Minibatch-SGD PPO on one device (``None`` = the card)."""

    def __init__(self, module_spec: dict, *, lr: float = 3e-4,
                 clip_param: float = 0.2, vf_clip_param: float = 10.0,
                 vf_loss_coeff: float = 0.5, entropy_coeff: float = 0.0,
                 num_sgd_iter: int = 6, sgd_minibatch_size: int = 128,
                 grad_clip: float = 0.5, seed: int = 0, device=None):
        super().__init__(module_spec, lr=lr, grad_clip=grad_clip, seed=seed,
                         device=device)
        self.num_sgd_iter = num_sgd_iter
        self.minibatch_size = sgd_minibatch_size
        self.loss_kw = dict(clip_param=clip_param,
                            vf_clip_param=vf_clip_param,
                            vf_loss_coeff=vf_loss_coeff,
                            entropy_coeff=entropy_coeff)
        self._rng = np.random.default_rng(seed)

    def sgd_step(self, minibatch) -> Dict[str, torch.Tensor]:
        """One clipped Adam step on a minibatch of device tensors -> its
        stats as 0-d tensors (no host sync)."""
        return self.clipped_step(*ppo_loss(self.module, self.params,
                                           minibatch, **self.loss_kw))

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


class LearnerGroup:
    """One learner, local or remote (parity: learner_group.py:48), ported
    from ``ray_tpu/rl/learner.py``. The remote mode puts the learner in its
    own actor holding ``num_gpus``; weight broadcast to rollout workers goes
    through the object store. ``learner_kwargs["device"]`` (``None`` = the
    card) is resolved here, before any actor exists, so a machine without a
    card raises at once."""

    def __init__(self, learner_cls, learner_kwargs: dict, *,
                 remote: bool = False, num_gpus: float = 0.0):
        resolve_device(learner_kwargs.get("device"))
        self.remote = remote
        if remote:
            cls = rt.remote(learner_cls)
            self.actor = cls.options(num_cpus=1, num_gpus=num_gpus).remote(
                **learner_kwargs)
        else:
            self.local = learner_cls(**learner_kwargs)

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        if self.remote:
            return rt.get(self.actor.update.remote(batch), timeout=600)
        return self.local.update(batch)

    def get_weights(self):
        if self.remote:
            return rt.get(self.actor.get_weights.remote(), timeout=600)
        return self.local.get_weights()

    def shutdown(self):
        if self.remote:
            try:
                rt.kill(self.actor)
            except Exception:
                pass
