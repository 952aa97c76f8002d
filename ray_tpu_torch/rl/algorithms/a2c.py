"""A2C — synchronous advantage actor-critic. Ported from
``ray_tpu/rl/algorithms/a2c.py``.

Role parity: rllib/algorithms/a2c/a2c.py. Exact reduction: with ONE SGD
pass over a freshly-collected on-policy batch, the importance ratio
pi/mu == 1 everywhere, so PPO's clipped surrogate collapses to the plain
policy-gradient loss -logp * advantage — A2C IS the single-epoch,
clip-inactive point of the shared PPO learner. The config pins that point;
everything else (sync sampling, GAE, the update, weight broadcast) is the
PPO path.
"""

from __future__ import annotations

from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig


class A2CConfig(PPOConfig):
    def __init__(self):
        super().__init__()
        # One pass, whole-batch, clip never active at ratio==1.
        self.num_sgd_iter = 1
        self.sgd_minibatch_size = 0       # 0 -> whole train batch
        self.clip_param = 10.0            # inert at ratio 1
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.lr = 1e-3
        self.algo_class = A2C


class A2C(PPO):
    # sgd_minibatch_size=0 resolves to whole-batch inside the learner
    # (PPOLearner.update) — no config mutation at build time.
    _default_config = A2CConfig
