"""ray_tpu_torch.rl: what PPO computes, ported from ``ray_tpu.rl``.

The RLModule catalog (MLP, CNN, LSTM, GTrXL), the sample batch, the
vectorized envs, rollout with GAE and the PPO learner, in PyTorch on one
device (``device=None`` = the CUDA card). The drivers (``WorkerSet``,
``LearnerGroup``, ``Algorithm``, ``PPO``) wait for the port's copy of the
runtime; until then a caller runs the workers and the learner in-process in
``PPO.training_step``'s order: sample, ``SampleBatch.concat_samples``,
``PPOLearner.update``, ``get_weights`` back to the workers.
"""

from ray_tpu_torch.models.convert import rl_params_from_jax
from ray_tpu_torch.rl.env import (CartPoleVectorEnv, GymVectorEnv,
                                  MultiAgentEnv, PendulumVectorEnv,
                                  VectorEnv, make_env)
from ray_tpu_torch.rl.learner import PPOLearner
from ray_tpu_torch.rl.module import (AttentionRLModule, ConvRLModule,
                                     RecurrentRLModule, RLModule,
                                     make_module)
from ray_tpu_torch.rl.rollout import RolloutWorker, compute_gae
from ray_tpu_torch.rl.sample_batch import SampleBatch

__all__ = ["VectorEnv", "CartPoleVectorEnv", "PendulumVectorEnv",
           "GymVectorEnv", "MultiAgentEnv", "make_env", "RLModule",
           "ConvRLModule", "RecurrentRLModule", "AttentionRLModule",
           "make_module", "RolloutWorker", "compute_gae", "SampleBatch",
           "PPOLearner", "rl_params_from_jax"]
