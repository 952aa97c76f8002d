"""ray_tpu_torch.rl: the RL library ported from ``ray_tpu.rl``.

The RLModule catalog (MLP, CNN, LSTM, GTrXL), the sample batch, the
vectorized envs, rollout with GAE, V-trace (``rl.vtrace``), the replay
buffers, the offline IO with BC and MARWIL (``rl.offline``), the
connectors (``rl.connectors``), multi-agent collection
(``rl.multi_agent``), the PPO learner and the drivers (``LearnerGroup``,
``WorkerSet``, ``Algorithm``, ``AlgorithmConfig``), and the algorithms in
``ray_tpu_torch.rl.algorithms`` (PPO, IMPALA, APPO, A2C, DQN, SAC, TD3,
DDPG, CQL, QMIX, MADDPG, ES and the bandits), in PyTorch. The drivers
run the rollout workers, collectors and learners as actors of the port's
in-process runtime or in the driver's thread, all on one device (``None`` =
the CUDA card):

    import ray_tpu_torch as rt
    from ray_tpu_torch.rl.algorithms import PPOConfig

    rt.init()
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=16)
            .build())                    # .resources(device="cpu") for the CPU
    result = algo.train()                # result["episode_reward_mean"], ...
    algo.stop()
    rt.shutdown()
"""

from ray_tpu_torch.models.convert import rl_params_from_jax, rl_tree_from_jax
from ray_tpu_torch.rl.env import (CartPoleVectorEnv, GymVectorEnv,
                                  MultiAgentEnv, PendulumVectorEnv,
                                  VectorEnv, make_env)
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, WorkerSet
from ray_tpu_torch.rl.learner import LearnerGroup, PPOLearner
from ray_tpu_torch.rl.module import (AttentionRLModule, ConvRLModule,
                                     RecurrentRLModule, RLModule,
                                     make_module)
from ray_tpu_torch.rl.replay_buffer import (PrioritizedReplayBuffer,
                                            ReplayBuffer)
from ray_tpu_torch.rl.rollout import RolloutWorker, compute_gae
from ray_tpu_torch.rl.sample_batch import SampleBatch

__all__ = ["VectorEnv", "CartPoleVectorEnv", "PendulumVectorEnv",
           "GymVectorEnv", "MultiAgentEnv", "make_env", "RLModule",
           "ConvRLModule", "RecurrentRLModule", "AttentionRLModule",
           "make_module", "RolloutWorker", "compute_gae", "SampleBatch",
           "PPOLearner", "LearnerGroup", "WorkerSet", "Algorithm",
           "AlgorithmConfig", "ReplayBuffer", "PrioritizedReplayBuffer",
           "rl_params_from_jax", "rl_tree_from_jax"]
