"""The port's RL algorithms, each ported from its module in
``ray_tpu/rl/algorithms/``: the single-agent ones, the multi-agent QMIX
and MADDPG, ES and the contextual bandits."""

from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.algorithms.impala import Impala, ImpalaConfig
from ray_tpu_torch.rl.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rl.algorithms.td3 import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rl.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rl.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rl.algorithms.es import ES, ESConfig
from ray_tpu_torch.rl.algorithms.qmix import QMIX, QMIXConfig
from ray_tpu_torch.rl.algorithms.maddpg import (CoopSpreadEnv, MADDPG,
                                                MADDPGConfig)
from ray_tpu_torch.rl.algorithms.bandits import (Bandit, BanditConfig,
                                                 ContextualBanditEnv)

__all__ = ["PPO", "PPOConfig", "Impala", "ImpalaConfig", "DQN", "DQNConfig",
           "SAC", "SACConfig", "TD3", "TD3Config", "DDPG", "DDPGConfig",
           "APPO", "APPOConfig", "A2C", "A2CConfig", "CQL", "CQLConfig",
           "ES", "ESConfig", "QMIX", "QMIXConfig", "MADDPG", "MADDPGConfig",
           "CoopSpreadEnv", "Bandit", "BanditConfig", "ContextualBanditEnv"]
