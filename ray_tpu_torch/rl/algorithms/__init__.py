"""The port's single-agent RL algorithms, each ported from its module in
``ray_tpu/rl/algorithms/``. The JAX package's multi-agent ones (QMIX,
MADDPG), ES and the bandits are queued in ROADMAP.md A.9."""

from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.algorithms.impala import Impala, ImpalaConfig
from ray_tpu_torch.rl.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rl.algorithms.td3 import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rl.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rl.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rl.algorithms.cql import CQL, CQLConfig

__all__ = ["PPO", "PPOConfig", "Impala", "ImpalaConfig", "DQN", "DQNConfig",
           "SAC", "SACConfig", "TD3", "TD3Config", "DDPG", "DDPGConfig",
           "APPO", "APPOConfig", "A2C", "A2CConfig", "CQL", "CQLConfig"]
