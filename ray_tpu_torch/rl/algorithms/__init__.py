"""The port's RL algorithms. PPO is ported; the JAX package's others
(IMPALA, APPO, DQN, SAC, TD3/DDPG, A2C, CQL, ES, QMIX, MADDPG, bandits) are
queued in ROADMAP.md A.9."""

from ray_tpu_torch.rl.algorithms.ppo import PPO, PPOConfig

__all__ = ["PPO", "PPOConfig"]
