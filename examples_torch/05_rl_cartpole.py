"""PPO on CartPole via the Algorithm API (run: python
examples_torch/05_rl_cartpole.py [--device cpu] [--local-mode]).

The learner runs on the card unless ``--device cpu``; on a head (the
default) the two rollout workers are CPU processes of the cluster, with
``--local-mode`` threads of this process (the in-process runtime)."""
import argparse

import ray_tpu_torch as rt
from ray_tpu_torch.rl.algorithms import PPOConfig


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None)
    parser.add_argument("--local-mode", action="store_true")
    args = parser.parse_args()
    rt.init(num_cpus=8, local_mode=args.local_mode)  # explicit size: actors
    # HOLD their CPU, so leave headroom for tasks scheduled alongside them
    config = (PPOConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=2, num_envs_per_worker=8)
              .resources(device=args.device))
    algo = config.build()
    for i in range(5):
        result = algo.train()
        print(f"iter {i}: reward={result['episode_reward_mean']:.1f} "
              f"steps={result['timesteps_total']}")
    ckpt = algo.save()
    print("checkpoint:", ckpt)
    algo.stop()
    rt.shutdown()


if __name__ == "__main__":
    main()
