"""Algorithm base + config: the RL training driver. Ported from
``ray_tpu/rl/algorithm.py``.

Role parity: rllib/algorithms/algorithm.py:149 (Algorithm(Trainable):
setup builds the WorkerSet, train() -> training_step) and
algorithm_config.py:117 (AlgorithmConfig fluent builder). The WorkerSet
(evaluation/worker_set.py:79) is a list of RolloutWorker actors with
object-store weight broadcast (sync_weights:384), on either of the port's
runtimes: in this process (``init(local_mode=True)``), or in worker
processes of a cluster (``init()`` or ``init(address=...)``).

The port's device idiom: ``resources(device=...)`` places the learner;
``None`` (the default) means the CUDA card, as the JAX package runs it on
its default device, the accelerator. ``Algorithm.__init__`` resolves it
before any actor exists, so a machine without a card raises at ``build()``.
Where the rollout workers, the DQN/TD3 collectors and the ES workers sample
is ``sampler_placement``'s rule: on the learner's device in-process, on the
CPU in worker processes. ``learner_num_gpus`` is the remote learner's
resource, where the JAX package has ``learner_num_tpus``. Checkpoints are
the JAX package's pickle: the weights a numpy tree in its layout, so a
checkpoint of either stack restores in the other.
"""

from __future__ import annotations

import copy
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.core.api import in_process_runtime
from ray_tpu_torch.rl.env import check_env_ships, make_env
from ray_tpu_torch.rl.rollout import RolloutWorker
from ray_tpu_torch.rl.sample_batch import SampleBatch


# the CPUs a sampling actor asks for
SAMPLER_CPUS = 1


class AlgorithmConfig:
    """Fluent config (parity: algorithm_config.py:117)."""

    def __init__(self):
        self.env: Any = "CartPole-v1"
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 8
        self.rollout_fragment_length = 64
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.lr = 3e-4
        self.train_batch_size = 1024
        self.model_hiddens = (64, 64)
        # Model catalog knobs (parity: rllib model config / conv_filters).
        self.model_encoder = "mlp"        # "mlp" | "cnn"
        self.model_obs_shape = None       # (H, W, C) when encoder == "cnn"
        self.model_filters = ((16, 3, 2), (32, 3, 2))
        self.seed = 0
        self.learner_remote = False
        self.learner_num_gpus = 0.0
        self.device = None                # None = the CUDA card
        self.extra: Dict[str, Any] = {}

    def environment(self, env=None, **kwargs) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        self.extra.update(kwargs)
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None
                 ) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self.extra[k] = v
        return self

    def resources(self, *, learner_remote: Optional[bool] = None,
                  learner_num_gpus: Optional[float] = None,
                  device=None) -> "AlgorithmConfig":
        """``device``: where the learner and the rollout workers run
        (``"cpu"``, ``"cuda"``, ``"cuda:1"``); left unset, the card."""
        if learner_remote is not None:
            self.learner_remote = learner_remote
        if learner_num_gpus is not None:
            self.learner_num_gpus = learner_num_gpus
        if device is not None:
            self.device = device
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build(self) -> "Algorithm":
        return self.algo_class(self)  # type: ignore[attr-defined]

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)


def sampler_placement(device) -> dict:
    """Where a rollout worker, a DQN/TD3 collector or an ES worker samples
    for a learner on ``device``: its ``device`` and ``num_threads``
    arguments (ROADMAP.md C, "Samplers on a cluster").

    - In worker processes (a cluster): the CPU, with one torch intra-op
      thread for the actor's one CPU. The actor asks ``num_cpus=1`` and no
      card, and the daemon gives such a worker ``CUDA_VISIBLE_DEVICES=""``,
      as the JAX daemon gives every worker ``JAX_PLATFORMS=cpu``: the
      reference's placement, with no CUDA context or spawned process a
      worker. torch would start a thread a core in every such process,
      which oversubscribes the host's cores.
    - In this process: ``device``, the learner's, and the process's own
      threads.
    """
    if in_process_runtime():
        return {"device": device, "num_threads": None}
    return {"device": "cpu", "num_threads": SAMPLER_CPUS}


class WorkerSet:
    """Rollout-worker actors (parity: worker_set.py:79), placed by
    ``sampler_placement(device)``."""

    def __init__(self, config: AlgorithmConfig, module_spec: dict, device):
        cls = rt.remote(RolloutWorker)
        self.workers = [
            cls.options(num_cpus=SAMPLER_CPUS).remote(
                config.env, module_spec, config.rollout_fragment_length,
                config.num_envs_per_worker, config.gamma, config.lambda_,
                seed=config.seed + 1000 * (i + 1),
                **sampler_placement(device))
            for i in range(config.num_rollout_workers)
        ]

    def sample(self, weights_ref) -> List[SampleBatch]:
        return rt.get([w.sample.remote(weights_ref) for w in self.workers],
                      timeout=600)

    def sync_weights(self, weights) -> Any:
        """Broadcast via one object-store put (parity: sync_weights:384)."""
        return rt.put(weights)

    def episode_stats(self) -> List[dict]:
        return rt.get([w.episode_stats.remote() for w in self.workers],
                      timeout=600)

    def stop(self) -> None:
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:
                pass


class Algorithm:
    """Trainable-style driver: .train() one iteration at a time."""

    _default_config: Callable[[], AlgorithmConfig]

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        # before any actor: no card and device=None raises here
        self.device = resolve_device(config.device)
        check_env_ships(config.env)
        self.iteration = 0
        self._timesteps_total = 0
        probe = make_env(config.env, num_envs=1, seed=config.seed)
        self.module_spec = {
            "obs_dim": probe.observation_dim,
            "num_actions": probe.num_actions,
            "hiddens": tuple(config.model_hiddens),
        }
        if probe.num_actions < 0:  # continuous: carry the action dims
            self.module_spec["action_dim"] = getattr(probe, "action_dim", 1)
        if config.model_encoder != "mlp":
            if config.model_encoder != "cnn":
                # "lstm" modules have a sequence-first interface the
                # collector stack doesn't drive; fail at build, not inside
                # a remote worker.
                raise ValueError(
                    f"model_encoder {config.model_encoder!r} is not "
                    "trainable via Algorithm (supported: 'mlp', 'cnn'); "
                    "RecurrentRLModule is a module-level API")
            self.module_spec["encoder"] = "cnn"
            if config.model_obs_shape is None:
                raise ValueError("model_encoder='cnn' requires "
                                 "model_obs_shape=(H, W, C)")
            self.module_spec["obs_shape"] = tuple(config.model_obs_shape)
            self.module_spec["filters"] = tuple(config.model_filters)
        self.setup()

    def setup(self) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        start = time.time()
        result = self.training_step()
        self.iteration += 1
        result.update({
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "time_this_iter_s": time.time() - start,
        })
        return result

    # -- checkpointing (parity: Trainable.save/restore) ------------------
    def get_state(self) -> dict:
        raise NotImplementedError

    def set_state(self, state: dict) -> None:
        raise NotImplementedError

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        checkpoint_dir = checkpoint_dir or tempfile.mkdtemp(
            prefix="rtpu-algo-")
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump({"iteration": self.iteration,
                         "timesteps_total": self._timesteps_total,
                         "state": self.get_state()}, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            blob = pickle.load(f)
        self.iteration = blob["iteration"]
        self._timesteps_total = blob["timesteps_total"]
        self.set_state(blob["state"])

    def stop(self) -> None:
        pass
