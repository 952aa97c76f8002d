"""The RL stack on the card. Every test is marked ``cuda`` and skips without
a CUDA card. The file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_rl_cuda.py

Small f32 modules (MLP, CNN, LSTM and GTrXL, the sequence encoders with
dones) on the card with TF32 off against the CPU from the same weights:
logits, values and final states; logp and entropy of fixed actions; one
``PPOLearner.update`` (MLP, CNN) or the gradients of a loss over a sequence
(LSTM, GTrXL: the JAX package has no ``logp_entropy`` for them, so no PPO
learner). Tolerance 1e-4: the same f32 products summed in another order,
through at most 12 recurrent steps and 2 Adam steps. Then draws on the card
(Gumbel-max from a CUDA generator) and a rollout worker on the card. Last,
PPO through its drivers (``PPOConfig().build()`` with ``device`` left at
``None``) in the port's in-process runtime: the learner and the workers on
the card with finite stats, save and restore, and a shutdown that leaves no
thread of the runtime alive.

The learners beyond PPO, card (TF32 off) against the CPU from the same
weights and minibatches, 2 updates each, within the same 1e-4:
``APPOLearner.update`` (V-trace on the card), DQN's TD step,
``SACLearner.update``, ``TD3Learner.update`` at ``target_noise=0`` (its
noise generator lives on the learner's device) and CQL's update; and each
of them, built on both at one seed, starts from bitwise the same weights.
Then each new driver (``XConfig().build()``, ``device`` left at ``None``)
trains 2 small iterations on the card with finite stats and its parameters
there, and APPO's ``stop()`` with samples in flight leaves no runtime thread.

The rest of RL, within the same 1e-4 (TF32 off): QMIX's TD step and
MADDPG's update (across the actor delay) card against the CPU from the same
weights and batches, and each built on both at one seed starts from
bitwise the same weights; ``MultiAgentCollector`` draws on the card; an
``ESWorker`` on the card returns the CPU worker's fitness, and
``ESConfig().build()`` trains on the card and stops leaving no runtime
thread.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.core.runtime_local import THREAD_PREFIX
from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl import (PPOLearner, RolloutWorker, SampleBatch,
                              make_module)
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl import offline
from ray_tpu_torch.rl.algorithms import (APPOConfig, CQLConfig, DDPGConfig,
                                         DQNConfig, ESConfig, ImpalaConfig,
                                         MADDPGConfig, PPOConfig, QMIXConfig,
                                         SACConfig, TD3Config)
from ray_tpu_torch.rl.algorithms import appo, es, sac, td3
from ray_tpu_torch.rl.algorithms.dqn import TRANSITION
from ray_tpu_torch.rl.learner import batch_to_device
from ray_tpu_torch.rl.multi_agent import (AGENT_ID, MultiAgentCollector,
                                          TwoStepCoopEnv)
from ray_tpu_torch.rl.rollout import place_params

TOL = 1e-4
SPECS = {
    "mlp": {"obs_dim": 6, "num_actions": 3, "hiddens": (32, 32)},
    "cnn": {"encoder": "cnn", "obs_dim": 20 * 18 * 4, "num_actions": 3,
            "obs_shape": (20, 18, 4), "filters": ((8, 3, 2), (16, 3, 2)),
            "hiddens": (32,)},
    "lstm": {"encoder": "lstm", "obs_dim": 6, "num_actions": 3,
             "hidden_size": 32},
    "gtrxl": {"encoder": "gtrxl", "obs_dim": 6, "num_actions": 3,
              "hidden_size": 32, "num_layers": 2, "num_heads": 4,
              "memory_len": 4},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_close(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = (g.detach().cpu() - w.detach()).abs().max().item()
        assert err <= TOL, err


def _batch(spec, count, rng):
    obs = rng.standard_normal((count, spec["obs_dim"])).astype(np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    return SampleBatch({
        sb.OBS: obs, sb.ACTIONS: f32(rng.integers(0, 3, count)),
        sb.ACTION_LOGP: f32(np.log(1 / 3) + 0.3 * rng.standard_normal(count)),
        sb.ADVANTAGES: f32(rng.standard_normal(count)),
        sb.VF_PREDS: f32(rng.standard_normal(count)),
        sb.VALUE_TARGETS: f32(rng.standard_normal(count))})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mlp", "cnn"])
def test_flat_module_and_update_match_cpu(name, cuda_device, no_tf32):
    spec = SPECS[name]
    module = make_module(spec)
    cpu = module.init(torch.Generator().manual_seed(0), device="cpu")
    card = place_params(cpu, module, cuda_device)
    rng = np.random.default_rng(1)
    batch = _batch(spec, 48, rng)
    obs, actions = batch[sb.OBS], batch[sb.ACTIONS]
    with torch.no_grad():
        _assert_close(module.apply(card, obs), module.apply(cpu, obs))
        _assert_close(module.logp_entropy(card, obs, actions),
                      module.logp_entropy(cpu, obs, actions))
    learners = []
    for dev in ("cpu", None):
        learner = PPOLearner(spec, num_sgd_iter=1, sgd_minibatch_size=24,
                             seed=2, device=dev)
        learner.set_weights(rl_params_to_numpy(cpu))
        learners.append((learner, learner.update(batch)))
    (want, want_stats), (got, got_stats) = learners
    for k in want_stats:
        assert abs(got_stats[k] - want_stats[k]) <= TOL, k
    _assert_close(got.params, want.params)
    assert got.params["pi"][0]["w"].device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lstm", "gtrxl"])
def test_sequence_module_and_gradients_match_cpu(name, cuda_device,
                                                 no_tf32):
    spec = SPECS[name]
    module = make_module(spec)
    cpu = module.init(torch.Generator().manual_seed(3), device="cpu")
    card = place_params(cpu, module, cuda_device)
    rng = np.random.default_rng(4)
    T, B = 12, 5
    obs = rng.standard_normal((T, B, spec["obs_dim"])).astype(np.float32)
    dones = (rng.random((T, B)) < 0.25).astype(np.float32)
    actions = rng.integers(0, 3, (T, B))
    outs = []
    for params, dev in ((cpu, "cpu"), (card, None)):
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        logits, values, final = module.apply_seq(
            params, obs, module.initial_state(B, device=dev), dones)
        logp, ent = module.dist_logp_entropy(logits, actions)
        loss = -logp.mean() + values.square().mean() - 0.01 * ent.mean()
        outs.append(((logits, values, final), (logp, ent),
                     torch.autograd.grad(loss, leaves)))
    (want_fwd, want_dist, want_grad), (got_fwd, got_dist, got_grad) = outs
    _assert_close(got_fwd, want_fwd)
    _assert_close(got_dist, want_dist)
    _assert_close(got_grad, want_grad)


@pytest.mark.cuda
def test_draws_on_the_card(cuda_device):
    module = make_module(SPECS["mlp"])
    params = module.init(torch.Generator(device=cuda_device).manual_seed(5),
                         device=None)
    n = 20_000
    obs = np.repeat(np.random.default_rng(6).standard_normal((1, 6))
                    .astype(np.float32), n, axis=0)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    with torch.no_grad():
        actions, logp, _ = module.sample_actions(params, obs, gen)
        want, _, _ = module.logp_entropy(params, obs, actions)
        p = torch.softmax(module.apply(params, obs[:1])[0][0], -1).cpu()
    assert actions.device.type == "cuda"
    assert (logp - want).abs().max().item() <= 1e-5
    freq = torch.bincount(actions.cpu(), minlength=3) / n
    assert torch.all((freq - p).abs() <= 4 * (p * (1 - p) / n).sqrt())


@pytest.mark.cuda
def test_rollout_worker_on_the_card(cuda_device, no_tf32):
    spec = {"obs_dim": 4, "num_actions": 2, "hiddens": (32, 32)}
    module = make_module(spec)
    weights = rl_params_to_numpy(module.init(
        torch.Generator().manual_seed(8), device="cpu"))
    worker = RolloutWorker("CartPole-v1", spec, 32, 8, 0.99, 0.95, seed=9)
    batch = worker.sample(weights)
    assert worker.params["pi"][0]["w"].device.type == "cuda"
    cpu = place_params(weights, module, torch.device("cpu"))
    with torch.no_grad():
        logp, _, value = module.logp_entropy(cpu, batch[sb.OBS],
                                             batch[sb.ACTIONS])
    assert np.abs(batch[sb.ACTION_LOGP] - logp.numpy()).max() <= TOL
    assert np.abs(batch[sb.VF_PREDS] - value.numpy()).max() <= TOL
    assert batch.count == 256 and np.isfinite(batch[sb.ADVANTAGES]).all()


@pytest.fixture
def port_runtime(cuda_device):
    import ray_tpu_torch
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _ppo(**resources):
    return (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=8,
                      rollout_fragment_length=32)
            .debugging(seed=0).resources(**resources).build())


def _param_devices(rt, algo):
    """The device type of the learner's and each worker's first leaf, read
    through the in-process runtime's actor table."""
    actors = rt.core.api._runtime._actors
    group = algo.learner_group
    learner = (actors[group.actor.actor_id].instance if group.remote
               else group.local)
    workers = [actors[w.actor_id].instance for w in algo.workers.workers]
    return ([learner.params["pi"][0]["w"].device.type]
            + [w.params["pi"][0]["w"].device.type for w in workers])


@pytest.mark.cuda
@pytest.mark.parametrize("remote", [False, True], ids=["local", "remote"])
def test_ppo_drivers_on_the_card(port_runtime, remote):
    algo = _ppo(learner_remote=remote, learner_num_gpus=1 if remote else 0)
    for i in range(2):
        result = algo.train()
        assert result["training_iteration"] == i + 1
        assert result["num_env_steps_sampled"] == 2 * 8 * 32
        assert all(np.isfinite(v) for k, v in result.items()
                   if k.startswith("info/"))
    assert _param_devices(port_runtime, algo) == ["cuda"] * 3
    algo.stop()


@pytest.mark.cuda
def test_ppo_save_and_restore_on_the_card(port_runtime, tmp_path):
    algo = _ppo()
    algo.train()
    ckpt = algo.save(str(tmp_path / "ck"))
    want = algo.get_state()["weights"]
    algo.stop()
    fresh = _ppo()
    fresh.restore(ckpt)
    assert fresh.iteration == 1
    got = fresh.get_state()["weights"]
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.tobytes() == b.tobytes()
    assert fresh.train()["training_iteration"] == 2
    fresh.stop()


@pytest.mark.cuda
def test_shutdown_leaves_no_runtime_thread_on_the_card(port_runtime):
    import threading
    algo = _ppo(learner_remote=True, learner_num_gpus=1)
    algo.train()
    algo.stop()
    port_runtime.shutdown()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(THREAD_PREFIX) and t.is_alive()]
    assert alive == []


def _transitions(rng, n, obs_dim, discrete):
    return SampleBatch({
        sb.OBS: rng.standard_normal((n, obs_dim)).astype(np.float32),
        sb.ACTIONS: (rng.integers(0, 2, n) if discrete else
                     rng.uniform(-2, 2, (n, 1)).astype(np.float32)),
        sb.REWARDS: rng.standard_normal(n).astype(np.float32),
        sb.NEXT_OBS: rng.standard_normal((n, obs_dim)).astype(np.float32),
        sb.DONES: (rng.random(n) < 0.2).astype(np.float32)})


def _structured(rng, T, N, obs_dim):
    batch = SampleBatch({
        sb.OBS: rng.standard_normal((T * N, obs_dim)).astype(np.float32),
        sb.ACTIONS: rng.integers(0, 2, T * N).astype(np.float32),
        sb.REWARDS: rng.standard_normal(T * N).astype(np.float32),
        sb.DONES: (rng.random(T * N) < 0.1).astype(np.float32),
        sb.ACTION_LOGP: (np.log(0.5) + 0.3 * rng.standard_normal(T * N))
        .astype(np.float32)})
    batch.rollout_shape = (T, N)
    batch.last_obs = rng.standard_normal((N, obs_dim)).astype(np.float32)
    return batch


def _learner(name, dev, tmp_path):
    """-> (learner, weights getter, one update of a host batch)."""
    spec = {"obs_dim": 4, "num_actions": 2, "hiddens": (32, 32)}
    if name == "appo":
        le = appo.APPOLearner(spec, lr=1e-3, seed=1, device=dev)
        return le, le.get_weights, le.update
    if name == "sac":
        le = sac.SACLearner(spec, seed=1, device=dev)
        return le, le.get_state, le.update
    if name == "td3":
        le = td3.TD3Learner({"obs_dim": 4, "num_actions": -1},
                            target_noise=0.0, target_noise_clip=0.0,
                            policy_delay=1, action_low=-2.0,
                            action_high=2.0, hiddens=(32, 32), seed=1,
                            device=dev)
        return le, le.state, le.update
    if name == "dqn":
        le = (DQNConfig().rollouts(num_rollout_workers=0)
              .training(model_hiddens=(32, 32)).resources(device=dev)
              .build())
        return le, le.get_state, lambda b: le.td_step(
            batch_to_device(b, TRANSITION, le.device))
    path = str(tmp_path / "data")
    offline.collect_experiences("CartPole-v1", path, num_steps=256)
    le = (CQLConfig().offline_data(input_path=path)
          .training(model_hiddens=(32, 32)).resources(device=dev).build())
    return le, le.get_state, lambda b: le.step(
        batch_to_device(b, TRANSITION, le.device))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["appo", "dqn", "sac", "td3", "cql"])
def test_learners_beyond_ppo_match_cpu(name, cuda_device, no_tf32,
                                       tmp_path):
    (cpu, cpu_state, cpu_update), (card, card_state, card_update) = (
        _learner(name, dev, tmp_path) for dev in ("cpu", None))
    state = cpu_state()
    (card.set_weights if name == "appo" else card.set_state)(state)
    rng = np.random.default_rng(11)
    for _ in range(2):
        batch = (_structured(rng, 16, 4, 4) if name == "appo" else
                 _transitions(rng, 64, 4, discrete=name != "td3"))
        cpu_update(batch)
        card_update(batch)
    got, want = _leaves(card_state()), _leaves(cpu_state())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["appo", "dqn", "sac", "td3", "cql"])
def test_a_seed_gives_the_cpus_initial_weights_on_the_card(name, cuda_device,
                                                           tmp_path):
    """The learners draw their initial weights on the host and move them, so
    one seed gives the same weights on the card as on the CPU."""
    (_, cpu_state, _), (_, card_state, _) = (
        _learner(name, dev, tmp_path) for dev in ("cpu", None))
    got, want = _leaves(card_state()), _leaves(cpu_state())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


NEW_DRIVERS = {
    "appo": lambda: APPOConfig().training(train_batch_size=256),
    "impala": lambda: ImpalaConfig().training(train_batch_size=256),
    "dqn": lambda: DQNConfig().training(learning_starts=64,
                                        updates_per_iter=8),
    "sac": lambda: SACConfig().training(learning_starts=64,
                                        updates_per_iter=8),
    "td3": lambda: TD3Config().environment("Pendulum-v1").training(
        learning_starts=64, updates_per_iter=8),
    "ddpg": lambda: DDPGConfig().environment("Pendulum-v1").training(
        learning_starts=64, updates_per_iter=8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NEW_DRIVERS))
def test_new_drivers_on_the_card(port_runtime, name):
    config = NEW_DRIVERS[name]().rollouts(
        num_rollout_workers=2, num_envs_per_worker=4,
        rollout_fragment_length=16).debugging(seed=0)
    algo = config.build()
    for i in range(2):
        result = algo.train()
        assert result["training_iteration"] == i + 1
        assert all(np.isfinite(v) for k, v in result.items()
                   if isinstance(v, float) and k != "episode_reward_mean")
    learner = getattr(algo, "learner", None) or algo
    leaf = _leaves(getattr(learner, "params", None)
                   or algo.learner_group.local.params)[0]
    assert leaf.device.type == "cuda"
    algo.stop()


@pytest.mark.cuda
def test_appo_stop_with_samples_in_flight_on_the_card(port_runtime):
    import threading
    algo = NEW_DRIVERS["appo"]().rollouts(num_envs_per_worker=4).build()
    algo.train()
    algo.stop()
    port_runtime.shutdown()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(THREAD_PREFIX) and t.is_alive()]
    assert alive == []


def _multi_agent(name, dev):
    """-> (algorithm, state getter, one update of a host joint batch)."""
    on = lambda algo, batch: tuple(torch.as_tensor(a).to(algo.device)
                                   for a in batch)
    if name == "qmix":
        config = QMIXConfig().resources(device=dev).debugging(seed=3)
        config.env_fn = lambda: TwoStepCoopEnv(horizon=8)
        algo = config.build()
        return algo, algo.get_state, lambda b, do: algo.td_step(on(algo, b))
    config = MADDPGConfig().resources(device=dev).debugging(seed=3)
    algo = config.build()
    return algo, algo.get_state, lambda b, do: algo.update(on(algo, b), do)


def _joint_batch(name, rng, B=64):
    n, d = (2, 2) if name == "qmix" else (2, 3)
    obs = rng.random((B, n, d)).astype(np.float32)
    nobs = rng.random((B, n, d)).astype(np.float32)
    done = (rng.random(B) < 0.2).astype(np.float32)
    if name == "qmix":
        return (obs, rng.integers(0, 2, (B, n)).astype(np.int32),
                rng.standard_normal(B).astype(np.float32), nobs, done,
                obs.reshape(B, -1), nobs.reshape(B, -1))
    return (obs, rng.uniform(-1, 1, (B, n, 1)).astype(np.float32),
            rng.standard_normal((B, n)).astype(np.float32), nobs, done)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qmix", "maddpg"])
def test_multi_agent_updates_match_cpu(name, cuda_device, no_tf32):
    """QMIX's TD step and MADDPG's update (the second one past the actor
    delay), 2 each from the same weights and batches."""
    (cpu, cpu_state, cpu_update), (card, card_state, card_update) = (
        _multi_agent(name, dev) for dev in ("cpu", None))
    card.set_state(cpu_state())
    rng = np.random.default_rng(12)
    for do_actor in (0.0, 1.0):
        batch = _joint_batch(name, rng)
        cpu_update(batch, do_actor)
        card_update(batch, do_actor)
    got, want = _leaves(card_state()), _leaves(cpu_state())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= TOL
    assert _leaves(card.params)[0].device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qmix", "maddpg"])
def test_a_seed_gives_the_cpus_multi_agent_weights_on_the_card(name,
                                                                cuda_device):
    (_, cpu_state, _), (_, card_state, _) = (
        _multi_agent(name, dev) for dev in ("cpu", None))
    got, want = _leaves(card_state()), _leaves(cpu_state())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()


@pytest.mark.cuda
def test_collector_samples_on_the_card(cuda_device):
    module = make_module({"obs_dim": 2, "num_actions": 2, "hiddens": (32,)})
    weights = rl_params_to_numpy(module.init(
        torch.Generator().manual_seed(4), device="cpu"))
    col = MultiAgentCollector(TwoStepCoopEnv(horizon=4), {"shared": module},
                              {"shared": weights}, seed=0)
    batch = col.collect(16)["shared"]
    assert col.generator.device.type == "cuda"
    assert col.params["shared"]["pi"][0]["w"].device.type == "cuda"
    assert batch.count == 32 and len(col.episode_returns) == 4
    assert batch[sb.ACTIONS].dtype == np.int32
    assert set(batch[sb.ACTIONS].tolist()) <= {0, 1}
    assert set(batch[AGENT_ID].tolist()) == {"agent_0", "agent_1"}


@pytest.mark.cuda
def test_es_on_the_card(port_runtime, no_tf32):
    """An ESWorker on the card returns the CPU worker's fitness for the
    same theta and seeds; ``ESConfig().build()`` trains on the card and
    its ``stop()`` leaves no runtime thread after shutdown."""
    import threading
    spec = {"obs_dim": 4, "num_actions": 2, "hiddens": (64, 64)}
    theta = es._flatten(rl_params_to_numpy(make_module(spec).init(
        torch.Generator().manual_seed(2), device="cpu")))
    card = es.ESWorker("CartPole-v1", spec, 100, 0.1, seed=1)
    cpu = es.ESWorker("CartPole-v1", spec, 100, 0.1, seed=1, device="cpu")
    assert card.evaluate(theta, [5, 6]) == cpu.evaluate(theta, [5, 6])
    config = ESConfig().rollouts(num_rollout_workers=2).debugging(seed=3)
    config.num_perturbations, config.episode_horizon = 4, 50
    algo = config.build()
    result = algo.train()
    assert np.isfinite(result["episode_reward_mean"])
    algo.stop()
    port_runtime.shutdown()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(THREAD_PREFIX) and t.is_alive()]
    assert alive == []
