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
(Gumbel-max from a CUDA generator) and a rollout worker on the card.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.convert import rl_params_to_numpy
from ray_tpu_torch.rl import (PPOLearner, RolloutWorker, SampleBatch,
                              make_module)
from ray_tpu_torch.rl import sample_batch as sb
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
