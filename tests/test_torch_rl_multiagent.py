"""Port parity: the connectors, multi-agent collection, QMIX and MADDPG,
ray_tpu_torch.rl against ray_tpu.rl on the CPU. The port runs with
``device="cpu"``; both stacks compute in f32.

- Connectors and the copied envs (``TwoStepCoopEnv``, ``CoopSpreadEnv``):
  numpy in both stacks, so equal bitwise on the same seeded arrays and
  actions, the connectors' state round trip included.
- ``MultiAgentCollector``: the JAX collector draws from ``jax.random``,
  the port from a ``torch.Generator`` (ROADMAP C). So the draws are held by
  their law: over 20,000 draws the frequency of each action, for each
  observation, lies within 4 sigma of the softmax of the module's logits.
  The batches' layout and the policy mapping are the JAX tests'
  (``tests/test_rl_connectors_multiagent.py:47``, ``:68``), and the
  shared-policy coordination gate (``:88``) is met with a torch Adam.
- QMIX: ``_agent_qs`` and ``_mix`` within 1e-6 of JAX's on converted
  weights (f32, summed in another order; relative to the outputs' largest
  magnitude where that is above 1), the mixer monotone; 4 TD steps from
  the same weights, target and batches: the params within 2e-6, the Adam
  moments within 1e-5 relative to their size above 1 (the second moment
  squares gradients of size 10-50, whose own relative error is ~2e-6), the
  losses 1e-5 relative (the off-policy learners' bounds,
  ``tests/test_torch_rl_offpolicy.py``); 64 steps of ``_collect`` take the
  JAX version's actions and fill the same buffer, bitwise (its epsilon,
  random actions and indices are the same numpy draws; the greedy argmax
  of two f32 forwards within 1e-6 of each other). The gate
  (``tests/test_rl_breadth.py:29``): above 6.0 after 14 iterations.
- MADDPG: 4 updates across the actor delay (``do_actor`` 0, 0, 1, 1) from
  converted weights on the same batches: actors, critics, targets and both
  Adam states (step counts equal, moments relative to their size above 1)
  within 2e-6, the losses 1e-5
  relative. During the delay the actors keep their values bit for bit and
  their Adam state advances, as in JAX. The gate (``:81``): above -5.5
  after 12 iterations and the greedy median error below 0.3.
- Checkpoints cross the stacks both ways, bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl import connectors as jconn
from ray_tpu.rl.algorithms import MADDPG as JMADDPG
from ray_tpu.rl.algorithms import MADDPGConfig as JMADDPGConfig
from ray_tpu.rl.algorithms import QMIX as JQMIX
from ray_tpu.rl.algorithms import QMIXConfig as JQMIXConfig
from ray_tpu.rl.algorithms import CoopSpreadEnv as JCoopSpreadEnv
from ray_tpu.rl.algorithms import qmix as jqmix
from ray_tpu.rl.multi_agent import TwoStepCoopEnv as JTwoStepCoopEnv
from ray_tpu_torch.models.convert import rl_tree_from_jax
from ray_tpu_torch.rl import RLModule
from ray_tpu_torch.rl import connectors as tconn
from ray_tpu_torch.rl import sample_batch as sb
from ray_tpu_torch.rl.algorithms import (MADDPG, QMIX, CoopSpreadEnv,
                                         MADDPGConfig, QMIXConfig)
from ray_tpu_torch.rl.algorithms import qmix as tqmix
from ray_tpu_torch.rl.learner import _named_leaves
from ray_tpu_torch.rl.multi_agent import (AGENT_ID, MultiAgentCollector,
                                          TwoStepCoopEnv)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small ops (faster alone, and the suite
    runs in parallel processes: a thread a core in each oversubscribes the
    cores, and a CPU gate then runs 20x slower or more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moved(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.standard_normal(
        np.shape(a)).astype(np.float32), jax.device_get(tree))


def _numpy(tree):
    """Leaves by path as numpy: the port's tensors or a JAX tree."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in _named_leaves(tree).items()}


def _max_error(got, want, leaves=None):
    got, want = _numpy(got), _numpy(want)
    assert sorted(got) == sorted(want)
    assert leaves is None or len(got) == leaves
    for k in want:
        assert got[k].shape == want[k].shape, k
    return max(float(np.max(np.abs(got[k] - want[k]))) for k in want)


def _bitwise(got, want):
    got, want = _numpy(got), _numpy(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def _scaled_error(got, want) -> float:
    """The largest difference, relative to the largest magnitude of
    ``want`` where that is above 1 (an f32 ulp of 20 is 2e-6)."""
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))) / max(
        1.0, float(np.max(np.abs(want))))


def _adam_error(opt, leaves, params, jax_adam):
    """The largest difference of a torch Adam's moments (by the params'
    paths) from optax's ``ScaleByAdamState``, each leaf's relative to its
    largest magnitude where that is above 1 (a second moment of squared
    gradients reaches 1e2-1e3 here, where an f32 ulp is 1e-5-1e-4), and
    that the step counts agree."""
    path = {id(leaf): k for k, leaf in _named_leaves(params).items()}
    mu, nu = _numpy(jax_adam.mu), _numpy(jax_adam.nu)
    err = 0.0
    for leaf in leaves:
        st, k = opt.state[leaf], path[id(leaf)]
        assert int(st["step"]) == int(jax_adam.count), k
        for got, want in ((st["exp_avg"], mu[k]), (st["exp_avg_sq"], nu[k])):
            err = max(err, _scaled_error(got.numpy(), want))
    assert len(leaves) == len(mu)
    return err


# ---------------------------------------------------------------------------
# connectors and the copied envs
# ---------------------------------------------------------------------------

def test_connectors_equal_jax_bitwise():
    rng = np.random.default_rng(0)
    data = rng.normal(5.0, 2.0, size=(300, 2, 3))
    acts = rng.normal(0.0, 2.0, size=(64, 2))
    for make in (lambda m: m.FlattenObs(), lambda m: m.ClipObs(-6.0, 6.0),
                 lambda m: m.ClipActions(-0.5, 0.5),
                 lambda m: m.UnsquashActions(-2.0, 3.0),
                 lambda m: m.ConnectorPipeline(
                     [m.FlattenObs(), m.MeanStdObs(), m.ClipObs(-1.0, 1.0)])):
        j, t = make(jconn), make(tconn)
        x = acts if isinstance(j, (jconn.ClipActions, jconn.UnsquashActions)
                               ) else data
        for chunk in np.array_split(x, 5):
            _bitwise({"out": t(chunk)}, {"out": j(chunk)})
    # MeanStdObs: running statistics and the state's round trip, both ways
    j, t = jconn.MeanStdObs(), tconn.MeanStdObs()
    for chunk in np.array_split(data.reshape(300, 6), 7):
        _bitwise({"out": t(chunk)}, {"out": j(chunk)})
    _bitwise(t.get_state(), j.get_state())
    jf, tf = jconn.MeanStdObs(update=False), tconn.MeanStdObs(update=False)
    jf.set_state(t.get_state())
    tf.set_state(j.get_state())
    x = data.reshape(300, 6)
    _bitwise({"out": tf(x)}, {"out": jf(x)})
    _bitwise(tf.get_state(), j.get_state())
    # a pipeline's aggregate state, with string keys as a JSON round trip
    jp = jconn.ConnectorPipeline([jconn.FlattenObs(), jconn.MeanStdObs()])
    tp = tconn.ConnectorPipeline([tconn.FlattenObs(), tconn.MeanStdObs()])
    jp(data)
    tp.set_state({str(k): v for k, v in jp.get_state().items()})
    _bitwise({str(k): v for k, v in tp.get_state().items()},
             {str(k): v for k, v in jp.get_state().items()})


def test_meanstd_connector_normalizes_and_checkpoints():
    rng = np.random.default_rng(0)
    c = tconn.MeanStdObs()
    data = rng.normal(5.0, 2.0, size=(500, 3))
    for chunk in np.array_split(data, 10):
        c(chunk)
    normed = c(data)
    assert abs(normed.mean()) < 0.1 and abs(normed.std() - 1.0) < 0.1
    # checkpoint roundtrip into a FROZEN eval copy
    frozen = tconn.MeanStdObs(update=False)
    frozen.set_state(c.get_state())
    again = frozen(data)
    assert np.allclose(again, normed, atol=1e-5)


def test_pipeline_compose_and_actions():
    pipe = tconn.ConnectorPipeline([tconn.FlattenObs(),
                                    tconn.ClipObs(-1.0, 1.0)])
    out = pipe(np.full((4, 2, 3), 7.0))
    assert out.shape == (4, 6) and out.max() == 1.0
    assert tconn.ClipActions(-0.5, 0.5)(np.array([2.0, -2.0])).tolist() == \
        [0.5, -0.5]
    un = tconn.UnsquashActions(0.0, 10.0)(np.array([0.0]))
    assert abs(un[0] - 5.0) < 1e-5
    state = pipe.get_state()
    pipe.set_state(state)
    assert pipe.append(tconn.ClipActions()) is pipe


def test_copied_envs_equal_jax():
    rng = np.random.default_rng(1)
    for jenv, tenv, draw in (
            (JTwoStepCoopEnv(horizon=5, seed=3), TwoStepCoopEnv(horizon=5,
                                                                seed=3),
             lambda: {a: int(rng.integers(0, 2))
                      for a in ("agent_0", "agent_1")}),
            (JCoopSpreadEnv(horizon=4, seed=3), CoopSpreadEnv(horizon=4,
                                                              seed=3),
             lambda: {a: rng.uniform(-1, 1, 1).astype(np.float32)
                      for a in ("agent_0", "agent_1")})):
        _bitwise(tenv.reset(), jenv.reset())
        for _ in range(13):
            actions = draw()
            jout, tout = jenv.step(actions), tenv.step(actions)
            assert tout[1:4] == jout[1:4]
            _bitwise(tout[0], jout[0])
            if jout[3]["__all__"]:
                _bitwise(tenv.reset(), jenv.reset())


# ---------------------------------------------------------------------------
# MultiAgentCollector
# ---------------------------------------------------------------------------

def _module_params(module, seed):
    return module.init(torch.Generator().manual_seed(seed), device="cpu")


def test_multi_agent_shared_policy_collection():
    env = TwoStepCoopEnv(horizon=4)
    module = RLModule(obs_dim=2, num_actions=2)
    col = MultiAgentCollector(env, {"shared": module},
                              {"shared": _module_params(module, 0)}, seed=0,
                              device="cpu")
    batch = col.collect(16)["shared"]
    # both agents contribute every step
    assert batch.count == 32
    assert set(np.asarray(batch[AGENT_ID]).tolist()) == {"agent_0",
                                                         "agent_1"}
    assert len(col.episode_returns) == 4  # 16 steps / horizon 4
    assert batch[sb.OBS].shape == (32, 2) and batch[sb.OBS].dtype == \
        np.float32
    assert batch[sb.ACTIONS].dtype == np.int32
    assert set(batch[sb.ACTIONS].tolist()) <= {0, 1}
    # rows in step order, agent_0 then agent_1; the last step of each
    # episode is done, and its next observation is the last phase (1.0)
    assert batch[AGENT_ID][:4].tolist() == ["agent_0", "agent_1"] * 2
    done = batch[sb.DONES][0::2]
    np.testing.assert_array_equal(done.reshape(4, 4), [[0, 0, 0, 1]] * 4)
    obs, nxt = batch[sb.OBS][0::2, 0], batch[sb.NEXT_OBS][0::2, 0]
    np.testing.assert_array_equal(nxt[:-1][done[:-1] == 0],
                                  obs[1:][done[:-1] == 0])
    assert (nxt[done == 1] == 1.0).all()


def test_multi_agent_policy_mapping():
    env = TwoStepCoopEnv(horizon=4)
    m0 = RLModule(obs_dim=2, num_actions=2)
    m1 = RLModule(obs_dim=2, num_actions=2)
    col = MultiAgentCollector(
        env, {"p0": m0, "p1": m1},
        {"p0": _module_params(m0, 0), "p1": _module_params(m1, 1)},
        policy_mapping_fn=lambda a: "p0" if a.endswith("0") else "p1",
        seed=0, device="cpu")
    batches = col.collect(8)
    assert set(batches) == {"p0", "p1"}
    assert batches["p0"].count == 8 and batches["p1"].count == 8
    assert set(batches["p0"][AGENT_ID].tolist()) == {"agent_0"}
    assert set(batches["p1"][AGENT_ID].tolist()) == {"agent_1"}


def test_collector_takes_jax_weights_and_draws_by_the_softmax():
    """20,000 draws (10,000 steps x 2 agents) from JAX weights carried over
    as numpy, moved so the 8 observations' probabilities of action 1 spread
    over 0.33-0.52: for each
    observation, the count of action 1 lies within 4 sigma of the sum of
    its softmax probabilities."""
    from ray_tpu.rl.module import RLModule as JRLModule
    jmod = JRLModule(obs_dim=2, num_actions=2, hiddens=(16,))
    jparams = _moved(jmod.init(jax.random.PRNGKey(0)), 3, scale=0.3)
    module = RLModule(obs_dim=2, num_actions=2, hiddens=(16,))
    col = MultiAgentCollector(TwoStepCoopEnv(horizon=8), {"shared": module},
                              {"shared": jparams}, seed=5, device="cpu")
    batch = col.collect(10_000)["shared"]
    assert batch.count == 20_000
    logits = np.asarray(jmod.apply(jparams, batch[sb.OBS])[0])
    p1 = np.exp(logits[:, 1]) / np.exp(logits).sum(axis=1)
    phases = np.unique(batch[sb.OBS][:, 0])
    assert len(phases) == 8
    spread = []
    for phase in phases:
        rows = batch[sb.OBS][:, 0] == phase
        p, a = p1[rows], batch[sb.ACTIONS][rows]
        sigma = np.sqrt(np.sum(p * (1 - p)))
        assert abs(a.sum() - p.sum()) <= 4 * sigma, (phase, a.sum(),
                                                     p.sum(), sigma)
        spread.append(p.mean())
    assert max(spread) - min(spread) > 0.1   # the law is not flat


def test_shared_policy_learns_to_coordinate():
    """Parameter-shared policy-gradient updates on the cooperative match
    game (the JAX test's loss and lr, a torch Adam): reward climbs toward
    the 1.0/step optimum."""
    module = RLModule(obs_dim=2, num_actions=2, hiddens=(32,))
    params = _module_params(module, 0)
    leaves = list(_named_leaves(params).values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=3e-3)
    col = MultiAgentCollector(TwoStepCoopEnv(horizon=8), {"shared": module},
                              {"shared": params}, seed=0, device="cpu")
    mean_r = 0.0
    for _ in range(40):
        b = col.collect(64)["shared"]
        logp, entropy, _ = module.logp_entropy(params, b[sb.OBS],
                                               b[sb.ACTIONS])
        rew = torch.as_tensor(b[sb.REWARDS])
        adv = rew - rew.mean()
        loss = -(logp * adv).mean() - 0.01 * entropy.mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        col.set_params({"shared": params})
        mean_r = float(np.mean(b[sb.REWARDS]))
        if mean_r > 0.9:
            break
    assert mean_r > 0.9, f"agents never coordinated: {mean_r:.2f}"


# ---------------------------------------------------------------------------
# QMIX
# ---------------------------------------------------------------------------

def _qmix_configs(seed=1, horizon=8, **training):
    j, t = JQMIXConfig(), QMIXConfig().resources(device="cpu")
    j.env_fn = lambda: JTwoStepCoopEnv(horizon=horizon)
    t.env_fn = lambda: TwoStepCoopEnv(horizon=horizon)
    for c in (j, t):
        c.training(**training).debugging(seed=seed)
    return j, t


def test_qmix_agent_qs_and_mix_match_jax():
    jp = _moved(jqmix._qmix_init(jax.random.PRNGKey(0), obs_dim=3,
                                 num_actions=4, n_agents=3, state_dim=9,
                                 hidden=8, embed=5), 1)
    like = tqmix._qmix_init(torch.Generator(), 3, 4, 3, 9, 8, 5, "cpu")
    tp = rl_tree_from_jax(jp, like, "cpu")
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(6, 3, 3)).astype(np.float32)
    q = rng.normal(size=(6, 3)).astype(np.float32)
    state = obs.reshape(6, 9)
    got = tqmix._agent_qs(tp, torch.as_tensor(obs)).numpy()
    assert _scaled_error(got, jqmix._agent_qs(jp, obs)) <= 1e-6
    mix = lambda qq: tqmix._mix(tp, torch.as_tensor(qq),
                                torch.as_tensor(state)).numpy()
    assert _scaled_error(mix(q), jqmix._mix(jp, q, state)) <= 1e-6
    # the leaky ReLU's negative side is reached
    w1 = np.abs(state @ jp["hyper_w1"][0]["w"] + jp["hyper_w1"][0]["b"])
    h = np.einsum("bn,bne->be", q, w1.reshape(6, 3, 5)) + \
        (state @ jp["hyper_b1"][0]["w"] + jp["hyper_b1"][0]["b"])
    assert (h < 0).any() and (h > 0).any()
    # monotone in every agent's chosen Q (tests/test_rl_breadth.py:49)
    for agent in range(3):
        bump = np.zeros(3, np.float32)
        bump[agent] = 1.0
        assert (mix(q + bump) >= mix(q) - 1e-5).all()


def _qmix_batch(rng, B=32, n=2, d=2, A=2):
    # observations in [0, 1], as TwoStepCoopEnv's phase and constant
    obs = rng.random((B, n, d)).astype(np.float32)
    nobs = rng.random((B, n, d)).astype(np.float32)
    return (obs, rng.integers(0, A, (B, n)).astype(np.int32),
            rng.normal(size=B).astype(np.float32), nobs,
            (rng.random(B) < 0.2).astype(np.float32),
            obs.reshape(B, -1), nobs.reshape(B, -1))


def test_qmix_td_steps_match_jax():
    jcfg, tcfg = _qmix_configs(lr=3e-3, gamma=0.9)
    jalgo, talgo = JQMIX(jcfg), QMIX(tcfg)
    params, target = _moved(jalgo.params, 1), _moved(jalgo.params, 2)
    talgo.set_state({"params": params, "target": target})
    jp, jopt = params, jalgo.tx.init(params)
    rng = np.random.default_rng(0)
    for _ in range(4):
        batch = _qmix_batch(rng)
        jp, jopt, want = jalgo._td_step(jp, target, jopt, batch)
        got = talgo.td_step(tuple(torch.as_tensor(a) for a in batch))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert _max_error(talgo.params, jp, 16) <= 2e-6
        # the squared gradients' relative error is twice the gradients'
        assert _adam_error(talgo.opt, talgo.opt.param_groups[0]["params"],
                           talgo.params, jopt[0]) <= 1e-5
    # the step leaves the target alone
    _bitwise(talgo.get_state()["target"], target)


def test_qmix_collect_matches_jax():
    """64 joint steps at epsilon 0.367 (greedy and random actions mixed)
    from the same moved weights: the same actions, rewards, next
    observations and done flags, bitwise, and the numpy draws in step."""
    jcfg, tcfg = _qmix_configs(seed=3)
    jalgo, talgo = JQMIX(jcfg), QMIX(tcfg)
    state = {"params": _moved(jalgo.params, 4, scale=0.5),
             "target": _moved(jalgo.params, 5)}
    jalgo.set_state(state)
    talgo.set_state(state)
    for algo in (jalgo, talgo):
        algo._eps_step = 2000
    jalgo._collect(64)
    talgo._collect(64)
    assert len(talgo._buf) == len(jalgo._buf) == 64
    matches = 0
    for t, j in zip(talgo._buf, jalgo._buf):
        _bitwise({"o": t[0], "a": t[1], "no": t[3]},
                 {"o": j[0], "a": j[1], "no": j[3]})
        assert (t[2], t[4]) == (j[2], j[4])
        matches += j[1][0] == j[1][1]
    assert talgo.episode_returns == jalgo.episode_returns
    assert talgo._rng.random() == jalgo._rng.random()
    assert 0 < matches < 64     # both matching and clashing steps


def test_qmix_learns_coordination():
    """tests/test_rl_breadth.py:29: on the cooperative matching env the
    optimal joint return is 2 x horizon; random play averages half of it.
    The gate: above 6.0 after 14 iterations; the state round trips."""
    _, cfg = _qmix_configs(seed=1, epsilon_decay_steps=1500)
    algo = cfg.build()
    assert isinstance(algo, QMIX)
    last = {}
    for _ in range(14):
        last = algo.train()
    assert last["episode_reward_mean"] > 6.0, last   # random play: ~4
    assert np.isfinite(last["info/td_loss"])
    state = algo.get_state()
    algo.set_state(state)
    _bitwise(algo.get_state(), state)


# ---------------------------------------------------------------------------
# MADDPG
# ---------------------------------------------------------------------------

def _maddpg_configs(seed=2, **training):
    j, t = JMADDPGConfig(), MADDPGConfig().resources(device="cpu")
    j.env_fn = lambda: JCoopSpreadEnv(horizon=10)
    t.env_fn = lambda: CoopSpreadEnv(horizon=10)
    for c in (j, t):
        c.training(**training).debugging(seed=seed)
    return j, t


def _maddpg_batch(rng, B=32, n=2, d=3):
    return (rng.normal(size=(B, n, d)).astype(np.float32),
            rng.uniform(-1, 1, (B, n, 1)).astype(np.float32),
            rng.normal(size=(B, n)).astype(np.float32),
            rng.normal(size=(B, n, d)).astype(np.float32),
            (rng.random(B) < 0.2).astype(np.float32))


def test_maddpg_updates_across_the_actor_delay_match_jax():
    jcfg, tcfg = _maddpg_configs(hidden=16, actor_lr=3e-3, tau=0.1)
    jalgo, talgo = JMADDPG(jcfg), MADDPG(tcfg)
    params, target = _moved(jalgo.params, 1), _moved(jalgo.params, 2)
    talgo.set_state({"params": params, "target": target})
    jp, jt, jaopt, jcopt = params, target, jalgo.aopt, jalgo.copt
    rng = np.random.default_rng(0)
    for do_actor in (0.0, 0.0, 1.0, 1.0):
        batch = _maddpg_batch(rng)
        jp, jt, jaopt, jcopt, jcl, jal = jalgo._update(
            jp, jt, jaopt, jcopt, batch, do_actor)
        info = talgo.update(tuple(torch.as_tensor(a) for a in batch),
                            do_actor)
        np.testing.assert_allclose(float(info["critic_loss"]), float(jcl),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(info["actor_loss"]), float(jal),
                                   rtol=1e-5)
        if not do_actor:   # the actors stay put, bit for bit, in both
            _bitwise(talgo.params["actors"], params["actors"])
            _bitwise(jax.device_get(jp["actors"]), params["actors"])
        assert _max_error(talgo.params, jp, 24) <= 2e-6
        assert _max_error(talgo.target, jt, 24) <= 2e-6
        assert _adam_error(talgo.aopt, talgo._actor_leaves,
                           talgo.params["actors"], jaopt[0]) <= 2e-6
        assert _adam_error(talgo.copt, talgo._critic_leaves,
                           talgo.params["critics"], jcopt[0]) <= 2e-6
    assert _max_error(talgo.params["actors"], params["actors"]) > 1e-4


def test_maddpg_act_matches_jax():
    jcfg, tcfg = _maddpg_configs()
    jalgo, talgo = JMADDPG(jcfg), MADDPG(tcfg)
    params = _moved(jalgo.params, 3, scale=0.3)
    talgo.set_state({"params": params, "target": params})
    obs = talgo._stack_obs(CoopSpreadEnv(seed=9).reset())
    got = talgo._act(talgo.params["actors"], obs)
    assert got.shape == (2, 1) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(jalgo._act(params["actors"], obs)), atol=1e-6,
        rtol=0)


def test_maddpg_learns_coordination():
    """tests/test_rl_breadth.py:81: hit a shared target AND agree. Random
    play scores about -0.9/step; coordinated play approaches 0."""
    _, cfg = _maddpg_configs(seed=2)
    algo = cfg.build()
    assert isinstance(algo, MADDPG)
    last = {}
    for _ in range(12):
        last = algo.train()
    assert last["episode_reward_mean"] > -5.5, last  # random: ~ -9
    errs = []
    env = CoopSpreadEnv(horizon=10, seed=77)
    for _ in range(5):
        obs = env.reset()
        a = np.asarray(algo._act(algo.params["actors"],
                                 algo._stack_obs(obs))).ravel()
        errs.append(max(abs(a[0] - env.target), abs(a[1] - env.target)))
    assert float(np.median(errs)) < 0.3, errs
    state = algo.get_state()
    algo.set_state(state)
    _bitwise(algo.get_state(), state)


@pytest.mark.parametrize("name", ["qmix", "maddpg"])
def test_checkpoint_crosses_the_stacks(name):
    jcfg, tcfg = (_qmix_configs() if name == "qmix" else _maddpg_configs())
    jalgo, talgo = jcfg.build(), tcfg.build()
    state = jax.tree.map(np.asarray, jalgo.get_state())
    moved = {"params": _moved(state["params"], 1),
             "target": _moved(state["target"], 2)}
    talgo.set_state(moved)
    _bitwise(talgo.get_state(), moved)
    jalgo.set_state(talgo.get_state())
    _bitwise(jax.tree.map(np.asarray, jalgo.get_state()), moved)
