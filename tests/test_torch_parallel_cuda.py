"""The parallel layer on the card, one rank. Every test is marked ``cuda``
and skips without a CUDA card. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_parallel_cuda.py

``build_mesh(MeshSpec())`` starts a one-rank NCCL group (destroyed after
the file's tests); on it every collective returns its input bitwise
(``ring_permute`` sends nothing), ring and Ulysses attention equal
``attention_reference`` and the pipeline the plain stack of its stage
(f32, TF32 off: 1e-5, sums in another order), the mesh train step (a small
f32 model through the flash kernels) takes the one-device step's losses and
parameters within 1e-4 and launches the same kernels, and the PPO learner
with the mesh takes the one-device learner's weights within 1e-5.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import TransformerConfig, transformer_init
from ray_tpu_torch.ops import attention_reference, flash, pipeline
from ray_tpu_torch.ops import ring_attention, ulysses_attention
from ray_tpu_torch.parallel import MeshSpec, build_mesh
from ray_tpu_torch.parallel import collectives as c
from ray_tpu_torch.parallel.mesh import AXIS_ORDER

TOL = 1e-5
STEP_TOL = 1e-4


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = build_mesh(MeshSpec())
    yield mesh
    torch.backends.cuda.matmul.allow_tf32 = saved
    dist.destroy_process_group()


@pytest.mark.cuda
def test_one_rank_nccl_mesh(mesh):
    import torch.distributed as dist
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    assert mesh.device_type == "cuda"
    assert mesh.mesh_dim_names == AXIS_ORDER
    assert tuple(mesh.mesh.shape) == (1,) * 7


@pytest.mark.cuda
@pytest.mark.parametrize("axis", list(AXIS_ORDER) + [("dp", "fsdp")])
def test_every_collective_is_the_identity_at_one_rank(mesh, axis):
    x = torch.randn(4, 6, device="cuda")
    with c.axis_env(mesh):
        outs = [c.allreduce_sum(x, axis), c.allreduce_mean(x, axis),
                c.allreduce_max(x, axis), c.allreduce_min(x, axis),
                c.allgather(x, axis), c.allgather(x, axis, concat_dim=1),
                c.reducescatter(x, axis), c.alltoall(x, axis, split_dim=0,
                                                     concat_dim=1)]
        if isinstance(axis, str):
            outs += [c.ring_permute(x, axis), c.broadcast_from(x, axis)]
        assert c.axis_index(axis) == 0 and c.axis_size(axis) == 1
        assert c.allgather(x, axis, tiled=False).shape == (1, 4, 6)
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, x)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_at_one_rank(mesh, impl, causal):
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(2, 128, 4, 32, generator=g, device="cuda")
               for _ in range(3))
    fn = ring_attention if impl == "ring" else ulysses_attention
    got = fn(q, k, v, mesh, causal=causal).full_tensor()
    want = attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_pipeline_at_one_rank_is_the_stage(mesh):
    g = torch.Generator(device="cuda").manual_seed(1)
    w = torch.randn(1, 3, 16, 16, generator=g, device="cuda") * 0.3
    x = torch.randn(2, 5, 16, generator=g, device="cuda")

    def stage(p, a):
        for i in range(p["w"].shape[0]):
            a = torch.tanh(a @ p["w"][i])
        return a

    got = pipeline.pipeline_apply(stage, {"w": w}, x, mesh).full_tensor()
    torch.testing.assert_close(got, stage({"w": w[0]}, x), atol=TOL,
                               rtol=TOL)


def _launches():
    return (flash.launches, flash.bwd_dkv_launches, flash.bwd_dq_launches,
            flash.bwd_delta_launches)


@pytest.mark.cuda
def test_mesh_train_step_takes_the_one_device_steps(mesh):
    from ray_tpu_torch.train import make_lm_train_step
    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                            n_heads=2, max_seq=128, dtype=torch.float32,
                            attn_impl="flash")
    tokens = np.random.default_rng(2).integers(0, 256, (4, 128))
    host = transformer_init(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
    runs = []
    for m in (None, mesh):
        init_fn, step_fn, place = make_lm_train_step(cfg, m)
        state = init_fn(_to_cuda(host))
        batch = place({"tokens": tokens})
        before = _launches()
        losses = []
        for _ in range(2):
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"].item())
        launched = tuple(a - b for a, b in zip(_launches(), before))
        params = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                  for k, v in _flat(state.params).items()}
        runs.append((losses, launched, params))
    (want, want_n, want_p), (got, got_n, got_p) = runs
    assert got_n == want_n == (2 * 2 * 2, 2 * 2, 2 * 2, 2 * 2)
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)
    for k in want_p:
        torch.testing.assert_close(got_p[k], want_p[k], atol=STEP_TOL,
                                   rtol=0)


def _to_cuda(tree):
    return {k: _to_cuda(v) if isinstance(v, dict) else
            v.detach().to("cuda") for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.cuda
def test_ppo_learner_with_a_one_rank_mesh(mesh):
    from ray_tpu_torch.rl import PPOLearner, SampleBatch
    from ray_tpu_torch.rl import sample_batch as sb
    spec = {"obs_dim": 6, "num_actions": 3, "hiddens": (32, 32)}
    rng = np.random.default_rng(4)
    f32 = lambda x: np.asarray(x, np.float32)
    batch = SampleBatch({
        sb.OBS: f32(rng.standard_normal((64, 6))),
        sb.ACTIONS: f32(rng.integers(0, 3, 64)),
        sb.ACTION_LOGP: f32(np.log(1 / 3) + 0.3 * rng.standard_normal(64)),
        sb.ADVANTAGES: f32(rng.standard_normal(64)),
        sb.VF_PREDS: f32(rng.standard_normal(64)),
        sb.VALUE_TARGETS: f32(rng.standard_normal(64)),
    })
    learners = [PPOLearner(spec, mesh=m, num_sgd_iter=2,
                           sgd_minibatch_size=16) for m in (None, mesh)]
    stats = [learner.update(batch) for learner in learners]
    for k in stats[0]:
        np.testing.assert_allclose(stats[1][k], stats[0][k], rtol=TOL,
                                   atol=1e-7)
    for a, b in zip(_leaf_list(learners[0].get_weights()),
                    _leaf_list(learners[1].get_weights())):
        np.testing.assert_allclose(b, a, atol=TOL)


def _leaf_list(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaf_list(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaf_list(v)]
    return [tree]

