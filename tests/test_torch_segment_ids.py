"""``segment_ids`` in the port's ``attention_reference``, the packed-sequence
mask, held to ``ray_tpu/ops/attention.py:attention_reference``.

The same seeded numpy inputs and segment ids go through both functions on
the CPU at float32, causal on and off, with GQA. A query sees only keys of
its own segment, ANDed with the causal mask. A query row whose segment has
no key at all softmaxes over ``NEG_INF`` alone in both stacks and comes out
as the uniform mean of every value, not as zeros: the port must give what
JAX gives there too. Tolerance: 1e-5 on outputs (float32 sums taken in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

TOL = 1e-5

# (b, sq, sk, h, kvh, d): square, sq < sk, GQA
SHAPES = [(2, 32, 32, 4, 4, 16), (2, 16, 48, 4, 4, 16), (2, 32, 32, 8, 2, 16)]


def _inputs(b, sq, sk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, sk, kvh, d), np.float32)
    v = rng.standard_normal((b, sk, kvh, d), np.float32)
    # packed rows: sorted segment ids, a few segments a row
    seg_k = np.sort(rng.integers(0, 4, (b, sk)), axis=1).astype(np.int32)
    seg_q = seg_k[:, sk - sq:].copy()
    return q, k, v, seg_q, seg_k


def _both(q, k, v, seg_q, seg_k, causal):
    want = np.asarray(jattn.attention_reference(
        *map(jnp.asarray, (q, k, v)), causal=causal,
        segment_ids=(jnp.asarray(seg_q), jnp.asarray(seg_k))))
    got = tattn.attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal=causal,
        segment_ids=(torch.from_numpy(seg_q),
                     torch.from_numpy(seg_k))).numpy()
    return want, got


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_segment_ids_match_jax(shape, causal):
    q, k, v, seg_q, seg_k = _inputs(*shape, seed=sum(shape))
    want, got = _both(q, k, v, seg_q, seg_k, causal)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the mask matters: without it the outputs differ
    plain = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal).numpy()
    assert np.abs(plain - got).max() > 1e-2


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_rows_average_every_value_like_jax(causal):
    """Query segment 9 has no key, so its rows (and, under the causal mask,
    a row whose own segment starts after it) see nothing: a uniform
    softmax over NEG_INF, the mean of every value, in both stacks."""
    q, k, v, seg_q, seg_k = _inputs(2, 16, 16, 4, 2, 16, seed=7)
    seg_q[0, :5] = 9
    seg_q[1, 11] = 9
    want, got = _both(q, k, v, seg_q, seg_k, causal)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    mean_v = np.repeat(v, 2, axis=2).mean(axis=1)      # [b, h, d]
    np.testing.assert_allclose(got[0, :5], np.broadcast_to(
        mean_v[0], (5,) + mean_v[0].shape), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1, 11], mean_v[1], atol=TOL, rtol=TOL)
    assert np.abs(got[0, :5]).max() > 0


def test_one_segment_is_the_plain_mask():
    q, k, v, _, _ = _inputs(2, 32, 32, 4, 4, 16, seed=3)
    ones = torch.ones(2, 32, dtype=torch.int32)
    for causal in (True, False):
        with_seg = tattn.attention_reference(
            *map(torch.from_numpy, (q, k, v)), causal=causal,
            segment_ids=(ones, ones))
        plain = tattn.attention_reference(
            *map(torch.from_numpy, (q, k, v)), causal=causal)
        assert torch.equal(with_seg, plain)
