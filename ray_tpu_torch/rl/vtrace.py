"""V-trace: off-policy corrected value targets (IMPALA/APPO). Ported from
``ray_tpu/rl/vtrace.py``.

Role parity: rllib/algorithms/impala/vtrace.py. The JAX function is one
reverse ``lax.scan`` over the time axis on [T, N] arrays; here the
recurrence is a loop over T, one fused multiply-add (``addcmul``) a step on
the device, under ``torch.no_grad()``: the JAX function stops the gradient
on both outputs. About T + 12 kernels a call (T is 32-50 on these paths).

Math (Espeholt et al. 2018):
    delta_t = rho_t (r_t + gamma_t V(x_{t+1}) - V(x_t))
    vs_t    = V(x_t) + delta_t + gamma_t c_t (vs_{t+1} - V(x_{t+1}))
    adv_t   = rho_t (r_t + gamma_t vs_{t+1} - V(x_t))
with rho_t = min(rho_bar, pi/mu), c_t = min(c_bar, pi/mu), and gamma_t = 0
across episode boundaries (dones).
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def vtrace_returns(behavior_logp, target_logp, rewards, values, dones,
                   bootstrap_value, *, gamma: float = 0.99,
                   rho_bar: float = 1.0, c_bar: float = 1.0):
    """All inputs [T, N] tensors on one device (bootstrap_value [N]) ->
    (vs [T, N], pg_adv [T, N]), neither carrying a gradient.

    ``dones[t]=1`` means the episode ended after step t: the next state's
    value does not flow back across the boundary.
    """
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=rho_bar)
    clipped_cs = torch.clamp(rhos, max=c_bar)
    discounts = gamma * (1.0 - dones)

    values_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    # Within-trajectory bootstrap: the value AFTER a terminal step is 0 via
    # the discount mask, so values_next needs no done handling itself.
    deltas = clipped_rhos * (rewards + discounts * values_next - values)
    decay = discounts * clipped_cs
    # acc_t = vs_t - V(x_t) = delta_t + gamma_t c_t acc_{t+1}
    acc = torch.empty_like(deltas)
    carry = torch.zeros_like(bootstrap_value)
    for t in reversed(range(deltas.shape[0])):
        carry = torch.addcmul(deltas[t], decay[t], carry, out=acc[t])
    vs = values + acc

    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = clipped_rhos * (rewards + discounts * vs_next - values)
    return vs, pg_adv


def vtrace_reference(behavior_logp, target_logp, rewards, values, dones,
                     bootstrap_value, *, gamma=0.99, rho_bar=1.0,
                     c_bar=1.0):
    """Slow numpy double-loop implementation of the same recurrences, for
    tests only (a copy of the JAX package's)."""
    T, N = rewards.shape
    rhos = np.minimum(rho_bar, np.exp(target_logp - behavior_logp))
    cs = np.minimum(c_bar, np.exp(target_logp - behavior_logp))
    disc = gamma * (1.0 - dones)
    v_next = np.concatenate([values[1:], bootstrap_value[None]], axis=0)
    deltas = rhos * (rewards + disc * v_next - values)
    vs = np.zeros((T, N))
    acc = np.zeros(N)
    for t in reversed(range(T)):
        acc = deltas[t] + disc[t] * cs[t] * acc
        vs[t] = values[t] + acc
    vs_next = np.concatenate([vs[1:], bootstrap_value[None]], axis=0)
    pg_adv = rhos * (rewards + disc * vs_next - values)
    return vs, pg_adv
