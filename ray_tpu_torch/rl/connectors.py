"""Connectors: composable obs/action transform pipelines.

Role parity: rllib/connectors/ — small stateful transforms between env and
policy (agent/obs side) and between policy and env (action side), kept
OUTSIDE the model so they checkpoint/restore with the worker and stay
consistent between sampling and serving. Transforms are vectorized
numpy on the host, so the policy forward on the device stays pure.

A copy of ``ray_tpu/rl/connectors.py`` (the port imports nothing of the JAX
package); what each class computes is unchanged.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Connector:
    """One transform. ``__call__`` maps a batched array to a batched
    array; get_state/set_state make pipelines checkpointable."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def get_state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass


class FlattenObs(Connector):
    """[B, ...] -> [B, prod(...)] (connectors/agent/obs_preproc role)."""

    def __call__(self, x):
        x = np.asarray(x)
        return x.reshape(x.shape[0], -1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def __call__(self, x):
        return np.clip(x, self.low, self.high)


class MeanStdObs(Connector):
    """Running mean/std normalization (Welford), the classic obs filter
    (parity: rllib's MeanStdFilter connector). Frozen via ``update=False``
    for evaluation."""

    def __init__(self, eps: float = 1e-8, update: bool = True):
        self.eps = eps
        self.update = update
        self._n = 0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def __call__(self, x):
        x = np.asarray(x, np.float64)
        if self.update and len(x):
            # batched Welford (Chan parallel merge): O(1) numpy calls per
            # batch, not per row
            bn = len(x)
            bmean = x.mean(axis=0)
            bm2 = ((x - bmean) ** 2).sum(axis=0)
            if self._mean is None:
                self._n, self._mean, self._m2 = bn, bmean, bm2
            else:
                delta = bmean - self._mean
                tot = self._n + bn
                self._mean = self._mean + delta * (bn / tot)
                self._m2 = self._m2 + bm2 + \
                    delta * delta * (self._n * bn / tot)
                self._n = tot
        if self._mean is None or self._n < 2:
            return x.astype(np.float32)
        std = np.sqrt(self._m2 / (self._n - 1)) + self.eps
        return ((x - self._mean) / std).astype(np.float32)

    def get_state(self) -> dict:
        # copies: a checkpointed state must not alias live (mutating) stats
        return {"n": self._n,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state: dict) -> None:
        self._n = state["n"]
        self._mean = None if state["mean"] is None else \
            np.array(state["mean"], np.float64)
        self._m2 = None if state["m2"] is None else \
            np.array(state["m2"], np.float64)


class ClipActions(Connector):
    """Bound continuous actions to the env's action range
    (connectors/action/clip role)."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, a):
        return np.clip(a, self.low, self.high)


class UnsquashActions(Connector):
    """Map tanh-squashed [-1, 1] policy outputs to [low, high]."""

    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def __call__(self, a):
        a = np.tanh(np.asarray(a, np.float64))
        return (self.low + (a + 1.0) * 0.5 *
                (self.high - self.low)).astype(np.float32)


class ConnectorPipeline(Connector):
    """Ordered composition with aggregate state."""

    def __init__(self, connectors: List[Connector]):
        self.connectors = list(connectors)

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x

    def get_state(self) -> dict:
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: dict) -> None:
        for i, c in enumerate(self.connectors):
            if i in state or str(i) in state:
                c.set_state(state.get(i, state.get(str(i))))

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self
