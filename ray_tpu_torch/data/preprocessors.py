"""Dataset preprocessors: fit statistics on a Dataset, transform lazily.
Ported from ``ray_tpu/data/preprocessors.py``.

Role parity: python/ray/data/preprocessors/ (Preprocessor base with
fit/transform/fit_transform over Datasets; scalers, encoders, imputers,
Chain, Concatenator). Fitting aggregates statistics with ONE pass of
per-block tasks; transform is a lazy ``map_batches`` stage, so it rides the
streaming executor and composes with any other Dataset op.
``Concatenator`` packs feature columns into the dense matrix a train step
consumes.

Where the port differs from the JAX module: the per-block fit functions
are module-level functions bound with ``functools.partial`` (the JAX
module's are closures), because the port sends a data function to cluster
workers by import path (ROADMAP.md C). ``transform`` maps the bound method
``_transform_batch``, which pickles with its instance, so a preprocessor
class is defined at module level.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import numpy as np


class Preprocessor:
    """fit() computes state from a Dataset; transform() applies lazily."""

    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted and type(self)._fit is not Preprocessor._fit:
            raise RuntimeError(
                f"{type(self).__name__} must be fit before transform")
        fn = self._transform_batch
        return ds.map_batches(fn, batch_format="numpy")

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> dict:
        """Apply to one in-memory batch (serving-time single records)."""
        return self._transform_batch(batch)

    # -- subclass hooks --------------------------------------------------
    def _fit(self, ds) -> None:
        pass

    def _transform_batch(self, batch: Dict[str, np.ndarray]) -> dict:
        raise NotImplementedError


def _block_stats(batch, columns: List[str]):
    """Per-column count/sum/sumsq/min/max of one block."""
    out = {}
    for c in columns:
        v = np.asarray(batch[c], dtype=np.float64)
        out[c] = {"n": np.array([v.size]),
                  "sum": np.array([v.sum()]),
                  "sumsq": np.array([(v * v).sum()]),
                  "min": np.array([v.min() if v.size else np.inf]),
                  "max": np.array([v.max() if v.size else -np.inf])}
    # flatten to columns for the block format
    return {f"{c}:{k}": out[c][k] for c in columns for k in out[c]}


def _column_stats(ds, columns: List[str]) -> Dict[str, dict]:
    """One distributed pass: per-column count/sum/sumsq/min/max."""
    rows = ds.map_batches(functools.partial(_block_stats, columns=columns),
                          batch_format="numpy").take_all()
    stats: Dict[str, dict] = {}
    for c in columns:
        n = sum(r[f"{c}:n"] for r in rows)
        s = sum(r[f"{c}:sum"] for r in rows)
        ss = sum(r[f"{c}:sumsq"] for r in rows)
        mean = s / max(n, 1)
        var = max(ss / max(n, 1) - mean * mean, 0.0)
        stats[c] = {
            "mean": float(mean), "std": float(np.sqrt(var)),
            "min": float(min(r[f"{c}:min"] for r in rows)),
            "max": float(max(r[f"{c}:max"] for r in rows)),
            "count": int(n),
        }
    return stats


def _uniques(batch, column: str):
    return {"u": np.unique(np.asarray(batch[column]))}


def _nan_stats(batch, columns: List[str]):
    """Per-column count and sum of the non-NaN values of one block."""
    out = {}
    for c in columns:
        v = np.asarray(batch[c], np.float64)
        ok = ~np.isnan(v)
        out[f"{c}:n"] = np.array([ok.sum()])
        out[f"{c}:sum"] = np.array([v[ok].sum()])
    return out


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (preprocessors/scaler.py parity)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, dict] = {}

    def _fit(self, ds) -> None:
        self.stats_ = _column_stats(ds, self.columns)

    def _transform_batch(self, batch):
        batch = dict(batch)
        stats = self.stats_
        for c in self.columns:
            s = stats[c]
            denom = s["std"] or 1.0
            batch[c] = (np.asarray(batch[c], np.float64) - s["mean"]) / denom
        return batch


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, dict] = {}

    def _fit(self, ds) -> None:
        self.stats_ = _column_stats(ds, self.columns)

    def _transform_batch(self, batch):
        batch = dict(batch)
        for c in self.columns:
            s = self.stats_[c]
            span = (s["max"] - s["min"]) or 1.0
            batch[c] = (np.asarray(batch[c], np.float64) - s["min"]) / span
        return batch


class LabelEncoder(Preprocessor):
    """Map a categorical column to dense int codes."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: List[Any] = []

    def _fit(self, ds) -> None:
        uniques = functools.partial(_uniques, column=self.label_column)
        vals = set()
        for r in ds.map_batches(uniques, batch_format="numpy").take_all():
            vals.add(r["u"])
        self.classes_ = sorted(vals)

    def _transform_batch(self, batch):
        batch = dict(batch)
        index = {v: i for i, v in enumerate(self.classes_)}
        # unseen categories code to -1 (explicit sentinel, not a KeyError
        # buried in a remote task)
        batch[self.label_column] = np.asarray(
            [index.get(v, -1) for v in np.asarray(batch[self.label_column])],
            np.int64)
        return batch


class OneHotEncoder(Preprocessor):
    """Expand categorical columns into 0/1 indicator columns."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.categories_: Dict[str, List[Any]] = {}

    def _fit(self, ds) -> None:
        for c in self.columns:
            enc = LabelEncoder(c)
            enc._fit(ds)
            self.categories_[c] = enc.classes_

    def _transform_batch(self, batch):
        batch = dict(batch)
        for c in self.columns:
            vals = np.asarray(batch.pop(c))
            for cat in self.categories_[c]:
                batch[f"{c}_{cat}"] = (vals == cat).astype(np.int8)
        return batch


class SimpleImputer(Preprocessor):
    """Fill NaNs with the fitted mean (or a constant)."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Optional[float] = None):
        if strategy not in ("mean", "constant"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats_: Dict[str, float] = {}

    def _fit(self, ds) -> None:
        if self.strategy == "constant":
            self.stats_ = {c: float(self.fill_value or 0.0)
                           for c in self.columns}
            return
        rows = ds.map_batches(
            functools.partial(_nan_stats, columns=self.columns),
            batch_format="numpy").take_all()
        for c in self.columns:
            n = sum(r[f"{c}:n"] for r in rows)
            s = sum(r[f"{c}:sum"] for r in rows)
            self.stats_[c] = float(s / max(n, 1))

    def _transform_batch(self, batch):
        batch = dict(batch)
        for c in self.columns:
            v = np.asarray(batch[c], np.float64)
            batch[c] = np.where(np.isnan(v), self.stats_[c], v)
        return batch


class Concatenator(Preprocessor):
    """Pack columns into one dense float matrix column (the shape compiled
    train steps consume)."""

    def __init__(self, columns: List[str], output_column: str = "features",
                 dtype=np.float32):
        self.columns = list(columns)
        self.output_column = output_column
        self.dtype = dtype
        self._fitted = True

    def _transform_batch(self, batch):
        batch = dict(batch)
        mat = np.stack([np.asarray(batch.pop(c), self.dtype)
                        for c in self.columns], axis=1)
        batch[self.output_column] = mat
        return batch


class Chain(Preprocessor):
    """Sequential composition; fit() fits each stage on the progressively
    transformed dataset (preprocessors/chain.py parity)."""

    def __init__(self, *stages: Preprocessor):
        self.stages = list(stages)

    def fit(self, ds) -> "Chain":
        cur = ds
        for p in self.stages:
            p.fit(cur)
            cur = p.transform(cur)
        self._fitted = True
        return self

    def transform(self, ds):
        for p in self.stages:
            ds = p.transform(ds)
        return ds

    def _transform_batch(self, batch):
        for p in self.stages:
            batch = p._transform_batch(batch)
        return batch
