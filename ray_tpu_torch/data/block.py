"""Blocks: the distributed unit of a Dataset. Ported from
``ray_tpu/data/block.py``.

Role parity: python/ray/data/block.py:237 (BlockAccessor) over Ray Data's
"numpy" batch format. A block is a ``dict`` of equal-length numpy columns:

- a scalar column is a 1-d array (int64, float64, bool, ...);
- a tensor column is an ndarray of shape ``(rows, *cell_shape)``, which
  takes the place of the JAX package's ``ArrowTensorType`` column;
- a text or bytes column is an object array of ``str`` or ``bytes``:
  numpy's ``U`` dtype pads every string to the longest and stores 4 bytes a
  character, so a column of documents would grow several-fold.

Blocks travel through the object store as numpy buffers out of band, and
come back as read-only views.

Where the port differs from the JAX module (ROADMAP.md C):

- ``schema()`` maps each column name to ``(dtype, cell shape)``, where the
  JAX package returns a ``pyarrow.Schema``.
- ``to_rows()`` gives Python scalars for 0-d cells and ndarrays for tensor
  cells, where pyarrow's ``to_pylist`` gives (flat) lists.
- ``size_bytes()`` counts a text column as pyarrow's ``nbytes`` does (its
  UTF-8 bytes and a 4-byte offset a row), not as the object array's
  memory; a bool column counts a byte a row, where Arrow packs bits.
- The ``"pandas"`` and ``"pyarrow"`` batch formats import pandas and
  pyarrow inside the call, and raise ``ImportError`` naming the package
  where it is absent. Nothing here imports either at module level.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]


def _column(values: List[Any]) -> np.ndarray:
    """Python values of one column -> its numpy column."""
    if values and all(isinstance(v, (str, bytes)) for v in values):
        return _objects(values)
    if values and all(isinstance(v, (np.ndarray, list, tuple))
                      for v in values):
        arrs = [np.asarray(v) for v in values]
        if len({a.shape for a in arrs}) == 1 and arrs[0].dtype != object:
            return np.stack(arrs)
        return _objects(arrs)
    arr = np.asarray(values)
    if arr.dtype.kind in "US":
        return _as_object(arr)
    return arr


def _objects(values: List[Any]) -> np.ndarray:
    """A 1-d object array of the given values (arrays stay cells)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _as_object(arr: np.ndarray) -> np.ndarray:
    out = np.empty(arr.shape, dtype=object)
    out[...] = arr.tolist()
    return out


def block_from_rows(rows: List[Any]) -> Block:
    """Rows: dicts -> columns; scalars -> single 'item' column."""
    if rows and isinstance(rows[0], dict):
        cols: Dict[str, list] = {}
        for r in rows:
            for k in r:
                cols.setdefault(k, [])
        for r in rows:
            for k in cols:
                cols[k].append(r.get(k))
        return {k: _column(v) for k, v in cols.items()}
    return {"item": _column(list(rows))}


def block_from_numpy(arrays: Dict[str, np.ndarray]) -> Block:
    out = {}
    n = None
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.ndim == 0:
            v = v.reshape(1)
        if v.dtype.kind in "US":
            v = _as_object(v)
        if n is not None and len(v) != n:
            raise ValueError(f"column {k!r} has {len(v)} rows, the block "
                             f"{n}")
        n = len(v)
        out[k] = v
    return out


def block_from_pandas(df) -> Block:
    """A pandas DataFrame -> block (pandas is the caller's: it made it)."""
    out = {}
    for name in df.columns:
        col = df[name].to_numpy()
        if col.dtype == object and len(col) and \
                isinstance(col[0], np.ndarray):
            col = _column(list(col))
        out[str(name)] = col
    return block_from_numpy(out)


class BlockAccessor:
    """Uniform view over a block (parity: block.py:237)."""

    def __init__(self, block: Block):
        if not isinstance(block, dict):
            raise TypeError(f"block must be a dict of numpy columns, got "
                            f"{type(block)}")
        self.block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        for v in self.block.values():
            return len(v)
        return 0

    def size_bytes(self) -> int:
        total = 0
        for v in self.block.values():
            if v.dtype == object:
                total += 4 * len(v) + sum(
                    len(x.encode("utf-8")) if isinstance(x, str)
                    else len(x) if isinstance(x, bytes) else 8
                    for x in v)
            else:
                total += v.nbytes
        return total

    def schema(self) -> Dict[str, tuple]:
        return {k: (v.dtype, tuple(v.shape[1:]))
                for k, v in self.block.items()}

    def to_numpy(self, columns: Optional[List[str]] = None
                 ) -> Dict[str, np.ndarray]:
        cols = columns or list(self.block)
        return {name: self.block[name] for name in cols}

    def to_pandas(self):
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError("to_pandas / batch_format='pandas' needs "
                              "pandas, which is not installed") from e
        data = {}
        for k, v in self.block.items():
            if v.ndim > 1:
                v = _objects(list(v))
            data[k] = v
        return pd.DataFrame(data)

    def to_arrow(self):
        from ray_tpu_torch.data.tensor_ext import block_to_arrow
        return block_to_arrow(self.block)

    def to_rows(self) -> List[dict]:
        names = list(self.block)
        cols = [self.block[k] for k in names]
        plain = [c.ndim == 1 and c.dtype != object for c in cols]
        lists = [c.tolist() if p else c for c, p in zip(cols, plain)]
        return [{k: col[i] for k, col in zip(names, lists)}
                for i in range(self.num_rows())]

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self.block.items()}

    def take_indices(self, indices: np.ndarray) -> Block:
        idx = np.asarray(indices, dtype=np.int64)
        return {k: v[idx] for k, v in self.block.items()}

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks
                  if BlockAccessor(b).num_rows() > 0] or blocks[:1]
        if len(blocks) == 1:
            return blocks[0]
        names: List[str] = []
        for b in blocks:
            names.extend(k for k in b if k not in names)
        out = {}
        for k in names:
            parts = []
            for b in blocks:
                if k in b:
                    parts.append(b[k])
                else:   # a missing column reads as nulls, as in Arrow
                    parts.append(np.full(BlockAccessor(b).num_rows(), None,
                                         dtype=object))
            out[k] = np.concatenate(parts)
        return out


def _is_arrow_table(batch: Any) -> bool:
    pa = sys.modules.get("pyarrow")
    return pa is not None and isinstance(batch, pa.Table)


def _is_dataframe(batch: Any) -> bool:
    pd = sys.modules.get("pandas")
    return pd is not None and isinstance(batch, pd.DataFrame)


def normalize_batch_to_block(batch: Any) -> Block:
    """Map outputs -> block: dict-of-arrays | rows | pyarrow | pandas.
    A pyarrow or pandas batch can only come from a caller that loaded the
    package, so neither is imported to recognise it."""
    if isinstance(batch, dict):
        return block_from_numpy(batch)
    if isinstance(batch, list):
        return block_from_rows(batch)
    if _is_arrow_table(batch):
        from ray_tpu_torch.data.tensor_ext import block_from_arrow
        return block_from_arrow(batch)
    if _is_dataframe(batch):
        return block_from_pandas(batch)
    raise TypeError(f"cannot convert {type(batch)} to a Block")


def format_batch(block: Block, batch_format: str):
    acc = BlockAccessor(block)
    if batch_format in ("numpy", "default"):
        return acc.to_numpy()
    if batch_format == "pandas":
        return acc.to_pandas()
    if batch_format in ("pyarrow", "arrow"):
        return acc.to_arrow()
    if batch_format == "rows":
        return acc.to_rows()
    raise ValueError(f"unknown batch_format {batch_format!r}")
