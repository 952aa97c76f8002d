"""Datasources: readers/writers for files and in-memory data. Ported from
``ray_tpu/data/datasource.py``.

Role parity: python/ray/data/datasource/ + read_api.py — range, from_items,
from_numpy, from_pandas/arrow, read_parquet/csv/json/numpy/binary_files,
write_parquet/csv/json. File reads fan out one task per file (the
reference's read-task model) so IO parallelizes across the cluster.

Where the port differs from the JAX module (ROADMAP.md C):

- CSV and JSON are read and written with the standard library, where the
  JAX package uses pyarrow (and pandas to write JSON). The readers infer
  what pyarrow's readers infer: int64, then bool, then float64, then str,
  per column; pyarrow's null spellings in a numeric column read as NaN,
  as pyarrow's ``to_numpy`` gives them.
- Parquet, ``from_arrow``, ``from_pandas`` and ``read_images`` import
  pyarrow, pandas or PIL inside the call, and raise ``ImportError`` naming
  the package where it is absent. This is an optional format, not a
  fallback: no path switches to something else.
"""

from __future__ import annotations

import builtins
import csv
import json
import os
import re
from typing import Any, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (BlockAccessor, _objects,
                                      block_from_numpy, block_from_rows)
from ray_tpu_torch.data.dataset import Dataset


def _put_blocks(blocks) -> Dataset:
    import ray_tpu_torch as rt
    return Dataset([rt.put(b) for b in blocks])


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    edges = np.linspace(0, n, min(parallelism, max(1, n)) + 1, dtype=np.int64)
    blocks = [block_from_numpy({"id": np.arange(a, b)})
              for a, b in zip(edges[:-1], edges[1:]) if b > a]
    return _put_blocks(blocks)


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    if not items:
        return Dataset([])
    chunks = np.array_split(np.arange(len(items)),
                            min(parallelism, len(items)))
    blocks = [block_from_rows([items[i] for i in c]) for c in chunks if len(c)]
    return _put_blocks(blocks)


def from_numpy(arrays, *, column: str = "data") -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    return _put_blocks([block_from_numpy({column: a}) for a in arrays])


def from_pandas(dfs) -> Dataset:
    from ray_tpu_torch.data.block import block_from_pandas
    if not isinstance(dfs, list):
        dfs = [dfs]
    return _put_blocks([block_from_pandas(df) for df in dfs])


def from_arrow(tables) -> Dataset:
    from ray_tpu_torch.data.tensor_ext import block_from_arrow
    if not isinstance(tables, list):
        tables = [tables]
    return _put_blocks([block_from_arrow(t) for t in tables])


def _expand_paths(path, suffix: Optional[str] = None) -> List[str]:
    paths = path if isinstance(path, list) else [path]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if suffix is None or name.endswith(suffix):
                    out.append(os.path.join(p, name))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files under {path}")
    return out


def _parquet():
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("parquet needs pyarrow, which is not "
                          "installed") from e
    return pq


def _read_parquet_file(path: str):
    from ray_tpu_torch.data.tensor_ext import block_from_arrow
    return block_from_arrow(_parquet().read_table(path))


# -- CSV and JSON, with pyarrow's type inference ---------------------------

# pyarrow.csv's default null spellings (ConvertOptions.null_values)
_CSV_NULLS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a", "nan", "null"])
_CSV_TRUE = frozenset(["1", "True", "TRUE", "true"])
_CSV_FALSE = frozenset(["0", "False", "FALSE", "false"])
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\Z")


def _csv_column(cells: List[str]) -> np.ndarray:
    """One CSV column's text -> numpy, in pyarrow's order of inference."""
    nulls = [c in _CSV_NULLS for c in cells]
    present = [c for c, null in zip(cells, nulls) if not null]
    if not present:
        return _objects([None] * len(cells))
    if all(_INT.match(c) and -(1 << 63) <= int(c) < (1 << 63)
           for c in present):
        if not any(nulls):
            return np.array([int(c) for c in cells], dtype=np.int64)
        return np.array([np.nan if null else float(c)
                         for c, null in zip(cells, nulls)])
    if all(c in _CSV_TRUE or c in _CSV_FALSE for c in present):
        if not any(nulls):
            return np.array([c in _CSV_TRUE for c in cells])
        return _objects([None if null else c in _CSV_TRUE
                         for c, null in zip(cells, nulls)])
    if all(_FLOAT.match(c) for c in present):
        return np.array([np.nan if null else float(c)
                         for c, null in zip(cells, nulls)])
    return _objects(cells)


def _read_csv_file(path: str):
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    if not rows:
        return {}
    names, body = rows[0], rows[1:]
    return block_from_numpy({name: _csv_column([r[i] for r in body])
                             for i, name in enumerate(names)})


def _json_column(values: List[Any]) -> np.ndarray:
    """One JSON column's values -> numpy, as pyarrow.json infers them."""
    present = [v for v in values if v is not None]
    nulls = len(present) < len(values)
    if present and all(isinstance(v, bool) for v in present):
        return _objects(values) if nulls else np.array(values, dtype=bool)
    if present and all(isinstance(v, (int, float)) and
                       not isinstance(v, bool) for v in present):
        if all(isinstance(v, int) for v in present) and not nulls:
            return np.array(values, dtype=np.int64)
        return np.array([np.nan if v is None else float(v) for v in values])
    if present and all(isinstance(v, str) for v in present):
        return _objects(values)
    return block_from_rows([{"c": v} for v in values])["c"]


def _read_json_file(path: str):
    with open(path, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    names: List[str] = []
    for r in rows:
        names.extend(k for k in r if k not in names)
    return block_from_numpy({k: _json_column([r.get(k) for r in rows])
                             for k in names})


def _read_numpy_file(path: str):
    return block_from_numpy({"data": np.load(path)})


def _read_binary_file(path: str):
    with open(path, "rb") as f:
        return block_from_rows([{"path": path, "bytes": f.read()}])


_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")


def _read_image_file(path: str, size=None, mode: Optional[str] = None):
    """One image file -> a 1-row tensor block {image, path, height, width}.
    Decode happens IN THE READ TASK (parallel across the cluster); the
    tensor column feeds iter_batches directly (parity:
    image_datasource.py: decoded NHWC uint8, contiguous)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("read_images needs PIL (pillow), which is not "
                          "installed") from e
    with Image.open(path) as im:
        if mode is not None:
            im = im.convert(mode)
        elif im.mode not in ("RGB", "L"):
            im = im.convert("RGB")
        if size is not None:
            # ``size`` follows the reference's (height, width) convention;
            # PIL's resize takes (width, height).
            h, w = size
            im = im.resize((w, h))
        arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w = arr.shape[:2]
    return block_from_numpy({
        "image": arr[None],
        "path": _objects([path]),
        "height": np.array([h], np.int32),
        "width": np.array([w], np.int32),
    })


def _read_tfrecords_file(path: str):
    """One TFRecord file -> a block of decoded tf.train.Examples. Scalar
    features unbox to scalars; bytes features stay bytes (parity:
    tfrecords_datasource.py semantics, without the TF dependency —
    data/tfrecord.py implements the framing + proto codec)."""
    from ray_tpu_torch.data.tfrecord import (decode_example,
                                             read_tfrecord_frames)
    rows = []
    for frame in read_tfrecord_frames(path):
        ex = decode_example(frame)
        row = {}
        for k, v in ex.items():
            if isinstance(v, list):      # BytesList
                row[k] = v[0] if len(v) == 1 else v
            elif len(v) == 1:
                row[k] = v[0].item()
            else:
                row[k] = v.tolist()
        rows.append(row)
    return block_from_rows(rows)


_READERS = {
    "parquet": (_read_parquet_file, ".parquet"),
    "csv": (_read_csv_file, ".csv"),
    "json": (_read_json_file, ".json"),
    "numpy": (_read_numpy_file, ".npy"),
    "binary": (_read_binary_file, None),
    "tfrecords": (_read_tfrecords_file, None),
}


def _read_files(path, kind: str) -> Dataset:
    import ray_tpu_torch as rt
    reader, suffix = _READERS[kind]
    files = _expand_paths(path, suffix)
    remote = rt.remote(reader).options(num_cpus=1)
    return Dataset([remote.remote(f) for f in files])


def read_parquet(path) -> Dataset:
    _parquet()          # raise at the user's call where pyarrow is absent
    return _read_files(path, "parquet")


def read_csv(path) -> Dataset:
    return _read_files(path, "csv")


def read_json(path) -> Dataset:
    return _read_files(path, "json")


def read_numpy(path) -> Dataset:
    return _read_files(path, "numpy")


def read_binary_files(path) -> Dataset:
    return _read_files(path, "binary")


def read_images(path, *, size=None, mode: Optional[str] = None) -> Dataset:
    """One decode task per image file; rows carry a fixed-shape tensor
    column when ``size`` forces a uniform shape (feed `iter_batches`
    straight into device pipelines), else per-file blocks of native
    sizes."""
    import functools

    import ray_tpu_torch as rt
    files = [p for p in _expand_paths(path)
             if p.lower().endswith(_IMAGE_SUFFIXES)]
    if not files:
        raise FileNotFoundError(f"no image files under {path}")
    reader = functools.partial(_read_image_file, size=size, mode=mode)
    remote = rt.remote(reader).options(num_cpus=1)
    return Dataset([remote.remote(f) for f in files])


def read_tfrecords(path) -> Dataset:
    return _read_files(path, "tfrecords")


def write_tfrecords(ds: Dataset, path: str) -> None:
    """Rows -> tf.train.Example records, one file per block."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.data.tfrecord import (encode_example,
                                             write_tfrecord_frames)
    os.makedirs(path, exist_ok=True)
    for i, ref in enumerate(ds.iter_block_refs()):
        block = rt.get(ref)
        recs = [encode_example(row)
                for row in BlockAccessor(block).to_rows()]
        write_tfrecord_frames(
            os.path.join(path, f"part-{i:05d}.tfrecords"), recs)


def _plain(value):
    """A cell -> what the json module writes (ndarrays as lists)."""
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    return value


def _write_csv(block, out: str) -> None:
    names = list(block)
    if any(block[k].ndim > 1 for k in names):
        raise ValueError("CSV has no tensor columns; write parquet")
    cols = [block[k].tolist() for k in names]
    with open(out, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, quoting=csv.QUOTE_NONNUMERIC)
        w.writerow(names)
        for i in builtins.range(BlockAccessor(block).num_rows()):
            w.writerow([("true" if c[i] else "false")
                        if isinstance(c[i], bool) else c[i] for c in cols])


def _write_block(block, path: str, fmt: str, index: int) -> str:
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.{fmt}")
    if fmt == "parquet":
        from ray_tpu_torch.data.tensor_ext import block_to_arrow
        _parquet().write_table(block_to_arrow(block), out)
    elif fmt == "csv":
        _write_csv(block, out)
    elif fmt == "json":
        with open(out, "w", encoding="utf-8") as f:
            for row in BlockAccessor(block).to_rows():
                f.write(json.dumps({k: _plain(v) for k, v in row.items()})
                        + "\n")
    else:
        raise ValueError(fmt)
    return out


def write_blocks(ds: Dataset, path: str, fmt: str) -> List[str]:
    import ray_tpu_torch as rt
    if fmt == "parquet":
        _parquet()
    remote = rt.remote(_write_block).options(num_cpus=1)
    refs = [remote.remote(r, path, fmt, i)
            for i, r in enumerate(ds.materialize_refs())]
    return rt.get(refs)
