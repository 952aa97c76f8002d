"""Arrow conversion of numpy blocks, with the JAX package's tensor extension
type. Ported from ``ray_tpu/data/tensor_ext.py``.

Role parity: python/ray/air/util/tensor_extensions/arrow.py
(ArrowTensorType/ArrowTensorArray). The port's blocks are numpy (a tensor
column is an ``(N, *shape)`` ndarray), so Arrow is needed only at the edges:
``read_parquet``/``write_parquet``, ``from_arrow`` and
``batch_format="pyarrow"``. There a tensor column becomes a fixed-shape
tensor column of the JAX package's extension type: storage
``FixedSizeList(value)``, extension name ``"ray_tpu.tensor"`` and metadata
``{"shape": [...]}``. So a parquet file with tensor columns that either
package writes is read by the other.

pyarrow is imported inside the functions, never at module level: the card's
machine may lack it, and the rest of ``data/`` does not need it.
``ArrowTensorType`` and ``ArrowTensorArray`` are made on first access. A
process that already registered the JAX package's type under the same
name keeps that registration; reading accepts either class, and a column
whose extension type is not registered at all (its storage with the
extension's field metadata).
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

EXTENSION_NAME = "ray_tpu.tensor"
_classes: Dict[str, type] = {}


def _pyarrow():
    try:
        import pyarrow as pa
    except ImportError as e:
        raise ImportError("Arrow and parquet data need pyarrow, which is "
                          "not installed") from e
    return pa


def _make_classes() -> Dict[str, type]:
    if _classes:
        return _classes
    pa = _pyarrow()

    class ArrowTensorType(pa.ExtensionType):
        """Fixed-shape tensor column type: storage = FixedSizeList(value)."""

        def __init__(self, shape, value_type):
            self._shape = tuple(int(s) for s in shape)
            size = 1
            for s in self._shape:
                size *= s
            super().__init__(pa.list_(value_type, size), EXTENSION_NAME)

        @property
        def shape(self):
            return self._shape

        @property
        def value_type(self):
            return self.storage_type.value_type

        def __arrow_ext_serialize__(self) -> bytes:
            return json.dumps({"shape": list(self._shape)}).encode()

        @classmethod
        def __arrow_ext_deserialize__(cls, storage_type, serialized):
            shape = json.loads(serialized.decode())["shape"]
            return cls(shape, storage_type.value_type)

        def __arrow_ext_class__(self):
            return _classes["ArrowTensorArray"]

        def __reduce__(self):
            return (_deserialize_type,
                    (self.storage_type, self.__arrow_ext_serialize__()))

    class ArrowTensorArray(pa.ExtensionArray):
        """Array of fixed-shape tensors."""

        @staticmethod
        def from_numpy(arr: np.ndarray) -> "ArrowTensorArray":
            arr = np.ascontiguousarray(arr)
            if arr.ndim < 2:
                raise ValueError("tensor columns need ndim >= 2 (N, *shape)")
            typ = ArrowTensorType(arr.shape[1:],
                                  pa.from_numpy_dtype(arr.dtype))
            flat = arr.reshape(len(arr), -1)
            storage = pa.FixedSizeListArray.from_arrays(
                pa.array(flat.ravel()), flat.shape[1])
            return pa.ExtensionArray.from_storage(typ, storage)

        def to_numpy(self, zero_copy_only: bool = True) -> np.ndarray:
            return _tensor_chunk_to_numpy(self, self.type.shape)

    for cls in (ArrowTensorType, ArrowTensorArray):
        cls.__module__, cls.__qualname__ = __name__, cls.__name__
    _classes.update(ArrowTensorType=ArrowTensorType,
                    ArrowTensorArray=ArrowTensorArray)
    try:
        pa.register_extension_type(ArrowTensorType((1,), pa.float32()))
    except pa.ArrowKeyError:
        pass  # registered already, by the JAX package in this process
    return _classes


def _deserialize_type(storage_type, serialized):
    return _make_classes()["ArrowTensorType"].__arrow_ext_deserialize__(
        storage_type, serialized)


def __getattr__(name):
    if name in ("ArrowTensorType", "ArrowTensorArray"):
        return _make_classes()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def tensor_column(arr: np.ndarray):
    return _make_classes()["ArrowTensorArray"].from_numpy(arr)


def _tensor_shape(field):
    """The cell shape of a tensor column, or None: an extension type of
    this name (the port's class or the JAX package's), or its storage with
    the extension's field metadata where the type is not registered."""
    t = field.type
    ext = getattr(t, "extension_name", None)
    if ext == EXTENSION_NAME:
        return tuple(json.loads(t.__arrow_ext_serialize__())["shape"])
    meta = field.metadata or {}
    if meta.get(b"ARROW:extension:name") == EXTENSION_NAME.encode():
        return tuple(json.loads(meta[b"ARROW:extension:metadata"])["shape"])
    return None


def _tensor_chunk_to_numpy(chunk, shape) -> np.ndarray:
    storage = getattr(chunk, "storage", chunk)
    flat = storage.flatten().to_numpy(zero_copy_only=False)
    return flat.reshape((len(chunk), *shape))


def block_to_arrow(block):
    """numpy block -> ``pyarrow.Table`` (tensor columns as extension)."""
    pa = _pyarrow()
    cols = {}
    for k, v in block.items():
        if v.ndim > 1:
            cols[k] = tensor_column(v)
        elif v.dtype == object:
            cols[k] = pa.array(v.tolist())
        else:
            cols[k] = pa.array(v)
    return pa.table(cols)


def block_from_arrow(table) -> Dict[str, np.ndarray]:
    """``pyarrow.Table`` -> numpy block."""
    from ray_tpu_torch.data.block import block_from_numpy, _column
    out = {}
    for field, col in zip(table.schema, table.columns):
        shape = _tensor_shape(field)
        if shape is not None:
            parts = [_tensor_chunk_to_numpy(c, shape) for c in col.chunks]
            out[field.name] = (np.concatenate(parts) if parts else
                               np.zeros((0, *shape)))
            continue
        arr = col.to_numpy() if col.num_chunks else np.zeros(0)
        if arr.dtype == object:
            arr = _column(list(arr))
        out[field.name] = arr
    return block_from_numpy(out)
