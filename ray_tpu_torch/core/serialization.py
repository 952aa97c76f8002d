"""Object serialization: pickle + out-of-band zero-copy buffers. Ported from
``ray_tpu/core/serialization.py``.

Role parity: python/ray/_private/serialization.py — values are pickled with
protocol 5; large contiguous buffers (numpy arrays, bytes) are extracted
out-of-band so readers can map them zero-copy. ObjectRefs contained in a
value are collected during serialization so a runtime can track borrowing
and task dependencies (reference_count.h:61).

Wire layout of a serialized object (the JAX package's, byte for byte):

    [8B magic+version][8B pickle_len][4B nbuf]
    [8B len + pad-to-64 for each buffer] ... header, then:
    [pickle bytes][pad][buffer 0][pad][buffer 1] ...

Buffers are 64-byte aligned relative to the start of the blob so that a
reader holding the blob in an aligned mapping can reconstruct numpy arrays
as views without copying.

Where the port differs from the JAX module:

- The pickler is the stdlib ``pickle.Pickler`` (protocol 5, the same
  ``persistent_id`` and ``reducer_override`` hooks), not cloudpickle, which
  the port does not depend on. Functions and classes pickle by import path
  only: a lambda or a function defined inside another does not pickle. The
  in-process runtime holds callables by reference and never pickles them;
  shipping code to other processes waits for the cluster runtime.
- The RTAR array path knows torch tensors, where the JAX module knows
  ``jax.Array``: a top-level CPU or CUDA tensor whose dtype numpy has is
  exported through ``.detach().cpu().numpy()``, sets flag bit 0 ("a
  framework array") and records its device in the header. It comes back as
  a read-only host numpy view, as a ``jax.Array`` does in the JAX package.
  A tensor whose dtype numpy lacks (bfloat16) takes the classic pickle path
  and comes back as a tensor on its device; so do tensors nested in other
  values (torch pickles them itself).
- No shared-memory pin tracking and no fault-injection hooks: both belong
  to the JAX package's cluster runtime.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
from typing import Any, List, Optional, Tuple

from ray_tpu_torch import config
from ray_tpu_torch.core.refs import ObjectRef

_MAGIC = b"RTOB\x00\x00\x00\x01"
# Array fast-path wire format: a tiny fixed header instead of a pickle
# program. Layout after the magic:
#
#     [1B flags][1B order][2B dtype_len][2B device_len][2B pad]
#     [4B ndim][8B nbytes][ndim x 8B shape][dtype str][device str]
#     [pad-to-64][raw buffer]
#
# flags bit 0: the value was a framework array (here a torch tensor; the
# ``device`` string records its placement). The buffer is the array's bytes
# in MEMORY order; ``order`` ('C'/'F') says how to fold them back.
_ARRAY_MAGIC = b"RTAR\x00\x00\x00\x01"
_ARRAY_HDR = struct.Struct("<BBHHHIQ")
_ARRAY_FLAG_FRAMEWORK = 1
_ALIGN = 64


def _pad(n: int) -> int:
    return (-n) % _ALIGN


class _Pickler(pickle.Pickler):
    def __init__(self, file, buffer_callback):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        self.contained_refs: List[ObjectRef] = []

    def persistent_id(self, obj):
        return None

    def reducer_override(self, obj):
        if isinstance(obj, ObjectRef):
            self.contained_refs.append(obj)
        return NotImplemented


# ---------------------------------------------------------------------------
# Array fast path: top-level numpy arrays and torch tensors skip pickle — a
# fixed RTAR header plus the raw buffer as a zero-copy segment, and
# deserialize returns a read-only view over the blob's memory.
# ---------------------------------------------------------------------------

_zc_gen: Optional[int] = None
_zc_v = True


def _zero_copy_enabled() -> bool:
    """Generation-cached array_zero_copy_enabled read (serialize sits on
    the put hot path; config.get walks os.environ)."""
    global _zc_gen, _zc_v
    if _zc_gen != config.generation:
        _zc_v = bool(config.get("array_zero_copy_enabled"))
        _zc_gen = config.generation
    return _zc_v


def is_array_blob(buf) -> bool:
    """True when a serialized blob (or its first segment) is an RTAR
    array-header object."""
    m = memoryview(buf)
    return m.nbytes >= 8 and bytes(m[:8]) == _ARRAY_MAGIC


def array_header(buf) -> Optional[dict]:
    """Parse an RTAR header without touching the payload."""
    m = memoryview(buf)
    if m.nbytes < 8 + _ARRAY_HDR.size or bytes(m[:8]) != _ARRAY_MAGIC:
        return None
    flags, order, dtype_len, device_len, _r, ndim, nbytes = \
        _ARRAY_HDR.unpack_from(m, 8)
    off = 8 + _ARRAY_HDR.size
    shape = struct.unpack_from(f"<{ndim}q", m, off)
    off += 8 * ndim
    dtype = bytes(m[off:off + dtype_len]).decode()
    off += dtype_len
    device = bytes(m[off:off + device_len]).decode()
    return {"nbytes": nbytes, "shape": tuple(shape), "dtype": dtype,
            "order": chr(order), "device": device,
            "was_tensor": bool(flags & _ARRAY_FLAG_FRAMEWORK)}


def _export_array(value):
    """value -> (ndarray, was_tensor, device) or None when not an exact
    top-level array, or a tensor numpy cannot hold."""
    np = sys.modules.get("numpy")
    if np is None:
        return None
    was_tensor = False
    device = ""
    if type(value) is not np.ndarray:
        # never import torch here: a value can only BE a tensor if torch is
        # already in sys.modules
        torch = sys.modules.get("torch")
        if torch is None or not isinstance(value, torch.Tensor):
            return None
        was_tensor = True
        device = str(value.device)
        try:
            value = value.detach().cpu().resolve_conj().resolve_neg().numpy()
        except (TypeError, RuntimeError, NotImplementedError):
            return None  # no numpy dtype (bfloat16), sparse, meta, ...
        if not (value.flags.c_contiguous or value.flags.f_contiguous):
            value = np.ascontiguousarray(value)
    d = value.dtype
    if d.hasobject or d.fields is not None:
        return None
    if not (value.flags.c_contiguous or value.flags.f_contiguous):
        return None
    return value, was_tensor, device


def _array_segments(value) -> Optional[Tuple[int, List]]:
    """RTAR (total, segments) for a top-level array value, or None to
    take the classic pickle path."""
    if not _zero_copy_enabled():
        return None
    exported = _export_array(value)
    if exported is None:
        return None
    arr, was_tensor, device = exported
    order = b"C" if arr.flags.c_contiguous else b"F"
    # memoryview.cast requires C-contiguity; an F-ordered array's
    # transpose is the same memory seen C-contiguously.
    base = arr if arr.flags.c_contiguous else arr.T
    try:
        if arr.ndim == 0 or arr.size == 0:
            # cast("B") rejects 0-d/empty views; the "copy" is one itemsize.
            buf = memoryview(arr.tobytes())
        else:
            buf = memoryview(base)
            if buf.format != "B" or buf.ndim != 1:
                buf = buf.cast("B")
    except (ValueError, TypeError):
        return None  # datetime64 etc. refuse the buffer protocol
    dtype_b = arr.dtype.str.encode()
    device_b = device.encode()
    flags = _ARRAY_FLAG_FRAMEWORK if was_tensor else 0
    header = bytearray()
    header += _ARRAY_MAGIC
    header += _ARRAY_HDR.pack(flags, order[0], len(dtype_b), len(device_b),
                              0, arr.ndim, arr.nbytes)
    header += struct.pack(f"<{arr.ndim}q", *arr.shape)
    header += dtype_b + device_b
    header += b"\x00" * _pad(len(header))
    segments: List = [bytes(header), buf]
    total = len(segments[0]) + buf.nbytes
    tail = _pad(total)
    if tail:
        segments.append(b"\x00" * tail)
        total += tail
    return total, segments


def _deserialize_array(m: memoryview):
    """RTAR blob -> read-only ndarray view over the blob's memory."""
    import numpy as np
    hdr = array_header(m)
    if hdr is None:
        raise ValueError("bad array blob header")
    ndim = len(hdr["shape"])
    off = 8 + _ARRAY_HDR.size + 8 * ndim + len(hdr["dtype"]) \
        + len(hdr["device"].encode())
    body = off + _pad(off)
    nbytes = hdr["nbytes"]
    arr = np.frombuffer(m[body:body + nbytes], dtype=np.dtype(hdr["dtype"]))
    arr = arr.reshape(hdr["shape"], order=hdr["order"])
    try:
        arr.flags.writeable = False
    except ValueError:
        pass  # already read-only (bytes blob)
    return arr


# Exact-type primitives cannot contain ObjectRefs or out-of-band buffers,
# so their serialization skips the pickler construction entirely.
_PRIM_TYPES = frozenset((type(None), bool, int, float, str, bytes))


def serialize_segments(value: Any) -> Tuple[int, List, List[ObjectRef]]:
    """Serialize ``value`` into (total_len, segments, contained refs).

    Segments are bytes/memoryviews whose concatenation is the wire blob;
    large buffers stay as views so a store put can copy them once.
    """
    if type(value) in _PRIM_TYPES:
        pickled = pickle.dumps(value, protocol=5)
        seg0 = _MAGIC + struct.pack("<QI", len(pickled), 0) + pickled
        total = len(seg0)
        pad = _pad(total)
        if pad:
            return total + pad, [seg0, b"\x00" * pad], []
        return total, [seg0], []

    fast = _array_segments(value)
    if fast is not None:
        total, segments = fast
        return total, segments, []

    buffers: List[pickle.PickleBuffer] = []
    bio = io.BytesIO()
    p = _Pickler(bio, buffers.append)
    p.dump(value)
    pickled = bio.getvalue()

    raw: List[memoryview] = []
    for b in buffers:
        m = b.raw()
        if not m.contiguous:
            m = memoryview(bytes(m))
        if m.format != "B" or m.ndim != 1:
            m = m.cast("B")
        raw.append(m)

    header = bytearray()
    header += _MAGIC
    header += struct.pack("<QI", len(pickled), len(raw))
    for m in raw:
        header += struct.pack("<Q", m.nbytes)

    segments: List = [bytes(header) + pickled]
    total = len(segments[0])
    pad = _pad(total)
    if pad:
        segments.append(b"\x00" * pad)
        total += pad
    for m in raw:
        segments.append(m)
        total += m.nbytes
        pad = _pad(total)
        if pad:
            segments.append(b"\x00" * pad)
            total += pad
    return total, segments, p.contained_refs


def serialize(value: Any) -> Tuple[bytes, List[ObjectRef]]:
    """Serialize ``value``; returns (blob, contained ObjectRefs)."""
    total, segments, refs = serialize_segments(value)
    return b"".join(segments), refs


def deserialize(blob) -> Any:
    """Deserialize from a bytes-like (bytes or a memoryview). Buffer-backed
    arrays are reconstructed as zero-copy views over that memory."""
    m = memoryview(blob)
    if bytes(m[:8]) == _ARRAY_MAGIC:
        return _deserialize_array(m)
    if bytes(m[:8]) != _MAGIC:
        raise ValueError("bad object blob magic")
    pickle_len, nbuf = struct.unpack_from("<QI", m, 8)
    off = 20
    buf_lens = []
    for i in range(nbuf):
        (blen,) = struct.unpack_from("<Q", m, off)
        buf_lens.append(blen)
        off += 8
    body = off
    pickled = m[body:body + pickle_len]
    cur = body + pickle_len
    cur += _pad(cur)
    bufs = []
    for blen in buf_lens:
        bufs.append(m[cur:cur + blen])
        cur += blen
        cur += _pad(cur)
    return pickle.loads(pickled, buffers=bufs)


def dumps(value: Any) -> bytes:
    """Plain pickle (control-plane payloads)."""
    return pickle.dumps(value, protocol=5)


def loads(blob: bytes) -> Any:
    return pickle.loads(blob)


def collect_refs(value: Any) -> List[ObjectRef]:
    """Find ObjectRefs inside a value without a full re-serialize when cheap.

    Falls back to a serializing walk for arbitrary nesting.
    """
    if isinstance(value, ObjectRef):
        return [value]
    if isinstance(value, (list, tuple, set)):
        out: List[ObjectRef] = []
        for v in value:
            out.extend(collect_refs(v))
        return out
    if isinstance(value, dict):
        out = []
        for k, v in value.items():
            out.extend(collect_refs(k))
            out.extend(collect_refs(v))
        return out
    if isinstance(value, (int, float, str, bytes, bool, type(None))):
        return []
    _, refs = serialize(value)
    return refs
