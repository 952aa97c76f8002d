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
  only, so the process that loads them must be able to import their
  module (cluster workers start with the driver's ``sys.path``). A function
  or class defined in the driver's ``__main__`` pickles as (path of the
  main file, qualname): a worker imports that file under the name
  ``__rt_main__`` (the ``if __name__ == "__main__"`` guard keeps its body
  from running), as ``multiprocessing``'s spawn imports it as
  ``__mp_main__``, and the driver maps it back to its own ``__main__``. A
  lambda, a closure or a function defined inside another raises
  ``TypeError`` naming it ("define it at module level"). The in-process
  runtime holds callables by reference and never pickles them.
- The RTAR array path knows torch tensors, where the JAX module knows
  ``jax.Array``: a top-level CPU or CUDA tensor whose dtype numpy has is
  exported through ``.detach().cpu().numpy()``, sets flag bit 0 ("a
  framework array") and records its device in the header. It comes back as
  a read-only host numpy view, as a ``jax.Array`` does in the JAX package.
  A tensor whose dtype numpy lacks (bfloat16), and every tensor nested in
  another value, takes the pickle path. A CUDA tensor is copied to the host
  before it is pickled, so any reader can load it, card or not: it comes
  back as a CPU tensor of its dtype (a bf16 tensor as a bf16 CPU tensor,
  where the JAX package returns an ``ml_dtypes`` bf16 numpy array, which
  numpy alone lacks).
"""

from __future__ import annotations

import io
import mmap
import os
import pickle
import struct
import sys
import threading
import types
import weakref
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
        if isinstance(obj, (types.FunctionType, type)):
            return _reduce_by_path(obj)
        torch = sys.modules.get("torch")
        if (torch is not None and isinstance(obj, torch.Tensor)
                and obj.device.type != "cpu"):
            # Any reader must be able to load it, with or without a card.
            return (_restore_tensor, (obj.detach().cpu(),))
        return NotImplemented


def _restore_tensor(t):
    return t


# Name under which a worker imports the driver's main file (the role of
# multiprocessing's ``__mp_main__``).
_MAIN_ALIAS = "__rt_main__"


def _reduce_by_path(obj):
    """Reduce a function or class to (module, qualname), or raise the
    by-reference rule's TypeError. A module attribute that is the
    ``@remote`` wrapper of ``obj`` resolves to ``obj``."""
    module = getattr(obj, "__module__", None) or ""
    qualname = getattr(obj, "__qualname__", "") or ""
    if "<lambda>" in qualname or "<locals>" in qualname:
        raise TypeError(
            f"cannot ship {module}.{qualname} to another process: the port "
            "pickles functions and classes by import path (it has no "
            "cloudpickle), so a lambda, a closure or a function or class "
            "defined inside another cannot be sent; define it at module "
            "level")
    if module in ("__main__", _MAIN_ALIAS):
        path = getattr(sys.modules.get(module), "__file__", None)
        if not path:
            raise TypeError(
                f"cannot ship {module}.{qualname} to another process: it "
                "was defined in an interactive __main__ with no file (a "
                "python -c body or a REPL); define it at module level in a "
                "file")
        return (_main_global, (os.path.realpath(path), qualname))
    mod = sys.modules.get(module)
    if mod is None:
        return NotImplemented
    try:
        named = _getattr_path(mod, qualname)
    except AttributeError:
        named = None
    if named is obj:
        return NotImplemented   # the stdlib's own global lookup
    if _unwrap(named) is not obj:
        raise TypeError(
            f"cannot ship {module}.{qualname} to another process by "
            "import path: that name does not lead back to it; define it "
            "at module level under its own name")
    return (_import_global, (module, qualname))


def _unwrap(obj):
    """The function or class behind an ``@remote`` wrapper or a serve
    ``@deployment``. A ``Deployment`` can exist only once its module is
    loaded, so ``core`` never imports ``serve`` for this."""
    from ray_tpu_torch.core.actor import ActorClass
    from ray_tpu_torch.core.remote_function import RemoteFunction
    if isinstance(obj, RemoteFunction):
        return obj._fn
    if isinstance(obj, ActorClass):
        return obj._cls
    serve_api = sys.modules.get("ray_tpu_torch.serve.api")
    if serve_api is not None and isinstance(obj, serve_api.Deployment):
        return obj._target
    return obj


def _import_global(module: str, qualname: str):
    import importlib
    return _unwrap(_getattr_path(importlib.import_module(module), qualname))


def _getattr_path(obj, qualname: str):
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _main_global(path: str, qualname: str):
    """Inverse of ``_reduce_by_path`` for the driver's ``__main__``: the
    driver's own module where this process runs that file as its main,
    else the file imported once under ``__rt_main__``."""
    main = sys.modules.get("__main__")
    main_file = getattr(main, "__file__", None)
    if main_file and os.path.realpath(main_file) == path:
        return _unwrap(_getattr_path(main, qualname))
    mod = sys.modules.get(_MAIN_ALIAS)
    if mod is None or getattr(mod, "__file__", None) != path:
        import importlib.util
        spec = importlib.util.spec_from_file_location(_MAIN_ALIAS, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[_MAIN_ALIAS] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:  # noqa: BLE001 - unregister then re-raise
            sys.modules.pop(_MAIN_ALIAS, None)
            raise
    return _unwrap(_getattr_path(mod, qualname))


# ---------------------------------------------------------------------------
# Array fast path: top-level numpy arrays and torch tensors skip pickle — a
# fixed RTAR header plus the raw buffer as a zero-copy segment, and
# deserialize returns a read-only view over the blob's memory.
# ---------------------------------------------------------------------------

_zc_gen: Optional[int] = None
_zc_v = True

# Live read-only array views whose base is a pinned shm mapping: each
# deserialized array registers a finalizer on the mmap, so a hygiene gate
# (and the rt_array_pins_live gauge) can assert no test leaks a pin past
# its own teardown.
_pin_lock = threading.Lock()
_live_array_pins = 0


def _zero_copy_enabled() -> bool:
    """Generation-cached array_zero_copy_enabled read (serialize sits on
    the put hot path; config.get walks os.environ)."""
    global _zc_gen, _zc_v
    if _zc_gen != config.generation:
        _zc_v = bool(config.get("array_zero_copy_enabled"))
        _zc_gen = config.generation
    return _zc_v


def _untrack_pin() -> None:
    global _live_array_pins
    with _pin_lock:
        _live_array_pins -= 1


def _track_pin(base) -> None:
    global _live_array_pins
    try:
        weakref.finalize(base, _untrack_pin)
    except TypeError:
        return  # bytes-backed view: no store pin behind it
    with _pin_lock:
        _live_array_pins += 1


def live_array_pins() -> int:
    """Read-only array views still holding a shm pin (hygiene gate)."""
    with _pin_lock:
        return _live_array_pins


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
    try:
        from ray_tpu_torch.cluster import fault_plane
        fault_plane.fire("object.array.export",
                         kind="torch" if was_tensor else "numpy")
    except Exception:
        return None  # injected export failure: classic pickle path
    if was_tensor:
        device = str(value.device)
        try:
            # a dtype numpy lacks (bfloat16) is known before any copy: a
            # CUDA tensor is then copied to the host once, by the pickler
            torch.empty(0, dtype=value.dtype).numpy()
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
        pass  # already read-only (PROT_READ mapping / bytes blob)
    base = getattr(m, "obj", None)
    if isinstance(base, mmap.mmap):
        _track_pin(base)
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


def serialized_size(blob: bytes) -> int:
    return len(blob)


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
    """In-band pickle (control-plane payloads: task specs, functions),
    through ``_Pickler``'s by-path rule."""
    bio = io.BytesIO()
    _Pickler(bio, None).dump(value)
    return bio.getvalue()


def _prims_only_args(value: Any) -> bool:
    """True iff ``value`` is the submit-path ``(args_list, kwargs_dict)``
    pair and every element is an exact primitive — such a payload cannot
    contain an ObjectRef, so the in-band ref-collecting pickler is pure
    overhead for it."""
    if type(value) is not tuple or len(value) != 2:
        return False
    a, kw = value
    if type(a) is not list or type(kw) is not dict:
        return False
    for v in a:
        if type(v) not in _PRIM_TYPES:
            return False
    for k, v in kw.items():
        if type(k) is not str or type(v) not in _PRIM_TYPES:
            return False
    return True


def dumps_with_refs(value: Any) -> Tuple[bytes, List[ObjectRef]]:
    """In-band pickle that also reports every ObjectRef reachable from
    ``value`` (at any nesting depth) in ONE pass — the submit path pins
    these for the duration of the task handoff (reference_count.h:61
    in-flight argument references)."""
    if _prims_only_args(value):
        return pickle.dumps(value, protocol=5), []
    bio = io.BytesIO()
    p = _Pickler(bio, None)
    p.dump(value)
    return bio.getvalue(), p.contained_refs


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
