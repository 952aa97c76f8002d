"""Checkpoint: one dict- or directory-backed checkpoint object. Ported from
``ray_tpu/air/checkpoint.py``.

Role parity: python/ray/air/checkpoint.py: one type that can be created
from a dict or a directory, moved through the object store, and persisted
to a path. The layout is the JAX package's: a dict checkpoint is written as
``_dict_checkpoint.pkl`` (pickle protocol 5), a directory checkpoint
travels packed as a tar of its files (``__reduce__``). So a dict
checkpoint of numpy values written by either package's ``to_directory``
loads in the other.

Where the port differs from the JAX module: a torch tensor in a dict
checkpoint (at any depth of dicts, lists and tuples) is copied to the host
when the checkpoint is made. The checkpoint then holds a snapshot that the
optimizer's in-place updates of the live tensors do not reach, and it
pickles, moves and loads on a machine without a card (ROADMAP.md C,
"Tensors across processes come back on the host").
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional


def _to_host(value):
    """``value`` with every torch tensor in it a detached host copy."""
    if type(value).__module__.split(".")[0] == "torch" and \
            hasattr(value, "detach"):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


class Checkpoint:
    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 path: Optional[str] = None):
        if (data is None) == (path is None):
            raise ValueError("pass exactly one of data= or path=")
        self._data = None if data is None else _to_host(data)
        self._path = path

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=os.path.abspath(path))

    # -- accessors -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        blob_file = os.path.join(self._path, "_dict_checkpoint.pkl")
        if os.path.exists(blob_file):
            with open(blob_file, "rb") as f:
                return pickle.load(f)
        out: Dict[str, Any] = {}
        for name in os.listdir(self._path):
            with open(os.path.join(self._path, name), "rb") as f:
                out[name] = f.read()
        return out

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = tempfile.mkdtemp(prefix="rtpt-ckpt-")
        os.makedirs(path, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(path) != os.path.abspath(self._path):
                shutil.copytree(self._path, path, dirs_exist_ok=True)
            return path
        with open(os.path.join(path, "_dict_checkpoint.pkl"), "wb") as f:
            pickle.dump(self._data, f, protocol=5)
        return path

    @property
    def path(self) -> Optional[str]:
        return self._path

    def __reduce__(self):
        # dict checkpoints ship by value; directory checkpoints pack their
        # contents so the checkpoint survives crossing node boundaries (a
        # bare path would dangle on any other host)
        if self._path is not None:
            return (_unpack_dir_checkpoint, (_pack_dir(self._path),))
        return (Checkpoint, (self._data, self._path))

    def __repr__(self):
        if self._path:
            return f"Checkpoint(path={self._path!r})"
        return f"Checkpoint(dict with {len(self._data)} keys)"


def _pack_dir(path: str) -> bytes:
    """Tar a checkpoint directory into bytes for transport."""
    import io
    import tarfile
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        tar.add(path, arcname=".")
    return buf.getvalue()


_unpacked_dirs: Dict[str, str] = {}
_unpacked_lock = threading.Lock()


def _unpack_dir_checkpoint(payload: bytes) -> "Checkpoint":
    """Restore a packed directory checkpoint into a local temp dir.

    Deduped by content digest (a worker receiving the same checkpoint every
    round extracts once) and removed at interpreter exit so repeated
    deserialization cannot fill the disk with orphaned copies."""
    import atexit
    import hashlib
    import io
    import tarfile
    digest = hashlib.blake2b(payload, digest_size=16).hexdigest()
    with _unpacked_lock:
        path = _unpacked_dirs.get(digest)
        if path is not None and os.path.isdir(path):
            return Checkpoint.from_directory(path)
        path = tempfile.mkdtemp(prefix="rtpt-ckpt-")
        with tarfile.open(fileobj=io.BytesIO(payload), mode="r") as tar:
            tar.extractall(path, filter="data")
        if not _unpacked_dirs:
            atexit.register(_cleanup_unpacked)
        _unpacked_dirs[digest] = path
    return Checkpoint.from_directory(path)


def _cleanup_unpacked() -> None:
    for path in _unpacked_dirs.values():
        shutil.rmtree(path, ignore_errors=True)
