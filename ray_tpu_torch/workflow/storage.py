"""Pluggable workflow storage. Ported from ``ray_tpu/workflow/storage.py``.

Role parity: python/ray/workflow storage layer (workflow_storage.py) —
step checkpoints, workflow metadata, and events live behind a small
byte-blob interface so the backend can be a local directory (default),
an fsspec URI (gs://, s3://, file://), or the in-memory mock:// store
(tests). Selected via ``workflow.set_storage(url)`` or the
``RTPT_WORKFLOW_STORAGE`` environment variable.

Where the port differs: the default root is ``rtpt_workflows`` under
``tempfile.gettempdir()`` and the variable ``RTPT_WORKFLOW_STORAGE``, where
the JAX module has ``rtpu_workflows`` and ``RTPU_WORKFLOW_STORAGE``, so the
two packages' workflows never share a directory; and ``FileStorage`` stages
a write in a file named after the writing process, so two processes
writing one key never share a staging file.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Optional
from urllib.parse import urlparse


class Storage:
    def put_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get_bytes(self, key: str) -> bytes:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> List[str]:
        """Immediate child names under prefix (directory-style)."""
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError


class FileStorage(Storage):
    def __init__(self, root: str):
        self.root = root

    def _p(self, key: str) -> str:
        return os.path.join(self.root, key)

    def put_bytes(self, key: str, data: bytes) -> None:
        path = self._p(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic commit

    def get_bytes(self, key: str) -> bytes:
        with open(self._p(key), "rb") as f:
            return f.read()

    def exists(self, key: str) -> bool:
        return os.path.exists(self._p(key))

    def list_prefix(self, prefix: str) -> List[str]:
        d = self._p(prefix)
        if not os.path.isdir(d):
            return []
        return sorted(os.listdir(d))

    def delete_prefix(self, prefix: str) -> None:
        shutil.rmtree(self._p(prefix), ignore_errors=True)


class UriStorage(Storage):
    """Any tune-syncer backend scheme (mock://, fsspec gs/s3/file)."""

    def __init__(self, uri_root: str):
        from ray_tpu_torch.tune.syncer import backend_for
        self.uri_root = uri_root.rstrip("/")
        self._backend = backend_for(uri_root)
        # Byte-level ops ride a per-key staging file through the backend's
        # dir-level API (it is the stable surface all three schemes share).
        self._stage = tempfile.mkdtemp(prefix="rtpt-wfstage-")

    def _key_uri(self, key: str) -> str:
        return f"{self.uri_root}/{key}".rstrip("/")

    def _is_mock(self) -> bool:
        from ray_tpu_torch.tune.syncer import _MockBackend
        return isinstance(self._backend, _MockBackend)

    def _fs_path(self, key: str):
        from ray_tpu_torch.tune.syncer import _fsspec
        p = urlparse(self._key_uri(key))
        return _fsspec().filesystem(p.scheme), (p.netloc + p.path).rstrip("/")

    def put_bytes(self, key: str, data: bytes) -> None:
        d = os.path.join(self._stage, "put")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        with open(os.path.join(d, "blob"), "wb") as f:
            f.write(data)
        self._backend.upload_dir(d, self._key_uri(key))

    def get_bytes(self, key: str) -> bytes:
        d = os.path.join(self._stage, "get")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        self._backend.download_dir(self._key_uri(key), d)
        with open(os.path.join(d, "blob"), "rb") as f:
            return f.read()

    def exists(self, key: str) -> bool:
        return self._backend.exists(self._key_uri(key))

    def list_prefix(self, prefix: str) -> List[str]:
        if self._is_mock():
            # mock backend: keys are whole-dir uploads keyed by URI
            from ray_tpu_torch.tune.syncer import _MockBackend
            base = self._key_uri(prefix)
            return sorted({uri[len(base) + 1:].split("/")[0]
                           for uri in _MockBackend.store
                           if uri.startswith(base + "/")})
        fs, base = self._fs_path(prefix)
        try:
            return sorted({e.rstrip("/").rsplit("/", 1)[-1]
                           for e in fs.ls(base, detail=False)})
        except FileNotFoundError:
            return []

    def delete_prefix(self, prefix: str) -> None:
        if self._is_mock():
            from ray_tpu_torch.tune.syncer import _MockBackend
            base = self._key_uri(prefix)
            for uri in list(_MockBackend.store):
                if uri == base or uri.startswith(base + "/"):
                    del _MockBackend.store[uri]
            return
        fs, path = self._fs_path(prefix)
        try:
            fs.rm(path, recursive=True)
        except FileNotFoundError:
            pass


_DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "rtpt_workflows")
ENV_VAR = "RTPT_WORKFLOW_STORAGE"
_storage: Optional[Storage] = None
_storage_url: Optional[str] = None


def storage_for(url: str) -> Storage:
    """Backend instance for a URL without touching the process global —
    remote steps (event waiters) receive the driver's URL explicitly."""
    from ray_tpu_torch.tune.syncer import is_uri
    return UriStorage(url) if is_uri(url) else FileStorage(url)


def set_storage(url: str) -> None:
    """Select the workflow storage backend (parity: workflow.init's
    storage URL)."""
    global _storage, _storage_url
    _storage = storage_for(url)
    _storage_url = url


def get_storage_url() -> str:
    if _storage_url is None:
        return os.environ.get(ENV_VAR, _DEFAULT_ROOT)
    return _storage_url


def get_storage() -> Storage:
    global _storage
    if _storage is None:
        set_storage(get_storage_url())
    return _storage


def reset_storage() -> None:
    """Back to the env/default selection (test teardown)."""
    global _storage, _storage_url
    _storage = None
    _storage_url = None
