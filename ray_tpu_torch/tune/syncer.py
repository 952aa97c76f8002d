"""Experiment/checkpoint sync to remote storage: the storage half.

Role parity: python/ray/tune/syncer.py — a tree of files mirrors to a
storage URI (gs://, s3://, ...) so a driver on a different machine can read
it back. Ported from ``ray_tpu/tune/syncer.py`` (its storage half only: the
tuner that uses it is ROADMAP.md A.6). Backends:

- local paths (no scheme): plain directory trees, no syncing needed;
- ``mock://`` — in-process memory store (tests; survives nothing);
- any fsspec-resolvable scheme (gs/s3/file/...) via the fsspec package,
  imported only by the calls that need it.

Sync is WHOLE-TREE with a size skip: checkpoints are immutable once
written, so a naive rsync-style one-way mirror is both correct and cheap.

Where the port differs: ``local_cache_dir`` lives under
``tempfile.gettempdir()`` as ``rtpt-storage-cache/<hash>``, where the JAX
module uses ``/tmp/ray_tpu/storage-cache/<hash>``; and a missing fsspec
raises ``ImportError`` naming it.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, Tuple
from urllib.parse import urlparse


def parse_uri(uri: str) -> Tuple[str, str]:
    """-> (scheme, rest). Plain paths have scheme ''."""
    p = urlparse(uri)
    if len(p.scheme) <= 1:     # '' or a windows drive letter
        return "", uri
    return p.scheme, uri


def is_uri(path: str) -> bool:
    return parse_uri(path)[0] != ""


def _fsspec():
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            "a storage URI other than mock:// needs the fsspec package, "
            "which is not installed") from e
    return fsspec


class StorageBackend:
    def upload_dir(self, local: str, uri: str) -> None:
        raise NotImplementedError

    def download_dir(self, uri: str, local: str) -> None:
        raise NotImplementedError

    def exists(self, uri: str) -> bool:
        raise NotImplementedError


class _MockBackend(StorageBackend):
    """In-memory tree keyed by URI (scheme mock://) — the test double the
    reference gets from mock_storage_client."""

    store: Dict[str, Dict[str, bytes]] = {}

    def upload_dir(self, local: str, uri: str) -> None:
        tree = self.store.setdefault(uri, {})
        for root, _dirs, files in os.walk(local):
            for f in files:
                p = os.path.join(root, f)
                with open(p, "rb") as fh:
                    tree[os.path.relpath(p, local)] = fh.read()

    def download_dir(self, uri: str, local: str) -> None:
        tree = self.store.get(uri)
        if tree is None:
            raise FileNotFoundError(uri)
        for rel, blob in tree.items():
            dst = os.path.join(local, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(dst, "wb") as f:
                f.write(blob)

    def exists(self, uri: str) -> bool:
        return uri in self.store


class _FsspecBackend(StorageBackend):
    def _fs(self, uri: str):
        return _fsspec().filesystem(parse_uri(uri)[0])

    def _strip(self, uri: str) -> str:
        p = urlparse(uri)
        return (p.netloc + p.path).rstrip("/")

    def upload_dir(self, local: str, uri: str) -> None:
        fs = self._fs(uri)
        base = self._strip(uri)
        for root, _dirs, files in os.walk(local):
            for f in files:
                src = os.path.join(root, f)
                dst = base + "/" + os.path.relpath(src, local)
                try:
                    info = fs.info(dst)
                    if info.get("size") == os.path.getsize(src):
                        continue  # immutable artifacts: size match = done
                except FileNotFoundError:
                    pass
                fs.makedirs(os.path.dirname(dst), exist_ok=True)
                fs.put_file(src, dst)

    def download_dir(self, uri: str, local: str) -> None:
        fs = self._fs(uri)
        base = self._strip(uri)
        for src in fs.find(base):
            rel = os.path.relpath(src, base)
            dst = os.path.join(local, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            fs.get_file(src, dst)

    def exists(self, uri: str) -> bool:
        return self._fs(uri).exists(self._strip(uri))


class _LocalBackend(StorageBackend):
    def upload_dir(self, local: str, uri: str) -> None:
        if os.path.abspath(local) != os.path.abspath(uri):
            shutil.copytree(local, uri, dirs_exist_ok=True)

    def download_dir(self, uri: str, local: str) -> None:
        if os.path.abspath(local) != os.path.abspath(uri):
            shutil.copytree(uri, local, dirs_exist_ok=True)

    def exists(self, uri: str) -> bool:
        return os.path.exists(uri)


def backend_for(uri: str) -> StorageBackend:
    scheme = parse_uri(uri)[0]
    if scheme == "":
        return _LocalBackend()
    if scheme == "mock":
        return _MockBackend()
    return _FsspecBackend()


def local_cache_dir(uri: str) -> str:
    """Deterministic local staging dir for a storage URI (same URI on a
    fresh driver -> same staging path -> restore finds prior downloads)."""
    import hashlib
    h = hashlib.sha1(uri.encode()).hexdigest()[:16]
    d = os.path.join(tempfile.gettempdir(), "rtpt-storage-cache", h)
    os.makedirs(d, exist_ok=True)
    return d


class Syncer:
    """One experiment's up/down mirror."""

    def __init__(self, uri: str):
        self.uri = uri
        self.backend = backend_for(uri)

    def sync_up(self, local: str) -> None:
        self.backend.upload_dir(local, self.uri)

    def sync_down(self, local: str) -> None:
        self.backend.download_dir(self.uri, local)

    def exists(self) -> bool:
        return self.backend.exists(self.uri)
