"""Coordinated spill backend: the object store's durable second tier.

Role parity: src/ray/raylet/local_object_manager.h — the raylet-side
component that writes cold primary copies out of the shm store into
external storage and reports their URLs to the conductor, so the object
directory can hand a spill URL to any restorer.

Ported from ``ray_tpu/cluster/spill.py`` with its local-directory backend
only: the JAX module does its byte I/O through the workflow/tune
``Storage`` backends (``mock://``, fsspec ``gs://`` / ``s3://``), which are
still to port (ROADMAP.md A.5, A.6). A root that is a URI raises
``NotImplementedError``; a plain or shared directory works as in the JAX
package.

URL format: ``<root>/<oid.hex()>`` — self-describing. Any process (the
conductor deleting on ref-drop, a peer restoring after the writer died)
operates on a URL with no backend registry.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def _check_local(root: str) -> None:
    if "://" in root:
        raise NotImplementedError(
            f"spill root {root!r}: URI spill backends are still to port "
            "(ROADMAP.md A.5); use a directory")


class SpillBackend:
    """Writes sealed object bytes under a root directory, keyed by oid
    hex. One instance per node daemon."""

    def __init__(self, root: str):
        self.root = root.rstrip("/")
        _check_local(self.root)
        os.makedirs(self.root, exist_ok=True)

    def url_for(self, oid: bytes) -> str:
        return f"{self.root}/{oid.hex()}"

    def write(self, oid: bytes, data) -> str:
        """Write one object's bytes (bytes-like / memoryview). Returns
        the spill URL to report via rpc_add_spilled."""
        path = self.url_for(oid)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return path

    def read(self, oid: bytes) -> bytes:
        return read_url(self.url_for(oid))

    def exists(self, oid: bytes) -> bool:
        return os.path.exists(self.url_for(oid))

    def delete(self, oid: bytes) -> None:
        delete_url(self.url_for(oid))


def split_url(url: str) -> Tuple[str, str]:
    root, _, key = url.rpartition("/")
    return root, key


def read_url(url: str) -> bytes:
    """Restore an object's bytes from its spill URL (any process)."""
    _check_local(url)
    with open(url, "rb") as f:
        return f.read()


def local_path(url: str) -> Optional[str]:
    """Filesystem path behind a spill URL: the daemon that spilled an
    object serves fetch_chunk with a plain seek+read from it."""
    _check_local(url)
    return url


def delete_url(url: str) -> None:
    """Delete one spill copy by URL (conductor ref-drop path). Missing
    files are fine — deletes race benignly with the writing node's own
    cleanup."""
    _check_local(url)
    try:
        os.unlink(url)
    except OSError:
        pass
