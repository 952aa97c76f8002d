"""Coordinated spill backend: the object store's durable second tier.

Role parity: src/ray/raylet/local_object_manager.h — the raylet-side
component that writes cold primary copies out of the shm store into
external storage and reports their URLs to the conductor, so the object
directory can hand a spill URL to any restorer even after the writing node
is gone. Ported from ``ray_tpu/cluster/spill.py``: the byte I/O reuses the
workflow/tune ``Storage`` backends, so one root string selects a node-local
directory (default), a shared directory, or a URI scheme (``mock://``,
fsspec ``gs://`` / ``s3://`` / ``file://``) — a shared root is what makes
spill copies survive node death.

URL format: ``<root>/<oid.hex()>`` — self-describing. Any process (the
conductor deleting on ref-drop, a peer restoring after the writer died)
operates on a URL with no backend registry: split on the last '/' and hand
the root back to ``storage_for``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from ray_tpu_torch.tune.syncer import is_uri
from ray_tpu_torch.workflow.storage import storage_for


class SpillBackend:
    """Writes sealed object bytes under a root path/URI, keyed by oid
    hex. One instance per node daemon."""

    def __init__(self, root: str):
        self.root = root.rstrip("/")
        if not is_uri(self.root):
            os.makedirs(self.root, exist_ok=True)
        self._storage = storage_for(self.root)

    def url_for(self, oid: bytes) -> str:
        return f"{self.root}/{oid.hex()}"

    def write(self, oid: bytes, data) -> str:
        """Write one object's bytes (bytes-like / memoryview). Returns
        the spill URL to report via rpc_add_spilled."""
        self._storage.put_bytes(oid.hex(), bytes(data))
        return self.url_for(oid)

    def read(self, oid: bytes) -> bytes:
        return self._storage.get_bytes(oid.hex())

    def exists(self, oid: bytes) -> bool:
        return self._storage.exists(oid.hex())

    def delete(self, oid: bytes) -> None:
        delete_url(self.url_for(oid))


def split_url(url: str) -> Tuple[str, str]:
    root, _, key = url.rpartition("/")
    return root, key


def read_url(url: str) -> bytes:
    """Restore an object's bytes from its spill URL (any process)."""
    root, key = split_url(url)
    return storage_for(root).get_bytes(key)


def local_path(url: str) -> Optional[str]:
    """Filesystem path behind a plain-directory spill URL (None for URI
    schemes). Lets the daemon that spilled an object serve fetch_chunk
    with a plain seek+read from the spill file — no shm re-inflation."""
    root, key = split_url(url)
    if is_uri(root):
        return None
    return os.path.join(root, key)


def delete_url(url: str) -> None:
    """Delete one spill copy by URL (conductor ref-drop path). Missing
    files/keys are fine — deletes race benignly with the writing node's
    own cleanup."""
    root, key = split_url(url)
    if is_uri(root):
        try:
            storage_for(root).delete_prefix(key)
        except Exception:
            pass
        return
    # FileStorage.delete_prefix rmtree's directories and ignores plain
    # files; spill entries ARE plain files, so unlink directly.
    try:
        os.unlink(os.path.join(root, key))
    except OSError:
        pass
