"""Tune's storage layer, ported from ``ray_tpu/tune/syncer.py``: URI
parsing, the storage backends (local directory, ``mock://``, fsspec
schemes) and ``Syncer``. The workflow storage and the spill backend do
their byte I/O through it. The tuner, its schedulers and its search are
still to port (ROADMAP.md A.6)."""

from ray_tpu_torch.tune.syncer import (StorageBackend, Syncer, backend_for,
                                       is_uri, local_cache_dir, parse_uri)

__all__ = ["parse_uri", "is_uri", "StorageBackend", "backend_for",
           "local_cache_dir", "Syncer"]
