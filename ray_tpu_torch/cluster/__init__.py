"""Distributed cluster runtime.

Process anatomy (role parity in parentheses, per SURVEY.md §1):
  conductor    — cluster control plane (GCS, src/ray/gcs): node/actor/PG/job
                 tables, KV, named actors, pubsub, health checks.
  node daemon  — per-node manager (raylet, src/ray/raylet): worker pool,
                 local lease scheduler, object-store supervision, spillback.
  shmstored    — C++ shared-memory object store (plasma), native/shmstore/.
  workers      — task/actor executor processes (core worker + default_worker).

Control RPCs are msgpack-framed asyncio TCP (protocol.py); bulk objects move
through shared memory locally and chunked TCP between nodes (transfer in the
node daemon).

Ported from ``ray_tpu/cluster/``: every module is the JAX package's, copied
whole, apart from what the port must do otherwise. The store daemon is built
at first use from the port's own copy of its source (``native/shmstore.cc``)
into ``build/ray_tpu_torch/shmstored-<hash of the source and flags>``; its
segments and the sessions carry the prefix ``rtpt-`` (the JAX package's are
``rtpu-``), so the two packages' clusters and sweeps never touch each
other's. The accelerator is ``"GPU"``: the node daemon gives each GPU lease
its own ``CUDA_VISIBLE_DEVICES``.
Callables go to workers by import path (``core/serialization.py``). Spilling
keeps a local-directory backend only (``spill.py``); compiled graphs
(``dag/``) raise ``NotImplementedError`` where the daemon and the worker
would reach them (ROADMAP.md A.5).
"""
