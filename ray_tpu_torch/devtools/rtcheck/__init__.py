"""rtcheck: distributed-correctness static analysis for the ray_tpu_torch
tree. Ported from ``ray_tpu/devtools/rtcheck``: the same seven checkers,
messages and pragmas.

Role parity: the reference enforces its invariants with a C++ toolchain —
the single ``RAY_CONFIG`` macro registry (src/ray/common/ray_config_def.h),
clang-tidy checks, and ``GUARDED_BY``/TSAN lock-annotation discipline. Our
equivalents (config knobs, ``fault_plane.fire()`` sites, ``rt_*`` metric
names, flight-recorder event kinds, "does no RPC under self._lock"
comments) were convention-only; rtcheck machine-checks them.

Checkers (each one AST-based, cross-file where the invariant is global):

- ``config-drift``    every ``config.get("x")`` / ``set_override("x")``
                      literal (``config`` imported from
                      ``ray_tpu_torch``) must be ``config.define``d;
                      every defined flag must be read somewhere
                      (dead-knob detection);
                      ``define`` with an empty ``doc`` is a finding.
- ``fault-sites``     every ``fire("…")`` literal must be registered in
                      ``fault_plane.SITES``; every registered site must
                      be fired somewhere.
- ``name-drift``      ``rt_*`` metric-name literals outside
                      ``util/metrics.py`` must be minted in
                      ``metrics.METRICS``; ``events.emit`` kind literals
                      must be minted in ``events.EVENT_KINDS``; both
                      registries are checked for dead entries.
- ``lock-blocking``   inside ``with self._lock:`` / ``with self._cv:``
                      bodies (and module-level ``_lock``/``_cv``), calls
                      to known-blocking ops (``time.sleep``, RPC
                      ``call*``, socket send/recv, ``subprocess``,
                      ``.result()``, ``open``) are findings unless the
                      statement carries ``# rtcheck: allow-blocking(why)``.
- ``except-hygiene``  bare ``except:`` / ``except BaseException`` without
                      an annotation, and ``os._exit`` outside the
                      process-termination allowlist.
- ``thread-hygiene``  ``threading.Thread(...)`` must pass ``name=`` and
                      ``daemon=`` explicitly.
- ``doc-drift``       PARITY.md's fault-site table must list every
                      ``SITES`` entry (runs only when PARITY.md exists).

Run: ``python -m ray_tpu_torch.devtools.rtcheck [--json] [paths...]`` —
exits nonzero on findings. A tier-1 test runs the suite over
``ray_tpu_torch/`` and asserts zero findings, making every checker
self-enforcing. ``doc-drift`` reads the ``PARITY.md`` it finds walking up
from the scanned paths (the repo root's).

Suppressions are explicit and carry a reason::

    sock.sendall(buf)   # rtcheck: allow-blocking(one serialized socket)

``# noqa: BLE001`` (the pre-existing broad-except convention) is honored
by ``except-hygiene``.
"""

from ray_tpu_torch.devtools.rtcheck.core import (  # noqa: F401
    Finding, run_tree)
