"""Rehearse the serving phases of ``chip_smoke.py`` on one card, phase 30
(serve from a replica process, its replica killed and replaced) several
times in one process.

    python3 chip_rehearse.py              # phases 3, 7, 24-26, 30 x 4, 32, 33, 36
    python3 chip_rehearse.py 3,7 2        # only phases 3 and 7
    python3 chip_rehearse.py 24,26,30 6   # phase 30 six times

The first argument lists phases by their number (``small`` is the small f32
reference that follows phase 3); the second is how often phase 30 runs.
Each phase prints what ``chip_smoke.py`` prints for it, then a line
``[rehearse] <phase>: ok|FAILED <seconds> s``; the last line lists every
phase's outcome. A failed phase is printed with its traceback, its serve
instance and runtime are shut down, and the next phase runs. Phase 30 needs
24 and 26 and phase 33 needs 32 (they hand it their results). The exit code
is 0 only when every phase run passed.
"""

from __future__ import annotations

import sys
import time
import traceback

import torch

import chip_smoke as cs

PHASES = ("3", "small", "7", "24", "25", "26", "30", "32", "33", "36")


def main(argv) -> int:
    want = argv[0].split(",") if argv else PHASES
    repeats = int(argv[1]) if len(argv) > 1 else 4
    if not torch.cuda.is_available():
        print("chip_rehearse: no CUDA device", file=sys.stderr)
        return 1
    cs._keep_bytecode()
    card, _ = cs.phase_card_and_build()
    results = []

    def run(name, fn, *args):
        if name not in want:
            return None
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # noqa: BLE001 - the next phase still runs
            traceback.print_exc()
            ok, out = False, None
            _shut_down()
        else:
            ok = True
        print(f"[rehearse] {name}: {'ok' if ok else 'FAILED'} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        results.append((name, ok))
        return out

    serve = run("3", cs.phase_serving, card, cs.flagship_cfg(), "serve", 0)
    run("small", cs.phase_small_reference)
    run("7", cs.phase_serving, card, cs.moe_cfg(), "moe-serve", 10)
    tokens_per_s = serve["tokens_per_s"] if serve else float("nan")
    http = run("24", cs.phase_http_serve, card, tokens_per_s)
    run("25", cs.phase_cluster, card, tokens_per_s)
    graph = run("26", cs.phase_compiled_graph, card)
    if http and graph:
        for _ in range(repeats):
            run("30", cs.phase_serve_cluster, card, http, graph)
    control = run("32", cs.phase_control_surface, card)
    if control:
        run("33", cs.phase_elastic_durable, card, control)
    run("36", cs.phase_examples, card)
    print(f"[rehearse] results {results}", flush=True)
    return 0 if results and all(ok for _, ok in results) else 1


def _shut_down():
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    for stop in (serve.shutdown, rt.shutdown):
        try:
            stop()
        except Exception:  # noqa: BLE001 - nothing may be running
            pass


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
