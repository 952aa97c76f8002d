#!/usr/bin/env python3
"""Where a fresh process's first seconds go before it trains on one NVIDIA
Hopper card, with and without kept bytecode.

    python3 chip_import_probe.py

A child process (this script with ``--child``) times, in order: ``import
torch``; ``import chip_smoke``; ``torch.cuda.init()``; the CUDA context
(a first allocation); ``make_lm_train_step`` for the flagship
(``chip_smoke.flagship_cfg(remat=True)``); its ``init_fn`` from a seeded
card generator, whose ``torch.optim.AdamW`` imports torch._dynamo on its
first use; the batch on the card; and three train steps at batch 4 x 2048
(``chip_smoke._tune_tokens``, phase 35's trial). What a GPU worker of the
port's cluster pays before its first step is the same.

The parent builds the kernels, then runs children:

- as the environment stands (when it says ``PYTHONDONTWRITEBYTECODE`` and
  the installed packages ship no bytecode, each child compiles torch's
  sources again): one alone, then two at once;
- with bytecode kept under a fresh ``build/probe_pycache``
  (``PYTHONPYCACHEPREFIX``, writing on), as ``chip_smoke.py`` keeps it:
  one alone that writes it, one alone that reads it, then two at once.

Prints the card's name and power limit, one line per child, and a last
JSON line with every time. Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def child() -> None:
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    import torch
    mark("import torch")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    mark("import chip_smoke")
    torch.cuda.init()
    mark("cuda.init")
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    mark("context")
    from ray_tpu_torch.train import make_lm_train_step
    cfg = cs.flagship_cfg(remat=True)
    init_fn, step_fn, place = make_lm_train_step(cfg, learning_rate=1e-4)
    mark("make step")
    state = init_fn(torch.Generator(device="cuda").manual_seed(cs.TUNE_SEED))
    torch.cuda.synchronize()
    mark("init_fn (AdamW)")
    data = place({"tokens": cs._tune_tokens(cfg)})
    torch.cuda.synchronize()
    mark("batch")
    for i in range(3):
        state, metrics = step_fn(state, data)
        metrics["loss"].item()
        mark(f"step {i}")
    print(json.dumps({"pid": os.getpid(), "seconds": {
        name: round(t - prev, 3)
        for (name, t), (_, prev) in zip(marks[1:], marks[:-1])}}),
        flush=True)


def run_children(n: int, env: dict) -> list:
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--child"], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(n)]
    out = []
    for p in procs:
        stdout, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise SystemExit(f"a child exited {p.returncode}")
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_import_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sys.path.insert(0, ROOT)
    from ray_tpu_torch.ops import _build
    _build.build_all()
    base = dict(os.environ)
    cache = os.path.join(ROOT, "build", "probe_pycache")
    shutil.rmtree(cache, ignore_errors=True)
    kept = {k: v for k, v in base.items() if k != "PYTHONDONTWRITEBYTECODE"}
    kept["PYTHONPYCACHEPREFIX"] = cache
    print(f"environment: PYTHONDONTWRITEBYTECODE="
          f"{base.get('PYTHONDONTWRITEBYTECODE')!r}, "
          f"sys.dont_write_bytecode={sys.dont_write_bytecode}", flush=True)
    runs = {}
    for label, n, env in (("as is, alone", 1, base),
                          ("as is, two at once", 2, base),
                          ("kept, alone, writing", 1, kept),
                          ("kept, alone, reading", 1, kept),
                          ("kept, two at once", 2, kept)):
        t0 = time.perf_counter()
        runs[label] = run_children(n, env)
        wall = time.perf_counter() - t0
        for r in runs[label]:
            print(f"[{label}] wall {wall:.2f} s; " + " | ".join(
                f"{k} {v:.2f}" for k, v in r["seconds"].items()), flush=True)
    shutil.rmtree(cache, ignore_errors=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        child()
    else:
        sys.exit(main())
