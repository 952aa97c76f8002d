#!/usr/bin/env python3
"""Where the serve front's time goes on one NVIDIA Hopper card.

    python3 chip_serve_probe.py

The flagship (``chip_smoke.flagship_cfg()``, bf16, seeded weights) runs
``generate`` on 8 prompts of 128 tokens for 64 greedy tokens:

- directly, in the main thread and in a fresh thread;
- in the main thread while another thread polls ``rt.wait`` on 8
  unresolved refs, as the JAX serve handle's drainer thread does
  (``ray_tpu/serve/api.py:374``);
- over HTTP through ``ray_tpu_torch.serve`` (one replica, ``@serve.batch``
  of 8, 8 clients posting at once), with the handle counting completions
  by the runtime's callback (A, the port's handle) and by a polling
  drainer thread in the JAX handle's manner (B), in turns A B B A.

Each setting runs 3 times after a warm-up; HTTP rounds also report the
``generate`` time inside the replica. Prints the card's name and power
limit, one line per setting, and a last JSON line with every time.
Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

NEW_TOKENS = 64
REPEATS = 3


def polling_submit(handle, replica, call):
    """``DeploymentHandle._submit`` with the JAX handle's drainer: one
    thread a handle polls ``rt.wait`` over the outstanding refs."""
    import ray_tpu_torch as rt
    key = replica._rt_actor_id
    with handle._lock:
        handle._inflight[key] = handle._inflight.get(key, 0) + 1
    ref = replica.handle_request.remote(handle.method, call)
    with handle._lock:
        if getattr(handle, "_drainer", None) is None:
            handle._outstanding = []

            def drain():
                while not handle._closed:
                    with handle._lock:
                        pending = list(handle._outstanding)
                    if not pending:
                        time.sleep(0.02)
                        continue
                    try:
                        done, _ = rt.wait([r for r, _ in pending],
                                          num_returns=1, timeout=1.0)
                    except Exception:
                        return   # the runtime is gone
                    with handle._lock:
                        still = []
                        for r, k in handle._outstanding:
                            if r in done:
                                handle._inflight[k] = max(
                                    0, handle._inflight.get(k, 1) - 1)
                            else:
                                still.append((r, k))
                        handle._outstanding = still

            handle._drainer = threading.Thread(target=drain, daemon=True)
            handle._drainer.start()
        handle._outstanding.append((ref, key))
    return ref, key


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_serve_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.ids import ObjectID
    from ray_tpu_torch.core.refs import ObjectRef
    from ray_tpu_torch.models import generate, transformer_init
    from ray_tpu_torch.serve import api as serve_api
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from ray_tpu_torch.ops import _build
    _build.build_all()
    cfg = cs.flagship_cfg()
    params = transformer_init(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 128))

    def direct():
        t0 = time.perf_counter()
        generate(params, torch.from_numpy(prompts), cfg,
                 max_new_tokens=NEW_TOKENS).tolist()
        return time.perf_counter() - t0

    def fresh_thread():
        out = []
        t = threading.Thread(target=lambda: out.append(direct()))
        t.start()
        t.join()
        return out[0]

    times = {}
    direct()
    times["direct_main"] = [direct() for _ in range(REPEATS)]
    times["direct_fresh_thread"] = [fresh_thread() for _ in range(REPEATS)]
    rt.init()
    try:
        pending = [ObjectRef(ObjectID.from_random()) for _ in range(8)]
        stop = threading.Event()

        def poll():
            while not stop.is_set():
                rt.wait(pending, num_returns=1, timeout=1.0)

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        times["direct_main_beside_poller"] = [direct()
                                              for _ in range(REPEATS)]
        stop.set()
        poller.join()

        @serve.deployment(route_prefix="/generate")
        class LM:
            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
            def generate_batch(self, batch):
                t0 = time.perf_counter()
                out = generate(params, torch.tensor(batch), cfg,
                               max_new_tokens=NEW_TOKENS).tolist()
                self.seconds = time.perf_counter() - t0
                return out

            def __call__(self, prompt=None):
                return self.generate_batch(prompt)

            def last_generate_s(self):
                return self.seconds

        handle = serve.run(LM.bind(), http_host="127.0.0.1")
        url = f"http://127.0.0.1:{handle.http_port}/generate"

        def post(prompt):
            req = urllib.request.Request(
                url, data=json.dumps({"prompt": prompt}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.code

        def http_round():
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                codes = list(pool.map(post, prompts.tolist()))
            if codes != [200] * 8:
                raise RuntimeError(f"statuses {codes}")
            return (time.perf_counter() - t0, rt.get(
                handle.options("last_generate_s").remote(), timeout=60))

        callback_submit = serve_api.DeploymentHandle._submit
        http_round()
        for mode in ("A", "B", "B", "A"):
            serve_api.DeploymentHandle._submit = (
                callback_submit if mode == "A" else polling_submit)
            for h in list(serve_api._handles.values()):
                h.close()   # a fresh handle: no drainer left from B
            times.setdefault(f"http_{mode}", []).extend(
                http_round() for _ in range(REPEATS))
        serve_api.DeploymentHandle._submit = callback_submit
    finally:
        serve.shutdown()
        rt.shutdown()
    for name, values in times.items():
        print(f"[probe] {name}: {values} s on {card}", flush=True)
    print(json.dumps({"card": card, "new_tokens": NEW_TOKENS,
                      "times_s": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
