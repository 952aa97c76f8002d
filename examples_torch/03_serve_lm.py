"""Serve the in-tree LM with KV-cache generation over HTTP (run: python
examples_torch/03_serve_lm.py [--device cpu] [--local-mode]).

The replica holds the model on the card unless ``--device cpu``; on a head
(the default) it is a worker process that leases the card, with
``--local-mode`` a thread of this process (the in-process runtime)."""
import argparse
import json
import urllib.request

import ray_tpu_torch as rt
from ray_tpu_torch import serve


@serve.deployment(route_prefix="/generate")
class LM:
    def __init__(self, device=None):
        import torch

        from ray_tpu_torch.models import TransformerConfig, transformer_init
        self.device = device
        # head_dim 64: on the card the prefill runs the flash kernel
        self.cfg = TransformerConfig(vocab_size=258, d_model=256, n_layers=2,
                                     n_heads=4, n_kv_heads=2, max_seq=128,
                                     dtype=torch.float32)
        gen = torch.Generator(device=device or "cuda").manual_seed(0)
        self.params = transformer_init(gen, self.cfg, device=device)

    def __call__(self, prompt=None):
        import torch

        from ray_tpu_torch.data import ByteTokenizer
        from ray_tpu_torch.models import generate
        tok = ByteTokenizer()
        ids = tok.encode(prompt or "hello")[:-1]      # keep it open-ended
        out = generate(self.params, torch.tensor([ids]), self.cfg,
                       max_new_tokens=16, temperature=0.8, top_k=40,
                       device=self.device)[0].tolist()
        return {"prompt": prompt, "generated_tokens": out,
                "text": tok.decode(out)}


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None)
    parser.add_argument("--local-mode", action="store_true")
    args = parser.parse_args()
    from ray_tpu_torch._device import resolve_device
    resolve_device(args.device)   # no card: raise now, not in the replica
    cards = 0 if args.device == "cpu" else 1
    rt.init(num_cpus=8, local_mode=args.local_mode,
            num_gpus=cards if args.local_mode else None)
    app = LM.options(ray_actor_options={"num_gpus": cards}).bind(args.device)
    handle = serve.run(app, http_host="127.0.0.1")
    req = urllib.request.Request(
        f"http://127.0.0.1:{handle.http_port}/generate",
        data=json.dumps({"prompt": "gpu"}).encode(),
        headers={"Content-Type": "application/json"})
    print(json.loads(urllib.request.urlopen(req, timeout=120).read()))
    serve.shutdown()
    rt.shutdown()


if __name__ == "__main__":
    main()
