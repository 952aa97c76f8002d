"""LM training on a mesh of ranks, one TorchTrainer worker a rank (run:
python examples_torch/02_train_lm_multichip.py [--device cpu]).

With ``--device cpu`` the mesh is dp 4 x tp 2 over 8 gloo ranks on a head
in this process: 4-way data, 2-way tensor parallel, the stand-in for the
JAX example's 8 virtual devices. On the card the mesh is data parallel over
the visible cards, one NCCL rank each; a single card is a one-rank gang,
which runs on the in-process runtime, in this process.
"""
import argparse

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train import TorchTrainer

STEPS = 5


def loop(config):
    import logging

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import TransformerConfig
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train import make_lm_train_step
    from ray_tpu_torch.train.torch_utils import get_device
    # DTensor's notes on gloo's missing all-to-all and on two all-reduces
    # over (dp, tp) are about speed, not results
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dev = get_device()
    if dev.type == "cpu":
        torch.set_num_threads(1)   # a thread a rank: 8 ranks share the host
    mesh = build_mesh(MeshSpec(**config["mesh"]), device=dev)
    # head_dim 64: on the card attention runs the flash kernels
    cfg = TransformerConfig(vocab_size=1024, d_model=256, n_layers=2,
                            n_heads=4, max_seq=128, dtype=torch.float32)
    init_fn, step_fn, place_batch = make_lm_train_step(cfg, mesh,
                                                       device=dev)
    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = place_batch({"tokens": rng.integers(0, 1024, (8, 128))})
    # a weight's layout: sharded on tp, replicated on dp (on one rank, a
    # plain tensor)
    name, leaf = "layers", state.params["layers"]
    while isinstance(leaf, dict):
        key = sorted(leaf)[0]
        name, leaf = f"{name}.{key}", leaf[key]
    sharding = (f"{name}: {list(leaf.placements)} over "
                f"{leaf.device_mesh.mesh_dim_names}"
                if hasattr(leaf, "placements") else
                f"{name}: {type(leaf).__name__} on {leaf.device}")
    for step in range(STEPS):
        state, metrics = step_fn(state, batch)
        session.report({"step": step, "loss": metrics["loss"].item(),
                        "world": dist.get_world_size(),
                        "sharding": sharding})


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None)
    args = parser.parse_args()
    on_cpu = args.device == "cpu"
    if on_cpu:
        world, mesh = 8, {"dp": 4, "tp": 2}
    else:
        from ray_tpu_torch.gpu import local_gpu_count
        world = local_gpu_count()
        if not world:
            raise RuntimeError("no CUDA card on this host: pass --device cpu")
        mesh = {"dp": world}
    # a one-rank gang runs in this process; more ranks need a head
    rt.init(num_cpus=max(world, 2), local_mode=world == 1)
    result = TorchTrainer(
        loop, train_loop_config={"mesh": mesh},
        scaling_config=ScalingConfig(num_workers=world,
                                     use_gpu=not on_cpu)).fit()
    if result.error is not None:
        raise result.error
    for m in result.metrics_history:
        print(f"step {m['step']}: loss={m['loss']:.4f}")
    print(f"ranks: {result.metrics['world']}, mesh: {mesh}")
    print("param sharding example:", result.metrics["sharding"])
    rt.shutdown()


if __name__ == "__main__":
    main()
