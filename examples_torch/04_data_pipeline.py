"""Text -> packed tokens -> per-rank dataset shards -> train loop (run:
python examples_torch/04_data_pipeline.py; its workers run on the CPU, so
``--device cpu`` changes nothing)."""
import argparse

import ray_tpu_torch as rt
from ray_tpu_torch import data
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train.trainer import DataParallelTrainer


def loop(config):
    from ray_tpu_torch.air import session
    shard = session.get_dataset_shard("train")
    rows = 0
    for batch in shard.iter_batches(batch_size=8):
        rows += len(batch["tokens"])
    session.report({"rank": session.get_world_rank(), "rows": rows})


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None)
    parser.parse_args()
    rt.init(num_cpus=8)  # explicit size: actors HOLD their CPU, so
    # leave headroom for tasks scheduled alongside them
    corpus = [{"text": "jax and pallas and pjit make the chips go brrr. " * 4}
              for _ in range(16)]
    ds = data.tokenize_and_pack(data.from_items(corpus, parallelism=4),
                                seq_len=64)
    print("packed sequences:", ds.count())
    # two CPU workers: use_gpu=False (left unset, a worker asks for a card)
    result = DataParallelTrainer(
        loop, datasets={"train": ds},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     resources_per_worker={"CPU": 1})).fit()
    print("rank-0 metrics:", result.metrics)
    rt.shutdown()


if __name__ == "__main__":
    main()
