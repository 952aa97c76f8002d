"""ray_tpu_torch.data — distributed block-based data library. Ported from
``ray_tpu/data/``.

Parity surface: reference python/ray/data (Dataset dataset.py:168, blocks
block.py:237, lazy plan _internal/plan.py, streaming executor
streaming_executor.py:45, shuffle push_based_shuffle.py, datasources
datasource/, DatasetPipeline dataset_pipeline.py).

Blocks are dicts of numpy columns (``block.py``). It runs on both port
runtimes, and feeds ``TorchTrainer(datasets=...)``. Importing it loads
numpy and the standard library only: pyarrow (parquet, ``from_arrow``,
``ArrowTensorType``), pandas (``from_pandas``, ``to_pandas``) and PIL
(``read_images``) load inside the calls that need them, and torch inside
``iter_torch_batches``.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data.dataset import Dataset, DatasetPipeline, GroupedData
from ray_tpu_torch.data.datasource import (from_arrow, from_items,
                                           from_numpy, from_pandas, range,
                                           read_binary_files, read_csv,
                                           read_images, read_json,
                                           read_numpy, read_parquet,
                                           read_tfrecords, write_tfrecords)
from ray_tpu_torch.data import preprocessors
from ray_tpu_torch.data.llm import ByteTokenizer, tokenize_and_pack

__all__ = ["Dataset", "DatasetPipeline", "GroupedData", "Block",
           "BlockAccessor", "range", "from_items", "from_numpy",
           "from_pandas", "from_arrow", "read_parquet", "read_csv",
           "read_json", "read_numpy", "read_binary_files", "read_images",
           "read_tfrecords", "write_tfrecords", "preprocessors",
           "ByteTokenizer", "tokenize_and_pack", "ArrowTensorArray",
           "ArrowTensorType"]


def __getattr__(name):
    # pyarrow loads on first use of the Arrow extension types only
    if name in ("ArrowTensorArray", "ArrowTensorType"):
        from ray_tpu_torch.data import tensor_ext
        return getattr(tensor_ext, name)
    raise AttributeError(
        f"module 'ray_tpu_torch.data' has no attribute {name!r}")
