"""The local card count and generation, as the cluster runtime's resource
accounting needs them (``"GPU"``). Takes the place of the JAX package's
``ray_tpu/tpu/`` for the runtime."""

from ray_tpu_torch.gpu.topology import is_sm90, local_gpu_count

__all__ = ["local_gpu_count", "is_sm90"]
