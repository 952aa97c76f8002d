"""Attention ops: plain PyTorch primitives and the hand-written flash kernel.

- attention: reference softmax attention and the blockwise online-softmax
  form, differentiable on any device.
- flash: the FlashAttention-2 forward and backward, CUDA C++ kernels for
  sm_90a (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) with their plain
  PyTorch versions, joined by a ``torch.autograd.Function``.
- ring_attention: sequence parallelism over a ring of ranks (point-to-point
  rotation of kv), blockwise-causal.
- ulysses: all-to-all sequence parallelism (seq-sharded <-> head-sharded).
- pipeline: the GPipe schedule over a mesh axis.
"""

from ray_tpu_torch.ops.attention import (attention_reference,
                                         blockwise_attention, mha)
from ray_tpu_torch.ops.flash import (flash_attention,
                                     flash_attention_bwd_plain,
                                     flash_attention_plain, flash_bwd,
                                     flash_bwd_plain, flash_fwd,
                                     flash_fwd_plain)
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.ops.ulysses import ulysses_attention

__all__ = [
    "attention_reference", "blockwise_attention", "mha",
    "flash_attention", "flash_attention_plain", "flash_fwd",
    "flash_fwd_plain", "flash_bwd", "flash_bwd_plain",
    "flash_attention_bwd_plain", "ring_attention", "ulysses_attention",
]
