"""Attention ops: plain PyTorch primitives and the hand-written flash kernel.

- attention: reference softmax attention and the blockwise online-softmax
  form, differentiable on any device.
- flash: the FlashAttention-2 forward and backward, CUDA C++ kernels for
  sm_90a (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) with their plain
  PyTorch versions, joined by a ``torch.autograd.Function``.
"""

from ray_tpu_torch.ops.attention import (attention_reference,
                                         blockwise_attention, mha)
from ray_tpu_torch.ops.flash import (flash_attention,
                                     flash_attention_bwd_plain,
                                     flash_attention_plain, flash_bwd,
                                     flash_bwd_plain, flash_fwd,
                                     flash_fwd_plain)

__all__ = [
    "attention_reference", "blockwise_attention", "mha",
    "flash_attention", "flash_attention_plain", "flash_fwd",
    "flash_fwd_plain", "flash_bwd", "flash_bwd_plain",
    "flash_attention_bwd_plain",
]
