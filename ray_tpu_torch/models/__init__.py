"""The flagship LM in PyTorch, with the entry points of ``ray_tpu.models``."""

from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.generate import (decode_step, generate, init_cache,
                                           prefill)
from ray_tpu_torch.models.transformer import (TransformerConfig,
                                              transformer_apply,
                                              transformer_init,
                                              transformer_loss,
                                              transformer_num_params)

__all__ = [
    "TransformerConfig", "transformer_init", "transformer_apply",
    "transformer_loss", "transformer_num_params", "generate", "prefill",
    "decode_step", "init_cache", "params_from_jax",
]
