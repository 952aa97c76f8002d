"""The flagship LM (dense or with experts) and the ViT classifier in
PyTorch, with the entry points of ``ray_tpu.models``."""

from ray_tpu_torch.models.convert import params_from_jax, vit_params_from_jax
from ray_tpu_torch.models.generate import (decode_step, generate, init_cache,
                                           prefill)
from ray_tpu_torch.models.moe import load_balance_loss, moe_apply
from ray_tpu_torch.models.transformer import (TransformerConfig,
                                              transformer_apply,
                                              transformer_init,
                                              transformer_loss,
                                              transformer_num_params)
from ray_tpu_torch.models.vit import ViTConfig, vit_apply, vit_init, vit_loss

__all__ = [
    "TransformerConfig", "transformer_init", "transformer_apply",
    "transformer_loss", "transformer_num_params", "generate", "prefill",
    "decode_step", "init_cache", "params_from_jax", "moe_apply",
    "load_balance_loss", "ViTConfig", "vit_init", "vit_apply", "vit_loss",
    "vit_params_from_jax",
]
