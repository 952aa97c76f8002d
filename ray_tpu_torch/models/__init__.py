"""The flagship LM (dense or with experts), the ViT classifier, ResNet-50
and the MLP in PyTorch, with the entry points of ``ray_tpu.models``."""

from ray_tpu_torch.models.convert import (params_from_jax,
                                          resnet_variables_from_jax,
                                          vit_params_from_jax)
from ray_tpu_torch.models.generate import (decode_step, generate, init_cache,
                                           prefill)
from ray_tpu_torch.models.mlp import mlp_apply, mlp_init
from ray_tpu_torch.models.moe import load_balance_loss, moe_apply
from ray_tpu_torch.models.resnet import (BottleneckBlock, ResNet, resnet50,
                                         resnet50_apply, resnet50_init,
                                         resnet_loss)
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
    "vit_params_from_jax", "BottleneckBlock", "ResNet", "resnet50",
    "resnet50_init", "resnet50_apply", "resnet_loss",
    "resnet_variables_from_jax", "mlp_init", "mlp_apply",
]
