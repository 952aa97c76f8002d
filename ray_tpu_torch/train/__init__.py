"""Training for the flagship LM, the ViT classifier and ResNet-50 in
PyTorch, with the entry points of ``ray_tpu.train``'s compiled train
steps."""

from ray_tpu_torch.train.step import (TrainState, make_lm_train_step,
                                      make_resnet_train_step,
                                      make_vit_train_step)

__all__ = ["TrainState", "make_lm_train_step", "make_vit_train_step",
           "make_resnet_train_step"]
