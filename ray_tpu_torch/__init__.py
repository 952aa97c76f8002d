"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu's compute plane.

The JAX package ``ray_tpu`` stays the reference. This package serves and
trains the flagship LM, trains the ViT and ResNet-50 (``models``, ``train``)
and runs PPO's compute (``rl``) on an NVIDIA Hopper card (H100) through the
same entry points as the JAX package, with each TPU kernel rewritten by hand
in CUDA C++ for ``sm_90a``. It imports torch and numpy only, never JAX nor
``ray_tpu``. What is ported so far, and what is queued, is in ROADMAP.md.
"""

from ray_tpu_torch._device import device_name, require_sm90, resolve_device

__all__ = ["resolve_device", "device_name", "require_sm90"]
