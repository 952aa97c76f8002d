"""torch conveniences for TorchTrainer loops. Ported from
``ray_tpu/train/torch_utils.py``.

Role parity: python/ray/train/torch/train_loop_utils.py: get_device,
prepare_model (DDP wrap), prepare_data_loader (DistributedSampler).

Where the port differs from the JAX module, which keeps torch on the CPU:
``get_device`` returns the worker's card, ``cuda:0`` (the one its lease
gave it: the node daemon sets ``CUDA_VISIBLE_DEVICES``), in a gang whose
workers hold cards, and the CPU in a CPU gang; ``prepare_model`` moves the
model there and, above one rank, wraps it in ``DistributedDataParallel``
with ``device_ids`` on the card.
"""

from __future__ import annotations


def get_device():
    """The device of this train worker: its session's (``cuda:0`` or the
    CPU); outside a session, ``cuda:0`` when a card is visible."""
    import torch

    from ray_tpu_torch.air import session
    s = session._get_session()
    if s is not None:
        return torch.device(s.device)
    return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")


def prepare_model(model):
    """Move ``model`` to ``get_device()``; wrap it in
    DistributedDataParallel when a process group of more than one rank is
    live."""
    import torch.distributed as dist
    device = get_device()
    model = model.to(device)
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel
        if device.type == "cuda":
            return DistributedDataParallel(model, device_ids=[device.index])
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(data_loader):
    """Re-build the loader with a DistributedSampler sharding per rank."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return data_loader
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler
    sampler = DistributedSampler(data_loader.dataset)
    return DataLoader(data_loader.dataset,
                      batch_size=data_loader.batch_size,
                      sampler=sampler,
                      num_workers=0,
                      collate_fn=data_loader.collate_fn,
                      drop_last=data_loader.drop_last)
