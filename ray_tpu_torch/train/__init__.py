"""Training for the flagship LM, the ViT classifier and ResNet-50 in
PyTorch, with the entry points of ``ray_tpu.train``: the train steps, and
the trainer that runs a loop in a gang of worker processes
(``DataParallelTrainer``, ``TorchTrainer``: NCCL over cards, gloo over CPU
workers).

Every name is imported on first use (``ray_tpu/train/__init__.py``'s
exports, without ``JaxTrainer`` and ``JaxBackend``: ``TorchTrainer`` and
``TorchBackend`` take their roles), so a train worker process that runs no
step does not load torch."""

_LAZY = {
    "TrainState": ("ray_tpu_torch.train.step", "TrainState"),
    "make_lm_train_step": ("ray_tpu_torch.train.step", "make_lm_train_step"),
    "make_vit_train_step": ("ray_tpu_torch.train.step",
                            "make_vit_train_step"),
    "make_resnet_train_step": ("ray_tpu_torch.train.step",
                               "make_resnet_train_step"),
    "ScalingConfig": ("ray_tpu_torch.air.config", "ScalingConfig"),
    "RunConfig": ("ray_tpu_torch.air.config", "RunConfig"),
    "CheckpointConfig": ("ray_tpu_torch.air.config", "CheckpointConfig"),
    "FailureConfig": ("ray_tpu_torch.air.config", "FailureConfig"),
    "Checkpoint": ("ray_tpu_torch.air.checkpoint", "Checkpoint"),
    "Result": ("ray_tpu_torch.air.result", "Result"),
    "session": ("ray_tpu_torch.air", "session"),
    "report": ("ray_tpu_torch.air.session", "report"),
    "TorchTrainer": ("ray_tpu_torch.train.trainer", "TorchTrainer"),
    "TorchBackend": ("ray_tpu_torch.train.backend_executor", "TorchBackend"),
    "torch_utils": ("ray_tpu_torch.train.torch_utils", None),
    "DataParallelTrainer": ("ray_tpu_torch.train.trainer",
                            "DataParallelTrainer"),
    "BaseTrainer": ("ray_tpu_torch.train.trainer", "BaseTrainer"),
    "BackendExecutor": ("ray_tpu_torch.train.backend_executor",
                        "BackendExecutor"),
    "WorkerGroup": ("ray_tpu_torch.train.worker_group", "WorkerGroup"),
    "PipelineTrainer": ("ray_tpu_torch.train.pipeline", "PipelineTrainer"),
    "CompiledPipeline": ("ray_tpu_torch.train.pipeline", "CompiledPipeline"),
    "PipelineStageActor": ("ray_tpu_torch.train.pipeline",
                           "PipelineStageActor"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(name)
    import importlib
    mod = importlib.import_module(entry[0])
    return mod if entry[1] is None else getattr(mod, entry[1])
