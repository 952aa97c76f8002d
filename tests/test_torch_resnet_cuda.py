"""ResNet and its train step on the card. Every test is marked ``cuda`` and
skips without a CUDA card. The file imports no JAX, so it runs where JAX is
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_resnet_cuda.py

Tolerance: the small f32 model on the card (cuDNN, TF32 off for the test)
against the CPU, 1e-3 on logits, the loss, every updated parameter and
every batch statistic: the two sum the convolutions in other orders, and
train-mode BatchNorm over 4 values a channel (1x1 maps at batch 4)
magnifies that rounding.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import resnet as tres
from ray_tpu_torch.train import make_resnet_train_step

TOL = 1e-3
SMALL = (1, 1, 1, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _perturbed(variables, seed):
    """``variables`` with every BatchNorm scale, bias and running statistic
    drawn from a seed (the init zeroes each block's last scale, which would
    hide its branch)."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = 0.5 + torch.rand(v.shape, generator=gen)
            elif k in ("bias", "mean"):
                out[k] = 0.1 * torch.randn(v.shape, generator=gen)
            else:
                out[k] = v
        return out

    return walk(variables)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _batch(b=4, size=32, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((b, size, size, 3))
            .astype(np.float32),
            "label": rng.integers(0, classes, (b,))}


@pytest.mark.cuda
def test_small_f32_matches_cpu(cuda_device, no_tf32):
    model = tres.ResNet(SMALL, 10, torch.float32)
    cpu = _perturbed(model.init(torch.Generator().manual_seed(0),
                                device="cpu"), seed=1)
    card = _to(cpu, cuda_device)
    batch = _batch()
    images = torch.from_numpy(batch["image"])
    with torch.no_grad():
        for train in (True, False):
            want = tres.resnet50_apply(model, cpu, images, train=train,
                                       device="cpu")
            got = tres.resnet50_apply(model, card, images, train=train)
            if train:
                (want, want_stats), (got, got_stats) = want, got
                for name, v in _flat(got_stats).items():
                    assert torch.allclose(v.cpu(), _flat(want_stats)[name],
                                          atol=TOL, rtol=TOL), name
            assert got.device.type == "cuda"
            assert torch.allclose(got.cpu(), want, atol=TOL, rtol=TOL)
    results = []
    for variables, device in ((cpu, "cpu"), (card, None)):
        init_fn, step_fn, place = make_resnet_train_step(
            num_classes=10, image_size=32, dtype=torch.float32,
            stage_sizes=SMALL, device=device)
        state, metrics = step_fn(init_fn(variables), place(batch))
        results.append((state.params, metrics))
    (want, wm), (got, gm) = results
    assert abs(gm["loss"].item() - wm["loss"].item()) <= TOL
    want = _flat(want)
    for name, v in _flat(got).items():
        assert torch.allclose(v.detach().cpu(), want[name].detach(),
                              atol=TOL, rtol=TOL), name


@pytest.mark.cuda
def test_bf16_step_is_finite_and_moves_the_statistics(cuda_device):
    init_fn, step_fn, place = make_resnet_train_step(
        num_classes=10, image_size=32, stage_sizes=SMALL)
    state = init_fn(torch.Generator(device=cuda_device).manual_seed(0))
    stats = {k: v.clone() for k, v in
             _flat(state.params["batch_stats"]).items()}
    batch = place(_batch(b=8))
    losses = []
    for _ in range(3):
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for name, v in _flat(state.params["batch_stats"]).items():
        assert torch.isfinite(v).all() and not torch.equal(v, stats[name]), \
            name
    # channels_last through the model: the NHWC batch permuted, and cuDNN's
    # output of a convolution on it
    x = batch["image"].to(torch.bfloat16).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    y = tres.conv(x, state.params["params"]["conv_init"]["kernel"], 2, 3)
    assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
def test_default_step_lives_on_the_card(cuda_device):
    init_fn, step_fn, place = make_resnet_train_step()
    state = init_fn(torch.Generator(device=cuda_device).manual_seed(0))
    leaves = _flat(state.params)
    assert all(v.device.type == "cuda" and v.dtype == torch.float32
               for v in leaves.values())
    assert sum(v.numel() for k, v in leaves.items()
               if k.startswith("params/")) == 25_557_032
    batch = place(_batch(b=2, size=64, classes=1000))
    assert batch["image"].device.type == "cuda"
    state, metrics = step_fn(state, batch)
    assert metrics["loss"].device.type == "cuda"
    assert np.isfinite(metrics["loss"].item()) and state.step == 1
