"""ResNet-50, ported from ``ray_tpu/models/resnet.py``.

The image-classification bench model (``bench.py:bench_resnet``): images
NHWC in, logits f32 out; convolutions and BatchNorm outputs in ``dtype``
(bfloat16 by default), parameters and BatchNorm statistics float32.

``BottleneckBlock`` and ``ResNet`` are frozen dataclasses that hold what the
flax modules hold as attributes, and their ``__call__`` is a function over a
variables dict, as flax's ``apply``. The dict keeps flax's tree key for key:
``{"params", "batch_stats"}``, then ``conv_init``, ``bn_init``,
``BottleneckBlock_0..15`` (each ``Conv_0..2`` and ``BatchNorm_0..2``, and
``conv_proj`` with ``norm_proj`` where the block changes shape) and
``Dense_0``. Two layouts differ, and ``convert.resnet_variables_from_jax``
maps them: conv kernels are ``[out, in, kh, kw]`` (flax: ``[kh, kw, in,
out]``); the Dense kernel stays ``[in, out]``.

flax's semantics, matched exactly:

- SAME padding as ``lax.padtype_to_pads``, ``(total // 2, total - total //
  2)`` per spatial dimension: at stride 2 on an even map that is ``(0, 1)``,
  not the ``(1, 1)`` of ``padding=1``. The max pool pads with -inf.
- BatchNorm (momentum 0.9, epsilon 1e-5): train mode normalises with the
  batch's biased variance and returns running averages ``0.9 · running +
  0.1 · batch`` of the batch mean and *biased* variance; eval mode
  normalises with the running averages. ``F.batch_norm`` normalises (in f32,
  output in the input's dtype, as flax). It would keep the unbiased
  variance, n/(n−1) times flax's, so the port makes the running averages
  itself (``batch_norm``). Each block's last BatchNorm starts at scale 0.

On a mesh (``group=``, the process group of the mesh's data axes, which
the train step passes from inside its ``shard_map``) each rank runs the
model on its rows of the batch, and train-mode BatchNorm normalises with the
statistics of the global batch, as flax's under jit with the batch sharded:
the per-channel sums, sums of squares and counts are all-reduced over the
group and the variance is flax's E[x²] − E[x]² clipped at 0
(``_GlobalBatchNorm``). Its backward all-reduces the sums that the
gradient of the statistics needs.

The model computes in ``channels_last`` memory format, which cuDNN's
tensor-core convolutions take: the NHWC images permuted to NCHW already are
``channels_last``, with no copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import check_device

MOMENTUM = 0.9
EPSILON = 1e-5


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """``lax.padtype_to_pads(..., "SAME")`` along one dimension: the output
    is ``ceil(size / stride)`` and the padding ``(total // 2, total - total
    // 2)``, the odd element after the input."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, window: int, stride: int, value: float = 0.0):
    """x [N, C, H, W] and the symmetric padding left for the op: SAME pads
    that are equal on both sides go to the op (no copy), others to
    ``F.pad`` first."""
    (top, bottom), (left, right) = (same_pads(n, window, stride)
                                    for n in x.shape[2:])
    if (top, left) == (bottom, right):
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


def conv(x, kernel, stride: int = 1, padding="SAME"):
    """flax ``nn.Conv(use_bias=False)`` on x [N, C, H, W] with kernel
    [out, in, kh, kw], cast to x's dtype; ``padding`` "SAME" or an int."""
    if padding == "SAME":
        x, padding = _pad_same(x, kernel.shape[2], stride)
    return F.conv2d(x, kernel.to(x.dtype), stride=stride, padding=padding)


def max_pool_same(x, window: int = 3, stride: int = 2):
    """``nn.max_pool(x, (window, window), (stride, stride), "SAME")``: the
    padding is -inf, so a window's maximum is over real elements only."""
    x, padding = _pad_same(x, window, stride, value=-math.inf)
    return F.max_pool2d(x, window, stride, padding=padding)


def batch_norm(x, params, stats, train: bool, group=None):
    """flax ``nn.BatchNorm`` over N, H and W of x [N, C, H, W] -> (y in x's
    dtype, statistics). Train mode returns the new running averages; eval
    mode normalises with ``stats`` and returns them unchanged. With
    ``group`` train mode takes the statistics over the rows of every rank
    of the group (``_GlobalBatchNorm``).

    In train mode ``F.batch_norm`` writes into the buffers it is given
    ``(1 − m) · buffer + m · batch``, with the batch mean and the *unbiased*
    variance; at m = 1 into zeroed buffers that is the batch's own
    statistics from its one pass over x. The update rescales the variance
    to the biased one that flax averages (flax computes it as E[x²] − E[x]²
    clipped at 0; the two agree to f32 rounding). Like ``F.batch_norm``,
    train mode refuses a channel with one value (flax would normalise it to
    its bias)."""
    # statistics, scale and bias in at least f32 (flax's promotion)
    acc = torch.promote_types(x.dtype, torch.float32)
    scale, bias = params["scale"].to(acc), params["bias"].to(acc)
    if not train:
        return F.batch_norm(x, stats["mean"].to(acc), stats["var"].to(acc),
                            scale, bias, training=False, eps=EPSILON), stats
    if group is not None:
        y, mean, var = _GlobalBatchNorm.apply(x, scale, bias, group)
    else:
        mean = torch.zeros_like(stats["mean"], dtype=acc)
        var = torch.zeros_like(stats["var"], dtype=acc)
        y = F.batch_norm(x, mean, var, scale, bias, training=True,
                         momentum=1.0, eps=EPSILON)
        n = x.numel() // x.shape[1]
        var = var * ((n - 1) / n)
    return y, {
        "mean": MOMENTUM * stats["mean"] + (1 - MOMENTUM) * mean,
        "var": MOMENTUM * stats["var"] + (1 - MOMENTUM) * var,
    }


_DIMS = (0, 2, 3)      # N, H and W: BatchNorm's reduction over [N, C, H, W]


def _per_channel(t):
    return t[:, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of x [N, C, H, W] over the rows of every rank of
    ``group`` -> (y in x's dtype, the global mean, the global biased
    variance). One all-reduce of [3, C] forward (sums, sums of squares,
    counts) and one of [2, C] backward (the sums of dy and of dy · (x −
    mean) that the statistics' gradients need). It keeps x and the
    per-channel statistics for the backward, as F.batch_norm does. The
    gradients of scale and bias are this rank's shares; the train step sums
    them over the data axes with every other parameter's.

    On the card each rank's passes are PyTorch's own kernels for BatchNorm
    split over ranks (those of ``nn.SyncBatchNorm``, channels_last
    included): one for the rank's mean and variance, one to normalise, two
    backward. On the CPU they are elementwise in the statistics' dtype."""

    @staticmethod
    def forward(ctx, x, scale, bias, group):
        import torch.distributed as dist
        acc, n_local = scale.dtype, x.numel() // x.shape[1]
        if x.is_cuda:
            # eps 0: the rank's exact variance is 1 / invstd²
            mean, invstd = torch.batch_norm_stats(x, 0.0)
            mean, var = mean.to(acc), invstd.to(acc).pow(-2)
            sums = torch.stack([mean, var + mean * mean,
                                torch.ones_like(mean)]) * n_local
        else:
            t = x.to(acc, copy=True)
            sums = torch.stack([t.sum(_DIMS), t.square().sum(_DIMS),
                                torch.full_like(scale, n_local)])
        dist.all_reduce(sums, group=group)
        n = sums[2]
        mean = sums[0] / n
        var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + EPSILON)
        if x.is_cuda:
            y = torch.batch_norm_elemt(x, scale, bias, mean, invstd, EPSILON)
        else:
            y = t.sub_(_per_channel(mean)).mul_(_per_channel(invstd * scale)) \
                .add_(_per_channel(bias)).to(x.dtype)
        ctx.save_for_backward(x, mean, invstd, scale, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        import torch.distributed as dist
        x, mean, invstd, scale, n = ctx.saved_tensors
        if x.is_cuda:
            dy = dy.contiguous(memory_format=torch.channels_last
                               if x.is_contiguous(
                                   memory_format=torch.channels_last)
                               else torch.contiguous_format)
            sum_dy, sum_dy_xmu, dscale, dbias = \
                torch.batch_norm_backward_reduce(dy, x, mean, invstd, scale,
                                                 True, True, True)
            sums = torch.stack([sum_dy, sum_dy_xmu])
            dist.all_reduce(sums, group=ctx.group)
            dx = torch.batch_norm_backward_elemt(
                dy, x, mean, invstd, scale, sums[0], sums[1],
                n[:1].to(torch.int32))
            return dx, dscale, dbias, None
        xmu = x.to(scale.dtype, copy=True).sub_(_per_channel(mean))
        g = dy.to(scale.dtype)
        local = torch.stack([g.sum(_DIMS), (g * xmu).sum(_DIMS)])
        sums = local.clone()
        dist.all_reduce(sums, group=ctx.group)
        dx = (g - _per_channel(sums[0] / n)
              - xmu.mul_(_per_channel(invstd * invstd * sums[1] / n))) \
            .mul_(_per_channel(invstd * scale))
        return dx.to(x.dtype), local[1] * invstd, local[0], None


def _norm_shapes(c: int):
    return {"scale": (c,), "bias": (c,)}, {"mean": (c,), "var": (c,)}


@dataclasses.dataclass(frozen=True)
class BottleneckBlock:
    """1x1, 3x3 (with the stride) and 1x1 x 4 convolutions, each followed by
    BatchNorm, and a projection of the input where the block changes its
    shape."""
    filters: int
    strides: int = 1
    dtype: Any = torch.bfloat16

    def variable_shapes(self, in_features: int):
        """(params, batch_stats) shape trees of the block on ``in_features``
        input channels, in flax's names."""
        f = self.filters
        params, stats = {}, {}
        for i, (out, inp, k) in enumerate(((f, in_features, 1), (f, f, 3),
                                           (4 * f, f, 1))):
            params[f"Conv_{i}"] = {"kernel": (out, inp, k, k)}
            params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"] = \
                _norm_shapes(out)
        if self.strides != 1 or in_features != 4 * f:
            params["conv_proj"] = {"kernel": (4 * f, in_features, 1, 1)}
            params["norm_proj"], stats["norm_proj"] = _norm_shapes(4 * f)
        return params, stats

    def __call__(self, params, stats, x, train: bool = True, group=None):
        """-> (y, the block's new batch statistics); ``group`` as
        ``batch_norm``'s."""
        new = {}
        residual = x
        y = conv(x, params["Conv_0"]["kernel"])
        y, new["BatchNorm_0"] = batch_norm(y, params["BatchNorm_0"],
                                           stats["BatchNorm_0"], train,
                                           group)
        y = conv(F.relu(y, inplace=True), params["Conv_1"]["kernel"],
                 self.strides)
        y, new["BatchNorm_1"] = batch_norm(y, params["BatchNorm_1"],
                                           stats["BatchNorm_1"], train,
                                           group)
        y = conv(F.relu(y, inplace=True), params["Conv_2"]["kernel"])
        y, new["BatchNorm_2"] = batch_norm(y, params["BatchNorm_2"],
                                           stats["BatchNorm_2"], train,
                                           group)
        if "conv_proj" in params:
            residual = conv(residual, params["conv_proj"]["kernel"],
                            self.strides)
            residual, new["norm_proj"] = batch_norm(
                residual, params["norm_proj"], stats["norm_proj"], train,
                group)
        return F.relu(residual + y, inplace=True), new


@dataclasses.dataclass(frozen=True)
class ResNet:
    """A 7x7/2 convolution with BatchNorm and a 3x3/2 max pool, then
    ``stage_sizes[i]`` bottleneck blocks of 64·2^i filters (the first of
    each stage after the first at stride 2), the mean over H and W, and a
    Dense head in f32."""
    stage_sizes: Sequence[int]
    num_classes: int = 1000
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        object.__setattr__(self, "stage_sizes", tuple(self.stage_sizes))

    def blocks(self) -> Iterator[Tuple[str, BottleneckBlock, int]]:
        """(flax name, block, input channels) in order."""
        k, features = 0, 64
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                yield (f"BottleneckBlock_{k}",
                       BottleneckBlock(64 * 2 ** i, strides, self.dtype),
                       features)
                k, features = k + 1, 4 * 64 * 2 ** i

    def variable_shapes(self) -> Dict[str, Any]:
        """The variables' shape tree, ``{"params", "batch_stats"}``."""
        params = {"conv_init": {"kernel": (64, 3, 7, 7)}}
        stats = {}
        params["bn_init"], stats["bn_init"] = _norm_shapes(64)
        features = 64
        for name, block, in_features in self.blocks():
            params[name], stats[name] = block.variable_shapes(in_features)
            features = 4 * block.filters
        params["Dense_0"] = {"kernel": (features, self.num_classes),
                             "bias": (self.num_classes,)}
        return {"params": params, "batch_stats": stats}

    def init(self, generator: torch.Generator, device=None) -> Dict[str, Any]:
        """flax's initialisers: ``lecun_normal`` (a normal truncated at two
        standard deviations, variance 1 / fan-in) for the conv and Dense
        kernels; BatchNorm scale 1, except each block's last (0); biases
        and running means 0, running variances 1. ``generator`` must live
        on the target device."""
        dev = resolve_device(device)

        def make(path, shape):
            if path[-1] == "kernel":
                fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
                # lecun_normal: the truncation's own std is 0.8796 of 1
                std = fan_in ** -0.5 / .87962566103423978
                return torch.nn.init.trunc_normal_(
                    torch.empty(shape, dtype=torch.float32, device=dev), 0.0,
                    std, -2 * std, 2 * std, generator=generator)
            fill = 1.0 if path[-1] == "var" or (
                path[-1] == "scale" and path[-2] != "BatchNorm_2") else 0.0
            return torch.full(shape, fill, dtype=torch.float32,
                              device=dev)

        def walk(tree, path=()):
            return {k: walk(v, path + (k,)) if isinstance(v, dict)
                    else make(path + (k,), v) for k, v in tree.items()}

        return walk(self.variable_shapes())

    def __call__(self, variables, x, train: bool = True, group=None):
        """x [N, C, H, W] in ``dtype`` -> logits [N, num_classes] f32, and
        in train mode the new ``batch_stats``. With ``group`` (the process
        group of the mesh's data axes) x is this rank's rows and train-mode
        BatchNorm takes its statistics over every rank's."""
        params, stats = variables["params"], variables["batch_stats"]
        new = {}
        x = conv(x, params["conv_init"]["kernel"], 2, padding=3)
        x, new["bn_init"] = batch_norm(x, params["bn_init"],
                                       stats["bn_init"], train, group)
        x = max_pool_same(F.relu(x, inplace=True))
        for name, block, _ in self.blocks():
            x, new[name] = block(params[name], stats[name], x, train,
                                 group)
        # jnp.mean of bf16 sums in f32 and rounds the mean to bf16
        x = x.mean((2, 3), dtype=torch.float32).to(self.dtype)
        dense = params["Dense_0"]
        logits = x.float() @ dense["kernel"] + dense["bias"]
        return (logits, new) if train else logits


def resnet50(num_classes: int = 1000, dtype=torch.bfloat16) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, dtype)


def resnet50_init(generator: torch.Generator, *, image_size: int = 224,
                  num_classes: int = 1000, dtype=torch.bfloat16,
                  device=None):
    """-> (model, variables). ``image_size`` is the JAX signature's (flax
    traces the init on an image of that size); the variables do not depend
    on it."""
    model = resnet50(num_classes, dtype)
    return model, model.init(generator, device=device)


def resnet50_apply(model: ResNet, variables, images, *, train: bool = True,
                   device=None):
    """images [B, H, W, 3] -> (logits, new_batch_stats) in train mode,
    logits otherwise. The variables must lie on ``device``."""
    dev = resolve_device(device)
    check_device(variables["params"]["conv_init"], dev, key="kernel")
    # NHWC permuted to NCHW: channels_last strides, no copy
    x = images.to(dev, model.dtype).permute(0, 3, 1, 2)
    return model(variables, x, train=train)


def resnet_loss(logits, labels):
    """Mean cross-entropy of f32 logits [B, classes] against int labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()
