"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain versions.

Ported from ``ray_tpu/ops/flash.py``:

- ``_fwd_kernel`` / ``_flash_fwd`` (the Pallas FlashAttention-2 forward)
  becomes ``csrc/flash_fwd.cu``, launched by ``flash_fwd``; its plain
  version is ``flash_attention_plain``.
- ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` / ``_flash_bwd`` become the
  dK/dV and dQ kernels of ``csrc/flash_bwd.cu``, and the XLA reduction that
  gives them Δ becomes that file's Δ pass, all launched by ``flash_bwd``;
  the plain versions are ``flash_attention_bwd_plain`` and ``bwd_delta``.
- The ``jax.custom_vjp`` around them becomes ``_FlashAttention``, a
  ``torch.autograd.Function`` that ``flash_attention`` goes through whenever
  an input needs a gradient.

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernels (built for ``sm_90a`` by ``ops/_build.py``)
or raises. The TPU's block-shape tables and autotuner (``_GEN_BLOCKS``,
``_fit_block``, ``autotune_blocks``) are not ported: the kernels' tile shapes
are their own constants.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ray_tpu_torch._device import require_sm90
from ray_tpu_torch.ops.attention import NEG_INF, _repeat_kv

# Launches of each CUDA kernel since the last reset (callers set them to 0):
# the forward, and the backward's dK/dV, dQ and Δ kernels.
launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0
bwd_delta_launches = 0

_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_takes(q, k, v) -> bool:
    """Whether the CUDA kernels take these inputs: head_dim in
    ``_HEAD_DIMS`` and q, k and v all of one dtype in ``_DTYPE_CODES``.
    ``mha(impl="auto")`` sends CUDA tensors to the kernel only then."""
    return (q.shape[-1] in _HEAD_DIMS and q.dtype in _DTYPE_CODES
            and k.dtype == q.dtype and v.dtype == q.dtype)


def flash_attention_plain(q, k, v, causal: bool, scale: float):
    """Plain PyTorch version of ``_fwd_kernel``: q [BH, Sq, D], k/v
    [BH, Sk, D] -> (out [BH, Sq, D] in q's dtype, lse [BH, Sq] f32).

    Same arithmetic as the kernel: QKᵀ accumulated in f32, the causal
    diagonal offset by ``sk - sq``, masked logits at NEG_INF with the
    ``m_safe`` guard, P cast to v's dtype before PV, l clamped at 1e-30.
    """
    sq, sk = q.shape[1], k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def flash_fwd_plain(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """BSHD form of ``flash_attention_plain``: q [B, Sq, H, D], k/v
    [B, Sk, KVH, D] -> (out [B, Sq, H, D], lse [B, H, Sq] f32)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(k, v, h)
    scale = scale if scale is not None else d ** -0.5

    def to_bh(x, s):
        return x.transpose(1, 2).reshape(b * h, s, d)

    out, lse = flash_attention_plain(to_bh(q, sq), to_bh(k, sk),
                                     to_bh(v, sk), causal, scale)
    return (out.reshape(b, h, sq, d).transpose(1, 2),
            lse.reshape(b, h, sq))


def _bwd_plain_f32(q, k, v, out, lse, do, causal: bool, scale: float):
    """``flash_attention_bwd_plain`` before its final cast: f32 (dq, dk, dv)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    do32 = do.float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do32)
    dp = torch.matmul(do32, v.float().transpose(1, 2))
    delta = (do32 * out.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    return (torch.matmul(ds, k.float()), torch.matmul(ds.transpose(1, 2),
                                                      q.float()), dv)


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal: bool,
                              scale: float):
    """Plain PyTorch version of ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``:
    q, out, do [BH, Sq, D], k/v [BH, Sk, D], lse [BH, Sq] f32 -> (dq, dk, dv)
    in the inputs' dtypes.

    As ``_flash_bwd``: Δ = rowsum(f32(dO) ⊙ f32(O)); P = exp(scale·QKᵀ,
    causal-masked to NEG_INF with the diagonal offset by ``sk - sq``, − LSE);
    dV = Pᵀ dO with P cast to dO's dtype; dP = dO Vᵀ; dS = P ⊙ (dP − Δ) ·
    scale cast to the input dtype; dK = dSᵀ Q and dQ = dS K, every product
    accumulated in f32.
    """
    dq, dk, dv = _bwd_plain_f32(q, k, v, out, lse, do, causal, scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, out, lse, do, *, causal: bool = True,
                    scale: Optional[float] = None):
    """BSHD form of ``flash_attention_bwd_plain``: q, out, do [B, Sq, H, D],
    k/v [B, Sk, KVH, D], lse [B, H, Sq] f32 -> (dq [B, Sq, H, D],
    dk/dv [B, Sk, KVH, D]). Under GQA the dK and dV of a kv head are the sum
    over its query heads, taken in f32 and rounded once, as the kernel does."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    kr, vr = _repeat_kv(k, v, h)
    scale = scale if scale is not None else d ** -0.5

    def to_bh(x, s):
        return x.transpose(1, 2).reshape(b * h, s, d)

    dq, dk, dv = _bwd_plain_f32(to_bh(q, sq), to_bh(kr, sk), to_bh(vr, sk),
                                to_bh(out, sq), lse.reshape(b * h, sq),
                                to_bh(do, sq), causal, scale)

    def kv_heads(x):   # [B*H, Sk, D] -> [B, Sk, KVH, D], summed per group
        x = x.reshape(b, hk, h // hk, sk, d).sum(2)
        return x.transpose(1, 2).to(k.dtype)

    return (dq.reshape(b, h, sq, d).transpose(1, 2).to(q.dtype),
            kv_heads(dk), kv_heads(dv))


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_fwd(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None):
    """q [B, Sq, H, D], k/v [B, Sk, KVH, D] -> (out [B, Sq, H, D],
    lse [B, H, Sq] f32). CPU tensors take the plain version; CUDA tensors
    launch ``csrc/flash_fwd.cu``. It records no gradient: ``flash_attention``
    is the differentiable entry."""
    if _needs_grad(q, k, v):
        raise ValueError("flash_fwd records no gradient; call "
                         "flash_attention, whose backward runs flash_bwd")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    if not q.is_cuda:
        raise ValueError(f"flash_fwd takes CPU or CUDA tensors, not {q.device}")
    return _flash_fwd_cuda(q, k, v, causal, scale)


def flash_bwd(q, k, v, out, lse, do, *, causal: bool = True,
              scale: Optional[float] = None):
    """Gradients of ``flash_fwd``'s out: q, out, do [B, Sq, H, D], k/v
    [B, Sk, KVH, D], lse [B, H, Sq] f32 (the forward's) -> (dq
    [B, Sq, H, D], dk/dv [B, Sk, KVH, D]). CPU tensors take the plain
    version; CUDA tensors launch the Δ pass, then the dK/dV and dQ kernels
    of ``csrc/flash_bwd.cu``.

    Causal attention with Sq > Sk is refused: its first rows see no key, the
    forward gives them O = 0 and LSE ≈ NEG_INF, and exp(s − LSE) would give
    P = 1 there, which is not the forward's gradient (the TPU backward has
    the same fault, ROADMAP.md C)."""
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"the causal backward takes Sq <= Sk, not "
                         f"Sq {q.shape[1]} > Sk {k.shape[1]}")
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, causal=causal,
                               scale=scale)
    if not q.is_cuda:
        raise ValueError(f"flash_bwd takes CPU or CUDA tensors, not {q.device}")
    return _flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the ``jax.custom_vjp`` ``_flash_bhsd``: the forward
    saves (q, k, v, out, lse), the backward is ``flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, causal=ctx.causal,
                               scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Fused attention; q,k,v: [B, S, H, D] -> [B, Sq, H, D]. Differentiable:
    when an input needs a gradient the call goes through ``_FlashAttention``,
    whose backward is ``flash_bwd``."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_fwd(q, k, v, causal=causal, scale=scale)[0]


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd takes 4-d [B, S, H, D] tensors")
    b, sq, h, d = q.shape
    bk, sk, hk, dk = k.shape
    if v.shape != k.shape or bk != b or dk != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hk == 0 or h % hk:
        raise ValueError(f"{h} query heads do not divide into {hk} kv heads")
    if d not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, not {d}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes one of {list(_DTYPE_CODES)} for "
                         f"q, k and v, not {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if sq == 0 or sk == 0 or b * h == 0:
        raise ValueError("flash_fwd takes non-empty sequences")


def _vector_ready(x):
    """16-byte vector loads, and the kernels' TMA tensor maps, need the last
    dim contiguous, every other stride a positive multiple of 16 bytes, and
    a 16-byte aligned base."""
    per16 = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s > 0 and s % per16 == 0 for s in x.stride()[:-1]))


_libs = {}


def _kernel_library(name: str):
    """``csrc/<name>.cu`` (flash_fwd or flash_bwd), built at first use, with
    its C signature."""
    lib = _libs.get(name)
    if lib is None:
        from ray_tpu_torch.ops._build import load_library
        lib = load_library(name)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if name == "flash_fwd":
            fn, err = lib.rtt_flash_fwd, lib.rtt_error_string
            fn.argtypes = ([ptr] * 5 + [i32] * 7 + [i64] * 12
                           + [ctypes.c_float, i32, i32, ptr])
            attrs = lib.rtt_flash_fwd_bf16_attributes
            attrs.argtypes = [i32] + [ctypes.POINTER(i32)] * 3
            attrs.restype = i32
        else:
            fn, err = lib.rtt_flash_bwd, lib.rtt_flash_bwd_error_string
            fn.argtypes = ([i32] + [ptr] * 9 + [i32] * 8 + [i64] * 12
                           + [ctypes.c_float, i32, i32, ptr])
            delta = lib.rtt_flash_bwd_delta
            delta.argtypes = [ptr] * 5 + [i32] * 6 + [i64] * 6 + [i32, ptr]
            delta.restype = i32
            attrs = lib.rtt_flash_bwd_bf16_attributes
            attrs.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 3
            attrs.restype = i32
        fn.restype = i32
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        lib.error_string = err
        _libs[name] = lib
    return lib


def _attributes(lib, query, *args) -> dict:
    out = [ctypes.c_int() for _ in range(3)]
    err = query(*args, *(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: "
                           f"{lib.error_string(err).decode()} (code {err})")
    return dict(zip(("registers", "local_bytes", "smem_bytes"),
                    (x.value for x in out)))


def fwd_kernel_attributes(head_dim: int) -> dict:
    """What the bf16 forward kernel for ``head_dim`` was built with (needs
    the card): registers a thread at launch, local memory a thread (spills)
    and the dynamic shared memory of a launch, in bytes."""
    lib = _kernel_library("flash_fwd")
    return _attributes(lib, lib.rtt_flash_fwd_bf16_attributes, head_dim)


def bwd_kernel_attributes(head_dim: int) -> dict:
    """``fwd_kernel_attributes`` of the bf16 backward kernels for
    ``head_dim``: {"dkv": {...}, "dq": {...}}."""
    lib = _kernel_library("flash_bwd")
    return {name: _attributes(lib, lib.rtt_flash_bwd_bf16_attributes, which,
                              head_dim)
            for which, name in enumerate(("dkv", "dq"))}


def _raise_on(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.error_string(err).decode()} (code {err})")


def _aligned(*xs):
    """The tensors as given, or a fresh copy of one whose strides break
    16-byte loads (a fresh allocation is contiguous and aligned;
    ``contiguous()`` may return a misaligned view unchanged)."""
    return tuple(x if _vector_ready(x) else
                 x.clone(memory_format=torch.contiguous_format) for x in xs)


def _flash_fwd_cuda(q, k, v, causal: bool, scale: Optional[float]):
    global launches
    _check_inputs(q, k, v)
    require_sm90(q.device)
    q, k, v = _aligned(q, k, v)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    lib = _kernel_library("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.rtt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q.device.index or 0, b, h, hk, sq, sk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], scale, int(causal), _DTYPE_CODES[q.dtype],
        stream)
    _raise_on(lib, err, "flash_fwd")
    launches += 1
    return out, lse


def bwd_delta(out, do):
    """Plain version of the Δ pass: Δ = rowsum(f32(dO) ⊙ f32(O)) as
    [B, H, Sq] f32, as ``_flash_bwd`` computes it outside Pallas."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


# The bf16 kernels read LSE and Δ in rows of Sq rounded up to this
_STAT_ROWS = 64


def bwd_preprocess(out, do, lse):
    """Launch the Δ pass of ``csrc/flash_bwd.cu`` on checked CUDA inputs
    (out, do [B, Sq, H, D] with 16-byte loadable strides, lse [B, H, Sq]
    f32 contiguous): one read of O and dO in their own dtype ->
    (lse_k, delta), both [B, H, R] f32, what the backward kernels read.
    bf16: R is Sq rounded up to 64, the rows past Sq hold zeros, and lse_k
    is LSE·log₂e. f32: R is Sq and lse_k is lse. ``delta[..., :Sq]`` is
    ``bwd_delta(out, do)``."""
    global bwd_delta_launches
    b, sq, h, d = out.shape
    bf16 = out.dtype == torch.bfloat16
    rows = -(-sq // _STAT_ROWS) * _STAT_ROWS if bf16 else sq
    delta = torch.empty(b, h, rows, dtype=torch.float32, device=out.device)
    lse_k = torch.empty_like(delta) if bf16 else lse
    lib = _kernel_library("flash_bwd")
    err = lib.rtt_flash_bwd_delta(
        out.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        lse_k.data_ptr() if bf16 else None, out.device.index or 0, b, h, sq,
        d, rows, *out.stride()[:3], *do.stride()[:3],
        _DTYPE_CODES[out.dtype],
        torch.cuda.current_stream(out.device).cuda_stream)
    _raise_on(lib, err, "flash_bwd_delta")
    bwd_delta_launches += 1
    return lse_k, delta


def _flash_bwd_cuda(q, k, v, out, lse, do, causal: bool,
                    scale: Optional[float]):
    _check_inputs(q, k, v)
    require_sm90(q.device)
    b, sq, h, d = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and do {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"out and do must be {q.dtype}, not {out.dtype}, "
                         f"{do.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, Sq] f32, not "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not (out.device == do.device == lse.device == q.device):
        raise ValueError("all inputs must lie on one device")
    q, k, v, out, do = _aligned(q, k, v, out, do)
    lse_k, delta = bwd_preprocess(out, do, lse.contiguous())
    scale = scale if scale is not None else d ** -0.5
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    args = (q, k, v, do, lse_k, delta, dq, dk, dv, causal, scale)
    bwd_dkv(*args)
    bwd_dq(*args)
    return dq, dk, dv


def _launch_bwd(which: int, q, k, v, do, lse, delta, dq, dk, dv,
                causal: bool, scale: float):
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    lib = _kernel_library("flash_bwd")
    err = lib.rtt_flash_bwd(
        which, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), q.device.index or 0, b, h, hk, sq, sk, d,
        delta.shape[-1], *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *do.stride()[:3],
        scale, int(causal), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(lib, err, ("flash_bwd_dkv", "flash_bwd_dq")[which])


def bwd_dkv(q, k, v, do, lse, delta, dq, dk, dv, causal, scale):
    """Launch the dK/dV kernel into ``dk``, ``dv`` (checked inputs, as
    ``_flash_bwd_cuda`` prepares them; lse and delta from
    ``bwd_preprocess``)."""
    global bwd_dkv_launches
    _launch_bwd(0, q, k, v, do, lse, delta, dq, dk, dv, causal, scale)
    bwd_dkv_launches += 1


def bwd_dq(q, k, v, do, lse, delta, dq, dk, dv, causal, scale):
    """Launch the dQ kernel into ``dq`` (checked inputs, as
    ``_flash_bwd_cuda`` prepares them)."""
    global bwd_dq_launches
    _launch_bwd(1, q, k, v, do, lse, delta, dq, dk, dv, causal, scale)
    bwd_dq_launches += 1
