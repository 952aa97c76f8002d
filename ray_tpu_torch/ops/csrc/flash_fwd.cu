// FlashAttention-2 forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ray_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of ray_tpu/ops/flash.py
// (launched by `_flash_fwd`). Same function:
//   O   = softmax(scale * Q K^T + causal mask) V     (in the input dtype)
//   LSE = m + log(l)                                 ([B, H, Sq] f32)
// with the causal diagonal offset by sk - sq, masked logits at -1e30, the
// fully-masked-row guard m_safe = max(m, -1e30 / 2), l clamped at 1e-30, and
// P cast to V's dtype before P V with f32 accumulation.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// serving path's prompt (BH 128, S 128, D 128) the bytes of q, k, v and o
// (~17 MB, ~5 us) outweigh the ~0.5 GFLOP of causal work (~0.6 us); from a
// few hundred tokens up (S 2048: ~137 GFLOP against ~270 MB) it is the
// tensor-core rate. So the design keeps every intermediate on chip: one CTA
// owns one (batch*head, 64-row q tile), keeps Q in registers and the
// online-softmax state (m, l, O accumulator) in registers, and walks the kv
// tiles itself (the TPU carried that state across a sequential grid axis;
// CUDA blocks run in no order). K/V tiles are staged in shared memory with
// cp.async and read by ldmatrix into bf16 mma.sync (m16n8k16, f32
// accumulate). Tiles wholly above the causal diagonal are never visited, and
// the heaviest causal q tiles are scheduled first. wgmma, TMA, a K/V ring
// and warp specialisation are later work.
//
// f32 inputs (the parity checks) run a plain FMA kernel of the same
// structure: four threads per q row, each owning a quarter of head_dim.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, KVH, D], o [B, Sq, H, D], each read
// through its strides (last dim contiguous, other strides multiples of 16
// bytes); GQA maps query head h to kv head h / (H / KVH). Any Sq and Sk: the
// ragged tails are masked. head_dim 64 or 128.

#include "flash_common.cuh"

namespace {

using namespace rtt;

enum : int {
  kErrBadDtype = -1,
  kErrBadHeadDim = -2,
  kErrGridTooLarge = -3,
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, KVH, Sq, Sk;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// Number of kv tiles a q tile must visit: all of them, or, under the causal
// mask, only those not wholly above the diagonal of its last row.
__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int block_m,
                                        int block_n) {
  int n = (p.Sk + block_n - 1) / block_n;
  if (p.causal) {
    int last = min(q0 + block_m, p.Sq) - 1 + (p.Sk - p.Sq);
    n = last < 0 ? 0 : min(n, last / block_n + 1);
  }
  return n;
}

__device__ __forceinline__ bool masked(const Params& p, int qi, int kj) {
  return kj >= p.Sk || (p.causal && qi + (p.Sk - p.Sq) < kj);
}

// ------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ------------------------------------------------------------------------

constexpr int kBlockM = 64;  // q rows per CTA, 16 per warp
constexpr int kBlockN = 64;  // kv rows per tile
constexpr int kThreads = 128;

// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): an accumulator
// tile holds rows g (elements 0, 1) and g + 8 (elements 2, 3) at columns
// 2t and 2t + 1. So each thread owns two q rows of its warp's 16.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int kPitch = D + 8;  // 16-byte pad: conflict-free ldmatrix rows
  __shared__ __align__(16) __nv_bfloat16 s_qk[kBlockM * kPitch];  // Q, then K
  __shared__ __align__(16) __nv_bfloat16 s_v[kBlockN * kPitch];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heavy tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const auto* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                   h * p.q_sh;
  const auto* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                   kvh * p.k_sh;
  const auto* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                   kvh * p.v_sh;

  load_tile<__nv_bfloat16, kBlockM, D, kPitch, kThreads>(s_qk, qb, p.q_ss, q0,
                                                         p.Sq);
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    int row = warp * 16 + lane % 16;
    int col = ks * 16 + (lane / 16) * 8;
    ldmatrix_x4(qf[ks], s_qk + row * kPitch + col);
  }
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_tiles = kv_tiles(p, q0, kBlockM, kBlockN);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBlockN;
    load_tile<__nv_bfloat16, kBlockN, D, kPitch, kThreads>(s_qk, kb, p.k_ss,
                                                           kv0, p.Sk);
    load_tile<__nv_bfloat16, kBlockN, D, kPitch, kThreads>(s_v, vb, p.v_ss,
                                                           kv0, p.Sk);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: 8 accumulator tiles of 16 x 8.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t kf[4];
        int row = np * 16 + (lane / 16) * 8 + lane % 8;
        int col = ks * 16 + ((lane / 8) % 2) * 8;
        ldmatrix_x4(kf, s_qk + row * kPitch + col);
        mma_16816(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_16816(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, mask, online softmax (rows g and g + 8 of the warp's slice)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + warp * 16 + g + 8 * r;
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = kv0 + nt * 8 + 2 * t + e;
          float x = s[nt][2 * r + e] * p.scale;
          if (masked(p, qi, kj)) x = kNegInf;
          s[nt][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = fmaxf(m_new, kNegInf / 2);
      const float corr = expf(m[r] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = expf(s[nt][2 * r + e] - m_safe);
          s[nt][2 * r + e] = pr;
          sum += pr;
        }
      }
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * r] *= corr;
        acc[dt][2 * r + 1] *= corr;
      }
    }

    // O += P V: P (cast to bf16) is reused from the accumulator registers as
    // the A operand; V tiles come transposed out of shared memory.
    mma_acc_b<D, kBlockN, kPitch>(acc, s, s_v, lane);
    __syncthreads();  // the next tile overwrites s_qk and s_v
  }

  auto* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float lc = fmaxf(sum, 1e-30f);
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi < p.Sq) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(ob + qi * p.o_ss + dt * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[dt][2 * r] / lc, acc[dt][2 * r + 1] / lc);
      }
      if (t == 0) p.lse[static_cast<int64_t>(bh) * p.Sq + qi] = m[r] + logf(lc);
    }
  }
}

// ------------------------------------------------------------------------
// f32: plain FMA, four threads per q row
// ------------------------------------------------------------------------

constexpr int kF32BlockM = 32;  // q rows per CTA
constexpr int kF32BlockN = 32;  // kv rows per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const Params p) {
  constexpr int kVec = D / 16;  // float4s per thread: dims 16 i + 4 part
  __shared__ __align__(16) float s_k[kF32BlockN * D];
  __shared__ __align__(16) float s_v[kF32BlockN * D];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32BlockM;
  const int part = threadIdx.x % 4;
  const int qi = q0 + threadIdx.x / 4;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  float4 q[kVec], acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    q[i] = qi < p.Sq ? *reinterpret_cast<const float4*>(
                           qb + qi * p.q_ss + 16 * i + 4 * part)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  const int n_tiles = kv_tiles(p, q0, kF32BlockM, kF32BlockN);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kF32BlockN;
    load_tile<float, kF32BlockN, D, D, kThreads>(s_k, kb, p.k_ss, kv0, p.Sk);
    load_tile<float, kF32BlockN, D, D, kThreads>(s_v, vb, p.v_ss, kv0, p.Sk);
    cp_async_wait_all();
    __syncthreads();

    float s[kF32BlockN];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kF32BlockN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(s_k + j * D + 16 * i + 4 * part);
        dot = fmaf(q[i].x, kv.x, dot);
        dot = fmaf(q[i].y, kv.y, dot);
        dot = fmaf(q[i].z, kv.z, dot);
        dot = fmaf(q[i].w, kv.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      float x = dot * p.scale;
      if (masked(p, qi, kv0 + j)) x = kNegInf;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, mx);
    const float m_safe = fmaxf(m_new, kNegInf / 2);
    const float corr = expf(m - m_safe);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kF32BlockN; ++j) {
      s[j] = expf(s[j] - m_safe);
      sum += s[j];
    }
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kF32BlockN; ++j) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 vv =
            *reinterpret_cast<const float4*>(s_v + j * D + 16 * i + 4 * part);
        acc[i].x = fmaf(s[j], vv.x, acc[i].x);
        acc[i].y = fmaf(s[j], vv.y, acc[i].y);
        acc[i].z = fmaf(s[j], vv.z, acc[i].z);
        acc[i].w = fmaf(s[j], vv.w, acc[i].w);
      }
    }
    __syncthreads();
  }

  if (qi < p.Sq) {
    const float lc = fmaxf(l, 1e-30f);
    float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      *reinterpret_cast<float4*>(ob + qi * p.o_ss + 16 * i + 4 * part) =
          make_float4(acc[i].x / lc, acc[i].y / lc, acc[i].z / lc,
                      acc[i].w / lc);
    }
    if (part == 0) p.lse[static_cast<int64_t>(bh) * p.Sq + qi] = m + logf(lc);
  }
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns cudaGetLastError() after the
// launch (0 on success) or one of the negative codes above.
int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, int device, int B, int H, int KVH, int Sq,
                  int Sk, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                  int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                  int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                  int64_t o_sh, float scale, int causal, int dtype,
                  void* stream) {
  const Params p{q,    k,    v,    o,    lse,  B,    H,    KVH,  Sq,
                 Sk,   q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                 v_sh, o_sb, o_ss, o_sh, scale, causal};
  if (B * H > 65535) return kErrGridTooLarge;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
    if (D == 64) {
      flash_fwd_bf16_kernel<64><<<grid, kThreads, 0, st>>>(p);
    } else if (D == 128) {
      flash_fwd_bf16_kernel<128><<<grid, kThreads, 0, st>>>(p);
    } else {
      return kErrBadHeadDim;
    }
  } else if (dtype == 0) {
    dim3 grid((Sq + kF32BlockM - 1) / kF32BlockM, B * H);
    if (D == 64) {
      flash_fwd_f32_kernel<64><<<grid, kThreads, 0, st>>>(p);
    } else if (D == 128) {
      flash_fwd_f32_kernel<128><<<grid, kThreads, 0, st>>>(p);
    } else {
      return kErrBadHeadDim;
    }
  } else {
    return kErrBadDtype;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rtt_error_string(int code) {
  switch (code) {
    case kErrBadDtype:
      return "dtype must be float32 or bfloat16";
    case kErrBadHeadDim:
      return "head_dim must be 64 or 128";
    case kErrGridTooLarge:
      return "batch * heads exceeds 65535";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
