// FlashAttention-2 backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ray_tpu_torch/ops/_build.py).
//
// Replaces the two Pallas TPU kernels of ray_tpu/ops/flash.py launched by
// `_flash_bwd`: `_bwd_dkv_kernel` (dK, dV) and `_bwd_dq_kernel` (dQ). Same
// function, with Delta = rowsum(f32(dO) * f32(O)) computed by the caller:
//   P  = exp(scale * Q K^T (causal-masked to -1e30, diagonal offset sk - sq)
//            - LSE)
//   dV = P^T dO          (P rounded to dO's dtype)
//   dP = dO V^T
//   dS = P * (dP - Delta) * scale   (rounded to the input dtype)
//   dK = dS^T Q,  dQ = dS K
// every product with f32 accumulation, outputs in the input dtype. The caller
// refuses Sq > Sk under the causal mask (rows that see no key).
//
// Two kernels, as on the TPU, and no atomics:
//   - dK/dV: one CTA owns one (batch * kv head, 64-row kv tile), keeps its dK
//     and dV accumulators in registers and walks the q tiles itself, from the
//     first q tile that reaches the causal diagonal. Under GQA it also walks
//     the query heads of its kv head, so dK and dV of a kv head are the sum
//     over its query heads in f32, rounded once (JAX gets the same sum from
//     the transpose of jnp.repeat).
//   - dQ: one CTA owns one (batch * head, 64-row q tile) and walks the kv
//     tiles, as the forward does.
// The TPU carried these accumulators across a sequential grid axis in VMEM;
// CUDA blocks run in no order, so the loop lives inside the block.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// backward's five products (Q K^T recomputed, dV, dP, dK, dQ) are 10 * D
// operations per visible (q, k) pair. At the training shape (bf16, B 8,
// S 2048, H 16, D 128, causal) that is 3.4e11 operations, 0.35 ms, against
// ~0.54 GB of q, k, v, o, dO in and dq, dk, dv out, 0.16 ms: the tensor-core
// rate bounds it. The two-kernel design recomputes Q K^T and dP in both
// kernels, 14 * D operations per pair, so it can reach at most 10/14 of that
// bound. It pays that to keep dQ free of atomics and of a f32 workspace; a
// single kernel that accumulates dQ atomically is later work, as are wgmma,
// TMA and a multi-stage ring. This version stages tiles in shared memory with
// cp.async and multiplies with bf16 mma.sync; the dK/dV kernel computes
// S^T = K Q^T directly, so P^T and dS^T are born in the accumulator layout
// of the kv rows and feed dV and dK from registers, with no trip through
// shared memory.
//
// f32 inputs (the parity checks) run plain FMA kernels of the same
// structure: four threads per row, each owning a quarter of head_dim.
//
// Layout: q, o, dO [B, Sq, H, D] and k, v [B, Sk, KVH, D], read through
// their strides (last dim contiguous, other strides multiples of 16 bytes);
// LSE and Delta [B, H, Sq] f32 contiguous; dq [B, Sq, H, D] and dk, dv
// [B, Sk, KVH, D] contiguous. Any Sq and Sk: ragged tails are zero-filled and
// masked. head_dim 64 or 128.

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
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, KVH, Sq, Sk;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  float scale;
  int causal;
};

// Element (qi, kj) takes no part: a ragged tail or above the causal diagonal.
__device__ __forceinline__ bool masked(const Params& p, int qi, int kj) {
  return qi >= p.Sq || kj >= p.Sk || (p.causal && qi + (p.Sk - p.Sq) < kj);
}

// Number of kv tiles a q tile must visit (as in the forward).
__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int block_m,
                                        int block_n) {
  int n = (p.Sk + block_n - 1) / block_n;
  if (p.causal) {
    int last = min(q0 + block_m, p.Sq) - 1 + (p.Sk - p.Sq);
    n = last < 0 ? 0 : min(n, last / block_n + 1);
  }
  return n;
}

// First q tile that sees kv row kv0: under the causal mask, q row qi sees
// kv0 once qi + (sk - sq) >= kv0.
__device__ __forceinline__ int first_q_tile(const Params& p, int kv0,
                                            int block_m) {
  return p.causal ? max(0, kv0 - (p.Sk - p.Sq)) / block_m : 0;
}

__device__ __forceinline__ int64_t row_offset(int b, int s, int h, int S,
                                              int H, int D) {
  return ((static_cast<int64_t>(b) * S + s) * H + h) * D;
}

// ------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ------------------------------------------------------------------------

constexpr int kBlockM = 64;  // q rows per tile
constexpr int kBlockN = 64;  // kv rows per tile
constexpr int kThreads = 128;

template <int D>
constexpr int bf16_smem_bytes() {
  // four 64-row tiles with a 16-byte pad per row, then 2 x 64 floats
  return 4 * 64 * (D + 8) * 2 + 2 * 64 * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16_kernel(const Params p) {
  constexpr int kPitch = D + 8;  // 16-byte pad: conflict-free ldmatrix rows
  extern __shared__ __align__(16) unsigned char smem[];
  auto* s_k = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* s_v = s_k + kBlockN * kPitch;
  auto* s_q = s_v + kBlockN * kPitch;
  auto* s_do = s_q + kBlockM * kPitch;
  auto* s_lse = reinterpret_cast<float*>(s_do + kBlockM * kPitch);
  auto* s_delta = s_lse + kBlockM;

  const int bk = blockIdx.y;
  const int b = bk / p.KVH, kvh = bk % p.KVH;
  const int group = p.H / p.KVH;
  const int kv0 = blockIdx.x * kBlockN;  // kv tile 0 has the most q tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const auto* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                   kvh * p.k_sh;
  const auto* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                   kvh * p.v_sh;
  load_tile<__nv_bfloat16, kBlockN, D, kPitch, kThreads>(s_k, kb, p.k_ss, kv0,
                                                         p.Sk);
  load_tile<__nv_bfloat16, kBlockN, D, kPitch, kThreads>(s_v, vb, p.v_ss, kv0,
                                                         p.Sk);
  cp_async_wait_all();
  __syncthreads();

  // Accumulators for the warp's 16 kv rows: rows g and g + 8 per thread.
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const __nv_bfloat16* k_warp = s_k + warp * 16 * kPitch;
  const __nv_bfloat16* v_warp = s_v + warp * 16 * kPitch;
  const int n_q = (p.Sq + kBlockM - 1) / kBlockM;
  const int first = first_q_tile(p, kv0, kBlockM);

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const auto* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                     h * p.q_sh;
    const auto* dob = static_cast<const __nv_bfloat16*>(p.dout) +
                      b * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    const float* delta = p.delta + (static_cast<int64_t>(b) * p.H + h) * p.Sq;

    for (int qt = first; qt < n_q; ++qt) {
      const int q0 = qt * kBlockM;
      load_tile<__nv_bfloat16, kBlockM, D, kPitch, kThreads>(s_q, qb, p.q_ss,
                                                             q0, p.Sq);
      load_tile<__nv_bfloat16, kBlockM, D, kPitch, kThreads>(s_do, dob,
                                                             p.do_ss, q0, p.Sq);
      if (threadIdx.x < kBlockM) {
        const int qi = q0 + threadIdx.x;
        s_lse[threadIdx.x] = qi < p.Sq ? lse[qi] : 0.f;
        s_delta[threadIdx.x] = qi < p.Sq ? delta[qi] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T = K Q^T: the warp's 16 kv rows against the tile's 64 q columns.
      float s[kBlockM / 8][4];
#pragma unroll
      for (int i = 0; i < kBlockM / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      mma_abt<D, kBlockM, kPitch>(s, k_warp, s_q, lane);

      // P^T = exp(scale S^T - LSE[q]), 0 where masked.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kj = kv0 + warp * 16 + g + 8 * r;
#pragma unroll
        for (int nt = 0; nt < kBlockM / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = nt * 8 + 2 * t + e;
            const float x = s[nt][2 * r + e] * p.scale;
            s[nt][2 * r + e] =
                masked(p, q0 + c, kj) ? 0.f : expf(x - s_lse[c]);
          }
        }
      }

      // dV += P^T dO, P^T rounded to bf16 from the accumulator registers.
      mma_acc_b<D, kBlockM, kPitch>(dv, s, s_do, lane);

      // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta[q]) scale in place.
      float ds[kBlockM / 8][4];
#pragma unroll
      for (int i = 0; i < kBlockM / 8; ++i) ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0.f;
      mma_abt<D, kBlockM, kPitch>(ds, v_warp, s_do, lane);
#pragma unroll
      for (int nt = 0; nt < kBlockM / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dlt = s_delta[nt * 8 + 2 * t + (i & 1)];
          ds[nt][i] = s[nt][i] * (ds[nt][i] - dlt) * p.scale;
        }
      }

      // dK += dS^T Q, dS^T rounded to bf16.
      mma_acc_b<D, kBlockM, kPitch>(dk, ds, s_q, lane);
      __syncthreads();  // the next tile overwrites s_q, s_do, s_lse, s_delta
    }
  }

  auto* dkb = static_cast<__nv_bfloat16*>(p.dk);
  auto* dvb = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kv0 + warp * 16 + g + 8 * r;
    if (kj < p.Sk) {
      const int64_t row = row_offset(b, kj, kvh, p.Sk, p.KVH, D);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + row + dt * 8 + 2 * t) =
            __floats2bfloat162_rn(dk[dt][2 * r], dk[dt][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + row + dt * 8 + 2 * t) =
            __floats2bfloat162_rn(dv[dt][2 * r], dv[dt][2 * r + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int kPitch = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* s_do = s_q + kBlockM * kPitch;
  auto* s_k = s_do + kBlockM * kPitch;
  auto* s_v = s_k + kBlockN * kPitch;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heavy tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const auto* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                   h * p.q_sh;
  const auto* dob = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb +
                    h * p.do_sh;
  const auto* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb +
                   kvh * p.k_sh;
  const auto* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb +
                   kvh * p.v_sh;
  load_tile<__nv_bfloat16, kBlockM, D, kPitch, kThreads>(s_q, qb, p.q_ss, q0,
                                                         p.Sq);
  load_tile<__nv_bfloat16, kBlockM, D, kPitch, kThreads>(s_do, dob, p.do_ss,
                                                         q0, p.Sq);
  cp_async_wait_all();
  __syncthreads();

  // LSE and Delta of the thread's two q rows.
  float lse[2], delta[2];
  const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    lse[r] = qi < p.Sq ? p.lse[stat + qi] : 0.f;
    delta[r] = qi < p.Sq ? p.delta[stat + qi] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  const __nv_bfloat16* q_warp = s_q + warp * 16 * kPitch;
  const __nv_bfloat16* do_warp = s_do + warp * 16 * kPitch;

  const int n_tiles = kv_tiles(p, q0, kBlockM, kBlockN);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kBlockN;
    load_tile<__nv_bfloat16, kBlockN, D, kPitch, kThreads>(s_k, kb, p.k_ss,
                                                           kv0, p.Sk);
    load_tile<__nv_bfloat16, kBlockN, D, kPitch, kThreads>(s_v, vb, p.v_ss,
                                                           kv0, p.Sk);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T, then P = exp(scale S - LSE), 0 where masked.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    mma_abt<D, kBlockN, kPitch>(s, q_warp, s_k, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + warp * 16 + g + 8 * r;
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = kv0 + nt * 8 + 2 * t + e;
          const float x = s[nt][2 * r + e] * p.scale;
          s[nt][2 * r + e] = masked(p, qi, kj) ? 0.f : expf(x - lse[r]);
        }
      }
    }

    // dP = dO V^T, then dS = P (dP - Delta) scale in place.
    float ds[kBlockN / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) ds[i][0] = ds[i][1] = ds[i][2] = ds[i][3] = 0.f;
    mma_abt<D, kBlockN, kPitch>(ds, do_warp, s_v, lane);
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ds[nt][i] = s[nt][i] * (ds[nt][i] - delta[i / 2]) * p.scale;
      }
    }

    // dQ += dS K, dS rounded to bf16; K read transposed.
    mma_acc_b<D, kBlockN, kPitch>(dq, ds, s_k, lane);
    __syncthreads();  // the next tile overwrites s_k and s_v
  }

  auto* dqb = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi < p.Sq) {
      const int64_t row = row_offset(b, qi, h, p.Sq, p.H, D);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<__nv_bfloat162*>(dqb + row + dt * 8 + 2 * t) =
            __floats2bfloat162_rn(dq[dt][2 * r], dq[dt][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------------
// f32: plain FMA, four threads per row, each owning a quarter of head_dim
// (float4s at dims 16 i + 4 part)
// ------------------------------------------------------------------------

constexpr int kF32Block = 32;  // rows per CTA and per tile

template <int D>
__device__ __forceinline__ float dot4(const float4 (&a)[D / 16],
                                      const float* row, int part) {
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + 16 * i + 4 * part);
    dot = fmaf(a[i].x, x.x, dot);
    dot = fmaf(a[i].y, x.y, dot);
    dot = fmaf(a[i].z, x.z, dot);
    dot = fmaf(a[i].w, x.w, dot);
  }
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  return dot;
}

template <int D>
__device__ __forceinline__ void axpy4(float4 (&acc)[D / 16], float a,
                                      const float* row, int part) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + 16 * i + 4 * part);
    acc[i].x = fmaf(a, x.x, acc[i].x);
    acc[i].y = fmaf(a, x.y, acc[i].y);
    acc[i].z = fmaf(a, x.z, acc[i].z);
    acc[i].w = fmaf(a, x.w, acc[i].w);
  }
}

template <int D>
__device__ __forceinline__ void load_row4(float4 (&x)[D / 16],
                                          const float* row, bool valid,
                                          int part) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    x[i] = valid ? *reinterpret_cast<const float4*>(row + 16 * i + 4 * part)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__device__ __forceinline__ void store_row4(float* row,
                                           const float4 (&x)[D / 16],
                                           int part) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    *reinterpret_cast<float4*>(row + 16 * i + 4 * part) = x[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const Params p) {
  constexpr int kVec = D / 16;
  __shared__ __align__(16) float s_q[kF32Block * D];
  __shared__ __align__(16) float s_do[kF32Block * D];
  __shared__ float s_lse[kF32Block];
  __shared__ float s_delta[kF32Block];

  const int bk = blockIdx.y;
  const int b = bk / p.KVH, kvh = bk % p.KVH;
  const int group = p.H / p.KVH;
  const int kv0 = blockIdx.x * kF32Block;
  const int part = threadIdx.x % 4;
  const int kj = kv0 + threadIdx.x / 4;

  float4 k[kVec], v[kVec], dk[kVec], dv[kVec];
  load_row4<D>(k, static_cast<const float*>(p.k) + b * p.k_sb +
                      kvh * p.k_sh + kj * p.k_ss, kj < p.Sk, part);
  load_row4<D>(v, static_cast<const float*>(p.v) + b * p.v_sb +
                      kvh * p.v_sh + kj * p.v_ss, kj < p.Sk, part);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    dk[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int n_q = (p.Sq + kF32Block - 1) / kF32Block;
  const int first = first_q_tile(p, kv0, kF32Block);

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dob = static_cast<const float*>(p.dout) + b * p.do_sb +
                       h * p.do_sh;
    const float* lse = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    const float* delta = p.delta + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    for (int qt = first; qt < n_q; ++qt) {
      const int q0 = qt * kF32Block;
      load_tile<float, kF32Block, D, D, kThreads>(s_q, qb, p.q_ss, q0, p.Sq);
      load_tile<float, kF32Block, D, D, kThreads>(s_do, dob, p.do_ss, q0,
                                                  p.Sq);
      if (threadIdx.x < kF32Block) {
        const int qi = q0 + threadIdx.x;
        s_lse[threadIdx.x] = qi < p.Sq ? lse[qi] : 0.f;
        s_delta[threadIdx.x] = qi < p.Sq ? delta[qi] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kF32Block; ++i) {
        const float s = dot4<D>(k, s_q + i * D, part) * p.scale;
        const float dp = dot4<D>(v, s_do + i * D, part);
        const float pr = masked(p, q0 + i, kj) ? 0.f : expf(s - s_lse[i]);
        const float ds = pr * (dp - s_delta[i]) * p.scale;
        axpy4<D>(dv, pr, s_do + i * D, part);
        axpy4<D>(dk, ds, s_q + i * D, part);
      }
      __syncthreads();
    }
  }
  if (kj < p.Sk) {
    const int64_t row = row_offset(b, kj, kvh, p.Sk, p.KVH, D);
    store_row4<D>(static_cast<float*>(p.dk) + row, dk, part);
    store_row4<D>(static_cast<float*>(p.dv) + row, dv, part);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const Params p) {
  constexpr int kVec = D / 16;
  __shared__ __align__(16) float s_k[kF32Block * D];
  __shared__ __align__(16) float s_v[kF32Block * D];

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32Block;
  const int part = threadIdx.x % 4;
  const int qi = q0 + threadIdx.x / 4;

  float4 q[kVec], dout[kVec], dq[kVec];
  load_row4<D>(q, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh +
                      qi * p.q_ss, qi < p.Sq, part);
  load_row4<D>(dout, static_cast<const float*>(p.dout) + b * p.do_sb +
                         h * p.do_sh + qi * p.do_ss, qi < p.Sq, part);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t stat = (static_cast<int64_t>(b) * p.H + h) * p.Sq + qi;
  const float lse = qi < p.Sq ? p.lse[stat] : 0.f;
  const float delta = qi < p.Sq ? p.delta[stat] : 0.f;

  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int n_tiles = kv_tiles(p, q0, kF32Block, kF32Block);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kv0 = tile * kF32Block;
    load_tile<float, kF32Block, D, D, kThreads>(s_k, kb, p.k_ss, kv0, p.Sk);
    load_tile<float, kF32Block, D, D, kThreads>(s_v, vb, p.v_ss, kv0, p.Sk);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kF32Block; ++j) {
      const float s = dot4<D>(q, s_k + j * D, part) * p.scale;
      const float dp = dot4<D>(dout, s_v + j * D, part);
      const float pr = masked(p, qi, kv0 + j) ? 0.f : expf(s - lse);
      const float ds = pr * (dp - delta) * p.scale;
      axpy4<D>(dq, ds, s_k + j * D, part);
    }
    __syncthreads();
  }
  if (qi < p.Sq) {
    store_row4<D>(static_cast<float*>(p.dq) + row_offset(b, qi, h, p.Sq, p.H,
                                                         D),
                  dq, part);
  }
}

// ------------------------------------------------------------------------
// launch
// ------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t st,
           const Params& p) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = dK/dV, 1 = dQ
int launch_bwd(int which, const Params& p, int D, int dtype,
               cudaStream_t st) {
  const int rows = which == 0 ? p.Sk : p.Sq;
  const int heads = which == 0 ? p.B * p.KVH : p.B * p.H;
  if (heads > 65535) return kErrGridTooLarge;
  if (dtype == 1) {
    dim3 grid((rows + 63) / 64, heads);
    if (D == 64) {
      return which == 0
                 ? launch(flash_bwd_dkv_bf16_kernel<64>, grid,
                          bf16_smem_bytes<64>(), st, p)
                 : launch(flash_bwd_dq_bf16_kernel<64>, grid,
                          bf16_smem_bytes<64>(), st, p);
    }
    if (D == 128) {
      return which == 0
                 ? launch(flash_bwd_dkv_bf16_kernel<128>, grid,
                          bf16_smem_bytes<128>(), st, p)
                 : launch(flash_bwd_dq_bf16_kernel<128>, grid,
                          bf16_smem_bytes<128>(), st, p);
    }
    return kErrBadHeadDim;
  }
  if (dtype == 0) {
    dim3 grid((rows + kF32Block - 1) / kF32Block, heads);
    if (D == 64) {
      return which == 0 ? launch(flash_bwd_dkv_f32_kernel<64>, grid, 0, st, p)
                        : launch(flash_bwd_dq_f32_kernel<64>, grid, 0, st, p);
    }
    if (D == 128) {
      return which == 0 ? launch(flash_bwd_dkv_f32_kernel<128>, grid, 0, st, p)
                        : launch(flash_bwd_dq_f32_kernel<128>, grid, 0, st, p);
    }
    return kErrBadHeadDim;
  }
  return kErrBadDtype;
}

}  // namespace

extern "C" {

// Launches one backward kernel on `stream` (which: 0 = dK/dV into dk and dv,
// 1 = dQ into dq); returns cudaGetLastError() after the launch (0 on
// success) or one of the negative codes above. Strides are in elements for
// q, k, v and dO ([batch, seq, head]); lse, delta and the outputs are
// contiguous.
int rtt_flash_bwd(int which, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int device, int B, int H,
                  int KVH, int Sq, int Sk, int D, int64_t q_sb, int64_t q_ss,
                  int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                  int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t do_sb,
                  int64_t do_ss, int64_t do_sh, float scale, int causal,
                  int dtype, void* stream) {
  const Params p{q,     k,     v,     dout,  lse,   delta, dq,    dk,
                 dv,    B,     H,     KVH,   Sq,    Sk,    q_sb,  q_ss,
                 q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,  do_sb,
                 do_ss, do_sh, scale, causal};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_bwd(which, p, D, dtype, static_cast<cudaStream_t>(stream));
}

const char* rtt_flash_bwd_error_string(int code) {
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
