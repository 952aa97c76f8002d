// FlashAttention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ray_tpu_torch/ops/_build.py).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of ray_tpu/ops/flash.py:45
// (launched by `_flash_fwd`). Same function:
//   O   = softmax(scale * Q K^T + causal mask) V     (in the input dtype)
//   LSE = m + log(l)                                 ([B, H, Sq] f32)
// with the causal diagonal offset by sk - sq, masked logits at -1e30, the
// fully-masked-row guard m_safe = max(m, -1e30 / 2), l clamped at 1e-30, and
// P cast to V's dtype before P V with f32 accumulation.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): from a
// few hundred tokens up (S 2048: ~137 GFLOP of causal work against ~270 MB)
// the tensor-core rate; at the serving prompt (B 8, S 128) the bytes. The
// full tensor-core rate is reached only through wgmma fed from shared memory
// that stays full, so the bf16 kernel is built around that:
//
// - A persistent CTA of three warpgroups on each SM walks work tiles of
//   (batch * head, 128 q rows). Warpgroup 0 is the producer: after
//   setmaxnreg gives most of its registers away, one thread issues TMA
//   copies. Warpgroups 1 and 2 are consumers with 240 registers each; each
//   owns 64 of the q rows.
// - Q has two buffers, so the next tile's Q loads while this one runs. K
//   and V stream through a ring of kStages stages (one 128-row K tile and
//   one V tile each) with a full mbarrier per tile (TMA transaction bytes)
//   and empty mbarriers per tile (arrivals of the 256 consumer threads);
//   K is released after Q K^T and V after P V, so two stages keep a copy
//   one step ahead of the products. For D 128: 2 x 32 KB of Q and 2 x 64 KB
//   of K and V, 193 KB of dynamic shared memory.
// - Tensor maps (tma_host.cuh) are 4-d over (D, heads, S, B) with each
//   tensor's own byte strides, so BSHD views (a fused QKV projection, GQA's
//   kv heads) are read in place; a box is 64 columns (128 bytes) by 128 rows
//   with the 128-byte swizzle, and a D-128 tile is two boxes side by side.
// - S = Q K^T is wgmma m64n128k16 with both operands from shared-memory
//   descriptors (K-major) that describe the same swizzle. The online
//   softmax stays in registers in the exp2 domain (scale * log2 e folded
//   into one FFMA before ex2); the element mask runs only on tiles that the
//   causal diagonal or the Sk tail cuts.
// - O += P V is wgmma with P from registers (the f32 S accumulator packed to
//   bf16 pairs already has the layout of the A operand) and V from shared
//   memory as an MN-major operand (the transpose bit). A tile's softmax
//   runs while the last tile's P V is on the tensor cores.
// - The epilogue divides by l, writes O through the consumer's own part of
//   its Q buffer (swizzled) and a TMA store, which clips the rows past Sq,
//   and writes LSE in the natural-log domain: a row that saw no key gets
//   exactly -1e30, as the plain version.
// - Tiles wholly above the causal diagonal are never loaded. Work goes
//   head by head (L2 keeps a few heads' K and V); under the causal mask a
//   CTA takes a head's heaviest and lightest q tiles as one unit, so every
//   CTA gets the same work.
//
// Tried on the card and left out, each slower in the same run: ping-pong
// between the two consumers on named barriers, rescaling O between the two
// products of a step (with two or three K/V stages), and skipping O's
// rescale where no row's max moved (PERF.md).
//
// f32 inputs (the parity checks) run a plain FMA kernel: four threads per q
// row, each owning a quarter of head_dim, with cp.async tiles.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, KVH, D], o [B, Sq, H, D], each read
// through its strides (last dim contiguous, other strides multiples of 16
// bytes, 16-byte aligned base); GQA maps query head h to kv head
// h / (H / KVH). Any Sq and Sk: the ragged tails are masked (TMA fills rows
// past the end with zeros, whose logit 0 the mask replaces). head_dim 64
// or 128.

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tma_host.cuh"

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
__device__ __forceinline__ int kv_tiles(int Sq, int Sk, int causal, int q0,
                                        int block_m, int block_n) {
  int n = (Sk + block_n - 1) / block_n;
  if (causal) {
    int last = min(q0 + block_m, Sq) - 1 + (Sk - Sq);
    n = last < 0 ? 0 : min(n, last / block_n + 1);
  }
  return n;
}

__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int block_m,
                                        int block_n) {
  return kv_tiles(p.Sq, p.Sk, p.causal, q0, block_m, block_n);
}

__device__ __forceinline__ bool masked(const Params& p, int qi, int kj) {
  return kj >= p.Sk || (p.causal && qi + (p.Sk - p.Sq) < kj);
}

// ------------------------------------------------------------------------
// bf16: TMA ring, warp-specialised producer, wgmma
// ------------------------------------------------------------------------

constexpr int kThreads = 128;       // one warpgroup (and the f32 kernel's CTA)
constexpr int kWsThreads = 384;     // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kBlockM = 128;        // q rows per CTA, 64 per consumer
constexpr int kBlockN = 128;        // kv rows per tile
constexpr int kStages = 2;
constexpr int kColBlock = 128 * 128;  // bytes of one 64-column box, 128 rows
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// bytes of dynamic shared memory: two Q buffers, kStages x (K, V), the
// barriers, and room to align the start to the 1024-byte swizzle atom
template <int D>
constexpr int fwd_smem_bytes() {
  return (2 + 2 * kStages) * kBlockN * D * 2 + 8 * (4 + 4 * kStages) + 1024;
}

// O (64 x D) += P V for one 128-row V tile at `v` (kv rows x D, D/64 column
// blocks of 128 rows); P in registers, 16 kv columns a product.
template <int D>
__device__ __forceinline__ void pv_products(float (&o)[D / 2],
                                            const uint32_t (&pa)[8][4],
                                            uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t desc = smem_desc_sw128(v + kk * 16 * 128, kColBlock, 1024);
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs_tb(o, pa[kk], desc);
    } else {
      wgmma_m64n64k16_rs_tb(o, pa[kk], desc);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o,
                          float* __restrict__ lse, int BH, int H, int KVH,
                          int Sq, int Sk, float scale, int causal,
                          int paired) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  constexpr int kTileBytes = kBlockN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = smem + (2 + 2 * kStages) * kTileBytes;
  auto s_q = [&](int qb) { return smem + qb * kTileBytes; };
  auto s_k = [&](int s) { return smem + (2 + 2 * s) * kTileBytes; };
  auto s_v = [&](int s) { return smem + (3 + 2 * s) * kTileBytes; };
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (2 + qb); };
  auto full_k = [&](int s) { return bars + 8 * (4 + s); };
  auto full_v = [&](int s) { return bars + 8 * (4 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (4 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (4 + 3 * kStages + s); };

  // Work: 128-row q tiles of one batch * head, in bh-major order so that
  // the CTAs at work at one time share a few heads' K and V in L2; CTA c
  // takes units c, c + grid, ... A unit is one q tile, a head's heaviest
  // causal tile first, or, when `paired` (causal, and more q tiles than
  // CTAs), the p-th heaviest and the p-th lightest tile of a head, so that
  // every unit holds the same work and no CTA ends far behind the rest.
  const int n_q = (Sq + kBlockM - 1) / kBlockM;
  const int per_head = paired ? (n_q + 1) / 2 : n_q;
  const int n_units = BH * per_head;
  struct Work {
    int b, h, kvh, bh, q0, n_tiles;
  };
  auto unit_size = [&](int u) {
    return paired && 2 * (u % per_head) + 1 != n_q ? 2 : 1;
  };
  auto work = [&](int u, int k) {  // the k-th q tile of unit u
    Work x;
    const int p = u % per_head;
    x.bh = u / per_head;
    x.b = x.bh / H;
    x.h = x.bh % H;
    x.kvh = x.h / (H / KVH);
    x.q0 = (k == 1 ? p : n_q - 1 - p) * kBlockM;
    x.n_tiles = kv_tiles(Sq, Sk, causal, x.q0, kBlockM, kBlockN);
    return x;
  };

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 2);  // one thread of each consumer
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerThreads);
      mbar_init(empty_v(s), kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kThreads) {
    // ---- producer: one thread keeps the buffers full --------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      // A buffer's first use passes at once (the phase before 0 counts as
      // done); later uses wait for the consumers' release of its last
      // contents. Q (two buffers) is released after the epilogue that
      // reuses it for O, K after Q K^T, V after P V.
      int it = 0;  // position in the K/V ring over all of this CTA's tiles
      int round = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        for (int k = 0; k < unit_size(u); ++k, ++round) {
          const Work x = work(u, k);
          const int qb = round & 1;
          mbar_wait(q_empty(qb), ((round >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(q_full(qb), kTileBytes);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load_4d(s_q(qb) + cb * kColBlock, &tm_q, q_full(qb), 64 * cb,
                        x.h, x.q0, x.b);
          for (int i = 0; i < x.n_tiles; ++i, ++it) {
            const int s = it % kStages;
            const uint32_t parity = ((it / kStages) & 1) ^ 1;
            mbar_wait(empty_k(s), parity);
            mbar_arrive_expect_tx(full_k(s), kTileBytes);
#pragma unroll
            for (int cb = 0; cb < D / 64; ++cb)
              tma_load_4d(s_k(s) + cb * kColBlock, &tm_k, full_k(s), 64 * cb,
                          x.kvh, i * kBlockN, x.b);
            mbar_wait(empty_v(s), parity);
            mbar_arrive_expect_tx(full_v(s), kTileBytes);
#pragma unroll
            for (int cb = 0; cb < D / 64; ++cb)
              tma_load_4d(s_v(s) + cb * kColBlock, &tm_v, full_v(s), 64 * cb,
                          x.kvh, i * kBlockN, x.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each --------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / kThreads - 1;
    const int tid = threadIdx.x % kThreads;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // this thread's rows of the accumulators: r0 and r0 + 8 of the work
    // tile (wgmma's layout: warp w holds rows 16 w .. 16 w + 15)
    const int r0 = 64 * wg + 16 * warp + g;
    const int diag = Sk - Sq;
    const float scale_log2 = scale * 1.4426950408889634f;

    float o[D / 2];
    float m[2], l[2];           // running max of the raw logits; this
                                // thread's share of the row sums
    float sacc[kBlockN / 2];    // S of one kv tile, then its P
    uint32_t pa[kBlockN / 16][4] = {};  // P of the last kv tile, bf16
    float corr[2];              // the rows' correction factors for O
    int it = 0;                 // position in the K/V ring
    int round = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      for (int k = 0; k < unit_size(u); ++k, ++round) {
        const Work x = work(u, k);
        const int qb = round & 1;
        const int first_row = x.q0 + 64 * wg;
        const uint32_t q_rows = s_q(qb) + 64 * wg * 128;  // this consumer's
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;

        // S = Q K^T for ring position j (64 x 128), D / 16 products, left in
        // flight
        auto issue_qk = [&](int j) {
#pragma unroll
          for (int e = 0; e < kBlockN / 2; ++e) sacc[e] = 0.f;
          mbar_wait(full_k(j % kStages), (j / kStages) & 1);
          fence_regs(sacc);
          fence_regs(o);
          fence_regs(pa);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            const uint32_t off = (ks / 4) * kColBlock + (ks % 4) * 32;
            wgmma_m64n128k16_ss(
                sacc, smem_desc_sw128(q_rows + off, 16, 1024),
                smem_desc_sw128(s_k(j % kStages) + off, 16, 1024), ks > 0);
          }
          wgmma_commit();
        };
        // O += P V for ring position j, left in flight (the caller fences)
        auto issue_pv = [&](int j) {
          mbar_wait(full_v(j % kStages), (j / kStages) & 1);
          pv_products<D>(o, pa, s_v(j % kStages));
          wgmma_commit();
        };
        // the online softmax of kv tile i on sacc (S -> P, f32): updates m
        // and l and leaves the rows' correction factors for O in corr
        auto softmax = [&](int i) {
          const int kv0 = i * kBlockN;
          // element e of the accumulator: row r0 + 8 ((e % 4) / 2), column
          // kv0 + 8 (e / 4) + 2 t + e % 2
          const bool cut = kv0 + kBlockN > Sk ||
                           (causal && kv0 + kBlockN - 1 > first_row + diag);
          if (cut) {
#pragma unroll
            for (int e = 0; e < kBlockN / 2; ++e) {
              const int kj = kv0 + 8 * (e / 4) + 2 * t + e % 2;
              const int qi = x.q0 + r0 + 8 * ((e % 4) / 2);
              if (kj >= Sk || (causal && kj > qi + diag)) sacc[e] = -INFINITY;
            }
          }
          float mx[2] = {m[0], m[1]};
#pragma unroll
          for (int e = 0; e < kBlockN / 2; ++e)
            mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], sacc[e]);
          float base[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            // a row with no visible key yet keeps max -inf: exp2 of its
            // masked logits and of its (empty) history are both 0
            base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
            corr[r] = ex2(m[r] * scale_log2 - base[r]);
            m[r] = mx[r];
          }
          float rsum[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < kBlockN / 2; ++e) {
            const int r = (e % 4) / 2;
            sacc[e] = ex2(fmaf(sacc[e], scale_log2, -base[r]));
            rsum[r] += sacc[e];
          }
          l[0] = l[0] * corr[0] + rsum[0];
          l[1] = l[1] * corr[1] + rsum[1];
        };
        // P, rounded to bf16, as the A operand: 16 kv columns per product
        auto pack_p = [&]() {
#pragma unroll
          for (int kk = 0; kk < kBlockN / 16; ++kk) {
            pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
            pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
            pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
            pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
          }
        };

        // Kv tile i's softmax runs while tile i - 1's P V is on the tensor
        // cores: each step issues S_i = Q K_i^T and O += P_{i-1} V_{i-1},
        // waits for S_i alone (releasing K_i), computes P_i, then waits for
        // the product (releasing V_{i-1}) and rescales O.
        const int n = x.n_tiles;
        mbar_wait(q_full(qb), (round >> 1) & 1);
        if (n > 0) {
          issue_qk(it);
          wgmma_wait<0>();
          fence_regs(sacc);
          mbar_arrive(empty_k(it % kStages));
          softmax(0);  // O is still 0: no rescale
          pack_p();
        }
        for (int i = 1; i < n; ++i) {
          issue_qk(it + i);
          issue_pv(it + i - 1);
          wgmma_wait<1>();
          fence_regs(sacc);
          mbar_arrive(empty_k((it + i) % kStages));
          softmax(i);
          wgmma_wait<0>();
          fence_regs(o);
          mbar_arrive(empty_v((it + i - 1) % kStages));
#pragma unroll
          for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e % 4) / 2];
          pack_p();
        }
        if (n > 0) {
          fence_regs(o);
          fence_regs(pa);
          wgmma_fence();
          issue_pv(it + n - 1);
          wgmma_wait<0>();
          fence_regs(o);
          mbar_arrive(empty_v((it + n - 1) % kStages));
        }
        it += n;

        // ---- epilogue -----------------------------------------------------
        float lc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          lc[r] = fmaxf(l[r], 1e-30f);
        }
        // O into this consumer's 64 rows of the Q buffer (its own products
        // are done with them), in the swizzled layout of the O map's box
#pragma unroll
        for (int p = 0; p < D / 8; ++p) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 16 * warp + g + 8 * r;  // of this consumer's 64
            const uint32_t addr = q_rows + (p / 8) * kColBlock + row * 128 +
                                  (((p % 8) ^ (row % 8)) * 16) + 4 * t;
            st_shared_u32(addr, pack_bf16(o[4 * p + 2 * r] / lc[r],
                                          o[4 * p + 2 * r + 1] / lc[r]));
          }
        }
        fence_proxy_async_smem();
        named_barrier_sync(1 + wg, kThreads);
        if (tid == 0) {
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_store_4d(&tm_o, q_rows + cb * kColBlock, 64 * cb, x.h,
                         first_row, x.b);
          tma_store_commit();
          tma_store_wait_read();
          mbar_arrive(q_empty(qb));
        }
        if (t == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int qi = x.q0 + r0 + 8 * r;
            if (qi < Sq)
              lse[static_cast<int64_t>(x.bh) * Sq + qi] =
                  m[r] == -INFINITY ? kNegInf : m[r] * scale + logf(lc[r]);
          }
        }
      }
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

// ------------------------------------------------------------------------
// host: launch (tensor maps from tma_host.cuh)
// ------------------------------------------------------------------------

template <int D>
int launch_bf16(const Params& p, int device, cudaStream_t st) {
  CUtensorMap tq, tk, tv, to;
  int err = make_map(&tq, p.q, D, p.H, p.Sq, p.B, p.q_sb, p.q_ss, p.q_sh,
                     kBlockM);
  if (err == 0)
    err = make_map(&tk, p.k, D, p.KVH, p.Sk, p.B, p.k_sb, p.k_ss, p.k_sh,
                   kBlockN);
  if (err == 0)
    err = make_map(&tv, p.v, D, p.KVH, p.Sk, p.B, p.v_sb, p.v_ss, p.v_sh,
                   kBlockN);
  if (err == 0)
    err = make_map(&to, p.o, D, p.H, p.Sq, p.B, p.o_sb, p.o_ss, p.o_sh,
                   kBlockM / 2);
  if (err != 0) return err;
  constexpr int smem = fwd_smem_bytes<D>();
  static uint64_t attribute_set = 0;
  err = allow_dynamic_smem(flash_fwd_bf16_kernel<D>, smem, device,
                           attribute_set);
  if (err != 0) return err;
  // persistent: one CTA per SM (or per work tile, if fewer)
  static int sm_count[64] = {};
  int& sms = sm_count[device & 63];
  if (sms == 0) {
    cudaError_t e =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_q = (p.Sq + kBlockM - 1) / kBlockM;
  const int paired = p.causal && p.B * p.H * n_q > sms;
  const int n_units = p.B * p.H * (paired ? (n_q + 1) / 2 : n_q);
  flash_fwd_bf16_kernel<D><<<min(n_units, sms), kWsThreads, smem, st>>>(
      tq, tk, tv, to, p.lse, p.B * p.H, p.H, p.KVH, p.Sq, p.Sk, p.scale,
      p.causal, paired);
  return 0;
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
    int e = D == 64    ? launch_bf16<64>(p, device, st)
            : D == 128 ? launch_bf16<128>(p, device, st)
                       : kErrBadHeadDim;
    if (e != 0) return e;
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

// What the bf16 kernel for head_dim D was built with: registers a thread at
// launch (before setmaxnreg moves them between warpgroups), local memory a
// thread (spills), and the dynamic shared memory of a launch.
int rtt_flash_fwd_bf16_attributes(int D, int* regs, int* local_bytes,
                                  int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = D == 64    ? cudaFuncGetAttributes(&attr,
                                                     flash_fwd_bf16_kernel<64>)
                  : D == 128 ? cudaFuncGetAttributes(
                                   &attr, flash_fwd_bf16_kernel<128>)
                             : cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem_bytes = D == 64 ? fwd_smem_bytes<64>() : fwd_smem_bytes<128>();
  return 0;
}

const char* rtt_error_string(int code) {
  switch (code) {
    case kErrBadDtype:
      return "dtype must be float32 or bfloat16";
    case kErrBadHeadDim:
      return "head_dim must be 64 or 128";
    case kErrGridTooLarge:
      return "batch * heads exceeds 65535";
    case kErrNoTensorMapEncoder:
      return "the driver offers no cuTensorMapEncodeTiled";
    case kErrTensorMap:
      return "cuTensorMapEncodeTiled refused the tensor's shape or strides";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
