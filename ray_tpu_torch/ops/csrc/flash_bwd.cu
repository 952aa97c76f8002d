// FlashAttention-2 backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ray_tpu_torch/ops/_build.py).
//
// Replaces the two Pallas TPU kernels of ray_tpu/ops/flash.py launched by
// `_flash_bwd`: `_bwd_dkv_kernel` (dK, dV) and `_bwd_dq_kernel` (dQ), and the
// XLA reduction that computes Delta for them (`_flash_bwd`, flash.py:219).
// Same function:
//   Delta = rowsum(f32(dO) * f32(O))
//   P  = exp(scale * Q K^T (causal-masked, diagonal offset sk - sq) - LSE)
//   dV = P^T dO          (P rounded to dO's dtype)
//   dP = dO V^T
//   dS = P * (dP - Delta) * scale   (rounded to the input dtype)
//   dK = dS^T Q,  dQ = dS K
// every product with f32 accumulation, outputs in the input dtype. Under GQA
// the dK and dV of a kv head are the f32 sum over its query heads, rounded
// once (JAX gets the same sum from the transpose of jnp.repeat). The caller
// refuses Sq > Sk under the causal mask (rows that see no key).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the
// five products (Q K^T, dV, dP, dK, dQ) are 10 * D operations per visible
// (q, k) pair; at the training shape (bf16, B 8, S 2048, H 16, D 128,
// causal) 3.4e11 operations, 0.35 ms, against ~0.54 GB in and out, 0.16 ms:
// the tensor-core rate. Like the TPU, the backward is two kernels and no
// atomics, so Q K^T and dO V^T are computed in both: 14 * D per pair, and
// the pair can reach at most 10/14 of the whole backward's bound. It pays
// that for a dQ without atomics or an f32 workspace, and for bitwise
// repeatable gradients.
//
// Three kernels for bf16, built from the pieces of the forward (hopper.cuh,
// tma_host.cuh):
//
// - The Delta pass reads O and dO once, in their own dtype, with 16-byte
//   loads, and writes Delta and LSE * log2 e into [B * H, R] f32 rows, R = Sq
//   rounded up to 64 with zeros past Sq, so the dK/dV kernel can take a q
//   tile's 64 values by one bulk copy that never leaves its row. (A torch
//   reduction over f32 copies of O and dO moved ~0.8 GB at the training
//   shape for a 0.5 MB result.)
// - dK/dV: a CTA of 384 threads owns a 128-row kv tile of one batch * kv
//   head. Warpgroup 0 is the producer (setmaxnreg 24; one thread issues
//   TMA): K and V once, then the 64-row q tiles of Q and dO with their LSE
//   and Delta through a 3-stage ring (full barrier: transaction bytes;
//   empty barrier: the 256 consumer threads), head after head of the GQA
//   group (the ring's parity runs on across heads). Warpgroups 1 and 2
//   (setmaxnreg 240) each own 64 kv rows and keep dK and dV in registers
//   (64 + 64 f32 a thread at D 128). Per q tile:
//     S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, both operands K-major
//       from shared memory; dP^T is in flight while P^T = exp2(S^T * scale
//       * log2 e - LSE * log2 e) is computed;
//     dV += P^T dO and dK += dS^T Q: wgmma m64n{D}k16 with A from registers
//       (the m64n64 accumulator packed to bf16 already has the A fragment
//       layout, 16 q columns a k-step) and B MN-major (the transpose bit),
//       as the forward's P V;
//     the tile's dV/dK products are still on the tensor cores when the next
//       tile's S^T is issued; its stage is released once they are done.
//   The 64-wide q tile is what the registers allow: dK, dV, S^T, dP^T and
//   the two bf16 fragments take ~210 of the 240. Under the causal mask the
//   walk starts at the first q tile that reaches the diagonal. dK and dV go
//   out through the consumer's own rows of the K and V buffers and a TMA
//   store, which clips rows past Sk.
// - dQ: the forward's shape. A CTA owns a 128-row q tile of one batch *
//   head (Q and dO loaded once by TMA); 64-row K and V tiles stream through
//   a 3-stage ring, K and V released apart (V after dP, K after dQ). Per kv
//   tile and consumer: S = Q K^T and dP = dO V^T (m64n64k16 SS; V is
//   K-major here), P and dS in registers with the rows' LSE and Delta loaded
//   once, dQ += dS K (m64n{D}k16 RS, K MN-major). S, dP and dQ take 32 +
//   32 + 64 registers at D 128. Causal: the forward's limit on kv tiles.
//   dQ goes out through the consumer's rows of the Q buffer and a TMA
//   store.
// - Both kernels take one tile a CTA, on a 1-d grid in a fixed order:
//   heads in groups of eight and, within a group, the heaviest causal tile
//   of every head first. Eight heads' worth of CTAs fill the 132 SMs at S
//   2048, so the CTAs at work at one time share those heads' Q, dO (or K,
//   V) in L2, while the light tiles fill the last wave. (A 2-d grid of
//   (tiles, heads) dispatches a head's tiles together, so a heavy tile of
//   the last heads starts last. The order above, and a third ring stage
//   for dQ, were each faster on the card, side by side with the last
//   version.)
//
// Against the mma.sync kernels these replace: wgmma instead of mma.sync fed
// by ldmatrix; TMA loads a stage ahead of the products instead of cp.async
// and a barrier per tile; 384-thread CTAs over 128-row tiles instead of
// 128 threads over 64; the element mask only on tiles that the causal
// diagonal or a ragged tail cuts, exp2 with the scale folded into one FMA;
// and the Delta pass above.
//
// Ragged tails: TMA fills Q and dO rows past Sq and K and V rows past Sk
// with zeros, whose logit 0 is not a masked one, so on a cut tile q >= Sq
// and kv >= Sk are masked with the diagonal (exp2(-inf) = 0), and LSE and
// Delta past Sq are the Delta pass's zeros. The element mask on a cut tile
// keeps exp(-LSE) from meeting a zero-filled row as inf * 0.
//
// f32 inputs (the parity checks) run plain FMA kernels of the same
// structure: four threads per row, each owning a quarter of head_dim; they
// read LSE and Delta as [B, H, Sq].
//
// Layout: q, o, dO [B, Sq, H, D] and k, v [B, Sk, KVH, D], read through
// their strides (last dim contiguous, other strides multiples of 16 bytes,
// 16-byte aligned base); dq [B, Sq, H, D] and dk, dv [B, Sk, KVH, D]
// contiguous. Any Sq and Sk. head_dim 64 or 128.

#include "flash_common.cuh"
#include "hopper.cuh"
#include "tma_host.cuh"

namespace {

using namespace rtt;

enum : int {
  kErrBadDtype = -1,
  kErrBadHeadDim = -2,
  kErrGridTooLarge = -3,
  kErrBadStatRows = -6,
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

// First q tile that sees kv row kv0: under the causal mask, q row qi sees
// kv0 once qi + (sk - sq) >= kv0.
__device__ __forceinline__ int first_q_tile(int Sq, int Sk, int causal,
                                            int kv0, int block_m) {
  return causal ? max(0, kv0 - (Sk - Sq)) / block_m : 0;
}

__device__ __forceinline__ int first_q_tile(const Params& p, int kv0,
                                            int block_m) {
  return first_q_tile(p.Sq, p.Sk, p.causal, kv0, block_m);
}

__device__ __forceinline__ int64_t row_offset(int b, int s, int h, int S,
                                              int H, int D) {
  return ((static_cast<int64_t>(b) * S + s) * H + h) * D;
}

// ------------------------------------------------------------------------
// bf16: TMA ring, warp-specialised producer, wgmma
// ------------------------------------------------------------------------

constexpr int kThreads = 128;         // a warpgroup; the f32 kernels' CTA
constexpr int kWsThreads = 384;       // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 3;
constexpr int kWide = 128;    // rows a CTA owns (kv in dK/dV, q in dQ)
constexpr int kNarrow = 64;   // rows of a streamed tile (q in dK/dV, kv in dQ)
constexpr int kWideBlock = kWide * 128;      // bytes of a 64-column box
constexpr int kNarrowBlock = kNarrow * 128;
constexpr int kStatRows = 64;  // the Delta pass pads LSE and Delta rows to it
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kGroupHeads = 8;

// Which tile of which (batch * head) this CTA takes, from a 1-d grid of
// n_tiles x heads: heads in groups of kGroupHeads and, within a group, the
// heaviest tile (index 0) of every head first. The CTAs at work at one time
// share a few heads' tiles in L2, and the light tiles fill the last wave.
__device__ __forceinline__ void tile_order(int n_tiles, int heads, int& tile,
                                           int& head) {
  const int per_group = kGroupHeads * n_tiles;
  const int group = blockIdx.x / per_group;
  const int g_heads = min(kGroupHeads, heads - group * kGroupHeads);
  const int w = blockIdx.x - group * per_group;
  tile = w / g_heads;
  head = group * kGroupHeads + w % g_heads;
}

// bytes of dynamic shared memory: the owned tile's two operands (K and V,
// or Q and dO), the ring, for dK/dV the stages' LSE and Delta, the barriers,
// and room to align the start to the 1024-byte swizzle atom
template <int D>
constexpr int dkv_smem_bytes() {
  return 2 * kWide * D * 2 + kStages * 2 * kNarrow * D * 2 +
         kStages * 2 * kNarrow * 4 + 8 * (1 + 2 * kStages) + 1024;
}

template <int D>
constexpr int dq_smem_bytes() {
  return 2 * kWide * D * 2 + kStages * 2 * kNarrow * D * 2 +
         8 * (1 + 4 * kStages) + 1024;
}

// Packs a 64 x 64 accumulator, rounded to bf16, into the A fragments of four
// k-steps of 16 columns each (as the forward packs P).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&acc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// acc (64 x 64) = A B^T over D: A the consumer's 64 rows of a wide tile at
// `a` (D/64 column blocks of kWide rows), B a narrow tile at `b` (column
// blocks of kNarrow rows), both K-major; committed as one group.
template <int D>
__device__ __forceinline__ void products_abt(float (&acc)[32], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t col = (ks % 4) * 32;
    wgmma_m64n64k16_ss(
        acc, smem_desc_sw128(a + (ks / 4) * kWideBlock + col, 16, 1024),
        smem_desc_sw128(b + (ks / 4) * kNarrowBlock + col, 16, 1024), ks > 0);
  }
}

// acc (64 x D) += X B: X (64 x 64) as bf16 A fragments in registers, B the
// 64 x D narrow tile at `b`, MN-major (the transpose bit).
template <int D>
__device__ __forceinline__ void products_xb(float (&acc)[D / 2],
                                            const uint32_t (&x)[4][4],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc =
        smem_desc_sw128(b + kk * 16 * 128, kNarrowBlock, 1024);
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs_tb(acc, x[kk], desc);
    } else {
      wgmma_m64n64k16_rs_tb(acc, x[kk], desc);
    }
  }
}

// Writes a consumer's 64 x D accumulator, rounded to bf16, into its rows of
// a wide tile at `rows` in the swizzled layout of a 64-row TMA box.
template <int D>
__device__ __forceinline__ void stage_out(uint32_t rows,
                                          const float (&acc)[D / 2], int warp,
                                          int g, int t) {
#pragma unroll
  for (int p = 0; p < D / 8; ++p) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;  // of the consumer's 64
      const uint32_t addr = rows + (p / 8) * kWideBlock + row * 128 +
                            (((p % 8) ^ (row % 8)) * 16) + 4 * t;
      st_shared_u32(addr,
                    pack_bf16(acc[4 * p + 2 * r], acc[4 * p + 2 * r + 1]));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_dk,
                              const __grid_constant__ CUtensorMap tm_dv,
                              const float* __restrict__ lse2,
                              const float* __restrict__ delta, int H, int KVH,
                              int Sq, int Sk, int stat_rows, float scale,
                              int causal) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  constexpr int kWideBytes = kWide * D * 2;
  constexpr int kNarrowBytes = kNarrow * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = smem, s_v = smem + kWideBytes;
  auto s_q = [&](int s) {
    return smem + 2 * kWideBytes + 2 * s * kNarrowBytes;
  };
  auto s_do = [&](int s) { return s_q(s) + kNarrowBytes; };
  const uint32_t stats = smem + 2 * kWideBytes + 2 * kStages * kNarrowBytes;
  auto s_lse = [&](int s) { return stats + 2 * kNarrow * 4 * s; };
  auto s_delta = [&](int s) { return s_lse(s) + kNarrow * 4; };
  const uint32_t bars = stats + 2 * kNarrow * 4 * kStages;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int n_kv = (Sk + kWide - 1) / kWide;
  int tile, bk;
  tile_order(n_kv, gridDim.x / n_kv, tile, bk);
  const int b = bk / KVH, kvh = bk % KVH;
  const int group = H / KVH;
  const int kv0 = tile * kWide;  // kv tile 0 sees the most q tiles
  const int diag = Sk - Sq;
  const int n_q = (Sq + kNarrow - 1) / kNarrow;
  const int first = first_q_tile(Sq, Sk, causal, kv0, kNarrow);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < kThreads) {
    // ---- producer: one thread keeps the ring full -----------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_do);
      mbar_arrive_expect_tx(kv_full, 2 * kWideBytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load_4d(s_k + cb * kWideBlock, &tm_k, kv_full, 64 * cb, kvh, kv0,
                    b);
        tma_load_4d(s_v + cb * kWideBlock, &tm_v, kv_full, 64 * cb, kvh, kv0,
                    b);
      }
      // A stage's first use passes at once (the phase before 0 counts as
      // done); later uses wait for both consumers' release of it.
      int it = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int h = kvh * group + hh;
        const int64_t stat = (static_cast<int64_t>(b) * H + h) * stat_rows;
        for (int qt = first; qt < n_q; ++qt, ++it) {
          const int s = it % kStages;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full(s), 2 * kNarrowBytes + 2 * kNarrow * 4);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb) {
            tma_load_4d(s_q(s) + cb * kNarrowBlock, &tm_q, full(s), 64 * cb,
                        h, qt * kNarrow, b);
            tma_load_4d(s_do(s) + cb * kNarrowBlock, &tm_do, full(s), 64 * cb,
                        h, qt * kNarrow, b);
          }
          bulk_load(s_lse(s), lse2 + stat + qt * kNarrow, kNarrow * 4, full(s));
          bulk_load(s_delta(s), delta + stat + qt * kNarrow, kNarrow * 4,
                    full(s));
        }
      }
    }
  } else {
    // ---- consumers: 64 kv rows each -------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / kThreads - 1;
    const int tid = threadIdx.x % kThreads;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = kv0 + 64 * wg;       // this consumer's first kv row
    const int r0 = row0 + 16 * warp + g;  // this thread's rows r0, r0 + 8
    const uint32_t k_rows = s_k + 64 * wg * 128;
    const uint32_t v_rows = s_v + 64 * wg * 128;
    const float scale_log2 = scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    // element e of a 64 x 64 accumulator: kv row r0 + 8 ((e % 4) / 2), q
    // column q0 + 8 (e / 4) + 2 t + e % 2
    float st[32], dpt[32];          // S^T then P^T; dP^T then dS^T
    uint32_t pa[4][4], dsa[4][4];   // P^T and dS^T as bf16 A fragments
    mbar_wait(kv_full, 0);
    int it = 0;
    bool pending = false;  // the last tile's dV/dK products are in flight
    for (int hh = 0; hh < group; ++hh) {
      for (int qt = first; qt < n_q; ++qt, ++it) {
        const int s = it % kStages;
        const int q0 = qt * kNarrow;
        mbar_wait(full(s), (it / kStages) & 1);
        fence_regs(st);
        wgmma_fence();
        products_abt<D>(st, k_rows, s_q(s));  // S^T = K Q^T
        wgmma_commit();
        if (pending) {
          // the last tile's dV/dK are done: its stage and fragments are free
          wgmma_wait<1>();
          fence_regs(dk);
          fence_regs(dv);
          mbar_arrive(empty((it - 1) % kStages));
        }
        fence_regs(dpt);
        wgmma_fence();
        products_abt<D>(dpt, v_rows, s_do(s));  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // P^T = exp2(S^T scale log2 e - LSE log2 e), 0 where masked
        const bool cut = q0 + kNarrow > Sq || row0 + 64 > Sk ||
                         (causal && row0 + 63 > q0 + diag);
        if (cut) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int qi = q0 + 8 * (e / 4) + 2 * t + e % 2;
            const int kj = r0 + 8 * ((e % 4) / 2);
            if (qi >= Sq || kj >= Sk || (causal && kj > qi + diag))
              st[e] = -INFINITY;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = ld_shared_f2(s_lse(s) + 4 * (8 * j + 2 * t));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * j + i;
            st[e] = ex2(fmaf(st[e], scale_log2, -(i % 2 ? l.y : l.x)));
          }
        }
        pack_a(pa, st);

        // dS^T = P^T (dP^T - Delta) scale
        wgmma_wait<0>();
        fence_regs(dpt);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dl = ld_shared_f2(s_delta(s) + 4 * (8 * j + 2 * t));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * j + i;
            dpt[e] = st[e] * (dpt[e] - (i % 2 ? dl.y : dl.x)) * scale;
          }
        }
        pack_a(dsa, dpt);

        // dV += P^T dO, dK += dS^T Q, left in flight
        fence_regs(pa);
        fence_regs(dsa);
        fence_regs(dk);
        fence_regs(dv);
        wgmma_fence();
        products_xb<D>(dv, pa, s_do(s));
        products_xb<D>(dk, dsa, s_q(s));
        wgmma_commit();
        pending = true;
      }
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);

    // ---- epilogue: dK and dV through this consumer's K and V rows --------
    stage_out<D>(k_rows, dk, warp, g, t);
    stage_out<D>(v_rows, dv, warp, g, t);
    fence_proxy_async_smem();
    named_barrier_sync(1 + wg, kThreads);
    if (tid == 0) {
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_store_4d(&tm_dk, k_rows + cb * kWideBlock, 64 * cb, kvh, row0, b);
        tma_store_4d(&tm_dv, v_rows + cb * kWideBlock, 64 * cb, kvh, row0, b);
      }
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_dq,
                             const float* __restrict__ lse2,
                             const float* __restrict__ delta, int H, int KVH,
                             int Sq, int Sk, int stat_rows, float scale,
                             int causal) {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  constexpr int kWideBytes = kWide * D * 2;
  constexpr int kNarrowBytes = kNarrow * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_q = smem, s_do = smem + kWideBytes;
  auto s_k = [&](int s) {
    return smem + 2 * kWideBytes + 2 * s * kNarrowBytes;
  };
  auto s_v = [&](int s) { return s_k(s) + kNarrowBytes; };
  const uint32_t bars = smem + 2 * kWideBytes + 2 * kStages * kNarrowBytes;
  const uint32_t qdo_full = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  const int n_qt = (Sq + kWide - 1) / kWide;
  int tile, bh;
  tile_order(n_qt, gridDim.x / n_qt, tile, bh);
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = (n_qt - 1 - tile) * kWide;  // the last q tile is heaviest
  const int diag = Sk - Sq;
  const int n = kv_tiles(Sq, Sk, causal, q0, kWide, kNarrow);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
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
    // ---- producer --------------------------------------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(qdo_full, 2 * kWideBytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load_4d(s_q + cb * kWideBlock, &tm_q, qdo_full, 64 * cb, h, q0, b);
        tma_load_4d(s_do + cb * kWideBlock, &tm_do, qdo_full, 64 * cb, h, q0,
                    b);
      }
      // K is released after dQ += dS K, V after dP = dO V^T
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        mbar_wait(empty_k(s), parity);
        mbar_arrive_expect_tx(full_k(s), kNarrowBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(s_k(s) + cb * kNarrowBlock, &tm_k, full_k(s), 64 * cb,
                      kvh, i * kNarrow, b);
        mbar_wait(empty_v(s), parity);
        mbar_arrive_expect_tx(full_v(s), kNarrowBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_load_4d(s_v(s) + cb * kNarrowBlock, &tm_v, full_v(s), 64 * cb,
                      kvh, i * kNarrow, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each --------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / kThreads - 1;
    const int tid = threadIdx.x % kThreads;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * wg;        // this consumer's first q row
    const int r0 = row0 + 16 * warp + g;  // this thread's rows r0, r0 + 8
    const uint32_t q_rows = s_q + 64 * wg * 128;
    const uint32_t do_rows = s_do + 64 * wg * 128;
    const float scale_log2 = scale * kLog2e;

    float lse_r[2], delta_r[2];  // LSE log2 e and Delta of rows r0, r0 + 8
    const int64_t stat = static_cast<int64_t>(bh) * stat_rows;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + 8 * r;
      lse_r[r] = qi < Sq ? lse2[stat + qi] : 0.f;
      delta_r[r] = qi < Sq ? delta[stat + qi] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    // element e of a 64 x 64 accumulator: q row r0 + 8 ((e % 4) / 2), kv
    // column kv0 + 8 (e / 4) + 2 t + e % 2
    float sacc[32], dp[32];  // S then P; dP then dS
    uint32_t dsa[4][4];      // dS as bf16 A fragments
    mbar_wait(qdo_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      const int kv0 = i * kNarrow;
      mbar_wait(full_k(s), phase);
      fence_regs(sacc);
      wgmma_fence();
      products_abt<D>(sacc, q_rows, s_k(s));  // S = Q K^T
      wgmma_commit();
      mbar_wait(full_v(s), phase);
      fence_regs(dp);
      wgmma_fence();
      products_abt<D>(dp, do_rows, s_v(s));  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<1>();  // S, and the last tile's dQ products
      fence_regs(sacc);
      fence_regs(dq);
      if (i > 0) mbar_arrive(empty_k((i - 1) % kStages));

      // P = exp2(S scale log2 e - LSE log2 e), 0 where masked
      const bool cut = kv0 + kNarrow > Sk || row0 + 64 > Sq ||
                       (causal && kv0 + kNarrow - 1 > row0 + diag);
      if (cut) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int kj = kv0 + 8 * (e / 4) + 2 * t + e % 2;
          const int qi = r0 + 8 * ((e % 4) / 2);
          if (qi >= Sq || kj >= Sk || (causal && kj > qi + diag))
            sacc[e] = -INFINITY;
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sacc[e] = ex2(fmaf(sacc[e], scale_log2, -lse_r[(e % 4) / 2]));

      // dS = P (dP - Delta) scale
      wgmma_wait<0>();
      fence_regs(dp);
      mbar_arrive(empty_v(s));
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = sacc[e] * (dp[e] - delta_r[(e % 4) / 2]) * scale;
      pack_a(dsa, dp);

      // dQ += dS K, left in flight
      fence_regs(dsa);
      fence_regs(dq);
      wgmma_fence();
      products_xb<D>(dq, dsa, s_k(s));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dq);

    // ---- epilogue: dQ through this consumer's Q rows ---------------------
    stage_out<D>(q_rows, dq, warp, g, t);
    fence_proxy_async_smem();
    named_barrier_sync(1 + wg, kThreads);
    if (tid == 0) {
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_store_4d(&tm_dq, q_rows + cb * kWideBlock, 64 * cb, h, row0, b);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// ------------------------------------------------------------------------
// Delta: one pass over O and dO
// ------------------------------------------------------------------------

constexpr int kDeltaThreads = 256;

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    sum = fmaf(u.x, w.x, sum);
    sum = fmaf(u.y, w.y, sum);
  }
  return sum;
}

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b,
                                       const float*) {
  const float4 x = *reinterpret_cast<const float4*>(&a);
  const float4 y = *reinterpret_cast<const float4*>(&b);
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, x.x * y.x)));
}

// A CTA takes 64 rows s of one batch * head: Delta[s] = sum_d dO[s, d] O[s,
// d] in f32, and, where lse2 is given, lse2[s] = LSE[s] log2 e; both in rows
// of `stat_rows` (>= Sq) with zeros past Sq.
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ delta, float* __restrict__ lse2,
                           int H, int Sq, int stat_rows, int64_t o_sb,
                           int64_t o_ss, int64_t o_sh, int64_t do_sb,
                           int64_t do_ss, int64_t do_sh) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int kLanes = D / kPer;      // threads a row: 8, 16 or 32
  constexpr int kRows = kDeltaThreads / kLanes;
  static_assert(32 % kLanes == 0 && 64 % kRows == 0, "rows split evenly");
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int lane = threadIdx.x % kLanes;
  const T* ob = o + b * o_sb + h * o_sh + lane * kPer;
  const T* dob = dout + b * do_sb + h * do_sh + lane * kPer;
  const int64_t stat = static_cast<int64_t>(bh) * stat_rows;
#pragma unroll
  for (int r = threadIdx.x / kLanes; r < 64; r += kRows) {
    const int s = blockIdx.x * 64 + r;
    float sum = 0.f;
    if (s < Sq) {
      const uint4 x = *reinterpret_cast<const uint4*>(ob + s * o_ss);
      const uint4 y = *reinterpret_cast<const uint4*>(dob + s * do_ss);
      sum = dot16(x, y, ob);
    }
#pragma unroll
    for (int m = kLanes / 2; m > 0; m /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (lane == 0 && s < stat_rows) {
      delta[stat + s] = sum;
      if (lse2 != nullptr)
        lse2[stat + s] =
            s < Sq ? lse[static_cast<int64_t>(bh) * Sq + s] * kLog2e : 0.f;
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

template <int D>
int launch_dkv_bf16(const Params& p, int stat_rows, int device,
                    cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  const int64_t kv_ss = static_cast<int64_t>(p.KVH) * D;
  int err = make_map(&tq, p.q, D, p.H, p.Sq, p.B, p.q_sb, p.q_ss, p.q_sh,
                     kNarrow);
  if (err == 0)
    err = make_map(&tk, p.k, D, p.KVH, p.Sk, p.B, p.k_sb, p.k_ss, p.k_sh,
                   kWide);
  if (err == 0)
    err = make_map(&tv, p.v, D, p.KVH, p.Sk, p.B, p.v_sb, p.v_ss, p.v_sh,
                   kWide);
  if (err == 0)
    err = make_map(&tdo, p.dout, D, p.H, p.Sq, p.B, p.do_sb, p.do_ss,
                   p.do_sh, kNarrow);
  if (err == 0)
    err = make_map(&tdk, p.dk, D, p.KVH, p.Sk, p.B, p.Sk * kv_ss, kv_ss, D,
                   kNarrow);
  if (err == 0)
    err = make_map(&tdv, p.dv, D, p.KVH, p.Sk, p.B, p.Sk * kv_ss, kv_ss, D,
                   kNarrow);
  if (err != 0) return err;
  constexpr int smem = dkv_smem_bytes<D>();
  static uint64_t attribute_set = 0;
  err = allow_dynamic_smem(flash_bwd_dkv_bf16_kernel<D>, smem, device,
                           attribute_set);
  if (err != 0) return err;
  const int grid = (p.Sk + kWide - 1) / kWide * p.B * p.KVH;
  flash_bwd_dkv_bf16_kernel<D><<<grid, kWsThreads, smem, st>>>(
      tq, tk, tv, tdo, tdk, tdv, p.lse, p.delta, p.H, p.KVH, p.Sq, p.Sk,
      stat_rows, p.scale, p.causal);
  return 0;
}

template <int D>
int launch_dq_bf16(const Params& p, int stat_rows, int device,
                   cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  const int64_t q_ss = static_cast<int64_t>(p.H) * D;
  int err = make_map(&tq, p.q, D, p.H, p.Sq, p.B, p.q_sb, p.q_ss, p.q_sh,
                     kWide);
  if (err == 0)
    err = make_map(&tk, p.k, D, p.KVH, p.Sk, p.B, p.k_sb, p.k_ss, p.k_sh,
                   kNarrow);
  if (err == 0)
    err = make_map(&tv, p.v, D, p.KVH, p.Sk, p.B, p.v_sb, p.v_ss, p.v_sh,
                   kNarrow);
  if (err == 0)
    err = make_map(&tdo, p.dout, D, p.H, p.Sq, p.B, p.do_sb, p.do_ss,
                   p.do_sh, kWide);
  if (err == 0)
    err = make_map(&tdq, p.dq, D, p.H, p.Sq, p.B, p.Sq * q_ss, q_ss, D,
                   kNarrow);
  if (err != 0) return err;
  constexpr int smem = dq_smem_bytes<D>();
  static uint64_t attribute_set = 0;
  err = allow_dynamic_smem(flash_bwd_dq_bf16_kernel<D>, smem, device,
                           attribute_set);
  if (err != 0) return err;
  const int grid = (p.Sq + kWide - 1) / kWide * p.B * p.H;
  flash_bwd_dq_bf16_kernel<D><<<grid, kWsThreads, smem, st>>>(
      tq, tk, tv, tdo, tdq, p.lse, p.delta, p.H, p.KVH, p.Sq, p.Sk,
      stat_rows, p.scale, p.causal);
  return 0;
}

// which: 0 = dK/dV, 1 = dQ
int launch_bwd(int which, const Params& p, int D, int stat_rows, int dtype,
               int device, cudaStream_t st) {
  const int rows = which == 0 ? p.Sk : p.Sq;
  const int heads = which == 0 ? p.B * p.KVH : p.B * p.H;
  if (heads > 65535) return kErrGridTooLarge;
  if (dtype == 1) {
    if (stat_rows % kStatRows != 0 || stat_rows < p.Sq) return kErrBadStatRows;
    if (D == 64) {
      return which == 0 ? launch_dkv_bf16<64>(p, stat_rows, device, st)
                        : launch_dq_bf16<64>(p, stat_rows, device, st);
    }
    if (D == 128) {
      return which == 0 ? launch_dkv_bf16<128>(p, stat_rows, device, st)
                        : launch_dq_bf16<128>(p, stat_rows, device, st);
    }
    return kErrBadHeadDim;
  }
  if (dtype == 0) {
    if (stat_rows != p.Sq) return kErrBadStatRows;
    dim3 grid((rows + kF32Block - 1) / kF32Block, heads);
    if (D == 64) {
      if (which == 0)
        flash_bwd_dkv_f32_kernel<64><<<grid, kThreads, 0, st>>>(p);
      else
        flash_bwd_dq_f32_kernel<64><<<grid, kThreads, 0, st>>>(p);
      return 0;
    }
    if (D == 128) {
      if (which == 0)
        flash_bwd_dkv_f32_kernel<128><<<grid, kThreads, 0, st>>>(p);
      else
        flash_bwd_dq_f32_kernel<128><<<grid, kThreads, 0, st>>>(p);
      return 0;
    }
    return kErrBadHeadDim;
  }
  return kErrBadDtype;
}

template <typename T>
int launch_delta(const void* o, const void* dout, const float* lse,
                 float* delta, float* lse2, int B, int H, int Sq, int D,
                 int stat_rows, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 int64_t do_sb, int64_t do_ss, int64_t do_sh,
                 cudaStream_t st) {
  const dim3 grid((stat_rows + 63) / 64, B * H);
  const T* x = static_cast<const T*>(o);
  const T* y = static_cast<const T*>(dout);
  if (D == 64) {
    flash_bwd_delta_kernel<T, 64><<<grid, kDeltaThreads, 0, st>>>(
        x, y, lse, delta, lse2, H, Sq, stat_rows, o_sb, o_ss, o_sh, do_sb,
        do_ss, do_sh);
  } else if (D == 128) {
    flash_bwd_delta_kernel<T, 128><<<grid, kDeltaThreads, 0, st>>>(
        x, y, lse, delta, lse2, H, Sq, stat_rows, o_sb, o_ss, o_sh, do_sb,
        do_ss, do_sh);
  } else {
    return kErrBadHeadDim;
  }
  return 0;
}

}  // namespace

extern "C" {

// Launches one backward kernel on `stream` (which: 0 = dK/dV into dk and dv,
// 1 = dQ into dq); returns cudaGetLastError() after the launch (0 on
// success) or one of the negative codes above. Strides are in elements for
// q, k, v and dO ([batch, seq, head]); the outputs are contiguous. lse and
// delta are the Delta pass's rows of `stat_rows` floats per batch * head:
// for bf16, LSE * log2 e and Delta with stat_rows = Sq rounded up to 64; for
// f32, LSE and Delta with stat_rows = Sq.
int rtt_flash_bwd(int which, const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int device, int B, int H,
                  int KVH, int Sq, int Sk, int D, int stat_rows, int64_t q_sb,
                  int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                  int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                  int64_t do_sb, int64_t do_ss, int64_t do_sh, float scale,
                  int causal, int dtype, void* stream) {
  const Params p{q,     k,     v,     dout,  lse,   delta, dq,    dk,
                 dv,    B,     H,     KVH,   Sq,    Sk,    q_sb,  q_ss,
                 q_sh,  k_sb,  k_ss,  k_sh,  v_sb,  v_ss,  v_sh,  do_sb,
                 do_ss, do_sh, scale, causal};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = launch_bwd(which, p, D, stat_rows, dtype, device,
                           static_cast<cudaStream_t>(stream));
  return e != 0 ? e : static_cast<int>(cudaGetLastError());
}

// Launches the Delta pass on `stream`: Delta into `delta` and, when `lse2`
// is not null, LSE * log2 e into `lse2`, both rows of `stat_rows` floats
// per batch * head (zeros past Sq). o and dout [B, Sq, H, D] through their
// strides (in elements), lse [B, H, Sq] contiguous. Returns as
// rtt_flash_bwd.
int rtt_flash_bwd_delta(const void* o, const void* dout, const float* lse,
                        float* delta, float* lse2, int device, int B, int H,
                        int Sq, int D, int stat_rows, int64_t o_sb,
                        int64_t o_ss, int64_t o_sh, int64_t do_sb,
                        int64_t do_ss, int64_t do_sh, int dtype,
                        void* stream) {
  if (B * H > 65535) return kErrGridTooLarge;
  if (stat_rows < Sq) return kErrBadStatRows;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = dtype == 1 ? launch_delta<__nv_bfloat16>(
                           o, dout, lse, delta, lse2, B, H, Sq, D, stat_rows,
                           o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, st)
          : dtype == 0 ? launch_delta<float>(o, dout, lse, delta, lse2, B, H,
                                             Sq, D, stat_rows, o_sb, o_ss,
                                             o_sh, do_sb, do_ss, do_sh, st)
                       : kErrBadDtype;
  return e != 0 ? e : static_cast<int>(cudaGetLastError());
}

// What the bf16 kernel `which` (0 = dK/dV, 1 = dQ) for head_dim D was built
// with: registers a thread at launch (before setmaxnreg moves them between
// warpgroups), local memory a thread (spills), and the dynamic shared
// memory of a launch.
int rtt_flash_bwd_bf16_attributes(int which, int D, int* regs,
                                  int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaErrorInvalidValue;
  if (which == 0 && D == 64) {
    e = cudaFuncGetAttributes(&attr, flash_bwd_dkv_bf16_kernel<64>);
    *smem_bytes = dkv_smem_bytes<64>();
  } else if (which == 0 && D == 128) {
    e = cudaFuncGetAttributes(&attr, flash_bwd_dkv_bf16_kernel<128>);
    *smem_bytes = dkv_smem_bytes<128>();
  } else if (which == 1 && D == 64) {
    e = cudaFuncGetAttributes(&attr, flash_bwd_dq_bf16_kernel<64>);
    *smem_bytes = dq_smem_bytes<64>();
  } else if (which == 1 && D == 128) {
    e = cudaFuncGetAttributes(&attr, flash_bwd_dq_bf16_kernel<128>);
    *smem_bytes = dq_smem_bytes<128>();
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

const char* rtt_flash_bwd_error_string(int code) {
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
    case kErrBadStatRows:
      return "LSE and Delta rows must hold Sq rounded up to 64 (bf16) or Sq "
             "(f32) floats";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
