// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async tile loads into shared memory, ldmatrix, and bf16
// mma.sync m16n8k16 with f32 accumulation.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4): an accumulator
// tile holds rows g (elements 0, 1) and g + 8 (elements 2, 3) at columns
// 2t and 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [row0, row0 + ROWS) of one head into shared memory (row pitch
// PITCH elements), 16 bytes a thread per step; rows past `rows` are zeroed.
template <typename T, int ROWS, int D, int PITCH, int THREADS>
__device__ __forceinline__ void load_tile(T* smem, const T* base,
                                          int64_t row_stride, int row0,
                                          int rows) {
  constexpr int kPer16 = 16 / sizeof(T);
  constexpr int kChunksPerRow = D / kPer16;
  constexpr int kChunks = ROWS * kChunksPerRow;
  static_assert(kChunks % THREADS == 0, "tile must split evenly");
#pragma unroll
  for (int i = 0; i < kChunks / THREADS; ++i) {
    int c = threadIdx.x + i * THREADS;
    int r = c / kChunksPerRow;
    int col = (c % kChunksPerRow) * kPer16;
    T* dst = smem + r * PITCH + col;
    if (row0 + r < rows) {
      cp_async16(dst, base + (row0 + r) * row_stride + col);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16 x 16 chunk (columns 16 kk .. 16 kk + 15) of a
// 16-row accumulator, rounded to bf16: accumulator tiles 2 kk and 2 kk + 1
// become the A operand of the next product without leaving registers.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         float (&acc)[N][4], int kk) {
  a[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// acc (16 rows x 8 N) += A (16 rows, warp's slice, from row-major shared
// memory at `a`, pitch P) times B^T, where B is N rows of row-major shared
// memory at `b` (pitch P): the product of two row-major tiles over their
// common last dimension D, e.g. S = Q K^T.
template <int D, int N, int P>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane % 16) * P + ks * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];
      int row = np * 16 + (lane / 16) * 8 + lane % 8;
      int col = ks * 16 + ((lane / 8) % 2) * 8;
      ldmatrix_x4(bf, b + row * P + col);
      mma_16816(acc[2 * np], af, bf[0], bf[1]);
      mma_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out (16 rows x D) += X (16 rows x K, in accumulator registers, rounded to
// bf16) times B, where B is K rows x D of row-major shared memory at `b`
// (pitch P), read transposed by ldmatrix: e.g. O += P V.
template <int D, int K, int P>
__device__ __forceinline__ void mma_acc_b(float (&out)[D / 8][4],
                                          float (&x)[K / 8][4],
                                          const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t xf[4];
    acc_to_a(xf, x, kk);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      int row = kk * 16 + ((lane / 8) % 2) * 8 + lane % 8;
      int col = dp * 16 + (lane / 16) * 8;
      ldmatrix_x4_trans(bf, b + row * P + col);
      mma_16816(out[2 * dp], xf, bf[0], bf[1]);
      mma_16816(out[2 * dp + 1], xf, bf[2], bf[3]);
    }
  }
}

}  // namespace rtt
