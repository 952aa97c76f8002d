// Device helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async tile loads into shared memory for the f32 kernels,
// and the bf16 packing of f32 pairs.

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace rtt
