// Host side of the port's Hopper kernels: bf16 TMA tensor maps over a BSHD
// tensor's own strides, encoded by the driver's cuTensorMapEncodeTiled and
// cached per host thread, and the dynamic shared memory limit of a kernel.
// Included by flash_fwd.cu and flash_bwd.cu.
//
// A map is 4-d over (D, heads, S, B) with the tensor's byte strides, so
// views (a fused QKV projection, GQA's kv heads) are read in place; its box
// is 64 columns (128 bytes) by `rows` rows of one head with the 128-byte
// swizzle that hopper.cuh's wgmma descriptors describe. The tensor must
// have its last dim contiguous, every other stride a multiple of 16 bytes
// and a 16-byte aligned base (the wrappers copy a tensor that has not).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

enum : int {
  kErrNoTensorMapEncoder = -4,
  kErrTensorMap = -5,
};

// cuTensorMapEncodeTiled is a driver-API function; it is fetched through the
// runtime, so the library links no libcuda of its own.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-d bf16 map over (D, heads, S, B) with the tensor's strides (in
// elements), and a box of 64 columns by `rows` rows of one head, swizzled by
// 128 bytes. Elements outside the tensor load as zeros and are not stored.
inline int encode_map(CUtensorMap* map, const void* ptr, int D, int heads,
                      int S, int B, int64_t sb, int64_t ss, int64_t sh,
                      int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoTensorMapEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, elem_strides,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// encode_map through a small cache: encoding costs microseconds of host
// time a map, while a map depends only on its arguments, and PyTorch's
// allocator hands the same addresses back call after call. One cache per
// host thread (ctypes calls run without the interpreter lock) and per
// library; 64 entries, as a backward call alone uses eleven maps.
inline int make_map(CUtensorMap* map, const void* ptr, int D, int heads,
                    int S, int B, int64_t sb, int64_t ss, int64_t sh,
                    int rows) {
  struct Entry {
    const void* ptr;
    int64_t key[8];
    CUtensorMap map;
  };
  static thread_local Entry cache[64] = {};  // indexed by 6 hash bits
  const int64_t key[8] = {D, heads, S, B, sb, ss, sh, rows};
  const uint64_t h = (reinterpret_cast<uintptr_t>(ptr) ^ rows) *
                     0x9E3779B97F4A7C15ull;  // Fibonacci hashing
  Entry& e = cache[h >> 58];
  bool hit = e.ptr == ptr;
  for (int i = 0; i < 8 && hit; ++i) hit = e.key[i] == key[i];
  if (!hit) {
    int err = encode_map(&e.map, ptr, D, heads, S, B, sb, ss, sh, rows);
    if (err != 0) {
      e.ptr = nullptr;
      return err;
    }
    e.ptr = ptr;
    for (int i = 0; i < 8; ++i) e.key[i] = key[i];
  }
  *map = e.map;
  return 0;
}

// Raises `kernel`'s dynamic shared memory limit to `bytes`, once per device:
// `mask` (a static of the caller, one per kernel) keeps a bit per device.
template <typename Kernel>
int allow_dynamic_smem(Kernel kernel, int bytes, int device, uint64_t& mask) {
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (mask & bit) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  mask |= bit;
  return 0;
}

}  // namespace rtt
