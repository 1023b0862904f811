// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded with ctypes):
// device pointers and the CUDA stream arrive as void*, every entry point
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sis {

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Grid size for a grid-stride loop over n elements: enough blocks to fill
// the 132 SMs several times over, never more than the work needs.
inline unsigned int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

}  // namespace sis
