// Fused bias + LeakyReLU + gain, forward and backward:
//   forward   y  = leaky_relu(x + b[c], slope) * scale
//   backward  dx = g * scale where y >= 0, else g * slope * scale
//
// Replaces the TPU kernels of synthesis_in_style_tpu/ops/pallas/fused_bias_act.py:
// fused_leaky_relu_pallas -> _forward / _fwd_kernel (forward) and
// _bwd_rule / _bwd_kernel (backward). The backward also serves the double
// backward: the derivative of dx with respect to g is the same mask, so the
// autograd Function applies this kernel again to the incoming gradient.
//
// Forward bound on the H100: bytes. Each element is read once and written once
// (plus a C-wide bias); one add, one compare and two multiplies per element
// are far below the card's arithmetic rate, so the kernel must spend few
// instructions per byte to stay on the memory's pace. The design views x as
// (R, C) rows:
//  * each thread owns one fixed 16-byte channel vector (8 bfloat16 or 4
//    float32 values) of a row, loads that vector's bias once into float32
//    registers, and walks rows with a fixed stride of `rows_per_step` rows:
//    the only division is the one 32-bit division that places the thread;
//    the loop does 64-bit adds and compares and no division or remainder;
//  * thread t of the grid starts at flat vector t, so neighbouring threads
//    move neighbouring 16 bytes and each step of the grid covers one
//    contiguous run of rows_per_step * C elements;
//  * loads and stores are 16 bytes wide with the streaming cache hint
//    (ld/st.global.cs: every byte is touched once), and each thread has
//    kFwdUnroll row vectors in flight before its first store;
//  * the geometry (vector width, threads, rows per step, grid) comes from the
//    Python wrapper (`bias_act_geometry` in ops/cuda/fused_bias_act.py). The
//    vector width is 1 where C x itemsize is not a multiple of 16 or a
//    pointer is not 16-byte aligned; the kernel then walks scalar columns
//    with the same 32-bit column math.
// Math is in float32 with one rounding to the output type.
//
// Backward bound: bytes too (read y and g, write dx; one compare and one
// multiply per element). The sign mask comes from the output y, compared in
// float32, as the TPU kernel does (y >= 0 iff x + b >= 0, since scale > 0),
// so no input is kept for it. It needs no bias and no `% C`: one grid-stride
// pass over the flat tensor.
#include "common.cuh"

namespace {

// Forward launch bounds and unroll: 512 threads a block, 4 row vectors in
// flight a thread, and (in the wrapper, TARGET_BLOCKS_PER_SM) a grid of 16
// blocks for each SM. Chosen by two sweeps on an H100
// (synthesis_in_style_tpu_torch/scripts/bias_act_sweep.py, which rebuilds
// this file with other values of the two macros) over 128-1024 threads x
// unroll 1-8 x 2-16 blocks per SM, with a device copy of the same bytes
// (`Tensor.copy_`) as the yardstick: at (16, 256, 256, 128) every geometry
// with 2-4 vectors in flight and at least one full wave of resident blocks
// ran within 1.15-1.26x the bytes bound, and this one was among the fastest
// in both sweeps, dtypes and large shapes, within 2-5 % of the copy. Grids
// of one wave (4 x 256 threads an SM; the bfloat16 build takes up to 62
// registers) were 2-4 % slower: with many blocks the block scheduler evens
// out SMs that finish early. One vector in flight needs 8 or more
// 256-thread blocks per SM to get there; unroll 8 at 1024 threads spills
// (64-register cap) and runs 5x slower. The sweep's numbers are in PERF.md.
#ifndef SIS_BIAS_ACT_THREADS
#define SIS_BIAS_ACT_THREADS 512
#endif
#ifndef SIS_BIAS_ACT_UNROLL
#define SIS_BIAS_ACT_UNROLL 4
#endif
constexpr int kFwdThreads = SIS_BIAS_ACT_THREADS;
constexpr int kFwdUnroll = SIS_BIAS_ACT_UNROLL;

// VEC consecutive values of T at p (16 bytes when VEC > 1, else one value),
// read and written with the streaming cache hint, as float32.
template <typename T, int VEC>
struct Pack;

template <>
struct Pack<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 r = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Pack<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) {
    v[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    __stcs(p, v[0]);
  }
};

// bfloat16 is the top half of a float32: widening is a shift, narrowing is
// one round-to-nearest-even conversion (as sis::from_float)
__device__ __forceinline__ unsigned int bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

template <>
struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __uint_as_float(
        static_cast<unsigned int>(__ldcs(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    __stcs(reinterpret_cast<unsigned short*>(p), static_cast<unsigned short>(bf16_bits(v[0])));
  }
};

// x, y: (rows, c) contiguous; thread t owns columns [col, col + VEC) with
// col = (t % (c / VEC)) * VEC and rows t / (c / VEC) + k * rows_per_step.
// Threads with t >= rows_per_step * (c / VEC) have no work.
template <typename T, int VEC, bool HAS_BIAS>
__global__ void __launch_bounds__(kFwdThreads)
bias_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                    T* __restrict__ y, long long rows, int c, int rows_per_step,
                    float slope, float scale) {
  const unsigned int c_vecs = static_cast<unsigned int>(c) / VEC;
  const unsigned int t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned int row0 = t / c_vecs;  // the kernel's one division
  if (row0 >= static_cast<unsigned int>(rows_per_step) || row0 >= rows) return;
  const int col = static_cast<int>(t - row0 * c_vecs) * VEC;

  float b[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) b[i] = HAS_BIAS ? sis::to_float(bias[col + i]) : 0.f;

  const long long n = rows * c;
  const long long step = static_cast<long long>(rows_per_step) * c;
  for (long long off = static_cast<long long>(row0) * c + col; off < n;
       off += kFwdUnroll * step) {
    float v[kFwdUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      if (off + u * step < n) Pack<T, VEC>::load(x + off + u * step, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      if (off + u * step < n) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float a = v[u][i];
          if (HAS_BIAS) a += b[i];
          v[u][i] = (a >= 0.f ? a : a * slope) * scale;
        }
        Pack<T, VEC>::store(y + off + u * step, v[u]);
      }
    }
  }
}

template <typename T, int VEC>
void launch_fwd(const void* x, const void* bias, void* y, long long rows, int c,
                int rows_per_step, int threads, int grid, float slope, float scale,
                cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* yt = static_cast<T*>(y);
  if (bias != nullptr) {
    bias_act_fwd_kernel<T, VEC, true><<<grid, threads, 0, s>>>(
        xt, bt, yt, rows, c, rows_per_step, slope, scale);
  } else {
    bias_act_fwd_kernel<T, VEC, false><<<grid, threads, 0, s>>>(
        xt, bt, yt, rows, c, rows_per_step, slope, scale);
  }
}

template <typename T>
__global__ void bias_act_bwd_kernel(const T* __restrict__ y,
                                    const T* __restrict__ g,
                                    T* __restrict__ dx, int64_t n,
                                    float neg_gain, float pos_gain) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gain = sis::to_float(y[i]) >= 0.f ? pos_gain : neg_gain;
    dx[i] = sis::from_float<T>(sis::to_float(g[i]) * gain);
  }
}

}  // namespace

// Geometry from the wrapper: `vec` values per thread (16 / itemsize, or 1),
// `threads` per block (<= kFwdThreads), `rows_per_step` rows walked by the
// grid per step, `grid` blocks of which at least rows_per_step * c / vec
// threads are live. x and y must be 16-byte aligned when vec > 1.
extern "C" int sis_bias_act_fwd(const void* x, const void* bias, void* y,
                                long long n, int c, int dtype, float slope,
                                float scale, int vec, int threads,
                                int rows_per_step, int grid, void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || n % c != 0 || vec <= 0 || c % vec != 0 || threads <= 0 ||
      threads > kFwdThreads || rows_per_step <= 0 || grid <= 0 ||
      static_cast<long long>(grid) * threads <
          static_cast<long long>(rows_per_step) * (c / vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = n / c;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sis::kFloat32 && vec == 4) {
    launch_fwd<float, 4>(x, bias, y, rows, c, rows_per_step, threads, grid, slope, scale, s);
  } else if (dtype == sis::kFloat32 && vec == 1) {
    launch_fwd<float, 1>(x, bias, y, rows, c, rows_per_step, threads, grid, slope, scale, s);
  } else if (dtype == sis::kBFloat16 && vec == 8) {
    launch_fwd<__nv_bfloat16, 8>(x, bias, y, rows, c, rows_per_step, threads, grid, slope,
                                 scale, s);
  } else if (dtype == sis::kBFloat16 && vec == 1) {
    launch_fwd<__nv_bfloat16, 1>(x, bias, y, rows, c, rows_per_step, threads, grid, slope,
                                 scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sis_bias_act_bwd(const void* y, const void* g, void* dx,
                                long long n, int dtype, float slope,
                                float scale, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned int blocks = sis::grid_for(n, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the same gains as the TPU kernel: g * scale and g * (slope * scale)
  const float pos_gain = scale, neg_gain = slope * scale;
  if (dtype == sis::kFloat32) {
    bias_act_bwd_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(g),
        static_cast<float*>(dx), n, neg_gain, pos_gain);
  } else if (dtype == sis::kBFloat16) {
    bias_act_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), n, neg_gain, pos_gain);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
