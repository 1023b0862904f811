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
// (plus a C-wide bias that stays in L1/L2); one add, one compare and two
// multiplies per element are far below the card's arithmetic rate. The
// design is a single grid-stride pass, one thread per element, with
// neighbouring threads on neighbouring addresses so loads and stores
// coalesce; the bias is indexed by `i % C` for any (..., C) tensor with C
// contiguous. Math is in float32 with one rounding to the output type.
//
// Backward bound: bytes too (read y and g, write dx; one compare and one
// multiply per element). The sign mask comes from the output y, compared in
// float32, as the TPU kernel does (y >= 0 iff x + b >= 0, since scale > 0),
// so no input is kept for it. It needs no bias and no `% C`: one grid-stride
// pass over the flat tensor.
#include "common.cuh"

namespace {

template <typename T>
__global__ void bias_act_fwd_kernel(const T* __restrict__ x,
                                    const T* __restrict__ bias,
                                    T* __restrict__ y, int64_t n, int c,
                                    float slope, float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float v = sis::to_float(x[i]);
    if (bias != nullptr) v += sis::to_float(bias[i % c]);
    v = (v >= 0.f ? v : v * slope) * scale;
    y[i] = sis::from_float<T>(v);
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

extern "C" int sis_bias_act_fwd(const void* x, const void* bias, void* y,
                                long long n, int c, int dtype, float slope,
                                float scale, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned int blocks = sis::grid_for(n, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sis::kFloat32) {
    bias_act_fwd_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(bias),
        static_cast<float*>(y), n, c, slope, scale);
  } else if (dtype == sis::kBFloat16) {
    bias_act_fwd_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(y), n, c, slope, scale);
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
