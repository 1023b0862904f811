// Fused bias + LeakyReLU + gain, forward:  y = leaky_relu(x + b[c], slope) * scale
//
// Replaces the TPU kernel synthesis_in_style_tpu/ops/pallas/fused_bias_act.py
// (fused_leaky_relu_pallas -> _forward / _fwd_kernel). The backward kernel
// (_bwd_kernel) is training-only and not ported yet.
//
// Bound on the H100: bytes. Each element is read once and written once
// (plus a C-wide bias that stays in L1/L2); one add, one compare and two
// multiplies per element are far below the card's arithmetic rate. The
// design is a single grid-stride pass, one thread per element, with
// neighbouring threads on neighbouring addresses so loads and stores
// coalesce; the bias is indexed by `i % C` for any (..., C) tensor with C
// contiguous. Math is in float32 with one rounding to the output type.
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
