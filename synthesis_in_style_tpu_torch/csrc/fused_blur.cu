// Upsample StyledConv tail in one pass:
//   out[b,y,x,c] = act(blur4(x)[b,y,x,c] * demod[b,c] + noise[b,y,x] + bias[c]) * scale
// with blur4 the separable 4-tap FIR (per-axis taps, upfirdn pad (1, 1)) and
// act a LeakyReLU.
//
// Replaces the TPU kernel synthesis_in_style_tpu/ops/pallas/fused_blur.py
// (blur_demod_noise_bias_act -> _forward / _kernel). The TPU version takes a
// width-padded input because Mosaic cannot slice odd widths; this kernel
// takes the logical (B, 2h+1, 2h+1, C) transposed-conv output and pads with
// virtual zeros instead.
//
// Bound on the H100: bytes. The input (B, 2h+1, 2h+1, C) is read once and
// the output (B, 2h, 2h, C) written once; 16 multiply-adds per output are
// well under the card's rate. The 4x4 taps touch every input pixel up to 16
// times, so the design keeps the re-reads out of device memory:
//   * one thread owns one (b, x, c) column of a strip of kStrip output rows,
//     channels fastest, so every load and store of a warp is one coalesced
//     row segment;
//   * per output row it loads the 4 horizontal taps of ONE new input row and
//     keeps the last four horizontally filtered rows in registers (a sliding
//     window), so the vertical taps cost no loads: 4 loads per output instead
//     of 16, the horizontal overlap between neighbouring x served by L1/L2;
//   * taps accumulate in float32 (vertical sum of horizontal 4-tap rows, like
//     the TPU kernel) and the epilogue runs in registers with one rounding to
//     the output type.
#include "common.cuh"

namespace {

constexpr int kStrip = 16;  // output rows per thread

template <typename T>
__device__ __forceinline__ float hfilt(const T* __restrict__ img, int yi, int xo,
                                       int h_in, int c, const float (&tap)[4]) {
  if (yi < 0 || yi >= h_in) return 0.f;  // virtual zero rows
  const T* row = img + static_cast<int64_t>(yi) * h_in * c;
  float r = 0.f;
#pragma unroll
  for (int dx = 0; dx < 4; ++dx) {
    const int xi = xo + dx - 1;  // pad 1 before: output x reads columns x-1..x+2
    if (xi >= 0 && xi < h_in) r += tap[dx] * sis::to_float(row[static_cast<int64_t>(xi) * c]);
  }
  return r;
}

template <typename T>
__global__ void blur_tail_kernel(const T* __restrict__ x,
                                 const float* __restrict__ demod,
                                 const float* __restrict__ noise,
                                 int64_t noise_batch_stride,
                                 const float* __restrict__ bias,
                                 T* __restrict__ out, int batch, int h_in,
                                 int c, float4 taps, float slope,
                                 float act_scale) {
  const int h_out = h_in - 1;
  const int strips = (h_out + kStrip - 1) / kStrip;
  const int64_t n = static_cast<int64_t>(batch) * strips * h_out * c;
  const float tap[4] = {taps.x, taps.y, taps.z, taps.w};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int ch = static_cast<int>(i % c);
    int64_t t = i / c;
    const int xo = static_cast<int>(t % h_out);
    t /= h_out;
    const int strip = static_cast<int>(t % strips);
    const int b = static_cast<int>(t / strips);

    const T* img = x + static_cast<int64_t>(b) * h_in * h_in * c + ch;
    const float d = demod[static_cast<int64_t>(b) * c + ch];
    const float bs = bias[ch];
    const float* nz = noise + b * noise_batch_stride + xo;
    T* o = out + (static_cast<int64_t>(b) * h_out * h_out + xo) * c + ch;

    const int y0 = strip * kStrip;
    const int y1 = min(y0 + kStrip, h_out);
    // output y reads input rows y-1..y+2 (pad 1 before)
    float r0 = hfilt(img, y0 - 1, xo, h_in, c, tap);
    float r1 = hfilt(img, y0, xo, h_in, c, tap);
    float r2 = hfilt(img, y0 + 1, xo, h_in, c, tap);
    for (int yo = y0; yo < y1; ++yo) {
      const float r3 = hfilt(img, yo + 2, xo, h_in, c, tap);
      const float acc = tap[0] * r0 + tap[1] * r1 + tap[2] * r2 + tap[3] * r3;
      float v = acc * d + nz[static_cast<int64_t>(yo) * h_out] + bs;
      v = (v >= 0.f ? v : v * slope) * act_scale;
      o[static_cast<int64_t>(yo) * h_out * c] = sis::from_float<T>(v);
      r0 = r1;
      r1 = r2;
      r2 = r3;
    }
  }
}

}  // namespace

// taps: the four per-axis taps already flipped (true convolution).
extern "C" int sis_blur_tail(const void* x, const void* demod,
                             const void* noise, long long noise_batch_stride,
                             const void* bias, void* out, int batch, int h_in,
                             int c, int dtype, float t0, float t1, float t2,
                             float t3, float slope, float act_scale,
                             void* stream) {
  const int h_out = h_in - 1;
  const int strips = (h_out + kStrip - 1) / kStrip;
  const int64_t n = static_cast<int64_t>(batch) * strips * h_out * c;
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned int blocks = sis::grid_for(n, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4 taps = make_float4(t0, t1, t2, t3);
  const float* d = static_cast<const float*>(demod);
  const float* nz = static_cast<const float*>(noise);
  const float* bs = static_cast<const float*>(bias);
  if (dtype == sis::kFloat32) {
    blur_tail_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), d, nz, noise_batch_stride, bs,
        static_cast<float*>(out), batch, h_in, c, taps, slope, act_scale);
  } else if (dtype == sis::kBFloat16) {
    blur_tail_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), d, nz, noise_batch_stride, bs,
        static_cast<__nv_bfloat16*>(out), batch, h_in, c, taps, slope,
        act_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
