// Upsample StyledConv tail in one pass:
//   out[b,y,x,c] = act(blur4(x)[b,y,x,c] * demod[b,c] + noise[b,y,x] + bias[c]) * scale
// with blur4 the separable 4-tap FIR (per-axis taps, upfirdn pad (1, 1)) and
// act a LeakyReLU.
//
// Replaces the TPU kernel synthesis_in_style_tpu/ops/pallas/fused_blur.py
// (blur_demod_noise_bias_act -> _forward / _kernel). The TPU version takes a
// width-padded input because Mosaic cannot slice odd widths; this kernel
// takes the logical (B, 2h+1, 2h+1, C) transposed-conv output and pads with
// zeros that never leave shared memory.
//
// Bound on the H100: bytes. The input (B, 2h+1, 2h+1, C) is read once and
// the output (B, 2h, 2h, C) written once; 16 multiply-adds per output are
// far under the card's rate. The 4x4 taps touch every input pixel up to 16
// times, so the design keeps the re-reads out of device memory:
//   * a block owns `tile_x` output columns x one chunk of channels (16-byte
//     vectors, `vpp` per pixel) of one image, and walks down a strip of
//     `rows` output rows; a thread owns one (column, vector) and produces
//     one 16-byte output vector per row;
//   * each input row of the tile (tile_x + 3 pixels: the halo) is staged in
//     shared memory once, by 16-byte cp.async copies whose zero fill gives
//     the blur's virtual padding without branches in the arithmetic; a ring
//     of kStages rows keeps kStages - 1 rows in flight while the block works
//     on the current one, so device-memory traffic is about (tile_x + 3) /
//     tile_x x (rows + 3) / rows of one read of the input;
//   * the horizontal 4 taps read shared memory; the vertical 4-tap window
//     (three horizontally filtered rows) stays in registers;
//   * taps accumulate in float32 and the epilogue (demod, noise, bias,
//     LeakyReLU, gain) runs in registers, rounded once to the output type and
//     written as one 16-byte store per thread and row.
// An earlier design (one thread per (b, x, c) column of a 16-row strip, four
// scalar loads per output through L1/L2) took 0.927 ms at the 256^2 x 128
// float32 layer on an H100 80GB HBM3 at 700 W.
#include "common.cuh"

namespace {

constexpr int kStages = 4;  // input rows in the shared-memory ring
// Threads per block at most, and blocks an SM must hold at once: the bound
// caps registers at 64 a thread, so two blocks share an SM and keep twice
// the rows in flight (the bfloat16 kernel needs 89 registers uncapped and
// then runs one block per SM, ~25 % slower at the 256^2 layer).
constexpr int kMaxThreads = 512;
constexpr int kMinBlocksPerSM = 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned int dst = static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes <-> float32 values: 4 floats or 8 bfloat16s.
__device__ __forceinline__ void to_floats(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void to_floats(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 v = __bfloat1622float2(h[k]);
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 from_floats(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ uint4 from_floats(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSM) blur_tail_kernel(const T* __restrict__ x,
                                 const float* __restrict__ demod,
                                 const float* __restrict__ noise,
                                 int64_t noise_batch_stride,
                                 const float* __restrict__ bias,
                                 T* __restrict__ out, int h_in, int c, int tile_x,
                                 int vpp, int rows, float4 taps, float slope,
                                 float act_scale) {
  constexpr int N = 16 / sizeof(T);  // channels per 16-byte vector
  extern __shared__ uint4 ring[];    // kStages x (tile_x + 3) pixels x vpp vectors
  const int h_out = h_in - 1;
  const int c_vecs = c / N;
  const int chunks = (c_vecs + vpp - 1) / vpp;
  const int col_tiles = (h_out + tile_x - 1) / tile_x;
  const int strips = (h_out + rows - 1) / rows;

  int idx = blockIdx.x;
  const int chunk = idx % chunks;
  idx /= chunks;
  const int ct = idx % col_tiles;  // neighbouring blocks share halo columns in L2
  idx /= col_tiles;
  const int strip = idx % strips;
  const int b = idx / strips;

  const int col = threadIdx.x / vpp;
  const int v = threadIdx.x % vpp;
  const int cvec = chunk * vpp + v;
  const int x0 = ct * tile_x;
  const int xo = x0 + col;
  const bool active = xo < h_out && cvec < c_vecs;
  const int y0 = strip * rows;
  const int y1 = min(y0 + rows, h_out);
  const int n_in = y1 - y0 + 3;  // output rows y0..y1-1 read input rows y0-1..y1+1
  const int row_vecs = (tile_x + 3) * vpp;

  const uint4* src = reinterpret_cast<const uint4*>(x) + static_cast<int64_t>(b) * h_in * h_in * c_vecs;
  auto stage_row = [&](int k) {  // input row y0 - 1 + k into ring slot k % kStages
    const int yi = y0 - 1 + k;
    uint4* slot = ring + (k % kStages) * row_vecs;
    for (int e = threadIdx.x; e < row_vecs; e += blockDim.x) {
      const int px = e / vpp;
      const int gv = chunk * vpp + e % vpp;
      const int xi = x0 - 1 + px;
      const bool valid = yi >= 0 && yi < h_in && xi >= 0 && xi < h_in && gv < c_vecs;
      const uint4* p = valid ? src + (static_cast<int64_t>(yi) * h_in + xi) * c_vecs + gv : src;
      cp_async16(slot + e, p, valid);
    }
  };

  const float tap[4] = {taps.x, taps.y, taps.z, taps.w};
  float d[N], bs[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    d[j] = active ? demod[static_cast<int64_t>(b) * c + cvec * N + j] : 0.f;
    bs[j] = active ? bias[cvec * N + j] : 0.f;
  }
  const float* nz = noise + b * noise_batch_stride + xo;
  uint4* dst = reinterpret_cast<uint4*>(out) +
               (static_cast<int64_t>(b) * h_out * h_out + xo) * c_vecs + cvec;

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_in) stage_row(k);
    cp_async_commit();
  }
  float r0[N], r1[N], r2[N];  // horizontally filtered input rows yo-1, yo, yo+1
#pragma unroll
  for (int j = 0; j < N; ++j) r0[j] = r1[j] = r2[j] = 0.f;
  for (int k = 0; k < n_in; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of row k have landed
    __syncthreads();               // everyone's; and slot (k-1) % kStages is free
    if (k + kStages - 1 < n_in) stage_row(k + kStages - 1);
    cp_async_commit();

    const uint4* row = ring + (k % kStages) * row_vecs + col * vpp + v;
    float r3[N];
#pragma unroll
    for (int j = 0; j < N; ++j) r3[j] = 0.f;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {  // output x reads input columns x-1..x+2
      float f[N];
      to_floats(row[dx * vpp], f);
#pragma unroll
      for (int j = 0; j < N; ++j) r3[j] += tap[dx] * f[j];
    }
    if (k >= 3 && active) {
      const int yo = y0 + k - 3;
      const float n = nz[static_cast<int64_t>(yo) * h_out];
      float o[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float acc = tap[0] * r0[j] + tap[1] * r1[j] + tap[2] * r2[j] + tap[3] * r3[j];
        const float val = acc * d[j] + n + bs[j];
        o[j] = (val >= 0.f ? val : val * slope) * act_scale;
      }
      dst[static_cast<int64_t>(yo) * h_out * c_vecs] = from_floats(o);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      r0[j] = r1[j];
      r1[j] = r2[j];
      r2[j] = r3[j];
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// x: (B, h_in, h_in, C) NHWC, 16-byte aligned, C * sizeof(element) a multiple
// of 16; out: (B, h_in - 1, h_in - 1, C). The launch geometry comes from the
// wrapper: blocks of tile_x * vpp threads (tile_x output columns x vpp
// 16-byte channel vectors), each walking `rows` output rows.
// taps: the four per-axis taps already flipped (true convolution).
extern "C" int sis_blur_tail(const void* x, const void* demod,
                             const void* noise, long long noise_batch_stride,
                             const void* bias, void* out, int batch, int h_in,
                             int c, int dtype, float t0, float t1, float t2,
                             float t3, float slope, float act_scale, int tile_x,
                             int vpp, int rows, void* stream) {
  const int esize = dtype == sis::kFloat32 ? 4 : dtype == sis::kBFloat16 ? 2 : 0;
  if (esize == 0 || (c * esize) % 16 != 0 || tile_x < 1 || vpp < 1 || rows < 1 ||
      tile_x * vpp > kMaxThreads || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int h_out = h_in - 1;
  if (batch <= 0 || h_out <= 0 || c <= 0) return 0;
  const int c_vecs = c * esize / 16;
  const int64_t blocks = static_cast<int64_t>(batch) * ((h_out + rows - 1) / rows) *
                         ((h_out + tile_x - 1) / tile_x) * ((c_vecs + vpp - 1) / vpp);
  const size_t smem = static_cast<size_t>(kStages) * (tile_x + 3) * vpp * 16;
  if (blocks > 0x7fffffffLL || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4 taps = make_float4(t0, t1, t2, t3);
  const float* d = static_cast<const float*>(demod);
  const float* nz = static_cast<const float*>(noise);
  const float* bs = static_cast<const float*>(bias);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const int threads = tile_x * vpp;
  if (dtype == sis::kFloat32) {
    blur_tail_kernel<float><<<grid, threads, smem, s>>>(
        static_cast<const float*>(x), d, nz, noise_batch_stride, bs,
        static_cast<float*>(out), h_in, c, tile_x, vpp, rows, taps, slope, act_scale);
  } else {
    blur_tail_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), d, nz, noise_batch_stride, bs,
        static_cast<__nv_bfloat16*>(out), h_in, c, tile_x, vpp, rows, taps, slope,
        act_scale);
  }
  return static_cast<int>(cudaGetLastError());
}
