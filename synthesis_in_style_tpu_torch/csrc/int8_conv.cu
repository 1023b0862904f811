// int8 x int8 -> int32 convolution, NHWC activations, HWIO weights, as an
// implicit GEMM on the tensor cores (mma.sync m16n8k32 s8.s8.s32).
//
// Replaces no TPU kernel: the JAX package computes ops/quant.py `int8_conv`
// with lax.conv_general_dilated(preferred_element_type=int32), an XLA op.
// Eager PyTorch has no int8 convolution on CUDA; its only library route is
// torch._int_mm over an im2col, which materialises KH*KW times the input.
//
// GEMM view: M = B * OH * OW output pixels, N = O output channels,
// K = KH * KW * C. Row m of A is the receptive field of output pixel m,
// gathered tap by tap straight from x (zero outside the image, at the
// padding and at the zeros an lhs dilation inserts); B[k][n] is w read in its
// HWIO order. The K loop walks the taps and, inside a tap, the input
// channels in chunks of 32 (one mma depth).
//
// Block: 256 threads, a 128 x 64 output tile; eight warps of 32 x 32 each
// (two m16 by four n8 mma tiles, 32 int32 accumulators a thread). Both
// operand tiles are staged through registers into double-buffered shared
// memory: the next chunk's global loads are issued before this chunk's mmas.
// A sits in shared memory as [m][k] and B transposed as [n][k] (k contiguous,
// rows padded to 48 bytes), so every fragment is one 32-bit shared load and
// a warp's fragment loads hit 32 distinct banks.
//
// Bound on the H100: at the generator's shapes (C = O = 128 at 256 px) the
// int32 output it writes (4 bytes per output element) outweighs the
// operations: bytes. This first design is simple and exact; a wgmma version
// and a fused requantize epilogue (int8 out) are later work.
#include "common.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kRow = 48;  // bytes per shared-memory row: 32 + 16 of padding
constexpr int kThreads = 256;

struct ConvGeom {
  int batch, h, w, c;         // input
  int kh, kw, o;              // weight
  int oh, ow;                 // output
  int stride;
  int pad_top, pad_left;
  int lhs_dil, rhs_dil;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// This thread's share of one K chunk: 16 bytes of one A row, 8 bytes (8
// output channels at one k) of B.
struct Stage {
  int4 a;
  int2 b;
};

__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, ConvGeom g) {
  __shared__ __align__(16) int8_t As[2][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[2][kBN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t m_total = int64_t(g.batch) * g.oh * g.ow;
  const int64_t m0 = int64_t(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int chunks = (g.c + kBK - 1) / kBK;
  const int steps = g.kh * g.kw * chunks;
  const bool c_vec = (g.c % 16) == 0;
  const bool o_vec = (g.o % 8) == 0;

  // A loader: row a_row of the tile, bytes [a_half * 16, a_half * 16 + 16)
  // of each 32-channel chunk
  const int a_row = tid >> 1;
  const int a_half = (tid & 1) * 16;
  const int64_t a_m = m0 + a_row;
  const bool a_live = a_m < m_total;
  int a_b = 0, a_y0 = 0, a_x0 = 0;
  if (a_live) {
    const int64_t hw = int64_t(g.oh) * g.ow;
    a_b = int(a_m / hw);
    const int rem = int(a_m - int64_t(a_b) * hw);
    a_y0 = (rem / g.ow) * g.stride - g.pad_top;
    a_x0 = (rem % g.ow) * g.stride - g.pad_left;
  }
  // B loader: k row b_k of the chunk, output channels [b_n, b_n + 8); a
  // warp's 32 threads take the 32 k rows of one 8-channel group, so their
  // transposed byte stores land in 8 words of distinct banks
  const int b_k = tid & 31;
  const int b_n = (tid >> 5) * 8;

  auto load = [&](int step) {
    Stage s;
    s.a = make_int4(0, 0, 0, 0);
    s.b = make_int2(0, 0);
    const int tap = step / chunks;
    const int c0 = (step - tap * chunks) * kBK;
    const int ky = tap / g.kw;
    const int kx = tap - ky * g.kw;
    // A: input pixel of this tap in the lhs-dilated, padded input
    if (a_live) {
      const int yd = a_y0 + ky * g.rhs_dil;
      const int xd = a_x0 + kx * g.rhs_dil;
      if (yd >= 0 && xd >= 0 && yd % g.lhs_dil == 0 && xd % g.lhs_dil == 0) {
        const int y = yd / g.lhs_dil;
        const int xx = xd / g.lhs_dil;
        if (y < g.h && xx < g.w) {
          const int8_t* src = x + ((int64_t(a_b) * g.h + y) * g.w + xx) * g.c;
          const int c = c0 + a_half;
          if (c_vec) {
            if (c < g.c) s.a = *reinterpret_cast<const int4*>(src + c);
          } else {
            int8_t* dst = reinterpret_cast<int8_t*>(&s.a);
#pragma unroll
            for (int j = 0; j < 16; ++j) dst[j] = (c + j < g.c) ? src[c + j] : int8_t(0);
          }
        }
      }
    }
    // B: w[ky][kx][c0 + b_k][n0 + b_n ...]
    const int c = c0 + b_k;
    const int n = n0 + b_n;
    if (c < g.c && n < g.o) {
      const int8_t* src = w + ((int64_t(ky) * g.kw + kx) * g.c + c) * g.o + n;
      if (o_vec) {
        s.b = *reinterpret_cast<const int2*>(src);
      } else {
        int8_t* dst = reinterpret_cast<int8_t*>(&s.b);
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = (n + j < g.o) ? src[j] : int8_t(0);
      }
    }
    return s;
  };

  auto store = [&](const Stage& s, int buf) {
    *reinterpret_cast<int4*>(&As[buf][a_row * kRow + a_half]) = s.a;
    const int8_t* bb = reinterpret_cast<const int8_t*>(&s.b);
#pragma unroll
    for (int j = 0; j < 8; ++j) Bs[buf][(b_n + j) * kRow + b_k] = bb[j];
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int wm = (warp & 3) * 32;   // warp's rows in the tile
  const int wn = (warp >> 2) * 32;  // warp's columns in the tile
  const int grp = lane >> 2;
  const int tig = lane & 3;

  store(load(0), 0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    Stage next;
    const bool more = step + 1 < steps;
    if (more) next = load(step + 1);

    unsigned af[2][4];
    unsigned bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* base = &As[buf][(wm + i * 16 + grp) * kRow + tig * 4];
      af[i][0] = *reinterpret_cast<const unsigned*>(base);
      af[i][1] = *reinterpret_cast<const unsigned*>(base + 8 * kRow);
      af[i][2] = *reinterpret_cast<const unsigned*>(base + 16);
      af[i][3] = *reinterpret_cast<const unsigned*>(base + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* base = &Bs[buf][(wn + j * 8 + grp) * kRow + tig * 4];
      bf[j][0] = *reinterpret_cast<const unsigned*>(base);
      bf[j][1] = *reinterpret_cast<const unsigned*>(base + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);

    if (more) store(next, buf ^ 1);
    __syncthreads();
  }

  // epilogue: c0, c1 at (row grp, cols 2 tig, 2 tig + 1); c2, c3 at row grp + 8
  const bool o_even = (g.o % 2) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm + i * 16 + grp + half * 8;
      if (m >= m_total) continue;
      int32_t* row = out + m * g.o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + tig * 2;
        const int v0 = acc[i][j][half * 2];
        const int v1 = acc[i][j][half * 2 + 1];
        if (o_even && n + 1 < g.o) {
          *reinterpret_cast<int2*>(row + n) = make_int2(v0, v1);
        } else {
          if (n < g.o) row[n] = v0;
          if (n + 1 < g.o) row[n + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

extern "C" int sis_int8_conv(const void* x, const void* w, void* out, int batch, int h,
                             int w_in, int c, int kh, int kw, int o, int oh, int ow,
                             int stride, int pad_top, int pad_left, int lhs_dil,
                             int rhs_dil, void* stream) {
  ConvGeom g{batch, h, w_in, c, kh, kw, o, oh, ow, stride, pad_top, pad_left, lhs_dil, rhs_dil};
  const int64_t m_total = int64_t(batch) * oh * ow;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM),
                  static_cast<unsigned>((o + kBN - 1) / kBN));
  int8_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), g);
  return static_cast<int>(cudaGetLastError());
}
