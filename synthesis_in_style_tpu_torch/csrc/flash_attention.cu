// Flash attention, forward and backward: non-causal softmax(q k^T * scale) v
// over (batch * heads, N, d) tensors, row-major and contiguous, in float32
// or bfloat16 (every product and sum in float32, outputs in the input type),
// head_dim d <= 128, any N. No N x N matrix ever reaches device memory.
//
// Replaces the TPU kernels the JAX package reaches from
// synthesis_in_style_tpu/models/trans_u_net.py (Attention.__call__,
// impl == "flash"): jax.experimental.pallas.ops.tpu.flash_attention's
// forward (`_flash_attention_impl`, pl.pallas_call at flash_attention.py:758
// of jax 0.9.0) and the two kernels of its custom VJP (`_flash_attention_
// bwd_dkv`, :1121, and `_flash_attention_bwd_dq`, :1456).
//
// Kernels, all on the caller's stream:
//   1. flash_fwd_kernel: one block per (batch * head, tile of 64 query rows).
//      It stages the query tile in shared memory, then loops over 64-row
//      K / V tiles staged there too, with an online softmax (running row
//      max and row sum, the accumulator rescaled as the max grows), and
//      writes O and the float32 logsumexp of each row (natural log).
//   2. flash_bwd_delta_kernel: D = rowsum(dO * O), one warp per row.
//   3. flash_bwd_dkdv_kernel: one block per (batch * head, tile of 64 key
//      rows), looping over the query tiles: P is recomputed from the saved
//      logsumexp, dV += P^T dO, dP = dO V^T, dS = P * (dP - D), dK += dS^T Q.
//   4. flash_bwd_dq_kernel: one block per (batch * head, query tile), looping
//      over the key tiles: P and dS again, dQ += dS K. A separate pass, so
//      dQ needs no atomics and every sum is taken in a fixed order (the
//      results are the same from run to run).
// Each block has 256 threads as 16 x 16; a thread owns a 4 x 4 patch of
// every 64 x 64 score tile (rows ty*4 .. ty*4+3, columns tx + 16 j) and 4
// rows x (DP / 16) columns of its accumulators, DP being d padded to 32, 64
// or 128 (a template argument). Row maxima and sums are 16-lane shuffles.
// Tiles are converted to float32 as they are staged; K and V are stored
// transposed where the product reads them along the key axis, with one
// float of padding a row so that neither the transposing stores nor the
// reads conflict in shared-memory banks.
//
// Bound on the H100 (SXM, 700 W) at the shipped TransUNet's shape
// (B, heads, N, d) = (8, 12, 1024, 64):
//   forward: 4 B h N^2 d = 25.8 GFLOP; q, k, v and o of 12.6 MB each in
//     bfloat16 (50 MB): 0.026 ms at 989 TFLOP/s (bfloat16 tensor cores),
//     0.385 ms at 67 TFLOP/s in float32 outside the tensor cores;
//   backward: ~10 B h N^2 d = ~64.4 GFLOP (recomputing P and the products
//     dP, dV, dK, dQ): 0.065 ms in bfloat16, 0.96 ms in float32.
// The work is the products: bound by operations, not bytes. This first
// design does them as float32 FMAs from shared memory (no tensor cores),
// so its ceiling is the float32 rate in both types, and the separate dQ
// pass recomputes S and dP (7 products in the backward where 5 would do).
// What it does about the bound: every score tile lives in registers and
// shared memory only, each K / V tile is read once per query tile (the
// minimum of the tiled scheme), and a thread's 4 x 4 patch reuses each
// operand it loads 4 times. Tensor cores (mma.sync, then wgmma with TMA)
// are the next step toward the bfloat16 bound.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLd = kTile + 1; // row stride of the transposed and score tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Rows [row0, row0 + 64) of a (n, d) matrix into dst (64 x DP, stride ld),
// as float32; rows past n and columns past d are zero.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int row0, int n,
                                          int d) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float v = 0.f;
    if (row0 + r < n && c < d) v = sis::to_float(src[static_cast<size_t>(row0 + r) * d + c]);
    dst[r * ld + c] = v;
  }
}

// The same rows transposed: dst[c * kLd + r].
template <typename T, int DP>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src, int row0, int n, int d) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float v = 0.f;
    if (row0 + r < n && c < d) v = sis::to_float(src[static_cast<size_t>(row0 + r) * d + c]);
    dst[c * kLd + r] = v;
  }
}

// acc[i][j] = sum_k a[(ty*4+i) * lda + k] * bt[k * kLd + tx + 16 j]: a
// thread's 4 x 4 patch of (64 x d) . (d x 64).
__device__ __forceinline__ void patch_product(float acc[4][4], const float* a, int lda,
                                              const float* bt, int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < d; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bt[k * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Reductions over the 16 lanes that share a row group (one half warp).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int DP>
constexpr int fwd_smem_floats() {
  // Q (64 x DP+1), K^T (DP x 65), V (64 x DP), P (64 x 65)
  return kTile * (DP + 1) + DP * kLd + kTile * DP + kTile * kLd;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int n, int d, float scale_log2) {
  constexpr int kCols = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* kt = qs + kTile * (DP + 1);
  float* vs = kt + DP * kLd;
  float* ps = vs + kTile * DP;
  const int bh = blockIdx.y, m0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<T, DP>(qs, DP + 1, q + base, m0, n, d);
  float m_i[4], l_i[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < n; n0 += kTile) {
    __syncthreads();  // the previous tile's K, V and P are read
    load_rows_t<T, DP>(kt, k + base, n0, n, d);
    load_rows<T, DP>(vs, DP, v + base, n0, n, d);
    __syncthreads();
    float s[4][4];
    patch_product(s, qs, DP + 1, kt, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (n0 + tx + 16 * j < n) ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds a key (n0 < n), so the new maximum is finite
      const float m_new = fmaxf(m_i[i], half_warp_max(mx));
      const float alpha = exp2f(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
      l_i[i] = l_i[i] * alpha + half_warp_sum(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kLd + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kLd + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= n) continue;
    const float inv = 1.f / l_i[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        o[base + static_cast<size_t>(row) * d + col] = sis::from_float<T>(acc[i][c] * inv);
      }
    }
    if (tx == 0) lse[static_cast<size_t>(bh) * n + row] = (m_i[i] + log2f(l_i[i])) * kLn2;
  }
}

// D[row] = sum_c dO[row, c] * O[row, c], one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int d) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) {
    const size_t at = static_cast<size_t>(row) * d + c;
    acc = fmaf(sis::to_float(dout[at]), sis::to_float(o[at]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// P (row-scaled) and dS = P * (dP - D) of one 64 x 64 tile pair in a
// thread's 4 x 4 patch: s enters as q.k, leaves as P; dp enters as dO.v,
// leaves as dS. lse2 and dl are the patch rows' logsumexp (log2 units) and D.
__device__ __forceinline__ void probs_and_ds(float s[4][4], float dp[4][4], const float lse2[4],
                                             const float dl[4], int n0, int n, int tx,
                                             float scale_log2) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = (n0 + tx + 16 * j < n) ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl[i]);
    }
}

template <int DP>
constexpr int dkdv_smem_floats() {
  // K^T, V^T (DP x 65 each), Q, dO (64 x DP+1 each), P, dS (64 x 65 each),
  // the query rows' logsumexp and D (64 each)
  return 2 * DP * kLd + 2 * kTile * (DP + 1) + 2 * kTile * kLd + 2 * kTile;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int n, int d,
                          float scale_log2, float sm_scale) {
  constexpr int kCols = DP / 16;
  extern __shared__ float smem[];
  float* kt = smem;
  float* vt = kt + DP * kLd;
  float* qs = vt + DP * kLd;
  float* dos = qs + kTile * (DP + 1);
  float* ps = dos + kTile * (DP + 1);
  float* dss = ps + kTile * kLd;
  float* lse_s = dss + kTile * kLd;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.y, n0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows_t<T, DP>(kt, k + base, n0, n, d);
  load_rows_t<T, DP>(vt, v + base, n0, n, d);
  // this block's key rows are ty*4+i; its accumulator columns tx + 16 c
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int m0 = 0; m0 < n; m0 += kTile) {
    __syncthreads();  // the previous query tile's Q, dO, P and dS are read
    load_rows<T, DP>(qs, DP + 1, q + base, m0, n, d);
    load_rows<T, DP>(dos, DP + 1, dout + base, m0, n, d);
    if (threadIdx.x < kTile) {
      const int row = m0 + threadIdx.x;
      // a row past n gets P = 0: logsumexp +inf
      lse_s[threadIdx.x] = row < n ? lse[static_cast<size_t>(bh) * n + row] * kLog2e : INFINITY;
      delta_s[threadIdx.x] = row < n ? delta[static_cast<size_t>(bh) * n + row] : 0.f;
    }
    __syncthreads();
    // the score patch: query rows ty*4+i, key columns tx + 16 j
    float s[4][4], dp[4][4], lse2[4], dl[4];
    patch_product(s, qs, DP + 1, kt, d, ty, tx);
    patch_product(dp, dos, DP + 1, vt, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lse2[i] = lse_s[ty * 4 + i];
      dl[i] = delta_s[ty * 4 + i];
    }
    probs_and_ds(s, dp, lse2, dl, n0, n, tx, scale_log2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty * 4 + i) * kLd + tx + 16 * j] = s[i][j];
        dss[(ty * 4 + i) * kLd + tx + 16 * j] = dp[i][j];
      }
    __syncthreads();
    // dV[key, :] += sum_r P[r, key] dO[r, :]; dK[key, :] += sum_r dS[r, key] Q[r, :]
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float p[4], g[4], dov[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ps[r * kLd + ty * 4 + i];
        g[i] = dss[r * kLd + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = dos[r * (DP + 1) + tx + 16 * c];
        qv[c] = qs[r * (DP + 1) + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[i][c] = fmaf(p[i], dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(g[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col >= d) continue;
      const size_t at = base + static_cast<size_t>(row) * d + col;
      dk[at] = sis::from_float<T>(dk_acc[i][c] * sm_scale);
      dv[at] = sis::from_float<T>(dv_acc[i][c]);
    }
  }
}

template <int DP>
constexpr int dq_smem_floats() {
  // Q, dO (64 x DP+1 each), K^T, V^T (DP x 65 each), dS (64 x 65)
  return 2 * kTile * (DP + 1) + 2 * DP * kLd + kTile * kLd;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int n, int d, float scale_log2, float sm_scale) {
  constexpr int kCols = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (DP + 1);
  float* kt = dos + kTile * (DP + 1);
  float* vt = kt + DP * kLd;
  float* dss = vt + DP * kLd;
  const int bh = blockIdx.y, m0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_rows<T, DP>(qs, DP + 1, q + base, m0, n, d);
  load_rows<T, DP>(dos, DP + 1, dout + base, m0, n, d);
  float lse2[4], dl[4], dq_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    lse2[i] = row < n ? lse[static_cast<size_t>(bh) * n + row] * kLog2e : INFINITY;
    dl[i] = row < n ? delta[static_cast<size_t>(bh) * n + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq_acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < n; n0 += kTile) {
    __syncthreads();  // the previous key tile's K, V and dS are read
    load_rows_t<T, DP>(kt, k + base, n0, n, d);
    load_rows_t<T, DP>(vt, v + base, n0, n, d);
    __syncthreads();
    float s[4][4], dp[4][4];
    patch_product(s, qs, DP + 1, kt, d, ty, tx);
    patch_product(dp, dos, DP + 1, vt, d, ty, tx);
    probs_and_ds(s, dp, lse2, dl, n0, n, tx, scale_log2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty * 4 + i) * kLd + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ[row, :] += sum_key dS[row, key] K[key, :], K[key, c] = kt[c * kLd + key]
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float g[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = dss[(ty * 4 + i) * kLd + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = kt[(tx + 16 * c) * kLd + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq_acc[i][c] = fmaf(g[i], kv[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dq[base + static_cast<size_t>(row) * d + col] = sis::from_float<T>(dq_acc[i][c] * sm_scale);
      }
    }
  }
}

// Dynamic shared memory above 48 KB has to be allowed per kernel once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * static_cast<int>(sizeof(float)));
}

template <typename T, int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                       int n, int d, float sm_scale, cudaStream_t stream) {
  static const cudaError_t allowed = allow_smem(flash_fwd_kernel<T, DP>, fwd_smem_floats<DP>());
  if (allowed != cudaSuccess) return allowed;
  const dim3 grid((n + kTile - 1) / kTile, bh);
  flash_fwd_kernel<T, DP><<<grid, kThreads, fwd_smem_floats<DP>() * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, n, d, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, float* delta, void* dq, void* dk,
                       void* dv, int bh, int n, int d, float sm_scale, cudaStream_t stream) {
  static const cudaError_t allowed_dkdv =
      allow_smem(flash_bwd_dkdv_kernel<T, DP>, dkdv_smem_floats<DP>());
  static const cudaError_t allowed_dq =
      allow_smem(flash_bwd_dq_kernel<T, DP>, dq_smem_floats<DP>());
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  if (allowed_dq != cudaSuccess) return allowed_dq;
  const long long rows = static_cast<long long>(bh) * n;
  const int rows_per_block = kThreads / 32;
  const auto delta_blocks = static_cast<unsigned int>((rows + rows_per_block - 1) / rows_per_block);
  flash_bwd_delta_kernel<T><<<delta_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, bh);
  const float scale_log2 = sm_scale * kLog2e;
  flash_bwd_dkdv_kernel<T, DP><<<grid, kThreads, dkdv_smem_floats<DP>() * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), n, d,
      scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, dq_smem_floats<DP>() * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), n, d, scale_log2, sm_scale);
  return cudaGetLastError();
}

bool valid_shape(int bh, int n, int d) {
  return bh > 0 && bh <= 65535 && n > 0 && d > 0 && d <= 128;
}

// The launches for d padded to DP = 32, 64 or 128.
template <typename T>
cudaError_t fwd_for_d(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                      int n, int d, float sm_scale, cudaStream_t s) {
  if (d <= 32) return launch_fwd<T, 32>(q, k, v, o, lse, bh, n, d, sm_scale, s);
  if (d <= 64) return launch_fwd<T, 64>(q, k, v, o, lse, bh, n, d, sm_scale, s);
  return launch_fwd<T, 128>(q, k, v, o, lse, bh, n, d, sm_scale, s);
}

template <typename T>
cudaError_t bwd_for_d(const void* q, const void* k, const void* v, const void* o,
                      const float* lse, const void* dout, float* delta, void* dq, void* dk,
                      void* dv, int bh, int n, int d, float sm_scale, cudaStream_t s) {
  if (d <= 32) {
    return launch_bwd<T, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  if (d <= 64) {
    return launch_bwd<T, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  return launch_bwd<T, 128>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, n, d, sm_scale, s);
}

}  // namespace

// o, lse = attention(q, k, v): (bh, n, d) tensors of `dtype`, lse (bh, n)
// float32.
extern "C" int sis_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int bh, int n, int d, float sm_scale,
                                       int dtype, void* stream) {
  if (!valid_shape(bh, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == sis::kFloat32) return fwd_for_d<float>(q, k, v, o, l, bh, n, d, sm_scale, s);
  if (dtype == sis::kBFloat16) {
    return fwd_for_d<__nv_bfloat16>(q, k, v, o, l, bh, n, d, sm_scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq, dk, dv from q, k, v, the forward's o and lse, and dout; delta is
// (bh, n) float32 scratch.
extern "C" int sis_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* lse, const void* dout,
                                       void* delta, void* dq, void* dk, void* dv, int bh, int n,
                                       int d, float sm_scale, int dtype, void* stream) {
  if (!valid_shape(bh, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == sis::kFloat32) {
    return bwd_for_d<float>(q, k, v, o, l, dout, dl, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  if (dtype == sis::kBFloat16) {
    return bwd_for_d<__nv_bfloat16>(q, k, v, o, l, dout, dl, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
