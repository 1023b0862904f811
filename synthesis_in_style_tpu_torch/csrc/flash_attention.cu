// Flash attention, forward and backward: non-causal softmax(q k^T * scale) v
// over (batch * heads, N, d) tensors, row-major and contiguous, in float32
// or bfloat16 (outputs in the input type), head_dim d <= 128 (a multiple of 8
// in bfloat16), any N. No N x N matrix ever reaches device memory.
//
// Replaces the TPU kernels the JAX package reaches from
// synthesis_in_style_tpu/models/trans_u_net.py (Attention.__call__,
// impl == "flash"): jax.experimental.pallas.ops.tpu.flash_attention's
// forward (`_flash_attention_impl`, pl.pallas_call at flash_attention.py:758
// of jax 0.9.0) and the two kernels of its custom VJP (`_flash_attention_
// bwd_dkv`, :1121, and `_flash_attention_bwd_dq`, :1456).
//
// The two types run two designs, all on the caller's stream:
//
// bfloat16 (flash_attention_bf16.cuh), on the tensor cores:
//   1. flash_fwd_wgmma_kernel: a block per (batch * head, 128 query rows),
//      two consumer warpgroups of 64 rows and a producer warp that streams
//      K / V tiles (128 keys at d <= 64, 64 at d <= 128) by TMA into a
//      three-stage mbarrier ring; S = Q K^T and O += P V are wgmma (P from
//      registers, rounded to bfloat16 as the TPU kernel rounds it), the
//      online softmax in registers, each tile's while the tensor cores run
//      the previous tile's P V; O and the float32 logsumexp out.
//   2. flash_bwd_delta_kernel<bfloat16>: D = rowsum(dO * O).
//   3. flash_bwd_dkdv_mma_kernel: a block per 128 keys (a warp per 32 at
//      d <= 64, per 16 above), 32-row query tiles by cp.async in a
//      double-buffered ring; S^T, dP^T, dV and dK on mma.sync.m16n8k16, P^T
//      and dS^T kept in registers as the next product's A operand.
//   4. flash_bwd_dq_mma_kernel: a block per 128 query rows (a warp per 16),
//      key tiles of 64: S, dP and dQ on mma.sync. Two passes, no atomics:
//      every sum in a fixed order, the same bits every run.
//
// float32 (below, the first design), on the CUDA cores: flash_fwd_kernel,
// flash_bwd_delta_kernel, flash_bwd_dkdv_kernel and flash_bwd_dq_kernel with
// 64-row query and key tiles staged in shared memory, 256 threads as 16 x 16
// (a thread owns a 4 x 4 patch of every 64 x 64 score tile and 4 rows x DP /
// 16 columns of its accumulators, DP being d padded to 32, 64 or 128), every
// product a float32 FMA from shared memory. K and V are stored transposed
// where the product reads them along the key axis, one float of padding a
// row keeping the transposing stores and the reads free of bank conflicts.
//
// Bound on the H100 (SXM, 700 W) at the shipped TransUNet's shape
// (B, heads, N, d) = (8, 12, 1024, 64):
//   forward: 4 B h N^2 d = 25.8 GFLOP; q, k, v and o of 12.6 MB each in
//     bfloat16 (50 MB): 0.026 ms at 989 TFLOP/s (bfloat16 tensor cores),
//     0.385 ms at 67 TFLOP/s in float32 outside the tensor cores;
//   backward: ~10 B h N^2 d = ~64.4 GFLOP (recomputing P and the products
//     dP, dV, dK, dQ): 0.065 ms in bfloat16, 0.96 ms in float32.
// The work is the products: bound by operations, not bytes. The float32
// design's ceiling is the float32 rate. The bfloat16 design runs every
// product on the tensor cores (~0.09 ms forward, ~0.43 ms backward here, on
// NVIDIA H100 80GB HBM3 at 700 W: PERF.md); what still holds it back: in
// the forward the softmax's exp2 and float work per score (about as long as
// the two products at d = 64) and one block an SM (no second block hides a
// block's start and end); in the backward mma.sync (not wgmma) with
// operands re-read by every warp through ldmatrix, and the separate dQ
// pass that recomputes S and dP (7 products where 5 would do, the price of
// determinism).
#include <math.h>

#include "common.cuh"
#include "flash_attention_bf16.cuh"

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

// The float32 launches for d padded to DP = 32, 64 or 128.
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                    int n, int d, float sm_scale, cudaStream_t s) {
  if (d <= 32) return launch_fwd<float, 32>(q, k, v, o, lse, bh, n, d, sm_scale, s);
  if (d <= 64) return launch_fwd<float, 64>(q, k, v, o, lse, bh, n, d, sm_scale, s);
  return launch_fwd<float, 128>(q, k, v, o, lse, bh, n, d, sm_scale, s);
}

cudaError_t bwd_f32(const void* q, const void* k, const void* v, const void* o, const float* lse,
                    const void* dout, float* delta, void* dq, void* dk, void* dv, int bh, int n,
                    int d, float sm_scale, cudaStream_t s) {
  if (d <= 32) {
    return launch_bwd<float, 32>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  if (d <= 64) {
    return launch_bwd<float, 64>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  return launch_bwd<float, 128>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, n, d, sm_scale, s);
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernels of flash_attention_bf16.cuh

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: reached through the runtime's
// entry-point query, so that the library needs no -lcuda. Null if missing.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status{};
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &status);
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A (bh, n, d) bfloat16 tensor as a 3-D TMA map of boxes of 64 columns x
// `rows` rows of one head, 128-byte swizzle; what lies past n or d reads as
// zeros. Host-only (no device call, no allocation): safe under graph capture.
bool encode_rows(CUtensorMap* map, const void* ptr, int bh, int n, int d, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(n) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem_bytes(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                            int bh, int n, int d, float sm_scale, cudaStream_t stream) {
  namespace fb = sis::flash_bf16;
  using C = fb::FwdCfg<DP>;
  static const cudaError_t allowed = allow_smem_bytes(fb::flash_fwd_wgmma_kernel<DP>, C::kSmem);
  if (allowed != cudaSuccess) return allowed;
  CUtensorMap tq, tk, tv;
  if (!encode_rows(&tq, q, bh, n, d, fb::kFwdRows) || !encode_rows(&tk, k, bh, n, d, C::kBN) ||
      !encode_rows(&tv, v, bh, n, d, C::kBN)) {
    return cudaErrorNotSupported;
  }
  const dim3 grid((n + fb::kFwdRows - 1) / fb::kFwdRows, bh);
  fb::flash_fwd_wgmma_kernel<DP><<<grid, fb::kFwdThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, n, d, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                            const float* lse, const void* dout, float* delta, void* dq, void* dk,
                            void* dv, int bh, int n, int d, float sm_scale, cudaStream_t stream) {
  namespace fb = sis::flash_bf16;
  using C = fb::BwdCfg<DP>;
  using bf16 = __nv_bfloat16;
  static const cudaError_t allowed_dkdv =
      allow_smem_bytes(fb::flash_bwd_dkdv_mma_kernel<DP>, C::kDkdvSmem);
  static const cudaError_t allowed_dq =
      allow_smem_bytes(fb::flash_bwd_dq_mma_kernel<DP>, C::kDqSmem);
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  if (allowed_dq != cudaSuccess) return allowed_dq;
  const long long rows = static_cast<long long>(bh) * n;
  const int rows_per_block = kThreads / 32;
  const auto delta_blocks = static_cast<unsigned int>((rows + rows_per_block - 1) / rows_per_block);
  flash_bwd_delta_kernel<bf16><<<delta_blocks, kThreads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((n + fb::kBwdRows - 1) / fb::kBwdRows, bh);
  const float scale_log2 = sm_scale * kLog2e;
  fb::flash_bwd_dkdv_mma_kernel<DP><<<grid, C::kDkdvThreads, C::kDkdvSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      n, d, scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fb::flash_bwd_dq_mma_kernel<DP><<<grid, 32 * fb::kDqWarps, C::kDqSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), n, d, scale_log2,
      sm_scale);
  return cudaGetLastError();
}

// bfloat16 needs rows of a multiple of 16 bytes (TMA, 16-byte copies).
bool valid_bf16_dim(int d) { return d % 8 == 0; }

}  // namespace

// o, lse = attention(q, k, v): (bh, n, d) tensors of `dtype`, lse (bh, n)
// float32. bfloat16 runs the tensor-core kernels and needs d % 8 == 0.
extern "C" int sis_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int bh, int n, int d, float sm_scale,
                                       int dtype, void* stream) {
  if (!valid_shape(bh, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == sis::kFloat32) return fwd_f32(q, k, v, o, l, bh, n, d, sm_scale, s);
  if (dtype == sis::kBFloat16 && valid_bf16_dim(d)) {
    if (d <= 64) return launch_fwd_bf16<64>(q, k, v, o, l, bh, n, d, sm_scale, s);
    return launch_fwd_bf16<128>(q, k, v, o, l, bh, n, d, sm_scale, s);
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
    return bwd_f32(q, k, v, o, l, dout, dl, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  if (dtype == sis::kBFloat16 && valid_bf16_dim(d)) {
    if (d <= 64) {
      return launch_bwd_bf16<64>(q, k, v, o, l, dout, dl, dq, dk, dv, bh, n, d, sm_scale, s);
    }
    return launch_bwd_bf16<128>(q, k, v, o, l, dout, dl, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
