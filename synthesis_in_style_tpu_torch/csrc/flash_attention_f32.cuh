// The float32 flash attention kernels, on the tensor cores in 3xTF32
// (included by flash_attention.cu, whose header says what they replace and
// what bounds them). Tensors are (bh, n, d) float32, contiguous, 1 <= d <=
// 128, any n; d is padded to DP = 32, 64 or 128 with zeros in shared memory.
//
// 3xTF32: every float32 operand x of a product is split into a TF32 high
// part hi = rna(x) (to nearest, ties away from zero: hopper::to_tf32) and a
// low part lo = x - hi, exact in float32, which the tensor cores truncate to
// TF32 as they read it; a . b runs as three mma.sync.m16n8k8 TF32 products
// into one float32 accumulator, the small ones first: a_hi b_lo + a_lo b_hi
// + a_hi b_hi. hi + lo keeps ~21 bits of x, the dropped a_lo b_lo is ~2^-22
// of a product: float32-class sums at the TF32 tensor-core rate. The
// kernels take this route whatever torch.backends.cuda.matmul.allow_tf32
// says, as PyTorch's own float32 attention does: there is no switch.
//
// Fragments (lane = 4 g + t). mma.m16n8k8's accumulator gives a thread
// columns 2t and 2t + 1 of rows g and g + 8, but its A operand wants k = t
// and t + 4. Nothing is shuffled: every product's k axis is permuted within
// each group of 8, k slot t <-> index 2t and slot t + 4 <-> 2t + 1, in both
// operands alike. So an accumulator (P, P^T, dS, dS^T) is the next
// product's A operand as it stands (registers c0, c2, c1, c3); a row-major
// tile's A fragment is a float2 from each of rows g and g + 8; a B operand
// read along its rows (K in S = Q K^T) is one float2, and one read down its
// rows (V in P V) is rows 2t and 2t + 1. Shared-memory tiles have rows of
// DP + 4 floats, which keeps every one of those reads free of bank
// conflicts.
//
// Accumulation: the tensor cores round each mma's sum toward zero, so a
// long chain of mma.sync into one accumulator drifts toward zero (O over
// 1024 keys, 384 products deep, landed 1.2e-5 of max|O| from float32 on an
// H100). The sums over the key or query axis therefore run in tile-sized
// partial sums (zeroed, 3 x 8 products deep at a tile of 64 keys), which
// are added into the running float32 sums by ordinary, round-to-nearest
// instructions, kChunk column blocks at a time (the A operand split again
// for each chunk).
//
// Forward, flash_fwd_split_kernel: a block per (batch * head, 64 query
// rows), 4 warps of 16 rows; K / V tiles of 64 keys by cp.async into a
// double-buffered ring; Q's fragments split once and kept in registers (DP
// <= 64; at DP = 128 re-read from shared memory at every tile); S = Q K^T,
// the online softmax in registers (exp2, the scale folded into one FMA), P
// split in registers as the A operand of O += P V; O normalised by its own
// weight sum, the logsumexp in natural log.
//
// Backward, after flash_bwd_delta_kernel<float> (D = rowsum(dO * O)), two
// passes with no atomics: every sum in a fixed order, the same bits every
// run.
//   flash_bwd_dkdv_split_kernel: a block per 64 keys (a warp per 16), query
//     tiles of 64 rows (32 at DP = 128) with their logsumexp and D in a
//     double-buffered ring: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T =
//     P^T (dP^T - D) in registers and as they stand the A operands of
//     dV += P^T dO and dK += dS^T Q; dK scaled by sm_scale at the end.
//   flash_bwd_dq_split_kernel: a block per 64 query rows (a warp per 16),
//     key tiles of 64 (32 at DP = 128): S = Q K^T, dP = dO V^T, dS,
//     dQ += dS K; dQ scaled by sm_scale at the end (float32's order: the
//     plain version scales the products, not dS).
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace sis {
namespace flash_f32 {

using hopper::smem_addr;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kRows = 64;      // query rows of a forward or dQ block, keys of a dK / dV block
constexpr int kThreads = 128;  // 4 warps, 16 of those rows each
constexpr int kFwdKeys = 64;   // keys per K / V tile of the forward
constexpr int kChunk = 4;      // column blocks of 8 a tile's partial sums cover at a time

template <int DP>
struct Cfg {
  static constexpr int kLd = DP + 4;          // floats per shared-memory row
  static constexpr bool kQInRegs = DP <= 64;  // the forward holds Q's fragments in registers
  static constexpr int kFwdTile = kFwdKeys * kLd;  // one K or V tile of the forward
  // forward: two stages of K, V; Q in stage 1's K tile while it is read into
  // registers, else in a tile of its own
  static constexpr int kFwdSmem = (4 * kFwdTile + (kQInRegs ? 0 : kRows * kLd)) * 4;
  static constexpr int kOwn = kRows * kLd;  // the block's own K, V (dK / dV) or Q, dO (dQ)
  // query rows (dK / dV) or keys (dQ) per tile of the backward: 64 would
  // spill registers at DP = 128
  static constexpr int kBwdTile = DP <= 64 ? 64 : 32;
  static constexpr int kBwdTileF = kBwdTile * kLd;
  // dK / dV: K, V, then two stages of Q, dO, logsumexp and D
  static constexpr int kDkdvStage = 2 * kBwdTileF + 2 * kBwdTile;
  static constexpr int kDkdvSmem = (2 * kOwn + 2 * kDkdvStage) * 4;
  // dQ: Q, dO, then two stages of K, V
  static constexpr int kDqSmem = (2 * kOwn + 4 * kBwdTileF) * 4;
};

// An m16n8k8 operand as TF32 high and low parts.
struct AFrag {
  uint32_t hi[4], lo[4];
};
struct BFrag {
  uint32_t hi[2], lo[2];
};

// x as TF32 hi and the rest, lo = x - hi, whole: a NaN in x stays in lo
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = hopper::to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A from its four registers' values: (row g, k slot t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)
__device__ __forceinline__ AFrag a_frag(float x0, float x1, float x2, float x3) {
  AFrag a;
  split(x0, a.hi[0], a.lo[0]);
  split(x1, a.hi[1], a.lo[1]);
  split(x2, a.hi[2], a.lo[2]);
  split(x3, a.hi[3], a.lo[3]);
  return a;
}

// B from its two registers' values: (k slot t, column g), (t + 4, g)
__device__ __forceinline__ BFrag b_frag(float x0, float x1) {
  BFrag b;
  split(x0, b.hi[0], b.lo[0]);
  split(x1, b.hi[1], b.lo[1]);
  return b;
}

// c += a . b in 3xTF32, the two small products first
__device__ __forceinline__ void mma3(float (&c)[4], const AFrag& a, const BFrag& b) {
  hopper::mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  hopper::mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  hopper::mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// k step kk of the 16 rows of a row-major tile that start at `rows`, as A:
// columns 8 kk + 2t and + 1 of rows g and g + 8
template <int DP>
__device__ __forceinline__ AFrag load_a(const float* rows, int kk, int g, int t) {
  constexpr int kLd = Cfg<DP>::kLd;
  const float2 x0 = *reinterpret_cast<const float2*>(rows + g * kLd + 8 * kk + 2 * t);
  const float2 x1 = *reinterpret_cast<const float2*>(rows + (g + 8) * kLd + 8 * kk + 2 * t);
  return a_frag(x0.x, x1.x, x0.y, x1.y);
}

// B = X^T for rows [8 nb, + 8) of a row-major tile X (B's columns) and the
// columns of k step kk: row 8 nb + g, columns 8 kk + 2t and + 1
template <int DP>
__device__ __forceinline__ BFrag load_bt(const float* x, int nb, int kk, int g, int t) {
  const float2 v =
      *reinterpret_cast<const float2*>(x + (8 * nb + g) * Cfg<DP>::kLd + 8 * kk + 2 * t);
  return b_frag(v.x, v.y);
}

// B = X for the rows of k step kk of a row-major tile X and its columns
// [8 nb, + 8): rows 8 kk + 2t and + 1, column 8 nb + g
template <int DP>
__device__ __forceinline__ BFrag load_b(const float* x, int kk, int nb, int g, int t) {
  constexpr int kLd = Cfg<DP>::kLd;
  const float* at = x + (8 * kk + 2 * t) * kLd + 8 * nb + g;
  return b_frag(at[0], at[kLd]);
}

// An accumulator (rows g, g + 8; columns 2t, 2t + 1) as the A operand of a
// product over its columns: column 2t is k slot t, column 2t + 1 slot t + 4
__device__ __forceinline__ AFrag c_to_a(const float (&c)[4]) {
  return a_frag(c[0], c[2], c[1], c[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// Max and sum over the 4 lanes that hold one row of an accumulator.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + rows) of a (n, d) matrix into a tile of DP columns (row
// stride kLd) by cp.async, zeros past n and past d, the block's threads
// sharing the copies: 16 bytes each when `vec` (d % 4 == 0 and 16-byte
// aligned tensors), else 4.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int rows, int n,
                                          int d, bool vec) {
  constexpr int kLd = Cfg<DP>::kLd;
  if (vec) {
    constexpr int kChunks = DP / 4;
    for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = 4 * (idx % kChunks);
      const bool valid = row0 + r < n && c < d;
      hopper::cp_async16(smem_addr(dst + r * kLd + c),
                         valid ? src + static_cast<size_t>(row0 + r) * d + c : src, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const bool valid = row0 + r < n && c < d;
      hopper::cp_async4(smem_addr(dst + r * kLd + c),
                        valid ? src + static_cast<size_t>(row0 + r) * d + c : src, valid);
    }
  }
}

// Per-row values [row0, row0 + rows) by cp.async, zeros past n.
__device__ __forceinline__ void load_values(float* dst, const float* src, int row0, int rows,
                                            int n) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const bool valid = row0 + r < n;
    hopper::cp_async4(smem_addr(dst + r), valid ? src + row0 + r : src, valid);
  }
}

// A warp's accumulators (rows row0 + g and + 8 of a (n, d) matrix, DP / 8
// column blocks) times scale[row], rows past n and columns past d skipped.
template <int DP>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[DP / 8][4],
                                           const float (&scale)[2], int row0, int n, int d,
                                           bool vec, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    float* out = dst + static_cast<size_t>(row) * d;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = 8 * nb + 2 * t;
      const float x0 = acc[nb][2 * r] * scale[r], x1 = acc[nb][2 * r + 1] * scale[r];
      if (vec) {  // d % 4 == 0: col < d holds both columns
        if (col < d) *reinterpret_cast<float2*>(out + col) = make_float2(x0, x1);
      } else {
        if (col < d) out[col] = x0;
        if (col + 1 < d) out[col + 1] = x1;
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int n, int d, float scale_log2, int vec) {
  using C = Cfg<DP>;
  constexpr int KS = DP / 8, NB = kFwdKeys / 8;
  extern __shared__ __align__(16) float smem_f32[];
  float* const kv_s = C::kQInRegs ? smem_f32 : smem_f32 + kRows * C::kLd;
  float* const q_s = C::kQInRegs ? kv_s + 2 * C::kFwdTile : smem_f32;
  const int bh = blockIdx.y, m0 = blockIdx.x * kRows;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* const q_w = q_s + warp * 16 * C::kLd;  // this warp's 16 rows
  const int tiles = (n + kFwdKeys - 1) / kFwdKeys;

  auto load_kv = [&](int j) {
    float* st = kv_s + (j & 1) * 2 * C::kFwdTile;
    load_tile<DP>(st, k + base, j * kFwdKeys, kFwdKeys, n, d, vec);
    load_tile<DP>(st + C::kFwdTile, v + base, j * kFwdKeys, kFwdKeys, n, d, vec);
  };
  load_tile<DP>(q_s, q + base, m0, kRows, n, d, vec);
  load_kv(0);
  hopper::cp_async_commit();

  AFrag qf[C::kQInRegs ? KS : 1];
  if constexpr (C::kQInRegs) {
    hopper::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) qf[kk] = load_a<DP>(q_w, kk, g, t);
    __syncthreads();  // Q's tile is stage 1, which tile 1 refills
  }

  float o_acc[DP / 8][4];
  zero(o_acc);
  // this thread's rows g (r = 0) and g + 8 (r = 1): running maximum (log2
  // units) and weight sum
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      load_kv(j + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const float* const k_t = kv_s + (j & 1) * 2 * C::kFwdTile;
    const float* const v_t = k_t + C::kFwdTile;

    // S = Q K^T: s[nb][2 r + e] is row g + 8 r, key 8 nb + 2t + e
    float s[NB][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      AFrag a;
      if constexpr (C::kQInRegs) {
        a = qf[kk];
      } else {
        a = load_a<DP>(q_w, kk, g, t);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma3(s[nb], a, load_bt<DP>(k_t, nb, kk, g, t));
    }

    // online softmax: P = exp2(S scale_log2 - m) in place. A full tile at a
    // positive scale takes the maximum of the raw scores, scaled (fewer
    // operations an element); else the scores are scaled and masked first.
    const int n0 = j * kFwdKeys;
    const bool whole = scale_log2 > 0.f && n0 + kFwdKeys <= n;
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
      if (whole) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mx = fmaxf(mx, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
        mx = quad_max(mx) * scale_log2;
      } else {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nb][2 * r + e];
            x = (n0 + 8 * nb + 2 * t + e < n) ? x * scale_log2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = quad_max(mx);
      }
      const float a = whole ? scale_log2 : 1.f;  // what exp2 still scales by
      // every tile holds a key (n0 < n), so the new maximum is finite
      const float m_new = fmaxf(m_i[r], mx);
      alpha[r] = exp2f(m_i[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nb][2 * r + e];
          x = exp2f(fmaf(x, a, -m_new));
          rs += x;
        }
      l_i[r] = l_i[r] * alpha[r] + quad_sum(rs);
      m_i[r] = m_new;
    }

    // O = O alpha + P V, P's key block kk as it stands the A operand
#pragma unroll
    for (int c0 = 0; c0 < DP / 8; c0 += kChunk) {
      float pv[kChunk][4];
      zero(pv);
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const AFrag p = c_to_a(s[kk]);
#pragma unroll
        for (int nb = 0; nb < kChunk; ++nb) mma3(pv[nb], p, load_b<DP>(v_t, kk, c0 + nb, g, t));
      }
#pragma unroll
      for (int nb = 0; nb < kChunk; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o_acc[c0 + nb][e] = fmaf(o_acc[c0 + nb][e], alpha[e >> 1], pv[nb][e]);
        }
    }
    __syncthreads();  // this stage is read before iteration j + 1 refills it
  }

  const float inv[2] = {1.f / l_i[0], 1.f / l_i[1]};
  store_rows<DP>(o + base, o_acc, inv, m0 + warp * 16, n, d, vec, g, t);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + warp * 16 + g + 8 * r;
      if (row < n) lse[static_cast<size_t>(bh) * n + row] = (m_i[r] + log2f(l_i[r])) * kLn2;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int n, int d,
                                float scale_log2, float sm_scale, int vec) {
  using C = Cfg<DP>;
  constexpr int KS = DP / 8, kBwdTile = C::kBwdTile, NQ = kBwdTile / 8;
  extern __shared__ __align__(16) float smem_f32[];
  float* const k_s = smem_f32;
  float* const v_s = k_s + C::kOwn;
  float* const stage0 = v_s + C::kOwn;
  const int bh = blockIdx.y, n0 = blockIdx.x * kRows;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const float* const lse_bh = lse + static_cast<size_t>(bh) * n;
  const float* const delta_bh = delta + static_cast<size_t>(bh) * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* const k_w = k_s + warp * 16 * C::kLd;  // this warp's 16 keys
  const float* const v_w = v_s + warp * 16 * C::kLd;

  auto load_stage = [&](int i) {
    float* st = stage0 + (i & 1) * C::kDkdvStage;
    load_tile<DP>(st, q + base, i * kBwdTile, kBwdTile, n, d, vec);
    load_tile<DP>(st + C::kBwdTileF, dout + base, i * kBwdTile, kBwdTile, n, d, vec);
    load_values(st + 2 * C::kBwdTileF, lse_bh, i * kBwdTile, kBwdTile, n);
    load_values(st + 2 * C::kBwdTileF + kBwdTile, delta_bh, i * kBwdTile, kBwdTile, n);
  };
  load_tile<DP>(k_s, k + base, n0, kRows, n, d, vec);
  load_tile<DP>(v_s, v + base, n0, kRows, n, d, vec);
  load_stage(0);
  hopper::cp_async_commit();

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  const int tiles = (n + kBwdTile - 1) / kBwdTile;
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      load_stage(i + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const float* const q_t = stage0 + (i & 1) * C::kDkdvStage;
    const float* const do_t = q_t + C::kBwdTileF;
    const float* const lse_t = do_t + C::kBwdTileF;
    const float* const delta_t = lse_t + kBwdTile;

    // S^T (keys x queries) and dP^T: st[nb][2 r + e] is key g + 8 r, query
    // 8 nb + 2t + e of the tile
    float st[NQ][4], dpt[NQ][4];
    zero(st);
    zero(dpt);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const AFrag ka = load_a<DP>(k_w, kk, g, t), va = load_a<DP>(v_w, kk, g, t);
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb) {
        mma3(st[nb], ka, load_bt<DP>(q_t, nb, kk, g, t));
        mma3(dpt[nb], va, load_bt<DP>(do_t, nb, kk, g, t));
      }
    }
    // P^T = exp2(S^T scale_log2 - lse2[query]), dS^T = P^T (dP^T - D[query]);
    // a query past n has P = 0
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nb + 2 * t + (e & 1);
        const float p = i * kBwdTile + col < n
                            ? exp2f(st[nb][e] * scale_log2 - lse_t[col] * kLog2e)
                            : 0.f;
        st[nb][e] = p;
        dpt[nb][e] = p * (dpt[nb][e] - delta_t[col]);
      }
    // dV += P^T dO, dK += dS^T Q: the query block kk of P^T and dS^T as A
#pragma unroll
    for (int c0 = 0; c0 < DP / 8; c0 += kChunk) {
      float tv[kChunk][4], tk[kChunk][4];
      zero(tv);
      zero(tk);
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        const AFrag pa = c_to_a(st[kk]), sa = c_to_a(dpt[kk]);
#pragma unroll
        for (int nb = 0; nb < kChunk; ++nb) {
          mma3(tv[nb], pa, load_b<DP>(do_t, kk, c0 + nb, g, t));
          mma3(tk[nb], sa, load_b<DP>(q_t, kk, c0 + nb, g, t));
        }
      }
#pragma unroll
      for (int nb = 0; nb < kChunk; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[c0 + nb][e] += tv[nb][e];
          dk_acc[c0 + nb][e] += tk[nb][e];
        }
    }
    __syncthreads();  // this stage is read before iteration i + 1 refills it
  }

  const float scale[2] = {sm_scale, sm_scale}, one[2] = {1.f, 1.f};
  store_rows<DP>(dk + base, dk_acc, scale, n0 + warp * 16, n, d, vec, g, t);
  store_rows<DP>(dv + base, dv_acc, one, n0 + warp * 16, n, d, vec, g, t);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dq, int n, int d, float scale_log2,
                              float sm_scale, int vec) {
  using C = Cfg<DP>;
  constexpr int KS = DP / 8, kBwdTile = C::kBwdTile, NK = kBwdTile / 8;
  extern __shared__ __align__(16) float smem_f32[];
  float* const q_s = smem_f32;
  float* const do_s = q_s + C::kOwn;
  float* const stage0 = do_s + C::kOwn;
  const int bh = blockIdx.y, m0 = blockIdx.x * kRows;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float* const q_w = q_s + warp * 16 * C::kLd;  // this warp's 16 query rows
  const float* const do_w = do_s + warp * 16 * C::kLd;

  auto load_stage = [&](int j) {
    float* st = stage0 + (j & 1) * 2 * C::kBwdTileF;
    load_tile<DP>(st, k + base, j * kBwdTile, kBwdTile, n, d, vec);
    load_tile<DP>(st + C::kBwdTileF, v + base, j * kBwdTile, kBwdTile, n, d, vec);
  };
  load_tile<DP>(q_s, q + base, m0, kRows, n, d, vec);
  load_tile<DP>(do_s, dout + base, m0, kRows, n, d, vec);
  load_stage(0);
  hopper::cp_async_commit();

  // rows g and g + 8: logsumexp (log2 units; +inf past n, so that P = 0)
  // and D
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    lse2[r] = row < n ? lse[static_cast<size_t>(bh) * n + row] * kLog2e : INFINITY;
    dl[r] = row < n ? delta[static_cast<size_t>(bh) * n + row] : 0.f;
  }
  float dq_acc[DP / 8][4];
  zero(dq_acc);

  const int tiles = (n + kBwdTile - 1) / kBwdTile;
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      load_stage(j + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const float* const k_t = stage0 + (j & 1) * 2 * C::kBwdTileF;
    const float* const v_t = k_t + C::kBwdTileF;

    // S and dP: s[nb][2 r + e] is row g + 8 r, key 8 nb + 2t + e of the tile
    float s[NK][4], dp[NK][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const AFrag qa = load_a<DP>(q_w, kk, g, t), oa = load_a<DP>(do_w, kk, g, t);
#pragma unroll
      for (int nb = 0; nb < NK; ++nb) {
        mma3(s[nb], qa, load_bt<DP>(k_t, nb, kk, g, t));
        mma3(dp[nb], oa, load_bt<DP>(v_t, nb, kk, g, t));
      }
    }
    // P = exp2(S scale_log2 - lse2[row]) (0 for a key past n), dS = P (dP - D)
#pragma unroll
    for (int nb = 0; nb < NK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * kBwdTile + 8 * nb + 2 * t + (e & 1);
        const float p = col < n ? exp2f(s[nb][e] * scale_log2 - lse2[r]) : 0.f;
        dp[nb][e] = p * (dp[nb][e] - dl[r]);
      }
    // dQ += dS K: the key block kk of dS as A
#pragma unroll
    for (int c0 = 0; c0 < DP / 8; c0 += kChunk) {
      float tq[kChunk][4];
      zero(tq);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const AFrag da = c_to_a(dp[kk]);
#pragma unroll
        for (int nb = 0; nb < kChunk; ++nb) mma3(tq[nb], da, load_b<DP>(k_t, kk, c0 + nb, g, t));
      }
#pragma unroll
      for (int nb = 0; nb < kChunk; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[c0 + nb][e] += tq[nb][e];
    }
    __syncthreads();  // this stage is read before iteration j + 1 refills it
  }

  const float scale[2] = {sm_scale, sm_scale};
  store_rows<DP>(dq + base, dq_acc, scale, m0 + warp * 16, n, d, vec, g, t);
}

}  // namespace flash_f32
}  // namespace sis
