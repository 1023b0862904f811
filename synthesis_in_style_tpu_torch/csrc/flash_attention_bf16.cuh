// The bfloat16 flash attention kernels, on the tensor cores (included by
// flash_attention.cu, whose header says what they replace and what bounds
// them). Tensors are (bh, n, d) bfloat16, contiguous, d a multiple of 8 (the
// TMA rows of the forward and the 16-byte copies of the backward), d <= 128;
// d is padded to DP = 64 or 128 with zeros.
//
// Roundings, as the TPU kernel takes them: S = Q K^T and dP = dO V^T from
// bfloat16 inputs with float32 sums; P is rounded to bfloat16 before P V (the
// forward, unnormalised against the running row maximum) and before P^T dO
// (dV); dS = P * (dP - D) * scale is rounded to bfloat16 before dS^T Q (dK)
// and dS K (dQ). Softmax statistics, D and every accumulator are float32.
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace sis {
namespace flash_bf16 {

using hopper::pack_bf16;
using hopper::smem_addr;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Max and sum over the 4 lanes that hold one row of an m16n8 / wgmma tile.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ===========================================================================
// Forward: wgmma fed by TMA.
//
// A block owns 128 query rows: two consumer warpgroups of 64 rows each and
// one producer warp. The producer loads the Q tile once and then each K / V
// tile of kBN keys into a ring of kFwdStages stages (TMA, 128-byte swizzle,
// rows and columns past the tensor read as zeros), each stage signalled by a
// `full` mbarrier (the bytes) and released by an `empty` one (the 256
// consumer threads). A consumer warpgroup computes S = Q K^T (wgmma, both
// operands in shared memory), the online softmax in registers (each thread
// holds two rows' columns), and O += P V (wgmma with P from the registers the
// softmax left it in, V from shared memory in the transposed-B layout). It
// issues S of tile j + 1 and P V of tile j together and runs the softmax of
// tile j + 1 while P V runs; no register of a running wgmma is read or
// written meanwhile (else ptxas serialises the wgmmas). Three stages let the
// producer load tile j + 2 while tiles j and j + 1 are in use.

constexpr int kFwdRows = 128;
constexpr int kFwdStages = 3;
constexpr int kFwdConsumers = 256;
constexpr int kFwdThreads = kFwdConsumers + 32;

template <int DP>
struct FwdCfg {
  static constexpr int kBN = DP == 64 ? 128 : 64;   // keys per K / V tile
  static constexpr int kHalves = DP / 64;           // 128-byte column boxes
  static constexpr int kQBytes = kHalves * kFwdRows * 128;
  static constexpr int kTileBytes = kHalves * kBN * 128;  // one K or one V tile
  // + 1024 to align the base to the swizzle atom
  static constexpr int kSmem = kQBytes + 2 * kFwdStages * kTileBytes + 1024;
};

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int s) {
  hopper::wgmma_ss_n64(d, a, b, s);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int s) {
  hopper::wgmma_ss_n128(d, a, b, s);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  hopper::wgmma_rs_n64_tb(d, a, b, 1);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  hopper::wgmma_rs_n128_tb(d, a, b, 1);
}

template <int DP>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int n, int d, float scale_log2) {
  using C = FwdCfg<DP>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kFwdStages + 1];  // full, empty, Q
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t kv_s = base + C::kQBytes;  // stage s: K at + 2 s tile, V after it
  const uint32_t full0 = smem_addr(&bars[0]);
  const uint32_t empty0 = smem_addr(&bars[kFwdStages]);
  const uint32_t q_bar = smem_addr(&bars[2 * kFwdStages]);
  const int bh = blockIdx.y, m0 = blockIdx.x * kFwdRows;
  const int tiles = (n + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(empty0 + 8 * s, kFwdConsumers);
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kFwdConsumers) {  // the producer warp
    if (threadIdx.x == kFwdConsumers) {
      hopper::mbar_arrive_expect_tx(q_bar, C::kQBytes);
      for (int h = 0; h < C::kHalves; ++h) {
        hopper::tma_load_3d(q_s + h * kFwdRows * 128, &tq, q_bar, h * 64, m0, bh);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kFwdStages;
        const uint32_t full = full0 + 8 * s, k_s = kv_s + 2 * s * C::kTileBytes;
        hopper::mbar_wait(empty0 + 8 * s, ((j / kFwdStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full, 2 * C::kTileBytes);
        for (int h = 0; h < C::kHalves; ++h) {
          hopper::tma_load_3d(k_s + h * kBN * 128, &tk, full, h * 64, j * kBN, bh);
          hopper::tma_load_3d(k_s + C::kTileBytes + h * kBN * 128, &tv, full, h * 64, j * kBN,
                              bh);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float o_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  const uint32_t q_wg = q_s + wg * 64 * 128;

  float s_acc[kBN / 2];
  uint32_t p_frag[kBN / 16][4];
  float alpha[2];
  // S = Q K^T of tile j into s_acc over DP / 16 steps of 16 columns (32
  // bytes of a swizzled row): issued and committed, not waited for
  auto issue_s = [&](int j) {
    const int s = j % kFwdStages;
    const uint32_t k_s = kv_s + 2 * s * C::kTileBytes;
    hopper::mbar_wait(full0 + 8 * s, (j / kFwdStages) & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int h = kk / 4, c = kk % 4;
      const uint64_t da = hopper::wgmma_desc_sw128(q_wg + h * kFwdRows * 128 + c * 32, 16, 1024);
      const uint64_t db = hopper::wgmma_desc_sw128(k_s + h * kBN * 128 + c * 32, 16, 1024);
      wgmma_ss<kBN>(s_acc, da, db, kk > 0 ? 1 : 0);
    }
    hopper::wgmma_commit();
  };
  // online softmax of tile j's S (rows g, r = 0, and g + 8, r = 1:
  // s_acc[4 jb + 2 r + e] is column 8 jb + 2 t + e): P = exp2(S - m) in
  // place, the row maxima and sums updated, alpha the rescale of O
  auto softmax = [&](int j) {
    const int n0 = j * kBN;
    // a full tile at a positive scale: the maximum of the raw scores, scaled
    // (fewer operations an element); else the scores scaled and masked first
    const bool whole = scale_log2 > 0.f && n0 + kBN <= n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
      if (whole) {
#pragma unroll
        for (int i = 0; i < kBN / 4; ++i) mx = fmaxf(mx, s_acc[4 * (i / 2) + 2 * r + i % 2]);
        mx = quad_max(mx) * scale_log2;
      } else {
#pragma unroll
        for (int jb = 0; jb < kBN / 8; ++jb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s_acc[4 * jb + 2 * r + e];
            x = (n0 + 8 * jb + 2 * t + e < n) ? x * scale_log2 : -INFINITY;
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
      for (int jb = 0; jb < kBN / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s_acc[4 * jb + 2 * r + e];
          x = exp2f(fmaf(x, a, -m_new));
          rs += x;
        }
      l_i[r] = l_i[r] * alpha[r] + quad_sum(rs);
      m_i[r] = m_new;
    }
  };
  // P in bfloat16 as the A fragments of kBN / 16 steps
  auto to_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p_frag[kk][i] = pack_bf16(s_acc[8 * kk + 2 * i], s_acc[8 * kk + 2 * i + 1]);
      }
  };

  // O rescaled by the last softmax's alpha
  auto rescale_o = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int jb = 0; jb < DP / 8; ++jb) {
        o_acc[4 * jb + 2 * r] *= alpha[r];
        o_acc[4 * jb + 2 * r + 1] *= alpha[r];
      }
  };
  // O += P V of tile j, P from p_frag: issued and committed
  auto issue_pv = [&](int j) {
    const uint32_t v_s = kv_s + (2 * (j % kFwdStages) + 1) * C::kTileBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t db = hopper::wgmma_desc_sw128(v_s + kk * 16 * 128, kBN * 128, 1024);
      wgmma_rs<DP>(o_acc, p_frag[kk], db);
    }
    hopper::wgmma_commit();
  };

  hopper::mbar_wait(q_bar, 0);
  issue_s(0);
  hopper::wgmma_wait<0>();
  hopper::fence_operands(s_acc);
  softmax(0);
  to_p();
  // tile j < tiles - 1, its P in p_frag; the last tile has no S to overlap
  for (int j = 0; j + 1 < tiles; ++j) {
    rescale_o();
    issue_s(j + 1);
    issue_pv(j);
    hopper::wgmma_wait<1>();  // S of tile j + 1 is done; P V of tile j may still run
    hopper::fence_operands(s_acc);
    softmax(j + 1);
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o_acc);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) hopper::fence_operands(p_frag[kk]);
    hopper::mbar_arrive(empty0 + 8 * (j % kFwdStages));
    to_p();
  }
  rescale_o();
  issue_pv(tiles - 1);
  hopper::wgmma_wait<0>();
  hopper::fence_operands(o_acc);

  // O / l in bfloat16 into this warpgroup's rows of the Q tile (same
  // 16-byte-chunk swizzle), then 16-byte stores of whole rows
  const int row_wg = warp * 16 + g;  // + 8 r
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / l_i[r];
    const int rr = row_wg + 8 * r;
#pragma unroll
    for (int jb = 0; jb < DP / 8; ++jb) {
      const int h = jb / 8, chunk = (jb % 8) ^ (rr % 8);
      uint8_t* at = base_ptr + h * kFwdRows * 128 + (wg * 64 + rr) * 128 + chunk * 16 + t * 4;
      *reinterpret_cast<uint32_t*>(at) =
          pack_bf16(o_acc[4 * jb + 2 * r] * inv, o_acc[4 * jb + 2 * r + 1] * inv);
    }
    const int row = m0 + wg * 64 + rr;
    if (t == 0 && row < n) {
      lse[static_cast<size_t>(bh) * n + row] = (m_i[r] + log2f(l_i[r])) * kLn2;
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const int chunks = d / 8;
  for (int idx = tid; idx < 64 * chunks; idx += 128) {
    const int rr = idx / chunks, c = idx % chunks, row = m0 + wg * 64 + rr;
    if (row >= n) continue;
    const int h = c / 8, chunk = (c % 8) ^ (rr % 8);
    const uint4 val = *reinterpret_cast<const uint4*>(base_ptr + h * kFwdRows * 128 +
                                                      (wg * 64 + rr) * 128 + chunk * 16);
    *reinterpret_cast<uint4*>(o + (static_cast<size_t>(bh) * n + row) * d + c * 8) = val;
  }
}

// ===========================================================================
// Backward: mma.sync.m16n8k16, operands through ldmatrix from shared-memory
// tiles of DP bfloat16 columns whose 16-byte chunks are swizzled by the row
// (chunk ^ (row % 8): the 8 rows of an 8 x 8 ldmatrix hit 8 different bank
// groups), filled by cp.async in a double-buffered ring. A warp owns MT
// m-tiles of 16 rows of every score tile, so S, P, dP and dS stay in its
// registers, and P and dS become the A operand of the next product without
// leaving them; each B fragment it loads feeds MT products.
//
// Two passes, no atomics, the same sums every run:
//   flash_bwd_dkdv_mma_kernel: a block per 128 keys (4 warps x 32 at
//     DP = 64, 8 x 16 at DP = 128), looping over query tiles of 32 rows:
//     S^T = K Q^T, dP^T = V dO^T, P^T and dS^T, dV += P^T dO, dK += dS^T Q.
//   flash_bwd_dq_mma_kernel: a block per 128 query rows (8 warps x 16),
//     looping over key tiles of 64: S = Q K^T, dP = dO V^T, P and dS,
//     dQ += dS K.

constexpr int kBwdRows = 128;  // the keys (dK / dV) or query rows (dQ) a block owns
constexpr int kDkdvQ = 32;     // query rows per tile of the dK / dV pass
constexpr int kDqWarps = 8;
constexpr int kDqKeys = 64;    // keys per tile of the dQ pass

template <int DP>
struct BwdCfg {
  static constexpr int kMT = DP == 64 ? 2 : 1;  // m-tiles a dK / dV warp owns
  static constexpr int kDkdvThreads = 32 * kBwdRows / (16 * kMT);
  static constexpr int kRowBytes = DP * 2;
  static constexpr int kOwnBytes = kBwdRows * kRowBytes;  // a [128][DP] tile
  static constexpr int kQTileBytes = kDkdvQ * kRowBytes;
  static constexpr int kKTileBytes = kDqKeys * kRowBytes;
  // K, V; then per stage Q, dO, logsumexp and D of kDkdvQ rows
  static constexpr int kDkdvStage = 2 * kQTileBytes + 2 * kDkdvQ * 4;
  static constexpr int kDkdvSmem = 2 * kOwnBytes + 2 * kDkdvStage;
  // Q, dO; then per stage K, V
  static constexpr int kDqSmem = 2 * kOwnBytes + 2 * 2 * kKTileBytes;
};

// Byte offset of (row, 16-byte chunk) in a swizzled tile of DP columns.
template <int DP>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * (DP * 2) + ((chunk ^ (row & 7)) * 16);
}

// Rows [row0, row0 + rows) of a (n, d) matrix into a swizzled tile by
// cp.async, zeros past n and past d; the block's threads share the copies.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int row0,
                                          int rows, int n, int d) {
  const int chunks = DP / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = idx % chunks;
    const bool valid = row0 + r < n && c * 8 < d;
    const __nv_bfloat16* at = valid ? src + static_cast<size_t>(row0 + r) * d + c * 8 : src;
    hopper::cp_async16(dst + swz<DP>(r, c), at, valid);
  }
}

// Per-row float32 values [row0, row0 + rows) by cp.async, zeros past n.
__device__ __forceinline__ void load_row_values(uint32_t dst, const float* src, int row0,
                                                int rows, int n) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const bool valid = row0 + r < n;
    hopper::cp_async4(dst + 4 * r, valid ? src + row0 + r : src, valid);
  }
}

// acc[mt] (16 x 8 NB) += A_mt . B^T for A_mt the 16 rows [a_row0 + 16 mt, +16)
// of tile `a` and B the rows [b_row0, + 8 NB) of tile `b`, k = the DP columns.
template <int DP, int MT, int NB>
__device__ __forceinline__ void product_abt(float (&acc)[MT][NB][4], uint32_t a, int a_row0,
                                            uint32_t b, int b_row0, int lane) {
  const int mi = lane / 8, lr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      hopper::ldsm_x4(af[mt],
                      a + swz<DP>(a_row0 + 16 * mt + (mi & 1) * 8 + lr, 2 * kk + (mi >> 1)));
    }
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t bf[4];
      hopper::ldsm_x4(bf, b + swz<DP>(b_row0 + np * 16 + (mi >> 1) * 8 + lr, 2 * kk + (mi & 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        hopper::mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
        hopper::mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// acc[mt] (16 x DP) += P_mt (16 x 16 KS, bfloat16 A fragments) . B for B the
// rows [b_row0, + 16 KS) of tile `b` (k = rows, n = the DP columns:
// ldmatrix.trans).
template <int DP, int MT, int KS>
__device__ __forceinline__ void product_pb(float (&acc)[MT][DP / 8][4],
                                           const uint32_t (&p)[MT][KS][4], uint32_t b,
                                           int b_row0, int lane) {
  const int mi = lane / 8, lr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t bf[4];
      hopper::ldsm_x4_t(bf, b + swz<DP>(b_row0 + kk * 16 + (mi & 1) * 8 + lr, 2 * np + (mi >> 1)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        hopper::mma_bf16(acc[mt][2 * np], p[mt][kk], bf[0], bf[1]);
        hopper::mma_bf16(acc[mt][2 * np + 1], p[mt][kk], bf[2], bf[3]);
      }
    }
}

// The m16n8 accumulators of MT x 16 x 16 KS values as bfloat16 A fragments.
template <int MT, int KS>
__device__ __forceinline__ void to_a_frags(uint32_t (&p)[MT][KS][4],
                                           const float (&x)[MT][2 * KS][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      p[mt][kk][0] = pack_bf16(x[mt][2 * kk][0], x[mt][2 * kk][1]);
      p[mt][kk][1] = pack_bf16(x[mt][2 * kk][2], x[mt][2 * kk][3]);
      p[mt][kk][2] = pack_bf16(x[mt][2 * kk + 1][0], x[mt][2 * kk + 1][1]);
      p[mt][kk][3] = pack_bf16(x[mt][2 * kk + 1][2], x[mt][2 * kk + 1][3]);
    }
}

template <int MT, int N>
__device__ __forceinline__ void zero(float (&x)[MT][N][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[mt][i][e] = 0.f;
}

// A warp's MT x 16 x DP float32 accumulators as bfloat16 rows [row0, +16 MT)
// of the (swizzled) tile at `tile`; the caller syncs and stores the tile.
template <int DP, int MT>
__device__ __forceinline__ void stage_rows(uint8_t* tile, int row0,
                                           const float (&acc)[MT][DP / 8][4], int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * mt + g + 8 * r;
        *reinterpret_cast<uint32_t*>(tile + swz<DP>(row, nb) + t * 4) =
            pack_bf16(acc[mt][nb][2 * r], acc[mt][nb][2 * r + 1]);
      }
}

// Rows [0, rows) of a swizzled tile to dst rows [row0, ...) of a (n, d)
// matrix, 16 bytes a thread, rows past n skipped.
template <int DP>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const uint8_t* tile, int row0,
                                           int rows, int n, int d, int first, int stride) {
  const int chunks = d / 8;
  for (int idx = first; idx < rows * chunks; idx += stride) {
    const int r = idx / chunks, c = idx % chunks;
    if (row0 + r >= n) continue;
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * d + c * 8) =
        *reinterpret_cast<const uint4*>(tile + swz<DP>(r, c));
  }
}

template <int DP>
__global__ void __launch_bounds__(BwdCfg<DP>::kDkdvThreads)
    flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              int n, int d, float scale_log2, float sm_scale) {
  using C = BwdCfg<DP>;
  constexpr int MT = C::kMT, kQ = kDkdvQ, NB = kQ / 8, KS = kQ / 16;
  extern __shared__ __align__(128) uint8_t smem_bwd[];
  const uint32_t k_s = smem_addr(smem_bwd), v_s = k_s + C::kOwnBytes;
  const uint32_t stage0 = v_s + C::kOwnBytes;
  const int bh = blockIdx.y, n0 = blockIdx.x * kBwdRows;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const float* lse_bh = lse + static_cast<size_t>(bh) * n;
  const float* delta_bh = delta + static_cast<size_t>(bh) * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int row0 = warp * 16 * MT;  // this warp's keys in the block's K / V tiles

  auto load_stage = [&](int i) {
    const uint32_t st = stage0 + (i & 1) * C::kDkdvStage;
    load_tile<DP>(st, q + base, i * kQ, kQ, n, d);
    load_tile<DP>(st + C::kQTileBytes, dout + base, i * kQ, kQ, n, d);
    load_row_values(st + 2 * C::kQTileBytes, lse_bh, i * kQ, kQ, n);
    load_row_values(st + 2 * C::kQTileBytes + kQ * 4, delta_bh, i * kQ, kQ, n);
  };
  load_tile<DP>(k_s, k + base, n0, kBwdRows, n, d);
  load_tile<DP>(v_s, v + base, n0, kBwdRows, n, d);
  load_stage(0);
  hopper::cp_async_commit();

  float dk_acc[MT][DP / 8][4], dv_acc[MT][DP / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  const int tiles = (n + kQ - 1) / kQ;
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      load_stage(i + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t q_t = stage0 + (i & 1) * C::kDkdvStage, do_t = q_t + C::kQTileBytes;
    const float* lse_t =
        reinterpret_cast<const float*>(smem_bwd + (q_t - k_s) + 2 * C::kQTileBytes);
    const float* delta_t = lse_t + kQ;

    // S^T (keys x queries) and dP^T
    float st[MT][NB][4], dpt[MT][NB][4];
    zero(st);
    zero(dpt);
    product_abt<DP, MT, NB>(st, k_s, row0, q_t, 0, lane);
    product_abt<DP, MT, NB>(dpt, v_s, row0, do_t, 0, lane);
    // P^T = exp2(S^T scale_log2 - lse2[query]), dS^T = P^T (dP^T - D[query])
    // scale; a query past n has P = 0
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nb + 2 * t + (e & 1);
        const bool valid = i * kQ + col < n;
        const float lse2 = lse_t[col] * kLog2e, dl = delta_t[col];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float p = valid ? exp2f(st[mt][nb][e] * scale_log2 - lse2) : 0.f;
          st[mt][nb][e] = p;
          dpt[mt][nb][e] = p * (dpt[mt][nb][e] - dl) * sm_scale;
        }
      }
    uint32_t pf[MT][KS][4];
    to_a_frags<MT, KS>(pf, st);
    product_pb<DP, MT, KS>(dv_acc, pf, do_t, 0, lane);
    to_a_frags<MT, KS>(pf, dpt);
    product_pb<DP, MT, KS>(dk_acc, pf, q_t, 0, lane);
    __syncthreads();  // this stage is read before the next iteration refills it
  }

  // dK and dV through this warp's rows of the K and V tiles
  stage_rows<DP, MT>(smem_bwd, row0, dk_acc, lane);
  stage_rows<DP, MT>(smem_bwd + C::kOwnBytes, row0, dv_acc, lane);
  __syncthreads();
  store_tile<DP>(dk + base, smem_bwd, n0, kBwdRows, n, d, threadIdx.x, blockDim.x);
  store_tile<DP>(dv + base, smem_bwd + C::kOwnBytes, n0, kBwdRows, n, d, threadIdx.x,
                 blockDim.x);
}

template <int DP>
__global__ void __launch_bounds__(32 * kDqWarps, 1)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int n, int d, float scale_log2,
                            float sm_scale) {
  using C = BwdCfg<DP>;
  constexpr int NB = kDqKeys / 8, KS = kDqKeys / 16;
  extern __shared__ __align__(128) uint8_t smem_bwd[];
  const uint32_t q_s = smem_addr(smem_bwd), do_s = q_s + C::kOwnBytes;
  const uint32_t stage0 = do_s + C::kOwnBytes;
  constexpr int kStageBytes = 2 * C::kKTileBytes;  // K, V
  const int bh = blockIdx.y, m0 = blockIdx.x * kBwdRows;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = warp * 16;

  auto load_stage = [&](int j) {
    const uint32_t st = stage0 + (j & 1) * kStageBytes;
    load_tile<DP>(st, k + base, j * kDqKeys, kDqKeys, n, d);
    load_tile<DP>(st + C::kKTileBytes, v + base, j * kDqKeys, kDqKeys, n, d);
  };
  load_tile<DP>(q_s, q + base, m0, kBwdRows, n, d);
  load_tile<DP>(do_s, dout + base, m0, kBwdRows, n, d);
  load_stage(0);
  hopper::cp_async_commit();

  // this thread's rows g and g + 8: logsumexp (log2 units; +inf past n,
  // so that P = 0) and D
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + row0 + g + 8 * r;
    lse2[r] = row < n ? lse[static_cast<size_t>(bh) * n + row] * kLog2e : INFINITY;
    dl[r] = row < n ? delta[static_cast<size_t>(bh) * n + row] : 0.f;
  }
  float dq_acc[1][DP / 8][4];
  zero(dq_acc);

  const int tiles = (n + kDqKeys - 1) / kDqKeys;
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      load_stage(j + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t k_t = stage0 + (j & 1) * kStageBytes, v_t = k_t + C::kKTileBytes;

    float s[1][NB][4], dp[1][NB][4];
    zero(s);
    zero(dp);
    product_abt<DP, 1, NB>(s, q_s, row0, k_t, 0, lane);
    product_abt<DP, 1, NB>(dp, do_s, row0, v_t, 0, lane);
    // P = exp2(S scale_log2 - lse2[row]) (0 for a key past n), dS = P (dP - D) scale
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = j * kDqKeys + 8 * nb + 2 * t + (e & 1);
        const float p = col < n ? exp2f(s[0][nb][e] * scale_log2 - lse2[r]) : 0.f;
        dp[0][nb][e] = p * (dp[0][nb][e] - dl[r]) * sm_scale;
      }
    uint32_t dsf[1][KS][4];
    to_a_frags<1, KS>(dsf, dp);
    product_pb<DP, 1, KS>(dq_acc, dsf, k_t, 0, lane);
    __syncthreads();  // this stage is read before the next iteration refills it
  }

  // dQ through this warp's own rows of the Q tile
  stage_rows<DP, 1>(smem_bwd, row0, dq_acc, lane);
  __syncwarp();
  store_tile<DP>(dq + base, smem_bwd + row0 * (DP * 2), m0 + row0, 16, n, d, lane, 32);
}

}  // namespace flash_bf16
}  // namespace sis
