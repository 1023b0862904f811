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
// float32 (flash_attention_f32.cuh), on the tensor cores in 3xTF32 (each
// operand split into a TF32 high and low part, three mma.sync.m16n8k8
// products: float32-class sums, whatever allow_tf32 says):
//   1. flash_fwd_split_kernel: a block per (batch * head, 64 query rows),
//      a warp per 16, K / V tiles of 64 keys by cp.async in a
//      double-buffered ring, Q's split fragments in registers, the online
//      softmax in registers and P from the accumulator straight into P V.
//   2. flash_bwd_delta_kernel<float>.
//   3. flash_bwd_dkdv_split_kernel: a block per 64 keys (a warp per 16),
//      32-row query tiles; S^T, dP^T, dV and dK, P^T and dS^T as they stand
//      the next product's A operand.
//   4. flash_bwd_dq_split_kernel: a block per 64 query rows, 32-key tiles:
//      S, dP, dQ. Two passes, no atomics: the same bits every run.
//
// Bound on the H100 (SXM, 700 W) at the shipped TransUNet's shape
// (B, heads, N, d) = (8, 12, 1024, 64):
//   forward: 4 B h N^2 d = 25.8 GFLOP; q, k, v and o of 12.6 MB each in
//     bfloat16 (50 MB): 0.026 ms at 989 TFLOP/s (bfloat16 tensor cores);
//     float32 in 3xTF32, three products each: 0.156 ms at 495 TFLOP/s
//     (TF32 tensor cores; 0.385 ms at 67 TFLOP/s on float32 FMAs);
//   backward: ~10 B h N^2 d = ~64.4 GFLOP (recomputing P and the products
//     dP, dV, dK, dQ): 0.065 ms in bfloat16, 0.39 ms in 3xTF32.
// The work is the products: bound by operations, not bytes. What holds the
// designs back (times: PERF.md, NVIDIA H100 80GB HBM3 at 700 W): bfloat16
// forward (~0.09 ms) the softmax's exp2 and float work per score (about as
// long as the two products at d = 64) and one block an SM. Every backward
// and the float32 forward (~0.51 ms; backward ~1.78 ms) run mma.sync, not
// wgmma, with operands re-read from shared memory by every warp; float32
// also splits each operand into hi and lo in every warp that reads it (some
// ten instructions execute for each mma, address arithmetic and splits most
// of them; forming the low parts alone takes 11-20 % of the time), and the
// backward's separate dQ pass recomputes S and dP (7 products where 5
// would do, the price of determinism).
#include <math.h>

#include "common.cuh"
#include "flash_attention_bf16.cuh"
#include "flash_attention_f32.cuh"

namespace {

constexpr int kDeltaThreads = 256;  // a warp per row
constexpr float kLog2e = 1.4426950408889634f;

// D[row] = sum_c dO[row, c] * O[row, c], one warp per row.
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kDeltaThreads / 32) + threadIdx.x / 32;
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

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int bh, int n, int d,
                         cudaStream_t stream) {
  const long long rows = static_cast<long long>(bh) * n;
  const int rows_per_block = kDeltaThreads / 32;
  const auto blocks = static_cast<unsigned int>((rows + rows_per_block - 1) / rows_per_block);
  flash_bwd_delta_kernel<T><<<blocks, kDeltaThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, d);
  return cudaGetLastError();
}

// Dynamic shared memory above 48 KB has to be allowed per kernel once.
template <typename Kernel>
cudaError_t allow_smem_bytes(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool valid_shape(int bh, int n, int d) {
  return bh > 0 && bh <= 65535 && n > 0 && d > 0 && d <= 128;
}

// ---------------------------------------------------------------------------
// float32: the 3xTF32 tensor-core kernels of flash_attention_f32.cuh

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int DP>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                           int bh, int n, int d, float sm_scale, cudaStream_t stream) {
  namespace ff = sis::flash_f32;
  using C = ff::Cfg<DP>;
  static const cudaError_t allowed = allow_smem_bytes(ff::flash_fwd_split_kernel<DP>, C::kFwdSmem);
  if (allowed != cudaSuccess) return allowed;
  // 16-byte copies and 8-byte stores need d % 4 == 0 and aligned tensors
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  const dim3 grid((n + ff::kRows - 1) / ff::kRows, bh);
  ff::flash_fwd_split_kernel<DP><<<grid, ff::kThreads, C::kFwdSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, n, d, sm_scale * kLog2e, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                           const float* lse, const void* dout, float* delta, void* dq, void* dk,
                           void* dv, int bh, int n, int d, float sm_scale, cudaStream_t stream) {
  namespace ff = sis::flash_f32;
  using C = ff::Cfg<DP>;
  static const cudaError_t allowed_dkdv =
      allow_smem_bytes(ff::flash_bwd_dkdv_split_kernel<DP>, C::kDkdvSmem);
  static const cudaError_t allowed_dq =
      allow_smem_bytes(ff::flash_bwd_dq_split_kernel<DP>, C::kDqSmem);
  if (allowed_dkdv != cudaSuccess) return allowed_dkdv;
  if (allowed_dq != cudaSuccess) return allowed_dq;
  cudaError_t err = launch_delta<float>(o, dout, delta, bh, n, d, stream);
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv);
  const dim3 grid((n + ff::kRows - 1) / ff::kRows, bh);
  const float scale_log2 = sm_scale * kLog2e;
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  ff::flash_bwd_dkdv_split_kernel<DP><<<grid, ff::kThreads, C::kDkdvSmem, stream>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), n, d,
      scale_log2, sm_scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ff::flash_bwd_dq_split_kernel<DP><<<grid, ff::kThreads, C::kDqSmem, stream>>>(
      fq, fk, fv, fdo, lse, delta, static_cast<float*>(dq), n, d, scale_log2, sm_scale, vec);
  return cudaGetLastError();
}

// d padded to DP = 32, 64 or 128
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                    int n, int d, float sm_scale, cudaStream_t s) {
  if (d <= 32) return launch_fwd_f32<32>(q, k, v, o, lse, bh, n, d, sm_scale, s);
  if (d <= 64) return launch_fwd_f32<64>(q, k, v, o, lse, bh, n, d, sm_scale, s);
  return launch_fwd_f32<128>(q, k, v, o, lse, bh, n, d, sm_scale, s);
}

cudaError_t bwd_f32(const void* q, const void* k, const void* v, const void* o, const float* lse,
                    const void* dout, float* delta, void* dq, void* dk, void* dv, int bh, int n,
                    int d, float sm_scale, cudaStream_t s) {
  if (d <= 32) {
    return launch_bwd_f32<32>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  if (d <= 64) {
    return launch_bwd_f32<64>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, n, d, sm_scale, s);
  }
  return launch_bwd_f32<128>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, n, d, sm_scale, s);
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
  cudaError_t err = launch_delta<bf16>(o, dout, delta, bh, n, d, stream);
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
