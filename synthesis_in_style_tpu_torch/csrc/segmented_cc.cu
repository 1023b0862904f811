// Connected-components label sweeps: `sweeps` rounds of
//   {8-connectivity only: 3x3 min bridge; segmented min along H; segmented min along W}
// over a batch of (H, W) int32 label images (INF at background), setting a
// per-image `changed` flag. Driven to its fixpoint (every component labelled
// with the smallest linear index it contains) by the host loop in
// synthesis_in_style_tpu_torch/ops/cuda/segmented_cc.py.
//
// Replaces the TPU kernel synthesis_in_style_tpu/ops/pallas/segmented_cc.py
// (cc_sweeps -> _sweep_kernel with _segment_reach, _prop_axis and
// _neighbor_min_3x3). The TPU kernel keeps a whole image resident in VMEM
// and runs Hillis-Steele scans in registers; a 256x256 int32 image (256 KiB)
// does not fit in one H100 block's 227 KB of shared memory, so this design
// works from device memory and L2 instead.
//
// Bound on the H100: bytes. The least work is one read of the mask and one
// write of the labels; each sweep here reads and writes the labels about
// twice more (L2-resident at the main path's sizes: 32 x 256 x 256 x 4 B =
// 8 MiB). The design:
//   * the row kernel gives one thread one (image, row) and runs the
//     segmented min forward, then backward, in place over the mask runs;
//   * the column kernel gives one thread one (image, column); neighbouring
//     threads walk neighbouring columns, so every step is one coalesced load;
//   * the 8-connectivity bridge writes a second buffer (a 3x3 min cannot run
//     in place) and the host entry ping-pongs the two buffers, so an even
//     sweep count leaves the result in `labels`;
//   * a thread that lowered any label sets its image's flag with atomicOr.
// Labels only ever decrease towards the component minimum, so any sweep
// order reaches the same unique fixpoint as the XLA reference, bit for bit.
#include "common.cuh"

namespace {

constexpr int kInf = 0x7fffffff;

__global__ void cc_bridge8_kernel(const int* __restrict__ in,
                                  int* __restrict__ out,
                                  const uint8_t* __restrict__ mask,
                                  int* __restrict__ changed, int batch, int h,
                                  int w) {
  const int64_t n = static_cast<int64_t>(batch) * h * w;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!mask[i]) {
      out[i] = kInf;
      continue;
    }
    const int x = static_cast<int>(i % w);
    const int y = static_cast<int>((i / w) % h);
    const int own = in[i];
    int m = own;
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= h) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = x + dx;
        if (xx < 0 || xx >= w) continue;
        m = min(m, in[i + static_cast<int64_t>(dy) * w + dx]);
      }
    }
    out[i] = m;
    if (m != own) atomicOr(&changed[i / (static_cast<int64_t>(h) * w)], 1);
  }
}

// Segmented min along one line of `len` pixels spaced `step` apart, forward
// then backward; background pixels reset the running minimum.
__device__ __forceinline__ bool segmented_min_line(int* labels,
                                                   const uint8_t* mask,
                                                   int len, int64_t step) {
  bool lowered = false;
  int run = kInf;
  for (int k = 0; k < len; ++k) {
    const int64_t o = k * step;
    if (!mask[o]) {
      run = kInf;
      continue;
    }
    const int v = labels[o];
    if (run < v) {
      labels[o] = run;
      lowered = true;
    } else {
      run = v;
    }
  }
  run = kInf;
  for (int k = len - 1; k >= 0; --k) {
    const int64_t o = k * step;
    if (!mask[o]) {
      run = kInf;
      continue;
    }
    const int v = labels[o];
    if (run < v) {
      labels[o] = run;
      lowered = true;
    } else {
      run = v;
    }
  }
  return lowered;
}

__global__ void cc_rows_kernel(int* __restrict__ labels,
                               const uint8_t* __restrict__ mask,
                               int* __restrict__ changed, int batch, int h,
                               int w) {
  const int64_t lines = static_cast<int64_t>(batch) * h;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= lines) return;
  const int64_t base = r * w;
  if (segmented_min_line(labels + base, mask + base, w, 1))
    atomicOr(&changed[r / h], 1);
}

__global__ void cc_cols_kernel(int* __restrict__ labels,
                               const uint8_t* __restrict__ mask,
                               int* __restrict__ changed, int batch, int h,
                               int w) {
  const int64_t lines = static_cast<int64_t>(batch) * w;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= lines) return;
  const int64_t b = r / w;
  const int64_t base = b * h * w + (r % w);
  if (segmented_min_line(labels + base, mask + base, h, w))
    atomicOr(&changed[b], 1);
}

}  // namespace

// labels, scratch: (B, H, W) int32; mask: (B, H, W) uint8; changed: (B,)
// int32, ORed (not cleared) by this call. For connectivity 8, `sweeps` must
// be even so that the ping-pong between labels and scratch ends in labels.
extern "C" int sis_cc_sweeps(void* labels, void* scratch, const void* mask,
                             void* changed, int batch, int h, int w,
                             int connectivity, int sweeps, void* stream) {
  if (connectivity != 4 && connectivity != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (connectivity == 8 && sweeps % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(batch) * h * w;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* flags = static_cast<int*>(changed);
  int* cur = static_cast<int*>(labels);
  int* other = static_cast<int*>(scratch);
  const int threads = 128;
  const unsigned int row_blocks =
      static_cast<unsigned int>((static_cast<int64_t>(batch) * h + threads - 1) / threads);
  const unsigned int col_blocks =
      static_cast<unsigned int>((static_cast<int64_t>(batch) * w + threads - 1) / threads);
  for (int k = 0; k < sweeps; ++k) {
    if (connectivity == 8) {
      cc_bridge8_kernel<<<sis::grid_for(n, 256), 256, 0, s>>>(cur, other, m,
                                                             flags, batch, h, w);
      int* t = cur;
      cur = other;
      other = t;
    }
    cc_cols_kernel<<<col_blocks, threads, 0, s>>>(cur, m, flags, batch, h, w);
    cc_rows_kernel<<<row_blocks, threads, 0, s>>>(cur, m, flags, batch, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
