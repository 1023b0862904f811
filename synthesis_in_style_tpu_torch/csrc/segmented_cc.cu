// Connected-components labelling by union-find, in three kernels on one
// stream and with no host round trip:
//   1. local merge: one block per (image, 32x32 tile), one warp per tile row.
//      Each row run is linked to its first pixel from one __ballot_sync of
//      the row; then, in shared memory, only the first pixel of each overlap
//      between a run and a run of the row above unions the two. The block
//      writes each pixel's parent: the image-wide linear index (y * W + x) of
//      its tile-local root, -1 at background;
//   2. boundary merge: one thread per pixel of a tile's top row and left
//      column unions it, in device memory, with the runs across the tile
//      edge, by the same first-overlap rule;
//   3. flatten: label[i] = find(i).
// The union rule links the larger root under the smaller with atomicMin and
// retries on a lost race, so parents only ever decrease and every root is
// the smallest linear index of its component: exactly the fixpoint of the
// JAX package's label propagation, bit for bit, whatever order the blocks
// and threads run in. References: Playne & Hawick, "A New Algorithm for
// Parallel Connected-Component Labelling on GPUs" (IEEE TPDS 2018); Allegretti,
// Bolelli & Grana, block-based union-find (2019).
//
// Replaces the TPU kernel synthesis_in_style_tpu/ops/pallas/segmented_cc.py
// (cc_sweeps -> _sweep_kernel), which keeps a whole image in VMEM and sweeps
// segmented minima along rows and columns until a host-side loop sees no
// change. An earlier design of this file did the same from device memory
// (one thread per 256-px line, a changed flag read on the host every 4
// sweeps) and took ~4.98 ms per fixpoint at (32, 256, 256), 8-connected, on
// an H100 80GB HBM3 at 700 W: latency-bound dependent loads and host syncs.
//
// Bound on the H100: bytes (read the mask once, write the labels once). This
// design reads the mask once, writes the parents once, and touches them in
// two more passes that stay in L2 at the path's sizes (32 x 256 x 256 x 4 B
// = 8 MiB); the number of passes does not depend on the component shapes.
// What costs time is the union work of large components: the run prelink
// and the first-overlap rule cut a full 32x32 tile from ~2000 contended
// unions to 31 (a first version that united every neighbour pair took
// ~0.4 ms on the path's masks on an H100).
// Tiles do not have to fit the image: any (B, H, W) with H * W < 2^31 works,
// ragged tiles included.
#include "common.cuh"

namespace {

// Tile side, equal to the warp size: one warp per tile row, so a row's
// foreground is one __ballot_sync.
constexpr int kTile = 32;

// Root of x. Parents are read volatile: other threads lower them meanwhile.
__device__ __forceinline__ int find_root(const volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// Join the sets of a and b: the larger root is linked under the smaller by
// atomicMin. If the larger root was linked elsewhere meanwhile (the atomic
// returns another value), that link was just overwritten, so join its old
// parent too and go on until a union lands on a root.
// No path compression while unions run: a union acting on a root that was
// just linked elsewhere leaves a link to another set until its retry, and a
// compressing walk that follows such a link re-points nodes of one set into
// another and loses their own links (measured: wrong labels on random masks).
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

// Which unions join pixel x to the line of pixels before it (the row above,
// or, across a vertical tile edge, the column to the left), given that the
// pixels of each straight run along the line are joined already:
//   b: the neighbour straight across, a / c: the diagonal ones before /
//   after it, d: the pixel before x in x's own run direction (joined to x).
// Every pair of adjacent runs gets one union at its first overlapping pixel:
// if b is foreground, x joins b unless both a and d are (then the pixel
// before x, in the same run, joins the same run across); otherwise, under
// 8-connectivity, x joins a if d is background and joins c.
struct Links {
  bool b, a, c;
};
__device__ __forceinline__ Links links(bool a, bool b, bool c, bool d,
                                       int connectivity) {
  if (b) return {!(a && d), false, false};
  if (connectivity != 8) return {false, false, false};
  return {false, a && !d, c};
}

struct TileOf {
  int64_t image;  // offset of the image in the batch
  int ty, tx;
};

__device__ __forceinline__ TileOf tile_of(int block, int h, int w, int tiles_x,
                                          int tiles_y) {
  const int tiles = tiles_x * tiles_y;
  const int b = block / tiles;
  const int t = block % tiles;
  return {static_cast<int64_t>(b) * h * w, t / tiles_x, t % tiles_x};
}

__global__ void __launch_bounds__(kTile * kTile)
    cc_local_kernel(const uint8_t* __restrict__ mask, int* __restrict__ labels,
                    int h, int w, int tiles_x, int tiles_y, int connectivity) {
  __shared__ int parent[kTile * kTile];  // tile-local indices, -1 background
  __shared__ unsigned int row_fg[kTile];
  const TileOf t = tile_of(blockIdx.x, h, w, tiles_x, tiles_y);
  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int y = t.ty * kTile + ly, x = t.tx * kTile + lx;
  const bool inside = y < h && x < w;
  const int64_t at = t.image + static_cast<int64_t>(y) * w + x;
  const int li = threadIdx.x;
  const bool fg = inside && mask[at] != 0;
  // each row run starts linked to its first pixel: the one after the last
  // background pixel to the left
  const unsigned int bits = __ballot_sync(0xffffffffu, fg);
  if (lx == 0) row_fg[ly] = bits;
  const unsigned int bg_left = ~bits & ((1u << lx) - 1u);
  const int run_start = bg_left ? kTile - __clz(bg_left) : 0;
  parent[li] = fg ? ly * kTile + run_start : -1;
  __syncthreads();
  if (fg && ly > 0) {
    const unsigned int up = row_fg[ly - 1];
    const Links l = links(lx > 0 && ((up >> (lx - 1)) & 1u), (up >> lx) & 1u,
                          lx < kTile - 1 && ((up >> (lx + 1)) & 1u),
                          lx > 0 && ((bits >> (lx - 1)) & 1u), connectivity);
    if (l.b) unite(parent, li, li - kTile);
    if (l.a) unite(parent, li, li - kTile - 1);
    if (l.c) unite(parent, li, li - kTile + 1);
  }
  __syncthreads();
  if (!inside) return;
  int out = -1;
  if (fg) {
    // tile-local order is image order, so the local root is the component's
    // smallest index inside the tile
    const int r = find_root(parent, li);
    out = (t.ty * kTile + r / kTile) * w + t.tx * kTile + r % kTile;
  }
  labels[at] = out;
}

// Joins across tile edges, with the rule of `links`: threads 0..kTile-1 take
// the tile's top row against the row above (its own run direction along the
// row, the pixel before x counting only inside the tile); threads
// kTile..2*kTile-1 take its left column against the column to the left (run
// direction down the column, the pixel above counting only inside the tile).
// An 8-connected edge leaving the top-right or bottom-left corner is taken
// by the tile it enters. Foreground is read from the local pass's output.
__global__ void cc_boundary_kernel(int* __restrict__ labels, int h, int w,
                                   int tiles_x, int tiles_y, int connectivity) {
  const TileOf t = tile_of(blockIdx.x, h, w, tiles_x, tiles_y);
  const bool top = threadIdx.x < kTile;
  const int k = top ? threadIdx.x : threadIdx.x - kTile;
  const int y = t.ty * kTile + (top ? 0 : k), x = t.tx * kTile + (top ? k : 0);
  if (y >= h || x >= w || (top ? y == 0 : x == 0)) return;
  int* parent = labels + t.image;
  const int i = y * w + x;
  if (parent[i] < 0) return;
  auto fg = [&](int yy, int xx) {
    return yy >= 0 && yy < h && xx >= 0 && xx < w && parent[yy * w + xx] >= 0;
  };
  // across: the neighbour straight over the edge; step: one pixel along it
  const int ay = top ? y - 1 : y, ax = top ? x : x - 1;
  const int sy = top ? 0 : 1, sx = top ? 1 : 0;
  const bool before_in_tile = k > 0;
  const Links l = links(fg(ay - sy, ax - sx), fg(ay, ax), fg(ay + sy, ax + sx),
                        before_in_tile && fg(y - sy, x - sx), connectivity);
  if (l.b) unite(parent, i, ay * w + ax);
  if (l.a) unite(parent, i, (ay - sy) * w + ax - sx);
  if (l.c) unite(parent, i, (ay + sy) * w + ax + sx);
}

// label[i] = root of i. (Compressing the paths here as well measured slower:
// the run prelink and the few unions keep the trees shallow.)
__global__ void cc_flatten_kernel(int* __restrict__ labels, int batch, int h,
                                  int w) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t n = batch * hw;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int p = labels[i];
    if (p < 0) continue;
    labels[i] = find_root(labels + (i - i % hw), p);
  }
}

}  // namespace

// mask: (B, H, W) uint8 (nonzero = foreground); labels: (B, H, W) int32,
// written whole: -1 at background, else the smallest linear index y * W + x
// of the pixel's component. connectivity 4 or 8.
extern "C" int sis_cc_union_find(const void* mask, void* labels, int batch,
                                 int h, int w, int connectivity, void* stream) {
  if (connectivity != 4 && connectivity != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch < 0 || h < 0 || w < 0 ||
      static_cast<int64_t>(h) * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0 || w == 0) return 0;
  const int tiles_x = (w + kTile - 1) / kTile;
  const int tiles_y = (h + kTile - 1) / kTile;
  const int64_t blocks = static_cast<int64_t>(batch) * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* lab = static_cast<int*>(labels);
  cc_local_kernel<<<static_cast<unsigned int>(blocks), kTile * kTile, 0, s>>>(
      static_cast<const uint8_t*>(mask), lab, h, w, tiles_x, tiles_y,
      connectivity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cc_boundary_kernel<<<static_cast<unsigned int>(blocks), 2 * kTile, 0, s>>>(
      lab, h, w, tiles_x, tiles_y, connectivity);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(batch) * h * w;
  cc_flatten_kernel<<<sis::grid_for(n, 256), 256, 0, s>>>(lab, batch, h, w);
  return static_cast<int>(cudaGetLastError());
}
