// Kernel B1: one cross-aggregation iteration over a (D, H, W) volume.
//
// Replaces adcensus_tpu/ops/cross_sum_pallas.py:_cross_pass_kernel (the
// masked-roll Pallas kernel launched by _cross_pass_pallas). For every
// (d, y, x): sum the plane along the first axis' per-pixel arms (x with
// left/right when horizontal-first, y with top/bottom otherwise), sum that
// result along the second axis' arms, then divide by the support count
// (reference: cross_aggregator.cpp:327-394).
//
// Bound on the H100: device memory. One iteration must read the volume
// once and write it once: 2 x 4 B per cell, 86.4 MB at 64x375x450, 0.0268
// ms at 3.35 TB/s. Its adds, (2*arm+1) per cell and pass, are far below
// the f32 rate. The Pallas kernel fuses both passes on a whole plane in
// VMEM; a 375x450 plane (675 KB) does not fit a block's 227 KB of shared
// memory, so this kernel tiles the plane:
//
// * One launch per iteration; the first pass's result lives only in
//   shared memory. A block owns a tile_y x tile_x output tile of PLANES
//   d-planes. It first reduces the tile's second-axis arms (clamped to
//   max_arm and the image) to the halo the tile needs on each side: how
//   far beyond the tile they reach. The halo follows the data and is not
//   always max_arm. The block sums the first axis over the tile and its
//   halo into shared memory, then the second axis from shared memory, and
//   writes only the output. Shared memory is sized on the host for halos
//   of max_arm (up to 255).
// * Arms and sup are read once per pixel and block and serve all of its
//   PLANES d-planes: each thread sums one pixel's window for PLANES planes
//   at once. The planes share the pixel's arms, so their chains of adds
//   are independent and of one length: the loads of PLANES planes, and of
//   4 steps (unrolled), are in flight together, with no per-output
//   predicate.
// * Index arithmetic is 32-bit from blockIdx / threadIdx, with one
//   division per thread and pass to place its first cell; the plane bases
//   are 64-bit pointers, made once per block. The caller guarantees
//   H * W < 2^31.
// * Launch geometry (tile sides, planes per block, threads, dynamic shared
//   bytes) comes from ops/cross_sum.py:cross_sum_geometry; this entry
//   point refuses a geometry whose shared memory is too small for it.
//   Registers are capped at 64 a thread (two blocks of 512 threads an SM).
//
// Order: every sum starts at +0.0f and adds its terms in ascending offset
// t = -lo .. hi, in the first pass (kept in shared memory) as in the
// second. The plain version adds a masked 0.0 for each offset outside the
// arm; a running sum from +0.0f is never -0.0f, so those adds are exact
// identities and both orders give the same bits. The division is IEEE '/'
// (built without fast math, with -fmad=false). Arms are int32 (H, W, 4) =
// left, right, top, bottom, capped at max_arm as the plain version caps
// its offsets, and clamped to the image so that no read leaves the volume
// (arms built by build_arms never cross the border).
#include "common.cuh"

namespace {

// Ceiling on one block's static + dynamic shared memory on the H100.
constexpr int kMaxSharedBytes = 232448;
// Most threads a block may have, and blocks of that size an SM must hold.
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;

// Cells of one plane of the first-pass buffer: the output tile widened by
// halos of up to max_arm along the second axis, never beyond the image.
// ops/cross_sum.py:plane_capacity is the same formula.
inline long long plane_capacity(int horizontal_first, int tile_x, int tile_y,
                                int H, int W, int max_arm) {
  const long long m = max_arm > 0 ? max_arm : 0;
  const long long along = (horizontal_first ? tile_y : tile_x) + 2 * m;
  const long long extent = horizontal_first ? H : W;
  return static_cast<long long>(horizontal_first ? tile_x : tile_y) *
         (along < extent ? along : extent);
}

// Cell (r, c) of a row-major grid with `cols` columns, visited from cell
// `start` in steps of `step` cells without a division per step.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int start, int step, int cols_) : cols(cols_) {
    r = start / cols;
    c = start - r * cols;
    dr = step / cols;
    dc = step - dr * cols;
  }
  __device__ void advance() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// (max of a, max of b) over the block; every thread must call it.
__device__ inline int2 block_max2(int a, int b, int (*red)[32]) {
  a = __reduce_max_sync(0xffffffffu, a);
  b = __reduce_max_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  int2 m = make_int2(0, 0);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    m.x = max(m.x, red[0][w]);
    m.y = max(m.y, red[1][w]);
  }
  return m;
}

// HF: horizontal-first (first pass along x, second along y). PLANES: the
// d-planes a block handles, summed together by each thread.
template <bool HF, int PLANES>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    cross_pass_kernel(const float* __restrict__ vol,
                      const int* __restrict__ arms,
                      const float* __restrict__ sup, float* __restrict__ out,
                      int D, int H, int W, int max_arm, int normalize,
                      int tile_x, int tile_y, int tiles_x, int plane_cap) {
  extern __shared__ float buf[];  // PLANES x plane_cap first-pass sums
  __shared__ int red[2][32];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int tile_row = blockIdx.x / tiles_x;
  const int x0 = (blockIdx.x - tile_row * tiles_x) * tile_x;
  const int y0 = tile_row * tile_y;
  const int tw = min(tile_x, W - x0);
  const int th = min(tile_y, H - y0);
  const int HW = H * W;

  // Planes p0 .. p0 + PLANES - 1; past D, the last plane is summed again
  // and not stored.
  const int p0 = blockIdx.y * PLANES;
  const float* src[PLANES];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
    src[p] = vol + static_cast<size_t>(min(p0 + p, D - 1)) * HW;

  // The halo: how far the output tile's second-axis arms reach beyond the
  // tile on each side.
  const int n_out = tw * th;
  int lo_need = 0, hi_need = 0;
  {
    Walk q(tid, nt, tw);
    for (int i = tid; i < n_out; i += nt, q.advance()) {
      const int x = x0 + q.c, y = y0 + q.r;
      const int* a = arms + static_cast<size_t>(y * W + x) * 4;
      if (HF) {
        lo_need = max(lo_need, min(min(a[2], max_arm), y) - q.r);
        hi_need = max(hi_need,
                      min(min(a[3], max_arm), H - 1 - y) - (th - 1 - q.r));
      } else {
        lo_need = max(lo_need, min(min(a[0], max_arm), x) - q.c);
        hi_need = max(hi_need,
                      min(min(a[1], max_arm), W - 1 - x) - (tw - 1 - q.c));
      }
    }
  }
  const int2 halo = block_max2(lo_need, hi_need, red);

  // First pass over the region (rows x cols, row-major in buf) at
  // (ry0, rx0): the tile widened by the halo along the second axis.
  const int rows = HF ? th + halo.x + halo.y : th;
  const int cols = HF ? tw : tw + halo.x + halo.y;
  const int ry0 = HF ? y0 - halo.x : y0;
  const int rx0 = HF ? x0 : x0 - halo.x;
  {
    Walk q(tid, nt, cols);
    for (int i = tid; i < rows * cols; i += nt, q.advance()) {
      const int x = rx0 + q.c, y = ry0 + q.r;
      const int pix = y * W + x;
      const int* a = arms + static_cast<size_t>(pix) * 4;
      int lo, hi, stride;
      if (HF) {
        lo = min(min(a[0], max_arm), x);
        hi = min(min(a[1], max_arm), W - 1 - x);
        stride = 1;
      } else {
        lo = min(min(a[2], max_arm), y);
        hi = min(min(a[3], max_arm), H - 1 - y);
        stride = W;
      }
      float acc[PLANES];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) acc[p] = 0.0f;
      int o = pix - lo * stride;
#pragma unroll 4
      for (int t = -lo; t <= hi; ++t, o += stride) {
#pragma unroll
        for (int p = 0; p < PLANES; ++p) acc[p] += src[p][o];
      }
#pragma unroll
      for (int p = 0; p < PLANES; ++p) buf[p * plane_cap + i] = acc[p];
    }
  }
  __syncthreads();

  // Second pass over the output tile, from the first-pass buffer.
  Walk q(tid, nt, tw);
  for (int i = tid; i < n_out; i += nt, q.advance()) {
    const int y = y0 + q.r, x = x0 + q.c;
    const int pix = y * W + x;
    const int* a = arms + static_cast<size_t>(pix) * 4;
    int lo, hi, o, stride;
    if (HF) {
      lo = min(min(a[2], max_arm), y);
      hi = min(min(a[3], max_arm), H - 1 - y);
      o = (q.r + halo.x - lo) * cols + q.c;
      stride = cols;
    } else {
      lo = min(min(a[0], max_arm), x);
      hi = min(min(a[1], max_arm), W - 1 - x);
      o = q.r * cols + q.c + halo.x - lo;
      stride = 1;
    }
    float acc[PLANES];
#pragma unroll
    for (int p = 0; p < PLANES; ++p) acc[p] = 0.0f;
#pragma unroll 4
    for (int t = -lo; t <= hi; ++t, o += stride) {
#pragma unroll
      for (int p = 0; p < PLANES; ++p) acc[p] += buf[p * plane_cap + o];
    }
    const float s = normalize ? sup[pix] : 1.0f;
#pragma unroll
    for (int p = 0; p < PLANES; ++p) {
      if (p0 + p < D)
        out[static_cast<size_t>(p0 + p) * HW + pix] =
            normalize ? acc[p] / s : acc[p];
    }
  }
}

struct Args {
  const float* vol;
  const int* arms;
  const float* sup;
  float* out;
  int D, H, W, max_arm, normalize, tile_x, tile_y, threads, smem,
      plane_cap;
};

template <bool HF, int PLANES>
int launch(const Args& g, cudaStream_t s) {
  auto kernel = cross_pass_kernel<HF, PLANES>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles_x = (g.W + g.tile_x - 1) / g.tile_x;
  const int tiles_y = (g.H + g.tile_y - 1) / g.tile_y;
  const dim3 grid(tiles_x * tiles_y, (g.D + PLANES - 1) / PLANES);
  kernel<<<grid, g.threads, g.smem, s>>>(
      g.vol, g.arms, g.sup, g.out, g.D, g.H, g.W, g.max_arm, g.normalize,
      g.tile_x, g.tile_y, tiles_x, g.plane_cap);
  return static_cast<int>(cudaGetLastError());
}

template <bool HF>
int launch_planes(int planes, const Args& g, cudaStream_t s) {
  switch (planes) {
    case 1: return launch<HF, 1>(g, s);
    case 2: return launch<HF, 2>(g, s);
    case 4: return launch<HF, 4>(g, s);
    case 8: return launch<HF, 8>(g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// tile_x, tile_y, planes (1, 2, 4 or 8), threads (a multiple of 32, at
// most 512) and smem (dynamic shared bytes) are the launch geometry of
// cross_sum_geometry. A geometry whose smem is short of what its tiles
// need, or that exceeds the card's limit, is refused with
// cudaErrorInvalidValue before any launch.
ADC_EXPORT int adc_cross_sum(const float* vol, const int* arms,
                             const float* sup, float* out, int D, int H,
                             int W, int max_arm, int horizontal_first,
                             int normalize, int tile_x, int tile_y,
                             int planes, int threads, int smem,
                             void* stream) {
  if (static_cast<long long>(D) * H * W == 0) return 0;
  if (D < 0 || H < 0 || W < 0 || tile_x < 1 || tile_y < 1 || planes < 1 ||
      (D + planes - 1) / planes > 65535 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || smem < 0 ||
      static_cast<long long>(H) * W >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cap = plane_capacity(horizontal_first, tile_x, tile_y, H,
                                       W, max_arm);
  if (cap * planes * 4 > smem ||
      smem + static_cast<int>(sizeof(int) * 64) > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args g{vol,       arms,    sup,       out,    D,      H,
               W,         max_arm, normalize, tile_x, tile_y, threads,
               smem,      static_cast<int>(cap)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return horizontal_first ? launch_planes<true>(planes, g, s)
                          : launch_planes<false>(planes, g, s);
}
