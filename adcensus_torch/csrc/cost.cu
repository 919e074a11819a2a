// Kernels C1 (census) and C2 (the AD-Census cost volume): the cost stage.
//
// Replace the plain PyTorch bodies of adcensus_torch/stages/cost.py
// (census_transform_9x7_plain, compute_cost_planes_plain), which port
// adcensus_tpu/stages/cost.py (jnp, not a Pallas kernel); the reference
// is cost_computor.cpp:58-137 and adcensus_util.cpp:10-53.
//
// C1, census: (H, W) uint8 gray -> (H, W) int64 signatures. A block
// takes a tile of kCensusTx x kCensusTy pixels, a thread a pixel. It
// stages the tile with its 4-row and 3-column halo in shared memory,
// zero outside the array (the plain version's shift fill); each thread
// then compares its 63 neighbours with its own value, row -4..4 outer,
// column -3..3 inner, the first comparison at bit 62. The border is
// judged in the image's coordinates (row_offset, full_h, full_w: the
// sharded layer's slab mode), and every signature is zero for an image
// no wider than 9 or no taller than 7.
//
// C2, cost volume: (d_count, H, W) float32 from the (H, W, 3) uint8
// images and their census. Plane i samples the right image at column
// xr = x - d with d = d_first + i (d_first = d0 + min_disparity); a column
// xr < 0 or xr >= real_w costs exactly 1.0, any other
//   A[|dR| + |dG| + |dB|] - C[popcount(census_l ^ census_r)]
// with the right pixel and census read at clamp(xr, 0, W - 1). A and C are
// float32 tables of 766 and 64 entries that the caller builds with the
// plain version's own operations (stages/cost.py:cost_tables), so the one
// float32 subtraction here rounds as the plain version's last one does
// and the volume is bitwise the plain version's: the kernel never
// evaluates exp.
//
// Bound on the H100: it writes 4 bytes an output and reads a few bytes a
// pixel, so it is write-bound (0.142 ms for KITTI's 477 MB at 3.35 TB/s).
//
// Design: a block owns one row, kTile columns and up to kPlanes planes;
// kTile / V threads, each on V consecutive columns (V = 4, 2 or 1, the
// largest that divides W, chosen by ops/cost.py:cost_volume_geometry, so
// that a thread stores its V outputs of a plane as one aligned vector and
// a warp's stores are contiguous). The
// block stages once in shared memory the right image's pixels (RGB packed
// in 4 bytes) and census words of the kTile + kPlanes - 1 columns its
// planes reach, clamped, and the two tables. Staged column s sits at
// (s % V) * lane_stride + s / V, so the warp's reads of one plane are
// consecutive words. A thread keeps its left pixels and census in
// registers and a window of V right pixels and census words: from one
// plane to the next, xr falls by one for every column, so the window
// shifts by one and one new column is read.
// What sets its time is the order of the writes, not the arithmetic: a
// kernel of the same grid that only stores takes most of its time. The
// blocks in flight write kPlanes separate stretches of the volume each;
// fewer planes a block keep them fewer, more cost more staging a
// plane, and streaming stores (st.global.cs, evict first) write faster.
// On the H100 at the KITTI size, 512 columns and 16 planes with streaming
// stores took 0.19 ms against 0.26 for 256 and 32 with plain stores, and
// the next stage's pass over the volume (kernel B1) was not slower after
// them at either size, the Cone volume being read back from L2 in both.
// No host sync and no allocation: both run inside a CUDA graph capture.
#include "common.cuh"

namespace {

// ops/cost.py holds the same constants (without the k)
constexpr int kCensusTx = 64;  // C1: columns a block
constexpr int kCensusTy = 4;   // C1: rows a block
constexpr int kRowR = 4;       // census window: rows -4..4
constexpr int kColR = 3;       //                columns -3..3
constexpr int kTile = 512;     // C2: columns a block
constexpr int kPlanes = 16;    // C2: planes a block at most
constexpr int kAdValues = 766;  // |dR| + |dG| + |dB| in 0..765
constexpr int kCenValues = 64;  // popcount of 63 bits in 0..63

__global__ void __launch_bounds__(kCensusTx * kCensusTy)
census_kernel(const uint8_t* __restrict__ gray, long long* __restrict__ out,
              int H, int W, int row_offset, int full_h, int full_w) {
  constexpr int kTw = kCensusTx + 2 * kColR;
  constexpr int kTh = kCensusTy + 2 * kRowR;
  __shared__ uint8_t tile[kTh][kTw];
  const int x0 = blockIdx.x * kCensusTx;
  const int y0 = blockIdx.y * kCensusTy;
  const int tid = threadIdx.y * kCensusTx + threadIdx.x;
  for (int i = tid; i < kTh * kTw; i += kCensusTx * kCensusTy) {
    const int gy = y0 + i / kTw - kRowR;
    const int gx = x0 + i % kTw - kColR;
    tile[i / kTw][i % kTw] =
        (gy >= 0 && gy < H && gx >= 0 && gx < W)
            ? gray[static_cast<long long>(gy) * W + gx]
            : 0;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int iy = row_offset + y;  // the row in the image's coordinates
  const bool valid = full_w > 9 && full_h > 7 && iy >= kRowR &&
                     iy < full_h - kRowR && x >= kColR && x < full_w - kColR;
  long long sig = 0;
  if (valid) {
    const uint8_t center = tile[threadIdx.y + kRowR][threadIdx.x + kColR];
#pragma unroll
    for (int r = 0; r < 2 * kRowR + 1; ++r)
#pragma unroll
      for (int c = 0; c < 2 * kColR + 1; ++c)
        sig = (sig << 1) |
              static_cast<long long>(tile[threadIdx.y + r][threadIdx.x + c] <
                                     center);
  }
  out[static_cast<long long>(y) * W + x] = sig;
}

__device__ __forceinline__ uint32_t rgb_word(const uint8_t* __restrict__ px) {
  return static_cast<uint32_t>(px[0]) | (static_cast<uint32_t>(px[1]) << 8) |
         (static_cast<uint32_t>(px[2]) << 16);
}

// a thread's V outputs of a plane, one aligned streaming store
template <int V>
__device__ __forceinline__ void store_outputs(float* p, const float* v) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (V == 2)
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  else
    __stcs(p, v[0]);
}

template <int V>
__global__ void __launch_bounds__(kTile / V)
cost_volume_kernel(const uint8_t* __restrict__ left,
                   const uint8_t* __restrict__ right,
                   const long long* __restrict__ cen_l,
                   const long long* __restrict__ cen_r,
                   const float* __restrict__ ad_table,
                   const float* __restrict__ cen_table,
                   float* __restrict__ out, int H, int W, int d_count,
                   int d_first, int real_w, int tiles) {
  constexpr int kSpan = kTile + kPlanes - 1;  // staged columns
  constexpr int kLane = (kSpan + V - 1) / V;  // staged columns a residue
  __shared__ uint32_t s_rgb[V * kLane];
  __shared__ long long s_cen[V * kLane];
  __shared__ float s_ad[kAdValues];
  __shared__ float s_ct[kCenValues];
  const int t = threadIdx.x;
  const int y = blockIdx.x / tiles;
  const int tx0 = (blockIdx.x % tiles) * kTile;
  const int i0 = blockIdx.y * kPlanes;
  const int n_planes = min(kPlanes, d_count - i0);
  // staged column s is image column lo + s, clamped
  const int lo = tx0 - (d_first + i0) - (kPlanes - 1);
  const long long row = static_cast<long long>(y) * W;
  for (int s = t; s < kSpan; s += kTile / V) {
    const long long p = row + min(max(lo + s, 0), W - 1);
    const int at = (s % V) * kLane + s / V;
    s_rgb[at] = rgb_word(right + 3 * p);
    s_cen[at] = __ldg(cen_r + p);
  }
  for (int k = t; k < kAdValues; k += kTile / V) s_ad[k] = __ldg(ad_table + k);
  for (int k = t; k < kCenValues; k += kTile / V) s_ct[k] = __ldg(cen_table + k);
  __syncthreads();
  const int xg = tx0 + V * t;
  if (xg >= W) return;
  uint32_t l_rgb[V], r_rgb[V];
  long long l_cen[V], r_cen[V];
  // the window of plane i0: staged columns s0 + j
  const int s0 = V * t + (kPlanes - 1);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    l_rgb[j] = rgb_word(left + 3 * (row + xg + j));
    l_cen[j] = __ldg(cen_l + row + xg + j);
    const int s = s0 + j;
    r_rgb[j] = s_rgb[(s % V) * kLane + s / V];
    r_cen[j] = s_cen[(s % V) * kLane + s / V];
  }
  float* dst = out + (static_cast<long long>(i0) * H + y) * W + xg;
  const long long plane = static_cast<long long>(H) * W;
  for (int i = 0; i < n_planes; ++i) {
    const int d = d_first + i0 + i;
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int xr = xg + j - d;
      const unsigned k = __vsadu4(l_rgb[j], r_rgb[j]);
      // signatures hold 63 bits; the mask keeps h a table index whatever
      // bit 63 holds
      const int h = __popcll(static_cast<unsigned long long>(
          (l_cen[j] ^ r_cen[j]) & 0x7fffffffffffffffll));
      v[j] = (xr < 0 || xr >= real_w) ? 1.0f : s_ad[k] - s_ct[h];
    }
    store_outputs<V>(dst, v);
    dst += plane;
    // plane i + 1 reads every column one to the left: shift the window
#pragma unroll
    for (int j = V - 1; j > 0; --j) {
      r_rgb[j] = r_rgb[j - 1];
      r_cen[j] = r_cen[j - 1];
    }
    const int s = s0 - (i + 1);
    if (s >= 0) {
      r_rgb[0] = s_rgb[(s % V) * kLane + s / V];
      r_cen[0] = s_cen[(s % V) * kLane + s / V];
    }
  }
}

}  // namespace

ADC_EXPORT int adc_census(const uint8_t* gray, long long* out, int H, int W,
                          int row_offset, int full_h, int full_w,
                          void* stream) {
  if (H < 0 || W < 0 || static_cast<long long>(H) * W >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0 || W == 0) return 0;
  const dim3 grid(adc_blocks(W, kCensusTx), adc_blocks(H, kCensusTy));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  census_kernel<<<grid, dim3(kCensusTx, kCensusTy), 0,
                  static_cast<cudaStream_t>(stream)>>>(
      gray, out, H, W, row_offset, full_h, full_w);
  return static_cast<int>(cudaGetLastError());
}

// d_first = d0 + min_disparity, the disparity of plane 0; cols, the
// columns a thread (ops/cost.py:cost_volume_geometry), divides W
ADC_EXPORT int adc_cost_volume(const uint8_t* left, const uint8_t* right,
                               const long long* cen_l,
                               const long long* cen_r,
                               const float* ad_table, const float* cen_table,
                               float* out, int H, int W, int d_count,
                               int d_first, int real_w, int cols,
                               void* stream) {
  const long long tiles = (static_cast<long long>(W) + kTile - 1) / kTile;
  if (H < 0 || W < 0 || d_count < 0 ||
      static_cast<long long>(H) * W >= (1ll << 31) || tiles * H >= (1ll << 31) ||
      (d_count + kPlanes - 1) / kPlanes > 65535 ||
      (cols != 1 && cols != 2 && cols != 4) || W % cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0 || W == 0 || d_count == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(tiles) * H,
                  (d_count + kPlanes - 1) / kPlanes);
  const int t = static_cast<int>(tiles);
  if (cols == 4)
    cost_volume_kernel<4><<<grid, kTile / 4, 0, s>>>(
        left, right, cen_l, cen_r, ad_table, cen_table, out, H, W, d_count,
        d_first, real_w, t);
  else if (cols == 2)
    cost_volume_kernel<2><<<grid, kTile / 2, 0, s>>>(
        left, right, cen_l, cen_r, ad_table, cen_table, out, H, W, d_count,
        d_first, real_w, t);
  else
    cost_volume_kernel<1><<<grid, kTile, 0, s>>>(
        left, right, cen_l, cen_r, ad_table, cen_table, out, H, W, d_count,
        d_first, real_w, t);
  return static_cast<int>(cudaGetLastError());
}
