// Kernel M2: depth-discontinuity adjustment of edge pixels.
//
// Replaces adcensus_tpu/stages/refine.py:depth_discontinuity_adjustment,
// a lax.scan over columns (not a Pallas kernel); the reference is
// multistep_refiner.cpp:307-352. At an edge pixel (y, x) of the interior
// whose disparity d is finite with lround(d) in [0, D), starting from
// c0 = cost[lround(d), y, x]:
//   the left neighbour's final value dl (already adjusted) replaces d
//   if its index is in range and cost[lround(dl), y, x-1] < c0, which
//   then becomes c0;
//   the right neighbour's original value dr replaces it if its index is
//   in range and cost[lround(dr), y, x+1] < c0.
// The cost is indexed by lround(d) (half away from zero) without
// subtracting min_disparity, as the reference does.
//
// Bound on the H100. The function reads the map, the edge mask and three
// cost cells an adjusted pixel, and writes the map (9 B a pixel and 12 B
// an edge pixel). What bounds it is the recurrence along each row: column
// x needs column x-1's final value, so a row is a chain of W steps, each
// with a data-dependent gather from the (D, H, W) volume at an edge
// pixel.
//
// Design: one thread a row, scanning x = 0 .. W-1 and carrying column
// x-1's final value, its index and whether the index is in range; the
// left cost is gathered only where a pixel is adjusted. Rows are
// independent, so the rows' chains overlap across threads. It only
// compares and selects, so it equals the plain version bit for bit. No
// host sync and no allocation: the kernel runs inside a CUDA graph
// capture.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// lround(v) (half away from zero) in [0, D) for a finite v: the index and
// whether it is in range, as ops/dda.py:_rounded_idx.
__device__ __forceinline__ bool index_of(float v, int D, int* di) {
  if (!isfinite(v)) return false;
  *di = static_cast<int>(v >= 0.0f ? floorf(v + 0.5f) : ceilf(v - 0.5f));
  return *di >= 0 && *di < D;
}

__global__ void __launch_bounds__(kThreads)
    dda_kernel(const float* __restrict__ disp, const float* __restrict__ cost,
               const uint8_t* __restrict__ edge, float* __restrict__ out,
               int D, int H, int W) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (y >= H) return;
  const long long plane = static_cast<long long>(H) * W;
  const long long row = static_cast<long long>(y) * W;
  const float* crow = cost + row;  // cost[d, y, x] = crow[d * plane + x]
  float prev_d = 0.0f;
  int prev_i = 0;
  bool prev_ok = false;
  for (int x = 0; x < W; ++x) {
    const float d = disp[row + x];
    int di = 0;
    const bool own_ok = index_of(d, D, &di);
    float out_d = d;
    if (own_ok && x >= 1 && x <= W - 2 && edge[row + x]) {
      float c0 = crow[di * plane + x];
      if (prev_ok) {
        const float cl = crow[prev_i * plane + x - 1];
        if (cl < c0) {
          out_d = prev_d;
          c0 = cl;
        }
      }
      const float dr = disp[row + x + 1];
      int ri = 0;
      if (index_of(dr, D, &ri) && crow[ri * plane + x + 1] < c0) out_d = dr;
    }
    out[row + x] = out_d;
    prev_d = out_d;
    prev_ok = index_of(out_d, D, &prev_i);
  }
}

}  // namespace

// The adjusted (H, W) float32 map of `disp` into `out` (a different
// buffer): cost is (D, H, W) float32, edge (H, W) bytes, 0 or 1. One
// thread a row. D < 1, H < 0 or W < 0 is refused with
// cudaErrorInvalidValue.
ADC_EXPORT int adc_dda(const float* disp, const float* cost,
                       const uint8_t* edge, float* out, int D, int H, int W,
                       void* stream) {
  if (D < 1 || H < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0 || W == 0) return 0;
  dda_kernel<<<adc_blocks(H, kThreads), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(disp, cost, edge, out, D,
                                                    H, W);
  return static_cast<int>(cudaGetLastError());
}
