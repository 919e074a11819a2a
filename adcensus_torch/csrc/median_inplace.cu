// Kernel M1: the reference's in-place 3x3 median.
//
// Replaces adcensus_tpu/stages/refine.py:median_filter_3x3_inplace, a
// lax.scan over the W + 2H columns of the sheared map (not a Pallas
// kernel); the reference is adcensus_util.cpp:55-81 called with in == out
// at multistep_refiner.cpp:86. Pixel (y, x) takes the median of its
// border-clipped 3x3 window in raster order: the filtered values at
// (y, x-1), (y-1, x-1), (y-1, x) and (y-1, x+1), the original values
// elsewhere. Out-of-image slots are +inf, and the median is the
// (population // 2)-th smallest of the nine, the population (4, 6 or 9,
// fewer on a map one pixel wide or high) counting in-image +inf values.
//
// Bound on the H100. The function reads and writes the map once (8 B a
// pixel, 0.0004 ms at Cone size at 3.35 TB/s) and sorts nine values a
// pixel. What bounds it is the recurrence: under t = x + 2y, every
// filtered value a pixel reads lies on wavefronts t-1 to t-3, so the
// W + 2H - 2 wavefronts run one after another.
//
// Design: one block a map, a thread a row (rows y, y + blockDim, ... so
// that maps higher than 1024 rows work). Wavefront t is the pixels with
// x = t - 2y; each thread that owns one reads its nine values, sorts them
// by an odd-even transposition network of min/max pairs, writes the median
// into `out`, and the block meets at one __syncthreads before wavefront
// t + 1. Pixels of one wavefront never read each other. The barrier makes
// the stores of wavefront t visible to the reads of t + 1 within the
// block, and the originals come from `in`, which nothing writes, so the
// map is filtered in place in the output buffer without a copy. No host
// sync and no allocation: the kernel runs inside a CUDA graph capture.
//
// The network picks the same value as the plain version's torch.sort for
// any map without NaN and without -0.0 and +0.0 in one window (their
// order is defined by neither).
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void order(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__global__ void __launch_bounds__(kMaxThreads)
    median_inplace_kernel(const float* __restrict__ in, float* out, int H,
                          int W) {
  const float inf = __int_as_float(0x7f800000);
  const int n_waves = W + 2 * (H - 1);
  for (int t = 0; t < n_waves; ++t) {
    for (int y = threadIdx.x; y < H; y += blockDim.x) {
      const int x = t - 2 * y;
      if (x < 0 || x >= W) continue;
      const bool up = y > 0, down = y < H - 1;
      const bool left = x > 0, right = x < W - 1;
      const int p = y * W + x;
      float v[9];
      // filtered: written on wavefronts t-1 (left, up-right), t-2 (up),
      // t-3 (up-left)
      v[0] = left ? out[p - 1] : inf;
      v[1] = up && right ? out[p - W + 1] : inf;
      v[2] = up ? out[p - W] : inf;
      v[3] = up && left ? out[p - W - 1] : inf;
      // original: this pixel and those of later wavefronts
      v[4] = in[p];
      v[5] = right ? in[p + 1] : inf;
      v[6] = down && left ? in[p + W - 1] : inf;
      v[7] = down ? in[p + W] : inf;
      v[8] = down && right ? in[p + W + 1] : inf;
#pragma unroll
      for (int round = 0; round < 9; ++round) {
#pragma unroll
        for (int i = round & 1; i + 1 < 9; i += 2) order(v[i], v[i + 1]);
      }
      const int rank = ((1 + up + down) * (1 + left + right)) / 2;
      float med = v[0];
#pragma unroll
      for (int k = 1; k <= 4; ++k) med = rank == k ? v[k] : med;
      out[p] = med;
    }
    __syncthreads();
  }
}

}  // namespace

// The in-place median of the (H, W) float32 map `in` into `out` (a
// different buffer of the same size). One block of up to 1024 threads.
// H < 1 or W < 1 and H * W >= 2^31 are refused with cudaErrorInvalidValue.
ADC_EXPORT int adc_median_inplace(const float* in, float* out, int H, int W,
                                  void* stream) {
  if (H < 1 || W < 1 || static_cast<long long>(H) * W >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = H < kMaxThreads ? (H + 31) / 32 * 32 : kMaxThreads;
  median_inplace_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
