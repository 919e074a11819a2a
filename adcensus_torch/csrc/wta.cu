// Kernel W1: winner-take-all over d and the parabola, both views in one
// pass over the (D, H, W) float32 cost volume -> two (H, W) float32 maps.
//
// Replaces the plain PyTorch bodies of adcensus_torch/stages/wta.py
// (wta_left, wta_right), which port adcensus_tpu/stages/wta.py. That
// stage is jnp, not a Pallas kernel, so no TPU kernel corresponds to W1:
// it was added because the plain right view is a Python loop of about
// five device operations a plane (about 5 D launches a pair), and the
// left view's argmin and gathers read the volume again.
//
// What it computes, for each pixel (y, x), min_disparity m and the width
// real_w of the real image (columns at or beyond it, and below 0, read
// as Large_Float):
//   left view:  v(d) = cost(d, y, x); the first minimum over d, NaN first
//               as argmin takes it; Invalid_Float (+inf) where the winner
//               is 0 or D - 1, else the parabola over v(d - 1), v(d + 1);
//   right view: v(d) = cost(d, y, x + d + m); a running first minimum
//               that starts at Large_Float (a value is taken only if
//               below it); where the winner is 0 or D - 1 its integer
//               disparity, else the parabola.
// The parabola's neighbours are the previous value the scan saw and the
// next one, so no gather is needed. The parabola is _parabola's float32
// operations in its order; the build has -fmad=false, so each rounds as
// the plain version's does and both maps are bitwise the plain ones.
//
// Bound on the H100: one read of the volume (0.142 ms for KITTI's 477 MB
// at 3.35 TB/s) and two small maps written; about 20 operations a cell.
//
// Design: a thread a column x of one row, both views. A warp's left loads
// of one plane are 128 contiguous bytes; its right loads are the same row
// shifted by d + m, which the block itself, or the blocks beside it on
// the same row, load at about the same time, so they come mostly from L1
// or L2 and device memory sees the volume about once. The d loop loads
// kUnroll planes of both views before it runs their compare chain, so
// that many loads are in flight. No shared memory. The launch geometry
// follows from (H, W): kThreads columns a block, a block a row.
// No host sync and no allocation: it runs inside a CUDA graph capture.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // columns a block
constexpr int kUnroll = 8;     // planes loaded ahead of the compare chain
constexpr int kMaxGridY = 65535;

// One view's running scan: the winner, its cost, the costs of the planes
// before (c1) and after (c2) it, the previous plane's cost, and whether
// the previous plane was taken (then this plane is the winner's c2).
struct Scan {
  int best;
  float cmin, c1, c2, prev;
  bool taken;
};

template <bool kArgmin>
__device__ __forceinline__ void step(Scan& s, float v, int d) {
  if (s.taken) s.c2 = v;
  // argmin takes the first NaN and keeps it; the right view's strict
  // comparison never takes a NaN
  const bool take = kArgmin ? (v < s.cmin || (v != v && s.cmin == s.cmin))
                            : v < s.cmin;
  if (take) {
    s.best = d;
    s.cmin = v;
    s.c1 = s.prev;
  }
  s.taken = take;
  s.prev = v;
}

// stages/wta.py:_parabola, in float32, in its order
__device__ __forceinline__ float parabola(const Scan& s, int min_d) {
  const float denom = (s.c1 + s.c2) - 2.0f * s.cmin;
  const float best_d = static_cast<float>(s.best + min_d);
  return denom != 0.0f ? best_d + (s.c1 - s.c2) / (denom * 2.0f) : best_d;
}

__global__ void __launch_bounds__(kThreads)
wta_kernel(const float* __restrict__ cost, float* __restrict__ out_l,
           float* __restrict__ out_r, int D, int H, int W, int min_d,
           int real_w) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  const long long hw = static_cast<long long>(H) * W;
  const bool left_in = x < real_w;
  for (int y = blockIdx.y; y < H; y += gridDim.y) {
    const float* col = cost + static_cast<long long>(y) * W + x;
    // argmin's first value is always taken: +inf start, NaN rule above
    Scan l{0, INFINITY, 0.0f, 0.0f, 0.0f, false};
    Scan r{0, ADC_LARGE_FLOAT, 0.0f, 0.0f, ADC_LARGE_FLOAT, false};
    int d = 0;
    for (; d + kUnroll <= D; d += kUnroll) {
      float a[kUnroll], b[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const float* plane = col + (d + k) * hw;
        const int shift = d + k + min_d;
        const int xr = x + shift;
        a[k] = left_in ? __ldg(plane) : ADC_LARGE_FLOAT;
        b[k] = (xr >= 0 && xr < real_w) ? __ldg(plane + shift)
                                        : ADC_LARGE_FLOAT;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        step<true>(l, a[k], d + k);
        step<false>(r, b[k], d + k);
      }
    }
    for (; d < D; ++d) {
      const float* plane = col + d * hw;
      const int shift = d + min_d;
      const int xr = x + shift;
      step<true>(l, left_in ? __ldg(plane) : ADC_LARGE_FLOAT, d);
      step<false>(r, (xr >= 0 && xr < real_w) ? __ldg(plane + shift)
                                              : ADC_LARGE_FLOAT, d);
    }
    const long long o = static_cast<long long>(y) * W + x;
    out_l[o] = (l.best == 0 || l.best == D - 1) ? INFINITY
                                                : parabola(l, min_d);
    out_r[o] = (r.best == 0 || r.best == D - 1)
                   ? static_cast<float>(r.best + min_d)
                   : parabola(r, min_d);
  }
}

}  // namespace

// cost (D, H, W) float32 -> out_l, out_r (H, W) float32, on `stream`.
// 0 <= real_w <= W; D >= 1.
ADC_EXPORT int adc_wta(const float* cost, float* out_l, float* out_r, int D,
                       int H, int W, int min_d, int real_w,
                       cudaStream_t stream) {
  if (H > 0 && W > 0) {
    const dim3 grid(adc_blocks(W, kThreads), H < kMaxGridY ? H : kMaxGridY);
    wta_kernel<<<grid, kThreads, 0, stream>>>(cost, out_l, out_r, D, H, W,
                                              min_d, real_w);
  }
  return static_cast<int>(cudaGetLastError());
}
