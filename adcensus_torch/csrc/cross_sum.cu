// Kernel B1: one cross-aggregation iteration over a (D, H, W) volume.
//
// Replaces adcensus_tpu/ops/cross_sum_pallas.py:_cross_pass_kernel (the
// masked-roll Pallas kernel launched by _cross_pass_pallas). For every
// (d, y, x): sum the plane along the first axis' per-pixel arms, then sum
// that result along the second axis' arms, then divide by the support
// count (reference: cross_aggregator.cpp:327-394).
//
// Order: acc starts at 0.0f and adds p[i + t] for t = -lo .. hi, in
// ascending t. The Pallas kernel and the plain version add a masked 0.0
// for every offset outside the arm; costs are >= 0, so those adds are
// exact identities and this loop is bit-identical to them. The division
// is IEEE '/' (built without fast math, with -fmad=false).
//
// Bound on the H100: device memory. One iteration must read the volume
// once and write it once (2 x 4 B per cell, ~86 MB at 64x375x450), while
// it does ~(2*arm+1) adds per cell and pass, far below the f32 rate. The
// design runs one thread per cell with x fastest, so a warp's reads of
// p[i + t] are coalesced and neighbouring threads reuse the same lines
// out of L1. The first-axis pass goes through a scratch volume (one extra
// read and write); fusing the two passes through shared memory is work
// for a later change.
//
// Arms are int32 (H, W, 4) = left, right, top, bottom, capped at max_arm
// as the plain version caps its offsets; there is no 127 limit. Arms are
// also clamped to the image so that no read leaves the volume (arms built
// by build_arms never cross the border).
#include "common.cuh"

template <int AXIS>  // 2: along x (left/right arms), 1: along y (top/bottom)
__global__ void arm_sum_kernel(const float* __restrict__ src,
                               const int* __restrict__ arms,
                               const float* __restrict__ sup,
                               float* __restrict__ dst, int D, int H, int W,
                               int max_arm, int normalize) {
  const long long n = static_cast<long long>(D) * H * W;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  const int x = static_cast<int>(i % W);
  const int y = static_cast<int>((i / W) % H);
  const long long pix = static_cast<long long>(y) * W + x;
  const int* a = arms + pix * 4;
  int lo, hi;
  long long stride;
  if (AXIS == 2) {
    lo = min(min(a[0], max_arm), x);
    hi = min(min(a[1], max_arm), W - 1 - x);
    stride = 1;
  } else {
    lo = min(min(a[2], max_arm), y);
    hi = min(min(a[3], max_arm), H - 1 - y);
    stride = W;
  }
  const float* p = src + i;
  float acc = 0.0f;
  for (int t = -lo; t <= hi; ++t) acc += p[t * stride];
  if (normalize) acc = acc / sup[pix];
  dst[i] = acc;
}

ADC_EXPORT int adc_cross_sum(const float* vol, const int* arms,
                             const float* sup, float* tmp, float* out, int D,
                             int H, int W, int max_arm, int horizontal_first,
                             int normalize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(D) * H * W;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = adc_blocks(n, threads);
  if (horizontal_first) {
    arm_sum_kernel<2><<<blocks, threads, 0, s>>>(vol, arms, sup, tmp, D, H,
                                                 W, max_arm, 0);
    arm_sum_kernel<1><<<blocks, threads, 0, s>>>(tmp, arms, sup, out, D, H,
                                                 W, max_arm, normalize);
  } else {
    arm_sum_kernel<1><<<blocks, threads, 0, s>>>(vol, arms, sup, tmp, D, H,
                                                 W, max_arm, 0);
    arm_sum_kernel<2><<<blocks, threads, 0, s>>>(tmp, arms, sup, out, D, H,
                                                 W, max_arm, normalize);
  }
  return static_cast<int>(cudaGetLastError());
}
