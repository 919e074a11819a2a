// Kernel A1: the cross arms of every pixel, its four directions.
//
// Replaces stages/arms.py:build_arms_plain (adcensus_tpu/stages/arms.py:19
// _arm_length, jnp: no Pallas kernel corresponds). The reference grows
// each arm with a per-pixel break loop (cross_aggregator.cpp:135-269); the
// plain version stacks min(L1, 255) + 1 shifted int32 copies of the image
// for each direction and takes a cumulative AND over them, about 35
// PyTorch launches a direction and 2.6 ms a Cone-size pair on the H100.
// This kernel runs the reference's loop itself, a thread a pixel and
// direction: candidate k of direction (dy, dx) sits at (y + k dy, x + k dx)
// and extends the arm iff
//   * it lies inside the image (rows judged at row_offset + y + k dy
//     against full_h, columns against full_w: the sharded layer's slab
//     mode),
//   * color_dist(candidate, anchor) < t1 and color_dist(candidate,
//     previous) < t1 (the previous of k == 1 is the anchor),
//   * k <= L2 or color_dist(candidate, anchor) < t2,
// and the arm is the count of leading candidates that do. A candidate
// inside the image but outside the array it is given reads as color 0,
// as the plain version's zero padding does. color_dist is the largest
// absolute channel difference; the comparisons are the plain version's,
// in float32 against float32 thresholds (exact for integer ones).
//
// Output: (H, W, 4) int32, [left, right, top, bottom], the thread of
// (pixel p, direction r) writing element 4 p + r, so a warp's stores are
// one run. Bound: the image read once (3 B a pixel) and the arms written
// (16 B a pixel); the candidates' reads hit the L1 and L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ inline int color_dist(int a0, int a1, int a2, int b0, int b1,
                                 int b2) {
  return max(max(abs(a0 - b0), abs(a1 - b1)), abs(a2 - b2));
}

__global__ void __launch_bounds__(kThreads)
    arms_kernel(const uint8_t* __restrict__ img, int* __restrict__ out,
                int H, int W, int row_offset, int full_h, int full_w,
                int steps, float l2, float t1, float t2) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= 4ll * H * W) return;
  const int r = static_cast<int>(i & 3);
  const int p = static_cast<int>(i >> 2);
  const int y = p / W;
  const int x = p - y * W;
  const int dy = r == 2 ? -1 : (r == 3 ? 1 : 0);
  const int dx = r == 0 ? -1 : (r == 1 ? 1 : 0);
  const uint8_t* a = img + 3 * static_cast<size_t>(p);
  const int a0 = a[0], a1 = a[1], a2 = a[2];
  int q0 = a0, q1 = a1, q2 = a2;  // the previous candidate
  int n = 0;
  for (int k = 1; k <= steps; ++k) {
    const int yy = y + k * dy;
    const int xx = x + k * dx;
    const int ny = row_offset + yy;
    if (ny < 0 || ny >= full_h || xx < 0 || xx >= full_w) break;
    int c0 = 0, c1 = 0, c2 = 0;
    if (yy >= 0 && yy < H && xx < W) {
      const uint8_t* c = img + 3 * (static_cast<size_t>(yy) * W + xx);
      c0 = c[0];
      c1 = c[1];
      c2 = c[2];
    }
    const float d1 = static_cast<float>(color_dist(c0, c1, c2, a0, a1, a2));
    const float dp = static_cast<float>(color_dist(c0, c1, c2, q0, q1, q2));
    if (!(d1 < t1 && dp < t1 && (static_cast<float>(k) <= l2 || d1 < t2)))
      break;
    ++n;
    q0 = c0;
    q1 = c1;
    q2 = c2;
  }
  out[i] = n;
}

}  // namespace

// img: (H, W, 3) uint8; out: (H, W, 4) int32. steps = min(L1, 255); l2,
// t1 and t2 are the plain version's thresholds as float32. Refuses
// negative sizes or steps and 4 * H * W >= 2^31 with cudaErrorInvalidValue.
ADC_EXPORT int adc_arms(const uint8_t* img, int* out, int H, int W,
                        int row_offset, int full_h, int full_w, int steps,
                        float l2, float t1, float t2, void* stream) {
  if (H < 0 || W < 0 || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = 4ll * H * W;
  if (n == 0) return 0;
  if (n >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  arms_kernel<<<adc_blocks(n, kThreads), kThreads, 0, s>>>(
      img, out, H, W, row_offset, full_h, full_w, steps, l2, t1, t2);
  return static_cast<int>(cudaGetLastError());
}
