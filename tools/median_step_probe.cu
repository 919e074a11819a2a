// The least time of one step of the in-place 3x3 median's recurrence
// (kernel M1, csrc/median_inplace.cu), for stereo_bench/roofline_refine.py.
//
// Under t = x + 2y every filtered value a pixel reads lies on wavefronts
// t-1 to t-3, so a step of the recurrence takes at least the chain from a
// value of wavefront t-1 to the pixel's median: the new value merged into
// the sorted window of the other eight, and the median read out. With the
// eight sorted as s0..s7, the median of the nine is max(min(v, s4), s3):
// two dependent min/max. This probe times that chain alone, on one warp,
// in clock64 cycles: no memory access and no barrier inside the timed
// loop. Each of the kSteps steps of an unrolled round clamps to its own
// window, so no step can be folded into the one before.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kSteps = 16;  // steps of one unrolled round

__global__ void step_probe_kernel(long long* cycles, float* sink,
                                  const float* windows, int rounds) {
  const int lane = threadIdx.x;
  float s3[kSteps], s4[kSteps];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    s3[k] = windows[(2 * k) * kWarp + lane];
    s4[k] = windows[(2 * k + 1) * kWarp + lane];
  }
  float v = windows[2 * kSteps * kWarp + lane];
  __syncwarp();
  const long long t0 = clock64();
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      v = fmaxf(fminf(v, s4[k]), s3[k]);
    }
  }
  const long long t1 = clock64();
  sink[lane] = v;
  if (lane == 0) *cycles = t1 - t0;
}

}  // namespace

// Cycles of `rounds` rounds of kSteps steps into cycles[0], on one warp;
// windows holds (2 * kSteps + 1) * 32 floats (each step's s3 and s4 a
// lane, then the first value); sink (32 floats) keeps the chain live.
extern "C" int median_step_cycles(long long* cycles, float* sink,
                                  const float* windows, int rounds,
                                  void* stream) {
  if (rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
  step_probe_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      cycles, sink, windows, rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int median_step_probe_steps() { return kSteps; }
