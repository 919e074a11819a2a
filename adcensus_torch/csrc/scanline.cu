// Kernel B2: one directional scanline-optimization pass.
//
// Replaces adcensus_tpu/ops/scanline_pallas.py:_scanline_kernel (launched
// by scanline_pass_sdp). The reference DP (scanline_optimizer.cpp:63-279)
// is a first-order recurrence along each image row or column:
//
//   Lr(p, d) = (C(p, d) + min(Lr(p-r, d), Lr(p-r, d-1) + P1,
//                             Lr(p-r, d+1) + P1, min_d' Lr(p-r, d') + P2)) / 2
//
// with Large_Float at d = -1 and d = D (the neighbour is Large_Float, and
// P1 is still added to it, as in the Pallas kernel and the plain version).
// The uint8 penalty code picks (P1, P2), (P1, P2)/4 or (P1, P2)/10; the six
// constants arrive as float32 values computed on the host. Each scan step
// has a flag: PAD passes the carry through and writes the raw cost, SEED
// copies the cost into the carry, NORMAL runs the recurrence.
//
// Design: one thread block per path, one thread per disparity. The TPU's
// sequential S grid becomes a loop inside the block; the previous Lr lives
// in shared memory and min_d Lr comes from a warp-shuffle plus shared
// memory reduction. The volume is read in place through strides (sD, sS,
// sP) for the pass's axis, so no transposed copy is made, and reverse
// walks S backward. The next step's cost and code are loaded before the
// current step's barriers so that their latency overlaps the reduction.
//
// Bound on the H100: the arithmetic is ~10 operations per cell, so the
// floor is device memory (read 4 B cost + 1 B code, write 4 B, ~97 MB at
// 64x375x450). This kernel is far from that floor: each step of a path is
// a chain of two barriers and a global load, and the threads of a block
// read addresses H*W apart (one sector per thread per step). On the
// y-axis passes consecutive steps of a path are W apart, so nothing is
// reused out of L1 either. Several paths per block with x across the
// threads would coalesce those reads; that is work for a later change.
#include "common.cuh"

namespace {
constexpr int kFlagPad = 0;
constexpr int kFlagSeed = 1;

__global__ void scanline_kernel(const float* __restrict__ cost,
                                const uint8_t* __restrict__ code,
                                const int* __restrict__ flags,
                                float* __restrict__ out, int D, int S,
                                long long sD, long long sS, long long sP,
                                float p1_0, float p1_1, float p1_2,
                                float p2_0, float p2_1, float p2_2,
                                int reverse) {
  extern __shared__ float smem[];
  float* lr = smem;             // D floats: Lr of the previous step
  float* warp_min = smem + D;   // one per warp
  const int d = threadIdx.x;
  const bool active = d < D;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const long long base = blockIdx.x * sP + static_cast<long long>(d) * sD;

  if (active) lr[d] = ADC_LARGE_FLOAT;
  float min_prev = ADC_LARGE_FLOAT;
  __syncthreads();

  float c_next = 0.0f;
  int code_next = 0;
  if (S > 0 && active) {
    const long long off = base + (reverse ? S - 1 : 0) * sS;
    c_next = cost[off];
    code_next = code[off];
  }
  for (int k = 0; k < S; ++k) {
    const int s = reverse ? S - 1 - k : k;
    const long long off = base + s * sS;
    const float c = c_next;
    const int cd = code_next;
    if (k + 1 < S && active) {
      const long long nxt = base + (reverse ? s - 1 : s + 1) * sS;
      c_next = cost[nxt];
      code_next = code[nxt];
    }
    const int flag = flags[k];  // uniform across the block
    if (flag == kFlagPad) {
      if (active) out[off] = c;
      continue;
    }
    float v = c;
    if (flag != kFlagSeed && active) {
      const float P1 = cd == 0 ? p1_0 : (cd == 1 ? p1_1 : p1_2);
      const float P2 = cd == 0 ? p2_0 : (cd == 1 ? p2_1 : p2_2);
      const float own = lr[d];
      const float l2 = (d > 0 ? lr[d - 1] : ADC_LARGE_FLOAT) + P1;
      const float l3 = (d < D - 1 ? lr[d + 1] : ADC_LARGE_FLOAT) + P1;
      const float l4 = min_prev + P2;
      const float m = fminf(fminf(own, l2), fminf(l3, l4));
      v = (c + m) * 0.5f;
    }
    if (active) out[off] = v;
    __syncthreads();  // every thread has read lr
    if (active) lr[d] = v;
    float mv = active ? v : __int_as_float(0x7f800000);  // +inf
    for (int o = 16; o > 0; o >>= 1)
      mv = fminf(mv, __shfl_xor_sync(0xffffffffu, mv, o));
    if (lane == 0) warp_min[warp] = mv;
    __syncthreads();
    min_prev = warp_min[0];
    for (int w = 1; w < n_warps; ++w) min_prev = fminf(min_prev, warp_min[w]);
  }
}
}  // namespace

ADC_EXPORT int adc_scanline(const float* cost, const uint8_t* code,
                            const int* flags, float* out, int D, int S, int P,
                            long long sD, long long sS, long long sP,
                            float p1_0, float p1_1, float p1_2, float p2_0,
                            float p2_1, float p2_2, int reverse,
                            void* stream) {
  if (P == 0 || S == 0 || D == 0) return 0;
  if (D > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = (D + 31) / 32 * 32;
  const size_t smem = (D + threads / 32) * sizeof(float);
  scanline_kernel<<<P, threads, smem, st>>>(cost, code, flags, out, D, S, sD,
                                            sS, sP, p1_0, p1_1, p1_2, p2_0,
                                            p2_1, p2_2, reverse);
  return static_cast<int>(cudaGetLastError());
}
