// Kernel B3: region-voting histogram statistics.
//
// Replaces adcensus_tpu/ops/region_vote_pallas.py:_region_vote_kernel
// (launched by _region_vote_pallas). For every pixel p it builds the
// histogram of rounded disparity indices over p's horizontal-first cross
// support region (multistep_refiner.cpp:183-197): the rows y + t for t in
// -top(p) .. bottom(p), and on each row the anchor q = (y + t, x) spans
// -left(q) .. right(q). Only valid pixels vote. It writes
//   out[0] = argmax_d hist (lowest d wins ties: strict '>' scanning up),
//   out[1] = max_d hist, clamped at 0,
//   out[2] = sum_d hist.
//
// Design: one thread per pixel, with a private histogram of D int32
// counts in shared memory, laid out d-major with the thread index
// fastest so that the threads of a warp hit distinct banks. The TPU
// kernel's 8/16-bit field packing and its limit at arm 127 existed to fit
// VMEM and the vector unit; plain int32 counts need neither. Blocks are
// 128 threads, or fewer for large D, so the histograms fit 48 KB of
// shared memory; beyond that the launch asks for more dynamic shared
// memory.
//
// Bound on the H100: the inputs and outputs are small (~36 B per pixel),
// so the floor is the work: one increment per region cell, ~(2*arm+1)^2
// per pixel. Region reads of di/valid/arms are served from L1/L2 because
// neighbouring threads' regions overlap almost entirely.
#include "common.cuh"

namespace {
__global__ void region_vote_kernel(const int* __restrict__ di,
                                   const uint8_t* __restrict__ valid,
                                   const int* __restrict__ arms,
                                   int* __restrict__ out, int D, int H, int W,
                                   int max_arm) {
  extern __shared__ int hist[];  // hist[d * blockDim.x + threadIdx.x]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long hw = static_cast<long long>(H) * W;
  const long long i = blockIdx.x * static_cast<long long>(nt) + tid;
  if (i >= hw) return;  // no barriers below
  for (int d = 0; d < D; ++d) hist[d * nt + tid] = 0;

  const int y = static_cast<int>(i / W);
  const int x = static_cast<int>(i % W);
  const int* a = arms + i * 4;
  const int top = min(min(a[2], max_arm), y);
  const int bottom = min(min(a[3], max_arm), H - 1 - y);
  for (int t = -top; t <= bottom; ++t) {
    const long long q0 = static_cast<long long>(y + t) * W + x;
    const int* aq = arms + q0 * 4;
    const int left = min(min(aq[0], max_arm), x);
    const int right = min(min(aq[1], max_arm), W - 1 - x);
    for (int s = -left; s <= right; ++s) {
      const long long q = q0 + s;
      if (valid[q]) {
        const int v = di[q];
        if (static_cast<unsigned int>(v) < static_cast<unsigned int>(D))
          hist[v * nt + tid] += 1;
      }
    }
  }
  int best = 0, max_ht = -1, count = 0;
  for (int d = 0; d < D; ++d) {
    const int c = hist[d * nt + tid];
    if (c > max_ht) {
      max_ht = c;
      best = d;
    }
    count += c;
  }
  out[i] = best;
  out[hw + i] = max(max_ht, 0);
  out[2 * hw + i] = count;
}
}  // namespace

ADC_EXPORT int adc_region_vote(const int* di, const uint8_t* valid,
                               const int* arms, int* out, int D, int H, int W,
                               int max_arm, void* stream) {
  const long long hw = static_cast<long long>(H) * W;
  if (hw == 0) return 0;
  if (D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int threads = 128;
  while (threads > 32 &&
         static_cast<size_t>(threads) * D * sizeof(int) > 48 * 1024)
    threads /= 2;
  const size_t smem = static_cast<size_t>(threads) * D * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        region_vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  region_vote_kernel<<<adc_blocks(hw, threads), threads, smem, s>>>(
      di, valid, arms, out, D, H, W, max_arm);
  return static_cast<int>(cudaGetLastError());
}
