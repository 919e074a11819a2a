// Kernel B5: the blocked-band window sum of the "banded" aggregation.
//
// Replaces adcensus_tpu/ops/band_mm_pallas.py:_band_kernel (launched by
// _band_pass). For every (d, n, o), with ob = o / 256:
//
//   out[d, n, o] = sum_ii mask[n, ii, o] * vol[d, n, ob*256 + ii],
//
// ii < WK = 256 + 2*PAD, the mask int8 0/1 and the float32 volume split
// into bfloat16 hi = bf16(v) and lo = bf16(v - hi). The Pallas kernel
// multiplies both parts on the TPU's matrix unit with float32 sums.
//
// Order, for bitwise equality with band_pass_plain (ops/band_mm.py):
// hi_sum starts at 0.0f and adds hi for each selected ii, ascending;
// lo_sum the same; the result is hi_sum + lo_sum. An unselected slot
// adds 0.0 in the plain version; the sums never become -0.0, so skipping
// that add changes nothing. Built with -fmad=false, no fast math.
//
// Bound on the H100: device memory. One pass must read the int8 mask
// (Np*WK*Mp bytes, 75 MB at 64x375x450 and arm cap 34) and the volume
// and write the output, while its ~19 GFLOP fit the bf16 tensor cores in
// a third of that time. This first kernel is scalar: one thread per
// output column o and DG = 8 d-planes, so that one mask byte serves 8
// outputs. A block of 256 threads covers one 256-column block of one row
// n and stages the 8 planes' WK-wide window, split hi/lo, in shared
// memory once; d-groups are the fastest grid axis, so the blocks that
// share a mask row run together and find it in L2. Its time follows the
// per-thread loop over the WK slots (one strided 1-byte mask load each),
// not the bytes. A tensor-core design (mma/wgmma with the mask as the B
// operand, TMA loads) is later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int NB = 256;  // output-block width (band_mm.py _NB)
constexpr int DG = 8;    // d-planes per block

__global__ void __launch_bounds__(NB)
    band_kernel(const int8_t* __restrict__ mask,
                const float* __restrict__ vol, float* __restrict__ out,
                int Dp, int Np, int Mp, int L, int WK) {
  extern __shared__ float4 smem[];
  float* s_hi = reinterpret_cast<float*>(smem);  // [WK][DG]
  float* s_lo = s_hi + static_cast<long long>(WK) * DG;
  const int d0 = blockIdx.x * DG;
  const int ob = blockIdx.y;
  const int n = blockIdx.z;
  const long long plane = static_cast<long long>(Np) * L;
  const float* src = vol + static_cast<long long>(n) * L +
                     static_cast<long long>(ob) * NB;
  for (int t = threadIdx.x; t < DG * WK; t += blockDim.x) {
    const int k = t / WK;
    const int ii = t - k * WK;
    const int d = d0 + k;
    const float v = d < Dp ? src[d * plane + ii] : 0.0f;
    const float hi = __bfloat162float(__float2bfloat16_rn(v));
    s_hi[ii * DG + k] = hi;
    s_lo[ii * DG + k] = __bfloat162float(__float2bfloat16_rn(v - hi));
  }
  __syncthreads();
  const int o = ob * NB + static_cast<int>(threadIdx.x);
  if (o >= Mp) return;
  float acc_hi[DG], acc_lo[DG];
#pragma unroll
  for (int k = 0; k < DG; ++k) {
    acc_hi[k] = 0.0f;
    acc_lo[k] = 0.0f;
  }
  const int8_t* m = mask + static_cast<long long>(n) * WK * Mp + o;
  for (int ii = 0; ii < WK; ++ii) {
    if (m[static_cast<long long>(ii) * Mp] != 0) {
      const float4* h4 = reinterpret_cast<const float4*>(s_hi + ii * DG);
      const float4* l4 = reinterpret_cast<const float4*>(s_lo + ii * DG);
      const float4 h0 = h4[0], h1 = h4[1], l0 = l4[0], l1 = l4[1];
      acc_hi[0] += h0.x; acc_hi[1] += h0.y; acc_hi[2] += h0.z;
      acc_hi[3] += h0.w; acc_hi[4] += h1.x; acc_hi[5] += h1.y;
      acc_hi[6] += h1.z; acc_hi[7] += h1.w;
      acc_lo[0] += l0.x; acc_lo[1] += l0.y; acc_lo[2] += l0.z;
      acc_lo[3] += l0.w; acc_lo[4] += l1.x; acc_lo[5] += l1.y;
      acc_lo[6] += l1.z; acc_lo[7] += l1.w;
    }
  }
#pragma unroll
  for (int k = 0; k < DG; ++k) {
    const int d = d0 + k;
    if (d < Dp) {
      out[(static_cast<long long>(d) * Np + n) * Mp + o] =
          acc_hi[k] + acc_lo[k];
    }
  }
}

}  // namespace

// mask (Np, WK, Mp) int8; vol (Dp, Np, L) float32 with L = ceil(Mp/256)*256
// + WK - 256 (margins attached); out (Dp, Np, Mp) float32.
ADC_EXPORT int adc_band_mm(const int8_t* mask, const float* vol, float* out,
                           int Dp, int Np, int Mp, int L, int WK,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dp == 0 || Np == 0 || Mp == 0) return 0;
  const size_t smem = 2 * sizeof(float) * DG * static_cast<size_t>(WK);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Dp + DG - 1) / DG, (Mp + NB - 1) / NB, Np);
  band_kernel<<<grid, NB, smem, s>>>(mask, vol, out, Dp, Np, Mp, L, WK);
  return static_cast<int>(cudaGetLastError());
}
