// Kernel B4: the 16-ray proper-interpolation fill search at one phase's
// targets.
//
// Replaces adcensus_tpu/ops/interp_pallas.py:_ray_interp_kernel (launched
// by _ray_interp_pallas / ray_interp_select). For every target pixel and
// each ray r = 0 .. n_rays-1 it marches the ray's steps in the offset table
// (stages/refine.py:ray_offset_table) and takes the first finite disparity
// on the ray (multistep_refiner.cpp:229-305). A ray ends at its first
// out-of-image probe (nothing found) or at an in-image NaN, as the NaN moat
// of ops/interp.py:ray_interp_plain ends it; an in-image +inf is marched
// through. Across rays it keeps
//   mismatch:  the hit with the least |dR| + |dG| + |dB| to the center
//              pixel's color,
//   occlusion: the least hit disparity, capped at LARGE_FLOAT as the plain
//              version's amin over (hit ? v : LARGE_FLOAT) caps it,
// and the lowest ray wins ties. Outputs: found (any ray hit) and fill (the
// selected disparity, 0.0 where nothing was hit); (0, 0.0) at every pixel
// that is not a target.
//
// Bound on the H100. The outputs are written over the whole map and the
// target mask read (6 B a pixel, 0.0003 ms at Cone size at 3.35 TB/s);
// beyond that the function reads the disparity of each cell its rays probe
// (4 B), the offset table, and in a mismatch the colors of the targets and
// of the hit cells (3 B each); chip_smoke.py:ray_interp_case counts these
// on a run's data. The work is the ray steps the data needs, a few loads
// each. The targets are
// sparse (7,945 and 774 of 168,750 pixels in the synthetic Cone-size pair's
// two phases) and each ray is a chain of loads whose addresses the data
// does not decide, so what holds a launch back is latency: the launch, the
// pass over the mask, and each target's longest ray.
//
// Design:
// * A block owns a run of `pixels` consecutive pixels. Each warp reads 32
//   target bytes at a time, writes (0, 0.0) at the pixels that are not
//   targets and appends the targets to a list in shared memory: one
//   __ballot_sync, one shared atomicAdd a warp and step. A block without
//   targets exits there, so an empty phase costs one pass over the mask and
//   nothing reads a count back to the host.
// * Sixteen lanes a target, one lane a ray (lane l takes rays l, l + 16,
//   ... in order): each half-warp takes one target of the list at a time,
//   so a target waits for its longest ray, not for the sum of its rays.
// * K probes in flight: a lane loads the disparities of K consecutive
//   steps before it tests any of them, then takes the chunk's first step
//   that ends the ray, in step order; the TPU kernel marches in chunks the
//   same way (interp_pallas.py:151-179). The next chunk's offsets are
//   loaded with this chunk's disparities, so a chunk waits for one load,
//   and a mismatch loads the colors of its ray's hit only.
// * The offset table (8 KB at D = 64) is read from device memory through
//   the read-only path and stays in L1. A copy into shared memory cost
//   each block with targets more than it saved (scratch variants on the
//   H100), so shared memory holds the target list only.
// * Reduction: four __shfl_xor_sync of width 16 on (key, ray, value),
//   compared as (key, ray) pairs, so the lowest ray wins ties and a ray
//   that hit beats every lane without a hit (key +inf); found is whether
//   the winner hit. The mismatch key is the integer color distance (at
//   most 765, exact in float).
// * 32-bit indices, one division a target; the caller guarantees
//   H * W < 2^31.
// * Launch geometry (pixels a block, warps a block, K, dynamic shared
//   bytes) comes from ops/interp.py:ray_interp_geometry; this entry point
//   refuses a geometry whose shared memory is too small for its list.

#include <math.h>

#include "common.cuh"

namespace {

// Ceiling on one block's static + dynamic shared memory on the H100, less
// this kernel's static list length.
constexpr int kMaxSharedBytes = 232448 - 16;
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoRay = 0x7fffffff;

// Dynamic shared bytes of a geometry: the target list.
// ops/interp.py:ray_interp_smem is the same formula.
inline long long list_bytes(int pixels) { return 4ll * pixels; }

template <int K, bool kMismatch>
__global__ void __launch_bounds__(kMaxWarps * 32)
    ray_interp_kernel(const float* __restrict__ disp,
                      const uint8_t* __restrict__ color,
                      const uint8_t* __restrict__ target,
                      const int2* __restrict__ offsets,
                      uint8_t* __restrict__ found, float* __restrict__ fill,
                      int H, int W, int n_rays, int n_steps, int pixels) {
  extern __shared__ int list[];  // [pixels] target pixel indices
  __shared__ int n_targets;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int HW = H * W;

  // The block's targets, listed; (0, 0.0) everywhere else.
  const int p0 = blockIdx.x * pixels;
  const int n_here = min(pixels, HW - p0);
  if (threadIdx.x == 0) n_targets = 0;
  __syncthreads();
  for (int c = warp * 32; c < n_here; c += warps * 32) {
    const int i = c + lane;
    const int p = p0 + i;
    const bool in = i < n_here;
    const bool is_target = in && target[p];
    if (in && !is_target) {
      found[p] = 0;
      fill[p] = 0.0f;
    }
    const unsigned m = __ballot_sync(kFull, is_target);
    if (m) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&n_targets, __popc(m));
      base = __shfl_sync(kFull, base, 0);
      if (is_target) list[base + __popc(m & ((1u << lane) - 1u))] = p;
    }
  }
  __syncthreads();
  const int n = n_targets;
  if (n == 0) return;

  const int sub = lane & 15;  // the lane's first ray
  for (int k0 = 2 * warp; k0 < n; k0 += 2 * warps) {
    const int k = k0 + (lane >> 4);
    const bool have = k < n;  // uniform over each half-warp
    const int p = have ? list[k] : 0;
    float best_key = INFINITY, best_val = 0.0f;
    int best_ray = kNoRay;
    if (have) {
      const int y = p / W;
      const int x = p - y * W;
      int c0 = 0, c1 = 0, c2 = 0;
      if (kMismatch) {
        const uint8_t* cp = color + 3 * static_cast<size_t>(p);
        c0 = cp[0];
        c1 = cp[1];
        c2 = cp[2];
      }
      for (int r = sub; r < n_rays; r += 16) {
        bool hit = false;
        float val = 0.0f;
        int hit_q = 0;
        const int2* ray = offsets + r * n_steps;
        int2 off[K];  // this chunk's offsets
#pragma unroll
        for (int u = 0; u < K; ++u)
          off[u] = u < n_steps ? ray[u] : make_int2(0, 0);
        for (int j = 0; j < n_steps; j += K) {
          bool in[K];
          float v[K];
          int q[K];
#pragma unroll
          for (int u = 0; u < K; ++u) {
            const int yy = y + off[u].x;
            const int xx = x + off[u].y;
            in[u] = j + u < n_steps &&
                    static_cast<unsigned>(yy) < static_cast<unsigned>(H) &&
                    static_cast<unsigned>(xx) < static_cast<unsigned>(W);
            q[u] = yy * W + xx;
            v[u] = in[u] ? disp[q[u]] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < K; ++u)  // the next chunk's, in flight too
            off[u] = j + K + u < n_steps ? ray[j + K + u] : make_int2(0, 0);
          bool stop = false;
#pragma unroll
          for (int u = 0; u < K; ++u) {
            if (!stop) {
              if (!in[u] || isnan(v[u])) {
                stop = true;  // left the image, or the last step is done
              } else if (isfinite(v[u])) {
                stop = hit = true;
                val = v[u];
                hit_q = q[u];
              }
            }
          }
          if (stop) break;
        }
        float key = 0.0f;
        if (hit) {
          if (kMismatch) {  // the hit's color only: one load chain a ray
            const uint8_t* cq = color + 3 * static_cast<size_t>(hit_q);
            key = static_cast<float>(abs(cq[0] - c0) + abs(cq[1] - c1) +
                                     abs(cq[2] - c2));
          } else {
            key = val = fminf(val, ADC_LARGE_FLOAT);
          }
        }
        if (hit && key < best_key) {  // this lane's rays ascend
          best_key = key;
          best_val = val;
          best_ray = r;
        }
      }
    }
#pragma unroll
    for (int d = 8; d > 0; d >>= 1) {
      const float ok = __shfl_xor_sync(kFull, best_key, d, 16);
      const float ov = __shfl_xor_sync(kFull, best_val, d, 16);
      const int orr = __shfl_xor_sync(kFull, best_ray, d, 16);
      if (ok < best_key || (ok == best_key && orr < best_ray)) {
        best_key = ok;
        best_val = ov;
        best_ray = orr;
      }
    }
    // Every lane of the half now holds its winner: a ray hit (found is
    // the OR of the lanes' hits) iff the winner is one.
    if (have && sub == 0) {
      const bool any = best_ray != kNoRay;
      found[p] = any ? 1 : 0;
      fill[p] = any ? best_val : 0.0f;
    }
  }
}

template <int K>
cudaError_t launch(bool mismatch, dim3 grid, int threads, int smem,
                   cudaStream_t s, const float* disp, const uint8_t* color,
                   const uint8_t* target, const int2* offsets,
                   uint8_t* found, float* fill, int H, int W, int n_rays,
                   int n_steps, int pixels) {
  auto kernel = mismatch ? ray_interp_kernel<K, true>
                         : ray_interp_kernel<K, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, s>>>(disp, color, target, offsets, found,
                                     fill, H, W, n_rays, n_steps, pixels);
  return cudaGetLastError();
}

}  // namespace

// pixels (a block's run of pixels), warps (1 to 32), k (probes in flight:
// 1, 2, 4 or 8) and smem (dynamic shared bytes) are the launch geometry of
// ray_interp_geometry. offsets must be 8-byte aligned (it is read as
// int2). A geometry whose smem is short of the list, or
// exceeds the card's limit, is refused with cudaErrorInvalidValue before
// any launch, as are n_rays < 1, n_steps < 0, a table of 2^30 offsets or
// more and H * W >= 2^31.
ADC_EXPORT int adc_ray_interp(const float* disp, const uint8_t* color,
                              const uint8_t* target, const int* offsets,
                              uint8_t* found, float* fill, int H, int W,
                              int n_rays, int n_steps, int is_mismatch,
                              int pixels, int warps, int k, int smem,
                              void* stream) {
  if (H < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long hw = static_cast<long long>(H) * W;
  if (hw == 0) return 0;
  const long long n_offsets = static_cast<long long>(n_rays) * n_steps;
  if (n_rays < 1 || n_steps < 0 || n_offsets >= (1ll << 30) ||
      hw >= (1ll << 31) || pixels < 1 || warps < 1 || warps > kMaxWarps ||
      smem < list_bytes(pixels) || smem > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(adc_blocks(hw, pixels));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* offs = reinterpret_cast<const int2*>(offsets);
  auto* fn = k == 1   ? launch<1>
             : k == 2 ? launch<2>
             : k == 4 ? launch<4>
             : k == 8 ? launch<8>
                      : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(is_mismatch != 0, grid, warps * 32, smem, s,
                             disp, color, target, offs, found, fill, H, W,
                             n_rays, n_steps, pixels));
}
