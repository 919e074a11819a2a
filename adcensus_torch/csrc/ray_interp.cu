// Kernel B4: the 16-ray proper-interpolation fill search.
//
// Replaces adcensus_tpu/ops/interp_pallas.py:_ray_interp_kernel (launched
// by _ray_interp_pallas / ray_interp_select). For every target pixel and
// each ray r = 0 .. n_rays-1 it marches the ray's offset table (from
// stages/refine.py:ray_offset_table) and takes the first finite disparity
// on the ray (multistep_refiner.cpp:229-305). A ray ends when it leaves
// the image; an in-image +inf is marched through. Across rays it keeps
//   mismatch:  the hit with the least sum of |dR| + |dG| + |dB| to the
//              center pixel's color,
//   occlusion: the least hit disparity,
// with a strict '<', so the first ray wins ties. Outputs: found (any ray
// hit) and fill (the selected disparity, 0.0 where nothing was hit).
// Non-target pixels write found = 0, fill = 0.0 at once.
//
// Design: one thread per output pixel, each stopping at its own hit. The
// TPU kernel's NaN moat, (8, 128)-aligned load blocks, coordinate mode and
// row chunking were VMEM workarounds; here they become one bounds check
// per step on the unpadded map.
//
// Bound on the H100: the inputs are read once and the outputs written
// once (~16 B per pixel), so the bytes floor is microseconds; the work is
// the ray steps the data needs, a handful of loads each. The steps of
// neighbouring threads touch neighbouring cells, so they are served from
// L1/L2, and target pixels are sparse, so most warps finish at once.
#include "common.cuh"

namespace {
constexpr float kBig = 3.0e38f;

__global__ void ray_interp_kernel(const float* __restrict__ disp,
                                  const uint8_t* __restrict__ color,
                                  const uint8_t* __restrict__ target,
                                  const int* __restrict__ offsets,
                                  uint8_t* __restrict__ found,
                                  float* __restrict__ fill, int H, int W,
                                  int n_rays, int n_steps, int is_mismatch) {
  const long long hw = static_cast<long long>(H) * W;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= hw) return;
  bool any = false;
  float best_key = kBig;
  float best_val = 0.0f;
  if (target[i]) {
    const int y = static_cast<int>(i / W);
    const int x = static_cast<int>(i % W);
    const int cr = color[i * 3], cg = color[i * 3 + 1], cb = color[i * 3 + 2];
    for (int r = 0; r < n_rays; ++r) {
      const int* o = offsets + static_cast<long long>(r) * n_steps * 2;
      for (int j = 0; j < n_steps; ++j) {
        const int yy = y + o[2 * j];
        const int xx = x + o[2 * j + 1];
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) break;  // left image
        const long long q = static_cast<long long>(yy) * W + xx;
        const float v = disp[q];
        if (isfinite(v)) {
          float key = v;
          if (is_mismatch) {
            key = static_cast<float>(abs(color[q * 3] - cr) +
                                     abs(color[q * 3 + 1] - cg) +
                                     abs(color[q * 3 + 2] - cb));
          }
          if (key < best_key) {
            best_key = key;
            best_val = v;
          }
          any = true;
          break;
        }
      }
    }
  }
  found[i] = any ? 1 : 0;
  fill[i] = any ? best_val : 0.0f;
}
}  // namespace

ADC_EXPORT int adc_ray_interp(const float* disp, const uint8_t* color,
                              const uint8_t* target, const int* offsets,
                              uint8_t* found, float* fill, int H, int W,
                              int n_rays, int n_steps, int is_mismatch,
                              void* stream) {
  const long long hw = static_cast<long long>(H) * W;
  if (hw == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  ray_interp_kernel<<<adc_blocks(hw, threads), threads, 0, s>>>(
      disp, color, target, offsets, found, fill, H, W, n_rays, n_steps,
      is_mismatch);
  return static_cast<int>(cudaGetLastError());
}
