// Kernel B3: region-voting histogram statistics at one phase's targets.
//
// Replaces adcensus_tpu/ops/region_vote_pallas.py:_region_vote_kernel
// (launched by _region_vote_pallas). For a target pixel p it builds the
// histogram of rounded disparity indices over p's horizontal-first cross
// support region (multistep_refiner.cpp:183-197): the rows y + t for t in
// -top(p) .. bottom(p), and on each row the anchor q = (y + t, x) spans
// -left(q) .. right(q). Only valid pixels vote. It writes
//   out[0] = argmax_d hist (the lowest d wins ties),
//   out[1] = max_d hist (0 for an empty region),
//   out[2] = sum_d hist,
// and (0, 0, 0) at every pixel that is not a target. A null target mask
// makes every pixel a target.
//
// Fill mode (adc_region_vote_fill) runs a whole voting phase in the same
// launch (stages/refine.py:region_vote_phase). It reads the float32 map
// instead of the indices: a cell votes where it is finite, at
// clamp(lround(d) - min_d, 0, D - 1), as ops/region_vote.py:vote_indices
// rounds. The targets are the pixels of the phase mask whose disparity is
// not finite, and it writes the phase's map: at a target whose histogram
// passes max > 0, count > ts and max / count > th (float32, rounded to
// nearest, as vote_fill divides) the disparity best + min_d, and
// everywhere else the map's own value. So a phase is one launch in place
// of 28 small PyTorch operations.
//
// Bound on the H100. A voting phase reads the statistics at its targets
// only (ops/region_vote.py:vote_fill), and the targets are sparse: on
// the Cone-size synthetic pair 7,952 of 168,750 pixels in the first
// mismatch phase, 1,152 in the first occlusion phase. The work is one pass
// over the 1-byte target mask and the 12-byte outputs (13 B a pixel,
// 0.0007 ms at 3.35 TB/s; in fill mode the 4-byte map read and written,
// 9 B a pixel) and one add per region cell of the targets.
// What holds it back is latency, not bytes or adds: the launch, the mask
// pass, and each target's chain of dependent loads (its arms, its rows'
// arms, its cells).
//
// Design:
// * A block owns a run of `pixels` consecutive pixels. Each warp reads 32
//   target bytes at a time, writes (0, 0, 0) (fill mode: the map's value)
//   at the pixels that are not targets and appends the targets to a list
//   in shared memory: one __ballot_sync, one shared atomicAdd a warp and
//   step. A block without
//   targets exits there, so an empty phase costs one pass over the mask
//   and nothing reads a count back to the host.
// * A warp takes one target of the list at a time, round robin, into its
//   own histogram of D int32 counts in shared memory. It loads the arms of
//   up to 32 region rows at once, one row a lane, scans their widths and
//   walks the rows' cells as one flat run, 32 cells a step, so the lanes
//   stay busy whatever the rows' widths; the loads of kUnroll steps are
//   in flight before their adds. Lanes that hold the same d combine by
//   __match_any_sync and their leader adds the __popc with one shared
//   atomicAdd. Integer counts are exact in any order.
// * Reduction: each lane scans bins lane, lane + 32, ... keeping (largest
//   count, lowest d) with a strict '>' in ascending d; then one
//   __reduce_max_sync of the counts, one __reduce_min_sync of d among the
//   lanes that hold the maximum, and one __reduce_add_sync of the totals.
//   An empty histogram gives best 0, max 0.
// * 32-bit indices, one division a target; the caller guarantees
//   H * W < 2^31. Arms are int32 (H, W, 4) = left, right, top, bottom,
//   capped at max_arm as the plain version caps its offsets, floored at 0
//   (a negative arm adds no offset there either) and clipped to the image
//   (arms built by build_arms never cross the border).
// * Launch geometry (pixels a block, warps a block, dynamic shared bytes)
//   comes from ops/region_vote.py:region_vote_geometry; this entry point
//   refuses a geometry whose shared memory is too small for it.
#include "common.cuh"

namespace {

// Ceiling on one block's static + dynamic shared memory on the H100, less
// this kernel's static list length.
constexpr int kMaxSharedBytes = 232448 - 16;
constexpr int kMaxWarps = 32;
constexpr int kUnroll = 2;  // flat steps whose loads are in flight together
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoBin = 0x7fffffff;

// Dynamic shared bytes of a geometry: the target list and one histogram a
// warp. ops/region_vote.py:region_vote_smem is the same formula.
inline long long smem_bytes(int pixels, int warps, int D) {
  return 4ll * pixels + 4ll * warps * D;
}

__device__ inline int clamp_arm(int arm, int max_arm, int room) {
  return max(min(min(arm, max_arm), room), 0);
}

// The 0-based voting index of a finite disparity: C lround (half away
// from zero) in float32, less min_d, clamped to [0, D).
__device__ inline int vote_index(float d, int min_d, int D) {
  const float r = d >= 0.0f ? floorf(d + 0.5f) : ceilf(d - 0.5f);
  return min(max(static_cast<int>(r) - min_d, 0), D - 1);
}

// Where the phase's fill reads and writes (fill mode only).
struct Fill {
  const float* disp;  // the (H, W) map the phase starts from
  float* out;         // the (H, W) map it leaves
  int min_d, ts;
  float th;
};

template <bool kFill>
__global__ void __launch_bounds__(kMaxWarps * 32)
    region_vote_kernel(const int* __restrict__ di,
                       const uint8_t* __restrict__ valid,
                       const int* __restrict__ arms,
                       const uint8_t* __restrict__ target,
                       int* __restrict__ out, Fill fill, int D, int H,
                       int W, int max_arm, int pixels) {
  extern __shared__ int smem[];
  __shared__ int n_targets;
  int* list = smem;  // [pixels] target pixel indices
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int HW = H * W;
  int* out_best = out;
  int* out_max = out + HW;
  int* out_count = out + 2 * static_cast<size_t>(HW);

  // The block's targets, listed; zeros everywhere else.
  const int p0 = blockIdx.x * pixels;
  const int n_here = min(pixels, HW - p0);
  if (threadIdx.x == 0) n_targets = 0;
  __syncthreads();
  for (int c = warp * 32; c < n_here; c += warps * 32) {
    const int i = c + lane;
    const int p = p0 + i;
    const bool in = i < n_here;
    bool is_target = in && (target == nullptr || target[p]);
    if constexpr (kFill) {
      const float d = in ? fill.disp[p] : 0.0f;
      is_target = is_target && !isfinite(d);
      if (in && !is_target) fill.out[p] = d;
    } else if (in && !is_target) {
      out_best[p] = 0;
      out_max[p] = 0;
      out_count[p] = 0;
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

  int* hist = smem + pixels + warp * D;
  for (int k = warp; k < n; k += warps) {
    const int p = list[k];
    const int y = p / W;
    const int x = p - y * W;
    for (int d = lane; d < D; d += 32) hist[d] = 0;
    __syncwarp();
    const int* a = arms + 4 * static_cast<size_t>(p);
    const int top = clamp_arm(a[2], max_arm, y);
    const int bottom = clamp_arm(a[3], max_arm, H - 1 - y);
    const int n_rows = top + bottom + 1;
    for (int r0 = 0; r0 < n_rows; r0 += 32) {
      // Lane l holds row r0 + l: its first cell and where its cells start
      // in the flat run of this batch of rows.
      int width = 0, first = 0;
      if (lane < n_rows - r0) {
        const int q0 = (y - top + r0 + lane) * W + x;
        const int* aq = arms + 4 * static_cast<size_t>(q0);
        const int lo = clamp_arm(aq[0], max_arm, x);
        const int hi = clamp_arm(aq[1], max_arm, W - 1 - x);
        width = lo + hi + 1;
        first = q0 - lo;
      }
      int end = width;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFull, end, o);
        if (lane >= o) end += v;
      }
      const int total = __shfl_sync(kFull, end, 31);
      // Lanes past the batch have width 0 and start at total, so start is
      // nondecreasing over the lanes and strictly increasing over rows.
      const int start = end - width;
      for (int k0 = 0; k0 < total; k0 += 32 * kUnroll) {
        int dv[kUnroll];
        bool vote[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          vote[u] = false;
          dv[u] = 0;
          if (k0 + u * 32 < total) {  // uniform over the warp
            const int kc = k0 + u * 32 + lane;
            // the cell's row: the last lane whose start is <= kc
            int j = 0;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1) {
              const int s = __shfl_sync(kFull, start, j + step);
              if (s <= kc) j += step;
            }
            const int q = __shfl_sync(kFull, first, j) +
                          (kc - __shfl_sync(kFull, start, j));
            if (kc < total) {
              if constexpr (kFill) {
                const float d = fill.disp[q];
                vote[u] = isfinite(d);
                if (vote[u]) dv[u] = vote_index(d, fill.min_d, D);
              } else {
                const int v = di[q];
                vote[u] = valid[q] && static_cast<unsigned>(v) <
                                          static_cast<unsigned>(D);
                dv[u] = v;
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const unsigned voters = __ballot_sync(kFull, vote[u]);
          if (vote[u]) {
            const unsigned peers = __match_any_sync(voters, dv[u]);
            if (lane == __ffs(peers) - 1)
              atomicAdd(&hist[dv[u]], __popc(peers));
          }
        }
      }
    }
    __syncwarp();
    int best_c = -1, best_d = kNoBin, sum = 0;
    for (int d = lane; d < D; d += 32) {
      const int c = hist[d];
      if (c > best_c) {
        best_c = c;
        best_d = d;
      }
      sum += c;
    }
    const int max_c = __reduce_max_sync(kFull, best_c);
    const int best =
        __reduce_min_sync(kFull, best_c == max_c ? best_d : kNoBin);
    const int count = static_cast<int>(
        __reduce_add_sync(kFull, static_cast<unsigned>(sum)));
    if (lane == 0) {
      const int max_ht = max(max_c, 0);
      if constexpr (kFill) {
        // a target's own disparity is not finite, so an unfilled target
        // keeps it
        const bool filled =
            max_ht > 0 && count > fill.ts &&
            __fdiv_rn(static_cast<float>(max_ht),
                      static_cast<float>(count)) > fill.th;
        fill.out[p] = filled ? static_cast<float>(best + fill.min_d)
                             : fill.disp[p];
      } else {
        out_best[p] = best;
        out_max[p] = max_ht;
        out_count[p] = count;
      }
    }
    // The next target's zeroing writes only this lane's own bins, which it
    // has read above.
  }
}

// Checks a launch's sizes and geometry and launches the kernel's kFill
// instance; cudaErrorInvalidValue for what it refuses.
template <bool kFill>
int launch(const int* di, const uint8_t* valid, const int* arms,
           const uint8_t* target, int* out, Fill fill, int D, int H, int W,
           int max_arm, int pixels, int warps, int smem, void* stream) {
  if (H < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long hw = static_cast<long long>(H) * W;
  if (hw == 0) return 0;
  if (D < 1 || max_arm < 0 || hw >= (1ll << 31) || pixels < 1 ||
      warps < 1 || warps > kMaxWarps || smem < smem_bytes(pixels, warps, D) ||
      smem > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        region_vote_kernel<kFill>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  region_vote_kernel<kFill><<<adc_blocks(hw, pixels), warps * 32, smem, s>>>(
      di, valid, arms, target, out, fill, D, H, W, max_arm, pixels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// target may be null (every pixel is a target). pixels (a block's run of
// pixels), warps (1 to 32) and smem (dynamic shared bytes) are the launch
// geometry of region_vote_geometry. A geometry whose smem is short of what
// it needs, or that exceeds the card's limit, is refused with
// cudaErrorInvalidValue before any launch, as are D < 1, max_arm < 0 and
// H * W >= 2^31.
ADC_EXPORT int adc_region_vote(const int* di, const uint8_t* valid,
                               const int* arms, const uint8_t* target,
                               int* out, int D, int H, int W, int max_arm,
                               int pixels, int warps, int smem,
                               void* stream) {
  return launch<false>(di, valid, arms, target, out, Fill{}, D, H, W,
                       max_arm, pixels, warps, smem, stream);
}

// Fill mode: one voting phase from the float32 map disp to out (another
// buffer: every target reads the phase's starting map). target is the
// phase mask (null: every pixel); the geometry and the refusals are
// adc_region_vote's.
ADC_EXPORT int adc_region_vote_fill(const float* disp, const int* arms,
                                    const uint8_t* target, float* out,
                                    int D, int H, int W, int max_arm,
                                    int min_d, int ts, float th, int pixels,
                                    int warps, int smem, void* stream) {
  if (disp == out) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(nullptr, nullptr, arms, target, nullptr,
                      Fill{disp, out, min_d, ts, th}, D, H, W, max_arm,
                      pixels, warps, smem, stream);
}
