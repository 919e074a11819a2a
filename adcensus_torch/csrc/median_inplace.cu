// Kernel M1: the reference's in-place 3x3 median.
//
// Replaces adcensus_tpu/stages/refine.py:median_filter_3x3_inplace, a
// lax.scan over the W + 2H columns of the sheared map (not a Pallas
// kernel); the reference is adcensus_util.cpp:55-81 called with in == out
// at multistep_refiner.cpp:86. Pixel (y, x) takes the median of its
// border-clipped 3x3 window in raster order: the filtered values at
// (y, x-1), (y-1, x-1), (y-1, x) and (y-1, x+1), the original values
// elsewhere. The median is the (population // 2)-th smallest of the
// in-image values, the population (4, 6 or 9, fewer on a map one pixel
// wide or high) counting in-image +inf values.
//
// Bound on the H100. The function reads and writes the map once (8 B a
// pixel, 0.0004 ms at Cone size at 3.35 TB/s). What bounds it is the
// recurrence: under t = x + 2y every filtered value a pixel reads lies on
// wavefronts t-1 to t-3, so the W + 2H - 2 wavefronts run one after
// another, and a wavefront can take no less than its critical chain: the
// up-right value from wavefront t-1 handed to the pixel and merged, and
// the result handed on. chip_smoke.py times that chain as this kernel
// runs it (adc_median_chain_cycles below) and prints the recurrence bound
// beside the bytes bound.
//
// Design: one block, a thread a row, a pixel a step, one __syncthreads a
// step; thread i owns rows i, i + threads, ... in bands when the map has
// more rows than the block (bands of about W / 2 + 64 rows, the rows a
// band has at work at once), and walks them one after another
// (ops/median.py:median_inplace_geometry and median_inplace_schedule).
// On the path from one wavefront to the next, only:
// - the hand-off. Each thread keeps its own last output (the left value)
//   in a register and receives the row above's output of the step before
//   (the up-right value) by __shfl_up_sync. The up and up-left values are
//   the up-right values of one and two steps back. Across a warp boundary
//   the value goes through a shared ring of each warp's last lane's
//   outputs, four steps deep and indexed by t mod 4. A band's first row
//   reads the last row of the band before it from `out`, where that row's
//   thread stores at once, through a cp.async queue issued LAG steps
//   ahead of its use and after the store.
// - the late merge. The seven values known a step early (the five
//   originals, up, up-left) are sorted (six by a 12-comparator network,
//   the seventh inserted) and merged with the left value off the path.
//   Rank 4 of the nine is always the answer: an out-of-image slot is
//   -inf or +inf by a fixed table a map class (H, W >= 2: the four edge
//   middles -inf, the corners +inf) so that 4 - population // 2 of them
//   sort first. So the up-right value meets two min/max: max(min(V4, b),
//   V3). An out-of-image up-right value is folded into V3 and V4 early.
// - originals never wait. Each warp keeps 33 rows of originals (its 32
//   and the row below) in a shared ring of 32 columns; every step it
//   refills two rows with 16 columns each by cp.async (coalesced,
//   16 columns ahead of the row), and cp.async.wait_group keeps LAG steps
//   of copies in flight. A thread reads its two new originals a step from
//   the ring and slides a 5-value window in registers.
// - filtered values go to a shared ring of 16 columns a row, and a
//   half-warp stores 16 consecutive columns of one row (two rows a step),
//   so `out` is written once a pixel, coalesced, and never read but at a
//   band's first row.
// A warp whose rows are all before or past their pixels skips the merge
// and the sort, and on a map of one band also the refills and stores when
// none is in the image. No host sync and no allocation: the kernel runs
// inside a CUDA graph capture.
//
// The min/max network picks the same value as the plain version's
// torch.sort for any map without NaN and without -0.0 and +0.0 in one
// window (their order is defined by neither).
#include "common.cuh"

namespace {

// ops/median.py holds the same constants (without the k)
constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxHeight = 1 << 22;  // band columns below 2^24: float-exact
constexpr int kInRing = 32;          // columns of originals a stream keeps
constexpr int kChunk = 16;           // columns a refill brings
constexpr int kLead = 16;            // a refill's lead on its stream
constexpr int kLag = 12;             // steps from a refill to its first read
constexpr int kOutRing = 16;         // filtered columns a row keeps
constexpr int kHandoff = 4;          // steps of the warp-boundary ring
constexpr int kWrap = 32;            // slots of the band-boundary queue
constexpr int kMargin = 2;           // steps before a row's start in its band
constexpr int kFirstStep = -(kLead + kChunk);
constexpr int kTail = kChunk;
constexpr int kInPitch = kInRing + 1;  // odd pitches: no bank conflicts
constexpr int kOutPitch = kOutRing + 1;
constexpr int kWarpFloats =
    (kWarp + 1) * kInPitch + kWarp * kOutPitch + kHandoff;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kLag <= kLead - 4 && kLead + kChunk - 1 - kInRing < 2,
              "a refill lands before its first read and after its slot's "
              "last read");

// Map classes and their out-of-image pads: true is -inf. Rank 4 of the
// nine is the (population // 2)-th smallest of the in-image values when
// 4 - population // 2 of the out-of-image slots are -inf.
enum MapClass { kGeneral, kOneRow, kOneColumn, kOnePixel };

template <int C>
struct NegPad {
  static constexpr bool ul = C != kGeneral;
  static constexpr bool u = C != kOneColumn;
  static constexpr bool ur = C == kOneRow || C == kOnePixel;
  static constexpr bool lf = C != kOneRow;
  static constexpr bool r = C == kGeneral;
  static constexpr bool bl = C == kOneColumn;
  static constexpr bool b = C == kGeneral;
  static constexpr bool br = false;
};

__device__ __forceinline__ void order(float& a, float& b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// A 4-byte cp.async into shared address `dst` of *src if `ok`, else of
// zero (reading nothing; `base`, a valid address, stands in for src): no
// branch. A column outside the image fills its slot with zero: the
// slot's last column is dead, and nothing reads the new one unpadded.
__device__ __forceinline__ void copy_or_zero(unsigned dst, const float* src,
                                             bool ok, const float* base) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(ok ? src : base), "r"(ok ? 4 : 0)
               : "memory");
}

// floor(v / period) for 0 <= v < 2^24: a float quotient, then one
// correction step
__device__ __forceinline__ int band_of(int v, int period, float inv) {
  int k = __float2int_rz(__int2float_rn(v) * inv);
  const int x = v - k * period;
  return k + (x >= period) - (x < 0);
}

struct Map {
  const float* in;
  float* out;
  int H, W;
  int period;  // 2 * threads + E (banded)
  float inv_period;
  int last_step;
};

// Row and column of virtual column v of a stream whose band-0 row is
// row0; ok if the pixel is in the image.
template <bool kBanded>
__device__ __forceinline__ bool locate(const Map& m, int row0, int v,
                                       int& g, int& x) {
  int k = 0;
  x = v;
  if (kBanded) {
    k = band_of(v < 0 ? 0 : v, m.period, m.inv_period);
    x = v - k * m.period;
  }
  g = k * static_cast<int>(blockDim.x) + row0;
  return v >= 0 && x < m.W && g < m.H;
}

// A virtual column as (band, column in the band), moved by d (|d| <
// period) a step without a division; one band: k = 0, x = v.
struct Col {
  int k, x;
};

template <bool kBanded>
__device__ __forceinline__ void advance(Col& c, int d, int period) {
  c.x += d;
  if (kBanded) {
    if (c.x >= period) {
      c.x -= period;
      ++c.k;
    } else if (c.x < 0 && c.k > 0) {
      c.x += period;
      --c.k;
    }
  }
}

template <bool kBanded, int kClass>
__global__ void __launch_bounds__(kMaxThreads)
    median_inplace_kernel(const Map m) {
  using Neg = NegPad<kClass>;
  const float inf = __int_as_float(0x7f800000);
  const float pad_ul = Neg::ul ? -inf : inf, pad_u = Neg::u ? -inf : inf;
  const float pad_lf = Neg::lf ? -inf : inf, pad_r = Neg::r ? -inf : inf;
  const float pad_bl = Neg::bl ? -inf : inf, pad_b = Neg::b ? -inf : inf;
  const float pad_br = Neg::br ? -inf : inf;

  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  float* in_ring = smem + warp * kWarpFloats;           // (33, kInPitch)
  float* out_ring = in_ring + (kWarp + 1) * kInPitch;   // (32, kOutPitch)
  float* handoff = out_ring + kWarp * kOutPitch;        // (kHandoff,)
  float* wrapq = smem + threads / kWarp * kWarpFloats;  // (kWrap,)
  const unsigned in_ring_s =
      static_cast<unsigned>(__cvta_generic_to_shared(in_ring));
  const unsigned wrapq_s =
      static_cast<unsigned>(__cvta_generic_to_shared(wrapq));
  // lane 0's source of the up-right value: the warp above's ring, or the
  // band-boundary queue
  const float* from = warp ? handoff - kWarpFloats : wrapq;

  float b_next = inf;  // the up-right value of the next step (shuffled)
  float u = inf;       // the up-right value of the step before
  float w0 = inf, w1 = inf, w2 = inf, w3 = inf, w4 = inf;  // originals
  float v3 = inf, v4 = inf;  // ranks 3 and 4 of the eight known values
  int x = kFirstStep - 2 * tid, k = 0, y = tid;
  // the half-warp's stream for refills and stores, relative to t mod 16,
  // and their columns (stream t mod 16 + 16 * half at step t)
  const int half_row = warp * kWarp + (lane & 16);
  const int col = lane & (kChunk - 1);
  static_assert((kFirstStep & (kChunk - 1)) == 0, "the walk starts at phase 0");
  Col cr = {0, kFirstStep - 2 * half_row + kLead + col};  // refill
  Col cs = {0, cr.x - kLead - kChunk};                    // store
  Col cw = {0, kFirstStep + kLag};  // thread 0's queue: the step it fills

  for (int t = kFirstStep; t <= m.last_step + kTail; ++t) {
    const int v = t - 2 * tid;
    int xn = x + 1, kn = k;
    if (kBanded && xn == m.period - kMargin) {
      xn = -kMargin;
      ++kn;
    }
    const int yn = kn * threads + tid;
    const bool busy = x >= -kMargin && x <= m.W + 1 && y < m.H;
    // refills and stores, unless a one-band warp has no column of its 33
    // streams in the image within their reach: [v0 - 78, v0 + 31]
    const int v0 = t - 2 * warp * kWarp;
    const bool io = kBanded || (v0 + kLead + kChunk - 1 >= 0 &&
                                v0 - 2 * kWarp - kChunk < m.W);
    const int phase = t & (kChunk - 1);
    const int rho = phase + (lane & 16);
    const int row = half_row + phase;
    const int gs = cs.k * threads + row;
    const bool store = io && cs.x >= 0 && cs.x < m.W && gs < m.H;
    // a warp with a row near its pixels loads pixel x+1's two new
    // originals and lane 0 the up-right value first; their latency runs
    // under the refills
    const bool merge = __any_sync(kFull, busy);
    const int slot = (v + 2) & (kInRing - 1);
    float own = 0.0f, below = 0.0f, b = b_next;
    if (merge) {
      own = in_ring[lane * kInPitch + slot];
      below = in_ring[(lane + 1) * kInPitch + slot];
      const float above = from[warp ? (t - 1) & (kHandoff - 1)
                                    : t & (kWrap - 1)];  // a broadcast
      b = lane == 0 ? above : b_next;
    }
    float stored = 0.0f;
    if (io) {
      // the store's value first (streams t mod 16 and that + 16, the 16
      // columns up to the step before), read before this step's write to
      // its slot
      stored = out_ring[rho * kOutPitch +
                        ((cs.k * m.period + cs.x) & (kOutRing - 1))];
      // refills: the same two streams (half-warps), at t mod 16 = 0 also
      // the row below the warp (the first half-warp); the band-boundary
      // queue (thread 0)
      int g = cr.k * threads + row;
      bool ok = cr.x >= 0 && cr.x < m.W && g < m.H;
      copy_or_zero(in_ring_s + 4 * (rho * kInPitch + ((cr.k * m.period + cr.x) &
                                                      (kInRing - 1))),
                   m.in + static_cast<size_t>(g) * m.W + cr.x, ok, m.in);
      if (phase == 0 && lane < kChunk) {
        const int v32 = t - 2 * (warp * kWarp + kWarp) + kLead + col;
        int xx;
        ok = locate<kBanded>(m, warp * kWarp + kWarp, v32, g, xx);
        copy_or_zero(in_ring_s + 4 * (kWarp * kInPitch + (v32 & (kInRing - 1))),
                     m.in + static_cast<size_t>(g) * m.W + xx, ok, m.in);
      }
      if (kBanded && tid == 0) {
        const int xw = cw.x + 1;
        ok = cw.k >= 1 && cw.k * threads < m.H && xw >= 0 && xw < m.W;
        copy_or_zero(wrapq_s + 4 * ((t + kLag) & (kWrap - 1)),
                     m.out + static_cast<size_t>(cw.k * threads - 1) * m.W + xw,
                     ok, m.out);
      }
    }
    __syncwarp();
    if (merge) {
      // the critical path: merge the up-right value, hand the result on
      const float z = fmaxf(fminf(v4, b), v3);
      out_ring[lane * kOutPitch + (v & (kOutRing - 1))] = z;
      if (lane == kWarp - 1) handoff[t & (kHandoff - 1)] = z;
      if (kBanded && tid == threads - 1 && x >= 0 && x < m.W && y < m.H)
        m.out[static_cast<size_t>(y) * m.W + x] = z;  // a band's first row
      b_next = __shfl_up_sync(kFull, z, 1);

      // off the path: pixel x+1's eight known values
      w0 = w1;
      w1 = own;
      w2 = w3;
      w3 = w4;
      w4 = below;
      const bool up = yn > 0, down = yn < m.H - 1;
      const bool left = xn > 0, right = xn < m.W - 1;
      float e0 = up && left ? u : pad_ul;
      float e1 = w0;
      float e2 = right ? w1 : pad_r;
      float e3 = down && left ? w2 : pad_bl;
      float e4 = down ? w3 : pad_b;
      float e5 = down && right ? w4 : pad_br;
      order(e0, e5);
      order(e1, e3);
      order(e2, e4);
      order(e1, e2);
      order(e3, e4);
      order(e0, e3);
      order(e2, e5);
      order(e0, e1);
      order(e2, e3);
      order(e4, e5);
      order(e1, e2);
      order(e3, e4);
      const float uu = up ? b : pad_u;  // the seventh: up, this step's b
      const float s2 = fmaxf(fminf(e2, uu), e1);
      const float s3 = fmaxf(fminf(e3, uu), e2);
      const float s4 = fmaxf(fminf(e4, uu), e3);
      const float a = left ? z : pad_lf;  // the eighth: left, this step's z
      const float r3 = fmaxf(fminf(s3, a), s2);
      const float r4 = fmaxf(fminf(s4, a), s3);
      const bool ur_out = !(up && right);
      v3 = ur_out && !Neg::ur ? r4 : r3;  // max(min(V4, pad), V3) folded
      v4 = ur_out && Neg::ur ? r3 : r4;
      u = b;
    }
    if (store) m.out[static_cast<size_t>(gs) * m.W + cs.x] = stored;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLag - 1) : "memory");
    __syncthreads();
    x = xn;
    k = kn;
    y = yn;
    const int d = ((t + 1) & (kChunk - 1)) ? -1 : 2 * kChunk - 1;
    advance<kBanded>(cr, d, m.period);
    advance<kBanded>(cs, d, m.period);
    if (kBanded && ++cw.x == m.period - kMargin) {
      cw.x = -kMargin;
      ++cw.k;
    }
  }
}

template <bool kBanded, int kClass>
cudaError_t launch(const Map& m, int threads, int smem, cudaStream_t s) {
  static bool attr_set = false;  // once per instance: the H100's limit
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        median_inplace_kernel<kBanded, kClass>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (kMaxThreads / kWarp * kWarpFloats + kWrap) * 4);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  median_inplace_kernel<kBanded, kClass><<<1, threads, smem, s>>>(m);
  return cudaGetLastError();
}

// The critical chain of the kernel's steps, as it runs them, on `threads`
// threads: the merge of the up-right value (two min/max), the hand-on by
// __shfl_up_sync and by the last lane to the warp's t mod 4 ring, the
// barrier, and lane 0's read of the ring of the warp above. Nothing else
// runs.
__global__ void chain_probe_kernel(long long* cycles, float* sink,
                                   int steps) {
  __shared__ float ring[kHandoff * kMaxThreads / kWarp];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int warps = blockDim.x / kWarp;
  const float* from = ring + (warp + warps - 1) % warps * kHandoff;
  const float v3 = 0.5f * tid, v4 = v3 + 1.0f;
  float b = 0.25f * tid;
  for (int i = tid; i < kHandoff * warps; i += blockDim.x) ring[i] = 0.0f;
  __syncthreads();
  const long long t0 = clock64();
  for (int t = 0; t < steps; ++t) {
    const float z = fmaxf(fminf(v4, b), v3);
    if (lane == kWarp - 1) ring[warp * kHandoff + (t & (kHandoff - 1))] = z;
    b = __shfl_up_sync(kFull, z, 1);
    __syncthreads();
    const float above = from[t & (kHandoff - 1)];
    b = lane == 0 ? above : b;
  }
  const long long t1 = clock64();
  sink[tid] = b;
  if (tid == 0) *cycles = t1 - t0;
}

}  // namespace

// The in-place median of the (H, W) float32 map `in` into `out` (a
// different buffer of the same size). One block; its geometry and walk
// are ops/median.py:median_inplace_geometry and median_inplace_schedule.
// H < 1, W < 1, H * W >= 2^31, H > 2^22 and a walk of 2^31 steps or more
// are refused with cudaErrorInvalidValue.
ADC_EXPORT int adc_median_inplace(const float* in, float* out, int H, int W,
                                  void* stream) {
  if (H < 1 || W < 1 || static_cast<long long>(H) * W >= (1ll << 31) ||
      H > kMaxHeight)
    return static_cast<int>(cudaErrorInvalidValue);
  // a thread a row up to kMaxThreads rows; taller maps in bands of
  // about W / 2 rows (the rows a band has at work at once), at most
  // kMaxThreads
  const int wide = (W / 2 + 2 * kWarp) / kWarp * kWarp;
  const int threads = H <= kMaxThreads ? (H + kWarp - 1) / kWarp * kWarp
                      : wide < kMaxThreads ? wide : kMaxThreads;
  const int rows = (H + threads - 1) / threads;
  const bool banded = rows > 1;
  const int lead = W - 2 * threads + kMargin;
  const int delay = !banded ? 0 : lead > kLag ? lead : kLag;
  const int period = 2 * threads + delay;
  const long long last = W - 1 + 2ll * ((H - 1) % threads) +
                         static_cast<long long>((H - 1) / threads) * period;
  if (last + kTail + kLead + kChunk >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Map m;
  m.in = in;
  m.out = out;
  m.H = H;
  m.W = W;
  m.period = period;
  m.inv_period = 1.0f / static_cast<float>(period);
  m.last_step = static_cast<int>(last);
  const int smem = (threads / kWarp * kWarpFloats + kWrap) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (H == 1)
    e = W == 1 ? launch<false, kOnePixel>(m, threads, smem, s)
               : launch<false, kOneRow>(m, threads, smem, s);
  else if (W == 1)
    e = banded ? launch<true, kOneColumn>(m, threads, smem, s)
               : launch<false, kOneColumn>(m, threads, smem, s);
  else
    e = banded ? launch<true, kGeneral>(m, threads, smem, s)
               : launch<false, kGeneral>(m, threads, smem, s);
  return static_cast<int>(e);
}

// Cycles (clock64) of `steps` steps of the kernel's critical chain on one
// block of `threads` (a multiple of 32, at most 1024) threads, into
// cycles[0]; sink (threads floats) keeps the chain's result live.
ADC_EXPORT int adc_median_chain_cycles(long long* cycles, float* sink,
                                       int threads, int steps,
                                       void* stream) {
  if (threads < kWarp || threads > kMaxThreads || threads % kWarp ||
      steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  chain_probe_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      cycles, sink, steps);
  return static_cast<int>(cudaGetLastError());
}
