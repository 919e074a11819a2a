// Kernel M2: depth-discontinuity adjustment of edge pixels, Sobel mask
// included.
//
// Replaces adcensus_tpu/stages/refine.py:depth_discontinuity_adjustment,
// a lax.scan over columns (not a Pallas kernel), edge_detect included;
// the reference is multistep_refiner.cpp:307-371. An interior pixel
// (y, x) is adjustable if it is a Sobel edge pixel (|gx| + |gy| > 5 in
// the port's order of float32 operations) and its disparity d is finite
// with lround(d) in [0, D). There, starting from c0 = cost[lround(d), y,
// x]:
//   the left neighbour's final value dl (already adjusted) replaces d
//   if its index is in range and cost[lround(dl), y, x-1] < c0, which
//   then becomes c0;
//   the right neighbour's original value dr replaces it if its index is
//   in range and cost[lround(dr), y, x+1] < c0.
// The cost is indexed by lround(d) (half away from zero) without
// subtracting min_disparity, as the reference does.
//
// Bound on the H100. The function reads the map and writes it (8 B a
// pixel), and at most three cost cells an adjustable pixel (the kernel
// gathers up to four off the chain, and one a round on it). What
// bounds a row is its chain: column x needs column x-1's final value
// where x-1 is adjustable, and that value's cost in column x-1 is a
// gather at a carried index. chip_smoke.py prints the chain bound of the
// plain scan (the case's longest run of pixels that each take the value
// on their left, times the cycles of one chained step, timed by
// adc_dda_chain_cycles below, over the top SM clock) beside the bytes
// bound.
//
// Design: a warp a row, kWarps rows a block, lane j on column x0 + j of
// 32-column chunks.
// - Loads run two chunks ahead, in two register sets: rows y-1, y, y+1 of
//   the chunk (coalesced), and lane 0 also loads column x0 + 32. The
//   row's neighbours come by shuffle: lane 0's left from lane 31's copy
//   of the chunk before, lane 31's right from lane 0's extra load.
// - prepare: the Sobel, the adjustable lanes, and the gathers that do not
//   depend on the chain, all lanes at once: the own cost, the right
//   neighbour's cost at its value, and in the left column the left
//   neighbour's original value's cost and the own value's. Chunk k + 1 is
//   prepared before chunk k is resolved, so its gathers are in flight
//   meanwhile.
// - resolve: the final value of column x-1 is one of three: its original
//   value (kL in column x's terms), column x's value, taken from the
//   right (kO), or the value column x-1 itself took from its left. Each
//   lane computes off the chain its output for kL and for kO, and names
//   each output in the next lane's terms (kL, kO, or kU for a value passed
//   on from the left). A lane that is not adjustable outputs kL whatever
//   its input. An exclusive scan over the warp composes these maps, so
//   every lane whose input is not kU is final at once. The rest wait on
//   the order: a round takes as its frontier the lane left of the lowest
//   waiting lane (or the carry), gathers cost[lround v, y, x-1] at the
//   frontier's value v in every lane still waiting (the input kV, which a
//   lane passes on as kV), and scans again. A round settles at least the
//   lane after the frontier, and a value that propagates along a run
//   settles the whole run; only a value passed on from a lane's original
//   left neighbour (kL, then taken again) starts a round.
// - Outputs are stored 32 columns at a time, coalesced; lane 31's final
//   value is carried into the next chunk, where lane 0 names it kO or kL
//   if it is one of those values.
// It only compares and selects, apart from the Sobel's float32 ops
// (-fmad=false), so it equals the plain version bit for bit. No shared
// memory, no host sync and no allocation: the kernel runs inside a CUDA
// graph capture.
#include "common.cuh"

namespace {

// ops/dda.py holds the same constants (without the k)
constexpr int kWarp = 32;
constexpr int kWarps = 4;  // warps (rows) a block
constexpr float kThreshold = 5.0f;
constexpr unsigned kFull = 0xffffffffu;

// lround(v) (half away from zero) in [0, D) for a finite v: the index and
// whether it is in range, as ops/dda.py:_rounded_idx.
__device__ __forceinline__ bool index_of(float v, int D, int* di) {
  if (!isfinite(v)) return false;
  *di = static_cast<int>(v >= 0.0f ? floorf(v + 0.5f) : ceilf(v - 0.5f));
  return *di >= 0 && *di < D;
}

// One register set of loads: the chunk's three rows, and column x0 + 32's
// in lane 0 (e*).
struct Raw {
  float u, m, b, eu, em, eb;
};

// A lane's prepared column: its original value m, its neighbours' (lm,
// rd) and whether their indices are in range, whether it and its left
// neighbour are adjustable, and the costs gathered for an adjustable lane:
// its own (c0), the right neighbour's at its value (rc), and in the left
// column the left neighbour's original value's (lc) and, where the left
// neighbour is adjustable and so may have taken this lane's value, the
// own value's (clo).
struct Lane {
  float m, lm, rd, c0, lc, rc, clo;
  bool adj, ladj, lok, rok;
};

// The lane's output when its left neighbour's final value is v, at cost
// vc in the left column (taken only if vok).
__device__ __forceinline__ float pick(const Lane& p, float v, bool vok,
                                      float vc) {
  float t = p.m;
  float c = p.c0;
  if (vok && vc < c) {
    t = v;
    c = vc;
  }
  if (p.rok && p.rc < c) t = p.rd;
  return t;
}

struct Row {
  const float* drow;  // disp[y, :]
  const float* crow;  // cost[0, y, :]; cost[d, y, x] = crow[d * plane + x]
  float* orow;
  long long plane;  // H * W
  int W, D, lane;
  bool inner;  // 1 <= y <= H - 2: rows y - 1 and y + 1 exist
};

// Chunk x0's loads into r: 0 past the row's end and, in a border row, for
// the rows above and below.
__device__ __forceinline__ void load(const Row& w, Raw& r, int x0) {
  const int x = x0 + w.lane;
  const int e = x0 + kWarp;
  r = Raw{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (x < w.W) r.m = w.drow[x];
  if (w.lane == 0 && e < w.W) r.em = w.drow[e];
  if (w.inner) {
    if (x < w.W) {
      r.u = w.drow[x - w.W];
      r.b = w.drow[x + w.W];
    }
    if (w.lane == 0 && e < w.W) {
      r.eu = w.drow[e - w.W];
      r.eb = w.drow[e + w.W];
    }
  }
}

// The chunk before's lane-31 values, for lane 0's left: each lane keeps
// its own, and lane 31's are read by shuffle.
struct Halo {
  float u, m, b;
  bool adj;
};

// Chunk x0 from r (loaded two chunks ago): the Sobel, the adjustable
// lanes, the gathers off the chain into p; then the halo kept and chunk
// x0 + 64 loaded into r.
__device__ __forceinline__ void prepare(const Row& w, Raw& r, Halo& h,
                                        Lane& p, int x0) {
  const int lane = w.lane;
  const int x = x0 + lane;
  const int left = (lane + kWarp - 1) & (kWarp - 1);
  const int right = (lane + 1) & (kWarp - 1);
  const bool last = lane == kWarp - 1;
  const bool first = lane == 0;
  const float ul = __shfl_sync(kFull, last ? h.u : r.u, left);
  const float l = __shfl_sync(kFull, last ? h.m : r.m, left);
  const float bl = __shfl_sync(kFull, last ? h.b : r.b, left);
  const float ur = __shfl_sync(kFull, first ? r.eu : r.u, right);
  const float rv = __shfl_sync(kFull, first ? r.em : r.m, right);
  const float br = __shfl_sync(kFull, first ? r.eb : r.b, right);
  // edge_detect's order: Python evaluates the sums left to right
  const float gx = ((((-ul + ur) - 2.0f * l) + 2.0f * rv) - bl) + br;
  const float gy = ((((-ul - 2.0f * r.u) - ur) + bl) + 2.0f * r.b) + br;
  const bool edge = (fabsf(gx) + fabsf(gy)) > kThreshold;  // NaN: false
  int di = 0, li = 0, ri = 0;
  const bool own_ok = index_of(r.m, w.D, &di);
  p.m = r.m;
  p.adj = w.inner && x >= 1 && x <= w.W - 2 && edge && own_ok;
  p.ladj = __shfl_sync(kFull, last ? h.adj : p.adj, left);
  p.lm = l;
  p.lok = index_of(l, w.D, &li);
  p.rd = rv;
  p.rok = index_of(rv, w.D, &ri);
  p.c0 = p.adj ? w.crow[di * w.plane + x] : 0.0f;
  p.lc = p.adj && p.lok ? w.crow[li * w.plane + x - 1] : 0.0f;
  p.rc = p.adj && p.rok ? w.crow[ri * w.plane + x + 1] : 0.0f;
  p.clo = p.adj && p.ladj ? w.crow[di * w.plane + x - 1] : 0.0f;
  h = Halo{r.u, r.m, r.b, p.adj};
  load(w, r, x0 + 2 * kWarp);
}

// Symbols of a lane's input, in that lane's terms: the frontier's value
// (kV), the left neighbour's original value (kL), the own value (kO), or
// another (kU). A lane's map from its input's symbol to its output's
// symbol in the next lane's terms is 4 bytes, byte s the image of s.
constexpr unsigned kV = 0, kL = 1, kO = 2, kU = 3;
constexpr unsigned kIdentity = 0x03020100u;  // s -> s
constexpr unsigned kConstL = 0x01010101u;    // a lane that is not adjustable

// The map a after b: one byte permute of a, selected by b's bytes packed
// into nibbles.
__device__ __forceinline__ unsigned after(unsigned a, unsigned b) {
  const unsigned x = b | (b >> 4);
  return __byte_perm(a, 0, (x & 0xFFu) | ((x >> 8) & 0xFF00u));
}

// The symbol, in the next lane's terms, of this lane's output t: kL where
// it is this lane's value, kO where it is the next lane's, else kU.
__device__ __forceinline__ unsigned symbol(const Lane& p, float t) {
  const unsigned bits = __float_as_uint(t);
  return bits == __float_as_uint(p.m) ? kL
         : bits == __float_as_uint(p.rd) ? kO
                                          : kU;
}

__device__ __forceinline__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// Chunk x0's outputs from p and the value carried from the chunk before;
// carry becomes lane 31's final value. Counts the chunk's scans and its
// rounds with a gather into *scans and *gathers.
__device__ __forceinline__ void resolve(const Row& w, const Lane& p, int x0,
                                        float& carry, int* scans,
                                        int* gathers) {
  const int lane = w.lane;
  const int x = x0 + lane;
  float out = p.m;
  unsigned pend = __ballot_sync(kFull, p.adj);
  if (pend) {
    // the outputs for the inputs kL and kO, from gathers off the chain
    const float val_l = pick(p, p.lm, p.lok, p.lc);
    const float val_o = pick(p, p.m, true, p.clo);
    const unsigned code_lo =
        p.adj ? (symbol(p, val_l) << 8) | (symbol(p, val_o) << 16) | (kU << 24)
              : kConstL;
    // lane 0's input: the carry, named kO or kL where it is one of those
    const float lm0 = __shfl_sync(kFull, p.lm, 0);
    const float m0 = __shfl_sync(kFull, p.m, 0);
    int f = -1;  // the frontier: lanes up to f are final
    float v = carry;
    unsigned s = kL;
    if (pend & __ballot_sync(kFull, p.ladj) & 1u)
      s = same(v, m0) ? kO : same(v, lm0) ? kL : kV;
    while (true) {
      const bool mine = (pend >> lane) & 1u;
      float val_v = 0.0f;
      unsigned t_v = kU;
      ++*scans;
      if (s == kV) {  // a gather at the frontier's value, all lanes at once
        ++*gathers;
        int vi = 0;
        const bool vok = index_of(v, w.D, &vi);
        const float vc = mine && vok ? w.crow[vi * w.plane + x - 1] : 0.0f;
        val_v = pick(p, v, vok, vc);
        t_v = !mine ? kU : same(val_v, v) ? kV : symbol(p, val_v);
      }
      // each lane's input symbol: the maps of the lanes after the frontier
      // composed by an exclusive scan, applied to s
      unsigned acc = lane <= f ? kIdentity : p.adj ? code_lo | t_v : kConstL;
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const unsigned other = __shfl_up_sync(kFull, acc, d);
        if (lane >= d) acc = after(acc, other);
      }
      unsigned ex = __shfl_up_sync(kFull, acc, 1);
      if (lane == 0) ex = kIdentity;
      const unsigned in = (ex >> (8 * s)) & 0xFFu;
      const bool got = mine && in != kU;
      if (got) out = in == kV ? val_v : in == kL ? val_l : val_o;
      pend &= ~__ballot_sync(kFull, got);
      if (!pend) break;
      // the lowest lane still waiting takes a value not in its terms: the
      // next round starts from the lane on its left
      f = __ffs(pend) - 2;
      v = __shfl_sync(kFull, out, f);
      s = kV;
    }
  }
  if (x < w.W) w.orow[x] = out;
  carry = __shfl_sync(kFull, out, kWarp - 1);
}

// counts, if not null: each row's scans and rounds with a gather, at
// 2y and 2y + 1.
__global__ void __launch_bounds__(kWarps * kWarp)
    dda_kernel(const float* __restrict__ disp, const float* __restrict__ cost,
               float* __restrict__ out, int* __restrict__ counts, int D,
               int H, int W) {
  const int y = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (y >= H) return;  // the whole warp
  const long long row = static_cast<long long>(y) * W;
  const Row w{disp + row, cost + row, out + row,
              static_cast<long long>(H) * W, W, D,
              static_cast<int>(threadIdx.x & (kWarp - 1)),
              y >= 1 && y <= H - 2};
  const int n = (W + kWarp - 1) / kWarp;
  Raw r0, r1;  // chunks of even and odd index
  Halo h{0.0f, 0.0f, 0.0f, false};
  Lane a, b;  // prepared chunks of even and odd index
  float carry = 0.0f;
  int scans = 0, gathers = 0;
  load(w, r0, 0);
  load(w, r1, kWarp);
  prepare(w, r0, h, a, 0);
  for (int k = 0; k < n; k += 2) {
    const int x0 = k * kWarp;
    if (k + 1 < n) prepare(w, r1, h, b, x0 + kWarp);
    resolve(w, a, x0, carry, &scans, &gathers);
    if (k + 1 >= n) break;
    if (k + 2 < n) prepare(w, r0, h, a, x0 + 2 * kWarp);
    resolve(w, b, x0 + kWarp, carry, &scans, &gathers);
  }
  if (counts != nullptr && w.lane == 0) {
    counts[2 * y] = scans;
    counts[2 * y + 1] = gathers;
  }
}

// The chain probe: one warp whose lanes each run `steps` chained steps of
// an L2 gather at a carried index, a compare, a select and an lround, as
// resolve's rounds do; table is (D, stride) float32 of values in [0, D),
// so each gathered value is the next index. Its clock64 cycles go to
// *cycles and its last values to sink[0..31].
__global__ void chain_probe_kernel(long long* cycles,
                                   const float* __restrict__ table, int D,
                                   int stride, int steps, float* sink) {
  const int lane = threadIdx.x;
  float v = static_cast<float>(lane % D);
  const float c0 = ADC_LARGE_FLOAT;
  __syncwarp();
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
    int vi = 0;
    const bool vok = index_of(v, D, &vi);
    const float c = vok ? __ldcg(table + vi * static_cast<long long>(stride) +
                                 lane)
                        : c0;
    v = c < c0 ? c : v;
  }
  __syncwarp();
  const long long t1 = clock64();
  sink[lane] = v;
  if (lane == 0) *cycles = t1 - t0;
}

}  // namespace

// The adjusted (H, W) float32 map of `disp` into `out` (a different
// buffer): cost is (D, H, W) float32. A warp a row, kWarps rows a block.
// D < 1, H < 0 or W < 0 is refused with cudaErrorInvalidValue. With
// counts (2H ints, adc_dda_counts), each row's scans and gather rounds
// too, for chip_smoke.py's labels; its launches are not counted.
ADC_EXPORT int adc_dda_counts(const float* disp, const float* cost,
                              float* out, int* counts, int D, int H, int W,
                              void* stream) {
  if (D < 1 || H < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0 || W == 0) return 0;
  dda_kernel<<<adc_blocks(H, kWarps), kWarps * kWarp, 0,
               static_cast<cudaStream_t>(stream)>>>(disp, cost, out, counts,
                                                    D, H, W);
  return static_cast<int>(cudaGetLastError());
}

ADC_EXPORT int adc_dda(const float* disp, const float* cost, float* out,
                       int D, int H, int W, void* stream) {
  return adc_dda_counts(disp, cost, out, nullptr, D, H, W, stream);
}

// The cycles of `steps` chained steps of one warp (chain_probe_kernel)
// into *cycles; table is (D, stride) float32 with values in [0, D) and
// stride >= 32, sink 32 floats.
ADC_EXPORT int adc_dda_chain_cycles(long long* cycles, const float* table,
                                    int D, int stride, int steps, float* sink,
                                    void* stream) {
  if (D < 1 || stride < kWarp || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  chain_probe_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      cycles, table, D, stride, steps, sink);
  return static_cast<int>(cudaGetLastError());
}
