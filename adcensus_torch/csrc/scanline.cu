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
// The penalty code picks (P1, P2), (P1, P2)/4 or (P1, P2)/10; the six
// constants arrive as float32 values computed on the host. The kernel
// derives each cell's code itself from two per-pixel flag maps, the left
// image's d1 >= tso at the volume's pixels and the right image's
// rd >= tso at full width: code = f1[y, x] + (d2 >= tso), where d2 is
// d1 when xr = x - d - min_disp >= real_w - 1 or x - min_disp <= 0, and
// rd[y, clamp(xr, 1, W_full - 1)] otherwise (the reference's sticky
// lookup, ops/scanline.py:penalty_codes). No (D, H, W) code volume
// exists. Each scan step
// has a flag: PAD passes the carry through and writes the raw cost, SEED
// copies the cost into the carry, NORMAL runs the recurrence. Every
// operation is an elementwise min, add or multiply, built with
// -fmad=false, so the result is bitwise the plain version's.
//
// Two floors on the H100. Bytes: each cell reads 4 B of cost and writes
// 4 B of Lr, 86 MB at 64x375x450, 0.026 ms at 3.35 TB/s (the flag maps
// add 2 B a pixel).
// Latency: a path's S steps (450 on x, 375 on y) form one dependent
// chain, and there are only 375 or 450 paths, fewer than the card's 528
// warp schedulers, so no other warp hides a step's latency. At 50 to
// 100 ns a step that floor is 0.02 to 0.045 ms a pass.
//
// Design, against each floor:
// - One compute warp per path, lanes across d. Lane l holds the Lr of its
//   run of N = ceil(D/32) (rounded up to a power of two) disparities in
//   registers. The d-1 / d+1 neighbours are register moves inside the run
//   and one __shfl_up_sync / __shfl_down_sync at its ends; min_d Lr is a
//   lane min and one __reduce_min_sync (redux.sync) on an order-preserving
//   unsigned key of the float (a 5-round __shfl_xor_sync tree measured
//   slower). A step is one straight-line body for every flag, with no
//   branch and no block barrier; the next step's cost, code and flag are
//   read from shared memory before the current step's chain.
// - Tiled, coalesced copies by separate producer warps. A block holds PB
//   compute warps (PB adjacent paths) and kProducerWarps producer warps,
//   and walks the scan in chunks of K steps through a ring of 2 to
//   kMaxStages shared-memory slots. Each slot holds the chunk's (D, outer,
//   inner) cost tile, its cells' left flags, the right flags its codes
//   look up (a window of inner + D - 1 columns a row: x passes, one a
//   path; y passes, one a step) and its K step flags, copied with
//   cp.async, neighbouring threads on neighbouring addresses along the
//   volume's contiguous axis (inner: the steps on x passes, the paths on
//   y passes).
//   The chunks after chunk c load while it runs, and there is one
//   __syncthreads per chunk. Cost rows hold exactly their cells and move
//   in 8-byte grains where every row segment is 8-byte aligned (4-byte
//   grains otherwise), so no store is ever cut by a chunk's edge (such
//   stores take a divergent path per lane and ran far slower).
//   Flag rows are copied as the 16-byte (left flags on y passes: 4-byte)
//   words that cover them, since W need not be a multiple of 16, and read
//   at their byte offset.
// - Staged stores. The compute warps write Lr over the cost tile in place;
//   after the chunk's barrier the producers store the tile along the
//   contiguous axis, then reload the same grains with the chunk `stages`
//   ahead.
// - Codes decoded where they are read. A chunk whose lookups all fall
//   inside the image (most chunks) reads one right flag a cell at a fixed
//   offset from its step and adds the step's left flag; a chunk at an
//   image edge clamps the column and applies the sticky rule per cell.
// - One block an SM where the grid fits the card (see launch()).
// What is left: at 64x375x450 an x pass is held by the step chain and the
// copies about equally, a y pass by the copies, whose 16-byte rows (four
// paths) make scattered requests. At D 640 (chunks of 8 steps in two
// slots) a lane holds 32 cells, 20 of them real: their cost rows, 32
// d-planes apart, share banks, and registers spill.
// Launch geometry (PB, K, ring slots, shared bytes) comes from
// adcensus_torch/ops/scanline.py:scanline_geometry; the slot layout here
// mirrors scanline_layout there, and the entry point refuses a size that
// disagrees.
#include <climits>

#include "common.cuh"

namespace {
constexpr int kFlagPad = 0;
constexpr int kFlagSeed = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;
constexpr int kProducerWarps = 4;
constexpr int kMaxPB = 8;
constexpr int kMaxStages = 6;

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// One ring slot, in bytes (ops/scanline.py:scanline_layout): a (D, outer,
// inner) f32 cost tile whose rows hold exactly their cells, the left
// flags as `outer` grain-aligned row windows of `inner` bytes, the right
// flags as `outer` rows of 16-byte grains covering inner + D - 1 columns,
// and K int32 step flags.
struct Layout {
  int inner, outer;  // tile axes; inner is the volume's contiguous axis
  int cost_dstride;  // between d-planes: an odd number of 8-byte units
  int left_groups, left_base;    // grains (x: 16 B, y: 4 B) a left row
  int right_groups, right_base;  // 16-byte grains a right row
  int flags_base, slot_bytes;
};

__host__ __device__ inline Layout make_layout(int D, int PB, int K,
                                              int step_inner) {
  Layout l;
  l.inner = step_inner ? K : PB;
  l.outer = step_inner ? PB : K;
  l.cost_dstride = (l.outer * l.inner * 4 + 7) / 8 * 8;
  if ((l.cost_dstride / 8) % 2 == 0) l.cost_dstride += 8;
  const int grain = step_inner ? 16 : 4;
  l.left_groups = (2 * grain - 2 + l.inner) / grain;
  l.right_groups = (30 + l.inner + D - 1) / 16;
  l.left_base = round16(D * l.cost_dstride);
  l.right_base = l.left_base + round16(l.outer * l.left_groups * grain);
  l.flags_base = l.right_base + l.outer * l.right_groups * 16;
  l.slot_bytes = l.flags_base + round16(K * 4);
  return l;
}

// Shared-memory accesses by 32-bit shared address, computed once.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float2 lds_f32x2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

__device__ __forceinline__ int lds_u8(uint32_t a) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(a));
  return static_cast<int>(v);
}

__device__ __forceinline__ int lds_s32(uint32_t a) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

// Store v at a when on, without a branch.
__device__ __forceinline__ void sts_f32_if(uint32_t a, float v, bool on) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %2, 0;\n"
      " @p st.shared.f32 [%0], %1;\n}\n" ::"r"(a),
      "f"(v), "r"(static_cast<unsigned>(on))
      : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

// Wait for this thread's copies of the oldest chunk in flight: all but
// the newest stages - 2 groups.
__device__ __forceinline__ void cp_async_wait_chunk(int stages) {
  switch (stages) {
    case 2: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

// Unsigned key whose order is the float order (every non-NaN value):
// flip all bits of a negative float, only the sign bit of a positive one.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) |
              0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float(
      k ^ (~static_cast<unsigned>(static_cast<int>(k) >> 31) | 0x80000000u));
}

__device__ __forceinline__ unsigned low_bits(const void* p) {
  return static_cast<unsigned>(reinterpret_cast<uintptr_t>(p));
}

struct Pass {
  const float* cost;
  const uint8_t* left;   // (H, W) d1 >= tso, the volume's plane layout
  const uint8_t* right;  // (H, right_w) rd >= tso
  const int* flags;
  float* out;
  int D, S, P;
  long long sD, sS, sP;
  int right_w, col0, min_disp, real_w;
  int reverse, PB, K, stages;
};

// The right-flag column that the code of a cell whose image column less
// min_disp less d is xr looks up, when d2 is not d1.
__device__ __forceinline__ int right_col(const Pass& a, int xr) {
  return min(max(xr, 1), a.right_w - 1);
}

// First right-flag column that cells of volume columns [x0, ...) look up:
// every d of the first column.
__device__ __forceinline__ int right_lo(const Pass& a, int x0) {
  return right_col(a, a.col0 + x0 - a.min_disp - (a.D - 1));
}

// Chunk c of the scan: its length and the lowest scan-axis position it
// covers. Tile positions along the step axis count from that position
// up, so the tile is in address order whichever way the pass runs.
__device__ __forceinline__ int chunk_len(const Pass& a, int c) {
  return min(a.K, a.S - c * a.K);
}

__device__ __forceinline__ int chunk_lo(const Pass& a, int c, int kn) {
  return a.reverse ? a.S - c * a.K - kn : c * a.K;
}

// Producer thread `pt` of `np`: store the finished chunk c_store from its
// slot, then copy chunk c_load into the same slot; either may be out of
// range. Row (d, o) of a chunk starts at cell (d, lo, p0 + o) on x passes
// (X) and (d, lo + o, p0) on y passes, holds n cells along the contiguous
// axis, and moves in G-byte grains (8 where every row of every chunk is
// 8-byte aligned, else 4). Each thread owns one grain position of a
// d-plane and walks d; it stores exactly the cost grains it then
// reloads, and its stores consume their shared reads before its copies
// issue, so the slot is reused without a barrier. Ends one cp.async group.
template <bool X, int G>
__device__ void exchange(const Pass& a, const Layout& L, uint32_t sbase,
                         int c_store, int c_load, int p0, int pn, int pt,
                         int np) {
  constexpr int kCells = G / 4;
  const int n_chunks = (a.S + a.K - 1) / a.K;
  const bool do_store = c_store >= 0 && c_store < n_chunks;
  const bool do_load = c_load >= 0 && c_load < n_chunks;
  const uint32_t slot =
      sbase + ((do_store ? c_store : c_load) % a.stages) * L.slot_bytes;
  const int kn_s = do_store ? chunk_len(a, c_store) : 0;
  const int lo_s = do_store ? chunk_lo(a, c_store, kn_s) : 0;
  const int kn_l = do_load ? chunk_len(a, c_load) : 0;
  const int lo_l = do_load ? chunk_lo(a, c_load, kn_l) : 0;
  const int n_s = X ? kn_s : pn;  // cells per row
  const int n_l = X ? kn_l : pn;

  {
    const int per_row = L.inner / kCells;
    const int plane = L.outer * per_row;
    const int sets = max(1, np / plane);
    const long long step = sets * a.sD;
    const uint32_t sm_step = sets * L.cost_dstride;
    for (int e = pt; e < plane * sets; e += np) {
      const int s = e % plane, d0 = e / plane;
      const int o = s / per_row, cell = (s % per_row) * kCells;
      const int q0 = X ? 0 : o, pb0 = X ? o : 0;
      if (pb0 >= pn) continue;
      const uint32_t sm0 = slot + d0 * L.cost_dstride + (o * L.inner + cell) * 4;
      const long long row = (p0 + pb0) * a.sP + d0 * a.sD + cell;
      if (q0 < kn_s && cell < n_s) {
        float* dst = a.out + row + (lo_s + q0) * a.sS;
        uint32_t sm = sm0;
        int d = d0;
        for (; d + 3 * sets < a.D; d += 4 * sets) {  // four reads in flight
          if constexpr (G == 8) {
            float2 v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] = lds_f32x2(sm + i * sm_step);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              *reinterpret_cast<float2*>(dst + i * step) = v[i];
          } else {
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] = lds_f32(sm + i * sm_step);
#pragma unroll
            for (int i = 0; i < 4; ++i) dst[i * step] = v[i];
          }
          sm += 4 * sm_step;
          dst += 4 * step;
        }
        for (; d < a.D; d += sets) {
          if constexpr (G == 8)
            *reinterpret_cast<float2*>(dst) = lds_f32x2(sm);
          else
            *dst = lds_f32(sm);
          sm += sm_step;
          dst += step;
        }
      }
      if (q0 < kn_l && cell < n_l) {
        const float* src = a.cost + row + (lo_l + q0) * a.sS;
        uint32_t sm = sm0;
        for (int d = d0; d < a.D; d += sets) {
          cp_async<G>(sm, src);
          sm += sm_step;
          src += step;
        }
      }
    }
  }
  if (do_load) {
    {  // left flags: row o holds n_l cells of the chunk's one plane
      constexpr int kGrain = X ? 16 : 4;
      const int plane = L.outer * L.left_groups;
      for (int s = pt; s < plane; s += np) {
        const int o = s / L.left_groups, grp = s % L.left_groups;
        const int q0 = X ? 0 : o, pb0 = X ? o : 0;
        if (pb0 >= pn || q0 >= kn_l) continue;
        const uint8_t* src = a.left + (lo_l + q0) * a.sS + (p0 + pb0) * a.sP;
        const int off = static_cast<int>(low_bits(src) & (kGrain - 1));
        if (grp * kGrain < off + n_l)
          cp_async<kGrain>(slot + L.left_base + s * kGrain,
                           src - off + kGrain * grp);
      }
    }
    {  // right flags: row o (x: path p0 + o, y: step lo_l + o) holds the
       // columns [ra, ra + rn) that the chunk's cells look up
      const int x0 = X ? lo_l : p0, xn = X ? kn_l : pn;
      const int ra = right_lo(a, x0);
      const int rn =
          right_col(a, a.col0 + x0 + xn - 1 - a.min_disp) - ra + 1;
      const int rows = X ? pn : kn_l;
      const int plane = L.outer * L.right_groups;
      for (int s = pt; s < plane; s += np) {
        const int o = s / L.right_groups, grp = s % L.right_groups;
        if (o >= rows) continue;
        const long long row = X ? p0 + o : lo_l + o;
        const uint8_t* src = a.right + row * a.right_w + ra;
        const int off = static_cast<int>(low_bits(src) & 15);
        if (grp * 16 < off + rn)
          cp_async<16>(slot + L.right_base + s * 16, src - off + 16 * grp);
      }
    }
    const int* fsrc = a.flags + c_load * a.K;  // flags are in scan order
    for (int e = pt; e < kn_l; e += np)
      cp_async<4>(slot + L.flags_base + 4 * e, fsrc + e);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool X>
__device__ __forceinline__ void exchange_any(const Pass& a, const Layout& L,
                                             bool g8, uint32_t sbase,
                                             int c_store, int c_load, int p0,
                                             int pn, int pt, int np) {
  if (g8)
    exchange<X, 8>(a, L, sbase, c_store, c_load, p0, pn, pt, np);
  else
    exchange<X, 4>(a, L, sbase, c_store, c_load, p0, pn, pt, np);
}

template <bool B>
struct BoolTag {
  static constexpr bool value = B;
};

// What a compute lane reads for one scan step.
template <int N>
struct Step {
  int flag;
  int f1;          // left flag of the step's pixel
  int d1_below;    // chunks at an edge: d2 is d1 at every d <= d1_below
  uint32_t at[N];  // shared address of the cost cell
  float c[N];
  int g[N];  // the cell's right flag
};

template <int N, bool X>
__global__ void __launch_bounds__((kMaxPB + kProducerWarps) * 32)
    scanline_kernel(Pass a, bool g8, float p1_0, float p1_1, float p1_2,
                    float p2_0, float p2_1, float p2_2) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = make_layout(a.D, a.PB, a.K, X);
  const uint32_t sbase = smem_addr(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * a.PB;
  const int pn = min(a.PB, a.P - p0);
  const int n_chunks = (a.S + a.K - 1) / a.K;
  const int D = a.D;
  const bool producer = warp >= a.PB;
  const int pt = threadIdx.x - a.PB * 32, np = kProducerWarps * 32;

  if (producer)
    for (int c = 0; c < a.stages - 1; ++c)
      exchange_any<X>(a, L, g8, sbase, -1, c, p0, pn, pt, np);

  // Per cell of the lane's run (d past D reads row D - 1 and stores
  // nothing): its d and its cost row's offset in a slot.
  float lr[N];
  bool on[N];
  int dd[N];
  uint32_t cost_row[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    lr[j] = ADC_LARGE_FLOAT;
    on[j] = lane * N + j < D;
    dd[j] = min(lane * N + j, D - 1);
    cost_row[j] = dd[j] * L.cost_dstride + (X ? warp * L.inner * 4 : warp * 4);
  }
  const bool first_lane = lane == 0;
  bool last_cell[N];  // d + 1 == D: its right neighbour is Large_Float
#pragma unroll
  for (int j = 0; j < N; ++j) last_cell[j] = lane * N + j + 1 >= D;
  float min_prev = ADC_LARGE_FLOAT;
  const unsigned sS = static_cast<unsigned>(a.sS);
  const unsigned rw = static_cast<unsigned>(a.right_w);
  // the low bits of the global address of the warp's left-flag row (x) or
  // of the block's first column on row 0 (y)
  const unsigned left_lo = low_bits(a.left + (p0 + (X ? warp : 0)) * a.sP);

  for (int c = 0; c < n_chunks; ++c) {
    if (producer) cp_async_wait_chunk(a.stages);
    __syncthreads();  // chunk c landed; chunk c-1 computed by every warp
    if (producer) {
      exchange_any<X>(a, L, g8, sbase, c - 1, c + a.stages - 1, p0, pn, pt,
                      np);
      continue;
    }
    if (warp >= pn) continue;

    const uint32_t slot = sbase + (c % a.stages) * L.slot_bytes;
    const uint32_t flags_at = slot + L.flags_base;
    const int kn = chunk_len(a, c);
    const int lo = chunk_lo(a, c, kn);
    uint32_t rc[N];
#pragma unroll
    for (int j = 0; j < N; ++j) rc[j] = slot + cost_row[j];
    // Left flag of step q: x: lf + q; y: lf + q * row bytes + ((lk + q *
    // sS) & 3), the 4-byte window's offset. Right flag of column c on step
    // q: x: rf + c; y: rf + q * row bytes + ((rk + q * rw) & 15) + c.
    const unsigned lk = left_lo + lo * sS;
    const uint32_t lf = slot + L.left_base +
                        (X ? warp * L.left_groups * 16 + (lk & 15) : warp);
    const int ra = right_lo(a, X ? lo : p0);
    const unsigned rk =
        low_bits(a.right + (X ? static_cast<long long>(p0 + warp) * a.right_w
                              : static_cast<long long>(lo) * a.right_w) +
                 ra);
    const uint32_t rf = slot + L.right_base +
                        (X ? warp * L.right_groups * 16 + (rk & 15) : 0) - ra;
    // image column less min_disp of step 0's cell (x) or of the warp's path
    const int xc = a.col0 + (X ? lo : p0 + warp) - a.min_disp;
    const int q0 = a.reverse ? kn - 1 : 0, dq = a.reverse ? -1 : 1;
    // The chunk's steps and d look up right columns xr = xs - d in
    // [xc - (D - 1), x_hi]. Where that lies inside [1, real_w - 2] and
    // inside the right map, no lookup clamps and d2 is never d1, so the
    // code is f1 + g; else (near the image's edges) the chunk runs the
    // sticky rule of ops/scanline.py:penalty_codes in full.
    const int x_hi = X ? xc + kn - 1 : xc;
    const bool edge = xc - (D - 1) < 1 || x_hi >= a.real_w - 1 ||
                      x_hi > a.right_w - 1;
    auto run = [&](auto edge_tag) {
      constexpr bool kEdge = decltype(edge_tag)::value;
      auto fetch = [&](Step<N>& st, int k) {
        const int q = q0 + k * dq;
        st.flag = lds_s32(flags_at + 4 * k);
        st.f1 = lds_u8(X ? lf + q
                         : lf + q * (L.left_groups * 4) + ((lk + q * sS) & 3));
        const int xs = X ? xc + q : xc;
        // d2 is d1 where xr = xs - d >= real_w - 1, and at every d where
        // xs <= 0
        if constexpr (kEdge)
          st.d1_below = xs <= 0 ? INT_MAX : xs - (a.real_w - 1);
        const uint32_t rrow =
            X ? rf : rf + q * (L.right_groups * 16) + ((rk + q * rw) & 15);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          st.at[j] = X ? rc[j] + 4 * q : rc[j] + q * (L.inner * 4);
          st.c[j] = lds_f32(st.at[j]);
          const int xr = xs - dd[j];
          st.g[j] = lds_u8(rrow + (kEdge ? right_col(a, xr) : xr));
        }
      };

      Step<N> nx;
      fetch(nx, 0);
#pragma unroll 2
      for (int k = 0; k < kn; ++k) {
        const Step<N> cur = nx;
        const float up = __shfl_up_sync(kFull, lr[N - 1], 1);
        const float down = __shfl_down_sync(kFull, lr[0], 1);
        fetch(nx, min(k + 1, kn - 1));
        // one straight-line body for every flag: PAD writes its cost back
        // and keeps the carry, SEED takes the cost, NORMAL the recurrence
        const bool pad = cur.flag == kFlagPad;
        const bool raw = pad || cur.flag == kFlagSeed;
        float v[N];
        unsigned key = 0xffffffffu;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          int cd = cur.f1 + cur.g[j];
          if constexpr (kEdge) cd = dd[j] <= cur.d1_below ? 2 * cur.f1 : cd;
          const float P1 = cd == 0 ? p1_0 : (cd == 1 ? p1_1 : p1_2);
          const float P2 = cd == 0 ? p2_0 : (cd == 1 ? p2_1 : p2_2);
          const float left =
              j > 0 ? lr[j - 1] : (first_lane ? ADC_LARGE_FLOAT : up);
          const float right =
              last_cell[j] ? ADC_LARGE_FLOAT : (j < N - 1 ? lr[j + 1] : down);
          const float m = fminf(fminf(lr[j], left + P1),
                                fminf(right + P1, min_prev + P2));
          v[j] = raw ? cur.c[j] : (cur.c[j] + m) * 0.5f;
          sts_f32_if(cur.at[j], v[j], on[j]);
          key = min(key, on[j] ? order_key(v[j]) : 0xffffffffu);
        }
#pragma unroll
        for (int j = 0; j < N; ++j) lr[j] = pad ? lr[j] : v[j];
        const float m = from_key(__reduce_min_sync(kFull, key));
        min_prev = pad ? min_prev : m;
      }
    };
    if (edge)
      run(BoolTag<true>{});
    else
      run(BoolTag<false>{});
  }
  __syncthreads();  // the last chunk computed
  if (producer)
    exchange_any<X>(a, L, g8, sbase, n_chunks - 1, -1, p0, pn, pt, np);
}

template <int N, bool X>
int launch(const Pass& a, bool g8, const float* p, size_t smem,
           cudaStream_t st) {
  static bool attr_set = false;  // once per instance: the H100's limit
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        scanline_kernel<N, X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const unsigned blocks = adc_blocks(a.P, a.PB);
  const int threads = (a.PB + kProducerWarps) * 32;
  // A grid that fits the card's SMs takes one an SM: its blocks reserve
  // more than half an SM's shared memory, since two blocks of a small ring
  // on one SM share its schedulers (10 to 25 % slower a launch at the
  // Cone size on the H100, where the grid is 94 and 113 blocks).
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t reserve =
      blocks <= static_cast<unsigned>(sms) ? kSmemLimit / 2 + 16 : 0;
  scanline_kernel<N, X><<<blocks, threads, smem > reserve ? smem : reserve,
                          st>>>(a, g8, p[0], p[1], p[2], p[3], p[4], p[5]);
  return static_cast<int>(cudaGetLastError());
}

template <bool X>
int launch_run(const Pass& a, bool g8, const float* p, size_t smem,
               cudaStream_t st) {
  const int n = (a.D + 31) / 32;
  if (n <= 1) return launch<1, X>(a, g8, p, smem, st);
  if (n <= 2) return launch<2, X>(a, g8, p, smem, st);
  if (n <= 4) return launch<4, X>(a, g8, p, smem, st);
  if (n <= 8) return launch<8, X>(a, g8, p, smem, st);
  if (n <= 16) return launch<16, X>(a, g8, p, smem, st);
  return launch<32, X>(a, g8, p, smem, st);
}

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }
bool even(long long v) { return v % 2 == 0; }
}  // namespace

ADC_EXPORT int adc_scanline(const float* cost, const uint8_t* left,
                            const uint8_t* right, const int* flags, float* out,
                            int D, int S, int P, long long sD, long long sS,
                            long long sP, int right_w, int col0, int min_disp,
                            int real_w, float p1_0, float p1_1, float p1_2,
                            float p2_0, float p2_1, float p2_2, int reverse,
                            int step_inner, int PB, int K, int stages,
                            int smem_bytes, void* stream) {
  if (P == 0 || S == 0 || D == 0) return 0;
  const Layout L = make_layout(D, PB, K, step_inner);
  if (D > 1024 || right_w < 1 || !is_pow2(PB) || PB > kMaxPB || !is_pow2(K) ||
      stages < 2 || stages > kMaxStages ||
      static_cast<long long>(stages) * L.slot_bytes != smem_bytes ||
      smem_bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  // 8-byte grains when every row segment of every chunk starts and ends
  // on an 8-byte boundary of both volumes: even pointers (in cells), even
  // strides between rows, and even chunk ends along the contiguous axis
  const bool g8 =
      ((reinterpret_cast<uintptr_t>(cost) | reinterpret_cast<uintptr_t>(out)) &
       7) == 0 &&
      even(sD) &&
      (step_inner ? even(sP) && even(S) && even(K)
                  : even(sS) && even(P) && even(PB));
  const Pass a{cost, left, right, flags, out, D, S, P, sD, sS, sP,
               right_w, col0, min_disp, real_w, reverse, PB, K, stages};
  const float p[6] = {p1_0, p1_1, p1_2, p2_0, p2_1, p2_2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
  return step_inner ? launch_run<true>(a, g8, p, smem, st)
                    : launch_run<false>(a, g8, p, smem, st);
}
