// Kernel B5: the blocked-band window sum of the "banded" aggregation.
//
// Replaces adcensus_tpu/ops/band_mm_pallas.py:_band_kernel (launched by
// _band_pass). For every (d, n, o), with ob = o / 256:
//
//   out[d, n, o] = sum_ii [mask[n, ii, o] != 0] * vol[d, n, ob*256 + ii],
//
// ii < WK = 256 + 2*PAD, the float32 volume split into bfloat16
// hi = bf16(v) and lo = bf16(v - hi). The Pallas kernel multiplies both
// parts by the 0/1 mask on the TPU's matrix unit with float32 sums.
//
// Order, for bitwise equality with band_pass_plain (ops/band_mm.py):
// hi_sum starts at +0.0f and adds hi for each selected ii, ascending;
// lo_sum the same; the result is hi_sum + lo_sum. An unselected slot
// adds +0.0 in the plain version; the sums never become -0.0, so
// skipping that add, or adding +0.0 more often, changes nothing. Built
// with -fmad=false, no fast math.
//
// Bound on the H100: device memory. One pass must read the int8 mask and
// the margined volume and write the output: 188.7 MB (horizontal) and
// 209.7 MB (vertical) at 64x375x450 and arm cap 34, 0.0563 and 0.0626 ms
// at 3.35 TB/s. The work is two float32 adds per selected slot and
// output: a column selects at most 2 * 34 + 1 of its WK = 384 slots, so
// a pass needs at most 1.74 G adds, 0.026 ms at 67 TFLOP/s, under the
// byte bound. The tensor cores are not used: they would do the dense
// 0/1 product, about 12x the adds the function needs, to no gain under
// that bound, and they add a product's terms in an order and with a
// rounding of their own, so their sum could not be bitwise.
//
// The earlier kernel walked all WK slots of each column with one strided
// 1-byte mask load and a branch a slot, and read each mask tile once per
// 8-plane group. Here:
// - One block of NB = 256 threads owns one row n and one 256-column
//   output block ob, and loops over the d-planes itself, so each mask
//   tile is read from device memory once; thread t owns column
//   o = ob*256 + t (768 and 1024 blocks a pass at Cone size, 4 an SM).
// - The mask tile comes in 32 rows at a time by 16-byte cp.async into a
//   three-slot ring, two chunks ahead; each thread packs its column's 32
//   bytes of a chunk into one bit word from shared memory (32 strided
//   byte loads a word from device memory were slower than the rest of
//   the kernel together, in a scratch variant).
// - Per group of DG = 8 d-planes (DG hi and lo sums in registers), the
//   group's WK-wide window arrives by 16-byte cp.async into a two-slot
//   ring, the next group's while this one is summed, and is split into
//   one word a (slot, plane): hi's bf16 bits high, lo's low. Both halves
//   are exact bfloat16 values, so unpacking them back to float32 is
//   exact, and a selected slot costs two 16-byte shared loads.
// - A thread walks only its column's set bits, word by word from low to
//   high, each word by __ffs and word &= word - 1: ascending ii, the
//   plain order. A warp takes a word's bits in step: the trip count of
//   word w is the largest popcount of w among its 32 columns (a lane
//   without a bit left reads a zero row, adding +0.0), and a warp skips a
//   word no column of it selects. So a warp's trip count is the sum over
//   words of that largest popcount, near its columns' largest selected
//   count (31 slots a column at most on the Cone pair), not WK. A
//   per-lane walk, each lane on to its next word alone, was slower at
//   long arms and no faster at Cone size (scratch variants).
// MAX_WK = 768 (PAD 256, max_arm 255) bounds the window; the wrapper
// raises for a larger one.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int NB = 256;       // output-block width (band_mm.py _NB); threads
constexpr int DG = 8;         // d-planes summed at once
constexpr int kMaxWK = 768;   // band_mm.py MAX_WK
// Words a window slot takes in the split buffer: DG used, padded to 12 so
// that 8 consecutive slots start in 8 different 16-byte bank groups
// (12 * ii mod 32 cycles through 0, 12, 24, 4, 16, 28, 8, 20): the
// threads of a warp read neighbouring slots, and their 16-byte loads do
// not collide.
constexpr int kRow = 12;
constexpr int kChunk = 32 * NB;  // bytes of one staged 32-row mask chunk
constexpr int kMaskSlots = 3;

// Shared memory of one block, in bytes: the volume ring (2 x DG x WK
// floats), then the split buffer (WK + 1 rows of kRow words, the last a
// zero row), then the mask bits (WK/32 x NB words). The mask chunks are
// staged behind the ring's first slot, over its second and the split
// buffer, which are free until the bits are packed.
__host__ __device__ constexpr size_t ring_bytes(int wk) {
  return 2u * DG * 4u * wk;
}
__host__ __device__ constexpr size_t bits_offset(int wk) {
  const size_t planes = ring_bytes(wk) + 4u * kRow * (wk + 1);
  const size_t staged = ring_bytes(wk) / 2 + size_t{kMaskSlots} * kChunk;
  return planes > staged ? planes : staged;
}
constexpr size_t smem_bytes(int wk) {
  return bits_offset(wk) + 4u * (wk / 32) * NB;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // copies `bytes` (0 to 16) and zero-fills the rest of the 16
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Copy planes d0 .. d0+DG-1 of the block's window into a ring slot
// ([DG][WK] floats); planes past Dp are zeros.
__device__ __forceinline__ void load_group(float* dst, const float* win,
                                           long long plane, int d0, int Dp,
                                           int WK) {
  const int quads = WK / 4;
  for (int c = threadIdx.x; c < DG * quads; c += NB) {
    const int k = c / quads;
    const int q = c - k * quads;
    const bool fill = d0 + k < Dp;
    cp_async16(dst + k * WK + 4 * q, fill ? win + (d0 + k) * plane + 4 * q
                                          : win, fill ? 16 : 0);
  }
  commit();
}

// Copy mask rows 32c .. 32c+31 of the block's 256 columns into a chunk
// slot ([32][256] bytes); columns at or past Mp are zeros.
__device__ __forceinline__ void load_mask_chunk(uint8_t* dst,
                                                const int8_t* seg, int Mp,
                                                int valid, int c) {
  for (int q = threadIdx.x; q < kChunk / 16; q += NB) {
    const int r = q >> 4;
    const int j = q & 15;
    const int bytes = min(max(valid - 16 * j, 0), 16);
    cp_async16(dst + 16 * q,
               bytes ? seg + static_cast<long long>(32 * c + r) * Mp + 16 * j
                     : seg, bytes);
  }
  commit();
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(
      __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__global__ void __launch_bounds__(NB)
    band_kernel(const int8_t* __restrict__ mask,
                const float* __restrict__ vol, float* __restrict__ out,
                int Dp, int Np, int Mp, int L, int WK) {
  extern __shared__ float4 smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem);
  float* s_ring = reinterpret_cast<float*>(base);           // [2][DG][WK]
  uint32_t* s_pair = reinterpret_cast<uint32_t*>(base + ring_bytes(WK));
  uint8_t* s_chunks = base + ring_bytes(WK) / 2;  // [kMaskSlots][32][NB]
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(base + bits_offset(WK));
  const int n_ob = (Mp + NB - 1) / NB;
  const int ob = blockIdx.x % n_ob;
  const int n = blockIdx.x / n_ob;
  const int t = threadIdx.x;
  const int o = ob * NB + t;
  const bool active = o < Mp;
  const int nw = WK / 32;
  const long long plane = static_cast<long long>(Np) * L;
  const float* win = vol + static_cast<long long>(n) * L +
                     static_cast<long long>(ob) * NB;
  const int n_groups = (Dp + DG - 1) / DG;

  // The first plane group's window, then the mask chunks; bit r of word
  // w is slot 32w + r of column o. Only thread t reads its words back.
  load_group(s_ring, win, plane, 0, Dp, WK);
  const int8_t* seg = mask + static_cast<long long>(n) * WK * Mp + ob * NB;
  const int valid = Mp - ob * NB;
  for (int c = 0; c < kMaskSlots - 1 && c < nw; ++c) {
    load_mask_chunk(s_chunks + c * kChunk, seg, Mp, valid, c);
  }
  for (int w = 0; w < nw; ++w) {
    if (w + 1 < nw) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // chunk w landed; every thread is done with w - 1
    if (w + kMaskSlots - 1 < nw) {
      load_mask_chunk(s_chunks + ((w + kMaskSlots - 1) % kMaskSlots) * kChunk,
                      seg, Mp, valid, w + kMaskSlots - 1);
    }
    const uint8_t* col = s_chunks + (w % kMaskSlots) * kChunk + t;
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      word |= static_cast<uint32_t>(col[r * NB] != 0) << r;
    }
    s_bits[w * NB + t] = word;
  }
  __syncthreads();  // the chunks' space goes back to the ring and split
  if (t < kRow) s_pair[kRow * WK + t] = 0u;  // the zero row

  for (int g = 0; g < n_groups; ++g) {
    const int d0 = g * DG;
    if (g + 1 < n_groups) {
      load_group(s_ring + ((g + 1) & 1) * DG * WK, win, plane, d0 + DG, Dp,
                 WK);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // group g landed; every thread is done with g - 1
    const float* raw = s_ring + (g & 1) * DG * WK;
    for (int ii = t; ii < WK; ii += NB) {
      uint32_t pw[DG];
#pragma unroll
      for (int k = 0; k < DG; ++k) {
        const float v = raw[k * WK + ii];
        const uint32_t hb = bf16_bits(v);
        const float hi = __uint_as_float(hb << 16);
        pw[k] = (hb << 16) | bf16_bits(v - hi);
      }
      uint4* row = reinterpret_cast<uint4*>(s_pair + kRow * ii);
      row[0] = make_uint4(pw[0], pw[1], pw[2], pw[3]);
      row[1] = make_uint4(pw[4], pw[5], pw[6], pw[7]);
    }
    __syncthreads();

    // every lane takes part, for the warp votes; columns at or past Mp
    // have no bits
    float ah[DG], al[DG];
#pragma unroll
    for (int k = 0; k < DG; ++k) {
      ah[k] = 0.0f;
      al[k] = 0.0f;
    }
    for (int w = 0; w < nw; ++w) {
      uint32_t bits = s_bits[w * NB + t];
      while (__any_sync(0xffffffffu, bits != 0)) {
        const int ii = bits ? (w << 5) | (__ffs(bits) - 1) : WK;
        bits &= bits - 1;
        const uint4* row = reinterpret_cast<const uint4*>(s_pair + kRow * ii);
        const uint4 p0 = row[0], p1 = row[1];
        const uint32_t pw[DG] = {p0.x, p0.y, p0.z, p0.w,
                                 p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int k = 0; k < DG; ++k) {
          ah[k] += __uint_as_float(pw[k] & 0xffff0000u);
          al[k] += __uint_as_float(pw[k] << 16);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < DG; ++k) {
      const int d = d0 + k;
      if (active && d < Dp) {
        out[(static_cast<long long>(d) * Np + n) * Mp + o] = ah[k] + al[k];
      }
    }
  }
}

}  // namespace

// mask (Np, WK, Mp) int8 and vol (Dp, Np, L) float32, both 16-byte
// aligned, with Mp a multiple of 16 and L = ceil(Mp/256)*256 + WK - 256
// (margins attached); out (Dp, Np, Mp) float32. WK is a multiple of 32 up
// to kMaxWK.
ADC_EXPORT int adc_band_mm(const int8_t* mask, const float* vol, float* out,
                           int Dp, int Np, int Mp, int L, int WK,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dp == 0 || Np == 0 || Mp == 0) return 0;
  if (WK <= 0 || WK % 32 != 0 || WK > kMaxWK || Mp % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mask) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vol) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>((Mp + NB - 1) / NB) * Np;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(WK);
  cudaError_t e = cudaFuncSetAttribute(
      band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // all of L1 as shared memory, so that 4 blocks fit an SM at WK = 384
  e = cudaFuncSetAttribute(band_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  band_kernel<<<static_cast<unsigned>(blocks), NB, smem, s>>>(
      mask, vol, out, Dp, Np, Mp, L, WK);
  return static_cast<int>(cudaGetLastError());
}
