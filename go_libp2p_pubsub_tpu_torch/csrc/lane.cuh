// Device helpers shared by the port's kernels (select.cu, receive.cu,
// fused.cu): the simulator's counter-based lane hash and the exact-k
// random selection, bit-identical to ops/graph.py.
#pragma once
#include <cstdint>

namespace gossip {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// lane_uniform's draw for lane c * stride + p (u32 wrap) of the stream
// seeded by the mixed lane seed ``seed``
__device__ __forceinline__ float lane_u(uint32_t seed, int c, long long p,
                                        uint32_t stride) {
  const uint32_t lane = (uint32_t)c * stride + (uint32_t)p;
  const uint32_t h = fmix32(lane ^ seed);
  return __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
}

// Sort N keys into descending order in registers: a bitonic network,
// N log2(N) (log2(N) + 1) / 4 compare-exchanges (80 at N = 16), every
// index a compile-time constant once unrolled.
// The stage and step loops count exponents (constant trip counts), so
// every loop unrolls and v stays in registers.
template <int N>
__device__ __forceinline__ void sort_desc(uint32_t (&v)[N]) {
  constexpr int LOG = N == 8 ? 3 : N == 16 ? 4 : 5;
  static_assert(N == 1 << LOG, "a power of two from 8 to 32");
#pragma unroll
  for (int ks = 1; ks <= LOG; ++ks) {
#pragma unroll
    for (int js = ks - 1; js >= 0; --js) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ (1 << js);
        if (l > i) {
          const uint32_t hi = max(v[i], v[l]), lo = min(v[i], v[l]);
          const bool desc = (i & (1 << ks)) == 0;
          v[i] = desc ? hi : lo;
          v[l] = desc ? lo : hi;
        }
      }
    }
  }
}

// ops.graph.select_k_bits with lane_uniform priorities: each set bit i
// (< c) of ``bits`` draws lane_u(seed, i, p, stride), unset bits -1; bit
// i is kept iff its rank (the count of candidates with a higher
// priority, ties to the lower index) is below k.
//
// The same function by integer keys: a priority is (h >> 8) * 2^-24 of
// the lane hash h, exact in f32, so the priority order is the order of
// the 24-bit integers h >> 8, and the unique key
// 2^29 | (h >> 8) << 5 | (31 - i) of an eligible bit orders ties to the
// lower index (0 for an ineligible one, below every key).  Rank below k
// is then "among the k largest keys": sorted, the first k keys' low five
// bits name the bits kept.  No draw where the answer needs none: 0 for
// k <= 0 or no eligible bit, every eligible bit for k >= their count.
template <int CMAX>
__device__ __forceinline__ uint32_t select_k(uint32_t bits, int c, int k,
                                             uint32_t seed, long long p,
                                             uint32_t stride) {
  const uint32_t elig = c >= 32 ? bits : bits & ((1u << c) - 1u);
  if (k <= 0 || elig == 0u) return 0u;
  if (k >= __popc(elig)) return elig;
  uint32_t v[CMAX];
#pragma unroll
  for (int i = 0; i < CMAX; ++i) {
    const uint32_t h = fmix32(((uint32_t)i * stride + (uint32_t)p) ^ seed);
    v[i] = ((elig >> i) & 1u)
               ? (1u << 29) | ((h >> 8) << 5) | (uint32_t)(31 - i)
               : 0u;
  }
  sort_desc<CMAX>(v);
  // the k largest keys (0 < k < the eligible count: every one eligible)
  uint32_t sel = 0u;
#pragma unroll
  for (int i = 0; i < CMAX; ++i) {
    if (i < k) sel |= 1u << (31u - (v[i] & 31u));
  }
  return sel;
}

}  // namespace gossip
