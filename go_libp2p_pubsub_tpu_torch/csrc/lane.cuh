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

// ops.graph.select_k_bits with lane_uniform priorities: each set bit i
// (< c) of ``bits`` draws lane_u(seed, i, p, stride), unset bits -1; bit
// i is kept iff its rank (the count of candidates with a higher
// priority, ties to the lower index) is below k.
template <int CMAX>
__device__ __forceinline__ uint32_t select_k(uint32_t bits, int c, int k,
                                             uint32_t seed, long long p,
                                             uint32_t stride) {
  float prio[CMAX];
#pragma unroll
  for (int i = 0; i < CMAX; ++i) {
    prio[i] = (i < c && ((bits >> i) & 1u)) ? lane_u(seed, i, p, stride)
                                            : -1.0f;
  }
  uint32_t sel = 0u;
#pragma unroll
  for (int i = 0; i < CMAX; ++i) {
    if (i >= c || !((bits >> i) & 1u)) continue;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < CMAX; ++j) {
      if (j >= c) continue;
      rank += (prio[j] > prio[i]) || (prio[j] == prio[i] && j < i);
    }
    if (rank < k) sel |= 1u << i;
  }
  return sel;
}

}  // namespace gossip
