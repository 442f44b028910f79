// Packed top-k selection, one thread per peer (Hopper, sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/select.py, _select_kernel
// (built by select_k_bits_pallas).  Bit-identical to
// ops/graph.select_k_bits with lane_uniform priorities: for each set bit
// c of the eligibility word the priority is
// (fmix32((c * stride + p) ^ seed) >> 8) * 2^-24, unset bits get -1, a
// candidate's rank is the count of candidates with a higher priority
// (ties: the lower candidate index wins), and bit c is kept iff it is
// eligible and its rank < k[p].
//
// Bound on this card: bytes.  It moves 12 bytes per peer (elig and k
// in, the packed word out), 12 MB per call at 1M peers, about 3.6 us at
// 3.35 TB/s; the operations its data needs (C compares per eligible
// candidate plus its lane hash) take less.  Design: the C priorities
// stay in registers (C is a template parameter), each thread reads its
// two words and writes one, neighbouring threads touch neighbouring
// addresses.  This first version is bound by instruction issue instead:
// some lane of every warp has each candidate eligible, so every warp
// runs all C * C compares of the unrolled loop (PERF.md has its time).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

template <int CMAX>
__global__ void select_k_bits_kernel(const uint32_t* __restrict__ elig,
                                     const int32_t* __restrict__ k,
                                     uint32_t* __restrict__ out, long long n,
                                     int c, uint32_t seed, uint32_t stride) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const uint32_t bits = elig[p];
  const int kk = k[p];
  float prio[CMAX];
#pragma unroll
  for (int i = 0; i < CMAX; ++i) {
    if (i < c && ((bits >> i) & 1u)) {
      uint32_t lane = (uint32_t)i * stride + (uint32_t)p;  // u32 wrap
      uint32_t h = fmix32(lane ^ seed);
      prio[i] = __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
    } else {
      prio[i] = -1.0f;
    }
  }
  uint32_t sel = 0;
#pragma unroll
  for (int i = 0; i < CMAX; ++i) {
    if (i >= c || !((bits >> i) & 1u)) continue;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < CMAX; ++j) {
      if (j >= c) continue;
      rank += (prio[j] > prio[i]) || (prio[j] == prio[i] && j < i);
    }
    if (rank < kk) sel |= 1u << i;
  }
  out[p] = sel;
}

}  // namespace

extern "C" int gossip_select_k_bits(const void* elig, const void* k,
                                    void* out, long long n, int c,
                                    unsigned int seed, unsigned int stride,
                                    void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (c <= 8) {
      select_k_bits_kernel<8><<<blocks, threads, 0, s>>>(
          (const uint32_t*)elig, (const int32_t*)k, (uint32_t*)out, n, c,
          seed, stride);
    } else if (c <= 16) {
      select_k_bits_kernel<16><<<blocks, threads, 0, s>>>(
          (const uint32_t*)elig, (const int32_t*)k, (uint32_t*)out, n, c,
          seed, stride);
    } else {
      select_k_bits_kernel<32><<<blocks, threads, 0, s>>>(
          (const uint32_t*)elig, (const int32_t*)k, (uint32_t*)out, n, c,
          seed, stride);
    }
  }
  return (int)cudaGetLastError();
}
