// Packed top-k selection, one thread per peer (Hopper, sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/select.py, _select_kernel
// (built by select_k_bits_pallas).  Bit-identical to
// ops/graph.select_k_bits with lane_uniform priorities: for each set bit
// c of the eligibility word the priority is
// (fmix32((c * stride + p) ^ seed) >> 8) * 2^-24, unset bits get -1, a
// candidate's rank is the count of candidates with a higher priority
// (ties: the lower candidate index wins), and bit c is kept iff it is
// eligible and its rank < k[p] (lane.cuh select_k, shared with the fused
// window kernel).
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

#include "lane.cuh"

namespace {

template <int CMAX>
__global__ void select_k_bits_kernel(const uint32_t* __restrict__ elig,
                                     const int32_t* __restrict__ k,
                                     uint32_t* __restrict__ out, long long n,
                                     int c, uint32_t seed, uint32_t stride) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  out[p] = gossip::select_k<CMAX>(elig[p], c, k[p], seed, p, stride);
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
