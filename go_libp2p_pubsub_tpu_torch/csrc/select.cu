// Packed top-k selection, four peers a thread (Hopper, sm_90a).
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
// 3.35 TB/s; the operations its data needs (one lane hash per candidate
// and a sorting network over the C keys, where a draw is needed) take
// less.  Design: each thread takes four neighbouring peers, with one
// 16-byte load of elig, one of k and one 16-byte store (a scalar path
// for the ragged last quad), so a warp moves 512 contiguous bytes a row.
// Every pointer must be 16-byte aligned: the entry point refuses others,
// and the wrapper (ops/kernels/select.py) copies an operand that starts
// off a 16-byte boundary, as the receive wrapper does for its staged
// operands.  The answers that need no draw
// come first (0 where k <= 0 or no bit is eligible, every eligible bit
// where k covers them); then the thread draws only for its peers that
// need it, one at a time, so a warp runs as many draws as its busiest
// thread needs rather than four.  A draw (lane.cuh select_k) sorts
// integer keys (the priority's 24 bits, then the lane index for ties) by
// a bitonic network, 80 compare-exchanges at C = 16, where the first
// version ran all C * C float compares of every lane in every warp.
#include <cstdint>
#include <cuda_runtime.h>

#include "lane.cuh"

namespace {

constexpr int SELECT_THREADS = 128;
constexpr int PEERS_PER_THREAD = 4;

// A replica stack (BATCHED): elig, k and out are [B, N] rows of n_rep
// peers each, replica b drawing from seeds[b] on the lanes of its own peer
// index; a quad that straddles two replicas (n_rep not a multiple of 4)
// takes each peer's replica and local index apart.
template <bool BATCHED>
__device__ __forceinline__ void replica_of(long long g, long long n_rep,
                                           const uint32_t* seeds,
                                           uint32_t seed, uint32_t& s,
                                           long long& p) {
  if constexpr (BATCHED) {
    const long long b = g / n_rep;
    s = __ldg(&seeds[b]);
    p = g - b * n_rep;
  } else {
    s = seed;
    p = g;
  }
}

template <int CMAX, bool BATCHED>
__global__ void __launch_bounds__(SELECT_THREADS)
select_k_bits_kernel(const uint32_t* __restrict__ elig,
                     const int32_t* __restrict__ k,
                     uint32_t* __restrict__ out, long long n, int c,
                     uint32_t seed, uint32_t stride,
                     const uint32_t* __restrict__ seeds, long long n_rep) {
  const long long p0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * PEERS_PER_THREAD;
  if (p0 >= n) return;
  if (p0 + PEERS_PER_THREAD <= n) {
    const uint4 e = *reinterpret_cast<const uint4*>(elig + p0);
    const int4 kk = *reinterpret_cast<const int4*>(k + p0);
    uint32_t ev[4] = {e.x, e.y, e.z, e.w}, ov[4];
    int kv[4] = {kk.x, kk.y, kk.z, kk.w};
    // the early outs first; then only the peers that draw, one at a time
    uint32_t draw = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t el = c >= 32 ? ev[i] : ev[i] & ((1u << c) - 1u);
      ov[i] = (kv[i] <= 0 || el == 0u) ? 0u : el;
      if (kv[i] > 0 && kv[i] < __popc(el)) draw |= 1u << i;
    }
    while (draw != 0u) {
      const int i = __ffs(draw) - 1;
      draw &= draw - 1u;
      uint32_t el = 0u, sel = 0u;
      int ki = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q == i) { el = ev[q]; ki = kv[q]; }
      }
      uint32_t s;
      long long p;
      replica_of<BATCHED>(p0 + i, n_rep, seeds, seed, s, p);
      sel = gossip::select_k<CMAX>(el, c, ki, s, p, stride);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q == i) ov[q] = sel;
      }
    }
    *reinterpret_cast<uint4*>(out + p0) = make_uint4(ov[0], ov[1], ov[2],
                                                     ov[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < PEERS_PER_THREAD; ++i) {
    const long long g = p0 + i;
    if (g < n) {
      uint32_t s;
      long long p;
      replica_of<BATCHED>(g, n_rep, seeds, seed, s, p);
      out[g] = gossip::select_k<CMAX>(elig[g], c, k[g], s, p, stride);
    }
  }
}

template <int CMAX, bool BATCHED>
void launch_select(const void* elig, const void* k, void* out, long long n,
                   int c, uint32_t seed, uint32_t stride,
                   const uint32_t* seeds, long long n_rep, cudaStream_t s) {
  const long long threads = (n + PEERS_PER_THREAD - 1) / PEERS_PER_THREAD;
  const unsigned blocks =
      (unsigned)((threads + SELECT_THREADS - 1) / SELECT_THREADS);
  select_k_bits_kernel<CMAX, BATCHED><<<blocks, SELECT_THREADS, 0, s>>>(
      (const uint32_t*)elig, (const int32_t*)k, (uint32_t*)out, n, c, seed,
      stride, seeds, n_rep);
}

template <bool BATCHED>
void dispatch(const void* elig, const void* k, void* out, long long n, int c,
              uint32_t seed, uint32_t stride, const uint32_t* seeds,
              long long n_rep, cudaStream_t s) {
  if (c <= 8) {
    launch_select<8, BATCHED>(elig, k, out, n, c, seed, stride, seeds,
                              n_rep, s);
  } else if (c <= 16) {
    launch_select<16, BATCHED>(elig, k, out, n, c, seed, stride, seeds,
                               n_rep, s);
  } else {
    launch_select<32, BATCHED>(elig, k, out, n, c, seed, stride, seeds,
                               n_rep, s);
  }
}

}  // namespace

extern "C" int gossip_select_k_bits(const void* elig, const void* k,
                                    void* out, long long n, int c,
                                    unsigned int seed, unsigned int stride,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (((reinterpret_cast<uintptr_t>(elig) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(out)) & 15u) != 0u) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) dispatch<false>(elig, k, out, n, c, seed, stride, nullptr, n, s);
  return (int)cudaGetLastError();
}

// A replica stack in one launch: elig, k and out are [reps, n_rep] (one
// row of n_rep peers a replica), seeds the replicas' mixed lane seeds
// [reps], each replica's lanes indexed by its own peers (stride: n_rep).
extern "C" int gossip_select_k_bits_batched(const void* elig, const void* k,
                                            void* out, long long reps,
                                            long long n_rep, int c,
                                            const void* seeds,
                                            unsigned int stride,
                                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (((reinterpret_cast<uintptr_t>(elig) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(out)) & 15u) != 0u ||
      n_rep <= 0 || reps <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  dispatch<true>(elig, k, out, reps * n_rep, c, 0u, stride,
                 (const uint32_t*)seeds, n_rep, s);
  return (int)cudaGetLastError();
}

// The launch of a select call at n peers and c candidates: out[0] peers a
// block, out[1] blocks a multiprocessor, out[2] dynamic shared memory
// (none), out[3] the grid.
extern "C" int gossip_select_launch_config(long long n, int c, int* out) {
  const void* kernel =
      c <= 8 ? (const void*)select_k_bits_kernel<8, false>
             : c <= 16 ? (const void*)select_k_bits_kernel<16, false>
                       : (const void*)select_k_bits_kernel<32, false>;
  const long long threads = (n + PEERS_PER_THREAD - 1) / PEERS_PER_THREAD;
  out[0] = SELECT_THREADS * PEERS_PER_THREAD;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                SELECT_THREADS, 0);
  out[2] = 0;
  out[3] = (int)((threads + SELECT_THREADS - 1) / SELECT_THREADS);
  return (int)cudaGetLastError();
}
