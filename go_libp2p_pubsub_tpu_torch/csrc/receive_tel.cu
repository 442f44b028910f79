// The receive kernels with the telemetry tally (Hopper, sm_90a): each
// variant of receive.cu (the flagship options scored and unscored, the
// attack options, the full and paired variants, each under fault
// schedules too) with the shared body's TEL flag on, in kernels of their
// own with the launch bounds of their twins, so that the kernels of
// receive.cu keep their code, and the C entry point
// gossip_receive_update_tel.
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py, _receive_kernel
// with with_telemetry (its per-tick RPC and duplicate tallies, :604-668,
// :738-743, and the latency-bucket tallies, :744-757, emitted at
// :1000-1024).  On the TPU the grid runs in order on one core and carries
// the tally across grid steps in one revisited output block of 128 lane
// partials.  Here blocks run in parallel and in no order: each thread
// counts its peer's edges in registers through stage 1 (the body), leaves
// its eight rows and its delivered acquisitions in shared memory before
// stage 2, and after the body each warp of the block sums rows over the
// tile's peers (the L latency-bucket rows popcount the delivered
// acquisitions against the tick's bucket masks here, once, so no L
// accumulators stay live through the edge loop) into the block's rows in
// shared memory; after its last tile the block adds each row into the
// tally with one i32 atomicAdd (receive_tiles).  Integer sums are
// order-free, so the tally is exact and the same on every run.  The port
// runs unpadded, so there are no pad lanes to mask (the reference's
// :1004-1013): a thread past the last peer leaves zeros.  i32 as in the
// reference: at 1,024,000 peers, C = 16, W = 2 the largest row (received
// words, at most 16 * 2 * 32 per peer) stays below 1.05e9.
//
// Bound: the body's operand bytes plus the deliver words with latency
// buckets; the tally itself is 4 (8 + L) bytes and a few hundred integer
// operations per peer.
#include "receive_body.cuh"

namespace {

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_tel(const ReceiveArgs a,
                   const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, true, false,
                false>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_tel(const ReceiveArgs a,
                           const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, true, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full_tel(const ReceiveArgs a,
                        const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, false, true, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(2, SCORED, false))
receive_kernel_paired_tel(const ReceiveArgs a,
                          const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 2, SCORED, false, CBF, BBF, false, true, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_faults_tel(const ReceiveArgs a,
                          const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, true, true, false,
                false>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_faults_tel(const ReceiveArgs a,
                                  const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, true, true, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full_faults_tel(const ReceiveArgs a,
                               const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, true, true, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(2, SCORED, false))
receive_kernel_paired_faults_tel(const ReceiveArgs a,
                                 const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 2, SCORED, false, CBF, BBF, true, true, false,
                false>(a, plan);
}

// this library's launcher for the dispatch of receive_body.cuh
struct TelKernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static int launch(const ReceiveArgs& a, cudaStream_t s) {
    ReceiveKernel k;
    if constexpr (FAMILY == 2 && FAULTS) {
      k = receive_kernel_paired_faults_tel<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 2) {
      k = receive_kernel_paired_tel<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 1 && FAULTS) {
      k = receive_kernel_full_faults_tel<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 1) {
      k = receive_kernel_full_tel<C, W, SCORED, CBF, BBF>;
    } else if constexpr (ATK && FAULTS) {
      k = receive_kernel_attacks_faults_tel<C, W, CBF, BBF>;
    } else if constexpr (ATK) {
      k = receive_kernel_attacks_tel<C, W, CBF, BBF>;
    } else if constexpr (FAULTS) {
      k = receive_kernel_faults_tel<C, W, SCORED, CBF, BBF>;
    } else {
      k = receive_kernel_tel<C, W, SCORED, CBF, BBF>;
    }
    return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, true,
                     false>(k, a, s);
  }
};

}  // namespace

// gossip_receive_update's arguments (receive.cu) with args->tel, the
// zeroed tally [8 + L], and with L = args->tel_lat_buckets > 0 the
// latency-bucket masks and deliver words; the return value as there (a
// replica stack, with seeds, is receive_tel_reps.cu's:
// cudaErrorInvalidValue).
extern "C" int gossip_receive_update_tel(const ReceiveArgs* args, int c,
                                         int w, int scored, int attacks,
                                         int ctr_bf16, int bp_bf16,
                                         void* stream) {
  if (args->n > 0 && (args->tel == nullptr || args->seeds != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_receive<TelKernels>(*args, c, w, scored, attacks, ctr_bf16,
                                    bp_bf16, (cudaStream_t)stream);
}
