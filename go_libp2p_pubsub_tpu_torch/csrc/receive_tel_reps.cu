// The receive kernels with the telemetry tally over a replica stack
// (Hopper, sm_90a): the flagship options (scored and unscored) and the
// attack options, each also under fault schedules, with the shared body's
// TEL and REPS flags on, in kernels of their own (the launch bounds of
// their one-sim twins in receive_tel.cu, whose code stays as it was), and
// the C entry point gossip_receive_update_tel_reps.
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py, _receive_kernel
// with with_telemetry, under the reference's vmap of its telemetry step
// over a replica stack (telemetry_run_batch, models/telemetry.py:499: its
// frames [T, B]; its kernel has no batching rule, so the reference
// batches on its XLA step).  One launch for B replicas: the tiles walk B
// times a replica's tiles, and each replica's tally is its own row block
// of the [B, 8 + L] output.  A block's tiles run replica by replica (a
// static stride over tiles ordered by replica), so the block sums its
// rows in shared memory as one sim's kernel does and, at each change of
// replica and after its last tile, adds them into that replica's rows
// with one i32 atomicAdd a row (receive_body.cuh receive_tiles): no
// replica's counts reach another's, and integer sums stay exact and
// order-free.  The L latency-bucket rows read the replica's [L, W] masks
// of the [B, L, W] operand and its deliver words [B, W, N].  The full and
// paired variants stay one sim's (batched_surface, batched_paired).
//
// Bound: B times the one-sim launch's bytes (receive_tel.cu), all bytes.
#include "receive_body.cuh"

namespace {

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_tel_reps(const ReceiveArgs a,
    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, true, false, false,
                true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_tel_reps(const ReceiveArgs a,
    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, true, false, false,
                true>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_faults_tel_reps(const ReceiveArgs a,
    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, true, true, false, false,
                true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_faults_tel_reps(const ReceiveArgs a,
    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, true, true, false, false,
                true>(a, plan);
}

// this library's launcher for the dispatch of receive_body.cuh; the entry
// point refuses the full and paired choices before the dispatch, so those
// branches launch nothing
struct TelRepsKernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static int launch(const ReceiveArgs& a, cudaStream_t s) {
    if constexpr (FAMILY != 0) {
      return (int)cudaErrorInvalidValue;
    } else {
      ReceiveKernel k;
      if constexpr (ATK && FAULTS) {
        k = receive_kernel_attacks_faults_tel_reps<C, W, CBF, BBF>;
      } else if constexpr (ATK) {
        k = receive_kernel_attacks_tel_reps<C, W, CBF, BBF>;
      } else if constexpr (FAULTS) {
        k = receive_kernel_faults_tel_reps<C, W, SCORED, CBF, BBF>;
      } else {
        k = receive_kernel_tel_reps<C, W, SCORED, CBF, BBF>;
      }
      return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, true,
                       false>(k, a, s);
    }
  }
};

}  // namespace

// gossip_receive_update_tel's arguments (receive_tel.cu) over a replica
// stack: args->reps replicas, args->seeds their [reps, 2] lane seeds,
// every operand's rows replica by replica, args->tel the zeroed [reps,
// 8 + L] tally and with L > 0 the [reps, L, W] bucket masks.  The return
// value as there; cudaErrorInvalidValue for one sim (no seeds), the full
// or paired choice, or no tally.
extern "C" int gossip_receive_update_tel_reps(const ReceiveArgs* args,
                                              int c, int w, int scored,
                                              int attacks, int ctr_bf16,
                                              int bp_bf16, void* stream) {
  if (args->n <= 0) return 0;
  if (args->seeds == nullptr || args->full || args->paired ||
      args->tel == nullptr || args->knobs != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_receive<TelRepsKernels>(*args, c, w, scored, attacks,
                                        ctr_bf16, bp_bf16,
                                        (cudaStream_t)stream);
}
