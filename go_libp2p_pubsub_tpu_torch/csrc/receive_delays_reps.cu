// The receive kernels' delay mode over a replica stack (Hopper, sm_90a):
// the flagship options (scored and unscored) and the attack options with
// the shared body's DELAY and REPS flags on, each also with KNB (the knob
// vector), in kernels of their own (the launch bounds of their one-sim
// twins in receive_delays.cu, whose code stays as it was), and the C entry
// point gossip_receive_update_delays_reps.
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py, _receive_kernel
// with with_delays, under the reference's vmap of its step over a replica
// stack (its kernel has no batching rule: the reference batches delayed
// sims on its XLA step, tests/test_delays.py:295-322).  One launch for B
// replicas: the tiles walk B times a replica's tiles, and a tile reads its
// replica's rows of every operand: the arrivals [B, C * W, N] staged by
// the bulk copies at row b * C * W + r (each replica's rows a multiple of
// 16 bytes, so a row's lead is the same in every replica), the GRAFT,
// PRUNE, retraction and broken-promise words [B, N], the validity words
// [B, W], the knob row [B, K] and the replica's two lane seeds.  The full
// variant stays one sim's (the step refuses the router surface in a
// stack, batched_surface).
//
// Bound: B times the one-sim launch's bytes (receive_delays.cu), all
// bytes.
#include "receive_body.cuh"

namespace {

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_delays_reps(const ReceiveArgs a,
                           const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, false, false,
                true, true>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_delays_knobs_reps(const ReceiveArgs a,
                                 const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, false, true,
                true, true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_delays_reps(const ReceiveArgs a,
                                   const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, false, false,
                true, true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_delays_knobs_reps(
    const ReceiveArgs a, const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, false, true,
                true, true>(a, plan);
}

// this library's launchers for the dispatch of receive_body.cuh, without
// and with knobs; the entry point refuses the full, paired and faulted
// choices before the dispatch, so those branches launch nothing
template <bool KNB>
struct DelayRepsKernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static int launch(const ReceiveArgs& a, cudaStream_t s) {
    if constexpr (FAMILY != 0 || FAULTS) {
      return (int)cudaErrorInvalidValue;
    } else {
      ReceiveKernel k;
      if constexpr (ATK && KNB) {
        k = receive_kernel_attacks_delays_knobs_reps<C, W, CBF, BBF>;
      } else if constexpr (ATK) {
        k = receive_kernel_attacks_delays_reps<C, W, CBF, BBF>;
      } else if constexpr (KNB) {
        k = receive_kernel_delays_knobs_reps<C, W, SCORED, CBF, BBF>;
      } else {
        k = receive_kernel_delays_reps<C, W, SCORED, CBF, BBF>;
      }
      return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, false,
                       true>(k, a, s);
    }
  }
};

}  // namespace

// gossip_receive_update_delays' arguments (receive_delays.cu) over a
// replica stack: args->reps replicas, args->seeds their [reps, 2] lane
// seeds, every operand's rows replica by replica; args->knobs non-null
// ([reps, K]) launches the knob variant.  The return value as there;
// cudaErrorInvalidValue for one sim (no seeds), the full, paired or
// faulted choice, or a missing delay operand.
extern "C" int gossip_receive_update_delays_reps(const ReceiveArgs* args,
                                                 int c, int w, int scored,
                                                 int attacks, int ctr_bf16,
                                                 int bp_bf16, void* stream) {
  if (args->n <= 0) return 0;
  if (args->seeds == nullptr || args->full || args->paired ||
      args->faults || args->arr == nullptr || args->graft_arr == nullptr ||
      args->prune_arr == nullptr || args->retract_in == nullptr ||
      (args->track_promises && args->cheat_arr == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->knobs != nullptr) {
    return launch_receive<DelayRepsKernels<true>>(
        *args, c, w, scored, attacks, ctr_bf16, bp_bf16,
        (cudaStream_t)stream);
  }
  return launch_receive<DelayRepsKernels<false>>(
      *args, c, w, scored, attacks, ctr_bf16, bp_bf16, (cudaStream_t)stream);
}
