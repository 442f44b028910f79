// The receive kernels with the telemetry tally and the knob vector over a
// replica stack (Hopper, sm_90a): each kernel of receive_tel_reps.cu with
// the shared body's KNB flag on as well (the knob row of the tile's
// replica, [B, K]), in kernels of their own with the launch bounds of their
// one-sim twins in receive_tel_knobs.cu, and the C entry point
// gossip_receive_update_tel_knobs_reps.
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py, _receive_kernel
// with with_telemetry and with_knobs together, under the reference's vmap
// over a replica stack (receive_tel_reps.cu says how the tally is kept
// per replica).  Bound: the telemetry stack's bytes plus B 28-byte
// vectors.
#include "receive_body.cuh"

namespace {

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_tel_knobs_reps(const ReceiveArgs a,
    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, true, true, false,
                true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_tel_knobs_reps(const ReceiveArgs a,
    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, true, true, false,
                true>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_faults_tel_knobs_reps(const ReceiveArgs a,
    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, true, true, true, false,
                true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_faults_tel_knobs_reps(const ReceiveArgs a,
    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, true, true, true, false,
                true>(a, plan);
}

// this library's launcher for the dispatch of receive_body.cuh; the entry
// point refuses the full and paired choices before the dispatch, so those
// branches launch nothing
struct TelKnobRepsKernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static int launch(const ReceiveArgs& a, cudaStream_t s) {
    if constexpr (FAMILY != 0) {
      return (int)cudaErrorInvalidValue;
    } else {
      ReceiveKernel k;
      if constexpr (ATK && FAULTS) {
        k = receive_kernel_attacks_faults_tel_knobs_reps<C, W, CBF, BBF>;
      } else if constexpr (ATK) {
        k = receive_kernel_attacks_tel_knobs_reps<C, W, CBF, BBF>;
      } else if constexpr (FAULTS) {
        k = receive_kernel_faults_tel_knobs_reps<C, W, SCORED, CBF, BBF>;
      } else {
        k = receive_kernel_tel_knobs_reps<C, W, SCORED, CBF, BBF>;
      }
      return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, true,
                       false>(k, a, s);
    }
  }
};

}  // namespace

// gossip_receive_update_tel_reps' arguments (receive_tel_reps.cu) with the
// knob vectors [reps, K] of gossip_receive_update_knobs (receive_knobs.cu);
// the return value as there, and cudaErrorInvalidValue without them.
extern "C" int gossip_receive_update_tel_knobs_reps(
    const ReceiveArgs* args, int c, int w, int scored, int attacks,
    int ctr_bf16, int bp_bf16, void* stream) {
  if (args->n <= 0) return 0;
  if (args->seeds == nullptr || args->full || args->paired ||
      args->tel == nullptr || args->knobs == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_receive<TelKnobRepsKernels>(*args, c, w, scored, attacks,
                                            ctr_bf16, bp_bf16,
                                            (cudaStream_t)stream);
}
