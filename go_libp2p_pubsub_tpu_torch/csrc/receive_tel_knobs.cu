// The receive kernels with the telemetry tally and the knob vector
// (Hopper, sm_90a): each variant of receive_tel.cu with the shared body's
// KNB flag on as well (receive_knobs.cu says what the flag reads), in
// kernels of their own with the launch bounds of their twins, and the C
// entry point gossip_receive_update_tel_knobs.
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py, _receive_kernel
// with with_telemetry and with_knobs together.  Bound: the telemetry
// twin's operand bytes plus the 28-byte vector per launch.
#include "receive_body.cuh"

namespace {

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_tel_knobs(const ReceiveArgs a,
                         const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, true, true,
                false>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_tel_knobs(const ReceiveArgs a,
                                 const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, true, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full_tel_knobs(const ReceiveArgs a,
                              const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, false, true, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(2, SCORED, false))
receive_kernel_paired_tel_knobs(const ReceiveArgs a,
                                const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 2, SCORED, false, CBF, BBF, false, true, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_faults_tel_knobs(const ReceiveArgs a,
                                const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, true, true, true,
                false>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_faults_tel_knobs(
    const ReceiveArgs a, const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, true, true, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full_faults_tel_knobs(const ReceiveArgs a,
                                     const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, true, true, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(2, SCORED, false))
receive_kernel_paired_faults_tel_knobs(const ReceiveArgs a,
                                       const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 2, SCORED, false, CBF, BBF, true, true, true,
                false>(a, plan);
}

// this library's launcher for the dispatch of receive_body.cuh
struct TelKnobKernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static int launch(const ReceiveArgs& a, cudaStream_t s) {
    ReceiveKernel k;
    if constexpr (FAMILY == 2 && FAULTS) {
      k = receive_kernel_paired_faults_tel_knobs<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 2) {
      k = receive_kernel_paired_tel_knobs<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 1 && FAULTS) {
      k = receive_kernel_full_faults_tel_knobs<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 1) {
      k = receive_kernel_full_tel_knobs<C, W, SCORED, CBF, BBF>;
    } else if constexpr (ATK && FAULTS) {
      k = receive_kernel_attacks_faults_tel_knobs<C, W, CBF, BBF>;
    } else if constexpr (ATK) {
      k = receive_kernel_attacks_tel_knobs<C, W, CBF, BBF>;
    } else if constexpr (FAULTS) {
      k = receive_kernel_faults_tel_knobs<C, W, SCORED, CBF, BBF>;
    } else {
      k = receive_kernel_tel_knobs<C, W, SCORED, CBF, BBF>;
    }
    return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, true,
                     false>(k, a, s);
  }
};

}  // namespace

// gossip_receive_update_tel's arguments (receive_tel.cu) with the knob
// vector of gossip_receive_update_knobs (receive_knobs.cu); the return
// value as there (a replica stack: receive_tel_knobs_reps.cu's).
extern "C" int gossip_receive_update_tel_knobs(const ReceiveArgs* args,
                                               int c, int w, int scored,
                                               int attacks, int ctr_bf16,
                                               int bp_bf16, void* stream) {
  if (args->n > 0 && (args->tel == nullptr || args->knobs == nullptr ||
                      args->seeds != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_receive<TelKnobKernels>(*args, c, w, scored, attacks,
                                        ctr_bf16, bp_bf16,
                                        (cudaStream_t)stream);
}
