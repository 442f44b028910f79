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

// the paired variant's blocks a multiprocessor (receive.cu PAIRED_BLOCKS)
constexpr int PAIRED_TEL_BLOCKS = 4;

// the variants of receive_tel.cu with KNB on, each with its twin's
// launch bound
template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256)
receive_kernel_tel_knobs(const ReceiveArgs a) {
  receive_tel_body<C, W, SCORED, false, CBF, BBF, false, false, false,
                   false, false, false, true>(a);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_attacks_tel_knobs(const ReceiveArgs a) {
  receive_tel_body<C, W, true, true, CBF, BBF, false, false, false,
                   false, false, false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_full_tel_knobs(const ReceiveArgs a) {
  receive_tel_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true,
                   SCORED, false, false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, PAIRED_TEL_BLOCKS)
receive_kernel_paired_tel_knobs(const ReceiveArgs a) {
  receive_tel_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true,
                   SCORED, true, false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256)
receive_kernel_faults_tel_knobs(const ReceiveArgs a) {
  receive_tel_body<C, W, SCORED, false, CBF, BBF, false, false, false,
                   false, false, true, true>(a);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_attacks_faults_tel_knobs(const ReceiveArgs a) {
  receive_tel_body<C, W, true, true, CBF, BBF, false, false, false,
                   false, false, true, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_full_faults_tel_knobs(const ReceiveArgs a) {
  receive_tel_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true,
                   SCORED, false, true, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, PAIRED_TEL_BLOCKS)
receive_kernel_paired_faults_tel_knobs(const ReceiveArgs a) {
  receive_tel_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true,
                   SCORED, true, true, true>(a);
}

// this library's launcher for the dispatch of receive_body.cuh
struct TelKnobKernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static void launch(const ReceiveArgs& a, unsigned blocks, cudaStream_t s) {
    constexpr int T = RECEIVE_THREADS;
    if constexpr (FAMILY == 2 && FAULTS) {
      receive_kernel_paired_faults_tel_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAMILY == 2) {
      receive_kernel_paired_tel_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAMILY == 1 && FAULTS) {
      receive_kernel_full_faults_tel_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAMILY == 1) {
      receive_kernel_full_tel_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (ATK && FAULTS) {
      receive_kernel_attacks_faults_tel_knobs<C, W, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (ATK) {
      receive_kernel_attacks_tel_knobs<C, W, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAULTS) {
      receive_kernel_faults_tel_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else {
      receive_kernel_tel_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    }
  }
};

}  // namespace

// gossip_receive_update_tel's arguments (receive_tel.cu) with the knob
// vector of gossip_receive_update_knobs (receive_knobs.cu); the return
// value as there.
extern "C" int gossip_receive_update_tel_knobs(const ReceiveArgs* args,
                                               int c, int w, int scored,
                                               int attacks, int ctr_bf16,
                                               int bp_bf16, void* stream) {
  if (args->n > 0 && (args->tel == nullptr || args->knobs == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_receive<TelKnobKernels>(*args, c, w, scored, attacks,
                                        ctr_bf16, bp_bf16,
                                        (cudaStream_t)stream);
}
