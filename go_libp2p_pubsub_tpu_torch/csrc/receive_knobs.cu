// The receive kernels with the knob vector (Hopper, sm_90a): each variant
// of receive.cu (the flagship options scored and unscored, the attack
// options, the full and paired variants, each under fault schedules too)
// with the shared body's KNB flag on, in kernels of their own with the
// launch bounds of their twins, so that the kernels of receive.cu keep
// their code, and the C entry point gossip_receive_update_knobs.
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py, _receive_kernel
// with with_knobs (the f32 SMEM vector :179-194, :326-327; its consumers,
// the backoff restart :758-761, the targets' gossip_factor and d_lazy
// :808-810, the P4/P7 weights and the graylist and gossip thresholds
// :928-958).  One f32 vector, [gossip_factor, d_lazy, backoff_ticks] and
// scored [P4 weight, P7 weight, graylist, gossip threshold], read where
// each value is consumed (after the edge loop), in place of the baked
// launch arguments; the integer knobs are exact through f32 and cast
// back.  A template flag and kernels of their own rather than a runtime
// null check of the pointer: the check alone moved the registers or
// spills of 58 of receive.cu's 120 instantiations (PERF.md).
//
// Bound: the twin's operand bytes plus the 28-byte vector per launch.
#include "receive_body.cuh"

namespace {

// receive.cu's PAIRED_BLOCKS
constexpr int PAIRED_BLOCKS = 4;

// the variants of receive.cu with KNB on, each with its twin's launch
// bound (TEL off: receive_tel_knobs.cu holds those with telemetry) but
// the flagship options', held to the blocks a multiprocessor their twins
// reach unbidden: scored four of 256 threads (left free, the knob reads
// take them to 66 registers, three blocks, and 0.640 ms against the
// twin's 0.522 on a 1M-peer tick), unscored eight (a bound of four let
// them take 39 registers, six blocks, and 0.136 ms against 0.107; H100,
// 700 W; PERF.md)

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, SCORED ? 4 : 8)
receive_kernel_knobs(const ReceiveArgs a) {
  receive_body<C, W, SCORED, false, CBF, BBF, false, false, false, false,
               false, false, false, true>(a);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_attacks_knobs(const ReceiveArgs a) {
  receive_body<C, W, true, true, CBF, BBF, false, false, false, false,
               false, false, false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_full_knobs(const ReceiveArgs a) {
  receive_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true, SCORED,
               false, false, false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, PAIRED_BLOCKS)
receive_kernel_paired_knobs(const ReceiveArgs a) {
  receive_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true, SCORED,
               true, false, false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, SCORED ? 4 : 8)
receive_kernel_faults_knobs(const ReceiveArgs a) {
  receive_body<C, W, SCORED, false, CBF, BBF, false, false, false, false,
               false, true, false, true>(a);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_attacks_faults_knobs(const ReceiveArgs a) {
  receive_body<C, W, true, true, CBF, BBF, false, false, false, false,
               false, true, false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_full_faults_knobs(const ReceiveArgs a) {
  receive_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true, SCORED,
               false, true, false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, PAIRED_BLOCKS)
receive_kernel_paired_faults_knobs(const ReceiveArgs a) {
  receive_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true, SCORED,
               true, true, false, true>(a);
}

// this library's launcher for the dispatch of receive_body.cuh
struct KnobKernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static void launch(const ReceiveArgs& a, unsigned blocks, cudaStream_t s) {
    constexpr int T = RECEIVE_THREADS;
    if constexpr (FAMILY == 2 && FAULTS) {
      receive_kernel_paired_faults_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAMILY == 2) {
      receive_kernel_paired_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAMILY == 1 && FAULTS) {
      receive_kernel_full_faults_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAMILY == 1) {
      receive_kernel_full_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (ATK && FAULTS) {
      receive_kernel_attacks_faults_knobs<C, W, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (ATK) {
      receive_kernel_attacks_knobs<C, W, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAULTS) {
      receive_kernel_faults_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    } else {
      receive_kernel_knobs<C, W, SCORED, CBF, BBF>
          <<<blocks, T, 0, s>>>(a);
    }
  }
};

}  // namespace

// gossip_receive_update's arguments (receive.cu) with args->knobs, the
// knob vector ([3] unscored, [7] scored), and (scored) args->topic_weight;
// the return value as there.
extern "C" int gossip_receive_update_knobs(const ReceiveArgs* args, int c,
                                           int w, int scored, int attacks,
                                           int ctr_bf16, int bp_bf16,
                                           void* stream) {
  if (args->n > 0 && args->knobs == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_receive<KnobKernels>(*args, c, w, scored, attacks, ctr_bf16,
                                     bp_bf16, (cudaStream_t)stream);
}
