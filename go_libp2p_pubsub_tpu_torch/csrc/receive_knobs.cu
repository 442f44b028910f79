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

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_knobs(const ReceiveArgs a,
                     const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, false, true,
                false>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_knobs(const ReceiveArgs a,
                             const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, false, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full_knobs(const ReceiveArgs a,
                          const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, false, false, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(2, SCORED, false))
receive_kernel_paired_knobs(const ReceiveArgs a,
                            const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 2, SCORED, false, CBF, BBF, false, false, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_faults_knobs(const ReceiveArgs a,
                            const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, true, false, true,
                false>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_faults_knobs(const ReceiveArgs a,
                                    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, true, false, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full_faults_knobs(const ReceiveArgs a,
                                 const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, true, false, true,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(2, SCORED, false))
receive_kernel_paired_faults_knobs(const ReceiveArgs a,
                                   const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 2, SCORED, false, CBF, BBF, true, false, true,
                false>(a, plan);
}

// this library's launcher for the dispatch of receive_body.cuh
// (REPS) the flagship and attack options over a replica stack, with and
// without faults: one launch for every replica's tiles
template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_knobs_reps(const ReceiveArgs a,
                     const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, false, true,
                false, true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_knobs_reps(const ReceiveArgs a,
                             const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, false, true,
                false, true>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_faults_knobs_reps(const ReceiveArgs a,
                            const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, true, false, true,
                false, true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_faults_knobs_reps(
    const ReceiveArgs a, const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, true, false, true,
                false, true>(a, plan);
}

struct KnobKernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static int launch(const ReceiveArgs& a, cudaStream_t s) {
    ReceiveKernel k;
    if (a.seeds != nullptr) {
      // a replica stack (of any size: its lane seeds are per replica): the
      // flagship and attack options only (the step refuses the others in a
      // stack)
      if constexpr (FAMILY != 0) {
        return (int)cudaErrorInvalidValue;
      } else if constexpr (ATK && FAULTS) {
        k = receive_kernel_attacks_faults_knobs_reps<C, W, CBF, BBF>;
      } else if constexpr (ATK) {
        k = receive_kernel_attacks_knobs_reps<C, W, CBF, BBF>;
      } else if constexpr (FAULTS) {
        k = receive_kernel_faults_knobs_reps<C, W, SCORED, CBF, BBF>;
      } else {
        k = receive_kernel_knobs_reps<C, W, SCORED, CBF, BBF>;
      }
      return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, false,
                       false>(k, a, s);
    }
    if constexpr (FAMILY == 2 && FAULTS) {
      k = receive_kernel_paired_faults_knobs<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 2) {
      k = receive_kernel_paired_knobs<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 1 && FAULTS) {
      k = receive_kernel_full_faults_knobs<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 1) {
      k = receive_kernel_full_knobs<C, W, SCORED, CBF, BBF>;
    } else if constexpr (ATK && FAULTS) {
      k = receive_kernel_attacks_faults_knobs<C, W, CBF, BBF>;
    } else if constexpr (ATK) {
      k = receive_kernel_attacks_knobs<C, W, CBF, BBF>;
    } else if constexpr (FAULTS) {
      k = receive_kernel_faults_knobs<C, W, SCORED, CBF, BBF>;
    } else {
      k = receive_kernel_knobs<C, W, SCORED, CBF, BBF>;
    }
    return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, false,
                     false>(k, a, s);
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
