// The receive kernels without telemetry (Hopper, sm_90a): one __global__
// per variant around the shared body of receive_body.cuh (the scored and
// unscored flagship options, the attack options, the full and paired
// variants, each under fault schedules too), their launcher for the
// shared dispatch and the C entry point gossip_receive_update.  What the
// body computes, what bounds it on this card and its design:
// receive_body.cuh.
#include "receive_body.cuh"

namespace {

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel(const ReceiveArgs a,
               const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, false, false,
                false>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks(const ReceiveArgs a,
                       const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, false, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full(const ReceiveArgs a,
                    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, false, false, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(2, SCORED, false))
receive_kernel_paired(const ReceiveArgs a,
                      const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 2, SCORED, false, CBF, BBF, false, false, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_faults(const ReceiveArgs a,
                      const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, true, false, false,
                false>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_faults(const ReceiveArgs a,
                              const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, true, false, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full_faults(const ReceiveArgs a,
                           const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, true, false, false,
                false>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(2, SCORED, false))
receive_kernel_paired_faults(const ReceiveArgs a,
                             const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 2, SCORED, false, CBF, BBF, true, false, false,
                false>(a, plan);
}

// (REPS) the flagship and attack options over a replica stack, with and
// without faults: one launch for every replica's tiles
template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_reps(const ReceiveArgs a,
                     const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, false, false,
                false, true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_reps(const ReceiveArgs a,
                             const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, false, false,
                false, true>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_faults_reps(const ReceiveArgs a,
                            const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, true, false, false,
                false, true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_faults_reps(
    const ReceiveArgs a, const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, true, false, false,
                false, true>(a, plan);
}

// this library's launcher for the dispatch of receive_body.cuh
struct Kernels {
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
        k = receive_kernel_attacks_faults_reps<C, W, CBF, BBF>;
      } else if constexpr (ATK) {
        k = receive_kernel_attacks_reps<C, W, CBF, BBF>;
      } else if constexpr (FAULTS) {
        k = receive_kernel_faults_reps<C, W, SCORED, CBF, BBF>;
      } else {
        k = receive_kernel_reps<C, W, SCORED, CBF, BBF>;
      }
      return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, false,
                       false>(k, a, s);
    }
    if constexpr (FAMILY == 2 && FAULTS) {
      k = receive_kernel_paired_faults<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 2) {
      k = receive_kernel_paired<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 1 && FAULTS) {
      k = receive_kernel_full_faults<C, W, SCORED, CBF, BBF>;
    } else if constexpr (FAMILY == 1) {
      k = receive_kernel_full<C, W, SCORED, CBF, BBF>;
    } else if constexpr (ATK && FAULTS) {
      k = receive_kernel_attacks_faults<C, W, CBF, BBF>;
    } else if constexpr (ATK) {
      k = receive_kernel_attacks<C, W, CBF, BBF>;
    } else if constexpr (FAULTS) {
      k = receive_kernel_faults<C, W, SCORED, CBF, BBF>;
    } else {
      k = receive_kernel<C, W, SCORED, CBF, BBF>;
    }
    return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, false,
                     false>(k, a, s);
  }
};

}  // namespace

// The arguments and return value: launch_receive (receive_body.cuh).
extern "C" int gossip_receive_update(const ReceiveArgs* args, int c, int w,
                                     int scored, int attacks, int ctr_bf16,
                                     int bp_bf16, void* stream) {
  return launch_receive<Kernels>(*args, c, w, scored, attacks, ctr_bf16,
                                 bp_bf16, (cudaStream_t)stream);
}
