// The receive kernels' delay mode (Hopper, sm_90a): the flagship options
// (scored and unscored), the attack options and the full variant with the
// shared body's DELAY flag on, each also with KNB (the knob vector), in
// kernels of their own (launch bounds below), so that the kernels of the
// other sources keep their code; and the C entry point
// gossip_receive_update_delays.
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py, _receive_kernel
// with with_delays (the operands :335-348; no DMA scratch :406; the
// arrivals :513-541; the sender-edge loop skipped :544; no fault or
// accept masking of the control :679, :693; the retraction taken as given
// :706-709).  The step (models/gossipsub.py delay_exchange) enqueues this
// tick's sends into the K-slot delay lines and dequeues the slot due now:
// the kernel reads the dequeued payload words per receiving edge (arr,
// [C*W, N], row j*W + w: already send-gated, rolled and alive-masked), the
// GRAFT and PRUNE words arriving (alive-masked and, scored, accept-gated),
// the retractions taking effect and, with the attack options tracking
// promises, the broken-promise adverts arriving.  Per edge it splits out
// the news and (scored) counts its valid and invalid ids; everything after
// the handshake (backoff, P1/P2/P4/P7 counters, the serve ledger, scores,
// gates, targets, the PX trigger word) is the body as it stands.  Faults
// and telemetry are composed in the step (no FAULTS or TEL variant);
// paired topics and the IWANT flood are refused there, as the reference
// refuses them.
//
// Bound: per peer at C = 16, W = 1 the arrival rows (64 B) and three or
// four [N] words replace the 16 ctrl bytes, the sender's fresh and advert
// words and the payload, gossip and accept gate words: the scored flagship
// options move 536 B/peer against the twin's 496 (attack 544 against 500,
// full 676 against 636, unscored 192 against 140; PERF.md), all bytes.
#include "receive_body.cuh"

namespace {

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_delays(const ReceiveArgs a,
                      const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, false, false,
                true>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, SCORED, false))
receive_kernel_delays_knobs(const ReceiveArgs a,
                            const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, SCORED, false, CBF, BBF, false, false, true,
                true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_delays(const ReceiveArgs a,
                              const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, false, false,
                true>(a, plan);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(0, true, true))
receive_kernel_attacks_delays_knobs(const ReceiveArgs a,
                                    const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 0, true, true, CBF, BBF, false, false, true,
                true>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full_delays(const ReceiveArgs a,
                           const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, false, false, false,
                true>(a, plan);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(RECEIVE_THREADS,
                                  receive_blocks(1, SCORED, false))
receive_kernel_full_delays_knobs(const ReceiveArgs a,
                                 const __grid_constant__ StagePlan plan) {
  receive_tiles<C, W, 1, SCORED, false, CBF, BBF, false, false, true,
                true>(a, plan);
}

// this library's launchers for the dispatch of receive_body.cuh, without
// and with knobs; the entry point refuses the paired and faulted choices
// before the dispatch, so those branches launch nothing
template <bool KNB>
struct DelayKernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static int launch(const ReceiveArgs& a, cudaStream_t s) {
    if constexpr (FAMILY == 2 || FAULTS) {
      return (int)cudaErrorInvalidValue;
    } else {
      ReceiveKernel k;
      if constexpr (FAMILY == 1 && KNB) {
        k = receive_kernel_full_delays_knobs<C, W, SCORED, CBF, BBF>;
      } else if constexpr (FAMILY == 1) {
        k = receive_kernel_full_delays<C, W, SCORED, CBF, BBF>;
      } else if constexpr (ATK && KNB) {
        k = receive_kernel_attacks_delays_knobs<C, W, CBF, BBF>;
      } else if constexpr (ATK) {
        k = receive_kernel_attacks_delays<C, W, CBF, BBF>;
      } else if constexpr (KNB) {
        k = receive_kernel_delays_knobs<C, W, SCORED, CBF, BBF>;
      } else {
        k = receive_kernel_delays<C, W, SCORED, CBF, BBF>;
      }
      return run_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, false,
                       true>(k, a, s);
    }
  }
};

}  // namespace

// gossip_receive_update's arguments (receive.cu) with the delay mode's
// operands (args->arr, graft_arr, prune_arr, retract_in and, tracking
// promises, cheat_arr) in place of the sender streams and the payload,
// gossip and accept gate words; args->knobs non-null launches the knob
// variant.  The return value as there; cudaErrorInvalidValue for a paired
// or faulted launch, a missing delay operand or a replica stack (with
// seeds: receive_delays_reps.cu's).
extern "C" int gossip_receive_update_delays(const ReceiveArgs* args, int c,
                                            int w, int scored, int attacks,
                                            int ctr_bf16, int bp_bf16,
                                            void* stream) {
  if (args->n <= 0) return 0;
  if (args->seeds != nullptr || args->paired || args->faults ||
      args->arr == nullptr ||
      args->graft_arr == nullptr || args->prune_arr == nullptr ||
      args->retract_in == nullptr ||
      (args->track_promises && args->cheat_arr == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->knobs != nullptr) {
    return launch_receive<DelayKernels<true>>(*args, c, w, scored, attacks,
                                              ctr_bf16, bp_bf16,
                                              (cudaStream_t)stream);
  }
  return launch_receive<DelayKernels<false>>(*args, c, w, scored, attacks,
                                             ctr_bf16, bp_bf16,
                                             (cudaStream_t)stream);
}
