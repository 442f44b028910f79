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
__global__ void __launch_bounds__(256) receive_kernel(const ReceiveArgs a) {
  receive_body<C, W, SCORED, false, CBF, BBF>(a);
}

// The attack variant, held to four blocks of 256 threads a
// multiprocessor (at most 64 registers a thread, a few spills), as the
// others reach unbidden: left free, ptxas gives it 72-100 registers (100
// with bf16 counters: two blocks), and this latency-bound kernel runs
// about 1.5x slower on an H100 (kernel_ab.py).  Its own kernel, so that
// the bound leaves the other variants' code as it is.
template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_attacks(const ReceiveArgs a) {
  receive_body<C, W, true, true, CBF, BBF>(a);
}

// The full variant: every router-surface option compiled in (scored: on
// the attack variant's stage 1, with FLOOD and SAMEIP; unscored: EXACTK
// and PX only), each chosen at run time by the launch's arguments.  Its
// own kernel, so that the other variants' code stays as it is.  Held to
// four blocks a multiprocessor (64 registers, with spills) as the attack
// variant is: on a 1M-peer everything-on tick (H100, 700 W) 0.748 ms against
// 0.764 at three blocks (80 registers) and 0.938 at two (126, no spills).
template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_full(const ReceiveArgs a) {
  receive_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true, SCORED>(a);
}

// The paired variant: the full variant's options, each again a runtime
// choice, with the second topic slot compiled in.  Its own kernel, so
// that the other variants' code stays as it is; held to PAIRED_BLOCKS
// blocks a multiprocessor (64 registers, with spills): on a 1M-peer
// paired everything-on tick (H100, 700 W; kernel_ab.py) 0.930 ms against
// 0.997 at three blocks (80 registers) and 1.280 at two (128, no spills).
constexpr int PAIRED_BLOCKS = 4;

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, PAIRED_BLOCKS)
receive_kernel_paired(const ReceiveArgs a) {
  receive_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true, SCORED,
               true>(a);
}

// Each variant under fault schedules (FAULTS: the alive_w operand, and
// flood_ok under the IWANT flood), in kernels of their own with the
// launch bounds of the variant they fault, so that the unfaulted kernels'
// code stays as it is.
template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256)
receive_kernel_faults(const ReceiveArgs a) {
  receive_body<C, W, SCORED, false, CBF, BBF, false, false, false, false,
               false, true>(a);
}

template <int C, int W, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_attacks_faults(const ReceiveArgs a) {
  receive_body<C, W, true, true, CBF, BBF, false, false, false, false,
               false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, 4)
receive_kernel_full_faults(const ReceiveArgs a) {
  receive_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true, SCORED,
               false, true>(a);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF>
__global__ void __launch_bounds__(256, PAIRED_BLOCKS)
receive_kernel_paired_faults(const ReceiveArgs a) {
  receive_body<C, W, SCORED, SCORED, CBF, BBF, SCORED, true, true, SCORED,
               true, true>(a);
}

// this library's launcher for the dispatch of receive_body.cuh
struct Kernels {
  template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
            bool BBF, bool FAULTS>
  static void launch(const ReceiveArgs& a, unsigned blocks, cudaStream_t s) {
    constexpr int T = RECEIVE_THREADS;
    if constexpr (FAMILY == 2 && FAULTS) {
      receive_kernel_paired_faults<C, W, SCORED, CBF, BBF><<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAMILY == 2) {
      receive_kernel_paired<C, W, SCORED, CBF, BBF><<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAMILY == 1 && FAULTS) {
      receive_kernel_full_faults<C, W, SCORED, CBF, BBF><<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAMILY == 1) {
      receive_kernel_full<C, W, SCORED, CBF, BBF><<<blocks, T, 0, s>>>(a);
    } else if constexpr (ATK && FAULTS) {
      receive_kernel_attacks_faults<C, W, CBF, BBF><<<blocks, T, 0, s>>>(a);
    } else if constexpr (ATK) {
      receive_kernel_attacks<C, W, CBF, BBF><<<blocks, T, 0, s>>>(a);
    } else if constexpr (FAULTS) {
      receive_kernel_faults<C, W, SCORED, CBF, BBF><<<blocks, T, 0, s>>>(a);
    } else {
      receive_kernel<C, W, SCORED, CBF, BBF><<<blocks, T, 0, s>>>(a);
    }
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
