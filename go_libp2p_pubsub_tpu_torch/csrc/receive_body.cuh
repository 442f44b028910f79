// The GossipSub heartbeat's receive half, one thread per peer (Hopper,
// sm_90a): the argument block and the body that every receive kernel
// instantiates.  receive.cu holds the kernels without telemetry,
// receive_tel.cu those with it (TEL), receive_knobs.cu and
// receive_tel_knobs.cu their twins with the knob vector (KNB); each is
// its own library, built concurrently.
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py, _receive_kernel
// (built by make_receive_update), for the options the port runs: the
// scored v1.1 step (SCORED = true) and the unscored v1.0 step
// (SCORED = false: no validity masks, payload/gossip/accept gates,
// counters or scores, two gate rows); scored, the attack options (ATK =
// true: track_promises, the IHAVE-spam targets override and the
// IWANT-flood serve accrual, each a warp-uniform runtime flag); and the
// router-surface options, compiled in by the template flags FLOOD,
// EXACTK, PX and SAMEIP (all false in the variants above) and served by
// one more kernel, receive_kernel_full, where each is again a
// warp-uniform runtime choice: flood publishing (FLOOD: the sender's
// injected words, a fourth sender stream, over the edges whose ctrl byte
// carries CTRL_FLOOD, under the receiver's payload gate), exact-k gossip
// targets (EXACTK: the exact uniform k-subset, select_k of lane.cuh at
// the targets' lane seed, instead of the Bernoulli draw), the PX trigger
// word (PX: one more output, the PRUNEs and PRUNE-responses received)
// and the shared-IP gater (SAMEIP: each edge's goodput from the f32 sums
// of the stored counters over its same-IP siblings, added in candidate
// order 0..C-1); and paired topics (PAIRED, one more kernel,
// receive_kernel_paired, with every option of the full one: each peer's
// second topic slot has its own mesh, backoff and time in mesh, its
// senders' flags on a second ctrl byte and its payload on a fifth sender
// stream, fresh_b, read over the edges whose second ctrl byte carries
// CTRL2_OUT_B under the receiver's payload gate; on an edge whose offset
// is an odd multiple of T/2 the partner holds the topic in its other
// slot, so the two ctrl bytes' GRAFT/PRUNE/A bits cross slots, a static
// choice per edge, odd_mask); and each of these under fault schedules
// (FAULTS, one more kernel per variant with that variant's launch bound:
// the receiver's alive word, all-ones or 0 at a down peer, gates the
// words it hears and the GRAFT, PRUNE, A and broken-promise bits it
// receives, and under the IWANT flood the flood_ok word gates the flood's
// serve accrual per edge; the senders' masks ride the ctrl bytes); and
// each of these with the telemetry tally (TEL, receive_tel.cu); and each
// of those with the knob vector (KNB, receive_knobs.cu and
// receive_tel_knobs.cu: gossip_factor, d_lazy and backoff_ticks, scored
// also the P4 and P7 weights and the graylist and gossip thresholds, read
// in place of the baked launch arguments where each is consumed); and
// the delay mode (DELAY, receive_delays.cu: the flagship options, the
// attack options, the full variant and unscored, each with and without
// KNB; no FAULTS, TEL or PAIRED): stage 1 reads this tick's arrivals per
// receiving edge, dequeued from the step's delay line (arr, row j*W + w,
// already send-gated, rolled and alive-masked), in place of the sender
// streams, and the GRAFT, PRUNE and retraction words the step resolved at
// arrival (graft_arr, prune_arr, retract_in: no ctrl bytes, no accept
// gating here) and, ATK, the broken-promise adverts arriving (cheat_arr,
// counted where some id is lacked).  Same semantics
// and op order, so every output is bit-identical to the plain version
// (ops/kernels/receive.py receive_update_plain):
//
//   stage 1, per receiving edge j: the sender q = (p + o_j) mod N, its
//     ctrl byte (row cinv[j]) and its fresh/advert words, gated (scored)
//     by this peer's payload and gossip gate bits; news = got & ~seen,
//     and (scored) the valid and invalid popcounts (P2/P4 provenance);
//     (ATK) the broken-promise bit (advertised, CTRL_ADV, without
//     delivering, CTRL_TGT, the receiver's gossip gate open and some id
//     lacked) and the edge's IWANT-serve ledger, where a sybil
//     receiver's pull under the IWANT flood is the popcount of the
//     sender's raw advert words while the ledger before decay is under
//     gossip_retransmission such windows;
//     the GRAFT/PRUNE/A handshake resolves into mesh and backoff;
//   (PAIRED) slot B's handshake the same way, from the routed bits;
//   per row c: backoff restart/decrement (PAIRED: both slots'); scored:
//   time in mesh (PAIRED: both slots'), the
//     decayed first/invalid-delivery and behaviour-penalty counters (f32
//     arithmetic, stored with round-to-nearest-even bf16 where the
//     counter dtype is bf16; PAIRED: slot B's backoff violations added
//     to P7 after slot A's; ATK: the broken promises after those), the
//     IWANT-serve ledger (ATK: stage 1);
//   stage 2: the next tick's gate words: scored, the seven rows from the
//     stored counters (the score thresholds, the RED gater with an
//     in-kernel lane hash and its pressure summed over c = 0..C-1 in
//     order, the Bernoulli gossip targets; ATK: IHAVE-spamming sybils
//     target every subscribed candidate); unscored, the targets and
//     backoff rows; PAIRED: slot B's P1 added to the topic part before
//     its cap, the targets outside both meshes, and slot B's backoff
//     row last (eight rows scored, three unscored);
//   (TEL) the tick's tally: per edge, the payload words sent (eager,
//     slot B, flood; before the receiver's alive mask), the ids
//     advertised on the edges the sender targeted (CTRL_ADV), the
//     gossip-pulled and received words and the advertised ids this
//     peer lacks (after the alive mask), one IHAVE RPC per targeted edge
//     with a nonempty advert and one IWANT RPC per edge with a lacked
//     id; after the loop the new acquisitions and, with latency buckets,
//     the delivered acquisitions; the body leaves each peer's rows in
//     shared memory and the kernel (receive_tel.cu) sums them.
//
// Every multiply, add and divide is written with the _rn intrinsics and
// the file is built with --fmad=false: XLA and PyTorch round each
// operation separately, and a contracted FMA would change score bits.
//
// Bound on this card: memory.  Counting each operand byte once, the
// scored flagship tick (C = 16, W = 1, no static score term) reads about
// 268 B/peer (six i16/bf16 [C, N] counter/backoff rows, the C ctrl bytes,
// eleven packed [N] words, the seen/injected/fresh/advert words) and
// writes about 228 B/peer: about 0.5 GB per tick at 1M peers, about
// 150 us at 3.35 TB/s; the attack variant adds the sybil word, 4 B/peer.
// The unscored tick moves about 140 B/peer at W = 1 (ctrl 16, backoff in
// and out 64, seven [N] words 28, four [W, N] words 16, acq 4, mesh 4,
// two gate rows 8).  The full variant adds up to 4 B of injected words,
// 64 B of sibling words and the 4 B trigger word; the paired variant the
// second ctrl byte (16 B), slot B's handshake words (20 B), mesh (4 B),
// backoff and time-in-mesh rows in and out (128 B) and one gate row; faults
// the alive word and, under the IWANT flood, the flood_ok word (4 B
// each); telemetry the deliver words (4W B with latency buckets).  The
// arithmetic (a few hundred integer and f32 operations per peer) is far
// below the card's rate.
//
// Design (the tile staged in shared memory).  The first version read each
// [C, N] operand one 1- or 2-byte element a thread at a time.  Now a
// persistent grid, as many blocks a multiprocessor as the stage and the
// launch bound allow, walks tiles of RECEIVE_TILE peers with a static
// stride; for each tile one warp issues bulk asynchronous tensor copies
// (TMA, cp.async.bulk.tensor.1d) of every [C, N]-shaped operand the variant
// reads — the tile's slice of each counter, backoff and time row (and the
// static score term, the sibling words, the arrivals), and per edge j the
// sender ctrl bytes at cinv[j] * N + (p0 + o_j) mod N, a second copy where
// that window wraps past N — into shared memory, completed on an mbarrier
// with the tile's byte count; the other blocks of the multiprocessor compute
// meanwhile.  One-dimensional tensor maps (cuTensorMapEncodeTiled, looked up
// through the CUDA runtime, so the library links no more than before) fill
// zeros past either end, so any N and the ragged last tile need no other
// path; a box must start on a 16-byte boundary of the operand and land on a
// 128-byte boundary of shared memory, so each copy starts at the boundary at
// or below its first element and takes 16 bytes more (Staged reads past the
// lead), and the wrapper copies an operand that does not start on a 16-byte
// boundary.  Each thread runs the body's arithmetic for its peer unchanged,
// reading its rows from shared memory; its [N] and [W, N] words (4-byte,
// coalesced) and the sender's fresh, advert, injected and slot-B words (per
// open edge; at 1M peers [W, N] arrays that stay in L2) are read from device
// memory through the read-only path.  Outputs are coalesced stores from
// registers.  Telemetry sums each block's rows across its tiles in shared
// memory and adds them into the tally once a block.  What bounds it now: not
// bytes but its instruction chain at the threads a multiprocessor holds
// (PERF.md): the staging removed the element loads, and the occupancy its
// shared memory allows decides the rest.
//
// The replica axis (ReceiveArgs.reps): a stack of B sims of N peers each is
// one launch.  Every [R, N] operand is a [B * R, N] array of rows, replica
// b's row r at row b * R + r, so the tiles walk B times a replica's tiles,
// a tile never straddles two replicas, and its staged rows and a wrapping
// ctrl window's second box stay inside its replica's rows (the wrap at N is
// the replica's own).  The body reads its replica's rows by an index
// offset (o1 = b * N elements a row) from the launch's base pointers, and
// its per-replica scalars by b: the two lane seeds (ReceiveArgs.seeds),
// the validity words ([B, W]) and the knob row ([B, K]).  A 16-byte lead is
// the same in every replica (each staged slot's rows are 16-byte multiples
// of N).  The replica is a template flag (REPS) of the flagship and attack
// options' kernels, with and without faults and knobs (the families a
// stack runs), in their delay mode (receive_delays_reps.cu: the arrival
// rows [C * W, N] and the handshake words of the tile's replica) and with
// the telemetry tally (receive_tel_reps.cu, receive_tel_knobs_reps.cu:
// the tally [reps, 8 + L], the bucket masks [reps, L, W]; a block's tiles
// run replica by replica, and its rows are added into a replica's row
// block at each change of replica, so no replica's counts reach
// another's): one sim (no seeds) launches the kernels without it, whose
// offsets fold to 0, so a stack's index arithmetic costs one sim nothing
// (an offset in every body, one sim's too, ran the flagship's receive 7.8%
// and the attack options' 31% slower on 1M-peer ticks, H100, 700 W,
// kernel_ab.py --parent: registers at the launch bound).
#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lane.cuh"

// Pointers marked (scored) are null for the unscored variant.
struct ReceiveArgs {
  // inputs
  const uint8_t* ctrl;       // [C, N] sender ctrl bytes, row = sender edge
  const uint32_t* fresh;     // [W, N] sender fresh words
  const uint32_t* adv;       // [W, N] sender advert words
  const uint32_t* pay;       // [N] payload gate bits (scored)
  const uint32_t* gsp;       // [N] gossip gate bits (scored)
  const uint32_t* acc;       // [N] accept (graylist) gate bits (scored)
  const uint32_t* sub_all;   // [N] all-ones (C bits) iff subscribed
  const uint32_t* cand_sub;  // [N] subscribed candidates
  const uint32_t* fanout;    // [N] this tick's fanout
  const uint32_t* wa;        // [N] would-accept bits
  const uint32_t* bo2;       // [N] post-write backoff bits (scored)
  const uint32_t* grafts;    // [N] GRAFTs sent
  const uint32_t* dropped;   // [N] PRUNEs sent
  const uint32_t* meshsel;   // [N] mesh after maintenance selections
  const uint32_t* seen;      // [W, N] held or injected this tick
  const uint32_t* inj;       // [W, N] injected this tick
  const uint32_t* valid;     // [W] message validity masks (scored)
  const int16_t* backoff;    // [C, N] remaining backoff ticks
  // (scored) the score counters
  const float* stat;         // [C, N] static P5+P6 term, or null
  const void* fd;            // [C, N] first deliveries (counter dtype)
  const void* inv;           // [C, N] invalid deliveries (counter dtype)
  const void* bp;            // [C, N] behaviour penalty (bp dtype)
  const int16_t* tim;        // [C, N] time in mesh
  const int16_t* iws;        // [C, N] IWANT-serve ledger
  const uint32_t* syb;       // [N] (ATK) ALL for a spamming sybil, else 0
  // outputs
  uint32_t* acq;             // [W, N]
  uint32_t* mesh;            // [N]
  int16_t* backoff_out;      // [C, N]
  uint32_t* gates;           // [7, N] scored, [2, N] unscored (a stack:
                             // [7, reps, N], [2, reps, N])
  // (scored) the updated counters
  void* fd_out;
  void* inv_out;
  void* bp_out;
  int16_t* tim_out;
  int16_t* iws_out;
  // scalars
  long long n;
  int offsets[16];           // o_j mod N, in [0, N)
  int cinv[16];
  unsigned int seed_gater;   // lane_seed(tick + 1, 6, salt) (scored)
  unsigned int seed_targets; // lane_seed(tick + 1, 1, salt)
  unsigned int stride;       // lane stream row stride (true N)
  int backoff_restart;       // backoff_ticks - 1
  int d_lazy;
  int history_length;
  int has_topic_cap;
  int track_promises;        // (ATK) P7 for broken promises
  int ihave_spam;            // (ATK) sybils target every candidate
  int iwant_spam;            // (ATK) sybil receivers flood IWANTs
  int retransmission;        // (ATK) gossip_retransmission
  float gossip_factor;
  float fd_cap;
  float fd_decay;
  float inv_decay;
  float bp_decay;
  float decay_to_zero;
  float c_tim;               // f32(topic_weight * time_in_mesh_weight)
  float tim_quantum;
  float tim_cap;
  float c_fd;                // f32(topic_weight * fmd_weight)
  float c_inv;               // f32(topic_weight * imd_weight)
  float topic_cap;
  float bp_thr;
  float w_bp;
  float gray_thr;
  float gossip_thr;
  float publish_thr;
  // the full variant's fields, last, so that the struct's head is the
  // same for every variant
  const uint32_t* inj_send;  // [W, N] (FLOOD) injected words, sender view
  const uint32_t* same_ip;   // [C, N] (SAMEIP) same-IP sibling words
  uint32_t* px_rot;          // [N] (PX) PRUNEs / PRUNE-responses received
  int full;                  // launch receive_kernel_full
  int flood_publish;         // (FLOOD) read CTRL_FLOOD and inj_send
  int exact_k;               // (EXACTK) exact-k targets, else Bernoulli
  // the paired variant's fields, after those
  const uint8_t* ctrl2;      // [C, N] second ctrl bytes, slot-B flags
  const uint32_t* fresh_b;   // [W, N] sender slot-B fresh words
  const uint32_t* wa_b;      // [N] slot-B would-accept bits
  const uint32_t* bo2_b;     // [N] slot-B post-write backoff bits (scored)
  const uint32_t* grafts_b;  // [N] slot-B GRAFTs sent
  const uint32_t* dropped_b; // [N] slot-B PRUNEs sent
  const uint32_t* meshsel_b; // [N] slot-B mesh after maintenance
  const int16_t* backoff_b;  // [C, N] slot-B remaining backoff ticks
  const int16_t* tim_b;      // [C, N] slot-B time in mesh (scored)
  uint32_t* mesh_b_out;      // [N]
  int16_t* backoff_b_out;    // [C, N]
  int16_t* tim_b_out;        // [C, N] (scored)
  unsigned int odd_mask;     // bit j: edge j crosses slots
  int paired;                // launch receive_kernel_paired
  // the fault options' fields, after those
  const uint32_t* alive_w;   // [N] (FAULTS) receiver alive: ~0u or 0
  const uint32_t* flood_ok;  // [N] (FAULTS, IWANT flood) send-ok and
                             // partner-alive bits, or null
  int faults;                // launch the variant's faulted kernel
  // the telemetry fields, after those
  const uint32_t* lat_masks; // [L, W] (TEL, L > 0) latency-bucket masks
  const uint32_t* dlv_eff;   // [W, N] (TEL, L > 0) effective deliver words
  int* tel;                  // [8 + L] (TEL) the tally, zeroed by the caller
  int tel_lat_buckets;       // L
  // the knob fields, after those
  const float* knobs;        // [3] unscored / [7] scored (KNOB_*), or
                             // null: the baked arguments above
  float topic_weight;        // f32(topic_weight) (scored, knobs)
  // the delay mode's fields, last (null in every other variant)
  const uint32_t* arr;       // [C*W, N] (DELAY) arrivals, row j*W + w
  const uint32_t* graft_arr; // [N] (DELAY) GRAFTs arriving
  const uint32_t* prune_arr; // [N] (DELAY) PRUNEs arriving
  const uint32_t* retract_in;  // [N] (DELAY) retractions taking effect
  const uint32_t* cheat_arr; // [N] (DELAY, ATK tracking promises)
                             // broken-promise adverts arriving
  // the replica axis, last: a stack of reps sims of n peers each, every
  // [R, N] operand a [reps * R, N] array of rows (replica b's row r is row
  // b * R + r; a [W] or knob operand likewise [reps, W], [reps, K], the
  // tally [reps, 8 + L], the bucket masks [reps, L, W]); a stack has
  // seeds, one sim none (reps 0) and reads the seeds above
  int reps;
  const uint32_t* seeds;     // [reps, 2] (gater, targets) lane seeds
  int knob_stride;           // K, the knob vector's length (KNB)
};

namespace {

constexpr int CTRL_OUT = 0, CTRL_TGT = 1, CTRL_GRAFT = 2, CTRL_DROP = 3,
              CTRL_A = 4, CTRL_ADV = 5, CTRL_FLOOD = 6;
// the tally's rows (ops/kernels/receive.py TEL_ROWS); the latency-bucket
// rows follow
constexpr int TEL_PAYLOAD = 0, TEL_IHAVE_IDS = 1, TEL_IWANT_SERVED = 2,
              TEL_RECV = 3, TEL_IWANT_REQ = 4, TEL_IHAVE_RPCS = 5,
              TEL_IWANT_RPCS = 6, TEL_NEW_IDS = 7, TEL_ROWS = 8;
// the second ctrl byte (PAIRED); GRAFT, PRUNE and A sit in the same
// order as on the first, so each byte's handshake is one 3-bit field
constexpr int CTRL2_OUT_B = 0, CTRL2_GRAFT_B = 1;
// the knob vector's rows (ops/kernels/receive.py KNOB_*): the protocol
// scalars, then (scored) the defense knobs; the integer knobs ride as
// exact f32 values
constexpr int KNOB_GF = 0, KNOB_DLAZY = 1, KNOB_BT = 2, KNOB_INVW = 3,
              KNOB_BPW = 4, KNOB_GRAY = 5, KNOB_GSP = 6;

using gossip::lane_u;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// replica rb's lane seed (which: 0 the gater's, 1 the targets'): from
// the stack's [reps, 2] seeds, else the one sim's launch arguments
__device__ __forceinline__ uint32_t seed_of(const ReceiveArgs& a, int rb,
                                            int which) {
  if (a.seeds != nullptr) return __ldg(&a.seeds[2 * rb + which]);
  return which ? a.seed_targets : a.seed_gater;
}

// ---- the staged tile

// threads a block; a tile is RECEIVE_TILE peers, one a thread (the last
// 16 threads of a block run no peer).  112 peers (7 × 16) keep each
// tile's first peer on a 16-element boundary, and a copy of a 2-byte row
// with its 16-byte lead fills 240 of a 256-byte row of the stage.
constexpr int RECEIVE_THREADS = 128;
constexpr int RECEIVE_TILE = 112;

// The least blocks a multiprocessor each kernel is built for (its launch
// bound: the registers a thread may take).  At C = 16, W = 1 with bf16
// counters the flagship and attack options' stage (28 KB) lets seven
// blocks share a multiprocessor, the full variant's (36 KB) six, the
// paired variant's (48 KB) four, unscored (8-16 KB) twelve at 40
// registers (the parent's unscored kernels ran eight blocks of 256
// threads at 32).  On 1M-peer ticks (H100, 700 W; kernel_ab.py, PERF.md) the
// flagship options ran 0.506 ms at six blocks (80 registers, no spills)
// against 0.517 at seven (72, 28 B of spills), the attack options 0.533
// at seven against 0.602 at six, the full variant 1.203 at five against
// 1.220 at six.
__host__ __device__ constexpr int receive_blocks(int family, bool scored,
                                                 bool atk) {
  return !scored ? 12 : family == 0 ? (atk ? 7 : 6) : family == 1 ? 5 : 4;
}

// The operands a tile stages, each in its own slot of a stage: [R, N]
// rows copied at r * N + p0 (R = C, or C * W for the arrivals), and the
// ctrl-byte windows (C edges, each with room for its wrap piece).  The
// static score term comes last: it is null on most launches, and its room
// is added to the stage only when it is not.
enum Slot : int {
  SL_BACKOFF, SL_TIM, SL_FD, SL_INV, SL_BP, SL_IWS, SL_BACKOFF_B, SL_TIM_B,
  SL_SAMEIP, SL_ARR, SL_CTRL, SL_CTRL2, SL_STAT,
  N_SLOTS
};

__host__ __device__ constexpr uint64_t slot_bit(int s) { return 1ull << s; }

// The slots a variant's body reads (FAMILY: 0 the flagship or attack
// options, 1 full, 2 paired).
template <int FAMILY, bool SCORED, bool DELAY>
__host__ __device__ constexpr uint64_t staged_slots() {
  constexpr bool FULL = FAMILY != 0, PAIRED = FAMILY == 2;
  uint64_t m = slot_bit(SL_BACKOFF);
  m |= DELAY ? slot_bit(SL_ARR) : slot_bit(SL_CTRL);
  if (SCORED) {
    m |= slot_bit(SL_TIM) | slot_bit(SL_FD) | slot_bit(SL_INV) |
         slot_bit(SL_BP) | slot_bit(SL_IWS) | slot_bit(SL_STAT);
  }
  if (FULL && SCORED) m |= slot_bit(SL_SAMEIP);
  if (PAIRED) {
    m |= slot_bit(SL_CTRL2) | slot_bit(SL_BACKOFF_B);
    if (SCORED) m |= slot_bit(SL_TIM_B);
  }
  return m;
}

// the bytes a box copies: the tile's row and one 16-byte granule more (a
// box starts on a 16-byte boundary of the operand, at or below the row's
// first element)
__host__ __device__ constexpr int box_bytes(int es) {
  return RECEIVE_TILE * es + 16;
}

// the shared memory a staged row takes: copies land on 128-byte
// boundaries
__host__ __device__ constexpr int row_room(int es) {
  return (box_bytes(es) + 127) / 128 * 128;
}

// A variant's stage, laid out at compile time: each slot of MASK, in slot
// order, rows(s) rows of row_room(es(s)) bytes.
template <uint64_t MASK, int C, int W, bool CBF, bool BBF>
struct Layout {
  __host__ __device__ static constexpr int es(int s) {
    return s == SL_FD || s == SL_INV ? (CBF ? 2 : 4)
           : s == SL_BP              ? (BBF ? 2 : 4)
           : s == SL_SAMEIP || s == SL_ARR || s == SL_STAT ? 4
           : s == SL_CTRL || s == SL_CTRL2 ? 1
                                           : 2;
  }
  // rows staged (a ctrl window has a second row for its wrap piece)
  __host__ __device__ static constexpr int rows(int s) {
    return s == SL_ARR ? C * W : s == SL_CTRL || s == SL_CTRL2 ? 2 * C : C;
  }
  // rows copied every tile (wrap pieces aside)
  __host__ __device__ static constexpr int copies(int s) {
    return s == SL_ARR ? C * W : C;
  }
  __host__ __device__ static constexpr uint32_t off(int s) {
    uint32_t o = 0;
    for (int i = 0; i < s; ++i) {
      if ((MASK >> i) & 1u) o += rows(i) * row_room(es(i));
    }
    return o;
  }
  // the stage without and with the static score term
  static constexpr uint32_t base_bytes = off(SL_STAT);
  static constexpr uint32_t stat_bytes =
      ((MASK >> SL_STAT) & 1u) ? C * row_room(4) : 0;
};

// A launch's staging, built on the host (make_plan) and passed as a
// __grid_constant__ kernel parameter, so the tensor maps stay in
// parameter space where the copies read them.
struct StagePlan {
  CUtensorMap map[N_SLOTS];   // 1-D, box_bytes(es) / es elements a box
  uint64_t present;           // bit s: slot s is staged
  uint32_t stage_bytes;       // the stage (a multiple of 128)
  uint32_t head_bytes;        // the stage's mbarrier and the tally rows
  uint32_t tile_tx;           // bytes of a tile's copies but wrap pieces
  // x / history_length for 0 <= x < 2^31 as (x * div_m) >> (31 + div_l)
  // (div_l = ceil(log2 H), div_m = ceil(2^(31 + div_l) / H): exact), in
  // place of an integer division per serve-ledger row
  uint64_t div_m;
  uint32_t div_l;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)), "r"(tx)
               : "memory");
}

// Wait for the barrier's phase of this parity to complete.  A copy that
// never lands would hold the block forever: after about 2^26 tries (many
// seconds) the kernel traps instead, and the launch reports the fault.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t ready;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ready)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (ready) return;
    if (tries == (1u << 26)) __trap();
  }
}

// one box of the slot's map at coordinate x (on a 16-byte boundary) into
// dst (on a 128-byte boundary), completed on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(smem_addr(bar))
      : "memory");
}

// x rounded down to a 16-byte boundary of elements of es bytes
__device__ __forceinline__ int granule_floor(int x, int es) {
  return x & ~(16 / es - 1);
}

// The first element of edge j's ctrl window: (p0 + o_j) mod N.
__device__ __forceinline__ long long window_start(const ReceiveArgs& a,
                                                  long long p0, int j) {
  long long q0 = p0 + a.offsets[j];
  return q0 >= a.n ? q0 - a.n : q0;
}

// Warp 0 stages tile p0 into st: lane 0 arms the stage's barrier with the
// tile's bytes, then the lanes issue the copies, row r of slot s by lane
// (s + r) mod 32 (edge j's window and its wrap piece by lane
// (slot + j) mod 32).
template <class L, uint64_t MASK, int C>
__device__ __forceinline__ void stage_tile(const ReceiveArgs& a,
                                           const StagePlan& plan,
                                           uint8_t* st, uint64_t* bar,
                                           long long p0, int rb, int lane) {
  const long long n = a.n;
  const uint64_t present = plan.present & MASK;
  const long long active =
      n - p0 < RECEIVE_TILE ? n - p0 : (long long)RECEIVE_TILE;
  if (lane == 0) {
    uint32_t tx = plan.tile_tx;
#pragma unroll
    for (int s = SL_CTRL; s <= SL_CTRL2; ++s) {
      if (!((present >> s) & 1u)) continue;
      for (int j = 0; j < C; ++j) {
        if (window_start(a, p0, j) + active > n) tx += box_bytes(1);
      }
    }
    mbar_expect_tx(bar, tx);
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < N_SLOTS; ++s) {
    if (!((MASK >> s) & 1u) || !((present >> s) & 1u)) continue;
    const int room = row_room(L::es(s));
    if (s == SL_CTRL || s == SL_CTRL2) {
      for (int j = (lane - s) & 31; j < C; j += 32) {
        const long long q0 = window_start(a, p0, j);
        const int x = (int)((long long)(rb * C + a.cinv[j]) * n + q0);
        tma_load(st + L::off(s) + j * room, &plan.map[s],
                 granule_floor(x, 1), bar);
        if (q0 + active > n) {
          tma_load(st + L::off(s) + (C + j) * room, &plan.map[s],
                   granule_floor(x - (int)n, 1), bar);
        }
      }
    } else {
      for (int r = (lane - s) & 31; r < L::copies(s); r += 32) {
        tma_load(st + L::off(s) + r * room, &plan.map[s],
                 granule_floor((int)((rb * L::copies(s) + r) * n + p0),
                               L::es(s)),
                 bar);
      }
    }
  }
}

// A thread's view of its peer's staged operands in one stage: element t
// of row r of slot s sits ``lead`` bytes into the row's box, the bytes
// between the 16-byte boundary the copy started at and the row's first
// element: (r * N * es) mod 16, the same for every tile (p0 is a multiple
// of 16 elements, each operand 16-byte aligned).  In a replica stack the
// replica's first row adds rep * copies(s) * N * es bytes, a multiple of
// 16 (every staged row slot has copies(s) * es >= 16: C >= 8 rows of 2 or
// 4 bytes), so the lead is the same in every replica.
template <class L>
struct Staged {
  const uint8_t* st;
  long long n;
  int t;
  int rep;      // the tile's replica (the body's rows: rep * R + r)
  uint64_t div_m;
  uint32_t div_l;

  // floor(x / history_length) (the reference's floor division)
  __device__ __forceinline__ int floordiv_h(int x, int h) const {
    if (x >= 0) return (int)(((uint64_t)x * div_m) >> (31 + div_l));
    return floordiv(x, h);
  }

  __device__ __forceinline__ const uint8_t* row(int s, int r) const {
    const int lead = (r * (int)(n & 15) * L::es(s)) & 15;
    return st + L::off(s) + r * row_room(L::es(s)) + lead;
  }
  template <class T>
  __device__ __forceinline__ T at(int s, int r) const {
    return reinterpret_cast<const T*>(row(s, r))[t];
  }
  __device__ __forceinline__ uint32_t word(int s, int r) const {
    return at<uint32_t>(s, r);
  }
  __device__ __forceinline__ int i16(int s, int r) const {
    return at<int16_t>(s, r);
  }
  // edge j's ctrl byte: byte t of its window, whose first byte has
  // coordinate x, or past N byte t of the wrap piece (at x - N)
  template <int C>
  __device__ __forceinline__ uint32_t ctrl(int s, int j, int x,
                                           bool wrapped) const {
    const uint8_t* w = st + L::off(s) + j * row_room(1);
    return wrapped ? w[C * row_room(1) + ((x - (int)n) & 15) + t]
                   : w[(x & 15) + t];
  }
};

template <bool BF>
__device__ __forceinline__ float load_ctr(const void* row, int t) {
  if constexpr (BF) {
    return __bfloat162float(((const __nv_bfloat16*)row)[t]);
  } else {
    return ((const float*)row)[t];
  }
}

// store in the counter dtype; returns the stored value read back as f32
template <bool BF>
__device__ __forceinline__ float store_ctr(void* p, int i, float x) {
  if constexpr (BF) {
    __nv_bfloat16 b = __float2bfloat16_rn(x);
    ((__nv_bfloat16*)p)[i] = b;
    return __bfloat162float(b);
  } else {
    ((float*)p)[i] = x;
    return x;
  }
}

// decay, then snap below decay_to_zero to 0 (the reference's dk())
__device__ __forceinline__ float decay_keep(float x, float decay, float dtz) {
  x = __fmul_rn(x, decay);
  return x < dtz ? 0.0f : x;
}

// (KNB) a knob's value from the vector, else the baked launch argument
// it replaces; each read where its value is consumed, after the edge
// loop, so the baked kernels' code stays as it was and the knob reads hold
// no register through the loop
template <bool KNB>
__device__ __forceinline__ float knob(const ReceiveArgs& a, int rb, int i,
                                      float baked) {
  if constexpr (KNB) {
    return a.knobs[rb * a.knob_stride + i];
  } else {
    return baked;
  }
}

// the backoff restart: backoff_ticks - 1 (exact through the f32 carry)
template <bool KNB>
__device__ __forceinline__ int restart_ticks(const ReceiveArgs& a, int rb) {
  if constexpr (KNB) {
    return (int)a.knobs[rb * a.knob_stride + KNOB_BT] - 1;
  } else {
    return a.backoff_restart;
  }
}

// the P4 term's weight: with knobs the f32 product of the rounded topic
// weight and the knob, as the reference forms it for a traced weight;
// baked, the f32 rounding of the double product (ScoreConsts.c_inv)
template <bool KNB>
__device__ __forceinline__ float p4_weight(const ReceiveArgs& a, int rb) {
  if constexpr (KNB) {
    return __fmul_rn(a.topic_weight,
                     a.knobs[rb * a.knob_stride + KNOB_INVW]);
  } else {
    return a.c_inv;
  }
}

// One thread per peer of the tile at p0, its receiver operands read from
// the stage ``in`` (receive_tiles).  (TEL) the thread's tally rows go to
// s_rows[r * RECEIVE_THREADS + t] and its delivered acquisitions to
// s_dlv[w * RECEIVE_THREADS + t], both in shared memory, before stage 2.
template <int C, int W, bool SCORED, bool ATK, bool CBF, bool BBF,
          bool FLOOD, bool EXACTK, bool PX, bool SAMEIP, bool PAIRED,
          bool FAULTS, bool TEL, bool KNB, bool DELAY, bool REPS, class S>
__device__ __forceinline__ void receive_body(const ReceiveArgs& a,
                                             const S& in, long long p0,
                                             int* s_rows, uint32_t* s_dlv) {
  static_assert(SCORED || !ATK, "the attack options need scoring");
  static_assert(ATK || !(FLOOD || SAMEIP),
                "flood publishing and the shared-IP gater ride the attack "
                "variant's stage 1 and need scoring");
  static_assert(!DELAY || !(FAULTS || TEL || PAIRED),
                "the delay mode takes no fault, telemetry or slot-B "
                "operands");
  constexpr bool FULL = FLOOD || EXACTK || PX || SAMEIP;
  // 32-bit indices: make_plan refuses a launch whose rows reach 2^31
  const int t = in.t;
  const int n = (int)a.n;
  const int p = (int)p0 + t;
  if (p >= n) return;
  // (REPS) the tile's replica: its [R, N] operands' rows start at row
  // rb * R, element o1 * R; one sim's kernels fold both to 0
  const int rb = REPS ? in.rep : 0;
  const int o1 = REPS ? rb * n : 0;
  constexpr uint32_t ALL = (C == 32) ? 0xFFFFFFFFu : ((1u << C) - 1u);
  // the sender streams, read from device memory over open edges (the
  // replica's rows, from element o1 * W: its senders are its own peers;
  // an index offset, so the launch arguments stay the base pointers)
  const uint32_t* __restrict__ fresh = a.fresh;
  const uint32_t* __restrict__ adv = a.adv;
  const uint32_t* __restrict__ fresh_b = a.fresh_b;
  const uint32_t* __restrict__ inj_send = a.inj_send;

  uint32_t seen[W], heard[W], valid[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    seen[w] = __ldg(&a.seen[o1 * W + w * n + p]);
    heard[w] = 0u;
    valid[w] = SCORED ? __ldg(&a.valid[rb * W + w]) : 0xFFFFFFFFu;
  }
  // unscored: every sender's payload and advert pass (no gates; DELAY:
  // the step applied them)
  const uint32_t pay = (SCORED && !DELAY) ? __ldg(&a.pay[o1 + p]) : ALL;
  const uint32_t gsp = (SCORED && !DELAY) ? __ldg(&a.gsp[o1 + p]) : ALL;
  // (ATK) the sybil word; the receiver lacks some possible id
  // (FULL: no sybil word without an attack option)
  const uint32_t syb =
      (ATK && (!FULL || a.syb != nullptr)) ? __ldg(&a.syb[o1 + p]) : 0u;
  const bool track = ATK && a.track_promises != 0;
  const bool adv_all = ATK && a.iwant_spam != 0;
  const bool flood_rx = adv_all && syb != 0u;
  uint32_t lacked = 0u;
  if constexpr (ATK) {
#pragma unroll
    for (int w = 0; w < W; ++w) lacked |= (~seen[w] != 0u) ? 1u : 0u;
  }
  // (FAULTS) the receiver's alive word, all-ones or 0 at a down peer;
  // under the IWANT flood, the edges a flood may cross
  const uint32_t alive = FAULTS ? __ldg(&a.alive_w[o1 + p]) : 0xFFFFFFFFu;
  const uint32_t fok = (FAULTS && flood_rx) ? __ldg(&a.flood_ok[o1 + p]) : ALL;

  // ---- stage 1: the C receiving edges
  // (TEL) the tally rows of this peer's edges
  int tr[TEL_ROWS] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t graft_recv = 0u, prune_recv = 0u, a_recv = 0u, broken = 0u;
  // (PAIRED) slot B's GRAFT, PRUNE and A received
  uint32_t graft_b = 0u, prune_b = 0u, a_b = 0u;
  int fdc[C], ivc[C];
  if constexpr (DELAY) {
    // this tick's arrivals: per edge the news and (scored) its valid and
    // invalid counts; the handshake words as the step resolved them
#pragma unroll
    for (int j = 0; j < C; ++j) {
      int fd_j = 0, iv_j = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t news = in.word(SL_ARR, j * W + w) & ~seen[w];
        heard[w] |= news;
        if constexpr (SCORED) {
          fd_j += __popc(news & valid[w]);
          iv_j += __popc(news & ~valid[w]);
        }
      }
      fdc[j] = fd_j;
      ivc[j] = iv_j;
    }
    graft_recv = __ldg(&a.graft_arr[o1 + p]);
    prune_recv = __ldg(&a.prune_arr[o1 + p]);
    if constexpr (ATK) {
      if (track) broken = __ldg(&a.cheat_arr[o1 + p]) & (lacked != 0u ? ~0u : 0u);
    }
  }
  // the sender edges (none in delay mode)
  constexpr int C_SEND = DELAY ? 0 : C;
#pragma unroll
  for (int j = 0; j < C_SEND; ++j) {
    int q = p + a.offsets[j];
    if (q >= n) q -= n;
    // past N the window wrapped: the byte sits in the wrap piece
    const int q0 = (int)window_start(a, p0, j);
    const bool wrapped = q < q0;
    // (the replica's row: the byte's 16-byte lead counts from it)
    const int xw = (rb * C + a.cinv[j]) * n + q0;
    const uint32_t ctl = in.template ctrl<C>(SL_CTRL, j, xw, wrapped);
    uint32_t ctl2 = 0u;
    if constexpr (PAIRED) {
      ctl2 = in.template ctrl<C>(SL_CTRL2, j, xw, wrapped);
      // GRAFT, PRUNE, A of each byte as bits 0..2; on an odd edge the
      // sender's slot A is this peer's slot B (odd_mask is a launch
      // argument: the same choice in every thread)
      uint32_t hs = (ctl >> CTRL_GRAFT) & 7u;
      uint32_t hs2 = (ctl2 >> CTRL2_GRAFT_B) & 7u;
      if ((a.odd_mask >> j) & 1u) {
        const uint32_t tmp = hs;
        hs = hs2;
        hs2 = tmp;
      }
      graft_recv |= (hs & 1u) << j;
      prune_recv |= ((hs >> 1) & 1u) << j;
      a_recv |= ((hs >> 2) & 1u) << j;
      graft_b |= (hs2 & 1u) << j;
      prune_b |= ((hs2 >> 1) & 1u) << j;
      a_b |= ((hs2 >> 2) & 1u) << j;
    } else {
      graft_recv |= ((ctl >> CTRL_GRAFT) & 1u) << j;
      prune_recv |= ((ctl >> CTRL_DROP) & 1u) << j;
      a_recv |= ((ctl >> CTRL_A) & 1u) << j;
    }
    const uint32_t ok_p = (pay >> j) & 1u;
    const uint32_t ok_g = ok_p & ((gsp >> j) & 1u);
    const bool fwd_on = ((ctl >> CTRL_OUT) & ok_p & 1u) != 0u;
    const bool gsp_on = ((ctl >> CTRL_TGT) & ok_g & 1u) != 0u;
    // (PAIRED) the sender forwards its slot-B words over this edge and
    // the receiver's payload gate is open
    const bool fb_on = PAIRED && ((ctl2 >> CTRL2_OUT_B) & ok_p & 1u) != 0u;
    // (TEL) the sender targeted this edge with an IHAVE; the ids this
    // peer lacks of it, and whether its advert words are nonempty
    const bool adv_on = TEL && ((ctl >> CTRL_ADV) & 1u) != 0u;
    int req_c = 0;
    bool adv_nz = false;
    int fd_j = 0, iv_j = 0;
    if constexpr (ATK) {
      // one read of the sender's advert words serves the gossip news
      // and, under the IWANT flood, the window count (read whatever the
      // gates say)
      int pa = 0;
      bool any_on = fwd_on || gsp_on || adv_all;
      // (FLOOD) the sender flood-publishes over this edge and the
      // receiver's payload gate is open
      bool fl_on = false;
      if constexpr (FLOOD) {
        fl_on = a.flood_publish != 0 &&
                ((ctl >> CTRL_FLOOD) & ok_p & 1u) != 0u;
        any_on = any_on || fl_on;
      }
      if constexpr (PAIRED) any_on = any_on || fb_on;
      if constexpr (TEL) any_on = any_on || adv_on;
      if (any_on) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t got = fwd_on ? __ldg(&fresh[o1 * W + w * n + q]) : 0u;
          if constexpr (PAIRED) {
            if (fb_on) got |= __ldg(&fresh_b[o1 * W + w * n + q]);
          }
          if constexpr (FLOOD) {
            if (fl_on) got |= __ldg(&inj_send[o1 * W + w * n + q]);
          }
          const uint32_t fwd_q = got;
          const uint32_t adv_q =
              (gsp_on || adv_all || adv_on) ? __ldg(&adv[o1 * W + w * n + q]) : 0u;
          if (gsp_on) got |= adv_q;
          if constexpr (FAULTS) got &= alive;   // a down peer hears 0
          if constexpr (TEL) {
            const uint32_t adv_w = adv_on ? adv_q : 0u;
            tr[TEL_PAYLOAD] += __popc(fwd_q);
            tr[TEL_IHAVE_IDS] += __popc(adv_w);
            tr[TEL_IWANT_SERVED] += __popc((gsp_on ? adv_q : 0u) & alive &
                                           ~seen[w]);
            tr[TEL_RECV] += __popc(got);
            req_c += __popc(adv_w & alive & ~seen[w]);
            adv_nz = adv_nz || adv_q != 0u;
          }
          const uint32_t news = got & ~seen[w];
          heard[w] |= news;
          fd_j += __popc(news & valid[w]);
          iv_j += __popc(news & ~valid[w]);
          pa += __popc(adv_q);
        }
      }
      if (track) {
        broken |= ((ctl >> CTRL_ADV) & ~(ctl >> CTRL_TGT) & ok_g & lacked &
                   1u) << j;
      }
      // this edge's serve ledger (row j), written here so no per-edge
      // window count stays live: a sybil receiver's pull is the
      // partner's whole window while the ledger before decay is under
      // gossip_retransmission windows
      const int s = in.i16(SL_IWS, j);
      const int H = a.history_length;
      int pull = fd_j + iv_j;
      if (flood_rx) pull = (s < a.retransmission * pa && pa > 0) ? pa : 0;
      // (FAULTS) no flood over a faulted edge: a dead sybil requests
      // nothing, a dead or cut-off partner serves nothing
      if (FAULTS && flood_rx && !((fok >> j) & 1u)) pull = 0;
      int srv = s - in.floordiv_h(s + (H - 1), H) + pull;
      srv = srv < 0 ? 0 : (srv > 30000 ? 30000 : srv);
      a.iws_out[o1 * C + j * n + p] = (int16_t)srv;
    } else {
      if (fwd_on || gsp_on || fb_on || adv_on) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t got = 0u;
          if (fwd_on) got |= __ldg(&fresh[o1 * W + w * n + q]);
          if constexpr (PAIRED) {
            if (fb_on) got |= __ldg(&fresh_b[o1 * W + w * n + q]);
          }
          if constexpr (TEL) {
            const uint32_t fwd_q = got;
            const uint32_t adv_q =
                (gsp_on || adv_on) ? __ldg(&adv[o1 * W + w * n + q]) : 0u;
            if (gsp_on) got |= adv_q;
            if constexpr (FAULTS) got &= alive;   // a down peer hears 0
            const uint32_t adv_w = adv_on ? adv_q : 0u;
            tr[TEL_PAYLOAD] += __popc(fwd_q);
            tr[TEL_IHAVE_IDS] += __popc(adv_w);
            tr[TEL_IWANT_SERVED] += __popc((gsp_on ? adv_q : 0u) & alive &
                                           ~seen[w]);
            tr[TEL_RECV] += __popc(got);
            req_c += __popc(adv_w & alive & ~seen[w]);
            adv_nz = adv_nz || adv_q != 0u;
          } else {
            if (gsp_on) got |= __ldg(&adv[o1 * W + w * n + q]);
            if constexpr (FAULTS) got &= alive;   // a down peer hears 0
          }
          const uint32_t news = got & ~seen[w];
          heard[w] |= news;
          if constexpr (SCORED) {
            fd_j += __popc(news & valid[w]);
            iv_j += __popc(news & ~valid[w]);
          }
        }
      }
    }
    fdc[j] = fd_j;
    ivc[j] = iv_j;
    if constexpr (TEL) {
      // one IHAVE RPC per targeted edge with a nonempty advert, one
      // IWANT RPC per edge with a lacked id
      tr[TEL_IWANT_REQ] += req_c;
      tr[TEL_IHAVE_RPCS] += (adv_on && adv_nz) ? 1 : 0;
      tr[TEL_IWANT_RPCS] += req_c > 0 ? 1 : 0;
    }
  }

  // (FAULTS) a down receiver processes no inbound control and records
  // no broken promise (the senders' masks rode the ctrl bytes)
  if constexpr (FAULTS) {
    graft_recv &= alive;
    prune_recv &= alive;
    a_recv &= alive;
    broken &= alive;
    graft_b &= alive;
    prune_b &= alive;
    a_b &= alive;
  }

  // ---- handshake resolution
  uint32_t viol = 0u, viol_b = 0u;
  if constexpr (SCORED) {
    // (DELAY: the step gated the arrivals)
    const uint32_t accb = DELAY ? ALL : __ldg(&a.acc[o1 + p]);
    graft_recv &= accb;
    prune_recv &= accb;
    viol = graft_recv & __ldg(&a.bo2[o1 + p]);
    if constexpr (PAIRED) {
      graft_b &= accb;
      prune_b &= accb;
      viol_b = graft_b & __ldg(&a.bo2_b[o1 + p]);
    }
  }
  const uint32_t accept = graft_recv & __ldg(&a.wa[o1 + p]);
  // (DELAY) the retractions the step resolved: delayed rejections
  // arriving, immediate ones and failed sends
  const uint32_t retract =
      DELAY ? __ldg(&a.retract_in[o1 + p]) : (__ldg(&a.grafts[o1 + p]) & ~a_recv);
  const uint32_t mesh =
      ((__ldg(&a.meshsel[o1 + p]) | accept) & ~prune_recv) & ~retract;
  a.mesh[o1 + p] = mesh;
  const uint32_t bo_trig = __ldg(&a.dropped[o1 + p]) | prune_recv | retract;
  // (PAIRED) slot B's handshake, mesh and backoff triggers
  uint32_t mesh_b = 0u, bo_trig_b = 0u, px_b = 0u;
  if constexpr (PAIRED) {
    const uint32_t accept_b = graft_b & __ldg(&a.wa_b[o1 + p]);
    const uint32_t retract_b = __ldg(&a.grafts_b[o1 + p]) & ~a_b;
    mesh_b = ((__ldg(&a.meshsel_b[o1 + p]) | accept_b) & ~prune_b) & ~retract_b;
    a.mesh_b_out[o1 + p] = mesh_b;
    bo_trig_b = __ldg(&a.dropped_b[o1 + p]) | prune_b | retract_b;
    px_b = prune_b | retract_b;
  }
  if constexpr (PX) {
    if (a.px_rot != nullptr) a.px_rot[o1 + p] = prune_recv | retract | px_b;
  }
  const uint32_t sub_all = __ldg(&a.sub_all[o1 + p]);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a.acq[o1 * W + w * n + p] =
        (sub_all != 0u ? heard[w] : 0u) | __ldg(&a.inj[o1 * W + w * n + p]);
  }
  if constexpr (TEL) {
    // the new acquisitions (injected publishes are no received copy)
    // and, with latency buckets, the delivered acquisitions; handed to
    // the kernel through shared memory so no tally stays live below
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t h = sub_all != 0u ? heard[w] : 0u;
      tr[TEL_NEW_IDS] += __popc(h);
      s_dlv[w * RECEIVE_THREADS + t] =
          a.tel_lat_buckets > 0
              ? (h | __ldg(&a.inj[o1 * W + w * n + p])) &
                    __ldg(&a.dlv_eff[o1 * W + w * n + p])
              : 0u;
    }
#pragma unroll
    for (int r = 0; r < TEL_ROWS; ++r) {
      s_rows[r * RECEIVE_THREADS + t] = tr[r];
    }
  }

  // ---- per row: backoff; scored: time in mesh, counters, serve
  // ledger, score.  (KNB) the backoff restart and (scored) the P4
  // product, the P7 weight and the two thresholds from the knob vector
  // (knob, restart_ticks, p4_weight: read where consumed)
  const float dtz = a.decay_to_zero;
  const int H = a.history_length;
  // (REPS) the replica's lane seeds, read once
  const uint32_t seed_gater = REPS ? seed_of(a, rb, 0) : a.seed_gater;
  uint32_t bo_gate = 0u, accept_g = 0u, gossip_g = 0u, pub_g = 0u,
           nonneg_g = 0u, gater = 0u, bo_gate_b = 0u;
  float inv_tot = 0.0f, del_tot = 0.0f;
  // (SAMEIP) the stored counters, kept for the sibling sums
  float fd_keep[SAMEIP ? C : 1], inv_keep[SAMEIP ? C : 1];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int idx = o1 * C + c * n + p;
    const int bo = in.i16(SL_BACKOFF, c);
    const int bo_new = ((bo_trig >> c) & 1u) ? restart_ticks<KNB>(a, rb)
                                             : (bo - 1 > 0 ? bo - 1 : 0);
    a.backoff_out[idx] = (int16_t)bo_new;
    bo_gate |= (uint32_t)(bo_new > 0) << c;
    // (PAIRED) slot B's row c in the same iteration; scored, its time in
    // mesh for the P1 term below
    int tim_b_new = 0;
    if constexpr (PAIRED) {
      const int bob = in.i16(SL_BACKOFF_B, c);
      const int bob_new = ((bo_trig_b >> c) & 1u)
                              ? restart_ticks<KNB>(a, rb)
                              : (bob - 1 > 0 ? bob - 1 : 0);
      a.backoff_b_out[idx] = (int16_t)bob_new;
      bo_gate_b |= (uint32_t)(bob_new > 0) << c;
      if constexpr (SCORED) {
        const int tb = in.i16(SL_TIM_B, c);
        tim_b_new = ((mesh_b >> c) & 1u) ? (tb + 1 < 32766 ? tb + 1 : 32766)
                                         : 0;
        a.tim_b_out[idx] = (int16_t)tim_b_new;
      }
    }
    if constexpr (!SCORED) continue;

    const int tim = in.i16(SL_TIM, c);
    const int tim_new = ((mesh >> c) & 1u) ? (tim + 1 < 32766 ? tim + 1
                                                               : 32766)
                                           : 0;
    a.tim_out[idx] = (int16_t)tim_new;

    float fdv =
        __fadd_rn(load_ctr<CBF>(in.row(SL_FD, c), t), (float)fdc[c]);
    fdv = fminf(fdv, a.fd_cap);
    const float fd_n = store_ctr<CBF>(a.fd_out, idx,
                                      decay_keep(fdv, a.fd_decay, dtz));
    const float invv =
        __fadd_rn(load_ctr<CBF>(in.row(SL_INV, c), t), (float)ivc[c]);
    const float inv_n = store_ctr<CBF>(a.inv_out, idx,
                                       decay_keep(invv, a.inv_decay, dtz));
    float bpv = __fadd_rn(load_ctr<BBF>(in.row(SL_BP, c), t),
                          (float)((viol >> c) & 1u));
    if constexpr (PAIRED) bpv = __fadd_rn(bpv, (float)((viol_b >> c) & 1u));
    if constexpr (ATK) {
      if (track) bpv = __fadd_rn(bpv, (float)((broken >> c) & 1u));
    }
    const float bp_n = store_ctr<BBF>(a.bp_out, idx,
                                      decay_keep(bpv, a.bp_decay, dtz));

    if constexpr (!ATK || DELAY) {   // (ATK: written in stage 1)
      const int s = in.i16(SL_IWS, c);
      int srv = s - in.floordiv_h(s + (H - 1), H) + fdc[c] + ivc[c];
      srv = srv < 0 ? 0 : (srv > 30000 ? 30000 : srv);
      a.iws_out[idx] = (int16_t)srv;
    }

    // the peer-score formula on the stored counters, reference op order
    const float tq = fminf(__fdiv_rn((float)tim_new, a.tim_quantum),
                           a.tim_cap);
    float topic = __fadd_rn(
        __fadd_rn(__fmul_rn(a.c_tim, tq), __fmul_rn(a.c_fd, fd_n)),
        __fmul_rn(__fmul_rn(p4_weight<KNB>(a, rb), inv_n), inv_n));
    if constexpr (PAIRED) {   // slot B's P1, before the cap
      const float tqb = fminf(__fdiv_rn((float)tim_b_new, a.tim_quantum),
                              a.tim_cap);
      topic = __fadd_rn(topic, __fmul_rn(a.c_tim, tqb));
    }
    if (a.has_topic_cap) topic = fminf(topic, a.topic_cap);
    const float bp_ex = fmaxf(0.0f, __fsub_rn(bp_n, a.bp_thr));
    if (a.stat != nullptr) {
      topic = __fadd_rn(topic, in.template at<float>(SL_STAT, c));
    }
    const float score =
        __fadd_rn(topic, __fmul_rn(__fmul_rn(knob<KNB>(a, rb, KNOB_BPW, a.w_bp),
                                             bp_ex), bp_ex));
    accept_g |= (uint32_t)(score >= knob<KNB>(a, rb, KNOB_GRAY, a.gray_thr))
                << c;
    gossip_g |= (uint32_t)(score >= knob<KNB>(a, rb, KNOB_GSP, a.gossip_thr))
                << c;
    pub_g |= (uint32_t)(score >= a.publish_thr) << c;
    nonneg_g |= (uint32_t)(score >= 0.0f) << c;

    // RED gater draw; the pressure sums run in c order
    inv_tot = __fadd_rn(inv_tot, inv_n);
    del_tot = __fadd_rn(del_tot, fd_n);
    if constexpr (SAMEIP) {   // drawn below, from the sibling sums
      fd_keep[c] = fd_n;
      inv_keep[c] = inv_n;
    } else {
      const float one_fd = __fadd_rn(1.0f, fd_n);
      const float goodput =
          __fdiv_rn(one_fd, __fadd_rn(one_fd, __fmul_rn(16.0f, inv_n)));
      gater |= (uint32_t)(lane_u(seed_gater, c, p, a.stride) < goodput)
               << c;
    }
  }
  if constexpr (SAMEIP) {
    // the gater's statistics keyed by source IP: edge c's goodput from
    // the sums over the candidates cc whose sibling word carries bit c,
    // added in cc order from 0.0 (no reassociation); per edge where no
    // address is shared
    const bool grouped = a.same_ip != nullptr;
    uint32_t sib[C];
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      sib[cc] = grouped ? in.word(SL_SAMEIP, cc) : 0u;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float fd_g = fd_keep[c], inv_g = inv_keep[c];
      if (grouped) {
        fd_g = 0.0f;
        inv_g = 0.0f;
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const bool on = ((sib[cc] >> c) & 1u) != 0u;
          inv_g = __fadd_rn(inv_g, on ? inv_keep[cc] : 0.0f);
          fd_g = __fadd_rn(fd_g, on ? fd_keep[cc] : 0.0f);
        }
      }
      const float one_fd = __fadd_rn(1.0f, fd_g);
      const float goodput =
          __fdiv_rn(one_fd, __fadd_rn(one_fd, __fmul_rn(16.0f, inv_g)));
      gater |= (uint32_t)(lane_u(seed_gater, c, p, a.stride) < goodput)
               << c;
    }
  }
  if constexpr (SCORED) {
    const float inv16 = __fmul_rn(16.0f, inv_tot);
    const float pressure =
        __fdiv_rn(inv16, __fadd_rn(__fadd_rn(1.0f, del_tot), inv16));
    if (!(pressure > 0.33f)) gater |= ALL;
  }

  // next tick's gossip targets (scored: above the gossip threshold;
  // PAIRED: one selection for both slots, outside either mesh):
  // Bernoulli(k/|elig|), or (EXACTK) the exact uniform k-subset
  const uint32_t cand_sub = __ldg(&a.cand_sub[o1 + p]);
  uint32_t elig = cand_sub & ~mesh & ~__ldg(&a.fanout[o1 + p]) & sub_all;
  if constexpr (PAIRED) elig &= ~mesh_b;
  if constexpr (SCORED) elig &= gossip_g;
  const int n_el = __popc(elig);
  const uint32_t seed_targets = REPS ? seed_of(a, rb, 1) : a.seed_targets;
  // (KNB) gossip_factor and d_lazy from the knob vector
  const int n_fac = (int)__fmul_rn(knob<KNB>(a, rb, KNOB_GF, a.gossip_factor),
                                   (float)n_el);
  const int d_lazy = KNB ? (int)knob<KNB>(a, rb, KNOB_DLAZY, 0.0f) : a.d_lazy;
  const int n_go = d_lazy > n_fac ? d_lazy : n_fac;
  uint32_t tgt = 0u;
  bool exact = false;
  if constexpr (EXACTK) {
    exact = a.exact_k != 0;
    if (exact) {
      tgt = gossip::select_k<C>(elig, C, n_go, seed_targets, p, a.stride);
    }
  }
  if (!exact) {
    const float p_g =
        fminf(1.0f, __fdiv_rn((float)n_go, (float)(n_el > 1 ? n_el : 1)));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tgt |= (uint32_t)(lane_u(seed_targets, c, p, a.stride) < p_g) << c;
    }
  }

  // the gate rows: gate g of replica rb at row g * reps + rb (each gate a
  // contiguous [reps, N] block, as the step carries it)
  const int gn = (REPS && a.reps > 1) ? a.reps * n : n;
  uint32_t* __restrict__ gates = a.gates;
  if constexpr (SCORED) {
    gates[o1 + 0 * gn + p] = accept_g;
    gates[o1 + 1 * gn + p] = gossip_g;
    gates[o1 + 2 * gn + p] = pub_g;
    gates[o1 + 3 * gn + p] = nonneg_g;
    gates[o1 + 4 * gn + p] = accept_g & gater;
    uint32_t tgt_row = elig & tgt;
    if constexpr (ATK) {
      if (a.ihave_spam) tgt_row = (tgt_row & ~syb) | (cand_sub & syb);
    }
    gates[o1 + 5 * gn + p] = tgt_row;
    gates[o1 + 6 * gn + p] = bo_gate;
    if constexpr (PAIRED) gates[o1 + 7 * gn + p] = bo_gate_b;
  } else {
    gates[o1 + 0 * gn + p] = elig & tgt;
    gates[o1 + 1 * gn + p] = bo_gate;
    if constexpr (PAIRED) gates[o1 + 2 * gn + p] = bo_gate_b;
  }
}

// The persistent loop every receive kernel runs.  Block b takes tiles b, b +
// gridDim.x, ... (a static stride: no counter, so a CUDA graph can replay
// the launch); warp 0 stages each tile into the block's one stage, and the
// other blocks of the multiprocessor compute while its copies land.  (A
// second stage, the next tile's copies landing while the block computes this
// one, halves the blocks a multiprocessor holds: the flagship ran 1.014 ms
// with two against 0.556 with one; H100, 700 W; kernel_ab.py, PERF.md.)
// FAMILY (0 the flagship or attack options, 1 full, 2 paired) sets the
// body's option flags as the kernels have them; (TEL) each tile's rows are
// summed into the block's rows in shared memory, added into the tally once
// at the end.
template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
          bool BBF, bool FAULTS, bool TEL, bool KNB, bool DELAY,
          bool REPS = false>
__device__ __forceinline__ void receive_tiles(const ReceiveArgs& a,
                                              const StagePlan& plan) {
  constexpr int T = RECEIVE_TILE, NT = RECEIVE_THREADS;
  constexpr bool FULL = FAMILY != 0;
  constexpr uint64_t MASK = staged_slots<FAMILY, SCORED, DELAY>();
  using L = Layout<MASK, C, W, CBF, BBF>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  int* acc_rows = reinterpret_cast<int*>(base + 16);
  uint8_t* stage = base + plan.head_bytes;
  __shared__ int s_rows[TEL ? TEL_ROWS * NT : 1];
  __shared__ uint32_t s_dlv[TEL ? W * NT : 1];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long n = a.n;
  // tiles over the replicas, each replica's peers in its own tiles
  const long long ntiles_rep = (n + T - 1) / T;
  const long long ntiles =
      REPS ? ntiles_rep * (a.reps > 1 ? a.reps : 1) : ntiles_rep;
  const int rows = TEL_ROWS + (TEL ? a.tel_lat_buckets : 0);
  if (t == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (TEL) {
    for (int r = t; r < rows; r += NT) acc_rows[r] = 0;
  }
  // (TEL && REPS) the replica whose tally the block's rows hold: its tiles
  // run replica by replica, and at each change of replica the rows are
  // added into that replica's tally row block and cleared
  int tel_rb = 0;
  __syncthreads();
  for (long long tile = blockIdx.x, it = 0; tile < ntiles;
       tile += gridDim.x, ++it) {
    const int rb = REPS ? (int)(tile / ntiles_rep) : 0;
    const long long p0 = (tile - rb * ntiles_rep) * T;
    if constexpr (TEL && REPS) {
      // (the last tile's rows are final: its loop ended on a barrier, and
      // the next writes to them come after the barrier below the body)
      if (rb != tel_rb) {
        for (int r = t; r < rows; r += NT) {
          if (acc_rows[r] != 0) {
            atomicAdd(&a.tel[tel_rb * rows + r], acc_rows[r]);
          }
          acc_rows[r] = 0;
        }
        tel_rb = rb;
      }
    }
    if (warp == 0) {
      stage_tile<L, MASK, C>(a, plan, stage, bar, p0, rb, lane);
    }
    mbar_wait(bar, (uint32_t)(it & 1));
    const Staged<L> in{stage, n, t, rb, plan.div_m, plan.div_l};
    if constexpr (TEL) {
#pragma unroll
      for (int r = 0; r < TEL_ROWS; ++r) s_rows[r * NT + t] = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) s_dlv[w * NT + t] = 0u;
    }
    if (t < T) {
      receive_body<C, W, SCORED, FULL ? SCORED : ATK, CBF, BBF,
                   FULL && SCORED, FULL, FULL, FULL && SCORED, FAMILY == 2,
                   FAULTS, TEL, KNB, DELAY, REPS>(a, in, p0, s_rows, s_dlv);
    }
    if constexpr (TEL) {
      __syncthreads();
      // warp k sums rows k, k + 4, ...: the tile's partial of each row
      // (the L latency-bucket rows popcount the delivered acquisitions
      // against the tick's bucket masks)
      for (int r = warp; r < rows; r += NT / 32) {
        int v = 0;
        if (r < TEL_ROWS) {
          for (int i = lane; i < NT; i += 32) v += s_rows[r * NT + i];
        } else {
          const int b = r - TEL_ROWS;
          // (REPS) the replica's [L, W] bucket masks
          const uint32_t* lm =
              a.lat_masks + (REPS ? rb * a.tel_lat_buckets * W : 0);
          for (int i = lane; i < NT; i += 32) {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              v += __popc(s_dlv[w * NT + i] & lm[b * W + w]);
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xFFFFFFFFu, v, off);
        }
        if (lane == 0) acc_rows[r] += v;
      }
    }
    __syncthreads();
  }
  if constexpr (TEL) {
    // (REPS) the last replica's rows, into its row block of the [reps,
    // rows] tally
    const int tel_base = REPS ? tel_rb * rows : 0;
    for (int r = t; r < rows; r += NT) {
      if (acc_rows[r] != 0) atomicAdd(&a.tel[tel_base + r], acc_rows[r]);
    }
  }
}

// ---- the host side: the plan, the grid and the dispatch

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (nothing more
// to link); null where the installed CUDA lacks it
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)f;
  }
  return fn;
}

// The plan of a variant's launch (L its layout, MASK its slots): a map
// of each staged operand (the static score term where it is not null),
// the stage's bytes, the tile's bytes.  Each staged operand must start on
// a 16-byte boundary (the wrapper copies one that does not).  Returns a
// CUDA error code.
template <class L, uint64_t MASK>
int make_plan(const ReceiveArgs& a, StagePlan* plan) {
  // the body's indices and the copies' coordinates are 32-bit: over a
  // replica stack, reps * max(8, C * W) rows of n
  const long long reps = a.reps > 1 ? a.reps : 1;
  if (reps * (L::copies(SL_ARR) > 8 ? L::copies(SL_ARR) : 8) * a.n >=
      (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptr[N_SLOTS] = {
      a.backoff, a.tim, a.fd, a.inv, a.bp, a.iws, a.backoff_b, a.tim_b,
      a.same_ip, a.arr, a.ctrl, a.ctrl2, a.stat};
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  memset(plan, 0, sizeof(*plan));
  uint32_t tx = 0;
  for (int s = 0; s < N_SLOTS; ++s) {
    if (!((MASK >> s) & 1u) || ptr[s] == nullptr) continue;
    if (reinterpret_cast<uintptr_t>(ptr[s]) & 15u) {
      return (int)cudaErrorMisalignedAddress;
    }
    const int es = L::es(s);
    const cuuint64_t dim =
        (cuuint64_t)(s == SL_CTRL || s == SL_CTRL2 ? L::copies(s)
                                                   : L::rows(s)) *
        a.n * reps;
    const cuuint64_t stride = 0;
    const cuuint32_t box = box_bytes(es) / es, estride = 1;
    const CUtensorMapDataType dt =
        es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : es == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT32;
    if (encode(&plan->map[s], dt, 1, const_cast<void*>(ptr[s]), &dim,
               &stride, &box, &estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return (int)cudaErrorInvalidValue;
    }
    plan->present |= slot_bit(s);
    tx += L::copies(s) * box_bytes(es);
  }
  plan->stage_bytes =
      L::base_bytes + (((plan->present >> SL_STAT) & 1u) ? L::stat_bytes : 0);
  const int h = a.history_length > 0 ? a.history_length : 1;
  int l = 0;
  while ((1 << l) < h) ++l;
  plan->div_l = (uint32_t)l;
  plan->div_m = ((1ull << (31 + l)) + (uint64_t)h - 1) / (uint64_t)h;
  plan->head_bytes =
      (16 + 4 * (TEL_ROWS + a.tel_lat_buckets) + 127) & ~127u;
  plan->tile_tx = tx;
  return 0;
}

using ReceiveKernel = void (*)(const ReceiveArgs, const StagePlan);

// the library's last launch: tile, blocks a multiprocessor, dynamic
// shared memory (bytes) and grid (gossip_receive_launch_config)
int last_launch[4] = {0, 0, 0, 0};

// Launch a receive kernel on its persistent grid: as many blocks as fit a
// multiprocessor at the plan's shared memory, on every multiprocessor, at
// most one a tile.  The kernel's dynamic shared memory limit is raised
// once, at its first launch (a table of the kernels seen), and its blocks
// a multiprocessor cached per shared-memory size.
inline int launch_tiles(ReceiveKernel kernel, const ReceiveArgs& a,
                        const StagePlan& plan, cudaStream_t s) {
  constexpr int NT = RECEIVE_THREADS, T = RECEIVE_TILE;
  struct Seen {
    ReceiveKernel kernel;
    int smem, blocks;
  };
  static Seen seen[256];
  static int n_seen = 0, sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int smem = 128 + (int)plan.head_bytes + (int)plan.stage_bytes;
  Seen* e = nullptr;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].kernel == kernel) e = &seen[i];
  }
  if (e == nullptr) {
    if (n_seen == 256) return (int)cudaErrorInvalidValue;
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    cudaFuncAttributes fa;
    cudaFuncGetAttributes(&fa, (const void*)kernel);
    cudaFuncSetAttribute((const void*)kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         optin - (int)fa.sharedSizeBytes);
    e = &seen[n_seen++];
    *e = {kernel, -1, 0};
  }
  if (e->smem != smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&e->blocks,
                                                  (const void*)kernel, NT,
                                                  smem);
    e->smem = smem;
  }
  if (e->blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = (a.n + T - 1) / T * (a.reps > 1 ? a.reps : 1);
  const long long grid = (long long)e->blocks * sms;
  const unsigned blocks = (unsigned)(grid < ntiles ? grid : ntiles);
  kernel<<<blocks, NT, smem, s>>>(a, plan);
  last_launch[0] = T;
  last_launch[1] = e->blocks;
  last_launch[2] = smem;
  last_launch[3] = (int)blocks;
  return (int)cudaGetLastError();
}

// The plan for a variant and its launch.  K's kernels instantiate
// receive_tiles<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS, TEL, ...>.
template <int C, int W, int FAMILY, bool SCORED, bool ATK, bool CBF,
          bool BBF, bool FAULTS, bool TEL, bool DELAY>
int run_tiles(ReceiveKernel kernel, const ReceiveArgs& a, cudaStream_t s) {
  constexpr uint64_t MASK = staged_slots<FAMILY, SCORED, DELAY>();
  StagePlan plan;
  const int err = make_plan<Layout<MASK, C, W, CBF, BBF>, MASK>(a, &plan);
  if (err != 0) return err;
  return launch_tiles(kernel, a, plan, s);
}

// The launch dispatch of every library.  K is the library's launcher:
// K::launch<C, W, FAMILY, SCORED, ATK, CBF, BBF, FAULTS>(a, s) launches
// its __global__ for that variant (FAMILY: 0 the flagship options, ATK
// the attack options; 1 full; 2 paired) through run_tiles and returns
// its error code, so each library instantiates only its own kernels.

// the counter dtypes of a scored launch (unscored ignores them)
template <class K, int C, int W, int FAMILY, bool ATK, bool FAULTS>
int launch_dtypes(const ReceiveArgs& a, int scored, int ctr_bf16,
                  int bp_bf16, cudaStream_t s) {
  auto go = [&](auto sc, auto cbf, auto bbf) {
    constexpr bool SC = decltype(sc)::value, CB = decltype(cbf)::value,
                   BB = decltype(bbf)::value;
    return K::template launch<C, W, FAMILY, SC, ATK && SC, CB, BB, FAULTS>(
        a, s);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (!scored) {
    if (ATK) return (int)cudaErrorInvalidValue;
    return go(F{}, F{}, F{});
  }
  if (ctr_bf16 && bp_bf16) return go(T{}, T{}, T{});
  if (ctr_bf16) return go(T{}, T{}, F{});
  if (!bp_bf16) return go(T{}, F{}, F{});
  return (int)cudaErrorInvalidValue;
}

// args->paired chooses the paired variant, else args->full the full
// variant (the attack and router-surface options then ride their
// runtime flags), else attacks (scored only) the attack variant;
// args->faults launches the chosen variant's faulted kernel
template <class K, int C, int W>
int launch_variant(const ReceiveArgs& a, int scored, int attacks,
                   int ctr_bf16, int bp_bf16, cudaStream_t s) {
  auto family = [&](auto faults) {
    constexpr bool FT = decltype(faults)::value;
    if (a.paired) {
      return launch_dtypes<K, C, W, 2, false, FT>(a, scored, ctr_bf16,
                                                  bp_bf16, s);
    }
    if (a.full) {
      return launch_dtypes<K, C, W, 1, false, FT>(a, scored, ctr_bf16,
                                                  bp_bf16, s);
    }
    if (attacks) {
      return launch_dtypes<K, C, W, 0, true, FT>(a, scored, ctr_bf16,
                                                 bp_bf16, s);
    }
    return launch_dtypes<K, C, W, 0, false, FT>(a, scored, ctr_bf16,
                                                bp_bf16, s);
  };
  return a.faults ? family(std::true_type{}) : family(std::false_type{});
}

// c in {8, 16}, w in {1, 2}; scored (1) or unscored (0); the attack
// variant (1, scored only) or not (0); counter/bp storage bf16 (1) or
// f32 (0).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape with no instantiation (the wrapper
// refuses those first).
template <class K>
int launch_receive(const ReceiveArgs& a, int c, int w, int scored,
                   int attacks, int ctr_bf16, int bp_bf16, cudaStream_t s) {
  if (a.n <= 0) return 0;
  const int k = attacks;
  if (c == 16 && w == 1) return launch_variant<K, 16, 1>(a, scored, k, ctr_bf16, bp_bf16, s);
  if (c == 16 && w == 2) return launch_variant<K, 16, 2>(a, scored, k, ctr_bf16, bp_bf16, s);
  if (c == 8 && w == 1) return launch_variant<K, 8, 1>(a, scored, k, ctr_bf16, bp_bf16, s);
  if (c == 8 && w == 2) return launch_variant<K, 8, 2>(a, scored, k, ctr_bf16, bp_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The last receive launch of this library: out[0] the tile (peers a
// block's step), out[1] the blocks a multiprocessor, out[2] the dynamic
// shared memory (bytes), out[3] the grid.
extern "C" int gossip_receive_launch_config(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = last_launch[i];
  return 0;
}
