// The GossipSub heartbeat's receive half, one thread per peer (Hopper,
// sm_90a).
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
// serve accrual per edge; the senders' masks ride the ctrl bytes).  No
// telemetry, knobs or delays.  Same semantics
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
//     row last (eight rows scored, three unscored).
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
// The unscored tick moves about 140 B/peer at
// W = 1 (ctrl 16, backoff in and out 64, seven [N] words 28, four
// [W, N] words 16, acq 4, mesh 4, two gate rows 8).  The arithmetic (a few hundred integer and
// f32 operations per peer) is far below the card's rate.  Design: each
// thread keeps its per-edge counts and packed words in registers and
// touches every [C, N] row once, at c * N + p, so neighbouring threads
// read neighbouring addresses; the sender's fresh/advert words are read
// only over edges whose gates are open; (ATK) under the IWANT flood its
// advert words over every edge, one read serving both the gossip news
// and the window count, and the ledger is written in stage 1 so no
// per-edge window count stays live in registers; the attack variant is
// its own kernel, held to 64 registers a thread (receive_kernel_attacks).
// The full variant adds, per peer at C = 16 and W = 1, up to 4 B of
// injected words, 64 B of sibling words and the 4 B trigger word; its
// flood read happens only over an edge whose flood bit is set (the
// injected words are zero at almost every sender on almost every tick);
// the shared-IP gater keeps the C stored first- and invalid-delivery
// values and the C sibling words in registers for its C x C masked sums.
// The paired variant adds, per peer at C = 16 and W = 1, the second ctrl
// byte of each edge (16 B), up to 4 B of slot-B sender words, five
// slot-B handshake words in (20 B) and the slot-B mesh out (4 B), the
// slot-B backoff and time-in-mesh rows in and out (128 B) and one gate
// row (4 B); the second ctrl byte is gathered at the same address as the
// first, the slot-B words only over an open edge of the sender's slot-B
// mesh; each row c updates both slots' backoff and time in mesh in the
// same iteration, so no C-wide array of slot B stays live.  Faults add
// the alive word (4 B/peer) and, under the IWANT flood, the flood_ok
// word (4 B/peer); both are read once a thread and applied in registers.
// Staging the sender windows in shared memory is left for later work.
#include <cstdint>
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
  uint32_t* gates;           // [7, N] scored, [2, N] unscored
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
};

namespace {

constexpr int CTRL_OUT = 0, CTRL_TGT = 1, CTRL_GRAFT = 2, CTRL_DROP = 3,
              CTRL_A = 4, CTRL_ADV = 5, CTRL_FLOOD = 6;
// the second ctrl byte (PAIRED); GRAFT, PRUNE and A sit in the same
// order as on the first, so each byte's handshake is one 3-bit field
constexpr int CTRL2_OUT_B = 0, CTRL2_GRAFT_B = 1;

using gossip::lane_u;

template <bool BF>
__device__ __forceinline__ float load_ctr(const void* p, long long i) {
  if constexpr (BF) {
    return __bfloat162float(((const __nv_bfloat16*)p)[i]);
  } else {
    return ((const float*)p)[i];
  }
}

// store in the counter dtype; returns the stored value read back as f32
template <bool BF>
__device__ __forceinline__ float store_ctr(void* p, long long i, float x) {
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

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// One thread per peer; the kernels below instantiate it.
template <int C, int W, bool SCORED, bool ATK, bool CBF, bool BBF,
          bool FLOOD = false, bool EXACTK = false, bool PX = false,
          bool SAMEIP = false, bool PAIRED = false, bool FAULTS = false>
__device__ __forceinline__ void receive_body(const ReceiveArgs& a) {
  static_assert(SCORED || !ATK, "the attack options need scoring");
  static_assert(ATK || !(FLOOD || SAMEIP),
                "flood publishing and the shared-IP gater ride the attack "
                "variant's stage 1 and need scoring");
  constexpr bool FULL = FLOOD || EXACTK || PX || SAMEIP;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = a.n;
  if (p >= n) return;
  constexpr uint32_t ALL = (C == 32) ? 0xFFFFFFFFu : ((1u << C) - 1u);

  uint32_t seen[W], heard[W], valid[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    seen[w] = a.seen[w * n + p];
    heard[w] = 0u;
    valid[w] = SCORED ? a.valid[w] : 0xFFFFFFFFu;
  }
  // unscored: every sender's payload and advert pass (no gates)
  const uint32_t pay = SCORED ? a.pay[p] : ALL;
  const uint32_t gsp = SCORED ? a.gsp[p] : ALL;
  // (ATK) the sybil word; the receiver lacks some possible id
  // (FULL: no sybil word without an attack option)
  const uint32_t syb = (ATK && (!FULL || a.syb != nullptr)) ? a.syb[p] : 0u;
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
  const uint32_t alive = FAULTS ? a.alive_w[p] : 0xFFFFFFFFu;
  const uint32_t fok = (FAULTS && flood_rx) ? a.flood_ok[p] : ALL;

  // ---- stage 1: the C receiving edges
  uint32_t graft_recv = 0u, prune_recv = 0u, a_recv = 0u, broken = 0u;
  // (PAIRED) slot B's GRAFT, PRUNE and A received
  uint32_t graft_b = 0u, prune_b = 0u, a_b = 0u;
  int fdc[C], ivc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    long long q = p + a.offsets[j];
    if (q >= n) q -= n;
    const uint32_t ctl = a.ctrl[(long long)a.cinv[j] * n + q];
    uint32_t ctl2 = 0u;
    if constexpr (PAIRED) {
      ctl2 = a.ctrl2[(long long)a.cinv[j] * n + q];
      // GRAFT, PRUNE, A of each byte as bits 0..2; on an odd edge the
      // sender's slot A is this peer's slot B (odd_mask is a launch
      // argument: the same choice in every thread)
      uint32_t hs = (ctl >> CTRL_GRAFT) & 7u;
      uint32_t hs2 = (ctl2 >> CTRL2_GRAFT_B) & 7u;
      if ((a.odd_mask >> j) & 1u) {
        const uint32_t t = hs;
        hs = hs2;
        hs2 = t;
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
      if (any_on) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t got = fwd_on ? a.fresh[w * n + q] : 0u;
          if constexpr (PAIRED) {
            if (fb_on) got |= a.fresh_b[w * n + q];
          }
          if constexpr (FLOOD) {
            if (fl_on) got |= a.inj_send[w * n + q];
          }
          const uint32_t adv_q = (gsp_on || adv_all) ? a.adv[w * n + q] : 0u;
          if (gsp_on) got |= adv_q;
          if constexpr (FAULTS) got &= alive;   // a down peer hears 0
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
      const long long idx = (long long)j * n + p;
      const int s = a.iws[idx];
      const int H = a.history_length;
      int pull = fd_j + iv_j;
      if (flood_rx) pull = (s < a.retransmission * pa && pa > 0) ? pa : 0;
      // (FAULTS) no flood over a faulted edge: a dead sybil requests
      // nothing, a dead or cut-off partner serves nothing
      if (FAULTS && flood_rx && !((fok >> j) & 1u)) pull = 0;
      int srv = s - floordiv(s + (H - 1), H) + pull;
      srv = srv < 0 ? 0 : (srv > 30000 ? 30000 : srv);
      a.iws_out[idx] = (int16_t)srv;
    } else {
      if (fwd_on || gsp_on || fb_on) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t got = 0u;
          if (fwd_on) got |= a.fresh[w * n + q];
          if constexpr (PAIRED) {
            if (fb_on) got |= a.fresh_b[w * n + q];
          }
          if (gsp_on) got |= a.adv[w * n + q];
          if constexpr (FAULTS) got &= alive;   // a down peer hears 0
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
    const uint32_t accb = a.acc[p];
    graft_recv &= accb;
    prune_recv &= accb;
    viol = graft_recv & a.bo2[p];
    if constexpr (PAIRED) {
      graft_b &= accb;
      prune_b &= accb;
      viol_b = graft_b & a.bo2_b[p];
    }
  }
  const uint32_t accept = graft_recv & a.wa[p];
  const uint32_t retract = a.grafts[p] & ~a_recv;
  const uint32_t mesh = ((a.meshsel[p] | accept) & ~prune_recv) & ~retract;
  a.mesh[p] = mesh;
  const uint32_t bo_trig = a.dropped[p] | prune_recv | retract;
  // (PAIRED) slot B's handshake, mesh and backoff triggers
  uint32_t mesh_b = 0u, bo_trig_b = 0u, px_b = 0u;
  if constexpr (PAIRED) {
    const uint32_t accept_b = graft_b & a.wa_b[p];
    const uint32_t retract_b = a.grafts_b[p] & ~a_b;
    mesh_b = ((a.meshsel_b[p] | accept_b) & ~prune_b) & ~retract_b;
    a.mesh_b_out[p] = mesh_b;
    bo_trig_b = a.dropped_b[p] | prune_b | retract_b;
    px_b = prune_b | retract_b;
  }
  if constexpr (PX) {
    if (a.px_rot != nullptr) a.px_rot[p] = prune_recv | retract | px_b;
  }
  const uint32_t sub_all = a.sub_all[p];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    a.acq[w * n + p] = (sub_all != 0u ? heard[w] : 0u) | a.inj[w * n + p];
  }

  // ---- per row: backoff; scored: time in mesh, counters, serve
  // ledger, score
  const float dtz = a.decay_to_zero;
  const int H = a.history_length;
  uint32_t bo_gate = 0u, accept_g = 0u, gossip_g = 0u, pub_g = 0u,
           nonneg_g = 0u, gater = 0u, bo_gate_b = 0u;
  float inv_tot = 0.0f, del_tot = 0.0f;
  // (SAMEIP) the stored counters, kept for the sibling sums
  float fd_keep[SAMEIP ? C : 1], inv_keep[SAMEIP ? C : 1];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const long long idx = (long long)c * n + p;
    const int bo = a.backoff[idx];
    const int bo_new = ((bo_trig >> c) & 1u) ? a.backoff_restart
                                             : (bo - 1 > 0 ? bo - 1 : 0);
    a.backoff_out[idx] = (int16_t)bo_new;
    bo_gate |= (uint32_t)(bo_new > 0) << c;
    // (PAIRED) slot B's row c in the same iteration; scored, its time in
    // mesh for the P1 term below
    int tim_b_new = 0;
    if constexpr (PAIRED) {
      const int bob = a.backoff_b[idx];
      const int bob_new = ((bo_trig_b >> c) & 1u)
                              ? a.backoff_restart
                              : (bob - 1 > 0 ? bob - 1 : 0);
      a.backoff_b_out[idx] = (int16_t)bob_new;
      bo_gate_b |= (uint32_t)(bob_new > 0) << c;
      if constexpr (SCORED) {
        const int tb = a.tim_b[idx];
        tim_b_new = ((mesh_b >> c) & 1u) ? (tb + 1 < 32766 ? tb + 1 : 32766)
                                         : 0;
        a.tim_b_out[idx] = (int16_t)tim_b_new;
      }
    }
    if constexpr (!SCORED) continue;

    const int tim = a.tim[idx];
    const int tim_new = ((mesh >> c) & 1u) ? (tim + 1 < 32766 ? tim + 1
                                                               : 32766)
                                           : 0;
    a.tim_out[idx] = (int16_t)tim_new;

    float fdv = __fadd_rn(load_ctr<CBF>(a.fd, idx), (float)fdc[c]);
    fdv = fminf(fdv, a.fd_cap);
    const float fd_n = store_ctr<CBF>(a.fd_out, idx,
                                      decay_keep(fdv, a.fd_decay, dtz));
    const float invv = __fadd_rn(load_ctr<CBF>(a.inv, idx), (float)ivc[c]);
    const float inv_n = store_ctr<CBF>(a.inv_out, idx,
                                       decay_keep(invv, a.inv_decay, dtz));
    float bpv = __fadd_rn(load_ctr<BBF>(a.bp, idx),
                          (float)((viol >> c) & 1u));
    if constexpr (PAIRED) bpv = __fadd_rn(bpv, (float)((viol_b >> c) & 1u));
    if constexpr (ATK) {
      if (track) bpv = __fadd_rn(bpv, (float)((broken >> c) & 1u));
    }
    const float bp_n = store_ctr<BBF>(a.bp_out, idx,
                                      decay_keep(bpv, a.bp_decay, dtz));

    if constexpr (!ATK) {   // (ATK: written in stage 1)
      const int s = a.iws[idx];
      int srv = s - floordiv(s + (H - 1), H) + fdc[c] + ivc[c];
      srv = srv < 0 ? 0 : (srv > 30000 ? 30000 : srv);
      a.iws_out[idx] = (int16_t)srv;
    }

    // the peer-score formula on the stored counters, reference op order
    const float tq = fminf(__fdiv_rn((float)tim_new, a.tim_quantum),
                           a.tim_cap);
    float topic = __fadd_rn(
        __fadd_rn(__fmul_rn(a.c_tim, tq), __fmul_rn(a.c_fd, fd_n)),
        __fmul_rn(__fmul_rn(a.c_inv, inv_n), inv_n));
    if constexpr (PAIRED) {   // slot B's P1, before the cap
      const float tqb = fminf(__fdiv_rn((float)tim_b_new, a.tim_quantum),
                              a.tim_cap);
      topic = __fadd_rn(topic, __fmul_rn(a.c_tim, tqb));
    }
    if (a.has_topic_cap) topic = fminf(topic, a.topic_cap);
    const float bp_ex = fmaxf(0.0f, __fsub_rn(bp_n, a.bp_thr));
    if (a.stat != nullptr) topic = __fadd_rn(topic, a.stat[idx]);
    const float score =
        __fadd_rn(topic, __fmul_rn(__fmul_rn(a.w_bp, bp_ex), bp_ex));
    accept_g |= (uint32_t)(score >= a.gray_thr) << c;
    gossip_g |= (uint32_t)(score >= a.gossip_thr) << c;
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
      gater |= (uint32_t)(lane_u(a.seed_gater, c, p, a.stride) < goodput)
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
      sib[cc] = grouped ? a.same_ip[(long long)cc * n + p] : 0u;
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
      gater |= (uint32_t)(lane_u(a.seed_gater, c, p, a.stride) < goodput)
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
  uint32_t elig = a.cand_sub[p] & ~mesh & ~a.fanout[p] & sub_all;
  if constexpr (PAIRED) elig &= ~mesh_b;
  if constexpr (SCORED) elig &= gossip_g;
  const int n_el = __popc(elig);
  const int n_fac = (int)__fmul_rn(a.gossip_factor, (float)n_el);
  const int n_go = a.d_lazy > n_fac ? a.d_lazy : n_fac;
  uint32_t tgt = 0u;
  bool exact = false;
  if constexpr (EXACTK) {
    exact = a.exact_k != 0;
    if (exact) {
      tgt = gossip::select_k<C>(elig, C, n_go, a.seed_targets, p, a.stride);
    }
  }
  if (!exact) {
    const float p_g =
        fminf(1.0f, __fdiv_rn((float)n_go, (float)(n_el > 1 ? n_el : 1)));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      tgt |= (uint32_t)(lane_u(a.seed_targets, c, p, a.stride) < p_g) << c;
    }
  }

  if constexpr (SCORED) {
    a.gates[0 * n + p] = accept_g;
    a.gates[1 * n + p] = gossip_g;
    a.gates[2 * n + p] = pub_g;
    a.gates[3 * n + p] = nonneg_g;
    a.gates[4 * n + p] = accept_g & gater;
    uint32_t tgt_row = elig & tgt;
    if constexpr (ATK) {
      if (a.ihave_spam) tgt_row = (tgt_row & ~syb) | (a.cand_sub[p] & syb);
    }
    a.gates[5 * n + p] = tgt_row;
    a.gates[6 * n + p] = bo_gate;
    if constexpr (PAIRED) a.gates[7 * n + p] = bo_gate_b;
  } else {
    a.gates[0 * n + p] = elig & tgt;
    a.gates[1 * n + p] = bo_gate;
    if constexpr (PAIRED) a.gates[2 * n + p] = bo_gate_b;
  }
}

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

inline unsigned grid_blocks(const ReceiveArgs& a, int threads) {
  return (unsigned)((a.n + threads - 1) / threads);
}

template <int C, int W, bool SCORED, bool CBF, bool BBF, bool FAULTS>
int launch_paired(const ReceiveArgs& a, cudaStream_t s) {
  const int threads = 256;
  if constexpr (FAULTS) {
    receive_kernel_paired_faults<C, W, SCORED, CBF, BBF>
        <<<grid_blocks(a, threads), threads, 0, s>>>(a);
  } else {
    receive_kernel_paired<C, W, SCORED, CBF, BBF>
        <<<grid_blocks(a, threads), threads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int C, int W, bool FAULTS>
int launch_paired_variant(const ReceiveArgs& a, int scored, int ctr_bf16,
                          int bp_bf16, cudaStream_t s) {
  if (!scored) return launch_paired<C, W, false, false, false, FAULTS>(a, s);
  if (ctr_bf16 && bp_bf16) {
    return launch_paired<C, W, true, true, true, FAULTS>(a, s);
  }
  if (ctr_bf16) return launch_paired<C, W, true, true, false, FAULTS>(a, s);
  if (!bp_bf16) return launch_paired<C, W, true, false, false, FAULTS>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <int C, int W, bool SCORED, bool CBF, bool BBF, bool FAULTS>
int launch_full(const ReceiveArgs& a, cudaStream_t s) {
  const int threads = 256;
  if constexpr (FAULTS) {
    receive_kernel_full_faults<C, W, SCORED, CBF, BBF>
        <<<grid_blocks(a, threads), threads, 0, s>>>(a);
  } else {
    receive_kernel_full<C, W, SCORED, CBF, BBF>
        <<<grid_blocks(a, threads), threads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int C, int W, bool FAULTS>
int launch_full_variant(const ReceiveArgs& a, int scored, int ctr_bf16,
                        int bp_bf16, cudaStream_t s) {
  if (!scored) return launch_full<C, W, false, false, false, FAULTS>(a, s);
  if (ctr_bf16 && bp_bf16) {
    return launch_full<C, W, true, true, true, FAULTS>(a, s);
  }
  if (ctr_bf16) return launch_full<C, W, true, true, false, FAULTS>(a, s);
  if (!bp_bf16) return launch_full<C, W, true, false, false, FAULTS>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <int C, int W, bool SCORED, bool ATK, bool CBF, bool BBF,
          bool FAULTS>
int launch(const ReceiveArgs& a, cudaStream_t s) {
  const int threads = 256;
  const unsigned blocks = grid_blocks(a, threads);
  if constexpr (ATK && FAULTS) {
    receive_kernel_attacks_faults<C, W, CBF, BBF><<<blocks, threads, 0, s>>>(a);
  } else if constexpr (ATK) {
    receive_kernel_attacks<C, W, CBF, BBF><<<blocks, threads, 0, s>>>(a);
  } else if constexpr (FAULTS) {
    receive_kernel_faults<C, W, SCORED, CBF, BBF><<<blocks, threads, 0, s>>>(a);
  } else {
    receive_kernel<C, W, SCORED, CBF, BBF><<<blocks, threads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int C, int W, bool ATK, bool FAULTS>
int launch_scored(const ReceiveArgs& a, int ctr_bf16, int bp_bf16,
                  cudaStream_t s) {
  if (ctr_bf16 && bp_bf16) {
    return launch<C, W, true, ATK, true, true, FAULTS>(a, s);
  }
  if (ctr_bf16) return launch<C, W, true, ATK, true, false, FAULTS>(a, s);
  if (!bp_bf16) return launch<C, W, true, ATK, false, false, FAULTS>(a, s);
  return (int)cudaErrorInvalidValue;
}

// scored: 1 (v1.1) or 0 (v1.0: counter dtypes ignored); attacks: 1 for
// the attack variant (scored only)
template <int C, int W, bool FAULTS>
int launch_family(const ReceiveArgs& a, int scored, int attacks,
                  int ctr_bf16, int bp_bf16, cudaStream_t s) {
  if (a.paired) {
    return launch_paired_variant<C, W, FAULTS>(a, scored, ctr_bf16, bp_bf16,
                                               s);
  }
  if (a.full) {
    return launch_full_variant<C, W, FAULTS>(a, scored, ctr_bf16, bp_bf16, s);
  }
  if (!scored) {
    if (attacks) return (int)cudaErrorInvalidValue;
    return launch<C, W, false, false, false, false, FAULTS>(a, s);
  }
  if (attacks) {
    return launch_scored<C, W, true, FAULTS>(a, ctr_bf16, bp_bf16, s);
  }
  return launch_scored<C, W, false, FAULTS>(a, ctr_bf16, bp_bf16, s);
}

template <int C, int W>
int launch_variant(const ReceiveArgs& a, int scored, int attacks,
                   int ctr_bf16, int bp_bf16, cudaStream_t s) {
  if (a.faults) {
    return launch_family<C, W, true>(a, scored, attacks, ctr_bf16, bp_bf16,
                                     s);
  }
  return launch_family<C, W, false>(a, scored, attacks, ctr_bf16, bp_bf16, s);
}

}  // namespace

// c in {8, 16}, w in {1, 2}; scored (1) or unscored (0); the attack
// variant (1, scored only) or not (0); counter/bp storage bf16 (1) or
// f32 (0); args->paired chooses the paired variant, else args->full the
// full variant (the attack and router-surface options then ride their
// runtime flags); args->faults launches the chosen variant's faulted
// kernel.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape with no instantiation (the wrapper
// refuses those first).
extern "C" int gossip_receive_update(const ReceiveArgs* args, int c, int w,
                                     int scored, int attacks, int ctr_bf16,
                                     int bp_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (args->n <= 0) return 0;
  const ReceiveArgs& a = *args;
  const int k = attacks;
  if (c == 16 && w == 1) return launch_variant<16, 1>(a, scored, k, ctr_bf16, bp_bf16, s);
  if (c == 16 && w == 2) return launch_variant<16, 2>(a, scored, k, ctr_bf16, bp_bf16, s);
  if (c == 8 && w == 1) return launch_variant<8, 1>(a, scored, k, ctr_bf16, bp_bf16, s);
  if (c == 8 && w == 2) return launch_variant<8, 2>(a, scored, k, ctr_bf16, bp_bf16, s);
  return (int)cudaErrorInvalidValue;
}
