// The tick-resident fused window: T unscored GossipSub heartbeats in one
// launch (Hopper, sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py,
// _fused_gossip_kernel (built by make_fused_gossip_update), single
// device, without the sharded halo; with or without fault rows (FAULTS)
// and cold restart (COLD), each instantiated in a kernel of its own,
// fused_window_kernel_faults; with or without the per-tick telemetry rows
// (TEL, with_telemetry: fused_window_kernel_tel and
// fused_window_kernel_faults_tel).  It computes what that kernel
// computes, bit-identical to the
// plain version (ops/kernels/fused.py fused_gossip_update_plain): per
// tick, publish injection, fanout TTL and refill, the graft and v1.0
// random-prune selections, the eager/lazy exchange over the C circulant
// edges, the GRAFT/PRUNE/A handshake, the backoff write, the mcache ring
// update and the next tick's targets (Bernoulli, or with EXACTK the
// exact uniform k-subset: the same select_k as the other selections, at
// the targets' lane seed) and backoff gate rows; it emits each tick's
// acquisitions.  Under faults each tick reads the peer's alive word,
// send-ok bits and live-candidate bits of that tick ([T, N] rows, made
// by the window before the launch): a down peer's publish is lost, its
// sends (forwards, adverts, handshake) are cut at their source by the
// send-ok bits, it hears nothing and receives no control; mesh edges to
// or at a dead peer drop with PRUNE and backoff at both ends; nobody
// grafts at or by a dead peer, and dead candidates take no fanout slot.
// With cold restart (COLD) a peer rejoining at tick t has its
// possession words and mcache ring cleared first.  With telemetry (TEL)
// each tick writes its end-of-tick mesh row and its tally: the receive
// kernel's rows (receive_body.cuh, TEL) counted per peer in phase B, the
// L latency-bucket rows of the delivered acquisitions, and the GRAFTs
// and PRUNEs transmitted (under faults & sok & cal, the reference's
// :2132-2139).  On the TPU the tick's rows are one 128-lane block per
// grid step; here each thread sums its peers' rows in registers over the
// grid-stride loop (the latency rows into shared memory by shared
// atomics, only for a peer with a delivered acquisition, so no L
// accumulators stay live), each block reduces its rows by warp shuffles
// and adds them into the tick's tally row with one i32 atomicAdd per
// block and row before the next tick's barrier.  The wrapper zeroes the
// tally on the stream; integer sums are order-free, so it is exact.
//
// Design.  On the TPU the whole ring is one block resident in VMEM and
// the candidate views are whole-ring lane rolls.  Here every tick reads
// every peer's tick-t sender words at offsets up to N, so consecutive
// ticks need a grid-wide barrier: one persistent cooperative launch,
// sized by the occupancy calculator to the blocks that can be resident
// at once, each thread owning a grid-stride set of peers for all T
// ticks.  Per tick:
//
//   phase A: each peer computes its tick front (injection, fanout,
//     selections) from its carry and writes its sender words to a
//     staging buffer in device memory: fresh and advert words [2W, N]
//     and one ctrl byte per sender edge [C, N];
//   grid.sync();
//   phase B: each peer recomputes its front (the carry is unchanged
//     until now, so the same bits), reads its C senders' staged words at
//     (p + o_j) mod N, resolves the exchange and handshake and writes
//     its carry in place.
//
// The staging buffer is double-buffered by t mod 2, so one barrier per
// tick is enough: phase A of tick t + 2 cannot start before every block
// has passed the barrier of tick t + 1, which follows its own phase B of
// tick t.  Staged words are read with ld.global.cg (L2, never a stale
// L1 line of the slot's use two ticks earlier).  The carry (68 B/peer at
// C = 16, W = 1, Hg = 3; 71 MB at 1M peers, more than the 50 MB L2)
// stays in device memory; keeping it in registers or shared memory is
// later work.  Window entry reads the input carry and every tick writes
// the output carry, so inputs are never modified.
//
// Bound on this card: bytes.  Per window, the carry is read and written
// once (2 x 68 B/peer), the static rows read once (12 B/peer at W = 1)
// and per tick the acquisitions written (4W B/peer) and the stage
// written and read once (2 x (C + 8W) B/peer): about 564 B/peer for an
// 8-tick window, 0.59 GB at 1M peers, 0.18 ms at 3.35 TB/s; the fault
// rows add 12 B/peer a tick (16 with cold restart), read by the peer's
// own thread in both phases.  This first
// version also re-reads the carry in both phases of every tick; the
// selections run only where their k is positive (a selection with k = 0
// selects nothing).
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lane.cuh"

namespace cg = cooperative_groups;

constexpr int MAX_WINDOW = 64;  // models/plan.py MAX_WINDOW

struct FusedArgs {
  // static rows
  const uint32_t* sub_all;   // [N] all-ones (C bits) iff subscribed
  const uint32_t* cand_sub;  // [N] subscribed candidates
  const uint32_t* origin;    // [W, N] origin words
  const uint32_t* due;       // [T, W] publish-due words
  // carry in (read at tick 0 only)
  const uint32_t* have_in;   // [W, N]
  const uint32_t* rec_in;    // [Hg * W, N] mcache ring, row h * W + w
  const uint32_t* mesh_in;   // [N]
  const uint32_t* fan_in;    // [N]
  const int32_t* lp_in;      // [N] last publish tick
  const int16_t* bo_in;      // [C, N] remaining backoff ticks
  const uint32_t* tgt_in;    // [N] targets gate row
  const uint32_t* bog_in;    // [N] backoff gate row
  // carry out (the carry from tick 1 on)
  uint32_t* have;
  uint32_t* rec;
  uint32_t* mesh;
  uint32_t* fan;
  int32_t* lp;
  int16_t* bo;
  uint32_t* tgt;
  uint32_t* bog;
  uint32_t* acq;             // [T, W, N] per-tick acquisitions
  // double-buffered staging
  uint8_t* stage_ctrl;       // [2, C, N] sender ctrl bytes
  uint32_t* stage_pay;       // [2, 2W, N] sender fresh + advert words
  // scalars
  long long n;
  int ticks;
  int tick0;
  int hg;                    // history_gossip (ring rows)
  int offsets[16];           // o_j mod N, in [0, N)
  int cinv[16];
  int d, d_lo, d_hi;
  int fanout_ttl;
  int backoff_restart;       // backoff_ticks - 1
  int d_lazy;
  float gossip_factor;
  unsigned int stride;       // lane stream row stride (N)
  // per tick: fanout (phase 4), graft (2), prune (3), next tick's
  // targets (phase 1 at tick + 1) lane seeds
  unsigned int seeds[MAX_WINDOW][4];
  int exact_k;               // exact-k gossip targets (else Bernoulli)
  // the fault rows, last: per tick [T, N] words
  const uint32_t* alive;     // live peer: ~0u, down: 0
  const uint32_t* sok;       // edges a peer may send on
  const uint32_t* cal;       // live candidates
  const uint32_t* rej;       // (cold restart) ~0u at a rejoiner, or null
  int faults;                // launch the faulted kernel
  int cold;                  // ... with cold restart
  // the telemetry rows, after those
  const uint32_t* lat_masks; // [T, L, W] latency-bucket masks (L > 0)
  const uint32_t* dlv;       // [W, N] deliver words (L > 0)
  uint32_t* meshrow;         // [T, N] each tick's end-of-tick mesh
  int* tel;                  // [T, 8 + L + 2] tallies, zeroed by the caller
  int tel_lat_buckets;       // L
  int telemetry;             // launch the telemetry kernel
};

namespace {

constexpr int CTRL_OUT = 0, CTRL_TGT = 1, CTRL_GRAFT = 2, CTRL_DROP = 3,
              CTRL_A = 4, CTRL_ADV = 5;
// the tally's rows (ops/kernels/receive.py TEL_ROWS), then the L latency
// rows and the transmitted GRAFT and PRUNE rows
constexpr int TEL_PAYLOAD = 0, TEL_IHAVE_IDS = 1, TEL_IWANT_SERVED = 2,
              TEL_RECV = 3, TEL_IWANT_REQ = 4, TEL_IHAVE_RPCS = 5,
              TEL_IWANT_RPCS = 6, TEL_NEW_IDS = 7, TEL_ROWS = 8;

// what one peer sends and keeps at the start of tick t (from its carry);
// under faults its alive word, send-ok bits and (cold restart) rejoin
// word of the tick
template <int W>
struct Front {
  uint32_t have[W], inj[W];
  uint32_t sub_all, cand_sub, fanout, grafts, dropped, mesh_sel, wa,
      out_bits, targets, alive, sok, rej;
  int lp;
};

template <int C, int W, bool FAULTS, bool COLD>
__device__ __forceinline__ void tick_front(const FusedArgs& a, int t,
                                           long long p, Front<W>& f) {
  const long long n = a.n;
  const bool first = t == 0;
  const int tick = a.tick0 + t;
  const uint32_t* have = first ? a.have_in : a.have;
  const uint32_t* mesh = first ? a.mesh_in : a.mesh;
  const uint32_t* fan = first ? a.fan_in : a.fan;
  const int32_t* lp = first ? a.lp_in : a.lp;
  const uint32_t* tgt = first ? a.tgt_in : a.tgt;
  const uint32_t* bog = first ? a.bog_in : a.bog;

  constexpr uint32_t ALL = (1u << C) - 1u;
  // the tick's fault words (a rejoiner's possession cleared first)
  const long long tp = (long long)t * n + p;
  f.alive = FAULTS ? a.alive[tp] : 0xFFFFFFFFu;
  f.sok = FAULTS ? a.sok[tp] : 0xFFFFFFFFu;
  f.rej = COLD ? a.rej[tp] : 0u;
  const uint32_t cal = FAULTS ? a.cal[tp] : ALL;
  const uint32_t up = f.alive & ALL;

  // 1. publish injection (a down origin's publish is lost)
  f.sub_all = a.sub_all[p];
  f.cand_sub = a.cand_sub[p];
  bool publishing = false;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    f.have[w] = have[w * n + p];
    if constexpr (COLD) f.have[w] &= ~f.rej;
    f.inj[w] = a.origin[w * n + p] & a.due[t * W + w] & ~f.have[w];
    if constexpr (FAULTS) f.inj[w] &= f.alive;
    publishing = publishing || f.inj[w] != 0u;
  }

  // 1b. fanout TTL + refill (own publishes only)
  f.lp = publishing ? tick : lp[p];
  const bool alive = f.sub_all == 0u && tick - f.lp < a.fanout_ttl;
  uint32_t fanout = alive ? fan[p] : 0u;
  const int f_need = alive ? a.d - __popc(fanout) : 0;
  if (f_need > 0) {
    uint32_t f_elig = f.cand_sub & ~fanout;
    // (FAULTS) dead candidates make useless fanout targets
    if constexpr (FAULTS) f_elig &= cal;
    fanout |= gossip::select_k<C>(f_elig, C, f_need, a.seeds[t][0], p,
                                  a.stride);
  }
  f.fanout = fanout;

  // 4. maintenance: graft to D below Dlo, random retention of D above
  // Dhi (v1.0); (FAULTS) mesh edges to or at a dead peer drop with
  // PRUNE and backoff at both ends, and nobody grafts at or by a dead
  // peer
  const uint32_t mesh0 = mesh[p];
  const uint32_t bo_row = bog[p];
  const uint32_t dead = FAULTS ? mesh0 & ~(cal & up) : 0u;
  const uint32_t mesh_ng = mesh0 & ~dead;
  const int deg = __popc(mesh_ng);
  uint32_t can_graft = f.cand_sub & ~mesh_ng & ~bo_row & f.sub_all;
  if constexpr (FAULTS) can_graft &= cal & up;
  const int need = deg < a.d_lo ? a.d - deg : 0;
  f.grafts = need > 0 ? gossip::select_k<C>(can_graft, C, need,
                                            a.seeds[t][1], p, a.stride)
                      : 0u;
  const uint32_t prunes =
      deg > a.d_hi ? mesh_ng & ~gossip::select_k<C>(mesh_ng, C, a.d,
                                                    a.seeds[t][2], p,
                                                    a.stride)
                   : 0u;
  f.dropped = prunes | dead;
  // (grafts never meet dead edges, so this is (mesh_ng | grafts) &
  // ~prunes)
  f.mesh_sel = (mesh0 | f.grafts) & ~f.dropped;
  f.wa = f.sub_all & ~(bo_row | f.dropped);
  f.out_bits = mesh0 | fanout;
  f.targets = tgt[p];
}

// The window; FAULTS and COLD compile in the fault rows and cold
// restart, TEL the telemetry rows (all false in fused_window_kernel,
// whose code stays as it was).  (TEL) s_tel: the block's partial tally
// of the tick, 8 + L + 2 ints of dynamic shared memory.
template <int C, int W, bool EXACTK, bool FAULTS, bool COLD,
          bool TEL = false>
__device__ __forceinline__ void fused_body(const FusedArgs& a,
                                           int* s_tel = nullptr) {
  cg::grid_group grid = cg::this_grid();
  const long long n = a.n;
  const long long first_p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  const int hg = a.hg;

  for (int t = 0; t < a.ticks; ++t) {
    const int tick = a.tick0 + t;
    const int slot = t & 1;
    uint8_t* sctl = a.stage_ctrl + (long long)slot * C * n;
    uint32_t* spay = a.stage_pay + (long long)slot * 2 * W * n;
    const uint32_t* rec_cur = t == 0 ? a.rec_in : a.rec;

    // ---- phase A: stage this tick's sender words
    for (long long p = first_p; p < n; p += step) {
      Front<W> f;
      tick_front<C, W, FAULTS, COLD>(a, t, p, f);
      // 2/3a. fresh (the newest ring slot, tick - 1) and advert (the
      // whole ring) windows; (COLD) a rejoiner's ring reads as cleared
      const int newest = (tick - 1 + hg) % hg;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t adv = f.inj[w];
        for (int h = 0; h < hg; ++h) {
          uint32_t r = rec_cur[(h * W + w) * n + p];
          if constexpr (COLD) r &= ~f.rej;
          adv |= r;
        }
        uint32_t fresh = rec_cur[(newest * W + w) * n + p];
        if constexpr (COLD) fresh &= ~f.rej;
        spay[w * n + p] = fresh | f.inj[w];
        spay[(W + w) * n + p] = adv;
      }
      // (FAULTS) a dead peer, or either end of a down link, sends
      // nothing: forwards, adverts and the handshake alike (the local
      // effects of its drops still apply in phase B)
      const uint32_t out = f.out_bits & f.sok;
      const uint32_t tgt_tx = f.targets & f.sok;
      const uint32_t graft_tx = f.grafts & f.sok;
      const uint32_t drop_tx = f.dropped & f.sok;
      const uint32_t a_tx = f.wa & f.sok;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint32_t b = (((out >> c) & 1u) << CTRL_OUT)
                           | (((tgt_tx >> c) & 1u) << CTRL_TGT)
                           | (((graft_tx >> c) & 1u) << CTRL_GRAFT)
                           | (((drop_tx >> c) & 1u) << CTRL_DROP)
                           | (((a_tx >> c) & 1u) << CTRL_A)
                           | (((tgt_tx >> c) & 1u) << CTRL_ADV);
        sctl[c * n + p] = (uint8_t)b;
      }
    }
    const int n_lat = TEL ? a.tel_lat_buckets : 0;
    const int tel_rows = TEL_ROWS + n_lat + 2;
    if constexpr (TEL) {
      // the block's partial tally of this tick, cleared before the
      // barrier; thread r clears and (after phase B) flushes row r
      for (int r = threadIdx.x; r < tel_rows; r += blockDim.x) s_tel[r] = 0;
    }

    grid.sync();

    // ---- phase B: receive, resolve, write the carry
    const int16_t* bo_cur = t == 0 ? a.bo_in : a.bo;
    const int ring_slot = tick % hg;
    // (TEL) this thread's tally rows over its peers, then the GRAFT and
    // PRUNE rows
    int tr[TEL_ROWS + 2] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (long long p = first_p; p < n; p += step) {
      Front<W> f;
      tick_front<C, W, FAULTS, COLD>(a, t, p, f);
      uint32_t heard[W];
#pragma unroll
      for (int w = 0; w < W; ++w) heard[w] = 0u;
      uint32_t graft_recv = 0u, prune_recv = 0u, a_recv = 0u;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        long long q = p + a.offsets[j];
        if (q >= n) q -= n;
        const uint32_t ctl = __ldcg(&sctl[(long long)a.cinv[j] * n + q]);
        graft_recv |= ((ctl >> CTRL_GRAFT) & 1u) << j;
        prune_recv |= ((ctl >> CTRL_DROP) & 1u) << j;
        a_recv |= ((ctl >> CTRL_A) & 1u) << j;
        const bool fwd_on = ((ctl >> CTRL_OUT) & 1u) != 0u;
        const bool gsp_on = ((ctl >> CTRL_TGT) & 1u) != 0u;
        if constexpr (TEL) {
          // the receive kernel's tallies (receive_body.cuh): sent words
          // before the alive mask, received, served and requested after
          const bool adv_on = ((ctl >> CTRL_ADV) & 1u) != 0u;
          int req_c = 0;
          bool adv_nz = false;
          if (fwd_on || gsp_on || adv_on) {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const uint32_t fwd_q = fwd_on ? __ldcg(&spay[w * n + q]) : 0u;
              const uint32_t adv_q =
                  (gsp_on || adv_on) ? __ldcg(&spay[(W + w) * n + q]) : 0u;
              const uint32_t gsp_q = gsp_on ? adv_q : 0u;
              const uint32_t adv_w = adv_on ? adv_q : 0u;
              const uint32_t seen = f.have[w] | f.inj[w];
              const uint32_t got = (fwd_q | gsp_q) & f.alive;
              heard[w] |= got & ~seen;
              tr[TEL_PAYLOAD] += __popc(fwd_q);
              tr[TEL_IHAVE_IDS] += __popc(adv_w);
              tr[TEL_IWANT_SERVED] += __popc(gsp_q & f.alive & ~seen);
              tr[TEL_RECV] += __popc(got);
              req_c += __popc(adv_w & f.alive & ~seen);
              adv_nz = adv_nz || adv_q != 0u;
            }
          }
          tr[TEL_IWANT_REQ] += req_c;
          tr[TEL_IHAVE_RPCS] += (adv_on && adv_nz) ? 1 : 0;
          tr[TEL_IWANT_RPCS] += req_c > 0 ? 1 : 0;
        } else {
          if (fwd_on || gsp_on) {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              uint32_t got = 0u;
              if (fwd_on) got |= __ldcg(&spay[w * n + q]);
              if (gsp_on) got |= __ldcg(&spay[(W + w) * n + q]);
              if constexpr (FAULTS) got &= f.alive;   // a down peer hears 0
              heard[w] |= got & ~(f.have[w] | f.inj[w]);
            }
          }
        }
      }
      if constexpr (FAULTS) {
        // a down receiver processes no inbound control
        graft_recv &= f.alive;
        prune_recv &= f.alive;
        a_recv &= f.alive;
      }
      const uint32_t accept = graft_recv & f.wa;
      const uint32_t retract = f.grafts & ~a_recv;
      const uint32_t mesh_new =
          ((f.mesh_sel | accept) & ~prune_recv) & ~retract;
      const uint32_t bo_trig = f.dropped | prune_recv | retract;

      if constexpr (TEL) {
        // the new acquisitions; the delivered ones by latency bucket
        // (shared atomics, only for a peer with a delivery this tick);
        // the handshake RPCs on the wire
        uint32_t dw[W];
        bool any_dw = false;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t h = f.sub_all != 0u ? heard[w] : 0u;
          tr[TEL_NEW_IDS] += __popc(h);
          dw[w] = n_lat > 0 ? (h | f.inj[w]) & a.dlv[w * n + p] : 0u;
          any_dw = any_dw || dw[w] != 0u;
        }
        if (any_dw) {
          for (int b = 0; b < n_lat; ++b) {
            int c = 0;
#pragma unroll
            for (int w = 0; w < W; ++w) {
              c += __popc(dw[w] & a.lat_masks[((long long)t * n_lat + b) * W
                                              + w]);
            }
            if (c != 0) atomicAdd(&s_tel[TEL_ROWS + b], c);
          }
        }
        const uint32_t cal = FAULTS ? a.cal[(long long)t * n + p] : ~0u;
        tr[TEL_ROWS] += __popc(f.grafts & f.sok & cal);
        tr[TEL_ROWS + 1] += __popc(f.dropped & f.sok & cal);
        a.meshrow[(long long)t * n + p] = mesh_new;
      }

      // acquisitions, possession and the mcache ring slot tick mod Hg
      // (at window entry the other ring rows carry over too)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t acq = (f.sub_all != 0u ? heard[w] : 0u) | f.inj[w];
        a.acq[((long long)t * W + w) * n + p] = acq;
        a.have[w * n + p] = f.have[w] | acq;
        for (int h = 0; h < hg; ++h) {
          const long long r = (long long)(h * W + w) * n + p;
          if (h == ring_slot) {
            a.rec[r] = acq;
          } else if (t == 0) {
            a.rec[r] = COLD ? a.rec_in[r] & ~f.rej : a.rec_in[r];
          } else if (COLD && f.rej != 0u) {
            a.rec[r] &= ~f.rej;     // a rejoiner's ring comes back clear
          }
        }
      }

      // backoff write + its gate row (i32 detour for max(bo - 1, 0))
      uint32_t bo_gate = 0u;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const long long idx = (long long)c * n + p;
        const int bo = bo_cur[idx];
        const int bo_new = ((bo_trig >> c) & 1u) ? a.backoff_restart
                                                 : (bo - 1 > 0 ? bo - 1 : 0);
        a.bo[idx] = (int16_t)bo_new;
        bo_gate |= (uint32_t)(bo_new > 0) << c;
      }

      // next tick's gossip targets: Bernoulli(k/|elig|), or the exact
      // uniform k-subset
      const uint32_t elig = f.cand_sub & ~mesh_new & ~f.fanout & f.sub_all;
      const int n_el = __popc(elig);
      const int n_fac = (int)__fmul_rn(a.gossip_factor, (float)n_el);
      const int n_go = a.d_lazy > n_fac ? a.d_lazy : n_fac;
      uint32_t tgt = 0u;
      if constexpr (EXACTK) {
        tgt = gossip::select_k<C>(elig, C, n_go, a.seeds[t][3], p, a.stride);
      } else {
        const float p_g = fminf(
            1.0f, __fdiv_rn((float)n_go, (float)(n_el > 1 ? n_el : 1)));
#pragma unroll
        for (int c = 0; c < C; ++c) {
          tgt |= (uint32_t)(gossip::lane_u(a.seeds[t][3], c, p, a.stride)
                            < p_g) << c;
        }
      }

      a.mesh[p] = mesh_new;
      a.fan[p] = f.fanout;
      a.lp[p] = f.lp;
      a.tgt[p] = elig & tgt;
      a.bog[p] = bo_gate;
    }
    if constexpr (TEL) {
      // the block's partial of each row: warp shuffles, one shared
      // atomic per warp and row, then one global atomic per block and
      // row into the tick's tally
      const int lane = threadIdx.x & 31;
#pragma unroll
      for (int r = 0; r < TEL_ROWS + 2; ++r) {
        int v = tr[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xFFFFFFFFu, v, off);
        }
        const int row = r < TEL_ROWS ? r : r + n_lat;
        if (lane == 0 && v != 0) atomicAdd(&s_tel[row], v);
      }
      __syncthreads();
      for (int r = threadIdx.x; r < tel_rows; r += blockDim.x) {
        if (s_tel[r] != 0) atomicAdd(&a.tel[t * tel_rows + r], s_tel[r]);
      }
    }
  }
}

template <int C, int W, bool EXACTK>
__global__ void __launch_bounds__(256)
fused_window_kernel(const FusedArgs a) {
  fused_body<C, W, EXACTK, false, false>(a);
}

// The window under a fault schedule: the per-tick alive, send-ok and
// cand-alive rows, and (COLD) the rejoin row, each read by the peer's own
// thread at (t, p) in both phases.
template <int C, int W, bool EXACTK, bool COLD>
__global__ void __launch_bounds__(256)
fused_window_kernel_faults(const FusedArgs a) {
  fused_body<C, W, EXACTK, true, COLD>(a);
}

// The window with its telemetry rows, without and with fault rows, in
// kernels of their own, so that the kernels above keep their code.
template <int C, int W, bool EXACTK>
__global__ void __launch_bounds__(256)
fused_window_kernel_tel(const FusedArgs a) {
  extern __shared__ int s_tel[];
  fused_body<C, W, EXACTK, false, false, true>(a, s_tel);
}

template <int C, int W, bool EXACTK, bool COLD>
__global__ void __launch_bounds__(256)
fused_window_kernel_faults_tel(const FusedArgs a) {
  extern __shared__ int s_tel[];
  fused_body<C, W, EXACTK, true, COLD, true>(a, s_tel);
}

template <int C, int W, bool EXACTK, bool FAULTS, bool COLD, bool TEL>
const void* window_kernel() {
  if constexpr (TEL && FAULTS) {
    return (const void*)fused_window_kernel_faults_tel<C, W, EXACTK, COLD>;
  } else if constexpr (TEL) {
    return (const void*)fused_window_kernel_tel<C, W, EXACTK>;
  } else if constexpr (FAULTS) {
    return (const void*)fused_window_kernel_faults<C, W, EXACTK, COLD>;
  } else {
    return (const void*)fused_window_kernel<C, W, EXACTK>;
  }
}

template <int C, int W, bool EXACTK, bool FAULTS, bool COLD, bool TEL>
int resident_blocks(int threads, size_t smem, int* out) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, window_kernel<C, W, EXACTK, FAULTS, COLD, TEL>(), threads,
        smem);
  *out = per_sm * sms;
  return (int)err;
}

template <int C, int W, bool EXACTK, bool FAULTS, bool COLD, bool TEL>
int launch_variant(const FusedArgs& a, cudaStream_t s) {
  const int threads = 256;
  // (TEL) the block's partial tally: 8 + L + 2 ints
  const size_t smem =
      TEL ? (size_t)(TEL_ROWS + a.tel_lat_buckets + 2) * sizeof(int) : 0;
  int resident = 0;
  int err = resident_blocks<C, W, EXACTK, FAULTS, COLD, TEL>(threads, smem,
                                                             &resident);
  if (err != 0) return err;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long want = (a.n + threads - 1) / threads;
  const int blocks = (int)(want < resident ? want : resident);
  void* args[] = {(void*)&a};
  err = (int)cudaLaunchCooperativeKernel(
      window_kernel<C, W, EXACTK, FAULTS, COLD, TEL>(), dim3(blocks),
      dim3(threads), args, smem, s);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <int C, int W, bool EXACTK, bool TEL>
int launch_faults(const FusedArgs& a, cudaStream_t s) {
  if (!a.faults) return launch_variant<C, W, EXACTK, false, false, TEL>(a, s);
  if (a.cold) return launch_variant<C, W, EXACTK, true, true, TEL>(a, s);
  return launch_variant<C, W, EXACTK, true, false, TEL>(a, s);
}

template <int C, int W, bool EXACTK>
int launch_targets(const FusedArgs& a, cudaStream_t s) {
  if (a.telemetry) return launch_faults<C, W, EXACTK, true>(a, s);
  return launch_faults<C, W, EXACTK, false>(a, s);
}

template <int C, int W>
int launch(const FusedArgs& a, cudaStream_t s) {
  if (a.exact_k) return launch_targets<C, W, true>(a, s);
  return launch_targets<C, W, false>(a, s);
}

}  // namespace

// c in {8, 16}, w in {1, 2}.  Returns the CUDA error code of the launch:
// cudaErrorCooperativeLaunchTooLarge when not one block can be resident
// (the wrapper raises the named refusal; nothing runs), or
// cudaErrorInvalidValue for a shape with no instantiation (the wrapper
// refuses those first).
extern "C" int gossip_fused_window(const FusedArgs* args, int c, int w,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (args->n <= 0 || args->ticks <= 0) return 0;
  if (args->ticks > MAX_WINDOW) return (int)cudaErrorInvalidValue;
  if (c == 16 && w == 1) return launch<16, 1>(*args, s);
  if (c == 16 && w == 2) return launch<16, 2>(*args, s);
  if (c == 8 && w == 1) return launch<8, 1>(*args, s);
  if (c == 8 && w == 2) return launch<8, 2>(*args, s);
  return (int)cudaErrorInvalidValue;
}
