// The tick-resident fused window: T unscored GossipSub heartbeats in one
// launch (Hopper, sm_90a).
//
// Replaces: go_libp2p_pubsub_tpu/ops/pallas/receive.py,
// _fused_gossip_kernel (built by make_fused_gossip_update), single
// device, without fault rows, cold restart, telemetry or the sharded
// halo.  It computes what that kernel computes, bit-identical to the
// plain version (ops/kernels/fused.py fused_gossip_update_plain): per
// tick, publish injection, fanout TTL and refill, the graft and v1.0
// random-prune selections, the eager/lazy exchange over the C circulant
// edges, the GRAFT/PRUNE/A handshake, the backoff write, the mcache ring
// update and the next tick's targets (Bernoulli, or with EXACTK the
// exact uniform k-subset: the same select_k as the other selections, at
// the targets' lane seed) and backoff gate rows; it emits each tick's
// acquisitions.
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
// 8-tick window, 0.59 GB at 1M peers, 0.18 ms at 3.35 TB/s.  This first
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
};

namespace {

constexpr int CTRL_OUT = 0, CTRL_TGT = 1, CTRL_GRAFT = 2, CTRL_DROP = 3,
              CTRL_A = 4, CTRL_ADV = 5;

// what one peer sends and keeps at the start of tick t (from its carry)
template <int W>
struct Front {
  uint32_t have[W], inj[W];
  uint32_t sub_all, cand_sub, fanout, grafts, dropped, mesh_sel, wa,
      out_bits, targets;
  int lp;
};

template <int C, int W>
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

  // 1. publish injection
  f.sub_all = a.sub_all[p];
  f.cand_sub = a.cand_sub[p];
  bool publishing = false;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    f.have[w] = have[w * n + p];
    f.inj[w] = a.origin[w * n + p] & a.due[t * W + w] & ~f.have[w];
    publishing = publishing || f.inj[w] != 0u;
  }

  // 1b. fanout TTL + refill (own publishes only)
  f.lp = publishing ? tick : lp[p];
  const bool alive = f.sub_all == 0u && tick - f.lp < a.fanout_ttl;
  uint32_t fanout = alive ? fan[p] : 0u;
  const int f_need = alive ? a.d - __popc(fanout) : 0;
  if (f_need > 0) {
    fanout |= gossip::select_k<C>(f.cand_sub & ~fanout, C, f_need,
                                  a.seeds[t][0], p, a.stride);
  }
  f.fanout = fanout;

  // 4. maintenance: graft to D below Dlo, random retention of D above
  // Dhi (v1.0)
  const uint32_t mesh0 = mesh[p];
  const uint32_t bo_row = bog[p];
  const int deg = __popc(mesh0);
  const uint32_t can_graft = f.cand_sub & ~mesh0 & ~bo_row & f.sub_all;
  const int need = deg < a.d_lo ? a.d - deg : 0;
  f.grafts = need > 0 ? gossip::select_k<C>(can_graft, C, need,
                                            a.seeds[t][1], p, a.stride)
                      : 0u;
  f.dropped = deg > a.d_hi
                  ? mesh0 & ~gossip::select_k<C>(mesh0, C, a.d,
                                                 a.seeds[t][2], p, a.stride)
                  : 0u;
  f.mesh_sel = (mesh0 | f.grafts) & ~f.dropped;
  f.wa = f.sub_all & ~(bo_row | f.dropped);
  f.out_bits = mesh0 | fanout;
  f.targets = tgt[p];
}

template <int C, int W, bool EXACTK>
__global__ void __launch_bounds__(256)
fused_window_kernel(const FusedArgs a) {
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
      tick_front<C, W>(a, t, p, f);
      // 2/3a. fresh (the newest ring slot, tick - 1) and advert (the
      // whole ring) windows
      const int newest = (tick - 1 + hg) % hg;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t adv = f.inj[w];
        for (int h = 0; h < hg; ++h) adv |= rec_cur[(h * W + w) * n + p];
        spay[w * n + p] = rec_cur[(newest * W + w) * n + p] | f.inj[w];
        spay[(W + w) * n + p] = adv;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint32_t b = (((f.out_bits >> c) & 1u) << CTRL_OUT)
                           | (((f.targets >> c) & 1u) << CTRL_TGT)
                           | (((f.grafts >> c) & 1u) << CTRL_GRAFT)
                           | (((f.dropped >> c) & 1u) << CTRL_DROP)
                           | (((f.wa >> c) & 1u) << CTRL_A)
                           | (((f.targets >> c) & 1u) << CTRL_ADV);
        sctl[c * n + p] = (uint8_t)b;
      }
    }

    grid.sync();

    // ---- phase B: receive, resolve, write the carry
    const int16_t* bo_cur = t == 0 ? a.bo_in : a.bo;
    const int ring_slot = tick % hg;
    for (long long p = first_p; p < n; p += step) {
      Front<W> f;
      tick_front<C, W>(a, t, p, f);
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
        if (fwd_on || gsp_on) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            uint32_t got = 0u;
            if (fwd_on) got |= __ldcg(&spay[w * n + q]);
            if (gsp_on) got |= __ldcg(&spay[(W + w) * n + q]);
            heard[w] |= got & ~(f.have[w] | f.inj[w]);
          }
        }
      }
      const uint32_t accept = graft_recv & f.wa;
      const uint32_t retract = f.grafts & ~a_recv;
      const uint32_t mesh_new =
          ((f.mesh_sel | accept) & ~prune_recv) & ~retract;
      const uint32_t bo_trig = f.dropped | prune_recv | retract;

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
            a.rec[r] = a.rec_in[r];
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
  }
}

template <int C, int W, bool EXACTK>
int resident_blocks(int threads, int* out) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_window_kernel<C, W, EXACTK>, threads, 0);
  *out = per_sm * sms;
  return (int)err;
}

template <int C, int W, bool EXACTK>
int launch_variant(const FusedArgs& a, cudaStream_t s) {
  const int threads = 256;
  int resident = 0;
  int err = resident_blocks<C, W, EXACTK>(threads, &resident);
  if (err != 0) return err;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long want = (a.n + threads - 1) / threads;
  const int blocks = (int)(want < resident ? want : resident);
  void* args[] = {(void*)&a};
  err = (int)cudaLaunchCooperativeKernel(
      (void*)fused_window_kernel<C, W, EXACTK>, dim3(blocks), dim3(threads),
      args, 0, s);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <int C, int W>
int launch(const FusedArgs& a, cudaStream_t s) {
  if (a.exact_k) return launch_variant<C, W, true>(a, s);
  return launch_variant<C, W, false>(a, s);
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
