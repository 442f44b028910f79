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
// :2132-2139), counted in phase A.  Each thread sums its peers' rows in
// registers, each block reduces them by warp shuffles and shared atomics
// and adds them into the tick's tally row with one i32 atomicAdd per
// block and row before the next tick's barrier.  The wrapper zeroes the
// tally on the stream; integer sums are order-free, so it is exact.
//
// Design.  On the TPU the whole ring is one block resident in VMEM and
// the candidate views are whole-ring lane rolls.  Here every tick reads
// every peer's tick-t sender words at offsets up to N, so consecutive
// ticks need a grid-wide barrier: one persistent cooperative launch of
// one 512-thread block per multiprocessor.  Block b owns the peers
// [b P, b P + P), P = N / blocks rounded up to a multiple of 4, for the
// whole window; its threads own 4-peer groups, and every [N] row moves as
// one 16-byte access a group (a [C, N] i16 backoff row as 8 bytes), but
// at the ragged tail and in a row that does not start on a 16-byte
// boundary, which move a word a peer.  Per tick:
//
//   phase A: each group finishes the previous tick's backoff write (its
//     edges kept in the front by phase B), so its gate row is at hand;
//     computes its tick front once (injection, fanout, the graft and
//     prune selections) from its carry; writes last_pub and fanout (final
//     by then) to the output carry; keeps what phase B needs in the front
//     (below); and stages its sender words: fresh and advert words
//     [2W, SP] and, per edge c, one u32 of four senders' ctrl bytes
//     [C, SC];
//   grid.sync();
//   phase B: each group reads its front back, all C ctrl words of its
//     senders at q = p + o_j mod N (bytes q..q+3 of a row as two aligned
//     words and a funnel shift), then both payload words of every edge
//     (unconditional: no second round trip that waits on the ctrl
//     bytes), resolves the exchange and handshake and writes its carry
//     but the backoff, whose edges it leaves in the front.
//
// After the last tick one more pass writes the window's last backoff and
// gate rows.
//
// The front: per peer 2W + 4 words, packed at C <= 16 — possession
// (have | injected) and the injected words, grafts | dropped << 16 (then
// phase B's backoff edges), the selected mesh | would-accept << 16,
// fanout | cand_sub << 16, and the flags sub_all | alive << 16 |
// rejoining << 17 (the fault rows' alive and rejoin words are all-ones or
// zero, models/faults.py tick_masks).  It lives in dynamic shared memory,
// [2W + 4, P] a block (24 B/peer at W = 1: 186 KB of the 227 KB a block
// can have at 1,048,576 peers), with the telemetry tally s_tel after it;
// where it does not fit (W = 2 at 1M peers, or N above ~1.28M at W = 1)
// the same code keeps it in a device-memory scratch [2W + 4, blocks P]
// that the wrapper always passes, sized for any plan; make_plan chooses
// from the shape before the launch (gossip_fused_launch_config reports
// its choice).  cand_sub and sub_all, static, are read
// from the front after tick 0.
//
// The stage has one slot a tick ([T, C, SC] bytes, [T, 2W, SP] words),
// written in phase A of its tick and read after that tick's barrier with
// plain loads through L1 (a group's C ctrl words and its senders' payload
// words share lines).  An earlier version kept two slots by t mod 2,
// read as ld.global.cg, constant in T: on the card the payload a slot a tick
// through L1 took 1.0920 ms a window against 1.2851 for two .cg slots
// (PERF.md); two slots through L1 were not measured.  Its price is
// memory that grows with T: (C SC + 8W SP) bytes a tick, 25.2 MB at
// C = 16, W = 1 and 1,048,576 peers, so 201 MB at T = 8 and 1.61 GB at
// T = MAX_WINDOW = 64 (2.15 GB at W = 2), which the wrapper allocates
// per window.  The reads are correct because grid.sync() orders memory
// at device scope: each block's master fences before the barrier's
// arrive and after its wait, and the block's bar.sync follows, so under
// the PTX memory model every phase-A store of tick t happens before every
// phase-B load of tick t, whatever cache the load goes through (the
// acquire fence drops the multiprocessor's L1 lines).  Rows are whole
// 128-byte lines, so no line holds entries of two slots.  Each staged row has
// a halo: its first three entries again at N..N+2 (written by the group
// of peer 0), so a group's four senders q..q+3 never wrap, and the row
// holds both aligned words of every read.  Window entry reads the input
// carry and every tick writes the output carry, so inputs are never
// modified; the carry (68 B/peer at C = 16, W = 1, Hg = 3) is read once
// and written once a tick.
//
// Bound on this card.  The function moves, per window, the carry in and
// out once (2 x 68 B/peer), the static rows once (12 B/peer at W = 1)
// and each tick's acquisitions (4W B/peer): ~180 B/peer, 0.056 ms at
// 1,048,576 peers; its operations (chip_smoke.py fused_window_ops: one
// front a peer-tick, the selections' draws where select_k's early outs
// need them) bound it at ~0.1 ms.  The kernel takes ~1 ms: it moves the
// carry every tick (its rows, 71 MB at 1M peers, do not fit the 50 MB L2
// nor the chip) and the stage, and at 16 warps a multiprocessor (128
// registers a thread) its loads' latency shows.  The parent's window
// (1.77 ms) split on the card (PERF.md): phase B 1.2 ms, phase A
// 0.16-0.37, a second front cheaper than a device-memory copy of the
// first; this design's own split: the payload gathers (4x the L2 sectors
// as .cg loads, one through L1) and the backoff rows (latency after the
// gathers, now overlapped with phase A's carry loads) were phase B's two
// largest parts.
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
  // the stage, one slot a tick, rows padded (stage_stride)
  uint8_t* stage_ctrl;       // [T, C, SC] sender ctrl bytes
  uint32_t* stage_pay;       // [T, 2W, SP] sender fresh + advert words
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
  // the fault rows: per tick [T, N] words
  const uint32_t* alive;     // live peer: ~0u, down: 0
  const uint32_t* sok;       // edges a peer may send on
  const uint32_t* cal;       // live candidates
  const uint32_t* rej;       // (cold restart) ~0u at a rejoiner, or null
  int faults;                // launch the faulted kernel
  int cold;                  // ... with cold restart
  // the telemetry rows
  const uint32_t* lat_masks; // [T, L, W] latency-bucket masks (L > 0)
  const uint32_t* dlv;       // [W, N] deliver words (L > 0)
  uint32_t* meshrow;         // [T, N] each tick's end-of-tick mesh
  int* tel;                  // [T, 8 + L + 2] tallies, zeroed by the caller
  int tel_lat_buckets;       // L
  int telemetry;             // launch the telemetry kernel
  // the front's device-memory scratch (rows of at least blocks * peers),
  // read only where the front does not fit in shared memory; the launch
  // sets the rest
  uint32_t* front;
  int peers;                 // P: peers a block, a multiple of 4
  int front_global;          // 1: the front is in ``front``
};

namespace {

constexpr int THREADS = 512;
// words of the front a peer (ops/kernels/fused.py front_words)
__host__ __device__ constexpr int front_words(int w) { return 2 * w + 4; }
constexpr int CTRL_OUT = 0, CTRL_TGT = 1, CTRL_GRAFT = 2, CTRL_DROP = 3,
              CTRL_A = 4, CTRL_ADV = 5;
// the tally's rows (ops/kernels/receive.py TEL_ROWS), then the L latency
// rows and the transmitted GRAFT and PRUNE rows
constexpr int TEL_PAYLOAD = 0, TEL_IHAVE_IDS = 1, TEL_IWANT_SERVED = 2,
              TEL_RECV = 3, TEL_IWANT_REQ = 4, TEL_IHAVE_RPCS = 5,
              TEL_IWANT_RPCS = 6, TEL_NEW_IDS = 7, TEL_ROWS = 8;
// the front's flag word: sub_all's C bits, then alive and rejoining
constexpr uint32_t FL_ALIVE = 1u << 16, FL_REJ = 1u << 17;

// the stage's row stride in entries (ctrl bytes, payload words): at least
// N + 8 (the halo N..N+2 and the second aligned word of a read at N - 1),
// a whole number of 128-byte lines (no L1 line holds entries of two
// ticks' slots)
__host__ __device__ inline long long stage_stride(long long n, int size) {
  const long long per_line = 128 / size;
  return (n + 8 + per_line - 1) / per_line * per_line;
}

// four peers' words of a row from p0 (a multiple of 4): one 16-byte
// access where all four are peers and the row is 16-byte aligned there,
// else a word a peer (zero past the last peer)
template <typename T>
__device__ __forceinline__ void ld4(const T* row, long long p0, int nv,
                                    uint32_t (&v)[4]) {
  static_assert(sizeof(T) == 4, "32-bit rows");
  const T* s = row + p0;
  if (nv == 4 && ((uintptr_t)s & 15u) == 0u) {
    const uint4 x = *reinterpret_cast<const uint4*>(s);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < nv ? (uint32_t)s[i] : 0u;
  }
}

template <typename T>
__device__ __forceinline__ void st4(T* row, long long p0, int nv,
                                    const uint32_t (&v)[4]) {
  static_assert(sizeof(T) == 4, "32-bit rows");
  T* s = row + p0;
  if (nv == 4 && ((uintptr_t)s & 15u) == 0u) {
    *reinterpret_cast<uint4*>(s) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < nv) s[i] = (T)v[i];
    }
  }
}

// the same for an i16 row: one 8-byte access
__device__ __forceinline__ void ld4h(const int16_t* row, long long p0,
                                     int nv, int (&v)[4]) {
  const int16_t* s = row + p0;
  if (nv == 4 && ((uintptr_t)s & 7u) == 0u) {
    const uint2 x = *reinterpret_cast<const uint2*>(s);
    v[0] = (int)(int16_t)(x.x & 0xFFFFu);
    v[1] = (int)(int16_t)(x.x >> 16);
    v[2] = (int)(int16_t)(x.y & 0xFFFFu);
    v[3] = (int)(int16_t)(x.y >> 16);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < nv ? (int)s[i] : 0;
  }
}

__device__ __forceinline__ void st4h(int16_t* row, long long p0, int nv,
                                     const int (&v)[4]) {
  int16_t* s = row + p0;
  if (nv == 4 && ((uintptr_t)s & 7u) == 0u) {
    *reinterpret_cast<uint2*>(s) = make_uint2(
        ((uint32_t)v[0] & 0xFFFFu) | ((uint32_t)v[1] << 16),
        ((uint32_t)v[2] & 0xFFFFu) | ((uint32_t)v[3] << 16));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < nv) s[i] = (int16_t)v[i];
    }
  }
}

// the front's row r of a group (16-byte aligned: P is a multiple of 4)
__device__ __forceinline__ void fr_ld(const uint32_t* fr, long long stride,
                                      int r, int g, uint32_t (&v)[4]) {
  const uint4 x = *reinterpret_cast<const uint4*>(fr + r * stride + 4 * g);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void fr_st(uint32_t* fr, long long stride, int r,
                                      int g, const uint32_t (&v)[4]) {
  *reinterpret_cast<uint4*>(fr + r * stride + 4 * g) =
      make_uint4(v[0], v[1], v[2], v[3]);
}

// select_k's draws and sort, out of line: most calls take an early out
template <int C>
__device__ __noinline__ uint32_t select_drawn(uint32_t elig, int k,
                                              uint32_t seed, long long p,
                                              uint32_t stride) {
  return gossip::select_k<C>(elig, C, k, seed, p, stride);
}

template <int C>
__device__ __forceinline__ uint32_t select_bits(uint32_t bits, int k,
                                           uint32_t seed, long long p,
                                           uint32_t stride) {
  const uint32_t elig = bits & ((1u << C) - 1u);
  if (k <= 0 || elig == 0u) return 0u;
  if (k >= __popc(elig)) return elig;
  return select_drawn<C>(elig, k, seed, p, stride);
}

// The backoff write of a tick for one group (i32 detour for max(bo - 1,
// 0)): rows ``src`` to ``dst``, restarted where ``trig`` has the edge;
// its gate row (bo > 0) into ``gate``
template <int C>
__device__ __forceinline__ void backoff_step(const int16_t* src, int16_t* dst,
                                             long long n, long long p0,
                                             int nv, const uint32_t (&trig)[4],
                                             int restart, uint32_t (&gate)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) gate[i] = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    int bo[4];
    ld4h(src + c * n, p0, nv, bo);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = ((trig[i] >> c) & 1u) ? restart
                                          : (bo[i] - 1 > 0 ? bo[i] - 1 : 0);
      bo[i] = b;
      gate[i] |= (uint32_t)(b > 0) << c;
    }
    st4h(dst + c * n, p0, nv, bo);
  }
}

// byte b of each of four words, as one word (byte i from x[i])
__device__ __forceinline__ uint32_t bytes_of(const uint32_t (&x)[4], int b) {
  const uint32_t sel = (uint32_t)b | ((uint32_t)(b + 4) << 4);
  const uint32_t lo = __byte_perm(x[0], x[1], sel);
  const uint32_t hi = __byte_perm(x[2], x[3], sel);
  return __byte_perm(lo, hi, 0x5410);
}

// The window; FAULTS and COLD compile in the fault rows and cold
// restart, TEL the telemetry rows.  ``smem``: the front (where it fits)
// and then (TEL) s_tel, the block's partial tally of the tick.
template <int C, int W, bool EXACTK, bool FAULTS, bool COLD, bool TEL>
__device__ __forceinline__ void fused_body(const FusedArgs& a,
                                           uint32_t* smem) {
  static_assert(C <= 16, "the front packs C-bit masks into 16 bits");
  constexpr uint32_t ALL = (1u << C) - 1u;
  constexpr int FW = front_words(W);
  constexpr int FR_SEEN = 0, FR_INJ = W, FR_GD = 2 * W, FR_MA = 2 * W + 1,
                FR_FC = 2 * W + 2, FR_FL = 2 * W + 3;
  cg::grid_group grid = cg::this_grid();
  const long long n = a.n;
  const int P = a.peers;
  const long long b0 = (long long)blockIdx.x * P;
  const long long left = n - b0;
  const int groups = (int)(((left < P ? left : P) + 3) >> 2);
  uint32_t* fr = a.front_global ? a.front + b0 : smem;
  const long long fstride =
      a.front_global ? (long long)gridDim.x * P : (long long)P;
  int* s_tel = reinterpret_cast<int*>(a.front_global ? smem : smem + FW * P);
  const long long SC = stage_stride(n, 1), SP = stage_stride(n, 4);
  const int hg = a.hg;
  const int n_lat = TEL ? a.tel_lat_buckets : 0;
  const int tel_rows = TEL_ROWS + n_lat + 2;

  for (int t = 0; t < a.ticks; ++t) {
    const int tick = a.tick0 + t;
    const bool first = t == 0;
    uint8_t* sctl = a.stage_ctrl + (long long)t * C * SC;
    uint32_t* spay = a.stage_pay + (long long)t * 2 * W * SP;
    const uint32_t* rec_cur = first ? a.rec_in : a.rec;
    const long long tn = (long long)t * n;
    // (TEL) this thread's tally rows over its peers, then the GRAFT and
    // PRUNE rows (counted in phase A)
    int tr[TEL_ROWS + 2] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

    // ---- phase A: the front, once; stage this tick's sender words
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const long long p0 = b0 + 4 * g;
      const int nv = (int)(n - p0 < 4 ? n - p0 : 4);
      uint32_t have[W][4], orig[W][4], mesh[4], fan[4], lpw[4], tgt[4],
          bog[4], sub[4], cand[4], alive[4], sok[4], cal[4], rej[4];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        ld4(first ? a.have_in + w * n : a.have + w * n, p0, nv, have[w]);
        ld4(a.origin + w * n, p0, nv, orig[w]);
      }
      ld4(first ? a.mesh_in : a.mesh, p0, nv, mesh);
      ld4(first ? a.fan_in : a.fan, p0, nv, fan);
      ld4(first ? a.lp_in : a.lp, p0, nv, lpw);
      ld4(first ? a.tgt_in : a.tgt, p0, nv, tgt);
      if (first) {
        ld4(a.bog_in, p0, nv, bog);
      } else {
        // the previous tick's backoff write (its edges from phase B, in
        // the front's grafts | dropped word) and this tick's gate row
        uint32_t trig[4];
        fr_ld(fr, fstride, FR_GD, g, trig);
        backoff_step<C>(t == 1 ? a.bo_in : a.bo, a.bo, n, p0, nv, trig,
                        a.backoff_restart, bog);
      }
      if (first) {
        ld4(a.sub_all, p0, nv, sub);
        ld4(a.cand_sub, p0, nv, cand);
      } else {
        uint32_t fc[4], fl[4];
        fr_ld(fr, fstride, FR_FC, g, fc);
        fr_ld(fr, fstride, FR_FL, g, fl);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cand[i] = fc[i] >> 16;
          sub[i] = fl[i] & 0xFFFFu;
        }
      }
      if constexpr (FAULTS) {
        ld4(a.alive + tn, p0, nv, alive);
        ld4(a.sok + tn, p0, nv, sok);
        ld4(a.cal + tn, p0, nv, cal);
      }
      if constexpr (COLD) ld4(a.rej + tn, p0, nv, rej);

      uint32_t seen[W][4], inj[W][4], gd[4], ma[4], fc[4], fl[4], fanout[4],
          lp_new[4], c_out[4], c_tgt[4], c_graft[4], c_drop[4], c_a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long p = p0 + i;
        const uint32_t aw = FAULTS ? alive[i] : 0xFFFFFFFFu;
        const uint32_t so = FAULTS ? sok[i] : 0xFFFFFFFFu;
        const uint32_t ca = FAULTS ? cal[i] : ALL;
        const uint32_t rj = COLD ? rej[i] : 0u;
        const uint32_t up = aw & ALL;
        // 1. publish injection (a down origin's publish is lost)
        bool publishing = false;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t h = have[w][i];
          if constexpr (COLD) h &= ~rj;
          uint32_t in = orig[w][i] & a.due[t * W + w] & ~h;
          if constexpr (FAULTS) in &= aw;
          publishing = publishing || in != 0u;
          inj[w][i] = in;
          seen[w][i] = h | in;
        }
        // 1b. fanout TTL + refill (own publishes only)
        const int lp = publishing ? tick : (int)lpw[i];
        lp_new[i] = (uint32_t)lp;
        const bool fan_alive = sub[i] == 0u && tick - lp < a.fanout_ttl;
        uint32_t fo = fan_alive ? fan[i] : 0u;
        const int f_need = fan_alive ? a.d - __popc(fo) : 0;
        if (f_need > 0) {
          uint32_t f_elig = cand[i] & ~fo;
          // (FAULTS) dead candidates make useless fanout targets
          if constexpr (FAULTS) f_elig &= ca;
          fo |= select_bits<C>(f_elig, f_need, a.seeds[t][0], p, a.stride);
        }
        fanout[i] = fo;
        // 4. maintenance: graft to D below Dlo, random retention of D
        // above Dhi (v1.0); (FAULTS) mesh edges to or at a dead peer drop
        // with PRUNE and backoff at both ends, and nobody grafts at or by
        // a dead peer
        const uint32_t mesh0 = mesh[i];
        const uint32_t dead = FAULTS ? mesh0 & ~(ca & up) : 0u;
        const uint32_t mesh_ng = mesh0 & ~dead;
        const int deg = __popc(mesh_ng);
        uint32_t can_graft = cand[i] & ~mesh_ng & ~bog[i] & sub[i];
        if constexpr (FAULTS) can_graft &= ca & up;
        const int need = deg < a.d_lo ? a.d - deg : 0;
        const uint32_t grafts =
            select_bits<C>(can_graft, need, a.seeds[t][1], p, a.stride);
        const uint32_t prunes =
            deg > a.d_hi
                ? mesh_ng & ~select_bits<C>(mesh_ng, a.d, a.seeds[t][2], p,
                                       a.stride)
                : 0u;
        const uint32_t dropped = prunes | dead;
        // (grafts never meet dead edges, so this is (mesh_ng | grafts) &
        // ~prunes)
        const uint32_t mesh_sel = (mesh0 | grafts) & ~dropped;
        const uint32_t wa = sub[i] & ~(bog[i] | dropped);
        gd[i] = (grafts & 0xFFFFu) | (dropped << 16);
        ma[i] = (mesh_sel & 0xFFFFu) | (wa << 16);
        fc[i] = (fo & 0xFFFFu) | (cand[i] << 16);
        fl[i] = (sub[i] & 0xFFFFu) | (aw != 0u ? FL_ALIVE : 0u)
                | (rj != 0u ? FL_REJ : 0u);
        // (FAULTS) a dead peer, or either end of a down link, sends
        // nothing: forwards, adverts and the handshake alike (the local
        // effects of its drops still apply in phase B)
        c_out[i] = (mesh0 | fo) & so;
        c_tgt[i] = tgt[i] & so;
        c_graft[i] = grafts & so;
        c_drop[i] = dropped & so;
        c_a[i] = wa & so;
        if constexpr (TEL) {
          if (i < nv) {
            tr[TEL_ROWS] += __popc(grafts & so & ca);
            tr[TEL_ROWS + 1] += __popc(dropped & so & ca);
          }
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        fr_st(fr, fstride, FR_SEEN + w, g, seen[w]);
        fr_st(fr, fstride, FR_INJ + w, g, inj[w]);
      }
      fr_st(fr, fstride, FR_GD, g, gd);
      fr_st(fr, fstride, FR_MA, g, ma);
      fr_st(fr, fstride, FR_FC, g, fc);
      fr_st(fr, fstride, FR_FL, g, fl);
      st4(a.lp, p0, nv, lp_new);
      st4(a.fan, p0, nv, fanout);

      // 2/3a. fresh (the newest ring slot, tick - 1) and advert (the
      // whole ring) windows; (COLD) a rejoiner's ring reads as cleared.
      // The group of peer 0 also writes the halo: entries N..N+2 hold
      // peers 0..2 (mod N).
      const int newest = (tick - 1 + hg) % hg;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t fresh[4], adv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) fresh[i] = adv[i] = inj[w][i];
        for (int h = 0; h < hg; ++h) {
          uint32_t r[4];
          ld4(rec_cur + (h * W + w) * n, p0, nv, r);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (COLD) r[i] &= ~rej[i];
            adv[i] |= r[i];
            if (h == newest) fresh[i] = r[i] | inj[w][i];
          }
        }
        uint32_t* f_row = spay + w * SP;
        uint32_t* a_row = spay + (W + w) * SP;
        st4(f_row, p0, nv, fresh);
        st4(a_row, p0, nv, adv);
        if (p0 == 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int src = k < n ? k : 0;
            f_row[n + k] = src == 0 ? fresh[0] : src == 1 ? fresh[1]
                                                          : fresh[2];
            a_row[n + k] = src == 0 ? adv[0] : src == 1 ? adv[1] : adv[2];
          }
        }
      }
      // the ctrl bytes: per edge c one word, byte i peer p0 + i's; built
      // four edges at a time from the peers' masks (a nibble a peer, then
      // each edge's bit of each flag into its byte)
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += 4) {
        const int byte = c0 >> 3, nib = (c0 & 4) ? 4 : 0;
        const uint32_t m_out = (bytes_of(c_out, byte) >> nib) & 0x0F0F0F0Fu;
        const uint32_t m_tgt = (bytes_of(c_tgt, byte) >> nib) & 0x0F0F0F0Fu;
        const uint32_t m_graft =
            (bytes_of(c_graft, byte) >> nib) & 0x0F0F0F0Fu;
        const uint32_t m_drop = (bytes_of(c_drop, byte) >> nib) & 0x0F0F0F0Fu;
        const uint32_t m_a = (bytes_of(c_a, byte) >> nib) & 0x0F0F0F0Fu;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t word = (((m_out >> k) & 0x01010101u) << CTRL_OUT)
                                | (((m_tgt >> k) & 0x01010101u) << CTRL_TGT)
                                | (((m_graft >> k) & 0x01010101u)
                                   << CTRL_GRAFT)
                                | (((m_drop >> k) & 0x01010101u) << CTRL_DROP)
                                | (((m_a >> k) & 0x01010101u) << CTRL_A)
                                | (((m_tgt >> k) & 0x01010101u) << CTRL_ADV);
          uint8_t* row = sctl + (c0 + k) * SC;
          if (nv == 4) {
            *reinterpret_cast<uint32_t*>(row + p0) = word;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (i < nv) row[p0 + i] = (uint8_t)(word >> (8 * i));
            }
          }
          if (p0 == 0) {
#pragma unroll
            for (int h = 0; h < 3; ++h) {
              const int src = h < n ? h : 0;
              row[n + h] = (uint8_t)(word >> (8 * src));
            }
          }
        }
      }
    }
    if constexpr (TEL) {
      // the block's partial tally of this tick, cleared before the
      // barrier; thread r clears and (after phase B) flushes row r
      for (int r = threadIdx.x; r < tel_rows; r += blockDim.x) s_tel[r] = 0;
    }

    grid.sync();

    // ---- phase B: receive, resolve, write the carry
    const int ring_slot = tick % hg;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const long long p0 = b0 + 4 * g;
      const int nv = (int)(n - p0 < 4 ? n - p0 : 4);
      // the senders' ctrl bytes first: bytes q..q+3 of row cinv[j], q =
      // p0 + o_j mod N, as two aligned words and a funnel shift
      uint32_t x[C];
      {
        uint32_t lo[C], hi[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          long long q = p0 + a.offsets[j];
          if (q >= n) q -= n;
          const uint32_t* wd = reinterpret_cast<const uint32_t*>(
              sctl + a.cinv[j] * SC + (q & ~3LL));
          lo[j] = wd[0];
          hi[j] = wd[1];
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          long long q = p0 + a.offsets[j];
          if (q >= n) q -= n;
          x[j] = __funnelshift_r(lo[j], hi[j], (uint32_t)(q & 3) * 8u);
        }
      }
      uint32_t seen[W][4], inj[W][4], gd[4], ma[4], fc[4], fl[4];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        fr_ld(fr, fstride, FR_SEEN + w, g, seen[w]);
        fr_ld(fr, fstride, FR_INJ + w, g, inj[w]);
      }
      fr_ld(fr, fstride, FR_GD, g, gd);
      fr_ld(fr, fstride, FR_MA, g, ma);
      fr_ld(fr, fstride, FR_FC, g, fc);
      fr_ld(fr, fstride, FR_FL, g, fl);
      uint32_t alive[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        alive[i] = (!FAULTS || (fl[i] & FL_ALIVE)) ? 0xFFFFFFFFu : 0u;
      }

      // the handshake bits of each peer, edge j at bit j
      uint32_t graft_recv[4], prune_recv[4], a_recv[4];
      {
        uint32_t gl = 0u, gh = 0u, pl = 0u, ph = 0u, al = 0u, ah = 0u;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const uint32_t gb = (x[j] >> CTRL_GRAFT) & 0x01010101u;
          const uint32_t pb = (x[j] >> CTRL_DROP) & 0x01010101u;
          const uint32_t ab = (x[j] >> CTRL_A) & 0x01010101u;
          if (j < 8) {
            gl |= gb << j; pl |= pb << j; al |= ab << j;
          } else {
            gh |= gb << (j - 8); ph |= pb << (j - 8); ah |= ab << (j - 8);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t sel = (uint32_t)i | ((uint32_t)(i + 4) << 4);
          graft_recv[i] = __byte_perm(gl, gh, sel) & ALL;
          prune_recv[i] = __byte_perm(pl, ph, sel) & ALL;
          a_recv[i] = __byte_perm(al, ah, sel) & ALL;
        }
      }

      // both payload words of every edge, kept where the ctrl bytes ask
      // for them (unconditional reads: no second round trip after the
      // ctrl words)
      uint32_t heard[W][4];
#pragma unroll
      for (int w = 0; w < W; ++w) {
#pragma unroll
        for (int i = 0; i < 4; ++i) heard[w][i] = 0u;
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        long long q0 = p0 + a.offsets[j];
        if (q0 >= n) q0 -= n;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t ctl = x[j] >> (8 * i);
          const bool fwd_on = ((ctl >> CTRL_OUT) & 1u) != 0u;
          const bool gsp_on = ((ctl >> CTRL_TGT) & 1u) != 0u;
          const long long q = q0 + i;
          if constexpr (TEL) {
            // the receive kernel's tallies (receive_body.cuh): sent words
            // before the alive mask, received, served and requested after
            const bool adv_on = ((ctl >> CTRL_ADV) & 1u) != 0u;
            int req_c = 0;
            bool adv_nz = false;
            {
#pragma unroll
              for (int w = 0; w < W; ++w) {
                const uint32_t fv = spay[w * SP + q];
                const uint32_t av = spay[(W + w) * SP + q];
                const uint32_t fwd_q = fwd_on ? fv : 0u;
                const uint32_t adv_q = (gsp_on || adv_on) ? av : 0u;
                const uint32_t gsp_q = gsp_on ? adv_q : 0u;
                const uint32_t adv_w = adv_on ? adv_q : 0u;
                const uint32_t sn = seen[w][i];
                const uint32_t got = (fwd_q | gsp_q) & alive[i];
                heard[w][i] |= got & ~sn;
                if (i < nv) {
                  tr[TEL_PAYLOAD] += __popc(fwd_q);
                  tr[TEL_IHAVE_IDS] += __popc(adv_w);
                  tr[TEL_IWANT_SERVED] += __popc(gsp_q & alive[i] & ~sn);
                  tr[TEL_RECV] += __popc(got);
                  req_c += __popc(adv_w & alive[i] & ~sn);
                }
                adv_nz = adv_nz || adv_q != 0u;
              }
            }
            if (i < nv) {
              tr[TEL_IWANT_REQ] += req_c;
              tr[TEL_IHAVE_RPCS] += (adv_on && adv_nz) ? 1 : 0;
              tr[TEL_IWANT_RPCS] += req_c > 0 ? 1 : 0;
            }
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const uint32_t fv = spay[w * SP + q];
              const uint32_t av = spay[(W + w) * SP + q];
              uint32_t got = (gsp_on ? av : 0u) | (fwd_on ? fv : 0u);
              if constexpr (FAULTS) got &= alive[i];  // a down peer hears 0
              heard[w][i] |= got & ~seen[w][i];
            }
          }
        }
      }

      uint32_t mesh_new[4], bo_trig[4], acq[W][4], have_out[W][4], rej[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t grafts = gd[i] & 0xFFFFu, dropped = gd[i] >> 16;
        const uint32_t mesh_sel = ma[i] & 0xFFFFu, wa = ma[i] >> 16;
        uint32_t gr = graft_recv[i], pr = prune_recv[i], ar = a_recv[i];
        if constexpr (FAULTS) {
          // a down receiver processes no inbound control
          gr &= alive[i];
          pr &= alive[i];
          ar &= alive[i];
        }
        const uint32_t accept = gr & wa;
        const uint32_t retract = grafts & ~ar;
        mesh_new[i] = ((mesh_sel | accept) & ~pr) & ~retract;
        bo_trig[i] = dropped | pr | retract;
        const bool subscribed = (fl[i] & 0xFFFFu) != 0u;
        rej[i] = (COLD && (fl[i] & FL_REJ)) ? 0xFFFFFFFFu : 0u;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t h = subscribed ? heard[w][i] : 0u;
          acq[w][i] = h | inj[w][i];
          have_out[w][i] = seen[w][i] | h;
        }
      }

      if constexpr (TEL) {
        // the new acquisitions (the delivered ones by latency bucket in a
        // pass of their own, below)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool subscribed = (fl[i] & 0xFFFFu) != 0u;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if (i < nv) tr[TEL_NEW_IDS] += __popc(subscribed ? heard[w][i]
                                                             : 0u);
          }
        }
        st4(a.meshrow + tn, p0, nv, mesh_new);
      }

      // acquisitions, possession and the mcache ring slot tick mod Hg
      // (at window entry the other ring rows carry over too)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        st4(a.acq + ((long long)t * W + w) * n, p0, nv, acq[w]);
        st4(a.have + w * n, p0, nv, have_out[w]);
        for (int h = 0; h < hg; ++h) {
          uint32_t* row = a.rec + (h * W + w) * n;
          if (h == ring_slot) {
            st4(row, p0, nv, acq[w]);
          } else if (first) {
            uint32_t r[4];
            ld4(a.rec_in + (h * W + w) * n, p0, nv, r);
            if constexpr (COLD) {
#pragma unroll
              for (int i = 0; i < 4; ++i) r[i] &= ~rej[i];
            }
            st4(row, p0, nv, r);
          } else if (COLD && (rej[0] | rej[1] | rej[2] | rej[3]) != 0u) {
            uint32_t r[4];    // a rejoiner's ring comes back clear
            ld4(row, p0, nv, r);
#pragma unroll
            for (int i = 0; i < 4; ++i) r[i] &= ~rej[i];
            st4(row, p0, nv, r);
          }
        }
      }

      // the backoff write's edges, for phase A of the next tick (or the
      // window's last pass)
      fr_st(fr, fstride, FR_GD, g, bo_trig);

      // next tick's gossip targets: Bernoulli(k/|elig|), or the exact
      // uniform k-subset
      uint32_t tgt_out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long p = p0 + i;
        const uint32_t elig = (fc[i] >> 16) & ~mesh_new[i] & ~(fc[i] & 0xFFFFu)
                              & (fl[i] & 0xFFFFu);
        const int n_el = __popc(elig);
        const int n_fac = (int)__fmul_rn(a.gossip_factor, (float)n_el);
        const int n_go = a.d_lazy > n_fac ? a.d_lazy : n_fac;
        uint32_t tg = 0u;
        if constexpr (EXACTK) {
          tg = select_bits<C>(elig, n_go, a.seeds[t][3], p, a.stride);
        } else {
          const float p_g = fminf(
              1.0f, __fdiv_rn((float)n_go, (float)(n_el > 1 ? n_el : 1)));
#pragma unroll
          for (int c = 0; c < C; ++c) {
            tg |= (uint32_t)(gossip::lane_u(a.seeds[t][3], c, p, a.stride)
                             < p_g) << c;
          }
        }
        tgt_out[i] = elig & tg;
      }

      st4(a.mesh, p0, nv, mesh_new);
      st4(a.tgt, p0, nv, tgt_out);
    }
    if constexpr (TEL) {
      // the delivered acquisitions (this tick's, just written by this
      // thread: acq & dlv) by latency bucket: each warp's groups in step,
      // a bucket's count summed across the warp and added by one shared
      // atomic (a shared atomic a peer and bucket contends across the
      // block's 16 warps)
      const int lane = threadIdx.x & 31;
      for (int g0 = threadIdx.x - lane; n_lat > 0 && g0 < groups;
           g0 += blockDim.x) {
        const int g = g0 + lane;
        uint32_t dw[W][4];
        bool any_dw = false;
#pragma unroll
        for (int w = 0; w < W; ++w) {
#pragma unroll
          for (int i = 0; i < 4; ++i) dw[w][i] = 0u;
          if (g < groups) {
            const long long p0 = b0 + 4 * g;
            const int nv = (int)(n - p0 < 4 ? n - p0 : 4);
            uint32_t dl[4];
            ld4(a.acq + ((long long)t * W + w) * n, p0, nv, dw[w]);
            ld4(a.dlv + w * n, p0, nv, dl);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dw[w][i] &= dl[i];
              any_dw = any_dw || dw[w][i] != 0u;
            }
          }
        }
        if (__any_sync(0xFFFFFFFFu, any_dw)) {
          for (int b = 0; b < n_lat; ++b) {
            int c = 0;
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const uint32_t m =
                  a.lat_masks[((long long)t * n_lat + b) * W + w];
#pragma unroll
              for (int i = 0; i < 4; ++i) c += __popc(dw[w][i] & m);
            }
            c = __reduce_add_sync(0xFFFFFFFFu, c);
            if (lane == 0 && c != 0) atomicAdd(&s_tel[TEL_ROWS + b], c);
          }
        }
      }
      // the block's partial of each row: warp shuffles, one shared
      // atomic per warp and row, then one global atomic per block and
      // row into the tick's tally
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
  // the window's last backoff write and gate row
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const long long p0 = b0 + 4 * g;
    const int nv = (int)(n - p0 < 4 ? n - p0 : 4);
    uint32_t trig[4], gate[4];
    fr_ld(fr, fstride, FR_GD, g, trig);
    backoff_step<C>(a.ticks == 1 ? a.bo_in : a.bo, a.bo, n, p0, nv, trig,
                    a.backoff_restart, gate);
    st4(a.bog, p0, nv, gate);
  }
}

template <int C, int W, bool EXACTK>
__global__ void __launch_bounds__(THREADS, 1)
fused_window_kernel(const FusedArgs a) {
  extern __shared__ uint4 smem_raw[];
  fused_body<C, W, EXACTK, false, false, false>(
      a, reinterpret_cast<uint32_t*>(smem_raw));
}

// The window under a fault schedule: the per-tick alive, send-ok and
// cand-alive rows, and (COLD) the rejoin row, each read by the peer's own
// thread at (t, p) in phase A.
template <int C, int W, bool EXACTK, bool COLD>
__global__ void __launch_bounds__(THREADS, 1)
fused_window_kernel_faults(const FusedArgs a) {
  extern __shared__ uint4 smem_raw[];
  fused_body<C, W, EXACTK, true, COLD, false>(
      a, reinterpret_cast<uint32_t*>(smem_raw));
}

// The window with its telemetry rows, without and with fault rows.
template <int C, int W, bool EXACTK>
__global__ void __launch_bounds__(THREADS, 1)
fused_window_kernel_tel(const FusedArgs a) {
  extern __shared__ uint4 smem_raw[];
  fused_body<C, W, EXACTK, false, false, true>(
      a, reinterpret_cast<uint32_t*>(smem_raw));
}

template <int C, int W, bool EXACTK, bool COLD>
__global__ void __launch_bounds__(THREADS, 1)
fused_window_kernel_faults_tel(const FusedArgs a) {
  extern __shared__ uint4 smem_raw[];
  fused_body<C, W, EXACTK, true, COLD, true>(
      a, reinterpret_cast<uint32_t*>(smem_raw));
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

// The launch: one block per multiprocessor, each P = ceil(N / SMs)
// rounded up to a multiple of 4 peers; the front in shared memory where
// (2W + 4) 4 P bytes and the tally fit in a block's opt-in shared memory,
// else in device memory.  out: blocks, threads, peers a block, dynamic
// shared memory a block (bytes), front in device memory (0 / 1).
struct Plan {
  int blocks, threads, peers, smem, front_global;
};

template <int C, int W, bool EXACTK, bool FAULTS, bool COLD, bool TEL>
int make_plan(long long n, int tel_lat_buckets, Plan* pl) {
  int sms = 0, optin = 0, dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long per = (n + sms - 1) / sms;
  const long long peers = (per + 3) / 4 * 4;
  const long long tel_bytes =
      TEL ? ((long long)(TEL_ROWS + tel_lat_buckets + 2) * 4 + 15) / 16 * 16
          : 0;
  const long long front_bytes = (long long)front_words(W) * 4 * peers;
  pl->threads = THREADS;
  pl->peers = (int)peers;
  pl->blocks = (int)((n + peers - 1) / peers);
  pl->front_global = front_bytes + tel_bytes > optin;
  pl->smem = (int)(pl->front_global ? tel_bytes : front_bytes + tel_bytes);
  const void* fn = window_kernel<C, W, EXACTK, FAULTS, COLD, TEL>();
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl->smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        THREADS, pl->smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < pl->blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

template <int C, int W, bool EXACTK, bool FAULTS, bool COLD, bool TEL>
int launch_variant(const FusedArgs& args, cudaStream_t s, Plan* only) {
  Plan pl;
  int err = make_plan<C, W, EXACTK, FAULTS, COLD, TEL>(
      args.n, args.tel_lat_buckets, &pl);
  if (err != 0 || only != nullptr) {
    if (only != nullptr) *only = pl;
    return err;
  }
  if (pl.front_global && args.front == nullptr)
    return (int)cudaErrorInvalidValue;
  FusedArgs a = args;
  a.peers = pl.peers;
  a.front_global = pl.front_global;
  void* kargs[] = {(void*)&a};
  err = (int)cudaLaunchCooperativeKernel(
      window_kernel<C, W, EXACTK, FAULTS, COLD, TEL>(), dim3(pl.blocks),
      dim3(pl.threads), kargs, pl.smem, s);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

template <int C, int W, bool EXACTK, bool TEL>
int launch_faults(const FusedArgs& a, cudaStream_t s, Plan* only) {
  if (!a.faults)
    return launch_variant<C, W, EXACTK, false, false, TEL>(a, s, only);
  if (a.cold) return launch_variant<C, W, EXACTK, true, true, TEL>(a, s, only);
  return launch_variant<C, W, EXACTK, true, false, TEL>(a, s, only);
}

template <int C, int W, bool EXACTK>
int launch_targets(const FusedArgs& a, cudaStream_t s, Plan* only) {
  if (a.telemetry) return launch_faults<C, W, EXACTK, true>(a, s, only);
  return launch_faults<C, W, EXACTK, false>(a, s, only);
}

template <int C, int W>
int launch(const FusedArgs& a, cudaStream_t s, Plan* only) {
  if (a.exact_k) return launch_targets<C, W, true>(a, s, only);
  return launch_targets<C, W, false>(a, s, only);
}

int dispatch(const FusedArgs* args, int c, int w, void* stream,
             Plan* only) {
  cudaStream_t s = (cudaStream_t)stream;
  if (c == 16 && w == 1) return launch<16, 1>(*args, s, only);
  if (c == 16 && w == 2) return launch<16, 2>(*args, s, only);
  if (c == 8 && w == 1) return launch<8, 1>(*args, s, only);
  if (c == 8 && w == 2) return launch<8, 2>(*args, s, only);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// c in {8, 16}, w in {1, 2}.  Returns the CUDA error code of the launch:
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident
// (the wrapper raises the named refusal; nothing runs),
// cudaErrorInvalidValue for a shape with no instantiation (the wrapper
// refuses those first) or a front that needs the device-memory scratch
// the caller did not give.
extern "C" int gossip_fused_window(const FusedArgs* args, int c, int w,
                                   void* stream) {
  if (args->n <= 0 || args->ticks <= 0) return 0;
  if (args->ticks > MAX_WINDOW) return (int)cudaErrorInvalidValue;
  return dispatch(args, c, w, stream, nullptr);
}

// The launch the window would make for ``args`` (the kernel variant its
// flags select) at shape (c, w): out = {blocks, threads, peers a block,
// dynamic shared memory a block, front in device memory}; nothing runs.
extern "C" int gossip_fused_launch_config(const FusedArgs* args, int c,
                                          int w, int* out) {
  Plan pl{};
  const int err = dispatch(args, c, w, nullptr, &pl);
  out[0] = pl.blocks;
  out[1] = pl.threads;
  out[2] = pl.peers;
  out[3] = pl.smem;
  out[4] = pl.front_global;
  return err;
}
