"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the device: torch's name and count, nvidia-smi's name and power limit;
2. build the ten CUDA sources from ``go_libp2p_pubsub_tpu_torch/csrc``
   (one nvcc per source, concurrently: select, receive, its telemetry
   twin receive_tel, their knob twins receive_knobs and
   receive_tel_knobs, the delay mode's receive_delays, the replica
   stack's delay mode receive_delays_reps and telemetry tally
   receive_tel_reps and receive_tel_knobs_reps, fused), printing ptxas'
   register and spill lines and each source's compile seconds on a line
   of its own;
3. the select kernel against its plain version at 1,000,000 peers,
   C = 16, seeded: bit-identical; both timed with CUDA events;
4. the receive kernel against its plain version at the flagship shapes
   (N = 1,000,000, C = 16, W = 1), on seeded random operands and on the
   operands of a real tick of the 1M-peer sim: every output
   bit-identical; both timed;
5. the main path: the scored GossipSub v1.1 flagship (1,000,000 peers,
   100 topics, C = 16, M = 32, ScoreSimConfig(), seed 0) through
   make_gossip_sim / make_gossip_step / gossip_run, 100 warm-up and 300
   timed heartbeats, with the benchmark's mesh and delivery gates; the
   kernels' launch counts are reset just before and read just after;
5a. the receive kernel's attack variant against its plain version at
   N = 1,000,000, C = 16, W = 1 with all three attack options on, on
   seeded random operands (a fifth of the peers carrying the sybil word)
   and on the operands of a real tick of the 1M-peer adversarial sim
   after warm-up: every output bit-identical; both timed;
5b. the adversarial main path: the JAX package's adversarial benchmark
   configuration (the flagship with 20% sybils running IHAVE
   broken-promise spam and the IWANT flood, honest origins) through
   make_gossip_sim / make_gossip_step / gossip_run, 100 warm-up and 300
   timed heartbeats, with the benchmark's honest mesh-degree, honest
   delivery and IWANT-containment gates and the attacks live; the
   attack variant launched once per tick, counts reset just before and
   read just after;
5c. the receive kernel's full variant (the router-surface options)
   against its plain version at N = 1,000,000, C = 16, W = 1: flood
   publishing, exact-k targets, the PX trigger word and the shared-IP
   gater with the three attack options, on seeded random operands and on
   the operands of two real ticks of the 1M-peer everything-on sim
   (tick 3, where the trigger word is live, and a publishing tick after
   warm-up, there also as the main path runs it, with Bernoulli
   targets): every output bit-identical, the trigger word too; both
   timed; and exact-k alone on the flagship's options, the same two
   ways (on phase 4's operands);
5d. the everything-on main path: the flagship with topic_score_cap=50,
   20% sybils four to an address running both gossip-repair attacks,
   flood publishing, PX rotation over 14 of the 16 candidates and a
   sparse direct overlay (go_libp2p_pubsub_tpu_torch/everything.py)
   through make_gossip_sim / make_gossip_step / gossip_run, 100 warm-up
   and 300 timed heartbeats, with the adversarial path's three gates and
   every option shown live (the active set rotated, no direct edge ever
   in a mesh, some ctrl byte carrying CTRL_FLOOD during warm-up, the
   same-IP words present and some sybil's static score below 0); the
   full variant launched once per tick and no other receive variant,
   counts reset just before and read just after;
5e. exact-k on the fused path: the fused-window kernel with exact-k
   targets against its plain version at the resident shapes, one window;
   timed; then 64 heartbeats of the exact-k resident configuration
   through make_fused_window / gossip_run_fused (counts reset just
   before and read just after) against the same ticks stepped one by one
   (the unscored full variant), equal digests;
5f. the receive kernel's paired variant against its plain version at
   N = 1,000,000, C = 16, W = 1: the three attack options, PX and the
   shared-IP gater on (and, on random operands, flood publishing and
   exact-k too), on seeded random operands with odd and even edges and on
   the operands of a real tick of the 1M-peer paired everything-on sim
   after warm-up with some slot-B GRAFT and some GRAFT or PRUNE on an odd
   edge live (the first such from tick 60, where opportunistic grafting
   wakes the settled meshes; there also as the main path runs it): every
   output
   bit-identical, slot B's mesh, backoff, time in mesh and gate row too;
   both timed; then the unscored paired variant the same two ways at the
   resident shapes, its real tick the last of 64 heartbeats of an
   unscored paired resident sim through make_gossip_sim /
   make_gossip_step / gossip_run (counts reset just before and read just
   after: the unscored paired variant launched once per tick, no other
   receive variant), both slots' mean mesh degree >= Dlo;
5g. the fifth slice's main path: the JAX package's everything-on benchmark
   as written (bench_suite.py bench_gossipsub_v11_everything: paired
   topics, topic_score_cap=50, 20% sybils four to an address running both
   gossip-repair attacks, PX over 14 of the 16 candidates, the direct
   overlay; go_libp2p_pubsub_tpu_torch/everything.py ``paired=True``)
   through make_gossip_sim / make_gossip_step / gossip_run, 100 warm-up
   and 300 timed heartbeats, with the benchmark's three gates (the
   delivery gate over both residue classes of a topic), paired topics
   shown live (a slot-B mesh, slot-B time in mesh, an odd edge in some
   slot-B mesh; the honest slot-B mean degree >= Dlo, which the
   reference meets at 100,000 peers) and phase 5d's live checks (the
   active set rotated, no direct edge ever in a mesh, the same-IP words and a
   sybil static score below 0); the paired variant launched once per
   tick and no other receive variant, counts reset just before and read
   just after; then 20 more heartbeats under torch.profiler for the
   device's idle share;
5h. the receive kernel under faults against its plain version, each
   family at N = 1,000,000, C = 16, W = 1 (the flagship's scored
   options, the attack options with the IWANT flood's flood_ok word, the
   full variant, paired) and the unscored one at the resident shapes:
   on seeded random operands with a tenth of the peers down, and on the
   operands of a real tick of a 1M-peer sim under the churn benchmark's
   schedule (the benchmark's own sim for the flagship options, the
   adversarial, everything-on and paired everything-on sims with it
   attached for the others; tick 130, inside a churn wave and the
   partition, with some peer down and some edge cut; unscored, tick 30
   of the resident configuration under the same kind of schedule), each
   faulted variant launched once per tick of the run to it and no other
   receive variant: every output bit-identical; both timed;
5i. the slice's main path: the JAX package's churn benchmark as written
   (bench_suite.py bench_gossipsub_v11_churn: the flagship under 10%
   churn in three staggered waves, 2% link loss and a 30-tick half/half
   partition; go_libp2p_pubsub_tpu_torch/churn.py) through
   make_gossip_sim / make_gossip_step / gossip_run + gossip_run_curve,
   100 warm-up and 150 timed heartbeats: its three rows (heartbeats/s,
   the delivery fraction of the settled messages, the probes' median
   recovery ticks) and its two gates (fraction above 0.80, some probe
   recovered), the faults shown live (peers down, edges cut on tick
   130, the fraction below 1), the faulted receive variant launched once
   per tick and no other receive variant, counts reset just before and
   read just after; one tick's fault masks (the link draw) timed alone;
   then 20 more heartbeats under torch.profiler for the idle share;
5j. the fused-window kernel under faults and cold restart against its
   plain version at N = 1,048,576, T = 8, one window of the resident
   configuration under the churn benchmark's kind of schedule (cold
   restart on, rejoins inside the window), timed, the window's fault rows
   timed apart; then 64 heartbeats on fused windows (counts reset just
   before and read just after: the faulted fused kernel once per window,
   nothing else) against the same ticks one by one, equal digests, with
   rejoins inside the 64 ticks;
5k. the receive kernel's telemetry variants (the tally and L = 16
   latency-bucket rows) against their plain versions, each family with
   and without faults: the flagship's scored options, the attack options,
   the full variant and paired (scored) at N = 1,000,000, C = 16, W = 1,
   unscored and unscored paired at the resident shapes; on seeded random
   operands and on the operands of a real tick of the family's sim
   stepped by the telemetry step (clean: tick 40, resident tick 12;
   faulted, under the churn benchmark's kind of schedule: tick 130,
   resident tick 30), the telemetry variant launched once per tick of
   the run to it and no other: every output bit-identical, the tally rows
   too; the variant, its plain version and its variant without telemetry
   timed on the real tick;
5l. the slice's main path: the JAX package's telemetry-kernel benchmark
   as written (bench_suite.py bench_gossipsub_telemetry_kernel: the
   flagship at 1,024,000 peers, telemetry off through gossip_run, then on
   through telemetry_run, each 100 warm-up and 3 x 100 timed heartbeats;
   go_libp2p_pubsub_tpu_torch/telemetry_flagship.py): both rates, the
   overhead, the control-overhead ratio and its totals; the flagship's
   gates on both runs, equal digests of every state leaf after the two
   runs, some payload sent and a finite ratio, the flagship variant once
   per tick on the off-run and its telemetry variant once per tick on the
   on-run, no other receive variant, counts reset just before each run
   and read just after; then that telemetry variant (no latency rows)
   against its plain version at the benchmark's shapes, on seeded random
   operands and on a real tick of the benchmark's sim stepped by its
   telemetry step (two ticks after its first publish from tick 40):
   every output bit-identical, the tally too; timed there for the
   kernel line;
5m. the fused-window kernel with telemetry against its plain version at
   N = 1,048,576, T = 8, on one window of the resident configuration
   (mesh formation) and one under the churn benchmark's kind of schedule
   with cold restart: every output bit-identical, each tick's mesh row
   and tally too; timed, and timed again without the latency rows and
   without telemetry; then 64 heartbeats of each through
   gossip_run_frames_fused (the telemetry fused kernel once per window,
   nothing else) against the same ticks through the per-tick telemetry
   step: frames equal field by field, equal digests;
5n. the receive kernel's knob variants (the knob vector, ``+knobs``)
   against their plain versions, each family with and without faults:
   the flagship's scored options (also with telemetry, L = 16), the
   attack options (the IHAVE spam; the IWANT flood too on the random
   operands), the full variant (also with telemetry) and paired (scored)
   at N = 1,000,000, C = 16, W = 1, unscored and unscored paired at the
   resident shapes; on seeded random operands with a non-default knob
   vector and on the operands of a real tick of the family's sim armed at
   a knob point (the seven kernel knobs off their defaults; the IWANT-flood
   sims, full and paired, at the hardened defense through score_knobs)
   and stepped by its step (clean: tick 40, telemetry two ticks after a
   publish, resident tick 12; faulted, under the churn benchmark's kind of
   schedule: tick 130, resident tick 30), the knob variant launched once
   per tick of the run to it and no other: every output bit-identical;
   the variant, its plain version and its twin without knobs timed on the
   real tick;
5o. the slice's main path: the knob sweep (go_libp2p_pubsub_tpu_torch/
   knob_sweep.py) at 1,000,000 peers: the flagship at baked, ref, d8,
   gf50_bo30, d5 and gf40, the IHAVE-spam configuration at baked and the
   tournament's defenses plus hard, the churn benchmark at baked and the
   fault knob at 0.02 and 0.05 (with a P7 weight of -40); each point armed
   on one built sim and run by one step (100 warm-up + 100 timed
   heartbeats; churn 100 + 150), counts reset just before each point and
   read just after: each knob point's knob variant once per tick and no
   other, baked its twin; every point's gates; ref's, the reference
   defense's and the churn point at 0.02's digests of every state leaf
   equal to baked's; each point's heartbeats/s beside baked's;
5p. the receive kernel's delay mode (``+delays``) against its plain
   version (``delay_variants``): the flagship's scored options, the attack
   options tracking promises and the full variant (exact-k, PX, the
   shared-IP gater) at N = 1,000,000, C = 16, W = 1, unscored at the
   resident shapes, each without and with knobs; on seeded random
   operands and on a real tick of the family's delayed sim
   (DelayConfig(4, 2, 8)) with arrivals and retractions (attack: also
   broken-promise adverts) live, the variant launched once per tick of
   the run to it and no other: every output bit-identical; the variant,
   its plain version and its delay-free twin (the same tick of the sim
   without delays) timed;
5q. the slice's main path: the JAX package's pipelined-gossip benchmark
   (go_libp2p_pubsub_tpu_torch/pipelined.py) as written at 100,000 peers
   and at full width, 1,000,000, one point after another
   (``pipelined.run_sequential``; 5ad runs it as one dispatch): the points
   base1, base2, base4 and base4j2 armed one after another on one built
   sim (DelayConfig(1, 0, 8), the latency histogram on) and run 48 ticks
   from build through telemetry_run, counts reset just before each point
   and read just after: every point's ``scored+delays+knobs`` once a tick
   and no other receive variant, no kernel library built after the first
   point; the
   rows (delivery fraction, latency percentiles, histogram, the p99
   stretch, the replica heartbeats/s, peak memory) and the benchmark's two
   gates; then at 1,000,000 peers the K = 1 identity (DelayConfig(1, 0,
   1) on the flagship for 48 ticks: the digest of every leaf both runs
   carry equal to the delay-free flagship's) and the steady state
   (DelayConfig(4, 2, 8) beside no delays, 100 + 100 heartbeats each, then
   20 delayed ones profiled: the device's idle share, the delay ranges and
   the top device operations);
5r. each per-tick family's step with the invariant checker on
   (``armed_families``): the flagship, the unscored resident
   configuration, adversarial, everything-on, paired everything-on and
   unscored paired at 50,000 peers, each clean, under the churn
   benchmark's kind of schedule, with every telemetry group and at a knob
   point, and the delayed flagship, attack, full and unscored sims; each
   armed and run 24 ticks on the card, then tick 24 on the card (one
   receive launch), on the CPU from the same state and on the card
   without the checker: every state leaf and the two carry scalars equal
   the CPU's, every other leaf, the delivered words and the frames the
   unarmed step's, the report clean; then the reference's seeded mesh
   defect trips mesh-subscription on tick 0, on the card as on the CPU;
5s. the slice's main path: the JAX package's invariants-kernel benchmark
   as written (bench_suite.py bench_gossipsub_invariants_kernel: the
   flagship at 1,024,000 peers, the checker off, then armed with
   InvariantConfig(), each 100 warm-up and 100 timed heartbeats;
   go_libp2p_pubsub_tpu_torch/invariants_flagship.py): both rates, the
   overhead, the report with no bits, the flagship's gates on both runs,
   equal digests of every state leaf but the carry, the flagship variant
   once per tick and the select kernel as often on both runs, no other
   receive variant, counts reset just before each run and read just
   after; then (``invariant_path_kernels``) the receive and select kernels
   at the path's shapes (N = 1,024,000, whole 256-peer blocks, where
   phases 3 and 4 hold them at 1,000,000 with a tail block) against their
   plain versions, on seeded random operands and on every call of a busy
   tick of the benchmark's sim stepped by its armed step: every output
   bit-identical; both timed on the tick;
5t. the select kernel's C = 32 instantiation against its plain version:
   seeded operands at N = 1,000,000 (bit 31 live) and every call of a
   real tick of phase 5w's C = 32 sim (50,000 peers, after 10
   heartbeats): bit-identical; both timed on the seeded operands;
5u. the receive loops' combined form at full width
   (go_libp2p_pubsub_tpu_torch/loops_flagship.py ``byzantine``: the
   tournament's byzantine x reference cell at the flagship's widths,
   1,000,000 peers x 100 topics, C = 16, M = 32, 20% mutating relays,
   honest origins, the checker armed), 50 warm-up and 100 timed
   heartbeats, counts reset just before and read just after: every
   settled message at every honest member of its topic, P4 on some edge
   from a mutator and on no other edge, the report clean, the receive
   kernel never launched and the select kernel launched; the rate, a
   10-tick profile (device busy ms a tick, idle share, launches a tick),
   peak memory;
5v. the loops' split form at full width (``p3``: the flagship with the
   JAX package's P3/P3b test configuration and one message a tick), the
   same counts and records: delivery of the settled messages, P3 credit on
   a mesh edge, a P3b penalty somewhere, no receive-kernel launch;
5w. the split loops at C = 32 (``wide``: 50,000 peers, 30 ticks): the
   digest of every state leaf on the card equal to the CPU's;
5x. the JAX package's attack x defense tournament as written
   (go_libp2p_pubsub_tpu_torch/tournament.py ``run_tournament(20000, 20,
   24, 150)``) as one dispatch: its 20 cells stacked on a replica axis,
   one step a tick, every row equal to TOURNEY_r12.json's, no cell with
   an invariant bit, no receive-kernel launch, B3's launches for the
   grid equal to one cell's alone; the byzantine x reference cell in the
   grid, alone on the card and on the CPU, one digest; the replica
   heartbeats/s, and 10 profiled ticks of the grid and of one cell
   (launches a tick, device busy time, idle share);
5y. B3 with a replica axis against its plain version and against one
   launch a replica: 4 x 1,000,000 seeded peers with distinct seeds at
   C = 16 and C = 32, the tournament's 20 x 20,000 and 20 x 20,002 (a
   quad straddles two replicas): bit-identical; each timed beside the
   single launches;
5z. the JAX package's batched flagship benchmark as written
   (go_libp2p_pubsub_tpu_torch/batched_flagship.py: 4 replicas of the
   1M-peer flagship, mesh seeds 0-3, 100 + 3 x 100 ticks on one step a
   tick): every replica's gates, B1 launched once a batched tick and B3
   as often as a seed-0 replica alone over the same ticks, replica 0's
   digest equal to that replica alone, the replica heartbeats/s, 20
   profiled ticks, the peak memory; then B1 with a replica axis (the
   flagship's options, with knobs, under faults, the attack options,
   unscored, unscored under faults) on a real tick of it and on seeded
   operands whose replicas differ (unscored at 1,048,576): each
   bit-identical to its plain version and to four single launches, timed
   beside them; and each of those families through the user's batched
   runner at 4 x 100,000 peers for 10 ticks (their launches);
5aa. ``tune_defense`` at the tournament's shape (coordinate descent
   over TUNE_SPACE, one batched grid a step): its dict, its wall time,
   and its tuned point's worst case, column mean and eclipse takeover
   beside the JAX package's record (0.9139, 0.98278, 0.2987);
5ab. B1's delay mode with a replica axis (csrc/receive_delays_reps.cu:
   the flagship's scored options, the attack options tracking promises,
   unscored; each without and with knobs): one launch for four replicas on
   a real delayed batched tick (the pipelined benchmark's four points
   stacked at 1,000,000 peers, stepped to the first tick from 8 on with
   arrivals and retractions live; the operands adapted to the family, its
   extra operands each replica's own), on seeded random operands at
   1,000,000 and at C = 8 on a ring of 100,003 peers: bit-identical to its
   plain version and to four single launches; timed beside them;
5ac. B1's telemetry tally with a replica axis (csrc/receive_tel_reps.cu,
   receive_tel_knobs_reps.cu: the same three families, each without and
   with faults and knobs, L = 16): the same three ways, the real tick 5z's
   batched flagship stepped with telemetry; the [4, 8 + L] tally equal to
   the four single launches' tallies;
5ad. the slice's main path: the pipelined benchmark as the JAX package
   runs it (``pipelined.run``: the four points built with their knobs,
   stacked, 48 ticks as ONE dispatch of telemetry_run_batch) at 100,000
   and 1,000,000 peers, counts reset just before and read just after: the
   rows, the gates, the p99 stretch, the replica heartbeats/s, the peak
   memory; the delayed knob stack variant once a batched tick (48) and no
   other receive variant, B3 launched, no library built during the run;
5ae. every replica of the 100,000-peer batched run against its point run
   alone (5q): equal digests of every state leaf, equal histograms, B3
   launched as often a batched tick as for one point; then each stack
   kernel of 5ab and 5ac through the user's batched runner
   (gossip_run_batch / telemetry_run_batch) at 4 x 20,000 peers for 10
   ticks, once a tick and no other receive variant (their launches);
5af. FloodSub (models/floodsub.py; the reference leaves it to XLA, so no
   hand-written kernel runs): (a) the circulant and gather cores at
   20,000 peers, 40 ticks, in each form of floodsub_flagship.FORMS
   (plain; churn waves, 2% link loss and a partition window; with
   TelemetryConfig(); with DelayConfig(4, 2, 8); armed with the checker)
   on the card and on the CPU (the CPU's in a child process started
   during phase 2, once five sources are built): every digest of state
   leaves, delivered words and frame fields equal; (b)
   floodsub_flagship.run at 1,000,000
   peers on both cores (50 + 3 x 100 ticks): gates, heartbeats/s, peak
   memory, reach_by_hops at 16 hops, a profile of 20 more ticks;
5ag. RandomSub (models/randomsub.py): (a) the same matrix for the
   circulant step (C = 128, 20,000 peers) and the dense step (1,000
   peers, two topics); (b) randomsub_10k.run(dense=True), the JAX
   package's RandomSub-10k benchmark as written (10,000 peers, C = 128,
   the dense step, 50 + 3 x 100 ticks, every message at all 10,000);
   (c) the circulant step at 1,000,000 peers, 100 topics, C = 128, the
   same ticks and full reach; each with heartbeats/s, peak memory, a
   20-tick profile (idle share, launches a tick).  Across 5af and 5ag
   the receive, fused and select kernels launch zero times and no
   library is built (counts reset before, read after);
5ah. the RPC probe (make_gossip_step(rpc_probe=True)) at 20,000 peers on
   every per-tick family (trace_export.PROBE_FORMS: the flagship, the
   unscored resident configuration, the adversarial one, everything-on,
   paired everything-on and unscored paired, each clean, under the churn
   benchmark's kind of schedule, faulted with every telemetry group, at a
   knob point and faulted with the checker armed; the delayed flagship,
   attack, full and unscored sims with the probe line; the receive
   loops' byzantine, P3 and C = 32 forms), 8 ticks each: the digest of
   every tick's snapshot and the end state on the card equal to the
   CPU's (the CPU's in 5af's child process, after the build), and
   the card's end state equal to the probe-free step's but for the probe
   line; then the trace-export pipeline at 20,000 peers (collected on
   the card, exported in a child process) writes the pb bytes the CPU's
   run writes (SHA-256);
5ai. the slice's main path: the JAX package's trace-export benchmark as
   written (bench_suite.py _trace_export_run, unpadded; trace_export.py:
   100,000 peers, 100 topics, M = 16, C = 16, ScoreSimConfig(), two
   invalid messages from sybil origins, ~0.2% of the peers down, 2% link
   loss; telemetry for 6 ticks, acquisition snapshots for 6, the RPC
   probe for 2), collected on the card right after phase 2 (counts reset
   just before, read just after: B1 and B3 launched, B2 not; B1's
   variants printed), its host-side export in a child process while the
   later phases run: 13/13 event types, the trace's SHA-256 equal to the
   reference's (trace_export.REFERENCE_SHA256), the port's tracestat
   --check against the committed OBS_r10.json clean; its rows
   (n_events, bytes_total, collect_s, export_s, write_s, events/s,
   bytes/event, peak memory);
5aj. the sweep server as written (sweepd_bench.run_sweepd, the JAX
   package's gossipsub_sweepd row: the batched SweepServer at 10,000
   peers, 10 topics, M = 16, 60 ticks, batch 6, the 24 seed replicas then
   the 24 scenarios; counts reset just before and read just after): every
   row equal to the JAX package's (sweepd_bench.REFERENCE_ROWS), all ok,
   no invariant bit, compiles() == 1, the sweep/seed wall ratio <= 2.0,
   no source built by ops/kernels/_build.py; replica heartbeats/s, B3's
   batched launches, B1's (0: the tournament config's cells run on the
   receive loops), the peak memory;
5ak. the kernel server (batch 1) at 512 peers (the benchmark's shape) and
   at 10,000 (the CLI's default shape): rows equal to the JAX package's,
   B1's attacks_faults+knobs variant launched once a tick of every
   scenario and no other variant, no receive-loop pass, each scenario's
   last tick's operands kernel == plain, compiles() == 1 and no source
   built by ops/kernels/_build.py;
5al. the checkpoint benchmark as written at 1,000,000 peers
   (checkpoint_bench.run: single, segmented S2 and S4, kill_resume;
   snapshots in a temporary directory removed after): every digest equal
   to the JAX package's (checkpoint_bench.REFERENCE_DIGEST), the port's
   ckptstat exits 0; snapshot bytes, each row's wall seconds, B1 and B3
   launches;
5am. ckpt_gossip_run_fused at the resident shape: 4 windows of 8 ticks,
   segmented by 2 windows, the stop flag up (interrupted after the first
   segment) then resumed: the unsegmented fused run's digest, B2 launched
   once a window;
5an. the server as a process on the card (sweepd_bench.restart_check, run
   in a thread once select.cu and five more sources are built: its one
   kernel is B3): an uninterrupted run of nine scenarios; a run sent
   SIGTERM after its first batch, which drains and exits 0; a restart on
   the same journal, SIGKILLed with a partial batch journaled; a restart
   that replays it; every scenario's row equal to the uninterrupted run's;
5ao. the serving row as written (serving_bench.run, the JAX package's
   gossipsub_serving row: the multi-tenant front end under 2,000 Zipf /
   Poisson requests over five bucket shapes, the overload burst, a child
   server SIGKILLed mid long scenario and restarted, the cold start
   traced then from runner records), run in a spawned child once
   select.cu is built and joined before phase 3 (the wait printed): the
   accounting identity with no error or transient row, compiles ==
   traced buckets == 5 with evictions, no invariant bit, the overload's
   176 admitted and 124 rejected, the kill digest and the cold rows the
   JAX package's (serving_bench.REFERENCE_KILL_DIGEST,
   REFERENCE_COLD_ROWS), the AOT pass with 0 compiles and 2 loads, B1 0
   and B3 (batched) > 0 launches in the load phase, no source built in
   any child; each phase's seconds and launches;
5ap. the front end at the sweepd CLI's full width (serving_bench.
   full_width: 36 requests over 10,000 / 5,000 / 20,000 peers x 10
   topics x 16 messages, max_buckets 2, batch 6): compiles == the 3
   distinct shapes, evictions, the accounting identity, no error or
   transient row, every row equal to SweepServer.submit's at its
   bucket's shape; served/s, replica heartbeats/s, launches, peak memory;
5aq. the metrics row as written (metrics_bench.run: a `sweepd --multi
   --socket --metrics-port 0` child on the card driven by the port's
   loadgen fleet while scraped mid-flight, the span ledger, delay parity
   on B1 with telemetry and the delayed path): 18 rows for 18 sent, the
   identity on every scrape, the stats row equal to the scrape, a
   non-empty /trace.json, traces == admissions with no open span or
   dropped event, parity 0 and the JAX package's totals
   (metrics_bench.REFERENCE_PARITY);
5ar. the port's servestat --check SERVE_r18.json on 5ao's artifact and
   obsstat --check METRICS_r19.json on 5aq's: their tables and exit
   codes (0);
6. the unscored receive kernel against its plain version at the resident
   configuration's shapes (N = 1,048,576, C = 16, W = 1), on seeded random
   operands and on the operands of a real unscored tick: every output
   bit-identical; both timed;
7. the fused-window kernel against its plain version at N = 1,048,576,
   T = 8, on two real carries, the built state (mesh formation) and the
   state after 12 warm-up ticks: every output bit-identical; both timed
   on the second (CUDA events over back-to-back launches);
8. full-size identity: from one built state, 16 per-tick unscored steps
   and 2 fused windows give equal digests of the carry;
9. the resident main path: the unscored v1.0 configuration of the JAX
   package's resident-window benchmark (1,048,576 peers, 10 topics,
   C = 16, M = 24) through make_fused_window / gossip_run_fused, 64
   warm-up and 256 timed heartbeats (32 windows), with the mesh and
   delivery gates and the fused kernel launched once per window and no
   other kernel; then the per-tick unscored step over the same ticks
   (make_gossip_step(cfg, None) / gossip_run) for comparison, each with
   its counts reset just before and read just after;
10. one line with every main path's heartbeats/s, one line with each
    kernel's time before its redesign (``PARENT_MS``, copied
    from PERF.md, not measured by this run), one JSON line with every
    kernel's numbers as this run measured them;
11. the last line: ``{"ok": true, "device": {...}}``.

It needs no network and imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import multiprocessing
import re
import sys
import tempfile
import time
from pathlib import Path

import torch

WARMUP, TIMED = 100, 300
INV_CHECK_PEERS = 50_000       # 5r: each family's armed tick, card vs CPU
RES_WARMUP, RES_TIMED = 64, 256     # the resident path, 8-tick windows
WIDE_PEERS, WIDE_TICKS = 50_000, 30    # 5t/5w: the C = 32 split loops
TOURNEY_SHAPE = (20_000, 20, 24, 150)  # 5x: the tournament as written
BATCHED_PATH_PEERS, BATCHED_PATH_TICKS = 100_000, 10   # 5z: B1's families
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores


#: each kernel's time on the card before its latest redesign, copied
#: from PERF.md (NVIDIA H100 80GB HBM3, 700 W): printed on a line of its
#: own, labelled as copied, and kept out of the ``kernels`` line, which
#: holds only what this run measured
PARENT_MS = {
    "receive_update": 0.5226, "receive_update_attacks": 0.5680,
    "receive_update_full": 0.7479, "receive_update_paired": 0.9403,
    "receive_update_paired_unscored": 0.2560,
    "receive_update_unscored": 0.1060, "select_k_bits": 0.0462,
    "fused_gossip_update": 1.7991, "fused_gossip_update_exact_k": 1.8765,
    "fused_gossip_update_faults": 1.7642,
    "fused_gossip_update_tel": 2.0044,
    "fused_gossip_update_faults_tel": 3.0160,
    "receive_update_faults": 0.5064, "receive_update_attacks_faults": 0.5694,
    "receive_update_full_faults": 0.7431,
    "receive_update_paired_faults": 0.9259,
    "receive_update_unscored_faults": 0.0972,
    "receive_update_tel": 0.7087, "receive_update_faults_tel": 0.6334,
    "receive_update_attacks_tel": 0.6687,
    "receive_update_attacks_faults_tel": 0.7388,
    "receive_update_full_tel": 0.8338, "receive_update_full_faults_tel": 0.8067,
    "receive_update_paired_tel": 1.2363,
    "receive_update_paired_faults_tel": 1.2423,
    "receive_update_unscored_tel": 0.1199,
    "receive_update_unscored_faults_tel": 0.1326,
    "receive_update_paired_unscored_tel": 0.2736,
    "receive_update_paired_unscored_faults_tel": 0.2457,
    "receive_update_knobs": 0.5259, "receive_update_faults_knobs": 0.5090,
    "receive_update_tel_knobs": 0.6611,
    "receive_update_faults_tel_knobs": 0.6353,
    "receive_update_attacks_knobs": 0.6003,
    "receive_update_attacks_faults_knobs": 0.5845,
    "receive_update_full_knobs": 0.8007,
    "receive_update_full_faults_knobs": 0.8000,
    "receive_update_full_tel_knobs": 0.8975,
    "receive_update_full_faults_tel_knobs": 0.8989,
    "receive_update_paired_knobs": 1.0175,
    "receive_update_paired_faults_knobs": 0.9569,
    "receive_update_unscored_knobs": 0.1059,
    "receive_update_unscored_faults_knobs": 0.0965,
    "receive_update_paired_unscored_knobs": 0.2573,
    "receive_update_paired_unscored_faults_knobs": 0.2358,
    "receive_update_delays": 0.4404, "receive_update_delays_knobs": 0.4429,
    "receive_update_attacks_delays": 0.4473,
    "receive_update_attacks_delays_knobs": 0.4532,
    "receive_update_full_delays": 0.6538,
    "receive_update_full_delays_knobs": 0.6692,
    "receive_update_unscored_delays": 0.0864,
    "receive_update_unscored_delays_knobs": 0.0866,
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _events_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, reps: int) -> float:
    """Mean time of one call issued from Python, by CUDA events over
    ``reps`` back-to-back calls after a warm-up (includes any gap the
    host leaves between launches)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _events_ms(run, reps)


def device_ms(fn, reps: int) -> float:
    """Mean device time of one call: ``reps`` calls captured into one
    CUDA graph, replayed after a warm-up replay, timed by CUDA events —
    no host launch gaps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, reps)
    del graph
    return ms


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"output type/shape {g.dtype}{tuple(g.shape)} vs "
                 f"{w.dtype}{tuple(w.shape)}")
        d = (g.to(torch.float64) - w.to(torch.float64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def check_identical(name: str, got, want) -> float:
    """Every output bit-identical (compared as raw bits)."""
    for i, (g, w) in enumerate(zip(got, want)):
        gb = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        wb = w.view(torch.int16) if w.dtype == torch.bfloat16 else w
        if gb.dtype == torch.float32:
            gb, wb = gb.view(torch.int32), wb.view(torch.int32)
        if not torch.equal(gb, wb):
            fail(f"{name}: output {i} differs from the plain version")
    return max_abs_err(got, want)


def random_receive_operands(k, n: int, w: int, device, seed: int):
    """Seeded random receive operands (the kernel's full input space;
    the scored variant's own operands only for a scored ``k``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    C = k.n_candidates

    def words(shape, bits=32):
        hi = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        lo = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        v = ((hi << 16) | lo) & ((1 << bits) - 1)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    def ctr(hi):
        return (torch.rand((C, n), generator=g, device=device) * hi).to(
            k.counter_dtype)

    sub = torch.rand(n, generator=g, device=device) < 0.8
    ops = dict(
        gseeds=(0x9E3779B9, 0x85EBCA6B),
        ctrl=torch.randint(0, 64, (C, n), generator=g, device=device).to(
            torch.uint8),
        fresh=words((w, n)) & words((w, n)), adv=words((w, n)),
        sub_all=torch.where(sub, (1 << C) - 1, 0).to(torch.int32),
        cand_sub=words((n,), C), fanout=words((n,), C) & words((n,), C),
        wa=words((n,), C), grafts=words((n,), C) & words((n,), C),
        dropped=words((n,), C) & words((n,), C), meshsel=words((n,), C),
        seen=words((w, n)) & words((w, n)), injected=words((w, n)) & 0x0F0F,
        backoff=torch.randint(0, 61, (C, n), generator=g,
                              device=device).to(torch.int16))
    if not k.scored:
        return ops
    return dict(
        ops, valid=words((w,)), pay=words((n,), C), gsp=words((n,), C),
        acc=words((n,), C), bo2=words((n,), C), static=None,
        fd=ctr(60.0), inv=ctr(3.0), bp=ctr(3.0).to(k.bp_dtype),
        tim=torch.randint(0, 32767, (C, n), generator=g,
                          device=device).to(torch.int16),
        iws=torch.randint(0, 30001, (C, n), generator=g,
                          device=device).to(torch.int16))


def stack_receive_operands(reps: list) -> dict:
    """B replicas' receive operands as one replica stack: every tensor
    stacked [B, ...], ``gseeds`` two [B] int64 seed tensors."""
    out = {}
    for name, v in reps[0].items():
        if name == "gseeds":
            out[name] = tuple(torch.tensor(
                [int(r[name][i]) & 0xFFFFFFFF for r in reps],
                dtype=torch.int64, device=reps[0]["sub_all"].device)
                for i in range(2))
        elif isinstance(v, torch.Tensor):
            out[name] = torch.stack([r[name] for r in reps]).contiguous()
        else:
            out[name] = v
    return out


def replica_operands(k, n: int, device, seed: int, reps: int = 4,
                     attack: bool = False, faults: bool = False,
                     knobs: bool = False) -> list:
    """``reps`` replicas' seeded random receive operands, each from its
    own seed (distinct seeds, knob vectors and fault words, so a
    replica mix-up shows): the attack variant's sybil word and ledgers,
    the faulted variant's alive word, a non-default knob vector."""
    out = []
    C = k.n_candidates
    for b in range(reps):
        ops = random_receive_operands(k, n, 1, device, seed + 17 * b)
        ops["gseeds"] = (0x9E3779B9 ^ (b * 0x1234567),
                         0x85EBCA6B ^ (b * 0x7654321))
        if attack:
            g = torch.Generator(device=device)
            g.manual_seed(seed + 17 * b + 2)
            ops["syb"] = torch.where(
                torch.rand(n, generator=g, device=device) < 0.2,
                (1 << C) - 1, 0).to(torch.int32)
            ops["iws"] = torch.randint(0, 4 * 32, (C, n), generator=g,
                                       device=device).to(torch.int16)
        if faults:
            ops = fault_operands(k, ops, device, seed + 17 * b + 5)
        if knobs:
            v = [0.3 + 0.1 * b, 3.0 + b, 9.0 + 2 * b]
            if k.scored:
                v += [-10.0 - b, -20.0 - 5 * b, -60.0 - b, -5.0 + b]
            ops["knobs"] = torch.tensor(v, dtype=torch.float32,
                                        device=device)
        out.append(ops)
    return out


def check_batched_receive(name: str, k, reps: list, krecv,
                          timed: bool = True) -> dict:
    """One launch of the receive kernel on the stack of ``reps`` against
    its plain version on the stack and against one launch per replica:
    every output bit-identical (raw bits); the batched launch timed
    beside the replicas' single launches."""
    ops = stack_receive_operands(reps)
    got = krecv.receive_update(k, **ops)
    want = krecv.receive_update_plain(k, **ops)
    err = check_identical(f"{name} batched vs plain", got, want)
    singles = [krecv.receive_update(k, **r) for r in reps]
    for b, one in enumerate(singles):
        check_identical(f"{name} batched replica {b} vs its single launch",
                        [g[b] for g in got], one)
    out = dict(max_abs_err=err, replicas=len(reps))
    if timed:
        out["ms"] = device_ms(lambda: krecv.receive_update(k, **ops), 10)
        out["singles_ms"] = device_ms(
            lambda: [krecv.receive_update(k, **r) for r in reps], 10)
        out["plain_ms"] = eager_ms(
            lambda: krecv.receive_update_plain(k, **ops), 2)
        out["bytes"] = krecv.operand_bytes(ops, got)
    return out


def check_batched_select(name: str, elig, kk, c: int, seeds, kselect,
                         timed: bool = True) -> dict:
    """One select launch over the stack ``elig``/``kk`` [B, N] with the
    [B] ``seeds`` against its plain version and against B single
    launches: bit-identical; timed beside the single launches."""
    n = elig.shape[1]
    got = kselect.select_k_bits(elig, kk, c, seeds, n)
    want = kselect.select_k_bits_plain(elig, kk, c, seeds, n)
    err = check_identical(f"{name} batched vs plain", [got], [want])
    host = [int(x) & 0xFFFFFFFF for x in seeds.tolist()]
    for b in range(elig.shape[0]):
        one = kselect.select_k_bits(elig[b].contiguous(),
                                    kk[b].contiguous(), c, host[b], n)
        check_identical(f"{name} replica {b} vs its single launch",
                        [got[b]], [one])
    out = dict(max_abs_err=err, replicas=int(elig.shape[0]))
    if timed:
        rows = [(elig[b].contiguous(), kk[b].contiguous())
                for b in range(elig.shape[0])]
        out["ms"] = device_ms(
            lambda: kselect.select_k_bits(elig, kk, c, seeds, n), 20)
        out["singles_ms"] = device_ms(
            lambda: [kselect.select_k_bits(e, q, c, h, n)
                     for (e, q), h in zip(rows, host)], 20)
        out["plain_ms"] = eager_ms(
            lambda: kselect.select_k_bits_plain(elig, kk, c, seeds, n), 2)
    return out


def batched_paths(dev, pg, krecv, ksel, flagship) -> dict:
    """B1's other families on a replica stack, each through the user's
    runner (gossip_run_knob_batch / gossip_run_batch) for
    BATCHED_PATH_TICKS ticks at 4 x BATCHED_PATH_PEERS flagship-drawn
    peers, counts reset just before and read just after: the knob batch
    (a SimKnobs point a replica), unscored and scored under a fault
    schedule a replica (distinct fault seeds and churn), unscored, the
    attack options (20% sybils a replica).  Returns each run's launches; B1
    must run once a tick, its family only."""
    import numpy as np

    from go_libp2p_pubsub_tpu_torch.models import faults as pfl

    n_p, ticks = BATCHED_PATH_PEERS, BATCHED_PATH_TICKS
    cfg, subs, topic, origin, tick = flagship.inputs(n_p, horizon=40)
    common = dict(subs=subs, msg_topic=topic, msg_origin=origin,
                  msg_publish_tick=tick, track_first_tick=False)
    atk = pg.ScoreSimConfig(sybil_ihave_spam=True, sybil_iwant_spam=True)

    def sched(r):
        rng = np.random.default_rng(r)
        down = np.flatnonzero(rng.random(n_p) < 0.05)
        return pfl.FaultSchedule(
            n_peers=n_p, horizon=40, seed=11 + r, drop_prob=0.02,
            down_intervals=[(int(p), 2, 6) for p in down])

    runs = {
        "scored+knobs": (pg.ScoreSimConfig(), lambda r: dict(
            sim_knobs={"gossip_factor": 0.2 + 0.1 * r,
                       "behaviour_penalty_weight": -5.0 * (r + 1)})),
        "unscored": (None, lambda r: {}),
        "unscored_faults": (None, lambda r: dict(fault_schedule=sched(r))),
        "scored_faults": (pg.ScoreSimConfig(), lambda r: dict(
            fault_schedule=sched(r))),
        "attacks": (atk, lambda r: dict(
            sybil=np.random.default_rng(r).random(n_p) < 0.2)),
    }
    out = {}
    for variant, (sc, extra) in runs.items():
        params, state = pg.stack_sims(
            cfg, [dict(seed=r, **extra(r)) for r in range(4)],
            score_cfg=sc, device=dev, **common)
        step = pg.make_gossip_step(cfg, sc, device=dev)
        torch.cuda.synchronize()
        krecv.launches.clear()
        ksel.launches = 0
        state, reach = pg.gossip_run_knob_batch(params, state, ticks, step,
                                                device=dev)
        torch.cuda.synchronize()
        got = dict(krecv.launches)
        if got != {variant: ticks} or ksel.launches <= 0:
            fail(f"batched {variant}: launches {got}, select "
                 f"{ksel.launches}")
        out[variant] = dict(receive=got[variant], select=ksel.launches,
                            reached=int((reach > 0).sum()))
        del params, state, step
    return out


#: the families of B1's delay-mode and telemetry stack kernels: the score
#: keywords (None: unscored) and replica_operands' keywords; the delay
#: mode's attack options track promises on the IHAVE spam alone (it
#: refuses the IWANT flood), the telemetry tally's run both spams
STACK_DELAY_FAMILIES = {
    "scored": ({}, {}),
    "attacks": (dict(sybil_ihave_spam=True), dict(attack=True)),
    "unscored": (None, {})}
STACK_TEL_FAMILIES = {
    "scored": ({}, {}),
    "attacks": (dict(sybil_ihave_spam=True, sybil_iwant_spam=True),
                dict(attack=True)),
    "unscored": (None, {})}
#: 5ac's latency-bucket rows and the stack paths' size (5ae)
STACK_TEL_BUCKETS = 16
STACK_PATH_PEERS, STACK_PATH_TICKS = 20_000, 10
#: a ring of odd N at C = 8: a replica's staged rows start off a 16-byte
#: boundary of the stack
ODD_PEERS = 100_003


def stack_label(fam: str, mode: str, knobs: bool,
                faults: bool = False) -> str:
    """A stack kernel's name in the kernels line."""
    return ("receive_update" + ("" if fam == "scored" else "_" + fam)
            + ("_faults" if faults else "") + "_" + mode
            + ("_knobs" if knobs else "") + "_batched")


def tel_receive_operands(k, ops, device, seed: int):
    """``ops`` with the telemetry tally's latency-bucket operands, seeded:
    the bucket masks [L, W] and the deliver words [W, N]."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    w, n = ops["seen"].shape
    out = dict(ops)
    if k.tel_lat_buckets:
        out["lat_masks"] = torch.randint(
            0, 1 << 30, (k.tel_lat_buckets, w), generator=g,
            device=device).to(torch.int32)
        out["dlv_eff"] = torch.randint(0, 1 << 30, (w, n), generator=g,
                                       device=device).to(torch.int32)
    return out


def odd_ring_cfg(pg):
    """A C = 8 ring of ODD_PEERS peers and a degree family that fits."""
    return pg.GossipSimConfig(
        offsets=pg.make_gossip_offsets(2, 8, ODD_PEERS - 1, seed=3),
        n_topics=2, d=3, d_lo=2, d_hi=6, d_score=2, d_out=1, d_lazy=2)


def stack_kernel_rows(mode: str, tick_reps: list, cfg, n: int, dev,
                      label_tick: str) -> dict:
    """Phases 5ab (``mode`` "delays") and 5ac ("tel"): each stack kernel of
    the mode's families (the flagship's options, the attack options,
    unscored; each with and without knobs, the telemetry tally also with
    and without faults) on the real batched tick ``tick_reps`` (four
    replicas' operands, adapted to the family: the extra operands each
    replica's own seeded draws), on seeded random operands at ``n`` and at
    C = 8 on a ring of ODD_PEERS: one launch for the four replicas,
    bit-identical to its plain version and to four single launches; timed
    on the real tick beside the single launches and the plain version."""
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pg
    from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv

    name = torch.cuda.get_device_name(0)
    families = STACK_DELAY_FAMILIES if mode == "delays" else \
        STACK_TEL_FAMILIES
    faults_opts = (False,) if mode == "delays" else (False, True)
    unscored_names = set(tick_reps[0]) - set(krecv.SCORED_OPERANDS)
    cfg8 = odd_ring_cfg(pg)
    out = {}
    seed = 901
    for fam, (sc_kw, extra) in families.items():
        scfg = None if sc_kw is None else pg.ScoreSimConfig(**sc_kw)
        for faults in faults_opts:
            for knobs in (False, True):
                kw = dict(knobs=knobs)
                if mode == "delays":
                    kw["delays"] = True
                else:
                    kw.update(telemetry=True, faults=faults,
                              tel_lat_buckets=STACK_TEL_BUCKETS)
                label = stack_label(fam, mode, knobs, faults)
                seed += 10

                def seeded(k_, n_, s_):
                    reps = replica_operands(k_, n_, dev, s_, faults=faults,
                                            knobs=knobs, **extra)
                    if mode == "delays":
                        return [delay_receive_operands(k_, r, dev, s_ + b)
                                for b, r in enumerate(reps)]
                    return [tel_receive_operands(k_, r, dev, s_ + b)
                            for b, r in enumerate(reps)]
                k = krecv.receive_consts(cfg, scfg, **kw)
                k8 = krecv.receive_consts(cfg8, scfg, **kw)
                r_rand = check_batched_receive(
                    f"{label} (seeded, N={n})", k, seeded(k, n, seed),
                    krecv, timed=False)
                r_odd = check_batched_receive(
                    f"{label} (seeded, C=8, N={ODD_PEERS})", k8,
                    seeded(k8, ODD_PEERS, seed + 5), krecv, timed=False)
                adds = seeded(k, n, seed + 3)
                reps = []
                for b in range(len(tick_reps)):
                    ops_t = dict(tick_reps[b])
                    if scfg is None:
                        ops_t = {key: v for key, v in ops_t.items()
                                 if key in unscored_names}
                    ops_t.pop("knobs", None)
                    for key in ("knobs", "alive_w", "flood_ok", "syb",
                                "cheat_arr"):
                        if key in adds[b]:
                            ops_t[key] = adds[b][key]
                    reps.append(ops_t)
                r = check_batched_receive(f"{label} ({label_tick})", k,
                                          reps, krecv)
                r["bound"] = bound(r["bytes"], sum(receive_ops(k, t_)
                                                   for t_ in reps))
                r["err"] = max(r_rand["max_abs_err"], r_odd["max_abs_err"],
                               r["max_abs_err"])
                r["variant"] = krecv.variant(k)
                r["library"] = krecv.library(k, stacked=True)
                out[label] = r
                print(f"{label} ({r['variant']}, {r['library']}.cu): 4 "
                      f"replicas identical to plain and to 4 single "
                      f"launches, seeded at N={n} and at C=8, "
                      f"N={ODD_PEERS}, and on {label_tick} at N={n}; "
                      f"device time {r['ms']:.4f} ms against "
                      f"{r['singles_ms']:.4f} ms for 4 single launches, "
                      f"plain {r['plain_ms']:.3f} ms, bound "
                      f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), "
                      f"{r['bytes'] / (4 * n):.1f} B/peer [{name}]")
                del reps, adds
    return out


def stack_paths(dev, flagship) -> dict:
    """Phase 5ae: each delay-mode and telemetry stack kernel through the
    user's batched runner (``gossip_run_batch`` / ``telemetry_run_batch``)
    for STACK_PATH_TICKS ticks at 4 x STACK_PATH_PEERS flagship-drawn
    peers, counts reset just before and read just after: delayed stacks
    (DelayConfig(4, 2, 8), a delay seed a replica; with knobs a delay and
    protocol point a replica), telemetry stacks (the latency histogram on;
    with faults a schedule a replica, with knobs a point a replica; the
    attack options with knobs on the IHAVE spam alone, since a knob point
    on an IWANT flood runs on the receive loops).  B1 must run once a
    tick, its variant only.  Returns each run's launches."""
    import numpy as np

    from go_libp2p_pubsub_tpu_torch.models import delays as pdl
    from go_libp2p_pubsub_tpu_torch.models import faults as pfl
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pg
    from go_libp2p_pubsub_tpu_torch.models import telemetry as tl
    from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
    from go_libp2p_pubsub_tpu_torch.ops.kernels import select as ksel

    n_p, ticks = STACK_PATH_PEERS, STACK_PATH_TICKS
    cfg, subs, topic, origin, tick = flagship.inputs(n_p, horizon=8)
    common = dict(subs=subs, msg_topic=topic, msg_origin=origin,
                  msg_publish_tick=tick, track_first_tick=False)

    def sched(r):
        rng = np.random.default_rng(r)
        down = np.flatnonzero(rng.random(n_p) < 0.05)
        return pfl.FaultSchedule(
            n_peers=n_p, horizon=40, seed=11 + r, drop_prob=0.02,
            down_intervals=[(int(p), 2, 6) for p in down])

    out = {}
    for mode, families in (("delays", STACK_DELAY_FAMILIES),
                           ("tel", STACK_TEL_FAMILIES)):
        for fam, (sc_kw, _) in families.items():
            for faults in ((False,) if mode == "delays" else (False, True)):
                for knobs in (False, True):
                    kw_sc = dict(sc_kw or {})
                    if knobs and mode == "tel":
                        kw_sc.pop("sybil_iwant_spam", None)
                    sc = None if sc_kw is None else pg.ScoreSimConfig(**kw_sc)

                    def extra(r, fam=fam, faults=faults, knobs=knobs,
                              mode=mode):
                        e = {}
                        if fam == "attacks":
                            e["sybil"] = (np.random.default_rng(r).random(n_p)
                                          < 0.2)
                        if faults:
                            e["fault_schedule"] = sched(r)
                        point = {}
                        if knobs:
                            point = {"gossip_factor": 0.2 + 0.1 * r,
                                     "d_lazy": 4 + r}
                        if mode == "delays":
                            e["delays"] = pdl.DelayConfig(4, 2, 8,
                                                          seed=3 + r)
                            if knobs:
                                point.update(delay_base=1 + r,
                                             delay_jitter=r % 3)
                        if point:
                            e["sim_knobs"] = point
                        return e
                    params, state = pg.stack_sims(
                        cfg, [dict(seed=r, **extra(r)) for r in range(4)],
                        score_cfg=sc, device=dev, **common)
                    tcfg = (tl.TelemetryConfig(
                        latency_hist=True, latency_buckets=STACK_TEL_BUCKETS)
                        if mode == "tel" else None)
                    step = pg.make_gossip_step(cfg, sc, device=dev,
                                               telemetry=tcfg)
                    variant = krecv.variant(krecv.receive_consts(
                        cfg, sc, faults=faults, knobs=knobs,
                        delays=mode == "delays", telemetry=mode == "tel",
                        tel_lat_buckets=STACK_TEL_BUCKETS
                        if mode == "tel" else 0))
                    torch.cuda.synchronize()
                    krecv.launches.clear()
                    ksel.launches = 0
                    if mode == "tel":
                        state, frames = tl.telemetry_run_batch(
                            params, state, ticks, step)
                        live = int(frames.payload_sent.sum())
                    else:
                        state = pg.gossip_run_batch(params, state, ticks,
                                                    step, device=dev)
                        live = int(state.pay_line.ne(0).sum())
                    torch.cuda.synchronize()
                    got = dict(krecv.launches)
                    if got != {variant: ticks} or ksel.launches <= 0 \
                            or live <= 0:
                        fail(f"stack path {mode} {fam} faults={faults} "
                             f"knobs={knobs}: launches {got}, select "
                             f"{ksel.launches}, live {live}")
                    out[stack_label(fam, mode, knobs, faults)] = dict(
                        variant=variant, receive=got[variant],
                        select=ksel.launches, live=live)
                    del params, state, step
    return out


def full_receive_operands(k, n: int, device, seed: int):
    """Seeded random operands of the full variant with every option on:
    the attack variant's (a fifth of the peers carrying the sybil word,
    ledgers around the flood budget) plus ctrl bytes with CTRL_FLOOD,
    sparse injected sender words and same-IP sibling words."""
    C = k.n_candidates
    ops = random_receive_operands(k, n, 1, device, seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 2)
    ops["syb"] = torch.where(
        torch.rand(n, generator=g, device=device) < 0.2, (1 << C) - 1, 0).to(
            torch.int32)
    ops["iws"] = torch.randint(0, 4 * 32, (C, n), generator=g,
                               device=device).to(torch.int16)
    ops["ctrl"] = torch.randint(0, 128, (C, n), generator=g,
                                device=device).to(torch.uint8)
    ops["inj_send"] = (ops["fresh"] & ops["adv"]).contiguous()
    group = torch.randint(0, 6, (C, n), generator=g, device=device)
    same = torch.zeros((C, n), dtype=torch.int32, device=device)
    for c in range(C):
        same |= (group == group[c][None, :]).to(torch.int32) << c
    ops["same_ip"] = same
    return ops


def paired_receive_operands(k, ops, n: int, device, seed: int):
    """``ops`` with the paired variant's own operands added, seeded: a
    second ctrl byte with every slot-B flag, slot-B sender words and
    handshake words, the slot-B backoff and (scored) time in mesh."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    C = k.n_candidates
    w = ops["fresh"].shape[0]

    def words(shape, bits=32):
        hi = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        lo = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        v = ((hi << 16) | lo) & ((1 << bits) - 1)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    out = dict(
        ops,
        ctrl2=torch.randint(0, 16, (C, n), generator=g, device=device).to(
            torch.uint8),
        fresh_b=words((w, n)) & words((w, n)), wa_b=words((n,), C),
        grafts_b=words((n,), C) & words((n,), C),
        dropped_b=words((n,), C) & words((n,), C), meshsel_b=words((n,), C),
        backoff_b=torch.randint(0, 61, (C, n), generator=g,
                                device=device).to(torch.int16))
    if k.scored:
        out.update(bo2_b=words((n,), C),
                   tim_b=torch.randint(0, 32767, (C, n), generator=g,
                                       device=device).to(torch.int16))
    return out


def fault_operands(k, ops, device, seed: int):
    """``ops`` with the faulted variant's own operands, seeded: the alive
    word 0 at a tenth of the peers and, under the IWANT flood, random
    flood_ok bits."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = ops["sub_all"].shape[0]
    down = torch.rand(n, generator=g, device=device) < 0.1
    out = dict(ops, alive_w=torch.where(down, 0, -1).to(torch.int32))
    if k.iwant_spam:
        out["flood_ok"] = torch.randint(0, 1 << k.n_candidates, (n,),
                                        generator=g, device=device).to(
                                            torch.int32)
    return out


def delay_receive_operands(k, ops, device, seed: int):
    """``ops`` (a variant's random operands) in the delay mode's form,
    seeded: the sender streams and (scored) the receiver's gate words left
    out, random arrivals [C·W, N] (a word in four set) and GRAFT, PRUNE,
    retraction and (tracking promises) broken-promise advert words in."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    C = k.n_candidates
    w, n = ops["seen"].shape

    def words(shape, bits=32):
        hi = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        lo = torch.randint(0, 1 << 16, shape, generator=g, device=device)
        v = ((hi << 16) | lo) & ((1 << bits) - 1)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    sender = ("ctrl", "fresh", "adv", "inj_send", "pay", "gsp", "acc")
    out = {key: v for key, v in ops.items() if key not in sender}
    out.update(arr=words((C * w, n)) & words((C * w, n)),
               graft_arr=words((n,), C) & words((n,), C),
               prune_arr=words((n,), C) & words((n,), C),
               retract=words((n,), C) & words((n,), C))
    if k.track_promises:
        out["cheat_arr"] = words((n,), C) & words((n,), C)
    return out


#: the knob point of the delayed variants' real ticks (the seven kernel
#: knobs off their defaults; unscored, the protocol three)
DELAY_KNOB_POINT = {"gossip_factor": 0.4, "d_lazy": 4, "backoff_ticks": 6,
                    "invalid_message_deliveries_weight": -20.0,
                    "behaviour_penalty_weight": -40.0,
                    "graylist_threshold": -60.0, "gossip_threshold": -5.0}


def delayed_tick(params, state, step, krecv, first: int, last: int,
                 need_cheat: bool):
    """Step a delayed sim from its state, capturing each tick's receive
    operands, up to the first tick in [first, last] whose arrivals and
    retractions (and, ``need_cheat``, broken-promise adverts) are live:
    (that tick, its operands, the launches counted on the way)."""
    real = krecv.receive_update
    box = []

    def capture(k_, **ops_):
        box[:] = [ops_]
        return real(k_, **ops_)

    krecv.launches.clear()
    krecv.receive_update = capture
    try:
        for tick in range(last + 1):
            state = step(params, state)[0]
            o = box[0]
            live = [o["arr"], o["retract"]]
            if need_cheat:
                live.append(o["cheat_arr"])
            if tick >= first and all(bool(x.any()) for x in live):
                break
        else:
            fail(f"no tick in [{first}, {last}] with live delay operands")
    finally:
        krecv.receive_update = real
    torch.cuda.synchronize()
    return tick, box[0], dict(krecv.launches)


def delay_variants(dev, n: int, n_r: int, seed: int = 701) -> dict:
    """Phase 5p: each delayed receive variant (the flagship's scored
    options, the attack options tracking promises, the full variant with
    exact-k, PX and the shared-IP gater at ``n`` peers; unscored at the
    resident shapes, ``n_r``), each without and with knobs, against its
    plain version on seeded random operands and on a real tick of the
    family's delayed sim (``pipelined.family_sim``, DelayConfig(4, 2, 8),
    messages published over the first 16 ticks (unscored: the resident
    benchmark's 8); the first tick from 8 on with arrivals, retractions
    and, for the attack variant, broken-promise adverts live): every output
    bit-identical; the variant, its plain version and its delay-free twin
    on the same tick of the sim without delays timed.  One result per
    kernel name."""
    import dataclasses

    from go_libp2p_pubsub_tpu_torch import pipelined
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pg
    from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv

    C = 16
    out = {}
    for fam in ("scored", "attacks", "full", "unscored"):
        n_f = n_r if fam == "unscored" else n
        horizon = 8 if fam == "unscored" else 16
        for knobs in (False, True):
            point = None
            if knobs:
                point = ({key: DELAY_KNOB_POINT[key] for key in (
                    "gossip_factor", "d_lazy", "backoff_ticks")}
                    if fam == "unscored" else DELAY_KNOB_POINT)
            cfg, sc, params, state = pipelined.family_sim(
                fam, dev, n_f, horizon=horizon, knobs=point)
            k = krecv.receive_consts(
                cfg, sc, px=state.active is not None,
                same_ip=params.cand_same_ip is not None, knobs=knobs,
                delays=True)
            # random operands: the full variant with flood publishing and
            # exact-k on, the attack options with the IHAVE spam
            seed += 7
            if fam == "full":
                k_r = dataclasses.replace(k, flood_publish=True,
                                          exact_k=True)
                rops = full_receive_operands(k_r, n_f, dev, seed)
            else:
                k_r = k
                rops = random_receive_operands(k_r, n_f, 1, dev, seed)
            if k_r.attacks and "syb" not in rops:
                g = torch.Generator(device=dev)
                g.manual_seed(seed + 2)
                rops["syb"] = torch.where(
                    torch.rand(n_f, generator=g, device=dev) < 0.2,
                    (1 << C) - 1, 0).to(torch.int32)
            rops = delay_receive_operands(k_r, rops, dev, seed + 1)
            if knobs:
                v = [0.4, 4.0, 13.0] + ([-13.0, -40.0, -60.0, -5.0]
                                        if k_r.scored else [])
                rops["knobs"] = torch.tensor(v, dtype=torch.float32,
                                             device=dev)
            got = krecv.receive_update(k_r, **rops)
            torch.cuda.synchronize()
            label = ("receive_update"
                     + ("" if fam == "scored" else "_" + fam)
                     + "_delays" + ("_knobs" if knobs else ""))
            err = check_identical(f"{label} (random operands)", got,
                                  krecv.receive_update_plain(k_r, **rops))
            del rops, got
            step = pg.make_gossip_step(cfg, sc, device=dev)
            tick, ops, launched = delayed_tick(
                params, state, step, krecv, 8, 60, fam == "attacks")
            if launched != {krecv.variant(k): tick + 1}:
                fail(f"{label}: launches {launched}")
            want = krecv.receive_update_plain(k, **ops)
            got = krecv.receive_update(k, **ops)
            torch.cuda.synchronize()
            err = max(err, check_identical(f"{label} (tick {tick})", got,
                                           want))
            ms = device_ms(lambda: krecv.receive_update(k, **ops), 50)
            plain = device_ms(lambda: krecv.receive_update_plain(k, **ops),
                              5)
            nbytes = krecv.operand_bytes(ops, got)
            bnd = bound(nbytes, receive_ops(k, ops))
            del want, got, step
            # the delay-free twin on the same tick of the sim without delays
            params_t = dataclasses.replace(params, delays=None)
            state_t = dataclasses.replace(state, pay_line=None,
                                          ctrl_line=None)
            k_t = dataclasses.replace(k, delays=False)
            step_t = pg.make_gossip_step(cfg, sc, device=dev)
            ops_t = capture_receive(lambda: pg.gossip_run(
                params_t, state_t, tick + 1, step_t, device=dev), krecv)
            twin = device_ms(lambda: krecv.receive_update(k_t, **ops_t), 50)
            print(f"{label}: identical at N={n_f}, C={C}, W=1 (random "
                  f"operands, tick {tick} of the delayed sim); device time: "
                  f"kernel {ms:.4f} ms (twin without delays {twin:.4f}), "
                  f"plain {plain:.3f} ms; {nbytes / n_f:.1f} B/peer, bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]}); {tick + 1} launches of "
                  f"{krecv.variant(k)} to tick {tick}")
            out[label] = dict(err=err, ms=ms, plain_ms=plain, twin_ms=twin,
                              bytes_per_peer=nbytes / n_f, bound=bnd,
                              launches=tick + 1, tick=tick,
                              variant=krecv.variant(k))
            del ops, ops_t, params, state, params_t, state_t, step_t
    return out


#: 5r's telemetry groups: every group, all three histograms
INV_TEL = dict(latency_hist=True, degree_hist=True, score_hist=True,
               latency_buckets=16)


def armed_families(dev, n: int, warm: int = 24) -> dict:
    """Phase 5r: each per-tick family's step with the invariant checker on
    (``InvariantConfig()``) for one real tick on the card, against the same
    step on the CPU and the step without the checker on the card.

    The families are the earlier phases' builders at ``n`` peers: the
    flagship (messages over the first 48 ticks), the unscored resident
    configuration (over 16), the adversarial one, everything-on, paired
    everything-on, unscored paired; each clean, under the churn
    benchmark's kind of schedule from tick 0 (waves from tick 5, the
    partition from 20), with every telemetry group (``INV_TEL``) and at a
    knob point (the seven kernel knobs of ``DELAY_KNOB_POINT``; the
    IWANT-flood sims at the hardened defense through ``score_knobs``;
    unscored, the three protocol knobs); and the delayed flagship, attack,
    full and unscored sims (``pipelined.family_sim``, DelayConfig(4, 2,
    8)).  Each armed sim runs ``warm`` ticks on the card; then tick
    ``warm`` runs on the card (one receive launch), on the CPU from the
    same state copied over (``convert``), and on the card without the
    checker from the unarmed state: every state leaf and the two carry
    scalars equal the CPU's, every other leaf and the delivered words the
    unarmed step's, the frames (but ``score_mean``, summed in another
    order) both; the report clean.  Then the reference's seeded mesh
    defect (tests/test_invariants.py ``test_seeded_mesh_defect_fires``:
    240 peers, peer 7 subscribed to nothing, a forged mesh bit to it) on
    the card and on the CPU: mesh-subscription on tick 0, both the
    same."""
    import dataclasses

    import numpy as np

    from go_libp2p_pubsub_tpu_torch import (adversarial, churn, convert,
                                            everything, flagship,
                                            invariants_flagship, knob_sweep,
                                            pipelined, resident)
    from go_libp2p_pubsub_tpu_torch.knob_sweep import tree_digest
    from go_libp2p_pubsub_tpu_torch.models import faults
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pg
    from go_libp2p_pubsub_tpu_torch.models import invariants as iv
    from go_libp2p_pubsub_tpu_torch.models import telemetry as tl
    from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv

    def unscored(paired):
        cfg, params, state = resident.build(dev, n_peers=n, horizon=16,
                                            paired=paired)[:3]
        return cfg, None, params, state

    bases = {
        "scored": lambda: flagship.build(dev, n_peers=n, horizon=48)[:4],
        "unscored": lambda: unscored(False),
        "attack": lambda: adversarial.build(dev, n_peers=n, horizon=48)[:4],
        "full": lambda: everything.build(dev, n_peers=n, horizon=48)[:4],
        "paired": lambda: everything.build(dev, n_peers=n, horizon=48,
                                           paired=True)[:4],
        "paired_unscored": lambda: unscored(True),
    }
    proto = {key: DELAY_KNOB_POINT[key]
             for key in ("gossip_factor", "d_lazy", "backoff_ticks")}

    def variant(sim, mode):
        cfg, sc, params, state = sim
        if mode == "faults":
            sched = churn.schedule(n, np.random.default_rng(3), 0, 400)
            params = dataclasses.replace(params, faults=faults.compile_faults(
                sched, cfg.offsets, device=dev))
        elif mode == "knobs":
            if sc is None:
                surface = dict(sim_knobs=proto)
            elif sc.sybil_iwant_spam:
                surface = dict(
                    score_knobs=knob_sweep.DEFENSE_POINTS["hardened"])
            else:
                surface = dict(sim_knobs=DELAY_KNOB_POINT)
            params = pg.knob_params(cfg, sc, params, **surface)
            state = pg.refresh_gates(cfg, sc, params, state)
        return cfg, sc, params, state

    cases = [(f"{fam}/{mode}", lambda fam=fam, mode=mode: variant(
        bases[fam](), mode), mode == "telemetry")
        for fam in bases for mode in ("clean", "faults", "telemetry",
                                      "knobs")]
    cases += [(f"{fam}/delays", lambda fam=fam: pipelined.family_sim(
        fam, dev, n, horizon=16), False)
        for fam in ("scored", "attacks", "full", "unscored")]
    icfg = iv.InvariantConfig()
    out = {}
    for label, build, with_tel in cases:
        t0 = time.perf_counter()
        cfg, sc, params, state = build()
        tcfg = tl.TelemetryConfig(**INV_TEL) if with_tel else None
        on = pg.make_gossip_step(cfg, sc, device=dev, telemetry=tcfg,
                                 invariants=icfg)
        state = pg.gossip_run(params, iv.attach(state), warm, on,
                              device=dev)
        p_c = convert.params_from_numpy(convert.params_to_numpy(params),
                                        "cpu")
        s_c = convert.state_from_numpy(convert.state_to_numpy(state), sc,
                                       "cpu")
        torch.cuda.synchronize()
        krecv.launches.clear()
        s_g, d_g, *f_g = on(params, state)
        torch.cuda.synchronize()
        launched = dict(krecv.launches)
        if sum(launched.values()) != 1:
            fail(f"5r {label}: receive launches {launched} in one tick")
        s_cpu, d_cpu, *f_cpu = pg.make_gossip_step(
            cfg, sc, device="cpu", telemetry=tcfg, invariants=icfg)(p_c, s_c)
        off = pg.make_gossip_step(cfg, sc, device=dev, telemetry=tcfg)
        s_off, d_off, *f_off = off(params, invariants_flagship.unarmed(state))
        g_np = convert.state_to_numpy(s_g)
        # every leaf, the carry's too, against the CPU's; the other leaves
        # against the unarmed step's
        bad = [what for what, ok in (
            ("state vs CPU", tree_digest(g_np)
             == tree_digest(convert.state_to_numpy(s_cpu))),
            ("state vs unarmed", tree_digest(dict(
                g_np, inv_viol=None, inv_first=None))
             == tree_digest(convert.state_to_numpy(s_off))),
            ("delivered vs CPU", torch.equal(d_g.cpu(), d_cpu)),
            ("delivered vs unarmed", torch.equal(d_g, d_off))) if not ok]
        if with_tel:
            fr = [convert.frame_to_numpy(f[0]) for f in (f_g, f_cpu, f_off)]
            sm = [f.pop("score_mean") for f in fr]
            if tree_digest(fr[0]) != tree_digest(fr[1]) or not np.allclose(
                    sm[0], sm[1], rtol=1e-5, atol=1e-6):
                bad.append("frame vs CPU")
            if tree_digest(fr[0]) != tree_digest(fr[2]) or not np.array_equal(
                    sm[0], sm[2]):
                bad.append("frame vs unarmed")
        rep = iv.report(s_g)
        if bad or rep["bits"] != 0 or g_np["inv_viol"] is None:
            fail(f"5r {label}: {bad} differ; report {rep}")
        out[label] = dict(report=rep, launches=launched,
                          tick=int(s_g.tick) - 1,
                          seconds=time.perf_counter() - t0)
        print(f"5r {label}: tick {warm} armed on the card == CPU (every "
              f"leaf, the carry {int(g_np['inv_viol'])}/"
              f"{int(g_np['inv_first'])}), == unarmed on every other leaf"
              f"{' and frame' if with_tel else ''}; launches {launched}; "
              f"{out[label]['seconds']:.1f} s")
        del params, state, p_c, s_c, s_g, s_cpu, s_off, on, off
    # the reference's seeded mesh defect, on the card and on the CPU
    n_d = 240
    subs = np.zeros((n_d, 2), dtype=bool)
    subs[np.arange(n_d), np.arange(n_d) % 2] = True
    subs[7] = False
    rng = np.random.default_rng(0)
    topic = rng.integers(0, 2, 8)
    origin = rng.integers(0, n_d // 2, 8) * 2 + topic
    origin = np.where(origin == 7, (origin + 2) % n_d, origin)
    topic = (origin % 2).astype(topic.dtype)
    ticks = rng.integers(0, 5, 8).astype(np.int32)
    cfg = pg.GossipSimConfig(offsets=pg.make_gossip_offsets(2, 16, n_d,
                                                            seed=1),
                             n_topics=2)
    sc = pg.ScoreSimConfig()
    reps = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        params, state = pg.make_gossip_sim(cfg, subs, topic, origin, ticks,
                                           score_cfg=sc, device=d)
        mesh = torch.zeros(n_d, dtype=torch.int32, device=d)
        mesh[(7 - cfg.offsets[0]) % n_d] = 1
        state = pg.refresh_gates(cfg, sc, params, dataclasses.replace(
            state, mesh=mesh))
        state = pg.gossip_run(params, iv.attach(state), 3, pg.make_gossip_step(
            cfg, sc, device=d, invariants=icfg), device=d)
        reps[where] = iv.report(state)
    want = {"violations": ["mesh-subscription"], "bits": 1 << iv.MESH_SUB,
            "first_tick": 0}
    print(f"5r seeded mesh defect: card {reps['card']}, CPU {reps['cpu']}")
    if not reps["card"] == reps["cpu"] == want:
        fail(f"5r seeded mesh defect: {reps}, want {want}")
    out["seeded_mesh_defect"] = reps["card"]
    return out


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel: its name with its template
    arguments (``receive_kernel<16,1,1,0,1,1>``), registers and spill
    bytes, from nvcc's ``-Xptxas -v`` report."""
    out, entry, spill = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d+([A-Za-z_]+)I((?:L[ib]\d+E)+)EEv", line)
            entry = (f"{m.group(1)}<"
                     f"{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
                     if m else line.strip())
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}; "
                       f"{spill}")
    return out


def receive_ops(k, ops) -> int:
    """Operations the receive half needs on these operands: ~15 integer
    ops per edge, ~8 per message word over an edge whose gates are open
    (this tick's data); scored, ~60 integer/f32 ops per counter row and
    ~10 per lane-hash draw (two draws per row); unscored, ~6 per backoff
    row and one draw per row; the attack options, ~12 per edge (broken
    bit, P7 add, flood budget) and ~3 per advert word a sybil receiver
    counts; the router-surface options, ~3 per edge for the flood bit,
    ~4 per candidate pair for the same-IP sums and at most a draw per
    peer for the exact-k targets (C lane hashes, the bitonic network,
    ~3 per lane); paired topics, ~8 per edge for the second ctrl byte
    and its cross-slot routing, ~20 per row for slot B's backoff and
    (scored) time in mesh and P1, and ~8 per message word over an edge
    whose slot-B forward is open (this tick's data); faults, ~2 per edge
    and message word (the heard words masked) and ~8 per peer (the
    handshake words and the flood's gate); telemetry, ~10 per edge and
    message word (four popcounts and their masks), ~4 per edge (the RPC
    rows), ~3 per message word (the new ids) and ~3 per latency row and
    word, and the block's sums (~8 + L a peer)."""
    n = ops["sub_all"].shape[0]
    W = ops["seen"].shape[0]
    C = k.n_candidates
    # (delay mode: every arrival word is read; no ctrl byte to parse)
    open_words = C * W * n if k.delays else 0
    for j, (o, ci) in enumerate(() if k.delays else zip(k.offsets, k.cinv)):
        ctl = torch.roll(ops["ctrl"][ci], -o).to(torch.int32)
        ok_p = (ops["pay"] >> j) & 1 if k.scored else 1
        ok_g = ok_p & ((ops["gsp"] >> j) & 1) if k.scored else 1
        on = (ctl & ok_p & 1) | ((ctl >> 1) & ok_g & 1)
        open_words += W * int(on.sum())
        if k.paired:
            ctl2 = torch.roll(ops["ctrl2"][ci], -o).to(torch.int32)
            open_words += W * int((ctl2 & ok_p & 1).sum())
    per_row = 60 + 2 * 10 if k.scored else 6 + 10
    extra = 0
    if k.attacks:
        n_syb = int((ops["syb"] != 0).sum())
        extra = n * C * 12 + 3 * n_syb * C * W
    extra += n * C * (3 * k.flood_publish + 4 * C * k.with_same_ip
                      + (8 + 20) * k.paired
                      + 2 * W * k.faults) + 8 * n * k.faults
    # exact-k targets: a draw at every peer, at most
    extra += n * k.exact_k * (13 * C + 2 * sort_exchanges(C))
    L = k.tel_lat_buckets
    extra += k.telemetry * (n * C * (10 * W + 4)
                            + n * (3 * W + 3 * L * W + 8 + L))
    return n * C * (15 + per_row) + 8 * open_words + extra


def sort_exchanges(c: int) -> int:
    """Compare-exchanges of the bitonic network over c keys (rounded up
    to a power of two): 80 at c = 16."""
    size = 1 << (c - 1).bit_length()
    log = size.bit_length() - 1
    return size * log * (log + 1) // 4


def drawn_rows(elig, kk) -> int:
    """Selections that draw (0 < k < the eligible count): the others
    return at once."""
    from go_libp2p_pubsub_tpu_torch.ops import graph

    return int(((kk > 0) & (kk < graph.popcount32(elig))).sum())


def select_ops(elig, kk, c: int) -> int:
    """Operations a select call needs on these operands: ~6 per peer
    (the loads, the eligible count, the early outs), and where a draw is
    needed (0 < k < the eligible count) C lane hashes of ~10, the bitonic
    network's compare-exchanges (two each; 80 at C = 16) and ~3 per lane
    for the k-th key and the kept bits."""
    return 6 * elig.numel() + drawn_rows(elig, kk) * (
        13 * c + 2 * sort_exchanges(c))


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """The least time (ms) for the work, and what bounds it."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def capture_receive(run, krecv):
    """Run ``run()`` with receive_update wrapped; the last call's
    operands."""
    captured = []
    real = krecv.receive_update

    def capture(k_, **ops_):
        captured[:] = [ops_]            # keep the latest tick only
        return real(k_, **ops_)

    krecv.receive_update = capture
    try:
        run()
    finally:
        krecv.receive_update = real
    return captured[-1]


def capture_calls(run, mod, name: str) -> list:
    """Run ``run()`` with ``mod.<name>`` wrapped; every call's (args,
    kwargs)."""
    calls = []
    real = getattr(mod, name)

    def capture(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(mod, name, capture)
    try:
        run()
    finally:
        setattr(mod, name, real)
    return calls


def invariant_path_kernels(dev, target: int = 40) -> dict:
    """Phase 5s's kernel check: the scored receive kernel and the select
    kernel at the invariants benchmark's shapes (its sim,
    ``invariants_flagship.build``) against their plain versions, on seeded
    random operands and on every call of one busy tick (two ticks after
    the first publish at or after ``target``) of the sim stepped by the
    benchmark's armed step: every output bit-identical.  Each kernel's
    largest error, and its device time and its plain version's on the
    tick (select: the call with the most rows to draw)."""
    from go_libp2p_pubsub_tpu_torch import invariants_flagship
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pg
    from go_libp2p_pubsub_tpu_torch.models import invariants as iv
    from go_libp2p_pubsub_tpu_torch.ops import graph
    from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
    from go_libp2p_pubsub_tpu_torch.ops.kernels import select as ksel

    cfg, sc, params, state, _ = invariants_flagship.build(dev)
    n = params.subscribed.shape[0]
    C = cfg.n_candidates
    k = krecv.receive_consts(cfg, sc)
    ops = random_receive_operands(k, n, 1, dev, seed=101)
    got = krecv.receive_update(k, **ops)
    torch.cuda.synchronize()
    err_r = check_identical("receive (invariants path, random operands)",
                            got, krecv.receive_update_plain(k, **ops))
    g = torch.Generator(device=dev)
    g.manual_seed(103)
    hi = torch.randint(0, 1 << C, (n,), generator=g, device=dev)
    lo = torch.randint(0, 1 << C, (n,), generator=g, device=dev)
    elig = (hi & lo).to(torch.int32)
    kk = torch.randint(0, C + 3, (n,), generator=g, device=dev).to(
        torch.int32)
    sel = ((elig, kk, C, graph.lane_seed(9, 3, 0), n), {})
    got = ksel.select_k_bits(*sel[0])
    torch.cuda.synchronize()
    err_s = check_identical("select (invariants path, random operands)",
                            (got,), (ksel.select_k_bits_plain(*sel[0]),))
    del ops, got, hi, lo, elig, kk, sel
    pt = params.publish_tick.cpu().numpy()
    tick = int(pt[pt >= target].min()) + 2
    step = pg.make_gossip_step(cfg, sc, device=dev,
                               invariants=iv.InvariantConfig())
    state = pg.gossip_run(params, iv.attach(state), tick, step, device=dev)
    sels = []

    def one_tick():
        sels.extend(capture_calls(lambda: step(params, state), ksel,
                                  "select_k_bits"))

    rcvs = capture_calls(one_tick, krecv, "receive_update")
    if len(rcvs) != 1 or not sels:
        fail(f"invariants path tick {tick}: {len(rcvs)} receive calls, "
             f"{len(sels)} select calls")
    (k_t,), ops_t = rcvs[0]
    got = krecv.receive_update(k_t, **ops_t)
    torch.cuda.synchronize()
    err_r = max(err_r, check_identical(
        f"receive (invariants path, tick {tick})", got,
        krecv.receive_update_plain(k_t, **ops_t)))
    for i, (args, _) in enumerate(sels):
        got = ksel.select_k_bits(*args)
        torch.cuda.synchronize()
        err_s = max(err_s, check_identical(
            f"select (invariants path, tick {tick}, call {i})", (got,),
            (ksel.select_k_bits_plain(*args),)))
    busiest = max(sels, key=lambda c: int((c[0][1] > 0).sum()))[0]
    out = dict(
        n_peers=n, tick=tick, select_calls=len(sels),
        receive=dict(
            err=err_r,
            ms=device_ms(lambda: krecv.receive_update(k_t, **ops_t), 50),
            plain_ms=device_ms(
                lambda: krecv.receive_update_plain(k_t, **ops_t), 5)),
        select=dict(
            err=err_s,
            ms=device_ms(lambda: ksel.select_k_bits(*busiest), 200),
            plain_ms=device_ms(
                lambda: ksel.select_k_bits_plain(*busiest), 5)))
    print(f"invariants path kernels: identical at N={n}, C={C}, W=1 "
          f"(random operands and tick {tick}: 1 receive call, {len(sels)} "
          f"select calls); device time on the tick: receive "
          f"{out['receive']['ms']:.4f} ms (plain "
          f"{out['receive']['plain_ms']:.3f}), select "
          f"{out['select']['ms']:.4f} ms (plain "
          f"{out['select']['plain_ms']:.3f})")
    return out


def digest(state) -> str:
    """sha256 of the resident carry and the tick (the JAX package's
    resident-benchmark contract, plus the carried gates)."""
    h = hashlib.sha256()
    for leaf in (state.have, state.recent, state.mesh, state.fanout,
                 state.last_pub, state.backoff, *state.gates):
        h.update(leaf.cpu().numpy().tobytes())
    h.update(str(state.tick).encode())
    return h.hexdigest()[:16]


def sweepd_kernel_phase(dev, shape: str, krecv, ksel, pg) -> dict:
    """5ak at one shape: the kernel server's six scenarios (batch 1) with
    the receive launches counted by variant, the receive loops' passes
    counted, and the operands of each scenario's last tick kept; each kept
    tick's kernel output is then held against the plain version (those
    launches counted apart).  Fails unless the rows equal the JAX
    package's, ``attacks_faults+knobs`` ran once a tick of every scenario
    and nothing else did, ``compiles() == 1`` and no source was built."""
    from go_libp2p_pubsub_tpu_torch import sweepd_bench
    from go_libp2p_pubsub_tpu_torch.ops.kernels import _build

    ticks = sweepd_bench.KERNEL_SHAPES[shape][3]
    kept, calls = [], [0]
    real = krecv.receive_update

    def keep(k_, **ops_):
        calls[0] += 1
        if calls[0] % ticks == 0:               # each scenario's last tick
            kept.append((k_, {key: (v.clone() if isinstance(v, torch.Tensor)
                                    else v) for key, v in ops_.items()}))
        return real(k_, **ops_)

    loop_passes = []
    krecv.launches.clear()
    ksel.launches = 0
    built0 = _build.compiled
    krecv.receive_update = keep
    try:
        out = {}
        loop_passes = capture_calls(
            lambda: out.update(sweepd_bench.run_kernel(dev, shape)),
            pg._loops, "receive")
    finally:
        krecv.receive_update = real
    launches = dict(krecv.launches)
    select = ksel.launches
    n_req = len(sweepd_bench.KERNEL_REQUESTS)
    want = {"attacks_faults+knobs": n_req * ticks}
    errs = [check_identical(f"5ak {shape}: kernel server tick {i}",
                            krecv.receive_update(k_, **ops_),
                            krecv.receive_update_plain(k_, **ops_))
            for i, (k_, ops_) in enumerate(kept)]
    rows_ok = sweepd_bench.rows_equal(
        out["rows"], sweepd_bench.REFERENCE_KERNEL_ROWS[shape])
    if not rows_ok:
        fail(f"5ak {shape}: rows {out['rows']} != the JAX package's "
             f"{sweepd_bench.REFERENCE_KERNEL_ROWS[shape]}")
    if launches != want or loop_passes:
        fail(f"5ak {shape}: receive launches {launches} (want {want}), "
             f"receive-loop passes {len(loop_passes)} (want 0)")
    if len(kept) != n_req or out["compiles"] != 1 \
            or _build.compiled != built0:
        fail(f"5ak {shape}: kept {len(kept)} ticks, compiles "
             f"{out['compiles']}, sources built {_build.compiled - built0}")
    return dict(out, launches=launches, select=select,
                loop_passes=len(loop_passes), max_abs_err=max(errs),
                rows_equal_reference=rows_ok)


def fused_window_ops(k, ops, select_rows: int) -> int:
    """Operations one window needs on these operands: per peer-tick ~55
    for its one front (injection, fanout TTL, the degree and the graft,
    prune, accept and send masks), the handshake and the ring, ~38 per
    candidate row (ctrl pack, edge read, backoff, targets draw), ~6 per
    message word per edge at most; per selection the data draws, only
    where select_k's early outs need them (0 < k < the eligible count:
    ``drawn_rows``), C lane-hash draws (~10 each), the bitonic network's
    compare-exchanges (two each) and ~3 per lane; under faults ~10 more
    per peer-tick (the dead edges, the graft, fanout and send masks, the
    handshake masks) and ~2 per message word per edge (the heard words
    masked); with cold restart ~3 per ring word per peer-tick (the clear
    and the ring write)."""
    C = k.n_candidates
    W, n = ops["have"].shape
    T = len(ops["seeds"])
    faulted = ops.get("alive") is not None
    cold = ops.get("rejoin") is not None
    hg = ops["recent"].shape[0]
    return (n * T * (55 + 38 * C + 6 * C * W
                     + faulted * (10 + 2 * C * W) + cold * 3 * hg * W)
            + select_rows * (13 * C + 2 * sort_exchanges(C)))


def meshless_cpu_forms() -> dict:
    """The CPU half of 5af/5ag's card-against-CPU matrix: each step form's
    digests on the CPU and their seconds.  It runs in a child process
    while the last kernel sources build, on the cores their nvcc leave
    idle (three threads)."""
    torch.set_num_threads(3)
    from go_libp2p_pubsub_tpu_torch import floodsub_flagship, randomsub_10k

    out = {}
    for phase, mod in (("5af", floodsub_flagship), ("5ag", randomsub_10k)):
        t0 = time.perf_counter()
        digests = mod.forms(torch.device("cpu"))
        out[phase] = (digests, time.perf_counter() - t0)
    return out


def counted_phases(phases: dict):
    """A ``hook(phase)`` for the benches' runs: each phase's seconds and
    the B1 (by variant) and B3 launches it made, the counts reset on
    entry and read after a synchronize."""
    import contextlib

    from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
    from go_libp2p_pubsub_tpu_torch.ops.kernels import select as ksel

    @contextlib.contextmanager
    def hook(phase):
        krecv.launches.clear()
        ksel.launches = 0
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        phases[phase] = dict(seconds=time.perf_counter() - t0,
                             receive=dict(krecv.launches),
                             select=ksel.launches)
    return hook


def serving_row() -> dict:
    """5ao: the serving row as written on the card, in a child process
    spawned once select.cu (its one kernel) is built, while the other
    sources compile; each phase's seconds and launches, and the sources
    this process built."""
    from go_libp2p_pubsub_tpu_torch import serving_bench
    from go_libp2p_pubsub_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    phases: dict = {}
    art = serving_bench.run(torch.device("cuda"),
                            hook=counted_phases(phases))
    art.update(phases=phases, child_sources_built=_build.compiled,
               seconds=time.perf_counter() - t0)
    return art


def trace_cpu_half() -> dict:
    """The CPU half of 5ah: each probe form's digest and the 20,000-peer
    pipeline's trace digest on the CPU, with their seconds.  It runs in
    the child process of ``meshless_cpu_forms``, submitted once the build
    is done (three threads)."""
    torch.set_num_threads(3)
    from go_libp2p_pubsub_tpu_torch import trace_export

    t0 = time.perf_counter()
    forms = trace_export.probe_forms(torch.device("cpu"))
    t_forms = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        rows = trace_export.export(
            trace_export.collect("cpu", trace_export.FORM_PEERS), tmp)
    return dict(forms=forms, forms_s=t_forms, sha256=rows["sha256"],
                n_events=rows["n_events"],
                pipeline_s=time.perf_counter() - t0 - t_forms)


def trace_start(dev, name: str, smi: str) -> dict:
    """5ai's device half (the benchmark collected on the card, counts
    reset just before and read just after) and the 20,000-peer pipeline's
    collection for 5ah; both exports start in a child process (two
    workers, one each), writing into a temporary directory, while the
    later phases run."""
    from go_libp2p_pubsub_tpu_torch import floodsub_flagship, trace_export

    libs0 = floodsub_flagship.reset_kernel_counts()
    t0 = time.perf_counter()
    bundle = trace_export.collect(dev)
    torch.cuda.synchronize()
    launched = floodsub_flagship.kernel_counts(libs0)
    variants = dict(bundle["receive_launches"])
    print(f"5ai collected on the card: {trace_export.N_PEERS} peers, "
          f"{trace_export.T_TEL} telemetry + {trace_export.T_ACQ} "
          f"acquisition + {trace_export.T_RPC} probe ticks in "
          f"{bundle['collect_s']!r} s, peak memory {bundle['peak_bytes']} "
          f"B; launches B1 {launched['receive']} ({variants}), B3 "
          f"{launched['select']}, B2 {launched['fused']} [{name}, {smi}]")
    if launched["fused"] or not launched["receive"] or not launched["select"]:
        fail(f"5ai kernels: {launched}")
    small = trace_export.collect(dev, trace_export.FORM_PEERS)
    tmp = tempfile.TemporaryDirectory()
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    return dict(
        tmp=tmp, pool=pool, launches=launched, variants=variants,
        collect_s=bundle["collect_s"], peak_bytes=bundle["peak_bytes"],
        seconds=time.perf_counter() - t0,
        export=pool.submit(trace_export.export, bundle,
                           Path(tmp.name) / "main"),
        small=pool.submit(trace_export.export, small,
                          Path(tmp.name) / "small", None))


def trace_finish(dev, started: dict, cpu_half: dict, name: str,
                 smi: str) -> dict:
    """5ah on the card against the CPU half, and 5ai's export read back:
    the checks and rows of both phases (the child process stopped, the
    temporary directory removed)."""
    from go_libp2p_pubsub_tpu_torch import trace_export

    t0 = time.perf_counter()
    card = trace_export.probe_forms(dev, check_plain=True)
    t_card = time.perf_counter() - t0
    bad = {label: (row, cpu_half["forms"].get(label))
           for label, row in card.items()
           if not row["plain_equal"]
           or row["digest"] != cpu_half["forms"].get(label, {}).get("digest")}
    print(f"5ah probe forms at {trace_export.FORM_PEERS} peers, "
          f"{trace_export.FORM_TICKS} ticks: {len(card)} card == CPU and "
          f"== the probe-free step: {not bad} (card {t_card:.1f} s, CPU "
          f"{cpu_half['forms_s']:.1f} s in the child process); "
          + json.dumps({k: v["digest"] for k, v in card.items()}))
    if bad or set(card) != set(cpu_half["forms"]):
        fail(f"5ah probe forms differ: {bad}")
    small = started["small"].result()
    print(f"5ah pipeline at {trace_export.FORM_PEERS} peers: card trace "
          f"sha256 {small['sha256']}, CPU {cpu_half['sha256']} "
          f"({small['n_events']} events; CPU run "
          f"{cpu_half['pipeline_s']:.1f} s)")
    if (small["sha256"] != cpu_half["sha256"]
            or small["n_events"] != cpu_half["n_events"]):
        fail("5ah: the card's 20,000-peer trace differs from the CPU's")
    rows = started["export"].result()
    started["pool"].shutdown()
    started["tmp"].cleanup()
    rows.pop("tracestat")
    rows.pop("trace")
    rows.pop("frames")
    rows.update(launches=started["launches"],
                receive_variants=started["variants"])
    ok = (rows["n_types"] == 13 and rows["check_problems"] == []
          and rows["sha256"] == trace_export.REFERENCE_SHA256)
    print(f"5ai the trace-export benchmark as written: {rows['n_events']} "
          f"events, {rows['bytes_total']} B, {rows['n_types']}/13 types, "
          f"collect {rows['collect_s']!r} s (card), export "
          f"{rows['export_s']!r} s, write {rows['write_s']!r} s (host, the "
          f"child process), {rows['events_per_s']!r} events/s, "
          f"{rows['bytes_per_event']!r} B/event, sha256 {rows['sha256']} "
          f"(the reference's: {rows['sha256'] == trace_export.REFERENCE_SHA256}"
          f"), tracestat --check OBS_r10.json problems "
          f"{rows['check_problems']}, peak memory {rows['peak_bytes']} B, "
          f"launches {rows['launches']} ({rows['receive_variants']}) "
          f"[{name}, {smi}]")
    print(f"5ai types: {json.dumps(rows['types'])}")
    if not ok:
        fail(f"5ai: {json.dumps(rows)}")
    return dict(main=rows, forms={k: v["digest"] for k, v in card.items()},
                forms_card_s=t_card, forms_cpu_s=cpu_half["forms_s"],
                pipeline_20k_sha256=small["sha256"])


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs "
             "an NVIDIA GPU")
    import dataclasses

    import numpy as np

    from go_libp2p_pubsub_tpu_torch import (
        adversarial,
        batched_flagship,
        checkpoint_bench,
        churn,
        ckptstat,
        convert,
        everything,
        flagship,
        floodsub_flagship,
        knob_sweep,
        invariants_flagship,
        loops_flagship,
        metrics_bench,
        obsstat,
        pipelined,
        randomsub_10k,
        resident,
        servestat,
        serving_bench,
        sweepd_bench,
        telemetry_flagship,
        tournament,
    )
    from go_libp2p_pubsub_tpu_torch.models import faults
    from go_libp2p_pubsub_tpu_torch.models import gossipsub as pg
    from go_libp2p_pubsub_tpu_torch.models import telemetry as tl
    from go_libp2p_pubsub_tpu_torch.ops import graph
    from go_libp2p_pubsub_tpu_torch.ops.kernels import _build
    from go_libp2p_pubsub_tpu_torch.ops.kernels import fused as kfused
    from go_libp2p_pubsub_tpu_torch.ops.kernels import receive as krecv
    from go_libp2p_pubsub_tpu_torch.ops.kernels import select as ksel
    from go_libp2p_pubsub_tpu_torch.parallel import checkpoint as ckpt

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = flagship.card()
    print(smi)
    print(f"device: {name} x{count}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 2. build the seven kernel sources, concurrently
    t0 = time.perf_counter()
    build_s = {}
    # 5af/5ag's CPU half starts once five sources are built: the other
    # nvcc then leave three cores idle (one child process, stopped after
    # 5ag reads it)
    cpu_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    cpu_forms = []

    # 5an (the sweep server killed and restarted as a process on the card,
    # B3 its one kernel) runs in a thread once select.cu and five more
    # sources are built; read after 5am
    restart_pool = concurrent.futures.ThreadPoolExecutor(1)
    restart_run = []
    # 5ao (the serving row as written, B3 its one kernel) runs in a
    # spawned child once select.cu is built; joined before phase 3
    serving_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    serving_run = []

    def built(src):
        build_s.setdefault(src, time.perf_counter() - t0)
        if "select" in build_s and not serving_run:
            serving_run.append(serving_pool.submit(serving_row))
        if len(build_s) == 5 and not cpu_forms:
            cpu_forms.append(cpu_pool.submit(meshless_cpu_forms))
        if ("select" in build_s and len(build_s) >= 6
                and not restart_run):
            restart_run.append(restart_pool.submit(
                sweepd_bench.restart_check, dev))
    logs = _build.build(("select", *krecv.SOURCES, "fused"), on_done=built)
    if not cpu_forms:
        cpu_forms.append(cpu_pool.submit(meshless_cpu_forms))
    if not restart_run:
        restart_run.append(restart_pool.submit(sweepd_bench.restart_check,
                                               dev))
    if not serving_run:
        serving_run.append(serving_pool.submit(serving_row))
    # 5ah's CPU half follows in the same child once no nvcc is left
    cpu_forms.append(cpu_pool.submit(trace_cpu_half))
    for src, log in logs.items():
        for line in ptxas_summary(log):
            print(f"ptxas[{src}]: {line}")
    for src, sec in sorted(build_s.items(), key=lambda kv: kv[1]):
        print(f"build seconds [{src}.cu]: {sec:.1f}")
    print(f"build: {time.perf_counter() - t0:.1f} s")

    # -- 5ao (joined). the serving row as written, run in its child during
    # the build: its gates
    t0 = time.perf_counter()
    serve = serving_run[0].result()
    serving_pool.shutdown()
    print(f"5ao joined {time.perf_counter() - t0:.1f} s after the build "
          f"(the row took {serve['seconds']:.1f} s in its child)")
    sv_load, sv_over = serve["load"], serve["overload"]
    sv_kill, sv_cold = serve["kill_recovery"], serve["cold_start"]
    sv_ph = serve["phases"]
    print(f"5ao serving as written [{name}, {smi}]: load "
          f"{sv_load['throughput_rps']!r} rps served ({sv_load['served']} "
          f"of {sv_load['admitted']}, {sv_load['timeouts']} timeouts, "
          f"{sv_load['errors']} errors, {sv_load['transient_failures']} "
          f"transient), p50 queue {sv_load['p50_queue_s']!r} s, p99 "
          f"{sv_load['p99_queue_s']!r} s, wall "
          f"{sv_load['wall_s_unrounded']!r} s, compiles "
          f"{serve['compiles']} for {serve['traced_buckets']} traced "
          f"buckets, evictions {serve['evictions']}; overload admitted "
          f"{sv_over['admitted']} rejected {sv_over['rejected_overload']}; "
          f"kill digest {sv_kill['digest']} (the JAX package's "
          f"{serving_bench.REFERENCE_KILL_DIGEST}); cold start traced "
          f"{sv_cold['traced_s']!r} s / {sv_cold['traced_total_s']!r} s, "
          f"AOT {sv_cold['aot_s']!r} s / {sv_cold['aot_total_s']!r} s "
          f"(compiles {sv_cold['aot_compiles']}, loads "
          f"{sv_cold['aot_loads']}); sources built in the children "
          f"{serve['sources_built']} and the row's own "
          f"{serve['child_sources_built']}; phases " + json.dumps(sv_ph))
    if (sv_load["errors"] or sv_load["transient_failures"]
            or sv_over["errors"] or sv_over["transient_failures"]
            or sv_kill["errors"] or sv_kill["transient_failures"]
            or sv_over["admitted"] != 176
            or sv_over["rejected_overload"] != 124
            or sv_kill["digest"] != serving_bench.REFERENCE_KILL_DIGEST
            or sv_cold["aot_compiles"] != 0 or sv_cold["aot_loads"] != 2
            or not sv_cold["bit_identical"]
            or serve["cold_rows"] != serving_bench.REFERENCE_COLD_ROWS
            or sv_ph["load"]["receive"] or not sv_ph["load"]["select"]
            or any(serve["sources_built"]) or serve["child_sources_built"]):
        fail("5ao: " + json.dumps(serve))

    # -- 5ai (its device half). the trace-export benchmark collected on
    # the card; its host-side export (and 5ah's 20,000-peer one) runs in a
    # child process while the later phases run (read before phase 10)
    trace_started = trace_start(dev, name, smi)

    n, C = flagship.N_PEERS, flagship.N_CAND

    # -- 3. select kernel vs plain at 1M peers, C = 16
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    hi = torch.randint(0, 1 << C, (n,), generator=g, device=dev)
    lo = torch.randint(0, 1 << C, (n,), generator=g, device=dev)
    elig = (hi & lo).to(torch.int32)
    kk = torch.randint(0, C + 3, (n,), generator=g, device=dev).to(
        torch.int32)
    seed = graph.lane_seed(7, 2, 0)
    want = ksel.select_k_bits_plain(elig, kk, C, seed, n)
    got = ksel.select_k_bits(elig, kk, C, seed, n)
    torch.cuda.synchronize()
    sel_err = check_identical("select", (got,), (want,))
    sel_ms = device_ms(lambda: ksel.select_k_bits(elig, kk, C, seed, n),
                       200)
    sel_plain_ms = device_ms(
        lambda: ksel.select_k_bits_plain(elig, kk, C, seed, n), 5)
    sel_eager_ms = eager_ms(
        lambda: ksel.select_k_bits(elig, kk, C, seed, n), 200)
    sel_bytes = 3 * 4 * n                     # elig, k in; word out
    sel_ops = select_ops(elig, kk, C)
    print(f"select: identical at N={n}, C={C}; device time: kernel "
          f"{sel_ms:.4f} ms, plain {sel_plain_ms:.3f} ms; issued from "
          f"Python: {sel_eager_ms:.4f} ms per call")
    sel_cfg = ksel.launch_config(n, C)
    print(f"select launch: {sel_cfg['tile']} peers a block (4 a thread), "
          f"{sel_cfg['blocks_per_sm']} blocks a multiprocessor, "
          f"{sel_cfg['smem_bytes']} B dynamic shared memory, grid "
          f"{sel_cfg['grid']}")

    # -- 4. receive kernel vs plain at the flagship shapes
    cfg, sc, params, state, _ = flagship.build(dev, horizon=WARMUP + TIMED)
    k = krecv.receive_consts(cfg, sc)
    ops = random_receive_operands(k, n, 1, dev, seed=11)
    err_rand = check_identical("receive (random operands)",
                               krecv.receive_update(k, **ops),
                               krecv.receive_update_plain(k, **ops))
    step = pg.make_gossip_step(cfg, sc, device=dev)
    tick_ops = capture_receive(
        lambda: pg.gossip_run(params, state, 40, step, device=dev), krecv)
    want = krecv.receive_update_plain(k, **tick_ops)
    got = krecv.receive_update(k, **tick_ops)
    torch.cuda.synchronize()
    err_tick = check_identical("receive (a real tick)", got, want)
    rcv_ms = device_ms(lambda: krecv.receive_update(k, **tick_ops), 50)
    rcv_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k, **tick_ops), 5)
    rcv_eager_ms = eager_ms(lambda: krecv.receive_update(k, **tick_ops), 50)
    rcv_cfg = krecv.launch_config(k)
    rcv_bytes = krecv.operand_bytes(tick_ops, got)
    rcv_ops = receive_ops(k, tick_ops)
    # (5c) exact-k targets alone, on the same two operand sets
    k_xk = dataclasses.replace(k, exact_k=True)
    err_xk = 0.0
    for label, o in (("random operands", ops), ("a real tick", tick_ops)):
        got_xk = krecv.receive_update(k_xk, **o)
        torch.cuda.synchronize()
        err_xk = max(err_xk, check_identical(
            f"exact-k receive ({label})", got_xk,
            krecv.receive_update_plain(k_xk, **o)))
    if torch.equal(got_xk[8], got[8]):
        fail("exact-k receive: the targets equal the Bernoulli draw")
    xk_ms = device_ms(lambda: krecv.receive_update(k_xk, **tick_ops), 50)
    del got_xk, o
    print(f"receive: identical at N={n}, C={C}, W=1 (random and real "
          f"tick); device time: kernel {rcv_ms:.4f} ms, plain "
          f"{rcv_plain_ms:.3f} ms; issued from Python: {rcv_eager_ms:.4f} "
          f"ms per call; {rcv_bytes / n:.1f} B/peer")
    print(f"receive launch (flagship options): tile {rcv_cfg['tile']} "
          f"peers, {rcv_cfg['blocks_per_sm']} blocks a multiprocessor, "
          f"{rcv_cfg['smem_bytes']} B dynamic shared memory (one stage), "
          f"persistent grid {rcv_cfg['grid']}")
    # B2's launch at the resident shapes (clean and with telemetry, L =
    # 16), as its wrapper plans it
    k_res = kfused.fused_consts(pg.GossipSimConfig(
        offsets=pg.make_gossip_offsets(resident.N_TOPICS, resident.N_CAND,
                                       resident.N_PEERS,
                                       seed=resident.OFFSETS_SEED),
        n_topics=resident.N_TOPICS))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, k_l, tel_rows in (
            ("clean", k_res, 0),
            ("telemetry", dataclasses.replace(k_res, telemetry=True,
                                              tel_lat_buckets=16),
             len(krecv.TEL_ROWS) + 16 + kfused.TEL_FUSED_EXTRA)):
        fus_cfg = kfused.launch_config(k_l, resident.N_PEERS)
        plan_l = kfused.launch_plan(1, resident.N_PEERS, tel_rows, sms=sms)
        if (fus_cfg["blocks"], fus_cfg["peers"], fus_cfg["smem_bytes"],
                fus_cfg["front"] == "device") != (
                plan_l["blocks"], plan_l["peers"], plan_l["smem_bytes"],
                bool(plan_l["front_global"])):
            fail(f"fused launch {fus_cfg} != launch_plan {plan_l}")
        print(f"fused launch ({label}, N={resident.N_PEERS}): "
              f"{fus_cfg['blocks']} blocks of {fus_cfg['threads']} threads, "
              f"{fus_cfg['peers']} peers a block (4 a thread's group), "
              f"{fus_cfg['smem_bytes']} B dynamic shared memory, the front "
              f"in {fus_cfg['front']} memory")
    del want, got, ops, tick_ops, params, state, step

    # -- 5. the main path, counts reset just before and read just after
    cfg, sc, params, state, msg_tick = flagship.build(
        dev, horizon=WARMUP + TIMED)
    step = pg.make_gossip_step(cfg, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    krecv.launches.clear()
    ksel.launches = 0
    state = pg.gossip_run(params, state, WARMUP, step, device=dev)
    torch.cuda.synchronize()
    sub = params.subscribed
    deg = pg.mesh_degrees(state)[sub].to(torch.float64).mean().item()
    if not deg >= cfg.d_lo:
        fail(f"mesh failed to form: mean degree {deg}")
    t0 = time.perf_counter()
    state = pg.gossip_run(params, state, TIMED, step, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"receive": krecv.launches["scored"],
                "select": ksel.launches}
    peak = torch.cuda.max_memory_allocated()
    reach = pg.reach_counts_from_have(params, state).cpu().numpy()
    settled = msg_tick < WARMUP + TIMED - 30
    want_reach = flagship.N_PEERS // flagship.N_TOPICS
    if not (reach[settled] == want_reach).all():
        fail(f"delivery gate: reach {reach[settled].tolist()} != "
             f"{want_reach}")
    if launches["receive"] != WARMUP + TIMED:
        fail(f"receive launches {launches['receive']} != ticks "
             f"{WARMUP + TIMED}")
    if launches["select"] <= 0:
        fail("the select kernel was not launched on the main path")
    if state.tick != WARMUP + TIMED:
        fail(f"state tick {state.tick}")
    hb = TIMED / dt
    print(f"main path: {n} peers x {flagship.N_TOPICS} topics, C={C}, "
          f"M={flagship.N_MSGS}: {hb:.2f} heartbeats/s "
          f"({dt * 1e3 / TIMED:.3f} ms/tick), mean mesh degree {deg:.3f}, "
          f"{int(settled.sum())} settled messages all at {want_reach} "
          f"peers, peak memory {peak} B, launches {launches} "
          f"[{name}, {smi}]")

    main_flagship = {
        "heartbeats_per_s": hb, "ms_per_tick": dt * 1e3 / TIMED,
        "peak_bytes": peak, "mean_mesh_degree": deg}
    del params, state, step

    # -- 5a. the attack variant vs plain at the adversarial shapes, all
    # three attack options on
    horizon = WARMUP + TIMED
    cfg, sc, params, state, *_ = adversarial.build(dev, horizon=horizon)
    k_a = krecv.receive_consts(cfg, sc)
    if not (k_a.track_promises and k_a.ihave_spam and k_a.iwant_spam):
        fail(f"adversarial receive consts: {k_a}")
    ops = random_receive_operands(k_a, n, 1, dev, seed=17)
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    ops["syb"] = torch.where(
        torch.rand(n, generator=g, device=dev) < 0.2, (1 << C) - 1, 0).to(
            torch.int32)
    # ledgers around the flood budget (3 windows of up to 32 ids)
    ops["iws"] = torch.randint(0, 4 * 32, (C, n), generator=g,
                               device=dev).to(torch.int16)
    err_arand = check_identical("attack receive (random operands)",
                                krecv.receive_update(k_a, **ops),
                                krecv.receive_update_plain(k_a, **ops))
    step = pg.make_gossip_step(cfg, sc, device=dev)
    tick_ops = capture_receive(
        lambda: pg.gossip_run(params, state, 40, step, device=dev), krecv)
    want = krecv.receive_update_plain(k_a, **tick_ops)
    got = krecv.receive_update(k_a, **tick_ops)
    torch.cuda.synchronize()
    err_atick = check_identical("attack receive (a real tick)", got, want)
    arcv_ms = device_ms(lambda: krecv.receive_update(k_a, **tick_ops), 50)
    arcv_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_a, **tick_ops), 5)
    arcv_bytes = krecv.operand_bytes(tick_ops, got)
    arcv_bound = bound(arcv_bytes, receive_ops(k_a, tick_ops))
    print(f"attack receive: identical at N={n}, C={C}, W=1 (random and "
          f"real tick, {int((tick_ops['syb'] != 0).sum())} sybil words); "
          f"device time: kernel {arcv_ms:.4f} ms, plain "
          f"{arcv_plain_ms:.3f} ms; {arcv_bytes / n:.1f} B/peer, bound "
          f"{arcv_bound[0]:.4f} ms ({arcv_bound[1]})")
    del want, got, ops, tick_ops, params, state, step

    # -- 5b. the adversarial main path, counts reset just before and read
    # just after
    cfg, sc, params, state, msg_topic, msg_tick, _ = adversarial.build(
        dev, horizon=horizon)
    step = pg.make_gossip_step(cfg, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    krecv.launches.clear()
    ksel.launches = 0
    # warm-up tick by tick: the attacks' levels (they fade between
    # publishes, so the end state alone may not show them) and the
    # ledger's bound on every tick
    bp_max = syb_serves = serves_warm = 0
    for _ in range(WARMUP):
        state = pg.gossip_run(params, state, 1, step, device=dev)
        bp_t, syb_t = adversarial.attack_levels(params, state)
        bp_max, syb_serves = max(bp_max, bp_t), max(syb_serves, syb_t)
        serves_warm = max(serves_warm, int(state.iwant_serves.max()))
    torch.cuda.synchronize()
    deg_a = adversarial.honest_degree(params, state)
    if not deg_a >= cfg.d_lo:
        fail(f"adversarial: honest mesh failed to form: mean degree {deg_a}")
    t0 = time.perf_counter()
    state = pg.gossip_run(params, state, TIMED, step, device=dev)
    torch.cuda.synchronize()
    dt_a = time.perf_counter() - t0
    launches_adv = {"receive_attacks": krecv.launches["attacks"],
                    "receive": krecv.launches["scored"],
                    "select": ksel.launches}
    peak_a = torch.cuda.max_memory_allocated()
    gates = adversarial.gates(cfg, params, state, msg_topic, msg_tick,
                              horizon)
    bp_t, syb_t = adversarial.attack_levels(params, state)
    gates.update(behaviour_penalty_max=max(bp_max, bp_t),
                 sybil_serves_max=max(syb_serves, syb_t),
                 warmup_serves_max=serves_warm)
    if not gates["ok"] or serves_warm >= gates["serves_cap"]:
        fail(f"adversarial gates: {gates}")
    if not (gates["behaviour_penalty_max"] > 0
            and gates["sybil_serves_max"] > 0):
        fail(f"adversarial: the attacks were not live: {gates}")
    if (launches_adv["receive_attacks"] != horizon
            or launches_adv["receive"] or launches_adv["select"] <= 0):
        fail(f"adversarial launches {launches_adv}")
    if state.tick != horizon:
        fail(f"adversarial: state tick {state.tick}")
    hb_a = TIMED / dt_a
    print(f"adversarial path: {n} peers x {adversarial.N_TOPICS} topics, "
          f"20% sybils spamming IHAVEs and flooding IWANTs: {hb_a:.2f} "
          f"heartbeats/s ({dt_a * 1e3 / TIMED:.3f} ms/tick), honest mean "
          f"mesh degree {gates['honest_mean_degree']:.3f}, "
          f"{gates['settled_messages']} settled messages at every honest "
          f"member, iwant_serves max {gates['serves_max']} at the end, "
          f"{serves_warm} over the warm-up ticks (< {gates['serves_cap']}), "
          f"sybil rows max "
          f"{gates['sybil_serves_max']}, behaviour_penalty max "
          f"{gates['behaviour_penalty_max']}, peak memory {peak_a} B, "
          f"launches {launches_adv} [{name}, {smi}]")
    main_adversarial = dict(
        gates, heartbeats_per_s=hb_a, ms_per_tick=dt_a * 1e3 / TIMED,
        peak_bytes=peak_a, launches=launches_adv)
    del params, state, step

    # -- 5c. the full variant vs plain: all four router-surface options
    # and the three attack options, on random operands and on a real tick
    # of the everything-on sim (there also as the main path runs it)
    cfg, sc, params, state, _, msg_tick, _ = everything.build(
        dev, horizon=horizon)
    k_e = krecv.receive_consts(cfg, sc, px=True, same_ip=True)
    k_all = dataclasses.replace(k_e, exact_k=True)
    if not (k_all.flood_publish and k_all.with_px and k_all.with_same_ip
            and k_all.track_promises and k_all.ihave_spam
            and k_all.iwant_spam and k_e.full and not k_e.exact_k):
        fail(f"everything receive consts: {k_e}")
    ops = full_receive_operands(k_all, n, dev, seed=23)
    got = krecv.receive_update(k_all, **ops)
    torch.cuda.synchronize()
    err_full = check_identical("full receive (random operands)", got,
                               krecv.receive_update_plain(k_all, **ops))
    if len(got) != 16 or not got[-1].any():
        fail("full receive: no PX trigger word")
    step = pg.make_gossip_step(cfg, sc, device=dev)
    # two real ticks: tick 3, mesh formation (PRUNEs and PRUNE-responses
    # arrive: the trigger word is live), and the first tick after warm-up
    # on which some peer publishes (its ctrl bytes carry CTRL_FLOOD)
    box = [state]

    def run_to(tick):
        box[0] = pg.gossip_run(params, box[0], tick + 1 - box[0].tick, step,
                               device=dev)

    tick_ops = capture_receive(lambda: run_to(3), krecv)
    got = krecv.receive_update(k_all, **tick_ops)
    torch.cuda.synchronize()
    err_full = max(err_full, check_identical(
        "full receive (tick 3, all options)", got,
        krecv.receive_update_plain(k_all, **tick_ops)))
    triggers = int((got[-1] != 0).sum())
    if triggers <= 0:
        fail("full receive: no PX trigger word on tick 3")
    t_pub = int(msg_tick[msg_tick >= 30][0])
    tick_ops = capture_receive(lambda: run_to(t_pub), krecv)
    for label, k_ in (("all options", k_all), ("as the main path", k_e)):
        want = krecv.receive_update_plain(k_, **tick_ops)
        got = krecv.receive_update(k_, **tick_ops)
        torch.cuda.synchronize()
        err_full = max(err_full, check_identical(
            f"full receive (a real tick, {label})", got, want))
    full_ms = device_ms(lambda: krecv.receive_update(k_e, **tick_ops), 50)
    full_all_ms = device_ms(lambda: krecv.receive_update(k_all, **tick_ops),
                            50)
    full_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_e, **tick_ops), 5)
    full_bytes = krecv.operand_bytes(tick_ops, got)
    full_bound = bound(full_bytes, receive_ops(k_e, tick_ops))
    flood_edges = int(((tick_ops["ctrl"] >> krecv.CTRL_FLOOD) & 1).sum())
    if flood_edges <= 0:
        fail(f"full receive: no flood edge on tick {t_pub}")
    print(f"full receive: identical at N={n}, C={C}, W=1 (random and real "
          f"ticks 3 and {t_pub}; flood, exact-k, PX, same-IP and the attack "
          f"options; {triggers} trigger words on tick 3, {flood_edges} "
          f"flood edges on tick {t_pub}); "
          f"device time: kernel {full_ms:.4f} ms as the main path runs it "
          f"(Bernoulli targets), {full_all_ms:.4f} ms with exact-k too, "
          f"plain {full_plain_ms:.3f} ms; {full_bytes / n:.1f} B/peer, bound "
          f"{full_bound[0]:.4f} ms ({full_bound[1]}); exact-k alone on the "
          f"flagship's options: identical, {xk_ms:.4f} ms")
    del want, got, ops, tick_ops, params, state, step, box

    # -- 5d. the everything-on main path, counts reset just before and
    # read just after
    cfg, sc, params, state, msg_topic, msg_tick, _ = everything.build(
        dev, horizon=horizon)
    active0 = state.active
    step = pg.make_gossip_step(cfg, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_e = torch.cuda.memory_allocated()
    krecv.launches.clear()
    ksel.launches = 0
    # warm-up tick by tick: the attacks' levels, the ledger's bound, the
    # direct edges out of every mesh and the flood bits on the ctrl bytes
    bp_max = syb_serves = serves_warm = direct_meshed = 0
    flood_bytes = torch.zeros((), dtype=torch.int64, device=dev)
    real_receive = krecv.receive_update

    def watch_flood(k_, **ops_):
        flood_bytes.add_(((ops_["ctrl"] >> krecv.CTRL_FLOOD) & 1).sum())
        return real_receive(k_, **ops_)

    krecv.receive_update = watch_flood
    try:
        for _ in range(WARMUP):
            state = pg.gossip_run(params, state, 1, step, device=dev)
            bp_t, syb_t = adversarial.attack_levels(params, state)
            bp_max, syb_serves = max(bp_max, bp_t), max(syb_serves, syb_t)
            serves_warm = max(serves_warm, int(state.iwant_serves.max()))
            direct_meshed += everything.direct_in_mesh(params, state)
    finally:
        krecv.receive_update = real_receive
    torch.cuda.synchronize()
    deg_e = adversarial.honest_degree(params, state)
    if not deg_e >= cfg.d_lo:
        fail(f"everything: honest mesh failed to form: mean degree {deg_e}")
    t0 = time.perf_counter()
    state = pg.gossip_run(params, state, TIMED, step, device=dev)
    torch.cuda.synchronize()
    dt_e = time.perf_counter() - t0
    launches_ev = {"receive_full": krecv.launches["full"],
                   "receive_attacks": krecv.launches["attacks"],
                   "receive": krecv.launches["scored"],
                   "receive_unscored": krecv.launches["unscored"],
                   "select": ksel.launches}
    peak_e = torch.cuda.max_memory_allocated()
    gates_e = adversarial.gates(cfg, params, state, msg_topic, msg_tick,
                                horizon)
    bp_t, syb_t = adversarial.attack_levels(params, state)
    live = everything.options_live(params, active0, state)
    live["direct_in_mesh"] += direct_meshed
    live["flood_ctrl_bytes_warmup"] = int(flood_bytes)
    gates_e.update(behaviour_penalty_max=max(bp_max, bp_t),
                   sybil_serves_max=max(syb_serves, syb_t),
                   warmup_serves_max=serves_warm, **live)
    if not gates_e["ok"] or serves_warm >= gates_e["serves_cap"]:
        fail(f"everything gates: {gates_e}")
    # (the attacks' levels are reported, not gated: behind shared
    # addresses P6 graylists the sybils, which mutes their adverts)
    if not (live["active_rotated"] > 0 and live["direct_in_mesh"] == 0
            and int(params.cand_direct.ne(0).sum()) > 0
            and live["flood_ctrl_bytes_warmup"] > 0
            and live["same_ip_words"] and live["sybil_static_min"] < 0):
        fail(f"everything: an option was not live: {live}")
    if (launches_ev["receive_full"] != horizon
            or launches_ev["receive_attacks"] or launches_ev["receive"]
            or launches_ev["receive_unscored"]
            or launches_ev["select"] <= 0):
        fail(f"everything launches {launches_ev}")
    if state.tick != horizon:
        fail(f"everything: state tick {state.tick}")
    hb_e = TIMED / dt_e
    print(f"everything path: {n} peers x {adversarial.N_TOPICS} topics, 20% "
          f"sybils four to an address spamming IHAVEs and flooding IWANTs, "
          f"flood publishing, PX over {everything.PX_CANDIDATES} of {C} "
          f"candidates, direct overlay: {hb_e:.2f} heartbeats/s "
          f"({dt_e * 1e3 / TIMED:.3f} ms/tick), honest mean mesh degree "
          f"{gates_e['honest_mean_degree']:.3f}, "
          f"{gates_e['settled_messages']} settled messages at every honest "
          f"member, iwant_serves max {gates_e['serves_max']} at the end, "
          f"{serves_warm} over the warm-up ticks (< {gates_e['serves_cap']}),"
          f" sybil rows max {gates_e['sybil_serves_max']}, "
          f"behaviour_penalty max {gates_e['behaviour_penalty_max']}, "
          f"options {live}, peak memory {peak_e} B ({alloc0_e} B at the "
          f"start), launches {launches_ev} "
          f"[{name}, {smi}]")
    main_everything = dict(
        gates_e, heartbeats_per_s=hb_e, ms_per_tick=dt_e * 1e3 / TIMED,
        peak_bytes=peak_e, start_bytes=alloc0_e, launches=launches_ev)
    del params, state, active0, step

    # -- 5e. exact-k on the fused path: the kernel vs plain on one window
    # of the exact-k resident configuration after 12 per-tick steps, then
    # 64 heartbeats on fused windows against the same ticks one by one
    Tw = resident.WINDOW
    cfg_x, params, state, *_ = resident.build(dev, horizon=64, exact_k=True)
    n_x = resident.N_PEERS
    k_fx = kfused.fused_consts(cfg_x)
    if not k_fx.receive.exact_k:
        fail(f"exact-k fused consts: {k_fx}")
    step_x = pg.make_gossip_step(cfg_x, None, device=dev)
    st = pg.gossip_run(params, state, 12, step_x, device=dev)
    tk = torch.arange(st.tick, st.tick + Tw, dtype=torch.int32, device=dev)
    all_c = (1 << cfg_x.n_candidates) - 1
    fops = dict(
        tick0=st.tick, seeds=kfused.window_seeds(st.tick, Tw, st.salt),
        due=graph.pack_bits(params.publish_tick[None, :] == tk[:, None]),
        sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
        cand_sub=params.cand_sub_bits, origin=params.origin_words,
        have=st.have, recent=st.recent, mesh=st.mesh, fanout=st.fanout,
        last_pub=st.last_pub, backoff=st.backoff, tgt=st.gates[0],
        bog=st.gates[1])
    sel_rows_x = [0]
    real_sel = kfused.select_plain

    def count_sel_x(elig, kk, c, seed):
        sel_rows_x[0] += drawn_rows(elig, kk)
        return real_sel(elig, kk, c, seed)

    kfused.select_plain = count_sel_x
    try:
        want = kfused.fused_gossip_update_plain(k_fx, **fops)
    finally:
        kfused.select_plain = real_sel
    got = kfused.fused_gossip_update(k_fx, **fops)
    torch.cuda.synchronize()
    err_fx = check_identical("exact-k fused window", got, want)
    fx_ms = eager_ms(lambda: kfused.fused_gossip_update(k_fx, **fops), 20)
    fx_plain_ms = eager_ms(
        lambda: kfused.fused_gossip_update_plain(k_fx, **fops), 2)
    # the targets' selections: one more per peer-tick with candidates
    fx_rows = sel_rows_x[0] + n_x * Tw
    fx_bound = bound(kfused.window_operand_bytes(fops),
                     fused_window_ops(k_fx, fops, fx_rows))
    del want, got, fops, st
    win_x = pg.make_fused_window(cfg_x, None, ticks_fused=Tw, device=dev)
    krecv.launches.clear()
    ksel.launches = kfused.launches = 0
    end_fused = pg.gossip_run_fused(params, state, 64, win_x, device=dev)
    torch.cuda.synchronize()
    counts_x = {"fused": kfused.launches,
                "receive_full": krecv.launches["full"],
                "receive_unscored": krecv.launches["unscored"],
                "select": ksel.launches}
    if counts_x != {"fused": 64 // Tw, "receive_full": 0,
                    "receive_unscored": 0, "select": 0}:
        fail(f"exact-k fused launches {counts_x}")
    d_fx = digest(end_fused)
    d_tx = digest(pg.gossip_run(params, state, 64, step_x, device=dev))
    if d_fx != d_tx or krecv.launches["full"] != 64:
        fail(f"exact-k digest: per-tick {d_tx} != fused {d_fx} "
             f"(full launches {krecv.launches['full']})")
    deg_x = pg.mesh_degrees(end_fused)[params.subscribed].to(
        torch.float64).mean().item()
    if not deg_x >= cfg_x.d_lo:
        fail(f"exact-k fused: mesh failed to form: mean degree {deg_x}")
    print(f"exact-k fused window: identical at N={n_x}, C={C}, W=1, T={Tw}; "
          f"kernel {fx_ms:.4f} ms, plain {fx_plain_ms:.3f} ms per window, "
          f"bound {fx_bound[0]:.4f} ms ({fx_bound[1]}); 64 heartbeats on "
          f"{counts_x['fused']} fused windows and one by one (the unscored "
          f"full variant, 64 launches): digest {d_fx} both, mean mesh "
          f"degree {deg_x:.3f}")
    del params, state, end_fused

    # -- 5f. the paired variant vs plain: the main path's options (the
    # three attack options, PX, the shared-IP gater) with slot B, on
    # random operands (flood publishing and exact-k on too) and on a real
    # tick of the paired everything-on sim after warm-up
    cfg, sc, params, state, _, msg_tick, _ = everything.build(
        dev, horizon=horizon, paired=True)
    k_p = krecv.receive_consts(cfg, sc, px=True, same_ip=True)
    k_pall = dataclasses.replace(k_p, flood_publish=True, exact_k=True)
    if not (k_p.paired and k_p.with_px and k_p.with_same_ip
            and k_p.track_promises and k_p.ihave_spam and k_p.iwant_spam
            and not k_p.flood_publish and not k_p.exact_k
            and 0 < k_p.odd_mask < (1 << C) - 1):
        fail(f"paired receive consts: {k_p}")
    ops = paired_receive_operands(
        k_pall, full_receive_operands(k_pall, n, dev, seed=29), n, dev,
        seed=31)
    got = krecv.receive_update(k_pall, **ops)
    torch.cuda.synchronize()
    err_paired = check_identical("paired receive (random operands)", got,
                                 krecv.receive_update_plain(k_pall, **ops))
    if len(got) != 20 or not got[2].any() or not got[-1].any():
        fail("paired receive: no slot-B mesh or no PX trigger word")
    step = pg.make_gossip_step(cfg, sc, device=dev)
    box = [state]

    def run_to(tick):
        box[0] = pg.gossip_run(params, box[0], tick + 1 - box[0].tick, step,
                               device=dev)

    # the first tick after warm-up whose operands carry a slot-B GRAFT
    # and a GRAFT or PRUNE on an odd edge: the settled meshes are quiet
    # until opportunistic grafting (tick 60) starts a wave of grafts
    t_real = sc.opportunistic_graft_ticks
    for _ in range(20):
        tick_ops = capture_receive(lambda: run_to(t_real), krecv)
        sent = (tick_ops["grafts"] | tick_ops["dropped"]
                | tick_ops["grafts_b"] | tick_ops["dropped_b"])
        graft_b_live = int((tick_ops["grafts_b"] != 0).sum())
        odd_live = int((sent & k_p.odd_mask != 0).sum())
        if graft_b_live and odd_live:
            break
        t_real += 1
    else:
        fail(f"paired receive: no slot-B GRAFT and odd-edge handshake on "
             f"ticks {sc.opportunistic_graft_ticks}-{t_real}")
    ops_all = dict(tick_ops, inj_send=tick_ops["injected"])
    for label, k_, o in (("all options", k_pall, ops_all),
                         ("as the main path", k_p, tick_ops)):
        want = krecv.receive_update_plain(k_, **o)
        got = krecv.receive_update(k_, **o)
        torch.cuda.synchronize()
        err_paired = max(err_paired, check_identical(
            f"paired receive (tick {t_real}, {label})", got, want))
    paired_ms = device_ms(lambda: krecv.receive_update(k_p, **tick_ops), 50)
    paired_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_p, **tick_ops), 5)
    paired_bytes = krecv.operand_bytes(tick_ops, got)
    paired_bound = bound(paired_bytes, receive_ops(k_p, tick_ops))
    print(f"paired receive: identical at N={n}, C={C}, W=1 (random "
          f"operands with every option; real tick {t_real} with the main "
          f"path's options and with all: {graft_b_live} slot-B GRAFT words, "
          f"{odd_live} peers sending on an odd edge, odd mask "
          f"{k_p.odd_mask:#06x}); device time: kernel {paired_ms:.4f} ms as "
          f"the main path runs it, plain {paired_plain_ms:.3f} ms; "
          f"{paired_bytes / n:.1f} B/peer, bound {paired_bound[0]:.4f} ms "
          f"({paired_bound[1]})")
    del want, got, o, ops, ops_all, tick_ops, params, state, step, box

    # the unscored paired variant at the resident shapes: random operands,
    # then the last of 64 heartbeats of an unscored paired sim, its
    # launches counted
    n_r = resident.N_PEERS
    cfg_up, params, state, *_ = resident.build(dev, horizon=RES_WARMUP,
                                               paired=True)
    k_up = krecv.receive_consts(cfg_up, None)
    if not (k_up.paired and not k_up.scored
            and 0 < k_up.odd_mask < (1 << C) - 1):
        fail(f"unscored paired receive consts: {k_up}")
    ops = paired_receive_operands(
        k_up, random_receive_operands(k_up, n_r, 1, dev, seed=37), n_r, dev,
        seed=41)
    err_up = check_identical("unscored paired receive (random operands)",
                             krecv.receive_update(k_up, **ops),
                             krecv.receive_update_plain(k_up, **ops))
    step_up = pg.make_gossip_step(cfg_up, None, device=dev)
    box = [state]
    torch.cuda.synchronize()
    krecv.launches.clear()
    ksel.launches = 0
    tick_ops = capture_receive(lambda: box.append(pg.gossip_run(
        params, state, RES_WARMUP, step_up, device=dev)), krecv)
    torch.cuda.synchronize()
    launches_up = {"receive_paired_unscored":
                   krecv.launches["paired_unscored"],
                   "receive_unscored": krecv.launches["unscored"],
                   "receive_paired": krecv.launches["paired"],
                   "receive_full": krecv.launches["full"],
                   "select": ksel.launches}
    if (launches_up["receive_paired_unscored"] != RES_WARMUP
            or launches_up["receive_unscored"] or launches_up["receive_paired"]
            or launches_up["receive_full"] or launches_up["select"] <= 0):
        fail(f"unscored paired launches {launches_up}")
    end_up = box[-1]
    sub = params.subscribed
    deg_ua = pg.mesh_degrees(end_up)[sub].to(torch.float64).mean().item()
    deg_ub = graph.popcount32(end_up.mesh_b)[sub].to(
        torch.float64).mean().item()
    if not (deg_ua >= cfg_up.d_lo and deg_ub >= cfg_up.d_lo):
        fail(f"unscored paired: meshes failed to form: mean degrees "
             f"{deg_ua}, {deg_ub}")
    want = krecv.receive_update_plain(k_up, **tick_ops)
    got = krecv.receive_update(k_up, **tick_ops)
    torch.cuda.synchronize()
    err_up = max(err_up, check_identical(
        "unscored paired receive (a real tick)", got, want))
    up_ms = device_ms(lambda: krecv.receive_update(k_up, **tick_ops), 50)
    up_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_up, **tick_ops), 5)
    up_bytes = krecv.operand_bytes(tick_ops, got)
    up_bound = bound(up_bytes, receive_ops(k_up, tick_ops))
    print(f"unscored paired receive: identical at N={n_r}, C={C}, W=1 "
          f"(random operands and tick {end_up.tick - 1} of {RES_WARMUP} "
          f"heartbeats, mean mesh degrees {deg_ua:.3f} and {deg_ub:.3f}, "
          f"launches {launches_up}); device time: kernel {up_ms:.4f} ms, "
          f"plain {up_plain_ms:.3f} ms; {up_bytes / n_r:.1f} B/peer, bound "
          f"{up_bound[0]:.4f} ms ({up_bound[1]})")
    del want, got, ops, tick_ops, params, state, step_up, box, end_up

    # -- 5g. the fifth slice's main path: the everything-on benchmark as
    # written
    # (paired topics), counts reset just before and read just after
    cfg, sc, params, state, msg_topic, msg_tick, _ = everything.build(
        dev, horizon=horizon, paired=True)
    active0 = state.active
    step = pg.make_gossip_step(cfg, sc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_p = torch.cuda.memory_allocated()
    krecv.launches.clear()
    ksel.launches = 0
    bp_max = syb_serves = serves_warm = direct_meshed = 0
    for _ in range(WARMUP):
        state = pg.gossip_run(params, state, 1, step, device=dev)
        bp_t, syb_t = adversarial.attack_levels(params, state)
        bp_max, syb_serves = max(bp_max, bp_t), max(syb_serves, syb_t)
        serves_warm = max(serves_warm, int(state.iwant_serves.max()))
        direct_meshed += everything.direct_in_mesh(params, state)
    torch.cuda.synchronize()
    deg_p = adversarial.honest_degree(params, state)
    if not deg_p >= cfg.d_lo:
        fail(f"everything paired: honest mesh failed to form: mean degree "
             f"{deg_p}")
    t0 = time.perf_counter()
    state = pg.gossip_run(params, state, TIMED, step, device=dev)
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t0
    launches_pp = {"receive_paired": krecv.launches["paired"],
                   "receive_paired_unscored":
                   krecv.launches["paired_unscored"],
                   "receive_full": krecv.launches["full"],
                   "receive_attacks": krecv.launches["attacks"],
                   "receive": krecv.launches["scored"],
                   "receive_unscored": krecv.launches["unscored"],
                   "select": ksel.launches}
    peak_p = torch.cuda.max_memory_allocated()
    gates_p = adversarial.gates(cfg, params, state, msg_topic, msg_tick,
                                horizon)
    bp_t, syb_t = adversarial.attack_levels(params, state)
    live = everything.options_live(params, active0, state, cfg)
    live["direct_in_mesh"] += direct_meshed
    gates_p.update(behaviour_penalty_max=max(bp_max, bp_t),
                   sybil_serves_max=max(syb_serves, syb_t),
                   warmup_serves_max=serves_warm, **live)
    if not gates_p["ok"] or serves_warm >= gates_p["serves_cap"]:
        fail(f"everything paired gates: {gates_p}")
    if not (live["mesh_b_peers"] > 0 and live["time_in_mesh_b_max"] > 0
            and live["odd_in_mesh_b"] > 0
            and live["honest_mean_degree_b"] >= cfg.d_lo):
        fail(f"everything paired: paired topics not live: {live}")
    if not (live["active_rotated"] > 0 and live["direct_in_mesh"] == 0
            and int(params.cand_direct.ne(0).sum()) > 0
            and live["same_ip_words"] and live["sybil_static_min"] < 0):
        fail(f"everything paired: an option was not live: {live}")
    if (launches_pp["receive_paired"] != horizon or launches_pp["select"] <= 0
            or any(v for key, v in launches_pp.items()
                   if key not in ("receive_paired", "select"))):
        fail(f"everything paired launches {launches_pp}")
    if state.tick != horizon:
        fail(f"everything paired: state tick {state.tick}")
    box = [state]

    def run_more():
        box[0] = pg.gossip_run(params, box[0], 20, step, device=dev)

    prof_p = flagship.profile_ticks(run_more, 20)
    hb_p = TIMED / dt_p
    print(f"everything paired path (the benchmark as written): {n} peers x "
          f"{adversarial.N_TOPICS} topics, two topics a peer, 20% sybils "
          f"four to an address spamming IHAVEs and flooding IWANTs, PX over "
          f"{everything.PX_CANDIDATES} of {C} candidates, direct overlay: "
          f"{hb_p:.2f} heartbeats/s ({dt_p * 1e3 / TIMED:.3f} ms/tick), "
          f"honest mean mesh degree {gates_p['honest_mean_degree']:.3f} "
          f"(slot B {live['honest_mean_degree_b']:.3f}), "
          f"{gates_p['settled_messages']} settled messages at every honest "
          f"member of both classes, iwant_serves max "
          f"{gates_p['serves_max']} at the end, {serves_warm} over the "
          f"warm-up ticks (< {gates_p['serves_cap']}), sybil rows max "
          f"{gates_p['sybil_serves_max']}, behaviour_penalty max "
          f"{gates_p['behaviour_penalty_max']}, options {live}, peak "
          f"memory {peak_p} B ({alloc0_p} B at the start), launches "
          f"{launches_pp}; 20 more heartbeats "
          f"profiled: {prof_p['wall_ms_per_tick']:.3f} ms/tick wall, "
          f"{prof_p['device_busy_ms_per_tick']:.3f} busy, idle share "
          f"{prof_p['device_idle_share']:.3f} [{name}, {smi}]")
    main_paired = dict(
        gates_p, heartbeats_per_s=hb_p, ms_per_tick=dt_p * 1e3 / TIMED,
        peak_bytes=peak_p, start_bytes=alloc0_p, launches=launches_pp,
        device_idle_share=prof_p["device_idle_share"],
        device_busy_ms_per_tick=prof_p["device_busy_ms_per_tick"],
        profile_kernels=prof_p["kernels"][:8])
    del params, state, active0, step, box

    # -- 5h. B1 under faults against its plain version, each family, on
    # seeded random operands (a tenth of the peers down) and on a real
    # tick of a 1M-peer sim under the churn benchmark's schedule: tick
    # 130, inside the third churn wave and the partition; the faulted
    # variant's launches counted over the run to it
    t_real = churn.heal_tick() - 20
    faulted = {}

    def faulted_tick(label, sim, k):
        """Run ``sim`` (cfg, sc, params, state), its compiled churn
        schedule attached, to tick ``t_real`` with the launch counts
        reset; the operands of that tick, the schedule's masks there and
        the launches of each receive variant over the run."""
        cfg_, sc_, params_, state_ = sim
        step_ = pg.make_gossip_step(cfg_, sc_, device=dev)
        krecv.launches.clear()
        ops_ = capture_receive(lambda: pg.gossip_run(
            params_, state_, t_real + 1, step_, device=dev), krecv)
        torch.cuda.synchronize()
        launched = dict(krecv.launches)
        if launched != {krecv.variant(k): t_real + 1}:
            fail(f"{label}: launches {launched}")
        fm = faults.tick_masks(params_.faults, cfg_.offsets, cfg_.cinv,
                               t_real)
        down = int((ops_["alive_w"] == 0).sum())
        cut = int(graph.popcount32(fm.alive_all & ~fm.send_ok).sum())
        if not (down > 0 and cut > 0):
            fail(f"{label}: tick {t_real} has {down} down peers and {cut} "
                 "cut edges")
        return ops_, down, cut, t_real + 1

    def faulted_check(label, k, rand_ops, tick_ops, down, cut, launched,
                      tick=t_real, k_rand=None):
        """The faulted variant ``k`` against its plain version on the
        random operands (with the options of ``k_rand`` where given) and
        the real tick's, timed on the real tick."""
        k_rand = k if k_rand is None else k_rand
        got = krecv.receive_update(k_rand, **rand_ops)
        torch.cuda.synchronize()
        err = check_identical(f"{label} (random operands)", got,
                              krecv.receive_update_plain(k_rand, **rand_ops))
        want = krecv.receive_update_plain(k, **tick_ops)
        got = krecv.receive_update(k, **tick_ops)
        torch.cuda.synchronize()
        err = max(err, check_identical(f"{label} (tick {tick})", got,
                                       want))
        ms = device_ms(lambda: krecv.receive_update(k, **tick_ops), 50)
        plain = device_ms(lambda: krecv.receive_update_plain(k, **tick_ops),
                          5)
        nbytes = krecv.operand_bytes(tick_ops, got)
        bnd = bound(nbytes, receive_ops(k, tick_ops))
        n_ = tick_ops["sub_all"].shape[0]
        print(f"{label}: identical at N={n_}, C={C}, W=1 (random operands "
              f"with a tenth of the peers down; tick {tick}: {down} down "
              f"peers, {cut} cut edges); device time: kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms; {nbytes / n_:.1f} B/peer, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}); {launched} launches to tick "
              f"{tick}")
        return dict(err=err, ms=ms, plain_ms=plain, bytes_per_peer=nbytes / n_,
                    bound=bnd, launches=launched)

    def with_schedule(sim, seed):
        cfg_, sc_, params_, state_ = sim[:4]
        sched = churn.schedule(n, np.random.default_rng(seed), churn.WARMUP,
                               churn.WARMUP + churn.TIMED)
        return cfg_, sc_, dataclasses.replace(
            params_, faults=faults.compile_faults(sched, cfg_.offsets,
                                                  device=dev)), state_

    # the scored flagship options: the churn benchmark's own sim, built
    # once for this check and the main path (5i: the step leaves its input
    # state as it was)
    churn_sim = churn.build(dev)
    k_f = krecv.receive_consts(churn_sim[0], churn_sim[1], faults=True)
    tick_ops, down, cut, nl = faulted_tick("churn", churn_sim[:4], k_f)
    faulted["receive_update_faults"] = faulted_check(
        "faulted receive", k_f,
        fault_operands(k_f, random_receive_operands(k_f, n, 1, dev, seed=43),
                       dev, 47), tick_ops, down, cut, nl)
    del tick_ops
    # the attack options (the IWANT flood's flood_ok word live)
    sim = with_schedule(adversarial.build(dev, horizon=horizon), 1)
    k_fa = krecv.receive_consts(sim[0], sim[1], faults=True)
    rand = random_receive_operands(k_fa, n, 1, dev, seed=53)
    g = torch.Generator(device=dev)
    g.manual_seed(59)
    rand["syb"] = torch.where(torch.rand(n, generator=g, device=dev) < 0.2,
                              (1 << C) - 1, 0).to(torch.int32)
    rand["iws"] = torch.randint(0, 4 * 32, (C, n), generator=g,
                                device=dev).to(torch.int16)
    tick_ops, down, cut, nl = faulted_tick("attack", sim, k_fa)
    faulted["receive_update_attacks_faults"] = faulted_check(
        "faulted attack receive", k_fa, fault_operands(k_fa, rand, dev, 61),
        tick_ops, down, cut, nl)
    del tick_ops, sim, rand
    # the full variant (flood publishing, PX, the shared-IP gater, the
    # attack options; exact-k on the random operands)
    sim = with_schedule(everything.build(dev, horizon=horizon), 2)
    k_fe = krecv.receive_consts(sim[0], sim[1], px=True, same_ip=True,
                                faults=True)
    k_fall = dataclasses.replace(k_fe, exact_k=True)
    tick_ops, down, cut, nl = faulted_tick("full", sim, k_fe)
    rand = fault_operands(k_fall, full_receive_operands(k_fall, n, dev,
                                                        seed=67), dev, 71)
    r_all = faulted_check("faulted full receive (exact-k too)", k_fall, rand,
                          tick_ops, down, cut, nl)
    r = faulted_check("faulted full receive", k_fe, rand, tick_ops, down,
                      cut, nl, k_rand=k_fall)
    r["err"] = max(r["err"], r_all["err"])
    faulted["receive_update_full_faults"] = r
    del tick_ops, sim, rand
    # the paired variant
    sim = with_schedule(everything.build(dev, horizon=horizon, paired=True),
                        3)
    k_fp = krecv.receive_consts(sim[0], sim[1], px=True, same_ip=True,
                                faults=True)
    k_fpall = dataclasses.replace(k_fp, flood_publish=True, exact_k=True)
    tick_ops, down, cut, nl = faulted_tick("paired", sim, k_fp)
    faulted["receive_update_paired_faults"] = faulted_check(
        "faulted paired receive", k_fp, fault_operands(
            k_fpall, paired_receive_operands(
                k_fpall, full_receive_operands(k_fpall, n, dev, seed=73), n,
                dev, seed=79), dev, 83), tick_ops, down, cut, nl,
        k_rand=k_fpall)
    del tick_ops, sim

    # -- 5i. the slice's main path: the churn benchmark as written, counts
    # reset just before and read just after
    cfg, sc, params, state, msg_tick, probes = churn_sim
    del churn_sim
    step = pg.make_gossip_step(cfg, sc, device=dev)
    ticks_c = churn.WARMUP + churn.TIMED
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_c = torch.cuda.memory_allocated()
    krecv.launches.clear()
    ksel.launches = kfused.launches = kfused.launches_faults = 0
    state = pg.gossip_run(params, state, churn.WARMUP, step, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, counts_c = pg.gossip_run_curve(params, state, churn.TIMED, step,
                                          flagship.N_MSGS, device=dev)
    torch.cuda.synchronize()
    dt_c = time.perf_counter() - t0
    launches_c = dict(krecv.launches, select=ksel.launches)
    peak_c = torch.cuda.max_memory_allocated()
    rows_c = churn.readouts(params, state, counts_c, probes, cfg.n_topics)
    fp = params.faults
    down_c = max(int((~faults.alive_mask(fp, t)).sum())
                 for t in range(churn.WARMUP, ticks_c, 5))
    fm = faults.tick_masks(fp, cfg.offsets, cfg.cinv, t_real)
    cut_c = int(graph.popcount32(fm.alive_all & ~fm.send_ok).sum())
    if not rows_c["ok"]:
        fail(f"churn gates: {rows_c}")
    if not (down_c > 0 and cut_c > 0 and rows_c["delivery_fraction"] < 1):
        fail(f"churn: faults not live: {down_c} down, {cut_c} cut edges, "
             f"delivery fraction {rows_c['delivery_fraction']}")
    if (dict(krecv.launches) != {"scored_faults": ticks_c}
            or launches_c["select"] <= 0):
        fail(f"churn launches {launches_c}")
    if state.tick != ticks_c:
        fail(f"churn: state tick {state.tick}")
    link_ms = churn.link_draw_ms(cfg, params, t_real)
    box = [state]

    def run_more_c():
        box[0] = pg.gossip_run(params, box[0], 20, step, device=dev)

    prof_c = flagship.profile_ticks(run_more_c, 20)
    hb_c = churn.TIMED / dt_c
    print(f"churn path (the benchmark as written): {n} peers x "
          f"{flagship.N_TOPICS} topics, 10% churn in three waves, 2% link "
          f"loss, a half/half partition over ticks "
          f"[{churn.WARMUP + 20}, {churn.heal_tick()}): {hb_c:.2f} "
          f"heartbeats/s ({dt_c * 1e3 / churn.TIMED:.3f} ms/tick), "
          f"delivery fraction {rows_c['delivery_fraction']!r} over "
          f"{rows_c['settled_messages']} settled messages (gate > "
          f"{churn.MIN_DELIVERY_FRACTION}), probe recovery ticks "
          f"{rows_c['probe_recovery_ticks']}, median "
          f"{rows_c['recovery_ticks_median']}; up to {down_c} peers down, "
          f"{cut_c} cut edges on tick {t_real}; one tick's fault masks "
          f"(the link draw) {link_ms:.4f} ms; peak memory {peak_c} B "
          f"({alloc0_c} B at the start), launches {launches_c}; 20 more "
          f"heartbeats profiled: {prof_c['wall_ms_per_tick']:.3f} ms/tick "
          f"wall, {prof_c['device_busy_ms_per_tick']:.3f} busy, idle share "
          f"{prof_c['device_idle_share']:.3f} [{name}, {smi}]")
    main_churn = dict(
        rows_c, heartbeats_per_s=hb_c, ms_per_tick=dt_c * 1e3 / churn.TIMED,
        peak_bytes=peak_c, start_bytes=alloc0_c, launches=launches_c,
        max_down_peers=down_c, cut_edges=cut_c, link_draw_ms=link_ms,
        device_idle_share=prof_c["device_idle_share"],
        device_busy_ms_per_tick=prof_c["device_busy_ms_per_tick"],
        profile_kernels=prof_c["kernels"][:8])
    del params, state, step, box, counts_c

    # -- 5j. B2 under faults and cold restart against its plain version at
    # the resident shapes, one window from tick 24 (rejoins at 25 and 30,
    # the partition from 20); then 64 heartbeats of the resident
    # configuration under the churn benchmark's kind of schedule with cold
    # restart on fused windows and one by one (the faulted unscored
    # receive, its tick 30 also checked against its plain version)
    n_r = resident.N_PEERS
    sched_r = churn.schedule(n_r, np.random.default_rng(5), 0, RES_WARMUP,
                             cold_restart=True)
    cfg_c, params, state, *_ = resident.build(dev, horizon=RES_WARMUP,
                                              fault_schedule=sched_r)
    k_c = kfused.fused_consts(cfg_c)
    step_c = pg.make_gossip_step(cfg_c, None, device=dev)
    k_fu = krecv.receive_consts(cfg_c, None, faults=True)
    rand_u = fault_operands(k_fu, random_receive_operands(
        k_fu, n_r, 1, dev, seed=89), dev, 97)
    t_u = 30
    krecv.launches.clear()
    box = [state]
    tick_ops = capture_receive(lambda: box.append(pg.gossip_run(
        params, state, t_u + 1, step_c, device=dev)), krecv)
    fm = faults.tick_masks(params.faults, cfg_c.offsets, cfg_c.cinv, t_u)
    down = int((tick_ops["alive_w"] == 0).sum())
    cut = int(graph.popcount32(fm.alive_all & ~fm.send_ok).sum())
    faulted["receive_update_unscored_faults"] = faulted_check(
        "faulted unscored receive", k_fu, rand_u, tick_ops, down, cut,
        krecv.launches["unscored_faults"], tick=t_u)
    del tick_ops, rand_u, box
    st = pg.gossip_run(params, state, 24, step_c, device=dev)
    tk = torch.arange(st.tick, st.tick + Tw, dtype=torch.int32, device=dev)
    all_c = (1 << cfg_c.n_candidates) - 1
    rows_r = pg.window_fault_rows(cfg_c, params.faults, st.tick, Tw)
    fops = dict(
        tick0=st.tick, seeds=kfused.window_seeds(st.tick, Tw, st.salt),
        due=graph.pack_bits(params.publish_tick[None, :] == tk[:, None]),
        sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
        cand_sub=params.cand_sub_bits, origin=params.origin_words,
        have=st.have, recent=st.recent, mesh=st.mesh, fanout=st.fanout,
        last_pub=st.last_pub, backoff=st.backoff, tgt=st.gates[0],
        bog=st.gates[1], **rows_r)
    if not (bool(rows_r["rejoin"].any())
            and bool((rows_r["alive"] == 0).any())):
        fail("faulted fused window: no rejoin or no down peer in the window")
    sel_rows_c = [0]
    real_sel = kfused.select_plain

    def count_sel_c(elig, kk, c, seed):
        sel_rows_c[0] += drawn_rows(elig, kk)
        return real_sel(elig, kk, c, seed)

    kfused.select_plain = count_sel_c
    try:
        want = kfused.fused_gossip_update_plain(k_c, **fops)
    finally:
        kfused.select_plain = real_sel
    got = kfused.fused_gossip_update(k_c, **fops)
    torch.cuda.synchronize()
    err_fc = check_identical("faulted fused window (cold restart)", got, want)
    fc_ms = eager_ms(lambda: kfused.fused_gossip_update(k_c, **fops), 20)
    fc_plain_ms = eager_ms(
        lambda: kfused.fused_gossip_update_plain(k_c, **fops), 2)
    rows_ms = eager_ms(lambda: pg.window_fault_rows(
        cfg_c, params.faults, st.tick, Tw), 20)
    # exact-k targets add one selection per peer-tick; Bernoulli targets
    # (this window's) are in the per-row count already
    fc_rows = sel_rows_c[0] + k_c.receive.exact_k * n_r * Tw
    fc_bound = bound(kfused.window_operand_bytes(fops),
                     fused_window_ops(k_c, fops, fc_rows))
    print(f"faulted fused window (cold restart): identical at N={n_r}, "
          f"C={C}, W=1, T={Tw} from tick {st.tick} "
          f"({int((rows_r['alive'] == 0).sum())} down peer-ticks, "
          f"{int((rows_r['rejoin'] != 0).sum())} rejoins); kernel "
          f"{fc_ms:.4f} ms, plain {fc_plain_ms:.3f} ms per window, the "
          f"window's fault rows (T link draws, on the device) "
          f"{rows_ms:.4f} ms; operands "
          f"{kfused.window_operand_bytes(fops) / n_r:.1f} B/peer, bound "
          f"{fc_bound[0]:.4f} ms ({fc_bound[1]})")
    del want, got, fops, st, rows_r
    win_c = pg.make_fused_window(cfg_c, None, ticks_fused=Tw, device=dev)
    krecv.launches.clear()
    ksel.launches = kfused.launches = kfused.launches_faults = 0
    end_fused = pg.gossip_run_fused(params, state, RES_WARMUP, win_c,
                                    device=dev)
    torch.cuda.synchronize()
    counts_fc = {"fused_faults": kfused.launches_faults,
                 "fused": kfused.launches, "select": ksel.launches,
                 "receive": krecv.launches.total()}
    if counts_fc != {"fused_faults": RES_WARMUP // Tw, "fused": 0,
                     "select": 0, "receive": 0}:
        fail(f"faulted fused launches {counts_fc}")
    d_fc = digest(end_fused)
    end_tick = pg.gossip_run(params, state, RES_WARMUP, step_c, device=dev)
    d_tc = digest(end_tick)
    rejoins = sum(int(faults.rejoined_mask(params.faults, t).sum())
                  for t in range(RES_WARMUP))
    if d_fc != d_tc or rejoins <= 0:
        fail(f"faulted fused digest: per-tick {d_tc} != fused {d_fc} "
             f"({rejoins} rejoins)")
    deg_fc = pg.mesh_degrees(end_fused)[params.subscribed].to(
        torch.float64).mean().item()
    print(f"faulted resident (cold restart): {RES_WARMUP} heartbeats on "
          f"{counts_fc['fused_faults']} fused windows and one by one: digest "
          f"{d_fc} both, {rejoins} rejoins, mean mesh degree {deg_fc:.3f}")
    del params, state, end_fused, end_tick

    # -- 5k. B1 with telemetry against its plain version, each family with
    # and without faults, on seeded random operands and on a real tick of
    # the family's sim stepped by the telemetry step
    L_TEL = 16
    tcfg_k = tl.TelemetryConfig(latency_hist=True, latency_buckets=L_TEL)
    tel_k = {}

    def tel_operands(ops, seed):
        """``ops`` with random latency-bucket masks and deliver words."""
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        w_, n_ = ops["fresh"].shape

        def words(shape):
            hi = torch.randint(0, 1 << 16, shape, generator=g, device=dev)
            lo = torch.randint(0, 1 << 16, shape, generator=g, device=dev)
            v = (hi << 16) | lo
            return torch.where(v >= 1 << 31, v - (1 << 32), v).to(
                torch.int32)
        return dict(ops, lat_masks=words((L_TEL, w_)),
                    dlv_eff=words((w_, n_)))

    def schedule_on(sim, seed, start, horizon):
        """``sim`` (cfg, sc, params, state) with the churn benchmark's kind
        of schedule from ``start`` attached."""
        cfg_, sc_, params_, state_ = sim[:4]
        n_ = params_.subscribed.shape[0]
        sched = churn.schedule(n_, np.random.default_rng(seed), start,
                               horizon)
        return cfg_, sc_, dataclasses.replace(
            params_, faults=faults.compile_faults(sched, cfg_.offsets,
                                                  device=dev)), state_

    def busy_tick(params_, target):
        """Two ticks after the first publish at or after ``target``
        (messages in flight: the tally's rows live), else ``target``."""
        pt = params_.publish_tick.cpu().numpy()
        later = pt[pt >= target]
        return int(later.min()) + 2 if len(later) else target

    def tel_check(label, sim, target, rand_ops, k_rand_kw=None,
                  tcfg=tcfg_k):
        """The telemetry variant of ``sim``'s receive against its plain
        version on ``rand_ops`` and on a real tick of the sim stepped by
        the telemetry step of ``tcfg`` (``busy_tick`` from ``target``; its
        launches counted over that run); the variant, its plain version
        and its twin without telemetry timed on the tick."""
        cfg_, sc_, params_, state_ = sim
        tick = busy_tick(params_, target)
        lat = tcfg.latency_buckets if tcfg.latency_hist else 0
        k_ = krecv.receive_consts(
            cfg_, sc_, px=state_.active is not None,
            same_ip=params_.cand_same_ip is not None,
            faults=params_.faults is not None, telemetry=True,
            tel_lat_buckets=lat)
        k_r = dataclasses.replace(k_, **(k_rand_kw or {}))
        got = krecv.receive_update(k_r, **rand_ops)
        torch.cuda.synchronize()
        err = check_identical(f"{label} (random operands)", got,
                              krecv.receive_update_plain(k_r, **rand_ops))
        step_ = pg.make_gossip_step(cfg_, sc_, device=dev, telemetry=tcfg)
        torch.cuda.synchronize()
        krecv.launches.clear()
        ops_ = capture_receive(lambda: pg.gossip_run(
            params_, state_, tick + 1, step_, device=dev), krecv)
        torch.cuda.synchronize()
        launched = dict(krecv.launches)
        if launched != {krecv.variant(k_): tick + 1}:
            fail(f"{label}: launches {launched}")
        want = krecv.receive_update_plain(k_, **ops_)
        got = krecv.receive_update(k_, **ops_)
        torch.cuda.synchronize()
        err = max(err, check_identical(f"{label} (tick {tick})", got, want))
        tally = got[-1]
        dlv = (int(graph.popcount32(got[0] & ops_["dlv_eff"]).sum())
               if lat else 0)
        if not (tally.shape == (len(krecv.TEL_ROWS) + lat,)
                and int(tally[krecv.TEL_PAYLOAD]) > 0
                and int(tally[krecv.TEL_IHAVE_IDS]) > 0
                and int(tally[len(krecv.TEL_ROWS):].sum()) == dlv):
            fail(f"{label}: tally {tally.tolist()}, {dlv} delivered")
        ms = device_ms(lambda: krecv.receive_update(k_, **ops_), 50)
        plain = device_ms(lambda: krecv.receive_update_plain(k_, **ops_), 5)
        k_twin = dataclasses.replace(k_, telemetry=False, tel_lat_buckets=0)
        ops_twin = {key: v for key, v in ops_.items()
                    if key not in ("lat_masks", "dlv_eff")}
        twin = device_ms(lambda: krecv.receive_update(k_twin, **ops_twin), 50)
        n_ = ops_["sub_all"].shape[0]
        nbytes = krecv.operand_bytes(ops_, got)
        bnd = bound(nbytes, receive_ops(k_, ops_))
        print(f"{label}: identical at N={n_}, C={C}, W=1, L={lat} (random "
              f"operands; tick {tick}, tally {tally.tolist()}); device time: "
              f"kernel {ms:.4f} ms (without telemetry {twin:.4f}), plain "
              f"{plain:.3f} ms; {nbytes / n_:.1f} B/peer, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}); {tick + 1} launches to tick "
              f"{tick}")
        return dict(err=err, ms=ms, plain_ms=plain, twin_ms=twin,
                    bytes_per_peer=nbytes / n_, bound=bnd,
                    launches=tick + 1, tally=tally.tolist())

    horizon = WARMUP + TIMED
    t_clean, t_fault = 40, churn.heal_tick() - 20
    families = (
        ("", lambda: flagship.build(dev, horizon=horizon)[:4], n, None),
        ("_attacks", lambda: adversarial.build(dev, horizon=horizon)[:4], n,
         None),
        ("_full", lambda: everything.build(dev, horizon=horizon)[:4], n,
         dict(exact_k=True)),
        ("_paired", lambda: everything.build(dev, horizon=horizon,
                                             paired=True)[:4], n,
         dict(flood_publish=True, exact_k=True)))
    for suffix, make, n_f, k_rand_kw in families:
        sim = make()
        for fault_on in (False, True):
            sim_f = (schedule_on(sim, 1, churn.WARMUP, churn.WARMUP
                                 + churn.TIMED) if fault_on else sim)
            k0 = krecv.receive_consts(sim_f[0], sim_f[1], faults=fault_on,
                                      px=sim_f[3].active is not None,
                                      same_ip=sim_f[2].cand_same_ip
                                      is not None)
            k0r = dataclasses.replace(k0, **(k_rand_kw or {}))
            seed = 101 + len(tel_k)
            if k0.paired:
                rand = paired_receive_operands(
                    k0r, full_receive_operands(k0r, n_f, dev, seed), n_f,
                    dev, seed + 1)
            elif k0.full:
                rand = full_receive_operands(k0r, n_f, dev, seed)
            else:
                rand = random_receive_operands(k0r, n_f, 1, dev, seed)
                if k0.attacks:
                    g = torch.Generator(device=dev)
                    g.manual_seed(seed + 2)
                    rand["syb"] = torch.where(
                        torch.rand(n_f, generator=g, device=dev) < 0.2,
                        (1 << C) - 1, 0).to(torch.int32)
                    rand["iws"] = torch.randint(0, 4 * 32, (C, n_f),
                                                generator=g,
                                                device=dev).to(torch.int16)
            if fault_on:
                rand = fault_operands(k0r, rand, dev, seed + 3)
            name_k = ("receive_update" + suffix
                      + ("_faults" if fault_on else "") + "_tel")
            tel_k[name_k] = tel_check(
                name_k.replace("_", " "), sim_f, t_fault if fault_on
                else t_clean, tel_operands(rand, seed + 4), k_rand_kw)
            del rand, sim_f
        del sim
    # unscored and unscored paired at the resident shapes
    n_r = resident.N_PEERS
    for suffix, paired_ in (("_unscored", False), ("_paired_unscored", True)):
        cfg_u, params, state, *_ = resident.build(dev, horizon=RES_WARMUP,
                                                  paired=paired_)
        sim = (cfg_u, None, params, state)
        for fault_on in (False, True):
            sim_f = schedule_on(sim, 5, 0, RES_WARMUP) if fault_on else sim
            k0 = krecv.receive_consts(cfg_u, None, faults=fault_on)
            seed = 131 + len(tel_k)
            rand = random_receive_operands(k0, n_r, 1, dev, seed)
            if paired_:
                rand = paired_receive_operands(k0, rand, n_r, dev, seed + 1)
            if fault_on:
                rand = fault_operands(k0, rand, dev, seed + 3)
            name_k = ("receive_update" + suffix
                      + ("_faults" if fault_on else "") + "_tel")
            tel_k[name_k] = tel_check(
                name_k.replace("_", " "), sim_f, 30 if fault_on else 12,
                tel_operands(rand, seed + 4))
            del rand, sim_f
        del sim, params, state

    # -- 5l. the slice's main path: the telemetry-kernel benchmark as
    # written, counts reset just before each run and read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_t = torch.cuda.memory_allocated()
    tel_main = telemetry_flagship.run(dev)
    peak_t = torch.cuda.max_memory_allocated()
    if not tel_main["ok"]:
        fail(f"telemetry benchmark: checks {tel_main['checks']}: {tel_main}")
    hb_off = tel_main["off"]["heartbeats_per_s"]
    hb_on = tel_main["on"]["heartbeats_per_s"]
    print(f"telemetry path (the benchmark as written): "
          f"{tel_main['n_peers']} peers x {flagship.N_TOPICS} topics, "
          f"telemetry off {hb_off:.2f} heartbeats/s, on {hb_on:.2f} "
          f"(overhead {tel_main['telemetry_overhead_pct']:.2f}%); control "
          f"overhead ratio {tel_main['control_overhead_ratio']!r}, totals "
          f"{tel_main['totals']}; gates off {tel_main['off']['gates']}, on "
          f"{tel_main['on']['gates']}; digests {tel_main['off']['digest']} "
          f"/ {tel_main['on']['digest']}; launches off "
          f"{tel_main['off']['launches']}, on {tel_main['on']['launches']}; "
          f"peak memory {peak_t} B ({alloc0_t} B at the start) "
          f"[{name}, {smi}]")
    # the main path's variant (TelemetryConfig(): no latency rows) against
    # its plain version at the main path's shapes, on random operands and
    # on a busy tick of the benchmark's sim stepped by its telemetry step
    sim_t = telemetry_flagship.build(dev)[:4]
    k_t = krecv.receive_consts(sim_t[0], sim_t[1])
    tel_main_k = tel_check(
        "receive update tel (main path)", sim_t, 40,
        random_receive_operands(k_t, telemetry_flagship.N_PEERS, 1, dev, 97),
        tcfg=tl.TelemetryConfig())
    del sim_t

    # -- 5m. B2 with telemetry against its plain version, one window of
    # the resident configuration clean (mesh formation) and under faults
    # with cold restart; then 64 heartbeats of each on fused windows with
    # frames against the per-tick telemetry step
    tcfg_m = tl.TelemetryConfig(latency_hist=True, latency_buckets=L_TEL,
                                degree_hist=True)
    sched_m = churn.schedule(n_r, np.random.default_rng(5), 0, RES_WARMUP,
                             cold_restart=True)
    fused_tel = {}
    for label, sched, t0_w in (("fused_gossip_update_tel", None, 1),
                               ("fused_gossip_update_faults_tel", sched_m,
                                24)):
        cfg_m, params, state, *_ = resident.build(
            dev, horizon=RES_WARMUP, fault_schedule=sched)
        k_m = kfused.fused_consts(cfg_m, telemetry=True,
                                  tel_lat_buckets=L_TEL)
        step_m = pg.make_gossip_step(cfg_m, None, device=dev)
        st = pg.gossip_run(params, state, t0_w, step_m, device=dev)
        tk = torch.arange(st.tick, st.tick + Tw, dtype=torch.int32,
                          device=dev)
        all_c = (1 << cfg_m.n_candidates) - 1
        fops = dict(
            tick0=st.tick, seeds=kfused.window_seeds(st.tick, Tw, st.salt),
            due=graph.pack_bits(params.publish_tick[None, :] == tk[:, None]),
            sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
            cand_sub=params.cand_sub_bits, origin=params.origin_words,
            have=st.have, recent=st.recent, mesh=st.mesh, fanout=st.fanout,
            last_pub=st.last_pub, backoff=st.backoff, tgt=st.gates[0],
            bog=st.gates[1],
            lat_masks=tl.latency_bucket_masks(
                params.publish_tick, tk[:, None], L_TEL, st.have.shape[0]),
            dlv=params.deliver_words,
            **pg.window_fault_rows(cfg_m, params.faults, st.tick, Tw))
        sel_rows_m = [0]
        real_sel = kfused.select_plain

        def count_sel_m(elig, kk, c, seed):
            sel_rows_m[0] += drawn_rows(elig, kk)
            return real_sel(elig, kk, c, seed)

        kfused.select_plain = count_sel_m
        try:
            want = kfused.fused_gossip_update_plain(k_m, **fops)
        finally:
            kfused.select_plain = real_sel
        got = kfused.fused_gossip_update(k_m, **fops)
        torch.cuda.synchronize()
        err_m = check_identical(label.replace("_", " "), got, want)
        tally = got[-1]
        if not (int(tally[:, krecv.TEL_PAYLOAD].sum()) > 0
                and int(tally[:, -2:].sum()) > 0):
            fail(f"{label}: tally {tally.tolist()}")
        r0 = len(krecv.TEL_ROWS)
        copies_m = int(tally[:, r0:r0 + L_TEL].sum())
        ms_m = eager_ms(lambda: kfused.fused_gossip_update(k_m, **fops), 20)
        plain_m = eager_ms(
            lambda: kfused.fused_gossip_update_plain(k_m, **fops), 2)
        k_tw = dataclasses.replace(k_m, telemetry=False, tel_lat_buckets=0)
        fops_tw = {key: v for key, v in fops.items()
                   if key not in ("lat_masks", "dlv")}
        twin_m = eager_ms(lambda: kfused.fused_gossip_update(k_tw, **fops_tw),
                          20)
        # the tally without its latency rows, apart
        k_l0 = dataclasses.replace(k_m, tel_lat_buckets=0)
        l0_m = eager_ms(lambda: kfused.fused_gossip_update(k_l0, **fops_tw),
                        20)
        nb_m = (kfused.window_operand_bytes(fops)
                + sum(t_.numel() * t_.element_size() for t_ in got[9:]))
        bnd_m = bound(nb_m, fused_window_ops(k_m, fops, sel_rows_m[0])
                      + Tw * n_r * (16 + C * (10 + 4)))
        del want, got, fops, fops_tw, st
        # 64 heartbeats on fused windows against the per-tick telemetry
        # step, frames field by field
        win_m = pg.make_fused_window(cfg_m, None, ticks_fused=Tw, device=dev,
                                     telemetry=tcfg_m)
        step_t = pg.make_gossip_step(cfg_m, None, device=dev,
                                     telemetry=tcfg_m)
        torch.cuda.synchronize()
        krecv.launches.clear()
        ksel.launches = kfused.launches = kfused.launches_faults = 0
        kfused.launches_tel = 0
        end_f, fr_f = pg.gossip_run_frames_fused(params, state, RES_WARMUP,
                                                 win_m, device=dev)
        torch.cuda.synchronize()
        counts_m = {"fused_tel": kfused.launches_tel,
                    "fused": kfused.launches + kfused.launches_faults,
                    "select": ksel.launches,
                    "receive": krecv.launches.total()}
        if counts_m != {"fused_tel": RES_WARMUP // Tw, "fused": 0,
                        "select": 0, "receive": 0}:
            fail(f"{label}: launches {counts_m}")
        end_t, fr_t = tl.telemetry_run(params, state, RES_WARMUP, step_t)
        a_np, b_np = convert.frame_to_numpy(fr_f), convert.frame_to_numpy(
            fr_t)
        for key, v in b_np.items():
            if (v is None) != (a_np[key] is None) or (
                    v is not None and not np.array_equal(
                        a_np[key].view(np.uint8), v.view(np.uint8))):
                fail(f"{label}: frames differ in {key}")
        d_f, d_t = digest(end_f), digest(end_t)
        tot_m = tl.summarize_frames(fr_f)
        if d_f != d_t or not tot_m["payload_sent"] > 0:
            fail(f"{label}: digests {d_f} / {d_t}, totals {tot_m}")
        print(f"{label}: identical at N={n_r}, C={C}, W=1, T={Tw}, "
              f"L={L_TEL} from tick {t0_w}; kernel {ms_m:.4f} ms (without "
              f"latency rows {l0_m:.4f}, without telemetry {twin_m:.4f}), "
              f"plain {plain_m:.3f} ms per window ({copies_m} delivered "
              f"copies in its latency rows); "
              f"{nb_m / n_r:.1f} B/peer, bound {bnd_m[0]:.4f} ms "
              f"({bnd_m[1]}); {RES_WARMUP} heartbeats on {counts_m} "
              f"launches and per tick: frames equal, digest {d_f}, "
              f"payload {tot_m['payload_sent']}, control overhead ratio "
              f"{tot_m['control_overhead_ratio']!r}")
        fused_tel[label] = dict(
            err=err_m, ms=ms_m, plain_ms=plain_m, twin_ms=twin_m,
            no_latency_rows_ms=l0_m, latency_row_copies=copies_m,
            bytes_per_peer=nb_m / n_r, bound=bnd_m,
            launches=counts_m["fused_tel"], digest=d_f,
            control_overhead_ratio=tot_m["control_overhead_ratio"])
        del params, state, end_f, end_t, fr_f, fr_t, win_m, step_t, step_m

    # -- 5n. B1 with knobs against its plain version, each family with and
    # without faults (the flagship's options and the full variant also with
    # telemetry), on seeded random operands with a non-default knob vector
    # and on a real tick of a knob point's sim stepped by its step
    knob_k = {}
    # the seven kernel knobs off their defaults (a SimKnobs point); the
    # IWANT-flood sims (full, paired) arm a defense through score_knobs
    knob_point = {"gossip_factor": 0.4, "d_lazy": 4, "backoff_ticks": 6,
                  "invalid_message_deliveries_weight": -20.0,
                  "behaviour_penalty_weight": -40.0,
                  "graylist_threshold": -60.0, "gossip_threshold": -5.0}
    knob_proto = {key: v for key, v in knob_point.items()
                  if key in ("gossip_factor", "d_lazy", "backoff_ticks")}
    defense = knob_sweep.DEFENSE_POINTS["hardened"]

    def knob_vector(k_):
        """A non-default knob vector in the KNOB_* order."""
        v = [0.4, 4.0, 13.0] + ([-13.0, -40.0, -60.0, -5.0] if k_.scored
                                else [])
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def knob_check(label, sim, target, rand_fn, surface, tcfg=None,
                   k_rand_kw=None):
        """The knob variant of ``sim``'s receive, armed through ``surface``
        (make_gossip_sim's knob keywords), against its plain version on
        ``rand_fn``'s random operands with a non-default vector and on a
        real tick of the armed sim stepped by its step (``target``; with
        ``tcfg`` the telemetry step's, two ticks after a publish), its
        launches counted over that run; the variant, its plain version and
        its twin without knobs timed on the tick."""
        cfg_, sc_, params_, state_ = sim
        params_ = pg.knob_params(cfg_, sc_, params_, **surface)
        state_ = pg.refresh_gates(cfg_, sc_, params_, state_)
        lat = tcfg.latency_buckets if tcfg is not None else 0
        tick = busy_tick(params_, target) if tcfg is not None else target
        k_ = krecv.receive_consts(
            cfg_, sc_, px=state_.active is not None,
            same_ip=params_.cand_same_ip is not None,
            faults=params_.faults is not None, telemetry=tcfg is not None,
            tel_lat_buckets=lat, knobs=True)
        k_r = dataclasses.replace(k_, **(k_rand_kw or {}))
        rops = dict(rand_fn(k_r), knobs=knob_vector(k_r))
        got = krecv.receive_update(k_r, **rops)
        torch.cuda.synchronize()
        err = check_identical(f"{label} (random operands)", got,
                              krecv.receive_update_plain(k_r, **rops))
        del rops
        step_ = pg.make_gossip_step(cfg_, sc_, device=dev, telemetry=tcfg)
        torch.cuda.synchronize()
        krecv.launches.clear()
        ops_ = capture_receive(lambda: pg.gossip_run(
            params_, state_, tick + 1, step_, device=dev), krecv)
        torch.cuda.synchronize()
        launched = dict(krecv.launches)
        if launched != {krecv.variant(k_): tick + 1}:
            fail(f"{label}: launches {launched}")
        want = krecv.receive_update_plain(k_, **ops_)
        got = krecv.receive_update(k_, **ops_)
        torch.cuda.synchronize()
        err = max(err, check_identical(f"{label} (tick {tick})", got, want))
        ms = device_ms(lambda: krecv.receive_update(k_, **ops_), 50)
        plain = device_ms(lambda: krecv.receive_update_plain(k_, **ops_), 5)
        k_twin = dataclasses.replace(k_, knobs=False)
        ops_twin = {key: v for key, v in ops_.items() if key != "knobs"}
        twin = device_ms(lambda: krecv.receive_update(k_twin, **ops_twin), 50)
        n_ = ops_["sub_all"].shape[0]
        nbytes = krecv.operand_bytes(ops_, got)
        bnd = bound(nbytes, receive_ops(k_, ops_))
        print(f"{label}: identical at N={n_}, C={C}, W=1 (random operands, "
              f"tick {tick} of the armed sim); device time: kernel {ms:.4f} "
              f"ms (without knobs {twin:.4f}), plain {plain:.3f} ms; "
              f"{nbytes / n_:.1f} B/peer, bound {bnd[0]:.4f} ms ({bnd[1]}); "
              f"{tick + 1} launches of {krecv.variant(k_)} to tick {tick}")
        return dict(err=err, ms=ms, plain_ms=plain, twin_ms=twin,
                    bytes_per_peer=nbytes / n_, bound=bnd,
                    launches=tick + 1, variant=krecv.variant(k_))

    def attack_rand(k_, n_, seed):
        """Random operands with a fifth of the peers carrying the sybil
        word and ledgers around the flood budget."""
        rand = random_receive_operands(k_, n_, 1, dev, seed)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 2)
        rand["syb"] = torch.where(torch.rand(n_, generator=g, device=dev)
                                  < 0.2, (1 << C) - 1, 0).to(torch.int32)
        rand["iws"] = torch.randint(0, 4 * 32, (C, n_), generator=g,
                                    device=dev).to(torch.int16)
        return rand

    horizon = WARMUP + TIMED
    t_clean, t_fault = 40, churn.heal_tick() - 20
    # (suffix, sim, peers, random operands, knob surface, random-operand
    # options, with telemetry too); the attack options on the IHAVE spam
    # (a SimKnobs point cannot ride the IWANT flood; the random operands
    # turn the flood on); full and paired through score_knobs
    families = (
        ("", lambda: flagship.build(dev, horizon=horizon)[:4], n,
         lambda k_, s: random_receive_operands(k_, n, 1, dev, s),
         dict(sim_knobs=knob_point), None, True),
        ("_attacks", lambda: adversarial.build(
            dev, horizon=horizon, iwant_spam=False)[:4], n,
         lambda k_, s: attack_rand(k_, n, s), dict(sim_knobs=knob_point),
         dict(iwant_spam=True), False),
        ("_full", lambda: everything.build(dev, horizon=horizon)[:4], n,
         lambda k_, s: full_receive_operands(k_, n, dev, s),
         dict(score_knobs=defense), dict(exact_k=True), True),
        ("_paired", lambda: everything.build(dev, horizon=horizon,
                                             paired=True)[:4], n,
         lambda k_, s: paired_receive_operands(
             k_, full_receive_operands(k_, n, dev, s), n, dev, s + 1),
         dict(score_knobs=defense), dict(flood_publish=True, exact_k=True),
         False))
    for suffix, make, n_f, rand_fn, surface, k_rand_kw, with_tel in families:
        sim = make()
        for fault_on in (False, True):
            sim_f = (schedule_on(sim, 1, churn.WARMUP, churn.WARMUP
                                 + churn.TIMED) if fault_on else sim)
            for tcfg in ((None, tcfg_k) if with_tel else (None,)):
                seed = 211 + 7 * len(knob_k)

                def rand(k_, seed=seed, fault_on=fault_on, tcfg=tcfg):
                    r_ = rand_fn(k_, seed)
                    if fault_on:
                        r_ = fault_operands(k_, r_, dev, seed + 3)
                    return tel_operands(r_, seed + 4) if tcfg else r_
                name_k = ("receive_update" + suffix
                          + ("_faults" if fault_on else "")
                          + ("_tel" if tcfg else "") + "_knobs")
                knob_k[name_k] = knob_check(
                    name_k.replace("_", " "), sim_f,
                    t_fault if fault_on else t_clean, rand, surface, tcfg,
                    k_rand_kw)
            del sim_f
        del sim
    # unscored and unscored paired at the resident shapes
    n_r = resident.N_PEERS
    for suffix, paired_ in (("_unscored", False), ("_paired_unscored", True)):
        cfg_u, params, state, *_ = resident.build(dev, horizon=RES_WARMUP,
                                                  paired=paired_)
        sim = (cfg_u, None, params, state)
        for fault_on in (False, True):
            sim_f = schedule_on(sim, 5, 0, RES_WARMUP) if fault_on else sim
            seed = 311 + 7 * len(knob_k)

            def rand(k_, seed=seed, fault_on=fault_on, paired_=paired_):
                r_ = random_receive_operands(k_, n_r, 1, dev, seed)
                if paired_:
                    r_ = paired_receive_operands(k_, r_, n_r, dev, seed + 1)
                return (fault_operands(k_, r_, dev, seed + 3) if fault_on
                        else r_)
            name_k = ("receive_update" + suffix
                      + ("_faults" if fault_on else "") + "_knobs")
            knob_k[name_k] = knob_check(
                name_k.replace("_", " "), sim_f, 30 if fault_on else 12,
                rand, dict(sim_knobs=knob_proto))
            del sim_f
        del sim, params, state

    # -- 5o. the slice's main path: the knob sweep (knob_sweep.py) at
    # 1,000,000 peers, each point armed on one built sim and stepped by one
    # step, counts reset just before each point's run and read just after
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep = knob_sweep.run(dev)
    t_sweep = time.perf_counter() - t0
    for kind in knob_sweep.SWEEPS:
        s_ = sweep[kind]
        base = s_["rows"]["baked"]["heartbeats_per_s"]
        for pname, row in s_["rows"].items():
            gate = {key: row[key] for key in (
                "mean_mesh_degree", "d_lo", "honest_mean_degree",
                "delivery_ok", "delivery_fraction", "probe_recovery_ticks")
                if key in row}
            print(f"knob sweep {kind} {pname}: {row['heartbeats_per_s']:.2f} "
                  f"heartbeats/s (baked {base:.2f}), digest {row['digest']}, "
                  f"{row['variant']} launches {row['launches']}, gates "
                  f"{'pass' if row['gates_ok'] else 'FAIL'} {gate}")
        print(f"knob sweep {kind}: identity "
              f"{s_.get('identity_ok')} ({knob_sweep.IDENTITY[kind]} == "
              f"baked); digests differing from baked: "
              f"{s_['differ_from_baked']} [{name}, {smi}]")
        if not s_["ok"]:
            fail(f"knob sweep {kind}: {json.dumps(s_)}")
    print(f"knob sweep: {t_sweep:.1f} s")
    main_knobs = {kind: sweep[kind] for kind in knob_sweep.SWEEPS}
    # the main path's launches of its three knob variants
    main_knob_launches = {}
    for kind in knob_sweep.SWEEPS:
        for row in sweep[kind]["rows"].values():
            v_ = row["variant"]
            main_knob_launches[v_] = (main_knob_launches.get(v_, 0)
                                      + row["launches"].get(v_, 0))
    del sweep

    # -- 5p. B1's delay mode against its plain version, each family with
    # and without knobs, on random operands and on a real delayed tick
    t0 = time.perf_counter()
    delay_k = delay_variants(dev, n, resident.N_PEERS)
    print(f"5p: {time.perf_counter() - t0:.1f} s")

    # -- 5q. the slice's main path: the pipelined-gossip benchmark at
    # 100,000 and 1,000,000 peers, each point's counts reset just before its
    # run and read just after; then the K = 1 identity and the steady state
    main_pipe = {}
    for n_p in (pipelined.N_PEERS, pipelined.FULL_WIDTH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = pipelined.run_sequential(dev, n_p)
        for pid, row in r["rows"].items():
            print(f"pipelined {n_p} {pid}: delivery fraction "
                  f"{row['delivery_fraction']!r}, latency {row['latency']}, "
                  f"{row['heartbeats_per_s']:.2f} heartbeats/s, peak memory "
                  f"{row['peak_bytes']} B, launches {row['launches']} "
                  f"(select {row['select_launches']}), digest "
                  f"{row['digest']}, histogram {row['hist']}")
        print(f"pipelined {n_p}: gates {r['gates']}, p99 {r['p99']}, "
              f"p99_stretch_base4 {r['p99_stretch_base4']!r}, replica "
              f"heartbeats/s {r['replica_heartbeats_per_s']!r}, launches ok "
              f"{r['launches_ok']}, a library built after the first point "
              f"{r['rebuilt_after_first']} ({time.perf_counter() - t0:.1f} s)"
              f" [{name}, {smi}]")
        if not r["ok"]:
            fail(f"pipelined benchmark at {n_p} peers: "
                 f"{json.dumps({k_: v for k_, v in r.items() if k_ != 'rows'})}")
        main_pipe[n_p] = r
    ident = pipelined.identity(dev)
    print(f"pipelined identity at {pipelined.FULL_WIDTH} peers: K = 1 "
          f"digest {ident['k1']}, without delays {ident['plain']}")
    if not ident["ok"]:
        fail(f"DelayConfig(1, 0, 1) departs from the step without delays: "
             f"{ident}")
    steady = pipelined.steady_state(dev)
    prof_d = steady["profile_delayed"]
    for label in ("plain", "delayed"):
        s_ = steady[label]
        print(f"steady state {label} at {pipelined.FULL_WIDTH} peers: "
              f"{s_['heartbeats_per_s']:.2f} heartbeats/s "
              f"({s_['ms_per_tick']:.3f} ms/tick), mean mesh degree "
              f"{s_['mean_mesh_degree']:.3f}, peak memory {s_['peak_bytes']} "
              f"B, launches {s_['launches']} [{name}, {smi}]")
        if s_["launches"] != {"scored" + ("+delays" if label == "delayed"
                                          else ""): pipelined.STEADY_WARMUP
                              + pipelined.STEADY_TIMED}:
            fail(f"steady state {label}: launches {s_['launches']}")
    print(f"steady state delayed profile: {prof_d['wall_ms_per_tick']:.3f} "
          f"ms/tick wall, {prof_d['device_busy_ms_per_tick']:.3f} busy, idle "
          f"share {prof_d['device_idle_share']!r}; ranges "
          f"{json.dumps(prof_d['ranges'])}; top device operations "
          f"{json.dumps(prof_d['kernels'][:10])}")
    main_delay_launches = sum(
        r_["rows"][pid]["launches"].get(pipelined.VARIANT, 0)
        for r_ in main_pipe.values() for pid in r_["rows"])

    # -- 5r. each per-tick family's armed step for one real tick on the
    # card against the CPU and against the step without the checker; the
    # reference's seeded mesh defect
    t0 = time.perf_counter()
    armed = armed_families(dev, INV_CHECK_PEERS)
    print(f"5r: {time.perf_counter() - t0:.1f} s")

    # -- 5s. the slice's main path: the invariants-kernel benchmark as
    # written, counts reset just before each run and read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_i = torch.cuda.memory_allocated()
    inv_main = invariants_flagship.run(dev)
    peak_i = torch.cuda.max_memory_allocated()
    hb_ioff = inv_main["off"]["heartbeats_per_s"]
    hb_ion = inv_main["on"]["heartbeats_per_s"]
    print(f"invariants path (the benchmark as written): "
          f"{inv_main['n_peers']} peers x {flagship.N_TOPICS} topics, "
          f"checker off {hb_ioff:.2f} heartbeats/s "
          f"({inv_main['off']['ms_per_tick']:.3f} ms/tick), on {hb_ion:.2f} "
          f"({inv_main['on']['ms_per_tick']:.3f} ms/tick), overhead "
          f"{inv_main['invariant_overhead_pct']!r}%; report "
          f"{inv_main['report']}; gates off {inv_main['off']['gates']}, on "
          f"{inv_main['on']['gates']}; digests {inv_main['off']['digest']} / "
          f"{inv_main['on']['digest']}; launches off "
          f"{inv_main['off']['launches']}, on {inv_main['on']['launches']}; "
          f"peak memory {peak_i} B ({alloc0_i} B at the start) "
          f"[{name}, {smi}]")
    if not inv_main["ok"]:
        fail(f"invariants benchmark: checks {inv_main['checks']}: "
             f"{inv_main}")
    inv_k = invariant_path_kernels(dev)

    # -- 5t. B3 at C = 32 against its plain version: seeded operands at
    # 1,000,000 peers, and every call of a real tick of the C = 32 split
    # loops (phase 5w's sim at 50,000 peers, after 10 heartbeats)
    t0 = time.perf_counter()
    C32 = 32
    g = torch.Generator(device=dev)
    g.manual_seed(32)
    hi = torch.randint(0, 1 << 32, (n,), generator=g, device=dev)
    lo = torch.randint(0, 1 << 32, (n,), generator=g, device=dev)
    elig32 = graph.to_i32(hi | lo)                       # bit 31 live
    kk32 = torch.randint(0, C32 + 3, (n,), generator=g, device=dev).to(
        torch.int32)
    seed32 = graph.lane_seed(7, 2, 0)
    s32_err = check_identical(
        "select C=32 (seeded)",
        (ksel.select_k_bits(elig32, kk32, C32, seed32, n),),
        (ksel.select_k_bits_plain(elig32, kk32, C32, seed32, n),))
    s32_ms = device_ms(
        lambda: ksel.select_k_bits(elig32, kk32, C32, seed32, n), 200)
    s32_plain_ms = device_ms(
        lambda: ksel.select_k_bits_plain(elig32, kk32, C32, seed32, n), 3)
    s32_bound = bound(3 * 4 * n, select_ops(elig32, kk32, C32))
    del hi, lo, elig32, kk32
    cfg_w, sc_w, p_w, s_w, _ = loops_flagship.build(
        "wide", dev, n_peers=WIDE_PEERS, horizon=WIDE_TICKS)
    step_w = pg.make_gossip_step(cfg_w, sc_w, device=dev)
    s_w = pg.gossip_run(p_w, s_w, 10, step_w, device=dev)
    calls = capture_calls(lambda: step_w(p_w, s_w), ksel, "select_k_bits")
    for args, _ in calls:
        s32_err = max(s32_err, check_identical(
            "select C=32 (a real tick)", (ksel.select_k_bits(*args),),
            (ksel.select_k_bits_plain(*args),)))
    if not calls or any(a[2] != C32 for a, _ in calls):
        fail(f"C=32 tick: select calls at C {[a[2] for a, _ in calls]}")
    del p_w, s_w, step_w
    print(f"select C=32: identical at N={n} (seeded, bit 31 live) and on "
          f"the {len(calls)} calls of a real C=32 tick at N={WIDE_PEERS}; "
          f"device time: kernel {s32_ms:.4f} ms, plain {s32_plain_ms:.3f} "
          f"ms, bound {s32_bound[0]:.4f} ms ({s32_bound[1]}) "
          f"[{name}, {smi}]; {time.perf_counter() - t0:.1f} s")

    # -- 5u, 5v. the receive loops at full width, combined (the
    # tournament's byzantine cell) and split (P3/P3b), counts reset just
    # before each run and read just after (loops_flagship.run)
    loops_main = {}
    for kind in ("byzantine", "p3"):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        alloc0_l = torch.cuda.memory_allocated()
        out = loops_flagship.run(kind, dev)
        st_l, p_l, step_l = out.pop("state"), out.pop("params"), \
            out.pop("step")
        box = [st_l]

        def more():
            box[0] = pg.gossip_run(p_l, box[0], 10, step_l, device=dev)
        prof = flagship.profile_ticks(more, 10)
        out.update(start_bytes=alloc0_l, profile={
            key: prof[key] for key in (
                "wall_ms_per_tick", "device_busy_ms_per_tick",
                "device_idle_share", "launches_per_tick")},
            select_launches_per_tick=out["launches"]["select"] / (
                out["warmup"] + out["timed"]),
            seconds=time.perf_counter() - t0)
        print(f"loops {kind} (full width): {out['n_peers']} peers x "
              f"{flagship.N_TOPICS} topics, C={out['n_candidates']}, "
              f"M={out['n_msgs']}: {out['heartbeats_per_s']:.2f} "
              f"heartbeats/s ({out['ms_per_tick']:.3f} ms/tick), device "
              f"busy {prof['device_busy_ms_per_tick']:.3f} ms/tick, idle "
              f"share {prof['device_idle_share']:.4f}, "
              f"{prof['launches_per_tick']:.1f} launches/tick, launches "
              f"{out['launches']}, gates {out['gates']}, peak memory "
              f"{out['peak_bytes']} B ({alloc0_l} B at the start) "
              f"[{name}, {smi}]; {out['seconds']:.1f} s")
        if not out["ok"]:
            fail(f"loops {kind}: {out}")
        loops_main[kind] = out
        del st_l, p_l, step_l, box, out

    # -- 5w. C = 32 on the split loops at 50,000 peers: the card's state
    # digest against the CPU's after WIDE_TICKS heartbeats
    t0 = time.perf_counter()
    digests = {}
    for d in (dev, torch.device("cpu")):
        cfg_w, sc_w, p_w, s_w, _ = loops_flagship.build(
            "wide", d, n_peers=WIDE_PEERS, horizon=WIDE_TICKS)
        step_w = pg.make_gossip_step(cfg_w, sc_w, device=d)
        if d == dev:
            krecv.launches.clear()
            ksel.launches = 0
        s_w = pg.gossip_run(p_w, s_w, WIDE_TICKS, step_w, device=d)
        if d == dev:
            wide_launches = {"receive": sum(krecv.launches.values()),
                             "select": ksel.launches}
        digests[d.type] = knob_sweep.tree_digest(
            convert.state_to_numpy(s_w))
    if digests["cuda"] != digests["cpu"] or wide_launches["receive"]:
        fail(f"C=32 split loops: digests {digests}, launches "
             f"{wide_launches}")
    wide_deg = float(pg.mesh_degrees(s_w).to(torch.float64).mean())
    del p_w, s_w, step_w
    print(f"loops C=32 at {WIDE_PEERS} peers, {WIDE_TICKS} ticks: card "
          f"digest {digests['cuda']} == CPU {digests['cpu']}, mean mesh "
          f"degree {wide_deg:.3f}, launches {wide_launches}; "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 5x. the tournament as one dispatch: 20 cells at 20,000 x 20 x 24
    # x 150 stacked, one step a tick (gossip_run_tournament); its launches
    # a batched tick beside one cell's; the byzantine x reference cell on
    # the card (in the grid and alone) against the CPU's
    t0 = time.perf_counter()
    cells = []
    krecv.launches.clear()
    ksel.launches = 0
    tourney = tournament.run_tournament(*TOURNEY_SHAPE, device=dev,
                                        cells=cells)
    torch.cuda.synchronize()
    dt_t = time.perf_counter() - t0
    tourney_launches = {"receive": sum(krecv.launches.values()),
                        "select": ksel.launches}
    committed = json.loads((Path(__file__).resolve().parent
                            / "TOURNEY_r12.json").read_text())
    for row in tourney["rows"]:
        old = next(c for c in committed["rows"]
                   if (c["attack"], c["defense"]) == (row["attack"],
                                                      row["defense"]))
        print(f"tournament row {json.dumps(row)}  TOURNEY_r12.json "
              f"{json.dumps(old)}")
    if (tourney["invariant_violations"] or tourney_launches["receive"]
            or tourney["rows"] != committed["rows"]):
        fail(f"tournament: {tourney['invariant_violations']} cells with "
             f"invariant bits, launches {tourney_launches}, rows equal to "
             f"TOURNEY_r12.json: {tourney['rows'] == committed['rows']}")
    i_byz = next(i for i, r in enumerate(tourney["rows"])
                 if (r["attack"], r["defense"]) == ("byzantine",
                                                    "reference"))
    one_cells = []
    ksel.launches = 0
    tournament.run_tournament(*TOURNEY_SHAPE, device=dev,
                              attacks=("byzantine",),
                              defenses={"reference": {}}, cells=one_cells)
    one_select = ksel.launches
    if one_select != tourney_launches["select"]:
        fail(f"tournament: B3 launches {tourney_launches['select']} for 20 "
             f"cells, {one_select} for one")
    cpu_cells = []
    tournament.run_tournament(*TOURNEY_SHAPE, device="cpu",
                              attacks=("byzantine",),
                              defenses={"reference": {}}, cells=cpu_cells)
    d_byz = [knob_sweep.tree_digest(convert.state_to_numpy(c[1]))
             for c in (cells[i_byz], one_cells[0], cpu_cells[0])]
    if len(set(d_byz)) != 1:
        fail(f"tournament byzantine x reference: card in the grid "
             f"{d_byz[0]}, card alone {d_byz[1]}, CPU {d_byz[2]}")
    del cells, one_cells, cpu_cells
    t_prof = {}
    for label, kw in (("grid", {}), ("one_cell", dict(
            attacks=("byzantine",), defenses={"reference": {}}))):
        _, _, p_g, s_g, step_g, _, _ = tournament.stack_grid(
            *TOURNEY_SHAPE, device=dev, **kw)
        box = [pg.gossip_run_batch(p_g, s_g, 10, step_g, device=dev)]

        def more():
            box[0] = pg.gossip_run_batch(p_g, box[0], 10, step_g,
                                         device=dev)
        prof = flagship.profile_ticks(more, 10)
        t_prof[label] = {key: prof[key] for key in (
            "wall_ms_per_tick", "device_busy_ms_per_tick",
            "device_idle_share", "launches_per_tick")}
        del p_g, s_g, box
    tourney_main = dict(
        rows_equal_committed=tourney["rows"] == committed["rows"],
        worst_case=tourney["worst_case"],
        invariant_violations=tourney["invariant_violations"],
        replica_heartbeats_per_s=tourney["replicas"] * TOURNEY_SHAPE[3]
        / dt_t, wall_s=dt_t, launches=tourney_launches,
        select_launches_one_cell=one_select, profile=t_prof,
        byzantine_digest=d_byz[0])
    print(f"tournament (as one dispatch): {tourney['replicas']} cells at "
          f"{TOURNEY_SHAPE}: {tourney_main['replica_heartbeats_per_s']:.2f}"
          f" replica heartbeats/s ({dt_t:.1f} s), rows equal to "
          f"TOURNEY_r12.json: {tourney_main['rows_equal_committed']}, "
          f"worst case {tourney['worst_case']}, launches {tourney_launches}"
          f" (B3 for one cell alone: {one_select}); launches a tick: grid "
          f"{t_prof['grid']['launches_per_tick']:.1f}, one cell "
          f"{t_prof['one_cell']['launches_per_tick']:.1f}; device busy "
          f"{t_prof['grid']['device_busy_ms_per_tick']:.3f} ms a batched "
          f"tick (one cell {t_prof['one_cell']['device_busy_ms_per_tick']:.3f}"
          f"), idle share {t_prof['grid']['device_idle_share']:.4f}; "
          f"byzantine x reference digest {d_byz[0]} == alone == CPU "
          f"[{name}, {smi}]; {time.perf_counter() - t0:.1f} s")

    # -- 5y. B3 with a replica axis against its plain version and against
    # one launch a replica: 4 x 1,000,000 seeded peers with distinct seeds
    # at C = 16 and 32, the tournament's 20 x 20,000 (N = 0 mod 4) and 20
    # x 20,002 (N = 2 mod 4: quads straddle replicas); each timed
    t0 = time.perf_counter()
    sel_b = {}
    g = torch.Generator(device=dev)
    g.manual_seed(59)
    for reps_b, n_b, c_b in ((4, n, 16), (4, n, 32), (20, 20_000, 16),
                             (20, 20_002, 16)):
        hi = torch.randint(0, 1 << 32, (reps_b, n_b), generator=g,
                           device=dev)
        lo = torch.randint(0, 1 << 32, (reps_b, n_b), generator=g,
                           device=dev)
        el = graph.to_i32(hi & lo) & (-1 if c_b == 32 else (1 << c_b) - 1)
        kb = torch.randint(0, c_b + 3, (reps_b, n_b), generator=g,
                           device=dev).to(torch.int32)
        seeds_b = graph.lane_seed(5, 2, torch.arange(
            reps_b, dtype=torch.int64, device=dev) * 7919 + 3)
        r = check_batched_select(f"select batched {reps_b}x{n_b} C={c_b}",
                                 el, kb, c_b, seeds_b, ksel)
        r["bound"] = bound(3 * 4 * el.numel(), select_ops(el, kb, c_b))
        sel_b[f"{reps_b}x{n_b}_c{c_b}"] = r
        print(f"select batched {reps_b} x {n_b}, C={c_b}: identical to "
              f"plain and to {reps_b} single launches; device time "
              f"{r['ms']:.4f} ms against {r['singles_ms']:.4f} ms for the "
              f"single launches, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}) [{name}, {smi}]")
        del hi, lo, el, kb
    print(f"5y: {time.perf_counter() - t0:.1f} s")

    # -- 5z. the batched flagship as written (batched_flagship.run: 4
    # replicas of the 1M-peer flagship, mesh seeds 0-3, 100 + 3 x 100
    # ticks, the gates of every replica, counts reset just before the
    # timed blocks and read just after), replica 0 against a seed-0 sim
    # alone; then B1 with a replica axis on a real tick of it and on
    # seeded operands whose replicas differ, each family
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    alloc0_b = torch.cuda.memory_allocated()
    bf = batched_flagship.run(dev, check_replica0=True)
    p_b, st_b, step_b = bf.pop("params"), bf.pop("state"), bf.pop("step")
    lb = bf["launches_per_batched_tick"]
    if (lb.get("scored") != 1.0 or set(lb) != {"select", "scored"}
            or lb["select"] != bf["select_launches_one_replica"]):
        fail(f"batched flagship launches a tick {lb}, one replica's B3 "
             f"{bf['select_launches_one_replica']}")
    bf.update(start_bytes=alloc0_b, seconds=time.perf_counter() - t0)
    print(f"batched flagship (the benchmark as written): {bf['replicas']} x "
          f"{bf['n_peers']} peers: {bf['replica_heartbeats_per_s']:.2f} "
          f"replica heartbeats/s ({bf['wall_s']:.2f} s for 3 x 100 "
          f"batched ticks), launches a batched tick {lb} (B3 for one "
          f"replica alone {bf['select_launches_one_replica']}), profile "
          f"{bf['profile']}, gates {bf['gates']}, replica 0 digest "
          f"{bf['replica0_digest']} == the seed-0 sim alone, peak memory "
          f"{bf['peak_memory_gb']:.2f} GB ({alloc0_b} B at the start) "
          f"[{name}, {smi}]; {bf['seconds']:.1f} s")
    ops_b = capture_receive(lambda: step_b(p_b, st_b), krecv)
    # (5ac) the same tick stepped with telemetry (the latency rows on)
    step_tb = pg.make_gossip_step(
        flagship.inputs(n)[0], pg.ScoreSimConfig(), device=dev,
        telemetry=tl.TelemetryConfig(latency_hist=True,
                                     latency_buckets=STACK_TEL_BUCKETS))
    ops_tb = capture_receive(lambda: step_tb(p_b, st_b), krecv)
    del st_b, step_b, step_tb
    t0 = time.perf_counter()
    reps_tick = [krecv._replica_ops(ops_b, b) for b in range(4)]
    cfg_b = pg.GossipSimConfig(offsets=flagship.inputs(n)[0].offsets,
                               n_topics=flagship.N_TOPICS)
    sc_atk = pg.ScoreSimConfig(sybil_ihave_spam=True, sybil_iwant_spam=True)
    unscored_names = set(reps_tick[0]) - set(krecv.SCORED_OPERANDS)
    b1_b = {}
    for label, scfg, var, extra in (
            ("scored", pg.ScoreSimConfig(), {}, {}),
            ("knobs", pg.ScoreSimConfig(), dict(knobs=True),
             dict(knobs=True)),
            ("faults", pg.ScoreSimConfig(), dict(faults=True),
             dict(faults=True)),
            ("attacks", sc_atk, {}, dict(attack=True)),
            ("unscored", None, {}, {}),
            ("unscored_faults", None, dict(faults=True),
             dict(faults=True))):
        k_b = krecv.receive_consts(cfg_b, scfg, **var)
        n_rand = 1_048_576 if scfg is None else n
        rand = replica_operands(k_b, n_rand, dev, 300, **extra)
        # the real tick's operands, adapted to the family: the extra
        # operands each replica's own (the seeded draws of ``rand`` at N)
        adds = replica_operands(k_b, n, dev, 700, **extra)
        tick_reps = []
        for b in range(4):
            ops_t = dict(reps_tick[b])
            if scfg is None:
                ops_t = {key: v for key, v in ops_t.items()
                         if key in unscored_names}
            for key in ("knobs", "alive_w", "flood_ok", "syb"):
                if key in adds[b]:
                    ops_t[key] = adds[b][key]
            tick_reps.append(ops_t)
        r_rand = check_batched_receive(f"{label} batched (seeded)", k_b,
                                       rand, krecv, timed=False)
        r_tick = check_batched_receive(f"{label} batched (a real tick)",
                                       k_b, tick_reps, krecv)
        stacked = stack_receive_operands(tick_reps)
        r_tick["bound"] = bound(r_tick["bytes"], sum(
            receive_ops(k_b, t_) for t_ in tick_reps))
        r_tick["err"] = max(r_rand["max_abs_err"], r_tick["max_abs_err"])
        r_tick["variant"] = krecv.variant(k_b)
        b1_b[label] = r_tick
        print(f"receive batched {label} ({krecv.variant(k_b)}): 4 replicas "
              f"identical to plain and to 4 single launches, seeded at N="
              f"{n_rand} and on a real batched flagship tick at N={n}; "
              f"device time {r_tick['ms']:.4f} ms against "
              f"{r_tick['singles_ms']:.4f} ms for 4 single launches, plain "
              f"{r_tick['plain_ms']:.3f} ms, bound "
              f"{r_tick['bound'][0]:.4f} ms ({r_tick['bound'][1]}) "
              f"[{name}, {smi}]")
        del rand, adds, tick_reps, stacked
    del ops_b, reps_tick, p_b
    b_paths = batched_paths(dev, pg, krecv, ksel, flagship)
    print(f"batched paths at 4 x {BATCHED_PATH_PEERS} peers, "
          f"{BATCHED_PATH_TICKS} ticks each: launches {b_paths} "
          f"[{name}, {smi}]; {time.perf_counter() - t0:.1f} s")

    # -- 5aa. tune_defense at the tournament's shape: coordinate descent
    # over TUNE_SPACE, each step one batched grid
    t0 = time.perf_counter()
    tuned = tournament.tune_defense(*TOURNEY_SHAPE, device=dev)
    torch.cuda.synchronize()
    tuned["wall_s"] = time.perf_counter() - t0
    want_t = dict(worst=0.9139, mean=0.98278, takeover=0.2987)
    got_t = dict(worst=tuned["tuned_worst_case"]["delivery_fraction"],
                 mean=tuned["tuned_mean"], takeover=tuned["tuned_takeover"])
    print(f"tune_defense at {TOURNEY_SHAPE}: {json.dumps(tuned)}")
    print(f"tune_defense: tuned point {tuned['tuned']}, worst case "
          f"{got_t['worst']} (the JAX package's record 0.9139), column mean "
          f"{got_t['mean']} (0.98278), eclipse takeover "
          f"{got_t['takeover']} (0.2987): "
          f"{'the same' if got_t == want_t else 'DIFFERENT'}; wall "
          f"{tuned['wall_s']:.1f} s [{name}, {smi}]")

    # -- 5ab. B1's delay mode with a replica axis: each stack kernel on a
    # real delayed batched tick (the pipelined benchmark's four points
    # stacked at 1M, stepped to the first tick from 8 on with arrivals and
    # retractions live) and on seeded operands (C = 16 at 1M, C = 8 at an
    # odd N)
    t0 = time.perf_counter()
    cfg_d, sc_d, p_d, s_d = pipelined.build_stack(dev, n)
    step_d = pg.make_gossip_step(cfg_d, sc_d, device=dev,
                                 telemetry=tl.TelemetryConfig(
                                     **pipelined.TELEMETRY))
    tick_d, ops_d, launched_d = delayed_tick(p_d, s_d, step_d, krecv, 8, 40,
                                             False)
    if launched_d != {pipelined.VARIANT: tick_d + 1}:
        fail(f"the delayed stack's launches to tick {tick_d}: {launched_d}")
    del p_d, s_d, step_d
    reps_d = [krecv._replica_ops(ops_d, b) for b in range(4)]
    del ops_d
    delay_b = stack_kernel_rows("delays", reps_d, cfg_d, n, dev,
                                f"tick {tick_d} of the pipelined stack")
    del reps_d
    print(f"5ab: {time.perf_counter() - t0:.1f} s")

    # -- 5ac. B1's telemetry tally with a replica axis: each stack kernel
    # on a real batched telemetry tick (5z's batched flagship, stepped with
    # the latency rows on) and on seeded operands, the [B, 8 + L] tally
    # equal to the single launches' tallies
    t0 = time.perf_counter()
    reps_t = [krecv._replica_ops(ops_tb, b) for b in range(4)]
    del ops_tb
    tel_b = stack_kernel_rows("tel", reps_t, flagship.inputs(n)[0], n, dev,
                              "a real batched flagship telemetry tick")
    del reps_t
    print(f"5ac: {time.perf_counter() - t0:.1f} s")

    # -- 5ad. the slice's main path: the pipelined benchmark as the JAX
    # package runs it, its four points stacked and advanced as ONE batched
    # dispatch (telemetry_run_batch), at 100,000 and 1,000,000 peers, the
    # counts reset just before and read just after; then (5ae) every
    # replica of the 100,000-peer run against its point run alone (5q)
    main_pipe_b = {}
    for n_p in (pipelined.N_PEERS, pipelined.FULL_WIDTH):
        torch.cuda.synchronize()
        alloc0_p = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        r = pipelined.run(dev, n_p)
        for pid, row in r["rows"].items():
            print(f"pipelined batched {n_p} {pid}: delivery fraction "
                  f"{row['delivery_fraction']!r}, latency {row['latency']}, "
                  f"digest {row['digest']}, histogram {row['hist']}")
        print(f"pipelined batched {n_p} (one dispatch, 4 x {n_p}): gates "
              f"{r['gates']}, p99 {r['p99']}, p99_stretch_base4 "
              f"{r['p99_stretch_base4']!r}, replica heartbeats/s "
              f"{r['replica_heartbeats_per_s']!r} ({r['wall_s']:.3f} s for "
              f"{r['ticks']} batched ticks), launches {r['launches']} "
              f"(select {r['select_launches']}), libraries built during the "
              f"run {r['libraries_built']}, peak memory {r['peak_bytes']} B "
              f"({alloc0_p} B at the start) "
              f"({time.perf_counter() - t0:.1f} s) [{name}, {smi}]")
        if not r["ok"]:
            fail(f"pipelined batched at {n_p} peers: "
                 f"{json.dumps({k_: v for k_, v in r.items() if k_ != 'rows'})}")
        r["start_bytes"] = alloc0_p
        main_pipe_b[n_p] = r
    cross = pipelined.cross_check(main_pipe_b[pipelined.N_PEERS],
                                  main_pipe[pipelined.N_PEERS])
    print(f"pipelined cross-check at {pipelined.N_PEERS} peers: every "
          f"replica's digest and histogram equal to its point run alone "
          f"{cross['rows']}, B3 launches batched {cross['select_batched']} "
          f"against one point's {cross['select_one_point']}")
    if not cross["ok"]:
        fail(f"pipelined batched != sequential: {cross}")
    # the stack kernels through the user's batched runners (their launches)
    t0 = time.perf_counter()
    s_paths = stack_paths(dev, flagship)
    print(f"stack paths at 4 x {STACK_PATH_PEERS} peers, "
          f"{STACK_PATH_TICKS} ticks each: {json.dumps(s_paths)} "
          f"[{name}, {smi}]; {time.perf_counter() - t0:.1f} s")

    # -- 5af, 5ag. the mesh-less simulators (no hand-written kernel: the
    # reference leaves them to XLA, the dense hop to a matmul): the card's
    # step forms against the CPU's digest for digest, then the full-width
    # runs; no B1, B2 or B3 launch and no library built across both
    libs_m = floodsub_flagship.reset_kernel_counts()
    t0 = time.perf_counter()
    cpu_all = cpu_forms[0].result()
    cpu_pool.shutdown()
    meshless = {}
    for phase, mod in (("5af", floodsub_flagship), ("5ag", randomsub_10k)):
        t1 = time.perf_counter()
        card_d = mod.forms(dev)
        t_card = time.perf_counter() - t1
        cpu_d, t_cpu = cpu_all[phase]
        bad = {k_: (card_d[k_], cpu_d[k_]) for k_ in card_d
               if card_d[k_] != cpu_d[k_]}
        print(f"{phase} forms card == CPU: {json.dumps(card_d)} (card "
              f"{t_card:.1f} s, CPU {t_cpu:.1f} s in the child process)")
        if bad or set(card_d) != set(cpu_d):
            fail(f"{phase}: the card's forms differ from the CPU's: {bad}")
        meshless[phase] = dict(forms=card_d, card_s=t_card, cpu_s=t_cpu)
    rows_m = {}
    for key, call in (
            ("floodsub circulant 1M",
             lambda: floodsub_flagship.run("circulant", dev,
                                           profile_ticks=20)),
            ("floodsub gather 1M",
             lambda: floodsub_flagship.run("gather", dev, profile_ticks=20)),
            ("randomsub dense 10k (the benchmark as written)",
             lambda: randomsub_10k.run(True, dev, profile_ticks=20)),
            ("randomsub circulant 1M",
             lambda: randomsub_10k.run(False, dev, profile_ticks=20))):
        torch.cuda.synchronize()
        alloc0_m = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        r = call()
        prof = r.pop("profile")
        r["idle_share"] = prof["device_idle_share"]
        r["launches_per_tick"] = prof["launches_per_tick"]
        r["device_busy_ms_per_tick"] = prof["device_busy_ms_per_tick"]
        r["top_ops"] = prof["ops"][:5]
        r["start_bytes"] = alloc0_m
        print(f"{key}: {r['heartbeats_per_s']!r} heartbeats/s "
              f"({r['wall_s']:.3f} s for {floodsub_flagship.REPS} x "
              f"{floodsub_flagship.TIMED} ticks), gate "
              f"{r['gate']} (reach min {r['reach_min']} of "
              f"{r['reach_want']}), peak memory {r['peak_bytes']} B "
              f"({alloc0_m} B at the start), idle share "
              f"{r['idle_share']!r}, launches a tick "
              f"{r['launches_per_tick']!r}, device busy "
              f"{r['device_busy_ms_per_tick']!r} ms a tick, kernels "
              f"{r['launches']}, digest {r['digest']} "
              f"({time.perf_counter() - t1:.1f} s) [{name}, {smi}]")
        if "reach_by_hops_16" in r:
            print(f"{key} reach_by_hops (16 hops, summed over the "
                  f"messages): {r['reach_by_hops_16']}; in ticks since "
                  f"publish: {r['reach_by_hops_since_publish_16']}")
        if not r["ok"]:
            fail(f"{key}: {json.dumps(r)}")
        rows_m[key] = r
    launched_m = floodsub_flagship.kernel_counts(libs_m)
    print(f"5af-5ag: kernels across the phases {launched_m} "
          f"({time.perf_counter() - t0:.1f} s)")
    if (launched_m["receive"] or launched_m["fused"] or launched_m["select"]
            or launched_m["libraries_built"]):
        fail(f"5af-5ag launched or built a kernel: {launched_m}")
    meshless["rows"] = rows_m
    meshless["kernels"] = launched_m

    # -- 5ah, 5ai. the RPC probe's forms card against CPU, the 20,000-peer
    # pipeline's bytes, and the trace-export benchmark's export read back
    t0 = time.perf_counter()
    trace_main = trace_finish(dev, trace_started, cpu_forms[1].result(),
                              name, smi)
    print(f"5ah-5ai: {time.perf_counter() - t0:.1f} s")

    # -- 5aj. the sweep server as written (sweepd_bench.run_sweepd: the
    # batched server at 10,000 peers, the 24 seed replicas then the 24
    # scenarios, every gate of bench_suite.py:1044-1150), counts reset just
    # before and read just after; its rows against the JAX package's
    t0 = time.perf_counter()
    krecv.launches.clear()
    ksel.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_s = torch.cuda.memory_allocated()
    built0 = _build.compiled
    sw = sweepd_bench.run_sweepd(dev)
    torch.cuda.synchronize()
    sw.update(select=ksel.launches, receive=sum(krecv.launches.values()),
              sources_built=_build.compiled - built0,
              peak_bytes=torch.cuda.max_memory_allocated(),
              start_bytes=alloc0_s)
    sw["rows_equal_reference"] = (
        sweepd_bench.rows_equal(sw["rows"],
                                sweepd_bench.REFERENCE_ROWS["sweep"])
        and sweepd_bench.rows_equal(sw["seed_rows"],
                                    sweepd_bench.REFERENCE_ROWS["seed"]))
    print(f"5aj sweepd at {sweepd_bench.SHAPE}: {sw['replica_hbps']!r} "
          f"replica heartbeats/s ({sw['sweep_wall_s_unrounded']!r} s for "
          f"the 24 scenarios), sweep/seed wall ratio "
          f"{sw['sweep_vs_seed_ratio']!r} (gate <= 2.0), compiles "
          f"{sw['compiles']}, B3 launches (batched) {sw['select']}, B1 "
          f"launches {sw['receive']} (the receive loops serve), sources "
          f"built {sw['sources_built']}, peak memory "
          f"{sw['peak_bytes']} B ({alloc0_s} B at the start), rows equal "
          f"to the JAX package's: {sw['rows_equal_reference']} "
          f"({time.perf_counter() - t0:.1f} s) [{name}, {smi}]")
    if (not sw["rows_equal_reference"] or sw["receive"] or not sw["select"]
            or sw["sources_built"]):
        fail(f"5aj: rows {sw['rows']}, seed rows {sw['seed_rows']}, B1 "
             f"{sw['receive']}, B3 {sw['select']}, sources built "
             f"{sw['sources_built']}")

    # -- 5ak. the kernel server (batch 1) at 512 and at 10,000 peers: B1's
    # attacks_faults+knobs variant every tick, checked against plain
    t0 = time.perf_counter()
    swk = {shape: sweepd_kernel_phase(dev, shape, krecv, ksel, pg)
           for shape in sweepd_bench.KERNEL_SHAPES}
    for shape, r in swk.items():
        print(f"5ak kernel server {shape} "
              f"{sweepd_bench.KERNEL_SHAPES[shape]}: rows equal to the JAX "
              f"package's, receive launches {r['launches']}, select "
              f"{r['select']}, receive-loop passes {r['loop_passes']}, kept "
              f"ticks kernel == plain (max abs err {r['max_abs_err']!r}), "
              f"compiles {r['compiles']}, {r['replica_hbps']!r} replica "
              f"heartbeats/s [{name}, {smi}]")
    print(f"5ak: {time.perf_counter() - t0:.1f} s")

    # -- 5al. the checkpoint benchmark as written at 1,000,000 peers
    # (checkpoint_bench.run: single, S2, S4, kill_resume; snapshots in a
    # temporary directory removed after), counts reset just before and
    # read just after; every digest the JAX package's; ckptstat as written
    # (its table and exit code printed), its identity and compile gates
    # clean.  Its overhead gate (segmented <= 10x single, set against the
    # reference's 8.8 s CPU run) is reported: on the card 8 ticks take
    # ~0.03 s and each 248 MB snapshot ~1 s of host copy, npz, CRC and
    # fsync, timed apart below
    t0 = time.perf_counter()
    krecv.launches.clear()
    ksel.launches = 0
    ck_art = checkpoint_bench.run(dev)
    ck_launch = dict(receive=dict(krecv.launches), select=ksel.launches)
    digests = {r_["id"]: r_["digest"] for r_ in ck_art["rows"]}
    with tempfile.TemporaryDirectory() as td:
        art_path = str(Path(td) / "checkpoint.json")
        Path(art_path).write_text(json.dumps(ck_art))
        rc_stat = ckptstat.main([art_path])
    stat_gates = ckptstat.gates(ck_art["rows"])
    rows_s = {r_["id"]: r_ for r_ in ck_art["rows"]}
    print(f"5al checkpoint at {checkpoint_bench.N_PEERS} peers: digests "
          f"{digests} (the JAX package's {checkpoint_bench.REFERENCE_DIGEST})"
          f", single {rows_s['single']['wall_s_unrounded']!r} s, S2 "
          f"{rows_s['segmented_S2']['wall_s_unrounded']!r} s "
          f"({rows_s['segmented_S2']['snapshot_bytes']} B of snapshots), S4 "
          f"{rows_s['segmented_S4']['wall_s_unrounded']!r} s "
          f"({rows_s['segmented_S4']['snapshot_bytes']} B), kill_resume "
          f"from tick {rows_s['kill_resume']['resumed_from_tick']}, "
          f"compiles {[r_.get('compiles') for r_ in ck_art['rows']]}, "
          f"launches {ck_launch}, ckptstat rc {rc_stat}, its failing "
          f"gates {sorted({g for g, _ in stat_gates})} "
          f"({time.perf_counter() - t0:.1f} s) [{name}, {smi}]")
    print("5al one snapshot's host seconds: " + json.dumps(
        checkpoint_bench.snapshot_seconds(dev)) + f" [{name}, {smi}]")
    if (set(digests.values()) != {checkpoint_bench.REFERENCE_DIGEST}
            or {g for g, _ in stat_gates} - {"overhead"}):
        fail(f"5al: {json.dumps(ck_art)}")

    # -- 5am. the fused runner segmented at the resident shape: 4 windows
    # of 8, segmented by 2 windows, killed after the first segment and
    # resumed, against the unsegmented fused run; B2 once a window
    t0 = time.perf_counter()
    cfg_f, params_f, state_f, *_ = resident.build(dev)
    window_f = pg.make_fused_window(cfg_f, None, ticks_fused=8, device=dev)
    d_whole = digest(pg.gossip_run_fused(params_f, pg.tree_copy(state_f), 32,
                                         window_f, device=dev))
    kfused.launches = 0
    with tempfile.TemporaryDirectory() as td:
        ckc_f = ckpt.CheckpointConfig(directory=td, every=16)
        ckpt.request_stop()
        try:
            ckpt.ckpt_gossip_run_fused(params_f, pg.tree_copy(state_f), 32,
                                       window_f, ckc_f, device=dev)
            fail("5am: the stop flag did not interrupt the fused run")
        except ckpt.CheckpointInterrupt as e:
            killed_at = e.ticks_done
        finally:
            ckpt.clear_stop()
        resumed = ckpt.ckpt_gossip_run_fused(params_f, pg.tree_copy(state_f),
                                             32, window_f, ckc_f, device=dev)
        d_resumed = digest(resumed)
    b2_fused = kfused.launches
    print(f"5am fused segmented at the resident shape: killed after "
          f"{killed_at} ticks, resumed digest {d_resumed} against the "
          f"unsegmented {d_whole}, B2 launches {b2_fused} for 4 windows "
          f"({time.perf_counter() - t0:.1f} s) [{name}, {smi}]")
    if d_resumed != d_whole or killed_at != 16 or b2_fused != 4:
        fail(f"5am: {killed_at} {d_resumed} {d_whole} {b2_fused}")
    del params_f, state_f, resumed

    # -- 5an. the server as a process on the card (run during the build):
    # SIGTERM drains and exits 0, a SIGKILLed server's journal replays,
    # every row equal to an uninterrupted run's
    restart = restart_run[0].result()
    restart_pool.shutdown()
    print("5an sweepd restart: " + json.dumps(
        {k_: v for k_, v in restart.items() if k_ != "rows"}))
    if not restart["ok"]:
        fail(f"5an: {json.dumps(restart)}")

    # -- 5ap. the front end at the sweepd CLI's full width: three shapes
    # drawn Zipf, two resident buckets, batch 6; its rows against
    # SweepServer.submit's at each bucket's shape
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0_w = torch.cuda.memory_allocated()
    built0 = _build.compiled
    fw_ph: dict = {}
    fw = serving_bench.full_width(dev, hook=counted_phases(fw_ph))
    fw.update(phases=fw_ph, sources_built=_build.compiled - built0,
              peak_bytes=torch.cuda.max_memory_allocated(),
              start_bytes=alloc0_w)
    fw_st = fw["stats"]
    print(f"5ap front end at full width {fw['pool']} [{name}, {smi}]: "
          f"served {fw_st['served']} of {fw_st['admitted']} "
          f"({fw_st['timeouts']} timeouts), {fw['served_per_s']!r} served/s,"
          f" {fw['replica_hbps']!r} replica heartbeats/s, compiles "
          f"{fw_st['compiles']} for {fw['distinct_shapes']} shapes, "
          f"evictions {fw_st['evictions']}, rows equal to SweepServer."
          f"submit's: {fw['rows_equal_submit']}, launches "
          f"{json.dumps(fw_ph)}, peak memory {fw['peak_bytes']} B "
          f"({alloc0_w} B at the start) "
          f"({time.perf_counter() - t0:.1f} s)")
    if (fw_st["compiles"] != fw["distinct_shapes"]
            or fw["distinct_shapes"] != 3 or not fw_st["evictions"]
            or fw_st["errors"] or fw_st["transient_failures"]
            or fw_st["admitted"] != fw_st["served"] + fw_st["errors"]
            + fw_st["timeouts"] + fw_st["transient_failures"]
            + fw_st["queued"] + fw_st["parked"]
            or not fw["rows_equal_submit"]
            or fw_ph["front_end"]["receive"]
            or not fw_ph["front_end"]["select"] or fw["sources_built"]):
        fail("5ap: " + json.dumps(fw))

    # -- 5aq. the metrics row as written: the fleet against a sweepd
    # --multi child on the card, the span ledger, delay parity on B1
    t0 = time.perf_counter()
    met_ph: dict = {}
    met = metrics_bench.run(dev, hook=counted_phases(met_ph))
    mf, msp, mpar = met["fleet"], met["spans"], met["delay_parity"]
    print(f"5aq metrics as written [{name}, {smi}]: fleet {mf['rps']!r} rps"
          f" ({mf['rows_received']} rows for {mf['requests_sent']} sent), "
          f"{mf['scrape_count']} scrapes ({mf['mid_flight_scrapes']} "
          f"mid-flight), identity {mf['identity_ok']}, cross "
          f"{mf['cross_match']}, spans {mf['spans_match']}, trace events "
          f"{mf['trace_events']}; spans traces {msp['traces']} for "
          f"{msp['admitted']} admitted, open {msp['open_spans']}, dropped "
          f"{msp['dropped_events']}; parity {json.dumps(mpar)} (the JAX "
          f"package's {json.dumps(metrics_bench.REFERENCE_PARITY)}); "
          f"phases {json.dumps(met_ph)} "
          f"({time.perf_counter() - t0:.1f} s)")
    if (mf["rows_received"] != 18 or mf["requests_sent"] != 18
            or not mf["identity_ok"] or not mf["cross_match"]
            or not mf["spans_match"] or not mf["trace_events"]
            or msp["traces"] != msp["admitted"] or msp["open_spans"]
            or msp["dropped_events"]
            or any(mpar[k] != v
                   for k, v in metrics_bench.REFERENCE_PARITY.items())
            or not met_ph["delay_parity"]["receive"]):
        fail("5aq: " + json.dumps(met))
    parity_launches = met_ph["delay_parity"]["receive"]

    # -- 5ar. servestat and obsstat as written on 5ao's and 5aq's
    # artifacts, against the JAX package's committed baselines
    with tempfile.TemporaryDirectory() as td:
        serve_path, met_path = Path(td) / "serving.json", Path(td) / "m.json"
        serve_path.write_text(json.dumps(serve))
        met_path.write_text(json.dumps(met))
        here = Path(__file__).resolve().parent
        print("5ar servestat --check SERVE_r18.json:", flush=True)
        rc_serve = servestat.main([str(serve_path), "--check",
                                   str(here / "SERVE_r18.json")])
        print("5ar obsstat --check METRICS_r19.json:", flush=True)
        rc_obs = obsstat.main([str(met_path), "--check",
                               str(here / "METRICS_r19.json")])
    print(f"5ar servestat rc {rc_serve}, obsstat rc {rc_obs}")
    if rc_serve or rc_obs:
        fail(f"5ar: servestat rc {rc_serve}, obsstat rc {rc_obs}")

    # -- 6. the unscored receive kernel vs plain at the resident shapes
    n_r = resident.N_PEERS
    cfg_r, params, state, msg_topic, _ = resident.build(dev)
    k_u = krecv.receive_consts(cfg_r, None)
    ops = random_receive_operands(k_u, n_r, 1, dev, seed=13)
    err_urand = check_identical("unscored receive (random operands)",
                                krecv.receive_update(k_u, **ops),
                                krecv.receive_update_plain(k_u, **ops))
    step_u = pg.make_gossip_step(cfg_r, None, device=dev)
    tick_ops = capture_receive(
        lambda: pg.gossip_run(params, state, 12, step_u, device=dev), krecv)
    want = krecv.receive_update_plain(k_u, **tick_ops)
    got = krecv.receive_update(k_u, **tick_ops)
    torch.cuda.synchronize()
    err_utick = check_identical("unscored receive (a real tick)", got, want)
    urcv_ms = device_ms(lambda: krecv.receive_update(k_u, **tick_ops), 50)
    urcv_plain_ms = device_ms(
        lambda: krecv.receive_update_plain(k_u, **tick_ops), 5)
    urcv_bytes = krecv.operand_bytes(tick_ops, got)
    urcv_bound = bound(urcv_bytes, receive_ops(k_u, tick_ops))
    print(f"unscored receive: identical at N={n_r}, C={C}, W=1 (random "
          f"and real tick); device time: kernel {urcv_ms:.4f} ms, plain "
          f"{urcv_plain_ms:.3f} ms; {urcv_bytes / n_r:.1f} B/peer")
    del want, got, ops, tick_ops

    # -- 7. the fused-window kernel vs plain, N = 1M, T = 8, on two real
    # carries: the built state (mesh formation: grafts and prunes run)
    # and the state after warm-up (12 per-tick steps), where it is timed
    k_f = kfused.fused_consts(cfg_r)
    all_c = (1 << cfg_r.n_candidates) - 1
    real_sel = kfused.select_plain
    err_fused = 0.0
    for st in (state, pg.gossip_run(params, state, 12, step_u, device=dev)):
        tk = torch.arange(st.tick, st.tick + Tw, dtype=torch.int32,
                          device=dev)
        fops = dict(
            tick0=st.tick, seeds=kfused.window_seeds(st.tick, Tw, st.salt),
            due=graph.pack_bits(params.publish_tick[None, :] == tk[:, None]),
            sub_all=torch.where(params.subscribed, all_c, 0).to(torch.int32),
            cand_sub=params.cand_sub_bits, origin=params.origin_words,
            have=st.have, recent=st.recent, mesh=st.mesh, fanout=st.fanout,
            last_pub=st.last_pub, backoff=st.backoff, tgt=st.gates[0],
            bog=st.gates[1])
        sel_rows = [0]

        def count_sel(elig, kk, c, seed):
            sel_rows[0] += drawn_rows(elig, kk)
            return real_sel(elig, kk, c, seed)

        kfused.select_plain = count_sel
        try:
            want = kfused.fused_gossip_update_plain(k_f, **fops)
        finally:
            kfused.select_plain = real_sel
        got = kfused.fused_gossip_update(k_f, **fops)
        torch.cuda.synchronize()
        err_fused = max(err_fused, check_identical(
            f"fused window from tick {st.tick}", got, want))
        print(f"fused window: identical at N={n_r}, C={C}, W=1, T={Tw} "
              f"from tick {st.tick} ({sel_rows[0]} selection rows)")
    # a cooperative launch is timed by CUDA events over back-to-back
    # launches (no CUDA-graph capture)
    fused_ms = eager_ms(lambda: kfused.fused_gossip_update(k_f, **fops), 20)
    fused_plain_ms = eager_ms(
        lambda: kfused.fused_gossip_update_plain(k_f, **fops), 2)
    fused_bytes = kfused.window_operand_bytes(fops)
    fused_bound = bound(fused_bytes,
                        fused_window_ops(k_f, fops, sel_rows[0]))
    print(f"fused window from tick {st.tick}: kernel {fused_ms:.4f} ms, "
          f"plain {fused_plain_ms:.3f} ms per window; operands "
          f"{fused_bytes / n_r:.1f} B/peer, bound {fused_bound[0]:.4f} ms "
          f"({fused_bound[1]}); the kernel's stage, apart: "
          f"{kfused.stage_bytes(k_f, fops) / n_r:.1f} B/peer")
    del want, got, fops, st

    # -- 8. full-size identity: 16 per-tick steps vs 2 fused windows
    win = pg.make_fused_window(cfg_r, None, ticks_fused=Tw, device=dev)
    d_tick = digest(pg.gossip_run(params, state, 2 * Tw, step_u,
                                  device=dev))
    d_fused = digest(pg.gossip_run_fused(params, state, 2 * Tw, win,
                                         device=dev))
    if d_tick != d_fused:
        fail(f"digest: per-tick {d_tick} != fused {d_fused}")
    print(f"identity: {2 * Tw} per-tick ticks and 2 fused windows at "
          f"N={n_r}: digest {d_fused} both")
    del params, state

    # -- 9. the resident main path, then the per-tick path, each with its
    # counts reset just before and read just after
    horizon = RES_WARMUP + RES_TIMED
    paths = {}
    for path in ("fused", "per_tick"):
        cfg_r, params, state, msg_topic, msg_tick = resident.build(
            dev, horizon=horizon)
        if path == "fused":
            win = pg.make_fused_window(cfg_r, None, ticks_fused=Tw,
                                       device=dev)

            def run_n(st, n_ticks):
                return pg.gossip_run_fused(params, st, n_ticks, win,
                                           device=dev)
        else:
            step_u = pg.make_gossip_step(cfg_r, None, device=dev)

            def run_n(st, n_ticks):
                return pg.gossip_run(params, st, n_ticks, step_u,
                                     device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        krecv.launches.clear()
        ksel.launches = kfused.launches = 0
        state = run_n(state, RES_WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_n(state, RES_TIMED)
        torch.cuda.synchronize()
        dt_r = time.perf_counter() - t0
        counts = {"receive": krecv.launches["scored"],
                  "receive_unscored": krecv.launches["unscored"],
                  "select": ksel.launches, "fused": kfused.launches}
        peak_r = torch.cuda.max_memory_allocated()
        sub = params.subscribed
        deg_r = pg.mesh_degrees(state)[sub].to(torch.float64).mean().item()
        if not deg_r >= cfg_r.d_lo:
            fail(f"{path}: mesh failed to form: mean degree {deg_r}")
        reach, members = resident.topic_reach(params, state, msg_topic,
                                              resident.N_TOPICS)
        settled = msg_tick < horizon - 30
        if not (reach[settled] == members[settled]).all():
            fail(f"{path}: delivery gate: reach {reach[settled].tolist()} "
                 f"!= members {members[settled].tolist()}")
        if state.tick != horizon:
            fail(f"{path}: state tick {state.tick}")
        if path == "fused":
            want_counts = {"receive": 0, "receive_unscored": 0, "select": 0,
                           "fused": horizon // Tw}
            if counts != want_counts:
                fail(f"fused path launches {counts} != {want_counts}")
        elif (counts["receive_unscored"] != horizon or counts["fused"]
              or counts["receive"] or counts["select"] != 3 * horizon):
            fail(f"per-tick path launches {counts}")
        paths[path] = dict(
            heartbeats_per_s=RES_TIMED / dt_r,
            ms_per_tick=dt_r * 1e3 / RES_TIMED, peak_bytes=peak_r,
            mean_mesh_degree=deg_r, launches=counts,
            settled_messages=int(settled.sum()))
        print(f"resident {path}: {n_r} peers x {resident.N_TOPICS} topics, "
              f"C={C}, M={resident.N_MSGS}: {RES_TIMED / dt_r:.2f} "
              f"heartbeats/s ({dt_r * 1e3 / RES_TIMED:.3f} ms/tick), mean "
              f"mesh degree {deg_r:.3f}, {int(settled.sum())} settled "
              f"messages each at all {members[settled].tolist()} members, "
              f"peak memory {peak_r} B, launches {counts}")
        del params, state

    # -- 10. the numbers
    print(f"heartbeats/s [{name}, {smi}]: flagship scored per-tick "
          f"{hb:.2f}; adversarial scored per-tick {hb_a:.2f}; "
          f"everything-on scored per-tick {hb_e:.2f}; everything-on paired "
          f"(the benchmark as written) per-tick {hb_p:.2f}; churn (the "
          f"benchmark as written) scored per-tick {hb_c:.2f}; telemetry "
          f"(the benchmark as written) off {hb_off:.2f}, on {hb_on:.2f}; "
          f"resident "
          f"unscored "
          f"fused "
          f"{paths['fused']['heartbeats_per_s']:.2f}, per-tick "
          f"{paths['per_tick']['heartbeats_per_s']:.2f}; " + "; ".join(
              f"{key} {r_['heartbeats_per_s']:.2f}"
              for key, r_ in rows_m.items()))
    print(f"knob sweep heartbeats/s [{name}, {smi}]: " + "; ".join(
        f"{kind} " + ", ".join(
            f"{pname} {row['heartbeats_per_s']:.2f}"
            for pname, row in main_knobs[kind]["rows"].items())
        for kind in knob_sweep.SWEEPS))
    print(f"pipelined batched (one dispatch) [{name}, {smi}]: " + "; ".join(
        f"{n_p} peers replica heartbeats/s "
        f"{r_['replica_heartbeats_per_s']:.2f}, peak memory "
        f"{r_['peak_bytes']} B" for n_p, r_ in main_pipe_b.items()))
    print(f"pipelined sequential [{name}, {smi}]: " + "; ".join(
        f"{n_p} peers replica heartbeats/s "
        f"{r_['replica_heartbeats_per_s']:.2f}, p99 " + ", ".join(
            f"{pid} {p99}" for pid, p99 in r_["p99"].items())
        + f", p99_stretch_base4 {r_['p99_stretch_base4']!r}"
        for n_p, r_ in main_pipe.items())
        + f"; steady state at {pipelined.FULL_WIDTH} peers heartbeats/s "
        f"without delays {steady['plain']['heartbeats_per_s']:.2f}, "
        f"DelayConfig(4, 2, 8) {steady['delayed']['heartbeats_per_s']:.2f}, "
        f"delayed idle share {prof_d['device_idle_share']!r}")
    print(f"mesh-less [{name}, {smi}]: " + "; ".join(
        f"{key} peak memory {r_['peak_bytes']} B, idle share "
        f"{r_['idle_share']!r}, launches a tick {r_['launches_per_tick']!r}"
        for key, r_ in rows_m.items()))
    print(f"invariants [{name}, {smi}]: {inv_main['n_peers']} peers, "
          f"checker off {hb_ioff!r} heartbeats/s, on {hb_ion!r}, overhead "
          f"{inv_main['invariant_overhead_pct']!r}%, bits "
          f"{inv_main['report']['bits']}")
    print(f"churn rows [{name}, {smi}]: heartbeats/s {hb_c!r}; delivery "
          f"fraction {main_churn['delivery_fraction']!r} (gate > "
          f"{churn.MIN_DELIVERY_FRACTION}); partition recovery ticks, "
          f"median {main_churn['recovery_ticks_median']!r} of "
          f"{main_churn['probes_recovered']} recovered probes")
    rcv_bound = bound(rcv_bytes, rcv_ops)
    sel_bound = bound(sel_bytes, sel_ops)
    kernels = [
        dict(name="receive_update", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=(launches["receive"]
                       + ck_launch["receive"].get("scored", 0)),
             max_abs_err=max(err_rand, err_tick, inv_k["receive"]["err"]),
             ms=rcv_ms,
             plain_ms=rcv_plain_ms, bound_ms=rcv_bound[0],
             bound_by=rcv_bound[1], library_ms=None),
        dict(name="receive_update_attacks", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=launches_adv["receive_attacks"],
             max_abs_err=max(err_arand, err_atick), ms=arcv_ms,
             plain_ms=arcv_plain_ms, bound_ms=arcv_bound[0],
             bound_by=arcv_bound[1], library_ms=None),
        dict(name="receive_update_full", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=launches_ev["receive_full"],
             max_abs_err=max(err_full, err_xk), ms=full_ms,
             plain_ms=full_plain_ms, bound_ms=full_bound[0],
             bound_by=full_bound[1], library_ms=None),
        dict(name="receive_update_paired", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=launches_pp["receive_paired"],
             max_abs_err=err_paired, ms=paired_ms, plain_ms=paired_plain_ms,
             bound_ms=paired_bound[0], bound_by=paired_bound[1],
             library_ms=None),
        dict(name="receive_update_paired_unscored", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=launches_up["receive_paired_unscored"],
             max_abs_err=err_up, ms=up_ms, plain_ms=up_plain_ms,
             bound_ms=up_bound[0], bound_by=up_bound[1], library_ms=None),
        dict(name="receive_update_unscored", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
             launches=paths["per_tick"]["launches"]["receive_unscored"],
             max_abs_err=max(err_urand, err_utick), ms=urcv_ms,
             plain_ms=urcv_plain_ms, bound_ms=urcv_bound[0],
             bound_by=urcv_bound[1], library_ms=None),
        dict(name="select_k_bits", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/select.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/select.py:39",
             launches=(launches["select"] + ck_launch["select"]
                       + sum(r_["select"] for r_ in swk.values())),
             max_abs_err=max(sel_err, inv_k["select"]["err"]),
             ms=sel_ms, plain_ms=sel_plain_ms, bound_ms=sel_bound[0],
             bound_by=sel_bound[1], library_ms=None),
        dict(name="select_k_bits_c32", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/select.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/select.py:39",
             launches=wide_launches["select"], max_abs_err=s32_err,
             ms=s32_ms, plain_ms=s32_plain_ms, bound_ms=s32_bound[0],
             bound_by=s32_bound[1], library_ms=None),
        dict(name="fused_gossip_update", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/fused.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:1662",
             launches=paths["fused"]["launches"]["fused"] + b2_fused,
             max_abs_err=err_fused, ms=fused_ms, plain_ms=fused_plain_ms,
             bound_ms=fused_bound[0], bound_by=fused_bound[1],
             library_ms=None),
        dict(name="fused_gossip_update_exact_k", route="cuda",
             source="go_libp2p_pubsub_tpu_torch/csrc/fused.cu",
             replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:1662",
             launches=counts_x["fused"], max_abs_err=err_fx, ms=fx_ms,
             plain_ms=fx_plain_ms, bound_ms=fx_bound[0],
             bound_by=fx_bound[1], library_ms=None)]
    # the faulted variants: the churn path's launches for the flagship
    # options, else those of the run to the checked tick
    for kname, r in faulted.items():
        kernels.append(dict(
            name=kname, route="cuda",
            source="go_libp2p_pubsub_tpu_torch/csrc/receive.cu",
            replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
            launches=(launches_c["scored_faults"]
                      if kname == "receive_update_faults"
                      else r["launches"]),
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=None))
    kernels.append(dict(
        name="fused_gossip_update_faults", route="cuda",
        source="go_libp2p_pubsub_tpu_torch/csrc/fused.cu",
        replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:1662",
        launches=counts_fc["fused_faults"], max_abs_err=err_fc, ms=fc_ms,
        plain_ms=fc_plain_ms, bound_ms=fc_bound[0], bound_by=fc_bound[1],
        library_ms=None))
    # the telemetry variants: for the flagship options the telemetry
    # path's launches and the times at its shapes (5l; the L = 16 check of
    # 5k in the main_path line), else those of the run to the checked tick
    # (fused: the 64 heartbeats on windows)
    rows_tel = dict(tel_k, receive_update_tel=dict(
        tel_main_k, err=max(tel_k["receive_update_tel"]["err"],
                            tel_main_k["err"]),
        launches=tel_main["on"]["launches"]["scored+tel"]
        + parity_launches.get("scored+tel", 0)))
    for kname, r in rows_tel.items():
        kernels.append(dict(
            name=kname, route="cuda",
            source="go_libp2p_pubsub_tpu_torch/csrc/receive_tel.cu",
            replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
            launches=r["launches"], max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=None))
    # the knob variants: for the main path's three (the flagship's
    # options, clean and faulted, and the attack options) the sweep's
    # launches, else those of the run to the checked tick
    main_variant = {"receive_update_knobs": "scored+knobs",
                    "receive_update_attacks_knobs": "attacks+knobs",
                    "receive_update_faults_knobs": "scored_faults+knobs"}
    # the kernel server's variant: 5ak's launches added
    served_k = sum(r_["launches"].get("attacks_faults+knobs", 0)
                   for r_ in swk.values())
    for kname, r in knob_k.items():
        kernels.append(dict(
            name=kname, route="cuda",
            source=("go_libp2p_pubsub_tpu_torch/csrc/"
                    + ("receive_tel_knobs.cu" if "_tel" in kname
                       else "receive_knobs.cu")),
            replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
            launches=(main_knob_launches[main_variant[kname]]
                      if kname in main_variant else r["launches"])
            + (served_k if kname == "receive_update_attacks_faults_knobs"
               else 0),
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=None))
    # the delayed variants: for the main path's (the flagship's scored
    # options with knobs) the pipelined runs' launches, else those of the
    # run to the checked tick
    for kname, r in delay_k.items():
        kernels.append(dict(
            name=kname, route="cuda",
            source="go_libp2p_pubsub_tpu_torch/csrc/receive_delays.cu",
            replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
            launches=(main_delay_launches
                      if r["variant"] == pipelined.VARIANT
                      else r["launches"])
            + parity_launches.get(r["variant"], 0),
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=None))
    for kname, r in fused_tel.items():
        kernels.append(dict(
            name=kname, route="cuda",
            source="go_libp2p_pubsub_tpu_torch/csrc/fused.cu",
            replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:1662",
            launches=r["launches"], max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=None))
    # the replica axis: B3 on the batched flagship (its launches) timed
    # at 4 x 1M, C = 16; B1's families on a real batched flagship tick,
    # the flagship's launches from its run, the others' from theirs (5z)
    sb_ = sel_b[f"4x{n}_c16"]
    kernels.append(dict(
        name="select_k_bits_batched", route="cuda",
        source="go_libp2p_pubsub_tpu_torch/csrc/select.cu",
        replaces="go_libp2p_pubsub_tpu/ops/pallas/select.py:39",
        launches=int(round(bf["launches_per_batched_tick"]["select"]
                           * batched_flagship.TIMED
                           * batched_flagship.BLOCKS)) + sw["select"]
        + sv_ph["load"]["select"] + sv_ph["overload"]["select"]
        + fw_ph["front_end"]["select"] + met_ph["spans"]["select"],
        max_abs_err=max(r["max_abs_err"] for r in sel_b.values()),
        ms=sb_["ms"], plain_ms=sb_["plain_ms"], bound_ms=sb_["bound"][0],
        bound_by=sb_["bound"][1], library_ms=None))
    for label, r in b1_b.items():
        launches_b = (int(round(bf["launches_per_batched_tick"]["scored"]
                                * batched_flagship.TIMED
                                * batched_flagship.BLOCKS))
                      if label == "scored"
                      else b_paths.get(r["variant"], {}).get("receive", 0))
        kernels.append(dict(
            name=f"receive_update_{label}_batched",
            route="cuda",
            source=("go_libp2p_pubsub_tpu_torch/csrc/receive_knobs.cu"
                    if label == "knobs"
                    else "go_libp2p_pubsub_tpu_torch/csrc/receive.cu"),
            replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
            launches=launches_b, max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=None))
    # the delay-mode and telemetry stack kernels: the main path's (the
    # delayed knob stack of the flagship's options) the batched pipelined
    # runs' launches, the others their stack path's (5ab-5ae)
    main_delay_b = sum(r_["launches"].get(pipelined.VARIANT, 0)
                       for r_ in main_pipe_b.values())
    for label, r in {**delay_b, **tel_b}.items():
        kernels.append(dict(
            name=label, route="cuda",
            source=f"go_libp2p_pubsub_tpu_torch/csrc/{r['library']}.cu",
            replaces="go_libp2p_pubsub_tpu/ops/pallas/receive.py:293",
            launches=(main_delay_b if r["variant"] == pipelined.VARIANT
                      and "_delays" in label
                      else s_paths[label]["receive"]),
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=None))
    print(json.dumps({"main_path": {
        "flagship": main_flagship, "adversarial": main_adversarial,
        "everything": main_everything, "everything_paired": main_paired,
        "churn": main_churn, "resident": paths, "card": smi,
        "faulted_receive": {
            kname: {key: v for key, v in r.items() if key != "bound"}
            for kname, r in faulted.items()},
        "resident_cold_restart": dict(
            digest=d_fc, rejoins=rejoins, launches=counts_fc,
            fault_rows_ms=rows_ms, mean_mesh_degree=deg_fc),
        "telemetry": dict(tel_main, peak_bytes=peak_t, start_bytes=alloc0_t),
        "telemetry_receive": {
            kname: {key: v for key, v in r.items() if key != "bound"}
            for kname, r in dict(
                tel_k, receive_update_tel_main_path=tel_main_k).items()},
        "telemetry_fused": {
            kname: {key: v for key, v in r.items() if key != "bound"}
            for kname, r in fused_tel.items()},
        "knob_sweep": main_knobs,
        "pipelined": {str(n_p): r_ for n_p, r_ in main_pipe.items()},
        "pipelined_batched": {str(n_p): r_
                              for n_p, r_ in main_pipe_b.items()},
        "pipelined_cross_check": cross,
        "stack_receive": {
            kname: {key: v for key, v in r.items() if key != "bound"}
            for kname, r in {**delay_b, **tel_b}.items()},
        "stack_paths": s_paths,
        "pipelined_identity": ident,
        "pipelined_steady_state": steady,
        "invariants": dict(inv_main, peak_bytes=peak_i, start_bytes=alloc0_i,
                           kernels=inv_k),
        "invariants_armed_families": armed,
        "loops": loops_main,
        "loops_c32": dict(n_peers=WIDE_PEERS, ticks=WIDE_TICKS,
                          digests=digests, launches=wide_launches,
                          mean_mesh_degree=wide_deg),
        "tournament": tourney_main,
        "batched_flagship": bf,
        "batched_select": {key: {k_: v for k_, v in r.items()
                                 if k_ != "bound"}
                           for key, r in sel_b.items()},
        "batched_receive": {key: {k_: v for k_, v in r.items()
                                  if k_ != "bound"}
                            for key, r in b1_b.items()},
        "batched_paths": b_paths,
        "tune_defense": tuned,
        "meshless": meshless,
        "trace_export": trace_main,
        "sweepd": {key: v for key, v in sw.items()
                   if key not in ("rows", "seed_rows")},
        "sweepd_kernel": swk,
        "checkpoint": dict(ck_art, launches=ck_launch),
        "checkpoint_fused": dict(killed_at=killed_at, digest=d_resumed,
                                 launches=b2_fused),
        "sweepd_restart": restart,
        "serving": {k_: v for k_, v in serve.items() if k_ != "cold_rows"},
        "serving_full_width": fw,
        "metrics": dict(met, phases=met_ph, servestat_rc=rc_serve,
                        obsstat_rc=rc_obs),
        "delay_receive": {
            kname: {key: v for key, v in r.items() if key != "bound"}
            for kname, r in delay_k.items()},
        "knob_receive": {
            kname: {key: v for key, v in r.items() if key != "bound"}
            for kname, r in knob_k.items()},
        "eager_ms": {"receive": rcv_eager_ms, "select": sel_eager_ms},
        "full_receive_ms": {"main_path": full_ms, "all_options": full_all_ms,
                            "exact_k_alone": xk_ms},
        "seconds": time.perf_counter() - t_start}}))
    print("parent_ms (copied from PERF.md, before each kernel's redesign; "
          "not measured by this run): " + json.dumps(
              {kd["name"]: PARENT_MS.get(kd["name"]) for kd in kernels}))
    print(json.dumps({"kernels": kernels}))
    # -- 11. the result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
