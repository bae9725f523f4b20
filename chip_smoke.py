#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``pivot_tpu_torch``).

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --phases 6,7 # some phases (default: all)
    python3 chip_smoke.py --phases 8   # the policy search alone
    python3 chip_smoke.py --phases 9   # congestion, checkpoints, calibrate
    python3 chip_smoke.py --phases 10  # serving and the per-row launch
    python3 chip_smoke.py --phases 11  # cross-run batching of spans
    python3 chip_smoke.py --phases 12  # serve --mpc and the recovery plane
    python3 chip_smoke.py --phases 13  # native fabric, degrade guard,
                                       # dispatch profiler, --profile-dir
    python3 chip_smoke.py --phases 14  # graftcheck, kernel budget, cost
                                       # attribution, compile check, worker
    python3 chip_smoke.py --phases 15  # host sharding (ops/shard.py)
    python3 chip_smoke.py --phases 16  # the replica axis: sharded
                                       # ensemble, sweeps, search and the
                                       # batcher's replica mesh
    python3 chip_smoke.py --phases 17  # the 2-D serving mesh: batched
                                       # twins, 2-D serve, sharded resident
    python3 chip_smoke.py --phases 18  # elastic meshes: mid-run reshard,
                                       # the serving soak, the shadow probe
    python3 chip_smoke.py --phases 19  # the carry-free kernel against its
                                       # plain form, timed
    python3 chip_smoke.py --phases 3,19 --cf-sweep
                                       # + its launch-shape sweep
    python3 chip_smoke.py --phases 6,20 # the ensemble's chain kernel on
                                       # the main path, then alone

One card.  ``--phases`` takes a comma list; phases 2-5, 10-17, 19 and
20 bring phase 1's build along, phase 5 the runs of phases 3 and 4, phase 13
phase 3's run (its python-fabric arms are what the native fabric is held
against).

Phases, each fatal on failure:

  1. environment: the card (``nvidia-smi`` name and power limit), torch,
     CUDA and nvcc versions, the build of every hand-written kernel, and
     ``nvcc -Xptxas -v``'s registers, shared memory and spills for each
     build of ``greedy_place`` (registers by K, one CTA's shared memory,
     a cluster CTA's, the global form; a line naming the builds that
     spill) and ``carry_free_place``; the wrappers'
     launch-shape tables must match the libraries', and
     ``greedy_place``'s straight-line square root and division must equal
     the IEEE intrinsics bit for bit on 2^27 hashed operand pairs each;
  2. ``greedy_place`` against its plain torch version on the card, float32:
     the five cost-aware modes over six (T, H) shapes, the edge cases
     (T = 0, nothing fits, invalid tasks, a ``live`` mask, a ``risk``
     row) and the replica-batched launch at R = 5 and R = 256, each on
     sparse inputs (few tasks fit) and dense ones (most place, with a
     floor on the placements made); the selection edge cases of
     ``tests/test_torch_greedy.py`` (score ties across warp boundaries,
     H = 1 / 33 / 100, ±0.0 risks, +inf and NaN scores) at several warp
     counts; every launch shape the phase-4 sweep times; the
     shared-memory-state build at H = 9664; past one CTA the CTA edge
     cases of ``tests/test_torch_greedy.py`` (ties across every CTA
     boundary, the winners in the last CTA, the first CTA all masked,
     ±0.0 and NaN risk) in every mode at the least H of each cluster
     size C = 2, 4, 8, 16 (H = 10,241, 20,481, 40,961, 98,304) and one
     host past the cluster form (163,841, the global form), and the
     replica-batched (R = 3) and per-row (G = 2) launches of a cluster
     and of the global form.  Placements must be equal;
     availability within rtol 1e-6 / atol 1e-5;
  3. end to end: the ``overall`` experiment (Opportunistic, VBP,
     Cost-Aware) at 600 hosts x 100 apps through the port's CLI entry
     point, on ``--device cuda --no-adaptive`` with fused spans (the
     default), again with fusion off, and on ``--device numpy``.  The
     Opportunistic and VBP arms on cuda serve every device tick and span
     tick with one launch of ``carry_free_place`` (launches = kernel
     ticks + span kernel ticks per arm, printed), each launch recorded
     and held against its plain form after the run, and their files with
     fusion on and off must be byte-identical.  Every
     span of the fused run executes under
     ``torch.cuda.set_sync_debug_mode("error")`` (a host read inside a
     span raises) between CUDA events that time it.  Every Cost-Aware
     tick must be a kernel launch — launches = per-tick kernel ticks +
     span kernel ticks, with span ticks present — the arms' egress-cost
     and runtime rankings must agree with numpy's, and the script says
     whether fusion on and off write byte-identical files (if not, the
     first differing task and whether float32 ties of the demand norms
     can explain it).  A second Cost-Aware run shadows every kernel call,
     per-tick and in spans, with the plain version (identical placements
     required), holds every span against ``reference_tick_run`` on the
     same float32 operands with the plain version serving its ticks, and
     checks ``placement_sensitivity`` (R = 256) against the plain batched
     version at each new largest tick;
  4. sensitivity on the card: the ``sensitivity`` experiment through the
     port's CLI at 600 hosts, R = 256, under a spot market drawn by
     ``MarketSchedule.generate`` from the port's own cluster metadata —
     the Cost-Aware arm (300 apps: every gated tick must be one R = 256
     launch of ``greedy_place``, each held after the run against
     ``cost_aware_plain_batched`` on its own f32 operands) and the VBP
     arm (100 apps: every gated tick one R = 256 launch of
     ``carry_free_place``, its largest tick's first rows held against
     the unbatched torch pass, and every launch of the arm's runs held
     against its plain form after the run); each baseline's
     four metrics within 0.5% of a numpy run of the same seed and
     market; the gate's telemetry, paired walls and a host-clock split
     of a gated tick (noise draw, staging, pass, fetch + unpad);
  5. times on the card by CUDA events: the wrapper the main path calls
     per tick (median over the run's ticks, and at T = 619 / 2048,
     H = 600), the R = 256 launch, the plain version, and the roofline
     bound; beside each wrapper time the bare launch (``kernel_ms``,
     ``_launch`` on checked operands) and its ns per task step; ns per
     step with one group entry, an entry at every task and best-fit, and
     the share of the main path's tasks that are group entries; the
     sweep of warps per replica at H = 600 that sets ``_launch_config``;
     and, where ``torch.profiler`` sees the card, one device kernel per
     wrapper call; and wrapper / bare-launch times of every gated
     R = 256 launch of phase 4;
  6. the Monte-Carlo ensemble on the card, each tick's placement chain
     one launch of ``ensemble_chain`` (``greedy_place`` must make no
     launch): the refund's sum order on the trace's demands
     against the CPU; at R = 16 the cost-aware and first-fit arms against
     ``pivot_tpu``'s own CPU rollout (``tests/data/ensemble_r16_seed0.npz``)
     under torch's sync debug mode, every ``ensemble_chain`` launch held
     right after it against ``_chain_plain`` on the same operands
     (placements, delays and availability bit for bit; the sync debug
     mode off around the hold), one launch a tick; the ``ensemble`` CLI
     at 600 hosts x 50 apps, R = 1024, both arms, one R = 1024 launch a
     tick — wall, replica rollouts/s, ticks,
     placement steps, host reads, CUDA-event ms of the tick loop, peak
     memory, its first 16 replicas equal to the R = 16 run; a
     ``torch.profiler`` window of ticks 100-125 per arm; the cost-aware
     run's first 2 replicas against the port on the CPU; best-fit,
     opportunistic and lifo at 10 apps, card against CPU.  Placements,
     finish times, makespans, instance-hours and unfinished counts must
     be equal, egress within rtol 1e-5;
  7. fault ensembles and the what-if sweeps on the card (the chains on
     ``ensemble_chain``, launched in this process at least once;
     ``greedy_place`` must make no launch): (a) every entry of
     ``pivot_tpu``'s fixture ``tests/data/ensemble_sweeps_seed0.npz`` —
     fault rollouts at 50 apps, R = 16; ``score_param_sweep``,
     ``capacity_sweep`` with faults and ``workload_sweep`` (three arms)
     at 10 apps, R = 4 — under torch's sync debug mode; (b) the
     README's commands at 600 hosts through the CLI: ``autotune
     --replicas 4`` (27 candidates × 4 replicas, cut from its default
     32), ``ensemble --replicas 64 --faults 4 --fault-mttr 300``
     (cost-aware, first-fit; replicas cut from 256), ``capacity
     --host-counts 100 200 400 600 --faults 4 --fault-mttr 300`` (both
     at 25 apps, cut from 50) and
     ``apps --app-counts 10 15`` (cut from 100 500 1000) —
     wall, rollouts/s, ticks, placement steps, host reads, CUDA-event
     ms, peak memory and the summary's best; with phase 6, autotune's
     (1, 1, 1) candidate against phase 6's first 4 replicas; (c) the
     card against the port on the CPU at 10 apps: best-fit, lifo, and
     the search stack's channels (score exponents, a
     ``MarketSchedule.generate`` market's risk term, faults, an active
     mask) per arm, and the float32 pow twin on 2**24 pairs.  The same
     rule as phase 6;
  8. the policy search on the card (the chains on ``ensemble_chain``,
     launched at least once; ``greedy_place`` must make no launch): (a)
     every entry of ``pivot_tpu``'s fixture
     ``tests/data/search_seed0.npz`` — ``_fitness_rows``' per-row egress,
     instance-hours, unfinished counts and makespans and the scores of
     six candidates in the tiny and the README worlds (shared and
     redrawn preemption plans, no hazard trace, capacity scales with
     admission masks) and a two-generation anchored CEM's populations,
     scores and argmins — under torch's sync debug mode; (b) ``search``
     through the CLI: the README quickstart (CEM, 96 rows a generation,
     with the DES validation), the same world with ES (88 rows), the
     committed ``data/search/ci_seed.json`` twice (the reports must be
     equal) and the 10,240-row population (64 candidates x 160
     replicas) at 600 hosts x 50 apps, 1 generation, horizon 300 s
     (cut from 2400) — wall,
     generations/s, rollouts/s, the slowest generation's ticks,
     placement steps and host reads, CUDA-event ms, peak memory, the
     best against the initial score and the oracle's regrets — and two
     of the population's candidates run alone on the card at its key
     (their rows must be the population's); (c) at
     600 hosts x 50 apps, 2 candidates x R = 16 on the card against the
     port on the CPU, and the float32 pow twin on 2**24 pairs with
     exponents in [0, 3] (bases from the tables and at the edges of
     float32's range).  Unfinished counts, makespans and instance-hours
     equal, egress and scores within rtol 1e-5;
  9. the congestion backlog model, realtime scoring, checkpoints and
     ``calibrate`` on the card (the chains on ``ensemble_chain``, launched
     at least once; ``greedy_place`` must make no launch): (a)
     ``calibrate --num-apps 50`` and ``... --realtime`` through the CLI
     at its defaults (600 hosts, cost-aware, R = 1,
     perturb 0, lifo, float32), each report equal to ``pivot_tpu``'s
     (``tests/data/calibrate_seed0.json``; egress within rtol 1e-5) —
     wall, and each mode's rollout ticks, placement steps and host
     reads; (b) the README's ``ensemble --policy opportunistic
     --congestion`` with ``--checkpoint`` at R = 32 (cut from 1024;
     50 apps, 600 hosts), its first 16 replicas equal to
     ``pivot_tpu``'s R = 16 run
     (``tests/data/ensemble_congestion_seed0.npz``) — wall, rollouts/s,
     ticks, placement steps, host reads, CUDA-event ms, peak memory;
     (c) at 10 apps, R = 4: a checkpointed run killed after its first
     segment and resumed from the file equals the uninterrupted run bit
     for bit, and first-fit and best-fit with congestion, host-pair pipes
     and realtime scoring with faults equal the port on the CPU.  The
     same rule as phase 6.  The card sides of 6 (d), 7 (a) and (c) and
     9 (c) time nothing: the first of phases 6, 7 and 9 runs them in a
     pool of spawned processes beside the main process (the loops are
     bound by the host's issue of small launches), and waits for them
     before it times anything;
 10. serving on the card: the per-row launch of ``greedy_place`` against
     ``cost_aware_plain_rows`` (every mode over five (G, T, H) shapes
     up to 16 rows x 600 hosts, sparse and dense, per-row step bounds,
     live masks and risk rows, T = 0); then the README's serve commands
     through ``cli.main`` on cuda at 600 hosts a session, seed 0, each
     with the launch counts zeroed just before and read just after:
     (a) ``serve --sessions 4 --jobs 200 --arrival-rate 0.5`` (Cost-
     Aware) — every arrival counted and every admitted job completed
     (replay mode sheds past the queue depth of 64, as ``pivot_tpu``'s
     run does), flushes coalesced, each coalesced Cost-Aware group ONE
     per-row launch and every other Cost-Aware tick one R = 1 launch,
     every per-row launch held against ``cost_aware_plain_rows`` on its
     own f32 operands, and each session's per-tick placements and
     summary equal to a batch-mode ``ExperimentRun`` on cuda of the jobs
     it served; (b) ``--source trace --queue-depth 32 --backpressure
     shed`` and ``--policy first-fit --closed-loop 8 --jobs 100`` (no
     ``greedy_place`` launch), counters consistent and audited; (c) the
     multi-tenant command (tiers, preemption, least-loaded routing,
     autoscaling 1:8), tier 0 never shed or preempted, ``audit()``
     clean.  Each run prints wall, decisions/s, p50 / p99 decision
     latency overall and per tier, the batcher's stats and the launches
     by G and R; (a) and (b)'s trace run time the largest per-row launch
     (wrapper and bare launch by CUDA events, the plain version, the
     bound);
 11. cross-run batching on the card: (a) synthetic mixed-horizon
     Cost-Aware span groups at 600 hosts (G = 2, 3, 4; horizons up to 32;
     with and without a market's risk rows, cost stack and live mask),
     each dispatched by G client threads through a ragged
     ``DispatchBatcher``: one merge, the batched span driver under
     ``torch.cuda.set_sync_debug_mode("error")``, each span tick ONE
     per-row launch of ``greedy_place`` held against
     ``cost_aware_plain_rows``, each trimmed result equal to its solo
     span (R = 1 launches); (d) a chain of four resident Cost-Aware spans
     with edit rows against the re-staged spans; (b) ``overall
     --batch-runs 4`` over 4 traces at 600 hosts against the sequential
     cuda grid — files byte-identical — with its per-row launches, span
     flushes, ragged merges and walls; (c) the serve span commands
     (``serve --sessions 3 --jobs 300 --arrival-rate 25 --fuse-spans
     slo``, the same with ``--no-ragged``, and with ``--resident
     --splice-tier 1``) through ``cli.main``: sessions equal batch mode on
     the jobs they injected, ``audit()`` clean, every per-row launch held
     against the plain version, the ragged arm merging and the resident
     arm running spans with edit rows; p50 / p99 per tier, fused spans,
     merges, pad cells, resident spans, edit rows, splices and the
     launches by route;
 12. model-predictive serving and the recovery plane on the card (the
     serving threads, the MPC's planner and tuner threads and the
     snapshot worker share the card; torch's sync debug mode stays
     off): (a) the README's MPC command (``serve --sessions 1 --jobs 300
     --arrival-rate 2.5 --queue-depth 16 --tier-mix 0.4,0.3,0.3
     --tier-policies spill,shed,shed --preempt --mpc --mpc-pool 1:4``)
     through ``cli.main`` at 600 hosts, again with ``--mpc-dry-run``, and
     without ``--mpc``: at least one plan, never referee-disabled, the
     forecaster seeing every arrival, no graph captured after the
     controller's warm-up (a float32 rollout on the card takes its
     snapshots inside ``ensemble_chain``: none is captured, so this reads
     0 by construction), the planner's rollouts on ``ensemble_chain``
     (launched at least once), TF32 turned off by the entry, tier 0 never
     shed, ``audit()`` clean, and the dry run serving the MPC-off
     outcome; (b) a paced soak through the library: one session of 600
     hosts growing to 4, Cost-Aware on the card, the controller at
     ``MpcConfig``'s defaults with the tuner on and a referee every 4th
     window, a mixed-tier stream paced (from one timed window) so that
     at least 8 windows are planned — every referee check passing, the
     controller never disabled, no graph captured after its warm-up,
     tier 0 lossless, ``audit()`` clean; it prints the windows, the
     planner's ms a window (CUDA events around ``plan``), the rollout
     ticks, steps and host reads a window, the referee checks, the
     actions by kind, the tuner's rounds and the rollout's stage events;
     (c) phase 11 (c)'s resident run (3 sessions, ``--fuse-spans slo
     --resident --splice-tier 1``, one far-future straggler appended)
     through the library: ``recovery=None`` and the armed plane
     (``snapshot_every=2``) decide alike, a run killed after its first
     snapshot and resumed (``resume=True``, its journal tail torn)
     decides as the uninterrupted run, and the resumed session that
     re-reaches the snapshot's span and splice counts holds a carry equal
     to it (fingerprint and arrays); it prints the journal records, the snapshots, the
     clone's ms on the dispatch thread and the bytes copied off the card;
     (d) the watchdog armed (``dispatch_timeout_s=2``): one resident
     dispatch wedged past the timeout is abandoned and retried, and the
     run decides as the no-fault run.  Every ``greedy_place`` launch of
     every run is held against ``cost_aware_plain`` /
     ``cost_aware_plain_rows`` (the batcher's one-request calls, the
     coalesced per-row launches and the resident tier's calls);
 13. the native network fabric, the degrade guard, the sampled dispatch
     profiler and ``--profile-dir`` on the card, at the CLI default
     cluster (600 hosts, seed 0): (a) ``overall --network native`` on
     cuda with fused spans, the three arms at phase 3's depth on its
     trace, against phase 3's python-fabric cuda run — ``sim_time``
     within rel 1e-12, ``avg_runtime``, ``egress_cost`` and
     ``avg_congestion_delay`` within rel 1e-9
     (``tests/test_native.py``'s tolerances), whether each arm's
     ``general.json`` is byte-equal, and each arm's wall and host ms per
     tick on each fabric (the run's wall less the host-clock time inside
     the policy's device calls, over the ticks that reached the policy);
     (b) the degrade guard refused on the card: every device policy
     built on ``cuda`` raises ``NotImplementedError`` for
     ``degrade_after=2``, at construction and through the setter, and a
     Cost-Aware and a First-Fit run (600 hosts, phase 3's trace,
     per-tick dispatch) whose kernel entry point (``_greedy``,
     ``first_fit_cuda``) raises on call ``P13_FAULT_AT`` end with that
     error, no tick served by the numpy
     twin, the ticks before it equal to the run with no faults; (c)
     phase 10's README serve command with ``--profile-dispatch 4`` and
     without: decisions equal, the census listing each family's calls,
     samples, median wall and median measured/predicted ratio, the
     sampled call numbers equal to ``sampled_indices``, beside the
     phase's own CUDA-event ``kernel_ms`` of the same launches; (d) the
     README's ``--network native --profile-dir DIR overall``, three arms
     at 8 apps (three profiler sessions one after another, late in this
     process: a trace's first kernel records go missing, the more the
     older the process, unless ``device_profile``'s synchronised warm-up
     opens the window): every trace holds a kernel record for each
     kernel launch after the warm-up, and the Cost-Aware trace the
     ``greedy_place`` kernel by name, as many as the run's launches.
     Every ``greedy_place`` launch of the phase is held against its
     plain version;
 14. the tooling that reads the port: (a) ``python -m
     pivot_tpu_torch.analysis --json`` over the checkout is clean; (b)
     the ``kernel-budget`` pass against the card — the static
     shared-memory bytes of every launch shape the script computed
     (recorded on ``cuda_kernels._launch_config``'s cache misses, never
     on the launch path) equal ``_launch_config``'s
     and fit the card's opt-in shared memory per block, and phase 1's
     ``ptxas`` registers x each instantiation's thread limit fit the
     65,536-register file (spills printed); (c)
     ``cost_attribution(device="cuda")`` is complete, with each torch
     row's dispatched ops, bytes, CUDA-event ``device_ms`` and model
     ratios and ``greedy_place``'s rows at R = 1, R = 4 and per-row
     G = 2; (d) ``--compile-check full``: after warming the span path,
     the serve dispatch path and one ensemble snapshot shape, a steady
     window counts 0 kernel builds and 0 graph captures, and a new
     snapshot shape exactly 1 capture; (e) the ``worker`` subcommand in
     this process, stdin swapped: the README's three-arm ``overall`` at
     8 apps twice, a malformed line, ``quit`` — both requests'
     ``general.json`` byte-equal to a one-shot run of the same argv in a
     fresh process (``P14OneShot``: started after phase 1's build, run
     beside phase 2, which times nothing, and ended before phase 3, so
     no time of the script is taken beside it), the malformed line
     answered ``ok: false``, the figures named as skipped where
     matplotlib is absent.
     Every ``greedy_place`` launch of the phase, (c)'s timed calls too,
     is held against its plain version;
 15. host sharding on the card (``ops/shard.py``; the sharded path
     launches no ``greedy_place``): (a) at the reference's pod scale
     (H = 98,304 hosts, T = 256 ready tasks, ``bench.py``'s
     ``_SHARD_H0`` / ``_SHARD_T``), f32, the four arms through the
     sharded passes on meshes of S = 1 and 4 logical shards of the card,
     per-step and chunk (C = 8), each placement and availability bit for
     bit the unsharded torch form's, every call timed by CUDA events
     beside the unsharded per-step and chunk forms; then ``greedy_place``
     at that tick (a cluster of 16 CTAs a replica) at R = 1, R = 4
     replicas and G = 2 rows (each its own tick and step bound), held
     against the Cost-Aware pass unsharded and at S = 1 and 4 (replica
     by replica, row by row; placements equal, availability within the
     tolerance) and against its plain form, and timed — wrapper and bare
     launch by CUDA events, the plain form by host clock — beside the
     bound and the torch pass's times; (b) ``overall``'s VBP and
     Cost-Aware arms at 600 hosts x 30 apps through ``ExperimentRun``
     with ``enable_sharding`` over 4 logical shards, each ``general.json``
     byte-equal to the unsharded run's (Cost-Aware with
     ``use_kernel=False``; VBP unsharded on ``carry_free_place``, sharded
     on the torch passes), spans engaged, no ``greedy_place`` launch
     (counts zeroed just before each run and read just after); (c)
     ``overall``'s Cost-Aware arm on cuda at 20,480 hosts x 10 apps
     through ``ExperimentRun``, unsharded: every tick and span tick one
     ``greedy_place`` launch in its cluster form (2 CTAs of 10,240 hosts;
     launches = kernel ticks + span kernel ticks, none on the torch
     pass), each held against its plain form after the run, and
     ``general.json`` byte-equal to the ``use_kernel=False`` run's.
 16. the replica axis on the card (``parallel/mesh.py::replica_mesh``
     naming the card S times: S logical replica shards): (a)
     ``sharded_rollout`` over 4 shards at the ``ensemble`` defaults
     (600 hosts x 50 apps, cost-aware) at R = 256 (cut from 1024 for
     phase 17), every field bit-equal to the unsharded rollout, the tick
     loop's wall of each; (b) the same over R = 64 with ``--faults 4
     --fault-mttr 300`` at 25 apps (phase 7 (b)'s command) against the
     unsharded ``rollout`` (the contracted fault draw); (c) ``search
     --backend sharded_rollout`` on the README quickstart through the
     CLI, its report equal to phase 8's ``rollout`` backend's, and
     ``evaluate_rows(backend="sharded_rollout")`` over 4 shards on phase
     8's 10,240-row population, scores bit-equal; (d) phase 7 (b)'s
     ``capacity`` command with its sweep ``shard_sweep(capacity_sweep,
     force_mesh=True)`` over 4 shards, the summary equal to phase 7's;
     (e) ``overall --batch-runs 4`` on the first 2 of phase 11 (b)'s 4
     traces (cut for phase 17) with each lock-step grid's batcher on
     ``replica_mesh(devices=[cuda:0] * 2)``: files byte-equal to phase
     11's meshless grid on those traces, flushes on the mesh
     and the fallbacks counted by cause, every per-row ``greedy_place``
     launch held against ``cost_aware_plain_rows`` (counts zeroed just
     before the run and read just after).  (a)-(d) launch no
     ``greedy_place``; (a)'s unsharded referent, (b) and (d) run in the
     card pool of phases 6-9 when one of phases 6, 7 and 9 runs, and a
     referent of a phase not run is run here;
 17. the 2-D serving mesh on the card (``build_hybrid_mesh`` over
     logical shards: ``replica × host``): (a) the four ``[G]``-batched
     host-sharded twins at phase 15's pod scale, G = 2 rows on a (1, 2,
     4) mesh, per-step and Cost-Aware at C = 8, each row bit-equal to
     the unsharded torch form on it, ms a call by CUDA events; and one
     ``sharded_batched_tick_run`` of 3 Cost-Aware spans of different
     horizons at 600 hosts (market operands, a live mask) padded to one
     bucket, each row equal to its solo ``sharded_fused_tick_run``; (b)
     the README's 2-D ``serve`` command at 600 hosts a session through
     the CLI, ``--shard-hosts 2`` over a (1, 2, 2) mesh of logical
     shards: every session host-sharded, flushes on the mesh, the
     fallback causes adding up, ``report["mesh"]``, no ``greedy_place``
     launch, each session equal to the unsharded per-tick run of the
     jobs it injected (placements and meters), latency per tier; (c)
     the same command with the sessions unsharded and the driver's
     batcher on a (1, 4, 2) mesh: every per-row and R = 1
     ``greedy_place`` launch held against its plain version, every
     fallback ``unshardable``; (d) the README's resident command with
     the sessions host-sharded over 2 shards: spans on the sharded
     carries, edit rows, splices, each session equal to the unsharded
     per-tick run of its jobs, 0 kernel builds and graph captures; (e)
     ``serve --shard-hosts 1`` through ``python -m
     pivot_tpu_torch.experiments.cli`` in a process of its own, beside
     phase 2, to its end.
 18. elastic meshes on the card (``serve/elastic.py``, ``reshard``; S
     logical shards of the card, f32, 600 hosts; the elastic path runs
     the sharded torch passes and launches no ``greedy_place``): (a)
     DES runs of ``tests/test_elastic.py``'s app chain (``P18_APPS``
     apps), First-Fit and Cost-Aware, resident tier on, resharded at
     t = 12 — 8 shards shrunk to 4, 4 regrown to 8, unsharded to 7 (the
     padded extent 602) — each equal to the unsharded run on the card in
     placements and end times, no placement naming a pad row; (b) the
     reference's serving soak (``tests/test_elastic.py::_elastic_soak``:
     mixed tiers at rate 20, 18 jobs and a straggler at t = 10,000, a
     host preemption, a market, resident, splice tier 2, 4 restarts) on
     Cost-Aware sessions sharded over 8 shards with shard 3 failing at
     t = 6 for 200 s: the reference's assertions, decisions/s, latency
     per tier, the recovery latency (wall ms from the ``DeviceLostError``
     to the first dispatch the shrunk mesh serves, and to its end) and the
     manager's ``describe()``; its healthy arm (an empty plan) equal in
     placements to ``elastic=None`` on unsharded sessions, with 0 kernel
     builds and graph captures once warm; (c) the shadow probe True on
     the 8, 4, 2 and 1 rungs at 600 hosts, and False, holding the shard
     out, when the candidate's run raises.  Unsharded referees run the
     torch form (``use_kernel=False``).
 19. ``carry_free_place`` on the card, float32: each arm against its plain
     form at H = 600 for T in {1, 12, 379, 619, 2048}, with and without a
     risk row and a ``live`` mask, and the no-fit and interspersed-invalid
     cases; at T = 12 and 619 the NaN / ±inf / ±0 risk, exact-tie and
     zero-demand cases; at H = 4,200 in one warp of the single-CTA
     cluster form, so that a thread owns more rows than its member bits
     cover; the R = 256 First-Fit and Best-Fit forms at T = 619; each arm
     at phase 15's pod tick (H = 98,304, T = 256, a cluster of 16 CTAs)
     without risk, with risk, and with risk and a ``live`` mask; then the
     launch shapes: every register build at its capacity with its most
     warps, the default shapes on each side of the arms' K switches and
     of the register form's end (H = 1,536-4,097), the cluster sizes the
     rule does not pick (C = 1, 2, 4 at H = 4,097) and C = 16 where it
     first does (8,193), ties across two CTAs' ranges and an
     opportunistic rank in the last CTA (``cta_edge`` at H = 8,192 and
     the pod tick), and the global-rows form once (one host past the
     cluster form's capacity, T = 12).  Placements equal, availability
     within rtol 1e-6 / atol 1e-5 (max |diff| printed, 0.0 expected: the
     same operations in the same order); then ``kernel_ms`` (CUDA events
     around the bare launch), the wrapper's ms, the plain form's ms (host
     clock around a synchronised call), ns per step and the bound (the
     operations this run's data needs, read from the plain form's
     placements) at T = 619 / 2048, the R = 256 forms, the pod tick and,
     with phase 3, the largest Opportunistic and VBP ticks of its run.
     ``--cf-sweep`` adds the sweeps of launch shapes that set
     ``_cf_config`` (register K at H = 600; K by groups a block at R =
     256; warps a CTA at the pod tick for C = 8 and 16; C by W at H =
     4,097 and 20,000), each swept launch held against plain.
 20. ``ensemble_chain`` on the card, float32, against
     ``parallel/ensemble/tick.py::_chain_plain`` on the same operands
     (placements, delays and availability bit for bit, max |diff| 0.0):
     each arm with and without a risk row at H = 600, R = 8 (n_ready
     from 0 to T); H = 1, 33 and 100; score ties across warp boundaries;
     down hosts (−1); ±0, ±inf and NaN risk; cost-aware with zero
     bandwidths and costs (inf and NaN scores), with score exponents over
     zero and tiny norms (powf's special cases), with realtime tables;
     opportunistic uniforms with u_eff just below 1; one host past the
     shared-memory form (the global form); then two real R = 1024 ticks
     of each arm (600 hosts x 50 apps, the tick with the longest replica
     chain of ticks 100-125 of ``_rollout_segment``, and that of ticks
     0-100, the rollout's opening burst), held against the plain chain
     and timed: ``kernel_ms`` (CUDA events around the bare
     launch), the wrapper's ms, the plain chain's ms (host clock around
     a synchronised call), ns a step of the longest replica chain and
     the bound (``chain_bound``: this run's data's bytes and
     operations).

The CPU sides of the card-vs-CPU checks of phases 6 (b) and (d), 7 (c),
8 (c) and 9 (c) run in one spawned worker process a phase
(``cpu_side``), on two cores of the host's eight that the main process
leaves while the phase runs: the card's host loop and the phase's timed
windows keep the other six to themselves.

Every phase asserts, at its end, that every device policy it built runs
with the degrade guard off (``degrade_after is None``) and recorded no
kernel failure: no failure is served by the numpy twin unseen.

Each phase logs its wall.  The line before the last is a JSON
``kernels`` record: ``carry_free_place`` with the launches of phases 3
and 4 (split by arm and R) and phase 19's times, ``ensemble_chain``
with the launches of phases 6 (a) (R = 1024, one a tick), 7, 8, 9 and
12 (the main process's) and phase 20's times, and ``greedy_place``
(its ``launches`` split into the R = 1 launches of
phases 3, 4, 10-14, 15 (c), 16 and 17, the R = 256 launches of phase 4,
the R = 4 launches of phase 14 and the per-row launches of phases 10-14,
16 and 17, with the per-row form's times and phase 15 (a)'s pod-tick
times; phase 15's sharded path launches none, (a)'s comparison
launches apart, and phase 18's none at all; a number of a phase not run
is null); the
last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from pivot_tpu_torch.infra.roofline import PEAK_BYTES, PEAK_F32_OPS

RTOL, ATOL = 1e-6, 1e-5  # tests/test_pallas.py's tolerance
Z = 31
MODES = [
    dict(bin_pack="first-fit", sort_hosts=True, host_decay=False),
    dict(bin_pack="first-fit", sort_hosts=True, host_decay=True),
    dict(bin_pack="first-fit", sort_hosts=False, host_decay=False),
    dict(bin_pack="best-fit", sort_hosts=True, host_decay=False),
    dict(bin_pack="best-fit", sort_hosts=True, host_decay=True),
]
SHAPES = [(37, 13), (300, 50), (5, 200), (700, 40), (619, 600), (2048, 600)]
TRACE = "data/jobs/jobs-5000-200-86400-172800.npz"
ARMS = ("Opportunistic", "VBP", "Cost-Aware")


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def ptxas_usage_start(build, tmp):
    """Start ``nvcc -Xptxas -v`` on ``greedy_place.cu`` (a cubin of the
    build's own flags) and return the process."""
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = os.path.join("pivot_tpu_torch", "csrc", "greedy_place.cu")
    return subprocess.Popen(
        [build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", src, "-o",
         os.path.join(tmp, "greedy_place.cubin")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


#: ``greedy_place``'s builds as ``ptxas`` names them: ``(kSmem,
#: kCluster)`` of ``greedy_place_kernel<K, kSmem, kCluster>``; and each
#: state's tag after K in the logs.
GREEDY_STATES = {("0", "0"): "registers", ("1", "0"): "smem",
                 ("1", "1"): "cluster"}
GREEDY_TAGS = {"registers": "", "smem": "s", "cluster": "c",
               "global": " global"}


def ptxas_usage_lines(proc):
    """One line per kernel build: hosts per thread K, where the state
    lives (registers, ``smem`` of one CTA, ``cluster`` of a cluster's
    CTAs, ``global`` memory: the global form, K 0), registers, shared
    memory, stack and spills."""
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v failed:\n{out}")
    lines, cur = [], None
    for raw in out.splitlines():
        m = re.search(r"greedy_place_kernelILi(\d+)ELb([01])ELb([01])E", raw)
        if "Compiling entry function" in raw and m:
            cur = dict(K=int(m.group(1)),
                       state=GREEDY_STATES[m.group(2), m.group(3)])
        elif "Compiling entry function" in raw and "greedy_global_kernel" \
                in raw:
            cur = dict(K=0, state="global")
        elif cur is not None and "spill stores" in raw:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", raw)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in raw and "registers" in raw:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             raw).group(1))
            smem = re.search(r"(\d+) bytes smem", raw)
            cur["static_smem"] = int(smem.group(1)) if smem else 0
            lines.append(cur)
            cur = None
    if not lines:
        raise AssertionError(f"no ptxas usage found in:\n{out}")
    return [json.dumps(x) for x in sorted(
        lines, key=lambda x: (x["state"], x["K"]))]


def cf_ptxas_start(build, tmp):
    """Start ``nvcc -Xptxas -v`` on ``carry_free_place.cu`` (a cubin of
    the build's own flags) and return the process."""
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = os.path.join("pivot_tpu_torch", "csrc", "carry_free_place.cu")
    return subprocess.Popen(
        [build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", src, "-o",
         os.path.join(tmp, "carry_free_place.cubin")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


#: The forms of ``carry_free_place`` as ``ptxas`` names them
#: (``kForm``: K hosts a thread in registers, 0 the cluster form, −1
#: the global-rows form).
CF_FORM_NAMES = {"0": "shared", "n1": "global"}


def cf_ptxas_lines(proc):
    """One row per build of ``carry_free_place`` (arm, risk row, form:
    ``K=k`` registers, ``shared`` or ``global`` rows): registers, shared
    memory, stack and spills, and the form number (for the register
    check)."""
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v failed:\n{out}")
    rows, cur = [], None
    for raw in out.splitlines():
        m = re.search(r"carry_free_kernelILi(\d)ELb([01])ELi(n?\d+)E", raw)
        if "Compiling entry function" in raw and m:
            form = m.group(3)
            cur = dict(build=f"{CF_ARMS[int(m.group(1))]}"
                             f"{'+risk' if m.group(2) == '1' else ''}/"
                             + CF_FORM_NAMES.get(form, f"K={form}"),
                       form=-int(form[1:]) if form[0] == "n" else int(form))
        elif cur is not None and "spill stores" in raw:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", raw)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in raw and "registers" in raw:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             raw).group(1))
            rows.append(cur)
            cur = None
    from pivot_tpu_torch.ops.cuda_kernels import _CF_REG_THREADS

    want = 6 * (len(_CF_REG_THREADS) + 2)  # 3 arms, risk or not, forms
    if len(rows) != want:
        raise AssertionError(f"{len(rows)} carry_free_place builds, not "
                             f"{want}, in:\n{out}")
    return sorted(rows, key=lambda r: r["build"])


def check_cf_tables(build, ck) -> None:
    """``carry_free_place``'s shared memory and thread limits in the
    library equal the wrapper's copies (``_cf_smem_bytes``,
    ``_CF_REG_THREADS``, ``_CF_MAX_THREADS``)."""
    lib = build.load("carry_free_place")
    lib.carry_free_place_smem_bytes.restype = ctypes.c_size_t
    forms = (*ck._CF_REG_THREADS, ck._CF_ROWS_SHARED, ck._CF_ROWS_GLOBAL)
    for form in forms:
        want = ck._CF_REG_THREADS.get(form, ck._CF_MAX_THREADS)
        if lib.carry_free_place_max_threads(form) != want:
            raise AssertionError(f"carry_free_place's thread limit of form "
                                 f"{form} differs from the wrapper's")
    for H in (1, 600, 4097, 98304, 211968):
        for form in forms:
            for W, G, C in ((1, 1, 1), (5, 2, 1), (32, 1, 1), (16, 1, 16),
                            (32, 1, 8)):
                if lib.carry_free_place_smem_bytes(H, form, W, G, C) != \
                        ck._cf_smem_bytes(H, form, W, G, C):
                    raise AssertionError(
                        f"carry_free_place smem bytes differ at H={H}, "
                        f"form={form}, W={W}, G={G}, C={C}")
    log("  carry_free_place launch-shape tables: wrapper = library")


def chain_ptxas_start(build, tmp):
    """Start ``nvcc -Xptxas -v`` on ``ensemble_chain.cu`` (a cubin of the
    build's own flags) and return the process."""
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = os.path.join("pivot_tpu_torch", "csrc", "ensemble_chain.cu")
    return subprocess.Popen(
        [build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", src, "-o",
         os.path.join(tmp, "ensemble_chain.cubin")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def chain_ptxas_lines(proc):
    """One row per build of ``ensemble_chain`` (``ensemble_chain_kernel<
    arm, form>``: four arms, the shared and global forms): registers,
    stack and spills."""
    from pivot_tpu_torch.ops.cuda_kernels import _CHAIN_ARMS

    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"nvcc -Xptxas -v failed:\n{out}")
    rows, cur = [], None
    for raw in out.splitlines():
        m = re.search(r"ensemble_chain_kernelILi(\d)ELi(\d)E", raw)
        if "Compiling entry function" in raw and m:
            cur = dict(build=f"{_CHAIN_ARMS[int(m.group(1))]}/"
                             f"{('shared', 'global')[int(m.group(2))]}")
        elif cur is not None and "spill stores" in raw:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", raw)]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in raw and "registers" in raw:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             raw).group(1))
            rows.append(cur)
            cur = None
    if len(rows) != 2 * len(_CHAIN_ARMS):
        raise AssertionError(f"{len(rows)} ensemble_chain builds, not "
                             f"{2 * len(_CHAIN_ARMS)}, in:\n{out}")
    return sorted(rows, key=lambda r: r["build"])


def check_chain_tables(build, ck) -> None:
    """``ensemble_chain``'s shared memory and thread limit in the library
    equal the wrapper's copies (``_chain_smem_bytes``,
    ``_CHAIN_MAX_WARPS``)."""
    lib = build.load("ensemble_chain")
    lib.ensemble_chain_smem_bytes.restype = ctypes.c_size_t
    if lib.ensemble_chain_max_threads() != 32 * ck._CHAIN_MAX_WARPS:
        raise AssertionError("ensemble_chain's thread limit differs from "
                             "the wrapper's")
    for H in (1, 600, 8856, 13478, 98304):
        for z in (1, 31, 169):
            for form in (ck._CHAIN_SHARED, ck._CHAIN_GLOBAL):
                for arm in range(len(ck._CHAIN_ARMS)):
                    for risk in (0, 1):
                        if lib.ensemble_chain_smem_bytes(H, z, form, arm,
                                                         risk) != \
                                ck._chain_smem_bytes(H, z, form, arm, risk):
                            raise AssertionError(
                                f"ensemble_chain smem bytes differ at H={H}, "
                                f"Z={z}, form={form}, arm={arm}, "
                                f"risk={risk}")
    log("  ensemble_chain launch-shape tables: wrapper = library")


def check_shape_tables(build, ck) -> None:
    """The wrapper's copy of the launch-shape tables must be the
    library's: thread limits of each (K, state), the shared-memory K,
    the smem formulas of one CTA, of a cluster's CTA and of the global
    form."""
    lib = build.load("greedy_place")
    lib.greedy_place_smem_bytes.restype = ctypes.c_size_t
    for K in range(1, 33):
        for state in range(len(ck._STATES)):
            want = (ck._REG_THREADS.get(K, 0) if state == 0
                    else (1024 if K == ck._SMEM_K else 0) if state == 1
                    else ck._GLOBAL_THREADS)
            got = lib.greedy_place_max_threads(K, state)
            if got != want:
                raise AssertionError(f"max threads of K={K} state="
                                     f"{ck._STATES[state]}: {got} in the "
                                     f"library, {want} in the wrapper")
    for z in (1, 7, 31, 45):
        for W, G, K, s, C in ((1, 1, 1, 0, 1), (2, 15, 10, 0, 1),
                              (4, 2, 5, 0, 1), (19, 1, 1, 0, 1),
                              (32, 1, ck._SMEM_K, 1, 1),
                              (17, 1, ck._SMEM_K, 1, 2),
                              (20, 1, ck._SMEM_K, 1, 16),
                              (32, 1, ck._SMEM_K, 1, 16)):
            if lib.greedy_place_smem_bytes(z, W, G, K, s, C) != \
                    ck._smem_bytes(z, W, G, K, bool(s), C):
                raise AssertionError(f"smem bytes differ at "
                                     f"{z, W, G, K, s, C}")
        if lib.greedy_place_smem_bytes(z, 32, 1, 0, 2, 1) != \
                ck._global_smem_bytes(z):
            raise AssertionError(f"global-form smem bytes differ at Z={z}")
    log("  launch-shape tables: wrapper = library")


def arith_check(build, n=1 << 26) -> None:
    """The kernel's straight-line square root and division against the
    IEEE intrinsics (``greedy_place_arith_check``) on 2n hashed operand
    pairs each: bitwise equal wherever the kernel takes them."""
    lib = build.load("greedy_place")
    counts = torch.zeros(4, dtype=torch.int64, device="cuda")
    for seed in (1, 2):
        err = lib.greedy_place_arith_check(
            ctypes.c_uint(seed), ctypes.c_int(n),
            ctypes.c_void_p(counts.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise AssertionError(f"arith check launch failed: {err}")
    torch.cuda.synchronize()
    bad_div, bad_sqrt, n_div, n_sqrt = counts.tolist()
    log(f"  straight-line div / sqrt vs __fdiv_rn / __fsqrt_rn: {bad_div} / "
        f"{bad_sqrt} mismatches in {n_div} / {n_sqrt} operations taken")
    if bad_div or bad_sqrt or not n_div or not n_sqrt:
        raise AssertionError("straight-line arithmetic differs from IEEE")


def make_inputs(seed, T, H, device, frac_new_group=0.2, dense=False):
    """Seeded f32 tick inputs (the pattern of ``tests/test_pallas.py``).
    That pattern draws demand dimension 1 from [0, 4000) against
    availability in [0, 16), so few tasks fit anywhere; ``dense`` draws
    it from [0, 4) instead, so that most tasks place until the hosts
    fill and every score, tie-break and decrement is exercised."""
    rng = np.random.default_rng(seed)
    avail = rng.uniform(0, 16, size=(H, 4)).astype(np.float32)
    demands = np.stack([
        rng.choice([0.0, 0.5, 1.0, 2.0, 4.0], size=T),
        rng.uniform(0, 4 if dense else 4000, size=T), np.zeros(T),
        np.zeros(T),
    ], axis=1).astype(np.float32)
    valid = rng.random(T) < 0.9
    new_group = rng.random(T) < frac_new_group
    if T:
        new_group[0] = True
    anchor = rng.integers(0, Z, size=T).astype(np.int32)
    cost = rng.uniform(0, 0.11, size=(Z, Z)).astype(np.float32)
    np.fill_diagonal(cost, 0.0)
    bw = rng.uniform(50, 15000, size=(Z, Z)).astype(np.float32)
    host_zone = rng.integers(0, Z, size=H).astype(np.int32)
    counts = rng.integers(0, 5, size=H).astype(np.int32)
    return [torch.from_numpy(x).to(device) for x in (
        avail, demands, valid, new_group, anchor, cost, bw, host_zone,
        counts)]


class Check:
    """Kernel-vs-plain comparisons: exact placements, availability within
    the tolerance; tracks the largest availability difference and the
    placements made."""

    def __init__(self):
        self.cases = 0
        self.placed = 0
        self.max_abs_err = 0.0

    def same(self, got, want, what, min_placed=0) -> None:
        """``min_placed``: the fewest placements the case must make, so
        that a dense case cannot pass on a handful of decisions."""
        (p, a), (pp, pa) = got, want
        torch.cuda.synchronize()
        if not torch.equal(p, pp):
            bad = (p != pp).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: placements differ at {bad}")
        if not torch.allclose(a, pa, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{what}: availability outside tolerance")
        if a.numel():
            self.max_abs_err = max(self.max_abs_err,
                                   float((a - pa).abs().max()))
        placed = int((p >= 0).sum())
        if placed < min_placed:
            raise AssertionError(f"{what}: {placed} placements, fewer than "
                                 f"the {min_placed} this case must make")
        self.placed += placed
        self.cases += 1


#: ``carry_free_place``'s arms, in the kernel's order, and the wrappers
#: ``sched.cuda`` calls (each one's plain form: ``_cuda`` → ``_plain``).
CF_ARMS = ("opportunistic", "first-fit", "best-fit")
CF_WRAPPERS = ("opportunistic_cuda", "first_fit_cuda", "best_fit_cuda",
               "first_fit_cuda_batched", "best_fit_cuda_batched")
#: The carry-free arm of each ``overall`` arm.
CF_ARM_OF = {"Opportunistic": "opportunistic", "VBP": "first-fit"}


def cf_counts(ck) -> dict:
    """``carry_free_place``'s launches since the last reset, by
    ``"arm/R=r"``."""
    return {f"{a}/R={r}": n for (a, r), n in ck.LAUNCHES_CARRY_FREE.items()}


class CarryFreeTap:
    """Wraps the ``carry_free_place`` wrappers that ``sched.cuda`` calls
    while active: every launch is recorded with its operands and outputs
    (fresh tensors the run never writes again) — one list append inside
    the run — and :meth:`hold` holds each against its plain form on the
    same inputs after the run, outside every timed window."""

    def __init__(self, cuda_mod, ck):
        self.mod, self.ck = cuda_mod, ck
        self.calls = []  # (wrapper name, args, kw, outputs)

    def __enter__(self):
        self.saved = {n: getattr(self.mod, n) for n in CF_WRAPPERS}
        for name, fn in self.saved.items():
            setattr(self.mod, name, self._recorder(name, fn))
        return self

    def _recorder(self, name, fn):
        calls = self.calls

        @functools.wraps(fn)
        def recorded(*a, **k):
            out = fn(*a, **k)
            calls.append((name, a, k, out))
            return out
        return recorded

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)

    def largest(self, name):
        """``(args, kw)`` of the recorded ``name`` call with the most
        steps (its ``n_bound``), or None."""
        calls = [(k["n_bound"], a, k) for n, a, k, _o in self.calls
                 if n == name]
        if not calls:
            return None
        _n, a, k = max(calls, key=lambda c: c[0])
        return a, k

    def hold(self, chk, what) -> int:
        """Every recorded launch against its plain form (placements equal,
        availability within the tolerance); returns the count and drops
        the records."""
        for i, (name, a, k, out) in enumerate(self.calls):
            plain = getattr(self.ck, name.replace("_cuda", "_plain"))
            chk.same(out, plain(*a, **k), (what, name, i))
        n = len(self.calls)
        self.calls.clear()
        return n


def dense_floor(args, R=1) -> int:
    """Placements a dense case must make: a quarter of its valid tasks
    in every replica."""
    return R * int(args[2].sum()) // 4


EDGE_CASES = ["ties", "h1", "h33", "h100", "risk_zeros", "zero_bw",
              "nan_only"]
#: The edge cases of a replica split over CTAs
#: (``tests/test_torch_greedy.py::CTA_EDGE_CASES``), and the host counts
#: phase 2 runs them at: the least H of each cluster size C = 2, 4, 8, 16
#: (the last one the pod tick's 98,304, whose C = 16 CTAs hold 6,144
#: hosts each) and one host past the cluster form (the global form).
CTA_EDGE_CASES = ["cta_ties", "cta_last", "cta_masked", "cta_risk",
                  "cta_nan"]
CTA_EDGE_HS = ((10241, 2), (20481, 4), (40961, 8), (98304, 16),
               (163841, 1))


def cta_slice(ck, H):
    """``tests/test_torch_greedy.py::cta_slice``: hosts a CTA of ``H``
    hosts' launch shape holds (the global form: the 16-CTA width)."""
    cfg = ck._launch_config(1, H, Z)
    return -(-H // (cfg.cluster if cfg.cluster > 1 else ck.MAX_CLUSTER))


def edge_inputs(name, device, H=None):
    """``tests/test_torch_greedy.py::edge_inputs`` on ``device``: a dense
    40-task tick on one selection edge case (ties across warp boundaries
    at hosts 31/32 and 63/64 = H − 1; H = 1, 33, 100; a risk row of ±0.0;
    +inf and NaN scores from zero bandwidth; and at ``H`` hosts split
    over CTAs of :func:`cta_slice` hosts: ties across every CTA
    boundary, the winners in the last CTA, the first CTA all
    ``live``-masked, ±0.0 risk, a NaN risk on one small host of the last
    CTA).  Returns the nine operands and the extra keyword tensors."""
    from pivot_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(sum(map(ord, name)))
    if name in CTA_EDGE_CASES:
        H = H or CTA_EDGE_HS[1][0]
    else:
        H = {"h1": 1, "h33": 33, "h100": 100}.get(name, 65)
    T = 40
    avail = rng.uniform(0, 16, size=(H, 4)).astype(np.float32)
    demands = np.stack([rng.choice([0.0, 0.5, 1.0, 2.0], size=T),
                        rng.uniform(0, 4, size=T), np.zeros(T), np.zeros(T)],
                       axis=1).astype(np.float32)
    valid = rng.random(T) < 0.9
    new_group = rng.random(T) < 0.2
    new_group[0] = True
    anchor = rng.integers(0, Z, size=T).astype(np.int32)
    cost = rng.uniform(0, 0.11, size=(Z, Z)).astype(np.float32)
    np.fill_diagonal(cost, 0.0)
    bw = rng.uniform(50, 15000, size=(Z, Z)).astype(np.float32)
    host_zone = rng.integers(0, Z, size=H).astype(np.int32)
    counts = rng.integers(0, 5, size=H).astype(np.int32)
    kw = {}
    if name == "ties":
        avail[:] = 1.5
        avail[[31, 32, 63, 64]] = 9.0
        host_zone[:] = 3
        counts[:] = 2
    elif name == "risk_zeros":
        kw["risk"] = rng.choice([-0.0, 0.0, 0.25], size=H).astype(np.float32)
    elif name == "zero_bw":
        bw[5, :] = 0.0
        bw[:, 5] = 0.0
        host_zone[: H // 3] = 5
        anchor[::2] = 5
    elif name == "nan_only":
        bw[5, 5] = 0.0
        host_zone[:] = 5
        anchor[:] = 5
    elif name in CTA_EDGE_CASES:
        w = cta_slice(ck, H)
        starts = list(range(w, H, w))  # the first host of each later CTA
        if name == "cta_ties":
            avail[:] = 1.5
            for b in starts:
                avail[[b - 1, b]] = 9.0
            host_zone[:] = 3
            counts[:] = 2
        elif name == "cta_last":
            avail[: starts[-1]] = 0.25
        elif name == "cta_masked":
            avail[:w] = 15.5
            live = np.ones(H, bool)
            live[:w] = False
            kw["live"] = live
        else:
            risk = rng.choice([-0.0, 0.0, 0.25], size=H).astype(np.float32)
            if name == "cta_nan":
                risk[H - 2] = np.nan
                avail[H - 2] = [0.75, 0.75, 1.0, 1.0]
            kw["risk"] = risk
    args = [torch.from_numpy(x).to(device) for x in (
        avail, demands, valid, new_group, anchor, cost, bw, host_zone,
        counts)]
    return args, {k: torch.from_numpy(v).to(device) for k, v in kw.items()}


def bare_launch(ck, args, kw, warps=None):
    """The kernel alone: ``_check`` once, outputs allocated once, then a
    function that runs ``_launch`` (the wrapper's one launch site) in the
    default shape or with ``warps`` warps per replica, and returns the
    outputs as ``[R, T]`` / ``[R, H, 4]``.  Also returns the shape."""
    avail = args[0] if args[0].dim() == 3 else args[0][None]
    a = [avail, *args[1:]]
    live, risk = kw.get("live"), kw.get("risk")
    bin_pack = kw.get("bin_pack", "first-fit")
    R, T, H, n_eff, cfg = ck._check(*a, bin_pack, live, risk,
                                    kw.get("n_eff"))
    if warps is not None:
        cfg = ck._launch_config(R, H, a[5].shape[0], warps)
    placements = torch.empty((R, T), dtype=torch.int32, device=avail.device)
    out = torch.empty_like(avail)

    def go():
        ck._launch(cfg, *a, live, risk, placements, out, n_eff,
                   bin_pack == "first-fit", kw.get("sort_hosts", True),
                   kw.get("host_decay", False))
        return placements, out
    return go, cfg


#: Warps per replica the phase-4 sweep times at H = 600 (19 = the whole
#: block at H = 600, one host a thread).
SWEEP_WARPS = (1, 2, 3, 4, 5, 6, 8, 10, 19)


def phase_kernel_vs_plain(ck, device) -> Check:
    chk = Check()
    for dense in (False, True):
        for mode in MODES:
            for seed, (T, H) in enumerate(SHAPES):
                args = make_inputs(seed, T, H, device, dense=dense)
                chk.same(ck.cost_aware_cuda(*args, **mode),
                         ck.cost_aware_plain(*args, **mode),
                         (mode, T, H, "dense" if dense else "sparse"),
                         dense_floor(args) if dense else 0)
    # Edge cases.
    args = make_inputs(0, 0, 8, device)
    chk.same(ck.cost_aware_cuda(*args), ck.cost_aware_plain(*args), "T=0")
    args = make_inputs(1, 40, 24, device)
    none_fit = [torch.full_like(args[0], 0.5), torch.full_like(args[1], 99.0)]
    for mode in (MODES[0], MODES[3]):
        got = ck.cost_aware_cuda(*none_fit, *args[2:], **mode)
        chk.same(got, ck.cost_aware_plain(*none_fit, *args[2:], **mode),
                 ("no fit", mode))
        if int((got[0] >= 0).sum()):
            raise AssertionError("a task was placed where nothing fits")
    args = make_inputs(2, 300, 50, device, dense=True)
    args[2][::3] = False  # invalid tasks interspersed
    for mode in MODES:
        got = ck.cost_aware_cuda(*args, **mode)
        chk.same(got, ck.cost_aware_plain(*args, **mode), ("invalid", mode),
                 dense_floor(args))
        if bool((got[0][~args[2]] >= 0).any()):
            raise AssertionError("an invalid task was placed")
    rng = np.random.default_rng(1)
    live = np.ones(600, bool)
    live[rng.choice(600, size=60, replace=False)] = False
    live = torch.from_numpy(live).to(device)
    risk = torch.from_numpy(rng.choice([0.0, 0.4, 1.5], size=600)
                            .astype(np.float32)).to(device)
    for dense in (False, True):
        args = make_inputs(3, 619, 600, device, dense=dense)
        for mode in MODES:
            for kw in (dict(live=live), dict(risk=risk),
                       dict(live=live, risk=risk)):
                got = ck.cost_aware_cuda(*args, **mode, **kw)
                chk.same(got, ck.cost_aware_plain(*args, **mode, **kw),
                         ("live/risk", mode, sorted(kw), dense),
                         dense_floor(args) if dense else 0)
                if "live" in kw:
                    placed = got[0][got[0] >= 0].long()
                    if not bool(live[placed].all()):
                        raise AssertionError("placed on a masked host")
    # Replica-batched launches.
    for dense in (False, True):
        for R, (T, H) in ((5, (70, 40)), (256, (619, 600))):
            args = make_inputs(4, T, H, device, dense=dense)
            noise = torch.from_numpy(np.random.default_rng(9).uniform(
                0.5, 1.5, (R, H, 1)).astype(np.float32)).to(device)
            avail_r = (args[0][None] * noise).contiguous()
            for mode in MODES:
                chk.same(
                    ck.cost_aware_cuda_batched(avail_r, *args[1:], **mode),
                    ck.cost_aware_plain_batched(avail_r, *args[1:], **mode),
                    ("batched", R, mode, dense),
                    dense_floor(args, R) if dense else 0)
    # Selection edge cases, in the default shape and at 1 / 2 / 4 warps.
    for name in EDGE_CASES:
        args, kw = edge_inputs(name, device)
        for mode in MODES:
            want = ck.cost_aware_plain(*args, **mode, **kw)
            chk.same(ck.cost_aware_cuda(*args, **mode, **kw), want,
                     ("edge", name, mode))
            want = (want[0][None], want[1][None])
            for warps in (1, 2, 4):
                go, _cfg = bare_launch(ck, args, {**mode, **kw}, warps)
                chk.same(go(), want, ("edge", name, mode, warps))
            if name == "nan_only" and mode["sort_hosts"] and bool(
                    (want[0] >= 0).any()):
                raise AssertionError("a NaN minimum placed a task")
    # Past one CTA: the CTA edge cases at each cluster size and in the
    # global form, every mode; and the replica-batched (R = 3) and
    # per-row (G = 2) launches of a cluster and of the global form.
    for H, C in CTA_EDGE_HS:
        cfg = ck._launch_config(1, H, Z)
        if cfg.cluster != C or (C == 1) != (cfg.state == "global"):
            raise AssertionError(f"H={H}: {cfg}, not the C={C} form")
        for name in CTA_EDGE_CASES:
            args, kw = edge_inputs(name, device, H)
            for mode in MODES:
                got = ck.cost_aware_cuda(*args, **mode, **kw)
                chk.same(got, ck.cost_aware_plain(*args, **mode, **kw),
                         ("cta edge", name, H, cfg.state, C, mode))
                if "live" in kw:
                    placed = got[0][got[0] >= 0].long()
                    if not bool(kw["live"][placed].all()):
                        raise AssertionError("placed on a masked host")
    for H in (CTA_EDGE_HS[1][0], CTA_EDGE_HS[-1][0]):
        for dense in (False, True):
            args = make_inputs(11, 40, H, device, dense=dense)
            noise = torch.from_numpy(np.random.default_rng(9).uniform(
                0.5, 1.5, (3, H, 1)).astype(np.float32)).to(device)
            avail_r = (args[0][None] * noise).contiguous()
            rargs, rkw = rows_inputs(12, 2, 40, H, device, dense=dense,
                                     live=True, risk=dense)
            for mode in (MODES[0], MODES[4]):
                chk.same(
                    ck.cost_aware_cuda_batched(avail_r, *args[1:], **mode),
                    ck.cost_aware_plain_batched(avail_r, *args[1:], **mode),
                    ("cta batched", H, mode, dense),
                    dense_floor(args, 3) if dense else 0)
                chk.same(ck.cost_aware_cuda_rows(*rargs, **mode, **rkw),
                         ck.cost_aware_plain_rows(*rargs, **mode, **rkw),
                         ("cta rows", H, mode, dense))
    # Every shape the phase-4 sweep times, and the shared-memory state.
    for dense in (False, True):
        for R, T, H in ((1, 619, 600), (256, 619, 600), (1, 64, 9664)):
            args = make_inputs(8, T, H, device, dense=dense)
            if R > 1:
                noise = torch.from_numpy(np.random.default_rng(9).uniform(
                    0.5, 1.5, (R, H, 1)).astype(np.float32)).to(device)
                args[0] = (args[0][None] * noise).contiguous()
            for mode in MODES if H > 600 or R == 1 else MODES[:1]:
                want = ck.cost_aware_plain_batched(
                    args[0] if R > 1 else args[0][None], *args[1:], **mode)
                for warps in SWEEP_WARPS if H == 600 else (None,):
                    go, cfg = bare_launch(ck, args, mode, warps)
                    chk.same(go(), want, ("shape", R, T, H, mode, cfg),
                             dense_floor(args, R) if dense and H == 600
                             else 0)
    return chk


def rows_inputs(seed, G, T, H, device, dense=False, live=False,
                risk=False):
    """Per-row operands of a per-row launch: G rows of
    :func:`make_inputs` (each its own stream, host rows and tables), each
    row's step bound drawn in [0, T] (row 0 walks all T), and, when asked,
    a ``[G, H]`` live mask and risk row."""
    rows = [make_inputs(seed * 101 + r, T, H, "cpu", dense=dense)
            for r in range(G)]
    args = [torch.stack([row[i] for row in rows]).to(device)
            for i in range(9)]
    rng = np.random.default_rng(seed)
    n_eff = rng.integers(0, T + 1, size=G).astype(np.int32)
    n_eff[0] = T
    kw = {"n_eff_g": torch.from_numpy(n_eff).to(device)}
    if live:
        kw["live"] = torch.from_numpy(rng.random((G, H)) < 0.8).to(device)
    if risk:
        kw["risk"] = torch.from_numpy(rng.choice(
            [0.0, 0.4, 1.5], size=(G, H)).astype(np.float32)).to(device)
    return args, kw


#: (G, T, H) of the synthetic per-row cases.
ROWS_SHAPES = ((2, 37, 13), (3, 300, 50), (5, 5, 200), (4, 120, 600),
               (16, 40, 600))


def rows_vs_plain(ck, device) -> Check:
    """The per-row launch of ``greedy_place`` against
    ``cost_aware_plain_rows`` on the card: every mode over the shapes of
    ``ROWS_SHAPES``, sparse and dense, with per-row step bounds; a live
    mask, a risk row and both on the 600-host shape; T = 0."""
    chk = Check()
    for dense in (False, True):
        for mode in MODES:
            for seed, (G, T, H) in enumerate(ROWS_SHAPES):
                args, kw = rows_inputs(seed, G, T, H, device, dense=dense)
                chk.same(ck.cost_aware_cuda_rows(*args, **mode, **kw),
                         ck.cost_aware_plain_rows(*args, **mode, **kw),
                         ("rows", mode, G, T, H, dense))
    for live, risk in ((True, False), (False, True), (True, True)):
        args, kw = rows_inputs(7, 4, 120, 600, device, dense=True, live=live,
                               risk=risk)
        for mode in MODES:
            got = ck.cost_aware_cuda_rows(*args, **mode, **kw)
            chk.same(got, ck.cost_aware_plain_rows(*args, **mode, **kw),
                     ("rows live/risk", mode, live, risk))
            if live:
                for r in range(4):
                    placed = got[0][r][got[0][r] >= 0].long()
                    if not bool(kw["live"][r][placed].all()):
                        raise AssertionError("placed on a masked host")
    args, kw = rows_inputs(9, 3, 0, 8, device)
    chk.same(ck.cost_aware_cuda_rows(*args, **kw),
             ck.cost_aware_plain_rows(*args, **kw), "rows T=0")
    return chk


def overall_argv(out, job_dir, device):
    return ["--device", device, "--no-adaptive", "--num-hosts", "600",
            "--job-dir", job_dir, "--output-dir", out, "--seed", "0",
            "overall", "--num-apps", "1000"]


def check_outputs(exp_dir) -> None:
    """The four reference output files of every arm, with finite metrics."""
    for arm in ARMS:
        d = os.path.join(exp_dir, "data", "0", arm)
        with open(os.path.join(d, "general.json")) as f:
            general = json.load(f)
        for key in ("egress_cost", "cum_instance_hours", "avg_runtime"):
            if not np.isfinite(general[key]):
                raise AssertionError(f"{arm}: {key} = {general[key]}")
        for name in ("transfers.json", "scheduler.json", "host_usage.json"):
            if not os.path.getsize(os.path.join(d, name)):
                raise AssertionError(f"{arm}: empty {name}")


def rankings_agree(cuda, numpy_, metric) -> None:
    """Pairwise order of the arms on ``metric`` must agree; two arms
    within 0.5% of each other in the numpy run count as tied."""
    for i, a in enumerate(ARMS):
        for b in ARMS[i + 1:]:
            na, nb = numpy_[a][metric], numpy_[b][metric]
            if abs(na - nb) <= 0.005 * max(abs(na), abs(nb)):
                log(f"  {metric}: {a} and {b} within 0.5% on numpy "
                    f"({na!r} vs {nb!r}) -- treated as tied")
                continue
            ca, cb = cuda[a][metric], cuda[b][metric]
            if (ca < cb) != (na < nb):
                raise AssertionError(
                    f"{metric} ranking differs: cuda {a}={ca!r} {b}={cb!r}, "
                    f"numpy {a}={na!r} {b}={nb!r}")


ARM_OF = {"opportunistic": "Opportunistic", "first-fit": "VBP",
          "cost-aware": "Cost-Aware"}


class SpanMeter:
    """Wraps ``sched.cuda.fused_tick_run`` while active: the device's
    sync debug mode is "error" around every span, so any host read inside
    one raises, and CUDA events around each call time the span on the
    device timeline (read after the run).  Its ``ticks_run`` is read after
    the span, beside the policy's own fetch."""

    def __init__(self, cuda_mod):
        self.mod, self.orig = cuda_mod, cuda_mod.fused_tick_run
        self.spans = []  # one dict per span

    def __call__(self, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = self.orig(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ev[1].record()
        self.spans.append(dict(arm=ARM_OF[kw["policy"]], k_dyn=a[3],
                               steps=sum(kw["n_bound"]),
                               ticks_run=int(res.ticks_run),
                               ready=int(res.n_ready.sum()), ev=ev))
        return res

    def __enter__(self):
        self.mod.fused_tick_run = self
        return self

    def __exit__(self, *exc):
        self.mod.fused_tick_run = self.orig

    def by_arm(self):
        """Per arm: spans, horizon ticks, executed ticks, pass steps
        walked, live steps (the executed ticks' ready sizes: what the
        per-tick path walks for them), and device ms per span (median,
        largest)."""
        torch.cuda.synchronize()
        out = {}
        for arm in ARMS:
            sp = [x for x in self.spans if x["arm"] == arm]
            ms = [x["ev"][0].elapsed_time(x["ev"][1]) for x in sp]
            out[arm] = dict(
                spans=len(sp), horizon_ticks=sum(x["k_dyn"] for x in sp),
                ticks_run=sum(x["ticks_run"] for x in sp),
                steps=sum(x["steps"] for x in sp),
                live_steps=sum(x["ready"] for x in sp),
                ms_median=statistics.median(ms) if ms else None,
                ms_max=max(ms) if ms else None, ms_sum=sum(ms))
        return out


class SpanReferee:
    """Wraps ``sched.cuda.fused_tick_run`` while active: every span's
    result is held against ``reference_tick_run`` on the same operands,
    the plain version serving its Cost-Aware ticks — equal placements,
    ready and placed counts, availability within the tolerance."""

    def __init__(self, cuda_mod, ck, tickloop):
        self.mod, self.orig = cuda_mod, cuda_mod.fused_tick_run
        self.ck, self.tickloop = ck, tickloop
        self.spans = 0
        self.max_abs_err = 0.0

    def __call__(self, avail, dem, arrive, k_dyn, **kw):
        res = self.orig(avail, dem, arrive, k_dyn, **kw)
        rkw = {k: v for k, v in kw.items() if k not in ("n_bound", "n_ticks")}
        if rkw.get("greedy") is not None:
            rkw["greedy"] = self.ck.cost_aware_plain
        p, n_ready, n_placed, a = self.tickloop.reference_tick_run(
            avail, dem, arrive, k_dyn, **rkw)
        ticks_run = int(res.ticks_run)
        if not (np.array_equal(res.placements[:k_dyn].cpu().numpy(), p)
                and np.array_equal(res.n_placed[:k_dyn].cpu().numpy(),
                                   n_placed)
                and np.array_equal(res.n_ready[:ticks_run].cpu().numpy(),
                                   n_ready[:ticks_run])):
            raise AssertionError(f"span {self.spans} differs from "
                                 "reference_tick_run")
        got = res.avail.cpu().numpy()
        if not np.allclose(got, a, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"span {self.spans}: availability outside "
                                 "tolerance of reference_tick_run")
        if got.size:
            self.max_abs_err = max(self.max_abs_err,
                                   float(np.abs(got - a).max()))
        self.spans += 1
        return res

    __enter__ = SpanMeter.__enter__
    __exit__ = SpanMeter.__exit__


def time_device_calls(policy) -> dict:
    """Wrap ``policy``'s device calls (``place``, ``place_span``) in
    host-clock timers: the returned dict holds their summed seconds
    (each call's fetch included, so its device work too) and the number
    of per-tick calls."""
    acc = dict(seconds=0.0, place_calls=0)
    for name in ("place", "place_span"):
        orig = getattr(policy, name, None)
        if orig is None:
            continue

        def timed(*a, _orig=orig, _tick=name == "place", **k):
            t0 = time.perf_counter()
            try:
                return _orig(*a, **k)
            finally:
                acc["seconds"] += time.perf_counter() - t0
                acc["place_calls"] += _tick

        setattr(policy, name, timed)
    return acc


def host_ms_per_tick(summary, acc) -> dict:
    """Host ms per tick of one run: its wall less the host-clock time
    inside the policy's device calls, over the ticks that reached the
    policy (per-tick calls + ticks replayed from fused spans)."""
    ticks = acc["place_calls"] + summary["spans"]["fused_ticks"]
    host_s = summary["wall_clock"] - acc["seconds"]
    return dict(wall_s=summary["wall_clock"], device_call_s=acc["seconds"],
                ticks=ticks, host_ms_per_tick=host_s * 1e3 / max(ticks, 1))


def run_cli(cli, argv, device, fuse):
    """``run_overall`` on ``argv`` with fused spans on or off; returns
    ``(exp_dir, summaries, runs)`` — the ``ExperimentRun`` objects keep
    every task's placement, and each carries ``device_calls``, its
    policy's :func:`time_device_calls` timers."""
    runs, build = [], cli._build_run

    def build_run(spec):
        run = build(spec)
        run.fuse_spans = fuse
        run.device_calls = time_device_calls(run.policy)
        runs.append(run)
        return run

    cli._build_run = build_run
    try:
        exp_dir, summaries = cli.run_overall(cli.parse_args(argv),
                                             torch_device=device)
    finally:
        cli._build_run = build
    return exp_dir, summaries, runs


def task_placements(run):
    return {(a.id, t.id): (t.placement, t.demand)
            for a in run.schedule.apps for g in a.groups for t in g.tasks}


def compare_outputs(dir_a, dir_b, runs_a, runs_b):
    """Per arm: None when the four files are byte-identical, else the
    first differing task (by app and task id) and whether a float32 tie
    of demand norms that float64 tells apart can explain it."""
    out = {}
    for arm, ra, rb in zip(ARMS, runs_a, runs_b):
        same = True
        for name in ("general.json", "transfers.json", "scheduler.json",
                     "host_usage.json"):
            paths = [os.path.join(d, "data", "0", arm, name)
                     for d in (dir_a, dir_b)]
            with open(paths[0], "rb") as fa, open(paths[1], "rb") as fb:
                same = same and fa.read() == fb.read()
        if same:
            out[arm] = None
            continue
        pa, pb = task_placements(ra), task_placements(rb)
        diff = sorted(k for k in pa if pa[k][0] != pb[k][0])
        first = diff[0] if diff else None
        norms = {k: float(np.sqrt(np.sum(np.square(v[1]))))
                 for k, v in pa.items()}
        tie = None
        if first is not None:
            n64 = norms[first]
            n32 = np.float32(n64)
            tie = any(np.float32(n) == n32 and n != n64
                      for n in norms.values())
        out[arm] = dict(differing_tasks=len(diff), first=first,
                        first_on=pa[first][0] if first else None,
                        first_off=pb[first][0] if first else None,
                        f32_norm_tie=tie)
    return out


def make_shadow_policy(cuda_mod, ck):
    base = cuda_mod.CudaCostAwarePolicy

    class ShadowCostAware(base):
        """The Cost-Aware device policy with every kernel call shadowed
        by the plain version on the same staged tensors."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.check = Check()
            self.ticks = []  # (args, kw) of every per-tick call, for timing
            self.span_ticks = []  # (args, kw) of every span tick
            self.in_span = False
            self.largest = 0
            self.sensitivity = None

        def _greedy(self, *args, **kw):
            got = super()._greedy(*args, **kw)
            ticks = self.span_ticks if self.in_span else self.ticks
            self.check.same(got, ck.cost_aware_plain(*args, **kw),
                            ("span tick" if self.in_span else "tick",
                             len(ticks)))
            ticks.append((args, kw))
            return got

        def _span_greedy(self, *args, **kw):
            self.in_span = True
            try:
                return super()._span_greedy(*args, **kw)
            finally:
                self.in_span = False

        def _greedy_batched(self, *args, **kw):
            got = super()._greedy_batched(*args, **kw)
            self.check.same(got, ck.cost_aware_plain_batched(*args, **kw),
                            "placement_sensitivity")
            return got

        def _device_place(self, ctx):
            out = super()._device_place(ctx)
            if ctx.n_tasks > self.largest:
                self.largest = ctx.n_tasks
                nominal, stability, placements = self.placement_sensitivity(
                    ctx, n_replicas=256, perturb=0.05, seed=0)
                if placements.shape != (256, ctx.n_tasks) or not (
                        nominal.tolist() == out.tolist()):
                    raise AssertionError("sensitivity replica 0 is not the "
                                         "production decision")
                self.sensitivity = (ctx.n_tasks, float(stability.mean()))
            return out

    return ShadowCostAware


#: Phase 3's depth: 100 apps, not 1000: cut to 500 when phase 9 came,
#: to 150 for phase 11 and to 100 for phase 14, for the script's 1,200 s
#: (PERF.md, section 4).
E2E_APPS = 100


def phase_end_to_end(device, n_hosts=600, n_apps=E2E_APPS):
    from pivot_tpu_torch.experiments import cli, runner
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.ops import tickloop
    from pivot_tpu_torch.sched import cuda as cuda_mod
    from pivot_tpu_torch.utils.config import build_cluster

    res = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        job_dir = os.path.join(tmp, "jobs")
        os.makedirs(job_dir)
        os.symlink(os.path.abspath(TRACE),
                   os.path.join(job_dir, os.path.basename(TRACE)))
        runs = {}
        cf_check = Check()
        for name, backend, fuse in (("cuda", "cuda", True),
                                    ("cuda_off", "cuda", False),
                                    ("numpy", "numpy", True)):
            argv = overall_argv(os.path.join(tmp, name), job_dir, backend)
            argv[argv.index("600")] = str(n_hosts)
            argv[-1] = str(n_apps)
            cluster_cfg = cli._cluster_config(cli.parse_args(argv))
            with SpanMeter(cuda_mod) as meter, \
                    CarryFreeTap(cuda_mod, ck) as tap:
                ck.reset_launches()  # the main path's count starts here
                t0 = time.perf_counter()
                exp_dir, summaries, objs = run_cli(cli, argv, device, fuse)
                wall = time.perf_counter() - t0
                launches = ck.LAUNCHES["greedy_place"]
                cf_launches = cf_counts(ck)
            if backend == "cuda":
                res.setdefault("cf_largest", {})[name] = {
                    arm: tap.largest(w) for arm, w in (
                        ("Opportunistic", "opportunistic_cuda"),
                        ("VBP", "first_fit_cuda"))}
            held = tap.hold(cf_check, ("phase 3", name))  # after the run
            if held != sum(cf_launches.values()):
                raise AssertionError(f"{name}: {held} carry_free_place "
                                     f"launches recorded, {cf_launches} "
                                     "counted")
            check_outputs(exp_dir)
            runs[name] = dict(wall=wall, launches=launches,
                              cf_launches=cf_launches, dir=exp_dir,
                              objs=objs, spans=meter.by_arm(),
                              arms={s["label"]: s for s in summaries},
                              host={s["label"]: host_ms_per_tick(
                                  s, r.device_calls)
                                  for s, r in zip(summaries, objs)})
        cuda, numpy_ = runs["cuda"]["arms"], runs["numpy"]["arms"]
        for name in ("cuda", "cuda_off"):
            ca = runs[name]["arms"]["Cost-Aware"]["dispatch"]
            fusion = "on" if name == "cuda" else "off"
            log(f"  cost-aware on cuda, fusion {fusion}: "
                f"{ca['device_ticks']} per-tick device ticks, "
                f"{ca['kernel_ticks']} served by greedy_place, "
                f"{ca['span_kernel_ticks']} span ticks launched on it, "
                f"{runs[name]['launches']} launches counted")
            if not (ca["device_ticks"] > 0
                    and ca["kernel_ticks"] == ca["device_ticks"]
                    and runs[name]["launches"]
                    == ca["kernel_ticks"] + ca["span_kernel_ticks"]):
                raise AssertionError("not every Cost-Aware tick was a launch")
            cf = runs[name]["cf_launches"]
            for arm in ARMS[:2]:
                d = runs[name]["arms"][arm]["dispatch"]
                n = cf.get(f"{CF_ARM_OF[arm]}/R=1", 0)
                log(f"  {arm.lower()} on cuda, fusion {fusion}: "
                    f"{d['device_ticks']} per-tick device ticks, "
                    f"{d['kernel_ticks']} served by carry_free_place, "
                    f"{d['span_kernel_ticks']} span ticks launched on it, "
                    f"{n} launches counted")
                if not (d["device_ticks"] > 0
                        and d["kernel_ticks"] == d["device_ticks"]
                        and n == d["kernel_ticks"] + d["span_kernel_ticks"]
                        and (d["span_kernel_ticks"] > 0) == (name == "cuda")):
                    raise AssertionError(f"{arm}: not every device tick was "
                                         "a carry_free_place launch")
            if set(cf) - {"opportunistic/R=1", "first-fit/R=1"}:
                raise AssertionError(f"{name}: carry_free_place launches "
                                     f"{cf}")
        log(f"  carry_free_place: {cf_check.cases} launches of the cuda runs "
            f"held against their plain forms, {cf_check.placed} placements, "
            f"all equal, max |avail diff| {cf_check.max_abs_err!r} (rtol "
            f"{RTOL}, atol {ATOL})")
        res["cf_check"] = cf_check
        if not cuda["Cost-Aware"]["dispatch"]["span_kernel_ticks"]:
            raise AssertionError("no Cost-Aware span tick was served by "
                                 "greedy_place")
        if runs["cuda_off"]["arms"]["Cost-Aware"]["dispatch"][
                "span_kernel_ticks"] or any(
                x["spans"] for x in runs["cuda_off"]["spans"].values()):
            raise AssertionError("a span ran with fusion off")
        for metric in ("egress_cost", "avg_runtime"):
            rankings_agree(cuda, numpy_, metric)
        for arm in ARMS:
            log(f"  {arm:13s} cuda: egress_cost={cuda[arm]['egress_cost']!r} "
                f"avg_runtime={cuda[arm]['avg_runtime']!r} "
                f"wall_s={cuda[arm]['wall_clock']!r} | numpy: "
                f"egress_cost={numpy_[arm]['egress_cost']!r} "
                f"avg_runtime={numpy_[arm]['avg_runtime']!r} "
                f"wall_s={numpy_[arm]['wall_clock']!r}")
        res["same_files"] = compare_outputs(
            runs["cuda"]["dir"], runs["cuda_off"]["dir"], runs["cuda"]["objs"],
            runs["cuda_off"]["objs"])
        for arm in ARMS[:2]:
            if res["same_files"][arm] is not None:
                raise AssertionError(f"{arm}: fusion on and off wrote "
                                     f"different files: "
                                     f"{res['same_files'][arm]}")
        # Phase 13 holds the native fabric against this run's files.
        runs["cuda"]["general"] = {}
        for arm in ARMS:
            with open(os.path.join(runs["cuda"]["dir"], "data", "0", arm,
                                   "general.json"), "rb") as f:
                runs["cuda"]["general"][arm] = f.read()
        for r in runs.values():
            r.pop("objs")
        res["runs"] = runs

        # The shadowed Cost-Aware run: same cluster, trace, seed.
        Shadow = make_shadow_policy(cuda_mod, ck)
        pc = cli.reference_policy_set("cuda", adaptive=False)[2]
        policy = Shadow(bin_pack=pc.bin_pack, sort_tasks=pc.sort_tasks,
                        sort_hosts=pc.sort_hosts, device=device)
        with SpanReferee(cuda_mod, ck, tickloop) as referee:
            summary = runner.ExperimentRun(
                "Cost-Aware", build_cluster(cluster_cfg), policy, TRACE,
                n_apps=n_apps, seed=0).run()
        for key in ("egress_cost", "avg_runtime"):
            if summary[key] != cuda["Cost-Aware"][key]:
                raise AssertionError(f"shadowed run differs on {key}")
        if not (referee.spans and policy.span_ticks):
            raise AssertionError("the shadowed run served no span")
        log(f"  shadow: {len(policy.ticks)} per-tick and "
            f"{len(policy.span_ticks)} span-tick kernel calls, "
            f"{policy.check.cases} kernel-vs-plain comparisons, all "
            f"placements equal, max |avail diff| {policy.check.max_abs_err!r};"
            f" {referee.spans} spans equal to reference_tick_run (plain "
            f"ticks), max |avail diff| {referee.max_abs_err!r}; sensitivity "
            f"R=256 at largest tick T={policy.sensitivity[0]}: mean "
            f"stability {policy.sensitivity[1]!r}")
        res["shadow"] = policy
        res["referee"] = referee
    return res


#: Apps of each gated arm the sensitivity phase runs, and its replicas.
SENS_APPS = {"cost-aware": 300, "vbp": 100}
SENS_REPLICAS = 256
METRICS = ("avg_runtime", "egress_cost", "instance_hours", "makespan")


def sensitivity_argv(out, job_dir, policy, n_apps, market, n_hosts=600):
    return ["--num-hosts", str(n_hosts), "--job-dir", job_dir,
            "--output-dir", out, "--seed", "0", "sensitivity",
            "--policy", policy, "--replicas", str(SENS_REPLICAS),
            "--num-apps", str(n_apps), "--des-seeds", "1",
            "--market", market]


class GateMeter:
    """Instruments the sensitivity path of ``sched.cuda`` while active.
    Host clocks split each gated tick's ``_mc_sensitivity`` into the noise
    draw (``_replicas``), the one ``stage`` copy, the pass (the kernel
    wrapper's enqueue, or the batched torch pass) and the rest (the fetch,
    which waits for the device, and the unpad).  Every replica-batched
    ``greedy_place`` call is recorded with its staged operands and its
    outputs — fresh tensors the run never reuses — for the shadow check
    and the times taken after the run; CUDA events bracket every batched
    First-Fit pass (the R-replica launch of ``carry_free_place``), and the
    operands of the largest one are kept."""

    def __init__(self, cuda_mod):
        self.mod = cuda_mod
        self.base = cuda_mod._DevicePolicyBase
        self.ca = cuda_mod.CudaCostAwarePolicy
        self.calls = []  # (args, kw, outputs) of every batched kernel call
        self.parts = []  # host seconds per gated tick, by part
        self.ff_passes = []  # (events, n_bound) per batched First-Fit pass
        self.ff_largest = None  # (args, kw) of the largest of them

    def __enter__(self):
        mod, meter = self.mod, self
        saved = self.saved = dict(
            mc=self.base._mc_sensitivity, replicas=self.base._replicas,
            greedy=self.ca._greedy_batched, stage=mod.stage,
            ffb=mod.first_fit_cuda_batched)
        cur = {}

        def timed(key, fn):
            def f(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    cur[key] = cur.get(key, 0.0) + time.perf_counter() - t0
            return f

        def mc(pol, *a, **k):
            cur.clear()
            t0 = time.perf_counter()
            out = saved["mc"](pol, *a, **k)
            cur["total"] = time.perf_counter() - t0
            meter.parts.append(dict(cur))
            return out

        def greedy(pol, *a, **k):
            out = saved["greedy"](pol, *a, **k)
            meter.calls.append((a, k, out))
            return out

        def ffb(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = saved["ffb"](*a, **k)
            ev[1].record()
            n = k["n_bound"]
            if not meter.ff_passes or n > max(x[1] for x in meter.ff_passes):
                meter.ff_largest = (a, k)
            meter.ff_passes.append((ev, n))
            return out

        self.base._mc_sensitivity = mc
        self.base._replicas = timed("noise", saved["replicas"])
        self.ca._greedy_batched = timed("pass", greedy)
        mod.stage = timed("stage", saved["stage"])
        mod.first_fit_cuda_batched = timed("pass", ffb)
        return self

    def __exit__(self, *exc):
        self.base._mc_sensitivity = self.saved["mc"]
        self.base._replicas = self.saved["replicas"]
        self.ca._greedy_batched = self.saved["greedy"]
        self.mod.stage = self.saved["stage"]
        self.mod.first_fit_cuda_batched = self.saved["ffb"]

    def part_sums(self):
        """Seconds summed over the gated ticks, by part."""
        out = {k: sum(p.get(k, 0.0) for p in self.parts)
               for k in ("noise", "stage", "pass", "total")}
        out["fetch_unpad"] = (out["total"] - out["noise"] - out["stage"]
                              - out["pass"])
        return out


def numpy_metrics(cli, policy, n_apps, market, cluster_cfg):
    """``des_metrics`` of the un-gated arm on ``--device numpy``, same
    trace, cluster, seed and market."""
    import dataclasses

    from pivot_tpu_torch.experiments.calibrate import des_metrics
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.utils.config import build_cluster, make_policy

    arm = dataclasses.replace(cli._SENSITIVITY_ARMS[policy][0],
                              device="numpy")
    run = ExperimentRun("numpy", build_cluster(cluster_cfg),
                        make_policy(arm), TRACE, n_apps=n_apps, seed=0,
                        interval=5.0, market=market)
    return des_metrics(run.run(), run.schedule)


def phase_sensitivity(device, n_hosts=600, apps=None):
    """The ``sensitivity`` experiment through the port's CLI under a
    seeded spot market: the Cost-Aware arm (every gated tick one
    R = 256 launch of ``greedy_place``, each held against the plain
    version after the run) and the VBP arm (every gated tick one R = 256
    launch of ``carry_free_place``; every launch of its runs held against
    the plain form after the run), each baseline against a numpy run of
    the same seed and market."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.infra.market import MarketSchedule
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.ops import kernels as pk
    from pivot_tpu_torch.sched import cuda as cuda_mod
    from pivot_tpu_torch.utils.config import build_cluster
    from pivot_tpu_torch.workload.trace import load_trace_jobs

    apps = apps or SENS_APPS
    res = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        job_dir = os.path.join(tmp, "jobs")
        os.makedirs(job_dir)
        os.symlink(os.path.abspath(TRACE),
                   os.path.join(job_dir, os.path.basename(TRACE)))
        market_path = os.path.join(tmp, "market.json")
        argv = sensitivity_argv(tmp, job_dir, "cost-aware",
                                apps["cost-aware"], market_path, n_hosts)
        args = cli.parse_args(argv)
        cluster_cfg = cli._cluster_config(args)
        bins = load_trace_jobs(TRACE, args.scale_factor).take(
            apps["cost-aware"]).bins
        horizon = bins[-1][0] - bins[0][0]  # the last submission instant
        market = MarketSchedule.generate(build_cluster(cluster_cfg).meta,
                                         seed=0, horizon=horizon,
                                         n_segments=8)
        market.save(market_path)
        log(f"  market: {market.n_segments} segments over {horizon!r} s "
            f"(MarketSchedule.generate, seed 0), {len(market.zones)} zones")
        for policy, n_apps in apps.items():
            argv = sensitivity_argv(os.path.join(tmp, policy), job_dir,
                                    policy, n_apps, market_path, n_hosts)
            with CarryFreeTap(cuda_mod, ck) as cft, \
                    GateMeter(cuda_mod) as gm:
                ck.reset_launches()  # this path's count starts here
                t0 = time.perf_counter()
                report = cli.run_sensitivity(cli.parse_args(argv),
                                             torch_device=device)
                wall = time.perf_counter() - t0
                launches = dict(ck.LAUNCHES_BY_REPLICAS)
                cf_launches = cf_counts(ck)
            seed = report["per_seed"][0]
            gate = seed["gate"]
            want = numpy_metrics(cli, policy, n_apps, market, cluster_cfg)
            for k in METRICS:
                got = seed["baseline"][k]
                if not (np.isfinite(got) and np.isfinite(seed["gated"][k])):
                    raise AssertionError(f"{policy}: {k} not finite")
                if abs(got - want[k]) > 0.005 * max(abs(got), abs(want[k])):
                    raise AssertionError(
                        f"{policy} baseline {k}={got!r} is more than 0.5% "
                        f"from numpy's {want[k]!r}")
            log(f"  {policy}, {n_hosts} hosts x {n_apps} apps, R="
                f"{SENS_REPLICAS}: {gate['ticks']} gated ticks, "
                f"{gate['held']} held, {gate['forced_through']} forced "
                f"through, mean stability {gate['mean_stability']!r}, min "
                f"{gate['min_stability']!r}")
            log(f"    baseline cuda vs numpy: " + ", ".join(
                f"{k} {seed['baseline'][k]!r} / {want[k]!r}"
                for k in METRICS))
            log(f"    gated: " + ", ".join(
                f"{k} {seed['gated'][k]!r}" for k in METRICS))
            wall_per_tick = gate["sensitivity_wall_s"] / gate["ticks"]
            parts = gm.part_sums()
            log(f"    walls: baseline {seed['baseline_wall_s']!r} s, gated "
                f"{seed['gated_wall_s']!r} s, both with the report "
                f"{wall!r} s; sensitivity_wall_per_tick_s "
                f"{gate['sensitivity_wall_per_tick_s']!r} (unrounded "
                f"{wall_per_tick!r}); per gated tick, host ms: " + ", ".join(
                    f"{k} {v * 1e3 / gate['ticks']!r}"
                    for k, v in parts.items()))
            r = dict(report=report, wall=wall, launches=launches,
                     cf_launches=cf_launches, numpy=want, parts=parts,
                     ticks=gate["ticks"])
            if policy == "cost-aware" and cf_launches:
                raise AssertionError(f"cost-aware: carry_free_place "
                                     f"launches {cf_launches}")
            if policy == "cost-aware":
                if not (launches.get(SENS_REPLICAS) == gate["ticks"]
                        == len(gm.calls) > 0 and launches.get(1, 0) > 0
                        and set(launches) == {1, SENS_REPLICAS}):
                    raise AssertionError(
                        f"gated ticks {gate['ticks']} vs launches "
                        f"{launches}: not one R={SENS_REPLICAS} launch a "
                        "gated tick")
                for a, _k, _out in gm.calls:
                    if tuple(a[0].shape) != (SENS_REPLICAS, n_hosts, 4):
                        raise AssertionError(f"gated launch of shape "
                                             f"{tuple(a[0].shape)}")
                chk = Check()
                for i, (a, k, out) in enumerate(gm.calls):
                    chk.same(out, ck.cost_aware_plain_batched(*a, **k),
                             ("gated tick", i))
                log(f"    shadow: all {chk.cases} R={SENS_REPLICAS} launches "
                    f"equal to cost_aware_plain_batched ({chk.placed} "
                    f"placements), max |avail diff| {chk.max_abs_err!r}; "
                    f"launches R=1 {launches[1]}, R={SENS_REPLICAS} "
                    f"{launches[SENS_REPLICAS]}")
                r.update(check=chk, calls=gm.calls)
            else:
                if (launches or len(gm.ff_passes) != gate["ticks"]
                        or cf_launches.get(f"first-fit/R={SENS_REPLICAS}")
                        != gate["ticks"]
                        or not cf_launches.get("first-fit/R=1")
                        or set(cf_launches) != {
                            "first-fit/R=1", f"first-fit/R={SENS_REPLICAS}"}):
                    raise AssertionError(
                        f"VBP: {len(gm.ff_passes)} batched passes for "
                        f"{gate['ticks']} gated ticks, greedy_place "
                        f"launches {launches}, carry_free_place launches "
                        f"{cf_launches}")
                cf_chk = Check()
                held = cft.hold(cf_chk, "VBP sensitivity")  # after the run
                if held != sum(cf_launches.values()):
                    raise AssertionError(f"VBP: {held} carry_free_place "
                                         f"launches recorded, {cf_launches} "
                                         "counted")
                log(f"    carry_free_place: {cf_launches['first-fit/R=1']} "
                    f"R=1 launches (per-tick and span ticks of the baseline "
                    f"and gated runs) and "
                    f"{cf_launches[f'first-fit/R={SENS_REPLICAS}']} "
                    f"R={SENS_REPLICAS} launches (one a gated tick), each "
                    f"held against its plain form, {cf_chk.placed} "
                    f"placements, max |avail diff| {cf_chk.max_abs_err!r}")
                r["cf_check"] = cf_chk
                torch.cuda.synchronize()
                ms = [ev[0].elapsed_time(ev[1]) for ev, _n in gm.ff_passes]
                steps = [n for _ev, n in gm.ff_passes]
                (avail_r, dem, valid), k = gm.ff_largest
                got = pk.first_fit_batched(avail_r, dem, valid, **k)
                chk = Check()
                for row in range(4):
                    want_row = pk.first_fit_impl(
                        avail_r[row], dem, valid, strict=k["strict"],
                        risk=k["risk"])
                    chk.same((got[0][row], got[1][row]), want_row,
                             ("vbp row", row))
                r.update(ms_median=statistics.median(ms), ms_max=max(ms),
                         ms_sum=sum(ms), steps_median=statistics.median(
                             steps), steps_max=max(steps), check=chk)
                log(f"    batched First-Fit pass (R={SENS_REPLICAS}, H="
                    f"{n_hosts}, CUDA events): median {r['ms_median']!r} ms "
                    f"a tick at median {r['steps_median']} steps, largest "
                    f"{r['ms_max']!r} ms, sum {r['ms_sum']!r} ms over "
                    f"{len(ms)} ticks; largest tick ({max(steps)} steps) rows "
                    f"0-3 equal to the unbatched pass")
            res[policy] = r
    return res


def gated_times(ck, calls):
    """Wrapper ms and bare-launch ``kernel_ms`` of every recorded gated
    launch, by CUDA events, and the largest launch's bound and plain
    time."""
    wrapper = [_events_ms(lambda: ck.cost_aware_cuda_batched(*a, **k), 3)
               for a, k, _o in calls]
    kernel_ = [_events_ms(bare_launch(ck, list(a), k)[0], 3)
               for a, k, _o in calls]
    n_eff = [k["n_eff"] for _a, k, _o in calls]
    big = max(range(len(calls)), key=n_eff.__getitem__)
    a, k, _o = calls[big]
    b_ms, b_by = bound(list(a), k, a[0].shape[0], n_eff[big])
    return dict(
        ms_median=statistics.median(wrapper), ms_max=max(wrapper),
        ms_sum=sum(wrapper), kernel_ms_median=statistics.median(kernel_),
        kernel_ms_max=max(kernel_), kernel_ms_sum=sum(kernel_),
        n_eff_median=statistics.median(n_eff), largest=dict(
            n_eff=n_eff[big], ms=wrapper[big], kernel_ms=kernel_[big],
            plain_ms=_host_ms(lambda: ck.cost_aware_plain_batched(*a, **k),
                              1),
            bound_ms=b_ms, bound_by=b_by))


def _events_ms(fn, reps) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps) -> float:
    """Mean wall ms of ``fn`` (synchronised) — for the plain version,
    whose Python loop sets its pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound(args, kw, R, n_eff):
    """Least time for one call of the wrapper at these inputs: the larger
    of the bytes over HBM bandwidth and the operations over the f32 peak.
    Bytes: each of the function's own inputs read once — availability
    ``[R, H, 4]``, the task stream up to ``n_eff`` (demands, valid,
    new_group, anchor_zone), the ``[Z, Z]`` cost and bandwidth tables,
    host_zone and the base counts ``[H]``, live / risk when given — and
    each output written once (placements ``[R, T]``, availability).
    Operations: building the two ``[Z, H]`` round-trip tables (one add
    per entry each), then per host and replica the fit test, select and
    min (6) every step, plus the first-fit group score at each group
    entry (10, +1 decay, +1 risk) or the best-fit score every step (15,
    +2 decay, +1 risk).

    This is PERF.md's bound of a kernel — what the function must move and
    compute on its actual inputs — not ``infra/roofline.py``'s
    ``placement_cost``, the dispatch profiler's trend-level work model of
    a placement call; the two share only the peak constants, which live
    in ``infra/roofline.py``."""
    avail, dem, ng, cost_zz = args[0], args[1], args[3], args[5]
    H, T, nz = avail.shape[-2], dem.shape[0], cost_zz.shape[0]
    first_fit = kw.get("bin_pack", "first-fit") == "first-fit"
    decay = kw.get("host_decay", False)
    risk = kw.get("risk") is not None
    nbytes = (2 * R * H * 16 + n_eff * (16 + 1 + 1 + 4) + 2 * nz * nz * 4
              + H * 4 + H * 4 + R * T * 4 + (H * 4 if risk else 0)
              + (H if kw.get("live") is not None else 0))
    if first_fit:
        entries = int(ng[:n_eff].sum()) if kw.get("sort_hosts", True) else 0
        per_host = 6 * n_eff + (10 + decay + risk) * entries
    else:
        per_host = (6 + 15 + 2 * decay + risk) * n_eff
    ops = 2 * nz * H + R * H * per_host
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_times(ck, shadow, device):
    """Device time of the wrapper the main path calls (phase 1 and the
    ``greedy_place`` launch), by CUDA events; the plain version by host
    clock around a synchronised call."""
    def wrapper(args, kw):
        fn = (ck.cost_aware_cuda if args[0].dim() == 2
              else ck.cost_aware_cuda_batched)
        return lambda: fn(*args, **kw)

    def kernel(args, kw, n_eff, reps):
        """``kernel_ms`` (the bare launch) and its ns per task step."""
        ms = _events_ms(bare_launch(ck, args, kw)[0], reps)
        return dict(kernel_ms=ms, ns_per_step=ms * 1e6 / max(n_eff, 1))

    times = {}
    per_tick = [_events_ms(wrapper(a, k), 5) for a, k in shadow.ticks]
    n_tasks = [k["n_eff"] for _a, k in shadow.ticks]
    times["tick_median_ms"] = statistics.median(per_tick)
    times["tick_sum_ms"] = sum(per_tick)
    per_span_tick = [_events_ms(wrapper(a, k), 5) for a, k in
                     shadow.span_ticks]
    times["span_tick_median_ms"] = statistics.median(per_span_tick)
    times["span_tick_sum_ms"] = sum(per_span_tick)
    times["span_tick_n_eff_median"] = statistics.median(
        k["n_eff"] for _a, k in shadow.span_ticks)
    times["tick_n_eff_median"] = statistics.median(n_tasks)
    med = sorted(range(len(n_tasks)), key=per_tick.__getitem__)[
        len(n_tasks) // 2]
    times["tick_median_kernel"] = kernel(*shadow.ticks[med],
                                         n_tasks[med], 20)
    big = max(range(len(n_tasks)), key=n_tasks.__getitem__)
    a, k = shadow.ticks[big]
    times["largest_tick"] = dict(
        n_eff=n_tasks[big], bucket=a[1].shape[0], H=a[0].shape[0],
        ms=_events_ms(wrapper(a, k), 20), **kernel(a, k, n_tasks[big], 20),
        plain_ms=_host_ms(lambda: ck.cost_aware_plain(*a, **k), 3),
        max_abs_err=shadow.check.max_abs_err,
    )
    times["largest_tick"]["bound_ms"], times["largest_tick"]["bound_by"] = \
        bound(a, k, 1, n_tasks[big])
    mode = MODES[0]  # the Cost-Aware arm's mode (first-fit, sorted hosts)
    shapes = {}
    for T in (619, 2048):
        args = make_inputs(5, T, 600, device)
        b_ms, b_by = bound(args, mode, 1, T)
        shapes[f"T{T}_H600"] = (args, 1, T)
        times[f"T{T}_H600"] = dict(
            ms=_events_ms(wrapper(args, mode), 20), **kernel(args, mode, T, 20),
            plain_ms=_host_ms(lambda: ck.cost_aware_plain(*args, **mode), 3),
            bound_ms=b_ms, bound_by=b_by)
    args = make_inputs(6, 619, 600, device)
    noise = torch.from_numpy(np.random.default_rng(9).uniform(
        0.95, 1.05, (256, 600, 1)).astype(np.float32)).to(device)
    args[0] = (args[0][None] * noise).contiguous()
    b_ms, b_by = bound(args, mode, 256, 619)
    shapes["R256_T619_H600"] = (args, 256, 619)
    times["R256_T619_H600"] = dict(
        ms=_events_ms(wrapper(args, mode), 5), **kernel(args, mode, 619, 10),
        plain_ms=_host_ms(lambda: ck.cost_aware_plain_batched(
            *args, **mode), 1),
        bound_ms=b_ms, bound_by=b_by)
    # Where a step's time goes (default shape, T = 2048, H = 600, dense):
    # first-fit with one group entry, the main path's shape; a group entry
    # at every task, which puts K scores per thread on the chain; best-fit,
    # which scores every host every step.
    args = make_inputs(7, 2048, 600, device, dense=True)
    args[3] = torch.zeros_like(args[3])
    args[3][0] = True
    every = list(args)
    every[3] = torch.ones_like(args[3])
    times["step_ns"] = {
        name: kernel(a, kw, 2048, 10)["ns_per_step"] for name, a, kw in (
            ("first-fit, one entry", args, mode),
            ("first-fit, entry every task", every, mode),
            ("best-fit", args, MODES[3]))}
    entries = sum(int(a[3][:k["n_eff"]].sum()) for a, k in shadow.ticks)
    times["main_path_entry_share"] = entries / sum(n_tasks)
    # The sweep that sets _launch_config: warps per replica at H = 600.
    times["sweep"] = {}
    for key, (args, R, T) in shapes.items():
        row = {}
        for warps in SWEEP_WARPS:
            go, cfg = bare_launch(ck, args, mode, warps)
            row[warps] = dict(K=cfg.hosts_per_thread, groups=cfg.groups,
                              kernel_ms=_events_ms(go, 10 if R > 1 else 20))
        times["sweep"][key] = dict(
            default_warps=ck._launch_config(R, 600, Z).warps, by_warps=row)
    return times


def profile_kernels(ck, shadow, calls=10):
    """Device kernels ``torch.profiler`` records over ``calls`` wrapper
    calls at the largest tick: ``(greedy_place kernels, all kernels)``,
    or None when it records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    n_tasks = [k["n_eff"] for _a, k in shadow.ticks]
    a, k = shadow.ticks[max(range(len(n_tasks)), key=n_tasks.__getitem__)]
    ck.cost_aware_cuda(*a, **k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ck.cost_aware_cuda(*a, **k)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return None
    return sum("greedy_place" in n for n in names), len(names)


ENS_REPLICAS = 1024
ENS_CHECK_REPLICAS = 16
ENS_SMALL_REPLICAS = 4  # the card-vs-CPU check of the other arms
ENS_CPU_REPLICAS = 4  # the cost-aware check against the port on the CPU
ENS_ARMS = ("cost-aware", "first-fit")
ENS_FIXTURE = "tests/data/ensemble_r16_seed0.npz"
ENS_FIELDS = ("makespan", "egress_cost", "finish_time", "placement",
              "n_unfinished", "instance_hours")
ENS_RTOL = 1e-5


def ensemble_argv(out, *extra):
    return ["--job-dir", "data/jobs", "--output-dir", out, "ensemble", *extra]


def ensemble_inputs(cli, device, n_apps=None):
    """The ``ensemble`` defaults' rollout inputs on ``device`` (float32)
    and the parsed defaults."""
    from pivot_tpu_torch.experiments.calibrate import (
        ensemble_inputs_from_schedule,
    )
    from pivot_tpu_torch.workload.trace import load_trace_jobs

    args = cli.parse_args(ensemble_argv("unused"))
    trace = cli._list_traces(args.job_dir, 1)[0]
    sched = load_trace_jobs(trace, args.scale_factor).take(
        n_apps or args.num_apps)
    workload, _sl, _arr, topo, avail0, sz = ensemble_inputs_from_schedule(
        sched, cli.build_cluster(cli._cluster_config(args)),
        dtype=torch.float32, device=device)
    return args, (avail0, workload, topo, sz)


def ensemble_compare(got, want, what, rows=None) -> float:
    """Placements, finish times, makespans, instance-hours and unfinished
    counts equal; egress within ``ENS_RTOL`` (a GEMM whose rounding
    differs between cuBLAS and XLA:CPU).  Returns egress's largest
    relative difference."""
    worst = 0.0
    for f in ENS_FIELDS:
        if f not in got or f not in want:
            continue
        g = np.asarray(got[f])[:rows]
        w = np.asarray(want[f])[:rows]
        if g.shape != w.shape:
            raise AssertionError(f"{what}: {f} shape {g.shape} vs {w.shape}")
        if f == "egress_cost":
            rel = np.abs(g.astype(np.float64) - w) / np.maximum(
                np.abs(w.astype(np.float64)), 1e-30)
            worst = max(worst, float(rel.max(initial=0.0)))
            if not np.allclose(g, w, rtol=ENS_RTOL, atol=0):
                raise AssertionError(f"{what}: {f} beyond rtol {ENS_RTOL} "
                                     f"(largest {rel.max()!r})")
        elif not np.array_equal(g, w):
            bad = np.argwhere(g != w)
            raise AssertionError(f"{what}: {f} differs at {len(bad)} "
                                 f"entries, first {bad[0].tolist()}")
    return worst


def _result(res) -> dict:
    return {f: getattr(res, f).cpu().numpy() for f in res._fields}


def cpu_side_cores(cores) -> tuple:
    """``(worker's, main process's)`` cores for ``cpu_side``: the last
    quarter of ``cores`` (at least one) for the worker, the rest for the
    main process; both all of them on a one-core host."""
    cores = sorted(cores)
    n = max(1, len(cores) // 4) if len(cores) > 1 else 0
    return (set(cores[-n:]) if n else set(cores),
            set(cores[:-n]) if n else set(cores))


def set_process_affinity(cpus) -> None:
    """Every thread of this process onto ``cpus`` (``sched_setaffinity``
    of pid 0 moves only the calling thread)."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:  # a thread that has ended
            pass


def _cpu_side_init(cpus, n_threads) -> None:
    set_process_affinity(cpus)
    torch.set_num_threads(n_threads)


@contextlib.contextmanager
def cpu_side(jobs):
    """The CPU sides of card-vs-CPU checks in one spawned worker process
    (``side_workers``: those of phases 6-9): it runs the port on the CPU
    while the card runs the phases' other work (those CPU runs took ~40%
    of phases 6-9's walls, one after another with the card's).  ``jobs`` are ``(function, *args)`` tuples
    of top-level functions; yields their futures, in order; the block's
    end waits for (and stops) the worker.  The worker runs on its own
    cores (``cpu_side_cores``: 2 of 8) and the main process keeps off
    them until the block ends, so the card's host loop and the timed
    windows of the block do not share a core with it.  It keeps the main
    process's torch thread count, so the CPU side's results stay as they
    were, and its OpenMP threads wait passively (``OMP_WAIT_POLICY``,
    read when the worker starts) on its two cores."""
    import concurrent.futures as cf
    import multiprocessing as mp

    cores = os.sched_getaffinity(0)
    side, main_cores = cpu_side_cores(cores)
    old = os.environ.get("OMP_WAIT_POLICY")
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    try:
        pool = cf.ProcessPoolExecutor(
            max_workers=1, mp_context=mp.get_context("spawn"),
            initializer=_cpu_side_init,
            initargs=(side, torch.get_num_threads()))
        # A spawn-context pool starts its worker inside the first submit.
        futures = [pool.submit(fn, *args) for fn, *args in jobs]
    finally:
        if old is None:
            os.environ.pop("OMP_WAIT_POLICY")
        else:
            os.environ["OMP_WAIT_POLICY"] = old
    set_process_affinity(main_cores)
    try:
        with pool:
            yield futures
    finally:
        set_process_affinity(cores)


def ens_rollout(device, n_apps, policy, n_replicas, tick_order=None):
    """``rollout`` of the ``ensemble`` defaults' inputs (``n_apps`` apps,
    the defaults' own when None) on ``device``: ``(result, seconds,
    ticks)`` (the CPU sides of phase 6 (b) and (d) on the worker, the
    card side of (d) in the card pool)."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.parallel.ensemble import prng, rollout

    args, inputs = ensemble_inputs(cli, device, n_apps=n_apps)
    st = {}
    t0 = time.perf_counter()
    res = _result(rollout(
        prng.PRNGKey(args.seed), *inputs, policy=policy,
        n_replicas=n_replicas, tick=args.tick, max_ticks=args.max_ticks,
        perturb=args.perturb, tick_order=tick_order or args.tick_order,
        stats=st))
    return res, time.perf_counter() - t0, st["ticks"]


def sync_debug(fn):
    """``fn()`` under torch's sync debug mode: ``(its value, the
    synchronizing calls flagged)``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            value = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return value, sum("synchroniz" in str(w.message) for w in caught)


#: Processes of the card pool at most (beside the main process).
CARD_POOL_WORKERS = 5


def _card_pool_init(n_threads) -> None:
    torch.set_num_threads(n_threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _card_pool_job(fn, device, *args):
    """One run of the card pool: ``(fn's value, greedy_place launches)``."""
    from pivot_tpu_torch.ops import cuda_kernels as ck

    ck.reset_launches()
    value = fn(device, *args)
    return value, ck.LAUNCHES["greedy_place"]


def card_pool_jobs(phases) -> dict:
    """The untimed card runs of phases 6, 7 and 9 (their checks against
    ``pivot_tpu``'s fixtures and against the port on the CPU) for the
    ``phases`` selected: ``{key: (function, *args)}``, the longest
    first.  Each function takes the device first and is top-level."""
    jobs = {}
    if 7 in phases:
        jobs.update({(7, "fixture", n): (sw_fixture_run, n)
                     for n in sw_cases() if n.startswith("fault__")})
    if 16 in phases and phases & {6, 7, 9}:
        # Phase 16's untimed runs; the first of phases 6, 7 and 9 waits
        # for them before it times anything.
        jobs[16, "rollout"] = (p16_rollout_ref,)
        jobs.update({(16, "faults", sharded): (p16_faults, sharded)
                     for sharded in (True, False)})
        jobs[16, "capacity"] = (p16_capacity,)
    if 9 in phases:
        jobs[9, "resume", True] = (cg_resume_run, True)
        jobs[9, "resume", False] = (cg_resume_run, False)
        jobs.update({(9, "small", i): (cg_small_run, i)
                     for i in range(len(CG_SMALL))})
    if 7 in phases:
        jobs.update({(7, "fixture", n): (sw_fixture_run, n)
                     for n in sw_cases() if not n.startswith("fault__")})
    if 6 in phases:
        jobs.update({(6, "small", arm, order): (
            ens_rollout, 10, arm, ENS_SMALL_REPLICAS, order)
            for arm, order in ENS_SMALL})
    if 7 in phases:
        jobs.update({(7, "small", n): (sw_small_run, n) for n in SW_SMALL})
    return jobs


def cpu_side_jobs(phases) -> dict:
    """The CPU sides of the card-vs-CPU checks of phases 6-9 for the
    ``phases`` selected: ``{key: (function, *args)}``, in phase order (one
    worker runs them one after another, each before its phase needs
    it)."""
    jobs = {}
    if 6 in phases:
        jobs[6, "b"] = (ens_rollout, "cpu", None, "cost-aware",
                        ENS_CPU_REPLICAS)
        jobs.update({(6, "d", arm, order): (
            ens_rollout, "cpu", 10, arm, ENS_SMALL_REPLICAS, order)
            for arm, order in ENS_SMALL})
    if 7 in phases:
        jobs.update({(7, "c", n): (sw_small_run, "cpu", n)
                     for n in SW_SMALL})
    if 8 in phases:
        jobs[8, "c"] = (cpu_sr_check,)
    if 9 in phases:
        jobs.update({(9, "c", i): (cg_small_run, "cpu", i)
                     for i in range(len(CG_SMALL))})
    return jobs


@contextlib.contextmanager
def side_workers(phases, device):
    """The side processes of phases 6-9 (those of ``phases``): one
    ``cpu_side`` worker for the CPU sides of their card-vs-CPU checks
    (across the phases: each phase's card work alone is shorter than its
    CPU side) and a started ``CardPool`` for their untimed card runs.
    Yields ``(pool, cpu)``, ``cpu`` mapping ``cpu_side_jobs``' keys to
    futures; the block's end stops both."""
    jobs = cpu_side_jobs(phases)
    with cpu_side(list(jobs.values())) as futures:
        pool = CardPool(card_pool_jobs(phases), device)
        try:
            pool.start()
            yield pool, dict(zip(jobs, futures))
        finally:
            pool.close()


class CardPool:
    """The untimed card runs of phases 6, 7 and 9 in spawned processes
    that share the card with the main process.  Those loops are bound by
    the host's issue of small launches, and the card idles most of the
    time, so five processes finish them ~3x sooner than one.  The first
    of those phases calls ``start`` inside its ``cpu_side`` block (the
    workers inherit the main process's cores) and ``wait`` before
    anything it times: ``wait`` collects every result and stops the
    processes, so no second process runs beside a timed window.  A run's
    own wall in the pool is not a time of the card alone."""

    def __init__(self, jobs, device):
        self.jobs = dict(jobs)
        self.device = str(device)
        self.pool = None
        self.futures = {}
        self.results = {}
        self.workers = 0

    def start(self) -> None:
        import concurrent.futures as cf
        import multiprocessing as mp

        if not self.jobs:
            return
        self.workers = max(1, min(CARD_POOL_WORKERS, len(self.jobs),
                                  len(os.sched_getaffinity(0)) - 1))
        self.t0 = time.perf_counter()
        # The main process's thread count keeps any host-side reduction
        # as it was; its OpenMP threads wait passively (read as a worker
        # starts, inside the first submits).
        old = os.environ.get("OMP_WAIT_POLICY")
        os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
        try:
            self.pool = cf.ProcessPoolExecutor(
                max_workers=self.workers, mp_context=mp.get_context("spawn"),
                initializer=_card_pool_init,
                initargs=(torch.get_num_threads(),))
            self.futures = {k: self.pool.submit(_card_pool_job, fn,
                                                self.device, *args)
                            for k, (fn, *args) in self.jobs.items()}
        finally:
            if old is None:
                os.environ.pop("OMP_WAIT_POLICY")
            else:
                os.environ["OMP_WAIT_POLICY"] = old

    def wait(self) -> None:
        """Every run's value, then the processes stopped (a no-op once
        done)."""
        if self.pool is None:
            return
        try:
            for key, fut in self.futures.items():
                self.results[key], launched = fut.result()
                if launched:
                    raise AssertionError(f"the card pool's run {key} "
                                         f"launched greedy_place {launched} "
                                         "times")
            self.pool.shutdown(wait=True)
            self.pool = None
        finally:
            self.close()
        phases = sorted({k[0] for k in self.jobs})
        log(f"  card pool: {len(self.jobs)} untimed runs of phases "
            f"{', '.join(map(str, phases))} (checks against pivot_tpu's "
            f"fixtures and the CPU) in {self.workers} processes beside this "
            f"one: {time.perf_counter() - self.t0!r} s; nothing timed ran "
            "beside them")

    def close(self) -> None:
        """Stop the processes, ending any run still going."""
        if self.pool is None:
            return
        pool, self.pool = self.pool, None
        procs = list((getattr(pool, "_processes", None) or {}).values())
        pool.shutdown(wait=False, cancel_futures=True)
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        for proc in procs:
            proc.join()

    def __getitem__(self, key):
        return self.results[key]


#: Phase 6 (e): the profiled window's first tick (cut from 600 to 300 for
#: phase 13 and to 100 for the script's 1,200 s on slower machines: the
#: unprofiled ticks before it are walked again for each arm) and its
#: length (cut from 50 to 25 for phase 14).
ENS_PROFILE_SKIP = 100
ENS_PROFILE_WINDOW = 25


def ensemble_profile(on_card, args, key, policy, skip=ENS_PROFILE_SKIP,
                     window=ENS_PROFILE_WINDOW):
    """Device time by operator over ``window`` ticks of the R = 1024 tick
    loop, after ``skip`` unprofiled ticks (the middle of the run, where
    the cluster is loaded), by ``torch.profiler``: the window's host wall
    (the profiler's own host overhead in it), the device's busy time
    summed over its kernels, their ratio (the busy share) and the ten
    largest operators by self device time.  ``None`` when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    from pivot_tpu_torch.parallel.ensemble import (
        _init_state,
        _perturbations,
        _rollout_segment,
    )

    avail0, workload, topo, sz = on_card
    rt, arr, anchor = _perturbations(key, workload, sz, ENS_REPLICAS,
                                     args.perturb, avail0.dtype)
    state = _init_state(avail0, workload.n_tasks, topo.cost.shape[0],
                        ENS_REPLICAS)
    kw = dict(totals=avail0, policy=policy, tick_order=args.tick_order)
    state = _rollout_segment(state, rt, arr, anchor, workload, topo,
                             args.tick, skip, **kw)
    st = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _rollout_segment(state, rt, arr, anchor, workload, topo, args.tick,
                         window, stats=st, **kw)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    # Kernels are device events; operators are host events charged with
    # the device time of the kernels they launch.
    total = sum(dev_us(e) for e in events
                if str(e.device_type).endswith("CUDA")) / 1e3
    ops = [(e.key, dev_us(e) / 1e3, e.count) for e in events
           if not str(e.device_type).endswith("CUDA")]
    if not total:
        return None
    ops.sort(key=lambda r: -r[1])
    return dict(policy=policy, ticks=st["ticks"],
                place_steps=st["place_steps"], wall_ms=wall_ms,
                device_busy_ms=total, busy_share=total / wall_ms,
                top=[dict(op=k, ms=ms, calls=c) for k, ms, c in ops[:10]])


def phase_ensemble(device, pool, cpu):
    """Phase 6: the Monte-Carlo ensemble on the card.  The refund's sum
    order and (c) the R = 16 runs against ``pivot_tpu``'s fixture first
    (they also warm the card up), while ``pool`` (``side_workers``'
    ``CardPool``) runs the untimed card runs of the phases selected,
    (d)'s among them; then (a) the main path, the CLI at R = 1024 for
    the cost-aware and first-fit arms; (e) a profiled window of each;
    (b) the cost-aware run's first ``ENS_CPU_REPLICAS`` replicas against
    the port on the CPU; (d) the other arms and lifo, card against CPU,
    at 10 apps.  ``cpu``: the CPU sides' futures (``side_workers``)."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.parallel.ensemble import prng, rollout

    out = {"checks": {}, "arms": {}}
    args, on_card = ensemble_inputs(cli, device)
    kw = dict(n_replicas=ENS_CHECK_REPLICAS, tick=args.tick,
              max_ticks=args.max_ticks, perturb=args.perturb,
              tick_order=args.tick_order)
    key = prng.PRNGKey(args.seed)
    return _phase_ensemble(device, cli, ck, rollout, out, args, on_card, kw,
                           key, cpu[6, "b"],
                           {(a, o): cpu[6, "d", a, o] for a, o in ENS_SMALL},
                           pool)


#: Phase 6 (d): the other arms and lifo, card against CPU.
ENS_SMALL = (("best-fit", "fifo"), ("opportunistic", "fifo"),
             ("cost-aware", "lifo"), ("first-fit", "lifo"))


def _phase_ensemble(device, cli, ck, rollout, out, args, on_card, kw, key,
                    cpu_b, cpu_d, pool):
    """Phase 6 after its inputs, the CPU sides of (b) and (d) running on
    the worker (``cpu_b``, ``cpu_d``: futures), the card side of (d) in
    ``pool``."""
    # The refund sums each host's retiring tasks in task-index order: the
    # trace's demands are not integers, so that order must hold on the
    # card too (index_put_ with accumulate: sort by row, then one
    # sequential pass per row).
    dem = on_card[1].demands
    rng = np.random.default_rng(0)
    for n_rows in (1, 7, 600, 600 * 64):
        rows = torch.from_numpy(rng.integers(0, n_rows, dem.shape[0]))
        card = torch.zeros((n_rows, 4), device=device).index_put_(
            (rows.to(device),), dem, accumulate=True).cpu()
        cpu = torch.zeros((n_rows, 4)).index_put_(
            (rows,), dem.cpu(), accumulate=True)
        if not torch.equal(card, cpu):
            raise AssertionError(f"refund sums over {n_rows} rows: the card "
                                 "adds in another order than the CPU")
    log("  refund sums of the trace's demands (1 to 38400 rows): the card "
        "equals the CPU bit for bit")
    with np.load(ENS_FIXTURE) as z:
        fixture = {arm: {f: z[f"{arm.replace('-', '_')}__{f}"]
                         for f in ENS_FIELDS} for arm in ENS_ARMS}
    card16 = {}
    chain_chk = ChainCheck()
    for arm in ENS_ARMS:
        st = {}
        n0 = ck.LAUNCHES["ensemble_chain"]
        with ChainTap(ck, chk=chain_chk, what=f"(c) {arm}") as tap:
            res, syncs = sync_debug(lambda: rollout(
                key, *on_card, policy=arm, stats=st, **kw))
        launched = ck.LAUNCHES["ensemble_chain"] - n0
        if not launched == tap.calls == st["ticks"]:
            raise AssertionError(f"(c) {arm}: {launched} ensemble_chain "
                                 f"launches, {tap.calls} calls, "
                                 f"{st['ticks']} ticks")
        card16[arm] = _result(res)
        worst = ensemble_compare(card16[arm], fixture[arm],
                                 f"(c) {arm} card R=16 vs pivot_tpu fixture",
                                 rows=ENS_CHECK_REPLICAS)
        out["checks"][f"{arm}_fixture"] = dict(
            max_rel=worst, ticks=st["ticks"], place_steps=st["place_steps"],
            host_syncs=st["host_syncs"], sync_debug_warnings=syncs,
            wall_s=st["wall_s"], event_span_ms=st["event_span_ms"],
            chain_launches=launched)
        log(f"  (c) {arm} R={ENS_CHECK_REPLICAS} on the card vs pivot_tpu's "
            f"fixture: placements, finish times, makespans, instance-hours, "
            f"unfinished equal; egress largest rel diff {worst!r}; "
            f"{st['ticks']} ticks, {st['place_steps']} placement steps, "
            f"{st['host_syncs']} host reads counted, {syncs} synchronizing "
            f"calls flagged by torch's sync debug mode; {launched} "
            f"ensemble_chain launches (one a tick), each equal to the plain "
            f"chain on its operands")
    out["chain_holds"] = chain_chk.cases
    out["chain_max_abs_err"] = chain_chk.max_abs_err
    log(f"  (c) {chain_chk.cases} ensemble_chain launches held against "
        f"_chain_plain: placements, delays and availability bit for bit "
        f"({chain_chk.placed} placements), max |diff| "
        f"{chain_chk.max_abs_err!r}")
    pool.wait()  # nothing timed before this

    # (a) the main path: the CLI on the card at R = 1024.
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        for arm in ENS_ARMS:
            st = {}
            ck.reset_launches()  # the chain kernel, and no greedy_place
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # The entry must turn TF32 off itself: hand it on.
            torch.backends.cuda.matmul.allow_tf32 = True
            summary = cli.run_ensemble(cli.parse_args(ensemble_argv(
                tmp, "--replicas", str(ENS_REPLICAS), "--policy", arm)),
                stats=st)
            peak = torch.cuda.max_memory_allocated()
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("run_ensemble left TF32 matmuls on")
            if ck.LAUNCHES["greedy_place"]:
                raise AssertionError("the ensemble launched greedy_place")
            chain = ck.LAUNCHES["ensemble_chain"]
            if chain != st["ticks"] or ck.LAUNCHES_CHAIN != {
                    (arm, ENS_REPLICAS): st["ticks"]}:
                raise AssertionError(
                    f"(a) {arm}: {chain} ensemble_chain launches "
                    f"({dict(ck.LAUNCHES_CHAIN)}) for {st['ticks']} ticks")
            with np.load(os.path.join(st["out_dir"], "rollout.npz")) as z:
                got = {k: z[k] for k in z.files}
            T = on_card[1].n_tasks
            if (got["placement"].shape != (ENS_REPLICAS, T)
                    or not np.isfinite(got["makespan"]).all()
                    or not np.isfinite(got["egress_cost"]).all()
                    or summary["unfinished_max"] != 0
                    or not np.isfinite(got["finish_time"]).all()):
                raise AssertionError(f"(a) {arm}: malformed rollout.npz")
            # The draws are prefix-stable: the first 16 replicas are the
            # R = 16 run checked above.
            worst = ensemble_compare(got, card16[arm],
                                     f"(a) {arm} R={ENS_REPLICAS} prefix vs "
                                     f"R={ENS_CHECK_REPLICAS}",
                                     rows=ENS_CHECK_REPLICAS)
            row = dict(
                wall_s=summary["wall_s"],
                replica_rollouts_per_sec=summary["replica_rollouts_per_sec"],
                loop_wall_s=st["wall_s"], event_span_ms=st["event_span_ms"],
                ticks=st["ticks"], place_steps=st["place_steps"],
                host_syncs=st["host_syncs"], peak_mem_bytes=peak,
                chain_launches=chain,
                makespan_mean=summary["makespan_mean"],
                egress_mean=summary["egress_mean"],
                instance_hours_mean=summary["instance_hours_mean"],
                prefix_max_rel=worst)
            out["arms"][arm] = row
            out["makespan_" + arm] = got["makespan"]  # for phase 7
            log(f"  (a) {arm} R={ENS_REPLICAS} through the CLI on the card: "
                f"wall {row['wall_s']!r} s, "
                f"{row['replica_rollouts_per_sec']!r} replica rollouts/s; "
                f"{row['ticks']} ticks, {chain} ensemble_chain launches "
                f"(R={ENS_REPLICAS}, one a tick), "
                f"{row['place_steps']} placement steps, {row['host_syncs']} "
                f"host reads; tick loop {row['loop_wall_s']!r} s on the host "
                f"clock, {row['event_span_ms']!r} ms of stream time between "
                f"CUDA events (idle gaps included: not busy time); peak "
                f"memory {peak / 2**30!r} GiB; rows 0-"
                f"{ENS_CHECK_REPLICAS - 1} equal the R={ENS_CHECK_REPLICAS} "
                f"run (rel diff {worst!r}); makespan mean "
                f"{row['makespan_mean']!r} s, egress mean "
                f"{row['egress_mean']!r} $, instance-hours mean "
                f"{row['instance_hours_mean']!r}")

    # (e) where the device time of a loaded tick goes.  A first session of
    # one tick, not reported, pays the profiler's own start-up, which
    # otherwise lands in the first arm's window (9.04 s of its 25 ticks'
    # wall on an H100, PERF.md §6).
    ensemble_profile(on_card, args, key, ENS_ARMS[0], skip=1, window=1)
    for arm in ENS_ARMS:
        prof = ensemble_profile(on_card, args, key, arm)
        out["profile_" + arm] = prof
        if prof is None:
            log(f"  (e) {arm}: torch.profiler recorded no device time: "
                "not measured")
            continue
        log(f"  (e) {arm} R={ENS_REPLICAS}, ticks {ENS_PROFILE_SKIP}-"
            f"{ENS_PROFILE_SKIP + prof['ticks']}"
            f" under torch.profiler: {prof['wall_ms']!r} ms of host wall "
            f"(profiler overhead included), device busy "
            f"{prof['device_busy_ms']!r} ms = {prof['busy_share']!r} of it, "
            f"{prof['place_steps']} placement steps; largest: " + ", ".join(
                f"{r['op']} {r['ms']!r} ms / {r['calls']}"
                for r in prof["top"]))

    # (b) the first replicas against the port on the CPU (prefix-stable).
    cpu_res, cpu_s, _ticks = cpu_b.result()
    worst = ensemble_compare(card16["cost-aware"], cpu_res,
                             f"(b) cost-aware card R={ENS_CPU_REPLICAS} vs "
                             "the port on the CPU", rows=ENS_CPU_REPLICAS)
    out["checks"]["cost-aware_cpu"] = dict(max_rel=worst, cpu_wall_s=cpu_s)
    log(f"  (b) cost-aware, the card's first {ENS_CPU_REPLICAS} replicas vs "
        f"the port on the CPU ({cpu_s!r} s there): placements, finish "
        f"times, makespans, instance-hours, unfinished equal; egress "
        f"largest rel diff {worst!r}")

    # (d) the other arms and lifo, card (in the pool) vs CPU, at 10 apps.
    for arm, order in ENS_SMALL:
        got, _s, ticks = pool[6, "small", arm, order]
        worst = ensemble_compare(got, cpu_d[arm, order].result()[0],
                                 f"(d) {arm} {order} card vs CPU at 10 apps")
        if got["n_unfinished"].max() != 0:
            raise AssertionError(f"(d) {arm} {order}: tasks unfinished")
        out["checks"][f"{arm}_{order}_10apps"] = dict(max_rel=worst,
                                                      ticks=ticks)
        log(f"  (d) {arm} {order}, 10 apps "
            f"({got['placement'].shape[-1]} tasks), R={ENS_SMALL_REPLICAS}: "
            f"card equals CPU, rel diff {worst!r}, {ticks} ticks")

    return out


#: Phase 7: the fixture ``pivot_tpu`` wrote (``tests/test_torch_sweeps_
#: fixture.py::make_fixture``) and the configuration of each entry.
SW_FIXTURE = "tests/data/ensemble_sweeps_seed0.npz"
SW_FAULT_ARMS = ("cost-aware", "first-fit")
SW_FAULT_REPLICAS = 16
SW_FAULTS = dict(n_faults=4, mttr=300.0)
SW_APPS = 10
SW_REPLICAS = 4
SW_EXPONENTS = (0.5, 2.0)
SW_HOST_COUNTS = (100, 300, 600)
SW_APP_COUNTS = (3, 6, 10)
SW_APP_ARMS = ("opportunistic", "first-fit", "cost-aware")
#: Phase 7 (b): the README's sweep commands at full width through the CLI
#: (``apps`` cut from 100 500 1000 apps to 10 15: its wall follows its
#: ~2,800 ticks, not its app counts, so fewer counts buy no time; the
#: faulted ensembles and ``capacity`` from 50 apps to 25, their replicas
#: from 256 to ``SW_FAULT_MAIN_REPLICAS``, ``autotune``'s replicas a
#: candidate from 32 to ``SW_AUTOTUNE_REPLICAS``: PERF.md, section 4).
SW_FAULT_MAIN_REPLICAS = 64
SW_AUTOTUNE_REPLICAS = 4
SW_MAIN = (
    ("autotune", "run_autotune",
     ["autotune", "--replicas", str(SW_AUTOTUNE_REPLICAS)]),
    ("ensemble-faults cost-aware", "run_ensemble",
     ["ensemble", "--replicas", str(SW_FAULT_MAIN_REPLICAS), "--faults",
      "4", "--fault-mttr", "300", "--policy", "cost-aware", "--num-apps",
      "25"]),
    ("ensemble-faults first-fit", "run_ensemble",
     ["ensemble", "--replicas", str(SW_FAULT_MAIN_REPLICAS), "--faults",
      "4", "--fault-mttr", "300", "--policy", "first-fit", "--num-apps",
      "25"]),
    ("capacity", "run_capacity",
     ["capacity", "--host-counts", "100", "200", "400", "600", "--faults",
      "4", "--fault-mttr", "300", "--num-apps", "25"]),
    ("apps", "run_apps", ["apps", "--app-counts", "10", "15"]),
)


def sw_score_grid() -> np.ndarray:
    """``run_autotune``'s grid over ``SW_EXPONENTS``: the cube and the
    reference shape."""
    import itertools

    grid = list(itertools.product(SW_EXPONENTS, repeat=3)) + [(1.0,) * 3]
    return np.array(grid, dtype=np.float32)


def sw_cases() -> dict:
    """``{entry: (kind, options)}`` of the fixture; ``kind`` is ``fault``
    (the rollout at 50 apps) or a sweep at ``SW_APPS`` apps: ``score``,
    ``capacity``, ``apps``."""
    out = {f"fault__{a}": ("fault", dict(policy=a)) for a in SW_FAULT_ARMS}
    out["score"] = ("score", {})
    out["capacity"] = ("capacity", {})
    out.update({f"apps__{a}": ("apps", dict(policy=a))
                for a in SW_APP_ARMS})
    return out


def sw_key(name, field) -> str:
    return f"{name.replace('-', '_')}__{field}"


def sw_load_fixture(path=SW_FIXTURE) -> dict:
    with np.load(path) as z:
        return {n: {f: z[sw_key(n, f)] for f in ENS_FIELDS}
                for n in sw_cases()}


def sw_run(name, inputs, replicas=None, stats=None):
    """The port's run of fixture entry ``name`` (float32) on the device of
    ``inputs`` (``{n_apps: (args, (avail0, workload, topo, sz))}``, from
    ``ensemble_inputs``), at ``replicas`` replicas (the fixture's by
    default)."""
    from pivot_tpu_torch.parallel import ensemble as E
    from pivot_tpu_torch.parallel.ensemble import prng

    kind, opt = sw_cases()[name]
    args, (a0, w, topo, sz) = inputs[50 if kind == "fault" else SW_APPS]
    key = prng.PRNGKey(args.seed)
    kw = dict(tick=args.tick, perturb=args.perturb,
              tick_order=args.tick_order, stats=stats)
    if kind == "fault":
        return E.rollout(key, a0, w, topo, sz,
                         n_replicas=replicas or SW_FAULT_REPLICAS,
                         max_ticks=2048, **SW_FAULTS, **opt, **kw)
    R = replicas or SW_REPLICAS
    if kind == "score":
        return E.score_param_sweep(key, a0, w, topo, sz, sw_score_grid(),
                                   n_replicas=R, max_ticks=2048, **kw)
    if kind == "capacity":
        return E.capacity_sweep(key, E.capacity_grid(a0, SW_HOST_COUNTS), w,
                                topo, sz, n_replicas=R, max_ticks=2048,
                                **SW_FAULTS, **kw)
    return E.workload_sweep(key, a0, w, topo, sz, list(SW_APP_COUNTS),
                            n_replicas=R, max_ticks=4096, **opt, **kw)


def sw_compare(got: dict, want: dict, name: str, replicas: int) -> float:
    """``got`` (entry ``name`` at ``replicas`` replicas) against the
    fixture's first ``replicas`` replicas (of each candidate, for a
    sweep): ``ensemble_compare``'s rule.  Returns egress's largest
    relative difference."""
    axis = 0 if name.startswith("fault__") else 1
    want = {f: np.take(v, np.arange(replicas), axis=axis)
            for f, v in want.items()}
    return ensemble_compare(got, want, name)


def sw_hazard(cli, args, topo, device):
    """A ``MarketSchedule.generate`` market's hazard rows on the CLI
    cluster: ``(times [P], rows [P, H])``, scaled so the risk term
    competes with the cost-aware score."""
    from pivot_tpu_torch.infra.market import MarketSchedule

    cluster = cli.build_cluster(cli._cluster_config(args))
    market = MarketSchedule.generate(cluster.meta, seed=0, horizon=4000.0,
                                     n_segments=8)
    rows = market.hazard[:, topo.host_zone.cpu().numpy()]
    rows = rows / max(float(rows.max()), 1e-30)
    return (torch.tensor(market.times, dtype=torch.float32, device=device),
            torch.tensor(rows, dtype=torch.float32, device=device))


def sw_small(name, inputs, hazard=None):
    """Phase 7 (c)'s card-vs-CPU runs at ``SW_APPS`` apps, R = 2."""
    from pivot_tpu_torch.parallel import ensemble as E
    from pivot_tpu_torch.parallel.ensemble import prng

    args, (a0, w, topo, sz) = inputs
    key = prng.PRNGKey(args.seed)
    kw = dict(n_replicas=2, tick=args.tick, perturb=args.perturb,
              max_ticks=2048)
    if name == "best-fit apps":
        return E.workload_sweep(key, a0, w, topo, sz, [4, 10],
                                policy="best-fit", **kw)
    if name == "cost-aware lifo score":
        return E.score_param_sweep(key, a0, w, topo, sz,
                                   [[1, 1, 1], [2, 0.5, 1.5]],
                                   tick_order="lifo", **kw)
    if name == "first-fit lifo capacity":
        return E.capacity_sweep(key, E.capacity_grid(a0, [150, 600]), w,
                                topo, sz, policy="first-fit",
                                tick_order="lifo", **SW_FAULTS, **kw)
    # The search stack's channels: exponents, risk, faults, active.
    K, R = 2, 2
    rt, arr, ra = E._perturbations(key, w, sz, R, args.perturb, a0.dtype)
    rows = [E._tile_rows(x, K) for x in (rt, arr, ra)]
    sp = torch.tensor([[1.0, 1.0, 1.0]] * R + [[1.5, 0.8, 0.5]] * R,
                      dtype=a0.dtype, device=a0.device)
    rc = torch.tensor([0.0] * R + [1e-3] * R, dtype=a0.dtype,
                      device=a0.device)
    faults = E._make_fault_schedule(key, R, 4, a0, args.tick, 2048, None,
                                    300.0, contract=True)
    active = (w.app_of < 7).expand(K * R, -1)
    rows[1] = torch.where(active, rows[1], float("inf"))
    avail = a0.expand(K * R, *a0.shape)
    policy = name.split()[0]
    task_u = E._tile_rows(E._opportunistic_uniforms(
        key, R, w.n_tasks, a0.dtype, a0.device), K) \
        if policy == "opportunistic" else None
    return E._run_rows(
        avail, *rows, w, topo, args.tick, 2048, None, policy, False, False,
        faults=tuple(E._tile_rows(f, K) for f in faults), totals=avail,
        score_params=sp if policy == "cost-aware" else None, active=active,
        task_u=task_u, risk_coeff=rc, hazard=hazard)


def sw_pow_check(device, n=1 << 24):
    """The float32 pow twin on the card against the port on the CPU over
    ``n`` (base, exponent) pairs drawn around the score tables (norms,
    round-trip costs and bandwidths); also counts how often a float64
    pow rounded to float32 differs from it (glibc's ``powf``, which the
    twin follows, is not correctly rounded)."""
    from pivot_tpu_torch.parallel.ensemble.libm import powf

    g = torch.Generator().manual_seed(7)
    base = torch.cat([torch.rand(n // 2, generator=g) * 2e5,
                      torch.rand(n // 4, generator=g),
                      torch.rand(n - n // 2 - n // 4, generator=g) * 2e4])
    w = torch.rand(n, generator=g) * 2.75 + 0.25
    w[: n // 4] = 0.5
    w[n // 4: n // 2] = 2.0
    t0 = time.perf_counter()
    card = powf(base.to(device), w.to(device)).cpu()
    card_s = time.perf_counter() - t0
    cpu = powf(base, w)
    if not torch.equal(card, cpu):
        bad = int((card != cpu).sum())
        raise AssertionError(f"(c) powf: the card differs from the CPU on "
                             f"{bad} of {n} pairs")
    f64 = torch.pow(base.to(device).double(), w.to(device).double()).float()
    return dict(pairs=n, card_s=card_s,
                f64_rounded_differs=int((f64.cpu() != card).sum()))


def chain_launches_in(ck, phase) -> int:
    """The ``ensemble_chain`` launches of this process since the phase
    reset the counts (its runs in other processes count there): at
    least one, or the phase's chains did not run on the kernel."""
    n = ck.LAUNCHES["ensemble_chain"]
    log(f"  ensemble_chain launches in phase {phase} (this process): {n} "
        f"{dict(sorted(ck.LAUNCHES_CHAIN.items()))}")
    if not n:
        raise AssertionError(f"phase {phase}'s chains made no "
                             "ensemble_chain launch")
    return n


def phase_sweeps(device, ens, pool, cpu):
    """Phase 7: fault ensembles and the what-if sweeps on the card, the
    chains on ``ensemble_chain`` (``greedy_place`` must make no launch).
    (a) every entry of ``pivot_tpu``'s fixture under torch's sync debug
    mode; (b) the
    README's commands at full width through the CLI; (c) the card against
    the port on the CPU at ``SW_APPS`` apps: best-fit, lifo, and the
    search stack's channels (exponents, a market's risk term, faults,
    an active mask), and the float32 pow twin.  The card sides of (a)
    and (c) run in ``pool``, the CPU sides of (c) on the ``cpu`` worker
    (``side_workers``); ``ens``: phase 6's cost-aware makespans, or
    None."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck

    out = {"fixture": {}, "runs": {}, "small": {}}
    ck.reset_launches()
    pool.wait()  # nothing timed before this
    return _phase_sweeps(device, ens, cli, ck, out,
                         {n: cpu[7, "c", n] for n in SW_SMALL}, pool)


#: Phase 7 (c)'s card-vs-CPU cases (``sw_small``).
SW_SMALL = ("best-fit apps", "cost-aware lifo score",
            "first-fit lifo capacity", "cost-aware channels",
            "first-fit channels", "opportunistic channels")


def sw_small_run(device, name) -> tuple:
    """One phase 7 (c) case on ``device`` (the CPU side on the worker,
    the card side in the card pool): ``(result, seconds)``.  The
    market's hazard rows are host values, so the card's equal the
    CPU's."""
    from pivot_tpu_torch.experiments import cli

    args, inputs = ensemble_inputs(cli, device, n_apps=SW_APPS)
    haz = sw_hazard(cli, args, inputs[2], device)
    t0 = time.perf_counter()
    res = _result(sw_small(name, (args, inputs),
                           haz if "channels" in name else None))
    return res, time.perf_counter() - t0


def sw_fixture_run(device, name) -> tuple:
    """Phase 7 (a): fixture entry ``name`` on ``device`` under torch's
    sync debug mode (in the card pool): ``(result, stats, synchronizing
    calls flagged)``."""
    from pivot_tpu_torch.experiments import cli

    n = 50 if sw_cases()[name][0] == "fault" else SW_APPS
    inputs = {n: ensemble_inputs(cli, device, n_apps=n)}
    st = {}
    res, syncs = sync_debug(lambda: sw_run(name, inputs, stats=st))
    return _result(res), st, syncs


def _phase_sweeps(device, ens, cli, ck, out, cpu_c, pool):
    """Phase 7 with the CPU sides of (c) on the worker (``cpu_c``) and the
    card sides of (a) and (c) from ``pool``."""
    fixture = sw_load_fixture()
    for name in sw_cases():
        got, st, syncs = pool[7, "fixture", name]
        reps = got["makespan"].shape[-1]
        worst = sw_compare(got, fixture[name], name, reps)
        out["fixture"][name] = dict(
            max_rel=worst, ticks=st["ticks"], place_steps=st["place_steps"],
            host_syncs=st["host_syncs"], sync_debug_warnings=syncs,
            wall_s=st["wall_s"], event_span_ms=st["event_span_ms"])
        log(f"  (a) {name}, shape {tuple(got['placement'].shape)}: card "
            f"equals pivot_tpu's fixture (egress largest rel diff "
            f"{worst!r}); {st['ticks']} ticks, {st['place_steps']} "
            f"placement steps, {st['host_syncs']} host reads counted, "
            f"{syncs} synchronizing calls flagged; {st['wall_s']!r} s in "
            f"the card pool")

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        for label, fn, argv in SW_MAIN:
            st = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            torch.backends.cuda.matmul.allow_tf32 = True
            summary = getattr(cli, fn)(cli.parse_args(
                ["--job-dir", "data/jobs", "--output-dir", tmp, *argv]),
                stats=st)
            peak = torch.cuda.max_memory_allocated()
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError(f"(b) {fn} left TF32 matmuls on")
            with open(os.path.join(st["out_dir"], "summary.json")) as f:
                if json.load(f) != json.loads(json.dumps(summary)):
                    raise AssertionError(f"(b) {label}: summary.json "
                                         "differs from the summary")
            rollouts = summary.get("rollouts", summary.get("replicas"))
            best = summary.get("best")
            if fn == "run_ensemble":
                best = {k: summary[k] for k in (
                    "makespan_mean", "egress_mean", "instance_hours_mean",
                    "unfinished_max")}
                finite = [best["makespan_mean"], best["egress_mean"]]
            elif fn == "run_apps":
                best = {a: rows[-1] for a, rows in summary["arms"].items()}
                finite = [r["makespan_mean"] for r in best.values()]
            else:
                if best is None:
                    raise AssertionError(f"(b) {label}: no candidate "
                                         "finished the workload")
                finite = [best["makespan_mean"], best["egress_mean"]]
            if not np.isfinite(finite).all():
                raise AssertionError(f"(b) {label}: non-finite results")
            row = dict(wall_s=summary["wall_s"], rollouts=rollouts,
                       rollouts_per_s=rollouts / summary["wall_s"],
                       ticks=st["ticks"], place_steps=st["place_steps"],
                       host_syncs=st["host_syncs"],
                       event_span_ms=st["event_span_ms"],
                       peak_mem_bytes=peak, best=best)
            out["runs"][label] = row
            if label in P16_FROM_PHASE_7:
                out["summary_" + label] = summary  # phase 16's referents
            log(f"  (b) {label} ({rollouts} rollouts) through the CLI: wall "
                f"{row['wall_s']!r} s, {row['rollouts_per_s']!r} rollouts/s;"
                f" {row['ticks']} ticks, {row['place_steps']} placement "
                f"steps, {row['host_syncs']} host reads; "
                f"{row['event_span_ms']!r} ms between CUDA events; peak "
                f"memory {peak / 2**30!r} GiB; best {json.dumps(best)}")
            if fn == "run_autotune" and ens is not None:
                # The (1, 1, 1) candidate is the plain cost-aware score
                # (pow by 1 is exact): its replicas are the first
                # SW_AUTOTUNE_REPLICAS of phase 6's R = 1024 run.
                n = SW_AUTOTUNE_REPLICAS
                want = float(np.asarray(ens, np.float32)[None, :n]
                             .mean(axis=1)[0])
                got = summary["reference"]["makespan_mean"]
                if got != want:
                    raise AssertionError(
                        f"(b) autotune's (1, 1, 1) makespan mean {got!r} is "
                        f"not phase 6's first {n} replicas' {want!r}")
                log(f"  (b) autotune's (1, 1, 1) candidate equals phase "
                    f"6's first {n} replicas (makespan mean {got!r})")

    for name in SW_SMALL:
        got, _s = pool[7, "small", name]
        want, cpu_s = cpu_c[name].result()
        worst = ensemble_compare(got, want, f"(c) {name} card vs CPU")
        out["small"][name] = dict(max_rel=worst, cpu_s=cpu_s)
        log(f"  (c) {name}, {SW_APPS} apps: the card equals the port on the "
            f"CPU ({cpu_s!r} s there), egress largest rel diff {worst!r}")
    pw = sw_pow_check(device)
    out["small"]["powf"] = pw
    log(f"  (c) float32 pow twin: the card equals the CPU on {pw['pairs']} "
        f"pairs ({pw['card_s']!r} s on the card); a float64 pow rounded to "
        f"float32 differs from it on {pw['f64_rounded_differs']} of them")
    if ck.LAUNCHES["greedy_place"]:
        raise AssertionError("phase 7 launched greedy_place")
    out["chain_launches"] = chain_launches_in(ck, 7)
    return out


SR_FIXTURE = "tests/data/search_seed0.npz"
#: Phase 8 (a): the fixture's environments — the tiny test world and the
#: README quickstart's world (``make_search_env`` keywords).
SR_ENVS = {
    "tiny": dict(n_hosts=8, seed=3, n_apps=3, horizon=300.0, n_replicas=4),
    "readme": dict(n_hosts=12, seed=5, n_apps=8, n_replicas=8),
}
#: The fixture's candidates: ``DEFAULT_WEIGHTS``, the two hand-tuned arms
#: (the first is the default), ``BAD_INIT`` and two learned-looking ones.
SR_VECTORS = np.array([
    [1.0, 1.0, 1.0, 0.0, 1.0],
    [1.0, 1.0, 1.0, 0.0, 1.0],
    [1.0, 1.0, 1.0, 1.0, 50.0],
    [0.0, 0.0, 0.0, 0.0, 1.0],
    [0.5, 2.0, 1.5, 5.0, 1.0],
    [3.0, 0.0, 0.25, 50.0, 1.0],
])
SR_FIELDS = ("egress", "instance_hours", "n_unfinished", "makespan")
#: The fixture's anchored CEM (on the README world).
SR_CEM = dict(generations=2, popsize=6, seed=5)


def sr_cases() -> dict:
    """``{entry: (env, variant, generation)}``: shared plans at generation
    keys 0 and 1, then at key 0 redrawn plans, no hazard trace, and
    capacity scales + admission masks."""
    out = {}
    for env in SR_ENVS:
        for gen in (0, 1):
            out[f"{env}__shared__g{gen}"] = (env, "shared", gen)
        for variant in ("redraw", "nohazard", "capact"):
            out[f"{env}__{variant}__g0"] = (env, variant, 0)
    return out


def sr_actions(n_tasks: int):
    """The ``capact`` case's ``cap_rows`` [B] and ``active_rows`` [B, T]:
    candidate 1 sheds the last task, candidate 4 the last four."""
    cap = np.array([1.0, 0.5, 1.0, 0.75, 1.0, 1.25])
    act = np.ones((len(SR_VECTORS), n_tasks), dtype=bool)
    act[1, -1] = False
    act[4, -4:] = False
    return cap, act


def sr_case_inputs(prng, name, envs):
    """``(env, key, cap_rows, active_rows)`` of fixture entry ``name``
    for either package (``prng``: a module with ``fold_in`` /
    ``PRNGKey``, the port's twin or ``jax.random``); ``envs`` maps
    ``"<env>"`` and ``"<env>/redraw"`` to built environments."""
    env_name, variant, gen = sr_cases()[name]
    env = envs[env_name + ("/redraw" if variant == "redraw" else "")]
    if variant == "nohazard":
        env = env._replace(hazard=None)
    key = prng.fold_in(prng.PRNGKey(env.seed), gen)
    cap = act = None
    if variant == "capact":
        cap, act = sr_actions(env.n_tasks)
    return env, key, cap, act


def sr_envs(make_search_env, **kw) -> dict:
    """The fixture's environments, ``"<env>"`` and ``"<env>/redraw"``
    (one preemption plan per replica), built by either package's
    ``make_search_env`` (``kw``: the port's ``device``)."""
    out = {}
    for name, env_kw in SR_ENVS.items():
        out[name] = make_search_env(**env_kw, **kw)
        out[name + "/redraw"] = make_search_env(**env_kw, redraw_faults=True,
                                                **kw)
    return out


def sr_key(name, field) -> str:
    return f"{name}__{field}"


def sr_load_fixture(path=SR_FIXTURE) -> dict:
    with np.load(path) as z:
        out = {n: {f: z[sr_key(n, f)] for f in SR_FIELDS + ("scores",)}
               for n in sr_cases()}
        out["cem"] = {k: z[f"cem__{k}"] for k in (
            "pops", "scores", "best_score", "init_score")}
    return out


@contextlib.contextmanager
def sr_record(F):
    """Record one dict per ``evaluate_rows`` call made inside the block
    (``F``: the port's ``search.fitness``): ``rows``, ``wall_s`` (host
    clock around the call: draws, row loop and host reduction), the
    call's ``weights``, ``env``, ``key`` and ``scores``, the row loop's
    ``ticks``, ``place_steps``, ``host_syncs``, ``loop_wall_s`` and, on
    the card, ``event_span_ms`` (``parallel/ensemble/tick.py``), and
    ``out``: ``_fitness_rows``' per-row fields (``SR_FIELDS``, on the
    device)."""
    calls = []
    evaluate, fitness_rows = F.evaluate_rows, F._fitness_rows

    def rows(*args, **kw):
        out = fitness_rows(*args, **dict(kw, stats=calls[-1]))
        calls[-1]["out"] = dict(zip(SR_FIELDS, out))
        return out

    def recorded(weights, env, **kw):
        calls.append({})
        t0 = time.perf_counter()
        scores, details = evaluate(weights, env, **kw)
        c = calls[-1]
        c.update(loop_wall_s=c.pop("wall_s"),
                 wall_s=time.perf_counter() - t0, rows=details["n_rows"],
                 weights=np.asarray(weights), env=env, key=kw.get("key"),
                 scores=scores)
        return scores, details

    F.evaluate_rows, F._fitness_rows = recorded, rows
    try:
        yield calls
    finally:
        F.evaluate_rows, F._fitness_rows = evaluate, fitness_rows


def sr_fitness(env, key, vecs, cap=None, act=None, stats=None) -> dict:
    """The port's ``_fitness_rows`` per-row fields and ``evaluate_rows``
    scores of candidates ``vecs`` on ``env`` (its device), as numpy, from
    one evaluator call; ``stats`` gets its record (``sr_record``)."""
    from pivot_tpu_torch.search import fitness as F

    with sr_record(F) as calls:
        scores, _ = F.evaluate_rows(vecs, env, key=key, cap_rows=cap,
                                    active_rows=act)
    out = {f: x.cpu().numpy() for f, x in calls[0]["out"].items()}
    out["scores"] = scores
    if stats is not None:
        stats.update(calls[0])
    return out


def sr_run(name, envs, stats=None) -> dict:
    """The port's run of fixture entry ``name`` on the device of
    ``envs`` (``sr_fitness``)."""
    from pivot_tpu_torch.parallel.ensemble import prng

    env, key, cap, act = sr_case_inputs(prng, name, envs)
    return sr_fitness(env, key, SR_VECTORS, cap, act, stats)


def sr_compare(got: dict, want: dict, what: str) -> float:
    """Unfinished counts, makespans and instance-hours equal; egress and
    scores within ``ENS_RTOL``.  Returns the largest relative difference
    of egress and scores."""
    worst = 0.0
    for f in SR_FIELDS + ("scores",):
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if g.shape != w.shape:
            raise AssertionError(f"{what}: {f} shape {g.shape} vs {w.shape}")
        if f in ("egress", "scores"):
            rel = np.abs(g.astype(np.float64) - w) / np.maximum(
                np.abs(w.astype(np.float64)), 1e-30)
            worst = max(worst, float(rel.max(initial=0.0)))
            if not np.allclose(g, w, rtol=ENS_RTOL, atol=0):
                raise AssertionError(f"{what}: {f} beyond rtol {ENS_RTOL} "
                                     f"(largest {rel.max()!r})")
        elif not np.array_equal(g, w):
            bad = np.argwhere(g != w)
            raise AssertionError(f"{what}: {f} differs at {len(bad)} "
                                 f"entries, first {bad[0].tolist()}")
    return worst


def sr_compare_cem(res, pops, scores, want) -> float:
    """The anchored CEM against the fixture's: generation 0's population
    equal, later ones within rtol 1e-9 (they follow the scores), scores,
    best and initial score within ``ENS_RTOL``, each generation's argmin
    equal.  Returns the scores' largest relative difference."""
    if pops.shape != want["pops"].shape:
        raise AssertionError(f"CEM populations {pops.shape} vs "
                             f"{want['pops'].shape}")
    if not np.array_equal(pops[0], want["pops"][0]):
        raise AssertionError("CEM generation 0's population differs")
    if not np.allclose(pops, want["pops"], rtol=1e-9, atol=0):
        raise AssertionError("CEM populations differ")
    if not np.array_equal(scores.argmin(1), want["scores"].argmin(1)):
        raise AssertionError(f"CEM argmins {scores.argmin(1)} vs "
                             f"{want['scores'].argmin(1)}")
    pairs = ((scores, want["scores"]),
             (np.float64(res.best_score), want["best_score"]),
             (np.float64(res.init_score), want["init_score"]))
    worst = 0.0
    for g, w in pairs:
        if not np.allclose(g, w, rtol=ENS_RTOL, atol=0):
            raise AssertionError(f"CEM scores beyond rtol {ENS_RTOL}: "
                                 f"{g!r} vs {w!r}")
        worst = max(worst, float(np.max(np.abs(g - w) / np.abs(w))))
    return worst


def sr_record_cem(cem, env, anchors):
    """``cem.cem_search`` on ``env`` at ``SR_CEM`` with ``anchors``,
    recording each generation's population and scores (``cem``: either
    package's ``search.cem`` module).  Returns ``(result, pops [G, B, 5],
    scores [G, B])``."""
    calls = []
    score = cem.score_population

    def recorded(pop, env_, gen, **kw):
        s = score(pop, env_, gen, **kw)
        calls.append((np.array(pop), np.asarray(s, np.float64)))
        return s

    cem.score_population = recorded
    try:
        res = cem.cem_search(env, anchors=anchors, **SR_CEM)
    finally:
        cem.score_population = score
    return (res, np.stack([c[0] for c in calls]),
            np.stack([c[1] for c in calls]))


#: Phase 8 (b): the search through the CLI — the README quickstart (CEM),
#: the same world with ES, the committed replay config (run twice), and
#: the 10,240-row population at the other phases' cluster size (its depth
#: cut from 4 generations to 1, and its horizon — the ticks it walks —
#: from 2400 s to ``SR_POPULATION_HORIZON``: PERF.md, section 4).  Each
#: with the rows a generation must have.
SR_POPULATION_HORIZON = 300
SR_MAIN = (
    ("1 cem, README quickstart", 96,
     ["search", "--method", "cem", "--generations", "6", "--popsize", "12",
      "--replicas", "8", "--hosts", "12", "--seed", "5", "--holdout", "2",
      "--des-validate"]),
    ("2 es, README world", 88,
     ["search", "--method", "es", "--generations", "6", "--popsize", "12",
      "--replicas", "8", "--hosts", "12", "--seed", "5", "--holdout", "2",
      "--des-validate"]),
    ("3 ci_seed.json", 16, ["search", "--config", "data/search/ci_seed.json"]),
    ("3 ci_seed.json again", 16,
     ["search", "--config", "data/search/ci_seed.json"]),
    ("4 population, 600 hosts", 64 * 160,
     ["search", "--method", "cem", "--hosts", "600", "--num-apps", "50",
      "--horizon", str(SR_POPULATION_HORIZON), "--popsize", "64",
      "--replicas", "160", "--generations", "1", "--holdout", "1"]),
)
#: Phase 8 (b): the population's candidates held against a run of their
#: own on the card at the same key (draws are tiled across candidates).
SR_PICK = [2, 4]
#: Phase 8 (c): the card against the port on the CPU at 600 hosts.
SR_CHECK = dict(n_hosts=600, seed=5, n_apps=50, horizon=2400.0,
                n_replicas=16)


def sr_cli_run(cli, fitness, argv, out_path) -> tuple:
    """One ``search`` run through the CLI's entry with its report written
    to ``out_path`` (the printed copy is captured).  Returns ``(report,
    row, calls)``: wall (host clock), generations/s and rollouts/s (over
    the evaluator's calls), the slowest generation's ticks, placement
    steps and host reads, CUDA-event ms of the row loops, peak memory;
    the evaluator's calls as ``sr_record`` gives them."""
    import contextlib
    import io

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = True
    args = cli.parse_args([*argv, "--out", out_path])
    t0 = time.perf_counter()
    with sr_record(fitness) as calls, \
            contextlib.redirect_stdout(io.StringIO()) as printed:
        report = cli.run_search_cli(args)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("(b) run_search_cli left TF32 matmuls on")
    with open(out_path) as f:
        written = json.load(f)
    if written != json.loads(printed.getvalue()) or written != json.loads(
            json.dumps(report)):
        raise AssertionError("(b) the printed, written and returned "
                             "reports differ")
    G = report["config"]["generations"]
    gens = calls[:G]
    slow = max(gens, key=lambda c: c["wall_s"])
    row = dict(
        wall_s=wall, generations=G,
        generations_per_s=G / sum(c["wall_s"] for c in gens),
        rows_per_generation=gens[0]["rows"],
        rollouts=sum(c["rows"] for c in calls),
        rollouts_per_s=sum(c["rows"] for c in calls) / sum(
            c["wall_s"] for c in calls),
        evaluator_calls=len(calls),
        slowest_generation={k: slow[k] for k in (
            "wall_s", "ticks", "place_steps", "host_syncs",
            "event_span_ms")},
        event_span_ms=sum(c["event_span_ms"] for c in calls),
        peak_mem_bytes=peak,
        best_score=report["search"]["best_score"],
        init_score=report["search"]["init_score"],
        beats_bad_init=report["beats_bad_init"],
        learned_beats_hand_tuned=report.get("learned_beats_hand_tuned"),
        regret=report.get("oracle", {}).get("regret"),
        best_weights=report["search"]["best_weights"])
    return report, row, calls


def sr_pow_check(device, env, n=1 << 24):
    """The float32 pow twin on the card against the port on the CPU over
    ``n`` (base, exponent) pairs: bases from the score tables of ``env``
    (a 600-host search environment on the CPU: round-trip costs and
    bandwidths, norms of partly used hosts) and at the edges (0,
    subnormal, near the float32 underflow and overflow of the result),
    exponents uniform in [0, 3] with 0 and 3 themselves."""
    from pivot_tpu_torch.parallel.ensemble.bill import _fma_norms
    from pivot_tpu_torch.parallel.ensemble.libm import powf

    hz = env.topo.host_zone.long()
    cost, bw = env.topo.cost, env.topo.bw
    tables = torch.cat([(cost[:, hz] + cost[hz, :].T).reshape(-1),
                        (bw[:, hz] + bw[hz, :].T).reshape(-1)])
    g = torch.Generator().manual_seed(8)
    used = torch.rand((n // (2 * env.avail0.shape[0]) + 1,)
                      + tuple(env.avail0.shape), generator=g)
    norms = _fma_norms(env.avail0[None] * used).reshape(-1)
    pick = torch.randint(0, tables.numel(), (n // 4,), generator=g)
    w = torch.rand(n, generator=g) * 3.0
    w[:1024], w[1024:2048] = 0.0, 3.0
    edge = n - n // 2 - n // 4
    lg = (torch.rand(edge, generator=g) * 300.0 - 160.0) / w[-edge:].clamp(
        min=1e-3)  # log2 of the base: results from 2**-160 to 2**140
    bases = torch.cat([norms[: n // 2], tables[pick],
                       torch.exp2(lg.double()).float()])
    bases[:64] = 0.0
    bases[64:128] = 2.0 ** -130  # subnormal
    t0 = time.perf_counter()
    card = powf(bases.to(device), w.to(device)).cpu()
    card_s = time.perf_counter() - t0
    cpu = powf(bases, w)
    same = (card == cpu) | (torch.isnan(card) & torch.isnan(cpu))
    if not bool(same.all()):
        raise AssertionError(f"(c) powf: the card differs from the CPU on "
                             f"{int((~same).sum())} of {n} pairs")
    return dict(pairs=n, card_s=card_s)


def cpu_sr_check() -> dict:
    """Phase 8 (c)'s CPU side: ``SR_PICK``'s candidates on the
    ``SR_CHECK`` environment on the port on the CPU (the worker's side),
    with its seconds (environment included) under ``"s"``."""
    from pivot_tpu_torch.parallel.ensemble import prng
    from pivot_tpu_torch.search import fitness as F

    t0 = time.perf_counter()
    env = F.make_search_env(**SR_CHECK, device="cpu")
    out = sr_fitness(env, prng.fold_in(prng.PRNGKey(SR_CHECK["seed"]), 0),
                     SR_VECTORS[SR_PICK])
    out["s"] = time.perf_counter() - t0
    return out


def phase_search(device, cpu):
    """Phase 8: the policy search on the card, the chains on
    ``ensemble_chain`` (``greedy_place`` must make no launch).  (a)
    ``pivot_tpu``'s fixture under torch's sync debug mode; (b) the four
    runs through the CLI; (c) the card against the port on the CPU at
    600 hosts (its CPU side on the ``cpu`` worker: ``side_workers``), and
    the pow twin over continuous exponents."""
    return _phase_search(device, cpu[8, "c"])


def _phase_search(device, cpu_check):
    """Phase 8 with (c)'s CPU side on the worker (``cpu_check``)."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.experiments.search import HAND_TUNED_ARMS
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.parallel.ensemble import prng
    from pivot_tpu_torch.search import cem
    from pivot_tpu_torch.search import fitness as F

    out = {"fixture": {}, "runs": {}, "check": {}}
    ck.reset_launches()
    envs = sr_envs(F.make_search_env, device=device)
    fixture = sr_load_fixture()
    for name in sr_cases():
        st = {}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = sr_run(name, envs, stats=st)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        worst = sr_compare(got, fixture[name], name)
        out["fixture"][name] = dict(
            max_rel=worst, ticks=st["ticks"], place_steps=st["place_steps"],
            host_syncs=st["host_syncs"], sync_debug_warnings=syncs,
            wall_s=st["wall_s"], event_span_ms=st["event_span_ms"])
        log(f"  (a) {name}: card equals pivot_tpu's fixture (egress / "
            f"scores largest rel diff {worst!r}); {st['ticks']} ticks, "
            f"{st['place_steps']} placement steps, {st['host_syncs']} host "
            f"reads counted, {syncs} synchronizing calls flagged; "
            f"{st['wall_s']!r} s")
    res, pops, scores = sr_record_cem(cem, envs["readme"],
                                      list(HAND_TUNED_ARMS.values()))
    worst = sr_compare_cem(res, pops, scores, fixture["cem"])
    out["fixture"]["cem"] = dict(max_rel=worst, argmins=scores.argmin(
        1).tolist(), best_score=res.best_score, init_score=res.init_score)
    log(f"  (a) anchored CEM, {SR_CEM}: populations, argmins "
        f"{scores.argmin(1).tolist()} and scores equal pivot_tpu's "
        f"(largest rel diff {worst!r}); best {res.best_score!r}, init "
        f"{res.init_score!r}")

    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        reports = {}
        for label, rows, argv in SR_MAIN:
            report, row, calls = sr_cli_run(cli, F, argv,
                                            os.path.join(tmp, "report.json"))
            if row["rows_per_generation"] != rows:
                raise AssertionError(
                    f"(b) {label}: {row['rows_per_generation']} rows a "
                    f"generation, not {rows}")
            finite = [row["best_score"], row["init_score"]] + [
                h["mean_cost_per_task"] for h in report["holdout"].values()]
            if not np.isfinite(finite).all():
                raise AssertionError(f"(b) {label}: non-finite scores")
            if min(row["regret"].values()) < -1e-12:
                raise AssertionError(f"(b) {label}: negative regret")
            if "des_validation" in report:
                row["des"] = report["des_validation"]
            reports[label] = report
            out["runs"][label] = row
            sl = row["slowest_generation"]
            log(f"  (b) {label} ({rows} rows a generation) through the CLI: "
                f"wall {row['wall_s']!r} s, {row['generations_per_s']!r} "
                f"generations/s, {row['rollouts_per_s']!r} rollouts/s over "
                f"{row['evaluator_calls']} evaluator calls; slowest "
                f"generation {sl['wall_s']!r} s: {sl['ticks']} ticks, "
                f"{sl['place_steps']} placement steps, {sl['host_syncs']} "
                f"host reads; {row['event_span_ms']!r} ms between CUDA "
                f"events; peak memory {row['peak_mem_bytes'] / 2**30!r} GiB;"
                f" best {row['best_score']!r} vs init {row['init_score']!r},"
                f" learned beats hand-tuned "
                f"{row['learned_beats_hand_tuned']}, regret "
                f"{json.dumps(row['regret'])}")
            if "des" in row:
                log(f"      DES validation: {json.dumps(row['des'])}")
            if rows == SR_MAIN[-1][1]:
                big = next(c for c in calls if c["rows"] == rows)
            del calls
        out["quickstart_report"] = reports[SR_MAIN[0][0]]  # for phase 16
        if reports["3 ci_seed.json"] != reports["3 ci_seed.json again"]:
            raise AssertionError("(b) the two ci_seed.json reports differ")
        log("  (b) the two ci_seed.json reports are equal")

    # The population's rows are independent and its draws tiled across
    # candidates: two of its candidates, run alone at the same key, give
    # the same rows (the batch-size paths of the tick loop: indices over
    # [B·R, ...], scatters, matmuls).
    R = big["env"].n_replicas
    t0 = time.perf_counter()
    alone = sr_fitness(big["env"], big["key"], big["weights"][SR_PICK])
    alone_s = time.perf_counter() - t0
    idx = np.concatenate([np.arange(b * R, (b + 1) * R) for b in SR_PICK])
    want = {f: x.cpu().numpy()[idx] for f, x in big["out"].items()}
    want["scores"] = big["scores"][SR_PICK]
    worst = sr_compare(alone, want, "(b) candidates alone vs in the "
                       "population")
    out["check"]["population_vs_alone"] = dict(max_rel=worst, s=alone_s)
    log(f"  (b) candidates {SR_PICK} of the {big['rows']}-row population, "
        f"run alone at its key ({len(SR_PICK)} x R={R}, {alone_s!r} s): "
        f"rows equal, egress / scores largest rel diff {worst!r}")
    # Phase 16 (c) holds the sharded backend against this call.
    out["population"] = {k: big[k] for k in ("weights", "env", "key",
                                             "scores", "rows")}
    del big

    key = prng.fold_in(prng.PRNGKey(SR_CHECK["seed"]), 0)
    t0 = time.perf_counter()
    env = F.make_search_env(**SR_CHECK, device=device)
    got = {device: sr_fitness(env, key, SR_VECTORS[SR_PICK])}
    got[device]["s"] = time.perf_counter() - t0
    got["cpu"] = cpu_check.result()
    # The pow check's bases come from the CPU environment's tables.
    env = F.make_search_env(**SR_CHECK, device="cpu")
    worst = sr_compare(got[device], got["cpu"], "(c) card vs CPU")
    out["check"]["card_vs_cpu"] = dict(max_rel=worst, cpu_s=got["cpu"]["s"],
                                       card_s=got[device]["s"])
    log(f"  (c) {SR_CHECK['n_hosts']} hosts x {SR_CHECK['n_apps']} apps, 2 "
        f"candidates x R={SR_CHECK['n_replicas']}: the card equals the port "
        f"on the CPU "
        f"({got['cpu']['s']!r} s there, {got[device]['s']!r} s on the "
        f"card), egress / scores largest rel diff {worst!r}")
    pw = sr_pow_check(device, env)
    out["check"]["powf"] = pw
    log(f"  (c) float32 pow twin, exponents in [0, 3]: the card equals the "
        f"CPU on {pw['pairs']} pairs ({pw['card_s']!r} s on the card)")
    n = ck.LAUNCHES["greedy_place"]
    out["greedy_place_launches"] = n
    log(f"  (d) greedy_place launches in phase 8: {n}")
    if n:
        raise AssertionError("phase 8 launched greedy_place")
    out["chain_launches"] = chain_launches_in(ck, 8)
    return out


#: Phase 9: the congestion model, realtime scoring, checkpoints and
#: ``calibrate``.  The fixtures ``pivot_tpu`` wrote
#: (``tests/test_torch_calibrate.py``, ``tests/test_torch_congestion_
#: fixture.py``) and their configurations.
CAL_FIXTURE = "tests/data/calibrate_seed0.json"
CAL_RUNS = {"modes": (), "realtime": ("--realtime",)}
CAL_RTOL = 1e-5
CG_FIXTURE = "tests/data/ensemble_congestion_seed0.npz"
CG_ARGV = ("--policy", "opportunistic", "--congestion")
CG_REPLICAS = 32  # cut from 1024 for the script's 1,200 s (PERF.md, 4)
CG_CHECK_REPLICAS = 16
CG_APPS = 10
CG_SMALL_REPLICAS = 4
#: (c)'s card-vs-CPU cases at ``CG_APPS`` apps: (policy, options).
CG_SMALL = (
    ("first-fit", dict(congestion=True, tick_order="lifo")),
    ("best-fit", dict(congestion=True)),
    ("cost-aware", dict(congestion="pairs", tick_order="lifo")),
    ("cost-aware", dict(congestion=True, realtime_scoring=True,
                        n_faults=4, mttr=300.0)),
)


def reports_equal(got, want, path="report") -> float:
    """``calibrate`` reports equal key for key; an estimate's egress (and
    what derives from it) within ``CAL_RTOL``.  Returns the largest
    relative egress difference."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{path}: keys {sorted(set(got) ^ set(want))}")
        return max([reports_equal(got[k], want[k], f"{path}.{k}")
                    for k in want] + [0.0])
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{path}: length {len(got)} vs {len(want)}")
        return max([reports_equal(g, w, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))] + [0.0])
    if ("egress_cost" in path and ".des" not in path
            and isinstance(want, float)):
        rel = abs(got - want) / max(abs(want), 1e-30) if want else abs(got)
        if rel > CAL_RTOL:
            raise AssertionError(f"{path}: {got!r} vs {want!r}")
        return rel
    if got != want:
        raise AssertionError(f"{path}: {got!r} vs {want!r}")
    return 0.0


def cg_small(inputs, policy, opts, path=None):
    """Phase 9 (c)'s runs at ``CG_APPS`` apps, R = 4, through
    ``rollout_checkpointed`` (faults drawn eagerly, as the CLI draws
    them)."""
    from pivot_tpu_torch.parallel import ensemble as E
    from pivot_tpu_torch.parallel.ensemble import prng

    args, (a0, w, topo, sz) = inputs
    return E.rollout_checkpointed(
        prng.PRNGKey(args.seed), a0, w, topo, sz, path,
        n_replicas=CG_SMALL_REPLICAS, tick=args.tick,
        max_ticks=args.max_ticks, perturb=args.perturb, segment_ticks=64,
        policy=policy, **opts)


def cg_small_run(device, i) -> tuple:
    """``CG_SMALL[i]`` on ``device`` (phase 9 (c): the CPU side on the
    worker, the card side in the card pool): ``(result, seconds)``."""
    from pivot_tpu_torch.experiments import cli

    policy, kw = CG_SMALL[i]
    inputs = ensemble_inputs(cli, device, n_apps=CG_APPS)
    t0 = time.perf_counter()
    res = _result(cg_small(inputs, policy, kw))
    return res, time.perf_counter() - t0


#: Phase 9 (c)'s run killed after its first segment and resumed.
CG_RESUME = ("opportunistic", dict(congestion=True, tick_order="lifo"))


def cg_resume_run(device, kill) -> tuple:
    """Phase 9 (c)'s resume check on ``device`` (in the card pool): with
    ``kill``, ``CG_RESUME`` checkpointed to a file, killed after its first
    segment and resumed from the file; without, the uninterrupted run.
    ``(result, the tick the file was written at, or None)``."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.parallel import ensemble as E

    inputs = ensemble_inputs(cli, device, n_apps=CG_APPS)
    if not kill:
        return _result(cg_small(inputs, *CG_RESUME)), None
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        path = os.path.join(tmp, "killed.npz")
        orig = E._segment_step
        calls = []

        def dying(*a, **k):
            if calls:
                raise KeyboardInterrupt("killed after the first segment")
            calls.append(1)
            return orig(*a, **k)

        E._segment_step = dying
        try:
            cg_small(inputs, *CG_RESUME, path)
            raise AssertionError("(c) the kill hook did not fire")
        except KeyboardInterrupt:
            pass
        finally:
            E._segment_step = orig
        with np.load(path) as z:
            killed_at = int(z["ticks_done"])
        return _result(cg_small(inputs, *CG_RESUME, path)), killed_at


def cg_kernels_per_tick(inputs, congestion, skip=60, window=20):
    """Device kernels a tick of an opportunistic rollout at ``CG_APPS``
    apps, R = 4, over ``window`` ticks after ``skip``, by
    ``torch.profiler``; None when it records no device kernel."""
    from torch.profiler import ProfilerActivity, profile

    from pivot_tpu_torch.parallel import ensemble as E
    from pivot_tpu_torch.parallel.ensemble import prng

    args, (a0, w, topo, sz) = inputs
    key = prng.PRNGKey(args.seed)
    rt, arr, ra = E._perturbations(key, w, sz, CG_SMALL_REPLICAS,
                                   args.perturb, a0.dtype)
    u = E._opportunistic_uniforms(key, CG_SMALL_REPLICAS, w.n_tasks,
                                  a0.dtype, a0.device)
    kw = dict(policy="opportunistic", task_u=u, congestion=congestion)
    state = E._init_state(a0, w.n_tasks, topo.cost.shape[0],
                          CG_SMALL_REPLICAS, congestion=congestion)
    state = E._rollout_segment(state, rt, arr, ra, w, topo, args.tick, skip,
                               **kw)
    torch.cuda.synchronize()
    st = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        E._rollout_segment(state, rt, arr, ra, w, topo, args.tick, window,
                           stats=st, **kw)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA"))
    return (n / st["ticks"], st["place_steps"] / st["ticks"]) if n else None


def phase_congestion(device, pool, cpu):
    """Phase 9: (a) ``calibrate`` through the CLI at its defaults, static
    and congested, then ``--realtime``, each report against
    ``pivot_tpu``'s; (b) the README's ``ensemble --policy opportunistic
    --congestion`` with ``--checkpoint`` at R = ``CG_REPLICAS``, its
    first 16 rows
    against ``pivot_tpu``'s R = 16 run; (c) at ``CG_APPS`` apps on the
    card against the port on the CPU: a checkpointed run killed after its
    first segment and resumed, and the arms and modes of ``CG_SMALL``;
    the card sides of (c) run in ``pool``, their CPU sides on the ``cpu``
    worker (``side_workers``).  No hand kernel lies on this path:
    ``greedy_place`` must make no launch."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck

    out = {"calibrate": {}, "checks": {}}
    ck.reset_launches()
    with open(CAL_FIXTURE) as f:
        cal_fx = json.load(f)
    # The CPU sides of (c) run on the worker meanwhile.
    cpu_c = [cpu[9, "c", i] for i in range(len(CG_SMALL))]
    pool.wait()  # nothing timed before this
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        # (a) calibrate at the CLI's defaults (600 hosts, cost-aware,
        #     R = 1, perturb 0, lifo, float32).
        for name, extra in CAL_RUNS.items():
            st = {}
            torch.backends.cuda.matmul.allow_tf32 = True
            t0 = time.perf_counter()
            report = cli.run_calibrate(cli.parse_args(
                ["--job-dir", "data/jobs", "--output-dir", tmp, "calibrate",
                 *extra]), stats=st)
            wall = time.perf_counter() - t0
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("run_calibrate left TF32 matmuls on")
            worst = reports_equal(json.loads(json.dumps(report)),
                                  cal_fx[name], f"(a) calibrate {name}")
            modes = {m: {k: st[m][k] for k in ("ticks", "place_steps",
                                               "host_syncs", "wall_s",
                                               "event_span_ms")}
                     for m in st if m != "out_dir"}
            out["calibrate"][name] = dict(wall_s=wall, egress_max_rel=worst,
                                          modes=modes)
            log(f"  (a) calibrate{' ' + ' '.join(extra) if extra else ''} "
                f"--num-apps 50 through the CLI: wall {wall!r} s; report "
                f"equals pivot_tpu's (egress largest rel diff {worst!r}); "
                + "; ".join(
                    f"{m}: {r['ticks']} ticks, {r['place_steps']} placement "
                    f"steps, {r['host_syncs']} host reads, rollout "
                    f"{r['wall_s']!r} s, {r['event_span_ms']!r} ms between "
                    f"CUDA events, makespan rel err "
                    f"{report[m]['rel_err']['makespan']!r}"
                    for m, r in modes.items()))

        # (b) the README's command at full width, checkpointed.
        with np.load(CG_FIXTURE) as z:
            fixture = {f: z[f] for f in ENS_FIELDS}
        st = {}
        ckpt = os.path.join(tmp, "congestion.npz")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        summary = cli.run_ensemble(cli.parse_args(ensemble_argv(
            tmp, "--replicas", str(CG_REPLICAS), *CG_ARGV, "--checkpoint",
            ckpt)), stats=st)
        peak = torch.cuda.max_memory_allocated()
        with np.load(os.path.join(st["out_dir"], "rollout.npz")) as z:
            got = {k: z[k] for k in z.files}
        with np.load(ckpt) as z:
            done = int(z["ticks_done"])
            q_shape = z["q"].shape
        if (got["placement"].shape[0] != CG_REPLICAS
                or summary["unfinished_max"] != 0
                or not summary["congestion"]
                or not np.isfinite(got["finish_time"]).all()
                or q_shape[0] != CG_REPLICAS or done <= 0):
            raise AssertionError("(b) malformed congestion run or checkpoint")
        worst = ensemble_compare(got, fixture, "(b) opportunistic congestion "
                                 f"R={CG_REPLICAS} prefix vs pivot_tpu",
                                 rows=CG_CHECK_REPLICAS)
        row = dict(wall_s=summary["wall_s"],
                   replica_rollouts_per_sec=summary[
                       "replica_rollouts_per_sec"],
                   loop_wall_s=st["wall_s"],
                   event_span_ms=st["event_span_ms"], ticks=st["ticks"],
                   place_steps=st["place_steps"],
                   host_syncs=st["host_syncs"], peak_mem_bytes=peak,
                   checkpoint_ticks=done, prefix_max_rel=worst,
                   makespan_mean=summary["makespan_mean"],
                   egress_mean=summary["egress_mean"])
        out["ensemble"] = row
        log(f"  (b) ensemble {' '.join(CG_ARGV)} --checkpoint, "
            f"R={CG_REPLICAS}, 50 apps, 600 hosts through the CLI: wall "
            f"{row['wall_s']!r} s, {row['replica_rollouts_per_sec']!r} "
            f"replica rollouts/s; {row['ticks']} ticks, {row['place_steps']} "
            f"placement steps, {row['host_syncs']} host reads; tick loop "
            f"{row['loop_wall_s']!r} s on the host clock (file writes "
            f"included), {row['event_span_ms']!r} ms between CUDA events; "
            f"peak memory {peak / 2**30!r} GiB; checkpoint at tick {done}, "
            f"q {list(q_shape)}; rows 0-{CG_CHECK_REPLICAS - 1} equal "
            f"pivot_tpu's R={CG_CHECK_REPLICAS} run (egress rel diff "
            f"{worst!r}); makespan mean {row['makespan_mean']!r} s")

        # (c) small cases, the card (in the pool) against the port on the
        #     CPU.
        whole, _ = pool[9, "resume", False]
        resumed, killed_at = pool[9, "resume", True]
        for f in ENS_FIELDS:
            if not np.array_equal(resumed[f], whole[f]):
                raise AssertionError(f"(c) resumed run differs in {f}")
        out["checks"]["resume"] = dict(killed_at=killed_at)
        log(f"  (c) opportunistic congestion lifo, {CG_APPS} apps, "
            f"R={CG_SMALL_REPLICAS}, killed at tick {killed_at} and resumed "
            "from the file: every field equals the uninterrupted run's bits")
        for i, (policy, kw) in enumerate(CG_SMALL):
            got, card_s = pool[9, "small", i]
            worst = ensemble_compare(got, cpu_c[i].result()[0],
                                     f"(c) {policy} {kw} card vs CPU")
            if got["n_unfinished"].max() != 0:
                raise AssertionError(f"(c) {policy} {kw}: tasks unfinished")
            label = f"{policy} " + " ".join(f"{k}={v}" for k, v in kw.items())
            out["checks"][label] = dict(max_rel=worst, card_s=card_s)
            log(f"  (c) {label}, {CG_APPS} apps, R={CG_SMALL_REPLICAS}: card "
                f"equals the port on the CPU, egress rel diff {worst!r}; "
                f"card {card_s!r} s in the card pool")
        on_card = ensemble_inputs(cli, device, n_apps=CG_APPS)
        per_tick = {c: cg_kernels_per_tick(on_card, c) for c in (False, True)}
        out["kernels_per_tick"] = per_tick
        if None in per_tick.values():
            log("  (c) torch.profiler recorded no device kernel: kernels a "
                "tick not measured")
        else:
            log(f"  (c) device kernels a tick, opportunistic, {CG_APPS} apps, "
                f"R={CG_SMALL_REPLICAS}, ticks 60-80 (torch.profiler): "
                f"{per_tick[True][0]!r} with congestion, "
                f"{per_tick[False][0]!r} without ({per_tick[True][1]!r} / "
                f"{per_tick[False][1]!r} placement steps a tick)")
    if ck.LAUNCHES["greedy_place"]:
        raise AssertionError("phase 9 launched greedy_place")
    log("  greedy_place launches in phase 9: 0")
    out["chain_launches"] = chain_launches_in(ck, 9)
    return out


#: Phase 10: the README's serve commands through the port's CLI at its
#: default cluster (600 hosts a session, seed 0), each on cuda.
SERVE_RUNS = {
    "a": ("--sessions", "4", "--jobs", "200", "--arrival-rate", "0.5"),
    "b_trace": ("--source", "trace", "--queue-depth", "32",
                "--backpressure", "shed"),
    "b_closed": ("--policy", "first-fit", "--closed-loop", "8", "--jobs",
                 "100"),
    "c": ("--sessions", "2", "--jobs", "300", "--arrival-rate", "2.5",
          "--queue-depth", "16", "--tier-mix", "0.25,0.35,0.40",
          "--tier-reserve", "0,2,4", "--tier-policies", "spill,shed,shed",
          "--preempt", "--routing", "least-loaded", "--autoscale", "1:8",
          "--slo-p99-ms", "50"),
}
#: Run (a)'s served sessions against batch-mode runs on these summary
#: keys (``tests/test_serve.py:137-141``).
SERVE_KEYS = ("egress_cost", "cum_instance_hours", "avg_congestion_delay",
              "total_scheduling_ops", "avg_scheduling_turnover",
              "avg_runtime", "n_apps")


class ServeRecorder:
    """Phase 10's taps on one CLI ``serve`` run: the driver and sessions
    the CLI builds (subclasses put in place of ``pivot_tpu_torch.serve``'s
    for the run), each session's per-tick placements, the flush groups of
    more than one Cost-Aware tick (``sched.batch.batch_execute``), and
    every per-row launch's operands and outputs
    (``cuda_kernels.cost_aware_cuda_rows``, as the batcher calls it), and
    every R = 1 call the policy makes itself (``_greedy``: the resident
    tier's span ticks and its per-tick placements; a batched policy's
    calls go through the batcher instead, and the batcher's one-request
    Cost-Aware calls — its single-live-slot path and flushes of one — are
    recorded into ``r1`` too).  Each session's log holds its per-tick
    placements and its span outcomes, in decision order."""

    def __init__(self):
        self.driver = None
        self.sessions = []
        self.groups = []  # sizes of coalesced Cost-Aware flush groups
        self.span_groups = []  # sizes of coalesced span flushes
        self.rows = []  # (args, kw, (placements, avail)) per launch
        self.r1 = []  # (args, kw, (placements, avail)) per R = 1 call

    @contextlib.contextmanager
    def attach(self):
        from pivot_tpu_torch import serve
        from pivot_tpu_torch.ops import cuda_kernels as ck
        from pivot_tpu_torch.sched import batch
        from pivot_tpu_torch.sched.cuda import CudaCostAwarePolicy

        rec = self
        base_driver, base_session = serve.ServeDriver, serve.ServeSession
        execute, rows = batch.batch_execute, ck.cost_aware_cuda_rows
        greedy = CudaCostAwarePolicy._greedy

        class Driver(base_driver):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.driver = self

        class Session(base_session):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                rec.sessions.append(self)
                self.log = []
                orig = self.policy.place

                def record(ctx, _orig=orig, _log=self.log):
                    out = _orig(ctx)
                    _log.append(np.asarray(out).copy())
                    return out

                self.policy.place = record
                span = getattr(self.policy, "place_span", None)
                if span is not None:
                    def record_span(ctx, plan, _orig=span, _log=self.log):
                        out = _orig(ctx, plan)
                        _log.append(None if out is None
                                    else np.asarray(out.placements).copy())
                        return out

                    self.policy.place_span = record_span

        def solo_r1(*a, **k):
            out = ck.cost_aware_cuda(*a, **k)
            rec.r1.append((a, k, out))
            return out

        def batch_execute(kernel, requests, *a, **k):
            if kernel is ck.cost_aware_cuda and len(requests) > 1:
                rec.groups.append(len(requests))
            if kernel is batch.fused_tick_run and len(requests) > 1:
                rec.span_groups.append(len(requests))
            if kernel is ck.cost_aware_cuda and len(requests) == 1:
                kernel = solo_r1  # a one-request flush: one R = 1 call
            return execute(kernel, requests, *a, **k)

        def cost_aware_cuda_rows(*a, **k):
            out = rows(*a, **k)
            rec.rows.append((a, k, out))
            return out

        def policy_greedy(policy, *a, **k):
            out = greedy(policy, *a, **k)
            rec.r1.append((a, k, out))
            return out

        serve.ServeDriver, serve.ServeSession = Driver, Session
        batch.batch_execute = batch_execute
        ck.cost_aware_cuda_rows = cost_aware_cuda_rows
        CudaCostAwarePolicy._greedy = policy_greedy
        try:
            yield self
        finally:
            serve.ServeDriver, serve.ServeSession = base_driver, base_session
            batch.batch_execute, ck.cost_aware_cuda_rows = execute, rows
            CudaCostAwarePolicy._greedy = greedy


def rows_bound(args, kw):
    """Least time for one per-row launch at these inputs, as
    :func:`bound` counts it, summed over the launch's G rows: bytes of
    each row's availability (in and out), its task stream up to its step
    bound, its two ``[Z, Z]`` tables, host zones and base counts (live /
    risk when given), its placements and step bound; operations of each
    row's round-trip tables and per-host steps."""
    avail, dem, ng, cost = args[0], args[1], args[3], args[5]
    G, H, T, nz = avail.shape[0], avail.shape[1], dem.shape[1], cost.shape[1]
    n_eff = kw["n_eff_g"].tolist()
    first_fit = kw.get("bin_pack", "first-fit") == "first-fit"
    decay, risk = kw.get("host_decay", False), kw.get("risk") is not None
    nbytes = ops = 0
    for r in range(G):
        n = n_eff[r]
        nbytes += (2 * H * 16 + n * 22 + 2 * nz * nz * 4 + 8 * H + 4 * T
                   + 4 + (4 * H if risk else 0)
                   + (H if kw.get("live") is not None else 0))
        if first_fit:
            entries = (int(ng[r][:n].sum()) if kw.get("sort_hosts", True)
                       else 0)
            per_host = 6 * n + (10 + decay + risk) * entries
        else:
            per_host = (6 + 15 + 2 * decay + risk) * n
        ops += 2 * nz * H + H * per_host
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bare_rows_launch(ck, args, kw):
    """The per-row launch alone: ``_check_rows`` once, outputs allocated
    once, then a function that runs ``_launch`` (the kernel's one launch
    site) on them."""
    live, risk, n_eff = kw.get("live"), kw.get("risk"), kw["n_eff_g"]
    bin_pack = kw.get("bin_pack", "first-fit")
    G, T, _H, cfg = ck._check_rows(*args, bin_pack, live, risk, n_eff)
    placements = torch.empty((G, T), dtype=torch.int32, device=args[0].device)
    out = torch.empty_like(args[0])

    def go():
        ck._launch(cfg, *args, live, risk, placements, out, T,
                   bin_pack == "first-fit", kw.get("sort_hosts", True),
                   kw.get("host_decay", False), n_eff_rows=n_eff)
        return placements, out
    return go


#: Rounds of :func:`rows_times`: the wrapper's and the bare launch's
#: 20-call windows alternate this many times and each time is the median.
ROWS_TIME_ROUNDS = 5


def rows_times(ck, calls):
    """Wrapper and bare-launch ms (CUDA events), ns per live step, plain
    ms (host clock) and the bound of the largest per-row launch of a run
    (most rows, then the most steps).

    A launch this small (tens of microseconds) keeps the card waiting on
    the host's issue of the next one, so one 20-call window times the
    host's pace as much as the kernel's: a stall of the issuing thread in
    one window once put the bare launch above its own wrapper (0.12318
    against 0.04706 ms, PERF.md).  So the two windows alternate
    ``ROWS_TIME_ROUNDS`` times and each time is the median of its
    rounds.  ``ns_per_step`` is ``kernel_ms`` over the launch's summed
    live steps (each row's step bound)."""
    big = max(range(len(calls)), key=lambda i: (
        calls[i][0][0].shape[0], int(calls[i][1]["n_eff_g"].sum())))
    a, k, _o = calls[big]
    b_ms, b_by = rows_bound(a, k)
    wrapper, bare = [], []
    go = bare_rows_launch(ck, a, k)
    for _ in range(ROWS_TIME_ROUNDS):
        wrapper.append(_events_ms(
            lambda: ck.cost_aware_cuda_rows(*a, **k), 20))
        bare.append(_events_ms(go, 20))
    steps = int(k["n_eff_g"].sum())
    kernel_ms = statistics.median(bare)
    return dict(
        G=a[0].shape[0], T=a[1].shape[1], H=a[0].shape[1],
        n_eff=k["n_eff_g"].tolist(), steps=steps,
        ms=statistics.median(wrapper), kernel_ms=kernel_ms,
        ms_rounds=wrapper, kernel_ms_rounds=bare,
        ns_per_step=kernel_ms * 1e6 / max(steps, 1),
        plain_ms=_host_ms(lambda: ck.cost_aware_plain_rows(*a, **k), 1),
        bound_ms=b_ms, bound_by=b_by)


def serve_run(cli, ck, name, out, args=None):
    """One CLI ``serve`` run of ``args`` (default ``SERVE_RUNS[name]``) on
    cuda through ``cli.main``, launch counts zeroed just before and read
    just after.  Returns ``(report, recorder, launches)``."""
    from pivot_tpu_torch.utils import reset_ids

    argv = ["--output-dir", out, "serve",
            *(SERVE_RUNS[name] if args is None else args)]
    rec = ServeRecorder()
    buf = io.StringIO()
    reset_ids()
    ck.reset_launches()
    with rec.attach(), contextlib.redirect_stdout(buf):
        cli.main(argv)
    launches = dict(total=ck.LAUNCHES["greedy_place"],
                    rows=dict(ck.LAUNCHES_ROWS),
                    by_replicas=dict(ck.LAUNCHES_BY_REPLICAS))
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    stamps = sorted(os.listdir(os.path.join(out, "serve")))
    with open(os.path.join(out, "serve", stamps[-1], "report.json")) as f:
        if json.load(f)["slo"] != report["slo"]:
            raise AssertionError(f"serve {name}: report.json differs from "
                                 "the printed report")
    return report, rec, launches


def serve_consistent(name, report, launches, cost_aware) -> None:
    """The counters of a drained run agree with each other, and with the
    kernel's launch counts: every coalesced Cost-Aware group one per-row
    launch, every other Cost-Aware tick one R = 1 launch."""
    c, st = report["slo"]["counters"], report["batcher"]
    settled = c["completed"] + c.get("failed_jobs", 0) + c.get("preempted", 0)
    if c["admitted"] != settled:
        raise AssertionError(f"serve {name}: admitted {c['admitted']} != "
                             f"settled {settled}")
    # Each arrival is shed or admitted once (directly, or after a spill or
    # a block); a preempted job re-enters through the spill buffer.
    if c["admitted"] != c["arrived"] - c["shed"] + c.get(
            "preempt_requeued", 0):
        raise AssertionError(f"serve {name}: arrivals do not add up: {c}")
    if st["dispatches"] != report["slo"]["decision_latency_s"]["count"]:
        raise AssertionError(f"serve {name}: {st['dispatches']} dispatches,"
                             f" {report['slo']['decision_latency_s']['count']}"
                             " decisions metered")
    rows = sum(launches["rows"].values())
    r1 = launches["by_replicas"].get(1, 0)
    if not cost_aware:
        if launches["total"]:
            raise AssertionError(f"serve {name}: a torch arm launched "
                                 "greedy_place")
        return
    if launches["total"] != rows + r1 or set(launches["by_replicas"]) - {1}:
        raise AssertionError(f"serve {name}: launches {launches}")
    if r1 != st["dispatches"] - st["coalesced"] or \
            st["device_calls"] != rows + r1:
        raise AssertionError(f"serve {name}: launches {launches} do not "
                             f"match the batcher's {st}")


def serve_log(name, report, launches, card) -> dict:
    """Print one run's numbers; return them for the JSON record."""
    slo, st = report["slo"], report["batcher"]
    lat = slo["decision_latency_s"]
    tiers = {t: dict(p50_ms=v["decision_latency_s"]["p50"] * 1e3,
                     p99_ms=v["decision_latency_s"]["p99"] * 1e3)
             for t, v in slo["tiers"].items()}
    row = dict(wall_s=report["wall_s"],
               decisions_per_sec=report["decisions_per_sec"],
               p50_ms=lat["p50"] * 1e3, p99_ms=lat["p99"] * 1e3,
               tiers=tiers, batcher=st, launches=launches,
               counters={k: slo["counters"].get(k, 0) for k in (
                   "arrived", "admitted", "completed", "shed", "spilled",
                   "preempted", "decisions")},
               pool=report["pool"])
    log(f"  [{card}]")
    log(f"  serve {name}: wall {row['wall_s']!r} s, "
        f"{row['decisions_per_sec']!r} decisions/s, decision latency p50 "
        f"{row['p50_ms']!r} ms p99 {row['p99_ms']!r} ms; per tier "
        + ", ".join(f"{t}: p50 {v['p50_ms']!r} p99 {v['p99_ms']!r} ms"
                    for t, v in tiers.items()))
    log(f"    counters {row['counters']}; pool {report['pool']}")
    log(f"    batcher {st}")
    log(f"    greedy_place launches: per-row by G {launches['rows']}, "
        f"shared-stream by R {launches['by_replicas']}")
    return row


def serve_breakdown(cli, ck, out) -> dict:
    """Run (a) again with ``--trace-out``: where a decision's wall goes.
    From the trace: the placement calls (``dispatch``/``place``, each
    from the policy's entry to its return: host prep, park, flush,
    unpad) and the batcher's flushes (``dispatch``/``flush``: staging,
    launch or row calls, fetch); a request rides its flush for the
    flush's whole duration, so the rest of its call is host prep and
    park.  Also the per-row launches' device time (CUDA events, bare
    launch) against the run's wall."""
    path = os.path.join(out, "a_trace.json")
    argv = ["--output-dir", out, "serve", *SERVE_RUNS["a"], "--trace-out",
            path]
    rec = ServeRecorder()
    buf = io.StringIO()
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    with rec.attach(), contextlib.redirect_stdout(buf):
        cli.main(argv)
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(path + ".jsonl") as f:
        events = [json.loads(line) for line in f]
    place = [e["dur"] for e in events
             if e["cat"] == "dispatch" and e["name"] == "place"]
    flush = [(e["dur"], e["args"]["group"]) for e in events
             if e["cat"] == "dispatch" and e["name"] == "flush"]
    in_flush = sum(d * g for d, g in flush)
    device = sum(_events_ms(bare_rows_launch(ck, a, k), 3)
                 for a, k, _o in rec.rows) / 1e3
    row = dict(
        wall_s=report["wall_s"], place_calls=len(place),
        place_s=sum(place), place_median_ms=statistics.median(place) * 1e3,
        flushes=len(flush), flush_s=sum(d for d, _g in flush),
        flush_median_ms=statistics.median(d for d, _g in flush) * 1e3,
        in_flush_share=in_flush / sum(place),
        rows_launches=len(rec.rows), rows_device_s=device,
        device_share=device / report["wall_s"])
    log(f"    traced rerun: wall {row['wall_s']!r} s; {row['place_calls']} "
        f"placement calls, {row['place_s']!r} s in all (median "
        f"{row['place_median_ms']!r} ms); {row['flushes']} flushes, "
        f"{row['flush_s']!r} s (median {row['flush_median_ms']!r} ms); "
        f"a call's share inside its flush {row['in_flush_share']!r}; "
        f"{row['rows_launches']} per-row launches, {row['rows_device_s']!r}"
        f" s of device time = {row['device_share']!r} of the wall")
    return row


def phase_serve(device):
    """Phase 10: ``serve`` on the card through the CLI (module docstring):
    (a) the README's first command, its coalesced Cost-Aware flushes each
    one per-row launch held against ``cost_aware_plain_rows``, its
    sessions equal to batch-mode runs on cuda; (b) the trace source with
    shedding, and first-fit closed-loop; (c) the multi-tenant command,
    audited.  Returns the record of phase 10."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.serve import poisson_arrivals
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import (
        PolicyConfig, build_cluster, make_policy)
    from pivot_tpu_torch.workload.trace import TraceSchedule

    card = card_line()
    out_rec = {}
    chk = Check()
    with tempfile.TemporaryDirectory() as out:
        # (a)
        report, rec, launches = serve_run(cli, ck, "a", out)
        c, st = report["slo"]["counters"], report["batcher"]
        # Replay mode admits as fast as the producer runs, so the
        # README's command sheds past its queue depth of 64 (as
        # pivot_tpu's own run does): every arrival is counted, and every
        # admitted job completes.
        if c["arrived"] != 200 or c["completed"] != c["admitted"] or \
                c["completed"] + c["shed"] != 200:
            raise AssertionError(f"serve a: {c}")
        if not st["coalesced"] or st["device_calls"] >= st["dispatches"]:
            raise AssertionError(f"serve a: nothing coalesced: {st}")
        rows = sum(launches["rows"].values())
        if rows != len(rec.groups) or rows != len(rec.rows) or not rows:
            raise AssertionError(
                f"serve a: {rows} per-row launches for {len(rec.groups)} "
                f"coalesced Cost-Aware groups ({len(rec.rows)} recorded)")
        serve_consistent("a", report, launches, True)
        out_rec["a"] = serve_log("a", report, launches, card)
        t0 = time.perf_counter()
        for i, (a, k, got) in enumerate(rec.rows):
            chk.same(got, ck.cost_aware_plain_rows(*a, **k), ("rows", i))
        log(f"    {len(rec.rows)} per-row launches (groups of "
            f"{sorted(set(rec.groups))}) equal cost_aware_plain_rows: "
            f"{chk.placed} placements, max |avail diff| "
            f"{chk.max_abs_err!r} ({time.perf_counter() - t0:.1f} s)")
        out_rec["a"]["rows_times"] = rows_times(ck, rec.rows)
        rt = out_rec["a"]["rows_times"]
        log(f"    largest flush (G={rt['G']}, T={rt['T']}, H={rt['H']}, "
            f"n_eff {rt['n_eff']}): wrapper {rt['ms']!r} ms, kernel_ms "
            f"{rt['kernel_ms']!r} (medians of {ROWS_TIME_ROUNDS} alternated"
            f" rounds: {rt['ms_rounds']!r} / {rt['kernel_ms_rounds']!r}), "
            f"{rt['ns_per_step']!r} ns per live step ({rt['steps']}), "
            f"plain {rt['plain_ms']!r} ms, bound {rt['bound_ms']!r} ms "
            f"({rt['bound_by']})")
        # Each session against a batch-mode run of the jobs it served (the
        # round-robin share of the admitted ones), fresh from the seed.
        t0 = time.perf_counter()
        args = cli.parse_args(["serve", *SERVE_RUNS["a"]])
        reset_ids()
        fresh = {x.app.id: x.app for x in poisson_arrivals(
            args.arrival_rate, args.jobs, seed=args.seed)}
        pcfg = PolicyConfig(name="cost-aware", device="cuda",
                            bin_pack="first-fit", sort_tasks=True,
                            sort_hosts=True)
        sessions = sorted(rec.sessions, key=lambda s: s.slot)
        G, ticks = len(sessions), 0
        for g, sess in enumerate(sessions):
            policy = make_policy(pcfg)
            run = ExperimentRun(
                f"batch-{g}", build_cluster(cli._cluster_config(args)),
                policy, schedule=TraceSchedule([(0.0, [])] + [
                    (app._serve_admit_ts, [fresh[app.id]])
                    for app in sess._injected]),
                seed=args.seed, interval=5.0, fuse_spans=False)
            log_b, orig = [], policy.place

            def record(ctx, _orig=orig, _log=log_b):
                got = _orig(ctx)
                _log.append(np.asarray(got).copy())
                return got

            policy.place = record
            want = run.run()
            if len(log_b) != len(sess.log) or any(
                    not np.array_equal(x, y) for x, y in zip(sess.log, log_b)):
                raise AssertionError(f"serve a: session {g}'s placements "
                                     "differ from its batch-mode run")
            got = sess.summary()
            if {k: got[k] for k in SERVE_KEYS} != {
                    k: want[k] for k in SERVE_KEYS}:
                raise AssertionError(f"serve a: session {g}'s summary "
                                     f"{got} differs from batch mode {want}")
            ticks += len(log_b)
        log(f"    served = batch mode on cuda: {G} sessions, {ticks} ticks "
            f"of placements and the summaries equal "
            f"({time.perf_counter() - t0:.1f} s)")
        out_rec["a"]["traced"] = serve_breakdown(cli, ck, out)
        # (b)
        for name in ("b_trace", "b_closed"):
            report, rec, launches = serve_run(cli, ck, name, out)
            c = report["slo"]["counters"]
            if name == "b_closed" and (c["completed"] != 100 or c["shed"]
                                       or report["slo"]["queue_depth"]["max"]
                                       > 8):
                raise AssertionError(f"serve {name}: {c}")
            if name == "b_trace" and (not c["completed"]
                                      or c["arrived"] != 50):
                raise AssertionError(f"serve {name}: {c}")
            serve_consistent(name, report, launches, name == "b_trace")
            rec.driver.audit()
            for i, (a, k, got) in enumerate(rec.rows):
                chk.same(got, ck.cost_aware_plain_rows(*a, **k),
                         (name, "rows", i))
            out_rec[name] = serve_log(name, report, launches, card)
            if rec.rows:
                rt = out_rec[name]["rows_times"] = rows_times(ck, rec.rows)
                log(f"    largest flush (G={rt['G']}, T={rt['T']}, n_eff "
                    f"{rt['n_eff']}): wrapper {rt['ms']!r} ms, kernel_ms "
                    f"{rt['kernel_ms']!r}, {rt['ns_per_step']!r} ns per "
                    f"live step, plain {rt['plain_ms']!r} ms, bound "
                    f"{rt['bound_ms']!r} ms ({rt['bound_by']})")
        # (c)
        report, rec, launches = serve_run(cli, ck, "c", out)
        serve_consistent("c", report, launches, True)
        rec.driver.audit("serve c")
        c0 = report["slo"]["tiers"]["0"]["counters"]
        if c0["shed"] or c0.get("preempted", 0):
            raise AssertionError(f"serve c: tier 0 degraded: {c0}")
        for i, (a, k, got) in enumerate(rec.rows):
            chk.same(got, ck.cost_aware_plain_rows(*a, **k), ("c", "rows", i))
        out_rec["c"] = serve_log("c", report, launches, card)
        log("    audit(): no violation")
    log(f"  per-row launches of phase 10: {chk.cases} held against "
        f"cost_aware_plain_rows, {chk.placed} placements, max |avail diff| "
        f"{chk.max_abs_err!r}")
    out_rec["max_abs_err"] = chk.max_abs_err
    return out_rec


# -- phase 11: cross-run batching on the card ----------------------------------

#: (a) synthetic mixed-horizon Cost-Aware span groups at H = 600: each
#: row's (horizon, slots), and whether a market's risk rows and cost stack
#: ride along (and a live mask, with the market).
P11_GROUPS = (
    (((3, 40), (17, 200)), False),
    (((1, 8), (9, 100), (32, 300)), True),
    (((2, 30), (5, 60), (12, 250), (30, 120)), False),
    (((4, 300), (8, 90), (16, 20), (32, 200)), True),
)
#: (b) the lock-step grid: ``overall`` over the first P11_TRACES traces
#: of ``data/jobs``, P11_APPS apps a run (cut from the README's 1000 for
#: the script's time: to 20 for phase 11, to 10 for phase 13), G = 4
#: runs an arm in lock-step.
P11_TRACES = 4
P11_APPS = 10
#: (c) the serve commands of the path (the README's span commands without
#: the mesh flag), at 600 hosts a session, and the same stream from the
#: first trace window with quiescence-only flushes: the README stream
#: serves few spans (6 at seed 0, as ``pivot_tpu``'s own run of it), too
#: few to meet in a flush, so the trace run is the one that must merge.
P11_SERVE_BASE = ("--sessions", "3", "--jobs", "300", "--arrival-rate", "25",
                  "--fuse-spans", "slo")
P11_SERVE = {
    "ragged": P11_SERVE_BASE,
    "no_ragged": P11_SERVE_BASE + ("--no-ragged",),
    "resident": P11_SERVE_BASE + ("--resident", "--splice-tier", "1"),
    "ragged_trace": P11_SERVE_BASE + ("--source", "trace",
                                      "--flush-after-us", "0"),
}


def p11_request(seed, n_ticks, S, market, H=600):
    """One Cost-Aware span request as a policy stages it for the batcher
    (host numpy, float32): ``(args, arr_kw, static_kw)``.  Cohorts arrive
    over the horizon; demand dimension 1 is drawn from [0, 8) against
    availability in [0, 16), and one task in ten asks for 20 (it never
    fits, so the wait stack carries it every tick)."""
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.ops.tickloop import span_bucket
    from pivot_tpu_torch.sched.cuda import pad_bucket

    rng = np.random.default_rng(seed)
    K, B = span_bucket(n_ticks), pad_bucket(S)
    avail = rng.uniform(0, 16, size=(H, 4)).astype(np.float32)
    dem = np.zeros((B, 4), np.float32)
    dem[:S, 0] = rng.choice([0.5, 1.0, 2.0, 4.0], size=S)
    dem[:S, 1] = np.where(rng.random(S) < 0.1, 20.0,
                          rng.uniform(0, 8, size=S))
    arrive = np.full(B, K, np.int32)
    arrive[:S] = np.sort(rng.integers(0, n_ticks, size=S))
    arrive[0] = 0
    cost = rng.uniform(0, 0.11, size=(Z, Z)).astype(np.float32)
    np.fill_diagonal(cost, 0.0)
    kw = dict(
        anchor_zone=rng.integers(0, Z, size=B).astype(np.int32),
        bucket_id=rng.integers(0, min(B, 12), size=B).astype(np.int32),
        sort_norm=np.sqrt((dem * dem).sum(1)).astype(np.float32),
        cost_zz=cost,
        bw_zz=rng.uniform(50, 15000, size=(Z, Z)).astype(np.float32),
        host_zone=rng.integers(0, Z, size=H).astype(np.int32),
        base_task_counts=rng.integers(0, 5, size=H).astype(np.int32),
    )
    if market:
        kw["risk_rows"] = rng.choice([0.0, 0.4, 1.5],
                                     size=(K, H)).astype(np.float32)
        kw["cost_stack"] = rng.uniform(0, 0.11,
                                       size=(4, Z, Z)).astype(np.float32)
        kw["cost_seg"] = rng.integers(0, 4, size=K).astype(np.int32)
        kw["live"] = rng.random(H) < 0.9
    static = dict(policy="cost-aware", n_ticks=K, bin_pack="first-fit",
                  sort_tasks=True, sort_hosts=True, host_decay=False,
                  phase2="auto", greedy=ck.cost_aware_cuda)
    return (avail, dem, arrive, np.int32(n_ticks)), kw, static


class RowsTap:
    """While active: the batched span driver (``sched.batch.
    fused_tick_run_rows``) runs under ``torch.cuda.set_sync_debug_mode(
    "error")`` between CUDA events, and every per-row launch
    (``cuda_kernels.cost_aware_cuda_rows``, as the driver calls it) keeps
    its operands and outputs.  The sync debug mode is process-wide: use
    it only where no other thread touches the card during a flush."""

    def __init__(self, sync_debug=True):
        self.sync_debug = sync_debug
        self.calls = []  # (args, kw, (placements, avail)) per launch
        self.flushes = []  # dict(G, ticks, greedy, ev) per driver call

    def __enter__(self):
        from pivot_tpu_torch.ops import cuda_kernels as ck
        from pivot_tpu_torch.sched import batch

        self.ck, self.batch = ck, batch
        self.rows, self.driver = ck.cost_aware_cuda_rows, \
            batch.fused_tick_run_rows

        def rows(*a, **k):
            out = self.rows(*a, **k)
            self.calls.append((a, k, out))
            return out

        def driver(avail, demands, arrive, n_ticks_dyn, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            if self.sync_debug:
                torch.cuda.set_sync_debug_mode("error")
            try:
                res = self.driver(avail, demands, arrive, n_ticks_dyn, **kw)
            finally:
                if self.sync_debug:
                    torch.cuda.set_sync_debug_mode("default")
            ev[1].record()
            self.flushes.append(dict(
                G=int(avail.shape[0]), ticks=int(max(n_ticks_dyn)),
                greedy=kw.get("greedy") is not None, ev=ev))
            return res

        ck.cost_aware_cuda_rows, batch.fused_tick_run_rows = rows, driver
        return self

    def __exit__(self, *exc):
        self.ck.cost_aware_cuda_rows = self.rows
        self.batch.fused_tick_run_rows = self.driver

    def flush_ms(self):
        torch.cuda.synchronize()
        return [f["ev"][0].elapsed_time(f["ev"][1]) for f in self.flushes]


class R1Tap:
    """While active: every shared-stream launch
    (``cuda_kernels.cost_aware_cuda_batched``; each R = 1
    ``cost_aware_cuda`` call, a span tick's included, goes through it)
    keeps clones of its operands and outputs (queued on the stream: no
    sync), held against ``cost_aware_plain_batched`` by :meth:`hold`."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from pivot_tpu_torch.ops import cuda_kernels as ck

        self.ck, self.fn = ck, ck.cost_aware_cuda_batched

        def batched(*a, **k):
            out = self.fn(*a, **k)
            self.calls.append((_clone(a), _clone(k), _clone(out)))
            return out

        ck.cost_aware_cuda_batched = batched
        return self

    def __exit__(self, *exc):
        self.ck.cost_aware_cuda_batched = self.fn

    def hold(self, chk, launches, what) -> None:
        """Each recorded launch against its plain version; ``launches``,
        the run's ``LAUNCHES_BY_REPLICAS``, must count them all."""
        if len(self.calls) != sum(launches.values()):
            raise AssertionError(f"{what}: {len(self.calls)} shared-stream "
                                 f"launches recorded of {launches}")
        for i, (a, k, got) in enumerate(self.calls):
            chk.same(got, self.ck.cost_aware_plain_batched(*a, **k),
                     (what, "r1", i))


def _dispatch_spans(batch, tickloop, device, reqs):
    """Co-pending span requests, one client thread each, through a ragged
    ``DispatchBatcher`` on ``device``; returns (results, stats)."""
    import threading

    batcher = batch.DispatchBatcher(len(reqs), device=device, ragged=True)
    clients = [batcher.client() for _ in reqs]
    out, errs = [None] * len(reqs), []

    def work(i):
        try:
            out[i] = clients[i].dispatch(tickloop.fused_tick_run, *reqs[i])
        except BaseException as exc:  # noqa: BLE001 — raised below
            errs.append(exc)
        finally:
            clients[i].close()

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    batcher.serve()
    for t in threads:
        t.join(timeout=120)
    if errs:
        raise errs[0]
    return out, batcher.stats


def _solo_span(tickloop, device, args, arr_kw, static):
    """One request as the policy's unbatched path runs it: staged on the
    card, its host bounds and segments on the host; R = 1 launches."""
    kw = {k: v if k in tickloop.SPAN_HOST_OPERANDS
          else torch.from_numpy(v).to(device) for k, v in arr_kw.items()}
    t = [torch.from_numpy(np.asarray(a)).to(device) for a in args[:3]]
    return tickloop.fused_tick_run(
        *t, int(args[3]), n_bound=tickloop.span_step_bounds(
            args[2], int(args[3])), **kw, **static)


def p11_flushes(device, n_hosts=600) -> dict:
    """Phase 11 (a): each synthetic group of P11_GROUPS dispatched through a
    ragged batcher: merged into one flush (one ``ragged_merges``), the
    batched span driver under sync debug "error", each span tick ONE
    per-row launch held against ``cost_aware_plain_rows``, each trimmed
    result equal to its solo span (R = 1 launches)."""
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.ops import tickloop
    from pivot_tpu_torch.sched import batch

    chk = Check()
    out = dict(cases=[], rows_launches=0, rows_by_g={},
               compare_r1_launches=0)
    all_calls = []
    # Warm-up flush (first pinned staging, first launches), not counted.
    _dispatch_spans(batch, tickloop, device, [
        p11_request(r, n, S, False, H=n_hosts)
        for r, (n, S) in enumerate(P11_GROUPS[0][0])])
    for gi, (rows, market) in enumerate(P11_GROUPS):
        reqs = [p11_request(1000 * gi + r, n, S, market, H=n_hosts)
                for r, (n, S) in enumerate(rows)]
        G, loop = len(reqs), max(n for n, _S in rows)
        with RowsTap() as tap:
            ck.reset_launches()
            res, stats = _dispatch_spans(batch, tickloop, device, reqs)
            torch.cuda.synchronize()
            launches = (dict(ck.LAUNCHES_ROWS), dict(ck.LAUNCHES_BY_REPLICAS))
        if launches != ({G: loop}, {}) or len(tap.calls) != loop:
            raise AssertionError(f"flush {gi}: launches {launches}, "
                                 f"{len(tap.calls)} recorded, want {loop} "
                                 f"per-row launches of G={G}")
        if (stats["ragged_merges"], stats["ragged_rows"],
                stats["device_calls"], stats["coalesced"]) != (1, G, 1, G):
            raise AssertionError(f"flush {gi}: batcher {stats}")
        for k, (a, kw, got) in enumerate(tap.calls):
            chk.same(got, ck.cost_aware_plain_rows(*a, **kw), (gi, k))
        ck.reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        solo = [_solo_span(tickloop, device, *r) for r in reqs]
        ev[1].record()
        torch.cuda.synchronize()
        r1 = dict(ck.LAUNCHES_BY_REPLICAS)
        if r1 != {1: sum(n for n, _S in rows)}:
            raise AssertionError(f"flush {gi}: solo launches {r1}")
        same_avail = True
        for r, (got, want) in enumerate(zip(res, solo)):
            if not np.array_equal(got.placements,
                                  want.placements.cpu().numpy()):
                raise AssertionError(f"flush {gi} row {r}: trimmed "
                                     "placements differ from the solo span")
            for f in ("n_ready", "n_placed", "ticks_run", "n_stack_final",
                      "stackpos"):
                if not torch.equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"flush {gi} row {r}: {f} differs")
            if not torch.allclose(got.avail, want.avail, rtol=RTOL,
                                  atol=ATOL):
                raise AssertionError(f"flush {gi} row {r}: availability")
            same_avail = same_avail and torch.equal(got.avail, want.avail)
        case = dict(
            G=G, horizons=[n for n, _S in rows], slots=[S for _n, S in rows],
            market=market, launches=loop, pad_cells=stats["ragged_pad_cells"],
            placed=int(sum((x.placements >= 0).sum() for x in res)),
            flush_ms=tap.flush_ms()[0], solo_ms=ev[0].elapsed_time(ev[1]),
            avail_bitwise=same_avail)
        out["cases"].append(case)
        out["rows_launches"] += loop
        out["rows_by_g"][G] = out["rows_by_g"].get(G, 0) + loop
        out["compare_r1_launches"] += sum(r1.values())
        all_calls += tap.calls
        log(f"  (a) G={G} horizons {case['horizons']} slots {case['slots']}"
            f" market {market}: one flush, {loop} per-row launches (each = "
            f"plain), {case['pad_cells']} pad cells, {case['placed']} "
            f"placements; batched driver {case['flush_ms']!r} ms vs "
            f"{case['solo_ms']!r} ms for the {G} solo spans "
            f"({sum(r1.values())} R=1 launches); trimmed = solo "
            f"(availability bitwise: {same_avail})")
    rt = out["rows_times"] = rows_times(ck, all_calls)
    out["max_abs_err"] = chk.max_abs_err
    log(f"  (a) {chk.cases} span ticks held against cost_aware_plain_rows, "
        f"{chk.placed} placements, max |avail diff| {chk.max_abs_err!r}; "
        f"largest span tick (G={rt['G']}, T={rt['T']}, n_eff {rt['n_eff']}):"
        f" wrapper {rt['ms']!r} ms, kernel_ms {rt['kernel_ms']!r} (medians "
        f"of {ROWS_TIME_ROUNDS} alternated rounds), {rt['ns_per_step']!r} ns"
        f" per live step ({rt['steps']}), plain {rt['plain_ms']!r} ms, "
        f"bound {rt['bound_ms']!r} ms ({rt['bound_by']})")
    return out


def p11_resident(device, n_hosts=600) -> dict:
    """Phase 11 (d): a chain of four Cost-Aware spans on one resident carry
    (edit rows before the third: freed capacity and a quarantine flip),
    each ``resident_span_run`` under sync debug "error" (its ticks R = 1
    launches), against the re-staged ``fused_tick_run`` on the host mirror
    of the same state served by the plain version
    (``cost_aware_plain``)."""
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.ops import tickloop

    args, kw, static = p11_request(77, 8, 200, False, H=n_hosts)
    host_avail, host_counts = args[0].copy(), kw.pop("base_task_counts")
    host_live = np.ones(n_hosts, bool)
    carry = tickloop.resident_carry_init(host_avail, host_counts, host_live,
                                         device=device)
    dev = {k: torch.from_numpy(v).to(device) for k, v in kw.items()}
    rng = np.random.default_rng(78)
    chk = Check()
    spans = horizon = edits = launches = 0
    for i in range(4):
        dem = args[1].copy()
        dem[: 200] *= rng.uniform(0.5, 1.0, size=(200, 1)).astype(np.float32)
        arrive = args[2]
        edit = {}
        if i == 2:
            rows = np.unique(np.array([5, 17, 123, 599]) % n_hosts
                             ).astype(np.int32)
            host_avail[rows] += 4.0
            host_live[rows[-1]] = False
            E = tickloop.edit_bucket(len(rows))
            eidx = np.full(E, n_hosts, np.int32)
            eidx[: len(rows)] = rows
            eav = np.zeros((E, 4), np.float32)
            eav[: len(rows)] = host_avail[rows]
            ect = np.zeros(E, np.int32)
            ect[: len(rows)] = host_counts[rows]
            elv = np.ones(E, bool)
            elv[: len(rows)] = host_live[rows]
            edit = {k: torch.from_numpy(v).to(device) for k, v in (
                ("edit_idx", eidx), ("edit_avail", eav),
                ("edit_counts", ect), ("edit_live", elv))}
            edits += len(rows)
        t_dem = torch.from_numpy(dem).to(device)
        t_arr = torch.from_numpy(arrive).to(device)
        n_bound = tickloop.span_step_bounds(arrive, 8)
        want = tickloop.fused_tick_run(
            torch.from_numpy(host_avail).to(device), t_dem, t_arr, 8,
            n_bound=n_bound, base_task_counts=torch.from_numpy(
                host_counts).to(device),
            live=torch.from_numpy(host_live).to(device), **dev,
            **dict(static, greedy=ck.cost_aware_plain))
        torch.cuda.synchronize()
        ck.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, carry = tickloop.resident_span_run(
                carry, t_dem, t_arr, 8, n_bound=n_bound, **edit, **dev,
                **static)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches += ck.LAUNCHES_BY_REPLICAS.get(1, 0)
        if ck.LAUNCHES_ROWS or set(ck.LAUNCHES_BY_REPLICAS) - {1}:
            raise AssertionError(f"resident span {i}: launches "
                                 f"{dict(ck.LAUNCHES_BY_REPLICAS)}")
        chk.same((got.placements, got.avail), (want.placements, want.avail),
                 f"resident span {i} vs the plain re-staged span")
        pl = want.placements.cpu().numpy()
        host_avail = want.avail.cpu().numpy().copy()
        np.add.at(host_counts, pl[pl >= 0], 1)
        if not np.array_equal(carry.counts.cpu().numpy(), host_counts):
            raise AssertionError(f"resident span {i}: counts differ")
        spans += 1
        horizon += 8
    if launches != horizon:
        raise AssertionError(f"resident chain: {launches} R=1 launches for "
                             f"{horizon} span ticks")
    log(f"  (d) resident chain: {spans} spans, {edits} edit rows, each equal"
        f" to the re-staged span served by cost_aware_plain ({chk.placed} "
        f"placements, max |avail diff| {chk.max_abs_err!r}); {launches} R=1 "
        "launches, no host read inside a resident span")
    return dict(spans=spans, edit_rows=edits, r1_launches=launches,
                max_abs_err=chk.max_abs_err)


def p11_lockstep(device, n_hosts=600, apps=P11_APPS,
                 traces=P11_TRACES) -> dict:
    """Phase 11 (b): ``overall --batch-runs 4`` through the CLI against the
    sequential ``--batch-runs 1`` cuda run of the same grid: files
    byte-identical; every per-row launch of the lock-step run (coalesced
    ticks and span ticks) held against ``cost_aware_plain_rows``;
    launches, span flushes, ragged merges and walls."""
    from pivot_tpu_torch.experiments import cli, runner
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.sched import batch

    res = {}
    chk = Check()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        for name, g in (("lockstep", 4), ("sequential", 1)):
            argv = ["--device", "cuda", "--num-hosts", str(n_hosts),
                    "--job-dir", "data/jobs", "--output-dir",
                    os.path.join(tmp, name), "--seed", "0", "--trace-limit",
                    str(traces), "--batch-runs", str(g), "overall",
                    "--num-apps", str(apps)]
            chunks, groups = [], {"ticks": [], "spans": []}
            lock, execute = runner.run_grid_lockstep, batch.batch_execute

            def run_grid_lockstep(runs, stats_out=None):
                stats = {}
                out = lock(runs, stats_out=stats)
                chunks.append(stats)
                if stats_out is not None:
                    stats_out.update(stats)
                return out

            def batch_execute(kernel, requests, *a, **k):
                if len(requests) > 1:
                    key = ("spans" if kernel is batch.fused_tick_run
                           else "ticks")
                    groups[key].append(len(requests))
                return execute(kernel, requests, *a, **k)

            runner.run_grid_lockstep = run_grid_lockstep
            batch.batch_execute = batch_execute
            try:
                with RowsTap(sync_debug=False) as tap, R1Tap() as r1:
                    ck.reset_launches()  # the path's count starts here
                    t0 = time.perf_counter()
                    exp_dir, sums = cli.run_overall(cli.parse_args(argv),
                                                    torch_device=device)
                    wall = time.perf_counter() - t0
                    launches = dict(rows=dict(ck.LAUNCHES_ROWS),
                                    by_replicas=dict(ck.LAUNCHES_BY_REPLICAS))
            finally:
                runner.run_grid_lockstep = lock
                batch.batch_execute = execute
            if len(tap.calls) != sum(launches["rows"].values()):
                raise AssertionError(f"{name}: {len(tap.calls)} per-row "
                                     f"launches recorded of {launches}")
            for i, (a, kw, got) in enumerate(tap.calls):
                chk.same(got, ck.cost_aware_plain_rows(*a, **kw),
                         ("lockstep", i))
            r1.hold(chk, launches["by_replicas"], name)
            del r1
            res[name] = dict(
                dir=exp_dir, wall=wall, launches=launches, chunks=chunks,
                tick_groups=len(groups["ticks"]),
                span_flushes=len(groups["spans"]),
                span_rows_launches=sum(f["ticks"] for f in tap.flushes
                                       if f["greedy"]),
                span_ms=sum(tap.flush_ms()),
                arms={s["label"] + "/" + str(i // 3): s["wall_clock"]
                      for i, s in enumerate(sums)})
        files = {n: grid_files(res[n]["dir"])
                 for n in ("lockstep", "sequential")}
        names = sorted({k[0] for k in files["sequential"]})
        differ = files_differ(files["lockstep"], files["sequential"])
    lk, sq = res["lockstep"], res["sequential"]
    rows = sum(lk["launches"]["rows"].values())
    if differ or len(names) != traces:
        raise AssertionError(f"lockstep files differ from sequential: "
                             f"{differ[:6]} ({len(names)} traces)")
    if sum(sq["launches"]["rows"].values()) or sq["chunks"]:
        raise AssertionError(f"the sequential grid coalesced: {sq}")
    if not rows or not lk["span_flushes"] or not lk["span_rows_launches"]:
        raise AssertionError(f"lockstep: nothing coalesced: {lk}")
    stats = {k: sum(c.get(k, 0) for c in lk["chunks"]) for k in (
        "dispatches", "device_calls", "coalesced", "ragged_merges",
        "ragged_rows", "ragged_pad_cells")}
    ca_ticks = rows - lk["span_rows_launches"]
    log(f"  (b) lockstep overall, {traces} traces x 3 arms x {apps} apps at "
        f"{n_hosts} hosts: files byte-identical to the sequential cuda grid;"
        f" wall {lk['wall']!r} s vs {sq['wall']!r} s sequential")
    log(f"    {rows} per-row launches ({ca_ticks} coalesced Cost-Aware "
        f"ticks, {lk['span_rows_launches']} span ticks of "
        f"{lk['span_flushes']} coalesced span flushes), by G "
        f"{lk['launches']['rows']}, each held against cost_aware_plain_rows; "
        f"R=1 launches {lk['launches']['by_replicas']} (sequential, the "
        f"comparison: {sq['launches']['by_replicas']}), each held against "
        f"cost_aware_plain (max |avail diff| {chk.max_abs_err!r}); batched "
        f"span driver "
        f"{lk['span_ms']!r} ms on the device timeline; batcher {stats}")
    return dict(
        wall=lk["wall"], wall_sequential=sq["wall"], batcher=stats,
        rows_launches=rows, span_flushes=lk["span_flushes"],
        span_rows_launches=lk["span_rows_launches"],
        tick_groups=lk["tick_groups"],
        launches=lk["launches"], launches_sequential=sq["launches"],
        rows_by_g=lk["launches"]["rows"],
        r1_launches=lk["launches"]["by_replicas"].get(1, 0),
        compare_r1_launches=sq["launches"]["by_replicas"].get(1, 0),
        max_abs_err=chk.max_abs_err,
        arm_walls=dict(lockstep=lk["arms"], sequential=sq["arms"]),
        files=files["lockstep"])


GRID_FILES = ("general.json", "transfers.json", "scheduler.json",
              "host_usage.json")


def grid_files(exp_dir) -> dict:
    """An ``overall`` grid's output files: ``{(trace, arm, file): bytes}``."""
    out = {}
    for sub in sorted(os.listdir(os.path.join(exp_dir, "data"))):
        for arm in ARMS:
            for f in GRID_FILES:
                with open(os.path.join(exp_dir, "data", sub, arm, f),
                          "rb") as fh:
                    out[sub, arm, f] = fh.read()
    return out


def files_differ(a: dict, b: dict) -> list:
    """The keys whose bytes differ, or that one side lacks."""
    return sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))


def p11_serve(device) -> dict:
    """Phase 11 (c): the three serve commands of the path through
    ``cli.main`` on cuda: sessions equal batch mode on the jobs they
    injected, ``audit()`` clean, every per-row launch (coalesced ticks and
    span ticks) held against ``cost_aware_plain_rows`` and every R = 1
    call of the resident run (its span ticks and per-tick placements)
    against ``cost_aware_plain``; the ragged arm merges, the resident arm
    runs spans on its carries with edit rows."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.serve import poisson_arrivals, trace_arrivals
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import (
        PolicyConfig, build_cluster, make_policy)
    from pivot_tpu_torch.workload.trace import TraceSchedule

    card = card_line()
    chk = Check()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in P11_SERVE.items():
            report, rec, launches = serve_run(cli, ck, name, tmp, argv)
            c, st = report["slo"]["counters"], report["batcher"]
            rows = sum(launches["rows"].values())
            r1 = launches["by_replicas"].get(1, 0)
            if c["completed"] != c["admitted"] or \
                    c["completed"] + c["shed"] != c["arrived"]:
                raise AssertionError(f"serve {name}: {c}")
            if launches["total"] != rows + r1 or \
                    set(launches["by_replicas"]) - {1} or \
                    rows != len(rec.rows):
                raise AssertionError(f"serve {name}: launches {launches}, "
                                     f"{len(rec.rows)} recorded")
            span_stats = [s.summary()["span_stats"] for s in rec.sessions]
            fused = sum(x["fused_spans"] for x in span_stats)
            resident = [s.policy.dispatch_stats().get("resident")
                        for s in rec.sessions]
            if not fused or not c.get("span_dispatches"):
                raise AssertionError(f"serve {name}: no span served")
            if name == "resident":
                spans = sum(x["spans"] for x in resident)
                edits = sum(x["edit_rows"] for x in resident)
                if st is not None or rows or not spans or not edits:
                    raise AssertionError(f"serve resident: batcher {st}, "
                                         f"{rows} per-row launches, "
                                         f"resident {resident}")
                if len(rec.r1) != r1:
                    raise AssertionError(f"serve resident: {len(rec.r1)} "
                                         f"R=1 calls recorded of {r1}")
            elif name == "ragged_trace" and not st["ragged_merges"]:
                raise AssertionError(f"serve ragged_trace: no merge: {st}")
            elif name == "no_ragged" and st["ragged_merges"]:
                raise AssertionError(f"serve no_ragged merged: {st}")
            rec.driver.audit(f"serve {name}")
            for i, (a, k, got) in enumerate(rec.rows):
                chk.same(got, ck.cost_aware_plain_rows(*a, **k),
                         (name, "rows", i))
            for i, (a, k, got) in enumerate(rec.r1):
                chk.same(got, ck.cost_aware_plain(*a, **k), (name, "r1", i))
            # Each session against a batch-mode run (per-tick, no spans)
            # of the jobs it injected, fresh from the seed.
            args = cli.parse_args(["serve", *argv])
            reset_ids()
            if args.source == "trace":
                stream = trace_arrivals(
                    cli._list_traces(args.job_dir, 1)[0], n_apps=args.jobs,
                    scale_factor=args.scale_factor,
                    rate=args.arrival_rate or None, seed=args.seed)
            else:
                stream = poisson_arrivals(args.arrival_rate, args.jobs,
                                          seed=args.seed)
            fresh = {x.app.id: x.app for x in stream}
            if c["arrived"] != len(fresh):
                raise AssertionError(f"serve {name}: {c['arrived']} arrived "
                                     f"of a {len(fresh)}-job stream")
            pcfg = PolicyConfig(name="cost-aware", device="cuda",
                                bin_pack="first-fit", sort_tasks=True,
                                sort_hosts=True)
            for g, sess in enumerate(sorted(rec.sessions,
                                            key=lambda s: s.slot)):
                apps = [fresh[app.id] for app in sess._injected]
                run = ExperimentRun(
                    f"batch-{g}", build_cluster(cli._cluster_config(args)),
                    make_policy(pcfg), schedule=TraceSchedule(
                        [(0.0, [])] + [(app._serve_admit_ts, [f]) for app, f
                                       in zip(sess._injected, apps)]),
                    seed=args.seed, interval=5.0, fuse_spans=False)
                want = run.run()
                served = [t.placement for app in sess._injected
                          for grp in app.groups for t in grp.tasks]
                batch_p = [t.placement for app in apps
                           for grp in app.groups for t in grp.tasks]
                if served != batch_p:
                    raise AssertionError(f"serve {name}: session {g}'s "
                                         "placements differ from batch mode")
                got = sess.summary()
                if {k: got[k] for k in SERVE_KEYS} != {
                        k: want[k] for k in SERVE_KEYS}:
                    raise AssertionError(f"serve {name}: session {g}'s "
                                         f"summary {got} != batch {want}")
            row = serve_log(name, report, launches, card)
            row.update(
                fused_spans=fused, span_dispatches=c["span_dispatches"],
                span_ticks=c["span_ticks"],
                span_aborts=sum(x["span_aborts"] for x in span_stats),
                span_splices=sum(x["span_splices"] for x in span_stats),
                span_groups=len(rec.span_groups),
                resident=resident if name == "resident" else None)
            if name == "resident":
                row["resident_totals"] = {k: sum(x[k] for x in resident)
                                          for k in resident[0]}
            log(f"    spans: {fused} served ({c['span_ticks']} ticks, "
                f"{row['span_aborts']} aborted, {row['span_splices']} "
                f"spliced), {row['span_groups']} coalesced span flushes; "
                + (f"resident {row['resident_totals']}"
                   if name == "resident" else
                   f"ragged merges {st['ragged_merges']}, rows "
                   f"{st['ragged_rows']}, pad cells {st['ragged_pad_cells']}")
                + f"; sessions = batch mode on their "
                f"{sum(len(s._injected) for s in rec.sessions)} jobs, audit "
                "clean")
            out[name] = row
    log(f"  (c) {chk.cases} launches held against their plain version "
        f"(per-row: cost_aware_plain_rows; the R=1 calls of the "
        f"batcher's one-request flushes and of the resident run: "
        f"cost_aware_plain), {chk.placed} placements, max |avail diff| "
        f"{chk.max_abs_err!r}")
    out["max_abs_err"] = chk.max_abs_err
    return out


def phase_batching(device) -> dict:
    """Phase 11: cross-run batching on the card (module docstring)."""
    card = card_line()
    log(f"  [{card}]")
    rec = {}
    t0 = time.perf_counter()
    rec["flushes"] = p11_flushes(device)
    rec["resident_chain"] = p11_resident(device)
    log(f"  (a) + (d): {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    rec["lockstep"] = p11_lockstep(device)
    log(f"  (b): {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    rec["serve"] = p11_serve(device)
    log(f"  (c): {time.perf_counter() - t0!r} s")
    # The path's launches; the comparison sides' (the solo spans of (a),
    # the sequential grid of (b)) apart.
    sv = [rec["serve"][k]["launches"] for k in P11_SERVE]
    rec["launches_r1"] = (
        rec["resident_chain"]["r1_launches"] + rec["lockstep"]["r1_launches"]
        + sum(x["by_replicas"].get(1, 0) for x in sv))
    rec["compare_launches_r1"] = (rec["flushes"]["compare_r1_launches"]
                                  + rec["lockstep"]["compare_r1_launches"])
    by_g = {}
    for d in (rec["flushes"]["rows_by_g"], rec["lockstep"]["rows_by_g"],
              *(x["rows"] for x in sv)):
        for g, n in d.items():
            by_g[g] = by_g.get(g, 0) + n
    rec["launches_rows_by_g"] = by_g
    rec["launches_rows"] = sum(by_g.values())
    rec["max_abs_err"] = max(rec[k]["max_abs_err"] for k in (
        "flushes", "resident_chain", "lockstep", "serve"))
    return rec


# -- phase 12: model-predictive serving and the recovery plane ---------------

#: (a) the README's MPC command (``README.md``, the model-predictive
#: serving section), at the CLI's 600 hosts a session; the same with
#: ``--mpc-dry-run``, and without the MPC (the outcome the dry run must
#: serve).
P12_README = ("--sessions", "1", "--jobs", "300", "--arrival-rate", "2.5",
              "--queue-depth", "16", "--tier-mix", "0.4,0.3,0.3",
              "--tier-policies", "spill,shed,shed", "--preempt")
P12_MPC = ("--mpc", "--mpc-pool", "1:4")
#: (b) the paced soak: a mixed-tier stream at the README's tier mix, the
#: controller at MpcConfig's defaults (env_apps 6, 4 replicas, horizon
#: 300, tick 5) with the pool 1:4, the tuner on and a referee every 4th
#: window; paced so that the controller plans at least P12_WINDOWS
#: windows (the pace is set from one timed window before the run).
P12_SOAK_JOBS = 120
P12_SOAK_RATE = 0.5
P12_WINDOWS = 8
#: A window in the run over the lone timed window: the serving threads
#: and the tuner share the card and the host (2.7 on an NVIDIA H100 80GB
#: HBM3 at 700 W, ``chip_smoke.py --phases 12``).
P12_CONTENTION = 3.0
#: (c) phase 11 (c)'s resident run (3 sessions, 300 jobs at rate 25,
#: ``--fuse-spans slo --resident --splice-tier 1``) through the library,
#: with one far-future straggler that keeps the release frontier open
#: while the killed run waits for its first snapshot (as
#: ``tests/test_recovery.py``'s soak): every run slices its spans alike.
#: The plane's snapshot cadence counts the spans of the whole pool
#: (``RecoveryPlane.note_span``, as the reference), so with several
#: session threads which session's carry a snapshot holds is a matter of
#: thread timing, and the plane's own resume check (``resume_verified``)
#: may meet the snapshot's span number on another session's carry: the
#: phase matches the snapshot to the resumed session whose own span and
#: splice counts it recorded, and holds the carries equal there.
P12_RESIDENT = dict(sessions=3, jobs=300, rate=25.0)
P12_STRAGGLER_TS = 10_000.0


def p12_outcome(report) -> dict:
    c = report["slo"]["counters"]
    return {k: c.get(k, 0) for k in ("arrived", "admitted", "completed",
                                     "shed", "decisions")}


def p12_hold(ck, rec, chk, what) -> None:
    """Every ``greedy_place`` launch a recorder saw against its plain
    version on the same operands."""
    for i, (a, k, got) in enumerate(rec.rows):
        chk.same(got, ck.cost_aware_plain_rows(*a, **k), (what, "rows", i))
    for i, (a, k, got) in enumerate(rec.r1):
        chk.same(got, ck.cost_aware_plain(*a, **k), (what, "r1", i))


def p12_launches(ck) -> dict:
    return dict(total=ck.LAUNCHES["greedy_place"],
                rows=dict(ck.LAUNCHES_ROWS),
                by_replicas=dict(ck.LAUNCHES_BY_REPLICAS),
                chain=ck.LAUNCHES["ensemble_chain"])


def p12_readme(device, chk) -> dict:
    """(a) The README's MPC command through ``cli.main`` on the card, with
    ``--mpc-dry-run``, and without the MPC: at least one plan, never
    referee-disabled, ``audit()`` clean; the dry run serves the MPC-off
    outcome; every launch held against its plain version."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.utils import reset_ids

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("mpc", P12_MPC),
                            ("dry_run", P12_MPC + ("--mpc-dry-run",)),
                            ("off", ())):
            argv = ["--output-dir", tmp, "serve", *P12_README, *extra]
            rec = ServeRecorder()
            buf = io.StringIO()
            reset_ids()
            if extra:
                # The entry must turn TF32 off itself (its evaluator's
                # egress product needs full float32).
                torch.backends.cuda.matmul.allow_tf32 = True
            ck.reset_launches()
            t0 = time.perf_counter()
            with rec.attach(), contextlib.redirect_stdout(buf):
                cli.main(argv)
            wall = time.perf_counter() - t0
            launches = p12_launches(ck)
            report = json.loads(buf.getvalue().strip().splitlines()[-1])
            rec.driver.audit(f"serve {name}")
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("serve --mpc left TF32 on")
            rows = sum(launches["rows"].values())
            r1 = launches["by_replicas"].get(1, 0)
            if launches["total"] != rows + r1 or rows != len(rec.rows) \
                    or r1 != len(rec.r1):
                raise AssertionError(f"serve {name}: launches {launches}, "
                                     f"{len(rec.rows)} per-row and "
                                     f"{len(rec.r1)} R=1 recorded")
            p12_hold(ck, rec, chk, name)
            m = report["mpc"]
            if name != "off":
                if not m["plans"] or m["disabled"]:
                    raise AssertionError(f"serve {name}: mpc {m}")
                if m["forecast"]["n_observed"] != \
                        report["slo"]["counters"]["arrived"]:
                    raise AssertionError(f"serve {name}: the forecaster "
                                         "missed arrivals")
                if rec.driver._mpc.captures_after_warmup():
                    raise AssertionError(f"serve {name}: graphs captured "
                                         "after the warm-up")
                if not launches["chain"]:
                    raise AssertionError(f"serve {name}: the planner's "
                                         "rollouts made no ensemble_chain "
                                         "launch")
            elif m is not None:
                raise AssertionError("serve off: an MPC report")
            if report["slo"]["tiers"]["0"]["counters"]["shed"]:
                raise AssertionError(f"serve {name}: tier 0 shed")
            out[name] = dict(
                wall_s=wall, outcome=p12_outcome(report), launches=launches,
                mpc=m and {k: m[k] for k in ("rounds", "plans", "disabled",
                                              "dry_run", "tuner")},
                actions=m and rec.driver._mpc.action_counts(),
                pool=report["pool"])
            log(f"  (a) serve {name}: wall {wall!r} s, outcome "
                f"{out[name]['outcome']}, pool {report['pool']}, launches "
                f"R=1 {r1} per-row {launches['rows']}, ensemble_chain "
                f"{launches['chain']}"
                + (f", mpc rounds {m['rounds']} plans {m['plans']} actions "
                   f"{out[name]['actions']} tuner {m['tuner']}" if m else ""))
    if out["dry_run"]["outcome"] != out["off"]["outcome"]:
        raise AssertionError(f"--mpc-dry-run served {out['dry_run']} but "
                             f"the MPC-off run {out['off']}")
    return out


@contextlib.contextmanager
def p12_eval_tap(F):
    """Record one dict per ``evaluate_rows`` call (``F``: the port's
    ``search.fitness``) from any thread: ``thread``, ``rows``,
    ``wall_s``, and the row loop's ``ticks``, ``place_steps``,
    ``host_syncs`` and ``event_span_ms``."""
    calls = []
    local = threading.local()
    evaluate, fitness_rows = F.evaluate_rows, F._fitness_rows

    def rows(*args, **kw):
        return fitness_rows(*args, **dict(kw, stats=local.rec))

    def recorded(weights, env, **kw):
        local.rec = rec = {"thread": threading.current_thread().name}
        t0 = time.perf_counter()
        out = evaluate(weights, env, **kw)
        rec.update(wall_s=time.perf_counter() - t0, rows=out[1]["n_rows"])
        calls.append(rec)
        return out

    F.evaluate_rows, F._fitness_rows = recorded, rows
    try:
        yield calls
    finally:
        F.evaluate_rows, F._fitness_rows = evaluate, fitness_rows


@contextlib.contextmanager
def p12_planner_tap(PC):
    """Time each ``plan`` the controller makes (CUDA events on its
    thread; host clock off the card) and count its referee checks."""
    plans, referees = [], []
    plan, referee = PC.plan, PC.referee_check

    def timed(*a, **k):
        cuda = torch.cuda.is_available()
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
        t0 = time.perf_counter()
        out = plan(*a, **k)
        wall = time.perf_counter() - t0
        if cuda:
            end.record()
            end.synchronize()
        plans.append(dict(wall_ms=wall * 1e3, event_ms=(
            start.elapsed_time(end) if cuda else None)))
        return out

    def refereed(*a, **k):
        ok = referee(*a, **k)
        referees.append(ok)
        return ok

    PC.plan, PC.referee_check = timed, refereed
    try:
        yield plans, referees
    finally:
        PC.plan, PC.referee_check = plan, referee


def p12_cluster(cli, n_hosts):
    from pivot_tpu_torch.utils.config import build_cluster

    args = cli.parse_args(["--num-hosts", str(n_hosts), "serve"])
    return build_cluster(cli._cluster_config(args))


def p12_policy(device):
    from pivot_tpu_torch.utils.config import PolicyConfig, make_policy

    return make_policy(PolicyConfig(
        name="cost-aware", device="cuda", bin_pack="first-fit",
        sort_tasks=True, sort_hosts=True, adaptive=False),
        torch_device=str(device))


def p12_soak(device, chk, n_hosts=600) -> dict:
    """(b) The paced MPC soak through the library (module docstring)."""
    from pivot_tpu_torch import serve
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.mpc import MpcConfig
    from pivot_tpu_torch.mpc import controller as PC
    from pivot_tpu_torch.mpc.forecast import TierForecast, render_env
    from pivot_tpu_torch.mpc.planner import enumerate_actions, plan
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.search import fitness as F
    from pivot_tpu_torch.search.weights import DEFAULT_WEIGHTS
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.compile_counter import count_compiles

    cfg = MpcConfig(g_min=1, g_max=4, referee_every=4, tune=True, seed=0)
    # One window timed before the run sets the pace: the stream lasts
    # the wall of 1.5 x P12_WINDOWS windows in the run (a referee window
    # runs two plans), within 12-40 s (at 2 x the whole script planned
    # 21-25 windows, at 1 x 9 of the 8 needed).
    reset_ids()
    tpl = p12_cluster(cli, n_hosts)
    from pivot_tpu_torch.infra.market import MarketSchedule

    market = MarketSchedule.generate(tpl.meta, seed=0, horizon=cfg.horizon)
    env, _, tiers = render_env(
        TierForecast((0.2, 0.15, 0.15), (0.4, 0.3, 0.3), 8, 60.0),
        cluster=tpl, market=market, horizon=cfg.horizon, seed=cfg.seed,
        n_replicas=cfg.n_replicas, tick=cfg.tick, n_apps=cfg.env_apps,
        device=device)
    menu = enumerate_actions(1, g_min=1, g_max=4, incumbent=DEFAULT_WEIGHTS,
                             shed_tier=2)
    plan(menu, env, tiers, 1)  # warm: the graphs of this shape
    t0 = time.perf_counter()
    plan(menu, env, tiers, 1)
    window_s = time.perf_counter() - t0 + cfg.check_interval_s
    sim_span = P12_SOAK_JOBS / P12_SOAK_RATE
    wall_target = min(max(
        1.5 * P12_WINDOWS * 1.25 * P12_CONTENTION * window_s, 12.0), 40.0)
    pace = sim_span / wall_target
    log(f"  (b) one window {window_s!r} s: pace {pace!r} sim-s a wall-s "
        f"for ~{wall_target!r} s of stream")

    rec = ServeRecorder()
    reset_ids()
    ck.reset_launches()
    with count_compiles() as compiles, rec.attach(), \
            p12_eval_tap(F) as evals, \
            p12_planner_tap(PC) as (plans, referees):
        def make_session(label):
            return serve.ServeSession(label, p12_cluster(cli, n_hosts),
                                      p12_policy(device), seed=0)

        driver = serve.ServeDriver(
            [make_session("s0")], queue_depth=24, backpressure="shed",
            tier_policies=("spill", "shed", "shed"), preempt=True,
            session_factory=make_session, mpc=cfg)
        stream = serve.mixed_tier_arrivals(
            P12_SOAK_RATE, P12_SOAK_JOBS, (0.4, 0.3, 0.3), seed=0)
        t0 = time.perf_counter()
        report = driver.run(stream, pace=pace)
        wall = time.perf_counter() - t0
    launches = p12_launches(ck)
    driver.audit("mpc soak")
    ctl = driver._mpc
    m = report["mpc"]
    if m["rounds"] < P12_WINDOWS or m["disabled"]:
        raise AssertionError(f"mpc soak: {m['rounds']} windows planned, "
                             f"disabled {m['disabled']}")
    if not referees or not all(referees):
        raise AssertionError(f"mpc soak: referee checks {referees}")
    if report["slo"]["tiers"]["0"]["counters"]["shed"]:
        raise AssertionError("mpc soak: tier 0 shed")
    if ctl.captures_after_warmup():
        raise AssertionError(f"mpc soak: {ctl.captures_after_warmup()} "
                             "graph captures after the warm-up")
    if not launches["chain"]:
        raise AssertionError("mpc soak: the planner's rollouts made no "
                             "ensemble_chain launch")
    rows = sum(launches["rows"].values())
    r1 = launches["by_replicas"].get(1, 0)
    if launches["total"] != rows + r1 or rows != len(rec.rows) or \
            r1 != len(rec.r1):
        raise AssertionError(f"mpc soak: launches {launches}, "
                             f"{len(rec.rows)} per-row and {len(rec.r1)} "
                             "R=1 recorded")
    p12_hold(ck, rec, chk, "soak")
    planner = [e for e in evals if e["thread"] == "serve-mpc"]
    tuner = [e for e in evals if e["thread"] == "mpc-tuner"]
    stages = {}
    for evt in ctl.rollout.events:
        stages[evt["stage"]] = stages.get(evt["stage"], 0) + 1

    def med(xs):
        return statistics.median(xs) if xs else None

    row = dict(
        wall_s=wall, pace=pace, windows=m["rounds"], plans=m["plans"],
        plan_event_ms=[p["event_ms"] for p in plans],
        plan_wall_ms=[p["wall_ms"] for p in plans],
        plan_event_ms_median=med([p["event_ms"] for p in plans
                                  if p["event_ms"] is not None]),
        plan_wall_ms_median=med([p["wall_ms"] for p in plans]),
        window_ticks=med([e["ticks"] for e in planner]),
        window_place_steps=med([e["place_steps"] for e in planner]),
        window_host_syncs=med([e["host_syncs"] for e in planner]),
        window_rows=med([e["rows"] for e in planner]),
        tuner_calls=len(tuner), tuner_rows=med([e["rows"] for e in tuner]),
        referee_checks=len(referees), referee_passed=sum(referees),
        actions=ctl.action_counts(), tuner_rounds=ctl.tuner.rounds,
        tuner_eligible=m["tuner"]["eligible"], rollout_stages=stages,
        captures_after_warmup=ctl.captures_after_warmup(),
        captures_in_run=compiles.graph_captures,
        outcome=p12_outcome(report), pool=report["pool"],
        launches=launches,
        p50_ms=report["slo"]["decision_latency_s"]["p50"] * 1e3,
        p99_ms=report["slo"]["decision_latency_s"]["p99"] * 1e3)
    log(f"  (b) soak: wall {wall!r} s, {row['windows']} windows planned "
        f"({row['plans']} plans), plan ms median {row['plan_event_ms_median']!r}"
        f" (events) / {row['plan_wall_ms_median']!r} (host), a window "
        f"{row['window_ticks']!r} ticks, {row['window_place_steps']!r} "
        f"steps, {row['window_host_syncs']!r} host reads over "
        f"{row['window_rows']!r} rows; referee {row['referee_passed']}/"
        f"{row['referee_checks']} passed; actions {row['actions']}; tuner "
        f"{row['tuner_rounds']} rounds ({row['tuner_eligible']} eligible, "
        f"{row['tuner_calls']} evaluator calls); rollout {stages}; graph "
        f"captures after warm-up {row['captures_after_warmup']} (in the "
        f"run {row['captures_in_run']}); outcome {row['outcome']}, pool "
        f"{report['pool']}; launches R=1 {r1} per-row {launches['rows']}, "
        f"ensemble_chain {launches['chain']}")
    return row


def p12_resident_stream(straggler=True):
    from pivot_tpu_torch.serve import JobArrival, poisson_arrivals
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.workload import Application, TaskGroup

    reset_ids()
    arrs = list(poisson_arrivals(P12_RESIDENT["rate"], P12_RESIDENT["jobs"],
                                 seed=0))
    if straggler:
        arrs.append(JobArrival(ts=P12_STRAGGLER_TS, app=Application(
            "straggler", [TaskGroup("s", cpus=1, mem=32, runtime=2.0,
                                    instances=1)]), tier=0))
    return arrs


def p12_kill_when_snapshotted(arrs, driver, timeout_s=120.0):
    """The stream, then a wait for the first snapshot, then a kill."""
    yield from arrs
    deadline = time.monotonic() + timeout_s
    while driver._recovery.snapshots.written < 1:
        if time.monotonic() > deadline:
            raise AssertionError("the killed run wrote no snapshot")
        time.sleep(0.01)
    raise RuntimeError("injected kill: the server died mid-stream")


def p12_resident_run(device, chk, name, recovery, n_hosts=600, kill=False,
                     wedge=None, carries=None):
    """One run of (c) / (d): the resident pool through the library, every
    R = 1 call recorded and held against its plain version; with
    ``carries`` (a list), each span's pending carry, exported to the host
    after the span, with its session's span and splice counts.  Returns
    ``(sorted final placements, each session's decision log, report or
    None, driver, launches)``."""
    from pivot_tpu_torch.ops.tickloop import resident_carry_export
    from pivot_tpu_torch import serve
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck

    arrs = p12_resident_stream()
    rec = ServeRecorder()
    ck.reset_launches()
    report = None
    with rec.attach():
        sessions = [serve.ServeSession(
            f"session-{g}", p12_cluster(cli, n_hosts), p12_policy(device),
            seed=0, fuse_spans="slo")
            for g in range(P12_RESIDENT["sessions"])]
        if wedge is not None:
            wedge(sessions[0].policy)
        for s in sessions if carries is not None else ():
            def export(ctx, plan, _orig=s.policy.place_span, _p=s.policy):
                out = _orig(ctx, plan)
                rs = _p._resident
                carries.append((rs.spans, rs.splices,
                                resident_carry_export(rs.carry)))
                return out

            s.policy.place_span = export
        driver = serve.ServeDriver(
            sessions, queue_depth=64, backpressure="shed", resident=True,
            splice_tier=1, recovery=recovery)
        if kill:
            try:
                driver.run(p12_kill_when_snapshotted(arrs, driver))
            except RuntimeError as e:
                if "injected kill" not in str(e):
                    raise
            else:
                raise AssertionError("the killed run was not killed")
        else:
            report = driver.run(iter(arrs))
            driver.audit(f"resident {name}")
    launches = p12_launches(ck)
    r1 = launches["by_replicas"].get(1, 0)
    if launches["total"] != r1 or r1 != len(rec.r1):
        raise AssertionError(f"resident {name}: launches {launches}, "
                             f"{len(rec.r1)} R=1 recorded")
    p12_hold(ck, rec, chk, name)
    placements = sorted(((t.id, t.placement) for a in arrs
                         for g in a.app.groups for t in g.tasks),
                        key=lambda x: (x[0], str(x[1])))
    logs = [[None if x is None else x.tolist() for x in s.log]
            for s in sorted(rec.sessions, key=lambda s: s.label)]
    return placements, logs, report, driver, launches


def p12_recovery(device, chk, n_hosts=600) -> dict:
    """(c) recovery over the resident stream and (d) the armed watchdog
    (module docstring)."""
    from pivot_tpu_torch.recover import DispatchTimeout, RecoveryConfig
    from pivot_tpu_torch.sched.retry import RetryPolicy

    out = {}
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        plain, plain_log, rep_plain, _, launches["none"] = p12_resident_run(
            device, chk, "none", None, n_hosts)

        def cfg(sub, **kw):
            return RecoveryConfig(directory=os.path.join(tmp, sub),
                                  snapshot_every=2, **kw)

        t0 = time.perf_counter()
        ref, ref_log, rep_ref, drv_ref, launches["armed"] = \
            p12_resident_run(device, chk, "armed", cfg("ref"), n_hosts)
        armed_wall = time.perf_counter() - t0
        if (ref, ref_log) != (plain, plain_log) or \
                p12_outcome(rep_ref) != p12_outcome(rep_plain):
            raise AssertionError("recovery=None and the armed plane decide "
                                 "differently")
        plane = drv_ref._recovery
        snap = rep_ref["recovery"]["snapshots"]
        if not snap["written"]:
            raise AssertionError("the armed run wrote no snapshot")
        _, _, _, drv_kill, launches["killed"] = p12_resident_run(
            device, chk, "killed", cfg("kill"), n_hosts, kill=True)
        with open(os.path.join(tmp, "kill", "journal.jsonl"), "a",
                  encoding="utf-8") as f:
            f.write('{"seq": 99999, "kind": "adm')  # torn mid-append
        carries = []
        res, res_log, rep_res, drv_res, launches["resumed"] = \
            p12_resident_run(device, chk, "resumed",
                             cfg("kill", resume=True), n_hosts,
                             carries=carries)
        resumed = drv_res._recovery
        if resumed.restored is None:
            raise AssertionError("resume: no snapshot survived the kill")
        if (res, res_log) != (ref, ref_log) or \
                p12_outcome(rep_res) != p12_outcome(rep_ref):
            raise AssertionError("the resumed run decides differently from "
                                 "the uninterrupted run")
        # The snapshot against the resumed session that re-reached its
        # span and splice counts (P12_RESIDENT's note): equal carry,
        # equal fingerprint under the snapshot's own meta.
        from pivot_tpu_torch.recover import fingerprint_arrays

        arrays, rmeta = resumed.restored
        submit = {k: v for k, v in rmeta.items()
                  if k not in ("fingerprint", "snapshot_seq")}
        matched = [
            c for spans, splices, c in carries
            if (spans, splices) == (rmeta["policy_spans"], rmeta["splices"])
            and set(c) == set(arrays) - {"risk"}
            and all(np.array_equal(c[k], arrays[k]) for k in c)
            and fingerprint_arrays(
                dict(c, **({"risk": arrays["risk"]} if "risk" in arrays
                           else {})), submit) == rmeta["fingerprint"]]
        if not matched:
            raise AssertionError("resume: no resumed session's carry "
                                 "equals the restored snapshot")
        out["c"] = dict(
            armed_wall_s=armed_wall, decisions=sum(map(len, ref_log)),
            journal_records=rep_ref["recovery"]["journal"]["records"],
            journal_fsyncs=rep_ref["recovery"]["journal"]["fsyncs"],
            snapshots_written=snap["written"],
            snapshots_dropped=snap["dropped"],
            spans_seen=rep_ref["recovery"]["spans_seen"],
            splices_seen=rep_ref["recovery"]["splices_seen"],
            clone_ms=list(plane.clone_ms),
            clone_ms_median=statistics.median(plane.clone_ms),
            d2h_bytes=plane.snapshots.d2h_bytes,
            d2h_bytes_a_snapshot=plane.snapshots.d2h_bytes // snap["written"],
            killed_snapshots=drv_kill._recovery.snapshots.written,
            resumed_snapshot_span=resumed.restored[1]["span"],
            resume_verified=resumed.resume_verified,
            carry_matched=len(matched),
            outcome=p12_outcome(rep_ref))
        c = out["c"]
        log(f"  (c) resident x {P12_RESIDENT['sessions']} sessions: "
            f"recovery=None and the armed plane decide alike "
            f"({c['decisions']} decisions); armed wall {armed_wall!r} s; "
            f"journal {c['journal_records']} records ({c['journal_fsyncs']} "
            f"fsyncs), {c['snapshots_written']} snapshots written "
            f"({c['snapshots_dropped']} dropped) of {c['spans_seen']} spans; "
            f"clone on the dispatch thread median {c['clone_ms_median']!r} "
            f"ms ({len(c['clone_ms'])} clones); D2H {c['d2h_bytes']} bytes "
            f"({c['d2h_bytes_a_snapshot']} a snapshot); killed after "
            f"{c['killed_snapshots']} snapshots, resumed from span "
            f"{c['resumed_snapshot_span']}: decisions equal the "
            "uninterrupted run's, a resumed session's carry equal to the "
            "snapshot (fingerprint and arrays; the plane's own check "
            f"{c['resume_verified']})")

        # (d) the watchdog armed: one resident dispatch wedges (parked past
        # the timeout, before it consumes the carry), is abandoned, retried.
        release = threading.Event()
        wedged = []

        def wedge(policy):
            orig = policy._resident_dispatch

            def wedged_dispatch(*a, **k):
                if not wedged:
                    wedged.append(threading.current_thread().name)
                    release.wait(120.0)
                    raise DispatchTimeout("wedged dispatch released")
                return orig(*a, **k)

            policy._resident_dispatch = wedged_dispatch

        t0 = time.perf_counter()
        try:
            wd_pl, wd_log, rep_wd, _, launches["watchdog"] = \
                p12_resident_run(device, chk, "watchdog",
                                 cfg("wd", dispatch_timeout_s=2.0,
                                     retry=RetryPolicy(max_retries=1,
                                                       base=0.0)),
                                 n_hosts, wedge=wedge)
        finally:
            release.set()
        wd_wall = time.perf_counter() - t0
        wd = rep_wd["recovery"]["watchdog"]
        if (wd_pl, wd_log) != (plain, plain_log) or \
                p12_outcome(rep_wd) != p12_outcome(rep_plain):
            raise AssertionError("the armed watchdog run decides differently "
                                 "from the no-fault run")
        if wd["timeouts"] != 1 or wd["retries_total"] != 1 or \
                wd["failures"]:
            raise AssertionError(f"watchdog {wd}")
        out["d"] = dict(wall_s=wd_wall, watchdog=wd,
                        wedged_thread=wedged[0])
        log(f"  (d) watchdog: one wedged resident dispatch timed out "
            f"(2.0 s) and was retried; decisions equal the no-fault run; "
            f"wall {wd_wall!r} s; {wd}")
    out["launches"] = launches
    return out


def phase_mpc_recovery(device) -> dict:
    """Phase 12: model-predictive serving and the recovery plane on the
    card (module docstring)."""
    card = card_line()
    log(f"  [{card}]")
    chk = Check()
    rec = {}
    t0 = time.perf_counter()
    rec["readme"] = p12_readme(device, chk)
    log(f"  (a): {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    rec["soak"] = p12_soak(device, chk)
    log(f"  (b): {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    rec["recovery"] = p12_recovery(device, chk)
    log(f"  (c) + (d): {time.perf_counter() - t0!r} s")
    path = [rec["readme"]["mpc"]["launches"],
            rec["readme"]["dry_run"]["launches"], rec["soak"]["launches"],
            *(rec["recovery"]["launches"][k]
              for k in ("armed", "killed", "resumed", "watchdog"))]
    compare = [rec["readme"]["off"]["launches"],
               rec["recovery"]["launches"]["none"]]
    rec["launches_r1"] = sum(x["by_replicas"].get(1, 0) for x in path)
    by_g = {}
    for x in path:
        for g, n in x["rows"].items():
            by_g[g] = by_g.get(g, 0) + n
    rec["launches_rows_by_g"] = by_g
    rec["launches_rows"] = sum(by_g.values())
    rec["compare_launches"] = sum(x["total"] for x in compare)
    rec["chain_launches"] = sum(x["chain"] for x in path[:3])
    rec["held"] = chk.cases
    rec["max_abs_err"] = chk.max_abs_err
    log(f"  {chk.cases} launches held against their plain version "
        f"(R=1: cost_aware_plain, per-row: cost_aware_plain_rows), "
        f"{chk.placed} placements, max |avail diff| {chk.max_abs_err!r}; "
        f"path launches R=1 {rec['launches_r1']} per-row {by_g}; "
        f"comparison sides (the MPC-off and recovery=None runs) "
        f"{rec['compare_launches']}; ensemble_chain launches of the "
        f"planner's and tuner's rollouts (a), (b) {rec['chain_launches']}")
    return rec


# -- phase 13: the native fabric, the degrade guard, the profiler ----------

#: (b) the kernel entry point's call (0-based) that raises in the
#: guard-off run, and the ``degrade_after`` the card policies must refuse.
P13_FAULT_AT = 5
P13_DEGRADE_AFTER = 2
#: (b) apps of phase 3's trace each run serves, per-tick dispatch
#: (37 ticks).
P13_GUARD_APPS = 16
#: (c) the profiler's cadence on phase 10's README serve command.
P13_PROFILE_EVERY = 4
#: (d) apps of the ``--profile-dir`` run.
P13_TRACE_APPS = 8
#: The relative tolerances of ``tests/test_native.py``'s full-sim parity.
P13_REL = {"sim_time": 1e-12, "avg_runtime": 1e-9, "egress_cost": 1e-9,
           "avg_congestion_delay": 1e-9}


def census_line(census, phase, exempt=()) -> None:
    n = census.check(phase, exempt)
    log(f"  phase {phase}: {n} device policies built, each with the degrade "
        "guard off (degrade_after is None) and no kernel failure")


class PolicyCensus:
    """Every device policy (``sched.cuda._DevicePolicyBase``) built while
    installed, so that a phase can assert at its end that none ran with
    the degrade guard on or recorded a kernel failure: a failing kernel
    is never served by the numpy twin unseen."""

    def __init__(self):
        self.policies = []
        self._base = None
        self._init = None

    def install(self) -> "PolicyCensus":
        from pivot_tpu_torch.sched.cuda import _DevicePolicyBase

        init, policies = _DevicePolicyBase.__init__, self.policies

        def counted(policy, *a, **k):
            init(policy, *a, **k)
            policies.append(policy)

        self._base, self._init = _DevicePolicyBase, init
        _DevicePolicyBase.__init__ = counted
        return self

    def uninstall(self) -> None:
        if self._base is not None:
            self._base.__init__ = self._init
            self._base = None

    def check(self, phase, exempt=()) -> int:
        """Assert the guard off and no kernel failure on every policy the
        phase built (but ``exempt``); forget them; return how many."""
        skip = {id(p) for p in exempt}
        seen = [p for p in self.policies if id(p) not in skip]
        self.policies.clear()
        for p in seen:
            if p.degrade_after is not None or p.kernel_failures:
                raise AssertionError(
                    f"phase {phase}: {type(p).__name__} ran with "
                    f"degrade_after={p.degrade_after!r} and "
                    f"{p.kernel_failures} kernel failures")
        return len(seen)


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


class CloneTap:
    """Records every ``CudaCostAwarePolicy._greedy`` call that returns —
    one ``greedy_place`` launch each — with clones of its operands and
    outputs (queued on the stream: no sync), held against
    ``cost_aware_plain`` after the run."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def attach(self):
        from pivot_tpu_torch.sched.cuda import CudaCostAwarePolicy

        greedy, calls = CudaCostAwarePolicy._greedy, self.calls

        def _greedy(policy, *a, **k):
            out = greedy(policy, *a, **k)
            calls.append((_clone(a), _clone(k), _clone(out)))
            return out

        CudaCostAwarePolicy._greedy = _greedy
        try:
            yield self
        finally:
            CudaCostAwarePolicy._greedy = greedy

    def hold(self, ck, chk, what) -> None:
        for i, (a, k, got) in enumerate(self.calls):
            chk.same(got, ck.cost_aware_plain(*a, **k), (what, i))


def _rel_ok(a, b, rel) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b))


def _trace_job_dir(tmp) -> str:
    """A job directory holding phase 3's trace alone."""
    job_dir = os.path.join(tmp, "jobs")
    os.makedirs(job_dir)
    os.symlink(os.path.abspath(TRACE),
               os.path.join(job_dir, os.path.basename(TRACE)))
    return job_dir


def p13_native(device, e2e, chk, n_apps=E2E_APPS) -> dict:
    """(a) ``overall --network native`` on cuda, fusion on, against phase
    3's python-fabric cuda run; every Cost-Aware launch held."""
    from pivot_tpu_torch import native
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck

    if not native.available():
        raise AssertionError("the native fabric did not build (g++): "
                             f"{native._lib_error}")
    py = e2e["runs"]["cuda"]
    tap = CloneTap()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        argv = overall_argv(os.path.join(tmp, "native"),
                            _trace_job_dir(tmp), "cuda")
        argv[-1] = str(n_apps)
        argv = ["--network", "native", *argv]
        with tap.attach():
            ck.reset_launches()  # the main path's count starts here
            t0 = time.perf_counter()
            exp_dir, summaries, objs = run_cli(cli, argv, device, True)
            wall = time.perf_counter() - t0
            launches = ck.LAUNCHES["greedy_place"]
            cf_launches = ck.LAUNCHES["carry_free_place"]
        if [r.cluster.network_backend for r in objs] != ["native"] * 3:
            raise AssertionError("(a) a run did not use the native fabric")
        check_outputs(exp_dir)
        arms = {s["label"]: s for s in summaries}
        host = {s["label"]: host_ms_per_tick(s, r.device_calls)
                for s, r in zip(summaries, objs)}
        same_general = {}
        for arm in ARMS:
            with open(os.path.join(exp_dir, "data", "0", arm,
                                   "general.json"), "rb") as f:
                same_general[arm] = f.read() == py["general"][arm]
    for arm in ARMS:
        for key, rel in P13_REL.items():
            got, want = arms[arm][key], py["arms"][arm][key]
            if not _rel_ok(got, want, rel):
                raise AssertionError(
                    f"(a) {arm}: {key} {got!r} on the native fabric vs "
                    f"{want!r} on the python fabric (rel {rel})")
    ca = arms["Cost-Aware"]["dispatch"]
    if not (ca["device_ticks"] > 0 and ca["kernel_ticks"] == ca["device_ticks"]
            and launches == ca["kernel_ticks"] + ca["span_kernel_ticks"]
            == len(tap.calls)):
        raise AssertionError(f"(a) not every Cost-Aware tick was a launch: "
                             f"{ca}, {launches} launches, "
                             f"{len(tap.calls)} recorded")
    cf_ticks = 0
    for arm in ARMS[:2]:
        d = arms[arm]["dispatch"]
        if not (d["device_ticks"] > 0
                and d["kernel_ticks"] == d["device_ticks"]):
            raise AssertionError(f"(a) {arm}: not every device tick was a "
                                 f"carry_free_place launch: {d}")
        cf_ticks += d["kernel_ticks"] + d["span_kernel_ticks"]
    if cf_launches != cf_ticks:
        raise AssertionError(f"(a) {cf_launches} carry_free_place launches "
                             f"for {cf_ticks} Opportunistic and VBP ticks")
    t0 = time.perf_counter()
    tap.hold(ck, chk, "(a) native Cost-Aware")
    log(f"  (a) overall --network native, 600 hosts x {n_apps} apps, cuda, "
        f"fusion on: {wall!r} s for 3 arms; against phase 3's python "
        f"fabric: sim_time within rel 1e-12, avg_runtime, egress_cost and "
        f"avg_congestion_delay within rel 1e-9 in every arm; "
        f"{launches} greedy_place launches ({ca['kernel_ticks']} per-tick,"
        f" {ca['span_kernel_ticks']} span ticks), each equal to "
        f"cost_aware_plain ({time.perf_counter() - t0:.1f} s to hold)")
    for arm in ARMS:
        hp, hn = py["host"][arm], host[arm]
        log(f"    {arm}: general.json byte-equal to the python fabric's: "
            f"{same_general[arm]}; wall python {hp['wall_s']!r} s / native "
            f"{hn['wall_s']!r} s; device calls {hp['device_call_s']!r} / "
            f"{hn['device_call_s']!r} s; host ms per tick "
            f"{hp['host_ms_per_tick']!r} / {hn['host_ms_per_tick']!r} over "
            f"{hp['ticks']} / {hn['ticks']} ticks")
    return dict(wall_s=wall, launches_r1=launches, same_general=same_general,
                host_native=host, host_python=py["host"],
                arms={a: {k: arms[a][k] for k in P13_REL} for a in ARMS})


def p13_guard_run(cli, device, arm, fault_at=None):
    """One per-tick run of ``arm`` on phase 3's trace, its kernel entry
    point raising on call ``fault_at`` (none when ``None``); returns
    ``(policy, log, entry calls, error)`` — the log holds each served
    tick's availability at entry and its placements, ``error`` what the
    run raised (``None`` when it ended)."""
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.sched import cuda as cuda_mod
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import build_cluster, make_policy

    policy = make_policy(p13_guard_config(arm), torch_device=str(device))
    calls = {"n": 0}

    def faulty(fn):
        def entry(*a, **k):
            n = calls["n"]
            calls["n"] += 1
            if n == fault_at:
                raise RuntimeError(f"injected kernel fault at call {n}")
            return fn(*a, **k)
        return entry

    ff = cuda_mod.first_fit_cuda  # the card's First-Fit entry point
    if arm == "cost-aware":
        policy._greedy = faulty(policy._greedy)
    else:
        cuda_mod.first_fit_cuda = faulty(ff)
    log_, place = [], policy.place

    def logged(ctx):
        avail = np.array(ctx.avail, copy=True)
        out = place(ctx)
        log_.append((avail, np.asarray(out).copy()))
        return out

    policy.place = logged
    reset_ids()
    err = None
    try:
        ExperimentRun(
            f"guard-{arm}", build_cluster(cli._cluster_config(
                cli.parse_args(["overall"]))), policy, TRACE,
            n_apps=P13_GUARD_APPS, seed=0, fuse_spans=False).run()
    except RuntimeError as exc:
        err = exc
    finally:
        cuda_mod.first_fit_cuda = ff
    return policy, log_, calls["n"], err


def p13_guard_config(arm):
    from pivot_tpu_torch.utils.config import PolicyConfig

    if arm == "cost-aware":
        return PolicyConfig(name="cost-aware", device="cuda", adaptive=False,
                            bin_pack="first-fit", sort_tasks=True,
                            sort_hosts=True)
    return PolicyConfig(name="first-fit", device="cuda", adaptive=False)


def p13_guard(device, chk) -> dict:
    """(b) The degrade guard on the card (module docstring): refused by
    every card policy, and a kernel failure with the guard off reaches
    the caller with no tick served by the numpy twin."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.sched import cuda as cuda_mod
    from pivot_tpu_torch.utils.config import make_policy

    out = {}
    refused = []
    for cls in (cuda_mod.CudaOpportunisticPolicy, cuda_mod.CudaFirstFitPolicy,
                cuda_mod.CudaBestFitPolicy, cuda_mod.CudaCostAwarePolicy):
        try:
            cls(adaptive=False, device=device,
                degrade_after=P13_DEGRADE_AFTER)
        except NotImplementedError:
            refused.append(cls.__name__)
        else:
            raise AssertionError(f"(b) {cls.__name__} on the card accepted "
                                 f"degrade_after={P13_DEGRADE_AFTER}")
    log(f"  (b) degrade_after={P13_DEGRADE_AFTER} refused on the card by "
        f"{', '.join(refused)}")
    for arm in ("cost-aware", "first-fit"):
        policy = make_policy(p13_guard_config(arm), torch_device=str(device))
        try:
            policy.degrade_after = P13_DEGRADE_AFTER
        except NotImplementedError:
            pass
        else:
            raise AssertionError(f"(b) {arm}: the setter accepted the guard")
        clean_tap = CloneTap()
        with clean_tap.attach():
            ck.reset_launches()
            _p, clean, _n, err = p13_guard_run(cli, device, arm)
            clean_launches = ck.LAUNCHES["greedy_place"]
        if err is not None:
            raise err
        clean_tap.hold(ck, chk, "(b) fault-free Cost-Aware")
        tap = CloneTap()
        with tap.attach():
            ck.reset_launches()
            policy, got, n_calls, err = p13_guard_run(cli, device, arm,
                                                      P13_FAULT_AT)
            launches = ck.LAUNCHES["greedy_place"]
        want = f"injected kernel fault at call {P13_FAULT_AT}"
        if err is None or want not in str(err):
            raise AssertionError(f"(b) {arm}: the injected fault did not "
                                 f"propagate (raised {err!r})")
        if (n_calls != P13_FAULT_AT + 1 or policy.twin_ticks
                or policy.kernel_failures or policy.degraded
                or len(got) >= len(clean)):
            raise AssertionError(
                f"(b) {arm}: {n_calls} entry calls, {len(got)} ticks served, "
                f"{policy.twin_ticks} by the twin, {policy.kernel_failures} "
                "kernel failures counted")
        for i, (x, y) in enumerate(zip(got, clean)):
            if not (np.array_equal(x[0], y[0]) and np.array_equal(x[1],
                                                                  y[1])):
                raise AssertionError(f"(b) {arm}: tick {i}'s availability "
                                     "or placements differ from the run "
                                     "with no faults")
        if arm == "cost-aware":
            if launches != len(tap.calls) or launches != P13_FAULT_AT:
                raise AssertionError(f"(b) {launches} launches, "
                                     f"{len(tap.calls)} recorded")
            tap.hold(ck, chk, "(b) Cost-Aware up to the fault")
        out[arm] = dict(ticks_clean=len(clean), ticks_served=len(got),
                        entry_calls=n_calls, launches=launches,
                        clean_launches=clean_launches)
        log(f"  (b) {arm}: the fault at kernel entry call {P13_FAULT_AT} "
            f"propagated; {len(got)} ticks served before it, each equal to "
            f"the run with no faults ({len(clean)} ticks), 0 by the numpy "
            f"twin; {launches} greedy_place launches up to the fault, "
            f"{clean_launches} in the run with no faults, each = plain")
    return out


def p13_profiler(device, chk) -> dict:
    """(c) Phase 10's README serve command with ``--profile-dispatch`` and
    without (module docstring)."""
    from pivot_tpu_torch import obs
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck

    base, made = obs.DispatchProfiler, []

    class RecordingProfiler(base):
        """Records the call numbers it samples, per family."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.hits = {}
            made.append(self)

        def _tick(self, family):
            st = self._stats.get(family)
            n = st.calls if st is not None else 0
            hit = super()._tick(family)
            if hit:
                self.hits.setdefault(family, []).append(n)
            return hit

    argv = SERVE_RUNS["a"] + ("--profile-dispatch", str(P13_PROFILE_EVERY))
    with tempfile.TemporaryDirectory() as out:
        obs.DispatchProfiler = RecordingProfiler
        try:
            on, rec_on, l_on = serve_run(cli, ck, "a", out, args=argv)
        finally:
            obs.DispatchProfiler = base
        off, rec_off, l_off = serve_run(cli, ck, "a", out)
    if len(made) != 1 or "profiler" not in on or "profiler" in off:
        raise AssertionError("(c) the profiled run built no profiler")
    prof = made[0]
    serve_consistent("c profiled", on, l_on, True)
    if on["slo"]["counters"] != off["slo"]["counters"]:
        raise AssertionError("(c) counters differ with the profiler on")
    s_on = sorted(rec_on.sessions, key=lambda s: s.slot)
    s_off = sorted(rec_off.sessions, key=lambda s: s.slot)
    decisions = 0
    for a, b in zip(s_on, s_off):
        if len(a.log) != len(b.log) or any(
                not np.array_equal(x, y) for x, y in zip(a.log, b.log)):
            raise AssertionError(f"(c) session {a.slot} decided otherwise "
                                 "with the profiler on")
        decisions += len(a.log)
    census = on["profiler"]["families"]
    if not census:
        raise AssertionError("(c) empty census")
    for fam, row in census.items():
        missing = {"calls", "sampled", "p50_us", "model_ratio_p50"} - set(row)
        if missing:
            raise AssertionError(f"(c) census row {fam} lacks {missing}")
        want = prof.sampled_indices(fam, row["calls"])
        if prof.hits.get(fam, []) != want or row["sampled"] != len(want):
            raise AssertionError(f"(c) {fam}: sampled calls "
                                 f"{prof.hits.get(fam)} are not "
                                 f"sampled_indices {want}")
    p12_hold(ck, rec_on, chk, "(c) profiled serve")
    p12_hold(ck, rec_off, chk, "(c) unprofiled serve")
    kernel = [_events_ms(bare_rows_launch(ck, a, k), 3)
              for a, k, _o in rec_on.rows]
    kernel += [_events_ms(bare_launch(ck, a, k)[0], 3)
               for a, k, _o in rec_on.r1]
    kms = statistics.median(kernel) if kernel else None
    log(f"  (c) serve {' '.join(argv)}: {decisions} decisions equal the "
        f"unprofiled run's, decision for decision; profiler on "
        f"{on['profiler']['backend']}, dispatch floor "
        f"{on['profiler']['dispatch_floor_us']!r} us")
    for fam, row in census.items():
        log(f"    {fam}: {row['calls']} calls, {row['sampled']} sampled at "
            f"{prof.hits.get(fam)} (= sampled_indices), median wall "
            f"{row['p50_us']!r} us, median measured/predicted "
            f"{row['model_ratio_p50']!r}; the phase's CUDA-event kernel_ms "
            f"of the same {len(kernel)} launches: median {kms!r} ms")
    log(f"    {len(rec_on.rows)} per-row and {len(rec_on.r1)} R=1 launches "
        f"each = plain; unprofiled run {l_off['total']} launches")
    return dict(decisions=decisions, census=census, launches=l_on,
                compare_launches=l_off["total"], kernel_ms_median=kms,
                floor_us=on["profiler"]["dispatch_floor_us"])


def p13_profile_dir(device, chk) -> dict:
    """(d) The README's ``--network native --profile-dir DIR overall``,
    three arms (three ``torch.profiler`` sessions one after another, late
    in this process: see ``obs.tracer.TRACE_WARMUP_KERNELS``), at
    ``P13_TRACE_APPS`` apps on phase 3's trace: every arm's trace holds
    a kernel record for each kernel launch (``trace_census``) and for
    its tail sentinel, with the margin the hold left (``trace_tail``),
    and the Cost-Aware (third) trace holds the ``greedy_place`` kernel by name,
    once for each of the run's launches, each held against the plain
    version."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.obs.tracer import (PROFILE_TRACE_FILE, TRACE_TAIL_S,
                                            trace_census, trace_tail)
    from pivot_tpu_torch.ops import cuda_kernels as ck

    tap = CloneTap()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        prof_dir = os.path.join(tmp, "prof")
        argv = overall_argv(os.path.join(tmp, "out"), _trace_job_dir(tmp),
                            "cuda")
        argv[-1] = str(P13_TRACE_APPS)
        argv = ["--network", "native", "--profile-dir", prof_dir, *argv]
        with tap.attach(), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ck.reset_launches()
            t0 = time.perf_counter()
            _exp, summaries, _objs = run_cli(cli, argv, device, True)
            wall = time.perf_counter() - t0
            launches = ck.LAUNCHES["greedy_place"]
        census, kern = {}, []
        for arm in ARMS:
            path = os.path.join(prof_dir, "0", arm, PROFILE_TRACE_FILE)
            census[arm] = trace_census(path)
            census[arm]["bytes"] = os.path.getsize(path)
            census[arm]["tail"] = trace_tail(path)
        with open(path) as f:  # the Cost-Aware trace, the third session
            kern = [e for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "kernel"
                    and "greedy_place" in e.get("name", "")]
    short = {a: c for a, c in census.items()
             if c["missing"] or c["launches"] != c["kernels"]
             or not c["tail"]["recorded"]}
    if short or any("no kernel record" in str(w.message) for w in caught):
        raise AssertionError(f"(d) traces missing kernel records: {short}")
    d = {s_["label"]: s_ for s_ in summaries}["Cost-Aware"]["dispatch"]
    if not (launches == len(kern) == len(tap.calls)
            == d["kernel_ticks"] + d["span_kernel_ticks"] and launches):
        raise AssertionError(f"(d) {len(kern)} greedy_place kernels in the "
                             f"Cost-Aware trace, {launches} launches, {d}")
    tap.hold(ck, chk, "(d) profiled Cost-Aware")
    log(f"  (d) --network native --profile-dir overall, 3 arms x "
        f"{P13_TRACE_APPS} apps: {wall!r} s; kernel launches / kernel "
        "records / missing per trace: " + ", ".join(
            f"{a} {c['launches']} / {c['kernels']} / {c['missing']} "
            f"({c['bytes']} bytes, least launch-to-kernel "
            f"{c['min_launch_to_kernel_us']!r} us; tail sentinel recorded, "
            f"its launch-to-kernel {c['tail']['skew_us']!r} us, margin to "
            f"the window's end {c['tail']['margin_us']!r} us of the "
            f"{TRACE_TAIL_S * 1e6!r} us hold)"
            for a, c in census.items())
        + f"; the Cost-Aware trace holds {len(kern)} greedy_place kernels "
        f"by name (e.g. {kern[0]['name']!r}) = the run's {launches} "
        "launches, each = plain")
    return dict(wall_s=wall, launches_r1=launches, trace_kernels=len(kern),
                census=census)


def phase_native_guard_profiler(device, e2e) -> dict:
    """Phase 13 (module docstring).  Returns its record."""
    card = card_line()
    log(f"  [{card}]")
    chk = Check()
    rec = {}
    for key, fn, args in (("native", p13_native, (device, e2e, chk)),
                          ("guard", p13_guard, (device, chk)),
                          ("profiler", p13_profiler, (device, chk)),
                          ("profile_dir", p13_profile_dir, (device, chk))):
        t0 = time.perf_counter()
        rec[key] = fn(*args)
        rec[key]["wall_s_part"] = time.perf_counter() - t0
        log(f"  ({'abcd'[len(rec) - 1]}): {rec[key]['wall_s_part']!r} s")
    prof = rec["profiler"]["launches"]
    rec["launches_r1"] = (rec["native"]["launches_r1"]
                          + rec["guard"]["cost-aware"]["launches"]
                          + prof["by_replicas"].get(1, 0)
                          + rec["profile_dir"]["launches_r1"])
    rec["launches_rows_by_g"] = dict(prof["rows"])
    rec["launches_rows"] = sum(prof["rows"].values())
    rec["compare_launches"] = (rec["profiler"]["compare_launches"]
                               + rec["guard"]["cost-aware"]["clean_launches"])
    rec["held"] = chk.cases
    rec["max_abs_err"] = chk.max_abs_err
    log(f"  {chk.cases} greedy_place launches held against their plain "
        f"version, {chk.placed} placements, max |avail diff| "
        f"{chk.max_abs_err!r}; path launches R=1 {rec['launches_r1']}, "
        f"per-row {rec['launches_rows_by_g']}; comparison sides (the "
        f"unprofiled serve run, the guard's fault-free run) "
        f"{rec['compare_launches']}")
    return rec


#: Phase 14 (e): the README's three-arm ``overall`` at this many apps,
#: served twice by the resident worker.
P14_WORKER_APPS = 8
#: Phase 14 (d): the falsifier's new norm-snapshot layout ``[R, H, 4]``
#: (the compile check warms ``[4, 64, 4]``).
P14_NEW_SNAPSHOT = (8, 64)


class LaunchConfigs:
    """Every launch shape of ``greedy_place`` the script computes,
    ``(config, Z)``, read by phase 14 (b).  Each launch takes its shape
    from ``cuda_kernels._launch_config``, a ``functools.lru_cache``; this
    puts a fresh cache of the same size in its place whose function
    records the shape and computes it.  Only a miss records, so a launch
    whose shape is cached (every timed one) runs the same cache lookup as
    without it, and the launch site itself is untouched."""

    def __init__(self):
        self.seen = set()

    def install(self) -> "LaunchConfigs":
        from pivot_tpu_torch.ops import cuda_kernels as ck

        self._ck, self._config = ck, ck._launch_config
        compute, seen = ck._launch_config.__wrapped__, self.seen

        @functools.lru_cache(
            maxsize=ck._launch_config.cache_parameters()["maxsize"])
        def launch_config(R, H, Z, warps=None):
            cfg = compute(R, H, Z, warps)
            seen.add((cfg, Z))
            return cfg

        ck._launch_config = launch_config
        return self

    def uninstall(self) -> None:
        self._ck._launch_config = self._config


def p14_analysis() -> dict:
    """(a) ``python -m pivot_tpu_torch.analysis --json`` over the
    checkout: clean, every rule listed."""
    from pivot_tpu_torch.analysis import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--json"])
    rep = json.loads(out.getvalue())
    if rc != 0 or not rep["clean"]:
        raise AssertionError(f"(a) graftcheck findings: {rep['findings']}")
    log(f"  (a) python -m pivot_tpu_torch.analysis --json: clean, "
        f"{len(rep['rules'])} rules: {', '.join(rep['rules'])}")
    return dict(rules=rep["rules"], clean=True)


def p14_budget(configs, ptxas_rows) -> dict:
    """(b) The ``kernel-budget`` pass against the card: the static
    shared-memory bytes of every launch shape the script made equal
    ``_launch_config``'s and fit the card's opt-in shared memory per
    block; ``ptxas``'s registers x each instantiation's thread limit fit
    the register file (spills printed, not failed)."""
    from pivot_tpu_torch.analysis import kernel_budget as kb
    from pivot_tpu_torch.infra.roofline import H100_REGS_PER_BLOCK
    from pivot_tpu_torch.ops import cuda_kernels as ck

    model = kb.cuda_model()
    if model is None:
        raise AssertionError("(b) greedy_place.cu unreadable by the pass")
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    shapes = set(configs) | {(ck._launch_config(1, 600, Z), Z),
                             (ck._launch_config(SENS_REPLICAS, 600, Z), Z)}
    rows = []
    for cfg, z in sorted(shapes, key=lambda c: (c[1], tuple(c[0]))):
        static = (model.global_bytes(z) if cfg.state == "global" else
                  model.smem_bytes(z, cfg.warps, cfg.groups,
                                   cfg.hosts_per_thread, cfg.smem_state,
                                   cfg.cluster))
        if static != cfg.smem_bytes or static > optin:
            raise AssertionError(
                f"(b) {cfg} at Z={z}: the pass counts {static} B of shared "
                f"memory, _launch_config {cfg.smem_bytes} B, the card's "
                f"opt-in {optin} B")
        rows.append(dict(W=cfg.warps, K=cfg.hosts_per_thread,
                         state=cfg.state, G=cfg.groups, C=cfg.cluster, Z=z,
                         smem_bytes=static))
    bad = kb.register_findings(ptxas_rows, H100_REGS_PER_BLOCK)
    if bad or not ptxas_rows:
        raise AssertionError(f"(b) registers: {[str(f) for f in bad]} "
                             f"({len(ptxas_rows)} ptxas rows)")
    regs = [dict(K=r["K"], state=r["state"], registers=r["registers"],
                 threads=model.max_threads(r["K"],
                                           r["state"] != "registers"),
                 spill_stores=r.get("spill_stores"),
                 spill_loads=r.get("spill_loads")) for r in ptxas_rows]
    log(f"  (b) kernel-budget on the card: {len(rows)} launch shapes, "
        f"static shared memory = _launch_config's, at most "
        f"{max(r['smem_bytes'] for r in rows)} B against the card's opt-in "
        f"{optin} B (roofline H100_SMEM_OPTIN_BYTES "
        f"{ck._SMEM_LIMIT}); registers x threads <= {H100_REGS_PER_BLOCK}: "
        + ", ".join(f"K={r['K']}{GREEDY_TAGS[r['state']]} "
                    f"{r['registers']}x{r['threads']}"
                    f"={r['registers'] * r['threads']}" for r in regs))
    spills = [r for r in regs if r["spill_stores"] or r["spill_loads"]]
    log("  (b) spills (printed, not failed): " + (", ".join(
        f"K={r['K']}{GREEDY_TAGS[r['state']]} {r['spill_stores']} B stored "
        f"/ {r['spill_loads']} B loaded" for r in spills) or "none"))
    from pivot_tpu_torch.infra.roofline import H100_MAX_THREADS_PER_BLOCK

    cf_model = kb.cf_model()
    max_threads = getattr(torch.cuda.get_device_properties(0),
                          "max_threads_per_block", H100_MAX_THREADS_PER_BLOCK)
    cf_rows = []
    for H, arm in ((P19_H, "first-fit"), (P19_H, "best-fit"),
                   (4096, "best-fit"), (4097, "opportunistic"),
                   (P19_POD[0], "best-fit"),
                   (ck._CF_CLUSTER_MAX_HOSTS, "first-fit"),
                   (ck._CF_CLUSTER_MAX_HOSTS + 1, "best-fit")):
        cfg = ck._cf_config(H, arm)
        static = cf_model.smem_bytes(H, cfg.form, cfg.warps, cfg.groups,
                                     cfg.cluster)
        if (static != cfg.smem_bytes or static > optin
                or cfg.threads > min(max_threads,
                                     cf_model.form_threads(cfg.form))):
            raise AssertionError(
                f"(b) carry_free_place at H={H}: {cfg}, the pass counts "
                f"{static} B, the card's opt-in {optin} B, "
                f"{max_threads} threads a block")
        cf_rows.append(dict(H=H, arm=arm, threads=cfg.threads,
                            cluster=cfg.cluster, state=cfg.state,
                            smem_bytes=static))
    log("  (b) carry_free_place shapes: " + ", ".join(
        f"{r['arm']} H={r['H']} {r['threads']} threads x {r['cluster']} "
        f"CTAs, {r['smem_bytes']} B ({r['state']} state)"
        for r in cf_rows) + f" <= the card's {optin} B opt-in and "
        f"{max_threads} threads a block")
    return dict(shapes=rows, optin=optin, registers=regs,
                cf_shapes=cf_rows)


def p14_costattr(device) -> dict:
    """(c) ``cost_attribution(device="cuda")``: complete, each torch
    row's ops, bytes, CUDA-event ``device_ms`` and model ratios, and the
    hand kernel's rows (R = 1, R = 4, per-row G = 2), each launch held
    against its plain version inside the call."""
    from pivot_tpu_torch.obs.costattr import cost_attribution
    from pivot_tpu_torch.ops import cuda_kernels as ck

    n0 = dict(ck.LAUNCHES_BY_REPLICAS), dict(ck.LAUNCHES_ROWS)
    rep = cost_attribution(device=str(device))
    if not rep["complete"]:
        raise AssertionError(f"(c) cost attribution incomplete: "
                             f"{rep['coverage_problems']}")
    from pivot_tpu_torch.obs.costattr import _CF_FORMS

    kern = {n: r for n, r in rep["rows"].items() if "kernel" in r}
    if sorted(r["form"] for r in kern.values()) != sorted(
            ["r1", "r4", "rows", *_CF_FORMS]):
        raise AssertionError(f"(c) hand-kernel rows: {sorted(kern)}")
    for name, r in kern.items():
        if r["compared"] != r["launches"]:
            raise AssertionError(f"(c) {name}: {r['launches']} launches, "
                                 f"{r['compared']} held against plain")
    log(f"  (c) cost_attribution(device='cuda') at T={rep['t']}, "
        f"H={rep['h']}: complete, {rep['measured']} measured, "
        f"{rep['flagged']} flagged, {len(rep['reference'])} reference "
        f"entries covered ({rep['device']})")
    for name, r in sorted(rep["rows"].items()):
        if "flagged" in r:
            continue
        log(f"    {name}: " + (
            f"{r['kernel']} {r['form']}: {r['launches']} launch(es), each "
            f"held against plain, device_ms {r['device_ms']!r}, bytes {r['bytes']!r}, "
            f"max |avail diff| vs plain {r['max_abs_err']!r}, "
            f"bytes_vs_model {r.get('bytes_vs_model')!r}"
            if "kernel" in r else
            f"ops {r['ops']}, bytes {r['bytes']!r}, flops {r['flops']!r}, "
            f"device_ms {r['device_ms']!r}, flops_vs_model "
            f"{r.get('flops_vs_model')!r}, bytes_vs_model "
            f"{r.get('bytes_vs_model')!r}"))
    r1 = ck.LAUNCHES_BY_REPLICAS.get(1, 0) - n0[0].get(1, 0)
    r4 = ck.LAUNCHES_BY_REPLICAS.get(4, 0) - n0[0].get(4, 0)
    g2 = ck.LAUNCHES_ROWS.get(2, 0) - n0[1].get(2, 0)
    return dict(rows=rep["rows"], launches_r1=r1, launches_r4=r4,
                launches_rows_g2=g2,
                max_abs_err=max(r["max_abs_err"] for r in kern.values()
                                if r["kernel"] == "greedy_place"),
                cf_max_abs_err=max(r["max_abs_err"] for r in kern.values()
                                   if r["kernel"] == "carry_free_place"))


def p14_compile(device, chk) -> dict:
    """(d) ``--compile-check full`` on the card (the fused span driver,
    the serve dispatch path and one ensemble snapshot shape warmed, then
    a steady window: 0 kernel builds, 0 graph captures), every
    ``greedy_place`` launch of its serve runs held against the plain
    version; then the falsifier: a new snapshot shape counts exactly one
    ``graph_capture``, and its second use none."""
    from pivot_tpu_torch import analysis
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.utils.compile_counter import count_compiles

    rec = ServeRecorder()
    n0 = ck.LAUNCHES["greedy_place"]
    out = io.StringIO()
    with rec.attach(), contextlib.redirect_stdout(out):
        rc = analysis.main(["--compile-check", "full", "--device",
                            str(device)])
    launches = ck.LAUNCHES["greedy_place"] - n0
    if rc != 0:
        raise AssertionError(f"(d) --compile-check full failed: "
                             f"{out.getvalue()}")
    if launches != len(rec.r1) + len(rec.rows) or not launches:
        raise AssertionError(f"(d) {launches} launches, {len(rec.r1)} R=1 "
                             f"and {len(rec.rows)} per-row recorded")
    p12_hold(ck, rec, chk, "(d) compile-check serve")
    R, H = P14_NEW_SNAPSHOT
    with count_compiles() as new:
        analysis._snapshot_once(device, R, H)
    with count_compiles() as again:
        analysis._snapshot_once(device, R, H)
    if (new.graph_captures, new.kernel_builds) != (1, 0) or \
            (again.graph_captures, again.kernel_builds) != (0, 0):
        raise AssertionError(
            f"(d) falsifier: a new snapshot shape counted "
            f"{new.graph_captures} capture(s) / {new.kernel_builds} "
            f"build(s), its second use {again.graph_captures} / "
            f"{again.kernel_builds}")
    log(f"  (d) {out.getvalue().strip()}; {launches} greedy_place "
        f"launches in its serve runs (R=1 {len(rec.r1)}, per-row "
        f"{len(rec.rows)}), each = plain; a new snapshot shape "
        f"[{R}, {H}, 4]: 1 graph capture, its second use 0")
    return dict(launches_r1=len(rec.r1), launches_rows=len(rec.rows),
                launches_rows_by_g=dict(collections.Counter(
                    int(a[0].shape[0]) for a, _k, _o in rec.rows)))


class _Requests:
    """The worker's stdin: the request lines in turn.  Before a request
    that repeats the one before it, wait for the clock's next whole
    second, so that the repeat stamps its own experiment directory
    (``<output-dir>/overall/<int(time.time())>``) and runs anew."""

    def __init__(self, lines):
        self.lines = lines

    def __iter__(self):
        prev = None
        for line in self.lines:
            if line == prev:
                time.sleep(1.0 - (time.time() % 1.0) + 0.01)
            prev = line
            yield line + "\n"


class P14OneShot:
    """(e)'s one-shot run: the README's three-arm ``overall`` at
    ``P14_WORKER_APPS`` apps through the CLI in a fresh process.  It
    needs phase 1's build, and ``main`` ends it before the first phase
    that times the card: it runs beside phase 2, which only compares
    the kernel with its plain version, so no time the script reports is
    taken beside a second process on the card."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory(dir=os.getcwd())
        self.job_dir = _trace_job_dir(self._tmp.name)
        self.out = os.path.join(self._tmp.name, "oneshot")
        self.worker_out = os.path.join(self._tmp.name, "worker")
        self.ref_dir = self.wall_s = None
        argv = overall_argv(self.out, self.job_dir, "cuda")
        argv[-1] = str(P14_WORKER_APPS)
        os.makedirs(self.out)
        self._log = os.path.join(self.out, "oneshot.log")
        self._t0 = time.perf_counter()
        with open(self._log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "pivot_tpu_torch.experiments.cli",
                 *argv], stdout=f, stderr=subprocess.STDOUT)

    def wait(self) -> None:
        """Wait for the run (killed after 600 s); raises if it failed.
        Sets ``ref_dir``, its experiment directory."""
        if self.ref_dir is not None:
            return
        try:
            rc = self.proc.wait(timeout=600)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        self.wall_s = time.perf_counter() - self._t0
        if rc != 0:
            with open(self._log) as f:
                raise AssertionError(f"(e) one-shot run failed:\n"
                                     f"{f.read()[-2000:]}")
        (self.ref_dir,) = [
            os.path.join(self.out, "overall", d)
            for d in os.listdir(os.path.join(self.out, "overall"))]

    def cleanup(self) -> None:
        self._tmp.cleanup()


def p14_worker(chk, oneshot) -> dict:
    """(e) ``worker`` in this process, stdin swapped: the README's
    three-arm ``overall`` at ``P14_WORKER_APPS`` apps, the same request
    again, a malformed line, ``quit``.  Both requests' ``general.json``
    files are byte-equal to the one-shot run's (``P14OneShot``), the
    malformed line answers ``ok: false``, every launch is held against
    the plain version; without matplotlib the figures are named on
    stderr."""
    import importlib.util

    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.ops import cuda_kernels as ck

    oneshot.wait()
    out_dir, ref_dir = oneshot.worker_out, oneshot.ref_dir
    argv = overall_argv(out_dir, oneshot.job_dir, "cuda")
    argv[-1] = str(P14_WORKER_APPS)
    req = json.dumps(argv)
    tap = CloneTap()
    out, err = io.StringIO(), io.StringIO()
    stdin = sys.stdin
    n0 = ck.LAUNCHES["greedy_place"]
    try:
        sys.stdin = _Requests([req, req, '{"not": "argv"}', "quit"])
        with tap.attach(), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            cli.run_worker()
    finally:
        sys.stdin = stdin
    launches = ck.LAUNCHES["greedy_place"] - n0
    lines = out.getvalue().splitlines()
    sent = [json.loads(ln) for ln in lines if ln.startswith('{"served"')]
    dirs = [ln for ln in lines if ln.startswith(out_dir)
            and ln.rstrip("/").split("/")[-2] == "overall"]
    if [s["ok"] for s in sent] != [True, True, False] or len(dirs) != 2 \
            or dirs[0] == dirs[1]:
        raise AssertionError(f"(e) worker answers {sent}, experiment dirs "
                             f"{dirs}:\n{out.getvalue()[-2000:]}")
    for arm in ARMS:
        rel = os.path.join("data", "0", arm, "general.json")
        with open(os.path.join(ref_dir, rel), "rb") as f:
            want = f.read()
        for d in dirs:
            with open(os.path.join(d, rel), "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"(e) {arm}: {d}'s general.json "
                                         "differs from the one-shot run's")
    if len(tap.calls) != launches or not launches:
        raise AssertionError(f"(e) {launches} launches, {len(tap.calls)} "
                             "recorded")
    tap.hold(ck, chk, "(e) worker Cost-Aware")
    skipped = [ln for ln in err.getvalue().splitlines()
               if ln.startswith("figures not drawn")]
    if importlib.util.find_spec("matplotlib") is None and len(skipped) != 2:
        raise AssertionError(f"(e) without matplotlib each request must "
                             f"name its skipped figures: {skipped}")
    log(f"  (e) worker, 4 lines: request 1 wall_s {sent[0]['wall_s']!r}, "
        f"request 2 (the same) {sent[1]['wall_s']!r}, the malformed line "
        f"ok={sent[2]['ok']}; both requests' general.json = the one-shot "
        f"run's (3 arms); {launches} greedy_place launches, each = plain; "
        f"figures: " + (skipped[0] if skipped else "drawn (matplotlib)"))
    return dict(wall_s=[s["wall_s"] for s in sent[:2]],
                launches_r1=launches, figures_skipped=skipped)


def phase_tooling(device, configs, ptxas_rows, oneshot) -> dict:
    """Phase 14 (module docstring); ``oneshot``: the ended
    :class:`P14OneShot`.  Returns its record."""
    card = card_line()
    log(f"  [{card}]")
    chk = Check()
    rec = {}
    for key, fn, args in (("analysis", p14_analysis, ()),
                          ("budget", p14_budget, (configs, ptxas_rows)),
                          ("costattr", p14_costattr, (device,)),
                          ("compile", p14_compile, (device, chk)),
                          ("worker", p14_worker, (chk, oneshot))):
        t0 = time.perf_counter()
        rec[key] = fn(*args)
        rec[key]["wall_s_part"] = time.perf_counter() - t0
        log(f"  ({'abcde'[len(rec) - 1]}): {rec[key]['wall_s_part']!r} s")
    ca, cc, wk = rec["costattr"], rec["compile"], rec["worker"]
    rec["launches_r1"] = (ca["launches_r1"] + cc["launches_r1"]
                          + wk["launches_r1"])
    rec["launches_r4"] = ca["launches_r4"]
    rec["launches_rows_by_g"] = dict(collections.Counter(
        {2: ca["launches_rows_g2"]}) + collections.Counter(
        cc["launches_rows_by_g"]))
    rec["launches_rows"] = sum(rec["launches_rows_by_g"].values())
    rec["held"] = chk.cases
    rec["max_abs_err"] = max(chk.max_abs_err, ca["max_abs_err"])
    log(f"  {chk.cases} greedy_place launches of (d) and (e) held against "
        f"their plain version ({chk.placed} placements), (c)'s "
        f"{ca['launches_r1'] + ca['launches_r4'] + ca['launches_rows_g2']} "
        f"inside cost_attribution; max |avail diff| "
        f"{rec['max_abs_err']!r}; path launches R=1 {rec['launches_r1']}, "
        f"R=4 {rec['launches_r4']}, per-row {rec['launches_rows_by_g']}")
    return rec

#: Phase 15 (a): the reference's pod scale (``bench.py:3018-3019``,
#: ``_SHARD_T``, ``_SHARD_H0``), the shard counts, the chunk size.
P15_T, P15_H = 256, 98_304
P15_SHARDS = (1, 4)
P15_CHUNK = 8
#: Calls each torch-pass time averages: cut from 3 when (c) came, for the
#: script's 1,200 s (PERF.md, section 4).
P15_REPS = 2
P15_ARMS = ("opportunistic", "first-fit", "best-fit", "cost-aware")
#: The ``overall`` Cost-Aware arm's pass (``reference_policy_set``).
P15_CA = dict(bin_pack="first-fit", sort_hosts=True, host_decay=False)
#: ``greedy_place`` at the pod tick (a cluster of 16 CTAs): its R = 4
#: replicas, its G = 2 rows (row 1 bounded 37 steps short), the calls
#: each CUDA-event time averages.
P15_GREEDY_R = 4
P15_GREEDY_G = 2
P15_ROW_SHORT = 37
P15_KERNEL_REPS = 5
#: Phase 15 (b): logical shards of the mesh and the apps of each run.
P15_E2E_SHARDS = 4
P15_APPS = 30
#: Phase 15 (c): ``overall``'s Cost-Aware arm past one CTA (a cluster of
#: 2 CTAs of 10,240 hosts at the CLI's 31 zones), and its apps.
P15_WIDE_HOSTS = 20480
P15_WIDE_APPS = 10


def p15_inputs(seed, T, H, device) -> dict:
    """A dense seeded f32 tick (:func:`make_inputs`) with the low-index
    hosts fuller (availability scaled from 0.05x to 1x along the host
    axis), so first fits land past shard 0, and the opportunistic
    uniforms."""
    keys = ("avail", "dem", "valid", "ng", "az", "cost", "bw", "hz",
            "counts")
    x = dict(zip(keys, make_inputs(seed, T, H, device, dense=True)))
    scale = torch.linspace(0.05, 1.0, H, device=device)[:, None]
    x["avail"] = (x["avail"] * scale).contiguous()
    x["u"] = torch.from_numpy(
        np.random.default_rng(seed).random(T).astype(np.float32)).to(device)
    return x


def p15_call(arm, x, mesh=None, phase2="auto"):
    """One placement call of ``arm`` on the tick ``x``: the port's
    unsharded torch form, or with ``mesh`` its host-sharded twin."""
    from pivot_tpu_torch.ops import kernels as tk
    from pivot_tpu_torch.ops import shard as sh

    forms = {"opportunistic": (tk.opportunistic_impl,
                               sh.opportunistic_kernel_sharded),
             "first-fit": (tk.first_fit_impl, sh.first_fit_kernel_sharded),
             "best-fit": (tk.best_fit_impl, sh.best_fit_kernel_sharded),
             "cost-aware": (tk.cost_aware_impl,
                            sh.cost_aware_kernel_sharded)}[arm]
    fn = forms[0] if mesh is None else functools.partial(forms[1], mesh)
    args = (x["avail"], x["dem"], x["valid"])
    if arm == "opportunistic":
        return fn(*args, x["u"], phase2=phase2)
    if arm == "cost-aware":
        return fn(*args, x["ng"], x["az"], x["cost"], x["bw"], x["hz"],
                  x["counts"], **P15_CA, phase2=phase2)
    return fn(*args, phase2=phase2)


def p15_exact(got, want, what) -> None:
    """Placements and availability bit for bit."""
    (p, a), (pp, pa) = got, want
    if not torch.equal(p, pp):
        bad = (p != pp).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: placements differ at {bad}")
    if not torch.equal(a.view(torch.int32), pa.view(torch.int32)):
        raise AssertionError(f"{what}: availability differs")


def p15_pod(device, ck, chk) -> dict:
    """Phase 15 (a): the four arms at pod scale through the sharded
    passes at S in P15_SHARDS, per-step and chunk, each exactly the
    unsharded form's result and timed beside it; then ``greedy_place``
    at the same tick in its three launches (:func:`p15_greedy`)."""
    from pivot_tpu_torch.parallel.mesh import host_sharded_mesh

    x = p15_inputs(15, P15_T, P15_H, device)
    meshes = {S: host_sharded_mesh(devices=[device] * S)
              for S in P15_SHARDS}
    modes = {"step": "auto", "chunk": P15_CHUNK}
    rec = {}
    for arm in P15_ARMS:
        want = p15_call(arm, x)
        row = {"placed": int((want[0] >= 0).sum())}
        if row["placed"] < int(x["valid"].sum()) // 4:
            raise AssertionError(f"{arm}: {row['placed']} placements")
        for mname, mode in modes.items():
            p15_exact(p15_call(arm, x, phase2=mode), want,
                      f"{arm} unsharded {mname}")
            row[f"unsharded_{mname}_ms"] = _events_ms(
                lambda: p15_call(arm, x, phase2=mode), P15_REPS)
            for S, mesh in meshes.items():
                p15_exact(p15_call(arm, x, mesh, mode), want,
                          f"{arm} S={S} {mname}")
                row[f"S{S}_{mname}_ms"] = _events_ms(
                    lambda: p15_call(arm, x, mesh, mode), P15_REPS)
        rec[arm] = row
        log(f"  (a) {arm}, H={P15_H}, T={P15_T}: {row['placed']} "
            "placements, every sharded form = the unsharded form bit for "
            "bit; ms per call (CUDA events, mean of "
            f"{P15_REPS}): " + ", ".join(
                f"{k[:-3]} {v!r}" for k, v in row.items() if k != "placed"))
    compare0 = ck.LAUNCHES["greedy_place"]
    greedy = p15_greedy(device, ck, chk, x, rec["cost-aware"], meshes)
    return dict(arms=rec, greedy=greedy,
                compare_launches=ck.LAUNCHES["greedy_place"] - compare0)


def p15_torch_ca(x, meshes, chk, kernel, what) -> None:
    """The Cost-Aware torch pass on the tick ``x``, unsharded and on each
    mesh (bit for bit the unsharded), each held against ``kernel``, the
    ``greedy_place`` result (placements equal, availability within the
    tolerance)."""
    want = p15_call("cost-aware", x)
    chk.same(kernel, want, f"{what}: unsharded torch pass vs greedy_place",
             min_placed=int(x["valid"].sum()) // 4)
    for S, mesh in meshes.items():
        got = p15_call("cost-aware", x, mesh)
        p15_exact(got, want, f"{what}: cost-aware S={S}")
        chk.same(kernel, got, f"{what}: S={S} torch pass vs greedy_place")


def p15_greedy(device, ck, chk, x, ca, meshes) -> dict:
    """Phase 15 (a)'s hand kernel at the pod tick, in its three launches:
    R = 1 (``cost_aware_cuda``), ``P15_GREEDY_R`` replicas
    (``cost_aware_cuda_batched``, the availability scaled per replica)
    and ``P15_GREEDY_G`` rows (``cost_aware_cuda_rows``, row 1 its own
    tick with its step bound ``P15_ROW_SHORT`` short): each held against
    the Cost-Aware torch pass (unsharded and every mesh, replica by
    replica, row by row) and its plain form, then timed — the wrapper
    and the bare launch by CUDA events, the plain form by host clock —
    beside the bound and the torch pass's times of the arms loop
    (``ca``)."""
    keys = ("avail", "dem", "valid", "ng", "az", "cost", "bw", "hz",
            "counts")
    T, H = P15_T, P15_H
    kw = dict(P15_CA, n_eff=T)
    a = [x[k] for k in keys]
    out = {}

    def timed(key, R, fn, go, plain, b):
        ms = _events_ms(fn, P15_KERNEL_REPS)
        kernel_ms = _events_ms(go, P15_KERNEL_REPS)
        out[key] = dict(
            R=R, ms=ms, kernel_ms=kernel_ms,
            ns_per_step=kernel_ms * 1e6 / T,
            plain_ms=_host_ms(plain, 1), bound_ms=b[0], bound_by=b[1],
            torch_step_ms=ca["unsharded_step_ms"],
            torch_chunk_ms=ca["unsharded_chunk_ms"],
            **{f"S{S}_step_ms": ca[f"S{S}_step_ms"] for S in meshes})
        log(f"  (a) greedy_place {key} (H={H}, T={T}, "
            f"{ck._launch_config(1, H, Z).cluster} CTAs a replica): wrapper "
            f"{ms!r} ms, kernel_ms {kernel_ms!r} "
            f"({out[key]['ns_per_step']!r} ns a step), plain "
            f"{out[key]['plain_ms']!r} ms, bound {b[0]!r} ms ({b[1]}); the "
            f"torch pass unsharded per-step {ca['unsharded_step_ms']!r} ms "
            f"a tick")

    # R = 1.
    kernel = ck.cost_aware_cuda(*a, **kw)
    p15_torch_ca(x, meshes, chk, kernel, "R=1")
    chk.same(kernel, ck.cost_aware_plain(*a, **kw), "R=1 plain")
    timed("R=1", 1, lambda: ck.cost_aware_cuda(*a, **kw),
          bare_launch(ck, a, kw)[0], lambda: ck.cost_aware_plain(*a, **kw),
          bound(a, kw, 1, T))
    # R replicas sharing the stream.
    R = P15_GREEDY_R
    noise = torch.from_numpy(np.random.default_rng(9).uniform(
        0.5, 1.5, (R, H, 1)).astype(np.float32)).to(device)
    ar = [(x["avail"][None] * noise).contiguous(), *a[1:]]
    kernel = ck.cost_aware_cuda_batched(*ar, **kw)
    for r in range(R):
        p15_torch_ca(dict(x, avail=ar[0][r]), meshes, chk,
                     (kernel[0][r], kernel[1][r]), f"R={R} replica {r}")
    chk.same(kernel, ck.cost_aware_plain_batched(*ar, **kw), f"R={R} plain")
    timed(f"R={R}", R, lambda: ck.cost_aware_cuda_batched(*ar, **kw),
          bare_launch(ck, ar, kw)[0],
          lambda: ck.cost_aware_plain_batched(*ar, **kw),
          bound(ar, kw, R, T))
    # G rows, each its own tick.
    G = P15_GREEDY_G
    rows = [x] + [p15_inputs(15 + g, T, H, device) for g in range(1, G)]
    bounds = [T] + [T - P15_ROW_SHORT] * (G - 1)
    for row, n in zip(rows[1:], bounds[1:]):
        row["valid"][n:] = False  # the bound is one past the last valid
    ag = [torch.stack([row[k] for row in rows]).contiguous() for k in keys]
    rkw = dict(P15_CA, n_eff_g=torch.tensor(bounds, dtype=torch.int32,
                                            device=device))
    kernel = ck.cost_aware_cuda_rows(*ag, **rkw)
    for g, row in enumerate(rows):
        p15_torch_ca(row, meshes, chk, (kernel[0][g], kernel[1][g]),
                     f"G={G} row {g}")
    chk.same(kernel, ck.cost_aware_plain_rows(*ag, **rkw), f"G={G} plain")
    timed(f"G={G}", G, lambda: ck.cost_aware_cuda_rows(*ag, **rkw),
          bare_rows_launch(ck, ag, rkw),
          lambda: ck.cost_aware_plain_rows(*ag, **rkw), rows_bound(ag, rkw))
    log(f"  (a) cost-aware at the pod tick: the torch pass (unsharded, S="
        f"{'/'.join(map(str, P15_SHARDS))}) = greedy_place at R=1, R={R} "
        f"and G={G} (placements equal), max |avail diff| "
        f"{chk.max_abs_err!r}")
    return out


def p15_wide(device, ck, chk) -> dict:
    """Phase 15 (c): ``overall``'s Cost-Aware arm on cuda at
    ``P15_WIDE_HOSTS`` hosts x ``P15_WIDE_APPS`` apps through
    ``ExperimentRun``, unsharded: every tick and span tick one
    ``greedy_place`` launch (launches = kernel ticks + span kernel
    ticks, every device tick a kernel tick: none on the torch pass), in
    the cluster form, each launch recorded (``R1Tap``) and held against
    the plain form after the run; ``general.json`` byte-equal to the
    same run with ``use_kernel=False`` (the torch pass, no launch).
    Counts are zeroed just before each run and read just after."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import (
        build_cluster,
        make_policy,
        reference_policy_set,
    )

    cluster_cfg = cli._cluster_config(cli.parse_args(
        ["--num-hosts", str(P15_WIDE_HOSTS), "overall"]))
    pc = next(p for p in reference_policy_set("cuda")
              if p.name == "cost-aware")
    runs = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        for name, use_kernel in (("kernel", None), ("torch", False)):
            policy = make_policy(pc, torch_device=str(device))
            policy.use_kernel = use_kernel
            reset_ids()
            tap = R1Tap()
            with tap:
                ck.reset_launches()  # the path's count starts here
                t0 = time.perf_counter()
                summary = ExperimentRun(
                    pc.label, build_cluster(cluster_cfg), policy, TRACE,
                    n_apps=P15_WIDE_APPS, seed=0,
                    data_dir=os.path.join(tmp, name)).run()
                wall = time.perf_counter() - t0
                launches = ck.LAUNCHES["greedy_place"]
                by_r = dict(ck.LAUNCHES_BY_REPLICAS)
            with open(os.path.join(tmp, name, pc.label, "general.json"),
                      "rb") as f:
                general = f.read()
            runs[name] = dict(wall_s=wall, launches=launches, by_r=by_r,
                              general=general, tap=tap,
                              spans=summary["spans"],
                              dispatch=summary["dispatch"])
    k, t = runs["kernel"], runs["torch"]
    d = k["dispatch"]
    H = int(k["tap"].calls[0][0][0].shape[1]) if k["tap"].calls else None
    cfg = ck._launch_config(1, P15_WIDE_HOSTS, Z)
    if not (k["launches"] > 0 and d["device_ticks"] > 0
            and d["kernel_ticks"] == d["device_ticks"]
            and k["launches"] == d["kernel_ticks"] + d["span_kernel_ticks"]
            and set(k["by_r"]) == {1} and H == P15_WIDE_HOSTS
            and cfg.cluster > 1):
        raise AssertionError(
            f"(c) Cost-Aware at {P15_WIDE_HOSTS} hosts: {k['launches']} "
            f"greedy_place launches {k['by_r']} at H={H} for {d}; shape "
            f"{cfg}")
    if t["launches"] or t["tap"].calls:
        raise AssertionError("(c) the use_kernel=False run launched "
                             "greedy_place")
    k["tap"].hold(chk, k["by_r"], "15 (c)")
    if k["general"] != t["general"]:
        raise AssertionError(f"(c) general.json on greedy_place differs "
                             f"from the torch pass's at {P15_WIDE_HOSTS} "
                             "hosts")
    log(f"  (c) Cost-Aware, {P15_WIDE_APPS} apps at {P15_WIDE_HOSTS} hosts "
        f"on cuda: {k['launches']} greedy_place launches ({cfg.cluster} "
        f"CTAs of {cfg.threads} threads a replica) = {d['kernel_ticks']} "
        f"kernel ticks + {d['span_kernel_ticks']} span kernel ticks, each "
        f"held against cost_aware_plain; general.json byte-equal to the "
        f"use_kernel=False run (0 launches); walls {k['wall_s']!r} / "
        f"{t['wall_s']!r} s; max |avail diff| {chk.max_abs_err!r}")
    return dict(launches=k["launches"], dispatch=d, spans=k["spans"],
                wall_s=k["wall_s"], torch_wall_s=t["wall_s"],
                cluster=cfg.cluster)


def p15_e2e(device) -> dict:
    """Phase 15 (b): ``overall``'s VBP and Cost-Aware arms at the CLI
    default cluster through ``ExperimentRun``, host-sharded over
    P15_E2E_SHARDS logical shards of the card and unsharded (Cost-Aware
    with ``use_kernel=False``; VBP unsharded on ``carry_free_place``, the
    sharded run on the torch passes): ``general.json`` byte-equal, spans
    engaged, no ``greedy_place`` launch in either."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.ops import cuda_kernels as ck
    from pivot_tpu_torch.parallel.mesh import host_sharded_mesh
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import (
        build_cluster,
        make_policy,
        reference_policy_set,
    )

    cluster_cfg = cli._cluster_config(cli.parse_args(["overall"]))
    mesh = host_sharded_mesh(devices=[device] * P15_E2E_SHARDS)
    rec = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        for pc in reference_policy_set("cuda")[1:]:
            runs = {}
            for name in ("sharded", "unsharded"):
                policy = make_policy(pc, torch_device=str(device))
                if pc.name == "cost-aware":
                    policy.use_kernel = False
                if name == "sharded":
                    policy.enable_sharding(mesh)
                reset_ids()
                ck.reset_launches()  # the path's count starts here
                t0 = time.perf_counter()
                summary = ExperimentRun(
                    pc.label, build_cluster(cluster_cfg), policy, TRACE,
                    n_apps=P15_APPS, seed=0,
                    data_dir=os.path.join(tmp, name)).run()
                wall = time.perf_counter() - t0
                launches = ck.LAUNCHES["greedy_place"]
                cf = ck.LAUNCHES["carry_free_place"]
                with open(os.path.join(tmp, name, pc.label,
                                       "general.json"), "rb") as f:
                    general = f.read()
                runs[name] = dict(wall_s=wall, launches=launches,
                                  cf_launches=cf,
                                  general=general, spans=summary["spans"],
                                  dispatch=summary["dispatch"])
            sh_, un = runs["sharded"], runs["unsharded"]
            if sh_["general"] != un["general"]:
                raise AssertionError(f"{pc.label}: sharded general.json "
                                     "differs from the unsharded run's")
            if not sh_["spans"]["fused_spans"]:
                raise AssertionError(f"{pc.label}: no span served sharded")
            if sh_["launches"] or un["launches"]:
                raise AssertionError(f"{pc.label}: greedy_place launched")
            vbp = pc.name == "first-fit"
            if sh_["cf_launches"] or bool(un["cf_launches"]) != vbp:
                raise AssertionError(
                    f"{pc.label}: carry_free_place launches sharded "
                    f"{sh_['cf_launches']}, unsharded {un['cf_launches']}")
            rec[pc.label] = dict(
                sharded_wall_s=sh_["wall_s"], unsharded_wall_s=un["wall_s"],
                launches=sh_["launches"], spans=sh_["spans"],
                dispatch=sh_["dispatch"],
                unsharded_cf_launches=un["cf_launches"])
            log(f"  (b) {pc.label}, {P15_APPS} apps at 600 hosts: "
                f"general.json byte-equal sharded (S={P15_E2E_SHARDS}) and "
                f"unsharded; walls {sh_['wall_s']!r} / {un['wall_s']!r} s; "
                f"{sh_['spans']['fused_spans']} spans of "
                f"{sh_['spans']['fused_ticks']} ticks, "
                f"{sh_['dispatch']['device_ticks']} per-tick dispatches; "
                f"0 greedy_place launches; carry_free_place launches "
                f"sharded 0, unsharded {un['cf_launches']}")
    return rec


def phase_sharding(device, ck) -> dict:
    """Phase 15 (module docstring).  Returns its record."""
    card = card_line()
    log(f"  [{card}]")
    chk = Check()
    t0 = time.perf_counter()
    pod = p15_pod(device, ck, chk)
    t1 = time.perf_counter()
    log(f"  (a): {t1 - t0!r} s")
    e2e = p15_e2e(device)
    t2 = time.perf_counter()
    log(f"  (b): {t2 - t1!r} s")
    wide = p15_wide(device, ck, chk)
    log(f"  (c): {time.perf_counter() - t2!r} s")
    return dict(pod=pod["arms"], greedy=pod["greedy"], e2e=e2e, wide=wide,
                launches=sum(r["launches"] for r in e2e.values()),
                wide_launches=wide["launches"],
                compare_launches=pod["compare_launches"],
                max_abs_err=chk.max_abs_err)


# -- phase 16: the replica axis ---------------------------------------------

#: Logical replica shards of the card: the sharded rollouts, the search
#: population and the capacity sweep (4), the lock-step grid's batcher (2:
#: its flushes of 2-4 runs pad to buckets of 2 and 4).
P16_SHARDS = 4
P16_GRID_SHARDS = 2
#: (a)'s replicas: cut from the ``ensemble`` default 1024 for phase 17's
#: time (the unsharded referent runs in the card pool).
P16_ROLLOUT_REPLICAS = 256
#: (e)'s traces: the first 2 of phase 11 (b)'s 4, cut for phase 17's
#: time.
P16_GRID_TRACES = 2
#: (b) and (d) run phase 7 (b)'s commands (25 apps, cut from the
#: ``ensemble`` default 50 for the script's 1,200 s; R = 64, ``--faults 4
#: --fault-mttr 300``; ``capacity --host-counts 100 200 400 600``).
P16_FROM_PHASE_7 = ("ensemble-faults cost-aware", "capacity")


def p16_mesh(device, S):
    from pivot_tpu_torch.parallel.mesh import replica_mesh

    return replica_mesh(devices=[torch.device(device)] * S)


def p16_argv(label) -> list:
    return next(argv for name, _fn, argv in SW_MAIN if name == label)


def p16_faults(device, sharded):
    """(b): the ``ensemble --replicas 64 --faults 4 --fault-mttr 300``
    rollout (25 apps) sharded over ``P16_SHARDS`` logical shards, or the
    unsharded ``rollout`` (the contracted fault draw, as the sharded
    program draws it): ``(result, seconds, ticks)``."""
    import functools

    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.parallel.ensemble import (
        prng,
        rollout,
        sharded_rollout,
    )

    args = cli.parse_args(ensemble_argv("unused", *p16_argv(
        P16_FROM_PHASE_7[0])[1:]))
    _a, inputs = ensemble_inputs(cli, device, n_apps=args.num_apps)
    fn = (functools.partial(sharded_rollout, p16_mesh(device, P16_SHARDS))
          if sharded else rollout)
    st = {}
    t0 = time.perf_counter()
    res = _result(fn(
        prng.PRNGKey(args.seed), *inputs, n_replicas=args.replicas,
        tick=args.tick, max_ticks=args.max_ticks, perturb=args.perturb,
        n_faults=args.faults, fault_horizon=args.fault_horizon,
        mttr=args.fault_mttr, policy=args.policy,
        tick_order=args.tick_order, stats=st))
    return res, time.perf_counter() - t0, st["ticks"]


def p16_capacity(device):
    """(d): phase 7 (b)'s ``capacity`` command through the CLI, its sweep
    ``shard_sweep(capacity_sweep, force_mesh=True)`` over ``P16_SHARDS``
    logical shards of the card: ``(summary, ticks, the sweep's type)``."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.parallel.ensemble import shard_sweep

    routed = []

    def sharded(sweep_fn, _device, **static_kw):
        fn = shard_sweep(sweep_fn, force_mesh=True, devices=[
            torch.device(device)] * P16_SHARDS, **static_kw)
        routed.append(type(fn).__name__)
        return fn

    st = {}
    orig, cli._maybe_shard_sweep = cli._maybe_shard_sweep, sharded
    try:
        with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
            summary = cli.run_capacity(cli.parse_args(
                ["--job-dir", "data/jobs", "--output-dir", tmp,
                 *p16_argv(P16_FROM_PHASE_7[1])]), stats=st)
    finally:
        cli._maybe_shard_sweep = orig
    return summary, st["ticks"], routed


def p16_same(got: dict, want: dict, what) -> None:
    """Every field two rollout results share equal bit for bit (the same
    program on the same card: the egress bill too).  The CLI's
    ``rollout.npz`` has all but ``n_unfinished``."""
    shared = [f for f in ENS_FIELDS if f in got and f in want]
    if len(shared) < len(ENS_FIELDS) - 1:
        raise AssertionError(f"{what}: only {shared} to compare")
    for f in shared:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{what}: {f} differs")


def p16_rollout(device, sharded, args, on_card):
    """(a)'s rollout at the ``ensemble`` defaults, R =
    ``P16_ROLLOUT_REPLICAS``, cost-aware: sharded over ``P16_SHARDS``
    logical shards or not.  Returns the arrays and the tick loop's counts
    (``rollout``'s ``stats``)."""
    import functools

    from pivot_tpu_torch.parallel.ensemble import (
        prng,
        rollout,
        sharded_rollout,
    )

    fn = (functools.partial(sharded_rollout, p16_mesh(device, P16_SHARDS))
          if sharded else rollout)
    st = {}
    torch.cuda.synchronize()
    res = _result(fn(
        prng.PRNGKey(args.seed), *on_card,
        n_replicas=P16_ROLLOUT_REPLICAS, tick=args.tick,
        max_ticks=args.max_ticks, perturb=args.perturb, policy="cost-aware",
        tick_order=args.tick_order, stats=st))
    return dict(arrays=res, loop_wall_s=st["wall_s"],
                event_span_ms=st.get("event_span_ms"), ticks=st["ticks"])


def p16_rollout_ref(device):
    """(a)'s unsharded referent (the card pool's run)."""
    from pivot_tpu_torch.experiments import cli

    args, on_card = ensemble_inputs(cli, device)
    return p16_rollout(device, False, args, on_card)


def p16_without_backend(report) -> dict:
    """A search report with its backend names taken out."""
    report = json.loads(json.dumps(report))
    for section in ("config", "search"):
        report[section].pop("backend")
    return report


def p16_search(device, refs) -> dict:
    """(c): the README quickstart with ``--backend sharded_rollout``
    through the CLI (one card: a mesh of one shard) against phase 8's
    report, and the 10,240-row population over ``P16_SHARDS`` logical
    shards against phase 8's scores."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.search import fitness as F

    label, _rows, argv = SR_MAIN[0]
    out = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        path = os.path.join(tmp, "report.json")
        want = refs.get("quickstart")
        if want is None:
            want, _row, _calls = sr_cli_run(cli, F, argv, path)
        got, row, _calls = sr_cli_run(
            cli, F, [*argv, "--backend", "sharded_rollout"], path)
        if p16_without_backend(got) != p16_without_backend(want):
            raise AssertionError("(c) the sharded backend's quickstart "
                                 "report differs from the rollout backend's")
        pop = refs.get("population")
        if pop is None:
            _report, _row, calls = sr_cli_run(cli, F, SR_MAIN[-1][2], path)
            pop = next(c for c in calls if c["rows"] == SR_MAIN[-1][1])
            del calls
    out["quickstart"] = dict(wall_s=row["wall_s"],
                             generations_per_s=row["generations_per_s"],
                             best_score=row["best_score"])
    log(f"  (c) {label} with --backend sharded_rollout through the CLI (a "
        f"mesh of the one visible card): the report equals the rollout "
        f"backend's ({'phase 8' if 'quickstart' in refs else 'run here'}); "
        f"wall {row['wall_s']!r} s, {row['generations_per_s']!r} "
        f"generations/s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, details = F.evaluate_rows(
        pop["weights"], pop["env"], key=pop["key"],
        backend="sharded_rollout", mesh=p16_mesh(device, P16_SHARDS))
    wall = time.perf_counter() - t0
    if not np.array_equal(scores, pop["scores"]):
        raise AssertionError("(c) the sharded population's scores differ "
                             "from the rollout backend's")
    if details["n_rows"] != pop["rows"]:
        raise AssertionError(f"(c) {details['n_rows']} rows, not "
                             f"{pop['rows']}")
    out["population"] = dict(rows=pop["rows"], wall_s=wall)
    log(f"  (c) the {pop['rows']}-row population (generation 0 of phase 8's "
        f"run{'' if 'population' in refs else ', run here'}) through "
        f"evaluate_rows(backend='sharded_rollout') over {P16_SHARDS} "
        f"logical shards: scores equal the rollout backend's bit for bit; "
        f"{wall!r} s")
    return out


def p16_grid(device, ck, mesh, tmp, chk) -> dict:
    """(e): ``overall --batch-runs 4`` on phase 11 (b)'s grid through the
    CLI, each lock-step grid's batcher on ``mesh`` (None: the meshless
    grid).  The launch counts are zeroed just before the run and read
    just after; every per-row launch is held against
    ``cost_aware_plain_rows``, every R = 1 launch against
    ``cost_aware_plain``."""
    from pivot_tpu_torch.experiments import cli, runner

    argv = ["--device", "cuda", "--num-hosts", "600", "--job-dir",
            "data/jobs", "--output-dir", tmp, "--seed", "0", "--trace-limit",
            str(P16_GRID_TRACES), "--batch-runs", "4", "overall",
            "--num-apps", str(P11_APPS)]
    chunks, lock = [], runner.run_grid_lockstep

    def run_grid_lockstep(runs, stats_out=None):
        stats = {}
        out = lock(runs, stats_out=stats, mesh=mesh)
        chunks.append(stats)
        if stats_out is not None:
            stats_out.update(stats)
        return out

    runner.run_grid_lockstep = run_grid_lockstep
    try:
        with RowsTap(sync_debug=False) as tap, R1Tap() as r1:
            ck.reset_launches()  # the path's count starts here
            t0 = time.perf_counter()
            exp_dir, _sums = cli.run_overall(cli.parse_args(argv),
                                             torch_device=device)
            wall = time.perf_counter() - t0
            launches = dict(rows=dict(ck.LAUNCHES_ROWS),
                            by_replicas=dict(ck.LAUNCHES_BY_REPLICAS))
    finally:
        runner.run_grid_lockstep = lock
    if len(tap.calls) != sum(launches["rows"].values()):
        raise AssertionError(f"(e) {len(tap.calls)} per-row launches "
                             f"recorded of {launches}")
    for i, (a, kw, got) in enumerate(tap.calls):
        chk.same(got, ck.cost_aware_plain_rows(*a, **kw), ("(e)", i))
    r1.hold(chk, launches["by_replicas"], "(e)")
    stats = {k: sum(c.get(k, 0) for c in chunks) for k in (
        "dispatches", "device_calls", "coalesced", "mesh_dispatches",
        "mesh_fallbacks", "mesh_fallback_unshardable",
        "mesh_fallback_mixed_shapes", "mesh_fallback_indivisible")}
    return dict(files=grid_files(exp_dir), wall=wall, launches=launches,
                batcher=stats)


def phase_replica_axis(device, ck, refs) -> dict:
    """Phase 16 (module docstring).  ``refs``: the referents the earlier
    phases left (``p16_refs``); what is missing is run here.  Returns its
    record."""
    from pivot_tpu_torch.experiments import cli

    card = card_line()
    log(f"  [{card}]")
    chk = Check()
    rec = {}
    ck.reset_launches()  # (a)-(d) launch no greedy_place

    # (a) the sharded rollout at the ensemble defaults, R = 256.
    t0 = time.perf_counter()
    args, on_card = ensemble_inputs(cli, device)
    in_pool = ("rollout",) in refs
    want = refs.get(("rollout",)) or p16_rollout(device, False, args,
                                                 on_card)
    got = p16_rollout(device, True, args, on_card)
    p16_same(got["arrays"], want["arrays"], "(a) sharded vs unsharded")
    if got["arrays"]["n_unfinished"].max() != 0:
        raise AssertionError("(a) tasks unfinished at the horizon")
    rec["a"] = {k: {f: r[f] for f in ("loop_wall_s", "event_span_ms",
                                      "ticks")}
                for k, r in (("sharded", got), ("unsharded", want))}
    ratio = got["loop_wall_s"] / want["loop_wall_s"]
    rec["a"]["wall_ratio"] = ratio
    rec["a"]["unsharded_in_pool"] = in_pool
    log(f"  (a) sharded_rollout over {P16_SHARDS} logical shards, "
        f"cost-aware R={P16_ROLLOUT_REPLICAS} at the ensemble defaults (T="
        f"{on_card[1].n_tasks}, H={on_card[0].shape[0]}): every field equals "
        f"the unsharded rollout's bit for bit "
        f"({'in the card pool' if in_pool else 'run here'}); tick "
        f"loop {got['loop_wall_s']!r} s sharded vs {want['loop_wall_s']!r} "
        f"s unsharded ({ratio!r}x"
        + (", the unsharded loop shared the card with the pool"
           if in_pool else "")
        + f"), {got['event_span_ms']!r} / "
        f"{want['event_span_ms']!r} ms between CUDA events, {got['ticks']} "
        f"/ {want['ticks']} ticks")
    del got, want
    log(f"  (a): {time.perf_counter() - t0!r} s")

    # (b) faults with an mttr, R = 64: the contracted draw.
    t0 = time.perf_counter()
    runs = {s: refs.get(("faults", s)) or p16_faults(device, s)
            for s in (True, False)}
    (sh, sh_s, sh_t), (un, un_s, un_t) = runs[True], runs[False]
    p16_same(sh, un, "(b) sharded vs unsharded, faults with an mttr")
    if not np.isfinite(sh["makespan"]).all():
        raise AssertionError("(b) non-finite makespans")
    rec["b"] = dict(sharded_s=sh_s, unsharded_s=un_s, ticks=sh_t,
                    in_pool=("faults", True) in refs)
    cli_eager = refs.get(P16_FROM_PHASE_7[0])
    eager = None
    if cli_eager is not None:
        eager = cli_eager["makespan_mean"] == float(sh["makespan"].mean())
        rec["b"]["equals_phase7_cli"] = eager
    log(f"  (b) sharded_rollout, R=64, --faults 4 --fault-mttr 300, 25 apps "
        f"over {P16_SHARDS} logical shards: every field equals the unsharded "
        f"rollout's (the contracted fault draw) bit for bit; {sh_t} ticks; "
        f"{sh_s!r} s sharded, {un_s!r} s unsharded"
        + (" (in the card pool)" if rec["b"]["in_pool"] else "")
        + ("" if eager is None else f"; makespan mean equal to phase 7 "
           f"(b)'s CLI run (the eager draw): {eager}"))
    log(f"  (b): {time.perf_counter() - t0!r} s")

    # (c) the search's sharded backend.
    t0 = time.perf_counter()
    rec["c"] = p16_search(device, refs)
    log(f"  (c): {time.perf_counter() - t0!r} s")

    # (d) the capacity sweep, sharded.
    t0 = time.perf_counter()
    summary, ticks, routed = (refs.get(("capacity",))
                              or p16_capacity(device))
    want = refs.get(P16_FROM_PHASE_7[1])
    if want is None:
        with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
            want = cli.run_capacity(cli.parse_args(
                ["--job-dir", "data/jobs", "--output-dir", tmp,
                 *p16_argv(P16_FROM_PHASE_7[1])]))
    if routed != ["_ShardedSweep"]:
        raise AssertionError(f"(d) the capacity sweep was not sharded: "
                             f"{routed}")
    drop = ("wall_s",)
    if ({k: v for k, v in summary.items() if k not in drop}
            != {k: v for k, v in want.items() if k not in drop}):
        raise AssertionError("(d) the sharded capacity sweep's summary "
                             "differs from phase 7's")
    rec["d"] = dict(wall_s=summary["wall_s"], ticks=ticks,
                    in_pool=("capacity",) in refs)
    log(f"  (d) shard_sweep(capacity_sweep, force_mesh=True) over "
        f"{P16_SHARDS} logical shards through the capacity CLI (--faults 4 "
        f"--fault-mttr 300, 25 apps, {summary['rollouts']} rollouts): the "
        f"summary equals phase 7 (b)'s unsharded one; {summary['wall_s']!r} "
        f"s, {ticks} ticks"
        + (" (in the card pool)" if rec["d"]["in_pool"] else ""))
    if ck.LAUNCHES["greedy_place"]:
        raise AssertionError("(a)-(d) launched greedy_place")
    log(f"  (d): {time.perf_counter() - t0!r} s")

    # (e) the lock-step grid on the batcher's replica mesh.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        ref = refs.get("grid")
        if ref is None:
            ref = p16_grid(device, ck, None, os.path.join(tmp, "plain"),
                           Check())["files"]
        grid = p16_grid(device, ck, p16_mesh(device, P16_GRID_SHARDS),
                        os.path.join(tmp, "mesh"), chk)
    traces = {k[0] for k in grid["files"]}
    differ = files_differ(grid["files"],
                          {k: v for k, v in ref.items() if k[0] in traces})
    if differ or len(traces) != P16_GRID_TRACES:
        raise AssertionError(f"(e) files differ from the meshless grid: "
                             f"{differ[:6]} ({len(traces)} traces)")
    st, launches = grid["batcher"], grid["launches"]
    rows = sum(launches["rows"].values())
    if not st["mesh_dispatches"] or not rows:
        raise AssertionError(f"(e) nothing rode the mesh: {st}, {launches}")
    if st["mesh_fallbacks"] != sum(st[f"mesh_fallback_{c}"] for c in (
            "unshardable", "mixed_shapes", "indivisible")):
        raise AssertionError(f"(e) the fallback causes do not add up: {st}")
    rec["e"] = dict(wall=grid["wall"], batcher=st, launches=launches)
    log(f"  (e) overall --batch-runs 4, {P16_GRID_TRACES} traces (of "
        f"phase 11 (b)'s {P11_TRACES}) x 3 arms x "
        f"{P11_APPS} apps at 600 hosts, each lock-step grid's batcher on "
        f"replica_mesh(devices=[cuda:0] * {P16_GRID_SHARDS}): files "
        f"byte-identical to the meshless grid "
        f"({'phase 11 (b)' if 'grid' in refs else 'run here'}); wall "
        f"{grid['wall']!r} s; batcher {st}; {rows} per-row launches by G "
        f"{launches['rows']}, each held against cost_aware_plain_rows; R=1 "
        f"launches {launches['by_replicas']}, each held against "
        f"cost_aware_plain (max |avail diff| {chk.max_abs_err!r})")
    log(f"  (e): {time.perf_counter() - t0!r} s")
    rec["launches_r1"] = launches["by_replicas"].get(1, 0)
    rec["launches_rows_by_g"] = launches["rows"]
    rec["launches_rows"] = rows
    rec["max_abs_err"] = chk.max_abs_err
    return rec


# -- phase 17: the 2-D serving mesh -----------------------------------------

#: (a) phase 15's pod-scale tick (``bench.py:3018-3019``), G rows, on a
#: (1, replica 2, host 4) mesh of 8 logical shards of the card.
P17_G = 2
P17_MESH_A = (2, 4)
#: (a) the ragged batched span: (horizon, slots) of its G = 3 spans at 600
#: hosts (phase 11's Cost-Aware requests with a market, served by the
#: torch pass), on a (1, replica 3, host 4) mesh.
P17_SPANS = ((3, 24), (11, 48), (6, 32))
P17_SPAN_MESH = (3, 4)
#: (b) the README's 2-D serve command (``README.md:100-102``) without its
#: ``--shard-hosts 2``, which each run sets on a mesh of logical shards.
P17_SERVE = ("--sessions", "3", "--jobs", "300", "--arrival-rate", "25",
             "--fuse-spans", "slo", "--tenant-quota", "0.5", "--tier-mix",
             "0.25,0.35,0.40", "--tier-reserve", "0,2,4", "--tier-policies",
             "spill,shed,shed")
#: (replica, host) logical shards of (b) and (c): on replica 4 a coalesced
#: pair of kernel ticks (bucket 2) cannot ride the mesh.
P17_MESH_B = (2, 2)
P17_MESH_C = (4, 2)
#: (d) the README's resident command (``README.md:122-123``), its
#: sessions host-sharded over ``P17_RESIDENT_SHARDS`` logical shards.
P17_RESIDENT = ("--sessions", "3", "--jobs", "300", "--arrival-rate", "25",
                "--fuse-spans", "slo", "--resident", "--splice-tier", "1")
P17_RESIDENT_SHARDS = 2
#: (e) ``serve --shard-hosts 1`` through the real CLI in a process of its
#: own (one card: only S = 1 divides the visible devices).
P17_ONESHOT = ("--device", "cuda", "serve", "--shard-hosts", "1",
               "--sessions", "2", "--jobs", "40", "--arrival-rate", "5",
               "--fuse-spans", "slo")


def p17_mesh(device, R, S):
    """``build_hybrid_mesh(host_parallel=S)`` over R·S logical shards."""
    from pivot_tpu_torch.parallel.mesh import build_hybrid_mesh

    return build_hybrid_mesh(host_parallel=S,
                             devices=[torch.device(device)] * (R * S))


def p17_twin_call(arm, x, mesh, phase2="auto"):
    """One call of ``arm``'s [G]-batched 2-D twin on the stacked tick
    ``x`` (``p15_inputs``' operands, a leading row axis)."""
    from pivot_tpu_torch.ops import shard as sh

    args = (x["avail"], x["dem"], x["valid"])
    if arm == "opportunistic":
        return sh.opportunistic_kernel_sharded_batched(
            mesh, *args, x["u"], phase2=phase2)
    if arm == "cost-aware":
        return sh.cost_aware_kernel_sharded_batched(
            mesh, *args, x["ng"], x["az"], x["cost"], x["bw"], x["hz"],
            x["counts"], **P15_CA, phase2=phase2)
    fn = {"first-fit": sh.first_fit_kernel_sharded_batched,
          "best-fit": sh.best_fit_kernel_sharded_batched}[arm]
    return fn(mesh, *args, phase2=phase2)


def p17_pod(device, p15) -> dict:
    """(a): the four arms per-step and Cost-Aware at C = 8 through the
    batched twins on G rows of the pod-scale tick, each row bit-equal to
    the unsharded torch form on it; ms a call by CUDA events."""
    rows = [p15_inputs(17 + g, P15_T, P15_H, device) for g in range(P17_G)]
    x = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    mesh = p17_mesh(device, *P17_MESH_A)
    rec = {}
    for arm, mode in [(a, "auto") for a in P15_ARMS] + [
            ("cost-aware", P15_CHUNK)]:
        got = p17_twin_call(arm, x, mesh, mode)
        placed = []
        for g, r in enumerate(rows):
            want = p15_call(arm, r)
            p15_exact((got[0][g], got[1][g]), want,
                      f"(a) {arm} {mode} row {g}")
            placed.append(int((want[0] >= 0).sum()))
        ms = _events_ms(lambda: p17_twin_call(arm, x, mesh, mode), 1)
        key = f"{arm} {'step' if mode == 'auto' else f'C={mode}'}"
        one_d = p15 and p15["pod"][arm][
            f"S4_{'step' if mode == 'auto' else 'chunk'}_ms"]
        rec[key] = dict(ms=ms, placed=placed, phase15_S4_ms=one_d)
        log(f"  (a) {key}, G={P17_G} x H={P15_H} x T={P15_T} on "
            f"(1, {P17_MESH_A[0]}, {P17_MESH_A[1]}): every row = the "
            f"unsharded torch form's bit for bit ({placed} placed); "
            f"{ms!r} ms a call (CUDA events)"
            + ("" if one_d is None else
               f"; phase 15's 1-D S=4 form {one_d!r} ms a row"))
    return rec


def p17_ragged(device) -> dict:
    """(a) the ragged span: G = 3 spans of different horizons padded to
    one (K', B') bucket through ``sharded_batched_tick_run`` (``n_ticks
    _dyn`` a [G] operand), each row trimmed back equal to its solo
    ``sharded_fused_tick_run``."""
    from pivot_tpu_torch.ops import shard as sh
    from pivot_tpu_torch.ops import tickloop as tt
    from pivot_tpu_torch.parallel.mesh import host_sharded_mesh

    reqs = []
    for seed, (n, S) in enumerate(P17_SPANS):
        args, kw, static = p11_request(170 + seed, n, S, True)
        static.pop("greedy")
        reqs.append((args, kw, static))
    k2 = max(r[2]["n_ticks"] for r in reqs)
    b2 = max(r[0][1].shape[0] for r in reqs)
    padded = [tt.ragged_span_pad(a, k, k2, b2) for a, k, _s in reqs]
    static = dict(reqs[0][2], n_ticks=k2)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    cols = [dev(np.stack([p[0][i] for p in padded])) for i in range(3)]
    kw = {k: (np.stack([p[1][k] for p in padded])
              if k in tt.SPAN_HOST_OPERANDS
              else dev(np.stack([p[1][k] for p in padded])))
          for k in padded[0][1]}
    horizons = np.array([n for n, _S in P17_SPANS], np.int32)
    mesh = p17_mesh(device, *P17_SPAN_MESH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sh.sharded_batched_tick_run(mesh, *cols, horizons, **kw, **static)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    solo_mesh = host_sharded_mesh(devices=[device] * P17_SPAN_MESH[1])
    placed = []
    for g, (args, k, own) in enumerate(reqs):
        row = tt.ragged_span_trim(tt.SpanResult(*(f[g] for f in got)),
                                  own["n_ticks"], args[1].shape[0])
        solo = sh.sharded_fused_tick_run(
            solo_mesh, dev(args[0]), dev(args[1]), dev(args[2]),
            int(args[3]), **{n: v if n in tt.SPAN_HOST_OPERANDS else dev(v)
                             for n, v in k.items()}, **own)
        for f in row._fields:
            a, b = getattr(row, f), getattr(solo, f)
            if a.shape != b.shape or not torch.equal(
                    a.view(torch.int32) if a.dtype == torch.float32 else a,
                    b.view(torch.int32) if b.dtype == torch.float32 else b):
                raise AssertionError(f"(a) ragged span row {g}: {f} differs "
                                     "from its solo sharded span")
        placed.append(int((row.placements >= 0).sum()))
    if not all(placed):
        raise AssertionError(f"(a) ragged spans placed {placed}")
    log(f"  (a) sharded_batched_tick_run: G={len(reqs)} Cost-Aware spans "
        f"of horizons {horizons.tolist()} (market operands, a live mask) at "
        f"600 hosts padded to (K'={k2}, B'={b2}) on (1, {P17_SPAN_MESH[0]}, "
        f"{P17_SPAN_MESH[1]}): each row = its solo sharded_fused_tick_run "
        f"bit for bit ({placed} placed); {wall!r} s")
    return dict(horizons=horizons.tolist(), k2=k2, b2=b2, placed=placed,
                wall_s=wall)


@contextlib.contextmanager
def p17_cards(n, device):
    """The CLI's visible cards as ``n`` logical shards of the card, so
    ``serve --shard-hosts S`` builds its hybrid mesh over them."""
    from pivot_tpu_torch.parallel import mesh as pm

    orig = pm.visible_cards
    pm.visible_cards = lambda: [torch.device(device)] * n
    try:
        yield
    finally:
        pm.visible_cards = orig


@contextlib.contextmanager
def p17_driver_mesh(mesh):
    """The CLI's ``ServeDriver`` handed ``mesh`` (its sessions' policies
    left unsharded): put in place inside ``ServeRecorder.attach``."""
    from pivot_tpu_torch import serve

    base = serve.ServeDriver

    class Driver(base):
        def __init__(self, *a, **k):
            k["mesh"] = mesh
            super().__init__(*a, **k)

    serve.ServeDriver = Driver
    try:
        yield
    finally:
        serve.ServeDriver = base


@contextlib.contextmanager
def p17_submits():
    """Each scheduler's submissions, in the order it took them: a list of
    ``(sim instant, app id)`` on the scheduler (``_p17_submits``)."""
    from pivot_tpu_torch.sched import GlobalScheduler

    orig = GlobalScheduler.submit

    def submit(self, app):
        self.__dict__.setdefault("_p17_submits", []).append(
            (self.env.now, app.id))
        return orig(self, app)

    GlobalScheduler.submit = submit
    try:
        yield
    finally:
        GlobalScheduler.submit = orig


def p17_serve(cli, ck, name, tmp, argv, cards=None, driver_mesh=None,
              device="cuda"):
    """One CLI ``serve`` of ``argv`` through ``cli.main`` (``ServeRecorder``
    taps, an ``R1Tap``, each session's submissions recorded, launch counts
    zeroed just before and read just after): ``(report, recorder,
    launches, R=1 tap)``."""
    from pivot_tpu_torch.utils import reset_ids

    rec, r1 = ServeRecorder(), R1Tap()
    buf = io.StringIO()
    reset_ids()
    with contextlib.ExitStack() as stack:
        if cards is not None:
            stack.enter_context(p17_cards(cards, device))
        stack.enter_context(rec.attach())
        if driver_mesh is not None:
            stack.enter_context(p17_driver_mesh(driver_mesh))
        stack.enter_context(r1)
        stack.enter_context(p17_submits())
        stack.enter_context(contextlib.redirect_stdout(buf))
        ck.reset_launches()
        cli.main(["--output-dir", os.path.join(tmp, name), "serve", *argv])
        launches = dict(total=ck.LAUNCHES["greedy_place"],
                        rows=dict(ck.LAUNCHES_ROWS),
                        by_replicas=dict(ck.LAUNCHES_BY_REPLICAS))
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    c = report["slo"]["counters"]
    if c["completed"] != c["admitted"] or \
            c["completed"] + c["shed"] != c["arrived"]:
        raise AssertionError(f"serve {name}: {c}")
    rec.driver.audit(f"serve {name}")
    return report, rec, launches, r1


def p17_stream(cli, args) -> dict:
    """The CLI's arrival stream for ``args``, fresh from the seed:
    ``{app id: app}``."""
    from pivot_tpu_torch.serve import mixed_tier_arrivals, poisson_arrivals
    from pivot_tpu_torch.utils import reset_ids

    reset_ids()
    if args.tier_mix:
        stream = mixed_tier_arrivals(
            args.arrival_rate, args.jobs,
            weights=tuple(float(w) for w in args.tier_mix.split(",")),
            seed=args.seed)
    else:
        stream = poisson_arrivals(args.arrival_rate, args.jobs,
                                  seed=args.seed)
    return {x.app.id: x.app for x in stream}


def p17_batch_referee(cli, argv, rec, report, name) -> int:
    """Each session against the per-tick, unsharded batch-mode run of the
    jobs it injected, submitted at the instants and in the order its
    scheduler took them (``p17_submits``; the torch Cost-Aware pass:
    ``use_kernel=False``, no launch): placements and the run meters
    equal.  Which session gets which job, and when a spilled job
    re-enters (a late injection, at the session's clock), follow the
    threads' timing in replay mode, so two service runs need not admit
    alike; each session's own submissions have one unsharded answer.
    Returns the jobs compared."""
    from pivot_tpu_torch.experiments.runner import ExperimentRun
    from pivot_tpu_torch.utils.config import (
        PolicyConfig, build_cluster, make_policy)
    from pivot_tpu_torch.workload.trace import TraceSchedule

    args = cli.parse_args(["serve", *argv])
    fresh = p17_stream(cli, args)
    if report["slo"]["counters"]["arrived"] != len(fresh):
        raise AssertionError(f"serve {name}: {report['slo']['counters']} of "
                             f"a {len(fresh)}-job stream")
    pcfg = PolicyConfig(name="cost-aware", device="cuda",
                        bin_pack="first-fit", sort_tasks=True,
                        sort_hosts=True)
    n = 0
    for g, sess in enumerate(sorted(rec.sessions, key=lambda s: s.slot)):
        apps = [fresh[app.id] for app in sess._injected]
        bins = [(0.0, [])]
        for t, app_id in sess.scheduler._p17_submits:
            if t == bins[-1][0]:
                bins[-1][1].append(fresh[app_id])
            else:
                bins.append((t, [fresh[app_id]]))
        policy = make_policy(pcfg)
        policy.use_kernel = False
        want = ExperimentRun(
            f"batch-{g}", build_cluster(cli._cluster_config(args)), policy,
            schedule=TraceSchedule(bins), seed=args.seed, interval=5.0,
            fuse_spans=False).run()
        served = [t.placement for app in sess._injected
                  for grp in app.groups for t in grp.tasks]
        batch_p = [t.placement for app in apps
                   for grp in app.groups for t in grp.tasks]
        if served != batch_p:
            raise AssertionError(f"serve {name}: session {g}'s placements "
                                 "differ from the unsharded per-tick run")
        got = sess.summary()
        if {k: got[k] for k in SERVE_KEYS} != {k: want[k]
                                              for k in SERVE_KEYS}:
            raise AssertionError(f"serve {name}: session {g}'s meters "
                                 f"{got} != unsharded per-tick {want}")
        n += len(apps)
    return n


def p17_2d_serve(device, ck, cli, tmp, card, serve10) -> dict:
    """(b): the README's 2-D command at 600 hosts a session, every session
    host-sharded and the driver's batcher on the (1, 2, 2) mesh."""
    R, S = P17_MESH_B
    argv = [*P17_SERVE, "--shard-hosts", str(S)]
    report, rec, launches, _r1 = p17_serve(cli, ck, "b", tmp, argv,
                                           cards=R * S, device=device)
    st = report["batcher"]
    if launches["total"]:
        raise AssertionError(f"(b) the sharded serve launched greedy_place: "
                             f"{launches}")
    if report["mesh"] != {"replica_dcn": 1, "replica": R, "host": S}:
        raise AssertionError(f"(b) report mesh {report['mesh']}")
    if not all(s.policy._mesh is not None for s in rec.sessions):
        raise AssertionError("(b) a session's policy is not host-sharded")
    if not st["mesh_dispatches"] or st["mesh_fallbacks"] != sum(
            st[f"mesh_fallback_{c}"] for c in (
                "unshardable", "mixed_shapes", "indivisible")):
        raise AssertionError(f"(b) batcher {st}")
    spans = sum(s.summary()["span_stats"]["fused_spans"] for s in rec.sessions)
    if not spans:
        raise AssertionError("(b) no span served")
    t0 = time.perf_counter()
    jobs = p17_batch_referee(cli, argv, rec, report, "b")
    ref_s = time.perf_counter() - t0
    row = serve_log("17 (b)", report, launches, card)
    row.update(spans=spans, referee_jobs=jobs, referee_s=ref_s,
               mesh=report["mesh"])
    if serve10 is not None:
        log(f"    phase 10 (c)'s unsharded tiers (its own command): "
            + ", ".join(f"{t}: p50 {v['p50_ms']!r} p99 {v['p99_ms']!r} ms"
                        for t, v in serve10["c"]["tiers"].items()))
    log(f"    (b) sessions host-sharded (S={S}) on the (1, {R}, {S}) mesh: "
        f"{spans} spans, {st['mesh_dispatches']} mesh dispatches, "
        f"fallbacks {st['mesh_fallbacks']} (unshardable "
        f"{st['mesh_fallback_unshardable']}, mixed shapes "
        f"{st['mesh_fallback_mixed_shapes']}, indivisible "
        f"{st['mesh_fallback_indivisible']}); each session = the unsharded "
        f"per-tick run of its {jobs} jobs in all (placements and meters; "
        f"{ref_s!r} s); 0 greedy_place launches; audit clean")
    return row


def p17_kernel_serve(device, ck, cli, tmp, card, chk) -> dict:
    """(c): the same command, the sessions unsharded (their Cost-Aware
    ticks on ``greedy_place``) and the driver's batcher on the (1, 4, 2)
    mesh: every per-row and R = 1 launch held against its plain version;
    a coalesced pair cannot ride replica 4 and falls back as
    ``unshardable``."""
    mesh = p17_mesh(device, *P17_MESH_C)
    report, rec, launches, r1 = p17_serve(cli, ck, "c", tmp, P17_SERVE,
                                          driver_mesh=mesh, device=device)
    st = report["batcher"]
    rows = sum(launches["rows"].values())
    if launches["total"] != rows + launches["by_replicas"].get(1, 0) or \
            set(launches["by_replicas"]) - {1} or rows != len(rec.rows):
        raise AssertionError(f"(c) launches {launches}, {len(rec.rows)} "
                             "per-row recorded")
    if any(s.policy._mesh is not None for s in rec.sessions):
        raise AssertionError("(c) a session is host-sharded")
    for i, (a, k, got) in enumerate(rec.rows):
        chk.same(got, ck.cost_aware_plain_rows(*a, **k), ("(c)", "rows", i))
    r1.hold(chk, launches["by_replicas"], "(c)")
    if not st["mesh_fallbacks"] or \
            st["mesh_fallback_unshardable"] != st["mesh_fallbacks"]:
        raise AssertionError(f"(c) the kernel's fallbacks are not all "
                             f"unshardable: {st}")
    row = serve_log("17 (c)", report, launches, card)
    row["mesh"] = report["mesh"]
    log(f"    (c) unsharded Cost-Aware sessions on the (1, "
        f"{P17_MESH_C[0]}, {P17_MESH_C[1]}) batcher: {rows} per-row launches "
        f"by G {launches['rows']}, {launches['by_replicas'].get(1, 0)} R=1, "
        f"each held against its plain version (max |avail diff| "
        f"{chk.max_abs_err!r}); {st['mesh_dispatches']} mesh dispatches, "
        f"{st['mesh_fallbacks']} fallbacks, all unshardable; audit clean")
    return row


def p17_resident(device, ck, cli, tmp, card) -> dict:
    """(d): the README's resident command with every session host-sharded
    over 2 logical shards: spans on the sharded carries, edit rows and
    splices, each session equal to the unsharded per-tick run of its
    jobs, no kernel build or graph capture."""
    from pivot_tpu_torch.utils.compile_counter import count_compiles

    argv = [*P17_RESIDENT, "--shard-hosts", str(P17_RESIDENT_SHARDS)]
    with count_compiles() as counter:
        report, rec, launches, _r1 = p17_serve(
            cli, ck, "d", tmp, argv, cards=P17_RESIDENT_SHARDS, device=device)
    if counter.kernel_builds or counter.graph_captures:
        raise AssertionError(f"(d) {counter.kernel_builds} kernel builds, "
                             f"{counter.graph_captures} graph captures")
    if launches["total"] or report["batcher"] is not None:
        raise AssertionError(f"(d) launches {launches}, batcher "
                             f"{report['batcher']}")
    resident = [s.policy.dispatch_stats()["resident"] for s in rec.sessions]
    tot = {k: sum(x[k] for x in resident) for k in resident[0]}
    splices = sum(s.summary()["span_stats"]["span_splices"]
                  for s in rec.sessions)
    if not tot["spans"] or not tot["edit_rows"] or any(
            s.policy._mesh is None for s in rec.sessions):
        raise AssertionError(f"(d) resident {tot}")
    t0 = time.perf_counter()
    jobs = p17_batch_referee(cli, argv, rec, report, "d")
    ref_s = time.perf_counter() - t0
    row = serve_log("17 (d)", report, launches, card)
    row.update(resident=tot, splices=splices, referee_jobs=jobs,
               referee_s=ref_s, kernel_builds=0, graph_captures=0)
    log(f"    (d) resident carries host-sharded (S={P17_RESIDENT_SHARDS}): "
        f"{tot['spans']} spans on the carries, {tot['edit_rows']} edit rows,"
        f" {splices} splices, {tot['d2h_bytes']} mirror-diff bytes; each "
        f"session = the unsharded per-tick run of its {jobs} jobs in all "
        f"({ref_s!r} s); 0 kernel builds, 0 graph captures, 0 greedy_place "
        "launches")
    return row


class P17OneShot:
    """(e): ``serve --shard-hosts 1`` through the real CLI in a process of
    its own.  Like ``P14OneShot`` it needs phase 1's build and runs beside
    phase 2, which times nothing; ``wait`` reads its report."""

    def __init__(self):
        self._tmp = tempfile.TemporaryDirectory(dir=os.getcwd())
        self._log = os.path.join(self._tmp.name, "oneshot.log")
        self._t0 = time.perf_counter()
        self.report = self.wall_s = None
        with open(self._log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "pivot_tpu_torch.experiments.cli",
                 "--output-dir", self._tmp.name, *P17_ONESHOT],
                stdout=f, stderr=subprocess.STDOUT)

    def wait(self) -> None:
        """Wait for the run (killed after 600 s); raises if it failed."""
        if self.report is not None:
            return
        try:
            rc = self.proc.wait(timeout=600)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        self.wall_s = time.perf_counter() - self._t0
        with open(self._log) as f:
            text = f.read()
        if rc != 0:
            raise AssertionError(f"(e) serve --shard-hosts 1 failed:\n"
                                 f"{text[-2000:]}")
        self.report = json.loads(text.strip().splitlines()[-1])
        self._tmp.cleanup()


def phase_2d_mesh(device, ck, p15, serve10, oneshot) -> dict:
    """Phase 17 (module docstring).  Returns its record."""
    from pivot_tpu_torch.experiments import cli

    card = card_line()
    log(f"  [{card}]")
    chk = Check()
    rec = {}
    t0 = time.perf_counter()
    rec["pod"] = p17_pod(device, p15)
    rec["ragged"] = p17_ragged(device)
    log(f"  (a): {time.perf_counter() - t0!r} s")
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        t0 = time.perf_counter()
        rec["b"] = p17_2d_serve(device, ck, cli, tmp, card, serve10)
        log(f"  (b): {time.perf_counter() - t0!r} s")
        t0 = time.perf_counter()
        rec["c"] = p17_kernel_serve(device, ck, cli, tmp, card, chk)
        log(f"  (c): {time.perf_counter() - t0!r} s")
        t0 = time.perf_counter()
        rec["d"] = p17_resident(device, ck, cli, tmp, card)
        log(f"  (d): {time.perf_counter() - t0!r} s")
    oneshot.wait()
    e = oneshot.report
    c = e["slo"]["counters"]
    if e["mesh"] != {"replica_dcn": 1, "replica": 1, "host": 1} or \
            not c["completed"] or c["completed"] + c["shed"] != c["arrived"]:
        raise AssertionError(f"(e) serve --shard-hosts 1: mesh {e['mesh']}, "
                             f"{c}")
    rec["e"] = dict(wall_s=oneshot.wall_s, mesh=e["mesh"], counters=c)
    log(f"  (e) python -m pivot_tpu_torch.experiments.cli "
        f"{' '.join(P17_ONESHOT)} (its own process, beside phase 2): ended "
        f"in {oneshot.wall_s!r} s from its start, {c['completed']} of "
        f"{c['arrived']} jobs completed, report mesh {e['mesh']}")
    launches = rec["c"]["launches"]
    rec["launches_r1"] = launches["by_replicas"].get(1, 0)
    rec["launches_rows_by_g"] = launches["rows"]
    rec["launches_rows"] = sum(launches["rows"].values())
    rec["max_abs_err"] = chk.max_abs_err
    return rec


# -- phase 18: elastic meshes -------------------------------------------------

#: (a) the mid-run reshards: (case, launch shards or None, shards after).
P18_RESHARDS = (("shrink 8->4", 8, 4), ("regrow 4->8", 4, 8),
                ("unsharded->7 (padded)", None, 7))
#: (a) ``tests/test_elastic.py::_chain_apps``' chain, this many apps (the
#: reference's 3 place at tick 0 on 600 hosts).
P18_APPS = 24
P18_RESHARD_AT = 12.0
#: (b) the soak's logical shards, failing ordinal and window.
P18_SHARDS = 8
P18_FAULT = (6.0, 3, 200.0)
P18_JOBS = 18


def p18_policy(device, arm, shards=None):
    """A float32 ``cuda`` policy of ``arm`` ("first-fit" or "cost-aware",
    the torch form: no ``greedy_place``), host-sharded over ``shards``
    logical shards of the card when given."""
    from pivot_tpu_torch.parallel.mesh import host_sharded_mesh
    from pivot_tpu_torch.sched import cuda as pc

    if arm == "first-fit":
        pol = pc.CudaFirstFitPolicy(device=device)
    else:
        pol = pc.CudaCostAwarePolicy(sort_tasks=True, sort_hosts=True,
                                     use_kernel=False, device=device)
    if shards is not None:
        pol.enable_sharding(host_sharded_mesh(
            devices=[torch.device(device)] * shards))
    return pol


class P18PadWatch:
    """Wraps a policy's ``place`` / ``place_span``: the largest host
    index any decision named."""

    def __init__(self, pol):
        self.max_index = -1
        place, span = pol.place, pol.place_span

        def placed(ctx):
            out = place(ctx)
            if len(out):
                self.max_index = max(self.max_index, int(np.max(out)))
            return out

        def spanned(ctx, plan):
            out = span(ctx, plan)
            if out is not None and out.placements.size:
                self.max_index = max(self.max_index,
                                     int(out.placements.max()))
            return out

        pol.place, pol.place_span = placed, spanned


def p18_des(device, arm, start=None, after=None, reshard=True):
    """One DES run of the chain at 600 hosts (``tests/test_elastic.py::
    _full_sim``: 4-cpu hosts over 2 zones, fused spans, resident tier),
    resharded at ``P18_RESHARD_AT`` onto ``after`` shards (None:
    unsharded) when ``reshard``.  Returns ``((placements, ends), policy,
    watch, wall_s, span_stats)``."""
    from pivot_tpu_torch.des import Environment
    from pivot_tpu_torch.infra import Cluster, Host, Storage
    from pivot_tpu_torch.infra.locality import ResourceMetadata
    from pivot_tpu_torch.infra.meter import Meter
    from pivot_tpu_torch.parallel.mesh import host_sharded_mesh
    from pivot_tpu_torch.sched import GlobalScheduler
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.workload import Application, TaskGroup

    reset_ids()
    env = Environment()
    meta = ResourceMetadata(seed=0)
    meter = Meter(env, meta)
    zones = meta.zones
    hosts = [Host(env, 4.0, 1024, 100, 1, locality=zones[i % 2],
                  meter=meter, id=f"h{i}") for i in range(600)]
    storage = [Storage(env, z)
               for z in dict.fromkeys(h.locality for h in hosts)]
    cluster = Cluster(env, hosts=hosts, storage=storage, meta=meta,
                      meter=meter, route_mode="meta", seed=0,
                      executor_backend="fast")
    pol = p18_policy(device, arm, start)
    pol.enable_resident(splice=True)
    watch = P18PadWatch(pol)
    sched = GlobalScheduler(env, cluster, pol, seed=3, meter=meter,
                            fuse_spans=True)
    cluster.start()
    sched.start()
    apps = [Application(f"app{i}", [
        TaskGroup("a", cpus=1, mem=64, runtime=17.0, output_size=400,
                  instances=10),
        TaskGroup("b", cpus=2, mem=64, runtime=9.0, dependencies=["a"],
                  instances=6),
        TaskGroup("c", cpus=1, mem=32, runtime=5.0, dependencies=["b"],
                  instances=8),
    ]) for i in range(P18_APPS)]
    t0 = time.perf_counter()
    for a in apps:
        sched.submit(a)
    if reshard:
        env.run(until=P18_RESHARD_AT)
        pol.reshard(None if after is None else host_sharded_mesh(
            devices=[torch.device(device)] * after))
    sched.stop()
    env.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    placements = sorted((t.id, t.placement)
                        for a in apps for g in a.groups for t in g.tasks)
    ends = sorted((a.id, a.end_time) for a in apps)
    return (placements, ends), pol, watch, wall, dict(sched.span_stats)


def p18_reshard(device) -> dict:
    """(a): every reshard of ``P18_RESHARDS`` for both arms, against the
    unsharded run of the arm on the card."""
    rec = {}
    for arm in ("first-fit", "cost-aware"):
        want, _pol, _w, ref_s, ref_spans = p18_des(device, arm,
                                                    reshard=False)
        if any(h is None for _id, h in want[0]):
            raise AssertionError(f"(a) {arm}: the unsharded run left "
                                 "tasks unplaced")
        for case, start, after in P18_RESHARDS:
            got, pol, watch, wall, spans = p18_des(device, arm, start, after)
            if got != want:
                bad = [x for x, y in zip(got[0], want[0]) if x != y][:3]
                raise AssertionError(f"(a) {arm} {case}: placements or end "
                                     f"times differ from the unsharded run "
                                     f"(first {bad}; ends {got[1][:2]} vs "
                                     f"{want[1][:2]})")
            extent = pol._host_extent or 600
            if watch.max_index >= 600 or (after == 7) != (extent == 602):
                raise AssertionError(f"(a) {arm} {case}: a placement named "
                                     f"host {watch.max_index} (extent "
                                     f"{extent})")
            rs = pol.dispatch_stats()["resident"]
            rec[f"{arm} {case}"] = dict(wall_s=wall, extent=extent,
                                        spans=spans, resident=rs,
                                        max_index=watch.max_index)
            log(f"  (a) {arm} {case} at t={P18_RESHARD_AT}: placements and "
                f"end times = the unsharded run's ({len(got[0])} tasks, "
                f"{spans['fused_spans']} fused spans, {rs['spans']} on the "
                f"carry, host extent {extent}, largest index named "
                f"{watch.max_index}); wall {wall!r} s (unsharded "
                f"{ref_s!r} s)")
    return rec


class P18Timer:
    """The soak's recovery latency, wall clock from the first
    ``DeviceLostError`` the gate raises: to the first dispatch the
    shrunk mesh's gate lets through (``ms``, the reference bench's
    ``recovery_latency_ms``, ``bench.py:2815-2842``), and to the end of
    that dispatch (``served_ms``; the policies' ``place`` / ``place_span``
    wrapped as the factory builds them)."""

    def __init__(self, mgr):
        self.mgr = mgr
        self.raised_at = self.resumed_at = self.served_at = None
        gate_for = mgr._gate_for

        def timed_gate_for(policy):
            gate = gate_for(policy)

            def timed(now):
                from pivot_tpu_torch.infra.faults import DeviceLostError

                try:
                    gate(now)
                except DeviceLostError:
                    if self.raised_at is None:
                        self.raised_at = time.perf_counter()
                    raise
                if (self.raised_at is not None and self.resumed_at is None
                        and self._shrunk(policy)):
                    self.resumed_at = time.perf_counter()

            return timed

        mgr._gate_for = timed_gate_for

    def _shrunk(self, pol) -> bool:
        return len(self.mgr._mesh_key(pol._mesh)) < len(self.mgr.devices)

    def wrap(self, pol) -> None:
        for name in ("place", "place_span"):
            fn = getattr(pol, name)

            def served(*a, _fn=fn):
                out = _fn(*a)
                if (self.resumed_at is not None and self.served_at is None
                        and self._shrunk(pol)):
                    self.served_at = time.perf_counter()
                return out

            setattr(pol, name, served)

    def _since_raise(self, t):
        return None if t is None else (t - self.raised_at) * 1e3

    @property
    def ms(self):
        return self._since_raise(self.resumed_at)

    @property
    def served_ms(self):
        return self._since_raise(self.served_at)


def p18_soak(device, elastic, sharded=True, timer=None, chaos=True,
             market=True):
    """``tests/test_elastic.py::_elastic_soak`` on the card at 600 hosts
    a session: Cost-Aware sessions (the torch form), sharded over
    ``P18_SHARDS`` logical shards when ``sharded``.  Returns
    ``(placements, driver, report)``."""
    from pivot_tpu_torch import serve as ps
    from pivot_tpu_torch.infra.faults import FaultInjector
    from pivot_tpu_torch.infra.market import MarketSchedule
    from pivot_tpu_torch.utils import reset_ids
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster
    from pivot_tpu_torch.workload import Application, TaskGroup

    reset_ids()
    arrs = list(ps.mixed_tier_arrivals(
        rate=20.0, n_jobs=P18_JOBS, weights=(0.5, 0.3, 0.2), seed=7,
        make_app=ps.synthetic_app_factory(seed=11)))
    arrs.append(ps.JobArrival(ts=10_000.0, app=Application("straggler", [
        TaskGroup("s", cpus=1, mem=32, runtime=2.0, instances=1)]), tier=0))

    def factory(label):
        pol = p18_policy(device, "cost-aware",
                         P18_SHARDS if sharded else None)
        if timer is not None:
            timer.wrap(pol)
        s = ps.ServeSession(label, build_cluster(ClusterConfig(
            n_hosts=600, seed=0)), pol, seed=0, fuse_spans="slo")
        if chaos:
            FaultInjector(s.cluster, seed=0).preempt_host(
                s.cluster.hosts[2].id, at=8.0, lead=6.0, outage=25.0)
        if market:
            s.scheduler.market = MarketSchedule.generate(
                s.cluster.meta, seed=5, horizon=400.0, n_segments=4,
                hot_fraction=0.3, hot_hazard=1e-2, base_hazard=1e-4)
        return s

    driver = ps.ServeDriver(
        [factory("s0")], queue_depth=64, backpressure="shed",
        flush_after=0.02, resident=True, splice_tier=2,
        session_factory=factory, max_restarts=4, elastic=elastic)
    t0 = time.perf_counter()
    report = driver.run(iter(arrs))
    torch.cuda.synchronize()
    # The CLI's serve metrics (``cli.run_serve_stream``), unrounded.
    report["wall_s"] = time.perf_counter() - t0
    report["decisions_per_sec"] = (report["slo"]["counters"]["decisions"]
                                   / report["wall_s"])
    placements = sorted((t.id, t.placement) for a in (x.app for x in arrs)
                        for g in a.groups for t in g.tasks)
    return placements, driver, report


def p18_tiers(report) -> dict:
    return {t: dict(p50_ms=v["decision_latency_s"]["p50"] * 1e3,
                    p99_ms=v["decision_latency_s"]["p99"] * 1e3)
            for t, v in report["slo"]["tiers"].items()}


def p18_serve(device, card) -> dict:
    """(b): the kill arm with the reference's assertions, then the
    healthy arm against ``elastic=None`` on unsharded sessions."""
    from pivot_tpu_torch import serve as ps
    from pivot_tpu_torch.infra.audit import audit_serve
    from pivot_tpu_torch.infra.faults import ChaosEvent, ChaosSchedule
    from pivot_tpu_torch.utils.compile_counter import count_compiles

    at, ordinal, duration = P18_FAULT
    mgr = ps.ElasticMeshManager(ps.ElasticConfig(schedule=ChaosSchedule(
        seed=13, events=[ChaosEvent(kind="device_fault", at=at,
                                    target=f"device:{ordinal}",
                                    duration=duration)])))
    timer = P18Timer(mgr)
    from pivot_tpu_torch.sched import cuda as pc

    folds, fold = [], pc.elastic_fold_carry

    def counted_fold(carry, H, mesh):
        folds.append(carry.avail.shape[0])
        return fold(carry, H, mesh)

    pc.elastic_fold_carry = counted_fold
    try:
        _pl, driver, report = p18_soak(device, mgr, timer=timer)
    finally:
        pc.elastic_fold_carry = fold
    c = report["slo"]["counters"]
    kinds = [k for _, k, _ in mgr.events]
    problems = [
        c["arrived"] != P18_JOBS + 1, c["completed"] != P18_JOBS + 1,
        c.get("failed_jobs", 0) != 0, c.get("device_losses", 0) < 1,
        c.get("session_restarts", 0) < 1, audit_serve(driver) != [],
        mgr.shrinks < 1, mgr.regrows < 1, mgr.probes < 1,
        mgr.probe_failures != 0, not kinds or kinds[0] != "loss"
        or kinds[-1] != "regrow",
        any(k == "loss" and o != (ordinal,) for _, k, o in mgr.events),
        timer.ms is None, timer.served_ms is None, not folds,
    ]
    if any(problems):
        raise AssertionError(f"(b) kill arm: checks {problems}; counters "
                             f"{c}; events {mgr.events}")
    kill = dict(wall_s=report["wall_s"],
                decisions_per_sec=report["decisions_per_sec"],
                tiers=p18_tiers(report), recovery_ms=timer.ms,
                recovery_served_ms=timer.served_ms,
                counters={k: c.get(k, 0) for k in (
                    "arrived", "completed", "device_losses",
                    "session_restarts", "requeued", "decisions")},
                events=mgr.events, describe=mgr.describe(),
                carries_folded=len(folds))
    log(f"  [{card}]")
    log(f"  (b) kill arm, shard {ordinal} down [{at:g}, {at + duration:g}) "
        f"over {P18_SHARDS} logical shards: {c['completed']} of "
        f"{c['arrived']} jobs completed, 0 failed, "
        f"{c.get('device_losses', 0)} device losses, "
        f"{c.get('session_restarts', 0)} restarts, audit_serve clean, "
        f"{len(folds)} pending resident carries folded by the regrow; "
        f"events {[(t, k, o) for t, k, o in mgr.events]}")
    log(f"    {report['decisions_per_sec']!r} decisions/s, wall "
        f"{report['wall_s']!r} s; per tier "
        + ", ".join(f"{t}: p50 {v['p50_ms']!r} p99 {v['p99_ms']!r} ms"
                    for t, v in kill["tiers"].items()))
    log(f"    recovery: {timer.ms!r} ms of wall clock from the "
        f"DeviceLostError to the first dispatch the shrunk mesh serves (its"
        f" gate passed), {timer.served_ms!r} ms to that dispatch's end")
    for line in mgr.describe().splitlines():
        log(f"    describe: {line}")
    want, _drv, rep_none = p18_soak(device, None, sharded=False,
                                    chaos=False, market=False)
    gated = ps.ElasticMeshManager()
    with count_compiles() as counter:
        got, drv_g, rep_g = p18_soak(device, gated, chaos=False,
                                     market=False)
    if got != want or counter.kernel_builds or counter.graph_captures or (
            gated.events or rep_g["slo"]["counters"]["completed"]
            != P18_JOBS + 1):
        raise AssertionError(
            f"(b) healthy arm: placements equal {got == want}, "
            f"{counter.kernel_builds} builds, {counter.graph_captures} "
            f"captures, events {gated.events}, counters "
            f"{rep_g['slo']['counters']}")
    healthy = dict(decisions_per_sec=rep_g["decisions_per_sec"],
                   tiers=p18_tiers(rep_g),
                   none_decisions_per_sec=rep_none["decisions_per_sec"],
                   none_tiers=p18_tiers(rep_none), kernel_builds=0,
                   graph_captures=0, tasks=len(got))
    log(f"  (b) healthy arm (empty plan, sharded): placements = elastic=None"
        f" on unsharded sessions ({len(got)} tasks); 0 kernel builds, 0 "
        f"graph captures once warm; {rep_g['decisions_per_sec']!r} "
        f"decisions/s (elastic=None unsharded "
        f"{rep_none['decisions_per_sec']!r}); per tier "
        + ", ".join(f"{t}: p50 {v['p50_ms']!r} p99 {v['p99_ms']!r} ms"
                    for t, v in healthy["tiers"].items()))
    return dict(kill=kill, healthy=healthy)


def p18_probe(device) -> dict:
    """(c): the real shadow probe at 600 hosts on every rung of the
    8-shard ladder; a candidate whose run raises fails it, and the
    manager holds the shard out until a later probe passes."""
    from pivot_tpu_torch import serve as ps
    from pivot_tpu_torch.infra.faults import (
        ChaosEvent,
        ChaosSchedule,
        DeviceLostError,
    )
    from pivot_tpu_torch.ops import shard as sh
    from pivot_tpu_torch.parallel.mesh import host_sharded_mesh
    from pivot_tpu_torch.sched import GlobalScheduler
    from pivot_tpu_torch.utils.config import ClusterConfig, build_cluster

    def bound():
        pol = p18_policy(device, "cost-aware", P18_SHARDS)
        cluster = build_cluster(ClusterConfig(n_hosts=600, seed=0))
        pol.bind(GlobalScheduler(cluster.env, cluster, pol, seed=0))
        return pol

    mgr = ps.ElasticMeshManager(ps.ElasticConfig(
        schedule=ChaosSchedule(seed=1, events=[ChaosEvent(
            kind="device_fault", at=5.0, target="device:3",
            duration=10.0)]), probe_every=2))
    first = bound()
    mgr.attach(first)
    rungs = {}
    for S in mgr.ladder:
        t0 = time.perf_counter()
        ok = mgr.shadow_probe(first, host_sharded_mesh(
            devices=[torch.device(device)] * S))
        rungs[S] = dict(ok=ok, ms=(time.perf_counter() - t0) * 1e3)
        if ok is not True:
            raise AssertionError(f"(c) the probe failed on the {S}-shard "
                                 "rung")
    try:
        first._fault_gate(6.0)
    except DeviceLostError:
        pass
    else:
        raise AssertionError("(c) the gate did not raise in the window")
    second = bound()
    mgr.attach(second)
    real = sh.sharded_fused_tick_run

    def sick(*a, **k):
        raise RuntimeError("the candidate shard raised")

    sh.sharded_fused_tick_run = sick
    try:
        second._fault_gate(20.0)
    finally:
        sh.sharded_fused_tick_run = real
    held = mgr._mesh_key(second._mesh)
    if (mgr.probe_failures, mgr.regrows, held) != (1, 0, (0, 1, 2, 4)):
        raise AssertionError(f"(c) a raising probe did not hold the shard "
                             f"out: {mgr.events}, mesh {held}")
    for t in (20.5, 21.0, 21.5):
        second._fault_gate(t)
    if mgr.regrows != 1 or mgr._mesh_key(second._mesh) != tuple(range(8)):
        raise AssertionError(f"(c) no regrow after the cooldown: "
                             f"{mgr.events}")
    log(f"  (c) shadow probe at 600 hosts: True on rungs "
        + ", ".join(f"{S} ({v['ms']!r} ms)" for S, v in rungs.items())
        + f"; a raising candidate failed it and the manager held shard 3 "
        f"out on {held}, then regrew after the cooldown; events "
        f"{[k for _, k, _ in mgr.events]}")
    return dict(rungs=rungs, events=mgr.events)


def phase_elastic(device, ck) -> dict:
    """Phase 18 (module docstring).  Returns its record."""
    card = card_line()
    log(f"  [{card}]")
    rec = {}
    ck.reset_launches()  # the path's count starts here
    for key, fn in (("a", lambda: p18_reshard(device)),
                    ("b", lambda: p18_serve(device, card)),
                    ("c", lambda: p18_probe(device))):
        t0 = time.perf_counter()
        rec[key] = fn()
        rec[f"{key}_wall_s"] = time.perf_counter() - t0
        log(f"  ({key}): {rec[f'{key}_wall_s']!r} s")
    rec["launches"] = ck.LAUNCHES["greedy_place"]
    if rec["launches"]:
        raise AssertionError(f"phase 18: {rec['launches']} greedy_place "
                             "launches on a path of sharded torch passes")
    log("  0 greedy_place launches on the phase's path")
    return rec


# -- phase 19: the carry-free kernel -----------------------------------------

#: Phase 19's shapes: the CLI default cluster's 600 hosts at task counts of
#: the main path's ticks (1, 12, 379: ``overall``'s largest) and the
#: synthetic 619 and 2048; the R = 256 forms at T = 619; phase 15's pod
#: tick (``bench.py``'s ``_SHARD_H0`` x ``_SHARD_T``).
P19_H = 600
P19_TS = (1, 12, 379, 619, 2048)
P19_R_T = 619
P19_POD = (98304, 256)
#: The cases the kernel has code of its own for, at H = 600 and these
#: task counts: NaN, ±inf and ±0.0 risk, exact ties, zero demand.
P19_EDGE_TS = (12, 619)
P19_EDGE_CASES = ("nan_risk", "ties", "zero")
#: Hosts and warps a CTA (the single-CTA cluster form, C = 1) where a
#: thread owns more rows (132) than its member bits cover (``kMaskHosts``
#: = 32), so the opportunistic rank walks its rows.
P19_WIDE = (4200, 1)
#: The register builds, each at its capacity with its most warps, and
#: the default shapes on each side of the arms' K switches and of the
#: register form's end, at a short stream.
P19_K_T = 64
P19_K_HS = (1536, 1537, 2048, 2049, 4096, 4097)
#: The cluster sizes the default rule does not pick (forced at H =
#: 4,097) and the host count where it first picks C = 16.
P19_C_FORCED = (1, 2, 4)
P19_C16_H = 8193
#: ``cta_edge`` inputs: H = 8,192 (C = 8, 1,024 hosts a CTA) and the pod
#: tick (C = 16, 6,144 a CTA), at the pod's T.
P19_EDGE_HS = (8192, P19_POD[0])
#: The global-rows form, once: one host past the cluster form's capacity.
P19_TAIL_T = 12
#: Launch shapes the ``--cf-sweep`` sweeps time (each held against the
#: plain form): every register build at T = 619, H = 600 for R = 1, and
#: K by groups a block for the R-replica arms at R = 256; the cluster
#: form's warps a CTA at the pod tick (C = 8 and 16) and C by W at H =
#: 4,097 and 20,000, T = 256.  They set ``ops/cuda_kernels.py``'s
#: ``_CF_REG_K``, ``_CF_REG_K_REPLICAS``, ``_CF_GROUPS_REPLICAS``,
#: ``_CF_CTA_HOSTS`` and ``_CF_ROWS_WARPS`` (PERF.md §6) and run only
#: when asked.
P19_SWEEP_G = (1, 2, 4)
P19_SWEEP_POD = ((8, 8), (8, 16), (16, 8), (16, 12), (16, 16))
P19_SWEEP_MID = ((4097, (4, 8, 16), (4, 8, 16)),
                 (20000, (4, 8, 16), (4, 8, 16)))
#: Timed launches a measurement (CUDA events); the plain form's pace is
#: its host loop, so it takes fewer.
P19_REPS = 20
P19_PLAIN_REPS = 1


def p19_inputs(seed, T, H, device, R=None, risk=False, live=False,
               case="dense", cta=None):
    """Seeded f32 operands of one carry-free tick, dense (most tasks place
    until the hosts fill); ``case`` "nofit" puts every third task out of
    reach, "invalid" drops ~30 % of the tasks and the last two,
    "nan_risk" draws risk from {0, −0, 0.25, ±inf, NaN}, "ties" gives
    every host and task the same rows (and risk from {0, −0}), "zero"
    zero demand on hosts half of them empty, "cta_edge" (with ``cta``,
    the hosts a CTA of the cluster form) fills only hosts cta − 1 and cta
    — the last of one CTA and the first of the next, one row — and the
    last CTA's hosts, with a flat risk row and uniforms in [0.5, 1), so
    that argmins tie across two CTAs and the opportunistic rank lands in
    the last CTA.  ``R`` gives ``[R, H, 4]`` replicas."""
    rng = np.random.default_rng(seed)
    avail = rng.uniform(0, 16, size=(H, 4) if R is None else (R, H, 4))
    dem = np.stack([rng.choice([0.0, 0.5, 1.0, 2.0], size=T),
                    rng.uniform(0, 4, size=T), rng.uniform(0, 2, size=T),
                    np.zeros(T)], axis=1)
    valid = np.ones(T, bool)
    r = rng.choice([0.0, 0.25, 1.0], size=H) if risk else None
    if case == "nofit":
        dem[::3, 1] = 1e6
    elif case == "invalid":
        valid = rng.random(T) > 0.3
        valid[-2:] = False
    elif case == "nan_risk":
        r = rng.choice([0.0, -0.0, 0.25, np.inf, -np.inf, np.nan], size=H,
                       p=[0.3, 0.2, 0.3, 0.08, 0.04, 0.08])
    elif case == "ties":
        avail[...] = 8.0
        dem[:] = (1.0, 1.0, 0.5, 0.0)
        if risk:
            r = rng.choice([0.0, -0.0], size=H)
    elif case == "zero":
        dem[:] = 0.0
        avail[..., ::2, :] = 0.0
    u = rng.uniform(size=T)
    if case == "cta_edge":
        avail[...] = 0.25
        avail[..., 1] = 0.0  # a filler host fits no task (lane 1 > 0)
        avail[..., cta - 1:cta + 1, :] = 16.0
        avail[..., (H - 1) // cta * cta:, :] = 16.0
        u = rng.uniform(0.5, 1.0, size=T)
        if risk:
            r = np.full(H, 0.25)
    x = dict(avail=avail.astype(np.float32), dem=dem.astype(np.float32),
             valid=valid, u=u.astype(np.float32),
             risk=None if r is None else r.astype(np.float32),
             live=rng.random(H) > 0.2 if live else None)
    return {k: None if v is None else torch.from_numpy(v).to(device)
            for k, v in x.items()}


def p19_call(ck, arm, x, form="cuda"):
    """One pass of ``arm`` on ``x``: the wrapper (``form="cuda"``) or the
    plain form (``"plain"``); ``[R, H, 4]`` operands take the R-replica
    forms (no live mask)."""
    a, d, v = x["avail"], x["dem"], x["valid"]
    stem = arm.replace("-", "_")
    if a.dim() == 3:
        return getattr(ck, f"{stem}_{form}_batched")(a, d, v, risk=x["risk"])
    kw = dict(live=x["live"], risk=x["risk"])
    if arm == "opportunistic":
        return getattr(ck, f"opportunistic_{form}")(a, d, v, x["u"], **kw)
    return getattr(ck, f"{stem}_{form}")(a, d, v, **kw)


def cf_bare_launch(ck, arm, x, cfg=None):
    """The kernel alone: ``_cf_check`` once, outputs allocated once, then a
    function that runs ``_cf_launch`` (the wrappers' one launch site) in
    the default shape or in ``cfg`` (a ``_CfConfig``)."""
    batched = x["avail"].dim() == 3
    a = x["avail"] if batched else x["avail"][None]
    live = None if batched else x["live"]
    u = x["u"] if arm == "opportunistic" else None
    R, T, H, nb = ck._cf_check(arm, a, x["dem"], x["valid"], u, live,
                               x["risk"], None)
    if cfg is None:
        cfg = ck._cf_config(H, arm, R)
    placements = torch.empty((R, T), dtype=torch.int32, device=a.device)
    out = torch.empty_like(a)

    def go():
        ck._cf_launch(cfg, arm, a, x["dem"], x["valid"], u, False, live,
                      x["risk"], nb, placements, out)
        return placements, out
    return go, cfg


def cf_shape(ck, H, form, warps, groups=1, cluster=1):
    """A ``_CfConfig`` of the given form, W, G and C (its shared memory
    from the wrapper's sizer)."""
    return ck._CfConfig(form, warps, groups, cluster,
                        ck._cf_smem_bytes(H, form, warps, groups, cluster))


def cf_shape_name(cfg) -> str:
    return (f"{cfg.state}"
            + (f" K={cfg.form}" if cfg.form > 0 else "")
            + f" W={cfg.warps} G={cfg.groups} C={cfg.cluster}")


def cf_fit_counts(x, placements):
    """Best-Fit's strict fits at each task's step, ``[R, T]`` int64 (0 at
    an invalid task): the pass replayed from its placements (the plain
    form's), live-masked hosts reading −1 as in the kernel."""
    a = x["avail"] if x["avail"].dim() == 3 else x["avail"][None]
    R, T = a.shape[0], x["dem"].shape[0]
    if x["avail"].dim() == 2 and x["live"] is not None:
        a = torch.where(x["live"][None, :, None], a, a.new_full((), -1.0))
    a = a.clone()
    p = placements.reshape(R, T).long()
    rows = torch.arange(R, device=a.device)
    counts = torch.zeros((R, T), dtype=torch.int64, device=a.device)
    for j in torch.nonzero(x["valid"]).flatten().tolist():
        d = x["dem"][j]
        counts[:, j] = (a > d).all(-1).sum(-1)
        ok = p[:, j] >= 0
        a[rows, p[:, j].clamp(min=0)] -= torch.where(ok[:, None], d,
                                                     torch.zeros_like(d))
    return counts


def cf_bound(arm, x, placements):
    """Least time for one pass at these inputs: the larger of the bytes
    over HBM bandwidth and the operations over the f32 peak.  Bytes:
    availability ``[R, H, 4]`` read and written once, the task stream up
    to the last valid task (demands, valid, uniforms for opportunistic),
    risk / live when given, placements ``[R, T]`` written.  Operations
    (per replica and valid task) are what this run's data needs, read
    from ``placements`` (the plain form's): a fit test of 8 (4 compares,
    3 ANDs, the selection) on each host it must see — every host for
    opportunistic (its count) plus 2 a host with risk (the tier's
    minimum and compare) and 3 for the rank; for first-fit the hosts up
    to the first that fits (all when none does, and all plus 1 a host
    with risk, whose argmin sees every fit); for best-fit every host
    plus 12 (4 subtractions, 4 squares, 3 adds, the root), +1 with
    risk, on each host that fits (:func:`cf_fit_counts`); and 4 (the
    decrement) for each placement.  Returns ``(ms, "bytes" or
    "operations", steps walked)``."""
    a, v = x["avail"], x["valid"]
    R = a.shape[0] if a.dim() == 3 else 1
    H, T = a.shape[-2], v.shape[0]
    risk = x["risk"] is not None
    live = a.dim() == 2 and x["live"] is not None
    idx = torch.nonzero(v).flatten()
    n_eff = int(idx[-1]) + 1 if idx.numel() else 0
    tasks = R * int(v.sum())
    p = placements.reshape(R, T)[:, v].long()
    placed = int((p >= 0).sum())
    nbytes = (2 * R * H * 16 + n_eff * (16 + 1 + 4 * (arm == "opportunistic"))
              + R * T * 4 + H * 4 * risk + H * live)
    if arm == "opportunistic":
        ops = tasks * (H * (8 + 2 * risk) + 3)
    elif arm == "first-fit" and risk:
        ops = tasks * H * 9
    elif arm == "first-fit":
        ops = 8 * int(torch.where(p >= 0, p + 1, H).sum())
    else:
        fits = int(cf_fit_counts(x, placements).sum())
        ops = tasks * H * 8 + (12 + risk) * fits
    ops += 4 * placed
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_eff)


def p19_time(ck, arm, x, reps=P19_REPS, plain_reps=P19_PLAIN_REPS) -> dict:
    """``kernel_ms`` (the bare launch) and the wrapper's ms by CUDA events,
    the plain form's ms by host clock around a synchronised call, the
    bound from the plain form's placements, and ns per step
    (``kernel_ms`` over the steps walked)."""
    go, cfg = cf_bare_launch(ck, arm, x)
    kernel_ms = _events_ms(go, reps)
    ms = _events_ms(lambda: p19_call(ck, arm, x), reps)
    plain_ms = _host_ms(lambda: p19_call(ck, arm, x, "plain"), plain_reps)
    b_ms, b_by, n_eff = cf_bound(arm, x, p19_call(ck, arm, x, "plain")[0])
    return dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, n_eff=n_eff,
                ns_per_step=kernel_ms * 1e6 / max(n_eff, 1),
                shape=cf_shape_name(cfg))


def p19_log(key, t) -> None:
    log(f"  {key}: wrapper {t['ms']!r} ms, kernel_ms {t['kernel_ms']!r}, "
        f"{t['ns_per_step']!r} ns per step ({t['n_eff']} steps, "
        f"{t['shape']}), plain "
        f"{t['plain_ms']!r} ms, bound {t['bound_ms']!r} ms "
        f"({t['bound_by']})")


def p19_sweep_row(ck, arm, x, shapes, key, chk) -> dict:
    """Kernel ms of ``arm`` on ``x`` in each launch shape, each launch
    held against the plain form first; logs one line."""
    want = p19_call(ck, arm, x, "plain")
    row = {}
    for cfg in shapes:
        go, _cfg = cf_bare_launch(ck, arm, x, cfg)
        p, a = go()
        if x["avail"].dim() == 2:
            p, a = p[0], a[0]
        chk.same((p, a), want, (key, "sweep", cfg))
        row[cf_shape_name(cfg)] = _events_ms(go, P19_REPS)
    H = x["avail"].shape[-2]
    R = x["avail"].shape[0] if x["avail"].dim() == 3 else 1
    log(f"  sweep {key} (default {cf_shape_name(ck._cf_config(H, arm, R))}"
        "): " + ", ".join(f"{n} {ms!r} ms" for n, ms in row.items()))
    return row


def p19_sweep(ck, device, chk, pod) -> dict:
    """``--cf-sweep``: kernel ms by launch shape (``P19_SWEEP_*``)."""
    sweep = {}
    x = p19_inputs(200 + P19_R_T, P19_R_T, P19_H, device)
    for arm in CF_ARMS:
        sweep[f"{arm} T={P19_R_T} H={P19_H}"] = p19_sweep_row(
            ck, arm, x, [cf_shape(ck, P19_H, K, -(-P19_H // (32 * K)))
                         for K in ck._CF_REG_THREADS],
            f"{arm} T={P19_R_T} H={P19_H}", chk)
    xr = p19_inputs(300, P19_R_T, P19_H, device, R=SENS_REPLICAS)
    for arm in CF_ARMS[1:]:
        shapes = []
        for K, limit in ck._CF_REG_THREADS.items():
            W = -(-P19_H // (32 * K))
            shapes += [cf_shape(ck, P19_H, K, W, G) for G in P19_SWEEP_G
                       if 32 * W * G <= limit]
        key = f"{arm} R={SENS_REPLICAS} T={P19_R_T} H={P19_H}"
        sweep[key] = p19_sweep_row(ck, arm, xr, shapes, key, chk)
    for arm in CF_ARMS:
        key = f"{arm} T={P19_POD[1]} H={P19_POD[0]}"
        sweep[key] = p19_sweep_row(
            ck, arm, pod, [cf_shape(ck, P19_POD[0], ck._CF_ROWS_SHARED, W,
                                    1, C) for C, W in P19_SWEEP_POD],
            key, chk)
    for H, cs_, ws in P19_SWEEP_MID:
        xm = p19_inputs(H, P19_POD[1], H, device)
        for arm in CF_ARMS:
            key = f"{arm} T={P19_POD[1]} H={H}"
            sweep[key] = p19_sweep_row(
                ck, arm, xm, [cf_shape(ck, H, ck._CF_ROWS_SHARED, W, 1, C)
                              for C in cs_ for W in ws], key, chk)
    return sweep


def p19_new_cases(ck, device, chk) -> None:
    """Phase 19's cases of the launch shapes: every register build at its
    capacity, the default shapes across the K switches and the register
    form's end, the cluster sizes the rule does not pick, C = 16 where
    it first does, ties across two CTAs and an opportunistic rank in the
    last CTA, and the global-rows form once."""
    def hold(arm, x, cfg, what, floor):
        go, _cfg = cf_bare_launch(ck, arm, x, cfg)
        p, a = go()
        chk.same((p[0], a[0]), p19_call(ck, arm, x, "plain"), what,
                 min_placed=floor)
    floor = P19_K_T // 4
    for K, limit in ck._CF_REG_THREADS.items():
        H = K * limit
        for risk in (False, True):
            x = p19_inputs(500 + K + risk, P19_K_T, H, device, risk=risk,
                           live=risk)
            for arm in CF_ARMS:
                cfg = cf_shape(ck, H, K, limit // 32)
                hold(arm, x, cfg, (arm, cf_shape_name(cfg), H, risk), floor)
    for H in P19_K_HS:
        x = p19_inputs(H, P19_K_T, H, device)
        for arm in CF_ARMS:
            chk.same(p19_call(ck, arm, x), p19_call(ck, arm, x, "plain"),
                     (arm, "default", H), min_placed=floor)
    x = p19_inputs(41, P19_K_T, P19_K_HS[-1], device, risk=True, live=True)
    for C in P19_C_FORCED:
        cfg = ck._cf_rows_config(P19_K_HS[-1], C)
        for arm in CF_ARMS:
            hold(arm, x, cfg, (arm, cf_shape_name(cfg)), floor)
    x = p19_inputs(42, P19_K_T, P19_C16_H, device, risk=True, live=True)
    for arm in CF_ARMS:
        chk.same(p19_call(ck, arm, x), p19_call(ck, arm, x, "plain"),
                 (arm, "default", P19_C16_H), min_placed=floor)
    for H in P19_EDGE_HS:
        cfg = ck._cf_config(H, "first-fit")
        cta = -(-H // cfg.cluster)
        for risk in (False, True):
            x = p19_inputs(43 + risk, P19_POD[1], H, device, risk=risk,
                           case="cta_edge", cta=cta)
            for arm in CF_ARMS:
                got = p19_call(ck, arm, x)
                chk.same(got, p19_call(ck, arm, x, "plain"),
                         (arm, "cta_edge", H, risk),
                         min_placed=P19_POD[1] // 4)
                p = got[0][x["valid"]]
                if arm != "opportunistic" and int(p[0]) != cta - 1:
                    raise AssertionError(f"{arm} cta_edge H={H}: the first "
                                         f"task went to {int(p[0])}, not "
                                         f"the tie's lower host {cta - 1}")
                if arm == "opportunistic" and not bool(
                        (p >= (H - 1) // cta * cta).any()):
                    raise AssertionError(f"opportunistic cta_edge H={H}: no "
                                         "rank landed in the last CTA")
    H = ck._CF_CLUSTER_MAX_HOSTS + 1
    x = p19_inputs(45, P19_TAIL_T, H, device, risk=True, live=True)
    for arm in CF_ARMS:
        if ck._cf_config(H, arm).state != "global":
            raise AssertionError(f"H={H}: not the global-rows form")
        chk.same(p19_call(ck, arm, x), p19_call(ck, arm, x, "plain"),
                 (arm, "global rows", H), min_placed=P19_TAIL_T // 4)


def phase_carry_free(device, ck, e2e=None, sweep=False) -> dict:
    """Phase 19 (module docstring).  Returns its record."""
    card = card_line()
    log(f"  [{card}]")
    chk = Check()
    ck.reset_launches()  # the phase's own launches: comparisons and times
    seed = 0
    for T in P19_TS:
        for case, extras in (("dense", ((False, False), (True, False),
                                        (False, True), (True, True))),
                             ("nofit", ((False, False), (True, True))),
                             ("invalid", ((False, False), (True, True)))):
            for risk, live in extras:
                seed += 1
                x = p19_inputs(seed, T, P19_H, device, risk=risk, live=live,
                               case=case)
                floor = (int(x["valid"].sum()) // 4
                         if case == "dense" and T > 1 else 0)
                for arm in CF_ARMS:
                    chk.same(p19_call(ck, arm, x),
                             p19_call(ck, arm, x, "plain"),
                             (arm, T, case, risk, live), min_placed=floor)
    n_small = chk.cases
    for T in P19_EDGE_TS:
        for case in P19_EDGE_CASES:
            for risk, live in ((False, False), (True, True)):
                seed += 1
                x = p19_inputs(seed, T, P19_H, device, risk=risk, live=live,
                               case=case)
                floor = T if case in ("ties", "zero") else 0
                for arm in CF_ARMS:
                    chk.same(p19_call(ck, arm, x),
                             p19_call(ck, arm, x, "plain"),
                             (arm, T, case, risk, live), min_placed=floor)
    n_edge = chk.cases - n_small
    wide = cf_shape(ck, P19_WIDE[0], ck._CF_ROWS_SHARED, P19_WIDE[1])
    for risk in (False, True):
        x = p19_inputs(95 + risk, P19_R_T, P19_WIDE[0], device, risk=risk,
                       live=risk)
        for arm in CF_ARMS:
            go, _cfg = cf_bare_launch(ck, arm, x, wide)
            p, a = go()
            chk.same((p[0], a[0]), p19_call(ck, arm, x, "plain"),
                     (arm, "wide", risk), min_placed=P19_R_T // 4)
    for arm in CF_ARMS[1:]:
        for risk in (False, True):
            x = p19_inputs(91 + risk, P19_R_T, P19_H, device, R=SENS_REPLICAS,
                           risk=risk)
            chk.same(p19_call(ck, arm, x), p19_call(ck, arm, x, "plain"),
                     (arm, f"R={SENS_REPLICAS}", risk),
                     min_placed=SENS_REPLICAS * P19_R_T // 4)
    pods = {}
    for key, risk, live in (("pod", False, False), ("pod risk", True, False),
                            ("pod risk live", True, True)):
        pod = p19_inputs(7, P19_POD[1], P19_POD[0], device, risk=risk,
                         live=live)
        pod["avail"][: P19_POD[0] // 2] *= 0.25  # low-index hosts fuller
        pods[key] = pod
        for arm in CF_ARMS:
            chk.same(p19_call(ck, arm, pod), p19_call(ck, arm, pod, "plain"),
                     (arm, key), min_placed=P19_POD[1] // 4)
    n_old = chk.cases
    p19_new_cases(ck, device, chk)
    log(f"  {chk.cases} cases ({n_small} at H={P19_H}, {n_edge} of NaN / "
        f"inf / ±0 risk, ties and zero demand at H={P19_H}, 6 at H="
        f"{P19_WIDE[0]} with {P19_WIDE[1]} warp (a thread past its "
        f"member bits), 4 at R={SENS_REPLICAS}, 9 at H={P19_POD[0]} with "
        f"and without risk and live; {chk.cases - n_old} of the launch "
        f"shapes: each register build at its capacity, the default shapes "
        f"at H={'/'.join(map(str, P19_K_HS))} and {P19_C16_H}, C="
        f"{'/'.join(map(str, P19_C_FORCED))} forced, ties across CTAs and "
        f"a rank in the last CTA at H={'/'.join(map(str, P19_EDGE_HS))}, "
        f"the global rows at H={ck._CF_CLUSTER_MAX_HOSTS + 1}), "
        f"{chk.placed} placements: all equal, max |avail diff| "
        f"{chk.max_abs_err!r} (0.0 expected; rtol {RTOL}, atol {ATOL})")
    compare = ck.LAUNCHES["carry_free_place"]
    timed = {}  # key: (arm, inputs), the shapes timed
    for T in (P19_R_T, 2048):
        x = p19_inputs(200 + T, T, P19_H, device)
        for arm in CF_ARMS:
            timed[f"{arm} T={T} H={P19_H}"] = (arm, x)
    for arm in CF_ARMS[1:]:
        x = p19_inputs(300, P19_R_T, P19_H, device, R=SENS_REPLICAS)
        timed[f"{arm} R={SENS_REPLICAS} T={P19_R_T} H={P19_H}"] = (arm, x)
    for arm in CF_ARMS:
        timed[f"{arm} T={P19_POD[1]} H={P19_POD[0]}"] = (arm, pods["pod"])
    for run, largest in ((e2e or {}).get("cf_largest") or {}).items():
        if run != "cuda":
            continue
        for arm_label, call in largest.items():
            if call is None:
                continue
            a, k = call
            arm = CF_ARM_OF[arm_label]
            x = dict(avail=a[0], dem=a[1], valid=a[2],
                     u=a[3] if arm == "opportunistic" else None,
                     live=k.get("live"), risk=k.get("risk"))
            timed[f"largest {arm_label} tick of phase 3"] = (arm, x)
    times = {}
    for key, (arm, x) in timed.items():
        pod = x["avail"].shape[-2] == P19_POD[0]
        times[key] = p19_time(ck, arm, x, **(
            dict(reps=5, plain_reps=1) if pod else {}))
    for key, t in times.items():
        p19_log(key, t)
    rec = dict(check=chk, cases=chk.cases, max_abs_err=chk.max_abs_err,
               compare_launches=compare, times=times,
               launches=ck.LAUNCHES["carry_free_place"])
    if sweep:
        rec["sweep"] = p19_sweep(ck, device, chk, pods["pod"])
    return rec


# ---------------------------------------------------------------------------
# Phase 20: ensemble_chain alone.
# ---------------------------------------------------------------------------

#: The chain's arms, in the kernel's order.
CHAIN_ARMS = ("cost-aware", "first-fit", "best-fit", "opportunistic")
#: The synthetic cases' tick: T steps at most a replica over G groups and
#: Z zones (the CLI's 31), R replicas.
P20_T = 160
P20_G = 24
P20_R = 8
#: The real ticks: the one with the most steps among ticks
#: [P20_SKIP, P20_SKIP + P20_WINDOW) of an R = 1024 rollout at the
#: ``ensemble`` defaults (phase 6 (e)'s window).
P20_SKIP = ENS_PROFILE_SKIP
P20_WINDOW = ENS_PROFILE_WINDOW
P20_REPS = 20


def _bits(t):
    """A tensor's bits, so that NaN payloads and ±0 compare exactly."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


class ChainCheck:
    """``ensemble_chain`` against the plain chain: placements, delays and
    availability bit for bit; tracks the cases, the placements and the
    largest |difference| of delays and availability (0.0 when equal)."""

    def __init__(self):
        self.cases = 0
        self.placed = 0
        self.max_abs_err = 0.0

    def same(self, got, want, what, min_placed=0) -> None:
        torch.cuda.synchronize()
        for name, g, w in zip(("placements", "delays", "availability"),
                              got, want):
            if not torch.equal(_bits(g), _bits(w)):
                bad = (_bits(g) != _bits(w)).nonzero()[:5].tolist()
                raise AssertionError(f"{what}: {name} differ at {bad}")
        placed = int((got[0] >= 0).sum())
        if placed < min_placed:
            raise AssertionError(f"{what}: {placed} placements, fewer than "
                                 f"the {min_placed} this case must make")
        self.placed += placed
        self.cases += 1


class ChainTap:
    """Wraps ``cuda_kernels.ensemble_chain_cuda`` (the tick loop's route on
    the card) while active.  With ``chk``, every launch is held right
    after it against ``_chain_plain`` on the same operands (the
    availability cloned before the launch), torch's sync debug mode off
    around the hold.  With ``keep``, the operands of the call with the
    most steps are kept (the availability cloned) for timing.  ``calls``
    counts the calls it saw; launches are the wrapper's own count."""

    def __init__(self, ck, chk=None, keep=False, what="chain"):
        from pivot_tpu_torch.parallel.ensemble import tick

        self.ck, self.tick, self.chk, self.keep = ck, tick, chk, keep
        self.what = what
        self.calls = 0
        self.kept = None  # (steps, policy, avail before, args, kw)

    def __enter__(self):
        self.fn = self.ck.ensemble_chain_cuda
        self.ck.ensemble_chain_cuda = self._call
        return self

    def __exit__(self, *exc):
        self.ck.ensemble_chain_cuda = self.fn

    def _call(self, policy, avail, *args, **kw):
        before = avail.clone() if (self.chk or self.keep) else None
        out = self.fn(policy, avail, *args, **kw)
        self.calls += 1
        if self.chk is not None or self.keep:
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                if self.chk is not None:
                    a = before.clone()
                    want = self.tick._chain_plain(policy, a, *args, **kw)
                    self.chk.same((*out, avail), (*want, a),
                                  (self.what, policy, self.calls))
                steps = int(args[4].max()) if args[4].numel() else 0
                if self.keep and (self.kept is None or steps > self.kept[0]):
                    self.kept = (steps, policy, before, args, kw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return out


def p20_inputs(seed, policy, device, case="dense", H=600, R=P20_R,
               T=P20_T, G=P20_G, Z=Z, risk=False, expo=False,
               realtime=False):
    """Seeded f32 operands of one tick's chain: ``(policy, avail, g_p,
    az_p, bf_p, order, n_ready, dem_group, cd, host_zone)`` and the
    keyword operands.  ``n_ready`` runs from 0 to T over the replicas;
    anchor buckets open every few steps.  Cases: "dense" (hosts of 0-16
    in each lane, demands of 0-2), "ties" (every host and demand equal,
    uniform score tables, risk ±0: every argmin ties, across warps),
    "down" (a third of the hosts at the −1 sentinel), "nan_risk" (risk
    from {0, −0, 0.25, ±inf, NaN}), "zero_bw" (zero bandwidths and
    costs in the tables: inf and NaN scores), "zero_norm" (with
    exponents from {0, 0.5, 1, 2, 3}: a quarter of the hosts empty and
    a quarter at 1e-20 in each lane, zero demands so that the tiny ones
    fit), "u_near_1" (uniforms just below 1 and rotations of whole
    turns)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    avail = rng.integers(0, 17, (R, H, 4)).astype(f32)
    dem = rng.choice([0.0, 0.5, 1.0, 2.0], (G, 4)).astype(f32)
    if case == "ties":
        avail[:] = 8.0
        dem[:] = (1.0, 1.0, 0.5, 0.0)
    elif case == "down":
        avail[:, rng.random(H) < 1 / 3] = -1.0
    elif case == "zero_norm":
        pick = rng.random((R, H))
        avail[pick < 0.25] = 0.0
        avail[(pick >= 0.25) & (pick < 0.5)] = f32(1e-20)
        dem[:] = 0.0
    n_ready = rng.integers(0, T + 1, R)
    n_ready[0], n_ready[-1] = 0, T
    bf = np.sort(rng.integers(0, T, (R, T)), axis=1)
    x = dict(
        avail=avail, g_p=rng.integers(0, G, (R, T)),
        az_p=rng.integers(0, Z, (R, T)), bf_p=bf,
        order=np.stack([rng.permutation(T) for _ in range(R)]),
        n_ready=n_ready, dem_group=dem,
        cd=rng.random((R, G, Z)).astype(f32),
        host_zone=rng.integers(0, Z, H))
    kw = {}
    if policy == "cost-aware":
        cost = rng.choice([0.01, 0.02, 0.09, 0.12], (Z, Z))
        bw = rng.choice([50.0, 100.0, 900.0, 2500.0], (Z, Z))
        if case == "ties":
            cost[:], bw[:] = 0.02, 100.0
        elif case == "zero_bw":
            bw[rng.random((Z, Z)) < 0.3] = 0.0
            cost[rng.random((Z, Z)) < 0.3] = 0.0
        czz = torch.from_numpy((cost + cost.T).astype(f32))
        bzz = torch.from_numpy((bw + bw.T).astype(f32))
        if expo:
            from pivot_tpu_torch.parallel.ensemble.libm import xla_pow

            sp = torch.from_numpy(rng.choice(
                [0.0, 0.5, 1.0, 2.0, 3.0], (R, 3)).astype(f32))
            czz = xla_pow(czz[None], sp[:, 0, None, None]).contiguous()
            bzz = xla_pow(bzz[None], sp[:, 1, None, None]).contiguous()
            kw["w_norm"] = sp[:, 2:3].contiguous()
        kw["cost_zz"], kw["bw_zz"] = czz, bzz
        if realtime:
            rt = (bw + bw.T).astype(f32)[:, x["host_zone"]]
            q = rng.choice([0.0, 0.0, 10.0, 400.0], (R, Z, H)).astype(f32)
            kw["score_bw"] = torch.from_numpy(np.where(
                q > 0, rt / (q + 1), rt).astype(f32))
    if policy == "opportunistic":
        u = rng.random((R, T)).astype(f32)
        rot = (rng.integers(0, 400, R) * f32(0.618034)).astype(f32)
        if case == "u_near_1":
            u[:] = f32(0.99999994)
            rot = rng.integers(0, 3, R).astype(f32)
        kw["u_p"], kw["weyl_rot"] = torch.from_numpy(u), torch.from_numpy(rot)
    if risk:
        r = rng.choice([0.0, 0.25, 1.0, 2.0], (R, H))
        if case == "ties":
            r = rng.choice([0.0, -0.0], (R, H))
        elif case == "nan_risk":
            r = rng.choice([0.0, -0.0, 0.25, np.inf, -np.inf, np.nan],
                           (R, H), p=[0.3, 0.2, 0.3, 0.08, 0.04, 0.08])
        kw["risk_row"] = torch.from_numpy(r.astype(f32))
    args = tuple(torch.from_numpy(np.ascontiguousarray(x[k])).to(device)
                 for k in ("avail", "g_p", "az_p", "bf_p", "order",
                           "n_ready", "dem_group", "cd", "host_zone"))
    return (policy, *args), {k: v.to(device) for k, v in kw.items()}


def p20_case(ck, chk, call, what, min_placed=0):
    """The wrapper against the plain chain on ``call``'s operands (each
    on its own copy of the availability); returns the launch shape."""
    from pivot_tpu_torch.parallel.ensemble import tick

    (policy, avail, *rest), kw = call
    a1, a2 = avail.clone(), avail.clone()
    got = ck.ensemble_chain_cuda(policy, a1, *rest, **kw)
    want = tick._chain_plain(policy, a2, *rest, **kw)
    chk.same((*got, a1), (*want, a2), what, min_placed=min_placed)
    return ck._chain_config(avail.shape[1], rest[6].shape[2], policy,
                            kw.get("risk_row") is not None)


def p20_cases(ck, device, chk) -> dict:
    """The synthetic cases of phase 20; returns the forms each ran in."""
    forms = collections.Counter()
    seed = 2000
    for policy in CHAIN_ARMS:
        ca, opp = policy == "cost-aware", policy == "opportunistic"
        cases = [("dense", 600, False), ("dense", 600, True),
                 ("dense", 1, True), ("dense", 33, False),
                 ("dense", 100, True), ("ties", 600, False),
                 ("ties", 600, True), ("down", 600, True),
                 ("nan_risk", 600, True)]
        if ca:
            cases += [("zero_bw", 600, False), ("zero_bw", 600, True),
                      ("zero_norm", 600, False), ("zero_norm", 600, True),
                      ("realtime", 600, False), ("realtime", 600, True),
                      ("expo", 600, True)]
        if opp:
            cases += [("u_near_1", 600, False), ("u_near_1", 600, True)]
        for risk in (False, True):  # one host past the shared form
            top = 1
            while ck._chain_config(top * 2, Z, policy, risk).form == \
                    ck._CHAIN_SHARED:
                top *= 2
            lo, hi = top, top * 2
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if ck._chain_config(mid, Z, policy, risk).form == \
                        ck._CHAIN_SHARED:
                    lo = mid
                else:
                    hi = mid
            cases.append(("global", hi, risk))
        for case, H, risk in cases:
            seed += 1
            kind = case if case not in ("realtime", "expo", "global") \
                else "dense"
            call = p20_inputs(seed, policy, device, case=kind, H=H,
                              R=2 if case == "global" else P20_R,
                              T=48 if case == "global" else P20_T,
                              risk=risk, expo=case in ("zero_norm", "expo"),
                              realtime=case == "realtime")
            n_ready = call[0][6]
            floor = int(n_ready.sum()) // 4 if case in ("dense", "global") \
                and H >= 600 else 0
            cfg = p20_case(ck, chk, call, (policy, case, H, risk),
                           min_placed=floor)
            if case == "global" and cfg.form != ck._CHAIN_GLOBAL:
                raise AssertionError(f"{policy} at H={H}: not the global "
                                     f"form ({cfg})")
            forms[cfg.state] += 1
    return dict(forms)


def p20_real_ticks(ck, device, chk) -> dict:
    """Two R = 1024 ticks of each arm at the ``ensemble`` defaults (600
    hosts x 50 apps): ``_rollout_segment`` walks ``P20_SKIP`` ticks,
    keeping the one with the longest replica chain (the rollout's
    opening burst), then ``P20_WINDOW`` more with every launch held
    against the plain chain, keeping the one with the longest chain
    there.  Returns ``({policy: window tick}, {policy: opening tick})``,
    each tick ``(steps, policy, avail before, args, kw)``."""
    from pivot_tpu_torch.experiments import cli
    from pivot_tpu_torch.parallel.ensemble import (
        _init_state,
        _opportunistic_uniforms,
        _perturbations,
        _rollout_segment,
        prng,
    )

    args, (avail0, workload, topo, sz) = ensemble_inputs(cli, device)
    key = prng.PRNGKey(args.seed)
    T, Z_ = workload.n_tasks, topo.cost.shape[0]
    out, opening = {}, {}
    for policy in CHAIN_ARMS:
        rt, arr, anchor = _perturbations(key, workload, sz, ENS_REPLICAS,
                                         args.perturb, avail0.dtype)
        task_u = _opportunistic_uniforms(
            key, ENS_REPLICAS, T, avail0.dtype, device) \
            if policy == "opportunistic" else None
        state = _init_state(avail0, T, Z_, ENS_REPLICAS)
        kw = dict(totals=avail0, policy=policy, tick_order=args.tick_order,
                  task_u=task_u)
        with ChainTap(ck, keep=True, what="opening tick") as tap:
            state = _rollout_segment(state, rt, arr, anchor, workload, topo,
                                     args.tick, P20_SKIP, **kw)
        opening[policy] = tap.kept
        with ChainTap(ck, chk=chk, keep=True, what="real tick") as tap:
            _rollout_segment(state, rt, arr, anchor, workload, topo,
                             args.tick, P20_WINDOW, **kw)
        out[policy] = tap.kept
    return out, opening


def chain_bound(policy, avail, args, kw, pl):
    """Least time for one chain at these operands: the larger of the
    bytes over HBM bandwidth and the operations over the f32 peak.
    Bytes: the availability rows of the replicas that walk a step
    (n_ready > 0; a replica at 0 leaves its rows as they are), read once
    — first-fit without risk reads each such replica's hosts only up to
    the last first fit of its chain (all of them when a step found none)
    — and 16 a distinct placed (replica, host) written back; the streams
    (group, anchor, bucket, task index, and the uniform for
    opportunistic) of the steps walked, Σ n_ready; n_ready; the demand
    table; one delay entry a placement; the zones; the tables (cost-aware,
    ``[Z, Z]``, or ``[R, Z, Z]`` with exponents), and the risk,
    exponent and realtime rows when given, a replica's rows only where
    it walks a step; ``pl`` and ``delay`` ``[R, T]`` written.
    Operations a step, each on the H hosts of its replica: the fit test
    (8: 4 compares, 3 ANDs, the selection), then cost-aware's score (a
    product and a quotient, +1 with risk) and argmin compare (1), plus 8
    a host (one square, three fused multiply-adds of 2, the root) at
    each step that opens an anchor bucket; first-fit the hosts up to the
    first fit (all when none fits; all plus 1 with risk); best-fit 13
    more (4 subtractions, a square, three fused multiply-adds, the root,
    the compare; +1 with risk); opportunistic 3 (the count, +2 with
    risk) and 3 for the rank; 4 a placement (the decrement).  Returns
    ``(ms, "bytes" or "operations", Σ n_ready, max n_ready)``."""
    g_p, az_p, bf_p, order, n_ready, dem, cd, hz = args
    R, H = avail.shape[0], avail.shape[1]
    T, G = order.shape[1], dem.shape[0]
    risk = kw.get("risk_row") is not None
    nr = n_ready.tolist()
    steps = sum(nr)
    active = sum(n > 0 for n in nr)
    walked = torch.arange(T, device=order.device)[None, :] < n_ready[:, None]
    host = pl.gather(1, order)  # the host each step placed at, or -1
    # the hosts a step reads up to: first-fit's first fit, else all H
    reach = torch.where(walked, torch.where(host >= 0, host + 1, H), 0)
    placed = int((pl >= 0).sum())
    rows = torch.arange(R, device=pl.device)[:, None] * H
    touched = int(torch.unique((rows + pl)[pl >= 0]).numel())
    hosts_read = (int(reach.amax(1).sum()) if T else 0) \
        if policy == "first-fit" and not risk else active * H
    nbytes = (hosts_read * 16 + touched * 16
              + steps * (32 + 4 * (policy == "opportunistic"))
              + R * 8 + G * 16 + placed * 4 + H * 8 + R * T * 12
              + active * H * 4 * risk)
    for name in ("cost_zz", "bw_zz", "w_norm", "score_bw"):
        t = kw.get(name)
        if t is None:
            continue
        per_row = name in ("w_norm", "score_bw") or t.dim() == 3
        nbytes += (t.numel() // R * active if per_row else t.numel()) * 4
    if policy == "cost-aware":
        prev = torch.cat([bf_p.new_full((R, 1), -1), bf_p[:, :-1]], 1)
        opens = int(((bf_p != prev) & walked).sum())
        ops = steps * H * (8 + 3 + risk) + opens * H * 8
    elif policy == "first-fit" and risk:
        ops = steps * H * 9
    elif policy == "first-fit":
        ops = 8 * int(reach.sum())
    elif policy == "best-fit":
        ops = steps * H * (8 + 13 + risk)
    else:
        ops = steps * (H * (8 + 3 + 2 * risk) + 3)
    ops += 4 * placed
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", steps, max(nr))


def p20_time(ck, kept, reps=P20_REPS) -> dict:
    """``kernel_ms`` (CUDA events around the bare launch, each on its own
    copy of the availability), the wrapper's ms (likewise), the plain
    chain's ms (host clock around one synchronised call), ns a step of
    the longest replica chain, and the bound."""
    from pivot_tpu_torch.parallel.ensemble import tick

    steps, policy, avail, args, kw = kept
    H, Zc = avail.shape[1], args[6].shape[2]
    cfg = ck._chain_config(H, Zc, policy, kw.get("risk_row") is not None)
    R, T = args[3].shape
    pl = torch.empty((R, T), dtype=torch.int64, device=avail.device)
    delay = torch.empty((R, T), dtype=torch.float32, device=avail.device)
    copies = [avail.clone() for _ in range(reps + 1)]
    order = ("cost_zz", "bw_zz", "u_p", "risk_row", "w_norm", "weyl_rot",
             "score_bw")

    def bare():
        ck._chain_launch(cfg, policy, copies.pop(), *args,
                         *(kw.get(k) for k in order), pl, delay)
    kernel_ms = _events_ms(bare, reps)
    copies[:] = [avail.clone() for _ in range(reps + 1)]
    ms = _events_ms(lambda: ck.ensemble_chain_cuda(policy, copies.pop(),
                                                   *args, **kw), reps)
    a = avail.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tick._chain_plain(policy, a, *args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    b_ms, b_by, total, longest = chain_bound(policy, avail, args, kw,
                                             want[0])
    return dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, steps=total,
                longest_chain=longest,
                ns_per_step=kernel_ms * 1e6 / max(longest, 1),
                shape=f"{cfg.state} W={cfg.warps} smem={cfg.smem_bytes}")


def phase_chain(device, ck) -> dict:
    """Phase 20 (module docstring).  Returns its record."""
    chk = ChainCheck()
    ck.reset_launches()  # the phase's own launches: comparisons and times
    forms = p20_cases(ck, device, chk)
    n_synth = chk.cases
    kept, opening = p20_real_ticks(ck, device, chk)
    for what, ticks, span in (
            ("real tick alone", kept, f"{P20_SKIP}-{P20_SKIP + P20_WINDOW}"),
            ("opening tick alone", opening, f"0-{P20_SKIP}")):
        for policy, k in ticks.items():  # each kept tick, held alone
            if k is None or not k[0]:
                raise AssertionError(f"{policy}: no placement step in "
                                     f"ticks {span}")
            p20_case(ck, chk, ((policy, k[2], *k[3]), k[4]),
                     (what, policy), min_placed=1)
    log(f"  {chk.cases} cases ({n_synth} synthetic over the four arms — "
        f"{forms} — and {chk.cases - n_synth} launches of R={ENS_REPLICAS} "
        f"ticks {P20_SKIP}-{P20_SKIP + P20_WINDOW} of the four arms at 600 "
        f"hosts x 50 apps, with the longest-chain tick of ticks "
        f"0-{P20_SKIP} of each alone), {chk.placed} placements: "
        f"placements, delays "
        f"and availability equal to the plain chain bit for bit, max "
        f"|diff| {chk.max_abs_err!r}")
    compare = ck.LAUNCHES["ensemble_chain"]
    times, times_opening = {}, {}
    for label, ticks, into in (
            (f"ticks {P20_SKIP}-{P20_SKIP + P20_WINDOW}", kept, times),
            (f"opening, ticks 0-{P20_SKIP}", opening, times_opening)):
        for policy, k in ticks.items():
            t = into[policy] = p20_time(ck, k)
            log(f"  {policy} R={ENS_REPLICAS} tick ({label}: {t['steps']} "
                f"steps, the longest replica chain {t['longest_chain']}; "
                f"{t['shape']}): wrapper {t['ms']!r} ms, kernel_ms "
                f"{t['kernel_ms']!r}, {t['ns_per_step']!r} ns a step of the "
                f"longest chain, plain chain {t['plain_ms']!r} ms, bound "
                f"{t['bound_ms']!r} ms ({t['bound_by']})")
    return dict(check=chk, cases=chk.cases, max_abs_err=chk.max_abs_err,
                compare_launches=compare, forms=forms, times=times,
                times_opening=times_opening)


def chain_record(ens, sweeps, search, congestion, p12, p20) -> dict:
    """``ensemble_chain``'s entry of the ``kernels`` record: the main
    path's launches (phase 6 (a)'s R = 1024 runs, one a tick, and the
    main process's launches in phases 7, 8, 9 and 12), the largest error
    of every comparison (6 (c)'s holds and phase 20's), and phase 20's
    times — its main-path shape the cost-aware R = 1024 tick.  A number
    of a phase not run is null."""
    by_phase = {
        "phase6 (a)": ens and sum(r["chain_launches"]
                                  for r in ens["arms"].values()),
        "phase7": sweeps and sweeps["chain_launches"],
        "phase8": search and search["chain_launches"],
        "phase9": congestion and congestion["chain_launches"],
        "phase12": p12 and p12["chain_launches"],
    }
    errs = [x for x in (ens and ens["chain_max_abs_err"],
                        p20 and p20["max_abs_err"]) if x is not None]
    main = p20 and p20["times"]["cost-aware"]
    return {
        "name": "ensemble_chain",
        "route": "cuda",
        "source": "pivot_tpu_torch/csrc/ensemble_chain.cu",
        "replaces": "pivot_tpu/parallel/ensemble/tick.py:720",
        "replaces_note": "no pallas_call: the lax.while_loop place_cond / "
                         "place_body (:720-890) of _rollout_segment, "
                         "vmapped over replicas",
        "launches": (None if None in by_phase.values()
                     else sum(by_phase.values())),
        "launches_by_phase": by_phase,
        "phase6_compare_holds": ens and ens["chain_holds"],
        "phase20_compare_launches": p20 and p20["compare_launches"],
        "max_abs_err": max(errs) if errs else None,
        "ms": main and main["ms"],
        "kernel_ms": main and main["kernel_ms"],
        "ns_per_step": main and main["ns_per_step"],
        "plain_ms": main and main["plain_ms"],
        "bound_ms": main and main["bound_ms"],
        "bound_by": main and main["bound_by"],
        "library_ms": None,
        "times": p20 and p20["times"],
        "times_opening": p20 and p20["times_opening"],
    }


def cf_record(e2e, sens, p14, p15, p19) -> dict:
    """``carry_free_place``'s entry of the ``kernels`` record: the main
    path's launches (phases 3 and 4, by run, arm and R), the largest
    error of every comparison, and phase 19's times — its main-path shape
    the largest VBP tick of phase 3 (else First-Fit at T = 619, H = 600).
    A number of a phase not run is null."""
    by_run = None
    if e2e is not None and sens is not None:
        by_run = {f"phase3 {n}": e2e["runs"][n]["cf_launches"]
                  for n in ("cuda", "cuda_off")}
        by_run["phase4 vbp"] = sens["vbp"]["cf_launches"]
    errs = [x.max_abs_err for x in (
        e2e and e2e["cf_check"], sens and sens["vbp"]["cf_check"],
        p19 and p19["check"]) if x is not None]
    if p14 is not None:
        errs.append(p14["costattr"]["cf_max_abs_err"])
    times = p19 and p19["times"]
    main = times and times.get("largest VBP tick of phase 3",
                               times[f"first-fit T={P19_R_T} H={P19_H}"])
    return {
        "name": "carry_free_place",
        "route": "cuda",
        "source": "pivot_tpu_torch/csrc/carry_free_place.cu",
        "replaces": "pivot_tpu/ops/kernels.py:714",
        "replaces_note": "no pallas_call: the slim lax.while_loop "
                         "(_slim_drive) of opportunistic_impl :795, "
                         "first_fit_impl :861 and best_fit_impl :924",
        "launches": by_run and sum(sum(r.values()) for r in by_run.values()),
        "launches_by_run": by_run,
        "phase15_unsharded_launches": p15 and sum(
            r["unsharded_cf_launches"] for r in p15["e2e"].values()),
        "phase19_compare_launches": p19 and p19["compare_launches"],
        "max_abs_err": max(errs) if errs else None,
        "ms": main and main["ms"],
        "kernel_ms": main and main["kernel_ms"],
        "ns_per_step": main and main["ns_per_step"],
        "plain_ms": main and main["plain_ms"],
        "bound_ms": main and main["bound_ms"],
        "bound_by": main and main["bound_by"],
        "library_ms": None,
        "times": times,
    }


def phase_5_report(ck, e2e, sens, card, device):
    """Phase 5: times on the card (the main path's wrapper, bare launches,
    the warp sweep, the gated R = 256 launches) and the reports of
    phases 3 and 4.  Returns ``(times, gated times, spans)``."""
    shadow = e2e["shadow"]
    ca = sens["cost-aware"]
    times = phase_times(ck, shadow, device)
    gt = gated_times(ck, ca.pop("calls"))
    lt = times["largest_tick"]
    log(f"  [{card}]")
    mk = times["tick_median_kernel"]
    log(f"  wrapper per tick: median {times['tick_median_ms']!r} ms over "
        f"{len(shadow.ticks)} ticks (median n_eff "
        f"{times['tick_n_eff_median']}); kernel_ms at the median tick "
        f"{mk['kernel_ms']!r}, {mk['ns_per_step']!r} ns per step")
    log(f"  largest tick (n_eff={lt['n_eff']}, bucket {lt['bucket']}, "
        f"H={lt['H']}): wrapper {lt['ms']!r} ms, kernel_ms "
        f"{lt['kernel_ms']!r}, {lt['ns_per_step']!r} ns per step, plain "
        f"{lt['plain_ms']!r} ms, bound {lt['bound_ms']!r} ms "
        f"({lt['bound_by']})")
    for key in ("T619_H600", "T2048_H600", "R256_T619_H600"):
        t = times[key]
        log(f"  {key}: wrapper {t['ms']!r} ms, kernel_ms {t['kernel_ms']!r},"
            f" {t['ns_per_step']!r} ns per step, plain {t['plain_ms']!r} ms,"
            f" bound {t['bound_ms']!r} ms ({t['bound_by']})")
    log("  ns per step (T=2048, H=600, default shape): " + ", ".join(
        f"{k} {v!r}" for k, v in times["step_ns"].items())
        + f"; group entries are {times['main_path_entry_share']!r} of the "
        "main path's tasks")
    for key, row in times["sweep"].items():
        log(f"  sweep {key} (default W={row['default_warps']}): " + ", ".join(
            f"W={w} K={r['K']} G={r['groups']} {r['kernel_ms']!r} ms"
            for w, r in row["by_warps"].items()))
    prof = profile_kernels(ck, shadow)
    if prof is None:
        log("  torch.profiler recorded no device kernels: one-kernel check "
            "not made")
    else:
        log(f"  torch.profiler: {prof[0]} greedy_place kernels of "
            f"{prof[1]} device kernels over 10 wrapper calls")
        if prof != (10, 10):
            raise AssertionError("a wrapper call is not exactly one kernel")
    ca_wall = e2e["runs"]["cuda"]["arms"]["Cost-Aware"]["wall_clock"]
    log(f"  greedy_place busy: {times['tick_sum_ms']!r} ms of wrapper time "
        f"over the run's ticks = {times['tick_sum_ms'] / (ca_wall * 1e3)!r} "
        f"of the Cost-Aware arm's {ca_wall!r} s wall on cuda")
    log(f"  greedy_place in spans: median {times['span_tick_median_ms']!r}"
        f" ms of wrapper time over {len(shadow.span_ticks)} span ticks "
        f"(median n_eff {times['span_tick_n_eff_median']}), "
        f"{times['span_tick_sum_ms']!r} ms in all")
    for name in ("cuda", "cuda_off", "numpy"):
        r = e2e["runs"][name]
        log(f"  overall on {name}: {r['wall']!r} s for 3 arms; per arm "
            + ", ".join(f"{a} {r['arms'][a]['wall_clock']!r} s"
                        for a in ARMS))
    spans = {}
    for arm in ARMS:
        st = e2e["runs"]["cuda"]["arms"][arm]["spans"]
        dev = e2e["runs"]["cuda"]["spans"][arm]
        spans[arm] = dict(st, **dev, launches=(
            e2e["runs"]["cuda"]["arms"][arm]["dispatch"]))
        log(f"  spans {arm}: {st['fused_spans']} served, {st['fused_ticks']}"
            f" ticks replayed ({st['fused_ticks'] / max(st['fused_spans'], 1)!r}"
            f" a span), {st['span_aborts']} aborted, {st['spans_declined']} "
            f"declined, {st['ff_ticks']} ticks fast-forwarded; on the card "
            f"{dev['spans']} spans of {dev['horizon_ticks']} horizon ticks, "
            f"{dev['ticks_run']} executed, {dev['steps']} pass steps walked "
            f"for {dev['live_steps']} live ones; device "
            f"ms per span median {dev['ms_median']!r}, largest "
            f"{dev['ms_max']!r}, sum {dev['ms_sum']!r}; no host sync inside")
    for arm, d in e2e["same_files"].items():
        log(f"  fusion on vs off, {arm}: " + (
            "output files byte-identical" if d is None else
            f"files differ: {d['differing_tasks']} tasks placed "
            f"differently, first {d['first']} on {d['first_on']} (on) vs "
            f"{d['first_off']} (off); float32 tie of demand norms possible: "
            f"{d['f32_norm_tie']}"))
    gl = gt["largest"]
    log(f"  gated Cost-Aware tick (R={SENS_REPLICAS}, H=600, market cost "
        f"slice): wrapper median {gt['ms_median']!r} ms, largest "
        f"{gt['ms_max']!r}, sum {gt['ms_sum']!r} over {ca['ticks']} ticks; "
        f"kernel_ms median {gt['kernel_ms_median']!r}, largest "
        f"{gt['kernel_ms_max']!r}, sum {gt['kernel_ms_sum']!r}; median n_eff "
        f"{gt['n_eff_median']}; largest n_eff {gl['n_eff']}: wrapper "
        f"{gl['ms']!r} ms, kernel_ms {gl['kernel_ms']!r}, plain "
        f"{gl['plain_ms']!r} ms, bound {gl['bound_ms']!r} ms "
        f"({gl['bound_by']})")
    for policy, r in sens.items():
        per = {k: v * 1e3 / r["ticks"] for k, v in r["parts"].items()}
        log(f"  gated {policy} tick, host ms (noise / stage / pass enqueue /"
            f" fetch+unpad incl. the device wait / _mc_sensitivity total): "
            f"{per['noise']!r} / {per['stage']!r} / {per['pass']!r} / "
            f"{per['fetch_unpad']!r} / {per['total']!r}")
    return times, gt, spans


PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
          19, 20)


def selected_phases(argv) -> tuple:
    """``--phases 1,6,7`` (default: all), ``--cf-sweep`` and
    the set of phases and whether phase 19 sweeps.  Phases 2-5, 10-17, 19
    and 20 need
    phase 1's build (phase 14 its ``ptxas`` rows too), phase 5 the runs
    of phases 3 and 4, phase 13 the python-fabric run of phase 3: they
    come along."""
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke of the port.")
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma list of phases to run (default: all)")
    ap.add_argument("--cf-sweep", action="store_true",
                    help="phase 19 also times carry_free_place by launch "
                         "shape (the study behind _cf_config)")
    args = ap.parse_args(argv)
    want = {int(x) for x in args.phases.split(",") if x}
    if not want <= set(PHASES):
        ap.error(f"phases are {PHASES}, got {sorted(want)}")
    if 5 in want:
        want |= {3, 4}
    if 13 in want:
        want.add(3)
    if want & {2, 3, 4, 5, 10, 11, 12, 13, 14, 15, 16, 17, 19, 20}:
        want.add(1)
    return want, args.cf_sweep


def phases_6_to_9(phases, device, card, census, walls, p16):
    """Phases 6-9 of ``main`` (those selected), sharing one
    ``side_workers``: the CPU sides of their checks on one worker, and
    their untimed card runs in a ``CardPool`` that the first of them
    waits for before it times anything.  Their reports (None for a phase
    not run); ``p16`` gains phase 16's referents from them and its runs
    from the pool (``p16_refs``' keys)."""
    ens_mk = ens = sweeps = search = congestion = None
    with side_workers(phases, device) as (pool, cpu):
        if 6 in phases:
            tp = time.perf_counter()
            log(f"== 6. the Monte-Carlo ensemble on the card: 600 hosts x "
                f"50 apps, R={ENS_REPLICAS} ({', '.join(ENS_ARMS)}), "
                f"checked at R={ENS_CHECK_REPLICAS}")
            log(f"  [{card}]")
            ens = phase_ensemble(device, pool, cpu)
            ens_mk = ens.pop("makespan_cost-aware")
            ens.pop("makespan_first-fit")
            walls[6] = time.perf_counter() - tp
            census_line(census, 6)
            log(f"  phase 6 wall: {walls[6]!r} s")
        if 7 in phases:
            tp = time.perf_counter()
            log(f"== 7. fault ensembles and the what-if sweeps on the card: "
                f"the pivot_tpu fixture, the README's commands at 600 hosts, "
                f"card vs CPU at {SW_APPS} apps")
            log(f"  [{card}]")
            sweeps = phase_sweeps(device, ens_mk, pool, cpu)
            walls[7] = time.perf_counter() - tp
            census_line(census, 7)
            log(f"  phase 7 wall: {walls[7]!r} s")
        if 8 in phases:
            tp = time.perf_counter()
            log("== 8. the policy search on the card: the pivot_tpu fixture, "
                "the four runs through the CLI (the 10,240-row population at "
                "600 hosts), card vs CPU at 600 hosts")
            log(f"  [{card}]")
            search = phase_search(device, cpu)
            walls[8] = time.perf_counter() - tp
            census_line(census, 8)
            log(f"  phase 8 wall: {walls[8]!r} s")
        if 9 in phases:
            tp = time.perf_counter()
            log("== 9. the congestion model, realtime scoring, checkpoints "
                "and calibrate on the card: calibrate and the README's "
                "congestion command through the CLI against pivot_tpu, card "
                f"vs CPU at {CG_APPS} apps")
            log(f"  [{card}]")
            congestion = phase_congestion(device, pool, cpu)
            walls[9] = time.perf_counter() - tp
            census_line(census, 9)
            log(f"  phase 9 wall: {walls[9]!r} s")
        p16.update({k[1:]: v for k, v in pool.results.items() if k[0] == 16})
    if sweeps is not None:
        p16.update({k: sweeps.pop("summary_" + k) for k in P16_FROM_PHASE_7})
    if search is not None:
        p16["quickstart"] = search.pop("quickstart_report")
        p16["population"] = search.pop("population")
    return ens, sweeps, search, congestion


def main(argv=None) -> int:
    phases, cf_sweep = selected_phases(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke runs only on a machine with a CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir("pivot_tpu_torch"):
        print("chip_smoke: run from the root of a pivot_tpu checkout",
              file=sys.stderr)
        return 2
    from pivot_tpu_torch.ops import build
    from pivot_tpu_torch.ops import cuda_kernels as ck

    census = PolicyCensus().install()
    configs = LaunchConfigs().install() if 14 in phases else None
    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"phases {sorted(phases)}")
    log(card)
    chk = e2e = sens = times = gt = spans = ens = sweeps = None
    walls, ptxas_rows = {}, []
    if 1 in phases:
        tp = time.perf_counter()
        log("== 1. environment")
        nvcc = subprocess.run([build._nvcc(), "--version"], check=True,
                              capture_output=True, text=True, timeout=60)
        log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, "
            f"{nvcc.stdout.strip().splitlines()[-1]}, "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ptxas = ptxas_usage_start(build, tmp)  # beside the build
            cf_ptxas = cf_ptxas_start(build, tmp)
            chain_ptxas = chain_ptxas_start(build, tmp)
            paths = build.build_all()
            log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.2f} "
                f"s (nvcc {' '.join(build.NVCC_FLAGS)})")
            for line in ptxas_usage_lines(ptxas):
                log(f"  ptxas {line}")
                ptxas_rows.append(json.loads(line))
            spilled = [r for r in ptxas_rows
                       if r["spill_stores"] or r["spill_loads"]]
            log(f"  greedy_place spills in {len(spilled)} of "
                f"{len(ptxas_rows)} builds: " + (", ".join(
                    f"K={r['K']}{GREEDY_TAGS[r['state']]} "
                    f"{r['spill_stores']}/{r['spill_loads']} B"
                    for r in spilled) or "none"))
            cf_rows = cf_ptxas_lines(cf_ptxas)
            chain_rows = chain_ptxas_lines(chain_ptxas)
        from pivot_tpu_torch.analysis import kernel_budget as kb
        from pivot_tpu_torch.infra.roofline import H100_REGS_PER_BLOCK

        for row in cf_rows:
            log(f"  ptxas carry_free_place {json.dumps(row)}")
        bad = kb.cf_register_findings(cf_rows, H100_REGS_PER_BLOCK)
        if bad:
            raise AssertionError(f"carry_free_place registers: "
                                 f"{[str(f) for f in bad]}")
        for row in chain_rows:
            log(f"  ptxas ensemble_chain {json.dumps(row)}")
        bad = kb.chain_register_findings(chain_rows, H100_REGS_PER_BLOCK)
        if bad:
            raise AssertionError(f"ensemble_chain registers: "
                                 f"{[str(f) for f in bad]}")
        check_shape_tables(build, ck)
        check_cf_tables(build, ck)
        check_chain_tables(build, ck)
        arith_check(build)
        walls[1] = time.perf_counter() - tp
        census_line(census, 1)
        log(f"  phase 1 wall: {walls[1]!r} s")
    # Phases 14 (e)'s and 17 (e)'s one-shot runs, beside phase 2 (which
    # times nothing).
    oneshot = P14OneShot() if 14 in phases else None
    oneshot17 = P17OneShot() if 17 in phases else None
    try:
        if 2 in phases:
            tp = time.perf_counter()
            log("== 2. greedy_place vs plain on the card (f32)"
                + (" (phase 14's one-shot run beside it)" if oneshot else ""))
            chk = phase_kernel_vs_plain(ck, device)
            log(f"  {chk.cases} cases, {chk.placed} placements: all equal, "
                f"max |avail diff| {chk.max_abs_err!r} (rtol {RTOL}, atol "
                f"{ATOL})")
            walls[2] = time.perf_counter() - tp
            census_line(census, 2)
            log(f"  phase 2 wall: {walls[2]!r} s")
    finally:
        try:
            if oneshot is not None:
                oneshot.wait()
        finally:
            if oneshot17 is not None:
                oneshot17.wait()
    if oneshot is not None:
        log(f"  phase 14 (e)'s one-shot run ended: {oneshot.wall_s!r} s "
            "from its start")
    if oneshot17 is not None:
        log(f"  phase 17 (e)'s one-shot run ended: {oneshot17.wall_s!r} s "
            "from its start")
    if 3 in phases:
        tp = time.perf_counter()
        log(f"== 3. overall, 600 hosts x {E2E_APPS} apps: cuda with fused "
            "spans, cuda with fusion off, numpy")
        e2e = phase_end_to_end(device)
        walls[3] = time.perf_counter() - tp
        census_line(census, 3)
        log(f"  phase 3 wall: {walls[3]!r} s")
    if 4 in phases:
        tp = time.perf_counter()
        log(f"== 4. sensitivity on the card: 600 hosts, R={SENS_REPLICAS}, "
            f"Cost-Aware x {SENS_APPS['cost-aware']} apps and VBP x "
            f"{SENS_APPS['vbp']} apps under a seeded spot market")
        sens = phase_sensitivity(device)
        walls[4] = time.perf_counter() - tp
        census_line(census, 4)
        log(f"  phase 4 wall: {walls[4]!r} s")
    if 5 in phases:
        tp = time.perf_counter()
        log("== 5. times on the card")
        times, gt, spans = phase_5_report(ck, e2e, sens, card, device)
        walls[5] = time.perf_counter() - tp
        census_line(census, 5)
        log(f"  phase 5 wall: {walls[5]!r} s")
    ens = sweeps = search = congestion = None
    p16_refs = {}  # phase 16's referents from phases 6-9 and 11
    if phases & {6, 7, 8, 9}:
        ens, sweeps, search, congestion = phases_6_to_9(
            phases, device, card, census, walls, p16_refs)
    serve = rows = None
    if 10 in phases:
        tp = time.perf_counter()
        log("== 10. serve on the card: the per-row launch vs plain, then "
            "the README's serve commands through the CLI at 600 hosts a "
            "session")
        log(f"  [{card}]")
        rows = rows_vs_plain(ck, device)
        log(f"  per-row launch vs plain: {rows.cases} cases, {rows.placed} "
            f"placements: all equal, max |avail diff| {rows.max_abs_err!r}")
        serve = phase_serve(device)
        walls[10] = time.perf_counter() - tp
        census_line(census, 10)
        log(f"  phase 10 wall: {walls[10]!r} s")
    batching = None
    if 11 in phases:
        tp = time.perf_counter()
        log("== 11. cross-run batching on the card: batched and ragged span "
            "flushes vs plain, a resident span chain, the lock-step overall "
            f"grid ({P11_TRACES} traces x {P11_APPS} apps, 600 hosts) and "
            "the serve span commands through the CLI")
        batching = phase_batching(device)
        p16_refs["grid"] = batching["lockstep"].pop("files")
        walls[11] = time.perf_counter() - tp
        census_line(census, 11)
        log(f"  phase 11 wall: {walls[11]!r} s")
    p12 = None
    if 12 in phases:
        tp = time.perf_counter()
        log("== 12. model-predictive serving and the recovery plane on the "
            "card: the README's MPC command through the CLI, a paced MPC "
            "soak, a resident run killed and resumed, the watchdog armed")
        p12 = phase_mpc_recovery(device)
        walls[12] = time.perf_counter() - tp
        census_line(census, 12)
        log(f"  phase 12 wall: {walls[12]!r} s")
    p13 = None
    if 13 in phases:
        tp = time.perf_counter()
        log(f"== 13. the native network fabric, the degrade guard and the "
            f"dispatch profiler on the card: overall --network native (600 "
            f"hosts x {E2E_APPS} apps) against phase 3, injected kernel "
            f"faults, serve --profile-dispatch {P13_PROFILE_EVERY}, "
            f"--profile-dir")
        p13 = phase_native_guard_profiler(device, e2e)
        walls[13] = time.perf_counter() - tp
        census_line(census, 13)
        log(f"  phase 13 wall: {walls[13]!r} s")
    p14 = None
    if 14 in phases:
        tp = time.perf_counter()
        log("== 14. the tooling on the card: the graftcheck suite, the "
            "kernel budget against the card, cost attribution, the compile "
            "check and its falsifier, the resident worker")
        p14 = phase_tooling(device, configs.seen, ptxas_rows, oneshot)
        walls[14] = time.perf_counter() - tp
        census_line(census, 14)
        log(f"  phase 14 wall: {walls[14]!r} s")
    p15 = None
    if 15 in phases:
        tp = time.perf_counter()
        log(f"== 15. host sharding on the card: the four arms at "
            f"H={P15_H}, T={P15_T} through the sharded passes (S="
            f"{'/'.join(map(str, P15_SHARDS))}, per-step and C="
            f"{P15_CHUNK}) and greedy_place there (R=1, R={P15_GREEDY_R}, "
            f"G={P15_GREEDY_G}), overall's VBP and Cost-Aware arms sharded "
            f"over {P15_E2E_SHARDS} logical shards, overall's Cost-Aware "
            f"arm at {P15_WIDE_HOSTS} hosts on greedy_place")
        p15 = phase_sharding(device, ck)
        walls[15] = time.perf_counter() - tp
        census_line(census, 15)
        log(f"  phase 15 wall: {walls[15]!r} s")
    p16 = None
    if 16 in phases:
        tp = time.perf_counter()
        log(f"== 16. the replica axis on the card: sharded_rollout over "
            f"{P16_SHARDS} logical shards (R={P16_ROLLOUT_REPLICAS}; R=64 "
            f"with "
            f"faults), search --backend sharded_rollout and the "
            f"{SR_MAIN[-1][1]}-row population, the sharded capacity sweep, "
            f"the lock-step grid on the batcher's replica mesh")
        p16 = phase_replica_axis(device, ck, p16_refs)
        del p16_refs
        walls[16] = time.perf_counter() - tp
        census_line(census, 16)
        log(f"  phase 16 wall: {walls[16]!r} s")
    p17 = None
    if 17 in phases:
        tp = time.perf_counter()
        log(f"== 17. the 2-D serving mesh on the card: the [G]-batched "
            f"twins at H={P15_H}, T={P15_T}, G={P17_G} and a ragged batched "
            f"span, the README's 2-D serve command on a (1, "
            f"{P17_MESH_B[0]}, {P17_MESH_B[1]}) mesh of logical shards, "
            f"unsharded Cost-Aware sessions on a 2-D batcher, the sharded "
            f"resident carry, serve --shard-hosts 1 through the CLI")
        p17 = phase_2d_mesh(device, ck, p15, serve, oneshot17)
        walls[17] = time.perf_counter() - tp
        census_line(census, 17)
        log(f"  phase 17 wall: {walls[17]!r} s")
    p18 = None
    if 18 in phases:
        tp = time.perf_counter()
        log(f"== 18. elastic meshes on the card: DES runs resharded mid-run "
            f"(8->4, 4->8, unsharded->7 padded) at 600 hosts, the "
            f"reference's serving soak with shard {P18_FAULT[1]} of "
            f"{P18_SHARDS} lost and regrown, the shadow probe")
        p18 = phase_elastic(device, ck)
        walls[18] = time.perf_counter() - tp
        census_line(census, 18)
        log(f"  phase 18 wall: {walls[18]!r} s")
    p19 = None
    if 19 in phases:
        tp = time.perf_counter()
        log(f"== 19. carry_free_place vs plain on the card (f32): H={P19_H} "
            f"at T={'/'.join(map(str, P19_TS))}, R={SENS_REPLICAS} at "
            f"T={P19_R_T}, H={P19_POD[0]} at T={P19_POD[1]}; then times")
        p19 = phase_carry_free(device, ck, e2e, cf_sweep)
        walls[19] = time.perf_counter() - tp
        census_line(census, 19)
        log(f"  phase 19 wall: {walls[19]!r} s")
    p20 = None
    if 20 in phases:
        tp = time.perf_counter()
        log(f"== 20. ensemble_chain vs plain on the card (f32): the four arms "
            f"at H=1-600 and past the shared form, the edge cases, then two "
            f"R={ENS_REPLICAS} ticks of each arm at 600 hosts x 50 apps "
            f"(one of ticks {P20_SKIP}-{P20_SKIP + P20_WINDOW} and the "
            f"opening burst's), timed")
        log(f"  [{card}]")
        p20 = phase_chain(device, ck)
        walls[20] = time.perf_counter() - tp
        census_line(census, 20)
        log(f"  phase 20 wall: {walls[20]!r} s")
    if configs is not None:
        configs.uninstall()
    if oneshot is not None:
        oneshot.cleanup()
    census.uninstall()
    log(json.dumps({
        "times": times, "spans": spans, "ensemble": ens, "sweeps": sweeps,
        "search": search, "congestion": congestion, "serve": serve,
        "batching": batching, "mpc_recovery": p12, "native_guard": p13,
        "tooling": p14 and {k: v for k, v in p14.items()
                            if k not in ("costattr",)},
        "cost_attribution": p14 and p14["costattr"]["rows"],
        "sharding": p15, "replica_axis": p16, "mesh_2d": p17,
        "elastic": p18,
        "phase_walls": walls,
        "same_files": e2e and e2e["same_files"], "gated_times": gt,
        "sensitivity": sens and {p: {k: v for k, v in r.items()
                                     if k not in ("check", "cf_check")}
                                 for p, r in sens.items()},
        "carry_free": p19 and {k: v for k, v in p19.items()
                               if k != "check"},
        "ensemble_chain": p20 and {k: v for k, v in p20.items()
                                   if k != "check"}},
        default=str))

    # The kernels record; a number of a phase not run is null.
    ca = sens and sens["cost-aware"]
    lt = times and times["largest_tick"]
    errs = [x.max_abs_err for x in (
        chk, e2e and e2e["shadow"].check, e2e and e2e["referee"],
        ca and ca["check"], rows) if x is not None]
    if serve is not None:
        errs.append(serve["max_abs_err"])
    if batching is not None:
        errs.append(batching["max_abs_err"])
    if p12 is not None:
        errs.append(p12["max_abs_err"])
    if p13 is not None:
        errs.append(p13["max_abs_err"])
    if p14 is not None:
        errs.append(p14["max_abs_err"])
    if p15 is not None:
        errs.append(p15["max_abs_err"])
    if p16 is not None:
        errs.append(p16["max_abs_err"])
    if p17 is not None:
        errs.append(p17["max_abs_err"])
    sv = serve and [serve[k]["launches"] for k in SERVE_RUNS]
    sv_rows = sv and sum(sum(x["rows"].values()) for x in sv)
    sv_r1 = sv and sum(x["by_replicas"].get(1, 0) for x in sv)
    rt = serve and serve["a"]["rows_times"]
    st = batching and batching["flushes"]["rows_times"]
    b_r1 = batching and batching["launches_r1"]
    b_rows = batching and batching["launches_rows"]
    m_r1 = p12 and p12["launches_r1"]
    m_rows = p12 and p12["launches_rows"]
    n_r1 = p13 and p13["launches_r1"]
    n_rows = p13 and p13["launches_rows"]
    t_r1 = p14 and p14["launches_r1"]
    t_rows = p14 and p14["launches_rows"]
    r_r1 = p16 and p16["launches_r1"]
    r_rows = p16 and p16["launches_rows"]
    m2_r1 = p17 and p17["launches_r1"]
    m2_rows = p17 and p17["launches_rows"]
    w_r1 = p15 and p15["wide_launches"]
    pod = p15 and p15["greedy"]
    record = {"kernels": [{
        "name": "greedy_place",
        "route": "cuda",
        "source": "pivot_tpu_torch/csrc/greedy_place.cu",
        "replaces": "pivot_tpu/ops/pallas_kernels.py:265",
        "launches": (e2e and ca and serve and batching and p12 and p13
                     and p14 and p15 and p16 and p17
                     and e2e["runs"]["cuda"]["launches"]
                     + sum(ca["launches"].values()) + sv_rows + sv_r1
                     + b_r1 + b_rows + m_r1 + m_rows + n_r1 + n_rows
                     + t_r1 + p14["launches_r4"] + t_rows + w_r1 + r_r1
                     + r_rows + m2_r1 + m2_rows),
        "launches_r1": (e2e and ca and serve and batching and p12 and p13
                        and p14 and p15 and p16 and p17
                        and e2e["runs"]["cuda"]["launches"]
                        + ca["launches"][1] + sv_r1 + b_r1 + m_r1 + n_r1
                        + t_r1 + w_r1 + r_r1 + m2_r1),
        f"launches_r{SENS_REPLICAS}": ca and ca["launches"][SENS_REPLICAS],
        "launches_r4": p14 and p14["launches_r4"],
        "launches_rows": serve and batching and p12 and p13 and p14 and p16
        and p17
        and sv_rows + b_rows + m_rows + n_rows + t_rows + r_rows + m2_rows,
        "launches_rows_by_g": sv and batching and p12 and p13 and p14
        and p16 and p17 and {
            g: sum(x["rows"].get(g, 0) for x in sv)
            + sum(p["launches_rows_by_g"].get(g, 0)
                  for p in (batching, p12, p13, p14, p16, p17))
            for g in sorted({g for x in sv for g in x["rows"]}.union(
                *(p["launches_rows_by_g"]
                  for p in (batching, p12, p13, p14, p16, p17))))},
        "phase11_launches_r1": b_r1,
        "phase11_launches_rows": b_rows,
        "phase11_compare_launches_r1": batching
        and batching["compare_launches_r1"],
        "phase12_launches_r1": m_r1,
        "phase12_launches_rows": m_rows,
        "phase12_compare_launches": p12 and p12["compare_launches"],
        "phase13_launches_r1": n_r1,
        "phase13_launches_rows": n_rows,
        "phase13_compare_launches": p13 and p13["compare_launches"],
        "phase14_launches_r1": t_r1,
        "phase14_launches_r4": p14 and p14["launches_r4"],
        "phase14_launches_rows": t_rows,
        "phase15_launches": p15 and p15["launches"],
        "phase15_wide_launches_r1": w_r1,
        "phase15_compare_launches": p15 and p15["compare_launches"],
        "phase16_launches_r1": r_r1,
        "phase16_launches_rows": r_rows,
        "phase17_launches_r1": m2_r1,
        "phase17_launches_rows": m2_rows,
        "phase18_launches": p18 and p18["launches"],
        "max_abs_err": max(errs) if errs else None,
        "ms": lt and lt["ms"],
        "plain_ms": lt and lt["plain_ms"],
        "bound_ms": lt and lt["bound_ms"],
        "bound_by": lt and lt["bound_by"],
        "library_ms": None,
        f"r{SENS_REPLICAS}_ms": gt and gt["ms_median"],
        f"r{SENS_REPLICAS}_kernel_ms": gt and gt["kernel_ms_median"],
        "rows_ms": rt and rt["ms"],
        "rows_kernel_ms": rt and rt["kernel_ms"],
        "rows_plain_ms": rt and rt["plain_ms"],
        "rows_bound_ms": rt and rt["bound_ms"],
        "rows_bound_by": rt and rt["bound_by"],
        "span_rows_ms": st and st["ms"],
        "span_rows_kernel_ms": st and st["kernel_ms"],
        "span_rows_plain_ms": st and st["plain_ms"],
        "span_rows_bound_ms": st and st["bound_ms"],
        "span_rows_bound_by": st and st["bound_by"],
        "pod_tick": pod,
    }, cf_record(e2e, sens, p14, p15, p19),
        chain_record(ens, sweeps, search, congestion, p12, p20)]}
    log(f"  smoke wall: {time.perf_counter() - t_start!r} s")
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
