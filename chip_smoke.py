"""Drive the PyTorch/CUDA port on one NVIDIA card and check what comes out.

    python3 chip_smoke.py            # from the repository root; one CUDA card

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. Environment and build: the card's name and power limit, then every
   CUDA kernel library under ``photon_ml_tpu_torch/csrc/`` built from
   source with ``nvcc`` for sm_90a (one ``nvcc`` per library, all at
   once), with ptxas's registers and spills for each kernel.  The
   production SpMV instances (the row kernel's FULL instances for each
   lane group G, the column kernel's FULL instances and the combine
   kernel) and the window kernel must spill nothing.
2. Kernel against its plain PyTorch version, per operation, on three
   matrices: 2^20 x 8192 with 32 normal values a row (valued), the same
   shape with binary values (value-free layout), and 2^18 rows with an
   intercept column plus a zipf(1.1) column head (dense stripes engaged,
   long column segments just below the stripe threshold).  The row side
   (matvec, row_sq_matvec) runs the row kernel, the column side (rmatvec,
   sq_rmatvec) the row-blocked column kernel and its combine; the script
   prints G, R, the row blocks, the column ranges, the block table's and
   the scratch's bytes and the table's host build time.  Each operation
   must agree with the plain version to rtol 1e-5 on the scale
   Σ|f(v)·x| of each output, repeat bitwise, and keep an inf in the
   input local to the outputs whose segments hold it.  Times are the
   median of 50 launches under CUDA events, beside the byte bound, the
   plain version and one cuSPARSE call on the same CSR (a yardstick only;
   the port never calls it).  On the valued matrix the SpMV kernel's
   ablation modes (full, nogather, stream) are held to the same checks,
   and none may run faster than 0.95 x its byte bound (that would mean a
   load was optimised away).
3. The slice through the library boundary at full width: L2-logistic
   L-BFGS over a λ grid on the 2^20 x 8192 valued data (make_glm_data →
   GlmOptimizationProblem.run_grid → score → AUC), checked against the
   plain (COO) objective at the solution.
3b. The solvers at full width on phase 3's data (other losses: its
   features with labels drawn from the bench's w_true margins), value
   summed in float64: OWL-QN over a warm-started 3-λ logistic elastic-net
   grid whose largest λ puts α·λ at the median |∂f/∂w_j| at w = 0 (it must
   zero at least a tenth of the coefficients), and one L1 solve each for
   squared, Poisson and smoothed-hinge losses; TRON on L2 logistic at
   λ = 1; SPG on L2 logistic with a ±0.05 box on every coefficient.  Each
   solve: the objective never rises and ends lower; value and gradient at
   the solution match the plain objective (rtol 1e-5); OWL-QN converged,
   |∂f/∂w_j| ≤ 1.01·λ1 at every zero, and the objective decrease a
   diagonal Newton step on its pseudo-gradient would buy at most 1e-7 of
   the objective; TRON converged, its objective within 1e-5 of L-BFGS's at
   the same tolerance, its HVP matching the plain one; SPG inside its box
   exactly, converged or reporting ``stalled``, its projected gradient
   down to 0.1 of its start; one OWL-QN solve repeated bitwise.  Each
   OWL-QN and the SPG solve is rerun stopped after half its iterations,
   and that planted fault must fail its check.
   Launch counts are zeroed before and read after each solver (matvec and
   rmatvec must launch); evaluations and HVPs an iteration, the solve wall
   and its kernel time (launches x phase 2's kernel ms) are logged.
4. The slice through the driver: LIBSVM files with binary features in a
   temporary directory, ``glm_driver.run(... --device cuda)`` three times
   (L2 L-BFGS, ``--optimizer owlqn --reg-type elastic_net``, ``--solver
   tron --reg-type l2``), each saved model loaded back and its validation
   AUC recomputed on the host.
5. The experiments (``photon_ml_tpu_torch/experiments/``) through their
   entry points at full size (``g8192``, ``g8192_v2``, ``ablate`` mains),
   then the ELL kernel and its chain captured as a CUDA graph, and the
   window kernel, each against its plain version on the reference's data
   (2^20 x 32 entries from an 8192-wide w, seed 0): rtol 1e-5, bitwise
   repeats, the graph chain bitwise equal to the eager one, the window
   kernel against the ELL kernel when the layout spilled nothing, and its
   NaN and inf outputs where the plain version has them for a w with an
   inf read by padded slots and one at a live column; the window kernel's
   design (tile, ring stages, accumulator copies, grid) is logged; times
   beside the byte bounds and cuSPARSE on the same entries.

6. GAME coordinate descent through the port's ``game`` package at the full
   width of ``bench.py``'s ``bench_game_cd`` (640,155 rows: a 512-wide fixed
   effect with 8 normal values a row, a per-user random effect 8 wide over
   100,000 zipf(1.8) users capped at 128 rows, bucket growth 4, logistic,
   L2 λ = 1, 10 iterations at tolerance 1e-6) and ``bench_game_multi_re``
   (seed 3: per-user, per-item and per-context effects, the contexts capped
   at 256 active rows so passive rows exist).  Host build times, buckets and
   their (E, R), one warm iteration, one monitored run, then the median of
   2 timed runs of 3 iterations as GAME iterations/s, each coordinate's
   wall, Newton bodies and host reads an update.  Checks: the float64 GAME
   objective never rises between updates beyond 2^-22 of its value; a second
   run repeats every state and score bitwise; the scores equal a float64
   host re-score of the finalized model to rtol 1e-5 of Σ|x·w|, passive rows
   included; every random-effect lane its solver marks converged passes its
   relative gradient test recomputed in float64, and the same buckets
   stopped after one Newton body fail it; ``GameEstimator.fit`` with and
   without device metrics gives the same train AUC within 1e-6; the SpMV
   kernels launched and match their plain versions at the fixed effect's
   shape (phase 2's checks).

7. The GAME drivers at ``bench_game_cd``'s width: GAME Avro files written
   with the port's ``write_game_avro`` (640,155 training rows of 100,000
   zipf(1.8) users, a 512-wide global shard with 8 normal values a row, an
   8-wide dense per-user shard, labels from the logistic of a true fixed
   effect plus a per-user margin; 80,000 validation rows from the same
   users, 2 % from users the training rows never hold), then
   ``game_training_driver.run`` (fixed L-BFGS L2 + per-user random effect,
   3 iterations, validation after every update), a two-point per-user
   ``reg_weight`` grid (``fit_grid`` and its checkpointer, metrics on the
   card with ``--device-metrics``),
   ``game_scoring_driver.run`` on the validation file with the host and the
   device metric, and ``feature_indexing_driver.run``.  Checks: the native
   decoder read every file of the training and scoring runs (their
   results' ``decoders``/``decoder``), and the native score encoder wrote
   both scoring files (their ``encoder``); the host run's 80,000 rows
   written again through the native encoder and through the Python path
   (``PHOTON_NO_NATIVE=1``) give the scoring driver's file byte for byte,
   each write timed; the scoring driver's scores equal a float64 host
   re-score of the saved model (loaded back with ``load_game_model``) within
   1e-5 of Σ|x·w|, unseen users contributing 0; its AUC equals the training
   driver's validation metric and the device AUC within 1e-6; every
   per-update validation metric equals the suite on a float64 host re-score
   of that update's states within 1e-6; the final validation AUC exceeds the
   fixed effect's alone; the grid selects its better point (a resumed
   resident run's files are held byte-equal by 8d's factored run and 9c's
   retried run); the SpMV kernels
   launched in training and in validation scoring, and the row kernel
   matches its plain version at the validation shape (phase 2's checks).
   Read, build, descent, validation scoring, save and load times are
   logged from the drivers' own ``stage_seconds``; the script wraps only
   the validation scorers, to count their launches and copy the states
   they score for the per-update check.

8. The batched random-effect fallback (``optim/batched.py``) and the
   factored random effect (``game/factored.py``) at full width, each
   config with phase 6's protocol and checks and the fixed effect's L2
   L-BFGS on the SpMV kernels: 8a ``game_cd_l1``, the ``bench_game_cd``
   draw with the per-user effect (8 wide) under elastic net α = 0.5, λ = 1
   (every bucket, the rank-1 one included, batched OWL-QN); 8b
   ``game_cd_wide_re``, the same draw with the per-user effect over the
   512-wide ``global`` shard, L2 λ = 1, once with L-BFGS and once with TRON
   (8 buckets up to D = 461, the five with D > 32 on the fallback; buckets'
   (E, R, D) and bytes logged); 8c ``game_multi_re_factored``, the
   ``bench_game_multi_re`` draw with the fixed effect, ``per_user`` (8
   wide) and ``per_item`` factored over ``global`` (rank 8, 2
   alternations, projection λ 0.1, λ 1).  Checks, beside phase 6's: every
   fallback lane its solver marks converged passes its stopping test in
   float64 (L-BFGS and TRON the relative gradient test, or a decrement test
   for lanes stopped on the relative decrease; OWL-QN |g_j| ≤ 1.01·λ1 at
   zeros and the diagonal-Newton decrement ≤ 1e-7·F, with float32
   rounding allowances), the same buckets stopped where half those lanes
   are converged fail it, and 64 lanes a bucket re-solved one at a time by
   the single-problem solvers land on the batched lanes (float64 copies
   within 1e-9 of ‖w‖ with equal iterations, float32 lanes within 5e-3 of
   the largest ‖w‖); the factored projection gradient equals a float64
   host recompute from the sparse rows within 1e-5 of its terms' Σ|·| and
   repeats bitwise, and no projection step raises the float64 objective
   in V.  Bodies a bucket, host reads, line-search trials or CG steps an
   iteration, latent- and projection-step seconds and the L-BFGS
   iterations over V are logged.  8d: ``game_training_driver`` on phase 7's
   GAME Avro files with a per-user elastic-net effect, and with a per-user
   factored effect over ``global`` (rank 8) run through, killed for real
   right after iteration 1's checkpoint and ``--resume``d (model files
   byte-equal); the drivers' ``stage_seconds`` logged.

9. Out-of-core GLM training (``data/streaming.py``, ``data/prefetch.py``,
   ``optim/streaming.py``) at full width.  9a and 9b run right after 3b on
   phase 3's matrix (``bench_streaming``'s draw: 2^20 x 8192, 32 normal
   values a row, seed 0, logistic).  9a: the store as 4 kernel-layout
   chunks (and a memmap copy); one value+grad pass against phase 3's
   resident objective (rtol 1e-5 of Σ|terms|); bitwise: depth 1 = depth 2,
   fuse 2 = fuse 1, each row of a 3-candidate batch = its single
   evaluation, the memmap store = the RAM store; the Kahan value within
   1e-6 of a float64 host sum; timed passes at depths 1 and 2 (rows/s
   beside the resident pass, H2D GB/s over the copy stream's CUDA events,
   pack / h2d / consume ms and stalls a pass) and the SpMV launches of one
   pass under CUDA events; the 16-chunk oversubscribed leg with the
   lossless wire and a hot cache at 0.7 of the wire store, bitwise equal
   to the raw stream on three passes, and its timed passes; fp16 and int8
   decodes of one chunk on the card within the reference's per-slot
   bounds.  9b: phase 3's L2 L-BFGS grid streamed (each λ's objective
   within 1e-5 of phase 3's), phase 3b's elastic-net OWL-QN grid streamed
   (3b's KKT checks and refused half-runs), L-BFGS at λ = 1 one trial a
   pass and batched (the same iterations, bitwise the same w, no more
   passes) and TRON at λ = 1 within 1e-5 of it.  9c, after phase 8: the
   GLM driver's ``--stream-chunk-rows 32768 --stream-storage-dir`` on
   phase 4's files (L2 with ``--training-report``, elastic-net OWL-QN:
   each selects the resident run's λ, every saved model's AUC = a host
   re-score within 1e-6; the report carries every λ), ``--initial-model``
   from phase 4's L2 model (fewer iterations than cold, within 1e-5 of
   it), ``--max-retries 1`` with one ``UNAVAILABLE`` failure injected into
   the second λ's solve (model files byte-equal to the uninterrupted
   run's), and the GAME training driver with ``--max-retries 1`` and one
   failure after its first CD iteration on phase 7's files (model files
   byte-equal to phase 7's uninterrupted run).  The failures are injected
   by patching from this script, never from the program.

10. GAME out of core (``game/ooc_random.py``, ``game/ooc_factored.py``,
   ``game/streaming.py``) at full width, after 9c.  10a: on
   ``bench_game_multi_re``'s draw, per-user, per-item and per-context
   (passive rows) effects each out of core at an eighth of its host
   blocks' bytes (at least 8 pass groups and an entity-axis split each):
   bitwise in one plan (a repeat, depth 1 = depth 2, prestaged, a memmap
   dataset, a hot cache at half the static bytes over three updates with
   hits from the second), at most ``prefetch_depth`` groups live, and the
   resident coordinate within 1e-5 (coefficients) and 1e-4 (scores).  10d:
   the whole descent on that draw with the fixed effect streamed in chunks
   of 2^17 rows (L-BFGS, batched line search) and the three effects out of
   core: a warm iteration, 3 timed iterations (GAME iterations/s over the
   resident descent's, a warm iteration and 3 timed right after it, under
   the same load), the pipelined schedule bitwise the same, the
   float64 objective never rising beyond 2^-22, the final objective within
   1e-5 of the resident descent's, the scores equal to a float64 host
   re-score; then OWL-QN (elastic net), L-BFGS and TRON updates of the
   streamed fixed effect in float32, as the estimator builds it: each
   float64 objective within 1e-5 of the same solver's on the resident
   problem, TRON within 1e-5 of L-BFGS (9b's gap), 9b's KKT residuals
   logged.  10b: phase 8b's wide per-user
   effect (884 MB) at a quarter of its bytes: the device bytes out of core
   (the update's peak above its baseline) at most half the resident
   coordinate's (its dataset plus its update's peak), coefficients within
   5e-3 of the largest ||w||.  10c: phase 8c's factored ``per_item`` at a
   quarter of its bytes: no more device bytes held between passes than V
   and its gradient, the update's device bytes at most half the resident
   coordinate's (as 10b), bitwise repeat, the projection gradient against a
   float64 host recompute within 1e-5, no projection step raising the
   objective in V, coefficients and scores within 1e-4 (of the largest
   |w|, |score|) of the resident factored coordinate.  10e: the GAME
   training driver on phase 7's files with ``streaming_chunk_rows: 131072``
   and ``device_budget_mb`` at an eighth of the per-user blocks (3
   iterations, per-update validation; killed after 1 and resumed: the
   float64 objective of the resumed run's model within 1e-5 of phase 7's
   resident run's), and ``game_scoring_driver --stream-block-rows 65536``
   on the validation file (2 blocks): scores equal to the whole-file
   run's, the same AUC, and the per-block device logistic loss within 1e-6
   of the host one; every scoring file written by the native encoder; an
   uninterrupted out-of-core run's model files byte-equal to the resumed
   run's.  (Since phase 14 came, 10e no longer scores the training file:
   the script must stay inside its time limit.
   ``tests/test_torch_game_stream_io.py`` holds it on the CPU.)

11. Multi-device GLM (``parallel/``, ``solvers/{admm,block_cd,sharded}.py``)
   on one card.  11a, right after 9b on phase 3's matrix: consensus ADMM
   over 4 logical shards of 2^18 rows (each the kernel-backed matrix, held
   against its plain version with phase 2's checks) on 3b's elastic-net
   grid, scored beside 3b's OWL-QN by one float64 host evaluator (relative
   gap at most 1e-3), its reductions a solve against OWL-QN's evaluations
   a solve; then 3b's squared labels and L1 λ through the ridge x-update
   (a Gram matrix by one HVP a basis vector, one 8192 x 8192 eigh a
   shard).  11c, beside it: a one-rank NCCL process group (a FileStore in
   the script's temporary directory): ``run_grid_distributed`` on phase
   3's L2 grid bitwise the single-device grid (variances included), with
   as many all-reduces as evaluations and variance passes, and ADMM over
   the group bitwise ADMM on one logical shard.  11b, after phase 4: block
   CD over 4 logical shards on ``bench_solvers``' ill-conditioned dense
   draw at 2^17 x 512 (elastic net) within 1e-5 of the resident OWL-QN's
   float64 objective, its rounds, seconds and launches a round; then
   ``glm_driver --solver block_cd`` on phase 4's files, a few rounds a λ,
   as a route check (model written, AUC = host re-score within 1e-6).
   11c's driver check: ``glm_driver --data-parallel auto`` under a
   one-rank group writes phase 4's L2 model files byte for byte.

12. GAME and the streamed mesh over a process group
   (``game/{distributed,hierarchical}.py``, the group forms of the
   out-of-core coordinates and of ``optim/streaming.py``), after phase 10.
   12a, a one-rank NCCL group: the GAME training driver's group route on
   phase 7's files (the row-sharded fixed effect, the bucket-shard random
   effect) and the GLM driver's ``--stream-chunk-rows`` route (the rank's
   shard of every chunk, one all-reduce a pass) write phase 7's and phase
   9c's one-card model files byte for byte.  12b,
   ``experiments.multirank --game`` over a spawned gloo group of 4 ranks
   sharing the card at full width (646,253 rows), a process of its own
   started before phase 8 and read here (it builds its own draw): the
   per-user plan splits
   its costliest bucket and packs its cheapest; one descent iteration of
   the three random effects, every coefficient within 1e-6 of the largest
   |w| of one card's and every score within 1e-5 of its row's Σ|x·w|; the
   per-user effect out of core at 1/8 of its bytes at the same tolerances;
   the row-sharded fixed effect's float64 objective within 1e-5 of one
   card's; phase 9a's store sharded 4 ways, one all-reduce a pass, within
   1e-5 of Σ|terms| of the resident pass.  Its times are of four ranks
   sharing one card.  Then a rank's row block of the fixed effect and a
   part of the sharded store against their plain versions (phase 2's
   checks).
13. Online serving of phase 7's model, reusing phase 7's files (the saved
   model, the grid's model, the scoring driver's scores of the validation
   file); it trains nothing.  13a, the serving kernel
   (``csrc/serve_margins.cu``) against its plain version at every bucket
   of the 1..64 ladder for phase 7's geometry (fixed 512 + per-user 8)
   and ``bench_serving``'s (fixed 64 + per-entity 8), with the request
   side in HBM and read in place from page-locked host memory (the
   runtime's placement): margins bitwise the plain version's (and within
   1e-5 of Σ|x·w|), the two placements bitwise, two launches bitwise,
   every row of the full bucket bitwise the row alone, fused == composed,
   a hot row == the same row cold; times at buckets 1 and 64 in both
   placements beside the byte bound, the plain version and the same
   function as composed torch ops, and an empty kernel's (the launch
   floor).  13b, ``ScoringRuntime`` with
   a 4,096-row hot set over 100,000 users behind ``ScoringService`` and
   ``start_http_server``: all 80,000 validation rows in process, features
   named through the saved index maps, margins within 1e-5 of Σ|x·w| of
   the scoring driver's scores and the AUC within 1e-6 of its AUC; 512
   rows over HTTP JSON and the same over the binary wire, both bitwise the
   in-process scores; ``/healthz``, ``/readyz``, ``/stats``.  13c,
   ``POST /reload`` to the grid's model under a client's traffic (zero
   failed requests, version 2 bitwise a fresh runtime), then to a copy
   with one flipped payload byte (rolled back, zero failed requests).
   13d, a 5 s closed loop of 16 clients on ``bench_serving``'s model
   (50,000 entities, seed 9): requests/s, p50/p99, mean batch rows,
   hot-hit rate, zero errors.  No batch may score degraded; every
   breaker stays closed.  For both models, a bucket's round trip
   (``ScoringRuntime._launch`` on all-hot batches, host clock, median of
   200) at buckets 1, 8 and 64, and a ``torch.profiler`` trace of 100
   all-hot ``score_rows`` batches on ``bench_serving``'s model: exactly
   100 kernel launches, no memcpy.
14. The process and fleet tier and model freshness, after phase 13 (it
   reuses 13's model and requests; every process it starts is stopped,
   under a strict process-leak sentinel).  14a, a ``WorkerPool`` of two
   SPAWNED workers on the card over ``bench_serving``'s model, published
   once to shared memory: 4,096 requests bitwise the in-process runtime,
   each worker's launches folded into the parent, from after its warm-up,
   equal to its batches, the segments mapped once, no ``jax`` in a
   worker.  14b, ``ReplicaSupervisor(pool=..., n_replicas=2)`` under
   ``ScoringService`` through the ``worker_kill`` scenario at 240
   requests/s with a real SIGKILL of worker 0 (zero errors and
   rejections; p50/p99/p99.9 and the respawn seconds), then two
   in-process replicas through ``replica_kill``.  14d, a ``FleetRouter``
   over two ``LocalHost`` HTTP services with a ``QuotaCoordinator``: a
   ``serving.host`` fault marks a host down with zero failed requests, a
   ``quota.lease`` fault keeps the last lease, and ``ShmIngress`` scores
   bitwise the HTTP binary path.  14c, a delta of 1 % of phase 7's user
   rows written by ``DeltaPublisher`` and applied by ``swap_delta`` over
   a new 2-worker pool under load (zero failed requests; scores bitwise a
   fresh runtime on the patched model; seconds beside 13c's full reload),
   and a delta with a flipped segment byte rolled back at its load stage.

15. Tensor parallelism and tuning, last (phase 4's and phase 7's files).
   15a: phase 4's training matrix (2^17 x 8193 binary with the intercept),
   parsed once, as 2 x 2 logical tiles of 2^16 x 4097 (``parallel/
   tensor.py``; each tile its own kernel layout): phase 4's three
   configurations (L2 L-BFGS, elastic-net OWL-QN with the intercept
   exempt, L2 TRON) at each one's selected λ, value summed in float64,
   against the resident solve of the same problem: objective within 1e-5,
   padded column exactly 0, a repeat bitwise, 1 x 1 tiles bitwise the
   resident solve, OWL-QN's solution passing 3b's KKT test on the resident
   problem; one evaluation launches one matvec and one rmatvec a tile; tile
   (0, 0) against its plain version (phase 2's checks, bound, cuSPARSE).
   15b: ``python -m photon_ml_tpu_torch.tuning --driver glm`` (its
   ``main``) on phase 4's files, 8 trials, 4 workers, GP with ASHA: every
   trial's SpMV launches, tallied on its own thread, add up to the global
   count; the best trial's AUC equals a host re-score of its stored
   coefficients within 1e-6; the same search killed at the middle journal
   record and resumed gives the same trial history and decisions; a 6-λ
   grid with warm starts off gives bitwise equal coefficients with 4
   workers and with 1.  15c: ``--selfcheck`` on the card, then the GAME
   training driver's tuning mode on phase 7's files (Bayesian, 4
   evaluations of one CD iteration): 4 evaluations, the coordinates' reg
   weights, and the tuned metric equal to the final model's validation
   metric within 1e-6.
16. The ops plane and the fault sites on the card, after phase 15.  (a)
   phase 4's L2 driver run twice more under
   ``torch.cuda.set_sync_debug_mode("warn")``: once with ``--telemetry
   off``, once with the default ``--telemetry on`` and the live plane
   (``--metrics-port 0 --metrics-interval-s 0.25``); both
   write phase 4's model files byte for byte and make the same number of
   synchronizing calls (the telemetry reads nothing from the device); the
   two walls are logged side by side.  (b) During the second run a thread scrapes ``/metrics``
   (its port from the run's log) every 10 ms until the run ends:
   at least two scrapes parse, ``solver_iterations`` rises between them,
   ``metrics_ts.jsonl`` holds at least 2 monotone records and no
   exporter or sampler thread outlives the run.  (c) Phase 9c's streamed
   L2 run's ``metrics.json`` carries ``h2d_bytes_total`` and
   ``h2d_chunks_total`` equal to that run's transfer statistics.  (d)
   ``python -m photon_ml_tpu_torch.chaos --selfcheck`` (on the card) and
   ``python -m photon_ml_tpu_torch.telemetry --selfcheck``, side by side
   as subprocesses started before phase 15 (they run beside it): both
   exit 0, and each scenario's verdict and seconds are printed.
17. The cluster control plane (``photon_ml_tpu_torch/cluster``), after
   phase 16 and alone (17a's gates are timed).  17a, ``python -m
   photon_ml_tpu_torch.cluster --selfcheck`` on the card as a subprocess at
   the reference's sizes (64 entities, 150 requests/s offered, lease TTL
   1 s): it exits 0, and its gate lines are printed (the failover's
   seconds against 1.25 x the TTL, the old and new leader, each phase's
   admissions against its bound, the cold host bitwise).  17b, in process
   at phase 7's width: phase 7's saved model directory published as a
   snapshot into a fresh publication root and phase 14c's 1 % delta on top
   of it, the root served by ``PublicationServer``; a cold host with an
   empty cache runs ``cold_start`` over HTTP (every file's sha256 checked)
   and its ``RemoteApplier`` applies and acks the delta (fetch MB/s and
   cold-start seconds logged); it registers with a ``MembershipRegistry``
   through a ``HeartbeatAgent`` and a ``MembershipWatcher`` joins it into a
   ``FleetRouter`` beside a warm ``LocalHost`` serving the patched model;
   under phase 13's requests at an offered 240 requests/s
   (``host_join_drain``) the warm host is drained through the registry.
   Checks: zero failed requests and zero rejections through the join and
   the drain; 4,096 of phase 13's requests through the router after the
   drain bitwise a fresh runtime on the patched model; each host's
   ``serve_margins`` launches in the window equal its batches, and their
   sum the kernel's count; the aggregator marks the drained host departed.
   Every thread the phase starts is joined (a strict thread-leak
   sentinel) and the selfcheck's process has exited (a strict
   process-leak sentinel).
18. The port's static invariant checker and its metric lint, last, in
   process on the checkout this script runs from: ``python -m
   photon_ml_tpu_torch.analysis --check``'s rules over
   ``photon_ml_tpu_torch/`` and this script, and ``python -m
   photon_ml_tpu_torch.telemetry --lint-metrics``'s names.  Every file
   parses, no finding lies outside the committed baseline, no baseline
   entry is stale and every metric name conforms; the counts of files,
   rules and findings and the phase's seconds are printed.

Phase 7's GAME Avro files are written by a spawned process that starts
after phase 1 and runs beside phases 2-6; phase 7 waits for it.  Phase 4's
LIBSVM files are parsed by its own runs; every later driver run on them
(11b, 11c, 9c, 12a, 15, 16) reads the copies parsed once after phase 4.

Launch counts are zeroed just before each main-path run of phases 3, 3b,
4, 5, 6, 7, 8, 9, 10, 11, 12, 13 (13b, 13d), 14 (14a-14b's pool,
14b's in-process replicas, 14d's hosts, 14c's pool; each once its
runtimes have warmed up), 15 (each 15a solve, 15b's searches and grid,
15c's selfcheck and driver run), 16 (each of 16a's driver runs) and 17
(17b's join, drain and routed requests, once both hosts' runtimes have
warmed up and the cold host has applied its delta) and read just after;
every kernel those paths run must have launched.  A kernel record's ``launches`` sums its
main-path runs (phases 3, 3b, 9a, 9b and 11c's group runs for the valued
instances, 11a's for the ``.shard`` ones, phase 4's three runs, 11b's and
11c's driver runs, 9c's and 12a's GLM driver runs, 15a's resident
solves, 15b's searches and 16a's driver runs for the binary ones, 15a's tiled solves for the
``.tile`` ones,
phase 6's descents and estimator fits, phases 7's, 8's, 9c's and 12a's
training runs, phase 10's descents, streamed solves and training runs and
15c's tuning run for the ``.game`` records, phases 7's, 8's, 10e's and
15c's validation scoring for ``.game_val``, 12b's four ranks for
``.game_shard`` and ``.chunk_shard``; 13b's, 14c's and 17b's for
``serve_margins``, 13d's, 14a's, 14b's and 14d's for
``serve_margins.bench_serving``, every bucket).  The
serving counts must equal the batches scored in their window: a
worker's launches and batches fold into the parent's from its
heartbeats, and the warm-up buckets of a runtime built inside a window
(14b's respawned worker and restarted replica) are held apart.
The second-to-last line is the kernels' JSON record and the last line
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings

import numpy as np
import torch

N_ROWS = 1 << 20
N_FEATURES = 8192
NNZ_PER_ROW = 32
SKEW_ROWS = 1 << 18
DRIVER_TRAIN_ROWS = 1 << 17
DRIVER_VAL_ROWS = 1 << 15
GRID = (10.0, 1.0, 0.1)
# Phase 3b's relative solver tolerances.  OWL-QN stops on a relative
# objective decrease of tol·1e-2 as readily as on its pseudo-gradient, so it
# runs tighter.  Its KKT conditions: |g_j| ≤ λ1·(1 + KKT_ZERO) at the zeros,
# and the objective decrease that a diagonal Newton step on the whole
# pseudo-gradient would buy at most KKT_DECREMENT of F, 100 times the solve's
# own stopping decrease.  SPG's projected-gradient norm must fall to
# SPG_PG_DROP of its start even when it stops on its float32 value carry.
# The same solves stopped after half their iterations must fail these checks.
SOLVE_TOL = 1e-5
OWLQN_TOL = 1e-7
KKT_ZERO = 1e-2
KKT_DECREMENT = 1e-7
SPG_PG_DROP = 0.1
DRIVER_RUNS = (
    ("l2", ("--reg-type", "l2")),
    ("elastic_net", ("--optimizer", "owlqn", "--reg-type", "elastic_net")),
    ("tron", ("--solver", "tron", "--reg-type", "l2")),
)
N_TIMED = 50
RTOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor)
# FLOP/s.  A card set below 700 W runs slower than these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNEL_SOURCE = "photon_ml_tpu_torch/csrc/spmv.cu"
TPU_KERNEL = "photon_ml_tpu/ops/sparse_pallas.py:400"
ELL_SOURCE = "photon_ml_tpu_torch/csrc/ell_matvec.cu"
WINDOW_SOURCE = "photon_ml_tpu_torch/csrc/window_matvec.cu"
TPU_ELL = "experiments/exp_g8192.py:48"
TPU_ELL_CHAIN = "experiments/exp_g8192.py:93"
TPU_WINDOW = "experiments/exp_g8192_v2.py:76"
TPU_ABLATE = "experiments/exp_ablate.py:69"
OPS = ("matvec", "rmatvec", "row_sq_matvec", "sq_rmatvec")
DEVICE = "cuda"
# Phase 6: bench.py's GAME configurations at full width.
GAME_ENTITIES = 100_000
GAME_FIXED_FEATURES = 512
GAME_FIXED_NNZ = 8
GAME_RE_DIM = 8
GAME_ROW_CAP = 128
GAME_BUCKET_GROWTH = 4.0
GAME_TIMED_ITERS = 3
GAME_TIMED_RUNS = 2
# Phase 7: the GAME drivers at bench_game_cd's width, with a validation
# file of GAME_VAL_ROWS rows (GAME_VAL_UNSEEN of them from unseen users).
GAME_VAL_ROWS = 80_000
GAME_VAL_UNSEEN = 0.02
GAME_UNSEEN_USERS = 2000
GAME_DRIVER_ITERS = 3
GAME_GRID_RE_WEIGHTS = (1.0, 1e4)
# The GAME objective (float64) may rise between updates by at most this
# fraction of its value: the float32 value sum that the fixed effect's line
# search decides on rounds at ~6e-8 of it.
GAME_OBJ_RISE = 2.0 ** -22
# Phase 9: the streamed store's chunks, the oversubscribed leg's chunks and
# its hot cache's share of the wire store (bench.py:79-80), timed passes.
STREAM_CHUNKS = 4
STREAM_OVERSUB_CHUNKS = 16
STREAM_HOT_FRACTION = 0.7
STREAM_TIMED_PASSES = 5
STREAM_DRIVER_CHUNK_ROWS = 32768


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


#: Phase 12b's process group while it may share the host and the card
#: with the phases it runs beside (see :func:`phase_header`).
BESIDE_GROUP = {"proc": None}
BESIDE_MARK = " [beside 12b's group]"


def log(msg: str) -> None:
    if BESIDE_GROUP["proc"] is not None:
        msg += BESIDE_MARK
    print(msg, flush=True)


#: The script's start on the host's clock (set again by :func:`main`).
T_START = time.perf_counter()


def log_phase(msg: str) -> None:
    """A line with the script's seconds so far."""
    log(f"{msg} [at {time.perf_counter() - T_START:.1f} s]")


def phase_header(msg: str) -> None:
    """A phase's or sub-phase's first line.  Every line from the start of
    phase 12b's group to the first header after it exited carries
    BESIDE_MARK: its timings were taken beside the group, or (for a
    sub-phase the group's exit fell into) partly so."""
    proc = BESIDE_GROUP["proc"]
    if proc is not None and proc.poll() is not None:
        BESIDE_GROUP["proc"] = None
        log_phase(f"phase 12b's group has exited (exit {proc.returncode})")
    log_phase(msg)


# -- data -----------------------------------------------------------------


def bench_triples(seed=0):
    """The primary GLM throughput workload: 2^20 rows x 8192 features, 32
    normal-valued entries a row, labels from a sparse logistic model."""
    rng = np.random.default_rng(seed)
    nnz = N_ROWS * NNZ_PER_ROW
    rows = np.repeat(np.arange(N_ROWS, dtype=np.int64), NNZ_PER_ROW)
    cols = rng.integers(0, N_FEATURES, size=nnz).astype(np.int64)
    vals = rng.normal(size=nnz).astype(np.float32)
    w_true = (rng.normal(size=N_FEATURES)
              * (rng.uniform(size=N_FEATURES) < 0.2)).astype(np.float32)
    margins = np.zeros(N_ROWS, np.float32)
    np.add.at(margins, rows, vals * w_true[cols])
    y = (rng.uniform(size=N_ROWS) < 1 / (1 + np.exp(-margins))).astype(
        np.float32)
    return rows, cols, vals, y, margins


def binary_rows(rng, n, d, k):
    """(rows, cols) of n rows with about k distinct features each."""
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    keys = np.sort(rows * d + rng.integers(0, d, size=n * k))
    # np.unique's values, by one sort: numpy 2.3 finds them through a hash
    # table, ~20x slower on 2^25 mostly distinct keys.
    keys = keys[np.concatenate(([True], keys[1:] != keys[:-1]))]
    return keys // d, keys % d


def skewed_triples(seed=2):
    """2^18 rows: a constant intercept column plus 31 entries a row drawn
    from a zipf(1.1) column head, normal values."""
    rng = np.random.default_rng(seed)
    n, k = SKEW_ROWS, NNZ_PER_ROW - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = np.minimum(rng.zipf(1.1, size=n * k) - 1, N_FEATURES - 2)
    vals = rng.normal(size=n * k).astype(np.float32)
    rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols, np.full(n, N_FEATURES - 1, np.int64)])
    vals = np.concatenate([vals, np.ones(n, np.float32)])
    return rows, cols, vals, n


# -- timing ---------------------------------------------------------------


def median_ms(fn, n=N_TIMED):
    """Median device time of one call (CUDA events around each call, the
    host's launches queued behind a device-side sleep)."""
    from photon_ml_tpu_torch.utils.timer import median_ms as timer_median_ms

    return timer_median_ms(fn, DEVICE, n)


def wall_ms(fn, n=20):
    """Median host-clock time of one call of ``fn`` from an idle device to
    its end (synchronize before and after): unlike :func:`median_ms`, the
    host's launch cost is inside the span whenever the device waits on it."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def bytes_bound(nbytes, flops=0):
    """Least time for work that moves ``nbytes`` through HBM and does
    ``flops`` f32 operations: (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(n_out, n_in, nnz, unit, square):
    """Least time for one SpMV: indptr, idx (and val) and x read once, y
    written once, against the HBM rate; f(v)·x and the add against the
    f32 rate.  Returns (ms, "bytes" | "operations")."""
    nbytes = 8 * (n_out + 1) + nnz * (4 if unit else 8) + 4 * n_in + 4 * n_out
    flops = nnz * (1 if unit else (3 if square else 2))
    return bytes_bound(nbytes, flops)


def ptxas_kernels(lines):
    """[(kernel, registers, spill bytes)] from ``nvcc -Xptxas -v`` lines."""
    out, entry, spill = [], None, 0
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.append((entry, int(m.group(1)), spill))
            entry = None
    return out


def demangle(names):
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt or not names:
        return list(names)
    res = subprocess.run([cxxfilt], input="\n".join(names),
                         capture_output=True, text=True)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


# -- phases ---------------------------------------------------------------


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); python {sys.version.split()[0]}"
        f", torch {torch.__version__}, cuda {torch.version.cuda}")
    from photon_ml_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build_libraries()
    log(f"kernel builds: {len(_kernels.BUILD_INFO)} libraries in "
        f"{time.perf_counter() - t0:.2f} s, one nvcc each, in parallel")
    # The FULL (mode 0) instances: 3 (UNIT, SQUARE) row and column
    # instances for each lane group, and the combine kernel.
    production = {"row": r"spmv_rows_kernelILi\d+ELi0E",
                  "column": r"spmv_cols_kernelILi\d+ELi0E",
                  "combine": r"spmv_combine_kernel"}
    expected = {"row": 3 * len(_kernels.GROUPS),
                "column": 3 * len(_kernels.GROUPS), "combine": 1}
    found = {kind: [] for kind in production}
    for name, info in _kernels.BUILD_INFO.items():
        log(f"  {name}: {'built' if info['built'] else 'cached'} "
            f"{info['path']} ({info['seconds']:.2f} s)")
        kernels = ptxas_kernels(info["ptxas"])
        check(bool(kernels), f"{name}: no ptxas register lines in the build")
        for (mangled, regs, spill), pretty in zip(
                kernels, demangle([k[0] for k in kernels])):
            log(f"    {pretty}: {regs} registers, {spill} bytes of spill")
            for kind, pattern in production.items():
                if name == "spmv" and re.search(pattern, mangled):
                    found[kind].append((pretty, regs, spill))
    for kind, n in expected.items():
        check(len(found[kind]) == n, f"expected {n} production spmv {kind} "
              f"instances, found {len(found[kind])}")
        check(all(spill == 0 for _, _, spill in found[kind]),
              f"a production spmv {kind} instance spills")
        log(f"production spmv {kind} instances: registers "
            f"{[regs for _, regs, _ in found[kind]]}, no spill")
    window = [k for k in ptxas_kernels(
        _kernels.BUILD_INFO["window_matvec"]["ptxas"])
        if "window_matvec_kernel" in k[0]]
    check(len(window) == 1, f"expected one window_matvec_kernel in the "
          f"window_matvec build, found {len(window)}")
    check(window[0][2] == 0, "window_matvec_kernel spills")
    log(f"window_matvec_kernel: {window[0][1]} registers, no spill")
    # One instance per register tier KF (fixed columns a lane holds).
    serve = [k for k in ptxas_kernels(
        _kernels.BUILD_INFO["serve_margins"]["ptxas"])
        if "serve_margins_kernel" in k[0]]
    check(len(serve) == len(SERVE_TIERS) and all(k[2] == 0 for k in serve),
          f"serve_margins_kernel: expected {len(SERVE_TIERS)} instances "
          f"without spill, found {serve}")
    log(f"serve_margins_kernel: registers "
        f"{[(p, r) for (_, r, _), p in zip(serve, demangle([k[0] for k in serve]))]}"
        f", no spill")
    return smi


def _side(M, op):
    """(indptr, idx, val, n_in, t_indptr, t_idx) of ``op``'s CSR and of
    the transposed one (for the inf probe)."""
    if op in ("matvec", "row_sq_matvec"):
        return M.f_indptr, M.f_idx, M.f_val, M.n_cols, M.b_indptr, M.b_idx
    return M.b_indptr, M.b_idx, M.b_val, M.n_rows, M.f_indptr, M.f_idx


def spmv_kernel(M, op, v):
    """``op``'s kernel on M's streamed entries (no dense stripes)."""
    from photon_ml_tpu_torch.ops import _kernels

    sq = "sq" in op
    if op in _kernels.ROW_OPS:
        return _kernels.spmv_rows(M.f_indptr, M.f_idx, M.f_val, v,
                                  group=M.row_group, n_in=M.n_cols, op=op,
                                  unit=M.unit_vals, square=sq)
    return _kernels.spmv_cols(M.b_blockptr, M.b_idx, M.b_val, v,
                              group=M.col_group, n_in=M.n_rows, op=op,
                              unit=M.unit_vals, square=sq)


def describe_layout(label, M):
    """Log the two kernels' layout parameters; rebuild the block table on
    the host to time it and check it is the matrix's."""
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.ops.sparse_cuda import row_block_table

    b_indptr, b_idx = M.b_indptr.cpu().numpy(), M.b_idx.cpu().numpy()
    t0 = time.perf_counter()
    table = row_block_table(b_indptr, b_idx, M.n_rows)
    table_s = time.perf_counter() - t0
    check(np.array_equal(table, M.b_blockptr.cpu().numpy()),
          f"{label}: block table differs from a host rebuild")
    n_rb = table.shape[1] - 1
    ranges = _kernels.col_ranges(M.col_group, M.n_cols, M.n_rows)
    log(f"  {label} layout: G={M.row_group} lanes a row (mean streamed row "
        f"{M.f_idx.shape[0] / M.n_rows:.2f} entries); R={_kernels.ROW_BLOCK}"
        f" rows a block, n_rb={n_rb}, {M.col_group} lanes a column "
        f"sub-range, {ranges} column ranges (grid {n_rb * ranges} CTAs; x "
        f"restaged {ranges} times, {ranges * 4 * M.n_rows} bytes from L2), "
        f"block table {table.nbytes} bytes, partial scratch "
        f"{n_rb * M.n_cols * 4 if n_rb > 1 else 0} bytes, table host build "
        f"{table_s:.3f} s")


def kernel_vs_plain(label, M, gen):
    """Phase 2 for one matrix: every op against its plain version, bitwise
    repeat, inf localization, and timings.  Returns {op: record}."""
    from photon_ml_tpu_torch.ops import _kernels

    unit = M.unit_vals
    describe_layout(label, M)
    out = {}
    for op in OPS:
        indptr, idx, val, n_in, t_indptr, t_idx = _side(M, op)
        sq = "sq" in op
        n_out, nnz = indptr.shape[0] - 1, idx.shape[0]
        x = torch.randn(n_in, device=DEVICE, generator=gen)

        def kernel(v=x):
            return spmv_kernel(M, op, v)

        def plain(v=x):
            return _kernels.spmv_plain(indptr, idx, val, v, unit=unit,
                                       square=sq)

        y, y2 = kernel(), kernel()
        ref = plain()
        scale = _kernels.spmv_plain(indptr, idx, None if unit else val.abs(),
                                    x.abs(), unit=unit, square=sq)
        torch.cuda.synchronize()
        check(torch.equal(y, y2), f"{label} {op}: two launches differ")
        err = (y - ref).abs()
        check(bool((err <= RTOL * scale).all()),
              f"{label} {op}: kernel vs plain beyond rtol {RTOL}")

        # inf probe: the input with the longest transposed segment.
        seg = t_indptr[1:] - t_indptr[:-1]
        j = int(torch.argmax(seg))
        touched = torch.zeros(n_out, dtype=torch.bool, device=DEVICE)
        touched[t_idx[int(t_indptr[j]):int(t_indptr[j + 1])].long()] = True
        x_inf = x.clone()
        x_inf[j] = float("inf")
        y_inf = kernel(x_inf)
        check(int(touched.sum()) > 0
              and bool((~torch.isfinite(y_inf[touched])).all())
              and torch.equal(y_inf[~touched], y[~touched]),
              f"{label} {op}: inf at input {j} leaked or vanished")

        # cuSPARSE on the same CSR (int32 indices, f(v) precomputed).
        lib_vals = (torch.ones(nnz, device=DEVICE) if unit
                    else (val * val if sq else val))
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(indptr.to(torch.int32), idx,
                                        lib_vals, size=(n_out, n_in),
                                        check_invariants=False)
        lib = torch.mv(A, x)
        torch.cuda.synchronize()
        check(bool(((lib - ref).abs() <= RTOL * scale).all()),
              f"{label} {op}: library yardstick disagrees")

        ms = median_ms(kernel)
        plain_ms = median_ms(plain)
        library_ms = median_ms(lambda: torch.mv(A, x))
        bound_ms, bound_by = bound(n_out, n_in, nnz, unit, sq)
        rec = dict(max_abs_err=float(err.max()) if nnz else 0.0, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   longest_segment=int((indptr[1:] - indptr[:-1]).max()))
        out[op] = rec
        log(f"  {label:8s} {op:14s} ok  kernel {ms:.4f} ms "
            f"({bound_ms / ms:.1%} of the {bound_by} bound {bound_ms:.4f} ms)"
            f"  plain {plain_ms:.4f} ms  cuSPARSE {library_ms:.4f} ms  "
            f"max|err| {rec['max_abs_err']:.3g}  "
            f"longest segment {rec['longest_segment']}  inf@{j} -> "
            f"{int(touched.sum())} outputs")
        del A, lib_vals
    return out


def phase_kernels(bench):
    from photon_ml_tpu_torch.ops.sparse_cuda import build_cuda_matrix

    rows, cols, vals, _, _ = bench
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    results = {}
    rng = np.random.default_rng(1)
    b_rows, b_cols = binary_rows(rng, N_ROWS, N_FEATURES, NNZ_PER_ROW)
    s_rows, s_cols, s_vals, s_n = skewed_triples()
    variants = (
        ("valued", rows, cols, vals, N_ROWS),
        ("binary", b_rows, b_cols, np.ones(len(b_rows), np.float32), N_ROWS),
        ("skewed", s_rows, s_cols, s_vals, s_n),
    )
    for label, r, c, v, n in variants:
        t0 = time.perf_counter()
        M = build_cuda_matrix(r, c, v, n, N_FEATURES, device=DEVICE)
        torch.cuda.synchronize()
        log(f"{label}: {n} x {N_FEATURES}, {M.f_idx.shape[0]} streamed "
            f"entries, {M.dense_col_ids.shape[0]} column / "
            f"{M.dense_row_ids.shape[0]} row stripes, unit={M.unit_vals}, "
            f"host build {time.perf_counter() - t0:.1f} s")
        check(M.unit_vals == (label == "binary"), f"{label}: unit detection")
        if label == "skewed":
            check(M.has_dense_cols, "skewed: no dense column stripes")
        results[label] = kernel_vs_plain(label, M, gen)
        if label == "valued":
            results["ablate"] = ablation_vs_plain(M)
        del M
        torch.cuda.empty_cache()
    return results


def ablation_vs_plain(M):
    """Phase 2 on the valued matrix: each ablation mode of the SpMV kernel
    against its plain version for matvec (CSR) and rmatvec (CSC), bitwise
    repeat, and its time against its own byte bound.  Returns
    {(mode, op): record}."""
    from photon_ml_tpu_torch.experiments import ablate

    out = {}
    for op in ablate.OPS:
        indptr, idx, val, n_in, layout = ablate.side(M, op)
        x = ablate.operand(M, op)
        n_out, nnz = indptr.shape[0] - 1, idx.shape[0]
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(indptr.to(torch.int32), idx, val,
                                        size=(n_out, n_in),
                                        check_invariants=False)
        library = {
            "full": lambda: torch.mv(A, x),
            "nogather": None,  # no one PyTorch call reads x at k mod n_in
            "stream": lambda: torch.segment_reduce(val, "sum",
                                                   offsets=indptr),
        }
        for mode in ablate.MODES:
            def kernel(mode=mode):
                return ablate.spmv_ablate(mode, indptr, idx, val, x, n_in, op,
                                          **layout)

            def plain(mode=mode):
                return ablate.spmv_ablate_plain(mode, indptr, idx, val, x,
                                                n_in)

            y, y2 = kernel(), kernel()
            ref = plain()
            scale = ablate.spmv_ablate_plain(mode, indptr, idx, val.abs(),
                                             x.abs(), n_in)
            torch.cuda.synchronize()
            label = f"ablate {mode} {op}"
            check(torch.equal(y, y2), f"{label}: two launches differ")
            err = (y - ref).abs()
            check(bool((err <= RTOL * scale).all()),
                  f"{label}: kernel vs plain beyond rtol {RTOL}")
            # stream moves indptr, idx, val and y; the other modes x too.
            nbytes = 8 * (n_out + 1) + 8 * nnz + 4 * n_out
            if mode != "stream":
                nbytes += 4 * n_in
            bound_ms, bound_by = bytes_bound(
                nbytes, nnz * (1 if mode == "stream" else 2))
            ms = median_ms(kernel)
            rec = dict(max_abs_err=float(err.max()), ms=ms,
                       plain_ms=median_ms(plain),
                       library_ms=(median_ms(library[mode])
                                   if library[mode] else None),
                       bound_ms=bound_ms, bound_by=bound_by)
            check(ms >= 0.95 * bound_ms,
                  f"{label}: {ms:.4f} ms is below 0.95 x its {bound_by} "
                  f"bound {bound_ms:.4f} ms: a load was optimised away")
            out[mode, op] = rec
            lib_txt = ("none" if rec["library_ms"] is None
                       else f"{rec['library_ms']:.4f} ms")
            log(f"  {label:22s} ok  kernel {ms:.4f} ms ({bound_ms / ms:.1%} "
                f"of the {bound_by} bound {bound_ms:.4f} ms)  plain "
                f"{rec['plain_ms']:.4f} ms  library {lib_txt}  max|err| "
                f"{rec['max_abs_err']:.3g}")
        t = {mode: out[mode, op]["ms"] for mode in ablate.MODES}
        log(f"  ablation {op}: full - nogather = "
            f"{t['full'] - t['nogather']:.4f} ms (the dependent gather of "
            f"x), nogather - stream = {t['nogather'] - t['stream']:.4f} ms "
            f"(reading x at all), stream = {t['stream']:.4f} ms (indptr, "
            f"idx, val and y)")
        del A
    return out


def phase_library(bench):
    """Phase 3: make_glm_data → run_grid → score → AUC at full width."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.evaluation.evaluators import (
        AreaUnderROCCurveEvaluator,
    )
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    rows, cols, vals, y, _ = bench
    X = sp.csr_matrix((vals, (rows, cols)), shape=(N_ROWS, N_FEATURES))
    t0 = time.perf_counter()
    data = make_glm_data(X, y, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"library: make_glm_data {N_ROWS} x {N_FEATURES} in "
        f"{build_s:.1f} s ({type(data.features).__name__})")
    problem = GlmOptimizationProblem(
        "logistic",
        GlmOptimizationConfig(
            optimizer=OptimizerConfig(max_iters=30),
            regularization=RegularizationContext.l2(),
            compute_variances=True,
        ),
    )
    evaluator = AreaUnderROCCurveEvaluator()
    y_host = np.asarray(y)

    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    grid = problem.run_grid(data, list(GRID))
    aucs = {lam: evaluator.evaluate(
        model.compute_score(data).cpu().numpy(), y_host)
        for lam, model, _ in grid}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    iters = sum(res.iterations for _, _, res in grid)
    for lam, model, res in grid:
        vals_h = res.values.numpy()[: res.iterations + 1].astype(np.float64)
        check(bool(np.all(np.diff(vals_h) <= 0)),
              f"library λ={lam}: objective rose")
        check(vals_h[-1] < vals_h[0] or res.iterations == 0,
              f"library λ={lam}: objective did not decrease")
        var = model.coefficients.variances
        check(var is not None and bool(torch.isfinite(var).all())
              and bool((var > 0).all()), f"library λ={lam}: variances")
        log(f"library λ={lam:g}: iterations {res.iterations}, converged "
            f"{res.converged}, value {vals_h[0]:.6g} -> {vals_h[-1]:.6g}, "
            f"wall {problem.grid_wall_seconds[lam]:.3f} s, "
            f"AUC {aucs[lam]:.6f}")
    best = max(aucs, key=aucs.get)
    check(aucs[best] > 0.5, f"library: AUC {aucs[best]} not above 0.5")
    log(f"library: selected λ={best:g} (AUC {aucs[best]:.6f}); grid wall "
        f"{wall:.3f} s, {iters} iterations; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"library launches: {json.dumps(launches)} "
        f"({launches['matvec'] / max(iters, 1):.2f} matvec and "
        f"{launches['rmatvec'] / max(iters, 1):.2f} rmatvec per iteration)")
    for op in ("matvec", "rmatvec", "sq_rmatvec"):
        check(launches[op] > 0, f"library: {op} never launched")

    # The kernel path's objective against the plain (COO) one at the
    # selected solution.
    w = [m for lam, m, _ in grid if lam == best][0].coefficients.means
    plain_data = make_glm_data(X, y, use_kernel=False, device=DEVICE)
    obj = problem.objective
    F = plain_data.features
    abs_F = type(F)(F.row_ids, F.col_ids, F.values.abs(), F.n_rows, F.n_cols)
    val_err, grad_err = objective_vs_plain(obj, w, data, plain_data, best,
                                           abs_F)
    check(val_err <= RTOL, f"library: value vs plain {val_err:.3g}")
    check(grad_err <= RTOL, f"library: gradient vs plain {grad_err:.3g}")
    log(f"library: value_and_grad vs plain at the solution: value rel err "
        f"{val_err:.3g}, gradient err {grad_err:.3g} of Σ|x·u|")

    # Primary metric: rows per second of one value+grad pass.
    ms = median_ms(lambda: obj.value_and_grad(w, data, best), n=20)
    log(f"library: value+grad pass {ms:.4f} ms = "
        f"{N_ROWS / (ms / 1e3):.4g} rows/s")
    values = {lam: float(res.values[res.iterations]) for lam, _, res in grid}
    return launches, dict(rows_per_s=N_ROWS / (ms / 1e3),
                          grid_wall_s=wall, iterations=iters,
                          build_s=build_s, grid_values=values), (
        data, plain_data, abs_F, X)


def objective_vs_plain(obj, w, data, plain_data, l2, abs_F):
    """The kernel path's value and gradient at ``w`` against the plain
    (COO) objective's: (value error relative to Σ|weight·ℓ| + ½·l2·‖w‖²,
    the largest gradient error relative to its Σ|x·u| + l2·|w|).
    ``abs_F`` is the COO matrix of |x|."""
    val_k, grad_k = obj.value_and_grad(w, data, l2)
    val_p, grad_p = obj.value_and_grad(w, plain_data, l2)
    m = obj.margins(w, plain_data)
    labels, weights = plain_data.labels, plain_data.weights
    vscale = (weights * obj.loss.value(m, labels)).abs().sum() + (
        0.5 * l2 * torch.dot(w, w))
    u = (weights * obj.loss.d1(m, labels)).abs()
    gscale = abs_F.rmatvec(u) + l2 * w.abs()
    val_err = abs(float(val_k) - float(val_p)) / float(vscale)
    grad_err = float(((grad_k - grad_p).abs() / gscale.clamp_min(1e-30))
                     .max())
    return val_err, grad_err


def pseudo_gradient_host(w, g, l1):
    """OWL-QN's pseudo-gradient of f + l1·‖w‖₁ on the host, in float64:
    its entries are the KKT violations (g_j + l1·sign(w_j) on the support,
    max(|g_j| − l1, 0) at zeros)."""
    w, g = (t.double().cpu().numpy() for t in (w, g))
    return np.where(w != 0, g + l1 * np.sign(w),
                    np.sign(g) * np.maximum(np.abs(g) - l1, 0.0))


def kkt_residuals(res, obj, d, l1, l2, mask=None):
    """(max |g_j|/λ1 over the zeros, max |g_j + λ1·sign(w_j)|/λ1 over the
    support, Σ_j pg_j²/(2·H_jj) / |F|) at res.w: pg is the pseudo-gradient
    and H_jj = Σ_i x_ij²·ℓ''_i + l2 the smooth part's diagonal curvature,
    so the last is the objective decrease that a diagonal Newton step on
    the residual would buy, relative to F.  ``mask`` (host, 0 at exempt
    coordinates such as the intercept) scales λ1 per coordinate."""
    f, g = obj.value_and_grad(res.w, d, l2)
    hdiag = d.features.sq_rmatvec(obj.d2_weights(res.w, d)) + l2
    w, g = res.w.double().cpu().numpy(), g.double().cpu().numpy()
    if mask is None:
        f_all = float(f) + l1 * float(res.w.double().abs().sum())
        l1v = l1
    else:
        l1v = l1 * np.asarray(mask, np.float64)
        f_all = float(f) + float((l1v * np.abs(w)).sum())
    hdiag = hdiag.double().cpu().numpy()
    pg = pseudo_gradient_host(res.w, torch.as_tensor(g), l1v)
    zero = w == 0
    at_zero = float((np.abs(g[zero]) / l1).max(initial=0.0))
    l1s = l1v if mask is None else l1v[~zero]
    support = float((np.abs(g[~zero] + l1s * np.sign(w[~zero])) / l1)
                    .max(initial=0.0))
    dec = float((pg * pg / (2 * np.maximum(hdiag, 1e-30))).sum()
                / abs(f_all))
    return at_zero, support, dec


def kkt_holds(residuals):
    at_zero, _, dec = residuals
    return at_zero <= 1 + KKT_ZERO and dec <= KKT_DECREMENT


def solver_labels(margins, seed=5):
    """Labels for the other losses from the bench's own w_true margins
    (numpy, seeded): squared loss margin + N(0, 1) noise; Poisson counts at
    exp(0.25·margin), far from overflowing exp; smoothed hinge {0, 1} (the
    loss maps them to ±1) from the sign of margin + noise."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=margins.shape).astype(np.float32)
    return {
        "linear": margins + noise,
        "poisson": rng.poisson(np.exp(0.25 * margins)).astype(np.float32),
        "smoothed_hinge": (margins + noise > 0).astype(np.float32),
    }


def phase_solvers(data, plain_data, abs_F, margins, kern):
    """Phase 3b: OWL-QN, TRON and SPG through GlmOptimizationProblem at full
    width on phase 3's data (other losses: its features with new labels).
    Returns ({op: launches}, {solver: record}, {(name, λ): w} of the
    elastic-net grid's and the squared L1 solve's OWL-QN solutions, which
    phase 11a scores beside ADMM's)."""
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    t_phase = time.perf_counter()
    kernel_ms = {op: kern["valued"][op]["ms"] for op in OPS}
    total = {op: 0 for op in OPS}
    records = {}
    solutions = {}

    def problem(task, reg, optimizer=OptimizerType.LBFGS, tol=SOLVE_TOL,
                max_iters=100):
        # The value summed in float64 (the driver's --precise-accumulation):
        # a float32 sum over 2^20 rows rounds at ~1e-7 relative, which is
        # where these tolerances' decisions are taken.
        return GlmOptimizationProblem(task, GlmOptimizationConfig(
            optimizer=OptimizerConfig(optimizer=optimizer,
                                      max_iters=max_iters, tolerance=tol),
            regularization=reg), accumulate="f64")

    def with_labels(task):
        if task == "logistic":
            return data, plain_data
        y = torch.as_tensor(labels[task], device=DEVICE)
        return (dataclasses.replace(data, labels=y),
                dataclasses.replace(plain_data, labels=y))

    def run(name, fn):
        """One solver's main-path run under zeroed launch counters."""
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {op: _kernels.LAUNCHES[op] for op in OPS}
        for op in OPS:
            total[op] += launches[op]
        check(launches["matvec"] > 0 and launches["rmatvec"] > 0,
              f"solvers {name}: matvec/rmatvec never launched")
        k_ms = sum(launches[op] * kernel_ms[op] for op in OPS)
        log(f"solvers {name}: wall {wall:.3f} s, kernel time "
            f"{k_ms / 1e3:.3f} s (launches x phase-2 kernel ms), launches "
            f"{json.dumps({op: n for op, n in launches.items() if n})}")
        return out, launches, wall, k_ms

    def check_solve(name, res, obj, d, pd, l2):
        v = res.values.numpy()[: res.iterations + 1].astype(np.float64)
        check(bool(np.all(np.diff(v) <= 0)), f"solvers {name}: objective rose")
        check(res.iterations > 0 and v[-1] < v[0],
              f"solvers {name}: objective did not decrease")
        val_err, grad_err = objective_vs_plain(obj, res.w, d, pd, l2, abs_F)
        check(val_err <= RTOL and grad_err <= RTOL,
              f"solvers {name}: kernel vs plain value {val_err:.3g}, "
              f"gradient {grad_err:.3g}")
        log(f"solvers {name}: value_and_grad vs plain at the solution: "
            f"value rel err {val_err:.3g}, gradient err {grad_err:.3g}")
        return v

    def owlqn_record(name, res, l1, v):
        zeros = int((res.w == 0).sum())
        log(f"solvers {name}: λ1={l1:.6g}, {res.iterations} iterations, "
            f"converged {res.converged}, value {v[0]:.8g} -> {v[-1]:.8g}, "
            f"{zeros} of {N_FEATURES} coefficients zero")
        return dict(iterations=res.iterations, converged=res.converged,
                    zeros=zeros, nonzeros=N_FEATURES - zeros, l1=l1,
                    value=v[-1])

    def costs(launches, wall, k_ms, iterations, n_solves=1):
        """Evaluations (one rmatvec each: OWL-QN and SPG run no HVP) an
        iteration, beside the wall and kernel time."""
        evals = launches["rmatvec"]
        return dict(evals=evals,
                    evals_per_iter=(evals - n_solves) / max(iterations, 1),
                    hvps=0, wall_s=wall, kernel_s=k_ms / 1e3)

    def kkt(name, res, half, obj, d, l1, l2):
        """OWL-QN's KKT conditions at res.w (the zeros against λ1, the
        whole residual through its decrement); ``half`` is the same solve
        stopped after half its iterations, which must fail them.  Logs the
        per-coordinate size of the gradient's terms, Σ_i |x_ij·u_i| with
        u = weight·ℓ'(margin), beside λ1."""
        full, cut = kkt_residuals(res, obj, d, l1, l2), kkt_residuals(
            half, obj, d, l1, l2)
        m = obj.margins(res.w, d)
        u = (d.weights * obj.loss.d1(m, d.labels)).abs()
        terms = abs_F.rmatvec(u)
        log(f"solvers {name}: KKT |g|/λ1 at zeros {full[0]:.6g} (<= "
            f"{1 + KKT_ZERO:g}), |g + λ1·sign(w)|/λ1 on the support "
            f"{full[1]:.3g}, decrement {full[2]:.3g} (<= {KKT_DECREMENT:g}); "
            f"λ1 {l1:.6g} beside "
            f"Σ|x·u| median {float(terms.median()):.6g}, max "
            f"{float(terms.max()):.6g}; stopped after {half.iterations} of "
            f"{res.iterations} iterations: {cut[0]:.6g} at zeros, "
            f"{cut[1]:.3g} on the support, decrement {cut[2]:.3g}")
        check(res.converged and kkt_holds(full),
              f"solvers {name}: converged {res.converged}, KKT residual "
              f"{full[0]:.6g} at zeros, decrement {full[2]:.3g}")
        check(not kkt_holds(cut),
              f"solvers {name}: the KKT check passes the solve stopped "
              f"after {half.iterations} iterations")

    labels = solver_labels(margins)

    # -- OWL-QN: logistic elastic net over a warm-started grid -----------
    obj0 = problem("logistic", RegularizationContext.l2()).objective
    _, g0 = obj0.value_and_grad(torch.zeros(N_FEATURES, device=DEVICE), data)
    alpha = 0.5
    # The largest λ puts α·λ at the median |∂f/∂w_j| at w = 0: half the
    # coefficients start inside their zero interval.
    lam_max = float(torch.quantile(g0.abs(), 0.5)) / alpha
    grid = [lam_max, lam_max / 10, lam_max / 100]
    en = problem("logistic", RegularizationContext.elastic_net(alpha),
                 tol=OWLQN_TOL, max_iters=200)
    out, launches, wall, k_ms = run(
        "owlqn elastic-net grid", lambda: en.run_grid(data, grid))
    grid_recs = []
    w_prev = None
    for lam, _, res in out:
        l1 = float(np.float32(alpha) * np.float32(lam))
        l2 = float(np.float32(1 - alpha) * np.float32(lam))
        name = f"owlqn logistic elastic-net λ={lam:.6g}"
        v = check_solve(name, res, en.objective, data, plain_data, l2)
        half = problem("logistic", RegularizationContext.elastic_net(alpha),
                       tol=OWLQN_TOL, max_iters=res.iterations // 2)
        kkt(name, res, half.solve_single_device(data, lam, w_prev),
            en.objective, data, l1, l2)
        w_prev = res.w
        solutions[("elastic_net", lam)] = res.w
        grid_recs.append(dict(owlqn_record(name, res, l1, v), lam=lam,
                              wall_s=en.grid_wall_seconds[lam]))
        log(f"solvers {name}: solve wall {en.grid_wall_seconds[lam]:.3f} s")
    check(grid_recs[0]["zeros"] >= N_FEATURES // 10,
          f"solvers: the largest elastic-net λ zeroes only "
          f"{grid_recs[0]['zeros']} coefficients")
    iters = sum(r["iterations"] for r in grid_recs)
    records["owlqn.elastic_net_grid"] = dict(
        costs(launches, wall, k_ms, iters, n_solves=len(grid)),
        iterations=iters, grid=grid_recs)
    log(f"solvers owlqn elastic-net grid: {iters} iterations, "
        f"{records['owlqn.elastic_net_grid']['evals_per_iter']:.2f} "
        f"evaluations an iteration")

    # -- OWL-QN: one L1 solve each for the other losses -------------------
    for task in ("linear", "poisson", "smoothed_hinge"):
        d, pd = with_labels(task)
        l1p = problem(task, RegularizationContext.l1(), tol=OWLQN_TOL,
                      max_iters=200)
        _, g0 = l1p.objective.value_and_grad(
            torch.zeros(N_FEATURES, device=DEVICE), d)
        lam = float(torch.quantile(g0.abs(), 0.5))
        name = f"owlqn {task} l1"
        res, launches, wall, k_ms = run(name, lambda: l1p.solve(d, lam))
        l1 = float(np.float32(lam))
        v = check_solve(name, res, l1p.objective, d, pd, 0.0)
        half = problem(task, RegularizationContext.l1(), tol=OWLQN_TOL,
                       max_iters=res.iterations // 2)
        kkt(name, res, half.solve(d, lam), l1p.objective, d, l1, 0.0)
        records[f"owlqn.{task}_l1"] = dict(
            owlqn_record(name, res, l1, v),
            **costs(launches, wall, k_ms, res.iterations), lam=lam)
        solutions[(f"{task}_l1", lam)] = res.w
        if task == "linear":
            again = l1p.solve(d, lam)
            check(torch.equal(again.w, res.w),
                  f"solvers {name}: a repeated solve is not bitwise equal")
            log(f"solvers {name}: repeated solve bitwise equal")
        del d, pd

    # -- TRON: L2 logistic at λ = 1, against L-BFGS -----------------------
    tp = problem("logistic", RegularizationContext.l2(), OptimizerType.TRON)
    res, launches, wall, k_ms = run("tron logistic l2",
                                    lambda: tp.solve(data, 1.0))
    v = check_solve("tron", res, tp.objective, data, plain_data, 1.0)
    check(res.converged, "solvers tron: not converged")
    lb = problem("logistic", RegularizationContext.l2(), max_iters=300)
    ref = lb.solve(data, 1.0)
    gap = abs(float(res.value) - float(ref.value)) / abs(float(ref.value))
    check(ref.converged and gap <= 1e-5,
          f"solvers tron: objective {float(res.value):.9g} vs L-BFGS "
          f"{float(ref.value):.9g} (gap {gap:.3g}, L-BFGS converged "
          f"{ref.converged})")
    # Its Hessian-vector product through the kernels against the plain one.
    vec = torch.randn(N_FEATURES, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(9))
    hv_k = tp.objective.hvp(res.w, vec, data, 1.0)
    hv_p = tp.objective.hvp(res.w, vec, plain_data, 1.0)
    d2w = tp.objective.d2_weights(res.w, plain_data)
    hscale = abs_F.rmatvec(d2w * abs_F.matvec(vec.abs())) + vec.abs()
    hvp_err = float(((hv_k - hv_p).abs() / hscale).max())
    check(hvp_err <= RTOL, f"solvers tron: HVP vs plain {hvp_err:.3g}")
    evals = res.iterations + 1  # the start and one trial an iteration
    hvps = launches["rmatvec"] - evals
    records["tron.logistic_l2"] = dict(
        iterations=res.iterations, converged=res.converged, evals=evals,
        evals_per_iter=1.0, hvps=hvps, hvps_per_iter=hvps / res.iterations,
        wall_s=wall, kernel_s=k_ms / 1e3, value=v[-1], lbfgs_gap=gap,
        lbfgs_iterations=ref.iterations)
    log(f"solvers tron: {res.iterations} iterations, converged, value "
        f"{v[0]:.8g} -> {v[-1]:.8g}; {hvps} HVPs "
        f"({hvps / res.iterations:.2f} an iteration), {evals} evaluations, "
        f"{launches['matvec'] - launches['rmatvec']} d2 passes; L-BFGS "
        f"{ref.iterations} iterations, objective gap {gap:.3g}; HVP vs "
        f"plain {hvp_err:.3g}")

    # -- SPG: L2 logistic with a box on every coefficient -----------------
    cap = 0.05
    lower = torch.full((N_FEATURES,), -cap, device=DEVICE)
    upper = torch.full((N_FEATURES,), cap, device=DEVICE)
    sp_ = problem("logistic", RegularizationContext.l2())
    res, launches, wall, k_ms = run(
        "spg logistic l2 box", lambda: sp_.solve(data, 1.0,
                                                 bounds=(lower, upper)))
    v = check_solve("spg", res, sp_.objective, data, plain_data, 1.0)
    check(bool(((res.w >= lower) & (res.w <= upper)).all()),
          "solvers spg: a coefficient left its box")
    def pg_norm(w):
        _, g = sp_.objective.value_and_grad(w, data, 1.0)
        return float(torch.linalg.vector_norm(
            w - torch.clamp(w - g, lower, upper)))

    pg, pg0 = pg_norm(res.w), float(res.grad_norms[0])
    eps = SOLVE_TOL * max(1.0, pg0)
    half = problem("logistic", RegularizationContext.l2(),
                   max_iters=res.iterations // 2).solve(
                       data, 1.0, bounds=(lower, upper))
    pg_half = pg_norm(half.w)
    log(f"solvers spg: projected gradient by iteration "
        f"{[float(x) for x in res.grad_norms[: res.iterations + 1]]}; "
        f"stopped after {half.iterations} iterations: {pg_half:.3g}")
    check((res.converged and pg <= eps) or res.stalled,
          f"solvers spg: projected gradient {pg:.3g} (tolerance {eps:.3g}), "
          f"converged {res.converged}, stalled {res.stalled}")
    check(pg <= SPG_PG_DROP * pg0,
          f"solvers spg: projected gradient {pg:.3g}, above {SPG_PG_DROP:g} "
          f"of its start {pg0:.3g}")
    check(pg_half > SPG_PG_DROP * pg0,
          f"solvers spg: the solve stopped after {half.iterations} "
          f"iterations already has projected gradient {pg_half:.3g} <= "
          f"{SPG_PG_DROP:g} x {pg0:.3g}")
    at_bound = int(((res.w == lower) | (res.w == upper)).sum())
    rec = records["spg.logistic_l2_box"] = dict(
        costs(launches, wall, k_ms, res.iterations),
        iterations=res.iterations, converged=res.converged,
        stalled=res.stalled, value=v[-1], at_bound=at_bound,
        projected_gradient=pg, projected_gradient_start=pg0)
    log(f"solvers spg: {res.iterations} iterations, converged "
        f"{res.converged}, stalled {res.stalled}, value {v[0]:.8g} -> "
        f"{v[-1]:.8g}, projected gradient {pg0:.3g} -> {pg:.3g} (tolerance "
        f"{eps:.3g}; {SPG_PG_DROP:g} x the start {SPG_PG_DROP * pg0:.3g}), "
        f"{at_bound} of {N_FEATURES} coefficients at a bound, "
        f"{rec['evals']} evaluations ({rec['evals_per_iter']:.2f} an "
        f"iteration)")
    log(f"phase 3b: {time.perf_counter() - t_phase:.1f} s wall; launches "
        f"{json.dumps(total)}")
    log(f"solver records: {json.dumps(records)}")
    return total, records, solutions


def write_libsvm_binary(path, rows, cols, n, y):
    starts = np.searchsorted(rows, np.arange(n + 1))
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{c + 1}:1" for c in cols[starts[i]:starts[i + 1]])
            f.write(f"{'+1' if y[i] > 0 else '-1'} {feats}\n")


def phase_driver(td):
    """Phase 4: the driver on binary LIBSVM data written into ``td`` (L2
    L-BFGS, elastic-net OWL-QN and L2 TRON), each saved model re-scored on
    the host.  Returns the launches summed over the runs, the (train,
    validation) paths and each run's (output dir, result) by label."""
    rng = np.random.default_rng(3)
    n = DRIVER_TRAIN_ROWS + DRIVER_VAL_ROWS
    rows, cols = binary_rows(rng, n, N_FEATURES, NNZ_PER_ROW)
    w_true = rng.normal(size=N_FEATURES) * (rng.uniform(size=N_FEATURES) < 0.3)
    margins = np.bincount(rows, weights=w_true[cols], minlength=n) - 0.5
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margins))).astype(np.float32)
    train, val = os.path.join(td, "train.libsvm"), os.path.join(
        td, "val.libsvm")
    t0 = time.perf_counter()
    split = np.searchsorted(rows, DRIVER_TRAIN_ROWS)
    write_libsvm_binary(train, rows[:split], cols[:split],
                        DRIVER_TRAIN_ROWS, y)
    write_libsvm_binary(val, rows[split:] - DRIVER_TRAIN_ROWS,
                        cols[split:], DRIVER_VAL_ROWS,
                        y[DRIVER_TRAIN_ROWS:])
    log(f"driver: wrote {DRIVER_TRAIN_ROWS} + {DRIVER_VAL_ROWS} LIBSVM "
        f"rows in {time.perf_counter() - t0:.1f} s")
    total = {}
    runs = {}
    for label, flags in DRIVER_RUNS:
        launches, runs[label] = driver_run(label, flags, td, train, val)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total, (train, val), runs


def driver_run(label, flags, td, train, val,
               kernels=("matvec_unit", "rmatvec_unit", "sq_rmatvec_unit")):
    """One ``glm_driver.run`` on the LIBSVM pair under zeroed launch
    counters, its saved model re-scored on the host; each of ``kernels``
    must have launched."""
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.data.libsvm import read_libsvm
    from photon_ml_tpu_torch.drivers import glm_driver
    from photon_ml_tpu_torch.evaluation.evaluators import (
        AreaUnderROCCurveEvaluator,
    )
    from photon_ml_tpu_torch.io.model_store import load_glm_model
    from photon_ml_tpu_torch.ops import _kernels

    out = os.path.join(td, f"out_{label}")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    result = glm_driver.run([
        "--train-data", train, "--validate-data", val,
        "--output-dir", out, "--task", "logistic", *flags,
        "--reg-weights", "0.1,1,10", "--max-iters", "50",
        "--n-features", str(N_FEATURES), "--device", DEVICE,
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    check(os.path.exists(os.path.join(out, "training_result.json")),
          f"driver {label}: no training_result.json")
    best = result["best_lambda"]
    model, _ = load_glm_model(
        os.path.join(out, f"model_lambda_{best:g}.avro"),
        index_map=IndexMap.load(out), device=DEVICE)
    w = model.coefficients.means.cpu().numpy().astype(np.float64)
    X_val, y_val = read_libsvm(val, n_features=N_FEATURES,
                               add_intercept=True, drop_out_of_range=True)
    host_auc = AreaUnderROCCurveEvaluator().evaluate(X_val @ w, y_val)
    drv_auc = result["metrics"][str(best)]
    log(f"driver {label} ({' '.join(flags)}): {wall:.1f} s end to end; "
        f"selected λ={best:g}, AUC {drv_auc:.6f} (host re-score "
        f"{host_auc:.6f}), {int((w == 0).sum())} of {w.size} coefficients "
        f"zero; solver walls {json.dumps(result['solver_wall_seconds'])}")
    log(f"driver {label} launches: {json.dumps(launches)}")
    check(drv_auc > 0.5, f"driver {label}: AUC {drv_auc}")
    check(abs(drv_auc - host_auc) <= 1e-6,
          f"driver {label}: AUC {drv_auc} vs host {host_auc}")
    for op in kernels:
        check(launches[op] > 0, f"driver {label}: {op} never launched")
    return launches, (out, result)


def run_main_path(label, mod, kernels):
    """One experiment's entry point at full size, with the launch counts
    zeroed just before and read just after; each of ``kernels`` must have
    launched."""
    from photon_ml_tpu_torch.ops import _kernels

    log(f"experiments: python -m {mod.__name__} --rows {N_ROWS}")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = mod.main(["--rows", str(N_ROWS)])
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    log(f"experiments: {label} main {time.perf_counter() - t0:.1f} s; "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    for key in kernels:
        check(launches[key] > 0, f"{label} main: {key} never launched")
    return res, launches


def layout_once(build):
    """A stand-in for ``g8192_v2.build_layout`` that returns the last
    layout again for the same operands."""
    last = []

    def once(cols, vals, n_rows):
        if last and last[0] == n_rows and all(
                np.array_equal(a, b) for a, b in zip(last[1:3], (cols, vals))):
            return last[3]
        last[:] = [n_rows, cols, vals, build(cols, vals, n_rows)]
        return last[3]

    return once


def phase_experiments():
    """Phase 5: the three experiments through their entry points, then the
    ELL kernel, its graph chain and the window kernel against their plain
    versions on the reference's data."""
    from photon_ml_tpu_torch.experiments import ablate, common, g8192, g8192_v2

    # g8192_v2's main and the window check below lay out the same ELL draw
    # (seed 0): the check reads the main's layout (≈ 17 s a build).
    g8192_v2.build_layout = layout_once(g8192_v2.build_layout)
    ell_main, ell_launches = run_main_path("g8192", g8192, ["ell_matvec"])
    win_main, win_launches = run_main_path("g8192_v2", g8192_v2,
                                           ["window_matvec"])
    _, abl_launches = run_main_path(
        "ablate", ablate,
        [f"spmv_ablate_{m}_{op}" for m in ablate.MODES for op in ablate.OPS])

    n, k, d = N_ROWS, g8192.K, g8192.D
    cols_T, vals_T, w = g8192.make_ell(n, k, d, seed=0)
    c_d, v_d, w_d = (torch.as_tensor(a, device=DEVICE)
                     for a in (cols_T, vals_T, w))
    recs = {}

    # -- ELL mat-vec ------------------------------------------------------
    def ell():
        return g8192.ell_matvec(c_d, v_d, w_d)

    def ell_plain():
        return g8192.ell_matvec_plain(c_d, v_d, w_d)

    m, m2 = ell(), ell()
    ref = ell_plain()
    scale = g8192.ell_matvec_plain(c_d, v_d.abs(), w_d.abs())
    torch.cuda.synchronize()
    check(torch.equal(m, m2), "ell_matvec: two launches differ")
    err = (m - ref).abs()
    check(bool((err <= RTOL * scale).all()),
          f"ell_matvec: kernel vs plain beyond rtol {RTOL}")
    # cuSPARSE on the same entries: the CSR with k entries a row, columns
    # sorted within each row.
    cols_sorted, perm = torch.sort(c_d.t(), dim=1)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(
            torch.arange(0, n * k + 1, k, dtype=torch.int32, device=DEVICE),
            cols_sorted.reshape(-1).contiguous(),
            torch.gather(v_d.t(), 1, perm).reshape(-1).contiguous(),
            size=(n, d), check_invariants=False)
    lib = torch.mv(A, w_d)
    torch.cuda.synchronize()
    check(bool(((lib - ref).abs() <= RTOL * scale).all()),
          "ell_matvec: library yardstick disagrees")
    library_ms = median_ms(lambda: torch.mv(A, w_d))
    ell_bound = bytes_bound(n * k * 8 + 4 * n + 4 * d, 2 * n * k)
    recs["ell"] = dict(max_abs_err=float(err.max()), ms=median_ms(ell),
                       plain_ms=median_ms(ell_plain), library_ms=library_ms,
                       bound_ms=ell_bound[0], bound_by=ell_bound[1])

    # -- its chain of R passes as one CUDA graph --------------------------
    reps = common.REPS
    step = functools.partial(g8192.step, cols_T=c_d, vals_T=v_d)

    def plain_step(x):
        return x + 1e-20 * g8192.ell_matvec_plain(c_d, v_d, x)[:d]

    graph = common.ChainGraph(step, w_d, reps)
    w_graph = graph(w_d)
    w_eager = common.run_chain(step, w_d, reps)
    w_plain = common.run_chain(plain_step, w_d, reps)
    torch.cuda.synchronize()
    check(torch.equal(w_graph, w_eager), "ell chain: graph != eager chain")
    chain_err = (w_graph - w_plain).abs()
    check(bool((chain_err <= RTOL * w_plain.abs().clamp_min(1.0)).all()),
          "ell chain: kernel chain vs plain chain beyond rtol")
    graph_ms = median_ms(graph.replay) / reps
    eager_ms = median_ms(lambda: common.run_chain(step, w_d, reps)) / reps
    graph_wall = wall_ms(graph.replay) / reps
    eager_wall = wall_ms(lambda: common.run_chain(step, w_d, reps)) / reps
    chain_bound = bytes_bound(n * k * 8 + 8 * d, 2 * n * k + 2 * d)
    # The library's pass (cuSPARSE torch.mv on the same CSR) in the same
    # 10-pass graph, or as an eager chain where the capture fails.
    def lib_step(x):
        return x + 1e-20 * torch.mv(A, x)[: x.shape[0]]

    try:
        lib_graph = common.ChainGraph(lib_step, w_d, reps)
        chain_lib_ms, chain_lib_route = (
            median_ms(lib_graph.replay) / reps, "graph")
        del lib_graph
    except RuntimeError as e:  # a capture the library refuses
        log(f"  ell chain: cuSPARSE capture failed ({e}); timed eager")
        chain_lib_ms, chain_lib_route = median_ms(
            lambda: common.run_chain(lib_step, w_d, reps)) / reps, "eager"
    recs["chain"] = dict(
        max_abs_err=float(chain_err.max()), ms=graph_ms,
        plain_ms=median_ms(lambda: common.run_chain(plain_step, w_d, reps),
                           n=10) / reps,
        library_ms=chain_lib_ms, bound_ms=chain_bound[0],
        bound_by=chain_bound[1])
    r = recs["ell"]
    log(f"  ell ok  kernel {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of "
        f"the {r['bound_by']} bound {r['bound_ms']:.4f} ms)  plain "
        f"{r['plain_ms']:.4f} ms  cuSPARSE {library_ms:.4f} ms  max|err| "
        f"{r['max_abs_err']:.3g}")
    r = recs["chain"]
    log(f"  ell chain of {reps} ok: graph replay {graph_ms:.4f} ms/pass "
        f"({r['bound_ms'] / graph_ms:.1%} of the {r['bound_by']} bound "
        f"{r['bound_ms']:.4f} ms), eager host loop {eager_ms:.4f} ms/pass "
        f"(gap {eager_ms - graph_ms:.4f} ms/pass), plain "
        f"{r['plain_ms']:.4f} ms/pass, cuSPARSE {chain_lib_ms:.4f} ms/pass "
        f"({chain_lib_route} chain); graph == eager bitwise")
    log(f"  ell chain of {reps} alone (host clock, synchronize around one "
        f"chain): graph {graph_wall:.4f} ms/pass, eager {eager_wall:.4f} "
        f"ms/pass: host launch cost {eager_wall - graph_wall:.4f} ms/pass")
    del A, cols_sorted, perm

    # -- window layout mat-vec --------------------------------------------
    t0 = time.perf_counter()
    lo, v, rhi, n_spill = g8192_v2.build_layout(cols_T.T, vals_T.T, n)
    log(f"window: host layout (g8192_v2's main's) "
        f"{time.perf_counter() - t0:.1f} s, spill {n_spill} of {n * k} "
        "entries")
    lo_d, vv_d, rhi_d = (torch.as_tensor(a, device=DEVICE)
                         for a in (lo, v, rhi))
    del lo, v, rhi

    def win():
        return g8192_v2.window_matvec(lo_d, vv_d, rhi_d, w_d)

    def win_plain():
        return g8192_v2.window_matvec_plain(lo_d, vv_d, rhi_d, w_d)

    o, o2 = win(), win()
    ref = win_plain()
    wscale = g8192_v2.window_matvec_plain(lo_d, vv_d.abs(), rhi_d, w_d.abs())
    torch.cuda.synchronize()
    check(torch.equal(o, o2), "window_matvec: two launches differ")
    werr = (o - ref).abs()
    check(bool((werr <= RTOL * wscale).all()),
          f"window_matvec: kernel vs plain beyond rtol {RTOL}")
    if n_spill == 0:
        check(bool(((o.reshape(-1) - m).abs() <= RTOL * scale).all()),
              "window_matvec: disagrees with the ELL kernel")
        log("  window == ELL kernel within rtol (nothing spilled)")
    design = g8192_v2.window_config(DEVICE, lo_d.shape[0])
    log(f"  window kernel design: S={design['tile']} sublanes a tile, "
        f"P={design['stages']} ring stages "
        f"({design['stages'] * 3 * design['tile'] * 512} B in flight a CTA), "
        f"C={design['copies']} accumulator copies, {design['threads']} "
        f"threads and {design['shared_bytes']} B of shared memory a CTA, "
        f"grid {design['ctas']} CTAs for {lo_d.shape[0]} blocks")
    check(design["stream_only"] == 0, "window_matvec: read-only build")

    # Non-finite w: inf at w[5·128], read by every padded slot of window 5
    # (0·inf = NaN in row group 0), and at a live column of window 9.
    sub = slice(9 * g8192_v2.DEPTH, 10 * g8192_v2.DEPTH)
    live = lo_d[0, sub][(vv_d[0, sub] != 0) & (lo_d[0, sub] != 0)]
    w_inf = w_d.clone()
    w_inf[5 * 128] = float("inf")
    w_inf[9 * 128 + int(live[0])] = float("inf")
    o_inf = g8192_v2.window_matvec(lo_d, vv_d, rhi_d, w_inf)
    ref_inf = g8192_v2.window_matvec_plain(lo_d, vv_d, rhi_d, w_inf)
    torch.cuda.synchronize()
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        check(torch.equal(kind(o_inf), kind(ref_inf)),
              f"window_matvec: {kind.__name__} positions differ from the "
              f"plain version's for a non-finite w")
    finite = torch.isfinite(ref_inf)
    check(bool(torch.isnan(ref_inf[:, 0]).any())
          and bool(torch.isinf(ref_inf).any()),
          "window_matvec: the non-finite probe reached no output")
    check(bool(((o_inf - ref_inf).abs()[finite] <= RTOL * wscale[finite])
               .all()), "window_matvec: finite outputs beyond rtol with a "
          "non-finite w")
    log(f"  window non-finite w ok: {int(torch.isnan(o_inf).sum())} NaN and "
        f"{int(torch.isinf(o_inf).sum())} inf outputs, where the plain "
        f"version has them; the other {int(finite.sum())} within rtol")
    del o_inf, ref_inf, w_inf, finite

    slots = lo_d.numel()
    win_bound = bytes_bound(12 * slots + 4 * d + 4 * o.numel(), 2 * slots)
    recs["window"] = dict(max_abs_err=float(werr.max()), ms=median_ms(win),
                          plain_ms=median_ms(win_plain, n=10),
                          library_ms=library_ms, bound_ms=win_bound[0],
                          bound_by=win_bound[1])
    r = recs["window"]
    log(f"  window ok  kernel {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%}"
        f" of the slot bound {r['bound_ms']:.4f} ms; the live entries alone "
        f"bound {ell_bound[0]:.4f} ms)  plain {r['plain_ms']:.4f} ms  "
        f"cuSPARSE {library_ms:.4f} ms  max|err| {r['max_abs_err']:.3g}")
    wstep = functools.partial(g8192_v2.step, lo=lo_d, v=vv_d, rhi=rhi_d)
    wgraph = common.ChainGraph(wstep, w_d, reps)
    check(torch.equal(wgraph(w_d), common.run_chain(wstep, w_d, reps)),
          "window chain: graph != eager chain")
    log(f"  window chain of {reps}: graph replay "
        f"{median_ms(wgraph.replay) / reps:.4f} ms/pass, eager host loop "
        f"{median_ms(lambda: common.run_chain(wstep, w_d, reps)) / reps:.4f}"
        f" ms/pass; graph == eager bitwise")

    # The graph's launches happen at replay, where no wrapper counts them:
    # the main path's graph launched the kernel reps x replays times.
    recs["ell"]["launches"] = ell_launches["ell_matvec"]
    recs["chain"]["launches"] = ell_main["reps"] * ell_main["graph_replays"]
    recs["window"]["launches"] = win_launches["window_matvec"]
    log(f"experiments main path: ell_matvec {recs['ell']['launches']} "
        f"launches by the wrapper, graph chain {ell_main['reps']} x "
        f"{ell_main['graph_replays']} replays = {recs['chain']['launches']}; "
        f"window_matvec {recs['window']['launches']} (+ "
        f"{win_main['reps']} x {win_main['graph_replays']} in its graph)")
    return recs, abl_launches


# -- phase 6: GAME coordinate descent --------------------------------------


def game_cd_data():
    """``bench.py``'s ``bench_game_cd`` draw at full width (seed 1): zipf(1.8)
    rows per user capped at 128, a 512-wide fixed effect with 8 normal values
    a row, an 8-wide dense per-user random effect, coin-flip labels."""
    import scipy.sparse as sp

    rng = np.random.default_rng(1)
    sizes = np.minimum(rng.zipf(1.8, GAME_ENTITIES), GAME_ROW_CAP)
    n = int(sizes.sum())
    users = np.repeat(
        np.array([f"u{i}" for i in range(GAME_ENTITIES)], dtype=object),
        sizes)
    users = users[rng.permutation(n)]
    nnzf = n * GAME_FIXED_NNZ
    Xg = sp.csr_matrix(
        (rng.normal(size=nnzf).astype(np.float32),
         (np.repeat(np.arange(n, dtype=np.int64), GAME_FIXED_NNZ),
          rng.integers(0, GAME_FIXED_FEATURES, size=nnzf))),
        shape=(n, GAME_FIXED_FEATURES))
    Xu = sp.csr_matrix(rng.normal(size=(n, GAME_RE_DIM)).astype(np.float32))
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return n, Xg, y, [("per_user", users, Xu, None)]


def game_multi_re_data():
    """``bench.py``'s ``bench_game_multi_re`` draw at full width (seed 3):
    the fixed effect plus per-user (zipf 1.8), per-item (zipf 1.5 pool of
    20,000 items) and per-context (200 contexts, active cap 256: passive
    rows) random effects, each 8 wide and dense (the draw of
    ``experiments/common.py``, which ``experiments.multirank --game`` runs
    too)."""
    from photon_ml_tpu_torch.experiments.common import game_multi_re_draw

    return game_multi_re_draw(entities=GAME_ENTITIES)


def game_objective(coords, y, scores, states, base, rows=None):
    """The GAME objective in float64 on the device: the logistic losses at
    base + Σ scores (over the rows where the bool mask ``rows`` holds, or
    all rows), plus each coordinate's penalty: ½·λ₂‖w‖² + λ₁‖w‖₁ (a
    factored coordinate's on its latents u, plus ½·λ_V‖V‖²)."""
    from photon_ml_tpu_torch.ops import losses as losses_lib

    total = (base + sum(scores.values())).double()
    losses = losses_lib.logistic.value(total, y.double())
    f = (losses if rows is None else losses[rows]).sum()
    for c in coords:
        st = states[c.name]
        if st is None:
            continue
        if torch.is_tensor(st):  # a fixed effect's w (resident or streamed)
            cfg = c.problem.config if hasattr(c, "problem") else c.config
            l1, l2 = 0.0, c.reg_weight * cfg.regularization.l2_weight(1.0)
            ws = [st]
        else:
            l1, l2 = c._reg()[:2]
            ws = st[0] if hasattr(c, "rank") else st
            if hasattr(c, "rank"):
                f = f + 0.5 * c._reg()[2] * (st[1].double() ** 2).sum()
        ws = [torch.as_tensor(w, device=total.device).double() for w in ws]
        f = f + sum(0.5 * l2 * (w ** 2).sum() + l1 * w.abs().sum()
                    for w in ws)
    return f


def re_gradients(coord, items, ws, tol):
    """Each lane's gradient test at ``ws`` recomputed in float64 by a plain
    per-bucket computation: (measure, threshold) a bucket.  The measure is
    the solver's own (‖g‖; |xᵀg| for R == 1, whose solve runs in α with
    w = α·x; |g| for D == 1) of g = Σ_r wt·ℓ'(m)·x + λ·w, m = x·w + offset;
    the threshold is tol·max(1, the measure at the warm start) plus a
    float32 rounding allowance of 64·2⁻²⁴ times the same measure of
    Σ_r wt·(|ℓ'(m)| + |y| + ℓ''(m)·(|offset| + Σ_d |x·w|))·|x| + λ|w|: what
    rounding the margin, the loss derivative and the sums can move g by."""
    loss = coord._solver.loss
    _, l2 = coord._reg()
    out = []
    for (b, off, w0), w in zip(items, ws):
        X, yb, wt = b.X.double(), b.labels.double(), b.weights.double()
        off = off.double()

        def grad(w):
            w = w.double()
            xw = X * w[:, None, :]
            m = xw.sum(-1) + off
            u = wt * loss.d1(m, yb)
            err = wt * (u.abs() / wt.clamp_min(1e-30) + yb.abs()
                        + loss.d2(m, yb) * (off.abs() + xw.abs().sum(-1)))
            return ((u[:, :, None] * X).sum(1) + l2 * w,
                    (err[:, :, None] * X.abs()).sum(1) + l2 * w.abs())

        def measure(g, absolute=False):
            if b.rows_per_entity == 1:
                x = X[:, 0, :].abs() if absolute else X[:, 0, :]
                return (x * g).sum(1).abs()
            if b.block_dim == 1:
                return g[:, 0].abs()
            return torch.linalg.vector_norm(g, dim=1)

        g, g_err = grad(w)
        g0, _ = grad(w0)
        thresh = tol * torch.clamp(measure(g0), min=1.0) \
            + 64 * 2.0 ** -24 * measure(g_err, absolute=True)
        out.append((measure(g), thresh))
    return out


def re_gradient_check(glog, coord, offsets):
    """A cold-start solve of ``coord`` at ``offsets``: every lane its solver
    marks converged must pass its gradient test recomputed in float64
    (:func:`re_gradients`); the same buckets stopped after one Newton body
    (a planted fault) must fail it.  Returns the full solve's stats."""
    from photon_ml_tpu_torch.game.coordinates import _gather_block_offsets

    solver, (l1, l2) = coord._solver, coord._reg()
    tol = coord.config.optimizer.tolerance
    items = [(b, _gather_block_offsets(offsets, b),
              torch.zeros((b.n_entities, b.block_dim), device=DEVICE))
             for b in coord.dataset.blocks]
    # The Newton buckets (the fallback's are fallback_checks').
    items = [it for it in items
             if solver.program(*it, l1, l2).iterations is None]
    if not items:
        return None
    ws, stats = solver.solve_all(items, l1, l2)
    cut = []
    for b, off, w0 in items:
        p = solver.program(b, off, w0, l1, l2)
        p.body()
        cut.append(p.result())

    def worst(w_list):
        """(lanes tested, lanes failing, max measure/threshold) over the
        lanes the full solve marked converged."""
        tested = failing = 0
        ratio = 0.0
        for (m, t), conv in zip(re_gradients(coord, items, w_list, tol),
                                stats.converged):
            tested += int(conv.sum())
            failing += int((conv & (m > t)).sum())
            if bool(conv.any()):
                ratio = max(ratio, float((m / t)[conv].max()))
        return tested, failing, ratio

    n_lanes = sum(b.n_entities for b, _, _ in items)
    tested, failing, ratio = worst(ws)
    _, cut_failing, cut_ratio = worst(cut)
    glog(f"{coord.name}: cold Newton solve at the final offsets marks "
         f"{tested} of {n_lanes} lanes converged (bodies {stats.bodies}, "
         f"{stats.host_reads} host reads); float64 gradient test: "
         f"{failing} fail, worst measure/threshold {ratio:.3g}; stopped "
         f"after one Newton body: {cut_failing} of {tested} fail, worst "
         f"{cut_ratio:.3g}")
    check(tested > 0 and failing == 0,
          f"game {coord.name}: {failing} converged lanes fail the float64 "
          f"gradient test (worst {ratio:.3g})")
    check(cut_failing > 0, f"game {coord.name}: the gradient test passes "
          "the solve stopped after one Newton body")
    return stats


# Phase 8's float64 stopping tests allow for float32 rounding: a lane's
# gradient sum by up to GAME_ROUNDING of the absolute sum of its terms (as
# phase 6's), its value sum by up to GAME_VALUE_ROUNDING of the absolute
# sum of its terms.  Lane by lane, a float64 copy of GAME_LANE_SAMPLE lanes
# a bucket follows each lane's single solve within FALLBACK_F64_TOL of ‖w‖;
# in float32 the lanes part at the noise floor (one ulp decides a trial or
# the stall test) and land within FALLBACK_F32_TOL of the largest ‖w‖.
GAME_ROUNDING = 64 * 2.0 ** -24
GAME_VALUE_ROUNDING = 4 * 2.0 ** -24
GAME_LANE_SAMPLE = 64
FALLBACK_F64_TOL = 1e-9
FALLBACK_F32_TOL = 5e-3


def states_equal(a, b):
    """Bitwise equality of two coordinate states (tensors, host arrays, or
    nested lists and tuples of them)."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return len(a) == len(b) and all(states_equal(x, y) for x, y in zip(a, b))


def solve_summary(stats):
    """A lockstep solve's bodies a bucket and host reads, and for each
    fallback bucket its mean line-search trials or CG steps an iteration
    (None for a Newton bucket)."""
    out = dict(bodies=list(stats.bodies), host_reads=stats.host_reads)
    inner = [None if it is None else round(
        int(inn.sum()) / max(int(it.sum()), 1), 3)
        for it, inn in zip(stats.iterations, stats.inner)]
    if any(v is not None for v in inner):
        out["inner_per_iteration"] = inner
    return out


def lane_tests(loss, b, off, w, w0, w_prev, l1, l2, tol, owlqn, plateau):
    """Each lane's stopping test of one fallback bucket at ``w``,
    recomputed in float64: (passes, measure / threshold).  OWL-QN: the KKT
    conditions, |g_j| ≤ (1 + KKT_ZERO)·λ1 at the zeros and a
    diagonal-Newton decrement Σ pg_j²/(2·H_jj) ≤ KKT_DECREMENT·|F| (phase
    3b's); L-BFGS and TRON: the relative gradient test ‖g‖ ≤
    tol·max(1, ‖g₀‖), or for a lane that stopped on the relative decrease
    (``plateau``) that test, |F(w_prev) − F(w)| ≤ tol·1e-2·|F(w_prev)|,
    with w_prev the iterate before its last step.  g is the smooth part's
    gradient Σ_r wt·ℓ'(m)·x + λ2·w, H_jj = Σ_r wt·ℓ''(m)·x_j² + λ2."""
    X, y, wt = b.X.double(), b.labels.double(), b.weights.double()
    off = off.double()

    def at(w):
        w = w.double()
        xw = X * w[:, None, :]
        m = xw.sum(-1) + off
        d1, d2 = loss.d1(m, y), loss.d2(m, y)
        g = ((wt * d1)[:, :, None] * X).sum(1) + l2 * w
        err = wt * (d1.abs() + y.abs() + d2 * (off.abs() + xw.abs().sum(-1)))
        g_err = (err[:, :, None] * X.abs()).sum(1) + l2 * w.abs()
        lv = wt * loss.value(m, y)
        pen = 0.5 * l2 * (w * w).sum(1) + l1 * w.abs().sum(1)
        h = ((wt * d2)[:, :, None] * X * X).sum(1) + l2
        return w, g, g_err, lv.sum(1) + pen, lv.abs().sum(1) + pen, h

    w, g, g_err, F, F_abs, h = at(w)
    if owlqn:
        pg = torch.where(w != 0, g + l1 * torch.sign(w),
                         torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0))
    else:
        pg = g
    dec = (pg * pg / (2 * h.clamp_min(1e-30))).sum(1)
    dec_ratio = dec / (KKT_DECREMENT * F.abs()
                       + GAME_VALUE_ROUNDING * F_abs).clamp_min(1e-300)
    if owlqn:
        zero = w == 0
        at_zero = torch.where(zero, (g.abs() - GAME_ROUNDING * g_err)
                              / (l1 * (1 + KKT_ZERO)), 0.0).amax(1)
        ratio = torch.maximum(at_zero, dec_ratio)
        return ratio <= 1, ratio
    _, g0, _, _, _, _ = at(w0)
    _, _, _, F_prev, F_prev_abs, _ = at(w_prev)
    norm = torch.linalg.vector_norm
    thresh = tol * torch.clamp(norm(g0, dim=1), min=1.0) \
        + GAME_ROUNDING * norm(g_err, dim=1)
    decrease = (F_prev - F).abs() / (
        tol * 1e-2 * F_prev.abs()
        + GAME_VALUE_ROUNDING * (F_prev_abs + F_abs)).clamp_min(1e-300)
    ratio = torch.where(plateau, decrease, norm(g, dim=1) / thresh)
    return ratio <= 1, ratio


def fallback_checks(glog, coord, offsets):
    """A cold solve of ``coord``'s fallback buckets at ``offsets``: every
    lane marked converged passes its stopping test in float64
    (:func:`lane_tests`); the same buckets stopped where half those lanes
    are converged (a planted fault) fail it on the other half; and
    GAME_LANE_SAMPLE lanes a bucket re-solved one at a time by the
    single-problem solver land on the batched lanes
    (float64 copies within FALLBACK_F64_TOL and the same iterations; the
    float32 lanes within FALLBACK_F32_TOL).  Returns a summary, or None
    without fallback buckets."""
    from photon_ml_tpu_torch.game.coordinates import _gather_block_offsets

    solver, (l1, l2) = coord._solver, coord._reg()
    tol = coord.config.optimizer.tolerance
    items = []
    for b in coord.dataset.blocks:
        it = (b, _gather_block_offsets(offsets, b),
              torch.zeros((b.n_entities, b.block_dim), device=DEVICE))
        if solver.program(*it, l1, l2).iterations is not None:
            items.append(it)
    if not items:
        return None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    progs = [solver.program(*it, l1, l2) for it in items]
    bodies, reads = solver.lockstep(progs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kind = type(progs[0]).__name__
    ws = [p.result() for p in progs]

    def worst(w_list, lanes, progs):
        """(lanes tested, failing, of them on the relative decrease,
        failing of those, worst measure/threshold)."""
        tested = failing = plateau = plateau_failing = 0
        ratio = 0.0
        for (b, off, w0), w, sel, full, p in zip(items, w_list, lanes,
                                                 full_progs, progs):
            plat = full.plateau & sel
            ok, r = lane_tests(solver.loss, b, off, w, w0, p.w_prev, l1, l2,
                               tol, solver.use_owlqn, plat)
            tested += int(sel.sum())
            plateau += int(plat.sum())
            failing += int((sel & ~ok).sum())
            plateau_failing += int((plat & ~ok).sum())
            if bool(sel.any()):
                ratio = max(ratio, float(r[sel].max()))
        return tested, failing, plateau, plateau_failing, ratio

    full_progs = progs

    # The planted fault: each bucket stopped at the first body where its
    # solver marks half the lanes it ends up converging converged; the
    # other half, tested there, must fail.
    cut, cut_lanes = [], []
    for (b, off, w0), full in zip(items, full_progs):
        p = solver.program(b, off, w0, l1, l2)
        goal = int(full.converged.sum()) // 2
        while int((p.converged & full.converged).sum()) < goal:
            p.body()
        cut.append(p)
        cut_lanes.append(full.converged & ~p.converged)
    n_lanes = sum(b.n_entities for b, _, _ in items)
    tested, failing, plateau, plateau_failing, ratio = worst(
        ws, [p.converged for p in progs], progs)
    cut_tested, cut_failing, _, _, cut_ratio = worst(
        [p.result() for p in cut], cut_lanes, cut)
    its = [int(p.iterations.sum()) for p in progs]
    inner = [int(p.inner.sum()) for p in progs]
    shapes = [(b.n_entities, b.rows_per_entity, b.block_dim)
              for b, _, _ in items]
    glog(f"{coord.name}: {kind} cold solve of {len(items)} fallback "
         f"buckets {shapes} "
         f"at the final offsets: {wall:.3f} s, bodies {bodies}, "
         f"{reads} host reads, iterations {its}, "
         f"{'line-search trials' if kind != 'BatchedTRON' else 'CG steps'} "
         f"{inner}; {tested} of {n_lanes} lanes converged ({plateau} on the "
         f"relative decrease); float64 stopping tests: {failing} fail "
         f"({plateau_failing} of them on the relative decrease), worst "
         f"measure/threshold {ratio:.3g}; stopped where half of them are "
         f"converged: {cut_failing} of the other {cut_tested} fail, worst "
         f"{cut_ratio:.3g}")
    check(tested > 0 and failing == 0,
          f"game {coord.name}: {failing} converged fallback lanes fail the "
          f"float64 stopping test (worst {ratio:.3g})")
    check(cut_failing > 0, f"game {coord.name}: the stopping tests pass "
          "the fallback solve stopped where half its lanes are converged")

    rng = np.random.default_rng(8)
    f32_worst = f64_worst = 0.0
    same_its = n_single = 0
    pairs = []
    for k, ((b, off, w0), w) in enumerate(zip(items, ws)):
        lanes = np.sort(rng.choice(b.n_entities, replace=False,
                                   size=min(b.n_entities, GAME_LANE_SAMPLE)))
        errs, norms = [], []
        for e in lanes.tolist():
            r = progs[k].single(e, w0[e])
            errs.append(float(torch.linalg.vector_norm(w[e] - r.w)))
            norms.append(float(torch.linalg.vector_norm(r.w)))
            pairs.append((int(progs[k].iterations[e]), r.iterations))
        f32_worst = max(f32_worst, max(errs) / max(max(norms), 1e-30))
        # A float64 copy of the sampled lanes: a bucket of its own.
        idx = torch.as_tensor(lanes, device=DEVICE)
        sub = dataclasses.replace(
            b, X=b.X[idx].double(), labels=b.labels[idx].double(),
            weights=b.weights[idx].double(), col_map=b.col_map[idx],
            row_index=b.row_index[idx], n_entities=len(lanes))
        o64, w64 = off[idx].double(), w0[idx].double()
        (sw,), sst = solver.solve_all([(sub, o64, w64)], l1, l2)
        p64 = solver.program(sub, o64, w64, l1, l2)
        for j in range(len(lanes)):
            r = p64.single(j, w64[j])
            n_single += 1
            same_its += int(r.iterations == int(sst.iterations[0][j]))
            f64_worst = max(f64_worst, float(
                torch.linalg.vector_norm(sw[j] - r.w)
                / torch.linalg.vector_norm(r.w).clamp_min(1e-300)))
    b_its = np.array([p[0] for p in pairs])
    s_its = np.array([p[1] for p in pairs])
    glog(f"{coord.name}: lane by lane, {len(pairs)} sampled lanes re-solved "
         f"by the single-problem solver: float32 within {f32_worst:.3g} of "
         f"the bucket's largest ‖w‖ (limit {FALLBACK_F32_TOL:g}), "
         f"iterations batched {b_its.mean():.2f} / single {s_its.mean():.2f} "
         f"a lane ({int((b_its == s_its).sum())} equal); float64 copies "
         f"within {f64_worst:.3g} of ‖w‖ (limit {FALLBACK_F64_TOL:g}), "
         f"iterations equal in {same_its} of {n_single}")
    check(f32_worst <= FALLBACK_F32_TOL, f"game {coord.name}: float32 lanes "
          f"{f32_worst:.3g} from their single solves")
    check(f64_worst <= FALLBACK_F64_TOL and same_its == n_single,
          f"game {coord.name}: float64 lanes {f64_worst:.3g} from their "
          f"single solves, iterations equal in {same_its} of {n_single}")
    return dict(kind=kind, wall_s=wall, bodies=bodies,
                host_reads=reads, iterations=its, inner=inner,
                converged=tested, lanes=n_lanes, plateau=plateau,
                worst_ratio=ratio, cut_failing=cut_failing,
                lane_f32=f32_worst, lane_f64=f64_worst,
                lane_iterations=(float(b_its.mean()), float(s_its.mean())))


def factored_checks(glog, coord, offsets, y, effects):
    """The factored coordinate at ``offsets`` from its cold start: the
    projection gradient (its deterministic column sums) against a float64
    host recompute from the raw sparse rows, within 1e-5 of the absolute
    sum of each entry's terms, and bitwise repeatable; then alternations
    stepped by hand: no projection step raises the float64 objective in V.
    Logs each step's seconds and L-BFGS iterations over V."""
    _, keys, Xe, _ = next(e for e in effects if e[0] == coord.name)
    X64 = Xe.tocsr().astype(np.float64)
    uniq, inv = np.unique(np.asarray(keys).astype(str), return_inverse=True)
    slots = [coord.dataset.entity_to_slot[k] for k in uniq]
    off_h = offsets.double().cpu().numpy()
    y64 = y.astype(np.float64)
    _, _, l2v = coord._reg()

    def host(u_list, V):
        """(f, G, the absolute sum of G's terms) in float64 on the host."""
        us = [u.double().cpu().numpy() for u in u_list]
        U = np.stack([us[bi][lane] for bi, lane in slots])[inv]
        V = V.double().cpu().numpy()
        m = ((X64 @ V) * U).sum(1) + off_h
        dm = 1 / (1 + np.exp(-m)) - y64
        f = float((np.logaddexp(0.0, m) - y64 * m).sum()
                  + 0.5 * l2v * (V * V).sum())
        G = X64.T @ (dm[:, None] * U) + l2v * V
        G_abs = abs(X64).T @ (np.abs(dm)[:, None] * np.abs(U)) \
            + l2v * np.abs(V)
        return f, G, G_abs

    offs = coord.block_offsets(offsets)
    u_list = [torch.zeros((b.n_entities, coord.rank), device=DEVICE)
              for b in coord.dataset.blocks]
    V = coord._v0
    steps = []
    grad_err = 0.0
    for _ in range(coord.alternations):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u_list, stats = coord.latent_step(offs, u_list, V)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, g = coord.projection_value_grad(V.reshape(-1), offs, u_list)
        _, g2 = coord.projection_value_grad(V.reshape(-1), offs, u_list)
        check(torch.equal(g, g2), f"game {coord.name}: the projection "
              "gradient differs between two calls")
        f0, G, G_abs = host(u_list, V)
        err = np.abs(g.view(V.shape).double().cpu().numpy() - G) / np.maximum(
            G_abs, 1e-30)
        grad_err = max(grad_err, float(err.max()))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        V_new, res = coord.projection_step(offs, u_list, V)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        f1 = host(u_list, V_new)[0]
        steps.append(dict(latent_s=t1 - t0, projection_s=t3 - t2,
                          projection_iterations=res.iterations,
                          latent=solve_summary(stats), f_before=f0,
                          f_after=f1))
        check(f1 - f0 <= GAME_OBJ_RISE * abs(f0),
              f"game {coord.name}: a projection step raised the objective "
              f"in V from {f0:.10g} to {f1:.10g}")
        V = V_new
    glog(f"{coord.name}: projection gradient vs a float64 host recompute "
         f"from the sparse rows: max err {grad_err:.3g} of each entry's "
         f"Σ|terms| (limit {RTOL:g}), bitwise repeatable; by hand from the "
         f"cold start: " + "; ".join(
             f"alternation {i}: latent step {st['latent_s']:.4f} s "
             f"({st['latent']}), projection step {st['projection_s']:.4f} s, "
             f"{st['projection_iterations']} L-BFGS iterations over V, "
             f"objective in V {st['f_before']:.10g} -> {st['f_after']:.10g}"
             for i, st in enumerate(steps)))
    check(grad_err <= RTOL, f"game {coord.name}: projection gradient "
          f"{grad_err:.3g} from the float64 host recompute")
    return dict(grad_err=grad_err, steps=steps)


def host_rescore(model, n, Xg, effects):
    """Float64 host scores of a finalized GameModel, per coordinate, and
    the per-row scale Σ|x·w| each is held to."""
    out = {}
    w = model["fixed"].model.coefficients.means.cpu().numpy().astype(
        np.float64)
    Xg64 = Xg.astype(np.float64)
    out["fixed"] = (Xg64 @ w, abs(Xg64) @ np.abs(w))
    for name, keys, Xe, _ in effects:
        re = model[name]
        uniq, inv = np.unique(np.asarray(keys).astype(str),
                              return_inverse=True)
        W = np.zeros((len(uniq), re.n_features))
        for i, k in enumerate(uniq):
            cols, vals = re.coefficients[k]
            W[i, cols] = vals
        # Each stored entry x_rj times its row's entity's w_j.
        Xc = Xe.tocoo()
        xw = Xc.data.astype(np.float64) * W[inv[Xc.row], Xc.col]
        out[name] = (np.bincount(Xc.row, xw, minlength=n),
                     np.bincount(Xc.row, np.abs(xw), minlength=n))
    return out


def run_game_config(glog, label, data_fn, kernels=False, re_specs=None):
    """One GAME configuration at full width: host builds, (with
    ``kernels``) the SpMV kernels against their plain versions at the fixed
    effect's shape before any descent, the descent's timed runs, and its
    checks.  ``re_specs`` maps a random effect's name to its ``opt``
    (default: phase 6's L2 L-BFGS) and, for a factored coordinate, its
    ``rank``, ``alternations`` and ``projection_reg_weight``.  Returns
    (metrics, launches, kernel records or None, built data)."""
    import statistics

    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.game.coordinates import (
        FixedEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.factored import (
        FactoredRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.data import (
        FixedEffectDataset,
        build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.game.descent import CoordinateDescent
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    t0 = time.perf_counter()
    n, Xg, y, effects = data_fn()
    glog(f"{label}: host draw {time.perf_counter() - t0:.2f} s, {n} rows, "
         f"fixed effect {GAME_FIXED_FEATURES} wide with {Xg.nnz} entries")
    opt = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=10, tolerance=1e-6),
        regularization=RegularizationContext.l2())
    t0 = time.perf_counter()
    fe_data = make_glm_data(Xg, y, device=DEVICE)
    torch.cuda.synchronize()
    M = fe_data.features
    glog(f"{label}: make_glm_data {time.perf_counter() - t0:.3f} s (host "
         f"build; {type(M).__name__}, {M.f_idx.shape[0]} streamed entries, "
         f"{M.dense_col_ids.shape[0]} column / {M.dense_row_ids.shape[0]} row "
         f"stripes)")
    kern = None
    if kernels:
        log("phase 6: the SpMV kernels against their plain versions at the "
            "GAME fixed effect's shape")
        kern = kernel_vs_plain("game", M, torch.Generator(device=DEVICE)
                               .manual_seed(6))
        for op in ("matvec", "rmatvec"):
            r = kern[op]
            glog(f"{label}: {op} kernel {r['ms']:.4f} ms, bound "
                 f"{r['bound_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                 f"cuSPARSE {r['library_ms']:.4f} ms, max|err| "
                 f"{r['max_abs_err']:.3g}")
    coords = [FixedEffectCoordinate(
        "fixed", FixedEffectDataset(data=fe_data, n_global_rows=n),
        "logistic", opt, reg_weight=1.0)]
    passive_rows = {}
    for name, keys, Xe, cap in effects:
        t0 = time.perf_counter()
        ds = build_random_effect_dataset(
            keys, Xe, y, np.ones(n, np.float32), max_rows_per_entity=cap,
            bucket_growth=GAME_BUCKET_GROWTH, device=DEVICE)
        torch.cuda.synchronize()
        shapes = [(b.n_entities, b.rows_per_entity, b.block_dim)
                  for b in ds.blocks]
        nbytes = sum(b.X.numel() * 4 for b in ds.blocks)
        prows = torch.cat([b.row_index.reshape(-1) for b in
                           ds.passive_blocks if b is not None]
                          or [torch.zeros(0, dtype=torch.int32,
                                          device=DEVICE)])
        passive_rows[name] = prows[prows < n].long()
        check(cap is None or passive_rows[name].numel() > 0,
              f"game {label}: {name} is capped at {cap} rows but has no "
              "passive rows")
        glog(f"{label}: {name}: build_random_effect_dataset "
             f"{time.perf_counter() - t0:.3f} s (host build), "
             f"{ds.n_entities} entities in {len(ds.blocks)} buckets (E, R, D) "
             f"{shapes}, {nbytes / 1e6:.1f} MB of blocks, padding ratio "
             f"{ds.padding_ratio:.3f}, {passive_rows[name].numel()} passive "
             f"rows")
        spec = (re_specs or {}).get(name, {})
        if "rank" in spec:
            coords.append(FactoredRandomEffectCoordinate(
                name, ds, "logistic", spec["opt"], rank=spec["rank"],
                reg_weight=1.0,
                projection_reg_weight=spec["projection_reg_weight"],
                alternations=spec["alternations"], entity_key=name))
        else:
            coords.append(RandomEffectCoordinate(
                name, ds, "logistic", spec.get("opt", opt), reg_weight=1.0,
                entity_key=name))
    cd = CoordinateDescent(coords)
    base = torch.zeros(n, device=DEVICE)
    y_dev = torch.as_tensor(y, device=DEVICE)
    res_by = {c.name: c for c in coords}

    # A capped coordinate trains on its active rows only: across its update
    # the objective over those rows (+ every L2, the others' constant)
    # never rises, while the objective over all rows may.  Every other
    # update minimizes the objective over all rows.
    active = {}
    for c in coords[1:]:
        if any(b is not None for b in c.dataset.passive_blocks):
            rows = torch.zeros(n + 1, dtype=torch.bool, device=DEVICE)
            for b in c.dataset.blocks:
                rows[b.row_index.reshape(-1).long()] = True
            active[c.name] = rows[:n]

    def objectives(scores, states):
        return {"objective": game_objective(coords, y_dev, scores, states,
                                            base),
                **{f"objective_{k}": game_objective(coords, y_dev, scores,
                                                    states, base, rows)
                   for k, rows in active.items()}}

    def monitor(it, cname, scores, states):
        entry = objectives(scores, states)
        c = res_by[cname]
        stats = getattr(c, "last_solve", None)
        if stats is not None:
            entry.update(solve_summary(stats))
        rec = getattr(c, "last_train", None)
        if rec is not None:
            entry.update(
                latent=[solve_summary(st) for st in rec["latent"]],
                latent_s=list(rec["latent_s"]),
                projection_s=list(rec["projection_s"]),
                projection_iterations=[r.iterations
                                       for r in rec["projection"]])
        return entry

    def timed(n_it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cd.run(base, n_iterations=n_it)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # The main path under zeroed launch counters: one warm iteration, one
    # untimed (monitored) run of GAME_TIMED_ITERS, then GAME_TIMED_RUNS
    # timed runs of GAME_TIMED_ITERS iterations each (bench.py's protocol).
    torch.cuda.synchronize()
    _kernels.reset_launches()
    warm, warm_s = timed(1)
    torch.cuda.synchronize()
    monitored = cd.run(base, n_iterations=GAME_TIMED_ITERS, eval_fn=monitor)
    runs = [timed(GAME_TIMED_ITERS) for _ in range(GAME_TIMED_RUNS)]
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    per_iter = [s / GAME_TIMED_ITERS for _, s in runs]
    med = statistics.median(per_iter)
    spread = (max(per_iter) - min(per_iter)) / med
    glog(f"{label}: warm iteration {warm_s:.3f} s; {GAME_TIMED_RUNS} runs x "
         f"{GAME_TIMED_ITERS} iterations: {[round(p, 5) for p in per_iter]} "
         f"s an iteration, median {med:.5f} s = {1 / med:.4f} GAME "
         f"iterations/s (spread {spread:.1%})")
    glog(f"{label}: main-path launches "
         f"{json.dumps({k: v for k, v in launches.items() if v})}")
    check(launches["matvec"] > 0 and launches["rmatvec"] > 0,
          f"game {label}: the fixed effect's SpMV kernels never launched")

    # Newton bodies and host reads a coordinate update; the objective, which
    # no update may raise beyond GAME_OBJ_RISE of its value (over the
    # updated coordinate's active rows when it is capped).
    start = {k: float(v) for k, v in objectives(
        {c.name: torch.zeros_like(base) for c in coords},
        {c.name: None for c in coords}).items()}
    prev, worst = start, -float("inf")
    for h in monitored.history:
        key = "objective_" + h["coordinate"]
        key = key if key in h else "objective"
        rise = h[key] - prev[key]
        worst = max(worst, rise / abs(prev[key]))
        check(rise <= GAME_OBJ_RISE * abs(prev[key]),
              f"game {label}: {h['coordinate']}'s update raised its "
              f"objective by {rise:.6g} (limit {GAME_OBJ_RISE:g} of its "
              f"value)")
        glog(f"{label}: iteration {h['iteration']} {h['coordinate']}: "
             f"objective {h['objective']:.10g}"
             + (f" (its active rows: {h[key]:.10g})" if key != "objective"
                else "")
             + f", host wall {h['wall_seconds']:.4f} s"
             + (f", bodies a bucket {h['bodies']}, {h['host_reads']} host "
                f"reads" if "bodies" in h else "")
             + (f", line-search trials or CG steps an iteration a bucket "
                f"{h['inner_per_iteration']}" if h.get("inner_per_iteration")
                else "")
             + (f", latent steps {h['latent']}, latent-step s "
                f"{[round(t, 4) for t in h['latent_s']]}, projection-step s "
                f"{[round(t, 4) for t in h['projection_s']]}, L-BFGS "
                f"iterations over V {h['projection_iterations']}"
                if "latent" in h else ""))
        prev = h
    glog(f"{label}: objective {start['objective']:.10g} -> "
         f"{monitored.history[-1]['objective']:.10g} over "
         f"{len(monitored.history)} updates; largest relative change "
         f"across an update {worst:.3g} (a rise is allowed up to "
         f"{GAME_OBJ_RISE:g}, the float32 value noise of the fixed effect's "
         f"line search)")

    # Each coordinate's wall: train + score with a synchronize, best of 2,
    # from the warm run's states.
    scores = dict(warm.scores)
    total = base + sum(scores.values())
    walls = {}
    for c in coords:
        best = float("inf")
        for _ in range(2):
            offsets = total - scores[c.name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c.score(c.train(offsets, warm_state=warm.states[c.name]))
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        walls[c.name] = best
    glog(f"{label}: each coordinate's wall (train + score, best of 2) "
         f"{json.dumps({k: round(v, 5) for k, v in walls.items()})}")

    # A second run repeats every state and score bitwise.
    (a, _), (b, _) = runs[0], runs[1]
    for name in a.states:
        same = states_equal(a.states[name], b.states[name])
        check(same and torch.equal(a.scores[name], b.scores[name]),
              f"game {label}: {name}'s state or scores differ between runs")
    glog(f"{label}: a repeated cd.run is bitwise equal (states and scores)")

    # The descent's scores against a float64 host re-score of the model.
    last = runs[-1][0]
    model_coords = {c.name: c.finalize(last.states[c.name]) for c in coords}
    from photon_ml_tpu_torch.game.model import GameModel

    host = host_rescore(GameModel(models=model_coords, task="logistic"), n,
                        Xg, effects)
    for name, (h, scale) in host.items():
        dev = last.scores[name].double().cpu().numpy()
        err = float((np.abs(dev - h) / np.maximum(scale, 1e-30)).max())
        check(err <= RTOL, f"game {label}: {name} scores vs the host "
              f"re-score {err:.3g} of Σ|x·w|")
        glog(f"{label}: {name} scores vs float64 host re-score of the "
             f"finalized model: max err {err:.3g} of Σ|x·w|")
    for name, rows in passive_rows.items():
        if rows.numel():
            s = last.scores[name][rows]
            check(bool((s != 0).all()), f"game {label}: a passive row of "
                  f"{name} was not scored")
            glog(f"{label}: all {rows.numel()} passive rows of {name} scored")

    # Converged lanes against the float64 stopping tests, and the faults.
    total = base + sum(last.scores.values())
    checks = {}
    for c in coords[1:]:
        offsets = total - last.scores[c.name]
        if isinstance(c, FactoredRandomEffectCoordinate):
            checks[c.name] = factored_checks(glog, c, offsets, y, effects)
            continue
        re_gradient_check(glog, c, offsets)
        checks[c.name] = fallback_checks(glog, c, offsets)
    metrics = dict(iters_per_s=1 / med, spread=spread,
                   s_per_iter=per_iter, coordinate_s=walls,
                   buckets={c.name: [(b.n_entities, b.rows_per_entity,
                                      b.block_dim)
                                     for b in c.dataset.blocks]
                            for c in coords[1:]},
                   updates=[{k: v for k, v in h.items()
                             if k not in ("validation",)}
                            for h in monitored.history],
                   checks=checks)
    return metrics, launches, kern, (n, Xg, y, effects)


def game_estimator_fits(glog, built):
    """``GameEstimator.fit`` on the game_cd data with and without device
    metrics: the device AUC of every update equals the host AUC within
    1e-6.  Returns the fits' launches."""
    from photon_ml_tpu_torch.game.estimator import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    n, Xg, y, effects = built
    name, keys, Xe, _ = effects[0]
    opt = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=10, tolerance=1e-6),
        regularization=RegularizationContext.l2())
    configs = {
        "fixed": FixedEffectCoordinateConfig("global", opt, reg_weight=1.0),
        name: RandomEffectCoordinateConfig(
            name, name, opt, reg_weight=1.0,
            bucket_growth=GAME_BUCKET_GROWTH),
    }
    shards, ids = {"global": Xg, name: Xe}, {name: keys}
    hist = {}
    torch.cuda.synchronize()
    _kernels.reset_launches()
    for flag in (True, False):
        t0 = time.perf_counter()
        _, hist[flag] = GameEstimator(
            "logistic", configs, n_iterations=1, device_metrics=flag,
            device=DEVICE).fit(shards, ids, y)
        torch.cuda.synchronize()
        glog(f"estimator fit (device_metrics={flag}): "
             f"{time.perf_counter() - t0:.2f} s with its host builds; "
             f"train AUC {[h['train_metric'] for h in hist[flag]]}")
    launches = dict(_kernels.LAUNCHES)
    diff = max(abs(a["train_metric"] - b["train_metric"])
               for a, b in zip(hist[True], hist[False]))
    check(len(hist[True]) == len(hist[False]) == 2 and diff <= 1e-6,
          f"game estimator: device AUC vs host AUC differ by {diff:.3g}")
    glog(f"estimator: device AUC = host AUC within {diff:.3g} (limit 1e-6)")
    return launches


def phase_game(smi):
    """Phase 6: GAME coordinate descent at bench.py's full width
    (``game_cd`` and ``game_multi_re``).  Returns (kernel records at the
    fixed effect's shape, main-path launches, metrics)."""
    def glog(msg):
        log_phase(f"game [{smi}] {msg}")

    metrics, launches, kern, built = run_game_config(
        glog, "game_cd", game_cd_data, kernels=True)
    fit_launches = game_estimator_fits(glog, built)
    del built
    torch.cuda.empty_cache()
    m_metrics, m_launches, _, _ = run_game_config(glog, "game_multi_re",
                                                  game_multi_re_data)
    total = {op: launches[op] + fit_launches[op] + m_launches[op]
             for op in ("matvec", "rmatvec")}
    glog(f"GAME iterations/s: game_cd {metrics['iters_per_s']:.4f} (spread "
         f"{metrics['spread']:.1%}), game_multi_re "
         f"{m_metrics['iters_per_s']:.4f} (spread {m_metrics['spread']:.1%});"
         f" main-path SpMV launches {json.dumps(total)}")
    return kern, total, {"game_cd": metrics, "game_multi_re": m_metrics}


# -- phase 7: the GAME drivers ---------------------------------------------


def write_game_driver_files(td, glog):
    """GAME Avro files at ``bench_game_cd``'s width, written with the port's
    ``write_game_avro``: training rows with bench_game_cd's user draw (seed
    1: 100,000 users, zipf(1.8) rows each capped at 128, 640,155 rows), a
    ``global`` shard 512 wide with 8 normal values a row and a dense
    ``userFeatures`` shard 8 wide; labels drawn from the logistic of a true
    fixed effect plus a per-user margin.  Validation: GAME_VAL_ROWS rows from
    the same population (users drawn in proportion to their training rows),
    GAME_VAL_UNSEEN of them from users the training rows never hold.
    Returns (train path, validation path, unseen user keys)."""
    from photon_ml_tpu_torch.data.game_reader import write_game_avro

    sizes = np.minimum(np.random.default_rng(1).zipf(1.8, GAME_ENTITIES),
                       GAME_ROW_CAP)
    rng = np.random.default_rng(7)
    n_unseen_users = GAME_UNSEEN_USERS
    w_fixed = rng.normal(scale=0.5, size=GAME_FIXED_FEATURES)
    b_user = rng.normal(scale=0.5, size=(GAME_ENTITIES + n_unseen_users,
                                         GAME_RE_DIM))
    g_names = [f"g{j}" for j in range(GAME_FIXED_FEATURES)]
    x_names = [f"x{k}" for k in range(GAME_RE_DIM)]
    user_keys = np.array([f"u{i}" for i in range(GAME_ENTITIES)]
                         + [f"v{i}" for i in range(n_unseen_users)], object)

    def rows(users, prefix):
        """GAME records for the rows of ``users`` (indices into
        ``user_keys``), drawn and converted in chunks."""
        chunk = 1 << 16
        for lo in range(0, len(users), chunk):
            u = users[lo:lo + chunk]
            m = len(u)
            cols = rng.integers(0, GAME_FIXED_FEATURES,
                                size=(m, GAME_FIXED_NNZ))
            vals = rng.normal(size=(m, GAME_FIXED_NNZ))
            xu = rng.normal(size=(m, GAME_RE_DIM))
            margin = (vals * w_fixed[cols]).sum(1) + (xu * b_user[u]).sum(1)
            y = (rng.uniform(size=m) < 1 / (1 + np.exp(-margin))).tolist()
            cols, vals, xu = cols.tolist(), vals.tolist(), xu.tolist()
            keys = user_keys[u].tolist()
            for i in range(m):
                yield {
                    "uid": f"{prefix}{lo + i}", "response": float(y[i]),
                    "weight": None, "offset": None,
                    "ids": {"userId": keys[i]},
                    "features": {
                        "global": [{"name": g_names[c], "term": "",
                                    "value": v}
                                   for c, v in zip(cols[i], vals[i])],
                        "userFeatures": [{"name": x_names[k], "term": "",
                                          "value": v}
                                         for k, v in enumerate(xu[i])],
                    },
                }

    train_users = np.repeat(np.arange(GAME_ENTITIES), sizes)
    train_users = train_users[rng.permutation(len(train_users))]
    n_unseen = int(GAME_VAL_ROWS * GAME_VAL_UNSEEN)
    val_users = np.concatenate([
        rng.choice(GAME_ENTITIES, size=GAME_VAL_ROWS - n_unseen,
                   p=sizes / sizes.sum()),
        GAME_ENTITIES + rng.integers(0, n_unseen_users, size=n_unseen)])
    val_users = val_users[rng.permutation(GAME_VAL_ROWS)]
    paths = {}
    for name, users in (("train", train_users), ("validate", val_users)):
        paths[name] = os.path.join(td, f"{name}.avro")
        t0 = time.perf_counter()
        write_game_avro(paths[name], rows(users, name[0]))
        glog(f"write_game_avro {name}: {len(users)} rows in "
             f"{time.perf_counter() - t0:.1f} s (host, pure-Python Avro "
             f"writer), {os.path.getsize(paths[name]) / 1e6:.1f} MB")
    unseen = set(user_keys[GAME_ENTITIES:].tolist())
    return paths["train"], paths["validate"], unseen


def _write_game_files_worker(td):
    """The GAME Avro files of phase 7, written in a spawned process (see
    :func:`start_game_files`); its log lines go to the shared stdout."""
    write_game_driver_files(
        td, lambda msg: print(f"game drivers [file writer] {msg}",
                              flush=True))


def start_game_files(td):
    """Start writing phase 7's GAME Avro files into ``td`` in a spawned
    process: the pure-Python Avro writer takes ~100 s of host time that
    phases 2-6 hide, on cores they leave idle.  Phase 7 joins it."""
    import multiprocessing

    proc = multiprocessing.get_context("spawn").Process(
        target=_write_game_files_worker, args=(td,), name="game-files")
    proc.start()
    return proc


def game_driver_config(path, iterations, re_weights=None):
    """The driver's coordinate config: a fixed L-BFGS L2 coordinate over the
    global shard and a per-user L-BFGS L2 random effect (its D = 8 buckets
    take the Newton routes), phase 6's solver settings, two evaluators."""
    per_user = {"name": "per_user", "type": "random",
                "feature_shard": "userFeatures", "entity_key": "userId",
                "optimizer": "lbfgs", "max_iters": 10, "tolerance": 1e-6,
                "reg_type": "l2", "bucket_growth": GAME_BUCKET_GROWTH}
    if re_weights is None:
        per_user["reg_weight"] = 1.0
    else:
        per_user["reg_weights"] = list(re_weights)
    with open(path, "w") as f:
        json.dump({"task": "logistic", "iterations": iterations,
                   "evaluators": ["auc", "logistic_loss"],
                   "coordinates": [
                       {"name": "fixed", "type": "fixed",
                        "feature_shard": "global", "optimizer": "lbfgs",
                        "max_iters": 10, "tolerance": 1e-6,
                        "reg_type": "l2", "reg_weight": 1.0},
                       per_user]}, f)
    return path


class ScorerRecorder:
    """Wraps both coordinates' validation scorers during phase 7's training
    runs: counts the matvec launches they make (to tell validation
    scoring's kernel launches from training's) and, while ``record`` is
    set, keeps a copy of every state they score for the per-update check.
    Neither needs a device synchronisation; the stage times come from the
    drivers' own results."""

    def __init__(self):
        self.val_matvec = 0
        self.record = False
        self.recorded = []
        self._undo = []

    def __enter__(self):
        from photon_ml_tpu_torch.game import coordinates
        from photon_ml_tpu_torch.ops import _kernels

        rec = self

        class Scorer:
            def __init__(self, coord, inner):
                self.coord, self.inner = coord, inner

            def score(self, state):
                before = _kernels.LAUNCHES["matvec"]
                out = self.inner.score(state)
                rec.val_matvec += _kernels.LAUNCHES["matvec"] - before
                if rec.record:
                    rec.recorded.append((self.coord, state.clone()
                                         if torch.is_tensor(state)
                                         else [s.clone() for s in state]))
                return out

        from photon_ml_tpu_torch.game.streaming import (
            StreamingFixedEffectCoordinate,
        )

        for cls in (coordinates.FixedEffectCoordinate,
                    coordinates.RandomEffectCoordinate,
                    StreamingFixedEffectCoordinate):
            inner = cls.make_validation_scorer

            def make(coord, shards, ids, _inner=inner):
                return Scorer(coord, _inner(coord, shards, ids))

            self._undo.append((cls, inner))
            cls.make_validation_scorer = make
        return self

    def __exit__(self, *exc):
        for cls, inner in self._undo:
            cls.make_validation_scorer = inner


def stage_summary(stages):
    """One log line of a driver's ``stage_seconds``."""
    return "; ".join(
        f"{k} {' + '.join(f'{t:.3f}' for t in v)} s" if isinstance(v, list)
        else f"{k} {v:.3f} s" for k, v in stages.items())


def validation_rescore(coord, state, v_shards, v_ids):
    """Float64 host scores of the validation rows under one coordinate's
    device state, independent of the scorers: the fixed effect's
    coefficients against the validation CSR, a random effect's finalized
    per-entity table against the rows' dense features (entities it lacks
    score 0)."""
    from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate

    if isinstance(coord, FixedEffectCoordinate):
        return v_shards[coord.feature_shard].astype(np.float64) @ \
            state.double().cpu().numpy()
    table = coord.finalize(state).coefficients
    keys = v_ids[coord.entity_key]
    X = v_shards[coord.feature_shard].toarray().astype(np.float64)
    W = np.zeros_like(X)
    for i, k in enumerate(keys):
        entry = table.get(k) if k is not None else None
        if entry is not None:
            W[i, entry[0]] = entry[1]
    return (X * W).sum(1)


def encoder_rewrite(glog, path, td):
    """5c: the rows of the scoring file ``path`` written again through the
    native encoder and through the Python path (``PHOTON_NO_NATIVE=1``, the
    writer before the encoder); both files must be byte-equal to
    ``path``.  Returns each write's host seconds."""
    from photon_ml_tpu_torch.io import avro

    _, recs = avro.read_container(path)
    keys = list(dict.fromkeys(k for r in recs for k in r["ids"]))
    block = ([r["uid"] for r in recs],
             [r["predictionScore"] for r in recs],
             [r["label"] for r in recs],
             {k: [r["ids"].get(k) for r in recs] for k in keys})
    want = open(path, "rb").read()
    out = {}
    for name, env in (("native", None), ("python", "1")):
        old = os.environ.pop("PHOTON_NO_NATIVE", None)
        if env is not None:
            os.environ["PHOTON_NO_NATIVE"] = env
        try:
            stats = {}
            dst = os.path.join(td, f"rewrite_{name}.avro")
            t0 = time.perf_counter()
            avro.write_scoring_blocks(dst, [block], stats=stats)
            out[f"{name}_s"] = time.perf_counter() - t0
        finally:
            os.environ.pop("PHOTON_NO_NATIVE", None)
            if old is not None:
                os.environ["PHOTON_NO_NATIVE"] = old
        check(stats["encoder"] == name, f"5c: the {name} write ran the "
              f"{stats['encoder']} encoder")
        check(open(dst, "rb").read() == want, f"5c: the {name} encoder's "
              f"file differs from the scoring driver's")
        os.remove(dst)
    glog(f"5c: {len(recs)} scoring rows rewritten byte-equal by the native "
         f"encoder in {out['native_s']:.3f} s and by the Python path in "
         f"{out['python_s']:.3f} s")
    return out


def phase_game_drivers(smi, td, writer):
    """Phase 7: the GAME drivers at ``bench_game_cd``'s width, on the GAME
    Avro files that ``writer`` (:func:`start_game_files`) writes into ``td``
    (phase 8 reads them again).  Returns
    (validation-shape kernel records, training launches, validation-scoring
    matvec launches, metrics, (train path, validation path))."""
    from photon_ml_tpu_torch.data.game_reader import read_game_avro
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.drivers import (
        feature_indexing_driver,
        game_scoring_driver,
        game_training_driver,
    )
    from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite
    from photon_ml_tpu_torch.io import avro
    from photon_ml_tpu_torch.io.game_store import load_game_model
    from photon_ml_tpu_torch.native import load_game_decoder
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.ops.sparse_cuda import from_scipy_csr_cuda

    def glog(msg):
        log_phase(f"game drivers [{smi}] {msg}")

    lib = load_game_decoder()
    check(lib is not None, "the native GAME decoder did not build")
    glog(f"native GAME decoder: {lib._name}")
    metrics = {}
    t0 = time.perf_counter()
    writer.join()
    check(writer.exitcode == 0,
          f"the GAME file writer exited with {writer.exitcode}")
    glog(f"waited {time.perf_counter() - t0:.1f} s for the GAME file writer")
    train, val = (os.path.join(td, f"{n}.avro") for n in ("train",
                                                          "validate"))
    unseen = {f"v{i}" for i in range(GAME_UNSEEN_USERS)}
    cfg3 = game_driver_config(os.path.join(td, "cfg3.json"),
                              GAME_DRIVER_ITERS)
    grid = game_driver_config(os.path.join(td, "grid.json"),
                              GAME_DRIVER_ITERS, GAME_GRID_RE_WEIGHTS)
    out = {k: os.path.join(td, k) for k in ("full", "grid")}
    train_launches = {"matvec": 0, "rmatvec": 0}
    decoders = []
    with ScorerRecorder() as rec:
        def training(label, argv, record=False):
            rec.record = record
            torch.cuda.synchronize()
            _kernels.reset_launches()
            rec.val_matvec = 0
            t0 = time.perf_counter()
            res = game_training_driver.run(argv + ["--device", DEVICE])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec.record = False
            launches = dict(_kernels.LAUNCHES)
            check(launches["matvec"] > rec.val_matvec > 0
                  and launches["rmatvec"] > 0,
                  f"{label}: the SpMV kernels did not launch in training "
                  "and in validation scoring")
            for op in train_launches:
                train_launches[op] += launches[op] - (
                    rec.val_matvec if op == "matvec" else 0)
            decoders.extend(res["decoders"].values())
            stages = res["stage_seconds"]
            n_it = len({h["iteration"] for h in res["history"]})
            val_ms = [1e3 * t for t in
                      stages["validation scoring and metrics"]]
            glog(f"{label}: driver wall {wall:.2f} s (its own "
                 f"{res['wall_seconds']:.2f} s); {len(res['history'])} "
                 f"updates; validation AUC {res.get('validation_metric')};"
                 f" SpMV launches: matvec {launches['matvec']} (of them "
                 f"{rec.val_matvec} validation scoring), rmatvec "
                 f"{launches['rmatvec']}; decoders {res['decoders']}")
            glog(f"{label}: driver stages (host s): "
                 f"{stage_summary(stages)}; validation scoring and "
                 f"metrics {np.mean(val_ms):.2f} ms an update")
            metrics[label] = {"wall_s": wall,
                              "descent_s": stages["descent"],
                              "val_ms_per_update": float(np.mean(val_ms)),
                              "val_matvec": rec.val_matvec,
                              "launches": launches, "stages": stages}
            return res, n_it, stages["descent"][-1]

        common = ["--train-data", train, "--validate-data", val]
        full, n_it, descent_s = training(
            "train", common + ["--config", cfg3, "--output-dir",
                               out["full"]], record=True)
        PHASE12["game_driver"] = (common + ["--config", cfg3], out["full"])
        recorded = list(rec.recorded)
        metrics["train"]["iters_per_s"] = n_it / descent_s
        glog(f"train: {n_it} GAME iterations in {descent_s:.3f} s of "
             f"descent = {n_it / descent_s:.3f} GAME iterations/s inside "
             "the driver (with per-update validation)")
        # The grid computes its metrics on the card (--device-metrics):
        # its descents against run 1's, whose train and validation
        # metrics are host numpy.
        grid_res, _, _ = training(
            "grid", common + ["--config", grid, "--output-dir",
                              out["grid"], "--device-metrics"])
    grid_descents = metrics["grid"]["descent_s"]
    metrics["grid"]["iters_per_s"] = [GAME_DRIVER_ITERS / t
                                      for t in grid_descents]
    glog(f"grid (device metrics): {GAME_DRIVER_ITERS} GAME "
         f"iterations a point in {grid_descents} s of descent = "
         f"{metrics['grid']['iters_per_s']} GAME iterations/s")

    scoring = {}
    for label, flags in (("host", []), ("device", ["--device-metrics"])):
        _kernels.reset_launches()
        t0 = time.perf_counter()
        scoring[label] = game_scoring_driver.run([
            "--data", val, "--model-dir", out["full"],
            "--output-dir", os.path.join(td, f"score_{label}"),
            "--evaluator", "auc", "--device", DEVICE, *flags])
        torch.cuda.synchronize()
        decoders.append(scoring[label]["decoder"])
        glog(f"scoring ({label} metric): wall "
             f"{time.perf_counter() - t0:.2f} s (its own "
             f"{scoring[label]['wall_seconds']:.2f} s), AUC "
             f"{scoring[label]['metric']!r}; driver stages (host s): "
             f"{stage_summary(scoring[label]['stage_seconds'])}")
        metrics[f"scoring {label}"] = scoring[label]["stage_seconds"]
    t0 = time.perf_counter()
    fi = feature_indexing_driver.run([
        "--data", train, "--output-dir", os.path.join(td, "maps")])
    glog(f"feature indexing: {fi} in {time.perf_counter() - t0:.2f} s")
    glog(f"GAME decoders of the drivers' reads: {decoders}")
    check(decoders and set(decoders) == {"native"},
          f"a GAME file was not decoded natively: {decoders}")
    encoders = [scoring[label]["encoder"] for label in scoring]
    glog(f"score encoders of the drivers' writes: {encoders}")
    check(set(encoders) == {"native"},
          f"a scoring file was not encoded natively: {encoders}")
    metrics["encoder"] = encoder_rewrite(
        glog, os.path.join(td, "score_host", "scores.avro"), td)

    # The scoring driver's scores against a float64 host re-score of
    # the saved model, loaded back with the port's load_game_model.
    t0 = time.perf_counter()
    model, imaps = load_game_model(os.path.join(out["full"], "models"),
                                   device="cpu")
    glog(f"load_game_model: {time.perf_counter() - t0:.2f} s")
    v_shards, v_ids, v_y, v_w, v_off, v_uids, _ = read_game_avro(
        val, index_maps=imaps)
    _, recs = avro.read_container(os.path.join(td, "score_host",
                                               "scores.avro"))
    got = np.array([r["predictionScore"] for r in recs])
    check([r["uid"] for r in recs] == list(v_uids),
          "scores.avro rows are not the validation rows in order")
    w = model["fixed"].model.coefficients.means.numpy().astype(
        np.float64)
    Xg = v_shards["global"].astype(np.float64)
    host, scale = Xg @ w, abs(Xg) @ np.abs(w)
    re = model["per_user"]
    Xu = v_shards["userFeatures"].toarray().astype(np.float64)
    W = np.zeros_like(Xu)
    keys = v_ids["userId"]
    for i, k in enumerate(keys):
        if k in re.coefficients:
            W[i, re.coefficients[k][0]] = re.coefficients[k][1]
    host = host + (Xu * W).sum(1) + v_off
    scale = scale + (np.abs(Xu) * np.abs(W)).sum(1)
    err = float((np.abs(got - host) / np.maximum(scale, 1e-30)).max())
    n_unseen = sum(k in unseen for k in keys)
    check(n_unseen > 0 and not any(k in re.coefficients for k in unseen),
          "the model holds coefficients for users the training rows "
          "never hold")
    check(err <= RTOL, f"scoring driver vs float64 host re-score: "
          f"{err:.3g} of Σ|x·w|")
    glog(f"scoring driver vs float64 host re-score of the saved model: "
         f"max err {err:.3g} of Σ|x·w| over {len(got)} rows "
         f"({n_unseen} rows of unseen users, random effect 0)")

    check(abs(scoring["host"]["metric"] - full["validation_metric"])
          <= 1e-6, "the scoring driver's AUC differs from the training "
          "driver's validation_metric")
    check(abs(scoring["device"]["metric"] - scoring["host"]["metric"])
          <= 1e-6, "--device-metrics AUC differs from the host AUC")
    glog(f"AUC: training driver {full['validation_metric']!r}, scoring "
         f"driver {scoring['host']['metric']!r}, device metric "
         f"{scoring['device']['metric']!r}")

    # Every per-update validation metric against a float64 host
    # re-score of that update's states (one recorded scorer call an
    # update in a fresh run).
    hist = full["history"]
    check(len(recorded) == len(hist), f"recorded {len(recorded)} scorer "
          f"calls for {len(hist)} updates")
    suite = EvaluationSuite.from_specs(["auc", "logistic_loss"])
    parts, worst = {}, 0.0
    for h, (coord, state) in zip(hist, recorded):
        check(h["coordinate"] == coord.name, "scorer calls out of order")
        parts[coord.name] = validation_rescore(coord, state, v_shards,
                                               v_ids)
        want = suite.evaluate(v_off + sum(parts.values()), v_y, v_w)
        for k, v in want.items():
            d = abs(h["validation"][k] - v)
            worst = max(worst, d)
            check(d <= 1e-6, f"update {h['iteration']} {h['coordinate']}"
                  f": validation {k} {h['validation'][k]!r} vs host "
                  f"re-score {v!r}")
    glog(f"per-update validation metrics vs float64 host re-scores of "
         f"each update's states: max |diff| {worst:.3g} over "
         f"{len(hist)} updates; AUC by update "
         f"{[round(h['validation_metric'], 6) for h in hist]}")
    check(hist[-1]["validation_metric"] > hist[0]["validation_metric"],
          "the random effect does not raise the validation AUC over the "
          "fixed effect alone")

    # The grid selects the point with the better validation metric.
    pts = grid_res["grid"]
    best = max(pts, key=lambda g: g["metric"])
    check(len(pts) == 2 and pts[0]["metric"] != pts[1]["metric"]
          and best["best"] and sum(g["best"] for g in pts) == 1,
          f"the grid's selection is not its best validation AUC: {pts}")
    glog(f"grid: {[(g['reg_weights']['per_user'], g['metric']) for g in pts]}"
         f"; selected per_user reg_weight "
         f"{best['reg_weights']['per_user']}")
    check(fi["n_rows"] == full["n_rows"] and fi["shards"] == {
        "global": GAME_FIXED_FEATURES, "userFeatures": GAME_RE_DIM},
        f"feature indexing: {fi}")
    check(dict(IndexMap.load(os.path.join(td, "maps", "global"))) ==
          dict(imaps["global"]), "feature indexing's global map differs "
          "from the training driver's")

    # The row kernel at the validation matrix's shape, against its
    # plain version (phase 2's checks).
    log("phase 7: the SpMV kernels against their plain versions at the "
        "validation matrix's shape")
    M = from_scipy_csr_cuda(v_shards["global"], device=DEVICE)
    kern = kernel_vs_plain("game_val", M,
                           torch.Generator(device=DEVICE).manual_seed(7))
    val_launches = sum(metrics[k]["val_matvec"] for k in (
        "train", "grid"))
    glog(f"main-path launches: training matvec "
         f"{train_launches['matvec']}, rmatvec "
         f"{train_launches['rmatvec']}; validation scoring matvec "
         f"{val_launches}")
    return kern, train_launches, val_launches, metrics, (train, val)


# -- phase 8: the batched random-effect fallback and the factored effect ---


def game_cd_wide_data():
    """The ``bench_game_cd`` draw with the per-user random effect over the
    512-wide ``global`` shard (8 values a row): buckets up to D = 461."""
    n, Xg, y, effects = game_cd_data()
    name, users, _, cap = effects[0]
    return n, Xg, y, [(name, users, Xg, cap)]


def game_multi_re_factored_data():
    """The ``bench_game_multi_re`` draw: the fixed effect, ``per_user`` (8
    wide, as phase 6) and ``per_item`` over the 512-wide ``global`` shard
    (factored: the item shard is 8 wide, and rank 8 would factor
    nothing)."""
    n, Xg, y, effects = game_multi_re_data()
    user, item = effects[0], effects[1]
    return n, Xg, y, [user, (item[0], item[1], Xg, item[3])]


def game_re_opt(optimizer="LBFGS", reg="l2"):
    """Phase 6's random-effect solver settings (10 iterations at 1e-6)
    with another optimizer or regularization (elastic net at α = 0.5)."""
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    return GlmOptimizationConfig(
        optimizer=OptimizerConfig(optimizer=OptimizerType[optimizer],
                                  max_iters=10, tolerance=1e-6),
        regularization=(RegularizationContext.elastic_net(0.5)
                        if reg == "elastic_net"
                        else RegularizationContext.l2()))


def fallback_driver_config(path, iterations, per_user):
    """A driver config: phase 7's fixed effect and ``per_user`` as given."""
    fixed = {"name": "fixed", "type": "fixed", "feature_shard": "global",
             "optimizer": "lbfgs", "max_iters": 10, "tolerance": 1e-6,
             "reg_type": "l2", "reg_weight": 1.0}
    with open(path, "w") as f:
        json.dump({"task": "logistic", "iterations": iterations,
                   "evaluators": ["auc", "logistic_loss"],
                   "coordinates": [fixed, dict(
                       {"name": "per_user", "entity_key": "userId",
                        "max_iters": 10, "tolerance": 1e-6,
                        "bucket_growth": GAME_BUCKET_GROWTH,
                        "reg_weight": 1.0}, **per_user)]}, f)
    return path


def phase_fallback_drivers(glog, td, train, val):
    """Phase 8d: ``game_training_driver`` on phase 7's GAME Avro files with
    (i) a per-user elastic-net random effect (the batched OWL-QN) and (ii) a
    per-user factored random effect over ``global`` (rank 8), run through
    and killed after iteration 1 and ``--resume``d.  (ii)'s model is not
    scored here: its load takes ≈ 27 s on the card's host, and
    ``tests/test_torch_game_drivers.py::TestFactoredDriver`` holds the
    scoring driver's AUC to the training driver's.  Returns (training
    launches, validation-scoring matvec launches, metrics)."""
    from photon_ml_tpu_torch.drivers import game_training_driver
    from photon_ml_tpu_torch.ops import _kernels

    en = {"type": "random", "feature_shard": "userFeatures",
          "optimizer": "lbfgs", "reg_type": "elastic_net",
          "elastic_net_alpha": 0.5}
    fact = {"type": "factored_random", "feature_shard": "global",
            "optimizer": "lbfgs", "reg_type": "l2", "rank": 8,
            "alternations": 2, "projection_reg_weight": 0.1}
    launches = {"matvec": 0, "rmatvec": 0}
    val_launches = 0
    metrics = {}
    common = ["--train-data", train, "--validate-data", val,
              "--device", DEVICE]
    with ScorerRecorder() as rec:
        def training(label, cfg, out, flags=()):
            nonlocal val_launches
            torch.cuda.synchronize()
            _kernels.reset_launches()
            rec.val_matvec = 0
            t0 = time.perf_counter()
            res = game_training_driver.run(
                common + ["--config", cfg, "--output-dir", out, *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ls = dict(_kernels.LAUNCHES)
            check(ls["matvec"] > rec.val_matvec > 0 and ls["rmatvec"] > 0,
                  f"{label}: the SpMV kernels did not launch in training and "
                  "in validation scoring")
            launches["matvec"] += ls["matvec"] - rec.val_matvec
            launches["rmatvec"] += ls["rmatvec"]
            val_launches += rec.val_matvec
            stages = res["stage_seconds"]
            n_it = len({h["iteration"] for h in res["history"]})
            glog(f"{label}: driver wall {wall:.2f} s; {n_it} GAME iterations "
                 f"in {stages['descent'][-1]:.3f} s of descent = "
                 f"{n_it / stages['descent'][-1]:.3f} GAME iterations/s (with "
                 f"per-update validation and the host train metric); "
                 f"validation AUC {res.get('validation_metric')}; SpMV "
                 f"launches {ls['matvec']} / {ls['rmatvec']} (validation "
                 f"scoring {rec.val_matvec}); driver stages (host s): "
                 f"{stage_summary(stages)}")
            metrics[label] = {"wall_s": wall, "stages": stages,
                              "iters_per_s": n_it / stages["descent"][-1],
                              "launches": ls}
            return res

        cfg_en = fallback_driver_config(os.path.join(td, "en.json"),
                                        GAME_DRIVER_ITERS, en)
        res_en = training("elastic net", cfg_en, os.path.join(td, "en"))
        check(res_en["history"][-1]["validation_metric"]
              > res_en["history"][0]["validation_metric"],
              "the elastic-net random effect does not raise the validation "
              "AUC over the fixed effect alone")
        out = {k: os.path.join(td, f"fact_{k}") for k in ("full", "resumed")}
        cfg2 = fallback_driver_config(os.path.join(td, "fact2.json"), 2, fact)
        full = training("factored", cfg2, out["full"])
        # Killed for real, so the killed run saves no model (a factored
        # save takes ≈ 35 s).
        run_killed_after_iteration_1(lambda: training(
            "factored, kill after iteration 1", cfg2, out["resumed"]))
        glog("factored: the run was killed after iteration 1's checkpoint")
        resumed = training("factored, resume to 2", cfg2, out["resumed"],
                           ["--resume"])
    for rel in ("fixed-effect/fixed/coefficients.avro",
                "random-effect/per_user/coefficients.avro"):
        a, b = (open(os.path.join(out[k], "models", rel), "rb").read()
                for k in ("full", "resumed"))
        check(a == b, f"the resumed factored model's {rel} differs from the "
              "uninterrupted run's")
    check([h["iteration"] for h in resumed["history"]]
          == [h["iteration"] for h in full["history"]],
          "the resumed factored history differs")
    glog("factored: killed after iteration 1 and resumed to 2: the saved "
         "model files equal the uninterrupted run's byte for byte")
    return launches, val_launches, metrics


def phase_game_fallback(smi, td, train, val):
    """Phase 8: the batched random-effect fallback and the factored random
    effect at full width (8a ``game_cd_l1``, 8b ``game_cd_wide_re`` with
    L-BFGS and TRON, 8c ``game_multi_re_factored``) and through the drivers
    (8d).  Returns (training launches, validation-scoring matvec launches,
    metrics)."""
    def glog(msg):
        log_phase(f"game fallback [{smi}] {msg}")

    metrics = {}
    launches = {"matvec": 0, "rmatvec": 0}
    runs = (
        ("game_cd_l1", game_cd_data,
         {"per_user": {"opt": game_re_opt(reg="elastic_net")}}),
        ("game_cd_wide_re.lbfgs", game_cd_wide_data,
         {"per_user": {"opt": game_re_opt("LBFGS")}}),
        ("game_cd_wide_re.tron", game_cd_wide_data,
         {"per_user": {"opt": game_re_opt("TRON")}}),
        ("game_multi_re_factored", game_multi_re_factored_data,
         {"per_item": {"opt": game_re_opt(), "rank": 8, "alternations": 2,
                       "projection_reg_weight": 0.1}}),
    )
    for label, data_fn, specs in runs:
        phase_header(f"phase 8: {label}")
        m, ls, _, _ = run_game_config(glog, label, data_fn, re_specs=specs)
        metrics[label] = m
        for op in launches:
            launches[op] += ls[op]
        torch.cuda.empty_cache()
    phase_header("phase 8d: the drivers")
    d_launches, d_val, metrics["drivers"] = phase_fallback_drivers(
        glog, td, train, val)
    for op in launches:
        launches[op] += d_launches[op]
    glog("GAME iterations/s: " + ", ".join(
        f"{k} {metrics[k]['iters_per_s']:.4f}" for k, *_ in runs)
        + f"; main-path SpMV launches {json.dumps(launches)}, validation "
        f"scoring matvec {d_val}")
    return launches, d_val, metrics


# -- phase 9: out-of-core GLM training -----------------------------------


class SpmvTimer:
    """Within the block, every ``spmv_rows``/``spmv_cols`` call the kernel
    matrix makes runs between two CUDA events on the current stream;
    :meth:`ms` sums the launches' device time."""

    def __enter__(self):
        from photon_ml_tpu_torch.ops import sparse_cuda

        self.events = []
        self.saved = {name: getattr(sparse_cuda, name)
                      for name in ("spmv_rows", "spmv_cols")}

        def timed(fn):
            def run(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a, **kw)
                end.record()
                self.events.append((start, end))
                return out
            return run

        for name, fn in self.saved.items():
            setattr(sparse_cuda, name, timed(fn))
        return self

    def __exit__(self, *exc):
        from photon_ml_tpu_torch.ops import sparse_cuda

        for name, fn in self.saved.items():
            setattr(sparse_cuda, name, fn)
        return False

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class ChunkStepTimer:
    """Within the block, every ``GlmObjective.raw_value_and_grad`` call (a
    streamed value pass's work on one chunk, after the compute stream has
    waited for the chunk's copy) runs between two CUDA events on the
    current stream; :meth:`ms` sums the steps' spans, an upper bound of the
    time the card computes in a pass (a span also holds the gaps between
    its launches)."""

    def __enter__(self):
        from photon_ml_tpu_torch.optim.objective import GlmObjective

        self.events = []
        self.saved = GlmObjective.raw_value_and_grad
        saved, events = self.saved, self.events

        def timed(obj, *a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = saved(obj, *a, **kw)
            end.record()
            events.append((start, end))
            return out

        GlmObjective.raw_value_and_grad = timed
        return self

    def __exit__(self, *exc):
        from photon_ml_tpu_torch.optim.objective import GlmObjective

        GlmObjective.raw_value_and_grad = self.saved
        return False

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def streamed_vs_resident(obj, w, data, abs_F, l2, v_s, g_s):
    """(value error relative to Σ|weight·ℓ| + ½·l2·‖w‖², largest gradient
    error relative to its Σ|x·u| + l2·|w|) of a streamed (value, grad)
    against the resident objective at ``w``."""
    v_r, g_r = obj.value_and_grad(w, data, l2)
    m = obj.margins(w, data)
    vscale = (data.weights * obj.loss.value(m, data.labels)).abs().sum() + (
        0.5 * l2 * torch.dot(w, w))
    u = (data.weights * obj.loss.d1(m, data.labels)).abs()
    gscale = abs_F.rmatvec(u) + l2 * w.abs()
    return (abs(float(v_s) - float(v_r)) / float(vscale),
            float(((g_s - g_r).abs() / gscale.clamp_min(1e-30)).max()))


def bitwise(a, b):
    return all(torch.equal(x, z) for x, z in zip(a, b))


def decode_bounds_hold(codec, bufs, mode):
    """Chunk ``bufs`` decoded on the card from ``codec``'s wire against its
    raw leaves: integer and {0,1} leaves exact; float leaves within
    rtol 1e-3 / atol 1e-4 (fp16) or maxabs/127 + 1e-7 of the leaf (int8).
    Returns the largest error relative to its bound."""
    wire = [torch.as_tensor(a, device=DEVICE) for a in codec.encode(bufs)]
    raw = [torch.as_tensor(np.asarray(a), device=DEVICE) for a in bufs]
    got = codec.unpack_device(wire)
    ref = codec.staging.unpack_device(raw)
    worst = 0.0
    for name, r in ref.items():
        g = got[name]
        check(g.dtype == r.dtype and g.shape == r.shape,
              f"{mode} decode of {name}: {g.dtype}{tuple(g.shape)}")
        if r.numel() == 0:
            continue
        exact = (not r.is_floating_point()
                 or bool(((r == 0) | (r == 1)).all()))
        if exact:
            check(torch.equal(g, r), f"{mode} decode of {name} not exact")
            continue
        r64, g64 = r.double(), g.double()
        if mode == "fp16":
            bound = 1e-3 * r64.abs() + 1e-4
        else:
            bound = torch.full_like(r64, float(r64.abs().max()) / 127 + 1e-7)
        worst = max(worst, float(((g64 - r64).abs() / bound).max()))
    return worst


def phase_streaming(smi, bench, data, abs_F, X, lib_metrics):
    """Phases 9a and 9b: the streamed objective and solvers at full width
    over phase 3's matrix (2^20 x 8192, 32 normal values a row, seed 0,
    logistic), built into kernel-layout chunk stores.  Returns (valued
    main-path launches, metrics, the 4-chunk store)."""
    from photon_ml_tpu_torch.data.staging import plan_compression
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.ops import _kernels, losses
    from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig
    from photon_ml_tpu_torch.optim.objective import GlmObjective
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )
    from photon_ml_tpu_torch.optim.lbfgs import lbfgs_solve
    from photon_ml_tpu_torch.optim.streaming import (
        StreamingObjective,
        streaming_run_grid,
    )

    def slog(msg):
        log_phase(f"streaming [{smi}] {msg}")

    t_phase = time.perf_counter()
    y = bench[3]
    total = {op: 0 for op in OPS}
    metrics = {}

    def build(label, n_chunks, **kw):
        t0 = time.perf_counter()
        st = make_streaming_glm_data(X, y, chunk_rows=N_ROWS // n_chunks,
                                     device=DEVICE, **kw)
        secs = time.perf_counter() - t0
        check(st.kind == "kernel" and st.n_chunks == n_chunks,
              f"streaming {label}: {st.n_chunks} {st.kind} chunks")
        slog(f"{label}: {st.n_chunks} chunks x {st.chunk_rows} rows, "
             f"{st.nbytes() / 1e9:.4f} GB of host buffers, built in "
             f"{secs:.2f} s (phase 3's resident build {lib_metrics['build_s']:.2f} "
             f"s); row groups {sorted({c.meta['row_group'] for c in st.chunks})}"
             f", column groups {sorted({c.meta['col_group'] for c in st.chunks})}")
        return st, secs

    def main_path(label, fn, sobjs):
        """One main-path run under zeroed launch counters."""
        torch.cuda.synchronize()
        _kernels.reset_launches()
        passes0 = [o.transfer_stats.passes for o in sobjs]
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {op: _kernels.LAUNCHES[op] for op in OPS}
        for op in OPS:
            total[op] += launches[op]
        passes = sum(o.transfer_stats.passes - p
                     for o, p in zip(sobjs, passes0))
        check(launches["matvec"] > 0 and launches["rmatvec"] > 0,
              f"streaming {label}: matvec/rmatvec never launched")
        slog(f"{label}: wall {wall:.3f} s, {passes} passes, launches "
             f"{json.dumps({k: v for k, v in launches.items() if v})} "
             f"({launches['matvec'] / max(passes, 1):.2f} spmv_rows and "
             f"{launches['rmatvec'] / max(passes, 1):.2f} spmv_cols "
             "launches a pass)")
        return out, wall, passes

    # -- 9a: the streamed objective ----------------------------------------
    store, build_s = build("store", STREAM_CHUNKS)
    # Part (chunk 0, shard 0) of phase 12b's 4-way sharded store.
    PHASE12["chunk_shard"] = X[:N_ROWS // STREAM_CHUNKS // GROUP_RANKS]
    metrics["build_s"] = build_s
    obj = GlmObjective(losses.get("logistic"))
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    w = torch.randn(N_FEATURES, device=DEVICE, generator=gen) * 0.05
    l2 = 1.0
    s2 = StreamingObjective(obj, store, prefetch_depth=2)
    vg2, _, _ = main_path("9a value+grad (depth 2)",
                          lambda: s2.value_and_grad(w, l2), [s2])
    val_err, grad_err = streamed_vs_resident(obj, w, data, abs_F, l2, *vg2)
    check(val_err <= RTOL and grad_err <= RTOL,
          f"streaming: value {val_err:.3g} / gradient {grad_err:.3g} "
          "against the resident objective")
    slog(f"9a against phase 3's resident objective: value rel err "
         f"{val_err:.3g}, gradient err {grad_err:.3g} of Σ|x·u| (rtol "
         f"{RTOL:g})")
    s1 = StreamingObjective(obj, store, prefetch_depth=1)
    vg1, _, _ = main_path("9a value+grad (depth 1)",
                          lambda: s1.value_and_grad(w, l2), [s1])
    check(bitwise(vg1, vg2), "streaming: depth 1 != depth 2 bitwise")
    sf = StreamingObjective(obj, store, chunk_fuse=2)
    vgf, _, _ = main_path("9a value+grad (fuse 2)",
                          lambda: sf.value_and_grad(w, l2), [sf])
    check(bitwise(vgf, vg2), "streaming: fuse 2 != fuse 1 bitwise")
    ws = torch.stack([w, 0.5 * w, w + 0.01 * torch.randn(
        N_FEATURES, device=DEVICE, generator=gen)])
    vb, gb = main_path("9a value+grad batch (3 candidates)",
                       lambda: s2.value_and_grad_batch(ws, l2), [s2])[0]
    for i in range(3):
        vi, gi = s2.value_and_grad(ws[i], l2)
        check(torch.equal(vb[i], vi) and torch.equal(gb[i], gi),
              f"streaming: batched row {i} != its single evaluation")
    slog("9a bitwise: depth 1 = depth 2, fuse 2 = fuse 1, each batched "
         "row = its single evaluation")
    disk_dir = tempfile.mkdtemp(prefix="photon_stream_store_")
    try:
        disk, _ = build("disk store (memmaps)", STREAM_CHUNKS,
                        storage_dir=disk_dir)
        sd = StreamingObjective(obj, disk)
        vgd, _, _ = main_path("9a value+grad (disk store)",
                              lambda: sd.value_and_grad(w, l2), [sd])
        check(bitwise(vgd, vg2), "streaming: disk store != RAM store")
        slog(f"9a disk store = RAM store bitwise; disk pass pack "
             f"{sd.transfer_stats.pack_seconds:.3f} s")
        del sd, disk
    finally:
        shutil.rmtree(disk_dir, ignore_errors=True)
    # Kahan and float32 accumulation against a float64 host value.
    X64 = X.astype(np.float64)
    w64 = w.double().cpu().numpy()
    m64 = X64 @ w64
    v64 = float(np.sum(np.logaddexp(0.0, m64) - y.astype(np.float64) * m64)
                + 0.5 * l2 * w64 @ w64)
    del X64, m64
    sk = StreamingObjective(obj, store, accumulate="kahan")
    vk = main_path("9a value+grad (kahan)",
                   lambda: sk.value_and_grad(w, l2), [sk])[0][0]
    err_k = abs(float(vk) - v64) / abs(v64)
    err_f = abs(float(vg2[0]) - v64) / abs(v64)
    check(err_k <= 1e-6, f"streaming: kahan value {err_k:.3g} from f64")
    slog(f"9a value against a float64 host sum: kahan {err_k:.3g}, f32 "
         f"{err_f:.3g} relative (bound 1e-6)")

    # Rates: the streamed pass beside the resident one, per-stage wall.
    def timed_passes(sobj, label):
        sobj.transfer_stats.reset()
        times = []

        def run():
            for _ in range(STREAM_TIMED_PASSES):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sobj.value_and_grad(w, l2)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)

        main_path(label, run, [sobj])
        st = sobj.transfer_stats
        n = st.passes
        pass_s = sorted(times)[len(times) // 2]
        rec = dict(pass_ms=1e3 * pass_s, rows_per_s=N_ROWS / pass_s,
                   h2d_gbps=st.gbps,
                   chunk_bytes=st.bytes / max(st.chunks, 1),
                   pack_ms=1e3 * st.pack_seconds / n,
                   h2d_ms=1e3 * st.h2d_seconds / n,
                   h2d_device_ms=1e3 * st.h2d_device_seconds / n,
                   consume_ms=1e3 * st.consume_seconds / n,
                   consumer_stalls=st.consumer_stalls / n,
                   consumer_stall_ms=1e3 * st.consumer_stall_seconds / n,
                   producer_stalls=st.producer_stalls / n,
                   producer_stall_ms=1e3 * st.producer_stall_seconds / n,
                   pack_stalls=st.pack_stalls / n,
                   pack_stall_ms=1e3 * st.pack_stall_seconds / n)
        slog(f"{label}: median pass {rec['pass_ms']:.2f} ms = "
             f"{rec['rows_per_s']:.4g} rows/s ({rec['rows_per_s'] / lib_metrics['rows_per_s']:.4f} "
             f"of the resident {lib_metrics['rows_per_s']:.4g}); H2D "
             f"{rec['h2d_gbps']:.2f} GB/s over CUDA events, "
             f"{rec['chunk_bytes'] / 1e6:.1f} MB a transfer; per pass: pack "
             f"{rec['pack_ms']:.2f} ms, h2d {rec['h2d_ms']:.2f} ms (copy "
             f"{rec['h2d_device_ms']:.2f} ms), consume "
             f"{rec['consume_ms']:.2f} ms, consumer stalls "
             f"{rec['consumer_stalls']:.2f} ({rec['consumer_stall_ms']:.2f} "
             f"ms), producer stalls {rec['producer_stalls']:.2f} "
             f"({rec['producer_stall_ms']:.2f} ms), pack waits for a pinned "
             f"slot {rec['pack_stalls']:.2f} ({rec['pack_stall_ms']:.2f} ms)")
        return rec

    for depth in (1, 2):
        so = s1 if depth == 1 else s2
        metrics[f"depth{depth}"] = timed_passes(
            so, f"9a timed passes (depth {depth})")
    with SpmvTimer() as timer, ChunkStepTimer() as steps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s2.value_and_grad(w, l2)
        torch.cuda.synchronize()
        pass_ms = 1e3 * (time.perf_counter() - t0)
    spmv_ms = timer.ms()
    step_ms = steps.ms()
    metrics["spmv_ms_per_pass"] = spmv_ms
    metrics["spmv_share"] = spmv_ms / pass_ms
    metrics["chunk_steps_ms_per_pass"] = step_ms
    metrics["compute_share"] = step_ms / pass_ms
    slog(f"9a SpMV launches of one depth-2 pass under CUDA events: "
         f"{len(timer.events)} launches, {spmv_ms:.3f} ms of a "
         f"{pass_ms:.2f} ms pass ({100 * spmv_ms / pass_ms:.1f} %); the "
         f"{len(steps.events)} chunk steps' spans on the compute stream "
         f"{step_ms:.3f} ms ({100 * step_ms / pass_ms:.1f} % busy at most, "
         f"compute stream idle {100 * (1 - step_ms / pass_ms):.1f} % at "
         "least)")

    # The oversubscribed leg: 16 chunks, lossless wire, hot cache at 0.7 of
    # the wire store, bitwise equal to the raw stream.
    store16, _ = build("oversubscribed store", STREAM_OVERSUB_CHUNKS)
    t0 = time.perf_counter()
    wire_total = sum(plan_compression(st, [b], "lossless").wire_nbytes
                     for st, b in zip(store16.staging, store16.staged))
    raw16 = StreamingObjective(obj, store16)
    ta = StreamingObjective(obj, store16, compress="lossless",
                            hot_budget_bytes=int(STREAM_HOT_FRACTION
                                                 * wire_total))
    slog(f"9a oversubscribed: lossless codecs planned and encoded in "
         f"{time.perf_counter() - t0:.2f} s; wire {wire_total / 1e9:.4f} GB "
         f"(ratio {ta.compression_ratio:.4f}), hot budget "
         f"{ta.hot_budget_bytes / 1e9:.4f} GB")
    for k in range(3):
        vr, _, _ = main_path(f"9a oversubscribed raw pass {k + 1}",
                             lambda: raw16.value_and_grad(w, l2), [raw16])
        ta_chunks = ta.transfer_stats.chunks
        ta_bytes = ta.transfer_stats.bytes
        vt, wall, _ = main_path(
            f"9a oversubscribed lossless+hot pass {k + 1}",
            lambda: ta.value_and_grad(w, l2), [ta])
        check(bitwise(vr, vt), f"streaming: lossless+hot pass {k + 1} != "
              "the raw stream bitwise")
        slog(f"9a oversubscribed pass {k + 1}: {ta.transfer_stats.chunks - ta_chunks} "
             f"transfers, {(ta.transfer_stats.bytes - ta_bytes) / 1e6:.1f} MB "
             f"on the wire, cache hits {ta._hot_cache.hits}, resident "
             f"{ta._hot_cache.resident_bytes / 1e6:.1f} MB; bitwise equal to "
             f"the raw stream")
    check(ta._hot_cache.hits > 0, "streaming: the hot cache never hit")
    metrics["compression_ratio"] = ta.compression_ratio
    metrics["oversub_raw"] = timed_passes(raw16, "9a oversubscribed raw")
    metrics["oversub_hot"] = timed_passes(ta, "9a oversubscribed "
                                              "lossless+hot")
    del ta, raw16
    for mode in ("fp16", "int8"):
        codec = plan_compression(store16.staging[0], [store16.staged[0]],
                                 mode)
        worst = decode_bounds_hold(codec, store16.staged[0], mode)
        check(worst <= 1.0, f"streaming: {mode} decode {worst:.3g} x its "
              "bound")
        slog(f"9a {mode}: chunk 0 decoded on the card within {worst:.3f} of "
             f"its bound (kinds {codec.kinds}, ratio {codec.ratio:.3f})")
    del store16

    # -- 9b: streamed solvers ----------------------------------------------
    def problem(reg, optimizer=OptimizerType.LBFGS, tol=1e-7, max_iters=30,
                accumulate="f32", variances=False):
        return GlmOptimizationProblem("logistic", GlmOptimizationConfig(
            optimizer=OptimizerConfig(optimizer=optimizer,
                                      max_iters=max_iters, tolerance=tol),
            regularization=reg, compute_variances=variances),
            accumulate=accumulate)

    # L2 L-BFGS over phase 3's grid and config, against its objectives.
    p3 = problem(RegularizationContext.l2(), variances=True)
    so3 = StreamingObjective(p3.objective, store)
    grid, wall, passes = main_path(
        "9b L-BFGS L2 grid", lambda: streaming_run_grid(
            p3, so3, list(GRID)), [so3])
    for lam, model, res in grid:
        value = float(res.values[res.iterations])
        gap = abs(value - lib_metrics["grid_values"][lam]) / abs(value)
        check(gap <= 1e-5, f"streaming λ={lam}: objective {value} vs "
              f"resident {lib_metrics['grid_values'][lam]} ({gap:.3g})")
        var = model.coefficients.variances
        check(bool(torch.isfinite(var).all() and (var > 0).all()),
              f"streaming λ={lam}: variances")
        slog(f"9b L-BFGS λ={lam:g}: {res.iterations} iterations, converged "
             f"{res.converged}, objective {value:.9g} vs resident "
             f"{lib_metrics['grid_values'][lam]:.9g} (gap {gap:.3g})")
    metrics["lbfgs_grid"] = dict(wall_s=wall, passes=passes, iterations=[
        res.iterations for _, _, res in grid])

    # Elastic-net OWL-QN over phase 3b's α and λs, its KKT conditions.
    alpha = 0.5
    obj0 = problem(RegularizationContext.l2(), accumulate="f64").objective
    _, g0 = obj0.value_and_grad(torch.zeros(N_FEATURES, device=DEVICE), data)
    lam_max = float(torch.quantile(g0.abs(), 0.5)) / alpha
    en_grid = [lam_max, lam_max / 10, lam_max / 100]
    en = problem(RegularizationContext.elastic_net(alpha),
                 tol=OWLQN_TOL, max_iters=200, accumulate="f64")
    soe = StreamingObjective(en.objective, store)
    out, wall, passes = main_path(
        "9b OWL-QN elastic-net grid", lambda: streaming_run_grid(
            en, soe, en_grid), [soe])
    w_prev = None
    en_recs = []
    for lam, _, res in out:
        l1 = float(np.float32(alpha) * np.float32(lam))
        l2e = float(np.float32(1 - alpha) * np.float32(lam))
        half_p = problem(RegularizationContext.elastic_net(alpha),
                         tol=OWLQN_TOL, max_iters=res.iterations // 2,
                         accumulate="f64")
        half = streaming_run_grid(half_p, soe, [lam], w0=w_prev)[0][2]
        full = kkt_residuals(res, en.objective, data, l1, l2e)
        cut = kkt_residuals(half, en.objective, data, l1, l2e)
        zeros = int((res.w == 0).sum())
        slog(f"9b OWL-QN λ={lam:.6g}: {res.iterations} iterations, "
             f"converged {res.converged}, {zeros} zeros; KKT |g|/λ1 at zeros "
             f"{full[0]:.6g} (<= {1 + KKT_ZERO:g}), decrement {full[2]:.3g} "
             f"(<= {KKT_DECREMENT:g}); stopped after {half.iterations}: "
             f"{cut[0]:.6g}, {cut[2]:.3g}")
        check(res.converged and kkt_holds(full),
              f"streaming OWL-QN λ={lam}: KKT {full}")
        check(not kkt_holds(cut),
              f"streaming OWL-QN λ={lam}: the half solve passes the KKT "
              "check")
        en_recs.append(dict(lam=lam, iterations=res.iterations,
                            zeros=zeros))
        w_prev = res.w
    check(en_recs[0]["zeros"] >= N_FEATURES // 10,
          "streaming OWL-QN: the largest λ zeroes too few coefficients")
    metrics["owlqn_grid"] = dict(wall_s=wall, passes=passes, grid=en_recs)

    # L-BFGS at λ = 1, one trial a pass and batched: the same iterations
    # and bitwise the same w in no more passes; TRON lands on its value.
    lb = problem(RegularizationContext.l2(), tol=SOLVE_TOL, max_iters=300,
                 accumulate="f64")
    sol = StreamingObjective(lb.objective, store)
    cfg = LBFGSConfig(max_iters=300, tolerance=SOLVE_TOL)
    w0 = torch.zeros(N_FEATURES, device=DEVICE)
    seq, wall_seq, passes_seq = main_path(
        "9b L-BFGS λ=1, one trial a pass", lambda: lbfgs_solve(
            lambda v: sol.value_and_grad(v, 1.0), w0, cfg), [sol])
    bat, wall_bat, passes_bat = main_path(
        "9b L-BFGS λ=1, batched line search", lambda: lbfgs_solve(
            lambda v: sol.value_and_grad(v, 1.0), w0, cfg,
            value_and_grad_batch=lambda ws: sol.value_and_grad_batch(
                ws, 1.0)), [sol])
    check(bat.iterations == seq.iterations and torch.equal(bat.w, seq.w),
          f"streaming: batched line search {bat.iterations} iterations vs "
          f"{seq.iterations}, w bitwise {torch.equal(bat.w, seq.w)}")
    check(passes_bat <= passes_seq,
          f"streaming: batched {passes_bat} passes > {passes_seq}")
    slog(f"9b batched line search: {seq.iterations} iterations both, w "
         f"bitwise equal; passes a solve {passes_seq} -> {passes_bat} "
         f"({passes_seq / max(seq.iterations, 1):.2f} -> "
         f"{passes_bat / max(bat.iterations, 1):.2f} an iteration); wall "
         f"{wall_seq:.2f} -> {wall_bat:.2f} s")
    tp = problem(RegularizationContext.l2(), OptimizerType.TRON,
                 tol=SOLVE_TOL, max_iters=100, accumulate="f64")
    sot = StreamingObjective(tp.objective, store)
    tron, wall_t, passes_t = main_path(
        "9b TRON λ=1", lambda: streaming_run_grid(
            tp, sot, [1.0])[0][2], [sot])
    gap = abs(float(tron.value) - float(bat.value)) / abs(float(bat.value))
    check(tron.converged and gap <= 1e-5,
          f"streaming TRON: objective gap {gap:.3g} to L-BFGS, converged "
          f"{tron.converged}")
    slog(f"9b TRON λ=1: {tron.iterations} iterations, converged, "
         f"{passes_t} passes ({passes_t - tron.iterations - 1} HVP passes, "
         f"{(passes_t - tron.iterations - 1) / max(tron.iterations, 1):.2f} "
         f"an iteration), objective gap to L-BFGS {gap:.3g}")
    metrics["batched"] = dict(iterations=seq.iterations, passes_seq=passes_seq,
                              passes_bat=passes_bat, wall_seq_s=wall_seq,
                              wall_bat_s=wall_bat)
    metrics["tron"] = dict(iterations=tron.iterations, passes=passes_t,
                           wall_s=wall_t, gap=gap)
    slog(f"phase 9a-9b: {time.perf_counter() - t_phase:.1f} s wall; "
         f"launches {json.dumps(total)}")
    return total, metrics


def _solves_from_log(out):
    """Per-λ (final objective, iterations) from the GLM driver's log."""
    with open(os.path.join(out, "photon.log")) as f:
        return {float(m.group(1)): (float(m.group(2)), int(m.group(3)))
                for m in re.finditer(
                    r"lambda=([0-9.e+-]+): value=(\S+) iters=(\d+)",
                    f.read())}


def _files(root, prefix=""):
    """Every file under ``root`` whose name starts with ``prefix``, by
    relative path, as bytes."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.startswith(prefix):
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = f.read()
    return out


def phase_stream_drivers(smi, files, drv_runs, game_td, game_files):
    """Phase 9c: the GLM driver's streamed route on phase 4's LIBSVM files
    (4 chunks of 32,768 rows from a disk store), its --initial-model,
    --training-report and --max-retries, and the GAME training driver's
    --max-retries on phase 7's files.  Returns (binary launches, GAME-shape
    launches, metrics)."""
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.data.libsvm import read_libsvm
    from photon_ml_tpu_torch.drivers import glm_driver, game_training_driver
    from photon_ml_tpu_torch.evaluation.evaluators import (
        AreaUnderROCCurveEvaluator,
    )
    from photon_ml_tpu_torch.game import descent
    from photon_ml_tpu_torch.io.model_store import load_glm_model
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.optim import lbfgs as port_lbfgs

    def slog(msg):
        log_phase(f"stream drivers [{smi}] {msg}")

    t_phase = time.perf_counter()
    train, val = files
    td = os.path.dirname(train)
    X_val, y_val = read_libsvm(val, n_features=N_FEATURES,
                               add_intercept=True, drop_out_of_range=True)
    total = {}
    metrics = {}

    def run(label, flags, grid="0.1,1,10"):
        out = os.path.join(td, "stream_" + label.replace(" ", "_"))
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        res = glm_driver.run([
            "--train-data", train, "--validate-data", val,
            "--output-dir", out, "--task", "logistic", *flags,
            "--reg-weights", grid, "--max-iters", "50",
            "--n-features", str(N_FEATURES), "--device", DEVICE,
            "--stream-chunk-rows", str(STREAM_DRIVER_CHUNK_ROWS),
            "--stream-storage-dir", os.path.join(out, "store")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        st = res["streaming"]
        passes = st["transfer"]["passes"]
        check(st["chunks"] == DRIVER_TRAIN_ROWS // STREAM_DRIVER_CHUNK_ROWS
              and st["disk"] and st["layout"] == "kernel",
              f"stream driver {label}: store {st}")
        check(launches["matvec_unit"] > 0 and launches["rmatvec_unit"] > 0,
              f"stream driver {label}: the SpMV kernels never launched")
        slog(f"{label}: {wall:.2f} s end to end (store built in "
             f"{st['build_seconds']:.2f} s), selected λ="
             f"{res['best_lambda']:g}, AUCs {res['metrics']}; {passes} "
             f"passes, launches "
             f"{json.dumps({k: v for k, v in launches.items() if v})} "
             f"({launches['matvec_unit'] / max(passes, 1):.2f} spmv_rows and "
             f"{launches['rmatvec_unit'] / max(passes, 1):.2f} spmv_cols a "
             f"pass); H2D {st['transfer']['gbps']:.2f} GB/s")
        metrics[label] = dict(wall_s=wall, passes=passes,
                              build_s=st["build_seconds"])
        return res, out

    def rescored(res, out):
        imap = IndexMap.load(out)
        for lam, auc in res["metrics"].items():
            model, _ = load_glm_model(
                os.path.join(out, f"model_lambda_{float(lam):g}.avro"),
                index_map=imap, device=DEVICE)
            w = model.coefficients.means.cpu().numpy().astype(np.float64)
            host = AreaUnderROCCurveEvaluator().evaluate(X_val @ w, y_val)
            check(abs(auc - host) <= 1e-6,
                  f"stream driver: λ={lam} AUC {auc} vs host {host}")

    # The streamed L2 and elastic-net runs select the resident runs' λ;
    # every saved model's AUC equals a host re-score.
    l2, l2_out = run("l2", ["--reg-type", "l2", "--output-mode", "all",
                            "--training-report"])
    PHASE12["glm_stream"] = (train, val, l2_out)
    en, en_out = run("elastic_net", ["--reg-type", "elastic_net",
                                     "--optimizer", "owlqn",
                                     "--output-mode", "all"])
    for label, res, out in (("l2", l2, l2_out), ("elastic_net", en, en_out)):
        resident = drv_runs[label][1]
        check(res["best_lambda"] == resident["best_lambda"],
              f"stream driver {label}: λ {res['best_lambda']} vs the "
              f"resident run's {resident['best_lambda']}")
        rescored(res, out)
        slog(f"{label}: selects the resident run's λ={res['best_lambda']:g}"
             f" (resident AUCs {resident['metrics']}); every saved model's "
             "AUC = its host re-score within 1e-6")
    rep = json.load(open(os.path.join(l2_out, "report.json")))
    for kind in ("convergence", "metric", "calibration",
                 "feature_importance"):
        lams = sorted(s_["lambda"] for s_ in rep["sections"]
                      if s_["kind"] == kind)
        check(lams == [0.1, 1.0, 10.0], f"training report {kind}: {lams}")
    check(os.path.getsize(os.path.join(l2_out, "report.html")) > 0,
          "training report: no report.html")
    slog("--training-report: report.json and report.html carry every λ")

    # --initial-model: phase 4's L2 model warm-starts its own λ.
    best = drv_runs["l2"][1]["best_lambda"]
    init = os.path.join(drv_runs["l2"][0], f"model_lambda_{best:g}.avro")
    _, cold_out = run("cold", ["--reg-type", "l2"], grid=f"{best:g}")
    _, warm_out = run("initial_model", ["--reg-type", "l2",
                                        "--initial-model", init],
                      grid=f"{best:g}")
    (f_c, it_c), (f_w, it_w) = (_solves_from_log(o)[best]
                                for o in (cold_out, warm_out))
    gap = abs(f_w - f_c) / abs(f_c)
    check(it_w < it_c and gap <= 1e-5,
          f"--initial-model: {it_w} iterations vs cold {it_c}, objective "
          f"gap {gap:.3g}")
    slog(f"--initial-model λ={best:g}: {it_w} iterations vs cold {it_c}, "
         f"objective {f_w:.9g} vs {f_c:.9g} (gap {gap:.3g})")
    metrics["initial_model"] = dict(iterations=it_w, cold_iterations=it_c,
                                    gap=gap)

    # --max-retries: one transport-style failure injected into the second
    # λ's solve; the retried run's models equal the uninterrupted run's.
    orig = port_lbfgs.lbfgs_solve
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("UNAVAILABLE: injected transport drop")
        return orig(*a, **kw)

    port_lbfgs.lbfgs_solve = flaky
    try:
        retried, retry_out = run("retried", [
            "--reg-type", "l2", "--output-mode", "all", "--max-retries", "1",
            "--retry-backoff", "0"])
    finally:
        port_lbfgs.lbfgs_solve = orig
    with open(os.path.join(retry_out, "training_result.json")) as f:
        saved = json.load(f)
    check(saved.get("retry", {}).get("retries") == 1 and len(calls) == 4,
          f"--max-retries: retry record {saved.get('retry')}, "
          f"{len(calls)} solves")
    check(_files(retry_out, "model_lambda_") == _files(l2_out,
                                                       "model_lambda_"),
          "--max-retries: the retried run's model files differ from the "
          "uninterrupted run's")
    slog(f"--max-retries: {saved['retry']['failures'][0]['message']!r} "
         f"retried once (the first λ restored from its checkpoint, "
         f"{len(calls) - 2} solves after the failure); model files "
         "byte-equal to the uninterrupted run's")

    # The GAME training driver: one failure in its second CD iteration.
    gtrain, gval = game_files
    orig_run = descent.CoordinateDescent.run
    cd_calls = []

    def flaky_cd(self, base_offsets, n_iterations=1, checkpointer=None,
                 **kw):
        cd_calls.append(1)
        if len(cd_calls) == 1:
            orig_run(self, base_offsets, n_iterations=1,
                     checkpointer=checkpointer, **kw)
            raise RuntimeError("UNAVAILABLE: injected transport drop")
        return orig_run(self, base_offsets, n_iterations=n_iterations,
                        checkpointer=checkpointer, **kw)

    descent.CoordinateDescent.run = flaky_cd
    gout = os.path.join(game_td, "retried")
    try:
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        gres = game_training_driver.run([
            "--train-data", gtrain, "--validate-data", gval, "--config",
            os.path.join(game_td, "cfg3.json"), "--output-dir", gout,
            "--max-retries", "1", "--retry-backoff", "0",
            "--device", DEVICE])
        torch.cuda.synchronize()
        gwall = time.perf_counter() - t0
        game_launches = {op: _kernels.LAUNCHES[op]
                         for op in ("matvec", "rmatvec")}
    finally:
        descent.CoordinateDescent.run = orig_run
    check(gres.get("retry", {}).get("retries") == 1 and len(cd_calls) == 2,
          f"GAME --max-retries: retry record {gres.get('retry')}")
    check(_files(os.path.join(gout, "models"))
          == _files(os.path.join(game_td, "full", "models")),
          "GAME --max-retries: model files differ from phase 7's "
          "uninterrupted run")
    slog(f"GAME training driver --max-retries: one failure after iteration "
         f"1, resumed from the CD checkpoint; {gwall:.2f} s; model files "
         f"byte-equal to phase 7's uninterrupted run; launches "
         f"{json.dumps(game_launches)}")
    metrics["game_retry_wall_s"] = gwall
    slog(f"phase 9c: {time.perf_counter() - t_phase:.1f} s wall")
    return total, game_launches, metrics


# -- phase 10: GAME out of core ---------------------------------------------

#: 10a and 10d: each random effect's device budget is this fraction of its
#: host blocks' bytes; 10b and 10c: the wide effects'.
OOC_BUDGET_DIV = 8
OOC_WIDE_BUDGET_DIV = 4
#: tests/test_ooc_random.py's coefficient and score tolerances.
OOC_COEF_TOL = 1e-5
OOC_SCORE_TOL = 1e-4
OOC_MEMORY_RATIO = 0.5
OOC_FACTORED_TOL = 1e-4
OOC_OBJ_TOL = 1e-5
OOC_CHUNK_ROWS = 1 << 17
OOC_SCORE_BLOCK_ROWS = 65536


def host_block_bytes(ds):
    """Bytes of a random-effect dataset's blocks, active and passive."""
    blocks = list(ds.blocks) + [b for b in ds.passive_blocks if b is not None]
    return int(sum(int(a.nbytes) for b in blocks for a in b.leaves()))


def ooc_offsets(n, seed):
    """Seeded per-row offsets on the card (the other coordinates' scores a
    single coordinate trains against)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(0.5 * rng.normal(size=n).astype(np.float32),
                           device=DEVICE)


def transfer_summary(snap):
    """One log line of a ``TransferStats.snapshot()``."""
    p = max(snap["passes"], 1)
    return (f"{snap['passes']} passes, {snap['chunks']} group transfers, "
            f"{snap['bytes'] / 1e6:.1f} MB; a pass: pack "
            f"{1e3 * snap['pack_seconds'] / p:.2f} ms, h2d "
            f"{1e3 * snap['h2d_seconds'] / p:.2f} ms (copy stream "
            f"{1e3 * snap['h2d_device_seconds'] / p:.2f} ms, "
            f"{snap['gbps']:.2f} GB/s), consume "
            f"{1e3 * snap['consume_seconds'] / p:.2f} ms; stalls: pack "
            f"{snap['pack_stalls']}, producer {snap['producer_stalls']}, "
            f"consumer {snap['consumer_stalls']}; live groups <= "
            f"{snap['max_live']}")


def device_peak(fn):
    """(fn's result, its peak device bytes above the bytes allocated when
    it started, its wall seconds)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base, \
        time.perf_counter() - t0


def ooc_updates(coord, offsets, updates=1, prestage=False):
    """``updates`` chained train + score updates of an out-of-core
    coordinate (warm-started from the last).  Each: (state, scores,
    train s, score s, last_solve, hot-cache hits)."""
    out, state = [], None
    for _ in range(updates):
        if prestage:
            coord.prestage(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = coord.train(offsets, warm_state=state)
        torch.cuda.synchronize()
        check(1 <= coord.live_groups_high_water <= coord.prefetch_depth,
              f"ooc {coord.name}: {coord.live_groups_high_water} groups "
              f"live in a train pass, depth {coord.prefetch_depth}")
        t1 = time.perf_counter()
        scores = coord.score(state)
        torch.cuda.synchronize()
        check(1 <= coord.live_groups_high_water <= coord.prefetch_depth,
              f"ooc {coord.name}: {coord.live_groups_high_water} groups "
              f"live in a score pass")
        cache = coord.hot_cache
        out.append((state, scores, t1 - t0, time.perf_counter() - t1,
                    dict(coord.last_solve),
                    None if cache is None else cache.hits))
    return out


def ooc_bitwise(label, a, b):
    """Every update's state and scores of two runs bitwise equal."""
    check(len(a) == len(b), f"ooc {label}: {len(a)} vs {len(b)} updates")
    for i, (x, y) in enumerate(zip(a, b)):
        check(states_equal(x[0], y[0]) and torch.equal(x[1], y[1]),
              f"ooc {label}: update {i} is not bitwise equal")


def ooc_random_effect(glog, name, keys, Xe, cap, y, offsets, opt, tmp):
    """10a for one random effect: the host dataset, its plan at an eighth
    of its bytes, the in-plan bitwise checks (repeat, depth 1 = depth 2,
    prestaged, memmap, a hot cache at half the static bytes over three
    updates), and the resident coordinate within 1e-5 / 1e-4.  Returns
    (host dataset, resident dataset, metrics)."""
    from photon_ml_tpu_torch.data.streaming import (
        spill_random_effect_dataset,
    )
    from photon_ml_tpu_torch.game.coordinates import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.data import build_random_effect_dataset
    from photon_ml_tpu_torch.game.ooc_random import (
        OutOfCoreRandomEffectCoordinate,
    )

    n = len(y)
    t0 = time.perf_counter()
    host = build_random_effect_dataset(
        keys, Xe, y, np.ones(n, np.float32), max_rows_per_entity=cap,
        bucket_growth=GAME_BUCKET_GROWTH, device=False)
    build_s = time.perf_counter() - t0
    nbytes = host_block_bytes(host)
    budget = nbytes // OOC_BUDGET_DIV

    def make(ds=host, budget=budget, **kw):
        return OutOfCoreRandomEffectCoordinate(
            name, ds, "logistic", opt, reg_weight=1.0, entity_key=name,
            device_budget_bytes=budget, device=DEVICE, **kw)

    c = make()
    plan = c.pass_plan
    n_slices = sum(map(len, plan))
    check(len(plan) >= 8 and any(s.lane_lo > 0 for g in plan for s in g),
          f"ooc {name}: {len(plan)} groups and no entity-axis split at "
          f"budget {budget}")
    glog(f"10a {name}: host build {build_s:.3f} s, {len(host.blocks)} "
         f"buckets, {nbytes / 1e6:.2f} MB of host blocks, budget "
         f"{budget} B (1/{OOC_BUDGET_DIV}): {len(plan)} pass groups, "
         f"{n_slices} slices")
    first = ooc_updates(c, offsets)
    _, _, train_s, score_s, solve, _ = first[0]
    glog(f"10a {name}: first update train {train_s:.4f} s, score "
         f"{score_s:.4f} s; lockstep bodies a group {solve['bodies']}, "
         f"{solve['host_reads']} host reads; {transfer_summary(c.transfer_stats.snapshot())}")
    three = ooc_updates(c, offsets, 3)
    ooc_bitwise(f"{name} repeat", first, three[:1])
    d1 = make(budget=budget // 2, prefetch_depth=1)
    check(d1.pass_plan == plan, f"ooc {name}: the depth-1 plan differs")
    ooc_bitwise(f"{name} depth 1 = depth 2", first, ooc_updates(d1, offsets))
    ooc_bitwise(f"{name} prestaged", first,
                ooc_updates(c, offsets, prestage=True))
    spilled = spill_random_effect_dataset(host, os.path.join(tmp, name))
    check(isinstance(spilled.blocks[0].X, np.memmap),
          f"ooc {name}: the spilled dataset is not memmapped")
    ooc_bitwise(f"{name} memmap = RAM", first,
                ooc_updates(make(ds=spilled), offsets))
    static = sum(c._group_static_bytes(k, g) for g in plan
                 for k in ("train", "score"))
    hot = make(hot_budget_bytes=static // 2)
    hot_runs = ooc_updates(hot, offsets, 3)
    ooc_bitwise(f"{name} hot cache = uncached", three, hot_runs)
    hits = [r[5] for r in hot_runs]
    check(hits[0] == 0 and hits[-1] > 0,
          f"ooc {name}: hot-cache hits by update {hits}")
    glog(f"10a {name}: bitwise in one plan: repeat, depth 1 = depth 2, "
         f"prestaged, memmap = RAM, hot cache at {static // 2} B (half the "
         f"static {static} B) over 3 updates = uncached (hits by update "
         f"{hits}, {hot.hot_cache.resident_bytes} B resident); hot updates "
         f"train {[round(r[2], 4) for r in hot_runs]} s vs uncached "
         f"{[round(r[2], 4) for r in three]} s")

    t0 = time.perf_counter()
    res_ds = build_random_effect_dataset(
        keys, Xe, y, np.ones(n, np.float32), max_rows_per_entity=cap,
        bucket_growth=GAME_BUCKET_GROWTH, device=DEVICE)
    res = RandomEffectCoordinate(name, res_ds, "logistic", opt,
                                 reg_weight=1.0, entity_key=name)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    st_r = res.train(offsets)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sc_r = res.score(st_r)
    torch.cuda.synchronize()
    res_train_s = t2 - t1
    coef_err = max(float(np.abs(a - b.cpu().numpy()).max())
                   for a, b in zip(first[0][0], st_r))
    score_err = float((first[0][1] - sc_r).abs().max())
    check(coef_err <= OOC_COEF_TOL and score_err <= OOC_SCORE_TOL,
          f"ooc {name}: against the resident coordinate coefficients "
          f"{coef_err:.3g} (limit {OOC_COEF_TOL:g}), scores {score_err:.3g}"
          f" (limit {OOC_SCORE_TOL:g})")
    glog(f"10a {name}: vs the resident coordinate (device build "
         f"{t1 - t0:.3f} s, train {res_train_s:.4f} s, "
         f"{res.last_solve.host_reads} host reads, bodies a bucket "
         f"{res.last_solve.bodies}): coefficients max |diff| "
         f"{coef_err:.3g} (limit {OOC_COEF_TOL:g}), scores {score_err:.3g} "
         f"(limit {OOC_SCORE_TOL:g})")
    metrics = dict(groups=len(plan), slices=n_slices, budget=budget,
                   host_bytes=nbytes, train_s=train_s, score_s=score_s,
                   bodies=solve["bodies"], host_reads=solve["host_reads"],
                   resident_train_s=res_train_s,
                   resident_host_reads=res.last_solve.host_reads,
                   transfer=c.transfer_stats.snapshot(), coef_err=coef_err,
                   score_err=score_err, hot_hits=hits)
    return host, res_ds, metrics


def ooc_wide_memory(glog, tmp):
    """10b: the wide per-user effect (phase 8b's, 884 MB of blocks) out of
    core at a quarter of its bytes: the device bytes it needs against the
    resident coordinate's, and its coefficients against them."""
    from photon_ml_tpu_torch.game.coordinates import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.data import build_random_effect_dataset
    from photon_ml_tpu_torch.game.ooc_random import (
        OutOfCoreRandomEffectCoordinate,
    )

    n, _, y, effects = game_cd_wide_data()
    name, keys, Xe, cap = effects[0]
    opt = game_re_opt("LBFGS")
    offsets = ooc_offsets(n, 101)
    t0 = time.perf_counter()
    host = build_random_effect_dataset(
        keys, Xe, y, np.ones(n, np.float32), max_rows_per_entity=cap,
        bucket_growth=GAME_BUCKET_GROWTH, device=False)
    build_s = time.perf_counter() - t0
    nbytes = host_block_bytes(host)
    c = OutOfCoreRandomEffectCoordinate(
        name, host, "logistic", opt, reg_weight=1.0, entity_key=name,
        device_budget_bytes=nbytes // OOC_WIDE_BUDGET_DIV, device=DEVICE)

    (st_o, sc_o), ooc_bytes, ooc_s = device_peak(
        lambda: (lambda st: (st, c.score(st)))(c.train(offsets)))
    res_ds = build_random_effect_dataset(
        keys, Xe, y, np.ones(n, np.float32), max_rows_per_entity=cap,
        bucket_growth=GAME_BUCKET_GROWTH, device=DEVICE)
    ds_bytes = int(sum(a.numel() * a.element_size() for b in res_ds.blocks
                       for a in b.leaves()))
    res = RandomEffectCoordinate(name, res_ds, "logistic", opt,
                                 reg_weight=1.0, entity_key=name)
    (st_r, sc_r), res_peak, res_s = device_peak(
        lambda: (lambda st: (st, res.score(st)))(res.train(offsets)))
    res_bytes = ds_bytes + res_peak
    ratio = ooc_bytes / res_bytes
    scale = max(float(torch.linalg.vector_norm(w, dim=1).max())
                for w in st_r)
    err = max(float(np.abs(a - b.cpu().numpy()).max())
              for a, b in zip(st_o, st_r))
    glog(f"10b {name}: {len(host.blocks)} buckets (E, R, D) "
         f"{[(b.n_entities, b.rows_per_entity, b.block_dim) for b in host.blocks]}"
         f", {nbytes / 1e6:.1f} MB host blocks (build {build_s:.2f} s); "
         f"budget 1/{OOC_WIDE_BUDGET_DIV}: {len(c.pass_plan)} groups, "
         f"{sum(map(len, c.pass_plan))} slices. Device bytes: out of core "
         f"{ooc_bytes / 1e6:.1f} MB (the update's peak above its baseline), "
         f"resident {res_bytes / 1e6:.1f} MB (dataset {ds_bytes / 1e6:.1f} "
         f"MB + the update's peak {res_peak / 1e6:.1f} MB), ratio "
         f"{ratio:.4f} (limit {OOC_MEMORY_RATIO}); wall (train + score) "
         f"{ooc_s:.3f} s out of core, {res_s:.3f} s resident; bodies a "
         f"group {c.last_solve['bodies']}, {c.last_solve['host_reads']} host"
         f" reads vs resident bodies {res.last_solve.bodies}, "
         f"{res.last_solve.host_reads} reads; coefficients max |diff| "
         f"{err:.3g} = {err / scale:.3g} of the largest ||w|| "
         f"(limit {FALLBACK_F32_TOL:g}); {transfer_summary(c.transfer_stats.snapshot())}")
    check(ratio <= OOC_MEMORY_RATIO,
          f"ooc 10b: out-of-core device bytes {ooc_bytes} > "
          f"{OOC_MEMORY_RATIO} x resident {res_bytes}")
    check(err <= FALLBACK_F32_TOL * scale,
          f"ooc 10b: coefficients {err:.3g} from the resident coordinate")
    return dict(ooc_bytes=ooc_bytes, resident_bytes=res_bytes, ratio=ratio,
                dataset_bytes=ds_bytes, ooc_s=ooc_s, resident_s=res_s,
                groups=len(c.pass_plan), coef_err_rel=err / scale,
                bodies=c.last_solve["bodies"],
                transfer=c.transfer_stats.snapshot())


def ooc_factored(glog):
    """10c: phase 8c's factored ``per_item`` (over ``global``, rank 8, two
    alternations, projection λ 0.1) out of core at a quarter of its bytes:
    the device bytes it holds between passes (no more than V and its
    gradient) and its update's peak against the resident coordinate's (as
    10b); its alternations stepped again by hand from the cold start (the
    projection gradient against a float64 host recompute and bitwise
    repeatable, no projection step raising the objective in V, the end
    state and scores bitwise train's); coefficients and scores against the
    resident factored coordinate."""
    from photon_ml_tpu_torch.game.data import build_random_effect_dataset
    from photon_ml_tpu_torch.game.factored import (
        FactoredRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.ooc_factored import (
        OutOfCoreFactoredRandomEffectCoordinate,
    )

    n, _, y, effects = game_multi_re_factored_data()
    name, keys, Xe, cap = effects[1]
    opt = game_re_opt()
    kw = dict(rank=8, reg_weight=1.0, projection_reg_weight=0.1,
              alternations=2, entity_key=name)
    offsets = ooc_offsets(n, 103)
    t0 = time.perf_counter()
    host = build_random_effect_dataset(
        keys, Xe, y, np.ones(n, np.float32), max_rows_per_entity=cap,
        bucket_growth=GAME_BUCKET_GROWTH, device=False)
    build_s = time.perf_counter() - t0
    nbytes = host_block_bytes(host)
    budget = nbytes // OOC_WIDE_BUDGET_DIV
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    c = OutOfCoreFactoredRandomEffectCoordinate(
        name, host, "logistic", opt, device_budget_bytes=budget,
        device=DEVICE, **kw)
    torch.cuda.synchronize()
    # What the coordinate keeps on the card between passes: V₀ only, not
    # anything that grows with the dataset.
    held = torch.cuda.memory_allocated() - before
    check(held <= c._budget_overhead_bytes(),
          f"ooc 10c: the coordinate holds {held} device bytes between "
          f"passes, over its {c._budget_overhead_bytes()}-byte whole-pass "
          "overhead")

    def train_score(coord):
        t0 = time.perf_counter()
        state = coord.train(offsets)
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0, coord.score(state)

    (st, train_s, sc), ooc_bytes, _ = device_peak(lambda: train_score(c))
    rec = c.last_train
    tables = [sum(a.nbytes for sl in g for a in (
        c._grad_tables[sl][0], *c._grad_tables[sl][1],
        c._grad_tables[sl][2])) for g in c.pass_plan]
    group_budget = (budget - c._budget_overhead_bytes()) // c.prefetch_depth
    glog(f"10c {name}: {len(host.blocks)} buckets, {nbytes / 1e6:.1f} MB "
         f"host blocks (build {build_s:.2f} s), budget 1/"
         f"{OOC_WIDE_BUDGET_DIV} = {budget / 1e6:.1f} MB: "
         f"{len(c.pass_plan)} groups of up to {group_budget / 1e6:.1f} MB "
         f"planned, the projection step's gather tables up to "
         f"{max(tables) / 1e6:.1f} MB a group ({sum(tables) / 1e6:.1f} MB "
         f"in all, on the host); device bytes held between passes {held}; "
         f"train + score peak {ooc_bytes / 1e6:.1f} MB above its baseline "
         f"= {ooc_bytes / budget:.3f} of the budget; train "
         f"{train_s:.3f} s (latent steps {[round(t, 3) for t in rec['latent_s']]}"
         f" s, projection steps {[round(t, 3) for t in rec['projection_s']]} "
         f"s, L-BFGS iterations over V "
         f"{[r.iterations for r in rec['projection']]}); "
         f"{transfer_summary(c.transfer_stats.snapshot())}")

    # By hand from the cold start, phase 8's checks; the steps are train's
    # own, so their end state repeats train's bitwise.
    X64 = Xe.tocsr().astype(np.float64)
    uniq, inv = np.unique(np.asarray(keys).astype(str), return_inverse=True)
    slots = [host.entity_to_slot[k] for k in uniq]
    off_h = offsets.double().cpu().numpy()
    y64 = y.astype(np.float64)
    l2v = c._reg3()[2]

    def host_f(u_list, V):
        U = np.stack([u_list[bi][lane] for bi, lane in slots])[inv]
        U = U.astype(np.float64)
        V = V.double().cpu().numpy()
        m = ((X64 @ V) * U).sum(1) + off_h
        dm = 1 / (1 + np.exp(-m)) - y64
        f = float((np.logaddexp(0.0, m) - y64 * m).sum()
                  + 0.5 * l2v * (V * V).sum())
        G = X64.T @ (dm[:, None] * U) + l2v * V
        G_abs = abs(X64).T @ (np.abs(dm)[:, None] * np.abs(U)) \
            + l2v * np.abs(V)
        return f, G, G_abs

    padded = c._padded_offsets(offsets)
    u_list = [np.zeros((b.n_entities, c.rank), np.float32)
              for b in host.blocks]
    V = c._v0
    grad_err, steps = 0.0, []
    for _ in range(c.alternations):
        c.latent_step(padded, u_list, V)
        _, g = c.projection_value_grad(V.reshape(-1), padded, u_list)
        _, g2 = c.projection_value_grad(V.reshape(-1), padded, u_list)
        check(torch.equal(g, g2), "ooc 10c: the projection gradient "
              "differs between two passes")
        f0, G, G_abs = host_f(u_list, V)
        err = np.abs(g.view(V.shape).double().cpu().numpy() - G) \
            / np.maximum(G_abs, 1e-30)
        grad_err = max(grad_err, float(err.max()))
        V_new, res_v = c.projection_step(padded, u_list, V)
        f1 = host_f(u_list, V_new)[0]
        check(f1 - f0 <= GAME_OBJ_RISE * abs(f0),
              f"ooc 10c: a projection step raised the objective in V from "
              f"{f0:.10g} to {f1:.10g}")
        steps.append((f0, f1, res_v.iterations))
        V = V_new
    check(grad_err <= RTOL, f"ooc 10c: projection gradient {grad_err:.3g} "
          "from the float64 host recompute")
    check(states_equal(u_list, st[0]) and torch.equal(V, st[1])
          and torch.equal(c.score((u_list, V)), sc),
          "ooc 10c: a repeated train is not bitwise equal")

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    res_ds = build_random_effect_dataset(
        keys, Xe, y, np.ones(n, np.float32), max_rows_per_entity=cap,
        bucket_growth=GAME_BUCKET_GROWTH, device=DEVICE)
    res = FactoredRandomEffectCoordinate(name, res_ds, "logistic", opt, **kw)
    torch.cuda.synchronize()
    res_held = torch.cuda.memory_allocated() - before
    (st_r, res_s, sc_r), res_peak, _ = device_peak(lambda: train_score(res))
    res_bytes = res_held + res_peak
    ratio = ooc_bytes / res_bytes
    glog(f"10c {name}: device bytes out of core {ooc_bytes / 1e6:.1f} MB, "
         f"resident {res_bytes / 1e6:.1f} MB (dataset and gather tables "
         f"{res_held / 1e6:.1f} MB + the update's peak "
         f"{res_peak / 1e6:.1f} MB), ratio {ratio:.4f} (limit "
         f"{OOC_MEMORY_RATIO})")
    check(ratio <= OOC_MEMORY_RATIO,
          f"ooc 10c: out-of-core device bytes {ooc_bytes} > "
          f"{OOC_MEMORY_RATIO} x resident {res_bytes}")
    w_o, w_r = c.materialize(st), [w.cpu().numpy()
                                   for w in res.materialize(st_r)]
    w_scale = max(float(np.abs(w).max()) for w in w_r)
    w_err = max(float(np.abs(a - b).max()) for a, b in zip(w_o, w_r))
    s_scale = float(sc_r.abs().max())
    s_err = float((sc - sc_r).abs().max())
    glog(f"10c {name}: projection gradient vs float64 host recompute "
         f"{grad_err:.3g} of Σ|terms| (limit {RTOL:g}), bitwise repeatable;"
         f" the steps by hand repeat train's state and scores bitwise;"
         f" objective in V by alternation "
         f"{[(round(a, 4), round(b, 4), i) for a, b, i in steps]}; vs the "
         f"resident factored coordinate (train {res_s:.3f} s): coefficients "
         f"{w_err:.3g} = {w_err / w_scale:.3g} of the largest |w|, scores "
         f"{s_err:.3g} = {s_err / s_scale:.3g} of the largest |score| "
         f"(limit {OOC_FACTORED_TOL:g})")
    check(w_err <= OOC_FACTORED_TOL * w_scale
          and s_err <= OOC_FACTORED_TOL * s_scale,
          f"ooc 10c: against the resident factored coordinate coefficients "
          f"{w_err / w_scale:.3g}, scores {s_err / s_scale:.3g}")
    return dict(groups=len(c.pass_plan), train_s=train_s, resident_s=res_s,
                ooc_bytes=ooc_bytes, resident_bytes=res_bytes, ratio=ratio,
                held_bytes=held, budget=budget, grad_err=grad_err, coef_err_rel=w_err / w_scale,
                score_err_rel=s_err / s_scale,
                projection_iterations=[r.iterations
                                       for r in rec["projection"]])


def ooc_descent(glog, built, hosts, residents, resident_iters_per_s):
    """10d: the whole descent out of core on the 10a draw (the fixed effect
    streamed in chunks of 2^17 rows, the three random effects at an eighth
    of their bytes): a warm iteration, a timed run of 3, the pipelined
    schedule bitwise the same, the objective never rising, the final
    objective against the resident descent's and the scores against a
    float64 host re-score; then OWL-QN, L-BFGS and TRON updates of the
    streamed fixed effect against the resident problem's.  Returns (SpMV
    launches, metrics)."""
    import dataclasses as dc

    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.game.coordinates import (
        FixedEffectCoordinate,
        RandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.data import FixedEffectDataset
    from photon_ml_tpu_torch.game.descent import CoordinateDescent
    from photon_ml_tpu_torch.game.model import GameModel
    from photon_ml_tpu_torch.game.ooc_random import (
        OutOfCoreRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.streaming import (
        StreamingFixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.ops import _kernels, losses
    from photon_ml_tpu_torch.optim.objective import GlmObjective
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    n, Xg, y, effects = built
    opt = game_re_opt()
    t0 = time.perf_counter()
    store = make_streaming_glm_data(Xg, y, chunk_rows=OOC_CHUNK_ROWS,
                                    device=DEVICE)
    store_s = time.perf_counter() - t0
    check(store.kind == "kernel" and store.n_chunks == -(-n // OOC_CHUNK_ROWS),
          f"ooc 10d: the chunk store is {store.kind}, {store.n_chunks} chunks")
    fe_data = make_glm_data(Xg, y, device=DEVICE)
    ooc = [StreamingFixedEffectCoordinate("fixed", store, "logistic", opt,
                                          reg_weight=1.0)]
    res = [FixedEffectCoordinate("fixed", FixedEffectDataset(
        data=fe_data, n_global_rows=n), "logistic", opt, reg_weight=1.0)]
    for name, _, _, _ in effects:
        ooc.append(OutOfCoreRandomEffectCoordinate(
            name, hosts[name], "logistic", opt, reg_weight=1.0,
            entity_key=name, device=DEVICE,
            device_budget_bytes=host_block_bytes(hosts[name])
            // OOC_BUDGET_DIV))
        res.append(RandomEffectCoordinate(name, residents[name], "logistic",
                                          opt, reg_weight=1.0,
                                          entity_key=name))
    base = torch.zeros(n, device=DEVICE)
    y_dev = torch.as_tensor(y, device=DEVICE)
    capped = next(c for c in res[1:] if any(
        b is not None for b in c.dataset.passive_blocks))
    rows = torch.zeros(n + 1, dtype=torch.bool, device=DEVICE)
    for b in capped.dataset.blocks:
        rows[b.row_index.reshape(-1).long()] = True
    active = rows[:n]

    def monitor(it, cname, scores, states):
        return {"objective": game_objective(ooc, y_dev, scores, states,
                                            base),
                "objective_active": game_objective(ooc, y_dev, scores,
                                                   states, base, active)}

    def timed(coords, n_it, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = CoordinateDescent(coords, pipeline=kw.pop("pipeline", False)
                              ).run(base, n_iterations=n_it, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    torch.cuda.synchronize()
    _kernels.reset_launches()
    _, warm_s = timed(ooc, 1)
    for c in ooc:
        c.transfer_stats.reset()
    run, run_s = timed(ooc, GAME_TIMED_ITERS)
    stats = {c.name: c.transfer_stats.snapshot() for c in ooc}
    piped, piped_s = timed(ooc, GAME_TIMED_ITERS, pipeline=True,
                           eval_fn=monitor)
    launches = dict(_kernels.LAUNCHES)
    check(launches["matvec"] > 0 and launches["rmatvec"] > 0,
          "ooc 10d: the fixed effect's SpMV kernels never launched")
    ips = GAME_TIMED_ITERS / run_s
    for name in run.states:
        check(states_equal(run.states[name], piped.states[name])
              and torch.equal(run.scores[name], piped.scores[name]),
              f"ooc 10d: pipeline=True differs from pipeline=False in "
              f"{name}")
    start = {"objective": float(game_objective(
        ooc, y_dev, {c.name: torch.zeros_like(base) for c in ooc},
        {c.name: None for c in ooc}, base))}
    start["objective_active"] = float(game_objective(
        ooc, y_dev, {c.name: torch.zeros_like(base) for c in ooc},
        {c.name: None for c in ooc}, base, active))
    prev, worst = start, -float("inf")
    for h in piped.history:
        key = ("objective_active" if h["coordinate"] == capped.name
               else "objective")
        rise = h[key] - prev[key]
        worst = max(worst, rise / abs(prev[key]))
        check(rise <= GAME_OBJ_RISE * abs(prev[key]),
              f"ooc 10d: {h['coordinate']}'s update raised its objective by "
              f"{rise:.6g}")
        prev = h
    # The ratio's resident side: the same coordinates timed here, warm,
    # under whatever else shares the host and the card at this moment.
    timed(res, 1)
    resident, res_s = timed(res, GAME_TIMED_ITERS)
    res_ips = GAME_TIMED_ITERS / res_s
    f_ooc = float(game_objective(ooc, y_dev, run.scores, run.states, base))
    f_res = float(game_objective(res, y_dev, resident.scores,
                                 resident.states, base))
    gap = abs(f_ooc - f_res) / abs(f_res)
    check(gap <= OOC_OBJ_TOL, f"ooc 10d: final objective {f_ooc!r} vs the "
          f"resident descent's {f_res!r} ({gap:.3g})")
    model = GameModel(models={c.name: c.finalize(run.states[c.name])
                              for c in ooc}, task="logistic")
    host = host_rescore(model, n, Xg, effects)
    for name, (h, scale) in host.items():
        dev = run.scores[name].double().cpu().numpy()
        err = float((np.abs(dev - h) / np.maximum(scale, 1e-30)).max())
        check(err <= RTOL, f"ooc 10d: {name} scores vs the host re-score "
              f"{err:.3g} of Σ|x·w|")
    glog(f"10d: chunk store {store.n_chunks} chunks of {OOC_CHUNK_ROWS} rows"
         f" (host build {store_s:.2f} s); warm iteration {warm_s:.3f} s; "
         f"{GAME_TIMED_ITERS} iterations in {run_s:.3f} s = {ips:.4f} GAME "
         f"iterations/s out of core vs {res_ips:.4f} for the resident "
         f"descent here (warm) = {ips / res_ips:.4f}; phase 6's resident "
         f"game_multi_re {resident_iters_per_s:.4f}; pipelined "
         f"{piped_s:.3f} s with its objective monitor, bitwise equal; "
         f"largest relative objective change across an update {worst:.3g}; "
         f"final objective {f_ooc!r} vs resident {f_res!r} (gap {gap:.3g}, "
         f"limit {OOC_OBJ_TOL:g}); scores = float64 host re-score within "
         f"{RTOL:g} of Σ|x·w|; SpMV launches {json.dumps(launches)}")
    for name, snap in stats.items():
        glog(f"10d {name} over the timed run: {transfer_summary(snap)}")

    # OWL-QN (elastic net) and TRON updates of the streamed fixed effect at
    # the run's final offsets, in float32 as the estimator builds it: each
    # against the same solver on the resident problem (the SpMV kernels
    # over the whole matrix) and TRON against L-BFGS (9b's gap), by their
    # float64 objectives.  Both float32 solves stop on their value's noise
    # floor, so 9b's KKT residuals are logged, not held.
    total = base + sum(run.scores.values())
    offsets = total - run.scores["fixed"]
    data = dc.replace(fe_data, offsets=offsets)
    obj64 = GlmObjective(losses.get("logistic"), accumulate="f64")
    w_zero = torch.zeros(GAME_FIXED_FEATURES, device=DEVICE)
    f_zero, g0 = obj64.value_and_grad(w_zero, data)
    # λ at the last point of 9b's grid (the median |∂f/∂w_j| at 0, over
    # α, over 100).
    alpha = 0.5
    lam = float(torch.quantile(g0.abs(), 0.5)) / alpha / 100
    l1 = float(np.float32(alpha) * np.float32(lam))
    l2e = float(np.float32(1 - alpha) * np.float32(lam))

    def f64(w, l1, l2):
        f, _ = obj64.value_and_grad(w, data, l2)
        return float(f) + l1 * float(w.double().abs().sum())

    def solve(reg, optimizer, tol, iters, reg_weight, l1, l2):
        cfg = GlmOptimizationConfig(
            optimizer=OptimizerConfig(optimizer=OptimizerType[optimizer],
                                      max_iters=iters, tolerance=tol),
            regularization=reg)
        coord = StreamingFixedEffectCoordinate(
            "fixed", store, "logistic", cfg, reg_weight=reg_weight)
        # Main-path launches: the streamed solve's; the resident problem
        # it is compared with launches outside the count.
        _kernels.reset_launches()
        coord.train(offsets)
        for op in solver_launches:
            solver_launches[op] += _kernels.LAUNCHES[op]
        res = GlmOptimizationProblem("logistic", cfg).solve_single_device(
            data, reg_weight, w_zero)
        r = coord.last_solve
        out = dict(iterations=(r.iterations, res.iterations),
                   converged=(r.converged, res.converged),
                   objective=(f64(r.w, l1, l2), f64(res.w, l1, l2)))
        gap = abs(out["objective"][0] - out["objective"][1]) \
            / abs(out["objective"][1])
        check(gap <= OOC_OBJ_TOL,
              f"ooc 10d: the streamed {optimizer} objective "
              f"{out['objective'][0]!r} vs the resident problem's "
              f"{out['objective'][1]!r} ({gap:.3g})")
        return r, res, dict(out, gap=gap)

    solver_launches = {"matvec": 0, "rmatvec": 0}
    r_en, res_en, m_en = solve(RegularizationContext.elastic_net(alpha),
                               "OWLQN", OWLQN_TOL, 200, lam, l1, l2e)
    kkt = (kkt_residuals(r_en, obj64, data, l1, l2e),
           kkt_residuals(res_en, obj64, data, l1, l2e))
    _, _, m_lb = solve(RegularizationContext.l2(), "LBFGS", SOLVE_TOL,
                          300, 1.0, 0.0, 1.0)
    _, _, m_tr = solve(RegularizationContext.l2(), "TRON", SOLVE_TOL,
                          100, 1.0, 0.0, 1.0)
    gap_t = abs(m_tr["objective"][0] - m_lb["objective"][0]) \
        / abs(m_lb["objective"][0])
    check(gap_t <= 1e-5, f"ooc 10d: streamed GAME TRON float64 objective "
          f"{gap_t:.3g} from L-BFGS's")
    check(min(solver_launches.values()) > 0,
          f"ooc 10d: the streamed solves launched {solver_launches}")
    f0 = float(f_zero)
    glog(f"10d streamed fixed effect (float32) at the run's offsets, float64"
         f" objective at w = 0 {f0!r} (+ penalties): OWL-QN λ={lam:.6g} "
         f"streamed / resident {m_en['iterations']} iterations, converged "
         f"{m_en['converged']}, objective {m_en['objective']} (gap "
         f"{m_en['gap']:.3g}, limit {OOC_OBJ_TOL:g}), {int((r_en.w == 0).sum())}"
         f" / {int((res_en.w == 0).sum())} zeros, 9b's KKT residuals (|g|/λ1"
         f" at zeros, at the support, decrement) {kkt[0]} / {kkt[1]} (9b "
         f"holds <= {1 + KKT_ZERO:g} and <= {KKT_DECREMENT:g}); L-BFGS "
         f"{m_lb['iterations']} iterations, objective {m_lb['objective']}; "
         f"TRON {m_tr['iterations']} iterations, converged "
         f"{m_tr['converged']}, objective {m_tr['objective']}, gap to "
         f"L-BFGS {gap_t:.3g} (limit 1e-5); streamed SpMV launches "
         f"{json.dumps(solver_launches)}")
    total_launches = {op: launches[op] + solver_launches[op]
                      for op in ("matvec", "rmatvec")}
    return total_launches, dict(
        iters_per_s=ips, resident_iters_per_s=resident_iters_per_s,
        resident_here_iters_per_s=res_ips, ratio=ips / res_ips,
        warm_s=warm_s, run_s=run_s,
        objective_gap=gap, transfer=stats, owlqn=m_en, owlqn_kkt=kkt,
        lbfgs=m_lb, tron=m_tr, tron_gap=gap_t,
        updates=[{k: v for k, v in h.items()}
                                 for h in run.history])


class _Killed(Exception):
    """The failure 8d and 10e inject into a training run after iteration
    1."""


def run_killed_after_iteration_1(train) -> None:
    """``train()`` killed for real: the run stops right after iteration
    1's checkpoint is written (the checkpointer patched from this script).
    Fails if the run was not killed."""
    from photon_ml_tpu_torch.io.checkpoint import (
        CoordinateDescentCheckpointer,
    )

    real_save = CoordinateDescentCheckpointer.save

    def save_then_die(self, it, *a, **k):
        real_save(self, it, *a, **k)
        if it == 0:
            raise _Killed("killed after iteration 1")

    CoordinateDescentCheckpointer.save = save_then_die
    try:
        train()
    except _Killed:
        return
    finally:
        CoordinateDescentCheckpointer.save = real_save
    check(False, "the killed run was not killed")


def ooc_driver_config(path, iterations, budget_mb):
    """Phase 7's driver config with the fixed effect streamed in chunks of
    2^17 rows and ``per_user`` out of core at ``budget_mb``."""
    game_driver_config(path, iterations)
    with open(path) as f:
        cfg = json.load(f)
    cfg["coordinates"][0]["streaming_chunk_rows"] = OOC_CHUNK_ROWS
    cfg["coordinates"][1]["device_budget_mb"] = budget_mb
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def driver_objective(model_dir, shards, ids, y, w, off):
    """The GAME objective of a saved model on the training rows, in float64
    on the host: logistic losses plus ½·‖w‖² of every coefficient (phase
    7's coordinates all have λ = 1)."""
    from photon_ml_tpu_torch.io.game_store import load_game_model

    model, _ = load_game_model(os.path.join(model_dir, "models"),
                               device="cpu")
    wf = model["fixed"].model.coefficients.means.numpy().astype(np.float64)
    m = shards["global"].astype(np.float64) @ wf + off
    re = model["per_user"]
    Xu = shards["userFeatures"].toarray().astype(np.float64)
    uniq, inv = np.unique(np.asarray(ids["userId"]).astype(str),
                          return_inverse=True)
    W = np.zeros((len(uniq), Xu.shape[1]))
    pen = float(wf @ wf)
    for i, k in enumerate(uniq):
        if k in re.coefficients:
            cols, vals = re.coefficients[k]
            W[i, cols] = vals
            pen += float(np.dot(vals.astype(np.float64), vals))
    m = m + (Xu * W[inv]).sum(1)
    y64 = y.astype(np.float64)
    return float((w * (np.logaddexp(0.0, m) - y64 * m)).sum() + 0.5 * pen)


def ooc_drivers(glog, td, train, val):
    """10e: the training driver with the fixed effect streamed (2^17-row
    chunks) and ``per_user`` at an eighth of its blocks, 3 iterations with
    per-update validation, killed after iteration 1 and resumed; the
    resumed model against phase 7's resident run; the scoring driver's
    ``--stream-block-rows 65536`` on the validation file against its
    whole-file run; an uninterrupted out-of-core run whose model files the
    resumed run's must equal byte for byte.  (The training file's scoring
    pair left the script to keep it inside its time limit; the CPU tests
    hold it.)  Returns
    (training SpMV launches, validation-scoring matvec launches,
    metrics)."""
    from photon_ml_tpu_torch.data.game_reader import read_game_avro
    from photon_ml_tpu_torch.drivers import (
        game_scoring_driver,
        game_training_driver,
    )
    from photon_ml_tpu_torch.evaluation.evaluators import get_evaluator
    from photon_ml_tpu_torch.game.data import build_random_effect_dataset
    from photon_ml_tpu_torch.io import avro
    from photon_ml_tpu_torch.io.game_store import load_game_model
    from photon_ml_tpu_torch.ops import _kernels

    _, imaps = load_game_model(os.path.join(td, "full", "models"),
                               device="cpu")
    shards, ids, y, w, off, _, _ = read_game_avro(train, index_maps=imaps)
    host = build_random_effect_dataset(
        ids["userId"], shards["userFeatures"], y, w,
        bucket_growth=GAME_BUCKET_GROWTH, device=False)
    budget_mb = host_block_bytes(host) / OOC_BUDGET_DIV / 2**20
    del host
    cfg3 = ooc_driver_config(os.path.join(td, "ooc3.json"),
                             GAME_DRIVER_ITERS, budget_mb)
    resumed = os.path.join(td, "ooc_resumed")
    common = ["--train-data", train, "--validate-data", val]
    metrics, launches = {}, {"matvec": 0, "rmatvec": 0}
    with ScorerRecorder() as rec:
        def training(label, argv):
            torch.cuda.synchronize()
            _kernels.reset_launches()
            rec.val_matvec = 0
            t0 = time.perf_counter()
            res = game_training_driver.run(argv + ["--device", DEVICE])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ls = dict(_kernels.LAUNCHES)
            check(ls["matvec"] > rec.val_matvec > 0 and ls["rmatvec"] > 0,
                  f"ooc 10e {label}: the SpMV kernels did not launch in "
                  "training and in validation scoring")
            launches["matvec"] += ls["matvec"] - rec.val_matvec
            launches["rmatvec"] += ls["rmatvec"]
            metrics[label] = dict(wall_s=wall, stages=res["stage_seconds"],
                                  val_matvec=rec.val_matvec)
            glog(f"10e {label}: driver wall {wall:.2f} s, validation AUC "
                 f"{res.get('validation_metric')!r}; stages (host s): "
                 f"{stage_summary(res['stage_seconds'])}")
            return res

        run_killed_after_iteration_1(lambda: training(
            "kill after iteration 1", common + [
                "--config", cfg3, "--output-dir", resumed]))
        glog("10e: the run was killed after iteration 1's checkpoint")
        full = training("resume to 3", common + [
            "--config", cfg3, "--output-dir", resumed, "--resume"])
        uninterrupted = os.path.join(td, "ooc_uninterrupted")
        training("uninterrupted", common + ["--config", cfg3,
                                            "--output-dir", uninterrupted])
    val_launches = sum(m["val_matvec"] for m in metrics.values())
    for rel in ("fixed-effect/fixed/coefficients.avro",
                "random-effect/per_user/coefficients.avro"):
        a, b = (open(os.path.join(k, "models", rel), "rb").read()
                for k in (uninterrupted, resumed))
        check(a == b, f"ooc 10e: the resumed model's {rel} differs from "
              "the uninterrupted run's")
    glog("10e: the resumed run's model files equal the uninterrupted "
         "run's byte for byte")
    f_ooc = driver_objective(resumed, shards, ids, y, w, off)
    f_res = driver_objective(os.path.join(td, "full"), shards, ids, y, w,
                             off)
    gap = abs(f_ooc - f_res) / abs(f_res)
    check(gap <= OOC_OBJ_TOL, f"ooc 10e: the driver's objective {f_ooc!r} "
          f"vs phase 7's resident run {f_res!r} ({gap:.3g})")
    glog(f"10e: per_user budget {budget_mb:.3f} MB (1/{OOC_BUDGET_DIV} of "
         f"its blocks); killed after iteration 1 and resumed: float64 "
         f"objective of the resumed run's saved model {f_ooc!r} vs "
         f"phase 7's resident {f_res!r} (gap {gap:.3g}, limit "
         f"{OOC_OBJ_TOL:g})")

    def score(label, data, *flags):
        t0 = time.perf_counter()
        res = game_scoring_driver.run([
            "--data", data, "--model-dir", resumed, "--output-dir",
            os.path.join(td, f"ooc_score_{label}"), "--device", DEVICE,
            *flags])
        torch.cuda.synchronize()
        check(res["encoder"] == "native",
              f"ooc 10e: {label} scores written by the {res['encoder']} "
              "encoder")
        glog(f"10e scoring {label}: wall {time.perf_counter() - t0:.2f} s, "
             f"{res['n_rows']} rows"
             + (f" in {res['blocks']} blocks" if "blocks" in res else "")
             + f", metric {res.get('metric')!r}; stages (host s): "
             f"{stage_summary(res['stage_seconds'])}")
        metrics[f"scoring {label}"] = res["stage_seconds"]
        return res

    stream = ["--stream-block-rows", str(OOC_SCORE_BLOCK_ROWS)]
    for label, data in (("validation", val),):
        whole = score(f"{label} whole", data, "--evaluator", "auc")
        part = score(f"{label} streamed", data, "--evaluator", "auc",
                     *stream)
        # Container blocks of 4096 rows: a block flushes at every 65,536.
        blocks = -(-whole["n_rows"] // OOC_SCORE_BLOCK_ROWS)
        check(part["blocks"] == blocks, f"ooc 10e: {label} streamed in "
              f"{part['blocks']} blocks, expected {blocks}")
        paths = [os.path.join(td, f"ooc_score_{label} {k}", "scores.avro")
                 for k in ("whole", "streamed")]
        same = open(paths[0], "rb").read() == open(paths[1], "rb").read()
        diff = 0.0
        if not same:
            got = [np.array([r["predictionScore"] for r in
                             avro.read_container(p)[1]]) for p in paths]
            diff = float(np.abs(got[0] - got[1]).max())
        check(same or diff <= 1e-6, f"ooc 10e: {label} streamed scores "
              f"differ from the whole-file run's by {diff:.3g}")
        check(part["metric"] == whole["metric"],
              f"ooc 10e: {label} streamed AUC {part['metric']!r} vs "
              f"{whole['metric']!r}")
        glog(f"10e {label}: streamed scores file "
             + ("byte-equal to" if same else f"within {diff:.3g} of")
             + f" the whole-file run's; AUC {part['metric']!r} equal")
    # The host logistic loss of the whole-file validation scores, against
    # the streamed run's per-block device partials.
    _, recs = avro.read_container(os.path.join(
        td, "ooc_score_validation whole", "scores.avro"))
    v_y, v_w = read_game_avro(val, index_maps=imaps)[2:4]
    host_ll = get_evaluator("logistic_loss").evaluate(
        np.array([r["predictionScore"] for r in recs], np.float32), v_y,
        v_w)
    dev_ll = score("validation logloss device", val, "--evaluator",
                   "logistic_loss", "--device-metrics", *stream)["metric"]
    d = abs(dev_ll - host_ll)
    check(d <= 1e-6, f"ooc 10e: the per-block device logistic loss "
          f"{dev_ll!r} vs the host {host_ll!r}")
    glog(f"10e: --device-metrics logistic loss from per-block partials "
         f"{dev_ll!r} vs host {host_ll!r} (|diff| {d:.3g}, limit 1e-6)")
    metrics.update(objective_gap=gap, budget_mb=budget_mb,
                   validation_auc=full.get("validation_metric"))
    return launches, val_launches, metrics


def phase_game_ooc(smi, td, files, resident_iters_per_s):
    """Phase 10: GAME out of core at full width (10a coordinates, 10d the
    whole descent, 10b memory, 10c factored, 10e the drivers).  Returns
    (``.game`` SpMV launches, validation-scoring matvec launches,
    metrics)."""
    def glog(msg):
        log_phase(f"game ooc [{smi}] {msg}")

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ooc_spill_", dir=td)
    built = game_multi_re_data()
    n, _, y, effects = built
    opt = game_re_opt()
    offsets = ooc_offsets(n, 100)
    hosts, residents, metrics = {}, {}, {"10a": {}}
    phase_header("phase 10a: out-of-core random effects on game_multi_re's draw")
    for name, keys, Xe, cap in effects:
        hosts[name], residents[name], metrics["10a"][name] = \
            ooc_random_effect(glog, name, keys, Xe, cap, y, offsets, opt,
                              tmp)
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    t_a = time.perf_counter()
    phase_header("phase 10d: the whole descent out of core")
    launches, metrics["10d"] = ooc_descent(glog, built, hosts, residents,
                                           resident_iters_per_s)
    # Rank 0's row block of phase 12b's row-sharded fixed effect.
    PHASE12["game_shard"] = built[1][:-(-n // GROUP_RANKS)]
    del built, hosts, residents
    torch.cuda.empty_cache()
    t_d = time.perf_counter()
    phase_header("phase 10b: device memory at the wide per-user effect")
    metrics["10b"] = ooc_wide_memory(glog, td)
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    phase_header("phase 10c: the out-of-core factored random effect")
    metrics["10c"] = ooc_factored(glog)
    torch.cuda.empty_cache()
    t_c = time.perf_counter()
    phase_header("phase 10e: the drivers out of core")
    d_launches, val_launches, metrics["10e"] = ooc_drivers(glog, td, *files)
    for op in launches:
        launches[op] += d_launches[op]
    t_e = time.perf_counter()
    metrics["seconds"] = dict(a=t_a - t_phase, d=t_d - t_a, b=t_b - t_d,
                              c=t_c - t_b, e=t_e - t_c)
    glog(f"phase 10: {t_e - t_phase:.1f} s (10a {t_a - t_phase:.1f}, 10d "
         f"{t_d - t_a:.1f}, 10b {t_b - t_d:.1f}, 10c {t_c - t_b:.1f}, 10e "
         f"{t_e - t_c:.1f}); main-path SpMV launches {json.dumps(launches)},"
         f" validation scoring matvec {val_launches}")
    return launches, val_launches, metrics


# -- phase 11: multi-device GLM --------------------------------------------

ADMM_SHARDS = 4
#: Consensus ADMM's knobs at full width (ρ near a shard's per-coordinate
#: curvature, the reference bench's over-relaxation).
ADMM_OPTIONS = (("rho", "64"), ("reltol", "1e-4"),
                ("over_relaxation", "1.8"))
ADMM_MAX_OUTER = 60
#: The ridge x-update's: ρ near a shard's squared-loss curvature (2^18 rows
#: x 32/8192 of a column's entries), and the cheap closed-form rounds run
#: to 400.
RIDGE_OPTIONS = (("rho", "1024"), ("reltol", "1e-4"),
                 ("over_relaxation", "1.8"), ("local_solver", "ridge"))
RIDGE_MAX_OUTER = 400
BCD_ROWS = 1 << 17
BCD_FEATURES = 512
BCD_SHARDS = 4
BCD_LAM = 0.3 * BCD_ROWS / 8192
BCD_OPTIONS = (("n_blocks", "8"), ("sweeps", "1"), ("max_rounds", "800"),
               ("tolerance", "1e-9"))
BCD_GAP = 1e-5
BCD_DRIVER_ROUNDS = 4


def f64_objective(task, X, y, w, l1, l2):
    """The full objective at ``w`` in float64 on the host (one scipy
    mat-vec): the one evaluator phase 11 scores every solver with."""
    w = w.double().cpu().numpy() if isinstance(w, torch.Tensor) else (
        np.asarray(w, np.float64))
    m = np.asarray(X @ w, np.float64).ravel()
    y = np.asarray(y, np.float64)
    if task == "logistic":
        loss = np.sum(np.logaddexp(0.0, m) - y * m)
    else:
        loss = 0.5 * np.sum((m - y) ** 2)
    return float(loss + l1 * np.abs(w).sum() + 0.5 * l2 * w @ w)


def glm_problem(task, reg, solver=None, options=(), max_iters=100,
                tol=SOLVE_TOL, accumulate="f64", compute_variances=False):
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
    )

    return GlmOptimizationProblem(task, GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=max_iters, tolerance=tol,
                                  solver=solver, solver_options=options),
        regularization=reg, compute_variances=compute_variances),
        accumulate=accumulate)


def phase_admm(X, y, margins, sol_records, sol_ws, gen):
    """Phase 11a: consensus ADMM over 4 logical shards of phase 3's matrix
    (2^18 rows each, on the SpMV kernels) on 3b's elastic-net grid, against
    3b's OWL-QN; the squared labels through the ridge x-update.  Returns
    (main-path launches, shard 0's kernel records, metrics)."""
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.ops.sparse_cuda import CudaSparseMatrix
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )
    from photon_ml_tpu_torch.parallel import distributed
    from photon_ml_tpu_torch.solvers import sharded

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dist = distributed.shard_glm_data(X, y, None, n_shards=ADMM_SHARDS,
                                      device=DEVICE)
    torch.cuda.synchronize()
    log(f"admm: {ADMM_SHARDS} logical shards of {dist.rows_per} rows, "
        f"host build {time.perf_counter() - t0:.1f} s")
    check(all(isinstance(s.features, CudaSparseMatrix) for s in dist.shards),
          "admm: a shard is not the kernel-backed matrix")
    # Each shard's kernel against its plain version (phase 2's checks).
    shard_recs = [kernel_vs_plain(f"shard{i}", s.features, gen)
                  for i, s in enumerate(dist.shards)]

    grid_rec = sol_records["owlqn.elastic_net_grid"]
    grid = [r["lam"] for r in grid_rec["grid"]]
    alpha = 0.5
    problem = glm_problem("logistic", RegularizationContext.elastic_net(alpha),
                          "admm", ADMM_OPTIONS, max_iters=ADMM_MAX_OUTER,
                          tol=OWLQN_TOL)
    total = {op: 0 for op in OPS}

    def counted(label, fn):
        torch.cuda.synchronize()
        _kernels.reset_launches()
        distributed.reset_allreduces()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {op: _kernels.LAUNCHES[op] for op in OPS}
        for op in OPS:
            total[op] += launches[op]
        check(launches["matvec"] > 0 and launches["rmatvec"] > 0,
              f"admm {label}: matvec/rmatvec never launched")
        return out, wall, launches, dict(distributed.ALLREDUCES)

    out, wall, launches, reduces = counted(
        "elastic-net grid",
        lambda: sharded.run_grid_sharded(problem, dist, None, grid))
    gaps, rounds = {}, {}
    for lam, model, res in out:
        l1 = float(np.float32(alpha) * np.float32(lam))
        l2 = float(np.float32(1 - alpha) * np.float32(lam))
        f_admm = f64_objective("logistic", X, y, model.coefficients.means,
                               l1, l2)
        f_owlqn = f64_objective("logistic", X, y,
                                sol_ws[("elastic_net", lam)], l1, l2)
        gaps[lam] = (f_admm - f_owlqn) / max(1.0, abs(f_owlqn))
        rounds[lam] = res.iterations
        vals = res.values.numpy().astype(np.float64)
        check(np.all(np.isfinite(vals)) and np.isfinite(f_admm),
              f"admm λ={lam:.6g}: non-finite objective")
        log(f"admm λ={lam:.6g}: {res.iterations} outer rounds, converged "
            f"{res.converged}, float64 objective {f_admm:.10g} vs OWL-QN "
            f"{f_owlqn:.10g}: relative gap {gaps[lam]:.3g}; "
            f"solve wall {problem.grid_wall_seconds[lam]:.3f} s")
    admm_per_solve = reduces["count"] / len(grid)
    owlqn_per_solve = grid_rec["evals"] / len(grid)
    ratio = owlqn_per_solve / admm_per_solve
    log(f"admm: {reduces['count']} reductions ({reduces['bytes']} bytes) "
        f"over {len(grid)} solves: {admm_per_solve:.1f} a solve against "
        f"OWL-QN's {owlqn_per_solve:.1f} evaluations a solve (each one "
        f"all-reduce over a group): {ratio:.2f}x fewer (the reference's "
        f"bench gate is >= 5x); grid wall {wall:.1f} s, launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    check(max(gaps.values()) <= 1e-3,
          f"admm: objective gap {max(gaps.values()):.3g} above 1e-3 of "
          "OWL-QN's")

    # The squared labels through the ridge x-update: one Gram matrix (one
    # HVP a basis vector on the kernels) and one 8192 x 8192 eigh a shard.
    lin = solver_labels(margins)["linear"]
    rp = dist.rows_per
    dist_lin = dataclasses.replace(dist, shards=[
        dataclasses.replace(s, labels=torch.as_tensor(
            lin[i * rp:(i + 1) * rp], device=DEVICE))
        for i, s in enumerate(dist.shards)])
    lin_rec = sol_records["owlqn.linear_l1"]
    lam_lin = lin_rec["lam"]
    ridge = glm_problem("linear", RegularizationContext.l1(), "admm",
                        RIDGE_OPTIONS, max_iters=RIDGE_MAX_OUTER,
                        tol=OWLQN_TOL)
    r_out, r_wall, r_launches, r_reduces = counted(
        "ridge", lambda: sharded.run_grid_sharded(ridge, dist_lin, None,
                                                  [lam_lin]))
    [(_, r_model, r_res)] = r_out
    l1 = float(np.float32(lam_lin))
    f_ridge = f64_objective("linear", X, lin, r_model.coefficients.means,
                            l1, 0.0)
    f_lin = f64_objective("linear", X, lin, sol_ws[("linear_l1", lam_lin)],
                          l1, 0.0)
    ridge_gap = (f_ridge - f_lin) / max(1.0, abs(f_lin))
    log(f"admm ridge (squared, L1 λ={lam_lin:.6g}): {r_res.iterations} outer "
        f"rounds, converged {r_res.converged}, {r_reduces['count']} "
        f"reductions, wall {r_wall:.1f} s (Gram by {N_FEATURES} HVPs and "
        f"one {N_FEATURES} x {N_FEATURES} eigh a shard inside), float64 "
        f"objective {f_ridge:.10g} vs OWL-QN {f_lin:.10g}: relative gap "
        f"{ridge_gap:.3g}; launches "
        f"{json.dumps({k: v for k, v in r_launches.items() if v})}")
    check(np.isfinite(f_ridge) and ridge_gap <= 1e-3,
          f"admm ridge: objective gap {ridge_gap:.3g} above 1e-3")
    log(f"phase 11a: {time.perf_counter() - t_phase:.1f} s; main-path "
        f"launches {json.dumps(total)}")
    metrics = dict(gaps={str(k): v for k, v in gaps.items()},
                   rounds={str(k): v for k, v in rounds.items()},
                   reductions_per_solve=admm_per_solve,
                   owlqn_evals_per_solve=owlqn_per_solve,
                   reduce_ratio=ratio, grid_wall_s=wall,
                   ridge_gap=ridge_gap, ridge_wall_s=r_wall,
                   ridge_rounds=r_res.iterations)
    return total, shard_recs[0], metrics


def bcd_data(seed=7):
    """``bench_solvers``' ill-conditioned dense construction (geometric
    spectrum 1 → 0.02 under a random rotation, bench.py:2566-2578) at
    2^17 x 512, squared-loss labels."""
    rng = np.random.default_rng(seed)
    n, d = BCD_ROWS, BCD_FEATURES
    Z = rng.normal(size=(n, d))
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    spec = np.geomspace(1.0, 0.02, d)
    X = ((Z * spec) @ Q.T / np.sqrt(d)).astype(np.float32)
    w_true = (rng.normal(size=d) * (rng.uniform(size=d) < 0.3)).astype(
        np.float32)
    y = (X @ w_true + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def count_ops(fn):
    """(result, aten ops dispatched that are not views): each is about one
    kernel launch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def phase_block_cd(drv_files, td):
    """Phase 11b: block CD on the ill-conditioned dense draw against the
    resident OWL-QN's objective, then ``glm_driver --solver block_cd`` on
    phase 4's files as a route check.  Returns (the driver run's launches,
    metrics)."""
    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )
    from photon_ml_tpu_torch.parallel import distributed
    from photon_ml_tpu_torch.solvers import sharded

    t_phase = time.perf_counter()
    X, y = bcd_data()
    reg = RegularizationContext.elastic_net(0.5)
    l1 = l2 = float(np.float32(0.5) * np.float32(BCD_LAM))
    resident = glm_problem("linear", reg, max_iters=500, tol=1e-9)
    data = make_glm_data(X, y, device=DEVICE)
    t0 = time.perf_counter()
    ref = resident.solve(data, BCD_LAM)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    f_ref = f64_objective("linear", X, y, ref.w, l1, l2)
    problem = glm_problem("linear", reg, "block_cd", BCD_OPTIONS,
                          tol=1e-9, accumulate="f32")
    dist = distributed.shard_glm_data(X, y, None, n_shards=BCD_SHARDS,
                                      device=DEVICE)
    distributed.reset_allreduces()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    [(_, model, res)] = sharded.run_grid_sharded(problem, dist, None,
                                                 [BCD_LAM])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reduces = distributed.ALLREDUCES["count"]
    f_cd = f64_objective("linear", X, y, model.coefficients.means, l1, l2)
    gap = (f_cd - f_ref) / max(1.0, abs(f_ref))
    # One more block round alone, its dispatched ops counted.
    one = glm_problem("linear", reg, "block_cd", BCD_OPTIONS[:2] + (
        ("max_rounds", "1"),), accumulate="f32")
    _, ops = count_ops(lambda: sharded.run_grid_sharded(
        one, dist, None, [BCD_LAM], w0=model.coefficients.means))
    log(f"block_cd: {BCD_ROWS} x {BCD_FEATURES} ill-conditioned, "
        f"{BCD_SHARDS} logical shards, {dict(BCD_OPTIONS)}: {res.iterations} "
        f"rounds, converged {res.converged}, {wall:.2f} s "
        f"({wall / max(res.iterations, 1) * 1e3:.2f} ms a round), "
        f"{reduces} reductions; about {ops} launches a round (the non-view "
        f"aten ops of one round and its final evaluation); float64 objective "
        f"{f_cd:.10g} vs resident OWL-QN {f_ref:.10g} ({ref.iterations} "
        f"iterations, {ref_wall:.2f} s): relative gap {gap:.3g}")
    check(res.converged and gap <= BCD_GAP,
          f"block_cd: gap {gap:.3g} to the resident objective (<= "
          f"{BCD_GAP:g}), converged {res.converged}")
    del dist, data

    # The GLM driver's block-CD route on phase 4's files: the design
    # densified, 2 logical shards, BCD_DRIVER_ROUNDS rounds a λ.
    train, val = drv_files
    launches, (out, result) = driver_run(
        "block_cd", ("--reg-type", "l2", "--solver", "block_cd",
                     "--solver-option", f"max_rounds={BCD_DRIVER_ROUNDS}"),
        td, train, val, kernels=("matvec_unit", "sq_rmatvec_unit"))
    log(f"phase 11b: {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(rounds=res.iterations, wall_s=wall,
                          ms_per_round=wall / max(res.iterations, 1) * 1e3,
                          launches_per_round=ops, gap=gap,
                          driver_wall_s=result["wall_seconds"])


def one_rank_group(path):
    """A NCCL process group of one rank through a FileStore at ``path``."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0,
                            world_size=1)


def phase_group_grid(data, X, y, store_path):
    """Phase 11c on phase 3's matrix: a one-rank NCCL group's λ grid and
    ADMM, each bitwise its single-device (one logical shard) run.  Returns
    ({op: launches} of the group's runs, metrics)."""
    import torch.distributed as dist

    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )
    from photon_ml_tpu_torch.parallel import distributed, multihost
    from photon_ml_tpu_torch.solvers import sharded

    t_phase = time.perf_counter()
    one_rank_group(store_path)
    try:
        mesh = multihost.global_data_mesh()
        # Phase 3's grid (L2 L-BFGS, 30 iterations, variances).
        problem = glm_problem("logistic", RegularizationContext.l2(),
                              max_iters=30, tol=1e-7, accumulate="f32",
                              compute_variances=True)
        single = problem.run_grid(data, list(GRID))
        # One rank holds the whole matrix: shard_glm_data's block for a
        # group of one is phase 3's matrix itself.
        held = distributed.DistributedGlmData(shards=[data], n_shards=1)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        distributed.reset_allreduces()
        t0 = time.perf_counter()
        grid = distributed.run_grid_distributed(problem, held, mesh,
                                                list(GRID))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {op: _kernels.LAUNCHES[op] for op in OPS}
        reduces = distributed.ALLREDUCES["count"]
        evals = launches["rmatvec"] + launches["sq_rmatvec"]
        for (lam, m, res), (_, m1, res1) in zip(grid, single):
            check(torch.equal(m.coefficients.means, m1.coefficients.means)
                  and torch.equal(m.coefficients.variances,
                                  m1.coefficients.variances)
                  and res.iterations == res1.iterations,
                  f"group grid λ={lam}: not bitwise the single-device run")
        check(reduces == evals,
              f"group grid: {reduces} all-reduces against {evals} "
              "evaluations and variance passes")
        log(f"group (NCCL, 1 rank): phase 3's grid bitwise the single-device"
            f" run; {reduces} all-reduces = {launches['rmatvec']} "
            f"evaluations + {launches['sq_rmatvec']} variance passes; wall "
            f"{wall:.3f} s; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")

        admm = glm_problem("logistic", RegularizationContext.elastic_net(0.5),
                           "admm", ADMM_OPTIONS + (("max_outer", "3"),
                                                   ("local_max_iters", "10")),
                           tol=OWLQN_TOL)
        lam = GRID[1]
        [(_, ma, ra)] = sharded.run_grid_sharded(admm, held, None, [lam])
        _kernels.reset_launches()
        [(_, mg, rg)] = distributed.run_grid_distributed(admm, held, mesh,
                                                         [lam])
        torch.cuda.synchronize()
        for op in OPS:
            launches[op] += _kernels.LAUNCHES[op]
        check(torch.equal(ma.coefficients.means, mg.coefficients.means)
              and ra.iterations == rg.iterations,
              "group ADMM: not bitwise ADMM on one logical shard")
        log(f"group (NCCL, 1 rank): ADMM ({rg.iterations} rounds at λ={lam})"
            " bitwise ADMM on one logical shard")
    finally:
        dist.destroy_process_group()
    log(f"phase 11c (grid, ADMM): {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(grid_wall_s=wall, allreduces=reduces)


def phase_group_driver(drv_files, drv_runs, td, store_path):
    """Phase 11c's driver check: ``glm_driver --data-parallel auto`` under
    a one-rank NCCL group writes phase 4's L2 run's model files byte for
    byte.  Returns the run's launches."""
    import torch.distributed as dist

    one_rank_group(store_path)
    try:
        launches, (out, _) = driver_run(
            "l2_data_parallel", ("--reg-type", "l2", "--data-parallel",
                                 "auto"), td, *drv_files)
    finally:
        dist.destroy_process_group()
    ref_out = drv_runs["l2"][0]
    models = sorted(f for f in os.listdir(ref_out)
                    if f.startswith("model_lambda_"))
    check(bool(models) and all(
        open(os.path.join(out, f), "rb").read()
        == open(os.path.join(ref_out, f), "rb").read() for f in models),
        "group driver: --data-parallel auto model files differ from the "
        "run without it")
    log(f"group (NCCL, 1 rank): glm_driver --data-parallel auto wrote "
        f"{models} byte-equal to phase 4's run")
    return launches


# -- phase 12: GAME and the streamed mesh over a process group --------------

#: Phase 12b's group: gloo ranks sharing the one card (NCCL refuses two
#: ranks on one card).
GROUP_RANKS = 4
#: The multi-device metrics the last log line carries.
MULTI_KEYS = ("admm", "group", "block_cd", "game_group")
#: What phases 7, 9a, 9c and 10 leave for phase 12: the driver runs to
#: repeat over a group, and one shard of each sharded matrix.
PHASE12: dict = {}


def model_files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def phase_group_game(smi, td, group_call):
    """Phase 12a: a one-rank NCCL group runs the GAME training driver's
    group route on phase 7's files and the GLM driver's streamed route on
    phase 4's files (each rank its shard of every chunk); their model
    files must equal phase 7's and phase 9c's one-card runs byte for byte.
    Phase 12b: ``experiments.multirank --game`` over a spawned gloo group of
    GROUP_RANKS ranks sharing this card at full width (its checks raise),
    ``group_call`` from :func:`start_group_call`, read here.  Then the two
    new shard instances of kernel #1 against their plain versions.
    Returns ({instance: {op: record}}, {instance: {op: launches}},
    metrics)."""
    import torch.distributed as dist

    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.drivers import game_training_driver, glm_driver
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.parallel import distributed, multihost
    from photon_ml_tpu_torch.utils.logging import PhotonLogger

    def glog(msg):
        log_phase(f"group GAME [{smi}] {msg}")

    t_phase = time.perf_counter()
    launches = {"game": {"matvec": 0, "rmatvec": 0}, "unit": {}}
    metrics = {}
    one_rank_group(os.path.join(td, "pg_store_game"))
    try:
        mesh = multihost.global_data_mesh()
        argv, one_out = PHASE12["game_driver"]
        # Without per-update validation: every matvec counted is the fixed
        # effect's (the model files do not depend on it).
        i = argv.index("--validate-data")
        argv = argv[:i] + argv[i + 2:]
        out = os.path.join(td, "group_game")
        args = game_training_driver.build_arg_parser().parse_args(
            argv + ["--output-dir", out, "--data-parallel", "auto",
                    "--device", DEVICE])
        os.makedirs(out, exist_ok=True)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        distributed.reset_allreduces()
        t0 = time.perf_counter()
        with PhotonLogger(out) as logger:
            res = game_training_driver._run_impl(args, logger, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for op in ("matvec", "rmatvec"):
            launches["game"][op] += _kernels.LAUNCHES[op]
        got, want = (model_files(os.path.join(d, "models"))
                     for d in (out, one_out))
        check(bool(want) and got == want,
              "12a: the GAME driver's group route wrote model files that "
              "differ from phase 7's one-card run")
        glog(f"12a GAME driver over a one-rank NCCL group: {len(got)} model "
             f"files byte-equal to phase 7's run; {wall:.2f} s, "
             f"{distributed.ALLREDUCES['count']} all-reduces, "
             f"{distributed.GATHERS['count']} gathers, train AUC "
             f"{res.get('train_metric')}")
        metrics["game_driver_s"] = wall

        train, val, stream_out = PHASE12["glm_stream"]
        out = os.path.join(td, "group_glm_stream")
        os.makedirs(out, exist_ok=True)
        args = glm_driver.build_arg_parser().parse_args([
            "--train-data", train, "--validate-data", val,
            "--output-dir", out, "--task", "logistic", "--reg-type", "l2",
            "--output-mode", "all", "--training-report",
            "--reg-weights", "0.1,1,10", "--max-iters", "50",
            "--n-features", str(N_FEATURES), "--device", DEVICE,
            "--stream-chunk-rows", str(STREAM_DRIVER_CHUNK_ROWS),
            "--stream-storage-dir", os.path.join(out, "store"),
            "--data-parallel", "auto"])
        torch.cuda.synchronize()
        _kernels.reset_launches()
        distributed.reset_allreduces()
        t0 = time.perf_counter()
        with PhotonLogger(out) as logger:
            res = glm_driver._run_impl(args, logger, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["unit"] = dict(_kernels.LAUNCHES)
        passes = res["streaming"]["transfer"]["passes"]
        names = sorted(f for f in os.listdir(stream_out)
                       if f.startswith("model_lambda_"))
        check(bool(names) and all(
            open(os.path.join(out, f), "rb").read()
            == open(os.path.join(stream_out, f), "rb").read()
            for f in names),
            "12a: the GLM driver's streamed group route wrote model files "
            "that differ from phase 9c's one-card run")
        reduces = distributed.ALLREDUCES["count"]
        check(0 < reduces <= passes,
              f"12a: {reduces} all-reduces against {passes} streamed "
              "passes (one a value, batch or HVP pass)")
        glog(f"12a GLM driver --stream-chunk-rows over the group: {names} "
             f"byte-equal to phase 9c's run; {wall:.2f} s, {passes} passes, "
             f"{reduces} all-reduces")
        metrics["glm_stream_s"] = wall
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    group = group_call_result(group_call)
    wall, started = group["wall_s"], group_call[2]
    for name in ("per_user", "per_item", "per_context"):
        p = group[f"plan.{name}"]
        glog(f"12b plan {name} over {GROUP_RANKS} ranks: n_split "
             f"{p['n_split']}, n_packed {p['n_packed']}, imbalance_ratio "
             f"{p['imbalance_ratio']:.4f}")
    for name in ("per_user", "per_item", "per_context"):
        e = group[f"descent.{name}"]
        glog(f"12b descent {name}: coefficients {e['coef_err']:.3g} of the "
             f"largest |w| (limit 1e-6), scores {e['score_err']:.3g} of "
             "Σ|x·w| (limit 1e-5)")
    o, f, st = group["ooc"], group["fixed"], group["stream"]
    glog(f"12b per_user out of core at 1/8 over the group: {o['groups']} "
         f"groups, {o['parts']} parts on rank 0; coefficients "
         f"{o['coef_err']:.3g}, scores {o['score_err']:.3g}")
    glog(f"12b row-sharded fixed effect: {f['rows_per']} rows a rank, "
         f"{f['allreduces']} all-reduces, float64 objective gap "
         f"{f['objective_gap']:.3g} to one card (limit 1e-5)")
    glog(f"12b phase 9a's store sharded {GROUP_RANKS} ways: {st['parts']} "
         f"parts of {st['rows_per_part']} rows a rank, {st['allreduces']} "
         f"all-reduce a pass; value {st['value_err']:.3g}, gradient "
         f"{st['grad_err']:.3g} of Σ|terms| (limit 1e-5)")
    glog(f"12b times of {GROUP_RANKS} gloo ranks SHARING ONE CARD (not a "
         f"speed across cards), taken beside the script's own phases (the "
         f"lines marked{BESIDE_MARK}): from {started:.1f} s to about "
         f"{started + wall:.1f} s by the script's clock; whole call "
         f"{wall:.1f} s, dataset builds "
         f"{group['build_s']:.2f} s, descent warm {group['descent_s']:.3f}"
         f" s, cold {group['descent_cold_s']:.3f} s (one card warm "
         f"{group['one_card_descent_s']:.3f} s), out-of-core train+score "
         f"{o['train_score_s']:.3f} s, fixed solve {f['solve_s']:.3f} s, "
         f"streamed pass warm {st['pass_s']:.3f} s, cold "
         f"{st['cold_pass_s']:.3f} s (one card warm "
         f"{st['one_card_pass_s']:.3f} s); "
         f"collectives through host memory (gloo): "
         f"{json.dumps(group['host_staged'])}")
    metrics["group"] = {k: group[k] for k in (
        "build_s", "descent_s", "descent_cold_s", "one_card_descent_s",
        "ooc", "fixed",
        "stream", "host_staged")}
    metrics["group_call_s"] = wall
    ls = group["launches_all_ranks"]
    for op in ("matvec", "rmatvec"):
        check(ls[f"fixed.{op}"] > 0 and ls[f"stream.{op}"] > 0,
              f"12b: the shard instances' {op} never launched")
    launches["game_shard"] = {op: ls[f"fixed.{op}"]
                              for op in ("matvec", "rmatvec")}
    launches["chunk_shard"] = {op: ls[f"stream.{op}"]
                               for op in ("matvec", "rmatvec")}

    # The two new instances against their plain versions.
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    kern = {}
    for label, X in (("game_shard", PHASE12["game_shard"]),
                     ("chunk_shard", PHASE12["chunk_shard"])):
        M = make_glm_data(X, np.zeros(X.shape[0], np.float32),
                          device=DEVICE).features
        kern[label] = kernel_vs_plain(label, M, gen)
        del M
    metrics["seconds"] = time.perf_counter() - t_phase
    glog(f"phase 12: {metrics['seconds']:.1f} s")
    return kern, launches, metrics



# -- phase 13: online serving ---------------------------------------------

SERVE_SOURCE = "photon_ml_tpu_torch/csrc/serve_margins.cu"
SERVE_REPLACES = "photon_ml_tpu/serving/kernels.py:137"
SERVE_MAX_BATCH = 64
SERVE_HOT = 4096
SERVE_BENCH_ENTITIES = 50_000
SERVE_CHUNK = 2048
SERVE_HTTP_ROWS = 512
SERVE_LOAD_SECONDS = 5.0
SERVE_LOAD_CLIENTS = 16
#: the kernel's register tiers (fixed columns a lane holds):
#: ``serve_margins_kernel<KF>`` instances in ``csrc/serve_margins.cu``.
SERVE_TIERS = (1, 2, 4, 8, 16)
SERVE_TRIP_ROUNDS = 200


def serve_inputs(x_f, w, x_r, coefs, hot_mask, seed):
    """One full bucket of the serving kernel's operands on the card: the
    rows' fixed features ``x_f`` and random-effect features ``x_r``, the
    fixed coefficients ``w``, each row's entity coefficients ``coefs``;
    rows in ``hot_mask`` find their entity in a hot table (slot i + 1),
    the others carry it as a cold row.  Offsets N(0, 0.1²)."""
    x_f, w, x_r, coefs = (np.asarray(a, np.float32)
                          for a in (x_f, w, x_r, coefs))
    b, d_r = x_r.shape
    rng = np.random.default_rng(seed)
    table = np.zeros((b + 1, d_r), np.float32)
    slots = np.zeros(b, np.int32)
    cold = np.zeros((b, d_r), np.float32)
    for i in range(b):
        if hot_mask[i]:
            slots[i] = i + 1
            table[i + 1] = coefs[i]
        else:
            cold[i] = coefs[i]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=DEVICE)

    off = rng.normal(scale=0.1, size=b).astype(np.float32)
    return (dev(off), dev(x_f), dev(w), dev(x_r), dev(table), dev(slots),
            dev(cold))


def serve_kernel_checks(label, ops, task):
    """13a: the serving kernel against its plain version at every bucket
    of the ladder, with the request side in HBM and read in place from
    page-locked host memory: margins bitwise the plain version's, the two
    placements bitwise, bitwise repeats, every row of the full bucket
    bitwise the row alone, fused == composed, a hot row == the same row
    cold; times at buckets 1 and the top in both placements against the
    byte bound and the same function as composed torch ops (no single
    PyTorch call computes it).  Returns {bucket: record}."""
    from photon_ml_tpu_torch.experiments import serve_launch
    from photon_ml_tpu_torch.serving import kernels as sk

    off, xf, w, xr, table, slots, cold = ops
    top = off.shape[0]
    dev = torch.device(DEVICE)
    link = sk.link_for_task(task)
    # The request side again in page-locked host memory.
    h_off, h_xf, h_xr, h_slots, h_cold = (
        t.cpu().pin_memory() for t in (off, xf, xr, slots, cold))

    def args(lo, hi, slots_=None, cold_=None):
        s = slots[lo:hi] if slots_ is None else slots_
        c = cold[lo:hi] if cold_ is None else cold_
        return (off[lo:hi], [(xf[lo:hi], w)], [(xr[lo:hi], table, s, c)],
                link)

    def pinned(lo, hi, slots_=None, cold_=None):
        s = h_slots[lo:hi] if slots_ is None else slots_
        c = h_cold[lo:hi] if cold_ is None else cold_
        out = torch.full((2, hi - lo), float("nan"), pin_memory=True)
        return sk.serve_margins_mapped(
            h_off[lo:hi], [(h_xf[lo:hi], w)], [(h_xr[lo:hi], table, s, c)],
            link, out, dev)

    def scale(lo, hi):
        coefs = table.index_select(0, slots[lo:hi].long()) + cold[lo:hi]
        return (off[lo:hi].abs() + (xf[lo:hi] * w).abs().sum(1)
                + (xr[lo:hi] * coefs).abs().sum(1)).double()

    def torch_ops(o, x1, w1, x2, t, s, c):
        m = o + (x1 * w1).sum(1) + (x2 * (t[s.long()] + c)).sum(1)
        return torch.stack([m, {"logistic": torch.sigmoid, "exp": torch.exp,
                                "identity": torch.clone}[link](m)])

    records = {}
    full = None
    for b in [1 << k for k in range(top.bit_length()) if 1 << k < top] + [
            top]:
        out = sk.serve_margins(*args(0, b))
        again = sk.serve_margins(*args(0, b))
        torch.cuda.synchronize()
        plain = sk.serve_margins_plain(*args(0, b))
        check(torch.equal(out, again), f"{label} bucket {b}: two launches "
              "differ")
        check(torch.equal(out[0], plain[0]), f"{label} bucket {b}: margins "
              "not bitwise the plain version's")
        err = float(((out[0] - plain[0]).double().abs()
                     / scale(0, b).clamp_min(1e-30)).max())
        mean_err = float((out[1] - plain[1]).double().abs().max())
        check(err <= RTOL, f"{label} bucket {b}: margins vs plain "
              f"{err:.3g} of Σ|x·w|")
        check(mean_err <= 1e-6, f"{label} bucket {b}: means vs plain "
              f"{mean_err:.3g}")
        host = pinned(0, b)
        check(torch.equal(host, out.cpu()) and torch.equal(host, pinned(0, b)),
              f"{label} bucket {b}: the pinned placement differs from HBM "
              "or between two launches")
        packed = torch.cat([off[:b, None], xf[:b], xr[:b], cold[:b]],
                           1).contiguous()
        fused = sk.build_fused_bucket_kernel(task)(
            packed, slots[None, :b].contiguous(), (w,), (table,))
        fused_pin = sk.serve_margins_mapped(
            *sk.fused_operands(packed.cpu().pin_memory(),
                               h_slots[None, :b].clone().pin_memory(),
                               (w,), (table,)),
            link, torch.zeros((2, b), pin_memory=True), dev)
        check(torch.equal(fused, out) and torch.equal(fused_pin, host),
              f"{label} bucket {b}: fused != composed")
        records[b] = {"max_abs_err": float((out[0] - plain[0]).abs().max()),
                      "rel_err": err}
        if b == top:
            full = out
    # Every row of the full bucket alone; a hot row cold; both placements.
    hot_rows = 0
    full_host = full.cpu()
    for i in range(top):
        one = sk.serve_margins(*args(i, i + 1))
        one_pin = pinned(i, i + 1)
        check(torch.equal(one[:, 0], full[:, i])
              and torch.equal(one_pin[:, 0], full_host[:, i]),
              f"{label}: row {i} of the full bucket differs from the row "
              f"scored alone")
        s = int(slots[i])
        if s:
            hot_rows += 1
            as_cold = sk.serve_margins(*args(
                i, i + 1, torch.zeros(1, dtype=torch.int32, device=DEVICE),
                table[s:s + 1].clone()))
            as_cold_pin = pinned(
                i, i + 1, torch.zeros(1, dtype=torch.int32).pin_memory(),
                table[s:s + 1].cpu().pin_memory())
            check(torch.equal(as_cold, one)
                  and torch.equal(as_cold_pin, one_pin),
                  f"{label}: row {i} hot != cold")
    torch.cuda.synchronize()
    check(hot_rows > 0, f"{label}: no hot row to compare")
    d_f, d_r = xf.shape[1], xr.shape[1]
    for b in (1, top):
        a = args(0, b)
        ms = median_ms(lambda: sk.serve_margins(*a))
        blk, _, _ = serve_launch.pinned_block(a[:3], link, dev)
        pinned_ms = median_ms(lambda: sk.launch(blk, dev))
        plain_ms = median_ms(lambda: sk.serve_margins_plain(*a))
        ops_ms = median_ms(lambda: torch_ops(off[:b], xf[:b], w, xr[:b],
                                             table, slots[:b], cold[:b]))
        # Bytes the function must move: offsets, both feature blocks, w,
        # the hot-table rows these slots name (distinct), the cold rows,
        # the slots, and the (2, b) output.
        n_rows = int(torch.unique(slots[:b]).numel())
        nbytes = 4 * (b + b * d_f + d_f + 2 * b * d_r + n_rows * d_r
                      + b + 2 * b)
        flops = b * (2 * d_f + 3 * d_r + 4)
        bound_ms, bound_by = bytes_bound(nbytes, flops)
        records[b].update(ms=ms, pinned_ms=pinned_ms, plain_ms=plain_ms,
                          torch_ops_ms=ops_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        log(f"serving [13a {label}] bucket {b}: kernel {ms:.4f} ms (HBM "
            f"inputs), {pinned_ms:.4f} ms (pinned inputs read in place), "
            f"plain {plain_ms:.4f} ms, composed torch ops {ops_ms:.4f} ms, "
            f"bound {bound_ms:.7f} ms ({bound_by}, {nbytes} bytes); margins "
            f"vs plain {records[b]['max_abs_err']:.3g} abs, {err:.3g} of "
            f"Σ|x·w|")
    log(f"serving [13a {label}]: every bucket {sorted(records)} bitwise the "
        f"plain version's margins (means within 1e-6) with HBM and pinned "
        f"inputs, launches bitwise repeatable, {top} rows bitwise alone, "
        f"fused == composed, {hot_rows} hot rows == cold")
    return records


def serve_round_trips(label, rt, rows):
    """(b): the host clock around ``rt._launch`` on all-hot batches of the
    first 1, 8 and 64 of ``rows`` (their entities known), median of
    :data:`SERVE_TRIP_ROUNDS` after a warm-up.  {bucket: ms}."""
    from photon_ml_tpu_torch.experiments import serve_launch

    trips = {b: serve_launch.round_trip_ms(rt, rows, b, SERVE_TRIP_ROUNDS)
             for b in serve_launch.TRIP_BUCKETS}
    log(f"serving [13 {label}] round trip (_launch, all-hot, median of "
        f"{SERVE_TRIP_ROUNDS}): " + ", ".join(
            f"bucket {b} {ms:.4f} ms" for b, ms in trips.items()))
    return trips


def serve_profile(label, rt, rows):
    """A ``torch.profiler`` trace of 100 all-hot ``score_rows`` batches:
    the trace must hold exactly 100 ``serve_margins_kernel`` launches and
    no memcpy (the request side is read in place, nothing is copied)."""
    from torch.profiler import ProfilerActivity, profile

    rt.score_rows(rows)  # promote: the batches below are all hot
    misses = sum(c.hot.misses for c in rt.random)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            rt.score_rows(rows)
        torch.cuda.synchronize()
    check(sum(c.hot.misses for c in rt.random) == misses,
          f"13 {label}: a profiled batch was not all hot")
    names = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    kernels = sum(n for k, n in names.items() if "serve_margins_kernel" in k)
    copies = {k: n for k, n in names.items() if "memcpy" in k.lower()}
    api_copies = sum(1 for e in prof.events()
                     if e.name.startswith("cudaMemcpy"))
    log(f"serving [13 {label}] profiler: 100 all-hot batches of {len(rows)}"
        f" rows -> {kernels} serve_margins_kernel launches, device events "
        f"{dict(names)}, {api_copies} cudaMemcpy calls")
    check(kernels == 100, f"13 {label}: the trace holds {kernels} "
          "serve_margins_kernel launches for 100 batches")
    check(not copies and not api_copies, f"13 {label}: the trace holds "
          f"copies {copies}, {api_copies} cudaMemcpy calls")
    return {"kernels": kernels, "device_events": dict(names)}


def serving_requests(shards, ids, offsets, imaps, rows):
    """Validation rows as serving requests with features NAMED through the
    saved index maps (each row's nonzeros, duplicates summed)."""
    names = {s: [imaps[s].index_to_name(j) for j in range(len(imaps[s]))]
             for s in shards}
    csr = {s: m.tocsr() for s, m in shards.items()}
    for m in csr.values():
        m.sum_duplicates()
    out = []
    for i in rows:
        feats = {}
        for s, m in csr.items():
            lo, hi = m.indptr[i], m.indptr[i + 1]
            feats[s] = [[names[s][c], "", float(v)]
                        for c, v in zip(m.indices[lo:hi], m.data[lo:hi])]
        out.append({"features": feats,
                    "ids": {k: str(v[i]) for k, v in ids.items()},
                    "offset": float(offsets[i])})
    return out


def dense_requests(shards, ids, offsets, rows):
    """The same rows with ``dense`` shards (the binary wire's form)."""
    out = []
    for i in rows:
        out.append({"dense": {s: np.asarray(m[i].todense(), np.float32)
                              .ravel().tolist() for s, m in shards.items()},
                    "ids": {k: str(v[i]) for k, v in ids.items()},
                    "offset": float(offsets[i])})
    return out


def http_json(base, route, body=None):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + route, data=None if body is None else json.dumps(
            body).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class SubmitClient:
    """A thread scoring ``requests`` through ``submit`` (a service's, an
    HTTP submitter's or a router's) in a loop until stopped; counts
    completed and failed requests."""

    def __init__(self, submit, requests):
        self.submit, self.requests = submit, requests
        self.done, self.failed = 0, []
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        i = 0
        while not self._stop.is_set():
            try:
                self.submit(self.requests[i % len(self.requests)]
                            ).result(timeout=60)
                self.done += 1
            except Exception as exc:  # noqa: BLE001 — counted, then checked
                self.failed.append(repr(exc))
            i += 1

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self.thread.join(timeout=120)
        return False


def tamper_coefficient(path):
    """Flip the sign bit of one coefficient in the first block of a
    deflate Avro container and leave every other byte of the file as it
    was: the file still decodes, so only its fingerprint can tell."""
    import io
    import zlib

    from photon_ml_tpu_torch.io import avro

    with open(path, "rb") as f:
        data = f.read()
    sync = data[-16:]  # every block ends with the header's sync marker
    buf = io.BytesIO(data)
    buf.seek(data.index(sync) + 16)
    head = buf.tell()
    count, size = avro.read_long(buf), avro.read_long(buf)
    start = buf.tell()
    schema = avro.read_schema(path)
    body = io.BytesIO(zlib.decompress(data[start:start + size], -15))
    recs = [avro.read_datum(body, schema) for _ in range(count)]
    coef = next(e for r in recs for e in r["coefficients"]
                if e["value"] != 0.0)
    coef["value"] = -coef["value"]
    out = io.BytesIO()
    for rec in recs:
        avro.write_datum(out, schema, rec)
    block = io.BytesIO()
    avro.write_long(block, count)
    avro.write_bytes(block, zlib.compress(out.getvalue())[2:-4])
    with open(path, "wb") as f:
        f.write(data[:head] + block.getvalue() + data[start + size:])


def serving_healthy(label, runtime):
    st = runtime.stats()
    check(not st["degraded"] and st["degraded_batches"] == 0
          and st["device_failures"] == 0, f"{label}: a batch scored degraded"
          f" ({st['degraded_batches']} degraded, {st['device_failures']} "
          "device failures)")
    check(st["breaker"]["state"] == "closed", f"{label}: breaker "
          f"{st['breaker']['state']}")


def phase_serving(smi, td):
    """Phase 13: serve phase 7's GAME model through the port's serving tier
    (13a the kernel against its plain version, 13b in-process and HTTP
    scoring against the scoring driver, 13c hot swap and a tampered
    rollback under traffic, 13d a closed-loop load on ``bench_serving``'s
    model).  Returns (kernel records, launches by geometry, metrics)."""
    from photon_ml_tpu_torch.data.game_reader import read_game_avro
    from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite
    from photon_ml_tpu_torch.io import avro
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.serving import kernels as sk
    from photon_ml_tpu_torch.serving import loadgen, wire
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.service import (
        ScoringService,
        start_http_server,
    )
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

    def slog(msg):
        log_phase(f"serving [{smi}] {msg}")

    t_phase = time.perf_counter()
    metrics = {}
    cfg = RuntimeConfig(max_batch_size=SERVE_MAX_BATCH,
                        hot_entities=SERVE_HOT, device=DEVICE)
    model_dir = os.path.join(td, "full", "models")
    t0 = time.perf_counter()
    model, imaps = ScoringRuntime.load_model(model_dir, device=DEVICE)
    val = os.path.join(td, "validate.avro")
    v_shards, v_ids, v_y, v_w, v_off, _, _ = read_game_avro(
        val, index_maps=imaps)
    n_val = v_y.shape[0]
    slog(f"model and validation file read in {time.perf_counter() - t0:.2f}"
         f" s ({n_val} rows, {model['per_user'].n_entities} users)")

    # -- 13a: the kernel against its plain version, both geometries ------
    w = model["fixed"].model.coefficients.means.detach().cpu().numpy()
    re = model["per_user"]
    b = SERVE_MAX_BATCH
    keys = [str(k) for k in v_ids["userId"][:b]]
    known = np.array([k in re.coefficients for k in keys])
    ops7 = serve_inputs(v_shards["global"][:b].toarray(), w,
                        v_shards["userFeatures"][:b].toarray(),
                        sk.dense_coefficient_rows(re, keys),
                        known & (np.arange(b) % 2 == 0), 13)
    rec7 = serve_kernel_checks("phase 7's model", ops7, "logistic")
    bench = SyntheticWorkload(n_entities=SERVE_BENCH_ENTITIES, fixed_dim=64,
                              re_dim=8, seed=9)
    breq = [bench.request(i) for i in range(b)]
    bre = bench.model.models["per_entity"]
    ops_b = serve_inputs(
        [r["dense"][bench.fixed_shard] for r in breq],
        bench.model.models["fixed"].model.coefficients.means.numpy(),
        [r["dense"][bench.re_shard] for r in breq],
        sk.dense_coefficient_rows(bre, [r["ids"][bench.entity_key]
                                        for r in breq]),
        np.arange(b) % 2 == 0, 14)
    recb = serve_kernel_checks("bench_serving's model", ops_b, "logistic")
    del ops7, ops_b
    from photon_ml_tpu_torch.experiments import serve_launch

    metrics["launch_floor_ms"] = serve_launch.launch_floor_ms(
        torch.device(DEVICE))
    slog(f"13a: an empty one-warp kernel (the launch floor) "
         f"{metrics['launch_floor_ms']:.4f} ms")

    # -- 13b: phase 7's model served on the card --------------------------
    t0 = time.perf_counter()
    rt = ScoringRuntime(model, imaps, cfg)
    rt.model_path = model_dir
    slog(f"ScoringRuntime: buckets {rt.buckets}, {rt.warmup_compiles} "
         f"warmed in {time.perf_counter() - t0:.2f} s, hot tables "
         f"{rt.hot_table_bytes} bytes")
    requests = serving_requests(v_shards, v_ids, v_off, imaps, range(n_val))
    service = ScoringService(rt, BatcherConfig(
        max_batch_size=SERVE_MAX_BATCH, max_wait_us=1000,
        max_queue=2 * SERVE_CHUNK))
    with service:
        server, _ = start_http_server(service, host="127.0.0.1", port=0)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            # The main path's launches: 13b's in-process and HTTP traffic
            # through the service, counted after the runtime's warm-up.
            torch.cuda.synchronize()
            _kernels.reset_launches()
            b0 = rt.batches
            t0 = time.perf_counter()
            served = []
            for lo in range(0, n_val, SERVE_CHUNK):
                res = service.score_many(requests[lo:lo + SERVE_CHUNK])
                bad = [r for r in res if "error" in r]
                check(not bad, f"13b: in-process scoring failed: {bad[:3]}")
                served.extend(np.float32(r["score"]) for r in res)
            wall = time.perf_counter() - t0
            served = np.asarray(served, np.float32)
            st = rt.stats()
            hot = st["hot_sets"]["per_user"]
            slog(f"13b: {n_val} rows in process in {wall:.2f} s "
                 f"({n_val / wall:.1f} rows/s), {st['batches']} batches, "
                 f"hot hits {hot['hits']}, cold misses {hot['misses']}, "
                 f"evictions {hot['evictions']}, unknown "
                 f"{hot['unknown_entities']}")
            check(hot["evictions"] > 0 and hot["misses"] > 0,
                  "13b: the hot set never evicted (no cold tail)")
            _, recs = avro.read_container(os.path.join(td, "score_host",
                                                       "scores.avro"))
            driver = np.array([r["predictionScore"] for r in recs])
            Xg = v_shards["global"].astype(np.float64)
            Xu = v_shards["userFeatures"].toarray().astype(np.float64)
            W = sk.dense_coefficient_rows(
                re, [str(k) for k in v_ids["userId"]]).astype(np.float64)
            scale = (abs(Xg) @ np.abs(w.astype(np.float64))
                     + (np.abs(Xu) * np.abs(W)).sum(1) + np.abs(v_off))
            err = float((np.abs(served - driver)
                         / np.maximum(scale, 1e-30)).max())
            check(err <= RTOL, f"13b: served margins vs the scoring "
                  f"driver's scores {err:.3g} of Σ|x·w|")
            with open(os.path.join(td, "score_host",
                                   "scoring_result.json")) as f:
                drv_auc = json.load(f)["metric"]
            auc = EvaluationSuite.from_specs(["auc"]).evaluate(
                served.astype(np.float64), v_y, v_w)["auc"]
            check(abs(auc - drv_auc) <= 1e-6, f"13b: served AUC {auc!r} vs "
                  f"the scoring driver's {drv_auc!r}")
            slog(f"13b: served margins vs the scoring driver's scores: max "
                 f"{err:.3g} of Σ|x·w|; AUC {auc!r} vs the driver's "
                 f"{drv_auc!r}")
            metrics["in_process"] = {"rows": n_val, "wall_s": wall,
                                     "rows_per_s": n_val / wall,
                                     "rel_err": err, "auc": auc,
                                     "driver_auc": drv_auc}

            # HTTP: JSON (named features) and the binary wire (dense).
            idx = np.random.default_rng(13).choice(n_val, SERVE_HTTP_ROWS,
                                                   replace=False)
            sub = [requests[i] for i in idx]
            t0 = time.perf_counter()
            via_json = []
            for lo in range(0, len(sub), SERVE_MAX_BATCH):
                status, body = http_json(
                    base, "/score", {"rows": sub[lo:lo + SERVE_MAX_BATCH]})
                check(status == 200, f"13b: /score JSON -> {status}")
                via_json.extend(np.float32(r["score"])
                                for r in body["results"])
            json_s = time.perf_counter() - t0
            dense = dense_requests(v_shards, v_ids, v_off, idx)
            import urllib.request

            t0 = time.perf_counter()
            via_bin = []
            for lo in range(0, len(dense), SERVE_MAX_BATCH):
                req = urllib.request.Request(
                    base + "/score",
                    data=wire.encode_request(dense[lo:lo + SERVE_MAX_BATCH]),
                    headers={"Content-Type": wire.CONTENT_TYPE})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    check(resp.headers.get("Content-Type") ==
                          wire.CONTENT_TYPE, "13b: no binary response")
                    via_bin.extend(np.float32(r["score"]) for r in
                                   wire.decode_response(resp.read()))
            bin_s = time.perf_counter() - t0
            want = served[idx].tobytes()
            check(np.asarray(via_json, np.float32).tobytes() == want,
                  "13b: HTTP JSON scores differ from the in-process scores")
            check(np.asarray(via_bin, np.float32).tobytes() == want,
                  "13b: binary-wire scores differ from the in-process "
                  "scores")
            slog(f"13b: {SERVE_HTTP_ROWS} rows over HTTP JSON "
                 f"({json_s:.2f} s) and the binary wire ({bin_s:.2f} s), "
                 "both bitwise the in-process scores")
            for route in ("/healthz", "/readyz", "/stats"):
                status, body = http_json(base, route)
                check(status == 200, f"13b: {route} -> {status}")
            health = http_json(base, "/healthz")[1]
            check(health["status"] == "ok" and health["degraded"] is False,
                  f"13b: /healthz {health}")
            stats = http_json(base, "/stats")[1]
            check(stats["runtime"]["degraded"] is False,
                  "13b: /stats says degraded")
            serving_healthy("13b", rt)
            torch.cuda.synchronize()
            launches = {"phase 7's model": _kernels.LAUNCHES["serve_margins"]}
            check(launches["phase 7's model"] == rt.batches - b0,
                  f"13b: {launches} launches for {rt.batches - b0} batches")
            # One batch's host-to-result time: filling the page-locked
            # staging buffer, the launch and the wait of a full bucket;
            # and the whole score_rows call (host packing included).
            rows64 = [rt.parse_request(r) for r in sub[:SERVE_MAX_BATCH]]
            packed = np.zeros((SERVE_MAX_BATCH, rt._packed_width),
                              np.float32)
            slots = np.zeros((1, SERVE_MAX_BATCH), np.int32)
            service.stop()
            launch_ms = wall_ms(lambda: rt._launch(SERVE_MAX_BATCH, packed,
                                                   slots), n=50)
            batch_ms = wall_ms(lambda: rt.score_rows(rows64), n=50)
            known = [r for r in requests
                     if r["ids"].get("userId") in re.coefficients]
            metrics["round_trip_ms"] = {"phase7": serve_round_trips(
                "phase 7's model", rt, [rt.parse_request(r) for r in
                                        known[:SERVE_MAX_BATCH]])}
            service.start()
            slog(f"13b: one {SERVE_MAX_BATCH}-row batch: staging fill + "
                 f"launch + wait {launch_ms:.4f} ms; score_rows (host "
                 f"packing, hot lookups included) {batch_ms:.4f} ms")
            metrics["batch_host_to_result_ms"] = launch_ms
            metrics["score_rows_ms"] = batch_ms

            # -- 13c: hot swap and a tampered rollback under traffic -----
            grid_dir = os.path.join(td, "grid", "models")
            from photon_ml_tpu_torch.serving.loadgen import HttpSubmitter

            http = HttpSubmitter(base, wire_format="json", workers=2)
            with SubmitClient(http.submit, sub) as client:
                time.sleep(0.3)
                t0 = time.perf_counter()
                status, body = http_json(base, "/reload",
                                         {"model_dir": grid_dir})
                swap_s = time.perf_counter() - t0
                time.sleep(0.3)
            check(status == 200 and body["status"] == "swapped",
                  f"13c: /reload -> {status} {body}")
            check(not client.failed and client.done > 0,
                  f"13c: {len(client.failed)} requests failed during the "
                  f"swap: {client.failed[:3]}")
            new_rt = service.current_runtime
            check(new_rt.model_version == 2 and new_rt is not rt,
                  "13c: the swap did not commit version 2")
            got = service.score_many(sub)
            fresh = ScoringRuntime(new_rt.model, new_rt.index_maps, cfg)
            ref = np.concatenate([fresh.score_rows(
                [fresh.parse_request(r) for r in sub[lo:lo + b]])[0]
                for lo in range(0, len(sub), b)])
            check(np.asarray([r["score"] for r in got], np.float32
                             ).tobytes() == ref.tobytes(),
                  "13c: the swapped-in version's scores differ from a "
                  "fresh runtime's")
            slog(f"13c: /reload to the grid's model in {swap_s:.2f} s under"
                 f" traffic: {client.done} requests, 0 failed; version 2 "
                 "scores bitwise a fresh runtime's")
            bad_dir = os.path.join(td, "serving_tampered")
            shutil.copytree(grid_dir, bad_dir)
            tamper_coefficient(os.path.join(bad_dir, "random-effect",
                                            "per_user", "coefficients.avro"))
            with SubmitClient(http.submit, sub) as client:
                time.sleep(0.3)
                status, body = http_json(base, "/reload",
                                         {"model_dir": bad_dir})
                time.sleep(0.3)
            http.close()
            check(status == 422 and body["status"] == "rolled_back"
                  and body["version_after"] == 2,
                  f"13c: tampered /reload -> {status} {body}")
            check(not client.failed, f"13c: {len(client.failed)} requests "
                  f"failed during the tampered reload: {client.failed[:3]}")
            check(service.current_runtime is new_rt,
                  "13c: the tampered reload replaced the runtime")
            check(body["stage"] == "load"
                  and "checksum mismatch" in body["reason"],
                  f"13c: the tampered reload was not refused by its "
                  f"fingerprint: {body['stage']!r} {body['reason']!r}")
            slog(f"13c: tampered copy rolled back at stage "
                 f"{body['stage']!r} ({body['reason'][:120]}); "
                 f"{client.done} requests, 0 failed")
            for r in (rt, new_rt, fresh):
                serving_healthy("13c", r)
            metrics["swap_s"] = swap_s
        finally:
            server.shutdown()
            server.server_close()

    # -- 13d: closed-loop load on bench_serving's model -------------------
    from photon_ml_tpu_torch import telemetry

    brt = ScoringRuntime(bench.model, bench.index_maps, cfg)
    bsvc = ScoringService(brt, BatcherConfig(
        max_batch_size=SERVE_MAX_BATCH, max_wait_us=1000, max_queue=1024))
    with telemetry.Telemetry(sinks=[]) as hub, bsvc:
        loadgen.closed_loop(bsvc.submit, bench.request, clients=4,
                            duration_s=0.5)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        b0, r0 = brt.batches, brt.rows_scored
        report = loadgen.closed_loop(bsvc.submit, bench.request,
                                     clients=SERVE_LOAD_CLIENTS,
                                     duration_s=SERVE_LOAD_SECONDS)
        torch.cuda.synchronize()
        launches["bench_serving's model"] = _kernels.LAUNCHES["serve_margins"]
        batches, rows = brt.batches - b0, brt.rows_scored - r0
        occ = hub.snapshot()["gauges"].get("serving_batch_occupancy")
    brows = [brt.parse_request(bench.request(i))
             for i in range(SERVE_MAX_BATCH)]
    metrics["round_trip_ms"]["bench_serving"] = serve_round_trips(
        "bench_serving's model", brt, brows)
    metrics["profile"] = serve_profile("bench_serving's model", brt, brows)
    snap = report.snapshot()
    hot = brt.stats()["hot_sets"]["per_entity"]
    mean_rows = rows / max(batches, 1)
    check(report.errors == 0 and report.rejected == 0 and
          report.completed > 0, f"13d: closed loop {snap}")
    serving_healthy("13d", brt)
    check(launches["bench_serving's model"] == batches,
          f"13d: {launches} launches for {batches} batches")
    slog(f"13d: {SERVE_LOAD_CLIENTS} closed-loop clients for "
         f"{SERVE_LOAD_SECONDS} s: {snap['throughput_rps']} requests/s, p50 "
         f"{snap['latency_p50_ms']} ms, p99 {snap['latency_p99_ms']} ms, p99.9"
         f" {snap['latency_p999_ms']} ms, mean batch {mean_rows:.2f} rows, "
         f"hot-hit rate {hot['hit_rate']:.4f}, occupancy gauge {occ}, "
         f"{report.errors} errors, {report.rejected} rejected — {smi}")
    metrics["load"] = dict(snap, mean_batch_rows=mean_rows,
                           hot_hit_rate=hot["hit_rate"], card=smi)
    for name, n in launches.items():
        check(n > 0, f"13: the serving kernel never launched on {name}'s "
              "main path")
    metrics["phase_s"] = time.perf_counter() - t_phase
    slog(f"phase 13: {metrics['phase_s']:.1f} s; main-path launches "
         f"{launches}")
    records = []
    for label, recs, n in (("", rec7, launches["phase 7's model"]),
                           (".bench_serving", recb,
                            launches["bench_serving's model"])):
        for bucket in (1, SERVE_MAX_BATCH):
            r = recs[bucket]
            records.append({
                "name": f"serve_margins{label}.b{bucket}", "route": "cuda",
                "source": SERVE_SOURCE, "replaces": SERVE_REPLACES,
                "launches": n, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None})
    metrics["torch_ops_ms"] = {f"{g}.b{bk}": recs[bk]["torch_ops_ms"]
                               for g, recs in (("phase7", rec7),
                                               ("bench_serving", recb))
                               for bk in (1, SERVE_MAX_BATCH)}
    handoff = {"model": model, "imaps": imaps, "requests": sub,
               "cluster_requests": requests[:CLUSTER_SCORED],
               "swap_s": metrics["swap_s"]}
    return records, launches, metrics, handoff


PROC_WORKERS = 2
PROC_REQUESTS = 4096
PROC_RATE_RPS = 240.0
DELTA_FRACTION = 0.01
FLEET_HOSTS = 2
FLEET_BUDGET_RPS = 100_000.0


def kill_and_respawn(sup, rid):
    """A scenario action: kill replica ``rid`` (a real SIGKILL for a
    worker process) and wait for its restart; returns the seconds from
    the kill to the replica serving again."""
    before = sup.replicas[rid].restarts
    t0 = time.perf_counter()
    sup.kill_replica(rid)
    deadline = t0 + 60.0
    while time.perf_counter() < deadline:
        rep = sup.replicas[rid]
        if rep.restarts > before and rep.state == "healthy":
            return {"killed": rid, "respawn_s": time.perf_counter() - t0}
        time.sleep(0.005)
    return {"killed": rid, "respawn_s": None}


def perturbed_copy(model, name, fraction, seed):
    """``model`` with ``fraction`` of coordinate ``name``'s entity rows
    shifted (a copy: the base model's tables are untouched)."""
    from photon_ml_tpu_torch.game.model import GameModel, RandomEffectModel

    sub = model.models[name]
    rng = np.random.default_rng(seed)
    keys = sorted(sub.coefficients)
    pick = rng.choice(len(keys), max(1, int(fraction * len(keys))),
                      replace=False)
    table = dict(sub.coefficients)
    for i in pick:
        cols, vals = table[keys[i]]
        table[keys[i]] = (cols, (vals + rng.normal(
            0, 0.1, vals.shape)).astype(np.float32))
    models = dict(model.models)
    models[name] = RandomEffectModel(
        coefficients=table, feature_shard=sub.feature_shard,
        entity_key=sub.entity_key, task=sub.task,
        n_features=sub.n_features, variances=sub.variances)
    return GameModel(models=models, task=model.task), len(pick)


def phase_process_fleet(smi, td, handoff):
    """Phase 14: the process and fleet tier and model freshness on the
    card (14a a 2-worker pool on one shared-memory publication against
    the in-process runtime, 14b the worker_kill and replica_kill
    scenarios at the reference's full rate, 14c a delta published and
    applied over the pool under load, 14d a fleet of two HTTP hosts with
    a quota coordinator and the shared-memory ingress).  ``handoff`` is
    phase 13's model, index maps, requests and full-reload seconds.
    Returns (launches by geometry, metrics)."""
    import urllib.request

    from photon_ml_tpu_torch import chaos, telemetry
    from photon_ml_tpu_torch.analysis.sanitizers import ProcessLeakSentinel
    from photon_ml_tpu_torch.freshness.delta import (
        apply_delta,
        diff_game_models,
        read_delta,
    )
    from photon_ml_tpu_torch.freshness.publisher import DeltaPublisher
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.serving import loadgen, shm_model, wire
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.fleet import (
        FleetBudget,
        FleetRouter,
        LocalHost,
        QuotaCoordinator,
    )
    from photon_ml_tpu_torch.serving.procpool import WorkerPool
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.service import ScoringService
    from photon_ml_tpu_torch.serving.shm_ingress import (
        ShmIngress,
        ShmIngressClient,
    )
    from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
    from photon_ml_tpu_torch.serving.tenancy import TenancyConfig, TenantSpec

    def plog(msg):
        log_phase(f"process tier [{smi}] {msg}")

    t_phase = time.perf_counter()
    metrics, launches = {}, {}
    cfg = RuntimeConfig(max_batch_size=SERVE_MAX_BATCH,
                        hot_entities=SERVE_HOT, device=DEVICE)
    bcfg = BatcherConfig(max_batch_size=SERVE_MAX_BATCH, max_wait_us=1000,
                         max_queue=1024)
    bench = SyntheticWorkload(n_entities=SERVE_BENCH_ENTITIES, fixed_dim=64,
                              re_dim=8, seed=9)
    requests = [bench.request(i) for i in range(PROC_REQUESTS)]
    n_warm = len(ScoringRuntime._bucket_ladder(SERVE_MAX_BATCH))

    def scores(submit, reqs, chunk=256):
        # In chunks, under the admission tiers' watermarks.
        out = []
        for lo in range(0, len(reqs), chunk):
            futs = [submit(r) for r in reqs[lo:lo + chunk]]
            out.extend(np.float32(f.result(timeout=120)["score"])
                       for f in futs)
        return np.asarray(out, np.float32)

    def single_scores(model, imaps, reqs):
        rt = ScoringRuntime(model, imaps, cfg)
        return np.concatenate([rt.score_rows(
            [rt.parse_request(r) for r in reqs[lo:lo + SERVE_MAX_BATCH]])[0]
            for lo in range(0, len(reqs), SERVE_MAX_BATCH)])

    def pool_service(model, imaps):
        pool = WorkerPool(model, imaps, runtime_config=cfg)
        sup = ReplicaSupervisor(pool=pool, n_replicas=PROC_WORKERS,
                                probe_interval_s=0.1, probe_timeout_s=60.0,
                                probe_failure_threshold=5)
        return pool, sup, ScoringService(sup, bcfg)

    def settle(sup):
        # Two more heartbeats from every worker: the first was sent after
        # the results in hand, and the second comes only once the first
        # was folded.
        seen = [[rep.batcher._hb] for rep in sup.replicas]
        deadline = time.perf_counter() + 30.0
        while not all(len(s) >= 3 for s in seen):
            check(time.perf_counter() < deadline,
                  "14: a worker sent no heartbeat for 30 s")
            time.sleep(0.01)
            for rep, s in zip(sup.replicas, seen):
                if rep.batcher._hb is not s[-1]:
                    s.append(rep.batcher._hb)

    def pool_reading(label, pool, sup=None, reset=False):
        # Every worker's folded launches against the batches it scored:
        # each of its processes adds its warm-up buckets.
        if sup is not None:
            settle(sup)
        counts = pool.launch_counts(reset=reset)
        for rid, c in counts.items():
            n = c["launches"].get("serve_margins", 0)
            check(n == c["batches"] + n_warm * c["processes"],
                  f"{label}: worker {rid} folded {n} launches for "
                  f"{c['batches']} batches and {c['processes']} "
                  f"processes' {n_warm} warm-up buckets")
        return counts

    def pool_launches(label, base, end):
        # The main path's launches since ``base`` (which zeroed the
        # parent's count): the workers' folded launches, less the warm-up
        # buckets of the processes started since, equal to their batches.
        def delta(key):
            return sum(end[r][key] - base.get(r, {}).get(key, 0)
                       for r in end)

        folded = sum(end[r]["launches"].get("serve_margins", 0)
                     - base.get(r, {}).get("launches", {}).get(
                         "serve_margins", 0) for r in end)
        n = _kernels.LAUNCHES["serve_margins"]
        check(n == folded, f"{label}: the parent counted {n} launches, "
              f"its workers {folded}")
        main = n - n_warm * delta("processes")
        check(main == delta("batches") and main > 0,
              f"{label}: {main} launches besides warm-ups for "
              f"{delta('batches')} batches")
        return main, delta("processes")

    def in_process_reading(runtimes, reset=False):
        # The launch count and this process's scored batches, read while
        # no runtime of ``runtimes`` is inside a batch.
        with contextlib.ExitStack() as held:
            for rt in runtimes:
                held.enter_context(rt.score_lock)
            if reset:
                _kernels.reset_launches()
            return (_kernels.LAUNCHES["serve_margins"],
                    hub.snapshot()["counters"].get("serving_batches_total",
                                                   0))

    def in_process_launches(label, b0, runtimes, restarted):
        # The main path's launches since ``in_process_reading(reset=
        # True)``, less the warm-up buckets of the runtimes built since,
        # equal to the batches scored.
        n, b = in_process_reading(runtimes)
        main = n - n_warm * restarted
        check(main == b - b0 and main > 0,
              f"{label}: {n} launches ({restarted} runtimes built since, "
              f"{n_warm} warm-up buckets each) for {b - b0} batches")
        return main

    with telemetry.Telemetry(sinks=[]) as hub, \
            ProcessLeakSentinel(grace_s=30.0, strict=True):
        # The in-process runtime's scores, the reference for 14a and 14d
        # (its launches precede every counted window).
        want = single_scores(bench.model, bench.index_maps, requests)

        # -- 14a: two spawned workers on one shared-memory publication --
        t0 = time.perf_counter()
        pool, sup, service = pool_service(bench.model, bench.index_maps)
        with service:
            start_s = time.perf_counter() - t0
            published = sum(seg["nbytes"]
                            for seg in pool.manifest["segments"].values())
            mapped = hub.snapshot()["gauges"].get(
                "serving_shared_segment_bytes")
            check(mapped == published, f"14a: {mapped} shared bytes mapped "
                  f"for one {published}-byte publication")
            # The main path's launches from here: every worker's warm-up
            # is folded in, and the count is zeroed.
            base = pool_reading("14a", pool, sup, reset=True)
            t0 = time.perf_counter()
            got = scores(service.submit, requests)
            pool_s = time.perf_counter() - t0
            for rep in sup.replicas:
                st = rep.batcher.stats()
                check(st["device"] == DEVICE and st["jax_imported"] is False,
                      f"14a: worker {rep.rid}: device {st['device']}, jax "
                      f"imported {st['jax_imported']}")
            mid = pool_reading("14a", pool, sup)
            folded = {rid: (c["launches"]["serve_margins"]
                            - base[rid]["launches"]["serve_margins"],
                            c["batches"] - base[rid]["batches"])
                      for rid, c in mid.items()}
            check(sorted(folded) == list(range(PROC_WORKERS)) and all(
                n == b > 0 for n, b in folded.values()),
                f"14a: (launches, batches) by worker {folded}")
            plog(f"14a: {PROC_WORKERS} workers up in {start_s:.2f} s on one "
                 f"{published}-byte publication (mapped once); "
                 f"{PROC_REQUESTS} requests in {pool_s:.2f} s; folded "
                 f"(launches, batches) by worker since their warm-up "
                 f"{folded}")
            metrics["pool"] = {"start_s": start_s,
                               "published_bytes": published,
                               "requests_s": pool_s,
                               "folded": {str(k): v for k, v in
                                          folded.items()}}

            # -- 14b: worker_kill at the reference's full rate ----------
            report = loadgen.run_scenario(
                service.submit, lambda i, phase: bench.request(i),
                loadgen.SCENARIOS["worker_kill"],
                base_rate_rps=PROC_RATE_RPS,
                actions={"kill_worker": lambda: kill_and_respawn(sup, 0)})
            kw = report.snapshot()
            respawn = report.actions.get("kill_worker")
            check(report.errors == 0 and report.rejected == 0 and
                  report.completed > 0, f"14b: worker_kill {kw}")
            check(isinstance(respawn, dict) and respawn["respawn_s"],
                  f"14b: the killed worker did not respawn: {respawn}")
            plog(f"14b: worker_kill at {PROC_RATE_RPS:g} requests/s: "
                 f"{report.completed} completed, {report.errors} errors, "
                 f"{report.rejected} rejected; p50 {kw['latency_p50_ms']} "
                 f"ms, p99 {kw['latency_p99_ms']} ms, p99.9 "
                 f"{kw['latency_p999_ms']} ms; respawn "
                 f"{respawn['respawn_s']:.2f} s")
            metrics["worker_kill"] = {k: kw[k] for k in (
                "completed", "errors", "rejected", "latency_p50_ms",
                "latency_p99_ms", "latency_p999_ms")} | {
                "rate_rps": PROC_RATE_RPS,
                "respawn_s": respawn["respawn_s"]}
        # Read once the pool is closed: every worker's last heartbeat (a
        # clean stop sends one) is folded.
        main, started = pool_launches(
            "14a-14b", base, pool_reading("14a-14b", pool))
        check(started == 1, f"14b: {started} worker processes started "
              "after the warm-up, for one kill")
        launches["bench_serving's model"] = main
        plog(f"14a-14b: {main} serve_margins launches for as many worker "
             f"batches (the respawned worker's {n_warm} warm-up buckets "
             "besides)")
        check(got.tobytes() == want.tobytes(), "14a: worker scores differ "
              "from the in-process runtime's")
        check(not shm_model.live_segments(),
              f"14a: segments left mapped: {shm_model.live_segments()}")

        built = []

        def replica_runtime():
            rt = ScoringRuntime(bench.model, bench.index_maps, cfg)
            built.append(rt)
            return rt

        sup2 = ReplicaSupervisor(replica_runtime, n_replicas=2,
                                 probe_interval_s=0.1)
        with ScoringService(sup2, bcfg) as svc2:
            _, b0 = in_process_reading(built, reset=True)
            n_built = len(built)
            report = loadgen.run_scenario(
                svc2.submit, lambda i, phase: bench.request(i),
                loadgen.SCENARIOS["replica_kill"],
                base_rate_rps=PROC_RATE_RPS,
                actions={"kill_replica": lambda: kill_and_respawn(sup2, 0)})
        main = in_process_launches("14b replica_kill", b0, built,
                                   len(built) - n_built)
        launches["bench_serving's model"] += main
        rk = report.snapshot()
        restart = report.actions.get("kill_replica")
        check(report.errors == 0 and report.rejected == 0 and
              isinstance(restart, dict) and restart["respawn_s"],
              f"14b: replica_kill {rk} {restart}")
        plog(f"14b: replica_kill (in-process replicas) at {PROC_RATE_RPS:g} "
             f"requests/s: {report.completed} completed, 0 errors, 0 "
             f"rejected; p50 {rk['latency_p50_ms']} ms, p99 "
             f"{rk['latency_p99_ms']} ms, p99.9 {rk['latency_p999_ms']} ms;"
             f" restart {restart['respawn_s']:.3f} s; {main} launches for "
             f"as many batches (the restarted runtime's warm-up besides)")
        metrics["replica_kill"] = {k: rk[k] for k in (
            "completed", "latency_p50_ms", "latency_p99_ms",
            "latency_p999_ms")} | {"restart_s": restart["respawn_s"]}

        # -- 14d: a fleet of two HTTP hosts with a quota coordinator ------
        tenancy = TenancyConfig(tenants=(TenantSpec(name="acme"),))
        coord = QuotaCoordinator([FleetBudget("acme", FLEET_BUDGET_RPS)],
                                 lease_ttl_s=5.0)
        host_rts = [ScoringRuntime(bench.model, bench.index_maps, cfg)
                    for _ in range(FLEET_HOSTS)]
        hosts = [LocalHost(f"h{i}", ScoringService(rt, BatcherConfig(
            max_batch_size=SERVE_MAX_BATCH, max_wait_us=1000,
            max_queue=1024, tenancy=tenancy))).start()
            for i, rt in enumerate(host_rts)]
        router = FleetRouter([h.base_url for h in hosts],
                             probe_interval_s=10.0)
        try:
            _, b0 = in_process_reading(host_rts, reset=True)
            leases = [h.attach_lease_client(coord) for h in hosts]
            # Two renewal rounds: the first host's first lease holds the
            # whole budget until its second renewal releases the share
            # the second host asked for.
            check(all([lc.poll_once() for _ in range(2) for lc in leases]),
                  "14d: a host did not take its lease")
            check(all(lc.leases["acme"].rate_rps > 0 for lc in leases),
                  f"14d: a host holds no lease: "
                  f"{[lc.stats() for lc in leases]}")
            granted = sum(lc.leases["acme"].rate_rps for lc in leases)
            check(granted <= FLEET_BUDGET_RPS + 1e-6,
                  f"14d: {granted} requests/s leased over the budget")
            router.start()
            tagged = [dict(r, tenant="acme") for r in requests[:256]]
            plan = chaos.FaultPlan([chaos.FaultSpec(site="serving.host",
                                                    at=3)])
            with plan:
                via_fleet = scores(router.submit, tagged)
            check([f["site"] for f in plan.fired] == ["serving.host"] and
                  router.healthy_count == FLEET_HOSTS - 1,
                  f"14d: the host fault did not mark a host down "
                  f"({plan.fired}, {router.healthy_count} healthy)")
            check(via_fleet.tobytes() == want[:256].tobytes(),
                  "14d: fleet scores differ from the in-process runtime's")
            lplan = chaos.FaultPlan([chaos.FaultSpec(site="quota.lease",
                                                     at=0)])
            with lplan:
                stale = not leases[0].poll_once() and leases[0].stale
            check(stale and leases[0].leases["acme"].rate_rps > 0,
                  "14d: a partitioned host did not keep its last lease")
            # The shared-memory ingress against the HTTP binary path.
            ingress = ShmIngress(hosts[1].service).start()
            client = ShmIngressClient(ingress.name)
            try:
                # Under the tenant partition's queue (64 by default).
                dense = tagged[:32]
                via_ring = client.score_many(dense, timeout_s=60.0)
                http = urllib.request.Request(
                    hosts[1].base_url + "/score",
                    data=wire.encode_request(dense),
                    headers={"Content-Type": wire.CONTENT_TYPE,
                             "Accept": wire.CONTENT_TYPE})
                with urllib.request.urlopen(http, timeout=60) as resp:
                    via_http = wire.decode_response(resp.read())
            finally:
                client.close()
                ingress.stop()
            ring = np.asarray([r["score"] for r in via_ring], np.float64)
            over_http = np.asarray([r["score"] for r in via_http],
                                   np.float64)
            check(ring.tobytes() == over_http.tobytes(),
                  "14d: shared-memory ingress scores differ from the HTTP "
                  "binary path's")
            main = in_process_launches("14d", b0, host_rts, 0)
            launches["bench_serving's model"] += main
            plog(f"14d: {FLEET_HOSTS} hosts behind a FleetRouter, leases "
                 f"{granted:.1f} of {FLEET_BUDGET_RPS:g} requests/s; a "
                 f"serving.host fault marked one host down and 256 requests"
                 f" scored with 0 failures, bitwise the in-process runtime;"
                 f" a quota.lease fault kept the last lease; shm ingress "
                 f"bitwise the HTTP binary path on {len(dense)} rows; "
                 f"{main} launches for as many batches")
        finally:
            router.stop()
            for h in hosts:
                h.stop()

        # -- 14c: a delta published and applied over the pool -----------
        model, imaps, sub = (handoff["model"], handoff["imaps"],
                             handoff["requests"])
        target, n_rows = perturbed_copy(model, "per_user", DELTA_FRACTION,
                                        14)
        t0 = time.perf_counter()
        # Phase 17 publishes the same delta over the wire.
        handoff["delta"] = diff_game_models(model, target)
        with DeltaPublisher(os.path.join(td, "publications")) as publisher:
            pub = publisher.publish(handoff["delta"])
        publish_s = time.perf_counter() - t0
        bad = os.path.join(td, "delta_flipped")
        shutil.copytree(pub.path, bad)
        seg = next(os.path.join(bad, f) for f in sorted(os.listdir(bad))
                   if f.startswith("segment-"))
        with open(seg, "r+b") as f:
            f.seek(-8, os.SEEK_END)
            byte = f.read(1)
            f.seek(-8, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
        pool, sup, service = pool_service(model, imaps)
        with service:
            base = pool_reading("14c", pool, sup, reset=True)
            with SubmitClient(service.submit, sub) as client:
                time.sleep(0.3)
                t0 = time.perf_counter()
                result = service.reload(pub.path, mode="delta")
                apply_s = time.perf_counter() - t0
                time.sleep(0.3)
            check(result.status == "swapped" and not client.failed and
                  client.done > 0, f"14c: delta apply {result}; "
                  f"{len(client.failed)} of {client.done} requests failed: "
                  f"{client.failed[:3]}")
            done = client.done
            served = scores(service.submit, sub)
            with SubmitClient(service.submit, sub) as client:
                time.sleep(0.2)
                rolled = service.reload(bad, mode="delta")
                time.sleep(0.2)
            check(rolled.status == "rolled_back" and rolled.stage == "load"
                  and "sha256" in rolled.reason and not client.failed,
                  f"14c: flipped delta -> {rolled}; {len(client.failed)} "
                  f"failed")
            check(service.swapper.version == result.version_after,
                  "14c: the flipped delta changed the serving version")
        main, started = pool_launches("14c", base,
                                      pool_reading("14c", pool))
        check(started == 0, f"14c: {started} worker processes started "
              "after the warm-up")
        launches["phase 7's model"] = main
        patched = apply_delta(model, read_delta(pub.path))
        fresh = single_scores(patched, imaps, sub)
        check(served.tobytes() == fresh.tobytes(), "14c: served scores "
              "after the delta differ from a fresh runtime's on the patched "
              "model")
        plog(f"14c: delta of {n_rows} of {model['per_user'].n_entities} "
             f"user rows published in {publish_s:.2f} s and applied over "
             f"{PROC_WORKERS} workers in {apply_s:.2f} s under load "
             f"({done} requests, 0 failed; the full reload took "
             f"{handoff['swap_s']:.2f} s in 13c); served scores bitwise a "
             f"fresh runtime's on the patched model; a flipped segment "
             f"rolled back at stage {rolled.stage!r}; {main} launches "
             "for as many worker batches")
        metrics["delta"] = {"rows": n_rows, "publish_s": publish_s,
                            "apply_s": apply_s,
                            "full_reload_s": handoff["swap_s"]}
    for name, n in launches.items():
        check(n > 0, f"14: the serving kernel never launched on {name}'s "
              "main path")
    metrics["phase_s"] = time.perf_counter() - t_phase
    plog(f"phase 14: {metrics['phase_s']:.1f} s; main-path launches "
         f"{launches}")
    return launches, metrics


# -- phase 15: tensor parallel and tuning ----------------------------------

TP_DP, TP_TP = 2, 2
TP_MAX_ITERS = 100
TP_OWLQN_ITERS = 200  # 3b's OWL-QN budget, for its KKT test
# At phase 4's elastic-net λ both the resident and the tiled OWL-QN stop
# short of 3b's KKT decrement at 3b's 1e-7 (2.9e-7 of F on the card);
# at 1e-9 they run on to the float32 gradient's noise floor.
TP_OWLQN_TOL = 1e-9
TP_TRON_ITERS = 50
TP_TOL = 1e-7
TP_OBJ_TOL = 1e-5
TUNE_TRIALS = 8
TUNE_WORKERS = 4
TUNE_GRID = 6
GAME_TUNE_EVALS = 4


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name = value`` for the block's duration."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


#: phase 4's LIBSVM files as parsed by :func:`parse_once`, by path and
#: arguments: every driver run after phase 4's first reads the same copies.
_PARSED: dict = {}


def parse_once():
    """A memoizing stand-in for ``data.libsvm.read_libsvm``: each file is
    parsed once, by phase 4's first driver run (phase 4's other runs, 11b's,
    11c's, 9c's and 12a's runs, 15a's arrays, every tuning CLI run of 15b
    and 16a's runs read the same copy)."""
    from photon_ml_tpu_torch.data import libsvm

    inner = libsvm.read_libsvm

    def read(path, **kw):
        key = (path, tuple(sorted(kw.items())))
        if key not in _PARSED:
            t0 = time.perf_counter()
            _PARSED[key] = inner(path, **kw)
            log(f"parsed {os.path.basename(path)} once for the driver runs "
                f"from phase 4 on in {time.perf_counter() - t0:.2f} s")
        return _PARSED[key]

    return read


def tp_config(kind):
    """Phase 4's configuration ``kind`` as a resident problem (its value
    summed in float64, as 3b's are) and the λ1/λ2 the problem splits λ
    into, as functions of λ."""
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    reg = (RegularizationContext.elastic_net(0.5) if kind == "elastic_net"
           else RegularizationContext.l2())
    opt = OptimizerConfig(
        optimizer=OptimizerType.TRON if kind == "tron"
        else OptimizerType.LBFGS,
        max_iters={"tron": TP_TRON_ITERS, "elastic_net": TP_OWLQN_ITERS}.get(
            kind, TP_MAX_ITERS),
        tolerance=TP_OWLQN_TOL if kind == "elastic_net" else TP_TOL)
    return GlmOptimizationProblem("logistic", GlmOptimizationConfig(
        optimizer=opt, regularization=reg), accumulate="f64")


def tp_solve(kind, data, mesh, lam, mask):
    """``kind``'s solve over the tiles ``data`` at λ, split as
    :func:`tp_config`'s problem splits it."""
    from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig
    from photon_ml_tpu_torch.optim.owlqn import OWLQNConfig
    from photon_ml_tpu_torch.optim.tron import TRONConfig
    from photon_ml_tpu_torch.parallel import tensor

    if kind == "elastic_net":
        half = float(np.float32(0.5) * np.float32(lam))
        return tensor.tp_owlqn_solve(
            "logistic", data, mesh, half, half, accumulate="f64",
            config=OWLQNConfig(max_iters=TP_OWLQN_ITERS,
                               tolerance=TP_OWLQN_TOL),
            l1_mask=mask)
    if kind == "tron":
        return tensor.tp_tron_solve(
            "logistic", data, mesh, lam, accumulate="f64",
            config=TRONConfig(max_iters=TP_TRON_ITERS, tolerance=TP_TOL))
    return tensor.tp_lbfgs_solve(
        "logistic", data, mesh, lam, accumulate="f64",
        config=LBFGSConfig(max_iters=TP_MAX_ITERS, tolerance=TP_TOL))


def phase_tensor_parallel(X, y, drv_runs, gen):
    """15a: phase 4's three configurations at their selected λ over 2 × 2
    logical tiles of phase 4's training matrix, against the resident solve
    (objective within 1e-5, OWL-QN's KKT test), a bitwise repeat, and 1 × 1
    tiles bitwise the resident solve.  Returns (resident launches, tile
    launches, the tile instance's kernel records, metrics)."""
    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.parallel import tensor

    n, d = X.shape
    t0 = time.perf_counter()
    resident = make_glm_data(X, y, device=DEVICE)
    mesh = tensor.dp_tp_mesh(TP_DP, TP_TP)
    tiles = tensor.shard_glm_data_dp_tp(X, y, mesh, device=DEVICE)
    one = tensor.shard_glm_data_dp_tp(X, y, tensor.dp_tp_mesh(1, 1),
                                      device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    M = tiles.tiles[(0, 0)].features
    log(f"15a: {n} x {d} as {TP_DP} x {TP_TP} tiles of {tiles.rows_per} x "
        f"{tiles.cols_per} (padded width {tiles.padded_width}; tile (0, 0) "
        f"{M.nnz} entries, value-free {M.unit_vals}); builds {build_s:.2f} s")
    check(M.unit_vals, "15a: the binary tiles did not take the value-free "
          "layout")
    # One evaluation's launches: a matvec and an rmatvec a tile.
    tobj = tensor.TileObjective(tp_config("l2").objective, tiles, mesh)
    w = torch.zeros(tiles.padded_width, device=DEVICE)
    _kernels.reset_launches()
    tobj.value_and_grad(w, 1.0)
    torch.cuda.synchronize()
    per_eval = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    log(f"15a: one evaluation's tile launches {json.dumps(per_eval)}")
    check(per_eval == {"matvec_unit": TP_DP * TP_TP,
                       "rmatvec_unit": TP_DP * TP_TP},
          f"15a: an evaluation launched {per_eval}, expected one matvec "
          "and one rmatvec a tile")

    res_launches, tile_launches = {}, {}
    metrics = {"build_s": build_s}

    def counted(into, fn):
        _kernels.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        for k, v in _kernels.LAUNCHES.items():
            into[k] = into.get(k, 0) + v
        return out, time.perf_counter() - t

    for kind, _ in DRIVER_RUNS:
        lam = float(drv_runs[kind][1]["best_lambda"])
        prob = tp_config(kind)
        mask_d = mask_p = None
        if kind == "elastic_net":
            # The driver's intercept (the last column) takes no L1.
            mask_d = torch.ones(d, device=DEVICE)
            mask_d[d - 1] = 0.0
            mask_p = np.ones(tiles.padded_width, np.float32)
            mask_p[d - 1] = 0.0
        ref, ref_s = counted(res_launches, lambda: prob.solve(
            resident, lam, l1_mask=mask_d))
        got, tile_s = counted(tile_launches, lambda: tp_solve(
            kind, tiles, mesh, lam, mask_p))
        again, _ = counted(tile_launches, lambda: tp_solve(
            kind, tiles, mesh, lam, mask_p))
        single, _ = counted(res_launches, lambda: tp_solve(
            kind, one, tensor.dp_tp_mesh(1, 1), lam,
            None if mask_d is None else mask_d.cpu().numpy()))
        f_ref, f_tp = float(ref.value), float(got.value)
        gap = abs(f_tp - f_ref) / abs(f_ref)
        pad = got.w[d:]
        log(f"15a {kind} λ={lam:g}: resident {f_ref!r} in {ref.iterations} "
            f"iterations ({ref_s:.2f} s); tiles {f_tp!r} in "
            f"{got.iterations} ({tile_s:.2f} s), gap {gap:.3g}; padded "
            f"columns {pad.tolist()}")
        check(gap <= TP_OBJ_TOL, f"15a {kind}: tiles' objective {f_tp!r} vs "
              f"the resident {f_ref!r} ({gap:.3g})")
        check(bool((pad == 0).all()), f"15a {kind}: a padded column moved")
        check(torch.equal(got.w, again.w) and torch.equal(got.value,
                                                          again.value),
              f"15a {kind}: a repeat of the tiled solve differs")
        check(torch.equal(single.w, ref.w)
              and torch.equal(single.value, ref.value)
              and single.iterations == ref.iterations,
              f"15a {kind}: 1 x 1 tiles differ from the resident solve")
        rec = {"lambda": lam, "resident": f_ref, "tiles": f_tp, "gap": gap,
               "iterations": [ref.iterations, got.iterations],
               "seconds": [ref_s, tile_s]}
        if kind == "elastic_net":
            l1 = float(np.float32(0.5) * np.float32(lam))
            kkt = kkt_residuals(types.SimpleNamespace(w=got.w[:d]),
                                prob.objective, resident, l1, l1,
                                mask=mask_d.cpu().numpy())
            kkt_ref = kkt_residuals(ref, prob.objective, resident, l1, l1,
                                    mask=mask_d.cpu().numpy())
            zeros = int((got.w[:d] == 0).sum())
            log(f"15a elastic_net KKT (zeros, support, decrement): tiles "
                f"{kkt}, resident {kkt_ref}; {zeros} of {d} coefficients "
                f"zero")
            check(kkt_holds(kkt), f"15a elastic_net: KKT fails {kkt}")
            rec["kkt"] = kkt
        metrics[kind] = rec
    for what, counts in (("resident", res_launches), ("tiles",
                                                      tile_launches)):
        log(f"15a {what} launches: "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
    for op in ("matvec_unit", "rmatvec_unit"):
        check(tile_launches.get(op, 0) > 0, f"15a: {op} never launched "
              "on a tile")
    log("15a: tile (0, 0) against its plain version")
    kern = kernel_vs_plain("tile", M, gen)
    return res_launches, tile_launches, kern, metrics


class TrialLaunches:
    """Per-thread launch counts: ``ops/_kernels.count_launch`` also adds to
    the calling thread's tally while a trial runs, and each trial's tally
    is kept by its (params, resource)."""

    def __init__(self):
        self.tls = threading.local()
        self.trials = []
        self._lock = threading.Lock()

    def count_launch(self, inner):
        def count(key, n=1):
            inner(key, n)
            tally = getattr(self.tls, "tally", None)
            if tally is not None:
                tally[key] = tally.get(key, 0) + n
        return count

    def wrap(self, fit_once):
        def fit(params, resource=0, warm_start=None):
            self.tls.tally = {}
            try:
                return fit_once(params, resource, warm_start)
            finally:
                with self._lock:
                    self.trials.append((float(np.asarray(params)[0]),
                                        int(resource), self.tls.tally))
                self.tls.tally = None
        fit.suite = fit_once.suite
        fit.larger_is_better = fit_once.larger_is_better
        return fit


def journal_decisions(directory):
    from photon_ml_tpu_torch.tuning.state import (
        STATE_RECORD_TYPES,
        TuningJournal,
    )

    return [{k: v for k, v in r.items() if k not in ("wall", "wall_epoch")}
            for r in TuningJournal(directory).read()
            if r.get("type") in STATE_RECORD_TYPES]


def phase_tuning_glm(files, td, train_xy, val_xy):
    """15b: the tuning CLI on phase 4's files (8 trials, 4 workers, GP with
    ASHA), the same search killed at a journal record boundary and resumed,
    a 6-λ grid with 4 workers and with 1 (bitwise per trial), the best
    trial's AUC against a host re-score, and every trial's launches
    against the global count."""
    from photon_ml_tpu_torch.drivers import glm_driver
    from photon_ml_tpu_torch.evaluation.evaluators import (
        AreaUnderROCCurveEvaluator,
    )
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.tuning import __main__ as tune_cli
    from photon_ml_tpu_torch.tuning import state as tune_state
    from photon_ml_tpu_torch.tuning.executor import (
        TuningConfig,
        TuningOrchestrator,
    )
    from photon_ml_tpu_torch.tuning.scheduler import GridProposer, SearchSpace

    train, val = files
    argv = ["--driver", "glm", "--train-data", train, "--validate-data",
            val, "--trials", str(TUNE_TRIALS), "--workers",
            str(TUNE_WORKERS), "--asha", "--proposer", "gp",
            "--n-features", str(N_FEATURES), "--device", DEVICE]
    trials = TrialLaunches()
    inner_make = glm_driver.make_fit_once
    metrics = {}
    launches = {}

    def make(*a, **kw):
        return trials.wrap(inner_make(*a, **kw))

    def cli(out, *extra):
        t = time.perf_counter()
        with patched(glm_driver, "make_fit_once", make):
            rc = tune_cli.main(argv + ["--output-dir", out, *extra])
        torch.cuda.synchronize()
        check(rc == 0, f"15b: the tuning CLI exited {rc}")
        with open(os.path.join(out, "tuning_result.json")) as f:
            return json.load(f), time.perf_counter() - t

    out_a, out_b = (os.path.join(td, f"tune_{k}") for k in "ab")
    with patched(_kernels, "count_launch",
                 trials.count_launch(_kernels.count_launch)):
        _kernels.reset_launches()
        res_a, wall_a = cli(out_a)
        total = dict(_kernels.LAUNCHES)
    per_trial = {}
    for _, _, tally in trials.trials:
        for k, v in tally.items():
            per_trial[k] = per_trial.get(k, 0) + v
    log(f"15b: {res_a['n_trials']} trials ({res_a['completed']} completed, "
        f"{res_a['pruned']} pruned, {res_a['failed']} failed) in "
        f"{wall_a:.2f} s, best λ {res_a['best_params']} AUC "
        f"{res_a['best_metric']!r}; {len(trials.trials)} trial rungs; "
        f"launches {json.dumps({k: v for k, v in total.items() if v})}, "
        f"summed over the trials' threads "
        f"{json.dumps({k: v for k, v in per_trial.items() if v})}")
    check(res_a["n_trials"] == TUNE_TRIALS and res_a["failed"] == 0
          and res_a["pruned"] > 0, f"15b: search {res_a}")
    for params, rung, tally in trials.trials:
        for op in ("matvec_unit", "rmatvec_unit"):
            check(tally.get(op, 0) > 0, f"15b: the trial at λ={params:g}, "
                  f"resource {rung} launched no {op}")
    check({k: v for k, v in total.items() if v}
          == {k: v for k, v in per_trial.items() if v},
          "15b: the trials' launches do not add up to the global count")
    for k, v in total.items():
        launches[k] = launches.get(k, 0) + v

    # The best trial's AUC against a host re-score of its coefficients.
    best = res_a["best_trial"]
    w = tune_state.TrialStore(out_a).load(best)[1].astype(np.float64)
    X_val, y_val = val_xy
    host = AreaUnderROCCurveEvaluator().evaluate(X_val @ w, y_val)
    log(f"15b: best trial {best} AUC {res_a['best_metric']!r}, host "
        f"re-score {host!r}")
    check(abs(host - res_a["best_metric"]) <= 1e-6,
          f"15b: best AUC {res_a['best_metric']!r} vs host {host!r}")

    # Killed at a journal record boundary, then resumed.
    n_records = len(tune_state.TuningJournal(out_a).read())
    cut = n_records // 2

    class Killing(tune_state.TuningJournal):
        def __init__(self, directory, fsync=True, abort_after=None):
            super().__init__(directory, fsync, abort_after=cut)

    _kernels.reset_launches()
    try:
        with patched(tune_state, "TuningJournal", Killing):
            cli(out_b)
        check(False, "15b: the abort hook never fired")
    except tune_state.SearchAborted:
        pass
    res_b, wall_b = cli(out_b, "--resume")
    for k, v in _kernels.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    same = res_b["trials"] == res_a["trials"]
    dec = journal_decisions(out_a) == journal_decisions(out_b)
    log(f"15b: killed at record {cut} of {n_records} and resumed "
        f"({wall_b:.2f} s): trial history "
        + ("equal" if same else "DIFFERS") + ", decisions "
        + ("equal" if dec else "DIFFER"))
    check(same and dec, "15b: the resumed search differs from the "
          "uninterrupted one")

    # A 6-λ grid, warm starts off: every trial's coefficients bitwise equal
    # between 4 workers and 1.
    X_train, y_train = train_xy
    fit_once = glm_driver.make_fit_once(
        X_train, y_train, X_val, y_val, task="logistic", reg_type="l2",
        max_iters=50, device=DEVICE)
    space = SearchSpace.create([(1e-3, 1e3)], log_scale=True,
                               names=["lambda"])
    grid = [[lam] for lam in np.geomspace(1e-2, 1e2, TUNE_GRID)]
    coefs = {}
    _kernels.reset_launches()
    for workers in (TUNE_WORKERS, 1):
        out = os.path.join(td, f"tune_grid_{workers}")
        journal = tune_state.TuningJournal(out)
        t = time.perf_counter()
        res = TuningOrchestrator(
            space, fit_once, GridProposer(space, grid),
            TuningConfig(max_trials=TUNE_GRID, workers=workers,
                         maximize=True, warm_start=False), journal).run()
        journal.close()
        torch.cuda.synchronize()
        store = tune_state.TrialStore(out)
        coefs[workers] = [store.load(i)[1] for i in range(TUNE_GRID)]
        log(f"15b: the {TUNE_GRID}-λ grid over {workers} worker(s) in "
            f"{time.perf_counter() - t:.2f} s, best λ {res.best_params} "
            f"AUC {res.best_metric!r}")
        metrics[f"grid_{workers}_workers_s"] = time.perf_counter() - t
    for k, v in _kernels.LAUNCHES.items():
        launches[k] = launches.get(k, 0) + v
    check(all(np.array_equal(a, b) for a, b in zip(coefs[TUNE_WORKERS],
                                                  coefs[1])),
          f"15b: a grid trial's coefficients differ between "
          f"{TUNE_WORKERS} workers and 1")
    log(f"15b: all {TUNE_GRID} grid trials bitwise equal between "
        f"{TUNE_WORKERS} workers and 1")
    metrics.update(trials=res_a["n_trials"], wall_s=wall_a,
                   resume_wall_s=wall_b, best_auc=res_a["best_metric"],
                   host_auc=host)
    return launches, metrics


def phase_tuning_game(td, game_files):
    """15c: the tuning CLI's selfcheck on the card, then the GAME training
    driver's tuning mode on phase 7's files (Bayesian, 4 evaluations of one
    CD iteration each).  Returns (training launches, validation-scorer
    matvec launches, metrics)."""
    from photon_ml_tpu_torch.drivers import game_training_driver
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.tuning import __main__ as tune_cli

    metrics = {}
    _kernels.reset_launches()
    t = time.perf_counter()
    rc = tune_cli.main(["--selfcheck", "--device", DEVICE])
    torch.cuda.synchronize()
    metrics["selfcheck_s"] = time.perf_counter() - t
    sc = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    log(f"15c: tuning --selfcheck on the card exited {rc} in "
        f"{metrics['selfcheck_s']:.2f} s; launches {json.dumps(sc)}")
    check(rc == 0, "15c: the tuning selfcheck failed on the card")
    for op in ("matvec", "rmatvec"):
        check(sc.get(op, 0) > 0, f"15c: the selfcheck's GAME fits never "
              f"launched {op}")

    train, val = game_files
    cfg_path = os.path.join(td, "tune.json")
    game_driver_config(cfg_path, 1)
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["tuning"] = {"mode": "bayesian", "iterations": GAME_TUNE_EVALS,
                     "range": [1e-2, 1e2]}
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    _kernels.reset_launches()
    t = time.perf_counter()
    with ScorerRecorder() as scorers:
        res = game_training_driver.run([
            "--train-data", train, "--validate-data", val, "--config",
            cfg_path, "--output-dir", os.path.join(td, "tuned"),
            "--device", DEVICE])
        torch.cuda.synchronize()
    metrics["driver_s"] = time.perf_counter() - t
    launches = {op: _kernels.LAUNCHES[op] for op in ("matvec", "rmatvec")}
    val_matvec = scorers.val_matvec
    launches["matvec"] -= val_matvec
    tun = res["tuning"]
    log(f"15c: GAME tuning mode ({GAME_TUNE_EVALS} Bayesian evaluations "
        f"of 1 CD iteration) {metrics['driver_s']:.2f} s: best "
        f"{tun['best_reg_weights']} metric {tun['best_metric']!r}, final "
        f"validation {res['validation_metric']!r}; stages (host s): "
        f"{stage_summary(res['stage_seconds'])}; training launches "
        f"{json.dumps(launches)}, validation scorer matvecs {val_matvec}")
    check(tun["n_evaluations"] == GAME_TUNE_EVALS,
          f"15c: {tun['n_evaluations']} evaluations")
    check(set(tun["best_reg_weights"]) == {"fixed", "per_user"},
          f"15c: tuned {sorted(tun['best_reg_weights'])}")
    check(abs(tun["best_metric"] - res["validation_metric"]) <= 1e-6,
          f"15c: tuned metric {tun['best_metric']!r} vs the final model's "
          f"{res['validation_metric']!r}")
    for op, n in launches.items():
        check(n > 0, f"15c: GAME tuning never launched {op}")
    metrics.update(best=tun, validation=res["validation_metric"])
    return launches, val_matvec, metrics


def phase_tuning(smi, drv_files, drv_runs, drv_td, game_td, game_files,
                 gen):
    """Phase 15: tensor parallel (15a), GLM tuning through the CLI (15b)
    and GAME tuning (15c)."""
    from photon_ml_tpu_torch.data import libsvm

    t_phase = time.perf_counter()
    with patched(libsvm, "read_libsvm", parse_once()):
        train, val = drv_files
        X, y = libsvm.read_libsvm(train, n_features=N_FEATURES,
                                  add_intercept=True)
        X_val, y_val = libsvm.read_libsvm(
            val, n_features=X.shape[1] - 1, add_intercept=True,
            drop_out_of_range=True)
        phase_header("phase 15a: tensor-parallel GLM over logical tiles")
        res_launches, tile_launches, tile_kern, tp_metrics = \
            phase_tensor_parallel(X, y, drv_runs, gen)
        torch.cuda.empty_cache()
        phase_header("phase 15b: GLM tuning through the CLI")
        glm_launches, tune_metrics = phase_tuning_glm(
            drv_files, drv_td, (X, y), (X_val, y_val))
    torch.cuda.empty_cache()
    phase_header("phase 15c: GAME tuning")
    game_launches, game_val, game_metrics = phase_tuning_game(
        game_td, game_files)
    torch.cuda.empty_cache()
    binary = {k: res_launches.get(k, 0) + glm_launches.get(k, 0)
              for k in set(res_launches) | set(glm_launches)}
    metrics = {"tensor_parallel": tp_metrics, "glm": tune_metrics,
               "game": game_metrics,
               "seconds": time.perf_counter() - t_phase}
    log(f"phase 15 [{smi}]: {metrics['seconds']:.1f} s")
    return binary, tile_launches, tile_kern, game_launches, game_val, \
        metrics


# -- phase 16: the ops plane and the fault sites -------------------------


def count_syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its
    result, the synchronizing CUDA calls it made by the Python line that
    made them, as a Counter of "file:line")."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def scrape_until_done(out, done, scrapes, errors):
    """The live plane's client: read the exporter's port from the run's
    log, then GET /metrics every 10 ms until ``done`` is set or the
    exporter stops answering; each parsed scrape is appended to
    ``scrapes``."""
    import urllib.error
    import urllib.request

    from photon_ml_tpu_torch.telemetry import parse_prometheus_text

    port = None
    log_path = os.path.join(out, "photon.log")
    while not done.is_set() and port is None:
        if os.path.exists(log_path):
            with open(log_path) as f:
                m = re.search(r"metrics exporter on http://127\.0\.0\.1:"
                              r"(\d+)", f.read())
            if m:
                port = int(m.group(1))
                break
        time.sleep(0.01)
    while port is not None and not done.is_set():
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                body = r.read().decode()
        except (urllib.error.URLError, ConnectionError, OSError):
            break  # the run closed its exporter
        try:
            scrapes.append((time.perf_counter(),
                            parse_prometheus_text(body)))
        except ValueError as e:
            errors.append(str(e))
        time.sleep(0.01)


def stage_spans(out):
    """Seconds of a driver run's top-level stage spans, from its
    events.jsonl."""
    spans = {}
    with open(os.path.join(out, "events.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") == "span" and rec["name"] in (
                    "run", "read", "summarize", "train", "validate",
                    "write"):
                spans[rec["name"]] = round(rec["dur"], 3)
    return spans


def selfcheck_process(module, args=()):
    """``python -m module --selfcheck`` from the repository root, started
    now (the caller reads it with :func:`selfcheck_result`, and
    :func:`stop_processes` reaps it in the caller's ``finally``)."""
    # photon: disable=process-lifecycle (returned; the caller reaps it)
    return subprocess.Popen(
        [sys.executable, "-m", module, "--selfcheck", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_selfchecks():
    """Phase 16d's two selfchecks, started side by side: (start time, the
    processes by label).  The caller stops any still running when it
    ends."""
    return time.perf_counter(), {
        "chaos selfcheck": selfcheck_process(
            "photon_ml_tpu_torch.chaos", ("--device", DEVICE)),
        "telemetry selfcheck": selfcheck_process(
            "photon_ml_tpu_torch.telemetry"),
    }


def stop_processes(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_group_call(td):
    """Phase 12b's ``experiments.multirank --game`` call, started as a
    process of its own beside phase 8 on (it builds its own draw, and its
    four ranks are mostly host work): (process, output file, the script's
    seconds at its start).  It leads a session of its own, so
    :func:`stop_group_call` stops its spawned ranks with it.  Until it has
    exited, every phase's lines carry BESIDE_MARK (:func:`phase_header`)."""
    out = os.path.join(td, "multirank_12b.log")
    started = time.perf_counter() - T_START
    with open(out, "w") as f:  # the child keeps its own descriptor
        proc = subprocess.Popen(
            [sys.executable, "-m", "photon_ml_tpu_torch.experiments.multirank",
             "--game", "--ranks", str(GROUP_RANKS), "--share-card",
             "--device", DEVICE, "--rows", str(N_ROWS),
             "--game-entities", str(GAME_ENTITIES)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
    BESIDE_GROUP["proc"] = proc
    return proc, out, started


def stop_group_call(call):
    """Stop phase 12b's call and every process of its session."""
    proc = call[0]
    with contextlib.suppress(ProcessLookupError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()
    BESIDE_GROUP["proc"] = None


def group_call_result(call, timeout=600):
    """Phase 12b's result: the call's last output line, once it exits 0."""
    proc, out, _ = call
    try:
        rc = proc.wait(timeout)
    except subprocess.TimeoutExpired:
        rc = None
    with open(out) as f:
        lines = f.read().splitlines()
    check(rc == 0, f"12b: experiments.multirank --game exit {rc}:\n"
          + "\n".join(lines[-40:]))
    return json.loads(lines[-1])


def selfcheck_result(label, proc, t0, timeout=300, phase="16d"):
    """Wait for ``proc`` (killed at ``timeout``), print its scenario and
    gate lines, and check it exited 0; returns (its seconds, its
    output)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        check(False, f"{label}: no exit in {timeout} s")
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith(("chaos scenario ", "telemetry selfcheck pass ",
                            "cluster selfcheck")):
            log(f"phase {phase} {label}: {line}")
    log(f"phase {phase} {label}: exit {proc.returncode} in {wall:.1f} s")
    check(proc.returncode == 0,
          f"{label} failed (exit {proc.returncode}): {err[-2000:]}")
    return wall, out


def phase_ops_plane(smi, drv_files, drv_runs, selfchecks):
    """Phase 16: the ops plane and the fault sites on the card (see the
    module docstring); ``selfchecks`` is :func:`start_selfchecks`' result,
    started beside phase 15.  Returns (the binary kernels' launches of
    16a's driver runs, metrics)."""
    from photon_ml_tpu_torch.drivers import glm_driver
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.telemetry import read_series

    from photon_ml_tpu_torch.data import libsvm

    t_phase = time.perf_counter()
    train, val = drv_files
    ref_out, ref_result = drv_runs["l2"]
    td = os.path.dirname(ref_out)
    total = {}
    runs = {}
    # The process's first synchronize under the debug mode warns once
    # more than later ones do: spend it here, before the compared runs.
    _, first = count_syncs(torch.cuda.synchronize)
    log(f"phase 16a: a synchronize under the debug mode, first in the "
        f"process: {sum(first.values())} warning(s)")
    for label, flags in (
            ("off", ("--telemetry", "off")),
            ("on", ("--metrics-port", "0", "--metrics-interval-s", "0.25"))):
        out = os.path.join(td, f"ops_plane_{label}")
        done = threading.Event()
        scrapes, errors = [], []
        scraper = threading.Thread(
            target=scrape_until_done, args=(out, done, scrapes, errors),
            name="ops-plane-scraper", daemon=True)
        if label == "on":
            scraper.start()
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            # The files as parsed once after phase 4: both runs skip the
            # parse, which makes no synchronizing call.
            with patched(libsvm, "read_libsvm", parse_once()):
                result, syncs = count_syncs(lambda: glm_driver.run([
                    "--train-data", train, "--validate-data", val,
                    "--output-dir", out, "--task", "logistic",
                    *DRIVER_RUNS[0][1], "--reg-weights", "0.1,1,10",
                    "--max-iters", "50", "--n-features", str(N_FEATURES),
                    "--device", DEVICE, *flags]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            done.set()
            if label == "on":
                scraper.join(timeout=30)
        launches = dict(_kernels.LAUNCHES)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        for op in ("matvec_unit", "rmatvec_unit", "sq_rmatvec_unit"):
            check(launches[op] > 0, f"phase 16a {label}: {op} never "
                  "launched")
        check(result["best_lambda"] == ref_result["best_lambda"]
              and result["metrics"] == ref_result["metrics"],
              f"phase 16a {label}: result {result['metrics']} vs phase 4's "
              f"{ref_result['metrics']}")
        runs[label] = dict(out=out, wall_s=wall, syncs=syncs,
                           scrapes=scrapes, errors=errors)
        log(f"phase 16a telemetry {label}: {wall:.2f} s end to end, "
            f"{sum(syncs.values())} synchronizing CUDA calls; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")

    # (a) Telemetry changes nothing: the same files, the same syncs.
    ref_files = _files(ref_out, "model_lambda_")
    ref_files["index_map.json"] = _files(ref_out, "index_map")[
        "index_map.json"]
    check(bool(ref_files), "phase 16a: phase 4's L2 run wrote no model")
    for label in ("on", "off"):
        got = _files(runs[label]["out"], "model_lambda_")
        got["index_map.json"] = _files(runs[label]["out"], "index_map")[
            "index_map.json"]
        check(got == ref_files,
              f"phase 16a {label}: model files differ from phase 4's L2 "
              f"run ({sorted(got)} vs {sorted(ref_files)})")
    on, off = runs["on"], runs["off"]
    check(on["syncs"] == off["syncs"],
          f"phase 16a: {sum(on['syncs'].values())} synchronizing calls "
          f"with telemetry on, {sum(off['syncs'].values())} off; on only "
          f"{dict(on['syncs'] - off['syncs'])}, off only "
          f"{dict(off['syncs'] - on['syncs'])}")
    check(not os.path.exists(os.path.join(off["out"], "events.jsonl")),
          "phase 16a: --telemetry off wrote events.jsonl")
    log(f"phase 16a: stage spans (s) of the run with the plane "
        f"{json.dumps(stage_spans(on['out']))}, of phase 4's L2 run "
        f"{json.dumps(stage_spans(ref_out))}")
    log(f"phase 16a [{smi}]: walls telemetry on {on['wall_s']:.3f} s / off "
        f"{off['wall_s']:.3f} s; synchronizing calls "
        f"{sum(on['syncs'].values())} / {sum(off['syncs'].values())}, at "
        f"the same lines; model files byte-equal to phase 4's L2 run")

    # (b) The live plane scraped mid-run.
    scrapes = on["scrapes"]
    check(not on["errors"], f"phase 16b: unparseable scrapes "
          f"{on['errors'][:2]}")
    iters = [p.get(("solver_iterations", ""), 0.0) for _, p in scrapes]
    check(len(scrapes) >= 2, f"phase 16b: {len(scrapes)} scrapes of "
          "/metrics during the run")
    check(iters == sorted(iters) and iters[-1] > iters[0],
          f"phase 16b: solver_iterations did not rise between scrapes "
          f"({iters[0] if iters else None} → "
          f"{iters[-1] if iters else None})")
    series = read_series(os.path.join(on["out"], "metrics_ts.jsonl"))
    monos = [r["t_mono"] for r in series]
    check(len(series) >= 2 and all(b > a for a, b in zip(monos,
                                                             monos[1:])),
          f"phase 16b: metrics_ts.jsonl {len(series)} records, t_mono "
          f"{monos[:4]}")
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("telemetry-")]
    check(not alive, f"phase 16b: threads outlived the run: {alive}")
    log(f"phase 16b [{smi}]: {len(scrapes)} scrapes of /metrics during "
        f"the run, solver_iterations {iters[0]:g} → {iters[-1]:g}; "
        f"{len(series)} time-series records; exporter joined")

    # (c) 9c's counters, then (d) the selfchecks' results.
    t0, procs = selfchecks
    try:
        stream_out = os.path.join(td, "stream_l2")
        with open(os.path.join(stream_out, "metrics.json")) as f:
            counters = json.load(f)["counters"]
        with open(os.path.join(stream_out, "training_result.json")) as f:
            transfer = json.load(f)["streaming"]["transfer"]
        check(counters.get("h2d_bytes_total") == transfer["bytes"]
              and counters.get("h2d_chunks_total") == transfer["chunks"],
              f"phase 16c: metrics.json h2d "
              f"{counters.get('h2d_bytes_total')} B / "
              f"{counters.get('h2d_chunks_total')} chunks vs the run's "
              f"transfer statistics {transfer['bytes']} B / "
              f"{transfer['chunks']} chunks")
        log(f"phase 16c: 9c's streamed L2 run: h2d_bytes_total "
            f"{counters['h2d_bytes_total']}, h2d_chunks_total "
            f"{counters['h2d_chunks_total']} = its transfer statistics")
        walls = {label: selfcheck_result(label, proc, t0)[0]
                 for label, proc in procs.items()}
    finally:
        stop_processes(procs.values())
    metrics = {"wall_on_s": on["wall_s"], "wall_off_s": off["wall_s"],
               "syncs": sum(on["syncs"].values()),
               "scrapes": len(scrapes),
               "chaos_selfcheck_s": walls["chaos selfcheck"],
               "telemetry_selfcheck_s": walls["telemetry selfcheck"],
               "seconds": time.perf_counter() - t_phase}
    log(f"phase 16 [{smi}]: {metrics['seconds']:.1f} s")
    return total, metrics


# -- phase 17: the cluster control plane ----------------------------------

CLUSTER_RATE_RPS = 240.0
CLUSTER_SCORED = 4096
CLUSTER_HEARTBEAT_TTL_S = 2.0


def file_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, names in os.walk(root) for f in names)


def phase_cluster(smi, td, handoff):
    """Phase 17: the cluster control plane on the card (17a the drill's
    selfcheck as a subprocess, 17b phase 7's model cold-started over HTTP
    behind a membership-driven router, see the module docstring).
    ``handoff`` is phase 13's model, index maps and requests, with phase
    14c's delta.  Returns (phase 7's model's serve_margins launches,
    metrics)."""
    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.analysis.sanitizers import (
        ProcessLeakSentinel,
        ThreadLeakSentinel,
    )
    from photon_ml_tpu_torch.cluster import (
        HeartbeatAgent,
        MembershipRegistry,
        MembershipWatcher,
        PublicationClient,
        PublicationServer,
        RegistryClient,
        RemoteApplier,
        cold_start,
    )
    from photon_ml_tpu_torch.freshness.delta import apply_delta
    from photon_ml_tpu_torch.freshness.publisher import DeltaPublisher
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.serving import loadgen
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.fleet import FleetRouter, LocalHost
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.service import ScoringService
    from photon_ml_tpu_torch.serving.tenancy import TenancyConfig, TenantSpec
    from photon_ml_tpu_torch.telemetry.fleet import FleetAggregator

    def clog(msg):
        log_phase(f"cluster [{smi}] {msg}")

    t_phase = time.perf_counter()
    metrics = {}

    # -- 17a: the drill's selfcheck, alone (its gates are timed) ----------
    with ProcessLeakSentinel(grace_s=30.0, strict=True):
        t0 = time.perf_counter()
        proc = selfcheck_process("photon_ml_tpu_torch.cluster",
                                 ("--device", DEVICE))
        try:
            wall, out = selfcheck_result("cluster selfcheck", proc, t0,
                                         phase="17a")
        finally:
            stop_processes([proc])
    gates = next(json.loads(line.split(": ", 1)[1])
                 for line in out.splitlines()
                 if line.startswith("cluster selfcheck gates: "))
    check(gates["cold_host_bitwise"] and gates["new_leader"]
          != gates["old_leader"], f"17a: gates {gates}")
    metrics["selfcheck"] = dict(gates, seconds=wall)
    clog(f"17a: failover {gates['old_leader']} -> {gates['new_leader']} in "
         f"{gates['failover_s']:.3f} s (bound {gates['failover_bound_s']:g} "
         f"s) at {gates['rate_rps']:g} requests/s; admitted against the "
         f"bound by phase {json.dumps(gates['admitted_vs_bound'])}; cold "
         f"host bitwise; {wall:.1f} s")

    # -- 17b: phase 7's model cold-started over HTTP ----------------------
    model, imaps, delta = handoff["model"], handoff["imaps"], handoff["delta"]
    reqs = handoff["cluster_requests"]
    cfg = RuntimeConfig(max_batch_size=SERVE_MAX_BATCH,
                        hot_entities=SERVE_HOT, device=DEVICE)
    bcfg = BatcherConfig(
        max_batch_size=SERVE_MAX_BATCH, max_wait_us=1000, max_queue=1024,
        tenancy=TenancyConfig(tenants=(TenantSpec(name="acme",
                                                  max_queue=1024),)))

    def routed_scores(submit, chunk=256):
        out = []
        for lo in range(0, len(reqs), chunk):
            futs = [submit(dict(r, tenant="acme"))
                    for r in reqs[lo:lo + chunk]]
            out.extend(np.float32(f.result(timeout=120)["score"])
                       for f in futs)
        return np.asarray(out, np.float32)

    with telemetry.Telemetry(sinks=[]) as hub, \
            ThreadLeakSentinel(grace_s=10.0, strict=True):
        t0 = time.perf_counter()
        root = os.path.join(td, "cluster_publications")
        with DeltaPublisher(root) as publisher:
            snap = publisher.publish_snapshot(os.path.join(td, "full",
                                                           "models"))
            delta_pub = publisher.publish(delta)
        publish_s = time.perf_counter() - t0
        pub_server = PublicationServer(root).serve()
        registry = MembershipRegistry(
            heartbeat_ttl_s=CLUSTER_HEARTBEAT_TTL_S).serve()
        reg_client = RegistryClient(registry.base_url)
        started = []  # everything with a stop(), stopped in reverse
        try:
            # The cold host: an empty cache, the snapshot over HTTP (every
            # file's sha256 checked), then the delta through the applier.
            t0 = time.perf_counter()
            client = PublicationClient(pub_server.base_url,
                                       os.path.join(td, "cold_cache"))
            local, got_snap = cold_start(client, subscriber_id="cold")
            fetch_s = time.perf_counter() - t0
            fetched = file_bytes(os.path.dirname(local))
            cold_svc = ScoringService(ScoringRuntime.load(local, cfg), bcfg)
            cold = LocalHost("cold", cold_svc).start()
            started.append(cold)
            applier = RemoteApplier(cold_svc, client, "cold",
                                    start_seq=got_snap.seq)
            applied = applier.poll_once()
            cold_start_s = time.perf_counter() - t0
            check(got_snap.seq == snap.seq and [r.status for r in applied]
                  == ["swapped"] and applier.applied_seq == delta_pub.seq,
                  f"17b: cold start at seq {got_snap.seq}, applied "
                  f"{[r.status for r in applied]} up to "
                  f"{applier.applied_seq}")
            clog(f"17b: cold start fetched {fetched} bytes over HTTP in "
                 f"{fetch_s:.3f} s ({fetched / fetch_s / 1e6:.1f} MB/s, "
                 f"sha256 checked), loaded and applied the delta (seq "
                 f"{delta_pub.seq}) in {cold_start_s:.2f} s; published in "
                 f"{publish_s:.2f} s")

            # The warm host serves the patched model; the watcher routes
            # the registry's members.
            patched = apply_delta(model, delta)
            warm = LocalHost("warm", ScoringService(
                ScoringRuntime(patched, imaps, cfg), bcfg)).start()
            started.append(warm)
            router = FleetRouter([warm.base_url],
                                 probe_interval_s=0.1).start()
            started.append(router)
            reg_client.register("warm", warm.base_url)
            warm_agent = HeartbeatAgent(
                reg_client, "warm", warm.base_url,
                heartbeat_ttl_s=CLUSTER_HEARTBEAT_TTL_S).start()
            started.append(warm_agent)
            aggregator = FleetAggregator(
                {"warm": warm.base_url},
                fetch=lambda url, timeout_s: {
                    "transport": hub.metrics.transport_snapshot()},
                stale_drop_s=10.0)
            watcher = MembershipWatcher(reg_client, router,
                                        aggregator=aggregator,
                                        interval_s=0.1).start()
            started.append(watcher)
            cold_agent = HeartbeatAgent(
                reg_client, "cold", cold.base_url,
                heartbeat_ttl_s=CLUSTER_HEARTBEAT_TTL_S)
            started.append(cold_agent)
            runtimes = {"warm": warm.service.current_runtime,
                        "cold": cold_svc.current_runtime}
            # Each host's launches: its runtime's calls of the kernel's
            # wrapper (both runtimes were built and warmed before the
            # window, so every launch in it scores a batch).
            per_host = dict.fromkeys(runtimes, 0)
            for label, rt in runtimes.items():
                def counted(*a, _launch=rt._launch, _label=label, **k):
                    per_host[_label] += 1
                    return _launch(*a, **k)
                rt._launch = counted
            with contextlib.ExitStack() as held:
                for rt in runtimes.values():
                    held.enter_context(rt.score_lock)
                torch.cuda.synchronize()
                _kernels.reset_launches()
                b0 = {k: rt.batches for k, rt in runtimes.items()}

            # The join and the drain under phase 13's requests.
            t0 = time.perf_counter()
            report = loadgen.run_fleet_scenario(
                router.submit,
                lambda i, phase, tenant: dict(reqs[i % len(reqs)],
                                              tenant=tenant),
                loadgen.SCENARIOS["host_join_drain"], tenant="acme",
                base_rate_rps=CLUSTER_RATE_RPS,
                actions={"join_host": lambda: bool(cold_agent.start()),
                         "drain_host": lambda: reg_client.drain("warm")},
                seed=17)
            scenario_s = time.perf_counter() - t0
            snap_r = report.snapshot()
            check(report.failed == 0 and report.shed == 0
                  and report.completed > 0
                  and report.actions == {"join_host": True,
                                         "drain_host": True},
                  f"17b: host_join_drain {snap_r} {report.actions}")
            deadline = time.perf_counter() + 10.0
            while time.perf_counter() < deadline:
                states = {h["url"]: h["state"]
                          for h in router.healthz()["hosts"]}
                if (states.get(cold.base_url) == "healthy"
                        and states.get(warm.base_url) == "removed"):
                    break
                time.sleep(0.05)
            check(states.get(cold.base_url) == "healthy"
                  and states.get(warm.base_url) == "removed",
                  f"17b: router hosts {router.healthz()['hosts']}")
            by_phase = {name: report.phase(name).completed
                        for name, *_ in report.phases}
            clog(f"17b: host_join_drain at {CLUSTER_RATE_RPS:g} requests/s "
                 f"in {scenario_s:.2f} s: {report.completed} completed "
                 f"({json.dumps(by_phase)}), {report.failed} failed, "
                 f"{report.shed} rejected; the cold host joined and the "
                 f"warm host drained through the registry")

            # After the drain: the router's scores against a fresh runtime
            # on the patched model.
            t0 = time.perf_counter()
            served = routed_scores(router.submit)
            routed_s = time.perf_counter() - t0
            with contextlib.ExitStack() as held:
                for rt in runtimes.values():
                    held.enter_context(rt.score_lock)
                launches = _kernels.LAUNCHES["serve_margins"]
                batches = {k: rt.batches - b0[k]
                           for k, rt in runtimes.items()}
                counted_launches = dict(per_host)
            check(launches == sum(counted_launches.values())
                  and all(counted_launches[k] == batches[k] > 0
                          for k in runtimes),
                  f"17b: {launches} serve_margins launches; by host "
                  f"{counted_launches} for batches {batches}")

            # The aggregator follows membership: the drained host leaves.
            warm_agent.stop(leave=True)
            deadline = time.perf_counter() + 5.0
            departed = False
            while not departed and time.perf_counter() < deadline:
                aggregator.poll_once()
                h = aggregator.slo_report()["hosts"].get("warm")
                departed = h is None or bool(h.get("departed"))
                time.sleep(0.05)
            check(departed, "17b: the aggregator never marked the drained "
                  "host departed")
        finally:
            for obj in reversed(started):
                obj.stop()
            registry.close()
            pub_server.close()
    rt = ScoringRuntime(patched, imaps, cfg)
    fresh = np.concatenate([rt.score_rows(
        [rt.parse_request(r) for r in reqs[lo:lo + SERVE_MAX_BATCH]])[0]
        for lo in range(0, len(reqs), SERVE_MAX_BATCH)])
    check(served.tobytes() == fresh.tobytes(), "17b: routed scores after "
          "the drain differ from a fresh runtime's on the patched model")
    clog(f"17b: {len(reqs)} requests through the router after the drain in "
         f"{routed_s:.2f} s, bitwise a fresh runtime's on the patched "
         f"model; serve_margins launches {launches} = batches by host "
         f"{batches}; the aggregator marked the drained host departed")
    metrics["cold_start"] = {"fetch_bytes": fetched, "fetch_s": fetch_s,
                             "fetch_mb_per_s": fetched / fetch_s / 1e6,
                             "cold_start_s": cold_start_s,
                             "publish_s": publish_s}
    metrics["join_drain"] = {k: snap_r[k] for k in (
        "completed", "failed", "shed")} | {"rate_rps": CLUSTER_RATE_RPS,
                                            "by_phase": by_phase,
                                            "launches": launches,
                                            "batches": batches}
    metrics["seconds"] = time.perf_counter() - t_phase
    clog(f"phase 17: {metrics['seconds']:.1f} s")
    return launches, metrics


# -- phase 18: the static invariant checker and the metric lint -----------


def phase_static_checks():
    """Phase 18: the port's invariant checker and metric lint over this
    checkout (see the module docstring).  Returns its counts and seconds."""
    from photon_ml_tpu_torch import analysis
    from photon_ml_tpu_torch.telemetry import lint

    t_phase = time.perf_counter()
    report = analysis.check()
    n_names, problems = lint.lint_source()
    seconds = time.perf_counter() - t_phase
    for line in (*report.parse_errors, *map(str, report.findings),
                 *(f"stale baseline entry: {e}"
                   for e in report.stale_baseline),
                 *(f"metric lint: {p}" for p in problems)):
        log(f"phase 18: {line}")
    metrics = {"files": report.files, "rules": report.rules,
               "findings": len(report.findings),
               "parse_errors": len(report.parse_errors),
               "suppressed": report.suppressed,
               "baselined": report.baselined,
               "stale_baseline": len(report.stale_baseline),
               "metric_names": n_names, "metric_problems": len(problems),
               "seconds": seconds}
    log(f"phase 18: the invariant checker over {report.files} files and "
        f"{report.rules} rules: {len(report.findings)} findings, "
        f"{len(report.parse_errors)} parse errors, {report.suppressed} "
        f"suppressed, {report.baselined} baselined, "
        f"{len(report.stale_baseline)} stale baseline entries; the metric "
        f"lint: {n_names} names, {len(problems)} problems; {seconds:.2f} s")
    check(report.ok, "18: the invariant checker has findings or parse "
          "errors")
    check(not report.stale_baseline, "18: stale baseline entries")
    check(not problems, "18: the metric lint failed")
    return metrics


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card only", file=sys.stderr)
        return 2
    global T_START
    t_start = T_START = time.perf_counter()
    smi = phase_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    td = tempfile.mkdtemp(prefix="photon_game_drivers_")
    writer = start_game_files(td)
    try:
        return _main_from_phase2(smi, t_start, td, writer)
    finally:
        if writer.is_alive():
            writer.terminate()
        writer.join()
        shutil.rmtree(td, ignore_errors=True)


def _main_from_phase2(smi, t_start, td, writer):
    bench = bench_triples()
    phase_header("phase 2: kernel against plain version")
    kern = phase_kernels(bench)
    phase_header("phase 3: library boundary")
    lib_launches, lib_metrics, (data, plain_data, abs_F, X) = \
        phase_library(bench)
    phase_header("phase 3b: solvers")
    sol_launches, sol_records, sol_ws = phase_solvers(
        data, plain_data, abs_F, bench[4], kern)
    del plain_data
    torch.cuda.empty_cache()
    phase_header("phase 9a-9b: out-of-core objective and solvers (run here, on "
              "phase 3's matrix)")
    stream_launches, stream_metrics = phase_streaming(
        smi, bench, data, abs_F, X, lib_metrics)
    phase_header("phase 11a: consensus ADMM over logical shards (run here, on "
              "phase 3's matrix)")
    shard_launches, shard_kern, admm_metrics = phase_admm(
        X, bench[3], bench[4], sol_records, sol_ws,
        torch.Generator(device=DEVICE).manual_seed(11))
    torch.cuda.empty_cache()
    phase_header("phase 11c: a one-rank process group (run here, on phase 3's "
              "matrix)")
    grp_launches, grp_metrics = phase_group_grid(
        data, X, bench[3], os.path.join(td, "pg_store_grid"))
    # The valued kernels' main-path launches: phases 3, 3b, 9a, 9b and
    # 11c's group runs.
    val_launches = {op: lib_launches[op] + sol_launches[op]
                    + stream_launches[op] + grp_launches[op] for op in OPS}
    multi = dict(admm=admm_metrics, group=grp_metrics,
                 shard_launches=shard_launches, shard_kern=shard_kern)
    del bench, data, abs_F, X
    torch.cuda.empty_cache()
    drv_td = tempfile.mkdtemp(prefix="photon_glm_driver_")
    try:
        return _main_from_phase4(smi, t_start, kern, lib_metrics,
                                 sol_records, stream_metrics, val_launches,
                                 drv_td, td, writer, multi)
    finally:
        shutil.rmtree(drv_td, ignore_errors=True)


def _main_from_phase4(*args):
    """The phases from 4 on, with ``read_libsvm`` put back at the end (the
    driver runs from phase 4 on read its files through :func:`parse_once`)."""
    from photon_ml_tpu_torch.data import libsvm

    original = libsvm.read_libsvm
    try:
        return _phases_from_4(*args)
    finally:
        libsvm.read_libsvm = original


def _phases_from_4(smi, t_start, kern, lib_metrics, sol_records,
                   stream_metrics, val_launches, drv_td, td, writer, multi):
    from photon_ml_tpu_torch.data import libsvm

    # Every driver run on phase 4's files after its first (phase 4's
    # other two, 11b, 11c, 9c, 12a, 15, 16) reads them as that run parsed
    # them: the parse is the first run's check, not theirs.
    libsvm.read_libsvm = parse_once()
    phase_header("phase 4: driver")
    drv_launches, drv_files, drv_runs = phase_driver(drv_td)
    torch.cuda.empty_cache()
    phase_header("phase 11b: block coordinate descent (run here, on phase 4's "
              "files)")
    bcd_launches, multi["block_cd"] = phase_block_cd(drv_files, drv_td)
    torch.cuda.empty_cache()
    phase_header("phase 11c: the driver under a one-rank process group")
    gd_launches = phase_group_driver(drv_files, drv_runs, drv_td,
                                     os.path.join(td, "pg_store_driver"))
    for extra in (bcd_launches, gd_launches):
        for k, n in extra.items():
            drv_launches[k] = drv_launches.get(k, 0) + n
    torch.cuda.empty_cache()
    phase_header("phase 5: experiments")
    exp, abl_launches = phase_experiments()
    torch.cuda.empty_cache()
    phase_header("phase 6: GAME coordinate descent")
    kern_game, game_launches, game_metrics = phase_game(smi)
    torch.cuda.empty_cache()
    phase_header("phase 7: GAME drivers")
    kern_val, drv_train, drv_val, drv_metrics, (train, val) = \
        phase_game_drivers(smi, td, writer)
    torch.cuda.empty_cache()
    # Phase 12b's process group runs beside phase 8 on, until it exits.
    group_call = start_group_call(td)
    try:
        phase_header("phase 8: GAME fallback and factored random effects")
        fb_train, fb_val, fb_metrics = phase_game_fallback(smi, td, train, val)
        torch.cuda.empty_cache()
        phase_header("phase 9c: the drivers' streamed route, initial models, "
                  "reports and retries")
        sd_launches, sd_game, sd_metrics = phase_stream_drivers(
            smi, drv_files, drv_runs, td, (train, val))
        stream_metrics["drivers"] = sd_metrics
        torch.cuda.empty_cache()
        phase_header("phase 10: GAME out of core")
        ooc_launches, ooc_val, ooc_metrics = phase_game_ooc(
            smi, td, (train, val),
            game_metrics["game_multi_re"]["iters_per_s"])
        torch.cuda.empty_cache()
        phase_header("phase 12: GAME and the streamed mesh over a process group")
        kern_group, grp_game, multi["game_group"] = phase_group_game(
            smi, td, group_call)
        for op in ("matvec", "rmatvec"):
            ooc_launches[op] += grp_game["game"][op]
        for k, n in grp_game["unit"].items():
            sd_launches[k] = sd_launches.get(k, 0) + n
    finally:
        stop_group_call(group_call)
    torch.cuda.empty_cache()
    phase_header("phase 13: online serving of phase 7's model")
    serve_records, _, serve_metrics, handoff = phase_serving(smi, td)
    torch.cuda.empty_cache()
    phase_header("phase 14: the process and fleet tier and model freshness")
    proc_launches, proc_metrics = phase_process_fleet(smi, td, handoff)
    torch.cuda.empty_cache()
    # Phase 16d's selfchecks are processes of their own: they run beside
    # phase 15 (each is mostly its interpreter's start and imports).
    phase_header("phase 16d: the chaos and telemetry selfchecks start, beside "
              "phase 15")
    selfchecks = start_selfchecks()
    try:
        phase_header("phase 15: tensor parallel and tuning")
        (tp_binary, tile_launches, tile_kern, tune_game, tune_game_val,
         tune_metrics) = phase_tuning(
            smi, drv_files, drv_runs, drv_td, td, (train, val),
            torch.Generator(device=DEVICE).manual_seed(15))
        for k, n in tp_binary.items():
            drv_launches[k] = drv_launches.get(k, 0) + n
        torch.cuda.empty_cache()
        phase_header("phase 16: the ops plane and the fault sites on the card")
        ops_launches, ops_metrics = phase_ops_plane(smi, drv_files, drv_runs,
                                                    selfchecks)
    finally:
        stop_processes(selfchecks[1].values())
    torch.cuda.empty_cache()
    # Alone: 17a's selfcheck gates on timing.
    phase_header("phase 17: the cluster control plane")
    cluster_launches, cluster_metrics = phase_cluster(smi, td, handoff)
    del handoff
    phase_header("phase 18: the static invariant checker and the metric lint")
    static_metrics = phase_static_checks()
    for k, n in ops_launches.items():
        drv_launches[k] = drv_launches.get(k, 0) + n
    # The serving records count phase 13's and phase 14's launches of
    # their geometry (phase 14's workers' folded in), and phase 7's model's
    # phase 17b's.
    for r in serve_records:
        if ".bench_serving." in r["name"]:
            r["launches"] += proc_launches["bench_serving's model"]
        else:
            r["launches"] += (proc_launches["phase 7's model"]
                              + cluster_launches)
    # The binary records count phase 4's, 11b's, 11c's, 9c's and 16a's GLM
    # driver launches.
    drv_launches = {k: drv_launches.get(k, 0) + sd_launches.get(k, 0)
                    for k in set(drv_launches) | set(sd_launches)}
    # The .game records count phase 6's, 7's, 8's, 9c's and 10's training
    # launches; .game_val phase 7's, 8's and 10e's validation scoring.
    game_launches = {op: game_launches[op] + drv_train[op] + fb_train[op]
                     + sd_game[op] + ooc_launches[op] + tune_game[op]
                     for op in ("matvec", "rmatvec")}
    drv_val += fb_val + ooc_val + tune_game_val

    log("not on the main path (no caller in the GLM slice), checked in "
        "phase 2: " + json.dumps({
            f"{v}.row_sq_matvec": kern[v]["row_sq_matvec"]
            for v in ("valued", "binary")} | {
            f"game.{op}": kern_game[op] for op in ("row_sq_matvec",
                                                   "sq_rmatvec")} | {
            f"game_val.{op}": kern_val[op] for op in ("rmatvec",
                                                      "row_sq_matvec",
                                                      "sq_rmatvec")}))
    # The skewed matrix runs the valued instances: its records carry the
    # valued main path's launches of the same operation.
    records = []
    for variant, suffix, launches in (("valued", "", val_launches),
                                      ("binary", "_unit", drv_launches),
                                      ("skewed", "", val_launches)):
        for op in ("matvec", "rmatvec", "sq_rmatvec"):
            r = kern[variant][op]
            name = f"spmv.{op}{suffix}"
            records.append({
                "name": name + (".skewed" if variant == "skewed" else ""),
                "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
                "launches": launches[op + suffix],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
    # The GAME fixed effect's shape (640,155 x 512, 8 values a row): the
    # valued instances, with phase 6's main-path launches.
    for op in ("matvec", "rmatvec"):
        r = kern_game[op]
        records.append({
            "name": f"spmv.{op}.game", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": game_launches[op],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    # A logical shard of phase 3's matrix (2^18 x 8192): phase 11a's ADMM
    # x-updates and ridge Gram matrices.
    for op in ("matvec", "rmatvec"):
        r = multi["shard_kern"][op]
        records.append({
            "name": f"spmv.{op}.shard", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": multi["shard_launches"][op],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    # Phase 12b's shards: a rank's row block of the GAME fixed effect
    # (161,564 x 512, 8 values a row) and a part of the 4-way sharded
    # streamed store (2^16 x 8192, 32 a row), with the group's launches
    # (every rank's, on the one card).
    for inst in ("game_shard", "chunk_shard"):
        for op in ("matvec", "rmatvec"):
            r = kern_group[inst][op]
            records.append({
                "name": f"spmv.{op}.{inst}", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
                "launches": grp_game[inst][op],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            })
    # Phase 15a's tiles (2^16 x 4097 of phase 4's binary matrix), with the
    # tiled solves' launches.
    for op in ("matvec", "rmatvec"):
        r = tile_kern[op]
        records.append({
            "name": f"spmv.{op}_unit.tile", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
            "launches": tile_launches[op + "_unit"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    # The validation matrix's shape (80,000 x 512, 8 values a row): the
    # fixed-effect validation scorer's matvec in phase 7's training runs.
    r = kern_val["matvec"]
    records.append({
        "name": "spmv.matvec.game_val", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_KERNEL,
        "launches": drv_val,
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    })
    fields = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms")
    for name, key, source, replaces in (
            ("ell_matvec", "ell", ELL_SOURCE, TPU_ELL),
            ("ell_matvec.chain_graph", "chain", ELL_SOURCE, TPU_ELL_CHAIN),
            ("window_matvec", "window", WINDOW_SOURCE, TPU_WINDOW)):
        records.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        **{f: exp[key][f] for f in fields}})
    for (mode, op), r in kern["ablate"].items():
        records.append({"name": f"spmv_ablate.{mode}.{op}", "route": "cuda",
                        "source": KERNEL_SOURCE, "replaces": TPU_ABLATE,
                        "launches": abl_launches[f"spmv_ablate_{mode}_{op}"],
                        **{f: r[f] for f in fields[1:]}})
    records.extend(serve_records)
    log(f"metrics: {json.dumps(lib_metrics)}; solvers: "
        f"{json.dumps({k: r['wall_s'] for k, r in sol_records.items()})}; "
        f"GAME: {json.dumps(game_metrics)}; GAME drivers: "
        f"{json.dumps(drv_metrics)}; GAME fallback and factored: "
        f"{json.dumps(fb_metrics)}; out-of-core: "
        f"{json.dumps(stream_metrics)}; GAME out of core: "
        f"{json.dumps(ooc_metrics, default=float)}; multi-device: "
        f"{json.dumps({k: multi[k] for k in MULTI_KEYS}, default=float)}"
        f"; serving: {json.dumps(serve_metrics, default=float)}"
        f"; process tier: {json.dumps(proc_metrics, default=float)}"
        f"; tensor parallel and tuning: "
        f"{json.dumps(tune_metrics, default=float)}"
        f"; ops plane: {json.dumps(ops_metrics, default=float)}"
        f"; cluster: {json.dumps(cluster_metrics, default=float)}"
        f"; static checks: {json.dumps(static_metrics)}"
        f"; total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
