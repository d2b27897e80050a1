"""Legacy GLM training driver (port of ``photon_ml_tpu/drivers/glm_driver.py``).

The end-to-end single-GLM pipeline of the reference's ``Driver``, as five
stages with artifacts written to the output directory:

    read → summarize + normalize → train the λ grid (warm-started) →
    validate + select → write model(s), index map, training_result.json

Ingest and evaluation run on the host; the data, the objective and the
solver run on ``--device`` (CUDA by default), where sparse features go
through the hand-written CUDA SpMV kernel.

The flags cover the four losses with L1, L2 and elastic-net regularization,
the solvers of the registry with ``--optimizer``/``--solver``: the
resident L-BFGS, OWL-QN, TRON and SPG, and the host-kind consensus-ADMM
and block coordinate descent (``--solver admm|block_cd``, with their
knobs in ``--solver-option KEY=VALUE`` and ``--solver-shards``: they run
over logical row shards on one card, or over the process group under
``--data-parallel auto``), box constraints (``--coefficient-bounds``),
λ-grid checkpoint/resume (``--resume``), warm starts from a saved model
(``--initial-model``), automatic retries of transient failures from the
checkpoint (``--max-retries``, ``--retry-backoff``; ``utils/watchdog.py``),
the diagnostics report (``--training-report``), and out-of-core training
(``--stream-chunk-rows`` and the other ``--stream-*`` flags): the training
rows stay on the host as a chunk store (``data/streaming.py``) and every
objective evaluation streams them through the card
(``optim/streaming.py``), with validation scored on the host.

``--data-parallel auto`` trains over a ``torch.distributed`` process group
(``parallel/``) when one with more than one rank forms: the group comes up
from ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID`` (or
``PHOTON_MULTIHOST=1`` under ``torchrun``), each rank keeps its
``host_local_rows`` block of the training rows on its card, every
objective evaluation is one all-reduce, and rank 0 writes the outputs.
With ``--stream-chunk-rows`` each rank streams its shard of every chunk
(one all-reduce a pass; ``--stream-chunk-fuse > 1`` and
``--stream-hot-budget-mb`` are refused, as the reference refuses them).
With one rank the flag changes nothing, as in the reference, which forms
a mesh only over more than one device.

``--telemetry on`` (the default) writes ``events.jsonl``, ``trace.json``
and ``metrics.json`` into the output directory: a ``run`` span over the
stages' spans (read, summarize, train with a ``solver`` span a λ,
validate, write), checkpoint and grid events, and the solvers' and the
streamed passes' counters, all from host values.  ``--metrics-port``
serves the live ops plane (``/metrics``, ``/snapshot``, ``/healthz``)
while the run is in flight and ``--metrics-interval-s`` paces the
``metrics_ts.jsonl`` sampler.  Under a process group rank 0 writes them;
the other ranks keep their hub in memory.  ``--telemetry off`` leaves
every instrumented site one branch and writes the same model files.

Multi-rank usage (one process a card):
    PHOTON_MULTIHOST=1 torchrun --nproc-per-node 4 \\
        -m photon_ml_tpu_torch.drivers.glm_driver --data-parallel auto ...

Usage:
    python -m photon_ml_tpu_torch.drivers.glm_driver \\
        --train-data a1a --task logistic --reg-type l2 \\
        --reg-weights 0.1,1,10 --output-dir /tmp/out --device cuda
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.data import libsvm
from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.data.normalization import (
    NormalizationType,
    build_normalization,
)
from photon_ml_tpu_torch.data.stats import summarize, summarize_host
from photon_ml_tpu_torch.drivers.ops_plane import (
    add_telemetry_args,
    driver_telemetry,
)
from photon_ml_tpu_torch.device import resolve_device, to_numpy
from photon_ml_tpu_torch.evaluation.evaluators import (
    default_evaluator_for_task,
    get_evaluator,
)
from photon_ml_tpu_torch.io.checkpoint import GridCheckpointer
from photon_ml_tpu_torch.io.model_store import load_glm_model, save_glm_model
from photon_ml_tpu_torch.io.summary_store import save_feature_summary
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    GlmOptimizationProblem,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_tpu_torch.optim.regularization import (
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.utils.logging import PhotonLogger
from photon_ml_tpu_torch.utils.timer import Timer
from photon_ml_tpu_torch.utils.tracker import OptimizationStatesTracker
from photon_ml_tpu_torch.utils.watchdog import (
    RetryPolicy,
    RetryStats,
    run_with_retries,
)


def build_arg_parser() -> argparse.ArgumentParser:
    """The reference Driver's ``Params``, restricted to this slice."""
    p = argparse.ArgumentParser(
        prog="glm_driver", description="PyTorch/CUDA GLM training driver"
    )
    p.add_argument("--train-data", required=True, help="LIBSVM training file")
    p.add_argument("--validate-data", help="LIBSVM validation file (optional)")
    p.add_argument("--output-dir", required=True)
    p.add_argument(
        "--task",
        default="logistic",
        help="logistic | linear | poisson | smoothed_hinge (or reference "
        "TaskType names like LOGISTIC_REGRESSION)",
    )
    p.add_argument(
        "--optimizer", default="lbfgs", choices=[t.value for t in OptimizerType]
    )
    p.add_argument(
        "--solver",
        help="registered solver name (photon_ml_tpu_torch/solvers): lbfgs | "
        "owlqn | tron | spg | admm | block_cd.  Unset keeps the historical "
        "routing (bounds → spg, any L1 → owlqn, else --optimizer).  "
        "Host-kind solvers (admm, block_cd) run sharded: over the "
        "--data-parallel process group when one forms, else over "
        "--solver-shards logical shards on one card",
    )
    p.add_argument(
        "--solver-shards",
        type=int,
        default=0,
        help="logical shard count for host-kind solvers without a process "
        "group (0 = auto: 2, or the solver_options 'shards' knob)",
    )
    p.add_argument(
        "--solver-option",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="solver-specific knob (repeatable), e.g. --solver-option "
        "rho=1.0 --solver-option n_blocks=8",
    )
    p.add_argument(
        "--reg-type",
        default="none",
        choices=[t.value for t in RegularizationType],
    )
    p.add_argument("--reg-weights", default="0.0", help="comma-separated λ grid")
    p.add_argument("--elastic-net-alpha", type=float, default=0.5)
    p.add_argument(
        "--normalization",
        default="none",
        choices=[t.value for t in NormalizationType],
    )
    p.add_argument("--max-iters", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument(
        "--coefficient-bounds",
        help="JSON file mapping feature key -> [lower, upper] box "
        "constraints (the reference's constraint map); unlisted features "
        "are unconstrained",
    )
    p.add_argument("--intercept", action="store_true", default=True)
    p.add_argument("--no-intercept", dest="intercept", action="store_false")
    p.add_argument("--compute-variances", action="store_true")
    p.add_argument("--evaluator", help="AUC | RMSE | ... (default: per task)")
    p.add_argument(
        "--output-mode",
        default="best",
        choices=["best", "all"],
        help="write only the selected model or every grid point",
    )
    p.add_argument("--n-features", type=int, help="fixed feature-space width")
    p.add_argument(
        "--resume",
        action="store_true",
        help="continue from the λ-grid checkpoint in the output dir "
        "(skips already-solved weights, keeps the warm-start chain)",
    )
    p.add_argument(
        "--initial-model",
        help="saved model Avro to warm-start the grid from (the reference's "
        "incremental training)",
    )
    p.add_argument(
        "--data-parallel",
        choices=["off", "auto"],
        default="off",
        help="auto: shard the training rows over the ranks of a "
        "torch.distributed process group (one card each) when one with "
        "more than one rank forms; a single process trains as with off",
    )
    p.add_argument(
        "--training-report",
        action="store_true",
        help="write report.json + report.html to the output dir: per-λ "
        "convergence traces, bootstrap CIs on the validation metric, "
        "Hosmer-Lemeshow calibration (logistic) and |coef|·std feature "
        "importance",
    )
    p.add_argument(
        "--max-retries",
        type=int,
        default=0,
        help="re-enter training after a transient failure (a dropped "
        "transport, a preemption) up to this many times, resuming from the "
        "λ-grid checkpoint; 0 disables",
    )
    p.add_argument(
        "--retry-backoff",
        type=float,
        default=5.0,
        help="initial seconds between retries (x2 per attempt, capped at "
        "300 s)",
    )
    p.add_argument(
        "--stream-chunk-rows",
        type=int,
        default=0,
        help="out-of-core training: keep the training rows on the host as "
        "chunks of this many rows and stream them through the card on every "
        "objective evaluation; 0 = device-resident.  L-BFGS, OWL-QN "
        "(L1/elastic net) and smooth TRON all stream",
    )
    p.add_argument(
        "--stream-storage-dir",
        help="with --stream-chunk-rows: spill the chunk store to .npy files "
        "in this (empty) directory and train from memmaps",
    )
    p.add_argument(
        "--stream-prefetch-depth",
        type=int,
        default=2,
        help="with --stream-chunk-rows: chunks in flight (pinned slots, "
        "device items and the compute window each); 1 serialises transfer "
        "and compute",
    )
    p.add_argument(
        "--stream-chunk-fuse",
        type=int,
        default=1,
        help="with --stream-chunk-rows: move this many chunks in one "
        "transfer and run them in one consumer step; 1 disables",
    )
    p.add_argument(
        "--stream-batch-linesearch",
        choices=["on", "off"],
        default="on",
        help="with --stream-chunk-rows: evaluate a bracket of line-search "
        "candidates in one streamed pass (the same trials, about half the "
        "passes); off streams one trial a pass",
    )
    p.add_argument(
        "--stream-compress",
        choices=["off", "lossless", "fp16", "int8"],
        default="off",
        help="with --stream-chunk-rows: move chunks as encoded wire buffers "
        "decoded on the card; lossless keeps every solve bitwise, fp16/int8 "
        "add bounded quantization error",
    )
    p.add_argument(
        "--stream-hot-budget-mb",
        type=float,
        default=0.0,
        help="with --stream-chunk-rows: keep up to this many MB of "
        "transferred chunks resident on the card across passes, chosen each "
        "pass by their contribution to the objective; bitwise neutral; 0 "
        "disables",
    )
    p.add_argument(
        "--precise-accumulation",
        action="store_true",
        help="accumulate the objective VALUE in float64 (gradient sums "
        "stay float32)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device for data, objective and solver (cuda | cpu)",
    )
    add_telemetry_args(p)
    return p


def make_fit_once(
    X_train,
    y_train,
    X_val,
    y_val,
    *,
    task: str = "logistic",
    reg_type: str = "l2",
    elastic_net_alpha: float = 0.5,
    optimizer: str = "lbfgs",
    max_iters: int = 100,
    tolerance: float = 1e-8,
    suite=None,
    val_weights=None,
    solver: Optional[str] = None,
    solver_options: tuple = (),
    device=None,
):
    """Reusable single-fit entry for the tuning orchestrator
    (``tuning/``): ``fit_once(params, resource, warm_start) -> (metric,
    metrics, coefficients)``.

    ``params[0]`` is the regularization weight λ.  ``resource`` > 0 caps
    the optimizer's iteration budget (an ASHA rung's resource; 0 uses
    ``max_iters``), and ``warm_start`` seeds the solve (the λ-path warm
    start of this driver's own grid).  The data goes to ``device`` (the
    card by default) once; trials solve there from their own threads, one
    problem per iteration budget shared under a lock, and the validation
    rows are scored on the host.  A host-kind ``solver`` (admm, block_cd)
    runs over logical shards of the same data.

    Exposes ``fit_once.suite`` and ``fit_once.larger_is_better`` so
    callers wire the orchestrator's direction without re-deriving it.
    """
    import threading

    from photon_ml_tpu_torch.analysis import sanitizers
    from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite
    from photon_ml_tpu_torch.ops import losses as losses_lib
    from photon_ml_tpu_torch.solvers import registry as solver_registry

    if suite is None:
        suite = EvaluationSuite.for_task(losses_lib.get(task).name)
    dev = resolve_device(device)
    host_kind = (solver is not None
                 and solver_registry.get(solver).kind == "host")
    if host_kind and hasattr(X_train, "todense"):
        # Host-kind solvers shard dense row blocks; tuning-scale designs
        # densify cheaply.
        X_train = np.asarray(X_train.todense(), np.float32)
    data = make_glm_data(X_train, y_train, device=dev)
    y_val = np.asarray(y_val)
    problems: dict[int, GlmOptimizationProblem] = {}
    sharded_solves: dict[int, object] = {}
    lock = sanitizers.tracked(threading.Lock(), "glm.problem_cache")

    def _problem(iters: int) -> GlmOptimizationProblem:
        # One problem per distinct iteration budget, shared across trials
        # and threads.
        with lock:
            p = problems.get(iters)
            if p is None:
                p = problems[iters] = GlmOptimizationProblem(
                    task,
                    GlmOptimizationConfig(
                        optimizer=OptimizerConfig(
                            optimizer=OptimizerType(optimizer),
                            max_iters=iters,
                            tolerance=tolerance,
                            solver=solver,
                            solver_options=tuple(solver_options),
                        ),
                        regularization=RegularizationContext(
                            RegularizationType(reg_type), elastic_net_alpha
                        ),
                    ),
                )
            return p

    def _sharded_solve(iters: int):
        # The host-kind counterpart of the problem cache: one bound solver
        # (logical shards) per iteration budget.
        from photon_ml_tpu_torch.solvers import sharded as solvers_sharded

        problem = _problem(iters)
        with lock:
            solve = sharded_solves.get(iters)
            if solve is None:
                n_shards = solvers_sharded.resolve_shard_count(
                    problem.config.optimizer)
                dist = solvers_sharded.stack_resident(data, n_shards)
                solve = sharded_solves[iters] = solver_registry.get(
                    solver).sharded(problem, dist, None, None)
            return solve

    def fit_once(params, resource=0, warm_start=None):
        iters = int(resource) if resource else max_iters
        w0 = (None if warm_start is None else torch.as_tensor(
            np.asarray(warm_start, np.float32), device=dev))
        lam = float(np.asarray(params).ravel()[0])
        if host_kind:
            res = _sharded_solve(iters)(lam, w0)
        else:
            res = _problem(iters).solve_single_device(data, reg_weight=lam,
                                                      w0=w0)
        w = to_numpy(res.w).astype(np.float32)
        scores = np.asarray(X_val @ w).ravel()
        metric, all_metrics = suite.evaluate_primary(scores, y_val,
                                                     val_weights)
        return metric, all_metrics, w

    fit_once.suite = suite
    fit_once.larger_is_better = suite.primary_evaluator.larger_is_better
    return fit_once


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_arg_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    from photon_ml_tpu_torch.parallel import multihost

    with PhotonLogger(args.output_dir) as logger, multihost.driver_group(
            logger, args.device) as world:
        # The reference forms a mesh only over more than one device.
        mesh = (multihost.global_data_mesh()
                if args.data_parallel == "auto" and world > 1 else None)
        with driver_telemetry(args, logger, "glm_driver",
                              writer=mesh is None or mesh.rank == 0,
                              task=args.task) as tel:
            return _run_impl(args, logger, mesh, tel)


def _check_stream_flags(args, data_parallel: bool) -> bool:
    """The reference's guards on the ``--stream-*`` flags, before any
    ingest; returns whether the run streams."""
    if args.stream_storage_dir and args.stream_chunk_rows <= 0:
        # Ignoring the flag would train fully resident on exactly the
        # oversized dataset the flag exists for.
        raise ValueError(
            "--stream-storage-dir requires --stream-chunk-rows > 0")
    for flag, value in (("--stream-prefetch-depth",
                         args.stream_prefetch_depth),
                        ("--stream-chunk-fuse", args.stream_chunk_fuse)):
        if value < 1:
            raise ValueError(f"{flag} must be >= 1, got {value}")
    if args.stream_hot_budget_mb < 0:
        raise ValueError("--stream-hot-budget-mb must be >= 0")
    if args.stream_chunk_fuse > 1 and data_parallel:
        # The objective would refuse it too, but only after the ingest.
        raise ValueError(
            "--stream-chunk-fuse > 1 is single-device only (a fused group "
            "does not compose with the group's reduction)")
    if args.stream_hot_budget_mb > 0 and data_parallel:
        raise ValueError(
            "--stream-hot-budget-mb > 0 is single-device only (a cached "
            "chunk would pin one rank's shard across passes)")
    return args.stream_chunk_rows > 0


def _run_impl(args, logger, mesh=None, tel=None) -> dict:
    """The driver's stages; ``mesh`` is the process group a
    ``--data-parallel auto`` run trains over (None: one process); ``tel``
    the run's hub (None: the process-current one)."""
    tel = telemetry_mod.current() if tel is None else tel
    timer = Timer().start()
    device = resolve_device(args.device)
    data_parallel = mesh is not None
    streaming = _check_stream_flags(args, data_parallel)
    writer = not data_parallel or mesh.rank == 0

    # Stage 1: read ---------------------------------------------------------
    with tel.span("read", path=args.train_data):
        X_train, y_train = libsvm.read_libsvm(
            args.train_data, n_features=args.n_features,
            add_intercept=args.intercept,
        )
    d = X_train.shape[1]
    logger.info(
        "read %d rows x %d features from %s", X_train.shape[0], d,
        args.train_data,
    )
    # Positional LIBSVM features get names (feature "j", intercept last).
    names = [f"f{j}" for j in range(d - 1 if args.intercept else d)]
    index_map = IndexMap.build(names, add_intercept=args.intercept)

    # Stage 2: summarize + normalization ------------------------------------
    with tel.span("summarize", rows=int(X_train.shape[0]), features=int(d)):
        if streaming or data_parallel:
            # The streamed run never puts the whole matrix on the card,
            # and a rank keeps only its own row block there.
            train_data = None
            summary = summarize_host(X_train)
        else:
            train_data = make_glm_data(X_train, y_train, device=device)
            summary = summarize(train_data)
    norm_type = NormalizationType(args.normalization)
    normalization = (
        None
        if norm_type is NormalizationType.NONE
        else build_normalization(norm_type, summary,
                                 index_map.intercept_index, device=device)
    )
    summary_out = {
        "mean": to_numpy(summary.mean).tolist(),
        "variance": to_numpy(summary.variance).tolist(),
        "min": to_numpy(summary.min).tolist(),
        "max": to_numpy(summary.max).tolist(),
        "nnz": to_numpy(summary.nnz).tolist(),
        "count": float(summary.count),
    }
    if writer:
        with open(os.path.join(args.output_dir, "feature_summary.json"),
                  "w") as f:
            json.dump(summary_out, f)
        save_feature_summary(
            summary, index_map,
            os.path.join(args.output_dir, "feature_summary.avro"),
        )

    # Stage 3: train over the λ grid ----------------------------------------
    solver_options = []
    for kv in args.solver_option:
        if "=" not in kv:
            raise SystemExit(f"--solver-option must be KEY=VALUE, got {kv!r}")
        k, _, v = kv.partition("=")
        solver_options.append((k.strip(), v.strip()))
    if args.solver_shards:
        solver_options.append(("shards", args.solver_shards))
    host_solver = False
    if args.solver is not None:
        from photon_ml_tpu_torch.solvers import registry as solver_registry

        try:
            host_solver = solver_registry.get(args.solver).kind == "host"
        except KeyError as e:
            raise SystemExit(str(e))
        if host_solver:
            if streaming:
                raise SystemExit(
                    f"--solver {args.solver} runs over sharded resident "
                    "data; it does not compose with --stream-chunk-rows")
            if args.compute_variances:
                raise SystemExit(f"--solver {args.solver} does not support "
                                 "--compute-variances")
            if args.coefficient_bounds:
                raise SystemExit(
                    f"--solver {args.solver} does not support "
                    "--coefficient-bounds (only spg does)")
    problem = GlmOptimizationProblem(
        args.task,
        GlmOptimizationConfig(
            optimizer=OptimizerConfig(
                optimizer=OptimizerType(args.optimizer),
                max_iters=args.max_iters,
                tolerance=args.tolerance,
                solver=args.solver,
                solver_options=tuple(solver_options),
            ),
            regularization=RegularizationContext(
                RegularizationType(args.reg_type), args.elastic_net_alpha
            ),
            compute_variances=args.compute_variances,
        ),
        normalization=normalization,
        accumulate="f64" if args.precise_accumulation else "f32",
    )
    reg_weights = [float(s) for s in args.reg_weights.split(",")]
    l1_mask = None
    if args.intercept and index_map.intercept_index is not None:
        # The reference never regularizes the intercept with L1.
        l1_mask = torch.ones(d, dtype=torch.float32, device=device)
        l1_mask[index_map.intercept_index] = 0.0

    # Checkpoint/resume: each solved λ is persisted; --resume skips
    # finished λs bit-exactly.  The RESOLVED bounds are fingerprinted: a
    # resume under other bounds would warm-start the remaining λs from
    # incompatibly constrained coefficients.
    bounds = bounds_fp = None
    if args.coefficient_bounds:
        lower, upper = _read_bounds(args, index_map, d, normalization,
                                    streaming or data_parallel)
        logger.info("box constraints on %d of %d coefficients",
                    int((np.isfinite(lower) | np.isfinite(upper)).sum()), d)
        bounds = (torch.as_tensor(lower, device=device),
                  torch.as_tensor(upper, device=device))
        h = hashlib.sha256()
        h.update(lower.tobytes())
        h.update(upper.tobytes())
        bounds_fp = h.hexdigest()
    ckpt = GridCheckpointer(os.path.join(args.output_dir, "checkpoints"))
    if args.resume:
        saved_fp = ckpt.load_meta().get("bounds_fingerprint")
        if ckpt.exists() and saved_fp != bounds_fp:
            raise SystemExit(
                "--resume: the grid checkpoint was written under "
                f"different --coefficient-bounds (saved fingerprint "
                f"{saved_fp}, this run {bounds_fp}); clear "
                f"{ckpt.path} or rerun with the matching bounds"
            )
        solved = ckpt.load()
    else:
        # A stale checkpoint (possibly from a run on other data) must not
        # survive into a later --resume.  One rank keeps the checkpoint;
        # every rank solves the same λs.
        if writer:
            ckpt.clear()
        solved = {}
    if solved:
        logger.info("resuming: %d of %d grid points already solved",
                    len(solved), len(reg_weights))

    # Incremental training: a saved model (original feature space) seeds
    # the warm-start chain in the solver's scaled-coefficient space.
    w0 = None
    if args.initial_model:
        glm0, _ = load_glm_model(args.initial_model, index_map,
                                 device=device)
        w0 = glm0.coefficients.means.to(torch.float32)
        if normalization is not None:
            w0 = normalization.original_to_model(w0)
        logger.info("warm-starting from %s", args.initial_model)

    sobj = None
    streaming_out = None
    if streaming:
        from photon_ml_tpu_torch.optim.streaming import (
            StreamingObjective,
            ensure_streamable,
        )

        # Refuse an unstreamable config BEFORE the (possibly long) ingest.
        ensure_streamable(problem.config)
        build = Timer().start()
        stream = _build_stream(args, X_train, y_train, device, mesh, logger)
        sobj = StreamingObjective(
            problem.objective, stream, mesh=mesh,
            prefetch_depth=args.stream_prefetch_depth,
            chunk_fuse=args.stream_chunk_fuse,
            compress=args.stream_compress,
            hot_budget_bytes=int(args.stream_hot_budget_mb * 1e6),
        )
        streaming_out = {
            "chunks": stream.n_chunks, "chunk_rows": stream.chunk_rows,
            "layout": stream.kind, "host_bytes": stream.nbytes(),
            "disk": args.stream_storage_dir is not None,
            "compression_ratio": sobj.compression_ratio,
            "build_seconds": build.stop(),
        }
        logger.info(
            "streaming: %d chunks x %d rows (%s layout, %.1f MB %s), built "
            "in %.2fs", stream.n_chunks, stream.chunk_rows, stream.kind,
            stream.nbytes() / 1e6, "on disk" if args.stream_storage_dir
            else "in RAM", streaming_out["build_seconds"],
        )

    def train(attempt: int):
        """One training attempt over the λ grid.  Re-entered by the
        watchdog after a transient failure: checkpointed λs are reloaded so
        finished work is never repeated, and resident data is re-placed."""
        solved_now = dict(solved)
        if attempt:
            solved_now.update(ckpt.load())
            logger.info("retry %d: %d grid points restored from checkpoints",
                        attempt, len(solved_now))
        solved_acc = dict(solved_now)

        def on_solved(lam, w):
            solved_acc[lam] = to_numpy(w)
            if writer:
                ckpt.save(solved_acc,
                          extra_meta={"bounds_fingerprint": bounds_fp})

        if streaming:
            from photon_ml_tpu_torch.optim.streaming import streaming_run_grid

            return streaming_run_grid(
                problem, sobj, reg_weights, w0=w0, solved=solved_now,
                on_solved=on_solved, l1_mask=l1_mask,
                batch_linesearch=args.stream_batch_linesearch == "on",
            )
        if data_parallel or host_solver:
            return _train_sharded(args, problem, X_train, y_train, device,
                                  mesh, reg_weights, w0, l1_mask,
                                  solved_now, on_solved, logger)
        data = train_data if attempt == 0 else make_glm_data(
            X_train, y_train, device=device)
        return problem.run_grid(data, reg_weights, w0=w0, l1_mask=l1_mask,
                                solved=solved_now, on_solved=on_solved,
                                bounds=bounds)

    retry_stats = RetryStats()
    with tel.span("train", grid_points=len(reg_weights),
                  streaming=streaming, data_parallel=data_parallel):
        grid = run_with_retries(
            train,
            RetryPolicy(max_retries=args.max_retries,
                        backoff_seconds=args.retry_backoff),
            logger, stats=retry_stats,
        )
    grid_walls = problem.grid_wall_seconds
    for lam, _, res in grid:
        tracker = OptimizationStatesTracker.from_solve_result(
            res, wall_seconds=grid_walls.get(lam, float("nan"))
        )
        if tracker.restored:
            logger.info("lambda=%g: restored from checkpoint", lam)
            continue
        logger.info(
            "lambda=%g: value=%.8g iters=%d converged=%s%s wall=%.3fs",
            lam, float(res.value), tracker.iterations, tracker.converged,
            "" if tracker.stalled is None else f" stalled={tracker.stalled}",
            tracker.wall_seconds,
        )

    # Stage 4: validate + select --------------------------------------------
    evaluator = (
        get_evaluator(args.evaluator)
        if args.evaluator
        else default_evaluator_for_task(problem.task)
    )
    if args.validate_data:
        X_val, y_val = libsvm.read_libsvm(
            args.validate_data, n_features=d - (1 if args.intercept else 0),
            add_intercept=args.intercept,
            # Features unseen at training time contribute nothing.
            drop_out_of_range=True,
        )
    else:
        X_val, y_val = X_train, y_train
    # A streamed run scores on the host (a scipy mat-vec): validation never
    # needs the whole matrix on the card.
    val_data = None
    if not streaming:
        val_data = (train_data if train_data is not None
                    and not args.validate_data
                    else make_glm_data(X_val, y_val, device=device))

    report = None
    if args.training_report:
        from photon_ml_tpu_torch.diagnostics import (
            TrainingReport,
            bootstrap_metric_ci,
            feature_importance,
            hosmer_lemeshow,
        )

        report = TrainingReport(task=problem.task)
        report_std = np.sqrt(np.maximum(to_numpy(summary.variance), 0.0))

    metrics = {}
    best = None
    best_metric = None
    with tel.span("validate", rows=int(len(y_val)),
                  evaluator=type(evaluator).__name__):
        for lam, model, res in grid:
            if streaming:
                w_host = to_numpy(model.coefficients.means)
                scores = np.asarray(X_val @ w_host.astype(np.float32)).ravel()
                val_weights = None
            else:
                scores = to_numpy(model.compute_score(val_data))
                val_weights = to_numpy(val_data.weights)
            m = evaluator.evaluate(scores, y_val, val_weights)
            metrics[lam] = m
            logger.info("lambda=%g: %s=%.6f", lam,
                        type(evaluator).__name__, m)
            if best_metric is None or evaluator.better_than(m, best_metric):
                best_metric, best = m, (lam, model)
            if report is not None:
                if res is not None:
                    report.add_convergence(lam, to_numpy(res.values),
                                           to_numpy(res.grad_norms))
                report.add_metric(
                    type(evaluator).__name__, lam,
                    bootstrap_metric_ci(
                        lambda s, l: evaluator.evaluate(s, l, None),
                        scores, np.asarray(y_val)),
                )
                if problem.task == "logistic":
                    report.add_calibration(
                        lam, hosmer_lemeshow(scores, np.asarray(y_val)))
                report.add_importance(lam, feature_importance(
                    to_numpy(model.coefficients.means),
                    feature_std=report_std, name_fn=index_map.index_to_name,
                ))

    # Stage 5: write --------------------------------------------------------
    if best is None:
        raise ValueError("empty --reg-weights grid: nothing was trained")
    best_lam, _ = best
    with tel.span("write", output_mode=args.output_mode):
        to_write = grid if args.output_mode == "all" else [
            (lam, mdl, res) for lam, mdl, res in grid if lam == best_lam
        ]
        if not writer:
            to_write = []
        for lam, model, _ in to_write:
            out = os.path.join(args.output_dir, f"model_lambda_{lam:g}.avro")
            save_glm_model(model, index_map, out, model_id=f"lambda={lam:g}")
        if writer:
            index_map.save(args.output_dir)
    result = {
        "best_lambda": best_lam,
        "metrics": {str(k): v for k, v in metrics.items()},
        "evaluator": type(evaluator).__name__,
        "n_rows": int(X_train.shape[0]),
        "n_features": int(d),
        "wall_seconds": timer.stop(),
        "solver_wall_seconds": {
            str(lam): w for lam, w in sorted(grid_walls.items())
        },
    }
    if retry_stats.retries or retry_stats.failures:
        result["retry"] = retry_stats.snapshot()
    if streaming_out is not None:
        streaming_out["transfer"] = sobj.transfer_stats.snapshot()
        result["streaming"] = streaming_out
    if data_parallel:
        result["data_parallel"] = {"ranks": mesh.size, "rank": mesh.rank}
    if report is not None and writer:
        jpath, hpath = report.save(args.output_dir)
        result["report"] = {"json": jpath, "html": hpath}
        logger.info("training report: %s", hpath)
    if writer:
        with open(os.path.join(args.output_dir, "training_result.json"),
                  "w") as f:
            json.dump(result, f, indent=2)
    tel.gauge("run_wall_seconds").set(result["wall_seconds"])
    logger.info(
        "selected lambda=%g (%s=%.6f) in %.2fs",
        best_lam, type(evaluator).__name__, best_metric,
        result["wall_seconds"],
    )
    return result


def _build_stream(args, X_train, y_train, device, mesh, logger):
    """The chunk store a run streams: one card's whole store, or under a
    group this rank's shard of every chunk (every rank read the same file;
    the reference's one-host mesh) — over several hosts, a store of this
    rank's ``host_local_rows`` alone."""
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.parallel import multihost

    kw = dict(chunk_rows=args.stream_chunk_rows,
              storage_dir=args.stream_storage_dir, device=device)
    if mesh is None:
        return make_streaming_glm_data(X_train, y_train, **kw)
    if args.stream_storage_dir:
        # Ranks of one host would collide in one directory.
        kw["storage_dir"] = os.path.join(args.stream_storage_dir,
                                         f"rank{mesh.rank}")
    if multihost.spans_hosts(mesh):
        start, stop = multihost.host_local_rows(X_train.shape[0])
        stream = make_streaming_glm_data(X_train[start:stop],
                                         y_train[start:stop], **kw)
        stream.row_block = (start, stop, X_train.shape[0])
        logger.info("streamed data-parallel: rank %d of %d streams its "
                    "host-local rows [%d, %d)", mesh.rank, mesh.size, start,
                    stop)
        return stream
    stream = make_streaming_glm_data(X_train, y_train, mesh=mesh, **kw)
    logger.info("streamed data-parallel: rank %d of %d streams shard %d of "
                "each of %d chunks (%d rows a shard)", mesh.rank, mesh.size,
                mesh.rank, stream.n_chunks, stream.per_shard)
    return stream


def _train_sharded(args, problem, X_train, y_train, device, mesh,
                   reg_weights, w0, l1_mask, solved, on_solved, logger):
    """The grid over row shards: the process group's (each rank its
    ``host_local_rows`` block, every evaluation one all-reduce; host-kind
    solvers one reduction a round) or, for a host-kind solver on one card,
    ``--solver-shards`` logical shards."""
    from photon_ml_tpu_torch.parallel import multihost
    from photon_ml_tpu_torch.parallel.distributed import (
        run_grid_distributed,
        shard_glm_data,
    )
    from photon_ml_tpu_torch.solvers import sharded as solvers_sharded

    X = X_train
    if args.solver == "block_cd" and hasattr(X, "todense"):
        # Block CD reads per-shard columns: densify (LIBSVM inputs at
        # driver scale fit).
        X = np.asarray(X.todense(), np.float32)
        logger.info("block_cd: densified %d x %d design for column access",
                    X.shape[0], X.shape[1])
    if mesh is not None:
        start, stop = multihost.host_local_rows(X.shape[0])
        dist = shard_glm_data(X, y_train, mesh, device=device)
        logger.info("data-parallel: rank %d of %d holds rows [%d, %d) "
                    "(%d a rank)", mesh.rank, mesh.size, start, stop,
                    dist.rows_per)
        return run_grid_distributed(
            problem, dist, mesh, reg_weights, w0=w0, l1_mask=l1_mask,
            solved=solved, on_solved=on_solved)
    n_shards = solvers_sharded.resolve_shard_count(problem.config.optimizer)
    dist = shard_glm_data(X, y_train, None, n_shards=n_shards, device=device)
    logger.info("solver %s: %d logical shard(s)", args.solver, n_shards)
    return solvers_sharded.run_grid_sharded(
        problem, dist, None, reg_weights, w0=w0, l1_mask=l1_mask,
        solved=solved, on_solved=on_solved)


def _read_bounds(args, index_map, d, normalization, sharded):
    """The ``--coefficient-bounds`` JSON map as (lower, upper) float32
    arrays of width ``d`` (unlisted features ±inf), with the reference
    driver's checks."""
    # Under normalization the solver's coefficients live in scaled space,
    # where a per-feature box does not map back to the user's box.
    if normalization is not None:
        raise SystemExit("--coefficient-bounds requires --normalization none")
    if sharded:
        raise SystemExit(
            "--coefficient-bounds is single-device resident-data only")
    if args.compute_variances:
        # The diag-inverse-Hessian variance assumes an interior optimum.
        raise SystemExit(
            "--coefficient-bounds is incompatible with --compute-variances"
        )
    with open(args.coefficient_bounds) as f:
        bounds_map = json.load(f)
    lower = np.full((d,), -np.inf, np.float32)
    upper = np.full((d,), np.inf, np.float32)
    unknown = [k for k in bounds_map if index_map.get_index(k) < 0]
    if unknown:
        raise SystemExit(
            f"--coefficient-bounds names unknown features: {unknown[:5]}"
        )
    for key, (lo, hi) in bounds_map.items():
        lo, hi = float(lo), float(hi)
        if np.isnan(lo) or np.isnan(hi) or lo > hi:
            # json.load accepts NaN literals, and a clamp with lower >
            # upper silently returns upper: both would train a wrong model.
            raise SystemExit(
                f"--coefficient-bounds: invalid bounds for {key!r}: "
                f"[{lo}, {hi}]"
            )
        idx = index_map.get_index(key)
        lower[idx], upper[idx] = lo, hi
    return lower, upper


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
