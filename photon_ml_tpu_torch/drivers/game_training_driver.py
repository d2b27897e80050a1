"""GAME training driver (port of ``photon_ml_tpu/drivers/game_training_driver.py``).

The reference's ``GameTrainingDriver``: read GAME Avro data → build
feature index maps → ``GameEstimator.fit`` (or ``fit_grid`` over a
coordinate-config grid) with per-update validation and checkpoints →
evaluate → save the GameModel (fixed-effect + per-entity coefficient Avro
files) → ``training_result.json``.  Ingest, evaluation and the model store
run on the host; the datasets, the descent and the validation scorers run
on ``--device`` (CUDA by default), where the fixed effect's products go
through the hand-written SpMV kernels.  Beside the reference's keys, the
result holds ``stage_seconds`` (host seconds of the reads, the builds, the
descent and its metric and validation stages, the model save) and
``decoders`` (the GAME decoder that read each file).

The coordinate configuration comes from a JSON file, e.g.::

    {
      "task": "logistic",
      "iterations": 3,
      "evaluator": "auc",
      "coordinates": [
        {"name": "fixed", "type": "fixed", "feature_shard": "global",
         "optimizer": "lbfgs", "max_iters": 50, "tolerance": 1e-7,
         "reg_type": "l2", "reg_weight": 1.0},
        {"name": "per_user", "type": "random", "feature_shard": "userFeatures",
         "entity_key": "userId", "optimizer": "lbfgs", "max_iters": 30,
         "reg_type": "l2", "reg_weight": 1.0, "max_rows_per_entity": 4096}
      ]
    }

A coordinate may give ``reg_weights`` (a list) instead of ``reg_weight``:
the grid is the cross product of every coordinate's variants.

Out of core, as in the reference: a fixed effect with
``streaming_chunk_rows`` streams a host chunk store (with
``prefetch_depth``, ``chunk_fuse``, ``batch_linesearch``,
``stream_compress`` and ``stream_hot_budget_mb``), and a plain or factored
random effect with ``device_budget_mb`` streams its entity blocks in
budget-bounded pass groups (with ``prefetch_depth`` and, plain,
``hot_budget_mb``).  A fixed effect's ``solver`` may name a host-kind
solver (``admm``, ``block_cd``) with its knobs in ``solver_options``: it
runs over logical row shards of a dense design.  ``--data-parallel auto``
and a random effect's ``split_factor`` act only where a group of more than
one rank forms, as in the reference: on one process they change nothing.
Over a group (``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``, or
``PHOTON_MULTIHOST=1`` under ``torchrun``) every rank reads the same files
and places only its own shards on its card (``game/estimator.py``: the
reference's one-host mesh, the whole dataset in each process's RAM); rank
0 writes the checkpoints, the model and the results.  A config with
``"tuning": {"mode": "bayesian"|"random", "iterations": N, "range": [lo,
hi]}`` first searches the per-coordinate regularization weights (Photon-ML's
BAYESIAN|RANDOM tuning): the datasets are built once, each point only sets
the coordinates' ``reg_weight`` and refits without variances, and the best
point's weights train the final model; ``training_result.json`` carries
the search under ``"tuning"``.  ``--max-retries`` re-enters the fit
after a transient failure (``utils/watchdog.py``), resuming from the CD
checkpoint (or, for a config grid, from the grid checkpoint), so a retry
repeats no finished iteration or grid point.
Random effects may be plain (``"type": "random"``) or factored
(``"factored_random"``/``"factored"`` with ``rank``, ``alternations`` and
``projection_reg_weight``), under any regularization and optimizer
(``elastic_net`` with ``elastic_net_alpha``, ``owlqn``, ``tron``).  Telemetry, the ops plane and the compile cache are
left out, as in the port's GLM driver.

Usage:
    python -m photon_ml_tpu_torch.drivers.game_training_driver \\
        --train-data train.avro --validate-data val.avro \\
        --config config.json --output-dir out --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import threading
from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.data.game_reader import read_game_avro
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.drivers.ops_plane import (
    add_telemetry_args,
    driver_telemetry,
)
from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite
from photon_ml_tpu_torch.game.estimator import (
    FactoredRandomEffectCoordinateConfig,
    FixedEffectCoordinateConfig,
    GameEstimator,
    GameTransformer,
    RandomEffectCoordinateConfig,
)
from photon_ml_tpu_torch.io.checkpoint import (
    CoordinateDescentCheckpointer,
    GameGridCheckpointer,
)
from photon_ml_tpu_torch.io.game_store import load_game_model, save_game_model
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_tpu_torch.optim.regularization import (
    RegularizationContext,
    RegularizationType,
)
from photon_ml_tpu_torch.utils.logging import PhotonLogger
from photon_ml_tpu_torch.utils.timer import Timer
from photon_ml_tpu_torch.utils.watchdog import (
    RetryPolicy,
    RetryStats,
    run_with_retries,
)


def expand_config_grid(coordinate_specs: Sequence[dict]) -> list[dict]:
    """Expand the JSON coordinate list into the coordinate-config GRID: a
    spec may give ``reg_weights`` (a list) instead of scalar
    ``reg_weight``; the grid is the cross product of every coordinate's
    variants.  Returns a list of name→config mappings."""
    per_coord = []
    for spec in coordinate_specs:
        name, base = parse_coordinate_config(spec)
        weights = spec.get("reg_weights")
        variants = (
            [dataclasses.replace(base, reg_weight=float(w)) for w in weights]
            if weights else [base]
        )
        per_coord.append((name, variants))
    return [
        {name: cfg for (name, _), cfg in zip(per_coord, combo)}
        for combo in itertools.product(*[v for _, v in per_coord])
    ]


def parse_coordinate_config(spec: dict):
    """One JSON coordinate spec → (name, CoordinateConfig), with the
    reference's keys and defaults."""
    solver = spec.get("solver")
    # A tuple of (key, value) strings, sorted: hashable, and the same image
    # in both packages' checkpoint fingerprints.
    solver_options = tuple(
        sorted((str(k), str(v)) for k, v in
               dict(spec.get("solver_options", {})).items())
    )
    opt = GlmOptimizationConfig(
        optimizer=OptimizerConfig(
            optimizer=OptimizerType(spec.get("optimizer", "lbfgs")),
            max_iters=int(spec.get("max_iters", 100)),
            tolerance=float(spec.get("tolerance", 1e-7)),
            solver=solver if solver is None else str(solver),
            solver_options=solver_options,
        ),
        regularization=RegularizationContext(
            RegularizationType(spec.get("reg_type", "none")),
            float(spec.get("elastic_net_alpha", 0.5)),
        ),
        compute_variances=bool(spec.get("compute_variances", False)),
    )
    name = spec["name"]
    if spec["type"] == "fixed":
        return name, FixedEffectCoordinateConfig(
            feature_shard=spec["feature_shard"],
            optimization=opt,
            reg_weight=float(spec.get("reg_weight", 0.0)),
            down_sampling_rate=float(spec.get("down_sampling_rate", 1.0)),
            streaming_chunk_rows=int(spec.get("streaming_chunk_rows", 0)),
            prefetch_depth=int(spec.get("prefetch_depth", 2)),
            chunk_fuse=int(spec.get("chunk_fuse", 1)),
            batch_linesearch=bool(spec.get("batch_linesearch", True)),
            stream_compress=str(spec.get("stream_compress", "off")),
            stream_hot_budget_mb=float(spec.get("stream_hot_budget_mb", 0.0)),
        )
    if spec["type"] == "random":
        return name, RandomEffectCoordinateConfig(
            feature_shard=spec["feature_shard"],
            entity_key=spec["entity_key"],
            optimization=opt,
            reg_weight=float(spec.get("reg_weight", 0.0)),
            max_rows_per_entity=spec.get("max_rows_per_entity"),
            bucket_growth=float(spec.get("bucket_growth", 2.0)),
            repack=str(spec.get("repack", "geometric")),
            program_budget=int(spec.get("program_budget", 16)),
            repack_seed=int(spec.get("repack_seed", 0)),
            split_factor=float(spec.get("split_factor", 0.5)),
            device_budget_bytes=int(
                float(spec.get("device_budget_mb", 0)) * 2**20),
            prefetch_depth=int(spec.get("prefetch_depth", 2)),
            hot_budget_mb=float(spec.get("hot_budget_mb", 0.0)),
        )
    if spec["type"] in ("factored_random", "factored"):
        proj_rw = spec.get("projection_reg_weight")
        return name, FactoredRandomEffectCoordinateConfig(
            feature_shard=spec["feature_shard"],
            entity_key=spec["entity_key"],
            rank=int(spec["rank"]),
            optimization=opt,
            reg_weight=float(spec.get("reg_weight", 0.0)),
            projection_reg_weight=(None if proj_rw is None
                                   else float(proj_rw)),
            alternations=int(spec.get("alternations", 2)),
            max_rows_per_entity=spec.get("max_rows_per_entity"),
            bucket_growth=float(spec.get("bucket_growth", 2.0)),
            repack=str(spec.get("repack", "geometric")),
            program_budget=int(spec.get("program_budget", 16)),
            repack_seed=int(spec.get("repack_seed", 0)),
            device_budget_bytes=int(
                float(spec.get("device_budget_mb", 0)) * 2**20),
            prefetch_depth=int(spec.get("prefetch_depth", 2)),
        )
    raise ValueError(f"unknown coordinate type {spec['type']!r}")


def make_fit_once(task: str, coordinate_configs: dict, shards: dict,
                  ids: dict, response, validation, *, weight=None,
                  offset=None, suite=None, device_metrics: bool = False,
                  device=None, mesh=None):
    """Reusable single-fit entry for a tuning loop: ``fit_once(params,
    resource, warm_start) -> (metric, metrics, None)``.

    ``params`` carries one regularization weight per coordinate (in
    ``coordinate_configs`` order) and ``resource`` the number of CD
    iterations (0 uses 1).  ``warm_start`` is accepted but unused: GAME
    state does not warm-start across trials.  Trials mutate each
    coordinate's ``reg_weight``, so one coordinate build serves many trials
    (never two at once: builds live in a checkout pool per iteration
    budget).  The coordinates are built on ``device``, over ``mesh`` when
    one is given (as ``GameEstimator`` builds them)."""
    if suite is None:
        suite = EvaluationSuite.for_task(losses_lib.get(task).name)
    evaluator = suite.primary_evaluator
    names = list(coordinate_configs)
    # Never pay the coefficient-variance finalize cost per tuning point.
    base_configs = {
        nm: dataclasses.replace(cfg, optimization=dataclasses.replace(
            cfg.optimization, compute_variances=False))
        for nm, cfg in coordinate_configs.items()
    }
    v_shards, v_ids, v_resp, v_weight, v_offset = validation[:5]
    v_groups = (np.asarray(v_ids[suite.group_column])
                if suite.group_column is not None else None)
    pools: dict[int, list] = {}
    pool_lock = sanitizers.tracked(threading.Lock(), "game.checkout_pool")

    def _checkout(resource: int):
        n_iter = int(resource) if resource else 1
        with pool_lock:
            free = pools.setdefault(n_iter, [])
            if free:
                return n_iter, free.pop()
        est = GameEstimator(task, base_configs, n_iterations=n_iter,
                            device_metrics=device_metrics, device=device,
                            mesh=mesh)
        coords = est.build_coordinates(shards, ids, response, weight, offset)
        return n_iter, (est, coords)

    def fit_once(params, resource=0, warm_start=None):
        n_iter, inst = _checkout(resource)
        try:
            est, coords = inst
            for coord, xi in zip(coords, np.asarray(params, float).ravel()):
                coord.reg_weight = float(xi)
            model, _ = est.fit_coordinates(coords, response, weight, offset,
                                           evaluator)
        finally:
            with pool_lock:
                pools[n_iter].append(inst)
        scores = GameTransformer(model).transform(v_shards, v_ids, v_offset)
        metric, all_metrics = suite.evaluate_primary(
            scores, v_resp, v_weight, group_ids=v_groups)
        return metric, all_metrics, None

    fit_once.suite = suite
    fit_once.larger_is_better = evaluator.larger_is_better
    fit_once.names = names
    return fit_once


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="game_training_driver",
        description="PyTorch/CUDA GAME training driver",
    )
    p.add_argument("--train-data", required=True, help="GAME Avro file")
    p.add_argument("--validate-data", help="GAME Avro validation file")
    p.add_argument("--config", required=True, help="coordinate config JSON")
    p.add_argument("--output-dir", required=True)
    p.add_argument(
        "--resume",
        action="store_true",
        help="continue coordinate descent (or the config grid) from the "
        "checkpoint in the output dir (bit-exact with the uninterrupted run)",
    )
    p.add_argument(
        "--initial-model",
        help="saved GameModel directory to warm-start from (incremental "
        "training); its index maps are used to read the data",
    )
    p.add_argument(
        "--locked-coordinates",
        help="comma-separated coordinate names held at --initial-model "
        "instead of retrained (partial retraining)",
    )
    p.add_argument(
        "--data-parallel",
        choices=["off", "auto"],
        default="off",
        help="auto: shard over the ranks of a torch.distributed process "
        "group when one with more than one rank forms (one card a rank; "
        "rank 0 writes the outputs); a single process trains as with off",
    )
    p.add_argument(
        "--pipeline-coordinates",
        action="store_true",
        help="fire the next coordinate's prestage hint before each update "
        "(the reference's overlap schedule); bitwise identical to serial",
    )
    p.add_argument(
        "--device-metrics",
        action="store_true",
        help="compute per-update train/validation metrics on the device "
        "(only metric scalars cross to the host; an evaluator with no "
        "device version reads the scores back and runs on the host); "
        "needs an ungrouped suite",
    )
    p.add_argument(
        "--max-retries",
        type=int,
        default=0,
        help="re-enter the fit after a transient failure (a dropped "
        "transport, a preemption) up to this many times, resuming from the "
        "CD or grid checkpoint; 0 disables",
    )
    p.add_argument(
        "--retry-backoff",
        type=float,
        default=5.0,
        help="initial seconds between retries (x2 per attempt, capped at "
        "300 s)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device for the datasets, the descent and the "
        "validation scorers (cuda | cpu)",
    )
    add_telemetry_args(p)
    return p


def run(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_arg_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    from photon_ml_tpu_torch.parallel import multihost

    with PhotonLogger(args.output_dir) as logger, multihost.driver_group(
            logger, args.device) as world:
        # The reference forms a mesh only over more than one device.
        mesh = (multihost.global_data_mesh()
                if args.data_parallel == "auto" and world > 1 else None)
        with driver_telemetry(args, logger, "game_training_driver",
                              writer=mesh is None or mesh.rank == 0) as tel:
            return _run_impl(args, logger, mesh, tel)


class _ReadOnly:
    """A checkpointer for the ranks that do not write: reads through to the
    one rank 0 writes, saves and clears nothing."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def save(self, *args, **kwargs) -> None:
        return None

    save_point = save

    def clear(self) -> None:
        return None


def _suite_from_config(config: dict, task: str) -> EvaluationSuite:
    """The reference's evaluator list: ``evaluators`` or ``evaluator``, the
    first driving selection, grouped by ``evaluator_group_column``."""
    group_column = config.get("evaluator_group_column")
    if "evaluators" in config:
        return EvaluationSuite.from_specs(config["evaluators"],
                                          group_column=group_column)
    if "evaluator" in config:
        return EvaluationSuite.from_specs([config["evaluator"]],
                                          group_column=group_column)
    suite = EvaluationSuite.for_task(losses_lib.get(task).name)
    if group_column is not None:
        suite = dataclasses.replace(suite, group_column=group_column)
    return suite


def _run_impl(args, logger, mesh=None, tel=None) -> dict:
    tel = telemetry.current() if tel is None else tel
    timer = Timer().start()
    device = resolve_device(args.device)
    writer = mesh is None or mesh.rank == 0
    if mesh is not None:
        logger.info("data-parallel: rank %d of %d (%s)", mesh.rank,
                    mesh.size, mesh.backend)

    with open(args.config) as f:
        config = json.load(f)
    task = config.get("task", "logistic")
    config_grid = expand_config_grid(config["coordinates"])
    coordinate_configs = config_grid[0]
    suite = _suite_from_config(config, task)
    evaluator = suite.primary_evaluator

    locked = tuple(s.strip() for s in (args.locked_coordinates or "")
                   .split(",") if s.strip())
    if locked and not args.initial_model:
        raise SystemExit("--locked-coordinates requires --initial-model")
    if locked and len(config_grid) > 1:
        raise SystemExit(
            "--locked-coordinates is single-config only (a locked "
            "coordinate has nothing to sweep)")

    # Incremental training: a prior model fixes the feature index maps, and
    # the data is read through them so coefficients line up column for
    # column with the saved model.
    initial_model = None
    # Host seconds of each stage, and the decoder that read each file.
    stages: dict = {}
    decoders = {"train": {}}
    read_timer = Timer().start()
    with tel.span("read", path=args.train_data):
        if args.initial_model:
            initial_model, initial_imaps = load_game_model(args.initial_model,
                                                           device=device)
            shards, ids, response, weight, offset, _, _ = read_game_avro(
                args.train_data, index_maps=initial_imaps, logger=logger,
                stats=decoders["train"])
            index_maps = initial_imaps
            logger.info("incremental training from %s", args.initial_model)
        else:
            shards, ids, response, weight, offset, _, index_maps = (
                read_game_avro(args.train_data, stats=decoders["train"]))
    stages["read train"] = read_timer.stop()
    logger.info(
        "read %d rows in %.3fs; shards: %s; id columns: %s", len(response),
        stages["read train"], {k: v.shape for k, v in shards.items()},
        list(ids),
    )

    # Optional per-shard feature summaries (Avro artifacts).
    if config.get("feature_summaries", False) and writer:
        from photon_ml_tpu_torch.data.stats import summarize_host
        from photon_ml_tpu_torch.io.summary_store import save_feature_summary

        summary_dir = os.path.join(args.output_dir, "feature-summaries")
        os.makedirs(summary_dir, exist_ok=True)
        for shard_name, shard_matrix in shards.items():
            save_feature_summary(
                summarize_host(shard_matrix, weight),
                index_maps[shard_name],
                os.path.join(summary_dir, f"{shard_name}.avro"),
            )
        logger.info("wrote feature summaries for %s", sorted(shards))

    n_cd_iterations = int(config.get("iterations", 1))
    validation = None
    if args.validate_data:
        read_timer = Timer().start()
        decoders["validation"] = {}
        with tel.span("read", path=args.validate_data, validation=True):
            validation = read_game_avro(args.validate_data,
                                        index_maps=index_maps, logger=logger,
                                        stats=decoders["validation"])
        stages["read validation"] = read_timer.stop()
        logger.info("read %d validation rows in %.3fs",
                    len(validation[2]), stages["read validation"])
    result = {"task": task, "n_rows": int(len(response))}

    tuning = config.get("tuning")
    if tuning:
        if locked:
            # A search refits every coordinate per point: a locked one would
            # be retrained during the search and locked only in the final
            # fit.
            raise SystemExit(
                "--locked-coordinates is incompatible with tuning mode")
        if validation is None:
            raise ValueError("hyperparameter tuning requires --validate-data")
        tune_timer = Timer().start()
        coordinate_configs, result["tuning"] = _tune(
            task, coordinate_configs, tuning, n_cd_iterations, suite,
            shards, ids, response, weight, offset, validation, args, device,
            mesh, logger)
        config_grid = [coordinate_configs]  # tuning supersedes any grid
        stages["tuning"] = tune_timer.stop()

    val_tuple = None
    if validation is not None:
        v_shards, v_ids, v_resp, v_weight, v_offset, _, _ = validation
        val_tuple = (v_shards, v_ids, v_resp, v_weight, v_offset)

    # Checkpointing: per CD iteration for a single config, per grid point
    # for a config grid (a finished point's model persists).
    checkpointer = None
    grid_checkpointer = None
    if bool(config.get("checkpoint", True)):
        ckpt_dir = os.path.join(args.output_dir, "checkpoints")
        if len(config_grid) == 1:
            checkpointer = CoordinateDescentCheckpointer(ckpt_dir)
            if not args.resume:
                # A stale checkpoint from a previous job must not silently
                # hijack a fresh run.
                checkpointer.clear()
        else:
            grid_checkpointer = GameGridCheckpointer(ckpt_dir, index_maps,
                                                     device=device)
            if not args.resume:
                grid_checkpointer.clear()
    elif args.resume:
        raise ValueError(
            '--resume requires checkpointing ("checkpoint": false is set '
            "in the config JSON)")
    if mesh is not None:
        # One rank keeps the checkpoints; every rank resumes from them, so
        # no rank may read before rank 0 has cleared a stale one.
        if not writer:
            checkpointer = checkpointer and _ReadOnly(checkpointer)
            grid_checkpointer = (grid_checkpointer
                                 and _ReadOnly(grid_checkpointer))
        import torch.distributed as dist

        dist.barrier()

    estimator = GameEstimator(
        task, coordinate_configs, n_iterations=n_cd_iterations,
        logger=logger, device_metrics=args.device_metrics,
        pipeline=args.pipeline_coordinates, device=device, mesh=mesh,
    )
    # A retry re-enters the fit, which resumes from the checkpoint: the CD
    # loop reloads it on entry, and the grid skips its finished points.
    retry_policy = RetryPolicy(max_retries=args.max_retries,
                               backoff_seconds=args.retry_backoff)
    retry_stats = RetryStats()
    fit_timer = Timer().start()
    if len(config_grid) > 1:
        with tel.span("train", grid_points=len(config_grid),
                      cd_iterations=n_cd_iterations):
            model, grid_results = run_with_retries(
                lambda attempt: estimator.fit_grid(
                    config_grid, shards, ids, response, weight=weight,
                    offset=offset, validation=val_tuple, suite=suite,
                    initial_model=initial_model,
                    grid_checkpointer=grid_checkpointer,
                ),
                retry_policy, logger, stats=retry_stats,
            )
        best = next(r for r in grid_results if r["best"])
        history = best["history"]
        result["grid"] = [
            {
                "grid_index": r["grid_index"],
                "reg_weights": {nm: cfg.reg_weight
                                for nm, cfg in r["configs"].items()},
                "metric": r["metric"],
                "selected_by": r["selected_by"],
                "best": r["best"],
            }
            for r in grid_results
        ]
        logger.info("config grid: %d points, best index %d (%s = %s)",
                    len(grid_results), best["grid_index"],
                    best["selected_by"], best["metric"])
    else:
        with tel.span("train", cd_iterations=n_cd_iterations):
            model, history = run_with_retries(
                lambda attempt: estimator.fit(
                    shards, ids, response, weight=weight, offset=offset,
                    validation=val_tuple, suite=suite,
                    initial_model=initial_model, checkpointer=checkpointer,
                    locked_coordinates=locked,
                ),
                retry_policy, logger, stats=retry_stats,
            )
    stages["fit"] = fit_timer.stop()
    logger.info("fit %.3fs (%d coordinate updates)", stages["fit"],
                len(history))
    result["history"] = history
    result["train_metric"] = (history[-1].get("train_metric") if history
                              else None)
    if history and "validation" in history[-1]:
        result["per_iteration_validation"] = True
        result["validation_suite"] = history[-1]["validation"]

    if validation is not None:
        final_timer = Timer().start()
        with tel.span("validate", rows=int(len(v_resp))):
            v_scores = GameTransformer(model).transform(v_shards, v_ids,
                                                        v_offset)
            v_groups = (np.asarray(v_ids[suite.group_column])
                        if suite.group_column is not None else None)
            result["validation_metric"] = evaluator.evaluate(
                v_scores, v_resp, v_weight, group_ids=v_groups)
        stages["final validation transform and metric"] = final_timer.stop()
        logger.info("validation %s = %.6f", type(evaluator).__name__,
                    result["validation_metric"])

    save_timer = Timer().start()
    with tel.span("write"):
        if writer:
            save_game_model(model, index_maps,
                            os.path.join(args.output_dir, "models"))
    stages["model save"] = save_timer.stop()
    if retry_stats.retries or retry_stats.failures:
        result["retry"] = retry_stats.snapshot()
    result["stage_seconds"] = {**stages, **estimator.stage_seconds}
    result["decoders"] = {k: v["decoder"] for k, v in decoders.items()}
    if mesh is not None:
        result["data_parallel"] = {"ranks": mesh.size, "rank": mesh.rank}
    result["wall_seconds"] = timer.stop()
    if writer:
        with open(os.path.join(args.output_dir, "training_result.json"),
                  "w") as f:
            json.dump(result, f, indent=2)
    tel.gauge("run_wall_seconds").set(result["wall_seconds"])
    logger.info("GAME training done in %.2fs", result["wall_seconds"])
    return result


def _tune(task, coordinate_configs, tuning, n_cd_iterations, suite, shards,
          ids, response, weight, offset, validation, args, device, mesh,
          logger):
    """The tuning mode's search over :func:`make_fit_once` (datasets built
    once, no variances a point): ``(configs at the best point, the
    result's "tuning" entry)``."""
    from photon_ml_tpu_torch.hyperparameter.search import (
        GaussianProcessSearch,
        RandomSearch,
    )

    names = list(coordinate_configs)
    lo, hi = tuning.get("range", [1e-3, 1e3])
    fit_once = make_fit_once(
        task, coordinate_configs, shards, ids, response, validation[:5],
        weight=weight, offset=offset, suite=suite,
        device_metrics=args.device_metrics, device=device, mesh=mesh)

    def evaluate(x):
        metric = fit_once(x, n_cd_iterations)[0]
        logger.info("tuning: reg=%s -> %.6f", list(map(float, x)), metric)
        return metric

    mode = tuning.get("mode", "bayesian")
    search_cls = GaussianProcessSearch if mode == "bayesian" else RandomSearch
    search = search_cls([(lo, hi)] * len(names), log_scale=True, seed=0)
    iterations = int(tuning.get("iterations", 10))
    with telemetry.current().span("tuning", mode=mode,
                                  iterations=iterations):
        found = search.find(evaluate, iterations,
                            maximize=fit_once.larger_is_better)
    best = {nm: float(xi) for nm, xi in zip(names, found.best_params)}
    logger.info("tuning selected %s", best)
    configs = {nm: dataclasses.replace(coordinate_configs[nm],
                                       reg_weight=best[nm])
               for nm in names}
    return configs, {"best_reg_weights": best,
                     "best_metric": found.best_value,
                     "n_evaluations": len(found.history)}


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
