"""Tuning CLI: selfcheck + parallel resumable search over both drivers
(port of ``photon_ml_tpu/tuning/__main__.py``).

Selfcheck (on the card; ``--device cpu`` for the plain versions)::

    python -m photon_ml_tpu_torch.tuning --selfcheck

runs a parallel (4-worker) ASHA+GP search on a synthetic GAME workload,
KILLS it mid-flight at a journal record boundary, resumes from
``tuning_state.jsonl``, and asserts the resumed search's trial history
and journal decision sequence are identical to an uninterrupted run's;
a second deterministic search exercises the executor's crash vocabulary
(one transient failure retried in place, one fatal trial that fails
without sinking the sweep, ASHA pruning) and the telemetry snapshot is
checked for per-trial spans and the started/pruned/failed counters.

Search a GLM λ (LIBSVM data)::

    python -m photon_ml_tpu_torch.tuning --driver glm \
        --train-data a1a --validate-data a1a.t --task logistic \
        --reg-type l2 --trials 16 --workers 4 --asha \
        --output-dir /tmp/tune_out

Search per-coordinate GAME regularization weights (Avro + config JSON,
the same config the training driver takes)::

    python -m photon_ml_tpu_torch.tuning --driver game \
        --train-data train.avro --validate-data val.avro \
        --config config.json --trials 24 --workers 4 \
        --output-dir /tmp/tune_game

A killed search continues with ``--resume`` (refused if the search
space or configuration changed).  Results land in
``tuning_result.json``; the journal, per-trial coefficient files,
events.jsonl / metrics.json all live in the output dir.  Every fit runs
on ``--device`` (the card unless ``cpu`` is asked for), trials sharing
it from their threads.  ``--metrics-port`` mounts the live ops plane
(``/metrics``, ``/snapshot``, ``/healthz``) beside the search, and
``--metrics-interval-s`` paces its ``metrics_ts.jsonl`` sampler.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.tuning",
        description="parallel, resumable hyperparameter search",
    )
    p.add_argument("--selfcheck", action="store_true")
    p.add_argument("--driver", choices=["glm", "game"])
    p.add_argument("--train-data", help="LIBSVM (glm) or GAME Avro (game)")
    p.add_argument("--validate-data", help="held-out data (required)")
    p.add_argument("--config", help="game: coordinate config JSON")
    p.add_argument("--task", default="logistic", help="glm: task type")
    p.add_argument("--reg-type", default="l2", help="glm: regularization")
    p.add_argument("--optimizer", default="lbfgs", help="glm")
    p.add_argument("--solver", help="glm: registered solver name "
                   "(lbfgs|owlqn|tron|admm|block_cd); unset keeps the "
                   "historical routing bitwise")
    p.add_argument("--max-iters", type=int, default=100, help="glm: full-"
                   "resource iteration budget (non-ASHA trials)")
    p.add_argument("--n-features", type=int, help="glm: fixed width")
    p.add_argument("--output-dir", help="journal + results + telemetry")
    p.add_argument("--trials", type=int, default=16)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--proposer", choices=["gp", "random"], default="gp")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--range", default="1e-3,1e3",
        help="lo,hi regularization-weight bounds (log-scaled)",
    )
    p.add_argument("--asha", action="store_true",
                   help="successive halving on intermediate rung metrics")
    p.add_argument("--min-resource", type=int, default=None,
                   help="ASHA rung-0 resource (glm: optimizer iterations, "
                   "default 10; game: CD iterations, default 1)")
    p.add_argument("--reduction-factor", type=int, default=3)
    p.add_argument("--num-rungs", type=int, default=3)
    p.add_argument("--resume", action="store_true",
                   help="replay tuning_state.jsonl and continue the search")
    p.add_argument("--max-retries", type=int, default=2,
                   help="bounded in-place retries of TRANSIENT trial "
                   "failures (watchdog classification)")
    p.add_argument("--no-warm-start", action="store_true")
    p.add_argument("--warm-start-dir",
                   help="published model (GLM .avro or GAME dir) whose "
                   "fixed-effect coefficients seed trials before any "
                   "completed trial exists — chain a search onto the "
                   "freshest published model")
    p.add_argument("--no-fsync", action="store_true",
                   help="skip the per-record journal fsync (faster, "
                   "crash-safety reduced to flush)")
    p.add_argument("--telemetry", choices=["on", "off"], default="on")
    p.add_argument("--device", default="cuda",
                   help="torch device of every fit (default: the card; "
                   "'cpu' runs the kernels' plain versions)")
    p.add_argument(
        "--metrics-port", type=int, default=None,
        help="expose the live ops plane on this port (/metrics "
        "Prometheus exposition, /snapshot JSON); 0 = ephemeral; omit "
        "to disable",
    )
    p.add_argument(
        "--metrics-interval-s", type=float, default=1.0,
        help="metrics_ts.jsonl sampling interval (0 disables)",
    )
    return p


# ---------------------------------------------------------------------------
# Synthetic GAME workload (selfcheck + tests)
# ---------------------------------------------------------------------------

def synthetic_game_problem(
    seed: int = 0,
    n_users: int = 10,
    rows_per_user: tuple = (6, 18),
    d_global: int = 4,
    d_user: int = 2,
):
    """Mixed-effects logistic data split train/validation: y ~
    sigmoid(x_g·w_g + x_u·w_user[u]).  Returns (train, validation) where
    train = (shards, ids, response) and validation additionally carries
    (weight=None, offset=None) — the tuple make_fit_once takes."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    wg = rng.normal(size=d_global)
    w_users = {
        f"user_{u}": 2.0 * rng.normal(size=d_user) for u in range(n_users)
    }

    def draw(frac: float):
        rows, user_ids = [], []
        for u in range(n_users):
            k = max(2, int(rng.integers(*rows_per_user) * frac))
            rows.append(k)
            user_ids.extend([f"user_{u}"] * k)
        n = sum(rows)
        Xg = rng.normal(size=(n, d_global)).astype(np.float32)
        Xu = rng.normal(size=(n, d_user)).astype(np.float32)
        margins = Xg @ wg + np.array(
            [Xu[i] @ w_users[user_ids[i]] for i in range(n)]
        )
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margins))).astype(
            np.float32
        )
        shards = {
            "global": sp.csr_matrix(Xg), "per_user": sp.csr_matrix(Xu)
        }
        return shards, {"userId": np.array(user_ids)}, y

    t_shards, t_ids, t_y = draw(1.0)
    v_shards, v_ids, v_y = draw(0.6)
    return (t_shards, t_ids, t_y), (v_shards, v_ids, v_y, None, None)


def synthetic_game_fit_once(seed: int = 0, device=None):
    """A ready-to-search GAME trial function over the synthetic problem,
    fitting on ``device``."""
    from photon_ml_tpu_torch.drivers.game_training_driver import make_fit_once
    from photon_ml_tpu_torch.game.estimator import (
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import RegularizationContext

    (shards, ids, y), validation = synthetic_game_problem(seed)
    opt = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=25, tolerance=1e-6),
        regularization=RegularizationContext.l2(),
    )
    configs = {
        "fixed": FixedEffectCoordinateConfig("global", opt, reg_weight=1.0),
        "per_user": RandomEffectCoordinateConfig(
            "per_user", "userId", opt, reg_weight=1.0
        ),
    }
    return make_fit_once(
        "logistic", configs, shards, ids, y, validation, device=device
    )


# ---------------------------------------------------------------------------
# Selfcheck
# ---------------------------------------------------------------------------

def _journal_decisions(journal) -> list[dict]:
    """The journal's state-bearing records with run-local noise (wall
    clocks, resume markers) stripped — the replay-parity comparison key."""
    from photon_ml_tpu_torch.tuning.state import STATE_RECORD_TYPES

    out = []
    for rec in journal.read():
        if rec.get("type") not in STATE_RECORD_TYPES:
            continue
        rec = dict(rec)
        rec.pop("wall", None)
        rec.pop("wall_epoch", None)
        out.append(rec)
    return out


def run_selfcheck(out_dir: str, device=None) -> list[str]:
    """Returns failure strings (empty = pass).  The GAME search fits on
    ``device``."""
    from photon_ml_tpu_torch import telemetry as telemetry_mod
    from photon_ml_tpu_torch.tuning.executor import (
        TuningConfig,
        TuningOrchestrator,
    )
    from photon_ml_tpu_torch.tuning.scheduler import (
        AshaConfig,
        GPProposer,
        GridProposer,
        SearchSpace,
    )
    from photon_ml_tpu_torch.tuning.state import SearchAborted, TuningJournal
    from photon_ml_tpu_torch.utils.watchdog import RetryPolicy

    failures: list[str] = []
    with telemetry_mod.Telemetry(
        output_dir=out_dir, run_name="tuning-selfcheck"
    ) as tel:
        with tel.span("selfcheck", subsystem="tuning"):
            fit_once = synthetic_game_fit_once(seed=11, device=device)
            space = SearchSpace.create(
                [(1e-2, 1e2)] * 2, log_scale=True,
                names=["fixed", "per_user"],
            )
            cfg = TuningConfig(
                max_trials=6,
                workers=4,
                maximize=fit_once.larger_is_better,
                asha=AshaConfig(
                    min_resource=1, reduction_factor=2, num_rungs=2
                ),
                retry=RetryPolicy(max_retries=1),
                sleep=lambda s: None,
            )

            def search(subdir, abort_after=None, resume=False):
                journal = TuningJournal(
                    os.path.join(out_dir, subdir), abort_after=abort_after
                )
                orch = TuningOrchestrator(
                    space, fit_once, GPProposer(space, seed=7), cfg, journal
                )
                try:
                    return orch.run(resume=resume), journal
                finally:
                    journal.close()

            # Uninterrupted reference run.
            result_a, journal_a = search("search_a")
            n_records = len(journal_a.read())

            # Same search, killed mid-flight at a record boundary…
            killed = False
            try:
                search("search_b", abort_after=max(2, n_records // 2))
            except SearchAborted:
                killed = True
            if not killed:
                failures.append(
                    f"abort hook never fired ({n_records} records in the "
                    "uninterrupted journal)"
                )
            # …and resumed from the journal.
            result_b, journal_b = search("search_b", resume=True)

            if result_a.trials != result_b.trials:
                failures.append(
                    "resumed trial history differs from the uninterrupted "
                    f"run:\n  uninterrupted: {result_a.trials}\n  "
                    f"resumed: {result_b.trials}"
                )
            if (result_a.best_trial, result_a.best_metric) != (
                result_b.best_trial, result_b.best_metric
            ):
                failures.append(
                    f"best-trial mismatch: {result_a.best_trial}/"
                    f"{result_a.best_metric} vs {result_b.best_trial}/"
                    f"{result_b.best_metric}"
                )
            dec_a = _journal_decisions(journal_a)
            dec_b = _journal_decisions(journal_b)
            if dec_a != dec_b:
                first = next(
                    (i for i, (a, b) in enumerate(zip(dec_a, dec_b))
                     if a != b),
                    min(len(dec_a), len(dec_b)),
                )
                failures.append(
                    "journal replay mismatch at state record "
                    f"{first}: {dec_a[first:first + 1]} vs "
                    f"{dec_b[first:first + 1]}"
                )
            if result_a.pruned + result_a.completed + result_a.failed == 0:
                failures.append("search produced no terminal trials")

            # Crash vocabulary: deterministic grid with one transient
            # failure (retried in place) and one fatal trial.
            attempts: dict[float, int] = {}
            attempt_lock = threading.Lock()

            def crashy(params, resource=0, warm_start=None):
                x = float(np.asarray(params).ravel()[0])
                with attempt_lock:
                    n = attempts[x] = attempts.get(x, 0) + 1
                if abs(x - 0.95) < 1e-9:
                    raise ValueError("synthetic fatal trial failure")
                if abs(x - 0.7) < 1e-9 and n == 1:
                    raise RuntimeError(
                        "UNAVAILABLE: synthetic transport drop"
                    )
                return -((x - 0.3) ** 2)

            grid = [0.3, 0.9, 0.1, 0.7, 0.5, 0.95]
            c_space = SearchSpace.create([(0.0, 1.0)], names=["x"])
            c_journal = TuningJournal(os.path.join(out_dir, "search_c"))
            c_cfg = TuningConfig(
                max_trials=len(grid),
                workers=2,
                maximize=True,
                asha=AshaConfig(
                    min_resource=1, reduction_factor=2, num_rungs=2
                ),
                retry=RetryPolicy(max_retries=2),
                sleep=lambda s: None,
            )
            result_c = TuningOrchestrator(
                c_space, crashy,
                GridProposer(c_space, [[x] for x in grid]),
                c_cfg, c_journal,
            ).run()
            c_journal.close()
            if result_c.failed != 1:
                failures.append(
                    f"expected exactly 1 fatal trial, got {result_c.failed}"
                )
            if result_c.pruned < 1:
                failures.append(
                    f"expected ASHA pruning, got {result_c.pruned} pruned"
                )
            if attempts.get(0.7) != 2:
                failures.append(
                    "transient failure was not retried exactly once "
                    f"(attempts: {attempts.get(0.7)})"
                )
            best_x = (
                None if result_c.best_params is None
                else result_c.best_params[0]
            )
            if best_x != 0.3:
                failures.append(
                    f"crash-vocabulary search selected {best_x}, "
                    "expected 0.3"
                )
        snap = tel.snapshot()

    # Telemetry contract: per-trial spans in events.jsonl, trial
    # counters + best-metric gauge in metrics.json.
    counters = snap["counters"]
    for name in (
        "tuning_trials_started", "tuning_trials_pruned",
        "tuning_trials_failed", "tuning_trial_retries",
    ):
        if not counters.get(name):
            failures.append(f"metrics counter {name} is missing or zero")
    if snap["gauges"].get("tuning_best_metric") is None:
        failures.append("tuning_best_metric gauge never set")
    events_path = os.path.join(out_dir, "events.jsonl")
    trial_spans = 0
    if os.path.exists(events_path):
        with open(events_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("type") == "span" and rec.get("name") == \
                        "tuning.trial":
                    trial_spans += 1
    if not trial_spans:
        failures.append("no tuning.trial spans in events.jsonl")
    metrics_path = os.path.join(out_dir, "metrics.json")
    if not os.path.exists(metrics_path):
        failures.append(f"missing {metrics_path}")
    else:
        with open(metrics_path) as f:
            on_disk = json.load(f)
        if "tuning_trials_pruned" not in on_disk.get("counters", {}):
            failures.append(
                "metrics.json lacks the tuning_trials_pruned counter"
            )
    if not failures:
        print(
            f"tuning selfcheck: {result_a.n_trials}-trial parallel "
            f"ASHA+GP search killed at record "
            f"{max(2, n_records // 2)}/{n_records} resumed bit-identically "
            f"({result_a.completed} completed, {result_a.pruned} pruned); "
            f"crash search: {result_c.failed} fatal / "
            f"{attempts.get(0.7, 0) - 1} transient retry / "
            f"{result_c.pruned} pruned; {trial_spans} tuning.trial spans"
        )
    return failures


# ---------------------------------------------------------------------------
# Driver searches
# ---------------------------------------------------------------------------

def _build_search(args):
    """(fit_once, space) for the selected driver."""
    if not args.train_data or not args.validate_data:
        raise SystemExit("--driver requires --train-data and --validate-data")
    lo, hi = (float(s) for s in args.range.split(","))
    if args.driver == "glm":
        from photon_ml_tpu_torch.data import libsvm
        from photon_ml_tpu_torch.drivers.glm_driver import make_fit_once

        X_train, y_train = libsvm.read_libsvm(
            args.train_data, n_features=args.n_features, add_intercept=True
        )
        X_val, y_val = libsvm.read_libsvm(
            args.validate_data,
            n_features=X_train.shape[1] - 1,
            add_intercept=True,
            drop_out_of_range=True,
        )
        fit_once = make_fit_once(
            X_train, y_train, X_val, y_val,
            task=args.task, reg_type=args.reg_type,
            optimizer=args.optimizer, max_iters=args.max_iters,
            solver=args.solver, device=args.device,
        )
        from photon_ml_tpu_torch.tuning.scheduler import SearchSpace

        return fit_once, SearchSpace.create(
            [(lo, hi)], log_scale=True, names=["lambda"]
        )
    # game
    if not args.config:
        raise SystemExit("--driver game requires --config")
    from photon_ml_tpu_torch.data.game_reader import read_game_avro
    from photon_ml_tpu_torch.drivers.game_training_driver import (
        make_fit_once,
        parse_coordinate_config,
    )
    from photon_ml_tpu_torch.tuning.scheduler import SearchSpace

    with open(args.config) as f:
        config = json.load(f)
    configs = dict(
        parse_coordinate_config(spec) for spec in config["coordinates"]
    )
    shards, ids, response, weight, offset, _, index_maps = read_game_avro(
        args.train_data
    )
    v = read_game_avro(args.validate_data, index_maps=index_maps)
    fit_once = make_fit_once(
        config.get("task", "logistic"), configs, shards, ids, response,
        (v[0], v[1], v[2], v[3], v[4]), weight=weight, offset=offset,
        device=args.device,
    )
    return fit_once, SearchSpace.create(
        [(lo, hi)] * len(configs), log_scale=True, names=list(configs)
    )


def run_search(args) -> dict:
    from photon_ml_tpu_torch import telemetry as telemetry_mod
    from photon_ml_tpu_torch.tuning.executor import (
        TuningConfig,
        TuningOrchestrator,
    )
    from photon_ml_tpu_torch.tuning.scheduler import AshaConfig, make_proposer
    from photon_ml_tpu_torch.tuning.state import TuningJournal
    from photon_ml_tpu_torch.utils.logging import PhotonLogger
    from photon_ml_tpu_torch.utils.watchdog import RetryPolicy

    if not args.output_dir:
        raise SystemExit("--output-dir is required")
    os.makedirs(args.output_dir, exist_ok=True)
    with PhotonLogger(args.output_dir) as logger:
        tel = telemetry_mod.Telemetry(
            output_dir=args.output_dir,
            logger=logger,
            enabled=args.telemetry != "off",
        )
        with tel, tel.span(
            "run", driver="tuning", mode=args.driver
        ), telemetry_mod.mount_ops_plane(
            tel, port=args.metrics_port,
            interval_s=args.metrics_interval_s, logger=logger,
        ):
            fit_once, space = _build_search(args)
            asha = None
            if args.asha:
                asha = AshaConfig(
                    min_resource=(
                        args.min_resource
                        if args.min_resource is not None
                        else (10 if args.driver == "glm" else 1)
                    ),
                    reduction_factor=args.reduction_factor,
                    num_rungs=args.num_rungs,
                )
            cfg = TuningConfig(
                max_trials=args.trials,
                workers=args.workers,
                maximize=fit_once.larger_is_better,
                resource=0 if args.driver == "game" else args.max_iters,
                asha=asha,
                retry=RetryPolicy(max_retries=args.max_retries),
                warm_start=not args.no_warm_start,
                warm_start_dir=args.warm_start_dir,
            )
            journal = TuningJournal(
                args.output_dir, fsync=not args.no_fsync
            )
            orch = TuningOrchestrator(
                space, fit_once, make_proposer(
                    args.proposer, space, seed=args.seed
                ),
                cfg, journal, logger=logger,
            )
            result = orch.run(resume=args.resume)
            journal.close()
            out = result.as_dict()
            out["space"] = space.to_config()
            out["primary_metric"] = fit_once.suite.primary
            with open(
                os.path.join(args.output_dir, "tuning_result.json"), "w"
            ) as f:
                json.dump(out, f, indent=2)
            logger.info(
                "search done: %d trials (%d completed, %d pruned, "
                "%d failed), best %s=%s at %s",
                result.n_trials, result.completed, result.pruned,
                result.failed, fit_once.suite.primary, result.best_metric,
                result.best_params,
            )
            return out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    from photon_ml_tpu_torch.device import resolve_device

    # Refuse a missing card here, not as one failed trial after another.
    resolve_device(args.device)
    if args.selfcheck:
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            failures = run_selfcheck(args.output_dir, args.device)
        else:
            with tempfile.TemporaryDirectory(
                prefix="photon_tuning_selfcheck_"
            ) as td:
                failures = run_selfcheck(td, args.device)
        if failures:
            print("tuning selfcheck FAILED:", file=sys.stderr)
            for f in failures:
                print(f"  - {f}", file=sys.stderr)
            return 1
        print("tuning selfcheck PASSED")
        return 0
    if not args.driver:
        raise SystemExit("one of --selfcheck / --driver is required")
    from photon_ml_tpu_torch.tuning.state import ResumeMismatch

    try:
        out = run_search(args)
    except ResumeMismatch as exc:
        # A refused resume is an operator decision point, not a crash.
        raise SystemExit(f"tuning: {exc}") from None
    print(json.dumps({
        "best_params": out["best_params"],
        "best_metric": out["best_metric"],
        "n_trials": out["n_trials"],
        "completed": out["completed"],
        "pruned": out["pruned"],
        "failed": out["failed"],
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
