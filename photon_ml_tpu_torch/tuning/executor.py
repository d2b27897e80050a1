"""Trial orchestration: bounded parallel execution, warm starts, resume
(port of ``photon_ml_tpu/tuning/executor.py``).

``TuningOrchestrator`` owns the search loop that hyperparameter/
search.py's ``find`` used to run inline: it asks a proposer
(tuning/scheduler.py) for points, runs trials CONCURRENTLY on a bounded
thread pool, feeds intermediate rung metrics to ASHA, journals every
decision (tuning/state.py), and survives kills via ``resume=True``.

Determinism contract (what makes "resume == uninterrupted" testable and
the selfcheck's bit-parity assertion honest): the loop is
batch-synchronous.  Each iteration forms a WAVE — the first ``workers``
runnable rung-tasks in trial-id order — runs it fully in parallel, then
processes the results in trial-id order.  Thread completion ORDER
therefore never reaches the search state: proposals, ASHA decisions,
warm-start choices, and the journal's state-bearing records are a pure
function of (space, seed, config, trial_fn) alone.  A resumed search
replays the journal to the crash point and continues through the exact
decision sequence the uninterrupted run would have taken — Snap ML's
hierarchical-parallelism observation (arXiv:1803.06333) that many
independent GLM fits are a throughput problem, without giving up
replayability.

Trials are plain callables::

    trial_fn(params, resource, warm_start) -> TrialReport | (metric, metrics, coefficients) | metric

``resource`` is the rung budget (optimizer iterations / CD iterations);
``warm_start`` is a coefficient vector or None.  Warm starts chain two
ways, after "Distributed Coordinate Descent for GLMs with
Regularization" (arXiv:1611.02101)'s λ-path warm starts: a promoted
trial continues from its OWN previous rung's coefficients, and a fresh
trial starts from the nearest COMPLETED trial's coefficients in the
normalized search space (ties to the lower trial id).

Crashes go through the watchdog vocabulary (utils/watchdog.py):
transient verdicts retry in place with bounded backoff; fatal verdicts
mark the trial failed and the search continues — one bad trial never
sinks the sweep.  A trial that fails on the card fails as the watchdog
classifies the CUDA error; nothing moves it to another device.

Trials of one wave run in threads that share the card and its default
stream: the trial functions the port builds (the drivers'
``make_fit_once``) guard their shared caches with locks, and the kernel
launch counts are taken under one (``ops/_kernels.py::count_launch``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Optional

import numpy as np

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.tuning.scheduler import (
    AshaConfig,
    AshaScheduler,
    Proposer,
    SearchSpace,
)
from photon_ml_tpu_torch.tuning.state import (
    JOURNAL_VERSION,
    ReplayState,
    ResumeMismatch,
    TrialStore,
    TuningJournal,
    replay_journal,
)
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.utils.watchdog import RetryPolicy


@dataclasses.dataclass
class TrialReport:
    """What one rung execution returns.  ``metric`` is in the CALLER's
    convention (``TuningConfig.maximize`` tells the orchestrator which
    way is up); ``metrics`` is the full evaluation-suite dict journaled
    with the rung report; ``coefficients`` feed warm starts and the
    trial store (None = this trial type has no warm-startable state)."""

    metric: float
    metrics: Optional[dict] = None
    coefficients: Optional[np.ndarray] = None


def _as_report(result) -> TrialReport:
    if isinstance(result, TrialReport):
        return result
    if isinstance(result, tuple):
        return TrialReport(*result)
    return TrialReport(float(result))


@dataclasses.dataclass
class Trial:
    id: int
    params: np.ndarray
    status: str = "running"  # running | completed | killed | failed
    rung: int = 0
    rung_metrics: dict = dataclasses.field(default_factory=dict)
    final_metric: Optional[float] = None
    coefficients: Optional[np.ndarray] = None  # latest rung's, host-side
    retries: int = 0
    error: Optional[str] = None

    def summary(self) -> dict:
        return {
            "id": self.id,
            "params": [float(v) for v in self.params],
            "status": self.status,
            "rung_metrics": {
                str(r): m for r, m in sorted(self.rung_metrics.items())
            },
            "final_metric": self.final_metric,
            "retries": self.retries,
            "error": self.error,
        }


@dataclasses.dataclass
class TuningConfig:
    """How the orchestrator runs the search.

    ``resource`` is what a non-ASHA trial receives as its rung budget
    (0 = trial_fn's own default); with ``asha`` set the rung geometry
    decides.  ``sleep`` is injectable so tests assert on retry behavior
    without timing real backoffs."""

    max_trials: int
    workers: int = 4
    maximize: bool = False
    resource: int = 0
    asha: Optional[AshaConfig] = None
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    warm_start: bool = True
    #: published model to SEED warm starts from (a saved GLM ``.avro``
    #: or a GAME model directory, whose fixed-effect means are used)
    #: when no completed trial is closer — chains a tuning run onto the
    #: freshest published model instead of cold-starting trial 1.
    warm_start_dir: Optional[str] = None
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        if self.max_trials < 1:
            raise ValueError("max_trials must be >= 1")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")


@dataclasses.dataclass
class TuningResult:
    best_trial: Optional[int]
    best_params: Optional[list]
    best_metric: Optional[float]
    n_trials: int
    completed: int
    pruned: int
    failed: int
    trials: list  # per-trial summaries, id order

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Task:
    trial: Trial
    rung: int
    # filled by the worker:
    report: Optional[TrialReport] = None
    exception: Optional[BaseException] = None
    transient: Optional[bool] = None
    wall: float = 0.0


class TuningOrchestrator:
    """One search run (fresh or resumed) over one trial function."""

    def __init__(
        self,
        space: SearchSpace,
        trial_fn: Callable,
        proposer: Proposer,
        config: TuningConfig,
        journal: TuningJournal,
        logger=None,
    ):
        self.space = space
        self.trial_fn = trial_fn
        self.proposer = proposer
        self.config = config
        self.journal = journal
        self.store = TrialStore(journal.directory)
        self.logger = logger
        self.sign = -1.0 if config.maximize else 1.0
        self.asha = AshaScheduler(config.asha) if config.asha else None
        self.trials: dict[int, Trial] = {}
        #: trial_id → (normalized params, coefficients) of COMPLETED
        #: trials — the cross-trial warm-start cache.
        self._completed_coefs: dict[int, tuple] = {}
        self._best: Optional[tuple] = None  # (y, trial_id) minimize-space
        self._counts = {"completed": 0, "pruned": 0, "failed": 0}
        #: on resume, the trials completed before the in-flight wave
        self._inflight_completed: frozenset = frozenset()

    # -- header / resume ----------------------------------------------------
    def _header(self) -> dict:
        return {
            "type": "header",
            "version": JOURNAL_VERSION,
            "fingerprint": self.space.fingerprint(),
            "space": self.space.to_config(),
            "maximize": self.config.maximize,
            "proposer": self.proposer.kind,
            "asha": (
                self.config.asha.to_config() if self.config.asha else None
            ),
            "resource": self.config.resource,
            "max_trials": self.config.max_trials,
            "workers": self.config.workers,
            "warm_start_dir": self.config.warm_start_dir,
            "wall_epoch": time.time(),
        }

    def _verify_header(self, header: dict) -> None:
        if header.get("fingerprint") != self.space.fingerprint():
            raise ResumeMismatch(
                "refusing to resume: the journal was written for a "
                f"different search space (journal fingerprint "
                f"{header.get('fingerprint')!r}, this run "
                f"{self.space.fingerprint()!r}) — clear "
                f"{self.journal.path} or rerun with the original space"
            )
        ours = self._header()
        for key in ("maximize", "proposer", "asha", "resource",
                    "max_trials", "workers", "warm_start_dir"):
            if header.get(key) != ours[key]:
                raise ResumeMismatch(
                    f"refusing to resume: journal {key}={header.get(key)!r} "
                    f"!= this run's {ours[key]!r} — the continuation would "
                    "not reproduce the uninterrupted search"
                )

    def _restore(self, replayed: ReplayState) -> list[_Task]:
        """Rebuild orchestrator + proposer + scheduler state from a
        replayed journal; returns the re-runnable tasks (the wave that
        was in flight when the run died)."""
        self._verify_header(replayed.header)
        self._inflight_completed = replayed.completed_before_wave
        for kind, *payload in replayed.proposer_events:
            if kind == "ask":
                self.proposer.restore_ask(payload[0])
            elif kind == "tell":
                self.proposer.tell(*payload)
            else:
                self.proposer.resolve(payload[0])
        if replayed.rng_state is not None:
            self.proposer.set_rng_state(replayed.rng_state)
        if self.asha is not None:
            for trial_id, rung, y in replayed.decided_reports:
                self.asha.record(trial_id, rung, y)
        for rt in sorted(replayed.trials.values(), key=lambda t: t.id):
            t = Trial(
                rt.id, rt.params, status=rt.status, rung=rt.rung,
                final_metric=rt.final_metric, error=rt.error,
            )
            t.rung_metrics = {
                int(r): rec["metric"] for r, rec in rt.reports.items()
            }
            # The last journaled rung's coefficients (see TrialStore).
            stored = (self.store.load(t.id, rung=max(rt.reports))
                      if rt.reports else None)
            if stored is not None:
                t.coefficients = stored[1]
            self.trials[t.id] = t
            # Result counts cover the WHOLE search, not just post-resume
            # activity (telemetry counters, by contrast, are per-process).
            if t.status == "killed":
                self._counts["pruned"] += 1
            elif t.status == "failed":
                self._counts["failed"] += 1
            elif t.status == "completed":
                self._counts["completed"] += 1
                y = self.sign * t.final_metric
                self._note_best(y, t.id)
                if t.coefficients is not None:
                    self._completed_coefs[t.id] = (
                        self.space.normalize(t.params)[0], t.coefficients
                    )
        # Re-derive the decisions the crash swallowed (report journaled,
        # promote/kill/tell not) — same order, same rule, journaled now.
        ready: list[_Task] = []
        for rec in replayed.undecided:
            trial = self.trials[rec["trial"]]
            report = TrialReport(
                rec["metric"], rec.get("metrics"), trial.coefficients
            )
            task = _Task(trial, int(rec["rung"]), report=report)
            self._apply_decision(task, journal_report=False, ready=ready)
        # Unfinished trials with no report at their current rung were in
        # flight (or queued).  The crash's IN-FLIGHT wave (the last
        # journaled wave record's unreported tasks) must re-run as one
        # wave of its own, in its original membership — merging it with
        # promotions the replay just re-derived would compress the
        # schedule relative to the uninterrupted run and change every
        # later proposal.  Everything else re-enters the ready queue.
        # (Trials the re-derived decisions above promoted are queued.)
        queued = {task.trial.id for task in ready}
        inflight_keys = {tuple(t) for t in replayed.last_wave}
        inflight: list[_Task] = []
        for t in sorted(self.trials.values(), key=lambda t: t.id):
            if (
                t.status == "running"
                and t.rung not in t.rung_metrics
                and t.id not in queued
            ):
                task = _Task(t, t.rung)
                if (t.id, t.rung) in inflight_keys:
                    inflight.append(task)
                else:
                    ready.append(task)
        self.journal.append(
            {"type": "resumed", "records": replayed.n_records}
        )
        if self.logger is not None:
            self.logger.info(
                "resumed tuning search: %d journal records, %d trials "
                "(%d completed, %d pruned, %d failed), %d in-flight + %d "
                "queued task(s)",
                replayed.n_records, len(self.trials),
                self._counts["completed"], self._counts["pruned"],
                self._counts["failed"], len(inflight), len(ready),
            )
        return ready, inflight

    # -- main loop ----------------------------------------------------------
    def run(self, resume: bool = False) -> TuningResult:
        tel = telemetry_mod.current()
        # Worker threads attach this context so every tuning.trial span
        # parents to the search's own span instead of rooting loose.
        self._trace_ctx = tel.current_context()
        ready: list[_Task] = []
        inflight: list[_Task] = []
        if resume:
            records = self.journal.read()
            if not records:
                raise ResumeMismatch(
                    f"--resume: no journal at {self.journal.path}"
                )
            ready, inflight = self._restore(replay_journal(records))
        else:
            if self.journal.exists():
                # A stale journal from a previous search must not survive
                # into a later --resume (same policy as the drivers'
                # checkpointers).
                self.journal.clear()
            # Stale trial_<id>.npz files likewise: a later resume would
            # warm-start an unreported trial from ANOTHER search's
            # coefficients.
            self.store.clear()
            self.journal.append(self._header())

        with ThreadPoolExecutor(
            max_workers=self.config.workers,
            thread_name_prefix="tuning-trial",
        ) as pool:
            if inflight:
                # Finish the crash's wave first, under its ORIGINAL
                # (journaled) membership — no new wave record.
                self._execute_wave(pool, inflight, ready, tel,
                                   completed=self._inflight_completed)
            while True:
                while (
                    len(ready) < self.config.workers
                    and len(self.trials) < self.config.max_trials
                    and not self.proposer.exhausted()
                ):
                    ready.append(self._ask(tel))
                if not ready:
                    break
                ready.sort(key=lambda task: task.trial.id)
                wave, ready = (
                    ready[: self.config.workers],
                    ready[self.config.workers :],
                )
                self.journal.append({
                    "type": "wave",
                    "tasks": [
                        [task.trial.id, task.rung] for task in wave
                    ],
                })
                self._execute_wave(pool, wave, ready, tel)
        return self._result()

    def _execute_wave(
        self, pool, wave: list, ready: list, tel, completed=None
    ) -> None:
        """Run ``wave`` in parallel, then process it in trial-id order.
        ``completed`` limits the warm-start cache to those trials (the
        cache a resumed in-flight wave was first submitted with)."""
        cache = (self._completed_coefs if completed is None else
                 {k: v for k, v in self._completed_coefs.items()
                  if k in completed})
        futures = [pool.submit(self._run_task, task, cache)
                   for task in wave]
        wait(futures)
        for f in futures:
            f.result()  # re-raise worker infrastructure errors
        for task in sorted(wave, key=lambda task: task.trial.id):
            if task.exception is not None:
                self._apply_failure(task, tel)
            else:
                self._apply_decision(task, ready=ready, tel=tel)

    # -- ask ----------------------------------------------------------------
    def _ask(self, tel) -> _Task:
        params = self.proposer.ask()
        trial = Trial(len(self.trials), np.asarray(params, float))
        self.trials[trial.id] = trial
        self.journal.append({
            "type": "ask",
            "trial": trial.id,
            "params": trial.params,
            # Reproducibility under resume: the generator state AFTER
            # this proposal — restoring it makes the resumed search
            # propose the same future points.
            "rng_state": self.proposer.rng_state,
        })
        tel.counter("tuning_trials_started").inc()
        return _Task(trial, 0)

    # -- worker side --------------------------------------------------------
    def _rung_resource(self, rung: int) -> int:
        if self.asha is not None:
            return self.asha.config.resource(rung)
        return self.config.resource

    def _warm_start(self, task: _Task, cache: dict
                    ) -> Optional[np.ndarray]:
        if task.trial.coefficients is not None:
            return task.trial.coefficients  # own previous rung
        if not self.config.warm_start:
            return None
        if cache:
            z = self.space.normalize(task.trial.params)[0]
            best = min(
                cache.items(),
                key=lambda kv: (float(np.sum((kv[1][0] - z) ** 2)), kv[0]),
            )
            return best[1][1]
        return self._published_warm_start()

    def _published_warm_start(self) -> Optional[np.ndarray]:
        """Seed coefficients from ``config.warm_start_dir`` — the
        freshest PUBLISHED model — used only before any trial of this
        run has completed (after that, same-search neighbors are the
        better prior).  Loaded lazily once; a bad explicit path fails
        the run loudly rather than silently cold-starting."""
        if self.config.warm_start_dir is None:
            return None
        if not hasattr(self, "_published_coefs"):
            path = self.config.warm_start_dir
            if os.path.isdir(path):
                from photon_ml_tpu_torch.io.game_store import load_game_model

                # Host seeds: the coefficients go back to numpy anyway.
                model, _ = load_game_model(path, device="cpu")
                fixed = [
                    c.model for c in model.models.values()
                    if hasattr(c, "model")
                ]
                if not fixed:
                    raise ValueError(
                        f"warm_start_dir {path!r} is a GAME model with "
                        "no fixed-effect coordinate — nothing to seed "
                        "trial coefficients from"
                    )
                means = fixed[0].coefficients.means
            else:
                from photon_ml_tpu_torch.io.model_store import load_glm_model

                model = load_glm_model(path, device="cpu")[0]
                means = model.coefficients.means
            self._published_coefs = np.asarray(means, np.float32)
        return self._published_coefs

    def _run_task(self, task: _Task, cache: dict) -> None:
        """Worker thread: run one rung, retrying transient failures in
        place.  Results land ON the task; classification and the journal's
        state-bearing records happen in the (deterministic) processing
        phase."""
        tel = telemetry_mod.current()
        policy = self.config.retry
        resource = self._rung_resource(task.rung)
        warm = self._warm_start(task, cache)
        attempt = 0
        t0 = time.perf_counter()
        with tel.attach(getattr(self, "_trace_ctx", None)), tel.span(
            "tuning.trial",
            trial=task.trial.id,
            rung=task.rung,
            resource=resource,
            params=[float(v) for v in task.trial.params],
            warm_started=warm is not None,
        ) as span:
            while True:
                try:
                    chaos_mod.maybe_fail(
                        "tuning.trial", trial=task.trial.id, rung=task.rung,
                    )
                    task.report = _as_report(
                        self.trial_fn(task.trial.params, resource, warm)
                    )
                    span.set(metric=task.report.metric, attempts=attempt + 1)
                    break
                except Exception as exc:  # noqa: BLE001 — classified below
                    verdict = policy.classify(exc)
                    if verdict.transient and attempt < policy.max_retries:
                        attempt += 1
                        task.trial.retries += 1
                        delay = policy.backoff(attempt - 1)
                        # Informational record (worker-side, so arrival
                        # order is timing-dependent); replay ignores it.
                        self.journal.append({
                            "type": "retry",
                            "trial": task.trial.id,
                            "rung": task.rung,
                            "attempt": attempt,
                            "error": f"{type(exc).__name__}: {exc}"[:200],
                            "matched": verdict.matched,
                            "backoff_seconds": delay,
                        })
                        tel.counter("tuning_trial_retries").inc()
                        tel.event(
                            "tuning.retry",
                            trial=task.trial.id,
                            attempt=attempt,
                            matched=verdict.matched,
                        )
                        if self.logger is not None:
                            self.logger.warning(
                                "trial %d rung %d: transient failure "
                                "(attempt %d/%d): %s",
                                task.trial.id, task.rung, attempt,
                                policy.max_retries, exc,
                            )
                        self.config.sleep(delay)
                        continue
                    task.exception = exc
                    task.transient = verdict.transient
                    span.set(error_class=(
                        "transient_exhausted" if verdict.transient
                        else "fatal"
                    ))
                    break
        task.wall = time.perf_counter() - t0
        tel.histogram("tuning_trial_seconds").observe(task.wall)

    # -- processing phase (deterministic, main thread) -----------------------
    def _note_best(self, y: float, trial_id: int) -> None:
        if self._best is None or (y, trial_id) < self._best:
            self._best = (y, trial_id)

    def _apply_failure(self, task: _Task, tel) -> None:
        trial, exc = task.trial, task.exception
        trial.status = "failed"
        trial.error = f"{type(exc).__name__}: {exc}"[:300]
        self.journal.append({
            "type": "fail",
            "trial": trial.id,
            "rung": task.rung,
            "error": trial.error,
            "transient": bool(task.transient),
            "retries": trial.retries,
        })
        self.proposer.resolve(trial.params)
        self._counts["failed"] += 1
        tel.counter("tuning_trials_failed").inc()
        if self.logger is not None:
            self.logger.warning(
                "trial %d FAILED (%s, search continues): %s",
                trial.id,
                "transient budget exhausted" if task.transient else "fatal",
                trial.error,
            )

    def _apply_decision(
        self,
        task: _Task,
        ready: list,
        journal_report: bool = True,
        tel=None,
    ) -> None:
        """Record a successful rung report and apply the ASHA decision.
        ``journal_report=False`` is the resume path re-deriving a
        decision for an already-journaled report."""
        tel = tel or telemetry_mod.current()
        trial, report = task.trial, task.report
        metric = float(report.metric)
        y = self.sign * metric
        trial.rung_metrics[task.rung] = metric
        if report.coefficients is not None:
            trial.coefficients = np.asarray(report.coefficients)
            # Persist BEFORE the report record: any journaled rung has
            # its warm-start state on disk, so a resumed search
            # warm-starts exactly as the uninterrupted one.
            self.store.save(trial.id, trial.params, trial.coefficients,
                            rung=task.rung)
        if journal_report:
            self.journal.append({
                "type": "report",
                "trial": trial.id,
                "rung": task.rung,
                "resource": self._rung_resource(task.rung),
                "metric": metric,
                "metrics": report.metrics,
                "wall": round(task.wall, 6),
            })
        decision = (
            self.asha.report(trial.id, task.rung, y)
            if self.asha is not None
            else "complete"
        )
        if decision == "promote":
            trial.rung = task.rung + 1
            self.journal.append({
                "type": "promote", "trial": trial.id, "rung": trial.rung,
            })
            tel.event("tuning.promote", trial=trial.id, rung=trial.rung)
            ready.append(_Task(trial, trial.rung))
        elif decision == "stop":
            trial.status = "killed"
            self.journal.append({
                "type": "kill",
                "trial": trial.id,
                "rung": task.rung,
                "metric": metric,
            })
            # The surrogate still learns from the pruned trial's last
            # rung metric — a bad region stays known-bad.
            self.proposer.tell(trial.params, y)
            self._counts["pruned"] += 1
            tel.counter("tuning_trials_pruned").inc()
        else:  # complete
            trial.status = "completed"
            trial.final_metric = metric
            self.journal.append({
                "type": "tell", "trial": trial.id, "metric": metric,
            })
            self.proposer.tell(trial.params, y)
            if trial.coefficients is not None:
                self._completed_coefs[trial.id] = (
                    self.space.normalize(trial.params)[0],
                    trial.coefficients,
                )
            self._counts["completed"] += 1
            tel.counter("tuning_trials_completed").inc()
            self._note_best(y, trial.id)
            if self._best is not None:
                tel.gauge("tuning_best_metric").set(
                    self.sign * self._best[0]
                )
        if self.logger is not None:
            self.logger.info(
                "trial %d rung %d: metric=%.6g -> %s",
                trial.id, task.rung, metric, decision,
            )

    # -- result -------------------------------------------------------------
    def _result(self) -> TuningResult:
        best_id = self._best[1] if self._best is not None else None
        best = self.trials.get(best_id) if best_id is not None else None
        return TuningResult(
            best_trial=best_id,
            best_params=(
                None if best is None
                else [float(v) for v in best.params]
            ),
            best_metric=None if best is None else best.final_metric,
            n_trials=len(self.trials),
            completed=self._counts["completed"],
            pruned=self._counts["pruned"],
            failed=self._counts["failed"],
            trials=[
                self.trials[i].summary() for i in sorted(self.trials)
            ],
        )
