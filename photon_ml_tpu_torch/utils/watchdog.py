"""Transient-failure watchdog (port of ``photon_ml_tpu/utils/watchdog.py``).

Bounded retries around long training runs.  Both drivers persist their
progress (the λ-grid checkpoint, the coordinate-descent checkpoint); this
module classifies an exception as transient, backs off, and re-runs the
training closure, which reloads the checkpoint and continues where the
failed attempt stopped, so a retry never repeats finished work.

Classification is by message pattern, as in the reference, with one
deliberate difference.  The reference falls back on the exception's type
name ``XlaRuntimeError``, the error a lost TPU transport raises.  The port
has no such type, and the error a CUDA fault raises is the opposite case:
``torch.AcceleratorError`` / ``RuntimeError("CUDA error: ...")`` (an
illegal address, a launch failure) leaves the CUDA context *sticky* — every
later call in the process fails the same way — so retrying inside the
process cannot succeed, and ``torch.OutOfMemoryError`` re-runs the same
allocation.  So the port adds no type-name fallback, and it classifies
``CUDA error``, ``illegal memory access`` and ``torch.OutOfMemoryError`` as
non-transient: they propagate, and a fresh process resumes from the
checkpoint.  Transport-style failures (``UNAVAILABLE``, a dropped
connection, a preemption) are retried as in the reference.

Each classify/backoff/give-up decision is a ``watchdog.attempt``
telemetry event, each retry counts on ``watchdog_retries``, and a fatal
failure (a CUDA error or ``torch.OutOfMemoryError`` included: both are
non-transient here) dumps the flight recorder before it propagates, as in
the reference.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Sequence, TypeVar

from photon_ml_tpu_torch import telemetry as telemetry_mod

T = TypeVar("T")

# gRPC-ish status markers and transport phrases that indicate the RUN may
# succeed on retry.  Deliberately NOT included: RESOURCE_EXHAUSTED / out of
# memory (a retry recomputes the same allocation) and INVALID_ARGUMENT-style
# programming errors.
_TRANSIENT_PATTERNS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
    "INTERNAL",
    "socket closed",
    "connection reset",
    "connection refused",
    "transport",
    "device lost",
    "heartbeat",
    "preempted",
)

# Markers that mean a retry in this process will deterministically fail
# again; they veto every transient pattern.  The last two are the port's:
# a CUDA fault leaves the context unusable for the rest of the process.
_NON_TRANSIENT_PATTERNS = (
    "RESOURCE_EXHAUSTED",
    "out of memory",
    "INVALID_ARGUMENT",
    "FAILED_PRECONDITION",
    "NOT_FOUND",
    "UNIMPLEMENTED",
    "CUDA error",
    "illegal memory access",
)

# Exception types that are never retried, whatever their message says
# (checked by name, so this module needs no torch import).
_NON_TRANSIENT_TYPE_NAMES = ("OutOfMemoryError",)


@dataclasses.dataclass(frozen=True)
class Classification:
    """Why an exception was (or wasn't) judged transient: the verdict plus
    the pattern or type name that decided it (what the watchdog logs and
    records per attempt)."""

    transient: bool
    #: the matched message pattern or type name, None when nothing matched
    matched: Optional[str] = None
    #: "interrupt" | "non_transient_type" | "non_transient_pattern" |
    #: "transient_pattern" | "none"
    source: str = "none"


@dataclasses.dataclass
class RetryStats:
    """Observable retry behavior of one :func:`run_with_retries` call.

    Tests assert on this instead of timing sleeps; drivers surface it in
    their result JSON.  ``failures`` holds one dict per caught exception
    (attempt, exception type, message head, verdict, matched pattern,
    backoff seconds — None when the failure propagated)."""

    attempts: int = 0  # fn invocations started
    retries: int = 0  # sleeps taken (= transient failures retried)
    sleep_seconds: float = 0.0  # total backoff requested
    succeeded: bool = False
    gave_up: bool = False  # budget exhausted on a transient failure
    failures: list = dataclasses.field(default_factory=list)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a long run reacts to transient failures.

    ``max_retries=0`` disables the watchdog (failures propagate).  Backoff
    is exponential: ``backoff_seconds * multiplier**attempt``, capped at
    ``max_backoff_seconds``; ``jitter="decorrelated"`` draws each delay
    from ``U[base, 3·previous]`` (capped) with the RNG passed to
    :func:`run_with_retries`, so parallel clients do not retry in
    lockstep."""

    max_retries: int = 0
    backoff_seconds: float = 5.0
    backoff_multiplier: float = 2.0
    max_backoff_seconds: float = 300.0
    extra_patterns: Sequence[str] = ()
    jitter: str = "none"

    def __post_init__(self):
        if self.jitter not in ("none", "decorrelated"):
            raise ValueError(
                f"jitter must be 'none' or 'decorrelated', got "
                f"{self.jitter!r}"
            )

    def classify(self, exc: BaseException) -> Classification:
        """Verdict + the pattern or type that decided it."""
        if isinstance(exc, (KeyboardInterrupt, SystemExit)):
            # A user interrupt or a deliberate exit is never retryable,
            # whatever its message says.
            return Classification(False, type(exc).__name__, "interrupt")
        name = type(exc).__name__
        if name in _NON_TRANSIENT_TYPE_NAMES:
            return Classification(False, name, "non_transient_type")
        msg = str(exc).lower()
        for p in _NON_TRANSIENT_PATTERNS:
            if p.lower() in msg:
                return Classification(False, p, "non_transient_pattern")
        for p in tuple(_TRANSIENT_PATTERNS) + tuple(self.extra_patterns):
            if p.lower() in msg:
                return Classification(True, p, "transient_pattern")
        return Classification(False)

    def is_transient(self, exc: BaseException) -> bool:
        return self.classify(exc).transient

    def backoff(
        self,
        attempt: int,
        rng: Optional[random.Random] = None,
        previous: Optional[float] = None,
    ) -> float:
        """Seconds to sleep before retrying after failure ``attempt``:
        the capped exponential, or with ``jitter="decorrelated"`` and an
        RNG ``min(cap, U[base, 3·previous])`` where ``previous`` is the
        last delay slept (``base`` on the first retry)."""
        if self.jitter == "decorrelated" and rng is not None:
            prev = self.backoff_seconds if previous is None else previous
            hi = max(self.backoff_seconds, 3.0 * prev)
            return min(
                self.max_backoff_seconds,
                rng.uniform(self.backoff_seconds, hi),
            )
        return min(
            self.backoff_seconds * self.backoff_multiplier**attempt,
            self.max_backoff_seconds,
        )


def run_with_retries(
    fn: Callable[[int], T],
    policy: RetryPolicy,
    logger=None,
    sleep: Callable[[float], None] = time.sleep,
    stats: Optional[RetryStats] = None,
    rng: Optional[random.Random] = None,
) -> T:
    """Run ``fn(attempt)`` until it returns, retrying transient failures.

    ``fn`` receives the attempt number (0 = first try) and must re-read its
    checkpoint state on each call: that is what makes a retry resume
    instead of restart.  Non-transient exceptions and an exhausted budget
    propagate unchanged.  ``stats`` (mutated in place) records every
    attempt's classification and backoff; ``rng`` drives the decorrelated
    jitter (a fresh RNG when the policy enables jitter and none is given).
    ``KeyboardInterrupt``/``SystemExit`` are not ``Exception``s: they
    propagate without reaching classification."""
    tel = telemetry_mod.current()
    if stats is None:
        stats = RetryStats()
    if rng is None and policy.jitter != "none":
        rng = random.Random()
    attempt = 0
    prev_delay: Optional[float] = None
    while True:
        stats.attempts += 1
        try:
            result = fn(attempt)
        except Exception as exc:  # noqa: BLE001 — classified below
            verdict = policy.classify(exc)
            retrying = verdict.transient and attempt < policy.max_retries
            delay = (
                policy.backoff(attempt, rng=rng, previous=prev_delay)
                if retrying else None
            )
            stats.gave_up = verdict.transient and not retrying
            stats.failures.append({
                "attempt": attempt,
                "exception": type(exc).__name__,
                "message": str(exc)[:200],
                "transient": verdict.transient,
                "matched": verdict.matched,
                "source": verdict.source,
                "backoff_seconds": delay,
            })
            tel.event(
                "watchdog.attempt",
                attempt=attempt,
                outcome=(
                    "retry" if retrying
                    else "gave_up" if verdict.transient
                    else "non_transient"
                ),
                exception=type(exc).__name__,
                matched=verdict.matched,
                source=verdict.source,
                backoff_seconds=delay,
            )
            if not retrying:
                # Watchdog-fatal: freeze the event window before the run
                # dies (a no-op without a recorder-equipped hub).
                telemetry_mod.dump_flight_recorder(
                    reason=(
                        "watchdog-fatal: "
                        f"{type(exc).__name__}: {exc}"
                    )[:300]
                )
                raise
            stats.retries += 1
            stats.sleep_seconds += delay
            prev_delay = delay
            tel.counter("watchdog_retries").inc()
            if logger is not None:
                logger.warning(
                    "transient failure (attempt %d/%d), retrying in %.1fs: "
                    "%s: %s",
                    attempt + 1, policy.max_retries, delay,
                    type(exc).__name__, exc,
                )
            sleep(delay)
            attempt += 1
        else:
            stats.succeeded = True
            if stats.retries or stats.failures:
                tel.event(
                    "watchdog.recovered",
                    attempts=stats.attempts, retries=stats.retries,
                )
            return result
