"""Circuit breaker: closed → open → half-open probe, injectable clock
(port of ``photon_ml_tpu/chaos/breaker.py``, copied).

The degraded-mode serving path (serving/runtime.py) must not hammer a
dead device with every batch — a lost accelerator takes seconds-to-
minutes to come back, and each failed probe costs a dispatch timeout on
the request path.  The classic fix is the circuit breaker: after
``failure_threshold`` consecutive failures the circuit OPENS (all
traffic takes the fallback path, the protected call is not attempted at
all); after ``cooldown_seconds`` it goes HALF-OPEN and admits one probe;
a successful probe CLOSES it (re-promotion), a failed probe re-opens it
and restarts the cooldown.

The clock is injectable (``clock=time.monotonic`` by default) so tests
drive the state machine deterministically without sleeping — the same
discipline as the watchdog's injectable ``sleep``.

Single-writer by design: the serving dispatch thread owns all scoring,
so state transitions need no lock; ``snapshot()`` reads are racy-but-
consistent-enough for /stats (plain attribute reads of small values).
"""

from __future__ import annotations

import time
from typing import Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-site breaker guarding an unreliable call's re-promotion."""

    def __init__(
        self,
        cooldown_seconds: float = 5.0,
        failure_threshold: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        if cooldown_seconds < 0:
            raise ValueError(
                f"cooldown_seconds must be >= 0, got {cooldown_seconds}"
            )
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.cooldown_seconds = float(cooldown_seconds)
        self.failure_threshold = int(failure_threshold)
        self._clock = clock
        self.state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: float | None = None
        # lifetime counters (stats/telemetry mirrors)
        self.failures = 0
        self.opens = 0
        self.probes = 0
        self.reclosures = 0

    # -- protected-call gating ----------------------------------------------
    def allow_request(self) -> bool:
        """May the protected call be attempted right now?

        CLOSED: always.  OPEN: only once the cooldown has elapsed — and
        that admission IS the transition to HALF_OPEN (the single
        probe).  HALF_OPEN: yes (the probe's own retry loop may ask
        again before reporting an outcome).
        """
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() - self._opened_at >= self.cooldown_seconds:
                self.state = HALF_OPEN
                self.probes += 1
                return True
            return False
        return True  # HALF_OPEN

    # -- outcome reporting ---------------------------------------------------
    def record_failure(self) -> None:
        """The protected call failed: trip (or re-trip) the breaker."""
        self.failures += 1
        self._consecutive_failures += 1
        if (
            self.state == HALF_OPEN
            or self._consecutive_failures >= self.failure_threshold
        ):
            if self.state != OPEN:
                self.opens += 1
            self.state = OPEN
            self._opened_at = self._clock()
            self._consecutive_failures = 0

    def record_success(self) -> None:
        """The protected call succeeded: close from a probe, and reset
        the consecutive-failure run in any state."""
        self._consecutive_failures = 0
        if self.state != CLOSED:
            self.state = CLOSED
            self._opened_at = None
            self.reclosures += 1

    # -- observability -------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "cooldown_seconds": self.cooldown_seconds,
            "failure_threshold": self.failure_threshold,
            "failures": self.failures,
            "opens": self.opens,
            "probes": self.probes,
            "reclosures": self.reclosures,
        }
