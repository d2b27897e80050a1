"""Flight recorder: a bounded ring of recent telemetry records (port of
``photon_ml_tpu/telemetry/recorder.py``, copied).

The end-of-run sinks (events.jsonl, trace.json) answer "what happened"
only after a run ends cleanly; a crashed long run leaves a partial event
log whose interesting part — the seconds before the failure — is buried
at the tail of a file that may be gigabytes deep.  The flight recorder
is the aviation-style answer: a fixed-capacity ring that every record
passes through at append cost, dumped to ``flightrecorder.json`` only
when something goes wrong:

- a driver crash (``Telemetry.__exit__`` with an exception),
- a watchdog-fatal failure (``utils/watchdog.run_with_retries`` giving
  up or classifying non-transient),
- an injected chaos fault (``chaos/core.FaultPlan`` firing a "raise"
  action) — so every fault-injection test doubles as a forensics test.

The ring is a ``collections.deque(maxlen=capacity)``: appends are
atomic under CPython's GIL (no lock on the hot path) and the oldest
record falls off for free, so a runaway emitter costs bounded memory
and zero coordination.  Records arrive already JSON-sanitized (the hub
sanitizes attrs before fan-out), so a dump is a straight ``json.dump``.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional

from photon_ml_tpu_torch.telemetry.sinks import Sink


class FlightRecorder(Sink):
    """Bounded ring of the most recent span/event/meta records.

    Installed automatically in the standard sink set of every hub built
    with an ``output_dir``; dump via
    :meth:`photon_ml_tpu_torch.telemetry.Telemetry.dump_flight_recorder`.
    """

    DEFAULT_CAPACITY = 512

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        #: best-effort total records seen (unlocked increment; the exact
        #: value is forensic context, not an invariant).
        self.records_seen = 0

    # -- sink contract -------------------------------------------------------
    def emit(self, record: dict) -> None:
        self._ring.append(record)
        self.records_seen += 1

    def close(self, snapshot: dict) -> None:
        # Keep the ring: Telemetry.__exit__ dumps AFTER restoring the
        # previous hub, and tests inspect post-close contents.
        pass

    # -- forensics -----------------------------------------------------------
    def snapshot(self) -> list[dict]:
        """Copy of the ring, oldest first."""
        return list(self._ring)

    def dump(
        self,
        path: str,
        reason: Optional[str] = None,
        wall_epoch: Optional[float] = None,
        trace: Optional[str] = None,
    ) -> str:
        """Write the ring (oldest → newest) plus dump metadata to
        ``path`` atomically; returns ``path``.  The newest record is the
        last element of ``events`` — for a fault-triggered dump that is
        the fault site's own record."""
        events = list(self._ring)
        payload = {
            "reason": reason,
            "dumped_at_wall": time.time(),
            "wall_epoch": wall_epoch,
            "trace": trace,
            "capacity": self.capacity,
            "records_seen": self.records_seen,
            "n_events": len(events),
            "events": events,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        return path
