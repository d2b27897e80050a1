"""Time-series metrics: periodic registry snapshots to metrics_ts.jsonl
(port of ``photon_ml_tpu/telemetry/timeseries.py``, framework-neutral,
copied).

``metrics.json`` is one end-of-run dump — useless for a run that takes
hours (or never ends, like the serving service).  The sampler turns the
same registry into a STREAM: a background thread snapshots every
``interval_s`` seconds and appends one JSON line to
``metrics_ts.jsonl`` in the hub's output dir, so a long run's observable
state is live (tail the file, or scrape /metrics — telemetry/exporter.py
serves the same registry over HTTP).

Records are append-only and self-describing::

    {"seq": 3, "t_wall": 1754..., "t_mono": 12.04,
     "host": {"host_id": "...", "pid": 1234},
     "counters": {...}, "gauges": {...}, "histograms": {...}}

``t_mono`` is monotonic seconds since the hub's epoch (immune to
wall-clock steps — consecutive records always have increasing ``t_mono``
and ``seq``); ``t_wall`` correlates across processes.  The file is
bounded: past ``max_bytes`` it rotates (``metrics_ts.jsonl`` →
``.1`` → ... → ``.keep``, oldest dropped), so an unattended month-long
run costs at most ``(keep + 1) * max_bytes`` of disk.

One sample is written at start and one at stop, so even a short run's
series brackets the run (≥ 2 records) and the final record equals the
end-of-run ``metrics.json`` state.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from photon_ml_tpu_torch.telemetry.core import host_identity


class TimeSeriesSampler:
    """Background interval snapshots of a hub's metrics registry.

    Use as a context manager (the ops-plane mount does)::

        with TimeSeriesSampler(tel, interval_s=1.0):
            ... long run ...

    A disabled hub, a missing destination, or ``interval_s <= 0`` makes
    the sampler a no-op — callers mount unconditionally.
    """

    def __init__(
        self,
        hub,
        path: Optional[str] = None,
        interval_s: float = 1.0,
        max_bytes: int = 4 << 20,
        keep: int = 2,
    ):
        if path is None and hub.output_dir is not None:
            path = os.path.join(hub.output_dir, "metrics_ts.jsonl")
        self.hub = hub
        self.path = path
        self.interval_s = float(interval_s)
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self.enabled = bool(
            hub.enabled and path is not None and self.interval_s > 0
        )
        self.samples = 0
        self._seq = 0
        self._file = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "TimeSeriesSampler":
        if not self.enabled or self._thread is not None:
            return self
        self._file = open(self.path, "w")
        self.sample()  # the series always brackets the run
        self._thread = threading.Thread(
            target=self._loop, name="telemetry-ts", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Final sample + clean thread shutdown.  Idempotent."""
        if not self.enabled:
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if self._file is not None:
            self.sample()
            with self._lock:
                self._file.close()
                self._file = None

    def __enter__(self) -> "TimeSeriesSampler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- sampling ------------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:
                # Observability must never sink the job it observes; a
                # failed write (disk full) drops this sample only.
                pass

    def sample(self) -> Optional[dict]:
        """Take one snapshot and append it; safe from any thread.
        Returns the record (None when disabled/closed)."""
        if not self.enabled:
            return None
        snap = self.hub.metrics.snapshot()
        with self._lock:
            if self._file is None:
                return None
            record = {
                "seq": self._seq,
                "t_wall": time.time(),
                "t_mono": time.perf_counter() - self.hub._epoch_perf,
                "host": host_identity(),
                "counters": snap["counters"],
                "gauges": snap["gauges"],
                "histograms": snap["histograms"],
            }
            self._seq += 1
            self.samples += 1
            # Rotate BEFORE writing: the live file always ends with the
            # newest record (a reader tailing metrics_ts.jsonl never
            # finds it freshly-empty after a rotation).
            if self._file.tell() > self.max_bytes:
                self._rotate_locked()
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        return record

    def _rotate_locked(self) -> None:
        """path → path.1 → ... → path.keep (oldest generation dropped)."""
        self._file.close()
        for i in range(self.keep, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i}")
        self._file = open(self.path, "w")


def read_series(path: str) -> list[dict]:
    """Parse a metrics_ts.jsonl file (tolerating a torn final line — the
    sampler can die mid-write on a crash, exactly when the series is
    being read forensically)."""
    records = []
    with open(path) as f:
        for line in f:
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                break
    return records
