"""Telemetry sinks: JSONL event log, Chrome trace export, logger summary
(port of ``photon_ml_tpu/telemetry/sinks.py``, copied).

Sink contract: ``emit(record)`` receives every span/event/meta record
(already JSON-sanitized attrs, monotonic ``ts``/``dur`` in SECONDS since
the hub's epoch); ``close(metrics_snapshot)`` flushes/finalizes.  The hub
serializes ``emit`` calls under one lock and swallows sink exceptions —
observability must never sink the job it observes.
"""

from __future__ import annotations

import json
import os
import threading


class Sink:
    def emit(self, record: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self, snapshot: dict) -> None:
        pass


class JsonlSink(Sink):
    """One JSON object per line in ``events.jsonl`` — the source of truth
    every other view (trace, summary) can be rebuilt from."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w", buffering=1)  # line-buffered

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")

    def close(self, snapshot: dict) -> None:
        try:
            self._f.write(
                json.dumps({"type": "metrics", "snapshot": snapshot}) + "\n"
            )
        finally:
            self._f.close()


class ChromeTraceSink(Sink):
    """Buffers records and writes a Chrome trace-event ARRAY at close —
    loadable in Perfetto / ``chrome://tracing``.

    Spans become complete ("X") events, instants become "i" events, and
    counter/gauge metrics are appended as one final "C" sample so the
    trace carries the end-of-run numbers.  The buffer is bounded: a
    runaway emitter degrades to a truncated trace (with a drop marker),
    never to unbounded host memory.

    Timestamps are WALL-ANCHORED by default: the hub's monotonic ``ts``
    offsets are shifted by the ``wall_epoch`` the meta record carries,
    so traces from several processes (a training driver + its tuning
    workers + a serving sidecar) concatenate into ONE merged Perfetto
    timeline with correct relative placement.  ``anchor_wall=False``
    keeps the raw run-relative offsets.
    """

    MAX_RECORDS = 500_000

    def __init__(self, path: str, anchor_wall: bool = True):
        self.path = path
        self.anchor_wall = anchor_wall
        self._records: list[dict] = []
        self._dropped = 0
        self._pid = os.getpid()
        self._wall_epoch = 0.0

    def emit(self, record: dict) -> None:
        if record.get("type") == "meta" and record.get("wall_epoch"):
            self._wall_epoch = float(record["wall_epoch"])
        if len(self._records) >= self.MAX_RECORDS:
            self._dropped += 1
            return
        self._records.append(record)

    def _anchor(self) -> float:
        return self._wall_epoch if self.anchor_wall else 0.0

    def _convert(self, record: dict) -> dict | None:
        kind = record.get("type")
        ts_us = (record.get("ts", 0.0) + self._anchor()) * 1e6
        base = {
            "name": record.get("name", "?"),
            "pid": self._pid,
            "tid": record.get("tid", 0),
            "ts": ts_us,
        }
        args = dict(record.get("attrs") or {})
        if record.get("error"):
            args["error"] = record["error"]
        if kind == "span":
            base["ph"] = "X"
            base["dur"] = record.get("dur", 0.0) * 1e6
            args["span_id"] = record.get("id")
            if record.get("parent") is not None:
                args["parent_span_id"] = record["parent"]
            # Distributed-trace stitching fields (telemetry/core.py
            # trace-context section): the shared trace id, this span's
            # GLOBAL id, the remote parent's global id, and the
            # tail-retention marker — concatenated per-process traces
            # merge into one Perfetto timeline that preserves the
            # cross-process parent links through these args.
            for key in ("trace", "gid", "rparent", "tail"):
                if record.get(key) is not None:
                    args[key] = record[key]
        elif kind == "event":
            base["ph"] = "i"
            base["s"] = "t"  # thread-scoped instant
        elif kind == "meta":
            base["ph"] = "i"
            base["s"] = "g"  # global instant marking run start
            args["wall_epoch"] = record.get("wall_epoch")
        else:
            return None
        if args:
            base["args"] = args
        return base

    def close(self, snapshot: dict) -> None:
        events = []
        for record in self._records:
            ev = self._convert(record)
            if ev is not None:
                events.append(ev)
        last_ts = max((e["ts"] for e in events), default=0.0)
        for kind in ("counters", "gauges"):
            for name, value in (snapshot.get(kind) or {}).items():
                if isinstance(value, (int, float)):
                    events.append({
                        "name": name, "ph": "C", "pid": self._pid,
                        "tid": 0, "ts": last_ts,
                        "args": {"value": value},
                    })
        if self._dropped:
            events.append({
                "name": "trace_truncated", "ph": "i", "s": "g",
                "pid": self._pid, "tid": 0, "ts": last_ts,
                "args": {"dropped_records": self._dropped},
            })
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(events, f)
        os.replace(tmp, self.path)
        self._records = []


class LoggerSummarySink(Sink):
    """Human-readable end-of-run summary through ``PhotonLogger``:
    per-span-name aggregate wall clock plus the metric values — the
    at-a-glance "where did the time go" the reference read off the Spark
    UI."""

    MAX_LINES = 40

    def __init__(self, logger):
        self.logger = logger
        self._lock = threading.Lock()
        # name -> [count, total_seconds]
        self._spans: dict[str, list] = {}
        self._events: dict[str, int] = {}

    def emit(self, record: dict) -> None:
        kind = record.get("type")
        name = record.get("name", "?")
        with self._lock:
            if kind == "span":
                agg = self._spans.setdefault(name, [0, 0.0])
                agg[0] += 1
                agg[1] += record.get("dur", 0.0)
            elif kind == "event":
                self._events[name] = self._events.get(name, 0) + 1

    def close(self, snapshot: dict) -> None:
        log = self.logger
        if log is None:
            return
        with self._lock:
            spans = sorted(
                self._spans.items(), key=lambda kv: -kv[1][1]
            )
            events = dict(self._events)
        log.info("telemetry summary (spans, by total wall):")
        for name, (count, total) in spans[: self.MAX_LINES]:
            log.info(
                "  %-28s %6d x  %9.3fs total  %9.3fs mean",
                name, count, total, total / count,
            )
        if events:
            log.info(
                "telemetry events: %s",
                {k: events[k] for k in sorted(events)},
            )
        for kind in ("counters", "gauges"):
            table = snapshot.get(kind) or {}
            if table:
                log.info("telemetry %s: %s", kind, table)
        hists = snapshot.get("histograms") or {}
        for name in sorted(hists):
            h = hists[name]
            if not h["count"]:
                continue
            log.info(
                "telemetry histogram %s: n=%d mean=%.6g min=%.6g max=%.6g",
                name, h["count"], h["mean"], h["min"], h["max"],
            )
