"""Embedded metrics endpoint: Prometheus text exposition + JSON snapshot
(port of ``photon_ml_tpu/telemetry/exporter.py``, framework-neutral,
copied).

A stdlib ``ThreadingHTTPServer`` (no dependencies, same shape as the
serving endpoint) that any long-running process mounts behind a
``--metrics-port`` flag:

- ``GET /metrics``  — Prometheus text exposition (format 0.0.4) of the
  hub's registry: counters and numeric gauges as-is, histograms as
  summaries (``{quantile="0.5|0.9|0.99"}`` + ``_sum`` + ``_count``).
  Scrape it with any Prometheus/VictoriaMetrics/agent setup.
- ``GET /snapshot`` — the full registry snapshot as JSON (includes the
  non-numeric gauges Prometheus cannot carry) plus run identity
  (``trace``, ``wall_epoch``, ``pid``).
- ``GET /healthz``  — liveness: ``{"status": "ok", ...}``.  Always
  "ok" while the process answers — the exporter is alive iff it serves.
- ``GET /livez``    — alias of the same liveness verdict.
- ``GET /readyz``   — readiness, DISTINCT from liveness: when the
  mounting process supplied a ``readiness`` callable (the serving CLI
  passes ``ScoringService.readiness``), 503 ``"not_ready"`` during
  startup warmup / mid-swap / zero healthy replicas; without one, ready
  iff serving (matching /healthz).  Load balancers route on THIS.

``mount_ops_plane`` is the one-call composition the drivers, the tuning
orchestrator, and the serving CLI use: time-series sampler
(telemetry/timeseries.py) + exporter, both torn down by ``close()`` with
no thread leak (the lifecycle the ops-plane tests pin).
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

# host_identity lives in core.py (the serving heartbeats need it without
# this module); re-exported here where the reference defines it.
from photon_ml_tpu_torch.telemetry.core import host_identity  # noqa: F401
from photon_ml_tpu_torch.telemetry.timeseries import TimeSeriesSampler


#: summary quantiles /metrics exposes per histogram.
QUANTILES = (0.5, 0.9, 0.99)

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+"
    r"([-+]?(?:[0-9.]+(?:[eE][-+]?[0-9]+)?|Inf|NaN))$"
)


def _sanitize(name: str) -> str:
    if _NAME_OK.match(name):
        return name
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def prometheus_text(snapshot: dict) -> str:
    """Render a registry snapshot as Prometheus text exposition.

    Pure function of the snapshot (unit-testable without HTTP).
    Non-numeric gauges are skipped — they remain visible on /snapshot.
    """
    lines: list[str] = []
    for name in sorted(snapshot.get("counters") or {}):
        value = snapshot["counters"][name]
        if not isinstance(value, (int, float)):
            continue
        safe = _sanitize(name)
        lines.append(f"# TYPE {safe} counter")
        lines.append(f"{safe} {_fmt(value)}")
    for name in sorted(snapshot.get("gauges") or {}):
        value = snapshot["gauges"][name]
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            continue
        safe = _sanitize(name)
        lines.append(f"# TYPE {safe} gauge")
        lines.append(f"{safe} {_fmt(value)}")
    for name in sorted(snapshot.get("histograms") or {}):
        h = snapshot["histograms"][name]
        if not h.get("count"):
            continue
        safe = _sanitize(name)
        lines.append(f"# TYPE {safe} summary")
        for q, key in zip(QUANTILES, ("p50", "p90", "p99")):
            v = h.get(key)
            if v is not None:
                lines.append(f'{safe}{{quantile="{q}"}} {_fmt(v)}')
        lines.append(f"{safe}_sum {_fmt(h['sum'])}")
        lines.append(f"{safe}_count {h['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Minimal exposition-format parser: ``{(name, labels): value}``.

    Raises ``ValueError`` on any malformed line — the selfcheck uses
    this to prove /metrics output actually parses, not merely that it
    was served.
    """
    out: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if m is None:
            raise ValueError(
                f"unparseable exposition line {lineno}: {line!r}"
            )
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        out[(name, labels)] = float(value)
    return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        pass

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — stdlib casing
        hub = self.server.exporter.hub
        hub.counter("telemetry_scrapes_total").inc()
        if self.path == "/metrics":
            body = prometheus_text(hub.snapshot()).encode()
            self._send(
                200, body, "text/plain; version=0.0.4; charset=utf-8"
            )
        elif self.path == "/snapshot":
            snap = hub.snapshot()
            snap["wall_epoch"] = hub._epoch_wall
            snap["trace"] = hub.trace_id
            snap["pid"] = os.getpid()
            snap["host"] = host_identity(self.server.exporter.host_id)
            # Mergeable histogram state rides alongside the summaries:
            # the fleet aggregator folds /snapshot via absorb_delta,
            # which needs raw bucket vectors, not quantiles.
            snap["transport"] = hub.metrics.transport_snapshot()
            self._send(
                200, json.dumps(snap).encode(), "application/json"
            )
        elif self.path in ("/healthz", "/livez"):
            self._send(200, json.dumps({
                "status": "ok",
                "pid": os.getpid(),
                "trace": hub.trace_id,
                "uptime_s": round(
                    time.perf_counter() - hub._epoch_perf, 3
                ),
            }).encode(), "application/json")
        elif self.path == "/readyz":
            ready, reason = True, "ok"
            readiness = self.server.exporter.readiness
            if readiness is not None:
                try:
                    verdict = readiness()
                    # accept a bare bool or a (bool, reason) tuple
                    if isinstance(verdict, tuple):
                        ready, reason = verdict
                    else:
                        ready, reason = bool(verdict), ""
                except Exception as exc:  # noqa: BLE001 — fail not-ready
                    ready, reason = False, f"readiness check failed: {exc}"
            self._send(200 if ready else 503, json.dumps({
                "status": "ready" if ready else "not_ready",
                "reason": reason,
            }).encode(), "application/json")
        else:
            self._send(
                404,
                json.dumps({"error": f"no route {self.path}"}).encode(),
                "application/json",
            )


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    exporter: "MetricsExporter"


class MetricsExporter:
    """HTTP exposition of one hub's registry; start/close lifecycle."""

    def __init__(
        self, hub, host: str = "127.0.0.1", port: int = 0, readiness=None,
        host_id: Optional[str] = None,
    ):
        self.hub = hub
        self.host = host
        #: optional ``() -> bool | (bool, reason)`` behind /readyz; None
        #: keeps the pre-split behavior (ready iff serving).
        self.readiness = readiness
        #: stable identity /snapshot publishes (see :func:`host_identity`).
        self.host_id = host_id
        self._requested_port = port
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        self._server = _Server((self.host, self._requested_port), _Handler)
        self._server.exporter = self
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="telemetry-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        return None if self._server is None else (
            self._server.server_address[1]
        )

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def close(self, timeout: float = 5.0) -> None:
        """Shut the server down and JOIN its thread (no leaked daemon —
        the lifecycle tests assert this survives chaos teardown paths).
        Idempotent."""
        server, thread = self._server, self._thread
        self._server, self._thread = None, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=timeout)


class OpsPlane:
    """Handle over the mounted live-ops pieces; ``close()`` is the one
    teardown call (sampler final-sample + exporter join), idempotent and
    exception-safe."""

    def __init__(
        self,
        sampler: Optional[TimeSeriesSampler],
        exporter: Optional[MetricsExporter],
        logger=None,
    ):
        self.sampler = sampler
        self.exporter = exporter
        if logger is not None and exporter is not None:
            logger.info(
                "metrics exporter on http://%s:%d (/metrics /snapshot "
                "/healthz /livez /readyz)", exporter.host, exporter.port,
            )

    @property
    def port(self) -> Optional[int]:
        return None if self.exporter is None else self.exporter.port

    def close(self) -> None:
        try:
            if self.sampler is not None:
                self.sampler.stop()
        finally:
            if self.exporter is not None:
                self.exporter.close()

    def __enter__(self) -> "OpsPlane":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def mount_ops_plane(
    hub,
    port: Optional[int] = None,
    interval_s: float = 1.0,
    host: str = "127.0.0.1",
    ts_path: Optional[str] = None,
    logger=None,
    readiness=None,
) -> OpsPlane:
    """Mount the live ops plane on ``hub``: a metrics_ts.jsonl sampler
    (when the hub has an output dir and ``interval_s > 0``) and the HTTP
    exporter (when ``port`` is not None; 0 binds an ephemeral port).
    Disabled hubs get an inert plane — callers mount unconditionally.
    """
    sampler = None
    exporter = None
    if hub.enabled:
        sampler = TimeSeriesSampler(
            hub, path=ts_path, interval_s=interval_s
        )
        sampler.start()
        if not sampler.enabled:
            sampler = None
        if port is not None and port >= 0:
            exporter = MetricsExporter(
                hub, host=host, port=port, readiness=readiness
            ).start()
    return OpsPlane(sampler, exporter, logger=logger)
