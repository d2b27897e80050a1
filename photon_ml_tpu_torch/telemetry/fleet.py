"""Fleet metrics aggregation + SLO burn-rate engine (port of
``photon_ml_tpu/telemetry/fleet.py``, framework-neutral, copied).

The ops plane (``exporter.py``) observes ONE process; the serving
fleet's router spreads traffic over N of them.  This module is the fold: a
:class:`FleetAggregator` the router (or a standalone CLI) runs that
scrapes each host's ``/snapshot``, merges every registry through the
same ``absorb_delta`` transport the worker heartbeat pipe already uses,
and serves ONE fleet-wide view:

- ``GET /metrics`` — Prometheus text with a ``host`` label dimension:
  every metric appears once per host (``{host="h0"}``) plus an
  unlabeled fleet-wide fold, so a dashboard reads either grain from one
  scrape.
- ``GET /slo`` — the burn-rate report as JSON.

**Scrape robustness** (the partition contract one tier up from the
lease client): a DOWN host degrades to its last-seen snapshot —
``fleet_scrape_failures_total`` counts, ``fleet_scrape_staleness_seconds``
ages, the loop never wedges.  The ``telemetry.scrape`` chaos seam makes
the failure FaultPlan-scriptable.

**SLO engine**: each :class:`SloPolicy` declares a latency target and an
error budget; the evaluator computes the error-budget burn rate over a
fast and a slow window (classic multi-window alerting: the fast window
catches the fire, the slow window suppresses blips) from deltas of the
aggregated counters and histogram bucket vectors.  When BOTH windows
burn past the threshold it emits an ``slo.burn`` event, increments
``slo_burn_alerts_total``, and trips a flight-recorder dump — the last-N
events leading into the burn land on disk before anyone pages.

See docs/telemetry.md "Distributed tracing + fleet aggregation".
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.telemetry.core import (
    BUCKET_BOUNDS,
    MetricsRegistry,
)
from photon_ml_tpu_torch.telemetry.exporter import _fmt, _sanitize


# ---------------------------------------------------------------------------
# SLO policy + burn math
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """One SLO: a latency target and an error budget for one traffic
    slice (fleet-wide or per-tenant, chosen by which metric family the
    policy points at).

    A request is BAD when it errors or lands slower than ``p99_s``; the
    budget says what fraction of bad requests is acceptable; the burn
    rate is ``bad_fraction / budget`` (1.0 = burning the budget exactly
    as fast as it refills; 10x = the classic page-now threshold on a
    5m window)."""

    name: str
    latency_metric: str = "serving_request_latency_seconds"
    p99_s: Optional[float] = 0.5
    error_counter: Optional[str] = None
    error_budget: float = 0.01
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    burn_threshold: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.error_budget <= 1.0):
            raise ValueError(
                f"error_budget must be in (0, 1], got {self.error_budget}"
            )
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError(
                "windows must be > 0, got "
                f"{self.fast_window_s}/{self.slow_window_s}"
            )
        if self.fast_window_s > self.slow_window_s:
            raise ValueError(
                f"fast window ({self.fast_window_s}s) must not exceed "
                f"slow window ({self.slow_window_s}s)"
            )
        if self.p99_s is None and self.error_counter is None:
            raise ValueError(
                f"policy {self.name!r} needs a latency target and/or an "
                "error counter — with neither, nothing can ever be bad"
            )


def _hist_bad_split(new: Optional[dict], old: Optional[dict],
                    p99_s: float) -> tuple[int, int]:
    """``(total, bad)`` request deltas between two histogram transports:
    bad = observations ABOVE the bucket covering ``p99_s``.  Bucket
    granularity (≤ 1.26x) bounds the misclassification band."""
    if not new:
        return 0, 0
    idx = bisect.bisect_left(BUCKET_BOUNDS, p99_s)
    new_buckets = new.get("buckets") or []
    old_buckets = (old or {}).get("buckets") or []
    total = new.get("count", 0) - (old or {}).get("count", 0)
    ok = sum(new_buckets[: idx + 1]) - sum(old_buckets[: idx + 1])
    return max(0, total), max(0, total - max(0, ok))


@dataclasses.dataclass
class _BurnState:
    alerting: bool = False
    alerts: int = 0
    last: Optional[dict] = None


# ---------------------------------------------------------------------------
# Per-host scrape state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HostState:
    host_id: str
    url: str
    registry: MetricsRegistry = dataclasses.field(
        default_factory=MetricsRegistry
    )
    prev: Optional[dict] = None
    last_snapshot: Optional[dict] = None
    last_success_t: Optional[float] = None
    scrapes: int = 0
    failures: int = 0
    stale: bool = False
    identity: Optional[dict] = None
    #: set when membership says the host left the fleet; the series is
    #: marked stale immediately and DROPPED after ``stale_drop_s``.
    departed_t: Optional[float] = None


def _default_fetch(url: str, timeout_s: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read())


# ---------------------------------------------------------------------------
# The aggregator
# ---------------------------------------------------------------------------

class FleetAggregator:
    """Scrape N hosts' ``/snapshot`` endpoints into one fleet registry.

    ``hosts`` maps host_id -> base URL (the exporter's root; the
    aggregator appends ``/snapshot``).  ``fetch`` is injectable for
    tests: ``(url, timeout_s) -> snapshot dict``.  Drive it manually
    with :meth:`poll_once` or on a thread with :meth:`start`/``stop``.

    The host set FOLLOWS membership: :meth:`sync_membership` (fed by
    the cluster tier's ``MembershipWatcher``, or any discovery source)
    adds new hosts, re-adopts returners, and marks departed hosts —
    whose series are flagged stale immediately
    (``fleet_host_stale_count{host=...} 1``), stop being scraped, and
    are DROPPED from the exposition after ``stale_drop_s``.  A dead
    host's last-seen numbers never sum forever into the fleet totals;
    they age out on a bounded schedule an alert can ride.
    """

    def __init__(
        self,
        hosts: dict,
        policies=(),
        scrape_timeout_s: float = 5.0,
        interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        fetch: Optional[Callable[[str, float], dict]] = None,
        max_samples: int = 4096,
        stale_drop_s: float = 30.0,
    ):
        if not hosts:
            raise ValueError("FleetAggregator needs at least one host")
        self.stale_drop_s = float(stale_drop_s)
        self.policies = list(policies)
        self.scrape_timeout_s = float(scrape_timeout_s)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._fetch = fetch or _default_fetch
        self._lock = sanitizers.tracked(
            threading.Lock(), "telemetry.fleet_aggregator"
        )
        self._hosts = {
            str(hid): _HostState(
                host_id=str(hid), url=str(url).rstrip("/")
            )
            for hid, url in dict(hosts).items()
        }
        #: the fleet-wide fold every host's deltas land in; the
        #: aggregator's own fleet_*/slo_* meta-metrics live here too, so
        #: one /metrics scrape carries both.
        self.registry = MetricsRegistry()
        self.registry.gauge("fleet_hosts_count").set(len(self._hosts))
        #: (t_mono, fleet transport_snapshot) ring the burn evaluator
        #: differentiates; bounded so a long-lived aggregator cannot
        #: grow without bound.
        self._samples: list[tuple[float, dict]] = []
        self._max_samples = int(max_samples)
        self._burn: dict[str, _BurnState] = {
            p.name: _BurnState() for p in self.policies
        }
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self._server_thread: Optional[threading.Thread] = None

    # -- membership ----------------------------------------------------------
    def sync_membership(self, hosts: dict) -> dict:
        """Converge the scraped host set onto ``hosts`` (host_id ->
        metrics base URL): new ids join, departed ids are marked (stale
        now, dropped after ``stale_drop_s``), returners are re-adopted
        in place — their series resume under the same ``host`` label.
        Returns ``{"added": [...], "departed": [...], "returned":
        [...]}``.  Safe from any thread; the watcher calls it between
        scrapes."""
        now = self._clock()
        added, departed, returned = [], [], []
        with self._lock:
            for hid, url in dict(hosts).items():
                hid = str(hid)
                hs = self._hosts.get(hid)
                if hs is None:
                    self._hosts[hid] = _HostState(
                        host_id=hid, url=str(url).rstrip("/")
                    )
                    added.append(hid)
                else:
                    hs.url = str(url).rstrip("/")
                    if hs.departed_t is not None:
                        hs.departed_t = None
                        returned.append(hid)
            for hid, hs in self._hosts.items():
                if hid not in hosts and hs.departed_t is None:
                    hs.departed_t = now
                    hs.stale = True
                    departed.append(hid)
            live = sum(
                1 for hs in self._hosts.values()
                if hs.departed_t is None
            )
            self.registry.gauge("fleet_hosts_count").set(live)
            if added or departed or returned:
                self.registry.counter(
                    "fleet_membership_changes_total"
                ).inc(len(added) + len(departed) + len(returned))
        if added or departed or returned:
            telemetry_mod.current().event(
                "fleet.membership_changed",
                added=added, departed=departed, returned=returned,
            )
        return {
            "added": added, "departed": departed, "returned": returned,
        }

    def _drop_departed_locked(self, now: float) -> None:
        # Caller holds self._lock.  A departed host's series stay
        # visible (marked stale) for stale_drop_s, then disappear from
        # the exposition entirely — bounded aging, not forever-sums.
        drop = [
            hid for hid, hs in self._hosts.items()
            if hs.departed_t is not None
            and now - hs.departed_t > self.stale_drop_s
        ]
        for hid in drop:
            del self._hosts[hid]
            self.registry.counter("fleet_hosts_dropped_total").inc()
        for hid in drop:
            telemetry_mod.current().event(
                "fleet.host_dropped",
                host=hid, stale_drop_s=self.stale_drop_s,
            )

    # -- scraping ------------------------------------------------------------
    def _scrape_host(self, hs: _HostState, now: float) -> bool:
        from photon_ml_tpu_torch.chaos import core as chaos_mod

        hs.scrapes += 1
        try:
            # The partition seam: a fault here is this host dropping off
            # the network mid-scrape — degrade to last-seen, never wedge.
            chaos_mod.maybe_fail("telemetry.scrape", host=hs.host_id)
            snap = self._fetch(hs.url + "/snapshot", self.scrape_timeout_s)
        except Exception as exc:  # noqa: BLE001 — degrade, never die
            hs.failures += 1
            self.registry.counter("fleet_scrape_failures_total").inc()
            if not hs.stale:
                hs.stale = True
                telemetry_mod.current().event(
                    "fleet.scrape_stale", host=hs.host_id,
                    reason=str(exc)[:200],
                )
            return False
        transport = snap.get("transport")
        if not isinstance(transport, dict):
            # A host whose /snapshot carries no mergeable state.  Fold
            # what we can (counters/gauges merge from summaries too).
            transport = {
                "counters": snap.get("counters") or {},
                "gauges": snap.get("gauges") or {},
                "histograms": {},
            }
        hs.registry.absorb_delta(transport, hs.prev)
        self.registry.absorb_delta(transport, hs.prev)
        hs.prev = transport
        hs.last_snapshot = snap
        hs.last_success_t = now
        hs.identity = snap.get("host") or {
            "host_id": hs.host_id, "pid": snap.get("pid")
        }
        if hs.stale:
            hs.stale = False
            telemetry_mod.current().event(
                "fleet.scrape_recovered", host=hs.host_id
            )
        return True

    def poll_once(self, now: Optional[float] = None) -> dict:
        """One scrape + burn-evaluation round; returns the SLO report.
        Every failure mode degrades (stale host, bad body, chaos fault)
        — the loop's only job is to keep folding what it CAN see."""
        now = self._clock() if now is None else now
        with self._lock:
            self._drop_departed_locked(now)
            for hs in list(self._hosts.values()):
                if hs.departed_t is None:
                    self._scrape_host(hs, now)
            self.registry.counter("fleet_scrapes_total").inc()
            staleness = max(
                (
                    now - hs.last_success_t
                    for hs in self._hosts.values()
                    if hs.last_success_t is not None
                    and hs.departed_t is None
                ),
                default=0.0,
            )
            self.registry.gauge("fleet_scrape_staleness_seconds").set(
                round(staleness, 6)
            )
            self._samples.append(
                (now, self.registry.transport_snapshot())
            )
            if len(self._samples) > self._max_samples:
                del self._samples[: len(self._samples)
                                  - self._max_samples]
            return self._evaluate_locked(now)

    # -- burn evaluation -----------------------------------------------------
    def _baseline(self, cutoff: float) -> Optional[dict]:
        """Newest sample at/before ``cutoff`` (else the oldest one —
        a partial window early in the run beats no signal)."""
        if not self._samples:
            return None
        base = self._samples[0][1]
        for t, snap in self._samples:
            if t > cutoff:
                break
            base = snap
        return base

    def _window_burn(
        self, policy: SloPolicy, cur: dict, now: float, window_s: float
    ) -> dict:
        base = self._baseline(now - window_s) or {}
        total, bad = 0, 0
        if policy.p99_s is not None:
            total, bad = _hist_bad_split(
                (cur.get("histograms") or {}).get(policy.latency_metric),
                (base.get("histograms") or {}).get(policy.latency_metric),
                policy.p99_s,
            )
        if policy.error_counter is not None:
            errs = (cur.get("counters") or {}).get(
                policy.error_counter, 0
            ) - (base.get("counters") or {}).get(policy.error_counter, 0)
            errs = max(0, errs)
            total += errs
            bad += errs
        ratio = bad / total if total else 0.0
        return {
            "window_s": window_s,
            "total": total,
            "bad": bad,
            "bad_ratio": round(ratio, 6),
            "burn": round(ratio / policy.error_budget, 4),
        }

    def _evaluate_locked(self, now: float) -> dict:
        cur = self._samples[-1][1] if self._samples else {}
        tel = telemetry_mod.current()
        report_policies = []
        worst_fast = 0.0
        for policy in self.policies:
            fast = self._window_burn(policy, cur, now,
                                     policy.fast_window_s)
            slow = self._window_burn(policy, cur, now,
                                     policy.slow_window_s)
            state = self._burn[policy.name]
            firing = (
                fast["total"] > 0
                and fast["burn"] >= policy.burn_threshold
                and slow["burn"] >= policy.burn_threshold
            )
            worst_fast = max(worst_fast, fast["burn"])
            if firing and not state.alerting:
                # Edge-triggered: one alert per excursion, re-armed when
                # the burn falls back under threshold.
                state.alerts += 1
                self.registry.counter("slo_burn_alerts_total").inc()
                tel.event(
                    "slo.burn",
                    policy=policy.name,
                    fast_burn=fast["burn"],
                    slow_burn=slow["burn"],
                    bad_ratio=fast["bad_ratio"],
                    budget=policy.error_budget,
                    threshold=policy.burn_threshold,
                )
                tel.dump_flight_recorder(
                    reason=f"slo.burn: {policy.name} fast={fast['burn']}"
                           f"x slow={slow['burn']}x"
                )
            state.alerting = firing
            entry = {
                "policy": policy.name,
                "latency_metric": policy.latency_metric,
                "p99_s": policy.p99_s,
                "error_budget": policy.error_budget,
                "threshold": policy.burn_threshold,
                "fast": fast,
                "slow": slow,
                "alerting": firing,
                "alerts": state.alerts,
            }
            state.last = entry
            report_policies.append(entry)
        self.registry.gauge("slo_burn_fast_ratio").set(
            round(worst_fast, 4)
        )
        return {
            "policies": report_policies,
            "hosts": self._host_report_locked(now),
        }

    def _host_report_locked(self, now: float) -> dict:
        return {
            hs.host_id: {
                "url": hs.url,
                "stale": hs.stale,
                "departed": hs.departed_t is not None,
                "staleness_s": (
                    None if hs.last_success_t is None
                    else round(now - hs.last_success_t, 6)
                ),
                "scrapes": hs.scrapes,
                "failures": hs.failures,
                "identity": hs.identity,
            }
            for hs in self._hosts.values()
        }

    # -- views ---------------------------------------------------------------
    def slo_report(self) -> dict:
        now = self._clock()
        with self._lock:
            return {
                "policies": [
                    self._burn[p.name].last
                    or {"policy": p.name, "alerting": False, "alerts": 0}
                    for p in self.policies
                ],
                "hosts": self._host_report_locked(now),
            }

    def prometheus_text(self) -> str:
        """Fleet exposition: the unlabeled fleet-wide fold, then every
        metric again per host as ``name{host="hid"}``, each host also
        carrying ``fleet_host_stale_count{host=...}`` (1 = last scrape
        failed or membership departed — the series is last-seen data,
        not live)."""
        with self._lock:
            fleet = self.registry.snapshot()
            per_host = {
                hs.host_id: (hs.registry.snapshot(), hs.stale)
                for hs in self._hosts.values()
                if hs.last_success_t is not None
            }
        lines = _exposition_lines(fleet, None, emit_type=True)
        lines.append("# TYPE fleet_host_stale_count gauge")
        for hid in sorted(per_host):
            snap, stale = per_host[hid]
            lines.append(
                f'fleet_host_stale_count{{host="{hid}"}} '
                f"{1 if stale else 0}"
            )
            lines.extend(_exposition_lines(snap, hid, emit_type=False))
        return "\n".join(lines) + "\n"

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetAggregator":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="fleet-aggregator", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the fold must survive
                pass

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Mount the fleet HTTP plane (``/metrics`` ``/slo``
        ``/healthz``); returns the bound port."""
        if self._server is not None:
            return self._server.server_address[1]
        self._server = _FleetServer((host, port), _FleetHandler)
        self._server.aggregator = self
        self._server_thread = threading.Thread(
            target=self._server.serve_forever,
            name="fleet-aggregator-http", daemon=True,
        )
        self._server_thread.start()
        return self._server.server_address[1]

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=timeout)
        server, sthread = self._server, self._server_thread
        self._server, self._server_thread = None, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if sthread is not None:
            sthread.join(timeout=timeout)

    def __enter__(self) -> "FleetAggregator":
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


def _exposition_lines(
    snapshot: dict, host: Optional[str], emit_type: bool
) -> list[str]:
    """Prometheus lines for one snapshot, optionally ``host``-labeled.
    (exporter.prometheus_text renders unlabeled text; the fleet view
    needs the label merged INSIDE existing quantile braces, so this is
    its own renderer rather than a post-hoc string patch.)"""

    def _labels(extra: Optional[str] = None) -> str:
        parts = []
        if extra:
            parts.append(extra)
        if host is not None:
            parts.append(f'host="{host}"')
        return "{" + ",".join(parts) + "}" if parts else ""

    lines: list[str] = []
    for name in sorted(snapshot.get("counters") or {}):
        value = snapshot["counters"][name]
        if not isinstance(value, (int, float)):
            continue
        safe = _sanitize(name)
        if emit_type:
            lines.append(f"# TYPE {safe} counter")
        lines.append(f"{safe}{_labels()} {_fmt(value)}")
    for name in sorted(snapshot.get("gauges") or {}):
        value = snapshot["gauges"][name]
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            continue
        safe = _sanitize(name)
        if emit_type:
            lines.append(f"# TYPE {safe} gauge")
        lines.append(f"{safe}{_labels()} {_fmt(value)}")
    for name in sorted(snapshot.get("histograms") or {}):
        h = snapshot["histograms"][name]
        if not h.get("count"):
            continue
        safe = _sanitize(name)
        if emit_type:
            lines.append(f"# TYPE {safe} summary")
        for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
            v = h.get(key)
            if v is not None:
                qlabel = 'quantile="%s"' % q
                lines.append(f"{safe}{_labels(qlabel)} {_fmt(v)}")
        lines.append(f"{safe}_sum{_labels()} {_fmt(h['sum'])}")
        lines.append(f"{safe}_count{_labels()} {h['count']}")
    return lines


class _FleetServer(ThreadingHTTPServer):
    daemon_threads = True
    aggregator: "FleetAggregator"


class _FleetHandler(BaseHTTPRequestHandler):
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
        agg = self.server.aggregator
        if self.path == "/metrics":
            self._send(
                200, agg.prometheus_text().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        elif self.path == "/slo":
            self._send(
                200, json.dumps(agg.slo_report()).encode(),
                "application/json",
            )
        elif self.path in ("/healthz", "/livez"):
            self._send(
                200, json.dumps({"status": "ok"}).encode(),
                "application/json",
            )
        else:
            self._send(
                404,
                json.dumps({"error": f"no route {self.path}"}).encode(),
                "application/json",
            )
