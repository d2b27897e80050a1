"""Fleet tier: one router over N serving HOSTS + fleet-wide quota leases
(port of ``photon_ml_tpu/serving/fleet.py``).

ROADMAP item 3's last open layer.  One ``ScoringService`` — even with a
``ReplicaSupervisor`` and process workers under it — is still ONE host:
one kernel, one NIC, one power feed.  This module is the node tier of
Snap ML's hierarchical split (PAPERS.md): whole hosts behind one front
door, built failure-first.

- :class:`FleetRouter` — routes scoring requests across N host
  endpoints (each a full ``ScoringService`` in thread or process mode,
  reached over the existing HTTP JSON protocol, serving/service.py).
  The supervisor's replica discipline, one tier up: requests round-robin
  over HEALTHY hosts; a transient host failure (connection refused,
  reset, 5xx, a watchdog-transient error body) marks the host DOWN and
  RESUBMITS the request to a peer — the client's future only fails when
  every host has been tried, so a host kill under load costs zero
  failed requests.  Down hosts are re-probed behind decorrelated-jitter
  backoff (``utils/watchdog.RetryPolicy``) and rejoin on sustained
  health, which also resets the backoff walk.  ``drain(hid)`` removes a
  host gracefully: no new routing, in-flight requests complete, then
  the host leaves the rotation.
- :class:`QuotaCoordinator` — turns the per-batcher ``TokenBucket``\\ s
  (serving/tenancy.py) into FLEET-accurate enforcement.  Each tenant
  has one fleet budget; hosts hold short-lived rate LEASES carved from
  it.  On every renewal the coordinator rebalances lease shares by
  observed per-host demand (with a min-share floor so a quiet host can
  still admit a sudden burst) and reclaims leases whose hosts stopped
  renewing (host death).  Outstanding grants never sum past the
  budget, so fleet-wide admission is bounded by construction.
- :class:`LeaseClient` — the host-side agent: measures this host's
  per-tenant demand (``ScoringService.demand_snapshot`` deltas), renews
  through the ``quota.lease`` chaos seam, and applies granted rates to
  the host's buckets via ``ScoringService.set_tenant_quota`` (thread
  mode mutates batcher buckets; process mode rides a ``set_quota``
  worker frame).  **The partition-tolerance contract:** a host that
  cannot reach the coordinator keeps enforcing its LAST lease — never
  unlimited, never zero — so a partition bounds fleet over-admission
  to one lease window (the stale host can only admit what it was last
  granted, and the coordinator stops counting that grant after
  ``lease_ttl_s``).
- :class:`LocalHost` — one in-process "host": a full ScoringService
  behind its own HTTP listener on an ephemeral port, with scripted
  ``kill()`` (listener torn down abruptly — new connections refuse,
  exactly what a crashed host looks like from the router) and
  ``restart()`` (rebind the same port).  The substrate for the
  ``host_kill`` / ``quota_partition`` scenarios, the fleet selfcheck,
  and bench gates; a production host runs the same service standalone.

Chaos seams: ``serving.host`` fires at routing time (a fault is a host
dying as it picks up the request — mark down + resubmit, zero failed
requests); ``quota.lease`` fires in the lease renewal (a fault is the
coordinator partition — degrade to the last lease).  Metric family:
``serving_fleet_*`` (docs/telemetry.md).  See docs/serving.md "Fleet"
and ops/README.md for the host-down / coordinator-unreachable runbooks.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import random
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future
from typing import Callable, Optional

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.serving.batcher import (
    DeadlineExceededError,
    RejectedError,
)
from photon_ml_tpu_torch.serving import wire as wire_mod
from photon_ml_tpu_torch.utils.watchdog import RetryPolicy


# ---------------------------------------------------------------------------
# HTTP plumbing (stdlib only; one fresh connection per request keeps the
# failure model simple — a dead host is ECONNREFUSED, not a stale pool)
# ---------------------------------------------------------------------------

def _http_json(
    method: str, url: str, payload: Optional[dict] = None,
    timeout_s: float = 30.0,
) -> tuple[int, dict]:
    """One JSON round-trip; returns ``(status, body)``.  Non-2xx statuses
    return normally (the body carries the verdict); only transport-level
    failures (refused, reset, timeout) raise."""
    data = None if payload is None else json.dumps(payload).encode()
    return _http_post_raw(
        url, data, "application/json", timeout_s, method=method
    )


def _http_post_raw(
    url: str, body: Optional[bytes], content_type: str,
    timeout_s: float = 30.0, method: str = "POST",
    headers: Optional[dict] = None,
) -> tuple[int, dict]:
    """One round-trip with a PRE-ENCODED body; returns ``(status,
    body_dict)``.  A binary response frame decodes into the same
    ``{"results": [...]}`` shape the JSON path returns (plus a
    top-level ``"error"`` mirror of the first failed row, so the
    status-code verdict logic reads both formats identically).
    ``headers`` adds extra request headers (the trace-context header
    rides here) without touching the content-type negotiation."""
    hdrs = {"Content-Type": content_type}
    if headers:
        hdrs.update(headers)
    req = urllib.request.Request(
        url, data=body, method=method, headers=hdrs,
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, _parse_response(
                resp.headers.get("Content-Type"), resp.read()
            )
    except urllib.error.HTTPError as exc:
        return exc.code, _parse_response(
            exc.headers.get("Content-Type") if exc.headers else None,
            exc.read(),
        )


def _parse_response(content_type: Optional[str], raw: bytes) -> dict:
    ctype = (content_type or "").split(";", 1)[0].strip().lower()
    if ctype == wire_mod.CONTENT_TYPE:
        try:
            results = wire_mod.decode_response(raw)
        except wire_mod.WireFormatError as exc:
            return {"error": f"bad response frame: {exc}"}
        out = {"results": results}
        if results and isinstance(results[0], dict) \
                and "error" in results[0]:
            out["error"] = results[0]["error"]
        return out
    try:
        return json.loads(raw or b"{}")
    except json.JSONDecodeError:
        return {"error": raw.decode(errors="replace")}


_ERROR_BUILDERS = {
    "rejected": RejectedError,
    "deadline": DeadlineExceededError,
    "bad_request": ValueError,
}

_STATUS_KIND = {429: "rejected", 504: "deadline", 400: "bad_request"}


# ---------------------------------------------------------------------------
# FleetRouter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _FleetHost:
    hid: int
    base_url: str
    state: str = "healthy"  # "healthy" | "down" | "draining" | "removed"
    inflight: int = 0
    probe_failures: int = 0
    reconnect_attempt: int = 0
    last_delay: Optional[float] = None
    next_reconnect_t: float = 0.0
    reconnects: int = 0
    down_reason: Optional[str] = None
    requests: int = 0


_STOP = object()


class FleetRouter:
    """Front-tier router over N host endpoints (HTTP base URLs).

    Mirrors enough of the ``ScoringService`` surface (``submit`` /
    ``score`` / ``score_many`` / ``healthz`` / ``readiness`` /
    ``stats``) that loadgen, scenarios, and callers compose with a
    fleet exactly as they do with one service.  ``submit`` takes the
    WIRE request (the JSON dict a client would POST) — parsing happens
    host-side, where the model lives.
    """

    def __init__(
        self,
        endpoints: list,
        policy: Optional[RetryPolicy] = None,
        reconnect_policy: Optional[RetryPolicy] = None,
        probe_interval_s: float = 0.25,
        probe_timeout_s: float = 5.0,
        probe_failure_threshold: int = 2,
        request_timeout_s: float = 30.0,
        no_host_retry_s: float = 5.0,
        workers: int = 16,
        max_pending: int = 1024,
        rng: Optional[random.Random] = None,
        clock: Callable[[], float] = time.monotonic,
        wire_format: str = "json",
    ):
        if not endpoints:
            raise ValueError("FleetRouter needs at least one endpoint")
        if wire_format not in ("json", "binary"):
            raise ValueError(
                f"wire_format must be 'json' or 'binary', got "
                f"{wire_format!r}"
            )
        #: request encoding toward the hosts: "binary" sends wire
        #: frames (serving/wire.py) and falls back to JSON per-request
        #: when a row is not frame-encodable (named sparse features).
        self.wire_format = wire_format
        self.policy = policy or RetryPolicy()
        self.reconnect_policy = reconnect_policy or RetryPolicy(
            backoff_seconds=0.05,
            max_backoff_seconds=2.0,
            jitter="decorrelated",
        )
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.probe_failure_threshold = probe_failure_threshold
        self.request_timeout_s = request_timeout_s
        #: how long a request with NO healthy host waits for reconnect
        #: probes to restore one before failing — a whole-fleet blip
        #: (every host mid-reconnect at once) delays requests instead
        #: of failing them, the same contract a single host's kill has.
        self.no_host_retry_s = no_host_retry_s
        self.max_pending = max_pending
        self._rng = rng or random.Random(0)
        self._clock = clock
        self.hosts = [
            _FleetHost(hid=i, base_url=str(url).rstrip("/"))
            for i, url in enumerate(endpoints)
        ]
        self._lock = sanitizers.tracked(threading.Lock(), "serving.fleet")
        self._rr = 0
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._workers = max(1, int(workers))
        self._threads: list[threading.Thread] = []
        self._probe_thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._started:
            return self
        self._stop_evt.clear()
        for i in range(self._workers):
            t = threading.Thread(
                target=self._work_loop, name=f"fleet-router-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="fleet-probe", daemon=True
        )
        self._probe_thread.start()
        self._started = True
        tel = telemetry_mod.current()
        tel.gauge("serving_fleet_hosts_count").set(len(self.hosts))
        tel.gauge("serving_fleet_healthy_hosts_count").set(
            self.healthy_count
        )
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if not self._started:
            return
        self._stop_evt.set()
        for _ in self._threads:
            self._queue.put(_STOP)
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []
        thread = self._probe_thread
        self._probe_thread = None
        if thread is not None:
            thread.join(timeout=timeout)
        # Fail anything that raced past submit after the stop — no
        # worker will ever route it.  Transient vocabulary, like the
        # batcher's drain: the caller may retry against a new router.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            fut = item[1]
            if fut.set_running_or_notify_cancel():
                fut.set_exception(RuntimeError(
                    "UNAVAILABLE: fleet router stopped before dispatch; "
                    "retry with backoff"
                ))
        self._started = False

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- submission (any thread) -------------------------------------------
    def submit(self, request: dict) -> Future:
        """Enqueue one wire request; returns a future resolving to the
        per-row result dict.  Raises RejectedError when the router's own
        pending queue is full (backpressure, not a host verdict)."""
        if not self._started:
            raise RuntimeError("fleet router is not started")
        # The router is the request's entry into the fleet: mint the
        # ROOT trace context here (head sampling decides once, every
        # downstream hop re-derives the verdict from the id) — unless
        # the caller is already inside a traced request, whose context
        # propagates instead.
        tel = telemetry_mod.current()
        ctx = tel.propagation_context()
        if ctx is None and tel.active:
            ctx = tel.new_trace()
        fut: Future = Future()
        try:
            self._queue.put_nowait(
                (request, fut, time.perf_counter(), ctx)
            )
        except queue.Full:
            telemetry_mod.current().counter(
                "serving_fleet_rejected_total"
            ).inc()
            raise RejectedError(
                f"UNAVAILABLE: fleet router pending queue full "
                f"({self.max_pending}); retry with backoff"
            ) from None
        telemetry_mod.current().counter(
            "serving_fleet_requests_total"
        ).inc()
        return fut

    def score(self, request: dict, timeout: Optional[float] = 30.0) -> dict:
        return self.submit(request).result(timeout=timeout)

    def score_many(
        self, requests: list, timeout: Optional[float] = 30.0
    ) -> list:
        slots: list = [None] * len(requests)
        futures = []
        for i, req in enumerate(requests):
            try:
                futures.append((i, self.submit(req)))
            except (RejectedError, ValueError) as exc:
                slots[i] = {"error": str(exc), "kind": "rejected"}
        for i, fut in futures:
            try:
                slots[i] = fut.result(timeout=timeout)
            except Exception as exc:  # noqa: BLE001 — per-row reporting
                slots[i] = {"error": str(exc), "kind": "error"}
        return slots

    # -- routing (worker threads) ------------------------------------------
    def _work_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            try:
                self._route(item)
            except Exception as exc:  # noqa: BLE001 — never kill a worker
                fut = item[1]
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(exc)

    def _pick(self, tried: set) -> Optional[_FleetHost]:
        with self._lock:
            candidates = [
                h for h in self.hosts
                if h.state == "healthy" and h.hid not in tried
            ]
            if not candidates:
                return None
            self._rr += 1
            host = candidates[self._rr % len(candidates)]
            host.inflight += 1
            host.requests += 1
            return host

    def _release(self, host: _FleetHost) -> None:
        with self._lock:
            host.inflight -= 1

    def _encode_request(
        self, request: dict, trace: Optional[str] = None
    ) -> tuple[bytes, str]:
        """Encode one wire request body, ONCE per routed request — the
        peer-retry loop reuses these bytes on every resubmission, so a
        retry costs a socket, never a re-serialization.  ``trace`` rides
        the frame's v2 ``trace:ctx`` column on the binary path (the
        JSON path carries it as an HTTP header instead)."""
        if self.wire_format == "binary":
            try:
                return (
                    wire_mod.encode_request([request], trace=trace),
                    wire_mod.CONTENT_TYPE,
                )
            except ValueError:
                # Not frame-encodable (named sparse features) — the
                # JSON compatibility path carries it instead.
                pass
        return (
            json.dumps({"rows": [request]}).encode(),
            "application/json",
        )

    def _route(self, item) -> None:
        request, fut, t_submit, ctx = item
        tel = telemetry_mod.current()
        # The routing span is the trace's root span on this node: every
        # host-side hop parents to it via the propagated context (HTTP
        # header on the JSON path, wire v2 trace:ctx column on the
        # binary path), so one fleet request reads as ONE stitched tree
        # across router, host, and worker processes.
        with tel.adopt(ctx), tel.span("serving.fleet_route"):
            pctx = tel.propagation_context()
            trace_value = None if pctx is None else pctx.header_value()
            headers = (
                {telemetry_mod.TRACE_HEADER: trace_value}
                if trace_value is not None else None
            )
            body, content_type = self._encode_request(request, trace_value)
            self._route_one(
                fut, t_submit, body, content_type, headers, tel
            )

    def _route_one(
        self, fut, t_submit, body, content_type, headers, tel
    ) -> None:
        tried: set = set()
        last_reject: Optional[Exception] = None
        no_host_deadline: Optional[float] = None
        while True:
            host = self._pick(tried)
            if host is None:
                # An admission verdict (every host shed the row) is
                # final here: the caller must back off, peers spinning
                # would only re-offer over-quota work.
                if last_reject is None:
                    # Transport/outage verdicts are not: wait for the
                    # reconnect probes to restore a host (a killed host
                    # delays requests, never fails them — including the
                    # window where EVERY host is momentarily down).
                    now = self._clock()
                    if no_host_deadline is None:
                        no_host_deadline = now + self.no_host_retry_s
                    if now < no_host_deadline and not \
                            self._stop_evt.wait(0.02):
                        tried.clear()
                        continue
                exc = last_reject or RejectedError(
                    "UNAVAILABLE: no healthy host "
                    f"({self.healthy_count} healthy, {len(tried)} "
                    "tried); retry with backoff"
                )
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(exc)
                return
            try:
                # The scripted-crash seam: a fault here is the host
                # dying as it picks up the request (docs/robustness.md).
                chaos_mod.maybe_fail("serving.host", host=host.hid)
                status, obj = _http_post_raw(
                    host.base_url + "/score", body, content_type,
                    self.request_timeout_s, headers=headers,
                )
            except Exception as exc:  # noqa: BLE001 — transport failure
                self._release(host)
                self._mark_down(host, f"request failed: {exc}"[:200])
                tried.add(host.hid)
                tel.counter("serving_fleet_resubmitted_total").inc()
                continue
            self._release(host)
            verdict = self._verdict(status, obj)
            kind, payload = verdict
            if kind == "ok":
                if fut.set_running_or_notify_cancel():
                    fut.set_result(payload)
                tel.histogram(
                    "serving_fleet_request_latency_seconds"
                ).observe(time.perf_counter() - t_submit)
                return
            if kind == "rejected":
                # This host's admission control shed the row; a peer
                # below its watermarks (or with lease tokens left) may
                # still admit it — total admission stays budget-bounded
                # because every host draws from its own lease.
                tried.add(host.hid)
                last_reject = payload
                continue
            if kind == "transient":
                # The HOST's fault (5xx, transient error body): mark it
                # down and resubmit to a peer.
                self._mark_down(host, f"transient failure: {payload}")
                tried.add(host.hid)
                tel.counter("serving_fleet_resubmitted_total").inc()
                continue
            # The REQUEST's own verdict (expired deadline, bad input) —
            # another host would only repeat it.
            if fut.set_running_or_notify_cancel():
                fut.set_exception(payload)
            return

    def _verdict(self, status: int, obj: dict) -> tuple:
        """Map one HTTP response to a routing verdict:
        ``("ok", result)`` / ``("rejected", exc)`` / ``("final", exc)``
        / ``("transient", reason_str)``."""
        if status == 200:
            results = obj.get("results") or [{}]
            result = results[0] if results else {}
            if not isinstance(result, dict) or "error" not in result:
                return ("ok", result)
            kind = result.get("kind", "internal")
            message = str(result.get("error", ""))
            if kind in _ERROR_BUILDERS:
                exc = _ERROR_BUILDERS[kind](message)
                if kind == "rejected":
                    return ("rejected", exc)
                return ("final", exc)
            # "internal": classify the message — the transient
            # vocabulary (UNAVAILABLE, worker died, ...) is the host's
            # fault and resubmits; anything else is final.
            if self.policy.classify(RuntimeError(message)).transient:
                return ("transient", message[:200])
            return ("final", RuntimeError(message))
        kind = _STATUS_KIND.get(status)
        if kind is not None:
            message = str(obj.get("error") or obj)[:500]
            exc = _ERROR_BUILDERS[kind](message)
            if kind == "rejected":
                return ("rejected", exc)
            return ("final", exc)
        return ("transient", f"HTTP {status}: {obj.get('error', obj)}"[:200])

    # -- failure handling --------------------------------------------------
    @property
    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for h in self.hosts if h.state == "healthy")

    def _mark_down(self, host: _FleetHost, reason: str) -> None:
        """Exclude a host from routing and schedule reconnect probes
        with decorrelated-jitter backoff.  Never blocks."""
        with self._lock:
            if host.state != "healthy":
                return
            host.state = "down"
            host.down_reason = reason
            host.probe_failures = 0
            delay = self.reconnect_policy.backoff(
                host.reconnect_attempt, rng=self._rng,
                previous=host.last_delay,
            )
            host.reconnect_attempt += 1
            host.last_delay = delay
            host.next_reconnect_t = self._clock() + delay
        tel = telemetry_mod.current()
        tel.counter("serving_fleet_host_down_total").inc()
        tel.gauge("serving_fleet_healthy_hosts_count").set(
            self.healthy_count
        )
        tel.event(
            "serving.fleet_host_down",
            host=host.hid,
            url=host.base_url,
            reason=reason,
            reconnect_in_s=round(delay, 4),
        )

    # -- probing (supervision thread) --------------------------------------
    def _probe_loop(self) -> None:
        while not self._stop_evt.wait(self.probe_interval_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — supervision must survive
                pass

    def _tick(self) -> None:
        now = self._clock()
        for host in list(self.hosts):
            if self._stop_evt.is_set():
                return
            if host.state == "down" and now >= host.next_reconnect_t:
                self._reconnect_probe(host, now)
            elif host.state == "healthy":
                self._probe(host)

    def _probe_ready(self, host: _FleetHost) -> bool:
        status, _ = _http_json(
            "GET", host.base_url + "/readyz",
            timeout_s=self.probe_timeout_s,
        )
        return status == 200

    def _probe(self, host: _FleetHost) -> None:
        try:
            ready = self._probe_ready(host)
            if not ready:
                raise RuntimeError("host reports not_ready")
        except Exception as exc:  # noqa: BLE001 — any failure counts
            host.probe_failures += 1
            telemetry_mod.current().counter(
                "serving_fleet_probe_failures_total"
            ).inc()
            if host.probe_failures >= self.probe_failure_threshold:
                self._mark_down(
                    host,
                    f"{host.probe_failures} consecutive probe failures "
                    f"(last: {exc})"[:200],
                )
            return
        host.probe_failures = 0
        # Sustained health resets the backoff walk — same contract as
        # the supervisor one tier down (a host answering probes again
        # is trusted again; flapping hosts re-escalate from base).
        host.reconnect_attempt = 0
        host.last_delay = None

    def _reconnect_probe(self, host: _FleetHost, now: float) -> None:
        try:
            if not self._probe_ready(host):
                raise RuntimeError("host reports not_ready")
        except Exception:  # noqa: BLE001 — still down; re-schedule
            with self._lock:
                delay = self.reconnect_policy.backoff(
                    host.reconnect_attempt, rng=self._rng,
                    previous=host.last_delay,
                )
                host.reconnect_attempt += 1
                host.last_delay = delay
                host.next_reconnect_t = self._clock() + delay
            return
        with self._lock:
            host.state = "healthy"
            host.probe_failures = 0
            host.down_reason = None
            host.reconnects += 1
        tel = telemetry_mod.current()
        tel.counter("serving_fleet_reconnects_total").inc()
        tel.gauge("serving_fleet_healthy_hosts_count").set(
            self.healthy_count
        )
        tel.event(
            "serving.fleet_host_reconnected",
            host=host.hid,
            reconnects=host.reconnects,
        )

    # -- draining / membership ---------------------------------------------
    def drain(self, hid: int, timeout_s: float = 10.0) -> bool:
        """Graceful host removal: stop routing NEW requests to ``hid``,
        wait for its in-flight requests to complete, then take it out of
        the rotation.  Returns True when the host drained inside the
        timeout (False leaves it 'draining': still unrouted, still
        counted in-flight — retry or escalate to kill)."""
        host = next((h for h in self.hosts if h.hid == hid), None)
        if host is None:
            raise ValueError(
                f"unknown host id {hid!r}; known: "
                f"{sorted(h.hid for h in self.hosts)}"
            )
        with self._lock:
            if host.state == "removed":
                return True
            host.state = "draining"
        tel = telemetry_mod.current()
        tel.gauge("serving_fleet_healthy_hosts_count").set(
            self.healthy_count
        )
        deadline = self._clock() + timeout_s
        while self._clock() < deadline:
            with self._lock:
                drained = host.inflight == 0
            if drained:
                with self._lock:
                    host.state = "removed"
                tel.counter("serving_fleet_drains_total").inc()
                tel.event("serving.fleet_host_drained", host=hid)
                return True
            time.sleep(0.005)
        return False

    def add_host(self, base_url: str) -> int:
        """Add a host to the rotation (it must already answer /readyz —
        probe verdicts take over from there)."""
        with self._lock:
            hid = max((h.hid for h in self.hosts), default=-1) + 1
            self.hosts.append(
                _FleetHost(hid=hid, base_url=str(base_url).rstrip("/"))
            )
        telemetry_mod.current().gauge("serving_fleet_hosts_count").set(
            len(self.hosts)
        )
        return hid

    def join(self, base_url: str) -> int:
        """Symmetric counterpart to :meth:`drain`: register a host into
        the LIVE rotation without a router restart.  Unlike
        :meth:`add_host` (which trusts the caller and routes
        immediately), a joined host enters as ``down`` with an
        immediate reconnect probe scheduled — it starts taking traffic
        only after it answers ``/readyz``, so joining a host that is
        still warming up never costs a request.  Re-joining a known URL
        (drained/removed or currently down) revives the SAME host id
        with fresh probe state.  Returns the host id."""
        url = str(base_url).rstrip("/")
        with self._lock:
            host = next(
                (h for h in self.hosts if h.base_url == url), None
            )
            if host is not None and host.state in ("healthy", "draining"):
                # Already in rotation: joining is idempotent.
                return host.hid
            if host is None:
                hid = max((h.hid for h in self.hosts), default=-1) + 1
                host = _FleetHost(hid=hid, base_url=url)
                self.hosts.append(host)
            host.state = "down"
            host.down_reason = "joining (awaiting first ready probe)"
            host.probe_failures = 0
            host.reconnect_attempt = 0
            host.last_delay = None
            host.next_reconnect_t = 0.0  # probe on the next tick
        tel = telemetry_mod.current()
        tel.counter("serving_fleet_joins_total").inc()
        tel.gauge("serving_fleet_hosts_count").set(len(self.hosts))
        tel.event(
            "serving.fleet_host_joined", host=host.hid, url=url,
        )
        return host.hid

    # -- observability -----------------------------------------------------
    def readiness(self) -> tuple[bool, str]:
        healthy = self.healthy_count
        if not self._started:
            return False, "not started"
        if healthy == 0:
            return False, "no healthy host"
        return True, "ok"

    def healthz(self) -> dict:
        with self._lock:
            hosts = [
                {
                    "hid": h.hid,
                    "url": h.base_url,
                    "state": h.state,
                    "inflight": h.inflight,
                    "probe_failures": h.probe_failures,
                    "reconnect_attempt": h.reconnect_attempt,
                    "reconnects": h.reconnects,
                    "down_reason": h.down_reason,
                    "requests": h.requests,
                }
                for h in self.hosts
            ]
        healthy = sum(1 for h in hosts if h["state"] == "healthy")
        active = sum(
            1 for h in hosts if h["state"] not in ("removed",)
        )
        return {
            "status": (
                "stopped" if not self._started
                else "down" if healthy == 0
                else "degraded" if healthy < active
                else "ok"
            ),
            "hosts": hosts,
            "healthy_hosts": healthy,
        }

    def stats(self) -> dict:
        out = self.healthz()
        out["pending"] = self._queue.qsize()
        out["max_pending"] = self.max_pending
        return out


# ---------------------------------------------------------------------------
# QuotaCoordinator: fleet budgets -> per-host leases
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetBudget:
    """One tenant's fleet-wide admission budget.

    ``burst_s`` sizes lease bursts in seconds-at-rate (a lease of R rps
    carries ``max(1, R * burst_s)`` bucket tokens); ``min_share`` is
    the fraction of the budget reserved as an equal floor across live
    hosts, so a host with zero observed demand still holds a nonzero
    lease and can admit the first requests of a traffic shift without
    waiting a renewal cycle."""

    tenant: str
    rate_rps: float
    burst_s: float = 1.0
    min_share: float = 0.1

    def __post_init__(self):
        if self.rate_rps < 0:
            raise ValueError(
                f"rate_rps must be >= 0, got {self.rate_rps}"
            )
        if not (0.0 <= self.min_share <= 1.0):
            raise ValueError(
                f"min_share must be in [0, 1], got {self.min_share}"
            )


@dataclasses.dataclass(frozen=True)
class Lease:
    """One host's short-lived slice of a tenant's fleet budget."""

    tenant: str
    host_id: str
    rate_rps: float
    burst: float
    seq: int
    #: coordinator-clock expiry; a host that stops renewing stops being
    #: counted against the budget after this instant (reclaim-on-death).
    expires_at: float
    window_s: float


@dataclasses.dataclass
class _Grant:
    rate_rps: float
    demand_rps: float
    expires_at: float


class QuotaCoordinator:
    """Per-tenant fleet budgets carved into per-host rate leases.

    Invariant: for each tenant, the sum of UNEXPIRED outstanding grants
    never exceeds the budget.  A renewal computes the host's demand-
    proportional target share but only grants what the budget minus
    every other live grant leaves — so rebalancing converges within one
    renewal round per host without ever over-committing, and a dead
    host's share is reclaimable the moment its lease expires.

    The coordinator is deliberately a plain object with an injectable
    clock: in-process today (tests, selfcheck, single-box fleets), an
    RPC service later — the lease algebra does not change.
    """

    def __init__(
        self,
        budgets,
        lease_ttl_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if isinstance(budgets, dict):
            budgets = [
                FleetBudget(tenant=t, rate_rps=float(r))
                for t, r in budgets.items()
            ]
        self.budgets: dict[str, FleetBudget] = {
            b.tenant: b for b in budgets
        }
        self.lease_ttl_s = float(lease_ttl_s)
        self._clock = clock
        self._lock = sanitizers.tracked(
            threading.Lock(), "serving.quota_coordinator"
        )
        #: tenant -> host_id -> _Grant
        self._grants: dict[str, dict[str, _Grant]] = {
            b.tenant: {} for b in self.budgets.values()
        }
        self._seq = 0
        self.renewals = 0
        self.reclaims = 0
        self.rebalances = 0

    def renew(
        self, host_id: str, demands: Optional[dict] = None
    ) -> dict[str, Lease]:
        """Grant/refresh ``host_id``'s leases for every budgeted tenant.

        ``demands`` maps tenant -> this host's observed offered rate
        (rps); missing tenants renew at zero demand (they still hold
        the min-share floor).  Returns tenant -> :class:`Lease`."""
        demands = demands or {}
        now = self._clock()
        tel = telemetry_mod.current()
        leases: dict[str, Lease] = {}
        with self._lock:
            self._seq += 1
            self.renewals += 1
            seq = self._seq
            for tenant, budget in self.budgets.items():
                grants = self._grants[tenant]
                # Reclaim leases whose hosts stopped renewing: their
                # rate goes back into the grantable pool right here.
                for h in list(grants):
                    if h != host_id and grants[h].expires_at <= now:
                        del grants[h]
                        self.reclaims += 1
                        tel.counter(
                            "serving_fleet_lease_reclaims_total"
                        ).inc()
                demand = max(0.0, float(demands.get(tenant, 0.0)))
                live = set(grants) | {host_id}
                dem = {
                    h: (demand if h == host_id
                        else grants[h].demand_rps)
                    for h in live
                }
                target = self._target_share(budget, dem, host_id)
                outstanding = sum(
                    g.rate_rps for h, g in grants.items()
                    if h != host_id
                )
                rate = max(
                    0.0, min(target, budget.rate_rps - outstanding)
                )
                previous = grants.get(host_id)
                if previous is not None and abs(
                    previous.rate_rps - rate
                ) > 1e-9:
                    self.rebalances += 1
                    tel.counter(
                        "serving_fleet_lease_rebalance_total"
                    ).inc()
                grants[host_id] = _Grant(
                    rate_rps=rate,
                    demand_rps=demand,
                    expires_at=now + self.lease_ttl_s,
                )
                leases[tenant] = Lease(
                    tenant=tenant,
                    host_id=host_id,
                    rate_rps=rate,
                    burst=max(1.0, rate * budget.burst_s),
                    seq=seq,
                    expires_at=now + self.lease_ttl_s,
                    window_s=self.lease_ttl_s,
                )
            outstanding_total = sum(
                g.rate_rps
                for grants in self._grants.values()
                for g in grants.values()
            )
        tel.counter("serving_fleet_lease_grants_total").inc(len(leases))
        tel.gauge("serving_fleet_lease_outstanding_rps").set(
            round(outstanding_total, 3)
        )
        return leases

    def restore_grant(
        self,
        tenant: str,
        host_id: str,
        rate_rps: float,
        demand_rps: float,
        expires_at: float,
    ) -> None:
        """Seed one grant from a durable record (the cluster tier's
        coordinator journal): a freshly-elected coordinator replica
        replays the previous leader's journaled grants through here, so
        its budget arithmetic starts from the SAME outstanding set the
        old leader promised — failover never double-grants a budget
        slice that is still live on some host.  Expired grants may be
        restored too; the next renewal reclaims them normally."""
        if tenant not in self.budgets:
            return  # a tenant the new configuration no longer budgets
        with self._lock:
            self._grants[tenant][str(host_id)] = _Grant(
                rate_rps=float(rate_rps),
                demand_rps=float(demand_rps),
                expires_at=float(expires_at),
            )

    @staticmethod
    def _target_share(
        budget: FleetBudget, demands: dict, host_id: str
    ) -> float:
        """Demand-proportional share with an equal min-share floor."""
        n = len(demands)
        floor = budget.rate_rps * budget.min_share / n
        variable = budget.rate_rps - floor * n
        total_demand = sum(demands.values())
        if total_demand <= 0.0:
            return budget.rate_rps / n  # no signal: equal split
        return floor + variable * demands[host_id] / total_demand

    def stats(self) -> dict:
        now = self._clock()
        with self._lock:
            tenants = {}
            for tenant, budget in self.budgets.items():
                grants = self._grants[tenant]
                tenants[tenant] = {
                    "budget_rps": budget.rate_rps,
                    "outstanding_rps": round(
                        sum(g.rate_rps for g in grants.values()), 3
                    ),
                    "hosts": {
                        h: {
                            "rate_rps": round(g.rate_rps, 3),
                            "demand_rps": round(g.demand_rps, 3),
                            "expired": g.expires_at <= now,
                        }
                        for h, g in grants.items()
                    },
                }
            return {
                "lease_ttl_s": self.lease_ttl_s,
                "renewals": self.renewals,
                "reclaims": self.reclaims,
                "rebalances": self.rebalances,
                "tenants": tenants,
            }


class LeaseClient:
    """Host-side lease agent: measure demand, renew, apply — or degrade.

    ``poll_once()`` is the whole protocol: read this host's per-tenant
    demand since the last poll (``service.demand_snapshot`` deltas),
    call ``coordinator.renew`` through the ``quota.lease`` chaos seam,
    and apply each granted lease to the host's token buckets
    (``service.set_tenant_quota``).  On ANY renewal failure — chaos
    fault, scripted ``partitioned`` flag, a real RPC error once the
    coordinator is remote — the client keeps the LAST applied lease:
    enforcement never becomes unlimited (buckets keep their rates) and
    never zero (the rates stay what they were), so a partition bounds
    fleet over-admission to one lease window.

    ``start()`` runs the loop on a daemon thread every
    ``renew_interval_s`` (default: half the coordinator's lease TTL, so
    one missed beat never expires a healthy host's lease); tests call
    ``poll_once()`` directly and never sleep."""

    def __init__(
        self,
        host_id: str,
        coordinator: QuotaCoordinator,
        service,
        renew_interval_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.host_id = str(host_id)
        self.coordinator = coordinator
        self.service = service
        self.renew_interval_s = (
            coordinator.lease_ttl_s / 2.0
            if renew_interval_s is None else float(renew_interval_s)
        )
        self._clock = clock
        #: scripted partition switch (the quota_partition scenario).
        self.partitioned = False
        self.leases: dict[str, Lease] = {}
        self.stale = False
        self.renewals = 0
        self.renew_failures = 0
        self._prev_demand: dict[str, int] = {}
        self._prev_t: Optional[float] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the protocol ------------------------------------------------------
    def _demand_rates(self, now: float) -> dict[str, float]:
        counts = self.service.demand_snapshot()
        if self._prev_t is None:
            rates = {t: 0.0 for t in counts}
        else:
            dt = max(1e-6, now - self._prev_t)
            rates = {
                t: max(0, c - self._prev_demand.get(t, 0)) / dt
                for t, c in counts.items()
            }
        self._prev_demand = counts
        self._prev_t = now
        return rates

    def poll_once(self) -> bool:
        """One renewal round; returns True when the lease refreshed.
        False = degraded to the last lease (partition contract)."""
        now = self._clock()
        rates = self._demand_rates(now)
        tel = telemetry_mod.current()
        try:
            # The partition seam: a fault here is this host losing its
            # network path to the coordinator (docs/robustness.md).
            chaos_mod.maybe_fail("quota.lease", host=self.host_id)
            if self.partitioned:
                raise RuntimeError(
                    "UNAVAILABLE: quota coordinator unreachable "
                    "(scripted partition)"
                )
            leases = self.coordinator.renew(self.host_id, rates)
        except Exception:  # noqa: BLE001 — degrade, never die
            self.renew_failures += 1
            if not self.stale:
                self.stale = True
                tel.event(
                    "serving.fleet_lease_stale", host=self.host_id,
                    failures=self.renew_failures,
                )
            tel.counter(
                "serving_fleet_lease_renew_failures_total"
            ).inc()
            return False
        for tenant, lease in leases.items():
            self.service.set_tenant_quota(
                tenant, lease.rate_rps, lease.burst
            )
        if self.stale:
            tel.event(
                "serving.fleet_lease_recovered", host=self.host_id
            )
        self.leases = leases
        self.stale = False
        self.renewals += 1
        return True

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "LeaseClient":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name=f"lease-client-{self.host_id}", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=timeout)

    def _loop(self) -> None:
        # First renewal immediately: a host should hold a real lease
        # before its first request, not one interval later.
        while True:
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the agent must survive
                pass
            if self._stop_evt.wait(self.renew_interval_s):
                return

    def stats(self) -> dict:
        return {
            "host_id": self.host_id,
            "stale": self.stale,
            "partitioned": self.partitioned,
            "renewals": self.renewals,
            "renew_failures": self.renew_failures,
            "leases": {
                t: {
                    "rate_rps": round(lease.rate_rps, 3),
                    "burst": round(lease.burst, 3),
                    "seq": lease.seq,
                }
                for t, lease in self.leases.items()
            },
        }


# ---------------------------------------------------------------------------
# LocalHost: one in-process host behind its own HTTP listener
# ---------------------------------------------------------------------------

class LocalHost:
    """A ``ScoringService`` behind its own HTTP listener — one fleet
    host, in-process.  ``kill()`` tears the listener down abruptly (new
    connections refuse — what a crashed host looks like from the
    router); ``restart()`` rebinds the SAME port, so the router's
    reconnect probes find the host again without reconfiguration;
    ``stop()`` is the graceful full shutdown.  The service is started
    on first ``start()`` and stopped only by ``stop()`` — a killed
    host's service survives, exactly like a host whose network died
    but whose process did not."""

    def __init__(self, host_id: str, service, host: str = "127.0.0.1"):
        from photon_ml_tpu_torch.serving.service import ScoringService

        if not isinstance(service, ScoringService):
            raise TypeError(
                "LocalHost wraps a ScoringService; got "
                f"{type(service).__name__}"
            )
        self.host_id = str(host_id)
        self.service = service
        self._host = host
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._service_started = False
        self.port: Optional[int] = None
        self.lease_client: Optional[LeaseClient] = None

    @property
    def base_url(self) -> str:
        if self.port is None:
            raise RuntimeError("host is not started")
        return f"http://{self._host}:{self.port}"

    def start(self) -> "LocalHost":
        from photon_ml_tpu_torch.serving.service import start_http_server

        if self._server is not None:
            return self
        if not self._service_started:
            self.service.start()
            self._service_started = True
        self._server, self._thread = start_http_server(
            self.service, host=self._host, port=self.port or 0
        )
        self.port = self._server.server_address[1]
        return self

    def attach_lease_client(
        self, coordinator: QuotaCoordinator, **kwargs
    ) -> LeaseClient:
        """Wire this host into a coordinator's lease protocol (started
        by the caller, or driven manually via ``poll_once``)."""
        self.lease_client = LeaseClient(
            self.host_id, coordinator, self.service, **kwargs
        )
        return self.lease_client

    def kill(self) -> None:
        """Abrupt listener teardown — the scripted host crash."""
        server, thread = self._server, self._thread
        self._server, self._thread = None, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
        telemetry_mod.current().event(
            "serving.fleet_host_killed", host=self.host_id,
            port=self.port,
        )

    def restart(self) -> "LocalHost":
        """Rebind the listener on the same port (the 'host came back'
        half of the host_kill scenario)."""
        return self.start()

    def stop(self, timeout: float = 5.0) -> None:
        if self.lease_client is not None:
            self.lease_client.stop(timeout=timeout)
        self.kill()
        if self._service_started:
            self.service.stop()
            self._service_started = False

    def __enter__(self) -> "LocalHost":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
