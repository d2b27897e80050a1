"""ScoringService: the in-process API and the stdlib HTTP endpoint (port
of ``photon_ml_tpu/serving/service.py``).

``ScoringService`` is the one object callers touch.  It composes either
a single :class:`~photon_ml_tpu_torch.serving.runtime.ScoringRuntime` with a
:class:`~photon_ml_tpu_torch.serving.batcher.MicroBatcher`, or — for
high-availability serving — a :class:`~photon_ml_tpu_torch.serving.supervisor.
ReplicaSupervisor` running N replicas behind the same listener:

    with ScoringService(runtime) as svc:          # single runtime
        fut = svc.submit({"dense": {"global": [...]}, "ids": {...}})
        result = svc.score({...})            # blocking convenience
        many = svc.score_many([{...}, ...])  # coalesces naturally

    sup = ReplicaSupervisor(factory, n_replicas=3)
    with ScoringService(sup) as svc:              # HA: same API
        ...

Either way the service carries a :class:`~photon_ml_tpu_torch.serving.swap.
HotSwapper` — ``svc.reload(model_dir)`` rolls every live runtime onto a
new model version with verified rollback (see serving/swap.py).

``start_http_server(svc, port)`` exposes the same API over a stdlib
``ThreadingHTTPServer`` (one thread per connection; the handler threads
only parse and encode — dispatch threads (or worker processes) own all
scoring and every CUDA call of it, so concurrency is safe by
construction):

- ``POST /score`` — ``{"rows": [...]}`` or a single request object;
  responds ``{"results": [...]}`` with per-row ``{"score", "mean",
  "latency_ms"}`` or ``{"error", "kind"}``.  A fully-rejected call
  returns 429, a fully-expired one 504, bad input 400.
- ``POST /reload`` — ``{"model_dir": ...}`` swaps to a new model
  (``{"rollback": true}`` is the one-step manual rollback).  200 on
  swap, 409 while another swap runs, 422 when the swap rolled back,
  503 when deferred (degraded target).
- ``GET /healthz`` — the RICH health view: status ``stopped`` /
  ``not_ready`` / ``degraded`` / ``ok``, model version, replica states.
- ``GET /livez`` — pure liveness: 200 whenever the process answers.
- ``GET /readyz`` — pure readiness: 200 only when traffic should route
  here; 503 with ``"not_ready"`` during startup warmup, mid-swap, and
  when no healthy replica exists.  Load balancers watch THIS, not
  /healthz (a warming server is alive but must not receive traffic).
- ``GET /stats`` — runtime/supervisor + batcher + swap counters.  With
  a telemetry hub enabled the batcher block is DERIVED from the hub's
  registry (the ``"source": "telemetry"`` field says so) — one source
  of truth with the /metrics exposition.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

from photon_ml_tpu_torch.serving.batcher import (
    BatcherConfig,
    DeadlineExceededError,
    MicroBatcher,
    RejectedError,
)
from photon_ml_tpu_torch.serving.runtime import Row, ScoringRuntime
from photon_ml_tpu_torch.serving.swap import HotSwapper, SwapInProgressError
from photon_ml_tpu_torch.serving.tenancy import TenantRouter
from photon_ml_tpu_torch.serving import wire as wire_mod
from photon_ml_tpu_torch import telemetry as telemetry_mod


class ScoringService:
    """Runtime(+batcher) or supervisor, started/stopped as one unit."""

    def __init__(
        self,
        runtime,
        batcher_config: Optional[BatcherConfig] = None,
        policy=None,
    ):
        from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor

        if isinstance(runtime, ReplicaSupervisor):
            self.supervisor: Optional[ReplicaSupervisor] = runtime
            if batcher_config is not None:
                self.supervisor.batcher_config = batcher_config
            self.runtime = None
            self.batcher = None
        else:
            self.supervisor = None
            self.runtime = runtime
            self.batcher = MicroBatcher(
                runtime, batcher_config, policy=policy
            )
        self.swapper = HotSwapper(
            self._swap_targets,
            on_commit=self._on_swap_commit,
            on_kill=self._on_swap_kill,
            on_tenant_commit=self._on_tenant_swap_commit,
        )
        #: tenant → model-version resolution view (serving/tenancy.py);
        #: the swapper owns the route state, this is the read API.
        self.router = TenantRouter(self.swapper)
        #: tenant → offered-request count, PRE-admission (counted even
        #: when the quota then sheds the request): the demand signal the
        #: fleet lease client feeds the QuotaCoordinator
        #: (serving/fleet.py).  Absent tenant ids count under None.
        self._demand: dict = {}
        self._demand_lock = threading.Lock()
        self._started = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ScoringService":
        if self.supervisor is not None:
            self.supervisor.start()
        else:
            self.batcher.start()
        self._started = True
        self.swapper.adopt_version(self.current_runtime)
        return self

    def stop(self) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
        else:
            self.batcher.stop()
        self._started = False

    def __enter__(self) -> "ScoringService":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- hot swap ----------------------------------------------------------
    @property
    def current_runtime(self):
        """The runtime serving NOW (post-swap it differs from the one the
        service was constructed with)."""
        if self.supervisor is not None:
            return self.supervisor._any_runtime()
        return self.batcher.runtime

    def _swap_targets(self) -> list:
        if self.supervisor is not None:
            return self.supervisor.swap_targets()
        return [self.batcher]

    def _on_swap_commit(
        self, model, index_maps, config, version, path
    ) -> None:
        if self.supervisor is not None:
            self.supervisor.on_swap_commit(
                model, index_maps, config, version, path
            )
        else:
            self.runtime = self.batcher.runtime

    def _on_tenant_swap_commit(
        self, tenant, model, index_maps, config, version, path
    ) -> None:
        # Tenant-route durability across replica restarts: the
        # supervisor retains enough to rebuild the route on a fresh
        # replica (thread mode; the pool's tenant-generation registry
        # replays routes in process mode).  Standalone batcher mode
        # needs nothing — the route already lives on the one batcher.
        if self.supervisor is not None:
            self.supervisor.on_tenant_swap_commit(
                tenant, model, index_maps, config, version, path
            )

    def _on_swap_kill(self, batcher, reason: str) -> None:
        # Through the supervisor where there is one: kill_replica marks
        # the replica down in the same call, so the rollback returns
        # with supervisor state already reflecting the convergence kill.
        if self.supervisor is not None:
            self.supervisor.kill_batcher(batcher, reason)
            return
        kill = getattr(batcher, "kill", None)
        if callable(kill):
            kill(reason)

    def reload(
        self,
        model_dir: Optional[str] = None,
        rollback: bool = False,
        mode: str = "full",
        tenant: Optional[str] = None,
    ):
        """Hot-swap to the model at ``model_dir`` (or roll back one
        step).  ``mode="delta"`` treats ``model_dir`` as a delta
        artifact (``freshness/delta.py``) and patches only the changed
        rows of the serving model — ``POST /reload?mode=delta``.
        ``tenant`` scopes the swap (or rollback) to ONE tenant's route
        (``POST /reload?tenant=acme``) — every other tenant and the
        default route are untouched; tenant reloads support
        ``mode="full"`` only.  Returns a
        :class:`~photon_ml_tpu_torch.serving.swap.SwapResult`; raises
        SwapInProgressError on concurrent reloads and ValueError on a
        missing path or unknown mode."""
        if rollback:
            return self.swapper.rollback(tenant=tenant)
        if not model_dir:
            raise ValueError(
                "reload needs 'model_dir' (or 'rollback': true)"
            )
        if mode == "delta":
            if tenant is not None:
                raise ValueError(
                    "tenant-scoped reload supports mode='full' only "
                    "(deltas patch the default route's serving model)"
                )
            return self.swapper.swap_delta(model_dir)
        if mode != "full":
            raise ValueError(
                f"unknown reload mode {mode!r}; expected 'full' or "
                "'delta'"
            )
        return self.swapper.swap(model_dir, tenant=tenant)

    # -- scoring -----------------------------------------------------------
    def submit(
        self,
        request,
        timeout_ms: Optional[float] = None,
        annotate_stages: bool = False,
    ) -> Future:
        """Parse + enqueue one request (dict or pre-parsed Row); returns
        the future.  Raises RejectedError on a full queue or load shed
        and ValueError on malformed input.  ``annotate_stages`` asks the
        batcher to attach the per-request latency decomposition to the
        result (the opt-in ``stages`` key — docs/telemetry.md)."""
        if isinstance(request, Row):
            row = request
        elif self.supervisor is not None:
            row = self.supervisor.parse_request(request)
        else:
            row = self.current_runtime.parse_request(request)
        if annotate_stages:
            row.want_stages = True
        # Offered demand, counted BEFORE admission: a shed request is
        # still demand — exactly the signal lease rebalancing needs
        # (a host shedding for lack of lease must report the pressure).
        tenant = getattr(row, "tenant", None)
        with self._demand_lock:
            self._demand[tenant] = self._demand.get(tenant, 0) + 1
        if self.supervisor is not None:
            return self.supervisor.submit(row, timeout_ms=timeout_ms)
        return self.batcher.submit(row, timeout_ms=timeout_ms)

    def score(self, request, timeout: Optional[float] = 30.0) -> dict:
        """Blocking single-request convenience."""
        return self.submit(request).result(timeout=timeout)

    def request_parser(self):
        """The :class:`~photon_ml_tpu_torch.serving.runtime.RequestParser`
        validating this service's requests — what the binary wire path
        decodes against (shard dims; the JSON path reads the same
        object, so both paths refuse identically)."""
        if self.supervisor is not None and self.supervisor.pool is not None:
            return self.supervisor.pool.parser
        runtime = self.current_runtime
        parser = getattr(runtime, "_parser", None)
        if parser is None:
            raise RejectedError(
                "UNAVAILABLE: no runtime available to parse against; "
                "retry with backoff"
            )
        return parser

    def score_many(
        self,
        requests: Sequence,
        timeout: Optional[float] = 30.0,
        annotate_stages: bool = False,
    ) -> list:
        """Submit all, then gather — concurrent submissions coalesce into
        shared batches.  Per-row failures come back as result dicts
        (``{"error", "kind"}``), not exceptions, so one bad row doesn't
        void its batch-mates."""
        slots: list = [None] * len(requests)
        futures: list[tuple[int, Future]] = []
        for i, req in enumerate(requests):
            try:
                futures.append((
                    i,
                    self.submit(req, annotate_stages=annotate_stages),
                ))
            except (RejectedError, ValueError, DeadlineExceededError) as exc:
                slots[i] = _error_result(exc)
        for i, fut in futures:
            try:
                slots[i] = fut.result(timeout=timeout)
            except Exception as exc:  # noqa: BLE001 — per-row reporting
                slots[i] = _error_result(exc)
        return slots

    # -- fleet quota seams (serving/fleet.py) -------------------------------
    def demand_snapshot(self) -> dict:
        """Cumulative per-tenant offered-request counts (pre-admission).
        The fleet LeaseClient differences successive snapshots into
        demand rates for the QuotaCoordinator."""
        with self._demand_lock:
            return {t: n for t, n in self._demand.items() if t is not None}

    def set_tenant_quota(
        self, tenant: str, rate_rps, burst=None
    ) -> None:
        """Apply a quota lease to this host's admission buckets —
        through the supervisor (which splits the host rate across
        replicas and replays it on restart) or straight onto the one
        batcher."""
        if self.supervisor is not None:
            self.supervisor.set_tenant_quota(tenant, rate_rps, burst)
        else:
            self.batcher.set_tenant_quota(tenant, rate_rps, burst)

    # -- observability -----------------------------------------------------
    def readiness(self) -> tuple[bool, str]:
        """The /readyz verdict: should a load balancer route traffic
        here RIGHT NOW?  False during startup warmup, mid-swap, and
        with zero healthy replicas — distinct from liveness (/livez)
        and from degraded (still serving, via the host path)."""
        if not self._started:
            return False, "not started"
        if self.swapper.in_progress:
            return False, "model swap in progress"
        if self.supervisor is not None:
            if not self.supervisor.ready:
                return False, "no healthy ready replica"
            return True, "ok"
        runtime = self.current_runtime
        if not getattr(runtime, "ready", True):
            return False, "runtime warming up"
        return True, "ok"

    def healthz(self) -> dict:
        # "degraded" ≠ down: requests still succeed through the host cold
        # path (runtime docstring); "not_ready" ≠ dead: the process is
        # alive but should not receive NEW traffic (warmup / mid-swap).
        # Statuses stay distinguishable so a load balancer can shed-or-
        # keep by policy, not by guessing.
        runtime = self.current_runtime
        degraded = (
            self.supervisor.degraded if self.supervisor is not None
            else getattr(runtime, "degraded", False)
        )
        ready, ready_reason = self.readiness()
        out = {
            "status": (
                "stopped" if not self._started
                else "not_ready" if not ready
                else "degraded" if degraded
                else "ok"
            ),
            "ready": ready,
            "ready_reason": ready_reason,
            "degraded": degraded,
            "model_version": self.swapper.version,
            "model_path": self.swapper.model_path,
            "swap_in_progress": self.swapper.in_progress,
            "tenant_versions": {
                t: v for t, (v, _) in
                self.swapper.tenant_versions().items()
            },
        }
        if self.supervisor is not None:
            sup = self.supervisor.stats()
            out["replicas"] = sup["replicas"]
            out["healthy_replicas"] = sup["healthy"]
        if runtime is not None and isinstance(runtime, ScoringRuntime):
            out.update({
                "breaker": runtime.breaker.state,
                "task": runtime.task,
                "coordinates": runtime.stats()["coordinates"],
                "buckets": list(runtime.buckets),
            })
        return out

    def stats(self) -> dict:
        out = {
            "swap": self.swapper.stats(),
            "tenancy": self.router.stats(),
        }
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.stats()
            targets = self.supervisor.swap_targets()
            if targets:
                # NOTE with a telemetry hub the batcher block is derived
                # from the process-wide registry — it aggregates across
                # replicas by construction.
                out["batcher"] = targets[0].stats()
            runtime = self.current_runtime
            if isinstance(runtime, ScoringRuntime):
                out["runtime"] = runtime.stats()
        else:
            out["runtime"] = self.current_runtime.stats()
            out["batcher"] = self.batcher.stats()
        return out


def _error_kind(exc: BaseException) -> str:
    if isinstance(exc, RejectedError):
        return "rejected"
    if isinstance(exc, DeadlineExceededError):
        return "deadline"
    if isinstance(exc, ValueError):
        return "bad_request"
    return "internal"


def _error_result(exc: BaseException) -> dict:
    return {"error": str(exc), "kind": _error_kind(exc)}


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

_KIND_STATUS = {
    "rejected": 429,
    "deadline": 504,
    "bad_request": 400,
    "internal": 500,
}

#: swap outcome → HTTP status for POST /reload (module docstring).
_SWAP_STATUS = {"swapped": 200, "rolled_back": 422, "deferred": 503}


def _status_for(results: list) -> int:
    """HTTP status for a batch of per-row results: only an ALL-failed
    response surfaces a row error as the status (429 tells a client to
    back off, 504 to re-budget); partial failure reports per-row."""
    errors = [r["kind"] for r in results if r and "error" in r]
    if errors and len(errors) == len(results):
        kinds = set(errors)
        return _KIND_STATUS[errors[0]] if len(kinds) == 1 else 500
    return 200


class _Handler(BaseHTTPRequestHandler):
    service: ScoringService  # set on the server class per instance
    protocol_version = "HTTP/1.1"

    # -- plumbing ----------------------------------------------------------
    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        pass  # request logging rides telemetry, not stderr

    def _send_json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- routes ------------------------------------------------------------
    def do_GET(self) -> None:  # noqa: N802 — stdlib casing
        service = self.server.service
        if self.path == "/healthz":
            self._send_json(200, service.healthz())
        elif self.path == "/livez":
            self._send_json(200, {"status": "alive"})
        elif self.path == "/readyz":
            ready, reason = service.readiness()
            self._send_json(200 if ready else 503, {
                "status": "ready" if ready else "not_ready",
                "reason": reason,
            })
        elif self.path == "/stats":
            self._send_json(200, service.stats())
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def _read_raw(self) -> bytes:
        length = int(self.headers.get("Content-Length", "0"))
        return self.rfile.read(length)

    def _read_body(self) -> dict:
        return json.loads(self._read_raw() or b"{}")

    def _content_type(self) -> str:
        ctype = self.headers.get("Content-Type") or ""
        return ctype.split(";", 1)[0].strip().lower()

    def _trace_context(self):
        """The caller's propagated trace context, from the
        ``X-Photon-Trace`` header (None when absent/malformed — an
        untraceable header must never fail the request)."""
        return telemetry_mod.TraceContext.parse(
            self.headers.get(telemetry_mod.TRACE_HEADER) or ""
        )

    def _want_stages(self) -> bool:
        """Per-request opt-in for the latency-decomposition annotation
        (``X-Photon-Stages: 1``)."""
        value = (self.headers.get("X-Photon-Stages") or "").strip().lower()
        return value in ("1", "true", "yes")

    def do_POST(self) -> None:  # noqa: N802 — stdlib casing
        # Split the query string off before routing: the reload mode
        # rides it (POST /reload?mode=delta).
        path, _, query = self.path.partition("?")
        if path == "/reload":
            self._do_reload(query)
            return
        if path != "/score":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        # Content-type negotiation (docs/serving.md "Data plane"): a
        # binary frame body takes the wire fast path; everything else is
        # the JSON compatibility path.  Both produce bitwise-identical
        # scores.
        if self._content_type() == wire_mod.CONTENT_TYPE:
            self._do_score_binary()
            return
        try:
            obj = self._read_body()
            rows = obj["rows"] if isinstance(obj, dict) and "rows" in obj \
                else [obj]
            if not isinstance(rows, list) or not rows:
                raise ValueError("'rows' must be a non-empty list")
        except (ValueError, KeyError, TypeError) as exc:
            self._send_json(400, {"error": f"bad request: {exc}"})
            return
        # Distributed tracing, JSON path: adopt the caller's context so
        # this hop's span — and the batcher's serving.batch span behind
        # it — stitch into the caller's trace (docs/telemetry.md).
        tel = telemetry_mod.current()
        with tel.adopt(self._trace_context()), tel.span(
            "serving.http_score", rows=len(rows)
        ):
            results = self.server.service.score_many(
                rows, annotate_stages=self._want_stages()
            )
        t_encode = time.perf_counter()
        self._send_json(_status_for(results), {"results": results})
        tel.histogram("serving_stage_encode_seconds").observe(
            time.perf_counter() - t_encode
        )

    def _do_score_binary(self) -> None:
        """POST /score with a wire-frame body: decode zero-copy into
        Rows, score, answer with a wire response frame — unless the
        client's Accept header explicitly asks for JSON back (the
        fallback matrix in docs/serving.md)."""
        tel = telemetry_mod.current()
        body = self._read_raw()
        tel.counter("serving_wire_rx_bytes").inc(len(body))
        try:
            rows, trace = wire_mod.decode_request_ex(
                body, self.server.service.request_parser()
            )
        except wire_mod.WireFormatError as exc:
            tel.counter("serving_wire_errors_total").inc()
            self._send_json(400, {"error": f"bad frame: {exc}"})
            return
        except RejectedError as exc:
            self._send_json(429, {"error": str(exc)})
            return
        tel.counter("serving_wire_requests_total").inc()
        tel.counter("serving_wire_rows_total").inc(len(rows))
        # Distributed tracing, binary path: the wire v2 trace:ctx column
        # wins (it rode the frame itself); the HTTP header is the
        # fallback for v1 frames POSTed by a traced client.
        ctx = None
        if trace is not None:
            ctx = telemetry_mod.TraceContext.parse(trace)
        if ctx is None:
            ctx = self._trace_context()
        with tel.adopt(ctx), tel.span(
            "serving.http_score", rows=len(rows)
        ):
            results = self.server.service.score_many(
                rows, annotate_stages=self._want_stages()
            )
        status = _status_for(results)
        accept = (self.headers.get("Accept") or "").lower()
        if "application/json" in accept:
            t_encode = time.perf_counter()
            self._send_json(status, {"results": results})
            tel.histogram("serving_stage_encode_seconds").observe(
                time.perf_counter() - t_encode
            )
            return
        t_encode = time.perf_counter()
        frame = wire_mod.encode_response(results)
        tel.histogram("serving_stage_encode_seconds").observe(
            time.perf_counter() - t_encode
        )
        tel.counter("serving_wire_tx_bytes").inc(len(frame))
        self.send_response(status)
        self.send_header("Content-Type", wire_mod.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(frame)))
        self.end_headers()
        self.wfile.write(frame)

    def _do_reload(self, query: str = "") -> None:
        try:
            obj = self._read_body()
            if not isinstance(obj, dict):
                raise ValueError("reload body must be a JSON object")
            # Mode and tenant come from the query string
            # (?mode=delta&tenant=acme) or the body; the body wins when
            # both are present.
            mode = "full"
            tenant = None
            for part in query.split("&"):
                key, _, value = part.partition("=")
                if key == "mode" and value:
                    mode = value
                elif key == "tenant" and value:
                    tenant = value
            mode = obj.get("mode", mode)
            tenant = obj.get("tenant", tenant)
            result = self.server.service.reload(
                model_dir=obj.get("model_dir"),
                rollback=bool(obj.get("rollback")),
                mode=mode,
                tenant=tenant,
            )
        except SwapInProgressError as exc:
            self._send_json(409, {"error": str(exc)})
            return
        except (ValueError, KeyError, TypeError) as exc:
            self._send_json(400, {"error": f"bad request: {exc}"})
            return
        self._send_json(
            _SWAP_STATUS.get(result.status, 500), result.to_dict()
        )


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    #: listen backlog.  A fleet router opens one connection per request
    #: from each of its workers (16 by default) at once, besides its
    #: probes; the stdlib's backlog of 5 lets some network stacks reset
    #: the excess, and a reset marks a healthy host down.
    request_queue_size = 128
    service: ScoringService


def start_http_server(
    service: ScoringService, host: str = "127.0.0.1", port: int = 0
) -> tuple[_Server, threading.Thread]:
    """Serve ``service`` over HTTP on a daemon thread; returns
    ``(server, thread)``.  ``port=0`` binds an ephemeral port — read it
    back from ``server.server_address[1]``.  Shut down with
    ``server.shutdown(); server.server_close()``."""
    server = _Server((host, port), _Handler)
    server.service = service
    thread = threading.Thread(
        target=server.serve_forever, name="scoring-http", daemon=True
    )
    thread.start()
    return server, thread
