"""Micro-batching request coalescer for the online scoring path (port of
``photon_ml_tpu/serving/batcher.py``).

The dispatch thread is the only thread that scores: it calls
``ScoringRuntime.score_rows``, which uploads, launches and reads back on
the runtime's device and that thread's current CUDA stream.

One dispatch thread drains a bounded queue: it blocks for the first
pending request, then coalesces more until ``max_batch_size`` rows are in
hand or ``max_wait_us`` has elapsed, pads to the runtime's nearest bucket,
dispatches ONE kernel call, and scatters results back to per-request
futures.  The shape follows the batching/caching discipline of
hierarchical ML runtimes (Snap ML, arXiv:1803.06333) and the
pipeline-overlap serving designs of arXiv:1702.07005: fixed-shape
pre-compiled kernels + request coalescing turn many tiny latency-bound
calls into few device-efficient ones.

Failure semantics ride :mod:`photon_ml_tpu_torch.utils.watchdog`'s
classification vocabulary so clients can reuse its retry discipline:

- **Admission control**: a full queue rejects at submit time with
  :class:`RejectedError` ("UNAVAILABLE: ..." — transient, retry later).
- **Deadlines**: a request that waited past its ``timeout_ms`` fails with
  :class:`DeadlineExceededError` ("DEADLINE_EXCEEDED: ..." — transient).
- Every failure is classified through the batcher's ``RetryPolicy``
  (``classify(exc)``) and counted as transient vs permanent.

**Tiered load shedding** — the binary queue-full reject is only the
backstop.  Admission is evaluated per submit against three tiers driven
by queue depth (watermark fractions of ``max_queue``) and the observed
p99 of the live ``serving_request_latency_seconds`` histogram:

- tier 0 **accept** — depth below ``shed_watermark``: everything admits.
- tier 1 **shed** — depth ≥ ``shed_watermark``, or observed p99 over
  ``p99_slo_ms``: ``priority="low"`` rows and over-deadline work (a
  deadline budget smaller than the current p99 — it would expire in the
  queue anyway) are rejected; normal/high traffic still admits.
- tier 2 **reject** — depth ≥ ``reject_watermark``: everything but
  supervisor health probes (``bypass_admission=True``) is rejected.

Shed rejections raise :class:`RejectedError` (UNAVAILABLE → HTTP 429,
transient) and count on ``serving_shed_total`` (+ per-reason counters);
every tier TRANSITION is journaled as a ``serving.shed_tier`` telemetry
event with the depth/p99 evidence that drove it (docs/serving.md).

Counting has ONE source of truth: with a telemetry hub enabled the
registry carries every count (``stats()`` derives the /stats view from
the same snapshot /metrics exposes); only with telemetry disabled does
the batcher maintain its own minimal mirror so /stats still answers.

**Tenancy** — when ``BatcherConfig.tenancy`` carries a
:class:`~photon_ml_tpu_torch.serving.tenancy.TenancyConfig`, every tenant gets
its own isolation boundary IN FRONT of the shared admission controller
(docs/serving.md):

- a **bulkhead queue partition**: the physical queue is sized to the sum
  of all partitions, and a tenant whose partition is full is rejected
  without touching a neighbor's slots;
- a **token-bucket quota** (sustained rps + burst) — over-quota traffic
  sheds with the tenant named in the error;
- its own **admission tiers** (partition-depth watermarks + a per-tenant
  observed p99 from ``serving_tenant_<t>_request_latency_seconds``
  against the tenant's own SLO);
- a **circuit breaker** (chaos/breaker.py) fed by per-tenant dispatch
  outcomes, so a tenant whose model path is failing degrades alone;
- a **tenant route**: dispatch groups rows by tenant and scores each
  group against that tenant's committed runtime (tenant-scoped hot
  swap, serving/swap.py), with the ``serving.tenant`` chaos site
  instrumenting exactly the tenant-routed scoring path.

With ``tenancy=None`` every code path below collapses to the
single-tenant behavior above, byte for byte.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.chaos import breaker as breaker_mod
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.serving import tenancy as tenancy_mod
from photon_ml_tpu_torch.utils.watchdog import RetryPolicy


class RejectedError(RuntimeError):
    """Admission control: the bounded request queue is full.

    The message carries watchdog's UNAVAILABLE marker — transient by
    classification, the client should back off and retry."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before (or while) it was scored."""


#: admission tiers, in escalation order (module docstring).
TIER_ACCEPT, TIER_SHED, TIER_REJECT = 0, 1, 2
TIER_NAMES = ("accept", "shed", "reject")


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Coalescing knobs (model/bucket knobs live on RuntimeConfig)."""

    #: rows one dispatch coalesces at most; capped by the runtime's top
    #: bucket at construction.
    max_batch_size: int = 64
    #: how long the dispatcher waits for more rows after the first one.
    #: 0 disables coalescing (every request scores alone — highest
    #: throughput cost, lowest latency under no load).  With
    #: ``adaptive_wait`` on this becomes the CEILING the adaptive
    #: policy never exceeds (the static knob stays the override).
    max_wait_us: int = 2000
    #: size the batch wait from the OBSERVED arrival rate instead of the
    #: static ``max_wait_us``: an EWMA over inter-arrival times
    #: estimates how long filling a batch would take; the dispatcher
    #: waits that long when it is under ``max_wait_us`` (traffic dense
    #: enough to fill a batch quickly) and drops to ``min_wait_us`` when
    #: it is not (sparse traffic must not idle a request at the ceiling
    #: for batch-mates that are not coming).  Bounded by
    #: ``slo_wait_fraction`` of the tightest p99 SLO in play.
    adaptive_wait: bool = False
    #: adaptive-mode floor: the wait under sparse traffic (microseconds).
    min_wait_us: int = 100
    #: EWMA smoothing factor over inter-arrival times, in (0, 1];
    #: higher = faster reaction to rate changes, lower = steadier waits.
    wait_ewma_alpha: float = 0.2
    #: adaptive waits never exceed this fraction of the tightest
    #: configured p99 SLO (global ``p99_slo_ms`` and every tenant's) —
    #: queueing time must leave the SLO room for scoring time.
    slo_wait_fraction: float = 0.25
    #: bounded queue depth; submissions beyond it are REJECTED, not
    #: buffered (explicit backpressure beats silent latency collapse).
    max_queue: int = 256
    #: default per-request deadline; None = no deadline.
    default_timeout_ms: Optional[float] = None
    #: queue-depth fraction at which tier 1 (shed low-priority /
    #: over-deadline work) engages.
    shed_watermark: float = 0.5
    #: queue-depth fraction at which tier 2 (reject everything but
    #: probes) engages; the queue-full RejectedError stays the backstop.
    reject_watermark: float = 0.9
    #: latency SLO: an observed request p99 above this escalates
    #: admission to at least tier 1.  None disables the latency signal
    #: (depth watermarks still apply); it also needs an enabled
    #: telemetry hub — the p99 is read from the live
    #: ``serving_request_latency_seconds`` histogram.
    p99_slo_ms: Optional[float] = None
    #: how often (seconds) the p99 estimate is refreshed; between
    #: refreshes a submit pays one queue-depth read and comparisons.
    admission_interval_s: float = 0.1
    #: multi-tenant isolation policy (serving/tenancy.py): per-tenant
    #: bulkhead partitions, quotas, tiers, SLOs, and breakers.  None =
    #: single-tenant behavior, bit-identical to before the field
    #: existed.  Frozen + picklable, so it rides the spawn args into
    #: process-mode workers unchanged (serving/worker.py).
    tenancy: Optional["tenancy_mod.TenancyConfig"] = None

    def __post_init__(self) -> None:
        # Pointed refusals at construction: a bad knob must name itself
        # here, not surface later as a hang (max_batch_size=0 would
        # dispatch nothing), a busy-spin (negative waits), or a queue
        # that admits nothing (inverted watermarks).
        if self.max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {self.max_batch_size}"
            )
        if self.max_wait_us < 0:
            raise ValueError(
                f"max_wait_us must be >= 0, got {self.max_wait_us}"
            )
        if self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1, got {self.max_queue}"
            )
        if not (0.0 < self.shed_watermark <= self.reject_watermark <= 1.0):
            raise ValueError(
                "need 0 < shed_watermark <= reject_watermark <= 1, got "
                f"{self.shed_watermark} / {self.reject_watermark}"
            )
        if self.default_timeout_ms is not None \
                and self.default_timeout_ms <= 0:
            raise ValueError(
                "default_timeout_ms must be positive (or None), got "
                f"{self.default_timeout_ms}"
            )
        if self.p99_slo_ms is not None and self.p99_slo_ms <= 0:
            raise ValueError(
                f"p99_slo_ms must be positive (or None), got "
                f"{self.p99_slo_ms}"
            )
        if self.admission_interval_s < 0:
            raise ValueError(
                "admission_interval_s must be >= 0, got "
                f"{self.admission_interval_s}"
            )
        if self.min_wait_us < 0:
            raise ValueError(
                f"min_wait_us must be >= 0, got {self.min_wait_us}"
            )
        if not (0.0 < self.wait_ewma_alpha <= 1.0):
            raise ValueError(
                f"wait_ewma_alpha must be in (0, 1], got "
                f"{self.wait_ewma_alpha}"
            )
        if not (0.0 < self.slo_wait_fraction <= 1.0):
            raise ValueError(
                f"slo_wait_fraction must be in (0, 1], got "
                f"{self.slo_wait_fraction}"
            )


@dataclasses.dataclass
class _Pending:
    row: object
    future: Future
    t_submit: float
    deadline: Optional[float]  # perf_counter seconds, None = no deadline
    #: submitter's trace context — the dispatch thread's serving.batch
    #: span parents to it, so a request's wait + batch execution nest
    #: under the span that submitted it (cross-thread tracing).
    ctx: Optional[tuple] = None
    #: the tenant partition this row occupies (``_TenantState``); None
    #: when tenancy is off.  Dispatch decrements the partition depth
    #: through this reference once the row leaves the queue.
    tenant_state: Optional[object] = None
    #: stage-decomposition timestamps (perf_counter seconds): when
    #: submit finished admission and enqueued the row, and when the
    #: dispatch loop pulled it back out.  Together with the group's
    #: scoring wall they split ``latency_ms`` into admission / queue /
    #: batch-wait / device stages (docs/telemetry.md).
    t_enqueue: float = 0.0
    t_pickup: float = 0.0


_STOP = object()


class _TenantState:
    """One tenant's live enforcement state: partition depth, token
    bucket, tier cache, and circuit breaker.  Named tenants each get
    one; every unknown/absent tenant shares the default spec's state.

    The bucket, depth, tier, and breaker mutate ONLY under the
    batcher's tenancy lock ("serving.tenancy") — the breaker is
    single-writer by design (chaos/breaker.py) and submit runs on many
    threads.  The p99 cache fields are racy-but-benign (worst case a
    duplicate refresh), matching the batcher's global p99 cache."""

    __slots__ = (
        "spec", "slug", "depth", "tier", "bucket", "breaker",
        "p99_ms", "p99_refresh_t",
    )

    def __init__(self, spec: "tenancy_mod.TenantSpec"):
        self.spec = spec
        self.slug = spec.slug
        self.depth = 0
        self.tier = TIER_ACCEPT
        self.bucket = tenancy_mod.TokenBucket(
            spec.quota_rps, spec.effective_burst
        )
        self.breaker = breaker_mod.CircuitBreaker(
            cooldown_seconds=spec.breaker_cooldown_s,
            failure_threshold=spec.breaker_failure_threshold,
        )
        self.p99_ms: Optional[float] = None
        self.p99_refresh_t = 0.0


class MicroBatcher:
    """Bounded-queue request coalescer in front of a ScoringRuntime."""

    def __init__(
        self,
        runtime,
        config: Optional[BatcherConfig] = None,
        policy: Optional[RetryPolicy] = None,
    ):
        cfg = config or BatcherConfig()
        if cfg.max_batch_size > runtime.buckets[-1]:
            cfg = dataclasses.replace(
                cfg, max_batch_size=runtime.buckets[-1]
            )
        # NOTE ``self.runtime`` is re-read at every dispatch: plain
        # attribute assignment is the hot-swap commit point
        # (serving/swap.py) — atomic under the GIL, no lock needed.
        self.runtime = runtime
        self.config = cfg
        self.policy = policy or RetryPolicy()
        self._tenancy = cfg.tenancy
        if self._tenancy is not None:
            # Bulkhead partitions: the physical queue holds the SUM of
            # every tenant partition (plus slack so bypass probes keep
            # flowing at saturation) — a tenant filling its own
            # partition can never consume a neighbor's slots, and
            # _capacity is the denominator every global-tier fraction
            # uses.
            self._tenant_states = {
                t.name: _TenantState(t) for t in self._tenancy.tenants
            }
            self._default_state: Optional[_TenantState] = _TenantState(
                self._tenancy.default
            )
            self._capacity = self._tenancy.partition_total
            self._tenant_lock = sanitizers.tracked(
                threading.Lock(), "serving.tenancy"
            )
        else:
            self._tenant_states = {}
            self._default_state = None
            self._capacity = cfg.max_queue
            self._tenant_lock = None
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=self._capacity + (32 if self._tenancy else 0)
        )
        # tenant -> runtime overriding self.runtime for that tenant's
        # rows (tenant-scoped hot swap, serving/swap.py).  Copy-on-write
        # dict: dispatch reads ONE reference per batch, commit replaces
        # the whole dict — GIL-atomic like the self.runtime commit.
        self._tenant_routes: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._lock = sanitizers.tracked(
            threading.Lock(), "serving.batcher"
        )
        # Admission-control state: current tier + the cached p99 read
        # (refreshed at most every admission_interval_s).
        self._tier = TIER_ACCEPT
        self._p99_ms: Optional[float] = None
        self._p99_refresh_t = 0.0
        # Adaptive-wait state: EWMA over submit inter-arrival times.
        # Written racy-benign from submit threads (GIL-atomic attribute
        # stores; worst case one lost sample) and read by the dispatch
        # loop.  The SLO cap is static: the tightest p99 SLO configured
        # anywhere (global + per-tenant), scaled by slo_wait_fraction.
        self._last_arrival_t: Optional[float] = None
        self._arrival_ewma_s: Optional[float] = None
        slos = [
            s for s in [cfg.p99_slo_ms]
            + ([t.p99_slo_ms for t in cfg.tenancy.tenants]
               + [cfg.tenancy.default.p99_slo_ms]
               if cfg.tenancy is not None else [])
            if s is not None
        ]
        self._adaptive_cap_s: Optional[float] = (
            min(slos) * 1e-3 * cfg.slo_wait_fraction if slos else None
        )
        # Internal counters exist ONLY for the telemetry-disabled path:
        # with a hub enabled, the registry is the single source of truth
        # and stats() derives every count from it (mirror drift is
        # structurally impossible because the mirror is never written).
        self._counts = {
            "submitted": 0,
            "completed": 0,
            "rejected": 0,
            "shed": 0,
            "shed_low_priority": 0,
            "shed_deadline": 0,
            "shed_quota": 0,
            "shed_breaker": 0,
            "tier_transitions": 0,
            "expired": 0,
            "failed": 0,
            "failed_transient": 0,
            "failed_permanent": 0,
            "batches": 0,
            "max_batch_rows": 0,
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="scoring-dispatch", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is None:
            return
        self._queue.put(_STOP)
        self._thread.join(timeout=timeout)
        self._thread = None
        # Fail anything that raced past admission after the _STOP went
        # in — nothing will ever dispatch it.  Transient vocabulary, not
        # RejectedError: a supervisor treats this as the BATCHER's fault
        # and resubmits the row to a peer replica.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            if item.tenant_state is not None:
                with self._tenant_lock:
                    item.tenant_state.depth -= 1
            if item.future.set_running_or_notify_cancel():
                item.future.set_exception(RuntimeError(
                    "UNAVAILABLE: batcher stopped before dispatch; "
                    "retry with backoff"
                ))

    # -- admission control (any thread) ------------------------------------
    def _observed_p99_ms(self, now: float) -> Optional[float]:
        """Cached read of the live request-latency p99, in ms; None when
        the SLO signal is off, the hub is disabled, or no observations
        exist yet."""
        if self.config.p99_slo_ms is None:
            return None
        if now >= self._p99_refresh_t:
            self._p99_refresh_t = now + self.config.admission_interval_s
            hist = telemetry_mod.current().histogram(
                "serving_request_latency_seconds"
            )
            quantile = getattr(hist, "quantile", None)
            p99_s = None if quantile is None else quantile(0.99)
            self._p99_ms = None if p99_s is None else p99_s * 1e3
        return self._p99_ms

    def admission_tier(self, now: Optional[float] = None) -> int:
        """The current admission tier (module docstring): max of the
        depth-watermark tier and the p99-SLO tier."""
        if now is None:
            now = time.perf_counter()
        frac = self._queue.qsize() / self._capacity
        if frac >= self.config.reject_watermark:
            tier = TIER_REJECT
        elif frac >= self.config.shed_watermark:
            tier = TIER_SHED
        else:
            tier = TIER_ACCEPT
        p99 = self._observed_p99_ms(now)
        if (
            tier < TIER_SHED
            and p99 is not None
            and p99 > self.config.p99_slo_ms
        ):
            tier = TIER_SHED
        return tier

    def _note_tier(self, tier: int) -> None:
        """Journal a tier transition: gauge + counter + telemetry event
        carrying the evidence (depth, p99) that drove it."""
        with self._lock:
            prev = self._tier
            if tier == prev:
                return
            self._tier = tier
        self._count("tier_transitions")
        tel = telemetry_mod.current()
        tel.counter("serving_tier_transitions_total").inc()
        tel.gauge("serving_shed_tier").set(tier)
        tel.event(
            "serving.shed_tier",
            tier=TIER_NAMES[tier],
            previous=TIER_NAMES[prev],
            queue_depth=self._queue.qsize(),
            max_queue=self._capacity,
            p99_ms=self._p99_ms,
        )

    def _shed(self, reason: str, detail: str) -> RejectedError:
        self._count("shed")
        tel = telemetry_mod.current()
        tel.counter("serving_shed_total").inc()
        if reason in ("reject_tier", "tenant_reject"):
            # The reject tier refuses ALL non-probe traffic — that is
            # the same verdict the pre-tier queue-full backstop gave, so
            # it keeps feeding the legacy rejection counters.
            self._count("rejected")
            tel.counter("serving_rejected_total").inc()
        if reason == "low_priority":
            self._count("shed_low_priority")
            tel.counter("serving_shed_low_priority_total").inc()
        elif reason == "deadline":
            self._count("shed_deadline")
            tel.counter("serving_shed_deadline_total").inc()
        elif reason == "tenant_quota":
            self._count("shed_quota")
            tel.counter("serving_shed_quota_total").inc()
        elif reason == "tenant_breaker":
            self._count("shed_breaker")
            tel.counter("serving_shed_breaker_total").inc()
        exc = RejectedError(
            f"UNAVAILABLE: load shed ({detail}); retry with backoff"
        )
        self._classify(exc)
        return exc

    # -- tenancy (any thread) ----------------------------------------------
    def _tenant_state_for(self, row) -> Optional[_TenantState]:
        """The partition governing this row: the named tenant's state
        when registered, else the shared default-spec state."""
        if self._tenancy is None:
            return None
        tenant = getattr(row, "tenant", None)
        state = self._tenant_states.get(tenant) if tenant is not None else None
        return state or self._default_state

    def _tenant_counter(self, state: _TenantState, name: str):
        # Dynamic per-tenant metric family; slugs keep every name
        # convention-shaped (<subsystem>_<name>_<unit>).
        return telemetry_mod.current().counter(
            f"serving_tenant_{state.slug}_{name}"
        )

    def _tenant_p99_ms(self, state: _TenantState, now: float):
        """Cached per-tenant p99 read, in ms — the tenant's own latency
        family against the tenant's own SLO.  Racy-but-benign cache
        (see _TenantState); call OUTSIDE the tenancy lock."""
        if state.spec.p99_slo_ms is None:
            return None
        if now >= state.p99_refresh_t:
            state.p99_refresh_t = now + self.config.admission_interval_s
            hist = telemetry_mod.current().histogram(
                f"serving_tenant_{state.slug}_request_latency_seconds"
            )
            quantile = getattr(hist, "quantile", None)
            p99_s = None if quantile is None else quantile(0.99)
            state.p99_ms = None if p99_s is None else p99_s * 1e3
        return state.p99_ms

    def _tenant_admit(
        self,
        state: _TenantState,
        row,
        timeout: Optional[float],
        now: float,
    ) -> None:
        """Per-tenant admission: breaker, quota bucket, then the
        tenant's own tier ladder.  Raises RejectedError on denial —
        always naming the tenant, so a shed client knows it was ITS
        budget (not a neighbor's) that ran out."""
        p99 = self._tenant_p99_ms(state, now)
        with self._tenant_lock:
            if not state.breaker.allow_request():
                verdict = "breaker"
            elif not state.bucket.try_acquire():
                verdict = "quota"
            else:
                frac = state.depth / state.spec.max_queue
                if frac >= state.spec.reject_watermark:
                    tier = TIER_REJECT
                elif frac >= state.spec.shed_watermark:
                    tier = TIER_SHED
                else:
                    tier = TIER_ACCEPT
                if (
                    tier < TIER_SHED
                    and p99 is not None
                    and p99 > state.spec.p99_slo_ms
                ):
                    tier = TIER_SHED
                state.tier = tier
                verdict = tier
        name = state.spec.name
        if verdict == "breaker":
            self._tenant_counter(state, "shed_total").inc()
            raise self._shed(
                "tenant_breaker",
                f"tenant {name!r} circuit open after repeated scoring "
                "failures; cooling down",
            )
        if verdict == "quota":
            self._tenant_counter(state, "shed_total").inc()
            raise self._shed(
                "tenant_quota",
                # The LIVE bucket's rate: a fleet lease re-rates a tenant
                # whose static spec has no quota (the reference formats
                # the spec's None there and raises TypeError instead).
                f"tenant {name!r} over quota "
                f"({state.bucket.rate_rps:g} rps sustained)",
            )
        if verdict >= TIER_REJECT:
            self._tenant_counter(state, "shed_total").inc()
            self._tenant_counter(state, "rejected_total").inc()
            raise self._shed(
                "tenant_reject",
                f"tenant {name!r} partition at reject tier "
                f"({state.depth}/{state.spec.max_queue} queued)",
            )
        if verdict == TIER_SHED:
            if getattr(row, "priority", "normal") == "low":
                self._tenant_counter(state, "shed_total").inc()
                raise self._shed(
                    "low_priority",
                    f"tenant {name!r} low-priority request at its shed "
                    "tier",
                )
            if (
                timeout is not None
                and state.p99_ms is not None
                and timeout < state.p99_ms
            ):
                self._tenant_counter(state, "shed_total").inc()
                raise self._shed(
                    "deadline",
                    f"tenant {name!r} deadline budget {timeout:.0f} ms "
                    f"is under its observed p99 {state.p99_ms:.0f} ms; "
                    "it would expire in the queue",
                )

    # -- submission (any thread) -------------------------------------------
    def submit(
        self,
        row,
        timeout_ms: Optional[float] = None,
        bypass_admission: bool = False,
    ) -> Future:
        """Enqueue one request; returns its future.

        Raises :class:`RejectedError` immediately when the tiered
        admission controller sheds the row or the queue is full —
        admission control is synchronous so the caller can shed load
        (HTTP 429) without waiting on a future.  ``bypass_admission``
        skips the tier check (NOT the queue-full backstop): supervisor
        health probes must keep flowing under overload, or shedding
        would read as replica death and trigger a restart storm.
        """
        tel = telemetry_mod.current()
        timeout = (
            timeout_ms
            if timeout_ms is not None
            else getattr(row, "timeout_ms", None)
        )
        if timeout is None:
            timeout = self.config.default_timeout_ms
        now = time.perf_counter()
        if self.config.adaptive_wait:
            last = self._last_arrival_t
            self._last_arrival_t = now
            if last is not None and now > last:
                dt = now - last
                ewma = self._arrival_ewma_s
                alpha = self.config.wait_ewma_alpha
                self._arrival_ewma_s = (
                    dt if ewma is None else alpha * dt + (1 - alpha) * ewma
                )
        state = self._tenant_state_for(row)
        if state is not None:
            self._tenant_counter(state, "requests_total").inc()
            if not bypass_admission:
                # Tenant-scoped admission FIRST: a tenant is judged
                # against its own breaker/quota/partition before the
                # shared controller sees the row, so its denial can
                # never be caused by — or blamed on — a neighbor.
                self._tenant_admit(state, row, timeout, now)
        tier = self.admission_tier(now)
        self._note_tier(tier)
        if tier > TIER_ACCEPT and not bypass_admission:
            if tier >= TIER_REJECT:
                raise self._shed(
                    "reject_tier",
                    f"admission tier {TIER_NAMES[tier]}, queue "
                    f"{self._queue.qsize()}/{self.config.max_queue}",
                )
            priority = getattr(row, "priority", "normal")
            if priority == "low":
                raise self._shed(
                    "low_priority",
                    "low-priority request at admission tier shed",
                )
            if (
                timeout is not None
                and self._p99_ms is not None
                and timeout < self._p99_ms
            ):
                raise self._shed(
                    "deadline",
                    f"deadline budget {timeout:.0f} ms is under the "
                    f"observed p99 {self._p99_ms:.0f} ms; it would "
                    "expire in the queue",
                )
        pending = _Pending(
            row=row,
            future=Future(),
            t_submit=now,
            deadline=None if timeout is None else now + timeout / 1e3,
            ctx=tel.current_context(),
            tenant_state=state,
        )
        if state is not None:
            # Reserve a slot in the tenant's bulkhead partition.  Probes
            # (bypass) still occupy depth so accounting stays exact, but
            # they are never turned away by a full partition.
            with self._tenant_lock:
                full = (
                    not bypass_admission
                    and state.depth >= state.spec.max_queue
                )
                if not full:
                    state.depth += 1
                    depth = state.depth
            if full:
                self._count("rejected")
                tel.counter("serving_rejected_total").inc()
                self._tenant_counter(state, "rejected_total").inc()
                exc = RejectedError(
                    f"UNAVAILABLE: tenant {state.spec.name!r} partition "
                    f"full ({state.spec.max_queue} pending); retry with "
                    "backoff"
                )
                self._classify(exc)
                raise exc
            tel.gauge(
                f"serving_tenant_{state.slug}_queue_depth"
            ).set(depth)
        pending.t_enqueue = time.perf_counter()
        try:
            self._queue.put_nowait(pending)
        except queue.Full:
            if state is not None:
                with self._tenant_lock:
                    state.depth -= 1
            self._count("rejected")
            tel.counter("serving_rejected_total").inc()
            if state is not None:
                self._tenant_counter(state, "rejected_total").inc()
            exc = RejectedError(
                f"UNAVAILABLE: serving queue full "
                f"({self._capacity} pending); retry with backoff"
            )
            self._classify(exc)
            raise exc
        self._count("submitted")
        tel.counter("serving_requests_total").inc()
        tel.gauge("serving_queue_depth").set(self._queue.qsize())
        tel.histogram("serving_stage_admission_seconds").observe(
            max(0.0, pending.t_enqueue - now)
        )
        return pending.future

    # -- dispatch loop (one thread) ----------------------------------------
    def _wait_budget_s(self) -> float:
        """How long this dispatch waits for batch-mates.

        Static mode: ``max_wait_us``, unconditionally.  Adaptive mode
        sizes the wait from the arrival-rate EWMA: the expected time to
        fill the rest of a batch (``ewma × (max_batch_size − 1)``) when
        that is under the ``max_wait_us`` ceiling, else ``min_wait_us``
        — dense traffic waits exactly as long as filling takes, sparse
        traffic stops paying the ceiling for batch-mates that are not
        coming.  Clamped into [min_wait_us, slo_fraction × tightest p99
        SLO] so queueing can never eat a tenant's latency budget.
        """
        cfg = self.config
        if not cfg.adaptive_wait:
            return cfg.max_wait_us / 1e6
        ceiling = cfg.max_wait_us / 1e6
        floor = cfg.min_wait_us / 1e6
        ewma = self._arrival_ewma_s
        if ewma is None:
            wait = ceiling
        else:
            fill = ewma * max(1, cfg.max_batch_size - 1)
            wait = fill if fill <= ceiling else floor
        if self._adaptive_cap_s is not None:
            wait = min(wait, self._adaptive_cap_s)
        wait = max(wait, floor)
        telemetry_mod.current().gauge(
            "serving_adaptive_wait_seconds"
        ).set(wait)
        return wait

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            item.t_pickup = time.perf_counter()
            batch = [item]
            stop_after = False
            wait_s = self._wait_budget_s()
            t_close = item.t_pickup + wait_s
            while len(batch) < self.config.max_batch_size:
                remaining = t_close - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop_after = True
                    break
                nxt.t_pickup = time.perf_counter()
                batch.append(nxt)
            self._dispatch(batch)
            if stop_after:
                return

    def _dispatch(self, batch: list) -> None:
        tel = telemetry_mod.current()
        # One read per dispatch: the whole batch scores against a single
        # runtime — and ONE copy-on-write tenant route table — even if a
        # hot-swap commits mid-dispatch (swap.py).
        runtime = self.runtime
        routes = self._tenant_routes
        tel.gauge("serving_queue_depth").set(self._queue.qsize())
        if self._tenancy is not None:
            # Every batch row has left the queue: release its bulkhead
            # partition slot now (expired rows included); publish the
            # new depths outside the lock.
            depths = {}
            with self._tenant_lock:
                for p in batch:
                    st = p.tenant_state
                    if st is not None:
                        st.depth -= 1
                        depths[st.slug] = st.depth
            for slug, depth in depths.items():
                tel.gauge(f"serving_tenant_{slug}_queue_depth").set(depth)
        now = time.perf_counter()
        live = []
        for p in batch:
            if p.deadline is not None and now > p.deadline:
                waited_ms = (now - p.t_submit) * 1e3
                self._count("expired")
                tel.counter("serving_deadline_expired_total").inc()
                self._fail(p, DeadlineExceededError(
                    f"DEADLINE_EXCEEDED: request waited {waited_ms:.1f} ms "
                    "past its deadline before dispatch"
                ))
            else:
                live.append(p)
        if not live:
            return
        # Group rows by tenant route: a tenant with a committed
        # tenant-scoped runtime scores against it; everyone else shares
        # the default runtime in one group.  With no routes this is
        # exactly the old single-group dispatch.
        if routes:
            keyed: dict = {}
            order = []
            for p in live:
                tenant = getattr(p.row, "tenant", None)
                rt = routes.get(tenant) if tenant is not None else None
                key = tenant if rt is not None else None
                if key not in keyed:
                    keyed[key] = (rt or runtime, [])
                    order.append(key)
                keyed[key][1].append(p)
            groups = [(k, keyed[k][0], keyed[k][1]) for k in order]
        else:
            groups = [(None, runtime, live)]
        # Cross-thread trace propagation: the batch executes on the
        # dispatch thread, but its span parents to the FIRST live
        # request's submitting span (batch-mates ride along as the rows
        # count) — a request's end-to-end latency reads as one nested
        # tree in Perfetto instead of orphaned root spans.
        ctx = next((p.ctx for p in live if p.ctx is not None), None)
        outcomes = []
        try:
            with tel.attach(ctx), tel.span(
                "serving.batch", rows=len(live)
            ):
                chaos_mod.maybe_fail("serving.batch", rows=len(live))
                for tenant, rt, rows in groups:
                    t_score = time.perf_counter()
                    try:
                        if tenant is not None:
                            # The tenant-routed scoring path is its own
                            # chaos seam: a fault here degrades exactly
                            # one tenant (docs/robustness.md).
                            chaos_mod.maybe_fail(
                                "serving.tenant",
                                tenant=tenant,
                                rows=len(rows),
                            )
                        margins, means = rt.score_rows(
                            [p.row for p in rows]
                        )
                    except Exception as exc:  # noqa: BLE001 — per-group
                        outcomes.append(
                            (tenant, rt, rows, None, None, exc,
                             t_score, 0.0)
                        )
                    else:
                        outcomes.append(
                            (tenant, rt, rows, margins, means, None,
                             t_score, time.perf_counter() - t_score)
                        )
        except Exception as exc:  # noqa: BLE001 — classified + surfaced
            # A batch-level fault (serving.batch chaos, trace plumbing)
            # fails every live row, exactly like the pre-tenancy single
            # group did.
            outcomes = [
                (tenant, rt, rows, None, None, exc, now, 0.0)
                for tenant, rt, rows in groups
            ]
        done = time.perf_counter()
        failed_states: dict = {}
        ok_states: dict = {}
        for tenant, rt, rows, margins, means, exc, t_score, device_s \
                in outcomes:
            if exc is not None:
                for p in rows:
                    self._fail(p, exc)
                    st = p.tenant_state
                    if st is not None:
                        failed_states[id(st)] = st
                        self._tenant_counter(
                            st, "failed_requests_total"
                        ).inc()
                continue
            bucket = rt.bucket_for(len(rows))
            if not tel.enabled:
                with self._lock:
                    self._counts["batches"] += 1
                    self._counts["completed"] += len(rows)
                    self._counts["max_batch_rows"] = max(
                        self._counts["max_batch_rows"], len(rows)
                    )
            tel.histogram("serving_batch_rows").observe(len(rows))
            tel.gauge("serving_batch_occupancy").set(len(rows) / bucket)
            for i, p in enumerate(rows):
                latency = done - p.t_submit
                tel.histogram(
                    "serving_request_latency_seconds"
                ).observe(latency)
                # Per-request latency decomposition: where inside
                # ``latency_ms`` the time went (docs/telemetry.md
                # "stage decomposition").  admission = submit-side
                # admission control, queue = waiting to be picked up,
                # batch = waiting for batch-mates + grouping, device =
                # this row's group's scoring wall.
                stages = {
                    "admission_s": max(0.0, p.t_enqueue - p.t_submit),
                    "queue_s": max(0.0, p.t_pickup - p.t_enqueue),
                    "batch_s": max(0.0, t_score - p.t_pickup),
                    "device_s": device_s,
                }
                tel.histogram(
                    "serving_stage_queue_seconds"
                ).observe(stages["queue_s"])
                tel.histogram(
                    "serving_stage_batch_seconds"
                ).observe(stages["batch_s"])
                tel.histogram(
                    "serving_stage_device_seconds"
                ).observe(stages["device_s"])
                st = p.tenant_state
                if st is not None:
                    ok_states.setdefault(id(st), st)
                    tel.histogram(
                        f"serving_tenant_{st.slug}"
                        "_request_latency_seconds"
                    ).observe(latency)
                if not p.future.set_running_or_notify_cancel():
                    continue  # client cancelled while queued
                result = {
                    "score": float(margins[i]),
                    "mean": float(means[i]),
                    "latency_ms": latency * 1e3,
                }
                if getattr(p.row, "want_stages", False):
                    # Opt-in response annotation; an extra result key
                    # deliberately leaves the IPC result fast path
                    # (protocol.py keys check) and rides pickle/JSON.
                    result["stages"] = stages
                p.future.set_result(result)
        if self._tenancy is not None and (failed_states or ok_states):
            # Feed each tenant's breaker with this dispatch's outcomes.
            # A state that both failed and succeeded in one dispatch
            # counts the failure (the breaker errs toward opening).
            with self._tenant_lock:
                for key, st in ok_states.items():
                    if key not in failed_states:
                        st.breaker.record_success()
                for st in failed_states.values():
                    st.breaker.record_failure()

    # -- failure plumbing --------------------------------------------------
    def _classify(self, exc: BaseException):
        """Watchdog-vocabulary classification of a request failure; feeds
        the transient/permanent split in stats and telemetry."""
        verdict = self.policy.classify(exc)
        self._count(
            "failed_transient" if verdict.transient else "failed_permanent"
        )
        telemetry_mod.current().counter(
            "serving_failures_transient_total" if verdict.transient
            else "serving_failures_permanent_total"
        ).inc()
        return verdict

    def _fail(self, p: _Pending, exc: BaseException) -> None:
        self._count("failed")
        telemetry_mod.current().counter(
            "serving_failed_requests_total"
        ).inc()
        self._classify(exc)
        if p.future.set_running_or_notify_cancel():
            p.future.set_exception(exc)

    def _count(self, key: str, n: int = 1) -> None:
        # Disabled-hub mirror only — see __init__; with a hub installed
        # the registry carries the count and this is a no-op.
        if telemetry_mod.current().enabled:
            return
        with self._lock:
            self._counts[key] += n

    # -- tenant routes (swap commit path, serving/swap.py) ------------------
    def set_tenant_route(self, tenant: str, runtime) -> None:
        """Commit a tenant-scoped runtime: rows carrying ``tenant``
        score against it instead of ``self.runtime``.  Copy-on-write so
        the dispatch thread's single route-table read stays lock-free —
        the same GIL-atomic commit discipline as ``self.runtime``."""
        routes = dict(self._tenant_routes)
        routes[tenant] = runtime
        self._tenant_routes = routes

    def clear_tenant_route(self, tenant: str) -> None:
        """Drop a tenant back onto the default route."""
        routes = dict(self._tenant_routes)
        routes.pop(tenant, None)
        self._tenant_routes = routes

    def tenant_route(self, tenant: str):
        """The tenant's committed runtime, or None (default route)."""
        return self._tenant_routes.get(tenant)

    # -- tenant quotas (fleet lease apply path, serving/fleet.py) -----------
    def set_tenant_quota(
        self,
        tenant: str,
        rate_rps: Optional[float],
        burst: Optional[float] = None,
    ) -> None:
        """Re-rate one tenant's token bucket in place (a fleet quota
        lease landing on this batcher).  The spec stays immutable — the
        lease overrides only the live bucket, so a rebuilt batcher
        starts back at the static spec until the next lease applies."""
        if self._tenancy is None:
            raise ValueError(
                "tenancy is not enabled on this batcher; no quota to set"
            )
        state = self._tenant_states.get(tenant)
        if state is None and tenant == self._tenancy.default.name:
            state = self._default_state
        if state is None:
            raise ValueError(
                f"unknown tenant {tenant!r}; declare it in TenancyConfig "
                "before leasing it quota"
            )
        with self._tenant_lock:
            state.bucket.reset_rate(rate_rps, burst)

    # -- observability -----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return self._queue.qsize()

    #: stats key → how to derive it from the telemetry snapshot.  The
    #: batch aggregates come from the serving_batch_rows histogram: one
    #: observation per dispatched batch, value = live rows, so count =
    #: batches, sum = completed rows, max = max_batch_rows.
    _HUB_COUNTERS = {
        "submitted": "serving_requests_total",
        "rejected": "serving_rejected_total",
        "shed": "serving_shed_total",
        "shed_low_priority": "serving_shed_low_priority_total",
        "shed_deadline": "serving_shed_deadline_total",
        "shed_quota": "serving_shed_quota_total",
        "shed_breaker": "serving_shed_breaker_total",
        "tier_transitions": "serving_tier_transitions_total",
        "expired": "serving_deadline_expired_total",
        "failed": "serving_failed_requests_total",
        "failed_transient": "serving_failures_transient_total",
        "failed_permanent": "serving_failures_permanent_total",
    }

    def stats(self) -> dict:
        tel = telemetry_mod.current()
        if tel.enabled:
            # Single source of truth: derive every count from the hub's
            # registry (the same numbers /metrics exposes).  Note the
            # registry is process-wide — two batchers under one hub sum.
            snap = tel.metrics.snapshot()
            counters = snap["counters"]
            hist = snap["histograms"].get("serving_batch_rows") or {}
            counts = {
                key: counters.get(name, 0)
                for key, name in self._HUB_COUNTERS.items()
            }
            counts["batches"] = hist.get("count", 0)
            counts["completed"] = int(hist.get("sum") or 0)
            counts["max_batch_rows"] = int(hist.get("max") or 0)
            counts["source"] = "telemetry"
        else:
            with self._lock:
                counts = dict(self._counts)
            counts["source"] = "internal"
        counts["queue_depth"] = self._queue.qsize()
        counts["max_queue"] = self._capacity
        counts["max_batch_size"] = self.config.max_batch_size
        counts["max_wait_us"] = self.config.max_wait_us
        counts["adaptive_wait"] = self.config.adaptive_wait
        if self.config.adaptive_wait:
            ewma = self._arrival_ewma_s
            counts["arrival_ewma_ms"] = (
                None if ewma is None else ewma * 1e3
            )
        with self._lock:
            counts["tier"] = TIER_NAMES[self._tier]
        counts["model_version"] = getattr(self.runtime, "model_version", 1)
        if self._tenancy is not None:
            routes = self._tenant_routes
            tenants = {}
            with self._tenant_lock:
                states = [self._default_state]
                states.extend(self._tenant_states.values())
                for st in states:
                    tenants[st.spec.name] = {
                        "slug": st.slug,
                        "depth": st.depth,
                        "max_queue": st.spec.max_queue,
                        "tier": TIER_NAMES[st.tier],
                        "quota": st.bucket.snapshot(),
                        "breaker": st.breaker.snapshot(),
                        "p99_slo_ms": st.spec.p99_slo_ms,
                    }
            for tenant, entry in tenants.items():
                rt = routes.get(tenant)
                entry["routed_version"] = (
                    None if rt is None
                    else getattr(rt, "model_version", None)
                )
            counts["tenants"] = tenants
        return counts
