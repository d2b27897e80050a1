"""Telemetry core: hierarchical spans, a metrics registry, and the hub
(port of ``photon_ml_tpu/telemetry/core.py``, framework-neutral, copied).

The reference leaned on Spark's UI and executor logs for run visibility;
a single-process driver has neither, so this package is the common
event stream the scattered fragments (``PhotonLogger`` lines, ``Timer``
measurements, ``TransferStats``, watchdog decisions) feed into:

- **Spans** — hierarchical wall-clock intervals (``run → coordinate →
  solver → chunk``) with monotonic timestamps and structured attributes.
  Nesting is tracked per thread; spans opened on other threads (the
  prefetch producer) become roots of their own stacks.
- **Metrics registry** — named counters, gauges, and histograms
  (``h2d_gbps``, ``consumer_stall_seconds``, ``solver_iterations``, ...)
  snapshotted to JSON at end of run.
- **Sinks** (telemetry/sinks.py) — JSONL event log (source of truth),
  Chrome trace-event ``trace.json`` (Perfetto / ``chrome://tracing``),
  and a human-readable end-of-run summary through ``PhotonLogger``.

Cost contract: telemetry is default-on but must be no-op cheap — a
disabled or sink-less hub costs ONE branch per event/span, and nothing
in this package ever touches a device array's values or forces a sync
the caller didn't already do (device arrays in attributes are recorded
as shape/dtype placeholders, never materialized).
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import math
import os
import threading
import time
import uuid
from typing import Optional


# ---------------------------------------------------------------------------
# JSON sanitization (device-sync-safe)
# ---------------------------------------------------------------------------

def json_safe(value):
    """Best-effort conversion of an attribute value to JSON-able data.

    Never materializes a device array: anything exposing ``shape``/
    ``dtype`` that is not a host numpy array becomes a placeholder
    string (reading ``.shape`` does not sync; ``str(arr)`` would).
    """
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        # NaN/inf are not valid JSON; keep the record parseable.
        return value if math.isfinite(value) else repr(value)
    import numpy as np

    if isinstance(value, np.generic):
        return json_safe(value.item())
    if isinstance(value, np.ndarray):
        if value.size <= 32:
            return [json_safe(v) for v in value.tolist()]
        return f"<ndarray shape={value.shape} dtype={value.dtype}>"
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        # A device tensor (possibly still being computed): shape/dtype
        # are metadata reads, str() would block on the computation.
        return f"<array shape={tuple(value.shape)} dtype={value.dtype}>"
    if isinstance(value, dict):
        return {str(k): json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_safe(v) for v in value]
    if isinstance(value, BaseException):
        return f"{type(value).__name__}: {value}"
    try:
        json.dumps(value)
        return value
    except TypeError:
        return str(value)


# ---------------------------------------------------------------------------
# Distributed trace context
# ---------------------------------------------------------------------------

#: HTTP header carrying the serialized trace context on the JSON path.
TRACE_HEADER = "X-Photon-Trace"


class TraceContext:
    """The compact context that rides every transport hop.

    Three fields, two encodings: the string form
    (``"<trace16hex>-<span16hex>-<0|1>"``) travels as an HTTP header and
    as a string column in wire frames; :meth:`to_words` packs the same
    data into three fixed integers for binary slot headers (shm ring).
    ``span_id`` is the GLOBAL id of the remote parent span (0 = the
    trace root: no parent yet); ``sampled`` is the head-sampling verdict
    made once at the edge and honored by every hop downstream, so one
    request is either traced everywhere or nowhere (tail retention
    excepted — see :meth:`Telemetry.configure_tracing`).
    """

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: int = 0,
                 sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = int(span_id)
        self.sampled = bool(sampled)

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, "
                f"{self.span_id:#x}, sampled={self.sampled})")

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.sampled == other.sampled)

    def header_value(self) -> str:
        """String form for headers / wire string columns."""
        return f"{self.trace_id}-{self.span_id:016x}-{int(self.sampled)}"

    @classmethod
    def parse(cls, text) -> Optional["TraceContext"]:
        """Parse :meth:`header_value` output; None on anything malformed
        (propagation is best-effort — a bad header degrades to an
        untraced request, never a failed one)."""
        if not text or not isinstance(text, str):
            return None
        parts = text.strip().split("-")
        if len(parts) != 3 or len(parts[0]) != 16:
            return None
        try:
            trace_word = int(parts[0], 16)
            span_id = int(parts[1], 16)
            sampled = bool(int(parts[2]))
        except ValueError:
            return None
        if trace_word == 0:
            return None
        return cls(parts[0], span_id, sampled)

    def to_words(self) -> tuple:
        """``(trace_word, span_word, flags)`` — three unsigned ints for
        fixed binary headers.  ``trace_word`` is never 0 for a live
        context, so 0 doubles as "no context" on the wire."""
        return (int(self.trace_id, 16), self.span_id,
                1 if self.sampled else 0)

    @classmethod
    def from_words(cls, trace_word: int, span_word: int,
                   flags: int) -> Optional["TraceContext"]:
        if not trace_word:
            return None
        return cls(f"{trace_word:016x}", span_word, bool(flags & 1))


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonically increasing count (events, retries, bytes moved)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-written value (rates, depths, sizes)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = None

    def set(self, v) -> None:
        with self._lock:
            self.value = v


#: Log-spaced histogram bucket upper bounds: ~10 per decade over
#: 1e-9 .. 1e10 — wide enough for nanosecond latencies through terabyte
#: counts without per-histogram configuration.  Bucket resolution bounds
#: the quantile error: a bound is ≤ 1.26x its predecessor, and
#: :meth:`Histogram.quantile` interpolates inside the bucket, so
#: quantiles land within a few percent of the exact order statistic.
_BUCKET_MANTISSAS = (1.0, 1.25, 1.6, 2.0, 2.5, 3.15, 4.0, 5.0, 6.3, 8.0)
BUCKET_BOUNDS = tuple(
    m * 10.0 ** e for e in range(-9, 11) for m in _BUCKET_MANTISSAS
)


class Histogram:
    """Streaming summary of observed values.

    Tracks count/sum/min/max/last exactly plus a fixed log-spaced bucket
    grid (:data:`BUCKET_BOUNDS`) that supports :meth:`quantile` without
    retaining observations — the ad-hoc ``np.percentile`` over saved
    sample lists this replaces kept O(n) host memory per metric.
    Values ≤ 0 land in the underflow bucket and quantiles clamp to the
    exact observed min/max.
    """

    __slots__ = ("_lock", "count", "sum", "min", "max", "last", "_buckets")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.last = None
        self._buckets = [0] * (len(BUCKET_BOUNDS) + 1)

    def observe(self, v) -> None:
        v = float(v)
        idx = bisect.bisect_left(BUCKET_BOUNDS, v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.last = v
            self._buckets[idx] += 1

    def _quantile_locked(self, q: float) -> Optional[float]:
        if self.count == 0:
            return None
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        target = q * self.count
        cum = 0
        for i, c in enumerate(self._buckets):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= target:
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else self.min
                hi = (
                    BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else self.max
                )
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                return lo + (target - prev) / c * (hi - lo)
        return self.max

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile (q in [0, 1]) from the bucket grid,
        linearly interpolated within the covering bucket; None when the
        histogram is empty.  Exact at the min/max endpoints."""
        with self._lock:
            return self._quantile_locked(q)

    def summary(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "mean": self.sum / self.count if self.count else None,
                "last": self.last,
                "p50": self._quantile_locked(0.5),
                "p90": self._quantile_locked(0.9),
                "p99": self._quantile_locked(0.99),
            }

    def transport(self) -> dict:
        """Raw cross-process form: exact state INCLUDING the bucket
        vector.  :meth:`summary` interpolates quantiles and cannot be
        merged; this can — serving worker processes ship it over their
        metrics pipe and the parent folds it in with
        :meth:`absorb_delta`."""
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "last": self.last,
                "buckets": list(self._buckets),
            }

    def absorb_delta(self, new: dict, prev: Optional[dict] = None) -> None:
        """Fold another process's :meth:`transport` state in as a delta
        against ``prev`` (the previous snapshot absorbed from the same
        source): count/sum/buckets add their increments, min/max merge,
        last adopts the source's latest.  The sender's state is
        cumulative, so a dropped snapshot loses nothing — the next one
        carries the missed increments."""
        prev = prev or {}
        prev_buckets = prev.get("buckets")
        with self._lock:
            self.count += new["count"] - prev.get("count", 0)
            self.sum += new["sum"] - prev.get("sum", 0.0)
            for i, c in enumerate(new["buckets"]):
                self._buckets[i] += c - (prev_buckets[i] if prev_buckets
                                         else 0)
            if new["min"] is not None:
                self.min = (new["min"] if self.min is None
                            else min(self.min, new["min"]))
            if new["max"] is not None:
                self.max = (new["max"] if self.max is None
                            else max(self.max, new["max"]))
            if new["last"] is not None:
                self.last = new["last"]


class _NullMetric:
    """Shared no-op metric: one attribute call and out."""

    __slots__ = ()

    def inc(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass


_NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Named counters/gauges/histograms, thread-safe, JSON-snapshottable.

    Disabled registries hand back a shared no-op metric object, so an
    instrumented call site pays one branch whether telemetry is on or
    off.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, cls):
        if not self.enabled:
            return _NULL_METRIC
        with self._lock:
            m = table.get(name)
            if m is None:
                for kind, other in (
                    ("counter", self._counters),
                    ("gauge", self._gauges),
                    ("histogram", self._histograms),
                ):
                    if other is not table and name in other:
                        raise ValueError(
                            f"metric {name!r} is already registered as a "
                            f"{kind}; one name = one kind (the Prometheus "
                            "exposition cannot represent both)"
                        )
                m = table[name] = cls(self._lock)
            return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def snapshot(self) -> dict:
        """JSON-able view of every metric, stable key order."""
        with self._lock:
            counters = {k: self._counters[k].value
                        for k in sorted(self._counters)}
            gauges = {k: json_safe(self._gauges[k].value)
                      for k in sorted(self._gauges)}
            hists = dict(sorted(self._histograms.items()))
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: h.summary() for k, h in hists.items()},
        }

    def transport_snapshot(self) -> dict:
        """Mergeable cross-process snapshot: counter/gauge values plus
        each histogram's raw :meth:`Histogram.transport` state
        (:meth:`snapshot`'s summaries interpolate quantiles and cannot
        be merged).  Serving worker processes ship this over their
        heartbeat pipe; the parent registry folds it in with
        :meth:`absorb_delta`, so /metrics, /stats, and the admission
        tiers see one pool-wide view."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: json_safe(g.value) for k, g in self._gauges.items()}
            hists = dict(self._histograms)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: h.transport() for k, h in hists.items()},
        }

    def absorb_delta(self, new: dict, prev: Optional[dict] = None) -> None:
        """Merge another registry's :meth:`transport_snapshot`: counters
        add the increment since ``prev`` (the previous snapshot absorbed
        from the SAME source), gauges adopt the source's latest value,
        histograms fold their bucket deltas.  Senders keep cumulative
        state, so the merge is loss-tolerant and idempotent per
        (snapshot, prev) pair."""
        if not self.enabled:
            return
        prev = prev or {}
        prev_counters = prev.get("counters", {})
        for name, value in (new.get("counters") or {}).items():
            delta = value - prev_counters.get(name, 0)
            if delta:
                self.counter(name).inc(delta)
        for name, value in (new.get("gauges") or {}).items():
            self.gauge(name).set(value)
        prev_hists = prev.get("histograms", {})
        for name, state in (new.get("histograms") or {}).items():
            self.histogram(name).absorb_delta(state, prev_hists.get(name))


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op span for the disabled path (no allocation per call)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Adopt:
    """Context manager behind :meth:`Telemetry.adopt`: installs a remote
    :class:`TraceContext` as this thread's distributed context for the
    duration.  ``ctx=None`` degrades to a no-op enter/exit — cheap
    enough that every transport handler wraps unconditionally."""

    __slots__ = ("_hub", "_ctx", "_prev")

    def __init__(self, hub: "Telemetry", ctx):
        self._hub = hub
        self._ctx = ctx

    def __enter__(self) -> "Telemetry":
        if self._ctx is not None:
            local = self._hub._local
            self._prev = getattr(local, "remote", None)
            local.remote = self._ctx
        return self._hub

    def __exit__(self, *exc) -> bool:
        if self._ctx is not None:
            self._hub._local.remote = self._prev
        return False


class Span:
    """One wall-clock interval; emits a record to the hub's sinks on exit.

    Timestamps are monotonic (``perf_counter``) relative to the hub's
    epoch, so span math is immune to wall-clock steps; the hub's meta
    record carries the wall-clock epoch for correlation.
    """

    __slots__ = ("_hub", "name", "attrs", "span_id", "parent_id", "t0",
                 "_tid", "_remote")

    def __init__(self, hub: "Telemetry", name: str, attrs: dict):
        self._hub = hub
        self.name = name
        self.attrs = attrs
        self.span_id = None
        self.parent_id = None
        self.t0 = None
        self._tid = None
        self._remote = None

    def set(self, **attrs) -> "Span":
        """Attach attributes mid-span (solver iteration counts, sizes)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        hub = self._hub
        stack = hub._span_stack()
        # Parent: the innermost span on THIS thread, else an attached
        # cross-thread context (hub.attach) — how the prefetch pack/
        # transfer threads, the serving dispatch thread, and the tuning
        # workers nest under the span that spawned their work.
        self.parent_id = (
            stack[-1].span_id if stack
            else getattr(hub._local, "inherit", None)
        )
        self.span_id = next(hub._ids)
        self._tid = threading.get_ident()
        self._remote = getattr(hub._local, "remote", None)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        hub = self._hub
        stack = hub._span_stack()
        # Defensive pop: a mismatched exit (caller error) must not corrupt
        # sibling spans' parents for the rest of the run.
        while stack and stack.pop() is not self:
            pass
        remote = self._remote
        tail = False
        if remote is not None and not remote.sampled \
                and exc_type is None:
            # Head-unsampled request: drop the span record UNLESS the
            # hop blew the tail-retention SLO (then keep it, tagged) —
            # the slow 1-in-N request is exactly the one worth a trace.
            # Errored spans always emit.  Metrics are sampling-blind.
            slo = hub.trace_tail_slo_s
            if slo is None or (t1 - self.t0) < slo:
                return False
            tail = True
        record = {
            "type": "span",
            "name": self.name,
            "ts": self.t0 - hub._epoch_perf,
            "dur": t1 - self.t0,
            "id": self.span_id,
            "parent": self.parent_id,
            "tid": self._tid,
        }
        if remote is not None:
            # Cross-process stitching fields: the distributed trace id,
            # this span's GLOBAL id, and — for the local root of the
            # adopted subtree — the remote parent's global id.
            record["trace"] = remote.trace_id
            record["gid"] = f"{hub._global_span_id(self.span_id):016x}"
            if self.parent_id is None and remote.span_id:
                record["rparent"] = f"{remote.span_id:016x}"
            if tail:
                record["tail"] = True
        if exc_type is not None:
            record["error"] = f"{exc_type.__name__}: {exc}"
        if self.attrs:
            record["attrs"] = {k: json_safe(v)
                               for k, v in self.attrs.items()}
        hub._emit(record)
        return False


# ---------------------------------------------------------------------------
# The hub
# ---------------------------------------------------------------------------

class Telemetry:
    """Span + event + metrics hub feeding a list of sinks.

    ``output_dir`` builds the standard sink set: ``events.jsonl``
    (JSONL, source of truth), ``trace.json`` (Chrome trace-event array),
    and — when ``logger`` is given — an end-of-run summary through it.
    ``enabled=False`` (or an empty sink list) makes every span/event a
    single-branch no-op; the metrics registry follows ``enabled``.

    Use as a context manager to install as the process-current hub
    (:func:`current`), restoring the previous one and closing sinks on
    exit::

        with Telemetry(output_dir=out, logger=logger) as tel:
            with tel.span("run", driver="glm"):
                ...
    """

    def __init__(
        self,
        output_dir: Optional[str] = None,
        sinks=None,
        logger=None,
        enabled: bool = True,
        run_name: str = "run",
    ):
        self.enabled = enabled
        self.run_name = run_name
        self.output_dir = output_dir
        self._epoch_perf = time.perf_counter()
        self._epoch_wall = time.time()
        #: process-unique trace id: spans/events carry it implicitly (one
        #: hub = one trace); the meta record publishes it so traces from
        #: several processes can be correlated after a Perfetto merge.
        self.trace_id = uuid.uuid4().hex[:16]
        #: 32-bit node tag mixed into GLOBAL span ids: two hubs (even in
        #: one process — tests run several) never collide, so a merged
        #: multi-process trace keeps its parent links unambiguous.
        self._node = int(uuid.uuid4().hex[:8], 16)
        #: head sampling: a fresh trace is sampled iff its 64-bit id is
        #: 0 mod this (deterministic — every hop agrees without talking).
        self.trace_sample_every = 256
        #: tail retention: an UNSAMPLED hop slower than this still emits
        #: its span records, tagged ``"tail": true``.  None = off.
        self.trace_tail_slo_s: Optional[float] = None
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._emit_lock = threading.Lock()
        self._closed = False
        self._restore_token = None
        self.metrics = MetricsRegistry(enabled=enabled)
        if sinks is None:
            sinks = []
            if enabled and output_dir is not None:
                from photon_ml_tpu_torch.telemetry.recorder import FlightRecorder
                from photon_ml_tpu_torch.telemetry.sinks import (
                    ChromeTraceSink,
                    JsonlSink,
                    LoggerSummarySink,
                )

                os.makedirs(output_dir, exist_ok=True)
                sinks.append(
                    JsonlSink(os.path.join(output_dir, "events.jsonl"))
                )
                sinks.append(
                    ChromeTraceSink(os.path.join(output_dir, "trace.json"))
                )
                # Always-on forensics ring: bounded memory, dumped only
                # on crash / watchdog-fatal / injected chaos fault.
                sinks.append(FlightRecorder())
                if logger is not None:
                    sinks.append(LoggerSummarySink(logger))
        self._sinks = list(sinks)
        if self.active:
            self._emit({
                "type": "meta",
                "name": run_name,
                "ts": 0.0,
                "wall_epoch": self._epoch_wall,
                "pid": os.getpid(),
                "trace": self.trace_id,
                "node": f"{self._node:08x}",
            })

    # -- state ---------------------------------------------------------------
    @property
    def active(self) -> bool:
        """True when events/spans actually reach a sink."""
        return self.enabled and bool(self._sinks) and not self._closed

    def _span_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- trace-context propagation -------------------------------------------
    def _global_span_id(self, local_id: int) -> int:
        """Process-transcending span id: node tag (high 32) | local id
        (low 32).  What :class:`TraceContext` carries across hops and
        span records publish as ``gid``."""
        return ((self._node & 0xFFFFFFFF) << 32) \
            | (int(local_id) & 0xFFFFFFFF)

    def configure_tracing(
        self,
        sample_every: Optional[int] = None,
        tail_slo_s: Optional[float] = None,
    ) -> "Telemetry":
        """Set the distributed-tracing knobs (docs/telemetry.md):
        ``sample_every`` — head-sample 1 in N new traces (1 = all);
        ``tail_slo_s`` — emit UNSAMPLED hops slower than this anyway,
        tagged ``tail``.  Returns self for chaining."""
        if sample_every is not None:
            sample_every = int(sample_every)
            if sample_every < 1:
                raise ValueError(
                    f"sample_every must be >= 1, got {sample_every}"
                )
            self.trace_sample_every = sample_every
        if tail_slo_s is not None:
            tail_slo_s = float(tail_slo_s)
            if tail_slo_s <= 0:
                raise ValueError(
                    f"tail_slo_s must be > 0, got {tail_slo_s}"
                )
            self.trace_tail_slo_s = tail_slo_s
        return self

    def new_trace(self, sampled: Optional[bool] = None) -> TraceContext:
        """Mint the root context for one request entering the system
        (the fleet router / service edge calls this).  The head-sampling
        verdict is decided HERE, deterministically from the trace id, so
        every downstream hop re-derives the same answer for free."""
        # os.urandom over uuid4: same 64 random bits at ~1/6 the cost —
        # this runs once per request on the serving edge.
        trace_word = int.from_bytes(os.urandom(8), "big")
        while trace_word == 0:  # 0 means "no context" on binary wires
            trace_word = int.from_bytes(os.urandom(8), "big")
        if sampled is None:
            every = self.trace_sample_every
            sampled = every <= 1 or trace_word % every == 0
        return TraceContext(f"{trace_word:016x}", 0, sampled)

    def adopt(self, ctx: Optional[TraceContext]) -> "_Adopt":
        """Adopt a remote hop's :class:`TraceContext` for spans opened
        on this thread: their records gain the distributed ``trace`` /
        ``gid`` fields, the first one parents to the remote span
        (``rparent``), and the sampling verdict applies.  None → no-op,
        so transport handlers adopt unconditionally.  (A slotted context
        manager, not contextlib — this sits on the per-request path.)"""
        return _Adopt(self, ctx if self.active else None)

    def propagation_context(self) -> Optional[TraceContext]:
        """The :class:`TraceContext` to send DOWNSTREAM from here: the
        adopted remote trace with the current span's global id as the
        parent.  None when no remote context is active — background work
        pays one branch and sends nothing."""
        if not self.active:
            return None
        remote = getattr(self._local, "remote", None)
        if remote is None:
            return None
        stack = self._span_stack()
        if stack:
            span_id = self._global_span_id(stack[-1].span_id)
        else:
            inherit = getattr(self._local, "inherit", None)
            span_id = (self._global_span_id(inherit)
                       if inherit is not None else remote.span_id)
        return TraceContext(remote.trace_id, span_id, remote.sampled)

    def current_context(self) -> Optional[tuple]:
        """``(trace_id, span_id, remote_ctx)`` of this thread's
        innermost span — the handle a caller passes to :meth:`attach` on
        another thread so work it farms out nests under the span that
        requested it (and keeps the adopted distributed context, if
        any).  None when the hub is inactive or no span is open."""
        if not self.active:
            return None
        remote = getattr(self._local, "remote", None)
        stack = self._span_stack()
        if stack:
            return (self.trace_id, stack[-1].span_id, remote)
        inherit = getattr(self._local, "inherit", None)
        if inherit is not None:
            return (self.trace_id, inherit, remote)
        if remote is not None:
            # Adopted remote with no local span open (a transport
            # handler between hops — the worker's score loop): the
            # capture still carries the distributed context, so work
            # farmed to another thread parents to the REMOTE span.
            return (self.trace_id, None, remote)
        return None

    @contextlib.contextmanager
    def attach(self, ctx: Optional[tuple]):
        """Adopt ``ctx`` (a :meth:`current_context` capture) as this
        thread's parent for spans/events opened while attached.  No-op
        for None / inactive hubs, so threads attach unconditionally at
        one-branch cost when telemetry is off.  Accepts the legacy
        2-tuple form; the 3-tuple form also restores the distributed
        remote context across the thread hop."""
        if ctx is None or not self.active:
            yield self
            return
        prev = getattr(self._local, "inherit", None)
        prev_remote = getattr(self._local, "remote", None)
        self._local.inherit = ctx[1]
        has_remote = len(ctx) > 2
        if has_remote:
            self._local.remote = ctx[2]
        try:
            yield self
        finally:
            self._local.inherit = prev
            if has_remote:
                self._local.remote = prev_remote

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager for a hierarchical wall-clock span."""
        if not self.active:
            return _NULL_SPAN
        # Head-unsampled distributed request with tail retention off:
        # nothing under this span can ever emit (every hop shares the
        # verdict), so skip the Span bookkeeping entirely — this is the
        # 255-in-256 per-request path on the serving edge.
        remote = getattr(self._local, "remote", None)
        if remote is not None and not remote.sampled \
                and self.trace_tail_slo_s is None:
            return _NULL_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """Instant (zero-duration) event under the current span."""
        if not self.active:
            return
        stack = self._span_stack()
        record = {
            "type": "event",
            "name": name,
            "ts": time.perf_counter() - self._epoch_perf,
            "parent": (
                stack[-1].span_id if stack
                else getattr(self._local, "inherit", None)
            ),
            "tid": threading.get_ident(),
        }
        if attrs:
            record["attrs"] = {k: json_safe(v) for k, v in attrs.items()}
        self._emit(record)

    def counter(self, name: str) -> Counter:
        return self.metrics.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.metrics.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.metrics.histogram(name)

    def _emit(self, record: dict) -> None:
        with self._emit_lock:
            for sink in self._sinks:
                try:
                    sink.emit(record)
                except Exception:
                    # Observability must never sink the job it observes.
                    pass

    # -- flight recorder -----------------------------------------------------
    @property
    def recorder(self):
        """The hub's :class:`~photon_ml_tpu_torch.telemetry.recorder.
        FlightRecorder` sink, or None (only hubs built with an
        ``output_dir`` install one by default)."""
        from photon_ml_tpu_torch.telemetry.recorder import FlightRecorder

        for sink in self._sinks:
            if isinstance(sink, FlightRecorder):
                return sink
        return None

    def dump_flight_recorder(
        self, reason: str, path: Optional[str] = None
    ) -> Optional[str]:
        """Write the flight-recorder ring to ``flightrecorder.json`` in
        the output dir (or ``path``); returns the path, or None when no
        recorder/destination exists.  Never raises — forensics must not
        mask the failure being recorded."""
        rec = self.recorder
        if rec is None:
            return None
        if path is None:
            if self.output_dir is None:
                return None
            path = os.path.join(self.output_dir, "flightrecorder.json")
        try:
            return rec.dump(
                path, reason=reason, wall_epoch=self._epoch_wall,
                trace=self.trace_id,
            )
        except Exception:
            return None

    # -- snapshot / shutdown -------------------------------------------------
    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    def write_snapshot(self, path: Optional[str] = None) -> Optional[str]:
        """Write the metrics snapshot JSON; defaults to
        ``<output_dir>/metrics.json``.  Safe to call repeatedly (the
        drivers write once at end of run)."""
        if path is None:
            if self.output_dir is None:
                return None
            path = os.path.join(self.output_dir, "metrics.json")
        snap = self.snapshot()
        snap["wall_epoch"] = self._epoch_wall
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=2)
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        """Flush and close every sink (passing them the final metrics
        snapshot) and write ``metrics.json``.  Idempotent."""
        if self._closed:
            return
        snap = self.snapshot()
        self._closed = True
        for sink in self._sinks:
            try:
                sink.close(snap)
            except Exception:
                pass
        if self.enabled and self.output_dir is not None:
            try:
                self.write_snapshot()
            except OSError:
                pass

    # -- context manager: install as current ----------------------------------
    def __enter__(self) -> "Telemetry":
        self._restore_token = set_current(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        set_current(self._restore_token)
        self._restore_token = None
        if exc_type is not None and not self._closed:
            # Crash forensics: the last-N events leading into the
            # failure, dumped before sinks close (drivers run context-
            # managed, so every crashed run leaves flightrecorder.json).
            self.dump_flight_recorder(
                reason=f"crash: {exc_type.__name__}: {exc}"[:300]
            )
        self.close()
        return False


# ---------------------------------------------------------------------------
# Process-current hub
# ---------------------------------------------------------------------------

#: Shared disabled hub: the default target for instrumented call sites, so
#: library use without a driver costs one branch per event.
NULL = Telemetry(enabled=False, sinks=[])

_current: Telemetry = NULL
_current_lock = threading.Lock()


def current() -> Telemetry:
    """The process-current telemetry hub (a disabled no-op by default)."""
    return _current


def set_current(hub: Optional[Telemetry]) -> Telemetry:
    """Install ``hub`` (None → the disabled NULL hub) as process-current;
    returns the previous hub so callers can restore it."""
    global _current
    with _current_lock:
        prev = _current
        _current = hub if hub is not None else NULL
        return prev


def host_identity(host_id: Optional[str] = None) -> dict:
    """Stable provenance block every heartbeat carries so merged metrics
    never GUESS which host a number came from: explicit ``host_id`` >
    ``$PHOTON_HOST_ID`` > hostname, plus the emitting pid (the
    reference keeps this in ``telemetry/exporter.py``)."""
    import socket

    return {
        "host_id": str(
            host_id
            or os.environ.get("PHOTON_HOST_ID")
            or socket.gethostname()
        ),
        "pid": os.getpid(),
    }


def dump_flight_recorder(reason: str, path=None) -> Optional[str]:
    """Dump the process-current hub's flight recorder (see
    :meth:`Telemetry.dump_flight_recorder`).  The chaos injector and the
    watchdog's fatal path call this so every deliberate or fatal failure
    leaves its trailing event window on disk."""
    return current().dump_flight_recorder(reason, path)
