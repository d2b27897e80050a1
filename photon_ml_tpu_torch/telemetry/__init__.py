"""Unified telemetry: spans, metrics, and pluggable sinks (port of
``photon_ml_tpu/telemetry``: the hub of ``core.py`` with the sinks and
the flight recorder it loads lazily, and the live ops plane).

Public surface::

    from photon_ml_tpu_torch import telemetry

    with telemetry.Telemetry(output_dir=out, logger=logger) as tel:
        with tel.span("run", driver="serving"):
            tel.event("checkpoint.save", path=p)
            tel.counter("solver_iterations").inc(12)

Library code that cannot be handed a hub uses :func:`current` — a
disabled no-op by default, the installed hub inside a run.  The serving
tier reads its latency histograms back from the hub (the batcher's p99
admission signal).

The live ops plane composes on top: :class:`TimeSeriesSampler` streams
registry snapshots into ``metrics_ts.jsonl``, :class:`MetricsExporter`
serves Prometheus text exposition at ``/metrics`` (mount both with
:func:`mount_ops_plane` behind a ``--metrics-port`` flag),
:class:`FleetAggregator` folds many hosts' ``/snapshot`` into one view
with SLO burn alerts, and the :class:`FlightRecorder` ring dumps the
last-N events on crash / watchdog-fatal / injected chaos fault.
``python -m photon_ml_tpu_torch.telemetry --selfcheck`` exercises every
sink and the plane and validates the outputs.  No metric of the plane
reads a device tensor: the instrumented sites publish host values only.
"""

from photon_ml_tpu_torch.telemetry.core import (  # noqa: F401
    NULL,
    TRACE_HEADER,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Span,
    Telemetry,
    TraceContext,
    current,
    dump_flight_recorder,
    host_identity,
    json_safe,
    set_current,
)
from photon_ml_tpu_torch.telemetry.recorder import FlightRecorder  # noqa: F401
from photon_ml_tpu_torch.telemetry.sinks import (  # noqa: F401
    ChromeTraceSink,
    JsonlSink,
    LoggerSummarySink,
    Sink,
)
from photon_ml_tpu_torch.telemetry.exporter import (  # noqa: F401
    MetricsExporter,
    OpsPlane,
    mount_ops_plane,
    parse_prometheus_text,
    prometheus_text,
)
from photon_ml_tpu_torch.telemetry.timeseries import (  # noqa: F401
    TimeSeriesSampler,
    read_series,
)
from photon_ml_tpu_torch.telemetry.fleet import (  # noqa: F401
    FleetAggregator,
    SloPolicy,
)
