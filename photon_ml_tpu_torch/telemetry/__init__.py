"""Unified telemetry: spans, metrics, and pluggable sinks (port of
``photon_ml_tpu/telemetry``: the hub of ``core.py`` with the sinks and
the flight recorder it loads lazily).

Public surface::

    from photon_ml_tpu_torch import telemetry

    with telemetry.Telemetry(output_dir=out, logger=logger) as tel:
        with tel.span("run", driver="serving"):
            tel.event("checkpoint.save", path=p)
            tel.counter("solver_iterations").inc(12)

Library code that cannot be handed a hub uses :func:`current` — a
disabled no-op by default, the installed hub inside a run.  The serving
tier reads its latency histograms back from the hub (the batcher's p99
admission signal).  The live ops plane (the reference's ``exporter.py``,
``timeseries.py``, ``fleet.py``) and ``python -m ...telemetry`` are not
ported yet.
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
