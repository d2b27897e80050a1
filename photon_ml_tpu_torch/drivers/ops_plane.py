"""The drivers' telemetry hub and live ops plane (the reference drivers'
``Telemetry(output_dir=..., logger=..., enabled=...)``, ``run`` span and
``mount_ops_plane`` around their ``_run_impl``), shared by the GLM and
GAME drivers."""

from __future__ import annotations

import argparse
import contextlib

from photon_ml_tpu_torch import telemetry as telemetry_mod


def add_telemetry_args(p: argparse.ArgumentParser,
                       ops_plane: bool = True) -> None:
    """The reference drivers' ``--telemetry`` and, with ``ops_plane``,
    ``--metrics-port`` and ``--metrics-interval-s``."""
    p.add_argument(
        "--telemetry",
        choices=["on", "off"],
        default="on",
        help="unified telemetry (events.jsonl + trace.json + metrics.json "
        "in the output dir, summary in the log). 'off' reduces every "
        "instrumented site to one branch",
    )
    if not ops_plane:
        return
    p.add_argument(
        "--metrics-port",
        type=int,
        default=None,
        help="expose the live ops plane on this port while the run is "
        "in flight (/metrics Prometheus exposition, /snapshot JSON, "
        "/healthz); 0 binds an ephemeral port; omit to disable",
    )
    p.add_argument(
        "--metrics-interval-s",
        type=float,
        default=1.0,
        help="interval of the metrics_ts.jsonl time-series sampler "
        "(live registry snapshots in the output dir; 0 disables)",
    )


@contextlib.contextmanager
def driver_telemetry(args, logger, driver: str, writer: bool = True,
                     **attrs):
    """The driver run's hub, its ``run`` span and the mounted ops plane,
    yielding the hub.  The hub is the process-current one inside, and the
    previous one is restored on ANY exit (repeated in-process runs, tuning
    threads).  A rank that does not write the outputs keeps its hub in
    memory and mounts no exporter."""
    tel = telemetry_mod.Telemetry(
        output_dir=args.output_dir if writer else None,
        logger=logger if writer else None,
        enabled=args.telemetry != "off",
    )
    with contextlib.ExitStack() as stack:
        stack.enter_context(tel)
        stack.enter_context(tel.span("run", driver=driver, **attrs))
        if writer and hasattr(args, "metrics_port"):
            stack.enter_context(telemetry_mod.mount_ops_plane(
                tel, port=args.metrics_port,
                interval_s=args.metrics_interval_s, logger=logger,
            ))
        yield tel
