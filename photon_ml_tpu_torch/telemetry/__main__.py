"""Telemetry smoke entry point (port of
``photon_ml_tpu/telemetry/__main__.py``).

``python -m photon_ml_tpu_torch.telemetry --selfcheck`` emits a synthetic span
tree (including a cross-thread producer span, instant events, and every
metric kind) through the full sink set into a scratch directory, then
validates the outputs:

- every ``events.jsonl`` line parses as JSON and carries type/name/ts;
- ``trace.json`` parses as a Chrome trace-event ARRAY whose span events
  have the required ph/ts/dur/pid/tid fields and whose parent links
  resolve;
- ``metrics.json`` round-trips the registry snapshot;
- **ops plane**: the time-series sampler wrote ≥ 2 monotone-timestamped
  snapshots to ``metrics_ts.jsonl`` carrying the ``hbm_live_bytes``
  gauge (synthetic here, as in the reference: the device-memory name
  the prefetch pipeline publishes),
  the embedded exporter's ``/metrics`` output PARSES as Prometheus text
  exposition (and ``/snapshot`` as JSON), and the exporter thread joins
  cleanly on close;
- **flight recorder**: an injected chaos fault (``serving.batch`` via a
  scripted FaultPlan) dumps ``flightrecorder.json`` whose last-N events
  END at the fault site's ``chaos.fault`` record;
- **fleet pass**: a synthetic 2-host x 2-worker fleet — one
  traced request crosses router -> host -> worker hubs via
  ``TraceContext`` header propagation and the merged Chrome traces
  stitch into ONE trace (shared trace id, ``rparent`` links resolving
  across files); a :class:`FleetAggregator` scrapes both hosts' live
  ``/snapshot`` endpoints and its aggregated ``/metrics`` exposition
  PARSES with per-``host`` labels; injected slow latency trips the
  multi-window SLO burn alert (``slo.burn`` event + flight-recorder
  dump), and a scripted ``telemetry.scrape`` fault degrades to
  last-seen snapshots (failures counted, recovery observed) without
  wedging the poll loop.

``--lint-metrics`` runs the metric-name lint (``telemetry/lint.py``, the
invariant checker's ``metric-naming`` rule) over the port's source
instead: duplicate-kind registrations and non-conforming
``<subsystem>_<name>_<unit>`` names fail the check.

Exit status 0 on success; nonzero with a diagnostic on any failure —
CI-greppable, device-free (imports no torch device code).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time


def _build_synthetic_run(out_dir: str) -> dict:
    from photon_ml_tpu_torch.telemetry import Telemetry, mount_ops_plane

    info: dict = {}
    with Telemetry(output_dir=out_dir, run_name="selfcheck") as tel:
        plane = mount_ops_plane(tel, port=0, interval_s=0.02)
        with tel.span("run", driver="selfcheck"):
            for it in range(2):
                with tel.span("cd_iteration", iteration=it):
                    for coord in ("fixed", "per_user"):
                        with tel.span(
                            "coordinate", coordinate=coord, iteration=it
                        ):
                            with tel.span(
                                "solver", coordinate=coord,
                                optimizer="lbfgs",
                            ) as sp:
                                time.sleep(0.001)
                                sp.set(iterations=7, converged=True)
                            tel.counter("solver_iterations").inc(7)
                tel.event(
                    "checkpoint.save", iteration=it, path="<synthetic>"
                )

            ctx = tel.current_context()

            def producer():
                # Cross-thread spans ATTACH the spawning span's context
                # (the h2d prefetch producer's shape) so the Perfetto
                # view nests the producer track under the run.
                with tel.attach(ctx):
                    for k in range(3):
                        with tel.span("chunk", index=k):
                            time.sleep(0.0005)
                        tel.histogram("stream_chunk_seconds").observe(
                            0.0005
                        )
                        tel.gauge("hbm_live_bytes").set((k + 1) * 1024)
                    tel.gauge("h2d_gbps").set(1.25)
                    tel.counter("h2d_bytes_total").inc(3 * 1024)

            t = threading.Thread(
                target=producer, name="h2d-prefetch", daemon=True
            )
            t.start()
            t.join()
            tel.event(
                "watchdog.attempt", attempt=0, outcome="ok",
                exception=None,
            )

            # Injected chaos fault → flight-recorder dump ending at the
            # fault site (chaos/core.py touches no device; this stays a
            # device-free check).
            from photon_ml_tpu_torch import chaos

            with chaos.FaultPlan([chaos.FaultSpec(site="serving.batch")]):
                try:
                    chaos.maybe_fail("serving.batch", rows=4)
                    info["fault_raised"] = False
                except chaos.InjectedFault:
                    info["fault_raised"] = True

            # Let the interval sampler take >= 2 samples past the start
            # sample, then scrape the live endpoints.
            time.sleep(0.08)
            import urllib.request

            port = plane.port
            for route, key in (
                ("/metrics", "prom_text"),
                ("/snapshot", "snapshot_body"),
                ("/healthz", "healthz_body"),
            ):
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{route}", timeout=10
                ) as resp:
                    info[key] = resp.read().decode()
                    info[key + "_status"] = resp.status
        snap = tel.snapshot()
        exporter = plane.exporter
        plane.close()
        info["exporter_alive_after_close"] = exporter.alive
        info["sampler_alive_after_close"] = (
            plane.sampler is not None and plane.sampler.alive
        )
    info["snapshot"] = snap
    return info


def validate_outputs(out_dir: str, snapshot: dict) -> list[str]:
    """Returns a list of failure strings (empty = pass)."""
    failures: list[str] = []

    events_path = os.path.join(out_dir, "events.jsonl")
    trace_path = os.path.join(out_dir, "trace.json")
    metrics_path = os.path.join(out_dir, "metrics.json")
    for p in (events_path, trace_path, metrics_path):
        if not os.path.exists(p):
            failures.append(f"missing output: {p}")
    if failures:
        return failures

    span_ids = set()
    parents = []
    n_lines = 0
    with open(events_path) as f:
        for lineno, line in enumerate(f, 1):
            n_lines += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                failures.append(f"events.jsonl:{lineno} unparseable: {e}")
                continue
            if rec.get("type") == "metrics":
                # Trailing registry snapshot record — no name/ts.
                continue
            if "type" not in rec or "name" not in rec or "ts" not in rec:
                failures.append(
                    f"events.jsonl:{lineno} missing type/name/ts: {rec}"
                )
            if rec.get("type") == "span":
                span_ids.add(rec["id"])
                if rec.get("parent") is not None:
                    parents.append((lineno, rec["parent"]))
                if rec.get("dur", -1.0) < 0.0:
                    failures.append(
                        f"events.jsonl:{lineno} negative span duration"
                    )
    if n_lines == 0:
        failures.append("events.jsonl is empty")
    for lineno, parent in parents:
        if parent not in span_ids:
            failures.append(
                f"events.jsonl:{lineno} dangling parent span {parent}"
            )

    with open(trace_path) as f:
        try:
            trace = json.load(f)
        except json.JSONDecodeError as e:
            failures.append(f"trace.json unparseable: {e}")
            trace = None
    if trace is not None:
        if not isinstance(trace, list):
            failures.append(
                f"trace.json is {type(trace).__name__}, not an array"
            )
        else:
            n_spans = 0
            for i, ev in enumerate(trace):
                if not isinstance(ev, dict):
                    failures.append(f"trace.json[{i}] not an object")
                    continue
                missing = [k for k in ("name", "ph", "ts", "pid", "tid")
                           if k not in ev]
                if missing:
                    failures.append(
                        f"trace.json[{i}] missing {missing}"
                    )
                if ev.get("ph") == "X":
                    n_spans += 1
                    if "dur" not in ev:
                        failures.append(
                            f"trace.json[{i}] X event without dur"
                        )
            if n_spans == 0:
                failures.append("trace.json holds no span (X) events")

    with open(metrics_path) as f:
        try:
            metrics = json.load(f)
        except json.JSONDecodeError as e:
            failures.append(f"metrics.json unparseable: {e}")
            metrics = {}
    for kind in ("counters", "gauges", "histograms"):
        if kind not in metrics:
            failures.append(f"metrics.json missing {kind!r}")
        elif snapshot.get(kind) and metrics[kind] != json.loads(
            json.dumps(snapshot[kind])
        ):
            failures.append(
                f"metrics.json {kind} diverge from the live snapshot"
            )
    return failures


def validate_ops_plane(out_dir: str, info: dict) -> list[str]:
    """Validate the live ops plane's outputs: the time-series file, the
    Prometheus exposition scraped while the run was live, the exporter's
    thread lifecycle, and the chaos-fault flight-recorder dump."""
    from photon_ml_tpu_torch.telemetry.exporter import parse_prometheus_text
    from photon_ml_tpu_torch.telemetry.timeseries import read_series

    failures: list[str] = []

    # -- metrics_ts.jsonl: >= 2 monotone snapshots w/ the hbm_live_bytes gauge
    ts_path = os.path.join(out_dir, "metrics_ts.jsonl")
    if not os.path.exists(ts_path):
        failures.append(f"missing time series: {ts_path}")
    else:
        series = read_series(ts_path)
        if len(series) < 2:
            failures.append(
                f"metrics_ts.jsonl has {len(series)} snapshots, need >= 2"
            )
        for key in ("seq", "t_mono"):
            vals = [rec.get(key) for rec in series]
            if any(b <= a for a, b in zip(vals, vals[1:])):
                failures.append(
                    f"metrics_ts.jsonl {key} not strictly increasing: "
                    f"{vals}"
                )
        if series and "hbm_live_bytes" not in (
            series[-1].get("gauges") or {}
        ):
            failures.append(
                "metrics_ts.jsonl final snapshot lacks the live "
                "hbm_live_bytes gauge"
            )

    # -- /metrics parses as Prometheus exposition --------------------------
    prom = info.get("prom_text")
    if not prom:
        failures.append("/metrics returned no body")
    else:
        try:
            parsed = parse_prometheus_text(prom)
        except ValueError as e:
            failures.append(f"/metrics exposition unparseable: {e}")
            parsed = {}
        for family in ("hbm_live_bytes", "solver_iterations"):
            if (family, "") not in parsed:
                failures.append(
                    f"/metrics lacks the {family} family"
                )
        if not any(
            name == "stream_chunk_seconds" and 'quantile="0.5"' in labels
            for name, labels in parsed
        ):
            failures.append(
                "/metrics lacks histogram quantile samples "
                "(stream_chunk_seconds{quantile=...})"
            )

    # -- /snapshot + /healthz are JSON -------------------------------------
    for key in ("snapshot_body", "healthz_body"):
        body = info.get(key)
        if not body:
            failures.append(f"{key.split('_')[0]} endpoint returned nothing")
            continue
        try:
            json.loads(body)
        except json.JSONDecodeError as e:
            failures.append(f"{key} is not JSON: {e}")

    # -- exporter/sampler thread lifecycle ---------------------------------
    if info.get("exporter_alive_after_close"):
        failures.append("exporter thread still alive after close()")
    if info.get("sampler_alive_after_close"):
        failures.append("sampler thread still alive after stop()")

    # -- flight recorder: dump ends at the injected fault site -------------
    if not info.get("fault_raised"):
        failures.append("chaos fault did not raise (plan mis-armed?)")
    fr_path = os.path.join(out_dir, "flightrecorder.json")
    if not os.path.exists(fr_path):
        failures.append(f"missing flight-recorder dump: {fr_path}")
    else:
        with open(fr_path) as f:
            try:
                dump = json.load(f)
            except json.JSONDecodeError as e:
                failures.append(f"flightrecorder.json unparseable: {e}")
                dump = {}
        events = dump.get("events") or []
        if not events:
            failures.append("flightrecorder.json holds no events")
        else:
            last = events[-1]
            if last.get("name") != "chaos.fault" or (
                (last.get("attrs") or {}).get("site") != "serving.batch"
            ):
                failures.append(
                    "flightrecorder.json does not END at the fault "
                    f"site: last event {last.get('name')!r} "
                    f"attrs={last.get('attrs')}"
                )
        if dump.get("n_events", 0) > dump.get("capacity", 0):
            failures.append(
                "flight recorder dumped more events than its capacity"
            )
        if not str(dump.get("reason") or "").startswith("chaos"):
            failures.append(
                f"flight-recorder dump reason {dump.get('reason')!r} "
                "does not name the chaos fault"
            )
    return failures


def _build_fleet_run(out_dir: str) -> dict:
    """Synthetic 2-host x 2-worker fleet, all hubs in-process: a traced
    request hops router -> host -> worker through real ``TraceContext``
    header strings, the aggregator scrapes both hosts' live exporters
    over HTTP, injected slow latency trips the burn alert, and a chaos
    fault exercises scrape degradation.  Device-free and fast: no device,
    no subprocesses — the hop boundaries are exactly the header-encoded
    contexts the real transports carry."""
    import urllib.request

    from photon_ml_tpu_torch import chaos
    from photon_ml_tpu_torch.telemetry import (
        ChromeTraceSink,
        FleetAggregator,
        JsonlSink,
        MetricsExporter,
        SloPolicy,
        Telemetry,
        TraceContext,
    )

    info: dict = {}
    fleet_dir = os.path.join(out_dir, "fleet")
    os.makedirs(fleet_dir, exist_ok=True)

    def _leaf_hub(name: str) -> tuple:
        path = os.path.join(fleet_dir, name + ".trace.json")
        hub = Telemetry(
            sinks=[
                ChromeTraceSink(path),
                JsonlSink(os.path.join(fleet_dir, name + ".jsonl")),
            ],
            run_name=name,
        )
        return hub, path

    # The router hub doubles as the aggregator-side current hub: the
    # slo.burn event and its flight-recorder dump land in fleet_dir.
    with Telemetry(output_dir=fleet_dir, run_name="fleet-router") as router:
        router.configure_tracing(sample_every=1)
        hosts: dict = {}
        trace_files = [os.path.join(fleet_dir, "trace.json")]
        try:
            for hid in ("host-0", "host-1"):
                hub, path = _leaf_hub(hid)
                trace_files.append(path)
                workers = []
                for wk in range(2):
                    whub, wpath = _leaf_hub(f"{hid}-worker-{wk}")
                    trace_files.append(wpath)
                    workers.append(whub)
                exporter = MetricsExporter(hub, port=0, host_id=hid)
                exporter.start()
                hosts[hid] = {
                    "hub": hub, "workers": workers, "exporter": exporter,
                }

            # -- one traced request fanning out across the fleet -------
            ctx = router.new_trace()
            info["trace_id"] = ctx.trace_id
            info["trace_sampled"] = ctx.sampled
            with router.adopt(ctx), router.span("serving.fleet_route"):
                header = router.propagation_context().header_value()
            for hid, entry in hosts.items():
                hub = entry["hub"]
                # Each hop re-parses the wire string — the same
                # round-trip the HTTP header / wire frame / shm slot
                # transports perform.
                with hub.adopt(TraceContext.parse(header)), \
                        hub.span("serving.http_score", host=hid):
                    inner = hub.propagation_context().header_value()
                    for wk, whub in enumerate(entry["workers"]):
                        with whub.adopt(TraceContext.parse(inner)), \
                                whub.span("serving.batch", worker=wk):
                            pass

            # -- metrics: a healthy baseline, then injected latency ----
            for entry in hosts.values():
                hub = entry["hub"]
                lat = hub.histogram("serving_request_latency_seconds")
                for _ in range(50):
                    lat.observe(0.002)
                for stage in ("admission", "queue", "batch", "device",
                              "encode"):
                    hub.histogram(
                        f"serving_stage_{stage}_seconds"
                    ).observe(0.001)

            agg = FleetAggregator(
                {
                    hid: f"http://127.0.0.1:{entry['exporter'].port}"
                    for hid, entry in hosts.items()
                },
                policies=[SloPolicy(
                    name="latency-p99", p99_s=0.05, error_budget=0.01,
                )],
            )
            try:
                agg.poll_once(now=1000.0)  # baseline: all fast

                # -- scrape chaos: both hosts drop off for one round ---
                # (before the burn injection, so the burn's forensics
                # dump is the LAST flightrecorder.json write)
                with chaos.FaultPlan([chaos.FaultSpec(
                    site="telemetry.scrape", at=0, count=2,
                )]):
                    info["faulted_report"] = agg.poll_once(now=1030.0)
                info["recovered_report"] = agg.poll_once(now=1060.0)

                for entry in hosts.values():
                    lat = entry["hub"].histogram(
                        "serving_request_latency_seconds"
                    )
                    for _ in range(20):
                        lat.observe(1.0)  # way past the 50ms target
                info["burn_report"] = agg.poll_once(now=1120.0)

                port = agg.serve()
                for route, key in (
                    ("/metrics", "fleet_prom_text"),
                    ("/slo", "fleet_slo_body"),
                    ("/healthz", "fleet_healthz_body"),
                ):
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{route}", timeout=10
                    ) as resp:
                        info[key] = resp.read().decode()
            finally:
                agg.stop()
        finally:
            for entry in hosts.values():
                entry["exporter"].close()
                for whub in entry["workers"]:
                    whub.close()
                entry["hub"].close()
    info["trace_files"] = trace_files

    # Merge the per-hub Chrome traces the way ops would before loading
    # Perfetto: concatenate the event arrays.
    merged: list = []
    for path in trace_files:
        if os.path.exists(path):
            with open(path) as f:
                try:
                    merged.extend(json.load(f))
                except json.JSONDecodeError:
                    pass  # validated (and failed) per-file below
    merged_path = os.path.join(fleet_dir, "merged.trace.json")
    with open(merged_path, "w") as f:
        json.dump(merged, f)
    info["merged_path"] = merged_path
    return info


def validate_fleet(out_dir: str, info: dict) -> list[str]:
    """Validate the fleet pass: one stitched trace across 7 hubs, a
    parseable host-labeled aggregated exposition, a fired burn alert
    with its forensics dump, and non-wedging scrape degradation."""
    from photon_ml_tpu_torch.telemetry.exporter import parse_prometheus_text

    failures: list[str] = []
    fleet_dir = os.path.join(out_dir, "fleet")
    trace_id = info.get("trace_id")

    # -- stitched trace ----------------------------------------------------
    if not info.get("trace_sampled"):
        failures.append("fleet: sample_every=1 trace not head-sampled")
    gids: set = set()
    links: list = []  # (file, rparent)
    files_in_trace = 0
    for path in info.get("trace_files") or []:
        if not os.path.exists(path):
            failures.append(f"fleet: missing trace file {path}")
            continue
        with open(path) as f:
            try:
                events = json.load(f)
            except json.JSONDecodeError as e:
                failures.append(f"fleet: {path} unparseable: {e}")
                continue
        in_trace = False
        for ev in events:
            args = ev.get("args") or {}
            if ev.get("ph") == "X" and args.get("trace") == trace_id:
                in_trace = True
                if args.get("gid"):
                    gids.add(args["gid"])
                if args.get("rparent"):
                    links.append((path, args["rparent"]))
        if in_trace:
            files_in_trace += 1
    if files_in_trace != 7:
        failures.append(
            f"fleet: trace {trace_id} spans {files_in_trace} hub files, "
            "expected 7 (router + 2 hosts + 4 workers)"
        )
    if len(links) != 6:
        failures.append(
            f"fleet: {len(links)} cross-hub parent links, expected 6"
        )
    for path, rparent in links:
        if rparent not in gids:
            failures.append(
                f"fleet: {os.path.basename(path)} rparent {rparent} "
                "resolves to no span gid in the merged trace"
            )
    merged_path = info.get("merged_path") or ""
    if not os.path.exists(merged_path):
        failures.append(f"fleet: missing merged trace {merged_path}")
    else:
        with open(merged_path) as f:
            try:
                merged = json.load(f)
            except json.JSONDecodeError as e:
                failures.append(f"fleet: merged trace unparseable: {e}")
                merged = None
        if merged is not None:
            if not isinstance(merged, list) or not merged:
                failures.append("fleet: merged trace not a non-empty array")
            else:
                for i, ev in enumerate(merged):
                    missing = [
                        k for k in ("name", "ph", "ts", "pid", "tid")
                        if not isinstance(ev, dict) or k not in ev
                    ]
                    if missing:
                        failures.append(
                            f"fleet: merged[{i}] missing {missing} — "
                            "not Perfetto-loadable"
                        )
                        break

    # -- aggregated exposition ---------------------------------------------
    prom = info.get("fleet_prom_text")
    if not prom:
        failures.append("fleet: /metrics returned no body")
    else:
        try:
            parsed = parse_prometheus_text(prom)
        except ValueError as e:
            failures.append(f"fleet: /metrics exposition unparseable: {e}")
            parsed = {}
        if parsed.get(("fleet_hosts_count", "")) != 2.0:
            failures.append("fleet: /metrics fleet_hosts_count != 2")
        for hid in ("host-0", "host-1"):
            key = ("serving_request_latency_seconds_count",
                   f'{{host="{hid}"}}')
            if key not in parsed:
                failures.append(
                    "fleet: /metrics lacks host-labeled latency count "
                    f"for {hid}"
                )
        if ("serving_request_latency_seconds_count", "") not in parsed:
            failures.append(
                "fleet: /metrics lacks the fleet-wide latency fold"
            )
        if not any(
            name.startswith("serving_stage_") and name.endswith("_count")
            for name, _ in parsed
        ):
            failures.append(
                "fleet: /metrics lacks serving_stage_* decomposition "
                "families"
            )
        if parsed.get(("fleet_scrape_failures_total", ""), 0.0) < 2.0:
            failures.append(
                "fleet: fleet_scrape_failures_total < 2 after the "
                "scripted 2-host scrape fault"
            )
        if parsed.get(("slo_burn_alerts_total", ""), 0.0) < 1.0:
            failures.append("fleet: slo_burn_alerts_total never fired")

    # -- burn alert --------------------------------------------------------
    report = info.get("burn_report") or {}
    policies = report.get("policies") or []
    if not policies:
        failures.append("fleet: burn report carries no policies")
    else:
        pol = policies[0]
        if not pol.get("alerting"):
            failures.append(
                "fleet: burn alert did not fire under injected latency: "
                f"{pol}"
            )
        if pol.get("fast", {}).get("burn", 0.0) < 1.0:
            failures.append(
                f"fleet: fast-window burn below threshold: {pol.get('fast')}"
            )
    slo_body = info.get("fleet_slo_body")
    if not slo_body:
        failures.append("fleet: /slo returned no body")
    else:
        try:
            slo = json.loads(slo_body)
        except json.JSONDecodeError as e:
            failures.append(f"fleet: /slo not JSON: {e}")
            slo = {}
        for hid, entry in (slo.get("hosts") or {}).items():
            identity = entry.get("identity") or {}
            if identity.get("host_id") != hid:
                failures.append(
                    f"fleet: /slo host {hid} identity block says "
                    f"{identity.get('host_id')!r}"
                )
    fr_path = os.path.join(fleet_dir, "flightrecorder.json")
    if not os.path.exists(fr_path):
        failures.append(
            f"fleet: burn alert left no flight-recorder dump at {fr_path}"
        )
    else:
        with open(fr_path) as f:
            try:
                dump = json.load(f)
            except json.JSONDecodeError as e:
                failures.append(f"fleet: flight dump unparseable: {e}")
                dump = {}
        if not str(dump.get("reason") or "").startswith("slo.burn"):
            failures.append(
                f"fleet: flight dump reason {dump.get('reason')!r} does "
                "not name the burn"
            )

    # -- scrape degradation: fail soft, recover --------------------------
    faulted = (info.get("faulted_report") or {}).get("hosts") or {}
    for hid, entry in faulted.items():
        if entry.get("failures", 0) < 1:
            failures.append(
                f"fleet: host {hid} shows no scrape failure under the "
                "chaos plan"
            )
    recovered = (info.get("recovered_report") or {}).get("hosts") or {}
    if not recovered:
        failures.append("fleet: poll loop wedged after the scrape fault")
    for hid, entry in recovered.items():
        if entry.get("stale"):
            failures.append(
                f"fleet: host {hid} still stale after the fault cleared"
            )
    events_path = os.path.join(fleet_dir, "events.jsonl")
    names = set()
    if os.path.exists(events_path):
        with open(events_path) as f:
            for line in f:
                try:
                    names.add(json.loads(line).get("name"))
                except json.JSONDecodeError:
                    pass
    for needed in ("slo.burn", "fleet.scrape_stale",
                   "fleet.scrape_recovered"):
        if needed not in names:
            failures.append(
                f"fleet: router events.jsonl lacks the {needed} event"
            )
    return failures


def _run_and_validate(out_dir: str) -> list[str]:
    """Both passes; each prints its verdict and host seconds on a line
    of its own (``telemetry selfcheck pass <name>: PASS|FAIL <s> s``)."""
    failures: list[str] = []
    t0 = time.perf_counter()
    info = _build_synthetic_run(out_dir)
    found = validate_outputs(out_dir, info["snapshot"])
    found.extend(validate_ops_plane(out_dir, info))
    _report_pass("sinks_ops_plane", found, time.perf_counter() - t0)
    failures.extend(found)
    t0 = time.perf_counter()
    fleet_info = _build_fleet_run(out_dir)
    found = validate_fleet(out_dir, fleet_info)
    _report_pass("fleet", found, time.perf_counter() - t0)
    failures.extend(found)
    return failures


def _report_pass(name: str, found: list, seconds: float) -> None:
    print(f"telemetry selfcheck pass {name}: "
          f"{'FAIL' if found else 'PASS'} {seconds:.3f} s", flush=True)


def selfcheck(keep_dir: str | None = None) -> int:
    if keep_dir is not None:
        os.makedirs(keep_dir, exist_ok=True)
        out_dir = keep_dir
        failures = _run_and_validate(out_dir)
    else:
        with tempfile.TemporaryDirectory() as td:
            out_dir = td
            failures = _run_and_validate(out_dir)
    if failures:
        for f in failures:
            print(f"telemetry selfcheck FAIL: {f}", file=sys.stderr)
        return 1
    print(
        "telemetry selfcheck OK: events.jsonl + trace.json + metrics.json "
        "+ metrics_ts.jsonl + /metrics exposition + flightrecorder.json "
        "+ fleet pass (stitched 2-host trace, aggregated /metrics, SLO "
        f"burn alert, scrape degradation) valid ({out_dir})"
    )
    return 0


def lint_metrics() -> int:
    from photon_ml_tpu_torch.telemetry.lint import lint_source

    n_names, problems = lint_source()
    if problems:
        for p_ in problems:
            print(f"metric lint FAIL: {p_}", file=sys.stderr)
        return 1
    print(
        f"metric lint OK: {n_names} metric names conform "
        "(<subsystem>_<name>_<unit>, one kind per name)"
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m photon_ml_tpu_torch.telemetry")
    p.add_argument(
        "--selfcheck", action="store_true",
        help="emit a synthetic span tree through every sink + the live "
        "ops plane (time-series sampler, /metrics exporter, chaos-fault "
        "flight recorder) and validate every output",
    )
    p.add_argument(
        "--lint-metrics", action="store_true",
        help="scan the port's source for metric registrations and "
        "enforce the naming convention + one-kind-per-name",
    )
    p.add_argument(
        "--keep-dir",
        help="with --selfcheck: write the outputs here (inspectable) "
        "instead of a throwaway tempdir",
    )
    args = p.parse_args(argv)
    if args.lint_metrics:
        return lint_metrics()
    if args.selfcheck:
        return selfcheck(args.keep_dir)
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
