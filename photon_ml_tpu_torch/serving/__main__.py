"""Serving CLI: selfcheck, HTTP server, and the built-in load generator
(port of ``photon_ml_tpu/serving/__main__.py``, the in-process passes).

Selfcheck::

    python -m photon_ml_tpu_torch.serving --selfcheck --device cpu

builds a synthetic GAME model, warms the bucket ladder, serves CONCURRENT
requests through the real HTTP endpoint, and verifies:

- every batched score is BIT-IDENTICAL to single-request scoring
  (the padded-bucket kernel's parity contract);
- the telemetry snapshot carries request-latency histograms and a
  nonzero batch-occupancy gauge;
- /healthz and /stats answer.

A second, tenancy pass replays the ``noisy_neighbor`` scenario against a
two-tenant policy on one service: an aggressor tenant bursting to ~10x
its token-bucket quota is shed alone while the victim tenant's p99 stays
inside its SLO with zero failures, and the per-tenant
``serving_tenant_<t>_*`` metric family records both sides.

Process mode (``--selfcheck --workers 2``) runs the process pass
instead: crash-isolated worker processes on one shared-memory model
publication, bitwise parity with in-process scoring, zero failed
requests through a real SIGKILL under open-loop load, a cross-process
hot swap and rollback, and a leak-free shutdown.

``--replicas N`` serves N supervised in-process replicas, ``--workers N``
N worker processes, and ``--shm-ingress`` adds the same-machine
shared-memory ingress ring beside HTTP.  ``--metrics-port`` mounts the
live ops plane (``/metrics``, ``/snapshot``, ``/healthz``, and ``/readyz``
on the service's readiness) and ``--metrics-interval-s`` paces the
``metrics_ts.jsonl`` sampler when ``--output-dir`` is set.
``--tenant-report metrics_ts.jsonl ...`` prints per-tenant accounting
(rps, shed, latency percentiles) from the ``serving_tenant_*`` family of
recorded time series and exits.  ``--membership REGISTRY_URL``
registers the server with a cluster membership registry
(``photon_ml_tpu_torch.cluster``) and heartbeats until shutdown, when it
drains and leaves; ``--fleet-join URL`` / ``--fleet-drain HOST_ID`` are
one-shot admin verbs against that registry.

Serve a saved model (on the card unless ``--device cpu``)::

    python -m photon_ml_tpu_torch.serving --model-dir /tmp/game_out/models \\
        --port 8080

Load-generate against an in-process service (no HTTP overhead)::

    python -m photon_ml_tpu_torch.serving --synthetic 50000 \\
        --loadgen closed --clients 16 --duration 5
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import threading
import urllib.request

def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.serving",
        description="online GAME/GLM scoring service",
    )
    p.add_argument("--selfcheck", action="store_true")
    p.add_argument(
        "--model-dir",
        help="saved GAME model directory (or a GLM .avro file)",
    )
    p.add_argument(
        "--synthetic", type=int, metavar="N_ENTITIES", default=0,
        help="serve a synthetic GAME model with this many random-effect "
        "entities instead of --model-dir",
    )
    p.add_argument(
        "--device", default=None,
        help="cuda (default: the card, raises without one) or cpu",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch-size", type=int, default=64)
    p.add_argument(
        "--max-wait-us", type=int, default=2000,
        help="how long the dispatcher holds the first request open for "
        "coalescing",
    )
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument(
        "--adaptive-wait", action="store_true",
        help="size the coalescing wait from the arrival-rate EWMA "
        "instead of always paying --max-wait-us (which becomes the "
        "ceiling)",
    )
    p.add_argument(
        "--hot-entities", type=int, default=1024,
        help="per-coordinate LRU hot-set capacity (device-resident rows)",
    )
    p.add_argument(
        "--shm-ingress", metavar="NAME", nargs="?", const="", default=None,
        help="also serve same-machine clients over a shared-memory "
        "ingress ring (skips HTTP entirely); optional segment NAME, "
        "auto-generated when omitted",
    )
    p.add_argument(
        "--replicas", type=int, default=1,
        help="run this many supervised scoring replicas behind the "
        "listener (>1 enables the HA path: health probes, automatic "
        "restarts, request resubmission)",
    )
    p.add_argument(
        "--workers", type=int, default=0,
        help="score in this many crash-isolated worker PROCESSES "
        "attached to one shared-memory model publication instead of "
        "in-process replica threads; with --selfcheck, runs the "
        "process-mode pass instead of the in-process passes",
    )
    p.add_argument(
        "--timeout-ms", type=float, default=None,
        help="default per-request deadline (None = no deadline)",
    )
    p.add_argument(
        "--loadgen", choices=["closed", "open"],
        help="run the built-in load generator against the service, print "
        "a JSON report, and exit",
    )
    p.add_argument("--clients", type=int, default=8, help="closed-loop")
    p.add_argument("--rate", type=float, default=200.0, help="open-loop rps")
    p.add_argument("--duration", type=float, default=5.0, help="seconds")
    p.add_argument(
        "--output-dir",
        help="telemetry output dir (selfcheck defaults to a tempdir)",
    )
    p.add_argument("--telemetry", choices=["on", "off"], default="on")
    p.add_argument(
        "--metrics-port", type=int, default=None,
        help="expose the live ops plane on this port (/metrics "
        "Prometheus exposition, /snapshot JSON, /healthz); 0 binds an "
        "ephemeral port; omit to disable",
    )
    p.add_argument(
        "--metrics-interval-s", type=float, default=1.0,
        help="metrics_ts.jsonl sampling interval when --output-dir is "
        "set (0 disables the time series)",
    )
    p.add_argument(
        "--tenant-report", metavar="METRICS_TS_JSONL", nargs="+",
        help="summarize per-tenant rps/shed/p99 from one or more "
        "metrics_ts.jsonl files (the serving_tenant_* family) as JSON "
        "and exit; several files — one per host — merge into per-host "
        "sections plus a fleet-wide fold",
    )
    p.add_argument(
        "--membership", metavar="REGISTRY_URL", default=None,
        help="register this server with a cluster membership registry "
        "(photon_ml_tpu_torch.cluster) and heartbeat for the lifetime of "
        "the process; drained and removed on shutdown",
    )
    p.add_argument(
        "--host-id", default=None,
        help="membership host id (default: host:port of the listener)",
    )
    p.add_argument(
        "--fleet-join", metavar="SERVING_URL", default=None,
        help="one-shot admin verb: register SERVING_URL with the "
        "--membership registry and exit; the MembershipWatcher joins "
        "it into the live rotation",
    )
    p.add_argument(
        "--fleet-drain", metavar="HOST_ID", default=None,
        help="one-shot admin verb: mark HOST_ID draining in the "
        "--membership registry and exit; the watcher drains it from "
        "the router once converged",
    )
    return p


def _make_service(args):
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.service import ScoringService

    rt_cfg = RuntimeConfig(
        max_batch_size=args.max_batch_size, hot_entities=args.hot_entities,
        device=args.device,
    )
    if args.synthetic:
        from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

        workload = SyntheticWorkload(n_entities=args.synthetic)

        def factory() -> ScoringRuntime:
            return ScoringRuntime(
                workload.model, workload.index_maps, rt_cfg
            )
    elif args.model_dir:
        workload = None

        def factory() -> ScoringRuntime:
            return ScoringRuntime.load(args.model_dir, rt_cfg)
    else:
        raise SystemExit(
            "one of --selfcheck / --model-dir / --synthetic is required"
        )
    batcher_cfg = BatcherConfig(
        max_batch_size=args.max_batch_size,
        max_wait_us=args.max_wait_us,
        max_queue=args.max_queue,
        default_timeout_ms=args.timeout_ms,
        adaptive_wait=args.adaptive_wait,
    )
    if args.workers:
        from photon_ml_tpu_torch.serving.procpool import WorkerPool
        from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor

        if workload is not None:
            model, index_maps, path = (
                workload.model, workload.index_maps, None
            )
        else:
            # The parent keeps a host copy to publish; the workers
            # score on the device.
            model, index_maps = ScoringRuntime.load_model(
                args.model_dir, device="cpu"
            )
            path = args.model_dir
        pool = WorkerPool(
            model, index_maps, runtime_config=rt_cfg, model_path=path
        )
        unit = ReplicaSupervisor(pool=pool, n_replicas=args.workers)
    elif args.replicas > 1:
        from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor

        unit = ReplicaSupervisor(factory, n_replicas=args.replicas)
    else:
        unit = factory()
    return ScoringService(unit, batcher_cfg), workload


# ---------------------------------------------------------------------------
# Selfcheck
# ---------------------------------------------------------------------------

def run_selfcheck(out_dir: str, device=None) -> list[str]:
    """Returns failure strings (empty = pass)."""
    import numpy as np

    from photon_ml_tpu_torch import telemetry as telemetry_mod
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.service import (
        ScoringService,
        start_http_server,
    )
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

    failures: list[str] = []
    n_requests = 24
    with telemetry_mod.Telemetry(
        output_dir=out_dir, run_name="serving-selfcheck"
    ) as tel:
        with tel.span("selfcheck", subsystem="serving"):
            # Small hot set (< entities) so BOTH the device hot-table path
            # and the host cold-gather path serve real traffic.
            workload = SyntheticWorkload(n_entities=64, seed=3)
            runtime = ScoringRuntime(
                workload.model, workload.index_maps,
                RuntimeConfig(max_batch_size=8, hot_entities=16,
                              device=device),
            )
            requests = [workload.request(i) for i in range(n_requests)]
            rows = [runtime.parse_request(r) for r in requests]

            # Single-request reference: every row alone through bucket 1.
            reference = np.asarray(
                [runtime.score_rows([row])[0][0] for row in rows],
                np.float32,
            )

            service = ScoringService(runtime, BatcherConfig(
                max_batch_size=8, max_wait_us=20_000, max_queue=64,
            ))
            with service:
                server, _ = start_http_server(service, port=0)
                port = server.server_address[1]
                try:
                    # Concurrent clients through the REAL HTTP endpoint,
                    # 6 rows per POST, 4 posts in flight.
                    got: dict[int, list] = {}
                    errs: list[str] = []

                    def client(t: int) -> None:
                        chunk = requests[t * 6:(t + 1) * 6]
                        body = json.dumps({"rows": chunk}).encode()
                        req = urllib.request.Request(
                            f"http://127.0.0.1:{port}/score",
                            data=body,
                            headers={"Content-Type": "application/json"},
                        )
                        try:
                            with urllib.request.urlopen(
                                req, timeout=30
                            ) as resp:
                                got[t] = json.loads(resp.read())["results"]
                        except Exception as exc:  # noqa: BLE001
                            errs.append(f"client {t}: {exc}")

                    threads = [
                        threading.Thread(
                            target=client, args=(t,), daemon=True
                        )
                        for t in range(4)
                    ]
                    try:
                        for t in threads:
                            t.start()
                    finally:
                        for t in threads:
                            t.join()
                    failures.extend(errs)

                    served = np.zeros(n_requests, np.float32)
                    for t, results in got.items():
                        for j, r in enumerate(results):
                            if "error" in r:
                                failures.append(
                                    f"row {t * 6 + j} failed: {r}"
                                )
                            else:
                                served[t * 6 + j] = np.float32(r["score"])
                    if not failures and served.tobytes() != \
                            reference.tobytes():
                        bad = int(np.argmax(served != reference))
                        failures.append(
                            "batched scores are NOT bit-identical to "
                            f"single-request scoring (first diff row "
                            f"{bad}: {served[bad]!r} vs "
                            f"{reference[bad]!r})"
                        )

                    # /healthz and /stats answer.
                    for route in ("/healthz", "/stats"):
                        with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{route}", timeout=10
                        ) as resp:
                            if resp.status != 200:
                                failures.append(
                                    f"{route} -> HTTP {resp.status}"
                                )
                            json.loads(resp.read())
                finally:
                    server.shutdown()
                    server.server_close()

        snap = tel.snapshot()
    # Snapshot content: request-latency histogram + nonzero occupancy.
    hist = snap["histograms"].get("serving_request_latency_seconds", {})
    if not hist.get("count"):
        failures.append(
            "metrics snapshot has no serving_request_latency_seconds "
            "histogram observations"
        )
    occupancy = snap["gauges"].get("serving_batch_occupancy")
    if not occupancy:
        failures.append(
            f"serving_batch_occupancy gauge is {occupancy!r}, expected "
            "nonzero"
        )
    metrics_path = os.path.join(out_dir, "metrics.json")
    if not os.path.exists(metrics_path):
        failures.append(f"missing {metrics_path}")
    else:
        with open(metrics_path) as f:
            on_disk = json.load(f)
        if "serving_request_latency_seconds" not in on_disk.get(
            "histograms", {}
        ):
            failures.append(
                "metrics.json lacks the request-latency histogram"
            )
    if not failures:
        hot = runtime.stats()["hot_sets"]["per_entity"]
        print(
            f"serving selfcheck ({runtime.device}): {n_requests} rows "
            f"bit-identical over {runtime.batches - n_requests} coalesced "
            f"batches (buckets {runtime.buckets}, hot hits {hot['hits']}, "
            f"cold misses {hot['misses']}, mean latency "
            f"{1e3 * hist['sum'] / hist['count']:.2f} ms), "
            f"occupancy gauge {occupancy:.3f}"
        )
    return failures


def run_selfcheck_process(
    out_dir: str, n_workers: int = 2, device=None
) -> list[str]:
    """Process-mode pass: crash-isolated worker processes on a shared
    model.  Verifies score parity with in-process scoring, zero failed
    requests through a real SIGKILL under open-loop load, a
    cross-process hot swap + rollback (bit-identical on both sides),
    single-publication segment accounting, and a leak-free shutdown.
    Returns failure strings (empty = pass)."""
    import time

    import numpy as np

    from photon_ml_tpu_torch import telemetry as telemetry_mod
    from photon_ml_tpu_torch.analysis.sanitizers import ProcessLeakSentinel
    from photon_ml_tpu_torch.io.game_store import save_game_model
    from photon_ml_tpu_torch.serving import loadgen, shm_model
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.procpool import WorkerPool
    from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
    from photon_ml_tpu_torch.serving.service import ScoringService
    from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

    failures: list[str] = []
    n_requests = 24
    v1 = SyntheticWorkload(n_entities=64, seed=3)
    v2 = SyntheticWorkload(n_entities=64, seed=4)
    v2_dir = os.path.join(out_dir, "models", "v2")
    save_game_model(v2.model, v2.index_maps, v2_dir)
    rt_cfg = RuntimeConfig(max_batch_size=8, hot_entities=16, device=device)
    requests = [v1.request(i) for i in range(n_requests)]

    def reference(w: SyntheticWorkload) -> np.ndarray:
        rt = ScoringRuntime(w.model, w.index_maps, rt_cfg)
        return np.asarray(
            [
                rt.score_rows([rt.parse_request(r)])[0][0]
                for r in requests
            ],
            np.float32,
        )

    ref_v1, ref_v2 = reference(v1), reference(v2)

    def parity(tag: str, want: np.ndarray) -> None:
        futs = [service.submit(r) for r in requests]
        got = np.asarray(
            [np.float32(f.result(timeout=60)["score"]) for f in futs],
            np.float32,
        )
        if got.tobytes() != want.tobytes():
            bad = int(np.argmax(got != want))
            failures.append(
                f"{tag}: worker scores are NOT bit-identical to "
                f"in-process scoring (first diff row {bad}: "
                f"{got[bad]!r} vs {want[bad]!r})"
            )

    def await_healthy(what: str, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        while (
            supervisor.healthy_count < n_workers
            and time.monotonic() < deadline
        ):
            time.sleep(0.05)
        if supervisor.healthy_count < n_workers:
            failures.append(
                f"{what}: only {supervisor.healthy_count}/{n_workers} "
                f"workers healthy after {timeout_s:.0f} s"
            )

    with telemetry_mod.Telemetry(
        output_dir=out_dir, run_name="serving-selfcheck-proc"
    ) as tel:
        with ProcessLeakSentinel(grace_s=15.0, strict=True):
            pool = WorkerPool(
                v1.model, v1.index_maps, runtime_config=rt_cfg, version=1
            )
            supervisor = ReplicaSupervisor(
                pool=pool, n_replicas=n_workers, probe_interval_s=0.1
            )
            service = ScoringService(supervisor, BatcherConfig(
                max_batch_size=8, max_wait_us=2_000, max_queue=256,
            ))
            with service:
                parity("v1", ref_v1)

                # One publication, N attachments: the parent-side gauge
                # counts mapped bytes ONCE however many workers attach.
                published = sum(
                    seg["nbytes"]
                    for seg in pool.manifest["segments"].values()
                )
                mapped = tel.snapshot()["gauges"].get(
                    "serving_shared_segment_bytes", 0
                )
                if mapped != published:
                    failures.append(
                        "serving_shared_segment_bytes = "
                        f"{mapped}, expected exactly one publication "
                        f"({published} bytes) for {n_workers} workers"
                    )

                # Real SIGKILL mid-load: a burst straight into the dying
                # worker's queue plus an open loop across the kill, zero
                # failed requests end to end.  The worker is paused
                # first, so the rows routed to it (every other one) are
                # still in flight when the kill lands, however late this
                # thread reaches it: otherwise a worker that finished its
                # share first left nothing to resubmit.
                def script() -> None:
                    try:
                        time.sleep(0.4)
                        supervisor.replicas[0].batcher.pause()
                        burst = [
                            service.submit(v1.request(50_000 + j))
                            for j in range(64)
                        ]
                        supervisor.kill_replica(0)
                        for bf in burst:
                            try:
                                bf.result(timeout=60)
                            except Exception as exc:  # noqa: BLE001
                                failures.append(
                                    "burst request failed after worker "
                                    f"SIGKILL: {exc!r}"
                                )
                                break
                        await_healthy("post-SIGKILL respawn")
                    except Exception as exc:  # noqa: BLE001
                        failures.append(
                            f"process script failed: {exc!r}"
                        )

                script_thread = threading.Thread(
                    target=script, daemon=True
                )
                script_thread.start()
                report = loadgen.open_loop(
                    service.submit, v1.request,
                    rate_rps=120.0, duration_s=4.0,
                )
                script_thread.join(timeout=60)
                if report.errors or report.rejected:
                    failures.append(
                        f"process load saw {report.errors} errors and "
                        f"{report.rejected} rejections (expected 0/0) "
                        f"across {report.completed} requests"
                    )
                if report.completed < 100:
                    failures.append(
                        f"process load completed only {report.completed}"
                        " requests; the pass did not exercise the path"
                    )

                # Cross-process hot swap, then an operator rollback with
                # a worker killed in between (the respawned worker has
                # no retained previous; rollback must still converge).
                swapped = service.reload(v2_dir)
                if swapped.status != "swapped":
                    failures.append(f"process swap v2 -> {swapped}")
                parity("post-swap v2", ref_v2)
                if service.swapper.version != 2:
                    failures.append(
                        "expected model_version 2 after swap, got "
                        f"{service.swapper.version}"
                    )
                supervisor.kill_replica(1, "post-swap kill")
                await_healthy("post-swap respawn")
                rolled = service.swapper.rollback()
                if rolled.status != "rolled_back":
                    failures.append(f"process rollback -> {rolled}")
                await_healthy("rollback convergence")
                parity("post-rollback v1", ref_v1)
            leftover = shm_model.live_segments()
            if leftover:
                failures.append(
                    "shared segments still mapped after shutdown: "
                    f"{leftover}"
                )
        snap = tel.snapshot()

    counters = snap["counters"]
    for name, minimum in (
        ("serving_replica_restarts_total", 2),
        ("serving_resubmitted_total", 1),
        ("serving_swaps_total", 1),
        ("serving_rollbacks_total", 1),
    ):
        if counters.get(name, 0) < minimum:
            failures.append(
                f"{name} = {counters.get(name, 0)}, expected >= {minimum}"
            )
    if not failures:
        print(
            f"serving process selfcheck: {n_workers} worker processes, "
            f"{n_requests}-row parity x3 (v1, swapped v2, rolled-back "
            "v1) bit-identical, SIGKILL under 120 rps with 0 failed "
            "requests "
            f"({report.completed} completed, restarts "
            f"{counters.get('serving_replica_restarts_total')}, "
            f"resubmitted "
            f"{counters.get('serving_resubmitted_total')}), shared "
            f"segments {published} bytes mapped once, shutdown "
            "leak-free"
        )
    return failures


def run_selfcheck_tenancy(out_dir: str, device=None) -> list[str]:
    """Two-tenant noisy-neighbor pass on one service: an aggressor
    tenant bursts to ~10x its quota while a victim tenant holds steady;
    the tenancy layer must shed the aggressor alone — victim p99 inside
    its SLO with ZERO failed requests — and the per-tenant metric family
    must record both sides.  Returns failure strings (empty = pass)."""
    from photon_ml_tpu_torch import telemetry as telemetry_mod
    from photon_ml_tpu_torch.serving import loadgen
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.service import ScoringService
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
    from photon_ml_tpu_torch.serving.tenancy import TenancyConfig, TenantSpec

    failures: list[str] = []
    victim_slo_ms = 500.0
    aggressor_quota = 40.0
    workload = SyntheticWorkload(n_entities=64, seed=3)
    rt_cfg = RuntimeConfig(max_batch_size=8, hot_entities=16, device=device)
    tenancy = TenancyConfig(tenants=(
        TenantSpec(
            name="victim", max_queue=128, p99_slo_ms=victim_slo_ms,
        ),
        TenantSpec(
            name="aggressor", quota_rps=aggressor_quota,
            burst=max(aggressor_quota / 2.0, 1.0), max_queue=64,
        ),
    ))
    batcher_cfg = BatcherConfig(
        max_batch_size=8, max_wait_us=2_000, max_queue=256,
        tenancy=tenancy,
    )

    def make_request(i: int, phase, tenant: str) -> dict:
        obj = dict(workload.request(i))
        obj["tenant"] = tenant
        return obj

    with telemetry_mod.Telemetry(
        output_dir=out_dir, run_name="serving-selfcheck-tenancy"
    ) as tel:
        runtime = ScoringRuntime(workload.model, workload.index_maps, rt_cfg)
        service = ScoringService(runtime, batcher_cfg)
        with service:
            report = loadgen.run_noisy_neighbor(
                service.submit, make_request,
                victim_rate_rps=40.0, aggressor_rate_rps=40.0,
            )
        snap = tel.snapshot()

    gate = report.isolation(victim_slo_ms)
    if not gate["pass"]:
        failures.append(f"noisy-neighbor isolation gate FAILED: {gate}")
    counters = snap["counters"]
    if counters.get("serving_tenant_victim_requests_total", 0) < \
            report.victim.completed:
        failures.append(
            "serving_tenant_victim_requests_total = "
            f"{counters.get('serving_tenant_victim_requests_total', 0)}, "
            f"expected >= {report.victim.completed}"
        )
    if counters.get("serving_tenant_aggressor_shed_total", 0) < 1:
        failures.append(
            "serving_tenant_aggressor_shed_total = "
            f"{counters.get('serving_tenant_aggressor_shed_total', 0)}, "
            "expected >= 1 (the burst never pressured the quota)"
        )
    victim_hist = snap["histograms"].get(
        "serving_tenant_victim_request_latency_seconds", {}
    )
    if not victim_hist.get("count"):
        failures.append(
            "no serving_tenant_victim_request_latency_seconds "
            "observations — the per-tenant latency family is dark"
        )
    if not failures:
        print(
            f"serving tenancy selfcheck: aggressor burst 10x quota shed "
            f"{report.aggressor.shed} of its requests while victim "
            f"completed {report.victim.completed} with 0 failures, p99 "
            f"{gate['victim_p99_ms']} ms <= SLO {victim_slo_ms:g} ms"
        )
    return failures


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def tenant_report(ts_path: str) -> dict:
    """Summarize the ``serving_tenant_*`` family from a metrics_ts.jsonl
    into per-tenant accounting: request rate, shed/rejected totals, and
    latency percentiles (the reference's, byte for byte).

    Rates are counter deltas over the sampled ``t_mono`` span; p50/p99
    come from the LAST record's latency-histogram summary (cumulative
    over the run).  Returns the JSON-able report dict."""
    from photon_ml_tpu_torch.telemetry.timeseries import read_series

    records = read_series(ts_path)
    if not records:
        raise ValueError(f"no time-series records in {ts_path}")
    first, last = records[0], records[-1]
    span_s = max(float(last["t_mono"]) - float(first["t_mono"]), 1e-9)
    slug_re = re.compile(
        r"^serving_tenant_([a-z0-9_]+?)_requests_total$"
    )
    tenants = sorted(
        m.group(1)
        for name in last.get("counters", {})
        for m in [slug_re.match(name)]
        if m is not None
    )

    def delta(name: str) -> float:
        return float(last["counters"].get(name, 0)) - float(
            first["counters"].get(name, 0)
        )

    report = {
        "path": ts_path,
        "span_seconds": round(span_s, 3),
        "records": len(records),
        "tenants": {},
    }
    for slug in tenants:
        prefix = f"serving_tenant_{slug}_"
        hist = last.get("histograms", {}).get(
            prefix + "request_latency_seconds"
        ) or {}
        requests = delta(prefix + "requests_total")
        shed = delta(prefix + "shed_total")
        report["tenants"][slug] = {
            "requests": int(requests),
            "rps": round(requests / span_s, 2),
            "shed": int(shed),
            "shed_rps": round(shed / span_s, 2),
            "rejected": int(delta(prefix + "rejected_total")),
            "completed": int(hist.get("count") or 0),
            "latency_p50_ms": (
                None if hist.get("p50") is None
                else round(hist["p50"] * 1e3, 3)
            ),
            "latency_p99_ms": (
                None if hist.get("p99") is None
                else round(hist["p99"] * 1e3, 3)
            ),
        }
    return report


def tenant_report_multi(ts_paths) -> dict:
    """Fleet-grain tenant accounting: one :func:`tenant_report` per
    metrics_ts.jsonl (one file per host), keyed by the host identity the
    sampler recorded (falling back to the file name when two hosts
    collide or a file carries none), plus a fleet-wide fold —
    additive columns sum, latency percentiles report the WORST host
    (the number a fleet SLO is judged on).  A single path keeps the
    original single-host report shape."""
    paths = list(ts_paths)
    if len(paths) == 1:
        return tenant_report(paths[0])
    from photon_ml_tpu_torch.telemetry.timeseries import read_series

    hosts: dict = {}
    for path in paths:
        rep = tenant_report(path)
        records = read_series(path)
        host_id = None
        for rec in reversed(records):
            identity = rec.get("host")
            if isinstance(identity, dict) and identity.get("host_id"):
                host_id = str(identity["host_id"])
                break
        key = host_id or os.path.basename(os.path.dirname(path)) or path
        if key in hosts:
            key = f"{key}:{path}"
        hosts[key] = rep

    fleet: dict = {}
    for rep in hosts.values():
        for slug, row in rep["tenants"].items():
            agg = fleet.setdefault(slug, {
                "requests": 0, "rps": 0.0, "shed": 0, "shed_rps": 0.0,
                "rejected": 0, "completed": 0, "hosts": 0,
                "latency_p50_ms": None, "latency_p99_ms": None,
            })
            agg["hosts"] += 1
            for col in ("requests", "shed", "rejected", "completed"):
                agg[col] += row[col]
            for col in ("rps", "shed_rps"):
                agg[col] = round(agg[col] + row[col], 2)
            for col in ("latency_p50_ms", "latency_p99_ms"):
                if row[col] is not None:
                    agg[col] = (
                        row[col] if agg[col] is None
                        else max(agg[col], row[col])
                    )
    return {
        "hosts": hosts,
        "fleet": {"tenants": fleet},
    }


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    if args.tenant_report:
        try:
            report = tenant_report_multi(args.tenant_report)
        except (OSError, ValueError) as exc:
            print(f"tenant report failed: {exc}", file=sys.stderr)
            return 1
        print(json.dumps(report, indent=2))
        return 0

    if args.fleet_join or args.fleet_drain:
        # Admin verbs against the discovery plane: membership is the
        # source of truth, the MembershipWatcher converges the router.
        if not args.membership:
            print(
                "--fleet-join / --fleet-drain need --membership "
                "REGISTRY_URL (the registry is the source of truth; "
                "the watcher converges the router)",
                file=sys.stderr,
            )
            return 2
        from photon_ml_tpu_torch.cluster import RegistryClient

        client = RegistryClient(args.membership)
        if args.fleet_join:
            url = args.fleet_join.rstrip("/")
            hid = args.host_id or url.split("//", 1)[-1]
            member = client.register(hid, url)
            print(json.dumps({"joined": member}, indent=2))
        if args.fleet_drain:
            ok = client.drain(args.fleet_drain)
            print(json.dumps(
                {"drained": bool(ok), "host_id": args.fleet_drain},
                indent=2,
            ))
            if not ok:
                print(
                    f"host id {args.fleet_drain!r} is not a member",
                    file=sys.stderr,
                )
                return 1
        return 0

    if args.selfcheck:
        def process(root: str) -> list[str]:
            return run_selfcheck_process(root, args.workers, args.device)

        def both(root: str) -> list[str]:
            # Separate output dirs: each pass owns its Telemetry hub and
            # its metrics.json.
            single = os.path.join(root, "single")
            tenancy = os.path.join(root, "tenancy")
            os.makedirs(single, exist_ok=True)
            os.makedirs(tenancy, exist_ok=True)
            return (run_selfcheck(single, args.device)
                    + run_selfcheck_tenancy(tenancy, args.device))

        passes = process if args.workers else both
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            failures = passes(args.output_dir)
        else:
            with tempfile.TemporaryDirectory(
                prefix="photon_serving_selfcheck_"
            ) as td:
                failures = passes(td)
        if failures:
            print("serving selfcheck FAILED:", file=sys.stderr)
            for f in failures:
                print(f"  - {f}", file=sys.stderr)
            return 1
        print("serving selfcheck PASSED")
        return 0

    from photon_ml_tpu_torch import telemetry as telemetry_mod

    tel = telemetry_mod.Telemetry(
        output_dir=args.output_dir,
        enabled=args.telemetry != "off",
        run_name="serving",
        sinks=None if args.output_dir else [],
    )
    with tel:
        service, workload = _make_service(args)
        plane_ctx = telemetry_mod.mount_ops_plane(
            tel, port=args.metrics_port,
            interval_s=args.metrics_interval_s,
            readiness=service.readiness,
        )
        with plane_ctx as plane:
            if plane.port is not None:
                print(
                    f"metrics on http://127.0.0.1:{plane.port} "
                    "(/metrics /snapshot /healthz /livez /readyz)",
                    flush=True,
                )
            return _run_service(args, service, workload)


def _run_service(args, service, workload) -> int:
    if args.loadgen:
        from photon_ml_tpu_torch.serving import loadgen

        if workload is None:
            from photon_ml_tpu_torch.serving.synthetic import (
                SyntheticWorkload,
            )

            workload = SyntheticWorkload(n_entities=10_000)
        with service:
            if args.loadgen == "closed":
                report = loadgen.closed_loop(
                    service.submit, workload.request,
                    clients=args.clients, duration_s=args.duration,
                )
            else:
                report = loadgen.open_loop(
                    service.submit, workload.request,
                    rate_rps=args.rate, duration_s=args.duration,
                )
        print(json.dumps({
            "loadgen": report.snapshot(),
            "stats": service.stats(),
        }, indent=2))
        return 0

    from photon_ml_tpu_torch.serving.service import start_http_server

    with service:
        server, thread = start_http_server(
            service, host=args.host, port=args.port
        )
        host, port = server.server_address[:2]
        ingress = None
        if args.shm_ingress is not None:
            from photon_ml_tpu_torch.serving.shm_ingress import ShmIngress

            ingress = ShmIngress(
                service, name=args.shm_ingress or None
            ).start()
            print(
                f"shm ingress ring {ingress.name!r} "
                f"({ingress.n_slots} slots x {ingress.slot_bytes} bytes)",
                flush=True,
            )
        agent = None
        if args.membership:
            from photon_ml_tpu_torch.cluster import HeartbeatAgent

            hid = args.host_id or f"{host}:{port}"
            agent = HeartbeatAgent(
                args.membership, hid, f"http://{host}:{port}"
            ).start()
            print(
                f"membership: {hid!r} registered with "
                f"{args.membership}, heartbeating every "
                f"{agent.interval_s:g}s",
                flush=True,
            )
        print(
            f"serving on http://{host}:{port} "
            f"(/score /reload /healthz /livez /readyz /stats); "
            "Ctrl-C to stop",
            flush=True,
        )
        try:
            thread.join()
        except KeyboardInterrupt:
            print("shutting down")
        finally:
            if agent is not None:
                # Graceful exit: drain first so the watcher finishes
                # in-flight work, then leave the member set outright.
                try:
                    agent.client.drain(agent.host_id)
                except Exception:  # noqa: BLE001 — expiry catches up
                    pass
                agent.stop(leave=True)
            if ingress is not None:
                ingress.stop()
            server.shutdown()
            server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
