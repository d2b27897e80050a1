"""A fleet router's burst onto one surviving host (the port's own probe).

    python -m photon_ml_tpu_torch.experiments.fleet_burst [--trials N]
        [--backlog B] [--device D]

Two ``LocalHost``s, each an HTTP service on its own runtime, stand behind
a ``FleetRouter`` with its default 16 workers and a 10 s probe interval.
A ``serving.host`` fault marks the first host it routes to down at the
fourth request, so the router's workers all turn to the other host at
once.  Each trial scores 256 requests of ``bench_serving``'s synthetic
model (50,000 entities, seed 9) and fails if any request fails or the
surviving host was marked down too.  ``--backlog`` overrides the HTTP
listen backlog (``service._Server.request_queue_size``): the stdlib's 5
lets the network stack reset the excess connections, and a reset marks
the healthy host down.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

from photon_ml_tpu_torch import chaos, telemetry
from photon_ml_tpu_torch.serving import service as service_mod
from photon_ml_tpu_torch.serving.batcher import BatcherConfig
from photon_ml_tpu_torch.serving.fleet import (
    FleetBudget,
    FleetRouter,
    LocalHost,
    QuotaCoordinator,
)
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from photon_ml_tpu_torch.serving.tenancy import TenancyConfig, TenantSpec

REQUESTS = 256


class _Router(FleetRouter):
    """Keeps every mark-down's reason: a reconnect probe clears it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.down_reasons = []

    def _mark_down(self, host, reason):
        self.down_reasons.append((host.hid, reason))
        super()._mark_down(host, reason)


def trial(bench, cfg, requests) -> dict:
    tenancy = TenancyConfig(tenants=(TenantSpec(name="acme"),))
    coord = QuotaCoordinator([FleetBudget("acme", 100_000.0)],
                             lease_ttl_s=5.0)
    hosts = [LocalHost(f"h{i}", service_mod.ScoringService(
        ScoringRuntime(bench.model, bench.index_maps, cfg), BatcherConfig(
            max_batch_size=cfg.max_batch_size, max_wait_us=1000,
            max_queue=1024, tenancy=tenancy))).start() for i in range(2)]
    router = _Router([h.base_url for h in hosts], probe_interval_s=10.0)
    try:
        for lc in [h.attach_lease_client(coord) for h in hosts] * 2:
            lc.poll_once()
        router.start()
        plan = chaos.FaultPlan([chaos.FaultSpec(site="serving.host", at=3)])
        failed = []
        t0 = time.perf_counter()
        with plan:
            for fut in [router.submit(r) for r in requests]:
                try:
                    fut.result(timeout=60)
                except Exception as exc:  # noqa: BLE001 — counted
                    failed.append(str(exc)[:120])
        return {"seconds": time.perf_counter() - t0, "failed": len(failed),
                "first_failure": failed[0] if failed else None,
                "down": router.down_reasons}
    finally:
        router.stop()
        for h in hosts:
            h.stop()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--backlog", type=int, default=None,
                   help="listen backlog of each host (default: the "
                   f"service's, {service_mod._Server.request_queue_size})")
    args = p.parse_args(argv)
    if args.backlog is not None:
        service_mod._Server.request_queue_size = args.backlog
    backlog = service_mod._Server.request_queue_size
    bench = SyntheticWorkload(n_entities=50_000, fixed_dim=64, re_dim=8,
                              seed=9)
    cfg = RuntimeConfig(max_batch_size=64, hot_entities=4096,
                        device=args.device)
    requests = [dict(bench.request(i), tenant="acme")
                for i in range(REQUESTS)]
    bad = 0
    with telemetry.Telemetry(sinks=[]):
        for i in range(args.trials):
            r = trial(bench, cfg, requests)
            ok = r["failed"] == 0 and len(r["down"]) == 1
            bad += not ok
            print(f"trial {i}: {'ok' if ok else 'FAILED'} in "
                  f"{r['seconds']:.3f} s; {r['failed']} of {REQUESTS} "
                  f"requests failed ({r['first_failure']}); mark-downs "
                  f"{r['down']}", flush=True)
    out = {"device": args.device, "backlog": backlog, "trials": args.trials,
           "failed_trials": bad}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
