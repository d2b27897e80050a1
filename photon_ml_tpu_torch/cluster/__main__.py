"""Cluster CLI: the 3-host control-plane drill + registry utilities (port
of ``photon_ml_tpu/cluster/__main__.py``).

Selfcheck (CI-greppable; the hosts score on the card unless
``--device cpu``)::

    python -m photon_ml_tpu_torch.cluster --selfcheck [--device cpu]

replays the cluster drill from docs/serving.md "Cluster" against real
HTTP on localhost — 2 warm hosts plus 1 cold one, a replicated quota
coordinator, a membership registry, and a publication server — and
gates:

- **coordinator kill**: the leader replica dies mid-phase under
  >= 120 rps open-loop load; hosts ride the degrade-to-last-lease
  contract, a follower claims the leader lease and replays the grant
  journal, and leadership moves within ~one quota lease TTL.
  Over-admission for the over-subscribed tenant stays within one
  lease window of its fleet budget; ZERO failed requests.
- **host join + drain**: a host with NO local model state cold-starts
  over the wire from the newest committed snapshot publication
  (checksums verified end-to-end), registers, and is joined into the
  router by the MembershipWatcher; a veteran host drains via the
  registry.  ZERO failed requests, ZERO rejections for the in-quota
  tenant through both transitions — and the cold host's scores are
  BIT-IDENTICAL to in-process scoring of the source model.
- the aggregator's host set follows membership: the drained host's
  series are marked departed once it leaves, never summed forever.

Registry utilities (device-free)::

    python -m photon_ml_tpu_torch.cluster --serve-registry --port 7000
    python -m photon_ml_tpu_torch.cluster --registry http://HOST:7000 --members
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.cluster",
        description="cluster control plane: drill selfcheck + registry",
    )
    p.add_argument("--selfcheck", action="store_true")
    p.add_argument(
        "--output-dir",
        help="telemetry output dir (selfcheck defaults to a tempdir)",
    )
    p.add_argument(
        "--rate", type=float, default=150.0,
        help="open-loop rps the drill offers (the gate floor is 120)",
    )
    p.add_argument(
        "--device", default=None,
        help="the drill's scoring device: cuda (default: the card, raises "
        "without one) or cpu",
    )
    p.add_argument(
        "--lease-ttl", type=float, default=1.0,
        help="quota lease TTL seconds; the failover bound scales with it",
    )
    p.add_argument(
        "--serve-registry", action="store_true",
        help="run a standalone membership registry until Ctrl-C",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument(
        "--heartbeat-ttl", type=float, default=2.0,
        help="registry heartbeat TTL seconds (--serve-registry)",
    )
    p.add_argument(
        "--registry", metavar="URL",
        help="membership registry base URL for --members",
    )
    p.add_argument(
        "--members", action="store_true",
        help="print the registry's current member set as JSON and exit",
    )
    return p


# ---------------------------------------------------------------------------
# The drill
# ---------------------------------------------------------------------------

def run_cluster_drill(
    out_dir: str,
    drill_rate: float = 150.0,
    lease_ttl_s: float = 1.0,
    device=None,
) -> list[str]:
    """The 3-host cluster drill (module docstring has the gates), every
    host's runtime on ``device`` (None: the card).  Returns failure
    strings (empty = pass)."""
    import threading
    import time

    import numpy as np

    from photon_ml_tpu_torch import telemetry as telemetry_mod
    from photon_ml_tpu_torch.cluster.coordination import (
        CoordinatorReplica,
        ReplicatedQuotaCoordinator,
    )
    from photon_ml_tpu_torch.cluster.distribution import (
        PublicationClient,
        PublicationServer,
        cold_start,
    )
    from photon_ml_tpu_torch.cluster.membership import (
        HeartbeatAgent,
        MembershipRegistry,
        MembershipWatcher,
        RegistryClient,
    )
    from photon_ml_tpu_torch.freshness.publisher import DeltaPublisher
    from photon_ml_tpu_torch.io.game_store import save_game_model
    from photon_ml_tpu_torch.serving import loadgen
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.fleet import FleetBudget, FleetRouter, LocalHost
    from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
    from photon_ml_tpu_torch.serving.service import ScoringService
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
    from photon_ml_tpu_torch.serving.tenancy import TenancyConfig, TenantSpec
    from photon_ml_tpu_torch.telemetry.fleet import FleetAggregator

    failures: list[str] = []
    n_hosts = 3                 # 2 warm + 1 cold joiner
    acme_budget_rps = 600.0     # in-quota tenant: the zero-shed gates
    metered_budget_rps = 60.0   # over-subscribed: the admission bound
    burst_s = 0.25
    heartbeat_ttl_s = max(1.0, lease_ttl_s)
    workload = SyntheticWorkload(n_entities=64, seed=11)
    rt_cfg = RuntimeConfig(max_batch_size=8, hot_entities=16,
                           device=device)
    # Static specs = the pre-lease defaults: each tenant's per-host
    # slice of its fleet budget.  acme's slice is sized so the SURVIVING
    # hosts absorb the drill rate in-quota even mid-drain.
    tenancy = TenancyConfig(tenants=(
        TenantSpec(
            name="acme",
            quota_rps=acme_budget_rps / n_hosts,
            burst=max(acme_budget_rps * burst_s / n_hosts, 1.0),
            max_queue=256,
        ),
        TenantSpec(
            name="metered",
            quota_rps=metered_budget_rps / n_hosts,
            burst=max(metered_budget_rps * burst_s / n_hosts, 1.0),
            max_queue=256,
        ),
    ))
    batcher_cfg = BatcherConfig(
        max_batch_size=8, max_wait_us=2_000, max_queue=512,
        tenancy=tenancy,
    )

    def build_service() -> ScoringService:
        return ScoringService(
            ScoringRuntime(workload.model, workload.index_maps, rt_cfg),
            batcher_cfg,
        )

    def make_request(i: int, phase, tenant: str) -> dict:
        obj = dict(workload.request(i))
        obj["tenant"] = tenant
        return obj

    with telemetry_mod.Telemetry(
        output_dir=out_dir, run_name="cluster-selfcheck"
    ) as tel:
        # The publication the cold host pulls: snapshot the source model
        # into the freshness root and serve that root over HTTP.
        model_dir = os.path.join(out_dir, "models", "v1")
        save_game_model(workload.model, workload.index_maps, model_dir)
        pub_root = os.path.join(out_dir, "pubs")
        publisher = DeltaPublisher(pub_root)
        snap_pub = publisher.publish_snapshot(model_dir)
        pub_server = PublicationServer(pub_root)
        pub_server.serve()

        registry = MembershipRegistry(heartbeat_ttl_s=heartbeat_ttl_s)
        registry.serve()
        reg_client = RegistryClient(registry.base_url)

        # Two coordinator replicas over ONE durable store (the
        # replicated-log stand-in): leader lease + grant journal.
        store = os.path.join(out_dir, "coordinator")
        budgets = [
            FleetBudget("acme", acme_budget_rps, burst_s=burst_s),
            FleetBudget("metered", metered_budget_rps, burst_s=burst_s),
        ]
        replicas = [
            CoordinatorReplica(
                f"replica{i}", store, budgets, lease_ttl_s=lease_ttl_s
            )
            for i in range(2)
        ]
        coordinator = ReplicatedQuotaCoordinator(replicas)

        hosts = [
            LocalHost(f"host{i}", build_service()).start()
            for i in range(2)
        ]
        clients = [
            h.attach_lease_client(coordinator).start() for h in hosts
        ]
        router = FleetRouter(
            [h.base_url for h in hosts], probe_interval_s=0.1,
        ).start()
        # Register the warm hosts BEFORE the watcher's first poll — an
        # empty registry would read as "everyone left".
        for h in hosts:
            reg_client.register(h.host_id, h.base_url)
        agents = [
            HeartbeatAgent(
                reg_client, h.host_id, h.base_url,
                heartbeat_ttl_s=heartbeat_ttl_s,
            ).start()
            for h in hosts
        ]
        aggregator = FleetAggregator(
            {h.host_id: h.base_url for h in hosts},
            fetch=lambda url, timeout_s: {
                "transport": tel.metrics.transport_snapshot()
            },
            stale_drop_s=10.0,
        )
        watcher = MembershipWatcher(
            reg_client, router, aggregator=aggregator, interval_s=0.1,
        ).start()
        cold: dict = {}
        failover: dict = {}
        try:
            # Warm the bucket ladders and let lease shares settle.
            for i in range(8):
                router.score(make_request(i, None, "acme"))
            time.sleep(3 * lease_ttl_s / 2)

            # -- gate 1: coordinator kill under load ----------------------
            def kill_coordinator():
                leader_id = coordinator.leader() or replicas[0].replica_id
                victim = next(
                    r for r in replicas if r.replica_id == leader_id
                )
                failover["victim"] = victim
                t0 = time.monotonic()
                victim.kill()
                deadline = t0 + 5.0 * lease_ttl_s
                while time.monotonic() < deadline:
                    cur = coordinator.leader()
                    if cur is not None and cur != leader_id:
                        break
                    time.sleep(0.02)
                failover["elapsed_s"] = time.monotonic() - t0
                failover["from"] = leader_id
                failover["to"] = coordinator.leader()
                return {
                    "killed": leader_id,
                    "failover_s": round(failover["elapsed_s"], 3),
                    "new_leader": failover["to"],
                }

            def restart_coordinator():
                failover["victim"].restart()
                return True

            # Each phase's admission span: from its first submission to
            # the last outcome of its requests.  A loaded machine holds
            # the open loop behind its schedule, and the router's workers
            # then deliver a phase's requests over longer than its
            # nominal duration, while the hosts' buckets admit at the
            # leased rate throughout; the bounds below take the longer
            # of the two (the reference takes the nominal duration).
            spans: dict = {}
            spans_lock = threading.Lock()
            current = [None]

            def phase_request(i, phase, tenant):
                current[0] = phase.name
                return make_request(i, phase, tenant)

            def timed_submit(request):
                name = current[0]
                with spans_lock:
                    now = time.monotonic()
                    span = spans.setdefault(name, [now, now])

                def done(_fut, span=span):
                    with spans_lock:
                        span[1] = max(span[1], time.monotonic())

                fut = router.submit(request)
                fut.add_done_callback(done)
                return fut

            q_report = loadgen.run_fleet_scenario(
                timed_submit, phase_request,
                loadgen.SCENARIOS["coordinator_failover"],
                tenant="metered", base_rate_rps=drill_rate,
                actions={
                    "kill_coordinator": kill_coordinator,
                    "restart_coordinator": restart_coordinator,
                },
                seed=1,
            )
            if q_report.failed:
                failures.append(
                    f"coordinator_failover: {q_report.failed} non-shed "
                    "FAILURES (sheds are the design working; failures "
                    f"are not): {q_report.snapshot()}"
                )
            if failover.get("to") in (None, failover.get("from")):
                failures.append(
                    "coordinator_failover: leadership never moved off "
                    f"the killed replica: {failover.get('from')!r} -> "
                    f"{failover.get('to')!r}"
                )
            elif failover["elapsed_s"] > 1.25 * lease_ttl_s:
                # The bound: leader-lease expiry (ttl/2) + one host
                # renew interval (ttl/2) = one quota lease TTL, plus
                # scheduling slop.
                failures.append(
                    "coordinator_failover: takeover took "
                    f"{failover['elapsed_s']:.2f}s > 1.25 x lease TTL "
                    f"({lease_ttl_s:g}s)"
                )
            burst_total = metered_budget_rps * burst_s
            admitted: dict = {}
            for pname in ("baseline", "kill", "recover"):
                pr = q_report.phase(pname)
                duration = next(
                    d for n, d, _, _ in q_report.phases if n == pname
                )
                with spans_lock:
                    start, end = spans.get(pname, (0.0, 0.0))
                span = max(duration, end - start)
                # One lease window of over-admission is legal while the
                # leadership is in flight; exact enforcement before and
                # after.
                window = lease_ttl_s if pname == "kill" else 0.0
                bound = (
                    metered_budget_rps * (span + window) * 1.15
                    + burst_total + 10
                )
                admitted[pname] = [pr.completed, round(bound, 1),
                                   round(span, 3)]
                if pr.completed > bound:
                    failures.append(
                        f"coordinator_failover phase {pname}: admitted "
                        f"{pr.completed} > bound {bound:.0f} (budget "
                        f"{metered_budget_rps:g} rps over {span:.3g}s "
                        "+ one lease window) — enforcement leaked past "
                        "the lease contract"
                    )
                if pr.completed < 0.4 * metered_budget_rps * duration:
                    failures.append(
                        f"coordinator_failover phase {pname}: admitted "
                        f"only {pr.completed} — degraded toward zero "
                        "(the contract is never-zero)"
                    )
            if any(lc.stale for lc in clients):
                failures.append(
                    "after failover: lease clients still stale "
                    f"({[lc.stale for lc in clients]}) — renewal never "
                    "reached the new leader"
                )

            # -- gate 2: cold-start join + drain --------------------------
            def join_host():
                client = PublicationClient(
                    pub_server.base_url,
                    cache_dir=os.path.join(out_dir, "cold_cache"),
                )
                local_model, pub = cold_start(client, subscriber_id="host2")
                runtime = ScoringRuntime.load(local_model, rt_cfg)
                host = LocalHost(
                    "host2", ScoringService(runtime, batcher_cfg)
                ).start()
                lease = host.attach_lease_client(coordinator).start()
                agent = HeartbeatAgent(
                    reg_client, "host2", host.base_url,
                    heartbeat_ttl_s=heartbeat_ttl_s,
                ).start()
                cold.update(
                    host=host, lease=lease, agent=agent, seq=pub.seq,
                )
                return {"host": "host2", "snapshot_seq": pub.seq}

            def drain_host():
                return reg_client.drain(hosts[0].host_id)

            j_report = loadgen.run_fleet_scenario(
                router.submit, make_request,
                loadgen.SCENARIOS["host_join_drain"],
                tenant="acme", base_rate_rps=drill_rate,
                actions={
                    "join_host": join_host, "drain_host": drain_host,
                },
                seed=2,
            )
            if j_report.failed:
                failures.append(
                    f"host_join_drain: {j_report.failed} FAILED requests "
                    f"(must be 0): {j_report.snapshot()}"
                )
            if j_report.shed:
                failures.append(
                    f"host_join_drain: {j_report.shed} rejections for "
                    f"the in-quota tenant (must be 0): "
                    f"{j_report.snapshot()}"
                )
            if j_report.completed < drill_rate:  # ~1s of traffic, floor
                failures.append(
                    f"host_join_drain: only {j_report.completed} "
                    "requests completed — the scenario never loaded the "
                    "fleet"
                )
            for key in ("join_host", "drain_host"):
                if str(j_report.actions.get(key)).startswith("ERROR"):
                    failures.append(
                        f"{key} action failed: {j_report.actions[key]}"
                    )

            # Convergence: the cold host routed, the drained host out.
            deadline = time.monotonic() + 10.0
            cold_state = h0_state = None
            while time.monotonic() < deadline:
                hz = {
                    h["url"]: h["state"]
                    for h in router.healthz()["hosts"]
                }
                cold_state = (
                    hz.get(cold["host"].base_url) if "host" in cold
                    else None
                )
                h0_state = hz.get(hosts[0].base_url)
                if cold_state == "healthy" and h0_state == "removed":
                    break
                time.sleep(0.05)
            if cold_state != "healthy":
                failures.append(
                    "host_join_drain: cold host never became a healthy "
                    f"routing target (state {cold_state!r}): "
                    f"{router.healthz()}"
                )
            if h0_state != "removed":
                failures.append(
                    "host_join_drain: drained host never left the "
                    f"rotation (state {h0_state!r}): {router.healthz()}"
                )

            # Bitwise parity: the cold host's scores vs in-process
            # scoring of the SOURCE model (snapshot -> wire -> verify ->
            # load must change nothing).
            if "host" in cold:
                # Untenanted requests: parity judges VALUES, not the
                # cold host's freshly-leased admission budget.
                ref_requests = [workload.request(i) for i in range(16)]
                ref_rt = ScoringRuntime(
                    workload.model, workload.index_maps, rt_cfg
                )
                want = np.asarray(
                    [
                        ref_rt.score_rows([ref_rt.parse_request(r)])[0][0]
                        for r in ref_requests
                    ],
                    np.float32,
                )
                got = np.asarray(
                    [
                        np.float32(
                            cold["host"].service.score(r, timeout=60)[
                                "score"
                            ]
                        )
                        for r in ref_requests
                    ],
                    np.float32,
                )
                if got.tobytes() != want.tobytes():
                    bad = int(np.argmax(got != want))
                    failures.append(
                        "cold host scores are NOT bit-identical to the "
                        f"source model (first diff row {bad}: "
                        f"{got[bad]!r} vs {want[bad]!r})"
                    )

            # The aggregator follows membership: retire host0 fully and
            # watch its series get marked departed (never summed
            # forever).
            agents[0].stop(leave=True)
            deadline = time.monotonic() + 5.0
            departed = False
            while time.monotonic() < deadline:
                aggregator.poll_once()
                h0 = aggregator.slo_report()["hosts"].get(
                    hosts[0].host_id
                )
                if h0 is None or h0.get("departed"):
                    departed = True
                    break
                time.sleep(0.05)
            if not departed:
                failures.append(
                    "aggregator never marked the departed host stale — "
                    "its last-seen series would sum forever"
                )

            snap = tel.snapshot()
        finally:
            watcher.stop()
            for a in agents:
                a.stop(leave=True)
            if "agent" in cold:
                cold["agent"].stop(leave=True)
            router.stop()
            for h in hosts:
                h.stop()
            if "host" in cold:
                cold["host"].stop()
            registry.close()
            pub_server.close()
            for r in replicas:
                r.close()
        counters = snap["counters"]
        for name, floor in (
            ("cluster_elections_total", 2),
            ("cluster_failovers_total", 1),
            ("cluster_renewals_total", n_hosts),
            ("cluster_joins_total", n_hosts),
            ("cluster_heartbeats_total", n_hosts),
            ("cluster_drains_total", 1),
            ("cluster_cold_starts_total", 1),
            ("cluster_fetches_total", 1),
            ("cluster_acks_total", 1),
            ("serving_fleet_joins_total", 1),
        ):
            if counters.get(name, 0) < floor:
                failures.append(
                    f"{name} = {counters.get(name, 0)}, expected >= "
                    f"{floor} — the drill left no metric trace"
                )
    if not failures:
        print(
            "cluster selfcheck: coordinator kill failed over "
            f"{failover['from']} -> {failover['to']} in "
            f"{failover['elapsed_s']:.2f}s (bound 1.25 x "
            f"{lease_ttl_s:g}s lease TTL) with {q_report.completed} "
            f"admitted / 0 failed at {drill_rate:g} rps; cold host "
            f"joined from snapshot seq {snap_pub.seq} serving "
            f"bit-identical scores and host0 drained with "
            f"{j_report.completed} completed / 0 failed / 0 shed"
        )
        # The gates' numbers, for a caller that records them.
        print("cluster selfcheck gates: " + json.dumps({
            "failover_s": failover["elapsed_s"],
            "old_leader": failover["from"],
            "new_leader": failover["to"],
            "failover_bound_s": 1.25 * lease_ttl_s,
            "rate_rps": drill_rate,
            "admitted_vs_bound": admitted,
            "join_drain_completed": j_report.completed,
            "cold_host_bitwise": True,
        }))
    return failures


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    if args.members:
        from photon_ml_tpu_torch.cluster.membership import RegistryClient

        if not args.registry:
            print("--members needs --registry URL", file=sys.stderr)
            return 2
        members = RegistryClient(args.registry).members()
        print(json.dumps(members, indent=2, sort_keys=True))
        return 0

    if args.serve_registry:
        from photon_ml_tpu_torch.cluster.membership import MembershipRegistry

        registry = MembershipRegistry(
            heartbeat_ttl_s=args.heartbeat_ttl
        )
        registry.serve(host=args.host, port=args.port)
        print(
            f"membership registry on {registry.base_url} "
            "(/register /heartbeat /drain /leave /members /healthz); "
            "Ctrl-C to stop",
            flush=True,
        )
        try:
            import threading

            threading.Event().wait()
        except KeyboardInterrupt:
            print("shutting down")
        finally:
            registry.close()
        return 0

    if args.selfcheck:
        from photon_ml_tpu_torch.device import resolve_device

        # Up front: without a card the drill raises here, not as failed
        # hosts mid-drill.
        device = resolve_device(args.device)

        def run(root: str) -> list[str]:
            os.makedirs(root, exist_ok=True)
            return run_cluster_drill(
                root, drill_rate=args.rate, lease_ttl_s=args.lease_ttl,
                device=str(device),
            )

        if args.output_dir:
            failures = run(args.output_dir)
        else:
            with tempfile.TemporaryDirectory(
                prefix="photon_cluster_selfcheck_"
            ) as td:
                failures = run(td)
        if failures:
            print("cluster selfcheck FAILED:", file=sys.stderr)
            for f in failures:
                print(f"  - {f}", file=sys.stderr)
            return 1
        print("cluster selfcheck PASSED")
        return 0

    build_arg_parser().print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
