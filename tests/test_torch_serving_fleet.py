"""The port's fleet tier and same-machine ingress on the CPU — the
reference's ``tests/test_serving_fleet.py`` and
``test_serving_wire.py::{TestProtocolWireFrames,TestShmIngress,
TestFleetBinaryMode}``, run through the port, plus the parity the port
owes the reference: a ``QuotaCoordinator`` grants the reference's leases
on the same demand, and ``ShmIngress`` scores bitwise the HTTP binary
path.  Hosts are HTTP services on localhost, bound to port 0.
"""

import threading
import time

import socket
import struct
import urllib.request

import numpy as np
import pytest

from photon_ml_tpu_torch import chaos
from photon_ml_tpu_torch.serving.batcher import BatcherConfig, RejectedError
from photon_ml_tpu_torch.serving.fleet import (
    FleetBudget,
    FleetRouter,
    LeaseClient,
    LocalHost,
    QuotaCoordinator,
)
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.service import ScoringService
from photon_ml_tpu_torch.serving.protocol import (
    FrameConn,
    ProtocolError,
    _encode_payload,
)
from photon_ml_tpu_torch.serving.runtime import Row
from photon_ml_tpu_torch.serving.service import start_http_server
from photon_ml_tpu_torch.serving.shm_ingress import (
    ShmIngress,
    ShmIngressClient,
    ShmIngressError,
)
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from photon_ml_tpu_torch.serving.tenancy import TokenBucket
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


@pytest.fixture(scope="module")
def workload():
    return SyntheticWorkload(n_entities=32, seed=7)


def _service(workload):
    cfg = RuntimeConfig(max_batch_size=8, hot_entities=8, device="cpu")
    runtime = ScoringRuntime(workload.model, workload.index_maps, cfg)
    return ScoringService(runtime, BatcherConfig(
        max_batch_size=8, max_wait_us=1000, max_queue=256,
    ))


def _wait_until(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class _Fleet:
    """n hosts + one router, torn down in reverse order."""

    def __init__(self, workload, n_hosts=2, **router_kwargs):
        self.hosts = [
            LocalHost(f"h{i}", _service(workload)).start()
            for i in range(n_hosts)
        ]
        kwargs = {"probe_interval_s": 0.05, **router_kwargs}
        self.router = FleetRouter(
            [h.base_url for h in self.hosts], **kwargs
        ).start()

    def __enter__(self) -> "_Fleet":
        return self

    def __exit__(self, *exc) -> bool:
        self.router.stop()
        for h in self.hosts:
            h.stop()
        return False


class TestFleetRouter:
    def test_scores_and_balances_across_hosts(self, workload):
        with _Fleet(workload) as fleet:
            results = [
                fleet.router.score(workload.request(i))
                for i in range(8)
            ]
            assert all(np.isfinite(r["score"]) for r in results)
            hz = fleet.router.healthz()
            assert hz["status"] == "ok"
            assert all(h["requests"] > 0 for h in hz["hosts"])

    def test_host_kill_under_load_costs_zero_failures(self, workload):
        with _Fleet(workload) as fleet:
            futures = [
                fleet.router.submit(workload.request(i))
                for i in range(16)
            ]
            fleet.hosts[0].kill()
            futures += [
                fleet.router.submit(workload.request(i))
                for i in range(16, 48)
            ]
            results = [f.result(timeout=30) for f in futures]
            assert all(np.isfinite(r["score"]) for r in results)
            # The killed host's listener rebinds and rejoins.
            fleet.hosts[0].restart()
            assert _wait_until(
                lambda: fleet.router.healthy_count == 2
            ), fleet.router.healthz()

    def test_host_takes_a_routers_connections_at_once(self):
        """A router's workers connect to one host together: a host that
        has not yet accepted any of them still completes every
        handshake, where a backlog of 5 reset or stalled the excess and
        marked a healthy host down."""
        from photon_ml_tpu_torch.serving import service as service_mod

        n = 2 * FleetRouter(["http://127.0.0.1:1"])._workers
        server = service_mod._Server(("127.0.0.1", 0), service_mod._Handler)
        server.service = None
        socks, thread = [], None
        try:
            for _ in range(n):
                s = socket.create_connection(server.server_address,
                                             timeout=2.0)
                socks.append(s)
                s.sendall(b"GET /livez HTTP/1.1\r\nHost: h\r\n"
                          b"Connection: close\r\n\r\n")
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            for s in socks:
                s.settimeout(10.0)
                assert s.recv(64).startswith(b"HTTP/1.1 200"), \
                    "a queued connection was not served"
        finally:
            for s in socks:
                s.close()
            if thread is not None:
                server.shutdown()
            server.server_close()

    def test_chaos_host_site_marks_down_and_resubmits(self, workload):
        plan = chaos.FaultPlan([
            chaos.FaultSpec(site="serving.host", at=0),
        ])
        with _Fleet(workload, probe_interval_s=10.0) as fleet:
            with plan:
                result = fleet.router.score(workload.request(0))
            assert np.isfinite(result["score"])
            assert plan.fired and \
                plan.fired[0]["site"] == "serving.host"
            # The victim is out of rotation awaiting reconnect probes.
            assert fleet.router.healthy_count == 1

    def test_no_healthy_host_is_a_transient_rejection(self, workload):
        """With the whole fleet down, a request waits out the no-host
        retry window (reconnect probes might restore someone), then
        fails with the transient vocabulary."""
        with _Fleet(
            workload, n_hosts=1, no_host_retry_s=0.2
        ) as fleet:
            fleet.hosts[0].kill()
            with pytest.raises((RejectedError, RuntimeError)) as exc:
                fleet.router.score(workload.request(0), timeout=10)
            assert "UNAVAILABLE" in str(exc.value)
            assert fleet.router.healthy_count == 0

    def test_whole_fleet_blip_delays_instead_of_failing(self, workload):
        """EVERY host momentarily unreachable: requests in the window
        wait for reconnect probes and still complete (the host-kill
        zero-failures contract extends to total blips shorter than
        ``no_host_retry_s``)."""
        with _Fleet(workload, n_hosts=1) as fleet:
            fleet.hosts[0].kill()
            # Trip the transport failure so the host is marked down.
            fut = fleet.router.submit(workload.request(0))
            restorer = threading.Timer(0.3, fleet.hosts[0].restart)
            restorer.start()
            try:
                assert np.isfinite(fut.result(timeout=30)["score"])
            finally:
                restorer.join()

    def test_drain_removes_host_without_dropping_requests(
        self, workload
    ):
        with _Fleet(workload) as fleet:
            assert fleet.router.drain(0, timeout_s=10.0)
            before = fleet.router.healthz()
            drained = next(
                h for h in before["hosts"] if h["hid"] == 0
            )
            assert drained["state"] == "removed"
            for i in range(6):
                r = fleet.router.score(workload.request(i))
                assert np.isfinite(r["score"])
            after = fleet.router.healthz()
            assert (
                next(h for h in after["hosts"] if h["hid"] == 0)[
                    "requests"
                ] == drained["requests"]
            )
            with pytest.raises(ValueError, match="unknown host id"):
                fleet.router.drain(99)

    def test_join_adds_a_live_host_without_restart(self, workload):
        """Satellite: ``join()`` is ``drain()``'s symmetric
        counterpart — a joined host enters as down-until-ready and
        takes traffic only after its first ready probe, and re-joining
        a drained URL revives the SAME host id."""
        with _Fleet(workload, n_hosts=1) as fleet:
            extra = LocalHost("hx", _service(workload)).start()
            try:
                hid = fleet.router.join(extra.base_url)
                joined = next(
                    h for h in fleet.router.healthz()["hosts"]
                    if h["hid"] == hid
                )
                # Enters down (awaiting its first ready probe); the
                # probe loop may already have admitted it.
                assert joined["state"] in ("down", "healthy")
                assert _wait_until(
                    lambda: fleet.router.healthy_count == 2
                ), fleet.router.healthz()
                # Joining an in-rotation URL is idempotent.
                assert fleet.router.join(extra.base_url) == hid
                # Drain it out, re-join: the same id revives.
                assert fleet.router.drain(hid, timeout_s=10.0)
                assert fleet.router.join(extra.base_url) == hid
                assert _wait_until(
                    lambda: fleet.router.healthy_count == 2
                ), fleet.router.healthz()
                for i in range(6):
                    assert np.isfinite(
                        fleet.router.score(workload.request(i))["score"]
                    )
            finally:
                extra.stop()

    def test_reconnect_backoff_resets_after_sustained_health(
        self, workload
    ):
        """Satellite: repeated HOST-level failure bursts.  The backoff
        walk escalates while a host stays dead, resets to base once
        probes see sustained health, and the NEXT burst escalates from
        base again instead of inheriting the previous burst's delay."""
        with _Fleet(workload) as fleet:
            host = fleet.router.hosts[0]

            def burst():
                fleet.hosts[0].kill()
                # A request trips the transport failure -> mark down.
                assert np.isfinite(
                    fleet.router.score(workload.request(0))["score"]
                )
                assert _wait_until(lambda: host.state == "down")
                # Reconnect probes keep failing: the walk escalates.
                assert _wait_until(
                    lambda: host.reconnect_attempt >= 3, timeout=20.0
                ), fleet.router.healthz()
                first_delay = host.last_delay
                assert first_delay is not None and first_delay > 0
                fleet.hosts[0].restart()
                assert _wait_until(lambda: host.state == "healthy")
                # Sustained health resets the walk (healthy probes run
                # every probe_interval_s).
                assert _wait_until(
                    lambda: host.reconnect_attempt == 0
                    and host.last_delay is None
                ), fleet.router.healthz()

            burst()  # burst 1: escalate, recover, reset
            burst()  # burst 2: must re-escalate from a reset walk


class TestQuotaCoordinator:
    def _clock(self, start=100.0):
        state = {"t": start}

        def clock():
            return state["t"]

        return state, clock

    def test_outstanding_never_exceeds_budget(self):
        state, clock = self._clock()
        coord = QuotaCoordinator(
            [FleetBudget("t", 100.0)], lease_ttl_s=1.0, clock=clock
        )
        for rnd in range(6):
            for host, demand in (("a", 10.0), ("b", 90.0), ("c", 40.0)):
                coord.renew(host, {"t": demand})
                outstanding = coord.stats()["tenants"]["t"][
                    "outstanding_rps"
                ]
                assert outstanding <= 100.0 + 1e-6, coord.stats()
            state["t"] += 0.4  # inside the TTL: nothing expires

    def test_rebalance_converges_to_demand_in_one_round(self):
        state, clock = self._clock()
        coord = QuotaCoordinator(
            [FleetBudget("t", 100.0, min_share=0.1)],
            lease_ttl_s=5.0, clock=clock,
        )
        # First renewer is the only live host: it holds the whole
        # budget until a peer shows up.
        assert coord.renew("a", {"t": 10.0})["t"].rate_rps == \
            pytest.approx(100.0)
        # b's target is demand-proportional but the budget is spoken
        # for — it gets the leftovers (zero), never over-commits.
        assert coord.renew("b", {"t": 30.0})["t"].rate_rps == \
            pytest.approx(0.0)
        # One more renewal each converges to floor + proportional:
        # floor 5 each, variable 90 split 10:30 -> 27.5 / 72.5.
        assert coord.renew("a", {"t": 10.0})["t"].rate_rps == \
            pytest.approx(27.5)
        assert coord.renew("b", {"t": 30.0})["t"].rate_rps == \
            pytest.approx(72.5)
        assert coord.rebalances >= 2

    def test_equal_split_at_zero_demand(self):
        _, clock = self._clock()
        coord = QuotaCoordinator(
            [FleetBudget("t", 60.0)], lease_ttl_s=5.0, clock=clock
        )
        coord.renew("a", {})
        coord.renew("b", {})
        assert coord.renew("a", {})["t"].rate_rps == pytest.approx(30.0)
        assert coord.renew("b", {})["t"].rate_rps == pytest.approx(30.0)

    def test_dead_host_share_reclaimed_after_ttl(self):
        state, clock = self._clock()
        coord = QuotaCoordinator(
            [FleetBudget("t", 100.0)], lease_ttl_s=1.0, clock=clock
        )
        assert coord.renew("a", {"t": 50.0})["t"].rate_rps == \
            pytest.approx(100.0)
        # a dies (stops renewing); its lease expires...
        state["t"] += 1.5
        # ...and b's next renewal reclaims the whole budget.
        assert coord.renew("b", {"t": 50.0})["t"].rate_rps == \
            pytest.approx(100.0)
        assert coord.reclaims == 1
        assert coord.stats()["tenants"]["t"]["outstanding_rps"] == \
            pytest.approx(100.0)


class _FakeService:
    """The two methods LeaseClient needs, with an applied-quota log."""

    def __init__(self):
        self.demand = {}
        self.applied = []

    def demand_snapshot(self):
        return dict(self.demand)

    def set_tenant_quota(self, tenant, rate_rps, burst=None):
        self.applied.append((tenant, rate_rps, burst))


class TestLeaseClient:
    def test_poll_applies_granted_lease(self):
        coord = QuotaCoordinator([FleetBudget("t", 50.0)])
        svc = _FakeService()
        lc = LeaseClient("h0", coord, svc)
        assert lc.poll_once()
        assert lc.leases["t"].rate_rps == pytest.approx(50.0)
        assert svc.applied == [("t", pytest.approx(50.0),
                                pytest.approx(50.0))]
        assert not lc.stale

    def test_partition_degrades_to_last_lease(self):
        """The partition contract: on renewal failure the LAST lease
        keeps enforcing — never unlimited, never zero."""
        coord = QuotaCoordinator([FleetBudget("t", 50.0)])
        svc = _FakeService()
        lc = LeaseClient("h0", coord, svc)
        assert lc.poll_once()
        applied_before = list(svc.applied)
        lease_before = lc.leases["t"]

        lc.partitioned = True
        assert not lc.poll_once()
        assert lc.stale
        assert lc.renew_failures == 1
        # Buckets untouched: no new set_tenant_quota, no zeroing, and
        # the remembered lease still carries a bounded nonzero rate.
        assert svc.applied == applied_before
        assert lc.leases["t"] is lease_before
        assert 0 < lc.leases["t"].rate_rps <= 50.0

        lc.partitioned = False
        assert lc.poll_once()
        assert not lc.stale
        assert len(svc.applied) > len(applied_before)

    def test_chaos_lease_site_degrades_then_recovers(self):
        coord = QuotaCoordinator([FleetBudget("t", 50.0)])
        svc = _FakeService()
        lc = LeaseClient("h0", coord, svc)
        assert lc.poll_once()
        plan = chaos.FaultPlan([
            chaos.FaultSpec(site="quota.lease", at=0, count=1),
        ])
        with plan:
            assert not lc.poll_once()  # scripted partition fires
            assert lc.stale
            assert lc.poll_once()  # next renewal heals
        assert plan.fired and plan.fired[0]["site"] == "quota.lease"
        assert not lc.stale
        assert lc.renew_failures == 1

    def test_demand_rates_difference_counters(self):
        times = iter([0.0, 2.0])
        coord = QuotaCoordinator([FleetBudget("t", 50.0)])
        svc = _FakeService()
        lc = LeaseClient(
            "h0", coord, svc, clock=lambda: next(times)
        )
        svc.demand = {"t": 10}
        lc.poll_once()  # first poll: no interval yet -> zero rate
        svc.demand = {"t": 50}
        lc.poll_once()
        # 40 offered requests over 2s -> 20 rps observed demand.
        grant = coord.stats()["tenants"]["t"]["hosts"]["h0"]
        assert grant["demand_rps"] == pytest.approx(20.0)


class TestTokenBucketReset:
    def test_reset_clamps_tokens_down_never_refills_up(self):
        times = iter([0.0, 0.0, 0.0, 0.0, 0.0])
        bucket = TokenBucket(
            100.0, burst=100.0, clock=lambda: next(times)
        )
        assert bucket.try_acquire(60.0)  # 40 tokens left
        bucket.reset_rate(10.0, burst=5.0)
        # Shrinking the burst clamps stored tokens down with it...
        assert bucket.tokens <= 5.0
        bucket.reset_rate(200.0, burst=100.0)
        # ...but raising the rate never mints tokens retroactively.
        assert bucket.tokens <= 5.0

    def test_reset_to_none_is_unlimited(self):
        bucket = TokenBucket(1.0, burst=1.0)
        bucket.reset_rate(None)
        assert all(bucket.try_acquire() for _ in range(100))

    def test_reset_rejects_bad_values(self):
        bucket = TokenBucket(10.0, burst=10.0)
        with pytest.raises(ValueError):
            bucket.reset_rate(-1.0)
        with pytest.raises(ValueError):
            bucket.reset_rate(10.0, burst=0.0)


class TestServiceQuotaSurface:
    def test_set_tenant_quota_requires_tenancy(self, workload):
        service = _service(workload)
        with service:
            with pytest.raises(ValueError):
                service.set_tenant_quota("acme", 10.0)

    def test_demand_counts_offered_not_admitted(self, workload):
        service = _service(workload)
        with service:
            req = dict(workload.request(0))
            req["tenant"] = "acme"
            for _ in range(5):
                service.submit(req).result(timeout=30)
            assert service.demand_snapshot().get("acme") == 5


# ---------------------------------------------------------------------------
# Wire frames, shared-memory ingress, the fleet's binary mode
# ---------------------------------------------------------------------------

def _wire_runtime(workload, **kwargs):
    cfg = RuntimeConfig(**{"max_batch_size": 4, "hot_entities": 8,
                           "device": "cpu", **kwargs})
    return ScoringRuntime(workload.model, workload.index_maps, cfg)


def _requests(workload, n, start=0):
    return [workload.request(i) for i in range(start, start + n)]


class TestProtocolWireFrames:
    def _pair(self):
        a, b = socket.socketpair()
        return FrameConn(a), FrameConn(b)

    def test_score_message_rides_the_wire_codec(self):
        row = Row(
            features={"g": np.arange(4, dtype=np.float32)},
            ids={"memberId": "m1"}, offset=0.25, timeout_ms=50.0,
            priority="high", tenant="acme",
        )
        msg = {"kind": "score", "id": 7, "row": row, "tenant": "acme",
               "timeout_ms": 50.0, "bypass": True}
        assert _encode_payload(msg)[0] == 1  # wire, not pickle
        ca, cb = self._pair()
        try:
            ca.send(msg)
            got = cb.recv()
            assert got["id"] == 7 and got["bypass"] is True
            assert got["row"].features["g"].tobytes() == \
                row.features["g"].tobytes()
            assert got["row"].tenant == "acme"
        finally:
            ca.close()
            cb.close()

    def test_success_result_rides_the_wire_codec(self):
        msg = {"kind": "result", "id": 3, "ok": True, "value": {
            "score": 1.0000000000000002, "mean": 0.5, "latency_ms": 0.75,
        }}
        assert _encode_payload(msg)[0] == 2
        ca, cb = self._pair()
        try:
            ca.send(msg)
            assert cb.recv() == msg  # bitwise float64 equality
        finally:
            ca.close()
            cb.close()

    @pytest.mark.parametrize("msg", [
        {"kind": "result", "id": 3, "ok": False, "error": "boom",
         "error_kind": "internal"},
        {"kind": "result", "id": 3, "ok": True, "value": {"depth": 4}},
        {"kind": "stats", "id": 1},
        {"kind": "swap_prepare", "id": 2, "model_dir": "/x"},
        ["not", "a", "dict"],
    ])
    def test_everything_else_stays_pickle(self, msg):
        assert _encode_payload(msg)[0] == 0
        ca, cb = self._pair()
        try:
            ca.send(msg)
            assert cb.recv() == msg
        finally:
            ca.close()
            cb.close()

    def test_corrupt_wire_payload_raises_protocol_error(self):
        ca, cb = self._pair()
        try:
            bad = bytes([1]) + b"XXXX" + bytes(40)
            ca._sock.sendall(struct.pack(">I", len(bad)) + bad)
            with pytest.raises(ProtocolError, match="corrupt wire"):
                cb.recv()
        finally:
            ca.close()
            cb.close()

    def test_unknown_kind_byte_raises_protocol_error(self):
        ca, cb = self._pair()
        try:
            ca._sock.sendall(struct.pack(">I", 1) + bytes([9]))
            with pytest.raises(ProtocolError, match="kind byte"):
                cb.recv()
        finally:
            ca.close()
            cb.close()


class _Ring:
    def __init__(self, workload, **kwargs):
        self.service = ScoringService(_wire_runtime(workload))
        self.service.start()
        self.ingress = ShmIngress(self.service, **{
            "n_slots": 4, "slot_bytes": 64 << 10, **kwargs,
        }).start()
        self.client = ShmIngressClient(self.ingress.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.client.close()
        self.ingress.stop()
        self.service.stop()
        return False


class TestShmIngress:
    def test_ring_scores_match_in_process(self, workload):
        with _Ring(workload) as ring:
            reqs = _requests(workload, 8)
            via_ring = ring.client.score_many(reqs, timeout_s=60.0)
            via_proc = ring.service.score_many(
                [dict(r) for r in reqs]
            )
            for a, b in zip(via_ring, via_proc):
                if "error" in b:
                    assert a.get("kind") == b.get("kind")
                else:
                    assert a["score"] == b["score"]

    def test_concurrent_clients_share_the_ring(self, workload):
        with _Ring(workload) as ring:
            reqs = _requests(workload, 3)
            errors = []

            def hammer():
                try:
                    for _ in range(5):
                        out = ring.client.score_many(reqs, timeout_s=60.0)
                        assert len(out) == 3
                except Exception as exc:  # noqa: BLE001 — collect
                    errors.append(exc)

            threads = [
                threading.Thread(target=hammer) for _ in range(4)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert not errors, errors

    def test_oversized_request_refused_client_side(self, workload):
        with _Ring(workload) as ring:
            big = [{"dense": {"g": [0.0] * 64}}] * 4096
            with pytest.raises(ShmIngressError, match="exceeds"):
                ring.client.score_many(big, timeout_s=5.0)

    def test_garbage_frame_answers_in_band(self, workload):
        with _Ring(workload) as ring:
            out = ring.client._roundtrip(b"JUNK" + bytes(28), 30.0)
            assert out[0]["kind"] == "bad_request"

    def test_missing_segment_refused(self):
        with pytest.raises(ShmIngressError, match="gone"):
            ShmIngressClient("no-such-ingress-ring")

    def test_geometry_validation(self, workload):
        service = ScoringService(_wire_runtime(workload))
        with pytest.raises(ValueError, match="n_slots"):
            ShmIngress(service, n_slots=0)
        with pytest.raises(ValueError, match="slot_bytes"):
            ShmIngress(service, slot_bytes=16)


# ---------------------------------------------------------------------------
# Fleet binary mode
# ---------------------------------------------------------------------------

class TestFleetBinaryMode:
    def test_binary_fleet_matches_json_fleet(self, workload):
        from photon_ml_tpu_torch.serving.fleet import FleetRouter, LocalHost
        host = LocalHost("h0", ScoringService(_wire_runtime(workload))).start()
        try:
            reqs = _requests(workload, 6)
            json_router = FleetRouter(
                [host.base_url], probe_interval_s=0.05,
            ).start()
            try:
                via_json = [json_router.score(r) for r in reqs]
            finally:
                json_router.stop()
            bin_router = FleetRouter(
                [host.base_url], probe_interval_s=0.05,
                wire_format="binary",
            ).start()
            try:
                via_bin = [bin_router.score(r) for r in reqs]
            finally:
                bin_router.stop()
            for a, b in zip(via_bin, via_json):
                assert a["score"] == b["score"]
                assert a["mean"] == b["mean"]
        finally:
            host.stop()

    def test_wire_format_validated(self):
        from photon_ml_tpu_torch.serving.fleet import FleetRouter
        with pytest.raises(ValueError, match="wire_format"):
            FleetRouter(["http://127.0.0.1:1"], wire_format="msgpack")


# ---------------------------------------------------------------------------
# Against the reference, and ingress against HTTP
# ---------------------------------------------------------------------------

class TestAgainstReference:
    def test_coordinator_grants_the_references_leases(self):
        from photon_ml_tpu.serving.fleet import (
            FleetBudget as RefBudget,
            QuotaCoordinator as RefCoordinator,
        )

        t = [0.0]
        clock = lambda: t[0]  # noqa: E731
        mine = QuotaCoordinator([FleetBudget("acme", 100.0, burst_s=0.5)],
                                lease_ttl_s=2.0, clock=clock)
        theirs = RefCoordinator([RefBudget("acme", 100.0, burst_s=0.5)],
                                lease_ttl_s=2.0, clock=clock)
        script = [("h0", {"acme": 70.0}), ("h1", {"acme": 10.0}),
                  ("h2", {"acme": 0.0}), ("h0", {"acme": 50.0}),
                  ("h1", {"acme": 40.0})]
        for step, (host, demand) in enumerate(script):
            t[0] = 0.5 * step
            a = mine.renew(host, demand)
            b = theirs.renew(host, demand)
            assert {k: (v.rate_rps, v.burst, v.seq) for k, v in a.items()} \
                == {k: (v.rate_rps, v.burst, v.seq) for k, v in b.items()}
        t[0] = 10.0  # every lease expired: the shares are reclaimed
        assert mine.renew("h0", {"acme": 1.0})["acme"].rate_rps == \
            theirs.renew("h0", {"acme": 1.0})["acme"].rate_rps

    def test_shm_ingress_scores_bitwise_the_http_binary_path(self,
                                                             workload):
        from photon_ml_tpu_torch.serving import wire

        reqs = [workload.request(i) for i in range(8)]
        service = ScoringService(_wire_runtime(workload))
        with service:
            server, _ = start_http_server(service, port=0)
            ingress = ShmIngress(service, n_slots=4,
                                 slot_bytes=64 << 10).start()
            client = ShmIngressClient(ingress.name)
            try:
                via_ring = client.score_many(reqs, timeout_s=60.0)
                body = wire.encode_request(reqs)
                http = urllib.request.Request(
                    f"http://127.0.0.1:{server.server_address[1]}/score",
                    data=body,
                    headers={"Content-Type": wire.CONTENT_TYPE,
                             "Accept": wire.CONTENT_TYPE})
                with urllib.request.urlopen(http, timeout=60) as resp:
                    via_http = wire.decode_response(resp.read())
            finally:
                client.close()
                ingress.stop()
                server.shutdown()
                server.server_close()
        assert len(via_ring) == len(via_http) == 8
        for a, b in zip(via_ring, via_http):
            assert np.float64(a["score"]).tobytes() == \
                np.float64(b["score"]).tobytes()
            assert np.float64(a["mean"]).tobytes() == \
                np.float64(b["mean"]).tobytes()
