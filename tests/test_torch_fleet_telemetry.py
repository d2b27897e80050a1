"""The port's fleet aggregator (``telemetry/fleet.py``) against the JAX
package's, on the CPU.

Both aggregators are fed the same scripted scrape sequence — the hosts'
``/snapshot`` bodies as plain dicts, a host that drops off the network,
the ``telemetry.scrape`` fault site, membership changes — under the same
injected clock: every poll's report, ``slo_report()`` and the labelled
exposition must be equal.  Mirrors the fleet cases of
``tests/test_distributed_tracing.py`` (scrape degradation, edge-triggered
burn alerts, the host-labelled fold, membership aging) and the fleet HTTP
plane's lifecycle.
"""

import json
import os
import threading
import urllib.request

import pytest

from photon_ml_tpu import chaos as ref_chaos
from photon_ml_tpu import telemetry as ref_tel
from photon_ml_tpu_torch import chaos, telemetry
from photon_ml_tpu_torch.telemetry import FleetAggregator, SloPolicy
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

POLICIES = dict(
    latency=dict(name="latency-p99", p99_s=0.05, error_budget=0.01),
    errors=dict(name="errors", p99_s=None,
                error_counter="serving_errors_total", error_budget=0.05,
                fast_window_s=60.0, slow_window_s=600.0),
)


class _Hosts:
    """Live registries of a few hosts, built in the PORT's registry (the
    transport format is the reference's); ``down`` hosts fail the fetch
    like a dropped connection."""

    def __init__(self, ids):
        self.hubs = {hid: telemetry.Telemetry(enabled=True, sinks=[])
                     for hid in ids}
        self.down: set = set()

    def fetch(self, url, timeout_s):
        hid = url.split("//", 1)[1].split("/", 1)[0]
        if hid in self.down:
            raise ConnectionRefusedError(f"host {hid} unreachable")
        return {
            "transport": self.hubs[hid].metrics.transport_snapshot(),
            "host": {"host_id": hid, "pid": 4242},
            "pid": 4242,
        }

    def traffic(self, hid, fast=0, slow=0, errors=0, requests=0):
        hub = self.hubs[hid]
        lat = hub.histogram("serving_request_latency_seconds")
        for _ in range(fast):
            lat.observe(0.002)
        for _ in range(slow):
            lat.observe(1.0)
        if errors:
            hub.counter("serving_errors_total").inc(errors)
        if requests:
            hub.counter("serving_requests_total").inc(requests)


def _pair(hosts, clock, **kw):
    urls = {hid: f"http://{hid}" for hid in hosts.hubs}
    ours = FleetAggregator(
        urls, policies=[SloPolicy(**p) for p in POLICIES.values()],
        clock=clock, fetch=hosts.fetch, **kw)
    ref = ref_tel.FleetAggregator(
        urls, policies=[ref_tel.SloPolicy(**p) for p in POLICIES.values()],
        clock=clock, fetch=hosts.fetch, **kw)
    return ours, ref


class TestAgainstTheReference:
    def test_scripted_scrapes_give_the_references_verdicts(self):
        t = {"now": 1000.0}
        hosts = _Hosts(["h0", "h1"])
        ours, ref = _pair(hosts, lambda: t["now"], stale_drop_s=30.0)

        def round_(now, plan=None):
            t["now"] = now
            if plan is None:
                a, b = ours.poll_once(), ref.poll_once()
            else:
                with plan[0]:
                    a = ours.poll_once()
                with plan[1]:
                    b = ref.poll_once()
            assert a == b
            assert ours.slo_report() == ref.slo_report()
            assert ours.prometheus_text() == ref.prometheus_text()
            assert ours.registry.snapshot() == ref.registry.snapshot()
            return a

        for hid in hosts.hubs:
            hosts.traffic(hid, fast=100, requests=100)
        rep = round_(1000.0)
        assert not rep["policies"][0]["alerting"]

        hosts.down.add("h1")  # a host drops off mid-scrape
        hosts.traffic("h0", fast=10, errors=1, requests=10)
        rep = round_(1030.0)
        assert rep["hosts"]["h1"]["stale"] and rep["hosts"]["h1"][
            "failures"] == 1

        hosts.down.clear()
        hosts.traffic("h0", slow=20, errors=4, requests=20)
        hosts.traffic("h1", slow=20, requests=20)
        rep = round_(1060.0)
        assert rep["policies"][0]["alerting"]
        assert not rep["hosts"]["h1"]["stale"]
        rep = round_(1120.0)  # the same excursion: no second alert
        assert rep["policies"][0]["alerts"] == 1

        # Both hosts drop off through the telemetry.scrape fault site.
        plans = (chaos.FaultPlan([chaos.FaultSpec(
                     site="telemetry.scrape", at=0, count=2)]),
                 ref_chaos.FaultPlan([ref_chaos.FaultSpec(
                     site="telemetry.scrape", at=0, count=2)]))
        rep = round_(1150.0, plans)
        assert all(h["stale"] for h in rep["hosts"].values())
        assert plans[0].fired == plans[1].fired

        rep = round_(1120.0 + 7200.0)  # a quiet window re-arms
        assert not rep["policies"][0]["alerting"]
        hosts.traffic("h0", slow=30, requests=30)
        rep = round_(1120.0 + 7260.0)
        assert rep["policies"][0]["alerts"] == 2

        # Membership: h1 departs (stale now, dropped after 30 s), h2 joins.
        hosts.hubs["h2"] = telemetry.Telemetry(enabled=True, sinks=[])
        hosts.traffic("h2", fast=5, requests=5)
        t["now"] = 1120.0 + 7270.0
        members = {"h0": "http://h0", "h2": "http://h2"}
        assert ours.sync_membership(members) == ref.sync_membership(
            members) == {"added": ["h2"], "departed": ["h1"],
                         "returned": []}
        rep = round_(1120.0 + 7280.0)
        assert rep["hosts"]["h1"]["departed"]
        rep = round_(1120.0 + 7330.0)
        assert "h1" not in rep["hosts"]
        assert 'host="h1"' not in ours.prometheus_text()

    @pytest.mark.parametrize("kwargs", [
        dict(name="x", error_budget=0.0),
        dict(name="x", fast_window_s=0.0),
        dict(name="x", fast_window_s=10.0, slow_window_s=5.0),
        dict(name="x", p99_s=None),
    ])
    def test_policy_refusals_match_the_reference(self, kwargs):
        with pytest.raises(ValueError) as ours:
            SloPolicy(**kwargs)
        with pytest.raises(ValueError) as ref:
            ref_tel.SloPolicy(**kwargs)
        assert str(ours.value) == str(ref.value)

    def test_a_host_list_is_required(self):
        with pytest.raises(ValueError, match="at least one host"):
            FleetAggregator({})


class TestFleetPlane:
    def test_scrapes_live_exporters_and_serves_the_fold(self):
        """Two hosts' real exporters scraped over HTTP; the fleet plane's
        /metrics parses with per-host labels, /slo carries each host's
        identity, and stop() joins every thread."""
        before = {t.name for t in threading.enumerate()}
        hubs = {hid: telemetry.Telemetry(enabled=True, sinks=[])
                for hid in ("host-0", "host-1")}
        exporters = {}
        try:
            for i, (hid, hub) in enumerate(hubs.items()):
                hub.counter("serving_requests_total").inc(10 * (i + 1))
                hub.histogram("serving_request_latency_seconds").observe(
                    0.002)
                exporters[hid] = telemetry.MetricsExporter(
                    hub, port=0, host_id=hid).start()
            agg = FleetAggregator(
                {hid: f"http://127.0.0.1:{e.port}"
                 for hid, e in exporters.items()},
                policies=[SloPolicy(name="latency-p99", p99_s=0.05)],
                interval_s=0.01)
            with agg:
                agg.poll_once()
                port = agg.serve()
                bodies = {}
                for route in ("/metrics", "/slo", "/healthz"):
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{route}",
                            timeout=10) as resp:
                        bodies[route] = resp.read().decode()
                agg.start()  # the background loop stops with the plane
        finally:
            for e in exporters.values():
                e.close()
            for hub in hubs.values():
                hub.close()
        parsed = telemetry.parse_prometheus_text(bodies["/metrics"])
        assert parsed[("serving_requests_total", "")] == 30.0
        assert parsed[("serving_requests_total", '{host="host-0"}')] == 10.0
        assert parsed[("serving_requests_total", '{host="host-1"}')] == 20.0
        assert parsed[("fleet_hosts_count", "")] == 2.0
        slo = json.loads(bodies["/slo"])
        for hid, entry in slo["hosts"].items():
            assert entry["identity"]["host_id"] == hid
        assert json.loads(bodies["/healthz"])["status"] == "ok"
        leaked = {t.name for t in threading.enumerate()
                  if t.name.startswith(("fleet-", "telemetry-"))} - before
        assert not leaked

    def test_burn_alert_dumps_the_current_hubs_flight_recorder(
            self, tmp_path):
        hosts = _Hosts(["h0"])
        agg = FleetAggregator(
            {"h0": "http://h0"}, fetch=hosts.fetch,
            policies=[SloPolicy(name="latency-p99", p99_s=0.05)])
        with telemetry.Telemetry(output_dir=str(tmp_path)):
            hosts.traffic("h0", fast=100)
            agg.poll_once(now=1000.0)
            hosts.traffic("h0", slow=20)
            assert agg.poll_once(now=1060.0)["policies"][0]["alerting"]
        with open(os.path.join(tmp_path, "flightrecorder.json")) as f:
            dump = json.load(f)
        assert dump["reason"].startswith("slo.burn: latency-p99")
        assert dump["events"][-1]["name"] == "slo.burn"
