"""The port's cluster control plane (``photon_ml_tpu_torch/cluster``) on the
CPU, against the reference's ``tests/test_cluster.py`` contracts and
against the reference itself.

- Every case of ``tests/test_cluster.py``, run through the port with the
  same injected clock: membership expiry and healing, the registry's HTTP
  protocol, the watcher's convergence, the leader lease's failover and
  journal replay, the ``cluster.*`` fault sites, checksum-verified
  fetches, cold start, the remote applier, retention held by a silent
  subscriber.
- Across the packages: under one clock and one scripted sequence of
  renewals through a leader kill, the port's replicas grant the
  reference's leases field by field and write the same journal records
  (wall-clock stamps aside); each package's registry client speaks to the
  other package's registry server with equal member records; each
  package's publication client fetches byte-equal files from the other
  package's server, off a root the reference's publisher wrote.
- Cold start over HTTP, then the delta through ``RemoteApplier``: the
  port's scores are within 1e-6 of Σ|x·w| of the reference's runtime on
  the reference's cold-started model (the serving tolerance: the kernel's
  lane-strided sums against XLA's), and bitwise a port runtime built
  directly on the patched model.
- The registry's and the publication server's listen backlog is 128 (the
  reference's is the standard library's 5), the serving CLI's
  ``--membership``/``--fleet-join``/``--fleet-drain``, the selfcheck as a
  subprocess, and ``import photon_ml_tpu_torch.cluster`` without jax.
"""

import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from photon_ml_tpu_torch import chaos
from photon_ml_tpu_torch.cluster import (
    CoordinatorReplica,
    FetchError,
    HeartbeatAgent,
    MembershipRegistry,
    MembershipWatcher,
    NotLeaderError,
    PublicationClient,
    PublicationServer,
    RegistryClient,
    RemoteApplier,
    ReplicatedQuotaCoordinator,
    cold_start,
)
from photon_ml_tpu_torch.freshness.delta import DeltaError
from photon_ml_tpu_torch.freshness.publisher import (
    DeltaPublisher,
    read_acks,
    remove_ack,
    write_ack,
)
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clock:
    """Injectable monotonic clock: liveness tests advance time instead
    of sleeping through it."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# Membership registry
# ---------------------------------------------------------------------------

class TestMembershipRegistry:
    def test_register_heartbeat_and_expiry(self):
        clock = _Clock()
        registry = MembershipRegistry(heartbeat_ttl_s=1.0, clock=clock)
        member = registry.register("h0", "http://a:1/")
        assert member["state"] == "alive"
        assert member["url"] == "http://a:1"  # trailing slash normalized

        # A beat inside the TTL keeps the member alive across what
        # would otherwise be two expiry windows.
        clock.advance(0.9)
        assert registry.heartbeat("h0") is True
        clock.advance(0.9)
        assert "h0" in registry.members()

        # Silence past the TTL expires it, and beating the expired id
        # returns False — the registration record is gone.
        clock.advance(1.1)
        assert registry.members() == {}
        assert registry.heartbeat("h0") is False

        # Re-registering re-admits (the agent's healing path).
        registry.register("h0", "http://a:1")
        assert registry.members()["h0"]["state"] == "alive"

    def test_drain_keeps_member_visible_and_leave_removes(self):
        clock = _Clock()
        registry = MembershipRegistry(heartbeat_ttl_s=5.0, clock=clock)
        registry.register("h0", "http://a:1")
        assert registry.drain("h0") is True
        # Draining stays visible: the router needs to see it to finish
        # its in-flight work before removal.
        assert registry.members()["h0"]["state"] == "draining"
        assert registry.drain("nope") is False

        assert registry.leave("h0") is True
        assert registry.members() == {}
        assert registry.leave("h0") is False

    def test_heartbeat_cannot_resurrect_a_draining_member_as_alive(self):
        clock = _Clock()
        registry = MembershipRegistry(heartbeat_ttl_s=5.0, clock=clock)
        registry.register("h0", "http://a:1")
        registry.drain("h0")
        assert registry.heartbeat("h0") is True  # still a member...
        assert registry.members()["h0"]["state"] == "draining"  # ...but


class TestRegistryHTTP:
    def test_protocol_roundtrip_over_the_wire(self):
        registry = MembershipRegistry(heartbeat_ttl_s=5.0).serve()
        try:
            client = RegistryClient(registry.base_url)
            member = client.register(
                "h0", "http://a:1", metrics_url="http://a:2"
            )
            assert member["host_id"] == "h0"
            assert member["metrics_url"] == "http://a:2"
            assert set(client.members()) == {"h0"}
            assert client.heartbeat("h0") is True
            # Unknown id rides the 410 Gone contract back as False —
            # the verdict the HeartbeatAgent re-registers on.
            assert client.heartbeat("ghost") is False
            assert client.drain("ghost") is False
            assert client.drain("h0") is True
            assert client.members()["h0"]["state"] == "draining"
            assert client.leave("h0") is True
            assert client.members() == {}
        finally:
            registry.close()


class TestHeartbeatAgent:
    def test_register_then_beat_then_heal_after_expiry(self):
        clock = _Clock()
        registry = MembershipRegistry(heartbeat_ttl_s=1.0, clock=clock)
        agent = HeartbeatAgent(
            registry, "h0", "http://a:1", interval_s=0.5
        )
        assert agent.beat_once() is True  # registers
        assert agent.beat_once() is True  # beats
        assert agent.beats == 1

        # Expire the member (a stall longer than the TTL), then watch
        # the agent heal: one False beat flips it back to registering,
        # the next cycle re-admits the host.
        clock.advance(1.5)
        assert agent.beat_once() is False
        assert agent.reregisters == 1
        assert agent.beat_once() is True
        assert registry.members()["h0"]["state"] == "alive"

    def test_chaos_heartbeat_site_counts_failure_then_recovers(self):
        registry = MembershipRegistry(heartbeat_ttl_s=5.0)
        agent = HeartbeatAgent(
            registry, "h0", "http://a:1", interval_s=0.5
        )
        plan = chaos.FaultPlan([
            chaos.FaultSpec(site="cluster.heartbeat", at=0, count=1),
        ])
        with plan:
            assert agent.beat_once() is False
            assert agent.beat_failures == 1
            # A lost beat is not fatal: the next cycle registers.
            assert agent.beat_once() is True
        assert plan.fired and plan.fired[0]["site"] == "cluster.heartbeat"
        assert "h0" in registry.members()


class _FakeRouter:
    """Records join/drain calls; mimics FleetRouter.healthz()'s host
    rows (url / hid / state)."""

    def __init__(self):
        self.hosts = {}  # url -> [hid, state]
        self.joins = []
        self.drains = []
        self._n = 0

    def healthz(self):
        return {"hosts": [
            {"url": url, "hid": hid, "state": state}
            for url, (hid, state) in self.hosts.items()
        ]}

    def join(self, url):
        self.joins.append(url)
        hid = f"host{self._n}"
        self._n += 1
        self.hosts[url] = [hid, "healthy"]
        return hid

    def drain(self, hid, timeout_s=None):
        self.drains.append(hid)
        for entry in self.hosts.values():
            if entry[0] == hid:
                entry[1] = "removed"
        return True


class _FakeAggregator:
    def __init__(self):
        self.synced = []

    def sync_membership(self, hosts):
        self.synced.append(dict(hosts))


class TestMembershipWatcher:
    def test_converges_router_and_aggregator_to_membership(self):
        registry = MembershipRegistry(heartbeat_ttl_s=60.0)
        router, aggregator = _FakeRouter(), _FakeAggregator()
        watcher = MembershipWatcher(registry, router, aggregator)

        registry.register("h0", "http://a:1", metrics_url="http://a:2")
        assert watcher.poll_once() is True
        assert router.joins == ["http://a:1"]
        # The aggregator sees metrics_url, not the serving url.
        assert aggregator.synced[-1] == {"h0": "http://a:2"}

        # Draining in the registry drains the router; the member stays
        # in the aggregator view (departure needs leave/expiry).
        registry.drain("h0")
        watcher.poll_once()
        assert router.drains == ["host0"]
        assert "h0" in aggregator.synced[-1]

        # A removed routed entry re-joins when the host comes back.
        registry.leave("h0")
        watcher.poll_once()
        assert "h0" not in aggregator.synced[-1]
        registry.register("h0", "http://a:1")
        watcher.poll_once()
        assert router.joins == ["http://a:1", "http://a:1"]

    def test_registry_outage_keeps_last_converged_state(self):
        # Nothing listens on this port: the read fails fast, and the
        # watcher must keep the last converged state, not drain anyone.
        router = _FakeRouter()
        router.join("http://a:1")
        watcher = MembershipWatcher(
            RegistryClient("http://127.0.0.1:1", timeout_s=0.2), router
        )
        assert watcher.poll_once() is False
        assert watcher.poll_failures == 1
        assert router.drains == []


# ---------------------------------------------------------------------------
# Replicated quota coordination
# ---------------------------------------------------------------------------

def _replica_pair(tmp_path, clock, lease_ttl_s=10.0, leader_ttl_s=1.0):
    store = str(tmp_path / "coord")
    budgets = {"t": 100.0}
    r0 = CoordinatorReplica(
        "r0", store, budgets, lease_ttl_s=lease_ttl_s,
        leader_ttl_s=leader_ttl_s, clock=clock, fsync=False,
    )
    r1 = CoordinatorReplica(
        "r1", store, budgets, lease_ttl_s=lease_ttl_s,
        leader_ttl_s=leader_ttl_s, clock=clock, fsync=False,
    )
    return r0, r1, ReplicatedQuotaCoordinator([r0, r1])


class TestReplicatedCoordination:
    def test_first_renew_elects_and_followers_refuse_with_hint(
        self, tmp_path
    ):
        clock = _Clock()
        r0, r1, rc = _replica_pair(tmp_path, clock)
        leases = rc.renew("hA", {"t": 50.0})
        assert leases["t"].rate_rps > 0
        assert rc.leader() == "r0"
        assert r0.term == 1 and r0.is_leader()
        with pytest.raises(NotLeaderError) as exc:
            r1.renew("hA", {"t": 50.0})
        assert exc.value.leader_hint == "r0"

    def test_kill_fails_over_and_replay_preserves_budget_bound(
        self, tmp_path
    ):
        clock = _Clock()
        r0, r1, rc = _replica_pair(tmp_path, clock)
        a = rc.renew("hA", {"t": 100.0})["t"]
        b = rc.renew("hB", {"t": 100.0})["t"]
        assert a.rate_rps + b.rate_rps <= 100.0 + 1e-6

        # Kill the leader.  Its lease is deliberately not released, so
        # failover must ride the lease expiry.
        r0.kill()
        clock.advance(1.5)  # > leader_ttl_s, << lease_ttl_s
        a2 = rc.renew("hA", {"t": 100.0})["t"]
        assert rc.leader() == "r1"
        assert rc.failovers == 1
        assert r1.term == 2

        # hB's grant was replayed from the journal: it is still live
        # (its lease has not expired), so the new leader's grant to hA
        # must leave room for it — the invariant survives the handoff.
        b2 = rc.renew("hB", {"t": 100.0})["t"]
        assert a2.rate_rps + b2.rate_rps <= 100.0 + 1e-6
        records = r1._read_journal()
        election = [
            r for r in records
            if r.get("kind") == "election" and r["term"] == 2
        ]
        assert election and election[0]["replayed_grants"] == 2

        # A restarted replica comes back as a follower, never resumes
        # its stale term.
        r0.restart()
        with pytest.raises(NotLeaderError):
            r0.renew("hA", {"t": 100.0})

    def test_torn_journal_tail_is_tolerated_on_replay(self, tmp_path):
        clock = _Clock()
        r0, r1, rc = _replica_pair(tmp_path, clock)
        rc.renew("hA", {"t": 100.0})
        # Simulate the journal writer dying mid-line.
        with open(r0._journal_path, "a") as f:
            f.write('{"kind": "gra')
        r0.kill()
        clock.advance(1.5)
        leases = rc.renew("hA", {"t": 100.0})
        assert leases["t"].rate_rps > 0
        assert r1.term == 2

    def test_chaos_lease_site_moves_the_walk_to_the_next_replica(
        self, tmp_path
    ):
        clock = _Clock()
        r0, r1, rc = _replica_pair(tmp_path, clock)
        rc.renew("hA", {"t": 100.0})
        # Expire the leader lease so the surviving replica CAN take
        # over when the fault knocks out the path to r0.
        clock.advance(1.5)
        plan = chaos.FaultPlan([
            chaos.FaultSpec(site="cluster.lease", at=0, count=1),
        ])
        with plan:
            leases = rc.renew("hA", {"t": 100.0})
        assert plan.fired and plan.fired[0]["site"] == "cluster.lease"
        assert leases["t"].rate_rps > 0
        assert rc.leader() == "r1"
        assert rc.failovers == 1

    def test_every_replica_faulted_is_the_full_partition(self, tmp_path):
        clock = _Clock()
        _r0, _r1, rc = _replica_pair(tmp_path, clock)
        plan = chaos.FaultPlan([
            chaos.FaultSpec(site="cluster.lease", at=0, count=10),
        ])
        with plan, pytest.raises(RuntimeError, match="UNAVAILABLE"):
            rc.renew("hA", {"t": 100.0})


# ---------------------------------------------------------------------------
# Publication-based model distribution
# ---------------------------------------------------------------------------

def _model_dir(tmp_path) -> str:
    model = tmp_path / "model"
    (model / "sub").mkdir(parents=True)
    (model / "weights.bin").write_bytes(b"\x00\x01\x02" * 100)
    (model / "meta.json").write_text('{"kind": "test-model"}')
    (model / "sub" / "nested.bin").write_bytes(b"nested-bytes")
    return str(model)


def _read_tree(root: str) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


@pytest.fixture()
def pub_root(tmp_path):
    root = str(tmp_path / "pubroot")
    publisher = DeltaPublisher(root, fsync=False)
    publisher.publish_snapshot(_model_dir(tmp_path))
    return root, publisher


@pytest.fixture()
def pub_server(pub_root):
    root, publisher = pub_root
    server = PublicationServer(root).serve()
    yield root, publisher, server
    server.close()


class TestDistribution:
    def test_fetch_is_bitwise_faithful_and_idempotent(
        self, pub_server, tmp_path
    ):
        root, _publisher, server = pub_server
        client = PublicationClient(
            server.base_url, str(tmp_path / "cache")
        )
        pubs = client.publications()
        assert [p.kind for p in pubs] == ["snapshot"]
        local = client.fetch(pubs[0])
        served = _read_tree(local)
        original = {
            k: v for k, v in _read_tree(
                os.path.join(root, f"snapshot-{pubs[0].seq:06d}")
            ).items()
        }
        assert served == original  # manifest rides along, byte-equal
        # Second fetch returns the cached dir without touching the
        # wire: the atomic rename is the completeness marker.
        assert client.fetch(pubs[0]) == local
        assert client.fetches == 1

    def test_chaos_fetch_site_retries_then_exhausts(
        self, pub_server, tmp_path
    ):
        _root, _publisher, server = pub_server
        client = PublicationClient(
            server.base_url, str(tmp_path / "cache-a")
        )
        pub = client.publications()[0]
        plan = chaos.FaultPlan([
            chaos.FaultSpec(site="cluster.fetch", at=0, count=1),
        ])
        with plan:
            local = client.fetch(pub)
        assert plan.fired and plan.fired[0]["site"] == "cluster.fetch"
        assert os.path.isdir(local)
        assert client.fetch_retries == 1

        # Exhausted retries refuse the artifact, and nothing
        # half-fetched is visible at the final path.
        client2 = PublicationClient(
            server.base_url, str(tmp_path / "cache-b"), retries=1,
        )
        with chaos.FaultPlan([
            chaos.FaultSpec(site="cluster.fetch", at=0, count=50),
        ]):
            with pytest.raises(FetchError, match="attempts"):
                client2.fetch(pub)
        assert not os.path.isdir(client2._local_dir(pub))

    def test_tampered_artifact_is_refused(self, pub_server, tmp_path):
        root, _publisher, server = pub_server
        client = PublicationClient(
            server.base_url, str(tmp_path / "cache")
        )
        pub = client.publications()[0]
        victim = os.path.join(
            root, f"snapshot-{pub.seq:06d}", "model", "weights.bin"
        )
        with open(victim, "r+b") as f:
            f.write(b"\xff")
        with pytest.raises(FetchError, match="sha256 mismatch"):
            client.fetch(pub)
        assert not os.path.isdir(client._local_dir(pub))

    def test_blob_route_refuses_path_traversal(self, pub_server):
        _root, _publisher, server = pub_server
        host, port = server.base_url[len("http://"):].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=5)
        try:
            # Raw http.client request: urllib would normalize the
            # "../" away before it ever reached the server.
            conn.request("GET", "/blob/1/../publish_journal.jsonl")
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 403
            assert "escapes" in body["error"]
        finally:
            conn.close()

    def test_cold_start_fetches_newest_snapshot_and_acks(
        self, pub_server, tmp_path
    ):
        root, _publisher, server = pub_server
        client = PublicationClient(
            server.base_url, str(tmp_path / "cache")
        )
        model_dir, pub = cold_start(client, subscriber_id="cold1")
        assert pub.kind == "snapshot"
        assert os.path.basename(model_dir) == "model"
        with open(os.path.join(model_dir, "meta.json")) as f:
            assert json.load(f)["kind"] == "test-model"
        # The ack registers the host with retention at the snapshot
        # seq, so every later delta is held until applied.
        assert read_acks(root)["cold1"] == pub.seq

    def test_cold_start_without_snapshot_is_a_pointed_error(
        self, tmp_path
    ):
        root = str(tmp_path / "empty-root")
        DeltaPublisher(root, fsync=False)  # settles an empty root
        server = PublicationServer(root).serve()
        try:
            client = PublicationClient(
                server.base_url, str(tmp_path / "cache")
            )
            with pytest.raises(DeltaError, match="publish_snapshot"):
                cold_start(client)
        finally:
            server.close()

    def test_remote_applier_applies_in_order_and_never_retries(
        self, pub_server, tmp_path
    ):
        root, publisher, server = pub_server
        publisher.publish_snapshot(
            os.path.join(root, "snapshot-000001", "model")
        )
        client = PublicationClient(
            server.base_url, str(tmp_path / "cache")
        )
        service = SimpleNamespace(reloads=[])

        def reload(path, mode=None):
            service.reloads.append((os.path.basename(path), mode))
            return SimpleNamespace(
                status="swapped", stage=None, reason=None
            )

        service.reload = reload
        applier = RemoteApplier(service, client, "subA", start_seq=0)
        results = applier.poll_once()
        assert [r.status for r in results] == ["swapped", "swapped"]
        assert applier.applied_seq == 2
        assert service.reloads == [("model", None), ("model", None)]
        assert read_acks(root)["subA"] == 2

        # A failed apply is recorded once and NEVER retried — the
        # runbook escalates to a fresh cold start instead.
        publisher.publish_snapshot(
            os.path.join(root, "snapshot-000001", "model")
        )
        service.reload = lambda path, mode=None: SimpleNamespace(
            status="rolled_back", stage="validate", reason="boom"
        )
        applier.poll_once()
        assert applier.failed == [3]
        assert applier.poll_once() == []
        assert applier.failed == [3]


# ---------------------------------------------------------------------------
# Retention vs. remote subscribers (the never-acking host)
# ---------------------------------------------------------------------------

class TestRetentionBlockedBySubscriber:
    def test_blocking_names_the_guilty_id_and_unregister_releases(
        self, tmp_path
    ):
        root = str(tmp_path / "root")
        publisher = DeltaPublisher(root, fsync=False)
        model = _model_dir(tmp_path)
        for _ in range(3):
            publisher.publish_snapshot(model)  # seqs 1, 2, 3

        # A subscriber registered at seq 1 and then went silent: seq 1
        # prunes (it acked it), seq 2 is held — and the summary NAMES
        # the holder, so the operator knows exactly who to chase.
        write_ack(root, "laggard", 1)
        summary = publisher.retain(keep_last=1)
        assert summary["pruned"] == [1]
        assert summary["blocked"] == [2]
        assert summary["blocking"] == {2: ["laggard"]}
        assert os.path.isdir(os.path.join(root, "snapshot-000002"))

        # Unregistering the dead subscriber releases the prune.
        assert remove_ack(root, "laggard") is True
        summary = publisher.retain(keep_last=1)
        assert summary["pruned"] == [2]
        assert summary["blocked"] == []
        assert summary["kept"] == [3]
        assert not os.path.isdir(os.path.join(root, "snapshot-000002"))


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def _strip_wall(obj):
    """``obj`` without its wall-clock stamps (the only fields two runs
    cannot share)."""
    if isinstance(obj, dict):
        return {k: _strip_wall(v) for k, v in obj.items()
                if k not in ("registered_wall_epoch", "wall_epoch")}
    if isinstance(obj, list):
        return [_strip_wall(v) for v in obj]
    return obj


def _lease_script(coordination, store):
    """One scripted renewal sequence through a leader kill, a refused
    renewal while the dead leader's lease is live, the failover, a
    restart and an expiry; returns (trace, the new leader's journal)."""
    clock = _Clock()
    budgets = {"a": 100.0, "b": 30.0}
    r0, r1 = (coordination.CoordinatorReplica(
        rid, store, budgets, lease_ttl_s=10.0, leader_ttl_s=1.0,
        clock=clock, fsync=False) for rid in ("r0", "r1"))
    rc = coordination.ReplicatedQuotaCoordinator([r0, r1])
    trace = []

    def renew(host, demands):
        try:
            leases = rc.renew(host, demands)
        except RuntimeError as exc:
            trace.append(("refused", str(exc)))
            return
        trace.append((host, rc.leader(), r0.term, r1.term, rc.failovers,
                      {t: dataclasses.asdict(lease)
                       for t, lease in leases.items()}))

    renew("hA", {"a": 80.0, "b": 10.0})
    renew("hB", {"a": 50.0, "b": 40.0})
    clock.advance(0.3)
    renew("hA", {"a": 80.0, "b": 5.0})
    clock.advance(0.4)
    r0.kill()
    renew("hB", {"a": 50.0})
    clock.advance(1.0)
    renew("hB", {"a": 50.0, "b": 40.0})
    renew("hA", {"a": 100.0})
    r0.restart()
    clock.advance(0.6)
    renew("hA", {"a": 20.0, "b": 30.0})
    clock.advance(11.0)
    renew("hB", {"a": 100.0, "b": 100.0})
    with r1._lock:
        journal = r1._read_journal()
    for r in (r0, r1):
        r.close()
    return trace, _strip_wall(journal)


def _membership_script(client):
    """Every registry verb through ``client``, answers in order."""
    return _strip_wall([
        client.register("h0", "http://a:1/", metrics_url="http://a:2"),
        client.register("h1", "http://b:1"),
        client.heartbeat("h0"),
        client.heartbeat("ghost"),
        client.drain("h1"),
        client.drain("ghost"),
        client.members(),
        client.leave("h0"),
        client.leave("h0"),
        client.members(),
    ])


@pytest.fixture(scope="module")
def ref_root(tmp_path_factory):
    """A publication root the REFERENCE's publisher wrote: a snapshot of
    its synthetic GAME model, then a delta moving 5 entities' rows."""
    from photon_ml_tpu.freshness.delta import diff_game_models
    from photon_ml_tpu.freshness.publisher import (
        DeltaPublisher as RefPublisher,
    )
    from photon_ml_tpu.io.game_store import save_game_model
    from photon_ml_tpu.serving.synthetic import SyntheticWorkload

    tmp = tmp_path_factory.mktemp("ref_root")
    base = SyntheticWorkload(n_entities=32, seed=7)
    target = SyntheticWorkload(n_entities=32, seed=7)
    re = target.model.models["per_entity"]
    for k in [f"u{i}" for i in range(5)]:
        cols, vals = re.coefficients[k]
        re.coefficients[k] = (cols,
                              (vals + np.float32(0.25)).astype(np.float32))
    model_dir = str(tmp / "model")
    save_game_model(base.model, base.index_maps, model_dir)
    root = str(tmp / "pubs")
    publisher = RefPublisher(root, fsync=False)
    snap = publisher.publish_snapshot(model_dir)
    delta = publisher.publish(diff_game_models(base.model, target.model,
                                               event_wall_epoch=1.0))
    return SimpleNamespace(root=root, snap=snap, delta=delta,
                           workload=base)


class TestAgainstReference:
    def test_replicas_grant_the_references_leases_through_a_failover(
            self, tmp_path):
        from photon_ml_tpu.cluster import coordination as ref_coordination
        from photon_ml_tpu_torch.cluster import coordination

        ours = _lease_script(coordination, str(tmp_path / "port"))
        theirs = _lease_script(ref_coordination, str(tmp_path / "ref"))
        assert ours == theirs
        trace, journal = ours
        # The kill refused one renewal (the dead leader's lease was live),
        # the next moved leadership to r1 (term 2), and r1 took a third
        # term once its own lease lapsed in the idle 11 s.
        assert [step[0] for step in trace].count("refused") == 1
        assert [step[1:5] for step in trace[4:]] == \
            [("r1", 1, 2, 1)] * 3 + [("r1", 1, 3, 1)]
        assert [r["term"] for r in journal if r["kind"] == "election"] == \
            [1, 2, 3]

    @pytest.mark.parametrize("client_pkg,server_pkg", [
        ("port", "ref"), ("ref", "port"), ("port", "port")])
    def test_registries_interoperate_both_ways(self, client_pkg,
                                               server_pkg):
        from photon_ml_tpu.cluster import membership as ref_membership
        from photon_ml_tpu_torch.cluster import membership

        pkgs = {"port": membership, "ref": ref_membership}
        registry = pkgs[server_pkg].MembershipRegistry(
            heartbeat_ttl_s=60.0).serve()
        try:
            got = _membership_script(
                pkgs[client_pkg].RegistryClient(registry.base_url))
        finally:
            registry.close()
        local = _membership_script(
            ref_membership.RegistryClient(
                ref_membership.MembershipRegistry(heartbeat_ttl_s=60.0)))
        assert got == local

    @pytest.mark.parametrize("client_pkg,server_pkg", [
        ("port", "ref"), ("ref", "port")])
    def test_publication_servers_interoperate_byte_for_byte(
            self, ref_root, tmp_path, client_pkg, server_pkg):
        from photon_ml_tpu.cluster import distribution as ref_distribution
        from photon_ml_tpu_torch.cluster import distribution

        pkgs = {"port": distribution, "ref": ref_distribution}
        server = pkgs[server_pkg].PublicationServer(ref_root.root).serve()
        try:
            client = pkgs[client_pkg].PublicationClient(
                server.base_url, str(tmp_path / "cache"))
            pubs = client.publications()
            assert [(p.seq, p.kind) for p in pubs] == \
                [(1, "snapshot"), (2, "delta")]
            for pub in pubs:
                local = client.fetch(pub)
                want = _read_tree(os.path.join(
                    ref_root.root, f"{pub.kind}-{pub.seq:06d}"))
                assert want and _read_tree(local) == want
        finally:
            server.close()

    def test_cold_start_and_delta_score_as_the_reference(self, ref_root,
                                                         tmp_path):
        """The port cold-starts over HTTP and applies the delta through
        ``RemoteApplier``: within 1e-6 of Σ|x·w| of the reference doing
        the same, and bitwise a port runtime on the patched model."""
        from photon_ml_tpu.cluster import distribution as ref_distribution
        from photon_ml_tpu.serving.batcher import (
            BatcherConfig as RefBatcherConfig,
        )
        from photon_ml_tpu.serving.runtime import (
            RuntimeConfig as RefRuntimeConfig,
        )
        from photon_ml_tpu.serving.runtime import (
            ScoringRuntime as RefRuntime,
        )
        from photon_ml_tpu.serving.service import (
            ScoringService as RefService,
        )
        from photon_ml_tpu_torch.freshness.delta import (
            apply_delta,
            read_delta,
        )
        from photon_ml_tpu_torch.serving import kernels
        from photon_ml_tpu_torch.serving.batcher import BatcherConfig
        from photon_ml_tpu_torch.serving.runtime import (
            RuntimeConfig,
            ScoringRuntime,
        )
        from photon_ml_tpu_torch.serving.service import ScoringService

        w = ref_root.workload
        requests = [w.request(i) for i in range(24)]
        server = PublicationServer(ref_root.root).serve()
        try:
            # The port's cold host.
            client = PublicationClient(server.base_url,
                                       str(tmp_path / "port_cache"))
            local, pub = cold_start(client, subscriber_id="port")
            cfg = RuntimeConfig(max_batch_size=8, hot_entities=8,
                                device="cpu")
            with ScoringService(ScoringRuntime.load(local, cfg),
                                BatcherConfig(max_batch_size=8)) as svc:
                applier = RemoteApplier(svc, client, "port",
                                        start_seq=pub.seq)
                assert [r.status for r in applier.poll_once()] == \
                    ["swapped"]
                ours = np.asarray([svc.score(r, timeout=60)["score"]
                                   for r in requests], np.float32)
            # The applied delta, from the cache (no wire: fetched).
            delta_dir = client.fetch(client.publications()[1])
            assert read_acks(ref_root.root)["port"] == 2
            # The reference's cold host, from the same server.
            ref_client = ref_distribution.PublicationClient(
                server.base_url, str(tmp_path / "ref_cache"))
            ref_local, ref_pub = ref_distribution.cold_start(ref_client)
            ref_cfg = RefRuntimeConfig(max_batch_size=8, hot_entities=8)
            with RefService(RefRuntime.load(ref_local, ref_cfg),
                            RefBatcherConfig(max_batch_size=8)) as ref_svc:
                ref_applier = ref_distribution.RemoteApplier(
                    ref_svc, ref_client, "ref", start_seq=ref_pub.seq)
                assert [r.status for r in ref_applier.poll_once()] == \
                    ["swapped"]
                theirs = np.asarray(
                    [ref_svc.score(r, timeout=60)["score"]
                     for r in requests], np.float32)
        finally:
            server.close()
        # A port runtime built directly on the patched model.
        model, imaps = ScoringRuntime.load_model(local, device="cpu")
        patched = apply_delta(model, read_delta(delta_dir))
        fresh = ScoringRuntime(patched, imaps, cfg)
        rows = [fresh.parse_request(r) for r in requests]
        want = np.asarray([fresh.score_rows([r])[0][0] for r in rows],
                          np.float32)
        assert ours.tobytes() == want.tobytes()
        # Σ|x·w| of each row on the patched model.
        fixed = patched.models["fixed"].model.coefficients.means
        wf = np.asarray(fixed, np.float64)
        re = patched.models["per_entity"]
        scale = []
        for r in rows:
            s = abs(r.offset) + np.abs(
                r.features[w.fixed_shard].astype(np.float64) * wf).sum()
            key = r.ids.get(w.entity_key)
            if key in re.coefficients:
                coef = kernels.dense_coefficient_rows(re, [key])[0]
                s += np.abs(r.features[w.re_shard].astype(np.float64)
                            * coef).sum()
            scale.append(s)
        err = np.abs(ours.astype(np.float64) - theirs) / np.asarray(scale)
        assert err.max() <= 1e-6


# ---------------------------------------------------------------------------
# Deliberate differences, the CLIs, import hygiene
# ---------------------------------------------------------------------------

class TestListenBacklog:
    @pytest.mark.parametrize("module,server,handler", [
        ("membership", "_RegistryServer", "_RegistryHandler"),
        ("distribution", "_PubServer", "_PubHandler")])
    def test_server_takes_a_fleets_connections_at_once(self, module,
                                                       server, handler,
                                                       tmp_path):
        """32 connections queued before the server accepts any are all
        served (the serving host's backlog of 128; the reference's
        servers keep the standard library's 5)."""
        import importlib

        from photon_ml_tpu.cluster import distribution as ref_distribution
        from photon_ml_tpu.cluster import membership as ref_membership

        mod = importlib.import_module(f"photon_ml_tpu_torch.cluster.{module}")
        ref = {"membership": ref_membership,
               "distribution": ref_distribution}[module]
        assert getattr(mod, server).request_queue_size == 128
        assert getattr(ref, server).request_queue_size == 5
        srv = getattr(mod, server)(("127.0.0.1", 0), getattr(mod, handler))
        if module == "membership":
            srv.registry = MembershipRegistry()
        else:
            DeltaPublisher(str(tmp_path), fsync=False)
            srv.pub_root = str(tmp_path)
        socks, thread = [], None
        try:
            for _ in range(32):
                s = socket.create_connection(srv.server_address,
                                             timeout=2.0)
                socks.append(s)
                s.sendall(b"GET /healthz HTTP/1.1\r\nHost: h\r\n"
                          b"Connection: close\r\n\r\n")
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            for s in socks:
                s.settimeout(10.0)
                assert s.recv(64).startswith(b"HTTP/1.1 200"), \
                    "a queued connection was not served"
        finally:
            for s in socks:
                s.close()
            if thread is not None:
                srv.shutdown()
                thread.join(timeout=10)
            srv.server_close()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


class TestServingCliMembership:
    def test_server_registers_heartbeats_and_leaves_on_shutdown(self):
        registry = MembershipRegistry(heartbeat_ttl_s=2.0).serve()
        drained = []
        drain = registry.drain
        registry.drain = lambda hid: drained.append(hid) or drain(hid)
        proc = subprocess.Popen(
            [sys.executable, "-m", "photon_ml_tpu_torch.serving",
             "--synthetic", "64", "--device", "cpu", "--port", "0",
             "--membership", registry.base_url, "--host-id", "h0"],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            url = None
            for line in proc.stdout:
                if line.startswith("serving on "):
                    url = line.split()[2]
                    break
            assert url is not None, proc.stderr.read()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                member = registry.members().get("h0")
                if member is not None and member["heartbeats"] >= 1:
                    break
                time.sleep(0.05)
            assert member is not None and member["heartbeats"] >= 1
            assert member["url"] == url and member["state"] == "alive"
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=60) == 0
            assert drained == ["h0"]
            assert registry.members() == {}
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
            proc.stderr.close()
            registry.close()

    def test_fleet_verbs_change_the_registrys_member_states(self, capsys):
        from photon_ml_tpu_torch.serving.__main__ import main

        registry = MembershipRegistry(heartbeat_ttl_s=60.0).serve()
        try:
            base = ["--membership", registry.base_url]
            assert main([*base, "--fleet-join", "http://127.0.0.1:9/"]) == 0
            assert registry.members()["127.0.0.1:9"]["state"] == "alive"
            assert main([*base, "--fleet-join", "http://127.0.0.1:8",
                         "--host-id", "h8"]) == 0
            assert main([*base, "--fleet-drain", "h8"]) == 0
            members = registry.members()
            assert members["h8"]["state"] == "draining"
            assert members["h8"]["url"] == "http://127.0.0.1:8"
            assert main([*base, "--fleet-drain", "ghost"]) == 1
            assert "'ghost' is not a member" in capsys.readouterr().err
        finally:
            registry.close()


class TestClusterCli:
    def test_selfcheck_passes_on_the_cpu(self, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "photon_ml_tpu_torch.cluster",
             "--selfcheck", "--device", "cpu", "--output-dir",
             str(tmp_path)],
            cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr
        assert "cluster selfcheck PASSED" in out.stdout
        assert "bit-identical" in out.stdout

    def test_registry_utilities(self, capsys):
        from photon_ml_tpu_torch.cluster.__main__ import main

        registry = MembershipRegistry(heartbeat_ttl_s=60.0).serve()
        try:
            registry.register("h0", "http://a:1")
            assert main(["--registry", registry.base_url, "--members"]) == 0
            members = json.loads(capsys.readouterr().out)
            assert list(members) == ["h0"]
            assert members["h0"]["url"] == "http://a:1"
        finally:
            registry.close()
        assert main(["--members"]) == 2

    def test_selfcheck_without_a_card_refuses(self, monkeypatch):
        import torch

        from photon_ml_tpu_torch.cluster.__main__ import main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--selfcheck"])

    def test_import_leaves_jax_out(self):
        out = subprocess.run(
            [sys.executable, "-c",
             "import sys, photon_ml_tpu_torch.cluster, "
             "photon_ml_tpu_torch.cluster.__main__; "
             "print('jax' in sys.modules, "
             "any(m.split('.')[0] == 'photon_ml_tpu' for m in sys.modules))"],
            cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["False", "False"]
