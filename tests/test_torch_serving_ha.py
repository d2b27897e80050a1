"""Replica supervision in the port, on the CPU — the reference's
``tests/test_serving_ha.py::TestSupervisor`` and its supervisor swap
case, with the scores held bitwise against a single port runtime.

In-process replicas are runtimes on the CPU (``device="cpu"``); the
worker-process form of the same supervisor is
``tests/test_torch_serving_proc.py``.
"""

import random
import threading
import time

import numpy as np
import pytest

from photon_ml_tpu.serving.supervisor import (
    ReplicaSupervisor as RefSupervisor,
)
from photon_ml_tpu_torch import chaos
from photon_ml_tpu_torch.io.game_store import save_game_model
from photon_ml_tpu_torch.serving import loadgen
from photon_ml_tpu_torch.serving.batcher import BatcherConfig, RejectedError
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.service import ScoringService
from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from photon_ml_tpu_torch.serving.tenancy import TenancyConfig, TenantSpec
from photon_ml_tpu_torch.utils.watchdog import RetryPolicy
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


@pytest.fixture(scope="module")
def workload():
    return SyntheticWorkload(n_entities=32, seed=7)


@pytest.fixture(scope="module")
def workload_v2():
    return SyntheticWorkload(n_entities=32, seed=8)


def _runtime(workload, **kwargs):
    cfg = RuntimeConfig(**{"max_batch_size": 8, "hot_entities": 8,
                           "device": "cpu", **kwargs})
    return ScoringRuntime(workload.model, workload.index_maps, cfg)


def _reference(workload, requests):
    runtime = _runtime(workload)
    return np.asarray([runtime.score_rows([runtime.parse_request(r)])[0][0]
                       for r in requests], np.float32)


def _wait_until(predicate, timeout_s=10.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


class TestSupervisor:
    def test_kill_replica_zero_failed_requests(self, workload):
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=2,
                                probe_interval_s=0.05)
        with sup:
            requests = [workload.request(i) for i in range(48)]
            rows = [sup.parse_request(r) for r in requests]
            futures = [sup.submit(r) for r in rows[:24]]
            sup.kill_replica(0)
            futures += [sup.submit(r) for r in rows[24:]]
            got = np.asarray([np.float32(f.result(timeout=30)["score"])
                              for f in futures], np.float32)
            assert got.tobytes() == _reference(workload, requests).tobytes()
            assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
            assert sup.stats()["replicas"][0]["restarts"] == 1

    def test_kill_costs_zero_errors_under_load(self, workload):
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=2,
                                probe_interval_s=0.05)
        service = ScoringService(sup)
        with service:
            killer = threading.Timer(0.3, lambda: sup.kill_replica(1))
            killer.start()
            report = loadgen.open_loop(service.submit, workload.request,
                                       rate_rps=150.0, duration_s=1.5)
            killer.join()
        assert report.errors == 0, report.snapshot()
        assert report.rejected == 0, report.snapshot()
        assert report.completed > 50

    def test_chaos_replica_site_reroutes(self, workload):
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=2,
                                probe_interval_s=10.0)
        plan = chaos.FaultPlan([chaos.FaultSpec(site="serving.replica",
                                                at=0)])
        with sup:
            row = sup.parse_request(workload.request(0))
            with plan:
                result = sup.submit(row).result(timeout=30)
            assert np.isfinite(result["score"])
            assert plan.fired and plan.fired[0]["site"] == "serving.replica"
            assert sup.healthy_count == 1  # the victim awaits its restart

    def test_probes_detect_poisoned_replica_and_restart(self, workload):
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=2,
                                probe_interval_s=0.05,
                                probe_failure_threshold=2)
        with sup:
            class _Wedged:
                degraded = False

                def score_rows(self, rows):
                    raise RuntimeError("UNAVAILABLE: wedged")

                def bucket_for(self, n):
                    return n

            sup.replicas[0].batcher.runtime = _Wedged()
            assert _wait_until(lambda: sup.replicas[0].restarts >= 1), \
                sup.stats()
            assert _wait_until(lambda: sup.healthy_count == 2)

    def test_restart_backoff_is_decorrelated_jitter(self, workload):
        """The restart walk is the reference's: the same policy and seed
        give the same delays in both packages."""
        from photon_ml_tpu.utils.watchdog import RetryPolicy as RefPolicy

        policy = RetryPolicy(backoff_seconds=0.1, max_backoff_seconds=5.0,
                             jitter="decorrelated")
        ref = RefPolicy(backoff_seconds=0.1, max_backoff_seconds=5.0,
                        jitter="decorrelated")
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=1,
                                restart_policy=policy)
        rng, ref_rng = random.Random(42), random.Random(42)
        prev = ref_prev = None
        for attempt in range(6):
            delay = policy.backoff(attempt, rng=rng, previous=prev)
            assert delay == ref.backoff(attempt, rng=ref_rng,
                                        previous=ref_prev)
            assert 0.1 <= delay <= 5.0
            if prev is not None:
                assert delay <= max(3 * prev, 0.1) + 1e-9
            prev = ref_prev = delay
        assert sup.restart_policy.jitter == "decorrelated"
        assert RefSupervisor.__init__.__defaults__ == \
            ReplicaSupervisor.__init__.__defaults__

    def test_no_healthy_replica_rejects_transiently(self, workload):
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=1,
                                probe_interval_s=10.0,
                                restart_policy=RetryPolicy(
                                    backoff_seconds=30.0))
        with sup:
            row = sup.parse_request(workload.request(0))
            sup.kill_replica(0)
            with pytest.raises(RejectedError):
                sup.submit(row).result(timeout=30)

    def test_exactly_one_of_factory_or_pool(self, workload):
        with pytest.raises(ValueError, match="exactly one"):
            ReplicaSupervisor()
        with pytest.raises(ValueError, match="n_replicas"):
            ReplicaSupervisor(lambda: _runtime(workload), n_replicas=0)


class TestSupervisorSwap:
    def test_supervisor_swap_rolls_all_replicas(self, workload, workload_v2,
                                                tmp_path):
        v2_dir = str(tmp_path / "v2")
        save_game_model(workload_v2.model, workload_v2.index_maps, v2_dir)
        requests = [workload.request(i) for i in range(8)]
        ref_v2 = _reference(workload_v2, requests)
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=2,
                                probe_interval_s=0.05)
        service = ScoringService(sup)
        with service:
            result = service.reload(v2_dir)
            assert result.status == "swapped"
            assert result.targets == 2
            got = np.asarray([np.float32(service.score(r)["score"])
                              for r in requests], np.float32)
            assert got.tobytes() == ref_v2.tobytes()
            # Restarts come back on the committed version.
            sup.kill_replica(0)
            assert _wait_until(lambda: sup.healthy_count == 2)
            assert {r["model_version"]
                    for r in sup.stats()["replicas"]} == {2}, sup.stats()

    def test_tenant_route_survives_a_restart(self, workload, workload_v2,
                                             tmp_path):
        """A restarted in-process replica serves the tenant's swapped
        version (the reference's restart drops the route; the port
        re-applies it)."""
        v2_dir = str(tmp_path / "v2")
        save_game_model(workload_v2.model, workload_v2.index_maps, v2_dir)
        tenancy = TenancyConfig(tenants=(TenantSpec(name="acme"),))
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=2,
                                probe_interval_s=0.05)
        service = ScoringService(sup, BatcherConfig(
            max_batch_size=8, max_wait_us=1_000, tenancy=tenancy))
        requests = [dict(workload.request(i), tenant="acme")
                    for i in range(8)]
        want = _reference(workload_v2, [workload.request(i)
                                        for i in range(8)])
        with service:
            assert service.reload(v2_dir, tenant="acme").status == "swapped"
            sup.kill_replica(0)
            assert _wait_until(lambda: sup.healthy_count == 2)
            for _ in range(2):  # both replicas, round robin
                got = np.asarray([np.float32(service.score(r)["score"])
                                  for r in requests], np.float32)
                assert got.tobytes() == want.tobytes()

    def test_quota_lease_splits_across_replicas(self, workload):
        tenancy = TenancyConfig(tenants=(TenantSpec(name="acme",
                                                    quota_rps=100.0),))
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=2,
                                probe_interval_s=0.05)
        service = ScoringService(sup, BatcherConfig(tenancy=tenancy))
        with service:
            service.set_tenant_quota("acme", 40.0, 8.0)
            for rep in sup.replicas:
                bucket = rep.batcher._tenant_states["acme"].bucket
                assert bucket.rate_rps == pytest.approx(20.0)
                assert bucket.burst == pytest.approx(4.0)
            with pytest.raises(ValueError, match="unknown tenant"):
                service.set_tenant_quota("nobody", 1.0)


class TestSanitizers:
    def test_lock_order_inversion_reported_like_reference(self):
        from photon_ml_tpu.analysis import sanitizers as ref_san
        from photon_ml_tpu_torch.analysis import sanitizers

        reports = []
        for mod in (sanitizers, ref_san):
            with mod.LockOrderSanitizer() as san:
                a = mod.tracked(threading.Lock(), "a")
                b = mod.tracked(threading.Lock(), "b")
                with a, b:
                    pass
                with b, a:
                    pass
            reports.append([{k: r[k] for k in ("kind", "acquiring",
                                               "held", "cycle")}
                            for r in san.reports])
        assert reports[0] == reports[1] and reports[0]

    def test_strict_sanitizer_raises_and_untracked_is_raw(self):
        from photon_ml_tpu_torch.analysis import sanitizers

        raw = threading.Lock()
        assert sanitizers.tracked(raw, "x") is raw
        with sanitizers.LockOrderSanitizer(strict=True):
            a = sanitizers.tracked(threading.Lock(), "a")
            b = sanitizers.tracked(threading.Lock(), "b")
            with a, b:
                pass
            with pytest.raises(sanitizers.LockOrderViolation):
                with b, a:
                    pass

    def test_supervisor_locks_are_tracked(self, workload):
        from photon_ml_tpu_torch.analysis import sanitizers

        with sanitizers.LockOrderSanitizer(strict=True) as san:
            sup = ReplicaSupervisor(lambda: _runtime(workload),
                                    n_replicas=2, probe_interval_s=0.05)
            assert isinstance(sup._lock, sanitizers.TrackedLock)
            with ScoringService(sup) as service:
                for i in range(8):
                    service.score(workload.request(i))
                sup.kill_replica(0)
                assert _wait_until(lambda: sup.healthy_count == 2)
        assert san.reports == []

    def test_thread_leak_sentinel_names_the_leak(self):
        from photon_ml_tpu_torch.analysis import sanitizers

        stop = threading.Event()
        with pytest.raises(sanitizers.ThreadLeakError, match="leaky"):
            with sanitizers.ThreadLeakSentinel(grace_s=0.1, strict=True):
                threading.Thread(target=stop.wait, name="leaky",
                                 daemon=True).start()
        stop.set()
