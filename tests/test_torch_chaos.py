"""The port's fault-site registry against the reference's
(``photon_ml_tpu/chaos/core.py``), and the serving sites of the
in-process tier fired through real ``maybe_fail`` calls: the reference's
``test_chaos_verify_stage_rolls_back_post_commit``
(``tests/test_serving_ha.py``) and ``test_chaos_site_degrades_one_tenant``
(``tests/test_serving_tenancy.py``) among them.  The process tier's
sites (``serving.replica``, ``serving.worker``, ``serving.host``,
``quota.lease``) and the freshness sites (``publish.*``,
``online.step``) are held in the test files of those modules.
"""

import json

import numpy as np
import pytest

from photon_ml_tpu import chaos as ref_chaos
from photon_ml_tpu_torch import chaos, telemetry
from photon_ml_tpu_torch.io.game_store import save_game_model
from photon_ml_tpu_torch.serving.batcher import BatcherConfig
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.service import ScoringService
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from photon_ml_tpu_torch.serving.tenancy import TenancyConfig, TenantSpec
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


@pytest.fixture()
def v2_dir(tmp_path, workload_v2):
    path = str(tmp_path / "v2")
    save_game_model(workload_v2.model, workload_v2.index_maps, path)
    return path


# ---------------------------------------------------------------------------
# The registry against the reference's
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_sites_and_descriptions_are_the_references(self):
        assert chaos.KNOWN_SITES == ref_chaos.KNOWN_SITES

    def test_exception_registry_is_the_references(self):
        assert sorted(chaos.EXCEPTIONS) == sorted(ref_chaos.EXCEPTIONS)
        for name, exc in chaos.EXCEPTIONS.items():
            assert exc.__name__ == ref_chaos.EXCEPTIONS[name].__name__

    @pytest.mark.parametrize("kwargs", [
        {"site": "serving.nowhere"},
        {"site": "serving.batch", "action": "explode"},
        {"site": "serving.batch", "exception": "KeyError"},
        {"site": "serving.batch", "at": -1},
        {"site": "serving.batch", "count": 0},
    ], ids=["site", "action", "exception", "at", "count"])
    def test_bad_spec_refused_with_the_references_message(self, kwargs):
        with pytest.raises(ValueError) as ref_err:
            ref_chaos.FaultSpec(**kwargs)
        with pytest.raises(ValueError) as err:
            chaos.FaultSpec(**kwargs)
        assert str(err.value) == str(ref_err.value)

    def test_plan_json_crosses_the_packages(self):
        plan = chaos.FaultPlan([
            chaos.FaultSpec(site="serving.swap", at=2),
            chaos.FaultSpec(site="publish.delta", at=1, count=-1,
                            action="delay", delay_seconds=0.01),
        ])
        ref_plan = ref_chaos.FaultPlan.from_json(plan.to_json())
        assert ref_plan.to_json() == plan.to_json()
        assert chaos.FaultPlan.from_json(ref_plan.to_json()).to_json() == \
            plan.to_json()
        assert json.loads(plan.to_json())[0]["site"] == "serving.swap"

    def test_occurrences_and_fired_log_match_the_reference(self):
        logs = []
        for mod in (chaos, ref_chaos):
            plan = mod.FaultPlan([mod.FaultSpec(site="online.step", at=1,
                                                count=2)])
            raised = []
            with plan:
                for i in range(5):
                    try:
                        mod.maybe_fail("online.step", events=i)
                    except mod.InjectedFault as exc:
                        raised.append(str(exc))
            logs.append((plan.fired, raised,
                         plan.occurrences("online.step")))
        assert logs[0] == logs[1]
        assert logs[0][2] == 5 and len(logs[0][1]) == 2

    def test_disabled_path_is_a_no_op(self):
        assert chaos.current_plan() is None
        chaos.maybe_fail("serving.device", rows=1)  # nothing installed

    def test_one_plan_at_a_time(self):
        with chaos.FaultPlan([]):
            with pytest.raises(RuntimeError, match="already installed"):
                chaos.FaultPlan([]).install()


# ---------------------------------------------------------------------------
# The in-process serving sites
# ---------------------------------------------------------------------------

class TestServingSites:
    def test_device_site_degrades_a_cpu_runtime_with_zero_errors(
            self, workload):
        runtime = _runtime(workload, breaker_cooldown_s=60.0)
        requests = [workload.request(i) for i in range(8)]
        healthy = _reference(workload, requests)
        plan = chaos.FaultPlan([chaos.FaultSpec(
            site="serving.device", at=0, exception="InjectedDeviceLost")])
        with ScoringService(runtime) as service, plan:
            got = np.asarray([np.float32(service.score(r)["score"])
                              for r in requests], np.float32)
        assert [f["site"] for f in plan.fired] == ["serving.device"]
        assert runtime.degraded and runtime.device_failures == 1
        np.testing.assert_allclose(got, healthy, rtol=1e-5, atol=1e-6)

    def test_batch_site_fails_one_batch_and_the_next_scores(self, workload):
        service = ScoringService(_runtime(workload), BatcherConfig(
            max_batch_size=8, max_wait_us=1_000))
        plan = chaos.FaultPlan([chaos.FaultSpec(site="serving.batch",
                                                at=0)])
        with service:
            with plan:
                future = service.submit(workload.request(0))
                with pytest.raises(Exception, match="chaos-injected"):
                    future.result(timeout=30)
                assert np.isfinite(service.score(workload.request(1))[
                    "score"])
        assert [f["site"] for f in plan.fired] == ["serving.batch"]
        assert plan.fired[0]["rows"] == 1
        assert plan.occurrences("serving.batch") == 2

    @pytest.mark.parametrize("at,stage", [(0, "load"), (1, "prepare")])
    def test_swap_site_aborts_before_the_commit(self, workload, v2_dir,
                                                at, stage):
        requests = [workload.request(i) for i in range(8)]
        ref = _reference(workload, requests)
        service = ScoringService(_runtime(workload))
        plan = chaos.FaultPlan([chaos.FaultSpec(site="serving.swap", at=at)])
        with service:
            with plan:
                result = service.reload(v2_dir)
            assert (result.status, result.stage) == ("rolled_back", stage)
            assert service.swapper.version == 1
            got = np.asarray([np.float32(service.score(r)["score"])
                              for r in requests], np.float32)
        assert got.tobytes() == ref.tobytes()

    def test_chaos_verify_stage_rolls_back_post_commit(self, workload,
                                                       v2_dir):
        """A fault AFTER the commit (verify stage = occurrence 2 of
        serving.swap) restores the previous runtimes."""
        requests = [workload.request(i) for i in range(8)]
        ref = _reference(workload, requests)
        service = ScoringService(_runtime(workload))
        plan = chaos.FaultPlan([chaos.FaultSpec(site="serving.swap", at=2)])
        with service:
            with plan:
                result = service.reload(v2_dir)
            assert result.status == "rolled_back", result
            assert result.stage == "verify"
            assert service.swapper.version == 1
            got = np.asarray([np.float32(service.score(r)["score"])
                              for r in requests], np.float32)
        assert got.tobytes() == ref.tobytes()
        assert [f["site"] for f in plan.fired] == ["serving.swap"]

    def test_chaos_site_degrades_one_tenant(self, workload, v2_dir):
        tenancy = TenancyConfig(tenants=(TenantSpec(name="acme"),))
        with telemetry.Telemetry(sinks=[]) as tel:
            service = ScoringService(_runtime(workload), BatcherConfig(
                max_batch_size=8, max_wait_us=1_000, max_queue=256,
                tenancy=tenancy))
            with service:
                assert service.reload(v2_dir, tenant="acme").status == \
                    "swapped"
                plan = chaos.FaultPlan([chaos.FaultSpec(
                    site="serving.tenant", at=0)])
                with plan:
                    future = service.submit(dict(workload.request(0),
                                                 tenant="acme"))
                    with pytest.raises(Exception, match="chaos-injected"):
                        future.result(timeout=30)
                assert [f["site"] for f in plan.fired] == ["serving.tenant"]
                assert plan.fired[0]["tenant"] == "acme"
                # The fault degraded acme alone: the default route scores.
                assert np.isfinite(service.score(workload.request(1))[
                    "score"])
            snap = tel.snapshot()
        assert snap["counters"][
            "serving_tenant_acme_failed_requests_total"] == 1
