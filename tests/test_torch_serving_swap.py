"""Hot swap, tiered admission, the health split, unverified loads, tenancy
and load-generator scenarios of the port, on the CPU — the reference's
``tests/test_serving_ha.py`` (without the supervisor, chaos and exporter
cases) and ``tests/test_serving_tenancy.py`` (thread mode).

Models cross between the packages through the store: the reference saves
a model directory that the port hot-swaps in; the tenancy primitives are
held against the reference's on the same inputs.
"""

import concurrent.futures
import dataclasses
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from photon_ml_tpu.io.game_store import save_game_model as ref_save
from photon_ml_tpu.serving import tenancy as ref_tenancy
from photon_ml_tpu.serving.synthetic import SyntheticWorkload as RefWorkload
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.io.game_store import save_game_model
from photon_ml_tpu_torch.serving import loadgen
from photon_ml_tpu_torch.serving.batcher import (
    TIER_ACCEPT,
    TIER_REJECT,
    TIER_SHED,
    BatcherConfig,
    MicroBatcher,
    RejectedError,
)
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.service import (
    ScoringService,
    start_http_server,
)
from photon_ml_tpu_torch.serving.swap import SwapInProgressError
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from photon_ml_tpu_torch.serving.tenancy import (
    TenancyConfig,
    TenantRouter,
    TenantSpec,
    TokenBucket,
    tenant_slug,
)
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


@pytest.fixture(scope="module")
def workload():
    return SyntheticWorkload(n_entities=32, seed=7)


@pytest.fixture(scope="module")
def workload_v2():
    return SyntheticWorkload(n_entities=32, seed=8)


@pytest.fixture(scope="module")
def workload_v3():
    return SyntheticWorkload(n_entities=32, seed=9)


def _runtime(workload, **kwargs):
    cfg = RuntimeConfig(**{"max_batch_size": 8, "hot_entities": 8,
                           "device": "cpu", **kwargs})
    return ScoringRuntime(workload.model, workload.index_maps, cfg)


def _reference(workload, requests):
    """Scores from a fresh single runtime, one row at a time."""
    runtime = _runtime(workload)
    return np.asarray([runtime.score_rows([runtime.parse_request(r)])[0][0]
                       for r in requests], np.float32)


def _scores(service, requests):
    return np.asarray([np.float32(service.score(r)["score"])
                       for r in requests], np.float32)


@pytest.fixture()
def model_dirs(tmp_path, workload, workload_v2):
    """v1 saved by the port; v2 saved by the JAX package's store (the
    same seed-8 draw), so every swap below loads a reference-written
    directory."""
    v1 = str(tmp_path / "v1")
    v2 = str(tmp_path / "v2")
    save_game_model(workload.model, workload.index_maps, v1)
    ref_v2 = RefWorkload(n_entities=32, seed=8)
    ref_save(ref_v2.model, ref_v2.index_maps, v2)
    return v1, v2


class TestHotSwap:
    def test_swap_bit_parity_under_concurrent_traffic(
            self, workload, workload_v2, model_dirs):
        """Every score observed during a hot swap matches EITHER the
        pre-swap or the post-swap single-runtime reference, bitwise."""
        _v1, v2_dir = model_dirs
        requests = [workload.request(i) for i in range(16)]
        ref_v1 = _reference(workload, requests)
        ref_v2 = _reference(workload_v2, requests)
        assert ref_v1.tobytes() != ref_v2.tobytes()
        service = ScoringService(_runtime(workload))
        scores, errors = [], []
        stop = threading.Event()

        def traffic():
            i = 0
            while not stop.is_set():
                try:
                    r = service.score(requests[i % 16], timeout=30)
                    scores.append((i % 16, np.float32(r["score"])))
                except Exception as exc:  # noqa: BLE001
                    errors.append(repr(exc))
                i += 1

        with service:
            threads = [threading.Thread(target=traffic) for _ in range(3)]
            for t in threads:
                t.start()
            time.sleep(0.2)
            result = service.reload(v2_dir)
            time.sleep(0.2)
            stop.set()
            for t in threads:
                t.join()
            post = _scores(service, requests)
        assert result.status == "swapped", result
        assert result.version_after == 2
        assert not errors, errors[:3]
        assert len(scores) > 20
        for idx, score in scores:
            assert score.tobytes() in (np.float32(ref_v1[idx]).tobytes(),
                                       np.float32(ref_v2[idx]).tobytes())
        assert post.tobytes() == ref_v2.tobytes()

    def test_tampered_payload_rolls_back_with_zero_errors(
            self, workload, model_dirs, tmp_path):
        v1_dir, v2_dir = model_dirs
        bad_dir = str(tmp_path / "bad")
        shutil.copytree(v2_dir, bad_dir)
        rel = os.path.join("random-effect", "per_entity", "coefficients.avro")
        shutil.copyfile(os.path.join(v1_dir, rel), os.path.join(bad_dir, rel))
        requests = [workload.request(i) for i in range(8)]
        ref = _reference(workload, requests)
        service = ScoringService(_runtime(workload))
        with service:
            result = service.reload(bad_dir)
            assert result.status == "rolled_back", result
            assert result.stage in ("load", "prepare")
            assert result.version_after == 1
            assert "checksum" in result.reason
            got = _scores(service, requests)
        assert got.tobytes() == ref.tobytes()

    def test_one_flipped_byte_rolls_back(self, workload, model_dirs,
                                         tmp_path):
        """phase 13c's probe: one payload byte flipped in a copy."""
        _v1, v2_dir = model_dirs
        bad_dir = str(tmp_path / "flipped")
        shutil.copytree(v2_dir, bad_dir)
        path = os.path.join(bad_dir, "random-effect", "per_entity",
                            "coefficients.avro")
        with open(path, "r+b") as f:
            f.seek(-64, os.SEEK_END)
            byte = f.read(1)
            f.seek(-64, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
        service = ScoringService(_runtime(workload))
        with service:
            result = service.reload(bad_dir)
        assert result.status == "rolled_back", result
        assert service.swapper.version == 1

    def test_tampered_meta_sidecar_rolls_back(self, workload, model_dirs,
                                              tmp_path):
        _v1, v2_dir = model_dirs
        bad_dir = str(tmp_path / "badmeta")
        shutil.copytree(v2_dir, bad_dir)
        meta = os.path.join(bad_dir, "fixed-effect", "fixed",
                            "coefficients.avro.meta.json")
        with open(meta) as f:
            payload = json.load(f)
        payload["fingerprint"]["coefficient_checksum"] = "0" * 64
        with open(meta, "w") as f:
            json.dump(payload, f)
        service = ScoringService(_runtime(workload))
        with service:
            result = service.reload(bad_dir)
        assert result.status == "rolled_back", result
        assert service.swapper.version == 1

    def test_swap_while_degraded_defers(self, workload, model_dirs):
        _v1, v2_dir = model_dirs
        service = ScoringService(_runtime(workload))
        with service:
            service.batcher.runtime.degraded = True
            result = service.reload(v2_dir)
            assert result.status == "deferred", result
            assert service.swapper.version == 1
            service.batcher.runtime.degraded = False
            assert service.reload(v2_dir).status == "swapped"

    def test_failed_verify_probe_rolls_back_post_commit(
            self, workload, model_dirs, monkeypatch):
        """A non-finite probe after the commit (the reference scripts the
        same stage with a chaos fault) restores the previous runtime."""
        _v1, v2_dir = model_dirs
        requests = [workload.request(i) for i in range(8)]
        ref = _reference(workload, requests)
        service = ScoringService(_runtime(workload))
        real_submit = service.batcher.submit

        def poisoned(row, timeout_ms=None, bypass_admission=False):
            fut = real_submit(row, timeout_ms, bypass_admission)
            if bypass_admission:
                from concurrent.futures import Future

                bad = Future()
                bad.set_result({"score": float("nan")})
                fut.result(timeout=30)
                return bad
            return fut

        with service:
            monkeypatch.setattr(service.batcher, "submit", poisoned)
            result = service.reload(v2_dir)
            monkeypatch.undo()
            assert result.status == "rolled_back", result
            assert result.stage == "verify"
            assert service.swapper.version == 1
            assert _scores(service, requests).tobytes() == ref.tobytes()

    def test_manual_rollback_and_version_monotonicity(
            self, workload, model_dirs):
        _v1, v2_dir = model_dirs
        requests = [workload.request(i) for i in range(4)]
        ref_v1 = _reference(workload, requests)
        service = ScoringService(_runtime(workload))
        with service:
            assert service.reload(v2_dir).version_after == 2
            back = service.reload(rollback=True)
            assert back.status == "rolled_back" and back.version_after == 1
            assert _scores(service, requests).tobytes() == ref_v1.tobytes()
            assert service.reload(v2_dir).version_after == 3
            stats = service.stats()["swap"]
            assert stats["swaps"] == 2 and stats["can_rollback"] is True

    def test_concurrent_swap_raises_in_progress(self, workload, model_dirs):
        _v1, v2_dir = model_dirs
        service = ScoringService(_runtime(workload))
        with service:
            assert service.swapper._swap_lock.acquire(blocking=False)
            try:
                with pytest.raises(SwapInProgressError):
                    service.reload(v2_dir)
            finally:
                service.swapper._swap_lock.release()

    def test_delta_reload_serves_v2_bitwise(self, workload,
                                                 model_dirs, tmp_path):
        """A delta from v1 to v2 applies in process and serves v2's
        scores bitwise; a delta for a tenant or an unknown mode is
        refused."""
        from photon_ml_tpu_torch.freshness.delta import (
            diff_model_dirs,
            write_delta,
        )

        v1_dir, v2_dir = model_dirs
        delta_dir = str(tmp_path / "delta")
        write_delta(diff_model_dirs(v1_dir, v2_dir), delta_dir)
        v2 = ScoringRuntime.load(v2_dir, RuntimeConfig(
            max_batch_size=8, hot_entities=8, device="cpu"))
        requests = [workload.request(i) for i in range(12)]
        want = np.asarray([v2.score_rows([v2.parse_request(r)])[0][0]
                           for r in requests], np.float32)
        service = ScoringService(ScoringRuntime.load(v1_dir, RuntimeConfig(
            max_batch_size=8, hot_entities=8, device="cpu")))
        with service:
            assert service.reload(delta_dir, mode="delta").status == \
                "swapped"
            assert _scores(service, requests).tobytes() == want.tobytes()
            assert service.swapper.version == 2
            assert service.swapper.rollback().status == "rolled_back"
            with pytest.raises(ValueError, match="mode='full' only"):
                service.reload(v2_dir, mode="delta", tenant="acme")
            with pytest.raises(ValueError, match="unknown reload mode"):
                service.reload(v2_dir, mode="bogus")
            assert service.swapper.version == 1

    def test_swap_keeps_the_runtime_config(self, workload, model_dirs):
        _v1, v2_dir = model_dirs
        service = ScoringService(_runtime(workload, hot_entities=3,
                                          fused=False))
        with service:
            assert service.reload(v2_dir).status == "swapped"
            rt = service.current_runtime
            assert rt.config.hot_entities == 3 and not rt.config.fused
            assert rt.device.type == "cpu" and rt.model_path == v2_dir


def _idle_batcher(workload, **cfg_kwargs):
    runtime = _runtime(workload)
    cfg = BatcherConfig(**{"max_batch_size": 8, "max_queue": 20,
                           "max_wait_us": 1000, **cfg_kwargs})
    return MicroBatcher(runtime, cfg), runtime


class TestTieredAdmission:
    def test_accept_below_watermarks(self, workload):
        batcher, runtime = _idle_batcher(workload)
        batcher.submit(runtime.parse_request(workload.request(0)))
        assert batcher.admission_tier() == TIER_ACCEPT

    def test_low_priority_shed_at_shed_tier(self, workload):
        batcher, runtime = _idle_batcher(workload, shed_watermark=0.25,
                                         reject_watermark=0.9)
        normal = runtime.parse_request(workload.request(0))
        low = runtime.parse_request({**workload.request(1),
                                     "priority": "low"})
        for _ in range(6):
            batcher.submit(normal)
        assert batcher.admission_tier() == TIER_SHED
        with pytest.raises(RejectedError, match="load shed"):
            batcher.submit(low)
        batcher.submit(normal)

    def test_reject_tier_sheds_everything(self, workload):
        batcher, runtime = _idle_batcher(workload, shed_watermark=0.2,
                                         reject_watermark=0.5)
        row = runtime.parse_request(workload.request(0))
        for _ in range(10):
            batcher.submit(row)
        assert batcher.admission_tier() == TIER_REJECT
        with pytest.raises(RejectedError, match="load shed"):
            batcher.submit(row)

    def test_bypass_admission_flows_at_reject_tier(self, workload):
        batcher, runtime = _idle_batcher(workload, shed_watermark=0.2,
                                         reject_watermark=0.5)
        row = runtime.parse_request(workload.request(0))
        for _ in range(10):
            batcher.submit(row)
        assert batcher.admission_tier() == TIER_REJECT
        batcher.submit(row, bypass_admission=True)

    def test_p99_slo_breach_sheds_over_deadline_work(self, workload):
        """The p99 signal is read back from the telemetry hub's
        ``serving_request_latency_seconds`` histogram."""
        with telemetry.Telemetry(sinks=[]) as tel:
            hist = tel.histogram("serving_request_latency_seconds")
            for _ in range(100):
                hist.observe(0.5)
            batcher, runtime = _idle_batcher(workload, p99_slo_ms=100.0,
                                             admission_interval_s=0.0)
            row = runtime.parse_request(workload.request(0))
            assert batcher.admission_tier() == TIER_SHED
            with pytest.raises(RejectedError, match="p99"):
                batcher.submit(row, timeout_ms=10.0)
            batcher.submit(row, timeout_ms=5_000.0)

    def test_tier_transitions_are_journaled(self, workload):
        with telemetry.Telemetry(sinks=[]) as tel:
            batcher, runtime = _idle_batcher(workload, shed_watermark=0.25,
                                             reject_watermark=0.9)
            row = runtime.parse_request(workload.request(0))
            for _ in range(6):
                batcher.submit(row)
            with pytest.raises(RejectedError):
                batcher.submit(runtime.parse_request(
                    {**workload.request(1), "priority": "low"}))
            snap = tel.snapshot()
            assert snap["counters"]["serving_tier_transitions_total"] >= 1
            assert snap["counters"]["serving_shed_total"] >= 1
            assert snap["counters"]["serving_shed_low_priority_total"] >= 1
            assert snap["gauges"]["serving_shed_tier"] == TIER_SHED
            assert batcher.stats()["tier"] == "shed"
            assert batcher.stats()["source"] == "telemetry"

    def test_watermark_validation(self, workload):
        with pytest.raises(ValueError):
            MicroBatcher(_runtime(workload), BatcherConfig(
                shed_watermark=0.9, reject_watermark=0.5))


def _get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(port, route, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestHealthSplit:
    def test_livez_readyz_routes(self, workload):
        service = ScoringService(_runtime(workload))
        with service:
            server, _ = start_http_server(service, port=0)
            port = server.server_address[1]
            try:
                assert _get(port, "/livez")[0] == 200
                assert _get(port, "/readyz") == (
                    200, {"status": "ready", "reason": "ok"})
                health = _get(port, "/healthz")[1]
                assert health["status"] == "ok"
                assert health["model_version"] == 1
                assert health["degraded"] is False
                service.swapper.in_progress = True
                try:
                    assert _get(port, "/livez")[0] == 200
                    status, body = _get(port, "/readyz")
                    assert (status, body["status"]) == (503, "not_ready")
                    assert _get(port, "/healthz")[1]["status"] == \
                        "not_ready"
                finally:
                    service.swapper.in_progress = False
                service.batcher.runtime.ready = False
                try:
                    status, body = _get(port, "/readyz")
                    assert (status, body["status"]) == (503, "not_ready")
                finally:
                    service.batcher.runtime.ready = True
                assert _get(port, "/nope")[0] == 404
            finally:
                server.shutdown()
                server.server_close()

    def test_reload_endpoint_over_http(self, workload, model_dirs):
        _v1, v2_dir = model_dirs
        service = ScoringService(_runtime(workload))
        with service:
            server, _ = start_http_server(service, port=0)
            port = server.server_address[1]
            try:
                status, body = _post(port, "/reload", {"model_dir": v2_dir})
                assert (status, body["status"]) == (200, "swapped")
                assert body["version_after"] == 2
                assert _get(port, "/healthz")[1]["model_version"] == 2
                status, body = _post(port, "/reload", {"rollback": True})
                assert (status, body["status"]) == (422, "rolled_back")
                assert _post(port, "/reload", {})[0] == 400
                # A full model directory is no delta artifact: the
                # delta reload answers it as a rolled-back load.
                status, body = _post(port, "/reload?mode=delta",
                                     {"model_dir": v2_dir})
                assert (status, body["status"]) == (422, "rolled_back")
                assert "delta" in body["reason"]
            finally:
                server.shutdown()
                server.server_close()


class TestUnverifiedLoads:
    def test_glm_without_sidecar_warns_and_counts(self, tmp_path):
        from photon_ml_tpu_torch.convert import glm_from_numpy
        from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
        from photon_ml_tpu_torch.io.model_store import (
            load_glm_model,
            save_glm_model,
        )

        imap = IndexMap.build([feature_key(f"f{i}", "") for i in range(4)])
        glm = glm_from_numpy(np.ones(4, np.float32), "logistic",
                             device="cpu")
        path = str(tmp_path / "legacy.avro")
        save_glm_model(glm, imap, path)
        os.remove(path + ".meta.json")
        with telemetry.Telemetry(sinks=[]) as tel:
            with pytest.warns(UserWarning, match="UNVERIFIED"):
                load_glm_model(path, device="cpu")
            assert tel.snapshot()["counters"][
                "model_load_unverified_total"] == 1

    def test_game_dir_without_fingerprints_warns(self, tmp_path, workload):
        from photon_ml_tpu_torch.io.game_store import load_game_model

        directory = str(tmp_path / "legacy_game")
        save_game_model(workload.model, workload.index_maps, directory)
        meta_path = os.path.join(directory, "metadata.json")
        with open(meta_path) as f:
            manifest = json.load(f)
        del manifest["fingerprints"]
        with open(meta_path, "w") as f:
            json.dump(manifest, f)
        for root, _dirs, files in os.walk(directory):
            for name in files:
                if name.endswith(".meta.json"):
                    os.remove(os.path.join(root, name))
        with telemetry.Telemetry(sinks=[]) as tel:
            with pytest.warns(UserWarning, match="UNVERIFIED"):
                load_game_model(directory, device="cpu")
            assert tel.snapshot()["counters"][
                "model_load_unverified_total"] == 2

    def test_verified_load_stays_silent(self, tmp_path, workload):
        import warnings

        from photon_ml_tpu_torch.io.game_store import load_game_model

        directory = str(tmp_path / "verified_game")
        save_game_model(workload.model, workload.index_maps, directory)
        with telemetry.Telemetry(sinks=[]) as tel:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                load_game_model(directory, device="cpu")
            assert tel.snapshot()["counters"].get(
                "model_load_unverified_total", 0) == 0

    def test_runtime_load_finds_nested_models_dir(self, tmp_path, workload):
        save_game_model(workload.model, workload.index_maps,
                        str(tmp_path / "out" / "models"))
        rt = ScoringRuntime.load(str(tmp_path / "out"), RuntimeConfig(
            max_batch_size=4, device="cpu"))
        ref = _runtime(workload, max_batch_size=4)
        reqs = [workload.request(i) for i in range(4)]
        a = rt.score_rows([rt.parse_request(r) for r in reqs])[0]
        b = ref.score_rows([ref.parse_request(r) for r in reqs])[0]
        assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Tenancy (the reference's tests/test_serving_tenancy.py, thread mode)
# ---------------------------------------------------------------------------

def _tagged(workload, i, tenant):
    obj = dict(workload.request(i))
    if tenant is not None:
        obj["tenant"] = tenant
    return obj


class TestTenancyPrimitives:
    @pytest.mark.parametrize("name", ["Acme Corp.", "__x__", "!!!", "a-b",
                                      "Ünïcode", "x" * 80])
    def test_slug_matches_reference(self, name):
        assert tenant_slug(name) == ref_tenancy.tenant_slug(name)

    @pytest.mark.parametrize("kwargs", [
        {"name": ""}, {"name": "t", "quota_rps": -1.0},
        {"name": "t", "burst": 0.0},
        {"name": "t", "shed_watermark": 0.9, "reject_watermark": 0.5},
    ])
    def test_spec_refusals_match_reference(self, kwargs):
        with pytest.raises(ValueError) as ref_err:
            ref_tenancy.TenantSpec(**kwargs)
        with pytest.raises(ValueError) as err:
            TenantSpec(**kwargs)
        assert str(err.value) == str(ref_err.value)

    @pytest.mark.parametrize("names", [("a", "a"), ("a b", "a.b")])
    def test_config_refusals_match_reference(self, names):
        with pytest.raises(ValueError) as ref_err:
            ref_tenancy.TenancyConfig(tenants=tuple(
                ref_tenancy.TenantSpec(name=n) for n in names))
        with pytest.raises(ValueError) as err:
            TenancyConfig(tenants=tuple(TenantSpec(name=n) for n in names))
        assert str(err.value) == str(ref_err.value)

    def test_spec_for_unknown_is_default(self):
        cfg = TenancyConfig(tenants=(TenantSpec(name="a", max_queue=8),))
        assert cfg.spec_for("a").max_queue == 8
        assert cfg.spec_for("stranger") is cfg.default
        assert cfg.spec_for(None) is cfg.default
        assert cfg.is_known("a") and not cfg.is_known("stranger")
        assert cfg.partition_total == 8 + cfg.default.max_queue

    def test_bucket_sequence_matches_reference(self):
        t = [0.0]
        ours = TokenBucket(rate_rps=2.0, burst=4.0, clock=lambda: t[0])
        ref = ref_tenancy.TokenBucket(rate_rps=2.0, burst=4.0,
                                      clock=lambda: t[0])
        for step in np.linspace(0.0, 5.0, 41):
            t[0] = float(step)
            for _ in range(2):
                assert ours.try_acquire() == ref.try_acquire()
            if step == 2.5:
                ours.reset_rate(0.5, 1.0)
                ref.reset_rate(0.5, 1.0)
        assert ours.snapshot() == ref.snapshot()

    def test_zero_quota_and_unlimited_buckets(self):
        bucket = TokenBucket(rate_rps=0.0, burst=5.0, clock=lambda: 0.0)
        assert not bucket.try_acquire()
        assert bucket.denied == 1 and bucket.admitted == 0
        free = TokenBucket(rate_rps=None)
        assert all(free.try_acquire() for _ in range(100))


class TestTenantAdmission:
    def _service(self, workload, tenancy):
        return ScoringService(_runtime(workload), BatcherConfig(
            max_batch_size=8, max_wait_us=1_000, max_queue=256,
            tenancy=tenancy))

    def test_zero_quota_tenant_shed_neighbor_unaffected(self, workload):
        tenancy = TenancyConfig(tenants=(
            TenantSpec(name="suspended", quota_rps=0.0),
            TenantSpec(name="paying")))
        with telemetry.Telemetry(sinks=[]) as tel:
            with self._service(workload, tenancy) as service:
                for i in range(8):
                    with pytest.raises(RejectedError, match="over quota"):
                        service.submit(_tagged(workload, i, "suspended"))
                results = [service.score(_tagged(workload, i, "paying"))
                           for i in range(8)]
                assert all(np.isfinite(r["score"]) for r in results)
            counters = tel.snapshot()["counters"]
        assert counters["serving_tenant_suspended_shed_total"] == 8
        assert counters["serving_shed_quota_total"] == 8
        assert counters["serving_tenant_paying_requests_total"] == 8
        assert "serving_tenant_paying_shed_total" not in counters

    def test_unknown_tenant_scores_on_default_route(self, workload):
        tenancy = TenancyConfig(tenants=(TenantSpec(name="paying"),))
        requests = [workload.request(i) for i in range(8)]
        expected = _reference(workload, requests)
        with telemetry.Telemetry(sinks=[]):
            with self._service(workload, tenancy) as service:
                got = _scores(service, [_tagged(workload, i, "stranger")
                                        for i in range(8)])
                stats = service.batcher.stats()
        assert got.tobytes() == expected.tobytes()
        assert "stranger" not in stats["tenants"]
        assert stats["tenants"]["default"]["quota"]["admitted"] >= 8

    def test_stats_expose_per_tenant_state(self, workload):
        tenancy = TenancyConfig(tenants=(
            TenantSpec(name="a", quota_rps=100.0, max_queue=16),))
        with telemetry.Telemetry(sinks=[]):
            with self._service(workload, tenancy) as service:
                service.score(_tagged(workload, 0, "a"))
                stats = service.batcher.stats()
        entry = stats["tenants"]["a"]
        assert entry["max_queue"] == 16
        assert entry["quota"]["admitted"] >= 1
        assert entry["breaker"]["state"] == "closed"
        assert entry["routed_version"] is None


class TestTenantRouting:
    @pytest.fixture()
    def dirs(self, tmp_path, workload, workload_v2, workload_v3):
        out = {}
        for name, w in (("v1", workload), ("v2", workload_v2),
                        ("v3", workload_v3)):
            out[name] = str(tmp_path / name)
            save_game_model(w.model, w.index_maps, out[name])
        return out

    def test_swap_isolates_and_rollback_restores_bitwise(
            self, dirs, workload, workload_v2, workload_v3):
        requests = [workload.request(i) for i in range(8)]
        want = {"v1": _reference(workload, requests),
                "v2": _reference(workload_v2, requests),
                "v3": _reference(workload_v3, requests)}

        def scores(service, tenant):
            return _scores(service, [_tagged(workload, i, tenant)
                                     for i in range(8)])

        tenancy = TenancyConfig(tenants=(TenantSpec(name="acme"),
                                         TenantSpec(name="beta")))
        with telemetry.Telemetry(sinks=[]):
            service = ScoringService(_runtime(workload), BatcherConfig(
                max_batch_size=8, max_wait_us=1_000, max_queue=256,
                tenancy=tenancy))
            with service:
                result = service.reload(dirs["v2"], tenant="acme")
                assert result.status == "swapped" and result.tenant == "acme"
                assert scores(service, "acme").tobytes() == \
                    want["v2"].tobytes()
                for other in ("beta", None, "stranger"):
                    assert scores(service, other).tobytes() == \
                        want["v1"].tobytes()
                rb = service.reload(rollback=True, tenant="acme")
                assert rb.status == "rolled_back" and rb.targets > 0, rb
                assert scores(service, "acme").tobytes() == \
                    want["v1"].tobytes()
                assert service.swapper.tenant_versions() == {}
                assert service.reload(dirs["v2"],
                                      tenant="acme").status == "swapped"
                assert service.reload(dirs["v3"],
                                      tenant="beta").status == "swapped"
                assert scores(service, "beta").tobytes() == \
                    want["v3"].tobytes()
                assert scores(service, "acme").tobytes() == \
                    want["v2"].tobytes()
                stale = service.reload(rollback=True, tenant="acme")
                assert stale.targets == 0
                assert "no prior tenant swap" in stale.reason
                rb2 = service.reload(rollback=True, tenant="beta")
                assert rb2.status == "rolled_back" and rb2.targets > 0
                assert scores(service, "beta").tobytes() == \
                    want["v1"].tobytes()
                assert scores(service, "acme").tobytes() == \
                    want["v2"].tobytes()
                assert set(service.swapper.tenant_versions()) == {"acme"}

    def test_router_view_tracks_routes(self, dirs, workload):
        tenancy = TenancyConfig(tenants=(TenantSpec(name="acme"),))
        with telemetry.Telemetry(sinks=[]):
            service = ScoringService(_runtime(workload), BatcherConfig(
                max_batch_size=8, max_wait_us=1_000, max_queue=256,
                tenancy=tenancy))
            with service:
                router = TenantRouter(service.swapper)
                before = router.route("acme")
                assert before["default_route"] is True
                assert before["version"] == service.swapper.version
                assert service.reload(dirs["v2"],
                                      tenant="acme").status == "swapped"
                after = router.route("acme")
                assert after["default_route"] is False
                assert after["version"] > before["version"]
                assert router.route("stranger")["default_route"] is True
                routes = router.routes()
                assert routes["acme"]["version"] == after["version"]
                assert routes["*default*"]["default_route"] is True

    def test_failing_tenant_route_fails_that_tenant_alone(
            self, dirs, workload, monkeypatch):
        """A tenant route whose scoring fails fails that tenant's rows
        alone (the reference scripts this with the ``serving.tenant``
        chaos site); the default route keeps scoring."""
        tenancy = TenancyConfig(tenants=(TenantSpec(name="acme"),))
        with telemetry.Telemetry(sinks=[]) as tel:
            service = ScoringService(_runtime(workload), BatcherConfig(
                max_batch_size=8, max_wait_us=1_000, max_queue=256,
                tenancy=tenancy))
            with service:
                assert service.reload(dirs["v2"],
                                      tenant="acme").status == "swapped"
                route = service.batcher.tenant_route("acme")

                def broken(rows):
                    raise RuntimeError("INVALID_ARGUMENT: broken route")

                monkeypatch.setattr(route, "score_rows", broken)
                future = service.submit(_tagged(workload, 0, "acme"))
                with pytest.raises(RuntimeError, match="broken route"):
                    future.result(timeout=30)
                assert np.isfinite(service.score(workload.request(1))[
                    "score"])
            snap = tel.snapshot()
        assert snap["counters"][
            "serving_tenant_acme_failed_requests_total"] == 1


def _short_scenario():
    return loadgen.Scenario(
        name="noisy_neighbor", description="test-sized replay",
        phases=[loadgen.ScenarioPhase("baseline", 0.3),
                loadgen.ScenarioPhase("burst", 0.8, rate_multiplier=10.0),
                loadgen.ScenarioPhase("recovery", 0.3)])


class TestScenarios:
    def test_catalog_is_the_references(self):
        from photon_ml_tpu.serving import loadgen as ref_loadgen

        assert list(loadgen.SCENARIOS) == list(ref_loadgen.SCENARIOS)
        for name, sc in loadgen.SCENARIOS.items():
            ref = ref_loadgen.SCENARIOS[name]
            assert [(p.name, p.duration_s, p.rate_multiplier, p.action)
                    for p in sc.phases] == \
                [(p.name, p.duration_s, p.rate_multiplier, p.action)
                 for p in ref.phases]

    @pytest.mark.parametrize("name", ["replica_kill", "worker_kill",
                                      "freshness", "host_kill",
                                      "host_join_drain",
                                      "coordinator_failover",
                                      "quota_partition"])
    def test_process_tier_scenarios_run_their_actions(self, name):
        """A scenario of the process and fleet tier, the cluster
        membership plane's included, runs every phase and fires every
        action wired to it."""
        scenario = loadgen.SCENARIOS[name]
        fired = []
        actions = {p.action: (lambda a=p.action: fired.append(a) or "ok")
                   for p in scenario.phases if p.action}

        def submit(row):
            fut = concurrent.futures.Future()
            fut.set_result({"score": 0.0})
            return fut

        short = loadgen.Scenario(scenario.name, scenario.description, [
            dataclasses.replace(p, duration_s=0.05)
            for p in scenario.phases])
        report = loadgen.run_scenario(submit, lambda *a: {}, short,
                                      base_rate_rps=200.0, actions=actions)
        assert [n for n, _ in report.phases] == \
            [p.name for p in scenario.phases]
        assert sorted(fired) == sorted(actions)
        assert report.actions == {a: "ok" for a in actions}
        assert report.errors == 0 and report.rejected == 0

    def test_unwired_action_raises_up_front(self):
        with pytest.raises(ValueError, match="swap"):
            loadgen.run_scenario(lambda row: None, lambda i, phase: {},
                                 loadgen.SCENARIOS["swap_under_load"])

    def test_scenario_runs_phases_and_fires_action(self, workload):
        service = ScoringService(_runtime(workload))
        fired, pools = [], []
        scenario = loadgen.Scenario("mini", "test", [
            loadgen.ScenarioPhase("a", 0.3, rate_multiplier=1.0),
            loadgen.ScenarioPhase("b", 0.3, action="poke",
                                  entity_pool=(0.5, 1.0))])

        def make_request(i, phase):
            pools.append(phase.entity_pool)
            return workload.request(i)

        with service:
            report = loadgen.run_scenario(
                service.submit, make_request, scenario, base_rate_rps=60.0,
                actions={"poke": lambda: fired.append(1) or "ok"})
        assert [name for name, _ in report.phases] == ["a", "b"]
        assert fired == [1] and report.actions == {"poke": "ok"}
        assert report.errors == 0 and (0.5, 1.0) in pools
        assert report.snapshot()["phases"]["a"]["completed"] > 0

    def test_noisy_neighbor_thread_mode_isolation(self, workload):
        tenancy = TenancyConfig(tenants=(
            TenantSpec(name="victim", max_queue=128, p99_slo_ms=500.0),
            TenantSpec(name="aggressor", quota_rps=5.0, burst=2.0)))
        with telemetry.Telemetry(sinks=[]) as tel:
            service = ScoringService(_runtime(workload), BatcherConfig(
                max_batch_size=8, max_wait_us=2_000, max_queue=256,
                tenancy=tenancy))
            with service:
                report = loadgen.run_noisy_neighbor(
                    service.submit,
                    lambda i, phase, tenant: _tagged(workload, i, tenant),
                    victim_rate_rps=30.0, aggressor_rate_rps=30.0,
                    scenario=_short_scenario())
            snap = tel.snapshot()
        gate = report.isolation(500.0)
        assert gate["pass"], gate
        assert report.victim.failed == 0 and report.victim.completed > 0
        assert report.aggressor.shed > 0
        counters = snap["counters"]
        assert counters["serving_tenant_aggressor_shed_total"] == \
            report.aggressor.shed
        assert counters["serving_tenant_victim_requests_total"] >= \
            report.victim.completed
