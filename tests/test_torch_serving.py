"""Online serving of the port against the JAX package's, on the CPU: the
runtime (bucket ladder, hot/cold LRU, degraded mode), the micro-batcher,
the service and its HTTP endpoint, the selfcheck and the load generators.

Across the packages the same seeded ``SyntheticWorkload`` model and
requests go through both runtimes: margins and means within 1e-6 of
Σ|x·w| of each row, parse refusals with the reference's messages, the
LRU's ``hot_keys`` sequence and the ``/stats`` and ``/healthz`` key sets
exactly the reference's.  Inside the port the reference's bitwise
contracts hold: batched == single at every bucket, hot == cold.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photon_ml_tpu.game.model import FixedEffectModel as RefFixed
from photon_ml_tpu.serving.runtime import (
    RuntimeConfig as RefRuntimeConfig,
    ScoringRuntime as RefRuntime,
)
from photon_ml_tpu.serving.service import ScoringService as RefService
from photon_ml_tpu.serving.synthetic import SyntheticWorkload as RefWorkload
from photon_ml_tpu_torch.convert import game_model_from_numpy
from photon_ml_tpu_torch.serving import kernels
from photon_ml_tpu_torch.serving.batcher import (
    BatcherConfig,
    DeadlineExceededError,
    MicroBatcher,
    RejectedError,
)
from photon_ml_tpu_torch.serving.runtime import (
    RuntimeConfig,
    ScoringRuntime,
    _host_mean,
)
from photon_ml_tpu_torch.serving.service import (
    ScoringService,
    start_http_server,
)
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workload():
    return SyntheticWorkload(n_entities=32, seed=7, unknown_rate=0.1)


@pytest.fixture(scope="module")
def ref_workload():
    return RefWorkload(n_entities=32, seed=7, unknown_rate=0.1)


def _runtime(workload, **kwargs):
    cfg = RuntimeConfig(**{"max_batch_size": 8, "hot_entities": 8,
                           "device": "cpu", **kwargs})
    return ScoringRuntime(workload.model, workload.index_maps, cfg)


def _ref_runtime(ref_workload, **kwargs):
    cfg = RefRuntimeConfig(**{"max_batch_size": 8, "hot_entities": 8,
                              **kwargs})
    return RefRuntime(ref_workload.model, ref_workload.index_maps, cfg)


def _rows(runtime, workload, n, start=0):
    return [runtime.parse_request(workload.request(i))
            for i in range(start, start + n)]


def port_model(ref_model):
    """The reference's GAME model as the port's, through numpy."""
    coords = {}
    for name, sub in ref_model.models.items():
        if isinstance(sub, RefFixed):
            coords[name] = {
                "feature_shard": sub.feature_shard,
                "means": np.asarray(sub.model.coefficients.means),
            }
        else:
            coords[name] = {
                "feature_shard": sub.feature_shard,
                "entity_key": sub.entity_key,
                "n_features": sub.n_features,
                "coefficients": sub.coefficients,
            }
    return game_model_from_numpy(coords, ref_model.task, device="cpu")


def _abs_scale(workload, rows):
    """Σ|terms| of each row's margin, in float64: |offset| + Σ|x·w| over
    the fixed effect + Σ|x·w_e| over the entity's coefficients."""
    fixed = workload.model.models["fixed"]
    w = fixed.model.coefficients.means.numpy().astype(np.float64)
    re = workload.model.models["per_entity"]
    out = []
    for r in rows:
        s = abs(r.offset)
        x = r.features.get(workload.fixed_shard)
        if x is not None:
            s += np.abs(x.astype(np.float64) * w).sum()
        key = r.ids.get(workload.entity_key)
        xr = r.features.get(workload.re_shard)
        if key in re.coefficients and xr is not None:
            coef = kernels.dense_coefficient_rows(re, [key])[0]
            s += np.abs(xr.astype(np.float64) * coef).sum()
        out.append(s)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

class TestAgainstReference:
    def test_synthetic_workload_draws_the_reference_model(
            self, workload, ref_workload):
        ref_w = np.asarray(
            ref_workload.model.models["fixed"].model.coefficients.means)
        w = workload.model.models["fixed"].model.coefficients.means
        assert w.numpy().tobytes() == ref_w.tobytes()
        ref_t = ref_workload.model.models["per_entity"].coefficients
        t = workload.model.models["per_entity"].coefficients
        assert list(t) == list(ref_t)
        for k in t:
            assert t[k][0].tobytes() == ref_t[k][0].tobytes()
            assert t[k][1].tobytes() == ref_t[k][1].tobytes()
        for i in range(20):
            assert workload.request(i) == ref_workload.request(i)

    def test_game_model_from_numpy_builds_the_same_model(
            self, workload, ref_workload):
        m = port_model(ref_workload.model)
        assert list(m.models) == list(workload.model.models)
        assert m.task == "logistic"
        a = m.models["fixed"].model.coefficients.means
        b = workload.model.models["fixed"].model.coefficients.means
        assert a.numpy().tobytes() == b.numpy().tobytes()
        assert m.models["per_entity"].n_features == 4

    @pytest.mark.parametrize("fused", [True, False])
    @pytest.mark.parametrize("n", [1, 3, 8])
    def test_margins_and_means_match_reference(self, workload, ref_workload,
                                               fused, n):
        runtime = ScoringRuntime(
            port_model(ref_workload.model), ref_workload.index_maps,
            RuntimeConfig(max_batch_size=8, hot_entities=8, fused=fused,
                          device="cpu"))
        ref = _ref_runtime(ref_workload, fused=fused)
        for start in (0, 40):
            reqs = [ref_workload.request(i) for i in range(start, start + n)]
            rows = [runtime.parse_request(r) for r in reqs]
            m, e = runtime.score_rows(rows)
            rm, re_ = ref.score_rows([ref.parse_request(r) for r in reqs])
            scale = _abs_scale(workload, rows)
            assert np.all(np.abs(m.astype(np.float64) - rm) <= 1e-6 * scale)
            assert np.all(np.abs(e.astype(np.float64) - re_)
                          <= 1e-6 * scale + 1e-7)

    @pytest.mark.parametrize("task", ["squared", "poisson",
                                      "logistic_regression"])
    def test_other_links_match_reference(self, task):
        ref_wl = RefWorkload(n_entities=16, seed=2, task=task)
        wl = SyntheticWorkload(n_entities=16, seed=2, task=task)
        runtime = ScoringRuntime(wl.model, wl.index_maps, RuntimeConfig(
            max_batch_size=4, hot_entities=4, device="cpu"))
        ref = RefRuntime(ref_wl.model, ref_wl.index_maps,
                         RefRuntimeConfig(max_batch_size=4, hot_entities=4))
        reqs = [wl.request(i) for i in range(4)]
        rows = [runtime.parse_request(r) for r in reqs]
        m, e = runtime.score_rows(rows)
        rm, re_ = ref.score_rows([ref.parse_request(r) for r in reqs])
        scale = _abs_scale(wl, rows)
        np.testing.assert_array_less(np.abs(m - rm), 1e-6 * scale + 1e-12)
        np.testing.assert_allclose(e, re_, rtol=1e-6 * scale.max(),
                                   atol=1e-7)

    def test_lru_hot_keys_sequence_matches_reference(self, workload,
                                                     ref_workload):
        runtime = _runtime(workload, hot_entities=3, max_batch_size=4)
        ref = _ref_runtime(ref_workload, hot_entities=3, max_batch_size=4)
        port_hot, ref_hot = runtime.random[0].hot, ref.random[0].hot
        rng = np.random.default_rng(5)
        for step in range(30):
            n = int(rng.integers(1, 5))
            reqs = [workload.request(int(i))
                    for i in rng.integers(0, 200, size=n)]
            runtime.score_rows([runtime.parse_request(r) for r in reqs])
            ref.score_rows([ref.parse_request(r) for r in reqs])
            assert port_hot.hot_keys() == ref_hot.hot_keys(), step
        for key in ("hits", "misses", "inserts", "evictions"):
            assert getattr(port_hot, key) == getattr(ref_hot, key), key
        assert runtime.random[0].unknown == ref.random[0].unknown

    @pytest.mark.parametrize("request_obj", [
        "not a dict",
        {"dense": {"nope": [1.0]}},
        {"dense": {"global": [1.0, 2.0]}},
        {"features": {"nope": [["g0", "", 1.0]]}},
        {"priority": "urgent"},
        {"tenant": 7},
    ])
    def test_parse_refusals_match_reference(self, workload, ref_workload,
                                            request_obj):
        runtime = _runtime(workload)
        ref = _ref_runtime(ref_workload)
        with pytest.raises(ValueError) as ref_err:
            ref.parse_request(request_obj)
        with pytest.raises(ValueError) as err:
            runtime.parse_request(request_obj)
        assert str(err.value) == str(ref_err.value)

    def test_batch_size_refusal_matches_reference(self, workload,
                                                  ref_workload):
        runtime = _runtime(workload)
        ref = _ref_runtime(ref_workload)
        with pytest.raises(ValueError) as ref_err:
            ref.score_rows(_rows(ref, ref_workload, 9))
        with pytest.raises(ValueError) as err:
            runtime.score_rows(_rows(runtime, workload, 9))
        assert str(err.value) == str(ref_err.value)

    def test_stats_and_healthz_keys_match_reference(self, workload,
                                                    ref_workload):
        def keys(d, prefix=""):
            out = set()
            for k, v in d.items():
                out.add(prefix + k)
                if isinstance(v, dict) and k not in ("hot_sets",
                                                     "tenant_versions"):
                    out |= keys(v, prefix + k + ".")
            return out

        svc = ScoringService(_runtime(workload))
        ref_svc = RefService(_ref_runtime(ref_workload))
        with svc, ref_svc:
            svc.score(workload.request(0))
            ref_svc.score(ref_workload.request(0))
            assert keys(svc.stats()) == keys(ref_svc.stats())
            assert keys(svc.healthz()) == keys(ref_svc.healthz())
            hs = svc.stats()["runtime"]["hot_sets"]["per_entity"]
            ref_hs = ref_svc.stats()["runtime"]["hot_sets"]["per_entity"]
            assert hs == ref_hs

    def test_host_mean_matches_reference(self):
        from photon_ml_tpu.serving.runtime import _host_mean as ref_mean

        m = np.asarray([-90.0, -3.5, -1e-3, 0.0, 2.25, 40.0], np.float32)
        for task in ("logistic", "poisson", "squared"):
            assert _host_mean(task, m).tobytes() == \
                ref_mean(task, m).tobytes()


# ---------------------------------------------------------------------------
# The port's own contracts (the reference's tests/test_serving.py)
# ---------------------------------------------------------------------------

class TestRuntimeParity:
    @pytest.mark.parametrize("fused", [True, False])
    def test_batched_bit_identical_to_single_all_buckets(self, workload,
                                                         fused):
        runtime = _runtime(workload, fused=fused)
        rows = _rows(runtime, workload, runtime.buckets[-1])
        reference = [runtime.score_rows([r]) for r in rows]
        ref_m = np.asarray([m[0] for m, _ in reference], np.float32)
        ref_e = np.asarray([e[0] for _, e in reference], np.float32)
        for n in range(1, len(rows) + 1):
            margins, means = runtime.score_rows(rows[:n])
            assert margins.tobytes() == ref_m[:n].tobytes(), n
            assert means.tobytes() == ref_e[:n].tobytes(), n

    def test_batched_bit_identical_at_full_width(self):
        """phase 7's widths (fixed 512, per-user 8): a row's bits do not
        depend on its position in any bucket."""
        wl = SyntheticWorkload(n_entities=40, fixed_dim=512, re_dim=8,
                               seed=11)
        runtime = ScoringRuntime(wl.model, wl.index_maps, RuntimeConfig(
            max_batch_size=16, hot_entities=8, device="cpu"))
        rows = _rows(runtime, wl, 16)
        single = np.asarray([runtime.score_rows([r])[0][0] for r in rows],
                            np.float32)
        for n in (2, 5, 16):
            m, _ = runtime.score_rows(rows[-n:])
            assert m.tobytes() == single[-n:].tobytes(), n

    def test_parity_unchanged_by_hot_cold_state(self, workload):
        runtime = _runtime(workload, hot_entities=4)
        row = runtime.parse_request(workload.request(1))
        cold = runtime.score_rows([row])
        hot = runtime.score_rows([row])
        assert runtime.random[0].hot.hits == 1
        assert cold[0].tobytes() == hot[0].tobytes()
        assert cold[1].tobytes() == hot[1].tobytes()

    def test_offset_and_unknown_entity(self, workload):
        runtime = _runtime(workload)
        req = workload.request(2)
        req["ids"] = {"userId": "never-trained"}
        base = runtime.score_rows([runtime.parse_request(req)])[0][0]
        req2 = dict(req, offset=(req.get("offset") or 0.0) + 1.0)
        shifted = runtime.score_rows([runtime.parse_request(req2)])[0][0]
        assert shifted == pytest.approx(base + 1.0, abs=1e-6)
        assert runtime.stats()["hot_sets"]["per_entity"][
            "unknown_entities"] >= 1

    def test_matches_batch_transformer(self, workload):
        import scipy.sparse as sp

        from photon_ml_tpu_torch.game.estimator import GameTransformer

        runtime = _runtime(workload)
        rows = _rows(runtime, workload, 8)
        margins, _ = runtime.score_rows(rows)
        shards = {
            s: sp.csr_matrix(np.stack([r.features[s] for r in rows]))
            for s in (workload.fixed_shard, workload.re_shard)
        }
        ids = {workload.entity_key: np.asarray(
            [r.ids.get(workload.entity_key) for r in rows], object)}
        offsets = np.asarray([r.offset for r in rows], np.float32)
        batch = GameTransformer(workload.model).transform(
            shards, ids, offsets)
        np.testing.assert_allclose(margins, batch, rtol=1e-5, atol=1e-6)

    def test_named_features_resolve_through_index_map(self, workload):
        runtime = _runtime(workload)
        dense_req = workload.request(3)
        named_req = {
            "features": {
                workload.fixed_shard: [
                    {"name": f"g{j}", "term": "", "value": v}
                    for j, v in enumerate(
                        dense_req["dense"][workload.fixed_shard])
                ] + [{"name": "UNSEEN", "term": "", "value": 99.0}],
                workload.re_shard: [
                    [f"r{j}", "", v]
                    for j, v in enumerate(dense_req["dense"][workload.re_shard])
                ],
            },
            "ids": dense_req["ids"],
            "offset": dense_req["offset"],
        }
        a = runtime.score_rows([runtime.parse_request(dense_req)])[0][0]
        b = runtime.score_rows([runtime.parse_request(named_req)])[0][0]
        assert np.float32(a).tobytes() == np.float32(b).tobytes()

    def test_warmup_runs_every_bucket_once(self, workload):
        runtime = ScoringRuntime(workload.model, workload.index_maps,
                                 RuntimeConfig(max_batch_size=8,
                                               hot_entities=4, warmup=False,
                                               device="cpu"))
        assert runtime.warmup_compiles == 0
        assert runtime.warm_up() == len(runtime.buckets) == 4
        assert runtime.warm_up() == 0
        assert runtime.ready

    def test_hot_table_is_written_in_place(self, workload):
        """The hot table stays one (H+1, D) tensor, row 0 zero, and its
        resident rows are the entities' dense coefficients."""
        runtime = _runtime(workload, hot_entities=4)
        hot = runtime.random[0].hot
        table = hot.table
        runtime.score_rows(_rows(runtime, workload, 8))
        assert hot.table is table and table.shape == (5, 4)
        assert not table[0].any()
        for key, slot in hot._slots.items():
            dense = kernels.dense_coefficient_rows(
                runtime.random[0].model, [key])[0]
            assert table[slot].numpy().tobytes() == dense.tobytes()

    def test_factored_or_unknown_coordinate_refused(self, workload):
        from photon_ml_tpu_torch.game.model import GameModel

        with pytest.raises(TypeError, match="unsupported coordinate type"):
            ScoringRuntime(GameModel({"x": object()}, "logistic"),
                           config=RuntimeConfig(device="cpu"))

    def test_default_device_is_the_card(self, workload, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ScoringRuntime(workload.model, workload.index_maps)


class TestDegradedMode:
    def test_transient_failure_degrades_then_repromotes(self, workload,
                                                        monkeypatch):
        runtime = _runtime(workload, breaker_cooldown_s=0.0)
        rows = _rows(runtime, workload, 4)
        healthy, _ = _runtime(workload).score_rows(rows)
        real = runtime._score_rows_device
        calls = {"n": 0}

        def flaky(batch):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("UNAVAILABLE: device lost")
            return real(batch)

        monkeypatch.setattr(runtime, "_score_rows_device", flaky)
        m, _ = runtime.score_rows(rows)
        assert runtime.degraded and runtime.degraded_batches == 1
        np.testing.assert_allclose(m, healthy, rtol=1e-5, atol=1e-6)
        m2, _ = runtime.score_rows(rows)
        assert not runtime.degraded and runtime.repromotions == 1
        assert m2.tobytes() == healthy.tobytes()
        assert runtime.stats()["breaker"]["state"] == "closed"

    @pytest.mark.parametrize("message", [
        "CUDA error: an illegal memory access was encountered",
        "serve_margins launch failed: CUDA error 700 (UNAVAILABLE)",
        "nvcc failed (1) building serve_margins",
    ])
    def test_cuda_and_build_errors_raise_not_degrade(self, workload,
                                                     monkeypatch, message):
        runtime = _runtime(workload)

        def broken(batch):
            raise RuntimeError(message)

        monkeypatch.setattr(runtime, "_score_rows_device", broken)
        with pytest.raises(RuntimeError, match="CUDA error|nvcc"):
            runtime.score_rows(_rows(runtime, workload, 2))
        assert not runtime.degraded and runtime.degraded_batches == 0

    @pytest.mark.parametrize("message", [
        "UNAVAILABLE: device lost",
        "INTERNAL ASSERT FAILED at aten/src/ATen/native/Foo.cpp:1",
        "ABORTED: stream capture cancelled",
    ])
    def test_card_runtime_raises_every_failure(self, workload, monkeypatch,
                                               message):
        """A runtime on the card degrades on nothing: every failure of its
        device path raises, whatever the watchdog would call it."""
        runtime = _runtime(workload)
        runtime.device = torch.device("cuda")

        def broken(batch):
            raise RuntimeError(message)

        monkeypatch.setattr(runtime, "_score_rows_device", broken)
        with pytest.raises(RuntimeError, match=message.split(":")[0]):
            runtime.score_rows(_rows(runtime, workload, 2))
        assert not runtime.degraded and runtime.degraded_batches == 0
        assert runtime.device_failures == 0

    def test_build_failure_raises_at_warm_up(self, workload, monkeypatch):
        from photon_ml_tpu_torch.ops import _kernels

        def no_nvcc(*names):
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(_kernels, "build_libraries", no_nvcc)
        runtime = ScoringRuntime(workload.model, workload.index_maps,
                                 RuntimeConfig(warmup=False, device="cpu"))
        runtime.device = torch.device("cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            runtime.warm_up()


class TestHotSetLRU:
    def test_eviction_and_refill(self, workload):
        runtime = _runtime(workload, hot_entities=2)
        hot = runtime.random[0].hot

        def score_entity(i, ent):
            req = workload.request(i)
            req["ids"] = {workload.entity_key: ent}
            return runtime.score_rows([runtime.parse_request(req)])[0][0]

        s1 = score_entity(0, "u1")
        score_entity(1, "u2")
        assert hot.hot_keys() == ["u1", "u2"]
        score_entity(2, "u1")
        assert hot.hits == 1 and hot.hot_keys() == ["u2", "u1"]
        score_entity(3, "u3")
        assert hot.evictions == 1 and hot.hot_keys() == ["u1", "u3"]
        s1_again = score_entity(0, "u1")
        assert np.float32(s1).tobytes() == np.float32(s1_again).tobytes()
        score_entity(4, "u2")
        assert "u2" in hot.hot_keys() and hot.misses == 4

    def test_zero_capacity_serves_cold_only(self, workload):
        runtime = _runtime(workload, hot_entities=0)
        ref = _runtime(workload, hot_entities=8)
        rows = _rows(runtime, workload, 8)
        a, _ = runtime.score_rows(rows)
        b, _ = ref.score_rows(rows)
        assert a.tobytes() == b.tobytes()
        assert runtime.random[0].hot.size == 0

    def test_slot_reused_within_one_batch(self, workload):
        """More cold entities in one batch than the hot set holds: each
        slot is written once, with the entity that holds it at the end."""
        runtime = _runtime(workload, hot_entities=2)
        reqs = []
        for i, ent in enumerate(["u1", "u2", "u3", "u4", "u5"]):
            req = workload.request(i)
            req["ids"] = {workload.entity_key: ent}
            reqs.append(req)
        runtime.score_rows([runtime.parse_request(r) for r in reqs])
        hot = runtime.random[0].hot
        assert hot.hot_keys() == ["u4", "u5"]
        for key, slot in hot._slots.items():
            dense = kernels.dense_coefficient_rows(
                runtime.random[0].model, [key])[0]
            assert hot.table[slot].numpy().tobytes() == dense.tobytes()


class TestMicroBatcher:
    def test_coalesces_concurrent_submissions(self, workload):
        runtime = _runtime(workload)
        batcher = MicroBatcher(runtime, BatcherConfig(
            max_batch_size=8, max_wait_us=50_000, max_queue=64))
        rows = _rows(runtime, workload, 8)
        reference = np.asarray(
            [runtime.score_rows([r])[0][0] for r in rows], np.float32)
        futures = [batcher.submit(r) for r in rows]
        batcher.start()
        got = np.asarray([f.result(timeout=30)["score"] for f in futures],
                         np.float32)
        batcher.stop()
        assert got.tobytes() == reference.tobytes()
        stats = batcher.stats()
        assert stats["batches"] == 1 and stats["max_batch_rows"] == 8

    def test_queue_full_rejection(self, workload):
        runtime = _runtime(workload)
        batcher = MicroBatcher(runtime, BatcherConfig(max_queue=3))
        rows = _rows(runtime, workload, 4)
        for r in rows[:3]:
            batcher.submit(r)
        with pytest.raises(RejectedError, match="UNAVAILABLE"):
            batcher.submit(rows[3])
        stats = batcher.stats()
        assert stats["rejected"] == 1 and stats["failed_transient"] == 1
        batcher.start()
        batcher.stop()

    def test_deadline_timeout_classified_transient(self, workload):
        from photon_ml_tpu_torch.utils.watchdog import RetryPolicy

        runtime = _runtime(workload)
        batcher = MicroBatcher(runtime, BatcherConfig())
        fut = batcher.submit(_rows(runtime, workload, 1)[0], timeout_ms=1.0)
        time.sleep(0.02)
        batcher.start()
        with pytest.raises(DeadlineExceededError, match="DEADLINE_EXCEEDED"):
            fut.result(timeout=30)
        batcher.stop()
        stats = batcher.stats()
        assert stats["expired"] == 1 and stats["failed_transient"] == 1
        verdict = RetryPolicy().classify(fut.exception())
        assert verdict.transient and verdict.matched == "DEADLINE_EXCEEDED"

    def test_default_timeout_from_config(self, workload):
        runtime = _runtime(workload)
        batcher = MicroBatcher(runtime, BatcherConfig(default_timeout_ms=1.0))
        fut = batcher.submit(_rows(runtime, workload, 1)[0])
        time.sleep(0.02)
        batcher.start()
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=30)
        batcher.stop()

    def test_stop_fails_leftovers_transiently(self, workload):
        """Rows still queued when the batcher stops fail with the
        transient UNAVAILABLE vocabulary (a dead dispatch loop here)."""

        class _Dead:
            def join(self, timeout=None):
                pass

        runtime = _runtime(workload)
        batcher = MicroBatcher(runtime, BatcherConfig())
        batcher._thread = _Dead()
        fut = batcher.submit(_rows(runtime, workload, 1)[0])
        batcher.stop()
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            fut.result(timeout=5)


class TestScoringService:
    def test_concurrent_clients_stress(self, workload):
        runtime = _runtime(workload, max_batch_size=16)
        n_clients, per_client = 6, 15
        requests = [workload.request(i)
                    for i in range(n_clients * per_client)]
        reference = np.asarray([
            runtime.score_rows([runtime.parse_request(r)])[0][0]
            for r in requests], np.float32)
        service = ScoringService(runtime, BatcherConfig(
            max_batch_size=16, max_wait_us=500, max_queue=512))
        results = np.zeros(len(requests), np.float32)
        errors: list = []

        def client(c):
            for k in range(per_client):
                i = c * per_client + k
                try:
                    results[i] = np.float32(
                        service.score(requests[i], timeout=60)["score"])
                except Exception as exc:  # noqa: BLE001
                    errors.append((i, exc))

        with service:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        assert not errors
        assert results.tobytes() == reference.tobytes()
        assert service.stats()["batcher"]["completed"] == len(requests)

    def test_score_many_reports_per_row_errors(self, workload):
        service = ScoringService(_runtime(workload))
        good = workload.request(0)
        with service:
            results = service.score_many([good, {"dense": {"nope": [1.0]}},
                                          good])
        assert "score" in results[0] and "score" in results[2]
        assert results[1]["kind"] == "bad_request"

    def test_http_endpoint(self, workload):
        runtime = _runtime(workload)
        reference = [float(runtime.score_rows(
            [runtime.parse_request(workload.request(i))])[0][0])
            for i in range(3)]
        service = ScoringService(runtime)
        with service:
            server, _ = start_http_server(service, port=0)
            port = server.server_address[1]
            try:
                body = json.dumps(
                    {"rows": [workload.request(i) for i in range(3)]}
                ).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/score", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    assert resp.status == 200
                    results = json.loads(resp.read())["results"]
                assert [np.float32(r["score"]) for r in results] == \
                    [np.float32(r) for r in reference]
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz",
                        timeout=10) as resp:
                    assert json.loads(resp.read())["status"] == "ok"
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/stats", timeout=10) as resp:
                    assert json.loads(resp.read())["batcher"][
                        "completed"] >= 3
                bad = urllib.request.Request(
                    f"http://127.0.0.1:{port}/score",
                    data=json.dumps(
                        {"rows": [{"dense": {"nope": [1]}}]}).encode())
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(bad, timeout=10)
                assert e.value.code == 400
                assert json.loads(e.value.read())["results"][0]["kind"] == \
                    "bad_request"
            finally:
                server.shutdown()
                server.server_close()

    def test_glm_model_serves(self):
        from photon_ml_tpu_torch.convert import glm_from_numpy

        rng = np.random.default_rng(5)
        w = rng.normal(size=6).astype(np.float32)
        runtime = ScoringRuntime.from_glm_model(
            glm_from_numpy(w, "logistic", device="cpu"), shard="features",
            config=RuntimeConfig(max_batch_size=4, hot_entities=0,
                                 device="cpu"))
        x = rng.normal(size=6).astype(np.float32)
        margins, means = runtime.score_rows([runtime.parse_request(
            {"dense": {"features": x.tolist()}})])
        assert margins[0] == pytest.approx(float(np.sum(x * w)), rel=1e-5)
        assert 0.0 < means[0] < 1.0

    def test_service_over_supervisor_scores_like_a_runtime(self, workload):
        """A service over a supervisor of two in-process replicas scores
        bitwise a single runtime."""
        from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor

        requests = [workload.request(i) for i in range(12)]
        single = _runtime(workload)
        want = np.asarray([single.score_rows([single.parse_request(r)])[0][0]
                           for r in requests], np.float32)
        sup = ReplicaSupervisor(lambda: _runtime(workload), n_replicas=2,
                                probe_interval_s=0.05)
        with ScoringService(sup) as service:
            got = np.asarray([np.float32(service.submit(r).result(
                timeout=30)["score"]) for r in requests], np.float32)
            assert service.stats()["supervisor"]["healthy"] == 2
        assert got.tobytes() == want.tobytes()


class TestSelfcheckAndLoadGen:
    def test_selfcheck_passes(self, tmp_path):
        from photon_ml_tpu_torch.serving.__main__ import run_selfcheck

        assert run_selfcheck(str(tmp_path), device="cpu") == []
        with open(tmp_path / "metrics.json") as f:
            snap = json.load(f)
        assert snap["histograms"]["serving_request_latency_seconds"][
            "count"] >= 24
        assert snap["gauges"]["serving_batch_occupancy"] > 0

    def test_process_selfcheck_passes(self, tmp_path):
        """``--selfcheck --workers 2``'s pass: parity x3, a SIGKILL under
        load, a cross-process swap and rollback, a leak-free shutdown.
        (Here, not beside the pool tests: its segment gauge counts every
        publication of the process, and that module keeps a pool up.)"""
        from photon_ml_tpu_torch.serving.__main__ import (
            run_selfcheck_process,
        )

        assert run_selfcheck_process(str(tmp_path), 2, device="cpu") == []

    def test_cli_selfcheck_exits_zero(self, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "photon_ml_tpu_torch.serving",
             "--selfcheck", "--device", "cpu", "--output-dir",
             str(tmp_path)],
            cwd=ROOT, capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr
        assert "serving selfcheck PASSED" in out.stdout

    @pytest.mark.parametrize("argv,item", [
        (["--replicas", "2"], "7b"),
        (["--workers", "2"], "7b"),
        (["--shm-ingress"], "7b"),
        (["--metrics-port", "0"], "8a"),
        (["--tenant-report", "x.jsonl"], "8a"),
        (["--membership", "http://127.0.0.1:1"], "8c"),
    ])
    def test_cli_refuses_unported_flags(self, argv, item, capsys):
        """No flag of the reference is refused: the process tier's (item
        7b), the ops plane's (8a) and the cluster's (8c) parse to the
        reference's values; ``--fleet-join`` without ``--membership``
        exits 2 with the reference's message."""
        from photon_ml_tpu.serving.__main__ import (
            build_arg_parser as ref_parser,
        )
        from photon_ml_tpu.serving.__main__ import main as ref_main
        from photon_ml_tpu_torch.serving.__main__ import (
            build_arg_parser,
            main,
        )

        ours = vars(build_arg_parser().parse_args(
            ["--selfcheck", "--device", "cpu", *argv]))
        ref = vars(ref_parser().parse_args(["--selfcheck", *argv]))
        assert ours.pop("device") == "cpu"
        assert ours == ref
        if item != "8c":
            return
        verb = ["--fleet-join", "http://127.0.0.1:2"]
        assert main(verb) == 2
        err = capsys.readouterr().err
        assert "need --membership" in err
        assert ref_main(verb) == 2
        assert capsys.readouterr().err == err

    def test_closed_loop_loadgen(self, workload):
        from photon_ml_tpu_torch.serving import loadgen

        service = ScoringService(_runtime(workload, max_batch_size=16),
                                 BatcherConfig(max_batch_size=16,
                                               max_wait_us=200,
                                               max_queue=256))
        with service:
            report = loadgen.closed_loop(service.submit, workload.request,
                                         clients=4, duration_s=0.5)
        snap = report.snapshot()
        assert report.completed > 0 and report.errors == 0
        assert snap["latency_p99_ms"] >= snap["latency_p50_ms"] > 0

    def test_open_loop_loadgen(self, workload):
        from photon_ml_tpu_torch.serving import loadgen

        service = ScoringService(_runtime(workload, max_batch_size=16),
                                 BatcherConfig(max_batch_size=16,
                                               max_wait_us=200,
                                               max_queue=256))
        with service:
            report = loadgen.open_loop(service.submit, workload.request,
                                       rate_rps=100.0, duration_s=0.5)
        assert report.completed > 0 and report.errors == 0

    def test_loadgen_report_quantiles_match_reference(self):
        from photon_ml_tpu.serving.loadgen import LoadReport as RefReport
        from photon_ml_tpu_torch.serving.loadgen import LoadReport

        lat = np.random.default_rng(3).exponential(2.0, size=500)
        a = LoadReport("closed", 1.5, 500, 2, 0, lat).snapshot()
        b = RefReport("closed", 1.5, 500, 2, 0, lat).snapshot()
        assert a == b
