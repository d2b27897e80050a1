"""The port's telemetry hub, circuit breaker and serving telemetry against
the JAX package's, on the CPU: histogram quantiles and summaries, counters,
gauges and registry snapshots, ``TraceContext`` header and word round
trips, span nesting and the sinks' files, the hub install/restore, and
the breaker's state machine — each fed the same inputs in both packages.
"""

import json
import os
import threading

import numpy as np
import pytest

from photon_ml_tpu import telemetry as ref_tel
from photon_ml_tpu.chaos.breaker import CircuitBreaker as RefBreaker
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.chaos import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


def _observed(pkg, values):
    h = pkg.Histogram(threading.Lock())
    for v in values:
        h.observe(v)
    return h


class TestHistogram:
    @pytest.mark.parametrize("dist", ["exponential", "lognormal", "uniform",
                                      "spiky"])
    def test_quantiles_and_summary_match_reference(self, dist):
        rng = np.random.default_rng(len(dist))
        values = {
            "exponential": rng.exponential(3e-3, size=2000),
            "lognormal": rng.lognormal(0.0, 2.0, size=500),
            "uniform": rng.uniform(-1.0, 5.0, size=300),
            "spiky": np.r_[np.full(99, 1e-4), [10.0]],
        }[dist]
        ours, ref = _observed(telemetry, values), _observed(ref_tel, values)
        for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert ours.quantile(q) == ref.quantile(q), q
        assert ours.summary() == ref.summary()
        assert ours.transport() == ref.transport()

    def test_quantile_within_a_bucket_of_the_order_statistic(self):
        values = np.random.default_rng(1).exponential(1.0, size=5000)
        h = _observed(telemetry, values)
        for q in (0.5, 0.9, 0.99):
            exact = float(np.quantile(values, q))
            assert abs(h.quantile(q) - exact) <= 0.26 * exact

    def test_empty_and_absorb_match_reference(self):
        assert _observed(telemetry, []).quantile(0.5) is None
        a = _observed(telemetry, [1.0, 2.0])
        b = _observed(ref_tel, [1.0, 2.0])
        src = _observed(telemetry, [3.0, 4.0, 5.0]).transport()
        a.absorb_delta(src)
        b.absorb_delta(src)
        assert a.summary() == b.summary()


class TestRegistry:
    def _fill(self, reg):
        reg.counter("serving_requests_total").inc()
        reg.counter("serving_requests_total").inc(4)
        reg.gauge("serving_batch_occupancy").set(0.75)
        reg.gauge("serving_degraded").set(np.int64(1))
        for v in (0.001, 0.002, 0.004):
            reg.histogram("serving_request_latency_seconds").observe(v)
        return reg

    def test_snapshot_matches_reference(self):
        ours = self._fill(telemetry.MetricsRegistry())
        ref = self._fill(ref_tel.MetricsRegistry())
        assert ours.snapshot() == ref.snapshot()
        assert ours.transport_snapshot() == ref.transport_snapshot()

    def test_kind_conflict_refused_like_reference(self):
        ours, ref = telemetry.MetricsRegistry(), ref_tel.MetricsRegistry()
        ours.counter("x")
        ref.counter("x")
        with pytest.raises(ValueError) as ref_err:
            ref.gauge("x")
        with pytest.raises(ValueError) as err:
            ours.gauge("x")
        assert str(err.value) == str(ref_err.value)

    def test_disabled_registry_is_a_noop(self):
        reg = telemetry.MetricsRegistry(enabled=False)
        reg.counter("c").inc()
        reg.histogram("h").observe(1.0)
        assert reg.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}

    def test_threaded_counters_do_not_lose_increments(self):
        reg = telemetry.MetricsRegistry()

        def bump():
            for _ in range(1000):
                reg.counter("n").inc()

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert reg.snapshot()["counters"]["n"] == 8000

    def test_json_safe_matches_reference(self):
        import torch

        values = [1, 2.5, float("nan"), np.float32(0.5), np.arange(3),
                  np.zeros(40), {"a": (1, 2)}, ValueError("boom"), None]
        for v in values:
            assert telemetry.json_safe(v) == ref_tel.json_safe(v)
        # A device tensor is a placeholder, never materialized.
        assert telemetry.json_safe(torch.zeros(2, 3)).startswith("<array")


class TestTraceContext:
    @pytest.mark.parametrize("text", [
        "00000000000000ab-0000000000000001-1",
        "0123456789abcdef-fedcba9876543210-0",
        "00000000000000ab-0000000000000000-1",
        "0000000000000000-0000000000000001-1",
        "short-0000000000000001-1",
        "00000000000000ab-zz-1",
        "00000000000000ab-01",
        "", None, 7,
    ])
    def test_header_parse_matches_reference(self, text):
        ours = telemetry.TraceContext.parse(text)
        ref = ref_tel.TraceContext.parse(text)
        if ref is None:
            assert ours is None
        else:
            assert (ours.trace_id, ours.span_id, ours.sampled) == \
                (ref.trace_id, ref.span_id, ref.sampled)
            assert ours.header_value() == ref.header_value() == text
            assert ours.to_words() == ref.to_words()
            back = telemetry.TraceContext.from_words(*ours.to_words())
            assert back == ours

    def test_zero_trace_word_means_untraced(self):
        assert telemetry.TraceContext.from_words(0, 5, 1) is None
        assert ref_tel.TraceContext.from_words(0, 5, 1) is None

    def test_adopted_context_stitches_spans(self, tmp_path):
        with telemetry.Telemetry(output_dir=str(tmp_path)) as hub:
            hub.configure_tracing(sample_every=1)
            ctx = telemetry.TraceContext("00000000000000ab", 0x77, True)
            with hub.adopt(ctx), hub.span("serving.http_score", rows=2):
                prop = hub.propagation_context()
        assert prop.trace_id == "00000000000000ab"
        spans = [json.loads(line) for line in
                 open(tmp_path / "events.jsonl")
                 if '"span"' in line]
        span = [s for s in spans if s.get("name") == "serving.http_score"]
        assert span and span[0]["trace"] == "00000000000000ab"
        assert span[0]["rparent"] == f"{0x77:016x}"
        assert span[0]["attrs"] == {"rows": 2}


class TestHub:
    def test_current_defaults_to_disabled_null(self):
        hub = telemetry.current()
        assert not hub.enabled and hub.span("x") is telemetry.NULL.span("y")

    def test_install_restore_nesting(self, tmp_path):
        outer = telemetry.Telemetry(sinks=[])
        with outer:
            assert telemetry.current() is outer
            with telemetry.Telemetry(sinks=[]) as inner:
                assert telemetry.current() is inner
            assert telemetry.current() is outer
        assert telemetry.current() is telemetry.NULL

    def test_sinks_write_valid_files(self, tmp_path):
        with telemetry.Telemetry(output_dir=str(tmp_path),
                                 run_name="t") as hub:
            with hub.span("outer", k=1):
                with hub.span("inner"):
                    hub.event("tick", n=2)
                hub.counter("serving_batches_total").inc(3)
        records = [json.loads(line)
                   for line in open(tmp_path / "events.jsonl")]
        assert records[0]["type"] == "meta"
        names = [r.get("name") for r in records]
        assert {"outer", "inner", "tick"} <= set(names)
        trace = json.load(open(tmp_path / "trace.json"))
        assert isinstance(trace, (list, dict))
        metrics = json.load(open(tmp_path / "metrics.json"))
        assert metrics["counters"]["serving_batches_total"] == 3

    def test_flight_recorder_dump(self, tmp_path):
        with telemetry.Telemetry(output_dir=str(tmp_path)) as hub:
            hub.event("serving.degraded", error="x")
            path = hub.dump_flight_recorder("test")
        dump = json.load(open(path))
        assert dump["reason"] == "test"
        assert any(r.get("name") == "serving.degraded"
                   for r in dump["events"])

    def test_serving_metric_names_match_reference(self, tmp_path):
        """The same batch through both packages' runtimes under a hub
        registers the same serving metric names."""
        from photon_ml_tpu.serving.runtime import (
            RuntimeConfig as RefConfig,
            ScoringRuntime as RefRuntime,
        )
        from photon_ml_tpu.serving.synthetic import (
            SyntheticWorkload as RefWorkload,
        )
        from photon_ml_tpu_torch.serving.runtime import (
            RuntimeConfig,
            ScoringRuntime,
        )
        from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

        names = []
        for hubs, wl, rt_cls, cfg in (
                (telemetry, SyntheticWorkload(n_entities=8, seed=1),
                 ScoringRuntime, RuntimeConfig(max_batch_size=4,
                                               hot_entities=2,
                                               device="cpu")),
                (ref_tel, RefWorkload(n_entities=8, seed=1), RefRuntime,
                 RefConfig(max_batch_size=4, hot_entities=2))):
            with hubs.Telemetry(sinks=[]) as hub:
                rt = rt_cls(wl.model, wl.index_maps, cfg)
                rt.score_rows([rt.parse_request(wl.request(i))
                               for i in range(4)])
                snap = hub.snapshot()
            names.append({k: sorted(snap[k]) for k in snap})
        assert names[0] == names[1]


class TestBreaker:
    def test_state_machine_matches_reference(self):
        t = [0.0]
        ours = CircuitBreaker(cooldown_seconds=2.0, failure_threshold=2,
                              clock=lambda: t[0])
        ref = RefBreaker(cooldown_seconds=2.0, failure_threshold=2,
                         clock=lambda: t[0])
        script = ["ok", "fail", "allow", "fail", "allow", "t1", "allow",
                  "t3", "allow", "allow", "fail", "t6", "allow", "ok",
                  "allow"]
        for step in script:
            for b in (ours, ref):
                if step == "ok":
                    b.record_success()
                elif step == "fail":
                    b.record_failure()
            if step.startswith("t"):
                t[0] = float(step[1:])
            if step == "allow":
                assert ours.allow_request() == ref.allow_request()
            assert ours.state == ref.state, step
            assert ours.snapshot() == ref.snapshot(), step
        assert {CLOSED, OPEN, HALF_OPEN} == {"closed", "open", "half_open"}
