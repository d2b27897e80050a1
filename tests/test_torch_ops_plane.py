"""The port's live ops plane against the JAX package's, on the CPU.

Mirrors ``tests/test_ops_plane.py`` (the time-series sampler, the
Prometheus exporter, the flight recorder, the selfcheck),
``test_serving_ha.py``'s exporter readiness split and
``test_serving.py::TestTenantReport``, and holds the instrumented port
against the reference: the exposition of one registry snapshot is
byte-equal, the tenant report of one ``metrics_ts.jsonl`` is equal, and
the GLM and GAME drivers emit the same span and event names in the same
order with the same deterministic counters.  Inside the port, a run with
``--telemetry off`` writes the same model files byte for byte.
"""

import glob
import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu import telemetry as ref_tel
from photon_ml_tpu.data import libsvm as ref_libsvm
from photon_ml_tpu.drivers import game_scoring_driver as ref_scoring
from photon_ml_tpu.drivers import game_training_driver as ref_training
from photon_ml_tpu.drivers import glm_driver as ref_glm
from photon_ml_tpu.serving import __main__ as ref_serving_cli
from photon_ml_tpu_torch import chaos, telemetry
from photon_ml_tpu_torch.data import datasets
from photon_ml_tpu_torch.data.game_reader import write_game_avro
from photon_ml_tpu_torch.drivers import (
    game_scoring_driver,
    game_training_driver,
    glm_driver,
)
from photon_ml_tpu_torch.serving import __main__ as serving_cli
from photon_ml_tpu_torch.telemetry.exporter import (
    MetricsExporter,
    parse_prometheus_text,
    prometheus_text,
)
from photon_ml_tpu_torch.telemetry.timeseries import (
    TimeSeriesSampler,
    read_series,
)

sys.path.insert(0, os.path.dirname(__file__))
from test_game_drivers import _make_game_rows  # noqa: E402
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

N_TRAIN, N_VAL, D = 400, 200, 123
#: the reference's compile-cache events have no port counterpart, and a
#: solver registration counts only when its module is first imported while
#: a hub is current (import order, not the run).
_REF_ONLY = re.compile(r"^compile_cache|^solvers_registered_total$")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _get(port, route):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{route}", timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _sequence(out_dir, collapse=()):
    """(kind, name) of every span and event record in ``out_dir``'s
    events.jsonl, in order; names in ``collapse`` are dropped."""
    seq = []
    with open(os.path.join(out_dir, "events.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") not in ("span", "event"):
                continue
            if _REF_ONLY.match(rec["name"]) or rec["name"] in collapse:
                continue
            seq.append((rec["type"], rec["name"]))
    return seq


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        return json.load(f)


def _fill(pkg_tel, hub):
    """The same registry traffic into a hub of either package."""
    hub.counter("solver_iterations").inc(12)
    hub.counter("serving_requests_total").inc(3)
    hub.counter("h2d_bytes_total").inc(1 << 33)
    hub.gauge("hbm_live_bytes").set(1 << 20)
    hub.gauge("stream_effective_gbps").set(1.25)
    hub.gauge("serving_degraded").set(True)
    hub.gauge("run_note_count").set("not-numeric")  # skipped
    hub.gauge("odd-name.with dots").set(7)  # sanitized
    hub.gauge("nan_gauge").set(float("nan"))
    hub.gauge("inf_gauge").set(float("-inf"))
    for v in np.random.default_rng(3).exponential(2e-3, size=200):
        hub.histogram("serving_request_latency_seconds").observe(float(v))
    hub.histogram("empty_seconds")  # no observation: skipped


# ---------------------------------------------------------------------------
# Exposition
# ---------------------------------------------------------------------------

class TestExposition:
    def test_prometheus_text_is_byte_equal_to_the_references(self):
        with telemetry.Telemetry() as ours, ref_tel.Telemetry() as ref:
            _fill(telemetry, ours)
            _fill(ref_tel, ref)
            snap_o, snap_r = ours.snapshot(), ref.snapshot()
        text = prometheus_text(snap_o)
        assert text == ref_tel.prometheus_text(snap_r)
        assert text == ref_tel.prometheus_text(snap_o)
        parsed = parse_prometheus_text(text)
        assert parsed == ref_tel.parse_prometheus_text(text)
        assert parsed[("solver_iterations", "")] == 12
        assert parsed[("serving_degraded", "")] == 1.0
        assert parsed[("odd_name_with_dots", "")] == 7.0
        assert ("run_note_count", "") not in parsed
        assert ("empty_seconds_count", "") not in parsed
        assert parsed[("serving_request_latency_seconds_count", "")] == 200

    def test_fixed_snapshot_round_trips_and_refuses_garbage(self):
        snap = {
            "counters": {"serving_requests_total": 7},
            "gauges": {"hbm_live_bytes": 123, "run_name_count": "x"},
            "histograms": {
                "solver_wall_seconds": {
                    "count": 2, "sum": 3.0, "min": 1.0, "max": 2.0,
                    "mean": 1.5, "last": 2.0, "p50": 1.4, "p90": 1.9,
                    "p99": 2.0,
                },
            },
        }
        text = prometheus_text(snap)
        assert text == ref_tel.prometheus_text(snap)
        for parse in (parse_prometheus_text, ref_tel.parse_prometheus_text):
            parsed = parse(text)
            assert parsed[("serving_requests_total", "")] == 7
            assert parsed[("solver_wall_seconds_sum", "")] == 3.0
            assert parsed[("solver_wall_seconds",
                           '{quantile="0.99"}')] == 2.0
            with pytest.raises(ValueError, match="unparseable"):
                parse("this is } not exposition format\n")


# ---------------------------------------------------------------------------
# Time-series sampler
# ---------------------------------------------------------------------------

class TestTimeSeriesSampler:
    def test_brackets_run_with_monotone_snapshots(self, tmp_path):
        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            tel.counter("solver_iterations").inc(3)
            tel.gauge("hbm_live_bytes").set(4096)
            with TimeSeriesSampler(tel, interval_s=0.02) as sampler:
                time.sleep(0.07)
                tel.counter("solver_iterations").inc(4)
            assert not sampler.alive
        series = read_series(str(tmp_path / "metrics_ts.jsonl"))
        assert len(series) >= 2  # start + interval(s) + stop
        seqs = [r["seq"] for r in series]
        monos = [r["t_mono"] for r in series]
        assert seqs == list(range(len(series)))
        assert all(b > a for a, b in zip(monos, monos[1:]))
        assert series[-1]["counters"]["solver_iterations"] == 7
        assert series[-1]["gauges"]["hbm_live_bytes"] == 4096
        assert series[-1]["host"] == telemetry.host_identity()

    def test_stopped_sampler_still_brackets(self, tmp_path):
        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            sampler = TimeSeriesSampler(tel, interval_s=1e9).start()
            sampler.stop()
            sampler.stop()  # idempotent
        assert len(read_series(str(tmp_path / "metrics_ts.jsonl"))) == 2

    def test_rotation_before_a_write_that_would_pass_max_bytes(
            self, tmp_path):
        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            for i in range(64):
                tel.gauge(f"hbm_g{i}_bytes").set(i)
            sampler = TimeSeriesSampler(tel, interval_s=1e9,
                                        max_bytes=2048, keep=2)
            sampler.start()
            for _ in range(40):
                sampler.sample()
            sampler.stop()
        path = str(tmp_path / "metrics_ts.jsonl")
        assert os.path.exists(path) and os.path.exists(path + ".1")
        assert not os.path.exists(path + ".3")  # keep=2 bounds the set
        record = len(json.dumps(read_series(path)[-1])) + 1
        for p in (path, path + ".1", path + ".2"):
            if os.path.exists(p):
                # A file rotates once it holds more than max_bytes: at
                # most one record past the bound.
                assert os.path.getsize(p) <= 2048 + record
        seqs = [r["seq"] for p in (path + ".2", path + ".1", path)
                if os.path.exists(p) for r in read_series(p)]
        assert seqs == sorted(seqs) and seqs[-1] == 41

    def test_torn_tail_reads_like_the_reference(self, tmp_path):
        path = str(tmp_path / "metrics_ts.jsonl")
        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            tel.counter("solver_iterations").inc(2)
            sampler = TimeSeriesSampler(tel, interval_s=1e9).start()
            sampler.sample()
            sampler.stop()
        with open(path, "a") as f:
            f.write('{"seq": 3, "t_mono": 1.0, "coun')  # killed mid-write
        ours = read_series(path)
        assert len(ours) == 3
        assert ours == ref_tel.read_series(path)

    def test_disabled_hub_is_noop(self, tmp_path):
        tel = telemetry.Telemetry(output_dir=str(tmp_path / "off"),
                                  enabled=False)
        sampler = TimeSeriesSampler(tel, interval_s=0.01)
        sampler.start()
        assert not sampler.enabled and not sampler.alive
        sampler.stop()
        assert not os.path.exists(tmp_path / "off" / "metrics_ts.jsonl")


# ---------------------------------------------------------------------------
# Exporter
# ---------------------------------------------------------------------------

class TestExporter:
    def test_metrics_snapshot_healthz_and_404(self, tmp_path):
        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            _fill(telemetry, tel)
            exporter = MetricsExporter(tel, port=0, host_id="h-7").start()
            try:
                st_m, body = _get(exporter.port, "/metrics")
                st_s, snap_body = _get(exporter.port, "/snapshot")
                st_h, hz_body = _get(exporter.port, "/healthz")
                st_l, _ = _get(exporter.port, "/livez")
                st_n, _ = _get(exporter.port, "/nope")
            finally:
                exporter.close()
        assert (st_m, st_s, st_h, st_l, st_n) == (200, 200, 200, 200, 404)
        parsed = parse_prometheus_text(body)
        assert parsed[("solver_iterations", "")] == 12
        snap = json.loads(snap_body)
        assert snap["counters"]["solver_iterations"] == 12
        assert snap["trace"] == tel.trace_id and snap["pid"] == os.getpid()
        assert snap["host"] == {"host_id": "h-7", "pid": os.getpid()}
        assert "transport" in snap
        assert json.loads(hz_body)["status"] == "ok"

    @pytest.mark.parametrize("readiness,status,reason", [
        (None, 200, "ok"),
        (lambda: True, 200, ""),
        (lambda: False, 503, ""),
        (lambda: (False, "warming"), 503, "warming"),
        (lambda: 1 / 0, 503, "readiness check failed: division by zero"),
    ])
    def test_exporter_readiness_split(self, tmp_path, readiness, status,
                                      reason):
        """/readyz follows the readiness callable; /healthz and /livez
        stay 200 while the process answers (liveness ≠ readiness)."""
        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            exporter = MetricsExporter(tel, port=0,
                                       readiness=readiness).start()
            try:
                st_r, body = _get(exporter.port, "/readyz")
                st_h, _ = _get(exporter.port, "/healthz")
                st_l, _ = _get(exporter.port, "/livez")
            finally:
                exporter.close()
        assert (st_r, st_h, st_l) == (status, 200, 200)
        verdict = json.loads(body)
        assert verdict["status"] == ("ready" if status == 200
                                     else "not_ready")
        assert verdict["reason"] == reason

    def test_close_joins_thread_no_leak(self, tmp_path):
        before = {t.name for t in threading.enumerate()}
        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            plane = telemetry.mount_ops_plane(tel, port=0, interval_s=0.01)
            assert plane.exporter.alive and plane.sampler.alive
            plane.close()
            plane.close()  # idempotent
            assert not plane.exporter.alive and not plane.sampler.alive
        leaked = {t.name for t in threading.enumerate()
                  if t.name.startswith("telemetry-")} - before
        assert not leaked

    def test_disabled_hub_mounts_an_inert_plane(self, tmp_path):
        tel = telemetry.Telemetry(output_dir=str(tmp_path), enabled=False)
        with telemetry.mount_ops_plane(tel, port=0, interval_s=0.01) as p:
            assert p.sampler is None and p.exporter is None
            assert p.port is None

    def test_lifecycle_survives_chaos_mid_pass_teardown(self, tmp_path):
        """A chaos fault kills a streamed pass while the plane is mounted:
        the flight recorder ends at the fault, no prefetch thread leaks,
        the exporter still answers, and close() joins both threads."""
        from photon_ml_tpu_torch.data.streaming import (
            make_streaming_glm_data,
        )
        from photon_ml_tpu_torch.optim.streaming import StreamingObjective

        X, y = _small_xy()
        stream = make_streaming_glm_data(X, y, chunk_rows=40, device="cpu")
        sobj = StreamingObjective("logistic", stream)
        w = torch.zeros(stream.n_features)
        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            plane = telemetry.mount_ops_plane(tel, port=0, interval_s=0.02)
            try:
                with chaos.FaultPlan([chaos.FaultSpec(
                        site="streaming.carry_sync", at=1)]):
                    with pytest.raises(chaos.InjectedFault):
                        sobj.value_and_grad(w, 1.0)
                assert tel.counter("prefetch_thread_leak").value == 0
                assert _get(plane.port, "/metrics")[0] == 200
            finally:
                plane.close()
            assert not plane.exporter.alive and not plane.sampler.alive
        with open(tmp_path / "flightrecorder.json") as f:
            dump = json.load(f)
        assert dump["events"][-1]["name"] == "chaos.fault"
        assert dump["events"][-1]["attrs"]["site"] == "streaming.carry_sync"


def _small_xy(n=160, d=10):
    rng = np.random.default_rng(11)
    X = sp.random(n, d, density=0.5, random_state=2, format="csr",
                  dtype=np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# Flight recorder and the watchdog's events
# ---------------------------------------------------------------------------

class TestFlightRecorder:
    @pytest.mark.parametrize("exc,outcome", [
        (ValueError("INVALID_ARGUMENT: bad shape"), "non_transient"),
        (RuntimeError("CUDA error: an illegal memory access was "
                      "encountered"), "non_transient"),
        (torch.OutOfMemoryError("CUDA out of memory"), "non_transient"),
        (RuntimeError("UNAVAILABLE: device lost"), "gave_up"),
    ])
    def test_watchdog_fatal_dump(self, tmp_path, exc, outcome):
        from photon_ml_tpu_torch.utils.watchdog import (
            RetryPolicy,
            run_with_retries,
        )

        def fn(attempt):
            raise exc

        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            with tel.span("run"):
                with pytest.raises(type(exc)):
                    run_with_retries(fn, RetryPolicy(max_retries=1),
                                     sleep=lambda s: None)
            # Dumped at the fatal verdict, not at hub exit.
            with open(tmp_path / "flightrecorder.json") as f:
                dump = json.load(f)
            retries = tel.counter("watchdog_retries").value
        assert dump["reason"].startswith(
            f"watchdog-fatal: {type(exc).__name__}")
        last = dump["events"][-1]
        assert last["name"] == "watchdog.attempt"
        assert last["attrs"]["outcome"] == outcome
        assert retries == (1 if outcome == "gave_up" else 0)

    def test_retry_then_recovery_events_match_the_reference(self, tmp_path):
        from photon_ml_tpu.utils.watchdog import (
            RetryPolicy as RefPolicy,
            run_with_retries as ref_run,
        )
        from photon_ml_tpu_torch.utils.watchdog import (
            RetryPolicy,
            run_with_retries,
        )

        def fn(attempt):
            if attempt < 2:
                raise RuntimeError("UNAVAILABLE: preempted")
            return attempt

        got = {}
        for name, pkg, run, policy in (
                ("port", telemetry, run_with_retries, RetryPolicy),
                ("ref", ref_tel, ref_run, RefPolicy)):
            out = str(tmp_path / name)
            with pkg.Telemetry(output_dir=out) as tel:
                assert run(fn, policy(max_retries=3, jitter="none"),
                           sleep=lambda s: None) == 2
                got[name] = tel.counter("watchdog_retries").value
            got[name + "_events"] = [
                (e, {k: a.get(k) for k in ("attempt", "outcome",
                                           "backoff_seconds",
                                           "retries")})
                for e, a in _events(out)]
        assert got["port"] == got["ref"] == 2
        assert got["port_events"] == got["ref_events"]
        assert not os.path.exists(tmp_path / "port" / "flightrecorder.json")

    def test_driver_crash_dump_via_hub_exit(self, tmp_path):
        with pytest.raises(RuntimeError, match="boom"):
            with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
                with tel.span("run"):
                    tel.event("about.to.die", step=3)
                    raise RuntimeError("boom")
        with open(tmp_path / "flightrecorder.json") as f:
            dump = json.load(f)
        assert dump["reason"].startswith("crash: RuntimeError: boom")
        names = [e["name"] for e in dump["events"]]
        assert "about.to.die" in names and "run" in names


def _events(out_dir):
    out = []
    with open(os.path.join(out_dir, "events.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") == "event":
                out.append((rec["name"], rec.get("attrs") or {}))
    return out


# ---------------------------------------------------------------------------
# A streamed pass's publication
# ---------------------------------------------------------------------------

class TestStreamedPassPublication:
    def test_one_pass_publishes_the_references_chunk_counters(
            self, tmp_path):
        """One streamed value+grad pass over the same rows and chunking:
        the same ``h2d_chunks_total``, one pass and one all-reduce round in
        both packages, and the port's counters equal its TransferStats."""
        import jax.numpy as jnp

        from photon_ml_tpu.data.streaming import (
            make_streaming_glm_data as ref_make,
        )
        from photon_ml_tpu.optim.streaming import (
            StreamingObjective as RefStreamingObjective,
        )
        from photon_ml_tpu_torch.data.streaming import (
            make_streaming_glm_data,
        )
        from photon_ml_tpu_torch.optim.streaming import StreamingObjective

        X, y = _small_xy()
        with telemetry.Telemetry(output_dir=str(tmp_path / "p")) as tel:
            stream = make_streaming_glm_data(X, y, chunk_rows=40,
                                             device="cpu")
            sobj = StreamingObjective("logistic", stream)
            with tel.span("solver"):
                sobj.value_and_grad(torch.zeros(stream.n_features), 1.0)
            ours = tel.snapshot()
        with ref_tel.Telemetry(output_dir=str(tmp_path / "r")) as tel:
            rstream = ref_make(X, y, chunk_rows=40, use_pallas=False)
            RefStreamingObjective("logistic", rstream).value_and_grad(
                jnp.zeros(rstream.n_features, jnp.float32), 1.0)
            ref = tel.snapshot()
        for key in ("h2d_chunks_total", "prefetch_passes",
                    "solver_allreduce_count", "solver_allreduce_bytes_total"):
            assert ours["counters"][key] == ref["counters"][key], key
        stats = sobj.transfer_stats
        assert ours["counters"]["h2d_chunks_total"] == stats.chunks == 4
        assert ours["counters"]["h2d_bytes_total"] == stats.bytes
        assert set(ref["gauges"]) <= set(ours["gauges"])
        # The pipeline threads' stage spans nest under the caller's span.
        spans = {}
        with open(tmp_path / "p" / "events.jsonl") as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("type") == "span":
                    spans[rec["name"]] = rec
        for stage in ("prefetch.pack_stage", "prefetch.transfer_stage"):
            assert spans[stage]["parent"] == spans["solver"]["id"]

    def test_telemetry_off_leaves_the_pass_bitwise(self):
        from photon_ml_tpu_torch.data.streaming import (
            make_streaming_glm_data,
        )
        from photon_ml_tpu_torch.optim.streaming import StreamingObjective

        X, y = _small_xy()
        outs = []
        for enabled in (True, False):
            stream = make_streaming_glm_data(X, y, chunk_rows=40,
                                             device="cpu")
            sobj = StreamingObjective("logistic", stream)
            with telemetry.Telemetry(enabled=enabled):
                outs.append(sobj.value_and_grad(
                    torch.full((stream.n_features,), 0.1), 0.5))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def a1a_shaped(tmp_path_factory):
    rng = np.random.default_rng(2)
    X = sp.random(N_TRAIN + N_VAL, D, density=0.11, random_state=4,
                  format="csr")
    X.data[:] = 1.0
    w_true = rng.normal(size=D) * (rng.uniform(size=D) < 0.3)
    logits = X @ w_true - 0.5
    y = np.where(rng.uniform(size=N_TRAIN + N_VAL)
                 < 1 / (1 + np.exp(-logits)), 1.0, -1.0)
    root = tmp_path_factory.mktemp("ops_a1a")
    train, val = str(root / "train.libsvm"), str(root / "val.libsvm")
    ref_libsvm.write_libsvm(train, X[:N_TRAIN], y[:N_TRAIN])
    ref_libsvm.write_libsvm(val, X[N_TRAIN:], y[N_TRAIN:])
    return train, val


def _glm_argv(train, val, out, *extra):
    return ["--train-data", train, "--validate-data", val,
            "--output-dir", out, "--task", "logistic", "--reg-type", "l2",
            "--reg-weights", "0.1,1.0,10.0", "--n-features", str(D),
            "--tolerance", "1e-5", "--output-mode", "all", *extra]


def _reported_iterations(out_dir):
    with open(os.path.join(out_dir, "photon.log")) as f:
        return [int(m.group(1)) for m in
                re.finditer(r"lambda=\S+: value=\S+ iters=(\d+)", f.read())]


def _model_bytes(out_dir):
    """The run's model Avro files and their sidecars, and the feature
    summary."""
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(out_dir, "*.avro*")))}


@pytest.fixture(scope="module")
def glm_runs(a1a_shaped, tmp_path_factory):
    train, val = a1a_shaped
    root = tmp_path_factory.mktemp("ops_glm")
    before = telemetry.current()
    glm_driver.run(_glm_argv(train, val, str(root / "on"), "--device",
                             "cpu"))
    glm_driver.run(_glm_argv(train, val, str(root / "off"), "--device",
                             "cpu", "--telemetry", "off"))
    after = telemetry.current()
    ref_glm.run(_glm_argv(train, val, str(root / "ref")))
    return root, before, after


class TestGlmDriver:
    def test_same_spans_events_and_counters_as_the_reference(self,
                                                              glm_runs):
        root = glm_runs[0]
        ours, ref = str(root / "on"), str(root / "ref")
        seq = _sequence(ours)
        assert seq == _sequence(ref)
        assert [n for _, n in seq].count("solver") == 3
        m_o, m_r = _metrics(ours), _metrics(ref)
        assert m_o["counters"]["checkpoint_saves"] == \
            m_r["counters"]["checkpoint_saves"] == 3
        assert {k for k in m_o["counters"] if not _REF_ONLY.match(k)} == {
            k for k in m_r["counters"] if not _REF_ONLY.match(k)}
        assert m_o["histograms"]["solver_wall_seconds"]["count"] == 3
        for name in ("events.jsonl", "trace.json", "metrics.json",
                     "metrics_ts.jsonl"):
            assert os.path.exists(os.path.join(ours, name)), name

    def test_solver_iterations_are_the_ports_reported_iterations(
            self, glm_runs):
        ours = str(glm_runs[0] / "on")
        iters = _reported_iterations(ours)
        assert len(iters) == 3
        assert _metrics(ours)["counters"]["solver_iterations"] == sum(iters)
        spans = [rec for rec in map(json.loads, open(
            os.path.join(ours, "events.jsonl")))
            if rec.get("type") == "span" and rec["name"] == "solver"]
        assert [s["attrs"]["iterations"] for s in spans] == iters

    def test_telemetry_off_writes_the_same_models_and_no_telemetry(
            self, glm_runs):
        root = glm_runs[0]
        on, off = _model_bytes(str(root / "on")), _model_bytes(
            str(root / "off"))
        assert len([k for k in on if k.endswith(".avro")
                    and k.startswith("model_lambda_")]) == 3
        assert on == off
        for name in ("events.jsonl", "trace.json", "metrics.json",
                     "metrics_ts.jsonl"):
            assert not os.path.exists(root / "off" / name), name

    def test_runs_restore_the_process_current_hub(self, glm_runs):
        _, before, after = glm_runs
        assert after is before

    def test_a_failed_run_restores_the_hub_too(self, a1a_shaped, tmp_path):
        train, val = a1a_shaped
        before = telemetry.current()
        with pytest.raises(SystemExit):
            glm_driver.run(_glm_argv(train, val, str(tmp_path), "--device",
                                     "cpu", "--solver-option", "broken"))
        assert telemetry.current() is before

    def test_live_plane_on_a_real_run(self, a1a_shaped, tmp_path):
        train, val = a1a_shaped
        before = {t.name for t in threading.enumerate()}
        glm_driver.run(_glm_argv(train, val, str(tmp_path), "--device",
                                 "cpu", "--metrics-port", "0",
                                 "--metrics-interval-s", "0.01"))
        series = read_series(str(tmp_path / "metrics_ts.jsonl"))
        assert len(series) >= 2
        assert all(b["t_mono"] > a["t_mono"]
                   for a, b in zip(series, series[1:]))
        assert series[-1]["counters"]["solver_iterations"] == \
            _metrics(str(tmp_path))["counters"]["solver_iterations"]
        leaked = {t.name for t in threading.enumerate()
                  if t.name.startswith("telemetry-")} - before
        assert not leaked
        with open(tmp_path / "photon.log") as f:
            assert "metrics exporter on http://127.0.0.1:" in f.read()

    def test_streamed_route_counters(self, a1a_shaped, tmp_path):
        """The streamed driver's h2d counters are its TransferStats; the
        span and event structure is the reference's once the per-pass
        records are collapsed, and both packages move the same chunks a
        pass (the port's streamed grid takes fewer passes: it runs the
        resident solvers with batched line-search trials)."""
        train, val = a1a_shaped
        extra = ("--stream-chunk-rows", "128")
        glm_driver.run(_glm_argv(train, val, str(tmp_path / "p"), *extra,
                                 "--device", "cpu"))
        ref_glm.run(_glm_argv(train, val, str(tmp_path / "r"), *extra))
        per_pass = ("prefetch.pack_stage", "prefetch.transfer_stage",
                    "prefetch.pass")
        assert _sequence(str(tmp_path / "p"), per_pass) == \
            _sequence(str(tmp_path / "r"), per_pass)
        with open(tmp_path / "p" / "training_result.json") as f:
            transfer = json.load(f)["streaming"]["transfer"]
        c_o = _metrics(str(tmp_path / "p"))["counters"]
        c_r = _metrics(str(tmp_path / "r"))["counters"]
        assert c_o["h2d_chunks_total"] == transfer["chunks"]
        assert c_o["h2d_bytes_total"] == transfer["bytes"]
        assert c_o["prefetch_passes"] == transfer["passes"]
        n_chunks = -(-N_TRAIN // 128)
        for c in (c_o, c_r):
            assert c["h2d_chunks_total"] == n_chunks * c["prefetch_passes"]
            assert c["solver_allreduce_count"] == c["prefetch_passes"]


@pytest.fixture(scope="module")
def game_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ops_game")
    rng = np.random.default_rng(11)
    effects = {f"u{u}": rng.normal(scale=2.0) for u in range(20)}
    train, val = str(root / "train.avro"), str(root / "val.avro")
    write_game_avro(train, _make_game_rows(rng, effects, 300))
    write_game_avro(val, _make_game_rows(rng, effects, 100, uid_start=300))
    config = {"task": "logistic", "iterations": 2, "evaluator": "auc",
              "coordinates": [
                  {"name": "fixed", "type": "fixed",
                   "feature_shard": "global", "optimizer": "lbfgs",
                   "max_iters": 50, "reg_type": "l2", "reg_weight": 0.5},
                  {"name": "per_user", "type": "random",
                   "feature_shard": "userFeatures", "entity_key": "userId",
                   "optimizer": "lbfgs", "max_iters": 30, "reg_type": "l2",
                   "reg_weight": 0.5}]}
    with open(root / "config.json", "w") as f:
        json.dump(config, f)
    args = ["--train-data", train, "--validate-data", val, "--config",
            str(root / "config.json")]
    game_training_driver.run(args + ["--output-dir", str(root / "on"),
                                     "--device", "cpu"])
    game_training_driver.run(args + ["--output-dir", str(root / "off"),
                                     "--device", "cpu", "--telemetry",
                                     "off"])
    ref_training.run(args + ["--output-dir", str(root / "ref")])
    game_scoring_driver.run(["--data", val, "--model-dir", str(root / "on"),
                             "--output-dir", str(root / "score"),
                             "--device", "cpu"])
    ref_scoring.run(["--data", val, "--model-dir", str(root / "ref"),
                     "--output-dir", str(root / "rscore")])
    return root


class TestGameDrivers:
    def test_same_spans_per_cd_iteration_as_the_reference(self, game_runs):
        seq = _sequence(str(game_runs / "on"))
        assert seq == _sequence(str(game_runs / "ref"))
        names = [n for _, n in seq]
        assert names.count("cd_iteration") == 2
        assert names.count("coordinate") == names.count("solver") == 4

    def test_deterministic_counters_match_the_reference(self, game_runs):
        m_o, m_r = _metrics(str(game_runs / "on")), _metrics(
            str(game_runs / "ref"))
        assert m_o["counters"]["checkpoint_saves"] == \
            m_r["counters"]["checkpoint_saves"] == 2
        assert m_o["histograms"]["cd_iteration_seconds"]["count"] == \
            m_r["histograms"]["cd_iteration_seconds"]["count"] == 2
        assert m_o["gauges"]["game_bucket_padding_ratio"] == \
            m_r["gauges"]["game_bucket_padding_ratio"]
        assert set(m_o["gauges"]) == {
            k for k in m_r["gauges"] if not _REF_ONLY.match(k)}

    def test_telemetry_off_writes_the_same_model(self, game_runs):
        def files(d):
            out = {}
            for p in sorted(glob.glob(os.path.join(d, "models", "**", "*"),
                                      recursive=True)):
                if os.path.isfile(p):
                    out[os.path.relpath(p, d)] = open(p, "rb").read()
            return out

        on, off = files(str(game_runs / "on")), files(str(game_runs / "off"))
        assert on and on == off
        assert not os.path.exists(game_runs / "off" / "events.jsonl")

    def test_scoring_driver_telemetry_is_the_references(self, game_runs):
        ours, ref = str(game_runs / "score"), str(game_runs / "rscore")
        assert _sequence(ours) == _sequence(ref) == [("span", "run")]
        g_o, g_r = _metrics(ours)["gauges"], _metrics(ref)["gauges"]
        assert g_o["scored_rows"] == g_r["scored_rows"] == 100
        assert set(g_o) == set(g_r)
        for name in ("events.jsonl", "trace.json", "metrics.json"):
            assert os.path.exists(os.path.join(ours, name))


# ---------------------------------------------------------------------------
# The serving CLI's tenant report
# ---------------------------------------------------------------------------

def _tenant_series(path, host_id, scale):
    records = [
        {"seq": 0, "t_wall": 0.0, "t_mono": 10.0,
         "host": {"host_id": host_id, "pid": 1},
         "counters": {"serving_tenant_acme_requests_total": 100 * scale,
                      "serving_tenant_acme_shed_total": 5,
                      "serving_tenant_acme_rejected_total": 1},
         "gauges": {}, "histograms": {}},
        {"seq": 1, "t_wall": 4.0, "t_mono": 13.0 + scale,
         "host": {"host_id": host_id, "pid": 1},
         "counters": {"serving_tenant_acme_requests_total": 300 * scale,
                      "serving_tenant_acme_shed_total": 25,
                      "serving_tenant_acme_rejected_total": 3,
                      "serving_tenant_free_tier_requests_total": 40},
         "gauges": {},
         "histograms": {"serving_tenant_acme_request_latency_seconds": {
             "count": 295, "p50": 0.004 * scale, "p99": 0.020 * scale}}},
    ]
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        f.write('{"seq": 2, "t_mo')  # a torn tail
    return str(path)


class TestTenantReport:
    def test_single_file_report_equals_the_references(self, tmp_path):
        path = _tenant_series(tmp_path / "metrics_ts.jsonl", "h0", 1)
        ours = serving_cli.tenant_report(path)
        assert ours == ref_serving_cli.tenant_report(path)
        acme = ours["tenants"]["acme"]
        assert acme["requests"] == 200 and acme["rps"] == 50.0
        assert acme["latency_p99_ms"] == 20.0

    def test_fleet_report_equals_the_references(self, tmp_path):
        paths = []
        for i, hid in enumerate(("h0", "h1", "h0")):
            d = tmp_path / f"host{i}"
            d.mkdir()
            paths.append(_tenant_series(d / "metrics_ts.jsonl", hid, i + 1))
        ours = serving_cli.tenant_report_multi(paths)
        assert ours == ref_serving_cli.tenant_report_multi(paths)
        assert ours["fleet"]["tenants"]["acme"]["hosts"] == 3

    def test_cli_prints_the_report_and_refuses_an_empty_series(
            self, tmp_path, capsys):
        path = _tenant_series(tmp_path / "metrics_ts.jsonl", "h0", 1)
        assert serving_cli.main(["--tenant-report", path]) == 0
        assert json.loads(capsys.readouterr().out) == \
            serving_cli.tenant_report(path)
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        assert serving_cli.main(["--tenant-report", str(empty)]) == 1
        assert "no time-series records" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The selfcheck and the staged datasets
# ---------------------------------------------------------------------------

class TestSelfcheck:
    def test_telemetry_selfcheck_passes(self, tmp_path, capsys):
        from photon_ml_tpu_torch.telemetry.__main__ import main

        keep = str(tmp_path / "sc")
        assert main(["--selfcheck", "--keep-dir", keep]) == 0
        out = capsys.readouterr().out
        assert "telemetry selfcheck pass sinks_ops_plane: PASS" in out
        assert "telemetry selfcheck pass fleet: PASS" in out
        for name in ("metrics_ts.jsonl", "flightrecorder.json",
                     os.path.join("fleet", "merged.trace.json")):
            assert os.path.exists(os.path.join(keep, name)), name

    def test_lint_flag_is_left_out(self, capsys):
        """The flag was left out until the static checker was ported; it
        now runs the checker's metric-naming rule, clean on the port."""
        from photon_ml_tpu_torch.telemetry.__main__ import main

        assert main(["--lint-metrics"]) == 0
        assert "metric lint OK" in capsys.readouterr().out


class TestDatasets:
    def test_staged_files_are_found_as_the_reference_finds_them(
            self, tmp_path, monkeypatch):
        from photon_ml_tpu.data import datasets as ref_datasets

        (tmp_path / "a1a").write_text("+1 1:1\n")
        monkeypatch.setenv("PHOTON_DATA_DIR", str(tmp_path))
        for name in ("a1a", "a1a.t", "README.md", "ml-20m"):
            assert datasets.resolve_dataset(name) == \
                ref_datasets.resolve_dataset(name), name
        assert datasets.resolve_dataset("a1a") == str(tmp_path / "a1a")
        assert datasets.require_dataset("a1a") == str(tmp_path / "a1a")
        monkeypatch.delenv("PHOTON_DATA_DIR")
        assert datasets.resolve_dataset("a1a") == \
            ref_datasets.resolve_dataset("a1a")
        assert datasets.skip_reason("x") == ref_datasets.skip_reason("x")

    def test_a_missing_file_raises_and_downloads_nothing(
            self, tmp_path, monkeypatch):
        monkeypatch.setenv("PHOTON_DATA_DIR", str(tmp_path))
        before = set(os.listdir(tmp_path))
        assert datasets.resolve_dataset("not-staged.libsvm") is None
        with pytest.raises(FileNotFoundError, match="not staged"):
            datasets.require_dataset("not-staged.libsvm")
        assert set(os.listdir(tmp_path)) == before
