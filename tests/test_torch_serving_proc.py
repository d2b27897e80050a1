"""The port's process tier on the CPU — the reference's
``tests/test_serving_proc.py`` and
``test_serving_tenancy.py::test_process_mode_burst_with_midstream_sigkill``.

Worker processes are spawned with ``device="cpu"`` (the plain version of
the serving kernel).  What is held:

- a 2-worker pool on one shared-memory publication scores bitwise the
  port's in-process runtime, and within 1e-6 of Σ|x·w| of the
  reference's runtime on the same requests;
- a real SIGKILL mid-stream, under open-loop load, and through the
  ``serving.worker`` fault site costs zero failed requests;
- a cross-process swap, a delta apply and their rollbacks stay bitwise;
- a shared-memory manifest's segments and digests equal the
  reference's for the same model, and each package attaches the other's
  publication;
- binary frames are byte-equal across the packages;
- ``stop()`` leaks no process and no segment, and a spawned worker holds
  no ``jax`` module;
- a worker asked for ``cuda`` on a machine without a card fails the
  pool's start.

Every wait on a process or a socket is bounded.
"""

import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

from photon_ml_tpu.serving import protocol as ref_protocol
from photon_ml_tpu.serving import shm_model as ref_shm
from photon_ml_tpu.serving.runtime import (
    RuntimeConfig as RefRuntimeConfig,
    ScoringRuntime as RefRuntime,
)
from photon_ml_tpu.serving.synthetic import SyntheticWorkload as RefWorkload
from photon_ml_tpu_torch import chaos, telemetry
from photon_ml_tpu_torch.io.game_store import save_game_model
from photon_ml_tpu_torch.serving import kernels, loadgen, shm_model
from photon_ml_tpu_torch.serving.batcher import BatcherConfig
from photon_ml_tpu_torch.serving.procpool import WorkerPool
from photon_ml_tpu_torch.serving.protocol import (
    MAX_FRAME_BYTES,
    FrameConn,
    ProtocolError,
)
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.service import ScoringService
from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from photon_ml_tpu_torch.serving.tenancy import TenancyConfig, TenantSpec
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

RT_CFG = dict(max_batch_size=8, hot_entities=8, device="cpu")


@pytest.fixture(scope="module")
def workload():
    return SyntheticWorkload(n_entities=32, seed=7)


@pytest.fixture(scope="module")
def workload_v2():
    return SyntheticWorkload(n_entities=32, seed=8)


def _reference(workload, requests):
    """The port's in-process runtime, one row at a time."""
    runtime = ScoringRuntime(
        workload.model, workload.index_maps, RuntimeConfig(**RT_CFG))
    return np.asarray([runtime.score_rows([runtime.parse_request(r)])[0][0]
                       for r in requests], np.float32)


def _abs_scale(workload, requests):
    """Σ|terms| of each request's margin in float64."""
    runtime = ScoringRuntime(
        workload.model, workload.index_maps, RuntimeConfig(**RT_CFG))
    w = workload.model.models["fixed"].model.coefficients.means.numpy()
    re = workload.model.models["per_entity"]
    out = []
    for req in requests:
        r = runtime.parse_request(req)
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


def _wait_until(predicate, timeout_s=60.0, interval_s=0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


def _scores(service, requests):
    futures = [service.submit(r) for r in requests]
    return np.asarray([np.float32(f.result(timeout=60)["score"])
                       for f in futures], np.float32)


@pytest.fixture(scope="module")
def hub():
    """Metrics-only hub for the module (the pool folds the workers'
    heartbeat metrics into the current hub)."""
    prev = telemetry.current()
    tel = telemetry.Telemetry(enabled=True, sinks=[])
    telemetry.set_current(tel)
    yield tel
    telemetry.set_current(prev)


@pytest.fixture(scope="module")
def proc(hub, workload):
    """One 2-worker pool + supervisor + service shared by the spawn
    tests; each test restores what it perturbs (kills wait for the
    respawn, swaps roll back)."""
    pool = WorkerPool(workload.model, workload.index_maps,
                      runtime_config=RuntimeConfig(**RT_CFG), version=1)
    supervisor = ReplicaSupervisor(
        pool=pool, n_replicas=2, probe_interval_s=0.05,
        probe_timeout_s=60.0, probe_failure_threshold=5)
    service = ScoringService(supervisor, BatcherConfig(
        max_batch_size=8, max_wait_us=2_000, max_queue=256))
    with service:
        yield types.SimpleNamespace(pool=pool, supervisor=supervisor,
                                    service=service)


# ---------------------------------------------------------------------------
# Worker pool: parity, SIGKILL, chaos, accounting
# ---------------------------------------------------------------------------

class TestWorkerPool:
    def test_scores_bit_identical_to_in_process(self, proc, workload):
        requests = [workload.request(i) for i in range(24)]
        got = _scores(proc.service, requests)
        assert got.tobytes() == _reference(workload, requests).tobytes()

    def test_scores_match_reference_runtime(self, proc, workload):
        requests = [workload.request(i) for i in range(24)]
        got = _scores(proc.service, requests).astype(np.float64)
        ref_w = RefWorkload(n_entities=32, seed=7)
        ref = RefRuntime(ref_w.model, ref_w.index_maps, RefRuntimeConfig(
            max_batch_size=8, hot_entities=8))
        want = np.asarray([ref.score_rows([ref.parse_request(r)])[0][0]
                           for r in requests], np.float64)
        scale = _abs_scale(workload, requests)
        assert np.all(np.abs(got - want) <= 1e-6 * scale)

    def test_spawned_worker_imports_no_jax(self, proc):
        for rep in proc.supervisor.replicas:
            stats = rep.batcher.stats()
            assert stats["jax_imported"] is False
            assert stats["device"] == "cpu"

    def test_sigkill_mid_stream_zero_failed_requests(self, proc, workload):
        sup = proc.supervisor
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        restarts_before = sum(r["restarts"] for r in sup.stats()["replicas"])
        requests = [workload.request(i) for i in range(48)]
        futures = [proc.service.submit(r) for r in requests[:24]]
        sup.kill_replica(0)  # SIGKILL: a real process dies mid-batch
        futures += [proc.service.submit(r) for r in requests[24:]]
        got = np.asarray([np.float32(f.result(timeout=60)["score"])
                          for f in futures], np.float32)
        assert got.tobytes() == _reference(workload, requests).tobytes()
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        assert sum(r["restarts"] for r in sup.stats()["replicas"]) == \
            restarts_before + 1

    def test_paused_worker_holds_its_rows_for_the_kill_to_resubmit(
            self, proc, workload, hub):
        """The process selfcheck's kill made deterministic: rows routed to
        a paused worker stay in flight however long the script takes to
        reach the kill, so the kill always resubmits some (the selfcheck
        once found none when its worker had finished its share first),
        and every row still scores bitwise."""
        sup = proc.supervisor
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        before = hub.snapshot()["counters"].get(
            "serving_resubmitted_total", 0)
        requests = [workload.request(50_000 + j) for j in range(16)]
        sup.replicas[0].batcher.pause()
        futures = [proc.service.submit(r) for r in requests]
        time.sleep(0.5)  # a slow script: the peer finishes its share
        held = [f for f in futures if not f.done()]
        assert held, "the paused worker answered"
        sup.kill_replica(0)
        got = np.asarray([np.float32(f.result(timeout=60)["score"])
                          for f in futures], np.float32)
        assert got.tobytes() == _reference(workload, requests).tobytes()
        assert hub.snapshot()["counters"].get(
            "serving_resubmitted_total", 0) - before >= 1
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()

    def test_sigkill_under_open_loop_load_zero_errors(self, proc, workload):
        sup = proc.supervisor
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        killer = threading.Timer(0.3, lambda: sup.kill_replica(1))
        killer.start()
        report = loadgen.open_loop(proc.service.submit, workload.request,
                                   rate_rps=120.0, duration_s=1.5)
        killer.join()
        assert report.errors == 0, report.snapshot()
        assert report.rejected == 0, report.snapshot()
        assert report.completed > 50
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()

    def test_chaos_worker_site_kills_for_real_and_reroutes(
            self, proc, workload):
        sup = proc.supervisor
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()

        def pids():
            return {getattr(r.batcher.runtime, "pid", None)
                    for r in sup.replicas}

        pids_before = pids()
        plan = chaos.FaultPlan([chaos.FaultSpec(site="serving.worker",
                                                at=0)])
        with plan:
            result = proc.service.submit(
                workload.request(0)).result(timeout=60)
        assert np.isfinite(result["score"])
        assert plan.fired and plan.fired[0]["site"] == "serving.worker"
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        assert pids() != pids_before  # a real process was SIGKILLed

    def test_shared_segments_mapped_once_not_per_worker(self, proc, hub):
        published = sum(seg["nbytes"]
                        for gen in proc.pool._generations
                        for seg in gen.manifest["segments"].values())
        assert published > 0
        gauge = hub.snapshot()["gauges"].get("serving_shared_segment_bytes")
        assert gauge == published  # one publication, not x workers

    def test_worker_batches_fold_into_the_pool(self, proc, workload):
        """Each worker's batches ride its heartbeats beside its launch
        counts and fold per worker, every process of a worker counted."""
        pool, sup = proc.pool, proc.supervisor
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()

        def batches():
            return sum(c["batches"] for c in pool.launch_counts().values())

        before = batches()
        for i in range(12):  # one request at a time: 12 batches at least
            proc.service.submit(workload.request(i)).result(timeout=60)
        assert _wait_until(lambda: batches() >= before + 12,
                           timeout_s=10.0), pool.launch_counts()
        counts = pool.launch_counts()
        assert sorted(counts) == [0, 1]
        assert all(c["processes"] >= 1 for c in counts.values())

    def test_worker_metrics_fold_into_parent_registry(
            self, proc, workload, hub):
        before = hub.snapshot()["counters"].get("serving_requests_total", 0)
        for f in [proc.service.submit(workload.request(i))
                  for i in range(8)]:
            f.result(timeout=60)
        assert _wait_until(
            lambda: hub.snapshot()["counters"].get(
                "serving_requests_total", 0) >= before + 8,
            timeout_s=10.0), hub.snapshot()["counters"]


# ---------------------------------------------------------------------------
# Cross-process hot swap and delta apply
# ---------------------------------------------------------------------------

class TestProcessSwap:
    def test_swap_and_rollback_bit_identical_with_convergence(
            self, proc, workload, workload_v2, tmp_path):
        v2_dir = str(tmp_path / "v2")
        save_game_model(workload_v2.model, workload_v2.index_maps, v2_dir)
        requests = [workload.request(i) for i in range(16)]
        ref_v1 = _reference(workload, requests)
        ref_v2 = _reference(workload_v2, requests)
        sup, service = proc.supervisor, proc.service
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        version_before = service.swapper.version
        result = service.reload(v2_dir)
        assert result.status == "swapped", result
        assert service.swapper.version == version_before + 1
        assert _scores(service, requests).tobytes() == ref_v2.tobytes()
        # A worker killed AFTER the commit respawns on v2 with no
        # retained previous; the rollback still converges.
        sup.kill_replica(1, "post-swap kill")
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        rolled = service.reload(rollback=True)
        assert rolled.status == "rolled_back", rolled
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        assert _scores(service, requests).tobytes() == ref_v1.tobytes()


class TestProcessDelta:
    def test_delta_apply_and_rollback_bit_identical(
            self, proc, workload, tmp_path):
        from photon_ml_tpu_torch.freshness.delta import diff_game_models
        from photon_ml_tpu_torch.freshness.publisher import DeltaPublisher

        target_w = SyntheticWorkload(n_entities=32, seed=7)
        re = target_w.model.models["per_entity"]
        for k in [f"u{i}" for i in range(5)]:
            cols, vals = re.coefficients[k]
            re.coefficients[k] = (cols,
                                  (vals + np.float32(0.25)).astype(np.float32))
        requests = [workload.request(i) for i in range(16)]
        ref_v1 = _reference(workload, requests)
        ref_target = _reference(target_w, requests)
        assert ref_v1.tobytes() != ref_target.tobytes()
        sup, service = proc.supervisor, proc.service
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        version_before = service.swapper.version
        with DeltaPublisher(str(tmp_path / "pubs")) as pub:
            p = pub.publish(diff_game_models(
                workload.model, target_w.model, event_wall_epoch=1.0))
        result = service.reload(p.path, mode="delta")
        assert result.status == "swapped", result
        assert service.swapper.version > version_before
        assert _scores(service, requests).tobytes() == ref_target.tobytes()
        rolled = service.reload(rollback=True)
        assert rolled.status == "rolled_back", rolled
        assert _wait_until(lambda: sup.healthy_count == 2), sup.stats()
        assert _scores(service, requests).tobytes() == ref_v1.tobytes()


# ---------------------------------------------------------------------------
# Tenancy: a burst with a SIGKILL mid-stream
# ---------------------------------------------------------------------------

def test_process_mode_burst_with_midstream_sigkill(hub, workload):
    tenancy = TenancyConfig(tenants=(
        TenantSpec(name="victim", max_queue=256),
        TenantSpec(name="aggressor", quota_rps=3.0, burst=2.0),
    ))
    scenario = loadgen.Scenario(
        name="noisy_neighbor", description="test-sized replay", phases=[
            loadgen.ScenarioPhase("baseline", 0.3),
            loadgen.ScenarioPhase("burst", 0.8, rate_multiplier=10.0),
            loadgen.ScenarioPhase("recovery", 0.3)])

    def tagged(i, phase, tenant):
        obj = dict(workload.request(i))
        if tenant is not None:
            obj["tenant"] = tenant
        return obj

    pool = WorkerPool(workload.model, workload.index_maps,
                      runtime_config=RuntimeConfig(**RT_CFG), version=1)
    supervisor = ReplicaSupervisor(
        pool=pool, n_replicas=2, probe_interval_s=0.05,
        probe_timeout_s=60.0, probe_failure_threshold=5)
    service = ScoringService(supervisor, BatcherConfig(
        max_batch_size=8, max_wait_us=2_000, max_queue=256,
        tenancy=tenancy))
    mine = set(pool.manifest["segments"])
    with service:
        assert _wait_until(lambda: supervisor.healthy_count == 2)
        restarts_before = sum(r["restarts"]
                              for r in supervisor.stats()["replicas"])
        killer = threading.Timer(0.5, lambda: supervisor.kill_replica(0))
        killer.start()
        report = loadgen.run_noisy_neighbor(
            service.submit, tagged, victim_rate_rps=30.0,
            aggressor_rate_rps=30.0, scenario=scenario, timeout_s=60.0)
        killer.join()
        assert report.victim.failed == 0, report.snapshot()
        assert report.victim.completed > 0
        assert report.aggressor.shed > 0, report.snapshot()
        assert _wait_until(lambda: supervisor.healthy_count == 2), \
            supervisor.stats()
        assert sum(r["restarts"] for r in supervisor.stats()["replicas"]) \
            == restarts_before + 1
    assert not mine & set(shm_model.live_segments())


# ---------------------------------------------------------------------------
# Start-up on a device that is not there; clean shutdown
# ---------------------------------------------------------------------------

class TestStartAndStop:
    @pytest.mark.skipif(torch.cuda.is_available(),
                        reason="needs a machine without a CUDA card")
    def test_cuda_worker_without_a_card_fails_the_start(self, workload):
        from photon_ml_tpu_torch.analysis.sanitizers import (
            ProcessLeakSentinel,
        )

        before = set(shm_model.live_segments())
        with ProcessLeakSentinel(grace_s=15.0, strict=True):
            pool = WorkerPool(workload.model, workload.index_maps,
                              runtime_config=RuntimeConfig(
                                  max_batch_size=8, hot_entities=8,
                                  device="cuda"))
            assert pool.device == "cuda"
            supervisor = ReplicaSupervisor(pool=pool, n_replicas=1)
            try:
                with pytest.raises(RuntimeError, match="failed to start"):
                    supervisor.start()
            finally:
                supervisor.stop()
        assert set(shm_model.live_segments()) == before

    def test_stop_leaks_nothing(self, hub, workload):
        from photon_ml_tpu_torch.analysis.sanitizers import (
            ProcessLeakSentinel,
            ThreadLeakSentinel,
        )

        before = set(shm_model.live_segments())
        with ThreadLeakSentinel(grace_s=10.0, strict=True,
                                allow=("procpool-reader",)), \
                ProcessLeakSentinel(grace_s=15.0, strict=True):
            pool = WorkerPool(workload.model, workload.index_maps,
                              runtime_config=RuntimeConfig(**RT_CFG),
                              version=1)
            supervisor = ReplicaSupervisor(
                pool=pool, n_replicas=2, probe_interval_s=0.05,
                probe_timeout_s=60.0, probe_failure_threshold=5)
            with supervisor:
                result = supervisor.submit(supervisor.parse_request(
                    workload.request(0))).result(timeout=60)
                assert np.isfinite(result["score"])
            assert set(shm_model.live_segments()) == before


# ---------------------------------------------------------------------------
# Shared-memory publication: verify-or-die attach, cross-package
# ---------------------------------------------------------------------------

class TestShmModel:
    def test_attach_reconstructs_bit_identical_scores(self, workload):
        manifest = shm_model.publish_model(workload.model, version=1)
        try:
            model, attachment = shm_model.attach_model(manifest)
            runtime = ScoringRuntime(model, workload.index_maps,
                                     RuntimeConfig(**RT_CFG))
            requests = [workload.request(i) for i in range(8)]
            got = np.asarray([runtime.score_rows(
                [runtime.parse_request(r)])[0][0] for r in requests],
                np.float32)
            del model, runtime
            attachment.close()
            assert got.tobytes() == _reference(workload, requests).tobytes()
        finally:
            shm_model.unpublish_model(manifest)

    def test_manifest_digests_equal_the_references(self, workload):
        ref_w = RefWorkload(n_entities=32, seed=7)
        mine = shm_model.publish_model(workload.model, version=3, path="p")
        theirs = ref_shm.publish_model(ref_w.model, version=3, path="p")
        try:
            def body(m):
                segs = [m["segments"][c["segment"]] for c in m["coordinates"]]
                coords = [{k: v for k, v in c.items() if k != "segment"}
                          for c in m["coordinates"]]
                return coords, segs

            assert body(mine) == body(theirs)
            # Renaming the reference's segments to the port's makes the
            # two manifests equal, self-digest included.
            rename = {t["segment"]: m["segment"] for m, t in
                      zip(mine["coordinates"], theirs["coordinates"])}
            renamed = dict(theirs)
            renamed["coordinates"] = [dict(c, segment=rename[c["segment"]])
                                      for c in theirs["coordinates"]]
            renamed["segments"] = {rename[k]: v
                                   for k, v in theirs["segments"].items()}
            assert shm_model._manifest_digest(renamed) == \
                ref_shm._manifest_digest(renamed)
            renamed["manifest_sha256"] = ref_shm._manifest_digest(renamed)
            assert renamed == mine
        finally:
            shm_model.unpublish_model(mine)
            ref_shm.unpublish_model(theirs)

    def test_each_package_attaches_the_others_publication(self, workload):
        ref_w = RefWorkload(n_entities=32, seed=7)
        requests = [workload.request(i) for i in range(8)]
        want = _reference(workload, requests)
        theirs = ref_shm.publish_model(ref_w.model, version=1)
        mine = shm_model.publish_model(workload.model, version=1)
        try:
            model, attachment = shm_model.attach_model(theirs)
            runtime = ScoringRuntime(model, workload.index_maps,
                                     RuntimeConfig(**RT_CFG))
            got = np.asarray([runtime.score_rows(
                [runtime.parse_request(r)])[0][0] for r in requests],
                np.float32)
            del model, runtime
            attachment.close()
            assert got.tobytes() == want.tobytes()
            ref_model, ref_att = ref_shm.attach_model(mine)
            for name, sub in ref_w.model.models.items():
                if name == "fixed":
                    np.testing.assert_array_equal(
                        np.asarray(ref_model.models[name].model
                                   .coefficients.means),
                        np.asarray(sub.model.coefficients.means))
                else:
                    table = ref_model.models[name].coefficients
                    for key, (cols, vals) in sub.coefficients.items():
                        np.testing.assert_array_equal(table[key][0], cols)
                        np.testing.assert_array_equal(table[key][1], vals)
            del ref_model, table
            ref_att.close()
        finally:
            ref_shm.unpublish_model(theirs)
            shm_model.unpublish_model(mine)

    def test_flipped_segment_byte_fails_checksum(self, workload, hub):
        manifest = shm_model.publish_model(workload.model, version=1)
        try:
            before = hub.snapshot()["counters"].get(
                "model_map_unverified_total", 0)
            name = next(iter(manifest["segments"]))
            from multiprocessing import shared_memory

            shm = shared_memory.SharedMemory(name=name)
            try:
                shm.buf[0] = shm.buf[0] ^ 0xFF
                with pytest.raises(shm_model.ModelMapError,
                                   match="checksum"):
                    shm_model.attach_model(manifest)
            finally:
                shm.buf[0] = shm.buf[0] ^ 0xFF
                shm.close()
            assert hub.snapshot()["counters"].get(
                "model_map_unverified_total", 0) == before + 1
        finally:
            shm_model.unpublish_model(manifest)

    def test_torn_manifest_fails_self_digest(self, workload):
        manifest = shm_model.publish_model(workload.model, version=1)
        try:
            torn = dict(manifest, version=manifest["version"] + 1)
            with pytest.raises(shm_model.ModelMapError):
                shm_model.attach_model(torn)
            name = next(iter(manifest["segments"]))
            lied = {**manifest, "segments": {
                **manifest["segments"],
                name: {**manifest["segments"][name], "sha256": "0" * 64}}}
            with pytest.raises(shm_model.ModelMapError):
                shm_model.attach_model(lied)
        finally:
            shm_model.unpublish_model(manifest)

    def test_stale_manifest_after_unpublish_raises(self, workload):
        manifest = shm_model.publish_model(workload.model, version=1)
        shm_model.unpublish_model(manifest)
        with pytest.raises(shm_model.ModelMapError):
            shm_model.attach_model(manifest)

    def test_gauge_tracks_publish_and_unpublish(self, workload, hub):
        base = hub.snapshot()["gauges"].get("serving_shared_segment_bytes", 0)
        manifest = shm_model.publish_model(workload.model, version=1)
        published = sum(seg["nbytes"]
                        for seg in manifest["segments"].values())
        assert hub.snapshot()["gauges"][
            "serving_shared_segment_bytes"] == base + published
        shm_model.unpublish_model(manifest)
        assert hub.snapshot()["gauges"][
            "serving_shared_segment_bytes"] == base


# ---------------------------------------------------------------------------
# Frame protocol
# ---------------------------------------------------------------------------

class TestProtocol:
    def _pair(self):
        a, b = socket.socketpair()
        return FrameConn(a), FrameConn(b)

    def test_roundtrip(self):
        left, right = self._pair()
        try:
            payload = {"kind": "score", "id": 7, "row": [1.0, 2.0]}
            left.send(payload)
            assert right.recv() == payload
        finally:
            left.close()
            right.close()

    def test_clean_eof_returns_none(self):
        left, right = self._pair()
        left.close()
        try:
            assert right.recv() is None
        finally:
            right.close()

    def test_truncated_frame_raises(self):
        a, b = socket.socketpair()
        right = FrameConn(b)
        try:
            a.sendall((1024).to_bytes(4, "big") + b"\x00\x01")
            a.close()
            with pytest.raises(ProtocolError):
                right.recv()
        finally:
            right.close()

    def test_oversized_length_refused_at_recv(self):
        a, b = socket.socketpair()
        right = FrameConn(b)
        try:
            a.sendall((MAX_FRAME_BYTES + 1).to_bytes(4, "big"))
            with pytest.raises(ProtocolError, match="cap"):
                right.recv()
        finally:
            a.close()
            right.close()

    @pytest.mark.parametrize("message", [
        {"kind": "result", "id": 3, "ok": True,
         "value": {"score": 0.25, "mean": 0.5625, "latency_ms": 1.5}},
        {"kind": "stats", "id": 9},
    ], ids=["result", "pickled"])
    def test_frames_byte_equal_and_cross_readable(self, message):
        """A result rides the binary wire codec; other messages pickle.
        Both packages write the same bytes and read each other's."""
        assert ref_protocol._encode_payload(message) == \
            __import__("photon_ml_tpu_torch.serving.protocol",
                       fromlist=["_encode_payload"])._encode_payload(message)
        for writer, reader in ((FrameConn, ref_protocol.FrameConn),
                               (ref_protocol.FrameConn, FrameConn)):
            a, b = socket.socketpair()
            left, right = writer(a), reader(b)
            try:
                left.send(message)
                assert right.recv() == message
            finally:
                left.close()
                right.close()

    def test_score_frame_byte_equal_to_the_references(self, workload):
        from photon_ml_tpu.serving.runtime import RequestParser as RefParser
        from photon_ml_tpu_torch.serving import protocol as port_protocol
        from photon_ml_tpu_torch.serving.runtime import RequestParser

        ref_w = RefWorkload(n_entities=32, seed=7)
        req = workload.request(3)
        row = RequestParser.for_model(
            workload.model, workload.index_maps).parse(req)
        ref_row = RefParser.for_model(
            ref_w.model, ref_w.index_maps).parse(req)
        msg = {"kind": "score", "id": 5, "tenant": None,
               "timeout_ms": None, "bypass": False}
        mine = port_protocol._encode_payload(dict(msg, row=row))
        theirs = ref_protocol._encode_payload(dict(msg, row=ref_row))
        assert mine == theirs
        assert mine[0] == port_protocol._PAYLOAD_SCORE


# ---------------------------------------------------------------------------
# Metrics transport and the loadgen catalog
# ---------------------------------------------------------------------------

class TestMetricsTransport:
    def test_absorb_delta_folds_counters_gauges_histograms(self):
        src = telemetry.Telemetry(enabled=True, sinks=[]).metrics
        dst = telemetry.Telemetry(enabled=True, sinks=[]).metrics
        src.counter("serving_requests_total").inc(3)
        src.gauge("serving_queue_depth").set(5)
        src.histogram("serving_request_latency_seconds").observe(0.01)
        first = src.transport_snapshot()
        dst.absorb_delta(first)
        src.counter("serving_requests_total").inc(2)
        src.histogram("serving_request_latency_seconds").observe(0.02)
        second = src.transport_snapshot()
        dst.absorb_delta(second, first)
        snap = dst.snapshot()
        assert snap["counters"]["serving_requests_total"] == 5
        assert snap["gauges"]["serving_queue_depth"] == 5
        assert snap["histograms"][
            "serving_request_latency_seconds"]["count"] == 2

    def test_absorb_is_delta_not_double_count(self):
        src = telemetry.Telemetry(enabled=True, sinks=[]).metrics
        dst = telemetry.Telemetry(enabled=True, sinks=[]).metrics
        src.counter("serving_rows_scored_total").inc(10)
        snap1 = src.transport_snapshot()
        dst.absorb_delta(snap1)
        dst.absorb_delta(snap1, snap1)
        assert dst.snapshot()["counters"]["serving_rows_scored_total"] == 10

    def test_kernel_launches_fold_per_worker_as_deltas(self, workload):
        """Heartbeats carry cumulative launch and batch counts; the pool
        folds the differences, and a respawned worker (a new pid) counts
        from 0."""
        from photon_ml_tpu_torch.ops import _kernels

        pool = WorkerPool.__new__(WorkerPool)
        pool._lock = threading.Lock()
        pool.worker_launches = {}
        pool.worker_batches = {}
        pool.worker_processes = {}
        pool._launch_prev = {}
        before = _kernels.LAUNCHES["serve_margins"]
        try:
            for pid, n, b in ((11, 4, 0), (11, 6, 2), (12, 1, 0),
                              (12, 3, 2)):
                pool._absorb_launches(0, {
                    "pid": pid, "launches": {"serve_margins": n},
                    "batches_total": b})
            assert pool.worker_launches == {0: {"serve_margins": 9}}
            assert pool.launch_counts() == {0: {
                "launches": {"serve_margins": 9}, "batches": 4,
                "processes": 2}}
            assert _kernels.LAUNCHES["serve_margins"] == before + 9
        finally:
            _kernels.LAUNCHES["serve_margins"] = before

    def test_respawned_worker_metrics_count_from_zero(self, workload):
        """A respawned worker's counters fold from zero even when its
        first heartbeat comes before the dead worker's unregister."""
        pool = WorkerPool.__new__(WorkerPool)
        pool._lock = threading.Lock()
        pool.worker_launches = {}
        pool.worker_batches = {}
        pool.worker_processes = {}
        pool._launch_prev = {}
        pool._hb_prev = {}
        with telemetry.Telemetry(enabled=True, sinks=[]) as hub:
            for pid, n in ((21, 5), (21, 8), (22, 2)):
                pool._absorb(0, {"pid": pid, "metrics": {
                    "counters": {"serving_batches_total": n}}})
            assert hub.snapshot()["counters"][
                "serving_batches_total"] == 10


class TestLoadgenAdditions:
    def test_worker_kill_scenario_registered(self):
        scenario = loadgen.SCENARIOS["worker_kill"]
        assert any(p.action == "kill_worker" for p in scenario.phases)

    def test_report_snapshot_carries_p999(self):
        report = loadgen.LoadReport(
            mode="test", wall_seconds=1.0, completed=3, rejected=0,
            errors=0, latencies_ms=np.asarray([1.0, 2.0, 100.0]))
        snap = report.snapshot()
        assert snap["latency_p999_ms"] >= snap["latency_p99_ms"] >= \
            snap["latency_p50_ms"]


def test_serving_worker_site_registered():
    from photon_ml_tpu.chaos import KNOWN_SITES as REF_SITES

    assert "serving.worker" in chaos.KNOWN_SITES
    assert chaos.KNOWN_SITES["serving.worker"] == REF_SITES["serving.worker"]

