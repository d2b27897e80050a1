"""The binary data plane, the fused/composed bucket programs and the
batcher's adaptive wait of the port, against the JAX package's, on the CPU.

Frames are held byte for byte: a frame either package encodes decodes in
the other, and both packages encode the same bytes from the same input.
Refusals carry the reference's messages.  Inside the port: fused ==
composed bitwise at every bucket, the binary HTTP path == the JSON path
bitwise, and the kernel's C arguments marshal as its signature says.
"""

import ctypes
import json
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photon_ml_tpu.serving import wire as ref_wire
from photon_ml_tpu.serving.batcher import (
    BatcherConfig as RefBatcherConfig,
    MicroBatcher as RefBatcher,
)
from photon_ml_tpu.serving.runtime import (
    RuntimeConfig as RefRuntimeConfig,
    ScoringRuntime as RefRuntime,
)
from photon_ml_tpu.serving.synthetic import SyntheticWorkload as RefWorkload
from photon_ml_tpu_torch.data.staging import WIRE_DTYPE_TAGS, wire_dtype_tag
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.serving import kernels, wire
from photon_ml_tpu_torch.serving.batcher import BatcherConfig, MicroBatcher
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.service import (
    ScoringService,
    start_http_server,
)
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


@pytest.fixture(scope="module")
def workload():
    return SyntheticWorkload(n_entities=32, seed=7, unknown_rate=0.1)


@pytest.fixture(scope="module")
def ref_workload():
    return RefWorkload(n_entities=32, seed=7, unknown_rate=0.1)


def _runtime(workload, **kwargs):
    cfg = RuntimeConfig(**{"max_batch_size": 4, "hot_entities": 8,
                           "device": "cpu", **kwargs})
    return ScoringRuntime(workload.model, workload.index_maps, cfg)


def _requests(workload, n, start=0):
    return [workload.request(i) for i in range(start, start + n)]


# ---------------------------------------------------------------------------
# Frames across the packages
# ---------------------------------------------------------------------------

class TestFramesAcrossPackages:
    def test_dtype_tags_are_the_references(self):
        from photon_ml_tpu.data.staging import (
            WIRE_DTYPE_TAGS as REF_TAGS,
            wire_dtype_tag as ref_tag,
        )

        assert WIRE_DTYPE_TAGS == REF_TAGS
        for dt in REF_TAGS:
            assert wire_dtype_tag(dt) == ref_tag(dt)
        with pytest.raises(KeyError, match="no wire tag"):
            wire_dtype_tag(np.complex64)

    def _columns(self, seed):
        rng = np.random.default_rng(seed)
        cols = {}
        for dt in WIRE_DTYPE_TAGS:
            dt = np.dtype(dt)
            if dt == np.bool_:
                cols[f"c_{dt.name}"] = rng.random(5) > 0.5
            elif dt.kind == "f":
                cols[f"c_{dt.name}"] = rng.normal(size=5).astype(dt)
            else:
                cols[f"c_{dt.name}"] = rng.integers(0, 90, size=5).astype(dt)
        cols["mat"] = rng.normal(size=(5, 3)).astype(np.float32)
        return cols

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_column_frames_byte_equal_and_cross_decode(self, seed):
        cols = self._columns(seed)
        ours = wire.encode_columns(cols, wire.KIND_REQUEST, 5)
        theirs = ref_wire.encode_columns(cols, ref_wire.KIND_REQUEST, 5)
        assert ours == theirs
        for decode, frame in ((wire.decode_columns, theirs),
                              (ref_wire.decode_columns, ours)):
            kind, n, out = decode(frame)
            assert (kind, n) == (wire.KIND_REQUEST, 5)
            for name, arr in cols.items():
                assert np.ascontiguousarray(out[name]).tobytes() == \
                    arr.tobytes()

    def test_request_frames_byte_equal_and_cross_decode(
            self, workload, ref_workload):
        reqs = _requests(workload, 6)
        reqs[1] = dict(reqs[1], priority="high", tenant="acme",
                       timeout_ms=125.5)
        reqs[2] = dict(reqs[2], ids={})
        ours = wire.encode_request(reqs, trace="00ab-0000000000000001-1")
        theirs = ref_wire.encode_request(reqs,
                                         trace="00ab-0000000000000001-1")
        assert ours == theirs
        runtime = _runtime(workload)
        ref_rt = RefRuntime(ref_workload.model, ref_workload.index_maps,
                            RefRuntimeConfig(max_batch_size=4))
        rows, trace = wire.decode_request_ex(theirs, runtime._parser)
        ref_rows, ref_trace = ref_wire.decode_request_ex(ours, ref_rt._parser)
        assert trace == ref_trace == "00ab-0000000000000001-1"
        for row, ref in zip(rows, ref_rows):
            assert (row.offset, row.timeout_ms, row.priority, row.tenant,
                    row.ids) == (ref.offset, ref.timeout_ms, ref.priority,
                                 ref.tenant, ref.ids)
            for shard in ref.features:
                assert np.asarray(row.features[shard]).tobytes() == \
                    np.asarray(ref.features[shard]).tobytes()

    def test_response_frames_byte_equal(self):
        results = [
            {"score": 0.1234567890123456789, "mean": 0.5,
             "latency_ms": 1.875},
            {"error": "queue full; shedding", "kind": "rejected"},
            {"error": "past deadline", "kind": "deadline"},
            None,
        ]
        ours = wire.encode_response(results)
        assert ours == ref_wire.encode_response(results)
        assert wire.decode_response(ours) == ref_wire.decode_response(ours)

    def test_rows_frames_byte_equal(self, workload, ref_workload):
        runtime = _runtime(workload)
        ref_rt = RefRuntime(ref_workload.model, ref_workload.index_maps,
                            RefRuntimeConfig(max_batch_size=4))
        reqs = _requests(workload, 4)
        ours = wire.rows_to_request([runtime.parse_request(r) for r in reqs])
        theirs = ref_wire.rows_to_request(
            [ref_rt.parse_request(r) for r in reqs])
        assert ours == theirs

    def test_ipc_frames_byte_equal(self, workload, ref_workload):
        runtime = _runtime(workload)
        ref_rt = RefRuntime(ref_workload.model, ref_workload.index_maps,
                            RefRuntimeConfig(max_batch_size=4))
        req = workload.request(3)
        ours = wire.encode_score_ipc(7, runtime.parse_request(req),
                                     tenant="acme", timeout_ms=5.0)
        theirs = ref_wire.encode_score_ipc(7, ref_rt.parse_request(req),
                                           tenant="acme", timeout_ms=5.0)
        assert ours == theirs
        res = {"score": 0.25, "mean": 0.5, "latency_ms": 1.0}
        assert wire.encode_result_ipc(7, res) == \
            ref_wire.encode_result_ipc(7, res)

    def _bad_frames(self):
        good = ref_wire.encode_columns({"x": np.zeros(2, np.float32)},
                                       ref_wire.KIND_REQUEST, 2)
        magic = bytearray(good)
        magic[:4] = b"EVIL"
        version = bytearray(good)
        struct.pack_into("<H", version, 4, 99)
        tag = bytearray(good)
        struct.pack_into("<B", tag, 24 + 6, 250)
        overrun = bytearray(good)
        struct.pack_into("<I", overrun, 24 + 8, 1 << 20)
        forged = struct.pack("<4sHBBHHIII", b"PHWF", ref_wire.WIRE_VERSION,
                             1, 0, 0, 0, 1, 0, 300 << 20)
        return {
            "truncated": b"PHW", "magic": bytes(magic),
            "version": bytes(version), "dtype": bytes(tag),
            "overrun": bytes(overrun), "forged": forged,
            "long": good + b"extra", "short": good[:-1],
        }

    @pytest.mark.parametrize("case", ["truncated", "magic", "version",
                                      "dtype", "overrun", "forged", "long",
                                      "short"])
    def test_refusals_match_reference(self, case):
        frame = self._bad_frames()[case]
        with pytest.raises(ref_wire.WireFormatError) as ref_err:
            ref_wire.decode_columns(frame)
        with pytest.raises(wire.WireFormatError) as err:
            wire.decode_columns(frame)
        assert str(err.value) == str(ref_err.value)

    @pytest.mark.parametrize("reqs", [
        [{"features": {"g": [["a", "", 1.0]]}}],
        [{"dense": {"global": [[1.0, 2.0]]}}],
    ])
    def test_encode_refusals_match_reference(self, reqs):
        with pytest.raises(ValueError) as ref_err:
            ref_wire.encode_request(reqs)
        with pytest.raises(ValueError) as err:
            wire.encode_request(reqs)
        assert str(err.value) == str(ref_err.value)

    @pytest.mark.parametrize("dense", [{"nope": [1.0, 2.0]},
                                       {"global": [1.0, 2.0, 3.0]}])
    def test_decode_refusals_match_reference(self, workload, ref_workload,
                                             dense):
        runtime = _runtime(workload)
        ref_rt = RefRuntime(ref_workload.model, ref_workload.index_maps,
                            RefRuntimeConfig(max_batch_size=4))
        frame = ref_wire.encode_request([{"dense": dense}])
        with pytest.raises(ref_wire.WireFormatError) as ref_err:
            ref_wire.decode_request(frame, ref_rt._parser)
        with pytest.raises(wire.WireFormatError) as err:
            wire.decode_request(frame, runtime._parser)
        assert str(err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# Fused and composed programs
# ---------------------------------------------------------------------------

class TestFusedKernel:
    def test_fused_bit_identical_to_composed_all_buckets(self, workload):
        fused = _runtime(workload, fused=True)
        composed = _runtime(workload, fused=False)
        for n in range(1, 5):
            reqs = _requests(workload, n)
            mf, ef = fused.score_rows([fused.parse_request(r) for r in reqs])
            mc, ec = composed.score_rows(
                [composed.parse_request(r) for r in reqs])
            assert mf.tobytes() == mc.tobytes(), n
            assert ef.tobytes() == ec.tobytes(), n

    def test_fused_parity_survives_hot_promotion(self, workload):
        fused = _runtime(workload, fused=True)
        composed = _runtime(workload, fused=False)
        for _ in range(3):
            reqs = _requests(workload, 4)
            mf, ef = fused.score_rows([fused.parse_request(r) for r in reqs])
            mc, ec = composed.score_rows(
                [composed.parse_request(r) for r in reqs])
            assert mf.tobytes() == mc.tobytes()
            assert ef.tobytes() == ec.tobytes()

    def test_plain_sums_in_the_kernels_lane_order(self):
        """lane_sum is the kernel's order exactly: 32 strided lane sums
        from zero, then the xor tree — checked against a scalar float32
        emulation of one warp."""
        rng = np.random.default_rng(4)
        x = rng.normal(size=(3, 77)).astype(np.float32)
        got = kernels.lane_sum(torch.from_numpy(x)).numpy()
        for r in range(3):
            lanes = [np.float32(0.0)] * 32
            for d in range(77):
                lanes[d % 32] = np.float32(lanes[d % 32] + x[r, d])
            for off in (16, 8, 4, 2, 1):
                lanes = [np.float32(lanes[i] + lanes[i ^ off])
                         for i in range(32)]
            assert np.float32(got[r]).tobytes() == lanes[0].tobytes()

    def test_launch_arguments_marshal_as_the_signature_says(self):
        """The C arguments built for the card go through ctypes with the
        library's declared argument types (a prototype calling back into
        Python stands in for the library), and carry the right counts,
        strides and widths."""
        argtypes, restype = _kernels.SIGNATURES["serve_margins"][
            "photon_serve_margins"]
        seen = {}

        def fake(*args):
            seen["args"] = args
            return 0

        proto = ctypes.CFUNCTYPE(restype, *argtypes)(fake)
        packed = torch.zeros((4, 1 + 6 + 2 * 3))
        w = torch.ones(6)
        table = torch.zeros((5, 3))
        slots = torch.zeros((1, 4), dtype=torch.int32)
        out = torch.empty((2, 4))
        fixed = [(packed[:, 1:7], w)]
        random = [(packed[:, 7:10], table, slots[0], packed[:, 10:13])]
        args = kernels.launch_args(packed[:, 0], fixed, random, "exp", out)
        assert proto(*args, None) == 0
        a = seen["args"]
        assert len(a) == len(argtypes) == 19
        assert (a[1], a[2], a[7], a[15], a[17]) == (13, 1, 1, 2, 4)

        def read(ptr, ctype, n):
            return list(ctypes.cast(ptr, ctypes.POINTER(ctype))[:n])

        assert read(a[4], ctypes.c_longlong, 1) == [13]
        assert read(a[6], ctypes.c_int, 1) == [6]
        assert read(a[14], ctypes.c_int, 1) == [3]
        assert read(a[3], ctypes.c_void_p, 1) == [packed[:, 1:7].data_ptr()]
        assert read(a[13], ctypes.c_void_p, 1) == [slots[0].data_ptr()]

    @pytest.mark.parametrize("bad,match", [
        ("slots64", "int32"), ("strided", "contiguous columns"),
        ("link", "unknown link"), ("width", "float32 view"),
    ])
    def test_wrapper_refusals(self, bad, match):
        b = 3
        offset = torch.zeros(b)
        x = torch.zeros((b, 4))
        table = torch.zeros((5, 4))
        slots = torch.zeros(b, dtype=torch.int32)
        cold = torch.zeros((b, 4))
        link = "logistic"
        if bad == "slots64":
            slots = slots.long()
        elif bad == "strided":
            x = torch.zeros((b, 8))[:, ::2]
        elif bad == "link":
            link = "probit"
        elif bad == "width":
            cold = torch.zeros((b, 5))
        with pytest.raises(ValueError, match=match):
            kernels.serve_margins(offset, [], [(x, table, slots, cold)],
                                  link)

    def test_too_many_coordinates_refused(self):
        offset = torch.zeros(2)
        fixed = [(torch.zeros((2, 1)), torch.zeros(1))] * 9
        with pytest.raises(ValueError, match="at most 8 fixed"):
            kernels.serve_margins(offset, fixed, [], "identity")


# ---------------------------------------------------------------------------
# Batcher configuration and adaptive wait
# ---------------------------------------------------------------------------

class TestBatcherConfigValidation:
    @pytest.mark.parametrize("kwargs", [
        {"max_batch_size": 0}, {"max_wait_us": -1}, {"max_queue": 0},
        {"shed_watermark": 0.9, "reject_watermark": 0.5},
        {"shed_watermark": 0.0}, {"default_timeout_ms": 0},
        {"p99_slo_ms": -5}, {"admission_interval_s": -0.1},
        {"min_wait_us": -1}, {"wait_ewma_alpha": 0.0},
        {"wait_ewma_alpha": 1.5}, {"slo_wait_fraction": 0.0},
        {"slo_wait_fraction": 2.0},
    ])
    def test_bad_knob_refused_like_reference(self, kwargs):
        with pytest.raises(ValueError) as ref_err:
            RefBatcherConfig(**kwargs)
        with pytest.raises(ValueError) as err:
            BatcherConfig(**kwargs)
        assert str(err.value) == str(ref_err.value)

    def test_defaults_are_the_references(self):
        import dataclasses

        ours = dataclasses.asdict(BatcherConfig())
        theirs = dataclasses.asdict(RefBatcherConfig())
        assert ours == theirs


class TestAdaptiveWait:
    @pytest.mark.parametrize("kwargs,ewma", [
        ({}, None),
        ({}, 50e-6),
        ({"min_wait_us": 100}, 0.050),
        ({"p99_slo_ms": 2.0, "slo_wait_fraction": 0.25,
          "max_wait_us": 100_000}, 10e-3),
        ({"max_wait_us": 800}, None),
        ({"adaptive_wait": False, "max_wait_us": 1500}, 1e-3),
    ])
    def test_wait_budget_matches_reference(self, workload, ref_workload,
                                           kwargs, ewma):
        cfg = {"max_batch_size": 8, "max_wait_us": 2000, "max_queue": 64,
               "adaptive_wait": True, **kwargs}
        ours = MicroBatcher(_runtime(workload, max_batch_size=8),
                            BatcherConfig(**cfg))
        ref = RefBatcher(
            RefRuntime(ref_workload.model, ref_workload.index_maps,
                       RefRuntimeConfig(max_batch_size=8)),
            RefBatcherConfig(**cfg))
        ours._arrival_ewma_s = ewma
        ref._arrival_ewma_s = ewma
        assert ours._wait_budget_s() == ref._wait_budget_s()

    def test_adaptive_scores_match_static(self, workload):
        scores = []
        for adaptive in (False, True):
            runtime = _runtime(workload)
            batcher = MicroBatcher(runtime, BatcherConfig(
                max_batch_size=8, adaptive_wait=adaptive))
            batcher.start()
            try:
                scores.append([
                    batcher.submit(runtime.parse_request(
                        workload.request(i))).result(timeout=30)["score"]
                    for i in range(6)])
                stats = batcher.stats()
            finally:
                batcher.stop()
        assert scores[0] == scores[1]
        assert stats["adaptive_wait"] is True and "arrival_ewma_ms" in stats


# ---------------------------------------------------------------------------
# HTTP data plane: JSON vs binary
# ---------------------------------------------------------------------------

class _Http:
    def __init__(self, workload, **runtime_kwargs):
        self.service = ScoringService(_runtime(workload, **runtime_kwargs))
        self.service.start()
        self.server, _ = start_http_server(self.service, port=0)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.service.stop()
        return False

    def post(self, path, body, headers):
        req = urllib.request.Request(self.base + path, data=body,
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.headers.get("Content-Type"), resp.read()


class TestHttpBinaryPath:
    def test_binary_scores_bitwise_match_json(self, workload):
        with _Http(workload) as http:
            reqs = _requests(workload, 8)
            _, raw = http.post("/score", json.dumps({"rows": reqs}).encode(),
                               {"Content-Type": "application/json"})
            via_json = json.loads(raw)["results"]
            ctype, raw = http.post("/score", wire.encode_request(reqs),
                                   {"Content-Type": wire.CONTENT_TYPE})
            assert ctype == wire.CONTENT_TYPE
            via_bin = wire.decode_response(raw)
            assert len(via_bin) == len(via_json) == 8
            for b, j in zip(via_bin, via_json):
                assert b["score"] == j["score"] and b["mean"] == j["mean"]

    def test_reference_client_frames_score_like_json(self, workload):
        """A frame encoded by the JAX package's wire module scores on the
        port's server exactly like the same rows sent as JSON."""
        with _Http(workload) as http:
            reqs = _requests(workload, 4)
            _, raw = http.post("/score", json.dumps({"rows": reqs}).encode(),
                               {"Content-Type": "application/json"})
            via_json = json.loads(raw)["results"]
            _, raw = http.post("/score", ref_wire.encode_request(reqs),
                               {"Content-Type": ref_wire.CONTENT_TYPE})
            via_bin = ref_wire.decode_response(raw)
            assert [r["score"] for r in via_bin] == \
                [r["score"] for r in via_json]

    def test_accept_json_falls_back_to_json_response(self, workload):
        with _Http(workload) as http:
            ctype, raw = http.post(
                "/score", wire.encode_request(_requests(workload, 2)),
                {"Content-Type": wire.CONTENT_TYPE,
                 "Accept": "application/json"})
            assert "application/json" in ctype
            assert len(json.loads(raw)["results"]) == 2

    def test_garbage_frame_is_a_400(self, workload):
        with _Http(workload) as http:
            with pytest.raises(urllib.error.HTTPError) as err:
                http.post("/score", b"not a frame at all",
                          {"Content-Type": wire.CONTENT_TYPE})
            assert err.value.code == 400

    def test_http_submitter_binary_equals_json(self, workload):
        from photon_ml_tpu_torch.serving.loadgen import HttpSubmitter

        with _Http(workload) as http:
            reqs = _requests(workload, 6)
            out = {}
            for fmt in ("json", "binary"):
                with HttpSubmitter(http.base, wire_format=fmt,
                                   workers=2) as sub:
                    out[fmt] = [sub.submit(r).result(timeout=30)["score"]
                                for r in reqs]
            assert out["json"] == out["binary"]
