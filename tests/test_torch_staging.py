"""The port's chunk staging, wire codec and prefetch pipeline
(``data/staging.py``, ``data/prefetch.py``) against the reference's.

- Staging: a chunk's leaves pack into dtype-segregated buffers, the host
  leaves are zero-copy views into them, and the device unpack (torch views)
  gives every leaf back exactly; the plan and the packed bytes equal the
  reference's for the same leaves.
- Codec: ``lossless`` gives the raw buffers back byte for byte; the wire
  buffers the port encodes equal the reference's byte for byte; fp16 stays
  within rtol 1e-3 / atol 1e-4 and int8 within maxabs/127 + 1e-7 of a slot
  (the reference's stated bounds), integer and {0,1} slots exact.
- Pipeline: order, the liveness bound, error propagation and the stage
  attribution of the reference's ``run_prefetched`` tests.
"""

import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data import staging as ref_staging
from photon_ml_tpu_torch.data.prefetch import (
    HostToDevice,
    TransferStats,
    run_prefetched,
)
from photon_ml_tpu_torch.data.staging import (
    COMPRESSION_MODES,
    pack_chunk,
    plan_compression,
    plan_staging,
)
from photon_ml_tpu_torch.data.streaming import (
    StreamingGlmData,
    make_streaming_glm_data,
)
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

LAYOUTS = ["dense", "coo", "kernel"]


def _problem(rng, n, d, layout, seed=11):
    if layout == "dense":
        X = rng.normal(size=(n, d)).astype(np.float32)
        logits = X @ (rng.normal(size=d) * 0.3)
    else:
        X = sp.random(n, d, density=0.15, random_state=seed, format="csr",
                      dtype=np.float32)
        X = sp.hstack([sp.csr_matrix(np.ones((n, 1), np.float32)),
                       X[:, 1:]]).tocsr()
        logits = np.asarray(X @ (rng.normal(size=d) * 0.3)).ravel()
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


def _stream(rng, layout, n=640, d=24, chunk_rows=256):
    X, y = _problem(rng, n, d, layout)
    return X, y, make_streaming_glm_data(
        X, y, chunk_rows=chunk_rows, use_kernel=(layout == "kernel"),
        device="cpu")


def _device(bufs):
    return [torch.from_numpy(np.array(b)) for b in bufs]


class TestStagingRoundtrip:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_pack_view_unpack_bit_exact(self, rng, layout):
        _, _, stream = _stream(rng, layout)
        assert stream.kind == layout and stream.n_chunks == 3
        assert len(stream.staged) == len(stream.staging) == stream.n_chunks
        for plan, bufs, chunk in zip(stream.staging, stream.staged,
                                     stream.chunks):
            # Dtype segregation keeps the per-chunk copy count O(1).
            assert 1 <= plan.n_buffers <= 3
            for leaf in chunk.leaves.values():
                assert leaf.size == 0 or any(
                    np.shares_memory(leaf, b) for b in bufs)
            for a, b in zip(pack_chunk(plan, chunk.leaves), bufs):
                np.testing.assert_array_equal(a, b)
            assert plan.nbytes == sum(b.nbytes for b in bufs)
            restored = plan.unpack_device(_device(bufs))
            assert sorted(restored) == sorted(chunk.leaves)
            for name, host in chunk.leaves.items():
                dev = restored[name].numpy()
                assert dev.shape == host.shape and dev.dtype == host.dtype
                np.testing.assert_array_equal(dev, host)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_plan_and_bytes_match_reference(self, rng, layout):
        """The reference stages the same leaves (a dict flattens in sorted
        key order there too) into the same buffers, byte for byte."""
        _, _, stream = _stream(rng, layout)
        for plan, bufs, chunk in zip(stream.staging, stream.staged,
                                     stream.chunks):
            leaves = {k: np.asarray(v) for k, v in chunk.leaves.items()}
            ref_plan = ref_staging.plan_staging(leaves, 1)
            assert plan.dtypes == ref_plan.dtypes
            assert plan.row_elems == ref_plan.row_elems
            assert [(s.buffer, s.offset, s.size, s.shape)
                    for s in plan.slots] == [
                (s.buffer, s.offset, s.size, s.shape)
                for s in ref_plan.slots]
            for a, b in zip(bufs, ref_staging.pack_chunk(ref_plan, leaves)):
                assert np.asarray(a).tobytes() == b.tobytes()

    def test_plan_rejects_mismatched_chunk(self, rng):
        _, _, stream = _stream(rng, "coo")
        other = {k: np.zeros((3,) + v.shape[1:], v.dtype)
                 for k, v in stream.chunks[0].leaves.items()}
        with pytest.raises(ValueError, match="staging plan"):
            pack_chunk(stream.staging[0], other)

    def test_sharded_plans_refused(self):
        """A sharded plan takes leaves with the leading shard axis (one
        buffer row a shard); a leaf without it is refused, as the
        reference's ``_shard_split`` refuses it."""
        plan = plan_staging({"a": np.zeros((2, 3), np.float32)}, n_shards=2)
        assert plan.row_elems == (3,) and plan.slots[0].shard_shape == (3,)
        with pytest.raises(ValueError, match="leading shard axis"):
            plan_staging({"a": np.zeros((3, 3), np.float32)}, n_shards=2)

    def test_ensure_staged_retrofits_hand_built_store(self, rng):
        _, _, stream = _stream(rng, "coo")
        hand = StreamingGlmData(
            chunks=[type(c)(c.kind, {k: np.array(v)
                                     for k, v in c.leaves.items()},
                            c.n_rows, c.n_cols, c.meta)
                    for c in stream.chunks],
            n_rows=stream.n_rows, n_features=stream.n_features,
            chunk_rows=stream.chunk_rows, device=stream.device)
        assert hand.staged is None
        assert hand.ensure_staged()
        for a, b in zip(hand.staged, stream.staged):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        for c, bufs in zip(hand.chunks, hand.staged):
            assert all(v.size == 0 or any(np.shares_memory(v, b)
                                          for b in bufs)
                       for v in c.leaves.values())


def _codec_roundtrip(plan, bufs, mode):
    codec = plan_compression(plan, [bufs], mode)
    got = codec.unpack_device(_device(codec.encode(bufs)))
    ref = plan.unpack_device(_device(bufs))
    return codec, [(got[k].numpy(), ref[k].numpy()) for k in sorted(ref)]


def _exact_slot(r):
    return r.dtype.kind != "f" or set(np.unique(r)) <= {0.0, 1.0}


class TestChunkCodec:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_lossless_bitwise_and_smaller(self, rng, layout):
        _, _, stream = _stream(rng, layout)
        for plan, bufs in zip(stream.staging, stream.staged):
            codec, pairs = _codec_roundtrip(plan, bufs, "lossless")
            assert codec.is_lossless
            assert codec.wire_nbytes < codec.logical_nbytes
            for g, r in pairs:
                assert g.dtype == r.dtype and g.shape == r.shape
                assert g.tobytes() == r.tobytes()

    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("mode", ["lossless", "fp16", "int8"])
    def test_wire_matches_reference(self, rng, layout, mode):
        """Same staged buffers, same encodings, same wire bytes."""
        _, _, stream = _stream(rng, layout)
        for plan, bufs, chunk in zip(stream.staging, stream.staged,
                                     stream.chunks):
            leaves = {k: np.asarray(v) for k, v in chunk.leaves.items()}
            ref_plan = ref_staging.plan_staging(leaves, 1)
            ref_bufs = ref_staging.pack_chunk(ref_plan, leaves)
            codec = plan_compression(plan, [bufs], mode)
            ref_codec = ref_staging.plan_compression(ref_plan, [ref_bufs],
                                                     mode)
            assert [e.kind for e in codec.encodings] == [
                e.kind for e in ref_codec.encodings]
            assert codec.wire_dtypes == ref_codec.wire_dtypes
            for a, b in zip(codec.encode(bufs), ref_codec.encode(ref_bufs)):
                assert a.tobytes() == b.tobytes()

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_fp16_error_bounds(self, rng, layout):
        _, _, stream = _stream(rng, layout)
        codec, pairs = _codec_roundtrip(stream.staging[0], stream.staged[0],
                                        "fp16")
        assert not codec.is_lossless and "fp16" in codec.kinds
        for g, r in pairs:
            if _exact_slot(r):
                assert g.tobytes() == r.tobytes()
            else:
                np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_int8_error_bounds(self, rng, layout):
        _, _, stream = _stream(rng, layout)
        codec, pairs = _codec_roundtrip(stream.staging[0], stream.staged[0],
                                        "int8")
        assert "int8" in codec.kinds
        for g, r in pairs:
            if _exact_slot(r):
                assert g.tobytes() == r.tobytes()
            else:
                assert np.abs(g - r).max() <= np.abs(r).max() / 127 + 1e-7

    def test_delta_beats_downcast_on_sorted_large_values(self):
        chunk = {"idx": np.arange(256, dtype=np.int64) * 100,
                 "v": np.ones(4, np.float32)}
        plan = plan_staging(chunk)
        bufs = pack_chunk(plan, chunk)
        codec, pairs = _codec_roundtrip(plan, bufs, "lossless")
        kinds = {s.size: e.kind for s, e in zip(plan.slots, codec.encodings)}
        assert kinds[256] == "delta"
        for g, r in pairs:
            assert g.tobytes() == r.tobytes()

    def test_bitmap_rejects_negative_zero(self):
        ok = {"b": np.array([0.0, 1.0, 1.0, 0.0], np.float32)}
        st = plan_staging(ok)
        assert plan_compression(st, [pack_chunk(st, ok)],
                                "lossless").encodings[0].kind == "bitmap"
        bad = {"b": np.array([-0.0, 1.0, 1.0, 0.0], np.float32)}
        st2 = plan_staging(bad)
        assert plan_compression(st2, [pack_chunk(st2, bad)],
                                "lossless").encodings[0].kind == "raw"

    def test_fp16_overflow_falls_back_to_raw(self):
        chunk = {"v": np.array([1e5, -2.0, 3.0, 4.0], np.float32)}
        st = plan_staging(chunk)
        assert plan_compression(st, [pack_chunk(st, chunk)],
                                "fp16").encodings[0].kind == "raw"

    def test_mode_off_and_unknown(self, rng):
        _, _, stream = _stream(rng, "coo")
        plan, bufs = stream.staging[0], [stream.staged[0]]
        assert plan_compression(plan, bufs, "off") is None
        with pytest.raises(ValueError, match="compress must be one of"):
            plan_compression(plan, bufs, "zstd")
        assert set(COMPRESSION_MODES) == {"off", "lossless", "fp16", "int8"}

    @pytest.mark.parametrize("values,kind", [
        (np.array([0.0, 1.0, 1.0, 0.0, 1.0]), "bitmap"),
        (np.array([-0.0, 1.0, 0.0]), "downcast"),
        (np.array([1.0, -0.5, 2.75, 1024.0, -3.125]), "downcast"),
        (np.array([0.1, 1.0 + 2.0 ** -40]), "raw"),
    ], ids=["binary", "negative-zero", "f32-exact", "full-mantissa"])
    def test_f64_slots(self, values, kind):
        """f64 planning: bitmaps for bitwise {0,1}, an f32 wire when every
        value round-trips bitwise (the sign of -0.0 rides along), raw
        otherwise; every decode is bitwise."""
        chunk = {"offs": values.astype(np.float64),
                 "v": np.linspace(-1, 1, 8, dtype=np.float32)}
        plan = plan_staging(chunk)
        codec, pairs = _codec_roundtrip(plan, pack_chunk(plan, chunk),
                                        "lossless")
        assert codec.encodings[0].kind == kind and codec.is_lossless
        for g, r in pairs:
            assert g.dtype == r.dtype and g.tobytes() == r.tobytes()


class TestRunPrefetched:
    def test_order_and_results(self):
        items = [np.full((4,), k, np.float32) for k in range(7)]
        seen = []
        run_prefetched(len(items), lambda k: items[k], lambda h: h * 2,
                       lambda k, dev: seen.append((k, float(dev[0]))),
                       depth=2)
        assert seen == [(k, 2.0 * k) for k in range(7)]

    def test_liveness_bound_holds_at_put(self):
        counts = {"put": 0, "consumed": 0}
        violations = []
        depth = 3

        def put(h):
            counts["put"] += 1
            if counts["put"] - counts["consumed"] > depth:
                violations.append(dict(counts))
            return h

        run_prefetched(20, lambda k: np.zeros(1), put,
                       lambda k, dev: counts.__setitem__(
                           "consumed", counts["consumed"] + 1),
                       depth=depth)
        assert not violations

    def test_producer_error_propagates(self):
        def get_item(k):
            if k == 2:
                raise RuntimeError("ingest exploded")
            return np.zeros(1)

        consumed = []
        with pytest.raises(RuntimeError, match="ingest exploded"):
            run_prefetched(5, get_item, lambda h: h,
                           lambda k, dev: consumed.append(k), depth=2)
        assert consumed == [0, 1]

    def test_consumer_error_stops_producer(self):
        def consume(k, dev):
            if k == 1:
                raise ValueError("consumer bailed")

        with pytest.raises(ValueError, match="consumer bailed"):
            run_prefetched(50, lambda k: np.zeros(1), lambda h: h, consume,
                           depth=2, stats=TransferStats())
        for _ in range(50):
            if not any(t.name == "h2d-prefetch" and t.is_alive()
                       for t in threading.enumerate()):
                break
            time.sleep(0.1)
        else:
            pytest.fail("producer thread still alive after consumer error")

    def test_empty_and_invalid(self):
        stats = TransferStats()
        assert run_prefetched(0, lambda k: None, lambda h: h,
                              lambda k, d: None, depth=2, stats=stats) == 0
        assert stats.passes == 1
        with pytest.raises(ValueError, match="depth"):
            run_prefetched(1, lambda k: None, lambda h: h, lambda k, d: None,
                           depth=0)

    def test_stage_seconds_recorded_and_consistent(self):
        stats = TransferStats()

        def slow(x=None, *a):
            time.sleep(0.002)
            return np.zeros(64, np.float32)

        run_prefetched(6, slow, lambda h: slow() + h, lambda k, d: slow(),
                       depth=2, stats=stats)
        assert stats.pack_seconds > 0.0 and stats.consume_seconds > 0.0
        assert stats.h2d_seconds >= stats.dispatch_seconds > 0.0
        assert stats.h2d_device_seconds == 0.0  # no card: no CUDA events
        assert abs(stats.stage_seconds - (stats.pack_seconds
                                          + stats.h2d_seconds
                                          + stats.consume_seconds)) < 1e-12
        assert set(stats.snapshot()) >= {
            "pack_seconds", "dispatch_seconds", "consume_seconds",
            "stage_seconds", "h2d_device_seconds", "gbps"}

    def test_slot_waits_are_pack_stalls_not_pack_time(self):
        """A packed item that reports a wait for its pinned slot
        (``stall_seconds``, as ``HostToDevice.pack`` does) books that wait
        as a pack stall and leaves it out of ``pack_seconds``."""

        class Packed(list):
            stall_seconds = 0.0

        def get_item(k):
            t0 = time.perf_counter()
            time.sleep(0.02 if k % 2 else 0.0)  # the slot wait
            item = Packed([np.zeros(8, np.float32)])
            item.stall_seconds = (time.perf_counter() - t0) if k % 2 else 0.0
            return item

        stats = TransferStats()
        run_prefetched(4, get_item, lambda h: list(h), lambda k, d: None,
                       depth=2, stats=stats)
        assert stats.pack_stalls == 2
        assert stats.pack_stall_seconds >= 0.04
        assert 0.0 <= stats.pack_seconds < 0.02
        assert {"pack_stalls", "pack_stall_seconds"} <= set(stats.snapshot())

    def test_stages_run_on_their_own_threads(self):
        names, put_names = set(), set()

        def get_item(k):
            names.add(threading.current_thread().name)
            return np.zeros(8, np.float32)

        def put(h):
            put_names.add(threading.current_thread().name)
            return h

        run_prefetched(4, get_item, put, lambda k, d: None, depth=2)
        assert names == {"h2d-pack"} and put_names == {"h2d-prefetch"}

    def test_pack_failure_propagates_in_order(self):
        consumed = []

        def get_item(k):
            if k == 3:
                raise RuntimeError("pack exploded")
            return np.zeros(4, np.float32)

        with pytest.raises(RuntimeError, match="pack exploded"):
            run_prefetched(8, get_item, lambda h: h,
                           lambda k, d: consumed.append(k), depth=2)
        assert consumed == [0, 1, 2]

    def test_wait_hook_times_the_copy(self):
        """A ``put`` result with ``wait()`` is waited for on the transfer
        thread and its seconds land in ``h2d_device_seconds``."""
        class InFlight:
            def __init__(self, h):
                self.h = h

            def wait(self):
                return 0.25

        stats = TransferStats()
        seen = []
        run_prefetched(3, lambda k: np.full(2, k, np.float32), InFlight,
                       lambda k, d: seen.append(float(d.h[0])), depth=2,
                       stats=stats)
        assert seen == [0.0, 1.0, 2.0]
        assert stats.h2d_device_seconds == pytest.approx(0.75)
        assert stats.gbps == pytest.approx(stats.bytes / 0.75 / 1e9)


def test_host_to_device_on_the_cpu_copies_each_array():
    """On the CPU the mover's transfer is a host copy: the consumer gets
    torch tensors equal to the arrays and sharing no memory with them."""
    mover = HostToDevice(torch.device("cpu"), depth=2)
    mover.begin_pass(threading.Event())
    arrays = [np.arange(6, dtype=np.int32).reshape(1, 6),
              np.linspace(0, 1, 5, dtype=np.float32).reshape(1, 5)]
    out = mover.ready(mover.put(mover.pack(arrays)))
    for a, t in zip(arrays, out):
        np.testing.assert_array_equal(t.numpy(), a)
        assert not np.shares_memory(t.numpy(), a)
