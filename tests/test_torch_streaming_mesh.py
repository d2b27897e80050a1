"""The streamed mesh (sharded staging plans, sharded chunk stores, the
streamed objective and grid over a process group, the GLM driver's
``--stream-chunk-rows`` over a group) against the JAX package's, on the
CPU.

- ``plan_staging(chunk, n_shards)`` lays the reference's stacked chunks
  (a leading shard axis a leaf) out exactly as the reference does, the
  packed bytes and the codec's wire bytes equal, and the port's unpack
  gives every leaf back bitwise.
- Spawned gloo groups of 2 and 4 ranks (``tests/torch_dist_workers.py``,
  one run a group size for the module) stream their shard of every chunk:
  each value+gradient pass is ONE all-reduce (TRON's HVP pass one more),
  within 1e-5 of Σ|terms| of the reference's mesh stream (the 8 virtual
  CPU devices of ``conftest.py`` sliced to the group's size) and of one
  process's stream; a group of 2 is bitwise 2 logical shards (a 2-term
  sum does not depend on its order), a group of 4 within 1e-5 (the
  backend's sum order is not fixed).  The ranks agree bitwise.
- The reference's guards: a fused group, a store without shards, a rank's
  store without its group, a store built for another group, the hot cache
  over several hosts.
- ``glm_driver --stream-chunk-rows --data-parallel auto`` writes one
  process's streamed models within 2e-3.
"""

import multiprocessing
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from photon_ml_tpu.data import staging as ref_staging
from photon_ml_tpu.data.streaming import (
    make_streaming_glm_data as ref_make_stream,
)
from photon_ml_tpu.optim.streaming import (
    StreamingObjective as RefStreamingObjective,
)
from photon_ml_tpu.parallel.distributed import data_mesh
from photon_ml_tpu_torch.data.staging import (
    pack_chunk,
    plan_compression,
    plan_staging,
)
from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
from photon_ml_tpu_torch.drivers import glm_driver
from photon_ml_tpu_torch.optim.streaming import (
    StreamingObjective,
    streaming_run_grid,
)
from photon_ml_tpu_torch.parallel import distributed, multihost

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_workers as workers  # noqa: E402
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

#: Seconds a spawned group may take before the test fails (it takes
#: 6-10 s alone).
JOIN_TIMEOUT = 90
FIT_TOL = 2e-3


# -- sharded staging plans ----------------------------------------------------


def _ref_store(layout, n_shards):
    """The reference's ``tests/test_staging.py`` stores: 640 rows in
    256-row chunks, dense or COO, stacked over ``n_shards``."""
    rng = np.random.default_rng(11)
    n, d = 640, 24
    if layout == "dense":
        X = rng.normal(size=(n, d)).astype(np.float32)
    else:
        X = sp.random(n, d, density=0.15, random_state=11, format="csr",
                      dtype=np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return ref_make_stream(X, y, chunk_rows=256, use_pallas=False,
                           n_shards=n_shards)


@pytest.mark.parametrize("layout", ["dense", "coo"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_plan_pack_unpack_match_reference(layout, n_shards):
    """``tests/test_staging.py``'s round trips on the reference's own
    stacked chunks: the port's plan (buffers, slots, shard shapes) and
    packed bytes equal the reference's, and the port's device unpack gives
    each leaf back bitwise, whole and one shard row at a time."""
    store = _ref_store(layout, n_shards)
    ref_plan = store.staging
    for chunk, bufs in zip(store.chunks, store.staged):
        leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(chunk)]
        plan = plan_staging(leaves, n_shards)
        assert plan.dtypes == ref_plan.dtypes
        assert plan.row_elems == ref_plan.row_elems
        assert plan.nbytes == ref_plan.nbytes
        assert [(s.buffer, s.offset, s.size, s.shape, s.shard_shape)
                for s in plan.slots] == [
            (s.buffer, s.offset, s.size, s.shape, s.shard_shape)
            for s in ref_plan.slots]
        packed = pack_chunk(plan, leaves)
        for a, b in zip(packed, bufs):
            assert a.tobytes() == np.asarray(b).tobytes()
        restored = plan.unpack_device([torch.from_numpy(b) for b in packed])
        for got, want in zip(restored, leaves):
            assert got.numpy().tobytes() == want.tobytes()
        if n_shards > 1:
            # One rank's row of each buffer unpacks to that shard's part.
            row = plan.unpack_device(
                [torch.from_numpy(b[1:2].copy()) for b in packed])
            for got, want in zip(row, leaves):
                assert got.numpy()[0].tobytes() == want[1].tobytes()


@pytest.mark.parametrize("layout", ["dense", "coo"])
@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("mode", ["lossless", "int8"])
def test_sharded_codec_matches_reference(layout, n_shards, mode):
    """``tests/test_staging.py:471``: the codec over sharded buffers (one
    int8 scale a shard row and slot) encodes the reference's wire bytes,
    and ``lossless`` decodes every leaf bitwise."""
    store = _ref_store(layout, n_shards)
    leaves = [np.asarray(a)
              for a in jax.tree_util.tree_leaves(store.chunks[0])]
    plan = plan_staging(leaves, n_shards)
    bufs = pack_chunk(plan, leaves)
    codec = plan_compression(plan, [bufs], mode)
    ref_codec = ref_staging.plan_compression(store.staging,
                                             [store.staged[0]], mode)
    assert [e.kind for e in codec.encodings] == [
        e.kind for e in ref_codec.encodings]
    assert codec.wire_nbytes == ref_codec.wire_nbytes
    wire = codec.encode(bufs)
    for a, b in zip(wire, ref_codec.encode(store.staged[0])):
        assert a.tobytes() == np.asarray(b).tobytes()
    if mode == "lossless":
        got = codec.unpack_device([torch.from_numpy(w) for w in wire])
        for g, want in zip(got, leaves):
            assert g.numpy().tobytes() == want.tobytes()


# -- sharded chunk stores -----------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True], ids=["coo", "kernel"])
def test_sharded_store_parts_hold_the_reference_rows(use_kernel):
    """Shard s of chunk c holds the reference's rows: chunk_rows rounded
    up to a multiple of the shards, ``per_shard`` rows a part with local
    row ids, weight-0 padding; each part is a matrix of its own (the
    kernel layout, when asked)."""
    X, y, *_ = workers.stream_xy(n=700)
    store = make_streaming_glm_data(X, y, chunk_rows=250, n_shards=4,
                                    device="cpu", use_kernel=use_kernel)
    ref = ref_make_stream(X, y, chunk_rows=250, use_pallas=False,
                          n_shards=4)
    assert (store.chunk_rows, store.per_shard) == (ref.chunk_rows, 63)
    assert store.n_chunks == ref.n_chunks == 3
    dense = np.asarray(X.todense())
    for p, part in enumerate(store.chunks):
        c, s, start = store.part_rows(p)
        data = part.to_data({k: torch.from_numpy(np.array(v))
                             for k, v in part.leaves.items()})
        np.testing.assert_array_equal(
            data.weights.numpy(),
            np.asarray(ref.chunks[c].weights)[s])
        rows = slice(start, min(start + store.per_shard, dense.shape[0]))
        eye = torch.eye(dense.shape[1])
        got = torch.stack([data.features.matvec(eye[j])
                           for j in range(dense.shape[1])], 1).numpy()
        np.testing.assert_array_equal(got[:rows.stop - rows.start],
                                      dense[rows])
        assert part.kind == ("kernel" if use_kernel else "coo")


@pytest.mark.parametrize("n_shards", [1, 4])
def test_disk_store_bit_identical_to_ram(tmp_path, n_shards):
    """``tests/test_streaming.py:1183`` with shards: the disk-backed store's
    parts (memmaps of their staging buffers) equal the RAM store's."""
    X, y, *_ = workers.stream_xy(n=700)
    kw = dict(chunk_rows=256, n_shards=n_shards, device="cpu",
              use_kernel=False)
    ram = make_streaming_glm_data(X, y, **kw)
    disk = make_streaming_glm_data(X, y, storage_dir=str(tmp_path / "s"),
                                   **kw)
    assert len(disk.chunks) == len(ram.chunks) == 3 * n_shards
    for a, b in zip(ram.chunks, disk.chunks):
        assert any(isinstance(v, np.memmap) for v in b.leaves.values())
        for k in a.leaves:
            np.testing.assert_array_equal(a.leaves[k], b.leaves[k])


# -- the streamed objective over a group --------------------------------------


def _spawn(world, root, driver_argv):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.stream_rank_main,
                         args=(r, world, str(root / "rendezvous"), str(root),
                               driver_argv))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(world)]


def _driver_argv(root):
    from photon_ml_tpu_torch.data.libsvm import write_libsvm

    X, y, *_ = workers.stream_xy(n=600, d=12, density=0.3)
    write_libsvm(str(root / "train.libsvm"), X, np.where(y > 0, 1.0, -1.0))
    return ["--train-data", str(root / "train.libsvm"), "--reg-type", "l2",
            "--reg-weights", "0.1,1,10", "--tolerance", "1e-6",
            "--output-mode", "all", "--stream-chunk-rows", "128",
            "--device", "cpu"]


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def group(request, tmp_path_factory):
    world = request.param
    root = tmp_path_factory.mktemp(f"stream_group{world}")
    argv = _driver_argv(root)
    ranks = _spawn(world, root, argv + ["--data-parallel", "auto",
                                        "--output-dir", str(root / "dp")])
    return world, ranks, root, argv


def test_ranks_agree_bitwise(group):
    world, ranks, _, _ = group
    for other in ranks[1:]:
        for k, a in ranks[0].items():
            if not k.endswith("transfer_bytes"):
                assert other[k].tobytes() == a.tobytes(), k


def _terms(X, y, offsets, w, l2):
    """Σ|terms| of the logistic value and of each gradient coordinate, in
    float64 (the scale the streamed sums are held to)."""
    m = np.asarray(X @ w.astype(np.float64)).ravel() + offsets
    value = np.logaddexp(0.0, m) - y * m
    d1 = 1.0 / (1.0 + np.exp(-m)) - y
    gabs = np.asarray(abs(X).T @ np.abs(d1)).ravel() + l2 * np.abs(w)
    return float(np.abs(value).sum() + 0.5 * l2 * (w @ w)), gabs


@pytest.mark.parametrize("tag", ["coo", "kernel", "kahan"])
def test_group_pass_matches_reference_mesh(group, tag, eight_devices):
    """A value+gradient pass over the group: ONE all-reduce; within 1e-5 of
    Σ|terms| of the reference's mesh stream and of one process's stream;
    the HVP, the Hessian diagonal and the scores too (the scores exactly
    one process's: a gather moves bits)."""
    world, ranks, _, _ = group
    saved = ranks[0]
    X, y, offsets, w, v = workers.stream_xy()
    vterm, gterm = _terms(X, y, offsets, w, 0.7)
    assert int(saved[f"{tag}/vg_allreduces"]) == 1
    assert int(saved[f"{tag}/hvp_allreduces"]) == 1
    mesh = data_mesh(eight_devices[:world])
    ref = RefStreamingObjective(
        "logistic", ref_make_stream(X, y, chunk_rows=workers.STREAM_CHUNK,
                                    use_pallas=False, n_shards=world),
        mesh=mesh)
    rv, rg = ref.value_and_grad(jnp.asarray(w), 0.7,
                                offsets=jnp.asarray(offsets))
    one = StreamingObjective(
        "logistic", make_streaming_glm_data(
            X, y, chunk_rows=workers.STREAM_CHUNK, device="cpu",
            use_kernel=False))
    wt = torch.from_numpy(w)
    ov, og = one.value_and_grad(wt, 0.7, offsets=offsets)
    for want_v, want_g in ((float(rv), np.asarray(rg)),
                           (float(ov), og.numpy())):
        assert abs(float(saved[f"{tag}/value"]) - want_v) <= 1e-5 * vterm
        assert np.all(np.abs(saved[f"{tag}/grad"] - want_g) <= 1e-5 * gterm)
    rh = np.asarray(ref.hvp(jnp.asarray(w), jnp.asarray(v), 0.7,
                            offsets=jnp.asarray(offsets)))
    np.testing.assert_allclose(saved[f"{tag}/hvp"], rh, rtol=1e-5,
                               atol=1e-5 * float(np.abs(rh).max()))
    rd = np.asarray(ref.hessian_diagonal(jnp.asarray(w),
                                         offsets=jnp.asarray(offsets)))
    np.testing.assert_allclose(saved[f"{tag}/hdiag"], rd, rtol=1e-5,
                               atol=1e-5 * float(np.abs(rd).max()))
    np.testing.assert_allclose(saved[f"{tag}/scores"], one.scores(wt),
                               rtol=0, atol=1e-6)
    # The batched pass: row 0 is the single pass, bitwise at two ranks; at
    # four gloo sums a longer buffer in another order (within 1e-5).
    bv, bg = saved[f"{tag}/batch_value"][0], saved[f"{tag}/batch_grad"][0]
    if world == 2:
        assert bv.tobytes() == saved[f"{tag}/value"].tobytes()
        assert bg.tobytes() == saved[f"{tag}/grad"].tobytes()
    assert abs(float(bv - saved[f"{tag}/value"])) <= 1e-5 * vterm
    assert np.all(np.abs(bg - saved[f"{tag}/grad"]) <= 1e-5 * gterm)


@pytest.mark.parametrize("tag", ["coo", "kernel", "kahan"])
def test_group_is_logical_shards(group, tag):
    """Against k logical shards (``n_shards=k``, ``mesh=None``): bitwise at
    two ranks (a two-term sum has one result), within 1e-5 of Σ|terms| at
    four (gloo's sum order over more ranks is not fixed).  The scores are
    bitwise either way."""
    world, ranks, _, _ = group
    saved = ranks[0]
    logical = workers.stream_passes(
        None, n_shards=world, use_kernel=tag == "kernel",
        kahan=tag == "kahan")
    X, y, offsets, w, _ = workers.stream_xy()
    vterm, gterm = _terms(X, y, offsets, w, 0.7)
    assert logical["scores"].tobytes() == saved[f"{tag}/scores"].tobytes()
    for key in ("value", "grad", "batch_value", "batch_grad", "hvp",
                "hdiag"):
        if world == 2:
            assert logical[key].tobytes() == saved[f"{tag}/{key}"].tobytes()
    if world > 2:
        assert abs(float(logical["value"] - saved[f"{tag}/value"])) \
            <= 1e-5 * vterm
        assert np.all(np.abs(logical["grad"] - saved[f"{tag}/grad"])
                      <= 1e-5 * gterm)


def test_group_moves_only_its_shard(group):
    """A rank's pipeline moves its own part of each chunk: about 1/k of
    one process's bytes."""
    world, ranks, _, _ = group
    X, y, *_ = workers.stream_xy()
    one = make_streaming_glm_data(X, y, chunk_rows=workers.STREAM_CHUNK,
                                  device="cpu", use_kernel=False)
    whole = sum(b.nbytes for bufs in one.staged for b in bufs)
    # Five passes in stream_passes (vg, batch, hvp, hdiag, scores).
    per_pass = [int(r["coo/transfer_bytes"]) / 5 for r in ranks]
    assert sum(per_pass) == pytest.approx(whole, rel=0.05)
    assert max(per_pass) < 0.7 * whole


@pytest.mark.parametrize("name", [g[0] for g in workers.GRID_SOLVES])
def test_group_grid_fit(group, name):
    """``tests/test_streaming.py:550`` (the sharded grid fit), with OWL-QN
    and TRON too: each solve over the group within the drivers' 2e-3 of
    the largest |w| of one process's streamed solve (solves to 1e-9 stop
    on the float32 noise floor, where the sum order decides the last
    steps)."""
    world, ranks, _, _ = group
    one = workers.stream_grid(None)
    got, want = ranks[0][f"grid/{name}"], one[f"grid/{name}"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FIT_TOL * max(1.0, np.abs(want).max()))


def test_group_driver_streamed_route(group, tmp_path):
    """``tests/test_multiprocess.py:252``: ``glm_driver --stream-chunk-rows
    --data-parallel auto`` over the group (rank 0 writes) against one
    process's streamed run: every λ's model within 2e-3."""
    from photon_ml_tpu_torch.io import model_store

    world, ranks, root, argv = group
    assert int(ranks[0]["driver/ranks"]) == world
    single = glm_driver.run(argv + ["--output-dir", str(tmp_path / "one")])
    assert int(ranks[0]["driver/chunks"]) == single["streaming"]["chunks"]
    for lam in single["metrics"]:
        name = f"model_lambda_{float(lam):g}.avro"
        m, _ = model_store.load_glm_model(str(root / "dp" / name),
                                          device="cpu")
        m1, _ = model_store.load_glm_model(str(tmp_path / "one" / name),
                                           device="cpu")
        want = m1.coefficients.means.numpy()
        np.testing.assert_allclose(
            m.coefficients.means.numpy(), want, rtol=0,
            atol=FIT_TOL * max(1.0, np.abs(want).max()))


# -- a group of one rank, and the guards --------------------------------------


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield multihost.global_data_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_group_is_one_process_bitwise(one_rank_group):
    """A one-rank group streams the one process's store: its passes, grid
    and scores bitwise, one all-reduce a pass."""
    mesh = one_rank_group
    X, y, offsets, w, _ = workers.stream_xy()
    kw = dict(chunk_rows=workers.STREAM_CHUNK, device="cpu",
              use_kernel=False)
    one = StreamingObjective("logistic", make_streaming_glm_data(X, y, **kw))
    grp = StreamingObjective(
        "logistic", make_streaming_glm_data(X, y, mesh=mesh, **kw),
        mesh=mesh)
    wt = torch.from_numpy(w)
    distributed.reset_allreduces()
    for a, b in zip(one.value_and_grad(wt, 0.7, offsets=offsets),
                    grp.value_and_grad(wt, 0.7, offsets=offsets)):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert distributed.ALLREDUCES["count"] == 1
    assert one.scores(wt).tobytes() == grp.scores(wt).tobytes()
    prob = workers.problem("logistic", "l2", max_iters=40, tolerance=1e-8)
    w1 = streaming_run_grid(prob, one, [1.0])[0][1].coefficients.means
    wg = streaming_run_grid(prob, grp, [1.0],
                            mesh=mesh)[0][1].coefficients.means
    assert w1.numpy().tobytes() == wg.numpy().tobytes()


def test_mesh_guards(one_rank_group, monkeypatch):
    """The reference's guards (``optim/streaming.py:314-405``,
    ``tests/test_streaming.py:734,1383``,
    ``tests/test_multiprocess.py:556``): one-shard chunks without shards
    with a group, a fused group, sharded chunks without a group, a store of
    all logical shards or of another group size with a group, and the hot
    cache over several hosts."""
    mesh = one_rank_group
    X, y, *_ = workers.stream_xy(n=200)
    kw = dict(chunk_rows=64, device="cpu", use_kernel=False)
    plain = make_streaming_glm_data(X, y, **kw)
    with pytest.raises(ValueError, match="no shard axis"):
        StreamingObjective("logistic", plain, mesh=mesh)
    rank_store = make_streaming_glm_data(X, y, mesh=mesh, **kw)
    with pytest.raises(ValueError, match="single-device"):
        StreamingObjective("logistic", rank_store, mesh=mesh, chunk_fuse=2)
    with pytest.raises(ValueError, match="need a mesh"):
        StreamingObjective("logistic", rank_store)
    with pytest.raises(ValueError, match="logical shards"):
        StreamingObjective(
            "logistic", make_streaming_glm_data(X, y, n_shards=2, **kw),
            mesh=mesh)
    with pytest.raises(ValueError, match="n_shards=2 under a group of 1"):
        make_streaming_glm_data(X, y, n_shards=2, mesh=mesh, **kw)
    monkeypatch.setattr(multihost, "spans_hosts", lambda m: True)
    with pytest.raises(ValueError, match="single-host"):
        StreamingObjective("logistic", rank_store, mesh=mesh,
                           hot_budget_bytes=1 << 20)


def test_out_of_core_random_effect_single_host_guard(one_rank_group,
                                                     monkeypatch):
    """The reference's single-host guard (``game/ooc_random.py:230-238``):
    a group that spans more than one host is refused."""
    from photon_ml_tpu_torch.game.data import build_random_effect_dataset
    from photon_ml_tpu_torch.game.ooc_random import (
        OutOfCoreRandomEffectCoordinate,
    )

    keys, X, y, w, _ = workers.zipf_entities(3, 20, 4)
    host = build_random_effect_dataset(keys, X, y, w, device=False)
    monkeypatch.setattr(multihost, "spans_hosts", lambda m: True)
    with pytest.raises(NotImplementedError, match="single-host"):
        OutOfCoreRandomEffectCoordinate(
            "re", host, "logistic", workers.game_config(),
            device_budget_bytes=1 << 20, mesh=one_rank_group, device="cpu")


@pytest.mark.parametrize("flag", ["--stream-chunk-fuse",
                                  "--stream-hot-budget-mb"])
def test_driver_refuses_fused_or_cached_streams_over_a_group(tmp_path, flag):
    """``drivers/glm_driver.py:485-495``: a fused group or the hot cache is
    refused with ``--data-parallel`` before any ingest."""
    args = glm_driver.build_arg_parser().parse_args([
        "--train-data", "t", "--output-dir", str(tmp_path),
        "--stream-chunk-rows", "64", flag, "2"])
    with pytest.raises(ValueError, match="single-device"):
        glm_driver._check_stream_flags(args, data_parallel=True)
    assert glm_driver._check_stream_flags(args, data_parallel=False)
