"""GAME IO of the port against the JAX package's, on the CPU: the Avro reader
(with the native and the Python decoder), the GAME model store, both GAME
checkpoint kinds, the scoring-result writer and the binary index map.

The reader's output is held EXACTLY (same CSR arrays, ids, columns, index
maps); the file formats are held by loading what each package writes with
the other and comparing arrays for equality, and by byte equality of the
files both write from the same input.
"""

import json
import struct
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.data import game_reader as ref_reader
from photon_ml_tpu.data.index_map import BinaryIndexMap as RefBinaryIndexMap
from photon_ml_tpu.game import estimator as ref_est
from photon_ml_tpu.game.model import (
    FixedEffectModel as RefFixed,
    GameModel as RefGameModel,
    RandomEffectModel as RefRandom,
)
from photon_ml_tpu.io import avro as ref_avro
from photon_ml_tpu.io import checkpoint as ref_ckpt
from photon_ml_tpu.io import game_store as ref_store
from photon_ml_tpu.models.glm import (
    Coefficients as RefCoefficients,
    GeneralizedLinearModel as RefGLM,
)
from photon_ml_tpu.optim.problem import (
    GlmOptimizationConfig as RefConfig,
    OptimizerConfig as RefOpt,
)
from photon_ml_tpu.optim.regularization import RegularizationContext as RefReg
from photon_ml_tpu_torch import native
from photon_ml_tpu_torch.data import game_reader
from photon_ml_tpu_torch.data.index_map import BinaryIndexMap, IndexMap
from photon_ml_tpu_torch.game import estimator
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.io import avro, checkpoint, game_store
from photon_ml_tpu_torch.models.glm import (
    Coefficients,
    GeneralizedLinearModel,
)
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    OptimizerConfig,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = "cpu"


def _rows(seed, n=400):
    """GAME records with every optional part exercised: null uids, weights
    and offsets; id columns that appear late or on some rows only; a shard
    absent from some rows; name/term features."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        ids = {}
        if i % 11:
            ids["userId"] = f"u{rng.integers(25)}"
        if i > n // 3:
            ids["itemId"] = f"i{rng.integers(9)}"
        feats = {"global": [
            {"name": f"g{j}", "term": "t" if j % 3 == 0 else "",
             "value": float(rng.normal())}
            for j in rng.choice(30, size=5, replace=False)]}
        if i % 4:
            feats["userFeatures"] = [
                {"name": "bias", "term": "", "value": 1.0},
                {"name": f"h{rng.integers(4)}", "term": "",
                 "value": float(rng.normal())}]
        rows.append({
            "uid": None if i % 7 == 0 else f"r{i}",
            "response": float(rng.uniform() < 0.4),
            "weight": None if i % 3 else float(rng.uniform(0.5, 2.0)),
            "offset": None if i % 5 else float(rng.normal()),
            "ids": ids,
            "features": feats,
        })
    return rows


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("game_io")
    train, score = str(root / "train.avro"), str(root / "score.avro")
    game_reader.write_game_avro(train, _rows(0))
    extra = _rows(1, 120)
    extra[0]["features"]["global"].append(
        {"name": "BRAND_NEW", "term": "", "value": 9.5})
    extra[1]["features"]["otherShard"] = [
        {"name": "z", "term": "", "value": 1.0}]
    game_reader.write_game_avro(score, extra)
    return train, score


def _assert_reads_equal(a, b):
    shards, ids, resp, wt, off, uids, maps = a
    rshards, rids, rresp, rwt, roff, ruids, rmaps = b
    assert list(shards) == list(rshards)
    for k in shards:
        x, y = shards[k], rshards[k]
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x.indptr, y.indptr)
        np.testing.assert_array_equal(x.indices, y.indices)
        np.testing.assert_array_equal(x.data, y.data)
    assert list(ids) == list(rids)
    for k in ids:
        assert ids[k].tolist() == rids[k].tolist()
    for x, y in ((resp, rresp), (wt, rwt), (off, roff)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert list(uids) == list(ruids)
    assert {k: dict(v) for k, v in maps.items()} == {
        k: dict(v) for k, v in rmaps.items()}


class TestReader:
    def test_writer_matches_reference_bytes(self, tmp_path):
        rows = _rows(2, 60)
        game_reader.write_game_avro(str(tmp_path / "a.avro"), rows)
        ref_reader.write_game_avro(str(tmp_path / "b.avro"), rows)
        assert (tmp_path / "a.avro").read_bytes() == \
            (tmp_path / "b.avro").read_bytes()

    @pytest.mark.parametrize("decoder", ["native", "python"])
    @pytest.mark.parametrize("mode", ["build", "intercept", "scoring"])
    def test_read_matches_reference_exactly(self, files, monkeypatch,
                                            decoder, mode):
        train, score = files
        monkeypatch.setenv("PHOTON_NO_NATIVE",
                           "0" if decoder == "native" else "1")
        if mode == "build":
            got = game_reader.read_game_avro(train)
            want = ref_reader.read_game_avro(train)
        elif mode == "intercept":
            kw = {"add_intercept_shards": ("global", "userFeatures")}
            got = game_reader.read_game_avro(train, **kw)
            want = ref_reader.read_game_avro(train, **kw)
        else:
            maps = game_reader.read_game_avro(train)[6]
            # Unseen features and the unseen shard drop under index_maps.
            got = game_reader.read_game_avro(score, index_maps=maps)
            want = ref_reader.read_game_avro(score, index_maps=maps)
            assert "otherShard" not in got[0]
            assert got[0]["global"].shape[1] == len(maps["global"])
        _assert_reads_equal(got, want)

    def test_native_and_python_decoders_agree(self, files, monkeypatch):
        train, _ = files
        monkeypatch.setenv("PHOTON_NO_NATIVE", "0")
        fast = game_reader.read_game_avro(train)
        monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
        slow = game_reader.read_game_avro(train)
        _assert_reads_equal(fast, slow)

    def test_generic_schema_falls_back(self, tmp_path):
        """A file whose schema is not the GAME layout (here: a field order
        change) decodes record by record, in both packages alike."""
        schema = dict(game_reader.GAME_EXAMPLE_SCHEMA)
        schema["fields"] = list(reversed(schema["fields"]))
        path = str(tmp_path / "generic.avro")
        avro.write_container(path, schema, _rows(3, 50))
        assert not game_reader._is_game_schema(avro.read_schema(path))
        _assert_reads_equal(game_reader.read_game_avro(path),
                            ref_reader.read_game_avro(path))

    def test_native_decoder_builds_in_the_port(self, monkeypatch):
        monkeypatch.setenv("PHOTON_NO_NATIVE", "0")
        lib = native.load_game_decoder()
        if lib is None:
            pytest.skip("no g++ to build the native decoder")
        assert os.path.dirname(lib._name) == str(native.BUILD_DIR)
        assert native.BUILD_DIR.parent.name == "photon_ml_tpu_torch"


def _models(mod_glm, mod_model, to_vec):
    """The same GAME model in either package: a fixed effect with
    variances, a random effect with per-entity variances and an entity
    without coefficients."""
    Coef, GLM = mod_glm
    Fixed, Random, Game = mod_model
    means = np.array([0.5, 0.0, -1.25, 3.0], np.float32)
    var = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    table = {
        "u1": (np.array([0, 2], np.int32), np.array([1.5, -0.25], np.float32)),
        "u2": (np.array([1], np.int32), np.array([2.0], np.float32)),
        "u3": (np.zeros(0, np.int32), np.zeros(0, np.float32)),
    }
    variances = {k: np.full(len(c), 0.5, np.float32)
                 for k, (c, _) in table.items()}
    return Game(models={
        "fixed": Fixed(GLM(Coef(to_vec(means), to_vec(var)), "logistic"),
                       "global"),
        "per_user": Random(coefficients=table, feature_shard="userFeatures",
                           entity_key="userId", task="logistic",
                           n_features=3, variances=variances),
    }, task="logistic")


def _index_maps():
    return {"global": IndexMap.build(["g0", "g1\x01t", "g2", "(INTERCEPT)"]),
            "userFeatures": IndexMap.build(["bias", "h0", "h1"])}


def _assert_models_equal(a, b):
    assert list(a.models) == list(b.models) and a.task == b.task
    fa, fb = a.models["fixed"].model, b.models["fixed"].model
    np.testing.assert_array_equal(np.asarray(fa.coefficients.means),
                                  np.asarray(fb.coefficients.means))
    np.testing.assert_array_equal(np.asarray(fa.coefficients.variances),
                                  np.asarray(fb.coefficients.variances))
    ra, rb = a.models["per_user"], b.models["per_user"]
    assert ra.coefficients.keys() == rb.coefficients.keys()
    for k in ra.coefficients:
        for x, y in zip(ra.coefficients[k], rb.coefficients[k]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    assert (ra.variances is None) == (rb.variances is None)
    for k in ra.variances or {}:
        np.testing.assert_array_equal(ra.variances[k], rb.variances[k])
    assert (ra.n_features, ra.entity_key, ra.feature_shard) == (
        rb.n_features, rb.entity_key, rb.feature_shard)


class TestModelStore:
    def _pair(self):
        port = _models((Coefficients, GeneralizedLinearModel),
                       (FixedEffectModel, RandomEffectModel, GameModel),
                       torch.as_tensor)
        ref = _models((RefCoefficients, RefGLM),
                      (RefFixed, RefRandom, RefGameModel), jnp.asarray)
        return port, ref

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_model_loads_in_the_other_package(self, tmp_path, writer):
        port, ref = self._pair()
        maps = _index_maps()
        d = str(tmp_path / "m")
        if writer == "port":
            game_store.save_game_model(port, maps, d)
            loaded, lmaps = ref_store.load_game_model(d)
            again, _ = game_store.load_game_model(d, device=CPU)
        else:
            ref_store.save_game_model(ref, maps, d)
            loaded, lmaps = game_store.load_game_model(d, device=CPU)
            again, _ = ref_store.load_game_model(d)
        _assert_models_equal(loaded, again)
        _assert_models_equal(loaded, port)
        assert {k: dict(v) for k, v in lmaps.items()} == {
            k: dict(v) for k, v in maps.items()}
        assert game_store.read_fingerprints(d) == \
            ref_store.read_fingerprints(d)

    def test_both_packages_write_the_same_files(self, tmp_path):
        port, ref = self._pair()
        maps = _index_maps()
        game_store.save_game_model(port, maps, str(tmp_path / "p"))
        ref_store.save_game_model(ref, maps, str(tmp_path / "r"))
        for rel in ("metadata.json",
                    "fixed-effect/fixed/coefficients.avro",
                    "fixed-effect/fixed/coefficients.avro.meta.json",
                    "random-effect/per_user/coefficients.avro"):
            assert (tmp_path / "p" / rel).read_bytes() == \
                (tmp_path / "r" / rel).read_bytes(), rel

    def test_tampered_coefficients_refused(self, tmp_path):
        port, _ = self._pair()
        d = tmp_path / "m"
        game_store.save_game_model(port, _index_maps(), str(d))
        meta = json.loads((d / "metadata.json").read_text())
        meta["fingerprints"]["per_user"]["coefficient_checksum"] = "0" * 64
        (d / "metadata.json").write_text(json.dumps(meta))
        with pytest.raises(ValueError, match="checksum mismatch"):
            game_store.load_game_model(str(d), device=CPU)

    def test_nonfinite_coefficients_refused(self, tmp_path):
        port, _ = self._pair()
        port.models["per_user"].coefficients["u2"] = (
            np.array([1], np.int32), np.array([np.nan], np.float32))
        with pytest.raises(ValueError, match="non-finite"):
            game_store.save_game_model(port, _index_maps(),
                                       str(tmp_path / "m"))


def _cd_state(to_arr):
    rng = np.random.default_rng(4)
    return dict(
        iteration=1,
        total=to_arr(rng.normal(size=9).astype(np.float32)),
        scores={"fixed": to_arr(rng.normal(size=9).astype(np.float32)),
                "per_user": to_arr(rng.normal(size=9).astype(np.float32))},
        states={"fixed": to_arr(rng.normal(size=4).astype(np.float32)),
                "per_user": [to_arr(rng.normal(size=(3, 2)).astype(
                    np.float32)), to_arr(np.ones((1, 1), np.float32))]},
        history=[{"iteration": 0, "coordinate": "fixed",
                  "train_metric": 0.75, "validation": {"auc": 0.7}}],
        locked=["per_user"],
    )


def _assert_cd_equal(got, want):
    assert got["iteration"] == want["iteration"]
    assert got["history"] == want["history"]
    assert list(got["locked"]) == list(want["locked"])
    np.testing.assert_array_equal(np.asarray(got["total"]),
                                  np.asarray(want["total"]))
    for k in want["scores"]:
        np.testing.assert_array_equal(np.asarray(got["scores"][k]),
                                      np.asarray(want["scores"][k]))
    np.testing.assert_array_equal(np.asarray(got["states"]["fixed"]),
                                  np.asarray(want["states"]["fixed"]))
    for x, y in zip(got["states"]["per_user"], want["states"]["per_user"]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _grid_configs(mod, Config, Opt, Reg, reg):
    opt = Config(optimizer=Opt(max_iters=40, tolerance=1e-7),
                 regularization=Reg.l2())
    return {
        "fixed": mod.FixedEffectCoordinateConfig(
            feature_shard="global", optimization=opt, reg_weight=reg),
        "per_user": mod.RandomEffectCoordinateConfig(
            feature_shard="userFeatures", entity_key="userId",
            optimization=opt, reg_weight=reg, bucket_growth=4.0),
    }


class TestCheckpoints:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_cd_checkpoint_loads_in_the_other_package(self, tmp_path,
                                                      writer):
        d = str(tmp_path / "ck")
        if writer == "port":
            st = _cd_state(torch.as_tensor)
            checkpoint.CoordinateDescentCheckpointer(d).save(**st)
            got = ref_ckpt.CoordinateDescentCheckpointer(d).load()
        else:
            st = _cd_state(jnp.asarray)
            ref_ckpt.CoordinateDescentCheckpointer(d).save(**st)
            got = checkpoint.CoordinateDescentCheckpointer(d).load()
        _assert_cd_equal(got, st)
        assert checkpoint.CoordinateDescentCheckpointer(d).exists()

    def test_cd_checkpoint_keeps_generations_and_clears(self, tmp_path):
        ck = checkpoint.CoordinateDescentCheckpointer(str(tmp_path))
        st = _cd_state(torch.as_tensor)
        ck.save(**st)
        ck.save(**{**st, "iteration": 2})
        with open(ck.path, "r+b") as f:  # tear the newest generation
            f.truncate(100)
        assert ck.load()["iteration"] == 1
        ck.clear()
        assert ck.load() is None and not ck.exists()

    def test_cd_checkpoint_of_another_padding_generation_refused(
            self, tmp_path):
        ck = checkpoint.CoordinateDescentCheckpointer(str(tmp_path))
        ck.PADDING_GEN = 1  # as if written under the old bucket grid
        ck.save(**_cd_state(torch.as_tensor))
        assert checkpoint.CoordinateDescentCheckpointer(
            str(tmp_path)).load() is None

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_grid_point_loads_in_the_other_package(self, tmp_path, writer):
        port_model = _models((Coefficients, GeneralizedLinearModel),
                             (FixedEffectModel, RandomEffectModel,
                              GameModel), torch.as_tensor)
        ref_model = _models((RefCoefficients, RefGLM),
                            (RefFixed, RefRandom, RefGameModel), jnp.asarray)
        cfg = _grid_configs(estimator, GlmOptimizationConfig,
                            OptimizerConfig, RegularizationContext, 0.5)
        rcfg = _grid_configs(ref_est, RefConfig, RefOpt, RefReg, 0.5)
        port_ck = checkpoint.GameGridCheckpointer(str(tmp_path),
                                                  _index_maps(), device=CPU)
        ref_ck = ref_ckpt.GameGridCheckpointer(str(tmp_path), _index_maps())
        assert port_ck.fingerprint(cfg) == ref_ck.fingerprint(rcfg)
        history = [{"iteration": 0, "validation_metric": 0.8}]
        if writer == "port":
            port_ck.save_point(1, cfg, port_model, 0.8, "validation_metric",
                               history)
            got = ref_ck.load_point(1, rcfg, "validation_metric")
        else:
            ref_ck.save_point(1, rcfg, ref_model, 0.8, "validation_metric",
                              history)
            got = port_ck.load_point(1, cfg, "validation_metric")
        model, metric, hist = got
        _assert_models_equal(model, port_model)
        assert metric == 0.8 and hist == history
        # Another config, another metric kind or another point: no match.
        other = _grid_configs(estimator, GlmOptimizationConfig,
                              OptimizerConfig, RegularizationContext, 1.0)
        assert port_ck.load_point(1, other, "validation_metric") is None
        assert port_ck.load_point(1, cfg, "train_metric") is None
        assert port_ck.load_point(0, cfg, "validation_metric") is None
        port_ck.clear()
        assert port_ck.load_point(1, cfg, "validation_metric") is None


class TestScoringWriterAndIndexMaps:
    def test_scoring_container_matches_reference_bytes(self, tmp_path,
                                                       monkeypatch):
        rng = np.random.default_rng(5)
        n = 300
        uids = [None if i % 9 == 0 else f"r{i}" for i in range(n)]
        scores = rng.normal(size=n).astype(np.float32)
        labels = (rng.uniform(size=n) < 0.5).astype(np.float32)
        ids = {"itemId": np.array([None if i % 4 else f"i{i}"
                                   for i in range(n)], object),
               "userId": np.array([f"u{i % 7}" for i in range(n)], object)}
        got = avro.write_scoring_container(
            str(tmp_path / "a.avro"), uids, scores.tolist(),
            labels.tolist(), ids, records_per_block=64)
        # The reference's pure-Python body (its native encoder writes the
        # same bytes, by its own parity test), the columns as one block.
        monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
        want = ref_avro.write_scoring_container(
            str(tmp_path / "b.avro"), [(uids, scores, labels, ids)],
            records_per_block=64)
        assert got == want == n
        assert (tmp_path / "a.avro").read_bytes() == \
            (tmp_path / "b.avro").read_bytes()
        _, recs = avro.read_container(str(tmp_path / "a.avro"))
        assert recs[1]["ids"] == {"userId": "u1"}
        assert recs[4]["ids"] == {"itemId": "i4", "userId": "u4"}
        assert recs[150]["label"] == float(labels[150])
        with pytest.raises(ValueError, match="do not match"):
            avro.write_scoring_container(str(tmp_path / "c.avro"),
                                         uids[:3], scores[:3], labels[:2],
                                         {})

    def test_binary_index_map_loads_in_the_other_package(self, tmp_path):
        imap = IndexMap.build([f"f{i}\x01t{i % 3}" for i in range(200)])
        imap.save_binary(str(tmp_path / "p"))
        from photon_ml_tpu.data.index_map import IndexMap as RefIndexMap

        RefIndexMap(dict(imap)).save_binary(str(tmp_path / "r"))
        for d in ("p", "r"):
            for reader in (BinaryIndexMap, RefBinaryIndexMap):
                bm = reader(str(tmp_path / d))
                assert len(bm) == 200
                assert all(bm.get_index(k) == v for k, v in imap.items())
                assert bm.get_index("missing") == -1


_ALL_TYPES = {
    "type": "record", "name": "AllTypes", "fields": [
        {"name": "flag", "type": "boolean"},
        {"name": "count", "type": "long"},
        {"name": "small", "type": "int"},
        {"name": "ratio", "type": "float"},
        {"name": "blob", "type": "bytes"},
        {"name": "color", "type": {"type": "enum", "name": "Color",
                                   "symbols": ["RED", "GREEN", "BLUE"]}},
        {"name": "tags", "type": {"type": "map", "values": "long"}},
        {"name": "either", "type": ["null", "string", "long", "double"]},
        {"name": "nested", "type": {"type": "array", "items": {
            "type": "record", "name": "Inner", "fields": [
                {"name": "x", "type": ["null", "double"]},
                {"name": "s", "type": "string"}]}}},
    ]}


def _random_datum(schema, rng):
    if isinstance(schema, list):
        return _random_datum(schema[int(rng.integers(len(schema)))], rng)
    s = {"type": schema} if isinstance(schema, str) else schema
    t = s["type"]
    if t == "null":
        return None
    if t == "boolean":
        return bool(rng.integers(2))
    if t in ("int", "long"):
        return int(rng.integers(-2**40, 2**40)) >> int(rng.integers(41))
    if t == "float":
        return float(np.float32(rng.normal()))
    if t == "double":
        return float(rng.normal() * 10.0 ** int(rng.integers(-5, 6)))
    if t == "bytes":
        return rng.bytes(int(rng.integers(0, 300)))
    if t == "string":
        return "".join(rng.choice(list("abcé€\x01 ")) for _ in
                       range(int(rng.integers(0, 200))))
    if t == "enum":
        return s["symbols"][int(rng.integers(len(s["symbols"])))]
    if t == "record":
        return {f["name"]: _random_datum(f["type"], rng) for f in s["fields"]}
    if t == "array":
        return [_random_datum(s["items"], rng)
                for _ in range(int(rng.integers(0, 4)))]
    if t == "map":
        return {f"k{i}": _random_datum(s["values"], rng)
                for i in range(int(rng.integers(0, 4)))}
    raise AssertionError(t)


class TestScoringEncoder:
    """The native score encoder (``native/score_encoder.cpp``): the native
    path, the columnar Python path (``PHOTON_NO_NATIVE=1``), the record
    path and the reference's file are byte-equal (the reference's
    ``TestScoringContainerWriter``)."""

    @staticmethod
    def _data(n=3000, seed=0):
        rng = np.random.default_rng(seed)
        uids = [None if i % 17 == 0 else f"row{i}" for i in range(n)]
        scores = rng.normal(size=n).astype(np.float32)
        labels = [None if i % 23 == 0 else float(i % 2) for i in range(n)]
        ids = {"songId": [None if i % 5 == 0 else f"s{i % 41}"
                          for i in range(n)],
               "userId": [f"u{i % 97}" for i in range(n)]}
        return uids, scores, labels, ids

    @staticmethod
    def _blocks(uids, scores, labels, ids, cut=1234):
        # An uneven cut: the writer re-chunks to records_per_block, so the
        # bytes do not depend on the input blocking.
        ids = {k: ids[k] for k in sorted(ids)}
        return [(uids[:cut], scores[:cut], labels[:cut],
                 {k: v[:cut] for k, v in ids.items()}),
                (uids[cut:], scores[cut:], labels[cut:],
                 {k: v[cut:] for k, v in ids.items()})]

    def _write(self, path, blocks, no_native, monkeypatch):
        if no_native:
            monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("PHOTON_NO_NATIVE", raising=False)
        stats = {}
        n = avro.write_scoring_blocks(str(path), blocks, stats=stats)
        return n, stats["encoder"]

    def test_native_python_record_and_reference_bytes(self, tmp_path,
                                                      monkeypatch):
        from photon_ml_tpu.io.schemas import SCORING_RESULT

        assert native.load_score_encoder() is not None, "g++ builds it here"
        uids, scores, labels, ids = self._data()
        blocks = self._blocks(uids, scores, labels, ids)
        n_nat, enc_nat = self._write(tmp_path / "nat.avro", blocks, False,
                                     monkeypatch)
        n_py, enc_py = self._write(tmp_path / "py.avro", blocks, True,
                                   monkeypatch)
        assert n_nat == n_py == len(scores)
        assert (enc_nat, enc_py) == ("native", "python")
        records = [{"uid": uids[i], "predictionScore": float(scores[i]),
                    "label": labels[i],
                    "ids": {k: str(ids[k][i]) for k in sorted(ids)
                            if ids[k][i] is not None}}
                   for i in range(len(scores))]
        avro.write_container(str(tmp_path / "rec.avro"), SCORING_RESULT,
                             records)
        # The reference's writer with its own native encoder.
        monkeypatch.delenv("PHOTON_NO_NATIVE", raising=False)
        ref_avro.write_scoring_container(str(tmp_path / "ref.avro"), blocks)
        nat = (tmp_path / "nat.avro").read_bytes()
        for other in ("py", "rec", "ref"):
            assert (tmp_path / f"{other}.avro").read_bytes() == nat, other

    def test_no_native_env_forces_python(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
        assert native.load_score_encoder() is None
        uids, scores, labels, ids = self._data(n=50)
        stats = {}
        avro.write_scoring_blocks(str(tmp_path / "a.avro"),
                                  self._blocks(uids, scores, labels, ids, 20),
                                  stats=stats)
        assert stats["encoder"] == "python"

    def test_small_first_capacity_retries(self, tmp_path, monkeypatch):
        """Long uids overflow the first buffer guess; the encoder reports
        the size it needs and the second call writes the same bytes."""
        monkeypatch.delenv("PHOTON_NO_NATIVE", raising=False)
        lib = native.load_score_encoder()
        uids = ["x" * 5000, None, "y" * 3]
        body = avro._encode_scoring_block_native(
            lib, uids, [0.5, -1.0, 2.0], [1.0, None, 0.0],
            {"k": ["a" * 4000, None, "b"]})
        monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
        stats = {}
        avro.write_scoring_blocks(
            str(tmp_path / "py.avro"),
            [(uids, [0.5, -1.0, 2.0], [1.0, None, 0.0],
              {"k": ["a" * 4000, None, "b"]})], codec="null", stats=stats)
        assert stats["encoder"] == "python"
        assert body is not None and body in (tmp_path / "py.avro").read_bytes()


class TestCompiledCodec:
    """The containers' compiled codecs write and read what the schema walk
    (``write_datum`` / ``read_datum``) does, byte for byte."""

    @pytest.mark.parametrize("name", [
        "BAYESIAN_LINEAR_MODEL", "SCORING_RESULT", "FEATURE_SUMMARY",
        "RANDOM_EFFECT_MODEL_SCHEMA", "GAME_EXAMPLE_SCHEMA", "all types"])
    def test_same_bytes_and_records_as_the_schema_walk(self, name, tmp_path):
        import io as _io

        from photon_ml_tpu_torch.io import schemas

        schema = {"all types": _ALL_TYPES,
                  "RANDOM_EFFECT_MODEL_SCHEMA":
                      game_store.RANDOM_EFFECT_MODEL_SCHEMA,
                  "GAME_EXAMPLE_SCHEMA": game_reader.GAME_EXAMPLE_SCHEMA,
                  }.get(name) or getattr(schemas, name)
        rng = np.random.default_rng(11)
        data = [_random_datum(schema, rng) for _ in range(300)]
        walked = _io.BytesIO()
        for d in data:
            avro.write_datum(walked, schema, d)
        parts = []
        enc = avro._compile_writer(schema)
        for d in data:
            enc(parts.append, d)
        assert b"".join(parts) == walked.getvalue()
        avro.write_container(str(tmp_path / "c.avro"), schema, data,
                             records_per_block=64)
        _, got = avro.read_container(str(tmp_path / "c.avro"))
        body = _io.BytesIO(walked.getvalue())
        assert got == [avro.read_datum(body, schema) for _ in data] == data
        assert list(avro.iter_container(str(tmp_path / "c.avro"))) == data

    @pytest.mark.parametrize("bad", [
        {"flag": True},                                   # missing field
        dict(_random_datum(_ALL_TYPES, np.random.default_rng(1)),
             either=[1]),                                 # no union branch
        dict(_random_datum(_ALL_TYPES, np.random.default_rng(2)),
             nested=[{"x": "s", "s": "t"}]),              # nested union
    ])
    def test_same_errors_as_the_schema_walk(self, bad):
        import io as _io

        with pytest.raises(TypeError) as walked:
            avro.write_datum(_io.BytesIO(), _ALL_TYPES, bad)
        with pytest.raises(TypeError) as compiled:
            avro._compile_writer(_ALL_TYPES)([].append, bad)
        assert str(compiled.value) == str(walked.value)

    def test_truncated_payload_raises_eof(self):
        enc = avro._compile_writer(_ALL_TYPES)
        parts = []
        enc(parts.append, _random_datum(_ALL_TYPES, np.random.default_rng(3)))
        payload = b"".join(parts)
        dec = avro._compile_reader(_ALL_TYPES)
        assert dec(payload, 0)[1] == len(payload)
        with pytest.raises((EOFError, IndexError, struct.error)):
            dec(payload[:len(payload) // 2], 0)
