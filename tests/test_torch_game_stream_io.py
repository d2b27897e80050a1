"""The port's bounded-block GAME reader, block-iterable scoring writer and
streamed scoring driver against the JAX package's, on the CPU.

Mirrors ``tests/test_game_drivers.py``'s streamed-scoring cases:
``iter_game_avro`` yields exactly the reference's blocks (with the native
and the Python decoder), at container-block boundaries, with id-less
blocks and dropped features; ``write_scoring_blocks`` writes the
reference's bytes for the same blocks; and ``game_scoring_driver
--stream-block-rows`` writes a scores file byte-equal to the reference's
streamed file and to the port's whole-file run, with the same metrics.
"""

import os
import sys

import numpy as np
import pytest

from photon_ml_tpu.data.game_reader import iter_game_avro as ref_iter
from photon_ml_tpu.drivers import game_scoring_driver as ref_scoring
from photon_ml_tpu.drivers import game_training_driver as ref_training
from photon_ml_tpu.io import avro as ref_avro
from photon_ml_tpu_torch.data.game_reader import (
    GAME_EXAMPLE_SCHEMA,
    iter_game_avro,
    read_game_avro,
    write_game_avro,
)
from photon_ml_tpu_torch.drivers import game_scoring_driver
from photon_ml_tpu_torch.io import avro

sys.path.insert(0, os.path.dirname(__file__))
from test_game_drivers import _make_game_rows  # noqa: E402
from test_torch_game_drivers import _write_config  # noqa: E402
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = ("--device", "cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """600 train rows; a validation file re-cut into 32-record container
    blocks behind 64 id-less rows (one whole streamed block without the
    entity column), with a feature the index maps never saw; and the
    reference's trained model."""
    root = tmp_path_factory.mktemp("stream_io")
    rng = np.random.default_rng(11)
    user_effect = {f"u{u}": rng.normal(scale=2.0) for u in range(20)}
    train = str(root / "train.avro")
    write_game_avro(train, _make_game_rows(rng, user_effect, 600))
    recs = _make_game_rows(rng, user_effect, 200, uid_start=600)
    recs[5]["features"]["global"].append(
        {"name": "never_seen", "term": "", "value": 3.0})
    idless = [{"uid": f"noid{i}", "response": float(i % 2), "weight": None,
               "offset": None, "ids": {},
               "features": {"global": [
                   {"name": "g0", "term": "", "value": 1.0}]}}
              for i in range(64)]
    mixed = str(root / "mixed.avro")
    avro.write_container(mixed, GAME_EXAMPLE_SCHEMA, idless + recs,
                         records_per_block=32)
    model = str(root / "model")
    ref_training.run(["--train-data", train, "--config",
                      _write_config(root / "c.json"), "--output-dir", model])
    return train, mixed, model


def _same_blocks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g[0]) == sorted(w[0])
        for shard in w[0]:
            assert g[0][shard].shape == w[0][shard].shape
            np.testing.assert_array_equal(g[0][shard].toarray(),
                                          w[0][shard].toarray())
        assert list(g[1]) == list(w[1])
        for k in w[1]:
            assert list(g[1][k]) == list(w[1][k])
        for i in (2, 3, 4):
            np.testing.assert_array_equal(g[i], w[i])
        assert list(g[5]) == list(w[5])


@pytest.mark.parametrize("decoder", ["native", "python"])
@pytest.mark.parametrize("case", ["one_container_block", "recut_idless"])
def test_iter_game_avro_yields_the_reference_blocks(files, monkeypatch,
                                                    decoder, case):
    train, mixed, _ = files
    if decoder == "python":
        monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
    *_, imaps = read_game_avro(train)
    path = train if case == "one_container_block" else mixed
    stats = {}
    got = list(iter_game_avro(path, imaps, block_rows=64, stats=stats,
                              id_keys=("userId",)))
    want = list(ref_iter(path, {s: dict(m) for s, m in imaps.items()},
                         block_rows=64, id_keys=("userId",)))
    _same_blocks(got, want)
    if decoder == "python":
        assert stats["decoder"] == "python"
    if case == "one_container_block":
        # 600 rows in one 4096-record container block: one yield.
        assert len(got) == 1 and len(got[0][2]) == 600
    else:
        # Flushes at 32-record container boundaries once 64 rows are in:
        # the first block is the 64 id-less rows, its userId all None.
        assert [len(b[2]) for b in got] == [64] * 4 + [8]
        assert list(got[0][1]["userId"]) == [None] * 64
        assert all(b[0]["global"].shape[1] == len(imaps["global"])
                   for b in got)
        assert all(b[0]["userFeatures"].shape[0] == len(b[2]) for b in got)


def test_iter_game_avro_drops_unseen_features_and_needs_maps(files, caplog):
    train, mixed, _ = files
    *_, imaps = read_game_avro(train)
    with caplog.at_level("WARNING"):
        blocks = list(iter_game_avro(mixed, imaps, block_rows=64))
    assert "dropped features" in caplog.text and "global=1" in caplog.text
    full = read_game_avro(mixed, index_maps=imaps)
    np.testing.assert_array_equal(
        np.concatenate([b[0]["global"].toarray() for b in blocks]),
        full[0]["global"].toarray())
    with pytest.raises(ValueError, match="index maps"):
        list(iter_game_avro(train, None))


def test_scoring_blocks_writer_matches_reference_bytes(tmp_path,
                                                       monkeypatch):
    """Blocks whose id columns come and go (a column new in block 2,
    absent in block 3), cut across container blocks."""
    rng = np.random.default_rng(5)
    blocks = []
    for b, keys in enumerate((["userId"], ["itemId", "userId"], ["userId"])):
        n = 70 + 13 * b
        ids = {k: np.array([None if (i + b) % 5 == 0 else f"{k[0]}{i}"
                            for i in range(n)], object) for k in keys}
        blocks.append(([f"r{b}_{i}" if i % 7 else None for i in range(n)],
                       rng.normal(size=n).astype(np.float32),
                       (rng.uniform(size=n) < 0.5).astype(np.float32), ids))
    got = avro.write_scoring_blocks(str(tmp_path / "a.avro"), iter(blocks),
                                    records_per_block=64)
    monkeypatch.setenv("PHOTON_NO_NATIVE", "1")
    want = ref_avro.write_scoring_container(str(tmp_path / "b.avro"),
                                            iter(blocks),
                                            records_per_block=64)
    assert got == want == sum(len(b[1]) for b in blocks)
    assert (tmp_path / "a.avro").read_bytes() == \
        (tmp_path / "b.avro").read_bytes()


@pytest.mark.parametrize("evaluator,device_metrics", [
    ("auc", False), ("logistic_loss", True)])
def test_streamed_scoring_driver_matches_the_reference(
        files, tmp_path, evaluator, device_metrics):
    """The same model scored block by block by both packages, and whole by
    the port: the scores files are byte-equal, the metrics equal (the
    pointwise device metric from per-block partials within 1e-6)."""
    _, mixed, model = files
    flags = ["--evaluator", evaluator] + (
        ["--device-metrics"] if device_metrics else [])

    def run(mod, out, *extra):
        return mod.run(["--data", mixed, "--model-dir", model,
                        "--output-dir", str(tmp_path / out), *flags, *extra])

    streamed = run(game_scoring_driver, "port_s", "--stream-block-rows",
                   "64", *CPU)
    whole = run(game_scoring_driver, "port_w", *CPU)
    ref = run(ref_scoring, "ref_s", "--stream-block-rows", "64")
    assert streamed["n_rows"] == whole["n_rows"] == ref["n_rows"] == 264
    data = {k: (tmp_path / k / "scores.avro").read_bytes()
            for k in ("port_s", "port_w", "ref_s")}
    assert data["port_s"] == data["ref_s"] == data["port_w"]
    assert streamed["metric"] == pytest.approx(whole["metric"], abs=1e-6)
    assert streamed["metric"] == pytest.approx(ref["metric"], abs=1e-6)
    if evaluator == "auc":
        assert streamed["metric"] == whole["metric"]
    assert set(streamed["stage_seconds"]) >= {"model load", "read",
                                              "transform", "write"}
