"""The port's GAME drivers (training, scoring, feature indexing) against the
JAX package's, on the CPU (``--device cpu``), on the same GAME Avro files.

These are the reference's own driver flows (``tests/test_game_drivers.py``,
``tests/test_game_grid.py::TestDriverGrid``,
``tests/test_checkpoint.py::TestDriverResume``) run through both packages.
Metrics of whole fits agree within 2e-3 (the fixed effect's float32 L-BFGS
stops on its value's noise floor; ``test_torch_game.py``), the same grid
point wins, and a model written by either package scores the same in the
other.  Inside the port, a killed and resumed run is bitwise equal to the
uninterrupted one, and the scoring driver's metric equals the training
driver's validation metric within 1e-6.
"""

import json
import os
import sys

import numpy as np
import pytest

from photon_ml_tpu.drivers import feature_indexing_driver as ref_fi
from photon_ml_tpu.drivers import game_scoring_driver as ref_scoring
from photon_ml_tpu.drivers import game_training_driver as ref_training
from photon_ml_tpu.io import checkpoint as ref_ckpt
from photon_ml_tpu.io.game_store import load_game_model as ref_load
from photon_ml_tpu_torch.data.game_reader import (
    read_game_avro,
    write_game_avro,
)
from photon_ml_tpu_torch.data.index_map import BinaryIndexMap, IndexMap
from photon_ml_tpu_torch.drivers import (
    feature_indexing_driver,
    game_scoring_driver,
    game_training_driver,
)
from photon_ml_tpu_torch.game.estimator import GameTransformer
from photon_ml_tpu_torch.io import avro, checkpoint
from photon_ml_tpu_torch.io.game_store import load_game_model, save_game_model
from photon_ml_tpu_torch.native import load_game_decoder, load_score_encoder

sys.path.insert(0, os.path.dirname(__file__))
from test_game_drivers import _make_game_rows  # noqa: E402
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = ("--device", "cpu")
FIT_TOL = 2e-3

#: The decoder read_game_avro runs on GAME files here.
DECODER = "native" if load_game_decoder() is not None else "python"
ENCODER = "native" if load_score_encoder() is not None else "python"

COORDS = [
    {"name": "fixed", "type": "fixed", "feature_shard": "global",
     "optimizer": "lbfgs", "max_iters": 50, "reg_type": "l2",
     "reg_weight": 0.5},
    {"name": "per_user", "type": "random",
     "feature_shard": "userFeatures", "entity_key": "userId",
     "optimizer": "lbfgs", "max_iters": 30, "reg_type": "l2",
     "reg_weight": 0.5},
]


def _write_config(path, **overrides):
    config = {"task": "logistic", "iterations": 2, "evaluator": "auc",
              "coordinates": COORDS, **overrides}
    with open(path, "w") as f:
        json.dump(config, f)
    return str(path)


@pytest.fixture(scope="module")
def game_files(tmp_path_factory):
    """The reference test module's files: 600 train and 200 validation rows
    over one population of 20 per-user effects."""
    root = tmp_path_factory.mktemp("game_drivers")
    rng = np.random.default_rng(11)
    user_effect = {f"u{u}": rng.normal(scale=2.0) for u in range(20)}
    train, val = str(root / "train.avro"), str(root / "val.avro")
    write_game_avro(train, _make_game_rows(rng, user_effect, 600))
    write_game_avro(val, _make_game_rows(rng, user_effect, 200,
                                         uid_start=600))
    return train, val, _write_config(root / "config.json")


@pytest.fixture(scope="module")
def trained(game_files, tmp_path_factory):
    """Both packages' training drivers on the same files, with validation."""
    train, val, config = game_files
    root = tmp_path_factory.mktemp("trained")
    args = ["--train-data", train, "--validate-data", val, "--config",
            config]
    port = game_training_driver.run(args + ["--output-dir",
                                            str(root / "port"), *CPU])
    ref = ref_training.run(args + ["--output-dir", str(root / "ref")])
    return root, port, ref


def _scores(model_dir, data_path, ref=False):
    """Scores of ``data_path`` under the model saved in ``model_dir``,
    loaded and scored by the port (or by the reference)."""
    path = os.path.join(model_dir, "models")
    if ref:
        from photon_ml_tpu.game.estimator import (
            GameTransformer as RefTransformer,
        )

        model, imaps = ref_load(path)
        shards, ids, *_ = read_game_avro(data_path, index_maps=imaps)
        return RefTransformer(model).transform(shards, ids)
    model, imaps = load_game_model(path, device="cpu")
    shards, ids, *_ = read_game_avro(data_path, index_maps=imaps)
    return GameTransformer(model).transform(shards, ids)


class TestGameDrivers:
    def test_train_then_score_roundtrip(self, game_files, trained,
                                        tmp_path):
        train, val, _ = game_files
        root, result, ref = trained
        assert result["train_metric"] > 0.70
        assert result["validation_metric"] > 0.65
        for key in ("train_metric", "validation_metric"):
            assert result[key] == pytest.approx(ref[key], abs=FIT_TOL)
        assert set(result) >= {"task", "n_rows", "history", "train_metric",
                               "per_iteration_validation",
                               "validation_suite", "validation_metric",
                               "wall_seconds"}
        # The port adds its stage times and the decoder of each file.
        assert set(result) == set(ref) | {"stage_seconds", "decoders"}
        assert result["decoders"] == {"train": DECODER,
                                      "validation": DECODER}
        assert {"read train", "read validation", "fit", "model save",
                "fixed-effect dataset build", "random-effect bucket build",
                "validation scorer build", "descent", "train metric",
                "validation scoring and metrics",
                "final validation transform and metric"} == \
            set(result["stage_seconds"])
        assert len(result["stage_seconds"]["validation scoring and "
                                           "metrics"]) == \
            len(result["history"])
        assert [(h["iteration"], h["coordinate"]) for h in
                result["history"]] == [(h["iteration"], h["coordinate"])
                                       for h in ref["history"]]
        # The random effect helps: the final update beats the first.
        assert result["history"][-1]["validation_metric"] > \
            result["history"][0]["validation_metric"]
        with open(root / "port" / "training_result.json") as f:
            assert json.load(f)["validation_metric"] == \
                result["validation_metric"]

        out = str(tmp_path / "score_out")
        sresult = game_scoring_driver.run([
            "--data", val, "--model-dir", str(root / "port"),
            "--output-dir", out, "--evaluator", "auc", *CPU])
        assert sresult["n_rows"] == 200
        assert sresult["metric"] == pytest.approx(
            result["validation_metric"], abs=1e-6)
        _, scores = avro.read_container(os.path.join(out, "scores.avro"))
        assert len(scores) == 200
        # The reference's scoring driver on the port's model writes the
        # same file.
        ref_out = str(tmp_path / "ref_score_out")
        rresult = ref_scoring.run([
            "--data", val, "--model-dir", str(root / "port"),
            "--output-dir", ref_out, "--evaluator", "auc"])
        assert rresult["metric"] == sresult["metric"]
        assert set(sresult) == set(rresult) | {"stage_seconds", "decoder",
                                               "encoder"}
        assert sresult["decoder"] == DECODER
        assert sresult["encoder"] == ENCODER
        assert set(sresult["stage_seconds"]) == {"model load", "read",
                                                 "transform", "write",
                                                 "metric"}
        assert open(os.path.join(out, "scores.avro"), "rb").read() == \
            open(os.path.join(ref_out, "scores.avro"), "rb").read()
        # And the port's scoring of the reference's model agrees with the
        # reference's own validation metric.
        xresult = game_scoring_driver.run([
            "--data", val, "--model-dir", str(root / "ref"),
            "--output-dir", str(tmp_path / "x"), "--evaluator", "auc",
            *CPU])
        assert xresult["metric"] == pytest.approx(ref["validation_metric"],
                                                  abs=1e-6)

    def test_scoring_mean_and_device_metrics(self, game_files, trained,
                                             tmp_path):
        _, val, _ = game_files
        root, result, _ = trained
        common = ["--data", val, "--model-dir", str(root / "port"), *CPU]
        host = game_scoring_driver.run(common + [
            "--output-dir", str(tmp_path / "h"), "--evaluator", "auc"])
        dev = game_scoring_driver.run(common + [
            "--output-dir", str(tmp_path / "d"), "--evaluator", "auc",
            "--device-metrics"])
        assert dev["metric"] == pytest.approx(host["metric"], abs=1e-6)
        loss = game_scoring_driver.run(common + [
            "--output-dir", str(tmp_path / "l"), "--evaluator",
            "logistic_loss", "--device-metrics"])
        ref_loss = ref_scoring.run([
            "--data", val, "--model-dir", str(root / "port"),
            "--output-dir", str(tmp_path / "rl"), "--evaluator",
            "logistic_loss"])
        assert loss["metric"] == pytest.approx(ref_loss["metric"], rel=2e-5)
        game_scoring_driver.run(common + ["--output-dir",
                                          str(tmp_path / "m"), "--mean"])
        ref_scoring.run(["--data", val, "--model-dir", str(root / "port"),
                         "--output-dir", str(tmp_path / "rm"), "--mean"])
        _, got = avro.read_container(str(tmp_path / "m" / "scores.avro"))
        _, want = avro.read_container(str(tmp_path / "rm" / "scores.avro"))
        p = np.array([r["predictionScore"] for r in got])
        q = np.array([r["predictionScore"] for r in want])
        assert np.all((p > 0) & (p < 1))
        np.testing.assert_allclose(p, q, rtol=1e-6, atol=1e-7)

    def test_device_metrics_training(self, game_files, trained, tmp_path):
        train, val, config = game_files
        _, host, _ = trained
        dev = game_training_driver.run([
            "--train-data", train, "--validate-data", val, "--config",
            config, "--output-dir", str(tmp_path / "dev"),
            "--device-metrics", *CPU])
        assert dev["validation_metric"] == pytest.approx(
            host["validation_metric"], abs=1e-6)
        for h, d in zip(host["history"], dev["history"]):
            assert d["validation_metric"] == pytest.approx(
                h["validation_metric"], abs=1e-6)

    def test_pipeline_coordinates_is_bitwise_serial(self, game_files,
                                                    trained, tmp_path):
        train, val, config = game_files
        root, result, _ = trained
        piped = game_training_driver.run([
            "--train-data", train, "--validate-data", val, "--config",
            config, "--output-dir", str(tmp_path / "piped"),
            "--pipeline-coordinates", *CPU])
        assert piped["validation_metric"] == result["validation_metric"]
        for rel in ("fixed-effect/fixed/coefficients.avro",
                    "random-effect/per_user/coefficients.avro"):
            assert (tmp_path / "piped" / "models" / rel).read_bytes() == \
                (root / "port" / "models" / rel).read_bytes()

    def test_model_store_roundtrip_preserves_scores(self, game_files,
                                                    trained, tmp_path):
        _, val, _ = game_files
        root, _, _ = trained
        model, imaps = load_game_model(str(root / "port" / "models"),
                                       device="cpu")
        resaved = str(tmp_path / "resaved")
        save_game_model(model, imaps, resaved)
        model2, _ = load_game_model(resaved, device="cpu")
        shards, ids, *_ = read_game_avro(val, index_maps=imaps)
        s1 = GameTransformer(model).transform(shards, ids)
        s2 = GameTransformer(model2).transform(shards, ids)
        np.testing.assert_array_equal(s1, s2)
        # Each package's model scores alike (within the fit tolerance).
        np.testing.assert_allclose(
            _scores(str(root / "port"), val),
            _scores(str(root / "ref"), val, ref=True),
            atol=FIT_TOL * 10)

    def test_feature_summaries_match_reference(self, game_files, tmp_path):
        from photon_ml_tpu_torch.io.summary_store import load_feature_summary

        train, _, _ = game_files
        cfg = _write_config(tmp_path / "c.json", iterations=1,
                            feature_summaries=True)
        args = ["--train-data", train, "--config", cfg]
        game_training_driver.run(args + ["--output-dir",
                                         str(tmp_path / "p"), *CPU])
        ref_training.run(args + ["--output-dir", str(tmp_path / "r")])
        for shard in ("global", "userFeatures"):
            rel = os.path.join("feature-summaries", f"{shard}.avro")
            got = load_feature_summary(str(tmp_path / "p" / rel))
            want = load_feature_summary(str(tmp_path / "r" / rel))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    assert g[k] == pytest.approx(w[k], rel=1e-12, abs=1e-12)

    def test_feature_indexing_driver(self, game_files, tmp_path):
        train, _, _ = game_files
        for add_intercept in (False, True):
            flags = ["--binary"] + (["--add-intercept"] if add_intercept
                                    else [])
            out, ref_out = str(tmp_path / "p"), str(tmp_path / "r")
            result = feature_indexing_driver.run(
                ["--data", train, "--output-dir", out, *flags])
            ref = ref_fi.run(["--data", train, "--output-dir", ref_out,
                              *flags])
            assert result == ref
            assert result["shards"]["global"] == 3 + add_intercept
            for shard in result["shards"]:
                imap = IndexMap.load(os.path.join(out, shard))
                assert dict(imap) == dict(IndexMap.load(
                    os.path.join(ref_out, shard)))
                bmap = BinaryIndexMap(os.path.join(out, shard))
                assert all(bmap.get_index(k) == v for k, v in imap.items())


def test_make_fit_once_matches_reference(game_files):
    """The tuning entry: one fit per (reg weights, iteration budget),
    evaluated on the validation data, against the reference's."""
    train, val, config = game_files
    with open(config) as f:
        specs = json.load(f)["coordinates"]
    data = read_game_avro(train)
    v = read_game_avro(val, index_maps=data[6])
    fits = []
    for mod in (game_training_driver, ref_training):
        configs = mod.expand_config_grid(specs)[0]
        fits.append(mod.make_fit_once(
            "logistic", configs, data[0], data[1], data[2], v[:5],
            **({"device": "cpu"} if mod is game_training_driver else {})))
    port, ref = fits
    assert port.names == ref.names == ["fixed", "per_user"]
    assert port.larger_is_better and ref.larger_is_better
    for params, resource in (([0.5, 0.5], 1), ([2.0, 0.1], 2),
                             ([0.5, 0.5], 1)):
        m, all_m, _ = port(params, resource)
        rm, rall, _ = ref(params, resource)
        assert m == pytest.approx(rm, abs=FIT_TOL)
        assert all_m.keys() == rall.keys()


class TestTuningMode:
    """The training driver's tuning mode (the reference's
    ``test_bayesian_tuning_mode`` and its no-validation case), through both
    packages on the same files."""

    @staticmethod
    def _config(game_files, tmp_path, tuning, name="tuned.json"):
        with open(game_files[2]) as f:
            cfg = json.load(f)
        cfg["tuning"] = tuning
        cfg["iterations"] = 1
        path = str(tmp_path / name)
        with open(path, "w") as f:
            json.dump(cfg, f)
        return path

    def test_bayesian_tuning_mode_matches_reference(self, game_files,
                                                    tmp_path):
        train, val, _ = game_files
        cfg = self._config(game_files, tmp_path, {
            "mode": "bayesian", "iterations": 5, "range": [1e-2, 1e2]})
        args = ["--train-data", train, "--validate-data", val, "--config",
                cfg]
        port = game_training_driver.run(
            args + ["--output-dir", str(tmp_path / "port"), *CPU])
        ref = ref_training.run(args + ["--output-dir", str(tmp_path / "ref")])
        tun = port["tuning"]
        assert tun["n_evaluations"] == 5
        assert set(tun["best_reg_weights"]) == {"fixed", "per_user"}
        # The final fit used the tuned weights and reached the tuned metric.
        assert port["validation_metric"] == pytest.approx(
            tun["best_metric"], abs=1e-6)
        for nm, w in ref["tuning"]["best_reg_weights"].items():
            assert tun["best_reg_weights"][nm] == pytest.approx(w, rel=1e-6)
        assert tun["best_metric"] == pytest.approx(
            ref["tuning"]["best_metric"], abs=1e-6)
        with open(tmp_path / "port" / "training_result.json") as f:
            assert json.load(f)["tuning"] == tun

    def test_random_mode(self, game_files, tmp_path):
        train, val, _ = game_files
        cfg = self._config(game_files, tmp_path, {
            "mode": "random", "iterations": 3, "range": [1e-2, 1e2]})
        port = game_training_driver.run([
            "--train-data", train, "--validate-data", val, "--config", cfg,
            "--output-dir", str(tmp_path / "o"), *CPU])
        assert port["tuning"]["n_evaluations"] == 3
        assert port["validation_metric"] == pytest.approx(
            port["tuning"]["best_metric"], abs=1e-6)

    def test_tuning_without_validation_fails_cleanly(self, game_files,
                                                     tmp_path):
        train, _, _ = game_files
        cfg = self._config(game_files, tmp_path, {"iterations": 2})
        with pytest.raises(ValueError, match="requires --validate-data"):
            game_training_driver.run([
                "--train-data", train, "--config", cfg,
                "--output-dir", str(tmp_path / "x"), *CPU])

    def test_tuning_refuses_locked_coordinates(self, game_files, trained,
                                               tmp_path):
        train, val, _ = game_files
        root = trained[0]
        cfg = self._config(game_files, tmp_path, {"iterations": 2})
        with pytest.raises(SystemExit, match="incompatible with tuning"):
            game_training_driver.run([
                "--train-data", train, "--validate-data", val,
                "--config", cfg, "--output-dir", str(tmp_path / "x"),
                "--initial-model", str(root / "port" / "models"),
                "--locked-coordinates", "fixed", *CPU])


class TestPartialRetrainingDriver:
    def test_locked_coordinate_held_at_initial_model(self, game_files,
                                                     trained, tmp_path):
        train, val, config = game_files
        root, _, _ = trained
        args = ["--train-data", train, "--validate-data", val, "--config",
                config, "--initial-model", str(root / "port" / "models"),
                "--locked-coordinates", "per_user"]
        result = game_training_driver.run(
            args + ["--output-dir", str(tmp_path / "partial"), *CPU])
        m1, _ = load_game_model(str(root / "port" / "models"), device="cpu")
        m2, _ = load_game_model(str(tmp_path / "partial" / "models"),
                                device="cpu")
        re1, re2 = m1.models["per_user"], m2.models["per_user"]
        assert set(re1.coefficients) == set(re2.coefficients)
        for k, (c1, v1) in re1.coefficients.items():
            c2, v2 = re2.coefficients[k]
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(v1, v2)
        assert result["validation_metric"] > 0.65
        assert {h["coordinate"] for h in result["history"]} == {"fixed"}
        ref = ref_training.run(args + ["--output-dir",
                                       str(tmp_path / "ref_partial")])
        assert result["validation_metric"] == pytest.approx(
            ref["validation_metric"], abs=FIT_TOL)

    def test_locked_without_initial_model_rejected(self, game_files,
                                                   tmp_path):
        train, _, config = game_files
        with pytest.raises(SystemExit, match="initial-model"):
            game_training_driver.run([
                "--train-data", train, "--config", config, "--output-dir",
                str(tmp_path / "x"), "--locked-coordinates", "per_user",
                *CPU])


class TestDriverGrid:
    def test_driver_reg_weight_grid(self, tmp_path):
        rng = np.random.default_rng(3)
        user_effect = {f"u{u}": rng.normal(scale=2.0) for u in range(12)}
        train, val = str(tmp_path / "train.avro"), str(tmp_path / "val.avro")
        write_game_avro(train, _make_game_rows(rng, user_effect, 400))
        write_game_avro(val, _make_game_rows(rng, user_effect, 150,
                                             uid_start=400))
        coords = [dict(COORDS[0], max_iters=40, reg_weights=[1e5, 0.5]),
                  COORDS[1]]
        del coords[0]["reg_weight"]
        config = _write_config(tmp_path / "config.json",
                               evaluators=["auc", "logistic_loss"],
                               coordinates=coords)
        args = ["--train-data", train, "--validate-data", val, "--config",
                config]
        result = game_training_driver.run(
            args + ["--output-dir", str(tmp_path / "out"), *CPU])
        ref = ref_training.run(args + ["--output-dir",
                                       str(tmp_path / "ref")])
        assert len(result["grid"]) == 2
        best = next(g for g in result["grid"] if g["best"])
        assert best["reg_weights"]["fixed"] == 0.5
        assert [g["best"] for g in result["grid"]] == \
            [g["best"] for g in ref["grid"]]
        for g, rg in zip(result["grid"], ref["grid"]):
            assert g["metric"] == pytest.approx(rg["metric"], abs=FIT_TOL)
        assert result["per_iteration_validation"]
        assert set(result["validation_suite"]) == {"auc", "logistic_loss"}
        assert all("validation" in h for h in result["history"])
        assert result["validation_metric"] > 0.6
        # --resume skips the completed points and selects the same one.
        resumed = game_training_driver.run(
            args + ["--output-dir", str(tmp_path / "out"), "--resume", *CPU])
        assert resumed["grid"] == result["grid"]
        assert os.path.isdir(tmp_path / "out" / "checkpoints" / "grid" /
                             "point_1")


def _resume_rows(n, seed):
    """The reference's kill-and-resume data (``tests/test_checkpoint.py``)."""
    rng = np.random.default_rng(seed)
    user_effect = {f"u{u}": rng.normal(scale=2.0) for u in range(10)}
    rows = []
    for i in range(n):
        u = f"u{rng.integers(10)}"
        xg = rng.normal(size=3)
        margin = 1.5 * xg[0] + user_effect[u]
        rows.append({
            "uid": f"r{i}", "offset": None, "weight": None,
            "response": float(rng.uniform() < 1 / (1 + np.exp(-margin))),
            "ids": {"userId": u},
            "features": {
                "global": [{"name": f"g{j}", "term": "",
                            "value": float(xg[j])} for j in range(3)],
                "userFeatures": [{"name": "b", "term": "", "value": 1.0}],
            },
        })
    return rows


class TestDriverResume:
    def _config(self, tmp_path, iters):
        coords = [dict(COORDS[0], max_iters=30),
                  dict(COORDS[1], max_iters=20)]
        return _write_config(tmp_path / f"cfg{iters}.json",
                             iterations=iters, coordinates=coords)

    def test_game_driver_kill_and_resume(self, tmp_path):
        train = str(tmp_path / "train.avro")
        write_game_avro(train, _resume_rows(300, 2))
        full, res = str(tmp_path / "full"), str(tmp_path / "resumed")
        game_training_driver.run(["--train-data", train, "--config",
                                  self._config(tmp_path, 3),
                                  "--output-dir", full, *CPU])
        # "Kill" after 1 iteration, then resume to 3 in the same directory.
        game_training_driver.run(["--train-data", train, "--config",
                                  self._config(tmp_path, 1),
                                  "--output-dir", res, *CPU])
        assert os.path.exists(os.path.join(res, "checkpoints",
                                           "cd_checkpoint.npz"))
        result = game_training_driver.run([
            "--train-data", train, "--config", self._config(tmp_path, 3),
            "--output-dir", res, "--resume", *CPU])
        assert [h["iteration"] for h in result["history"]] == \
            [0, 0, 1, 1, 2, 2]
        np.testing.assert_array_equal(_scores(full, train),
                                      _scores(res, train))
        m_full, _ = load_game_model(os.path.join(full, "models"),
                                    device="cpu")
        m_res, _ = load_game_model(os.path.join(res, "models"), device="cpu")
        np.testing.assert_array_equal(
            m_full.models["fixed"].model.coefficients.means.numpy(),
            m_res.models["fixed"].model.coefficients.means.numpy())
        # The reference resumes from the port's checkpoint too.
        ref_res = str(tmp_path / "ref_resumed")
        game_training_driver.run(["--train-data", train, "--config",
                                  self._config(tmp_path, 1),
                                  "--output-dir", ref_res, *CPU])
        ref = ref_training.run(["--train-data", train, "--config",
                                self._config(tmp_path, 3), "--output-dir",
                                ref_res, "--resume"])
        assert [h["iteration"] for h in ref["history"]] == \
            [0, 0, 1, 1, 2, 2]
        np.testing.assert_allclose(_scores(ref_res, train, ref=True),
                                   _scores(full, train), atol=FIT_TOL * 10)

    def test_out_of_core_kill_and_resume_byte_equal(self, tmp_path):
        """The fixed effect streamed and the per-user effect out of core
        (the shape of ``chip_smoke.py`` phase 10e): a run killed after one
        iteration and resumed writes the uninterrupted run's model files
        byte for byte."""
        train = str(tmp_path / "train.avro")
        write_game_avro(train, _resume_rows(300, 2))

        def config(iters):
            coords = [dict(COORDS[0], max_iters=30, streaming_chunk_rows=128),
                      dict(COORDS[1], max_iters=20, device_budget_mb=0.01)]
            return _write_config(tmp_path / f"ooc{iters}.json",
                                 iterations=iters, coordinates=coords)

        full, res = str(tmp_path / "full"), str(tmp_path / "resumed")
        game_training_driver.run(["--train-data", train, "--config",
                                  config(3), "--output-dir", full, *CPU])
        game_training_driver.run(["--train-data", train, "--config",
                                  config(1), "--output-dir", res, *CPU])
        result = game_training_driver.run([
            "--train-data", train, "--config", config(3),
            "--output-dir", res, "--resume", *CPU])
        assert [h["iteration"] for h in result["history"]] == \
            [0, 0, 1, 1, 2, 2]
        for rel in ("fixed-effect/fixed/coefficients.avro",
                    "random-effect/per_user/coefficients.avro"):
            with open(os.path.join(full, "models", rel), "rb") as a, \
                    open(os.path.join(res, "models", rel), "rb") as b:
                assert a.read() == b.read(), rel

    def test_game_driver_incremental(self, tmp_path):
        """The reference's incremental-training flow and data: a warm start
        from a saved model does not regress the train metric."""
        rng = np.random.default_rng(4)
        rows = []
        for i in range(200):
            xg = rng.normal(size=2)
            rows.append({
                "uid": f"r{i}", "weight": None, "offset": None,
                "response": float(rng.uniform()
                                  < 1 / (1 + np.exp(-1.2 * xg[0]))),
                "ids": {"userId": f"u{i % 8}"},
                "features": {
                    "global": [{"name": f"g{j}", "term": "",
                                "value": float(xg[j])} for j in range(2)],
                    "userFeatures": [{"name": "b", "term": "",
                                      "value": 1.0}],
                },
            })
        train = str(tmp_path / "t.avro")
        write_game_avro(train, rows)
        coords = [dict(COORDS[0], max_iters=20),
                  dict(COORDS[1], max_iters=15)]
        cfg = _write_config(tmp_path / "c.json", iterations=1,
                            coordinates=coords)
        out1, out2 = str(tmp_path / "m1"), str(tmp_path / "m2")
        r1 = game_training_driver.run(["--train-data", train, "--config",
                                       cfg, "--output-dir", out1, *CPU])
        r2 = game_training_driver.run([
            "--train-data", train, "--config", cfg, "--output-dir", out2,
            "--initial-model", os.path.join(out1, "models"), *CPU])
        assert r2["train_metric"] >= r1["train_metric"] - 1e-6
        ref = ref_training.run([
            "--train-data", train, "--config", cfg, "--output-dir",
            str(tmp_path / "m3"), "--initial-model",
            os.path.join(out1, "models")])
        assert r2["train_metric"] == pytest.approx(ref["train_metric"],
                                                   abs=FIT_TOL)

    def test_resume_without_checkpointing_refused(self, tmp_path):
        train = str(tmp_path / "t.avro")
        write_game_avro(train, _resume_rows(50, 5))
        cfg = _write_config(tmp_path / "c.json", checkpoint=False)
        with pytest.raises(ValueError, match="requires checkpointing"):
            game_training_driver.run(["--train-data", train, "--config",
                                      cfg, "--output-dir",
                                      str(tmp_path / "o"), "--resume", *CPU])


def _train_both(game_files, tmp_path, coordinates, iterations=2):
    """Both packages' training drivers on ``coordinates``; returns
    (config path, port result, port dir, reference result, ref dir)."""
    train, val, _ = game_files
    cfg = _write_config(tmp_path / "cfg.json", coordinates=coordinates,
                        iterations=iterations)
    args = ["--train-data", train, "--validate-data", val, "--config", cfg]
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    port = game_training_driver.run(args + ["--output-dir", port_dir, *CPU])
    ref = ref_training.run(args + ["--output-dir", ref_dir])
    for key in ("train_metric", "validation_metric"):
        assert port[key] == pytest.approx(ref[key], abs=FIT_TOL)
    return cfg, port, port_dir, ref, ref_dir


def _tables_close(port_dir, ref_dir, name="per_user", tol=FIT_TOL):
    model, _ = load_game_model(os.path.join(port_dir, "models"),
                               device="cpu")
    rmodel, _ = ref_load(os.path.join(ref_dir, "models"))
    table = model.models[name].coefficients
    rtable = rmodel.models[name].coefficients
    assert set(table) == set(rtable)
    scale = max(float(np.abs(v).max()) for _, v in rtable.values())
    for k, (_, vals) in table.items():
        assert np.abs(vals - rtable[k][1]).max() <= tol * scale


FACTORED = dict(COORDS[1], type="factored_random", rank=1, alternations=2,
                max_iters=30, reg_weight=0.5)


class TestFactoredDriver:
    """The reference's ``TestFactoredDriver`` flows through both
    packages."""

    def test_factored_coordinate_end_to_end(self, game_files, tmp_path):
        _, val, _ = game_files
        _, port, port_dir, ref, ref_dir = _train_both(
            game_files, tmp_path, [COORDS[0], FACTORED])
        # userFeatures is one bias column: rank 1 is full rank.
        assert port["validation_metric"] > 0.65
        assert os.path.isdir(os.path.join(port_dir, "models",
                                          "random-effect"))
        _tables_close(port_dir, ref_dir)
        sresult = game_scoring_driver.run([
            "--data", val, "--model-dir", port_dir, "--output-dir",
            str(tmp_path / "score"), "--evaluator", "auc", *CPU])
        assert sresult["metric"] == pytest.approx(port["validation_metric"],
                                                  abs=1e-6)

    def test_factored_spec_trains_as_the_reference(self, game_files,
                                                   tmp_path):
        """The spec the driver once refused (``"type": "factored"``,
        rank 1, the plain coordinate's other keys), on the same files."""
        _, port, port_dir, _, ref_dir = _train_both(
            game_files, tmp_path, [COORDS[0], dict(COORDS[1],
                                                   type="factored", rank=1)])
        assert port["validation_metric"] > 0.6
        _tables_close(port_dir, ref_dir)

    def test_factored_resume_reproduces_run(self, game_files, tmp_path):
        """The nested (u_list, V) state survives the checkpoint: a killed
        and resumed run writes the uninterrupted run's model files."""
        train, val, _ = game_files
        coords = [COORDS[0], dict(FACTORED, alternations=1, max_iters=20)]
        runs = {}
        for label, iters in (("full", 2), ("resumed", 1), ("resumed", 2)):
            cfg = _write_config(tmp_path / f"c{iters}.json",
                                coordinates=coords, iterations=iters)
            out = str(tmp_path / label)
            runs[label] = game_training_driver.run(
                ["--train-data", train, "--validate-data", val, "--config",
                 cfg, "--output-dir", out, *CPU]
                + (["--resume"] if label == "resumed" and iters == 2
                   else []))
        assert runs["resumed"]["validation_metric"] == \
            runs["full"]["validation_metric"]
        for rel in ("fixed-effect/fixed/coefficients.avro",
                    "random-effect/per_user/coefficients.avro"):
            a, b = (open(os.path.join(str(tmp_path / k), "models", rel),
                         "rb").read() for k in ("full", "resumed"))
            assert a == b

    def test_factored_initial_model_starts_cold_not_crash(self, game_files,
                                                          tmp_path):
        train, val, _ = game_files
        coords = [COORDS[0], dict(FACTORED, alternations=1, max_iters=20)]
        cfg = _write_config(tmp_path / "c.json", coordinates=coords)
        args = ["--train-data", train, "--validate-data", val, "--config",
                cfg]
        first = str(tmp_path / "first")
        game_training_driver.run(args + ["--output-dir", first, *CPU])
        second = game_training_driver.run(args + [
            "--output-dir", str(tmp_path / "second"), "--initial-model",
            os.path.join(first, "models"), *CPU])
        rfirst = str(tmp_path / "rfirst")
        ref_training.run(args + ["--output-dir", rfirst])
        rsecond = ref_training.run(args + [
            "--output-dir", str(tmp_path / "rsecond"), "--initial-model",
            os.path.join(rfirst, "models")])
        assert second["validation_metric"] > 0.6
        assert second["validation_metric"] == pytest.approx(
            rsecond["validation_metric"], abs=FIT_TOL)


@pytest.mark.parametrize("spec", [
    dict(reg_type="elastic_net", elastic_net_alpha=0.5, reg_weight=0.5),
    dict(optimizer="owlqn", reg_type="l2"),
    dict(optimizer="tron", reg_type="l2"),
], ids=["elastic_net", "owlqn", "tron"])
def test_per_user_fallback_routes_match_reference(game_files, tmp_path,
                                                  spec):
    """A per-user random effect that runs the batched fallback (elastic
    net and the OWL-QN optimizer: OWL-QN on every bucket; TRON: on wide
    buckets only, so here the Newton routes)."""
    _, port, port_dir, _, ref_dir = _train_both(
        game_files, tmp_path, [COORDS[0], dict(COORDS[1], **spec)])
    assert port["validation_metric"] > 0.6
    _tables_close(port_dir, ref_dir)


@pytest.mark.parametrize("optimizer", ["lbfgs", "tron"])
def test_wide_per_user_effect_matches_reference(tmp_path, optimizer):
    """A per-user effect over a 48-wide shard (8 values a row): buckets of
    D > 32 on the batched L-BFGS or TRON, through both training drivers
    and the port's scoring driver."""
    rng = np.random.default_rng(12)
    rows = []
    for i in range(480):
        cols = rng.choice(48, size=8, replace=False)
        xg = rng.normal(size=3)
        rows.append({
            "uid": f"r{i}", "response": float(rng.uniform() < 1 / (
                1 + np.exp(-1.5 * xg[0]))), "weight": None, "offset": None,
            "ids": {"userId": f"u{rng.integers(10)}"},
            "features": {
                "global": [{"name": f"g{j}", "term": "", "value": float(v)}
                           for j, v in enumerate(xg)],
                "wide": [{"name": f"w{c}", "term": "",
                          "value": float(rng.normal())} for c in cols]}})
    train = str(tmp_path / "wide.avro")
    write_game_avro(train, rows)
    spec = dict(COORDS[1], feature_shard="wide", optimizer=optimizer,
                reg_weight=1.0)
    cfg = _write_config(tmp_path / "c.json", coordinates=[COORDS[0], spec])
    args = ["--train-data", train, "--validate-data", train, "--config",
            cfg]
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    port = game_training_driver.run(args + ["--output-dir", port_dir, *CPU])
    ref = ref_training.run(args + ["--output-dir", ref_dir])
    assert port["validation_metric"] == pytest.approx(
        ref["validation_metric"], abs=FIT_TOL)
    _tables_close(port_dir, ref_dir)
    model, _ = load_game_model(os.path.join(port_dir, "models"),
                               device="cpu")
    assert max(len(c) for c, _ in
               model.models["per_user"].coefficients.values()) > 32
    sresult = game_scoring_driver.run([
        "--data", train, "--model-dir", port_dir, "--output-dir",
        str(tmp_path / "s"), "--evaluator", "auc", *CPU])
    assert sresult["metric"] == pytest.approx(port["validation_metric"],
                                              abs=1e-6)


class TestRefusals:
    """The flags and configs the port once refused, naming their ROADMAP
    Queue 1 item, run: the ops plane over a GAME search, the out-of-core
    routes as the reference's; and the settings the
    reference reads only where a mesh forms change nothing on one
    process."""

    def test_refusal_names_its_item(self, game_files, trained, tmp_path):
        """A GAME search asked to mount the live ops plane, refused naming
        Queue 1 item 8 until the plane was ported, now runs with it: the
        time series brackets the search."""
        from photon_ml_tpu_torch.telemetry import read_series
        from photon_ml_tpu_torch.tuning.__main__ import main as tune

        train, val, config = game_files
        out = tmp_path / "o"
        assert tune(["--driver", "game", "--train-data", train,
                     "--validate-data", val, "--config", config,
                     "--output-dir", str(out), "--trials", "2",
                     "--workers", "2", "--metrics-port", "0",
                     "--metrics-interval-s", "0.05", *CPU]) == 0
        with open(out / "tuning_result.json") as f:
            assert json.load(f)["n_trials"] == 2
        assert len(read_series(str(out / "metrics_ts.jsonl"))) >= 2

    @pytest.mark.parametrize("case", ["data_parallel", "split_factor",
                                      "solver_options"])
    def test_one_device_settings_change_nothing(self, game_files, trained,
                                                tmp_path, case):
        """``--data-parallel auto`` on one process, a random effect's
        ``split_factor`` other than 0.5 and a fixed effect's
        ``solver_options`` (knobs of the host-kind solvers, unread by
        L-BFGS) train the same models as without them, in the port and in
        the reference; the grid checkpoint's fingerprint carries the
        settings as the reference's does."""
        train, val, _ = game_files
        root, port, ref = trained
        flags, overrides = [], {}
        if case == "data_parallel":
            flags = ["--data-parallel", "auto"]
        elif case == "split_factor":
            overrides = {"coordinates": [COORDS[0], dict(
                COORDS[1], split_factor=0.25)]}
        else:
            overrides = {"coordinates": [dict(
                COORDS[0], solver_options={"rho": 1.0}), COORDS[1]]}
        cfg = (_write_config(tmp_path / "c.json", **overrides)
               if overrides else game_files[2])
        args = ["--train-data", train, "--validate-data", val,
                "--config", cfg, *flags]
        out = game_training_driver.run(
            args + ["--output-dir", str(tmp_path / "o"), *CPU])
        assert out["validation_metric"] == port["validation_metric"]
        np.testing.assert_array_equal(
            _scores(str(tmp_path / "o"), val),
            _scores(str(root / "port"), val))
        ref_out = ref_training.run(args + ["--output-dir",
                                           str(tmp_path / "r")])
        assert abs(ref_out["validation_metric"]
                   - out["validation_metric"]) <= FIT_TOL
        with open(cfg) as f:
            specs = json.load(f)["coordinates"]
        configs = dict(game_training_driver.parse_coordinate_config(c)
                       for c in specs)
        ref_configs = dict(ref_training.parse_coordinate_config(c)
                           for c in specs)
        assert (checkpoint.GameGridCheckpointer.fingerprint(configs)
                == ref_ckpt.GameGridCheckpointer.fingerprint(ref_configs))

    def test_data_parallel_over_ranks_names_item_6c(self, game_files,
                                                    tmp_path, monkeypatch):
        """Over a process group GAME no longer refuses: the driver's group
        route (the mesh coordinates, rank 0 writing) runs; over a group of
        one rank (gloo, made to look like a larger world) it writes one
        process's validation metric within 1e-4 and the same entities.
        Groups of 2 and 4 ranks: ``tests/test_torch_game_mesh.py``."""
        import contextlib

        import torch.distributed as dist

        from photon_ml_tpu_torch.parallel import multihost

        train, val, config = game_files
        args = ["--train-data", train, "--validate-data", val, "--config",
                config, *CPU]
        one = game_training_driver.run(
            args + ["--output-dir", str(tmp_path / "one")])
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            monkeypatch.setattr(multihost, "driver_group",
                                lambda *a, **k: contextlib.nullcontext(2))
            group = game_training_driver.run(
                args + ["--output-dir", str(tmp_path / "o"),
                        "--data-parallel", "auto"])
        finally:
            dist.destroy_process_group()
        assert group["data_parallel"] == {"ranks": 1, "rank": 0}
        assert group["validation_metric"] == pytest.approx(
            one["validation_metric"], abs=1e-4)
        m_one, _ = load_game_model(str(tmp_path / "one" / "models"),
                                   device="cpu")
        m_group, _ = load_game_model(str(tmp_path / "o" / "models"),
                                     device="cpu")
        assert sorted(m_group.models["per_user"].coefficients) == sorted(
            m_one.models["per_user"].coefficients)

    #: The out-of-core specs, run by both packages' training drivers.
    OOC_SPECS = {
        "streamed_fixed": [dict(COORDS[0], streaming_chunk_rows=150),
                           COORDS[1]],
        "stream_knob": [dict(COORDS[0], streaming_chunk_rows=150,
                             chunk_fuse=2, prefetch_depth=3,
                             stream_compress="lossless",
                             stream_hot_budget_mb=0.01), COORDS[1]],
        "ooc_random": [COORDS[0], dict(COORDS[1], device_budget_mb=0.01)],
        "ooc_knob": [COORDS[0], dict(COORDS[1], device_budget_mb=0.01,
                                     prefetch_depth=3, hot_budget_mb=64)],
    }

    @pytest.mark.parametrize("case", ["streamed_fixed", "stream_knob",
                                      "ooc_random", "ooc_knob",
                                      "stream_scoring"])
    def test_out_of_core_route_matches_the_reference(
            self, game_files, trained, tmp_path, case):
        """Each out-of-core route the drivers once refused, through both
        packages: the training runs agree as whole fits do (2e-3) and with
        the port's resident run; the streamed scoring run writes the
        reference's streamed bytes and its whole-file scores."""
        train, val, _ = game_files
        root, port_resident, _ = trained
        if case == "stream_scoring":
            def score(mod, out, *extra):
                return mod.run(["--data", val, "--model-dir",
                                str(root / "ref"), "--output-dir",
                                str(tmp_path / out), "--evaluator", "auc",
                                "--stream-block-rows", "64", *extra])

            port = score(game_scoring_driver, "port", *CPU)
            ref = score(ref_scoring, "ref")
            assert port["n_rows"] == ref["n_rows"] == 200
            assert port["metric"] == ref["metric"]
            assert (tmp_path / "port" / "scores.avro").read_bytes() == \
                (tmp_path / "ref" / "scores.avro").read_bytes()
            whole = game_scoring_driver.run([
                "--data", val, "--model-dir", str(root / "ref"),
                "--output-dir", str(tmp_path / "whole"), *CPU])
            assert (tmp_path / "whole" / "scores.avro").read_bytes() == \
                (tmp_path / "port" / "scores.avro").read_bytes()
            return
        _, port, port_dir, ref, ref_dir = _train_both(
            game_files, tmp_path, self.OOC_SPECS[case])
        assert port["validation_metric"] == pytest.approx(
            ref["validation_metric"], abs=FIT_TOL)
        assert port["validation_metric"] == pytest.approx(
            port_resident["validation_metric"], abs=FIT_TOL)
        _tables_close(port_dir, ref_dir)
        _tables_close(port_dir, str(root / "ref"))
        model, _ = load_game_model(os.path.join(port_dir, "models"),
                                   device="cpu")
        rmodel, _ = ref_load(os.path.join(ref_dir, "models"))
        np.testing.assert_allclose(
            model["fixed"].model.coefficients.means.numpy(),
            np.asarray(rmodel["fixed"].model.coefficients.means),
            atol=5e-3)

    def test_reference_defaults_of_unported_keys_are_accepted(self):
        """A spec that spells out the reference's defaults of the keys the
        port refuses parses to the reference's grid fingerprint."""
        specs = [dict(COORDS[0], prefetch_depth=2, chunk_fuse=1,
                      batch_linesearch=True, stream_compress="off",
                      stream_hot_budget_mb=0, solver_options={}),
                 dict(COORDS[1], split_factor=0.5, prefetch_depth=2,
                      hot_budget_mb=0.0)]
        port = game_training_driver.expand_config_grid(specs)[0]
        ref = ref_training.expand_config_grid(specs)[0]
        assert checkpoint.GameGridCheckpointer.fingerprint(port) == \
            ref_ckpt.GameGridCheckpointer.fingerprint(ref)

    def test_out_of_core_keys_fingerprint_as_the_reference(self):
        """Non-default out-of-core keys parse into the port's configs and
        fingerprint as the reference's, for every coordinate kind."""
        specs = [dict(COORDS[0], streaming_chunk_rows=128, prefetch_depth=3,
                      chunk_fuse=2, batch_linesearch=False,
                      stream_compress="lossless", stream_hot_budget_mb=1.5),
                 dict(COORDS[1], device_budget_mb=2, prefetch_depth=4,
                      hot_budget_mb=8.0),
                 dict(FACTORED, name="per_user_f", device_budget_mb=3,
                      prefetch_depth=1)]
        port = game_training_driver.expand_config_grid(specs)[0]
        ref = ref_training.expand_config_grid(specs)[0]
        assert port["fixed"].stream_compress == "lossless"
        assert port["per_user"].device_budget_bytes == 2 * 2**20
        assert port["per_user_f"].prefetch_depth == 1
        assert checkpoint.GameGridCheckpointer.fingerprint(port) == \
            ref_ckpt.GameGridCheckpointer.fingerprint(ref)

    def test_drivers_default_to_cuda(self):
        assert game_training_driver.build_arg_parser().parse_args(
            ["--train-data", "x", "--config", "c", "--output-dir", "o"]
        ).device == "cuda"
        assert game_scoring_driver.build_arg_parser().parse_args(
            ["--data", "x", "--model-dir", "m", "--output-dir", "o"]
        ).device == "cuda"


def _model_files(out):
    """Every file of a saved GameModel directory, by relative path."""
    root = os.path.join(out, "models")
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            files[os.path.relpath(path, root)] = open(path, "rb").read()
    return files


class TestRetries:
    """``--max-retries``: a transport-style failure re-enters the fit,
    which resumes from the CD checkpoint (or skips the finished grid
    points), through both packages' training drivers."""

    def test_cd_crash_resumes_per_iteration(self, tmp_path, monkeypatch):
        from photon_ml_tpu.game import descent as ref_descent
        from photon_ml_tpu_torch.game import descent as port_descent

        train = str(tmp_path / "train.avro")
        write_game_avro(train, _resume_rows(300, 3))
        coords = [dict(COORDS[0], max_iters=20),
                  dict(COORDS[1], max_iters=15)]
        cfg = _write_config(tmp_path / "c.json", iterations=3,
                            coordinates=coords)
        args = ["--train-data", train, "--config", cfg]
        ok = str(tmp_path / "ok")
        game_training_driver.run(args + ["--output-dir", ok, *CPU])

        def flaky(module, state):
            orig = module.CoordinateDescent.run

            def run(self, base_offsets, n_iterations=1, checkpointer=None,
                    **kw):
                state["calls"] += 1
                if state["calls"] == 1:
                    # Finish (and checkpoint) one iteration, then die as a
                    # dropped transport would.
                    orig(self, base_offsets, n_iterations=1,
                         checkpointer=checkpointer, **kw)
                    raise RuntimeError("UNAVAILABLE: injected transport "
                                       "drop")
                saved = checkpointer.load()
                state["resumed_from"] = saved["iteration"]
                return orig(self, base_offsets, n_iterations=n_iterations,
                            checkpointer=checkpointer, **kw)

            monkeypatch.setattr(module.CoordinateDescent, "run", run)

        states = []
        for module, driver, extra in (
                (port_descent, game_training_driver, CPU),
                (ref_descent, ref_training, ())):
            state = {"calls": 0, "resumed_from": None}
            flaky(module, state)
            out = str(tmp_path / f"retried_{len(states)}")
            result = driver.run(args + ["--output-dir", out,
                                        "--max-retries", "1",
                                        "--retry-backoff", "0", *extra])
            states.append(state)
            assert result["retry"]["retries"] == 1
            assert [h["iteration"] for h in result["history"]][-1] == 2
        assert states == [{"calls": 2, "resumed_from": 0}] * 2
        assert _model_files(str(tmp_path / "retried_0")) == _model_files(ok)

    def test_grid_crash_resumes_at_point_boundary(self, game_files,
                                                  tmp_path, monkeypatch):
        """A failure between grid points: the retry skips the finished
        point (its checkpointed model) and fits only the rest."""
        from photon_ml_tpu_torch.game import estimator as est_mod

        train, val, _ = game_files
        cfg = _write_config(
            tmp_path / "grid.json", iterations=1,
            coordinates=[dict(COORDS[0], reg_weights=[0.1, 1.0, 10.0],
                              max_iters=10), dict(COORDS[1], max_iters=10)])
        orig = est_mod.GameEstimator.fit_coordinates
        fits = []

        def flaky(self, *a, **kw):
            out = orig(self, *a, **kw)
            fits.append(len(fits))
            if len(fits) == 2:
                raise RuntimeError("UNAVAILABLE: device lost (injected)")
            return out

        monkeypatch.setattr(est_mod.GameEstimator, "fit_coordinates", flaky)
        result = game_training_driver.run([
            "--train-data", train, "--validate-data", val, "--config", cfg,
            "--output-dir", str(tmp_path / "out"), "--max-retries", "1",
            "--retry-backoff", "0", *CPU])
        # Attempt 1 fits point 0 (checkpointed) and point 1 (killed before
        # its checkpoint); attempt 2 skips point 0 and fits 1 and 2.
        assert len(fits) == 4
        assert len(result["grid"]) == 3
        assert sum(g["best"] for g in result["grid"]) == 1
        assert all(g["metric"] is not None for g in result["grid"])
        assert result["retry"]["failures"][0]["matched"] == "UNAVAILABLE"

    def test_non_transient_failure_not_retried(self, game_files, tmp_path,
                                               monkeypatch):
        from photon_ml_tpu_torch.game import descent as port_descent

        train, _, config = game_files
        calls = []

        def broken(self, *a, **kw):
            calls.append(1)
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

        monkeypatch.setattr(port_descent.CoordinateDescent, "run", broken)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            game_training_driver.run([
                "--train-data", train, "--config", config, "--output-dir",
                str(tmp_path / "o"), "--max-retries", "3",
                "--retry-backoff", "0", *CPU])
        assert calls == [1]
