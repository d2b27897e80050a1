"""The port's training diagnostics (``diagnostics/report.py``) against the
reference's: the reference's cases, each statistic held equal to the
reference's on the same numpy inputs (both are host numpy, so to 1e-12),
and the GLM driver's ``--training-report`` through both packages."""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp

from photon_ml_tpu import diagnostics as ref_diag
from photon_ml_tpu_torch.diagnostics import (
    TrainingReport,
    bootstrap_metric_ci,
    feature_importance,
    hosmer_lemeshow,
)
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


def _auc(s, l):
    from sklearn.metrics import roc_auc_score

    return roc_auc_score(l, s)


class TestHosmerLemeshow:
    def test_calibrated_model_passes(self, rng):
        p = rng.uniform(0.05, 0.95, size=20000)
        y = (rng.uniform(size=p.size) < p).astype(np.float64)
        hl = hosmer_lemeshow(p, y, scores_are_margins=False)
        assert hl["p_value"] > 0.01 and len(hl["table"]) == 10

    def test_miscalibrated_model_fails(self, rng):
        p = rng.uniform(0.05, 0.95, size=20000)
        true_p = 0.5 + 0.3 * (p - 0.5)
        y = (rng.uniform(size=p.size) < true_p).astype(np.float64)
        hl = hosmer_lemeshow(p, y, scores_are_margins=False)
        assert hl["p_value"] < 1e-4

    @pytest.mark.parametrize("margins", [True, False])
    def test_matches_reference(self, rng, margins):
        s = (rng.normal(size=5000) * 2.0 if margins
             else rng.uniform(size=5000))
        p = 1 / (1 + np.exp(-s)) if margins else s
        y = (rng.uniform(size=s.size) < p).astype(np.float64)
        ours = hosmer_lemeshow(s, y, scores_are_margins=margins)
        ref = ref_diag.hosmer_lemeshow(s, y, scores_are_margins=margins)
        assert ours["dof"] == ref["dof"]
        assert ours["table"] == ref["table"]
        assert ours["statistic"] == pytest.approx(ref["statistic"],
                                                  rel=1e-12)
        assert ours["p_value"] == pytest.approx(ref["p_value"], rel=1e-9)

    def test_margins_in_unit_interval_still_squashed(self, rng):
        m = rng.uniform(0.0, 1.0, size=20000)
        y = (rng.uniform(size=m.size) < 1 / (1 + np.exp(-m))).astype(float)
        assert hosmer_lemeshow(m, y)["p_value"] > 0.01
        assert hosmer_lemeshow(m, y, scores_are_margins=False)[
            "p_value"] < 1e-6

    def test_probability_range_validated(self):
        with pytest.raises(ValueError, match="outside"):
            hosmer_lemeshow(np.array([-0.5, 0.5, 2.0]),
                            np.array([0.0, 1.0, 1.0]),
                            scores_are_margins=False)


class TestBootstrapCI:
    def test_ci_covers_point_and_tightens_with_n(self, rng):
        def make(n):
            m = rng.normal(size=n) + 1.0
            y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(float)
            return m, y

        small = bootstrap_metric_ci(_auc, *make(300), n_boot=100)
        big = bootstrap_metric_ci(_auc, *make(10000), n_boot=100)
        for ci in (small, big):
            assert ci["lo"] <= ci["point"] <= ci["hi"] and ci["n_boot"] > 50
        assert big["hi"] - big["lo"] < small["hi"] - small["lo"]

    def test_matches_reference(self, rng):
        m = rng.normal(size=2000)
        y = (rng.uniform(size=m.size) < 1 / (1 + np.exp(-m))).astype(float)
        assert (bootstrap_metric_ci(_auc, m, y, n_boot=60, seed=3)
                == ref_diag.bootstrap_metric_ci(_auc, m, y, n_boot=60,
                                                seed=3))

    def test_degenerate_resamples_skipped(self):
        ci = bootstrap_metric_ci(_auc, np.array([0.1, 0.9]),
                                 np.array([0.0, 1.0]), n_boot=50)
        assert ci["point"] == 1.0


class TestFeatureImportance:
    def test_ranking_uses_std(self):
        top = feature_importance(np.array([1.0, 1.0, 0.0]),
                                 np.array([0.1, 10.0, 5.0]),
                                 names=["a", "b", "c"])
        assert [t["feature"] for t in top] == ["b", "a"]

    def test_top_k_matches_reference(self, rng):
        w, std = rng.normal(size=100), rng.uniform(size=100)
        top = feature_importance(w, std, top_k=7,
                                 name_fn=lambda j: f"f{j}")
        assert len(top) == 7
        assert top == ref_diag.feature_importance(
            w, std, top_k=7, name_fn=lambda j: f"f{j}")


class TestReportArtifacts:
    def test_report_roundtrip(self, tmp_path, rng):
        r = TrainingReport(task="logistic")
        r.add_convergence(1.0, [10.0, 5.0, 4.0, np.nan], [3.0, 1.0, 0.1])
        r.add_metric("AUC", 1.0, {"point": 0.8, "lo": 0.75, "hi": 0.85,
                                  "n_boot": 100})
        r.add_calibration(1.0, hosmer_lemeshow(
            rng.uniform(size=500), (rng.uniform(size=500) < 0.5).astype(
                float)))
        r.add_importance(1.0, [{"feature": "f<0>", "coefficient": 1.0,
                                "importance": 2.0}])
        jpath, hpath = r.save(str(tmp_path))
        data = json.load(open(jpath))
        assert [s["kind"] for s in data["sections"]] == [
            "convergence", "metric", "calibration", "feature_importance"]
        html = open(hpath).read()
        assert "Hosmer" in html and "AUC" in html
        assert "f&lt;0&gt;" in html and "<svg" in html

    def test_html_matches_reference_but_title(self, tmp_path):
        sections = dict(lam=0.5, values=[3.0, 2.0, 1.5], gnorms=[1.0, 0.1])
        ours, ref = TrainingReport("logistic"), ref_diag.TrainingReport(
            "logistic")
        for r in (ours, ref):
            r.add_convergence(sections["lam"], sections["values"],
                              sections["gnorms"])
        assert ours.to_json() == ref.to_json()
        assert ours._render_html().replace("photon_ml_tpu_torch",
                                           "photon_ml_tpu") \
            == ref._render_html()


def test_driver_writes_report_like_reference(tmp_path, rng):
    """``--training-report`` through both packages' GLM drivers (the port on
    ``--device cpu``): the same sections per λ, each metric's point equal
    to that λ's validation metric."""
    from photon_ml_tpu.data import libsvm
    from photon_ml_tpu.drivers import glm_driver as ref_driver
    from photon_ml_tpu_torch.drivers import glm_driver

    n, d = 500, 40
    X = sp.random(n, d, density=0.15, random_state=3, format="csr")
    X.data[:] = 1.0
    w_true = rng.normal(size=d) * (rng.uniform(size=d) < 0.4)
    y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w_true))),
                 1.0, -1.0)
    train = str(tmp_path / "t.libsvm")
    libsvm.write_libsvm(train, X, y)
    argv = ["--train-data", train, "--task", "logistic", "--reg-type", "l2",
            "--reg-weights", "0.5,5.0", "--n-features", str(d),
            "--tolerance", "1e-5", "--training-report"]
    out, ref_out = str(tmp_path / "port"), str(tmp_path / "ref")
    result = glm_driver.run(argv + ["--output-dir", out, "--device", "cpu"])
    ref_driver.run(argv + ["--output-dir", ref_out])
    rep = json.load(open(os.path.join(out, "report.json")))
    ref = json.load(open(os.path.join(ref_out, "report.json")))
    kinds = [(s["kind"], s["lambda"]) for s in rep["sections"]]
    assert kinds == [(s["kind"], s["lambda"]) for s in ref["sections"]]
    assert [k for k, _ in kinds].count("convergence") == 2
    assert os.path.exists(os.path.join(out, "report.html"))
    assert result["report"]["json"].endswith("report.json")
    for s, rs in zip(rep["sections"], ref["sections"]):
        if s["kind"] == "metric":
            assert s["point"] == pytest.approx(
                result["metrics"][str(s["lambda"])], abs=1e-12)
            assert s["point"] == pytest.approx(rs["point"], abs=1e-3)
            assert s["lo"] <= s["point"] <= s["hi"]
        if s["kind"] == "calibration":
            assert s["statistic"] == pytest.approx(rs["statistic"],
                                                   rel=5e-2)
