"""The port's device metrics and evaluation suite against the JAX package's
and the host evaluators, on the CPU.

Tolerances: the pointwise metrics reduce float32 terms in different orders
(rtol 2e-5, the reference's own test); AUC computes in float64 in all three
(the reference under x64, the host evaluator in numpy), so it agrees within
1e-9 — the group sums come from a cumulative-sum difference in the port and
a segment sum in the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.evaluation import device as ref_device
from photon_ml_tpu_torch.evaluation import device, evaluators
from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

KINDS = [("logistic_loss", evaluators.LogisticLossEvaluator()),
         ("poisson_loss", evaluators.PoissonLossEvaluator()),
         ("squared_loss", evaluators.SquaredLossEvaluator()),
         ("rmse", evaluators.RMSEEvaluator())]


def _arrays(seed, n=5000, decimals=1):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.normal(size=n), decimals).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.4).astype(np.float32)
    weights = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    weights[rng.uniform(size=n) < 0.1] = 0.0  # padding rows
    return scores, labels, weights


def _t(*arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


class TestPointwise:
    @pytest.mark.parametrize("kind,host", KINDS)
    @pytest.mark.parametrize("weighted", [True, False])
    def test_matches_reference_and_host(self, kind, host, weighted):
        s, y, w = _arrays(1)
        w = w if weighted else None
        got = float(device.device_pointwise_metric(*_t(s, y, w), kind=kind))
        ref = float(ref_device.device_pointwise_metric(
            jnp.asarray(s), jnp.asarray(y),
            None if w is None else jnp.asarray(w), kind=kind))
        assert got == pytest.approx(ref, rel=2e-5)
        assert got == pytest.approx(host.evaluate(s, y, w), rel=2e-5)
        fn = device.device_evaluator_fn(host)
        assert float(fn(*_t(s, y, w))) == got

    @pytest.mark.parametrize("kind,host", KINDS)
    def test_partials_accumulate_to_the_metric(self, kind, host):
        s, y, w = _arrays(2)
        num = den = 0.0
        for lo in range(0, len(s), 1700):
            a, b = device.device_pointwise_partial(
                *_t(s[lo:lo + 1700], y[lo:lo + 1700], w[lo:lo + 1700]),
                kind=kind)
            num, den = num + float(a), den + float(b)
        assert device.finish_pointwise_partial(num, den, kind) == \
            pytest.approx(host.evaluate(s, y, w), rel=2e-5)
        assert device.pointwise_kind_for(host) == kind
        if kind != "squared_loss":
            assert np.isnan(device.finish_pointwise_partial(0.0, 0.0, kind))

    def test_masked_overflowing_rows_stay_out(self):
        s = np.array([1000.0, 0.5, -0.5], np.float32)
        y = np.array([1.0, 0.0, 1.0], np.float32)
        w = np.array([0.0, 1.0, 1.0], np.float32)
        got = float(device.device_pointwise_metric(*_t(s, y, w),
                                                   kind="poisson_loss"))
        assert np.isfinite(got)
        with pytest.raises(ValueError, match="unknown"):
            device.device_pointwise_metric(*_t(s, y, w), kind="bogus")


class TestAuc:
    @pytest.mark.parametrize("decimals", [1, 3, 6], ids=["many-ties",
                                                         "few-ties",
                                                         "no-ties"])
    @pytest.mark.parametrize("weighted", [True, False])
    def test_matches_reference_and_host(self, decimals, weighted):
        s, y, w = _arrays(3, decimals=decimals)
        w = w if weighted else None
        got = device.device_auc(*_t(s, y, w))
        assert got.dtype == torch.float64
        ref = float(ref_device.device_auc(
            jnp.asarray(s), jnp.asarray(y),
            None if w is None else jnp.asarray(w)))
        host = evaluators.AreaUnderROCCurveEvaluator().evaluate(s, y, w)
        assert float(got) == pytest.approx(ref, abs=1e-9)
        assert float(got) == pytest.approx(host, abs=1e-9)

    def test_edge_cases(self):
        scores = torch.as_tensor(np.random.default_rng(0).normal(size=10))
        assert np.isnan(float(device.device_auc(scores, torch.ones(10))))
        assert float(device.device_auc(
            torch.tensor([3.0, 2.0, -1.0, -2.0]),
            torch.tensor([1.0, 1.0, 0.0, 0.0]))) == 1.0
        # One tie group holding everything: every pair counts one half.
        assert float(device.device_auc(
            torch.zeros(6), torch.tensor([1.0, 0, 1, 0, 0, 1]))) == 0.5
        # Zero weights drop rows: only the (0.9, 1) vs (0.1, 0) pair stays.
        assert float(device.device_auc(
            torch.tensor([0.9, 0.5, 0.1, 0.95]),
            torch.tensor([1.0, 1.0, 0.0, 0.0]),
            torch.tensor([1.0, 0.0, 1.0, 0.0]))) == 1.0

    def test_repeats_bitwise(self):
        s, y, w = _t(*_arrays(4))
        assert torch.equal(device.device_auc(s, y, w),
                           device.device_auc(s, y, w))


@dataclasses.dataclass(frozen=True)
class MeanScoreEvaluator(evaluators.Evaluator):
    """A host-only evaluator (no device counterpart)."""

    def _compute(self, scores, labels, weights, group_ids):
        return float(np.average(scores, weights=weights))


class TestSuite:
    def test_device_and_host_evaluation_agree(self):
        s, y, w = _arrays(5)
        suite = EvaluationSuite.from_specs(
            ["auc", "logistic_loss", "rmse", MeanScoreEvaluator()])
        assert device.device_evaluator_fn(MeanScoreEvaluator()) is None
        host = suite.evaluate(s, y, w)
        dev = suite.evaluate_device(*_t(s, y, w))
        lazy = suite.evaluate_device(*_t(s, y, w), materialize=False)
        assert set(host) == set(dev) == {
            "auc", "logistic_loss", "rmse", "MeanScoreEvaluator"}
        for name in host:
            assert dev[name] == pytest.approx(host[name], rel=2e-5)
        assert isinstance(lazy["auc"], torch.Tensor)
        assert float(lazy["auc"]) == dev["auc"]
        primary, values = suite.evaluate_primary(s, y, w)
        assert primary == values["auc"] == host["auc"]

    def test_selection_and_construction(self):
        suite = EvaluationSuite.for_task("squared")
        assert suite.primary == "RMSEEvaluator"
        assert suite.better_than(0.1, 0.2) and not suite.better_than(
            float("nan"), 0.2) and suite.better_than(0.3, None)
        auc = EvaluationSuite.from_specs(["auc", "rmse"], primary="auc")
        assert auc.better_than(0.9, 0.8)
        with pytest.raises(ValueError, match="duplicate"):
            EvaluationSuite.from_specs(["auc", "AUC"])
        with pytest.raises(ValueError, match="primary"):
            EvaluationSuite.from_specs(["auc"], primary="rmse")
        with pytest.raises(ValueError, match="at least one"):
            EvaluationSuite.from_specs([])

    def test_grouped_evaluation_refused(self):
        """Grouped metrics are host-side: a grouped suite evaluates on the
        host (as the reference's does) and refuses the device path, as the
        reference's refuses it."""
        from photon_ml_tpu.evaluation.suite import EvaluationSuite as RefSuite

        s, y, w = _arrays(6)
        groups = np.arange(len(s)) % 37
        suite = EvaluationSuite.from_specs(["auc", "precision@3"],
                                           group_column="queryId")
        ref = RefSuite.from_specs(["auc", "precision@3"],
                                  group_column="queryId")
        got = suite.evaluate(s, y, w, group_ids=groups)
        want = ref.evaluate(s, y, w, group_ids=groups)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == pytest.approx(want[k], abs=1e-12)
        with pytest.raises(ValueError, match="group_column"):
            suite.evaluate_device(*_t(s, y, w))
        with pytest.raises(ValueError, match="group_column"):
            ref.evaluate_device(jnp.asarray(s), jnp.asarray(y),
                                jnp.asarray(w))
