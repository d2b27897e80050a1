"""Validation in the port's GAME path against the JAX package's, on the CPU:
grouped evaluators, the per-coordinate validation scorers, per-update
validation in ``GameEstimator.fit``, validation-driven grid selection and
``GameTransformer``.

Tolerances: grouped AUC and precision@k are host float64 in both packages
(1e-12); the validation scorers and the transformer score the same
coefficients in float32 with other summation orders (1e-6 relative to the
scores' scale).  Whole fits inherit ``test_torch_game.py``'s 2e-3 (the fixed
effect's float32 L-BFGS stops on its value's noise floor), so metrics of
whole fits are held within 2e-3 and the same grid point must win.  Inside
the port, repeats and the incremental per-update scores are bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.evaluation import evaluators as ref_evaluators
from photon_ml_tpu.evaluation.suite import EvaluationSuite as RefSuite
from photon_ml_tpu.game import estimator as ref_est
from photon_ml_tpu.game.data import (
    build_random_effect_dataset as ref_build_re,
)
from photon_ml_tpu.game.validation import (
    FixedEffectValidationScorer as RefFixedScorer,
    RandomEffectValidationScorer as RefRandomScorer,
)
from photon_ml_tpu.optim.problem import (
    GlmOptimizationConfig as RefConfig,
    OptimizerConfig as RefOpt,
)
from photon_ml_tpu.optim.regularization import RegularizationContext as RefReg
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.evaluation import evaluators
from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite
from photon_ml_tpu_torch.game import estimator
from photon_ml_tpu_torch.game.data import build_random_effect_dataset
from photon_ml_tpu_torch.game.validation import (
    FixedEffectValidationScorer,
    RandomEffectValidationScorer,
)
from photon_ml_tpu_torch.ops.sparse_cuda import CudaSparseMatrix
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    OptimizerConfig,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = "cpu"
FIT_TOL = 2e-3
SCORE_RTOL = 1e-6


# -- grouped evaluators -----------------------------------------------------


def _grouped_arrays(seed, n=3000, n_groups=120, decimals=1):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.normal(size=n), decimals)
    labels = (rng.uniform(size=n) < 0.3).astype(np.float64)
    weights = rng.uniform(0.0, 2.0, size=n)
    weights[rng.uniform(size=n) < 0.1] = 0.0
    groups = np.array([f"q{g}" for g in rng.integers(n_groups, size=n)])
    # Groups holding one class only (skipped by grouped AUC).
    labels[groups == "q0"] = 1.0
    labels[groups == "q1"] = 0.0
    return scores, labels, weights, groups


class TestGroupedEvaluators:
    @pytest.mark.parametrize("decimals", [1, 6], ids=["ties", "distinct"])
    @pytest.mark.parametrize("weighted", [False, True])
    def test_grouped_auc_matches_reference(self, decimals, weighted):
        s, y, w, g = _grouped_arrays(1, decimals=decimals)
        w = w if weighted else None
        got = evaluators.AreaUnderROCCurveEvaluator().evaluate(
            s, y, w, group_ids=g)
        want = ref_evaluators.AreaUnderROCCurveEvaluator().evaluate(
            s, y, w, group_ids=g)
        assert got == pytest.approx(want, abs=1e-12)
        assert 0.3 < got < 0.7  # random scores

    @pytest.mark.parametrize("k", [1, 3, 10])
    def test_precision_at_k_matches_reference(self, k):
        s, y, w, g = _grouped_arrays(2)
        ev = evaluators.get_evaluator(f"precision@{k}")
        assert isinstance(ev, evaluators.PrecisionAtKEvaluator) and ev.k == k
        got = ev.evaluate(s, y, w, group_ids=g)
        want = ref_evaluators.get_evaluator(f"PRECISION@{k}").evaluate(
            s, y, w, group_ids=g)
        assert got == pytest.approx(want, abs=1e-12)
        assert ev.larger_is_better and ev.better_than(0.5, 0.4)

    def test_edge_cases_match_reference(self):
        s, y, w, g = _grouped_arrays(3, n=50)
        zero = np.zeros_like(w)
        for ev, ref in (
                (evaluators.AreaUnderROCCurveEvaluator(),
                 ref_evaluators.AreaUnderROCCurveEvaluator()),
                (evaluators.PrecisionAtKEvaluator(k=2),
                 ref_evaluators.PrecisionAtKEvaluator(k=2))):
            # Every row masked: NaN, as the reference.
            assert np.isnan(ev.evaluate(s, y, zero, group_ids=g))
            assert np.isnan(ref.evaluate(s, y, zero, group_ids=g))
        one_class = np.ones_like(y)
        assert np.isnan(evaluators.AreaUnderROCCurveEvaluator().evaluate(
            s, one_class, w, group_ids=g))
        with pytest.raises(ValueError, match="group_ids"):
            evaluators.PrecisionAtKEvaluator(k=1).evaluate(s, y, w)
        assert evaluators.EvaluatorType("precision_at_k").value == \
            ref_evaluators.EvaluatorType("precision_at_k").value
        assert [e.value for e in evaluators.EvaluatorType] == \
            [e.value for e in ref_evaluators.EvaluatorType]

    def test_grouped_suite_matches_reference(self):
        s, y, w, g = _grouped_arrays(4)
        specs = ["auc", "precision@5", "logistic_loss"]
        suite = EvaluationSuite.from_specs(specs, group_column="queryId")
        ref = RefSuite.from_specs(specs, group_column="queryId")
        got, want = (x.evaluate_primary(s, y, w, group_ids=g)
                     for x in (suite, ref))
        assert got[0] == pytest.approx(want[0], abs=1e-12)
        for key in want[1]:
            assert got[1][key] == pytest.approx(want[1][key], abs=1e-12)


class TestEvaluationSuite:
    """The reference's ``tests/test_game_grid.py::TestEvaluationSuite``
    through both packages."""

    def test_from_specs_and_primary(self):
        for mod, Suite in ((evaluators, EvaluationSuite),
                           (ref_evaluators, RefSuite)):
            suite = Suite.from_specs(["auc", "logistic_loss"])
            assert suite.primary == "auc"
            assert isinstance(suite.primary_evaluator,
                              mod.AreaUnderROCCurveEvaluator)
            assert isinstance(dict(suite.evaluators)["logistic_loss"],
                              mod.LogisticLossEvaluator)

    def test_evaluate_all_metrics(self):
        scores = np.array([2.0, -1.0, 0.5, -0.5])
        labels = np.array([1.0, 0.0, 1.0, 0.0])
        specs = ["auc", "logistic_loss", "rmse"]
        got = EvaluationSuite.from_specs(specs).evaluate(scores, labels)
        want = RefSuite.from_specs(specs).evaluate(scores, labels)
        assert got == want and got["auc"] == 1.0

    def test_better_than_direction_and_none(self):
        auc_suite = EvaluationSuite.from_specs(["auc"])
        assert auc_suite.better_than(0.9, 0.8)
        assert not auc_suite.better_than(0.8, 0.9)
        assert EvaluationSuite.from_specs(["logistic_loss"]).better_than(
            0.3, 0.5)
        assert auc_suite.better_than(0.5, None)
        assert not auc_suite.better_than(None, 0.5)

    def test_bad_primary_rejected(self):
        with pytest.raises(ValueError, match="primary"):
            EvaluationSuite.from_specs(["auc"], primary="rmse")


# -- validation scorers -------------------------------------------------------


def _split_problem(seed, n_train=600, n_val=300, n_users=30, d_re=3):
    """Train and validation rows over one user population, with users that
    appear only in the validation rows, validation features outside some
    users' training subspace, and validation rows with no user id."""
    rng = np.random.default_rng(seed)
    ue = rng.normal(scale=1.5, size=(n_users + 5, d_re))

    def make(n, users_hi, sparse_re):
        Xg = rng.normal(size=(n, 5)).astype(np.float32)
        users = rng.integers(users_hi, size=n)
        Xe = rng.normal(size=(n, d_re)).astype(np.float32)
        if sparse_re:
            Xe[rng.uniform(size=(n, d_re)) < 0.4] = 0.0
        m = Xg @ np.array([1.0, -0.5, 0.0, 0.3, 0.0]) + (Xe * ue[users]).sum(1)
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
        ids = np.array([f"u{u}" for u in users], dtype=object)
        return ({"global": sp.csr_matrix(Xg), "userFeatures": sp.csr_matrix(
            Xe)}, {"userId": ids}, y)

    train = make(n_train, n_users, sparse_re=True)
    val = make(n_val, n_users + 5, sparse_re=False)
    val[1]["userId"][:7] = None
    return train, val


def _configs(mod, Config, Opt, Reg, reg_fixed=0.5, reg_user=0.5,
             **re_kw):
    opt = Config(optimizer=Opt(max_iters=40, tolerance=1e-7),
                 regularization=Reg.l2())
    return {
        "fixed": mod.FixedEffectCoordinateConfig(
            feature_shard="global", optimization=opt, reg_weight=reg_fixed),
        "per_user": mod.RandomEffectCoordinateConfig(
            feature_shard="userFeatures", entity_key="userId",
            optimization=opt, reg_weight=reg_user, **re_kw),
    }


def _port_configs(**kw):
    return _configs(estimator, GlmOptimizationConfig, OptimizerConfig,
                    RegularizationContext, **kw)


def _ref_configs(**kw):
    return _configs(ref_est, RefConfig, RefOpt, RefReg, **kw)


def _within(got, want, rtol=SCORE_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rtol * scale


class TestValidationScorers:
    def test_fixed_scorer_runs_the_kernel_matrix_and_matches(self):
        (_, _, _), (v_shards, _, _) = _split_problem(0)
        rng = np.random.default_rng(1)
        w = rng.normal(size=5).astype(np.float32)
        scorer = FixedEffectValidationScorer(v_shards["global"], device=CPU)
        # The kernel-backed CSR/CSC matrix (its plain version on the CPU),
        # not the COO matrix.
        assert isinstance(scorer._features, CudaSparseMatrix)
        got = scorer.score(torch.as_tensor(w)).numpy()
        want = np.asarray(RefFixedScorer(v_shards["global"]).score(
            jnp.asarray(w)))
        _within(got, want)
        dense = FixedEffectValidationScorer(
            v_shards["global"].toarray(), device=CPU)
        _within(dense.score(torch.as_tensor(w)).numpy(), want)

    @pytest.mark.parametrize("growth", [2.0, 4.0])
    def test_random_scorer_matches_reference(self, growth):
        (tr, tr_ids, tr_y), (v_shards, v_ids, _) = _split_problem(2)
        n = len(tr_y)
        kw = dict(bucket_growth=growth)
        ds = build_random_effect_dataset(
            tr_ids["userId"], tr["userFeatures"], tr_y,
            np.ones(n, np.float32), device=CPU, **kw)
        ref_ds = ref_build_re(tr_ids["userId"], tr["userFeatures"], tr_y,
                              np.ones(n, np.float32), **kw)
        rng = np.random.default_rng(3)
        state = [rng.normal(size=(b.n_entities, b.block_dim)).astype(
            np.float32) for b in ds.blocks]
        # The reference raises on id-less validation rows; compare where it
        # runs, and hold those rows to 0 in the port.
        has_id = np.array([k is not None for k in v_ids["userId"]])
        scorer = RandomEffectValidationScorer(
            ds, v_ids["userId"], v_shards["userFeatures"], device=CPU)
        got = scorer.score(convert.game_states_from_numpy(
            {"s": state}, device=CPU)["s"]).numpy()
        rows = np.flatnonzero(has_id)
        ref = RefRandomScorer(ref_ds, v_ids["userId"][rows],
                              v_shards["userFeatures"][rows])
        want = np.asarray(ref.score([jnp.asarray(s) for s in state]))
        _within(got[rows], want)
        assert np.all(got[~has_id] == 0.0)
        # Users seen only in validation score exactly 0.
        unseen = np.array([k is not None and k not in ds.entity_to_slot
                           for k in v_ids["userId"]])
        assert unseen.any() and np.all(got[unseen] == 0.0)
        again = scorer.score(convert.game_states_from_numpy(
            {"s": state}, device=CPU)["s"]).numpy()
        np.testing.assert_array_equal(got, again)

    def test_all_new_entities_and_a_missing_column_score_zero(self):
        (tr, tr_ids, tr_y), (v_shards, v_ids, v_y) = _split_problem(4)
        est = estimator.GameEstimator("logistic", _port_configs(),
                                      device=CPU)
        coords = est.build_coordinates(tr, tr_ids, tr_y)
        re_coord = coords[1]
        state = re_coord.train(torch.zeros(len(tr_y)))
        new_ids = {"userId": np.array([f"zz{i}" for i in range(len(v_y))])}
        scorer = re_coord.make_validation_scorer(v_shards, new_ids)
        np.testing.assert_array_equal(scorer.score(state).numpy(), 0.0)
        # A validation file with no rows carrying the id column at all.
        scorer = re_coord.make_validation_scorer(v_shards, {})
        np.testing.assert_array_equal(scorer.score(state).numpy(), 0.0)


# -- per-update validation, the grid and the transformer -------------------


@pytest.fixture(scope="module")
def problem():
    return _split_problem(7)


def _ref_val(val):
    """The reference's validation set: its scorer raises on id-less rows,
    so drop them for the reference side of a comparison."""
    shards, ids, y = val
    keep = np.array([k is not None for k in ids["userId"]])
    return ({k: m[np.flatnonzero(keep)] for k, m in shards.items()},
            {"userId": ids["userId"][keep]}, y[keep])


class TestPerIterationValidation:
    def _fit(self, problem, device_metrics, ref=False):
        (tr, tr_ids, tr_y), val = problem
        specs = ["auc", "logistic_loss"]
        if ref:
            return ref_est.GameEstimator(
                "logistic", _ref_configs(), n_iterations=2,
                device_metrics=device_metrics).fit(
                    tr, tr_ids, tr_y, validation=_ref_val(val),
                    suite=RefSuite.from_specs(specs))
        return estimator.GameEstimator(
            "logistic", _port_configs(), n_iterations=2,
            device_metrics=device_metrics, device=CPU).fit(
                tr, tr_ids, tr_y, validation=_ref_val(val),
                suite=EvaluationSuite.from_specs(specs))

    @pytest.mark.parametrize("device_metrics", [False, True])
    def test_history_carries_validation_suite(self, problem, device_metrics):
        model, history = self._fit(problem, device_metrics)
        _, ref_history = self._fit(problem, device_metrics, ref=True)
        assert len(history) == len(ref_history) == 4
        for entry, ref_entry in zip(history, ref_history):
            assert entry["coordinate"] == ref_entry["coordinate"]
            assert set(entry["validation"]) == {"auc", "logistic_loss"}
            assert entry["validation_metric"] == entry["validation"]["auc"]
            for k, v in ref_entry["validation"].items():
                assert entry["validation"][k] == pytest.approx(
                    v, abs=FIT_TOL)
        # The random effect helps on the validation rows.
        assert history[-1]["validation_metric"] > \
            history[0]["validation_metric"]

    def test_device_metrics_equal_host_metrics(self, problem):
        _, host = self._fit(problem, False)
        _, dev = self._fit(problem, True)
        for h, d in zip(host, dev):
            assert d["validation"]["auc"] == pytest.approx(
                h["validation"]["auc"], abs=1e-9)
            assert d["validation"]["logistic_loss"] == pytest.approx(
                h["validation"]["logistic_loss"], rel=2e-5)

    def test_incremental_scores_equal_a_full_rescore(self, problem):
        """The last update's validation metric is the suite on base + the
        sum of every coordinate's scorer at its final state: the
        incremental refresh sums what a full re-score sums, bitwise."""
        (tr, tr_ids, tr_y), (v_shards, v_ids, v_y) = problem
        est = estimator.GameEstimator("logistic", _port_configs(),
                                      n_iterations=2, device=CPU)
        coords = est.build_coordinates(tr, tr_ids, tr_y)
        seen = {}

        class Spy:
            def __init__(self, inner, name):
                self.inner, self.name = inner, name

            def score(self, state):
                seen[self.name] = state
                return self.inner.score(state)

        scorers = {c.name: Spy(c.make_validation_scorer(v_shards, v_ids),
                               c.name) for c in coords}
        suite = EvaluationSuite.from_specs(["auc", "logistic_loss"])
        _, history = est.fit_coordinates(
            coords, tr_y, validation=(v_shards, v_ids, v_y), suite=suite,
            validation_scorers=scorers)
        total = np.zeros(len(v_y), np.float32) + np.sum(
            [scorers[c.name].inner.score(seen[c.name]).numpy()
             for c in coords], axis=0)
        assert suite.evaluate(total, v_y) == history[-1]["validation"]

    def test_validation_scorer_matches_transformer(self, problem):
        (tr, tr_ids, tr_y), (v_shards, v_ids, v_y) = problem
        model, history = estimator.GameEstimator(
            "logistic", _port_configs(), n_iterations=2, device=CPU).fit(
                tr, tr_ids, tr_y, validation=(v_shards, v_ids, v_y))
        t_scores = estimator.GameTransformer(model).transform(v_shards,
                                                              v_ids)
        assert history[-1]["validation_metric"] == pytest.approx(
            evaluators.AreaUnderROCCurveEvaluator().evaluate(t_scores, v_y),
            abs=1e-6)

    def test_grouped_suite_and_device_metrics(self, problem):
        (tr, tr_ids, tr_y), (v_shards, v_ids, v_y) = problem
        g_tr = {**tr_ids, "queryId": np.arange(len(tr_y)) % 20}
        g_val = {**v_ids, "queryId": np.arange(len(v_y)) % 20}
        suite = EvaluationSuite.from_specs(["auc", "precision@2"],
                                           group_column="queryId")
        _, history = estimator.GameEstimator(
            "logistic", _port_configs(), n_iterations=1, device=CPU).fit(
                tr, g_tr, tr_y, validation=(v_shards, g_val, v_y),
                suite=suite)
        assert set(history[-1]["validation"]) == {"auc", "precision@2"}
        assert 0.5 < history[-1]["train_metric"] <= 1.0
        with pytest.raises(ValueError, match="GLOBAL"):
            estimator.GameEstimator(
                "logistic", _port_configs(), device_metrics=True,
                device=CPU).fit(tr, g_tr, tr_y, suite=suite)


class TestConfigGrid:
    def test_grid_selects_best_by_validation(self, problem):
        (tr, tr_ids, tr_y), val = problem
        grid = [_port_configs(reg_fixed=1e6, reg_user=1e6), _port_configs()]
        _, results = estimator.GameEstimator(
            "logistic", _port_configs(), n_iterations=2, device=CPU
        ).fit_grid(grid, tr, tr_ids, tr_y, validation=_ref_val(val))
        _, ref_results = ref_est.GameEstimator(
            "logistic", _ref_configs(), n_iterations=2).fit_grid(
                [_ref_configs(reg_fixed=1e6, reg_user=1e6), _ref_configs()],
                tr, tr_ids, tr_y, validation=_ref_val(val))
        assert [r["best"] for r in results] == [False, True]
        assert [r["best"] for r in ref_results] == [False, True]
        for r, rr in zip(results, ref_results):
            assert r["selected_by"] == rr["selected_by"] == \
                "validation_metric"
            assert r["metric"] == pytest.approx(rr["metric"], abs=FIT_TOL)

    def test_grid_shares_datasets_and_scorers(self, problem):
        (tr, tr_ids, tr_y), val = problem
        est = estimator.GameEstimator("logistic", _port_configs(),
                                      n_iterations=1, device=CPU)
        cache: dict = {}
        a = est._build_coordinates(_port_configs(reg_fixed=0.1), tr, tr_ids,
                                   tr_y, None, None, dataset_cache=cache)
        b = est._build_coordinates(_port_configs(reg_fixed=10.0), tr,
                                   tr_ids, tr_y, None, None,
                                   dataset_cache=cache)
        assert a[0].dataset is b[0].dataset and a[1].dataset is b[1].dataset
        built = []
        orig = estimator.RandomEffectCoordinate.make_validation_scorer

        def counting(self, shards, ids):
            built.append(self.name)
            return orig(self, shards, ids)

        estimator.RandomEffectCoordinate.make_validation_scorer = counting
        try:
            est.fit_grid([_port_configs(reg_user=r) for r in (0.1, 1.0,
                                                              10.0)],
                         tr, tr_ids, tr_y, validation=_ref_val(val))
        finally:
            estimator.RandomEffectCoordinate.make_validation_scorer = orig
        assert built == ["per_user"]

    def test_grid_without_validation_selects_by_train(self, problem):
        (tr, tr_ids, tr_y), _ = problem
        _, results = estimator.GameEstimator(
            "logistic", _port_configs(), n_iterations=1, device=CPU
        ).fit_grid([_port_configs(reg_fixed=1e6, reg_user=1e6),
                    _port_configs()], tr, tr_ids, tr_y)
        assert results[0]["selected_by"] == "train_metric"
        assert results[1]["best"]

    def test_grid_checkpointer_resumes_completed_points(self, problem,
                                                        tmp_path):
        from photon_ml_tpu_torch.io.checkpoint import GameGridCheckpointer

        (tr, tr_ids, tr_y), val = problem
        maps = {"global": {f"g{i}": i for i in range(5)},
                "userFeatures": {f"h{i}": i for i in range(3)}}
        from photon_ml_tpu_torch.data.index_map import IndexMap

        maps = {k: IndexMap(v) for k, v in maps.items()}
        grid = [_port_configs(reg_user=r) for r in (0.5, 2.0)]
        est = estimator.GameEstimator("logistic", _port_configs(),
                                      n_iterations=1, device=CPU)
        ck = GameGridCheckpointer(str(tmp_path), maps, device=CPU)
        _, first = est.fit_grid(grid, tr, tr_ids, tr_y,
                                validation=_ref_val(val),
                                grid_checkpointer=ck)
        _, again = est.fit_grid(grid, tr, tr_ids, tr_y,
                                validation=_ref_val(val),
                                grid_checkpointer=ck)
        assert all(r.get("resumed") for r in again)
        assert [r["metric"] for r in again] == [r["metric"] for r in first]
        assert [r["best"] for r in again] == [r["best"] for r in first]


class TestTransformer:
    def _model_pair(self, problem, tmp_path):
        """One trained model, saved by the port and loaded by both."""
        from photon_ml_tpu.io.game_store import load_game_model as ref_load
        from photon_ml_tpu_torch.data.index_map import IndexMap
        from photon_ml_tpu_torch.io.game_store import (
            load_game_model,
            save_game_model,
        )

        (tr, tr_ids, tr_y), _ = problem
        model, _ = estimator.GameEstimator(
            "logistic", _port_configs(), n_iterations=2, device=CPU).fit(
                tr, tr_ids, tr_y)
        maps = {"global": IndexMap.build([f"g{i}" for i in range(5)]),
                "userFeatures": IndexMap.build([f"h{i}" for i in range(3)])}
        save_game_model(model, maps, str(tmp_path / "m"))
        return (load_game_model(str(tmp_path / "m"), device=CPU)[0],
                ref_load(str(tmp_path / "m"))[0])

    def test_transform_matches_reference(self, problem, tmp_path):
        port, ref = self._model_pair(problem, tmp_path)
        _, (v_shards, v_ids, v_y) = problem
        offset = np.linspace(-1, 1, len(v_y)).astype(np.float32)
        got = estimator.GameTransformer(port).transform(v_shards, v_ids,
                                                        offset)
        want = ref_est.GameTransformer(ref).transform(v_shards, v_ids,
                                                      offset)
        _within(got, want)
        # Id-less rows and users unseen in training get the fixed effect
        # and the offset only.
        fixed_only = estimator.GameTransformer(
            estimator.GameModel(models={"fixed": port.models["fixed"]},
                                task="logistic")).transform(
                                    v_shards, v_ids, offset)
        miss = np.array([k is None or k not in port.models[
            "per_user"].coefficients for k in v_ids["userId"]])
        assert miss.any()
        np.testing.assert_array_equal(got[miss], fixed_only[miss])
        got_mean = estimator.GameTransformer(port).transform_with_mean(
            v_shards, v_ids, offset)
        want_mean = ref_est.GameTransformer(ref).transform_with_mean(
            v_shards, v_ids, offset)
        _within(got_mean, want_mean)

    def test_file_without_the_id_column_scores_fixed_effect_only(
            self, problem, tmp_path):
        port, ref = self._model_pair(problem, tmp_path)
        _, (v_shards, _, v_y) = problem
        got = estimator.GameTransformer(port).transform(v_shards, {})
        want = ref_est.GameTransformer(ref).transform(v_shards, {})
        _within(got, want)
        fixed = v_shards["global"] @ port.models[
            "fixed"].model.coefficients.means.numpy()
        np.testing.assert_array_equal(got, fixed.astype(np.float32))

    def test_prepared_set_and_weakref_cache(self, problem, tmp_path):
        port, _ = self._model_pair(problem, tmp_path)
        _, (v_shards, v_ids, _) = problem
        t = estimator.GameTransformer(port)
        ids = {"userId": v_ids["userId"].copy()}
        first = t.transform(v_shards, ids)
        cached = t._cache[2]
        np.testing.assert_array_equal(t.transform(v_shards, ids), first)
        assert t._cache[2] is cached  # same objects: grouping reused
        prepared = t.prepare(v_shards, ids)
        np.testing.assert_array_equal(
            t.transform(v_shards, ids, prepared=prepared), first)
        with pytest.raises(ValueError, match="prepare"):
            t.transform({k: m[:5] for k, m in v_shards.items()},
                        {"userId": ids["userId"][:5]}, prepared=prepared)
        # Replacing a column misses the cache; the dying array clears it.
        ids["userId"] = ids["userId"].copy()
        assert t._cache is None
        t.transform(v_shards, ids)
        assert t._cache is not None and t._cache[2] is not cached
