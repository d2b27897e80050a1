"""The port's factored random effect against the JAX package's, on the CPU.

Both packages draw V₀ the same way, so the same data trains from the same
point.  The latent step's batched Newton and the projection step's L-BFGS
over vec(V) run in float32 in both, with different summation orders: three
iterations a solve agree within 1e-5 of the largest coefficient, and whole
fits (25 iterations, several alternations) stop on float32's noise floor
and agree within 2e-3 (the tolerance of ``test_torch_game.py``).  The
projection gradient equals a float64 recompute within 1e-5 and repeats
bitwise.  The reference's ``TestFactoredCoordinate`` cases, the estimator's
factored branches, a CD checkpoint of ``(u_list, V)`` read by the other
package, and ``convert.game_states_from_numpy`` run here.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.data.dataset import make_glm_data as ref_make_glm_data
from photon_ml_tpu.game import data as ref_data
from photon_ml_tpu.game import estimator as ref_est
from photon_ml_tpu.game.coordinates import (
    FixedEffectCoordinate as RefFixed,
)
from photon_ml_tpu.game.descent import CoordinateDescent as RefCD
from photon_ml_tpu.game.factored import (
    FactoredRandomEffectCoordinate as RefFactored,
)
from photon_ml_tpu.io import checkpoint as ref_ckpt
from photon_ml_tpu.optim.problem import (
    GlmOptimizationConfig as RefConfig,
    OptimizerConfig as RefOpt,
)
from photon_ml_tpu.optim.regularization import (
    RegularizationContext as RefReg,
)
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.game import coordinates, data, estimator
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.game.factored import (
    FactoredRandomEffectCoordinate,
    SortedSegmentSum,
)
from photon_ml_tpu_torch.io import checkpoint
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    OptimizerConfig,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext

sys.path.insert(0, os.path.dirname(__file__))
from test_factored import _rank1_problem  # noqa: E402
from test_torch_game import _game_problem  # noqa: E402
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = "cpu"
FIT_TOL = 2e-3


def _cfgs(max_iters=25, tol=1e-8):
    return (
        GlmOptimizationConfig(
            optimizer=OptimizerConfig(max_iters=max_iters, tolerance=tol),
            regularization=RegularizationContext.l2()),
        RefConfig(optimizer=RefOpt(max_iters=max_iters, tolerance=tol),
                  regularization=RefReg.l2()),
    )


def _pair(users, X, y, cfgs=None, **kw):
    """The same factored coordinate in both packages."""
    cfg, rcfg = cfgs or _cfgs()
    w = np.ones(len(y), np.float32)
    Xs = sp.csr_matrix(X)
    ds = data.build_random_effect_dataset(users, Xs, y, w, device=CPU)
    rds = ref_data.build_random_effect_dataset(users, Xs, y, w)
    kw.setdefault("entity_key", "userId")
    return (FactoredRandomEffectCoordinate("fre", ds, "logistic", cfg, **kw),
            RefFactored("fre", rds, "logistic", rcfg, **kw))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _states_close(state, rstate, tol):
    (u, V), (ru, rV) = state, rstate
    _close(V.numpy(), np.asarray(rV), tol)
    for a, b in zip(u, ru):
        _close(a.numpy(), np.asarray(b), tol)


def _auc(y, s):
    from sklearn.metrics import roc_auc_score

    return roc_auc_score(y, s)


class TestFactoredCoordinate:
    """The reference's ``TestFactoredCoordinate`` through both packages."""

    def test_same_start_and_few_iterations_match_tightly(self, rng):
        users, X, y, _ = _rank1_problem(rng, n_entities=40, rows=5, d=10)
        port, ref = _pair(users, X, y, _cfgs(max_iters=3), rank=2,
                          reg_weight=0.3, alternations=2)
        np.testing.assert_array_equal(port._v0.numpy(), np.asarray(ref._v0))
        off = (rng.normal(size=len(y)) * 0.3).astype(np.float32)
        state = port.train(torch.as_tensor(off))
        rstate = ref.train(jnp.asarray(off))
        _states_close(state, rstate, 1e-5)
        np.testing.assert_allclose(port.score(state).numpy(),
                                   np.asarray(ref.score(rstate)),
                                   rtol=1e-5, atol=1e-6)
        rec = port.last_train
        assert len(rec["latent"]) == len(rec["projection"]) == 2
        assert all(r.iterations <= 3 for r in rec["projection"])

    def test_rank1_recovers_shared_direction(self, rng):
        users, X, y, v_true = _rank1_problem(rng)
        port, ref = _pair(users, X, y, rank=1, reg_weight=0.1,
                          alternations=3)
        state = port.train(torch.zeros(len(y)))
        rstate = ref.train(jnp.zeros(len(y), jnp.float32))
        v = state[1].numpy()[:, 0]
        cos = abs(v @ v_true / max(np.linalg.norm(v)
                                   * np.linalg.norm(v_true), 1e-12))
        assert cos > 0.8, cos
        _states_close(state, rstate, FIT_TOL)

    def test_full_rank_matches_plain_random_effect_quality(self, rng):
        users, X, y, _ = _rank1_problem(rng, n_entities=40, rows=10, d=6)
        port, ref = _pair(users, X, y, rank=6, reg_weight=0.5,
                          alternations=3)
        plain = coordinates.RandomEffectCoordinate(
            "re", port.dataset, "logistic", _cfgs()[0], reg_weight=0.5,
            entity_key="userId")
        base = torch.zeros(len(y))
        s_plain = plain.score(plain.train(base)).numpy()
        s_fact = port.score(port.train(base)).numpy()
        assert _auc(y, s_fact) > _auc(y, s_plain) - 0.03
        r_fact = np.asarray(ref.score(ref.train(jnp.zeros(len(y),
                                                          jnp.float32))))
        _close(s_fact, r_fact, FIT_TOL)

    def test_low_rank_beats_independent_fits_on_sparse_entities(self, rng):
        users, X, y, _ = _rank1_problem(rng, n_entities=120, rows=8, d=10)
        idx = np.arange(len(y)).reshape(120, 8)
        tr, te = idx[:, :4].ravel(), idx[:, 4:].ravel()
        port, ref = _pair(users[tr], X[tr], y[tr], rank=1, reg_weight=1.0,
                          alternations=6)
        plain = coordinates.RandomEffectCoordinate(
            "re", port.dataset, "logistic", _cfgs()[0], reg_weight=1.0,
            entity_key="userId")
        base = torch.zeros(len(tr))
        m_plain = plain.finalize(plain.train(base))
        m_fact = port.finalize(port.train(base))
        r_fact = ref.finalize(ref.train(jnp.zeros(len(tr), jnp.float32)))

        def score(model):
            out = np.zeros(len(te))
            for j, i in enumerate(te):
                ent = model.coefficients.get(users[i])
                if ent is not None:
                    out[j] = float(np.sum(X[i][ent[0]] * ent[1]))
            return out

        auc_fact = _auc(y[te], score(m_fact))
        assert auc_fact > _auc(y[te], score(m_plain)) + 0.02
        assert abs(auc_fact - _auc(y[te], score(r_fact))) <= 0.01

    def test_finalize_matches_score_on_training_rows(self, rng):
        users, X, y, _ = _rank1_problem(rng, n_entities=30, rows=5, d=8)
        port, ref = _pair(users, X, y, rank=2, reg_weight=0.3,
                          alternations=2)
        state = port.train(torch.zeros(len(y)))
        scores = port.score(state).numpy()
        model = port.finalize(state)
        assert model.variances is None
        for i in range(len(y)):
            cols, vals = model.coefficients[users[i]]
            np.testing.assert_allclose(float(np.sum(X[i][cols] * vals)),
                                       scores[i], rtol=1e-5, atol=1e-6)
        rmodel = ref.finalize(ref.train(jnp.zeros(len(y), jnp.float32)))
        assert set(model.coefficients) == set(rmodel.coefficients)
        for k, (cols, vals) in model.coefficients.items():
            np.testing.assert_array_equal(cols, rmodel.coefficients[k][0])

    def test_warm_start_and_cd_integration(self, rng):
        users, X, y, _ = _rank1_problem(rng, n_entities=50, rows=4, d=8)
        n = len(y)
        w = np.ones(n, np.float32)
        Xg = sp.csr_matrix(rng.normal(size=(n, 16)).astype(np.float32))
        cfg, rcfg = _cfgs()
        fixed = coordinates.FixedEffectCoordinate(
            "fixed", data.FixedEffectDataset(
                make_glm_data(Xg, y, device=CPU), n),
            "logistic", cfg, reg_weight=0.5)
        rfixed = RefFixed("fixed", ref_data.FixedEffectDataset(
            ref_make_glm_data(Xg, y), n), "logistic", rcfg, reg_weight=0.5)
        port, ref = _pair(users, X, y, rank=2, reg_weight=0.5,
                          alternations=1)
        res = CoordinateDescent([fixed, port]).run(torch.zeros(n),
                                                   n_iterations=2)
        rres = RefCD([rfixed, ref]).run(jnp.zeros(n, jnp.float32),
                                        n_iterations=2)
        total = (res.scores["fixed"] + res.scores["fre"]).numpy()
        assert np.all(np.isfinite(total))
        _close(total, np.asarray(rres.scores["fixed"] + rres.scores["fre"]),
               FIT_TOL)
        st = res.states["fre"]
        st2 = port.train(res.scores["fixed"], warm_state=st)
        assert len(st2) == 2 and len(st2[0]) == len(st[0])
        # A repeated descent is bitwise equal.
        again = CoordinateDescent([fixed, port]).run(torch.zeros(n),
                                                     n_iterations=2)
        assert torch.equal(again.scores["fre"], res.scores["fre"])
        assert torch.equal(again.states["fre"][1], st[1])

    def test_bad_rank_raises(self, rng):
        users, X, y, _ = _rank1_problem(rng, n_entities=5, rows=3, d=4)
        ds = data.build_random_effect_dataset(
            users, sp.csr_matrix(X), y, np.ones(len(y), np.float32),
            device=CPU)
        with pytest.raises(ValueError, match="rank"):
            FactoredRandomEffectCoordinate("fre", ds, "logistic",
                                           _cfgs()[0], rank=0)


class TestProjectionGradient:
    def test_matches_float64_recompute_and_reference(self, rng):
        users, X, y, _ = _rank1_problem(rng, n_entities=30, rows=6, d=9)
        port, ref = _pair(users, X, y, rank=3, reg_weight=0.3,
                          projection_reg_weight=0.2)
        off = (rng.normal(size=len(y)) * 0.3).astype(np.float32)
        u_list = [torch.as_tensor(rng.normal(size=(b.n_entities, 3)).astype(
            np.float32)) for b in port.dataset.blocks]
        V = torch.as_tensor(rng.normal(size=(9, 3)).astype(np.float32))
        offs = port.block_offsets(torch.as_tensor(off))
        val, g = port.projection_value_grad(V.reshape(-1), offs, u_list)
        val2, g2 = port.projection_value_grad(V.reshape(-1), offs, u_list)
        assert torch.equal(g, g2) and torch.equal(val, val2)
        # Float64 host recompute: w_e = V u_e per row's entity.
        V64, G = V.double().numpy(), np.zeros((9, 3))
        f = 0.5 * 0.2 * float((V64 ** 2).sum())
        slot = port.dataset.entity_to_slot
        for i in range(len(y)):
            b, lane = slot[users[i]]
            u = u_list[b][lane].double().numpy()
            m = float(X[i].astype(np.float64) @ (V64 @ u)) + float(off[i])
            f += float(np.logaddexp(0.0, m) - y[i] * m)
            G += np.outer(X[i].astype(np.float64),
                          u) * (1 / (1 + np.exp(-m)) - y[i])
        G += 0.2 * V64
        assert abs(float(val) - f) <= 1e-5 * abs(f)
        _close(g.numpy().reshape(9, 3), G, 1e-5)

    def test_sorted_segment_sum_is_exact_order_and_repeatable(self, rng):
        idx = rng.integers(-1, 40, size=3000)
        idx[:500] = 7  # one long segment: three levels of chunks
        rows = rng.normal(size=(3000, 2)).astype(np.float32)
        seg = SortedSegmentSum(idx, 41)
        assert len(seg.tables) >= 2
        got = seg(torch.as_tensor(rows))
        want = np.zeros((41, 2))
        np.add.at(want, idx[idx >= 0], rows[idx >= 0].astype(np.float64))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert torch.equal(seg(torch.as_tensor(rows)), got)
        assert float(got[40].abs().sum()) == 0.0 or (idx == 40).any()
        empty = SortedSegmentSum(np.full(4, -1), 3)
        assert torch.equal(empty(torch.ones(4, 2)), torch.zeros(3, 2))


def _estimators(cfg_kw=None, n_iterations=1):
    cfg, rcfg = _cfgs(max_iters=15, tol=1e-6)
    kw = dict(rank=2, reg_weight=1.0, **(cfg_kw or {}))
    port = estimator.GameEstimator("logistic", {
        "fixed": estimator.FixedEffectCoordinateConfig("global", cfg,
                                                       reg_weight=1.0),
        "user": estimator.FactoredRandomEffectCoordinateConfig(
            "user", "userId", optimization=cfg, **kw)},
        n_iterations=n_iterations, device=CPU)
    ref = ref_est.GameEstimator("logistic", {
        "fixed": ref_est.FixedEffectCoordinateConfig("global", rcfg,
                                                     reg_weight=1.0),
        "user": ref_est.FactoredRandomEffectCoordinateConfig(
            "user", "userId", optimization=rcfg, **kw)},
        n_iterations=n_iterations)
    return port, ref


def _models_close(model, rmodel, tol=FIT_TOL):
    _close(model["fixed"].model.coefficients.means.numpy(),
           np.asarray(rmodel["fixed"].model.coefficients.means), tol)
    table, rtable = model["user"].coefficients, rmodel["user"].coefficients
    assert set(table) == set(rtable)
    scale = max(float(np.abs(v).max()) for _, v in rtable.values())
    for k, (cols, vals) in table.items():
        np.testing.assert_array_equal(cols, rtable[k][0])
        assert np.abs(vals - rtable[k][1]).max() <= tol * scale


class TestEstimator:
    def test_factored_fit_matches_reference(self):
        shards, ids, y = _game_problem(15)
        port, ref = _estimators(n_iterations=2)
        coords = port.build_coordinates(shards, ids, y)
        assert isinstance(coords[1], FactoredRandomEffectCoordinate)
        model, hist = port.fit(shards, ids, y)
        rmodel, rhist = ref.fit(shards, ids, y)
        assert [h["coordinate"] for h in hist] == [h["coordinate"]
                                                   for h in rhist]
        for h, rh in zip(hist, rhist):
            assert h["train_metric"] == pytest.approx(rh["train_metric"],
                                                      abs=1e-4)
        _models_close(model, rmodel)

    def test_initial_model_starts_the_factored_coordinate_cold(self):
        shards, ids, y = _game_problem(16)
        port, ref = _estimators()
        model, _ = port.fit(shards, ids, y)
        coords = port.build_coordinates(shards, ids, y)
        states = port.initial_states_from_model(coords, model)
        assert "fixed" in states and "user" not in states
        warm, _ = port.fit(shards, ids, y, initial_model=model)
        rmodel, _ = ref.fit(shards, ids, y)
        rwarm, _ = ref.fit(shards, ids, y, initial_model=rmodel)
        _models_close(warm, rwarm)

    def test_locked_factored_rejected_up_front(self):
        shards, ids, y = _game_problem(17)
        port, _ = _estimators()
        model, _ = port.fit(shards, ids, y)
        with pytest.raises(ValueError, match="not reconstructible"):
            port.fit(shards, ids, y, initial_model=model,
                     locked_coordinates=("user",))

    def test_plain_and_factored_share_the_dataset_and_grid(self):
        shards, ids, y = _game_problem(18)
        cfg, _ = _cfgs(max_iters=10, tol=1e-6)
        plain = estimator.RandomEffectCoordinateConfig("user", "userId", cfg,
                                                       reg_weight=1.0)
        fact = estimator.FactoredRandomEffectCoordinateConfig(
            "user", "userId", rank=2, optimization=cfg, reg_weight=1.0)
        est = estimator.GameEstimator("logistic", {"user": plain},
                                      device=CPU)
        assert est.dataset_key(plain) == est.dataset_key(fact)
        v_shards, v_ids, v_y = _game_problem(19)
        best, points = est.fit_grid([{"user": plain}, {"user": fact}],
                                    shards, ids, y,
                                    validation=(v_shards, v_ids, v_y))
        assert len(points) == 2 and sum(p["best"] for p in points) == 1
        assert all(np.isfinite(p["metric"]) for p in points)

    def test_grid_fingerprint_equals_the_reference(self):
        from photon_ml_tpu_torch.drivers import game_training_driver
        from photon_ml_tpu.drivers import game_training_driver as ref_drv

        specs = [{"name": "per_item", "type": "factored_random",
                  "feature_shard": "itemFeatures", "entity_key": "itemId",
                  "rank": 8, "alternations": 2,
                  "projection_reg_weight": 0.1, "reg_type": "l2",
                  "reg_weight": 1.0}]
        port = game_training_driver.expand_config_grid(specs)[0]
        ref = ref_drv.expand_config_grid(specs)[0]
        assert checkpoint.GameGridCheckpointer.fingerprint(port) == \
            ref_ckpt.GameGridCheckpointer.fingerprint(ref)


class TestCheckpointAndConvert:
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_cd_checkpoint_of_factored_state_crosses_packages(self, tmp_path,
                                                              writer):
        rng = np.random.default_rng(3)
        u_list = [rng.normal(size=(4, 2)).astype(np.float32),
                  rng.normal(size=(1, 2)).astype(np.float32)]
        V = rng.normal(size=(6, 2)).astype(np.float32)
        w = rng.normal(size=5).astype(np.float32)
        total = rng.normal(size=9).astype(np.float32)
        scores = {"fixed": total * 0.5, "fre": total * 0.25}
        states = {"fixed": w, "fre": (u_list, V)}
        d = str(tmp_path)
        if writer == "port":
            st = convert.game_states_from_numpy(states, device=CPU)
            checkpoint.CoordinateDescentCheckpointer(d).save(
                1, torch.as_tensor(total),
                {k: torch.as_tensor(v) for k, v in scores.items()}, st,
                [{"iteration": 0}])
            loaded = ref_ckpt.CoordinateDescentCheckpointer(d).load()
        else:
            ref_ckpt.CoordinateDescentCheckpointer(d).save(
                1, jnp.asarray(total),
                {k: jnp.asarray(v) for k, v in scores.items()},
                {"fixed": jnp.asarray(w),
                 "fre": ([jnp.asarray(u) for u in u_list], jnp.asarray(V))},
                [{"iteration": 0}])
            loaded = checkpoint.CoordinateDescentCheckpointer(d).load()
        assert loaded["iteration"] == 1
        lu, lV = loaded["states"]["fre"]
        np.testing.assert_array_equal(np.asarray(lV), V)
        for a, b in zip(lu, u_list):
            np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(np.asarray(loaded["states"]["fixed"]),
                                      w)

    def test_game_states_from_numpy_carries_factored_state(self):
        rng = np.random.default_rng(4)
        u_list = [jnp.asarray(rng.normal(size=(3, 2))),
                  np.ones((1, 2), np.float64)]
        V = rng.normal(size=(5, 2))
        st = convert.game_states_from_numpy(
            {"fre": (u_list, V), "re": [np.ones((2, 3))], "none": None},
            device=CPU)
        u, v = st["fre"]
        assert isinstance(st["fre"], tuple) and isinstance(u, list)
        assert [t.shape for t in u] == [(3, 2), (1, 2)]
        assert v.shape == (5, 2) and v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), V.astype(np.float32))
        assert st["re"][0].shape == (2, 3) and st["none"] is None

    def test_resume_from_a_reference_checkpoint_is_the_ports_run(
            self, tmp_path, rng):
        """A descent killed after iteration 0 and resumed from a checkpoint
        the port wrote equals the uninterrupted run bitwise."""
        users, X, y, _ = _rank1_problem(rng, n_entities=20, rows=4, d=6)
        port, _ = _pair(users, X, y, _cfgs(max_iters=8), rank=2,
                        reg_weight=0.5, alternations=1)
        n = len(y)
        full = CoordinateDescent([port]).run(torch.zeros(n), n_iterations=2)
        ck = checkpoint.CoordinateDescentCheckpointer(str(tmp_path))
        CoordinateDescent([port]).run(torch.zeros(n), n_iterations=1,
                                      checkpointer=ck)
        resumed = CoordinateDescent([port]).run(torch.zeros(n),
                                                n_iterations=2,
                                                checkpointer=ck)
        assert torch.equal(resumed.scores["fre"], full.scores["fre"])
        assert torch.equal(resumed.states["fre"][1], full.states["fre"][1])
