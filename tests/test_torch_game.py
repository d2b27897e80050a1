"""GAME coordinate descent and the estimator's resident fit: the port against
the JAX package on the CPU, plus the port's own bitwise properties.

Both packages train the same seeded data from the same starting states
(``convert.game_states_from_numpy``).  The fixed effect's L-BFGS sums its
value in float32 and stops where that sum can no longer resolve a decrease:
one ulp of a value f is a change of ½·c·δw² for curvature c ≈ f, so the
two packages' solutions may differ by up to √(2⁻²³) ≈ 3.5e-4 of the
coefficients, and the random effects then train on offsets that differ by
as much.  So per-row scores and coefficients are held within 2e-3 of their
largest magnitude, the history's ``score_norm`` within 2e-3 relative and
train AUCs within 1e-4, and the history's order is identical.  (The block
solvers alone agree within 1e-5: ``test_torch_game_solvers.py``.)  Inside
the port, a repeated run, the pipelined schedule and a checkpoint resume
are bitwise equal to the plain run.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.data.dataset import make_glm_data as ref_make_glm_data
from photon_ml_tpu.game import coordinates as ref_coords
from photon_ml_tpu.game import data as ref_data
from photon_ml_tpu.game import estimator as ref_est
from photon_ml_tpu.game.descent import CoordinateDescent as RefCD
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
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    OptimizerConfig,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = "cpu"
TOL = 2e-3
AUC_TOL = 1e-4


def _cfgs(max_iters=15, tol=1e-6, variances=False):
    return (
        GlmOptimizationConfig(
            optimizer=OptimizerConfig(max_iters=max_iters, tolerance=tol),
            regularization=RegularizationContext.l2(),
            compute_variances=variances),
        RefConfig(
            optimizer=RefOpt(max_iters=max_iters, tolerance=tol),
            regularization=RefReg.l2(), compute_variances=variances),
    )


def _game_problem(seed, n_effects=1, n=700, d_global=6, d_re=3):
    """Rows with a global effect and ``n_effects`` zipf-tailed entity
    effects (user, item, context), each with its own dense features."""
    rng = np.random.default_rng(seed)
    Xg = rng.normal(size=(n, d_global)).astype(np.float32)
    margin = Xg @ rng.normal(size=d_global)
    shards = {"global": sp.csr_matrix(Xg)}
    ids = {}
    for k, (name, n_ent) in enumerate((("user", 40), ("item", 25),
                                       ("context", 4))[:n_effects]):
        p = 1.0 / np.arange(1, n_ent + 1) ** 1.2
        ent = rng.choice(n_ent, size=n, p=p / p.sum())
        Xe = rng.normal(size=(n, d_re)).astype(np.float32)
        W = rng.normal(size=(n_ent, d_re)) * 1.5
        margin = margin + (Xe * W[ent]).sum(1)
        shards[name] = sp.csr_matrix(Xe)
        ids[name + "Id"] = np.array([f"{name[0]}{e}" for e in ent])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return shards, ids, y


def _coordinates(shards, ids, y, caps=None, reg=1.0):
    """The same coordinates in both packages: (port list, reference list)."""
    cfg, rcfg = _cfgs()
    n = len(y)
    w = np.ones(n, np.float32)
    port = [coordinates.FixedEffectCoordinate(
        "fixed", data.FixedEffectDataset(
            make_glm_data(shards["global"], y, device=CPU), n),
        "logistic", cfg, reg_weight=reg)]
    ref = [ref_coords.FixedEffectCoordinate(
        "fixed", ref_data.FixedEffectDataset(
            ref_make_glm_data(shards["global"], y), n),
        "logistic", rcfg, reg_weight=reg)]
    for name in [k for k in shards if k != "global"]:
        key = name + "Id"
        cap = (caps or {}).get(name)
        ds = data.build_random_effect_dataset(
            ids[key], shards[name], y, w, max_rows_per_entity=cap,
            device=CPU)
        rds = ref_data.build_random_effect_dataset(
            ids[key], shards[name], y, w, max_rows_per_entity=cap)
        port.append(coordinates.RandomEffectCoordinate(
            name, ds, "logistic", cfg, reg_weight=reg, entity_key=key))
        ref.append(ref_coords.RandomEffectCoordinate(
            name, rds, "logistic", rcfg, reg_weight=reg, entity_key=key))
    return port, ref


def _random_states(port_coords, seed):
    rng = np.random.default_rng(seed)
    states = {}
    for c in port_coords:
        if isinstance(c, coordinates.FixedEffectCoordinate):
            states[c.name] = (0.1 * rng.normal(
                size=c.dataset.data.n_features)).astype(np.float32)
        else:
            states[c.name] = [(0.1 * rng.normal(
                size=(b.n_entities, b.block_dim))).astype(np.float32)
                for b in c.dataset.blocks]
    return states


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), scale)


def _assert_states_close(states, ref_states):
    for name, st in states.items():
        rst = ref_states[name]
        if isinstance(st, list):
            for a, b in zip(st, rst):
                _close(a.numpy(), np.asarray(b))
        else:
            _close(st.numpy(), np.asarray(rst))


def _equal_states(a, b):
    if isinstance(a, list):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


class TestCoordinateDescentParity:
    @pytest.mark.parametrize("n_effects,caps", [
        (1, None), (3, {"context": 40})], ids=["one-effect", "three-effects"])
    def test_matches_reference_from_the_same_states(self, n_effects, caps):
        shards, ids, y = _game_problem(n_effects, n_effects=n_effects)
        port, ref = _coordinates(shards, ids, y, caps)
        if caps:
            assert any(b is not None for b in
                       port[-1].dataset.passive_blocks)
        init = _random_states(port, seed=9)
        n = len(y)
        res = CoordinateDescent(port).run(
            torch.zeros(n), n_iterations=3,
            initial_states=convert.game_states_from_numpy(init, device=CPU))
        rres = RefCD(ref).run(
            jnp.zeros(n, jnp.float32), n_iterations=3,
            initial_states={k: (jnp.asarray(v) if not isinstance(v, list)
                                else [jnp.asarray(a) for a in v])
                            for k, v in init.items()})
        assert [(h["iteration"], h["coordinate"]) for h in res.history] == [
            (h["iteration"], h["coordinate"]) for h in rres.history]
        for h, rh in zip(res.history, rres.history):
            assert h["score_norm"] == pytest.approx(rh["score_norm"],
                                                    rel=TOL)
        for name in res.scores:
            _close(res.scores[name].numpy(), np.asarray(rres.scores[name]))
        _assert_states_close(res.states, rres.states)

    def test_bitwise_repeat_and_pipeline(self):
        shards, ids, y = _game_problem(3, n_effects=3)
        port, _ = _coordinates(shards, ids, y, {"context": 40})
        base = torch.zeros(len(y))
        a = CoordinateDescent(port).run(base, n_iterations=2)
        b = CoordinateDescent(port).run(base, n_iterations=2)
        c = CoordinateDescent(port, pipeline=True).run(base, n_iterations=2)
        for other in (b, c):
            for name in a.states:
                assert _equal_states(a.states[name], other.states[name])
                assert torch.equal(a.scores[name], other.scores[name])
            assert [h["score_norm"] for h in a.history] == [
                h["score_norm"] for h in other.history]

    def test_checkpoint_resume_is_bitwise(self):
        """A run stopped after iteration 0 and resumed through the
        checkpointer protocol ends where the uninterrupted run ends."""

        class MemoryCheckpointer:
            def __init__(self, stop_after=None):
                self.saved, self.stop_after = None, stop_after

            def load(self):
                return self.saved

            def save(self, it, total, scores, states, history, locked=()):
                self.saved = {
                    "iteration": it, "total": total.clone(),
                    "scores": {k: v.clone() for k, v in scores.items()},
                    "states": {k: ([s.clone() for s in v]
                                   if isinstance(v, list) else v.clone())
                               for k, v in states.items()},
                    "history": [dict(h) for h in history],
                    "locked": list(locked)}
                if it == self.stop_after:
                    raise KeyboardInterrupt

        shards, ids, y = _game_problem(4, n_effects=2)
        port, _ = _coordinates(shards, ids, y)
        base = torch.zeros(len(y))
        full = CoordinateDescent(port).run(base, n_iterations=3)
        ckpt = MemoryCheckpointer(stop_after=0)
        with pytest.raises(KeyboardInterrupt):
            CoordinateDescent(port).run(base, n_iterations=3,
                                        checkpointer=ckpt)
        ckpt.stop_after = None
        resumed = CoordinateDescent(port).run(base, n_iterations=3,
                                              checkpointer=ckpt)
        for name in full.states:
            assert _equal_states(full.states[name], resumed.states[name])
        assert [h["score_norm"] for h in full.history] == [
            h["score_norm"] for h in resumed.history]
        with pytest.raises(ValueError, match="locked coordinates"):
            CoordinateDescent(port).run(
                base, n_iterations=3, checkpointer=ckpt,
                initial_states={"fixed": full.states["fixed"]},
                locked=("fixed",))

    def test_history_flush_and_logger(self, tmp_path):
        from photon_ml_tpu_torch.utils.logging import PhotonLogger

        shards, ids, y = _game_problem(5)
        port, _ = _coordinates(shards, ids, y)
        base = torch.zeros(len(y))

        def eval_fn(it, name, scores, states):
            return {"flag": torch.tensor(True), "count": torch.tensor(it + 7),
                    "nested": {"m": scores[name].sum()}}

        quiet = CoordinateDescent(port).run(base, 2, eval_fn=eval_fn)
        with PhotonLogger(str(tmp_path)) as logger:
            logged = CoordinateDescent(port).run(base, 2, eval_fn=eval_fn,
                                                 logger=logger)
        for a, b in zip(quiet.history, logged.history):
            for key in ("score_norm", "count", "flag"):
                assert a[key] == b[key]
            assert type(a["score_norm"]) is float and a["flag"] is True
            assert type(a["count"]) is int and type(a["nested"]["m"]) is float
        assert [(h["iteration"], h["coordinate"]) for h in quiet.history] == [
            (0, "fixed"), (0, "user"), (1, "fixed"), (1, "user")]
        assert (tmp_path / "photon.log").read_text().count("score_norm") == 4

    def test_empty_and_locked_refusals(self):
        empty = CoordinateDescent([]).run(torch.zeros(7), n_iterations=2)
        assert empty.history == [] and empty.scores == {}
        shards, ids, y = _game_problem(6)
        port, _ = _coordinates(shards, ids, y)
        cd = CoordinateDescent(port)
        base = torch.zeros(len(y))
        with pytest.raises(ValueError, match="not in"):
            cd.run(base, locked=("nope",))
        with pytest.raises(ValueError, match="nothing to train"):
            cd.run(base, locked=("fixed", "user"))
        with pytest.raises(ValueError, match="no state to hold"):
            cd.run(base, locked=("user",))


def _est_configs(mod, cfg, **fixed_kw):
    return {
        "fixed": mod.FixedEffectCoordinateConfig("global", cfg,
                                                 reg_weight=1.0, **fixed_kw),
        "user": mod.RandomEffectCoordinateConfig("user", "userId", cfg,
                                                 reg_weight=1.0),
    }


def _fit_both(shards, ids, y, n_iterations=2, fixed_kw=None, **fit_kw):
    cfg, rcfg = _cfgs(max_iters=20)
    port = estimator.GameEstimator(
        "logistic", _est_configs(estimator, cfg, **(fixed_kw or {})),
        n_iterations=n_iterations, device=CPU)
    ref = ref_est.GameEstimator(
        "logistic", _est_configs(ref_est, rcfg, **(fixed_kw or {})),
        n_iterations=n_iterations)
    return port, ref, port.fit(shards, ids, y, **fit_kw), ref.fit(
        shards, ids, y, **fit_kw)


def _assert_models_close(model, rmodel):
    _close(model["fixed"].model.coefficients.means.numpy(),
           np.asarray(rmodel["fixed"].model.coefficients.means))
    re, rre = model["user"], rmodel["user"]
    assert set(re.coefficients) == set(rre.coefficients)
    scale = max(np.abs(v).max() for _, v in rre.coefficients.values())
    for k, (cols, vals) in re.coefficients.items():
        np.testing.assert_array_equal(cols, rre.coefficients[k][0])
        assert np.abs(vals - rre.coefficients[k][1]).max() <= TOL * scale


class TestEstimator:
    @pytest.mark.parametrize("rate", [1.0, 0.5], ids=["all-rows",
                                                       "down-sampled"])
    def test_fit_matches_reference(self, rate):
        shards, ids, y = _game_problem(10)
        ids = {"userId": ids["userId"]}
        _, _, (model, hist), (rmodel, rhist) = _fit_both(
            shards, ids, y, fixed_kw={"down_sampling_rate": rate})
        _assert_models_close(model, rmodel)
        assert len(hist) == len(rhist) == 4
        for h, rh in zip(hist, rhist):
            assert (h["iteration"], h["coordinate"], h["evaluator"]) == (
                rh["iteration"], rh["coordinate"], rh["evaluator"])
            assert h["train_metric"] == pytest.approx(rh["train_metric"],
                                                      abs=AUC_TOL)
        assert hist[-1]["train_metric"] > hist[0]["train_metric"]

    def test_device_metrics_equal_host_metrics(self):
        shards, ids, y = _game_problem(11)
        cfg, _ = _cfgs(max_iters=20)
        hists = []
        for flag in (False, True):
            est = estimator.GameEstimator(
                "logistic", _est_configs(estimator, cfg), n_iterations=2,
                device_metrics=flag, device=CPU)
            hists.append(est.fit(shards, {"userId": ids["userId"]}, y)[1])
        for a, b in zip(*hists):
            assert type(b["train_metric"]) is float
            assert a["train_metric"] == pytest.approx(b["train_metric"],
                                                      abs=1e-6)

    def test_warm_start_and_locked_coordinates_match_reference(self):
        shards, ids, y = _game_problem(12)
        ids = {"userId": ids["userId"]}
        port, ref, (base, _), (rbase, _) = _fit_both(shards, ids, y)
        # Warm start: each estimator from its own package's first model.
        model, hist = port.fit(shards, ids, y, initial_model=base)
        rmodel, rhist = ref.fit(shards, ids, y, initial_model=rbase)
        _assert_models_close(model, rmodel)
        # Partial retraining: "user" held at the prior model verbatim.
        locked, lhist = port.fit(shards, ids, y, initial_model=base,
                                 locked_coordinates=("user",))
        rlocked, _ = ref.fit(shards, ids, y, initial_model=rbase,
                             locked_coordinates=("user",))
        assert locked.models["user"] is base.models["user"]
        assert {h["coordinate"] for h in lhist} == {"fixed"}
        _close(locked["fixed"].model.coefficients.means.numpy(),
               np.asarray(rlocked["fixed"].model.coefficients.means))
        with pytest.raises(ValueError, match="initial_model"):
            port.fit(shards, ids, y, locked_coordinates=("user",))
        with pytest.raises(ValueError, match="not in the initial model"):
            port.fit(shards, ids, y, initial_model=base,
                     locked_coordinates=("nope",))
        states = port.initial_states_from_model(
            port.build_coordinates(shards, ids, y), base)
        assert states["fixed"].dtype == torch.float32
        bad = dataclasses.replace(base, models={"fixed": base["fixed"]})
        bad.models["fixed"] = dataclasses.replace(
            base["fixed"], model=dataclasses.replace(
                base["fixed"].model, coefficients=dataclasses.replace(
                    base["fixed"].model.coefficients,
                    means=torch.zeros(3))))
        with pytest.raises(ValueError, match="index maps"):
            port.fit(shards, ids, y, initial_model=bad)

    def test_random_effect_only_warm_start_matches_reference(self):
        """The reference's warm-start case (a random effect alone, two
        iterations: the second warm-starts from the first)."""
        shards, ids, y = _game_problem(16, n=300)
        ids = {"userId": ids["userId"]}
        fits = []
        for mod, cfg in zip((estimator, ref_est), _cfgs(max_iters=20)):
            kw = {"device": CPU} if mod is estimator else {}
            fits.append(mod.GameEstimator("logistic", {
                "user": mod.RandomEffectCoordinateConfig(
                    "user", "userId", cfg, reg_weight=1.0)},
                n_iterations=2, **kw).fit(shards, ids, y)[0])
        re, rre = fits[0]["user"], fits[1]["user"]
        assert re.n_entities == rre.n_entities == len(set(ids["userId"]))
        assert all(len(v) for _, v in re.coefficients.values())
        scale = max(np.abs(v).max() for _, v in rre.coefficients.values())
        for k, (cols, vals) in re.coefficients.items():
            np.testing.assert_array_equal(cols, rre.coefficients[k][0])
            # No fixed effect: no float32 L-BFGS floor, so 1e-5.
            assert np.abs(vals - rre.coefficients[k][1]).max() <= 1e-5 * scale

    def test_variances_match_closed_form(self):
        rng = np.random.default_rng(13)
        n, n_users = 300, 10
        ue = rng.normal(scale=1.5, size=n_users)
        Xg = rng.normal(size=(n, 3)).astype(np.float32)
        users = rng.integers(n_users, size=n)
        margin = 1.1 * Xg[:, 0] - 0.6 * Xg[:, 1] + ue[users]
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(
            np.float32)
        shards = {"global": sp.csr_matrix(Xg),
                  "bias": sp.csr_matrix(np.ones((n, 1), np.float32))}
        ids = {"userId": np.array([f"u{u}" for u in users])}
        cfg, _ = _cfgs(max_iters=40, tol=1e-7, variances=True)
        est = estimator.GameEstimator("logistic", {
            "fixed": estimator.FixedEffectCoordinateConfig(
                "global", cfg, 0.5),
            "user": estimator.RandomEffectCoordinateConfig(
                "bias", "userId", cfg, 0.5)}, n_iterations=2, device=CPU)
        model, _ = est.fit(shards, ids, y)
        fe = model["fixed"].model.coefficients
        assert fe.variances is not None and bool((fe.variances > 0).all())
        re = model["user"]
        key = "u3"
        rows = np.flatnonzero(ids["userId"] == key)
        m = Xg[rows] @ fe.means.numpy() + re.coefficients[key][1][0]
        p = 1 / (1 + np.exp(-m))
        H = np.sum(p * (1 - p)) + 0.5
        assert re.variances[key][0] == pytest.approx(1.0 / H, rel=1e-3)

    def test_fit_grid_matches_reference(self):
        shards, ids, y = _game_problem(14)
        ids = {"userId": ids["userId"]}
        grids = []
        for mod, cfg in zip((estimator, ref_est), _cfgs(max_iters=20)):
            grids.append([
                {"fixed": mod.FixedEffectCoordinateConfig("global", cfg,
                                                          reg_weight=lam),
                 "user": mod.RandomEffectCoordinateConfig(
                     "user", "userId", cfg, reg_weight=lam)}
                for lam in (100.0, 1.0)])
        port = estimator.GameEstimator("logistic", grids[0][0],
                                       n_iterations=2, device=CPU)
        ref = ref_est.GameEstimator("logistic", grids[1][0], n_iterations=2)
        best, results = port.fit_grid(grids[0], shards, ids, y)
        rbest, rresults = ref.fit_grid(grids[1], shards, ids, y)
        assert [r["best"] for r in results] == [r["best"] for r in rresults]
        for r, rr in zip(results, rresults):
            assert r["metric"] == pytest.approx(rr["metric"], abs=AUC_TOL)
        _assert_models_close(best, rbest)
        with pytest.raises(ValueError, match="empty"):
            port.fit_grid([], shards, ids, y)


class TestDeferredBranches:
    """The branches the port once refused fit as the reference's: the
    mesh routes and the out-of-core branches."""

    def test_refusals(self, tmp_path):
        """A mesh no longer raises: over a (one-rank gloo) process group
        the estimator builds the row-sharded fixed effect and the
        bucket-shard random effect, and fits one process's models within
        1e-5 (the group's all-reduce of one rank changes no bits; the
        row block is a COO matrix of its own)."""
        import torch.distributed as dist

        from photon_ml_tpu_torch.game.distributed import (
            DistributedFixedEffectCoordinate,
        )
        from photon_ml_tpu_torch.game.hierarchical import (
            ShardedBucketRandomEffectCoordinate,
        )
        from photon_ml_tpu_torch.parallel.distributed import DataGroup

        shards, ids, y = _game_problem(10)
        ids = {"userId": ids["userId"]}
        cfg, _ = _cfgs(max_iters=20)
        one = estimator.GameEstimator(
            "logistic", _est_configs(estimator, cfg), n_iterations=2,
            device=CPU)
        model, _ = one.fit(shards, ids, y)
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            est = estimator.GameEstimator(
                "logistic", _est_configs(estimator, cfg), n_iterations=2,
                mesh=DataGroup(), device=CPU)
            coords = est.build_coordinates(shards, ids, y)
            assert [type(c) for c in coords] == [
                DistributedFixedEffectCoordinate,
                ShardedBucketRandomEffectCoordinate]
            gmodel, _ = est.fit(shards, ids, y)
        finally:
            dist.destroy_process_group()
        _close(gmodel["fixed"].model.coefficients.means.numpy(),
               model["fixed"].model.coefficients.means.numpy(), 1e-5)
        for k, (cols, vals) in model["user"].coefficients.items():
            gcols, gvals = gmodel["user"].coefficients[k]
            np.testing.assert_array_equal(gcols, cols)
            np.testing.assert_allclose(gvals, vals, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("branch", ["streamed_fixed", "ooc_random"])
    def test_out_of_core_branch_fits_as_the_reference(self, branch):
        """The two out-of-core branches (a streamed fixed effect, an
        out-of-core random effect), through ``GameEstimator.fit`` of both
        packages on the same data."""
        shards, ids, y = _game_problem(15)
        cfg, rcfg = _cfgs()
        fixed_kw = ({"streaming_chunk_rows": 64}
                    if branch == "streamed_fixed" else {})
        re_kw = ({"device_budget_bytes": 1 << 14}
                 if branch == "ooc_random" else {})

        def configs(mod, c):
            return {
                "fixed": mod.FixedEffectCoordinateConfig(
                    "global", c, reg_weight=1.0, **fixed_kw),
                "user": mod.RandomEffectCoordinateConfig(
                    "user", "userId", c, reg_weight=1.0, **re_kw),
            }

        port = estimator.GameEstimator("logistic", configs(estimator, cfg),
                                       n_iterations=2, device=CPU)
        coords = port.build_coordinates(shards, ids, y)
        kinds = {"streamed_fixed": "StreamingFixedEffectCoordinate",
                 "ooc_random": "OutOfCoreRandomEffectCoordinate"}
        assert kinds[branch] in {type(c).__name__ for c in coords}
        model, hist = port.fit(shards, ids, y)
        rmodel, rhist = ref_est.GameEstimator(
            "logistic", configs(ref_est, rcfg), n_iterations=2).fit(
                shards, ids, y)
        _assert_models_close(model, rmodel)
        assert hist[-1]["train_metric"] == pytest.approx(
            rhist[-1]["train_metric"], abs=AUC_TOL)


def test_factored_coordinate_fits_as_the_reference():
    """The factored random effect the port once refused, on the same data:
    ``GameEstimator.fit`` matches the reference's."""
    shards, ids, y = _game_problem(15)
    cfg, rcfg = _cfgs()
    kw = dict(rank=2, reg_weight=1.0)
    model, hist = estimator.GameEstimator("logistic", {
        "user": estimator.FactoredRandomEffectCoordinateConfig(
            "user", "userId", optimization=cfg, **kw)}, device=CPU).fit(
                shards, ids, y)
    rmodel, rhist = ref_est.GameEstimator("logistic", {
        "user": ref_est.FactoredRandomEffectCoordinateConfig(
            "user", "userId", optimization=rcfg, **kw)}).fit(shards, ids, y)
    assert hist[0]["train_metric"] == pytest.approx(
        rhist[0]["train_metric"], abs=AUC_TOL)
    table, rtable = model["user"].coefficients, rmodel["user"].coefficients
    assert set(table) == set(rtable)
    scale = max(float(np.abs(v).max()) for _, v in rtable.values())
    for k, (cols, vals) in table.items():
        np.testing.assert_array_equal(cols, rtable[k][0])
        assert np.abs(vals - rtable[k][1]).max() <= TOL * scale


def test_game_states_from_numpy():
    states = convert.game_states_from_numpy(
        {"fixed": np.arange(3, dtype=np.float64),
         "re": [np.ones((2, 3)), np.zeros((1, 1), np.float32)],
         "none": None}, device=CPU)
    assert states["fixed"].dtype == torch.float32
    assert [t.shape for t in states["re"]] == [(2, 3), (1, 1)]
    assert states["none"] is None
