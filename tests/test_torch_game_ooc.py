"""The port's out-of-core random effects against the JAX package's, on the
CPU.

Mirrors ``tests/test_ooc_random.py`` (``TestParity``, ``TestBoundedMemory``,
``TestEstimatorIntegration``) and the out-of-core cases of
``tests/test_factored.py``.  The pass plan equals the reference's exactly;
train and score agree with the reference's out-of-core coordinate and with
the port's resident one within the reference tests' tolerances (1e-5 for
coefficients, 1e-4 for scores; the factored projection's float32 L-BFGS
stops on its noise floor, so factored fits hold the reference's factored
tolerances).  Inside the port one plan is bitwise the same at depth 1 and 2,
with and without the hot cache, prestaged or not, and from a memmap
dataset.

The reference's programs here compile in the test process, without JAX's
persistent compilation cache (``tests/torch_ref_compile.py``): a worker of
the ``-n 6`` run died with a segmentation fault while loading a cached
executable for this module's reference coordinates, and its running test
was reported failed; the parity margins are 40x inside their tolerances.
"""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from photon_ml_tpu.game import data as ref_data
from photon_ml_tpu.game import estimator as ref_est
from photon_ml_tpu.game.ooc_factored import (
    OutOfCoreFactoredRandomEffectCoordinate as RefOocFactored,
)
from photon_ml_tpu.game.ooc_random import (
    OutOfCoreRandomEffectCoordinate as RefOoc,
)
from photon_ml_tpu.optim.problem import (
    GlmOptimizationConfig as RefConfig,
    OptimizerConfig as RefOpt,
    OptimizerType as RefOptType,
)
from photon_ml_tpu.optim.regularization import (
    RegularizationContext as RefReg,
    RegularizationType as RefRegType,
)
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.data.streaming import spill_random_effect_dataset
from photon_ml_tpu_torch.game import data, estimator
from photon_ml_tpu_torch.game.coordinates import RandomEffectCoordinate
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.game.factored import FactoredRandomEffectCoordinate
from photon_ml_tpu_torch.game.ooc_factored import (
    OutOfCoreFactoredRandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.ooc_random import OutOfCoreRandomEffectCoordinate
from photon_ml_tpu_torch.io import checkpoint
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_tpu_torch.optim.regularization import (
    RegularizationContext,
    RegularizationType,
)

sys.path.insert(0, os.path.dirname(__file__))
from test_ooc_random import _zipf_data  # noqa: E402
from torch_ref_compile import (  # noqa: E402,F401
    reference_compiles_in_process,
    without_persistent_cache,
)

CPU = "cpu"
COEF_TOL = 1e-5  # tests/test_ooc_random.py's coefficient tolerance
SCORE_TOL = 1e-4  # ... and its score tolerance
# tests/test_factored.py's out-of-core factored tolerances: the projection's
# float32 L-BFGS stops on its noise floor.
FACTORED_V = dict(rtol=1e-2, atol=3e-3)
FACTORED_SCORES = dict(rtol=1e-2, atol=5e-3)
FACTORED_TABLES = dict(rtol=0, atol=5e-3)


def _cfgs(optimizer="lbfgs", reg="l2", **kw):
    return (
        GlmOptimizationConfig(
            optimizer=OptimizerConfig(optimizer=OptimizerType(optimizer),
                                      max_iters=25, tolerance=1e-7),
            regularization=RegularizationContext(RegularizationType(reg)),
            **kw),
        RefConfig(
            optimizer=RefOpt(optimizer=RefOptType(optimizer), max_iters=25,
                             tolerance=1e-7),
            regularization=RefReg(RefRegType(reg)), **kw),
    )


def _host_bytes(ds) -> int:
    return sum(a.nbytes for b in ds.blocks for a in b.leaves())


class _Built:
    """One dataset in three forms: the port's resident and host datasets
    and the reference's host dataset."""

    def __init__(self, seed=3, n_entities=60, d=5, max_rows=40, **kw):
        self.keys, self.X, self.y, self.w = _zipf_data(
            seed=seed, n_entities=n_entities, d=d, max_rows=max_rows)
        args = (self.keys, self.X, self.y, self.w)
        self.resident = data.build_random_effect_dataset(*args, device=CPU,
                                                         **kw)
        self.host = data.build_random_effect_dataset(*args, device=False,
                                                     **kw)
        self.ref_host = ref_data.build_random_effect_dataset(
            *args, device=False, **kw)

    def offsets(self, seed=0):
        if seed is None:
            return np.zeros(len(self.y), np.float32)
        return np.random.default_rng(seed).normal(
            size=len(self.y)).astype(np.float32)


def _ooc(built, cfg, budget, reg_weight=0.7, **kw):
    return OutOfCoreRandomEffectCoordinate(
        "re", built.host, "logistic", cfg, reg_weight=reg_weight,
        device_budget_bytes=budget, device=CPU, **kw)


def _plan(coord):
    return [[(s.block_idx, s.lane_lo, s.lane_hi, s.padded_e, s.bytes,
              s.placement) for s in g] for g in coord.pass_plan]


def _close(a_list, b_list, tol):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                                   rtol=0)


def _bitwise(a_list, b_list):
    for a, b in zip(a_list, b_list):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestPlan:
    @pytest.mark.parametrize("seed,budget,passive", [
        (5, None, None), (15, 24_000, None), (17, 16_000, None),
        (11, 25_000, 8), (31, 8_000, None),
    ])
    def test_plan_equals_the_reference(self, seed, budget, passive):
        built = _Built(seed=seed, max_rows=60 if passive else 40,
                       max_rows_per_entity=passive)
        if budget is None:
            budget = max(_host_bytes(built.host) // 6, 6000)
        cfg, rcfg = _cfgs()
        port = _ooc(built, cfg, budget)
        ref = RefOoc("re", built.ref_host, "logistic", rcfg,
                     reg_weight=0.7, device_budget_bytes=budget)
        assert _plan(port) == [[dataclasses.astuple(s) for s in g]
                               for g in ref.pass_plan]
        per_pass = budget // 2
        for group in port.pass_plan:
            assert sum(s.bytes for s in group) <= per_pass

    def test_factored_plan_equals_the_reference(self):
        built = _Built(seed=7)
        cfg, rcfg = _cfgs()
        budget = 20_000
        port = OutOfCoreFactoredRandomEffectCoordinate(
            "f", built.host, "logistic", cfg, rank=2,
            device_budget_bytes=budget, device=CPU)
        ref = RefOocFactored("f", built.ref_host, "logistic", rcfg, rank=2,
                             device_budget_bytes=budget)
        assert _plan(port) == [[dataclasses.astuple(s) for s in g]
                               for g in ref.pass_plan]


class TestParity:
    @pytest.mark.parametrize("case", ["big_budget", "tiny_budget",
                                      "warm_start", "passive"])
    def test_train_and_score_match(self, case):
        """Against the reference's out-of-core coordinate and the port's
        resident one (``TestParity`` of the reference)."""
        kw = {"max_rows_per_entity": 8, "max_rows": 60} \
            if case == "passive" else {}
        seed = {"big_budget": 3, "tiny_budget": 5, "warm_start": 9,
                "passive": 11}[case]
        built = _Built(seed=seed, **kw)
        budget = {"big_budget": 1 << 30,
                  "tiny_budget": max(_host_bytes(built.host) // 6, 6000),
                  "warm_start": 30_000, "passive": 25_000}[case]
        cfg, rcfg = _cfgs()
        ooc = _ooc(built, cfg, budget)
        res = RandomEffectCoordinate("re", built.resident, "logistic", cfg,
                                     reg_weight=0.7)
        ref = RefOoc("re", built.ref_host, "logistic", rcfg,
                     reg_weight=0.7, device_budget_bytes=budget)
        if case == "tiny_budget":
            assert len(ooc.pass_plan) >= 3
            assert any(s.lane_lo > 0 for g in ooc.pass_plan for s in g)
        off = built.offsets(0 if case == "big_budget" else None)
        st_o = ooc.train(torch.as_tensor(off))
        st_r = res.train(torch.as_tensor(off))
        st_f = ref.train(jnp.asarray(off))
        if case == "warm_start":
            st_o = ooc.train(torch.as_tensor(off),
                             warm_state=[torch.as_tensor(s) for s in st_o])
            st_r = res.train(torch.as_tensor(off), warm_state=st_r)
            st_f = ref.train(jnp.asarray(off),
                             warm_state=[jnp.asarray(s) for s in st_f])
        assert all(isinstance(s, np.ndarray) for s in st_o)
        _close(st_o, [s.numpy() for s in st_r], COEF_TOL)
        _close(st_o, st_f, COEF_TOL)
        sc = ooc.score(st_o).numpy()
        np.testing.assert_allclose(sc, res.score(st_r).numpy(),
                                   atol=SCORE_TOL, rtol=0)
        np.testing.assert_allclose(sc, np.asarray(ref.score(st_f)),
                                   atol=SCORE_TOL, rtol=0)

    @pytest.mark.parametrize("optimizer,reg", [
        ("tron", "l2"), ("owlqn", "elastic_net"),
    ])
    def test_other_optimizers_match(self, optimizer, reg):
        built = _Built(seed=7, n_entities=25)
        cfg, rcfg = _cfgs(optimizer, reg)
        ooc = _ooc(built, cfg, 20_000)
        res = RandomEffectCoordinate("re", built.resident, "logistic", cfg,
                                     reg_weight=0.7)
        ref = RefOoc("re", built.ref_host, "logistic", rcfg,
                     reg_weight=0.7, device_budget_bytes=20_000)
        off = built.offsets(None)
        st_o = ooc.train(torch.as_tensor(off))
        _close(st_o, [s.numpy() for s in res.train(torch.as_tensor(off))],
               COEF_TOL)
        # Across packages, float32 OWL-QN lanes at the noise floor part on
        # ulp-decided trials (7.4e-4 here): the cross-package OWL-QN
        # tolerance of the solver slice (tests/test_torch_solvers.py).
        _close(st_o, ref.train(jnp.asarray(off)),
               COEF_TOL if optimizer == "tron" else 1e-3)

    def test_variances_and_tables_match(self):
        built = _Built(seed=29, n_entities=30)
        cfg, rcfg = _cfgs(compute_variances=True)
        ooc = _ooc(built, cfg, 20_000)
        ref = RefOoc("re", built.ref_host, "logistic", rcfg,
                     reg_weight=0.7, device_budget_bytes=20_000)
        res = RandomEffectCoordinate("re", built.resident, "logistic", cfg,
                                     reg_weight=0.7)
        off = built.offsets(2)
        m_o = ooc.finalize(ooc.train(torch.as_tensor(off)), offsets=off)
        m_f = ref.finalize(ref.train(jnp.asarray(off)), offsets=off)
        m_r = res.finalize(res.train(torch.as_tensor(off)), offsets=off)
        for other in (m_f, m_r):
            assert set(other.coefficients) == set(m_o.coefficients)
            for k, (cols, vals) in other.coefficients.items():
                np.testing.assert_array_equal(cols, m_o.coefficients[k][0])
                np.testing.assert_allclose(vals, m_o.coefficients[k][1],
                                           atol=COEF_TOL, rtol=0)
            for k, v in other.variances.items():
                np.testing.assert_allclose(v, m_o.variances[k], rtol=1e-3)


class TestBitwiseInsideOnePlan:
    """Depth, hot cache, prestage and a memmap dataset change no bit."""

    @pytest.fixture(scope="class")
    def built(self):
        return _Built(seed=19)

    def _run(self, built, tmp=None, updates=1, prestage=False,
             budget=16_000, **kw):
        cfg, _ = _cfgs()
        host = built.host
        if tmp is not None:
            host = spill_random_effect_dataset(host, str(tmp))
            assert isinstance(host.blocks[0].X, np.memmap)
        coord = OutOfCoreRandomEffectCoordinate(
            "re", host, "logistic", cfg, reg_weight=0.7,
            device_budget_bytes=budget, device=CPU, **kw)
        off = torch.as_tensor(built.offsets(1))
        state, scores = None, []
        for _ in range(updates):
            if prestage:
                coord.prestage(state)
            state = coord.train(off, warm_state=state)
            scores.append(coord.score(state).numpy())
        return coord, state, scores

    @pytest.mark.parametrize("case", ["repeat", "depth1", "prestaged",
                                      "memmap"])
    def test_variant_equals_the_plain_run(self, built, tmp_path, case):
        _, base_state, base_scores = self._run(built, updates=2)
        # Depth 1 at half the budget keeps the per-pass budget, so the
        # plan is the same one.
        kw = {"depth1": {"prefetch_depth": 1, "budget": 8_000},
              "prestaged": {"prestage": True},
              "memmap": {"tmp": tmp_path}}.get(case, {})
        coord, state, scores = self._run(built, updates=2, **kw)
        base = self._run(built)[0]
        assert _plan(coord) == _plan(base) and len(base.pass_plan) >= 3
        _bitwise(state, base_state)
        _bitwise(scores, base_scores)
        assert 1 <= coord.live_groups_high_water <= coord.prefetch_depth

    def test_hot_cache_equals_uncached(self, built):
        """A hot cache at half the static bytes, over three updates, equals
        the uncached run bitwise and hits from the second update on."""
        _, base_state, base_scores = self._run(built, updates=3)
        cfg, _ = _cfgs()
        probe = OutOfCoreRandomEffectCoordinate(
            "re", built.host, "logistic", cfg, device_budget_bytes=16_000,
            device=CPU)
        static = sum(probe._group_static_bytes(kind, g)
                     for g in probe.pass_plan for kind in ("train", "score"))
        coord, state, scores = self._run(built, updates=3,
                                         hot_budget_bytes=static // 2)
        _bitwise(state, base_state)
        _bitwise(scores, base_scores)
        cache = coord.hot_cache
        assert cache.admissions > 0 and cache.hits > 0
        assert cache.resident_bytes <= static // 2


class TestBoundedMemory:
    def test_transfers_never_hold_more_than_depth_groups(self):
        built = _Built(seed=31)
        cfg, _ = _cfgs()
        ooc = _ooc(built, cfg, 8_000)
        assert len(ooc.pass_plan) >= 3
        counts = {"put": 0, "consume": 0}
        violations = []
        orig_put = ooc._put_group

        def tracked_put(packed):
            counts["put"] += 1
            if counts["put"] - counts["consume"] > 2:
                violations.append(dict(counts))
            return orig_put(packed)

        ooc._put_group = tracked_put

        def consume(gi, tensors):
            counts["consume"] += 1

        ooc._run_groups(lambda gi: [], consume)
        assert not violations, violations
        assert counts["put"] == counts["consume"] == len(ooc.pass_plan)
        assert ooc.live_groups_high_water <= 2

    def test_budget_too_small_is_refused(self):
        built = _Built(seed=21)
        cfg, _ = _cfgs()
        with pytest.raises(ValueError, match="per-pass budget"):
            _ooc(built, cfg, 64)

    def test_device_resident_dataset_is_refused(self):
        built = _Built(seed=23, n_entities=10)
        cfg, _ = _cfgs()
        with pytest.raises(ValueError, match="device=False"):
            OutOfCoreRandomEffectCoordinate(
                "re", built.resident, "logistic", cfg,
                device_budget_bytes=1 << 30, device=CPU)


class TestFactored:
    """The reference's out-of-core factored cases (tests/test_factored.py)
    against the port's out-of-core and resident factored coordinates."""

    def _coords(self, budget=10_000):
        built = _Built(seed=13, n_entities=50)
        cfg, rcfg = _cfgs()
        kw = dict(rank=2, reg_weight=0.3, alternations=2)
        ooc = OutOfCoreFactoredRandomEffectCoordinate(
            "f", built.host, "logistic", cfg, device_budget_bytes=budget,
            device=CPU, **kw)
        res = FactoredRandomEffectCoordinate("f", built.resident, "logistic",
                                             cfg, **kw)
        # The reference's projection pass fails on a donated buffer once a
        # plan has three groups or more (ROADMAP Queue 3), so it runs one
        # group: another plan than the port's, compared to tolerance.
        ref = RefOocFactored("f", built.ref_host, "logistic", rcfg,
                             device_budget_bytes=1 << 30, **kw)
        return built, ooc, res, ref

    def test_matches_the_reference_and_the_resident_coordinate(self):
        built, ooc, res, ref = self._coords()
        assert len(ooc.pass_plan) >= 2
        off = built.offsets(None)
        st_o = ooc.train(torch.as_tensor(off))
        st_r = res.train(torch.as_tensor(off))
        st_f = ref.train(jnp.asarray(off))
        sc = ooc.score(st_o).numpy()
        for V, scores in ((st_r[1].numpy(), res.score(st_r).numpy()),
                          (np.asarray(st_f[1]), np.asarray(ref.score(st_f)))):
            np.testing.assert_allclose(st_o[1].numpy(), V, **FACTORED_V)
            np.testing.assert_allclose(sc, scores, **FACTORED_SCORES)
        t_o = ooc.finalize(st_o).coefficients
        t_r = res.finalize(st_r).coefficients
        assert set(t_o) == set(t_r)
        for k, (cols, vals) in t_r.items():
            np.testing.assert_array_equal(cols, t_o[k][0])
            np.testing.assert_allclose(vals, t_o[k][1], **FACTORED_TABLES)
        # Warm restart round-trips the (host u, device V) state.
        st_o2 = ooc.train(torch.as_tensor(off), warm_state=st_o)
        assert all(isinstance(u, np.ndarray) for u in st_o2[0])
        assert 1 <= ooc.live_groups_high_water <= 2

    def test_projection_gradient_is_exact_and_repeats(self):
        """A projection pass's gradient equals a float64 host recompute
        within 1e-5 of its terms' Σ|·| and repeats bitwise (the
        deterministic column sums)."""
        built, ooc, _, _ = self._coords(budget=8_000)
        off = built.offsets(4)
        u_list, V = ooc.train(torch.as_tensor(off))
        padded = ooc._padded_offsets(off)
        v1, g1 = ooc.projection_value_grad(V.reshape(-1), padded, u_list)
        v2, g2 = ooc.projection_value_grad(V.reshape(-1), padded, u_list)
        assert float(v1) == float(v2)
        np.testing.assert_array_equal(g1.numpy(), g2.numpy())
        _, g64, mag = _host_projection(built, ooc, off, u_list, V)
        assert np.abs(g1.numpy() - g64).max() <= 1e-5 * max(mag, 1.0)

    def test_multi_group_steps_against_float64_host(self):
        """At a budget of three groups or more, each alternation's
        projection pass against a float64 host recompute from the host
        blocks alone (value within 1e-6 relative, gradient within 1e-5 of
        its terms' Σ|·|), no projection step raising the float64 objective
        in V, and the steps taken by hand equal to ``train``'s, bitwise."""
        built, ooc, _, _ = self._coords(budget=6_000)
        assert len(ooc.pass_plan) >= 3
        off = built.offsets(5)
        padded = ooc._padded_offsets(off)
        u_list = [np.zeros((b.n_entities, ooc.rank), np.float32)
                  for b in built.host.blocks]
        V = ooc._v0
        for _ in range(ooc.alternations):
            ooc.latent_step(padded, u_list, V)
            val, g = ooc.projection_value_grad(V.reshape(-1), padded, u_list)
            f0, g64, mag = _host_projection(built, ooc, off, u_list, V)
            assert abs(float(val) - f0) <= 1e-6 * abs(f0)
            assert np.abs(g.numpy() - g64).max() <= 1e-5 * max(mag, 1.0)
            V_new, _ = ooc.projection_step(padded, u_list, V)
            f1 = _host_projection(built, ooc, off, u_list, V_new)[0]
            assert f1 <= f0 * (1 + 1e-7)
            V = V_new
        u_t, V_t = ooc.train(torch.as_tensor(off))
        _bitwise(u_list, u_t)
        np.testing.assert_array_equal(V.numpy(), V_t.numpy())


def _host_projection(built, ooc, off, u_list, V):
    """Σ w·ℓ(x·V_sub u + off) + ½λ‖V‖² and its gradient in V, in float64
    on the host from the host blocks; returns (value, gradient, Σ|terms|
    of the gradient)."""
    from photon_ml_tpu_torch.ops import losses as losses_lib

    loss = losses_lib.get("logistic")
    V64 = np.asarray(V, np.float64)
    g = np.zeros_like(V64)
    mag = np.zeros_like(V64)
    value = 0.0
    offp = np.concatenate([off, [0.0]]).astype(np.float64)
    for b, u in zip(built.host.blocks, u_list):
        u64 = np.asarray(u, np.float64)
        cm = b.col_map
        vsub = np.where((cm >= 0)[:, :, None], V64[np.maximum(cm, 0)], 0.0)
        wl = (vsub * u64[:, None, :]).sum(-1)
        m = (b.X.astype(np.float64) * wl[:, None, :]).sum(-1) \
            + offp[b.row_index]
        y64 = torch.as_tensor(b.labels.astype(np.float64))
        d1 = loss.d1(torch.as_tensor(m), y64).numpy()
        value += float((b.weights * loss.value(torch.as_tensor(m),
                                               y64).numpy()).sum())
        dm = b.weights * d1
        terms = (dm[:, :, None] * b.X)[:, :, :, None] * u64[:, None, None, :]
        per_col = terms.sum(1)  # (E, D, rank)
        valid = cm >= 0
        np.add.at(g, cm[valid], per_col[valid])
        np.add.at(mag, cm[valid], np.abs(terms).sum(1)[valid])
    l2v = float(np.float32(ooc.projection_reg_weight))
    g += l2v * V64
    value += 0.5 * l2v * float((V64 * V64).sum())
    return value, g.reshape(-1), float(mag.max())


class TestEstimatorAndDescent:
    def _shards(self, seed=27, n_entities=40):
        keys, X, y, w = _zipf_data(seed=seed, n_entities=n_entities, d=4)
        rng = np.random.default_rng(1)
        Xg = rng.normal(size=(len(y), 3)).astype(np.float32)
        return {"global": sp.csr_matrix(Xg), "entity": X}, \
            {"eid": np.asarray(keys)}, y

    def _configs(self, mod, cfg, budget, factored=False):
        fixed = mod.FixedEffectCoordinateConfig(
            feature_shard="global", optimization=cfg, reg_weight=0.5)
        if factored:
            re = mod.FactoredRandomEffectCoordinateConfig(
                feature_shard="entity", entity_key="eid", rank=2,
                optimization=cfg, reg_weight=0.5,
                device_budget_bytes=budget)
        else:
            re = mod.RandomEffectCoordinateConfig(
                feature_shard="entity", entity_key="eid", optimization=cfg,
                reg_weight=0.5, device_budget_bytes=budget)
        return {"fixed": fixed, "re": re}

    @pytest.mark.parametrize("factored", [False, True])
    def test_estimator_ooc_matches_reference_and_resident(self, factored):
        shards, ids, y = self._shards()
        cfg, rcfg = _cfgs()
        kw = dict(n_iterations=2)
        m_ooc, h_ooc = estimator.GameEstimator(
            "logistic", self._configs(estimator, cfg, 60_000, factored),
            device=CPU, **kw).fit(shards, ids, y)
        m_res, _ = estimator.GameEstimator(
            "logistic", self._configs(estimator, cfg, 0, factored),
            device=CPU, **kw).fit(shards, ids, y)
        m_ref, h_ref = ref_est.GameEstimator(
            "logistic", self._configs(ref_est, rcfg, 60_000, factored),
            **kw).fit(shards, ids, y)
        tol = FACTORED_TABLES["atol"] if factored else SCORE_TOL
        for other in (m_res, m_ref):
            t, to = other.models["re"].coefficients, \
                m_ooc.models["re"].coefficients
            assert set(t) == set(to)
            for k, (cols, vals) in t.items():
                np.testing.assert_array_equal(cols, to[k][0])
                np.testing.assert_allclose(vals, to[k][1], atol=tol, rtol=0)
            np.testing.assert_allclose(
                np.asarray(other.models["fixed"].model.coefficients.means),
                m_ooc.models["fixed"].model.coefficients.means.numpy(),
                atol=tol, rtol=0)
        assert h_ooc[-1]["train_metric"] == pytest.approx(
            h_ref[-1]["train_metric"], abs=1e-3)

    def test_checkpoint_and_warm_start_from_the_reference(self, tmp_path):
        """A CD checkpoint written by the reference's out-of-core descent
        resumes the port's out-of-core descent (host states), and the next
        update matches the reference's from the same checkpoint."""
        from photon_ml_tpu.game.descent import CoordinateDescent as RefCD
        from photon_ml_tpu.io import checkpoint as ref_ckpt

        built = _Built(seed=9, n_entities=30)
        cfg, rcfg = _cfgs()
        ref = RefOoc("re", built.ref_host, "logistic", rcfg,
                     reg_weight=0.7, device_budget_bytes=30_000)
        ooc = _ooc(built, cfg, 30_000)
        base = built.offsets(3)
        d = str(tmp_path / "ck")
        RefCD([ref]).run(jnp.asarray(base), n_iterations=1,
                         checkpointer=ref_ckpt.CoordinateDescentCheckpointer(
                             d))
        port_dir = str(tmp_path / "port")
        shutil.copytree(d, port_dir)
        ref_res = RefCD([ref]).run(
            jnp.asarray(base), n_iterations=2,
            checkpointer=ref_ckpt.CoordinateDescentCheckpointer(d))
        port_res = CoordinateDescent([ooc]).run(
            torch.as_tensor(base), n_iterations=2,
            checkpointer=checkpoint.CoordinateDescentCheckpointer(port_dir))
        st = port_res.states["re"]
        assert all(isinstance(s, np.ndarray) for s in st)
        _close(st, ref_res.states["re"], COEF_TOL)
        # A warm start from the reference's states through convert.
        warm = convert.game_states_from_numpy(
            {"re": [np.asarray(s) for s in ref_res.states["re"]]},
            device=CPU, host=("re",))["re"]
        assert all(isinstance(s, np.ndarray) for s in warm)
        _close(ooc.train(torch.as_tensor(base), warm_state=warm),
               ref.train(jnp.asarray(base), warm_state=ref_res.states["re"]),
               COEF_TOL)


class TestReferenceCompileCache:
    def test_the_reference_compiles_without_the_persistent_cache(self):
        """Pins the repair of the order-dependent worker crash: inside this
        module no reference program is read from the shared persistent
        cache."""
        from jax._src import compilation_cache

        assert jax.config.jax_compilation_cache_dir is None
        jax.jit(lambda x: x * 3.0 + 1.0)(jnp.ones(4)).block_until_ready()
        assert not compilation_cache.is_cache_used(jax.devices()[0].client)

    def test_the_previous_cache_directory_is_restored(self, tmp_path):
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        jax.config.update("jax_enable_compilation_cache", True)
        try:
            with without_persistent_cache():
                assert jax.config.jax_compilation_cache_dir is None
                assert not jax.config.jax_enable_compilation_cache
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
            assert jax.config.jax_enable_compilation_cache
        finally:
            jax.config.update("jax_compilation_cache_dir", None)
            jax.config.update("jax_enable_compilation_cache", False)
