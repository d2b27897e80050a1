"""The port's host-kind solvers (``solvers/admm.py``, ``solvers/block_cd.py``,
``solvers/sharded.py``) against the JAX package's, on the CPU.

Mirrors the reference's ``tests/test_solvers.py``: the registry's
host-kind mechanics, consensus-ADMM over logical shards (against the
reference's logical shards and the resident OWL-QN optimum within 1e-5
relative objective; the cached-eigendecomposition ridge path), block CD
(the resident optimum within 1e-5; dense features required), the sharded
grid runner's guards and builders, and the GAME fixed-effect trainer.
Beside them, inside the port: a grid killed after its first λ and resumed
from its checkpoint is bitwise the uninterrupted grid, and the
``adaptive_rho`` knob parses ``false`` as False where the reference's
``bool(val)`` makes it True.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.data.dataset import make_glm_data as ref_make
from photon_ml_tpu.optim import problem as jp
from photon_ml_tpu.optim.regularization import RegularizationContext as JReg
from photon_ml_tpu.parallel.distributed import shard_glm_data as ref_shard
from photon_ml_tpu.solvers import registry as ref_registry
from photon_ml_tpu.solvers import sharded as ref_sharded
from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.io.checkpoint import GridCheckpointer
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    GlmOptimizationProblem,
    OptimizerConfig,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from photon_ml_tpu_torch.parallel import distributed
from photon_ml_tpu_torch.parallel.distributed import shard_glm_data
from photon_ml_tpu_torch.solvers import registry
from photon_ml_tpu_torch.solvers import sharded
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = "cpu"
REGS = {"l2": (RegularizationContext.l2, JReg.l2),
        "elastic_net": (lambda: RegularizationContext.elastic_net(0.5),
                        lambda: JReg.elastic_net(0.5))}


def _make_xy(rng, n=240, d=10, task="logistic"):
    X = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    w_true = (rng.normal(size=d) * (rng.uniform(size=d) < 0.5)).astype(
        np.float32)
    if task == "logistic":
        p = 1.0 / (1.0 + np.exp(-3.0 * (X @ w_true)))
        y = (rng.uniform(size=n) < p).astype(np.float32)
    else:
        y = (X @ w_true + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _problems(task="logistic", reg="l2", solver=None, options=(),
              max_iters=150, compute_variances=False):
    """(port, reference) problems of one config."""
    port = GlmOptimizationProblem(task, GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=max_iters, tolerance=1e-8,
                                  solver=solver, solver_options=options),
        regularization=REGS[reg][0](), compute_variances=compute_variances))
    ref = jp.GlmOptimizationProblem(task, jp.GlmOptimizationConfig(
        optimizer=jp.OptimizerConfig(max_iters=max_iters, tolerance=1e-8,
                                     solver=solver, solver_options=options),
        regularization=REGS[reg][1]()))
    return port, ref


def _objective(problem, X, y, w, lam, offsets=None):
    """The full objective in float64 on the host."""
    cfg = problem.config
    l1 = cfg.regularization.l1_weight(lam)
    l2 = cfg.regularization.l2_weight(lam)
    w = np.asarray(w, np.float64)
    m = X.astype(np.float64) @ w + (0.0 if offsets is None else offsets)
    y = y.astype(np.float64)
    if problem.task == "logistic":
        loss = np.sum(np.logaddexp(0.0, m) - y * m)
    else:
        loss = 0.5 * np.sum((m - y) ** 2)
    return loss + l1 * np.abs(w).sum() + 0.5 * l2 * w @ w


def _gap(a, b):
    return abs(a - b) / max(1.0, abs(b))


# -- registry ---------------------------------------------------------------


class TestRegistry:
    def test_solver_options_dict(self):
        opt = OptimizerConfig(
            solver="admm", solver_options=(("rho", "0.5"), ("shards", "4")))
        assert registry.solver_options_dict(opt) == {"rho": "0.5",
                                                     "shards": "4"}
        assert registry.solver_options_dict(opt) == (
            ref_registry.solver_options_dict(jp.OptimizerConfig(
                solver="admm", solver_options=opt.solver_options)))
        assert registry.solver_options_dict(OptimizerConfig()) == {}

    def test_host_kind_rejected_in_single_solve(self, rng):
        X, y = _make_xy(rng)
        port, _ = _problems(reg="elastic_net", solver="admm")
        with pytest.raises(ValueError, match="host-side outer loop"):
            port.solve(make_glm_data(X, y, device=CPU), 0.1)


# -- consensus ADMM -----------------------------------------------------------


class TestADMM:
    @pytest.mark.parametrize("sparse", [False, True], ids=["dense",
                                                          "sparse"])
    def test_logical_shards_match_reference_and_owlqn(self, rng, sparse):
        """ADMM over 4 logical shards lands within 1e-5 relative objective
        of the reference's ADMM over its 4 logical shards and of the
        resident OWL-QN optimum, on an elastic-net logistic grid."""
        import scipy.sparse as sp

        X, y = _make_xy(rng, n=256, d=10)
        Xs = sp.csr_matrix(X) if sparse else X
        grid = [0.3, 0.1]
        owlqn, _ = _problems(reg="elastic_net")
        best = {lam: m.coefficients.means.numpy() for lam, m, _ in
                owlqn.run_grid(make_glm_data(X, y, device=CPU), grid)}
        opts = (("reltol", "1e-6"), ("shards", "4"))
        port, ref = _problems(reg="elastic_net", solver="admm",
                              options=opts)
        ours = sharded.run_grid_sharded(
            port, shard_glm_data(Xs, y, None, n_shards=4, device=CPU), None,
            grid)
        theirs = ref_sharded.run_grid_sharded(
            ref, ref_shard(Xs, y, None, n_shards=4), None, grid)
        for (lam, m, res), (_, rm, _) in zip(ours, theirs):
            f = _objective(port, X, y, m.coefficients.means.numpy(), lam)
            assert res.converged
            assert _gap(f, _objective(port, X, y, best[lam], lam)) <= 1e-5
            assert _gap(f, _objective(port, X, y, rm.coefficients.means,
                                      lam)) <= 1e-5

    def test_ridge_closed_form_path(self, rng):
        """The squared-loss task takes the cached-eigendecomposition
        x-update; the local L-BFGS path and the reference's ridge path
        land on the same consensus optimum."""
        X, y = _make_xy(rng, n=200, d=6, task="linear")
        ws, refs = {}, {}
        for local in ("ridge", "lbfgs"):
            opts = (("reltol", "1e-6"), ("local_solver", local),
                    ("max_outer", "400"))
            port, refs[local] = _problems("linear", "elastic_net", "admm",
                                          opts)
            [(_, m, res)] = sharded.run_grid_sharded(
                port, shard_glm_data(X, y, None, n_shards=4, device=CPU),
                None, [0.2])
            assert res.converged
            ws[local] = m.coefficients.means.numpy()
        [(_, rm, _)] = ref_sharded.run_grid_sharded(
            refs["ridge"], ref_shard(X, y, None, n_shards=4), None, [0.2])
        f_r = _objective(port, X, y, ws["ridge"], 0.2)
        assert _gap(f_r, _objective(port, X, y, ws["lbfgs"], 0.2)) < 1e-5
        assert _gap(f_r, _objective(port, X, y, rm.coefficients.means,
                                    0.2)) < 1e-5

    @pytest.mark.parametrize("options,match", [
        ({"momentum": "0.9"}, "unknown admm solver_options"),
        ({"over_relaxation": "2.5"}, "over_relaxation"),
        ({"local_solver": "newton"}, "local_solver"),
    ], ids=["unknown", "over-relaxation", "local-solver"])
    def test_option_validation(self, options, match):
        from photon_ml_tpu.solvers.admm import ADMMOptions as RefOptions
        from photon_ml_tpu_torch.solvers.admm import ADMMOptions

        with pytest.raises(ValueError, match=match):
            ADMMOptions.from_options(options)
        with pytest.raises(ValueError, match=match):
            RefOptions.from_options(options)

    @pytest.mark.parametrize("text,port_value", [
        ("false", False), ("False", False), ("0", False), ("no", False),
        ("true", True), ("1", True)])
    def test_adaptive_rho_parsing_differs_from_reference(self, text,
                                                         port_value):
        """A deliberate difference: the reference coerces the knob with
        ``bool(val)``, so every non-empty string — ``--solver-option
        adaptive_rho=false`` included — turns adaptation ON; the port
        parses false/0/no as False."""
        from photon_ml_tpu.solvers.admm import ADMMOptions as RefOptions
        from photon_ml_tpu_torch.solvers.admm import ADMMOptions

        assert ADMMOptions.from_options(
            {"adaptive_rho": text}).adaptive_rho is port_value
        assert RefOptions.from_options(
            {"adaptive_rho": text}).adaptive_rho is True

    def test_reductions_counted(self, rng):
        """One reduction of 2d+4 floats an outer round, plus the final
        exact evaluation's d+1 (the reference's telemetry counters)."""
        X, y = _make_xy(rng, n=128, d=5)
        port, _ = _problems(reg="elastic_net", solver="admm")
        distributed.reset_allreduces()
        [(_, _, res)] = sharded.run_grid_sharded(
            port, shard_glm_data(X, y, None, n_shards=2, device=CPU), None,
            [0.1])
        rounds, d = res.iterations, X.shape[1]
        assert rounds > 0
        assert distributed.ALLREDUCES == {
            "count": rounds + 1,
            "bytes": rounds * (2 * d + 4) * 4 + (d + 1) * 4}


# -- block coordinate descent ---------------------------------------------


class TestBlockCD:
    @pytest.mark.parametrize("reg", ["l2", "elastic_net"])
    def test_matches_resident_and_reference(self, rng, reg):
        """Drift-corrected block CD over 4 shards reaches the resident
        optimum (its fixed point is exact global prox-stationarity) and
        the reference's block CD, within 1e-5 relative objective."""
        X, y = _make_xy(rng, n=240, d=9)
        resident, _ = _problems(reg=reg)
        [(lam, rm, _)] = resident.run_grid(make_glm_data(X, y, device=CPU),
                                           [0.1])
        opts = (("n_blocks", "3"), ("sweeps", "2"), ("tolerance", "1e-10"),
                ("max_rounds", "400"))
        port, ref = _problems(reg=reg, solver="block_cd", options=opts)
        [(_, m, _)] = sharded.run_grid_sharded(
            port, shard_glm_data(X, y, None, n_shards=4, device=CPU), None,
            [0.1])
        [(_, jm, _)] = ref_sharded.run_grid_sharded(
            ref, ref_shard(X, y, None, n_shards=4), None, [0.1])
        f = _objective(port, X, y, m.coefficients.means.numpy(), lam)
        assert _gap(f, _objective(port, X, y, rm.coefficients.means, lam)
                    ) <= 1e-5
        assert _gap(f, _objective(port, X, y, jm.coefficients.means, lam)
                    ) <= 1e-5

    def test_option_validation(self):
        from photon_ml_tpu.solvers.block_cd import BlockCDOptions as Ref
        from photon_ml_tpu_torch.solvers.block_cd import BlockCDOptions

        for cls in (BlockCDOptions, Ref):
            with pytest.raises(ValueError, match="unknown block_cd"):
                cls.from_options({"rho": "1.0"})
            with pytest.raises(ValueError, match=">= 1"):
                cls.from_options({"sweeps": "0"})

    def test_dense_features_required(self, rng):
        import scipy.sparse as sp

        X, y = _make_xy(rng, n=100, d=6)
        port, _ = _problems(solver="block_cd")
        dist = shard_glm_data(sp.csr_matrix(X), y, None, n_shards=2,
                              device=CPU)
        with pytest.raises(ValueError, match="[Dd]ense"):
            sharded.run_grid_sharded(port, dist, None, [0.1])

    def test_reductions_counted(self, rng):
        """Two reductions a block round ([g, h, f], then the deltas) and
        the final exact evaluation."""
        X, y = _make_xy(rng, n=128, d=6)
        port, _ = _problems(solver="block_cd", options=(
            ("n_blocks", "2"), ("max_rounds", "7")))
        distributed.reset_allreduces()
        [(_, _, res)] = sharded.run_grid_sharded(
            port, shard_glm_data(X, y, None, n_shards=2, device=CPU), None,
            [0.1])
        assert res.iterations == 7
        assert distributed.ALLREDUCES["count"] == 2 * 7 + 1


# -- the grid runner and shard builders ---------------------------------------


class TestShardedRunner:
    def test_jit_kind_rejected(self, rng):
        X, y = _make_xy(rng, n=80, d=4)
        dist = shard_glm_data(X, y, None, n_shards=2, device=CPU)
        with pytest.raises(ValueError, match="jit-kind"):
            sharded.run_grid_sharded(_problems(solver="lbfgs")[0], dist,
                                     None, [0.1])

    def test_variances_rejected(self, rng):
        X, y = _make_xy(rng, n=80, d=4)
        dist = shard_glm_data(X, y, None, n_shards=2, device=CPU)
        port, _ = _problems(solver="admm", compute_variances=True)
        with pytest.raises(ValueError, match="compute_variances"):
            sharded.run_grid_sharded(port, dist, None, [0.1])

    def test_stack_resident_matches_reference(self, rng):
        """103 rows on 4 shards: padded with weight-0 rows, reshaped to a
        leading shard axis exactly as the reference's."""
        X, y = _make_xy(rng, n=103, d=5)
        ours = sharded.stack_resident(make_glm_data(X, y, device=CPU), 4)
        theirs = ref_sharded.stack_resident(ref_make(X, y), 4)
        assert ours.n_shards == 4
        np.testing.assert_array_equal(ours.dense.numpy(),
                                      np.asarray(theirs.data.features.data))
        for name in ("labels", "weights", "offsets"):
            np.testing.assert_array_equal(
                ours.stacked(name).numpy(),
                np.asarray(getattr(theirs.data, name)))
        assert np.all(ours.stacked("weights").numpy().reshape(-1)[103:]
                      == 0.0)
        with pytest.raises(ValueError, match="DenseMatrix"):
            import scipy.sparse as sp

            sharded.stack_resident(
                make_glm_data(sp.csr_matrix(X), y, device=CPU), 4)

    def test_resolve_shard_count(self):
        opt = OptimizerConfig(solver="admm", solver_options=(("shards", "6"),))
        assert sharded.resolve_shard_count(opt) == 6
        assert sharded.resolve_shard_count(OptimizerConfig()) == 2
        assert ref_sharded.resolve_shard_count(jp.OptimizerConfig(
            solver="admm", solver_options=(("shards", "6"),))) == 6

    @pytest.mark.parametrize("solver,options", [
        ("admm", (("reltol", "1e-4"),)),
        ("block_cd", (("n_blocks", "2"), ("max_rounds", "30"))),
    ])
    def test_killed_grid_resumes_bitwise(self, rng, tmp_path, solver,
                                         options):
        """A grid killed after its first λ is persisted, then resumed from
        the checkpoint, equals the uninterrupted grid bitwise: the warm
        start is restored exactly and each solve is deterministic in it
        (ADMM rederives its duals from the warm start)."""
        X, y = _make_xy(rng, n=160, d=6)
        port, _ = _problems(reg="elastic_net", solver=solver,
                            options=options)
        dist = shard_glm_data(X, y, None, n_shards=2, device=CPU)
        lams = [0.3, 0.1, 0.03]
        full = sharded.run_grid_sharded(port, dist, None, lams)
        ckpt = GridCheckpointer(str(tmp_path / "ckpt"))
        acc = {}

        class Killed(Exception):
            pass

        def on_solved(lam, w):
            acc[lam] = w.numpy()
            ckpt.save(acc)
            raise Killed

        with pytest.raises(Killed):
            sharded.run_grid_sharded(port, dist, None, lams,
                                     on_solved=on_solved)
        solved = ckpt.load()
        assert list(solved) == [0.3]
        resumed = sharded.run_grid_sharded(port, dist, None, lams,
                                           solved=solved)
        for (lam, m, _), (lam1, m1, _) in zip(full, resumed):
            assert lam == lam1
            assert torch.equal(m.coefficients.means, m1.coefficients.means)


# -- GAME integration --------------------------------------------------------


class TestGameIntegration:
    def test_spec_solver_keys_parse(self):
        from photon_ml_tpu.drivers.game_training_driver import (
            parse_coordinate_config as ref_parse,
        )
        from photon_ml_tpu_torch.drivers.game_training_driver import (
            parse_coordinate_config,
        )

        spec = {"name": "global", "type": "fixed", "feature_shard": "global",
                "solver": "admm",
                "solver_options": {"rho": "0.5", "shards": 2},
                "reg_type": "elastic_net", "elastic_net_alpha": 0.5,
                "reg_weight": 0.1}
        name, cfg = parse_coordinate_config(spec)
        _, ref_cfg = ref_parse(spec)
        assert name == "global"
        assert cfg.optimization.optimizer.solver == "admm"
        assert cfg.optimization.optimizer.solver_options == (
            ref_cfg.optimization.optimizer.solver_options) == (
            ("rho", "0.5"), ("shards", "2"))

    def test_fixed_effect_trainer_matches_reference(self, rng):
        """make_fixed_effect_trainer (the GAME fixed-effect coordinate's
        host-kind path) reaches the resident optimum with re-slotted
        offsets, as the reference's does."""
        X, y = _make_xy(rng, n=160, d=6)
        offsets = rng.normal(scale=0.3, size=160).astype(np.float32)
        port, ref = _problems(reg="elastic_net", solver="admm",
                              options=(("reltol", "1e-6"),))
        trainer = sharded.make_fixed_effect_trainer(
            port, make_glm_data(X, y, device=CPU), n_shards=2)
        w = trainer(torch.as_tensor(offsets), torch.zeros(6), 0.1)
        ref_trainer = ref_sharded.make_fixed_effect_trainer(
            ref, ref_make(X, y), n_shards=2)
        w_ref = ref_trainer(jnp.asarray(offsets), jnp.zeros(6, jnp.float32),
                            0.1)
        resident, _ = _problems(reg="elastic_net")
        data = dataclasses.replace(make_glm_data(X, y, device=CPU),
                                   offsets=torch.as_tensor(offsets))
        best = resident.solve_single_device(data, 0.1).w.numpy()
        f = _objective(port, X, y, w.numpy(), 0.1, offsets)
        assert _gap(f, _objective(port, X, y, best, 0.1, offsets)) <= 1e-5
        assert _gap(f, _objective(port, X, y, w_ref, 0.1, offsets)) <= 1e-5
