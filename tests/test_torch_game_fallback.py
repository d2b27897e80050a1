"""The port's batched random-effect fallback against the JAX package's, on the CPU.

Buckets with no Newton fast path (any L1 component, the OWL-QN optimizer,
or D > 32 local features with R > 1) run the port's batched L-BFGS, OWL-QN
and TRON (``optim/batched.py`` through ``BlockSolver``) and the reference's
``jax.vmap`` of its solvers (``_make_block_solver_cached``).  Every lane of
the port follows its own single solve's trajectory, as under ``vmap``:

- in float64 (both packages, the blocks cast) the two agree within 1e-9 of
  the bucket's largest coefficient after 25 iterations, over four losses,
  every solver and TRON named both ways;
- in float32 the trajectories part at the float32 noise floor (one ulp
  decides a line-search trial, the PR 5 finding), so the float32 cases run
  four iterations and hold 1e-4.

Inside the port, fallback and Newton buckets solved in lockstep are bitwise
the buckets solved alone, with one host read a body.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.game import coordinates as ref_coords
from photon_ml_tpu.optim.problem import (
    GlmOptimizationConfig as RefConfig,
    OptimizerConfig as RefOpt,
    OptimizerType as RefOptType,
)
from photon_ml_tpu.optim.regularization import (
    RegularizationContext as RefReg,
)
from photon_ml_tpu_torch.game import coordinates, data
from photon_ml_tpu_torch.optim import batched
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_game_solvers import _both, _labels  # noqa: E402
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = "cpu"
TASKS = ["logistic", "squared", "poisson", "smoothed_hinge"]
#: kind → (optimizer, registry solver, regularization)
KINDS = {
    "lbfgs": ("LBFGS", None, "l2"),
    "tron": ("TRON", None, "l2"),
    "tron-registry": ("LBFGS", "tron", "l2"),
    "owlqn": ("OWLQN", None, "l2"),
    "owlqn-registry": ("LBFGS", "owlqn", "l2"),
    "l1": ("LBFGS", None, "l1"),
    "elastic_net": ("LBFGS", None, "elastic_net"),
}
FALLBACK = (batched.BatchedLBFGS, batched.BatchedOWLQN, batched.BatchedTRON)


def _configs(kind, max_iters=25, tol=1e-7, history=10):
    optimizer, solver, reg = KINDS[kind]

    def regctx(cls):
        return cls.elastic_net(0.5) if reg == "elastic_net" \
            else getattr(cls, reg)()

    port = GlmOptimizationConfig(
        optimizer=OptimizerConfig(optimizer=OptimizerType[optimizer],
                                  max_iters=max_iters, tolerance=tol,
                                  history=history, solver=solver),
        regularization=regctx(RegularizationContext))
    ref = RefConfig(
        optimizer=RefOpt(optimizer=RefOptType[optimizer], max_iters=max_iters,
                         tolerance=tol, history=history, solver=solver),
        regularization=regctx(RefReg))
    return port, ref


def _problem(seed, task, d=40, n_ent=16, density=0.8, growth=4.0):
    """Zipf-sized entities over ``d`` features: with d = 40 a rank-1
    bucket and D > 32 buckets of R > 1; with d = 5 only D ≤ 32."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(rng.zipf(1.6, n_ent), 24)
    sizes[:3] = (1, 5, 20)
    n = int(sizes.sum())
    keys = np.repeat(np.array([f"e{i}" for i in range(n_ent)],
                              dtype=object), sizes)[rng.permutation(n)]
    X = sp.csr_matrix(rng.normal(size=(n, d)).astype(np.float32)
                      * (rng.uniform(size=(n, d)) < density))
    y = _labels(rng, task, n)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    ds, ref = _both(keys, X, y, w, bucket_growth=growth)
    return rng, ds, ref


def _as(dtype, block, rblock):
    """Both packages' block in ``dtype`` (float32 or float64)."""
    tt = torch.float64 if dtype == np.float64 else torch.float32
    block = dataclasses.replace(block, X=block.X.to(tt),
                                labels=block.labels.to(tt),
                                weights=block.weights.to(tt))
    rblock = dataclasses.replace(
        rblock, X=rblock.X.astype(dtype), labels=rblock.labels.astype(dtype),
        weights=rblock.weights.astype(dtype))
    return block, rblock


def _reg(cfg, weight=0.7):
    reg = cfg.regularization
    return (float(np.float32(reg.l1_weight(1.0) * weight)),
            float(np.float32(reg.l2_weight(1.0) * weight)))


def _solve_pair(task, cfgs, block, rblock, off, w0, dtype=np.float64):
    """(port program, port w, reference w) for one bucket in ``dtype``."""
    block, rblock = _as(dtype, block, rblock)
    l1, l2 = _reg(cfgs[0])
    solver = coordinates.BlockSolver(task, cfgs[0])
    off_t, w0_t = torch.as_tensor(off.astype(dtype)), torch.as_tensor(
        w0.astype(dtype))
    prog = solver.program(block, off_t, w0_t, l1, l2)
    ws, stats = solver.solve_all([(block, off_t, w0_t)], l1, l2)
    ref = ref_coords._make_block_solver_cached(
        coordinates.losses_lib.get(task).name, cfgs[1])(
        rblock, jnp.asarray(off.astype(dtype)), jnp.asarray(w0.astype(dtype)),
        jnp.asarray(l1, dtype), jnp.asarray(l2, dtype))
    return prog, ws[0].numpy(), np.asarray(ref), stats


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _inputs(rng, block, warm=0.1):
    off = (rng.normal(size=(block.n_entities, block.rows_per_entity))
           * 0.3).astype(np.float32)
    w0 = (rng.normal(size=(block.n_entities, block.block_dim))
          * warm).astype(np.float32)
    return off, w0


@pytest.mark.parametrize("task,kind", [(t, k) for t in TASKS for k in (
    "lbfgs", "tron", "l1", "elastic_net")] + [
    ("logistic", k) for k in ("tron-registry", "owlqn", "owlqn-registry")])
def test_float64_trajectories_match_reference(task, kind):
    """Every fallback bucket (D > 32 for L-BFGS and TRON; every bucket,
    R = 1 and D ≤ 32 included, for OWL-QN) from a warm start."""
    cfgs = _configs(kind)
    owlqn = kind not in ("lbfgs", "tron", "tron-registry")
    problems = [_problem(1, task)] + ([_problem(2, task, d=5)] if owlqn
                                      else [])
    shapes = []
    for rng, ds, ref in problems:
        for block, rblock in zip(ds.blocks, ref.blocks):
            off, w0 = _inputs(rng, block)
            prog, got, want, _ = _solve_pair(task, cfgs, block, rblock, off,
                                             w0)
            if not isinstance(prog, FALLBACK):
                assert not owlqn and (block.block_dim <= 32
                                      or block.rows_per_entity == 1)
                continue
            want_cls = (batched.BatchedOWLQN if owlqn else
                        batched.BatchedTRON if "tron" in kind
                        else batched.BatchedLBFGS)
            assert type(prog) is want_cls
            shapes.append((block.rows_per_entity, block.block_dim))
            _close(got, want, 1e-9)
    assert any(d > 32 and r > 1 for r, d in shapes)
    if owlqn:
        assert any(r == 1 for r, _ in shapes)
        assert any(d <= 32 for _, d in shapes)


@pytest.mark.parametrize("kind", ["lbfgs", "tron", "l1", "elastic_net"])
def test_float32_matches_reference_before_the_noise_floor(kind):
    rng, ds, ref = _problem(3, "logistic")
    cfgs = _configs(kind, max_iters=3)
    n = 0
    for block, rblock in zip(ds.blocks, ref.blocks):
        off, w0 = _inputs(rng, block)
        prog, got, want, _ = _solve_pair("logistic", cfgs, block, rblock,
                                         off, w0, np.float32)
        if isinstance(prog, FALLBACK):
            n += 1
            _close(got, want, 1e-4)
    assert n >= 2


def test_mixed_iteration_counts_and_lanes_converged_at_entry():
    """Half the lanes start at their own solution (converged at entry: 0
    iterations, untouched), the rest cold; the lanes then stop after
    different iteration counts, each as the reference's."""
    rng, ds, ref = _problem(4, "logistic", n_ent=40)
    block, rblock = max(((b, r) for b, r in zip(ds.blocks, ref.blocks)
                         if b.block_dim > 32 and b.rows_per_entity > 1),
                        key=lambda br: br[0].n_entities)
    block, rblock = _as(np.float64, block, rblock)
    off, _ = _inputs(rng, block)
    l1, l2 = 0.0, 0.7
    tight = coordinates.BlockSolver("logistic", _configs(
        "lbfgs", max_iters=200, tol=1e-12)[0])
    w_star = tight.solve(block, torch.as_tensor(off, dtype=torch.float64),
                         torch.zeros(block.n_entities, block.block_dim,
                                     dtype=torch.float64), l1, l2).numpy()
    w0 = np.zeros_like(w_star)
    w0[::2] = w_star[::2]
    cfgs = _configs("lbfgs", max_iters=40, tol=1e-6)
    prog, got, want, stats = _solve_pair("logistic", cfgs, block, rblock,
                                         off, w0)
    its = stats.iterations[0].numpy()
    assert np.all(its[::2] == 0) and np.array_equal(got[::2], w0[::2])
    assert len(set(its[1::2].tolist())) > 1 and its[1::2].min() > 0
    assert bool(stats.converged[0].all())
    _close(got, want, 1e-9)


@pytest.mark.parametrize("kind,history,d,depth", [
    ("l1", 10, 5, None), ("lbfgs", 4, 40, 4), ("l1", 30, 40, None)],
    ids=["owlqn-D-below-history", "lbfgs-short-history",
         "owlqn-D-wide"])
def test_history_depth_is_min_of_history_and_D(kind, history, d, depth):
    rng, ds, ref = _problem(5, "logistic", d=d)
    cfgs = _configs(kind, history=history)
    seen = 0
    for block, rblock in zip(ds.blocks, ref.blocks):
        off, w0 = _inputs(rng, block)
        prog, got, want, _ = _solve_pair("logistic", cfgs, block, rblock,
                                         off, w0)
        if not isinstance(prog, FALLBACK):
            continue
        seen += 1
        assert prog.hist.m == min(history, block.block_dim)
        if depth is not None:
            assert prog.hist.m == depth
        _close(got, want, 1e-9)
    assert seen


class TestRank1FastPath:
    """The reference's ``TestRank1FastPath`` with the generic side on the
    fallback: a rank-1 bucket wider than 32 features, made R = 2 with a
    zero-weight copy of each row, runs batched L-BFGS."""

    @pytest.mark.parametrize("task", ["logistic", "squared", "poisson"])
    def test_single_row_bucket_matches_generic_solver(self, rng, task):
        n = 60
        users = np.array([f"u{i}" for i in range(n)], dtype=object)
        X = sp.csr_matrix(rng.normal(size=(n, 36)).astype(np.float32))
        y = _labels(rng, task, n)
        ds, ref = _both(users, X, y)
        block = ds.blocks[0]
        assert block.rows_per_entity == 1 and block.block_dim > 32
        cfg, rcfg = _configs("lbfgs", max_iters=60, tol=1e-9)
        solver = coordinates.BlockSolver(task, cfg)
        off = (rng.normal(size=(n, 1)) * 0.3).astype(np.float32)
        w0 = torch.zeros(n, block.block_dim)
        fast = solver.solve(block, torch.as_tensor(off), w0, 0.0,
                            0.7).numpy()
        block2 = data.EntityBlock(
            X=torch.cat([block.X, torch.zeros_like(block.X)], 1),
            labels=torch.cat([block.labels, torch.zeros_like(block.labels)],
                             1),
            weights=torch.cat([block.weights,
                               torch.zeros_like(block.weights)], 1),
            col_map=block.col_map,
            row_index=torch.cat([block.row_index,
                                 torch.full_like(block.row_index, n)], 1),
            n_entities=n, rows_per_entity=2, block_dim=block.block_dim)
        off2 = torch.as_tensor(np.concatenate([off, 0 * off], 1))
        assert isinstance(solver.program(block2, off2, w0, 0.0, 0.7),
                          batched.BatchedLBFGS)
        generic = solver.solve(block2, off2, w0, 0.0, 0.7).numpy()
        np.testing.assert_allclose(fast, generic, atol=5e-4)
        # The fast path also agrees with the reference's.
        want = np.asarray(ref_coords._make_block_solver(task, rcfg)(
            ref.blocks[0], jnp.asarray(off), jnp.zeros((n, block.block_dim),
                                                       jnp.float32),
            jnp.asarray(0.0, jnp.float32), jnp.asarray(0.7, jnp.float32)))
        _close(fast, want, 1e-5)


class TestBucketConsolidation:
    """The reference's ``TestBucketConsolidation`` on fallback buckets:
    bucket growth 4 packs the tail into fewer buckets and trains the same
    per-entity models as growth 2 (padding rows weigh 0)."""

    @pytest.mark.parametrize("kind,d", [("l1", 5), ("lbfgs", 40)])
    def test_growth_reduces_buckets_same_model(self, rng, kind, d):
        sizes = np.minimum(rng.zipf(1.7, 120), 40)
        n = int(sizes.sum())
        users = np.repeat(np.array([f"u{i}" for i in range(120)],
                                   dtype=object), sizes)
        X = sp.csr_matrix(rng.normal(size=(n, d)).astype(np.float32))
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
        w = np.ones(n, np.float32)
        ds2 = data.build_random_effect_dataset(users, X, y, w, device=CPU)
        ds4 = data.build_random_effect_dataset(users, X, y, w,
                                               bucket_growth=4.0, device=CPU)
        assert len(ds4.blocks) < len(ds2.blocks)
        cfg, _ = _configs(kind, max_iters=25, tol=1e-7)
        models = []
        for ds in (ds2, ds4):
            coord = coordinates.RandomEffectCoordinate(
                "re", ds, "logistic", cfg, reg_weight=0.5,
                entity_key="userId")
            models.append(coord.finalize(coord.train(torch.zeros(n))))
            assert any(it is not None
                       for it in coord.last_solve.iterations)
        t2, t4 = models[0].coefficients, models[1].coefficients
        assert set(t2) == set(t4)
        for k in t2:
            np.testing.assert_array_equal(t2[k][0], t4[k][0])
            np.testing.assert_allclose(t2[k][1], t4[k][1], atol=2e-3)


def test_lockstep_of_newton_and_fallback_buckets_is_bitwise():
    """A D > 32 L-BFGS coordinate with narrow buckets too: every bucket in
    one lockstep equals each bucket alone, with one host read a body."""
    rng, wide, _ = _problem(6, "logistic")
    _, narrow, _ = _problem(7, "logistic", d=6)
    solver = coordinates.BlockSolver("logistic",
                                     _configs("lbfgs", max_iters=10)[0])
    items = []
    for b in wide.blocks + narrow.blocks:
        off, w0 = _inputs(rng, b)
        items.append((b, torch.as_tensor(off), torch.as_tensor(w0)))
    kinds = {type(solver.program(*it, 0.0, 0.5)) for it in items}
    assert batched.BatchedLBFGS in kinds and len(kinds) >= 3
    ws, stats = solver.solve_all(items, 0.0, 0.5)
    # One read a body (none after a bucket's last body at its cap).
    assert max(stats.bodies) <= stats.host_reads <= max(stats.bodies) + 1
    for (b, o, w0), w in zip(items, ws):
        assert torch.equal(solver.solve(b, o, w0, 0.0, 0.5), w)
    fallback = [k for k, it in enumerate(stats.iterations) if it is not None]
    assert fallback and all(stats.inner[k].sum() >= stats.iterations[k].sum()
                            for k in fallback)


@pytest.mark.parametrize("kind", ["elastic_net", "tron"])
def test_coordinate_train_score_finalize_match_reference(kind):
    """``RandomEffectCoordinate`` under elastic net (every bucket OWL-QN)
    and under TRON (D > 32 buckets), float32, a few iterations."""
    from photon_ml_tpu.game.coordinates import RandomEffectCoordinate as Ref

    rng, ds, ref = _problem(8, "logistic")
    cfg, rcfg = _configs(kind, max_iters=3)
    n = ds.n_global_rows
    offsets = (rng.normal(size=n) * 0.3).astype(np.float32)
    coord = coordinates.RandomEffectCoordinate("re", ds, "logistic", cfg,
                                               reg_weight=0.7)
    rcoord = Ref("re", ref, "logistic", rcfg, reg_weight=0.7)
    state = coord.train(torch.as_tensor(offsets))
    rstate = rcoord.train(jnp.asarray(offsets))
    for s, r in zip(state, rstate):
        _close(s.numpy(), np.asarray(r), 1e-4)
    rs = [jnp.asarray(s.numpy()) for s in state]
    np.testing.assert_allclose(coord.score(state).numpy(),
                               np.asarray(rcoord.score(rs)), rtol=1e-5,
                               atol=1e-6)
    model, rmodel = coord.finalize(state), rcoord.finalize(rs)
    assert set(model.coefficients) == set(rmodel.coefficients)
    for k, (cols, vals) in model.coefficients.items():
        np.testing.assert_array_equal(cols, rmodel.coefficients[k][0])
        np.testing.assert_array_equal(vals, rmodel.coefficients[k][1])
    assert sum(coord.last_solve.bodies) > 0


@pytest.mark.parametrize("kind", ["lbfgs", "tron"])
def test_estimator_fits_a_wide_random_effect_as_the_reference(kind):
    """``GameEstimator.fit`` with a fixed effect and a per-user effect over
    40 features (D > 32 buckets on the fallback) against the reference's
    estimator; whole float32 fits agree within 2e-3, the tolerance of
    ``test_torch_game.py``."""
    from photon_ml_tpu.game import estimator as ref_est
    from photon_ml_tpu_torch.game import estimator

    rng = np.random.default_rng(9)
    n, d = 600, 40
    users = np.array([f"u{i}" for i in rng.integers(0, 12, size=n)])
    Xg = rng.normal(size=(n, 4)).astype(np.float32)
    Xu = (rng.normal(size=(n, d)) * (rng.uniform(size=(n, d)) < 0.5)
          ).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-Xg[:, 0]))).astype(
        np.float32)
    shards = {"global": sp.csr_matrix(Xg), "wide": sp.csr_matrix(Xu)}
    ids = {"userId": users}
    cfg, rcfg = _configs(kind, max_iters=20, tol=1e-6)
    port = estimator.GameEstimator("logistic", {
        "fixed": estimator.FixedEffectCoordinateConfig("global", cfg,
                                                       reg_weight=1.0),
        "user": estimator.RandomEffectCoordinateConfig(
            "wide", "userId", cfg, reg_weight=1.0)},
        n_iterations=2, device=CPU)
    ref = ref_est.GameEstimator("logistic", {
        "fixed": ref_est.FixedEffectCoordinateConfig("global", rcfg,
                                                     reg_weight=1.0),
        "user": ref_est.RandomEffectCoordinateConfig(
            "wide", "userId", rcfg, reg_weight=1.0)}, n_iterations=2)
    coords = port.build_coordinates(shards, ids, y)
    assert any(b.block_dim > 32 and b.rows_per_entity > 1
               for b in coords[1].dataset.blocks)
    model, hist = port.fit(shards, ids, y)
    rmodel, rhist = ref.fit(shards, ids, y)
    for h, rh in zip(hist, rhist):
        assert h["train_metric"] == pytest.approx(rh["train_metric"],
                                                  abs=1e-4)
    table, rtable = model["user"].coefficients, rmodel["user"].coefficients
    assert set(table) == set(rtable)
    scale = max(float(np.abs(v).max()) for _, v in rtable.values())
    for k, (cols, vals) in table.items():
        np.testing.assert_array_equal(cols, rtable[k][0])
        assert np.abs(vals - rtable[k][1]).max() <= 2e-3 * scale
