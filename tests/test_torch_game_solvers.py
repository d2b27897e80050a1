"""The port's batched per-entity solvers against the JAX package's, on the CPU.

Every block comes from both packages' ``build_random_effect_dataset`` on the
same seeded data and runs through the port's ``BlockSolver`` and the
reference's ``_make_block_solver`` with the same offsets, warm starts and λ.
The two run the same Newton iterations in float32 with different summation
orders, so coefficients agree within 1e-5 of the block's largest
coefficient (and within 5e-4 absolute where the reference's own test holds
two solvers to that).  Inside the port, the lockstep solve of several
buckets is bitwise the solve of each bucket alone.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.game import coordinates as ref_coords
from photon_ml_tpu.game import data as ref_data
from photon_ml_tpu.optim.problem import (
    GlmOptimizationConfig as RefConfig,
    OptimizerConfig as RefOpt,
    OptimizerType as RefOptType,
)
from photon_ml_tpu.optim.regularization import (
    RegularizationContext as RefReg,
)
from photon_ml_tpu_torch.game import coordinates, data
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = "cpu"


def _configs(max_iters=60, tol=1e-9, reg="l2", optimizer="LBFGS",
             solver=None):
    port = GlmOptimizationConfig(
        optimizer=OptimizerConfig(optimizer=OptimizerType[optimizer],
                                  max_iters=max_iters, tolerance=tol,
                                  solver=solver),
        regularization=getattr(RegularizationContext, reg)())
    ref = RefConfig(
        optimizer=RefOpt(optimizer=RefOptType[optimizer],
                         max_iters=max_iters, tolerance=tol, solver=solver),
        regularization=getattr(RefReg, reg)())
    return port, ref


def _labels(rng, task, n):
    if task == "poisson":
        return rng.poisson(1.5, size=n).astype(np.float32)
    if task == "squared":
        return rng.normal(size=n).astype(np.float32)
    return (rng.uniform(size=n) < 0.5).astype(np.float32)


def _both(keys, X, y, w=None, **kw):
    w = np.ones(len(y), np.float32) if w is None else w
    return (data.build_random_effect_dataset(keys, X, y, w, device=CPU, **kw),
            ref_data.build_random_effect_dataset(keys, X, y, w, **kw))


def _solve_both(task, cfgs, block, rblock, off, w0, l2):
    port = coordinates.BlockSolver(task, cfgs[0]).solve(
        block, torch.as_tensor(off), torch.as_tensor(w0), 0.0,
        float(np.float32(l2)))
    ref = ref_coords._make_block_solver(task, cfgs[1])(
        rblock, jnp.asarray(off), jnp.asarray(w0), jnp.asarray(0.0),
        jnp.asarray(l2, jnp.float32))
    return port.numpy(), np.asarray(ref)


def _close(got, want, rtol=1e-5):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max(), scale)


class TestRank1Newton:
    @pytest.mark.parametrize("task", ["logistic", "squared", "poisson"])
    def test_matches_reference_and_generic_path(self, rng, task):
        n = 80
        users = np.array([f"u{i}" for i in range(n)], dtype=object)
        X = sp.csr_matrix(rng.normal(size=(n, 4)).astype(np.float32))
        y = _labels(rng, task, n)
        ds, ref = _both(users, X, y)
        block, rblock = ds.blocks[0], ref.blocks[0]
        assert block.rows_per_entity == 1
        cfgs = _configs()
        off = (rng.normal(size=(n, 1)) * 0.3).astype(np.float32)
        w0 = np.zeros((n, block.block_dim), np.float32)
        fast, want = _solve_both(task, cfgs, block, rblock, off, w0, 0.7)
        _close(fast, want)
        # The same problem with a zero-weight second row takes the batched
        # Newton path; the reference holds the two within 5e-4.
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
        generic = coordinates.BlockSolver(task, cfgs[0]).solve(
            block2, torch.as_tensor(np.concatenate([off, 0 * off], 1)),
            torch.as_tensor(w0), 0.0, float(np.float32(0.7))).numpy()
        np.testing.assert_allclose(fast, generic, atol=5e-4)

    def test_large_norm_poisson_stays_finite_and_converges(self):
        users = np.array(["a", "b", "c"], dtype=object)
        X = sp.csr_matrix(np.array([[20.0, 0.0], [1e-2, 0.0], [1.0, 1.0]],
                                   np.float32))
        y = np.array([1000.0, 100.0, 2.0], np.float32)
        ds, ref = _both(users, X, y)
        cfgs = _configs(max_iters=40, tol=1e-7)
        for block, rblock in zip(ds.blocks, ref.blocks):
            off = np.zeros((block.n_entities, block.rows_per_entity),
                           np.float32)
            w0 = np.zeros((block.n_entities, block.block_dim), np.float32)
            got, want = _solve_both("poisson", cfgs, block, rblock, off, w0,
                                    1e-3)
            assert np.all(np.isfinite(got))
            _close(got, want)
        bi, lane = ds.entity_to_slot["a"]
        block = ds.blocks[bi]
        w = coordinates.BlockSolver("poisson", cfgs[0]).solve(
            block, torch.zeros(block.n_entities, block.rows_per_entity),
            torch.zeros(block.n_entities, block.block_dim), 0.0,
            float(np.float32(1e-3)))
        m = float((block.X[lane, 0] * w[lane]).sum())
        assert abs(np.exp(m) - 1000.0) / 1000.0 < 0.05


class TestDim1Newton:
    def test_bias_effect_matches_reference_and_scalar_oracle(self, rng):
        import scipy.optimize

        n_users, rows_each = 12, 7
        n = n_users * rows_each
        users = np.repeat(np.array([f"u{i}" for i in range(n_users)],
                                   dtype=object), rows_each)
        x = rng.normal(size=n).astype(np.float32)
        offs = rng.normal(size=n).astype(np.float32) * 0.5
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(1.3 * x + offs)))
             ).astype(np.float32)
        ds, ref = _both(users, sp.csr_matrix(x[:, None]), y)
        assert all(b.block_dim == 1 and b.rows_per_entity > 1
                   for b in ds.blocks)
        cfgs = _configs(max_iters=50)
        for block, rblock, ids in zip(ds.blocks, ref.blocks, ds.entity_ids):
            off = np.concatenate([offs, [0.0]]).astype(np.float32)[
                block.row_index.numpy()]
            w0 = np.zeros((block.n_entities, 1), np.float32)
            got, want = _solve_both("logistic", cfgs, block, rblock, off, w0,
                                    0.7)
            _close(got, want)
            for lane, key in enumerate(ids):
                rows = np.flatnonzero(users == key)

                def obj(w):
                    m = w * x[rows] + offs[rows]
                    return float(np.sum(np.logaddexp(0, m) - y[rows] * m)
                                 + 0.35 * w * w)

                res = scipy.optimize.minimize_scalar(
                    obj, bounds=(-20, 20), method="bounded",
                    options={"xatol": 1e-10})
                assert abs(float(got[lane, 0]) - res.x) <= 2e-4


def _bucket_problem(seed, task, n_ent=60, d=5, cap=None, density=0.8):
    rng = np.random.default_rng(seed)
    sizes = np.minimum(rng.zipf(1.6, n_ent), 40)
    n = int(sizes.sum())
    keys = np.repeat(np.array([f"e{i}" for i in range(n_ent)],
                              dtype=object), sizes)[rng.permutation(n)]
    X = sp.csr_matrix(rng.normal(size=(n, d)).astype(np.float32)
                      * (rng.uniform(size=(n, d)) < density))
    y = _labels(rng, task, n)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    ds, ref = _both(keys, X, y, w, max_rows_per_entity=cap)
    offsets = (rng.normal(size=n + 1) * 0.3).astype(np.float32)
    offsets[-1] = 0.0
    return rng, ds, ref, offsets


class TestNewtonBlock:
    @pytest.mark.parametrize("task", ["logistic", "squared", "poisson"])
    @pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
    def test_every_bucket_matches_reference(self, task, warm):
        rng, ds, ref, offsets = _bucket_problem(7, task, cap=24)
        cfgs = _configs(max_iters=10, tol=1e-6)
        assert any(b.rows_per_entity > 1 and b.block_dim > 1
                   for b in ds.blocks)
        for block, rblock in zip(ds.blocks, ref.blocks):
            off = offsets[block.row_index.numpy()]
            w0 = ((rng.normal(size=(block.n_entities, block.block_dim)) * 0.2)
                  if warm else np.zeros((block.n_entities, block.block_dim))
                  ).astype(np.float32)
            got, want = _solve_both(task, cfgs, block, rblock, off, w0, 0.5)
            _close(got, want)

    def test_lockstep_equals_each_bucket_alone_bitwise(self):
        _, ds, _, offsets = _bucket_problem(3, "logistic", n_ent=120)
        solver = coordinates.BlockSolver("logistic", _configs(
            max_iters=10, tol=1e-6)[0])
        off = torch.as_tensor(offsets)
        items = [(b, coordinates._gather_block_offsets(off[:-1], b),
                  torch.zeros(b.n_entities, b.block_dim)) for b in ds.blocks]
        assert len(items) >= 3
        ws, stats = solver.solve_all(items, 0.0, 0.5)
        assert stats.host_reads == max(stats.bodies) + 1
        assert stats.host_reads < sum(stats.bodies)  # one read a body
        for (b, o, w0), w in zip(items, ws):
            assert torch.equal(solver.solve(b, o, w0, 0.0, 0.5), w)
        assert all(bool(c.all()) for c in stats.converged)

    def test_spd_solve_cg_is_exact_at_d_steps(self):
        rng = np.random.default_rng(0)
        A = rng.normal(size=(4, 6, 6))
        H = torch.as_tensor(A @ A.transpose(0, 2, 1) + 6 * np.eye(6))
        g = torch.as_tensor(rng.normal(size=(4, 6)))
        x = coordinates.spd_solve_cg(H, g, 6)
        np.testing.assert_allclose(
            x.numpy(), np.linalg.solve(H.numpy(), g.numpy()[..., None])[..., 0],
            rtol=1e-9)
        zero = coordinates.spd_solve_cg(torch.zeros(2, 3, 3),
                                        torch.zeros(2, 3), 3)
        assert bool((zero == 0).all())


def _builder_case(case):
    """(task, keys, X, labels, weights, cap) of the reference's builder
    tests: tight padding (one 100-row and one 3-row entity), an entity
    whose kept rows are all zero, and TestBuilderDifferential's random
    draws (real labels, so squared loss)."""
    if case == "tight-padding":
        rng = np.random.default_rng(8)
        keys = np.array(["a"] * 100 + ["b"] * 3, dtype=object)
        X = sp.csr_matrix(rng.normal(size=(103, 5)).astype(np.float32))
        y = (rng.uniform(size=103) < 0.5).astype(np.float32)
        return "logistic", keys, X, y, np.ones(103, np.float32), None
    if case == "degenerate":
        X = np.zeros((5, 3), np.float32)
        X[1:4] = 1.0
        return ("logistic", np.array(["e"] * 5, dtype=object),
                sp.csr_matrix(X), np.array([0, 1, 1, 0, 1], np.float32),
                np.ones(5, np.float32), 2)
    rng = np.random.default_rng(100 + int(case[-1]))
    n = int(rng.integers(30, 400))
    d = int(rng.integers(1, 12))
    n_ent = int(rng.integers(1, 40))
    X = sp.random(n, d, float(rng.uniform(0.05, 0.9)), "csr",
                  dtype=np.float32, random_state=int(rng.integers(1 << 30)))
    keys = np.array([f"e{rng.integers(n_ent)}" for _ in range(n)],
                    dtype=object)
    y = rng.normal(size=n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    cap = (None if int(case[-1]) % 2 == 0
           else int(rng.integers(1, max(2, n // max(1, n_ent)))))
    return "squared", keys, X, y, w, cap


@pytest.mark.parametrize("case", ["tight-padding", "degenerate"]
                         + [f"differential-{t}" for t in range(6)])
def test_builder_cases_solve_as_the_reference(case):
    task, keys, X, y, w, cap = _builder_case(case)
    ds, ref = _both(keys, X, y, w, max_rows_per_entity=cap)
    rng = np.random.default_rng(9)
    cfgs = _configs(max_iters=10, tol=1e-6)
    for block, rblock in zip(ds.blocks, ref.blocks):
        off = (0.3 * rng.normal(size=(block.n_entities,
                                      block.rows_per_entity))
               ).astype(np.float32)
        w0 = np.zeros((block.n_entities, block.block_dim), np.float32)
        got, want = _solve_both(task, cfgs, block, rblock, off, w0, 0.5)
        _close(got, want)
        if case == "degenerate":
            assert np.all(got == 0)


class TestCoordinate:
    def test_train_and_variances_match_reference(self):
        rng, ds, ref, offsets = _bucket_problem(11, "logistic", cap=16)
        port_cfg, ref_cfg = _configs(max_iters=10, tol=1e-6)
        coord = coordinates.RandomEffectCoordinate(
            "re", ds, "logistic", port_cfg, reg_weight=0.5)
        rcoord = ref_coords.RandomEffectCoordinate(
            "re", ref, "logistic", ref_cfg, reg_weight=0.5)
        state = coord.train(torch.as_tensor(offsets[:-1]))
        rstate = rcoord.train(jnp.asarray(offsets[:-1]))
        for s, r in zip(state, rstate):
            _close(s.numpy(), np.asarray(r))
        # Variances at the same coefficients and offsets: one float32
        # reduction apart.
        rs = [jnp.asarray(s.numpy()) for s in state]
        for block, rblock, s, r in zip(ds.blocks, ref.blocks, state, rs):
            got = coord._block_variances(block, s,
                                         torch.as_tensor(offsets[:-1]))
            want = rcoord._block_variances(rblock, r, offsets[:-1])
            np.testing.assert_allclose(got, want, rtol=1e-5)
        # Scores (active and passive rows) and the finalized tables.
        np.testing.assert_allclose(
            coord.score(state).numpy(), np.asarray(rcoord.score(rs)),
            rtol=1e-5, atol=1e-6)
        model, rmodel = coord.finalize(state), rcoord.finalize(rs)
        assert set(model.coefficients) == set(rmodel.coefficients)
        for k, (cols, vals) in model.coefficients.items():
            np.testing.assert_array_equal(cols, rmodel.coefficients[k][0])
            np.testing.assert_array_equal(vals, rmodel.coefficients[k][1])
        assert coord.last_solve.host_reads >= 1

    def test_tf32_switch_changes_nothing(self):
        """The block products are multiply-plus-sum, never a matmul, so the
        TF32 switches cannot reach them (bitwise on any device)."""
        _, ds, _, offsets = _bucket_problem(4, "logistic")
        coord = coordinates.RandomEffectCoordinate(
            "re", ds, "logistic", _configs(10, 1e-6)[0], reg_weight=0.5)
        off = torch.as_tensor(offsets[:-1])
        before = torch.backends.cuda.matmul.allow_tf32
        try:
            torch.backends.cuda.matmul.allow_tf32 = False
            a = coord.train(off)
            torch.backends.cuda.matmul.allow_tf32 = True
            b = coord.train(off)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        assert all(torch.equal(x, y) for x, y in zip(a, b))


class TestFallbackBuckets:
    """The buckets the port once refused (an L1 component, the OWL-QN
    optimizer, D > 32 with R > 1) now run the batched fallback and match
    the reference on the same inputs, each bucket solved by both packages
    in float64 (blocks, offsets and warm starts cast) within 1e-9;
    ``test_torch_game_fallback.py`` holds more."""

    @staticmethod
    def _solve_buckets(ds, ref, cfgs, l1, l2):
        """Each bucket's (port, reference) float64 solution and whether
        the port ran a fallback program."""
        rng = np.random.default_rng(0)
        solver = coordinates.BlockSolver("logistic", cfgs[0])
        rsolver = ref_coords._make_block_solver("logistic", cfgs[1])
        out = []
        for block, rblock in zip(ds.blocks, ref.blocks):
            block = dataclasses.replace(
                block, X=block.X.double(), labels=block.labels.double(),
                weights=block.weights.double())
            rblock = dataclasses.replace(
                rblock, X=rblock.X.astype(jnp.float64),
                labels=rblock.labels.astype(jnp.float64),
                weights=rblock.weights.astype(jnp.float64))
            off = 0.3 * rng.normal(size=(block.n_entities,
                                         block.rows_per_entity))
            w0 = np.zeros((block.n_entities, block.block_dim))
            args = (block, torch.as_tensor(off), torch.as_tensor(w0), l1, l2)
            fallback = solver.program(*args).iterations is not None
            got = solver.solve(*args).numpy()
            want = np.asarray(rsolver(rblock, jnp.asarray(off),
                                      jnp.asarray(w0), jnp.asarray(l1),
                                      jnp.asarray(l2)))
            out.append((got, want, fallback))
        return out

    @pytest.mark.parametrize("reg,optimizer,solver", [
        ("l1", "LBFGS", None), ("elastic_net", "LBFGS", None),
        ("l2", "OWLQN", None), ("l2", "LBFGS", "owlqn")])
    def test_owlqn_blocks_match_reference(self, reg, optimizer, solver):
        _, ds, ref, _ = _bucket_problem(1, "logistic", n_ent=10)

        def cfg(ctx, opt, kind, reg_ns):
            return ctx(
                optimizer=opt(optimizer=kind[optimizer], solver=solver),
                regularization=(reg_ns.elastic_net(0.5)
                                if reg == "elastic_net"
                                else getattr(reg_ns, reg)()))

        cfgs = (cfg(GlmOptimizationConfig, OptimizerConfig, OptimizerType,
                    RegularizationContext),
                cfg(RefConfig, RefOpt, RefOptType, RefReg))
        l1 = cfgs[0].regularization.l1_weight(1.0)
        l2 = cfgs[0].regularization.l2_weight(1.0)
        results = self._solve_buckets(ds, ref, cfgs, l1, l2)
        # Every bucket, R = 1 included, ran OWL-QN.
        assert all(fb for _, _, fb in results)
        assert any(b.rows_per_entity == 1 for b in ds.blocks)
        for got, want, _ in results:
            _close(got, want, rtol=1e-9)

    def test_wide_blocks_match_reference_and_wide_single_rows_solve(self):
        rng = np.random.default_rng(0)
        keys = np.array(["a"] * 3 + ["b"], dtype=object)
        X = sp.csr_matrix(rng.normal(size=(4, 40)).astype(np.float32))
        y = (rng.uniform(size=4) < 0.5).astype(np.float32)
        ds, ref = _both(keys, X, y)
        results = self._solve_buckets(ds, ref, _configs(max_iters=30), 0.0,
                                      1.0)
        # The R = 3, D = 40 bucket ran batched L-BFGS, the single row the
        # rank-1 Newton path.
        assert [fb for _, _, fb in results] == [
            b.rows_per_entity > 1 for b in ds.blocks]
        for got, want, fb in results:
            _close(got, want, rtol=1e-9 if fb else 1e-5)
        single = data.build_random_effect_dataset(
            keys[3:], X[3:], np.zeros(1, np.float32), np.ones(1, np.float32),
            device=CPU)
        coord = coordinates.RandomEffectCoordinate(
            "re", single, "logistic", _configs()[0], reg_weight=1.0)
        assert coord.train(torch.zeros(1))[0].shape == (1, 40)


class TestRefusals:
    @pytest.mark.parametrize("name", ["admm", "block_cd"])
    def test_host_kind_solvers_refused(self, name):
        """A host-kind solver runs the FIXED effect over logical row shards
        of a dense design (the resident L-BFGS objective within 1e-5); the
        reference's refusals stay: a sparse fixed-effect design (no row
        shards of a resident sparse matrix) and the per-entity blocks of a
        random effect."""
        from photon_ml_tpu.data.dataset import make_glm_data as ref_make
        from photon_ml_tpu.game.data import (
            FixedEffectDataset as RefFixedEffectDataset,
        )
        from photon_ml_tpu_torch.data.dataset import make_glm_data
        from photon_ml_tpu_torch.game.data import FixedEffectDataset

        cfg, rcfg = _configs(solver=name)
        X = sp.csr_matrix(np.eye(3, dtype=np.float32))
        fe = FixedEffectDataset(make_glm_data(X, np.zeros(3), device=CPU), 3)
        with pytest.raises(ValueError, match="DenseMatrix"):
            coordinates.FixedEffectCoordinate("fe", fe, "logistic", cfg)
        rfe = RefFixedEffectDataset(ref_make(X, np.zeros(3)), 3)
        with pytest.raises(ValueError, match="DenseMatrix"):
            ref_coords.FixedEffectCoordinate("fe", rfe, "logistic", rcfg)
        _, ds, _, _ = _bucket_problem(1, "logistic", n_ent=10)
        with pytest.raises(ValueError, match="host-kind"):
            coordinates.RandomEffectCoordinate("re", ds, "logistic", cfg)

        rng = np.random.default_rng(4)
        Xd = rng.normal(size=(90, 4)).astype(np.float32)
        y = (rng.uniform(size=90) < 0.5).astype(np.float32)
        off = torch.as_tensor(rng.normal(scale=0.3, size=90)
                              .astype(np.float32))
        opts = (("tolerance", "1e-10"), ("max_rounds", "600")) if (
            name == "block_cd") else (("reltol", "1e-6"),)
        host = GlmOptimizationConfig(optimizer=OptimizerConfig(
            max_iters=200, tolerance=1e-9, solver=name,
            solver_options=opts), regularization=RegularizationContext.l2())
        dense = FixedEffectDataset(make_glm_data(Xd, y, device=CPU), 90)
        w = coordinates.FixedEffectCoordinate(
            "fe", dense, "logistic", host, reg_weight=1.0).train(off)
        w_ref = coordinates.FixedEffectCoordinate(
            "fe", dense, "logistic", _configs(max_iters=200)[0],
            reg_weight=1.0).train(off)

        def objective(w):  # float64, the reference's 1e-5 bar
            w = w.numpy().astype(np.float64)
            m = Xd.astype(np.float64) @ w + off.numpy()
            return (np.sum(np.logaddexp(0.0, m) - y * m)
                    + 0.5 * np.dot(w, w))

        f, f_ref = objective(w), objective(w_ref)
        assert abs(f - f_ref) / max(1.0, abs(f_ref)) <= 1e-5