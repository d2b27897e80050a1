"""The port's out-of-core GLM training (``data/streaming.py``,
``optim/streaming.py``) against the reference's streamed trainer and the
port's own resident objective, on the CPU.

Tolerances:
- the streamed objective against the reference's streamed objective and the
  port's resident one: value rtol 1e-5, gradient, HVP and Hessian diagonal
  within 1e-5 of the largest entry (float32 sums in another order);
- streamed solvers against the reference's streamed solvers, both stopped
  at a relative tolerance of 1e-4 (above the float32 noise floor, where
  the two packages' summation orders decide the last trials; TRON's
  acceptance ratio divides two value differences, so its solves sum the
  value in float64 in both packages): the stationary point within 1e-4 of
  max|w| (OWL-QN 1e-3, as in ``test_torch_solvers.py``), the value rtol
  1e-6, iterations within 3 (5 over a grid's warm starts);
- inside the port the properties the reference pins are bitwise: depth 1 =
  depth 2 = depth 3, a fused pass = an unfused one, a disk store = a RAM
  store, lossless compression and the hot cache change nothing, and
  ``value_and_grad_batch`` row i = ``value_and_grad(w_i)`` with the batched
  line searches taking the one-trial-per-pass trajectory (the reference's
  CPU run fails these last three: ROADMAP Queue 3).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.data.streaming import (
    make_streaming_glm_data as ref_make_stream,
)
from photon_ml_tpu.optim import streaming as ref_streaming
from photon_ml_tpu.optim.lbfgs import LBFGSConfig as RefLBFGSConfig
from photon_ml_tpu.optim.owlqn import OWLQNConfig as RefOWLQNConfig
from photon_ml_tpu.optim.problem import (
    GlmOptimizationConfig as RefConfig,
    GlmOptimizationProblem as RefProblem,
    OptimizerConfig as RefOptimizerConfig,
    OptimizerType as RefOptimizerType,
)
from photon_ml_tpu.optim.regularization import (
    RegularizationContext as RefReg,
)
from photon_ml_tpu.optim.tron import TRONConfig as RefTRONConfig

from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.data.normalization import (
    NormalizationType,
    build_normalization,
)
from photon_ml_tpu_torch.data.stats import summarize
from photon_ml_tpu_torch.data.streaming import (
    make_streaming_glm_data,
    spill_tree,
    streaming_from_blocks,
)
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve
from photon_ml_tpu_torch.optim.objective import GlmObjective
from photon_ml_tpu_torch.optim.owlqn import OWLQNConfig, owlqn_solve
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    GlmOptimizationProblem,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.streaming import (
    HotChunkCache,
    StreamingObjective,
    streaming_run_grid,
)
from photon_ml_tpu_torch.optim.tron import TRONConfig, tron_solve
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

LAYOUTS = ["coo", "kernel", "dense"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _logistic_problem(rng, n, d, density=0.1, seed=3, dense=False):
    """The reference test module's problem: an intercept column first,
    sparse uniform features, labels from a sparse w_true."""
    if dense:
        X = rng.normal(size=(n, d)).astype(np.float32)
        X[:, 0] = 1.0
    else:
        X = sp.random(n, d - 1, density=density, random_state=seed,
                      format="csr", dtype=np.float32)
        X = sp.hstack([sp.csr_matrix(np.ones((n, 1), np.float32)), X]
                      ).tocsr()
    w_true = (rng.normal(size=d) * (rng.uniform(size=d) < 0.3)).astype(
        np.float32)
    logits = np.asarray(X @ w_true).ravel()
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float32)
    return X, y


def _stream(X, y, layout, chunk_rows, **kw):
    if layout == "dense" and sp.issparse(X):
        X = X.toarray()
    return make_streaming_glm_data(X, y, chunk_rows=chunk_rows,
                                   use_kernel=layout == "kernel",
                                   device="cpu", **kw)


def _sobj(problem, stream, **kw):
    """The streamed objective ``streaming_run_grid`` takes, over the
    problem's own objective."""
    return StreamingObjective(problem.objective, stream, **kw)


def _ref_stream(X, y, chunk_rows, **kw):
    return ref_make_stream(X, y, chunk_rows=chunk_rows, use_pallas=False,
                           **kw)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# The streamed objective
# ---------------------------------------------------------------------------


class TestStreamingObjective:
    @pytest.mark.parametrize("accumulate", ["f32", "kahan"])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_value_grad_hvp_diag_scores(self, rng, layout, accumulate):
        """Against the reference's streamed objective and the port's
        resident objective, with per-row offsets."""
        n, d = 900, 40
        X, y = _logistic_problem(rng, n, d, dense=layout == "dense")
        offs = (0.1 * rng.normal(size=n)).astype(np.float32)
        stream = _stream(X, y, layout, 256)
        assert stream.n_chunks == 4 and stream.kind == layout
        sobj = StreamingObjective("logistic", stream, accumulate=accumulate)
        ref = ref_streaming.StreamingObjective(
            "logistic", _ref_stream(X, y, 256), accumulate=accumulate)
        data = make_glm_data(X, y, offsets=offs, device="cpu")
        obj = GlmObjective(losses.get("logistic"))
        w = rng.normal(size=d).astype(np.float32)
        v = rng.normal(size=d).astype(np.float32)
        vs, gs = sobj.value_and_grad(_t(w), 0.5, offsets=offs)
        vr, gr = ref.value_and_grad(jnp.asarray(w), 0.5,
                                    offsets=jnp.asarray(offs))
        vres, gres = obj.value_and_grad(_t(w), data, 0.5)
        for other_v, other_g in ((vr, gr), (vres, gres)):
            np.testing.assert_allclose(float(vs), float(other_v), rtol=1e-5)
            _close(gs.numpy(), np.asarray(other_g))
        hs = sobj.hvp(_t(w), _t(v), 0.5, offsets=offs)
        _close(hs.numpy(), np.asarray(ref.hvp(
            jnp.asarray(w), jnp.asarray(v), 0.5, offsets=jnp.asarray(offs))))
        _close(hs.numpy(), obj.hvp(_t(w), _t(v), data, 0.5).numpy())
        ds = sobj.hessian_diagonal(_t(w), offsets=offs)
        _close(ds.numpy(), np.asarray(ref.hessian_diagonal(
            jnp.asarray(w), offsets=jnp.asarray(offs))))
        _close(ds.numpy(), data.features.sq_rmatvec(
            obj.d2_weights(_t(w), data)).numpy())
        scores = sobj.scores(_t(w))
        assert scores.shape == (n,)
        _close(scores, np.asarray(X @ w).ravel())
        _close(scores, ref.scores(jnp.asarray(w)))

    def test_normalized_objective_matches_reference(self, rng):
        from photon_ml_tpu.data.dataset import make_glm_data as ref_data
        from photon_ml_tpu.data.normalization import (
            NormalizationType as RefNT,
            build_normalization as ref_norm,
        )
        from photon_ml_tpu.data.stats import summarize as ref_summarize
        from photon_ml_tpu.ops import losses as ref_losses
        from photon_ml_tpu.optim.objective import GlmObjective as RefObj

        n, d = 600, 20
        X, y = _logistic_problem(rng, n, d, density=0.2)
        data = make_glm_data(X, y, device="cpu")
        norm = build_normalization(NormalizationType.STANDARDIZATION,
                                   summarize(data), intercept_index=0,
                                   device="cpu")
        rnorm = ref_norm(RefNT.STANDARDIZATION, ref_summarize(ref_data(X, y)),
                         intercept_index=0)
        obj = GlmObjective(losses.get("logistic"), norm)
        sobj = StreamingObjective(obj, _stream(X, y, "kernel", 200))
        rsobj = ref_streaming.StreamingObjective(
            RefObj(ref_losses.get("logistic"), rnorm), _ref_stream(X, y, 200))
        w = rng.normal(size=d).astype(np.float32)
        v = rng.normal(size=d).astype(np.float32)
        vs, gs = sobj.value_and_grad(_t(w), 0.5)
        vr, gr = rsobj.value_and_grad(jnp.asarray(w), 0.5)
        vres, gres = obj.value_and_grad(_t(w), data, 0.5)
        np.testing.assert_allclose(float(vs), float(vr), rtol=1e-5)
        np.testing.assert_allclose(float(vs), float(vres), rtol=1e-5)
        _close(gs.numpy(), np.asarray(gr))
        _close(gs.numpy(), gres.numpy())
        _close(sobj.hvp(_t(w), _t(v), 0.5).numpy(),
               np.asarray(rsobj.hvp(jnp.asarray(w), jnp.asarray(v), 0.5)))

    def test_kahan_beats_f32_on_adversarial_stream(self, rng):
        """Many chunks of alternating huge and tiny contributions: the
        compensated accumulation tracks the float64 oracle within 1e-6."""
        n, d = 4096, 4
        X = np.zeros((n, d), np.float32)
        X[:, 0] = 1.0
        y = np.zeros(n, np.float32)
        w_rows = np.where(np.arange(n) % 2 == 0, 1e7, 1.0).astype(np.float32)
        stream = make_streaming_glm_data(X, y, weights=w_rows, chunk_rows=128,
                                         device="cpu")
        w = _t([1e-3, 0, 0, 0])
        v32, _ = StreamingObjective("linear", stream).value_and_grad(w)
        vk, _ = StreamingObjective("linear", stream,
                                   accumulate="kahan").value_and_grad(w)
        margins = X @ w.numpy().astype(np.float64)
        oracle = float(np.sum(w_rows.astype(np.float64) * 0.5 * margins**2))
        assert abs(float(vk) - oracle) <= abs(float(v32) - oracle)
        assert abs(float(vk) - oracle) <= 1e-6 * abs(oracle) + 1e-6

    def test_f64_objective_accumulates_the_value_in_f64(self, rng):
        X, y = _logistic_problem(rng, 500, 20)
        obj = GlmObjective(losses.get("logistic"), accumulate="f64")
        sobj = StreamingObjective(obj, _stream(X, y, "coo", 128))
        v, g = sobj.value_and_grad(_t(rng.normal(size=20)), 0.1)
        assert v.dtype == torch.float64 and g.dtype == torch.float32

    def test_kernel_chunks_match_coo_chunks(self, rng):
        """The kernel's CSR/CSC chunk layout (its plain versions on the CPU)
        against the COO chunks: the same objective."""
        n, d = 700, 300
        X, y = _logistic_problem(rng, n, d, density=0.05)
        w = _t(rng.normal(size=d))
        v1, g1 = StreamingObjective(
            "logistic", _stream(X, y, "coo", 256)).value_and_grad(w)
        v2, g2 = StreamingObjective(
            "logistic", _stream(X, y, "kernel", 256)).value_and_grad(w)
        np.testing.assert_allclose(float(v1), float(v2), rtol=1e-5)
        _close(g2.numpy(), g1.numpy())


# ---------------------------------------------------------------------------
# Streamed solvers and the grid against the reference's
# ---------------------------------------------------------------------------


def _same_solution(res, rres, w_tol=1e-4, iters=3):
    w, rw = res.w.numpy(), np.asarray(rres.w)
    assert np.abs(w - rw).max() <= w_tol * np.abs(rw).max()
    np.testing.assert_allclose(float(res.value), float(rres.value),
                               rtol=1e-6)
    assert abs(res.iterations - int(rres.iterations)) <= iters


class TestStreamedSolvers:
    @pytest.mark.parametrize("batched", [False, True])
    def test_lbfgs_matches_reference(self, rng, batched):
        n, d = 1200, 50
        X, y = _logistic_problem(rng, n, d)
        sobj = StreamingObjective("logistic", _stream(X, y, "kernel", 400))
        rs = ref_streaming.StreamingObjective("logistic",
                                              _ref_stream(X, y, 400))
        res = lbfgs_solve(
            lambda w: sobj.value_and_grad(w, 1.0), torch.zeros(d),
            LBFGSConfig(max_iters=200, tolerance=1e-4),
            value_and_grad_batch=(lambda ws: sobj.value_and_grad_batch(
                ws, 1.0)) if batched else None)
        rres = ref_streaming.streaming_lbfgs_solve(
            lambda w: rs.value_and_grad(w, 1.0), jnp.zeros(d, jnp.float32),
            RefLBFGSConfig(max_iters=200, tolerance=1e-4))
        _same_solution(res, rres)
        vals = res.values.numpy()[: res.iterations + 1]
        assert np.all(np.diff(vals) <= 0)

    def test_owlqn_matches_reference(self, rng):
        n, d = 700, 30
        X, y = _logistic_problem(rng, n, d, density=0.15)
        mask = np.ones(d, np.float32)
        mask[0] = 0.0  # no L1 on the intercept
        sobj = StreamingObjective("logistic", _stream(X, y, "coo", 256))
        rs = ref_streaming.StreamingObjective("logistic",
                                              _ref_stream(X, y, 256))
        res = owlqn_solve(
            lambda w: sobj.value_and_grad(w, 0.1), torch.zeros(d), 2.0,
            OWLQNConfig(max_iters=200, tolerance=1e-5), l1_mask=_t(mask),
            value_and_grad_batch=lambda ws: sobj.value_and_grad_batch(ws,
                                                                      0.1))
        rres = ref_streaming.streaming_owlqn_solve(
            lambda w: rs.value_and_grad(w, 0.1), jnp.zeros(d, jnp.float32),
            2.0, RefOWLQNConfig(max_iters=200, tolerance=1e-5),
            l1_mask=jnp.asarray(mask))
        _same_solution(res, rres, w_tol=1e-3, iters=5)
        w, rw = res.w.numpy(), np.asarray(rres.w)
        assert np.sum(rw == 0.0) > d // 4
        # Zero in one package and not the other only below 1e-3·max|w|.
        diff = (w == 0.0) != (rw == 0.0)
        assert np.abs(np.where(diff, w - rw, 0.0)).max() <= \
            1e-3 * np.abs(rw).max()

    def test_tron_matches_reference(self, rng):
        from photon_ml_tpu.ops import losses as ref_losses
        from photon_ml_tpu.optim.objective import GlmObjective as RefObj

        n, d = 1200, 50
        X, y = _logistic_problem(rng, n, d)
        sobj = StreamingObjective(
            GlmObjective(losses.get("logistic"), accumulate="f64"),
            _stream(X, y, "kernel", 400))
        rs = ref_streaming.StreamingObjective(
            RefObj(ref_losses.get("logistic"), accumulate="f64"),
            _ref_stream(X, y, 400))
        res = tron_solve(
            lambda w: sobj.value_and_grad(w, 1.0),
            lambda w, v, aux: sobj.hvp(w, v, 1.0), torch.zeros(d),
            TRONConfig(max_iters=100, tolerance=1e-4))
        rres = ref_streaming.streaming_tron_solve(
            lambda w: rs.value_and_grad(w, 1.0),
            lambda w, v: rs.hvp(w, v, 1.0), jnp.zeros(d, jnp.float32),
            RefTRONConfig(max_iters=100, tolerance=1e-4))
        _same_solution(res, rres)
        # TRON and L-BFGS land on one optimum.
        lb = lbfgs_solve(lambda w: sobj.value_and_grad(w, 1.0),
                                   torch.zeros(d),
                                   LBFGSConfig(max_iters=200,
                                               tolerance=1e-7))
        np.testing.assert_allclose(float(res.value), float(lb.value),
                                   rtol=1e-5)

    def test_single_chunk_tracks_the_resident_trajectory(self, rng):
        """With one chunk the streamed L-BFGS runs the resident solver's
        math: the first iterations' objective trace matches."""
        n, d = 400, 20
        X, y = _logistic_problem(rng, n, d, density=0.15)
        data = make_glm_data(X, y, device="cpu")
        obj = GlmObjective(losses.get("logistic"))
        cfg = LBFGSConfig(max_iters=40, tolerance=1e-9)
        res_r = lbfgs_solve(lambda w: obj.value_and_grad(w, data, 0.3),
                            torch.zeros(d), cfg)
        sobj = StreamingObjective("logistic", _stream(X, y, "coo", n))
        res_s = lbfgs_solve(lambda w: sobj.value_and_grad(w, 0.3),
                                      torch.zeros(d), cfg)
        k = min(5, res_r.iterations, res_s.iterations)
        np.testing.assert_allclose(res_s.values.numpy()[: k + 1],
                                   res_r.values.numpy()[: k + 1], rtol=1e-4)


def _problems(opt="lbfgs", reg="l2", compute_variances=False, alpha=0.5,
              max_iters=150, tolerance=1e-4, accumulate="f32"):
    reg_port = {"l2": RegularizationContext.l2(),
                "l1": RegularizationContext.l1(),
                "elastic_net": RegularizationContext.elastic_net(alpha)}[reg]
    reg_ref = {"l2": RefReg.l2(), "l1": RefReg.l1(),
               "elastic_net": RefReg.elastic_net(alpha)}[reg]
    port = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
        optimizer=OptimizerConfig(optimizer=OptimizerType(opt),
                                  max_iters=max_iters, tolerance=tolerance),
        regularization=reg_port, compute_variances=compute_variances),
        accumulate=accumulate)
    ref = RefProblem("logistic", RefConfig(
        optimizer=RefOptimizerConfig(optimizer=RefOptimizerType(opt),
                                     max_iters=max_iters,
                                     tolerance=tolerance),
        regularization=reg_ref, compute_variances=compute_variances),
        accumulate=accumulate)
    return port, ref


class TestStreamingGrid:
    @pytest.mark.parametrize("case", [
        ("lbfgs", "l2", [0.5, 2.0], 1e-4, 1e-4),
        ("lbfgs", "l1", [2.0], 1e-3, 1e-4),
        # A warm-started TRON solve starts near the optimum, where its
        # tolerance times a small ‖g0‖ lies below what the float32 per-row
        # losses resolve; it stops on the relative decrease at 1e-3.
        ("tron", "l2", [0.5, 2.0], 1e-3, 1e-3),
        ("tron", "elastic_net", [1.0], 1e-3, 1e-4),  # routes to OWL-QN
    ], ids=["l2", "l1", "tron", "tron-elastic-net"])
    def test_grid_matches_reference(self, rng, case):
        opt, reg, lams, w_tol, tolerance = case
        n, d = 800, 30
        X, y = _logistic_problem(rng, n, d, density=0.15)
        port, ref = _problems(opt, reg, tolerance=tolerance,
                              accumulate="f64" if opt == "tron" else "f32")
        grid = streaming_run_grid(
            port, _sobj(port, _stream(X, y, "kernel", 256)), lams)
        rgrid = ref_streaming.streaming_run_grid(ref, _ref_stream(X, y, 256),
                                                 lams)
        assert [lam for lam, _, _ in grid] == [lam for lam, _, _ in rgrid]
        for (_, model, res), (_, rmodel, rres) in zip(grid, rgrid):
            _same_solution(res, rres, w_tol=w_tol, iters=5)
            w = model.coefficients.means.numpy()
            rw = np.asarray(rmodel.coefficients.means)
            assert np.abs(w - rw).max() <= w_tol * np.abs(rw).max()
        if reg != "l2":
            assert np.sum(w == 0.0) > 0

    def test_variances_match_reference(self, rng):
        X, y = _logistic_problem(rng, 400, 15, density=0.2)
        port, ref = _problems(compute_variances=True, max_iters=100)
        grid = streaming_run_grid(
            port, _sobj(port, _stream(X, y, "coo", 128)), [1.0])
        rgrid = ref_streaming.streaming_run_grid(ref, _ref_stream(X, y, 128),
                                                 [1.0])
        np.testing.assert_allclose(
            grid[0][1].coefficients.variances.numpy(),
            np.asarray(rgrid[0][1].coefficients.variances), rtol=1e-3)

    def test_grid_matches_resident_grid(self, rng):
        X, y = _logistic_problem(rng, 800, 30)
        port, _ = _problems()
        lams = [0.5, 2.0]
        resident = port.run_grid(make_glm_data(X, y, device="cpu"), lams)
        grid = streaming_run_grid(
            port, _sobj(port, _stream(X, y, "kernel", 256),
                        accumulate="kahan"), lams)
        for (_, m_r, _), (_, m_s, _) in zip(resident, grid):
            w_r = m_r.coefficients.means.numpy()
            assert np.abs(m_s.coefficients.means.numpy() - w_r).max() <= \
                1e-4 * np.abs(w_r).max()

    def test_solved_chain_and_on_solved(self, rng):
        """The grid's checkpoint chain: a λ restored from ``solved`` skips
        its solve, the rest warm-start from it bitwise as an uninterrupted
        grid does, and ``on_solved`` fires for each fresh solve."""
        X, y = _logistic_problem(rng, 600, 20)
        port, _ = _problems()
        stream = _stream(X, y, "coo", 200)
        lams = [5.0, 1.0, 0.2]
        sobj = _sobj(port, stream)
        full = streaming_run_grid(port, sobj, lams)
        seen = []
        resumed = streaming_run_grid(
            port, sobj, lams,
            solved={5.0: full[0][1].coefficients.means.numpy()},
            on_solved=lambda lam, w: seen.append(lam))
        assert seen == [1.0, 0.2] and resumed[0][2] is None
        for (_, a, _), (_, b, _) in zip(full, resumed):
            assert torch.equal(a.coefficients.means, b.coefficients.means)
        warm = streaming_run_grid(port, sobj, [1.0],
                                  w0=full[0][1].coefficients.means)
        assert warm[0][2].iterations <= full[1][2].iterations


# ---------------------------------------------------------------------------
# In-port bitwise properties
# ---------------------------------------------------------------------------


def _stream4(rng, layout="coo", n=640, d=24, chunk_rows=160):
    X, y = _logistic_problem(rng, n, d, density=0.15,
                             dense=layout == "dense")
    return X, y, _stream(X, y, layout, chunk_rows)


def _equal(a, b):
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


class TestPipelineParity:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_depths_bit_identical(self, rng, layout):
        """depth 1 (serial) = depth 2 = depth 3, for every pass kind."""
        _, _, stream = _stream4(rng, layout)
        assert stream.n_chunks == 4
        w = _t(rng.normal(size=stream.n_features))
        v = _t(rng.normal(size=stream.n_features))
        objs = [StreamingObjective("logistic", stream, prefetch_depth=k)
                for k in (1, 2, 3)]
        outs = [(o.value_and_grad(w, 0.5), o.hvp(w, v, 0.5),
                 o.hessian_diagonal(w), o.scores(w)) for o in objs]
        for (vg, h, dg, sc) in outs[1:]:
            _equal(vg[0], outs[0][0][0])
            _equal(vg[1], outs[0][0][1])
            _equal(h, outs[0][1])
            _equal(dg, outs[0][2])
            np.testing.assert_array_equal(sc, outs[0][3])
        assert all(o.transfer_stats.max_live <= o.prefetch_depth
                   for o in objs)

    @pytest.mark.parametrize("fuse", [2, 3, 99])
    def test_fused_chunks_match_unfused(self, rng, fuse):
        """A fused group is one transfer and an in-order loop: bitwise the
        unfused pass, the ragged tail included (fuse 3 → groups 3 + 1)."""
        _, _, stream = _stream4(rng, "kernel")
        w = _t(rng.normal(size=stream.n_features))
        v = _t(rng.normal(size=stream.n_features))
        ref = StreamingObjective("logistic", stream)
        fused = StreamingObjective("logistic", stream, chunk_fuse=fuse)
        if fuse == 3:
            assert [len(g) for g in fused._groups] == [3, 1]
        for a, b in zip(ref.value_and_grad(w, 0.5),
                        fused.value_and_grad(w, 0.5)):
            _equal(a, b)
        _equal(ref.hvp(w, v, 0.5), fused.hvp(w, v, 0.5))
        np.testing.assert_array_equal(ref.scores(w), fused.scores(w))
        assert fused.transfer_stats.chunks == len(fused._groups) * 3

    def test_fuse_rejects_invalid_and_mesh(self, rng):
        _, _, stream = _stream4(rng)
        with pytest.raises(ValueError, match="chunk_fuse"):
            StreamingObjective("logistic", stream, chunk_fuse=0)
        # The reference's guards with a mesh: a fused group is
        # single-device, and a store without shards carries none to feed
        # a rank.
        with pytest.raises(ValueError, match="single-device"):
            StreamingObjective("logistic", stream, mesh=object(),
                               chunk_fuse=2)
        with pytest.raises(ValueError, match="no shard axis"):
            StreamingObjective("logistic", stream, mesh=object())

    @pytest.mark.parametrize("accumulate", ["f32", "kahan"])
    def test_batched_vg_rows_match_single(self, rng, accumulate):
        """value_and_grad_batch row i = value_and_grad(w_i), bitwise (the
        reference's CPU run fails this one)."""
        _, _, stream = _stream4(rng, "kernel")
        sobj = StreamingObjective("logistic", stream, accumulate=accumulate)
        ws = _t(rng.normal(size=(3, stream.n_features)))
        vb, gb = sobj.value_and_grad_batch(ws, 0.7)
        for i in range(3):
            vi, gi = sobj.value_and_grad(ws[i], 0.7)
            _equal(vb[i], vi)
            _equal(gb[i], gi)

    def test_batched_linesearch_same_trajectory(self, rng):
        _, _, stream = _stream4(rng, "kernel")
        cfg = LBFGSConfig(max_iters=40, tolerance=1e-8)
        w0 = torch.zeros(stream.n_features)
        sobj = StreamingObjective("logistic", stream)
        res_seq = lbfgs_solve(lambda w: sobj.value_and_grad(w, 0.3),
                                        w0, cfg)
        passes_seq = sobj.transfer_stats.passes
        res_bat = lbfgs_solve(
            lambda w: sobj.value_and_grad(w, 0.3), w0, cfg,
            value_and_grad_batch=lambda ws: sobj.value_and_grad_batch(ws,
                                                                      0.3))
        passes_bat = sobj.transfer_stats.passes - passes_seq
        assert res_bat.iterations == res_seq.iterations
        _equal(res_bat.w, res_seq.w)
        np.testing.assert_array_equal(res_bat.values.numpy(),
                                      res_seq.values.numpy())
        assert passes_bat <= passes_seq

    def test_batched_linesearch_owlqn_same_trajectory(self, rng):
        _, _, stream = _stream4(rng, "kernel")
        cfg = OWLQNConfig(max_iters=30, tolerance=1e-8)
        w0 = torch.zeros(stream.n_features)
        sobj = StreamingObjective("logistic", stream)
        res_seq = owlqn_solve(
            lambda w: sobj.value_and_grad(w, 0.1), w0, 0.05, cfg)
        passes_seq = sobj.transfer_stats.passes
        res_bat = owlqn_solve(
            lambda w: sobj.value_and_grad(w, 0.1), w0, 0.05, cfg,
            value_and_grad_batch=lambda ws: sobj.value_and_grad_batch(ws,
                                                                      0.1))
        assert res_bat.iterations == res_seq.iterations
        _equal(res_bat.w, res_seq.w)
        assert sobj.transfer_stats.passes - passes_seq <= passes_seq

    def test_failed_pass_leaves_the_objective_reusable(self, rng,
                                                       monkeypatch):
        """A pass that dies mid-stream leaves no stale state behind: the
        next pass equals an undisturbed objective's."""
        _, _, stream = _stream4(rng)
        sobj = StreamingObjective("logistic", stream, prefetch_depth=2)
        w = _t(rng.normal(size=stream.n_features))
        ref_v, ref_g = StreamingObjective("logistic",
                                          stream).value_and_grad(w, 0.5)
        orig = sobj._host_item

        def exploding(i):
            if i == 2:
                raise RuntimeError("ingest exploded mid-pass")
            return orig(i)

        monkeypatch.setattr(sobj, "_host_item", exploding)
        with pytest.raises(RuntimeError, match="ingest exploded"):
            sobj.value_and_grad(w, 0.5)
        monkeypatch.undo()
        v2, g2 = sobj.value_and_grad(w, 0.5)
        _equal(v2, ref_v)
        _equal(g2, ref_g)

    def test_counters_monotone(self, rng):
        _, _, stream = _stream4(rng)
        sobj = StreamingObjective("logistic", stream)
        w = torch.zeros(stream.n_features)
        prev = (0,) * 7
        for _ in range(3):
            sobj.value_and_grad(w, 0.5)
            st = sobj.transfer_stats
            cur = (st.consumer_stalls, st.producer_stalls,
                   st.consumer_stall_seconds, st.producer_stall_seconds,
                   st.pack_seconds, st.h2d_seconds, st.chunks)
            assert all(c >= p for c, p in zip(cur, prev))
            prev = cur
        assert st.passes == 3 and st.chunks == 3 * stream.n_chunks


class TestTransferAvoidance:
    def test_compressed_cached_parity(self, rng):
        """Lossless + a hot cache that holds everything: bitwise the raw
        uncached stream for every pass kind, with fewer wire bytes and,
        from the third pass, no transfers at all."""
        X, y, stream = _stream4(rng, "kernel")
        w = _t(rng.normal(size=stream.n_features))
        v = _t(rng.normal(size=stream.n_features))
        ws = torch.stack([w, 0.5 * w, 2.0 * w])
        raw = StreamingObjective("logistic", stream)
        ta = StreamingObjective("logistic", stream, compress="lossless",
                                hot_budget_bytes=1 << 30)
        assert ta.compression_ratio > 1.0
        v0, g0 = raw.value_and_grad(w, 0.5)
        for _ in range(3):  # pass 2 admits, pass 3 hits
            v1, g1 = ta.value_and_grad(w, 0.5)
        assert ta._hot_cache.hits > 0
        _equal(v0, v1)
        _equal(g0, g1)
        chunks = ta.transfer_stats.chunks
        for a, b in zip(raw.value_and_grad_batch(ws, 0.5),
                        ta.value_and_grad_batch(ws, 0.5)):
            _equal(a, b)
        assert ta.transfer_stats.chunks == chunks
        _equal(raw.hvp(w, v, 0.5), ta.hvp(w, v, 0.5))
        _equal(raw.hessian_diagonal(w), ta.hessian_diagonal(w))
        np.testing.assert_array_equal(raw.scores(w), ta.scores(w))
        s = ta.transfer_stats
        assert s.logical_bytes > s.bytes > 0 and s.compression_ratio > 1.0

    @pytest.mark.parametrize("depth", [1, 2])
    @pytest.mark.parametrize("fuse", [1, 2])
    @pytest.mark.parametrize("budget", ["zero", "half", "huge"])
    def test_cached_vs_uncached_bitwise_grid(self, rng, depth, fuse, budget):
        _, _, stream = _stream4(rng)
        w = _t(rng.normal(size=stream.n_features))
        v0, g0 = StreamingObjective("logistic", stream).value_and_grad(w, 0.5)
        probe = StreamingObjective("logistic", stream, compress="lossless",
                                   chunk_fuse=fuse)
        item_bytes = max(probe._item_wire(i)
                         for i in range(len(probe._groups)))
        budget_bytes = {"zero": 0, "half": 1 * item_bytes + 1,
                        "huge": 1 << 30}[budget]
        ta = StreamingObjective("logistic", stream, compress="lossless",
                                hot_budget_bytes=budget_bytes,
                                prefetch_depth=depth, chunk_fuse=fuse)
        for _ in range(3):
            v1, g1 = ta.value_and_grad(w, 0.5)
            _equal(v0, v1)
            _equal(g0, g1)
        if budget == "half":
            assert 0 < ta._hot_cache.resident_bytes <= budget_bytes
            assert ta._hot_cache.hits > 0
        if budget == "huge":
            chunks = ta.transfer_stats.chunks
            v1, g1 = ta.value_and_grad(w, 0.5)
            assert ta.transfer_stats.chunks == chunks
            _equal(v0, v1)

    @pytest.mark.parametrize("mode,bound", [("fp16", 1e-3), ("int8", 3e-2)])
    def test_lossy_modes_stay_close(self, rng, mode, bound):
        """fp16/int8 quantize the float feature values (within the staging
        tests' per-slot bounds): the objective moves by at most ``bound``
        relative."""
        _, _, stream = _stream4(rng, "kernel")
        w = _t(rng.normal(size=stream.n_features))
        v0, g0 = StreamingObjective("logistic", stream).value_and_grad(w, 0.5)
        v1, g1 = StreamingObjective("logistic", stream,
                                    compress=mode).value_and_grad(w, 0.5)
        assert abs(float(v1) - float(v0)) <= bound * abs(float(v0))
        _close(g1.numpy(), g0.numpy(), rel=bound * 10)

    def test_admission_determinism_under_tie(self):
        cache = HotChunkCache(budget_bytes=250)  # fits exactly 2 items
        scores = {i: 1.0 for i in range(6)}
        cache.replan(scores, lambda i: 100)
        assert [i for i in range(6)
                if cache.maybe_admit(i, object(), 100)] == [0, 1]
        scores[5] = 2.0
        cache.replan(scores, lambda i: 100)
        assert cache.maybe_admit(5, object(), 100)
        assert not cache.maybe_admit(2, object(), 100)
        assert cache.evictions == 1
        assert len(cache) == 2 and cache.resident_bytes == 200


class TestChunkStore:
    def test_uniform_rows_padding_and_from_blocks(self, rng):
        X, y = _logistic_problem(rng, 700, 12)
        w = rng.uniform(0.5, 2.0, size=700).astype(np.float32)
        one = make_streaming_glm_data(X, y, weights=w, chunk_rows=256,
                                      device="cpu")
        assert one.n_chunks == 3 and one.n_rows == 700
        assert all(c.n_rows == 256 for c in one.chunks)
        np.testing.assert_array_equal(one.chunks[-1].weights[700 - 512:], 0)
        assert sum(float(c.weights.sum()) for c in one.chunks) == \
            pytest.approx(float(w.sum()), rel=1e-6)
        blocks = [(X[i:i + 90], y[i:i + 90], w[i:i + 90])
                  for i in range(0, 700, 90)]
        cut = streaming_from_blocks(blocks, n_features=12, chunk_rows=256,
                                    use_kernel=False, device="cpu")
        for a, b in zip(one.staged, cut.staged):
            for x, z in zip(a, b):
                np.testing.assert_array_equal(x, z)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_disk_store_bit_identical_to_ram(self, tmp_path, rng, layout):
        X, y = _logistic_problem(rng, 700, 12, density=0.4,
                                 dense=layout == "dense")
        ram = _stream(X, y, layout, 256)
        disk = _stream(X, y, layout, 256, storage_dir=str(tmp_path / "s"))
        for cr, cd in zip(ram.chunks, disk.chunks):
            assert sorted(cr.leaves) == sorted(cd.leaves)
            assert any(isinstance(a.base, np.memmap) or isinstance(
                a, np.memmap) for a in cd.leaves.values())
            for k in cr.leaves:
                np.testing.assert_array_equal(cr.leaves[k], cd.leaves[k])
        cfg = LBFGSConfig(max_iters=30, tolerance=1e-9)
        sols = [lbfgs_solve(
            lambda w, s=s: StreamingObjective(
                "logistic", s).value_and_grad(w, 1.0),
            torch.zeros(12), cfg).w for s in (ram, disk)]
        _equal(sols[0], sols[1])

    def test_nonempty_storage_dir_refused(self, tmp_path, rng):
        X, y = _logistic_problem(rng, 100, 5)
        store = tmp_path / "store"
        store.mkdir()
        (store / "stale.npy").write_bytes(b"x")
        with pytest.raises(ValueError, match="not empty"):
            make_streaming_glm_data(X, y, chunk_rows=64, device="cpu",
                                    storage_dir=str(store))

    def test_spill_tree_memmaps_leaves(self, tmp_path):
        tree = {"a": np.arange(5, dtype=np.int32), "b": np.zeros(0)}
        out = spill_tree(tree, str(tmp_path), "t")
        assert isinstance(out["a"], np.memmap) and out["b"].size == 0
        np.testing.assert_array_equal(out["a"], tree["a"])

    def test_guards_and_refusals(self, rng):
        X, y = _logistic_problem(rng, 200, 8)
        stream = _stream(X, y, "coo", 64)
        # Sharded stores: chunk_rows rounds up to a multiple of the shards
        # (the reference's arithmetic); a rank's store needs its group.
        sharded = make_streaming_glm_data(X, y, chunk_rows=63, n_shards=2,
                                          device="cpu")
        assert (sharded.chunk_rows, sharded.per_shard) == (64, 32)
        assert sharded.n_chunks == 4 and len(sharded.chunks) == 8
        with pytest.raises(ValueError, match="n_shards"):
            make_streaming_glm_data(X, y, chunk_rows=64, n_shards=0,
                                    device="cpu")
        with pytest.raises(ValueError, match="chunk_rows"):
            make_streaming_glm_data(X, y, chunk_rows=0, device="cpu")
        for kw, match in (({"compress": "zstd"}, "compress must be one of"),
                          ({"hot_budget_bytes": -1}, "hot_budget_bytes"),
                          ({"prefetch_depth": 0}, "prefetch_depth"),
                          ({"accumulate": "f16"}, "accumulate")):
            with pytest.raises(ValueError, match=match):
                StreamingObjective("logistic", stream, **kw)
        sobj = StreamingObjective("logistic", stream)
        with pytest.raises(ValueError, match="rows"):
            sobj.value_and_grad(torch.zeros(8), offsets=np.zeros(199))
        with pytest.raises(ValueError, match="StreamingObjective's"):
            streaming_run_grid(_problems()[0], sobj, [1.0], mesh=object())
        with pytest.raises(ValueError, match="problem.objective"):
            streaming_run_grid(_problems(accumulate="f64")[0], sobj, [1.0])
        with pytest.raises(RuntimeError, match="keep_coo"):
            stream_k = _stream(X, y, "kernel", 64)
            sobj_k = StreamingObjective("logistic", stream_k)
            sobj_k._chunk_data(0, [torch.from_numpy(np.array(b))
                                   for b in stream_k.staged[0]]
                               ).features.col_nnz()

    def test_spg_has_no_streamed_form(self, rng):
        X, y = _logistic_problem(rng, 200, 8)
        problem = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
            optimizer=OptimizerConfig(solver="spg")))
        with pytest.raises(ValueError):
            streaming_run_grid(
                problem, _sobj(problem, _stream(X, y, "coo", 64)), [1.0])
