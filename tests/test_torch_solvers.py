"""The port's OWL-QN, TRON, SPG and solver registry against the JAX package's.

Mirrors ``tests/test_optimizers.py`` (``TestOWLQN``, ``TestTRON``,
``TestSPGBoxConstraints``, ``TestProblemDispatch``) and
``tests/test_solvers.py`` (``TestRegistry``, ``TestDispatchParity``, resident
cases): the same seeded numpy inputs go through both packages (the Pallas
kernel in interpret mode), and the port's solves must match.

Tolerances: coefficients within 1e-4 of the reference's largest component,
the objective within rtol 1e-6, iteration counts within ±3 (the packages sum
in different orders, so late decisions may differ) and the same
``converged``.  OWL-QN: the same support, except coefficients under
1e-4·max|w| in either package.  SPG: the same active bounds under the same
exception.  Solves with a float32 value stop at a relative tolerance of
1e-4 (OWL-QN 1e-3; float64 values 1e-5): at the float32 noise floor an
objective decrease of one ulp decides whether the last line-search trial
is accepted or halved, and the two packages round differently there.
"""

import os

import numpy as np
import pytest
import scipy.optimize
import scipy.sparse as sp
import torch

import jax.numpy as jnp

os.environ.setdefault("PHOTON_PALLAS_INTERPRET", "1")

from photon_ml_tpu.data.dataset import make_glm_data as jax_make_glm_data
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.optim import lbfgs as jax_lbfgs
from photon_ml_tpu.optim import owlqn as jax_owlqn
from photon_ml_tpu.optim import problem as jax_problem
from photon_ml_tpu.optim import projected as jax_projected
from photon_ml_tpu.optim import tron as jax_tron
from photon_ml_tpu.optim.objective import GlmObjective as JaxObjective
from photon_ml_tpu.optim.regularization import (
    RegularizationContext as JaxReg,
)

from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.optim import lbfgs, owlqn, projected, tron
from photon_ml_tpu_torch.optim.objective import GlmObjective
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    GlmOptimizationProblem,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from photon_ml_tpu_torch.solvers import registry
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- problems --------------------------------------------------------------


def _dense_logistic(rng, n=200, d=10):
    """The reference tests' float64 logistic problem, in both packages."""
    X = rng.normal(size=(n, d))
    w_true = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-X @ w_true))).astype(
        np.float64)
    data = make_glm_data(X, y, dtype=torch.float64, device="cpu")
    jdata = jax_make_glm_data(X, y, dtype=jnp.float64)
    return X, y, data, jdata


def _sparse_task(task, seed, n=600, d=40, density=0.15):
    """Sparse float32 features with an intercept column, labels drawn from a
    sparse true model under ``task``'s link."""
    rng = np.random.default_rng(seed)
    X = sp.random(n, d - 1, density=density,
                  random_state=np.random.RandomState(seed), format="csr",
                  dtype=np.float32)
    X.data = rng.normal(size=X.nnz).astype(np.float32)
    X = sp.hstack([X, np.ones((n, 1), np.float32)], format="csr")
    w_true = (rng.normal(size=d) * (rng.uniform(size=d) < 0.4)).astype(
        np.float32)
    m = X @ w_true
    if task == "logistic":
        y = rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-m))
    elif task == "linear":
        y = m + 0.3 * rng.normal(size=n)
    elif task == "poisson":
        y = rng.poisson(np.exp(0.3 * m))
    else:  # smoothed hinge: {0, 1}, the loss maps them to ±1
        y = m + 0.3 * rng.normal(size=n) > 0
    return X, np.asarray(y, np.float32)


_REG = {
    "l1": (RegularizationContext.l1(), JaxReg.l1()),
    "l2": (RegularizationContext.l2(), JaxReg.l2()),
    "elastic": (RegularizationContext.elastic_net(0.5),
                JaxReg.elastic_net(0.5)),
}


def _problems(task, reg, optimizer="LBFGS", solver=None, tolerance=None,
              max_iters=200, accumulate="f32"):
    port_reg, ref_reg = _REG[reg]
    if tolerance is None:
        # OWL-QN's Armijo backtrack has no curvature condition: with a
        # float32 value, its last step before 1e-4 would be one of a few
        # ulps of decrease, accepted or halved by rounding.
        owlqn_f32 = reg != "l2" or solver == "owlqn"
        tolerance = (1e-5 if accumulate == "f64"
                     else 1e-3 if owlqn_f32 else 1e-4)
    port = GlmOptimizationProblem(task, GlmOptimizationConfig(
        optimizer=OptimizerConfig(
            optimizer=OptimizerType[optimizer], max_iters=max_iters,
            tolerance=tolerance, solver=solver),
        regularization=port_reg), accumulate=accumulate)
    ref = jax_problem.GlmOptimizationProblem(task, jax_problem.GlmOptimizationConfig(
        optimizer=jax_problem.OptimizerConfig(
            optimizer=jax_problem.OptimizerType[optimizer],
            max_iters=max_iters, tolerance=tolerance, solver=solver),
        regularization=ref_reg), accumulate=accumulate)
    return port, ref


def _solve_sparse(task, reg, lam, seed, bounds=None, mask_intercept=False,
                  ref_accumulate=None, **kw):
    """(res, jres) of one problem.solve_single_device in each package, on
    the kernel layout (plain version on the CPU) and the Pallas layout;
    ``ref_accumulate`` overrides the reference's value accumulation."""
    X, y = _sparse_task(task, seed)
    port, ref = _problems(task, reg, **kw)
    if ref_accumulate is not None:
        _, ref = _problems(task, reg, **{**kw, "accumulate": ref_accumulate})
    d = X.shape[1]
    mask = jmask = None
    if mask_intercept:
        m = np.ones(d, np.float32)
        m[-1] = 0.0
        mask, jmask = torch.from_numpy(m), jnp.asarray(m)
    jb = None
    if bounds is not None:
        jb = tuple(jnp.asarray(b) for b in bounds)
        bounds = tuple(torch.from_numpy(b) for b in bounds)
    res = port.solve_single_device(
        make_glm_data(X, y, use_kernel=True, device="cpu"), lam,
        l1_mask=mask, bounds=bounds)
    jres = ref.solve_single_device(
        jax_make_glm_data(X, y, use_pallas=True), lam, l1_mask=jmask,
        bounds=jb)
    return res, jres


# -- tolerances ------------------------------------------------------------


def _assert_same_solution(res, jres, w_tol=1e-4, iters=3):
    w, jw = res.w.numpy(), np.asarray(jres.w)
    scale = np.abs(jw).max()
    assert np.abs(w - jw).max() <= w_tol * scale
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-6)
    assert abs(res.iterations - int(jres.iterations)) <= iters
    assert res.converged == bool(jres.converged)


def _assert_same_support(w, jw, tol=1e-4):
    """Zero in one package and not the other only below tol·max|w|."""
    w, jw = np.asarray(w), np.asarray(jw)
    differ = (w != 0) != (jw != 0)
    small = np.maximum(np.abs(w), np.abs(jw)) <= tol * np.abs(jw).max()
    assert bool(np.all(small[differ])), np.flatnonzero(differ & ~small)


def _assert_same_active_bounds(w, jw, lower, upper, tol=1e-4):
    """At a bound in one package and not the other only within
    tol·max|w| of that bound."""
    w, jw = np.asarray(w), np.asarray(jw)
    slack = tol * np.abs(jw).max()
    for b in (lower, upper):
        differ = (w == b) != (jw == b)
        near = np.maximum(np.abs(w - b), np.abs(jw - b)) <= slack
        assert bool(np.all(near[differ])), np.flatnonzero(differ & ~near)


def _monotone(res):
    v = res.values.numpy()[: res.iterations + 1].astype(np.float64)
    return bool(np.all(np.diff(v) <= 0))


# -- TestOWLQN ---------------------------------------------------------------


class TestOWLQN:
    def test_soft_threshold_closed_form(self):
        # min ½‖w - a‖² + λ‖w‖₁ has solution soft(a, λ).
        a = np.array([3.0, -2.0, 0.5, -0.1, 0.0])
        ta, ja = torch.from_numpy(a), jnp.asarray(a)
        cfg = owlqn.OWLQNConfig(tolerance=1e-10)
        res = owlqn.owlqn_solve(lambda w: (0.5 * torch.dot(w - ta, w - ta),
                                           w - ta),
                                torch.zeros(5, dtype=torch.float64), 1.0, cfg)
        jres = jax_owlqn.owlqn_solve(
            lambda w: (0.5 * jnp.vdot(w - ja, w - ja), w - ja),
            jnp.zeros(5, jnp.float64), 1.0,
            jax_owlqn.OWLQNConfig(tolerance=1e-10))
        expected = np.sign(a) * np.maximum(np.abs(a) - 1.0, 0)
        np.testing.assert_allclose(res.w.numpy(), expected, atol=1e-6)
        _assert_same_solution(res, jres, w_tol=1e-6)
        np.testing.assert_array_equal(res.w.numpy() != 0,
                                      np.asarray(jres.w) != 0)

    def test_l1_logistic_sparsity_and_optimality(self, rng):
        X, y, data, jdata = _dense_logistic(rng, n=300, d=20)
        lam = 20.0
        obj = GlmObjective(losses.logistic)
        jobj = JaxObjective(jax_losses.logistic)
        res = owlqn.owlqn_solve(lambda w: obj.value_and_grad(w, data),
                                torch.zeros(20, dtype=torch.float64), lam,
                                owlqn.OWLQNConfig(max_iters=300,
                                                  tolerance=1e-9))
        jres = jax_owlqn.owlqn_solve(
            lambda w: jobj.value_and_grad(w, jdata),
            jnp.zeros(20, jnp.float64), lam,
            jax_owlqn.OWLQNConfig(max_iters=300, tolerance=1e-9))
        w = res.w.numpy()
        assert np.sum(w == 0.0) > 0
        # KKT: |g_i| <= λ where w_i == 0; g_i = -λ·sign(w_i) otherwise.
        _, g = obj.value_and_grad(res.w, data)
        g = g.numpy()
        assert np.all(np.abs(g[w == 0.0]) <= lam + 1e-4)
        np.testing.assert_allclose(g[w != 0.0], -lam * np.sign(w[w != 0.0]),
                                   atol=1e-4)
        _assert_same_solution(res, jres)
        _assert_same_support(w, jres.w)
        # The returned gradient is the pseudo-gradient, as in the reference.
        np.testing.assert_allclose(res.grad.numpy(), np.asarray(jres.grad),
                                   atol=1e-4)

    def test_l1_mask_exempts_intercept(self, rng):
        n = 200
        X = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 3))], axis=1)
        y = (rng.uniform(size=n) < 0.8).astype(np.float64)
        data = make_glm_data(X, y, dtype=torch.float64, device="cpu")
        jdata = jax_make_glm_data(X, y, dtype=jnp.float64)
        obj = GlmObjective(losses.logistic)
        jobj = JaxObjective(jax_losses.logistic)
        mask = np.array([0.0, 1.0, 1.0, 1.0])
        res = owlqn.owlqn_solve(lambda w: obj.value_and_grad(w, data),
                                torch.zeros(4, dtype=torch.float64), 1e4,
                                owlqn.OWLQNConfig(max_iters=200),
                                l1_mask=torch.from_numpy(mask))
        jres = jax_owlqn.owlqn_solve(
            lambda w: jobj.value_and_grad(w, jdata),
            jnp.zeros(4, jnp.float64), 1e4,
            jax_owlqn.OWLQNConfig(max_iters=200), l1_mask=jnp.asarray(mask))
        w = res.w.numpy()
        np.testing.assert_allclose(w[1:], 0.0, atol=1e-8)
        expected = np.log(np.mean(y) / (1 - np.mean(y)))
        np.testing.assert_allclose(w[0], expected, atol=1e-2)
        _assert_same_solution(res, jres)

    @pytest.mark.parametrize("accumulate", ["f32", "f64"])
    @pytest.mark.parametrize("reg", ["l1", "elastic"])
    @pytest.mark.parametrize("task", ["logistic", "linear", "poisson",
                                      "smoothed_hinge"])
    def test_losses_match_jax(self, task, reg, accumulate):
        lam = {"logistic": 4.0, "linear": 8.0, "poisson": 6.0,
               "smoothed_hinge": 3.0}[task]
        res, jres = _solve_sparse(task, reg, lam, seed=11,
                                  mask_intercept=True, accumulate=accumulate)
        _assert_same_solution(res, jres)
        _assert_same_support(res.w.numpy(), jres.w)
        assert _monotone(res)
        w = res.w.numpy()
        assert 0 < np.sum(w[:-1] == 0.0) < w.size - 1  # L1 zeroes some
        assert w[-1] != 0.0  # the intercept is exempt


# -- TestTRON ---------------------------------------------------------------


class TestTRON:
    def test_quadratic_one_newton_step(self):
        d = 10
        diag = np.linspace(1.0, 10.0, d)
        tdiag, jdiag = torch.from_numpy(diag), jnp.asarray(diag)
        target = np.ones(d)
        tt, jt = torch.from_numpy(target), jnp.asarray(target)
        res = tron.tron_solve(
            lambda w: (0.5 * torch.dot(w - tt, tdiag * (w - tt)),
                       tdiag * (w - tt)),
            lambda w, v, aux: tdiag * v,
            torch.zeros(d, dtype=torch.float64),
            tron.TRONConfig(tolerance=1e-10))
        jres = jax_tron.tron_solve(
            lambda w: (0.5 * jnp.vdot(w - jt, jdiag * (w - jt)),
                       jdiag * (w - jt)),
            lambda w, v, aux: jdiag * v,
            jnp.zeros(d, jnp.float64), jax_tron.TRONConfig(tolerance=1e-10))
        np.testing.assert_allclose(res.w.numpy(), target, atol=1e-6)
        assert res.iterations <= 15
        _assert_same_solution(res, jres, w_tol=1e-6, iters=0)
        np.testing.assert_allclose(res.values.numpy(), np.asarray(jres.values),
                                   rtol=1e-9)

    def test_logistic_matches_lbfgs_and_jax(self, rng):
        X, y, data, jdata = _dense_logistic(rng)
        l2 = 0.5
        obj = GlmObjective(losses.logistic)
        jobj = JaxObjective(jax_losses.logistic)
        res = tron.tron_solve(
            lambda w: obj.value_and_grad(w, data, l2_weight=l2),
            lambda w, v, aux: obj.hvp(w, v, data, l2_weight=l2, d2w=aux),
            torch.zeros(X.shape[1], dtype=torch.float64),
            tron.TRONConfig(tolerance=1e-9, max_iters=100),
            d2_fn=lambda w: obj.d2_weights(w, data))
        jres = jax_tron.tron_solve(
            lambda w: jobj.value_and_grad(w, jdata, l2_weight=l2),
            lambda w, v, aux: jobj.hvp(w, v, jdata, l2_weight=l2, d2w=aux),
            jnp.zeros(X.shape[1], jnp.float64),
            jax_tron.TRONConfig(tolerance=1e-9, max_iters=100),
            d2_fn=lambda w: jobj.d2_weights(w, jdata))
        free = lbfgs.lbfgs_solve(
            lambda w: obj.value_and_grad(w, data, l2_weight=l2),
            torch.zeros(X.shape[1], dtype=torch.float64),
            lbfgs.LBFGSConfig(tolerance=1e-10, max_iters=300))
        assert res.converged
        _assert_same_solution(res, jres, w_tol=1e-6)
        np.testing.assert_allclose(res.w.numpy(), free.w.numpy(), atol=1e-5)

    def test_hvp_matches_finite_difference_and_jax(self, rng):
        X, y, data, jdata = _dense_logistic(rng, n=60, d=6)
        obj = GlmObjective(losses.logistic)
        jobj = JaxObjective(jax_losses.logistic)
        w, v = rng.normal(size=6), rng.normal(size=6)
        tw, tv = torch.from_numpy(w), torch.from_numpy(v)
        eps = 1e-6
        _, g_plus = obj.value_and_grad(tw + eps * tv, data)
        _, g_minus = obj.value_and_grad(tw - eps * tv, data)
        fd = (g_plus - g_minus).numpy() / (2 * eps)
        hvp = obj.hvp(tw, tv, data, l2_weight=0.3).numpy()
        np.testing.assert_allclose(hvp - 0.3 * v, fd, rtol=1e-5, atol=1e-5)
        jhvp = np.asarray(jobj.hvp(jnp.asarray(w), jnp.asarray(v), jdata,
                                   l2_weight=0.3))
        np.testing.assert_allclose(hvp, jhvp, rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("accumulate", ["f32", "f64"])
    @pytest.mark.parametrize("task", ["logistic", "linear", "poisson",
                                      "smoothed_hinge"])
    def test_losses_match_jax(self, task, accumulate):
        res, jres = _solve_sparse(task, "l2", 1.0, seed=12,
                                  optimizer="TRON", accumulate=accumulate)
        _assert_same_solution(res, jres)
        assert _monotone(res)
        assert res.converged


# -- TestSPGBoxConstraints ---------------------------------------------------


def _bounded_oracle(X, y, l2, bounds):
    def f(w):
        m = X @ w
        val = np.sum(np.logaddexp(0, m) - y * m) + 0.5 * l2 * w @ w
        g = X.T @ (1 / (1 + np.exp(-m)) - y) + l2 * w
        return val, g

    return scipy.optimize.minimize(
        f, np.zeros(X.shape[1]), jac=True, method="L-BFGS-B", bounds=bounds,
        options={"maxiter": 500, "ftol": 1e-14, "gtol": 1e-10}).x


class TestSPGBoxConstraints:
    def _spg_both(self, vg, jvg, w0, lower, upper, **cfg):
        res = projected.spg_solve(
            vg, torch.from_numpy(w0), torch.from_numpy(lower),
            torch.from_numpy(upper), projected.SPGConfig(**cfg))
        jres = jax_projected.spg_solve(
            jvg, jnp.asarray(w0), jnp.asarray(lower), jnp.asarray(upper),
            jax_projected.SPGConfig(**cfg))
        return res, jres

    def test_matches_scipy_lbfgsb(self, rng):
        X, y, data, jdata = _dense_logistic(rng)
        obj = GlmObjective(losses.logistic)
        jobj = JaxObjective(jax_losses.logistic)
        l2, d = 0.3, X.shape[1]
        lower, upper = np.full(d, -0.25), np.full(d, 0.25)
        lower[0], upper[1] = -np.inf, np.inf
        res, jres = self._spg_both(
            lambda w: obj.value_and_grad(w, data, l2_weight=l2),
            lambda w: jobj.value_and_grad(w, jdata, l2_weight=l2),
            np.zeros(d), lower, upper, max_iters=300, tolerance=1e-10)
        oracle = _bounded_oracle(X, y, l2, list(zip(lower, upper)))
        w = res.w.numpy()
        assert res.converged or res.stalled
        np.testing.assert_allclose(w, oracle, atol=2e-5)
        assert np.all(w >= lower) and np.all(w <= upper)
        assert np.any(np.isclose(np.abs(oracle[2:]), 0.25, atol=1e-8))
        _assert_same_solution(res, jres)
        assert res.stalled == bool(jres.stalled)
        _assert_same_active_bounds(w, jres.w, lower, upper)

    def test_inactive_bounds_match_unconstrained(self, rng):
        X, y, data, _ = _dense_logistic(rng)
        obj = GlmObjective(losses.logistic)
        d = X.shape[1]
        vg = lambda w: obj.value_and_grad(w, data, l2_weight=0.5)  # noqa: E731
        free = lbfgs.lbfgs_solve(vg, torch.zeros(d, dtype=torch.float64),
                                 lbfgs.LBFGSConfig(max_iters=300,
                                                   tolerance=1e-10))
        boxed = projected.spg_solve(
            vg, torch.zeros(d, dtype=torch.float64),
            torch.full((d,), -np.inf, dtype=torch.float64),
            torch.full((d,), np.inf, dtype=torch.float64),
            projected.SPGConfig(max_iters=300, tolerance=1e-10))
        np.testing.assert_allclose(boxed.w.numpy(), free.w.numpy(), atol=1e-6)

    def test_problem_routes_bounds_and_rejects_l1(self, rng):
        X, y, data, jdata = _dense_logistic(rng)
        d = X.shape[1]
        lower, upper = np.full(d, -0.2), np.full(d, 0.2)
        prob = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
            optimizer=OptimizerConfig(max_iters=300, tolerance=1e-10),
            regularization=RegularizationContext.l2()))
        jprob = jax_problem.GlmOptimizationProblem(
            "logistic", jax_problem.GlmOptimizationConfig(
                optimizer=jax_problem.OptimizerConfig(max_iters=300,
                                                      tolerance=1e-10),
                regularization=JaxReg.l2()))
        w0 = torch.zeros(d, dtype=torch.float64)
        res = prob.solve(data, 0.3, w0=w0, bounds=(torch.from_numpy(lower),
                                                   torch.from_numpy(upper)))
        jres = jprob.solve(jdata, 0.3, w0=jnp.zeros(d, jnp.float64),
                           bounds=(jnp.asarray(lower), jnp.asarray(upper)))
        oracle = _bounded_oracle(X, y, 0.3, [(-0.2, 0.2)] * d)
        np.testing.assert_allclose(res.w.numpy(), oracle, atol=2e-5)
        _assert_same_solution(res, jres)
        _assert_same_active_bounds(res.w.numpy(), jres.w, lower, upper)

        l1_prob = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
            regularization=RegularizationContext.l1()))
        with pytest.raises(NotImplementedError, match="box constraints"):
            l1_prob.solve(data, 0.1, bounds=(torch.from_numpy(lower),
                                             torch.from_numpy(upper)))

    def test_ftol_plateau_reports_stalled_not_converged(self):
        # A linear term riding a huge constant: the accepted step's decrease
        # is absorbed by f ≈ 1e8 in f32, so the objective plateaus while
        # the projected-gradient norm stays far above the tolerance.
        g = np.full(4, 1e-4, np.float32)
        tg, jg = torch.from_numpy(g), jnp.asarray(g)
        lo, hi = np.full(4, -1e6, np.float32), np.full(4, 1e6, np.float32)
        res, jres = self._spg_both(
            lambda w: (1e8 + torch.dot(tg, w), tg),
            lambda w: (1e8 + jnp.vdot(jg, w), jg),
            np.ones(4, np.float32), lo, hi, max_iters=50, tolerance=1e-8)
        assert not res.converged and res.stalled
        assert not bool(jres.converged) and bool(jres.stalled)
        assert res.iterations == int(jres.iterations)

    def test_converged_solve_is_not_stalled(self):
        lo, hi = np.full(4, -5.0, np.float32), np.full(4, 5.0, np.float32)
        res, jres = self._spg_both(
            lambda w: (0.5 * torch.dot(w, w), w),
            lambda w: (0.5 * jnp.vdot(w, w), w),
            np.ones(4, np.float32), lo, hi, max_iters=50, tolerance=1e-6)
        assert res.converged and not res.stalled
        assert res.iterations == int(jres.iterations)

    def test_bounds_with_variances_rejected(self, rng):
        X, y, data, _ = _dense_logistic(rng)
        d = X.shape[1]
        bounds = (torch.full((d,), -0.2), torch.full((d,), 0.2))
        prob = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
            regularization=RegularizationContext.l2(),
            compute_variances=True))
        with pytest.raises(ValueError, match="compute_variances"):
            prob.solve(data, 0.3, bounds=bounds)
        with pytest.raises(ValueError, match="compute_variances"):
            prob.run_grid(data, [0.3], bounds=bounds)

    @pytest.mark.parametrize("accumulate", ["f32", "f64"])
    @pytest.mark.parametrize("task", ["logistic", "linear", "poisson"])
    def test_losses_match_jax(self, task, accumulate):
        """Box of ±0.15 on every coefficient.  The reference's SPG cannot
        run with a float64 value (its while_loop carry mixes the f32
        gradient's dtype with the f64 value, a TypeError in JAX); the port
        carries the value in the gradient's dtype, so its f64 solve is held
        against the reference's f32 one."""
        d = _sparse_task(task, 13)[0].shape[1]
        lower = np.full(d, -0.15, np.float32)
        upper = np.full(d, 0.15, np.float32)
        res, jres = _solve_sparse(task, "l2", 1.0, seed=13,
                                  bounds=(lower, upper), accumulate=accumulate,
                                  ref_accumulate="f32", tolerance=1e-4)
        w = res.w.numpy()
        assert np.all(w >= lower) and np.all(w <= upper)
        assert res.converged or res.stalled
        _assert_same_solution(res, jres)
        assert res.stalled == bool(jres.stalled)
        _assert_same_active_bounds(w, jres.w, lower, upper)
        assert _monotone(res)
        assert np.any((w == lower) | (w == upper))  # the box binds


# -- NaN / overflow trials: the same branch as the reference -----------------


@pytest.mark.parametrize("solver", ["spg", "owlqn", "tron", "lbfgs"])
def test_nan_trial_takes_the_reference_branch(rng, solver):
    """The reference's ``test_nan_trial_backtracks_poisson``, in float32 so
    that trials really overflow: positive features ×30 from w0 = −1, where
    the first steps reach margins whose ``exp`` is inf (an inf value and a
    NaN gradient).  Each solver must reject those trials exactly as the
    reference's ``jnp.where`` logic does — the same iterations, convergence
    and value, and a finite answer."""
    X = (np.abs(rng.normal(size=(100, 5))) * 30.0).astype(np.float32)
    y = rng.poisson(1.0, size=100).astype(np.float32)
    obj, data = GlmObjective(losses.poisson), make_glm_data(X, y, device="cpu")
    jobj, jdata = JaxObjective(jax_losses.poisson), jax_make_glm_data(X, y)
    nonfinite = []

    def vg(w):
        v, g = obj.value_and_grad(w, data, l2_weight=1.0)
        nonfinite.append(not (torch.isfinite(v) and torch.isfinite(g).all()))
        return v, g

    def jvg(w):
        return jobj.value_and_grad(w, jdata, l2_weight=1.0)

    w0, jw0 = torch.full((5,), -1.0), jnp.full(5, -1.0, jnp.float32)
    cfg = dict(max_iters=200, tolerance=1e-3)
    if solver == "spg":
        lo, hi = np.full(5, -2.0, np.float32), np.full(5, 2.0, np.float32)
        res = projected.spg_solve(vg, w0, torch.from_numpy(lo),
                                  torch.from_numpy(hi),
                                  projected.SPGConfig(**cfg))
        jres = jax_projected.spg_solve(jvg, jw0, jnp.asarray(lo),
                                       jnp.asarray(hi),
                                       jax_projected.SPGConfig(**cfg))
        assert res.stalled == bool(jres.stalled)
    elif solver == "owlqn":
        res = owlqn.owlqn_solve(vg, w0, 0.5, owlqn.OWLQNConfig(**cfg))
        jres = jax_owlqn.owlqn_solve(jvg, jw0, 0.5,
                                     jax_owlqn.OWLQNConfig(**cfg))
    elif solver == "tron":
        res = tron.tron_solve(
            vg, lambda w, v, aux: obj.hvp(w, v, data, l2_weight=1.0, d2w=aux),
            w0, tron.TRONConfig(**cfg),
            d2_fn=lambda w: obj.d2_weights(w, data))
        jres = jax_tron.tron_solve(
            jvg,
            lambda w, v, aux: jobj.hvp(w, v, jdata, l2_weight=1.0, d2w=aux),
            jw0, jax_tron.TRONConfig(**cfg),
            d2_fn=lambda w: jobj.d2_weights(w, jdata))
    else:
        res = lbfgs.lbfgs_solve(vg, w0, lbfgs.LBFGSConfig(**cfg))
        jres = jax_lbfgs.lbfgs_solve(jvg, jw0, jax_lbfgs.LBFGSConfig(**cfg))
    assert any(nonfinite)  # the branch under test was taken
    assert np.isfinite(res.w.numpy()).all() and np.isfinite(float(res.value))
    assert np.isfinite(np.asarray(jres.w)).all()
    assert abs(res.iterations - int(jres.iterations)) <= 3
    assert res.converged == bool(jres.converged)
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-6)


# -- TestProblemDispatch -----------------------------------------------------


class TestProblemDispatch:
    @pytest.mark.parametrize("opt_type", ["LBFGS", "TRON", "OWLQN"])
    def test_l1_routes_to_owlqn_regardless_of_optimizer(self, rng, opt_type):
        X, y, data, jdata = _dense_logistic(rng, n=200, d=15)
        port, ref = _problems("logistic", "l1", optimizer=opt_type,
                              tolerance=1e-7)
        res = port.solve(data, 15.0, w0=torch.zeros(15, dtype=torch.float64))
        jres = ref.solve(jdata, 15.0, w0=jnp.zeros(15, jnp.float64))
        w = res.w.numpy()
        assert np.sum(w == 0.0) > 0, f"{opt_type}: L1 was dropped"
        _assert_same_solution(res, jres)
        _assert_same_support(w, jres.w)

    @pytest.mark.parametrize("optimizer,reg", [("TRON", "l2"),
                                               ("LBFGS", "l2"),
                                               ("OWLQN", "l2")])
    def test_smooth_routes_to_the_configured_optimizer(self, optimizer, reg):
        res, jres = _solve_sparse("logistic", reg, 1.0, seed=14,
                                  optimizer=optimizer)
        _assert_same_solution(res, jres)


# -- TestRegistry ------------------------------------------------------------


class TestRegistry:
    def test_builtins_registered(self):
        assert set(registry.names()) >= {"lbfgs", "owlqn", "tron", "spg",
                                         "admm", "block_cd"}

    def test_duplicate_refused_replace_allowed(self):
        defn = registry.SolverDef(
            name="scratch_test_solver", kind="jit",
            description="test double", resident=lambda ctx: None,
        )
        registry.register(defn, replace=True)
        with pytest.raises(ValueError, match="already registered"):
            registry.register(defn)
        registry.register(defn, replace=True)
        assert registry.get("scratch_test_solver") is defn

    def test_def_validation(self):
        # A jit-kind definition needs its resident callable and a host-kind
        # one its sharded factory, as in the reference; every built-in has
        # the one of its kind.
        with pytest.raises(ValueError, match="kind"):
            registry.SolverDef(name="x", kind="weird", description="")
        with pytest.raises(ValueError, match="resident"):
            registry.SolverDef(name="x", kind="jit", description="")
        with pytest.raises(ValueError, match="sharded"):
            registry.SolverDef(name="x", kind="host", description="")
        for name in ("lbfgs", "owlqn", "tron", "spg"):
            assert callable(registry.get(name).resident)
        for name in ("admm", "block_cd"):
            assert callable(registry.get(name).sharded)

    def test_unknown_name(self):
        with pytest.raises(KeyError, match="unknown solver"):
            registry.get("levenberg")

    @pytest.mark.parametrize("name", ["admm", "block_cd"])
    def test_host_kind_solvers_registered(self, name):
        """The reference's host-kind solvers resolve by name, with the
        reference's kind, L1 support and box-constraint refusal."""
        from photon_ml_tpu.optim.problem import OptimizerConfig as JOpt
        from photon_ml_tpu.solvers import registry as jax_registry

        defn, jdefn = registry.get(name), jax_registry.get(name)
        assert (defn.kind, defn.supports_l1, defn.supports_bounds) == (
            jdefn.kind, jdefn.supports_l1, jdefn.supports_bounds) == (
            "host", True, False)
        assert registry.resolve(OptimizerConfig(solver=name),
                                l1_frac=0.5) is defn
        with pytest.raises(ValueError, match="box constraints"):
            registry.resolve(OptimizerConfig(solver=name), l1_frac=0.0,
                             has_bounds=True)
        opt = OptimizerConfig(solver=name,
                              solver_options=(("shards", "4"),))
        assert registry.solver_options_dict(opt) == (
            jax_registry.solver_options_dict(JOpt(
                solver=name, solver_options=(("shards", "4"),))))

    def test_legacy_routing(self):
        from photon_ml_tpu.solvers import registry as jax_registry

        for opt_type in OptimizerType:
            opt = OptimizerConfig(optimizer=opt_type)
            jopt = jax_problem.OptimizerConfig(
                optimizer=jax_problem.OptimizerType(opt_type.value))
            for l1_frac, bounds in ((0.0, False), (0.5, False),
                                    (0.0, True)):
                assert (registry.resolve(opt, l1_frac=l1_frac,
                                         has_bounds=bounds).name
                        == jax_registry.resolve(jopt, l1_frac=l1_frac,
                                                has_bounds=bounds).name)
        opt = OptimizerConfig(optimizer=OptimizerType.TRON)
        assert registry.resolve(opt, l1_frac=0.0).name == "tron"
        assert registry.resolve(opt, l1_frac=0.5).name == "owlqn"
        assert registry.resolve(opt, l1_frac=0.0, has_bounds=True).name == "spg"

    def test_explicit_name_guards(self):
        from photon_ml_tpu.solvers import registry as jax_registry

        cases = [("lbfgs", 0.5, False), ("lbfgs", 0.0, True),
                 ("spg", 0.0, False), ("tron", 0.5, False),
                 ("owlqn", 0.0, True)]
        for name, l1_frac, bounds in cases:
            with pytest.raises(ValueError) as ours:
                registry.resolve(OptimizerConfig(solver=name),
                                 l1_frac=l1_frac, has_bounds=bounds)
            with pytest.raises(ValueError) as ref:
                jax_registry.resolve(jax_problem.OptimizerConfig(solver=name),
                                     l1_frac=l1_frac, has_bounds=bounds)
            assert str(ours.value) == str(ref.value)
        assert registry.resolve(OptimizerConfig(solver="owlqn"),
                                l1_frac=0.5).name == "owlqn"
        assert registry.resolve(OptimizerConfig(solver="spg"), l1_frac=0.0,
                                has_bounds=True).name == "spg"


# -- TestDispatchParity (resident) -------------------------------------------


def _bitwise(a, b):
    return torch.equal(a, b) and a.dtype == b.dtype


class TestDispatchParity:
    """An explicit solver name is bitwise the implicit routing inside the
    port, and both match the reference's explicit solve."""

    @pytest.mark.parametrize("name,optimizer,reg", [
        ("lbfgs", "LBFGS", "l2"),
        ("tron", "TRON", "l2"),
        ("owlqn", "LBFGS", "elastic"),
    ])
    def test_resident_bitwise(self, name, optimizer, reg):
        X, y = _sparse_task("logistic", 15, n=240, d=10, density=0.5)
        data = make_glm_data(X, y, use_kernel=True, device="cpu")
        implicit, _ = _problems("logistic", reg, optimizer=optimizer,
                                tolerance=1e-8, max_iters=150)
        explicit, _ = _problems("logistic", reg, optimizer=optimizer,
                                solver=name, tolerance=1e-8, max_iters=150)
        res_i = implicit.solve_single_device(data, 0.3)
        res_e = explicit.solve_single_device(data, 0.3)
        assert _bitwise(res_i.w, res_e.w)
        assert res_i.iterations == res_e.iterations
        # A repeat of the same solve is bitwise too (no atomics, no
        # data-dependent reduction order).
        assert _bitwise(explicit.solve_single_device(data, 0.3).w, res_e.w)
        # And the explicit solver matches the reference's explicit one
        # (above the float32 noise floor).
        port, ref = _problems("logistic", reg, optimizer=optimizer,
                              solver=name)
        _assert_same_solution(port.solve_single_device(data, 0.3),
                              ref.solve_single_device(
                                  jax_make_glm_data(X, y), 0.3))

    def test_explicit_spg_is_the_bounds_routing(self):
        X, y = _sparse_task("logistic", 15, n=240, d=10, density=0.5)
        data = make_glm_data(X, y, use_kernel=True, device="cpu")
        bounds = (torch.full((10,), -0.1), torch.full((10,), 0.1))
        implicit, _ = _problems("logistic", "l2")
        explicit, _ = _problems("logistic", "l2", solver="spg")
        a = implicit.solve_single_device(data, 0.3, bounds=bounds)
        b = explicit.solve_single_device(data, 0.3, bounds=bounds)
        assert _bitwise(a.w, b.w) and a.stalled == b.stalled
