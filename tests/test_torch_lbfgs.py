"""The port's L-BFGS (a host loop over tensors) against the JAX package's
(one ``lax.while_loop``) on the same L2-logistic problems.

Tolerances: coefficients within 1e-4 of their largest component, the
objective within 1e-6 relative, iteration counts within ±3 (the two
packages sum in different orders, so late line-search decisions may
differ), and the same ``converged`` flag.  The float32 solves use a
relative tolerance of 1e-5, which the gradient test reaches in float32;
at 1e-7 both packages end on the float32 noise floor, where which exit
fires first is decided by rounding.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

os.environ.setdefault("PHOTON_PALLAS_INTERPRET", "1")

from photon_ml_tpu.data.dataset import make_glm_data as jax_make_glm_data
from photon_ml_tpu.optim import lbfgs as jax_lbfgs
from photon_ml_tpu.optim import problem as jax_problem
from photon_ml_tpu.optim.regularization import (
    RegularizationContext as JaxReg,
)

from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.optim import lbfgs
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    GlmOptimizationProblem,
    OptimizerConfig,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _logistic_problem(seed, n=2000, d=100, density=0.08):
    rng = np.random.default_rng(seed)
    X = sp.random(n, d - 1, density=density,
                  random_state=np.random.RandomState(seed), format="csr",
                  dtype=np.float32)
    X.data = rng.normal(size=X.nnz).astype(np.float32)
    X = sp.hstack([X, np.ones((n, 1), np.float32)], format="csr")
    w_true = rng.normal(size=d).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ w_true)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y


def _configs(max_iters, compute_variances=False, tolerance=1e-4):
    port = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=max_iters, tolerance=tolerance),
        regularization=RegularizationContext.l2(),
        compute_variances=compute_variances,
    )
    ref = jax_problem.GlmOptimizationConfig(
        optimizer=jax_problem.OptimizerConfig(max_iters=max_iters,
                                              tolerance=tolerance),
        regularization=JaxReg.l2(),
        compute_variances=compute_variances,
    )
    return port, ref


def _assert_same_solution(res, jres, w_tol=1e-4):
    w, jw = res.w.numpy(), np.asarray(jres.w)
    assert np.abs(w - jw).max() <= w_tol * np.abs(jw).max()
    np.testing.assert_allclose(float(res.value), float(jres.value), rtol=1e-6)
    assert abs(res.iterations - int(jres.iterations)) <= 3
    assert res.converged == bool(jres.converged)


@pytest.mark.parametrize("accumulate", ["f32", "f64"])
@pytest.mark.parametrize("lam", [0.1, 1.0, 10.0])
def test_solve_matches_jax(lam, accumulate):
    X, y = _logistic_problem(6)
    port_cfg, ref_cfg = _configs(max_iters=200)
    res = GlmOptimizationProblem("logistic", port_cfg,
                                 accumulate=accumulate).solve(
        make_glm_data(X, y, use_kernel=True, device="cpu"), lam)
    jres = jax_problem.GlmOptimizationProblem(
        "logistic", ref_cfg, accumulate=accumulate).solve_single_device(
        jax_make_glm_data(X, y, use_pallas=True), lam)
    _assert_same_solution(res, jres)
    assert res.converged
    vals = res.values.numpy()
    assert vals.shape == (201,) and np.isnan(vals[res.iterations + 1:]).all()
    assert np.all(np.diff(vals[: res.iterations + 1]) <= 0)  # monotone


def test_run_grid_matches_jax_with_variances():
    X, y = _logistic_problem(2, n=1200, d=60)
    port_cfg, ref_cfg = _configs(max_iters=150, compute_variances=True)
    grid = [10.0, 1.0, 0.1]
    ours = GlmOptimizationProblem("logistic", port_cfg).run_grid(
        make_glm_data(X, y, device="cpu"), grid)
    ref = jax_problem.GlmOptimizationProblem("logistic", ref_cfg).run_grid(
        jax_make_glm_data(X, y), grid)
    assert [lam for lam, _, _ in ours] == [lam for lam, _, _ in ref] == grid
    for (_, model, res), (_, jmodel, jres) in zip(ours, ref):
        _assert_same_solution(res, jres)
        var = model.coefficients.variances.numpy()
        jvar = np.asarray(jmodel.coefficients.variances)
        np.testing.assert_allclose(var, jvar, rtol=1e-4)
        assert model.task == jmodel.task == "logistic"


def test_max_iters_cap_and_fields():
    X, y = _logistic_problem(3, n=800, d=50)
    port_cfg, ref_cfg = _configs(max_iters=3, tolerance=1e-12)
    res = GlmOptimizationProblem("logistic", port_cfg).solve(
        make_glm_data(X, y, device="cpu"), 0.01)
    jres = jax_problem.GlmOptimizationProblem(
        "logistic", ref_cfg).solve_single_device(jax_make_glm_data(X, y), 0.01)
    assert res.iterations == int(jres.iterations) == 3
    assert not res.converged and not bool(jres.converged)
    assert res._fields == jax_lbfgs.SolveResult._fields
    np.testing.assert_allclose(res.values.numpy(), np.asarray(jres.values),
                               rtol=1e-5)
    np.testing.assert_allclose(res.grad_norms.numpy(),
                               np.asarray(jres.grad_norms), rtol=1e-4)


def test_lbfgs_on_quadratic_matches_jax():
    """The bare solver on a dense quadratic in float64 (condition ~100)."""
    rng = np.random.default_rng(4)
    d = 40
    Q = rng.normal(size=(d, d))
    A = Q @ Q.T / d + np.diag(np.logspace(-1, 1, d))
    b = rng.normal(size=d)
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    jA, jb = jnp.asarray(A), jnp.asarray(b)
    cfg = lbfgs.LBFGSConfig(max_iters=300, tolerance=1e-8)
    res = lbfgs.lbfgs_solve(
        lambda w: (0.5 * w @ tA @ w - tb @ w, tA @ w - tb),
        torch.zeros(d, dtype=torch.float64), cfg)
    jres = jax_lbfgs.lbfgs_solve(
        lambda w: (0.5 * w @ jA @ w - jb @ w, jA @ w - jb),
        jnp.zeros(d, jnp.float64),
        jax_lbfgs.LBFGSConfig(max_iters=300, tolerance=1e-8))
    _assert_same_solution(res, jres, w_tol=1e-6)
    assert res.converged


@pytest.mark.parametrize("route", ["admm", "block_cd"])
def test_routes_outside_the_slice_raise(route):
    """The host-kind solvers run a host outer loop over sharded data
    (``solvers/sharded.py``): a single ``problem.solve`` refuses them with
    the reference's message, as the reference's does."""
    from photon_ml_tpu.data.dataset import make_glm_data as jax_make
    from photon_ml_tpu.optim import problem as jp
    from photon_ml_tpu.optim.regularization import (
        RegularizationContext as JReg,
    )

    X, y = _logistic_problem(5, n=100, d=10)
    data = make_glm_data(X, y, device="cpu")
    problem = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
        optimizer=OptimizerConfig(solver=route),
        regularization=RegularizationContext.elastic_net(0.5)))
    with pytest.raises(ValueError, match="host-side outer loop"):
        problem.solve(data, 1.0)
    ref = jp.GlmOptimizationProblem("logistic", jp.GlmOptimizationConfig(
        optimizer=jp.OptimizerConfig(solver=route),
        regularization=JReg.elastic_net(0.5)))
    with pytest.raises(ValueError, match="host-side outer loop"):
        ref.solve(jax_make(X, y), 1.0)
