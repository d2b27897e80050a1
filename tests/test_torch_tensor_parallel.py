"""The port's tensor-parallel GLM (``parallel/tensor.py``) against the JAX
package's, on the CPU.

- Logical (data × feature) tiles against the reference's ``tp_*_solve`` on
  the 8-device CPU mesh of ``conftest.py``, for every case of the
  reference's ``tests/test_tensor_parallel.py``: mesh shapes 1×8 to 8×1,
  the dense path, weights and offsets, L1 and elastic net with a mask, and
  TRON — the same stationary point within 1e-5 relative objective (the
  reference's own 1e-4 where it holds its L1 fits to that), padded columns
  exactly zero, and iteration counts within a few of each other.
- ``dp = tp = 1`` is bitwise the port's resident solve.
- Without a w-space hook the solvers are unchanged: a hook that sums one
  slice is still bitwise the plain route for L-BFGS.
- A spawned gloo group of 4 ranks (2 × 2) is bitwise the port's 2 × 2
  logical tiles for L-BFGS, OWL-QN and TRON, and its row-sharded GAME
  fixed effect's variances match one process and the reference's
  (``TestMeshVariancesFixedEffect``).
"""

import multiprocessing
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data.dataset import make_glm_data as j_make_glm_data
from photon_ml_tpu.optim.lbfgs import LBFGSConfig as JLBFGSConfig
from photon_ml_tpu.optim.owlqn import OWLQNConfig as JOWLQNConfig
from photon_ml_tpu.optim.tron import TRONConfig as JTRONConfig
from photon_ml_tpu.parallel import tensor as jtensor
from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve
from photon_ml_tpu_torch.optim.owlqn import OWLQNConfig
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    GlmOptimizationProblem,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from photon_ml_tpu_torch.optim.tron import TRONConfig
from photon_ml_tpu_torch.parallel import tensor

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_workers as workers  # noqa: E402
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

JOIN_TIMEOUT = 90


def _wide_problem(rng, n=600, d=500, density=0.05, task="logistic"):
    """The reference test's data (``_wide_problem``)."""
    X = sp.random(n, d, density=density, random_state=7, format="csr",
                  dtype=np.float32)
    w_true = (rng.normal(size=d) * (rng.uniform(size=d) < 0.2)).astype(
        np.float32)
    margin = np.asarray(X @ w_true).ravel()
    if task == "logistic":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(
            np.float32)
    else:
        y = (margin + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _reference(kind, X, y, dp, tp, task="logistic", weights=None,
               offsets=None, **kw):
    mesh = jtensor.dp_tp_mesh(dp, tp)
    feats, lab, wts, off, d = jtensor.shard_glm_data_dp_tp(
        X, y, mesh, weights=weights, offsets=offsets)
    solve = {"lbfgs": jtensor.tp_lbfgs_solve, "owlqn": jtensor.tp_owlqn_solve,
             "tron": jtensor.tp_tron_solve}[kind]
    return solve(task, feats, lab, wts, off, mesh, **kw), d


def _port(kind, X, y, dp, tp, task="logistic", weights=None, offsets=None,
          **kw):
    mesh = tensor.dp_tp_mesh(dp, tp)
    data = tensor.shard_glm_data_dp_tp(X, y, mesh, weights=weights,
                                       offsets=offsets, device="cpu")
    solve = {"lbfgs": tensor.tp_lbfgs_solve, "owlqn": tensor.tp_owlqn_solve,
             "tron": tensor.tp_tron_solve}[kind]
    return solve(task, data, mesh, **kw), data


def _assert_same_point(res, ref, d, rel, atol):
    w, w_ref = res.w.numpy(), np.asarray(ref.w)
    np.testing.assert_array_equal(w[d:], 0.0)
    assert w.shape == w_ref.shape
    assert float(res.value) == pytest.approx(float(ref.value), rel=rel)
    np.testing.assert_allclose(w[:d], w_ref[:d], atol=atol)
    # The same iteration, so the same number of steps give or take the
    # last few decided on the float32 noise floor.
    it, it_ref = int(res.iterations), int(ref.iterations)
    assert abs(it - it_ref) <= max(3, it_ref // 4), (it, it_ref)


class TestTensorParallel:
    @pytest.mark.parametrize("dp,tp", [(2, 4), (4, 2), (1, 8), (8, 1)])
    def test_sparse_parity_all_mesh_shapes(self, rng, dp, tp):
        X, y = _wide_problem(rng)
        ref, d = _reference("lbfgs", X, y, dp, tp, reg_weight=0.7,
                            config=JLBFGSConfig(max_iters=80))
        res, data = _port("lbfgs", X, y, dp, tp, reg_weight=0.7,
                          config=LBFGSConfig(max_iters=80))
        assert data.d == d and data.padded_width == res.w.shape[0]
        _assert_same_point(res, ref, d, rel=1e-5, atol=2e-3)

    def test_dense_path(self, rng):
        X, y = _wide_problem(rng, n=300, d=200, task="squared")
        Xd = np.asarray(X.todense(), np.float32)
        ref, d = _reference("lbfgs", Xd, y, 2, 4, task="squared",
                            reg_weight=1.3, config=JLBFGSConfig(max_iters=80))
        res, data = _port("lbfgs", Xd, y, 2, 4, task="squared",
                          reg_weight=1.3, config=LBFGSConfig(max_iters=80))
        _assert_same_point(res, ref, d, rel=1e-5, atol=2e-3)

    def test_weights_and_offsets(self, rng):
        X, y = _wide_problem(rng, n=400, d=300)
        weights = rng.uniform(0.5, 2.0, size=400).astype(np.float32)
        offsets = rng.normal(size=400).astype(np.float32) * 0.3
        ref, d = _reference("lbfgs", X, y, 2, 4, weights=weights,
                            offsets=offsets, reg_weight=0.5,
                            config=JLBFGSConfig(max_iters=60))
        res, _ = _port("lbfgs", X, y, 2, 4, weights=weights,
                       offsets=offsets, reg_weight=0.5,
                       config=LBFGSConfig(max_iters=60))
        _assert_same_point(res, ref, d, rel=1e-5, atol=2e-3)

    def test_reg_weight_sweep_shrinks(self, rng):
        """One tiling serves a λ sweep; stronger λ, smaller w."""
        X, y = _wide_problem(rng, n=200, d=150)
        mesh = tensor.dp_tp_mesh(2, 4)
        data = tensor.shard_glm_data_dp_tp(X, y, mesh, device="cpu")
        r1 = tensor.tp_lbfgs_solve("logistic", data, mesh, 0.1,
                                   config=LBFGSConfig(max_iters=30))
        r2 = tensor.tp_lbfgs_solve("logistic", data, mesh, 10.0,
                                   config=LBFGSConfig(max_iters=30))
        assert torch.linalg.vector_norm(r2.w) < torch.linalg.vector_norm(r1.w)


class TestTensorParallelOwlqn:
    def test_l1_parity_and_sparsity(self, rng):
        # d NOT a multiple of tp: the padded columns are a non-empty slice.
        X, y = _wide_problem(rng, n=500, d=397)
        ref, d = _reference("owlqn", X, y, 2, 4, l1_weight=2.0,
                            config=JOWLQNConfig(max_iters=80))
        res, _ = _port("owlqn", X, y, 2, 4, l1_weight=2.0,
                       config=OWLQNConfig(max_iters=80))
        w, w_ref = res.w.numpy()[:d], np.asarray(ref.w)[:d]
        assert np.sum(w_ref == 0) > 100  # the L1 fit is genuinely sparse
        _assert_same_point(res, ref, d, rel=1e-5, atol=3e-3)
        assert np.sum((w == 0) != (w_ref == 0)) <= max(2, int(0.01 * d))

    def test_elastic_net_with_mask(self, rng):
        X, y = _wide_problem(rng, n=300, d=200)
        lam, alpha = 1.5, 0.5
        mesh_width = 200  # 4 x 2 grid: 200 columns pad to 200
        mask = np.ones(mesh_width, np.float32)
        mask[0] = 0.0
        ref, d = _reference("owlqn", X, y, 4, 2, l1_weight=alpha * lam,
                            l2_weight=(1 - alpha) * lam,
                            config=JOWLQNConfig(max_iters=60),
                            l1_mask=jnp.asarray(mask))
        res, _ = _port("owlqn", X, y, 4, 2, l1_weight=alpha * lam,
                       l2_weight=(1 - alpha) * lam,
                       config=OWLQNConfig(max_iters=60), l1_mask=mask)
        _assert_same_point(res, ref, d, rel=1e-5, atol=3e-3)

    @pytest.mark.parametrize("reg", ["l1", "l2", "elastic_net"])
    def test_padded_columns_stay_zero(self, rng, reg):
        """Columns past d see no data and no pull from any penalty."""
        X, y = _wide_problem(rng, n=200, d=101)
        l1, l2 = {"l1": (1.0, 0.0), "l2": (0.0, 1.0),
                  "elastic_net": (0.5, 0.5)}[reg]
        res, data = _port("owlqn", X, y, 2, 4, l1_weight=l1, l2_weight=l2,
                          config=OWLQNConfig(max_iters=40))
        assert data.padded_width == 104
        np.testing.assert_array_equal(res.w.numpy()[101:], 0.0)
        assert np.any(res.w.numpy()[:101] != 0.0)


class TestTensorParallelTron:
    def test_tron_parity(self, rng):
        X, y = _wide_problem(rng, n=500, d=350)
        ref, d = _reference("tron", X, y, 2, 4, reg_weight=0.8,
                            config=JTRONConfig(max_iters=50))
        res, _ = _port("tron", X, y, 2, 4, reg_weight=0.8,
                       config=TRONConfig(max_iters=50))
        _assert_same_point(res, ref, d, rel=1e-5, atol=2e-3)


def _resident(kind, X, y, lam, max_iters):
    reg = (RegularizationContext.elastic_net(0.5) if kind == "owlqn"
           else RegularizationContext.l2())
    opt = OptimizerConfig(
        optimizer=OptimizerType.TRON if kind == "tron" else
        OptimizerType.LBFGS, max_iters=max_iters)
    prob = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
        optimizer=opt, regularization=reg))
    return prob.solve(make_glm_data(X, y, device="cpu"), lam)


@pytest.mark.parametrize("kind", ["lbfgs", "owlqn", "tron"])
def test_one_tile_is_bitwise_the_resident_solve(rng, kind):
    X, y = _wide_problem(rng, n=300, d=120)
    lam = 0.9
    ref = _resident(kind, X, y, lam, 40)
    mesh = tensor.dp_tp_mesh(1, 1)
    data = tensor.shard_glm_data_dp_tp(X, y, mesh, device="cpu")
    if kind == "owlqn":
        # The split the problem makes: float32 fractions times float32 λ.
        l1 = float(np.float32(0.5) * np.float32(lam))
        res = tensor.tp_owlqn_solve("logistic", data, mesh, l1, l1,
                                    config=OWLQNConfig(max_iters=40))
    elif kind == "tron":
        res = tensor.tp_tron_solve("logistic", data, mesh, lam,
                                   config=TRONConfig(max_iters=40))
    else:
        res = tensor.tp_lbfgs_solve("logistic", data, mesh, lam,
                                    config=LBFGSConfig(max_iters=40))
    assert torch.equal(res.w, ref.w)
    assert torch.equal(res.value, ref.value)
    assert res.iterations == ref.iterations


def test_one_slice_hook_keeps_the_lbfgs_bits(rng):
    """A w-space hook that sums a single slice's partial is the plain
    dot (the solvers' default, ``ops/ordered.py``'s); with ``norm`` the
    plain norm, the trajectory is unchanged bit for bit."""
    X, y = _wide_problem(rng, n=300, d=80)
    data = make_glm_data(X, y, device="cpu")
    prob = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=30),
        regularization=RegularizationContext.l2()))

    class OneSlice:
        dot = staticmethod(ordered.dot)
        norm = staticmethod(torch.linalg.vector_norm)

    def vg(w):
        return prob.objective.value_and_grad(w, data, 0.5)

    w0 = torch.zeros(80)
    plain = lbfgs_solve(vg, w0, LBFGSConfig(max_iters=30))
    hooked = lbfgs_solve(vg, w0, LBFGSConfig(max_iters=30),
                         w_space=OneSlice())
    assert torch.equal(plain.w, hooked.w)
    assert plain.iterations == hooked.iterations


def test_grid_refuses_a_mismatch():
    X, y = _wide_problem(np.random.default_rng(0), n=40, d=12)
    data = tensor.shard_glm_data_dp_tp(X, y, tensor.dp_tp_mesh(2, 2),
                                       device="cpu")
    with pytest.raises(ValueError, match="grid"):
        tensor.tp_lbfgs_solve("logistic", data, tensor.dp_tp_mesh(1, 4))
    with pytest.raises(ValueError, match="padded width"):
        tensor.tp_lbfgs_solve("logistic", data, tensor.dp_tp_mesh(2, 2),
                              w0=torch.zeros(13))
    with pytest.raises(ValueError, match=">= 1"):
        tensor.dp_tp_mesh(0, 2)


# -- a spawned 2 x 2 gloo group ------------------------------------------------


@pytest.fixture(scope="module")
def group_2x2(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp2x2")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.tp_rank_main,
                         args=(r, 4, str(root / "rendezvous"), str(root),
                               2, 2))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * 4, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("kind", ["lbfgs", "owlqn", "tron"])
def test_group_is_bitwise_its_logical_tiles(group_2x2, kind):
    logical = workers.tp_cases(tensor.dp_tp_mesh(2, 2))
    for r, saved in enumerate(group_2x2):
        for key in ("w", "value", "iterations"):
            np.testing.assert_array_equal(
                saved[f"{kind}/{key}"], logical[f"{kind}/{key}"],
                err_msg=f"rank {r} {kind}/{key}")
    # Every rank made the same reductions (a sum each inner product).
    assert len({int(s["gathers"]) for s in group_2x2}) == 1


def test_group_fixed_effect_variances(group_2x2):
    from photon_ml_tpu.game.estimator import (
        FixedEffectCoordinateConfig as JFixed,
        GameEstimator as JGameEstimator,
    )
    from photon_ml_tpu.optim import problem as jp
    from photon_ml_tpu.optim.regularization import RegularizationContext as JR

    single = workers.variance_case(None)
    for saved in group_2x2:
        np.testing.assert_allclose(saved["variances"], single, rtol=1e-3)
    rng = np.random.default_rng(20260729)
    n = 320
    Xg = rng.normal(size=(n, 5)).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-Xg[:, 0]))).astype(
        np.float32)
    opt = jp.GlmOptimizationConfig(
        optimizer=jp.OptimizerConfig(max_iters=40),
        regularization=JR.l2(), compute_variances=True)
    model, _ = JGameEstimator(
        "logistic", {"fixed": JFixed("global", opt, 0.6)}, 1).fit(
        {"global": sp.csr_matrix(Xg)}, {}, y)
    ref = np.asarray(model["fixed"].model.coefficients.variances)
    np.testing.assert_allclose(single, ref, rtol=1e-3)
