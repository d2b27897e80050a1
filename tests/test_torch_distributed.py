"""The port's data-parallel layer (``parallel/distributed.py``) against the
JAX package's, on the CPU.

- ``shard_glm_data`` builds the reference's row blocks exactly: padding
  rows of weight 0, contiguous blocks, local row ids, the same per-shard
  arrays.
- A process group of ONE rank (gloo, a file rendezvous) is bitwise the
  single-device path: the λ grid, ADMM and block CD, with one all-reduce
  an objective evaluation.
- Spawned groups of 2 and 4 gloo ranks: each rank's grid lands within
  1e-5 of the reference's mesh of the same size (the 8 virtual CPU devices
  of ``conftest.py``) and the ranks agree bitwise; ADMM and block CD over
  the group match the port's logical shards at the reference's own
  tolerances (``tests/test_solvers.py``) — bitwise, in fact: each logical
  ADMM x-update is its own single solve, as each rank's is, block CD's
  batched steps give each shard its own numbers, and a round's payloads
  are added in rank order.  ``glm_driver --data-parallel auto`` over the
  group writes the single-process run's models within 1e-4.
"""

import multiprocessing
import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.optim import problem as jp
from photon_ml_tpu.optim.regularization import RegularizationContext as JReg
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu_torch.parallel import distributed, multihost

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_workers as workers  # noqa: E402
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

#: Seconds a spawned group may take before the test fails (it normally
#: takes well under 20).
JOIN_TIMEOUT = 90


def _make_xy(n=250, d=10, seed=3):
    return workers.make_xy(n, d, seed)


def _ref_problem(task, reg, tolerance):
    regs = {"l2": JReg.l2(), "elastic_net": JReg.elastic_net(0.5)}
    return jp.GlmOptimizationProblem(task, jp.GlmOptimizationConfig(
        optimizer=jp.OptimizerConfig(max_iters=150, tolerance=tolerance),
        regularization=regs[reg]))


# -- shard_glm_data ---------------------------------------------------------


@pytest.mark.parametrize("n_shards", [3, 4])
def test_shard_glm_data_dense_matches_reference(n_shards):
    X, y = _make_xy(n=103, d=5)
    w = np.linspace(0.5, 1.5, 103).astype(np.float32)
    off = np.linspace(-1, 1, 103).astype(np.float32)
    port = distributed.shard_glm_data(X, y, None, weights=w, offsets=off,
                                      n_shards=n_shards, device="cpu")
    ref = jdist.shard_glm_data(X, y, None, weights=w, offsets=off,
                               n_shards=n_shards)
    assert port.n_shards == ref.n_shards == n_shards
    np.testing.assert_array_equal(port.dense.numpy(),
                                  np.asarray(ref.data.features.data))
    for name in ("labels", "weights", "offsets"):
        np.testing.assert_array_equal(port.stacked(name).numpy(),
                                      np.asarray(getattr(ref.data, name)))
    # Padded rows carry weight 0, label 0 and offset 0.
    assert port.stacked("weights").numpy().reshape(-1)[103:].tolist() == [
        0.0] * (port.rows_per * n_shards - 103)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["coo", "kernel-layout"])
def test_shard_glm_data_sparse_matches_reference(use_kernel):
    X, y = _make_xy(n=103, d=7)
    X[np.abs(X) < 0.3] = 0.0
    port = distributed.shard_glm_data(sp.csr_matrix(X), y, None, n_shards=4,
                                      use_kernel=use_kernel, device="cpu")
    ref = jdist.shard_glm_data(sp.csr_matrix(X), y, None, n_shards=4)
    F = ref.data.features
    for i, s in enumerate(port.shards):
        assert s.n_rows == F.n_rows == 26
        if use_kernel:
            dense = np.zeros((F.n_rows, F.n_cols), np.float32)
            np.add.at(dense, (np.asarray(F.row_ids[i]),
                              np.asarray(F.col_ids[i])),
                      np.asarray(F.values[i]))
            np.testing.assert_array_equal(
                s.features.to_dense().data.numpy(), dense)
        else:
            # The reference's nnz budget and local row ids, entry for entry.
            for a, b in (("row_ids", F.row_ids), ("col_ids", F.col_ids),
                         ("values", F.values)):
                np.testing.assert_array_equal(
                    getattr(s.features, a).numpy(), np.asarray(b[i]))
        np.testing.assert_array_equal(s.labels.numpy(),
                                      np.asarray(ref.data.labels[i]))
        np.testing.assert_array_equal(s.weights.numpy(),
                                      np.asarray(ref.data.weights[i]))


# -- a process group of one rank ----------------------------------------------


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield multihost.global_data_mesh()
    finally:
        dist.destroy_process_group()


def _count_calls(monkeypatch, obj, name):
    calls = {"n": 0}
    fn = getattr(obj, name)

    def counted(*a, **k):
        calls["n"] += 1
        return fn(*a, **k)

    monkeypatch.setattr(obj, name, counted)
    return calls


def test_one_rank_grid_is_single_device_bitwise(one_rank_group,
                                                monkeypatch):
    """World size 1: ``run_grid_distributed`` (variances included) equals
    ``problem.run_grid`` bitwise, with one all-reduce per objective
    evaluation (one rmatvec each) and one per variance pass."""
    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.optim.problem import GlmOptimizationConfig

    X, y = _make_xy()
    prob = workers.problem("logistic", "l2")
    prob = type(prob)("logistic", GlmOptimizationConfig(
        optimizer=prob.config.optimizer,
        regularization=prob.config.regularization, compute_variances=True))
    single = prob.run_grid(make_glm_data(sp.csr_matrix(X), y, device="cpu"),
                           [1.0, 0.1])
    dist_data = distributed.shard_glm_data(sp.csr_matrix(X), y,
                                           one_rank_group, device="cpu")
    feats = dist_data.local().features
    evals = _count_calls(monkeypatch, feats, "rmatvec")
    var_passes = _count_calls(monkeypatch, feats, "sq_rmatvec")
    distributed.reset_allreduces()
    grid = distributed.run_grid_distributed(prob, dist_data, one_rank_group,
                                            [1.0, 0.1])
    assert distributed.ALLREDUCES["count"] == evals["n"] + var_passes["n"]
    assert var_passes["n"] == 2
    for (lam, m, res), (lam1, m1, res1) in zip(grid, single):
        assert lam == lam1 and res.iterations == res1.iterations
        assert torch.equal(m.coefficients.means, m1.coefficients.means)
        assert torch.equal(m.coefficients.variances,
                           m1.coefficients.variances)


@pytest.mark.parametrize("reg", ["l2", "elastic_net"])
def test_one_rank_distributed_solve_is_single_device_bitwise(one_rank_group,
                                                             reg):
    """``distributed_solve`` hands ``solve_fn`` the rank's shard and the
    group's reduce hook; at world size 1 the solve (L-BFGS, OWL-QN) is
    bitwise the single-device one."""
    from photon_ml_tpu_torch.data.dataset import make_glm_data

    X, y = _make_xy()
    prob = workers.problem("logistic", reg)
    w0 = torch.zeros(X.shape[1])
    single = prob.solve(make_glm_data(X, y, device="cpu"), 0.1, w0)
    res = distributed.distributed_solve(
        lambda local, w, reduce: prob.solve(local, 0.1, w, reduce=reduce),
        distributed.shard_glm_data(X, y, one_rank_group, device="cpu"), w0,
        one_rank_group)
    assert res.iterations == single.iterations
    assert torch.equal(res.w, single.w)


@pytest.mark.parametrize("case", ["admm", "block_cd"])
def test_one_rank_host_kind_solver_is_one_logical_shard(one_rank_group,
                                                        case):
    ws, _ = workers.run_case(case, one_rank_group)
    ws1, _ = workers.run_case(case, None, n_shards=1)
    for lam in ws:
        assert ws[lam].tobytes() == ws1[lam].tobytes()


# -- spawned gloo groups of 2 and 4 ranks -----------------------------------


def _spawn_group(world, tmp_path, driver_argv=None):
    """Run ``torch_dist_workers.rank_main`` on ``world`` spawned ranks;
    every join is bounded by JOIN_TIMEOUT and a rank left running or
    exiting non-zero fails the test."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.rank_main,
                         args=(r, world, str(tmp_path / "rendezvous"),
                               str(tmp_path), driver_argv))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def group_run(request, tmp_path_factory):
    world = request.param
    X, y = _make_xy()
    root = tmp_path_factory.mktemp(f"group{world}")
    from photon_ml_tpu_torch.data.libsvm import write_libsvm

    # Binary features with labels drawn from their own logistic margins.
    Xb = sp.csr_matrix((np.abs(X) > 0.4).astype(np.float32))
    rng = np.random.default_rng(5)
    margins = Xb @ rng.normal(scale=2.0, size=X.shape[1]) - 1.0
    yb = rng.uniform(size=X.shape[0]) < 1 / (1 + np.exp(-margins))
    write_libsvm(str(root / "train.libsvm"), Xb, np.where(yb, 1.0, -1.0))
    driver_argv = [
        "--train-data", str(root / "train.libsvm"), "--reg-type", "l2",
        "--reg-weights", "0.1,1,10", "--tolerance", "1e-4",
        "--output-mode", "all", "--device", "cpu",
        "--output-dir", str(root / "dp"), "--data-parallel", "auto"]
    ranks = _spawn_group(world, root, driver_argv)
    return world, X, y, ranks, root, driver_argv


def test_group_grid_matches_reference_mesh(group_run, eight_devices):
    """Each rank's λ grid (L2 L-BFGS, elastic-net OWL-QN) within 1e-5 of
    the reference's mesh of the same size; the ranks bitwise equal; each
    rank held its ``host_local_rows`` block."""
    world, X, y, ranks, _, _ = group_run
    mesh = jdist.data_mesh(eight_devices[:world])
    ref_dist = jdist.shard_glm_data(sp.csr_matrix(X), y, mesh)
    rows_per = -(-X.shape[0] // world)
    for r, saved in enumerate(ranks):
        assert saved["host_local_rows"].tolist() == [
            min(r * rows_per, X.shape[0]),
            min((r + 1) * rows_per, X.shape[0])]
    for case in ("lbfgs_l2", "owlqn_elastic_net"):
        task, reg, _, _, lams, _, tol, _ = workers.CASES[case]
        ref = jdist.run_grid_distributed(_ref_problem(task, reg, tol),
                                         ref_dist, mesh, lams)
        for lam, m, _ in ref:
            w = ranks[0][f"{case}/{lam}"]
            for other in ranks[1:]:
                assert other[f"{case}/{lam}"].tobytes() == w.tobytes()
            np.testing.assert_allclose(
                w, np.asarray(m.coefficients.means), rtol=0,
                atol=1e-5 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("case,atol", [("admm", 5e-4), ("block_cd", 5e-5)])
def test_group_host_kind_solvers_match_logical_shards(group_run, case, atol):
    """ADMM and block CD over the group against the port's logical shards
    of the same count, at the reference's mesh-vs-logical tolerances, and
    bitwise: a round's payloads are added in rank order, the logical
    shards' order.  (The 64- and 128-row shards are whole multiples of the
    CPU's vector width: vectorized exp rounds a vector's tail apart from
    its body, so a shard's elementwise losses batched beside another
    shard repeat its own bits only when its rows start on a vector
    boundary.)"""
    world, _, _, ranks, _, _ = group_run
    logical, count = workers.run_case(case, None, n_shards=world)
    for lam, w in logical.items():
        got = ranks[0][f"{case}/{lam}"]
        for other in ranks[1:]:
            assert other[f"{case}/{lam}"].tobytes() == got.tobytes()
        np.testing.assert_allclose(got, w, rtol=0, atol=atol)
        assert got.tobytes() == w.tobytes()
    assert int(ranks[0][f"{case}/allreduces"]) == count


def test_group_driver_data_parallel(group_run, tmp_path):
    """``glm_driver --data-parallel auto`` over the group: rank 0 writes
    every λ's model within 1e-4 of the single-process run's (the solves
    stop at 1e-4, above the float32 noise floor, where the group's sum
    order would decide the last iterations)."""
    from photon_ml_tpu_torch.drivers import glm_driver
    from photon_ml_tpu_torch.io import model_store

    world, _, _, ranks, root, argv = group_run
    single_out = str(tmp_path / "single")
    single = glm_driver.run(argv[:argv.index("--output-dir")] + [
        "--output-dir", single_out])
    assert int(ranks[0]["driver/ranks"]) == world
    for lam in single["metrics"]:
        name = f"model_lambda_{float(lam):g}.avro"
        m, _ = model_store.load_glm_model(os.path.join(root, "dp", name),
                                          device="cpu")
        m1, _ = model_store.load_glm_model(os.path.join(single_out, name),
                                           device="cpu")
        np.testing.assert_allclose(m.coefficients.means.numpy(),
                                   m1.coefficients.means.numpy(), atol=1e-4)
