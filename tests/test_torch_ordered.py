"""The port's fixed-order CPU arithmetic (``photon_ml_tpu_torch/ops/
ordered.py``) and the paths that take it.

The port's CPU solves must not depend on the host's BLAS: a process group
of k ranks is meant to give the bits of k logical shards or tiles (a
rank's vectors are its own allocations where the logical form's are views
of larger tensors), and a solve whose stop rule is decided by the last bit
of a value must decide alike on every host.  ``torch.dot`` through MKL gave
other bits on another vendor's CPU.  Here:

- the fused multiply-add rounds once, against exact rational arithmetic;
- ``ordered.dot``, ``matvec`` and ``rmatvec`` follow their
  documented orders bit for bit (a plain Python re-statement of each
  order over exact rationals), agree with the library calls to rounding,
  and give the same bits for a view at any offset as for its fresh copy,
  at one thread and at several;
- the solves whose outcome the BLAS used to decide (the single-process
  L-BFGS, OWL-QN and TRON on the kernel layout with a dense intercept
  stripe, the GLM driver, the 2 x 2 tensor-parallel grid, ADMM and block
  CD over logical shards) make no BLAS call at all: ``torch.dot`` and
  every matrix product raise while they run;
"""

import os
import sys
from fractions import Fraction

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu_torch.ops import ordered

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_workers as workers  # noqa: E402

_MANT = {np.float32: 24, np.float64: 53}
_EMIN = {np.float32: -126, np.float64: -1022}


def _round(v: Fraction, dtype):
    """The float of ``dtype`` nearest ``v`` (ties to even), exactly."""
    if v == 0:
        return dtype(0.0)
    sign, x = (-1, -v) if v < 0 else (1, v)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    q = max(e, _EMIN[dtype]) - (_MANT[dtype] - 1)
    n = round(x / Fraction(2) ** q)  # half to even
    return dtype(sign * float(n * Fraction(2) ** q))


def _fma(x, y, c, dtype):
    return _round(Fraction(float(x)) * Fraction(float(y))
                  + Fraction(float(c)), dtype)


def _add(x, y, dtype):
    return _round(Fraction(float(x)) + Fraction(float(y)), dtype)


def _ref_dot(a, b, dtype):
    """``ordered.dot``'s order, one lane and one rounding at a time."""
    L = 16 if dtype == np.float32 else 8
    n = len(a)
    acc = [[dtype(0.0)] * L for _ in range(4)]

    def block(k, i):
        for j in range(L):
            if i + j < n:
                acc[k][j] = _fma(a[i + j], b[i + j], acc[k][j], dtype)

    i = 0
    while n - i >= 4 * L:
        for k in range(4):
            block(k, i + k * L)
        i += 4 * L
    if n - i >= 2 * L:
        block(0, i)
        block(1, i + L)
        i += 2 * L
    if n - i >= L:
        block(0, i)
        i += L
    if n > i:
        block(0, i)
    s = [_add(_add(acc[0][j], acc[1][j], dtype),
              _add(acc[2][j], acc[3][j], dtype), dtype) for j in range(L)]
    while len(s) > 4:
        h = len(s) // 2
        s = [_add(s[j], s[j + h], dtype) for j in range(h)]
    if dtype == np.float32:
        return _add(_add(s[0], s[1], dtype), _add(s[2], s[3], dtype), dtype)
    return _add(_add(s[0], s[2], dtype), _add(s[1], s[3], dtype), dtype)


def _ref_row(x, v, dtype):
    """``ordered.matvec``'s order for one row."""
    L = 16 if dtype == np.float32 else 8
    n = len(x)
    first = _round(Fraction(float(x[0])) * Fraction(float(v[0])), dtype)
    acc = [[dtype(0.0)] * L for _ in range(2)]
    i = 1
    while n - i >= 2 * L:
        for k in range(2):
            for j in range(L):
                p = i + k * L + j
                acc[k][j] = _fma(x[p], v[p], acc[k][j], dtype)
        i += 2 * L
    s = [_add(acc[0][j], acc[1][j], dtype) for j in range(L)]
    while n > i:
        for j in range(min(L, n - i)):
            s[j] = _fma(x[i + j], v[i + j], s[j], dtype)
        i += L
    while len(s) > 1:
        h = len(s) // 2
        s = [_add(s[j], s[j + h], dtype) for j in range(h)]
    return _add(first, s[0], dtype)


def _ref_col(x, u, dtype):
    """``ordered.rmatvec``'s order for one column of a few rows."""
    acc = dtype(0.0)
    for i in range(len(x)):
        acc = _fma(x[i], u[i], acc, dtype)
    return acc


def _data(rng, shape, dtype):
    """Normal values over six decades, so sums cancel and round."""
    return (rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3, size=shape)
            ).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_multiply_add_rounds_once(dtype):
    rng = np.random.default_rng(7)
    fma = ordered._fma32 if dtype == np.float32 else ordered._fma64
    x, y = (rng.normal(size=(2, 400))
            * 2.0 ** rng.integers(-30, 30, (2, 400))).astype(dtype)
    # Half the addends nearly cancel the product, half are unrelated.
    near = -(x.astype(np.float64) * y) * (
        1 + rng.normal(size=400) * 2.0 ** -rng.integers(1, 40, 400))
    far = rng.normal(size=400) * 2.0 ** rng.integers(-60, 60, 400)
    c = np.where(np.arange(400) % 2 == 0, near, far).astype(dtype)
    got = fma(x, y, c)
    want = np.array([_fma(*t, dtype) for t in zip(x, y, c)], dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 16, 17, 33, 40, 50, 64, 100,
                               117, 199, 300])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dot_follows_its_order(n, dtype):
    rng = np.random.default_rng(n)
    a, b = _data(rng, n, dtype), _data(rng, n, dtype)
    got = ordered.dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == () and got.dtype == torch.from_numpy(a).dtype
    assert got.numpy().tobytes() == np.asarray(
        _ref_dot(a, b, dtype), dtype).tobytes()


@pytest.mark.parametrize("n", [1, 2, 5, 17, 33, 40, 70])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matvec_and_rmatvec_follow_their_orders(n, dtype):
    rng = np.random.default_rng(100 + n)
    x = _data(rng, (3, n), dtype)
    v, u = _data(rng, n, dtype), _data(rng, 3, dtype)
    mv = ordered.matvec(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    want = np.array([_ref_row(row, v, dtype) for row in x], dtype)
    np.testing.assert_array_equal(mv, want)
    rv = ordered.rmatvec(torch.from_numpy(x), torch.from_numpy(u)).numpy()
    want = np.array([_ref_col(x[:, j], u, dtype) for j in range(n)], dtype)
    np.testing.assert_array_equal(rv, want)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 16, 40, 199, 398, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dot_agrees_with_the_library(n, dtype):
    g = torch.Generator().manual_seed(n)
    a = torch.randn(n, generator=g, dtype=dtype)
    b = torch.randn(n, generator=g, dtype=dtype)
    d = ordered.dot(a, b)
    assert d.dtype == dtype and d.shape == ()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    scale = max(1.0, float((a.abs() * b.abs()).sum()))
    assert abs(float(d) - float(torch.dot(a, b))) <= tol * scale


@pytest.mark.parametrize("shape", [(1, 1), (5, 3), (7, 600), (64, 7),
                                   (300, 40)])
def test_matvec_and_rmatvec_agree_with_the_library(shape):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(*shape, generator=g)
    v = torch.randn(shape[1], generator=g)
    u = torch.randn(shape[0], generator=g)
    mv, rv = ordered.matvec(x, v), ordered.rmatvec(x, u)
    assert mv.shape == (shape[0],) and rv.shape == (shape[1],)
    torch.testing.assert_close(mv, x @ v, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rv, x.T @ u, rtol=1e-5, atol=1e-5)
    # A row's result is its own: the same with or without its neighbours.
    for i in range(shape[0]):
        assert torch.equal(ordered.matvec(x[i:i + 1], v), mv[i:i + 1])


def test_other_dtypes_take_the_library_call():
    a = torch.arange(5, dtype=torch.int64)
    assert int(ordered.dot(a, a)) == 30
    x = torch.ones(2, 3, dtype=torch.float16)
    assert ordered.matvec(x, torch.ones(3, dtype=torch.float16)).tolist() \
        == [3.0, 3.0]


@pytest.mark.parametrize("n", [6, 199, 397, 1000])
def test_bits_do_not_depend_on_offset_or_threads(n):
    """The same values give the same bits whatever their address (a view
    at each of 16 offsets against its fresh copy) and whatever the thread
    count."""
    g = torch.Generator().manual_seed(n)
    base_a = torch.randn(n + 16, generator=g)
    base_b = torch.randn(n + 16, generator=g)
    x = torch.randn(n + 16, 5, generator=g)
    threads = torch.get_num_threads()
    try:
        results = set()
        for nt in (1, max(2, threads)):
            torch.set_num_threads(nt)
            for k in range(16):
                a, b = base_a[k:k + n], base_b[k:k + n]
                fresh = ordered.dot(a.clone(), b.clone())
                assert torch.equal(ordered.dot(a, b), fresh)
                xs = x[k:k + n]
                assert torch.equal(ordered.rmatvec(xs, a),
                                   ordered.rmatvec(xs.clone(), a.clone()))
                assert torch.equal(ordered.matvec(xs.T, a),
                                   ordered.matvec(xs.T.clone(), a.clone()))
            results.add(ordered.dot(base_a[3:3 + n],
                                    base_b[3:3 + n]).item())
        assert len(results) == 1
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def no_blas(monkeypatch):
    """``torch.dot`` and every matrix product raise while the test runs."""
    def refuse(*a, **k):
        raise AssertionError("a BLAS call on an ordered path")

    for name in ("dot", "vdot", "mv", "mm", "matmul", "addmv", "addmm",
                 "inner", "einsum", "tensordot"):
        monkeypatch.setattr(torch, name, refuse)
    for name in ("dot", "mv", "mm", "matmul", "__matmul__", "__rmatmul__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_no_blas_fixture_refuses(no_blas):
    with pytest.raises(AssertionError, match="BLAS"):
        torch.dot(torch.ones(3), torch.ones(3))
    with pytest.raises(AssertionError, match="BLAS"):
        torch.ones(2, 3) @ torch.ones(3)


def _sparse_intercept_problem(seed=12, n=600, d=40):
    """The solver tests' sparse float32 problem: 39 sparse columns and a
    dense intercept column, which the kernel layout keeps as a stripe."""
    rng = np.random.default_rng(seed)
    X = sp.random(n, d - 1, density=0.15,
                  random_state=np.random.RandomState(seed), format="csr",
                  dtype=np.float32)
    X.data = rng.normal(size=X.nnz).astype(np.float32)
    X = sp.hstack([X, np.ones((n, 1), np.float32)], format="csr")
    w_true = (rng.normal(size=d) * (rng.uniform(size=d) < 0.4)).astype(
        np.float32)
    y = rng.poisson(np.exp(0.3 * (X @ w_true))).astype(np.float32)
    return X, y


@pytest.mark.parametrize("optimizer,reg", [("LBFGS", "l2"), ("TRON", "l2"),
                                           ("LBFGS", "elastic")])
@pytest.mark.parametrize("accumulate", ["f32", "f64"])
def test_single_process_solves_make_no_blas_call(no_blas, optimizer, reg,
                                                  accumulate):
    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    X, y = _sparse_intercept_problem()
    regs = {"l2": RegularizationContext.l2(),
            "elastic": RegularizationContext.elastic_net(0.5)}
    prob = GlmOptimizationProblem("poisson", GlmOptimizationConfig(
        optimizer=OptimizerConfig(optimizer=OptimizerType[optimizer],
                                  max_iters=30, tolerance=1e-4),
        regularization=regs[reg]), accumulate=accumulate)
    data = make_glm_data(X, y, use_kernel=True, device="cpu")
    assert data.features.has_dense_cols  # the intercept stripe
    res = prob.solve_single_device(data, 1.0)
    assert np.all(np.isfinite(res.w.numpy())) and res.iterations > 0


def test_glm_driver_makes_no_blas_call(no_blas, tmp_path):
    """The data-parallel test's single-process driver run (an L2 grid of
    L-BFGS solves on binary LIBSVM features)."""
    from photon_ml_tpu_torch.data.libsvm import write_libsvm
    from photon_ml_tpu_torch.drivers import glm_driver

    X, _ = workers.make_xy(250, 10, 3)
    Xb = sp.csr_matrix((np.abs(X) > 0.4).astype(np.float32))
    rng = np.random.default_rng(5)
    margins = Xb @ rng.normal(scale=2.0, size=X.shape[1]) - 1.0
    yb = rng.uniform(size=X.shape[0]) < 1 / (1 + np.exp(-margins))
    write_libsvm(str(tmp_path / "train.libsvm"), Xb, np.where(yb, 1.0, -1.0))
    out = glm_driver.run([
        "--train-data", str(tmp_path / "train.libsvm"), "--reg-type", "l2",
        "--reg-weights", "0.1,1,10", "--tolerance", "1e-4",
        "--output-mode", "all", "--device", "cpu",
        "--output-dir", str(tmp_path / "out")])
    assert len(out["metrics"]) == 3


def test_tensor_parallel_solves_make_no_blas_call(no_blas):
    from photon_ml_tpu_torch.parallel import tensor

    out = workers.tp_cases(tensor.dp_tp_mesh(2, 2))
    for kind in ("lbfgs", "owlqn", "tron"):
        assert np.all(np.isfinite(out[f"{kind}/w"]))
        assert int(out[f"{kind}/iterations"]) > 0


@pytest.mark.parametrize("case,n_shards", [("admm", 2), ("admm", 4),
                                           ("block_cd", 2), ("block_cd", 4)])
def test_host_kind_solvers_make_no_blas_call(no_blas, case, n_shards):
    ws, count = workers.run_case(case, None, n_shards=n_shards)
    assert count > 0
    for w in ws.values():
        assert np.all(np.isfinite(w))

