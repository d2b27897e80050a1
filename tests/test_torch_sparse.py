"""The port's sparse matrices against the JAX package.

The kernel-backed CSR/CSC matrix (photon_ml_tpu_torch.ops.sparse_cuda) runs
here through its plain PyTorch path (CPU tensors); the same numpy inputs go
through the JAX ``PallasSparseMatrix`` in interpret mode (the tile kernel
itself) and through the JAX COO matrix.  Reductions are compared at rtol
1e-5 on the scale Σ|v·x| (the summation order differs between the TPU tile
sweep and a CSR segment sum, so parity is never bitwise across packages).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

os.environ.setdefault("PHOTON_PALLAS_INTERPRET", "1")

from photon_ml_tpu.ops.sparse import from_coo as jax_from_coo
from photon_ml_tpu.ops.sparse_pallas import build_pallas_matrix

from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.ops.sparse import SparseMatrix, from_coo
from photon_ml_tpu_torch.ops.sparse_cuda import (
    CudaSparseMatrix,
    build_cuda_matrix,
)
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

OPS = ("matvec", "rmatvec", "row_sq_matvec", "sq_rmatvec")
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_problem(rng, n, d, nnz, dense_col=True, dense_row=True):
    rows = rng.integers(0, n, size=nnz).astype(np.int64)
    cols = rng.integers(0, d, size=nnz).astype(np.int64)
    vals = rng.normal(size=nnz).astype(np.float32)
    if dense_col:  # a bias column touched by every row
        rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
        cols = np.concatenate([cols, np.zeros(n, np.int64)])
        vals = np.concatenate([vals, np.ones(n, np.float32)])
    if dense_row:  # one row touching many features
        k = min(d, 280)
        rows = np.concatenate([rows, np.full(k, n // 2, np.int64)])
        cols = np.concatenate([cols, np.arange(k, dtype=np.int64)])
        vals = np.concatenate([vals, np.full(k, 0.5, np.float32)])
    return rows, cols, vals


def _binary_problem(rng, n, d, nnz, bias=True):
    # Unique coordinates: duplicates would sum to 2.0 (not a unit layout).
    flat = rng.choice(n * (d - 1), size=nnz, replace=False)
    rows = (flat // (d - 1)).astype(np.int64)
    cols = (flat % (d - 1) + 1).astype(np.int64)
    if bias:  # dense stripe: kept valued even in unit mode
        rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
        cols = np.concatenate([cols, np.zeros(n, np.int64)])
    return rows, cols, np.ones(len(rows), np.float32)


def _scale(rows, cols, vals, vec, op):
    """Σ|f(v)·x| per output — the magnitude a reduction is compared at."""
    sq = op in ("row_sq_matvec", "sq_rmatvec")
    v = np.abs(vals.astype(np.float64)) ** (2 if sq else 1)
    if op in ("matvec", "row_sq_matvec"):
        contrib = v * np.abs(vec[cols])
        return np.bincount(rows, weights=contrib).max()
    contrib = v * np.abs(vec[rows])
    return np.bincount(cols, weights=contrib).max()


def _assert_close(out, ref, scale):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / max(scale, 1e-30)
    assert err < RTOL, err


def _vec_for(op, rng, n, d):
    size = d if op in ("matvec", "row_sq_matvec") else n
    return rng.normal(size=size).astype(np.float32)


_SHAPES = [
    (600, 300, 4000),  # bias column + dense row stripes
    (100, 60, 600),  # far below one TPU tile
    (300, 2100, 5000),  # wider than one TPU tile
]


class TestKernelMatrixParity:
    @pytest.mark.parametrize("op", OPS)
    @pytest.mark.parametrize("shape", _SHAPES)
    def test_matches_pallas_and_coo(self, rng, shape, op):
        n, d, nnz = shape
        rows, cols, vals = _random_problem(rng, n, d, nnz)
        M = build_cuda_matrix(rows, cols, vals, n, d, device="cpu")
        P = build_pallas_matrix(rows, cols, vals, n, d, depth_cap=32)
        C = jax_from_coo(rows, cols, vals, n, d)
        x = _vec_for(op, rng, n, d)
        out = getattr(M, op)(torch.from_numpy(x)).numpy()
        scale = _scale(rows, cols, vals, x, op)
        _assert_close(out, getattr(P, op)(jnp.asarray(x)), scale)
        _assert_close(out, getattr(C, op)(jnp.asarray(x)), scale)

    @pytest.mark.parametrize("op", OPS)
    def test_unit_layout_matches_pallas(self, rng, op):
        n, d = 700, 400
        rows, cols, vals = _binary_problem(rng, n, d, 5000)
        M = build_cuda_matrix(rows, cols, vals, n, d, device="cpu")
        P = build_pallas_matrix(rows, cols, vals, n, d, depth_cap=32)
        assert M.unit_vals and P.unit_vals
        assert M.f_val.numel() == 0 and M.b_val.numel() == 0
        assert M.has_dense_cols  # the bias column keeps its values
        x = _vec_for(op, rng, n, d)
        out = getattr(M, op)(torch.from_numpy(x)).numpy()
        _assert_close(out, getattr(P, op)(jnp.asarray(x)),
                      _scale(rows, cols, vals, x, op))

    @pytest.mark.parametrize("op", OPS)
    def test_coo_matrix_matches_jax_coo(self, rng, op):
        n, d = 400, 250
        rows, cols, vals = _random_problem(rng, n, d, 3000)
        M = from_coo(rows, cols, vals, n, d, device="cpu")
        C = jax_from_coo(rows, cols, vals, n, d)
        x = _vec_for(op, rng, n, d)
        out = getattr(M, op)(torch.from_numpy(x)).numpy()
        _assert_close(out, getattr(C, op)(jnp.asarray(x)),
                      _scale(rows, cols, vals, x, op))

    def test_repeat_runs_are_bitwise_equal(self, rng):
        n, d = 500, 300
        rows, cols, vals = _random_problem(rng, n, d, 4000)
        M = build_cuda_matrix(rows, cols, vals, n, d, device="cpu")
        w = torch.from_numpy(rng.normal(size=d).astype(np.float32))
        u = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        for op, x in (("matvec", w), ("rmatvec", u)):
            a = getattr(M, op)(x)
            b = getattr(M, op)(x)
            assert torch.equal(a, b)


class TestStorageClasses:
    def test_bias_column_becomes_dense_stripe(self, rng):
        n, d, nnz = 3000, 400, 8 * 3000
        rows = rng.integers(0, n, size=nnz).astype(np.int64)
        cols = rng.integers(1, d, size=nnz).astype(np.int64)
        vals = rng.normal(size=nnz).astype(np.float32)
        rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
        cols = np.concatenate([cols, np.zeros(n, np.int64)])
        vals = np.concatenate([vals, np.ones(n, np.float32)])
        M = build_cuda_matrix(rows, cols, vals, n, d, device="cpu")
        P = build_pallas_matrix(rows, cols, vals, n, d)
        assert M.has_dense_cols and P.has_dense_cols
        np.testing.assert_array_equal(
            M.dense_col_ids.numpy(), np.asarray(P.dense_col_ids))
        # The stripe's entries left the CSR/CSC streams.
        assert int(M.b_indptr[1] - M.b_indptr[0]) == 0
        u = rng.normal(size=n).astype(np.float32)
        _assert_close(M.rmatvec(torch.from_numpy(u)).numpy(),
                      P.rmatvec(jnp.asarray(u)),
                      _scale(rows, cols, vals, u, "rmatvec"))

    def test_dense_row_stripe_and_budget(self, rng):
        n, d = 800, 600
        rows, cols, vals = _random_problem(rng, n, d, 3000, dense_col=False)
        M = build_cuda_matrix(rows, cols, vals, n, d, device="cpu")
        assert M.has_dense_rows and not M.has_dense_cols
        assert int(M.dense_row_ids[0]) == n // 2
        # A zero stripe budget keeps everything in the CSR/CSC streams.
        M0 = build_cuda_matrix(rows, cols, vals, n, d, device="cpu",
                               dense_budget_bytes=0)
        assert not M0.has_dense_rows
        w = torch.from_numpy(rng.normal(size=d).astype(np.float32))
        _assert_close(M.matvec(w).numpy(), M0.matvec(w).numpy(),
                      _scale(rows, cols, vals, w.numpy(), "matvec"))

    def test_all_zero_values(self):
        M = build_cuda_matrix(
            np.array([0]), np.array([0]), np.array([0.0], np.float32), 10, 10,
            device="cpu",
        )
        assert M.f_idx.numel() == 0
        np.testing.assert_array_equal(
            M.matvec(torch.arange(10, dtype=torch.float32)).numpy(), 0.0)
        np.testing.assert_array_equal(
            M.rmatvec(torch.ones(10)).numpy(), 0.0)

    def test_empty_entry_list(self):
        M = build_cuda_matrix(
            np.empty(0, np.int64), np.empty(0, np.int64),
            np.empty(0, np.float32), 7, 5, device="cpu",
        )
        assert M.shape == (7, 5) and M.nnz == 0
        np.testing.assert_array_equal(M.matvec(torch.ones(5)).numpy(), 0.0)
        np.testing.assert_array_equal(M.sq_rmatvec(torch.ones(7)).numpy(), 0.0)

    def test_pad_nnz_budget(self, rng):
        n, d = 200, 100
        rows, cols, vals = _random_problem(rng, n, d, 1000, dense_row=False)
        M = build_cuda_matrix(rows, cols, vals, n, d, device="cpu")
        Mp = build_cuda_matrix(rows, cols, vals, n, d, device="cpu",
                               pad_nnz=M.nnz + 37)
        P = build_pallas_matrix(rows, cols, vals, n, d, pad_nnz=M.nnz + 37)
        assert Mp.nnz == P.nnz == M.nnz + 37  # nnz reports the budget
        assert Mp.f_idx.numel() == M.f_idx.numel()  # padding is not stored
        w = torch.from_numpy(rng.normal(size=d).astype(np.float32))
        assert torch.equal(M.matvec(w), Mp.matvec(w))
        with pytest.raises(ValueError, match="pad_nnz"):
            build_cuda_matrix(rows, cols, vals, n, d, device="cpu", pad_nnz=5)


class TestNonFinite:
    def test_nonfinite_vector_entries_stay_localized(self):
        n, d = 300, 2048
        rows = np.array([0, 1, 2], np.int64)
        cols = np.array([0, 128, 72], np.int64)
        vals = np.ones(3, np.float32)
        for unit in (True, False):
            M = build_cuda_matrix(rows, cols, vals, n, d, device="cpu",
                                  unit_values=unit)
            assert M.unit_vals is unit
            w = np.zeros(d, np.float32)
            w[128] = np.inf
            w[72] = 5.0
            w[0] = 1.0
            out = M.matvec(torch.from_numpy(w)).numpy()
            assert out[0] == 1.0 and np.isinf(out[1]) and out[2] == 5.0
            assert np.all(out[3:] == 0.0)
            u = np.zeros(n, np.float32)
            u[1] = np.nan
            u[2] = 2.0
            ru = M.rmatvec(torch.from_numpy(u)).numpy()
            assert np.isnan(ru[128]) and ru[72] == 2.0 and ru[0] == 0.0
            assert np.all(np.isfinite(np.delete(ru, 128)))

    def test_explicit_zero_entries_do_not_leak(self):
        # An explicit stored zero at (3, 9) must not turn inf·0 into NaN.
        rows = np.array([0, 3], np.int64)
        cols = np.array([1, 9], np.int64)
        vals = np.array([2.0, 0.0], np.float32)
        M = build_cuda_matrix(rows, cols, vals, 5, 10, device="cpu")
        w = np.zeros(10, np.float32)
        w[9] = np.inf
        out = M.matvec(torch.from_numpy(w)).numpy()
        assert np.all(out == 0.0)

    def test_unit_mode_localization_random(self, rng):
        n, d = 800, 500
        rows, cols, vals = _binary_problem(rng, n, d, 4000, bias=False)
        M = build_cuda_matrix(rows, cols, vals, n, d, device="cpu")
        assert M.unit_vals
        w = np.ones(d, np.float32)
        w[77] = np.inf
        out = M.matvec(torch.from_numpy(w)).numpy()
        touches = np.zeros(n, bool)
        touches[rows[cols == 77]] = True
        assert np.all(np.isinf(out[touches]))
        assert np.all(np.isfinite(out[~touches]))


class TestUnitDetection:
    def test_non_binary_values_keep_valued_layout(self, rng):
        rows, cols, _ = _binary_problem(rng, 300, 200, 2000, bias=False)
        vals = rng.normal(size=len(rows)).astype(np.float32)
        assert not build_cuda_matrix(rows, cols, vals, 300, 200,
                                     device="cpu").unit_vals

    def test_forced_off(self, rng):
        rows, cols, vals = _binary_problem(rng, 300, 200, 2000)
        M = build_cuda_matrix(rows, cols, vals, 300, 200, device="cpu",
                              unit_values=False)
        assert not M.unit_vals and M.f_val.numel() == M.f_idx.numel()

    def test_forced_on_with_nonunit_values_rejected(self, rng):
        rows, cols, _ = _binary_problem(rng, 300, 200, 2000, bias=False)
        vals = rng.normal(size=len(rows)).astype(np.float32)
        with pytest.raises(ValueError, match="unit_values"):
            build_cuda_matrix(rows, cols, vals, 300, 200, device="cpu",
                              unit_values=True)


class TestColdPaths:
    @pytest.mark.parametrize("kernel", [True, False])
    def test_cold_paths_match_jax(self, rng, kernel):
        n, d = 500, 200
        rows, cols, vals = _random_problem(rng, n, d, 3000)
        vals[:40] = 0.0  # explicit zeros count as absent
        build = build_cuda_matrix if kernel else from_coo
        M = build(rows, cols, vals, n, d, device="cpu")
        C = jax_from_coo(rows, cols, vals, n, d)
        mask = rng.uniform(size=n) < 0.8
        for rm in (None, mask):
            t_rm = None if rm is None else torch.from_numpy(rm)
            j_rm = None if rm is None else jnp.asarray(rm)
            np.testing.assert_array_equal(
                M.col_nnz(t_rm).numpy(), np.asarray(C.col_nnz(j_rm)))
            mn, mx = M.col_min_max(t_rm)
            cmn, cmx = C.col_min_max(j_rm)
            np.testing.assert_array_equal(mn.numpy(), np.asarray(cmn))
            np.testing.assert_array_equal(mx.numpy(), np.asarray(cmx))
        np.testing.assert_allclose(
            M.to_dense().data.numpy(), np.asarray(C.to_dense().data),
            rtol=0, atol=0)


class TestWrapperAndBoundary:
    def test_make_glm_data_layouts(self, rng):
        import scipy.sparse as sp

        X = sp.random(300, 120, density=0.05, random_state=3, format="csr",
                      dtype=np.float32)
        y = rng.uniform(size=300).astype(np.float32)
        auto = make_glm_data(X, y, device="cpu")
        assert isinstance(auto.features, SparseMatrix)  # CPU "auto" → COO
        kern = make_glm_data(X, y, device="cpu", use_kernel=True)
        assert isinstance(kern.features, CudaSparseMatrix)
        w = torch.from_numpy(rng.normal(size=120).astype(np.float32))
        np.testing.assert_allclose(kern.features.matvec(w).numpy(),
                                   auto.features.matvec(w).numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_plain_path_does_not_count_launches(self, rng):
        rows, cols, vals = _random_problem(rng, 100, 50, 400)
        M = build_cuda_matrix(rows, cols, vals, 100, 50, device="cpu")
        _kernels.reset_launches()
        M.matvec(torch.ones(50))
        M.rmatvec(torch.ones(100))
        assert all(v == 0 for v in _kernels.LAUNCHES.values())

    def test_wrapper_rejects_bad_operands(self):
        indptr = torch.tensor([0, 1, 2], dtype=torch.int64)
        blockptr = torch.tensor([[0, 1], [1, 2]], dtype=torch.int64)
        idx = torch.tensor([0, 1], dtype=torch.int32)
        val = torch.ones(2)
        x = torch.ones(3)

        def rows(indptr=indptr, idx=idx, val=val, x=x, n_in=3, op="matvec"):
            return _kernels.spmv_rows(indptr, idx, val, x, group=8,
                                      n_in=n_in, op=op, unit=False)

        def cols(blockptr=blockptr, idx=idx, val=val, x=x, n_in=3,
                 op="rmatvec"):
            return _kernels.spmv_cols(blockptr, idx, val, x, group=16,
                                      n_in=n_in, op=op, unit=False)

        assert rows().tolist() == [1.0, 1.0]
        assert cols().tolist() == [1.0, 1.0]
        for f in (rows, cols):
            with pytest.raises(ValueError, match="idx"):
                f(idx=idx.long())
            with pytest.raises(ValueError, match="x has"):
                f(n_in=4)
            with pytest.raises(ValueError, match="val"):
                f(val=val.double())
            with pytest.raises(ValueError, match="unknown op"):
                f(op="bogus")
            with pytest.raises(ValueError, match="unsupported device"):
                f(idx=idx.to("meta"), val=val.to("meta"), x=x.to("meta"),
                  **({"indptr": indptr.to("meta")} if f is rows
                     else {"blockptr": blockptr.to("meta")}))
        with pytest.raises(ValueError, match="unknown op"):
            rows(op="rmatvec")  # the row kernel serves the row side only
        with pytest.raises(ValueError, match="blockptr"):
            cols(blockptr=indptr)

    def test_float64_kernel_matrix_refused(self):
        with pytest.raises(ValueError, match="float32"):
            build_cuda_matrix(np.array([0]), np.array([0]),
                              np.array([1.0]), 2, 2, device="cpu",
                              dtype=torch.float64)
