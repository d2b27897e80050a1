"""The SpMV kernels' host layout: the column kernel's row-block table, the
row kernel's lanes per row, and the blocked plain version against the
JAX package.

The column kernel (``csrc/spmv.cu``) sums each column over row blocks of
``_kernels.ROW_BLOCK`` rows through the table ``row_block_table`` builds;
its plain version (``_kernels.spmv_cols_plain``) follows the same table, so
a wrong table fails here on the CPU.  Tables are built at a small
``block_rows`` (64) so that small matrices span many blocks.  Inputs come
from numpy seeds; reductions are compared at rtol 1e-5 on the scale
Σ|f(v)·x| of each output (segment sums in another order than the JAX COO
products, so never bitwise).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.sparse import from_coo as jax_from_coo

from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.ops.sparse_cuda import (
    build_cuda_matrix,
    row_block_table,
)
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

RTOL = 1e-5
BLOCK = 64


def _csc(rows, cols, n_cols):
    """(b_indptr, b_idx) of unique (row, col) entries, rows ascending in
    each column — the layout ``build_cuda_matrix`` gives the kernel."""
    order = np.lexsort((rows, cols))
    b_indptr = np.zeros(n_cols + 1, np.int64)
    np.cumsum(np.bincount(cols, minlength=n_cols), out=b_indptr[1:])
    return b_indptr, rows[order].astype(np.int64)


def _triples(kind, n, d, k, seed):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    if kind == "zipf":
        cols = np.minimum(rng.zipf(1.3, size=n * k) - 1, d - 1)
    else:
        cols = rng.integers(0, d, size=n * k)
    keys = np.unique(rows * d + cols)
    rows, cols = keys // d, keys % d
    return rows, cols, rng.normal(size=rows.size).astype(np.float32)


def _assert_table(table, b_indptr, b_idx, n_rows, block_rows):
    n_cols = b_indptr.shape[0] - 1
    n_rb = max(1, -(-n_rows // block_rows))
    assert table.shape == (n_cols, n_rb + 1) and table.dtype == np.int64
    # The sub-ranges partition every column ...
    np.testing.assert_array_equal(table[:, 0], b_indptr[:-1])
    np.testing.assert_array_equal(table[:, -1], b_indptr[1:])
    assert np.all(np.diff(table, axis=1) >= 0)
    # ... and every entry's row lies in its block.
    for j in range(n_cols):
        for t in range(n_rb):
            r = b_idx[table[j, t]:table[j, t + 1]]
            assert np.all(r // block_rows == t), (j, t)


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
@pytest.mark.parametrize("n_rows", [1000, 960, 50],
                         ids=["ragged-last-block", "whole-blocks",
                              "one-short-block"])
def test_row_block_table_partitions_columns(kind, n_rows):
    d = 90
    rows, cols, _ = _triples(kind, n_rows, d, 4, seed=n_rows)
    # Column 3 empty; row block 2 holds no entries.
    keep = (cols != 3) & ((rows // BLOCK != 2) | (n_rows <= 2 * BLOCK))
    rows, cols = rows[keep], cols[keep]
    b_indptr, b_idx = _csc(rows, cols, d)
    table = row_block_table(b_indptr, b_idx, n_rows, BLOCK)
    _assert_table(table, b_indptr, b_idx, n_rows, BLOCK)
    assert table[3, 0] == table[3, -1]  # the empty column
    if n_rows > 3 * BLOCK:
        np.testing.assert_array_equal(table[:, 2], table[:, 3])


def test_row_block_table_edge_shapes():
    # No entries at all, and no rows.
    empty = row_block_table(np.zeros(5, np.int64), np.zeros(0, np.int64),
                            200, BLOCK)
    assert empty.shape == (4, 5) and not empty.any()
    none = row_block_table(np.zeros(3, np.int64), np.zeros(0, np.int64), 0,
                           BLOCK)
    assert none.shape == (2, 2) and not none.any()
    # The library's own block size: a small matrix is one block.
    b_indptr, b_idx = _csc(np.array([0, 5, 9]), np.array([1, 1, 0]), 2)
    table = row_block_table(b_indptr, b_idx, 10)
    np.testing.assert_array_equal(table, [[0, 1], [1, 3]])
    assert _kernels.n_row_blocks(10) == 1
    assert _kernels.n_row_blocks(3 * _kernels.ROW_BLOCK + 1) == 4


def test_build_stores_the_table_and_group():
    rows, cols, vals = _triples("uniform", 700, 120, 9, seed=1)
    M = build_cuda_matrix(rows, cols, vals, 700, 120, device="cpu")
    table = row_block_table(M.b_indptr.numpy(), M.b_idx.numpy(), 700)
    np.testing.assert_array_equal(M.b_blockptr.numpy(), table)
    assert M.row_group == _kernels.row_group(M.f_idx.numel(), 700) == 4
    assert M.col_group == _kernels.col_group(np.diff(table, axis=1))


@pytest.mark.parametrize("mean,group", [
    (0.0, 4), (1.0, 4), (16.0, 4), (16.5, 8), (31.94, 8), (32.0, 8),
    (33.0, 16), (64.0, 16), (65.0, 32), (500.0, 32)])
def test_row_group_choice(mean, group):
    # The fewest lanes whose ROW_UNROLL loads each cover a mean row in one
    # round.
    assert _kernels.row_group(int(mean * 1000), 1000) == group
    assert group * _kernels.ROW_UNROLL >= min(mean, 128)
    assert _kernels.row_group(10, 0) == 4  # no rows


@pytest.mark.parametrize("case,group", [
    ("empty", 4), ("short", 4), ("medium", 8), ("bench", 16),
    ("bench-long-tail", 16), ("longer", 16), ("skewed-head", 16)])
def test_col_group_choice(case, group):
    # Per (column, row block) sub-range, with COL_UNROLL (8) loads a lane,
    # from the entry-weighted mean length within a tenth, at most 16.
    rng = np.random.default_rng(3)
    lengths = {
        "empty": np.zeros((10, 4)),
        "short": rng.poisson(8, size=(100, 4)),
        "medium": np.full((100, 4), 60),
        "bench": rng.binomial(1 << 15, 1 / 256, size=(8192, 32)),  # ~128
        "bench-long-tail": np.append(np.full(999, 128), 140),
        "longer": np.full((50, 4), 150),
        # mostly short sub-ranges, most entries in a few long ones
        "skewed-head": np.append(np.full(4000, 20), np.full(60, 1000)),
    }[case]
    assert _kernels.col_group(lengths) == group


OPS = ("rmatvec", "sq_rmatvec")


@pytest.mark.parametrize("unit", [False, True], ids=["valued", "unit"])
@pytest.mark.parametrize("kind", ["uniform", "zipf"])
def test_blocked_plain_matches_spmv_plain_and_jax(kind, unit):
    n, d = 1000, 150
    rows, cols, vals = _triples(kind, n, d, 8, seed=11)
    if unit:
        vals = np.ones_like(vals)
    b_indptr, b_idx = _csc(rows, cols, d)
    order = np.lexsort((rows, cols))
    table = torch.from_numpy(row_block_table(b_indptr, b_idx, n, BLOCK))
    ip, ix = torch.from_numpy(b_indptr), torch.from_numpy(b_idx.astype(
        np.int32))
    val = None if unit else torch.from_numpy(vals[order])
    C = jax_from_coo(rows, cols, vals, n, d)
    u = np.random.default_rng(5).normal(size=n).astype(np.float32)
    for op in OPS:
        sq = op == "sq_rmatvec"
        blocked = _kernels.spmv_cols_plain(table, ix, val, torch.from_numpy(u),
                                           unit=unit, square=sq).numpy()
        flat = _kernels.spmv_plain(ip, ix, val, torch.from_numpy(u),
                                   unit=unit, square=sq).numpy()
        f = np.abs(vals.astype(np.float64)) ** (2 if sq else 1)
        scale = np.bincount(cols, weights=f * np.abs(u[rows]), minlength=d)
        tol = RTOL * np.maximum(scale, 1e-30)
        assert np.all(np.abs(blocked - flat) <= tol), op
        ref = np.asarray(getattr(C, op)(jnp.asarray(u)))
        assert np.all(np.abs(blocked - ref) <= tol), op


def test_wrong_table_fails_the_plain_version():
    n, d = 300, 40
    rows, cols, vals = _triples("uniform", n, d, 5, seed=2)
    b_indptr, b_idx = _csc(rows, cols, d)
    table = row_block_table(b_indptr, b_idx, n, BLOCK)
    ix = torch.from_numpy(b_idx.astype(np.int32))
    u = torch.from_numpy(np.random.default_rng(1).normal(size=n).astype(
        np.float32))
    good = _kernels.spmv_cols_plain(torch.from_numpy(table), ix, None, u,
                                    unit=True)
    bad = table.copy()
    bad[7, 2] += 1  # one entry moved to the next block: still a partition
    assert torch.allclose(_kernels.spmv_cols_plain(
        torch.from_numpy(bad), ix, None, u, unit=True), good)
    bad[7, -1] -= 1  # column 7 loses its last entry
    assert not torch.allclose(_kernels.spmv_cols_plain(
        torch.from_numpy(bad), ix, None, u, unit=True), good)


@pytest.mark.parametrize("op", ["matvec", "rmatvec", "row_sq_matvec",
                                "sq_rmatvec"])
def test_matrix_with_small_row_blocks_matches_jax(op):
    # The whole matrix (bias stripe included) through a 64-row table.
    n, d = 900, 200
    rows, cols, vals = _triples("zipf", n, d, 6, seed=4)
    rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols, np.full(n, d - 1, np.int64)])
    vals = np.concatenate([vals, np.ones(n, np.float32)])
    M = build_cuda_matrix(rows, cols, vals, n, d, device="cpu")
    M = dataclasses.replace(M, b_blockptr=torch.from_numpy(row_block_table(
        M.b_indptr.numpy(), M.b_idx.numpy(), n, BLOCK)))
    assert M.b_blockptr.shape == (d, -(-n // BLOCK) + 1)
    C = jax_from_coo(rows, cols, vals, n, d)
    x = np.random.default_rng(6).normal(
        size=d if op in ("matvec", "row_sq_matvec") else n).astype(np.float32)
    out = getattr(M, op)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(C, op)(jnp.asarray(x)))
    C_abs = jax_from_coo(rows, cols, np.abs(vals), n, d)
    scale = np.asarray(getattr(C_abs, op)(jnp.abs(jnp.asarray(x))))
    assert np.all(np.abs(out - ref) <= RTOL * np.maximum(scale, 1e-30))
