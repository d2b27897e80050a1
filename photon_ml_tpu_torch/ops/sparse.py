"""Feature-matrix representations (port of ``photon_ml_tpu/ops/sparse.py``).

- ``DenseMatrix``: a plain ``(n_rows, n_cols)`` tensor; margins are one
  matmul.
- ``SparseMatrix``: flat COO with a static nnz budget (padding entries carry
  ``value = 0`` and point at the last row / col 0).  ``matvec`` is a gather
  plus a sorted segment reduction over the row-sorted entries; ``rmatvec``
  reduces over a column-sorted copy of the entry order, built once at
  construction — never ``index_add_``, whose CUDA atomics would make the
  sum order (and so the bits) change from run to run.

This COO path is what the port uses on the CPU and wherever the caller
forces ``use_kernel=False``; the kernel-backed matrix is
:mod:`photon_ml_tpu_torch.ops.sparse_cuda`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops import ordered

Tensor = torch.Tensor


def _segment_sum(contrib: Tensor, offsets: Tensor) -> Tensor:
    """Sum of each sorted segment ``[offsets[i], offsets[i+1])``; empty
    segments give 0."""
    return torch.segment_reduce(contrib, "sum", offsets=offsets)


def _offsets(sorted_ids: Tensor, n: int) -> Tensor:
    """Segment offsets (n+1,) of a sorted id vector."""
    bounds = torch.arange(n + 1, device=sorted_ids.device,
                          dtype=sorted_ids.dtype)
    return torch.searchsorted(sorted_ids, bounds).to(torch.int64)


@dataclasses.dataclass
class DenseMatrix:
    """Dense feature matrix of shape (n_rows, n_cols).

    On the CPU the four products sum in
    :mod:`~photon_ml_tpu_torch.ops.ordered`'s fixed order instead of the
    host BLAS's, so their bits depend on neither the host nor where
    ``data`` sits in memory (a logical shard's matrix is a view of one
    stacked tensor, a rank's its own allocation); on a card they are the
    plain products."""

    data: Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.data.shape)

    @property
    def n_rows(self) -> int:
        return self.data.shape[0]

    @property
    def n_cols(self) -> int:
        return self.data.shape[1]

    def matvec(self, w: Tensor) -> Tensor:
        return ordered.matvec(self.data, w)

    def rmatvec(self, u: Tensor) -> Tensor:
        return ordered.rmatvec(self.data, u)

    def row_sq_matvec(self, v: Tensor) -> Tensor:
        return ordered.matvec(self.data * self.data, v)

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        return ordered.rmatvec(self.data * self.data, u)

    def col_nnz(self, row_mask: Optional[Tensor] = None) -> Tensor:
        nz = self.data != 0
        if row_mask is not None:
            nz = nz & row_mask[:, None]
        return nz.sum(dim=0).to(torch.int32)

    def col_min_max(self, row_mask: Optional[Tensor] = None):
        if row_mask is None:
            return self.data.amin(dim=0), self.data.amax(dim=0)
        m = row_mask[:, None]
        inf = torch.tensor(float("inf"), dtype=self.data.dtype,
                           device=self.data.device)
        mins = torch.where(m, self.data, inf).amin(dim=0)
        maxs = torch.where(m, self.data, -inf).amax(dim=0)
        return mins, maxs


@dataclasses.dataclass
class SparseMatrix:
    """Flat COO sparse matrix with a static (padded) nnz budget.

    Invariants: ``row_ids`` sorted ascending; padding entries have
    ``values == 0``.  ``col_order`` is the stable column-sorted permutation
    of the entries and ``row_offsets`` / ``col_offsets`` the segment bounds
    of the two orders (derived at construction)."""

    row_ids: Tensor  # (nnz,) int64, sorted
    col_ids: Tensor  # (nnz,) int64
    values: Tensor  # (nnz,) float
    n_rows: int
    n_cols: int
    row_offsets: Tensor = dataclasses.field(init=False, repr=False)
    col_order: Tensor = dataclasses.field(init=False, repr=False)
    col_offsets: Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.row_offsets = _offsets(self.row_ids, self.n_rows)
        self.col_order = torch.argsort(self.col_ids, stable=True)
        self.col_offsets = _offsets(self.col_ids[self.col_order], self.n_cols)

    @classmethod
    def from_parts(cls, row_ids, col_ids, values, n_rows, n_cols,
                   row_offsets, col_order, col_offsets) -> "SparseMatrix":
        """A matrix whose derived orders were computed already (a streamed
        chunk carries them, as :func:`coo_parts` builds them on the host),
        so nothing is re-sorted when the chunk reaches its device."""
        m = cls.__new__(cls)
        m.row_ids, m.col_ids, m.values = row_ids, col_ids, values
        m.n_rows, m.n_cols = int(n_rows), int(n_cols)
        m.row_offsets, m.col_order = row_offsets, col_order
        m.col_offsets = col_offsets
        return m

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    def _row_reduce(self, coef: Tensor, v: Tensor) -> Tensor:
        return _segment_sum(coef * v.index_select(0, self.col_ids),
                            self.row_offsets)

    def _col_reduce(self, coef: Tensor, u: Tensor) -> Tensor:
        contrib = coef * u.index_select(0, self.row_ids)
        return _segment_sum(contrib.index_select(0, self.col_order),
                            self.col_offsets)

    def matvec(self, w: Tensor) -> Tensor:
        return self._row_reduce(self.values, w)

    def rmatvec(self, u: Tensor) -> Tensor:
        return self._col_reduce(self.values, u)

    def row_sq_matvec(self, v: Tensor) -> Tensor:
        return self._row_reduce(self.values * self.values, v)

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        return self._col_reduce(self.values * self.values, u)

    def _live_entries(self, row_mask: Optional[Tensor]) -> Tensor:
        live = self.values != 0
        if row_mask is not None:
            live = live & row_mask.index_select(0, self.row_ids)
        return live

    def col_nnz(self, row_mask: Optional[Tensor] = None) -> Tensor:
        live = self._live_entries(row_mask)
        return torch.bincount(
            self.col_ids[live], minlength=self.n_cols
        ).to(torch.int32)

    def col_min_max(self, row_mask: Optional[Tensor] = None):
        """Per-feature (min, max) over stored entries of live rows, folded
        with the implicit zeros of unstored entries."""
        live = self._live_entries(row_mask)
        nnz = torch.bincount(self.col_ids[live], minlength=self.n_cols)
        n_live_rows = (
            self.n_rows if row_mask is None else int(row_mask.sum())
        )
        has_zero = nnz < n_live_rows
        c, v = self.col_ids[live], self.values[live]
        full = torch.full((self.n_cols,), float("inf"),
                          dtype=self.values.dtype, device=self.values.device)
        mins = full.scatter_reduce(0, c, v, "amin")
        maxs = (-full).scatter_reduce(0, c, v, "amax")
        zero = torch.zeros((), dtype=mins.dtype, device=mins.device)
        mins = torch.where(has_zero, torch.minimum(mins, zero), mins)
        maxs = torch.where(has_zero, torch.maximum(maxs, zero), maxs)
        return mins, maxs

    def to_dense(self) -> DenseMatrix:
        dense = torch.zeros(self.shape, dtype=self.values.dtype,
                            device=self.values.device)
        dense.index_put_((self.row_ids, self.col_ids), self.values,
                         accumulate=True)
        return DenseMatrix(dense)


FeatureMatrix = Union[DenseMatrix, SparseMatrix]


def from_scipy_csr(csr, pad_nnz: Optional[int] = None, dtype=torch.float32,
                   device=None) -> SparseMatrix:
    """Build a SparseMatrix from a scipy CSR matrix, padding nnz to a
    static budget."""
    csr = csr.tocsr()
    csr.sum_duplicates()
    coo = csr.tocoo()
    return from_coo(coo.row, coo.col, coo.data, csr.shape[0], csr.shape[1],
                    pad_nnz, dtype, device)


def stable_argsort(keys: np.ndarray, key_bound: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for integer keys in
    ``[0, key_bound)``.  Where ``key_bound · len(keys)`` fits in int64 it
    sorts the unique composite ``key · n + position`` instead (numpy's
    unstable sort of int64, several times faster than its stable argsort of
    unsorted keys) and reads the positions back: the same permutation."""
    keys = np.asarray(keys)
    n = keys.shape[0]
    if n < 2 or int(key_bound) * n >= 1 << 62:
        return np.argsort(keys, kind="stable")
    composite = keys.astype(np.int64) * np.int64(n)
    composite += np.arange(n, dtype=np.int64)
    composite.sort()
    return composite % np.int64(n)


def canonicalize_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    pad_nnz: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side COO canonicalization shared by the COO and kernel-backed
    constructors: sum duplicate (row, col) entries, sort by (row, col), pad nnz
    to the requested budget.  Returns numpy (rows i32, cols i32, vals)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    # Duplicates must be summed, or row_sq_matvec (which squares per-entry
    # values) diverges from the dense equivalent.  One stable argsort of
    # the combined key orders by (row, col).
    keys = rows.astype(np.int64) * np.int64(n_cols) + cols.astype(np.int64)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    rows = rows[order].astype(np.int32)
    cols = cols[order].astype(np.int32)
    vals = vals[order]
    if keys.size > 1 and bool(np.any(keys[1:] == keys[:-1])):
        change = np.empty(keys.size, dtype=bool)
        change[0] = True
        np.not_equal(keys[1:], keys[:-1], out=change[1:])
        starts = np.flatnonzero(change)
        vals = np.add.reduceat(vals, starts)
        rows = rows[starts]
        cols = cols[starts]
    budget = pad_nnz if pad_nnz is not None else rows.shape[0]
    return pad_coo_triples(rows, cols, vals, budget)


def pad_coo_triples(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, budget: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad canonical (row-sorted) COO triples to a static nnz budget: pad
    entries carry value 0 and the LAST row id, so rows stay sorted and the
    entries are numerically inert."""
    nnz = rows.shape[0]
    if budget < nnz:
        raise ValueError(f"pad_nnz={budget} < actual nnz={nnz}")
    pad = budget - nnz
    if pad:
        pad_row = rows[-1] if nnz else 0
        rows = np.concatenate([rows, np.full(pad, pad_row, np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, vals.dtype)])
    return rows, cols, vals


def coo_parts(rows, cols, vals, n_rows: int, n_cols: int) -> dict:
    """Host arrays of :class:`SparseMatrix` over canonical (row-sorted)
    triples, with its derived orders computed as ``__post_init__`` computes
    them (a stable column sort, the two segment-offset vectors)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    order = stable_argsort(cols, n_cols)
    return {
        "row_ids": rows,
        "col_ids": cols,
        "values": np.asarray(vals, np.float32),
        "row_offsets": np.searchsorted(rows, np.arange(n_rows + 1)),
        "col_order": order.astype(np.int64),
        "col_offsets": np.searchsorted(cols[order], np.arange(n_cols + 1)),
    }


def from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    pad_nnz: Optional[int] = None,
    dtype=torch.float32,
    device=None,
) -> SparseMatrix:
    """Build a SparseMatrix from host COO triples (sums duplicates, sorts by
    row, pads nnz).  ``device`` is resolved by
    :func:`photon_ml_tpu_torch.device.resolve_device`."""
    dev = resolve_device(device)
    rows, cols, vals = canonicalize_coo(rows, cols, vals, n_rows, n_cols,
                                        pad_nnz)
    return SparseMatrix(
        row_ids=torch.as_tensor(rows.astype(np.int64), device=dev),
        col_ids=torch.as_tensor(cols.astype(np.int64), device=dev),
        values=torch.as_tensor(np.asarray(vals), device=dev).to(dtype),
        n_rows=int(n_rows),
        n_cols=int(n_cols),
    )
