"""Kernel-backed sparse feature matrix (port of
``photon_ml_tpu/ops/sparse_pallas.py``'s ``PallasSparseMatrix``).

The TPU layout packs entries into a window-packed slot grid because
Mosaic's only fast gather is a 128-lane ``dynamic_gather``; that grid needs
a cost-model depth, a compact COO spill for overflow and a column
permutation to balance hot windows.  A GPU gathers from its caches
directly, so the port stores plain CSR for the row orientation and a CSC
copy (the CSR of Xᵀ, built on the host) for the column orientation, and
runs the four hot operations through two hand-written CUDA kernels
(``csrc/spmv.cu``): the row kernel over the CSR, with ``row_group`` lanes a
row (:func:`photon_ml_tpu_torch.ops._kernels.spmv_rows`), and the column
kernel over the CSC copy cut into row blocks by ``b_blockptr``
(:func:`row_block_table`, :func:`~photon_ml_tpu_torch.ops._kernels.spmv_cols`).
A CSR segment has no depth cap, so nothing spills.

Storage classes, split at build time exactly as the reference splits them:

- **CSR/CSC streams** — the bulk of the entries, through the kernel;
- **dense stripes** — columns with ≥ ``max(256, n_rows·dense_frac)``
  entries (then rows with ≥ ``max(256, n_cols·dense_frac)`` from the rest),
  at most ``max_dense`` a side and within ``dense_budget_bytes``, stored
  dense and applied as ``ops/ordered.py`` products outside the kernel
  (plain torch products on a card; the reference runs them as ``einsum``
  outside Pallas).  The driver's intercept column becomes a column stripe,
  as on the TPU.

Binary matrices (every streamed value 1.0, detected automatically) drop the
value stream: the kernel then reads 4 bytes an entry instead of 8.  Cold
operations (``col_nnz``, ``col_min_max``, ``to_dense``) run on the host over
the canonical triples (:class:`HostCoo`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device, to_numpy
from photon_ml_tpu_torch.ops._kernels import (
    ROW_BLOCK,
    col_group,
    n_row_blocks,
    row_group,
    spmv_cols,
    spmv_rows,
)
from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.ops.sparse import (
    DenseMatrix,
    canonicalize_coo,
    stable_argsort,
)

Tensor = torch.Tensor


class HostCoo:
    """Host-side canonical COO triples for COLD paths (stats, min/max,
    densify): one-shot per job, so they run in numpy instead of keeping a
    device COO copy alive.  Results come back as tensors on ``device``."""

    __slots__ = ("rows", "cols", "vals", "n_rows", "n_cols", "device")

    def __init__(self, rows, cols, vals, n_rows, n_cols, device):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.device = device

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def _live(self, row_mask):
        live = self.vals != 0
        if row_mask is not None:
            live &= to_numpy(row_mask)[self.rows]
        return live

    def col_nnz(self, row_mask=None) -> Tensor:
        live = self._live(row_mask)
        counts = np.bincount(self.cols[live], minlength=self.n_cols)
        return torch.as_tensor(counts.astype(np.int32), device=self.device)

    def col_min_max(self, row_mask=None):
        """Per-feature (min, max) over stored entries of live rows, folded
        with the implicit zeros of unstored entries."""
        live = self._live(row_mask)
        c = self.cols[live]
        v = self.vals[live]
        mins = np.full(self.n_cols, np.inf, np.float32)
        maxs = np.full(self.n_cols, -np.inf, np.float32)
        np.minimum.at(mins, c, v)
        np.maximum.at(maxs, c, v)
        nnz = np.bincount(c, minlength=self.n_cols)
        n_live_rows = (
            self.n_rows if row_mask is None
            else int(np.sum(to_numpy(row_mask)))
        )
        has_zero = nnz < n_live_rows
        mins = np.where(has_zero, np.minimum(mins, 0.0), mins)
        maxs = np.where(has_zero, np.maximum(maxs, 0.0), maxs)
        return (torch.as_tensor(mins.astype(np.float32), device=self.device),
                torch.as_tensor(maxs.astype(np.float32), device=self.device))

    def to_dense(self) -> DenseMatrix:
        dense = np.zeros((self.n_rows, self.n_cols), np.float32)
        np.add.at(dense, (self.rows, self.cols), self.vals)
        return DenseMatrix(torch.as_tensor(dense, device=self.device))


@dataclasses.dataclass
class CudaSparseMatrix:
    """Sparse feature matrix whose hot operations run in the CUDA kernel.

    ``f_*``: row-major CSR (matvec, row_sq_matvec), summed with
    ``row_group`` lanes a row; ``b_*``: the CSC copy (rmatvec, sq_rmatvec),
    summed over the row blocks of ``b_blockptr`` with ``col_group`` lanes a
    (column, row block) sub-range.  ``f_val``/``b_val`` are
    empty when ``unit_vals`` (binary layout).  Dense stripes keep their
    true values."""

    f_indptr: Tensor       # (n_rows + 1,) int64
    f_idx: Tensor          # (nnz_streamed,) int32 — column of each entry
    f_val: Tensor          # (nnz_streamed,) f32, or (0,) when unit_vals
    b_indptr: Tensor       # (n_cols + 1,) int64
    b_idx: Tensor          # (nnz_streamed,) int32 — row of each entry
    b_val: Tensor
    dense_cols: Tensor     # (kc, n_rows) f32 — column stripes, transposed
    dense_col_ids: Tensor  # (kc,) int64
    dense_rows: Tensor     # (kr, n_cols) f32
    dense_row_ids: Tensor  # (kr,) int64
    host_coo: Optional[HostCoo]  # None: a streamed chunk (no cold paths)
    n_rows: int
    n_cols: int
    b_blockptr: Tensor     # (n_cols, n_rb + 1) int64 — row_block_table
    row_group: int         # lanes a row of the row kernel (_kernels.GROUPS)
    col_group: int         # lanes a sub-range of the column kernel
    unit_vals: bool = False

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        """The canonical entry budget (``pad_nnz`` when one was given)."""
        return self._coo().nnz

    @property
    def device(self) -> torch.device:
        return self.f_indptr.device

    @property
    def has_dense_cols(self) -> bool:
        return self.dense_col_ids.shape[0] > 0

    @property
    def has_dense_rows(self) -> bool:
        return self.dense_row_ids.shape[0] > 0

    # -- hot paths ---------------------------------------------------------
    def _rows_side(self, v: Tensor, op: str, square: bool) -> Tensor:
        out = spmv_rows(self.f_indptr, self.f_idx, self.f_val, v.contiguous(),
                        group=self.row_group, n_in=self.n_cols, op=op,
                        unit=self.unit_vals, square=square)
        if self.has_dense_cols:
            dc = self.dense_cols * self.dense_cols if square else self.dense_cols
            out = out + ordered.rmatvec(dc, v[self.dense_col_ids])
        if self.has_dense_rows:
            dr = self.dense_rows * self.dense_rows if square else self.dense_rows
            ids = self.dense_row_ids
            out[ids] = out[ids] + ordered.matvec(dr, v)
        return out

    def _cols_side(self, u: Tensor, op: str, square: bool) -> Tensor:
        out = spmv_cols(self.b_blockptr, self.b_idx, self.b_val,
                        u.contiguous(), group=self.col_group,
                        n_in=self.n_rows, op=op, unit=self.unit_vals,
                        square=square)
        if self.has_dense_cols:
            dc = self.dense_cols * self.dense_cols if square else self.dense_cols
            ids = self.dense_col_ids
            out[ids] = out[ids] + ordered.matvec(dc, u)
        if self.has_dense_rows:
            dr = self.dense_rows * self.dense_rows if square else self.dense_rows
            out = out + ordered.rmatvec(dr, u[self.dense_row_ids])
        return out

    def matvec(self, w: Tensor) -> Tensor:
        return self._rows_side(w, "matvec", square=False)

    def rmatvec(self, u: Tensor) -> Tensor:
        return self._cols_side(u, "rmatvec", square=False)

    def row_sq_matvec(self, v: Tensor) -> Tensor:
        return self._rows_side(v, "row_sq_matvec", square=True)

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        return self._cols_side(u, "sq_rmatvec", square=True)

    # -- cold paths: host-side over the canonical triples ------------------
    def _coo(self) -> HostCoo:
        if self.host_coo is None:
            raise RuntimeError(
                "this matrix was built without its canonical triples (a "
                "streamed chunk): its cold paths (nnz, col_nnz, col_min_max, "
                "to_dense) need build_cuda_layout(..., keep_coo=True)"
            )
        return self.host_coo

    def col_nnz(self, row_mask=None) -> Tensor:
        return self._coo().col_nnz(row_mask)

    def col_min_max(self, row_mask=None):
        return self._coo().col_min_max(row_mask)

    def to_dense(self) -> DenseMatrix:
        return self._coo().to_dense()


def _extract_dense(counts, threshold, max_stripes, long_axis, budget_bytes):
    """Up to ``max_stripes`` indices whose entry count ≥ threshold, densest
    first, also capped so the stripes' dense storage (``long_axis × 4``
    bytes each) stays within ``budget_bytes``."""
    mem_cap = int(budget_bytes // max(long_axis * 4, 1))
    max_stripes = min(max_stripes, mem_cap)
    if max_stripes <= 0:
        return np.empty(0, np.int64)
    cand = np.flatnonzero(counts >= threshold)
    if cand.size > max_stripes:
        cand = cand[np.argsort(-counts[cand], kind="stable")[:max_stripes]]
        cand = np.sort(cand)
    return cand.astype(np.int64)


def _indptr(seg_ids: np.ndarray, n: int) -> np.ndarray:
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(seg_ids, minlength=n), out=indptr[1:])
    return indptr


def row_block_table(b_indptr: np.ndarray, b_idx: np.ndarray, n_rows: int,
                    block_rows: int = ROW_BLOCK) -> np.ndarray:
    """The column kernel's block table over a CSC layout whose rows ascend
    within each column: ``table[j, t]`` is the first entry of column j whose
    row is ``>= t·block_rows``, for t in ``[0, n_rb]`` with ``n_rb =
    ceil(n_rows / block_rows)`` (at least 1).  So ``table[j, 0] =
    b_indptr[j]``, ``table[j, n_rb] = b_indptr[j+1]``, and the entries of
    column j in row block t are ``[table[j, t], table[j, t+1])``.  Shape
    (n_cols, n_rb + 1), int64: one ``searchsorted`` over the entries' sorted
    (column, row block) keys."""
    b_indptr = np.asarray(b_indptr, np.int64)
    n_cols = b_indptr.shape[0] - 1
    n_rb = n_row_blocks(int(n_rows), block_rows)
    keys = (np.repeat(np.arange(n_cols, dtype=np.int64) * n_rb,
                      np.diff(b_indptr))
            + np.asarray(b_idx, np.int64) // block_rows)
    queries = (np.arange(n_cols, dtype=np.int64)[:, None] * n_rb
               + np.arange(n_rb + 1, dtype=np.int64)[None, :])
    return np.searchsorted(keys, queries.ravel(), side="left").reshape(
        n_cols, n_rb + 1).astype(np.int64)


#: the tensors of :class:`CudaSparseMatrix`, as :class:`CudaLayout` names
#: its host arrays.
LAYOUT_FIELDS = ("f_indptr", "f_idx", "f_val", "b_indptr", "b_idx", "b_val",
                 "dense_cols", "dense_col_ids", "dense_rows", "dense_row_ids",
                 "b_blockptr")


@dataclasses.dataclass
class CudaLayout:
    """The host-side form of :class:`CudaSparseMatrix`: the same arrays as
    numpy (``arrays``, keyed by :data:`LAYOUT_FIELDS`) plus the metadata.
    The out-of-core store keeps chunks in this form until a pass moves
    them; :meth:`to_device` and :meth:`matrix` build the device matrix.
    ``coo`` holds the canonical triples for the cold paths, or None when
    the caller dropped them (a streamed chunk never needs them)."""

    arrays: dict
    n_rows: int
    n_cols: int
    row_group: int
    col_group: int
    unit_vals: bool
    coo: Optional[tuple] = None  # (rows, cols, vals) canonical triples

    def matrix(self, tensors: dict, device=None) -> CudaSparseMatrix:
        """The device matrix over ``tensors`` (this layout's arrays, already
        on a device, e.g. views into a chunk's transferred buffers)."""
        dev = tensors["f_indptr"].device if device is None else device
        host_coo = (None if self.coo is None
                    else HostCoo(*self.coo, self.n_rows, self.n_cols, dev))
        return CudaSparseMatrix(
            **{f: tensors[f] for f in LAYOUT_FIELDS}, host_coo=host_coo,
            n_rows=self.n_rows, n_cols=self.n_cols,
            row_group=self.row_group, col_group=self.col_group,
            unit_vals=self.unit_vals,
        )

    def to_device(self, device=None) -> CudaSparseMatrix:
        dev = resolve_device(device)
        return self.matrix({f: torch.as_tensor(a, device=dev)
                            for f, a in self.arrays.items()}, dev)


def build_cuda_layout(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    pad_nnz: Optional[int] = None,
    dense_frac: float = 1.0 / 32.0,
    max_dense: int = 64,
    dense_budget_bytes: int = 512 << 20,
    unit_values: bool | str = "auto",
    keep_coo: bool = True,
) -> CudaLayout:
    """Build the CSR/CSC layout from host COO triples, on the host.

    Canonicalize (sum duplicates, sort, pad/validate the nnz budget), drop
    zero-valued entries (padding included: ``nnz`` still reports the
    budget), extract dense stripes, then lay the rest out as CSR and CSC,
    with the CSC's row-block table and the kernels' lanes a segment (from
    the mean streamed row and sub-range lengths).  ``unit_values="auto"``
    drops the value stream when every streamed value is 1.0; ``True``
    forces it (and refuses non-unit values), ``False`` keeps the valued
    layout.  ``keep_coo=False`` drops the canonical triples (no cold
    paths)."""
    r_all, c_all, v_all = canonicalize_coo(rows, cols, vals, n_rows, n_cols,
                                           pad_nnz)
    v_all = v_all.astype(np.float32)
    # Zero-valued entries contribute nothing; dropping them keeps explicit
    # zeros (and nnz padding) out of the segments, so a non-finite vector
    # entry reaches only the outputs that really store its index.
    live = np.flatnonzero(v_all != 0)
    r, c, v = r_all[live], c_all[live], v_all[live]

    # --- dense stripes (columns first, rows from the rest) ----------------
    dense_col_ids = _extract_dense(
        np.bincount(c, minlength=n_cols),
        max(256, int(n_rows * dense_frac)), max_dense,
        n_rows, dense_budget_bytes,
    )
    dense_cols = np.zeros((len(dense_col_ids), n_rows), np.float32)
    if dense_col_ids.size:
        in_dc = np.isin(c, dense_col_ids)
        pos = np.searchsorted(dense_col_ids, c[in_dc])
        dense_cols[pos, r[in_dc]] = v[in_dc]
        r, c, v = r[~in_dc], c[~in_dc], v[~in_dc]

    dense_row_ids = _extract_dense(
        np.bincount(r, minlength=n_rows),
        max(256, int(n_cols * dense_frac)), max_dense,
        n_cols, dense_budget_bytes,
    )
    dense_rows = np.zeros((len(dense_row_ids), n_cols), np.float32)
    if dense_row_ids.size:
        in_dr = np.isin(r, dense_row_ids)
        pos = np.searchsorted(dense_row_ids, r[in_dr])
        dense_rows[pos, c[in_dr]] = v[in_dr]
        r, c, v = r[~in_dr], c[~in_dr], v[~in_dr]

    # --- value-free layout for binary matrices ----------------------------
    all_unit = v.size == 0 or bool(np.all(v == 1.0))
    if unit_values is True and not all_unit:
        raise ValueError("unit_values=True but streamed values are not all 1.0")
    unit = unit_values is True or (unit_values == "auto" and all_unit)

    # --- CSR (entries are already (row, col)-sorted) and CSC --------------
    f_indptr = _indptr(r, n_rows)
    order = stable_argsort(c, n_cols)  # rows stay ascending per column
    b_indptr = _indptr(c, n_cols)
    b_idx = r[order]
    b_val = v[order]
    b_blockptr = row_block_table(b_indptr, b_idx, n_rows)

    def a(x, dt=None):
        return np.ascontiguousarray(x, dt)

    empty = np.zeros(0, np.float32)
    arrays = dict(
        f_indptr=a(f_indptr), f_idx=a(c, np.int32),
        f_val=a(empty if unit else v, np.float32),
        b_indptr=a(b_indptr), b_idx=a(b_idx, np.int32),
        b_val=a(empty if unit else b_val, np.float32),
        dense_cols=a(dense_cols), dense_col_ids=a(dense_col_ids, np.int64),
        dense_rows=a(dense_rows), dense_row_ids=a(dense_row_ids, np.int64),
        b_blockptr=a(b_blockptr),
    )
    return CudaLayout(
        arrays=arrays, n_rows=int(n_rows), n_cols=int(n_cols),
        row_group=row_group(r.size, n_rows),
        col_group=col_group(np.diff(b_blockptr, axis=1)),
        unit_vals=unit, coo=(r_all, c_all, v_all) if keep_coo else None,
    )


def build_cuda_matrix(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    pad_nnz: Optional[int] = None,
    dtype=torch.float32,
    dense_frac: float = 1.0 / 32.0,
    max_dense: int = 64,
    dense_budget_bytes: int = 512 << 20,
    unit_values: bool | str = "auto",
    device=None,
) -> CudaSparseMatrix:
    """:func:`build_cuda_layout` on the host, then its arrays on
    ``device`` (CUDA by default)."""
    if dtype != torch.float32:
        raise ValueError(f"the CUDA SpMV kernel is float32-only, got {dtype}")
    dev = resolve_device(device)
    return build_cuda_layout(
        rows, cols, vals, n_rows, n_cols, pad_nnz=pad_nnz,
        dense_frac=dense_frac, max_dense=max_dense,
        dense_budget_bytes=dense_budget_bytes, unit_values=unit_values,
    ).to_device(dev)


def from_scipy_csr_cuda(csr, pad_nnz: Optional[int] = None,
                        dtype=torch.float32, device=None,
                        **kwargs) -> CudaSparseMatrix:
    csr = csr.tocsr()
    csr.sum_duplicates()
    coo = csr.tocoo()
    return build_cuda_matrix(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
        csr.shape[0], csr.shape[1], pad_nnz=pad_nnz, dtype=dtype,
        device=device, **kwargs,
    )
