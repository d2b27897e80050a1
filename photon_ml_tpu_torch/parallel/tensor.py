"""Feature-dim (tensor) parallelism for wide fixed-effect GLMs (port of
``photon_ml_tpu/parallel/tensor.py``).

At very wide feature counts a replicated ``w`` and the L-BFGS ``(m, d)``
history no longer fit beside the data, so both are sharded over a second
axis of a (data × feature) grid:

- the grid is ``dp`` row blocks × ``tp`` column slices; tile ``(i, j)``
  holds rows ``i·rows_per …`` and columns ``j·cols_per …`` of X with LOCAL
  row and column ids — on the card its own kernel layout
  (``ops/sparse_cuda.py``), so the SpMV kernels run on every tile — and
  the column slice ``j`` of ``w`` and of every history vector;
- margins: the tile's ``matvec``, then a sum over the FEATURE axis (a row
  block's margins need every column slice);
- the loss derivatives depend only on margins, so they are replicated
  within a feature group; the tile's ``rmatvec``, then a sum over the DATA
  axis, gives the gradient slice of the tile's columns — the gradient is
  born sharded like ``w``, and ``w`` is never all-gathered during a solve;
- the solvers run on the sharded state: every w-space inner product and
  norm sums per-slice partials (``optim/linesearch.py::WSpace``, the
  reference's ``w_axis``), so an iteration is the single-device one.
  Each partial is an ``ops/ordered.py`` dot: a logical slice is a view
  of the whole ``w`` where a rank's is its own allocation, and the host
  BLAS's bits may depend on that.

Two forms, as ``parallel/distributed.py`` has:

- LOGICAL tiles (``dp_tp_mesh(dp, tp)``): one process holds all ``dp·tp``
  tiles and ``w`` whole; the slices are views, and partials are added in
  tile order;
- a ``torch.distributed`` group of ``dp·tp`` ranks
  (``dp_tp_mesh(dp, tp, distributed=True)``): rank ``i·tp + j`` holds tile
  ``(i, j)`` and slice ``j``; the feature and data subgroups come from
  ``new_group``.  Every sum is an all-gather whose parts are added in rank
  order (``DataGroup.gather_sum``) — the order the logical tiles add in —
  so a group gives the bits of its logical tiles.

A grid of one slice (``tp == 1``) passes no hook: its inner products are
the plain ones, and ``dp = tp = 1`` is bitwise the resident solve.

Per evaluation the wire cost is one (rows/dp)-length sum over the feature
axis and one fused value/gradient-slice sum over the data axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.dataset import GlmData, make_glm_data
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.ops.sparse import DenseMatrix
from photon_ml_tpu_torch.optim.lbfgs import (
    LBFGSConfig,
    SolveResult,
    lbfgs_solve,
)
from photon_ml_tpu_torch.optim.objective import GlmObjective
from photon_ml_tpu_torch.optim.owlqn import OWLQNConfig, owlqn_solve
from photon_ml_tpu_torch.optim.tron import TRONConfig, tron_solve
from photon_ml_tpu_torch.parallel.distributed import DataGroup

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """A (data=dp, feature=tp) grid.  ``rank`` None: logical tiles, all
    held here.  Otherwise this process is group rank ``rank = i·tp + j``
    (the feature axis is the minor one, as in the reference), ``feature``
    its row block's group (tp ranks, group rank j) and ``data`` its column
    slice's group (dp ranks, group rank i)."""

    dp: int
    tp: int
    rank: Optional[int] = None
    feature: Optional[DataGroup] = None
    data: Optional[DataGroup] = None

    @property
    def logical(self) -> bool:
        return self.rank is None

    @property
    def held(self) -> list[tuple[int, int]]:
        """The tiles this process holds, in tile order."""
        if self.logical:
            return [(i, j) for i in range(self.dp) for j in range(self.tp)]
        return [divmod(self.rank, self.tp)]


def dp_tp_mesh(dp: int, tp: int, distributed: bool = False) -> TileMesh:
    """A (data=dp, feature=tp) grid: logical tiles, or with
    ``distributed=True`` the default process group (of exactly ``dp·tp``
    ranks) cut into its feature and data subgroups.  Every rank must call
    this, in the same order, since ``new_group`` is collective."""
    if dp < 1 or tp < 1:
        raise ValueError(f"dp and tp must be >= 1, got dp={dp}, tp={tp}")
    if not distributed:
        return TileMesh(dp, tp)
    import torch.distributed as dist

    world = dist.get_world_size()
    if world != dp * tp:
        raise ValueError(f"a {dp}x{tp} grid needs {dp * tp} ranks, the "
                         f"group has {world}")
    feature = [dist.new_group([i * tp + j for j in range(tp)])
               for i in range(dp)]
    data = [dist.new_group([i * tp + j for i in range(dp)])
            for j in range(tp)]
    rank = dist.get_rank()
    i, j = divmod(rank, tp)
    return TileMesh(dp, tp, rank=rank, feature=DataGroup(feature[i]),
                    data=DataGroup(data[j]))


def _ceil_to(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


@dataclasses.dataclass
class TiledGlmData:
    """The held tiles of one GLM dataset: ``tiles[(i, j)]`` is a
    :class:`GlmData` of ``rows_per`` rows × ``cols_per`` columns whose
    labels, weights and offsets are row block i's.  ``d`` is the original
    feature count (strip the padding with ``w[:d]``)."""

    tiles: dict
    dp: int
    tp: int
    rows_per: int
    cols_per: int
    d: int

    @property
    def padded_width(self) -> int:
        return self.tp * self.cols_per

    @property
    def device(self) -> torch.device:
        return next(iter(self.tiles.values())).device


def shard_glm_data_dp_tp(
    X_host,
    labels,
    mesh: TileMesh,
    weights=None,
    offsets=None,
    dtype=torch.float32,
    use_kernel: bool | str = "auto",
    device=None,
) -> TiledGlmData:
    """Tile host data (a numpy 2-D array or a scipy sparse matrix) over the
    grid.  Rows pad (weight 0, label 0, offset 0) to a multiple of dp,
    columns (all-zero) to a multiple of tp; only the held tiles are built.
    A sparse tile is the kernel-backed CSR/CSC matrix on a CUDA device
    (``use_kernel``, as in :func:`make_glm_data`); the COO fallback pads
    every tile's nnz to the largest tile's, as the reference does."""
    import scipy.sparse as sp

    dev = resolve_device(device)
    dp, tp = mesh.dp, mesh.tp
    n, d = X_host.shape
    rows_per = _ceil_to(n, dp) // dp
    cols_per = _ceil_to(d, tp) // tp

    def padded(a, fill):
        a = np.full(n, fill, np.float32) if a is None else np.asarray(
            a, np.float32)
        return np.concatenate([a, np.zeros(dp * rows_per - n, np.float32)])

    y, wt, off = padded(labels, 0.0), padded(weights, 1.0), padded(
        offsets, 0.0)
    held = mesh.held

    def rows(a, i):
        return a[i * rows_per:(i + 1) * rows_per]

    tiles = {}
    if sp.issparse(X_host):
        csr = X_host.tocsr().astype(np.float32)
        csr.sum_duplicates()
        csr.resize((n, tp * cols_per))
        if use_kernel == "auto":
            use_kernel = dev.type == "cuda"
        budget = None
        if not use_kernel:
            # The largest tile's nnz (the reference's uniform shapes),
            # counted over every tile so each form pads alike.
            budget = 1
            for i in range(dp):
                block = csr[min(i * rows_per, n):min((i + 1) * rows_per, n)]
                counts = np.bincount(block.indices // cols_per,
                                     minlength=tp)
                budget = max(budget, int(counts.max(initial=0)))
        for i, j in held:
            lo, hi = min(i * rows_per, n), min((i + 1) * rows_per, n)
            tile = csr[lo:hi, j * cols_per:(j + 1) * cols_per]
            tiles[(i, j)] = make_glm_data(
                tile, rows(y, i)[:hi - lo], rows(wt, i)[:hi - lo],
                rows(off, i)[:hi - lo], pad_rows=rows_per, pad_nnz=budget,
                dtype=dtype, use_kernel=use_kernel, device=dev)
    else:
        dense = np.zeros((dp * rows_per, tp * cols_per), np.float32)
        dense[:n, :d] = np.asarray(X_host, np.float32)
        for i, j in held:
            block = np.ascontiguousarray(
                rows(dense, i)[:, j * cols_per:(j + 1) * cols_per])

            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), device=dev)

            tiles[(i, j)] = GlmData(
                features=DenseMatrix(t(block).to(dtype)),
                labels=t(rows(y, i)), weights=t(rows(wt, i)),
                offsets=t(rows(off, i)))
    return TiledGlmData(tiles=tiles, dp=dp, tp=tp, rows_per=rows_per,
                        cols_per=cols_per, d=d)


def _ordered_sum(parts: list) -> Tensor:
    tot = parts[0]
    for p in parts[1:]:
        tot = tot + p
    return tot


class _SliceSpace:
    """w-space of logical tiles: ``w`` whole, slice j its columns
    ``j·c …``; an inner product adds the slices' ordered partials in
    slice order."""

    def __init__(self, tp: int, cols_per: int):
        self.tp, self.c = tp, cols_per

    def dot(self, a: Tensor, b: Tensor) -> Tensor:
        c = self.c
        return _ordered_sum([ordered.dot(a[j * c:(j + 1) * c],
                                       b[j * c:(j + 1) * c])
                             for j in range(self.tp)])

    def norm(self, a: Tensor) -> Tensor:
        return ordered.sqrt(self.dot(a, a))


class _GroupSpace:
    """w-space of a group rank: ``w`` is this rank's slice; an inner
    product gathers the feature group's partials and adds them in rank
    order (the slice order)."""

    def __init__(self, feature: DataGroup):
        self.feature = feature

    def dot(self, a: Tensor, b: Tensor) -> Tensor:
        return self.feature.gather_sum(ordered.dot(a, b).reshape(1))[0]

    def norm(self, a: Tensor) -> Tensor:
        return ordered.sqrt(self.dot(a, a))


class TileObjective:
    """The sharded smooth GLM objective every TP solver shares (the
    reference's ``_smooth_vg`` and TRON's ``d2f``/``hvp``).  Coefficient
    vectors are whole (logical tiles) or this rank's slice (a group)."""

    def __init__(self, objective: GlmObjective, data: TiledGlmData,
                 mesh: TileMesh):
        if objective.normalization is not None:
            raise ValueError("tensor-parallel solves take no normalization")
        if (data.dp, data.tp) != (mesh.dp, mesh.tp):
            raise ValueError(f"data tiled {data.dp}x{data.tp}, grid "
                             f"{mesh.dp}x{mesh.tp}")
        if set(data.tiles) != set(mesh.held):
            raise ValueError("the data's tiles are not the grid's held "
                             "tiles")
        self.obj, self.data, self.mesh = objective, data, mesh
        self.rows_held = sorted({i for i, _ in mesh.held})
        self.cols_held = sorted({j for _, j in mesh.held})
        if mesh.tp == 1:
            self.w_space = None
        elif mesh.logical:
            self.w_space = _SliceSpace(mesh.tp, data.cols_per)
        else:
            self.w_space = _GroupSpace(mesh.feature)

    # -- slices ------------------------------------------------------------
    def local(self, w_full: Tensor) -> Tensor:
        """The part of a whole (padded-width) vector this process holds."""
        if self.mesh.logical:
            return w_full
        c, (j,) = self.data.cols_per, self.cols_held
        return w_full[j * c:(j + 1) * c].clone()

    def whole(self, w: Tensor) -> Tensor:
        """A whole vector from the held part (a group gathers the feature
        group's slices in slice order)."""
        if self.mesh.logical:
            return w
        return self.mesh.feature.all_gather(w).reshape(-1)

    def _slices(self, w: Tensor) -> dict:
        if not self.mesh.logical:
            return {self.cols_held[0]: w}
        c = self.data.cols_per
        return {j: w[j * c:(j + 1) * c] for j in range(self.mesh.tp)}

    # -- the two reductions -------------------------------------------------
    def _feature_sum(self, parts: list) -> Tensor:
        if self.mesh.logical:
            return _ordered_sum(parts)
        return self.mesh.feature.gather_sum(parts[0])

    def _data_sum(self, parts: list) -> Tensor:
        if self.mesh.logical:
            return _ordered_sum(parts)
        return self.mesh.data.gather_sum(parts[0])

    def _matvec(self, w: Tensor) -> dict:
        """Row block i → Σ_j X_ij w_j (no offsets)."""
        ws = self._slices(w)
        return {i: self._feature_sum([
                    self.data.tiles[(i, j)].features.matvec(ws[j])
                    for j in self.cols_held])
                for i in self.rows_held}

    def _rmatvec_fused(self, per_row: dict, lead: Optional[dict] = None
                       ) -> tuple:
        """Column slice j → Σ_i X_ijᵀ u_i, with each row block's scalar
        ``lead[i]`` (its value term) summed over the data axis in the same
        buffer.  Returns (lead sum or None, {j: slice})."""
        out_lead, out = None, {}
        for j in self.cols_held:
            parts = []
            for i in self.rows_held:
                g = self.data.tiles[(i, j)].features.rmatvec(per_row[i])
                if lead is not None:
                    dtype = torch.promote_types(lead[i].dtype, g.dtype)
                    g = torch.cat([lead[i].reshape(1).to(dtype), g.to(dtype)])
                parts.append(g)
            tot = self._data_sum(parts)
            if lead is not None:
                out_lead = tot[0].to(lead[self.rows_held[0]].dtype)
                tot = tot[1:].to(per_row[self.rows_held[0]].dtype)
            out[j] = tot
        return out_lead, out

    def _join(self, slices: dict) -> Tensor:
        if len(slices) == 1:
            return next(iter(slices.values()))
        return torch.cat([slices[j] for j in sorted(slices)])

    # -- objective ----------------------------------------------------------
    def margins(self, w: Tensor) -> dict:
        return {i: m + self.data.tiles[(i, self.cols_held[0])].offsets
                for i, m in self._matvec(w).items()}

    def value_and_grad(self, w: Tensor, l2: float):
        obj, loss = self.obj, self.obj.loss
        vals, us = {}, {}
        for i, m in self.margins(w).items():
            t = self.data.tiles[(i, self.cols_held[0])]
            vals[i] = obj._wsum(t.weights, loss.value(m, t.labels))
            us[i] = t.weights * loss.d1(m, t.labels)
        val, g = self._rmatvec_fused(us, vals)
        dot = ordered.dot if self.w_space is None else self.w_space.dot
        return val + 0.5 * l2 * dot(w, w), self._join(g) + l2 * w

    def d2_weights(self, w: Tensor) -> dict:
        loss = self.obj.loss
        out = {}
        for i, m in self.margins(w).items():
            t = self.data.tiles[(i, self.cols_held[0])]
            out[i] = t.weights * loss.d2(m, t.labels)
        return out

    def hvp(self, v: Tensor, d2w: dict, l2: float) -> Tensor:
        dm = self._matvec(v)
        _, h = self._rmatvec_fused({i: d2w[i] * dm[i] for i in dm})
        return self._join(h) + l2 * v

    def result(self, res: SolveResult) -> SolveResult:
        """The solve's result with whole ``w`` and ``grad``."""
        return res._replace(w=self.whole(res.w), grad=self.whole(res.grad))


def _setup(task, data, mesh, w0, accumulate):
    obj = GlmObjective(losses_lib.get(task), accumulate=accumulate)
    tobj = TileObjective(obj, data, mesh)
    if w0 is None:
        w0 = torch.zeros(data.padded_width, dtype=torch.float32,
                         device=data.device)
    if w0.shape[0] != data.padded_width:
        raise ValueError(f"w0 has {w0.shape[0]} entries, the padded width "
                         f"is {data.padded_width}")
    return tobj, tobj.local(w0)


def _f32(x) -> float:
    """λ as the reference hands it to the solve: a float32 scalar."""
    return float(np.float32(x))


def tp_lbfgs_solve(
    task: str,
    data: TiledGlmData,
    mesh: TileMesh,
    reg_weight: float = 0.0,
    w0: Optional[Tensor] = None,
    config: LBFGSConfig = LBFGSConfig(),
    accumulate: str = "f32",
) -> SolveResult:
    """Fit an L2 GLM with rows sharded over DATA and features over FEATURE.
    ``data`` comes from :func:`shard_glm_data_dp_tp`; ``w0`` and the
    result's ``w`` have the padded width (slice ``w[:d]``)."""
    tobj, w0l = _setup(task, data, mesh, w0, accumulate)
    l2 = _f32(reg_weight)
    return tobj.result(lbfgs_solve(
        lambda w: tobj.value_and_grad(w, l2), w0l, config,
        w_space=tobj.w_space))


def tp_owlqn_solve(
    task: str,
    data: TiledGlmData,
    mesh: TileMesh,
    l1_weight: float,
    l2_weight: float = 0.0,
    w0: Optional[Tensor] = None,
    config: OWLQNConfig = OWLQNConfig(),
    l1_mask=None,
    accumulate: str = "f32",
) -> SolveResult:
    """L1/elastic-net fit with w, the history AND the orthant state
    sharded.  ``l1_mask`` (padded width) exempts columns (the intercept)
    from the penalty."""
    tobj, w0l = _setup(task, data, mesh, w0, accumulate)
    l2 = _f32(l2_weight)
    mask = None
    if l1_mask is not None:
        mask = torch.as_tensor(np.asarray(l1_mask, np.float32),
                               device=data.device)
        if mask.shape[0] != data.padded_width:
            raise ValueError("l1_mask must have the padded width "
                             f"{data.padded_width}")
        mask = tobj.local(mask)
    return tobj.result(owlqn_solve(
        lambda w: tobj.value_and_grad(w, l2), w0l, _f32(l1_weight), config,
        l1_mask=mask, w_space=tobj.w_space))


def tp_tron_solve(
    task: str,
    data: TiledGlmData,
    mesh: TileMesh,
    reg_weight: float = 0.0,
    w0: Optional[Tensor] = None,
    config: TRONConfig = TRONConfig(),
    accumulate: str = "f32",
) -> SolveResult:
    """Trust-region Newton fit with rows sharded over DATA and features
    over FEATURE (L2 only, like the single-device TRON); each CG step's
    HVP is one feature-axis sum of tile matvecs and one data-axis sum of
    tile rmatvecs."""
    tobj, w0l = _setup(task, data, mesh, w0, accumulate)
    l2 = _f32(reg_weight)
    return tobj.result(tron_solve(
        lambda w: tobj.value_and_grad(w, l2),
        lambda w, v, aux: tobj.hvp(v, aux, l2), w0l, config,
        d2_fn=tobj.d2_weights, w_space=tobj.w_space))
