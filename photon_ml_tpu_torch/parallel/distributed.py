"""Data-parallel training over a process group (port of
``photon_ml_tpu/parallel/distributed.py``).

The reference shards rows across the devices of a JAX mesh and runs the
whole solver inside ``shard_map``, with ONE fused ``psum`` of
``(value, grad)`` per objective evaluation.  The port does the same over a
``torch.distributed`` process group, one rank per card:

- rows are split into equal contiguous blocks, padded with weight-0 rows
  (label 0, offset 0) so every rank holds the same ``rows_per``; each block
  is a shard-local matrix with LOCAL row ids — the port's kernel-backed
  CSR/CSC matrix on the card (``ops/sparse_cuda.py``), so the SpMV kernel
  runs on every shard, and a stacked dense tensor for dense inputs;
- coefficients are replicated: every rank runs the same solver loop;
- each objective evaluation makes one all-reduce of ``[value, grad]``
  fused into one buffer (TRON's Hessian-vector product one more), and every
  decision a solver takes reads only reduced values, so all ranks take the
  same branch.  With more than two ranks the backend's sum order is not
  fixed, so a group agrees with one device to rounding;
- a host-kind solver's round payload (a few d floats) is all-gathered and
  added in rank order instead, so a group of k ranks gives the bits of k
  logical shards.

``mesh=None`` builds LOGICAL shards: the same row blocks, all held by this
process, which the host-kind solvers (``solvers/admm.py``,
``solvers/block_cd.py``) solve one after another (ADMM) or batched over a
leading shard axis (block CD), with a sum over the shards in a fixed order
standing in for the all-reduce.

:data:`ALLREDUCES` counts every reduction of either kind (``count``, and
the ``bytes`` each moves), as ``ops/_kernels.LAUNCHES`` counts launches;
:data:`GATHERS` counts the all-gathers that move rows or lanes (no sum).

GAME's coordinates exchange their scores over the group so that every rank
holds each coordinate's full n-row score vector (the reference replicates
it over the mesh): a row-sharded fixed effect all-gathers its row blocks
(:meth:`DataGroup.gather_rows`), an entity-sharded random effect sums each
rank's scatter over the group (:meth:`DataGroup.sum_scores`).

gloo's ``all_gather`` takes CPU tensors only (its ``all_reduce`` and
``broadcast`` also take CUDA ones), so a gloo group whose ranks compute on
the card copies an all-gather's buffer through host memory explicitly;
:data:`HOST_STAGED` counts each such collective by name.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.dataset import GlmData, make_glm_data
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.sparse import DenseMatrix

Tensor = torch.Tensor

#: Reductions over shards: all-reduces over a process group and their
#: logical stand-ins (a sum over the shards one process holds).
ALLREDUCES: dict[str, int] = {"count": 0, "bytes": 0}

#: All-gathers over a process group that move rows, lanes or states.
GATHERS: dict[str, int] = {"count": 0, "bytes": 0}

#: Collectives copied through host memory (a gloo group on the card), by
#: collective name.
HOST_STAGED: dict[str, int] = {}


#: Guards the three tallies: fits of a tuning search run in threads.
_COUNT_LOCK = threading.Lock()


def reset_allreduces() -> None:
    with _COUNT_LOCK:
        for k in ALLREDUCES:
            ALLREDUCES[k] = 0
        for k in GATHERS:
            GATHERS[k] = 0
        HOST_STAGED.clear()


def _tally(table: dict, key: str, n: int) -> None:
    with _COUNT_LOCK:
        table[key] = table.get(key, 0) + n


def _count(buf: Tensor) -> None:
    _tally(ALLREDUCES, "count", 1)
    _tally(ALLREDUCES, "bytes", buf.numel() * buf.element_size())


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The port's data mesh: a ``torch.distributed`` process group whose
    ranks each hold one row block (``group=None`` is the default group)."""

    group: object = None

    @property
    def size(self) -> int:
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        import torch.distributed as dist

        return str(dist.get_backend(self.group))

    def all_reduce(self, buf: Tensor) -> Tensor:
        """Sum ``buf`` over the group in place (one collective)."""
        import torch.distributed as dist

        _count(buf)
        dist.all_reduce(buf, group=self.group)
        return buf

    def _all_gather(self, buf: Tensor) -> list:
        """Every rank's ``buf`` (same shape on every rank), in rank order,
        on ``buf``'s device; through host memory for a CUDA tensor on a
        gloo group (counted in :data:`HOST_STAGED`)."""
        import torch.distributed as dist

        src = buf.contiguous()
        staged = src.device.type == "cuda" and self.backend == "gloo"
        if staged:
            _tally(HOST_STAGED, "all_gather", 1)
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        if staged:
            parts = [p.to(buf.device) for p in parts]
        return parts

    def gather_sum(self, buf: Tensor) -> Tensor:
        """Sum ``buf`` over the group in rank order: one all-gather, then
        the ranks' buffers added in order on every rank — the order logical
        shards are added in, so both give the same bits at any group
        size."""
        _count(buf)
        parts = self._all_gather(buf)
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p
        return tot

    def all_gather(self, buf: Tensor) -> Tensor:
        """``(size, *buf.shape)``: every rank's ``buf`` stacked in rank
        order (one all-gather, counted in :data:`GATHERS`)."""
        _tally(GATHERS, "count", 1)
        _tally(GATHERS, "bytes",
               buf.numel() * buf.element_size() * self.size)
        return torch.stack(self._all_gather(buf))

    def gather_rows(self, block: Tensor, n_rows: int) -> Tensor:
        """A row-sharded coordinate's full score vector: every rank's row
        block (the same length on every rank, padding rows last)
        concatenated in rank order and cut to ``n_rows``.  A gather moves
        bits, so the result is exactly the rows' own scores."""
        return self.all_gather(block).reshape(-1)[:n_rows]

    def sum_scores(self, partial: Tensor) -> Tensor:
        """An entity-sharded coordinate's full score vector: each rank
        scattered its own lanes' scores into a zeroed vector, so every row
        is nonzero on at most one rank and the sum over the group (one
        all-reduce) gives each row its own score in any sum order — as
        exact as a rank-order sum.  The one exception is a score of -0.0,
        which comes back +0.0; the coordinates' scatters already write
        ``s + 0.0`` (the reference's ``zeros.at[rows].add(s)``), so no
        -0.0 reaches the sum and the bitwise tests hold as they are."""
        return self.all_reduce(partial)

    def reduce(self, *parts: Tensor) -> tuple[Tensor, ...]:
        """Sum every tensor of ``parts`` over the group in ONE all-reduce:
        they travel flattened in one buffer of their promoted dtype (a
        float32 gradient beside a float64 value goes as float64, exactly)
        and come back in their own dtypes and shapes."""
        dtype = parts[0].dtype
        for p in parts[1:]:
            dtype = torch.promote_types(dtype, p.dtype)
        buf = torch.cat([p.reshape(-1).to(dtype) for p in parts])
        self.all_reduce(buf)
        out, at = [], 0
        for p in parts:
            out.append(buf[at:at + p.numel()].reshape(p.shape).to(p.dtype))
            at += p.numel()
        return tuple(out)


def sum_shards(payloads: Sequence[Tensor], mesh: Optional[DataGroup]
               ) -> Tensor:
    """The reduction of a host-kind solver's round (a payload of a few d
    floats): the shards' payloads added in shard order — held here
    (logical shards) or gathered from the group's ranks — never with
    atomics, so a run repeats bitwise and a group of k ranks gives the
    bits of k logical shards."""
    if mesh is not None:
        if len(payloads) != 1:
            raise ValueError("a process-group rank holds one shard, got "
                             f"{len(payloads)} payloads")
        return mesh.gather_sum(payloads[0])
    tot = payloads[0]
    for p in payloads[1:]:
        tot = tot + p
    _count(tot)
    return tot


def _fuse(parts, dtype) -> Tensor:
    return torch.cat([p.reshape(-1).to(dtype) for p in parts])


def reduce_shards(per_shard: Sequence[Sequence[Tensor]],
                  mesh: Optional[DataGroup]) -> tuple:
    """The fused reduction of a streamed pass: ``per_shard[j]`` are the
    accumulators (value, gradient, ...) of the j-th held shard.  Each
    shard's tensors travel flattened in one buffer of their promoted dtype
    (as :meth:`DataGroup.reduce` sends them); the held shards' buffers are
    added in shard order, then summed over the group in ONE all-reduce.
    Logical shards (``mesh=None``) are one reduction counted, so a group of
    two ranks gives the bits of two logical shards.  Returns the reduced
    tensors in their own dtypes and shapes."""
    first = per_shard[0]
    dtype = first[0].dtype
    for p in first[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    buf = _fuse(first, dtype)
    for parts in per_shard[1:]:
        buf = buf + _fuse(parts, dtype)
    if mesh is not None:
        mesh.all_reduce(buf)
    else:
        _count(buf)
    out, at = [], 0
    for p in first:
        out.append(buf[at:at + p.numel()].reshape(p.shape).to(p.dtype))
        at += p.numel()
    return tuple(out)


@dataclasses.dataclass
class DistributedGlmData:
    """Row-block shards of one GLM dataset.

    ``shards`` are the blocks this process holds: all ``n_shards`` of them
    for logical shards, this rank's one under a process group.  Each is a
    :class:`GlmData` of ``rows_per`` rows with local row ids.  Dense
    shards are views of ``dense``, one ``(len(shards), rows_per, d)``
    tensor, so batched solvers read every shard at once."""

    shards: list
    n_shards: int
    dense: Optional[Tensor] = None

    @property
    def n_features(self) -> int:
        return self.shards[0].n_features

    @property
    def rows_per(self) -> int:
        return self.shards[0].n_rows

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def local(self) -> GlmData:
        """The one shard a process-group rank holds."""
        if len(self.shards) != 1:
            raise ValueError(f"{len(self.shards)} shards held here; local() "
                             "is the one shard of a process-group rank")
        return self.shards[0]

    def stacked(self, name: str) -> Tensor:
        """``labels``/``weights``/``offsets`` of the held shards as one
        ``(len(shards), rows_per)`` tensor."""
        return torch.stack([getattr(s, name) for s in self.shards])

    def with_offsets(self, offsets: Tensor) -> "DistributedGlmData":
        """The same shards with new ``(len(shards), rows_per)`` offsets."""
        shards = [dataclasses.replace(s, offsets=offsets[i])
                  for i, s in enumerate(self.shards)]
        return dataclasses.replace(self, shards=shards)


def _pad_rows_to(n_rows: int, n_shards: int) -> int:
    return ((n_rows + n_shards - 1) // n_shards) * n_shards


def stack_dense(X: Tensor, labels: Tensor, weights: Tensor,
                offsets: Tensor, n_shards: int) -> DistributedGlmData:
    """Dense shards as views of one ``(k, rows_per, d)`` tensor (``k``
    held shards; ``labels``/``weights``/``offsets`` are ``(k, rows_per)``)."""
    shards = [GlmData(features=DenseMatrix(X[i]), labels=labels[i],
                      weights=weights[i], offsets=offsets[i])
              for i in range(X.shape[0])]
    return DistributedGlmData(shards=shards, n_shards=n_shards, dense=X)


def shard_glm_data(
    data_host,
    labels,
    mesh: Optional[DataGroup],
    weights=None,
    offsets=None,
    dtype=torch.float32,
    n_shards: Optional[int] = None,
    use_kernel: bool | str = "auto",
    device=None,
) -> DistributedGlmData:
    """Row-block shards from host data (a numpy 2-D array or a scipy
    sparse matrix).

    Rows are padded (weight 0, label 0, offset 0) to a multiple of the
    shard count and split into contiguous blocks of ``rows_per`` rows, each
    a shard-local matrix with LOCAL row ids.  Under a process group
    (``mesh``) the shard count is the group's size and this rank builds
    only its own block; ``mesh=None`` builds ``n_shards`` LOGICAL shards.
    A sparse block is the kernel-backed CSR/CSC matrix on a CUDA device
    (``use_kernel``, as in :func:`make_glm_data`); the COO fallback pads
    every block's nnz to the largest block's, as the reference does.
    """
    import scipy.sparse as sp

    dev = resolve_device(device)
    if mesh is not None:
        n_shards = mesh.size
        held = [mesh.rank]
    elif n_shards is None or n_shards < 1:
        raise ValueError("shard_glm_data needs a mesh or n_shards >= 1")
    else:
        held = list(range(n_shards))
    n, d = data_host.shape
    total = _pad_rows_to(n, n_shards)
    rows_per = total // n_shards
    pad = total - n

    def padded(a, fill):
        a = np.full(n, fill, np.float32) if a is None else np.asarray(
            a, np.float32)
        return np.concatenate([a, np.zeros(pad, np.float32)])

    y, wt, off = padded(labels, 0.0), padded(weights, 1.0), padded(
        offsets, 0.0)

    if not sp.issparse(data_host):
        dense = np.concatenate([np.asarray(data_host, np.float32),
                                np.zeros((pad, d), np.float32)])

        def t(a, *shape):
            # Only the held blocks travel to the device.
            return torch.as_tensor(np.ascontiguousarray(
                a.reshape(n_shards, rows_per, *shape)[held]), device=dev)

        return stack_dense(t(dense, d).to(dtype), t(y), t(wt), t(off),
                           n_shards)

    csr = data_host.tocsr()
    csr.sum_duplicates()
    if use_kernel == "auto":
        use_kernel = dev.type == "cuda"
    budget = None
    if not use_kernel:
        # nnz budget: the largest block's, for the reference's uniform
        # shapes (the kernel layout needs none).
        budget = max(1, max(
            int(csr.indptr[min((i + 1) * rows_per, n)]
                - csr.indptr[min(i * rows_per, n)])
            for i in range(n_shards)))
    shards = []
    for i in held:
        lo, hi = min(i * rows_per, n), min((i + 1) * rows_per, n)
        rows = slice(i * rows_per, (i + 1) * rows_per)
        shards.append(make_glm_data(
            csr[lo:hi], y[rows][:hi - lo], wt[rows][:hi - lo],
            off[rows][:hi - lo], pad_rows=rows_per, pad_nnz=budget,
            dtype=dtype, use_kernel=use_kernel, device=dev))
    return DistributedGlmData(shards=shards, n_shards=n_shards)


def run_grid_distributed(
    problem,
    dist_data: DistributedGlmData,
    mesh: DataGroup,
    reg_weights,
    w0: Optional[Tensor] = None,
    l1_mask: Optional[Tensor] = None,
    warm_start: bool = True,
    solved: Optional[dict] = None,
    on_solved=None,
):
    """The λ-grid warm-start chain (``GlmOptimizationProblem.grid_loop``)
    over a process group: each rank solves its row block with every
    objective evaluation all-reduced once, so every rank returns the same
    models.  Coefficient variances, when configured, take one reduction
    of the squared columns a λ.

    Host-kind solvers (``OptimizerConfig.solver`` naming admm/block_cd)
    route to ``solvers.sharded.run_grid_sharded`` over the same group."""
    from photon_ml_tpu_torch.solvers import registry as solver_registry
    from photon_ml_tpu_torch.solvers import sharded as solvers_sharded

    cfg = problem.config
    defn = solver_registry.resolve(
        cfg.optimizer, l1_frac=cfg.regularization.l1_weight(1.0)
    )
    if defn.kind == "host":
        return solvers_sharded.run_grid_sharded(
            problem, dist_data, mesh, reg_weights, w0=w0, l1_mask=l1_mask,
            warm_start=warm_start, solved=solved, on_solved=on_solved,
        )
    local = dist_data.local()
    reduce = mesh.reduce

    def solve_fn(lam, w_prev):
        return problem.solve_single_device(local, lam, w_prev, l1_mask,
                                           reduce=reduce)

    variance_fn = None
    if cfg.compute_variances:
        def variance_fn(w, lam):
            return problem.coefficient_variances(w, local, lam,
                                                 reduce=reduce)

    return problem.grid_loop(solve_fn, reg_weights, w0, warm_start, solved,
                             on_solved, variance_fn, device=local.device)


def distributed_solve(
    solve_fn: Callable,
    dist_data: DistributedGlmData,
    w0: Tensor,
    mesh: DataGroup,
):
    """Run ``solve_fn(local_data, w0, reduce) -> SolveResult`` on this
    rank's shard; ``solve_fn`` passes ``reduce`` to its objective (see
    ``GlmObjective.value_and_grad``), so every rank returns the same
    result."""
    return solve_fn(dist_data.local(), w0, mesh.reduce)
