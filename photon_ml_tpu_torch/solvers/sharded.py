"""Grid runner and shard builders for host-kind solvers (port of
``photon_ml_tpu/solvers/sharded.py``).

Host-kind solvers (``SolverDef.kind == "host"``: consensus-ADMM, block CD)
run a host outer loop around per-shard subproblems and one fixed-size
reduction a round, so they cannot run inside ``problem.solve``.
:func:`run_grid_sharded` plugs a host-kind solver's ``sharded`` factory
into the SAME ``problem.grid_loop`` warm-start chain the other paths use,
with the same checkpoint and resume semantics.

Sharding comes in two flavours, chosen by the caller:

- a process group (``parallel.distributed.DataGroup``): each rank holds
  one row block and the round's reduction is one all-reduce;
- LOGICAL shards on one device (``mesh=None``): the same row blocks in one
  process (``shard_glm_data(..., mesh=None, n_shards=k)``), their
  payloads summed in shard order in place of the all-reduce, so the
  communication a round costs is measurable on one card and single-device
  callers (the GAME fixed-effect coordinate) still get ≥ 2 shards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from photon_ml_tpu_torch.ops.sparse import DenseMatrix
from photon_ml_tpu_torch.parallel.distributed import (
    DistributedGlmData,
    _pad_rows_to,
    stack_dense,
)
from photon_ml_tpu_torch.solvers import registry

Tensor = torch.Tensor


def resolve_shard_count(opt, mesh=None, default: int = 2) -> int:
    """The shard count for a host-kind solve: the group's size when one
    participates, else the solver_options ``shards`` knob, else
    ``default`` logical shards."""
    if mesh is not None:
        return mesh.size
    shards = int(registry.solver_options_dict(opt).get("shards", 0) or 0)
    return shards if shards > 0 else default


def stack_resident(data, n_shards: int) -> DistributedGlmData:
    """Device-resident GlmData → ``n_shards`` LOGICAL shards: rows padded
    (weight 0) to a multiple of the shard count, every tensor reshaped to
    a leading shard axis.  Dense features only — splitting a resident
    sparse matrix into row shards would rebuild its layout; build shards
    from host data (``shard_glm_data``) instead."""
    if not isinstance(data.features, DenseMatrix):
        raise ValueError(
            "logical sharding of device-resident data needs DenseMatrix "
            "features; build shards from host data (shard_glm_data) for "
            "sparse inputs"
        )
    rows = int(data.labels.shape[0])
    total = _pad_rows_to(rows, n_shards)
    rows_per = total // n_shards

    def pad_rows(a):
        widths = [0, 0] * (a.dim() - 1) + [0, total - rows]
        return torch.nn.functional.pad(a, widths).reshape(
            n_shards, rows_per, *a.shape[1:])

    return stack_dense(pad_rows(data.features.data), pad_rows(data.labels),
                       pad_rows(data.weights), pad_rows(data.offsets),
                       n_shards)


def _resolve_host(problem):
    cfg = problem.config
    return registry.resolve(
        cfg.optimizer, l1_frac=cfg.regularization.l1_weight(1.0))


def run_grid_sharded(
    problem,
    dist: DistributedGlmData,
    mesh,
    reg_weights: Sequence[float],
    w0: Optional[Tensor] = None,
    l1_mask: Optional[Tensor] = None,
    warm_start: bool = True,
    solved: Optional[dict] = None,
    on_solved=None,
):
    """The λ-grid warm-start chain for a host-kind solver over sharded
    data — the host-loop counterpart of
    ``parallel.distributed.run_grid_distributed``."""
    defn = _resolve_host(problem)
    if defn.kind != "host":
        raise ValueError(
            f"run_grid_sharded serves host-kind solvers; {defn.name!r} is "
            "jit-kind — use problem.run_grid / run_grid_distributed"
        )
    if problem.config.compute_variances:
        raise ValueError(
            f"compute_variances is not supported with solver "
            f"{defn.name!r}; drop the variance request or use a jit-kind "
            "solver"
        )
    solve = defn.sharded(problem, dist, mesh, l1_mask)
    return problem.grid_loop(
        lambda lam, w_prev: solve(lam, w_prev),
        reg_weights, w0, warm_start, solved, on_solved, None,
        device=dist.device,
    )


def make_fixed_effect_trainer(problem, data, n_shards: int, l1_mask=None):
    """A GAME fixed-effect trainer backed by a host-kind solver:
    ``trainer(offsets, w0, reg_weight) → coefficients``.

    The dataset shards once (logical, dense); each GAME outer iteration's
    residual offsets re-slot into the SAME shard layout."""
    template = stack_resident(data, n_shards)
    rows = int(data.labels.shape[0])
    rows_per = template.rows_per
    solve = _resolve_host(problem).sharded(problem, template, None, l1_mask)

    def trainer(offsets: Tensor, w0: Tensor, reg_weight: float) -> Tensor:
        off = torch.as_tensor(offsets, dtype=torch.float32,
                              device=template.device)
        off = torch.nn.functional.pad(off, (0, rows_per * n_shards - rows))
        dist_k = template.with_offsets(off.reshape(n_shards, rows_per))
        return solve(reg_weight, w0, dist_override=dist_k).w

    return trainer
