"""Distributed block coordinate descent — local CD sweeps, periodic sync
(port of ``photon_ml_tpu/solvers/block_cd.py``).

Workers run proximal-Newton coordinate updates against their LOCAL rows
and synchronize once a block round instead of once a step:

- the coordinates are split statically into ``n_blocks`` blocks; round k
  works block ``k mod n_blocks``;
- each round opens with ONE reduction of the active block's GLOBAL
  per-coordinate gradient and curvature at the round-start iterate
  (``[g_blk, h_blk, f]`` — 2·blk+1 floats);
- each shard then runs ``sweeps`` prox-Newton CD sweeps over the block
  against its OWN rows, with the DRIFT-CORRECTED gradient
  ``ĝ_j = g_j^glob(m₀) + (g_j^loc(m) − g_j^loc(m₀))`` — the global
  round-start gradient plus the shard's own drift since (maintained
  margins make each update O(rows)).  Naive local sweeps average to a
  biased fixed point; with the correction the update is zero exactly at
  GLOBAL prox-stationarity;
- a second reduction of the block's deltas closes the round (``blk``
  floats), applied as their shard average.

The port runs every held shard at once: the shards are a leading axis of
one ``(k, rows, d)`` tensor, with a transposed ``(k, d, rows)`` copy so a
column read is contiguous, and each coordinate step is one set of
launches for all shards.  Under a process group a rank holds one shard and
each reduction is one all-reduce; with logical shards the reductions sum
the shards in order.

Scope: per-shard column access needs DENSE features and no normalization
(the GLM driver densifies its design for this solver).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.optim.lbfgs import SolveResult
from photon_ml_tpu_torch.parallel.distributed import sum_shards
from photon_ml_tpu_torch.solvers import registry
from photon_ml_tpu_torch.solvers.admm import (
    regularized,
    shard_values_and_grads,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BlockCDOptions:
    """Knobs, settable via ``OptimizerConfig.solver_options``.

    ``max_rounds`` of 0 defers to ``OptimizerConfig.max_iters × n_blocks``
    (one configured "iteration" ≈ one full block cycle); ``tolerance`` of 0
    defers to ``OptimizerConfig.tolerance`` (relative objective change over
    one full cycle)."""

    n_blocks: int = 4
    sweeps: int = 2  # local CD sweeps over the active block per round
    max_rounds: int = 0
    tolerance: float = 0.0
    shards: int = 0  # logical-shard count (0 = auto; sharded.py reads it)

    @classmethod
    def from_options(cls, options: dict) -> "BlockCDOptions":
        fields = [f.name for f in dataclasses.fields(cls)]
        unknown = sorted(set(options) - set(fields))
        if unknown:
            raise ValueError(
                f"unknown block_cd solver_options {unknown}; valid: {fields}"
            )
        coerced = {
            k: (float(v) if k == "tolerance" else int(v))
            for k, v in options.items()
        }
        opts = cls(**coerced)
        if opts.n_blocks < 1 or opts.sweeps < 1:
            raise ValueError("block_cd n_blocks and sweeps must be >= 1")
        return opts


def make_sharded_solver(problem, dist, mesh, l1_mask=None):
    """Registry ``sharded`` factory (same contract as
    ``solvers.admm.make_sharded_solver``)."""
    if dist.dense is None:
        raise ValueError(
            "block_cd needs dense per-shard columns (DenseMatrix); densify "
            "the design matrix upstream (glm_driver does this for this "
            "solver) or use the 'admm' solver, whose matvec-based "
            "subproblems take sparse features"
        )
    if problem.normalization is not None:
        raise ValueError(
            "block_cd does not compose with feature normalization (its "
            "column updates read raw columns); drop --normalization or use "
            "'admm'"
        )
    obj = problem.objective
    loss = obj.loss
    cfg = problem.config
    opt = cfg.optimizer
    opts = BlockCDOptions.from_options(registry.solver_options_dict(opt))
    l1_frac = cfg.regularization.l1_weight(1.0)
    l2_frac = cfg.regularization.l2_weight(1.0)

    n = dist.n_shards
    d = dist.n_features
    dev = dist.device
    n_blocks = min(opts.n_blocks, d)
    max_rounds = opts.max_rounds or opt.max_iters * n_blocks
    tol = opts.tolerance or opt.tolerance
    mask = (torch.ones(d, dtype=torch.float32, device=dev) if l1_mask is None
            else torch.as_tensor(l1_mask, device=dev).to(torch.float32))
    # The static block partition of the reference (np.array_split).
    blocks = [torch.as_tensor(s.astype(np.int64), device=dev)
              for s in np.array_split(np.arange(d), n_blocks)]
    # The reference's reduce payload a round (telemetry only): first
    # [g_blk, h_blk, f], then the block delta, at the widest block.
    blk = -(-d // n_blocks)
    payload_bytes = (2 * blk + 1) * 4 + blk * 4
    X = dist.dense  # (k, rows, d); the features never change per solve
    XT = X.transpose(1, 2).contiguous()  # (k, d, rows): contiguous columns

    def block_round(dd, w, coords, l1, l2):
        """One block round: the first reduction, ``sweeps`` local passes
        over the block on every held shard, the second reduction and the
        synchronized iterate.  Returns (w_next, f_total at the round's
        start)."""
        y, wt, off = (dd.stacked(a) for a in ("labels", "weights",
                                              "offsets"))
        # Every product is a shard's own (an ordered mat-vec, or sums along
        # contiguous rows), so on the CPU a shard's numbers do not depend on
        # how many shards are batched beside it or where its rows sit; the
        # card's reduction kernels may split a batched sum another way.
        m = torch.stack([ordered.matvec(x, w) for x in X]) + off  # (k, rows)
        cols = XT[:, coords, :]  # (k, b, rows)
        u0 = (wt * loss.d1(m, y)).unsqueeze(1)
        g0 = (cols * u0).sum(-1)  # (k, b)
        h0 = (cols * cols * (wt * loss.d2(m, y)).unsqueeze(1)).sum(-1)
        f0 = torch.sum(wt * loss.value(m, y), dim=-1, keepdim=True)
        tot1 = sum_shards(list(torch.cat([g0, h0, f0], dim=-1)), mesh)
        b = coords.numel()
        g_glob, h_glob, f_sum = tot1[:b], tot1[b:2 * b], tot1[2 * b]

        w_blk0 = w[coords]
        w_blk = w_blk0.expand(len(dd.shards), b).clone()
        h = torch.clamp(h_glob + l2, min=1e-12)
        thr = l1 * mask[coords] / h
        for _ in range(opts.sweeps):
            for i in range(b):
                col = cols[:, i, :]
                wj = w_blk[:, i]
                g_live = (col * (wt * loss.d1(m, y))).sum(-1)
                ghat = g_glob[i] + (g_live - g0[:, i]) + l2 * wj
                zhat = wj - ghat / h[i]
                wj_new = torch.sign(zhat) * torch.clamp(
                    zhat.abs() - thr[i], min=0.0)
                m = torch.addcmul(m, col, (wj_new - wj).unsqueeze(-1))
                w_blk[:, i] = wj_new
        delta_sum = sum_shards(list(w_blk - w_blk0), mesh)
        upd = torch.zeros_like(w)
        upd[coords] = delta_sum / n
        f_total = (f_sum + l1 * torch.sum(w.abs() * mask)
                   + 0.5 * l2 * ordered.dot(w, w))
        return w + upd, f_total

    def solve_fn(lam, w_prev, dist_override=None) -> SolveResult:
        dd = dist if dist_override is None else dist_override
        wt32 = np.float32
        l1 = float(wt32(l1_frac) * wt32(lam))
        l2 = float(wt32(l2_frac) * wt32(lam))
        w = (torch.zeros(d, dtype=torch.float32, device=dev)
             if w_prev is None else
             torch.as_tensor(w_prev, device=dev).to(torch.float32))
        values = []
        rounds = 0
        converged = False
        for k in range(max_rounds):
            # The reduce seam: the round about to run carries its two
            # reductions over the shards.
            chaos_mod.maybe_fail(
                "distributed.allreduce", solver="block_cd", outer=k
            )
            w_new, f_total = block_round(dd, w, blocks[k % n_blocks], l1, l2)
            values.append(float(f_total))  # objective at round-START w
            w = w_new
            rounds = k + 1
            # Objective change over one full block cycle (every coordinate
            # visited once): one small block's change can be ~0 while the
            # other blocks still move.
            if k >= n_blocks:
                prev, cur = values[-1 - n_blocks], values[-1]
                if abs(prev - cur) <= tol * max(1.0, abs(cur)):
                    converged = True
                    break

        val, grad = shard_values_and_grads(obj, dd, w, mesh)
        value, pg = regularized(val, grad, w, l1, l2, mask)
        tel = telemetry_mod.current()
        if tel.enabled:
            tel.counter("solver_outer_iterations_total").inc(rounds)
            # Two fused reduces per round + the final exact evaluation.
            tel.counter("solver_allreduce_count").inc(2 * rounds + 1)
            tel.counter("solver_allreduce_bytes_total").inc(
                rounds * payload_bytes + (d + 1) * 4)
            tel.counter("solvers_sharded_solves_total").inc()
        return SolveResult(
            w=w,
            value=value,
            grad=pg,
            iterations=rounds,
            converged=converged,
            values=torch.tensor(values, dtype=torch.float32),
            grad_norms=torch.tensor(
                [abs(v) for v in np.diff(values)] or [0.0],
                dtype=torch.float32),
        )

    return solve_fn


registry.register(registry.SolverDef(
    name="block_cd",
    kind="host",
    description=(
        "distributed block coordinate descent: drift-corrected local "
        "prox-Newton CD sweeps + two all-reduces per block round"
    ),
    supports_l1=True,
    sharded=make_sharded_solver,
))
