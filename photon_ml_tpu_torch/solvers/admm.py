"""Consensus-ADMM for L1/elastic-net GLMs — one all-reduce per outer
iteration (port of ``photon_ml_tpu/solvers/admm.py``).

Consensus ADMM (Boyd et al. §7.2) restructures the solve so that the only
communication across shards is ONE fixed-size reduction per OUTER
iteration, where L-BFGS/OWL-QN over a process group pay one per objective
evaluation:

- **x-update** (per shard, no communication): each shard s minimizes its
  local objective plus a proximal tie to the consensus,
  ``x_s = argmin f_s(x) + ρ/2·‖x − (z − u_s)‖²`` — a warm-started local
  L-BFGS for any GLM loss (``optim/lbfgs.py`` over the shard's objective,
  so the SpMV kernel runs on every shard), or for the linear task a
  CLOSED FORM through a cached eigendecomposition of the local Gram
  matrix: ``(G_s + ρI)x = b_s + ρv`` solves as
  ``Q((Qᵀ(b_s + ρv)) / (Λ + ρ))``, factorized once per dataset and reused
  by every outer iteration, every ρ change and every λ;
- **consensus z-update** (replicated): with the whole L1/L2 regularizer on
  z, one soft-threshold,
  ``z = S_{λ₁·mask/(λ₂+Nρ)}(ρ·Σ_s(x̂_s + u_s)/(λ₂+Nρ))``, where
  ``x̂ = α·x + (1−α)·z`` is the over-relaxed iterate (α ∈ [1, 1.8]);
- **dual update** (per shard): ``u_s += x̂_s − z``.

The reduction carries ``[Σ(x̂+u), Σx, ‖x‖², ‖u‖², f_s(x_s), iters]`` —
2d+4 floats, in the reference's order.  The primal residual follows from
``Σ‖x_s − z‖² = Σ‖x_s‖² − 2⟨Σx_s, z⟩ + N‖z‖²``, so residual stopping and
adaptive ρ (the μ/τ rule, the scaled dual rescaled when ρ changes) need
nothing beyond it.  A final exact evaluation (one more reduction) gives
the returned value and pseudo-gradient.

Shards are a process group (one per rank, the payload all-reduced) or
LOGICAL shards in one process: their x-updates run one after another, each
its own single ``lbfgs_solve`` (the reference's ``vmap`` of a
``while_loop`` freezes finished lanes, so each lane IS its single solve),
and their payloads are summed in shard order in place of the all-reduce.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.optim.lbfgs import (
    LBFGSConfig,
    SolveResult,
    lbfgs_solve,
)
from photon_ml_tpu_torch.optim.owlqn import _pseudo_gradient
from photon_ml_tpu_torch.parallel.distributed import sum_shards
from photon_ml_tpu_torch.solvers import registry

Tensor = torch.Tensor

_FALSE = ("false", "0", "no", "off")


def parse_bool(val) -> bool:
    """A knob's truth value: ``false``/``0``/``no``/``off`` (any case) are
    False.  The reference coerces with ``bool(val)``, which makes the
    CLI's ``adaptive_rho=false`` True; the port parses the string."""
    if isinstance(val, str):
        return val.strip().lower() not in _FALSE
    return bool(val)


@dataclasses.dataclass(frozen=True)
class ADMMOptions:
    """Knobs, settable via ``OptimizerConfig.solver_options``.

    ``max_outer`` of 0 defers to ``OptimizerConfig.max_iters``; likewise
    ``abstol`` of 0 defers to ``OptimizerConfig.tolerance``."""

    rho: float = 1.0  # initial penalty
    adaptive_rho: bool = True
    mu: float = 10.0  # residual-imbalance trigger (Boyd §3.4.1)
    tau: float = 2.0  # ρ scale factor on trigger
    over_relaxation: float = 1.5  # α ∈ [1.0, 1.8]
    abstol: float = 0.0
    reltol: float = 1e-4
    max_outer: int = 0
    local_solver: str = "auto"  # auto | lbfgs | ridge
    local_max_iters: int = 25  # L-BFGS subproblem budget
    local_tolerance: float = 1e-8
    shards: int = 0  # logical-shard count (0 = auto; sharded.py reads it)

    @classmethod
    def from_options(cls, options: dict) -> "ADMMOptions":
        fields = [f.name for f in dataclasses.fields(cls)]
        unknown = sorted(set(options) - set(fields))
        if unknown:
            raise ValueError(
                f"unknown admm solver_options {unknown}; valid: "
                f"{sorted(fields)}"
            )
        coerced = {}
        for key, val in options.items():
            if key == "local_solver":
                coerced[key] = str(val)
            elif key == "adaptive_rho":
                coerced[key] = parse_bool(val)
            elif key in ("max_outer", "local_max_iters", "shards"):
                coerced[key] = int(val)
            else:
                coerced[key] = float(val)
        opts = cls(**coerced)
        if opts.local_solver not in ("auto", "lbfgs", "ridge"):
            raise ValueError(
                f"admm local_solver must be auto|lbfgs|ridge, got "
                f"{opts.local_solver!r}"
            )
        if not 1.0 <= opts.over_relaxation <= 1.8:
            raise ValueError(
                "admm over_relaxation must lie in [1.0, 1.8] "
                f"(got {opts.over_relaxation})"
            )
        return opts


def _soft_threshold(t: Tensor, thresh: Tensor) -> Tensor:
    return torch.sign(t) * torch.clamp(t.abs() - thresh, min=0.0)


def shard_values_and_grads(obj, dd, w, mesh):
    """Σ over the shards of the raw (unregularized) value and gradient at
    ``w``: one reduction of ``[value, grad]``."""
    parts = []
    for local in dd.shards:
        val, grad = obj.raw_value_and_grad(w, local)
        dt = torch.promote_types(val.dtype, grad.dtype)
        parts.append(torch.cat([val.reshape(1).to(dt), grad.to(dt)]))
    tot = sum_shards(parts, mesh)
    return tot[0], tot[1:].to(w.dtype)


def regularized(val, grad, w, l1, l2, mask):
    """The full objective's value and pseudo-gradient from the reduced data
    term (the reference's final exact evaluation)."""
    val = (val + l1 * torch.sum(w.abs() * mask)
           + 0.5 * l2 * ordered.dot(w, w))
    return val, _pseudo_gradient(w, grad + l2 * w, l1, mask)


def make_sharded_solver(problem, dist, mesh, l1_mask=None):
    """Registry ``sharded`` factory: bind (problem, sharded data, group)
    once, return ``solve_fn(lam, w_prev, dist_override=None) →
    SolveResult``.

    ``dist`` is a ``parallel.distributed.DistributedGlmData``; ``mesh`` is
    a ``DataGroup`` (this rank holds one shard) or None for logical shards.
    ``dist_override`` swaps the dataset (same shapes) per solve — the GAME
    fixed-effect coordinate re-slots its per-iteration offsets this way."""
    obj = problem.objective
    cfg = problem.config
    opt = cfg.optimizer
    opts = ADMMOptions.from_options(registry.solver_options_dict(opt))
    max_outer = opts.max_outer or opt.max_iters
    abstol = opts.abstol or opt.tolerance
    l1_frac = cfg.regularization.l1_weight(1.0)
    l2_frac = cfg.regularization.l2_weight(1.0)
    alpha = float(np.float32(opts.over_relaxation))

    n = dist.n_shards
    d = dist.n_features
    dev = dist.device
    mask = (torch.ones(d, dtype=torch.float32, device=dev) if l1_mask is None
            else torch.as_tensor(l1_mask, device=dev).to(torch.float32))
    use_ridge = opts.local_solver == "ridge" or (
        opts.local_solver == "auto" and problem.task == "squared"
    )
    if use_ridge and problem.task != "squared":
        raise ValueError(
            "admm local_solver='ridge' needs the linear (squared) task "
            "(the closed "
            f"form assumes a quadratic objective); task is {problem.task!r}"
        )
    local_cfg = LBFGSConfig(
        max_iters=opts.local_max_iters,
        tolerance=opts.local_tolerance,
        history=opt.history,
    )

    # -- per-shard pieces ---------------------------------------------------
    def x_update_lbfgs(local, x_prev, v, rho):
        def vg(w):
            val, g = obj.raw_value_and_grad(w, local)
            dw = w - v
            return val + 0.5 * rho * ordered.dot(dw, dw), g + rho * dw

        res = lbfgs_solve(vg, x_prev, local_cfg)
        dw = res.w - v
        f_loc = res.value - 0.5 * rho * ordered.dot(dw, dw)
        return res.w, float(res.iterations), f_loc

    def ridge_prep(local):
        """(Q, Λ, b, c) of the shard's quadratic ½xᵀGx − bᵀx + c: G from
        one Hessian-vector product a basis vector (the SpMV kernel on a
        sparse shard), then one symmetric eigendecomposition."""
        zero = torch.zeros(d, dtype=torch.float32, device=dev)
        c, g0 = obj.raw_value_and_grad(zero, local)
        d2w = obj.d2_weights(zero, local)
        gram = torch.empty((d, d), dtype=torch.float32, device=dev)
        e = torch.zeros(d, dtype=torch.float32, device=dev)
        for j in range(d):
            e[j] = 1.0
            gram[j] = obj.raw_hvp(zero, e, local, d2w)
            e[j] = 0.0
        evals, q = torch.linalg.eigh(gram)
        return q, evals, -g0, c

    def x_update_ridge(prep, v, rho):
        q, evals, b, c = prep
        x = q @ ((q.T @ (b + rho * v)) / (evals + rho))
        gx = q @ (evals * (q.T @ x))
        f_loc = 0.5 * torch.dot(x, gx) - torch.dot(b, x) + c
        return x, 1.0, f_loc

    def consensus(tot, z_prev, rho, l1, l2):
        """z-update + residuals from the reduced payload (replicated)."""
        p_sum, x_sum = tot[:d], tot[d: 2 * d]
        sum_x2, sum_u2 = tot[2 * d], tot[2 * d + 1]
        f_sum, iters_sum = tot[2 * d + 2], tot[2 * d + 3]
        denom = l2 + rho * n
        z = _soft_threshold(rho * p_sum / denom, (l1 / denom) * mask)
        r2 = torch.clamp(
            sum_x2 - 2.0 * ordered.dot(x_sum, z) + n * ordered.dot(z, z),
            min=0.0,
        )
        obj_proxy = (f_sum + l1 * torch.sum(z.abs() * mask)
                     + 0.5 * l2 * ordered.dot(z, z))
        stats = torch.stack([
            obj_proxy, r2, torch.linalg.vector_norm(z - z_prev), sum_x2,
            sum_u2, iters_sum, torch.linalg.vector_norm(z),
        ])
        return z, stats

    def step(dd, prep, x, u, z, rho, l1, l2):
        """One outer iteration: every held shard's x-update and payload,
        ONE reduction, the consensus and the dual update."""
        xs, xhs, payloads = [], [], []
        for s, local in enumerate(dd.shards):
            v = z - u[s]
            if use_ridge:
                x_new, iters, f_loc = x_update_ridge(prep[s], v, rho)
            else:
                x_new, iters, f_loc = x_update_lbfgs(local, x[s], v, rho)
            xh = alpha * x_new + (1.0 - alpha) * z
            scalars = torch.stack([
                ordered.dot(x_new, x_new), ordered.dot(u[s], u[s]),
                f_loc.to(torch.float32),
                torch.tensor(iters, dtype=torch.float32, device=dev),
            ])
            xs.append(x_new)
            xhs.append(xh)
            payloads.append(torch.cat([xh + u[s], x_new, scalars]))
        tot = sum_shards(payloads, mesh)
        z_new, stats = consensus(tot, z, rho, l1, l2)
        u_new = u + torch.stack(xhs) - z_new
        return torch.stack(xs), u_new, z_new, stats

    prep_cache: dict = {}

    def solve_fn(lam, w_prev, dist_override=None) -> SolveResult:
        dd = dist if dist_override is None else dist_override
        wt = np.float32
        l1 = float(wt(l1_frac) * wt(lam))
        l2 = float(wt(l2_frac) * wt(lam))
        prep = None
        if use_ridge:
            # The Gram factorization is cached for the BOUND dataset (it
            # survives every λ and every ρ); an override (GAME's offsets
            # shift b and c) factorizes its own data.
            if dist_override is None:
                prep = prep_cache.get("default")
                if prep is None:
                    prep = prep_cache["default"] = [
                        ridge_prep(s) for s in dist.shards]
            else:
                prep = [ridge_prep(s) for s in dd.shards]

        z = (torch.zeros(d, dtype=torch.float32, device=dev)
             if w_prev is None else
             torch.as_tensor(w_prev, device=dev).to(torch.float32))
        k_held = len(dd.shards)
        x = z.expand(k_held, d).clone()
        rho = float(wt(opts.rho))
        # Warm dual: at the consensus fixed point u*_s = -∇f_s(z*)/ρ
        # (x-update stationarity at x = z), so seeding the duals from the
        # shard-local gradients at z0 removes the cold-dual transient;
        # deterministic in (data, z0, ρ), so a resumed grid repeats bitwise.
        u = -torch.stack([obj.raw_value_and_grad(z, local)[1]
                          for local in dd.shards]) / rho
        values, rnorms = [], []
        rounds = 0
        converged = False
        r = float("inf")
        for k in range(max_outer):
            # The reduce seam: the step about to run carries this
            # iteration's reduction over the shards.
            chaos_mod.maybe_fail(
                "distributed.allreduce", solver="admm", outer=k
            )
            x, u, z_new, stats = step(dd, prep, x, u, z, rho, l1, l2)
            (obj_proxy, r2, dz, sum_x2, sum_u2, _iters,
             znorm) = stats.to(torch.float64).cpu().tolist()
            rounds = k + 1
            r = float(np.sqrt(r2))
            s = rho * float(np.sqrt(n)) * dz
            values.append(obj_proxy)
            rnorms.append(r)
            z = z_new
            # The consensus commit: z is adopted; a kill here loses only
            # the in-flight λ, which re-solves deterministically on resume.
            chaos_mod.maybe_fail(
                "admm.consensus", solver="admm", outer=k, rho=rho
            )
            eps_pri = (np.sqrt(n * d) * abstol
                       + opts.reltol * max(np.sqrt(sum_x2),
                                           np.sqrt(n) * znorm))
            eps_dual = (np.sqrt(n * d) * abstol
                        + opts.reltol * rho * np.sqrt(sum_u2))
            if r <= eps_pri and s <= eps_dual:
                converged = True
                break
            if opts.adaptive_rho:
                # μ/τ imbalance rule; the SCALED dual u = y/ρ rescales
                # inversely with ρ (Boyd §3.4.1).
                if r > opts.mu * s:
                    rho *= opts.tau
                    u = u / opts.tau
                elif s > opts.mu * r:
                    rho /= opts.tau
                    u = u * opts.tau

        val, grad = shard_values_and_grads(obj, dd, z, mesh)
        value, pg = regularized(val, grad, z, l1, l2, mask)
        tel = telemetry_mod.current()
        if tel.enabled:
            # Host numbers only: the rounds of the host loop and the
            # residual it already read back for its stopping test.
            tel.counter("solver_outer_iterations_total").inc(rounds)
            # One reduce per outer round + the final exact evaluation.
            tel.counter("solver_allreduce_count").inc(rounds + 1)
            tel.counter("solver_allreduce_bytes_total").inc(
                rounds * (2 * d + 4) * 4 + (d + 1) * 4)
            tel.gauge("solver_consensus_residual").set(r)
            tel.counter("solvers_sharded_solves_total").inc()
        return SolveResult(
            w=z,
            value=value,
            grad=pg,
            iterations=rounds,
            converged=converged,
            values=torch.tensor(values, dtype=torch.float32),
            grad_norms=torch.tensor(rnorms, dtype=torch.float32),
        )

    return solve_fn


registry.register(registry.SolverDef(
    name="admm",
    kind="host",
    description=(
        "consensus ADMM: per-shard subproblems + soft-threshold "
        "consensus, one all-reduce per outer iteration"
    ),
    supports_l1=True,
    sharded=make_sharded_solver,
))
