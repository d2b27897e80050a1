"""Box-constrained solves: spectral projected gradient (port of
``photon_ml_tpu/optim/projected.py``).

The reference's optimizer layer supports box-constrained convex
optimization (per-coefficient bounds, the legacy ``Driver``'s constraint
map).  The solver is SPG (Birgin–Martínez–Raydan): each iteration is one
projection (a clamp), a Barzilai–Borwein step length and an Armijo
backtrack along the feasible segment ``w + λ·d`` with ``d = P(w − α·g) − w``
(the box is convex, so no trial needs re-projection).  Convergence is
measured by the projected-gradient norm ``‖P(w − g) − w‖``.

The reference runs it as one ``lax.while_loop``; the port runs a host loop
over device tensors, reading the trial value (and nothing else) once per
backtrack and the iteration's inner products once per iteration.  The
Armijo test is written ``not (ft <= bound)``, as the reference writes it, so
a NaN trial (an overflowing Poisson ``exp``) keeps backtracking.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.optim.lbfgs import SolveResult
from photon_ml_tpu_torch.optim.linesearch import (
    ValueAndGrad,
    host_scalars,
    np_dtype,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SPGConfig:
    max_iters: int = 100
    tolerance: float = 1e-7  # relative, on the projected-gradient norm
    alpha_min: float = 1e-10  # BB step clamp
    alpha_max: float = 1e10
    armijo_c: float = 1e-4
    max_backtracks: int = 30


def spg_solve(
    value_and_grad: ValueAndGrad,
    w0: Tensor,
    lower: Tensor,
    upper: Tensor,
    config: SPGConfig = SPGConfig(),
) -> SolveResult:
    """Minimize subject to ``lower <= w <= upper`` (±inf entries leave a
    coefficient unconstrained).  ``grad_norms`` tracks the projected-
    gradient norm.

    ``converged`` is True only when the projected-gradient norm met the
    tolerance.  An objective plateau (ftol) or a failed backtrack ends the
    loop with ``converged=False`` and ``stalled=True`` instead; a
    ``max_iters`` exit claims neither.

    The gradient's dtype is the carry's: the value is held in it too (an
    f32 ``w0`` against a float64-accumulated value keeps f32 iterates)."""
    f0, g0 = value_and_grad(torch.clamp(w0, lower, upper))
    dtype = g0.dtype
    wt = np_dtype(g0)
    lower = torch.as_tensor(lower, device=g0.device).to(dtype)
    upper = torch.as_tensor(upper, device=g0.device).to(dtype)

    def project(w):
        return torch.clamp(w, lower, upper)

    def pg_norm(w, g):
        return torch.linalg.vector_norm(w - project(w - g))

    w0 = project(w0.to(dtype))
    f0 = f0.to(dtype)
    f0_h, pg0 = host_scalars(f0, pg_norm(w0, g0))
    tol = wt(config.tolerance)
    tol_scale = np.maximum(wt(1.0), pg0)
    rel_tol = wt(config.tolerance * 1e-2)
    armijo_c = wt(config.armijo_c)
    alpha_min, alpha_max = wt(config.alpha_min), wt(config.alpha_max)

    n_track = config.max_iters + 1
    values = np.full(n_track, np.nan, wt)
    grad_norms = np.full(n_track, np.nan, wt)
    values[0] = f0_h
    grad_norms[0] = pg0

    w, f, g, f_h = w0, f0, g0, f0_h
    alpha = wt(1.0)  # BB step length
    converged = bool(pg0 <= tol * tol_scale)
    done = converged
    k = 0
    while not done and k < config.max_iters:
        d = project(w - float(alpha) * g) - w
        (gd,) = host_scalars(ordered.dot(g, d))

        def armijo_fails(lamb, ft_h):
            # ~(ft <= bound): a NaN trial is a failure and keeps
            # backtracking; the inverted comparison would accept it.
            return not bool(ft_h <= f_h + armijo_c * lamb * gd)

        lamb = wt(1.0)
        w_t = w + d
        ft, gt = value_and_grad(w_t)
        ft = ft.to(dtype)
        (ft_h,) = host_scalars(ft)
        tries = 0
        while armijo_fails(lamb, ft_h) and tries < config.max_backtracks:
            lamb = lamb * wt(0.5)
            w_t = w + float(lamb) * d
            ft, gt = value_and_grad(w_t)
            ft = ft.to(dtype)
            (ft_h,) = host_scalars(ft)
            tries += 1
        # A stalled backtrack (no decrease within max_backtracks, or a
        # still-NaN trial) keeps the incumbent.
        stalled = armijo_fails(lamb, ft_h)
        if stalled:
            w_next, f_next, g_next, f_next_h = w, f, g, f_h
        else:
            w_next, f_next, g_next, f_next_h = w_t, ft, gt, ft_h

        # Barzilai–Borwein step for the next iteration.
        s_vec = w_next - w
        y_vec = g_next - g
        sy, ss, pg = host_scalars(ordered.dot(s_vec, y_vec),
                                  ordered.dot(s_vec, s_vec),
                                  pg_norm(w_next, g_next))
        if sy > 0.0:
            alpha = np.clip(ss / np.maximum(sy, wt(1e-30)), alpha_min,
                            alpha_max)
        else:
            alpha = alpha_max

        k += 1
        rel_impr = abs(f_h - f_next_h) / np.maximum(abs(f_h), wt(1e-12))
        # ``converged`` is the stationarity test alone; an ftol plateau (or
        # a stalled backtrack) ends the loop without claiming it.
        converged = bool(pg <= tol * tol_scale)
        plateau = (not stalled) and bool(rel_impr <= rel_tol)
        done = converged or plateau or stalled
        w, f, g, f_h = w_next, f_next, g_next, f_next_h
        values[k] = f_h
        grad_norms[k] = pg

    return SolveResult(
        w=w,
        value=f,
        grad=g,
        iterations=k,
        converged=converged,
        values=torch.from_numpy(values),
        grad_norms=torch.from_numpy(grad_norms),
        # Exited early without stationarity (plateau / failed backtrack);
        # False on a max_iters exit, which claims neither.
        stalled=done and not converged,
    )
