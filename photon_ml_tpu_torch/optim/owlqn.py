"""OWL-QN: Orthant-Wise Limited-memory Quasi-Newton (port of
``photon_ml_tpu/optim/owlqn.py``).

Minimizes ``f(w) + λ·‖w∘mask‖₁`` where f is the smooth (optionally
L2-regularized) part, per Andrew & Gao (2007):

- the *pseudo-gradient* replaces the gradient where ``w_i = 0`` (the
  steepest one-sided derivative, or 0 inside the subdifferential interval);
- the quasi-Newton direction (two-loop over smooth-gradient pairs) is
  projected onto the pseudo-gradient's descent orthant;
- each trial point is projected back onto the chosen orthant (coordinates
  that would cross zero are clamped to zero), with Armijo backtracking on
  the projected step.

The reference runs the solve as one ``lax.while_loop``; the port runs the
same iteration as a host loop over device tensors, sharing the circular
history and the two-loop recursion with ``lbfgs.py``.  The host reads
scalars once for the direction (its squared norm and ‖pg‖), once per
line-search trial (value, projected directional derivative and the trial's
pseudo-gradient norm together) and once for the curvature-pair test.  Every
comparison is the reference's, on the same dtypes, so a NaN or inf takes
the branch ``jnp.where`` takes.  ``l1_mask`` exempts coordinates (the
intercept) from the penalty.

``value_and_grad_batch`` evaluates a ladder of backtracking trials
``t, tβ, tβ², tβ³`` in one call (the ladder is fixed before any of its
values are known, each step built by the same multiplication the
one-trial loop does), for objectives where a call is a pass over an
out-of-core chunk store (``optim/streaming.py``).  Each candidate goes
through the same expressions as a single trial and a batched row is
bitwise its single evaluation, so the search visits the same trials.

``w_space`` (``linesearch.WSpace``, the reference's ``w_axis``) sums every
inner product and norm, and the L1 term of the value, over the slices of
a feature-sharded coefficient vector.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.optim.lbfgs import (
    SolveResult,
    _History,
    _two_loop,
    update_history,
)
from photon_ml_tpu_torch.optim.linesearch import (
    ValueAndGrad,
    ValueAndGradBatch,
    WSpace,
    host_scalars,
    np_dtype,
    w_ops,
)

Tensor = torch.Tensor

#: backtracking trials a batched evaluation carries.
OWLQN_TRIAL_BATCH = 4


@dataclasses.dataclass(frozen=True)
class OWLQNConfig:
    max_iters: int = 100
    tolerance: float = 1e-7
    history: int = 10
    max_line_search_evals: int = 30
    armijo_c1: float = 1e-4
    backtrack: float = 0.5


def _pseudo_gradient(w: Tensor, grad: Tensor, l1, mask: Tensor) -> Tensor:
    """Steepest-descent direction of f + λ‖w‖₁ (Andrew & Gao eq. 4)."""
    lam = l1 * mask
    at_zero_pos = grad + lam  # right derivative at w_i = 0
    at_zero_neg = grad - lam  # left derivative at w_i = 0
    zero = torch.zeros_like(grad)
    pg_zero = torch.where(
        at_zero_neg > 0, at_zero_neg,
        torch.where(at_zero_pos < 0, at_zero_pos, zero),
    )
    return torch.where(w != 0, grad + lam * torch.sign(w), pg_zero)


def owlqn_solve(
    value_and_grad: ValueAndGrad,
    w0: Tensor,
    l1_weight,
    config: OWLQNConfig = OWLQNConfig(),
    l1_mask: Optional[Tensor] = None,
    value_and_grad_batch: Optional[ValueAndGradBatch] = None,
    w_space: Optional[WSpace] = None,
) -> SolveResult:
    """Minimize ``f(w) + l1_weight·Σ_i mask_i·|w_i|``.

    ``value_and_grad`` evaluates only the smooth part f.  The returned
    ``SolveResult.grad`` is the final *pseudo-gradient* (its norm is the
    convergence quantity, as Breeze's OWLQN ``adjustedGradient``)."""
    dot, norm = w_ops(w_space)
    m = config.history
    d = w0.shape[0]
    wt = np_dtype(w0)
    l1 = torch.tensor(float(l1_weight), dtype=w0.dtype, device=w0.device)
    mask = (
        torch.ones(d, dtype=w0.dtype, device=w0.device) if l1_mask is None
        else torch.as_tensor(l1_mask, device=w0.device).to(w0.dtype)
    )
    c1, backtrack = wt(config.armijo_c1), wt(config.backtrack)

    def full_value(w, smooth_value):
        return smooth_value + l1 * dot(mask, w.abs())

    def pg_norm_of(w, g):
        return norm(_pseudo_gradient(w, g, l1, mask))

    f0_smooth, g0 = value_and_grad(w0)
    f0 = full_value(w0, f0_smooth)
    f0_h, pg0_norm = host_scalars(f0, pg_norm_of(w0, g0))
    tol = wt(config.tolerance)
    tol_scale = np.maximum(wt(1.0), pg0_norm)
    rel_tol = np_dtype(f0)(config.tolerance * 1e-2)

    n_track = config.max_iters + 1
    values = np.full(n_track, np.nan, wt)
    grad_norms = np.full(n_track, np.nan, wt)
    values[0] = f0_h
    grad_norms[0] = pg0_norm

    hist = _History(
        S=torch.zeros((m, d), dtype=w0.dtype, device=w0.device),
        Y=torch.zeros((m, d), dtype=w0.dtype, device=w0.device),
        rho=np.zeros(m, wt),
        gamma=wt(1.0),
    )
    w, value, grad, value_h = w0, f0, g0, f0_h
    converged = bool(pg0_norm <= tol * tol_scale)
    done = converged
    k = 0
    while not done and k < config.max_iters:
        pg = _pseudo_gradient(w, grad, l1, mask)
        direction = -_two_loop(pg, hist, w_space)
        # Project the direction onto the descent orthant of -pg: zero any
        # coordinate whose sign disagrees (Andrew & Gao §3.2 "alignment").
        direction = torch.where(direction * (-pg) > 0, direction,
                                torch.zeros_like(direction))
        dd, pg_norm = host_scalars(dot(direction, direction), norm(pg))
        if dd == 0.0:
            # Degenerate (all-zero) direction → steepest descent on pg.
            direction = -pg
        # Orthant choice: sign(w) where nonzero, else sign of the step.
        xi = torch.where(w != 0, torch.sign(w), torch.sign(-pg))

        if hist.n_pairs == 0:
            with np.errstate(divide="ignore"):
                t = np.minimum(wt(1.0), wt(1.0) / pg_norm)
        else:
            t = wt(1.0)

        def trial_point(t):
            w_t = w + float(t) * direction
            # Clamp coordinates that crossed out of the chosen orthant.
            return torch.where(w_t * xi >= 0, w_t, torch.zeros_like(w_t))

        cache: dict = {}  # step → evaluated trial (batched search)

        def trial(t):
            if value_and_grad_batch is None:
                w_t = trial_point(t)
                smooth, g_t = value_and_grad(w_t)
                f_t = full_value(w_t, smooth)
                f_h, dg_proj, pgn = host_scalars(
                    f_t, dot(pg, w_t - w), pg_norm_of(w_t, g_t))
                return w_t, f_t, g_t, f_h, dg_proj, pgn
            if t not in cache:
                steps = [t]
                while len(steps) < OWLQN_TRIAL_BATCH:
                    steps.append(steps[-1] * backtrack)
                steps = [tc for tc in steps if tc not in cache]
                w_ts = [trial_point(tc) for tc in steps]
                smooths, grads = value_and_grad_batch(torch.stack(w_ts))
                grads = [g.clone() for g in grads]
                f_ts = [full_value(w_t, sm) for w_t, sm in zip(w_ts, smooths)]
                hs = host_scalars(
                    *f_ts, *(dot(pg, w_t - w) for w_t in w_ts),
                    *(pg_norm_of(w_t, g) for w_t, g in zip(w_ts, grads)))
                n = len(steps)
                for i, tc in enumerate(steps):
                    cache[tc] = (w_ts[i], f_ts[i], grads[i], hs[i],
                                 hs[n + i], hs[2 * n + i])
            return cache[t]

        # Armijo on the PROJECTED step <pg, w_t - w>, non-strict: a fully
        # clamped trial (w_t == w, dg_proj == 0) keeps backtracking.  A NaN
        # value compares False and ends the search, as in the reference.
        w_new, f_new, g_new, f_new_h, dg_proj, pg_new_norm = trial(t)
        n = 1
        while (f_new_h >= value_h + c1 * dg_proj
               and n < config.max_line_search_evals):
            t = t * backtrack
            w_new, f_new, g_new, f_new_h, dg_proj, pg_new_norm = trial(t)
            n += 1

        # History pairs use the SMOOTH gradient (standard OWL-QN).
        update_history(hist, w_new - w, g_new - grad, w_space)

        k += 1
        rel_impr = abs(value_h - f_new_h) / np.maximum(
            abs(value_h), type(value_h)(1e-12))
        # Line search made no progress: end the run and keep the incumbent
        # (never adopt a trial point with a higher objective).  Convergence
        # is measured at the iterate actually returned.
        stalled = bool(f_new_h >= value_h)
        if stalled:
            converged = bool(pg_norm <= tol * tol_scale)
        else:
            converged = bool(pg_new_norm <= tol * tol_scale) or bool(
                rel_impr <= rel_tol)
            w, value, grad, value_h = w_new, f_new, g_new, f_new_h
            pg_norm = pg_new_norm
        done = converged or stalled
        values[k] = value_h
        grad_norms[k] = pg_norm

    return SolveResult(
        w=w,
        value=value,
        grad=_pseudo_gradient(w, grad, l1, mask),
        iterations=k,
        converged=converged,
        values=torch.from_numpy(values),
        grad_norms=torch.from_numpy(grad_norms),
    )
