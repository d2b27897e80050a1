"""L-BFGS (port of ``photon_ml_tpu/optim/lbfgs.py``).

The reference runs a whole solve — two-loop recursion, line search,
convergence test — as one jitted ``lax.while_loop`` on the device.  The
port runs the same algorithm as a host loop over device tensors: the
coefficient vector, the gradient and the ``(m, d)`` history stay on the
device, and the host reads scalars only where a decision needs them — the
descent check, the line search's trial points, and one read per iteration
for the curvature-pair test and the convergence test.

Kept from the reference: the m=10 circular history with the curvature
safeguard, the two-loop recursion, the steepest-descent fallback, the
Breeze-style first step (1/‖g‖, capped at 1), the relative convergence
tests (‖g‖ ≤ tol·max(1, ‖g₀‖), or relative decrease ≤ tol·1e-2), the
stall rule (a failed, non-improving line search keeps the incumbent), and
every ``SolveResult`` field.  ``w_space`` (``linesearch.WSpace``, the
reference's ``w_axis``) sums every inner product and norm over the slices
of a feature-sharded coefficient vector.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.optim.linesearch import (
    LineSearchConfig,
    ValueAndGrad,
    ValueAndGradBatch,
    WSpace,
    host_scalars,
    np_dtype,
    w_ops,
    wolfe_line_search,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    """maxNumIterations, tolerance, numCorrections — as in the reference."""

    max_iters: int = 100
    # Relative tolerance on both objective decrease and gradient norm
    # (Breeze-style: ||g|| / max(1, ||g0||) <= tol).
    tolerance: float = 1e-7
    history: int = 10
    line_search: LineSearchConfig = LineSearchConfig()


class SolveResult(NamedTuple):
    """What every solver returns (the reference returns a model plus an
    ``OptimizationStatesTracker``; values/grad_norms are that tracker)."""

    w: Tensor
    value: Tensor
    grad: Tensor
    iterations: int
    converged: bool
    values: Tensor  # (max_iters+1,) objective per iteration (nan-padded), host
    grad_norms: Tensor  # (max_iters+1,), host
    # True when the solve exited without meeting the gradient-norm
    # tolerance; None for solvers that fold the plateau exit into
    # ``converged`` (L-BFGS, as in the reference).
    stalled: Optional[bool] = None


@dataclasses.dataclass
class _History:
    """The circular (s, y) history: S/Y on the device, rho/gamma on the
    host (they are decided by the host-side curvature test)."""

    S: Tensor  # (m, d)
    Y: Tensor  # (m, d)
    rho: np.ndarray  # (m,) 1 / <s, y>
    gamma: np.floating  # initial-Hessian scale <s,y>/<y,y>
    n_pairs: int = 0  # total pairs ever stored

    def valid_slots(self) -> list[int]:
        """Stored slots, newest first."""
        m = self.S.shape[0]
        newest = (self.n_pairs - 1) % m
        return [(newest - o) % m for o in range(min(self.n_pairs, m))]


def _two_loop(grad: Tensor, h: _History, w_space: Optional[WSpace] = None
              ) -> Tensor:
    """Two-loop recursion over the stored pairs (newest → oldest, then
    back).  Stays on the device: no host reads."""
    dot = w_ops(w_space)[0]
    slots = h.valid_slots()
    q = grad
    alphas = []
    for i in slots:
        alpha = float(h.rho[i]) * dot(h.S[i], q)
        q = q - alpha * h.Y[i]
        alphas.append(alpha)
    r = float(h.gamma) * q
    for i, alpha in zip(reversed(slots), reversed(alphas)):
        beta = float(h.rho[i]) * dot(h.Y[i], r)
        r = r + (alpha - beta) * h.S[i]
    return r


def update_history(h: _History, s_vec: Tensor, y_vec: Tensor,
                   w_space: Optional[WSpace] = None) -> None:
    """Insert a curvature pair, skipping it when <s, y> is not safely
    positive (standard safeguard)."""
    dot, norm = w_ops(w_space)
    sy, ns, ny, yy = host_scalars(
        dot(s_vec, y_vec), norm(s_vec), norm(y_vec), dot(y_vec, y_vec),
    )
    wt = type(sy)
    if not sy > wt(1e-10) * ns * ny:
        return
    slot = h.n_pairs % h.S.shape[0]
    h.S[slot] = s_vec
    h.Y[slot] = y_vec
    h.rho[slot] = wt(1.0) / sy
    h.gamma = sy / yy
    h.n_pairs += 1


def lbfgs_solve(
    value_and_grad: ValueAndGrad,
    w0: Tensor,
    config: LBFGSConfig = LBFGSConfig(),
    value_and_grad_batch: Optional[ValueAndGradBatch] = None,
    w_space: Optional[WSpace] = None,
) -> SolveResult:
    """Minimize ``value_and_grad`` from ``w0`` by L-BFGS.

    ``value_and_grad_batch`` evaluates a bracket of line-search trials a
    call (``linesearch.wolfe_line_search``): the same trajectory in fewer
    calls, for objectives where a call is a pass over a chunk store.
    ``w_space`` reduces w-space inner products over feature slices."""
    dot, norm = w_ops(w_space)
    m = config.history
    d = w0.shape[0]
    wt = np_dtype(w0)

    f0, g0 = value_and_grad(w0)
    f0_h, g0_norm = host_scalars(f0, norm(g0))
    tol = wt(config.tolerance)
    tol_scale = max(wt(1.0), g0_norm)
    rel_tol = np_dtype(f0)(config.tolerance * 1e-2)

    n_track = config.max_iters + 1
    values = np.full(n_track, np.nan, wt)
    grad_norms = np.full(n_track, np.nan, wt)
    values[0] = f0_h
    grad_norms[0] = g0_norm

    hist = _History(
        S=torch.zeros((m, d), dtype=w0.dtype, device=w0.device),
        Y=torch.zeros((m, d), dtype=w0.dtype, device=w0.device),
        rho=np.zeros(m, wt),
        gamma=wt(1.0),
    )
    w, value, grad, value_h, gnorm_h = w0, f0, g0, f0_h, g0_norm
    converged = bool(g0_norm <= tol * tol_scale)
    done = converged
    k = 0
    while not done and k < config.max_iters:
        direction = -_two_loop(grad, hist, w_space)
        (dg,) = host_scalars(dot(direction, grad))
        if dg >= 0.0:
            # Non-descent direction (possible after skipped updates):
            # fall back to steepest descent.
            direction = -grad
            (dg,) = host_scalars(dot(direction, grad))
        # First iteration: scale the initial step like Breeze (1 / ||g||,
        # capped at 1) so the unit quasi-Newton step is sane later.
        init_step = (
            min(wt(1.0), wt(1.0) / gnorm_h) if hist.n_pairs == 0 else wt(1.0)
        )
        ls = wolfe_line_search(
            value_and_grad, w, value_h, dg, direction,
            initial_step=init_step, config=config.line_search,
            value_and_grad_batch=value_and_grad_batch, w_space=w_space,
        )
        update_history(hist, ls.w - w, ls.grad - grad, w_space)

        k += 1
        rel_impr = abs(value_h - ls.value_host) / max(
            abs(value_h), type(value_h)(1e-12)
        )
        # A failed line search that also made no progress ends the run and
        # keeps the incumbent; convergence is measured at the iterate
        # actually returned.
        stalled = (not ls.success) and bool(ls.value_host >= value_h)
        if stalled:
            converged = bool(gnorm_h <= tol * tol_scale)
        else:
            converged = bool(ls.grad_norm <= tol * tol_scale) or bool(
                rel_impr <= rel_tol
            )
            w, value, grad = ls.w, ls.value, ls.grad
            value_h, gnorm_h = ls.value_host, ls.grad_norm
        done = converged or stalled
        values[k] = value_h
        grad_norms[k] = gnorm_h

    return SolveResult(
        w=w,
        value=value,
        grad=grad,
        iterations=k,
        converged=converged,
        values=torch.from_numpy(values),
        grad_norms=torch.from_numpy(grad_norms),
    )
