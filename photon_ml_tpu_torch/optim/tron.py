"""TRON: Trust-Region Newton method (port of ``photon_ml_tpu/optim/tron.py``).

LIBLINEAR's trust-region Newton, as the reference's ``TRON`` optimizer:
propose a step by approximately minimizing the quadratic model inside a
trust region with Steihaug conjugate gradient, accept or reject it by the
ratio of actual to predicted reduction, and grow or shrink the radius.
Each CG step needs one Hessian-vector product — for a GLM one ``matvec``
and one ``rmatvec`` through the sparse kernels.

The GLM structure is used as the reference uses it: the Hessian at a fixed
``w`` is ``Xᵀ diag(weight·d2(m)) X + λI``, so ``d2_weights`` is computed
once per accepted iterate and every CG step reuses it (``hvp_fn(w, v,
aux)`` with the cached ``aux``).  The reference evaluates ``d2_fn`` at every
trial point and discards it on rejection; the port evaluates it only for
accepted points, with the same results and one ``matvec`` fewer per
rejected step.

The reference runs both loops as ``lax.while_loop``s; the port runs them on
the host over device tensors.  Each CG step reads ``pᵀHp``, ‖s + αp‖ and
‖r − αHp‖² in one device→host copy (the boundary step τ stays on the
device); each outer iteration reads the trial value, its three inner
products and ‖∇f‖ at the trial point in one more.  ``w_space``
(``linesearch.WSpace``, the reference's ``w_axis``) sums every inner
product and norm over the slices of a feature-sharded coefficient
vector.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.optim.lbfgs import SolveResult
from photon_ml_tpu_torch.optim.linesearch import (
    ValueAndGrad,
    WSpace,
    host_scalars,
    np_dtype,
    w_ops,
)

Tensor = torch.Tensor

# hvp_fn(w, v, aux) -> H(w) @ v, where aux = d2_fn(w) is the per-iterate cache.
HvpFn = Callable[[Tensor, Tensor, object], Tensor]
D2Fn = Callable[[Tensor], object]


@dataclasses.dataclass(frozen=True)
class TRONConfig:
    max_iters: int = 100
    tolerance: float = 1e-7
    max_cg_iters: int = 50
    # CG forcing tolerance: stop when ||r|| <= cg_tol · ||g|| (LIBLINEAR xi).
    cg_tol: float = 0.1
    # Step-acceptance threshold and radius-update constants (LIBLINEAR).
    eta0: float = 1e-4
    eta1: float = 0.25
    eta2: float = 0.75
    sigma1: float = 0.25
    sigma2: float = 0.5
    sigma3: float = 4.0


def _steihaug_cg(
    hvp: Callable[[Tensor], Tensor],
    g: Tensor,
    delta,
    max_iters: int,
    tol,
    w_space: Optional[WSpace] = None,
) -> tuple[Tensor, Tensor, bool]:
    """Approximately minimize g·s + ½ sᵀHs subject to ‖s‖ ≤ delta.

    Returns (s, r, hit_boundary) with r = −g − H·s the final
    residual, kept consistent with s on boundary exits too, so sᵀHs is
    recoverable without another HVP.  Negative curvature and radius
    crossings move to the trust-region boundary along the current
    direction.  ``delta`` and ``tol`` are host scalars of ``g``'s dtype."""
    dot, norm = w_ops(w_space)
    delta_t = torch.tensor(float(delta), dtype=g.dtype, device=g.device)
    one = torch.ones((), dtype=g.dtype, device=g.device)
    tiny = torch.tensor(1e-30, dtype=g.dtype, device=g.device)
    s = torch.zeros_like(g)
    r = -g
    p = -g
    rr_t = dot(g, g)
    (g_norm,) = host_scalars(norm(g))
    done = bool(g_norm <= tol)
    hit_boundary = False
    i = 0
    while not done and i < max_iters:
        Hp = hvp(p)
        pHp_t = dot(p, Hp)
        alpha = rr_t / torch.where(pHp_t > 0, pHp_t, one)
        s_next = s + alpha * p
        r_next = r - alpha * Hp
        # τ ≥ 0 with ‖s + τp‖ = delta.
        pp, sp, ss = dot(p, p), dot(s, p), dot(s, s)
        disc = torch.clamp(sp * sp + pp * (delta_t * delta_t - ss), min=0.0)
        tau_t = (-sp + ordered.sqrt(disc)) / torch.maximum(pp, tiny)
        rr_next_t = dot(r_next, r_next)
        pHp, s_next_norm, rr_next = host_scalars(
            pHp_t, norm(s_next), rr_next_t)

        take_boundary = bool(pHp <= 0.0) or bool(s_next_norm >= delta)
        i += 1
        hit_boundary = hit_boundary or take_boundary
        if take_boundary:
            # Maintain r = −g − H s for the RETURNED step.
            s = s + tau_t * p
            r = r - tau_t * Hp
            break
        s, r = s_next, r_next
        done = bool(np.sqrt(rr_next) <= tol)
        beta = rr_next_t / torch.maximum(rr_t, tiny)
        p = r + beta * p
        rr_t = rr_next_t
    return s, r, hit_boundary


def tron_solve(
    value_and_grad: ValueAndGrad,
    hvp_fn: HvpFn,
    w0: Tensor,
    config: TRONConfig = TRONConfig(),
    d2_fn: Optional[D2Fn] = None,
    w_space: Optional[WSpace] = None,
) -> SolveResult:
    """Minimize by trust-region Newton-CG.

    ``hvp_fn(w, v, aux)`` returns the (regularized) Hessian-vector product;
    ``d2_fn(w)`` produces the per-iterate cache passed as ``aux`` (None:
    ``aux`` is None and ``hvp_fn`` recomputes what it needs).  ``w_space``
    reduces w-space inner products over feature slices."""
    dot, norm = w_ops(w_space)
    wt = np_dtype(w0)
    make_aux = d2_fn if d2_fn is not None else (lambda w: None)

    f0, g0 = value_and_grad(w0)
    f0_h, g0_norm = host_scalars(f0, norm(g0))
    vt = type(f0_h)
    tol = wt(config.tolerance)
    tol_scale = np.maximum(wt(1.0), g0_norm)
    rel_tol = vt(config.tolerance * 1e-2)
    sigma1, sigma2, sigma3 = (wt(config.sigma1), wt(config.sigma2),
                              wt(config.sigma3))

    n_track = config.max_iters + 1
    values = np.full(n_track, np.nan, wt)
    grad_norms = np.full(n_track, np.nan, wt)
    values[0] = f0_h
    grad_norms[0] = g0_norm

    w, value, grad, value_h, gnorm_h = w0, f0, g0, f0_h, g0_norm
    aux = make_aux(w0)
    delta = g0_norm  # LIBLINEAR: initial radius = ||g0||
    converged = bool(g0_norm <= tol * tol_scale)
    done = converged
    k = 0
    while not done and k < config.max_iters:
        step, residual, _ = _steihaug_cg(
            lambda v: hvp_fn(w, v, aux), grad, delta, config.max_cg_iters,
            wt(config.cg_tol) * gnorm_h, w_space,
        )
        w_try = w + step
        f_try, g_try = value_and_grad(w_try)
        f_try_h, gs, s_r, snorm, g_try_norm = host_scalars(
            f_try, dot(grad, step), dot(step, residual), norm(step),
            norm(g_try))
        # r = −g − H·s  ⇒  sᵀHs = −s·r − s·g: no extra HVP (LIBLINEAR).
        sHs = -s_r - gs
        pred = -(gs + wt(0.5) * sHs)
        ared = value_h - f_try_h
        rho = ared / (pred if pred > 0 else wt(1e-30))
        rt = type(rho)
        eta0, eta1, eta2 = rt(config.eta0), rt(config.eta1), rt(config.eta2)

        accept = bool(rho > eta0) and bool(pred > 0)
        # Radius update (LIBLINEAR), in the reference's branch order (a NaN
        # ratio keeps the radius, as jnp.where does).
        if rho < eta1:
            delta = np.maximum(sigma1 * snorm, sigma2 * delta) * (
                sigma2 if rho < eta0 else wt(1.0))
        elif rho > eta2:
            delta = np.maximum(delta, sigma3 * snorm)
        delta = np.maximum(delta, wt(1e-20))

        k += 1
        if accept:
            rel_impr = abs(ared) / np.maximum(abs(value_h), vt(1e-12))
            w, value, grad = w_try, f_try, g_try
            value_h, gnorm_h = f_try_h, g_try_norm
            aux = make_aux(w)
        else:
            rel_impr = vt(np.inf)
        converged = bool(gnorm_h <= tol * tol_scale) or bool(
            rel_impr <= rel_tol)
        # A collapsed radius allows no further progress.
        stalled = bool(delta <= wt(1e-18))
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
