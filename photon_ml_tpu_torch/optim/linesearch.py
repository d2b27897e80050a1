"""Weak-Wolfe line search (port of ``photon_ml_tpu/optim/linesearch.py``).

The same bisection / doubling weak-Wolfe search as the reference: Armijo
failure shrinks the upper bracket, curvature failure grows the lower one,
the next trial is the midpoint (or 2·lo while unbracketed), and a
degenerate bracket stops the search.  The reference runs it as a bounded
``lax.while_loop`` on the device; here it is a host loop over device
tensors.  Each trial point costs one value+gradient evaluation and ONE
device→host read (value, directional derivative and gradient norm
together).  The bracket arithmetic runs in numpy scalars of the
coefficient dtype, and the value tests in the objective's dtype, exactly as
the reference's traced arithmetic does, so both packages take the same
decisions on the same numbers.

When one evaluation is a whole pass over an out-of-core store
(``optim/streaming.py``), ``value_and_grad_batch`` lets a pass evaluate the
current trial together with its two possible successors: the next trial
after an Armijo success and after an Armijo failure are both known from the
bracket before the trial's result is, so a pass resolves two levels of the
search.  Every candidate is built by the same expression as a single trial
and a batched row is bitwise its single evaluation, so the trials, the
accepted step and ``n_evals`` are those of the one-trial-per-pass search.

``w_space`` is the reference's ``w_axis``: a :class:`WSpace` whose ``dot``
and ``norm`` sum per-slice partials, for a coefficient vector that lives
in feature slices (``parallel/tensor.py``).  Without it every inner
product is ``ops/ordered.py``'s ``dot`` (``torch.dot`` on a card; on the
CPU the same order on every host, where the BLAS's depends on the host)
and every norm ``torch.linalg.vector_norm``; the solvers (``lbfgs.py``,
``owlqn.py``, ``tron.py``) take the same hook.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Protocol

import numpy as np
import torch

from photon_ml_tpu_torch.ops import ordered

Tensor = torch.Tensor

# f(w) -> (value, grad): the only thing the line search needs.
ValueAndGrad = Callable[[Tensor], tuple[Tensor, Tensor]]
# (K, d) candidates -> ((K,), (K, d)), row i bitwise f(ws[i]).
ValueAndGradBatch = Callable[[Tensor], tuple[Tensor, Tensor]]


class WSpace(Protocol):
    """Inner products over coefficient space, summed over its slices."""

    def dot(self, a: Tensor, b: Tensor) -> Tensor: ...

    def norm(self, a: Tensor) -> Tensor: ...


def w_ops(w_space: Optional[WSpace]):
    """``(dot, norm)`` over coefficient space: the hook's, else
    ``ordered.dot`` and ``torch.linalg.vector_norm``."""
    if w_space is None:
        return ordered.dot, torch.linalg.vector_norm
    return w_space.dot, w_space.norm


def np_dtype(t: Tensor):
    """The numpy scalar type matching a floating tensor's dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[t.dtype]


def host_scalars(*scalars: Tensor) -> list:
    """Read several 0-d device tensors with one device→host copy; each
    comes back as a numpy scalar of its own dtype (exactly: f32 → f64 →
    f32 is lossless)."""
    vals = torch.stack([s.detach().to(torch.float64) for s in scalars])
    return [np_dtype(s)(v) for s, v in zip(scalars, vals.cpu().tolist())]


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    c1: float = 1e-4  # Armijo (sufficient decrease) constant
    c2: float = 0.9  # curvature constant
    max_evals: int = 30
    min_step: float = 1e-20
    max_step: float = 1e20


class LineSearchResult(NamedTuple):
    step: np.floating  # accepted step size t
    w: Tensor  # w0 + t * direction
    value: Tensor  # f(w)
    grad: Tensor  # ∇f(w)
    n_evals: int  # objective evaluations used
    success: bool  # both Wolfe conditions met
    value_host: np.floating  # f(w) on the host
    grad_norm: np.floating  # ‖∇f(w)‖ on the host


def wolfe_line_search(
    value_and_grad: ValueAndGrad,
    w0: Tensor,
    f0_host,
    dg0_host,
    direction: Tensor,
    initial_step=1.0,
    config: LineSearchConfig = LineSearchConfig(),
    value_and_grad_batch: Optional[ValueAndGradBatch] = None,
    w_space: Optional[WSpace] = None,
) -> LineSearchResult:
    """Find t satisfying the weak Wolfe conditions along ``direction``.

    ``f0_host`` is f(w0) and ``dg0_host`` the directional derivative
    ⟨direction, ∇f(w0)⟩, both as host numpy scalars.  Always returns the
    last evaluated point; ``success`` reports whether the Wolfe conditions
    held there.  ``value_and_grad_batch`` evaluates each trial with its
    successors in one call (see the module docstring)."""
    dot, norm = w_ops(w_space)
    wt = np_dtype(w0)
    c1, c2 = wt(config.c1), wt(config.c2)
    min_step, max_step = wt(config.min_step), wt(config.max_step)

    def next_step(t, lo, hi):
        t_next = wt(2.0) * lo if np.isinf(hi) else wt(0.5) * (lo + hi)
        return wt(min(max(t_next, min_step), max_step))

    def trial_point(t):
        return w0 + float(t) * direction

    def scalars(value, grad):
        return host_scalars(value, dot(direction, grad), norm(grad))

    cache: dict = {}  # step → evaluated trial (batched search)

    def evaluate(t, lo, hi):
        if value_and_grad_batch is None:
            w = trial_point(t)
            value, grad = value_and_grad(w)
            return (w, value, grad, *scalars(value, grad))
        if t not in cache:
            # An Armijo success moves lo up to t, a failure hi down to t.
            steps = [t]
            for lo2, hi2 in ((max(lo, t), hi), (lo, min(hi, t))):
                tn = next_step(t, lo2, hi2)
                if tn not in steps and tn not in cache:
                    steps.append(tn)
            ws = [trial_point(tc) for tc in steps]
            values, grads = value_and_grad_batch(torch.stack(ws))
            grads = [g.clone() for g in grads]
            hs = host_scalars(*values, *(dot(direction, g) for g in grads),
                              *(norm(g) for g in grads))
            n = len(steps)
            for i, tc in enumerate(steps):
                cache[tc] = (ws[i], values[i], grads[i], hs[i], hs[n + i],
                             hs[2 * n + i])
        return cache[t]

    def armijo_ok(t, v_h):
        return bool(v_h <= f0_host + c1 * t * dg0_host)

    def curvature_ok(dg_h):
        return bool(dg_h >= c2 * dg0_host)

    t = wt(initial_step)
    lo, hi = wt(0.0), wt(np.inf)
    w, value, grad, v_h, dg_h, gn_h = evaluate(t, lo, hi)
    n_evals = 1
    done = False
    while not done and n_evals < config.max_evals:
        a_ok = armijo_ok(t, v_h)
        done = a_ok and curvature_ok(dg_h)
        # Armijo fails → bracket from above; curvature fails → from below.
        if a_ok:
            lo = max(lo, t)
        else:
            hi = min(hi, t)
        t_next = next_step(t, lo, hi)
        # Degenerate bracket → stop where we are.
        done = done or bool(t_next == t) or bool(hi - lo < min_step)
        if not done:
            t = t_next
            w, value, grad, v_h, dg_h, gn_h = evaluate(t, lo, hi)
            n_evals += 1

    success = armijo_ok(t, v_h) and curvature_ok(dg_h)
    return LineSearchResult(
        step=t, w=w, value=value, grad=grad, n_evals=n_evals,
        success=success, value_host=v_h, grad_norm=gn_h,
    )
