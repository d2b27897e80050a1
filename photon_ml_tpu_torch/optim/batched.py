"""Batched L-BFGS, OWL-QN and TRON over the lanes of an entity bucket.

The reference solves a random-effect bucket whose per-entity problems have
no Newton fast path (any L1 component, the OWL-QN optimizer, or more than
32 local features with more than one row) as ``jax.vmap`` of
``lbfgs_solve`` / ``owlqn_solve`` / ``tron_solve`` over the bucket's ``E``
lanes (``photon_ml_tpu/game/coordinates.py:464-537``).  Under ``vmap`` each
``while_loop`` runs until every lane is done and a lane that is done keeps
its carry, so every lane follows the trajectory of its own single solve.

These programs give each lane that trajectory without a ``while_loop``: a
solve is a state machine whose ``body()`` does exactly ONE objective
evaluation (L-BFGS, OWL-QN: one line-search trial) or ONE Hessian-vector
product or trial evaluation (TRON) on every live lane, with per-lane state
for the phase each lane is in:

- L-BFGS: the weak-Wolfe bisection search of ``optim/linesearch.py``, each
  lane with its own bracket, trial step and evaluation count; when a lane's
  search ends, its iteration ends (curvature pair, stall rule, relative
  gradient and decrease tests) and its next body starts a new direction;
- OWL-QN: the pseudo-gradient, the orthant-aligned direction, the chosen
  orthant and Armijo backtracking on the projected step, per lane;
- TRON: Steihaug CG per lane (its own step, residual, direction and exit),
  then the trial evaluation with the LIBLINEAR ratio and radius rules.

The history of L-BFGS and OWL-QN is ``(E, m, D)`` with each lane's own
pair count: the two-loop recursion gathers each lane's slots newest first
and masks the slots it has not filled or skipped.  A lane that is done
keeps its state; a body reads nothing back to the host, so a caller that
advances several programs in lockstep (``game/coordinates.py``,
``BlockSolver.solve_all``) reads one flag a program a body.

The per-entity products are multiply-plus-sum over the R or D axis (never a
matmul, so TF32 cannot reach them), and the bracket arithmetic runs in the
coefficients' dtype as the reference's traced arithmetic does.
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve
from photon_ml_tpu_torch.optim.linesearch import LineSearchConfig
from photon_ml_tpu_torch.optim.owlqn import (
    OWLQNConfig,
    _pseudo_gradient,
    owlqn_solve,
)
from photon_ml_tpu_torch.optim.tron import TRONConfig, tron_solve

Tensor = torch.Tensor


def rowdot(X: Tensor, w: Tensor) -> Tensor:
    """(E, R, D)·(E, D) → (E, R): Σ_d X[e, r, d]·w[e, d]."""
    return (X * w[:, None, :]).sum(-1)


def coldot(u: Tensor, X: Tensor) -> Tensor:
    """(E, R)·(E, R, D) → (E, D): Σ_r u[e, r]·X[e, r, d]."""
    return (u[:, :, None] * X).sum(1)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(1)


def _norm(a: Tensor) -> Tensor:
    return torch.linalg.vector_norm(a, dim=1)


def _pick(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """Per-lane select: ``a`` where ``mask[e]``, else ``b``."""
    return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)


class LaneGlm:
    """One GLM a lane over an entity block: margins ``X w + offset``, value
    Σ_r wt·ℓ(m) + ½·λ₂‖w‖², gradient Σ_r wt·ℓ'(m)·x + λ₂w (the reference's
    ``make_solve_one`` objective, per lane)."""

    def __init__(self, loss, X: Tensor, labels: Tensor, weights: Tensor,
                 offsets: Tensor, l2: float):
        self.loss, self.X, self.y, self.wt = loss, X, labels, weights
        self.off = offsets.to(X.dtype)
        self.l2 = l2

    def value(self, m: Tensor, w: Tensor) -> Tensor:
        return (self.wt * self.loss.value(m, self.y)).sum(1) \
            + 0.5 * self.l2 * _dot(w, w)

    def value_grad(self, w: Tensor):
        """(value (E,), gradient (E, D), margins (E, R)) at ``w``."""
        m = rowdot(self.X, w) + self.off
        g = coldot(self.wt * self.loss.d1(m, self.y), self.X) + self.l2 * w
        return self.value(m, w), g, m

    def d2(self, m: Tensor) -> Tensor:
        """TRON's per-iterate Hessian weights wt·ℓ''(m)."""
        return self.wt * self.loss.d2(m, self.y)

    def lane(self, e: int):
        """Lane ``e``'s problem alone, for the single-problem solvers:
        ``(value_and_grad, hvp, d2)`` with ``hvp(w, v, aux)`` and ``d2(w)``
        as ``optim/tron.py`` takes them."""
        X, y, wt, off, l2 = self.X[e], self.y[e], self.wt[e], self.off[e], \
            self.l2

        def value_and_grad(w):
            m = (X * w).sum(1) + off
            return ((wt * self.loss.value(m, y)).sum() + 0.5 * l2
                    * ordered.dot(w, w),
                    (wt * self.loss.d1(m, y))[:, None].mul(X).sum(0) + l2 * w)

        def hvp(w, v, aux):
            return (aux * (X * v).sum(1))[:, None].mul(X).sum(0) + l2 * v

        def d2(w):
            return wt * self.loss.d2((X * w).sum(1) + off, y)

        return value_and_grad, hvp, d2


class _History:
    """Per-lane circular (s, y) history, ``(E, m, D)``; ``rho == 0`` marks
    an empty or skipped slot, as in ``optim/lbfgs.py``."""

    def __init__(self, E: int, m: int, D: int, like: Tensor):
        kw = dict(dtype=like.dtype, device=like.device)
        self.m = m
        self.S = torch.zeros((E, m, D), **kw)
        self.Y = torch.zeros((E, m, D), **kw)
        self.rho = torch.zeros((E, m), **kw)
        self.gamma = torch.ones(E, **kw)
        self.n_pairs = torch.zeros(E, dtype=torch.int64, device=like.device)
        self.lane = torch.arange(E, device=like.device)

    def two_loop(self, grad: Tensor) -> Tensor:
        """Each lane's two-loop recursion over its own filled slots (newest
        to oldest, then back)."""
        m = self.m
        newest = (self.n_pairs - 1) % m
        filled = torch.clamp(self.n_pairs, max=m)
        slots = []
        q = grad
        for o in range(m):
            i = (newest - o) % m
            S_i, Y_i = self.S[self.lane, i], self.Y[self.lane, i]
            rho_i = self.rho[self.lane, i]
            use = (o < filled) & (rho_i > 0)
            alpha = torch.where(use, rho_i * _dot(S_i, q), 0.0)
            q = q - alpha[:, None] * Y_i
            slots.append((S_i, Y_i, rho_i, use, alpha))
        r = self.gamma[:, None] * q
        for S_i, Y_i, rho_i, use, alpha in reversed(slots):
            beta = rho_i * _dot(Y_i, r)
            r = r + torch.where(use, alpha - beta, 0.0)[:, None] * S_i
        return r

    def update(self, s: Tensor, y: Tensor, lanes: Tensor) -> None:
        """Insert each of ``lanes``' pair unless ⟨s, y⟩ is not safely
        positive (the curvature safeguard)."""
        sy = _dot(s, y)
        good = lanes & (sy > 1e-10 * _norm(s) * _norm(y))
        slot = self.n_pairs % self.m
        hit = (torch.arange(self.m, device=s.device)[None, :]
               == slot[:, None]) & good[:, None]
        self.S = torch.where(hit[:, :, None], s[:, None, :], self.S)
        self.Y = torch.where(hit[:, :, None], y[:, None, :], self.Y)
        self.rho = torch.where(hit, (1.0 / sy)[:, None], self.rho)
        self.gamma = torch.where(good, sy / _dot(y, y), self.gamma)
        self.n_pairs = self.n_pairs + good.to(torch.int64)


class _Program:
    """What the lockstep driver needs of a program: ``pending()`` (a device
    bool: some lane is live), ``body()``, ``result()``, per-lane
    ``converged`` and a body bound ``cap``.  ``iterations`` counts each
    lane's outer iterations, ``inner`` its line-search trials (L-BFGS,
    OWL-QN) or CG steps (TRON); ``plateau`` marks lanes whose last
    convergence came from the relative-decrease test alone, and ``w_prev``
    holds each lane's iterate before its last accepted step; ``single(e,
    w0)`` solves lane ``e`` alone from ``w0`` with the single-problem
    solver whose trajectory the lane follows."""

    def pending(self) -> Tensor:
        return ~self.finished.all()

    def result(self) -> Tensor:
        return self.w

    def _finish_iteration(self, lanes, conv, stop, gtol_pass):
        self.iterations = self.iterations + lanes.to(torch.int64)
        self.converged = torch.where(lanes, conv, self.converged)
        self.plateau = torch.where(lanes, conv & ~gtol_pass, self.plateau)
        self.finished = self.finished | (
            lanes & (stop | (self.iterations >= self.max_iters)))


class BatchedLBFGS(_Program):
    """``lbfgs_solve`` on every lane (weak-Wolfe line search, history
    ``m``, Breeze-style first step, stall rule), one trial a body."""

    def __init__(self, obj: LaneGlm, w0: Tensor, max_iters: int,
                 tolerance: float, history: int,
                 line_search: LineSearchConfig = LineSearchConfig()):
        E, D = w0.shape
        self.obj, self.ls = obj, line_search
        self.max_iters, self.tol = max_iters, tolerance
        self.cap = max_iters * line_search.max_evals
        self.w = self.w_prev = w0
        self.value, self.grad, _ = obj.value_grad(w0)
        g0n = _norm(self.grad)
        self.gtol = tolerance * torch.clamp(g0n, min=1.0)
        self.converged = g0n <= self.gtol
        self.plateau = torch.zeros_like(self.converged)
        self.finished = self.converged | (max_iters <= 0)
        self.iterations = torch.zeros(E, dtype=torch.int64, device=w0.device)
        self.inner = torch.zeros_like(self.iterations)
        self.hist = _History(E, history, D, w0)
        self.searching = torch.zeros_like(self.converged)
        zero = torch.zeros_like(self.value)
        self.dir = torch.zeros_like(w0)
        self.dg0, self.t, self.lo, self.hi = zero, zero, zero, zero
        self.n_evals = torch.zeros_like(self.iterations)

    def single(self, e: int, w0: Tensor):
        vg, _, _ = self.obj.lane(e)
        return lbfgs_solve(vg, w0, LBFGSConfig(
            max_iters=self.max_iters, tolerance=self.tol,
            history=self.hist.m, line_search=self.ls))

    def body(self) -> None:
        ls = self.ls
        live = ~self.finished
        start = live & ~self.searching
        # A new iteration: the two-loop direction (steepest descent if it
        # is not a descent direction) and the first trial step.
        d = -self.hist.two_loop(self.grad)
        d = _pick(_dot(d, self.grad) >= 0.0, -self.grad, d)
        init = torch.where(self.hist.n_pairs == 0,
                           torch.clamp(1.0 / _norm(self.grad), max=1.0), 1.0)
        self.dir = _pick(start, d, self.dir)
        self.dg0 = torch.where(start, _dot(d, self.grad), self.dg0)
        self.t = torch.where(start, init, self.t)
        self.lo = torch.where(start, 0.0, self.lo)
        self.hi = torch.where(start, float("inf"), self.hi)
        self.n_evals = torch.where(start, 0, self.n_evals)

        w_t = self.w + self.t[:, None] * self.dir
        f_t, g_t, _ = self.obj.value_grad(w_t)
        dg_t = _dot(self.dir, g_t)
        self.n_evals = self.n_evals + live.to(torch.int64)
        self.inner = self.inner + live.to(torch.int64)

        # The bisection step of the weak-Wolfe search.
        armijo = f_t <= self.value + ls.c1 * self.t * self.dg0
        wolfe = armijo & (dg_t >= ls.c2 * self.dg0)
        hi = torch.where(armijo, self.hi, torch.minimum(self.hi, self.t))
        lo = torch.where(armijo, torch.maximum(self.lo, self.t), self.lo)
        t_next = torch.where(torch.isinf(hi), 2.0 * lo, 0.5 * (lo + hi))
        t_next = torch.clamp(t_next, ls.min_step, ls.max_step)
        stuck = (t_next == self.t) | (hi - lo < ls.min_step)
        done = live & ((self.n_evals >= ls.max_evals) | wolfe | stuck)
        cont = live & ~done
        self.lo = torch.where(cont, lo, self.lo)
        self.hi = torch.where(cont, hi, self.hi)
        self.t = torch.where(cont, t_next, self.t)
        self.searching = cont

        # Lanes whose search ended end their iteration.
        self.hist.update(w_t - self.w, g_t - self.grad, done)
        rel = (self.value - f_t).abs() / torch.clamp(self.value.abs(),
                                                     min=1e-12)
        stalled = ~wolfe & (f_t >= self.value)
        g_pass = torch.where(stalled, _norm(self.grad), _norm(g_t)) \
            <= self.gtol
        conv = torch.where(stalled, g_pass, g_pass | (rel <= self.tol * 1e-2))
        adopt = done & ~stalled
        self.w_prev = _pick(adopt, self.w, self.w_prev)
        self.w = _pick(adopt, w_t, self.w)
        self.value = torch.where(adopt, f_t, self.value)
        self.grad = _pick(adopt, g_t, self.grad)
        self._finish_iteration(done, conv, conv | stalled, g_pass)


class BatchedOWLQN(_Program):
    """``owlqn_solve`` on every lane: minimizes the smooth lane objective
    plus ``l1``·‖w‖₁, one Armijo trial a body."""

    def __init__(self, obj: LaneGlm, w0: Tensor, l1: float, max_iters: int,
                 tolerance: float, history: int,
                 config: OWLQNConfig = OWLQNConfig()):
        E, D = w0.shape
        self.obj, self.cfg, self.l1 = obj, config, l1
        self.mask = torch.ones(D, dtype=w0.dtype, device=w0.device)
        self.max_iters, self.tol = max_iters, tolerance
        self.cap = max_iters * config.max_line_search_evals
        self.w = self.w_prev = w0
        smooth, self.grad, _ = obj.value_grad(w0)
        self.value = self._full(w0, smooth)
        pg0n = _norm(self._pg(w0, self.grad))
        self.gtol = tolerance * torch.clamp(pg0n, min=1.0)
        self.converged = pg0n <= self.gtol
        self.plateau = torch.zeros_like(self.converged)
        self.finished = self.converged | (max_iters <= 0)
        self.iterations = torch.zeros(E, dtype=torch.int64, device=w0.device)
        self.inner = torch.zeros_like(self.iterations)
        self.hist = _History(E, history, D, w0)
        self.searching = torch.zeros_like(self.converged)
        self.dir = torch.zeros_like(w0)
        self.xi = torch.zeros_like(w0)
        self.pg = torch.zeros_like(w0)
        self.t = torch.zeros_like(self.value)
        self.n_evals = torch.zeros_like(self.iterations)

    def single(self, e: int, w0: Tensor):
        vg, _, _ = self.obj.lane(e)
        return owlqn_solve(vg, w0, self.l1, dataclasses.replace(
            self.cfg, max_iters=self.max_iters, tolerance=self.tol,
            history=self.hist.m))

    def _full(self, w, smooth):
        return smooth + self.l1 * w.abs().sum(1)

    def _pg(self, w, g):
        return _pseudo_gradient(w, g, self.l1, self.mask)

    def body(self) -> None:
        cfg = self.cfg
        live = ~self.finished
        start = live & ~self.searching
        # A new iteration: the two-loop direction on the pseudo-gradient,
        # aligned with -pg's orthant (steepest descent on pg if nothing is
        # left), the orthant chosen, and the first trial step.
        pg = self._pg(self.w, self.grad)
        d = -self.hist.two_loop(pg)
        d = torch.where(d * (-pg) > 0, d, 0.0)
        d = _pick(_dot(d, d) == 0.0, -pg, d)
        xi = torch.where(self.w != 0, torch.sign(self.w), torch.sign(-pg))
        t0 = torch.where(self.hist.n_pairs == 0,
                         torch.clamp(1.0 / _norm(pg), max=1.0), 1.0)
        self.pg = _pick(start, pg, self.pg)
        self.dir = _pick(start, d, self.dir)
        self.xi = _pick(start, xi, self.xi)
        self.t = torch.where(start, t0, self.t * cfg.backtrack)
        self.n_evals = torch.where(start, 0, self.n_evals)

        w_t = self.w + self.t[:, None] * self.dir
        w_t = torch.where(w_t * self.xi >= 0, w_t, 0.0)
        smooth, g_t, _ = self.obj.value_grad(w_t)
        f_t = self._full(w_t, smooth)
        self.n_evals = self.n_evals + live.to(torch.int64)
        self.inner = self.inner + live.to(torch.int64)
        # Armijo on the projected step, non-strict (a fully clamped trial
        # keeps backtracking).
        dg_proj = _dot(self.pg, w_t - self.w)
        cont = live & (f_t >= self.value + cfg.armijo_c1 * dg_proj) \
            & (self.n_evals < cfg.max_line_search_evals)
        done = live & ~cont
        self.searching = cont

        # History pairs use the smooth gradient.
        self.hist.update(w_t - self.w, g_t - self.grad, done)
        rel = (self.value - f_t).abs() / torch.clamp(self.value.abs(),
                                                     min=1e-12)
        stalled = f_t >= self.value
        g_pass = torch.where(stalled, _norm(self.pg),
                             _norm(self._pg(w_t, g_t))) <= self.gtol
        conv = torch.where(stalled, g_pass, g_pass | (rel <= self.tol * 1e-2))
        adopt = done & ~stalled
        self.w_prev = _pick(adopt, self.w, self.w_prev)
        self.w = _pick(adopt, w_t, self.w)
        self.value = torch.where(adopt, f_t, self.value)
        self.grad = _pick(adopt, g_t, self.grad)
        self._finish_iteration(done, conv, conv | stalled, g_pass)


class BatchedTRON(_Program):
    """``tron_solve`` on every lane: per-lane Steihaug CG on the Hessian
    X'diag(wt·ℓ''(m))X + λ₂I (weights cached at each accepted iterate),
    then the trial evaluation and the LIBLINEAR ratio and radius rules.  A
    body is one CG step or one trial evaluation a lane; both are one
    ``X v`` and one ``X'u``, so a body makes the same two products
    whatever phase each lane is in."""

    def __init__(self, obj: LaneGlm, w0: Tensor, max_iters: int,
                 tolerance: float, config: TRONConfig = TRONConfig()):
        E, _ = w0.shape
        self.obj, self.cfg = obj, config
        self.max_iters, self.tol = max_iters, tolerance
        self.cap = max_iters * (config.max_cg_iters + 1)
        self.w = self.w_prev = w0
        self.value, self.grad, m0 = obj.value_grad(w0)
        self.aux = obj.d2(m0)
        g0n = _norm(self.grad)
        self.gtol = tolerance * torch.clamp(g0n, min=1.0)
        self.delta = g0n  # LIBLINEAR: the first radius is ‖g₀‖
        self.converged = g0n <= self.gtol
        self.plateau = torch.zeros_like(self.converged)
        self.finished = self.converged | (max_iters <= 0)
        self.iterations = torch.zeros(E, dtype=torch.int64, device=w0.device)
        self.inner = torch.zeros_like(self.iterations)
        self.fresh = torch.ones_like(self.converged)  # starts an iteration
        self.s = torch.zeros_like(w0)
        self.r = torch.zeros_like(w0)
        self.p = torch.zeros_like(w0)
        self.rr = torch.zeros_like(self.value)
        self.cg_tol = torch.zeros_like(self.value)
        self.cg_i = torch.zeros_like(self.iterations)
        self.cg_done = torch.zeros_like(self.converged)

    def single(self, e: int, w0: Tensor):
        vg, hvp, d2 = self.obj.lane(e)
        return tron_solve(vg, hvp, w0, dataclasses.replace(
            self.cfg, max_iters=self.max_iters, tolerance=self.tol),
            d2_fn=d2)

    def body(self) -> None:
        cfg, obj = self.cfg, self.obj
        live = ~self.finished
        # Lanes starting an iteration start their CG at s = 0.
        start = live & self.fresh
        gn = _norm(self.grad)
        self.s = _pick(start, torch.zeros_like(self.s), self.s)
        self.r = _pick(start, -self.grad, self.r)
        self.p = _pick(start, -self.grad, self.p)
        self.rr = torch.where(start, _dot(self.grad, self.grad), self.rr)
        self.cg_i = torch.where(start, 0, self.cg_i)
        cg_tol = cfg.cg_tol * gn
        self.cg_tol = torch.where(start, cg_tol, self.cg_tol)
        self.cg_done = torch.where(start, gn <= cg_tol, self.cg_done)
        self.fresh = self.fresh & ~start

        cg = live & ~self.cg_done & (self.cg_i < cfg.max_cg_iters)
        ev = live & ~cg
        # One X v and one X'u a lane: v = p (CG) or the trial point.
        w_try = self.w + self.s
        xv = rowdot(obj.X, _pick(cg, self.p, w_try))
        m_try = xv + obj.off
        u = torch.where(cg[:, None], self.aux * xv,
                        obj.wt * obj.loss.d1(m_try, obj.y))
        xu = coldot(u, obj.X)

        # -- a Steihaug CG step (cg lanes) --------------------------------
        s, r, p, rr, delta = self.s, self.r, self.p, self.rr, self.delta
        Hp = xu + obj.l2 * p
        pHp = _dot(p, Hp)
        alpha = rr / torch.where(pHp > 0, pHp, 1.0)
        s_next = s + alpha[:, None] * p
        boundary = (pHp <= 0.0) | (_norm(s_next) >= delta)
        pp, sp, ss = _dot(p, p), _dot(s, p), _dot(s, s)
        disc = torch.clamp(sp * sp + pp * (delta * delta - ss), min=0.0)
        tau = (-sp + ordered.sqrt(disc)) / torch.clamp(pp, min=1e-30)
        step = torch.where(boundary, tau, alpha)
        s_new = s + step[:, None] * p
        r_new = r - step[:, None] * Hp
        rr_new = _dot(r_new, r_new)
        small = ordered.sqrt(rr_new) <= self.cg_tol
        beta = rr_new / torch.clamp(rr, min=1e-30)
        p_new = r_new + beta[:, None] * p
        self.s = _pick(cg, s_new, s)
        self.r = _pick(cg, r_new, r)
        self.p = _pick(cg & ~boundary, p_new, p)
        self.rr = torch.where(cg, rr_new, rr)
        self.cg_i = self.cg_i + cg.to(torch.int64)
        self.cg_done = torch.where(cg, boundary | small, self.cg_done)
        self.inner = self.inner + cg.to(torch.int64)

        # -- the trial evaluation (ev lanes) ------------------------------
        f_try = obj.value(m_try, w_try)
        g_try = xu + obj.l2 * w_try
        gs = _dot(self.grad, s)
        # r = -g - H·s  ⇒  sᵀHs = -s·r - s·g (no extra HVP).
        sHs = -_dot(s, r) - gs
        pred = -(gs + 0.5 * sHs)
        ared = self.value - f_try
        rho = ared / torch.where(pred > 0, pred, 1e-30)
        accept = ev & (rho > cfg.eta0) & (pred > 0)
        snorm = _norm(s)
        grown = torch.where(rho > cfg.eta2,
                            torch.maximum(delta, cfg.sigma3 * snorm), delta)
        shrunk = torch.maximum(cfg.sigma1 * snorm, cfg.sigma2 * delta) \
            * torch.where(rho < cfg.eta0, cfg.sigma2, 1.0)
        new_delta = torch.clamp(torch.where(rho < cfg.eta1, shrunk, grown),
                                min=1e-20)
        rel = torch.where(accept, ared.abs() / torch.clamp(
            self.value.abs(), min=1e-12), float("inf"))
        self.w_prev = _pick(accept, self.w, self.w_prev)
        self.w = _pick(accept, w_try, self.w)
        self.value = torch.where(accept, f_try, self.value)
        self.grad = _pick(accept, g_try, self.grad)
        self.aux = _pick(accept, obj.d2(m_try), self.aux)
        self.delta = torch.where(ev, new_delta, delta)
        g_pass = _norm(self.grad) <= self.gtol
        conv = g_pass | (rel <= self.tol * 1e-2)
        self.fresh = self.fresh | ev
        self._finish_iteration(ev, conv, conv | (new_delta <= 1e-18), g_pass)
