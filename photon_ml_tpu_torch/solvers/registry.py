"""Config-keyed solver registry (port of ``photon_ml_tpu/solvers/registry.py``).

Each solver registers a :class:`SolverDef` under a name, and
``OptimizerConfig.solver`` selects one explicitly — or, when unset,
:func:`resolve` applies the reference's historical routing (bounds → SPG,
any L1 component → OWL-QN, else the configured optimizer).

Two solver kinds exist, as in the reference:

- ``"jit"`` — one solve over device tensors (L-BFGS, OWL-QN, TRON, SPG),
  called through its ``resident`` callable.  The out-of-core grid
  (``optim/streaming.py``) calls the same callables with an objective
  whose every evaluation is one pass over a chunk store, and the
  data-parallel grid with a ``reduce`` hook that all-reduces each
  evaluation over a process group.
- ``"host"`` — a host outer loop around per-shard subproblems and a
  fixed-size reduction a round (consensus-ADMM, distributed block CD):
  ``problem.solve`` refuses them, and the grid runners go through
  :func:`photon_ml_tpu_torch.solvers.sharded.run_grid_sharded`.
  ``sharded`` is the factory: ``sharded(problem, dist, mesh, l1_mask) →
  solve_fn(lam, w_prev, dist_override=None)``.

Registration is guarded by a lock: drivers resolve concurrently while tests
register scratch solvers.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, NamedTuple, Optional

import torch

from photon_ml_tpu_torch import telemetry as telemetry_mod

Tensor = torch.Tensor

class ResidentSolve(NamedTuple):
    """One resident solve request — what ``problem.solve`` hands a
    solver.  ``l1``/``l2`` are the already-split regularization
    weights; ``opt`` is the ``OptimizerConfig``."""

    objective: Any  # GlmObjective
    data: Any  # GlmData
    w0: Tensor
    l1: float
    l2: float
    opt: Any  # OptimizerConfig
    l1_mask: Optional[Tensor] = None
    bounds: Optional[tuple] = None
    # The objective's all-reduce over a process group (the reference's
    # axis_name); None on one device.
    reduce: Optional[Callable] = None
    # (K, d) → ((K,), (K, d)): the line searches' batched trials (L-BFGS,
    # OWL-QN), for objectives where one evaluation is a streamed pass.
    value_and_grad_batch: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class SolverDef:
    """One registered solver.  ``resident`` serves jit-kind solvers;
    ``sharded`` serves host-kind ones and is a FACTORY — it binds the
    problem and the sharded data once and returns the per-λ ``solve_fn``,
    so Gram factorizations are shared across a warm-start grid."""

    name: str
    kind: str  # "jit" | "host"
    description: str
    supports_l1: bool = False
    supports_bounds: bool = False
    resident: Optional[Callable[[ResidentSolve], Any]] = None
    sharded: Optional[Callable] = None

    def __post_init__(self):
        if self.kind not in ("jit", "host"):
            raise ValueError(f"solver kind must be jit|host, got {self.kind!r}")
        if self.kind == "jit" and self.resident is None:
            raise ValueError(
                f"jit-kind solver {self.name!r} needs a resident callable")
        if self.kind == "host" and self.sharded is None:
            raise ValueError(
                f"host-kind solver {self.name!r} needs a sharded factory")


_REGISTRY: dict[str, SolverDef] = {}
_LOCK = threading.Lock()


def register(defn: SolverDef, replace: bool = False) -> SolverDef:
    """Register a solver under ``defn.name``; duplicate names are refused
    unless ``replace=True`` (tests swapping in instrumented doubles)."""
    with _LOCK:
        if defn.name in _REGISTRY and not replace:
            raise ValueError(
                f"solver {defn.name!r} is already registered "
                "(pass replace=True to override)"
            )
        _REGISTRY[defn.name] = defn
    tel = telemetry_mod.current()
    if tel.enabled:
        tel.counter("solvers_registered_total").inc()
    return defn


def get(name: str) -> SolverDef:
    with _LOCK:
        defn = _REGISTRY.get(name)
    if defn is None:
        raise KeyError(
            f"unknown solver {name!r}; registered: {names()}"
        )
    return defn


def names() -> list[str]:
    with _LOCK:
        return sorted(_REGISTRY)


def solver_options_dict(opt) -> dict:
    """``OptimizerConfig.solver_options`` (a hashable tuple of (key, value)
    pairs) as a plain dict."""
    return dict(getattr(opt, "solver_options", ()) or ())


def resolve(opt, *, l1_frac: float, has_bounds: bool = False) -> SolverDef:
    """Pick the solver for an ``OptimizerConfig``.

    ``opt.solver`` unset applies the historical routing: bounds → SPG for
    any smooth config, any L1 component → OWL-QN (the only L1-capable
    machinery), else the configured optimizer.  An explicit name is honored
    as-is, but incompatible combinations (an L1 component with a solver
    that has no subgradient handling; bounds with anything but SPG) are
    rejected here, before any compute is spent."""
    name = getattr(opt, "solver", None)
    if name is None:
        if has_bounds:
            return get("spg")
        if l1_frac > 0.0:
            return get("owlqn")
        return get(opt.optimizer.value)
    defn = get(name)
    if has_bounds and not defn.supports_bounds:
        raise ValueError(
            f"solver {name!r} does not support box constraints; "
            "only 'spg' does — drop the bounds or the solver override"
        )
    if l1_frac > 0.0 and not defn.supports_l1:
        raise ValueError(
            f"solver {name!r} has no L1 subgradient handling; use "
            "'owlqn', 'admm', or 'block_cd' for L1/elastic-net configs"
        )
    if name == "spg" and not has_bounds:
        # SPG is a projection method: without box constraints there is no
        # feasible set to project onto.
        raise ValueError(
            "solver 'spg' needs box constraints (lower/upper bounds); "
            "use 'lbfgs' or 'tron' for unconstrained smooth configs"
        )
    return defn


# ---------------------------------------------------------------------------
# Built-in solvers: each builds the closure the reference's
# resident callable builds, so explicit and implicit routing run the same
# solve.
# ---------------------------------------------------------------------------


def _reduce_kw(ctx: ResidentSolve) -> dict:
    # Objectives of one device (a streamed pass among them) take no hook.
    return {} if ctx.reduce is None else {"reduce": ctx.reduce}


def _value_and_grad(ctx: ResidentSolve):
    obj, data, kw = ctx.objective, ctx.data, _reduce_kw(ctx)
    return lambda w: obj.value_and_grad(w, data, l2_weight=ctx.l2, **kw)


def _lbfgs_resident(ctx: ResidentSolve):
    from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve

    opt = ctx.opt
    return lbfgs_solve(
        _value_and_grad(ctx),
        ctx.w0,
        LBFGSConfig(
            max_iters=opt.max_iters,
            tolerance=opt.tolerance,
            history=opt.history,
        ),
        value_and_grad_batch=ctx.value_and_grad_batch,
    )


def _owlqn_resident(ctx: ResidentSolve):
    from photon_ml_tpu_torch.optim.owlqn import OWLQNConfig, owlqn_solve

    opt = ctx.opt
    return owlqn_solve(
        _value_and_grad(ctx),
        ctx.w0,
        ctx.l1,
        OWLQNConfig(
            max_iters=opt.max_iters,
            tolerance=opt.tolerance,
            history=opt.history,
        ),
        l1_mask=ctx.l1_mask,
        value_and_grad_batch=ctx.value_and_grad_batch,
    )


def _tron_resident(ctx: ResidentSolve):
    from photon_ml_tpu_torch.optim.tron import TRONConfig, tron_solve

    obj, data = ctx.objective, ctx.data
    return tron_solve(
        _value_and_grad(ctx),
        lambda w, v, aux: obj.hvp(w, v, data, l2_weight=ctx.l2, d2w=aux,
                                  **_reduce_kw(ctx)),
        ctx.w0,
        TRONConfig(max_iters=ctx.opt.max_iters, tolerance=ctx.opt.tolerance),
        d2_fn=lambda w: obj.d2_weights(w, data),
    )


def _spg_resident(ctx: ResidentSolve):
    from photon_ml_tpu_torch.optim.projected import SPGConfig, spg_solve

    return spg_solve(
        _value_and_grad(ctx),
        ctx.w0,
        ctx.bounds[0],
        ctx.bounds[1],
        SPGConfig(max_iters=ctx.opt.max_iters, tolerance=ctx.opt.tolerance),
    )


register(SolverDef(
    name="lbfgs",
    kind="jit",
    description="limited-memory BFGS (smooth objectives)",
    resident=_lbfgs_resident,
))
register(SolverDef(
    name="owlqn",
    kind="jit",
    description="orthant-wise L-BFGS (L1/elastic-net)",
    supports_l1=True,
    resident=_owlqn_resident,
))
register(SolverDef(
    name="tron",
    kind="jit",
    description="trust-region Newton-CG (smooth objectives)",
    resident=_tron_resident,
))
register(SolverDef(
    name="spg",
    kind="jit",
    description="spectral projected gradient (box constraints)",
    supports_bounds=True,
    resident=_spg_resident,
))
