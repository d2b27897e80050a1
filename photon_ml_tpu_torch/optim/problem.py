"""Optimization problems (port of ``photon_ml_tpu/optim/problem.py``).

Binds objective + optimizer + regularization + normalization to produce a
trained ``GeneralizedLinearModel``, optionally with coefficient variances,
and sweeps a regularization-weight grid with warm starts (the reference's
``ModelTraining`` chain).

Every solve dispatches through the solver registry
(``photon_ml_tpu_torch/solvers/registry.py``): bounds → SPG, any L1
component → OWL-QN, else the configured optimizer, or the solver that
``OptimizerConfig.solver`` names.  Host-kind solvers (consensus-ADMM,
block CD) drive their own outer loop over sharded data and are refused
here; ``solvers/sharded.py::run_grid_sharded`` runs them through the same
:meth:`GlmOptimizationProblem.grid_loop`.

``reduce`` is the reference's ``axis_name``: the data-parallel grid
(``parallel/distributed.py::run_grid_distributed``) solves each rank's row
block with a hook that all-reduces the objective's data term, so one
solve here serves one device or a process group.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import chaos as chaos_mod
from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.data.dataset import GlmData
from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.optim.lbfgs import SolveResult
from photon_ml_tpu_torch.optim.linesearch import np_dtype
from photon_ml_tpu_torch.optim.objective import GlmObjective
from photon_ml_tpu_torch.optim.regularization import RegularizationContext

Tensor = torch.Tensor


class OptimizerType(enum.Enum):
    LBFGS = "lbfgs"
    OWLQN = "owlqn"
    TRON = "tron"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The reference's ``OptimizerConfig`` (optimizerType,
    maximumIterations, tolerance).  ``solver`` names a registered solver
    (``photon_ml_tpu_torch/solvers/registry.py``) explicitly; None keeps the
    historical routing (bounds → SPG, any L1 component → OWL-QN, else
    ``optimizer``).  ``solver_options`` carries the solver's knobs as a
    tuple of (key, value) pairs, hashable like the rest of the config."""

    optimizer: OptimizerType = OptimizerType.LBFGS
    max_iters: int = 100
    tolerance: float = 1e-7
    history: int = 10  # L-BFGS/OWL-QN corrections
    solver: Optional[str] = None
    solver_options: tuple = ()


@dataclasses.dataclass(frozen=True)
class GlmOptimizationConfig:
    """Optimizer config + regularization context + variance flag."""

    optimizer: OptimizerConfig = OptimizerConfig()
    regularization: RegularizationContext = RegularizationContext.none()
    compute_variances: bool = False


class GlmOptimizationProblem:
    """Trains GLMs for a task under a config."""

    def __init__(
        self,
        task: str,
        config: GlmOptimizationConfig = GlmOptimizationConfig(),
        normalization: Optional[NormalizationContext] = None,
        accumulate: str = "f32",
    ):
        self.task = losses_lib.get(task).name  # canonicalize aliases
        self.config = config
        #: per-λ wall seconds of the LAST grid_loop run (solve to completion).
        self.grid_wall_seconds: dict[float, float] = {}
        self.objective = GlmObjective(
            losses_lib.get(task), normalization, accumulate=accumulate
        )
        self.normalization = normalization

    def solve_single_device(
        self,
        data: GlmData,
        reg_weight: float = 0.0,
        w0: Optional[Tensor] = None,
        l1_mask: Optional[Tensor] = None,
        bounds: Optional[tuple[Tensor, Tensor]] = None,
        reduce=None,
    ) -> SolveResult:
        """The reference's jit-cached single-device entry, which hands λ to
        the solve as a float32 scalar; the port runs eagerly."""
        return self.solve(data, float(np.float32(reg_weight)), w0, l1_mask,
                          bounds, reduce=reduce)

    def solve(
        self,
        data: GlmData,
        reg_weight: float = 0.0,
        w0: Optional[Tensor] = None,
        l1_mask: Optional[Tensor] = None,
        bounds: Optional[tuple[Tensor, Tensor]] = None,
        reduce=None,
    ) -> SolveResult:
        """One optimization run at one regularization weight.

        ``bounds`` = (lower, upper) per-coefficient tensors (±inf entries
        unconstrained) routes the solve to the box-constrained SPG path.
        ``l1_mask`` exempts coordinates (the intercept) from an L1
        penalty.  ``reduce`` sums the objective's data term over a process
        group (``data`` is then this rank's row block)."""
        cfg = self.config
        if bounds is not None and cfg.compute_variances:
            # The diag-inverse-Hessian variance assumes an interior
            # optimum; a coefficient pinned at an active bound has a
            # nonzero gradient there and its variance would be meaningless.
            raise ValueError(
                "bounds are incompatible with compute_variances=True: "
                "diag-inverse-Hessian variances assume an interior "
                "optimum and are wrong for coefficients at an active "
                "bound — drop the bounds or the variance request"
            )
        if w0 is None:
            w0 = torch.zeros(data.n_features, dtype=torch.float32,
                             device=data.device)
        # λ in the coefficients' dtype, split as the reference's traced
        # arithmetic splits it (a float fraction times that scalar).
        wt = np_dtype(w0)
        lam = wt(reg_weight)
        l1_frac = cfg.regularization.l1_weight(1.0)
        l1 = float(wt(l1_frac) * lam)
        l2 = float(wt(cfg.regularization.l2_weight(1.0)) * lam)
        opt = cfg.optimizer

        if bounds is not None and l1_frac > 0.0:
            # Box constraints conflict with the orthant-wise machinery for
            # any solver choice.
            raise NotImplementedError(
                "box constraints combined with L1 regularization are "
                "not supported: the orthant-wise and projection "
                "machineries conflict (drop the L1 component or the "
                "bounds)"
            )
        from photon_ml_tpu_torch.solvers import registry as solver_registry

        defn = solver_registry.resolve(
            opt, l1_frac=l1_frac, has_bounds=bounds is not None
        )
        if defn.kind != "jit":
            raise ValueError(
                f"solver {defn.name!r} runs a host-side outer loop and "
                "cannot execute inside a single solve; route through "
                "solvers.sharded.run_grid_sharded (glm_driver --solver "
                "and run_grid_distributed do this automatically)"
            )
        return defn.resident(solver_registry.ResidentSolve(
            objective=self.objective, data=data, w0=w0, l1=l1, l2=l2,
            opt=opt, l1_mask=l1_mask, bounds=bounds, reduce=reduce,
        ))

    def coefficient_variances(self, w: Tensor, data: GlmData,
                              reg_weight: float = 0.0,
                              reduce=None) -> Tensor:
        """Diagonal-inverse-Hessian approximation ``1 / H_jj`` (the
        reference's ``VarianceComputationType.SIMPLE``), with ``H_jj =
        Σᵢ wᵢ·d2ᵢ·X²ᵢⱼ + λ₂`` — one squared-column reduction (summed over
        the process group by ``reduce``)."""
        l2 = self.config.regularization.l2_weight(1.0) * float(reg_weight)
        d2w = self.objective.d2_weights(w, data)
        diag = data.features.sq_rmatvec(d2w)
        if reduce is not None:
            (diag,) = reduce(diag)
        return 1.0 / torch.clamp(diag + l2, min=1e-12)

    def make_model(self, w: Tensor,
                   variances: Optional[Tensor] = None) -> GeneralizedLinearModel:
        """Map scaled-space coefficients back to the original feature space
        (normalization) and wrap them as a model."""
        if self.normalization is not None:
            w = self.normalization.model_to_original(w)
            if variances is not None:
                variances = variances * self.normalization.factors ** 2
        return GeneralizedLinearModel(Coefficients(w, variances), self.task)

    def grid_loop(
        self,
        solve_fn,
        reg_weights: Sequence[float],
        w0: Optional[Tensor] = None,
        warm_start: bool = True,
        solved: Optional[dict] = None,
        on_solved=None,
        variance_fn=None,
        device=None,
    ) -> list[tuple[float, GeneralizedLinearModel, Optional[SolveResult]]]:
        """The warm-started λ chain (largest λ first): ``solve_fn(lam,
        w_prev) → SolveResult``.

        Checkpoint/resume: ``solved`` (λ → coefficients, from
        ``io/checkpoint.GridCheckpointer``) skips already-solved λs — their
        entries come back with ``res=None`` and the warm-start chain
        continues from the restored coefficients, so a resumed grid matches
        the uninterrupted one bit for bit.  Restored coefficients keep their
        dtype and land on ``device``; without it, on the device of the
        chain's current coefficients (``w0`` or the last solve's), else on
        the default device (:func:`resolve_device`).  ``on_solved(lam, w)`` fires
        after each fresh solve (the driver persists the checkpoint there).
        ``variance_fn(w, lam)`` runs for every grid point, restored ones
        included, when variances are requested.  Each fresh solve is
        wall-clocked to completion into ``self.grid_wall_seconds``, under a
        ``solver`` telemetry span carrying the host loop's iteration count
        (``solver_iterations``, ``solver_wall_seconds``: host values, no
        device read).  The ``grid.point`` fault site fires after a fresh
        point is solved and persisted, before the next λ starts."""
        from photon_ml_tpu_torch.utils.timer import Timer

        tel = telemetry_mod.current()
        self.grid_wall_seconds = {}
        results = []
        w_prev = w0
        solved = solved or {}
        for lam in sorted(reg_weights, reverse=True):
            if lam in solved:
                dev = (resolve_device(device) if device is not None
                       else w_prev.device if isinstance(w_prev, Tensor)
                       else resolve_device(None))
                w = torch.as_tensor(solved[lam], device=dev)
                res = None
                tel.event("grid.restored", reg_weight=float(lam))
            else:
                with tel.span(
                    "solver",
                    reg_weight=float(lam),
                    optimizer=self.config.optimizer.optimizer.value,
                ) as sp:
                    timer = Timer().start()
                    res = solve_fn(lam, w_prev)
                    wall = timer.stop_blocking(res.w)
                    if tel.enabled:
                        iters = int(res.iterations)
                        sp.set(iterations=iters,
                               converged=bool(res.converged),
                               wall_seconds=wall)
                        tel.counter("solver_iterations").inc(iters)
                        tel.histogram("solver_wall_seconds").observe(wall)
                self.grid_wall_seconds[lam] = wall
                w = res.w
                if on_solved is not None:
                    on_solved(lam, w)
                # The warm-start chain's crash/resume boundary: the point
                # is solved AND persisted, nothing of the next λ started.
                chaos_mod.maybe_fail("grid.point", reg_weight=float(lam))
            variances = variance_fn(w, lam) if variance_fn else None
            results.append((lam, self.make_model(w, variances), res))
            if warm_start:
                w_prev = w
        return results

    def run_grid(
        self,
        data: GlmData,
        reg_weights: Sequence[float],
        w0: Optional[Tensor] = None,
        l1_mask: Optional[Tensor] = None,
        warm_start: bool = True,
        solved: Optional[dict] = None,
        on_solved=None,
        bounds: Optional[tuple[Tensor, Tensor]] = None,
    ) -> list[tuple[float, GeneralizedLinearModel, Optional[SolveResult]]]:
        """Train one model per regularization weight (see :meth:`grid_loop`
        for the warm-start and checkpoint semantics)."""
        if bounds is not None and self.config.compute_variances:
            # solve()'s guard, raised before the grid touches the device.
            raise ValueError(
                "run_grid with bounds is incompatible with "
                "compute_variances=True: diag-inverse-Hessian variances "
                "assume an interior optimum (see solve())"
            )

        def solve_fn(lam, w_prev):
            return self.solve_single_device(data, lam, w_prev, l1_mask, bounds)

        variance_fn = None
        if self.config.compute_variances:
            def variance_fn(w, lam):
                return self.coefficient_variances(w, data, lam)

        return self.grid_loop(solve_fn, reg_weights, w0, warm_start,
                              solved, on_solved, variance_fn,
                              device=data.device)
