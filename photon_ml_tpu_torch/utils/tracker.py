"""Convergence-trace bookkeeping.

The analogue of the reference's ``OptimizationStatesTracker`` (SURVEY.md §5.1):
per-iteration objective value and gradient norm for each optimizer run.  The
solver records these into the fixed-size nan-padded arrays of
``SolveResult`` (optim/lbfgs.py); this class turns them into the
human-readable trace the reference logs, plus wall-clock attribution.  A
λ restored from a grid checkpoint has no solve (``res=None``) and gives an
empty trace marked ``restored``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class OptimizationStatesTracker:
    values: np.ndarray  # (iterations+1,)
    grad_norms: np.ndarray  # (iterations+1,)
    iterations: int
    converged: bool
    wall_seconds: float = float("nan")
    # The solver's stall flag where it reports one (SPG), else None.
    stalled: Optional[bool] = None
    restored: bool = False

    @staticmethod
    def from_solve_result(res, wall_seconds: float = float("nan")):
        from photon_ml_tpu_torch.device import to_numpy

        if res is None:
            return OptimizationStatesTracker(
                values=np.zeros(0), grad_norms=np.zeros(0), iterations=0,
                converged=False, wall_seconds=wall_seconds, restored=True,
            )
        values = to_numpy(res.values).astype(np.float64)
        keep = ~np.isnan(values)
        # Block CD's "norms" are its per-round objective changes: one
        # fewer than its values.
        grad_norms = to_numpy(res.grad_norms).astype(np.float64)
        return OptimizationStatesTracker(
            values=values[keep],
            grad_norms=grad_norms[keep[:grad_norms.size]],
            iterations=int(res.iterations),
            converged=bool(res.converged),
            wall_seconds=wall_seconds,
            stalled=None if res.stalled is None else bool(res.stalled),
        )

    def summary(self) -> str:
        if self.restored:
            return "restored from checkpoint (no solve)"
        lines = [
            f"iter {i:4d}: value={v:.8g} |grad|={g:.4g}"
            for i, (v, g) in enumerate(zip(self.values, self.grad_norms))
        ]
        status = "converged" if self.converged else "NOT converged"
        if self.stalled:
            status += " (stalled)"
        lines.append(
            f"{status} after {self.iterations} iterations"
            + (
                f" in {self.wall_seconds:.3f}s"
                if not np.isnan(self.wall_seconds)
                else ""
            )
        )
        return "\n".join(lines)
