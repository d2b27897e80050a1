"""Evaluation suites (port of ``photon_ml_tpu/evaluation/suite.py``).

An ordered name→``Evaluator`` mapping evaluated together on one score
pass, with a designated primary metric that drives model selection (the
reference selects by the first configured evaluator).  ``group_column``
names an id column whose values group rows for the per-group evaluators
(per-query AUC, precision@k); grouped metrics are host-side, so a grouped
suite refuses :meth:`EvaluationSuite.evaluate_device`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.evaluation.evaluators import (
    Evaluator,
    default_evaluator_for_task,
    get_evaluator,
)


@dataclasses.dataclass(frozen=True)
class EvaluationSuite:
    """Ordered collection of named evaluators; ``primary`` drives selection."""

    evaluators: tuple  # tuple[(name, Evaluator), ...] — ordered
    primary: str
    #: id column whose values group rows for per-group evaluators; None
    #: evaluates globally.
    group_column: Optional[str] = None

    def __post_init__(self):
        names = [n for n, _ in self.evaluators]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate evaluator names: {names}")
        if self.primary not in names:
            raise ValueError(
                f"primary {self.primary!r} not among evaluators {names}"
            )

    @classmethod
    def from_specs(
        cls,
        specs: Sequence[Union[str, Evaluator]],
        primary: Optional[str] = None,
        group_column: Optional[str] = None,
    ) -> "EvaluationSuite":
        """Build from spec strings (``"auc"``, ``"precision@5"``, ...) or
        ``Evaluator`` instances; primary defaults to the first."""
        pairs = []
        for spec in specs:
            if isinstance(spec, Evaluator):
                pairs.append((type(spec).__name__, spec))
            else:
                pairs.append((str(spec).strip().lower(), get_evaluator(spec)))
        if not pairs:
            raise ValueError("EvaluationSuite requires at least one evaluator")
        return cls(
            evaluators=tuple(pairs),
            primary=primary if primary is not None else pairs[0][0],
            group_column=group_column,
        )

    @classmethod
    def for_task(cls, task: str) -> "EvaluationSuite":
        ev = default_evaluator_for_task(task)
        return cls(evaluators=((type(ev).__name__, ev),),
                   primary=type(ev).__name__)

    @property
    def primary_evaluator(self) -> Evaluator:
        return dict(self.evaluators)[self.primary]

    def evaluate(self, scores, labels, weights=None, group_ids=None) -> dict:
        """name → metric value, every evaluator on one host score pass."""
        with telemetry_mod.current().span(
            "evaluation",
            evaluators=[n for n, _ in self.evaluators],
            grouped=group_ids is not None,
            rows=len(scores),
        ):
            return {
                name: ev.evaluate(scores, labels, weights, group_ids)
                for name, ev in self.evaluators
            }

    def evaluate_primary(self, scores, labels, weights=None,
                         group_ids=None) -> tuple[float, dict]:
        """(primary metric, full name→value dict) from one score pass."""
        values = self.evaluate(scores, labels, weights, group_ids)
        return values[self.primary], values

    def evaluate_device(self, scores, labels, weights=None,
                        materialize: bool = True) -> dict:
        """name → metric value computed on the scores' device; only scalars
        come back.  Evaluators with no device implementation (precision@k)
        share ONE host pullback.  A grouped suite must use
        :meth:`evaluate`: per-group metrics are host-side.
        ``materialize=False`` leaves the device metrics as 0-d tensors for
        the caller's batched readback."""
        if self.group_column is not None:
            raise ValueError(
                "evaluate_device computes GLOBAL metrics; this suite has "
                f"group_column={self.group_column!r} — use evaluate()"
            )
        from photon_ml_tpu_torch.evaluation.device import device_evaluator_fn

        # The span covers the DISPATCH wall when materialize=False (the
        # device metrics are read back later, in the descent's batched
        # flush).
        with telemetry_mod.current().span(
            "evaluation",
            evaluators=[n for n, _ in self.evaluators],
            device=True,
            materialize=materialize,
        ):
            out = {}
            host_pull = None
            for name, ev in self.evaluators:
                fn = device_evaluator_fn(ev)
                if fn is not None:
                    m = fn(scores, labels, weights)
                    out[name] = float(m) if materialize else m
                    continue
                if host_pull is None:
                    host_pull = tuple(
                        None if a is None else a.detach().cpu().numpy()
                        for a in (scores, labels, weights)
                    )
                out[name] = ev.evaluate(*host_pull)
            return out

    def better_than(self, a: Optional[float], b: Optional[float]) -> bool:
        """Compare two PRIMARY metric values; None/NaN always loses."""
        if a is None or np.isnan(a):
            return False
        if b is None or np.isnan(b):
            return True
        return self.primary_evaluator.better_than(a, b)
