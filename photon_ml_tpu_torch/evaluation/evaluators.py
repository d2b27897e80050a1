"""Validation metrics (port of ``photon_ml_tpu/evaluation/evaluators.py``,
numpy only, copied so the port never imports the JAX package).

The analogue of the reference's ``...ml.evaluation`` package —
``Evaluator`` / ``EvaluatorType`` with AUC, RMSE, logistic loss, Poisson
loss, squared loss, and grouped (sharded) variants such as per-query AUC and
precision@k (SURVEY.md §2, Evaluation).  Evaluators drive model selection
across the regularization grid, so each knows its improvement direction
(``better_than``), exactly as the reference's do.

Host-side NumPy: the reference evaluates via Spark jobs on the cluster;
here scores come back from the device once per validation pass and the
metric itself is cheap.  Rows with ``weight == 0`` (padding) are excluded
everywhere.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class EvaluatorType(enum.Enum):
    AUC = "auc"
    RMSE = "rmse"
    LOGISTIC_LOSS = "logistic_loss"
    POISSON_LOSS = "poisson_loss"
    SQUARED_LOSS = "squared_loss"
    PRECISION_AT_K = "precision_at_k"


@dataclasses.dataclass(frozen=True)
class Evaluator:
    """Base evaluator; subclasses implement :meth:`_compute` on cleaned
    (nonzero-weight) arrays of scores / labels / weights."""

    #: larger-is-better metrics flip the comparison (reference:
    #: ``Evaluator.betterThan``).
    larger_is_better: bool = dataclasses.field(default=False, init=False)

    def evaluate(
        self,
        scores: np.ndarray,
        labels: np.ndarray,
        weights: Optional[np.ndarray] = None,
        group_ids: Optional[np.ndarray] = None,
    ) -> float:
        scores = np.asarray(scores, np.float64)
        labels = np.asarray(labels, np.float64)
        w = (
            np.ones_like(scores)
            if weights is None
            else np.asarray(weights, np.float64)
        )
        mask = w > 0
        g = None if group_ids is None else np.asarray(group_ids)[mask]
        return float(self._compute(scores[mask], labels[mask], w[mask], g))

    def better_than(self, a: float, b: float) -> bool:
        return a > b if self.larger_is_better else a < b

    def _compute(self, scores, labels, weights, group_ids) -> float:
        raise NotImplementedError


def _auc(scores, labels, weights) -> float:
    """Weighted AUC with tie averaging (trapezoidal ROC)."""
    pos_w = np.sum(weights * labels)
    neg_w = np.sum(weights * (1.0 - labels))
    if pos_w == 0 or neg_w == 0:
        return float("nan")
    order = np.argsort(scores, kind="stable")
    s, y, w = scores[order], labels[order], weights[order]
    wp = w * y
    wn = w * (1.0 - y)
    # For each tie group: pairs against strictly-lower negatives count 1,
    # within-group pairs count 1/2.
    cum_neg = np.concatenate([[0.0], np.cumsum(wn)])
    boundaries = np.concatenate([[True], s[1:] != s[:-1]])
    group_id = np.cumsum(boundaries) - 1
    group_start = np.flatnonzero(boundaries)
    neg_below = cum_neg[group_start][group_id]  # neg weight strictly below
    group_neg = np.add.reduceat(wn, group_start)[group_id]
    contrib = wp * (neg_below + 0.5 * group_neg)
    return float(np.sum(contrib) / (pos_w * neg_w))


def _grouped_auc_mean(scores, labels, weights, group_ids) -> float:
    """Unweighted mean of per-group weighted AUCs, fully vectorized.

    One lexsort by (group, score) plus segment reductions replaces the
    per-group Python loop — at 10⁵ per-query groups (MovieLens-scale) the
    loop costs minutes, this costs one sort.  Math per group is identical
    to :func:`_auc` (tie averaging included); groups lacking both classes
    are skipped, as the reference does."""
    if len(scores) == 0:  # all rows masked (e.g. zero weights)
        return float("nan")
    _, gidx = np.unique(group_ids, return_inverse=True)
    order = np.lexsort((scores, gidx))  # group-major, score ascending
    g = gidx[order]
    s = scores[order]
    y = labels[order]
    w = weights[order]
    wp = w * y
    wn = w * (1.0 - y)

    gb = np.concatenate([[True], g[1:] != g[:-1]])      # group starts
    g_start = np.flatnonzero(gb)
    cum_wn = np.concatenate([[0.0], np.cumsum(wn)])     # before each row
    base_wn = cum_wn[g_start]                           # at group start
    row_group = np.cumsum(gb) - 1                       # dense group seq

    # Tie groups are (group, score) runs; negatives strictly below a tie
    # group are group-LOCAL: global prefix minus the group's base.
    tb = np.concatenate([[True], (g[1:] != g[:-1]) | (s[1:] != s[:-1])])
    t_start = np.flatnonzero(tb)
    t_id = np.cumsum(tb) - 1
    neg_below = cum_wn[t_start][t_id] - base_wn[row_group]
    tie_neg = np.add.reduceat(wn, t_start)[t_id]
    contrib = wp * (neg_below + 0.5 * tie_neg)

    contrib_g = np.add.reduceat(contrib, g_start)
    pos_g = np.add.reduceat(wp, g_start)
    neg_g = np.add.reduceat(wn, g_start)
    valid = (pos_g > 0) & (neg_g > 0)
    if not np.any(valid):
        return float("nan")
    return float(np.mean(contrib_g[valid] / (pos_g[valid] * neg_g[valid])))


@dataclasses.dataclass(frozen=True)
class AreaUnderROCCurveEvaluator(Evaluator):
    """AUC; with ``group_ids`` given, the unweighted mean of per-group AUCs
    (the reference's sharded/per-query ``MultiAUC``).  Groups lacking both
    classes are skipped, as the reference does."""

    larger_is_better: bool = dataclasses.field(default=True, init=False)

    def _compute(self, scores, labels, weights, group_ids) -> float:
        if group_ids is None:
            return _auc(scores, labels, weights)
        return _grouped_auc_mean(scores, labels, weights, group_ids)


@dataclasses.dataclass(frozen=True)
class RMSEEvaluator(Evaluator):
    def _compute(self, scores, labels, weights, group_ids) -> float:
        r = scores - labels
        return float(np.sqrt(np.sum(weights * r * r) / np.sum(weights)))


@dataclasses.dataclass(frozen=True)
class SquaredLossEvaluator(Evaluator):
    def _compute(self, scores, labels, weights, group_ids) -> float:
        r = scores - labels
        return float(np.sum(weights * 0.5 * r * r))


@dataclasses.dataclass(frozen=True)
class LogisticLossEvaluator(Evaluator):
    """Mean weighted negative log-likelihood of {0,1} labels given margins."""

    def _compute(self, scores, labels, weights, group_ids) -> float:
        loss = np.logaddexp(0.0, scores) - labels * scores
        return float(np.sum(weights * loss) / np.sum(weights))


@dataclasses.dataclass(frozen=True)
class PoissonLossEvaluator(Evaluator):
    """Mean weighted Poisson NLL (up to the label-only constant) of margins."""

    def _compute(self, scores, labels, weights, group_ids) -> float:
        loss = np.exp(scores) - labels * scores
        return float(np.sum(weights * loss) / np.sum(weights))


@dataclasses.dataclass(frozen=True)
class PrecisionAtKEvaluator(Evaluator):
    """Precision@k within each group, averaged over groups (the reference's
    per-query precision@1/3/5/10 evaluators require a group id column)."""

    k: int = 1
    larger_is_better: bool = dataclasses.field(default=True, init=False)

    def _compute(self, scores, labels, weights, group_ids) -> float:
        if group_ids is None:
            raise ValueError("precision@k requires group_ids (per-query metric)")
        # Vectorized over groups: one lexsort by (group, score desc) and
        # segment reductions (the per-group argsort loop costs minutes at
        # 10⁵ per-query groups).  lexsort is stable, so ties keep original
        # order exactly like the per-group stable argsort did.
        if len(scores) == 0:  # all rows masked (e.g. zero weights)
            return float("nan")
        _, gidx = np.unique(group_ids, return_inverse=True)
        order = np.lexsort((-scores, gidx))
        g = gidx[order]
        y = labels[order]
        gb = np.concatenate([[True], g[1:] != g[:-1]])
        g_start = np.flatnonzero(gb)
        row_group = np.cumsum(gb) - 1
        pos_in_group = np.arange(len(g)) - g_start[row_group]
        sizes = np.diff(np.append(g_start, len(g)))
        k_eff = np.minimum(self.k, sizes)
        in_top = pos_in_group < self.k
        hits_g = np.add.reduceat(
            np.where(in_top, (y > 0).astype(np.float64), 0.0), g_start
        )
        return float(np.mean(hits_g / k_eff))


def get_evaluator(spec: str) -> Evaluator:
    """Parse an evaluator spec string as the reference's CLI does:
    ``AUC``, ``RMSE``, ``LOGISTIC_LOSS``, ``POISSON_LOSS``, ``SQUARED_LOSS``,
    or ``PRECISION@k`` (e.g. ``precision@5``)."""
    key = spec.strip().lower()
    if key.startswith("precision@"):
        return PrecisionAtKEvaluator(k=int(key.split("@", 1)[1]))
    table = {
        "auc": AreaUnderROCCurveEvaluator,
        "rmse": RMSEEvaluator,
        "logistic_loss": LogisticLossEvaluator,
        "logisticloss": LogisticLossEvaluator,
        "poisson_loss": PoissonLossEvaluator,
        "poissonloss": PoissonLossEvaluator,
        "squared_loss": SquaredLossEvaluator,
        "squaredloss": SquaredLossEvaluator,
    }
    if key not in table:
        raise KeyError(f"unknown evaluator {spec!r}; available: {sorted(table)}")
    return table[key]()


def default_evaluator_for_task(task: str) -> Evaluator:
    """Task-type default metric, as the reference's drivers choose."""
    return {
        "logistic": AreaUnderROCCurveEvaluator(),
        "squared": RMSEEvaluator(),
        "poisson": PoissonLossEvaluator(),
        "smoothed_hinge": AreaUnderROCCurveEvaluator(),
    }[task]
