"""Device-side metric computation (port of
``photon_ml_tpu/evaluation/device.py``).

The host evaluators (``evaluation/evaluators.py``) pull scores back and
compute in NumPy; these compute on the scores' device and return 0-d
tensors, so a coordinate-descent update reads back scalars only:

- pointwise losses (logistic / poisson / squared / rmse): one weighted
  reduction;
- weighted AUC with tie handling, from one stable sort.  The tie groups are
  contiguous after the sort, so each group's negative weight is a
  difference of one cumulative sum at its boundaries and its first index
  comes from the boundary mask: no segment reduction and no atomics, so the
  result is deterministic.  It computes in float64, as the reference does
  under x64 and as the host evaluator does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.ops import ordered

Tensor = torch.Tensor


def _weighted_per_row(scores, labels, weights, kind):
    """Shared per-row loss for the whole-array metric and the streaming
    partial.  Rows with w <= 0 get weight 0 AND a zero term, so ``0 * inf``
    from an overflowing masked row cannot poison the sum."""
    scores = scores.to(torch.float32)
    labels = labels.to(torch.float32)
    w = torch.ones_like(scores) if weights is None else weights.to(
        torch.float32)
    w = torch.where(w > 0, w, 0.0)
    if kind == "logistic_loss":
        per_row = torch.logaddexp(torch.zeros_like(scores), scores) \
            - labels * scores
    elif kind == "poisson_loss":
        per_row = ordered.exp(scores) - labels * scores
    elif kind in ("squared_loss", "rmse"):
        r = scores - labels
        per_row = (0.5 if kind == "squared_loss" else 1.0) * r * r
    else:
        raise ValueError(f"unknown device metric kind {kind!r}")
    return torch.where(w > 0, w * per_row, 0.0), w


def device_pointwise_metric(
    scores: Tensor,
    labels: Tensor,
    weights: Optional[Tensor] = None,
    kind: str = "logistic_loss",
) -> Tensor:
    """Weighted mean pointwise metric on the scores' device.  ``kind``:
    ``logistic_loss`` | ``poisson_loss`` | ``squared_loss`` (a SUM, as the
    reference's) | ``rmse``.  Zero-weight rows drop out."""
    wpr, w = _weighted_per_row(scores, labels, weights, kind)
    num = wpr.sum()
    den = w.sum()
    if kind == "squared_loss":
        return num
    out = num / den
    return ordered.sqrt(out) if kind == "rmse" else out


def device_evaluator_fn(evaluator):
    """Map a host evaluator to its device counterpart — ``callable(scores,
    labels, weights) → 0-d tensor`` — or None when there is none.  These
    run the GLOBAL metric; grouped evaluation stays on the host."""
    name = type(evaluator).__name__
    if name == "AreaUnderROCCurveEvaluator":
        return lambda s, y, w: device_auc(s, y, w)
    kind = pointwise_kind_for(evaluator)
    if kind is None:
        return None
    return lambda s, y, w: device_pointwise_metric(s, y, w, kind=kind)


def device_pointwise_partial(
    scores: Tensor,
    labels: Tensor,
    weights: Optional[Tensor] = None,
    kind: str = "logistic_loss",
) -> tuple[Tensor, Tensor]:
    """One block's (weighted-sum, weight-sum) contribution for ``kind``;
    :func:`finish_pointwise_partial` turns the running totals into the
    metric."""
    wpr, w = _weighted_per_row(scores, labels, weights, kind)
    return wpr.sum(), w.sum()


def finish_pointwise_partial(num: float, den: float, kind: str) -> float:
    if kind == "squared_loss":
        return float(num)
    if den == 0:  # zero rows / all-masked: the host path's NaN, not a crash
        return float("nan")
    out = num / den
    return float(np.sqrt(out)) if kind == "rmse" else float(out)


def pointwise_kind_for(evaluator) -> Optional[str]:
    """The accumulable kind for a host evaluator, or None (AUC needs a
    global sort)."""
    return {
        "RMSEEvaluator": "rmse",
        "SquaredLossEvaluator": "squared_loss",
        "LogisticLossEvaluator": "logistic_loss",
        "PoissonLossEvaluator": "poisson_loss",
    }.get(type(evaluator).__name__)


def device_auc(
    scores: Tensor, labels: Tensor, weights: Optional[Tensor] = None
) -> Tensor:
    """Weighted AUC with tie averaging on the scores' device, in float64.

    Same math as the host evaluator: for each tie group, pairs against
    strictly-lower negatives count 1, within-group pairs count ½.
    Zero-weight rows are excluded.  NaN when a class is missing.
    """
    scores = scores.to(torch.float64)
    labels = labels.to(torch.float64)
    w = torch.ones_like(scores) if weights is None else weights.to(
        torch.float64)
    w = torch.where(w > 0, w, 0.0)

    s, order = torch.sort(scores, stable=True)
    y = labels[order]
    ws = w[order]
    wp = ws * y
    wn = ws * (1.0 - y)
    pos_w = wp.sum()
    neg_w = wn.sum()

    n = s.shape[0]
    cum_neg = torch.cat([wn.new_zeros(1), torch.cumsum(wn, 0)])  # (n + 1,)
    boundary = torch.ones(n, dtype=torch.bool, device=s.device)
    boundary[1:] = s[1:] != s[:-1]
    idx = torch.arange(n, device=s.device)
    # Each row's group start: the last boundary at or before it.  Its
    # group's end: the first boundary after it (or n).
    start = torch.cummax(torch.where(boundary, idx, 0), 0).values
    nxt = torch.full((n,), n, dtype=idx.dtype, device=s.device)
    nxt[:-1] = torch.where(boundary[1:], idx[1:], n)
    end = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    neg_below = cum_neg[start]
    group_neg = cum_neg[end] - neg_below
    auc = (wp * (neg_below + 0.5 * group_neg)).sum() / (pos_w * neg_w)
    return torch.where((pos_w == 0) | (neg_w == 0),
                       torch.full_like(auc, float("nan")), auc)
