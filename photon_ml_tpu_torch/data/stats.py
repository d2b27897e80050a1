"""Per-feature summary statistics (port of ``photon_ml_tpu/data/stats.py``).

Weighted per-feature mean, variance, min, max and nonzero counts.  The
moments are two column reductions of the feature matrix (``rmatvec`` and
``sq_rmatvec`` — on the kernel-backed matrix, two launches of the CUDA
SpMV); counts and ranges are cold host paths.  Feeds normalization and the
driver's feature-summary artifacts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_tpu_torch.data.dataset import GlmData

Tensor = torch.Tensor


@dataclasses.dataclass
class BasicStatisticalSummary:
    mean: object  # (n_features,) weighted mean
    variance: object  # (n_features,) weighted (population) variance
    min: object  # (n_features,)
    max: object  # (n_features,)
    nnz: object  # (n_features,) int32 — unweighted nonzero counts
    count: object  # scalar — total weight


def summarize(data: GlmData) -> BasicStatisticalSummary:
    """One-pass weighted feature summary on the data's device."""
    X = data.features
    w = data.weights
    w_sum = w.sum()
    s1 = X.rmatvec(w)  # Σ w·x per feature
    s2 = X.sq_rmatvec(w)  # Σ w·x² per feature
    # Padding rows (weight 0) must not leak their zeros into nnz/min/max.
    row_mask = w > 0
    nnz = X.col_nnz(row_mask)
    mins, maxs = X.col_min_max(row_mask)
    denom = torch.clamp(w_sum, min=1e-30)
    mean = s1 / denom
    variance = torch.clamp(s2 / denom - mean * mean, min=0.0)
    return BasicStatisticalSummary(
        mean=mean, variance=variance, min=mins, max=maxs, nnz=nnz, count=w_sum
    )


def summarize_host(X, weights=None) -> BasicStatisticalSummary:
    """Host-side (numpy/scipy) summary of a raw feature matrix.  Same
    semantics as :func:`summarize`: weighted moments over all rows,
    nnz/min/max over live (weight > 0) rows folded with implicit zeros."""
    import scipy.sparse as sp

    n, d = X.shape
    w = (
        np.ones(n, np.float64) if weights is None
        else np.asarray(weights, np.float64)
    )
    w_sum = float(w.sum())
    if sp.issparse(X):
        csr = X.tocsr()
        csr.sum_duplicates()
        coo = csr.tocoo()
        rows, cols, vals = coo.row, coo.col, coo.data.astype(np.float64)
        wv = w[rows] * vals
        s1 = np.bincount(cols, weights=wv, minlength=d)
        s2 = np.bincount(cols, weights=wv * vals, minlength=d)
        live = (vals != 0) & (w[rows] > 0)
        c, v = cols[live], vals[live]
        nnz = np.bincount(c, minlength=d)
        mins = np.full(d, np.inf)
        maxs = np.full(d, -np.inf)
        np.minimum.at(mins, c, v)
        np.maximum.at(maxs, c, v)
        n_live = int(np.sum(w > 0))
        has_zero = nnz < n_live
        mins = np.where(has_zero, np.minimum(mins, 0.0), mins)
        maxs = np.where(has_zero, np.maximum(maxs, 0.0), maxs)
    else:
        dense = np.asarray(X, np.float64)
        s1 = w @ dense
        s2 = w @ (dense * dense)
        live = dense[w > 0]
        nnz = np.count_nonzero(live, axis=0)
        mins = live.min(axis=0) if live.shape[0] else np.zeros(d)
        maxs = live.max(axis=0) if live.shape[0] else np.zeros(d)
    mean = s1 / max(w_sum, 1e-12)
    variance = np.maximum(s2 / max(w_sum, 1e-12) - mean * mean, 0.0)
    return BasicStatisticalSummary(
        mean=mean.astype(np.float64),
        variance=variance,
        min=np.asarray(mins, np.float64),
        max=np.asarray(maxs, np.float64),
        nnz=np.asarray(nnz, np.int32),
        count=np.float64(w_sum),
    )


def entity_shape_histogram(
    row_counts, col_counts, max_entities: int = 500_000, seed: int = 0
):
    """Distinct per-entity (row count, active-feature count) shapes with
    multiplicities — the summary the GAME entity repacker plans buckets
    from (``game/data.py``).

    Returns ``(shapes, counts, inverse)``: ``shapes`` is ``(K, 2)`` int64
    sorted lexicographically, ``counts[k]`` how many entities have shape
    k, and ``inverse[e]`` each entity's shape index.  Column counts clamp
    to >= 1 (an entity with no active features still occupies a 1-wide
    lane).  Above ``max_entities`` the multiplicities are estimated from a
    seeded uniform subsample (scaled back up); ``inverse`` still covers
    every entity, so assignment stays exact and only the cost estimates
    coarsen.
    """
    rows = np.asarray(row_counts, np.int64)
    cols = np.maximum(np.asarray(col_counts, np.int64), 1)
    pairs = np.stack([rows, cols], axis=1)
    shapes, inverse, counts = np.unique(
        pairs, axis=0, return_inverse=True, return_counts=True
    )
    n_ent = len(rows)
    if n_ent > max_entities:
        rng = np.random.default_rng(seed)
        sample = rng.choice(n_ent, size=max_entities, replace=False)
        sample_counts = np.bincount(
            inverse[sample], minlength=len(shapes)
        ).astype(np.float64)
        scale = n_ent / max_entities
        counts = np.maximum(
            np.round(sample_counts * scale), 1
        ).astype(np.int64)
    return shapes.astype(np.int64), counts.astype(np.int64), inverse
