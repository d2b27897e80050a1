"""Hyperparameter search: random and Gaussian-process Bayesian optimization
(port of ``photon_ml_tpu/hyperparameter/search.py``, numpy and scipy only,
so the same code).

The analogue of Photon-ML's ``...ml.hyperparameter`` package:
``RandomSearch`` and ``GaussianProcessSearch`` — a GP
surrogate with a Matérn-5/2 kernel and expected-improvement acquisition —
proposing points in a bounded box (Photon-ML searches log-scaled
regularization weights the same way).  ``EvaluationFunction`` is just a
Python callable ``params -> metric`` here (Photon-ML wraps
GameEstimator.fit; drivers pass exactly that).

Pure NumPy: the GP fits over tens of observed points, far below device
scale.  Minimization convention — callers whose metric is
larger-is-better pass ``maximize=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class SearchResult:
    best_params: np.ndarray
    best_value: float
    history: list  # (params, value) tuples in evaluation order


class RandomSearch:
    """Uniform sampling in the (optionally log-scaled) box."""

    def __init__(
        self,
        bounds: Sequence[tuple[float, float]],
        log_scale: bool | Sequence[bool] = False,
        seed: int = 0,
    ):
        self.bounds = [(float(lo), float(hi)) for lo, hi in bounds]
        d = len(self.bounds)
        self.log_scale = (
            [bool(log_scale)] * d if isinstance(log_scale, bool) else list(log_scale)
        )
        self.rng = np.random.default_rng(seed)

    def _sample(self, n: int) -> np.ndarray:
        d = len(self.bounds)
        out = np.empty((n, d))
        for j, (lo, hi) in enumerate(self.bounds):
            if self.log_scale[j]:
                out[:, j] = np.exp(
                    self.rng.uniform(np.log(lo), np.log(hi), size=n)
                )
            else:
                out[:, j] = self.rng.uniform(lo, hi, size=n)
        return out

    def find(
        self,
        evaluate: Callable[[np.ndarray], float],
        n_iterations: int,
        maximize: bool = False,
    ) -> SearchResult:
        history = []
        for x in self._sample(n_iterations):
            history.append((x, float(evaluate(x))))
        sign = -1.0 if maximize else 1.0
        best = min(history, key=lambda h: sign * h[1])
        return SearchResult(best[0], best[1], history)


def _matern52(X1: np.ndarray, X2: np.ndarray, length_scale: float) -> np.ndarray:
    """Matérn-5/2 kernel, Photon-ML's GP covariance."""
    d = np.sqrt(
        np.maximum(
            np.sum(X1**2, 1)[:, None] + np.sum(X2**2, 1)[None, :]
            - 2.0 * X1 @ X2.T,
            0.0,
        )
    )
    s = np.sqrt(5.0) * d / length_scale
    return (1.0 + s + s**2 / 3.0) * np.exp(-s)


# Escalating diagonal jitter for a non-PD Gram matrix.  Repeated or
# near-repeated observed points (an ASHA sweep re-proposing a killed
# trial's region, a λ path with clustered weights) make the Matérn Gram
# numerically singular at tiny noise levels; each retry adds 100x more
# jitter before giving up.  The first rung (0.0) is the exact matrix.
_JITTER_LADDER = (0.0, 1e-10, 1e-8, 1e-6, 1e-4)


def _chol_with_jitter(K: np.ndarray) -> np.ndarray:
    for jitter in _JITTER_LADDER:
        try:
            if jitter:
                K = K.copy()
                K[np.diag_indices_from(K)] += jitter
            return np.linalg.cholesky(K)
        except np.linalg.LinAlgError:
            continue
    raise np.linalg.LinAlgError(
        "GP Gram matrix is not positive definite even with "
        f"{_JITTER_LADDER[-1]:g} diagonal jitter — observed points are "
        "degenerate (all identical?)"
    )


def _chol_lml(
    X: np.ndarray, y: np.ndarray, length_scale: float, noise: float
) -> tuple[np.ndarray, np.ndarray, float]:
    """Cholesky + α + log marginal likelihood for one (ℓ, σ²) setting."""
    K = _matern52(X, X, length_scale)
    K[np.diag_indices_from(K)] += noise
    L = _chol_with_jitter(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
    lml = (
        -0.5 * float(y @ alpha)
        - float(np.sum(np.log(np.diagonal(L))))
        - 0.5 * len(y) * np.log(2.0 * np.pi)
    )
    return L, alpha, lml


def _deduplicate(
    X: np.ndarray, y: np.ndarray, tol: float = 1e-9
) -> tuple[np.ndarray, np.ndarray]:
    """Merge (near-)repeated rows of X, averaging their targets.

    Two evaluations of the same point (priors fed back in, a proposer
    re-asking a boundary point) put two identical rows in the Gram
    matrix — exactly rank-deficient before noise.  Points within ``tol``
    Euclidean distance (inputs are normalized to [0,1]^d) collapse to
    their first representative with the mean target; N is tens, so the
    O(N²) scan is free next to one objective evaluation."""
    keep: list[int] = []
    groups: list[list[int]] = []
    for i in range(len(X)):
        for gi, k in enumerate(keep):
            if np.sum((X[i] - X[k]) ** 2) <= tol * tol:
                groups[gi].append(i)
                break
        else:
            keep.append(i)
            groups.append([i])
    if len(keep) == len(X):
        return X, y
    return X[keep], np.array([float(np.mean(y[g])) for g in groups])


# Hyperparameter grids for type-II maximum likelihood: inputs are
# normalized to [0,1]^d, so ℓ spans "nearly white" to "nearly flat", and
# targets are standardized, so σ² is relative to unit variance.
_LS_GRID = np.geomspace(0.05, 2.0, 24)
_NOISE_GRID = np.array([1e-6, 1e-4, 1e-2])


class GaussianProcessModel:
    """GP posterior over normalized inputs (Photon-ML's
    ``GaussianProcessModel``): zero mean, Matérn-5/2, observation noise.

    ``length_scale="fit"`` selects the kernel length scale (and the noise
    level) by maximizing the log marginal likelihood over a log-spaced
    grid at each :meth:`fit` — Photon-ML refits its GP kernel the same
    way per search iteration.  The grid is exact enough in 1-D/3-point
    noise space and costs ~70 Cholesky factorizations of a ≤tens-point
    kernel, i.e. nothing next to one real evaluation of the objective."""

    def __init__(self, length_scale: float | str = 0.3, noise: float = 1e-6):
        if not (length_scale == "fit" or isinstance(length_scale, (int, float))):
            raise ValueError(
                f"length_scale must be a float or 'fit', got {length_scale!r}"
            )
        self.length_scale = length_scale
        self.noise = noise
        self._X: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GaussianProcessModel":
        # De-duplicate BEFORE standardization: repeated rows make the
        # Gram matrix exactly singular, and the jitter ladder in
        # _chol_lml should be the fallback, not the steady state.
        self._X, y = _deduplicate(np.atleast_2d(X), np.asarray(y, float))
        self._y_mean = float(np.mean(y))
        self._y_std = float(np.std(y)) or 1.0
        self._y = (np.asarray(y, float) - self._y_mean) / self._y_std
        if self.length_scale == "fit":
            best = None
            for ls in _LS_GRID:
                for nz in _NOISE_GRID:
                    L, alpha, lml = _chol_lml(self._X, self._y, ls, nz)
                    if best is None or lml > best[0]:
                        best = (lml, ls, nz, L, alpha)
            _, self.fitted_length_scale, self.fitted_noise, self._L, \
                self._alpha = best
        else:
            self.fitted_length_scale = float(self.length_scale)
            self.fitted_noise = self.noise
            self._L, self._alpha, _ = _chol_lml(
                self._X, self._y, self.fitted_length_scale, self.fitted_noise
            )
        return self

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Posterior mean and standard deviation at X."""
        X = np.atleast_2d(X)
        ls = self.fitted_length_scale
        Ks = _matern52(X, self._X, ls)
        mean = Ks @ self._alpha
        v = np.linalg.solve(self._L, Ks.T)
        var = np.maximum(
            _matern52(X, X, ls).diagonal() - np.sum(v**2, 0),
            1e-12,
        )
        return (
            mean * self._y_std + self._y_mean,
            np.sqrt(var) * self._y_std,
        )


def expected_improvement(
    mean: np.ndarray, std: np.ndarray, best: float
) -> np.ndarray:
    """EI for MINIMIZATION: E[max(best - f, 0)]."""
    from scipy.stats import norm

    z = (best - mean) / std
    return (best - mean) * norm.cdf(z) + std * norm.pdf(z)


class GaussianProcessSearch(RandomSearch):
    """Reference: ``GaussianProcessSearch.findWithPriors`` — seed with a few
    random points, then repeatedly fit the GP and evaluate the EI-argmax of
    a candidate pool."""

    def __init__(
        self,
        bounds: Sequence[tuple[float, float]],
        log_scale: bool | Sequence[bool] = False,
        seed: int = 0,
        n_seed_points: int = 3,
        n_candidates: int = 512,
        length_scale: float | str = "fit",
    ):
        """``length_scale="fit"`` (default) re-selects the kernel length
        scale and noise by marginal likelihood at every GP refit; pass a
        float to pin them (round-2 behavior was a pinned 0.3)."""
        super().__init__(bounds, log_scale, seed)
        self.n_seed_points = n_seed_points
        self.n_candidates = n_candidates
        self.length_scale = length_scale

    def _normalize(self, X: np.ndarray) -> np.ndarray:
        """Map the (possibly log-scaled) box to [0,1]^d for the GP."""
        out = np.empty_like(X, dtype=float)
        for j, (lo, hi) in enumerate(self.bounds):
            if self.log_scale[j]:
                out[:, j] = (np.log(X[:, j]) - np.log(lo)) / (
                    np.log(hi) - np.log(lo)
                )
            else:
                out[:, j] = (X[:, j] - lo) / (hi - lo)
        return out

    def find(
        self,
        evaluate: Callable[[np.ndarray], float],
        n_iterations: int,
        maximize: bool = False,
        priors: Optional[list] = None,
    ) -> SearchResult:
        """``priors`` seeds the GP with already-evaluated (params, value)
        pairs (Photon-ML's findWithPriors — e.g. reuse the previous
        model-selection grid)."""
        sign = -1.0 if maximize else 1.0
        history: list = list(priors) if priors else []

        n_seed = max(0, min(self.n_seed_points - len(history), n_iterations))
        for x in self._sample(n_seed):
            history.append((x, float(evaluate(x))))

        remaining = n_iterations - n_seed
        for _ in range(remaining):
            X_obs = np.array([h[0] for h in history], float)
            y_obs = np.array([sign * h[1] for h in history], float)
            gp = GaussianProcessModel(self.length_scale).fit(
                self._normalize(X_obs), y_obs
            )
            candidates = self._sample(self.n_candidates)
            mean, std = gp.predict(self._normalize(candidates))
            ei = expected_improvement(mean, std, float(np.min(y_obs)))
            x_next = candidates[int(np.argmax(ei))]
            history.append((x_next, float(evaluate(x_next))))

        best = min(history, key=lambda h: sign * h[1])
        return SearchResult(np.asarray(best[0]), best[1], history)
