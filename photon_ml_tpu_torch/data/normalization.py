"""Feature normalization without touching the data (port of
``photon_ml_tpu/data/normalization.py``).

Training runs in a *scaled* coefficient space while the sparse data stays
unscaled.  For scaled feature x'ⱼ = (xⱼ - shiftⱼ)·factorⱼ the margin of
scaled-space coefficients w is

    m = Σⱼ wⱼ·factorⱼ·xⱼ  -  Σⱼ wⱼ·factorⱼ·shiftⱼ

so the objective needs only component-wise coefficient scaling and a scalar
margin correction.  Shifts require an intercept (as in the reference).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device, to_numpy
from photon_ml_tpu_torch.ops import ordered

Tensor = torch.Tensor


class NormalizationType(enum.Enum):
    NONE = "none"
    SCALE_WITH_STANDARD_DEVIATION = "scale_with_standard_deviation"
    SCALE_WITH_MAX_MAGNITUDE = "scale_with_max_magnitude"
    STANDARDIZATION = "standardization"


@dataclasses.dataclass
class NormalizationContext:
    """``factors`` / ``shifts`` have shape (n_features,); ``intercept_index``
    is the constant-1 intercept column (or None), whose factor is 1 and
    shift 0 by construction."""

    factors: Tensor
    shifts: Tensor
    intercept_index: Optional[int] = None

    def model_to_original(self, w_model: Tensor) -> Tensor:
        """Map scaled-space coefficients to original-space coefficients."""
        w = w_model * self.factors
        if self.intercept_index is not None:
            corr = -ordered.dot(w_model, self.factors * self.shifts)
            w = w.clone()
            w[self.intercept_index] += corr
        return w

    def original_to_model(self, w_orig: Tensor) -> Tensor:
        """Inverse of :meth:`model_to_original` (factors must be nonzero)."""
        w = w_orig / self.factors
        if self.intercept_index is not None:
            corr = -ordered.dot(w, self.factors * self.shifts)
            i = self.intercept_index
            w = w.clone()
            w[i] += -corr / self.factors[i]
        return w

    @staticmethod
    def identity(n_features: int, device=None) -> "NormalizationContext":
        dev = resolve_device(device)
        return NormalizationContext(
            factors=torch.ones(n_features, dtype=torch.float32, device=dev),
            shifts=torch.zeros(n_features, dtype=torch.float32, device=dev),
            intercept_index=None,
        )


def build_normalization(
    norm_type: NormalizationType,
    summary,  # BasicStatisticalSummary (data/stats.py); duck-typed
    intercept_index: Optional[int] = None,
    device=None,
) -> NormalizationContext:
    """Build a NormalizationContext from per-feature summary statistics
    (the reference's ``NormalizationContext(type, summary, interceptId)``).
    The context lives on ``device`` (default: the summary's device when it
    holds tensors, else CUDA)."""
    mean = to_numpy(summary.mean).astype(np.float32)
    std = np.sqrt(to_numpy(summary.variance).astype(np.float32))
    max_mag = np.maximum(
        np.abs(to_numpy(summary.max).astype(np.float32)),
        np.abs(to_numpy(summary.min).astype(np.float32)),
    )
    n = mean.shape[0]
    factors = np.ones(n, np.float32)
    shifts = np.zeros(n, np.float32)

    if norm_type is NormalizationType.NONE:
        pass
    elif norm_type is NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors = 1.0 / np.where(std > 0, std, 1.0)
    elif norm_type is NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors = 1.0 / np.where(max_mag > 0, max_mag, 1.0)
    elif norm_type is NormalizationType.STANDARDIZATION:
        if intercept_index is None:
            raise ValueError(
                "STANDARDIZATION requires an intercept term (as in the reference)"
            )
        factors = 1.0 / np.where(std > 0, std, 1.0)
        shifts = mean.copy()
    else:
        raise ValueError(f"unknown normalization type {norm_type}")

    if intercept_index is not None:
        factors[intercept_index] = 1.0
        shifts[intercept_index] = 0.0

    if device is None and isinstance(summary.mean, Tensor):
        device = summary.mean.device
    dev = resolve_device(device)
    return NormalizationContext(
        factors=torch.as_tensor(factors.astype(np.float32), device=dev),
        shifts=torch.as_tensor(shifts.astype(np.float32), device=dev),
        intercept_index=intercept_index,
    )
