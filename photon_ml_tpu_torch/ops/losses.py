"""Pointwise GLM loss functions (port of ``photon_ml_tpu/ops/losses.py``).

Each loss exposes the per-example value and its first and second
derivatives with respect to the margin ``m = <w, x> + offset``, so the
objective's gradient and Hessian-vector product factor as

    grad   = Xᵀ (weight ⊙ d1(m, y))
    H @ v  = Xᵀ (weight ⊙ d2(m, y) ⊙ (X @ v))

and the hot loop is two sparse mat-vecs.  All functions are elementwise on
tensors of any device.  Labels follow the reference: ``{0, 1}`` for logistic
and smoothed hinge, nonnegative counts for Poisson, reals for squared loss.
Softplus is ``logaddexp(m, 0)`` and the sigmoid is ``torch.sigmoid``, both
stable at margins of any size.  Poisson's ``exp`` is ``ops/ordered.py``'s:
on the CPU ATen's ``torch.exp`` calls MKL's vector math library, whose
bits depend on the CPU's vendor (its ``sigmoid`` and ``logaddexp`` are
ATen's own).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_ml_tpu_torch.ops import ordered

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A pointwise loss ℓ(m, y) with derivatives taken w.r.t. the margin m.

    Attributes:
      name: stable identifier used by configs and model metadata.
      value: ℓ(m, y) per example.
      d1: ∂ℓ/∂m per example.
      d2: ∂²ℓ/∂m² per example (nonnegative for convex losses).
      mean_fn: the inverse link used at scoring time.
    """

    name: str
    value: Callable[[Tensor, Tensor], Tensor]
    d1: Callable[[Tensor, Tensor], Tensor]
    d2: Callable[[Tensor, Tensor], Tensor]
    mean_fn: Callable[[Tensor], Tensor]

    def value_d1(self, margin: Tensor, label: Tensor) -> tuple[Tensor, Tensor]:
        return self.value(margin, label), self.d1(margin, label)


# Logistic loss (labels in {0, 1}):
#   ℓ = softplus(m) - y·m,  ∂ℓ/∂m = σ(m) - y,  ∂²ℓ/∂m² = σ(m)(1 - σ(m))

def _softplus(x: Tensor) -> Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _logistic_value(margin: Tensor, label: Tensor) -> Tensor:
    return _softplus(margin) - label * margin


def _logistic_d1(margin: Tensor, label: Tensor) -> Tensor:
    return torch.sigmoid(margin) - label


def _logistic_d2(margin: Tensor, label: Tensor) -> Tensor:
    p = torch.sigmoid(margin)
    return p * (1.0 - p)


logistic = PointwiseLoss(
    name="logistic",
    value=_logistic_value,
    d1=_logistic_d1,
    d2=_logistic_d2,
    mean_fn=torch.sigmoid,
)


# Squared loss: ℓ = ½(m - y)²

def _squared_value(margin: Tensor, label: Tensor) -> Tensor:
    r = margin - label
    return 0.5 * r * r


def _squared_d1(margin: Tensor, label: Tensor) -> Tensor:
    return margin - label


def _squared_d2(margin: Tensor, label: Tensor) -> Tensor:
    return torch.ones_like(margin)


squared = PointwiseLoss(
    name="squared",
    value=_squared_value,
    d1=_squared_d1,
    d2=_squared_d2,
    mean_fn=lambda m: m,
)


# Poisson loss (log link): ℓ = exp(m) - y·m

def _poisson_value(margin: Tensor, label: Tensor) -> Tensor:
    return ordered.exp(margin) - label * margin


def _poisson_d1(margin: Tensor, label: Tensor) -> Tensor:
    return ordered.exp(margin) - label


def _poisson_d2(margin: Tensor, label: Tensor) -> Tensor:
    return ordered.exp(margin)


poisson = PointwiseLoss(
    name="poisson",
    value=_poisson_value,
    d1=_poisson_d1,
    d2=_poisson_d2,
    mean_fn=ordered.exp,
)


# Smoothed hinge (labels in {0, 1}, converted to ±1), with z = ŷ·m:
#   ℓ = ½ - z (z ≤ 0),  ½(1 - z)² (0 < z < 1),  0 (z ≥ 1)
# ∂²ℓ/∂m² is the indicator of the quadratic region.

def _hinge_sign(label: Tensor) -> Tensor:
    return 2.0 * label - 1.0


def _smoothed_hinge_value(margin: Tensor, label: Tensor) -> Tensor:
    z = _hinge_sign(label) * margin
    zero = torch.zeros_like(z)
    return torch.where(
        z <= 0.0, 0.5 - z, torch.where(z < 1.0, 0.5 * (1.0 - z) ** 2, zero)
    )


def _smoothed_hinge_d1(margin: Tensor, label: Tensor) -> Tensor:
    s = _hinge_sign(label)
    z = s * margin
    dz = torch.where(
        z <= 0.0,
        torch.full_like(z, -1.0),
        torch.where(z < 1.0, z - 1.0, torch.zeros_like(z)),
    )
    return s * dz


def _smoothed_hinge_d2(margin: Tensor, label: Tensor) -> Tensor:
    z = _hinge_sign(label) * margin
    return ((z > 0.0) & (z < 1.0)).to(margin.dtype)


smoothed_hinge = PointwiseLoss(
    name="smoothed_hinge",
    value=_smoothed_hinge_value,
    d1=_smoothed_hinge_d1,
    d2=_smoothed_hinge_d2,
    mean_fn=lambda m: m,
)


_REGISTRY: dict[str, PointwiseLoss] = {
    loss.name: loss for loss in (logistic, squared, poisson, smoothed_hinge)
}

# Task-type aliases mirroring the reference's TaskType enum.
_ALIASES = {
    "logistic_regression": "logistic",
    "linear_regression": "squared",
    "linear": "squared",
    "poisson_regression": "poisson",
    "smoothed_hinge_loss_linear_svm": "smoothed_hinge",
    "hinge": "smoothed_hinge",
}


def get(name: str) -> PointwiseLoss:
    """Look up a loss by name or task-type alias (case-insensitive)."""
    key = name.lower()
    key = _ALIASES.get(key, key)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown loss {name!r}; available: {sorted(_REGISTRY)} "
            f"(aliases: {sorted(_ALIASES)})"
        )
    return _REGISTRY[key]
