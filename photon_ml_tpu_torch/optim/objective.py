"""GLM objective: value / gradient / Hessian-vector product (port of
``photon_ml_tpu/optim/objective.py``).

The data term is a **weighted sum** of per-example losses; L2 adds
``½·λ·‖w‖²`` to the value, ``λ·w`` to the gradient and ``λ·v`` to the HVP.
The gradient is the explicit ``Xᵀ(weight ⊙ d1(Xw))`` and the HVP the GLM
closed form ``Xᵀ(weight ⊙ d2 ⊙ (X v))`` — both are the same two sparse
mat-vecs (``matvec`` then ``rmatvec``), so there is no separate backward
kernel.  Normalization is applied in coefficient space.

``reduce`` takes the place of the reference's ``axis_name``: a callable
that sums its tensors over every rank of a process group in ONE collective
(``parallel/distributed.py``: ``DataGroup.reduce``), applied to the
data term before the L2 term is added, so each rank's solver reads the
same reduced value and gradient.  ``None`` is the single-device path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from photon_ml_tpu_torch.data.dataset import GlmData
from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.device import ACCUMULATE_DTYPES
from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.ops.losses import PointwiseLoss

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GlmObjective:
    """Binds a pointwise loss and optional normalization into a GLM
    objective.  ``l2_weight`` is a method argument so one objective serves
    a whole regularization grid."""

    loss: PointwiseLoss
    normalization: Optional[NormalizationContext] = None
    # "f32": the value is reduced in the data's dtype (float32 on the
    # training path).  "f64": the VALUE reduction
    # upcasts to float64 before summing and the returned value stays
    # float64, so the solvers' convergence tests see the extra precision;
    # the gradient's per-coordinate sums stay float32.
    accumulate: str = "f32"

    def __post_init__(self):
        if self.accumulate not in ACCUMULATE_DTYPES:
            raise ValueError(
                f"accumulate must be f32|f64, got {self.accumulate!r}"
            )

    def _wsum(self, weights: Tensor, vals: Tensor) -> Tensor:
        """The objective's weighted-sum reduction (see ``accumulate``)."""
        prod = weights * vals
        if self.accumulate == "f64":
            return prod.to(torch.float64).sum()
        return prod.sum()

    # -- normalized linear maps --------------------------------------------
    def _matvec(self, data: GlmData, w: Tensor) -> Tensor:
        norm = self.normalization
        if norm is None:
            return data.features.matvec(w)
        m = data.features.matvec(w * norm.factors)
        return m - ordered.dot(w, norm.factors * norm.shifts)

    def _rmatvec(self, data: GlmData, u: Tensor) -> Tensor:
        norm = self.normalization
        if norm is None:
            return data.features.rmatvec(u)
        g = data.features.rmatvec(u)
        return norm.factors * (g - norm.shifts * u.sum())

    def margins(self, w: Tensor, data: GlmData) -> Tensor:
        return self._matvec(data, w) + data.offsets

    # -- local pieces, no regularization -----------------------------------
    def raw_value(self, w: Tensor, data: GlmData) -> Tensor:
        m = self.margins(w, data)
        return self._wsum(data.weights, self.loss.value(m, data.labels))

    def raw_value_and_grad(self, w: Tensor, data: GlmData):
        m = self.margins(w, data)
        value = self._wsum(data.weights, self.loss.value(m, data.labels))
        u = data.weights * self.loss.d1(m, data.labels)
        return value, self._rmatvec(data, u)

    def d2_weights(self, w: Tensor, data: GlmData) -> Tensor:
        """``weight ⊙ d2(m, y)`` — compute once per outer iterate and pass to
        :meth:`raw_hvp`/:meth:`hvp` so each CG step costs two mat-vecs."""
        m = self.margins(w, data)
        return data.weights * self.loss.d2(m, data.labels)

    def raw_hvp(self, w: Tensor, v: Tensor, data: GlmData,
                d2w: Optional[Tensor] = None) -> Tensor:
        if d2w is None:
            d2w = self.d2_weights(w, data)
        dm = self._matvec(data, v)
        return self._rmatvec(data, d2w * dm)

    # -- full objective (optionally reduced over a process group) ---------
    def value(self, w: Tensor, data: GlmData, l2_weight=0.0,
              reduce=None) -> Tensor:
        val = self.raw_value(w, data)
        if reduce is not None:
            (val,) = reduce(val)
        return val + 0.5 * l2_weight * ordered.dot(w, w)

    def value_and_grad(self, w: Tensor, data: GlmData, l2_weight=0.0,
                       reduce=None):
        val, grad = self.raw_value_and_grad(w, data)
        if reduce is not None:
            # The treeAggregate analogue: one fused all-reduce.
            val, grad = reduce(val, grad)
        return val + 0.5 * l2_weight * ordered.dot(w, w), grad + l2_weight * w

    def hvp(self, w: Tensor, v: Tensor, data: GlmData, l2_weight=0.0,
            d2w: Optional[Tensor] = None, reduce=None) -> Tensor:
        h = self.raw_hvp(w, v, data, d2w)
        if reduce is not None:
            (h,) = reduce(h)
        return h + l2_weight * v

    # -- scoring -----------------------------------------------------------
    def mean(self, w: Tensor, data: GlmData) -> Tensor:
        """Mean response (inverse link of the margin)."""
        return self.loss.mean_fn(self.margins(w, data))
