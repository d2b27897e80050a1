"""GAME model containers (port of ``photon_ml_tpu/game/model.py``).

The analogue of the reference's ``...ml.model`` GAME classes:
``GameModel`` (container of per-coordinate models; scoring = sum of
coordinate scores), ``FixedEffectModel`` (one coefficient vector, broadcast
in the reference — replicated here), and ``RandomEffectModel`` (per-entity
coefficients, an RDD in the reference — a host-side entity→sparse-coefficient
table here, materialized into dense device blocks when scoring).  The
tables are host numpy in both packages, so a model from either holds the
same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel


@dataclasses.dataclass
class FixedEffectModel:
    """Reference: ``FixedEffectModel(model, featureShardId)``."""

    model: GeneralizedLinearModel
    feature_shard: str


@dataclasses.dataclass
class RandomEffectModel:
    """Per-entity GLMs over one feature shard.

    ``coefficients`` maps entity key → (global_cols int32[], values float32[])
    with columns sorted ascending — the sparse original-space coefficient
    vector of that entity (the
    reference stores per-entity ``Coefficients`` in projected space and
    carries the projector; storing sparse global-space pairs is equivalent
    and projector-free).  Entities never seen at training time score 0, as
    in the reference.
    """

    coefficients: dict
    feature_shard: str
    entity_key: str
    task: str
    n_features: int
    #: optional per-entity coefficient variances (reference: Bayesian model
    #: output) — entity key → float32[] aligned with that entity's ``cols``.
    variances: Optional[dict] = None
    #: lazily-built packed view for vectorized lookup; the coefficient table
    #: is immutable after training/load, so this never needs invalidation.
    _packed: object = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def n_entities(self) -> int:
        return len(self.coefficients)

    def _ensure_packed(self):
        """CSR-like packing of the entity→(cols, vals) table enabling ONE
        vectorized lookup across all lanes of a block: entity keys sorted,
        per-entity column segments concatenated, and a combined
        ``entity_rank * (n_features + 1) + col`` key that is GLOBALLY sorted
        (segments are rank-ordered, columns sorted within each segment), so
        a single ``searchsorted`` resolves every (lane, local column) pair."""
        if self._packed is not None:
            return self._packed
        keys = np.asarray(sorted(self.coefficients), dtype=object)
        sizes = np.array(
            [len(self.coefficients[k][0]) for k in keys], np.int64
        )
        starts = np.concatenate([[0], np.cumsum(sizes)])
        total = int(starts[-1])
        cols = np.empty(total, np.int64)
        vals = np.empty(total, np.float32)
        for i, k in enumerate(keys):
            c, v = self.coefficients[k]
            cols[starts[i] : starts[i + 1]] = c
            vals[starts[i] : starts[i + 1]] = v
        stride = self.n_features + 1
        ranks = np.repeat(np.arange(len(keys), dtype=np.int64), sizes)
        combined = ranks * stride + cols
        self._packed = (keys, combined, vals, stride)
        return self._packed

    def coefficient_matrix_for(
        self, col_map: np.ndarray, entity_ids: list
    ) -> np.ndarray:
        """Project stored coefficients into a block's local column layout:
        returns (E, D) with w_local[e, k] = w_e[col_map[e, k]].  Used when
        scoring new data through the block pipeline.  Fully vectorized: one
        ``searchsorted`` over the packed combined-key array covers every
        lane and column at once (no per-entity Python loop)."""
        keys, combined, vals, stride = self._ensure_packed()
        E, D = col_map.shape
        out = np.zeros((E, D), np.float32)
        if len(keys) == 0:
            return out
        lane_keys = np.asarray(entity_ids, dtype=object)
        rank = np.searchsorted(keys, lane_keys)
        rank_c = np.minimum(rank, len(keys) - 1)
        known = keys[rank_c] == lane_keys  # (E,) entity seen at training
        cm = np.asarray(col_map, np.int64)
        q = rank_c[:, None] * stride + cm  # (E, D) combined query keys
        pos = np.searchsorted(combined, q)
        pos_c = np.minimum(pos, len(combined) - 1)
        hit = (
            known[:, None]
            & (cm >= 0)
            & (pos < len(combined))
            & (combined[pos_c] == q)
        )
        out[hit] = vals[pos_c[hit]]
        return out


@dataclasses.dataclass
class GameModel:
    """Reference: ``GameModel`` — ordered per-coordinate models; the overall
    score of a row is the sum of its coordinate scores (plus offset)."""

    models: dict  # coordinate name -> FixedEffectModel | RandomEffectModel
    task: str

    def __getitem__(self, name: str):
        return self.models[name]

    @property
    def coordinate_names(self) -> list[str]:
        return list(self.models)
