"""Synthetic GAME serving workload (selfcheck, tests, bench_serving; port
of ``photon_ml_tpu/serving/synthetic.py``: the same numpy draws, so a seed
gives the same model and requests in both packages).

Builds an in-memory GAME model with one fixed effect and one per-entity
random effect — the MovieLens shape the training benches use — plus a
request generator with a zipf-tailed entity stream, so the LRU hot set
sees realistic skew: a few heavy entities dominate (hot hits) over a long
cold tail (fallback gathers + promotions).  The fixed effect's means are
a host tensor; a runtime copies them to its own device.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel


class SyntheticWorkload:
    """A GAME model + matching request stream.

    ``entity_skew`` > 0 draws request entities zipf(``entity_skew``)
    (rank-1 dominates); 0 draws them uniformly.  Entity ids beyond
    ``n_entities`` never occur, so every request joins (use
    ``unknown_rate`` to mix in never-trained entities).
    """

    def __init__(
        self,
        n_entities: int = 64,
        fixed_dim: int = 8,
        re_dim: int = 4,
        task: str = "logistic",
        entity_key: str = "userId",
        fixed_shard: str = "global",
        re_shard: str = "userFeatures",
        entity_skew: float = 1.4,
        unknown_rate: float = 0.0,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self.n_entities = int(n_entities)
        self.fixed_dim = int(fixed_dim)
        self.re_dim = int(re_dim)
        self.entity_key = entity_key
        self.fixed_shard = fixed_shard
        self.re_shard = re_shard
        self.entity_skew = float(entity_skew)
        self.unknown_rate = float(unknown_rate)

        w_fixed = rng.normal(size=fixed_dim).astype(np.float32)
        glm = GeneralizedLinearModel(
            Coefficients(means=torch.from_numpy(w_fixed)), task
        )
        cols = np.arange(re_dim, dtype=np.int32)
        table = {
            f"u{i}": (cols, rng.normal(size=re_dim).astype(np.float32))
            for i in range(self.n_entities)
        }
        self.model = GameModel(
            models={
                "fixed": FixedEffectModel(glm, fixed_shard),
                "per_entity": RandomEffectModel(
                    coefficients=table,
                    feature_shard=re_shard,
                    entity_key=entity_key,
                    task=task,
                    n_features=re_dim,
                ),
            },
            task=task,
        )
        self.index_maps = {
            fixed_shard: IndexMap.build(
                [feature_key(f"g{j}", "") for j in range(fixed_dim)]
            ),
            re_shard: IndexMap.build(
                [feature_key(f"r{j}", "") for j in range(re_dim)]
            ),
        }

    def entity_for(self, i: int, rng: np.random.Generator) -> str:
        if self.unknown_rate > 0 and rng.uniform() < self.unknown_rate:
            return f"unknown{i}"
        if self.entity_skew > 0:
            rank = min(
                int(rng.zipf(1.0 + self.entity_skew)), self.n_entities
            )
            return f"u{rank - 1}"
        return f"u{rng.integers(self.n_entities)}"

    def request(self, i: int) -> dict:
        """Deterministic i-th request (dense features + one entity id)."""
        rng = np.random.default_rng(1_000_003 + i)
        return {
            "dense": {
                self.fixed_shard: rng.normal(
                    size=self.fixed_dim
                ).astype(np.float32).tolist(),
                self.re_shard: rng.normal(
                    size=self.re_dim
                ).astype(np.float32).tolist(),
            },
            "ids": {self.entity_key: self.entity_for(i, rng)},
            "offset": float(rng.normal(scale=0.1)),
        }
