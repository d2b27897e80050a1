"""The bucket ladder placed over a process group (port of
``photon_ml_tpu/game/hierarchical.py``).

A random effect's buckets (``game/data.py``) are independent dense blocks.
The reference distributes the ladder over a mesh: big buckets SPLIT along
the entity axis over every device, small ones PACK whole onto single
devices by a greedy cost-balanced assignment (longest processing time over
padded-FLOP costs), so the long tail stops paying mesh-wide padding.  The
port keeps that plan exactly (host arithmetic: :func:`plan_bucket_shards`
gives the reference's placements and ``imbalance_ratio`` on the same
blocks) and runs it over the ranks of a ``torch.distributed`` group:

- a ``("split",)`` block pads its entity axis to a multiple of the group
  size (zero-weight lanes, sentinel rows) and rank r solves its contiguous
  lanes ``[r·E/k, (r+1)·E/k)``, the reference's ``P(DATA)`` split;
- a ``("pack", r)`` block is solved whole on rank r.

Each rank keeps only its own lanes on its card, solves them in one
lockstep, and the ranks' lanes are exchanged in one all-gather (every rank
then holds the whole state); a score is each rank's scatter of its own
lanes summed over the group (``DataGroup.sum_scores``).  A lane's programs
use per-lane reductions only, so the plan changes where a lane is solved,
never its bits: the sharded coordinate gives the one-process coordinate's
state and scores bitwise (``tests/test_torch_game_mesh.py``).

The plan's ``imbalance_ratio`` is published as the reference's
``game_shard_imbalance_ratio`` telemetry gauge.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.game.data import EntityBlock, RandomEffectDataset
from photon_ml_tpu_torch.game.distributed import (
    LaneShardedRandomEffectCoordinate,
    held_shards,
    shard_count,
)
from photon_ml_tpu_torch.optim.problem import GlmOptimizationConfig


@dataclasses.dataclass(frozen=True)
class BucketShardPlan:
    """Where each bucket of one random-effect ladder runs.

    ``placements[b]`` is ``("split",)`` — block b's entity axis split over
    the whole group — or ``("pack", k)`` — block b whole on rank k.
    ``imbalance_ratio`` is the max/mean padded-FLOP load across ranks (1.0
    is perfectly balanced)."""

    placements: tuple
    n_devices: int
    imbalance_ratio: float

    @property
    def n_split(self) -> int:
        return sum(1 for p in self.placements if p[0] == "split")

    @property
    def n_packed(self) -> int:
        return len(self.placements) - self.n_split


def plan_bucket_shards(
    blocks: list[EntityBlock],
    n_devices: int,
    split_factor: float = 0.5,
) -> BucketShardPlan:
    """Greedy cost-balanced placement of a bucket ladder on ``n_devices``
    ranks (the reference's arithmetic).

    Cost: padded FLOPs ``E·R·D`` a block.  A block SPLITS when its cost is
    at least ``split_factor`` of the ideal per-rank share and it has at
    least one lane a rank.  The rest pack by longest processing time:
    descending cost (ascending index on ties), each onto the least-loaded
    rank.  A split block loads every rank with cost / n_devices."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    costs = [b.n_entities * b.rows_per_entity * b.block_dim for b in blocks]
    total = sum(costs)
    if not blocks or n_devices == 1 or total == 0:
        return BucketShardPlan(
            placements=tuple(("pack", 0) for _ in blocks),
            n_devices=n_devices, imbalance_ratio=1.0)
    ideal = total / n_devices
    loads = np.zeros(n_devices)
    placements: list = [None] * len(blocks)
    packable = []
    for bi, (block, cost) in enumerate(zip(blocks, costs)):
        if cost >= split_factor * ideal and block.n_entities >= n_devices:
            placements[bi] = ("split",)
            loads += cost / n_devices
        else:
            packable.append((cost, bi))
    for cost, bi in sorted(packable, key=lambda t: (-t[0], t[1])):
        k = int(np.argmin(loads))
        placements[bi] = ("pack", k)
        loads[k] += cost
    mean = float(loads.mean())
    imbalance = float(loads.max() / mean) if mean > 0 else 1.0
    return BucketShardPlan(placements=tuple(placements), n_devices=n_devices,
                           imbalance_ratio=imbalance)


class ShardedBucketRandomEffectCoordinate(LaneShardedRandomEffectCoordinate):
    """Random-effect coordinate whose bucket ladder is placed over a group
    by a :class:`BucketShardPlan` (``self.plan``); ``split_factor`` is the
    plan's split threshold.  ``mesh=None, n_shards=k`` runs the same plan
    over k logical shards in one process."""

    def __init__(
        self,
        name: str,
        dataset: RandomEffectDataset,
        mesh,
        task: str,
        config: GlmOptimizationConfig,
        reg_weight: float = 0.0,
        feature_shard: str = "global",
        entity_key: str = "",
        split_factor: float = 0.5,
        n_shards: Optional[int] = None,
        device=None,
    ):
        k = shard_count(mesh, n_shards)
        self.plan = plan_bucket_shards(dataset.blocks, k,
                                       split_factor=split_factor)
        telemetry_mod.current().gauge("game_shard_imbalance_ratio").set(
            self.plan.imbalance_ratio)
        self.split_factor = float(split_factor)
        super().__init__(name, dataset, mesh, task, config,
                         self.plan.placements, reg_weight,
                         feature_shard=feature_shard, entity_key=entity_key,
                         n_shards=n_shards, device=device)

    def train(self, offsets, warm_state=None):
        # The per-placement dispatch seam, once a group this process
        # dispatches (the split group first, then each packed shard, as
        # the reference orders them): a fault here aborts the update
        # before any solve; the solves are pure functions of (blocks,
        # offsets, w0), so the retried update is bitwise the
        # uninterrupted one.
        held = set(held_shards(self.mesh, self.n_shards))
        groups: dict = {}
        for bi, p in enumerate(self.placements):
            if p[0] == "split" or p[1] in held:
                groups.setdefault(p, []).append(bi)
        for key in sorted(groups, key=lambda p: (p[0] != "split", p)):
            chaos_mod.maybe_fail(
                "game.bucket_shard", placement=key, blocks=len(groups[key])
            )
        return super().train(offsets, warm_state)
