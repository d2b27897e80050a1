"""GAME over a process group: row-sharded fixed effects and entity-sharded
random effects (port of ``photon_ml_tpu/game/distributed.py``).

The reference runs GAME on a JAX mesh: rows sharded for the fixed effect
(the whole solver inside ``shard_map``, one fused psum an evaluation),
entity lanes sharded for the random effects (the vmapped per-entity solves
need no communication).  The port runs it over a ``torch.distributed``
group, one rank a card (:class:`~photon_ml_tpu_torch.parallel.distributed
.DataGroup`):

- :class:`DistributedFixedEffectCoordinate` — each rank holds its
  contiguous row block (``shard_glm_data``: the kernel-backed CSR/CSC on
  the card, local row ids) and runs the same solver as every other rank
  with one all-reduce of ``[value, grad]`` an evaluation; its scores are
  the ranks' row blocks all-gathered in rank order.
- :class:`EntityShardedRandomEffectCoordinate` — every block's entity axis
  is padded to a multiple of the group size (zero-weight lanes, sentinel
  rows: :func:`_pad_block_entities`) and rank r solves the contiguous lanes
  ``[r·E/k, (r+1)·E/k)``, the reference's ``P(DATA)`` split.  Each rank
  keeps only its own lanes on its card.  After a solve the ranks' lanes
  are all-gathered so every rank holds the whole state (the descent, the
  checkpoints and the model need it); a score is each rank's scatter of
  its own lanes summed over the group.
- :func:`entity_sharded_factored_coordinate` — the factored random effect
  over the same everything-split lanes; its projection gradient over V is
  each rank's float64 :class:`~photon_ml_tpu_torch.game.factored
  .SortedSegmentSum` of its own lanes' terms, added over the ranks in rank
  order (``DataGroup.gather_sum``).

``mesh=None`` with ``n_shards=k`` is k LOGICAL shards held by one process:
the same lanes and programs, the exchange a concatenation and the sums in
shard order, so a group of k ranks gives the bits of k logical shards.

Lane independence: a lane's programs (``game/coordinates.py``'s Newton
paths, ``optim/batched.py``'s fallback) use only per-lane reductions, so a
rank's slice of a bucket solves its lanes to the same bits as the whole
bucket on one process (``tests/test_torch_game_mesh.py`` holds this).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device, to_numpy
from photon_ml_tpu_torch.game.coordinates import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
    _coldot,
    _gather_block_offsets,
    _rowdot,
)
from photon_ml_tpu_torch.game.data import EntityBlock, RandomEffectDataset
from photon_ml_tpu_torch.game.model import FixedEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    GlmOptimizationProblem,
)
from photon_ml_tpu_torch.parallel.distributed import (
    DataGroup,
    DistributedGlmData,
    shard_glm_data,
)

Tensor = torch.Tensor


def shard_count(mesh: Optional[DataGroup], n_shards: Optional[int]) -> int:
    """The group's size, or ``n_shards`` logical shards without one."""
    if mesh is not None:
        return mesh.size
    if n_shards is None or n_shards < 1:
        raise ValueError("a sharded coordinate needs a mesh or n_shards >= 1")
    return int(n_shards)


def held_shards(mesh: Optional[DataGroup], k: int) -> tuple:
    """The shards this process solves: its rank's, or all k logical."""
    return (mesh.rank,) if mesh is not None else tuple(range(k))


class DistributedFixedEffectCoordinate(FixedEffectCoordinate):
    """Row-sharded fixed-effect coordinate over a process group: built from
    HOST data, sharded once (``dist`` reuses a sharded dataset: grid points
    that differ only in the optimizer share it).  ``reg_weight`` is read at
    every ``train``, so tuning may change it without a re-shard."""

    def __init__(
        self,
        name: str,
        X_host,
        labels: np.ndarray,
        mesh: DataGroup,
        task: str,
        config: GlmOptimizationConfig,
        reg_weight: float = 0.0,
        feature_shard: str = "global",
        weights: Optional[np.ndarray] = None,
        dist: Optional[DistributedGlmData] = None,
        device=None,
    ):
        # Not FixedEffectCoordinate.__init__: the data is a row block.
        self.name = name
        self.task = losses_lib.get(task).name
        self.problem = GlmOptimizationProblem(task, config)
        self.reg_weight = reg_weight
        self.feature_shard = feature_shard
        self.mesh = mesh
        self.n_rows = int(X_host.shape[0])
        self.n_features = int(X_host.shape[1])
        self.dist = (dist if dist is not None else shard_glm_data(
            X_host, labels, mesh, weights=weights, device=device))

    @property
    def device(self) -> torch.device:
        return self.dist.device

    def _local(self, offsets) -> object:
        """This rank's row block with its slice of the full offsets (the
        padding rows get 0)."""
        rows = self.dist.rows_per
        lo = self.mesh.rank * rows
        off = torch.as_tensor(offsets, dtype=torch.float32,
                              device=self.device)[lo:lo + rows]
        if off.shape[0] < rows:
            off = torch.cat([off, off.new_zeros(rows - off.shape[0])])
        return dataclasses.replace(self.dist.local(), offsets=off)

    def train(self, offsets: Tensor, warm_state: Optional[Tensor] = None
              ) -> Tensor:
        w0 = (torch.zeros(self.n_features, dtype=torch.float32,
                          device=self.device)
              if warm_state is None else warm_state)
        return self.problem.solve_single_device(
            self._local(offsets), self.reg_weight, w0,
            reduce=self.mesh.reduce).w

    def score(self, state: Tensor) -> Tensor:
        return self.mesh.gather_rows(
            self.dist.local().features.matvec(state), self.n_rows)

    def finalize(self, state: Tensor, offsets=None) -> FixedEffectModel:
        variances = None
        if self.problem.config.compute_variances and offsets is not None:
            # One reduction of the squared columns, at the full final
            # margins (residual offsets included).
            variances = self.problem.coefficient_variances(
                state, self._local(offsets), self.reg_weight,
                reduce=self.mesh.reduce)
        return FixedEffectModel(
            GeneralizedLinearModel(Coefficients(state, variances), self.task),
            self.feature_shard,
        )


def _pad_block_entities(block: EntityBlock, multiple: int,
                        sentinel: int) -> EntityBlock:
    """A host block with its entity axis padded to a multiple of
    ``multiple``: padding lanes carry zero weights (they solve to 0 under
    L2), col_map -1 and sentinel row ids (they score into the discarded
    trailing slot)."""
    E = block.n_entities
    target = -(-E // multiple) * multiple
    pad = target - E
    if pad == 0:
        return block

    def p(x, fill=0):
        x = np.asarray(x)
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                      constant_values=fill)

    return dataclasses.replace(
        block, X=p(block.X), labels=p(block.labels),
        weights=p(block.weights), col_map=p(block.col_map, -1),
        row_index=p(block.row_index, sentinel), n_entities=target)


def pad_dataset(dataset: RandomEffectDataset, placements: Sequence,
                k: int) -> RandomEffectDataset:
    """The host dataset with every ``("split",)`` block (and its passive
    companion) padded to a multiple of ``k`` lanes; packed blocks stay as
    they are."""
    sentinel = dataset.n_global_rows

    def place(block, placement):
        if block is None or placement[0] != "split":
            return block
        return _pad_block_entities(block, k, sentinel)

    passive = dataset.passive_blocks or [None] * len(dataset.blocks)
    return dataclasses.replace(
        dataset,
        blocks=[place(b, p) for b, p in zip(dataset.blocks, placements)],
        passive_blocks=[place(b, p) for b, p in zip(passive, placements)],
    )


def shard_dataset_entities(dataset: RandomEffectDataset, k: int
                           ) -> RandomEffectDataset:
    """The dataset with every block's entity axis padded to a multiple of
    ``k`` (the group's size): the one layout both entity-sharded
    coordinates build on."""
    return pad_dataset(dataset, [("split",)] * len(dataset.blocks), k)


def lane_range(placement: tuple, n_entities: int, k: int,
               shard: int) -> Optional[tuple]:
    """``[lo, hi)`` of a block's lanes shard ``shard`` solves: its
    contiguous ``1/k`` of a split block, the whole of a block packed onto
    it, else None."""
    if placement[0] == "split":
        per = n_entities // k
        return shard * per, (shard + 1) * per
    return (0, n_entities) if placement[1] == shard else None


@dataclasses.dataclass(frozen=True)
class LanePart:
    """Lanes ``[lane_lo, lane_hi)`` of block ``block_idx`` that shard
    ``shard`` solves."""

    block_idx: int
    shard: int
    lane_lo: int
    lane_hi: int


def lane_parts(blocks: Sequence[EntityBlock], placements: Sequence, k: int,
               shards: Sequence[int]) -> list:
    """The parts ``shards`` solve, shard by shard, blocks in order."""
    out = []
    for s in shards:
        for bi, (b, p) in enumerate(zip(blocks, placements)):
            r = lane_range(p, b.n_entities, k, s)
            if r is not None:
                out.append(LanePart(bi, s, r[0], r[1]))
    return out


def exchange_lanes(state: list, parts_of: dict, mesh: DataGroup,
                   device) -> None:
    """Every other rank's solved lanes into ``state`` (a block's ``(E,
    width)`` tensor or host array each, this rank's own lanes already in
    place), in ONE all-gather: each rank's real lanes
    (``parts_of[rank]``, parts with ``block_idx``/``lane_lo``/``lane_hi``,
    the same list on every rank) flattened in part order and padded to the
    longest.  Moves bits only, so the state is exactly the ranks' lanes."""
    def rows(p):
        return state[p.block_idx][p.lane_lo:p.lane_hi]

    def as_tensor(a):
        return a if isinstance(a, Tensor) else torch.from_numpy(a)

    sizes = {r: sum(rows(p).shape[0] * rows(p).shape[1] for p in ps)
             for r, ps in parts_of.items()}
    buf = torch.zeros(max(sizes.values()), dtype=torch.float32,
                      device=device)
    mine = [as_tensor(rows(p)).reshape(-1) for p in parts_of[mesh.rank]]
    if mine:
        flat = torch.cat([m.to(device) for m in mine])
        buf[:flat.numel()] = flat
    every = mesh.all_gather(buf)
    for r, ps in parts_of.items():
        if r == mesh.rank:
            continue
        at = 0
        for p in ps:
            dst = as_tensor(rows(p))
            dst.copy_(every[r, at:at + dst.numel()].view(dst.shape))
            at += dst.numel()


def place_lanes(shapes: Sequence[tuple], parts_of: dict, held: dict,
                mesh: Optional[DataGroup], device) -> list:
    """The whole per-block state from the shards' lanes: ``shapes[b]`` is
    block b's ``(E, width)``, ``held[part]`` the ``(lane_hi - lane_lo,
    width)`` result of each part this process solved; under a group the
    other ranks' lanes arrive by :func:`exchange_lanes`."""
    state = [torch.zeros(s, dtype=torch.float32, device=device)
             for s in shapes]
    for part, w in held.items():
        state[part.block_idx][part.lane_lo:part.lane_hi] = w
    if mesh is not None:
        exchange_lanes(state, parts_of, mesh, device)
    return state


def _device_block(block: EntityBlock, lo: int, hi: int, device
                  ) -> EntityBlock:
    """Lanes ``[lo, hi)`` of a host block as tensors on ``device``."""
    leaves = {k: torch.as_tensor(np.ascontiguousarray(
        np.asarray(getattr(block, k))[lo:hi]), device=device)
        for k in EntityBlock.LEAVES}
    return dataclasses.replace(block, n_entities=hi - lo, **leaves)


class LaneShardedRandomEffectCoordinate(RandomEffectCoordinate):
    """A random effect whose buckets are placed over the shards of a group
    by ``placements`` (``("split",)`` or ``("pack", k)`` a block): the
    common body of :class:`EntityShardedRandomEffectCoordinate` (every block
    split) and ``game/hierarchical.py``'s bucket-shard plan.

    ``self.dataset`` is the padded HOST dataset (every process keeps the
    host blocks; the model, the validation scorer and the warm starts read
    it); each process places only the lanes it solves on its card.  State
    is the whole ``(E, D)`` tensor a block (padding lanes included) on
    every rank."""

    def __init__(
        self,
        name: str,
        dataset: RandomEffectDataset,
        mesh: Optional[DataGroup],
        task: str,
        config: GlmOptimizationConfig,
        placements: Sequence,
        reg_weight: float = 0.0,
        feature_shard: str = "global",
        entity_key: str = "",
        n_shards: Optional[int] = None,
        device=None,
    ):
        k = shard_count(mesh, n_shards)
        padded = pad_dataset(dataset, placements, k)
        super().__init__(name, padded, task, config, reg_weight,
                         feature_shard=feature_shard, entity_key=entity_key)
        self.mesh = mesh
        self.n_shards = k
        self.placements = tuple(placements)
        self._device = resolve_device(device)
        blocks = padded.blocks
        self._parts_of = {s: lane_parts(blocks, self.placements, k, [s])
                          for s in range(k)}
        self._parts = lane_parts(blocks, self.placements, k,
                                 held_shards(mesh, k))
        passive = padded.passive_blocks or [None] * len(blocks)
        self._local = {
            p: (_device_block(blocks[p.block_idx], p.lane_lo, p.lane_hi,
                              self._device),
                None if passive[p.block_idx] is None else _device_block(
                    passive[p.block_idx], p.lane_lo, p.lane_hi,
                    self._device))
            for p in self._parts}

    @property
    def device(self) -> torch.device:
        return self._device

    def _shapes(self, width=None) -> list:
        return [(b.n_entities, b.block_dim if width is None else width)
                for b in self.dataset.blocks]

    def place_state(self, state, device):
        """A restored state (a checkpoint's, or an initial model's
        unpadded matrices) as whole padded tensors on the card."""
        if state is None:
            return None
        out = []
        for b, s in zip(self.dataset.blocks, state):
            w = torch.zeros((b.n_entities, b.block_dim), dtype=torch.float32,
                            device=self._device)
            s = torch.as_tensor(np.asarray(to_numpy(s), np.float32),
                                device=self._device)
            w[:s.shape[0]] = s
            out.append(w)
        return out

    def train(self, offsets: Tensor, warm_state=None) -> list[Tensor]:
        l1, l2 = self._reg()
        offsets = torch.as_tensor(offsets, dtype=torch.float32,
                                  device=self._device)
        items = []
        for p in self._parts:
            block = self._local[p][0]
            w0 = (warm_state[p.block_idx][p.lane_lo:p.lane_hi]
                  if warm_state is not None
                  else torch.zeros((p.lane_hi - p.lane_lo, block.block_dim),
                                   dtype=torch.float32, device=self._device))
            items.append((block, _gather_block_offsets(offsets, block), w0))
        outs, self.last_solve = self._solver.solve_all(items, l1, l2)
        return place_lanes(self._shapes(), self._parts_of,
                           dict(zip(self._parts, outs)), self.mesh,
                           self._device)

    def score(self, state: list[Tensor]) -> Tensor:
        n = self.dataset.n_global_rows
        total = torch.zeros(n + 1, dtype=torch.float32, device=self._device)
        for p in self._parts:
            coefs = state[p.block_idx][p.lane_lo:p.lane_hi]
            for b in self._local[p]:
                if b is not None:
                    # + 0.0 as score_blocks (no -0.0 reaches the sum).
                    s = _rowdot(b.X, coefs) + 0.0
                    total.index_put_((b.row_index.reshape(-1).long(),),
                                     s.reshape(-1))
        total = total[:n].contiguous()
        return total if self.mesh is None else self.mesh.sum_scores(total)

    def _block_variances(self, block: EntityBlock, coefs: Tensor,
                         offsets: Tensor) -> np.ndarray:
        """The resident variances over a host block moved to the card for
        the computation (finalize only)."""
        loss = losses_lib.get(self.task)
        _, l2 = self._reg()
        blk = _device_block(block, 0, block.n_entities, self._device)
        off_b = _gather_block_offsets(offsets.to(torch.float32), blk)
        m = _rowdot(blk.X, coefs) + off_b
        d2w = blk.weights * loss.d2(m, blk.labels)
        diag = _coldot(d2w, blk.X * blk.X) + l2
        return (1.0 / torch.clamp(diag, min=1e-12)).cpu().numpy()


class EntityShardedRandomEffectCoordinate(LaneShardedRandomEffectCoordinate):
    """Random-effect coordinate with every block's entity axis split over
    the group (``finalize`` drops the padding lanes: the model holds
    exactly the real entities)."""

    def __init__(self, name: str, dataset: RandomEffectDataset,
                 mesh: Optional[DataGroup], task: str,
                 config: GlmOptimizationConfig, reg_weight: float = 0.0,
                 feature_shard: str = "global", entity_key: str = "",
                 n_shards: Optional[int] = None, device=None):
        super().__init__(name, dataset, mesh, task, config,
                         [("split",)] * len(dataset.blocks), reg_weight,
                         feature_shard=feature_shard, entity_key=entity_key,
                         n_shards=n_shards, device=device)


def entity_sharded_factored_coordinate(
    name: str,
    dataset: RandomEffectDataset,
    mesh: Optional[DataGroup],
    task: str,
    config: GlmOptimizationConfig,
    rank: int,
    n_shards: Optional[int] = None,
    device=None,
    **kwargs,
):
    """The factored random effect over entity-sharded lanes (every block
    split): see :class:`~photon_ml_tpu_torch.game.factored
    .ShardedFactoredRandomEffectCoordinate`."""
    from photon_ml_tpu_torch.game.factored import (
        ShardedFactoredRandomEffectCoordinate,
    )

    return ShardedFactoredRandomEffectCoordinate(
        name, dataset, mesh, task, config, rank, n_shards=n_shards,
        device=device, **kwargs)
