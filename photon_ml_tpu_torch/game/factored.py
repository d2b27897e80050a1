"""Factored random effects (port of ``photon_ml_tpu/game/factored.py``).

Entity e's coefficient vector is constrained to ``w_e = V u_e`` with ``V``
of shape ``(n_features, rank)`` shared by every entity and ``u_e`` of
``rank`` floats each, so sparse entities borrow strength through V.
Training alternates two convex sub-problems inside the coordinate:

1. **latent step** (V fixed): per-entity GLMs over the projected features
   ``Z = X V``, through the same ``BlockSolver`` as a plain random effect at
   dimension ``rank`` (Newton when rank ≤ 32 and the objective is smooth,
   the batched L-BFGS/OWL-QN/TRON otherwise), every bucket in lockstep;
2. **projection step** (every u_e fixed): one L-BFGS over vec(V) with
   margins ``x_rᵀ V u_e``, assembled bucket by bucket with multiply-plus-sum
   products (no ``(n_rows, d·rank)`` design matrix is built).

The projection gradient sums each (bucket, lane, local column) term into
its global column.  The reference does that with ``g.at[idx].add``; here a
:class:`SortedSegmentSum` built once from the buckets' column maps adds
each column's terms in one fixed order, with no atomics, so a training run
repeats bitwise on the card.  The value and the gradient's column sums
accumulate in float64 (the reference's in float32), so the out-of-core
coordinate, which sums the same terms slice by slice, rounds to the same
float32 gradient and takes the same L-BFGS steps over V.

``finalize`` materializes ``w_e = V u_e`` into the standard
``RandomEffectModel`` table, so the model store, the scoring driver and the
transformer treat factored and plain random effects alike.  ``V₀`` is drawn
as the reference draws it, so both packages start from the same point.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import to_numpy
from photon_ml_tpu_torch.game.coordinates import (
    BlockSolver,
    Coordinate,
    _coldot,
    _gather_block_offsets,
    _rowdot,
    pack_entity_tables,
    score_blocks,
)
from photon_ml_tpu_torch.game.data import EntityBlock, RandomEffectDataset
from photon_ml_tpu_torch.game.model import RandomEffectModel
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve
from photon_ml_tpu_torch.optim.problem import GlmOptimizationConfig

Tensor = torch.Tensor


class SortedSegmentSum:
    """Deterministic ``out[c] = Σ rows[i] for index[i] == c``.

    Built once on the host from ``index`` (``-1`` drops a row): the rows of
    each segment, in ascending row order, are cut into chunks of
    ``CHUNK``; one level gathers every chunk into a padded ``(chunks,
    CHUNK, ...)`` tensor (padding reads an appended zero row) and sums it,
    and the chunk sums are cut again until each segment holds one.  Every
    sum has a fixed shape and order, so the result repeats bitwise.
    :meth:`host_tables` gives the gather tables as host arrays (the
    out-of-core coordinate ships them with a pass group) and :meth:`apply`
    sums over tables already on the rows' device."""

    CHUNK = 32

    def __init__(self, index: np.ndarray, n_out: int, device=None):
        tables, final = self.host_tables(index, n_out)
        self.tables = [torch.as_tensor(t, device=device) for t in tables]
        self.final = torch.as_tensor(final, device=device)

    @classmethod
    def host_tables(cls, index: np.ndarray, n_out: int,
                    dtype=np.int64) -> tuple[list, np.ndarray]:
        """(per-level gather tables, final gather) as ``dtype`` arrays."""
        index = np.asarray(index, np.int64).reshape(-1)
        keep = np.flatnonzero(index >= 0)
        order = keep[np.argsort(index[keep], kind="stable")]
        counts = np.bincount(index[keep], minlength=n_out).astype(np.int64)
        starts = np.cumsum(counts) - counts
        C = cls.CHUNK
        source, length = order, len(index)  # sorted position → input row
        tables = []
        while len(counts) and counts.max() > 1:
            chunks = (counts + C - 1) // C
            seg = np.repeat(np.arange(len(counts)), chunks)
            first = np.cumsum(chunks) - chunks
            rank = np.arange(len(seg)) - first[seg]
            j = np.arange(C)
            offset = rank[:, None] * C + j[None, :]
            valid = offset < counts[seg][:, None]
            pos = np.where(valid, starts[seg][:, None] + offset, 0)
            tables.append(np.where(valid, source[pos], length).astype(dtype))
            counts, starts = chunks, first
            source, length = np.arange(len(seg)), len(seg)
        # A segment of one row reads it; an empty one the zero row.
        single = counts == 1
        final = np.full(len(counts), length, dtype)
        final[single] = source[starts[single]]
        return tables, final

    def __call__(self, rows: Tensor) -> Tensor:
        return self.apply(rows, self.tables, self.final)

    @staticmethod
    def apply(rows: Tensor, tables, final: Tensor) -> Tensor:
        a = rows
        for table in tables:
            a = torch.cat([a, a.new_zeros((1,) + a.shape[1:])])[table].sum(1)
        return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])[final]


def _grad_sum(col_maps, n_features: int, device) -> SortedSegmentSum:
    """The projection gradient's column sum over blocks' lanes (their
    ``(E, D)`` column maps, tensors or arrays, in order)."""
    index = [to_numpy(c).reshape(-1) for c in col_maps]
    return SortedSegmentSum(
        np.concatenate(index) if index else np.zeros(0, np.int64),
        n_features, device=device)


def _gather_v(V: Tensor, cmap: Tensor) -> Tensor:
    """Per-lane rows of V in the block's LOCAL column space: (E, D, rank).
    Padding columns (cmap == -1) read as zero rows."""
    vsub = V[torch.clamp(cmap, min=0).long()]
    return torch.where((cmap >= 0)[:, :, None], vsub, 0.0)


def _materialize(V: Tensor, cmap: Tensor, u: Tensor) -> Tensor:
    """w_e = V_sub u_e for every lane: (E, D)."""
    return (_gather_v(V, cmap) * u[:, None, :]).sum(-1)


def _project_block(block: EntityBlock, V: Tensor, rank: int) -> EntityBlock:
    """The block with its features projected through V: X (E, R, D) → Z
    (E, R, rank), one multiply-plus-sum per latent column."""
    vsub = _gather_v(V, block.col_map)
    z = torch.stack([_rowdot(block.X, vsub[:, :, k]) for k in range(rank)],
                    -1)
    # col_map means nothing in latent space; the solver never reads it.
    return dataclasses.replace(
        block, X=z,
        col_map=torch.zeros((block.n_entities, rank), dtype=torch.int32,
                            device=z.device),
        block_dim=rank)


class FactoredRandomEffectCoordinate(Coordinate):
    """Reference: ``FactoredRandomEffectCoordinate`` (see the module
    docstring).  State is ``(u_list, V)``: per-bucket latent tensors
    ``(E, rank)`` and the shared projection ``(n_features, rank)``.

    ``last_train`` holds what the latest ``train`` did: each alternation's
    latent-step :class:`~photon_ml_tpu_torch.game.coordinates.SolveStats`
    and projection-step ``SolveResult``, and each step's host seconds (both
    steps end in a host read)."""

    def __init__(
        self,
        name: str,
        dataset: RandomEffectDataset,
        task: str,
        config: GlmOptimizationConfig,
        rank: int,
        reg_weight: float = 0.0,
        projection_reg_weight: Optional[float] = None,
        alternations: int = 2,
        feature_shard: str = "global",
        entity_key: str = "",
        seed: int = 0,
    ):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.name = name
        self.dataset = dataset
        self.task = losses_lib.get(task).name
        self.loss = losses_lib.get(task)
        self.config = config
        self.rank = int(rank)
        self.reg_weight = reg_weight
        self.projection_reg_weight = (
            reg_weight if projection_reg_weight is None
            else projection_reg_weight)
        self.alternations = int(alternations)
        self.feature_shard = feature_shard
        self.entity_key = entity_key or name
        self._solver = BlockSolver(task, config)
        dev = self.device
        # A deterministic non-zero V₀, drawn as the reference draws it: with
        # U = 0 the projection gradient vanishes, so V must start
        # non-degenerate.
        self._v0 = torch.as_tensor((
            np.random.default_rng(seed).normal(
                size=(dataset.n_features, self.rank))
            / np.sqrt(max(self.rank, 1))).astype(np.float32), device=dev)
        self._grad_sum = self._whole_grad_sum()
        self.last_train: Optional[dict] = None

    def _whole_grad_sum(self) -> Optional[SortedSegmentSum]:
        """Every (bucket, lane, local column) term of the projection
        gradient → its global column, summed in one fixed order."""
        return _grad_sum([b.col_map for b in self.dataset.blocks],
                         self.dataset.n_features, self.device)

    @property
    def device(self) -> Optional[torch.device]:
        blocks = self.dataset.blocks
        return blocks[0].X.device if blocks else None

    def _reg(self):
        """(l1, l2, l2 of V) as the float32 values the reference's traced
        scalars hold."""
        reg = self.config.regularization
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        return (f32(reg.l1_weight(1.0) * self.reg_weight),
                f32(reg.l2_weight(1.0) * self.reg_weight),
                f32(self.projection_reg_weight))

    # -- the two steps --------------------------------------------------
    def block_offsets(self, offsets: Tensor) -> list[Tensor]:
        offsets = offsets.to(torch.float32)
        return [_gather_block_offsets(offsets, b)
                for b in self.dataset.blocks]

    def latent_step(self, offs: list, u_list: list, V: Tensor):
        """Every bucket's per-entity solve over Z = X V_sub at dim = rank,
        in lockstep.  Returns (u_list, SolveStats)."""
        l1, l2, _ = self._reg()
        items = [(_project_block(b, V, self.rank), off, u)
                 for b, off, u in zip(self.dataset.blocks, offs, u_list)]
        return self._solver.solve_all(items, l1, l2)

    def projection_value_grad(self, vflat: Tensor, offs: list,
                              u_list: list):
        """The objective in vec(V) with every latent fixed, and its
        gradient (deterministic column sums).  Both sum their terms in
        float64 (the value stays float64, the gradient returns to V's
        dtype), so a sum cut into other pieces, as the out-of-core
        coordinate's pass groups cut it, rounds to the same float32
        gradient."""
        _, _, l2v = self._reg()
        V = vflat.view(self.dataset.n_features, self.rank)
        v64 = vflat.double()
        val = 0.5 * l2v * ordered.dot(v64, v64)
        parts = []
        for block, off, u in zip(self.dataset.blocks, offs, u_list):
            m = _rowdot(block.X, _materialize(V, block.col_map, u)) + off
            val = val + (block.weights
                         * self.loss.value(m, block.labels)).double().sum()
            dm = block.weights * self.loss.d1(m, block.labels)  # (E, R)
            g_local = _coldot(dm, block.X)[:, :, None] * u[:, None, :]
            parts.append(g_local.reshape(-1, self.rank))
        g = (self._grad_sum(torch.cat(parts).double()).to(V.dtype) if parts
             else torch.zeros_like(V)) + l2v * V
        return val, g.reshape(-1)

    def projection_step(self, offs: list, u_list: list, V: Tensor):
        """One L-BFGS over vec(V).  Returns (V, SolveResult)."""
        opt = self.config.optimizer
        res = lbfgs_solve(
            lambda v: self.projection_value_grad(v, offs, u_list),
            V.reshape(-1),
            LBFGSConfig(max_iters=opt.max_iters, tolerance=opt.tolerance,
                        history=opt.history))
        return res.w.view(self.dataset.n_features, self.rank), res

    # -- Coordinate protocol --------------------------------------------
    def train(self, offsets: Tensor, warm_state=None):
        if warm_state is None:
            u_list = [torch.zeros((b.n_entities, self.rank),
                                  dtype=torch.float32, device=b.X.device)
                      for b in self.dataset.blocks]
            V = self._v0
        else:
            u_list, V = warm_state
        offs = self.block_offsets(offsets)
        record = {"latent": [], "projection": [], "latent_s": [],
                  "projection_s": []}
        for _ in range(self.alternations):
            t0 = time.perf_counter()
            u_list, stats = self.latent_step(offs, u_list, V)
            t1 = time.perf_counter()
            V, res = self.projection_step(offs, u_list, V)
            record["latent"].append(stats)
            record["projection"].append(res)
            record["latent_s"].append(t1 - t0)
            record["projection_s"].append(time.perf_counter() - t1)
        self.last_train = record
        return u_list, V

    def score(self, state) -> Tensor:
        return score_blocks(self.dataset.n_global_rows, self.dataset.blocks,
                            self.dataset.passive_blocks,
                            self.materialize(state), self.device)

    def materialize(self, state) -> list[Tensor]:
        """Per-bucket dense local coefficients (a plain random effect's
        state), for validation scorers and ``finalize``."""
        u_list, V = state
        return [_materialize(V, b.col_map, u)
                for b, u in zip(self.dataset.blocks, u_list)]

    def finalize(self, state, offsets=None) -> RandomEffectModel:
        return finalize_factored_model(self, state)

    def make_validation_scorer(self, shards: dict, ids: dict):
        from photon_ml_tpu_torch.game.validation import (
            FactoredValidationScorer,
            RandomEffectValidationScorer,
        )

        shard = shards[self.feature_shard]
        entity_col = ids.get(self.entity_key)
        if entity_col is None:
            entity_col = np.full(shard.shape[0], None, object)
        inner = RandomEffectValidationScorer(self.dataset, entity_col, shard,
                                             device=self.device)
        return FactoredValidationScorer(self, inner)


def finalize_factored_model(coord, state) -> RandomEffectModel:
    """The materialized table: the storage shape of a plain random effect.
    Coefficient variances are not defined through the factorization, so
    none are produced (as in the reference)."""
    table: dict = {}
    for block, ids, coefs in zip(coord.dataset.blocks,
                                 coord.dataset.entity_ids,
                                 coord.materialize(state)):
        col_parts, val_parts, _ = pack_entity_tables(
            to_numpy(block.col_map), to_numpy(coefs))
        for lane, key in enumerate(ids):
            table[key] = (col_parts[lane], val_parts[lane])
    return RandomEffectModel(
        coefficients=table,
        feature_shard=coord.feature_shard,
        entity_key=coord.entity_key,
        task=coord.task,
        n_features=coord.dataset.n_features,
        variances=None,
    )


class ShardedFactoredRandomEffectCoordinate(FactoredRandomEffectCoordinate):
    """The factored random effect over entity-sharded lanes (port of the
    reference's ``entity_sharded_factored_coordinate``): every block is
    split over the group (the reference's everything-split layout), each
    rank solves the latent step of its own lanes and sums its own lanes'
    projection terms; the projection step's value and float64 gradient are
    the ranks' partial sums added in rank order (one all-gather an
    evaluation, ``DataGroup.gather_sum``), so every rank takes the same
    L-BFGS steps over V and a group of k ranks gives the bits of k logical
    shards (``mesh=None, n_shards=k``).  ``self.dataset`` is the padded
    host dataset; the state is ``(u_list, V)`` with every block's whole
    padded ``(E, rank)`` latents on every rank."""

    def __init__(self, name: str, dataset: RandomEffectDataset, mesh,
                 task: str, config: GlmOptimizationConfig, rank: int,
                 reg_weight: float = 0.0,
                 projection_reg_weight: Optional[float] = None,
                 alternations: int = 2, feature_shard: str = "global",
                 entity_key: str = "", seed: int = 0,
                 n_shards: Optional[int] = None, device=None):
        from photon_ml_tpu_torch.device import resolve_device
        from photon_ml_tpu_torch.game.distributed import (
            _device_block,
            held_shards,
            lane_parts,
            shard_count,
            shard_dataset_entities,
        )

        k = shard_count(mesh, n_shards)
        self._device = resolve_device(device)
        padded = shard_dataset_entities(dataset, k)
        super().__init__(name, padded, task, config, rank,
                         reg_weight=reg_weight,
                         projection_reg_weight=projection_reg_weight,
                         alternations=alternations,
                         feature_shard=feature_shard, entity_key=entity_key,
                         seed=seed)
        self.mesh, self.n_shards = mesh, k
        split = [("split",)] * len(padded.blocks)
        self._parts_of = {s: lane_parts(padded.blocks, split, k, [s])
                          for s in range(k)}
        self._held = held_shards(mesh, k)
        self._parts = [p for s in self._held for p in self._parts_of[s]]
        passive = padded.passive_blocks or [None] * len(padded.blocks)
        dev = self._device
        self._local = [
            (_device_block(padded.blocks[p.block_idx], p.lane_lo, p.lane_hi,
                           dev),
             None if passive[p.block_idx] is None else _device_block(
                 passive[p.block_idx], p.lane_lo, p.lane_hi, dev))
            for p in self._parts]
        self._grad_sums = {
            s: _grad_sum([b.col_map for (b, _), p in zip(self._local,
                                                         self._parts)
                          if p.shard == s], padded.n_features, dev)
            for s in self._held}

    @property
    def device(self):
        return self._device

    def _whole_grad_sum(self) -> None:
        """None: a rank sums only its held shards' lanes (``_grad_sums``),
        so no table over the whole dataset reaches its card."""
        return None

    def _own(self, offsets, u_list, V):
        offsets = torch.as_tensor(offsets, dtype=torch.float32,
                                  device=self._device)
        offs = [_gather_block_offsets(offsets, b) for b, _ in self._local]
        u = [torch.zeros((p.lane_hi - p.lane_lo, self.rank),
                         dtype=torch.float32, device=self._device)
             if u_list is None else u_list[p.block_idx][p.lane_lo:p.lane_hi]
             for p in self._parts]
        return offs, u

    def latent_step(self, offs: list, u_list: list, V: Tensor):
        """The latent step of this process's lanes (``u_list`` a part)."""
        l1, l2, _ = self._reg()
        items = [(_project_block(b, V, self.rank), off, u)
                 for (b, _), off, u in zip(self._local, offs, u_list)]
        return self._solver.solve_all(items, l1, l2)

    def projection_value_grad(self, vflat: Tensor, offs: list,
                              u_list: list):
        from photon_ml_tpu_torch.parallel.distributed import sum_shards

        _, _, l2v = self._reg()
        nf = self.dataset.n_features
        V = vflat.view(nf, self.rank)
        payloads = []
        for s in self._held:
            val = torch.zeros((), dtype=torch.float64, device=V.device)
            parts = []
            for (block, _), p, off, u in zip(self._local, self._parts, offs,
                                             u_list):
                if p.shard != s:
                    continue
                m = _rowdot(block.X, _materialize(V, block.col_map, u)) + off
                val = val + (block.weights * self.loss.value(
                    m, block.labels)).double().sum()
                dm = block.weights * self.loss.d1(m, block.labels)
                g_local = _coldot(dm, block.X)[:, :, None] * u[:, None, :]
                parts.append(g_local.reshape(-1, self.rank))
            g = (self._grad_sums[s](torch.cat(parts).double()) if parts
                 else torch.zeros((nf, self.rank), dtype=torch.float64,
                                  device=V.device))
            payloads.append(torch.cat([val.reshape(1), g.reshape(-1)]))
        tot = sum_shards(payloads, self.mesh)
        v64 = vflat.double()
        value = 0.5 * l2v * ordered.dot(v64, v64) + tot[0]
        g = tot[1:].view(nf, self.rank).to(V.dtype) + l2v * V
        return value, g.reshape(-1)

    def train(self, offsets: Tensor, warm_state=None):
        from photon_ml_tpu_torch.game.distributed import place_lanes

        u_full, V = (None, self._v0) if warm_state is None else warm_state
        offs, u = self._own(offsets, u_full, V)
        record = {"latent": [], "projection": [], "latent_s": [],
                  "projection_s": []}
        for _ in range(self.alternations):
            t0 = time.perf_counter()
            u, stats = self.latent_step(offs, u, V)
            t1 = time.perf_counter()
            V, res = self.projection_step(offs, u, V)
            record["latent"].append(stats)
            record["projection"].append(res)
            record["latent_s"].append(t1 - t0)
            record["projection_s"].append(time.perf_counter() - t1)
        self.last_train = record
        shapes = [(b.n_entities, self.rank) for b in self.dataset.blocks]
        u_full = place_lanes(shapes, self._parts_of,
                             dict(zip(self._parts, u)), self.mesh,
                             self._device)
        return u_full, V

    def score(self, state) -> Tensor:
        u_full, V = state
        n = self.dataset.n_global_rows
        total = torch.zeros(n + 1, dtype=torch.float32, device=self._device)
        for (block, passive), p in zip(self._local, self._parts):
            w = _materialize(V, block.col_map,
                             u_full[p.block_idx][p.lane_lo:p.lane_hi])
            for b in (block, passive):
                if b is not None:
                    s = _rowdot(b.X, w) + 0.0
                    total.index_put_((b.row_index.reshape(-1).long(),),
                                     s.reshape(-1))
        total = total[:n].contiguous()
        return total if self.mesh is None else self.mesh.sum_scores(total)

    def materialize(self, state) -> list[Tensor]:
        u_list, V = state
        return [_materialize(V, torch.as_tensor(np.asarray(b.col_map),
                                                device=self._device), u)
                for b, u in zip(self.dataset.blocks, u_list)]
