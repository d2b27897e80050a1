"""Out-of-core FACTORED random effects: w_e = V u_e beyond the card (port of
``photon_ml_tpu/game/ooc_factored.py``).

The factored coordinate's entity blocks stream through the card in the
budget-bounded pass groups of ``game/ooc_random.py``, and the two
alternation sub-problems of ``game/factored.py`` become passes:

1. **latent step**: each pass group projects its slices through ``V`` (on
   the card for the whole pass) and runs every slice's ``BlockSolver``
   program at dimension ``rank`` in one lockstep; the latent vectors live
   in host numpy between passes;
2. **projection step**: the port's own ``lbfgs_solve`` over vec(V), whose
   every value/gradient evaluation is one pass over the groups.  Each
   slice's gradient terms are summed into the global columns it touches
   by the gather tables of a
   :class:`~photon_ml_tpu_torch.game.factored.SortedSegmentSum`, built
   once on the host from the slice's ``col_map`` (int32) and shipped with
   the slice in the pass group, so they are on the card only while the
   group is; the slices' sums are added in plan order, so the gradient has
   no atomics and repeats bitwise (the reference scatters with
   ``acc_g.at[idx].add``).

``V`` and its gradient are the only whole-pass state on the card; their
bytes come out of the budget before the groups are sized
(``_budget_overhead_bytes``).  The reference's plan counts a lane's block
leaves, latents and projected features; the projection step's group also
carries its slices' gather tables (about the size of their ``col_map``),
which that plan does not count.  State is ``(u_list, V)``: ``u_list`` host
numpy, ``V`` a tensor on the card.  ``V₀`` is drawn as the reference draws
it.  There is no hot cache and no prestage: the payloads are the
coordinate's own.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import to_numpy
from photon_ml_tpu_torch.game.coordinates import _coldot, _rowdot
from photon_ml_tpu_torch.game.data import EntityBlock, RandomEffectDataset
from photon_ml_tpu_torch.game.factored import (
    SortedSegmentSum,
    _materialize,
    _project_block,
    finalize_factored_model,
)
from photon_ml_tpu_torch.game.model import RandomEffectModel
from photon_ml_tpu_torch.game.ooc_random import (
    OutOfCoreRandomEffectCoordinate,
    _block_from,
    _cut,
    _slice_block,
)
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig, lbfgs_solve
from photon_ml_tpu_torch.optim.problem import GlmOptimizationConfig

Tensor = torch.Tensor


def _v_on(V, device) -> Tensor:
    """The projection as a float32 tensor on ``device`` (from a tensor or a
    host array, e.g. a checkpoint's)."""
    if isinstance(V, Tensor):
        return V.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(V, np.float32), device=device)


class OutOfCoreFactoredRandomEffectCoordinate(OutOfCoreRandomEffectCoordinate):
    """``FactoredRandomEffectCoordinate`` for datasets larger than the card:
    the same ``train(offsets, warm) → (u_list, V)`` / ``score(state)``
    surface, on the plain out-of-core coordinate's plan and pipeline.
    ``last_train`` holds each alternation's latent-step lockstep bodies and
    host reads, projection-step ``SolveResult`` and both steps'
    seconds."""

    # The projection step threads one (V, gradient) accumulator through
    # every part of a pass, so every block stays split over a group (the
    # reference's everything-split layout).
    _supports_packed = False

    def prestage(self, warm_state=None) -> None:
        # The factored train streams its own payloads, not the base class's
        # (block, w0) slices: nothing to stage.
        return None

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
        device_budget_bytes: int = 256 * 2**20,
        mesh=None,
        seed: int = 0,
        prefetch_depth: int = 2,
        device=None,
        n_shards: Optional[int] = None,
    ):
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        # The plan hooks read these during super().__init__.
        self.rank = int(rank)
        self._n_features = dataset.n_features
        super().__init__(
            name, dataset, task, config, reg_weight=reg_weight,
            feature_shard=feature_shard, entity_key=entity_key,
            device_budget_bytes=device_budget_bytes, mesh=mesh,
            prefetch_depth=prefetch_depth, device=device, n_shards=n_shards,
        )
        self.loss = losses_lib.get(self.task)
        self.projection_reg_weight = (
            reg_weight if projection_reg_weight is None
            else projection_reg_weight)
        self.alternations = int(alternations)
        dev = self.device
        # Same deterministic non-zero V₀ as the resident coordinate.
        self._v0 = torch.as_tensor((
            np.random.default_rng(seed).normal(
                size=(dataset.n_features, self.rank))
            / np.sqrt(max(self.rank, 1))).astype(np.float32), device=dev)
        opt = config.optimizer
        self._lbfgs_cfg = LBFGSConfig(max_iters=opt.max_iters,
                                      tolerance=opt.tolerance,
                                      history=opt.history)
        self.last_train: Optional[dict] = None

    # -- plan hooks ---------------------------------------------------------

    _ITEM_KINDS = ("train", "score", "projection")

    @functools.cached_property
    def _grad_tables(self) -> dict:
        """Per slice, the global columns its lanes touch and the
        :class:`SortedSegmentSum` tables that sum its gradient terms into
        them: int32 host arrays, built once and shipped with the slice in
        every projection pass (padding lanes and columns are -1 and
        drop).  Built on first use: the base class sizes the transfer
        slots from them while it is constructed."""
        out = {}
        for group in self.pass_plan:
            for s in group:
                cmap = _cut(self.dataset.blocks[s.block_idx].col_map,
                            s.lane_lo, s.lane_hi, s.padded_e,
                            -1).reshape(-1)
                valid = cmap >= 0
                cols, local = np.unique(cmap[valid], return_inverse=True)
                index = np.full(cmap.shape, -1, np.int64)
                index[valid] = local
                tables, final = SortedSegmentSum.host_tables(
                    index, len(cols), np.int32)
                out[s] = (cols.astype(np.int32), tables, final)
        return out

    def _extra_lane_bytes(self, block: EntityBlock) -> int:
        # Projected features Z (E, R, rank) next to X during the latent
        # step; latent vectors in and out.
        return 4 * (block.rows_per_entity * self.rank + 2 * self.rank)

    def _budget_overhead_bytes(self) -> int:
        # V and its gradient accumulator, resident for the whole pass.
        return 2 * 4 * (self._n_features + 1) * self.rank

    def _item_shapes(self, kind: str, s) -> list:
        b = self.dataset.blocks[s.block_idx]
        e, r, d = s.padded_e, b.rows_per_entity, b.block_dim
        f32, i32 = np.float32, np.int32
        if kind == "train":
            return [((e, r, d), f32), ((e, r), f32), ((e, r), f32),
                    ((e, d), i32), ((e, r), i32), ((e, self.rank), f32)]
        if kind == "projection":
            cols, tables, final = self._grad_tables[s]
            return self._item_shapes("train", s) + [
                (a.shape, i32) for a in (cols, *tables, final)]
        out = [((e, r, d), f32), ((e, d), i32), ((e, r), i32)]
        pb = self._passive(s.block_idx)
        if pb is not None:
            rp = pb.rows_per_entity
            out += [((e, rp, d), f32), ((e, d), i32), ((e, rp), i32)]
        return out + [((e, self.rank), f32)]

    def place_state(self, state, device):
        """``(u_list, V)``: the latents on the host, V on the card."""
        if state is None:
            return None
        u_list, V = state
        return ([np.array(to_numpy(u), np.float32) for u in u_list],
                _v_on(V, self.device))

    def _reg3(self):
        """(l1, l2, l2 of V) as the float32 values the reference's traced
        scalars hold."""
        f32 = lambda v: float(np.float32(v))  # noqa: E731
        l1, l2 = self._reg()
        return l1, l2, f32(self.projection_reg_weight)

    # -- coordinate surface -------------------------------------------------

    def _host_group(self, u_list, projection=False):
        """The pack of both steps: per slice its sliced block and its
        latent lanes (the latent step's warm start, the projection step's
        fixed latents), and in the projection step its gradient's columns
        and gather tables."""
        def host_group(gi):
            out = []
            for s in self.pass_plan[gi]:
                out.extend(self._slice_leaves(s))
                out.append(_cut(u_list[s.block_idx], s.lane_lo, s.lane_hi,
                                s.padded_e, 0))
                if projection:
                    cols, tables, final = self._grad_tables[s]
                    out += [cols, *tables, final]
            return out

        return host_group

    def latent_step(self, padded: Tensor, u_list: list, V: Tensor) -> dict:
        """One pass: every group's slices projected through ``V`` and solved
        at dim = rank in one lockstep, the latents written back into
        ``u_list`` (host, in place).  Returns the bodies a group and the
        host reads."""
        l1, l2, _ = self._reg3()
        bodies, reads = [], [0]

        def consume(gi, tensors):
            group = self.pass_plan[gi]
            items = self._unpack_train(group, tensors, None)
            progs = [self._solver.program(
                _project_block(blk, V, self.rank),
                self._gather(padded, blk.row_index), u0, l1, l2)
                for blk, u0 in items]
            b, r = self._solver.lockstep(progs)
            bodies.append(b)
            reads[0] += r + len(group)
            for s, p in zip(group, progs):
                u_list[s.block_idx][s.lane_lo:s.lane_hi] = to_numpy(
                    p.result()[: s.lane_hi - s.lane_lo])

        self._run_groups(self._host_group(u_list), consume)
        return {"bodies": bodies, "host_reads": reads[0]}

    def projection_value_grad(self, vflat: Tensor, padded: Tensor,
                              u_list: list):
        """The objective in vec(V) with every latent fixed and its gradient,
        as one pass: the data terms accumulate slice by slice in plan
        order, each slice's gradient through its deterministic column
        sum.  Over shards each shard accumulates its own parts, and the
        shards' sums are added in shard order (over a group, one
        all-gather: ``DataGroup.gather_sum``)."""
        _, _, l2v = self._reg3()
        nf, rank = self._n_features, self.rank
        Vm = vflat.view(nf, rank)
        # One (value, gradient) accumulator a held shard.
        accs = {r: {"val": torch.zeros((), dtype=torch.float64,
                                       device=self.device),
                    "g": torch.zeros((nf, rank), dtype=torch.float64,
                                     device=self.device)}
                for r in self._held}

        n = len(EntityBlock.LEAVES)

        def consume(gi, tensors):
            pos = 0
            for s in self.pass_plan[gi]:
                acc = accs[s.shard]
                k = len(self._grad_tables[s][1])
                like = dataclasses.replace(self.dataset.blocks[s.block_idx],
                                           n_entities=s.padded_e)
                blk = _block_from(like, tensors[pos:pos + n])
                u, cols = tensors[pos + n], tensors[pos + n + 1]
                tables = tensors[pos + n + 2:pos + n + 2 + k]
                final = tensors[pos + n + 2 + k]
                pos += n + 3 + k
                m = _rowdot(blk.X, _materialize(Vm, blk.col_map, u)) \
                    + self._gather(padded, blk.row_index)
                acc["val"] = acc["val"] + (
                    blk.weights * self.loss.value(m, blk.labels)
                ).double().sum()
                dm = blk.weights * self.loss.d1(m, blk.labels)
                g_local = _coldot(dm, blk.X)[:, :, None] * u[:, None, :]
                # The columns of one slice are distinct: a plain indexed
                # add, no atomics.
                acc["g"][cols] += SortedSegmentSum.apply(
                    g_local.reshape(-1, rank).double(), tables, final)

        self._run_groups(self._host_group(u_list, projection=True), consume)
        v64 = vflat.double()
        if self.mesh is None and len(self._held) == 1:
            acc = accs[self._held[0]]
            val, g = acc["val"], acc["g"]
        else:
            from photon_ml_tpu_torch.parallel.distributed import sum_shards

            tot = sum_shards([torch.cat([accs[r]["val"].reshape(1),
                                         accs[r]["g"].reshape(-1)])
                              for r in self._held], self.mesh)
            val, g = tot[0], tot[1:].view(nf, rank)
        return (val + 0.5 * l2v * ordered.dot(v64, v64),
                (g.to(Vm.dtype) + l2v * Vm).reshape(-1))

    def projection_step(self, padded: Tensor, u_list: list, V: Tensor):
        """One L-BFGS over vec(V), one pass an evaluation.  Returns (V,
        SolveResult)."""
        res = lbfgs_solve(
            lambda v: self.projection_value_grad(v, padded, u_list),
            V.reshape(-1), self._lbfgs_cfg)
        return res.w.view(self._n_features, self.rank), res

    def train(self, offsets, warm_state=None):
        padded = self._padded_offsets(offsets)
        if warm_state is None:
            u_list = [np.zeros((b.n_entities, self.rank), np.float32)
                      for b in self.dataset.blocks]
            V = self._v0
        else:
            u_warm, V = warm_state
            u_list = [np.array(to_numpy(u), np.float32) for u in u_warm]
            V = _v_on(V, self.device)
        record = {"latent": [], "projection": [], "latent_s": [],
                  "projection_s": []}
        for _ in range(self.alternations):
            t0 = time.perf_counter()
            stats = self.latent_step(padded, u_list, V)
            t1 = time.perf_counter()
            V, res = self.projection_step(padded, u_list, V)
            record["latent"].append(stats)
            record["projection"].append(res)
            record["latent_s"].append(t1 - t0)
            record["projection_s"].append(time.perf_counter() - t1)
        self.last_train = record
        return self._exchange(u_list), V

    def _slice_leaves(self, s) -> tuple:
        return _slice_block(self.dataset.blocks[s.block_idx], s.lane_lo,
                            s.lane_hi, s.padded_e,
                            self.dataset.n_global_rows).leaves()

    def score(self, state) -> Tensor:
        u_list, V = state
        V = _v_on(V, self.device)
        sentinel = self.dataset.n_global_rows
        total = torch.zeros(sentinel + 1, dtype=torch.float32,
                            device=self.device)

        def host_group(gi):
            out = []
            for s in self.pass_plan[gi]:
                lo, hi, e = s.lane_lo, s.lane_hi, s.padded_e
                for b in (self.dataset.blocks[s.block_idx],
                          self._passive(s.block_idx)):
                    if b is not None:
                        out += [_cut(b.X, lo, hi, e, 0),
                                _cut(b.col_map, lo, hi, e, -1),
                                _cut(b.row_index, lo, hi, e, sentinel)]
                out.append(_cut(np.asarray(to_numpy(u_list[s.block_idx]),
                                           np.float32), lo, hi, e, 0))
            return out

        def consume(gi, tensors):
            pos = 0
            for s in self.pass_plan[gi]:
                n = 6 if self._passive(s.block_idx) is not None else 3
                parts, u = tensors[pos:pos + n], tensors[pos + n]
                pos += n + 1
                for X, cmap, row_index in zip(parts[0::3], parts[1::3],
                                              parts[2::3]):
                    sc = _rowdot(X, _materialize(V, cmap, u)) + 0.0
                    total.index_put_((row_index.reshape(-1).long(),),
                                     sc.reshape(-1))

        self._run_groups(host_group, consume)
        return self._sum_scores(total)

    def materialize(self, state) -> list[np.ndarray]:
        """Per-bucket dense local coefficients ``w_e = V u_e``, computed
        slice by slice (no whole block rides to the card); the validation
        scorer and ``finalize`` share it."""
        u_list, V = state
        V = _v_on(V, self.device)
        out = [np.zeros((b.n_entities, b.block_dim), np.float32)
               for b in self.dataset.blocks]
        for group in self.slice_plan:
            for s in group:
                lo, hi, e = s.lane_lo, s.lane_hi, s.padded_e
                cmap = torch.as_tensor(np.ascontiguousarray(_cut(
                    self.dataset.blocks[s.block_idx].col_map, lo, hi, e,
                    -1)), device=self.device)
                u = torch.as_tensor(_cut(np.asarray(
                    to_numpy(u_list[s.block_idx]), np.float32), lo, hi, e,
                    0), device=self.device)
                out[s.block_idx][lo:hi] = to_numpy(
                    _materialize(V, cmap, u)[: hi - lo])
        return out

    def finalize(self, state, offsets=None) -> RandomEffectModel:
        return finalize_factored_model(self, state)

    def make_validation_scorer(self, shards: dict, ids: dict):
        from photon_ml_tpu_torch.game.validation import (
            FactoredValidationScorer,
        )

        return FactoredValidationScorer(
            self, super().make_validation_scorer(shards, ids))
