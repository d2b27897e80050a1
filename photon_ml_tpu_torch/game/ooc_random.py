"""Out-of-core random effects: entity blocks larger than the card (port of
``photon_ml_tpu/game/ooc_random.py``).

The per-entity solves are independent (no cross-block state beyond the
shared per-row offsets), so the blocks stream through the card the way the
chunk store streams fixed-effect rows:

1. the dataset is built on the host (``build_random_effect_dataset(...,
   device=False)``);
2. oversized blocks are split along the ENTITY axis into slices of one
   padded lane count a block (the last slice pads with zero-weight lanes,
   which solve to w = 0 under any L2);
3. slices are packed into PASS GROUPS whose bytes fit ``budget /
   prefetch_depth``: the prefetch pipeline keeps up to ``prefetch_depth``
   groups live on the card (the group being solved and the ones being
   transferred);
4. per-entity coefficients live in host numpy between passes; only the
   per-row offset and score arrays stay on the card.

The plan (``_Slice``, ``_lane_bytes``, ``_cut``, ``_slice_block``,
``_build_plan``) is the reference's arithmetic, so the same dataset and
budget give the same slices and groups.  Each group crosses the link as one
item of :class:`~photon_ml_tpu_torch.data.prefetch.HostToDevice` (one
pinned buffer and one copy a dtype, slots sized from the whole plan up
front), and every slice of a group runs in ONE
:meth:`~photon_ml_tpu_torch.game.coordinates.BlockSolver.lockstep`: one host
read a round for the group, then one device-to-host copy a slice writes its
lanes back into the host ``(E, D)`` state.  Scoring writes each row once
with the non-accumulating ``index_put_`` of ``score_blocks`` (padding lanes
land in the sentinel slot), passive blocks after their active slice.

Within one plan the results are bitwise the same at any ``prefetch_depth``,
with or without the hot working-set cache, prestaged or not, and from a
disk-spilled (memmap) dataset: the same programs run on the same slices in
the same order.  Across plans (another budget, or the resident coordinate)
a lane's reductions may split differently, so those agree to tolerance.

**Over a process group** (``mesh``; or ``n_shards`` logical shards in
one process) the blocks are placed by ``game/hierarchical.py``'s
:func:`plan_bucket_shards` (``split_factor`` its threshold) and the slices
inherit their block's placement, as in the reference: a split slice's
padded lanes (a multiple of the group size) divide over the ranks in
contiguous runs, a packed slice is streamed only by its rank.
``slice_plan`` is the reference's plan; ``pass_plan`` holds the parts this
process streams (a part is a slice of its own: a rank's lanes of a split
slice, or a whole packed slice), each group's parts in one lockstep.
After a train pass the ranks' lanes are exchanged in one all-gather so
every rank holds the whole host state; a score is each rank's scatter of
its own parts summed over the group.  The reference's single-host guard is
kept: a group that spans more than one host is refused.

The reference's telemetry is kept: the plan's
``game_shard_imbalance_ratio`` gauge and the prestage's
``game_coordinate_overlap_seconds`` counter, and its ``game.bucket_shard``
fault site, once a pass group of a train pass.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.data.prefetch import (
    HostToDevice,
    TransferStats,
    run_prefetched,
)
from photon_ml_tpu_torch.device import resolve_device, to_numpy
from photon_ml_tpu_torch.game.coordinates import (
    RandomEffectCoordinate,
    _coldot,
    _rowdot,
)
from photon_ml_tpu_torch.game.data import EntityBlock, RandomEffectDataset
from photon_ml_tpu_torch.game.distributed import (
    exchange_lanes,
    held_shards,
    shard_count,
)
from photon_ml_tpu_torch.game.hierarchical import plan_bucket_shards
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.optim.problem import GlmOptimizationConfig
from photon_ml_tpu_torch.optim.streaming import HotChunkCache

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class _Slice:
    """One schedulable unit: lanes [lane_lo, lane_hi) of block
    ``block_idx``, padded to ``padded_e`` entities (one count for every
    slice of a block).  ``placement`` is the block's placement over a group
    (``("split",)`` without one)."""

    block_idx: int
    lane_lo: int
    lane_hi: int
    padded_e: int
    bytes: int
    placement: tuple = ("split",)
    shard: int = 0  # the shard that streams it (a part of a slice)


def _lane_bytes(block: EntityBlock, passive: Optional[EntityBlock]) -> int:
    """Device bytes one entity lane costs in a pass: active leaves + the
    gathered offsets + coefficients in and out, plus the lane's score-only
    passive companion (one conservative number keeps train and score on a
    single plan)."""
    r, d = block.rows_per_entity, block.block_dim
    active = 4 * (r * d + 4 * r + 2 * d)  # X, labels/weights/row_index/off, cmap+w
    out = 4 * d
    psv = 0
    if passive is not None:
        rp = passive.rows_per_entity
        psv = 4 * (rp * d + 3 * rp)  # Xp, labels/weights/row_index
    return active + out + psv


def _cut(x, lo: int, hi: int, padded_e: int, fill):
    """Entity-axis slice [lo, hi) padded to ``padded_e`` lanes with
    ``fill``."""
    x = x[lo:hi]
    pad = padded_e - x.shape[0]
    if pad == 0:
        return x
    width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, width, constant_values=fill)


def _slice_block(block: EntityBlock, lo: int, hi: int, padded_e: int,
                 sentinel: int) -> EntityBlock:
    """Host entity-axis slice [lo, hi), padded to ``padded_e`` lanes.
    Padding lanes carry zero weights (solve to 0), col_map -1 and sentinel
    row indices (their scores land in the discarded trailing slot)."""
    return EntityBlock(
        X=_cut(block.X, lo, hi, padded_e, 0),
        labels=_cut(block.labels, lo, hi, padded_e, 0),
        weights=_cut(block.weights, lo, hi, padded_e, 0),
        col_map=_cut(block.col_map, lo, hi, padded_e, -1),
        row_index=_cut(block.row_index, lo, hi, padded_e, sentinel),
        n_entities=padded_e,
        rows_per_entity=block.rows_per_entity,
        block_dim=block.block_dim,
    )


def _block_from(like: EntityBlock, leaves) -> EntityBlock:
    """A block of ``like``'s shape over ``leaves`` (``EntityBlock.LEAVES``
    order, e.g. the transferred tensors)."""
    return dataclasses.replace(like, **dict(zip(EntityBlock.LEAVES, leaves)))


def _host_leaf(x) -> None:
    if isinstance(x, torch.Tensor):
        raise ValueError(
            "out-of-core random effects need a HOST-resident dataset — "
            "build it with build_random_effect_dataset(..., device=False)"
        )


class _Window:
    """Bounds the device work queued ahead of the host: after each group an
    event is recorded on the compute stream, and the host waits for the
    one ``depth`` groups back (every group at depth 1), so the card holds
    O(``prefetch_depth``) groups' buffers whatever the plan's length."""

    def __init__(self, device: torch.device, depth: int):
        self.cuda = device.type == "cuda"
        self.window = 0 if depth == 1 else depth
        self.pending: collections.deque = collections.deque()

    def step(self) -> None:
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.pending.append(ev)
        if len(self.pending) > self.window:
            self.pending.popleft().synchronize()


class OutOfCoreRandomEffectCoordinate(RandomEffectCoordinate):
    """``RandomEffectCoordinate`` whose dataset exceeds the card.

    The same ``train(offsets, warm) → state`` / ``score(state)`` surface as
    the resident coordinate and the same per-lane math (the same
    ``BlockSolver`` programs run on each slice; slicing and padding never
    change a lane's arithmetic).  State is a list of HOST ``(E, D)`` numpy
    arrays.  ``last_solve`` holds the bodies of each group's lockstep and
    the host reads of the latest ``train``; ``transfer_stats`` the
    pipeline's per-stage times across passes; ``live_groups_high_water``
    the most groups live on the card in the latest pass (≤
    ``prefetch_depth``).
    """

    def __init__(
        self,
        name: str,
        dataset: RandomEffectDataset,
        task: str,
        config: GlmOptimizationConfig,
        reg_weight: float = 0.0,
        feature_shard: str = "global",
        entity_key: str = "",
        device_budget_bytes: int = 256 * 2**20,
        mesh=None,
        prefetch_depth: int = 2,
        split_factor: float = 0.5,
        hot_budget_bytes: int = 0,
        device=None,
        n_shards: Optional[int] = None,
    ):
        if not 0.0 < split_factor <= 1.0:
            raise ValueError(
                f"split_factor must lie in (0, 1], got {split_factor!r}")
        if mesh is not None:
            from photon_ml_tpu_torch.parallel.multihost import spans_hosts

            if spans_hosts(mesh):
                raise NotImplementedError(
                    "out-of-core random effects are single-host: entity "
                    "blocks live in one process's RAM, and a group that "
                    "spans more than one host is refused")
        # The bucket placement's threshold: with one shard there is no
        # placement, and the reference ignores it as the port does.
        self.split_factor = float(split_factor)
        self.mesh = mesh
        self.n_shards = (1 if mesh is None and n_shards is None
                         else shard_count(mesh, n_shards))
        self._held = held_shards(mesh, self.n_shards)
        super().__init__(name, dataset, task, config, reg_weight,
                         feature_shard=feature_shard, entity_key=entity_key)
        self.device_budget_bytes = int(device_budget_bytes)
        if prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}")
        self.prefetch_depth = int(prefetch_depth)
        self.transfer_stats = TransferStats()
        self._device = resolve_device(device)
        for b in list(dataset.blocks) + [
                p for p in dataset.passive_blocks if p is not None]:
            for leaf in b.leaves():
                _host_leaf(leaf)
        k = self.n_shards
        self.bucket_plan = (
            plan_bucket_shards(dataset.blocks, k, split_factor=split_factor)
            if k > 1 and self._supports_packed else None)
        if self.bucket_plan is not None:
            telemetry_mod.current().gauge(
                "game_shard_imbalance_ratio"
            ).set(self.bucket_plan.imbalance_ratio)
        self.slice_plan = self._build_plan()
        # Each shard's parts, group by group (aligned with slice_plan).
        self._parts_of = {r: [self._parts(group, r)
                              for group in self.slice_plan]
                          for r in range(k)}
        self.pass_plan = [g for g in (
            [p for r in self._held for p in self._parts_of[r][gi]]
            for gi in range(len(self.slice_plan))) if g]
        #: high-water mark of pass groups with live device buffers in the
        #: latest pass: the bounded-memory witness (≤ prefetch_depth).
        self.live_groups_high_water = 0
        self._prestage_rec = None
        self._mover = HostToDevice(self._device, self.prefetch_depth)
        self._mover.reserve(self._max_item_totals())
        if hot_budget_bytes < 0:
            raise ValueError(
                f"hot_budget_bytes must be >= 0, got {hot_budget_bytes}")
        # Hot working-set cache: a hot group's STATIC slice payloads (the
        # train path's sliced blocks, the score path's (X, row_index)
        # pairs) stay on the card, so later passes skip their pack and
        # transfer and move only the warm starts or coefficients.  Blocks
        # never change, so entries never go stale; the wanted set is picked
        # once, biggest transfers first.
        self.hot_budget_bytes = int(hot_budget_bytes)
        self._hot_cache = None
        self._hot_bytes: dict = {}
        if self.hot_budget_bytes:
            self._hot_cache = HotChunkCache(self.hot_budget_bytes)
            for gi, group in enumerate(self.pass_plan):
                for kind in ("train", "score"):
                    self._hot_bytes[(kind, gi)] = self._group_static_bytes(
                        kind, group)
            self._hot_cache.replan(self._hot_bytes,
                                   self._hot_bytes.__getitem__)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def hot_cache(self) -> Optional[HotChunkCache]:
        return self._hot_cache

    def place_state(self, state, device):
        """Restored states stay on the host: per-bucket float32 arrays."""
        if state is None:
            return None
        return [np.array(to_numpy(s), np.float32) for s in state]

    # -- pass planning -----------------------------------------------------

    #: Whether blocks may pack whole onto one shard (the factored
    #: coordinate keeps every block split, as the reference does).
    _supports_packed = True

    def _placement(self, bi: int) -> tuple:
        return (("split",) if self.bucket_plan is None
                else self.bucket_plan.placements[bi])

    def _parts(self, group, r: int) -> list:
        """The parts of ``group``'s slices shard ``r`` streams: its
        contiguous run of a split slice's padded lanes (real lanes first,
        then padding), or a slice packed onto it whole."""
        out = []
        k = self.n_shards
        for s in group:
            if s.placement[0] == "pack":
                if s.placement[1] == r:
                    out.append(dataclasses.replace(s, shard=r))
                continue
            per = s.padded_e // k
            lo = min(s.lane_lo + r * per, s.lane_hi)
            hi = min(s.lane_lo + (r + 1) * per, s.lane_hi)
            per_lane = s.bytes // s.padded_e
            out.append(_Slice(s.block_idx, lo, hi, per, per_lane * per,
                              s.placement, r))
        return out

    def _build_plan(self) -> list[list[_Slice]]:
        """Split blocks along the entity axis and pack slices into groups:
        each block is cut into ``n_parts`` slices of one padded lane count
        (ceil division); groups fill greedily to the per-pass budget
        ``(budget - overhead) / prefetch_depth``."""
        budget = (
            self.device_budget_bytes - self._budget_overhead_bytes()
        ) // self.prefetch_depth
        if budget <= 0:
            raise ValueError(
                f"random-effect coordinate {self.name!r}: "
                f"device_budget_bytes={self.device_budget_bytes} does not "
                f"cover the {self._budget_overhead_bytes()}-byte "
                "whole-pass-resident overhead"
            )
        plan: list[list[_Slice]] = []
        group: list[_Slice] = []
        group_bytes = 0
        for bi, block in enumerate(self.dataset.blocks):
            passive = (self.dataset.passive_blocks[bi]
                       if self.dataset.passive_blocks else None)
            # The lane quantum: a split slice needs one lane a shard; a
            # packed (or unsharded) slice runs whole on one.
            placement = self._placement(bi)
            q = (self.n_shards if self.n_shards > 1
                 and placement[0] == "split" else 1)
            per_lane = (_lane_bytes(block, passive)
                        + self._extra_lane_bytes(block))
            e = block.n_entities
            if per_lane * q > budget:
                raise ValueError(
                    f"random-effect coordinate {self.name!r}: one "
                    f"{q}-entity slice of block {bi} "
                    f"(R={block.rows_per_entity}, D={block.block_dim}) "
                    f"needs {per_lane * q} bytes, over the "
                    f"per-pass budget {budget} (= (device_budget_bytes "
                    f"- {self._budget_overhead_bytes()} overhead) / "
                    f"prefetch_depth={self.prefetch_depth}). "
                    "Raise device_budget_bytes or lower "
                    "max_rows_per_entity / bucket_growth"
                )
            lanes_per_pass = max(q, (budget // per_lane) // q * q)
            n_parts = max(1, -(-e // lanes_per_pass))  # ceil
            sub_e = -(-e // n_parts)
            sub_e = ((sub_e + q - 1) // q) * q
            for lo in range(0, e, sub_e):
                hi = min(lo + sub_e, e)
                s = _Slice(bi, lo, hi, sub_e, per_lane * sub_e, placement)
                if group and group_bytes + s.bytes > budget:
                    plan.append(group)
                    group, group_bytes = [], 0
                group.append(s)
                group_bytes += s.bytes
        if group:
            plan.append(group)
        return plan

    def _group_static_bytes(self, kind: str, group) -> int:
        """Wire bytes of one group's pass-invariant payloads: the train
        path's sliced blocks, or the score path's (X, row_index) active and
        passive pairs.  The hot cache's budget arithmetic."""
        total = 0
        for s in group:
            b = self.dataset.blocks[s.block_idx]
            r, d = b.rows_per_entity, b.block_dim
            if kind == "train":
                per = 4 * (r * d + 3 * r + d)
            else:
                per = 4 * (r * d + r)
                pb = self._passive(s.block_idx)
                if pb is not None:
                    rp = pb.rows_per_entity
                    per += 4 * (rp * d + rp)
            total += per * s.padded_e
        return total

    def _extra_lane_bytes(self, block: EntityBlock) -> int:
        """Subclass hook: device bytes one lane costs beyond the raw block
        leaves (the factored variant's projected features and latents)."""
        return 0

    def _budget_overhead_bytes(self) -> int:
        """Subclass hook: device bytes resident for the WHOLE pass (the
        factored projection and its gradient), carved out of the budget
        before groups are sized."""
        return 0

    def _passive(self, bi: int) -> Optional[EntityBlock]:
        pbs = self.dataset.passive_blocks
        return pbs[bi] if pbs else None

    #: The kinds of transfer a pass sends (``_item_shapes``' ``kind``).
    _ITEM_KINDS = ("train", "score")

    def _item_shapes(self, kind: str, s: _Slice) -> list:
        """(shape, dtype) of each array one slice adds to a ``kind``
        transfer (one of ``_ITEM_KINDS``), in payload order."""
        b = self.dataset.blocks[s.block_idx]
        e, r, d = s.padded_e, b.rows_per_entity, b.block_dim
        f32, i32 = np.float32, np.int32
        if kind == "train":
            return [((e, r, d), f32), ((e, r), f32), ((e, r), f32),
                    ((e, d), i32), ((e, r), i32), ((e, d), f32)]
        out = [((e, r, d), f32), ((e, r), i32)]
        pb = self._passive(s.block_idx)
        if pb is not None:
            out += [((e, pb.rows_per_entity, d), f32),
                    ((e, pb.rows_per_entity), i32)]
        return out + [((e, d), f32)]

    def _max_item_totals(self) -> dict:
        """Per dtype, the most elements any group's transfer needs: the
        pinned slots' size, allocated once up front."""
        out: dict = {}
        for group in self.pass_plan:
            for kind in self._ITEM_KINDS:
                totals, _ = HostToDevice.layout([
                    spec for s in group
                    for spec in self._item_shapes(kind, s)])
                for dt, n in totals.items():
                    out[dt] = max(out.get(dt, 0), n)
        return out

    # -- the group pipeline -------------------------------------------------

    def _put_group(self, packed):
        """One group's transfer (the transfer thread's stage; tests hook it
        to count dispatched-but-unconsumed groups)."""
        return self._mover.put(packed)

    def _run_groups(self, make_host_group, consume) -> None:
        """The prefetch pipeline over the plan (``data/prefetch.py``): the
        pack thread builds group k+1's host arrays into a pinned slot while
        group k's bytes cross the link on the copy stream and the caller
        consumes the group before.  ``make_host_group(gi) → arrays`` (a flat
        list); ``consume(gi, tensors)`` gets the group's device tensors in
        the same order.  At most ``prefetch_depth`` groups are admitted
        (the permit accounting), and a window of compute-stream events
        keeps the device work queued behind the host to as many."""
        plan = self.pass_plan
        self.live_groups_high_water = 0
        if not plan:
            return
        mover = self._mover
        window = _Window(self._device, self.prefetch_depth)

        def on_item(gi, dev):
            consume(gi, mover.ready(dev))
            window.step()

        abort = threading.Event()
        mover.begin_pass(abort)
        self.live_groups_high_water = run_prefetched(
            len(plan), lambda gi: mover.pack(make_host_group(gi)),
            self._put_group, on_item, depth=self.prefetch_depth,
            stats=self.transfer_stats, abort=abort,
        )

    # -- pipelined-descent prestage -----------------------------------------

    def _train_state_init(self, warm_state) -> list[np.ndarray]:
        return [
            np.zeros((b.n_entities, b.block_dim), np.float32)
            if warm_state is None
            # a copy: this buffer is written into, and a warm state may be
            # a read-only view (a checkpoint's arrays) or a tensor
            else np.array(to_numpy(warm_state[bi]), np.float32)
            for bi, b in enumerate(self.dataset.blocks)
        ]

    def _train_host_group(self, group, state, with_blocks=True) -> list:
        """One group's train payload: per slice its sliced block (unless
        ``with_blocks`` is False: the hot path) and its warm-start lanes."""
        sentinel = self.dataset.n_global_rows
        out = []
        for s in group:
            if with_blocks:
                out.extend(_slice_block(self.dataset.blocks[s.block_idx],
                                        s.lane_lo, s.lane_hi, s.padded_e,
                                        sentinel).leaves())
            out.append(_cut(state[s.block_idx], s.lane_lo, s.lane_hi,
                            s.padded_e, 0))
        return out

    def prestage(self, warm_state=None) -> None:
        """Pack the first ``prefetch_depth`` groups' host payloads on a
        background thread while ANOTHER coordinate's solve owns the
        foreground (the pipelined descent, ``game/descent.py``).  Packing
        depends on (dataset, plan, warm state) only, so the staged payloads
        are byte-identical to what ``train``'s pack thread would build and
        results stay bitwise the unpipelined run's.  The thread builds numpy
        arrays only and touches no CUDA state.  The buffers are keyed to
        this exact ``warm_state`` object; a train call with another warm
        state discards them."""
        self._drop_prestage()
        if not self.pass_plan:
            return
        n = min(self.prefetch_depth, len(self.pass_plan))
        rec = {"warm": warm_state, "buf": {}, "t0": time.perf_counter(),
               "t_end": None}

        def work():
            try:
                state = self._train_state_init(warm_state)
                for gi in range(n):
                    rec["buf"][gi] = self._train_host_group(
                        self.pass_plan[gi], state)
            finally:
                rec["t_end"] = time.perf_counter()

        rec["thread"] = threading.Thread(target=work,
                                         name="game-ooc-prestage",
                                         daemon=True)
        self._prestage_rec = rec
        rec["thread"].start()

    def _drop_prestage(self) -> None:
        rec, self._prestage_rec = self._prestage_rec, None
        if rec is not None:
            rec["thread"].join()

    def _take_prestage(self, warm_state) -> dict:
        rec, self._prestage_rec = self._prestage_rec, None
        if rec is None:
            return {}
        t_take = time.perf_counter()
        rec["thread"].join()
        if rec["warm"] is not warm_state:
            # A stale hint: its payloads carry other warm-start lanes.
            return {}
        # Host seconds of packing that overlapped the foreground solve.
        overlap = max(0.0, min(rec["t_end"], t_take) - rec["t0"])
        telemetry_mod.current().counter(
            "game_coordinate_overlap_seconds"
        ).inc(overlap)
        return rec["buf"]

    # -- coordinate surface ------------------------------------------------

    def _padded_offsets(self, offsets) -> Tensor:
        """The per-row offsets on the card with the sentinel's zero slot
        appended, once a pass."""
        off = torch.as_tensor(offsets, dtype=torch.float32,
                              device=self._device)
        return torch.cat([off, off.new_zeros(1)])

    @staticmethod
    def _gather(padded: Tensor, row_index: Tensor) -> Tensor:
        return padded.index_select(0, row_index.reshape(-1)).view(
            row_index.shape)

    def _unpack_train(self, group, tensors, resident):
        """The group's (block, w0) per slice from its transferred tensors
        (blocks from the hot cache when ``resident``)."""
        out, pos = [], 0
        n = len(EntityBlock.LEAVES)
        for si, s in enumerate(group):
            like = self.dataset.blocks[s.block_idx]
            like = dataclasses.replace(like, n_entities=s.padded_e)
            if resident is None:
                blk = _block_from(like, tensors[pos:pos + n])
                pos += n
            else:
                blk = resident[si]
            out.append((blk, tensors[pos]))
            pos += 1
        return out

    def train(self, offsets, warm_state=None) -> list[np.ndarray]:
        l1, l2 = self._reg()
        padded = self._padded_offsets(offsets)
        prestaged = self._take_prestage(warm_state)
        state = self._train_state_init(warm_state)
        hot = self._probe_hot("train")
        bodies: list = []
        reads = [0]

        def host_group(gi):
            if gi in prestaged:
                payload = prestaged.pop(gi)
                if gi in hot:
                    # Prestaged before this pass knew its hot set: keep the
                    # warm-start lanes only.
                    k = len(EntityBlock.LEAVES) + 1
                    payload = payload[k - 1::k]
                return payload
            return self._train_host_group(self.pass_plan[gi], state,
                                          with_blocks=gi not in hot)

        def consume(gi, tensors):
            group = self.pass_plan[gi]
            # The per-group dispatch seam (mirrors the resident bucket
            # plan's): a fault here aborts the update mid-pass; the solves
            # are pure functions of (block, offsets, w0), so the retried
            # update is bitwise the uninterrupted one.
            chaos_mod.maybe_fail(
                "game.bucket_shard", coordinate=self.name,
                slices=len(group),
            )
            resident = hot.get(gi)
            items = self._unpack_train(group, tensors, resident)
            progs = [self._solver.program(blk, self._gather(padded,
                                                            blk.row_index),
                                          w0, l1, l2)
                     for blk, w0 in items]
            b, r = self._solver.lockstep(progs)
            bodies.append(b)
            reads[0] += r
            # One device-to-host copy a slice, after the group's lockstep.
            for s, p in zip(group, progs):
                state[s.block_idx][s.lane_lo:s.lane_hi] = to_numpy(
                    p.result()[: s.lane_hi - s.lane_lo])
            reads[0] += len(group)
            if self._hot_cache is not None and resident is None:
                self._hot_cache.maybe_admit(
                    ("train", gi), [blk for blk, _ in items],
                    self._hot_bytes[("train", gi)])

        self._run_groups(host_group, consume)
        self.last_solve = {"bodies": bodies, "host_reads": reads[0],
                           "groups": len(self.pass_plan),
                           "slices": sum(map(len, self.pass_plan))}
        return self._exchange(state)

    def _exchange(self, state: list) -> list:
        """Every rank's solved lanes into every rank's host state (one
        all-gather); logical shards wrote them all already."""
        if self.mesh is not None:
            exchange_lanes(state, {
                r: [p for g in groups for p in g if p.lane_hi > p.lane_lo]
                for r, groups in self._parts_of.items()},
                self.mesh, self._device)
        return state

    def _sum_scores(self, total: Tensor) -> Tensor:
        """This process's scatter of its parts → the whole score vector."""
        total = total[:self.dataset.n_global_rows]
        if self.mesh is None:
            return total
        return self.mesh.sum_scores(total.contiguous())

    def _probe_hot(self, kind: str) -> dict:
        """Resident static payloads by group for this pass: one cache probe
        a group, before the pipeline's threads start."""
        hot: dict = {}
        if self._hot_cache is not None:
            for gi in range(len(self.pass_plan)):
                d = self._hot_cache.get((kind, gi))
                if d is not None:
                    hot[gi] = d
        return hot

    def score(self, state) -> Tensor:
        sentinel = self.dataset.n_global_rows
        total = torch.zeros(sentinel + 1, dtype=torch.float32,
                            device=self._device)
        hot = self._probe_hot("score")

        def host_group(gi):
            # Score-only payloads: X and row_index (active, then passive)
            # and the coefficients; a hot group's statics are resident.
            out = []
            for s in self.pass_plan[gi]:
                lo, hi, e = s.lane_lo, s.lane_hi, s.padded_e
                if gi not in hot:
                    block = self.dataset.blocks[s.block_idx]
                    out += [_cut(block.X, lo, hi, e, 0),
                            _cut(block.row_index, lo, hi, e, sentinel)]
                    pb = self._passive(s.block_idx)
                    if pb is not None:
                        out += [_cut(pb.X, lo, hi, e, 0),
                                _cut(pb.row_index, lo, hi, e, sentinel)]
                out.append(_cut(np.asarray(to_numpy(state[s.block_idx]),
                                           np.float32), lo, hi, e, 0))
            return out

        def consume(gi, tensors):
            resident = hot.get(gi)
            statics, pos = [], 0
            for si, s in enumerate(self.pass_plan[gi]):
                if resident is None:
                    pairs = [tuple(tensors[pos:pos + 2])]
                    pos += 2
                    if self._passive(s.block_idx) is not None:
                        pairs.append(tuple(tensors[pos:pos + 2]))
                        pos += 2
                else:
                    pairs = resident[si]
                coefs = tensors[pos]
                pos += 1
                statics.append(pairs)
                for X, row_index in pairs:
                    # + 0.0 as the reference's zeros.at[rows].add(s).
                    sc = _rowdot(X, coefs) + 0.0
                    total.index_put_((row_index.reshape(-1).long(),),
                                     sc.reshape(-1))
            if self._hot_cache is not None and resident is None:
                self._hot_cache.maybe_admit(("score", gi), statics,
                                            self._hot_bytes[("score", gi)])

        self._run_groups(host_group, consume)
        return self._sum_scores(total)

    def _block_variances(self, block: EntityBlock, coefs, offsets):
        """Budget-bounded variances: the resident version moves the WHOLE
        block to the card, exactly the transfer this coordinate avoids; this
        one moves the plan's slices of the block, one at a time."""
        bi = next(i for i, b in enumerate(self.dataset.blocks)
                  if b is block)
        sub_e = next(s.padded_e for group in self.slice_plan for s in group
                     if s.block_idx == bi)
        sentinel = self.dataset.n_global_rows
        loss = losses_lib.get(self.task)
        _, l2 = self._reg()
        padded = self._padded_offsets(to_numpy(offsets))
        coefs = np.asarray(to_numpy(coefs), np.float32)
        out = np.empty((block.n_entities, block.block_dim), np.float32)
        for lo in range(0, block.n_entities, sub_e):
            hi = min(lo + sub_e, block.n_entities)
            sl = _slice_block(block, lo, hi, sub_e, sentinel)
            X, labels, weights, _, row_index = (
                torch.as_tensor(np.ascontiguousarray(a), device=self._device)
                for a in sl.leaves())
            c = torch.as_tensor(_cut(coefs, lo, hi, sub_e, 0),
                                device=self._device)
            m = _rowdot(X, c) + self._gather(padded, row_index)
            d2w = weights * loss.d2(m, labels)
            diag = _coldot(d2w, X * X) + l2
            out[lo:hi] = to_numpy(
                (1.0 / torch.clamp(diag, min=1e-12))[: hi - lo])
        return out
