"""GAME data layer (port of ``photon_ml_tpu/game/data.py``).

``FixedEffectDataset`` (all rows, one feature shard) and
``RandomEffectDataset``: the rows of each entity grouped together,
projected onto the feature columns that entity observes, and bucketed by
size into dense padded blocks ``(E, R, D)`` that the batched per-entity
solvers (``game/coordinates.py``) minimize as one tensor program a bucket.

The build is host numpy, written as the reference writes it, so bucket
shapes, lane order, ``col_map`` and ``row_index`` are identical; the
blocks' tensors go to ``device`` (CUDA unless the caller asks for the CPU)
only at the end.  With ``device=False`` the blocks stay host numpy arrays:
the dataset of the out-of-core coordinates (``game/ooc_random.py``), which
slice and stream it to the card pass by pass.

Padding: padding rows carry weight 0; padding columns map to global column
-1 and carry value 0; padding rows point at the sentinel row ``n_rows``.
Every real row appears exactly once across a coordinate's active and
passive blocks, which the builder checks; scoring relies on it to write
each row's score with one non-accumulating index write (no atomics).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.dataset import GlmData
from photon_ml_tpu_torch.device import resolve_device, to_numpy

Tensor = torch.Tensor


@dataclasses.dataclass
class EntityBlock:
    """One size-bucket of entities as a dense padded batch.

    ``X[e, r, k]`` is the value of local feature k in row r of entity e;
    ``col_map[e, k]`` maps local feature k to its global column (or -1).
    ``row_index[e, r]`` is the row's index in the global dataset (or the
    sentinel ``n_global_rows`` for padding).
    """

    X: Tensor  # (E, R, D) float
    labels: Tensor  # (E, R)
    weights: Tensor  # (E, R) — 0 for padding rows / entities
    col_map: Tensor  # (E, D) int32 — global column ids, -1 pad
    row_index: Tensor  # (E, R) int32 — global row ids, sentinel pad
    n_entities: int
    rows_per_entity: int
    block_dim: int

    #: the array fields, in the order the out-of-core coordinates move them.
    LEAVES = ("X", "labels", "weights", "col_map", "row_index")

    def leaves(self) -> tuple:
        return tuple(getattr(self, k) for k in self.LEAVES)


@dataclasses.dataclass
class RandomEffectDataset:
    """All buckets for one random-effect coordinate + host-side id maps.

    ``entity_ids[b][e]`` is the entity key of lane e in bucket b;
    ``entity_to_slot`` maps entity key → (bucket, lane).

    ``passive_blocks[b]`` (None when no entity in bucket b exceeds the
    active-set cap) holds the rows beyond ``max_rows_per_entity``: never
    trained on, but scored, lane-aligned with the active block (same entity
    order, same ``col_map``); passive features outside the entity's active
    subspace drop.
    """

    blocks: list[EntityBlock]
    entity_ids: list[list]
    entity_to_slot: dict
    n_global_rows: int
    n_features: int  # global feature-space width of this coordinate's shard
    passive_blocks: list[Optional[EntityBlock]] = dataclasses.field(
        default_factory=list
    )
    # Padding accounting: padded = Σ_blocks E·R·D over the realized block
    # shapes, exact = Σ_entities r·max(d, 1).
    padded_flops: int = 0
    exact_flops: int = 0

    @property
    def n_entities(self) -> int:
        return len(self.entity_to_slot)

    @property
    def padding_ratio(self) -> float:
        """Padded/exact FLOPs of the realized bucket ladder (>= 1.0)."""
        return (
            self.padded_flops / self.exact_flops if self.exact_flops else 1.0
        )


@dataclasses.dataclass
class FixedEffectDataset:
    """All rows against one feature shard."""

    data: GlmData
    n_global_rows: int


@dataclasses.dataclass
class GameData:
    """Per-coordinate datasets over one global row space; labels/weights are
    global row arrays shared by every coordinate, ``base_offsets`` the
    user-supplied per-row offsets."""

    coordinates: dict  # name -> FixedEffectDataset | RandomEffectDataset
    labels: np.ndarray
    weights: np.ndarray
    base_offsets: np.ndarray

    @property
    def n_rows(self) -> int:
        return len(self.labels)


def _round_up_geometric(n: int, growth: float, floor: int = 1) -> int:
    """Smallest bucket size >= n on the geometric grid floor·growth^k
    (growth=2.0 is the pow2 grid; larger growth consolidates the long tail
    into fewer buckets at the cost of more padding)."""
    if growth <= 1.0:
        raise ValueError(f"bucket growth must be > 1, got {growth}")
    n = max(n, floor)
    v = floor
    while v < n:
        v = max(v + 1, int(math.ceil(v * growth)))
    return v


@dataclasses.dataclass(frozen=True)
class RepackPlan:
    """A cost-model bucket plan: K bucket shapes + the entity→bucket map.

    ``shapes`` is ``(K, 2)`` int64 ``(rows, dims)`` sorted ascending;
    ``assignment[e]`` is entity e's bucket.  ``padded_flops`` is the plan's
    Σ n·R·D cost over PLAN shapes (realized blocks pad tighter)."""

    shapes: np.ndarray  # (K, 2) int64
    assignment: np.ndarray  # (n_entities,) int64
    padded_flops: int
    exact_flops: int


#: Distinct (rows, dims) shapes above which the repacker pre-quantizes on a
#: fine geometric grid before the O(K²)-per-merge greedy runs.
_REPACK_MAX_DISTINCT = 256


def plan_entity_buckets(
    row_counts,
    col_counts,
    program_budget: int = 16,
    seed: int = 0,
) -> RepackPlan:
    """Cost-model entity repacker: pick ≤ ``program_budget`` bucket shapes
    minimizing padded FLOPs for the observed per-entity sizes.

    Greedy agglomeration: start from every distinct shape as its own
    bucket, then repeatedly merge the pair whose merged bucket
    (elementwise-max shape) adds the fewest padded FLOPs, until the budget
    holds; then fold buckets that became identical.  Deterministic: shapes
    are processed in sorted order and ties break on the first pair;
    ``seed`` only feeds ``entity_shape_histogram``'s subsample."""
    from photon_ml_tpu_torch.data.stats import entity_shape_histogram

    if program_budget < 1:
        raise ValueError(
            f"program_budget must be >= 1, got {program_budget}"
        )
    shapes, counts, inverse = entity_shape_histogram(
        row_counts, col_counts, seed=seed
    )
    exact = int(
        np.sum(
            np.asarray(row_counts, np.int64)
            * np.maximum(np.asarray(col_counts, np.int64), 1)
        )
    )
    if len(shapes) == 0:
        return RepackPlan(
            shapes=np.zeros((0, 2), np.int64),
            assignment=np.zeros(0, np.int64),
            padded_flops=0, exact_flops=0,
        )

    # Pre-quantize a pathologically diverse shape population onto a fine
    # geometric grid so each greedy step stays a small dense matrix.
    shape_to_slot = np.arange(len(shapes))
    if len(shapes) > _REPACK_MAX_DISTINCT:
        growth = 1.05
        while True:
            q = np.stack(
                [
                    [_round_up_geometric(int(r), growth) for r in shapes[:, 0]],
                    [_round_up_geometric(int(c), growth) for c in shapes[:, 1]],
                ],
                axis=1,
            )
            qshapes, qinv = np.unique(q, axis=0, return_inverse=True)
            if len(qshapes) <= _REPACK_MAX_DISTINCT:
                break
            growth *= 1.1
        qcounts = np.bincount(
            qinv, weights=counts.astype(np.float64), minlength=len(qshapes)
        ).astype(np.int64)
        shape_to_slot = qinv
        shapes, counts = qshapes.astype(np.int64), qcounts

    R = shapes[:, 0].astype(np.int64)
    D = shapes[:, 1].astype(np.int64)
    N = counts.astype(np.int64)
    C = N * R * D
    members: list[list[int]] = [[i] for i in range(len(shapes))]
    alive = np.ones(len(shapes), bool)

    def _merge_pass(free_only: bool) -> None:
        while True:
            idx = np.flatnonzero(alive)
            if len(idx) <= 1 or (
                not free_only and len(idx) <= program_budget
            ):
                break
            Ra, Da, Na, Ca = R[idx], D[idx], N[idx], C[idx]
            Rm = np.maximum(Ra[:, None], Ra[None, :])
            Dm = np.maximum(Da[:, None], Da[None, :])
            delta = (Na[:, None] + Na[None, :]) * Rm * Dm \
                - Ca[:, None] - Ca[None, :]
            iu = np.triu_indices(len(idx), k=1)
            flat = delta[iu]
            if free_only and flat.min() > 0:
                break
            k = int(np.argmin(flat))
            a, b = idx[iu[0][k]], idx[iu[1][k]]
            R[a] = max(R[a], R[b])
            D[a] = max(D[a], D[b])
            N[a] += N[b]
            C[a] = N[a] * R[a] * D[a]
            members[a].extend(members[b])
            alive[b] = False

    _merge_pass(free_only=False)
    _merge_pass(free_only=True)

    kept = np.flatnonzero(alive)
    order = np.lexsort((D[kept], R[kept]))
    kept = kept[order]
    plan_shapes = np.stack([R[kept], D[kept]], axis=1)
    slot_to_bucket = np.empty(
        int(shape_to_slot.max()) + 1 if len(shape_to_slot) else 0, np.int64
    )
    for bi, ki in enumerate(kept):
        for slot in members[ki]:
            slot_to_bucket[slot] = bi
    assignment = slot_to_bucket[shape_to_slot[inverse]]
    padded = int(np.sum(C[kept]))
    return RepackPlan(
        shapes=plan_shapes,
        assignment=assignment,
        padded_flops=padded,
        exact_flops=exact,
    )


def _empty_dataset(n_rows: int, d: int) -> RandomEffectDataset:
    return RandomEffectDataset(
        blocks=[], entity_ids=[], entity_to_slot={},
        n_global_rows=n_rows, n_features=d, passive_blocks=[],
    )


def check_rows_once(row_indices, n_rows: int) -> None:
    """Every real row may appear at most once across a coordinate's active
    and passive blocks (``row_indices``: their host ``row_index`` arrays;
    padding points at the sentinel ``n_rows``).  Scoring writes each row's
    score with one non-accumulating index write, which is exact only under
    this invariant."""
    counts = np.zeros(n_rows + 1, np.int64)
    for ri in row_indices:
        counts += np.bincount(ri.ravel().astype(np.int64),
                              minlength=n_rows + 1)
    if n_rows and counts[:n_rows].max() > 1:
        raise ValueError(
            f"row {int(np.argmax(counts[:n_rows]))} appears "
            f"{int(counts[:n_rows].max())} times across the random-effect "
            "blocks"
        )


def build_random_effect_dataset(
    entity_keys: Sequence,
    rows_csr,  # scipy CSR (n_rows, d) — this coordinate's feature shard
    labels: np.ndarray,
    weights: np.ndarray,
    max_rows_per_entity: Optional[int] = None,
    dtype=torch.float32,
    device=None,
    bucket_growth: float = 2.0,
    allow_missing: bool = False,
    repack: str = "geometric",
    program_budget: int = 16,
    repack_seed: int = 0,
) -> RandomEffectDataset:
    """Group rows by entity, project to per-entity subspaces, bucket by size.

    ``max_rows_per_entity`` is the active-set cap: entities with more rows
    train on a uniformly-spaced subset; the remaining (passive) rows land
    in score-only ``passive_blocks``.  ``bucket_growth`` sets the geometric
    bucket grid (2.0 = pow2); ``repack="cost_model"`` plans the buckets
    with :func:`plan_entity_buckets` instead.  Entity keys are
    canonicalized to strings (the on-disk model format is string-keyed).
    ``allow_missing`` lets rows without an entity id (``None``) contribute
    nothing instead of raising.  ``device=False`` keeps every block leaf a
    host numpy array (the out-of-core coordinates' dataset).
    """
    import scipy.sparse as sp

    host = device is False
    dev = None if host else resolve_device(device)
    rows_csr = sp.csr_matrix(rows_csr)
    rows_csr.sum_duplicates()
    n_rows, d = rows_csr.shape
    entity_keys = np.asarray(entity_keys)
    assert entity_keys.shape[0] == n_rows
    if entity_keys.dtype == object:
        missing = sum(1 for k in entity_keys if k is None)
        if missing and not allow_missing:
            raise ValueError(
                f"{missing} of {n_rows} rows have no entity id for this "
                "random effect (records missing the id column?)"
            )
        if missing:
            # Id-less rows get no contribution from this coordinate: drop
            # them from the grouping and re-point the blocks' row indices at
            # the original row space afterwards.
            keep = np.array([k is not None for k in entity_keys])
            rows_kept = np.flatnonzero(keep)
            if rows_kept.size == 0:
                return _empty_dataset(n_rows, d)
            ds = build_random_effect_dataset(
                entity_keys[keep], rows_csr[rows_kept], labels[keep],
                weights[keep], max_rows_per_entity=max_rows_per_entity,
                dtype=dtype, device=False if host else dev,
                bucket_growth=bucket_growth,
                repack=repack, program_budget=program_budget,
                repack_seed=repack_seed,
            )
            remap = np.concatenate([rows_kept, [n_rows]]).astype(np.int64)
            kept_n = int(keep.sum())

            def _repoint(block):
                if block is None:
                    return None
                ri = to_numpy(block.row_index)
                ri = np.where(ri >= kept_n, kept_n, ri)  # sentinel slot
                new_ri = remap[ri].astype(np.int32)
                if not host:
                    new_ri = torch.as_tensor(new_ri, device=dev)
                return dataclasses.replace(block, row_index=new_ri)

            return dataclasses.replace(
                ds,
                blocks=[_repoint(b) for b in ds.blocks],
                passive_blocks=[_repoint(b) for b in ds.passive_blocks],
                n_global_rows=n_rows,
            )
    entity_keys = entity_keys.astype(str)

    def _t(x, dt=None):
        if host:
            return x if dt is None else x.astype(
                torch.empty(0, dtype=dt).numpy().dtype, copy=False)
        t = torch.as_tensor(x, device=dev)
        return t if dt is None else t.to(dt)

    # Group rows by entity with flat-array operations on ONE bulk row
    # gather (no per-entity scipy slicing).
    order = np.argsort(entity_keys, kind="stable")
    n_sorted = len(order)
    if n_sorted == 0:
        return _empty_dataset(n_rows, d)
    sorted_keys = entity_keys[order]
    starts = np.flatnonzero(
        np.concatenate([[True], sorted_keys[1:] != sorted_keys[:-1]])
    )
    ends = np.append(starts[1:], n_sorted)
    span_sizes = ends - starts
    n_ent = len(starts)
    ent_keys = sorted_keys[starts]

    # Active-set cap: capped entities keep a uniformly-spaced row subset,
    # the rest become score-only passive rows (keep is over SORTED
    # positions).
    keep = np.ones(n_sorted, bool)
    if max_rows_per_entity is not None:
        for g in np.flatnonzero(span_sizes > max_rows_per_entity):
            m = np.zeros(span_sizes[g], bool)
            m[np.linspace(
                0, span_sizes[g] - 1, max_rows_per_entity
            ).astype(int)] = True
            keep[starts[g]:ends[g]] = m

    ent_of_pos = np.repeat(np.arange(n_ent), span_sizes)
    kept_counts = np.bincount(ent_of_pos, weights=keep, minlength=n_ent
                              ).astype(np.int64)
    kept_before = np.concatenate([[0], np.cumsum(kept_counts)[:-1]])
    local_kept = (np.cumsum(keep) - 1) - kept_before[ent_of_pos]
    psv = ~keep
    psv_counts = np.bincount(ent_of_pos, weights=psv, minlength=n_ent
                             ).astype(np.int64)
    psv_before = np.concatenate([[0], np.cumsum(psv_counts)[:-1]])
    local_psv = (np.cumsum(psv) - 1) - psv_before[ent_of_pos]

    sorted_csr = rows_csr[order]  # one bulk row gather
    nnz_per_row = np.diff(sorted_csr.indptr)
    ent_of_nnz = np.repeat(ent_of_pos, nnz_per_row)
    pos_of_nnz = np.repeat(np.arange(n_sorted), nnz_per_row)
    nnz_keep = keep[pos_of_nnz]

    # Per-entity ACTIVE columns (kept rows only): one global unique over
    # (entity, column) keys, entity-major, columns ascending.
    pair = ent_of_nnz.astype(np.int64) * d + sorted_csr.indices
    upair, inv_kept = np.unique(pair[nnz_keep], return_inverse=True)
    act_ent = (upair // d).astype(np.int64)
    act_col = (upair % d).astype(np.int32)
    act_counts = np.bincount(act_ent, minlength=n_ent).astype(np.int64)
    act_before = np.concatenate([[0], np.cumsum(act_counts)[:-1]])

    # GROUP entities into buckets; each block pads only to its members'
    # actual maxima.
    if repack == "cost_model":
        from photon_ml_tpu_torch.chaos import core as chaos_mod

        chaos_mod.maybe_fail(
            "game.repack", n_entities=n_ent, budget=program_budget
        )
        plan = plan_entity_buckets(
            kept_counts, act_counts, program_budget=program_budget,
            seed=repack_seed,
        )
        buckets: dict[tuple[int, int], list[int]] = {}
        for g in range(n_ent):
            bi = int(plan.assignment[g])
            key = (int(plan.shapes[bi, 0]), int(plan.shapes[bi, 1]))
            buckets.setdefault(key, []).append(g)
    elif repack == "geometric":
        geo = {}

        def _geo(v: int) -> int:
            if v not in geo:
                geo[v] = _round_up_geometric(v, bucket_growth)
            return geo[v]

        buckets = {}
        for g in range(n_ent):
            key = (_geo(int(kept_counts[g])), _geo(int(act_counts[g])))
            buckets.setdefault(key, []).append(g)
    else:
        raise ValueError(
            f"repack must be 'geometric' or 'cost_model', got {repack!r}"
        )

    lane_of_ent = np.empty(n_ent, np.int64)
    ordered_buckets = []
    for _key, members in sorted(buckets.items()):
        m = np.asarray(members, np.int64)
        ordered_buckets.append(m)
        lane_of_ent[m] = np.arange(len(m))

    labels = np.asarray(labels)
    weights = np.asarray(weights)
    row_of_pos = order  # global row id of each sorted position
    blocks: list[EntityBlock] = []
    passive_blocks: list[Optional[EntityBlock]] = []
    ids_per_block: list[list] = []
    entity_to_slot: dict = {}
    host_rows: list[np.ndarray] = []
    for bi, m in enumerate(ordered_buckets):
        E = len(m)
        R = int(kept_counts[m].max())
        D = max(1, int(act_counts[m].max()))
        in_b = np.zeros(n_ent, bool)
        in_b[m] = True

        # Row-level fills: labels/weights/row_index at (lane, local_row).
        sel = in_b[ent_of_pos] & keep
        lane_r = lane_of_ent[ent_of_pos[sel]]
        lrow = local_kept[sel]
        lab = np.zeros((E, R), np.float32)
        wts = np.zeros((E, R), np.float32)
        rindex = np.full((E, R), n_rows, np.int32)  # sentinel
        rows_sel = row_of_pos[sel]
        lab[lane_r, lrow] = labels[rows_sel]
        wts[lane_r, lrow] = weights[rows_sel]
        rindex[lane_r, lrow] = rows_sel
        host_rows.append(rindex)

        # col_map: each unique active (entity, col) at its rank within the
        # entity's active list.
        cmap = np.full((E, D), -1, np.int32)
        a_sel = in_b[act_ent]
        local_c = (np.arange(len(upair)) - act_before[act_ent])[a_sel]
        cmap[lane_of_ent[act_ent[a_sel]], local_c] = act_col[a_sel]

        # X: every kept nnz of the bucket scatters to (lane, local_row,
        # local_col); duplicates were pre-summed.
        n_sel = in_b[ent_of_nnz] & nnz_keep
        n_sel_k = n_sel[nnz_keep]  # same nnz, indexed in kept-nnz space
        e_n = ent_of_nnz[n_sel]
        X = np.zeros((E, R, D), np.float32)
        X[
            lane_of_ent[e_n],
            local_kept[pos_of_nnz[n_sel]],
            inv_kept[n_sel_k] - act_before[e_n],
        ] = sorted_csr.data[n_sel]

        ids = list(ent_keys[m])
        for lane, key in enumerate(ids):
            entity_to_slot[key] = (bi, lane)
        cmap_t = _t(cmap)
        blocks.append(
            EntityBlock(
                X=_t(X, dtype), labels=_t(lab), weights=_t(wts),
                col_map=cmap_t, row_index=_t(rindex),
                n_entities=E, rows_per_entity=R, block_dim=D,
            )
        )
        ids_per_block.append(ids)

        # Score-only passive companion block, lane-aligned with the active
        # block (same entity order and col_map).
        Rp = int(psv_counts[m].max()) if len(m) else 0
        if Rp == 0:
            passive_blocks.append(None)
            continue
        selp = in_b[ent_of_pos] & psv
        lane_p = lane_of_ent[ent_of_pos[selp]]
        lrow_p = local_psv[selp]
        rows_p = row_of_pos[selp]
        labp = np.zeros((E, Rp), np.float32)
        wtsp = np.zeros((E, Rp), np.float32)
        rindexp = np.full((E, Rp), n_rows, np.int32)
        labp[lane_p, lrow_p] = labels[rows_p]
        wtsp[lane_p, lrow_p] = weights[rows_p]
        rindexp[lane_p, lrow_p] = rows_p
        host_rows.append(rindexp)

        # Passive features project onto the ACTIVE subspace: locate each
        # passive nnz's (entity, col) in the sorted unique-pair table;
        # misses drop.
        Xp = np.zeros((E, Rp, D), np.float32)
        np_sel = in_b[ent_of_nnz] & ~nnz_keep
        if len(upair):  # no active pairs at all → every passive nnz drops
            p_pair = pair[np_sel]
            ss = np.searchsorted(upair, p_pair)
            hit = (ss < len(upair)) & (
                upair[np.minimum(ss, len(upair) - 1)] == p_pair
            )
            e_p = ent_of_nnz[np_sel][hit]
            Xp[
                lane_of_ent[e_p],
                local_psv[pos_of_nnz[np_sel][hit]],
                ss[hit] - act_before[e_p],
            ] = sorted_csr.data[np_sel][hit]
        passive_blocks.append(
            EntityBlock(
                X=_t(Xp, dtype), labels=_t(labp), weights=_t(wtsp),
                col_map=cmap_t, row_index=_t(rindexp),
                n_entities=E, rows_per_entity=Rp, block_dim=D,
            )
        )

    check_rows_once(host_rows, n_rows)
    padded_flops = int(
        sum(b.n_entities * b.rows_per_entity * b.block_dim for b in blocks)
    )
    exact_flops = int(np.sum(kept_counts * np.maximum(act_counts, 1)))
    ds = RandomEffectDataset(
        blocks=blocks,
        entity_ids=ids_per_block,
        entity_to_slot=entity_to_slot,
        n_global_rows=n_rows,
        n_features=d,
        passive_blocks=passive_blocks,
        padded_flops=padded_flops,
        exact_flops=exact_flops,
    )
    from photon_ml_tpu_torch import telemetry as telemetry_mod

    telemetry_mod.current().gauge("game_bucket_padding_ratio").set(
        ds.padding_ratio
    )
    return ds
