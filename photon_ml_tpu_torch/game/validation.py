"""Per-coordinate validation scoring for coordinate descent (port of
``photon_ml_tpu/game/validation.py``).

The estimator evaluates its validation ``EvaluationSuite`` after every
coordinate update.  Doing that cheaply means scoring the validation set
against a coordinate's CURRENT device state without finalizing a host model
each step.  These scorers are built ONCE per (training dataset, validation
data) pair and reused across a config grid whose points share the dataset:

- ``FixedEffectValidationScorer``: the validation shard as the
  kernel-backed CSR/CSC matrix (``ops/sparse_cuda.py``); one matvec per
  evaluation, which on CUDA is the hand-written row kernel
  (``csrc/spmv.cu``) and on the CPU its plain version.
- ``RandomEffectValidationScorer``: the validation rows grouped into entity
  blocks once, plus a host-built STATIC gather map from every (validation
  lane, local column) into the flattened training state (the per-bucket
  ``(E, D)`` coefficient tensors).  Each evaluation is then device work:
  flatten the state, one gather per validation block, a multiply-plus-sum
  over D, and one non-accumulating index write of each row's score into a
  zeroed ``(n_val + 1,)`` buffer (padding rows write the sentinel slot).
  Each validation row lies in exactly one block (the grouping has no
  active-set cap), so no atomic scatter is needed and the scores repeat
  bitwise.  Entities unseen in training (and columns outside a training
  entity's active subspace) gather from a zero slot, so they score 0, as
  the reference scores unseen entities and features.
- ``FactoredValidationScorer``: a factored coordinate's state materialized
  into per-bucket coefficients, then scored as a plain random effect.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device, to_numpy
from photon_ml_tpu_torch.game.coordinates import _rowdot
from photon_ml_tpu_torch.game.data import (
    RandomEffectDataset,
    build_random_effect_dataset,
)

Tensor = torch.Tensor


class FixedEffectValidationScorer:
    """``score(w) = X_val @ w`` on ``device``; built once per validation
    shard.  Holds ONLY the feature matrix (scoring reads no labels)."""

    def __init__(self, val_shard, device=None):
        import scipy.sparse as sp

        from photon_ml_tpu_torch.ops.sparse import DenseMatrix
        from photon_ml_tpu_torch.ops.sparse_cuda import from_scipy_csr_cuda

        dev = resolve_device(device)
        self.n_rows = val_shard.shape[0]
        if sp.issparse(val_shard):
            self._features = from_scipy_csr_cuda(sp.csr_matrix(val_shard),
                                                 device=dev)
        else:
            self._features = DenseMatrix(torch.as_tensor(
                np.asarray(val_shard, np.float32), device=dev))

    def score(self, state: Tensor) -> Tensor:
        return self._features.matvec(state)


def _flat_layout(state_shapes: Sequence[tuple[int, int]]):
    """Bucket (E, D) shapes → per-bucket offsets into the flattened state."""
    sizes = [e * d for e, d in state_shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return offsets, int(offsets[-1])


class RandomEffectValidationScorer:
    """Static-gather scoring of validation rows against training RE state.

    ``train_dataset`` fixes the entity→(bucket, lane) layout and per-lane
    column maps; ``entity_col``/``val_shard`` are the validation rows.  The
    grouping and the gather map are built here, once, in host numpy as the
    reference builds them.  Rows without an entity id (``None``) score 0, as
    ``GameTransformer`` scores them.
    """

    def __init__(self, train_dataset: RandomEffectDataset, entity_col,
                 val_shard, device=None):
        dev = resolve_device(device)
        n_val = val_shard.shape[0]
        self.n_rows = n_val
        # Group validation rows by entity (no active-set cap: scoring covers
        # every row).  Labels and weights are irrelevant for scoring.
        val_ds = build_random_effect_dataset(
            entity_col, val_shard, np.zeros(n_val, np.float32),
            np.ones(n_val, np.float32), device=dev, allow_missing=True,
        )
        state_shapes = [(b.n_entities, b.block_dim)
                        for b in train_dataset.blocks]
        offsets, total = _flat_layout(state_shapes)
        self._miss = total  # index of the appended zero slot
        d = train_dataset.n_features

        # Every training lane's active columns as ONE globally sorted key
        # table (global_lane_id * d + col: ascending because lanes flatten
        # in order and each lane's col_map holds its sorted active columns
        # first), so each validation block resolves with one searchsorted.
        lane_gid0 = np.concatenate(
            [[0], np.cumsum([e for e, _d in state_shapes])]).astype(np.int64)
        key_parts, pos_parts = [], []
        for tb, b in enumerate(train_dataset.blocks):
            tcmap = to_numpy(b.col_map)  # (E, D) active cols, -1 pad
            lanes, cols = np.nonzero(tcmap >= 0)
            key_parts.append((lane_gid0[tb] + lanes).astype(np.int64) * d
                             + tcmap[lanes, cols])
            # col_map packs actives first, so the column position IS the
            # coefficient's place in the lane's local space.
            pos_parts.append(offsets[tb] + lanes.astype(np.int64)
                             * state_shapes[tb][1] + cols)
        train_keys = (np.concatenate(key_parts) if key_parts
                      else np.empty(0, np.int64))
        train_pos = (np.concatenate(pos_parts) if pos_parts
                     else np.empty(0, np.int64))

        gather_idxs = []
        for vb, vids in zip(val_ds.blocks, val_ds.entity_ids):
            vcmap = vb.col_map.cpu().numpy()  # (E_v, D_v) global cols
            gid = np.fromiter(
                (-1 if (s := train_dataset.entity_to_slot.get(k)) is None
                 else lane_gid0[s[0]] + s[1] for k in vids),
                np.int64, count=len(vids),
            )
            gidx = np.full(vcmap.shape, self._miss, np.int64)
            valid = (vcmap >= 0) & (gid[:, None] >= 0)
            keys = gid[:, None] * d + vcmap
            if len(train_keys) and valid.any():
                kv = keys[valid]
                ss = np.searchsorted(train_keys, kv)
                hit = (ss < len(train_keys)) & (
                    train_keys[np.minimum(ss, len(train_keys) - 1)] == kv)
                flat = gidx[valid]
                flat[hit] = train_pos[ss[hit]]
                gidx[valid] = flat
            gather_idxs.append(torch.as_tensor(gidx, device=dev))
        self._val_blocks = val_ds.blocks
        self._gather_idxs = gather_idxs
        self._device = dev

    def score(self, state: list[Tensor]) -> Tensor:
        """``state``: per-bucket ``(E, D)`` tensors, or the host arrays of
        an out-of-core coordinate (moved to the card here, as one copy)."""
        flat = torch.cat([torch.as_tensor(s, dtype=torch.float32,
                                          device=self._device).reshape(-1)
                          for s in state]
                         + [torch.zeros(1, dtype=torch.float32,
                                        device=self._device)])
        out = torch.zeros(self.n_rows + 1, dtype=torch.float32,
                          device=self._device)
        for vb, gidx in zip(self._val_blocks, self._gather_idxs):
            coefs = flat.index_select(0, gidx.reshape(-1)).view(gidx.shape)
            # + 0.0 as the reference's zeros.at[rows].add(s).
            s = _rowdot(vb.X, coefs) + 0.0
            out.index_put_((vb.row_index.reshape(-1).long(),), s.reshape(-1))
        return out[:self.n_rows]


class FactoredValidationScorer:
    """A factored coordinate's ``(u_list, V)`` state scored by the plain
    random-effect scorer: the state is materialized into per-bucket
    ``w_e = V u_e`` first, so both kinds score validation rows alike."""

    def __init__(self, coord, inner: RandomEffectValidationScorer):
        self._coord = coord
        self._inner = inner

    @property
    def n_rows(self) -> int:
        return self._inner.n_rows

    def score(self, state) -> Tensor:
        return self._inner.score(self._coord.materialize(state))
