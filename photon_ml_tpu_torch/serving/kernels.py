"""The batch part of GAME scoring math (port of
``photon_ml_tpu/serving/kernels.py``, host batch path).

``GameTransformer`` (and through it ``game_scoring_driver``) scores whole
datasets on the host: :func:`fixed_effect_matvec` (a scipy CSR matvec),
:func:`random_effect_block_scores` (pre-grouped block gather + einsum,
``np.add.at`` into the row space, deterministic) and :func:`sum_margins`
(offset + per-coordinate margins).  The reference's online bucket kernels
(``build_bucket_kernel``, ``dense_coefficient_rows``) come with the serving
runtime (ROADMAP.md, PyTorch/CUDA port, Queue 1 item 7).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.device import to_numpy
from photon_ml_tpu_torch.game.model import RandomEffectModel


def fixed_effect_matvec(shard_matrix, means) -> np.ndarray:
    """Fixed-effect margins of a whole scoring shard: one CSR matvec.
    ``means`` may be a tensor on any device."""
    w = to_numpy(means).astype(np.float32, copy=False)
    return np.asarray(shard_matrix @ w, np.float32).ravel()


def random_effect_block_scores(model: RandomEffectModel,
                               dataset) -> np.ndarray:
    """Score a pre-grouped random-effect dataset (its blocks on the host)
    through the block pipeline; entities without trained coefficients (and
    padding lanes) contribute zero."""
    n = dataset.n_global_rows
    out = np.zeros(n + 1, np.float32)
    for block, block_ids in zip(dataset.blocks, dataset.entity_ids):
        coefs = model.coefficient_matrix_for(to_numpy(block.col_map),
                                             block_ids)
        scores = np.einsum("erd,ed->er", to_numpy(block.X), coefs)
        np.add.at(out, to_numpy(block.row_index).ravel(), scores.ravel())
    return out[:n]


def sum_margins(n_rows: int, offset: Optional[np.ndarray],
                parts: Sequence[np.ndarray]) -> np.ndarray:
    """Offset + per-coordinate margin sum (the GAME score definition)."""
    total = (np.zeros(n_rows, np.float32) if offset is None
             else np.asarray(offset, np.float32).copy())
    for p in parts:
        total += p
    return total
