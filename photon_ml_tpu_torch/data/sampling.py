"""Down-sampling (port of ``photon_ml_tpu/data/sampling.py``).

``DefaultDownSampler`` (uniform row sampling) and
``BinaryClassificationDownSampler`` (negative down-sampling for imbalanced
binary data, with weight re-scaling so the objective stays unbiased).  The
GAME estimator applies them to the fixed-effect coordinate's training
weights on the host, before the data goes to the device.  Both draw with
``np.random.default_rng(seed)`` exactly as the reference does, so the kept
rows and their weights are identical.
"""

from __future__ import annotations

import numpy as np


class DefaultDownSampler:
    """Keep each row with probability ``rate``, re-weighting survivors by
    ``1/rate`` so weighted sums remain unbiased."""

    def __init__(self, rate: float, seed: int = 0):
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"down-sampling rate must be in (0, 1], got {rate}")
        self.rate = rate
        self.seed = seed

    def downsample(self, labels, weights):
        """Returns (row_indices_kept, new_weights_for_kept)."""
        rng = np.random.default_rng(self.seed)
        n = len(labels)
        keep = rng.uniform(size=n) < self.rate
        idx = np.flatnonzero(keep)
        return idx, np.asarray(weights)[idx] / self.rate


class BinaryClassificationDownSampler:
    """Keep all positives; keep each negative with probability ``rate`` and
    re-weight kept negatives by ``1/rate``."""

    def __init__(self, rate: float, seed: int = 0):
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"down-sampling rate must be in (0, 1], got {rate}")
        self.rate = rate
        self.seed = seed

    def downsample(self, labels, weights):
        rng = np.random.default_rng(self.seed)
        labels = np.asarray(labels)
        weights = np.asarray(weights)
        n = len(labels)
        is_pos = labels > 0
        keep = is_pos | (rng.uniform(size=n) < self.rate)
        idx = np.flatnonzero(keep)
        new_w = weights[idx].copy()
        neg_kept = ~is_pos[idx]
        new_w[neg_kept] = new_w[neg_kept] / self.rate
        return idx, new_w
