"""Hand parameters to this package as numpy arrays.

The JAX package and this one share no types; what crosses between them is
numpy (or an Avro model file, which both read and write).  These helpers
build the port's objects from plain arrays, so a caller holding a reference
model, normalization or matrix can give the port exactly the same one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.normalization import NormalizationContext
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_lib


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32).copy(), device=dev)


def glm_from_numpy(means, task: str, variances=None,
                   device=None) -> GeneralizedLinearModel:
    """A ``GeneralizedLinearModel`` from coefficient (and variance)
    arrays; ``task`` may be any loss name or alias."""
    dev = resolve_device(device)
    return GeneralizedLinearModel(
        Coefficients(
            _f32(means, dev),
            None if variances is None else _f32(variances, dev),
        ),
        losses_lib.get(task).name,
    )


def normalization_from_numpy(factors, shifts,
                             intercept_index: Optional[int] = None,
                             device=None) -> NormalizationContext:
    dev = resolve_device(device)
    return NormalizationContext(_f32(factors, dev), _f32(shifts, dev),
                                intercept_index)


def game_states_from_numpy(states: dict, device=None, host=()) -> dict:
    """Coordinate-descent states as the port's tensors: a fixed effect's
    ``w`` array becomes one float32 tensor, a random effect's list of
    per-bucket ``(E, D)`` arrays a list of them, and a factored random
    effect's ``(list of (E, rank), (n_features, rank))`` a tuple of such a
    list and one tensor; ``None`` stays ``None``.  Both packages can then
    warm-start from the same point.

    The coordinates named in ``host`` are out of core and keep their
    per-bucket arrays on the host (float32 numpy copies); a factored one's
    projection V still becomes a tensor on ``device``."""
    dev = resolve_device(device)

    def one(st):
        if st is None:
            return None
        if isinstance(st, tuple):
            return tuple(one(a) for a in st)
        if isinstance(st, list):
            return [one(a) for a in st]
        return _f32(st, dev)

    def host_form(st):
        if st is None:
            return None
        if isinstance(st, tuple):
            u_list, V = st
            return ([np.array(u, np.float32) for u in u_list], _f32(V, dev))
        return [np.array(a, np.float32) for a in st]

    return {name: host_form(st) if name in host else one(st)
            for name, st in states.items()}


def matrix_from_coo(rows, cols, vals, n_rows: int, n_cols: int,
                    use_kernel: bool = True, device=None, **kwargs):
    """A feature matrix from COO triples: the kernel-backed CSR/CSC matrix
    (default) or, with ``use_kernel=False``, the COO matrix.  Extra keyword
    arguments go to ``build_cuda_matrix`` / ``from_coo`` (``pad_nnz``,
    ``unit_values``, ...)."""
    if use_kernel:
        from photon_ml_tpu_torch.ops.sparse_cuda import build_cuda_matrix

        return build_cuda_matrix(rows, cols, vals, n_rows, n_cols,
                                 device=device, **kwargs)
    from photon_ml_tpu_torch.ops.sparse import from_coo

    return from_coo(rows, cols, vals, n_rows, n_cols, device=device, **kwargs)


def game_model_from_numpy(coordinates: dict, task: str, device=None):
    """A ``GameModel`` from numpy arrays.  ``coordinates`` maps each
    coordinate name, in coordinate order, to its spec: a fixed effect is
    ``{"feature_shard": s, "means": array}`` (the means become a float32
    tensor on ``device``); a random effect is ``{"feature_shard": s,
    "entity_key": k, "n_features": d, "coefficients": {entity: (cols,
    vals)}}`` (the per-entity table stays host numpy, int32 columns and
    float32 values, as the port's model holds it)."""
    from photon_ml_tpu_torch.game.model import (
        FixedEffectModel,
        GameModel,
        RandomEffectModel,
    )

    name = losses_lib.get(task).name
    models = {}
    for coord, spec in coordinates.items():
        if "means" in spec:
            models[coord] = FixedEffectModel(
                glm_from_numpy(spec["means"], name, device=device),
                spec["feature_shard"])
        else:
            table = {
                key: (np.asarray(cols, np.int32).copy(),
                      np.asarray(vals, np.float32).copy())
                for key, (cols, vals) in spec["coefficients"].items()
            }
            models[coord] = RandomEffectModel(
                coefficients=table, feature_shard=spec["feature_shard"],
                entity_key=spec["entity_key"], task=name,
                n_features=int(spec["n_features"]))
    return GameModel(models=models, task=name)
