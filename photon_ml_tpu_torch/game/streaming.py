"""Out-of-core GAME: a fixed-effect coordinate over a streamed dataset (port
of ``photon_ml_tpu/game/streaming.py``).

When the GAME fixed effect's rows do not fit the card, this coordinate
plugs the host chunk store (``data/streaming.py``) into coordinate
descent: each objective evaluation is one pass of
:class:`~photon_ml_tpu_torch.optim.streaming.StreamingObjective` (on the
card, each chunk's products run the hand-written SpMV kernels), with the
other coordinates' scores entering as per-chunk offset slices, cut once a
solve.  The solve is the registry's resident L-BFGS, OWL-QN (any L1
component, or the OWL-QN optimizer) or TRON (one streamed HVP pass a CG
step) over those passes, with the line searches' batched trials when
``batch_linesearch`` is on, as ``streaming_run_grid`` runs them; the
reference keeps separate streamed solvers only because its resident ones
cannot call host code.  Scores stream back chunk by chunk.

The chunks must carry ZERO offsets: in GAME the base offsets ride the
coordinate-descent total, so chunk offsets would count twice.

Over a process group (``mesh``) the store is this rank's shard of every
chunk (``make_streaming_glm_data(..., mesh=)``): each pass ends in one
all-reduce, every rank runs the same solve, the offsets arrive as the full
n-row vector every rank holds and are cut to the rank's rows, and the
scores come back whole on every rank (an all-gather).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from photon_ml_tpu_torch.data.streaming import StreamingGlmData
from photon_ml_tpu_torch.game.coordinates import Coordinate
from photon_ml_tpu_torch.game.model import FixedEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.optim.problem import GlmOptimizationConfig
from photon_ml_tpu_torch.optim.streaming import (
    StorePasses,
    StreamingObjective,
    ensure_streamable,
)

Tensor = torch.Tensor


class StreamingFixedEffectCoordinate(Coordinate):
    """``FixedEffectCoordinate`` for datasets larger than the card: the
    same ``train(offsets, warm) → w`` / ``score(w)`` / ``finalize`` surface,
    every objective evaluation a streamed pass.

    ``prefetch_depth``, ``chunk_fuse``, ``compress`` and
    ``hot_budget_bytes`` are the :class:`StreamingObjective`'s; lossless
    compression and the hot cache leave every solve bitwise unchanged.
    ``batch_linesearch`` evaluates a bracket of line-search trials a pass
    (the same trials, fewer passes).  ``accumulate``: "f32" or "kahan",
    the cross-chunk sums, as the reference's.  ``last_solve`` holds the
    latest ``train``'s ``SolveResult``."""

    def __init__(
        self,
        name: str,
        stream: StreamingGlmData,
        task: str,
        config: GlmOptimizationConfig,
        reg_weight: float = 0.0,
        feature_shard: str = "global",
        accumulate: str = "f32",
        mesh=None,
        prefetch_depth: int = 2,
        chunk_fuse: int = 1,
        batch_linesearch: bool = True,
        compress: str = "off",
        hot_budget_bytes: int = 0,
    ):
        ensure_streamable(config)
        if stream.has_nonzero_offsets():  # computed once a store
            raise ValueError(
                "streamed GAME chunks must carry zero offsets — base "
                "offsets ride the coordinate-descent total"
            )
        self.name = name
        self.stream = stream
        self.task = losses_lib.get(task).name
        self.config = config
        self.reg_weight = reg_weight
        self.feature_shard = feature_shard
        self.batch_linesearch = bool(batch_linesearch)
        self.last_solve = None
        self.mesh = mesh
        self._sobj = StreamingObjective(
            self.task, stream, mesh=mesh, accumulate=accumulate,
            prefetch_depth=prefetch_depth, chunk_fuse=chunk_fuse,
            compress=compress, hot_budget_bytes=hot_budget_bytes,
        )

    @property
    def device(self) -> torch.device:
        return self._sobj.device

    @property
    def n_features(self) -> int:
        return self.stream.n_features

    @property
    def transfer_stats(self):
        """The stream's per-stage times, bytes and stalls (``TransferStats``
        of ``data/prefetch.py``), across passes."""
        return self._sobj.transfer_stats

    def _reg(self):
        reg = self.config.regularization
        return (reg.l1_weight(1.0) * self.reg_weight,
                reg.l2_weight(1.0) * self.reg_weight)

    def train(self, offsets, warm_state: Optional[Tensor] = None) -> Tensor:
        from photon_ml_tpu_torch.solvers import registry as solver_registry

        sobj = self._sobj
        w0 = (torch.zeros(self.n_features, dtype=torch.float32,
                          device=sobj.device)
              if warm_state is None else warm_state)
        l1, l2 = self._reg()
        # The offsets hold for the whole solve: cut them per chunk once.
        slices = sobj.offset_slices(offsets)
        vgb = ((lambda ws: sobj.value_and_grad_batch(ws, l2, offsets=slices))
               if self.batch_linesearch else None)
        opt = self.config.optimizer
        defn = solver_registry.resolve(
            opt, l1_frac=self.config.regularization.l1_weight(1.0))
        self.last_solve = defn.resident(solver_registry.ResidentSolve(
            objective=StorePasses(sobj, slices), data=None, w0=w0, l1=l1,
            l2=l2, opt=opt, value_and_grad_batch=vgb,
        ))
        return self.last_solve.w

    def score(self, state: Tensor) -> Tensor:
        # Margins WITHOUT offsets (the chunks carry none): coordinate
        # scores are additive pieces.
        return torch.as_tensor(self._sobj.scores(state), device=self.device)

    def finalize(self, state: Tensor, offsets=None) -> FixedEffectModel:
        variances = None
        if self.config.compute_variances and offsets is None:
            # The variance Hessian needs the FULL final margins.
            logging.getLogger(__name__).warning(
                "compute_variances requested but finalize() got no "
                "offsets; variances omitted for coordinate %r", self.name,
            )
        if self.config.compute_variances and offsets is not None:
            _, l2 = self._reg()
            diag = self._sobj.hessian_diagonal(state, offsets=offsets)
            variances = 1.0 / torch.clamp(diag + l2, min=1e-12)
        return FixedEffectModel(
            GeneralizedLinearModel(Coefficients(state, variances), self.task),
            self.feature_shard,
        )

    def make_validation_scorer(self, shards: dict, ids: dict):
        from photon_ml_tpu_torch.game.validation import (
            FixedEffectValidationScorer,
        )

        return FixedEffectValidationScorer(shards[self.feature_shard],
                                           device=self.device)
