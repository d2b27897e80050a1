"""GAME coordinates (port of ``photon_ml_tpu/game/coordinates.py``).

- ``FixedEffectCoordinate``: one GLM fit over all rows through
  ``GlmOptimizationProblem.solve`` with per-row offsets from the other
  coordinates; on CUDA its products run the hand-written SpMV kernels
  (``csrc/spmv.cu``) of the kernel-backed matrix.
- ``RandomEffectCoordinate``: one GLM fit per entity.  Each size bucket
  ``(E, R, D)`` solves as one batched tensor program over its entity lanes.
  Smooth objectives take a Newton fast path where the bucket has one:
  rank-1 Newton (R == 1), scalar Newton (D == 1) or damped Newton with an
  unrolled-CG Hessian solve (D ≤ 32).  Every other bucket (any L1
  component, the OWL-QN optimizer, or D > 32 with R > 1) runs the batched
  L-BFGS, OWL-QN or TRON of ``optim/batched.py``, the counterpart of the
  reference's ``vmap`` of its solvers.  Each program keeps per-lane
  ``done`` masks in place of the reference's ``while_loop`` over a
  ``vmap``.  The buckets advance in lockstep, one body each (a Newton step,
  a line-search trial, a CG step), with ONE host read a body for the whole
  coordinate update (which buckets still have live lanes); a body whose
  lanes are all done is never run.

The per-entity products are written as multiply-plus-sum over the R or D
axis, never as a matmul, so they cannot run in TF32 whatever the caller's
``torch.backends`` settings: a lower-precision product would put a noise
floor above the 1e-6 gradient tolerance and silently disable the early
exit (the reason the reference runs these einsums at HIGHEST precision).

Scoring writes each row's score with one non-accumulating index write into
a zeroed ``(n_rows + 1,)`` buffer (padding rows go to the sentinel slot):
every real row appears once across a coordinate's active and passive blocks
(checked when the dataset is built), so no atomic scatter is needed and
the result is bitwise repeatable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import to_numpy
from photon_ml_tpu_torch.game.data import (
    EntityBlock,
    FixedEffectDataset,
    RandomEffectDataset,
)
from photon_ml_tpu_torch.game.model import FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.optim.batched import (
    BatchedLBFGS,
    BatchedOWLQN,
    BatchedTRON,
    LaneGlm,
)
from photon_ml_tpu_torch.optim.batched import coldot as _coldot
from photon_ml_tpu_torch.optim.batched import rowdot as _rowdot
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    GlmOptimizationProblem,
    OptimizerType,
)

Tensor = torch.Tensor

def _state_to_device(st, device):
    """Recursively move a coordinate state (tensor, array, or list of them)
    onto ``device``."""
    if st is None:
        return None
    if isinstance(st, (list, tuple)):
        return [_state_to_device(s, device) for s in st]
    if isinstance(st, Tensor):
        return st.to(device)
    return torch.as_tensor(np.asarray(st), device=device)


class Coordinate:
    """Protocol: train against offsets, score into the global row space."""

    name: str

    def train(self, offsets: Tensor, warm_state=None):
        raise NotImplementedError

    def prestage(self, warm_state=None) -> None:
        """Hint that ``train(..., warm_state)`` is about to be called (the
        pipelined descent schedule issues it for the NEXT coordinate).  A
        resident coordinate has nothing to stage, so this is a no-op; results
        never depend on it."""
        return None

    def score(self, state) -> Tensor:
        raise NotImplementedError

    def place_state(self, state, device):
        """A state restored from numpy (a checkpoint, an initial model) in
        the form ``train`` keeps it: tensors on ``device`` here; the
        out-of-core coordinates keep theirs on the host."""
        return _state_to_device(state, device)

    def finalize(self, state, offsets=None):
        """Turn device state into the host-side model object.  ``offsets``
        are this coordinate's final residual offsets, needed for variances
        (their Hessian is evaluated at the full final margins)."""
        raise NotImplementedError

    def make_validation_scorer(self, shards: dict, ids: dict):
        """A reusable validation scorer for this coordinate, built from raw
        validation columns (see ``game/validation.py``)."""
        raise NotImplementedError


class FixedEffectCoordinate(Coordinate):
    """Reference: ``FixedEffectCoordinate`` — one GLM over the full dataset."""

    def __init__(
        self,
        name: str,
        dataset: FixedEffectDataset,
        task: str,
        config: GlmOptimizationConfig,
        reg_weight: float = 0.0,
        feature_shard: str = "global",
    ):
        self.name = name
        self.dataset = dataset
        self.task = losses_lib.get(task).name
        self.problem = GlmOptimizationProblem(task, config)
        self.reg_weight = reg_weight
        self.feature_shard = feature_shard
        self._sharded_trainer = None
        solver_name = getattr(config.optimizer, "solver", None)
        if solver_name is not None:
            from photon_ml_tpu_torch.solvers import registry as solver_registry

            if solver_registry.get(solver_name).kind == "host":
                # Host-kind solvers (ADMM, block CD) distribute this
                # coordinate's solve over logical row shards; each GAME
                # iteration's offsets re-slot into one shard template.
                from photon_ml_tpu_torch.solvers import sharded

                self._sharded_trainer = sharded.make_fixed_effect_trainer(
                    self.problem, dataset.data,
                    sharded.resolve_shard_count(config.optimizer),
                )

    @property
    def device(self) -> torch.device:
        return self.dataset.data.device

    def train(self, offsets: Tensor, warm_state: Optional[Tensor] = None
              ) -> Tensor:
        data = dataclasses.replace(self.dataset.data, offsets=offsets)
        w0 = (
            torch.zeros(data.n_features, dtype=torch.float32,
                        device=data.device)
            if warm_state is None else warm_state
        )
        if self._sharded_trainer is not None:
            return self._sharded_trainer(offsets, w0, self.reg_weight)
        return self.problem.solve_single_device(data, self.reg_weight, w0).w

    def score(self, state: Tensor) -> Tensor:
        # Margin WITHOUT offsets: coordinate scores are additive pieces.
        return self.dataset.data.features.matvec(state)

    def make_validation_scorer(self, shards: dict, ids: dict):
        from photon_ml_tpu_torch.game.validation import (
            FixedEffectValidationScorer,
        )

        return FixedEffectValidationScorer(shards[self.feature_shard],
                                           device=self.device)

    def finalize(self, state: Tensor, offsets=None) -> FixedEffectModel:
        variances = None
        if self.problem.config.compute_variances and offsets is not None:
            data = dataclasses.replace(
                self.dataset.data,
                offsets=torch.as_tensor(np.asarray(offsets, np.float32),
                                        device=self.device),
            )
            variances = self.problem.coefficient_variances(
                state, data, self.reg_weight
            )
        return FixedEffectModel(
            GeneralizedLinearModel(Coefficients(state, variances), self.task),
            self.feature_shard,
        )


# -- batched per-entity solvers ----------------------------------------------


class _NewtonProgram:
    """A Newton bucket program: ``done`` marks the lanes that passed the
    relative gradient test (its ``converged``); the outer-iteration and
    inner counters of the fallback programs do not apply."""

    iterations = inner = None

    def pending(self) -> Tensor:
        return ~self.done.all()

    @property
    def converged(self) -> Tensor:
        return self.done


class _Rank1Newton(_NewtonProgram):
    """Single-row entities (R == 1): stationarity ℓ'(m)·x + λw = 0 forces
    w ∝ x, so the per-entity GLM collapses to a 1-D problem in α (w = α·x):
    up to 30 damped Newton steps with a per-lane relative-gradient exit."""

    cap = 30

    def __init__(self, loss, tol, block, offsets_block, w0, l2):
        X = block.X[:, 0, :]                       # (E, D)
        self.loss, self.X, self.l2 = loss, X, l2
        self.y = block.labels[:, 0]
        self.wt = block.weights[:, 0]
        self.off = offsets_block[:, 0].to(X.dtype)
        self.s = (X * X).sum(1)                    # (E,) = ‖x‖²
        safe_s = torch.clamp(self.s, min=1e-12)
        self.alpha = (w0 * X).sum(1) / safe_s      # warm start projection
        # Margin-change clamp: Δmargin = Δα·s, so |Δα| ≤ 20/s bounds each
        # step's margin movement at 20.
        self.clip = 20.0 / safe_s
        _, g0 = self._grad(self.alpha)
        self.gtol = tol * torch.clamp(g0.abs(), min=1.0)
        self.done = (g0.abs() <= self.gtol) | (self.s <= 0)

    def _grad(self, alpha):
        m = alpha * self.s + self.off
        return m, self.s * (self.wt * self.loss.d1(m, self.y)
                            + self.l2 * alpha)

    def body(self) -> None:
        m, g1 = self._grad(self.alpha)
        self.done = self.done | (g1.abs() <= self.gtol)
        g2 = self.wt * self.loss.d2(m, self.y) * self.s * self.s \
            + self.l2 * self.s
        step = g1 / torch.clamp(g2, min=1e-12)
        step = torch.clamp(step, -self.clip, self.clip)
        self.alpha = self.alpha - torch.where(self.done, 0.0, step)

    def result(self) -> Tensor:
        return self.alpha[:, None] * self.X


class _Dim1Newton(_NewtonProgram):
    """Single-feature entities (D == 1, a per-entity bias): a 1-D problem
    in w whatever the row count, solved by damped scalar Newton with the
    rank-1 path's exit and cap."""

    cap = 30

    def __init__(self, loss, tol, block, offsets_block, w0, l2):
        X = block.X[:, :, 0]                       # (E, R)
        self.loss, self.X, self.l2 = loss, X, l2
        self.y, self.wt = block.labels, block.weights
        self.off = offsets_block.to(X.dtype)
        self.w = w0[:, 0]                          # (E,)
        # Margin-change clamp: |Δw|·max|x| ≤ 20 a step.
        xmax = X.abs().amax(1)
        self.clip = 20.0 / torch.clamp(xmax, min=1e-12)
        _, g0 = self._grad(self.w)
        self.gtol = tol * torch.clamp(g0.abs(), min=1.0)
        self.done = g0.abs() <= self.gtol

    def _grad(self, w):
        m = w[:, None] * self.X + self.off
        return m, (self.wt * self.loss.d1(m, self.y) * self.X).sum(1) \
            + self.l2 * w

    def body(self) -> None:
        m, g = self._grad(self.w)
        self.done = self.done | (g.abs() <= self.gtol)
        h = (self.wt * self.loss.d2(m, self.y) * self.X * self.X).sum(1) \
            + self.l2
        # All-zero-feature lanes need no special case: g = l2·w, h = l2 →
        # one exact step to w = 0 (and with l2 = 0 the step is 0).
        step = torch.clamp(g / torch.clamp(h, min=1e-12), -self.clip,
                           self.clip)
        self.w = self.w - torch.where(self.done, 0.0, step)

    def result(self) -> Tensor:
        return self.w[:, None]


def spd_solve_cg(H: Tensor, g: Tensor, n_steps: int) -> Tensor:
    """Batched (E, D, D) SPD solve by ``n_steps`` unrolled CG iterations
    (exact at n_steps = D in exact arithmetic).  Zero lanes (H = 0, g = 0,
    bucket padding) stay exactly zero."""
    x = torch.zeros_like(g)
    r = g
    p = r
    rs = (r * r).sum(1)
    for _ in range(n_steps):
        Hp = (H * p[:, None, :]).sum(-1)
        alpha = rs / torch.clamp((p * Hp).sum(1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Hp
        rs_new = (r * r).sum(1)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        rs = rs_new
        p = r + beta[:, None] * p
    return x


class _NewtonBlock(_NewtonProgram):
    """Batched damped Newton for smooth objectives on small-D blocks: an
    exact (E, D, D) Hessian solved by D unrolled CG steps, each step's
    margin change damped to 20, lanes frozen once their gradient passes the
    Breeze-style relative test ‖g‖ ≤ tol·max(1, ‖g₀‖)."""

    def __init__(self, loss, tol, block, offsets_block, w0, l2, max_iters):
        self.loss, self.l2, self.cap = loss, l2, max_iters
        self.X, self.y, self.wt = block.X, block.labels, block.weights
        self.off = offsets_block.to(block.X.dtype)
        self.d = block.block_dim
        self.eye = torch.eye(self.d, dtype=block.X.dtype,
                             device=block.X.device)
        self.w = w0
        _, g0 = self._grad(w0)
        self.gtol = tol * torch.clamp(torch.linalg.vector_norm(g0, dim=1),
                                      min=1.0)
        self.done = torch.zeros(block.X.shape[0], dtype=torch.bool,
                                device=block.X.device)

    def _grad(self, w):
        m = _rowdot(self.X, w) + self.off
        g = _coldot(self.wt * self.loss.d1(m, self.y), self.X) + self.l2 * w
        return m, g

    def body(self) -> None:
        X = self.X
        m, g = self._grad(self.w)
        newly = torch.linalg.vector_norm(g, dim=1) <= self.gtol
        d2 = self.wt * self.loss.d2(m, self.y)
        H = ((X * d2[:, :, None])[:, :, :, None] * X[:, :, None, :]).sum(1) \
            + self.l2 * self.eye
        step = spd_solve_cg(H, g, self.d)
        dm = _rowdot(X, step)
        scale = torch.clamp(
            20.0 / torch.clamp(dm.abs().amax(1), min=1e-12), max=1.0
        )
        keep = self.done | newly
        self.w = torch.where(keep[:, None], self.w,
                             self.w - scale[:, None] * step)
        self.done = keep

    def result(self) -> Tensor:
        return self.w


@dataclasses.dataclass
class SolveStats:
    """What one lockstep solve did: bodies a bucket, host reads in all (one
    a lockstep body, plus the last test), and each bucket's per-lane
    ``converged`` flags.  For the fallback buckets also each lane's outer
    ``iterations`` and its ``inner`` line-search trials (L-BFGS, OWL-QN) or
    CG steps (TRON); None for the Newton buckets."""

    bodies: list
    host_reads: int
    converged: list
    iterations: list
    inner: list


class BlockSolver:
    """The batched per-entity solver for one (task, config): the port of
    the reference's ``_make_block_solver`` (without its program cache: the
    port compiles nothing).

    Dispatch per bucket, as the reference's: for smooth objectives R == 1 →
    rank-1 Newton, D == 1 → scalar Newton, D ≤ 32 → batched Newton.  Every
    other bucket runs the configured solver batched over its lanes
    (``optim/batched.py``) with history ``min(history, D)``: OWL-QN for any
    L1 component or the OWL-QN optimizer (every bucket, R == 1 included),
    TRON when the optimizer or the registry solver is TRON, else L-BFGS."""

    def __init__(self, task: str, config: GlmOptimizationConfig):
        self.loss = losses_lib.get(task)
        self.config = config
        opt = config.optimizer
        has_l1 = config.regularization.l1_weight(1.0) > 0.0
        if getattr(opt, "solver", None) is not None:
            from photon_ml_tpu_torch.solvers import registry as solver_registry

            defn = solver_registry.resolve(
                opt, l1_frac=config.regularization.l1_weight(1.0)
            )
            if defn.kind != "jit":
                # Random-effect blocks are batched per-entity solves; the
                # host-kind solvers distribute the FIXED-effect coordinate.
                raise ValueError(
                    f"solver {defn.name!r} is host-kind and cannot run the "
                    "per-entity random-effect blocks; set it on the "
                    "fixed-effect coordinate's spec instead"
                )
            self.use_owlqn = defn.name == "owlqn" or has_l1
            self.use_tron = defn.name == "tron"
        else:
            self.use_owlqn = opt.optimizer is OptimizerType.OWLQN or has_l1
            self.use_tron = opt.optimizer is OptimizerType.TRON

    def program(self, block: EntityBlock, offsets_block: Tensor, w0: Tensor,
                l1: float, l2: float):
        """One bucket's solve as a program: ``pending()`` (a device bool),
        ``body()`` (one step on every live lane), ``result()`` and per-lane
        ``converged``; ``cap`` bounds its bodies."""
        opt = self.config.optimizer
        if not self.use_owlqn:
            args = (self.loss, opt.tolerance, block, offsets_block, w0, l2)
            if block.rows_per_entity == 1:
                return _Rank1Newton(*args)
            if block.block_dim == 1:
                return _Dim1Newton(*args)
            if block.block_dim <= 32:
                return _NewtonBlock(*args, opt.max_iters)
        obj = LaneGlm(self.loss, block.X, block.labels, block.weights,
                      offsets_block, l2)
        # History beyond the local problem dimension buys nothing.
        history = min(opt.history, block.block_dim)
        if self.use_owlqn:
            return BatchedOWLQN(obj, w0, l1, opt.max_iters, opt.tolerance,
                                history)
        if self.use_tron:
            return BatchedTRON(obj, w0, opt.max_iters, opt.tolerance)
        return BatchedLBFGS(obj, w0, opt.max_iters, opt.tolerance, history)

    def solve(self, block: EntityBlock, offsets_block: Tensor, w0: Tensor,
              l1: float, l2: float) -> Tensor:
        """One bucket → its (E, D) coefficients."""
        ws, _ = self.solve_all([(block, offsets_block, w0)], l1, l2)
        return ws[0]

    @staticmethod
    def lockstep(progs) -> tuple[list, int]:
        """Run ``progs`` to their ends, one body each a round, with ONE host
        read a round of which still have live lanes.  Returns (bodies a
        program, host reads)."""
        bodies = [0] * len(progs)
        live = [k for k, p in enumerate(progs) if p.cap > 0]
        reads = 0
        while live:
            flags = torch.stack([progs[k].pending() for k in live]).tolist()
            reads += 1
            live = [k for k, f in zip(live, flags) if f]
            for k in live:
                progs[k].body()
                bodies[k] += 1
            live = [k for k in live if bodies[k] < progs[k].cap]
        return bodies, reads

    def solve_all(self, items, l1: float, l2: float):
        """Every bucket of ``items`` = [(block, offsets_block, w0)] in
        lockstep: before each body, ONE host read of which buckets still
        have live lanes (``i < cap`` and some lane not done), so a bucket
        runs exactly the bodies the reference's ``while_loop`` would.
        Returns (coefficients a bucket, :class:`SolveStats`)."""
        progs = [self.program(b, off, w0, l1, l2) for b, off, w0 in items]
        bodies, reads = self.lockstep(progs)
        return ([p.result() for p in progs],
                SolveStats(bodies=bodies, host_reads=reads,
                           converged=[p.converged for p in progs],
                           iterations=[p.iterations for p in progs],
                           inner=[p.inner for p in progs]))


def pack_entity_tables(cmap: np.ndarray, w: np.ndarray, var=None):
    """Per-lane (cols, vals[, variances]) lists for the host model table:
    one bulk mask + ``np.split``.  Keeps real columns whose coefficient is
    nonzero."""
    valid = (cmap >= 0) & (w != 0)
    bounds = np.cumsum(valid.sum(axis=1))[:-1]
    col_parts = np.split(cmap[valid].astype(np.int32), bounds)
    val_parts = np.split(w[valid].astype(np.float32), bounds)
    var_parts = (
        np.split(np.asarray(var)[valid].astype(np.float32), bounds)
        if var is not None else None
    )
    return col_parts, val_parts, var_parts


def _gather_block_offsets(offsets: Tensor, block: EntityBlock) -> Tensor:
    """Per-row offsets for one entity block; padding rows (sentinel index)
    read the appended zero slot."""
    padded = torch.cat([offsets, offsets.new_zeros(1)])
    return padded.index_select(0, block.row_index.reshape(-1)).view(
        block.row_index.shape)


def score_blocks(n_rows: int, blocks, passive_blocks, coefs_list,
                 device=None) -> Tensor:
    """Per-row scores of one random-effect coordinate: each block's
    margins written at their rows (active and passive), padding into the
    sentinel slot ``n_rows``.  ``s + 0.0`` as in the reference's
    ``zeros.at[rows].add(s)``, without atomics."""
    total = torch.zeros(n_rows + 1, dtype=torch.float32, device=device)
    passive = passive_blocks or [None] * len(blocks)
    for block, passive_block, coefs in zip(blocks, passive, coefs_list):
        for b in (block, passive_block):
            if b is None:
                continue
            s = _rowdot(b.X, coefs) + 0.0
            total.index_put_((b.row_index.reshape(-1).long(),), s.reshape(-1))
    return total[:n_rows]


class RandomEffectCoordinate(Coordinate):
    """Reference: ``RandomEffectCoordinate`` — per-entity solves, batched.

    State is a list of per-bucket coefficient tensors ``(E, D)`` in each
    block's LOCAL (projected) column space.  ``last_solve`` holds the
    :class:`SolveStats` of the latest ``train``.
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
    ):
        self.name = name
        self.dataset = dataset
        self.task = losses_lib.get(task).name
        self.config = config
        self.reg_weight = reg_weight
        self.feature_shard = feature_shard
        self.entity_key = entity_key or name
        self._solver = BlockSolver(task, config)
        self.last_solve: Optional[SolveStats] = None

    @property
    def device(self) -> Optional[torch.device]:
        blocks = self.dataset.blocks
        return blocks[0].X.device if blocks else None

    def _reg(self):
        """(l1, l2) as the float32 values the reference's traced scalars
        hold."""
        reg = self.config.regularization
        return (float(np.float32(reg.l1_weight(1.0) * self.reg_weight)),
                float(np.float32(reg.l2_weight(1.0) * self.reg_weight)))

    def train(self, offsets: Tensor, warm_state=None) -> list[Tensor]:
        l1, l2 = self._reg()
        offsets = offsets.to(torch.float32)
        items = []
        for bi, block in enumerate(self.dataset.blocks):
            w0 = (
                warm_state[bi] if warm_state is not None
                else torch.zeros((block.n_entities, block.block_dim),
                                 dtype=torch.float32, device=block.X.device)
            )
            items.append((block, _gather_block_offsets(offsets, block), w0))
        state, self.last_solve = self._solver.solve_all(items, l1, l2)
        return state

    def score(self, state: list[Tensor]) -> Tensor:
        return score_blocks(self.dataset.n_global_rows, self.dataset.blocks,
                            self.dataset.passive_blocks, state, self.device)

    def make_validation_scorer(self, shards: dict, ids: dict):
        """A validation file with no rows for this entity column gives an
        all-``None`` column: every row scores 0 (the reference raises a
        KeyError there; the port scores such rows as ``GameTransformer``
        does, so the per-update metric and the final transform agree)."""
        from photon_ml_tpu_torch.game.validation import (
            RandomEffectValidationScorer,
        )

        shard = shards[self.feature_shard]
        entity_col = ids.get(self.entity_key)
        if entity_col is None:
            entity_col = np.full(shard.shape[0], None, object)
        return RandomEffectValidationScorer(self.dataset, entity_col, shard,
                                            device=self.device)

    def _block_variances(self, block: EntityBlock, coefs: Tensor,
                         offsets: Tensor) -> np.ndarray:
        """Per-entity diagonal-inverse-Hessian variances (the reference's
        SIMPLE variance type, per entity): 1 / (Σ_r w·d2(m)·X² + λ₂),
        evaluated at the FULL final margins (residual offsets included)."""
        loss = losses_lib.get(self.task)
        _, l2 = self._reg()
        off_b = _gather_block_offsets(offsets.to(torch.float32), block)
        m = _rowdot(block.X, coefs) + off_b
        d2w = block.weights * loss.d2(m, block.labels)
        diag = _coldot(d2w, block.X * block.X) + l2
        return (1.0 / torch.clamp(diag, min=1e-12)).cpu().numpy()

    def finalize(self, state: list[Tensor], offsets=None) -> RandomEffectModel:
        compute_var = self.config.compute_variances and offsets is not None
        if compute_var:
            offsets = torch.as_tensor(np.asarray(offsets, np.float32),
                                      device=self.device)
        table: dict = {}
        var_table: dict = {} if compute_var else None
        for block, ids, coefs in zip(
            self.dataset.blocks, self.dataset.entity_ids, state
        ):
            cmap = to_numpy(block.col_map)
            w = to_numpy(coefs)
            var = (
                self._block_variances(block, coefs, offsets)
                if compute_var else None
            )
            col_parts, val_parts, var_parts = pack_entity_tables(cmap, w, var)
            for lane, key in enumerate(ids):
                table[key] = (col_parts[lane], val_parts[lane])
                if var_parts is not None:
                    var_table[key] = var_parts[lane]
        return RandomEffectModel(
            coefficients=table,
            feature_shard=self.feature_shard,
            entity_key=self.entity_key,
            task=self.task,
            n_features=self.dataset.n_features,
            variances=var_table,
        )
