"""Search scheduling: the ask/tell proposer interface and ASHA (port of
``photon_ml_tpu/tuning/scheduler.py``).

hyperparameter/search.py is a library FUNCTION — ``find(evaluate, n)``
owns the loop and evaluates synchronously, so it can neither run trials
concurrently nor survive a kill.  This module inverts that control:

- **Proposers** expose ``ask() → params`` / ``tell(params, y)`` so the
  orchestrator (tuning/executor.py) owns the loop, journals every
  decision, and keeps several asks IN FLIGHT at once.  The GP proposer
  supports batched asks via constant-liar imputation: pending
  (asked-but-unresolved) points enter the surrogate fit with the current
  best observed value as a stand-in, so the next ask's
  expected-improvement argmax is pushed away from points already being
  evaluated instead of proposing them again.
- **AshaScheduler** implements successive halving on intermediate rung
  metrics (ASHA, arXiv:1810.05934 applied at this repo's scale): rung r
  runs each trial at ``min_resource·η^r`` resource; on a rung report the
  trial is promoted iff it ranks in the top ``max(1, n//η)`` of every
  metric seen at that rung, else killed.  Decisions are made per report
  (no barrier across trials beyond the executor's wave), and the
  deterministic ``(metric, trial_id)`` ordering makes them replayable.

Everything here speaks MINIMIZATION internally (like
hyperparameter/search.py); the orchestrator applies the sign once at
its boundary.  All randomness flows through one ``numpy`` Generator per
proposer whose full bit-generator state is exposed for the journal
(``rng_state``/``set_rng_state``) — the reproducibility-under-resume
contract.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.hyperparameter.search import (
    GaussianProcessModel,
    expected_improvement,
)


# ---------------------------------------------------------------------------
# Search space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """A bounded box of named dimensions, optionally log-scaled — the same
    geometry hyperparameter/search.py searches, made an explicit value so
    it can be fingerprinted into the journal header."""

    bounds: tuple  # ((lo, hi), ...)
    log_scale: tuple  # (bool, ...) per dimension
    names: tuple  # ("fixed", "per_user", ...)

    @classmethod
    def create(
        cls,
        bounds: Sequence[tuple],
        log_scale=False,
        names: Optional[Sequence[str]] = None,
    ) -> "SearchSpace":
        bounds = tuple((float(lo), float(hi)) for lo, hi in bounds)
        d = len(bounds)
        for j, (lo, hi) in enumerate(bounds):
            if not lo < hi:
                raise ValueError(f"dimension {j}: empty bounds [{lo}, {hi}]")
        ls = (
            (bool(log_scale),) * d
            if isinstance(log_scale, bool)
            else tuple(bool(b) for b in log_scale)
        )
        if len(ls) != d:
            raise ValueError("log_scale length != bounds length")
        for j, ((lo, _), lg) in enumerate(zip(bounds, ls)):
            if lg and lo <= 0.0:
                raise ValueError(
                    f"dimension {j}: log scale requires a positive lower "
                    f"bound, got {lo}"
                )
        nm = (
            tuple(f"x{j}" for j in range(d))
            if names is None
            else tuple(str(n) for n in names)
        )
        if len(nm) != d:
            raise ValueError("names length != bounds length")
        return cls(bounds=bounds, log_scale=ls, names=nm)

    @property
    def dim(self) -> int:
        return len(self.bounds)

    def to_config(self) -> dict:
        return {
            "names": list(self.names),
            "bounds": [list(b) for b in self.bounds],
            "log_scale": list(self.log_scale),
        }

    @classmethod
    def from_config(cls, cfg: dict) -> "SearchSpace":
        return cls.create(
            cfg["bounds"], log_scale=cfg["log_scale"], names=cfg["names"]
        )

    def fingerprint(self) -> str:
        """Stable identity of the search geometry; a resumed search must
        match the journal's or be refused (tuning/state.py)."""
        return hashlib.sha256(
            json.dumps(self.to_config(), sort_keys=True).encode()
        ).hexdigest()

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Uniform (log-uniform where flagged) points in the box."""
        out = np.empty((n, self.dim))
        for j, (lo, hi) in enumerate(self.bounds):
            if self.log_scale[j]:
                out[:, j] = np.exp(
                    rng.uniform(np.log(lo), np.log(hi), size=n)
                )
            else:
                out[:, j] = rng.uniform(lo, hi, size=n)
        return out

    def normalize(self, X: np.ndarray) -> np.ndarray:
        """Map the (possibly log-scaled) box to [0,1]^d — the GP's input
        space, and the metric for nearest-neighbor warm starts."""
        X = np.atleast_2d(np.asarray(X, float))
        out = np.empty_like(X)
        for j, (lo, hi) in enumerate(self.bounds):
            if self.log_scale[j]:
                out[:, j] = (np.log(X[:, j]) - np.log(lo)) / (
                    np.log(hi) - np.log(lo)
                )
            else:
                out[:, j] = (X[:, j] - lo) / (hi - lo)
        return out


# ---------------------------------------------------------------------------
# Proposers
# ---------------------------------------------------------------------------

class Proposer:
    """ask/tell protocol.  ``ask`` returns one point and registers it as
    PENDING; every pending point must later be resolved by ``tell``
    (observed) or ``resolve`` (failed, no observation).  ``y`` is in
    minimization convention."""

    kind = "base"

    def __init__(self, space: SearchSpace, seed: int = 0):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.pending: list[np.ndarray] = []
        self.observations: list[tuple[np.ndarray, float]] = []

    # -- protocol ----------------------------------------------------------
    def ask(self) -> np.ndarray:
        x = self._propose()
        self.pending.append(np.asarray(x, float))
        return x

    def tell(self, x: np.ndarray, y: float) -> None:
        self._drop_pending(x)
        self.observations.append((np.asarray(x, float), float(y)))

    def resolve(self, x: np.ndarray) -> None:
        """Drop a pending ask without an observation (trial failed)."""
        self._drop_pending(x)

    def exhausted(self) -> bool:
        return False

    # -- journal restore ---------------------------------------------------
    def restore_ask(self, x: np.ndarray) -> None:
        """Re-register a journaled ask as pending WITHOUT consuming RNG
        (the journaled rng_state already reflects it)."""
        self.pending.append(np.asarray(x, float))

    @property
    def rng_state(self) -> dict:
        return self.rng.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state

    # -- internals ---------------------------------------------------------
    def _propose(self) -> np.ndarray:
        raise NotImplementedError

    def _drop_pending(self, x: np.ndarray) -> None:
        x = np.asarray(x, float)
        for i, p in enumerate(self.pending):
            if p.shape == x.shape and np.allclose(p, x, rtol=0, atol=0):
                del self.pending[i]
                return
        # Journal floats round-trip exactly through repr, so a miss means
        # a caller bug — but a proposer must never sink the search over
        # bookkeeping; drop the oldest pending instead.
        if self.pending:
            del self.pending[0]


class RandomProposer(Proposer):
    """Uniform sampling (the RandomSearch analogue)."""

    kind = "random"

    def _propose(self) -> np.ndarray:
        return self.space.sample(self.rng, 1)[0]


class GridProposer(Proposer):
    """A fixed, ordered list of points (λ-path sweeps, bench parity runs).
    RNG-free: sequential and parallel orchestration propose the identical
    trial set."""

    kind = "grid"

    def __init__(self, space: SearchSpace, points, seed: int = 0):
        super().__init__(space, seed)
        self.points = [
            np.atleast_1d(np.asarray(p, float)) for p in points
        ]
        self._next = 0

    def _propose(self) -> np.ndarray:
        if self._next >= len(self.points):
            raise IndexError("grid proposer exhausted")
        x = self.points[self._next]
        self._next += 1
        return x

    def restore_ask(self, x: np.ndarray) -> None:
        super().restore_ask(x)
        self._next += 1

    def exhausted(self) -> bool:
        return self._next >= len(self.points)


class GPProposer(Proposer):
    """GP + expected improvement with constant-liar batching.

    Sequentially this is GaussianProcessSearch's inner step; with k asks
    pending it fits the surrogate over observations ∪ pending, imputing
    each pending point's value as the best observed y (the CL-min
    "constant liar" of Ginsbourger et al.) — the liar flattens EI around
    in-flight points so a batch of asks spreads out instead of k copies
    of the same argmax.
    """

    kind = "gp"

    def __init__(
        self,
        space: SearchSpace,
        seed: int = 0,
        n_seed_points: int = 3,
        n_candidates: int = 256,
        length_scale="fit",
    ):
        super().__init__(space, seed)
        self.n_seed_points = int(n_seed_points)
        self.n_candidates = int(n_candidates)
        self.length_scale = length_scale

    def _propose(self) -> np.ndarray:
        # Cold start: random until the surrogate has seed observations
        # (pending count included — a 4-wide first wave is 4 random seeds,
        # not 1 random + 3 GP fits over nothing).
        if (
            not self.observations
            or len(self.observations) + len(self.pending) < self.n_seed_points
        ):
            return self.space.sample(self.rng, 1)[0]
        X_obs = [x for x, _ in self.observations]
        y_obs = [y for _, y in self.observations]
        best = float(np.min(y_obs))
        liar = best  # CL-min: pending points pinned at the incumbent
        X = np.asarray(X_obs + list(self.pending), float)
        y = np.asarray(y_obs + [liar] * len(self.pending), float)
        gp = GaussianProcessModel(self.length_scale).fit(
            self.space.normalize(X), y
        )
        candidates = self.space.sample(self.rng, self.n_candidates)
        mean, std = gp.predict(self.space.normalize(candidates))
        ei = expected_improvement(mean, std, best)
        return candidates[int(np.argmax(ei))]


PROPOSERS = {
    "random": RandomProposer,
    "gp": GPProposer,
    "grid": GridProposer,
}


def make_proposer(
    kind: str, space: SearchSpace, seed: int = 0, **kwargs
) -> Proposer:
    try:
        cls = PROPOSERS[kind]
    except KeyError:
        raise ValueError(
            f"unknown proposer {kind!r} (have {sorted(PROPOSERS)})"
        ) from None
    return cls(space, seed=seed, **kwargs)


# ---------------------------------------------------------------------------
# ASHA
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AshaConfig:
    """Successive-halving geometry.  Rung r's resource (optimizer
    iterations for GLM trials, CD iterations for GAME trials) is
    ``min_resource · reduction_factor^r``; ``num_rungs`` rungs total, so
    the top rung runs at ``min_resource · η^(num_rungs-1)``."""

    min_resource: int = 1
    reduction_factor: int = 3
    num_rungs: int = 3

    def __post_init__(self):
        if self.min_resource < 1 or self.num_rungs < 1:
            raise ValueError("min_resource and num_rungs must be >= 1")
        if self.reduction_factor < 2:
            raise ValueError("reduction_factor must be >= 2")

    def resource(self, rung: int) -> int:
        return self.min_resource * self.reduction_factor**rung

    @property
    def top_rung(self) -> int:
        return self.num_rungs - 1

    def to_config(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_config(cls, cfg: Optional[dict]) -> Optional["AshaConfig"]:
        return None if cfg is None else cls(**cfg)


class AshaScheduler:
    """Promote/kill decisions on rung metrics (minimization convention).

    ``report`` records the metric and decides; ``record`` only records —
    journal replay uses it to rebuild the rung tables for decisions that
    are already journaled, without re-deciding them.  Decisions are a
    pure function of the rung table CONTENTS (a set), so replaying
    records in any order reproduces the table the crashed run had.
    """

    def __init__(self, config: AshaConfig):
        self.config = config
        #: rung → {trial_id: y}; entries never change once written.
        self.rungs: list[dict[int, float]] = [
            {} for _ in range(config.num_rungs)
        ]

    def record(self, trial_id: int, rung: int, y: float) -> None:
        self.rungs[rung][trial_id] = float(y)

    def decide(self, trial_id: int, rung: int) -> str:
        """"complete" (top rung), "promote", or "stop"."""
        if rung >= self.config.top_rung:
            return "complete"
        table = self.rungs[rung]
        # Deterministic total order: metric, then trial id (stable under
        # exact ties, which synthetic objectives do produce).
        ranked = sorted(table.items(), key=lambda kv: (kv[1], kv[0]))
        keep = max(1, len(ranked) // self.config.reduction_factor)
        top = {tid for tid, _ in ranked[:keep]}
        return "promote" if trial_id in top else "stop"

    def report(self, trial_id: int, rung: int, y: float) -> str:
        self.record(trial_id, rung, y)
        return self.decide(trial_id, rung)
