"""Online per-entity refinement between full coordinate-descent sweeps
(port of ``photon_ml_tpu/freshness/online.py``).

A full CD sweep (``game/descent.py``) refits every coordinate against
the whole dataset — the freshest model it can produce is hours old by
the time it lands.  :class:`OnlineRefiner` closes that gap for the
coordinates where staleness actually hurts: the RANDOM effects.  It
warm-starts from the serving model's per-entity coefficients, folds in
labeled events one at a time with seeded SGD/AdaGrad on the canonical-
link gradient, and hands the result to the SAME delta publish path a
full sweep would use (``diff_game_models`` → ``DeltaPublisher``), so
the serving side cannot tell refined deltas from retrained ones.

Scope is deliberate: fixed effects are NOT touched (they move slowly
and globally; refitting them from a trickle of events would let one hot
entity's traffic drag the global model), and per-entity posteriors
(variances) are dropped for refined entities — point-estimate SGD says
nothing about the posterior, and shipping a stale variance next to a
fresh mean would be worse than shipping none.

Determinism: updates are plain float32 numpy in event order; two
refiners fed the same events from the same base produce bitwise-equal
models (the tests assert it via table checksums).  ``config.seed`` only
drives the optional event shuffle in :meth:`OnlineRefiner.consume`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.device import to_numpy
from photon_ml_tpu_torch.freshness.delta import ModelDelta, diff_game_models
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)


@dataclasses.dataclass(frozen=True)
class LabeledEvent:
    """One observed (features, entity ids, label) outcome.

    ``wall_epoch`` is when the event HAPPENED (not when it was
    processed) — it anchors the freshness SLO: the published delta
    carries the newest event's wall epoch, and the swapper measures
    ``freshness_event_to_servable_seconds`` against it at commit.
    """

    features: dict  # feature shard -> np.float32 (D,) dense vector
    ids: dict  # entity-key name -> str entity id
    label: float
    offset: float = 0.0
    wall_epoch: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    """Knobs for one refinement pass."""

    #: "adagrad" (per-coordinate adaptive step, the default — robust to
    #: feature-scale spread) or "sgd" (constant step).
    algorithm: str = "adagrad"
    learning_rate: float = 0.1
    #: L2 pull toward the warm-start coefficients (NOT toward zero):
    #: online refinement trusts the full sweep's estimate and should
    #: drift from it only as far as the events justify.
    l2: float = 0.0
    adagrad_eps: float = 1e-8
    #: clamp on the per-event error term, so one mislabeled outlier
    #: cannot blow up a low-traffic entity's row.
    max_error: float = 100.0
    seed: int = 0


class OnlineRefiner:
    """Refine a GAME model's random-effect rows from labeled events."""

    def __init__(self, model: GameModel, config: Optional[RefinerConfig] = None):
        self.config = config or RefinerConfig()
        if self.config.algorithm not in ("sgd", "adagrad"):
            raise ValueError(
                f"unknown refiner algorithm {self.config.algorithm!r} — "
                "expected 'sgd' or 'adagrad'"
            )
        self._base = model
        self._rng = np.random.default_rng(self.config.seed)
        # Dense working rows, built lazily per touched entity:
        # (coordinate, entity) -> float32 (n_features,).  Untouched
        # entities never leave the base model's sparse table, so the
        # exported model is bitwise-identical to the base everywhere the
        # events didn't reach — which is what keeps the delta small.
        self._work: Dict[Tuple[str, str], np.ndarray] = {}
        #: AdaGrad squared-gradient accumulators, same keying.
        self._accum: Dict[Tuple[str, str], np.ndarray] = {}
        #: warm-start anchors for the L2 pull (dense copy at first touch).
        self._anchor: Dict[Tuple[str, str], np.ndarray] = {}
        self.events = 0
        self.latest_event_wall: Optional[float] = None

    # -- model access --------------------------------------------------------
    def _dense_row(self, name: str, sub: RandomEffectModel, entity: str):
        key = (name, entity)
        row = self._work.get(key)
        if row is None:
            row = np.zeros(sub.n_features, np.float32)
            pair = sub.coefficients.get(entity)
            if pair is not None:
                cols, vals = pair
                row[np.asarray(cols, np.int64)] = np.asarray(vals, np.float32)
            self._work[key] = row
            self._anchor[key] = row.copy()
            self._accum[key] = np.zeros(sub.n_features, np.float32)
        return row

    def _margin(self, event: LabeledEvent) -> float:
        margin = float(event.offset)
        for name, coord in self._base.models.items():
            if isinstance(coord, FixedEffectModel):
                x = event.features.get(coord.feature_shard)
                if x is not None:
                    means = to_numpy(coord.model.coefficients.means)
                    margin += float(
                        np.dot(means.astype(np.float32), np.asarray(x, np.float32))
                    )
                continue
            entity = event.ids.get(coord.entity_key)
            x = event.features.get(coord.feature_shard)
            if entity is None or x is None:
                continue
            row = self._dense_row(name, coord, str(entity))
            margin += float(np.dot(row, np.asarray(x, np.float32)))
        return margin

    def _mean(self, margin: float) -> float:
        # Function-local import: keeps `import photon_ml_tpu_torch.freshness`
        # from dragging in the serving runtime (and its kernel machinery)
        # when only the delta/publisher side is wanted.
        from photon_ml_tpu_torch.serving.runtime import _host_mean

        return float(_host_mean(self._base.task, np.array([margin], np.float32))[0])

    # -- refinement ----------------------------------------------------------
    def step(self, event: LabeledEvent) -> float:
        """Fold one event into the working rows.  Returns the per-event
        error term (mean(margin) − label, post-clamp) for monitoring."""
        chaos_mod.maybe_fail(
            "online.step", events=self.events, ids=dict(event.ids)
        )
        cfg = self.config
        err = self._mean(self._margin(event)) - float(event.label)
        err = float(np.clip(err, -cfg.max_error, cfg.max_error))
        err32 = np.float32(err)
        for name, coord in self._base.models.items():
            if isinstance(coord, FixedEffectModel):
                continue
            entity = event.ids.get(coord.entity_key)
            x = event.features.get(coord.feature_shard)
            if entity is None or x is None:
                continue
            key = (name, str(entity))
            row = self._dense_row(name, coord, str(entity))
            x32 = np.asarray(x, np.float32)
            grad = err32 * x32
            if cfg.l2:
                grad = grad + np.float32(cfg.l2) * (row - self._anchor[key])
            if cfg.algorithm == "adagrad":
                acc = self._accum[key]
                acc += grad * grad
                step = grad / np.sqrt(acc + np.float32(cfg.adagrad_eps))
            else:
                step = grad
            row -= np.float32(cfg.learning_rate) * step
        self.events += 1
        if event.wall_epoch is not None:
            if self.latest_event_wall is None or (
                event.wall_epoch > self.latest_event_wall
            ):
                self.latest_event_wall = float(event.wall_epoch)
        telemetry_mod.current().counter("freshness_online_events_total").inc()
        return err

    def consume(
        self, events: Iterable[LabeledEvent], shuffle: bool = False
    ) -> List[float]:
        """Step through ``events`` (optionally in a seed-determined
        shuffled order); returns the per-event error terms."""
        batch = list(events)
        if shuffle:
            self._rng.shuffle(batch)
        return [self.step(e) for e in batch]

    # -- export --------------------------------------------------------------
    @property
    def touched(self) -> Dict[str, List[str]]:
        """Coordinate name -> sorted entity ids with refined rows."""
        out: Dict[str, List[str]] = {}
        for name, entity in self._work:
            out.setdefault(name, []).append(entity)
        return {name: sorted(ents) for name, ents in out.items()}

    def refined_model(self) -> GameModel:
        """A new :class:`GameModel` with refined rows re-sparsified and
        every untouched entity's arrays SHARED with the base model (so a
        subsequent diff sees them as bitwise-unchanged for free)."""
        models = {}
        for name, coord in self._base.models.items():
            if isinstance(coord, FixedEffectModel):
                models[name] = coord
                continue
            refined = {
                entity for (cname, entity) in self._work if cname == name
            }
            if not refined:
                models[name] = coord
                continue
            coeffs = dict(coord.coefficients)
            variances = dict(coord.variances) if coord.variances else None
            for entity in refined:
                row = self._work[(name, entity)]
                cols = np.flatnonzero(row).astype(np.int32)
                coeffs[entity] = (cols, row[cols].astype(np.float32))
                if variances is not None:
                    # Point-estimate refinement invalidates the posterior.
                    variances.pop(entity, None)
            models[name] = RandomEffectModel(
                coefficients=coeffs,
                feature_shard=coord.feature_shard,
                entity_key=coord.entity_key,
                task=coord.task,
                n_features=coord.n_features,
                variances=variances,
            )
        return GameModel(models=models, task=self._base.task)

    def delta(self) -> ModelDelta:
        """Diff the refined model against the warm-start base."""
        return diff_game_models(
            self._base,
            self.refined_model(),
            event_wall_epoch=self.latest_event_wall,
        )

    def publish(self, publisher):
        """Publish the refinement through ``publisher``
        (:class:`~photon_ml_tpu_torch.freshness.publisher.DeltaPublisher`) —
        the same artifact path a full retrain would use.  Returns the
        :class:`~photon_ml_tpu_torch.freshness.publisher.Publication`."""
        return publisher.publish(self.delta())
