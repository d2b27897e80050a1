"""GAME estimator, resident path (port of ``photon_ml_tpu/game/estimator.py``).

``fit`` builds per-coordinate datasets from feature shards + entity-id
columns, runs coordinate descent and returns a ``GameModel``; ``fit_grid``
fits every coordinate-config combination over shared datasets and selects
the best by its final train metric.  The "DataFrame" is (shards, ids,
response, weight, offset) host arrays: ``shards`` maps feature-shard name →
scipy CSR, ``ids`` maps id-column name → per-row entity keys.

Every dataset lives on one device (CUDA unless the caller passes
``device="cpu"``).  What the reference runs beyond that — streaming and
out-of-core coordinates, factored random effects, a device mesh, validation
data and the grid checkpointer — raises ``NotImplementedError`` naming the
ROADMAP item that brings it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.evaluation.evaluators import Evaluator
from photon_ml_tpu_torch.game.coordinates import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
    not_ported,
)
from photon_ml_tpu_torch.game.data import (
    FixedEffectDataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.optim.problem import GlmOptimizationConfig

@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfig:
    """Reference: ``FixedEffectCoordinateConfiguration`` (incl. its
    down-sampling rate, applied to this coordinate's TRAINING loss only)."""

    feature_shard: str
    optimization: GlmOptimizationConfig = GlmOptimizationConfig()
    reg_weight: float = 0.0
    #: <1.0 down-samples training rows (negatives only for binary tasks,
    #: uniform otherwise), re-weighting survivors; dropped rows get training
    #: weight 0, so every row is still scored.
    down_sampling_rate: float = 1.0
    #: > 0 trains the coordinate out of core in the reference; refused here.
    streaming_chunk_rows: int = 0


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfig:
    """Reference: ``RandomEffectCoordinateConfiguration`` (entity id column +
    feature shard + optimization; ``max_rows_per_entity`` is the active-set
    cap of the active/passive split)."""

    feature_shard: str
    entity_key: str
    optimization: GlmOptimizationConfig = GlmOptimizationConfig()
    reg_weight: float = 0.0
    max_rows_per_entity: Optional[int] = None
    #: geometric bucket grid for per-entity size bucketing (2.0 = pow2).
    bucket_growth: float = 2.0
    #: "geometric" ladder or the "cost_model" repacker (game/data.py).
    repack: str = "geometric"
    program_budget: int = 16
    repack_seed: int = 0
    #: > 0 trains the coordinate out of core in the reference; refused here.
    device_budget_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectCoordinateConfig:
    """Reference: ``FactoredRandomEffectCoordinateConfiguration`` (w_e =
    V u_e).  Accepted for the config's shape; fitting one raises."""

    feature_shard: str
    entity_key: str
    rank: int
    optimization: GlmOptimizationConfig = GlmOptimizationConfig()
    reg_weight: float = 0.0
    projection_reg_weight: Optional[float] = None
    alternations: int = 2
    max_rows_per_entity: Optional[int] = None
    bucket_growth: float = 2.0
    repack: str = "geometric"
    program_budget: int = 16
    repack_seed: int = 0


CoordinateConfig = (
    FixedEffectCoordinateConfig
    | RandomEffectCoordinateConfig
    | FactoredRandomEffectCoordinateConfig
)


class GameEstimator:
    """Reference: ``GameEstimator``.  ``coordinate_configs`` is an ORDERED
    name→config mapping; the update order is the reference's
    ``coordinateUpdateSequence``.

    ``device_metrics``: the per-update train metric computes on the device
    (``evaluation/device.py``) and rides the descent's batched readback.
    """

    def __init__(
        self,
        task: str,
        coordinate_configs: dict,
        n_iterations: int = 1,
        logger=None,
        mesh=None,
        device_metrics: bool = False,
        pipeline: bool = False,
        device=None,
    ):
        if mesh is not None:
            raise not_ported("multi-device GAME (a mesh)", 6,
                              "multi-device")
        self.task = losses_lib.get(task).name  # canonicalize aliases
        self.coordinate_configs = dict(coordinate_configs)
        self.device_metrics = device_metrics
        self.n_iterations = n_iterations
        self.logger = logger
        self.pipeline = bool(pipeline)
        self.device = resolve_device(device)

    def build_coordinates(self, shards, ids, response, weight=None,
                          offset=None):
        """Build per-coordinate datasets + coordinate objects once; tuning
        loops reuse them (mutating ``coord.reg_weight``)."""
        return self._build_coordinates(
            self.coordinate_configs, shards, ids, response, weight, offset
        )

    @staticmethod
    def dataset_key(cfg) -> tuple:
        """Cache key of the DATASET a config needs: grid points differing
        only in optimizer/regularization share built datasets."""
        if isinstance(cfg, FixedEffectCoordinateConfig):
            return (
                "fixed", cfg.feature_shard, cfg.down_sampling_rate,
                cfg.streaming_chunk_rows,
            )
        return (
            "random",
            cfg.feature_shard,
            cfg.entity_key,
            cfg.max_rows_per_entity,
            cfg.bucket_growth,
            cfg.repack,
            cfg.program_budget,
            cfg.repack_seed,
        )

    def _build_coordinates(
        self,
        coordinate_configs,
        shards,
        ids,
        response,
        weight,
        offset,
        dataset_cache: Optional[dict] = None,
    ):
        n = len(response)
        weight = (np.ones(n, np.float32) if weight is None
                  else np.asarray(weight, np.float32))
        cache = {} if dataset_cache is None else dataset_cache
        coordinates = []
        for name, cfg in coordinate_configs.items():
            if isinstance(cfg, FactoredRandomEffectCoordinateConfig):
                raise not_ported(
                    f"coordinate {name!r}: a factored random effect", 3,
                    "GAME factored random effect")
            if getattr(cfg, "streaming_chunk_rows", 0) > 0 or getattr(
                    cfg, "device_budget_bytes", 0) > 0:
                raise not_ported(
                    f"coordinate {name!r}: out-of-core training", 5,
                    "out-of-core")
            shard = shards[cfg.feature_shard]
            key = self.dataset_key(cfg)
            if isinstance(cfg, FixedEffectCoordinateConfig):
                dataset = cache.get(key)
                if dataset is None:
                    data = make_glm_data(
                        shard, response,
                        weights=self._train_weight(cfg, response, weight),
                        device=self.device,
                    )
                    dataset = FixedEffectDataset(data=data, n_global_rows=n)
                    cache[key] = dataset
                coordinates.append(FixedEffectCoordinate(
                    name, dataset, self.task, cfg.optimization,
                    cfg.reg_weight, feature_shard=cfg.feature_shard,
                ))
                continue
            dataset = cache.get(key)
            if dataset is None:
                dataset = build_random_effect_dataset(
                    ids[cfg.entity_key],
                    shard,
                    np.asarray(response, np.float32),
                    weight,
                    max_rows_per_entity=cfg.max_rows_per_entity,
                    bucket_growth=cfg.bucket_growth,
                    repack=cfg.repack,
                    program_budget=cfg.program_budget,
                    repack_seed=cfg.repack_seed,
                    device=self.device,
                )
                cache[key] = dataset
            coordinates.append(RandomEffectCoordinate(
                name, dataset, self.task, cfg.optimization, cfg.reg_weight,
                feature_shard=cfg.feature_shard, entity_key=cfg.entity_key,
            ))
        return coordinates

    def _train_weight(self, cfg, response, weight):
        """The fixed effect's training weights, down-sampled on a cache
        miss only."""
        if cfg.down_sampling_rate >= 1.0:
            return weight
        from photon_ml_tpu_torch.data.sampling import (
            BinaryClassificationDownSampler,
            DefaultDownSampler,
        )

        binary = self.task in ("logistic", "smoothed_hinge")
        sampler = (
            BinaryClassificationDownSampler(cfg.down_sampling_rate)
            if binary else DefaultDownSampler(cfg.down_sampling_rate)
        )
        idx, w_kept = sampler.downsample(response, weight)
        tw = np.zeros(len(response), np.float32)
        tw[idx] = w_kept
        return tw

    def fit(
        self,
        shards: dict,
        ids: dict,
        response: np.ndarray,
        weight: Optional[np.ndarray] = None,
        offset: Optional[np.ndarray] = None,
        evaluator: Optional[Evaluator] = None,
        validation=None,
        suite=None,
        initial_model: Optional[GameModel] = None,
        checkpointer=None,
        locked_coordinates: Sequence[str] = (),
    ) -> tuple[GameModel, list]:
        """Train; returns (model, per-coordinate-update history).

        ``initial_model`` warm-starts coordinate descent from a trained
        GameModel; ``locked_coordinates`` holds named coordinates at that
        model instead of retraining them; ``checkpointer`` is handed to
        :meth:`CoordinateDescent.run`."""
        if validation is not None:
            raise not_ported("validation data in GameEstimator.fit", 2,
                              "GAME IO, validation and drivers")
        coordinates = self._build_coordinates(
            self.coordinate_configs, shards, ids, response, weight, offset
        )
        return self.fit_coordinates(
            coordinates, response, weight, offset, evaluator, suite=suite,
            initial_model=initial_model, checkpointer=checkpointer,
            locked_coordinates=locked_coordinates,
        )

    def initial_states_from_model(self, coordinates, model: GameModel
                                  ) -> dict:
        """Project a GameModel onto pre-built coordinates' state layout:
        fixed effects take the coefficient vector directly; random effects
        materialize each bucket's (E, D) local-space matrix from the
        entity→sparse-coefficient table.  Coordinates absent from the model
        start from zero (state None).  The datasets must come from data read
        with the model's index maps (width mismatches are caught)."""
        states: dict = {}
        for c in coordinates:
            sub = model.models.get(c.name)
            if sub is None:
                continue
            if isinstance(sub, FixedEffectModel):
                means = sub.model.coefficients.means
                w = (means.detach().cpu().numpy()
                     if isinstance(means, torch.Tensor) else np.asarray(means))
                w = w.astype(np.float32)
                width = c.dataset.data.n_features
                if w.shape[0] != width:
                    raise ValueError(
                        f"initial model coordinate {c.name!r} has "
                        f"{w.shape[0]} features but the dataset has "
                        f"{width}; read the data with the initial model's "
                        "index maps"
                    )
                states[c.name] = torch.as_tensor(w, device=self.device)
            elif isinstance(sub, RandomEffectModel):
                if sub.n_features != c.dataset.n_features:
                    raise ValueError(
                        f"initial model coordinate {c.name!r} has "
                        f"{sub.n_features} features but the dataset has "
                        f"{c.dataset.n_features}; read the data with the "
                        "initial model's index maps"
                    )
                states[c.name] = [
                    torch.as_tensor(sub.coefficient_matrix_for(
                        block.col_map.cpu().numpy(), ids),
                        device=self.device)
                    for block, ids in zip(c.dataset.blocks,
                                          c.dataset.entity_ids)
                ]
        return states

    def fit_coordinates(
        self,
        coordinates,
        response,
        weight=None,
        offset=None,
        evaluator: Optional[Evaluator] = None,
        suite=None,
        initial_model: Optional[GameModel] = None,
        checkpointer=None,
        locked_coordinates: Sequence[str] = (),
    ) -> tuple[GameModel, list]:
        """Run coordinate descent over pre-built coordinates (see
        :meth:`build_coordinates`) and finalize the GameModel.  Each
        history entry carries the primary evaluator's train metric.

        ``locked_coordinates`` (partial retraining): each named coordinate
        takes its coefficients from ``initial_model`` and is never
        retrained; its sub-model passes into the result unchanged."""
        from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite

        n = len(response)
        response = np.asarray(response, np.float32)
        base_offsets = (np.zeros(n, np.float32) if offset is None
                        else np.asarray(offset, np.float32))
        if suite is None:
            suite = (
                EvaluationSuite.from_specs([evaluator])
                if evaluator is not None
                else EvaluationSuite.for_task(self.task)
            )
        primary = suite.primary_evaluator
        w_host = None if weight is None else np.asarray(weight, np.float32)
        dev = self.device
        base_dev = torch.as_tensor(base_offsets, device=dev)

        primary_dev = None
        if self.device_metrics:
            from photon_ml_tpu_torch.evaluation.device import (
                device_evaluator_fn,
            )

            # Labels and weights go to the device ONCE; each update's
            # metric then stays there and rides the descent's readback.
            resp_dev = torch.as_tensor(response, device=dev)
            w_dev = None if w_host is None else torch.as_tensor(
                w_host, device=dev)
            primary_dev = device_evaluator_fn(primary)

        def eval_fn(it, cname, scores, states):
            if primary_dev is not None:
                total = base_dev + sum(scores.values())
                train_metric = primary_dev(total, resp_dev, w_dev)
            else:
                total = base_offsets + np.sum(
                    [s.detach().cpu().numpy() for s in scores.values()],
                    axis=0,
                )
                train_metric = primary.evaluate(total, response, w_host)
            return {"train_metric": train_metric,
                    "evaluator": type(primary).__name__}

        locked = tuple(locked_coordinates)
        if locked and initial_model is None:
            raise ValueError(
                "locked_coordinates requires initial_model (partial "
                "retraining holds those coordinates at the prior model)"
            )
        if locked:
            missing = [
                n_ for n_ in locked if n_ not in (initial_model.models or {})
            ]
            if missing:
                raise ValueError(
                    f"locked coordinates {missing} are not in the initial "
                    "model"
                )
        initial_states = (
            self.initial_states_from_model(coordinates, initial_model)
            if initial_model is not None else None
        )
        cd = CoordinateDescent(coordinates, pipeline=self.pipeline)
        result = cd.run(
            base_dev,
            n_iterations=self.n_iterations,
            eval_fn=eval_fn,
            logger=self.logger,
            checkpointer=checkpointer,
            initial_states=initial_states,
            locked=locked,
        )

        # Finalize with each coordinate's residual offsets (base + the
        # OTHER coordinates' scores), so variances, when a coordinate's
        # config asks for them, are evaluated at the full final margins.
        def wants_variances(c):
            cfg = getattr(c, "config", None) or getattr(
                getattr(c, "problem", None), "config", None)
            return bool(cfg is not None and cfg.compute_variances)

        host_scores = None
        total_np = None
        if any(wants_variances(c) for c in coordinates):
            host_scores = {k: s.detach().cpu().numpy()
                           for k, s in result.scores.items()}
            total_np = base_offsets + np.sum(list(host_scores.values()),
                                             axis=0)
        models = {}
        for c in coordinates:
            if c.name in locked:
                models[c.name] = initial_model.models[c.name]
                continue
            off_c = (total_np - host_scores[c.name]
                     if total_np is not None else None)
            models[c.name] = c.finalize(result.states[c.name], offsets=off_c)
        return GameModel(models=models, task=self.task), result.history

    def fit_grid(
        self,
        grid_configs: Sequence[dict],
        shards: dict,
        ids: dict,
        response: np.ndarray,
        weight: Optional[np.ndarray] = None,
        offset: Optional[np.ndarray] = None,
        validation=None,
        suite=None,
        initial_model: Optional[GameModel] = None,
        grid_checkpointer=None,
    ) -> tuple[GameModel, list[dict]]:
        """Fit EVERY coordinate-config combination and select the best by
        its final train metric.  ``grid_configs`` is a list of name→config
        mappings (one grid point each); datasets are built once per distinct
        :meth:`dataset_key` and shared.  Returns ``(best_model,
        point_results)``; each point result carries ``configs / model /
        history / metric``."""
        from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite

        if validation is not None:
            raise not_ported("validation data in GameEstimator.fit_grid", 2,
                              "GAME IO, validation and drivers")
        if grid_checkpointer is not None:
            raise not_ported("the GAME grid checkpointer", 2,
                              "GAME IO, validation and drivers")
        if not grid_configs:
            raise ValueError("empty coordinate-config grid")
        if suite is None:
            suite = EvaluationSuite.for_task(self.task)
        dataset_cache: dict = {}
        results: list[dict] = []
        best_idx, best_metric = None, None
        metric_key = "train_metric"
        for gi, configs in enumerate(grid_configs):
            coordinates = self._build_coordinates(
                configs, shards, ids, response, weight, offset,
                dataset_cache=dataset_cache,
            )
            model, history = self.fit_coordinates(
                coordinates, response, weight, offset, suite=suite,
                initial_model=initial_model,
            )
            metric = history[-1].get(metric_key) if history else None
            results.append({
                "grid_index": gi,
                "configs": configs,
                "model": model,
                "history": history,
                "metric": metric,
                "selected_by": metric_key,
            })
            if best_idx is None or suite.better_than(metric, best_metric):
                best_idx, best_metric = gi, metric
            if self.logger is not None:
                self.logger.info(
                    "grid point %d/%d: %s = %s",
                    gi + 1, len(grid_configs), metric_key, metric,
                )
        for r in results:
            r["best"] = r["grid_index"] == best_idx
        return results[best_idx]["model"], results
