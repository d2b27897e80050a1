"""GAME estimator and transformer, resident path (port of
``photon_ml_tpu/game/estimator.py``).

``fit`` builds per-coordinate datasets from feature shards + entity-id
columns, runs coordinate descent (tracking a validation ``EvaluationSuite``
after every coordinate update when validation data is given) and returns a
``GameModel``; ``fit_grid`` fits every coordinate-config combination over
shared datasets and validation scorers and selects the best by its final
validation metric (train metric without validation), optionally resuming
completed points from a ``GameGridCheckpointer``.  ``GameTransformer``
scores data with a trained model on the host (unseen entities contribute
0).  The "DataFrame" is (shards, ids, response, weight, offset) host
arrays: ``shards`` maps feature-shard name → scipy CSR, ``ids`` maps
id-column name → per-row entity keys.

Every coordinate runs on one device (CUDA unless the caller passes
``device="cpu"``).  Random effects are plain (``RandomEffectCoordinate``)
or factored (``game/factored.py``, w_e = V u_e); both share one built
dataset.  Out of core: a fixed effect with ``streaming_chunk_rows > 0``
streams a host chunk store (``game/streaming.py``), and a random effect
with ``device_budget_bytes > 0`` streams a host dataset, cached apart from
the resident one, in budget-bounded pass groups (``game/ooc_random.py``,
``game/ooc_factored.py``).

Over a process group (``mesh``, a ``DataGroup``: one rank a card) every
rank builds the same host datasets and places only its own shards on its
card: a resident fixed effect row-sharded (``game/distributed.py``), a
streamed one from a store of this rank's shard of every chunk, a resident
random effect placed by the bucket-shard plan (``game/hierarchical.py``,
``split_factor`` its threshold), a factored one over everything-split
lanes, an out-of-core one with its slices placed by the same plan.  Every
rank ends each update with the coordinate's whole score vector, so every
rank runs the same descent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
from photon_ml_tpu_torch.device import resolve_device, to_numpy
from photon_ml_tpu_torch.evaluation.evaluators import Evaluator
from photon_ml_tpu_torch.game.coordinates import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.ooc_factored import (
    OutOfCoreFactoredRandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.ooc_random import (
    OutOfCoreRandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.streaming import StreamingFixedEffectCoordinate
from photon_ml_tpu_torch.game.data import (
    FixedEffectDataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.game.factored import FactoredRandomEffectCoordinate
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
    #: > 0 trains the coordinate OUT OF CORE: the shard lives in host RAM
    #: as chunks of this many rows, streamed through the card each
    #: objective pass (``game/streaming.py``).
    streaming_chunk_rows: int = 0
    #: chunks in flight when streaming (2 = the double buffer).
    prefetch_depth: int = 2
    #: chunks moved in one transfer and run in one consumer step.
    chunk_fuse: int = 1
    #: evaluate a bracket of line-search trials a streamed pass.
    batch_linesearch: bool = True
    #: chunk wire format when streaming: off|lossless|fp16|int8.
    stream_compress: str = "off"
    #: > 0 keeps up to this many MB of chunk buffers on the card across
    #: streamed passes (bitwise neutral).
    stream_hot_budget_mb: float = 0.0


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
    #: the bucket placement threshold (a bucket whose solve cost is ≥
    #: split_factor × the ideal per-rank share splits over the group); read
    #: only where a group forms, so ignored on one device.
    split_factor: float = 0.5
    #: > 0 trains the coordinate OUT OF CORE: entity blocks stay in host RAM
    #: and stream through the card in pass groups bounded by this many
    #: bytes (``game/ooc_random.py``).
    device_budget_bytes: int = 0
    #: pass groups in flight when out of core (each sized to
    #: device_budget_bytes / prefetch_depth).
    prefetch_depth: int = 2
    #: > 0 keeps up to this many MB of pass groups' static payloads on the
    #: card across passes (bitwise neutral).
    hot_budget_mb: float = 0.0


@dataclasses.dataclass(frozen=True)
class FactoredRandomEffectCoordinateConfig:
    """Reference: ``FactoredRandomEffectCoordinateConfiguration``: random
    effects constrained to a shared rank-``rank`` projection (w_e = V u_e,
    see ``game/factored.py``).  The dataset is a plain random effect's, so
    grid points share built datasets with it."""

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
    #: > 0 trains the coordinate OUT OF CORE (``game/ooc_factored.py``).
    device_budget_bytes: int = 0
    #: pass groups in flight when out of core.
    prefetch_depth: int = 2


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

    ``stage_seconds`` maps a stage (the dataset and bucket builds, the
    validation scorers' build, the descent, and inside it the train metric
    and the validation scoring and metrics) to the host seconds of each
    time it ran.  Device work still queued when a stage's block ends is
    not in it; the descent ends in a readback of its history, so its time
    is whole.
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
        self.mesh = mesh
        self.task = losses_lib.get(task).name  # canonicalize aliases
        self.coordinate_configs = dict(coordinate_configs)
        self.device_metrics = device_metrics
        self.n_iterations = n_iterations
        self.logger = logger
        self.pipeline = bool(pipeline)
        self.device = resolve_device(device)
        self.stage_seconds: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds.setdefault(name, []).append(
                time.perf_counter() - t0)

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
            shard = shards[cfg.feature_shard]
            key = self.dataset_key(cfg)
            if isinstance(cfg, FixedEffectCoordinateConfig):
                coordinates.append(self._fixed(name, cfg, shard, response,
                                               weight, cache, key, n))
                continue
            factored = isinstance(cfg, FactoredRandomEffectCoordinateConfig)
            ooc = cfg.device_budget_bytes > 0
            if self.mesh is not None and not ooc:
                coordinates.append(self._distributed_random(
                    name, cfg, shard, ids, response, weight, cache, key,
                    factored))
                continue
            # The host dataset of the out-of-core path is cached apart from
            # the resident one.
            ds_key = ("ooc_ds",) + key if ooc else key
            dataset = cache.get(ds_key)
            if dataset is None:
                with self._stage("random-effect bucket build"):
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
                        device=False if ooc else self.device,
                    )
                cache[ds_key] = dataset
            kw = dict(feature_shard=cfg.feature_shard,
                      entity_key=cfg.entity_key)
            if ooc:
                kw.update(device_budget_bytes=cfg.device_budget_bytes,
                          prefetch_depth=cfg.prefetch_depth,
                          device=self.device, mesh=self.mesh)
            if factored:
                cls = (OutOfCoreFactoredRandomEffectCoordinate if ooc
                       else FactoredRandomEffectCoordinate)
                coordinates.append(cls(
                    name, dataset, self.task, cfg.optimization,
                    rank=cfg.rank, reg_weight=cfg.reg_weight,
                    projection_reg_weight=cfg.projection_reg_weight,
                    alternations=cfg.alternations, **kw,
                ))
            elif ooc:
                coordinates.append(OutOfCoreRandomEffectCoordinate(
                    name, dataset, self.task, cfg.optimization,
                    cfg.reg_weight,
                    hot_budget_bytes=int(cfg.hot_budget_mb * 1e6),
                    split_factor=cfg.split_factor, **kw,
                ))
            else:
                coordinates.append(RandomEffectCoordinate(
                    name, dataset, self.task, cfg.optimization,
                    cfg.reg_weight, **kw,
                ))
        return coordinates

    def _fixed(self, name, cfg, shard, response, weight, cache, key, n):
        """The fixed-effect coordinate of ``cfg``: streamed from a host
        chunk store when ``streaming_chunk_rows > 0`` (over a group, this
        rank's shard of every chunk), else resident (over a group,
        row-sharded)."""
        dataset = cache.get(key)
        if cfg.streaming_chunk_rows > 0:
            if dataset is None:
                with self._stage("fixed-effect chunk store build"):
                    dataset = make_streaming_glm_data(
                        shard, response,
                        weights=self._train_weight(cfg, response, weight),
                        chunk_rows=cfg.streaming_chunk_rows,
                        device=self.device, mesh=self.mesh,
                    )
                cache[key] = dataset
            return StreamingFixedEffectCoordinate(
                name, dataset, self.task, cfg.optimization, cfg.reg_weight,
                feature_shard=cfg.feature_shard, mesh=self.mesh,
                prefetch_depth=cfg.prefetch_depth,
                chunk_fuse=cfg.chunk_fuse,
                batch_linesearch=cfg.batch_linesearch,
                compress=cfg.stream_compress,
                hot_budget_bytes=int(cfg.stream_hot_budget_mb * 1e6),
            )
        if self.mesh is not None:
            return self._distributed_fixed(name, cfg, shard, response,
                                           weight, cache, key)
        if dataset is None:
            with self._stage("fixed-effect dataset build"):
                data = make_glm_data(
                    shard, response,
                    weights=self._train_weight(cfg, response, weight),
                    device=self.device,
                )
            dataset = FixedEffectDataset(data=data, n_global_rows=n)
            cache[key] = dataset
        return FixedEffectCoordinate(
            name, dataset, self.task, cfg.optimization, cfg.reg_weight,
            feature_shard=cfg.feature_shard,
        )

    def _distributed_fixed(self, name, cfg, shard, response, weight, cache,
                           key):
        """The row-sharded fixed effect.  Grid points sharing the dataset
        and the optimizer config reuse the coordinate (a shallow copy with
        its own name and ``reg_weight``); the sharded dataset is cached
        apart, so a config change never re-shards or re-uploads the
        matrix."""
        import copy

        from photon_ml_tpu_torch.game.distributed import (
            DistributedFixedEffectCoordinate,
        )

        cached = cache.get(("dist",) + key)
        if cached is not None and cached[0] == cfg.optimization:
            coord = copy.copy(cached[1])
            coord.name = name
            coord.reg_weight = cfg.reg_weight
            return coord
        dist = cache.get(("dist_ds",) + key)
        with self._stage("fixed-effect dataset build"):
            coord = DistributedFixedEffectCoordinate(
                name, shard, np.asarray(response, np.float32), self.mesh,
                self.task, cfg.optimization, cfg.reg_weight,
                feature_shard=cfg.feature_shard,
                # The (down-sampled) weights matter only for a new shard.
                weights=(None if dist is not None
                         else self._train_weight(cfg, response, weight)),
                dist=dist, device=self.device)
        cache[("dist_ds",) + key] = coord.dist
        cache[("dist",) + key] = (cfg.optimization, coord)
        return coord

    def _distributed_random(self, name, cfg, shard, ids, response, weight,
                            cache, key, factored: bool):
        """A random effect over the group: plain through the bucket-shard
        plan (big buckets split, the tail packed whole onto ranks; reads
        ``split_factor``), factored over everything-split lanes.  The same
        reuse rules as :meth:`_distributed_fixed`: the entity grouping is
        cached apart from the config, so a config change re-places blocks
        but never re-groups entities."""
        import copy

        from photon_ml_tpu_torch.game.distributed import (
            entity_sharded_factored_coordinate,
        )
        from photon_ml_tpu_torch.game.hierarchical import (
            ShardedBucketRandomEffectCoordinate,
        )

        sig = ((cfg.optimization, cfg.rank, cfg.alternations) if factored
               else (cfg.optimization, cfg.split_factor))
        cache_key = ("dist", factored) + key
        cached = cache.get(cache_key)
        if cached is not None and cached[0] == sig:
            coord = copy.copy(cached[1])
            coord.name = name
            coord.reg_weight = cfg.reg_weight
            if factored:
                coord.projection_reg_weight = (
                    cfg.reg_weight if cfg.projection_reg_weight is None
                    else cfg.projection_reg_weight)
            return coord
        ds_key = ("dist_ds",) + key
        dataset = cache.get(ds_key)
        if dataset is None:
            with self._stage("random-effect bucket build"):
                dataset = build_random_effect_dataset(
                    ids[cfg.entity_key], shard,
                    np.asarray(response, np.float32), weight,
                    max_rows_per_entity=cfg.max_rows_per_entity,
                    bucket_growth=cfg.bucket_growth, repack=cfg.repack,
                    program_budget=cfg.program_budget,
                    repack_seed=cfg.repack_seed,
                    device=False,  # the coordinate places its own lanes
                )
            cache[ds_key] = dataset
        kw = dict(feature_shard=cfg.feature_shard, entity_key=cfg.entity_key,
                  device=self.device)
        if factored:
            coord = entity_sharded_factored_coordinate(
                name, dataset, self.mesh, self.task, cfg.optimization,
                rank=cfg.rank, reg_weight=cfg.reg_weight,
                projection_reg_weight=cfg.projection_reg_weight,
                alternations=cfg.alternations, **kw)
        else:
            coord = ShardedBucketRandomEffectCoordinate(
                name, dataset, self.mesh, self.task, cfg.optimization,
                cfg.reg_weight, split_factor=cfg.split_factor, **kw)
        cache[cache_key] = (sig, coord)
        return coord

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

        ``validation`` is ``(shards, ids, response[, weight[, offset]])``;
        with it, every history entry carries the full validation
        ``EvaluationSuite`` after that coordinate update.
        ``initial_model`` warm-starts coordinate descent from a trained
        GameModel; ``locked_coordinates`` holds named coordinates at that
        model instead of retraining them; ``checkpointer`` is handed to
        :meth:`CoordinateDescent.run`."""
        coordinates = self._build_coordinates(
            self.coordinate_configs, shards, ids, response, weight, offset
        )
        train_groups = None
        if suite is not None and suite.group_column is not None:
            train_groups = np.asarray(ids[suite.group_column])
        return self.fit_coordinates(
            coordinates, response, weight, offset, evaluator,
            validation=validation, suite=suite,
            initial_model=initial_model, checkpointer=checkpointer,
            train_group_ids=train_groups,
            locked_coordinates=locked_coordinates,
        )

    def initial_states_from_model(self, coordinates, model: GameModel
                                  ) -> dict:
        """Project a GameModel onto pre-built coordinates' state layout:
        fixed effects take the coefficient vector directly; random effects
        materialize each bucket's (E, D) local-space matrix from the
        entity→sparse-coefficient table.  Coordinates absent from the model
        start from zero (state None), and so do factored coordinates: the
        saved model holds only the materialized w_e = V u_e, from which the
        factorization is not recoverable.  The datasets must come from data
        read with the model's index maps (width mismatches are caught)."""
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
                width = (c.dataset.data.n_features
                         if hasattr(c, "dataset") else c.n_features)
                if w.shape[0] != width:
                    raise ValueError(
                        f"initial model coordinate {c.name!r} has "
                        f"{w.shape[0]} features but the dataset has "
                        f"{width}; read the data with the initial model's "
                        "index maps"
                    )
                states[c.name] = c.place_state(w, self.device)
            elif isinstance(sub, RandomEffectModel):
                if isinstance(c, (FactoredRandomEffectCoordinate,
                                  OutOfCoreFactoredRandomEffectCoordinate)):
                    continue
                if sub.n_features != c.dataset.n_features:
                    raise ValueError(
                        f"initial model coordinate {c.name!r} has "
                        f"{sub.n_features} features but the dataset has "
                        f"{c.dataset.n_features}; read the data with the "
                        "initial model's index maps"
                    )
                # Host arrays; each coordinate places them as it keeps its
                # state (out-of-core coordinates keep them on the host).
                # (A sharded coordinate's padding lanes past the ids are
                # placed as zeros.)
                states[c.name] = c.place_state([
                    sub.coefficient_matrix_for(
                        to_numpy(block.col_map)[:len(ids)], ids)
                    for block, ids in zip(c.dataset.blocks,
                                          c.dataset.entity_ids)
                ], self.device)
        return states

    def fit_coordinates(
        self,
        coordinates,
        response,
        weight=None,
        offset=None,
        evaluator: Optional[Evaluator] = None,
        validation=None,
        suite=None,
        validation_scorers: Optional[dict] = None,
        initial_model: Optional[GameModel] = None,
        checkpointer=None,
        train_group_ids=None,
        locked_coordinates: Sequence[str] = (),
    ) -> tuple[GameModel, list]:
        """Run coordinate descent over pre-built coordinates (see
        :meth:`build_coordinates`) and finalize the GameModel.  Each history
        entry carries the primary evaluator's train metric and, with
        ``validation``, the whole suite on the validation data.

        Each coordinate's validation scores are refreshed incrementally:
        only the just-updated coordinate re-scores.  ``validation_scorers``
        (name → scorer, see ``game/validation.py``) lets grid loops reuse
        scorers built once per shared dataset.  With ``device_metrics`` the
        train and validation metrics compute on the device and ride the
        descent's batched readback; an evaluator with no device version
        (``evaluation/device.py::device_evaluator_fn`` gives None) is
        evaluated on the host from the scores copied back, as the
        reference does; a grouped suite is host-side and refuses it.

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
        device_metrics = self.device_metrics
        if device_metrics and (suite.group_column is not None
                               or train_group_ids is not None):
            raise ValueError(
                "device_metrics computes GLOBAL metrics; grouped evaluation "
                f"(suite group_column={suite.group_column!r} / explicit "
                "train_group_ids) is host-side"
            )

        val = None
        if validation is not None:
            v_shards, v_ids, v_resp = validation[:3]
            v_weight = validation[3] if len(validation) > 3 else None
            v_offset = validation[4] if len(validation) > 4 else None
            n_val = len(v_resp)
            if validation_scorers is None:
                with self._stage("validation scorer build"):
                    validation_scorers = {
                        c.name: c.make_validation_scorer(v_shards, v_ids)
                        for c in coordinates
                    }
            val = {
                "scorers": validation_scorers,
                "resp": np.asarray(v_resp, np.float32),
                "weight": (None if v_weight is None
                           else np.asarray(v_weight, np.float32)),
                "base": (np.zeros(n_val, np.float32) if v_offset is None
                         else np.asarray(v_offset, np.float32)),
                # Per-group evaluation: the suite's group column names an
                # id column of the validation set.
                "groups": (None if suite.group_column is None
                           else np.asarray(v_ids[suite.group_column])),
                # Per-coordinate validation scores, refreshed incrementally.
                "scores": {c.name: np.zeros(n_val, np.float32)
                           for c in coordinates},
                "primed": False,
            }

        primary_dev = None
        if device_metrics:
            from photon_ml_tpu_torch.evaluation.device import (
                device_evaluator_fn,
            )

            # Labels and weights go to the device ONCE; each update's
            # metrics then stay there and ride the descent's readback.
            resp_dev = torch.as_tensor(response, device=dev)
            w_dev = None if w_host is None else torch.as_tensor(
                w_host, device=dev)
            primary_dev = device_evaluator_fn(primary)
            if val is not None:
                val["resp"] = torch.as_tensor(val["resp"], device=dev)
                if val["weight"] is not None:
                    val["weight"] = torch.as_tensor(val["weight"], device=dev)
                val["base"] = torch.as_tensor(val["base"], device=dev)
                val["scores"] = {k: torch.zeros(len(v), dtype=torch.float32,
                                                device=dev)
                                 for k, v in val["scores"].items()}

        def keep(scores):
            return scores if device_metrics else to_numpy(scores)

        def eval_fn(it, cname, scores, states):
            with self._stage("train metric"):
                entry = train_entry(scores)
            if val is None:
                return entry
            with self._stage("validation scoring and metrics"):
                metrics = validation_metrics(cname, states)
            entry["validation"] = metrics
            entry["validation_metric"] = metrics[suite.primary]
            return entry

        def train_entry(scores):
            if device_metrics:
                total = base_dev + sum(scores.values())
                train_metric = (
                    primary_dev(total, resp_dev, w_dev)
                    if primary_dev is not None
                    else primary.evaluate(to_numpy(total), response, w_host)
                )
            elif suite.group_column is not None and train_group_ids is None:
                # A per-group primary without train group ids records None
                # rather than mixing global and per-group semantics.
                train_metric = None
            else:
                total = base_offsets + np.sum(
                    [to_numpy(s) for s in scores.values()], axis=0)
                train_metric = primary.evaluate(
                    total, response, w_host, group_ids=train_group_ids)
            return {"train_metric": train_metric,
                    "evaluator": type(primary).__name__}

        def validation_metrics(cname, states):
            if not val["primed"]:
                # First evaluation: warm starts and resumed runs carry live
                # states for coordinates that have not updated yet this
                # run; score them all once.
                for c in coordinates:
                    if states[c.name] is not None:
                        val["scores"][c.name] = keep(
                            val["scorers"][c.name].score(states[c.name]))
                val["primed"] = True
            else:
                val["scores"][cname] = keep(
                    val["scorers"][cname].score(states[cname]))
            if device_metrics:
                v_total = val["base"] + sum(val["scores"].values())
                return suite.evaluate_device(
                    v_total, val["resp"], val["weight"], materialize=False)
            v_total = val["base"] + np.sum(list(val["scores"].values()),
                                           axis=0)
            return suite.evaluate(v_total, val["resp"], val["weight"],
                                  group_ids=val["groups"])

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
        unlockable = [
            n_ for n_ in locked
            if initial_states is None or initial_states.get(n_) is None
        ]
        if unlockable:
            # A factored coordinate's saved sub-model holds materialized w_e
            # only, so its (u, V) state cannot be rebuilt from it.
            raise ValueError(
                f"coordinates {unlockable} cannot be locked: their prior "
                "state is not reconstructible from the initial model "
                "(factored coordinates save materialized coefficients "
                "only)"
            )
        cd = CoordinateDescent(coordinates, pipeline=self.pipeline)
        with self._stage("descent"):
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
            host_scores = {k: to_numpy(s) for k, s in result.scores.items()}
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
        """Fit EVERY coordinate-config combination and select the best.

        ``grid_configs`` is a list of name→config mappings (one grid point
        each, same coordinate names).  Datasets and validation scorers are
        built once per distinct :meth:`dataset_key` and shared across
        points.  Selection: the final validation primary metric when
        ``validation`` is given, else the final train metric.  Returns
        ``(best_model, point_results)``; each point result carries
        ``configs / model / history / metric``.

        ``grid_checkpointer`` (``io.checkpoint.GameGridCheckpointer``):
        completed points persist as saved models and are SKIPPED on
        re-entry, so an interrupted grid resumes at the completed-point
        boundary."""
        from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite

        if not grid_configs:
            raise ValueError("empty coordinate-config grid")
        if suite is None:
            suite = EvaluationSuite.for_task(self.task)
        dataset_cache: dict = {}
        scorer_cache: dict = {}
        results: list[dict] = []
        best_idx, best_metric = None, None
        metric_key = ("validation_metric" if validation is not None
                      else "train_metric")
        train_groups = (None if suite.group_column is None
                        else np.asarray(ids[suite.group_column]))
        for gi, configs in enumerate(grid_configs):
            loaded = (grid_checkpointer.load_point(gi, configs, metric_key)
                      if grid_checkpointer is not None else None)
            if loaded is not None:
                model, metric, history = loaded
                point = {"resumed": True}
            else:
                coordinates = self._build_coordinates(
                    configs, shards, ids, response, weight, offset,
                    dataset_cache=dataset_cache,
                )
                scorers = None
                if validation is not None:
                    scorers = {}
                    for name, cfg in configs.items():
                        # Fixed-effect scorers depend only on the feature
                        # shard (down-sampling is train-side only).
                        key = (
                            ("fixed_scorer", cfg.feature_shard)
                            if isinstance(cfg, FixedEffectCoordinateConfig)
                            else (type(cfg).__name__,)
                            + self.dataset_key(cfg)
                        )
                        if key not in scorer_cache:
                            coord = next(c for c in coordinates
                                         if c.name == name)
                            with self._stage("validation scorer build"):
                                scorer_cache[key] = \
                                    coord.make_validation_scorer(
                                        validation[0], validation[1])
                        scorers[name] = scorer_cache[key]
                model, history = self.fit_coordinates(
                    coordinates, response, weight, offset,
                    validation=validation, suite=suite,
                    validation_scorers=scorers, initial_model=initial_model,
                    train_group_ids=train_groups,
                )
                metric = history[-1].get(metric_key) if history else None
                if grid_checkpointer is not None:
                    grid_checkpointer.save_point(gi, configs, model, metric,
                                                 metric_key, history)
                point = {}
            results.append({
                "grid_index": gi,
                "configs": configs,
                "model": model,
                "history": history,
                "metric": metric,
                "selected_by": metric_key,
                **point,
            })
            if best_idx is None or suite.better_than(metric, best_metric):
                best_idx, best_metric = gi, metric
            if self.logger is not None:
                self.logger.info(
                    "grid point %d/%d%s: %s = %s", gi + 1, len(grid_configs),
                    " resumed from checkpoint" if loaded is not None else "",
                    metric_key, metric,
                )
        for r in results:
            r["best"] = r["grid_index"] == best_idx
        return results[best_idx]["model"], results


@dataclasses.dataclass
class PreparedScoringSet:
    """Grouped block structures for scoring ONE dataset many times.

    Grouping rows into per-entity blocks is the dominant host cost of
    random-effect scoring; ``GameTransformer.prepare`` pays it once and every
    later ``transform`` over the same data reuses it."""

    n_rows: int
    re_datasets: dict  # coordinate name -> host RandomEffectDataset


class GameTransformer:
    """Reference: ``GameTransformer`` — batch scoring with a GameModel:
    fixed effect = one matvec; each random effect = a block gather of
    per-entity coefficients; total = sum + offset.

    Scoring is host compute (a scipy matvec, packed-table gathers and
    ``np.add.at``, deterministic), as the reference designs it: uploading
    scoring shards to the card just to pull scores back would cost more
    than the products.  The math lives in ``serving/kernels.py``.  Repeated
    calls on the SAME (shards, ids) objects reuse the entity grouping
    automatically (a cache slot cleared by weakref callbacks when a source
    array dies); for explicit control, call :meth:`prepare` once and pass
    ``prepared=`` to every transform."""

    def __init__(self, model: GameModel, logger=None):
        self.model = model
        self.logger = logger
        # (value-identity key, [weakrefs to source arrays], prepared).
        self._cache: Optional[tuple] = None

    def prepare(self, shards: dict, ids: dict) -> PreparedScoringSet:
        """Group scoring rows by entity for every random-effect coordinate
        (build once, score many times)."""
        n = next(iter(shards.values())).shape[0]
        re_datasets = {}
        for name, sub in self.model.models.items():
            if isinstance(sub, RandomEffectModel):
                # A file with NO rows carrying this id column yields no ids
                # entry at all: the same join miss as rows individually
                # missing it, zero contribution.
                entity_col = ids.get(sub.entity_key)
                if entity_col is None:
                    entity_col = np.full(n, None, object)
                re_datasets[name] = build_random_effect_dataset(
                    np.asarray(entity_col),
                    shards[sub.feature_shard],
                    np.zeros(n, np.float32),
                    np.ones(n, np.float32),
                    device="cpu",
                    # Rows without this entity id get zero contribution.
                    allow_missing=True,
                )
        return PreparedScoringSet(n_rows=n, re_datasets=re_datasets)

    @staticmethod
    def _cache_key(shards: dict, ids: dict) -> tuple:
        """Identity of the VALUE objects (not the dicts): replacing a matrix
        or id column inside the same dict objects must miss the cache."""
        return (
            tuple(sorted((name, id(m)) for name, m in shards.items())),
            tuple(sorted((name, id(a)) for name, a in ids.items())),
        )

    def _prepared_for(self, shards: dict, ids: dict) -> PreparedScoringSet:
        import weakref

        key = self._cache_key(shards, ids)
        if self._cache is not None and self._cache[0] == key:
            return self._cache[2]
        prepared = self.prepare(shards, ids)

        def _clear(_ref, _self=weakref.ref(self)):
            t = _self()
            if t is not None:
                t._cache = None

        refs = []
        for obj in list(shards.values()) + list(ids.values()):
            try:
                refs.append(weakref.ref(obj, _clear))
            except TypeError:
                pass  # un-weakref-able value: the identity key still holds
        self._cache = (key, refs, prepared)
        return prepared

    def transform(self, shards: dict, ids: dict,
                  offset: Optional[np.ndarray] = None,
                  prepared: Optional[PreparedScoringSet] = None
                  ) -> np.ndarray:
        n = next(iter(shards.values())).shape[0]
        if prepared is not None and prepared.n_rows != n:
            raise ValueError(
                f"prepared scoring set covers {prepared.n_rows} rows but "
                f"the shards have {n}; prepare() must be called on the same "
                "data being transformed"
            )
        from photon_ml_tpu_torch.serving import kernels as serving_kernels

        parts = []
        for name, sub in self.model.models.items():
            if isinstance(sub, FixedEffectModel):
                parts.append(serving_kernels.fixed_effect_matvec(
                    shards[sub.feature_shard], sub.model.coefficients.means))
            else:
                if prepared is None:
                    prepared = self._prepared_for(shards, ids)
                parts.append(serving_kernels.random_effect_block_scores(
                    sub, prepared.re_datasets[name]))
        return serving_kernels.sum_margins(n, offset, parts)

    def transform_with_mean(self, shards, ids, offset=None) -> np.ndarray:
        """Scores through the task's inverse link (probabilities for
        logistic, rates for Poisson)."""
        margins = self.transform(shards, ids, offset)
        return to_numpy(losses_lib.get(self.model.task).mean_fn(
            torch.as_tensor(margins)))
