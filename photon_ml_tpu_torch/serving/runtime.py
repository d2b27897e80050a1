"""Online scoring runtime: a hand-written bucket kernel + hot/cold entities
(port of ``photon_ml_tpu/serving/runtime.py``).

``ScoringRuntime`` loads a saved GLM or GAME model ONCE and turns it into
a request-path scorer on one device (``RuntimeConfig.device``: the CUDA
card unless the caller asks for the CPU):

- **Bucket ladder** — every batch runs ``csrc/serve_margins.cu``
  (serving/kernels.py) at a padded batch size from a ladder (powers of
  two up to ``max_batch_size``).  :meth:`ScoringRuntime.warm_up` builds
  the CUDA library and runs the kernel once at every bucket at startup,
  so the request path never builds anything.  A batch of B rows pads to
  the smallest bucket ≥ B; padding rows are zeros and slot 0 (exact
  no-ops).
- **Hot/cold split** — each random-effect coordinate's per-entity
  coefficients live host-side as the model's sparse table (millions of
  entities), while an LRU hot set of ``hot_entities`` dense rows stays
  resident on the device as a ``(H+1, D)`` table (row 0 reserved zero,
  filled by in-place row writes).  Hot rows gather ON DEVICE by slot;
  the cold tail falls back to host-side gathers
  (:func:`~photon_ml_tpu_torch.serving.kernels.dense_coefficient_rows`)
  uploaded with the batch, then promotes into the hot set (evicting LRU)
  for the next request.  ``table[slot] + cold`` keeps hot and cold rows
  bit-identical.

All mutation (LRU order, hot-table updates) happens on the dispatch
thread — the MicroBatcher owns scoring — so the runtime needs no locks;
``parse_request`` is read-only and safe from any request thread.  On the
card a batch is ONE launch and no copy: the host packs the bucket into
page-locked staging buffers that the kernel reads in place (unified
addressing), the kernel writes the margins and means into a page-locked
output buffer, and the batch waits for the calling thread's current CUDA
stream alone.  Each bucket's kernel argument block (staging addresses,
fixed means, hot tables, widths) is built once, when its buffers are
allocated; every pointer in it is fixed for the runtime's life (the hot
tables are written in place), and a swapped or patched runtime, or a
spawned worker, builds its own.

**Graceful degradation** (CPU runtimes only): a device-path failure the
port's watchdog classifies as transient (``UNAVAILABLE``/device
lost/...) flips the runtime into DEGRADED mode —
every batch scores through a pure-numpy host cold path (same margins and
mean link, no device touch, correct scores at host float tolerance) and
requests keep succeeding with zero errors.  A per-runtime circuit
breaker (:class:`photon_ml_tpu_torch.chaos.CircuitBreaker`, closed → open →
half-open) guards re-promotion: after ``breaker_cooldown_s`` one batch
probes the device path; success re-promotes (degraded flag clears), a
failed probe re-opens the breaker and degraded serving continues.  The
``degraded`` flag rides ``/healthz`` and ``/stats``.  A runtime on the
card never degrades: a CUDA fault leaves the context unusable
(``utils/watchdog.py``), so no in-process failure there is transient, and
every exception of its device path raises — at
:meth:`ScoringRuntime.warm_up` for a kernel build, on the batch for
anything else — rather than moving the batch onto the host.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.chaos.breaker import CircuitBreaker
from photon_ml_tpu_torch.device import resolve_device, to_numpy
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.models.glm import GeneralizedLinearModel
from photon_ml_tpu_torch.ops import losses as losses_lib
from photon_ml_tpu_torch.serving import kernels as kernels_lib


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Serving-side model knobs (batching knobs live on BatcherConfig)."""

    #: top of the bucket ladder; also the largest batch one dispatch scores.
    max_batch_size: int = 64
    #: per-coordinate LRU hot-set capacity (dense rows resident on device).
    hot_entities: int = 1024
    #: build the kernel and run it at every bucket at startup (skip only
    #: in tests that assert on warm-up behavior themselves).
    warmup: bool = True
    #: seconds the circuit breaker stays OPEN after a device-path failure
    #: before admitting one half-open probe batch (re-promotion guard).
    breaker_cooldown_s: float = 5.0
    #: consecutive device-path failures before the breaker trips.
    breaker_failure_threshold: int = 1
    #: hand the kernel the fused layout (views of one packed buffer, any
    #: model structure) instead of the composed per-coordinate arrays.
    #: Scores are bitwise identical either way (one kernel serves both,
    #: serving/kernels.py); the composed layout stays for parity with the
    #: reference's API.
    fused: bool = True
    #: the device the runtime scores on: None is the CUDA card (raises
    #: without one); "cpu" runs the kernel's plain version.
    device: Optional[str] = None


def _host_mean(task: str, margins: np.ndarray) -> np.ndarray:
    """The mean link evaluated with host numpy (degraded-mode scoring):
    the same inverse links ops/losses.py defines, no device touch.  The
    logistic branch uses the kernel's numerically-stable split so large
    |margin| rows agree with the device path."""
    if task == "logistic":
        out = np.empty_like(margins, np.float32)
        pos = margins >= 0
        out[pos] = 1.0 / (1.0 + np.exp(-margins[pos]))
        em = np.exp(margins[~pos])
        out[~pos] = em / (1.0 + em)
        return out
    if task == "poisson":
        return np.exp(margins).astype(np.float32)
    # squared / smoothed_hinge: identity link.
    return margins.astype(np.float32)


#: request priorities the admission controller understands; "low" work is
#: the first tier shed under load (serving/batcher.py).
PRIORITIES = ("low", "normal", "high")


@dataclasses.dataclass
class Row:
    """One parsed scoring request."""

    features: dict  # shard name -> np.float32 (D,) or None (all zeros)
    ids: dict  # entity-key name -> str entity id (or absent)
    offset: float = 0.0
    timeout_ms: Optional[float] = None
    priority: str = "normal"  # one of PRIORITIES
    #: tenant id for multi-tenant admission/routing (serving/tenancy.py);
    #: None rides the default tenant's partition and route.
    tenant: Optional[str] = None


class RequestParser:
    """Stateless request validation: shard dims + saved index maps — the
    ONLY runtime state request parsing reads, split out so the
    process-backed worker pool can parse in the parent (routing, probe
    rows) without holding a local :class:`ScoringRuntime`
    (serving/procpool.py).  ``ScoringRuntime.parse_request`` delegates
    here, so both serving modes validate identically."""

    def __init__(
        self, shard_dims: dict, index_maps: Optional[dict] = None
    ):
        self.shard_dims = dict(shard_dims)
        self.index_maps = index_maps or {}

    @classmethod
    def for_model(
        cls, model: GameModel, index_maps: Optional[dict] = None
    ) -> "RequestParser":
        """Shard dims straight off the model's coordinates — the same
        derivation ScoringRuntime.__init__ performs."""
        shard_dims: dict[str, int] = {}
        for sub in model.models.values():
            if isinstance(sub, FixedEffectModel):
                shard_dims[sub.feature_shard] = int(
                    sub.model.coefficients.means.shape[0]
                )
            elif isinstance(sub, RandomEffectModel):
                shard_dims[sub.feature_shard] = int(sub.n_features)
            else:
                raise TypeError(f"unsupported coordinate type: {type(sub)}")
        return cls(shard_dims, index_maps)

    def parse(self, obj: dict) -> "Row":
        """Validate one JSON-shaped request into a :class:`Row`.

        ``dense``: shard → full-width float list.  ``features``: shard →
        named entries (``{"name", "term", "value"}`` dicts or
        ``[name, term, value]`` triples) resolved through the saved index
        map — unseen features drop, exactly like batch scoring.
        """
        if not isinstance(obj, dict):
            raise ValueError("request must be a JSON object")
        features: dict = {}
        for shard, vec in (obj.get("dense") or {}).items():
            dim = self.shard_dims.get(shard)
            if dim is None:
                raise ValueError(f"unknown feature shard {shard!r}")
            arr = np.asarray(vec, np.float32)
            if arr.shape != (dim,):
                raise ValueError(
                    f"shard {shard!r} expects {dim} features, got "
                    f"{arr.shape}"
                )
            features[shard] = arr
        for shard, entries in (obj.get("features") or {}).items():
            dim = self.shard_dims.get(shard)
            if dim is None:
                raise ValueError(f"unknown feature shard {shard!r}")
            imap = self.index_maps.get(shard)
            if imap is None:
                raise ValueError(
                    f"shard {shard!r} has no saved index map; send "
                    "'dense' features"
                )
            from photon_ml_tpu_torch.data.index_map import feature_key

            arr = features.get(shard)
            if arr is None:
                arr = np.zeros(dim, np.float32)
            for e in entries:
                if isinstance(e, dict):
                    name, term, value = (
                        e.get("name"), e.get("term", ""), e.get("value"),
                    )
                else:
                    name, term, value = e
                idx = imap.get_index(feature_key(str(name), str(term or "")))
                if idx >= 0:
                    arr[idx] = np.float32(value)
            features[shard] = arr
        ids = {}
        for key, value in (obj.get("ids") or {}).items():
            if value is not None:
                ids[str(key)] = str(value)
        timeout = obj.get("timeout_ms")
        priority = obj.get("priority", "normal")
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}"
            )
        tenant = obj.get("tenant")
        if tenant is not None and not isinstance(tenant, str):
            raise ValueError(
                f"tenant must be a string, got {type(tenant).__name__}"
            )
        return Row(
            features=features,
            ids=ids,
            offset=float(obj.get("offset") or 0.0),
            timeout_ms=None if timeout is None else float(timeout),
            priority=priority,
            tenant=tenant,
        )

    def probe_row(self) -> "Row":
        """A minimal valid request (offset-only) — what health probes
        and swap verification score."""
        return self.parse({})


class _HotTable:
    """LRU hot set of dense per-entity coefficient rows, device-resident.

    Slot 0 is the reserved zero row (cold / unknown / padding); slots
    1..capacity hold entities in LRU order.  Eviction is O(1)
    (OrderedDict).  An insert stages its row on the host; :meth:`flush`
    writes the staged rows into the device table in place, one
    ``index_copy_`` over distinct slots (the last row staged for a slot
    wins, so a slot reused within one batch is written once, with the
    entity that holds it).  ``table`` is never reallocated: the runtime's
    launch blocks hold its address.
    """

    def __init__(self, capacity: int, dim: int, device: torch.device):
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.table = torch.zeros((self.capacity + 1, self.dim),
                                 dtype=torch.float32, device=device)
        self._pending: dict = {}
        self._slots: "collections.OrderedDict[object, int]" = (
            collections.OrderedDict()
        )
        self._free = list(range(self.capacity, 0, -1))
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    def lookup(self, key) -> int:
        """Hot slot for ``key`` (marks it most-recently-used), 0 if cold."""
        slot = self._slots.get(key)
        if slot is None:
            return 0
        self._slots.move_to_end(key)
        self.hits += 1
        return slot

    def insert(self, key, dense_row: np.ndarray) -> None:
        """Promote ``key``; evicts the least-recently-used entity when full."""
        if self.capacity == 0 or key in self._slots:
            return
        if self._free:
            slot = self._free.pop()
        else:
            _, slot = self._slots.popitem(last=False)
            self.evictions += 1
        self._pending[slot] = np.asarray(dense_row, np.float32)
        self._slots[key] = slot
        self.inserts += 1

    def flush(self) -> None:
        """Write the staged rows into the device table (in place, on the
        calling thread's current stream)."""
        if not self._pending:
            return
        slots = np.fromiter(self._pending, np.int64, len(self._pending))
        rows = np.stack(list(self._pending.values()))
        self._pending = {}
        dev = self.table.device
        self.table.index_copy_(
            0, torch.from_numpy(slots).to(dev),
            torch.from_numpy(rows).to(dev),
        )

    @property
    def size(self) -> int:
        return len(self._slots)

    def hot_keys(self) -> list:
        """LRU→MRU order (test/diagnostic view)."""
        return list(self._slots)


@dataclasses.dataclass
class _Staging:
    """One bucket's host buffers (packed request rows, ``(n_random, B)``
    slots, the ``(2, B)`` output), their numpy views, and the kernel's
    launch block over them."""

    tensors: tuple
    arrays: tuple
    block: kernels_lib.Coords


@dataclasses.dataclass
class _FixedCoord:
    name: str
    shard: str
    means: object  # torch float32 (D,) on the runtime's device
    host_means: object = None  # np.float32 (D,) — the degraded cold path


@dataclasses.dataclass
class _RandomCoord:
    name: str
    shard: str
    entity_key: str
    model: RandomEffectModel
    hot: _HotTable
    unknown: int = 0


class ScoringRuntime:
    """A loaded model, built and warmed for the online request path."""

    def __init__(
        self,
        model: GameModel,
        index_maps: Optional[dict] = None,
        config: Optional[RuntimeConfig] = None,
    ):
        self.config = config or RuntimeConfig()
        if self.config.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.device = resolve_device(self.config.device)
        # Version identity for the hot-swap machinery (serving/swap.py):
        # the initially-loaded model is version 1; every successful swap
        # stamps a strictly greater number.  ``ready`` is the READINESS
        # half of the health split (/readyz): False until the bucket
        # ladder is warm, so a load balancer never routes at a runtime
        # that would build its kernel on the request path.
        self.model_version = 1
        self.model_path: Optional[str] = None
        self.ready = False
        self.model = model
        self.index_maps = index_maps or {}
        self.task = model.task
        #: the canonical loss name (task aliases resolved): picks the
        #: kernel's mean link and the degraded path's.
        self._loss_name = losses_lib.get(model.task).name
        self.fixed: list[_FixedCoord] = []
        self.random: list[_RandomCoord] = []
        self.shard_dims: dict[str, int] = {}
        for name, sub in model.models.items():
            if isinstance(sub, FixedEffectModel):
                w = to_numpy(sub.model.coefficients.means).astype(
                    np.float32)
                self.fixed.append(_FixedCoord(
                    name, sub.feature_shard,
                    torch.from_numpy(w.copy()).to(self.device), w,
                ))
                self.shard_dims[sub.feature_shard] = w.shape[0]
            elif isinstance(sub, RandomEffectModel):
                self.random.append(_RandomCoord(
                    name, sub.feature_shard, sub.entity_key, sub,
                    _HotTable(self.config.hot_entities, sub.n_features,
                              self.device),
                ))
                self.shard_dims[sub.feature_shard] = sub.n_features
            else:
                raise TypeError(f"unsupported coordinate type: {type(sub)}")
        if not self.fixed and not self.random:
            raise ValueError("model has no coordinates to serve")
        if len(self.fixed) > kernels_lib.MAX_FIXED or \
                len(self.random) > kernels_lib.MAX_RANDOM:
            raise ValueError(
                f"the serving kernel takes at most {kernels_lib.MAX_FIXED} "
                f"fixed and {kernels_lib.MAX_RANDOM} random coordinates; "
                f"the model has {len(self.fixed)} and {len(self.random)}"
            )
        self._parser = RequestParser(self.shard_dims, self.index_maps)
        self.buckets = self._bucket_ladder(self.config.max_batch_size)
        self._link = kernels_lib.link_for_task(self._loss_name)
        #: packed-buffer width: offset column + fixed feature blocks +
        #: (features, cold) block pairs per random coordinate
        #: (kernels.build_fused_bucket_kernel's layout).
        self._packed_width = 1 + sum(
            int(c.host_means.shape[0]) for c in self.fixed
        ) + sum(2 * c.hot.dim for c in self.random)
        #: bucket → its :class:`_Staging` (reused batch after batch: each
        #: batch waits for its kernel before the next one fills them).
        self._staging: dict = {}
        #: buckets the kernel has run at (warm_up's bookkeeping).
        self._warm: set = set()
        self.batches = 0
        self.rows_scored = 0
        self.warmup_compiles = 0
        self._lock = threading.Lock()  # stats snapshot vs dispatch thread
        #: held across each score_rows call, from the kernel's launch to
        #: the batch's count: a reader that takes it sees the launch
        #: counts and the batch counts of the same finished batches.
        self.score_lock = threading.Lock()
        # Graceful degradation: a transient device failure flips scoring
        # onto the host cold path; the breaker guards re-promotion
        # (module docstring).
        self.degraded = False
        self.breaker = CircuitBreaker(
            cooldown_seconds=self.config.breaker_cooldown_s,
            failure_threshold=self.config.breaker_failure_threshold,
        )
        from photon_ml_tpu_torch.utils.watchdog import RetryPolicy

        self._fault_policy = RetryPolicy()  # classification only
        self.degraded_batches = 0
        self.device_failures = 0
        self.repromotions = 0
        # Device-memory accounting: the hot tables are the serving path's
        # device-resident working set — (capacity+1) x dim f32 per random
        # coordinate, allocated up front (LRU inserts overwrite rows,
        # they never grow the table).
        self.hot_table_bytes = sum(
            (c.hot.capacity + 1) * c.hot.dim * 4 for c in self.random
        )
        telemetry_mod.current().gauge(
            "hbm_serving_hot_table_bytes"
        ).set(self.hot_table_bytes)
        if self.config.warmup:
            self.warm_up()
        self.ready = True

    # -- construction ------------------------------------------------------
    @staticmethod
    def _bucket_ladder(max_batch: int) -> list[int]:
        ladder = []
        b = 1
        while b < max_batch:
            ladder.append(b)
            b *= 2
        ladder.append(max_batch)
        return ladder

    @classmethod
    def from_glm_model(
        cls,
        model: GeneralizedLinearModel,
        index_map=None,
        shard: str = "features",
        config: Optional[RuntimeConfig] = None,
    ) -> "ScoringRuntime":
        """Serve a plain GLM as a one-fixed-coordinate GAME model."""
        game = GameModel(
            models={"fixed": FixedEffectModel(model, shard)},
            task=model.task,
        )
        imaps = {shard: index_map} if index_map is not None else {}
        return cls(game, imaps, config)

    @staticmethod
    def load_model(path: str, device=None) -> tuple[GameModel, dict]:
        """Read a saved model off disk: a GAME model directory (either
        the directory holding ``metadata.json`` or a driver output dir
        with a ``models/`` subdir) or a GLM ``.avro`` file.  Returns
        ``(GameModel, index_maps)`` — fingerprint sidecars are verified
        by the stores (a tampered payload raises before anything is
        served).  Fixed-effect coefficients land on ``device`` (the card
        unless ``"cpu"``).  The hot-swap path loads ONCE through here."""
        if os.path.isdir(path):
            from photon_ml_tpu_torch.io.game_store import load_game_model

            if not os.path.exists(os.path.join(path, "metadata.json")):
                nested = os.path.join(path, "models")
                if os.path.exists(os.path.join(nested, "metadata.json")):
                    path = nested
            return load_game_model(path, device=device)
        from photon_ml_tpu_torch.io.model_store import load_glm_model

        glm, imap = load_glm_model(path, device=device)
        game = GameModel(
            models={"fixed": FixedEffectModel(glm, "features")},
            task=glm.task,
        )
        return game, {"features": imap}

    @classmethod
    def load(
        cls, path: str, config: Optional[RuntimeConfig] = None
    ) -> "ScoringRuntime":
        """Load a saved model (see :meth:`load_model`) into a runtime."""
        model, index_maps = cls.load_model(
            path, device=(config or RuntimeConfig()).device
        )
        runtime = cls(model, index_maps, config)
        runtime.model_path = path
        return runtime

    def _kernel_geometry(self) -> tuple:
        """Everything the warmed bucket ladder is shaped by: device, task
        (mean link), layout, bucket sizes, fixed dims, random (dim,
        capacity) pairs.  A runtime with equal geometry launches the same
        library at the same shapes, so what ``base`` warmed is warm for
        it too."""
        return (
            str(self.device),
            self._loss_name,
            bool(self.config.fused),
            tuple(self.buckets),
            tuple(int(c.host_means.shape[0]) for c in self.fixed),
            tuple((c.hot.dim, c.hot.capacity) for c in self.random),
        )

    @classmethod
    def patched(
        cls,
        base: "ScoringRuntime",
        model: GameModel,
        index_maps: Optional[dict] = None,
        config: Optional[RuntimeConfig] = None,
        carry_hot: bool = True,
    ) -> "ScoringRuntime":
        """Build a runtime around ``model`` by CLONING ``base``'s warmed
        identity — the delta-apply fast path (serving/swap.py
        ``swap_delta``).

        A value-only delta never changes kernel geometry (same task,
        dims, bucket ladder), so the new runtime adopts ``base``'s warm
        bucket set: no warm-up launches.  The LRU hot sets are then
        carried (:func:`carry_hot_sets`) — every row REBUILT from the
        patched model and written into the new device table by one
        ``index_copy_`` over distinct slots, never copied from the live
        table (the dispatch thread may be mutating it mid-clone).
        Geometry drift (a config change) falls back to a full warm-up;
        the result is correct either way."""
        cfg = config or base.config
        rt = cls(
            model,
            base.index_maps if index_maps is None else index_maps,
            dataclasses.replace(cfg, warmup=False),
        )
        # Restore the caller-visible config: warm-up was suppressed only
        # for THIS construction; a replica restarted from this config
        # must still warm its ladder.
        rt.config = cfg
        if rt._kernel_geometry() == base._kernel_geometry():
            rt._warm = set(base._warm)
            rt.warmup_compiles = 0
        elif cfg.warmup:
            rt.warm_up()
        if carry_hot:
            carry_hot_sets(base, rt)
        return rt

    # -- warmup ------------------------------------------------------------
    def warm_up(self) -> int:
        """Build the kernel library (on the card; a build failure raises
        here) and run the kernel once, on zero inputs, at every bucket
        that has not run yet, so the request path never builds anything.
        Returns (and stores in ``warmup_compiles``) the number of buckets
        this call warmed: every bucket the first time, 0 once all ran."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from photon_ml_tpu_torch.ops import _kernels

            _kernels.build_libraries("serve_margins")
        todo = [b for b in self.buckets if b not in self._warm]
        for bucket in todo:
            self._launch(bucket, np.zeros((bucket, self._packed_width),
                                          np.float32),
                         np.zeros((len(self.random), bucket), np.int32))
        self.warmup_compiles = len(todo)
        # The reference's compile-cache warm-up metrics, same names.
        tel = telemetry_mod.current()
        if tel.enabled:
            wall = time.perf_counter() - t0
            tel.counter("compile_cache_warmup_compiles").inc(len(todo))
            tel.gauge("compile_cache_warmup_seconds").set(round(wall, 4))
            tel.event("compile_cache.warmup", fns=len(self.buckets),
                      compiles=len(todo), exact=True, seconds=wall)
        return self.warmup_compiles

    # -- request parsing ---------------------------------------------------
    def parse_request(self, obj: dict) -> Row:
        """Validate one JSON-shaped request into a :class:`Row` — see
        :meth:`RequestParser.parse` (the shared implementation every
        serving mode uses)."""
        return self._parser.parse(obj)

    def probe_row(self) -> Row:
        """A minimal valid request (offset-only) — what health probes and
        swap verification score.  Scores 0 margin on any model; the point
        is exercising the whole dispatch → kernel → future path."""
        return self.parse_request({})

    # -- scoring -----------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"batch of {n} exceeds max_batch_size={self.buckets[-1]}"
        )

    def score_rows(self, rows: Sequence[Row]) -> tuple[np.ndarray, np.ndarray]:
        """Score a batch.

        Returns ``(margins, means)`` float32 arrays of ``len(rows)``.
        Dispatch-thread only (mutates the LRU hot sets and the breaker).

        The healthy path is the padded bucket kernel
        (:meth:`_score_rows_device`).  On a CPU runtime a transient
        failure (the watchdog's UNAVAILABLE/device-lost vocabulary)
        degrades THIS batch — and every batch until the breaker
        re-promotes — onto the pure-host cold path
        (:meth:`_score_rows_host`): requests keep succeeding, the
        ``degraded`` flag rides /healthz and /stats.  On the card every
        failure propagates (module docstring), as do non-transient ones
        on the CPU (a bad batch size, programming errors) — degrading on
        those would mask real faults.
        """
        with self.score_lock:
            if self.degraded and not self.breaker.allow_request():
                return self._score_rows_host(rows)
            try:
                margins, means = self._score_rows_device(rows)
            except Exception as exc:  # noqa: BLE001 — classified below
                if (self.device.type == "cuda"
                        or not self._fault_policy.classify(exc).transient):
                    raise
                self._note_device_failure(exc)
                return self._score_rows_host(rows)
            if self.degraded:
                self._note_repromotion()
            return margins, means

    def _note_device_failure(self, exc: BaseException) -> None:
        tel = telemetry_mod.current()
        self.breaker.record_failure()
        self.device_failures += 1
        tel.counter("serving_device_failures_total").inc()
        tel.gauge("serving_degraded").set(1)
        if not self.degraded:
            self.degraded = True
            tel.event(
                "serving.degraded",
                error=f"{type(exc).__name__}: {exc}"[:200],
                breaker=self.breaker.state,
            )

    def _note_repromotion(self) -> None:
        tel = telemetry_mod.current()
        self.breaker.record_success()
        self.degraded = False
        self.repromotions += 1
        tel.counter("serving_repromotions_total").inc()
        tel.gauge("serving_degraded").set(0)
        tel.event("serving.repromoted", breaker=self.breaker.state)

    def _score_rows_host(
        self, rows: Sequence[Row]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Degraded-mode scoring: pure numpy, zero device touches.

        Same margin arithmetic as the kernel (offset + Σ fixed x·w +
        Σ random-effect x·row) and the same mean link, evaluated with
        host numpy — scores agree with the device path to host float
        tolerance (the device kernel's reduce order differs in the last
        ulp; bit parity is the HEALTHY path's contract, availability is
        this one's).  The LRU hot sets are deliberately untouched: their
        device tables may be gone with the device."""
        tel = telemetry_mod.current()
        n = len(rows)
        margins = np.zeros(n, np.float32)
        for i, row in enumerate(rows):
            margins[i] = np.float32(row.offset)
        for c in self.fixed:
            for i, row in enumerate(rows):
                vec = row.features.get(c.shard)
                if vec is not None:
                    margins[i] += np.float32(np.dot(vec, c.host_means))
        for c in self.random:
            for i, row in enumerate(rows):
                key = row.ids.get(c.entity_key)
                if key is None:
                    continue
                entry = c.model.coefficients.get(key)
                if entry is None:
                    c.unknown += 1
                    tel.counter("serving_unknown_entities_total").inc()
                    continue
                vec = row.features.get(c.shard)
                if vec is None:
                    continue
                dense = kernels_lib.dense_coefficient_rows(c.model, [key])[0]
                margins[i] += np.float32(np.dot(vec, dense))
        means = _host_mean(self._loss_name, margins)
        with self._lock:
            self.batches += 1
            self.rows_scored += n
            self.degraded_batches += 1
        tel.counter("serving_batches_total").inc()
        tel.counter("serving_rows_scored_total").inc(n)
        tel.counter("serving_degraded_batches_total").inc()
        return margins, means

    def _staging_buffers(self, bucket: int) -> "_Staging":
        """The bucket's host buffers and launch block, allocated on first
        use: page-locked on the card, each checked once that the card can
        address it (a buffer it cannot raises: nothing falls back to a
        copy), plain on the CPU."""
        st = self._staging.get(bucket)
        if st is None:
            cuda = self.device.type == "cuda"
            tensors = tuple(
                torch.zeros(shape, dtype=dtype, pin_memory=cuda)
                for shape, dtype in (
                    ((bucket, self._packed_width), torch.float32),
                    ((len(self.random), bucket), torch.int32),
                    ((2, bucket), torch.float32)))
            operands = (*self._operands(*tensors[:2]), self._link,
                        tensors[2])
            if cuda:
                for name, t in zip(("packed", "slots", "out"), tensors):
                    kernels_lib.mapped_pointer(
                        t, f"the {name} staging buffer of bucket {bucket}",
                        self.device)
                block = kernels_lib.mapped_block(*operands, self.device)
            else:
                block = kernels_lib.launch_block(*operands)
            st = _Staging(tensors, tuple(t.numpy() for t in tensors), block)
            self._staging[bucket] = st
        return st

    def _operands(self, packed: torch.Tensor, slots: torch.Tensor) -> tuple:
        """``(offset, fixed, random)``: the kernel's operands as views of
        the packed and slot buffers, in the configured layout."""
        fixed_w = tuple(c.means for c in self.fixed)
        tables = tuple(c.hot.table for c in self.random)
        if self.config.fused:
            return kernels_lib.fused_operands(packed, slots, fixed_w,
                                              tables)
        fixed_x, re_x, re_cold = [], [], []
        off = 1
        for c in self.fixed:
            d = int(c.host_means.shape[0])
            fixed_x.append(packed[:, off:off + d])
            off += d
        for c in self.random:
            d = c.hot.dim
            re_x.append(packed[:, off:off + d])
            re_cold.append(packed[:, off + d:off + 2 * d])
            off += 2 * d
        return kernels_lib.composed_operands(
            packed[:, 0], tuple(fixed_x), fixed_w, tuple(re_x), tables,
            tuple(slots), tuple(re_cold))

    def _launch(self, bucket: int, packed: np.ndarray,
                slots: np.ndarray) -> np.ndarray:
        """Score one bucket's request-side arrays (copied into the
        bucket's staging buffers unless they are those buffers) and return
        the ``(2, bucket)`` margins and means.  On the card: one launch
        from the bucket's prebuilt block on this thread's current stream
        of the runtime's device, then a wait on that stream; the result is
        the page-locked output buffer itself.  On the CPU: the plain
        version."""
        st = self._staging_buffers(bucket)
        pk, sl, out = st.arrays
        if packed is not pk:
            pk[...] = packed
        if slots is not sl:
            sl[...] = slots
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            kernels_lib.launch(st.block, self.device, stream=stream)
            stream.synchronize()
            self._warm.add(bucket)
            return out
        res = kernels_lib.serve_margins(*self._operands(*st.tensors[:2]),
                                        self._link)
        self._warm.add(bucket)
        return res.numpy()

    def _score_rows_device(
        self, rows: Sequence[Row]
    ) -> tuple[np.ndarray, np.ndarray]:
        """The healthy path: the padded bucket kernel (bit-parity
        contract).  Dispatch-thread only (mutates the LRU hot sets).

        Both layouts gather into the bucket's packed staging buffer; the
        composed path then hands the kernel views of its per-coordinate
        columns (the reference uploads each one), so the two differ only
        in how the kernel's arguments are named."""
        # The device-lost seam: a scripted fault here exercises the whole
        # degrade → breaker → re-promote machinery of a CPU runtime (a
        # card runtime raises it, as it raises every device failure).
        chaos_mod.maybe_fail("serving.device", rows=len(rows))
        n = len(rows)
        bucket = self.bucket_for(n)
        tel = telemetry_mod.current()

        def fill_shard(dst: np.ndarray, shard: str) -> None:
            for i, row in enumerate(rows):
                vec = row.features.get(shard)
                if vec is not None:
                    dst[i] = vec

        def gather_random(c, slots: np.ndarray, cold: np.ndarray) -> None:
            """Hot-slot lookup + cold-tail host gather for one random
            coordinate, writing into views of the packed buffer."""
            pending: dict = {}
            hits_before = c.hot.hits
            for i, row in enumerate(rows):
                key = row.ids.get(c.entity_key)
                if key is None:
                    continue
                slot = c.hot.lookup(key)
                if slot:
                    slots[i] = slot
                    continue
                entry = c.model.coefficients.get(key)
                if entry is None:
                    c.unknown += 1
                    tel.counter("serving_unknown_entities_total").inc()
                    continue
                c.hot.misses += 1
                tel.counter("serving_cold_misses_total").inc()
                vec = pending.get(key)
                if vec is None:
                    vec = kernels_lib.dense_coefficient_rows(
                        c.model, [key]
                    )[0]
                    pending[key] = vec
                    promotions.append((c, key, vec))
                cold[i] = vec
            tel.counter("serving_hot_hits_total").inc(
                c.hot.hits - hits_before
            )

        promotions: list[tuple[_RandomCoord, object, np.ndarray]] = []
        packed, all_slots, _ = self._staging_buffers(bucket).arrays
        packed.fill(0.0)
        all_slots.fill(0)
        for i, row in enumerate(rows):
            packed[i, 0] = row.offset
        off = 1
        for c in self.fixed:
            d = int(c.host_means.shape[0])
            fill_shard(packed[:, off:off + d], c.shard)
            off += d
        for j, c in enumerate(self.random):
            d = c.hot.dim
            fill_shard(packed[:, off:off + d], c.shard)
            gather_random(c, all_slots[j], packed[:, off + d:off + 2 * d])
            off += 2 * d
        out = self._launch(bucket, packed, all_slots)
        margins = np.array(out[0, :n], np.float32)
        means = np.array(out[1, :n], np.float32)

        # Promote the cold tail AFTER this batch (the batch itself scored
        # through the cold path; the next request finds the entity hot).
        for c, key, vec in promotions:
            c.hot.insert(key, vec)
        for c in self.random:
            c.hot.flush()
        if promotions:
            tel.gauge("serving_hot_resident_rows").set(
                sum(c.hot.size for c in self.random)
            )
        with self._lock:
            self.batches += 1
            self.rows_scored += n
        tel.counter("serving_batches_total").inc()
        tel.counter("serving_rows_scored_total").inc(n)
        return margins, means

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """Mirrors the telemetry counters, independent of the hub state
        (the /stats endpoint must work with telemetry disabled)."""
        with self._lock:
            batches, rows = self.batches, self.rows_scored
            degraded_batches = self.degraded_batches
        hot = {}
        for c in self.random:
            total = c.hot.hits + c.hot.misses
            hot[c.name] = {
                "capacity": c.hot.capacity,
                "resident": c.hot.size,
                "hits": c.hot.hits,
                "misses": c.hot.misses,
                "hit_rate": (c.hot.hits / total) if total else None,
                "inserts": c.hot.inserts,
                "evictions": c.hot.evictions,
                "unknown_entities": c.unknown,
                "n_entities": c.model.n_entities,
            }
        return {
            "task": self.task,
            "model_version": self.model_version,
            "model_path": self.model_path,
            "ready": self.ready,
            "buckets": list(self.buckets),
            "coordinates": {
                "fixed": [c.name for c in self.fixed],
                "random": [c.name for c in self.random],
            },
            "batches": batches,
            "rows_scored": rows,
            "warmup_compiles": self.warmup_compiles,
            "hot_sets": hot,
            # Degraded-mode observability (docs/robustness.md): the flag
            # /healthz mirrors, the breaker state machine, and how much
            # traffic the host cold path carried.
            "degraded": self.degraded,
            "degraded_batches": degraded_batches,
            "device_failures": self.device_failures,
            "repromotions": self.repromotions,
            "breaker": self.breaker.snapshot(),
        }


def carry_hot_sets(
    old: ScoringRuntime, new: ScoringRuntime, retries: int = 3
) -> int:
    """Seed ``new``'s LRU hot sets from ``old``'s WITHOUT copying device
    rows.  Returns the number of rows carried.

    Only the KEY LISTS are snapshotted from the live runtime; every
    carried row is rebuilt dense from ``new``'s model and
    inserted in the old LRU→MRU order.  Copying ``old``'s device table
    instead would race the dispatch thread (an eviction between the
    slot snapshot and the table reference would map entity A to entity
    B's row) and would serve STALE rows for delta-changed entities.
    Rebuilt rows cost one host gather per coordinate — and the scoring
    contract (``table[slot] + cold`` keeps hot and cold bit-identical)
    means a raced, slightly-stale KEY list is harmless: it only changes
    which entities start hot, never any score bit.

    ``old``'s OrderedDict may be mutated mid-iteration by its dispatch
    thread (RuntimeError); the snapshot retries, then degrades to an
    empty carry — cold-starting the hot set is always correct."""
    carried = 0
    new_by_name = {c.name: c for c in new.random}
    for oc in old.random:
        nc = new_by_name.get(oc.name)
        if nc is None or nc.hot.capacity == 0:
            continue
        keys: list = []
        for _ in range(max(1, retries)):
            try:
                keys = oc.hot.hot_keys()
                break
            except RuntimeError:  # dict mutated mid-list(); retry
                keys = []
        keys = [k for k in keys if k in nc.model.coefficients]
        if not keys:
            continue
        rows = kernels_lib.dense_coefficient_rows(nc.model, keys)
        for key, row in zip(keys, rows):
            nc.hot.insert(key, row)
        nc.hot.flush()
        carried += len(keys)
    if carried:
        telemetry_mod.current().gauge("serving_hot_resident_rows").set(
            sum(c.hot.size for c in new.random)
        )
    return carried
