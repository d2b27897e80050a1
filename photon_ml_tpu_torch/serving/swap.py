"""Zero-downtime model hot-swap with verified rollback (port of
``photon_ml_tpu/serving/swap.py``).

:class:`HotSwapper` rolls a serving unit — one ``MicroBatcher`` or every
healthy replica under a :class:`~photon_ml_tpu_torch.serving.supervisor.
ReplicaSupervisor` — onto a new model directory without dropping a
request:

1. **Load** the new model ONCE off the request path, through the PR-3
   fingerprint sidecars (``io/model_store.py`` / ``io/game_store.py``) —
   a tampered payload or ``.meta.json`` raises here, before anything is
   built, and the old version keeps serving.
2. **Prepare**: build one fresh ``ScoringRuntime`` per target from the
   shared host-side model (per-replica LRU hot sets start cold), warm
   the bucket-ladder kernels, and score a verification probe directly on
   each new runtime (finite scores or abort).
3. **Commit**: assign ``batcher.runtime = new_runtime`` on every target.
   The dispatch loop reads the attribute once per batch, so the
   assignment is the atomic cutover — in-flight batches finish on the
   old runtime, the next batch scores on the new one.  No request ever
   observes a half-swapped runtime.
4. **Verify**: score a probe THROUGH each target's real dispatch path.
   A failed probe (or a scripted ``serving.swap`` fault) restores the
   previous runtimes — one-step rollback, counted on
   ``serving_rollbacks_total``.

The previous version is retained after a successful swap for one-step
manual :meth:`rollback` (``POST /reload {"rollback": true}``).

**Pinned decision** — a swap requested while any target runtime is
``degraded=True`` (PR-6 host path) is **deferred**: the result reports
``"deferred"``, nothing changes, and ``serving_swaps_deferred_total``
counts it.  Degraded means the device path is suspect; committing a new
runtime whose hot tables live on that same device would "verify" through
the host fallback and mask a broken swap.  Recover the device first (the
breaker re-promotes) or restart the replica, then reload.

Versions are monotone integers stamped on each runtime
(``model_version``; the initial load is version 1) and surfaced on the
``serving_model_version`` gauge, ``/healthz``, and ``/stats``.

Chaos: the ``serving.swap`` site is touched at stages ``load`` /
``prepare`` / ``verify`` (occurrences 0/1/2 per swap attempt), so a
FaultPlan can script both the abort path (pre-commit) and the rollback
path (post-commit) — see docs/robustness.md.

**Process mode** (targets are :class:`~photon_ml_tpu_torch.serving.procpool.
ProcessReplica` stubs): the same four stages run over the worker swap
protocol.  Load publishes the new model ONCE into shared memory as a
staged pool generation; prepare asks each worker to attach + warm +
probe it off its request path (``swap_prepare``); commit is each
worker's own GIL-atomic ``batcher.runtime`` assignment
(``swap_commit``); verify scores through each worker's real dispatch
path from the parent.  Failure anywhere unwinds: staged attachments are
aborted, committed workers ``swap_rollback``, and the staged segments
are unlinked.  Success promotes the generation
(``pool.commit_generation`` — the last TWO generations stay linked, so
a worker respawned mid-window can still attach) and manual rollback
walks workers back one step and restores the prior generation.  A
worker RESTARTED after the commit attached the new generation directly
and holds no worker-side previous; rollback detects that (the worker
answers ``rolled_back: false``) and kills it, so it respawns on the
restored generation — convergence costs one restart, never a wrong
version left serving.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.tenancy import tenant_slug


class SwapInProgressError(RuntimeError):
    """A second /reload arrived while a swap was still running.  Swaps
    are serialized — concurrent swaps would race the commit point and
    leave targets on mixed versions."""


@dataclasses.dataclass
class SwapResult:
    """Outcome of one swap attempt (the /reload response body)."""

    status: str  # "swapped" | "rolled_back" | "deferred"
    version_before: int
    version_after: int
    model_path: Optional[str]
    #: how far the attempt got: "load" | "prepare" | "verify" | "commit"
    stage: str = "commit"
    reason: Optional[str] = None
    targets: int = 0
    #: set on tenant-scoped swaps/rollbacks: only this tenant's route
    #: moved; the default route and every other tenant are untouched.
    tenant: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class HotSwapper:
    """Owns model-version state and the swap/rollback state machine for
    one serving unit.

    ``targets_fn`` returns the live ``MicroBatcher`` list to roll (the
    service supplies it: one batcher standalone, the healthy replicas'
    batchers under a supervisor).  ``on_commit`` (optional) is called
    after every successful swap OR rollback with the now-serving
    ``(model, index_maps, config, version, path)`` — the supervisor uses
    it to rebuild its replica factory so restarts come back on the
    serving version.
    """

    def __init__(
        self,
        targets_fn: Callable[[], Sequence],
        on_commit: Optional[Callable] = None,
        on_kill: Optional[Callable] = None,
        on_tenant_commit: Optional[Callable] = None,
        probe_timeout_s: float = 30.0,
    ):
        self._targets_fn = targets_fn
        self._on_commit = on_commit
        #: tenant-route durability hook: called after every successful
        #: TENANT swap or rollback with ``(tenant, model, index_maps,
        #: config, version, path)`` — all-None payload means the tenant
        #: fell back onto the default route.  The supervisor uses it to
        #: re-apply tenant routes on replicas it restarts (thread mode;
        #: in pool mode the pool's tenant-generation registry replays
        #: routes into respawned workers instead).
        self._on_tenant_commit = on_tenant_commit
        #: convergence-kill hook: called with (target, reason) when the
        #: rollback must kill a worker that holds no retained previous.
        #: A supervisor-backed service routes this through kill_replica
        #: so the mark-down is SYNCHRONOUS with the rollback — healthz
        #: never reports the converge-killed worker healthy, and a
        #: caller that awaits health after rollback() waits for the
        #: respawn instead of racing stale state.
        self._on_kill = on_kill
        self.probe_timeout_s = probe_timeout_s
        self._swap_lock = sanitizers.tracked(
            threading.Lock(), "serving.swap"
        )
        #: readiness hook: True between /reload accept and commit+verify.
        self.in_progress = False
        self.version = 1
        #: high-water mark: version numbers are NEVER reused, so the
        #: sequence of committed swaps is strictly monotone even across
        #: a manual rollback (rollback lowers ``version``, not this).
        self._max_version = 1
        self.model_path: Optional[str] = None
        #: (target, previous_runtime) pairs retained for one-step rollback.
        self._previous: list[tuple] = []
        #: process-mode rollback token: (pool, version_before) after a
        #: successful remote swap (the runtimes to restore live in the
        #: workers and the pool's generation list, not here).
        self._remote_previous: Optional[tuple] = None
        #: tenant → (version, model_path) for every committed
        #: tenant-scoped route.  Tenants absent here follow the default
        #: route (``self.version``).  Versions come from the SAME
        #: monotone ``_max_version`` sequence as full swaps.
        self._tenant_versions: dict = {}
        #: one-step tenant rollback token, set by the last successful
        #: tenant swap: ("thread", tenant, [(target, old_route)], prev)
        #: or ("process", tenant, pool, prev) where prev is the
        #: registry entry the swap displaced (None = default route).
        self._tenant_previous: Optional[tuple] = None
        self.swaps = 0
        self.rollbacks = 0
        self.deferred = 0

    # -- observability -------------------------------------------------------
    def adopt_version(self, runtime) -> None:
        """Sync the swapper's version identity from an already-serving
        runtime (called by the service at construction)."""
        self.version = getattr(runtime, "model_version", 1)
        self._max_version = max(self._max_version, self.version)
        self.model_path = getattr(runtime, "model_path", None)
        telemetry_mod.current().gauge("serving_model_version").set(
            self.version
        )

    def tenant_versions(self) -> dict:
        """tenant → (version, model_path) for every committed
        tenant-scoped route (snapshot copy)."""
        return dict(self._tenant_versions)

    def stats(self) -> dict:
        return {
            "model_version": self.version,
            "model_path": self.model_path,
            "in_progress": self.in_progress,
            "swaps": self.swaps,
            "rollbacks": self.rollbacks,
            "deferred": self.deferred,
            "can_rollback": bool(self._previous)
            or self._remote_previous is not None,
            "tenant_versions": {
                t: {"version": v, "model_path": p}
                for t, (v, p) in self._tenant_versions.items()
            },
        }

    # -- the swap state machine ----------------------------------------------
    def swap(
        self,
        model_path: str,
        runtime_config: Optional[RuntimeConfig] = None,
        tenant: Optional[str] = None,
    ) -> SwapResult:
        """Roll every live target onto the model at ``model_path``.

        With ``tenant`` set, only that tenant's ROUTE moves: every
        target keeps its default runtime, and rows carrying the tenant
        id score against the new version (serving/tenancy.py).  The
        default route and every other tenant are bitwise untouched.

        Never raises for a failed swap — the failure IS the result
        (status ``"rolled_back"`` with the stage and reason), because
        the old version is still serving and the caller needs to report
        that, not crash.  Only :class:`SwapInProgressError` (concurrent
        /reload) propagates.
        """
        if not self._swap_lock.acquire(blocking=False):
            raise SwapInProgressError(
                "a model swap is already in progress; retry after it "
                "completes"
            )
        try:
            self.in_progress = True
            if tenant is not None:
                return self._swap_tenant_locked(
                    tenant, model_path, runtime_config
                )
            return self._swap_locked(model_path, runtime_config)
        finally:
            self.in_progress = False
            self._swap_lock.release()

    def _swap_locked(
        self, model_path: str, runtime_config: Optional[RuntimeConfig]
    ) -> SwapResult:
        tel = telemetry_mod.current()
        version_before = self.version
        new_version = self._max_version + 1
        targets = list(self._targets_fn())
        if not targets:
            return self._rolled_back(
                version_before, model_path, "load",
                "no live targets to swap", 0,
            )
        if any(
            getattr(t.runtime, "degraded", False) for t in targets
        ):
            # Pinned: defer, never swap through a degraded device
            # (module docstring).
            self.deferred += 1
            tel.counter("serving_swaps_deferred_total").inc()
            tel.event(
                "serving.swap_deferred",
                model_path=model_path,
                version=version_before,
            )
            return SwapResult(
                status="deferred",
                version_before=version_before,
                version_after=version_before,
                model_path=model_path,
                stage="load",
                reason="a target runtime is degraded; recover or "
                "restart it before swapping",
                targets=len(targets),
            )

        if hasattr(targets[0], "swap_prepare"):
            # Process mode: the targets are worker stubs; roll them via
            # the cross-process swap protocol and the pool's
            # shared-memory generations.
            return self._swap_remote(
                targets, model_path, runtime_config,
                version_before, new_version,
            )

        # Stage 1+2: load + prepare, entirely off the request path — the
        # old runtimes keep serving while this thread builds and warms.
        stage = "load"
        try:
            chaos_mod.maybe_fail(
                "serving.swap", stage="load", path=model_path
            )
            model, index_maps = ScoringRuntime.load_model(
                model_path, device=(
                    runtime_config or targets[0].runtime.config
                ).device,
            )
            stage = "prepare"
            fresh = []
            for t in targets:
                cfg = runtime_config or t.runtime.config
                rt = ScoringRuntime(model, index_maps, cfg)
                rt.model_version = new_version
                rt.model_path = model_path
                margins, means = rt.score_rows([rt.probe_row()])
                if not (
                    np.isfinite(margins).all() and np.isfinite(means).all()
                ):
                    raise ValueError(
                        "pre-commit verification probe returned "
                        "non-finite scores"
                    )
                fresh.append(rt)
            chaos_mod.maybe_fail("serving.swap", stage="prepare")
        except Exception as exc:  # noqa: BLE001 — abort, old version serves
            return self._rolled_back(
                version_before, model_path, stage,
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
            )

        # Stage 3: atomic commit (attribute assignment per target).
        previous = [(t, t.runtime) for t in targets]
        for t, rt in zip(targets, fresh):
            t.runtime = rt

        # Stage 4: verify through the real dispatch path; any failure
        # restores the previous runtimes.
        try:
            chaos_mod.maybe_fail("serving.swap", stage="verify")
            for t, rt in zip(targets, fresh):
                fut = t.submit(rt.probe_row(), bypass_admission=True)
                result = fut.result(timeout=self.probe_timeout_s)
                if not np.isfinite(result["score"]):
                    raise ValueError(
                        "post-swap probe returned a non-finite score"
                    )
        except Exception as exc:  # noqa: BLE001 — roll back, then report
            for t, old in previous:
                t.runtime = old
            return self._rolled_back(
                version_before, model_path, "verify",
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
            )

        self.version = new_version
        self._max_version = new_version
        self.model_path = model_path
        self._previous = previous
        self._remote_previous = None
        self.swaps += 1
        tel.counter("serving_swaps_total").inc()
        tel.gauge("serving_model_version").set(new_version)
        tel.event(
            "serving.swap",
            version_before=version_before,
            version_after=new_version,
            model_path=model_path,
            targets=len(targets),
        )
        if self._on_commit is not None:
            sample = fresh[0]
            self._on_commit(
                model, index_maps, sample.config, new_version, model_path
            )
        return SwapResult(
            status="swapped",
            version_before=version_before,
            version_after=new_version,
            model_path=model_path,
            targets=len(targets),
        )

    def _swap_remote(
        self,
        targets: list,
        model_path: str,
        runtime_config: Optional[RuntimeConfig],
        version_before: int,
        new_version: int,
        site: str = "serving.swap",
        preloaded: Optional[tuple] = None,
        carry_hot: bool = False,
        on_success: Optional[Callable] = None,
    ) -> SwapResult:
        """The four swap stages over the worker protocol.  Same chaos
        occurrences (load=0, prepare=1, verify=2) so every scripted
        FaultPlan written against in-process swaps scripts this path
        identically.

        The delta path (:meth:`swap_delta`) rides this same machinery
        with ``site="publish.apply"``, a ``preloaded`` (model,
        index_maps) it already patched parent-side (its "load" stage —
        chaos occurrence 0 — already fired there), and
        ``carry_hot=True`` so each worker clones its warmed buckets
        and hot sets instead of rebuilding cold."""
        tel = telemetry_mod.current()
        pool = targets[0].pool
        generation = None
        prepared: list = []
        stage = "load"
        try:
            if preloaded is not None:
                model, index_maps = preloaded
            else:
                chaos_mod.maybe_fail(site, stage="load", path=model_path)
                model, index_maps = ScoringRuntime.load_model(
                    model_path, device="cpu",
                )
            # ONE shared-memory publication for the whole pool; workers
            # attach it zero-copy during prepare.
            generation = pool.publish(
                model, index_maps, version=new_version, path=model_path
            )
            stage = "prepare"
            for t in targets:
                t.swap_prepare(
                    generation.manifest, runtime_config,
                    carry_hot=carry_hot,
                )
                prepared.append(t)
            chaos_mod.maybe_fail(site, stage="prepare")
        except Exception as exc:  # noqa: BLE001 — abort, old version serves
            for t in prepared:
                t.swap_abort(new_version)
            if generation is not None:
                pool.retire_generation(generation)
            return self._rolled_back(
                version_before, model_path, stage,
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
            )

        committed: list = []
        try:
            for t in targets:
                t.swap_commit(new_version)
                committed.append(t)
            chaos_mod.maybe_fail(site, stage="verify")
            for t in targets:
                fut = t.submit(
                    generation.parser.probe_row(), bypass_admission=True
                )
                result = fut.result(timeout=self.probe_timeout_s)
                if not np.isfinite(result["score"]):
                    raise ValueError(
                        "post-swap probe returned a non-finite score"
                    )
        except Exception as exc:  # noqa: BLE001 — roll back, then report
            for t in committed:
                try:
                    t.swap_rollback()
                except Exception:  # noqa: BLE001 — dead worker respawns
                    pass           # on the still-current old generation
            for t in targets:
                if t not in committed:
                    t.swap_abort(new_version)
            pool.retire_generation(generation)
            return self._rolled_back(
                version_before, model_path, "verify",
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
            )

        # Promote: new generation becomes what restarts attach; the old
        # one stays linked as the rollback window.
        pool.commit_generation(generation)
        self.version = new_version
        self._max_version = new_version
        self.model_path = model_path
        self._previous = []
        self._remote_previous = (pool, version_before)
        self.swaps += 1
        tel.counter("serving_swaps_total").inc()
        tel.gauge("serving_model_version").set(new_version)
        tel.event(
            "serving.swap",
            version_before=version_before,
            version_after=new_version,
            model_path=model_path,
            targets=len(targets),
            mode="process" if preloaded is None else "process-delta",
        )
        if on_success is not None:
            on_success()
        if self._on_commit is not None:
            self._on_commit(
                model, index_maps,
                runtime_config or pool.runtime_config,
                new_version, model_path,
            )
        return SwapResult(
            status="swapped",
            version_before=version_before,
            version_after=new_version,
            model_path=model_path,
            targets=len(targets),
        )

    # -- tenant-scoped swaps (serving/tenancy.py) ----------------------------
    def _tenant_version_before(self, tenant: str) -> int:
        entry = self._tenant_versions.get(tenant)
        return entry[0] if entry is not None else self.version

    def _swap_tenant_locked(
        self,
        tenant: str,
        model_path: str,
        runtime_config: Optional[RuntimeConfig],
    ) -> SwapResult:
        """Roll ONE tenant's route onto a new model version.

        Same four stages and chaos occurrences as a full swap
        (``serving.swap`` load=0 / prepare=1 / verify=2), but commit is
        ``set_tenant_route`` per target instead of the ``runtime``
        assignment — the default route keeps serving everyone else
        untouched, and ``self.version`` does not move (only
        ``_max_version``, keeping the version sequence monotone)."""
        tel = telemetry_mod.current()
        version_before = self._tenant_version_before(tenant)
        new_version = self._max_version + 1
        targets = list(self._targets_fn())
        if not targets:
            return self._rolled_back(
                version_before, model_path, "load",
                "no live targets to swap", 0, tenant=tenant,
            )
        if any(getattr(t.runtime, "degraded", False) for t in targets):
            self.deferred += 1
            tel.counter("serving_swaps_deferred_total").inc()
            tel.event(
                "serving.swap_deferred",
                model_path=model_path,
                version=version_before,
                tenant=tenant,
            )
            return SwapResult(
                status="deferred",
                version_before=version_before,
                version_after=version_before,
                model_path=model_path,
                stage="load",
                reason="a target runtime is degraded; recover or "
                "restart it before swapping",
                targets=len(targets),
                tenant=tenant,
            )

        if hasattr(targets[0], "swap_prepare"):
            return self._swap_tenant_remote(
                tenant, targets, model_path, runtime_config,
                version_before, new_version,
            )

        stage = "load"
        try:
            chaos_mod.maybe_fail(
                "serving.swap", stage="load", path=model_path
            )
            model, index_maps = ScoringRuntime.load_model(
                model_path, device=(
                    runtime_config or targets[0].runtime.config
                ).device,
            )
            stage = "prepare"
            fresh = []
            for t in targets:
                cfg = runtime_config or t.runtime.config
                rt = ScoringRuntime(model, index_maps, cfg)
                rt.model_version = new_version
                rt.model_path = model_path
                margins, means = rt.score_rows([rt.probe_row()])
                if not (
                    np.isfinite(margins).all() and np.isfinite(means).all()
                ):
                    raise ValueError(
                        "pre-commit verification probe returned "
                        "non-finite scores"
                    )
                fresh.append(rt)
            chaos_mod.maybe_fail("serving.swap", stage="prepare")
        except Exception as exc:  # noqa: BLE001 — abort, old route serves
            return self._rolled_back(
                version_before, model_path, stage,
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
                tenant=tenant,
            )

        # Commit: route the tenant, keep the default runtime in place.
        previous_routes = [(t, t.tenant_route(tenant)) for t in targets]
        for t, rt in zip(targets, fresh):
            t.set_tenant_route(tenant, rt)

        # Verify THROUGH the dispatch path: a probe row carrying the
        # tenant id must come back finite from the new route.
        try:
            chaos_mod.maybe_fail("serving.swap", stage="verify")
            for t, rt in zip(targets, fresh):
                probe = rt.probe_row()
                probe.tenant = tenant
                fut = t.submit(probe, bypass_admission=True)
                result = fut.result(timeout=self.probe_timeout_s)
                if not np.isfinite(result["score"]):
                    raise ValueError(
                        "post-swap probe returned a non-finite score"
                    )
        except Exception as exc:  # noqa: BLE001 — roll back, then report
            for t, old in previous_routes:
                if old is None:
                    t.clear_tenant_route(tenant)
                else:
                    t.set_tenant_route(tenant, old)
            return self._rolled_back(
                version_before, model_path, "verify",
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
                tenant=tenant,
            )

        prev_entry = self._tenant_versions.get(tenant)
        self._tenant_versions[tenant] = (new_version, model_path)
        self._max_version = new_version
        self._tenant_previous = (
            "thread", tenant, previous_routes, prev_entry
        )
        self.swaps += 1
        tel.counter("serving_swaps_total").inc()
        tel.gauge(
            f"serving_tenant_{tenant_slug(tenant)}_model_version"
        ).set(new_version)
        tel.event(
            "serving.swap",
            version_before=version_before,
            version_after=new_version,
            model_path=model_path,
            targets=len(targets),
            tenant=tenant,
        )
        if self._on_tenant_commit is not None:
            sample = fresh[0]
            self._on_tenant_commit(
                tenant, model, index_maps, sample.config,
                new_version, model_path,
            )
        return SwapResult(
            status="swapped",
            version_before=version_before,
            version_after=new_version,
            model_path=model_path,
            targets=len(targets),
            tenant=tenant,
        )

    def _swap_tenant_remote(
        self,
        tenant: str,
        targets: list,
        model_path: str,
        runtime_config: Optional[RuntimeConfig],
        version_before: int,
        new_version: int,
    ) -> SwapResult:
        """Tenant swap over the worker protocol: one shared-memory
        publication, per-worker prepare, then a tenant-tagged
        ``swap_commit`` — each worker routes the tenant onto the
        attached runtime without touching its default.  Success records
        the generation in the pool's TENANT registry (never the default
        generation window), so respawned workers replay the route."""
        tel = telemetry_mod.current()
        pool = targets[0].pool
        generation = None
        prepared: list = []
        stage = "load"
        try:
            chaos_mod.maybe_fail(
                "serving.swap", stage="load", path=model_path
            )
            model, index_maps = ScoringRuntime.load_model(
                model_path, device="cpu",
            )
            generation = pool.publish(
                model, index_maps, version=new_version, path=model_path
            )
            generation.runtime_config = runtime_config
            stage = "prepare"
            for t in targets:
                t.swap_prepare(generation.manifest, runtime_config)
                prepared.append(t)
            chaos_mod.maybe_fail("serving.swap", stage="prepare")
        except Exception as exc:  # noqa: BLE001 — abort, old route serves
            for t in prepared:
                t.swap_abort(new_version)
            if generation is not None:
                pool.retire_generation(generation)
            return self._rolled_back(
                version_before, model_path, stage,
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
                tenant=tenant,
            )

        committed: list = []
        try:
            for t in targets:
                t.swap_commit(new_version, tenant=tenant)
                committed.append(t)
            chaos_mod.maybe_fail("serving.swap", stage="verify")
            for t in targets:
                probe = generation.parser.probe_row()
                probe.tenant = tenant
                fut = t.submit(probe, bypass_admission=True)
                result = fut.result(timeout=self.probe_timeout_s)
                if not np.isfinite(result["score"]):
                    raise ValueError(
                        "post-swap probe returned a non-finite score"
                    )
        except Exception as exc:  # noqa: BLE001 — roll back, then report
            for t in committed:
                try:
                    t.swap_rollback(tenant=tenant)
                except Exception:  # noqa: BLE001 — dead worker respawns
                    pass           # without the uncommitted route
            for t in targets:
                if t not in committed:
                    t.swap_abort(new_version)
            pool.retire_generation(generation)
            return self._rolled_back(
                version_before, model_path, "verify",
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
                tenant=tenant,
            )

        pool.commit_tenant_generation(tenant, generation)
        prev_entry = self._tenant_versions.get(tenant)
        self._tenant_versions[tenant] = (new_version, model_path)
        self._max_version = new_version
        self._tenant_previous = ("process", tenant, pool, prev_entry)
        self.swaps += 1
        tel.counter("serving_swaps_total").inc()
        tel.gauge(
            f"serving_tenant_{tenant_slug(tenant)}_model_version"
        ).set(new_version)
        tel.event(
            "serving.swap",
            version_before=version_before,
            version_after=new_version,
            model_path=model_path,
            targets=len(targets),
            tenant=tenant,
            mode="process",
        )
        if self._on_tenant_commit is not None:
            self._on_tenant_commit(
                tenant, model, index_maps,
                runtime_config or pool.runtime_config,
                new_version, model_path,
            )
        return SwapResult(
            status="swapped",
            version_before=version_before,
            version_after=new_version,
            model_path=model_path,
            targets=len(targets),
            tenant=tenant,
        )

    # -- the delta path ------------------------------------------------------
    def swap_delta(
        self,
        delta_path: str,
        runtime_config: Optional[RuntimeConfig] = None,
    ) -> SwapResult:
        """Roll every live target onto ``delta_path`` — a delta artifact
        (``freshness/delta.py``), not a model directory — by patching
        only the changed rows of the currently-serving model.

        Same contract and state machine as :meth:`swap`: serialized,
        versioned on the same monotone registry (so one-step
        :meth:`rollback` after a delta apply restores the pre-delta
        version exactly like after a full swap), deferred while any
        target is degraded, and never raises for a failed apply — a
        torn/tampered artifact or a base-mismatch refusal comes back as
        status ``"rolled_back"`` with the pointed reason, the old
        version still serving.  Chaos site ``publish.apply`` fires at
        stages ``load``/``prepare``/``verify`` (occurrences 0/1/2),
        mirroring ``serving.swap``.

        In-process targets are cloned via
        :meth:`ScoringRuntime.patched` — shared warmed buckets, hot
        sets carried and rebuilt from the patched model — so the apply
        wall is row-patching, not a cold rebuild.  Process workers ride
        the same swap protocol with a ``carry_hot`` prepare: the parent
        patches its host-side copy, publishes ONE new shared-memory
        generation, and each worker clones its own runtime around the
        attached tables."""
        if not self._swap_lock.acquire(blocking=False):
            raise SwapInProgressError(
                "a model swap is already in progress; retry after it "
                "completes"
            )
        try:
            self.in_progress = True
            return self._swap_delta_locked(delta_path, runtime_config)
        finally:
            self.in_progress = False
            self._swap_lock.release()

    def _swap_delta_locked(
        self, delta_path: str, runtime_config: Optional[RuntimeConfig]
    ) -> SwapResult:
        # Runtime import: freshness imports serving for its applier, so
        # a module-level import here would be circular.
        from photon_ml_tpu_torch.freshness.delta import apply_delta, read_delta

        tel = telemetry_mod.current()
        version_before = self.version
        new_version = self._max_version + 1
        targets = list(self._targets_fn())
        if not targets:
            return self._rolled_back(
                version_before, delta_path, "load",
                "no live targets to apply the delta to", 0,
            )
        if any(getattr(t.runtime, "degraded", False) for t in targets):
            self.deferred += 1
            tel.counter("serving_swaps_deferred_total").inc()
            tel.event(
                "serving.swap_deferred",
                model_path=delta_path,
                version=version_before,
                mode="delta",
            )
            return SwapResult(
                status="deferred",
                version_before=version_before,
                version_after=version_before,
                model_path=delta_path,
                stage="load",
                reason="a target runtime is degraded; recover or "
                "restart it before applying a delta",
                targets=len(targets),
            )

        if hasattr(targets[0], "swap_prepare"):
            # Process mode: patch the parent's host-side copy of the
            # serving model, then roll the patched model through the
            # shared swap protocol as a new shm generation.
            stage = "load"
            try:
                chaos_mod.maybe_fail(
                    "publish.apply", stage="load", path=delta_path
                )
                pool = targets[0].pool
                base_model, index_maps = pool.current_model()
                delta = read_delta(delta_path)
                model = apply_delta(base_model, delta)
            except Exception as exc:  # noqa: BLE001 — refuse, old serves
                return self._rolled_back(
                    version_before, delta_path, stage,
                    f"{type(exc).__name__}: {exc}"[:300], len(targets),
                )
            return self._swap_remote(
                targets, delta_path, runtime_config,
                version_before, new_version,
                site="publish.apply",
                preloaded=(model, index_maps),
                carry_hot=True,
                on_success=lambda: self._record_freshness(
                    delta, new_version, len(targets)
                ),
            )

        stage = "load"
        try:
            chaos_mod.maybe_fail(
                "publish.apply", stage="load", path=delta_path
            )
            delta = read_delta(delta_path)
            # Replicas restarted through a factory hold DISTINCT (but
            # bitwise-equal) model objects; patch once per distinct base
            # and let apply_delta's whole-base checksum verification
            # refuse any target that ACTUALLY diverged — that comes back
            # as a rolled_back with the pointed base-mismatch reason.
            patched_by_base: dict = {}
            for t in targets:
                key = id(t.runtime.model)
                if key not in patched_by_base:
                    patched_by_base[key] = apply_delta(
                        t.runtime.model, delta
                    )
            model = patched_by_base[id(targets[0].runtime.model)]
            index_maps = targets[0].runtime.index_maps
            stage = "prepare"
            fresh = []
            for t in targets:
                cfg = runtime_config or t.runtime.config
                rt = ScoringRuntime.patched(
                    t.runtime,
                    patched_by_base[id(t.runtime.model)],
                    t.runtime.index_maps,
                    cfg,
                )
                rt.model_version = new_version
                rt.model_path = delta_path
                margins, means = rt.score_rows([rt.probe_row()])
                if not (
                    np.isfinite(margins).all() and np.isfinite(means).all()
                ):
                    raise ValueError(
                        "pre-commit verification probe returned "
                        "non-finite scores"
                    )
                fresh.append(rt)
            chaos_mod.maybe_fail("publish.apply", stage="prepare")
        except Exception as exc:  # noqa: BLE001 — refuse, old serves
            return self._rolled_back(
                version_before, delta_path, stage,
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
            )

        # Atomic commit + through-the-dispatch-path verify: identical
        # discipline to the full swap.
        previous = [(t, t.runtime) for t in targets]
        for t, rt in zip(targets, fresh):
            t.runtime = rt
        try:
            chaos_mod.maybe_fail("publish.apply", stage="verify")
            for t, rt in zip(targets, fresh):
                fut = t.submit(rt.probe_row(), bypass_admission=True)
                result = fut.result(timeout=self.probe_timeout_s)
                if not np.isfinite(result["score"]):
                    raise ValueError(
                        "post-apply probe returned a non-finite score"
                    )
        except Exception as exc:  # noqa: BLE001 — roll back, then report
            for t, old in previous:
                t.runtime = old
            return self._rolled_back(
                version_before, delta_path, "verify",
                f"{type(exc).__name__}: {exc}"[:300], len(targets),
            )

        self.version = new_version
        self._max_version = new_version
        self.model_path = delta_path
        self._previous = previous
        self._remote_previous = None
        self.swaps += 1
        tel.counter("serving_swaps_total").inc()
        tel.gauge("serving_model_version").set(new_version)
        tel.event(
            "serving.swap",
            version_before=version_before,
            version_after=new_version,
            model_path=delta_path,
            targets=len(targets),
            mode="delta",
        )
        self._record_freshness(delta, new_version, len(targets))
        if self._on_commit is not None:
            sample = fresh[0]
            self._on_commit(
                model, index_maps, sample.config, new_version, delta_path
            )
        return SwapResult(
            status="swapped",
            version_before=version_before,
            version_after=new_version,
            model_path=delta_path,
            targets=len(targets),
        )

    def _record_freshness(
        self, delta, new_version: int, targets: int
    ) -> None:
        """Delta-apply observability: the moment a delta commits, its
        newest absorbed event is SERVABLE — the event→servable histogram
        is the freshness SLO (docs/freshness.md)."""
        tel = telemetry_mod.current()
        tel.counter("freshness_deltas_applied_total").inc()
        tel.counter("freshness_delta_rows").inc(delta.n_changed_rows)
        tel.gauge("freshness_applied_version").set(new_version)
        if delta.event_wall_epoch is not None:
            import time

            now_wall = time.time()
            tel.histogram("freshness_event_to_servable_seconds").observe(
                max(0.0, now_wall - delta.event_wall_epoch)
            )
        tel.event(
            "freshness.delta_applied",
            version=new_version,
            rows=delta.n_changed_rows,
            targets=targets,
        )

    def _rolled_back(
        self,
        version_before: int,
        model_path: str,
        stage: str,
        reason: str,
        targets: int,
        tenant: Optional[str] = None,
    ) -> SwapResult:
        """Record an aborted (pre-commit) or rolled-back (post-commit)
        swap; either way the previous version is the one serving."""
        tel = telemetry_mod.current()
        self.rollbacks += 1
        tel.counter("serving_rollbacks_total").inc()
        tel.event(
            "serving.rollback",
            stage=stage,
            reason=reason,
            model_path=model_path,
            version=version_before,
            tenant=tenant,
        )
        return SwapResult(
            status="rolled_back",
            version_before=version_before,
            version_after=version_before,
            model_path=model_path,
            stage=stage,
            reason=reason,
            targets=targets,
            tenant=tenant,
        )

    def rollback(self, tenant: Optional[str] = None) -> SwapResult:
        """One-step manual rollback to the version the last successful
        swap replaced.  The retained runtimes (warm hot sets and all)
        are restored on their original targets.  With ``tenant`` set,
        only that tenant's route rolls back — to its previous version,
        or onto the default route if the undone swap was its first."""
        if not self._swap_lock.acquire(blocking=False):
            raise SwapInProgressError(
                "a model swap is in progress; retry after it completes"
            )
        try:
            self.in_progress = True
            if tenant is not None:
                return self._rollback_tenant(tenant)
            if self._remote_previous is not None:
                return self._rollback_remote()
            if not self._previous:
                return SwapResult(
                    status="rolled_back",
                    version_before=self.version,
                    version_after=self.version,
                    model_path=self.model_path,
                    stage="load",
                    reason="nothing to roll back to (no prior "
                    "successful swap retained)",
                )
            version_before = self.version
            for t, old in self._previous:
                t.runtime = old
            restored = self._previous[0][1]
            self._previous = []
            self.version = restored.model_version
            self.model_path = restored.model_path
            self.rollbacks += 1
            tel = telemetry_mod.current()
            tel.counter("serving_rollbacks_total").inc()
            tel.gauge("serving_model_version").set(self.version)
            tel.event(
                "serving.rollback",
                stage="manual",
                reason="operator-requested rollback",
                model_path=self.model_path,
                version=self.version,
            )
            if self._on_commit is not None:
                self._on_commit(
                    restored.model, restored.index_maps, restored.config,
                    restored.model_version, restored.model_path,
                )
            return SwapResult(
                status="rolled_back",
                version_before=version_before,
                version_after=self.version,
                model_path=self.model_path,
                stage="manual",
                reason="operator-requested rollback",
                targets=len(self._targets_fn()),
            )
        finally:
            self.in_progress = False
            self._swap_lock.release()

    def _rollback_tenant(self, tenant: str) -> SwapResult:
        """One-step rollback of a tenant route (thread or process
        mode).  Restores the route the last tenant swap displaced —
        or clears it, putting the tenant back on the default route —
        and re-syncs the version registry.  A worker that holds no
        retained previous route (restarted after the tenant commit) is
        converge-killed, exactly like the default-route remote
        rollback."""
        tel = telemetry_mod.current()
        token = self._tenant_previous
        version_before = self._tenant_version_before(tenant)
        if token is None or token[1] != tenant:
            return SwapResult(
                status="rolled_back",
                version_before=version_before,
                version_after=version_before,
                model_path=self.model_path,
                stage="load",
                reason=f"nothing to roll back for tenant {tenant!r} "
                "(no prior tenant swap retained)",
                tenant=tenant,
            )
        mode, _, carrier, prev_entry = token
        restored_runtime = None
        if mode == "thread":
            for t, old in carrier:
                if old is None:
                    t.clear_tenant_route(tenant)
                else:
                    t.set_tenant_route(tenant, old)
                    restored_runtime = old
        else:
            pool = carrier
            targets = list(self._targets_fn())
            stale: list = []
            for t in targets:
                try:
                    if not t.swap_rollback(tenant=tenant):
                        stale.append(t)
                except Exception:  # noqa: BLE001 — a dead worker
                    pass           # respawns on the restored registry
            pool.rollback_tenant_generation(tenant)
            for t in stale:
                reason = (
                    f"no retained previous route for tenant {tenant!r}; "
                    "respawn replays the restored tenant registry"
                )
                if self._on_kill is not None:
                    self._on_kill(t, reason)
                else:
                    t.kill(reason)
        if prev_entry is None:
            self._tenant_versions.pop(tenant, None)
            version_after = self.version
            restored_path = self.model_path
        else:
            self._tenant_versions[tenant] = prev_entry
            version_after, restored_path = prev_entry
        self._tenant_previous = None
        self.rollbacks += 1
        tel.counter("serving_rollbacks_total").inc()
        tel.gauge(
            f"serving_tenant_{tenant_slug(tenant)}_model_version"
        ).set(version_after)
        tel.event(
            "serving.rollback",
            stage="manual",
            reason="operator-requested tenant rollback",
            model_path=restored_path,
            version=version_after,
            tenant=tenant,
        )
        if self._on_tenant_commit is not None:
            if restored_runtime is not None:
                self._on_tenant_commit(
                    tenant,
                    restored_runtime.model,
                    restored_runtime.index_maps,
                    restored_runtime.config,
                    restored_runtime.model_version,
                    restored_runtime.model_path,
                )
            elif mode == "thread":
                # Back on the default route: clear any retained factory.
                self._on_tenant_commit(tenant, None, None, None, None, None)
        return SwapResult(
            status="rolled_back",
            version_before=version_before,
            version_after=version_after,
            model_path=restored_path,
            stage="manual",
            reason="operator-requested tenant rollback",
            targets=len(self._targets_fn()),
            tenant=tenant,
        )

    def _rollback_remote(self) -> SwapResult:
        """Process-mode manual rollback: each worker restores its
        retained previous runtime, then the pool drops the rolled-back
        generation so restarts attach the restored one.  (No
        ``on_commit`` call — the supervisor's commit hook is a no-op in
        pool mode, and the restored model object lives only in the
        workers.)"""
        pool, _ = self._remote_previous
        self._remote_previous = None
        version_before = self.version
        targets = list(self._targets_fn())
        stale: list = []
        for t in targets:
            try:
                if not t.swap_rollback():
                    # Restarted after the commit: no worker-side
                    # previous to restore.  Converge it below.
                    stale.append(t)
            except Exception:  # noqa: BLE001 — a dead worker respawns
                pass           # on the restored generation below
        restored = pool.rollback_generation()
        for t in stale:
            reason = "no retained previous; respawn on restored generation"
            if self._on_kill is not None:
                self._on_kill(t, reason)
            else:
                t.kill(reason)
        self.version = restored.version
        self.model_path = restored.path
        self.rollbacks += 1
        tel = telemetry_mod.current()
        tel.counter("serving_rollbacks_total").inc()
        tel.gauge("serving_model_version").set(self.version)
        tel.event(
            "serving.rollback",
            stage="manual",
            reason="operator-requested rollback",
            model_path=self.model_path,
            version=self.version,
            mode="process",
        )
        return SwapResult(
            status="rolled_back",
            version_before=version_before,
            version_after=self.version,
            model_path=self.model_path,
            stage="manual",
            reason="operator-requested rollback",
            targets=len(targets),
        )
