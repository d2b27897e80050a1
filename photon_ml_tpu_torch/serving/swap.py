"""Zero-downtime model hot-swap with verified rollback (port of
``photon_ml_tpu/serving/swap.py``).

:class:`HotSwapper` rolls a serving unit — one ``MicroBatcher`` or every
healthy replica under a supervisor, once the process tier ports one
(ROADMAP item 7b) — onto a new model directory without dropping a
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

The reference's process mode (worker stubs rolled over the swap
protocol and shared-memory generations) and its delta path
(:meth:`HotSwapper.swap_delta`, over ``freshness/delta.py``) wait for the
process tier (ROADMAP item 7b); the ``serving.swap`` fault sites wait for
the chaos registry (item 8).

The load and prepare stages run on the thread that asked for the swap
(the ``/reload`` handler): they build the new runtime on the card and
wait for its warm-up and probe before the commit hands it to the
dispatch thread.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from photon_ml_tpu_torch import telemetry as telemetry_mod
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
    service supplies it: its one batcher).  ``on_commit`` (optional) is
    called after every successful swap OR rollback with the now-serving
    ``(model, index_maps, config, version, path)``.
    """

    def __init__(
        self,
        targets_fn: Callable[[], Sequence],
        on_commit: Optional[Callable] = None,
        probe_timeout_s: float = 30.0,
    ):
        self._targets_fn = targets_fn
        self._on_commit = on_commit
        self.probe_timeout_s = probe_timeout_s
        self._swap_lock = threading.Lock()
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
        #: tenant → (version, model_path) for every committed
        #: tenant-scoped route.  Tenants absent here follow the default
        #: route (``self.version``).  Versions come from the SAME
        #: monotone ``_max_version`` sequence as full swaps.
        self._tenant_versions: dict = {}
        #: one-step tenant rollback token, set by the last successful
        #: tenant swap: (tenant, [(target, old_route)], prev) where prev
        #: is the registry entry the swap displaced (None = default
        #: route).
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
            "can_rollback": bool(self._previous),
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

        # Stage 1+2: load + prepare, entirely off the request path — the
        # old runtimes keep serving while this thread builds and warms.
        stage = "load"
        try:
            model, index_maps = ScoringRuntime.load_model(
                model_path,
                device=(runtime_config or targets[0].runtime.config).device,
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

        stage = "load"
        try:
            model, index_maps = ScoringRuntime.load_model(
                model_path,
                device=(runtime_config or targets[0].runtime.config).device,
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
        self._tenant_previous = (tenant, previous_routes, prev_entry)
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
        """The reference's delta apply (patch only the changed rows of
        the serving model from a ``freshness/delta.py`` artifact).  It
        needs the freshness package, which comes with the process tier:
        refused until ROADMAP item 7b lands."""
        raise NotImplementedError(
            "delta reloads need photon_ml_tpu_torch.freshness, which is "
            "not ported yet (ROADMAP item 7b); reload a full model "
            f"directory instead of {delta_path!r}"
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
        """One-step rollback of a tenant route.  Restores the route the
        last tenant swap displaced — or clears it, putting the tenant
        back on the default route — and re-syncs the version
        registry."""
        tel = telemetry_mod.current()
        token = self._tenant_previous
        version_before = self._tenant_version_before(tenant)
        if token is None or token[0] != tenant:
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
        _, previous_routes, prev_entry = token
        for t, old in previous_routes:
            if old is None:
                t.clear_tenant_route(tenant)
            else:
                t.set_tenant_route(tenant, old)
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
