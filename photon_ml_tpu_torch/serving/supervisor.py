"""Replica supervision: N scoring replicas behind one listener (port of
``photon_ml_tpu/serving/supervisor.py``).

One ``ScoringRuntime`` is a single point of failure: a wedged dispatch
thread or a lost device is a full outage until something restarts the
process.  :class:`ReplicaSupervisor` runs ``n_replicas`` independent
replicas — each its own ``ScoringRuntime`` + ``MicroBatcher`` (own
dispatch thread, so the runtime's lock-free single-writer invariant
holds per replica) — and owns three jobs:

- **Routing**: requests round-robin over HEALTHY replicas.  A replica
  that fails a request with a watchdog-transient error (the vocabulary a
  crash speaks: UNAVAILABLE, device lost, injected faults) is marked
  down and the request is RESUBMITTED to another healthy replica — the
  client's future only fails when every replica has been tried.  This is
  what makes a scripted replica kill cost zero failed requests.
- **Health probes**: a supervision thread scores a cheap offset-only
  probe through every healthy replica's real dispatch path each
  ``probe_interval_s`` (``bypass_admission=True`` — shedding tiers must
  not read as replica death).  ``probe_failure_threshold`` consecutive
  failures — including a probe future that never completes within
  ``probe_timeout_s``, i.e. a WEDGED dispatch thread — drain the replica.
- **Restarts**: a down replica's batcher is drained and stopped off the
  request path, then rebuilt from ``runtime_factory`` after a
  decorrelated-jitter backoff (``utils/watchdog.RetryPolicy``,
  ``jitter="decorrelated"``: sleep ~ U[base, 3·previous], capped) — N
  replicas lost to one cause do not restart in lockstep and re-overload
  whatever killed them.  Sustained health resets the backoff walk.

Replica states::

    starting ──> healthy ──(probe/request failures)──> down
                    ^                                    │
                    └── restart (factory, jitter backoff)┘

``kill_replica(rid)`` is the scripted crash: the replica's runtime is
replaced with a poison stand-in so every queued and future batch fails
transiently (and resubmits elsewhere), then the replica is marked down
and follows the normal drain → backoff → restart path.  The chaos seam
``serving.replica`` fires at routing time (FaultSpec ``at=k`` kills the
k-th routed request's replica) for plan-scripted kills.

The supervisor intentionally mirrors ``ScoringService``'s surface
(``submit`` / ``healthz`` / ``stats`` / ``start`` / ``stop``) so the
service and HTTP layer compose with either a bare runtime or a
supervisor — see serving/service.py and docs/serving.md.

**Process mode**: pass ``pool=`` (a
:class:`~photon_ml_tpu_torch.serving.procpool.WorkerPool`) instead of
``runtime_factory`` and every replica becomes an OS process mapping the
pool's shared-memory model — same routing, probing, resubmission, and
jittered-restart machinery, but the fault domain a probe failure or
kill costs is a whole process, and ``kill_replica`` delivers a real
SIGKILL.  The pool's :class:`ProcessReplica` duck-types the
MicroBatcher surface the supervisor drives, so every seam below stays
mode-agnostic.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.serving.batcher import (
    BatcherConfig,
    DeadlineExceededError,
    MicroBatcher,
    RejectedError,
)
from photon_ml_tpu_torch.serving.runtime import (
    Row,
    RuntimeConfig,
    ScoringRuntime,
)
from photon_ml_tpu_torch.utils.watchdog import RetryPolicy


class _DeadRuntime:
    """Poison runtime installed by :meth:`ReplicaSupervisor.kill_replica`:
    every batch fails with a watchdog-transient error, so queued requests
    drain as resubmissions instead of hanging on a corpse."""

    degraded = False

    def __init__(self, reason: str):
        self.reason = reason
        self.model_version = 0
        self.buckets = [1]

    def score_rows(self, rows):
        raise RuntimeError(f"UNAVAILABLE: replica killed ({self.reason})")

    def bucket_for(self, n: int) -> int:
        return n


@dataclasses.dataclass
class _Replica:
    rid: int
    batcher: MicroBatcher
    state: str = "healthy"  # "healthy" | "down"
    probe_failures: int = 0
    restart_attempt: int = 0
    last_delay: Optional[float] = None
    next_restart_t: float = 0.0
    restarts: int = 0
    down_reason: Optional[str] = None


class ReplicaSupervisor:
    """N scoring replicas + health probes + jittered restarts."""

    def __init__(
        self,
        runtime_factory: Optional[Callable[[], ScoringRuntime]] = None,
        n_replicas: int = 2,
        batcher_config: Optional[BatcherConfig] = None,
        policy: Optional[RetryPolicy] = None,
        restart_policy: Optional[RetryPolicy] = None,
        probe_interval_s: float = 0.25,
        probe_timeout_s: float = 10.0,
        probe_failure_threshold: int = 2,
        rng: Optional[random.Random] = None,
        clock: Callable[[], float] = time.monotonic,
        pool=None,
    ):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        if (runtime_factory is None) == (pool is None):
            raise ValueError(
                "pass exactly one of runtime_factory (in-process "
                "replicas) or pool (process workers)"
            )
        self.runtime_factory = runtime_factory
        self.pool = pool
        self.n_replicas = n_replicas
        self.batcher_config = batcher_config
        self.policy = policy or RetryPolicy()
        self.restart_policy = restart_policy or RetryPolicy(
            backoff_seconds=0.05,
            max_backoff_seconds=2.0,
            jitter="decorrelated",
        )
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.probe_failure_threshold = probe_failure_threshold
        self._rng = rng or random.Random()
        self._clock = clock
        self.replicas: list[_Replica] = []
        self._lock = sanitizers.tracked(
            threading.Lock(), "serving.supervisor"
        )
        self._rr = 0
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None
        self._started = False
        #: tenant → (model, index_maps, config, version, path) retained
        #: from tenant-swap commits (thread mode), so a restarted
        #: replica's fresh batcher gets every committed tenant route
        #: re-applied.  Process mode keeps this empty — the pool's
        #: tenant-generation registry replays routes into respawned
        #: workers instead.  Written only under _lock.
        self._tenant_factories: dict = {}
        #: tenant → (rate_rps, burst) live quota overrides (fleet lease
        #: apply path, serving/fleet.py) — HOST-level rates, split
        #: evenly across replicas because each replica admits with its
        #: own bucket.  Replayed into every rebuilt replica so a
        #: restart comes back under the live lease, not the static
        #: spec.  Written only under _lock.
        self._quota_overrides: dict = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        if self._started:
            return self
        if self.pool is not None and self.n_replicas > 1:
            self.replicas.extend(self._spawn_all())
        else:
            for rid in range(self.n_replicas):
                self.replicas.append(self._build_replica(rid))
        self._stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="replica-supervisor", daemon=True
        )
        self._probe_thread.start()
        self._started = True
        telemetry_mod.current().gauge(
            "serving_healthy_replicas_count"
        ).set(len(self.replicas))
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        thread = self._probe_thread
        self._probe_thread = None
        if thread is not None:
            thread.join(timeout=timeout)
        for rep in self.replicas:
            rep.batcher.stop(timeout=timeout)
        if self.pool is not None:
            self.pool.close(timeout=timeout)
        if thread is not None and thread.is_alive():
            # The supervision thread outlived the first join: a restart
            # was mid-spawn when stop() began (a worker spawn takes
            # seconds on a loaded box).  new_replica on the now-closed
            # pool refuses — and a spawn that slipped past the close
            # reaps itself at registration — so the thread exits
            # promptly; sweep any batcher it installed before noticing.
            thread.join(timeout=timeout)
            for rep in self.replicas:
                rep.batcher.stop(timeout=1.0)
        self._started = False

    def __enter__(self) -> "ReplicaSupervisor":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def _spawn_all(self) -> list:
        """Start every worker process at once: each spawn pays its own
        interpreter start, ``import torch`` and device context, so N
        workers come up in about the time of one (the reference spawns
        them one after the other).  If any fails, the ones that came up
        are stopped and the first error raises."""
        built: dict = {}
        errors: list = []

        def build(rid: int) -> None:
            try:
                built[rid] = self._build_replica(rid)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)

        threads = [
            threading.Thread(target=build, args=(rid,),
                             name=f"replica-spawn-{rid}", daemon=True)
            for rid in range(self.n_replicas)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            for rep in built.values():
                rep.batcher.stop(timeout=1.0)
            raise errors[0]
        return [built[rid] for rid in range(self.n_replicas)]

    def _build_replica(self, rid: int) -> _Replica:
        if self.pool is not None:
            batcher = self.pool.new_replica(
                rid, self.batcher_config, policy=self.policy
            )
        else:
            runtime = self.runtime_factory()
            batcher = MicroBatcher(
                runtime, self.batcher_config, policy=self.policy
            ).start()
            self._apply_tenant_routes(batcher)
        with self._lock:
            overrides = dict(self._quota_overrides)
        for tenant, (rate, burst) in overrides.items():
            try:
                batcher.set_tenant_quota(
                    tenant, *self._per_replica_quota(rate, burst)
                )
            except Exception:  # noqa: BLE001 — next lease re-applies
                pass
        return _Replica(rid=rid, batcher=batcher)

    def _apply_tenant_routes(self, batcher: MicroBatcher) -> None:
        """Re-apply every committed tenant route so a fresh replica —
        built at start or by a restart — serves tenants on their swapped
        versions, not the default (serving/tenancy.py).  The reference
        re-applies them at start only, so its restarted replicas fall
        back to the default route."""
        with self._lock:
            factories = dict(self._tenant_factories)
        for tenant, (model, index_maps, config, version,
                     path) in factories.items():
            rt = ScoringRuntime(model, index_maps, config)
            rt.model_version = version
            rt.model_path = path
            batcher.set_tenant_route(tenant, rt)

    def _per_replica_quota(self, rate, burst) -> tuple:
        """A host-level lease split evenly across this host's replicas
        (admission is per-bucket, so N buckets at R/N enforce R — the
        same sizing precedent as per-worker quota specs)."""
        n = max(1, self.n_replicas)
        per_rate = None if rate is None else float(rate) / n
        per_burst = None if burst is None else max(1.0, float(burst) / n)
        return per_rate, per_burst

    def set_tenant_quota(
        self, tenant: str, rate_rps, burst=None
    ) -> None:
        """Apply a HOST-level tenant quota across every replica (fleet
        lease apply path).  Raises if no replica accepted it — e.g. an
        undeclared tenant; partial application heals at the next lease
        renewal, which re-applies the full rate set."""
        with self._lock:
            self._quota_overrides[tenant] = (rate_rps, burst)
            replicas = list(self.replicas)
        per_rate, per_burst = self._per_replica_quota(rate_rps, burst)
        applied = 0
        last_exc: Optional[Exception] = None
        for rep in replicas:
            try:
                rep.batcher.set_tenant_quota(tenant, per_rate, per_burst)
                applied += 1
            except Exception as exc:  # noqa: BLE001 — count failures
                last_exc = exc
        if applied == 0 and last_exc is not None:
            raise last_exc

    # -- routing (any thread) ------------------------------------------------
    def _healthy(self) -> list[_Replica]:
        with self._lock:
            return [r for r in self.replicas if r.state == "healthy"]

    @property
    def healthy_count(self) -> int:
        return len(self._healthy())

    def _pick(self, tried: set) -> Optional[_Replica]:
        with self._lock:
            candidates = [
                r for r in self.replicas
                if r.state == "healthy" and r.rid not in tried
            ]
            if not candidates:
                return None
            self._rr += 1
            return candidates[self._rr % len(candidates)]

    def parse_request(self, obj: dict) -> Row:
        runtime = self._any_runtime()
        if runtime is None:
            raise RejectedError(
                "UNAVAILABLE: no replica available to parse against; "
                "retry with backoff"
            )
        return runtime.parse_request(obj)

    def _any_runtime(self):
        if self.pool is not None:
            # Parsing is parent-side state in process mode (the pool's
            # RequestParser) — no worker round-trip, and it stays
            # available even while every worker is respawning.
            return self.pool.runtime_view()
        # isinstance filter even on healthy replicas: a just-killed one
        # carries a poison _DeadRuntime for the instant before
        # _mark_down lands, and parsing against it would crash.
        reps = [
            r for r in self._healthy()
            if isinstance(r.batcher.runtime, ScoringRuntime)
        ] or [
            r for r in self.replicas
            if isinstance(r.batcher.runtime, ScoringRuntime)
        ]
        return reps[0].batcher.runtime if reps else None

    def submit(
        self, row, timeout_ms: Optional[float] = None
    ) -> Future:
        """Route one parsed row; returns a supervisor-level future.

        The future resolves from whichever replica ultimately scores the
        row — a replica that dies mid-request is drained and the row is
        resubmitted to a peer (fresh deadline budget; failover
        stretches a deadline rather than failing the request).  Only
        exhausting every healthy replica fails the future.
        """
        fut: Future = Future()
        self._route(row, timeout_ms, fut, tried=set())
        return fut

    def _route(
        self, row, timeout_ms, fut: Future, tried: set
    ) -> None:
        last_reject: Optional[Exception] = None
        while True:
            rep = self._pick(tried)
            if rep is None:
                exc = last_reject or RejectedError(
                    "UNAVAILABLE: no healthy replica "
                    f"({self.healthy_count} healthy, "
                    f"{len(tried)} tried); retry with backoff"
                )
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(exc)
                return
            try:
                # The scripted-crash seam: a fault here is a replica
                # dying as it picks up the request (docs/robustness.md).
                chaos_mod.maybe_fail("serving.replica", replica=rep.rid)
                inner = rep.batcher.submit(row, timeout_ms=timeout_ms)
            except RejectedError as exc:
                # This replica's admission control shed the row; another
                # replica below its watermarks may still take it.
                tried.add(rep.rid)
                last_reject = exc
                continue
            except Exception as exc:  # noqa: BLE001 — classified below
                if not self.policy.classify(exc).transient:
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(exc)
                    return
                self._mark_down(
                    rep, f"failed at routing: {exc}"[:200]
                )
                tried.add(rep.rid)
                telemetry_mod.current().counter(
                    "serving_resubmitted_total"
                ).inc()
                continue
            inner.add_done_callback(
                lambda f, rep=rep: self._on_done(
                    f, rep, row, timeout_ms, fut, tried
                )
            )
            return

    def _on_done(
        self, inner: Future, rep: _Replica, row, timeout_ms,
        fut: Future, tried: set,
    ) -> None:
        # Runs on the replica's dispatch thread — must never join
        # threads or block; resubmission is a non-blocking queue put.
        exc = inner.exception()
        if exc is None:
            if fut.set_running_or_notify_cancel():
                fut.set_result(inner.result())
            return
        if (
            isinstance(exc, (DeadlineExceededError, RejectedError))
            or not self.policy.classify(exc).transient
        ):
            # The REQUEST's own verdict (expired deadline, bad input) —
            # another replica would only repeat it.
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)
            return
        # A transient failure is the replica's fault, not the row's:
        # drain the replica, resubmit the row to a peer.
        self._mark_down(rep, f"failed a request: {exc}"[:200])
        tried.add(rep.rid)
        telemetry_mod.current().counter("serving_resubmitted_total").inc()
        self._route(row, timeout_ms, fut, tried)

    # -- failure handling ----------------------------------------------------
    def _mark_down(self, rep: _Replica, reason: str) -> None:
        """Exclude a replica from routing and schedule its restart with
        decorrelated-jitter backoff.  Never blocks: teardown of the old
        batcher happens on the supervision thread."""
        with self._lock:
            if rep.state != "healthy":
                return
            rep.state = "down"
            rep.down_reason = reason
            rep.probe_failures = 0
            delay = self.restart_policy.backoff(
                rep.restart_attempt, rng=self._rng,
                previous=rep.last_delay,
            )
            rep.restart_attempt += 1
            rep.last_delay = delay
            rep.next_restart_t = self._clock() + delay
        tel = telemetry_mod.current()
        tel.gauge("serving_healthy_replicas_count").set(
            self.healthy_count
        )
        tel.event(
            "serving.replica_down",
            replica=rep.rid,
            reason=reason,
            restart_in_s=round(delay, 4),
        )

    def kill_replica(
        self, rid: int, reason: str = "scripted kill"
    ) -> _Replica:
        """Scripted crash of replica ``rid`` (bench scenarios, the
        selfcheck, tests): queued and in-flight requests on it fail
        transiently — and therefore resubmit to peers — and the replica
        takes the normal drain → backoff → restart path."""
        rep = next(r for r in self.replicas if r.rid == rid)
        kill = getattr(rep.batcher, "kill", None)
        if callable(kill):
            # Process mode: an actual SIGKILL.  The worker's death fails
            # its in-flight rows transiently via the pipe EOF, which is
            # the same resubmit-to-a-peer path the poison runtime fakes.
            kill(reason)
        else:
            rep.batcher.runtime = _DeadRuntime(reason)
        self._mark_down(rep, reason)
        return rep

    def kill_batcher(
        self, batcher, reason: str = "scripted kill"
    ) -> Optional[_Replica]:
        """:meth:`kill_replica` by batcher identity — the swapper holds
        batchers, not rids.  Killing through here (instead of
        ``batcher.kill``) marks the replica down in the same call, so
        health state never reports a converge-killed worker healthy."""
        for rep in self.replicas:
            if rep.batcher is batcher:
                return self.kill_replica(rep.rid, reason)
        # Not a current replica (already restarted past it): best-effort
        # direct kill of the orphaned batcher.
        kill = getattr(batcher, "kill", None)
        if callable(kill):
            kill(reason)
        return None

    # -- supervision thread --------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — supervision must survive
                pass

    def _tick(self) -> None:
        now = self._clock()
        for rep in list(self.replicas):
            if self._stop.is_set():
                return
            if rep.state == "down":
                # Drain off the request path: queued items flow through
                # the dispatch loop (fast-failing on a killed replica's
                # poison runtime), then the thread exits.  Idempotent.
                rep.batcher.stop(timeout=1.0)
                if now >= rep.next_restart_t:
                    self._restart(rep)
            elif rep.state == "healthy":
                self._probe(rep)

    def _probe(self, rep: _Replica) -> None:
        tel = telemetry_mod.current()
        try:
            fut = rep.batcher.submit(
                Row(features={}, ids={}), bypass_admission=True
            )
            result = fut.result(timeout=self.probe_timeout_s)
            if result is None:
                raise RuntimeError("probe returned no result")
        except Exception as exc:  # noqa: BLE001 — any failure counts
            rep.probe_failures += 1
            tel.counter("serving_probe_failures_total").inc()
            if rep.probe_failures >= self.probe_failure_threshold:
                self._mark_down(
                    rep,
                    f"{rep.probe_failures} consecutive probe failures "
                    f"(last: {exc})"[:200],
                )
            return
        rep.probe_failures = 0
        # Sustained health resets the backoff walk (a replica that
        # answers probes again is trusted again; see the flapping
        # runbook in ops/README.md for threshold tuning).
        rep.restart_attempt = 0
        rep.last_delay = None

    def _restart(self, rep: _Replica) -> None:
        tel = telemetry_mod.current()
        try:
            if self.pool is not None:
                batcher = self.pool.new_replica(
                    rep.rid, self.batcher_config, policy=self.policy
                )
                runtime = batcher.runtime
            else:
                runtime = self.runtime_factory()
                batcher = MicroBatcher(
                    runtime, self.batcher_config, policy=self.policy
                ).start()
                self._apply_tenant_routes(batcher)
        except Exception as exc:  # noqa: BLE001 — reschedule with backoff
            with self._lock:
                delay = self.restart_policy.backoff(
                    rep.restart_attempt, rng=self._rng,
                    previous=rep.last_delay,
                )
                rep.restart_attempt += 1
                rep.last_delay = delay
                rep.next_restart_t = self._clock() + delay
            tel.event(
                "serving.replica_restart_failed",
                replica=rep.rid,
                error=f"{type(exc).__name__}: {exc}"[:200],
                retry_in_s=round(delay, 4),
            )
            return
        # Restarted replicas come back under the LIVE quota lease, not
        # the static spec (serving/fleet.py); a failed apply heals at
        # the next lease renewal.
        with self._lock:
            overrides = dict(self._quota_overrides)
        for tenant, (rate, burst) in overrides.items():
            try:
                batcher.set_tenant_quota(
                    tenant, *self._per_replica_quota(rate, burst)
                )
            except Exception:  # noqa: BLE001 — next lease re-applies
                pass
        with self._lock:
            rep.batcher = batcher
            rep.state = "healthy"
            rep.probe_failures = 0
            rep.down_reason = None
            rep.restarts += 1
        tel.counter("serving_replica_restarts_total").inc()
        tel.gauge("serving_healthy_replicas_count").set(
            self.healthy_count
        )
        tel.event(
            "serving.replica_restarted",
            replica=rep.rid,
            restarts=rep.restarts,
            model_version=getattr(runtime, "model_version", 1),
        )

    # -- hot-swap integration ------------------------------------------------
    def swap_targets(self) -> list[MicroBatcher]:
        """The batchers a hot-swap rolls: every HEALTHY replica.  Down
        replicas rejoin on the new version via the updated factory."""
        return [r.batcher for r in self._healthy()]

    def on_swap_commit(
        self, model, index_maps, config: RuntimeConfig,
        version: int, path: Optional[str],
    ) -> None:
        """HotSwapper commit hook: restarts must come back on the
        NOW-SERVING version, so rebuild the replica factory around the
        committed model.  (A restart racing the commit window may build
        the prior version; its next swap or kill converges it.)"""
        if self.pool is not None:
            # Process mode: restarts attach the pool's CURRENT
            # generation, which the swapper already advanced via
            # commit_generation — there is no factory to rebuild.
            return

        def factory() -> ScoringRuntime:
            rt = ScoringRuntime(model, index_maps, config)
            rt.model_version = version
            rt.model_path = path
            return rt

        self.runtime_factory = factory

    def on_tenant_swap_commit(
        self, tenant: str, model, index_maps,
        config: Optional[RuntimeConfig], version: Optional[int],
        path: Optional[str],
    ) -> None:
        """HotSwapper tenant-commit hook: retain what a restart needs to
        re-apply this tenant's route on a fresh replica.  An all-None
        payload means the tenant rolled back onto the default route —
        drop the retained entry."""
        if self.pool is not None:
            # Process mode: respawned workers replay routes from the
            # pool's tenant-generation registry (procpool.py).
            return
        with self._lock:
            if model is None:
                self._tenant_factories.pop(tenant, None)
            else:
                self._tenant_factories[tenant] = (
                    model, index_maps, config, version, path
                )

    # -- observability -------------------------------------------------------
    @property
    def degraded(self) -> bool:
        return any(
            getattr(r.batcher.runtime, "degraded", False)
            for r in self._healthy()
        )

    @property
    def ready(self) -> bool:
        return self._started and any(
            getattr(r.batcher.runtime, "ready", False)
            for r in self._healthy()
        )

    def stats(self) -> dict:
        with self._lock:
            replicas = [
                {
                    "rid": r.rid,
                    "state": r.state,
                    "restarts": r.restarts,
                    "probe_failures": r.probe_failures,
                    "restart_attempt": r.restart_attempt,
                    "down_reason": r.down_reason,
                    "model_version": getattr(
                        r.batcher.runtime, "model_version", None
                    ),
                    "queue_depth": r.batcher.queue_depth,
                }
                for r in self.replicas
            ]
        return {
            "n_replicas": self.n_replicas,
            "healthy": self.healthy_count,
            "replicas": replicas,
        }
