"""Built-in load generators for the serving path (port of
``photon_ml_tpu/serving/loadgen.py``).

Two disciplines, both driving ``ScoringService.submit``:

- **Closed loop** (:func:`closed_loop`): N client threads, each with one
  request in flight — measures the service's achievable throughput at a
  concurrency level (latency and throughput are coupled; this is the
  classic saturation probe).
- **Open loop** (:func:`open_loop`): requests arrive on a Poisson clock
  at ``rate`` rps regardless of completions — measures latency under a
  FIXED offered load, including the queueing delay a closed loop hides
  (coordinated omission).  Arrivals that find the queue full count as
  rejections, which is the admission-control design working as intended.

On top of the two disciplines, **scripted scenarios** (:func:`run_scenario`
over the :data:`SCENARIOS` catalog) chain open-loop phases with varying
rate, entity skew, and mid-phase ACTIONS (hot-swap, replica kill) — the
repeatable "a bad day in serving" scripts that ``bench_serving`` and the
HA selfcheck replay:

- ``diurnal``      — rate ramps up 4x and back down (the daily curve);
  admission tiers should engage at the peak and release after.
- ``skew_shift``   — the hot entity set jumps to a disjoint pool
  mid-run; the LRU hot tables churn and re-converge.
- ``swap_under_load``   — a model hot-swap commits mid-phase while
  traffic flows; zero failed requests expected.
- ``replica_kill`` — a replica is killed mid-phase; the supervisor
  resubmits and restarts; zero failed requests expected.
- ``freshness``    — concept drift: the hot pool shifts (as in
  ``skew_shift``) while an online-refined delta publishes and
  hot-applies mid-phase (``freshness/``); zero failed requests expected.
- ``worker_kill``  — process-mode only: a worker PROCESS takes a real
  SIGKILL mid-phase; same zero-failed-requests contract through the
  pipe-EOF resubmission path.
- ``noisy_neighbor`` — TWO tenants: an aggressor bursts to ~10x its
  quota while a victim holds steady; the tenancy layer must shed the
  aggressor alone — victim p99 inside its SLO, zero victim failures.
  Tenant-aware: replay with :func:`run_noisy_neighbor` (per-tenant
  outcome accounting), not the tenant-blind :func:`run_scenario`.

Per-phase and whole-run p50/p99 come from the same shared
``telemetry.Histogram.quantile`` the live exposition uses.

Used by ``python -m photon_ml_tpu_torch.serving --loadgen ...`` and by
``chip_smoke.py``'s serving phases.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from photon_ml_tpu_torch.telemetry import Histogram
from photon_ml_tpu_torch.serving.batcher import DeadlineExceededError, RejectedError


@dataclasses.dataclass
class LoadReport:
    """Latency/throughput summary of one load-generator run."""

    mode: str
    wall_seconds: float
    completed: int
    rejected: int
    errors: int
    latencies_ms: np.ndarray  # completed requests only, milliseconds

    @property
    def throughput_rps(self) -> float:
        return self.completed / self.wall_seconds if self.wall_seconds else 0.0

    def latency_histogram(self) -> Histogram:
        """The latencies folded into a telemetry histogram — the same
        bucket grid and quantile estimator the live /metrics exposition
        uses, so a loadgen report and a scraped
        ``serving_request_latency_seconds`` quantile are directly
        comparable (cached; build cost paid once)."""
        hist = getattr(self, "_hist", None)
        if hist is None:
            hist = Histogram(threading.Lock())
            for v in self.latencies_ms:
                hist.observe(v)
            self._hist = hist
        return hist

    def percentile_ms(self, q: float) -> Optional[float]:
        if len(self.latencies_ms) == 0:
            return None
        return float(self.latency_histogram().quantile(q / 100.0))

    def snapshot(self) -> dict:
        return {
            "mode": self.mode,
            "wall_seconds": round(self.wall_seconds, 3),
            "completed": self.completed,
            "rejected": self.rejected,
            "errors": self.errors,
            "throughput_rps": round(self.throughput_rps, 1),
            "latency_p50_ms": _round(self.percentile_ms(50)),
            "latency_p90_ms": _round(self.percentile_ms(90)),
            "latency_p99_ms": _round(self.percentile_ms(99)),
            "latency_p999_ms": _round(self.percentile_ms(99.9)),
            "latency_max_ms": _round(
                float(self.latencies_ms.max())
                if len(self.latencies_ms) else None
            ),
        }


def _round(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 3)


def closed_loop(
    submit: Callable,
    make_request: Callable[[int], object],
    clients: int = 8,
    duration_s: float = 5.0,
    timeout_s: float = 30.0,
) -> LoadReport:
    """``clients`` threads, one in-flight request each, for
    ``duration_s``.  ``make_request(i)`` builds the i-th request (vary it
    so the hot/cold split sees a realistic entity stream)."""
    latencies: list[list[float]] = [[] for _ in range(clients)]
    counts = np.zeros((clients, 3), np.int64)  # completed/rejected/errors
    stop = time.perf_counter() + duration_s
    seq = [0]
    seq_lock = threading.Lock()

    def client(ci: int) -> None:
        while time.perf_counter() < stop:
            with seq_lock:
                i = seq[0]
                seq[0] += 1
            t0 = time.perf_counter()
            try:
                fut = submit(make_request(i))
                fut.result(timeout=timeout_s)
            except RejectedError:
                counts[ci, 1] += 1
                continue
            except Exception:  # noqa: BLE001 — loadgen counts, not raises
                counts[ci, 2] += 1
                continue
            latencies[ci].append((time.perf_counter() - t0) * 1e3)
            counts[ci, 0] += 1

    t_start = time.perf_counter()
    threads = [
        threading.Thread(target=client, args=(ci,), daemon=True)
        for ci in range(clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    return LoadReport(
        mode=f"closed(clients={clients})",
        wall_seconds=wall,
        completed=int(counts[:, 0].sum()),
        rejected=int(counts[:, 1].sum()),
        errors=int(counts[:, 2].sum()),
        latencies_ms=np.concatenate(
            [np.asarray(c) for c in latencies]
        ) if any(latencies) else np.zeros(0),
    )


def open_loop(
    submit: Callable,
    make_request: Callable[[int], object],
    rate_rps: float = 200.0,
    duration_s: float = 5.0,
    timeout_s: float = 30.0,
    seed: int = 0,
) -> LoadReport:
    """Poisson arrivals at ``rate_rps`` for ``duration_s``; latency is
    measured from the SCHEDULED arrival time (no coordinated omission —
    a stalled service accrues queueing delay against every later
    arrival)."""
    rng = np.random.default_rng(seed)
    results_lock = threading.Lock()
    latencies: list[float] = []
    counts = [0, 0, 0]  # completed / rejected / errors
    pending: list[threading.Thread] = []

    def waiter(fut, t_sched: float) -> None:
        try:
            fut.result(timeout=timeout_s)
        except Exception:  # noqa: BLE001
            with results_lock:
                counts[2] += 1
            return
        lat = (time.perf_counter() - t_sched) * 1e3
        with results_lock:
            latencies.append(lat)
            counts[0] += 1

    t_start = time.perf_counter()
    t_next = t_start
    i = 0
    while t_next < t_start + duration_s:
        now = time.perf_counter()
        if now < t_next:
            time.sleep(t_next - now)
        try:
            fut = submit(make_request(i))
        except RejectedError:
            with results_lock:
                counts[1] += 1
        except Exception:  # noqa: BLE001
            with results_lock:
                counts[2] += 1
        else:
            t = threading.Thread(
                target=waiter, args=(fut, t_next), daemon=True
            )
            t.start()
            pending.append(t)
        i += 1
        t_next += float(rng.exponential(1.0 / rate_rps))
    for t in pending:
        t.join(timeout=timeout_s)
    wall = time.perf_counter() - t_start
    return LoadReport(
        mode=f"open(rate={rate_rps:g}rps)",
        wall_seconds=wall,
        completed=counts[0],
        rejected=counts[1],
        errors=counts[2],
        latencies_ms=np.asarray(latencies),
    )


# ---------------------------------------------------------------------------
# Scripted scenarios
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScenarioPhase:
    """One open-loop segment of a scenario."""

    name: str
    duration_s: float
    #: offered load = ``base_rate_rps * rate_multiplier``.
    rate_multiplier: float = 1.0
    #: fraction range ``(lo, hi)`` of the entity space this phase draws
    #: from; the caller's ``make_request(i, phase)`` interprets it (a
    #: disjoint range across phases is the hot-set skew shift).
    entity_pool: Optional[tuple[float, float]] = None
    #: action fired DURING the phase (``"swap"`` / ``"kill_replica"`` /
    #: any key the caller wires), resolved via ``run_scenario(actions=)``.
    action: Optional[str] = None
    #: when within the phase the action fires (fraction of duration) —
    #: far enough in that traffic is flowing, far enough from the end
    #: that the aftermath is measured.
    action_at_frac: float = 0.25


@dataclasses.dataclass
class Scenario:
    name: str
    description: str
    phases: list


@dataclasses.dataclass
class ScenarioReport:
    """Per-phase + whole-run summary of one scenario replay."""

    scenario: str
    phases: list  # (phase_name, LoadReport) pairs
    actions: dict  # action name -> result (or error string)

    @property
    def completed(self) -> int:
        return sum(r.completed for _, r in self.phases)

    @property
    def rejected(self) -> int:
        return sum(r.rejected for _, r in self.phases)

    @property
    def errors(self) -> int:
        return sum(r.errors for _, r in self.phases)

    def percentile_ms(self, q: float) -> Optional[float]:
        latencies = [
            r.latencies_ms for _, r in self.phases if len(r.latencies_ms)
        ]
        if not latencies:
            return None
        merged = LoadReport(
            mode="merged", wall_seconds=0.0, completed=self.completed,
            rejected=self.rejected, errors=self.errors,
            latencies_ms=np.concatenate(latencies),
        )
        return merged.percentile_ms(q)

    def snapshot(self) -> dict:
        return {
            "scenario": self.scenario,
            "completed": self.completed,
            "rejected": self.rejected,
            "errors": self.errors,
            "latency_p50_ms": _round(self.percentile_ms(50)),
            "latency_p99_ms": _round(self.percentile_ms(99)),
            "latency_p999_ms": _round(self.percentile_ms(99.9)),
            "actions": self.actions,
            "phases": {
                name: report.snapshot() for name, report in self.phases
            },
        }


#: The scenario catalog ``bench_serving`` iterates.  Durations are short
#: (seconds) — these are repeatable scripts, not endurance runs; scale
#: offered load through ``base_rate_rps``.
SCENARIOS = {
    "diurnal": Scenario(
        "diurnal",
        "rate ramps 0.5x -> 2x -> 0.5x, the compressed daily curve",
        [
            ScenarioPhase("night", 1.0, rate_multiplier=0.5),
            ScenarioPhase("morning", 1.0, rate_multiplier=1.0),
            ScenarioPhase("peak", 1.0, rate_multiplier=2.0),
            ScenarioPhase("evening", 1.0, rate_multiplier=0.5),
        ],
    ),
    "skew_shift": Scenario(
        "skew_shift",
        "hot entity set jumps to a disjoint pool mid-run (LRU churn)",
        [
            ScenarioPhase("pool_a", 1.5, entity_pool=(0.0, 0.3)),
            ScenarioPhase("pool_b", 1.5, entity_pool=(0.7, 1.0)),
        ],
    ),
    "swap_under_load": Scenario(
        "swap_under_load",
        "model hot-swap commits while traffic flows; zero errors expected",
        [
            ScenarioPhase("warm", 1.0),
            ScenarioPhase("swap", 2.0, action="swap"),
            ScenarioPhase("after", 1.0),
        ],
    ),
    "replica_kill": Scenario(
        "replica_kill",
        "a replica dies mid-phase; resubmission + restart, zero errors "
        "expected",
        [
            ScenarioPhase("warm", 1.0),
            ScenarioPhase("kill", 2.0, action="kill_replica"),
            ScenarioPhase("after", 1.0),
        ],
    ),
    "freshness": Scenario(
        "freshness",
        "concept drift: the hot entity pool shifts mid-run while an "
        "online-refined delta publishes and hot-applies under load; "
        "zero errors expected (skew_shift + the freshness loop)",
        [
            ScenarioPhase("pool_a", 1.0, entity_pool=(0.0, 0.3)),
            ScenarioPhase(
                "drift", 1.5, entity_pool=(0.7, 1.0),
                action="publish_delta", action_at_frac=0.3,
            ),
            ScenarioPhase(
                "apply", 1.5, entity_pool=(0.7, 1.0),
                action="apply_delta", action_at_frac=0.25,
            ),
        ],
    ),
    "worker_kill": Scenario(
        "worker_kill",
        "a worker PROCESS is SIGKILLed mid-phase (process-mode serving); "
        "pipe EOF -> resubmission -> respawn, zero errors expected",
        [
            ScenarioPhase("warm", 1.0),
            ScenarioPhase("kill", 2.0, action="kill_worker"),
            ScenarioPhase("after", 1.0),
        ],
    ),
    "noisy_neighbor": Scenario(
        "noisy_neighbor",
        "an aggressor tenant bursts to rate_multiplier x its baseline "
        "(sized ~10x its quota) while a victim tenant holds steady; the "
        "aggressor sheds alone, the victim's p99 stays inside its SLO "
        "with zero failures.  Tenant-aware: the multiplier scales the "
        "AGGRESSOR only — replay via run_noisy_neighbor, never the "
        "tenant-blind run_scenario",
        [
            ScenarioPhase("baseline", 1.0),
            ScenarioPhase("burst", 2.0, rate_multiplier=10.0),
            ScenarioPhase("recovery", 1.0),
        ],
    ),
    "host_kill": Scenario(
        "host_kill",
        "a whole serving HOST dies mid-phase behind the FleetRouter "
        "(listener torn down abruptly; serving/fleet.py) and comes "
        "back later; the router marks it down, resubmits in-flight "
        "requests to peers, and re-admits it via reconnect probes — "
        "zero failed requests expected, the ReplicaSupervisor's gate "
        "one tier up",
        [
            ScenarioPhase("warm", 1.0),
            ScenarioPhase("kill", 2.0, action="kill_host"),
            ScenarioPhase(
                "recover", 1.0,
                action="restart_host", action_at_frac=0.1,
            ),
        ],
    ),
    "host_join_drain": Scenario(
        "host_join_drain",
        "fleet membership churns under load (cluster/membership.py): a "
        "cold host registers mid-phase and the MembershipWatcher joins "
        "it into the FleetRouter once its ready probe passes; later a "
        "veteran host drains — in-flight requests finish, new traffic "
        "re-spreads, the aggregator stops summing the departed host.  "
        "Zero failed requests expected through both transitions",
        [
            ScenarioPhase("warm", 1.0),
            ScenarioPhase("join", 1.5, action="join_host"),
            ScenarioPhase("drain", 1.5, action="drain_host"),
        ],
    ),
    "coordinator_failover": Scenario(
        "coordinator_failover",
        "the leader quota-coordinator replica is killed mid-phase "
        "(cluster/coordination.py): hosts ride the degrade-to-last-"
        "lease contract until a follower's leader lease claim wins, "
        "replays the grant journal, and resumes exact enforcement — "
        "failover within one lease TTL, over-admission bounded to one "
        "lease window, zero failed requests throughout",
        [
            ScenarioPhase("baseline", 1.5),
            ScenarioPhase("kill", 2.0, action="kill_coordinator"),
            ScenarioPhase(
                "recover", 1.5,
                action="restart_coordinator", action_at_frac=0.1,
            ),
        ],
    ),
    "quota_partition": Scenario(
        "quota_partition",
        "every host's LeaseClient loses its path to the "
        "QuotaCoordinator mid-phase (serving/fleet.py): hosts degrade "
        "to their LAST lease — never unlimited, never zero — so "
        "fleet-wide admission stays within one lease window of the "
        "budget; after heal, exact enforcement resumes.  Zero "
        "non-shed errors expected throughout",
        [
            ScenarioPhase("baseline", 1.5),
            ScenarioPhase("partition", 2.0, action="partition"),
            ScenarioPhase("heal", 1.5, action="heal"),
        ],
    ),
}


def run_scenario(
    submit: Callable,
    make_request: Callable,
    scenario: Scenario,
    base_rate_rps: float = 100.0,
    actions: Optional[dict] = None,
    timeout_s: float = 30.0,
    seed: int = 0,
) -> ScenarioReport:
    """Replay ``scenario`` phase by phase against ``submit``.

    ``make_request(i, phase)`` builds the i-th request of a phase (use
    ``phase.entity_pool`` for skew).  ``actions`` maps an action name to
    a zero-arg callable; a phase's action fires on a helper thread
    ``action_at_frac`` into the phase, so the load keeps flowing while
    the swap/kill happens — that concurrency is the whole point.  An
    action named by a phase but not wired raises ValueError up front
    (silently skipping it would report a scenario that never ran)."""
    actions = actions or {}
    for phase in scenario.phases:
        if phase.action is not None and phase.action not in actions:
            raise ValueError(
                f"scenario {scenario.name!r} phase {phase.name!r} needs "
                f"action {phase.action!r}; wire it via run_scenario("
                "actions={...})"
            )
    phase_reports: list = []
    action_results: dict = {}
    for pi, phase in enumerate(scenario.phases):
        action_thread = None
        if phase.action is not None:
            fn = actions[phase.action]
            delay = phase.duration_s * phase.action_at_frac

            def fire(fn=fn, delay=delay, key=phase.action):
                time.sleep(delay)
                try:
                    action_results[key] = fn()
                except Exception as exc:  # noqa: BLE001 — report, not crash
                    action_results[key] = (
                        f"ERROR {type(exc).__name__}: {exc}"
                    )

            action_thread = threading.Thread(
                target=fire, name=f"scenario-{phase.action}", daemon=True
            )
            action_thread.start()
        report = open_loop(
            submit,
            lambda i, phase=phase: make_request(i, phase),
            rate_rps=base_rate_rps * phase.rate_multiplier,
            duration_s=phase.duration_s,
            timeout_s=timeout_s,
            seed=seed + pi,
        )
        if action_thread is not None:
            action_thread.join(timeout=timeout_s)
        phase_reports.append((phase.name, report))
    return ScenarioReport(
        scenario=scenario.name,
        phases=phase_reports,
        actions=action_results,
    )


# ---------------------------------------------------------------------------
# Tenant-aware replay (the noisy_neighbor isolation proof)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TenantLoadReport:
    """One tenant's outcomes across a tenant-aware replay.

    ``shed`` counts admission-control verdicts (RejectedError — quota,
    bulkhead, tier, or breaker — whether raised at submit or delivered
    through the future, which is how process-mode rejections arrive);
    ``failed`` is everything else that isn't a completion.  The victim
    gate reads ``failed`` — a shed aggressor is the design working,
    a failed victim is the isolation story broken."""

    tenant: str
    completed: int
    shed: int
    failed: int
    latencies_ms: np.ndarray

    def percentile_ms(self, q: float) -> Optional[float]:
        if len(self.latencies_ms) == 0:
            return None
        hist = Histogram(threading.Lock())
        for v in self.latencies_ms:
            hist.observe(v)
        return float(hist.quantile(q / 100.0))

    def snapshot(self) -> dict:
        return {
            "tenant": self.tenant,
            "completed": self.completed,
            "shed": self.shed,
            "failed": self.failed,
            "latency_p50_ms": _round(self.percentile_ms(50)),
            "latency_p99_ms": _round(self.percentile_ms(99)),
        }


@dataclasses.dataclass
class NoisyNeighborReport:
    """Victim/aggressor outcomes of one noisy-neighbor replay."""

    scenario: str
    victim: TenantLoadReport
    aggressor: TenantLoadReport

    def isolation(self, victim_slo_ms: float) -> dict:
        """The containment gate: victim completed traffic with ZERO
        failures and a p99 inside its SLO, while the aggressor actually
        got shed (no sheds = the burst never pressured the quota and
        the run proved nothing)."""
        p99 = self.victim.percentile_ms(99)
        ok = (
            self.victim.failed == 0
            and self.victim.completed > 0
            and p99 is not None
            and p99 <= victim_slo_ms
            and self.aggressor.shed > 0
        )
        return {
            "pass": bool(ok),
            "victim_completed": self.victim.completed,
            "victim_failed": self.victim.failed,
            "victim_p99_ms": _round(p99),
            "victim_slo_ms": victim_slo_ms,
            "aggressor_completed": self.aggressor.completed,
            "aggressor_shed": self.aggressor.shed,
            "aggressor_failed": self.aggressor.failed,
        }

    def snapshot(self) -> dict:
        return {
            "scenario": self.scenario,
            "victim": self.victim.snapshot(),
            "aggressor": self.aggressor.snapshot(),
        }


class _TenantAcct:
    """Thread-safe per-tenant outcome accumulator."""

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.lock = threading.Lock()
        self.completed = 0
        self.shed = 0
        self.failed = 0
        self.latencies: list = []

    def report(self) -> TenantLoadReport:
        with self.lock:
            return TenantLoadReport(
                tenant=self.tenant,
                completed=self.completed,
                shed=self.shed,
                failed=self.failed,
                latencies_ms=np.asarray(self.latencies),
            )


def _tenant_open_loop(
    submit: Callable,
    make_request: Callable,
    phase: ScenarioPhase,
    tenant: str,
    rate_rps: float,
    acct: _TenantAcct,
    timeout_s: float,
    seed: int,
) -> None:
    """One tenant's Poisson arrival stream for one phase, classifying
    every outcome into ``acct`` (sync or via the future — process-mode
    rejections arrive as future exceptions)."""
    rng = np.random.default_rng(seed)
    pending: list = []

    def waiter(fut, t_sched: float) -> None:
        try:
            fut.result(timeout=timeout_s)
        except RejectedError:
            with acct.lock:
                acct.shed += 1
            return
        except Exception:  # noqa: BLE001 — loadgen counts, not raises
            with acct.lock:
                acct.failed += 1
            return
        lat = (time.perf_counter() - t_sched) * 1e3
        with acct.lock:
            acct.latencies.append(lat)
            acct.completed += 1

    t_start = time.perf_counter()
    t_next = t_start
    i = 0
    while t_next < t_start + phase.duration_s:
        now = time.perf_counter()
        if now < t_next:
            time.sleep(t_next - now)
        try:
            fut = submit(make_request(i, phase, tenant))
        except RejectedError:
            with acct.lock:
                acct.shed += 1
        except Exception:  # noqa: BLE001
            with acct.lock:
                acct.failed += 1
        else:
            t = threading.Thread(
                target=waiter, args=(fut, t_next), daemon=True
            )
            t.start()
            pending.append(t)
        i += 1
        t_next += float(rng.exponential(1.0 / rate_rps))
    for t in pending:
        t.join(timeout=timeout_s)


def run_noisy_neighbor(
    submit: Callable,
    make_request: Callable,
    victim: str = "victim",
    aggressor: str = "aggressor",
    victim_rate_rps: float = 40.0,
    aggressor_rate_rps: float = 40.0,
    scenario: Optional[Scenario] = None,
    timeout_s: float = 30.0,
    seed: int = 0,
) -> NoisyNeighborReport:
    """Replay the noisy-neighbor script: per phase, the victim offers
    ``victim_rate_rps`` and the aggressor offers ``aggressor_rate_rps *
    phase.rate_multiplier`` — the multiplier scales the AGGRESSOR only,
    so the burst phase is the aggressor alone going over quota while the
    victim's offered load never changes.  ``make_request(i, phase,
    tenant)`` must build a request carrying the tenant id.  Outcomes are
    classified per tenant (RejectedError = shed, any other
    non-completion = failed); gate the result with
    :meth:`NoisyNeighborReport.isolation`."""
    scenario = scenario or SCENARIOS["noisy_neighbor"]
    accts = {victim: _TenantAcct(victim), aggressor: _TenantAcct(aggressor)}
    for pi, phase in enumerate(scenario.phases):
        streams = [
            (victim, victim_rate_rps),
            (aggressor, aggressor_rate_rps * phase.rate_multiplier),
        ]
        threads = [
            threading.Thread(
                target=_tenant_open_loop,
                args=(
                    submit, make_request, phase, tenant, rate,
                    accts[tenant], timeout_s, seed + 7 * pi + ti,
                ),
                name=f"noisy-{phase.name}-{tenant}",
                daemon=True,
            )
            for ti, (tenant, rate) in enumerate(streams)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return NoisyNeighborReport(
        scenario=scenario.name,
        victim=accts[victim].report(),
        aggressor=accts[aggressor].report(),
    )


# ---------------------------------------------------------------------------
# Fleet-aware replay (host_kill / quota_partition, serving/fleet.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetScenarioReport:
    """Per-phase shed/failed-classified outcomes of a fleet replay.

    The host_kill gate reads the whole-run ``failed`` and ``shed``
    (both must be zero for an in-quota tenant: a dying host may delay
    a request, never fail or reject it); the quota_partition gate reads
    PER-PHASE ``completed`` against budget × phase duration (admitted
    rate within one lease window of the budget while partitioned,
    exact enforcement after heal) with ``failed == 0`` throughout —
    sheds there are the design working."""

    scenario: str
    tenant: str
    phases: list  # (phase_name, duration_s, offered_rps, TenantLoadReport)
    actions: dict  # action name -> result (or error string)

    @property
    def completed(self) -> int:
        return sum(r.completed for _, _, _, r in self.phases)

    @property
    def shed(self) -> int:
        return sum(r.shed for _, _, _, r in self.phases)

    @property
    def failed(self) -> int:
        return sum(r.failed for _, _, _, r in self.phases)

    def phase(self, name: str) -> TenantLoadReport:
        for pname, _, _, report in self.phases:
            if pname == name:
                return report
        raise KeyError(f"no phase {name!r} in {self.scenario}")

    def snapshot(self) -> dict:
        return {
            "scenario": self.scenario,
            "tenant": self.tenant,
            "completed": self.completed,
            "shed": self.shed,
            "failed": self.failed,
            "actions": self.actions,
            "phases": {
                name: dict(
                    report.snapshot(),
                    duration_s=_round(duration),
                    offered_rps=_round(offered),
                )
                for name, duration, offered, report in self.phases
            },
        }


def run_fleet_scenario(
    submit: Callable,
    make_request: Callable,
    scenario: Scenario,
    tenant: str = "acme",
    base_rate_rps: float = 120.0,
    actions: Optional[dict] = None,
    timeout_s: float = 30.0,
    seed: int = 0,
) -> FleetScenarioReport:
    """Replay a fleet scenario (host_kill / quota_partition) as ONE
    tenant's open-loop stream with shed/failed-classified outcomes.

    Same action contract as :func:`run_scenario` (unwired actions raise
    up front; actions fire on a helper thread mid-phase), but outcomes
    are accounted per phase through :class:`TenantLoadReport` so the
    gates can tell admission-control sheds (RejectedError, through the
    future or at submit) from real failures.  ``make_request(i, phase,
    tenant)`` must build a wire request carrying the tenant id."""
    actions = actions or {}
    for phase in scenario.phases:
        if phase.action is not None and phase.action not in actions:
            raise ValueError(
                f"scenario {scenario.name!r} phase {phase.name!r} needs "
                f"action {phase.action!r}; wire it via "
                "run_fleet_scenario(actions={...})"
            )
    phase_rows: list = []
    action_results: dict = {}
    for pi, phase in enumerate(scenario.phases):
        action_thread = None
        if phase.action is not None:
            fn = actions[phase.action]
            delay = phase.duration_s * phase.action_at_frac

            def fire(fn=fn, delay=delay, key=phase.action):
                time.sleep(delay)
                try:
                    action_results[key] = fn()
                except Exception as exc:  # noqa: BLE001 — report
                    action_results[key] = (
                        f"ERROR {type(exc).__name__}: {exc}"
                    )

            action_thread = threading.Thread(
                target=fire, name=f"fleet-{phase.action}", daemon=True
            )
            action_thread.start()
        acct = _TenantAcct(tenant)
        rate = base_rate_rps * phase.rate_multiplier
        _tenant_open_loop(
            submit, make_request, phase, tenant, rate, acct,
            timeout_s, seed + pi,
        )
        if action_thread is not None:
            action_thread.join(timeout=timeout_s)
        phase_rows.append(
            (phase.name, phase.duration_s, rate, acct.report())
        )
    return FleetScenarioReport(
        scenario=scenario.name,
        tenant=tenant,
        phases=phase_rows,
        actions=action_results,
    )


# ---------------------------------------------------------------------------
# HTTP submitter (wire A/B benchmarking)
# ---------------------------------------------------------------------------

class HttpSubmitter:
    """A ``submit(request) -> Future`` adapter that drives POST /score
    over HTTP with PERSISTENT connections — one keep-alive
    ``http.client.HTTPConnection`` per worker thread, so the measured
    numbers are the data plane (framing + parse + score), not TCP
    handshakes.

    ``wire_format="json"`` sends the JSON compatibility body;
    ``"binary"`` sends a serving/wire.py request frame and decodes the
    frame response — the A/B lever ``bench.py``'s
    ``_bench_serving_wire`` pulls.  Per-row errors come back as the
    same exceptions the in-process ``ScoringService.submit`` path
    raises (RejectedError / DeadlineExceededError), so the load
    generators count rejections identically either way.
    """

    def __init__(
        self,
        base_url: str,
        wire_format: str = "json",
        workers: int = 16,
        timeout_s: float = 30.0,
    ):
        if wire_format not in ("json", "binary"):
            raise ValueError(
                f"wire_format must be 'json' or 'binary', got "
                f"{wire_format!r}"
            )
        parsed = urllib.parse.urlparse(base_url)
        if not parsed.hostname:
            raise ValueError(f"base_url {base_url!r} has no host")
        self._host = parsed.hostname
        self._port = parsed.port or 80
        self.wire_format = wire_format
        self._timeout_s = timeout_s
        self._local = threading.local()
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="http-loadgen"
        )

    # -- per-thread connection ---------------------------------------------
    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._timeout_s
            )
            self._local.conn = conn
        return conn

    def _reset_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
        self._local.conn = None

    # -- one round-trip -----------------------------------------------------
    def _encode(self, request: dict) -> tuple:
        if self.wire_format == "binary":
            from photon_ml_tpu_torch.serving import wire

            return wire.encode_request([request]), wire.CONTENT_TYPE
        return (
            json.dumps({"rows": [request]}).encode(), "application/json"
        )

    def _call(self, request: dict) -> dict:
        body, ctype = self._encode(request)
        for attempt in (0, 1):
            conn = self._conn()
            try:
                conn.request("POST", "/score", body=body, headers={
                    "Content-Type": ctype,
                    "Content-Length": str(len(body)),
                })
                resp = conn.getresponse()
                raw = resp.read()
                break
            except (http.client.HTTPException, OSError):
                # A dropped keep-alive connection: reconnect once.
                self._reset_conn()
                if attempt:
                    raise
        resp_ctype = (resp.getheader("Content-Type") or "").split(";")[0]
        if resp_ctype == "application/x-photon-frame":
            from photon_ml_tpu_torch.serving import wire

            result = wire.decode_response(raw)[0]
        else:
            payload = json.loads(raw or b"{}")
            results = payload.get("results")
            if not results:
                raise RuntimeError(
                    payload.get("error") or f"HTTP {resp.status}"
                )
            result = results[0]
        if "error" in result:
            kind = result.get("kind")
            if kind == "rejected":
                raise RejectedError(result["error"])
            if kind == "deadline":
                raise DeadlineExceededError(result["error"])
            raise RuntimeError(result["error"])
        return result

    # -- loadgen surface ----------------------------------------------------
    def submit(self, request: dict):
        """Enqueue one request; returns a Future resolving to the
        result dict (or raising like ``ScoringService.submit``'s
        future)."""
        return self._pool.submit(self._call, request)

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "HttpSubmitter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
