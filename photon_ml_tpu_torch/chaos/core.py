"""Deterministic fault injection: named sites, scripted plans (port of
``photon_ml_tpu/chaos/core.py``: the same site catalog, descriptions,
exception registry and refusal messages, so a plan either package
accepts the other accepts too).

A :class:`FaultPlan` — JSON-scriptable, so crash schedules live in test
files — names a site, an occurrence index, and what to inject (an
exception from a small registry, or a delay), and the plan replays
EXACTLY: occurrence counters are plan-local and thread-safe, so the same
plan against the same workload kills at the same boundary every time.

Every site of the catalog has a caller in the port, at the reference's
place: the serving and freshness sites (``serving.*``, ``publish.*``,
``online.step``, ``quota.lease``), the cluster control plane's
(``cluster.lease``/``heartbeat``/``fetch``), the training sites
(``prefetch.pack``/``transfer``, ``staging.put``/``decode``,
``streaming.carry_sync``/``cache_evict``, ``checkpoint.save``/``restore``,
``cd.iteration``, ``grid.point``, ``game.repack``, ``game.bucket_shard``,
``admm.consensus``, ``distributed.allreduce``) and the fleet aggregator's
``telemetry.scrape``.

Cost contract (mirrors the telemetry hub): with no plan installed,
every instrumented seam pays ONE module-global read + one branch
(:func:`maybe_fail`).

Usage::

    from photon_ml_tpu_torch import chaos

    plan = chaos.FaultPlan([
        chaos.FaultSpec(site="grid.point", at=1,
                        message="UNAVAILABLE: injected preemption"),
    ])
    with plan:
        ...  # the second grid-point boundary raises InjectedFault

    plan.fired  # -> [{"site": "grid.point", "occurrence": 1, ...}]

Exception messages default to watchdog-transient vocabulary
("UNAVAILABLE: ..."), so an injected fault exercises the SAME
classify/backoff/resume machinery a real lost device would.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Optional, Sequence

from photon_ml_tpu_torch import telemetry as telemetry_mod


class InjectedFault(RuntimeError):
    """An exception raised on purpose by an installed :class:`FaultPlan`.

    Default messages carry watchdog-transient markers so the injected
    fault rides the real recovery path; a plan can override the message
    to exercise the non-transient vocabulary instead."""


class InjectedDeviceLost(InjectedFault):
    """A chaos stand-in for the runtime losing its accelerator (an
    "UNAVAILABLE: ..." device error) — what the serving degraded-mode
    path and the training watchdog both classify as transient."""


#: Exception types a FaultSpec may name.  Deliberately small: injected
#: faults should either speak the watchdog vocabulary (InjectedFault /
#: InjectedDeviceLost with a gRPC-ish message) or be a plain stdlib type
#: a seam's own error handling already knows.
EXCEPTIONS = {
    "InjectedFault": InjectedFault,
    "InjectedDeviceLost": InjectedDeviceLost,
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "TimeoutError": TimeoutError,
    "ValueError": ValueError,
}


#: The fault-site catalog: every name ``maybe_fail`` is called with, and
#: what a fault there simulates.  Plans naming an unknown site are
#: refused at construction (a typo'd site would silently never fire and
#: the test would "pass" without killing anything).  docs/robustness.md
#: renders this table.
KNOWN_SITES = {
    "prefetch.pack": (
        "pack thread, before get_item(k): host materialization dies "
        "mid-stream (data/prefetch.py)"
    ),
    "prefetch.transfer": (
        "transfer thread, before put(item): the h2d dispatch path dies "
        "mid-stream (data/prefetch.py)"
    ),
    "staging.put": (
        "the staged device_put of one chunk's coalesced buffers "
        "(optim/streaming.py _put, on the transfer thread)"
    ),
    "streaming.carry_sync": (
        "consumer thread, before dispatching chunk k's program into the "
        "carry window (optim/streaming.py _stream_accumulate)"
    ),
    "staging.decode": (
        "consumer thread, before dispatching the in-program dequant "
        "step for a COMPRESSED item — only fires when a chunk codec is "
        "active (optim/streaming.py _stream_accumulate)"
    ),
    "streaming.cache_evict": (
        "the working-set cache's admission/eviction replan at pass end "
        "(optim/streaming.py HotChunkCache.replan) — the cache clears "
        "itself before the fault propagates, so the next pass streams "
        "everything and stays bitwise clean"
    ),
    "checkpoint.save": (
        "after the checkpoint tmp file is written+fsynced, BEFORE the "
        "atomic rename publishes it (io/checkpoint.py) — a kill here "
        "must leave the previous checkpoint intact"
    ),
    "checkpoint.restore": (
        "at restore entry, before the checkpoint file is opened "
        "(io/checkpoint.py)"
    ),
    "cd.iteration": (
        "GAME coordinate-descent iteration boundary, after that "
        "iteration's checkpoint save (game/descent.py)"
    ),
    "game.repack": (
        "cost-model entity repacker, before the bucket plan is built "
        "(game/data.py build_random_effect_dataset) — a kill here dies "
        "before any block exists; the rebuilt dataset must be bitwise "
        "identical to an uninterrupted build"
    ),
    "game.bucket_shard": (
        "hierarchical random-effect execution, before one device "
        "placement's bucket programs dispatch (game/hierarchical.py) — "
        "a kill here aborts the coordinate update mid-dispatch; the "
        "retried update must be bitwise identical to an uninterrupted "
        "one (per-bucket solves are pure functions of offsets)"
    ),
    "grid.point": (
        "λ-grid point boundary, after on_solved persisted the point "
        "(optim/problem.py grid_loop)"
    ),
    "serving.batch": (
        "batcher dispatch, before the runtime scores a batch "
        "(serving/batcher.py)"
    ),
    "serving.device": (
        "the device scoring kernel call (serving/runtime.py) — a fault "
        "here simulates a lost accelerator and must flip the runtime "
        "into degraded host-side scoring"
    ),
    "serving.replica": (
        "supervisor routing, before a request is handed to the chosen "
        "replica (serving/supervisor.py) — a fault here simulates that "
        "replica crashing; the supervisor must mark it down and "
        "re-route/resubmit with zero failed requests"
    ),
    "serving.worker": (
        "process-pool routing, before a request is framed to the chosen "
        "worker process (serving/procpool.py) — a fault here SIGKILLs "
        "the routed worker for real before raising, so the scripted "
        "crash exercises the actual death-mid-batch path: pipe EOF, "
        "transient failure of in-flight rows, supervisor resubmission "
        "with zero failed requests, jittered respawn"
    ),
    "serving.swap": (
        "model hot-swap critical section (serving/swap.py): touched at "
        "stage 'load' (before the background load), 'prepare' (loaded+"
        "warmed, before the atomic commit) and 'verify' (committed, "
        "before the post-swap probe) — a fault must abort or roll back "
        "with the previous version still serving"
    ),
    "tuning.trial": (
        "worker thread, before a tuning trial's fit runs "
        "(tuning/executor.py)"
    ),
    "publish.delta": (
        "delta publication boundaries (freshness/publisher.py): stage "
        "'journal' (begin record written, before the artifact staging "
        "dir), 'artifact' (artifact staged+digested, before the atomic "
        "rename publishes it) and 'commit' (artifact published, before "
        "the commit record) — a crash at any stage must resume exactly, "
        "never leaving a half-published artifact visible"
    ),
    "publish.apply": (
        "delta hot-apply critical section (serving/swap.py swap_delta): "
        "touched at stage 'load' (before the artifact is read+verified), "
        "'prepare' (patched runtime built, before the atomic commit) and "
        "'verify' (committed, before the post-apply probe) — a fault "
        "must roll back with the previous version still serving"
    ),
    "online.step": (
        "online refinement, before one entity's SGD/AdaGrad step "
        "(freshness/online.py) — a fault must abandon the refinement "
        "pass without corrupting the warm-start model or publishing a "
        "partial delta"
    ),
    "serving.tenant": (
        "dispatch thread, before a tenant-routed group scores against "
        "its tenant-scoped runtime (serving/batcher.py _dispatch; ctx: "
        "tenant, rows) — only fires for tenants with a committed "
        "tenant route, so a fault degrades exactly one tenant: its "
        "breaker opens and its traffic sheds while every other "
        "tenant's requests keep completing"
    ),
    "serving.host": (
        "fleet-router routing seam, after a host is picked but before "
        "the request goes over the wire (serving/fleet.py _route; ctx: "
        "host) — a fault is a HOST dying as it picks up the request: "
        "the router must mark the host DOWN, resubmit to a peer, and "
        "the client future must still resolve (zero failed requests, "
        "the host_kill scenario's gate)"
    ),
    "quota.lease": (
        "fleet lease renewal, before the LeaseClient reaches the "
        "QuotaCoordinator (serving/fleet.py poll_once; ctx: host) — a "
        "fault is a network partition from the coordinator: the host "
        "must degrade to its LAST granted lease (never unlimited, "
        "never zero), bounding fleet over-admission to one lease "
        "window (the quota_partition scenario's gate)"
    ),
    "telemetry.scrape": (
        "fleet aggregator scrape, before one host's /snapshot fetch "
        "(telemetry/fleet.py _scrape_host; ctx: host) — a fault is the "
        "host dropping off the network mid-scrape: the aggregator must "
        "degrade to the host's last-seen snapshot (counted in "
        "fleet_scrape_failures_total, aged by the staleness gauge) and "
        "keep folding every other host — the loop never wedges"
    ),
    "distributed.allreduce": (
        "a distributed solver's outer-iteration reduce seam, before the "
        "round's step program (and its all-reduce) dispatches "
        "(solvers/admm.py, solvers/block_cd.py; ctx: solver, outer) — a "
        "fault is a host dying at the collective: the watchdog re-enters "
        "the grid, the checkpoint warm-start chain replays the in-flight "
        "λ deterministically, and the resumed sweep is bitwise identical"
    ),
    "admm.consensus": (
        "consensus-ADMM z-update boundary, after outer iteration k's "
        "consensus variable (and adapted ρ) is computed "
        "(solvers/admm.py; ctx: solver, outer, rho) — a kill here lands "
        "between outer iterations; resume must replay the λ point to "
        "the SAME consensus trajectory (bitwise, the ISSUE 18 gate)"
    ),
    "cluster.lease": (
        "replicated-coordinator renewal, before a replica is attempted "
        "(cluster/coordination.py ReplicatedQuotaCoordinator.renew; "
        "ctx: host, replica) — a fault is the wire to THAT replica "
        "dying: the walk must move on to the next replica, and only an "
        "all-replica failure surfaces to the LeaseClient, which then "
        "degrades to its LAST lease (never unlimited, never zero)"
    ),
    "cluster.heartbeat": (
        "membership heartbeat, before the agent reaches the registry "
        "(cluster/membership.py HeartbeatAgent.beat_once; ctx: host) — "
        "a fault is the host partitioned from the registry: the beat "
        "fails (cluster_heartbeat_failures_total), the loop keeps "
        "trying, and a partition longer than the heartbeat TTL expires "
        "the host from membership until it re-registers"
    ),
    "cluster.fetch": (
        "publication blob fetch, before one file's HTTP GET "
        "(cluster/distribution.py PublicationClient._get_blob; ctx: "
        "seq, file) — a fault is the wire dying mid-distribution: the "
        "client retries (cluster_fetch_retries), an exhausted retry "
        "budget raises FetchError, and NOTHING half-fetched is ever "
        "visible at the final path (staging dir + atomic rename)"
    ),
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: fire at site ``site`` on occurrence ``at``
    (0-based, counted per plan per site), for ``count`` consecutive
    occurrences (-1 = every occurrence from ``at`` on).

    ``action`` is ``"raise"`` (build ``exception`` with ``message``) or
    ``"delay"`` (sleep ``delay_seconds`` then continue — for deadline /
    stall scenarios).  The default message speaks the watchdog's
    transient vocabulary and names the site, so logs and RetryStats say
    exactly which scripted fault fired.
    """

    site: str
    at: int = 0
    count: int = 1
    action: str = "raise"  # "raise" | "delay"
    exception: str = "InjectedFault"
    message: Optional[str] = None
    delay_seconds: float = 0.0

    def __post_init__(self):
        if self.site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known sites: "
                f"{sorted(KNOWN_SITES)}"
            )
        if self.action not in ("raise", "delay"):
            raise ValueError(
                f"action must be 'raise' or 'delay', got {self.action!r}"
            )
        if self.exception not in EXCEPTIONS:
            raise ValueError(
                f"unknown exception {self.exception!r}; registry: "
                f"{sorted(EXCEPTIONS)}"
            )
        if self.at < 0:
            raise ValueError(f"at must be >= 0, got {self.at}")
        if self.count < -1 or self.count == 0:
            raise ValueError(
                f"count must be positive or -1 (forever), got {self.count}"
            )

    def matches(self, occurrence: int) -> bool:
        if occurrence < self.at:
            return False
        if self.count == -1:
            return True
        return occurrence < self.at + self.count

    def build_exception(self, occurrence: int) -> BaseException:
        msg = self.message
        if msg is None:
            msg = (
                f"UNAVAILABLE: chaos-injected fault at site "
                f"{self.site!r} (occurrence {occurrence})"
            )
        return EXCEPTIONS[self.exception](msg)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(**d)


class FaultPlan:
    """A repeatable crash schedule: scripted faults + per-site occurrence
    counters + a log of what actually fired.

    Install with :meth:`install` / :meth:`uninstall` or as a context
    manager; only one plan may be installed at a time (two concurrent
    plans would race each other's occurrence counters and neither
    schedule would be deterministic).  Counters persist across
    uninstall/reinstall of the SAME plan object — that is what lets a
    kill/resume scenario arm "occurrence 1" once and have the resumed
    run sail past it.
    """

    def __init__(self, faults: Sequence[FaultSpec] = ()):
        self.faults = list(faults)
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        #: what fired, in order: {"site", "occurrence", "action", ...}
        self.fired: list[dict] = []

    # -- (de)serialization --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps([f.to_dict() for f in self.faults], indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        specs = json.loads(text)
        if not isinstance(specs, list):
            raise ValueError("a fault plan is a JSON list of fault specs")
        return cls([FaultSpec.from_dict(d) for d in specs])

    # -- installation -------------------------------------------------------
    def install(self) -> "FaultPlan":
        global _PLAN
        with _INSTALL_LOCK:
            if _PLAN is not None and _PLAN is not self:
                raise RuntimeError(
                    "another FaultPlan is already installed; uninstall it "
                    "first (concurrent plans would race occurrence "
                    "counters)"
                )
            _PLAN = self
        return self

    def uninstall(self) -> None:
        global _PLAN
        with _INSTALL_LOCK:
            if _PLAN is self:
                _PLAN = None

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -- observation --------------------------------------------------------
    def occurrences(self, site: str) -> int:
        """How many times ``site`` has been reached under this plan."""
        with self._lock:
            return self._counts.get(site, 0)

    def fired_at(self, site: str) -> list[dict]:
        with self._lock:
            return [f for f in self.fired if f["site"] == site]

    # -- the hot path (called via maybe_fail) --------------------------------
    def _hit(self, site: str, ctx: dict) -> None:
        with self._lock:
            occurrence = self._counts.get(site, 0)
            self._counts[site] = occurrence + 1
            spec = next(
                (f for f in self.faults
                 if f.site == site and f.matches(occurrence)),
                None,
            )
            if spec is None:
                return
            record = {
                "site": site,
                "occurrence": occurrence,
                "action": spec.action,
                **{k: telemetry_mod.json_safe(v) for k, v in ctx.items()},
            }
            self.fired.append(record)
        tel = telemetry_mod.current()
        tel.counter("chaos_faults_injected").inc()
        tel.event("chaos.fault", **record)
        if spec.action == "delay":
            time.sleep(spec.delay_seconds)
            return
        # Forensics before the kill: the flight-recorder ring is dumped
        # with the chaos.fault record just emitted as its LAST event, so
        # every fault-injection test doubles as a forensics test
        # (telemetry/recorder.py).  The event window at the moment of
        # injection is exactly what a real crash would have left behind.
        telemetry_mod.dump_flight_recorder(
            reason=f"chaos:{site}@{occurrence}"
        )
        raise spec.build_exception(occurrence)


_INSTALL_LOCK = threading.Lock()
_PLAN: Optional[FaultPlan] = None


def current_plan() -> Optional[FaultPlan]:
    """The installed plan, or None (the default, zero-cost state)."""
    return _PLAN


def maybe_fail(site: str, **ctx) -> None:
    """The instrumented seams' hook: a no-op unless a plan is installed.

    Disabled path = one global read + one branch (the whole cost
    contract); with a plan installed, the plan counts the occurrence
    and fires any matching scripted fault (raise or delay).  ``ctx``
    (chunk index, λ, trial id, ...) rides the injection log and the
    ``chaos.fault`` telemetry event — it is only touched when a fault
    actually fires.
    """
    plan = _PLAN
    if plan is None:
        return
    plan._hit(site, ctx)
