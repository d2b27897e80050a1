"""Replicated quota coordination: leader-lease failover for the fleet
quota tier (port of ``photon_ml_tpu/cluster/coordination.py``; host code,
copied, the same journal and leader-file formats).

A bare :class:`~photon_ml_tpu_torch.serving.fleet.QuotaCoordinator` is one
object in one process: its death freezes rebalancing until an operator
notices (hosts ride the degrade-to-last-lease contract, so admission
stays bounded — but it stays FROZEN).  This module makes the
coordinator a replicated service with bounded failover:

- :class:`CoordinatorReplica` — one coordinator replica over a SHARED
  store directory.  Exactly one replica is leader at a time, elected
  through a leader-lease file (``leader.json``: atomic
  write-temp + fsync + rename, then read-back to confirm — the same
  discipline every journal in this package uses).  The leader answers
  ``renew`` by delegating to an inner ``QuotaCoordinator`` and
  JOURNALS every grant batch (``coordinator_journal.jsonl``,
  tuning/state.py fsync discipline) BEFORE the lease is returned;
  followers refuse with :class:`NotLeaderError` naming the leader.
- **Failover**: when the leader dies, its leader lease stops being
  renewed and expires after ``leader_ttl_s`` (default: half the quota
  lease TTL).  The next ``renew`` that reaches any live replica
  acquires the lease with a bumped term and REPLAYS the journal —
  seeding its grant table with the dead leader's outstanding grants
  (``QuotaCoordinator.restore_grant``) so the new leader's budget
  arithmetic never double-grants a slice that is still live on a
  host.  Total takeover time is bounded by ``leader_ttl_s`` + one
  host renew interval ≈ one quota lease TTL; meanwhile hosts degrade
  to their last lease, so over-admission stays within one lease
  window — the SAME bound a coordinator partition already has.
- :class:`ReplicatedQuotaCoordinator` — the host-facing client: same
  duck type as ``QuotaCoordinator`` (``renew`` + ``lease_ttl_s``), so
  ``LeaseClient`` composes unchanged.  Each renewal walks the replica
  set starting at the last known leader, follows ``NotLeaderError``
  hints, and raises UNAVAILABLE only when NO replica will serve — at
  which point the lease client degrades exactly as today.

Chaos seam: ``cluster.lease`` fires per replica attempt inside the
client (a fault is that replica unreachable — the client fails over;
every replica faulted is the full partition).  Metric family:
``cluster_*``.  docs/serving.md "Cluster" has the TTL math.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.io.checkpoint import fsync_file
from photon_ml_tpu_torch.serving.fleet import QuotaCoordinator


class NotLeaderError(RuntimeError):
    """A follower replica refusing ``renew``; ``leader_hint`` names the
    replica id currently holding the leader lease (None when the lease
    is expired and the refusing replica lost the acquire race)."""

    def __init__(self, message: str, leader_hint: Optional[str] = None):
        super().__init__(message)
        self.leader_hint = leader_hint


LEADER_FILE = "leader.json"
JOURNAL_FILE = "coordinator_journal.jsonl"

#: Journal compaction threshold: past this many records the journal is
#: rewritten to the latest grant per (tenant, host) + the election
#: high-water — the replay state, nothing else.
_COMPACT_AFTER = 4096


class CoordinatorReplica:
    """One quota-coordinator replica over a shared ``store_dir``.

    All liveness bookkeeping rides the injectable monotonic ``clock``
    shared by the replica set (one process today; a shared clock
    service later — the election algebra does not change).  ``kill()``
    makes the replica refuse everything (the scripted coordinator
    crash); ``restart()`` brings it back as a FOLLOWER — it may win
    the next election, but never resumes a stale term."""

    def __init__(
        self,
        replica_id: str,
        store_dir: str,
        budgets,
        lease_ttl_s: float = 1.0,
        leader_ttl_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        fsync: bool = True,
    ):
        self.replica_id = str(replica_id)
        self.store_dir = store_dir
        self.lease_ttl_s = float(lease_ttl_s)
        #: leader-lease TTL: half the quota lease TTL by default, so
        #: leader expiry + one renew interval stays within ONE quota
        #: lease window (the failover bound in docs/serving.md).
        self.leader_ttl_s = (
            self.lease_ttl_s / 2.0
            if leader_ttl_s is None else float(leader_ttl_s)
        )
        self._budgets = budgets
        self._clock = clock
        self.fsync = fsync
        self.killed = False
        self.term = 0
        self.elections = 0
        self.renewals = 0
        self._coordinator: Optional[QuotaCoordinator] = None
        self._f = None
        self._written = 0
        self._lock = sanitizers.tracked(
            threading.Lock(), f"cluster.coordinator.{self.replica_id}"
        )
        os.makedirs(store_dir, exist_ok=True)
        self._leader_path = os.path.join(store_dir, LEADER_FILE)
        self._journal_path = os.path.join(store_dir, JOURNAL_FILE)

    # -- leader lease -------------------------------------------------------
    def _read_leader(self) -> Optional[dict]:
        try:
            with open(self._leader_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            # A torn leader file is an expired lease: the writer died
            # mid-rename-window; the next acquire overwrites it.
            return None

    def _write_leader(self, record: dict) -> None:
        # Caller holds self._lock.  Atomic + durable, then READ BACK:
        # last-writer-wins between racing replicas, and the read-back
        # means a replica only believes an election it can see on disk.
        tmp = self._leader_path + f".{self.replica_id}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
            if self.fsync:
                fsync_file(f)
        os.replace(tmp, self._leader_path)

    def _ensure_leader(self, now: float) -> None:
        # Caller holds self._lock.  Raises NotLeaderError / RuntimeError
        # unless this replica holds (or just acquired) the leader lease.
        if self.killed:
            raise RuntimeError(
                f"UNAVAILABLE: coordinator replica {self.replica_id} "
                "is down"
            )
        current = self._read_leader()
        holder = None if current is None else current.get("leader")
        expired = (
            current is None
            or float(current.get("expires_at", 0.0)) <= now
        )
        if holder == self.replica_id and not expired:
            # Renew our own lease past half-TTL so a busy leader never
            # lets it lapse between renews.
            if float(current["expires_at"]) - now < self.leader_ttl_s / 2:
                current["expires_at"] = now + self.leader_ttl_s
                self._write_leader(current)
            return
        if not expired:
            raise NotLeaderError(
                f"replica {self.replica_id} is not the leader "
                f"(leader: {holder}, term {current.get('term')})",
                leader_hint=str(holder),
            )
        # Expired or vacant: try to take it.
        term = (0 if current is None else int(current.get("term", 0))) + 1
        self._write_leader({
            "leader": self.replica_id,
            "term": term,
            "expires_at": now + self.leader_ttl_s,
        })
        confirmed = self._read_leader()
        if confirmed is None or confirmed.get("leader") != self.replica_id:
            raise NotLeaderError(
                f"replica {self.replica_id} lost the acquire race "
                f"(winner: {None if confirmed is None else confirmed.get('leader')})",
                leader_hint=(
                    None if confirmed is None
                    else str(confirmed.get("leader"))
                ),
            )
        self._become_leader_locked(int(confirmed["term"]))

    def _become_leader_locked(self, term: int) -> None:
        # Caller holds self._lock.  Fresh coordinator seeded from the
        # journal: the previous leader's outstanding grants are the
        # starting budget arithmetic, not an empty table.
        self.term = term
        self.elections += 1
        coordinator = QuotaCoordinator(
            self._budgets, lease_ttl_s=self.lease_ttl_s,
            clock=self._clock,
        )
        replayed = 0
        for host, leases in self._replay_grants().items():
            for tenant, g in leases.items():
                coordinator.restore_grant(
                    tenant, host,
                    rate_rps=g["rate"],
                    demand_rps=g["demand"],
                    expires_at=g["expires_at"],
                )
                replayed += 1
        self._coordinator = coordinator
        self._append({
            "kind": "election",
            "term": term,
            "leader": self.replica_id,
            "replayed_grants": replayed,
            "wall_epoch": time.time(),
        })
        tel = telemetry_mod.current()
        tel.counter("cluster_elections_total").inc()
        tel.gauge("cluster_leader_term_count").set(term)
        tel.event(
            "cluster.leader_elected",
            replica=self.replica_id, term=term,
            replayed_grants=replayed,
        )

    # -- journal (tuning/state.py discipline) -------------------------------
    def _append(self, record: dict) -> None:
        # Caller holds self._lock.
        if self._f is None:
            self._f = open(self._journal_path, "a")
        self._f.write(json.dumps(record) + "\n")
        if self.fsync:
            fsync_file(self._f)
        else:
            self._f.flush()
        self._written += 1
        if self._written >= _COMPACT_AFTER:
            self._compact_locked()

    def _read_journal(self) -> List[dict]:
        # Caller holds self._lock.  Torn-tail tolerant.
        if not os.path.exists(self._journal_path):
            return []
        if self._f is not None:
            self._f.flush()
        with open(self._journal_path) as f:
            lines = f.read().splitlines()
        records = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break  # torn tail: the write died mid-line
                raise
        return records

    def _replay_grants(self) -> Dict[str, dict]:
        # Caller holds self._lock.  Latest grant batch per host wins
        # (records are append-ordered).
        grants: Dict[str, dict] = {}
        for r in self._read_journal():
            if r.get("kind") == "grants":
                grants[str(r["host"])] = r["leases"]
        return grants

    def _compact_locked(self) -> None:
        # Caller holds self._lock.  Keep exactly the replay state: the
        # newest election record + the latest grant batch per host.
        records = self._read_journal()
        elections = [r for r in records if r.get("kind") == "election"]
        latest: Dict[str, dict] = {}
        for r in records:
            if r.get("kind") == "grants":
                latest[str(r["host"])] = r
        compacted = elections[-1:] + [
            latest[h] for h in sorted(latest)
        ]
        if self._f is not None:
            self._f.close()
            self._f = None
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w") as f:
            for r in compacted:
                f.write(json.dumps(r) + "\n")
            if self.fsync:
                fsync_file(f)
        os.replace(tmp, self._journal_path)
        self._written = len(compacted)

    # -- the coordinator surface -------------------------------------------
    def renew(
        self, host_id: str, demands: Optional[dict] = None
    ) -> dict:
        """Leader: delegate to the inner coordinator, JOURNAL the grant
        batch, then return it — a grant is never live on a host without
        being durable first, so a failover replay can only be a
        superset of what hosts actually hold (over-admission bounded by
        the lease window, never unbounded).  Follower: refuse with the
        leader hint.  Killed: UNAVAILABLE."""
        now = self._clock()
        with self._lock:
            self._ensure_leader(now)
            leases = self._coordinator.renew(host_id, demands)
            self._append({
                "kind": "grants",
                "term": self.term,
                "host": str(host_id),
                "wall_epoch": time.time(),
                "leases": {
                    tenant: {
                        "rate": lease.rate_rps,
                        "demand": float((demands or {}).get(tenant, 0.0)),
                        "expires_at": lease.expires_at,
                    }
                    for tenant, lease in leases.items()
                },
            })
            self.renewals += 1
        return leases

    def is_leader(self) -> bool:
        now = self._clock()
        with self._lock:
            if self.killed:
                return False
            current = self._read_leader()
            return (
                current is not None
                and current.get("leader") == self.replica_id
                and float(current.get("expires_at", 0.0)) > now
            )

    # -- scripted failure ---------------------------------------------------
    def kill(self) -> None:
        """The scripted coordinator crash: refuse everything, drop the
        journal handle.  The leader lease is deliberately NOT released
        — a crashed leader cannot clean up after itself; failover must
        ride the lease expiry, which is exactly what the drill
        measures."""
        with self._lock:
            self.killed = True
            self._coordinator = None
            if self._f is not None:
                self._f.close()
                self._f = None
        telemetry_mod.current().event(
            "cluster.coordinator_killed", replica=self.replica_id,
        )

    def restart(self) -> "CoordinatorReplica":
        with self._lock:
            self.killed = False
        telemetry_mod.current().event(
            "cluster.coordinator_restarted", replica=self.replica_id,
        )
        return self

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "replica_id": self.replica_id,
                "killed": self.killed,
                "term": self.term,
                "elections": self.elections,
                "renewals": self.renewals,
                "leader_ttl_s": self.leader_ttl_s,
                "lease_ttl_s": self.lease_ttl_s,
            }


class ReplicatedQuotaCoordinator:
    """Host-facing client over N :class:`CoordinatorReplica`\\ s.

    Duck-types ``QuotaCoordinator`` (``renew`` + ``lease_ttl_s``), so
    ``LeaseClient``/``attach_lease_client`` compose unchanged.  A
    renewal walks the replica set starting from the last known leader,
    follows :class:`NotLeaderError` hints, and surfaces UNAVAILABLE
    only when every replica refused — the lease client then degrades
    to the last lease, the standing partition contract."""

    def __init__(self, replicas: List[CoordinatorReplica]):
        if not replicas:
            raise ValueError(
                "ReplicatedQuotaCoordinator needs at least one replica"
            )
        ttls = {r.lease_ttl_s for r in replicas}
        if len(ttls) != 1:
            raise ValueError(
                f"replicas disagree on lease_ttl_s: {sorted(ttls)} — "
                "one replica set, one TTL"
            )
        self.replicas = list(replicas)
        self.lease_ttl_s = replicas[0].lease_ttl_s
        self._lock = sanitizers.tracked(
            threading.Lock(), "cluster.replicated_coordinator"
        )
        self._leader_id: Optional[str] = None
        self.renewals = 0
        self.failovers = 0

    def _attempt_order(self) -> List[CoordinatorReplica]:
        with self._lock:
            leader_id = self._leader_id
        ordered = sorted(
            self.replicas,
            key=lambda r: (r.replica_id != leader_id, r.replica_id),
        )
        return ordered

    def renew(
        self, host_id: str, demands: Optional[dict] = None
    ) -> dict:
        tel = telemetry_mod.current()
        errors: List[str] = []
        remaining = self._attempt_order()
        while remaining:
            replica = remaining.pop(0)
            try:
                # The partition seam, PER REPLICA: a fault here is this
                # host losing its path to this one replica — the walk
                # continues; every replica faulted is the full
                # partition (docs/robustness.md).
                chaos_mod.maybe_fail(
                    "cluster.lease",
                    host=str(host_id), replica=replica.replica_id,
                )
                leases = replica.renew(host_id, demands)
            except NotLeaderError as exc:
                errors.append(
                    f"{replica.replica_id}: not leader "
                    f"(hint: {exc.leader_hint})"
                )
                if exc.leader_hint is not None:
                    # Follow the hint: try the named leader next.
                    hinted = next(
                        (r for r in remaining
                         if r.replica_id == exc.leader_hint),
                        None,
                    )
                    if hinted is not None:
                        remaining.remove(hinted)
                        remaining.insert(0, hinted)
                continue
            except Exception as exc:  # noqa: BLE001 — walk on
                errors.append(
                    f"{replica.replica_id}: "
                    f"{type(exc).__name__}: {exc}"[:120]
                )
                continue
            with self._lock:
                previous = self._leader_id
                self._leader_id = replica.replica_id
                self.renewals += 1
                if previous is not None and \
                        previous != replica.replica_id:
                    self.failovers += 1
                    failover_from = previous
                else:
                    failover_from = None
            tel.counter("cluster_renewals_total").inc()
            if failover_from is not None:
                tel.counter("cluster_failovers_total").inc()
                tel.event(
                    "cluster.coordinator_failover",
                    new_leader=replica.replica_id,
                    old_leader=failover_from,
                )
            return leases
        raise RuntimeError(
            "UNAVAILABLE: no coordinator replica would renew "
            f"({'; '.join(errors)})"
        )

    def leader(self) -> Optional[str]:
        with self._lock:
            return self._leader_id

    def stats(self) -> dict:
        with self._lock:
            leader_id = self._leader_id
        return {
            "leader": leader_id,
            "renewals": self.renewals,
            "failovers": self.failovers,
            "lease_ttl_s": self.lease_ttl_s,
            "replicas": [r.stats() for r in self.replicas],
        }
