"""Cluster control plane: coordination, discovery, distribution (port of
``photon_ml_tpu/cluster``; host code, framework-neutral).

The serving tier (``photon_ml_tpu_torch/serving``) scales out to N hosts
behind a :class:`~photon_ml_tpu_torch.serving.fleet.FleetRouter`, but three
pieces of its control plane assumed a single machine or a shared
filesystem.  This package removes those assumptions:

- **Replicated quota coordination** (``coordination.py``) — the
  :class:`~photon_ml_tpu_torch.serving.fleet.QuotaCoordinator` becomes N
  journal-backed :class:`CoordinatorReplica`\\ s under a leader lease;
  a coordinator kill fails over within one lease TTL, and the grant
  journal replay bounds over-admission to one lease window.
- **Service discovery** (``membership.py``) — hosts register with a
  :class:`MembershipRegistry` and heartbeat to stay in it; a
  :class:`MembershipWatcher` converges the FleetRouter (and the
  FleetAggregator's scrape set) onto the discovered membership, so
  ``join`` and ``drain`` are registry operations, not config edits.
- **Model distribution** (``distribution.py``) — a cold host pulls the
  newest committed snapshot publication over HTTP
  (:func:`cold_start`), verifies every byte against the manifest
  checksums, and catches up by deltas via :class:`RemoteApplier` with
  per-subscriber acks; no shared filesystem on the serving path.

``python -m photon_ml_tpu_torch.cluster --selfcheck [--device cpu]``
replays the 3-host drill (coordinator kill, host join + drain,
publication cold start) under open-loop load, its hosts scoring on the
card unless ``--device cpu`` — docs/serving.md "Cluster".
"""

from photon_ml_tpu_torch.cluster.coordination import (  # noqa: F401
    CoordinatorReplica,
    NotLeaderError,
    ReplicatedQuotaCoordinator,
)
from photon_ml_tpu_torch.cluster.distribution import (  # noqa: F401
    FetchError,
    PublicationClient,
    PublicationServer,
    RemoteApplier,
    cold_start,
)
from photon_ml_tpu_torch.cluster.membership import (  # noqa: F401
    HeartbeatAgent,
    MembershipRegistry,
    MembershipWatcher,
    RegistryClient,
)

__all__ = [
    "CoordinatorReplica",
    "FetchError",
    "HeartbeatAgent",
    "MembershipRegistry",
    "MembershipWatcher",
    "NotLeaderError",
    "PublicationClient",
    "PublicationServer",
    "RegistryClient",
    "RemoteApplier",
    "ReplicatedQuotaCoordinator",
    "cold_start",
]
