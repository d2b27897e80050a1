"""Online serving: micro-batched low-latency GLM / GAME scoring (port of
``photon_ml_tpu/serving``).

- :mod:`~photon_ml_tpu_torch.serving.kernels` — the scoring math shared by
  batch scoring (``GameTransformer`` / ``game_scoring_driver``) and the
  online runtime, including the padded-bucket margin program over the
  hand-written CUDA kernel ``csrc/serve_margins.cu``.
- :mod:`~photon_ml_tpu_torch.serving.runtime` — ``ScoringRuntime``: the
  kernel warmed at a ladder of padded batch-size buckets, a per-entity
  coefficient table with an LRU hot set resident on the card, host-side
  fallback gathers for the cold tail.
- :mod:`~photon_ml_tpu_torch.serving.batcher` — ``MicroBatcher``:
  bounded-queue request coalescing, admission tiers, deadlines,
  per-tenant bulkheads, quotas and breakers, the adaptive wait.
- :mod:`~photon_ml_tpu_torch.serving.service` — ``ScoringService``
  (in-process API) and a stdlib ``ThreadingHTTPServer`` endpoint
  (``/score`` JSON and binary, ``/reload``, ``/healthz``, ``/livez``,
  ``/readyz``, ``/stats``).
- :mod:`~photon_ml_tpu_torch.serving.swap` — ``HotSwapper``:
  zero-downtime model hot swap with verified one-step rollback.
- :mod:`~photon_ml_tpu_torch.serving.tenancy` — ``TenantSpec`` /
  ``TenancyConfig`` / ``TenantRouter``.
- :mod:`~photon_ml_tpu_torch.serving.wire` — the binary data plane, frame
  for frame the reference's.
- :mod:`~photon_ml_tpu_torch.serving.loadgen` /
  :mod:`~photon_ml_tpu_torch.serving.synthetic` — load generators and the
  synthetic workload.

The process and fleet tier:

- :mod:`~photon_ml_tpu_torch.serving.supervisor` — ``ReplicaSupervisor``:
  N replicas behind one listener, health probes, request resubmission,
  decorrelated-jitter restarts.
- :mod:`~photon_ml_tpu_torch.serving.procpool` /
  :mod:`~photon_ml_tpu_torch.serving.worker` /
  :mod:`~photon_ml_tpu_torch.serving.shm_model` /
  :mod:`~photon_ml_tpu_torch.serving.protocol` — crash-isolated worker
  PROCESSES (spawned, each with its own CUDA context) on one
  shared-memory model publication, framed over a socketpair.
- :mod:`~photon_ml_tpu_torch.serving.shm_ingress` — same-machine
  ingress over a shared-memory slot ring.
- :mod:`~photon_ml_tpu_torch.serving.fleet` — ``FleetRouter`` over N
  host endpoints and ``QuotaCoordinator`` / ``LeaseClient`` fleet quota
  leases.

Model deltas (``/reload?mode=delta``) come from
:mod:`photon_ml_tpu_torch.freshness`.

``python -m photon_ml_tpu_torch.serving --selfcheck --device cpu`` builds
a synthetic GAME model, serves concurrent HTTP requests, and verifies
batched results are bit-identical to single-request scoring.

Imports here are lazy: ``game.estimator`` imports ``serving.kernels``
(the shared scoring math), so the package root must not import modules
that import the estimator back.
"""

from __future__ import annotations

_LAZY = {
    "ScoringRuntime": ("photon_ml_tpu_torch.serving.runtime",
                       "ScoringRuntime"),
    "RuntimeConfig": ("photon_ml_tpu_torch.serving.runtime", "RuntimeConfig"),
    "MicroBatcher": ("photon_ml_tpu_torch.serving.batcher", "MicroBatcher"),
    "BatcherConfig": ("photon_ml_tpu_torch.serving.batcher", "BatcherConfig"),
    "RejectedError": ("photon_ml_tpu_torch.serving.batcher", "RejectedError"),
    "DeadlineExceededError": (
        "photon_ml_tpu_torch.serving.batcher", "DeadlineExceededError",
    ),
    "ScoringService": ("photon_ml_tpu_torch.serving.service",
                       "ScoringService"),
    "start_http_server": (
        "photon_ml_tpu_torch.serving.service", "start_http_server",
    ),
    "TenancyConfig": ("photon_ml_tpu_torch.serving.tenancy", "TenancyConfig"),
    "TenantSpec": ("photon_ml_tpu_torch.serving.tenancy", "TenantSpec"),
    "TenantRouter": ("photon_ml_tpu_torch.serving.tenancy", "TenantRouter"),
    "HotSwapper": ("photon_ml_tpu_torch.serving.swap", "HotSwapper"),
    "SwapResult": ("photon_ml_tpu_torch.serving.swap", "SwapResult"),
    "SwapInProgressError": (
        "photon_ml_tpu_torch.serving.swap", "SwapInProgressError",
    ),
    "WireFormatError": ("photon_ml_tpu_torch.serving.wire",
                        "WireFormatError"),
    "HttpSubmitter": ("photon_ml_tpu_torch.serving.loadgen", "HttpSubmitter"),
    "ReplicaSupervisor": (
        "photon_ml_tpu_torch.serving.supervisor", "ReplicaSupervisor",
    ),
    "WorkerPool": ("photon_ml_tpu_torch.serving.procpool", "WorkerPool"),
    "ProcessReplica": ("photon_ml_tpu_torch.serving.procpool",
                       "ProcessReplica"),
    "ModelMapError": ("photon_ml_tpu_torch.serving.shm_model",
                      "ModelMapError"),
    "FleetRouter": ("photon_ml_tpu_torch.serving.fleet", "FleetRouter"),
    "FleetBudget": ("photon_ml_tpu_torch.serving.fleet", "FleetBudget"),
    "QuotaCoordinator": ("photon_ml_tpu_torch.serving.fleet",
                         "QuotaCoordinator"),
    "LeaseClient": ("photon_ml_tpu_torch.serving.fleet", "LeaseClient"),
    "LocalHost": ("photon_ml_tpu_torch.serving.fleet", "LocalHost"),
    "ShmIngress": ("photon_ml_tpu_torch.serving.shm_ingress", "ShmIngress"),
    "ShmIngressClient": ("photon_ml_tpu_torch.serving.shm_ingress",
                         "ShmIngressClient"),
    "ShmIngressError": ("photon_ml_tpu_torch.serving.shm_ingress",
                        "ShmIngressError"),
    "SyntheticWorkload": ("photon_ml_tpu_torch.serving.synthetic",
                          "SyntheticWorkload"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(entry[0]), entry[1])
