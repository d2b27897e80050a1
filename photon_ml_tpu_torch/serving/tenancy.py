"""Tenancy primitives: per-tenant isolation for the serving stack (port of
``photon_ml_tpu/serving/tenancy.py``, copied).

ROADMAP item 3's multi-tenant half, in the hierarchical-isolation shape
of Snap ML (arXiv:1803.06333): every level of the serving stack gets a
per-tenant boundary so overload and failure are contained where they
originate instead of shed onto neighbors.

- :class:`TenantSpec` / :class:`TenancyConfig` — the declarative
  contract per tenant: token-bucket quota, bulkhead queue partition,
  tiered-admission watermarks, p99 SLO, and circuit-breaker knobs.
  Frozen and picklable: the config rides ``BatcherConfig`` into spawned
  worker processes unchanged, so thread- and process-mode admission run
  the SAME policy (serving/worker.py).
- :class:`TokenBucket` — the quota primitive: refill at ``rate_rps``
  up to ``burst``, one token per admitted request.  ``rate_rps=None``
  is unlimited; ``rate_rps=0`` admits nothing (a suspended tenant).
  NOT internally locked — the batcher mutates it under its tenancy
  lock; the injectable clock keeps tests sleep-free (the same
  discipline as chaos/breaker.py).
- :class:`TenantRouter` — the tenant → model-version view on top of
  the :class:`~photon_ml_tpu_torch.serving.swap.HotSwapper` monotone version
  registry: per-tenant hot swap and one-step rollback, with unknown
  tenants following the default route (the swapper's ``version``).

The enforcement half — bulkhead partitions, per-tenant admission tiers,
per-tenant breakers, tenant-routed dispatch, and the per-tenant
``serving_tenant_<t>_request_latency_seconds`` metric family — lives in
``serving/batcher.py``; the chaos seam is ``serving.tenant``
(docs/robustness.md), and the proof is the ``noisy_neighbor`` loadgen
scenario (serving/loadgen.py): an aggressor at 10x quota sheds only its
own traffic while a victim's p99 holds inside its SLO with zero failed
requests.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Optional

#: metric-family component derived from a tenant name; anything outside
#: [a-z0-9_] folds to "_" so dynamic names stay convention-shaped
#: (<subsystem>_<name>_<unit>, docs/telemetry.md).
_SLUG_RE = re.compile(r"[^a-z0-9_]+")


def tenant_slug(name: str) -> str:
    """Sanitize a tenant name into a metric-name component."""
    slug = _SLUG_RE.sub("_", str(name).lower()).strip("_")
    return slug or "tenant"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's isolation contract (all enforcement is per
    MicroBatcher — i.e. per replica/worker; a pool of N replicas gives
    the tenant ~N× these budgets in aggregate, see docs/serving.md)."""

    name: str
    #: sustained admission rate (token-bucket refill).  None = no quota;
    #: 0.0 = zero-quota tenant, every non-probe request is shed.
    quota_rps: Optional[float] = None
    #: bucket capacity in tokens (how big a burst admits at once);
    #: defaults to max(quota_rps, 1).
    burst: Optional[float] = None
    #: bulkhead partition depth: the most rows this tenant may hold
    #: queued in one batcher.  Its burst fills THIS, never a
    #: neighbor's share of the queue.
    max_queue: int = 64
    #: partition-depth fraction where tier 1 (shed low-priority /
    #: over-deadline rows) engages for this tenant alone.
    shed_watermark: float = 0.5
    #: partition-depth fraction where tier 2 (reject everything but
    #: probes) engages for this tenant alone.
    reject_watermark: float = 0.9
    #: per-tenant latency SLO: an observed per-tenant p99 above this
    #: escalates THIS tenant's admission to at least tier 1.
    p99_slo_ms: Optional[float] = None
    #: circuit-breaker knobs (chaos/breaker.py): consecutive scoring
    #: failures on this tenant's model path trip the breaker, and the
    #: tenant degrades alone while the cooldown runs.
    breaker_cooldown_s: float = 5.0
    breaker_failure_threshold: int = 3

    def __post_init__(self):
        if not str(self.name):
            raise ValueError("tenant name must be non-empty")
        if self.quota_rps is not None and self.quota_rps < 0:
            raise ValueError(
                f"quota_rps must be >= 0 or None, got {self.quota_rps}"
            )
        if self.burst is not None and self.burst <= 0:
            raise ValueError(f"burst must be > 0, got {self.burst}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if not (0.0 < self.shed_watermark <= self.reject_watermark <= 1.0):
            raise ValueError(
                "need 0 < shed_watermark <= reject_watermark <= 1, got "
                f"{self.shed_watermark} / {self.reject_watermark}"
            )
        if self.breaker_cooldown_s < 0:
            raise ValueError(
                f"breaker_cooldown_s must be >= 0, got "
                f"{self.breaker_cooldown_s}"
            )
        if self.breaker_failure_threshold < 1:
            raise ValueError(
                f"breaker_failure_threshold must be >= 1, got "
                f"{self.breaker_failure_threshold}"
            )

    @property
    def slug(self) -> str:
        return tenant_slug(self.name)

    @property
    def effective_burst(self) -> float:
        if self.burst is not None:
            return float(self.burst)
        if self.quota_rps is None:
            return 1.0  # unused: no quota means no bucket draw
        return max(float(self.quota_rps), 1.0)


@dataclasses.dataclass(frozen=True)
class TenancyConfig:
    """The full tenancy policy one serving unit enforces.

    ``tenants`` declares the named tenants (each with its own bulkhead
    partition, quota, tiers, SLO, and breaker); every request whose
    tenant id is unknown — or absent — shares the ``default`` spec's
    partition and budgets, so an unregistered tenant can never starve a
    registered one."""

    tenants: tuple = ()
    default: TenantSpec = dataclasses.field(
        default_factory=lambda: TenantSpec(name="default")
    )

    def __post_init__(self):
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        slugs = [t.slug for t in self.tenants] + [self.default.slug]
        if len(set(slugs)) != len(slugs):
            raise ValueError(
                f"tenant names collide after metric-slug folding: {slugs}"
            )

    def spec_for(self, tenant: Optional[str]) -> TenantSpec:
        """The governing spec: the named tenant's, else the default."""
        if tenant is not None:
            for t in self.tenants:
                if t.name == tenant:
                    return t
        return self.default

    def is_known(self, tenant: Optional[str]) -> bool:
        return any(t.name == tenant for t in self.tenants)

    @property
    def partition_total(self) -> int:
        """Aggregate bulkhead capacity — what the physical queue must
        hold so no tenant's burst can consume a neighbor's slots."""
        return sum(t.max_queue for t in self.tenants) + self.default.max_queue


class TokenBucket:
    """Classic token bucket with injectable clock; caller-locked."""

    def __init__(
        self,
        rate_rps: Optional[float],
        burst: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.rate_rps = rate_rps
        self.burst = float(burst)
        self._clock = clock
        self._tokens = self.burst
        self._refill_t = clock()
        self.admitted = 0
        self.denied = 0

    def try_acquire(self, n: float = 1.0) -> bool:
        """Take ``n`` tokens if available; never blocks."""
        if self.rate_rps is None:
            self.admitted += 1
            return True
        if self.rate_rps <= 0:
            # Zero-quota (suspended) tenant: nothing admits, not even
            # the initial burst fill.
            self.denied += 1
            return False
        now = self._clock()
        elapsed = max(0.0, now - self._refill_t)
        self._refill_t = now
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate_rps)
        if self._tokens >= n:
            self._tokens -= n
            self.admitted += 1
            return True
        self.denied += 1
        return False

    @property
    def tokens(self) -> float:
        return self._tokens

    def reset_rate(
        self, rate_rps: Optional[float], burst: Optional[float] = None
    ) -> None:
        """Re-rate the bucket in place (quota lease updates,
        serving/fleet.py).  Tokens only ever CLAMP down to the new
        burst, never refill up — a lease shrink takes effect on the
        very next acquire, and a grow never mints admission credit the
        old rate did not earn."""
        if rate_rps is not None and rate_rps < 0:
            raise ValueError(f"rate_rps must be >= 0 or None, got {rate_rps}")
        if burst is not None:
            if burst <= 0:
                raise ValueError(f"burst must be > 0, got {burst}")
            self.burst = float(burst)
        self.rate_rps = rate_rps
        self._tokens = min(self._tokens, self.burst)

    def snapshot(self) -> dict:
        return {
            "rate_rps": self.rate_rps,
            "burst": self.burst,
            "tokens": round(self._tokens, 3),
            "admitted": self.admitted,
            "denied": self.denied,
        }


class TenantRouter:
    """Tenant → model version on top of the HotSwapper registry.

    The swapper owns the actual route state and the swap/rollback state
    machine (tenant swaps share its monotone version sequence and its
    serialization lock); this facade resolves a tenant id to the route
    that WILL score it — a tenant-scoped version when one was committed,
    else the default route every unknown tenant follows."""

    def __init__(self, swapper):
        self._swapper = swapper

    def route(self, tenant: Optional[str] = None) -> dict:
        routes = self._swapper.tenant_versions()
        if tenant is not None and tenant in routes:
            version, path = routes[tenant]
            return {
                "tenant": tenant, "version": version,
                "model_path": path, "default_route": False,
            }
        return {
            "tenant": tenant,
            "version": self._swapper.version,
            "model_path": self._swapper.model_path,
            "default_route": True,
        }

    def routes(self) -> dict:
        """Every committed tenant route plus the default."""
        out = {
            t: {"version": v, "model_path": p, "default_route": False}
            for t, (v, p) in self._swapper.tenant_versions().items()
        }
        out["*default*"] = {
            "version": self._swapper.version,
            "model_path": self._swapper.model_path,
            "default_route": True,
        }
        return out

    def swap(self, tenant: str, model_path: str, runtime_config=None):
        """Hot-swap ONE tenant onto a new model version; every other
        tenant's route (and the default) is untouched."""
        return self._swapper.swap(
            model_path, runtime_config, tenant=tenant
        )

    def rollback(self, tenant: str):
        """One-step rollback of a tenant route (back to its previous
        version, or to the default route if this was its first swap)."""
        return self._swapper.rollback(tenant=tenant)

    def stats(self) -> dict:
        return {"routes": self.routes()}
