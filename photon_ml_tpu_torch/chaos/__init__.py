"""Deterministic fault injection + recovery primitives (port of
``photon_ml_tpu/chaos``; see core.py).

Public surface::

    chaos.maybe_fail(site, **ctx)   # the instrumented seams' hook
    chaos.FaultPlan / chaos.FaultSpec
    chaos.InjectedFault / chaos.InjectedDeviceLost
    chaos.CircuitBreaker            # closed -> open -> half-open probe
    chaos.KNOWN_SITES               # the fault-site catalog

``python -m photon_ml_tpu_torch.chaos --selfcheck`` runs the scripted
kill/resume/degrade scenarios end to end (see ``__main__.py``).
"""

from photon_ml_tpu_torch.chaos.breaker import (  # noqa: F401
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
)
from photon_ml_tpu_torch.chaos.core import (  # noqa: F401
    EXCEPTIONS,
    KNOWN_SITES,
    FaultPlan,
    FaultSpec,
    InjectedDeviceLost,
    InjectedFault,
    current_plan,
    maybe_fail,
)

__all__ = [
    "CLOSED",
    "HALF_OPEN",
    "OPEN",
    "CircuitBreaker",
    "EXCEPTIONS",
    "KNOWN_SITES",
    "FaultPlan",
    "FaultSpec",
    "InjectedDeviceLost",
    "InjectedFault",
    "current_plan",
    "maybe_fail",
]
