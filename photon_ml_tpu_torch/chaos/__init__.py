"""Recovery primitives (port of ``photon_ml_tpu/chaos``): so far the
circuit breaker that guards the serving runtime's re-promotion.  The
fault-site registry (``chaos/core.py``) is not ported."""

from photon_ml_tpu_torch.chaos.breaker import (  # noqa: F401
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
)
