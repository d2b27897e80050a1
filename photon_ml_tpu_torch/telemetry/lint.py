"""Metric-name lint (port of ``photon_ml_tpu/telemetry/lint.py``): a thin
alias over the invariant checker's ``metric-naming`` rule.

The implementation lives in :mod:`photon_ml_tpu_torch.analysis.rules_registry`
(``python -m photon_ml_tpu_torch.analysis --check`` runs it with every
other rule); this module re-exports its surface so ``python -m
photon_ml_tpu_torch.telemetry --lint-metrics`` runs it alone.
"""

from __future__ import annotations

from photon_ml_tpu_torch.analysis.engine import SourceTree
from photon_ml_tpu_torch.analysis.rules_registry import (  # noqa: F401
    LEGACY_NAMES,
    SUBSYSTEMS,
    UNITS,
    lint_name,
    lint_source,
    scan_tree,
)


def scan_source(roots=None) -> list[tuple[str, str, str, int]]:
    """``(name, kind, relpath, lineno)`` hits over the default roots
    (``photon_ml_tpu_torch/`` + ``chip_smoke.py``) or explicit ``roots``."""
    return scan_tree(SourceTree(roots=roots))


__all__ = [
    "LEGACY_NAMES",
    "SUBSYSTEMS",
    "UNITS",
    "lint_name",
    "lint_source",
    "scan_source",
]
