"""The port's invariant checker: static rules + runtime sanitizers (port of
``photon_ml_tpu/analysis``).

``python -m photon_ml_tpu_torch.analysis --check`` runs every rule over
the port (``photon_ml_tpu_torch/`` and ``chip_smoke.py``; exit 0 =
clean); ``--list-rules`` / ``--explain RULE`` document them;
``--update-baseline`` regenerates the grandfather list
(``analysis/baseline.json``).  The static checker parses files and never
imports what it checks, nor torch.  The runtime half (lock-order
tracking, thread- and process-leak sentinels) lives in
:mod:`photon_ml_tpu_torch.analysis.sanitizers`, used by the serving,
freshness and cluster packages and by ``chip_smoke.py``'s phases.

Rule families:

- concurrency (rules_concurrency.py): thread-lifecycle,
  process-lifecycle, lock-blocking-call, wall-clock-interval
- torch (rules_torch.py): graph-capture-side-effect (the counterpart of
  the reference's jit-side-effect), unseeded-rng
- registry (rules_registry.py): chaos-site-sync, chaos-site-tested,
  metric-naming

The reference's donated-buffer-reuse and jit-side-effect are not run
here; :data:`NOT_APPLICABLE` says why, and ``--list-rules`` lists them.
"""

from __future__ import annotations

from photon_ml_tpu_torch.analysis import (
    rules_concurrency,
    rules_registry,
    rules_torch,
)
from photon_ml_tpu_torch.analysis.engine import (
    Baseline,
    CheckReport,
    Finding,
    Rule,
    SourceTree,
    default_baseline_path,
    default_roots,
    run_check,
    run_rules,
)

#: Every rule, in --list-rules order (family, then id).
ALL_RULES: list[Rule] = [
    *rules_concurrency.RULES,
    *rules_torch.RULES,
    *rules_registry.RULES,
]

RULES_BY_ID: dict[str, Rule] = {r.id: r for r in ALL_RULES}

#: The reference's rules with no counterpart in the port: id → why.
NOT_APPLICABLE: dict[str, str] = dict(rules_torch.NOT_APPLICABLE)


def check(
    roots=None,
    repo_root=None,
    baseline_path=None,
    rules=None,
) -> CheckReport:
    """Run the full rule set (or ``rules``) and return a CheckReport."""
    return run_check(
        ALL_RULES if rules is None else rules,
        roots=roots,
        repo_root=repo_root,
        baseline_path=baseline_path,
    )


__all__ = [
    "ALL_RULES",
    "NOT_APPLICABLE",
    "RULES_BY_ID",
    "Baseline",
    "CheckReport",
    "Finding",
    "Rule",
    "SourceTree",
    "check",
    "default_baseline_path",
    "default_roots",
    "run_check",
    "run_rules",
]
