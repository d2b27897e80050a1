"""Cross-registry rules: chaos sites and metric names stay in sync (port
of ``photon_ml_tpu/analysis/rules_registry.py``).

Two registries in the port are load-bearing conventions:

- ``photon_ml_tpu_torch/chaos/core.py``'s :data:`KNOWN_SITES` — every
  name a ``FaultPlan`` may target.  A registered site with no
  ``maybe_fail`` call-site means chaos tests "pass" without ever
  killing anything; a call-site with an unregistered name can never be
  scripted (``FaultSpec`` refuses it),
  so the seam is silently untestable.  ``chaos-site-sync`` checks both
  directions against the live source.
- The metric-name convention ``<subsystem>_<name>_<unit>`` with one
  kind per name, the ``metric-naming`` rule.  ``python -m
  photon_ml_tpu_torch.telemetry --lint-metrics`` is a thin alias over
  this module (``telemetry/lint.py``), as in the reference.

``chaos-site-tested`` reads the port's tests only (``tests/test_torch_*.py``
and the ``tests/torch_*.py`` helpers they share): the reference's tests
script the reference's sites, and would otherwise vouch for the port's.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Optional

from photon_ml_tpu_torch.analysis.engine import (
    Finding,
    Rule,
    SourceTree,
    const_str,
    dotted_name,
)

# ---------------------------------------------------------------------------
# metric-naming
# ---------------------------------------------------------------------------

#: First name token: which subsystem emits the metric.
SUBSYSTEMS = frozenset({
    "h2d", "hbm", "prefetch", "stream", "streaming", "staging",
    "solver", "solvers", "cd", "grid", "game", "glm", "watchdog", "checkpoint",
    "chaos", "serving", "tuning", "compile", "run", "telemetry",
    "evaluation", "model", "analysis", "freshness", "fleet", "slo",
    "cluster",
})

#: Last name token: what the value measures.
UNITS = frozenset({
    "total", "seconds", "bytes", "ratio", "gbps", "rows", "ms",
    "count", "entries", "iterations", "retries", "depth", "version",
    "tier", "rps", "residual",
})

#: Pre-convention names, grandfathered verbatim (the reference's list;
#: the port keeps its metric names).  Do NOT add to this list — rename or
#: conform instead; each entry is a pending rename chore.
LEGACY_NAMES = frozenset({
    "chaos_faults_injected",
    "checkpoint_corruptions",
    "checkpoint_fallbacks",
    "checkpoint_restores",
    "checkpoint_saves",
    "compile_cache_warmup_compiles",
    "consumer_stall_seconds",
    "consumer_stalls",
    "producer_stall_seconds",
    "producer_stalls",
    "prefetch_max_live",
    "prefetch_passes",
    "prefetch_thread_leak",
    "scored_rows",
    "serving_batch_occupancy",
    "serving_degraded",
    "tuning_best_metric",
    "tuning_trials_completed",
    "tuning_trials_failed",
    "tuning_trials_pruned",
    "tuning_trials_started",
})

_NAME_RE = re.compile(r"^[a-z][a-z0-9]*(_[a-z0-9]+)+$")
_CALL_RE = re.compile(r"\.(counter|gauge|histogram)\(\s*\"([a-z0-9_]+)\"")

#: Files whose metric-name string literals are convention DATA, not
#: registrations (this module and its ``telemetry/lint.py`` alias).
_LINT_EXEMPT_SUFFIXES = (
    "photon_ml_tpu_torch/analysis/rules_registry.py",
    "photon_ml_tpu_torch/telemetry/lint.py",
)


def lint_name(name: str, kind: Optional[str] = None) -> list[str]:
    """Issues with one metric name (empty list = conforming)."""
    if name in LEGACY_NAMES:
        return []
    issues = []
    if not _NAME_RE.match(name):
        issues.append(
            f"{name!r}: not lowercase snake_case with >= 2 tokens"
        )
        return issues
    tokens = name.split("_")
    if tokens[0] not in SUBSYSTEMS:
        issues.append(
            f"{name!r}: unknown subsystem prefix {tokens[0]!r} "
            f"(known: {sorted(SUBSYSTEMS)})"
        )
    if tokens[-1] not in UNITS:
        issues.append(
            f"{name!r}: unknown unit suffix {tokens[-1]!r} "
            f"(known: {sorted(UNITS)})"
        )
    return issues


def scan_tree(tree: SourceTree) -> list[tuple[str, str, str, int]]:
    """String-literal metric registrations: ``(name, kind, relpath,
    lineno)``.  Dynamically-built names (f-strings) are invisible here —
    the runtime kind check in MetricsRegistry still covers them."""
    hits: list[tuple[str, str, str, int]] = []
    for pf in tree.files:
        if pf.relpath.replace("\\", "/").endswith(_LINT_EXEMPT_SUFFIXES):
            continue
        for lineno, line in enumerate(pf.lines, 1):
            for m in _CALL_RE.finditer(line):
                hits.append((m.group(2), m.group(1), pf.relpath, lineno))
    return hits


def _check_metric_naming(tree: SourceTree) -> Iterable[Finding]:
    hits = scan_tree(tree)
    kinds: dict[str, dict[str, tuple[str, int]]] = {}
    for name, kind, path, lineno in hits:
        kinds.setdefault(name, {}).setdefault(kind, (path, lineno))
    for name in sorted(kinds):
        by_kind = kinds[name]
        if len(by_kind) > 1:
            sites = ", ".join(
                f"{kind} at {path}:{lineno}"
                for kind, (path, lineno) in sorted(by_kind.items())
            )
            path, lineno = next(iter(sorted(by_kind.values())))
            yield Finding(
                "metric-naming", path, lineno,
                f"{name!r} registered as multiple kinds: {sites}",
            )
        kind = next(iter(by_kind))
        path, lineno = by_kind[kind]
        for issue in lint_name(name, kind):
            yield Finding("metric-naming", path, lineno, issue)


def lint_source(roots=None) -> tuple[int, list[str]]:
    """The surface of ``python -m photon_ml_tpu_torch.telemetry
    --lint-metrics``: ``(n_names, problems)`` over the default scan
    roots (or explicit ``roots`` for tests)."""
    tree = SourceTree(roots=roots)
    hits = scan_tree(tree)
    problems = [
        f"{f.message} (first seen {f.path}:{f.line})"
        for f in _check_metric_naming(tree)
    ]
    return len({h[0] for h in hits}), problems


# ---------------------------------------------------------------------------
# chaos-site-sync
# ---------------------------------------------------------------------------

_CHAOS_CORE_SUFFIX = "photon_ml_tpu_torch/chaos/core.py"


def _registry_sites(tree: SourceTree) -> dict[str, tuple[str, int]]:
    """KNOWN_SITES keys parsed from chaos/core.py's AST (no import —
    the checker must not execute the package it checks)."""
    pf = tree.file(_CHAOS_CORE_SUFFIX)
    if pf is None or pf.tree is None:
        return {}
    for node in ast.walk(pf.tree):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "KNOWN_SITES"
            and isinstance(node.value, ast.Dict)
        ):
            out = {}
            for k in node.value.keys:
                s = const_str(k)
                if s is not None:
                    out[s] = (pf.relpath, k.lineno)
            return out
    return {}


def _maybe_fail_sites(tree: SourceTree) -> list[tuple[str, str, int]]:
    """Every ``maybe_fail("<literal>", ...)`` call outside chaos/:
    ``(site, relpath, lineno)``.  Non-literal site arguments are
    invisible — none exist today, and a dynamic site name would also
    defeat the registry's typo protection, so keep them literal."""
    out: list[tuple[str, str, int]] = []
    for pf in tree.files:
        if "/chaos/" in "/" + pf.relpath.replace("\\", "/"):
            continue
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            if name.rsplit(".", 1)[-1] != "maybe_fail":
                continue
            if not node.args:
                continue
            site = const_str(node.args[0])
            if site is not None:
                out.append((site, pf.relpath, node.lineno))
    return out


def _check_chaos_site_sync(tree: SourceTree) -> Iterable[Finding]:
    registry = _registry_sites(tree)
    if not registry:
        return  # tree without chaos/core.py (rule fixtures): nothing on
    calls = _maybe_fail_sites(tree)
    called = {site for site, _, _ in calls}
    for site, (path, lineno) in sorted(registry.items()):
        if site not in called:
            yield Finding(
                "chaos-site-sync", path, lineno,
                f"chaos site {site!r} is registered in KNOWN_SITES but "
                "has no maybe_fail call-site: fault plans targeting it "
                "never fire and its recovery path is untested — wire "
                "the seam or retire the registry entry",
            )
    for site, path, lineno in calls:
        if site not in registry:
            yield Finding(
                "chaos-site-sync", path, lineno,
                f"maybe_fail site {site!r} is not in chaos/core.py "
                "KNOWN_SITES: no FaultPlan can ever target it "
                "(FaultSpec refuses unknown sites), so the seam is "
                "silently untestable — register it with a description",
            )


# ---------------------------------------------------------------------------
# chaos-site-tested
# ---------------------------------------------------------------------------


def _is_port_test(name: str) -> bool:
    """A test module of the port, or a helper only the port's tests use
    (``tests/torch_dist_workers.py``)."""
    return name.endswith(".py") and (
        name.startswith("test_torch_") or name.startswith("torch_"))


def _test_texts(tree: SourceTree) -> list[tuple[str, str]]:
    """``(relpath, text)`` for every port test under the repo root's
    ``tests/`` (see :func:`_is_port_test`).  Tests are deliberately NOT in
    ``tree.files`` (they violate invariants on purpose in fixtures), so
    this rule reads them directly — as text, not AST: a site name counts
    as referenced however the test spells it (FaultSpec argument, plan
    literal, parametrize id)."""
    out: list[tuple[str, str]] = []
    tests_root = os.path.join(tree.repo_root, "tests")
    if not os.path.isdir(tests_root):
        return out
    for dirpath, dirnames, filenames in os.walk(tests_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if not _is_port_test(name):
                continue
            path = os.path.join(dirpath, name)
            with open(path, encoding="utf-8") as f:
                out.append((os.path.relpath(path, tree.repo_root),
                            f.read()))
    return out


def _check_chaos_site_tested(tree: SourceTree) -> Iterable[Finding]:
    registry = _registry_sites(tree)
    if not registry:
        return  # tree without chaos/core.py (rule fixtures): nothing on
    tests = _test_texts(tree)
    if not tests:
        return  # no tests/ dir alongside this tree: nothing to check
    for site, (path, lineno) in sorted(registry.items()):
        quoted = (f'"{site}"', f"'{site}'")
        if any(q in text for _, text in tests for q in quoted):
            continue
        yield Finding(
            "chaos-site-tested", path, lineno,
            f"chaos site {site!r} is registered in KNOWN_SITES but no "
            "test file references it: the recovery path behind the "
            "seam is never exercised under injected faults — add a "
            "test that scripts a FaultPlan (or flips the scripted "
            "flag) at this site, or retire the registry entry",
        )


RULES = [
    Rule(
        id="chaos-site-sync",
        family="registry",
        summary="chaos KNOWN_SITES and maybe_fail call-sites cover each "
                "other exactly",
        explain=(
            "The fault-site registry (chaos/core.py KNOWN_SITES) and "
            "the instrumented seams must stay in lockstep in BOTH "
            "directions.  A registered site with no call-site is a "
            "recovery path that silently stopped being exercised (a "
            "refactor moved the seam and dropped the hook); a "
            "maybe_fail with an unregistered name can never fire from a "
            "plan because FaultSpec validates sites at construction.  "
            "The rule parses KNOWN_SITES from the AST (never importing "
            "the package under check) and cross-references every "
            "maybe_fail string literal outside chaos/ itself.  "
            "Fix: add the KNOWN_SITES entry (with its what-a-fault-"
            "here-simulates description) or wire/remove the call-site."
        ),
        fn=_check_chaos_site_sync,
    ),
    Rule(
        id="chaos-site-tested",
        family="registry",
        summary="every chaos KNOWN_SITES entry is referenced by at "
                "least one test file",
        explain=(
            "chaos-site-sync guarantees a registered site has a "
            "maybe_fail call-site, but a seam nobody scripts a fault "
            "at is still an untested recovery path — the hook fires in "
            "production shapes while every test runs the happy path.  "
            "This rule reads the port's tests directly "
            "(tests/test_torch_*.py and the tests/torch_*.py helpers; "
            "tests are excluded from the scanned tree on purpose, and "
            "the reference's tests script the reference's sites) and "
            "flags any KNOWN_SITES key that appears as a quoted string "
            "literal in NO such file.  Fix: add a test that targets the site "
            "with a FaultPlan/FaultSpec (or asserts the degrade "
            "behavior behind it), or retire the registry entry."
        ),
        fn=_check_chaos_site_tested,
    ),
    Rule(
        id="metric-naming",
        family="registry",
        summary="metric names follow <subsystem>_<name>_<unit>, one "
                "kind per name",
        explain=(
            "Registering one metric name as two kinds (counter in one "
            "file, gauge in another) cannot be rendered in a Prometheus "
            "exposition and surfaces as silently-wrong scraped data; "
            "off-convention names break dashboards' subsystem grouping "
            "and unit inference.  The rule scans string-literal "
            "registrations (.counter(\"x\")/.gauge/.histogram) across "
            "the package + chip_smoke.py, enforcing lowercase snake_case, a "
            "known subsystem prefix, a known unit suffix, and cross-"
            "file kind consistency.  Pre-convention names are "
            "grandfathered in LEGACY_NAMES (burn the list down, never "
            "grow it).  python -m photon_ml_tpu_torch.telemetry "
            "--lint-metrics is a thin alias over this rule."
        ),
        fn=_check_metric_naming,
    ),
]
