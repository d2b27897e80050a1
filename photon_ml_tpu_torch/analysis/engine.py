"""AST-based rule engine for the port's invariant checker (port of
``photon_ml_tpu/analysis/engine.py``).

The codebase guarantees invariants no generic linter knows about —
bit-for-bit resume, thread and process seams that must never leak,
side-effect-free CUDA graph captures, fault sites and metric names that
must stay in sync with their registries.  ``flake8`` cannot police
"every ``threading.Thread`` is daemon or provably joined"; this engine
can, because the rules are written against THIS repo's idioms (see
rules_concurrency.py / rules_torch.py / rules_registry.py).

Mechanics (all stdlib, no new deps):

- Every ``.py`` file under the scanned roots is parsed ONCE into an
  :class:`PyFile` (source lines + ``ast`` tree + a parent map rules can
  share); rules walk those trees and emit :class:`Finding`\\ s with
  ``file:line`` positions and stable messages.
- **Suppressions**: a ``# photon: disable=rule-a,rule-b`` comment on the
  flagged line (or on a comment-only line directly above it) silences
  those rules for that line — ``disable=all`` silences everything.
  Suppressions are deliberate, reviewable, and local; prefer them over
  baseline entries for new code.
- **Baseline**: grandfathered findings live in a committed JSON file
  (``analysis/baseline.json``) keyed by ``(rule, path, message)`` — NOT
  by line number, so unrelated edits above a finding do not invalidate
  the baseline.  ``--check`` fails only on findings outside the
  baseline; ``--update-baseline`` rewrites it (preserving per-entry
  ``justification`` strings, which every committed entry must carry).
  Stale entries (matching nothing) are reported so the list burns down
  instead of fossilizing.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Iterable, Optional

#: Comment grammar: ``# photon: disable=rule-a,rule-b`` (or ``=all``).
_SUPPRESS_RE = re.compile(r"#\s*photon:\s*disable=([a-z0-9_,\-]+|all)")
_COMMENT_ONLY_RE = re.compile(r"^\s*#")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source position.

    ``message`` must be STABLE for a given defect (no line numbers, no
    volatile paths inside it): the baseline matches on
    ``(rule, path, message)`` so the entry survives line drift.
    """

    rule: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.message}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One named invariant: ``fn(tree) -> Iterable[Finding]``.

    ``summary`` is the one-liner ``--list-rules`` prints; ``explain`` is
    the full story ``--explain RULE`` prints — what the rule checks, why
    the invariant matters in THIS codebase, and what a fix looks like.
    """

    id: str
    family: str  # "concurrency" | "torch" | "registry"
    summary: str
    explain: str
    fn: Callable[["SourceTree"], Iterable[Finding]]

    def run(self, tree: "SourceTree") -> list[Finding]:
        return list(self.fn(tree))


class PyFile:
    """One parsed source file: lines, AST, parent links, suppressions."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as exc:  # surfaced as a finding by run_rules
            self.parse_error = exc
        self._parents: Optional[dict[ast.AST, ast.AST]] = None
        self._suppress: Optional[dict[int, set[str]]] = None

    # -- shared AST services -------------------------------------------------
    @property
    def parents(self) -> dict[ast.AST, ast.AST]:
        """child node -> parent node, built lazily once per file."""
        if self._parents is None:
            parents: dict[ast.AST, ast.AST] = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    parents[child] = node
            self._parents = parents
        return self._parents

    def parent_chain(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(
        self, node: ast.AST
    ) -> Optional[ast.FunctionDef]:
        for anc in self.parent_chain(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    # -- suppressions --------------------------------------------------------
    @property
    def suppressions(self) -> dict[int, set[str]]:
        """line number (1-based) -> rule ids disabled on that line."""
        if self._suppress is None:
            sup: dict[int, set[str]] = {}
            for i, line in enumerate(self.lines, 1):
                m = _SUPPRESS_RE.search(line)
                if not m:
                    continue
                rules = set(m.group(1).split(","))
                sup.setdefault(i, set()).update(rules)
                # A comment-only suppression line covers the next line
                # (for statements too long to carry an inline comment).
                if _COMMENT_ONLY_RE.match(line):
                    sup.setdefault(i + 1, set()).update(rules)
            self._suppress = sup
        return self._suppress

    def is_suppressed(self, rule: str, line: int) -> bool:
        rules = self.suppressions.get(line)
        return bool(rules) and (rule in rules or "all" in rules)


class SourceTree:
    """All scanned files plus the repo-root used for relative paths."""

    def __init__(self, roots=None, repo_root: Optional[str] = None):
        if repo_root is None:
            repo_root = default_repo_root()
        if roots is None:
            roots = default_roots(repo_root)
        self.repo_root = os.path.abspath(repo_root)
        self.files: list[PyFile] = []
        seen: set[str] = set()
        for root in roots:
            for path in sorted(_py_files(root)):
                apath = os.path.abspath(path)
                if apath in seen:
                    continue
                seen.add(apath)
                rel = os.path.relpath(apath, self.repo_root)
                with open(apath, encoding="utf-8") as f:
                    text = f.read()
                self.files.append(PyFile(apath, rel, text))

    def file(self, relpath_suffix: str) -> Optional[PyFile]:
        for f in self.files:
            if f.relpath.endswith(relpath_suffix):
                return f
        return None


#: Directories the walk never enters: byte-code caches, the kernels' build
#: directory (``photon_ml_tpu_torch/_build/``, which ``.gitignore`` lists)
#: and hidden ones.  What a run writes there is not source, so it cannot
#: change what a scan of the tree finds.
_SKIP_DIRS = frozenset({"__pycache__", "_build"})


def _py_files(root: str) -> Iterable[str]:
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in _SKIP_DIRS and not d.startswith(".")]
        for name in filenames:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def default_repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def default_roots(repo_root: Optional[str] = None) -> list[str]:
    """What ``--check`` scans by default: the port's package and
    ``chip_smoke.py``, its driver on the card.  ``bench.py`` is the JAX
    package's and is not scanned.  Tests are NOT scanned — they exist to
    poke invariants, including violating them on purpose in fixtures."""
    if repo_root is None:
        repo_root = default_repo_root()
    return [
        os.path.join(repo_root, "photon_ml_tpu_torch"),
        os.path.join(repo_root, "chip_smoke.py"),
    ]


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


class Baseline:
    """Committed grandfathered findings, each with a justification."""

    def __init__(self, entries: list[dict]):
        self.entries = entries
        self._keys = {
            f"{e['rule']}::{e['path']}::{e['message']}" for e in entries
        }

    @classmethod
    def load(cls, path: Optional[str]) -> "Baseline":
        if path is None or not os.path.exists(path):
            return cls([])
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        entries = data.get("entries", [])
        for e in entries:
            missing = {"rule", "path", "message"} - set(e)
            if missing:
                raise ValueError(
                    f"baseline entry missing fields {sorted(missing)}: {e}"
                )
            just = str(e.get("justification", "")).strip()
            if not just or just.startswith("TODO"):
                raise ValueError(
                    "every baseline entry must carry a one-line "
                    "justification (not a TODO placeholder); "
                    f"missing on {e['rule']}::{e['path']}"
                )
        return cls(entries)

    def contains(self, finding: Finding) -> bool:
        return finding.key in self._keys

    def stale(self, findings: Iterable[Finding]) -> list[dict]:
        live = {f.key for f in findings}
        return [
            e for e in self.entries
            if f"{e['rule']}::{e['path']}::{e['message']}" not in live
        ]

    @staticmethod
    def write(path: str, findings: Iterable[Finding],
              old: "Baseline") -> None:
        """Rewrite the baseline from current findings, carrying forward
        existing justifications; new entries get a TODO placeholder the
        loader will refuse until a human fills it in."""
        just = {
            f"{e['rule']}::{e['path']}::{e['message']}":
                e.get("justification", "")
            for e in old.entries
        }
        entries = [
            {
                "rule": f.rule,
                "path": f.path,
                "message": f.message,
                "justification": just.get(
                    f.key, "TODO: justify or fix this finding"
                ),
            }
            for f in sorted(
                findings, key=lambda f: (f.rule, f.path, f.message)
            )
        ]
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"entries": entries}, f, indent=2, sort_keys=False)
            f.write("\n")


# ---------------------------------------------------------------------------
# Check driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckReport:
    findings: list[Finding]  # actionable: not suppressed, not baselined
    suppressed: int
    baselined: int
    stale_baseline: list[dict]
    parse_errors: list[str]
    files: int
    rules: int

    @property
    def ok(self) -> bool:
        return not self.findings and not self.parse_errors


def run_rules(tree: SourceTree, rules: Iterable[Rule]) -> list[Finding]:
    """All raw findings (before suppression/baseline filtering)."""
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(rule.run(tree))
    return findings


def run_check(
    rules: Iterable[Rule],
    roots=None,
    repo_root: Optional[str] = None,
    baseline_path: Optional[str] = None,
) -> CheckReport:
    rules = list(rules)
    tree = SourceTree(roots=roots, repo_root=repo_root)
    baseline = Baseline.load(
        default_baseline_path() if baseline_path is None else baseline_path
    )
    raw = run_rules(tree, rules)
    by_rel = {f.relpath: f for f in tree.files}
    actionable: list[Finding] = []
    suppressed = baselined = 0
    for f in raw:
        pf = by_rel.get(f.path)
        if pf is not None and pf.is_suppressed(f.rule, f.line):
            suppressed += 1
        elif baseline.contains(f):
            baselined += 1
        else:
            actionable.append(f)
    parse_errors = [
        f"{pf.relpath}:{pf.parse_error.lineno}: syntax error: "
        f"{pf.parse_error.msg}"
        for pf in tree.files if pf.parse_error is not None
    ]
    actionable.sort(key=lambda f: (f.path, f.line, f.rule))
    return CheckReport(
        findings=actionable,
        suppressed=suppressed,
        baselined=baselined,
        stale_baseline=baseline.stale(raw),
        parse_errors=parse_errors,
        files=len(tree.files),
        rules=len(rules),
    )


# -- small AST helpers shared by the rule modules ---------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def kwarg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None
