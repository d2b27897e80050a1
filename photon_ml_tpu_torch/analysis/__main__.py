"""CLI for the port's invariant checker (port of
``photon_ml_tpu/analysis/__main__.py``).

    python -m photon_ml_tpu_torch.analysis --check
    python -m photon_ml_tpu_torch.analysis --check \
        --root photon_ml_tpu_torch/serving
    python -m photon_ml_tpu_torch.analysis --update-baseline
    python -m photon_ml_tpu_torch.analysis --list-rules
    python -m photon_ml_tpu_torch.analysis --explain graph-capture-side-effect

Exit status: 0 when the tree is clean (modulo suppressions and the
committed baseline), 1 when there are actionable findings, parse
errors, or a broken baseline.  Stale baseline entries are reported on
stderr but do not fail the check — they mean a grandfathered defect was
fixed and the entry should be deleted (run --update-baseline).
``--explain`` of a reference rule with no counterpart here (see
``--list-rules``) prints why and exits 0.
"""

from __future__ import annotations

import argparse
import sys
import textwrap

from photon_ml_tpu_torch.analysis import (
    ALL_RULES,
    NOT_APPLICABLE,
    RULES_BY_ID,
    Baseline,
    SourceTree,
    check,
    default_baseline_path,
    run_rules,
)


def _list_rules() -> int:
    width = max(len(r.id) for r in ALL_RULES)
    family = None
    for r in ALL_RULES:
        if r.family != family:
            family = r.family
            print(f"[{family}]")
        print(f"  {r.id:<{width}}  {r.summary}")
    print("[not applicable to the port]")
    for rule_id in sorted(NOT_APPLICABLE):
        print(f"  {rule_id:<{width}}  not applicable: "
              f"{NOT_APPLICABLE[rule_id].split('.  ')[-1]}")
    print(
        "\nsuppress inline with '# photon: disable=<rule>' (or =all); "
        "see --explain <rule> for the full story"
    )
    return 0


def _explain(rule_id: str) -> int:
    rule = RULES_BY_ID.get(rule_id)
    if rule is None and rule_id in NOT_APPLICABLE:
        print(f"{rule_id} [not applicable to the port]\n")
        print(textwrap.fill(NOT_APPLICABLE[rule_id], width=76,
                            initial_indent="  ", subsequent_indent="  "))
        return 0
    if rule is None:
        print(
            f"unknown rule {rule_id!r}; known: "
            f"{', '.join(sorted([*RULES_BY_ID, *NOT_APPLICABLE]))}",
            file=sys.stderr,
        )
        return 1
    print(f"{rule.id} [{rule.family}]")
    print(f"  {rule.summary}\n")
    print(textwrap.fill(rule.explain, width=76, initial_indent="  ",
                        subsequent_indent="  "))
    return 0


def _update_baseline(roots, baseline_path: str) -> int:
    tree = SourceTree(roots=roots)
    raw = run_rules(tree, ALL_RULES)
    by_rel = {f.relpath: f for f in tree.files}
    keep = [
        f for f in raw
        if not (
            by_rel.get(f.path) is not None
            and by_rel[f.path].is_suppressed(f.rule, f.line)
        )
    ]
    try:
        old = Baseline.load(baseline_path)
    except ValueError:
        # A baseline mid-edit (TODO justifications) still carries the
        # human-written ones forward.
        import json
        with open(baseline_path, encoding="utf-8") as f:
            old = Baseline.__new__(Baseline)
            old.entries = json.load(f).get("entries", [])
            old._keys = set()
    Baseline.write(baseline_path, keep, old)
    print(f"wrote {baseline_path} with {len(keep)} entries")
    print(
        "fill in any 'TODO' justifications before committing: --check "
        "refuses a baseline with placeholder or missing justifications"
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.analysis",
        description="the port's invariant checker",
    )
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--check", action="store_true",
                      help="run all rules; exit 1 on findings")
    mode.add_argument("--update-baseline", action="store_true",
                      help="rewrite the baseline from current findings")
    mode.add_argument("--list-rules", action="store_true",
                      help="list rule ids and one-line summaries")
    mode.add_argument("--explain", metavar="RULE",
                      help="print the full rationale for one rule")
    p.add_argument("--root", action="append", default=None,
                   help="scan root (repeatable; default: "
                        "photon_ml_tpu_torch/ + chip_smoke.py)")
    p.add_argument("--baseline", default=None,
                   help="baseline path (default: analysis/baseline.json)")
    args = p.parse_args(argv)

    if args.list_rules:
        return _list_rules()
    if args.explain:
        return _explain(args.explain)

    baseline_path = args.baseline or default_baseline_path()
    if args.update_baseline:
        return _update_baseline(args.root, baseline_path)

    try:
        report = check(roots=args.root, baseline_path=baseline_path)
    except ValueError as exc:  # malformed baseline
        print(f"analysis: {exc}", file=sys.stderr)
        return 1
    for err in report.parse_errors:
        print(err)
    for f in report.findings:
        print(f)
    for e in report.stale_baseline:
        print(
            f"stale baseline entry (fixed? delete it): "
            f"[{e['rule']}] {e['path']}: {e['message']}",
            file=sys.stderr,
        )
    status = "clean" if report.ok else "FAILED"
    print(
        f"analysis: {status} — {len(report.findings)} finding(s), "
        f"{report.suppressed} suppressed, {report.baselined} baselined, "
        f"{len(report.stale_baseline)} stale baseline entr(ies) over "
        f"{report.files} files / {report.rules} rules"
    )
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
