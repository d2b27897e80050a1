"""Training diagnostics reports (port of
``photon_ml_tpu/diagnostics/report.py``).

Bootstrap confidence intervals, Hosmer–Lemeshow calibration and feature
importance for the GLM driver's ``--training-report``.  Every statistic is
one-shot numpy (and scipy) over scores and labels already on the host, so
nothing touches the device.  Outputs: a JSON artifact (the source of
truth) and a self-contained HTML page (no external assets).
"""

from __future__ import annotations

import dataclasses
import html
import json
import os
from typing import Callable, Optional, Sequence

import numpy as np


def hosmer_lemeshow(
    scores: np.ndarray,
    labels: np.ndarray,
    n_groups: int = 10,
    scores_are_margins: bool = True,
) -> dict:
    """Hosmer–Lemeshow goodness-of-fit for a binary classifier.

    ``scores_are_margins`` (default): scores are raw margins and are
    squashed through the logistic link; pass False when they are already
    probabilities.  (Explicit, not range-detected: a regularized model's
    margins can legitimately all fall inside [0, 1], where a heuristic
    would silently treat them as probabilities and report a bogus
    statistic.)  Rows are cut into ``n_groups`` deciles of predicted
    probability; the statistic is ``Σ (O-E)²/(E(1-E/n))`` over groups,
    asymptotically χ²(n_groups-2) under good calibration.  Returns the
    statistic, degrees of freedom, an approximate p-value, and the
    per-decile table.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    p = 1.0 / (1.0 + np.exp(-scores)) if scores_are_margins else scores
    if not scores_are_margins and (p.min() < 0.0 or p.max() > 1.0):
        raise ValueError(
            "scores_are_margins=False but scores fall outside [0, 1]"
        )
    order = np.argsort(p, kind="stable")
    p, y = p[order], labels[order]
    edges = np.linspace(0, len(p), n_groups + 1).astype(int)
    stat = 0.0
    table = []
    for g in range(n_groups):
        lo, hi = edges[g], edges[g + 1]
        if hi <= lo:
            continue
        n = hi - lo
        observed = float(np.sum(y[lo:hi]))
        expected = float(np.sum(p[lo:hi]))
        denom = expected * (1.0 - expected / n)
        if denom > 1e-12:
            stat += (observed - expected) ** 2 / denom
        table.append({
            "group": g,
            "n": int(n),
            "mean_predicted": float(np.mean(p[lo:hi])),
            "observed_rate": observed / n,
        })
    dof = max(n_groups - 2, 1)
    return {
        "statistic": float(stat),
        "dof": dof,
        "p_value": float(_chi2_sf(stat, dof)),
        "table": table,
    }


def _chi2_sf(x: float, k: int) -> float:
    """Survival function of χ²(k) (scipy is a dependency of the port)."""
    from scipy.stats import chi2

    return float(chi2.sf(x, k))


def bootstrap_metric_ci(
    metric_fn: Callable[[np.ndarray, np.ndarray], float],
    scores: np.ndarray,
    labels: np.ndarray,
    n_boot: int = 200,
    alpha: float = 0.05,
    seed: int = 0,
) -> dict:
    """Percentile bootstrap CI for any metric(scores, labels) — the
    reference's report CIs.  Resampling is row-wise with replacement;
    degenerate resamples (single-class for AUC-like metrics) are skipped
    via NaN filtering."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    n = len(scores)
    stats = []
    for _ in range(n_boot):
        idx = rng.integers(0, n, size=n)
        try:
            v = float(metric_fn(scores[idx], labels[idx]))
        except Exception:
            continue
        if np.isfinite(v):
            stats.append(v)
    stats = np.asarray(stats)
    point = float(metric_fn(scores, labels))
    if stats.size == 0:
        return {"point": point, "lo": point, "hi": point, "n_boot": 0}
    return {
        "point": point,
        "lo": float(np.quantile(stats, alpha / 2)),
        "hi": float(np.quantile(stats, 1 - alpha / 2)),
        "n_boot": int(stats.size),
    }


def feature_importance(
    coefficients: np.ndarray,
    feature_std: Optional[np.ndarray] = None,
    names: Optional[Sequence[str]] = None,
    top_k: int = 25,
    name_fn: Optional[Callable[[int], str]] = None,
) -> list:
    """|coefficient| x feature-std importances (the standardized effect
    size the reference's report ranked by), top-k descending.

    ``name_fn(index) -> name`` resolves names lazily for just the top-k —
    at millions of features, materializing a full ``names`` list only to
    label 25 rows would dominate the report cost."""
    w = np.asarray(coefficients, np.float64)
    std = (
        np.ones_like(w) if feature_std is None
        else np.asarray(feature_std, np.float64)
    )
    imp = np.abs(w) * std
    order = np.argsort(-imp)[:top_k]

    def _name(j: int) -> str:
        if names is not None:
            return str(names[j])
        if name_fn is not None:
            return str(name_fn(j))
        return f"feature_{j}"

    return [
        {
            "feature": _name(int(j)),
            "coefficient": float(w[j]),
            "importance": float(imp[j]),
        }
        for j in order
        if imp[j] > 0
    ]


@dataclasses.dataclass
class TrainingReport:
    """Collects per-run diagnostics and writes report.json + report.html."""

    task: str
    sections: list = dataclasses.field(default_factory=list)

    def add_convergence(self, lam, values, grad_norms) -> None:
        values = [float(v) for v in np.asarray(values) if np.isfinite(v)]
        gnorms = [float(g) for g in np.asarray(grad_norms) if np.isfinite(g)]
        self.sections.append({
            "kind": "convergence",
            "lambda": float(lam),
            "values": values,
            "grad_norms": gnorms,
            "iterations": max(len(values) - 1, 0),
        })

    def add_metric(self, name: str, lam, ci: dict) -> None:
        self.sections.append({
            "kind": "metric", "name": name, "lambda": float(lam), **ci,
        })

    def add_calibration(self, lam, hl: dict) -> None:
        self.sections.append({
            "kind": "calibration", "lambda": float(lam), **hl,
        })

    def add_importance(self, lam, importances: list) -> None:
        self.sections.append({
            "kind": "feature_importance", "lambda": float(lam),
            "top": importances,
        })

    # -- output --------------------------------------------------------
    def to_json(self) -> dict:
        return {"task": self.task, "sections": self.sections}

    def save(self, output_dir: str) -> tuple[str, str]:
        os.makedirs(output_dir, exist_ok=True)
        jpath = os.path.join(output_dir, "report.json")
        hpath = os.path.join(output_dir, "report.html")
        with open(jpath, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        with open(hpath, "w") as f:
            f.write(self._render_html())
        return jpath, hpath

    def _render_html(self) -> str:
        parts = [
            "<!doctype html><meta charset='utf-8'>",
            "<title>photon_ml_tpu_torch training report</title>",
            "<style>body{font:14px sans-serif;margin:2em;max-width:60em}"
            "table{border-collapse:collapse;margin:1em 0}"
            "td,th{border:1px solid #ccc;padding:2px 8px;text-align:right}"
            "th{background:#f0f0f0}caption{font-weight:bold;text-align:left}"
            "svg{background:#fafafa;border:1px solid #eee}</style>",
            f"<h1>Training report — {html.escape(self.task)}</h1>",
        ]
        for s in self.sections:
            kind = s["kind"]
            lam = s.get("lambda")
            if kind == "convergence":
                parts.append(
                    f"<h2>Convergence (λ={lam:g}, "
                    f"{s['iterations']} iterations)</h2>"
                )
                parts.append(_sparkline(s["values"]))
                parts.append(_kv_table(
                    "objective value per iteration",
                    {str(i): f"{v:.8g}" for i, v in enumerate(s["values"])},
                ))
            elif kind == "metric":
                parts.append(
                    f"<h2>{html.escape(s['name'])} (λ={lam:g})</h2>"
                    f"<p>{s['point']:.6f} "
                    f"(95% CI [{s['lo']:.6f}, {s['hi']:.6f}], "
                    f"{s['n_boot']} bootstrap resamples)</p>"
                )
            elif kind == "calibration":
                parts.append(
                    f"<h2>Hosmer–Lemeshow calibration (λ={lam:g})</h2>"
                    f"<p>χ²={s['statistic']:.3f}, dof={s['dof']}, "
                    f"p={s['p_value']:.4f}</p>"
                )
                rows = "".join(
                    f"<tr><td>{r['group']}</td><td>{r['n']}</td>"
                    f"<td>{r['mean_predicted']:.4f}</td>"
                    f"<td>{r['observed_rate']:.4f}</td></tr>"
                    for r in s["table"]
                )
                parts.append(
                    "<table><caption>deciles</caption>"
                    "<tr><th>group</th><th>n</th><th>mean predicted</th>"
                    "<th>observed rate</th></tr>" + rows + "</table>"
                )
            elif kind == "feature_importance":
                parts.append(f"<h2>Feature importance (λ={lam:g})</h2>")
                rows = "".join(
                    f"<tr><td style='text-align:left'>"
                    f"{html.escape(r['feature'])}</td>"
                    f"<td>{r['coefficient']:.6g}</td>"
                    f"<td>{r['importance']:.6g}</td></tr>"
                    for r in s["top"]
                )
                parts.append(
                    "<table><tr><th>feature</th><th>coefficient</th>"
                    "<th>|coef|·std</th></tr>" + rows + "</table>"
                )
        return "\n".join(parts)


def _kv_table(caption: str, kv: dict) -> str:
    rows = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{html.escape(str(v))}</td></tr>"
        for k, v in kv.items()
    )
    return (
        f"<table><caption>{html.escape(caption)}</caption>"
        "<tr><th>iteration</th><th>value</th></tr>" + rows + "</table>"
    )


def _sparkline(values, width=480, height=80) -> str:
    """Inline SVG line of the convergence trace (no external assets)."""
    v = np.asarray([x for x in values if np.isfinite(x)], np.float64)
    if v.size < 2:
        return ""
    lo, hi = float(v.min()), float(v.max())
    span = hi - lo or 1.0
    xs = np.linspace(4, width - 4, v.size)
    ys = height - 4 - (v - lo) / span * (height - 8)
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
    return (
        f"<svg width='{width}' height='{height}'>"
        f"<polyline points='{pts}' fill='none' "
        "stroke='#36c' stroke-width='1.5'/></svg>"
    )
