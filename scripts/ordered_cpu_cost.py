"""What the port's fixed-order CPU arithmetic (``ops/ordered.py``) costs a
CPU solve, against the library calls it replaced.

One L2 logistic L-BFGS solve (and one TRON solve) on the CPU at the width of
``chip_smoke.py``'s phase 4 driver: 2^17 rows, 8,192 binary features with 32
a row, and the intercept as a dense stripe of the kernel layout, float32.
Each solve runs twice in each mode, alternating; the best wall is kept.

- ``ordered``: the port as it is (its CPU sums, ``exp`` and ``sqrt`` from
  ``ops/ordered.py``);
- ``library``: the same solve with ``ordered``'s functions replaced by
  ``torch.dot``, ``@``, ``torch.exp`` and ``torch.sqrt``, the calls the port
  made on the CPU before it had ``ops/ordered.py``.

    python scripts/ordered_cpu_cost.py [--root DIR] [--rows N] [--threads T]

``--root`` imports the package from another checkout; one without
``ops/ordered.py`` runs the ``library`` mode alone.  The last line is a JSON
summary.  It imports torch, numpy, scipy and the port only (no JAX).
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch


def problem(rows: int, d: int, nnz: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, d, size=(rows, nnz))
    X = sp.csr_matrix((np.ones(rows * nnz, np.float32), cols.reshape(-1),
                       np.arange(0, rows * nnz + 1, nnz)), shape=(rows, d))
    X.sum_duplicates()
    X.data[:] = 1.0
    X = sp.hstack([X, np.ones((rows, 1), np.float32)], format="csr")
    w = rng.normal(size=d + 1) * (rng.uniform(size=d + 1) < 0.3)
    p = 1.0 / (1.0 + np.exp(-(X @ w - 0.5)))
    y = (rng.uniform(size=rows) < p).astype(np.float32)
    return X, y


def library_calls(ordered):
    """Replace ``ordered``'s functions by the library calls; returns the
    originals."""
    saved = {k: getattr(ordered, k)
             for k in ("dot", "matvec", "rmatvec", "exp", "sqrt")}
    ordered.dot = torch.dot
    ordered.matvec = lambda x, v: x @ v
    ordered.rmatvec = lambda x, u: x.T @ u
    ordered.exp = torch.exp
    ordered.sqrt = torch.sqrt
    return saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--rows", type=int, default=1 << 17)
    ap.add_argument("--features", type=int, default=8192)
    ap.add_argument("--nnz", type=int, default=32)
    ap.add_argument("--max-iters", type=int, default=30)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch's CPU threads (0: leave as is)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    if args.threads:
        torch.set_num_threads(args.threads)

    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )
    try:
        from photon_ml_tpu_torch.ops import ordered
    except ImportError:
        ordered = None

    X, y = problem(args.rows, args.features, args.nnz)
    data = make_glm_data(X, y, use_kernel=True, device="cpu")

    def solve(opt):
        prob = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
            optimizer=OptimizerConfig(optimizer=OptimizerType[opt],
                                      max_iters=args.max_iters,
                                      tolerance=1e-7),
            regularization=RegularizationContext.l2()))
        t0 = time.perf_counter()
        res = prob.solve_single_device(data, 1.0)
        return time.perf_counter() - t0, int(res.iterations)

    modes = ["library"] if ordered is None else ["ordered", "library"]
    out = {"host": platform.processor() or platform.machine(),
           "torch": torch.__version__, "threads": torch.get_num_threads(),
           "rows": args.rows, "features": args.features + 1,
           "nnz_per_row": args.nnz, "ordered_module": ordered is not None}
    for opt in ("LBFGS", "TRON"):
        best = {m: (float("inf"), 0) for m in modes}
        for _ in range(2):
            for mode in modes:
                saved = library_calls(ordered) if (
                    mode == "library" and ordered is not None) else None
                try:
                    s, it = solve(opt)
                finally:
                    if saved:
                        for k, f in saved.items():
                            setattr(ordered, k, f)
                best[mode] = min(best[mode], (s, it))
        for mode, (s, it) in best.items():
            print(f"{opt} {mode}: {s:.3f} s, {it} iterations, "
                  f"{s / max(it, 1) * 1e3:.1f} ms an iteration", flush=True)
            out[f"{opt}.{mode}"] = {"s": s, "iterations": it}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
