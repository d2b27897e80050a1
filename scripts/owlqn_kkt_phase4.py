"""OWL-QN's KKT test on phase 4's training matrix, in both packages, on the CPU.

The setting of ``chip_smoke.py`` phase 15a's resident elastic-net solve:
phase 4's training matrix (2^17 rows x 8192 binary features, about 32 a
row, seed 3, plus the intercept as column 8192), logistic loss, elastic net
alpha 0.5 at lambda 10 (l1 = l2 = 5), the intercept exempt from the L1
term, tolerance 1e-9, at most 200 iterations, the value summed in float64.
The reference (``photon_ml_tpu``, its plain sparse layout) and the port
(``photon_ml_tpu_torch``, its kernel layout's plain version) solve the same
arrays, and each solution gets phase 3b's KKT test, evaluated in float64 on
the host: max |g_j| / l1 over the penalised zeros must stay within 1.01, and
the decrease that a diagonal Newton step on the pseudo-gradient would buy,
sum_j pg_j^2 / (2 H_jj), must stay within 1e-7 of F.

    JAX_PLATFORMS=cpu python scripts/owlqn_kkt_phase4.py [--rows 131072]

Prints one line a package and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_FEATURES = 8192
NNZ_PER_ROW = 32
TRAIN_ROWS = 1 << 17
VAL_ROWS = 1 << 15
LAMBDA = 10.0
ALPHA = 0.5
TOLERANCE = 1e-9
MAX_ITERS = 200
KKT_ZERO = 1e-2
KKT_DECREMENT = 1e-7


def phase4_training(train_rows: int):
    """Phase 4's draw (``chip_smoke.phase_driver``): the first
    ``train_rows`` rows as CSR with the intercept last, labels in {0, 1}."""
    rng = np.random.default_rng(3)
    n = TRAIN_ROWS + VAL_ROWS
    rows = np.repeat(np.arange(n, dtype=np.int64), NNZ_PER_ROW)
    keys = np.unique(rows * N_FEATURES
                     + rng.integers(0, N_FEATURES, size=n * NNZ_PER_ROW))
    rows, cols = keys // N_FEATURES, keys % N_FEATURES
    w_true = (rng.normal(size=N_FEATURES)
              * (rng.uniform(size=N_FEATURES) < 0.3))
    margins = np.bincount(rows, weights=w_true[cols], minlength=n) - 0.5
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margins))).astype(np.float32)
    keep = rows < train_rows
    rows, cols = rows[keep], cols[keep]
    rows = np.concatenate([rows, np.arange(train_rows)])
    cols = np.concatenate([cols, np.full(train_rows, N_FEATURES)])
    X = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                      shape=(train_rows, N_FEATURES + 1))
    X.sum_duplicates()
    X.sort_indices()
    return X, y[:train_rows]


def kkt(X, y, w, l1, l2, mask):
    """(max |g|/l1 at the penalised zeros, decrement / F, F) in float64."""
    w = np.asarray(w, np.float64)
    Xd = X.astype(np.float64)
    m = Xd @ w
    p = 1.0 / (1.0 + np.exp(-m))
    loss = np.logaddexp(0.0, m) - y * m
    l1v = l1 * mask
    f_all = (loss.sum() + 0.5 * l2 * (w @ w) + (l1v * np.abs(w)).sum())
    g = Xd.T @ (p - y) + l2 * w
    hdiag = Xd.multiply(Xd).T @ (p * (1.0 - p)) + l2
    pg = np.where(w != 0, g + l1v * np.sign(w),
                  np.sign(g) * np.maximum(np.abs(g) - l1v, 0.0))
    zero = (w == 0) & (mask > 0)
    at_zero = float((np.abs(g[zero]) / l1).max(initial=0.0))
    dec = float((pg * pg / (2.0 * np.maximum(hdiag, 1e-30))).sum()
                / abs(f_all))
    return at_zero, dec, float(f_all)


def solve_reference(X, y, mask):
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from photon_ml_tpu.data.dataset import make_glm_data
    from photon_ml_tpu.optim import problem
    from photon_ml_tpu.optim.regularization import RegularizationContext

    prob = problem.GlmOptimizationProblem("logistic", problem.GlmOptimizationConfig(
        optimizer=problem.OptimizerConfig(
            optimizer=problem.OptimizerType.LBFGS, max_iters=MAX_ITERS,
            tolerance=TOLERANCE),
        regularization=RegularizationContext.elastic_net(ALPHA)),
        accumulate="f64")
    data = make_glm_data(X, y, use_pallas=False)
    res = prob.solve_single_device(data, LAMBDA,
                                   l1_mask=jnp.asarray(mask, jnp.float32))
    return (np.asarray(res.w), float(res.value), int(res.iterations),
            bool(res.converged))


def solve_port(X, y, mask):
    import torch

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

    prob = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
        optimizer=OptimizerConfig(optimizer=OptimizerType.LBFGS,
                                  max_iters=MAX_ITERS, tolerance=TOLERANCE),
        regularization=RegularizationContext.elastic_net(ALPHA)),
        accumulate="f64")
    data = make_glm_data(X, y, device="cpu")
    res = prob.solve(data, LAMBDA, l1_mask=torch.from_numpy(mask))
    return (res.w.numpy(), float(res.value), int(res.iterations),
            bool(res.converged))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=TRAIN_ROWS)
    args = ap.parse_args()
    X, y = phase4_training(args.rows)
    mask = np.ones(X.shape[1], np.float32)
    mask[-1] = 0.0
    l1 = l2 = float(np.float32(ALPHA) * np.float32(LAMBDA))
    summary = {"rows": X.shape[0], "cols": X.shape[1], "nnz": int(X.nnz),
               "lambda": LAMBDA, "tolerance": TOLERANCE}
    for name, solve in (("reference", solve_reference), ("port", solve_port)):
        t0 = time.perf_counter()
        w, value, iters, converged = solve(X, y, mask)
        seconds = time.perf_counter() - t0
        at_zero, dec, f_all = kkt(X, y, w, l1, l2, mask)
        passes = at_zero <= 1 + KKT_ZERO and dec <= KKT_DECREMENT
        summary[name] = {"value": value, "F64": f_all, "iterations": iters,
                         "converged": converged, "at_zero": at_zero,
                         "decrement": dec, "kkt_passes": passes,
                         "zeros": int((w == 0).sum()), "seconds": seconds}
        print(f"{name}: F {f_all!r} in {iters} iterations (converged "
              f"{converged}, {seconds:.1f} s); max |g|/l1 at zeros "
              f"{at_zero:.6f}, decrement {dec:.3e} of F -> KKT "
              f"{'passes' if passes else 'fails'}", flush=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
