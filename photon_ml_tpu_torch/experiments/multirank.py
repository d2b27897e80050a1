"""Data-parallel GLM over the cards of one host: an NCCL process group's λ
grid, consensus ADMM and block CD against one card.

    python -m photon_ml_tpu_torch.experiments.multirank [--ranks 4]
        [--rows N] [--device D]

Spawns one process a card (NCCL through a ``FileStore`` in a temporary
directory; gloo with ``--device cpu``).  Every rank draws the valued
matrix of ``chip_smoke.py``'s phase 3 (N x 8192, 32 normal values a row,
logistic labels, seed 0) and keeps its ``host_local_rows`` block on its
card (``shard_glm_data(X, y, group)``).  Then:

1. the L2-logistic λ grid (10, 1, 0.1; 30 iterations, variances) by
   ``run_grid_distributed``: every rank's coefficients bitwise equal, one
   all-reduce an evaluation or variance pass (the SpMV launches), and on
   rank 0 against the same grid on one card: the float64 objective of each
   λ within 1e-5 relative, the variances within 1e-5 of one card's at the
   group's solution; walls of both (the group's first, cold: it
   includes the communicator's first collective);
2. the all-reduce of one evaluation (``[value, grad]``, 8193 floats) alone:
   median of 50 under CUDA events;
3. consensus ADMM (elastic net, λ = 5) over the group against ADMM over as
   many logical shards on rank 0's card: bitwise (a round's payloads are
   added in rank order either way);
4. block CD over the group on ``bench_solvers``' ill-conditioned dense
   draw (2^17 x 512, elastic net) against as many logical shards on rank
   0's card: the largest coefficient difference (the logical shards'
   elementwise ops run batched over the shard axis).

Rank 0 prints one JSON line; any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np
import torch

N_ROWS, D, K = 1 << 20, 1 << 13, 32
GRID = (10.0, 1.0, 0.1)
ADMM_LAM = 5.0
ADMM_OPTIONS = (("rho", "64"), ("reltol", "1e-4"),
                ("over_relaxation", "1.8"))
BCD_ROWS, BCD_D = 1 << 17, 512
BCD_OPTIONS = (("n_blocks", "8"), ("sweeps", "1"), ("max_rounds", "800"),
               ("tolerance", "1e-9"))
#: seconds a rank may take before the launcher stops the group.
TIMEOUT = 900


def valued(n: int, seed: int = 0):
    """(CSR X, labels): n rows x 8192, 32 normal values a row, logistic
    labels of a sparse w_true (``chip_smoke.py``'s ``bench_triples``)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), K)
    cols = rng.integers(0, D, size=n * K).astype(np.int64)
    vals = rng.normal(size=n * K).astype(np.float32)
    w_true = (rng.normal(size=D) * (rng.uniform(size=D) < 0.2)).astype(
        np.float32)
    margins = np.zeros(n, np.float32)
    np.add.at(margins, rows, vals * w_true[cols])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margins))).astype(
        np.float32)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, D)), y


def ill_conditioned(n: int, d: int, seed: int = 7):
    """``bench_solvers``' dense draw: a geometric spectrum 1 → 0.02 under a
    random rotation, squared-loss labels."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, d))
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    X = ((Z * np.geomspace(1.0, 0.02, d)) @ Q.T / np.sqrt(d)).astype(
        np.float32)
    w_true = (rng.normal(size=d) * (rng.uniform(size=d) < 0.3)).astype(
        np.float32)
    y = (X @ w_true + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _problem(task, reg, solver=None, options=(), max_iters=30,
             tol=1e-7, compute_variances=False):
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
    )

    return GlmOptimizationProblem(task, GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=max_iters, tolerance=tol,
                                  solver=solver, solver_options=options),
        regularization=reg, compute_variances=compute_variances))


def _objective(X, y, w, l1, l2):
    w = w.double().cpu().numpy()
    m = np.asarray(X @ w, np.float64).ravel()
    return float(np.sum(np.logaddexp(0.0, m) - y * m)
                 + l1 * np.abs(w).sum() + 0.5 * l2 * w @ w)


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"multirank: {what}")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_rank(rank: int, world: int, dev: torch.device, rows: int) -> dict:
    """Every case on this rank; rank 0's dict carries the comparisons."""
    import torch.distributed as dist

    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )
    from photon_ml_tpu_torch.parallel import distributed, multihost
    from photon_ml_tpu_torch.solvers import sharded
    from photon_ml_tpu_torch.utils.timer import median_ms

    mesh = multihost.global_data_mesh()
    out = {"ranks": world, "rows": rows,
           "host_local_rows": multihost.host_local_rows(rows)}
    X, y = valued(rows)
    t0 = time.perf_counter()
    held = distributed.shard_glm_data(X, y, mesh, device=dev)
    _sync(dev)
    out["shard_build_s"] = time.perf_counter() - t0

    # 1. the λ grid over the group (its wall includes the library load
    # and the communicator's first collective).
    problem = _problem("logistic", RegularizationContext.l2(),
                       compute_variances=True)
    dist.barrier()
    _kernels.reset_launches()
    distributed.reset_allreduces()
    t0 = time.perf_counter()
    grid = distributed.run_grid_distributed(problem, held, mesh, list(GRID))
    _sync(dev)
    out["group_grid_s"] = time.perf_counter() - t0
    reduces = distributed.ALLREDUCES["count"]
    if dev.type == "cuda":
        evals = _kernels.LAUNCHES["rmatvec"] + _kernels.LAUNCHES["sq_rmatvec"]
        _need(reduces == evals, f"{reduces} all-reduces against {evals} "
              "evaluations and variance passes")
    out["group_allreduces"] = reduces
    ws = torch.stack([m.coefficients.means for _, m, _ in grid])
    every = [torch.empty_like(ws) for _ in range(world)]
    dist.all_gather(every, ws)
    _need(all(torch.equal(e, ws) for e in every),
          "the ranks' coefficients differ")

    # 2. one evaluation's all-reduce alone.
    val = torch.zeros((), dtype=torch.float32, device=dev)
    grad = torch.zeros(D, dtype=torch.float32, device=dev)
    out["allreduce_ms"] = median_ms(lambda: mesh.reduce(val, grad), dev)

    # 3. ADMM over the group.
    admm = _problem("logistic", RegularizationContext.elastic_net(0.5),
                    "admm", ADMM_OPTIONS, max_iters=60)
    dist.barrier()
    t0 = time.perf_counter()
    [(_, m_admm, r_admm)] = sharded.run_grid_sharded(admm, held, mesh,
                                                     [ADMM_LAM])
    _sync(dev)
    out["group_admm_s"] = time.perf_counter() - t0
    out["admm_rounds"] = r_admm.iterations

    # 4. block CD over the group.
    Xb, yb = ill_conditioned(BCD_ROWS, BCD_D)
    bcd_lam = 0.3 * BCD_ROWS / 8192
    bcd = _problem("linear", RegularizationContext.elastic_net(0.5),
                   "block_cd", BCD_OPTIONS, tol=1e-9)
    held_b = distributed.shard_glm_data(Xb, yb, mesh, device=dev)
    dist.barrier()
    t0 = time.perf_counter()
    [(_, m_bcd, r_bcd)] = sharded.run_grid_sharded(bcd, held_b, mesh,
                                                   [bcd_lam])
    _sync(dev)
    out["group_block_cd_s"] = time.perf_counter() - t0
    out["block_cd_rounds"] = r_bcd.iterations
    dist.barrier()
    if rank != 0:
        return out

    # Rank 0 against one card (no collective from here on).
    from photon_ml_tpu_torch.data.dataset import make_glm_data

    data = make_glm_data(X, y, device=dev)
    t0 = time.perf_counter()
    single = problem.run_grid(data, list(GRID))
    _sync(dev)
    out["single_grid_s"] = time.perf_counter() - t0
    gaps, var_errs = {}, {}
    for (lam, m, _), (_, m1, _) in zip(grid, single):
        l2 = float(lam)
        f, f1 = (_objective(X, y, w, 0.0, l2) for w in (
            m.coefficients.means, m1.coefficients.means))
        gaps[lam] = abs(f - f1) / max(1.0, abs(f1))
        # The variances at the group's own solution, on one card.
        v = m.coefficients.variances
        v1 = problem.coefficient_variances(m.coefficients.means, data, lam)
        var_errs[lam] = float(((v - v1).abs() / v1.abs()).max())
        _need(gaps[lam] <= 1e-5, f"λ={lam}: objective gap {gaps[lam]:.3g}")
        _need(var_errs[lam] <= 1e-5,
              f"λ={lam}: variances {var_errs[lam]:.3g} apart")
    out["grid_gaps"] = {str(k): v for k, v in gaps.items()}
    out["variance_errs"] = {str(k): v for k, v in var_errs.items()}
    del data

    logical = distributed.shard_glm_data(X, y, None, n_shards=world,
                                         device=dev)
    [(_, m_log, r_log)] = sharded.run_grid_sharded(admm, logical, None,
                                                   [ADMM_LAM])
    _need(torch.equal(m_log.coefficients.means, m_admm.coefficients.means)
          and r_log.iterations == r_admm.iterations,
          "ADMM over the group is not bitwise ADMM over logical shards")
    del logical
    logical_b = distributed.shard_glm_data(Xb, yb, None, n_shards=world,
                                           device=dev)
    [(_, m_logb, r_logb)] = sharded.run_grid_sharded(bcd, logical_b, None,
                                                     [bcd_lam])
    out["block_cd_vs_logical_max_diff"] = float(
        (m_logb.coefficients.means - m_bcd.coefficients.means).abs().max())
    out["block_cd_logical_rounds"] = r_logb.iterations
    out["block_cd_bitwise"] = bool(torch.equal(m_logb.coefficients.means,
                                               m_bcd.coefficients.means))
    return out


def _rank_main(rank, world, store, device_type, rows, result_path):
    import datetime

    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.FileStore(store, world), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        out = run_rank(rank, world, dev, rows)
        if rank == 0:
            out["device"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")
            with open(result_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--rows", type=int, default=N_ROWS)
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, one card a rank) or cpu (gloo)")
    args = p.parse_args(argv)
    from photon_ml_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() < args.ranks:
        raise RuntimeError(f"{args.ranks} ranks need {args.ranks} cards; "
                           f"{torch.cuda.device_count()} visible")
    if dev.type == "cuda":
        from photon_ml_tpu_torch.ops import _kernels

        _kernels.build_libraries("spmv")  # once, before the ranks load it
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="photon_multirank_") as td:
        result = os.path.join(td, "result.json")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, args.ranks, os.path.join(td, "store"),
                                   dev.type, args.rows, result))
                 for r in range(args.ranks)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + TIMEOUT
        for proc in procs:
            proc.join(max(1.0, deadline - time.monotonic()))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
        codes = [proc.exitcode for proc in procs]
        if codes != [0] * args.ranks:
            raise RuntimeError(f"multirank: rank exit codes {codes}")
        with open(result) as f:
            out = json.load(f)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
