"""Rank programs for the port's multi-process tests
(``tests/test_torch_distributed.py``).

Each rank joins a gloo process group through a file rendezvous, runs the
same cases on its own row block, and saves what it computed to
``<out>/rank<r>.npz``.  This module imports torch, numpy and the port
only, so a spawned rank starts without JAX.
"""

import os

import numpy as np
import torch


def make_xy(n, d, seed=3):
    """Seeded logistic data (the reference's ``tests/test_solvers.py``
    construction)."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    w_true = (rng.normal(size=d) * (rng.uniform(size=d) < 0.5)).astype(
        np.float32)
    p = 1.0 / (1.0 + np.exp(-3.0 * (X @ w_true)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y


#: The grids' data (250 rows: padding on 4 ranks) and the host-kind
#: solvers' (the reference's 256 × 6 of its mesh-vs-logical tests).
DATA = {"grid": (250, 10), "host": (256, 6)}


def problem(task, reg, solver=None, options=(), max_iters=150,
            tolerance=1e-8):
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    regs = {"l2": RegularizationContext.l2(),
            "elastic_net": RegularizationContext.elastic_net(0.5)}
    return GlmOptimizationProblem(task, GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=max_iters, tolerance=tolerance,
                                  solver=solver, solver_options=options),
        regularization=regs[reg]))


#: name → (task, regularization, solver, solver_options, λ grid, sparse,
#: tolerance, data).  The grids against the reference's mesh stop at 1e-4,
#: above the float32 noise floor where the packages' summation orders
#: decide the last iterations.
CASES = {
    "lbfgs_l2": ("logistic", "l2", None, (), [1.0, 0.1], True, 1e-4,
                 "grid"),
    "owlqn_elastic_net": ("logistic", "elastic_net", None, (), [0.3, 0.1],
                          True, 1e-4, "grid"),
    "admm": ("logistic", "elastic_net", "admm", (("reltol", "1e-6"),),
             [0.2], True, 1e-8, "host"),
    "block_cd": ("logistic", "elastic_net", "block_cd",
                 (("n_blocks", "2"), ("max_rounds", "50")), [0.2], False,
                 1e-8, "host"),
}


def run_case(name, mesh, n_shards=None):
    """One case's grid over ``mesh`` (a process group) or, with
    ``n_shards``, over that many logical shards.  Returns {λ: w} and the
    reductions it made."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.parallel import distributed
    from photon_ml_tpu_torch.solvers import sharded

    task, reg, solver, options, lams, sparse, tol, data = CASES[name]
    X, y = make_xy(*DATA[data])
    prob = problem(task, reg, solver, options, tolerance=tol)
    Xs = sp.csr_matrix(X) if sparse else X
    dist = distributed.shard_glm_data(Xs, y, mesh, n_shards=n_shards,
                                      device="cpu")
    distributed.reset_allreduces()
    if mesh is not None:
        grid = distributed.run_grid_distributed(prob, dist, mesh, lams)
    else:
        grid = sharded.run_grid_sharded(prob, dist, None, lams)
    return ({lam: m.coefficients.means.numpy() for lam, m, _ in grid},
            distributed.ALLREDUCES["count"])


def rank_main(rank, world, init_file, out_dir, driver_argv):
    """One rank: every case of :data:`CASES` over the group, then (when
    ``driver_argv`` is given) the GLM driver with ``--data-parallel
    auto``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from photon_ml_tpu_torch.parallel import distributed, multihost

        mesh = multihost.global_data_mesh()
        saved = {"host_local_rows": np.array(
            multihost.host_local_rows(DATA["grid"][0]))}
        for name in CASES:
            ws, count = run_case(name, mesh)
            for lam, w in ws.items():
                saved[f"{name}/{lam}"] = w
            saved[f"{name}/allreduces"] = np.array(count)
        if driver_argv:
            from photon_ml_tpu_torch.drivers import glm_driver

            result = glm_driver.run(driver_argv)
            saved["driver/ranks"] = np.array(
                result["data_parallel"]["ranks"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    finally:
        dist.destroy_process_group()
