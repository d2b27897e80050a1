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
            tolerance=1e-8, optimizer=None):
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    regs = {"l2": RegularizationContext.l2(),
            "elastic_net": RegularizationContext.elastic_net(0.5)}
    return GlmOptimizationProblem(task, GlmOptimizationConfig(
        optimizer=OptimizerConfig(
            optimizer=OptimizerType(optimizer or "lbfgs"),
            max_iters=max_iters, tolerance=tolerance, solver=solver,
            solver_options=options),
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


# -- the streamed mesh (tests/test_torch_streaming_mesh.py) -------------------


def stream_xy(n=960, d=25, seed=7, density=0.1):
    """The reference's ``_logistic_problem`` shape: an intercept column
    plus sparse normal features, logistic labels; seeded offsets and a
    coefficient vector to evaluate at."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    X = sp.random(n, d - 1, density=density, random_state=seed,
                  format="csr", dtype=np.float32)
    X = sp.hstack([sp.csr_matrix(np.ones((n, 1), np.float32)), X]).tocsr()
    w_true = rng.normal(size=d).astype(np.float32)
    m = np.asarray(X @ w_true).ravel()
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    offsets = rng.normal(size=n).astype(np.float32)
    w = (rng.normal(size=d) * 0.5).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    return X, y, offsets, w, v


#: Chunk rows of the streamed cases (3 chunks of 960 rows; 160 or 80 rows a
#: shard at 2 or 4 ranks).
STREAM_CHUNK = 320


def stream_passes(mesh, n_shards=None, use_kernel=False, kahan=False):
    """One value+gradient pass, a batched pass of two candidates, an HVP
    pass, a Hessian-diagonal pass and the scores over a sharded store, with
    the reductions each pass made."""
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.optim.streaming import StreamingObjective
    from photon_ml_tpu_torch.parallel import distributed

    X, y, offsets, w, v = stream_xy()
    store = make_streaming_glm_data(
        X, y, chunk_rows=STREAM_CHUNK, use_kernel=use_kernel,
        n_shards=n_shards or 1, mesh=mesh, device="cpu")
    sobj = StreamingObjective("logistic", store, mesh=mesh,
                              accumulate="kahan" if kahan else "f32")
    wt, vt = torch.from_numpy(w), torch.from_numpy(v)
    out = {}
    distributed.reset_allreduces()
    val, grad = sobj.value_and_grad(wt, 0.7, offsets=offsets)
    out["vg_allreduces"] = np.array(distributed.ALLREDUCES["count"])
    out["value"], out["grad"] = val.numpy(), grad.numpy()
    vb, gb = sobj.value_and_grad_batch(torch.stack([wt, 0.5 * wt]), 0.7,
                                       offsets=offsets)
    out["batch_value"], out["batch_grad"] = vb.numpy(), gb.numpy()
    distributed.reset_allreduces()
    out["hvp"] = sobj.hvp(wt, vt, 0.7, offsets=offsets).numpy()
    out["hvp_allreduces"] = np.array(distributed.ALLREDUCES["count"])
    out["hdiag"] = sobj.hessian_diagonal(wt, offsets=offsets).numpy()
    out["scores"] = sobj.scores(wt)
    out["transfer_bytes"] = np.array(sobj.transfer_stats.bytes)
    return out


#: The streamed grid's solves: (name, regularization, optimizer).
GRID_SOLVES = (("lbfgs", "l2", "lbfgs"), ("owlqn", "elastic_net", "lbfgs"),
               ("tron", "l2", "tron"))


def stream_grid(mesh, n_shards=None):
    """The reference's ``test_sharded_grid_fit``: an L2 L-BFGS solve at λ =
    1 over a sharded store (160-row chunks), and an elastic-net OWL-QN and a
    TRON solve."""
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.optim.streaming import (
        StreamingObjective,
        streaming_run_grid,
    )

    X, y, *_ = stream_xy(n=640, d=20, density=0.15)
    out = {}
    for name, reg, opt in GRID_SOLVES:
        prob = problem("logistic", reg, max_iters=120, tolerance=1e-9,
                       optimizer=opt)
        store = make_streaming_glm_data(
            X, y, chunk_rows=160, n_shards=n_shards or 1, mesh=mesh,
            device="cpu", use_kernel=False)
        sobj = StreamingObjective(prob.objective, store, mesh=mesh)
        grid = streaming_run_grid(prob, sobj, [1.0], mesh=mesh)
        out[f"grid/{name}"] = grid[0][1].coefficients.means.numpy()
    return out


def stream_rank_main(rank, world, init_file, out_dir, driver_argv):
    """One rank of the streamed-mesh tests: the passes (COO and kernel
    layouts, Kahan), the grid solves, then the GLM driver's streamed route
    with ``--data-parallel auto``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from photon_ml_tpu_torch.parallel import multihost

        mesh = multihost.global_data_mesh()
        saved = {}
        for tag, kw in (("coo", {}), ("kernel", {"use_kernel": True}),
                        ("kahan", {"kahan": True})):
            for k, a in stream_passes(mesh, **kw).items():
                saved[f"{tag}/{k}"] = a
        saved.update(stream_grid(mesh))
        if driver_argv:
            from photon_ml_tpu_torch.drivers import glm_driver

            result = glm_driver.run(driver_argv)
            saved["driver/ranks"] = np.array(
                result["data_parallel"]["ranks"])
            saved["driver/chunks"] = np.array(result["streaming"]["chunks"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    finally:
        dist.destroy_process_group()


# -- GAME over a group (tests/test_torch_game_mesh.py) ------------------------


def zipf_entities(seed, n_entities=60, d=5, max_rows=40, task="logistic"):
    """The reference's ``tests/test_game_hierarchical.py::_zipf_data``:
    long-tailed per-entity row counts (a head bucket that splits over the
    group, a tail that packs whole).  ``task="squared"`` draws Gaussian
    responses from the same margins."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    keys, rows, labels = [], [], []
    true_w = rng.normal(size=(n_entities, d))
    for e in range(n_entities):
        n_e = int(np.clip(rng.zipf(1.7), 1, max_rows))
        for _ in range(n_e):
            x = np.zeros(d, np.float32)
            nz = rng.choice(d, size=rng.integers(1, d + 1), replace=False)
            x[nz] = rng.normal(size=len(nz)).astype(np.float32)
            m = float(x @ true_w[e])
            keys.append(f"e{e}")
            rows.append(x)
            labels.append(float(rng.uniform() < 1 / (1 + np.exp(-m))))
    X = sp.csr_matrix(np.asarray(rows, np.float32))
    y = np.asarray(labels, np.float32)
    if task == "squared":
        y = (np.asarray(X @ np.ones(d, np.float32)).ravel()
             + rng.normal(size=len(y))).astype(np.float32)
    offsets = (0.3 * rng.normal(size=len(y))).astype(np.float32)
    return keys, X, y, np.ones_like(y), offsets


def game_config(max_iters=25, tolerance=1e-7, reg="l2"):
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    regs = {"l2": RegularizationContext.l2(),
            "elastic_net": RegularizationContext.elastic_net(0.5)}
    return GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=max_iters, tolerance=tolerance),
        regularization=regs[reg])


#: GAME random-effect cases: name → (task, zipf seed, entities, width).
RE_CASES = {
    "per_user": ("logistic", 3, 120, 5),
    "per_user_sq": ("squared", 3, 120, 5),
    "per_context": ("logistic", 9, 80, 6),
}

def FACTORED_CONFIG():
    """The factored cases' solves, run to the float32 noise floor (a
    stopped-early alternation's path depends on the sum order)."""
    return game_config(max_iters=200, tolerance=1e-12)


#: The out-of-core cases' device budget (the reference's
#: ``tests/test_ooc_random.py::TestMesh``).
OOC_BUDGET = 200_000


def game_re_cases(mesh, n_shards=None):
    """Every entity-sharded random effect on the RE cases: the bucket-shard
    plan, every block split, the factored effect, and both out of core; a
    cold and a warm train each, and the scores."""
    from photon_ml_tpu_torch.game.data import build_random_effect_dataset
    from photon_ml_tpu_torch.game.distributed import (
        EntityShardedRandomEffectCoordinate,
        entity_sharded_factored_coordinate,
    )
    from photon_ml_tpu_torch.game.hierarchical import (
        ShardedBucketRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.ooc_factored import (
        OutOfCoreFactoredRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.ooc_random import (
        OutOfCoreRandomEffectCoordinate,
    )

    out = {}
    kw = dict(n_shards=n_shards, device="cpu")
    for case, (task, seed, n_ent, d) in RE_CASES.items():
        keys, X, y, w, offsets = zipf_entities(seed, n_ent, d, task=task)
        host = build_random_effect_dataset(keys, X, y, w, device=False)
        off = torch.from_numpy(offsets)
        coords = {
            "bucket": ShardedBucketRandomEffectCoordinate(
                "re", host, mesh, task, game_config(), reg_weight=0.7,
                entity_key="uid", **kw),
            "split": EntityShardedRandomEffectCoordinate(
                "re", host, mesh, task, game_config(), reg_weight=0.7, **kw),
            "ooc": OutOfCoreRandomEffectCoordinate(
                "re", host, task, game_config(), reg_weight=0.7,
                device_budget_bytes=OOC_BUDGET, mesh=mesh, **kw),
        }
        if case == "per_user":
            out[f"{case}/plan"] = np.array(
                [-1 if p[0] == "split" else p[1]
                 for p in coords["bucket"].plan.placements])
            out[f"{case}/ooc_plan"] = np.array(
                [(s.block_idx, s.lane_lo, s.lane_hi, s.padded_e, s.bytes,
                  -1 if s.placement[0] == "split" else s.placement[1])
                 for g in coords["ooc"].slice_plan for s in g])
        for name, c in coords.items():
            st = c.train(off)
            for b, s in enumerate(st):
                out[f"{case}/{name}/state{b}"] = np.asarray(
                    s.numpy() if isinstance(s, torch.Tensor) else s)
            out[f"{case}/{name}/score"] = c.score(st).numpy()
            st2 = c.train(off, warm_state=st)
            out[f"{case}/{name}/warm_score"] = c.score(st2).numpy()
            if name == "bucket":
                out[f"{case}/{name}/n_entities"] = np.array(
                    len(c.finalize(st).coefficients))
        if task != "logistic" or case != "per_user":
            continue
        for name, c in (
                ("factored", entity_sharded_factored_coordinate(
                    "re", host, mesh, task, FACTORED_CONFIG(),
                    rank=2, reg_weight=0.7, **kw)),
                ("ooc_factored", OutOfCoreFactoredRandomEffectCoordinate(
                    "re", host, task, FACTORED_CONFIG(), rank=2,
                    reg_weight=0.7, device_budget_bytes=OOC_BUDGET,
                    mesh=mesh, **kw))):
            st = c.train(off)
            out[f"{case}/{name}/V"] = st[1].numpy()
            out[f"{case}/{name}/score"] = c.score(st).numpy()
    return out


def fixed_xy(n=300, d=10, seed=13):
    """The reference's ``tests/test_game_distributed.py`` fixed-effect
    problem: sparse logistic rows and random offsets."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=0.4, random_state=seed, format="csr",
                  dtype=np.float32)
    m = np.asarray(X @ rng.normal(size=d)).ravel()
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    offsets = (0.3 * rng.normal(size=n)).astype(np.float32)
    return X, y, offsets


def game_fixed_cases(mesh):
    """The row-sharded fixed effect: a solve, its scores, a solve after a
    ``reg_weight`` change (no re-shard), and the finalized variances."""
    from photon_ml_tpu_torch.game.distributed import (
        DistributedFixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.parallel import distributed

    X, y, offsets = fixed_xy()
    cfg = game_config(max_iters=100, tolerance=1e-7)
    cfg = type(cfg)(optimizer=cfg.optimizer,
                    regularization=cfg.regularization,
                    compute_variances=True)
    coord = DistributedFixedEffectCoordinate(
        "fixed", X, y, mesh, "logistic", cfg, reg_weight=1.0, device="cpu")
    dist_before = coord.dist
    off = torch.from_numpy(offsets)
    distributed.reset_allreduces()
    w = coord.train(off)
    out = {"fixed/w": w.numpy(), "fixed/score": coord.score(w).numpy(),
           "fixed/allreduces": np.array(distributed.ALLREDUCES["count"])}
    coord.reg_weight = 5.0
    w5 = coord.train(off)
    out["fixed/w_reg5"] = w5.numpy()
    out["fixed/same_shards"] = np.array(coord.dist is dist_before)
    model = coord.finalize(w5, offsets=offsets)
    out["fixed/variances"] = model.model.coefficients.variances.numpy()
    return out


def game_cd_case(mesh, n_shards=None):
    """The reference's ``test_streamed_game_cd_on_mesh``: a streamed fixed
    effect (this rank's shard of each chunk) and a per-user random effect
    over the group, two coordinate-descent iterations."""
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.game.descent import CoordinateDescent
    from photon_ml_tpu_torch.game.data import build_random_effect_dataset
    from photon_ml_tpu_torch.game.hierarchical import (
        ShardedBucketRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.streaming import (
        StreamingFixedEffectCoordinate,
    )

    keys, Xu, y, w, _ = zipf_entities(3, 120, 5)
    X, *_ = fixed_xy(n=len(y), d=8)
    cfg = game_config(max_iters=50, tolerance=1e-8)
    store = make_streaming_glm_data(X, y, chunk_rows=128, mesh=mesh,
                                    n_shards=n_shards or 1, device="cpu",
                                    use_kernel=False)
    fixed = StreamingFixedEffectCoordinate("fixed", store, "logistic", cfg,
                                           reg_weight=1.0, mesh=mesh)
    re = ShardedBucketRandomEffectCoordinate(
        "per_user", build_random_effect_dataset(keys, Xu, y, w,
                                                device=False),
        mesh, "logistic", cfg, reg_weight=1.0, entity_key="userId",
        n_shards=n_shards, device="cpu")
    res = CoordinateDescent([fixed, re]).run(torch.zeros(len(y)),
                                              n_iterations=2)
    return {"cd/fixed": res.states["fixed"].numpy(),
            "cd/total": (res.scores["fixed"]
                         + res.scores["per_user"]).numpy()}


def game_rank_main(rank, world, init_file, out_dir, driver_runs):
    """One rank of the GAME-over-a-group tests: the coordinates, the
    streamed descent, then each ``(name, argv)`` GAME training driver run
    of ``driver_runs`` with ``--data-parallel auto``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from photon_ml_tpu_torch.parallel import multihost

        mesh = multihost.global_data_mesh()
        saved = {}
        saved.update(game_fixed_cases(mesh))
        saved.update(game_re_cases(mesh))
        saved.update(game_cd_case(mesh))
        if driver_runs:
            from photon_ml_tpu_torch.drivers import game_training_driver

            for name, argv in driver_runs:
                result = game_training_driver.run(argv)
                saved[f"driver/{name}/ranks"] = np.array(
                    result["data_parallel"]["ranks"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    finally:
        dist.destroy_process_group()


# -- tensor parallel (tests/test_torch_tensor_parallel.py) ---------------------


def tp_xy(n=480, d=397, seed=7):
    """A wide sparse logistic problem with row weights and offsets; d is
    not a multiple of the grid's tp, so the padded columns are real."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=0.05, random_state=seed, format="csr",
                  dtype=np.float32)
    w_true = (rng.normal(size=d) * (rng.uniform(size=d) < 0.2))
    m = np.asarray(X @ w_true).ravel()
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    offsets = (0.3 * rng.normal(size=n)).astype(np.float32)
    return X, y, weights, offsets


def tp_cases(mesh):
    """L-BFGS (L2), OWL-QN (elastic net, the intercept column exempt) and
    TRON over the (data × feature) grid ``mesh`` of the port's
    ``parallel/tensor.py``: each case's whole w, value and iterations."""
    from photon_ml_tpu_torch.optim.lbfgs import LBFGSConfig
    from photon_ml_tpu_torch.optim.owlqn import OWLQNConfig
    from photon_ml_tpu_torch.optim.tron import TRONConfig
    from photon_ml_tpu_torch.parallel import tensor

    X, y, weights, offsets = tp_xy()
    data = tensor.shard_glm_data_dp_tp(X, y, mesh, weights=weights,
                                       offsets=offsets, device="cpu")
    mask = np.ones(data.padded_width, np.float32)
    mask[0] = 0.0
    runs = {
        "lbfgs": lambda: tensor.tp_lbfgs_solve(
            "logistic", data, mesh, reg_weight=0.7,
            config=LBFGSConfig(max_iters=60)),
        "owlqn": lambda: tensor.tp_owlqn_solve(
            "logistic", data, mesh, l1_weight=0.75, l2_weight=0.75,
            config=OWLQNConfig(max_iters=60), l1_mask=mask),
        "tron": lambda: tensor.tp_tron_solve(
            "logistic", data, mesh, reg_weight=0.8,
            config=TRONConfig(max_iters=30)),
    }
    out = {}
    for name, run in runs.items():
        res = run()
        out[f"{name}/w"] = res.w.numpy()
        out[f"{name}/value"] = np.asarray(res.value.item())
        out[f"{name}/iterations"] = np.asarray(res.iterations)
    return out


def variance_case(mesh):
    """The reference's ``TestMeshVariancesFixedEffect``: a GAME fixed
    effect with coefficient variances, over ``mesh`` (a data group) or on
    one process (``mesh=None``)."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.game.estimator import (
        FixedEffectCoordinateConfig,
        GameEstimator,
    )
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    rng = np.random.default_rng(20260729)
    n = 320
    Xg = rng.normal(size=(n, 5)).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-Xg[:, 0]))).astype(
        np.float32)
    opt = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=40),
        regularization=RegularizationContext.l2(), compute_variances=True)
    configs = {"fixed": FixedEffectCoordinateConfig("global", opt, 0.6)}
    model, _ = GameEstimator("logistic", configs, 1, device="cpu",
                             mesh=mesh).fit({"global": sp.csr_matrix(Xg)},
                                            {}, y)
    return model["fixed"].model.coefficients.variances.numpy()


def tp_rank_main(rank, world, init_file, out_dir, dp, tp):
    """One rank of a dp × tp grid: :func:`tp_cases` over the group, then
    :func:`variance_case` over the whole group as one data mesh."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        from photon_ml_tpu_torch.parallel import distributed, multihost
        from photon_ml_tpu_torch.parallel import tensor

        mesh = tensor.dp_tp_mesh(dp, tp, distributed=True)
        distributed.reset_allreduces()
        saved = tp_cases(mesh)
        saved["gathers"] = np.asarray(distributed.ALLREDUCES["count"])
        saved["variances"] = variance_case(multihost.global_data_mesh())
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **saved)
    finally:
        dist.destroy_process_group()
