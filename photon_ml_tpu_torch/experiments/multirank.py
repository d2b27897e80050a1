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

``--game`` runs GAME over the group instead, on ``bench_game_multi_re``'s
draw at full width (``experiments/common.py``, 646,253 rows):

1. the per-user bucket-shard plan (its head bucket split, its tail
   packed), then one coordinate-descent iteration of the three random
   effects over the group (``game/hierarchical.py``): every per-entity
   coefficient within 1e-6 of the largest |w| of the same descent on one
   card, every score within 1e-5 of its row's Σ|x·w|;
2. the per-user effect out of core at an eighth of its bytes over the
   group (``game/ooc_random.py``), against one card's resident
   coordinate at the same tolerances;
3. the row-sharded fixed effect (``game/distributed.py``, a 1/k row block
   a rank): its float64 objective within 1e-5 of one card's solve;
4. phase 9a's store (``--stream-rows`` x 8192, 4 chunks) sharded over the
   group: one value+gradient pass is one all-reduce and lands within 1e-5
   of Σ|terms| of the resident pass.

Walls are host clocks ending in a synchronize; the descent and the pass
run twice, and the second (warm) run is compared with a warm run on one
card.

``--share-card`` puts every rank on card 0 over gloo (NCCL refuses two
ranks on one card; ``chip_smoke.py`` phase 12b on a one-card machine); its
times are of ranks sharing one card, not a speed across cards.
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


def _timed(fn, dev):
    """(fn(), seconds) on the host clock, ending in a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


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


#: --game: the random effects' solver (chip_smoke.py phase 6: 10
#: iterations at 1e-6, L2 λ = 1), the offsets' seed, the bucket grid.
GAME_RE_ITERS, GAME_TOL, GAME_OFFSET_SEED, GAME_BUCKET_GROWTH = (
    10, 1e-6, 100, 4.0)


def _game_config():
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import (
        RegularizationContext,
    )

    return GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=GAME_RE_ITERS,
                                  tolerance=GAME_TOL),
        regularization=RegularizationContext.l2())


def _abs_scores(ds, state, n: int) -> np.ndarray:
    """Σ_j |x_ij·w_ij| of every row (active and passive blocks): the scale
    a coordinate's scores are held to."""
    out = np.zeros(n + 1)
    passive = ds.passive_blocks or [None] * len(ds.blocks)
    for b, pb, w in zip(ds.blocks, passive, state):
        w = np.abs(np.asarray(w, np.float64))[:b.n_entities]
        for blk in (b, pb):
            if blk is not None:
                s = np.einsum("erd,ed->er",
                              np.abs(np.asarray(blk.X, np.float64)), w)
                out[np.asarray(blk.row_index).reshape(-1)] = s.reshape(-1)
    return out[:n]


def _game_errs(ds, st, one, sc, sc1, n: int) -> tuple[float, float]:
    """(largest coefficient difference over the largest |w|, largest score
    difference over its row's Σ|x·w|) of a group's state and scores
    against one card's."""
    from photon_ml_tpu_torch.device import to_numpy

    one = [to_numpy(w) for w in one]
    scale = max(float(np.abs(w).max()) for w in one)
    coef = max(float(np.abs(to_numpy(a)[:b.shape[0]] - b).max())
               for a, b in zip(st, one)) / max(scale, 1e-30)
    rows = _abs_scores(ds, one, n)
    diff = np.abs(to_numpy(sc).astype(np.float64)
                  - to_numpy(sc1).astype(np.float64))
    return coef, float((diff / np.maximum(rows, 1e-30)).max())


def run_game_rank(rank: int, world: int, dev: torch.device,
                  stream_rows: int, entities: int = 100_000) -> dict:
    """The ``--game`` cases on this rank; rank 0's dict carries the
    comparisons with one card."""
    import torch.distributed as dist

    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.experiments.common import game_multi_re_draw
    from photon_ml_tpu_torch.game.coordinates import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.data import build_random_effect_dataset
    from photon_ml_tpu_torch.game.descent import CoordinateDescent
    from photon_ml_tpu_torch.game.distributed import (
        DistributedFixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.hierarchical import (
        ShardedBucketRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.ooc_random import (
        OutOfCoreRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.ops import _kernels
    from photon_ml_tpu_torch.optim.streaming import StreamingObjective
    from photon_ml_tpu_torch.parallel import distributed, multihost

    mesh = multihost.global_data_mesh()
    t0 = time.perf_counter()
    n, Xg, y, effects = game_multi_re_draw(entities=entities)
    opt = _game_config()
    rng = np.random.default_rng(GAME_OFFSET_SEED)
    offsets = torch.as_tensor(0.5 * rng.normal(size=n).astype(np.float32),
                              device=dev)
    ones = np.ones(n, np.float32)
    out = {"ranks": world, "rows": n, "backend": mesh.backend}
    hosts, coords = {}, []
    for name, keys, Xe, cap in effects:
        hosts[name] = build_random_effect_dataset(
            keys, Xe, y, ones, max_rows_per_entity=cap,
            bucket_growth=GAME_BUCKET_GROWTH, device=False)
        coords.append(ShardedBucketRandomEffectCoordinate(
            name, hosts[name], mesh, "logistic", opt, reg_weight=1.0,
            entity_key=name, device=dev))
        plan = coords[-1].plan
        out[f"plan.{name}"] = dict(n_split=plan.n_split,
                                   n_packed=plan.n_packed,
                                   imbalance_ratio=plan.imbalance_ratio)
    out["build_s"] = time.perf_counter() - t0
    user = coords[0]
    blocks = hosts["per_user"].blocks
    costs = [b.n_entities * b.rows_per_entity * b.block_dim for b in blocks]
    head, tail = int(np.argmax(costs)), int(np.argmin(costs))
    _need(user.plan.placements[head] == ("split",)
          and user.plan.placements[tail][0] == "pack",
          f"per-user plan {user.plan.placements}: the costliest bucket "
          f"{head} must split and the cheapest {tail} pack")

    # 1. one descent iteration of the three random effects, twice: the
    # first pays the process's first collectives and allocations.
    dist.barrier()
    _, out["descent_cold_s"] = _timed(
        lambda: CoordinateDescent(coords).run(offsets, n_iterations=1), dev)
    dist.barrier()
    _kernels.reset_launches()
    distributed.reset_allreduces()
    res, out["descent_s"] = _timed(
        lambda: CoordinateDescent(coords).run(offsets, n_iterations=1), dev)
    out["descent_gathers"] = distributed.GATHERS["count"]
    out["descent_allreduces"] = distributed.ALLREDUCES["count"]
    staged = {"descent": dict(distributed.HOST_STAGED)}

    # 2. per-user out of core at an eighth of its bytes.
    nbytes = sum(int(a.nbytes) for b in blocks for a in b.leaves())
    ooc = OutOfCoreRandomEffectCoordinate(
        "per_user", hosts["per_user"], "logistic", opt, reg_weight=1.0,
        entity_key="per_user", device_budget_bytes=nbytes // 8, mesh=mesh,
        device=dev)
    dist.barrier()
    distributed.reset_allreduces()
    t0 = time.perf_counter()
    st_o = ooc.train(offsets)
    sc_o = ooc.score(st_o)
    _sync(dev)
    staged["ooc"] = dict(distributed.HOST_STAGED)
    out["ooc"] = dict(train_score_s=time.perf_counter() - t0,
                      groups=len(ooc.slice_plan),
                      parts=sum(map(len, ooc.pass_plan)))

    # 3. the row-sharded fixed effect.
    fixed = DistributedFixedEffectCoordinate(
        "fixed", Xg, y, mesh, "logistic", opt, reg_weight=1.0, device=dev)
    dist.barrier()
    _kernels.reset_launches()
    distributed.reset_allreduces()
    t0 = time.perf_counter()
    w_f = fixed.train(offsets)
    sc_f = fixed.score(w_f)
    _sync(dev)
    out["fixed"] = dict(solve_s=time.perf_counter() - t0,
                        rows_per=fixed.dist.rows_per,
                        allreduces=distributed.ALLREDUCES["count"],
                        launches=dict(_kernels.LAUNCHES))
    staged["fixed"] = dict(distributed.HOST_STAGED)
    del fixed

    # 4. phase 9a's store sharded over the group: one pass.
    Xv, yv = valued(stream_rows)
    t0 = time.perf_counter()
    store = make_streaming_glm_data(Xv, yv, chunk_rows=stream_rows // 4,
                                    mesh=mesh, device=dev)
    build_s = time.perf_counter() - t0
    sobj = StreamingObjective("logistic", store, mesh=mesh)
    w9 = torch.randn(D, generator=torch.Generator().manual_seed(17)).to(
        dev) * 0.05
    dist.barrier()
    _kernels.reset_launches()
    _, cold_s = _timed(lambda: sobj.value_and_grad(w9, 1.0), dev)
    dist.barrier()
    distributed.reset_allreduces()
    (v9, g9), pass_s = _timed(lambda: sobj.value_and_grad(w9, 1.0), dev)
    out["stream"] = dict(pass_s=pass_s, cold_pass_s=cold_s, build_s=build_s,
                         parts=len(store.chunks),
                         rows_per_part=store.per_shard,
                         allreduces=distributed.ALLREDUCES["count"],
                         launches=dict(_kernels.LAUNCHES),
                         bytes=sobj.transfer_stats.bytes)
    staged["stream"] = dict(distributed.HOST_STAGED)
    _need(out["stream"]["allreduces"] == 1,
          f"a streamed pass made {out['stream']['allreduces']} all-reduces")
    del store, sobj
    # Every rank's launches of the two shard instances, summed on rank 0.
    counts = torch.tensor([[out[k]["launches"].get(op, 0)
                            for k in ("fixed", "stream")
                            for op in ("matvec", "rmatvec")]],
                          dtype=torch.float64, device=dev)
    every = mesh.all_gather(counts).sum(0)[0].tolist()
    out["launches_all_ranks"] = {
        f"{k}.{op}": int(every[i]) for i, (k, op) in enumerate(
            (k, op) for k in ("fixed", "stream")
            for op in ("matvec", "rmatvec"))}
    # The collectives each case copied through host memory (a gloo group
    # on the card).
    out["host_staged"] = staged
    dist.barrier()
    if rank != 0:
        return out

    # Rank 0 against one card (no collective from here on).
    one = [RandomEffectCoordinate(
        name, build_random_effect_dataset(
            keys, Xe, y, ones, max_rows_per_entity=cap,
            bucket_growth=GAME_BUCKET_GROWTH, device=dev),
        "logistic", opt, reg_weight=1.0, entity_key=name)
        for name, keys, Xe, cap in effects]
    _, out["one_card_descent_cold_s"] = _timed(
        lambda: CoordinateDescent(one).run(offsets, n_iterations=1), dev)
    res1, out["one_card_descent_s"] = _timed(
        lambda: CoordinateDescent(one).run(offsets, n_iterations=1), dev)
    for (name, *_), c in zip(effects, coords):
        coef, score = _game_errs(hosts[name], res.states[name],
                                 res1.states[name], res.scores[name],
                                 res1.scores[name], n)
        out[f"descent.{name}"] = dict(coef_err=coef, score_err=score)
        _need(coef <= 1e-6 and score <= 1e-5,
              f"descent {name}: coefficients {coef:.3g} of the largest "
              f"|w| (limit 1e-6), scores {score:.3g} of Σ|x·w| (limit "
              "1e-5)")
    st1 = one[0].train(offsets)
    coef, score = _game_errs(hosts["per_user"], st_o, st1, sc_o,
                             one[0].score(st1), n)
    _need(coef <= 1e-6 and score <= 1e-5,
          f"out-of-core per_user over the group: coefficients {coef:.3g}, "
          f"scores {score:.3g}")
    out["ooc"].update(coef_err=coef, score_err=score)
    del one

    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
    from photon_ml_tpu_torch.game.data import FixedEffectDataset

    fixed1 = FixedEffectCoordinate(
        "fixed", FixedEffectDataset(make_glm_data(Xg, y, device=dev),
                                    n_global_rows=n),
        "logistic", opt, reg_weight=1.0)
    w_1 = fixed1.train(offsets)
    off64 = offsets.double().cpu().numpy()

    def f64(w):
        w = w.double().cpu().numpy()
        m = np.asarray(Xg @ w).ravel() + off64
        return float(np.sum(np.logaddexp(0.0, m) - y * m) + 0.5 * w @ w)

    f_g, f_1 = f64(w_f), f64(w_1)
    gap = abs(f_g - f_1) / abs(f_1)
    _need(gap <= 1e-5, f"the row-sharded fixed effect: objective gap "
          f"{gap:.3g}")
    out["fixed"].update(objective_gap=gap,
                        score_err=float((sc_f - fixed1.score(w_f)).abs()
                                        .max()))
    del fixed1

    data = make_glm_data(Xv, yv, use_kernel=False, device=dev)
    from photon_ml_tpu_torch.ops import losses as losses_lib
    from photon_ml_tpu_torch.optim.objective import GlmObjective

    obj = GlmObjective(losses_lib.get("logistic"))
    v_r, g_r = obj.value_and_grad(w9, data, 1.0)
    m = obj.margins(w9, data)
    vscale = float((data.weights * obj.loss.value(m, data.labels)).abs()
                   .sum() + 0.5 * torch.dot(w9, w9))
    u = (data.weights * obj.loss.d1(m, data.labels)).abs()
    F = data.features
    absF = type(F)(F.row_ids, F.col_ids, F.values.abs(), F.n_rows, F.n_cols)
    gscale = absF.rmatvec(u) + w9.abs()
    v_err = abs(float(v9) - float(v_r)) / vscale
    g_err = float(((g9 - g_r).abs() / gscale.clamp_min(1e-30)).max())
    _need(v_err <= 1e-5 and g_err <= 1e-5,
          f"the sharded streamed pass: value {v_err:.3g}, gradient "
          f"{g_err:.3g} of Σ|terms| (limit 1e-5)")
    out["stream"].update(value_err=v_err, grad_err=g_err)
    del data
    # The same store on this one card (4 chunks, all their rows).
    one_store = make_streaming_glm_data(Xv, yv, chunk_rows=stream_rows // 4,
                                        device=dev)
    one_obj = StreamingObjective("logistic", one_store)
    one_obj.value_and_grad(w9, 1.0)
    _, out["stream"]["one_card_pass_s"] = _timed(
        lambda: one_obj.value_and_grad(w9, 1.0), dev)
    return out


def _rank_main(rank, world, store, device_type, rows, result_path,
               game=False, share_card=False, entities=None):
    import datetime

    import torch.distributed as dist

    if device_type == "cuda":
        card = 0 if share_card else rank
        torch.cuda.set_device(card)
        dev = torch.device("cuda", card)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    backend = ("nccl" if device_type == "cuda" and not share_card
               else "gloo")
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        out = (run_game_rank(rank, world, dev, rows, entities) if game
               else run_rank(rank, world, dev, rows))
        if rank == 0:
            out["device"] = (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")
            with open(result_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    t_main = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--rows", type=int, default=N_ROWS)
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, one card a rank) or cpu (gloo)")
    p.add_argument("--game", action="store_true",
                   help="GAME over the group (see the module docstring); "
                   "--rows sizes the streamed store")
    p.add_argument("--game-entities", type=int, default=100_000,
                   help="--game: users of the draw (100,000: full width)")
    p.add_argument("--share-card", action="store_true",
                   help="every rank on card 0, over gloo (NCCL refuses "
                   "two ranks on one card)")
    args = p.parse_args(argv)
    from photon_ml_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if (dev.type == "cuda" and not args.share_card
            and torch.cuda.device_count() < args.ranks):
        raise RuntimeError(f"{args.ranks} ranks need {args.ranks} cards; "
                           f"{torch.cuda.device_count()} visible")
    if dev.type == "cuda":
        from photon_ml_tpu_torch.ops import _kernels

        _kernels.build_libraries("spmv")  # once, before the ranks load it
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="photon_multirank_") as td:
        result = os.path.join(td, "result.json")
        procs = []
        try:
            for r in range(args.ranks):
                proc = ctx.Process(
                    target=_rank_main,
                    args=(r, args.ranks, os.path.join(td, "store"),
                          dev.type, args.rows, result, args.game,
                          args.share_card, args.game_entities))
                procs.append(proc)
                proc.start()
            deadline = time.monotonic() + TIMEOUT
            for proc in procs:
                proc.join(max(1.0, deadline - time.monotonic()))
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        codes = [proc.exitcode for proc in procs]
        if codes != [0] * args.ranks:
            raise RuntimeError(f"multirank: rank exit codes {codes}")
        with open(result) as f:
            out = json.load(f)
    out["wall_s"] = time.perf_counter() - t_main
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
