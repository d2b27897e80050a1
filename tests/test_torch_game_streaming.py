"""The port's streamed GAME fixed effect against the JAX package's, on the
CPU.

Mirrors ``tests/test_streaming.py::TestStreamingGameCoordinate``: a
streamed fixed effect (L-BFGS, L1 through OWL-QN, TRON) inside a descent
with a per-user random effect matches the resident fixed effect and the
reference's streamed coordinate within the reference test's 5e-3, with
the same sparsity pattern under L1.  Inside the port the descent is
bitwise the same at depth 1 and 2 and with or without batched line-search
trials.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.data.streaming import (
    make_streaming_glm_data as ref_make_streaming,
)
from photon_ml_tpu.game import data as ref_data
from photon_ml_tpu.game.coordinates import (
    RandomEffectCoordinate as RefRandom,
)
from photon_ml_tpu.game.descent import CoordinateDescent as RefCD
from photon_ml_tpu.game.streaming import (
    StreamingFixedEffectCoordinate as RefStreamed,
)
from photon_ml_tpu.optim.problem import (
    GlmOptimizationConfig as RefConfig,
    OptimizerConfig as RefOpt,
    OptimizerType as RefOptType,
)
from photon_ml_tpu.optim.regularization import (
    RegularizationContext as RefReg,
)
from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
from photon_ml_tpu_torch.game.coordinates import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.data import (
    FixedEffectDataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game.descent import CoordinateDescent
from photon_ml_tpu_torch.game.streaming import StreamingFixedEffectCoordinate
from photon_ml_tpu_torch.optim.problem import (
    GlmOptimizationConfig,
    OptimizerConfig,
    OptimizerType,
)
from photon_ml_tpu_torch.optim.regularization import RegularizationContext
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = "cpu"
TOL = 5e-3  # tests/test_streaming.py's streamed-vs-resident tolerance


def _game_problem(seed=0, n=600, d=20, n_users=15):
    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=0.15, random_state=7, format="csr",
                  dtype=np.float32)
    users = np.array([f"u{rng.integers(n_users)}" for _ in range(n)],
                     dtype=object)
    user_eff = {f"u{u}": rng.normal() for u in range(n_users)}
    w_true = rng.normal(size=d).astype(np.float32)
    margin = X @ w_true + np.array([user_eff[u] for u in users])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    return X, users, y


#: (optimizer, regularization, reg_weight, max_iters, tolerance, chunk_rows)
CASES = {
    "lbfgs": ("lbfgs", "l2", 0.5, 50, 1e-8, 200),
    "l1": ("lbfgs", "l1", 2.0, 60, 1e-8, 180),
    "tron": ("tron", "l2", 0.5, 50, 1e-8, 180),
}


def _configs(case, compute_variances=False):
    opt, reg, _, iters, tol, _ = CASES[case]
    port = GlmOptimizationConfig(
        optimizer=OptimizerConfig(optimizer=OptimizerType(opt),
                                  max_iters=iters, tolerance=tol),
        regularization=getattr(RegularizationContext, reg)(),
        compute_variances=compute_variances)
    ref = RefConfig(
        optimizer=RefOpt(optimizer=RefOptType(opt), max_iters=iters,
                         tolerance=tol),
        regularization=getattr(RefReg, reg)(),
        compute_variances=compute_variances)
    re_iters = 50 if case == "lbfgs" else 30
    re_tol = 1e-8 if case == "lbfgs" else 1e-7
    re_port = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=re_iters, tolerance=re_tol),
        regularization=RegularizationContext.l2())
    re_ref = RefConfig(optimizer=RefOpt(max_iters=re_iters, tolerance=re_tol),
                       regularization=RefReg.l2())
    return port, ref, re_port, re_ref


def _port_cd(X, users, y, fixed, re_cfg):
    n = X.shape[0]
    bias = sp.csr_matrix(np.ones((n, 1), np.float32))
    re = RandomEffectCoordinate(
        "per_user", build_random_effect_dataset(
            users, bias, y, np.ones(n, np.float32), device=CPU),
        "logistic", re_cfg, reg_weight=1.0, entity_key="userId")
    return CoordinateDescent([fixed, re]).run(
        torch.zeros(n, dtype=torch.float32), n_iterations=2)


@pytest.mark.parametrize("case", ["lbfgs", "l1", "tron"])
def test_streamed_fixed_effect_in_a_descent(case):
    size = {"lbfgs": (600, 20), "l1": (500, 30), "tron": (500, 20)}[case]
    X, users, y = _game_problem(n=size[0], d=size[1])
    n = X.shape[0]
    cfg, rcfg, re_cfg, re_rcfg = _configs(case)
    rw, chunk = CASES[case][2], CASES[case][5]
    streamed = _port_cd(X, users, y, StreamingFixedEffectCoordinate(
        "fixed", make_streaming_glm_data(X, y, chunk_rows=chunk, device=CPU),
        "logistic", cfg, reg_weight=rw), re_cfg)
    resident = _port_cd(X, users, y, FixedEffectCoordinate(
        "fixed", FixedEffectDataset(
            data=make_glm_data(X, y, device=CPU), n_global_rows=n),
        "logistic", cfg, reg_weight=rw), re_cfg)
    bias = sp.csr_matrix(np.ones((n, 1), np.float32))
    ref = RefCD([
        RefStreamed("fixed", ref_make_streaming(X, y, chunk_rows=chunk,
                                                use_pallas=False),
                    "logistic", rcfg, reg_weight=rw),
        RefRandom("per_user", ref_data.build_random_effect_dataset(
            users, bias, y, np.ones(n, np.float32)), "logistic", re_rcfg,
            reg_weight=1.0, entity_key="userId"),
    ]).run(jnp.zeros(n, jnp.float32), n_iterations=2)

    w_s = streamed.states["fixed"].numpy()
    for other in (resident.states["fixed"].numpy(),
                  np.asarray(ref.states["fixed"])):
        np.testing.assert_allclose(w_s, other, atol=TOL, rtol=0)
    np.testing.assert_allclose(streamed.scores["fixed"].numpy(),
                               resident.scores["fixed"].numpy(), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(streamed.scores["fixed"].numpy(),
                               np.asarray(ref.scores["fixed"]), atol=TOL,
                               rtol=0)
    # The other coordinate trains against the streamed scores.
    for b_s, b_r in zip(streamed.states["per_user"],
                        resident.states["per_user"]):
        np.testing.assert_allclose(b_s.numpy(), b_r.numpy(), atol=TOL)
    if case == "l1":
        w_r = resident.states["fixed"].numpy()
        assert np.sum(w_r == 0.0) > 0  # the penalty pruned
        np.testing.assert_array_equal(w_s == 0.0, w_r == 0.0)


@pytest.mark.parametrize("variant", ["depth1", "no_batch", "fuse2"])
def test_descent_is_bitwise_across_pipeline_settings(variant):
    """Depth, chunk fusion and batched line-search trials change no bit of
    the descent (each batched trial runs the single evaluation's
    launches)."""
    X, users, y = _game_problem(seed=1, n=400, d=12)
    cfg, _, re_cfg, _ = _configs("lbfgs")
    stream = make_streaming_glm_data(X, y, chunk_rows=96, device=CPU)
    kw = {"depth1": {"prefetch_depth": 1},
          "no_batch": {"batch_linesearch": False},
          "fuse2": {"chunk_fuse": 2}}[variant]
    runs = [_port_cd(X, users, y, StreamingFixedEffectCoordinate(
        "fixed", stream, "logistic", cfg, reg_weight=0.5, **k), re_cfg)
        for k in ({}, kw)]
    np.testing.assert_array_equal(runs[0].states["fixed"].numpy(),
                                  runs[1].states["fixed"].numpy())
    np.testing.assert_array_equal(runs[0].scores["per_user"].numpy(),
                                  runs[1].scores["per_user"].numpy())


def test_finalize_variances_match_the_reference():
    X, _, y = _game_problem(n=300, d=10)
    cfg, rcfg, _, _ = _configs("lbfgs", compute_variances=True)
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, max_iters=40, tolerance=1e-7))
    rcfg = dataclasses.replace(rcfg, optimizer=dataclasses.replace(
        rcfg.optimizer, max_iters=40, tolerance=1e-7))
    port = StreamingFixedEffectCoordinate(
        "fixed", make_streaming_glm_data(X, y, chunk_rows=128, device=CPU),
        "logistic", cfg, reg_weight=1.0)
    ref = RefStreamed("fixed", ref_make_streaming(X, y, chunk_rows=128,
                                                  use_pallas=False),
                      "logistic", rcfg, reg_weight=1.0)
    off = np.random.default_rng(3).normal(size=X.shape[0]).astype(
        np.float32)
    m = port.finalize(port.train(torch.as_tensor(off)), offsets=off)
    rm = ref.finalize(ref.train(jnp.asarray(off)), offsets=off)
    assert m.model.task == "logistic"
    v = m.model.coefficients.variances.numpy()
    assert v.shape == (10,) and np.all(v > 0)
    np.testing.assert_allclose(v, np.asarray(rm.model.coefficients.variances),
                               rtol=1e-3)
    np.testing.assert_allclose(m.model.coefficients.means.numpy(),
                               np.asarray(rm.model.coefficients.means),
                               atol=TOL)


@pytest.mark.parametrize("case", ["nonzero_offsets", "mesh"])
def test_refusals(case):
    X, _, y = _game_problem(n=200, d=8)
    kw = {}
    if case == "nonzero_offsets":
        stream = make_streaming_glm_data(
            X, y, offsets=np.ones(X.shape[0], np.float32), chunk_rows=100,
            device=CPU)
        err, match = ValueError, "zero offsets"
    else:
        # A group streams a store built for it (one shard a rank): a
        # store without shards is refused, as the reference refuses
        # single-shard chunks with a mesh.
        stream = make_streaming_glm_data(X, y, chunk_rows=100, device=CPU)
        kw = {"mesh": object()}
        err, match = ValueError, "no shard axis"
    with pytest.raises(err, match=match):
        StreamingFixedEffectCoordinate("fixed", stream, "logistic",
                                       GlmOptimizationConfig(), **kw)
