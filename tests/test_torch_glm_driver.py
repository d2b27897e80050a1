"""The port's GLM driver against the JAX package's, end to end.

Both drivers train the same a1a-shaped LIBSVM pair (400 train / 200
validation rows, 123 binary features, a 3-point λ grid — the shape of
``BENCH_SMALL``'s driver workload); the port runs with ``--device cpu``.
They must select the same λ with validation AUCs within 1e-4, and each
package must load the other's model Avro.  ``convert.py`` hands the JAX
package's parameters to the port.  The solves stop at a relative
tolerance of 1e-5, above the float32 noise floor where the two packages'
different summation orders decide the last iterations.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.data import libsvm as jax_libsvm
from photon_ml_tpu.data.normalization import (
    NormalizationContext as JaxNormalization,
)
from photon_ml_tpu.drivers import glm_driver as jax_driver
from photon_ml_tpu.io import avro as jax_avro
from photon_ml_tpu.io import model_store as jax_store
from photon_ml_tpu.ops.sparse import from_coo as jax_from_coo

from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.drivers import glm_driver
from photon_ml_tpu_torch.io import model_store
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN, N_VAL, D = 400, 200, 123


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def a1a_shaped(tmp_path_factory):
    rng = np.random.default_rng(2)
    X = sp.random(N_TRAIN + N_VAL, D, density=0.11, random_state=4,
                  format="csr")
    X.data[:] = 1.0
    w_true = rng.normal(size=D) * (rng.uniform(size=D) < 0.3)
    logits = X @ w_true - 0.5
    y = np.where(rng.uniform(size=N_TRAIN + N_VAL)
                 < 1 / (1 + np.exp(-logits)), 1.0, -1.0)
    root = tmp_path_factory.mktemp("a1a_shaped")
    train, val = str(root / "train.libsvm"), str(root / "val.libsvm")
    jax_libsvm.write_libsvm(train, X[:N_TRAIN], y[:N_TRAIN])
    jax_libsvm.write_libsvm(val, X[N_TRAIN:], y[N_TRAIN:])
    return train, val


def _argv(train, val, out, *extra):
    return [
        "--train-data", train, "--validate-data", val, "--output-dir", out,
        "--task", "logistic", "--reg-type", "l2",
        "--reg-weights", "0.1,1.0,10.0", "--n-features", str(D),
        "--tolerance", "1e-5", *extra,
    ]


@pytest.fixture(scope="module")
def both_runs(a1a_shaped, tmp_path_factory):
    train, val = a1a_shaped
    root = tmp_path_factory.mktemp("drivers")
    ours_dir, ref_dir = str(root / "torch"), str(root / "jax")
    ours = glm_driver.run(_argv(train, val, ours_dir, "--device", "cpu",
                                "--output-mode", "all"))
    ref = jax_driver.run(_argv(train, val, ref_dir, "--output-mode", "all"))
    return ours, ref, ours_dir, ref_dir


def test_same_selection_and_metrics(both_runs):
    ours, ref, _, _ = both_runs
    assert ours["best_lambda"] == ref["best_lambda"]
    assert ours["evaluator"] == ref["evaluator"] == "AreaUnderROCCurveEvaluator"
    assert ours["metrics"].keys() == ref["metrics"].keys()
    for lam, auc in ours["metrics"].items():
        assert abs(auc - ref["metrics"][lam]) <= 1e-4, lam
    assert ours["metrics"][str(ours["best_lambda"])] > 0.7
    assert (ours["n_rows"], ours["n_features"]) == (N_TRAIN, D + 1)


def test_artifacts_match(both_runs):
    ours, ref, ours_dir, ref_dir = both_runs
    with open(os.path.join(ours_dir, "training_result.json")) as f:
        ours_json = json.load(f)
    with open(os.path.join(ref_dir, "training_result.json")) as f:
        ref_json = json.load(f)
    assert set(ours_json) == set(ref_json)
    assert ours_json["best_lambda"] == ours["best_lambda"]
    with open(os.path.join(ours_dir, "feature_summary.json")) as f:
        s = json.load(f)
    with open(os.path.join(ref_dir, "feature_summary.json")) as f:
        rs = json.load(f)
    for key in ("mean", "variance", "min", "max"):
        np.testing.assert_allclose(s[key], rs[key], rtol=1e-5, atol=1e-6)
    assert s["nnz"] == rs["nnz"] and s["count"] == rs["count"]
    # The five stages' artifacts, the λ-grid checkpoint and the telemetry
    # outputs (events, trace, end-of-run metrics and the time series).
    stage_files = {"feature_summary.json", "feature_summary.avro",
                   "index_map.json", "training_result.json", "photon.log",
                   "checkpoints", "events.jsonl", "trace.json",
                   "metrics.json", "metrics_ts.jsonl"}
    for lam in ("0.1", "1", "10"):
        stage_files |= {f"model_lambda_{lam}.avro",
                        f"model_lambda_{lam}.avro.meta.json"}
    assert stage_files <= set(os.listdir(ref_dir))
    assert stage_files == set(os.listdir(ours_dir))


@pytest.mark.parametrize("lam", ["0.1", "1", "10"])
def test_models_load_across_packages(both_runs, lam):
    _, _, ours_dir, ref_dir = both_runs
    name = f"model_lambda_{lam}.avro"
    ours_model, ours_map = model_store.load_glm_model(
        os.path.join(ours_dir, name), device="cpu")
    ref_model, ref_map = jax_store.load_glm_model(os.path.join(ref_dir, name))
    # Each package reads the other's file.
    cross_ref, cross_ref_map = jax_store.load_glm_model(
        os.path.join(ours_dir, name))
    cross_ours, cross_ours_map = model_store.load_glm_model(
        os.path.join(ref_dir, name), device="cpu")
    assert list(cross_ref_map) == list(ours_map)
    assert list(cross_ours_map) == list(ref_map)
    np.testing.assert_array_equal(np.asarray(cross_ref.coefficients.means),
                                  ours_model.coefficients.means.numpy())
    np.testing.assert_array_equal(cross_ours.coefficients.means.numpy(),
                                  np.asarray(ref_model.coefficients.means))
    assert cross_ref.task == cross_ours.task == "logistic"
    # And the two trainings agree.
    ours_w = ours_model.coefficients.means.numpy()
    ref_w = np.asarray(ref_model.coefficients.means)
    assert np.abs(ours_w - ref_w).max() <= 1e-3 * np.abs(ref_w).max()


def test_variances_and_normalization_match_jax(a1a_shaped, tmp_path):
    train, val = a1a_shaped
    extra = ("--normalization", "standardization", "--compute-variances")
    ours = glm_driver.run(_argv(train, val, str(tmp_path / "t"), *extra,
                                "--device", "cpu"))
    ref = jax_driver.run(_argv(train, val, str(tmp_path / "j"), *extra))
    assert ours["best_lambda"] == ref["best_lambda"]
    name = f"model_lambda_{ours['best_lambda']:g}.avro"
    m, _ = model_store.load_glm_model(str(tmp_path / "t" / name),
                                      device="cpu")
    jm, _ = jax_store.load_glm_model(str(tmp_path / "j" / name))
    np.testing.assert_allclose(m.coefficients.variances.numpy(),
                               np.asarray(jm.coefficients.variances),
                               rtol=1e-3)
    w, jw = m.coefficients.means.numpy(), np.asarray(jm.coefficients.means)
    assert np.abs(w - jw).max() <= 1e-3 * np.abs(jw).max()


def test_module_entry_point(a1a_shaped, tmp_path):
    train, val = a1a_shaped
    out = str(tmp_path / "cli")
    proc = subprocess.run(
        [sys.executable, "-m", "photon_ml_tpu_torch.drivers.glm_driver",
         *_argv(train, val, out, "--device", "cpu", "--max-iters", "20")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(os.path.join(out, "training_result.json"))


def test_convert_round_trip(tmp_path, rng):
    means = rng.normal(size=D + 1).astype(np.float32)
    variances = rng.uniform(0.1, 1.0, size=D + 1).astype(np.float32)
    model = convert.glm_from_numpy(means, "LOGISTIC_REGRESSION", variances,
                                   device="cpu")
    assert model.task == "logistic"
    imap = IndexMap.build([f"f{j}" for j in range(D)], add_intercept=True)
    path = str(tmp_path / "m.avro")
    model_store.save_glm_model(model, imap, path)
    ref, _ = jax_store.load_glm_model(path)
    np.testing.assert_array_equal(np.asarray(ref.coefficients.means), means)
    np.testing.assert_array_equal(np.asarray(ref.coefficients.variances),
                                  variances)
    back, _ = model_store.load_glm_model(path, device="cpu")
    assert torch.equal(back.coefficients.means, model.coefficients.means)

    factors = rng.uniform(0.5, 2.0, size=D).astype(np.float32)
    shifts = rng.normal(size=D).astype(np.float32)
    norm = convert.normalization_from_numpy(factors, shifts, D - 1,
                                            device="cpu")
    jnorm = JaxNormalization(jnp.asarray(factors), jnp.asarray(shifts), D - 1)
    w = rng.normal(size=D).astype(np.float32)
    np.testing.assert_allclose(
        norm.model_to_original(torch.from_numpy(w)).numpy(),
        np.asarray(jnorm.model_to_original(jnp.asarray(w))), rtol=1e-6)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_convert_matrix_from_coo(rng, use_kernel):
    n, d, nnz = 300, 80, 2000
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, d, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    M = convert.matrix_from_coo(rows, cols, vals, n, d,
                                use_kernel=use_kernel, device="cpu")
    C = jax_from_coo(rows, cols, vals, n, d)
    w = rng.normal(size=d).astype(np.float32)
    np.testing.assert_allclose(M.matvec(torch.from_numpy(w)).numpy(),
                               np.asarray(C.matvec(jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)


def _both(train, val, tmp_path, *extra, reg_type="l2",
          weights="0.1,1.0,10.0", tolerance="1e-5"):
    """The port's and the reference's driver on the same files and flags.
    OWL-QN routes (any L1 component) stop at 1e-3: its Armijo backtrack has
    no curvature condition, so below that its last float32 steps are ulps
    of decrease that the two packages round apart — enough to swap one
    validation pair (1e-4 of AUC on 200 rows)."""
    argv = [
        "--train-data", train, "--validate-data", val, "--task", "logistic",
        "--reg-type", reg_type, "--reg-weights", weights,
        "--n-features", str(D), "--tolerance", tolerance, *extra,
    ]
    ours_dir, ref_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    ours = glm_driver.run(argv + ["--output-dir", ours_dir, "--device", "cpu"])
    ref = jax_driver.run(argv + ["--output-dir", ref_dir])
    assert ours["best_lambda"] == ref["best_lambda"]
    assert ours["metrics"].keys() == ref["metrics"].keys()
    for lam, auc in ours["metrics"].items():
        assert abs(auc - ref["metrics"][lam]) <= 1e-4, lam
    return ours, ref, ours_dir, ref_dir


def _saved_means(out, lam):
    """The coefficient records an Avro model file holds (zeros are not
    written), read with the reference's container reader."""
    _, recs = jax_avro.read_container(os.path.join(out, f"model_lambda_{lam}.avro"))
    return len(recs[0]["means"])


def test_owlqn_l1_output_mode_all_and_sparsity(a1a_shaped, tmp_path):
    train, val = a1a_shaped
    ours, _, ours_dir, ref_dir = _both(
        train, val, tmp_path, "--optimizer", "owlqn", "--output-mode", "all",
        reg_type="l1", weights="1.0,5.0", tolerance="1e-3")
    # Stronger L1 ⇒ a sparser model file, in both packages alike.
    sizes = {lam: _saved_means(ours_dir, lam) for lam in ("1", "5")}
    assert sizes["5"] < sizes["1"] < D + 1
    for lam in ("1", "5"):
        assert abs(sizes[lam] - _saved_means(ref_dir, lam)) <= 2
        m, _ = model_store.load_glm_model(
            os.path.join(ours_dir, f"model_lambda_{lam}.avro"), device="cpu")
        jm, _ = jax_store.load_glm_model(
            os.path.join(ref_dir, f"model_lambda_{lam}.avro"))
        w, jw = m.coefficients.means.numpy(), np.asarray(jm.coefficients.means)
        assert np.abs(w - jw).max() <= 1e-3 * np.abs(jw).max()
        assert w[-1] != 0.0  # the intercept carries no L1 penalty
    assert ours["metrics"][str(ours["best_lambda"])] > 0.7


@pytest.mark.parametrize("flags", [("--solver", "tron"),
                                   ("--optimizer", "tron"),
                                   ("--reg-type", "elastic_net",
                                    "--elastic-net-alpha", "0.3")],
                         ids=["solver-tron", "optimizer-tron", "elastic-net"])
def test_solver_routes_match_jax(a1a_shaped, tmp_path, flags):
    train, val = a1a_shaped
    tolerance = "1e-3" if "elastic_net" in flags else "1e-5"
    ours, _, ours_dir, ref_dir = _both(train, val, tmp_path, *flags,
                                       tolerance=tolerance)
    name = f"model_lambda_{ours['best_lambda']:g}.avro"
    m, _ = model_store.load_glm_model(os.path.join(ours_dir, name),
                                      device="cpu")
    jm, _ = jax_store.load_glm_model(os.path.join(ref_dir, name))
    w, jw = m.coefficients.means.numpy(), np.asarray(jm.coefficients.means)
    assert np.abs(w - jw).max() <= 1e-3 * np.abs(jw).max()


def _bounds_file(tmp_path, bounds_map, name="bounds.json"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(bounds_map, f)
    return path


def test_box_constrained_driver_end_to_end(a1a_shaped, tmp_path):
    """--coefficient-bounds clamps the named coefficients into their box,
    selects what the reference selects, and matches a scipy L-BFGS-B
    oracle's objective on the same data."""
    import scipy.optimize

    train, val = a1a_shaped
    cap = 0.05
    bounds_map = {f"f{j}": [-cap, cap] for j in range(10)}
    path = _bounds_file(tmp_path, bounds_map)
    _, _, ours_dir, ref_dir = _both(train, val, tmp_path,
                                    "--coefficient-bounds", path,
                                    weights="1.0")
    model, imap = model_store.load_glm_model(
        os.path.join(ours_dir, "model_lambda_1.avro"), device="cpu")
    jm, _ = jax_store.load_glm_model(os.path.join(ref_dir,
                                                  "model_lambda_1.avro"))
    w = model.coefficients.means.numpy()
    idx = [imap.get_index(k) for k in bounds_map]
    assert np.all(np.abs(w[idx]) <= cap)
    assert np.any(np.abs(w[idx]) == np.float32(cap))  # the box binds
    jw = np.asarray(jm.coefficients.means)
    assert np.abs(w - jw).max() <= 1e-3 * np.abs(jw).max()

    X, y = jax_libsvm.read_libsvm(train, n_features=D, add_intercept=True)
    Xd, y = X.toarray(), np.asarray(y, np.float64)
    lo, hi = np.full(D + 1, -np.inf), np.full(D + 1, np.inf)
    lo[idx], hi[idx] = -cap, cap

    def f(wv):
        m = Xd @ wv
        return (np.sum(np.logaddexp(0, m) - y * m) + 0.5 * wv @ wv,
                Xd.T @ (1 / (1 + np.exp(-m)) - y) + wv)

    oracle = scipy.optimize.minimize(
        f, np.zeros(D + 1), jac=True, method="L-BFGS-B",
        bounds=list(zip(lo, hi)),
        options={"maxiter": 1000, "ftol": 1e-14, "gtol": 1e-10})
    assert f(w.astype(np.float64))[0] <= oracle.fun * (1 + 1e-5) + 1e-6


@pytest.mark.parametrize("case", ["nan", "lo-above-hi", "unknown-key",
                                  "normalization", "variances"])
def test_coefficient_bounds_refusals(a1a_shaped, tmp_path, case):
    train, val = a1a_shaped
    bounds_map = {"nan": {"f0": [float("nan"), 1.0]},
                  "lo-above-hi": {"f1": [0.5, -0.5]},
                  "unknown-key": {"f0": [-1.0, 1.0], "no_such": [0.0, 1.0]},
                  }.get(case, {"f0": [-1.0, 1.0]})
    extra = {"normalization": ["--normalization", "standardization"],
             "variances": ["--compute-variances"]}.get(case, [])
    match = {"nan": "invalid bounds", "lo-above-hi": "invalid bounds",
             "unknown-key": "unknown features",
             "normalization": "normalization none",
             "variances": "compute-variances"}[case]
    with pytest.raises(SystemExit, match=match):
        glm_driver.run(_argv(train, val, str(tmp_path / "out"),
                             "--coefficient-bounds",
                             _bounds_file(tmp_path, bounds_map), *extra,
                             "--device", "cpu"))


@pytest.mark.parametrize("flags,error", [
    (("--solver", "admm", "--compute-variances"),
     "does not support --compute-variances"),
    (("--solver", "levenberg"), "unknown solver")],
    ids=["admm-variances", "levenberg"])
def test_driver_refuses_unported_and_unknown_solvers(a1a_shaped, tmp_path,
                                                     flags, error):
    """An unknown solver, and the reference's refusals of a host-kind
    solver's combinations (variances, bounds, streaming)."""
    train, val = a1a_shaped
    with pytest.raises(SystemExit, match=error):
        glm_driver.run(_argv(train, val, str(tmp_path / "out"), *flags,
                             "--device", "cpu"))


def test_host_kind_solver_routes_match_jax(a1a_shaped, tmp_path):
    """``--solver admm`` with ``--solver-option`` and ``--solver-shards``:
    the port's logical shards against the reference's, the same λ
    selected, AUCs within two validation pairs (the two packages' ADMM
    take their adaptive-ρ decisions at the float32 noise floor apart, so
    their stopping rounds differ), coefficients within 1e-3 of the
    largest."""
    train, val = a1a_shaped
    flags = ("--solver", "admm", "--solver-shards", "4",
             "--solver-option", "reltol=1e-6", "--solver-option", "rho=0.5")
    ours_dir, ref_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    ours = glm_driver.run(_argv(train, val, ours_dir, *flags, "--device",
                                "cpu"))
    ref = jax_driver.run(_argv(train, val, ref_dir, *flags))
    assert ours["best_lambda"] == ref["best_lambda"]
    for lam, auc in ours["metrics"].items():
        assert abs(auc - ref["metrics"][lam]) <= AUC_PAIRS_TOL, lam
    name = f"model_lambda_{ours['best_lambda']:g}.avro"
    m, _ = model_store.load_glm_model(os.path.join(ours_dir, name),
                                      device="cpu")
    jm, _ = jax_store.load_glm_model(os.path.join(ref_dir, name))
    w, jw = m.coefficients.means.numpy(), np.asarray(jm.coefficients.means)
    assert np.abs(w - jw).max() <= 1e-3 * np.abs(jw).max()


def test_block_cd_driver_route_matches_jax(a1a_shaped, tmp_path):
    """``--solver block_cd``: the driver densifies the design and solves
    over ``--solver-shards`` logical shards; its model equals the
    reference's block CD on the same densified design: their float64
    objectives within 1e-5 relative (the reference's block-CD bar).  (The reference's driver cannot run this route:
    its tracker indexes block CD's one-shorter ``grad_norms`` with the
    values' mask and raises IndexError.)"""
    from photon_ml_tpu.optim import problem as jp
    from photon_ml_tpu.optim.regularization import (
        RegularizationContext as JReg,
    )
    from photon_ml_tpu.parallel.distributed import shard_glm_data
    from photon_ml_tpu.solvers import sharded as jax_sharded

    train, val = a1a_shaped
    out = str(tmp_path / "torch")
    opts = (("n_blocks", "4"), ("tolerance", "1e-9"))
    ours = glm_driver.run(_argv(
        train, val, out, "--solver", "block_cd", "--solver-shards", "2",
        *(f for k, v in opts for f in ("--solver-option", f"{k}={v}")),
        "--reg-weights", "10", "--max-iters", "200", "--device", "cpu"))
    X, y = jax_libsvm.read_libsvm(train, n_features=D, add_intercept=True)
    problem = jp.GlmOptimizationProblem("logistic", jp.GlmOptimizationConfig(
        optimizer=jp.OptimizerConfig(
            max_iters=200, tolerance=1e-5, solver="block_cd",
            solver_options=opts + (("shards", "2"),)),
        regularization=JReg.l2()))
    mask = np.ones(D + 1, np.float32)
    mask[-1] = 0.0
    [(_, jm, _)] = jax_sharded.run_grid_sharded(
        problem, shard_glm_data(np.asarray(X.todense(), np.float32), y,
                                None, n_shards=2),
        None, [10.0], l1_mask=jnp.asarray(mask))
    m, _ = model_store.load_glm_model(
        os.path.join(out, "model_lambda_10.avro"), device="cpu")
    Xd, yd = np.asarray(X.todense(), np.float64), np.asarray(y, np.float64)

    def objective(w):
        m = Xd @ np.asarray(w, np.float64)
        return (np.sum(np.logaddexp(0.0, m) - yd * m)
                + 0.5 * 10.0 * np.dot(w, w))

    f, f_ref = objective(m.coefficients.means.numpy()), objective(
        np.asarray(jm.coefficients.means))
    assert abs(f - f_ref) / max(1.0, abs(f_ref)) <= 1e-5
    assert ours["metrics"]["10.0"] > 0.7


def test_data_parallel_on_one_process_trains_as_without(a1a_shaped,
                                                        tmp_path):
    """``--data-parallel auto`` forms no group on one process: the model
    files are byte-equal to the run without it, as the reference (which
    forms a mesh only over more than one device) trains the same model."""
    train, val = a1a_shaped
    outs = [str(tmp_path / "off"), str(tmp_path / "auto")]
    glm_driver.run(_argv(train, val, outs[0], "--device", "cpu"))
    glm_driver.run(_argv(train, val, outs[1], "--data-parallel", "auto",
                         "--device", "cpu"))
    assert _model_bytes(outs[0]) == _model_bytes(outs[1])


def _solves(out):
    """Per-λ (final objective, iterations) from the driver's log."""
    import re

    with open(os.path.join(out, "photon.log")) as f:
        return {float(m.group(1)): (float(m.group(2)), int(m.group(3)))
                for m in re.finditer(
                    r"lambda=([0-9.e+-]+): value=(\S+) iters=(\d+)",
                    f.read())}


def _model_bytes(out):
    return {name: open(os.path.join(out, name), "rb").read()
            for name in sorted(os.listdir(out))
            if name.startswith("model_lambda_")}


STREAM = ("--stream-chunk-rows", "128")
#: Solves that stop at the float32 noise floor in another summation order
#: (streamed chunks, a warm start) may swap a validation pair or two: two
#: of the validation file's 9,900 positive-negative pairs.
AUC_PAIRS_TOL = 2.1e-4


@pytest.mark.parametrize("flags", [
    (), ("--reg-type", "l1", "--optimizer", "owlqn"),
    ("--solver", "tron"),
], ids=["l2", "l1", "tron"])
def test_streamed_driver_matches_resident_and_reference(a1a_shaped,
                                                        tmp_path, flags):
    """The streamed route (4 chunks of 128 rows from a disk store, host
    validation scoring) selects what the port's resident run and the
    reference's streamed run select, with coefficients within 1e-3 of
    max|w| (the OWL-QN route stops at 1e-3,
    see ``_both``), AUCs within :data:`AUC_PAIRS_TOL`.  The value sums in
    float64 (``--precise-accumulation``): the port's streamed route runs
    the resident solvers, whose decisions are the reference's resident
    float32 arithmetic, while the reference's streamed solvers decide in
    host floats, so with float32 values the two streamed runs part where a
    solve stops on a one-ulp decrease."""
    train, val = a1a_shaped
    argv = [
        "--train-data", train, "--validate-data", val, "--task", "logistic",
        "--reg-type", "l2", "--reg-weights", "0.1,1.0,10.0",
        "--n-features", str(D), *flags,
        "--tolerance", "1e-3" if "l1" in flags else "1e-5",
        "--precise-accumulation",
    ]
    store = str(tmp_path / "store")
    runs = {
        "streamed": glm_driver.run(argv + [
            "--output-dir", str(tmp_path / "s"), *STREAM,
            "--stream-storage-dir", store, "--device", "cpu"]),
        "resident": glm_driver.run(argv + [
            "--output-dir", str(tmp_path / "r"), "--device", "cpu"]),
        "reference": jax_driver.run(argv + [
            "--output-dir", str(tmp_path / "j"), *STREAM]),
    }
    ours = runs["streamed"]
    assert ours["streaming"]["chunks"] == 4 and ours["streaming"]["disk"]
    assert ours["streaming"]["layout"] == "coo"
    assert ours["streaming"]["transfer"]["chunks"] > 0
    for other in ("resident", "reference"):
        assert runs[other]["best_lambda"] == ours["best_lambda"]
        for lam, auc in ours["metrics"].items():
            assert abs(auc - runs[other]["metrics"][lam]) <= \
                AUC_PAIRS_TOL, (other, lam)
    name = f"model_lambda_{ours['best_lambda']:g}.avro"
    w = model_store.load_glm_model(str(tmp_path / "s" / name),
                                   device="cpu")[0].coefficients.means
    for sub, loader in (("r", lambda p: model_store.load_glm_model(
            p, device="cpu")[0].coefficients.means.numpy()),
                        ("j", lambda p: np.asarray(jax_store.load_glm_model(
                            p)[0].coefficients.means))):
        other = loader(str(tmp_path / sub / name))
        assert np.abs(w.numpy() - other).max() <= 1e-3 * np.abs(other).max()


def test_streamed_driver_kill_and_resume_bitwise(a1a_shaped, tmp_path,
                                                 monkeypatch):
    """A streamed grid killed after its first λ resumes with ``--resume``
    to model files byte-equal to the uninterrupted streamed run's."""
    from photon_ml_tpu_torch.optim import streaming as port_streaming

    train, val = a1a_shaped
    full, res = str(tmp_path / "full"), str(tmp_path / "resumed")
    glm_driver.run(_argv(train, val, full, *STREAM, "--device", "cpu",
                         "--output-mode", "all"))
    orig = port_streaming.streaming_run_grid

    def killed(*a, on_solved=None, **kw):
        def die(lam, w):
            on_solved(lam, w)
            raise KeyboardInterrupt("killed after the first λ")

        return orig(*a, on_solved=die, **kw)

    monkeypatch.setattr(port_streaming, "streaming_run_grid", killed)
    with pytest.raises(KeyboardInterrupt):
        glm_driver.run(_argv(train, val, res, *STREAM, "--device", "cpu",
                             "--output-mode", "all"))
    monkeypatch.undo()
    result = glm_driver.run(_argv(train, val, res, *STREAM, "--device",
                                  "cpu", "--output-mode", "all", "--resume"))
    assert "resuming: 1 of 3" in open(os.path.join(res, "photon.log")).read()
    assert _model_bytes(res) == _model_bytes(full)
    assert result["metrics"] == json.load(open(os.path.join(
        full, "training_result.json")))["metrics"]


@pytest.mark.parametrize("stream", [False, True], ids=["resident",
                                                       "streamed"])
def test_mid_grid_transient_crash_resumes(a1a_shaped, tmp_path, monkeypatch,
                                          stream):
    """A transport-style failure after the first λ checkpointed: with
    ``--max-retries`` the driver re-enters training from the checkpoint
    without re-solving that λ, and its models are byte-equal to an
    uninterrupted run's; the reference's driver recovers the same way."""
    from photon_ml_tpu.optim.problem import (
        GlmOptimizationProblem as RefProblem,
    )
    from photon_ml_tpu_torch.optim import streaming as port_streaming
    from photon_ml_tpu_torch.optim.problem import GlmOptimizationProblem

    train, val = a1a_shaped
    extra = (*STREAM,) if stream else ()
    ok = str(tmp_path / "ok")
    glm_driver.run(_argv(train, val, ok, *extra, "--device", "cpu"))

    def flaky(orig, state):
        def run(*a, **kw):
            state["attempts"] += 1
            if state["attempts"] == 1:
                inner = kw["on_solved"]

                def dying(lam, w):
                    inner(lam, w)  # persist the checkpoint first
                    state["solved_before_crash"].append(lam)
                    raise RuntimeError(
                        "UNAVAILABLE: injected transport drop")

                kw["on_solved"] = dying
            return orig(*a, **kw)
        return run

    state = {"attempts": 0, "solved_before_crash": []}
    if stream:
        monkeypatch.setattr(port_streaming, "streaming_run_grid",
                            flaky(port_streaming.streaming_run_grid, state))
    else:
        monkeypatch.setattr(GlmOptimizationProblem, "run_grid",
                            flaky(GlmOptimizationProblem.run_grid, state))
    out = str(tmp_path / "recovered")
    result = glm_driver.run(_argv(train, val, out, *extra, "--device", "cpu",
                                  "--max-retries", "1",
                                  "--retry-backoff", "0"))
    monkeypatch.undo()
    assert state == {"attempts": 2, "solved_before_crash": [10.0]}
    assert result["retry"]["retries"] == 1
    assert result["retry"]["failures"][0]["matched"] == "UNAVAILABLE"
    assert _model_bytes(out) == _model_bytes(ok)
    assert "restored from checkpoint" in open(
        os.path.join(out, "photon.log")).read()
    if not stream:
        # The reference's driver, crashed the same way, recovers to the
        # same selection.
        rstate = {"attempts": 0, "solved_before_crash": []}
        monkeypatch.setattr(RefProblem, "run_grid",
                            flaky(RefProblem.run_grid, rstate))
        ref = jax_driver.run(_argv(train, val, str(tmp_path / "ref"),
                                   "--max-retries", "1",
                                   "--retry-backoff", "0"))
        assert rstate == state
        assert ref["best_lambda"] == result["best_lambda"]
        assert ref["retry"]["retries"] == result["retry"]["retries"]


def test_non_transient_failure_is_not_retried(a1a_shaped, tmp_path,
                                              monkeypatch):
    from photon_ml_tpu_torch.optim.problem import GlmOptimizationProblem

    train, val = a1a_shaped
    calls = []

    def broken(self, *a, **k):
        calls.append(1)
        raise ValueError("genuinely broken config")

    monkeypatch.setattr(GlmOptimizationProblem, "run_grid", broken)
    with pytest.raises(ValueError, match="genuinely broken"):
        glm_driver.run(_argv(train, val, str(tmp_path / "o"), "--device",
                             "cpu", "--max-retries", "5",
                             "--retry-backoff", "0"))
    assert calls == [1]


@pytest.mark.parametrize("stream", [False, True], ids=["resident",
                                                       "streamed"])
def test_initial_model_warm_starts_the_grid(a1a_shaped, tmp_path, stream):
    """``--initial-model`` seeds the first λ from a saved model (in the
    original feature space, mapped into the solver's standardized space):
    fewer iterations than cold, the same optimum (objective rtol 1e-6,
    coefficients within 1e-3 of max|w|: both solves stop at the float32
    noise floor), and the reference's warm-started run's metrics within
    :data:`AUC_PAIRS_TOL`."""
    train, val = a1a_shaped
    extra = (*STREAM,) if stream else ()
    flags = ("--output-mode", "all", "--normalization", "standardization")
    cold = str(tmp_path / "cold")
    res_cold = glm_driver.run(_argv(train, val, cold, *extra, *flags,
                                    "--device", "cpu"))
    init = ("--initial-model", os.path.join(cold, "model_lambda_10.avro"))
    warm = str(tmp_path / "warm")
    res = glm_driver.run(_argv(train, val, warm, *extra, *flags, *init,
                               "--device", "cpu"))
    ref = jax_driver.run(_argv(train, val, str(tmp_path / "ref"), *extra,
                               *flags, *init))
    (f_warm, it_warm), (f_cold, it_cold) = (_solves(out)[10.0]
                                            for out in (warm, cold))
    assert it_warm < it_cold
    assert f_warm == pytest.approx(f_cold, rel=1e-6)
    for lam, auc in res["metrics"].items():
        assert abs(auc - ref["metrics"][lam]) <= AUC_PAIRS_TOL
        assert abs(auc - res_cold["metrics"][lam]) <= AUC_PAIRS_TOL
    w_w, w_c = (model_store.load_glm_model(os.path.join(
        out, "model_lambda_10.avro"), device="cpu")[0].coefficients.means
        for out in (warm, cold))
    assert (w_w - w_c).abs().max() <= 1e-3 * w_c.abs().max()


def test_streamed_training_report_carries_every_lambda(a1a_shaped,
                                                       tmp_path):
    train, val = a1a_shaped
    out = str(tmp_path / "out")
    result = glm_driver.run(_argv(train, val, out, *STREAM, "--device",
                                  "cpu", "--training-report"))
    rep = json.load(open(os.path.join(out, "report.json")))
    for kind in ("convergence", "metric", "calibration",
                 "feature_importance"):
        assert sorted(s["lambda"] for s in rep["sections"]
                      if s["kind"] == kind) == [0.1, 1.0, 10.0]
    assert os.path.exists(os.path.join(out, "report.html"))
    assert result["report"]["html"].endswith("report.html")


@pytest.mark.parametrize("case,error", [
    ("storage-without-chunks", "requires --stream-chunk-rows"),
    ("bounds", "single-device resident-data only"),
    pytest.param("data-parallel", "single-device",
                 id="data-parallel-Queue 1 item 6"),
    ("prefetch-depth", "--stream-prefetch-depth must be >= 1"),
])
def test_stream_flag_guards(a1a_shaped, tmp_path, case, error):
    train, val = a1a_shaped
    flags = {
        "storage-without-chunks": ("--stream-storage-dir",
                                   str(tmp_path / "s")),
        "bounds": (*STREAM, "--coefficient-bounds",
                   _bounds_file(tmp_path, {"f0": [-1, 1]})),
        "data-parallel": ("--data-parallel", "auto",
                          "--stream-chunk-fuse", "2"),
        "prefetch-depth": (*STREAM, "--stream-prefetch-depth", "0"),
    }[case]
    exc = {"bounds": SystemExit}.get(case, ValueError)
    with pytest.raises(exc, match=error):
        if case == "data-parallel":
            # Streaming over a process group of more than one rank runs
            # (tests/test_torch_streaming_mesh.py), but a fused group is
            # refused there, as the reference refuses it; on one process
            # the flag forms no group.
            glm_driver._check_stream_flags(
                glm_driver.build_arg_parser().parse_args(_argv(
                    train, val, str(tmp_path / "out"), *STREAM, *flags)),
                data_parallel=True)
        else:
            glm_driver.run(_argv(train, val, str(tmp_path / "out"), *flags,
                                 "--device", "cpu"))
