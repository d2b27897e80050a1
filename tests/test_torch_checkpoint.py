"""The port's λ-grid checkpoint (``io/checkpoint.GridCheckpointer``) and the
driver's ``--resume``.

The file format is the reference's: a checkpoint written by either package
loads in the other, byte for byte.  A driver run interrupted after its first
λ and resumed gives coefficients bitwise equal to the uninterrupted run, and
a resume under other ``--coefficient-bounds`` is refused, as in the
reference (``tests/test_glm_driver.py::test_resume_refused_on_bounds_mismatch``).
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data import libsvm as jax_libsvm
from photon_ml_tpu.io import checkpoint as jax_checkpoint

from photon_ml_tpu_torch.drivers import glm_driver
from photon_ml_tpu_torch.io import checkpoint
from photon_ml_tpu_torch.io.model_store import load_glm_model
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

D = 123


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _solved(rng, n=3, d=17):
    return {lam: rng.normal(size=d).astype(np.float32)
            for lam in (10.0, 1.0, 0.1)[:n]}


def _assert_same(a, b):
    assert list(a) == list(b)  # λs in solve order
    for lam in a:
        assert np.asarray(a[lam]).dtype == np.asarray(b[lam]).dtype
        assert np.asarray(a[lam]).tobytes() == np.asarray(b[lam]).tobytes()


def test_round_trip_and_meta(tmp_path, rng):
    ck = checkpoint.GridCheckpointer(str(tmp_path / "ck"))
    assert not ck.exists() and ck.load() == {} and ck.load_meta() == {}
    solved = _solved(rng)
    ck.save(solved, extra_meta={"bounds_fingerprint": "abc"})
    assert ck.exists()
    _assert_same(ck.load(), solved)
    assert ck.load_meta() == {"lambdas": [10.0, 1.0, 0.1],
                              "bounds_fingerprint": "abc"}
    ck.clear()
    assert not ck.exists() and not os.path.exists(ck.path + ".1")


def test_corrupt_latest_falls_back_to_previous(tmp_path, rng):
    ck = checkpoint.GridCheckpointer(str(tmp_path / "ck"))
    first = _solved(rng, n=1)
    ck.save(first)
    ck.save(_solved(rng, n=2))
    assert os.path.exists(ck.path + ".1")
    with open(ck.path, "r+b") as f:  # a torn newest file
        f.truncate(os.path.getsize(ck.path) // 2)
    _assert_same(ck.load(), first)
    # Every retained generation corrupt: the newest one's error, naming it.
    with open(ck.path + ".1", "r+b") as f:
        f.truncate(10)
    with pytest.raises(checkpoint.CheckpointCorruptError) as err:
        ck.load()
    assert err.value.path == ck.path and "unreadable npz" in err.value.reason


def test_digest_mismatch_is_refused(tmp_path, rng):
    ck = checkpoint.GridCheckpointer(str(tmp_path / "ck"), keep_last=1)
    ck.save(_solved(rng))
    with np.load(ck.path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["w__1"] = arrays["w__1"] + np.float32(1.0)  # bit rot, digest kept
    with open(ck.path, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(checkpoint.CheckpointCorruptError,
                       match="checksum mismatch"):
        ck.load()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(tmp_path, rng, writer):
    solved = _solved(rng)
    meta = {"bounds_fingerprint": "f" * 64}
    ours = checkpoint.GridCheckpointer(str(tmp_path / "ck"))
    ref = jax_checkpoint.GridCheckpointer(str(tmp_path / "ck"))
    (ref if writer == "jax" else ours).save(solved, extra_meta=meta)
    reader = ours if writer == "jax" else ref
    _assert_same(reader.load(), solved)
    assert reader.load_meta() == {"lambdas": list(solved), **meta}


# -- the driver's --resume -----------------------------------------------------


@pytest.fixture(scope="module")
def libsvm_pair(tmp_path_factory):
    rng = np.random.default_rng(5)
    n = 500
    X = sp.random(n, D, density=0.11, random_state=6, format="csr")
    X.data[:] = 1.0
    w_true = rng.normal(size=D) * (rng.uniform(size=D) < 0.3)
    y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w_true - 0.5))),
                 1.0, -1.0)
    root = tmp_path_factory.mktemp("resume")
    train, val = str(root / "train.libsvm"), str(root / "val.libsvm")
    jax_libsvm.write_libsvm(train, X[:350], y[:350])
    jax_libsvm.write_libsvm(val, X[350:], y[350:])
    return train, val


def _argv(train, val, out, *extra):
    return ["--train-data", train, "--validate-data", val, "--output-dir", out,
            "--task", "logistic", "--reg-weights", "0.1,1.0,10.0",
            "--n-features", str(D), "--output-mode", "all",
            "--device", "cpu", *extra]


class _Killed(Exception):
    """Stands in for a kill between two grid points."""


def _models(out):
    return {lam: load_glm_model(os.path.join(out, f"model_lambda_{lam}.avro"),
                                device="cpu")[0].coefficients.means.numpy()
            for lam in ("0.1", "1", "10")}


@pytest.mark.parametrize("route", [("--reg-type", "l2"),
                                   ("--reg-type", "l1"),
                                   ("--reg-type", "l2", "--solver", "tron")],
                         ids=["lbfgs", "owlqn", "tron"])
def test_resumed_grid_is_bitwise_the_uninterrupted_one(libsvm_pair, tmp_path,
                                                       monkeypatch, route):
    train, val = libsvm_pair
    whole = glm_driver.run(_argv(train, val, str(tmp_path / "whole"), *route))

    out = str(tmp_path / "resumed")
    save = checkpoint.GridCheckpointer.save

    def save_then_die(self, solved, extra_meta=None):
        save(self, solved, extra_meta)
        raise _Killed  # the first λ is solved and persisted, nothing more

    monkeypatch.setattr(checkpoint.GridCheckpointer, "save", save_then_die)
    with pytest.raises(_Killed):
        glm_driver.run(_argv(train, val, out, *route))
    monkeypatch.setattr(checkpoint.GridCheckpointer, "save", save)
    assert list(checkpoint.GridCheckpointer(
        os.path.join(out, "checkpoints")).load()) == [10.0]

    resumed = glm_driver.run(_argv(train, val, out, *route, "--resume"))
    assert resumed["metrics"] == whole["metrics"]
    assert resumed["best_lambda"] == whole["best_lambda"]
    assert set(resumed["solver_wall_seconds"]) == {"1.0", "0.1"}
    ours, ref = _models(out), _models(str(tmp_path / "whole"))
    for lam in ours:
        assert ours[lam].tobytes() == ref[lam].tobytes(), lam
    with open(os.path.join(out, "photon.log")) as f:
        assert "lambda=10: restored from checkpoint" in f.read()


def test_resume_refused_on_bounds_mismatch(libsvm_pair, tmp_path):
    train, val = libsvm_pair
    bounds_file = str(tmp_path / "bounds.json")
    with open(bounds_file, "w") as f:
        json.dump({"f0": [-0.05, 0.05]}, f)
    out = str(tmp_path / "out")
    base = _argv(train, val, out, "--reg-type", "l2", "--max-iters", "5")
    glm_driver.run(base + ["--coefficient-bounds", bounds_file])
    # Same bounds: resume is allowed (and skips every solved λ).
    res = glm_driver.run(base + ["--coefficient-bounds", bounds_file,
                                 "--resume"])
    assert res["solver_wall_seconds"] == {}
    # Dropping the bounds on resume must refuse...
    with pytest.raises(SystemExit, match="coefficient-bounds"):
        glm_driver.run(base + ["--resume"])
    # ...as must resuming a bound-less checkpoint WITH bounds.
    glm_driver.run(base)  # fresh run, no bounds (clears the checkpoint)
    with pytest.raises(SystemExit, match="coefficient-bounds"):
        glm_driver.run(base + ["--coefficient-bounds", bounds_file,
                               "--resume"])


@pytest.mark.parametrize("w0", [None, "cpu"], ids=["no-w0", "cpu-w0"])
def test_grid_loop_restores_onto_the_problem_device(rng, w0):
    """Restored λs land on the requested device (here the CPU) in their own
    dtype, and the next λ warm-starts from that tensor."""
    from photon_ml_tpu_torch.optim.lbfgs import SolveResult
    from photon_ml_tpu_torch.optim.problem import GlmOptimizationProblem

    solved = _solved(rng, n=1)  # λ = 10 restored, λ = 1 solved
    received = []

    def solve_fn(lam, w_prev):
        received.append(w_prev)
        w = w_prev + 1.0
        return SolveResult(w, w.sum(), w, 0, True, torch.zeros(1),
                           torch.zeros(1))

    start = None if w0 is None else torch.zeros(17, device=w0)
    out = GlmOptimizationProblem("logistic").grid_loop(
        solve_fn, [1.0, 10.0], w0=start, solved=solved, device="cpu")
    assert [lam for lam, _, _ in out] == [10.0, 1.0]
    (w_prev,) = received
    assert isinstance(w_prev, torch.Tensor)
    assert w_prev.device.type == "cpu" and w_prev.dtype == torch.float32
    np.testing.assert_array_equal(w_prev.numpy(), solved[10.0])
    assert out[0][2] is None and out[1][2] is not None
