"""The port's GLM objective against the JAX ``GlmObjective``.

The same numpy problem goes through both packages: the JAX side on its
Pallas tile kernel in interpret mode (``make_glm_data(..., use_pallas=True)``),
the port on the kernel-backed matrix's plain CPU path and on its COO
matrix.  Value, gradient, Hessian-vector product and ``d2_weights`` are
compared with and without normalization and in f32 and f64 value
accumulation, and the feature summaries that feed normalization.
Tolerances: the value at rtol 1e-5 (f32 reductions in two summation
orders; 1e-6 under f64 accumulation), vectors at 1e-5 of their largest
component.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

os.environ.setdefault("PHOTON_PALLAS_INTERPRET", "1")

from photon_ml_tpu.data import stats as jax_stats
from photon_ml_tpu.data.dataset import make_glm_data as jax_make_glm_data
from photon_ml_tpu.data.normalization import (
    NormalizationContext as JaxNormalization,
)
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.optim.objective import GlmObjective as JaxObjective

from photon_ml_tpu_torch.convert import normalization_from_numpy
from photon_ml_tpu_torch.data import stats
from photon_ml_tpu_torch.data.dataset import make_glm_data
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.ops.sparse import from_coo
from photon_ml_tpu_torch.optim.objective import GlmObjective
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

LOSSES = ("logistic", "squared", "poisson", "smoothed_hinge")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problem(rng, loss, n=1500, d=120, density=0.05):
    X = sp.random(n, d - 1, density=density,
                  random_state=np.random.RandomState(7), format="csr",
                  dtype=np.float32)
    X.data = rng.normal(size=X.nnz).astype(np.float32)
    X = sp.hstack([X, np.ones((n, 1), np.float32)], format="csr")  # intercept
    if loss == "poisson":
        y = rng.poisson(1.5, n).astype(np.float32)
    elif loss == "squared":
        y = rng.normal(size=n).astype(np.float32)
    else:
        y = rng.integers(0, 2, n).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, n).astype(np.float32)
    offsets = (0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y, weights, offsets


def _normalization(rng, d, on):
    if not on:
        return None, None
    factors = rng.uniform(0.5, 2.0, d).astype(np.float32)
    shifts = (0.1 * rng.normal(size=d)).astype(np.float32)
    factors[-1], shifts[-1] = 1.0, 0.0  # the intercept column
    return (
        normalization_from_numpy(factors, shifts, d - 1, device="cpu"),
        JaxNormalization(jnp.asarray(factors), jnp.asarray(shifts), d - 1),
    )


def _close_vec(ours, ref, tol=1e-5):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(ours - ref).max() <= tol * scale


@pytest.mark.parametrize("accumulate", ["f32", "f64"])
@pytest.mark.parametrize("normalized", [False, True], ids=["raw", "norm"])
@pytest.mark.parametrize("loss", LOSSES)
def test_matches_jax_objective(rng, loss, normalized, accumulate):
    X, y, wts, offs = _problem(rng, loss)
    d = X.shape[1]
    norm_t, norm_j = _normalization(rng, d, normalized)
    w = (0.2 * rng.normal(size=d)).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    l2 = 0.7

    jdata = jax_make_glm_data(X, y, wts, offs, use_pallas=True)
    jobj = JaxObjective(jax_losses.get(loss), norm_j, accumulate=accumulate)
    jval, jgrad = jobj.value_and_grad(jnp.asarray(w), jdata, l2)
    jhvp = jobj.hvp(jnp.asarray(w), jnp.asarray(v), jdata, l2)
    jd2 = jobj.d2_weights(jnp.asarray(w), jdata)

    rtol = 1e-6 if accumulate == "f64" else 1e-5
    for use_kernel in (True, False):
        data = make_glm_data(X, y, wts, offs, use_kernel=use_kernel,
                             device="cpu")
        obj = GlmObjective(losses.get(loss), norm_t, accumulate=accumulate)
        tw, tv = torch.from_numpy(w), torch.from_numpy(v)
        val, grad = obj.value_and_grad(tw, data, l2)
        assert val.dtype == (torch.float64 if accumulate == "f64"
                             else torch.float32)
        np.testing.assert_allclose(float(val), float(jval), rtol=rtol)
        _close_vec(grad.numpy(), jgrad)
        _close_vec(obj.hvp(tw, tv, data, l2).numpy(), jhvp)
        _close_vec(obj.d2_weights(tw, data).numpy(), jd2)
        np.testing.assert_allclose(
            float(obj.value(tw, data, l2)), float(val), rtol=1e-6)


def test_hvp_with_cached_d2_weights(rng):
    X, y, wts, offs = _problem(rng, "logistic")
    data = make_glm_data(X, y, wts, offs, use_kernel=True, device="cpu")
    obj = GlmObjective(losses.logistic)
    w = torch.from_numpy((0.2 * rng.normal(size=X.shape[1])).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=X.shape[1]).astype(np.float32))
    d2w = obj.d2_weights(w, data)
    assert torch.equal(obj.hvp(w, v, data, 0.3, d2w=d2w),
                       obj.hvp(w, v, data, 0.3))


@pytest.mark.parametrize("normalized", [False, True], ids=["raw", "norm"])
@pytest.mark.parametrize("loss", ["logistic", "squared", "poisson"])
def test_gradient_and_hvp_finite_differences(rng, loss, normalized):
    """Central differences in float64 on the COO matrix: the analytic
    gradient and HVP are the derivatives of the value."""
    X, y, wts, offs = _problem(rng, loss, n=300, d=20, density=0.2)
    d = X.shape[1]
    coo = X.tocoo()
    feats = from_coo(coo.row, coo.col, coo.data, *X.shape,
                     dtype=torch.float64, device="cpu")
    data = make_glm_data(X, y, wts, offs, use_kernel=False, device="cpu")
    data.features = feats
    data.labels, data.weights, data.offsets = (
        t.double() for t in (data.labels, data.weights, data.offsets))
    norm = None
    if normalized:
        norm, _ = _normalization(rng, d, True)
        norm.factors, norm.shifts = norm.factors.double(), norm.shifts.double()
    obj = GlmObjective(losses.get(loss), norm)
    w = torch.from_numpy(0.2 * rng.normal(size=d))
    v = torch.from_numpy(rng.normal(size=d))
    l2, eps = 0.4, 1e-6
    _, grad = obj.value_and_grad(w, data, l2)
    fd = torch.stack([
        (obj.value(w + eps * e, data, l2) - obj.value(w - eps * e, data, l2))
        / (2 * eps)
        for e in torch.eye(d, dtype=torch.float64)
    ])
    np.testing.assert_allclose(grad.numpy(), fd.numpy(), rtol=1e-5, atol=1e-6)
    g_plus = obj.value_and_grad(w + eps * v, data, l2)[1]
    g_minus = obj.value_and_grad(w - eps * v, data, l2)[1]
    np.testing.assert_allclose(obj.hvp(w, v, data, l2).numpy(),
                               ((g_plus - g_minus) / (2 * eps)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_bad_accumulate_refused():
    with pytest.raises(ValueError, match="f32|f64"):
        GlmObjective(losses.logistic, accumulate="f16")


SUMMARY_FIELDS = ("mean", "variance", "min", "max", "nnz", "count")


@pytest.mark.parametrize("layout", ["kernel", "coo", "dense"])
def test_summary_matches_jax(rng, layout):
    """Weighted moments (rmatvec / sq_rmatvec), live-row nnz and ranges,
    with zero-weight padding rows that must not count."""
    X, y, wts, offs = _problem(rng, "logistic", n=700, d=60, density=0.1)
    X.data[:25] = 0.0  # explicit zeros are absent entries
    feats = X.toarray() if layout == "dense" else X
    data = make_glm_data(feats, y, wts, offs, pad_rows=720,
                         use_kernel=layout == "kernel", device="cpu")
    jdata = jax_make_glm_data(feats, y, wts, offs, pad_rows=720)
    ours, ref = stats.summarize(data), jax_stats.summarize(jdata)
    for f in SUMMARY_FIELDS:
        np.testing.assert_allclose(
            np.asarray(getattr(ours, f), np.float64),
            np.asarray(getattr(ref, f), np.float64), rtol=1e-5, atol=1e-6,
            err_msg=f)


@pytest.mark.parametrize("sparse", [True, False], ids=["csr", "dense"])
def test_summarize_host_matches_jax(rng, sparse):
    X, _, wts, _ = _problem(rng, "squared", n=400, d=40, density=0.1)
    wts[:30] = 0.0
    feats = X if sparse else X.toarray()
    ours = stats.summarize_host(feats, wts)
    ref = jax_stats.summarize_host(feats, wts)
    for f in SUMMARY_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(ours, f)),
                                   np.asarray(getattr(ref, f)), rtol=1e-12,
                                   err_msg=f)
