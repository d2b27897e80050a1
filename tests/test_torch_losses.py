"""The port's pointwise losses against the JAX package (rtol 1e-6),
including margins of ±1e4 where an unstable softplus or sigmoid would
overflow."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops import losses as jax_losses

from photon_ml_tpu_torch.ops import losses
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

NAMES = ("logistic", "squared", "poisson", "smoothed_hinge")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(name, rng):
    m = np.concatenate([
        rng.normal(scale=3.0, size=200),
        [-1e4, -50.0, -1.0, -1e-3, 0.0, 1e-3, 0.5, 1.0, 50.0, 1e4],
    ]).astype(np.float32)
    if name == "poisson":
        m = np.clip(m, -30.0, 30.0)  # exp(1e4) is inf in both packages
        y = rng.poisson(3.0, size=m.size).astype(np.float32)
    elif name == "squared":
        y = rng.normal(size=m.size).astype(np.float32)
    else:
        y = (rng.uniform(size=m.size) < 0.5).astype(np.float32)
    return m, y


@pytest.mark.parametrize("fn", ["value", "d1", "d2"])
@pytest.mark.parametrize("name", NAMES)
def test_matches_jax(rng, name, fn):
    m, y = _inputs(name, rng)
    ours = getattr(losses.get(name), fn)(torch.from_numpy(m),
                                         torch.from_numpy(y)).numpy()
    ref = np.asarray(getattr(jax_losses.get(name), fn)(jnp.asarray(m),
                                                       jnp.asarray(y)))
    assert np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("name", NAMES)
def test_mean_fn_matches_jax(rng, name):
    m, _ = _inputs(name, rng)
    ours = losses.get(name).mean_fn(torch.from_numpy(m)).numpy()
    ref = np.asarray(jax_losses.get(name).mean_fn(jnp.asarray(m)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-30)


def test_aliases_and_unknown():
    assert losses.get("LOGISTIC_REGRESSION") is losses.logistic
    assert losses.get("linear").name == "squared"
    assert losses.get("hinge").name == "smoothed_hinge"
    for alias in ("logistic_regression", "poisson_regression",
                  "smoothed_hinge_loss_linear_svm"):
        assert losses.get(alias).name == jax_losses.get(alias).name
    with pytest.raises(KeyError, match="unknown loss"):
        losses.get("bogus")


def test_value_d1_pair(rng):
    m, y = _inputs("logistic", rng)
    v, g = losses.logistic.value_d1(torch.from_numpy(m), torch.from_numpy(y))
    assert torch.equal(v, losses.logistic.value(torch.from_numpy(m),
                                                torch.from_numpy(y)))
    assert torch.equal(g, losses.logistic.d1(torch.from_numpy(m),
                                             torch.from_numpy(y)))
