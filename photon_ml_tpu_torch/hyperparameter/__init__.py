"""Random and Gaussian-process hyperparameter search (port of
``photon_ml_tpu/hyperparameter``)."""

from photon_ml_tpu_torch.hyperparameter.search import (  # noqa: F401
    GaussianProcessSearch,
    RandomSearch,
)
