"""GAME (generalized additive mixed effects): the resident core.

``data`` (entity bucketing), ``model`` (model containers), ``coordinates``
(fixed-effect and batched random-effect coordinates), ``descent``
(coordinate descent) and ``estimator`` (``GameEstimator``).
"""
