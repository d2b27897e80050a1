"""photon_ml_tpu_torch — the PyTorch/CUDA port of ``photon_ml_tpu``.

The JAX package ``photon_ml_tpu`` stays beside this one as the reference;
this package rebuilds its capabilities slice by slice for an NVIDIA H100.
It imports ``torch``, numpy and scipy — never ``jax`` and never
``photon_ml_tpu`` (the host modules it needs are kept as its own copies).

Layout mirrors the reference so each module's counterpart is easy to find:

- ``device``     — device and dtype policy (CUDA by default; ``"cpu"`` only
                   when the caller asks for it).
- ``ops``        — pointwise GLM losses, the COO sparse matrix, and the
                   kernel-backed CSR/CSC matrix whose four hot operations run
                   in the hand-written CUDA SpMV kernel (``csrc/spmv.cu``).
- ``data``       — GLM datasets, LIBSVM ingest, index maps, normalization,
                   summary statistics, down-sampling.
- ``optim``      — the GLM objective, the weak-Wolfe line search, L-BFGS,
                   OWL-QN (L1 / elastic-net), TRON (trust-region Newton) and
                   SPG (box constraints) — host loops over device tensors —
                   and the λ-grid problem.
- ``solvers``    — the solver registry: named solvers and the routing
                   (bounds → SPG, any L1 → OWL-QN, else the optimizer).
- ``models``     — GLM model classes.
- ``game``       — GAME, resident: entity bucketing (``data``), model
                   containers, the fixed-effect and batched random-effect
                   coordinates, coordinate descent and ``GameEstimator``.
- ``evaluation`` — validation metrics: host evaluators, ``device`` (the
                   same metrics on the scores' device, sort-based AUC) and
                   ``suite`` (``EvaluationSuite``).
- ``io``         — the Avro container codec, model and summary persistence,
                   the λ-grid checkpoint (numpy ``.npz``, the reference's
                   format).
- ``utils``      — logging, timing, convergence traces.
- ``drivers``    — ``glm_driver``: the legacy GLM pipeline end to end.
- ``convert``    — hands numpy parameters to this package (parity tests).

What is ported so far is listed in ROADMAP.md ("PyTorch/CUDA port").
"""

__version__ = "0.1.0"
