"""Solver subsystem: the config-keyed registry (port of
``photon_ml_tpu/solvers/``).

Every resident solver — L-BFGS, OWL-QN, TRON, SPG — registers a
:class:`~photon_ml_tpu_torch.solvers.registry.SolverDef` and is selected by
``OptimizerConfig.solver``; unset ``solver`` keeps the historical routing
(bounds → SPG, any L1 component → OWL-QN, else the configured optimizer).
Importing the package registers them.  The reference's host-kind solvers
(consensus-ADMM, block CD) come with the multi-device slice.
"""

from photon_ml_tpu_torch.solvers import registry
from photon_ml_tpu_torch.solvers.registry import (  # noqa: F401
    ResidentSolve,
    SolverDef,
    get,
    names,
    register,
    resolve,
)
