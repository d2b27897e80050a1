"""Solver subsystem: the config-keyed registry and the communication-light
solvers (port of ``photon_ml_tpu/solvers/``).

Every solver — the resident L-BFGS / OWL-QN / TRON / SPG and the host-kind
consensus-ADMM (``admm.py``) and distributed block coordinate descent
(``block_cd.py``) — registers a
:class:`~photon_ml_tpu_torch.solvers.registry.SolverDef` and is selected by
``OptimizerConfig.solver`` (name) and ``solver_options`` (knobs); unset
``solver`` keeps the historical routing (bounds → SPG, any L1 component →
OWL-QN, else the configured optimizer).  Importing the package registers
every built-in solver.
"""

from photon_ml_tpu_torch.solvers import admm as _admm  # noqa: F401  (registers)
from photon_ml_tpu_torch.solvers import block_cd as _block_cd  # noqa: F401
from photon_ml_tpu_torch.solvers import registry
from photon_ml_tpu_torch.solvers.registry import (  # noqa: F401
    ResidentSolve,
    SolverDef,
    get,
    names,
    register,
    resolve,
    solver_options_dict,
)
