"""Tuning orchestration: parallel trials, ASHA, crash-safe resumable search
(port of ``photon_ml_tpu/tuning``; host code, so the reference's modules
with the port's imports).

The production layer over hyperparameter/search.py (Photon-ML's
``ml.hyperparameter`` package): ask/tell proposers with
constant-liar GP batching and an ASHA successive-halving scheduler
(tuning/scheduler.py), a bounded-concurrency trial executor with λ-path
warm starts and watchdog-classified crash handling
(tuning/executor.py), and an fsync'd append-only decision journal that
makes ``--resume`` replay a killed search bit-identically
(tuning/state.py).  ``python -m photon_ml_tpu_torch.tuning`` is the CLI
over the port's GLM and GAME drivers.  Trials run in threads that share
the card; the fits they reach count their kernel launches under a lock
(``ops/_kernels.py::count_launch``).
"""

from photon_ml_tpu_torch.tuning.executor import (  # noqa: F401
    TrialReport,
    TuningConfig,
    TuningOrchestrator,
    TuningResult,
)
from photon_ml_tpu_torch.tuning.scheduler import (  # noqa: F401
    AshaConfig,
    AshaScheduler,
    GPProposer,
    GridProposer,
    Proposer,
    RandomProposer,
    SearchSpace,
    make_proposer,
)
from photon_ml_tpu_torch.tuning.state import (  # noqa: F401
    ResumeMismatch,
    SearchAborted,
    TrialStore,
    TuningJournal,
    replay_journal,
)
