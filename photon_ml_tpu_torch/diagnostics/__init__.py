"""Training diagnostics: the GLM driver's ``--training-report``."""

from photon_ml_tpu_torch.diagnostics.report import (
    TrainingReport,
    bootstrap_metric_ci,
    feature_importance,
    hosmer_lemeshow,
)

__all__ = [
    "TrainingReport",
    "bootstrap_metric_ci",
    "feature_importance",
    "hosmer_lemeshow",
]
