"""Runtime invariant checks (port of ``photon_ml_tpu/analysis``, the
runtime half): lock-order tracking and thread- and process-leak
sentinels, in :mod:`photon_ml_tpu_torch.analysis.sanitizers`.  The
reference's static checker (``python -m photon_ml_tpu.analysis
--check`` and its rules) is ROADMAP item 8d.
"""
