"""Runtime invariant checks (port of ``photon_ml_tpu/analysis``, the
runtime half): lock-order tracking and thread- and process-leak
sentinels, in :mod:`photon_ml_tpu_torch.analysis.sanitizers`, used by
the serving, freshness and cluster packages and by ``chip_smoke.py``'s
phases.  The reference's static checker (``python -m
photon_ml_tpu.analysis --check`` and its rules, among them
``chaos-site-sync``, which every site of the port's fault catalog now
satisfies) is not ported yet (ROADMAP item 8d).
"""
