"""Scoring (port of ``photon_ml_tpu/serving``): so far the batch kernels
shared by ``GameTransformer`` and the scoring driver."""
