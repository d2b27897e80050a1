"""Multi-device training over ``torch.distributed`` (port of
``photon_ml_tpu/parallel/``): row-block sharding and the data-parallel
λ grid (``distributed.py``), the process-group bring-up
(``multihost.py``)."""
