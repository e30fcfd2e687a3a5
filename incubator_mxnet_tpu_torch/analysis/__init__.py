"""Checks of the framework's own invariants (counterpart of
``incubator_mxnet_tpu/analysis/``): ``engine_check``, the strict-mode
hazard checks of ``mx.engine.bulk`` segments."""
