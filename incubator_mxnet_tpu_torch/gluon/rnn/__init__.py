"""Gluon recurrent cells and fused layers (counterpart of
``incubator_mxnet_tpu/gluon/rnn``; ref: python/mxnet/gluon/rnn/__init__.py)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
