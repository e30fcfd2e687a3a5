"""Contrib recurrent cells (counterpart of
``incubator_mxnet_tpu/gluon/contrib/rnn``; ref:
python/mxnet/gluon/contrib/rnn/__init__.py)."""
from .rnn_cell import *  # noqa: F401,F403
from . import rnn_cell  # noqa: F401
