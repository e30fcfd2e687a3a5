"""Gluon contrib: experimental blocks (counterpart of
``incubator_mxnet_tpu/gluon/contrib``; ref:
python/mxnet/gluon/contrib/__init__.py)."""
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
