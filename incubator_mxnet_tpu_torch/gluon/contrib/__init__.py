"""Gluon contrib: experimental blocks (counterpart of
``incubator_mxnet_tpu/gluon/contrib``; ref:
python/mxnet/gluon/contrib/__init__.py).  ``nn`` is ported; ``rnn``
waits for the RNN slice (ROADMAP item 8) and raises."""
from ...base import MXNetError
from . import nn  # noqa: F401


def __getattr__(name):
    if name == "rnn":
        raise MXNetError("gluon.contrib.rnn is not ported yet: it comes with "
                         "the RNN slice (ROADMAP item 8)")
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
