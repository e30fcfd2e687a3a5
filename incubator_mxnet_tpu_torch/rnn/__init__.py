"""Legacy symbolic RNN API (counterpart of ``incubator_mxnet_tpu/rnn``;
ref: python/mxnet/rnn/__init__.py).

``mx.rnn`` predates Gluon: cells compose Symbol graphs for the
Module/BucketingModule path, with ``BucketSentenceIter`` feeding bucketed
batches.  The Gluon cells live in ``mx.gluon.rnn``.
"""
from .rnn_cell import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from . import rnn_cell  # noqa: F401
from . import io  # noqa: F401
from . import rnn  # noqa: F401
