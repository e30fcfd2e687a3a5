"""Gluon: the imperative layer API (ref: python/mxnet/gluon/__init__.py).

Block/HybridBlock, Parameter/Constant/ParameterDict, the layers, the model
zoo, the losses, the Trainer, ``utils``, ``rnn``, ``contrib`` and ``data``.
"""
from .parameter import (Parameter, Constant, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import loss  # noqa: F401
from . import model_zoo  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import utils  # noqa: F401
from . import contrib  # noqa: F401
from . import data  # noqa: F401
