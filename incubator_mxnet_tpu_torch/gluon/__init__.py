"""Gluon: the imperative layer API (ref: python/mxnet/gluon/__init__.py).

Block/HybridBlock, Parameter/ParameterDict, the layers of the
decoder-transformer LM and of the ResNets (convolution, pooling,
BatchNorm), the model zoo's ResNets, the losses and the Trainer.
"""
from .parameter import Parameter, ParameterDict, DeferredInitializationError  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import model_zoo  # noqa: F401
from .trainer import Trainer  # noqa: F401
