"""Gluon neural-network layers (ref: python/mxnet/gluon/nn/__init__.py)."""
from ..block import Block, HybridBlock  # noqa: F401
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
