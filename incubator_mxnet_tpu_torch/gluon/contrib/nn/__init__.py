"""Contrib neural-network layers (ref:
python/mxnet/gluon/contrib/nn/__init__.py)."""
from .basic_layers import *  # noqa: F401,F403
from . import basic_layers  # noqa: F401
