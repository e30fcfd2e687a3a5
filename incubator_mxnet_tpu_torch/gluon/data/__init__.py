"""Gluon data API (ref: python/mxnet/gluon/data/__init__.py)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401
