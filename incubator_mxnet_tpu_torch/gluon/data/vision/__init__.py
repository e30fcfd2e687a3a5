"""Vision data (ref: python/mxnet/gluon/data/vision/__init__.py)."""
from .datasets import *  # noqa: F401,F403
from . import transforms  # noqa: F401
