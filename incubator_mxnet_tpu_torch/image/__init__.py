"""Image API (ref: python/mxnet/image/__init__.py)."""
from .image import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from . import detection  # noqa: F401
from . import image  # noqa: F401
