"""Model zoo (counterpart of ``incubator_mxnet_tpu/gluon/model_zoo``; ref:
python/mxnet/gluon/model_zoo/__init__.py).  The vision models ported so
far are the ResNets; pretrained weights are not available."""
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401
