"""Model zoo (counterpart of ``incubator_mxnet_tpu/gluon/model_zoo``; ref:
python/mxnet/gluon/model_zoo/__init__.py): the vision models, and
``model_store`` for their local weight files."""
from . import model_store  # noqa: F401
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401
