"""``mx.contrib`` (counterpart of ``incubator_mxnet_tpu/contrib/``; ref:
python/mxnet/contrib/__init__.py): ``quantization``.  ``onnx`` and
``text`` are ROADMAP item 12."""
from . import quantization  # noqa: F401
