"""``nd.contrib`` namespace: short names over the registered ``_contrib_*``
ops (counterpart of ``incubator_mxnet_tpu/ndarray/contrib.py``; ref:
python/mxnet/ndarray/contrib.py)."""
from __future__ import annotations

from ..ops.registry import _REGISTRY
from .register import make_op_func

__all__ = []
for _name, _op in list(_REGISTRY.items()):
    if _name.startswith("_contrib_"):
        _short = _name[len("_contrib_"):]
        globals()[_short] = make_op_func(_short, _op)
        __all__.append(_short)
