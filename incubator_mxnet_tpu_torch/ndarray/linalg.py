"""``nd.linalg`` namespace: short names over the ``_linalg_*`` ops
(counterpart of ``incubator_mxnet_tpu/ndarray/linalg.py``; ref:
python/mxnet/ndarray/linalg.py)."""
from __future__ import annotations

from ..ops.registry import get_op
from .register import make_op_func

_OPS = ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm", "sumlogdiag",
        "syrk", "gelqf", "syevd")

for _n in _OPS:
    globals()[_n] = make_op_func(_n, get_op("_linalg_" + _n))

__all__ = list(_OPS)
