"""`nd` namespace: NDArray + one generated function per registered operator.

Counterpart of ``incubator_mxnet_tpu/ndarray/__init__.py``.
"""
from __future__ import annotations

from .. import ops as _ops  # noqa: F401  (registers every op)
from ..context import Context, current_context, cpu  # noqa: F401
from ..ops.registry import get_op
from .ndarray import (NDArray, array, empty, invoke, waitall,  # noqa: F401
                      imperative_invoke, concatenate, moveaxis)
from . import register as _register
from .utils import save, load, load_buffer  # noqa: F401
from . import sparse  # noqa: E402,F401


def zeros(shape, ctx=None, dtype="float32", stype=None, **kwargs):
    """ref: python/mxnet/ndarray/utils.py zeros; ``stype`` ``'row_sparse'``
    or ``'csr'`` gives an empty sparse array (``sparse.zeros``)."""
    if isinstance(shape, int):
        shape = (shape,)
    if stype not in (None, "default"):
        return sparse.zeros(stype, shape, ctx=ctx, dtype=dtype)
    return invoke(get_op("_zeros"), [], {"shape": tuple(shape),
                                         "dtype": dtype, "ctx": ctx})


def ones(shape, ctx=None, dtype="float32", **kwargs):
    if isinstance(shape, int):
        shape = (shape,)
    return invoke(get_op("_ones"), [], {"shape": tuple(shape),
                                        "dtype": dtype, "ctx": ctx})


def full(shape, val, ctx=None, dtype="float32", out=None):
    if isinstance(shape, int):
        shape = (shape,)
    return invoke(get_op("_full"), [], {"shape": tuple(shape),
                                        "value": float(val), "dtype": dtype,
                                        "ctx": ctx}, out=out)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    """ref: python/mxnet/ndarray/ndarray.py arange"""
    return invoke(get_op("_arange"), [], {"start": start, "stop": stop,
                                          "step": step, "repeat": repeat,
                                          "dtype": dtype, "ctx": ctx})


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    return invoke(get_op("_eye"), [], {"N": N, "M": M, "k": k,
                                       "dtype": dtype, "ctx": ctx})


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    return invoke(get_op("_linspace"), [], {"start": start, "stop": stop,
                                            "num": num, "endpoint": endpoint,
                                            "dtype": dtype, "ctx": ctx})


def zeros_like(data, **kwargs):
    return invoke(get_op("zeros_like"), [data], {})


def ones_like(data, **kwargs):
    return invoke(get_op("ones_like"), [data], {})


def onehot_encode(indices, out):
    """One-hot rows of ``indices`` written into ``out`` (its width is the
    depth) (ref: python/mxnet/ndarray/ndarray.py onehot_encode)."""
    res = invoke(get_op("one_hot"), [indices], {"depth": out.shape[1]})
    return invoke(get_op("Cast"), [res], {"dtype": out._data.dtype}, out=out)


def Custom(*args, **kwargs):
    """Python-defined custom op (ref: src/operator/custom/custom.cc;
    register with ``mx.operator.register``)."""
    from ..operator import custom_nd
    return custom_nd(*args, **kwargs)


# generate the remaining op surface
_register.populate(globals())


def cast_storage(arr, stype="default"):
    """The storage-type cast on the array surface (ref:
    src/operator/tensor/cast_storage.cc): ``sparse.cast_storage``.  It
    shadows the registered op, whose dense pass-through serves graphs."""
    return sparse.cast_storage(arr, stype)


def sparse_retain(data, indices):
    """The rows ``indices`` of ``data`` (ref:
    src/operator/tensor/sparse_retain.cc): row-sparse in, row-sparse out
    (``sparse.retain``); a dense array takes the registered op, which
    zeroes the other rows."""
    if isinstance(data, sparse.RowSparseNDArray):
        return sparse.retain(data, indices)
    return invoke(get_op("_sparse_retain_dense"), [data, indices], {})

# the namespaces of the reference: nd.random, nd.linalg, nd.contrib (and
# nd.sparse, above)
from . import random  # noqa: E402,F401
from . import linalg  # noqa: E402,F401
from . import contrib  # noqa: E402,F401
