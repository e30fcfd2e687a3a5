"""``sym``: Symbol, the Executor and one generated function per operator.

Counterpart of ``incubator_mxnet_tpu/symbol/__init__.py`` (ref:
python/mxnet/symbol/__init__.py), with ``sym.Custom`` (a node of a custom
op registered by ``mx.operator.register``).  The tracing of an autograd
history into a Symbol is ``autograd.get_symbol``.
"""
from __future__ import annotations

import sys

from ..ops.registry import get_op
from .symbol import (Symbol, var, Variable, Group, load, load_json,  # noqa: F401
                     _make_node)
from .executor import Executor  # noqa: F401
from . import register as _register


def _creation(op_name, shape, dtype):
    return _make_node(get_op(op_name), [],
                      {"shape": tuple(shape) if not isinstance(shape, int)
                       else (shape,), "dtype": dtype})


def zeros(shape, dtype="float32", **kwargs):
    """A node of zeros (ref: symbol.py zeros)."""
    return _creation("zeros", shape, dtype)


def ones(shape, dtype="float32", **kwargs):
    """A node of ones (ref: symbol.py ones)."""
    return _creation("ones", shape, dtype)


def Custom(*args, **kwargs):
    """A node of a Python custom op (ref: src/operator/custom/custom.cc;
    register it with ``mx.operator.register``)."""
    from ..operator import custom_sym
    return custom_sym(*args, **kwargs)


_register.populate(sys.modules[__name__].__dict__)

# sub-namespaces, as in the reference: sym.linalg, sym.contrib
from . import linalg  # noqa: E402,F401
from . import contrib  # noqa: E402,F401
