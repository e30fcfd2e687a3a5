"""Custom operators written in Python (ref: python/mxnet/operator.py
CustomOp:422, CustomOpProp:468, register).

Counterpart of ``incubator_mxnet_tpu/operator.py`` (:100-183).  Each
registered ``CustomOpProp`` becomes a registry op ``_custom_<op_type>``,
reached by ``nd.Custom(*data, op_type=...)``, whose fcompute is one
``torch.autograd.Function``:

- its forward calls the user's ``forward`` with ``req=["write"]`` on
  NDArrays over the input tensors where they lie, and zero-filled outputs;
  there is no trip to the host (the JAX build's ``pure_callback`` round trip
  is an XLA matter);
- its backward calls the user's ``backward`` with zero-filled ``in_grad``
  buffers, ``out_grad`` and the saved ``in_data``/``out_data``.  An input
  that needs no gradient (a label, an array without ``attach_grad``) gets
  ``req="null"`` and no gradient.

The user's code runs with recording paused.  ``sym.Custom`` makes a
symbol node of a registered op (:func:`custom_sym`); the Executor runs it
through the same registry op, so its forward and backward are the custom
op's methods, and its outputs' shapes and dtypes come from the prop's
``infer_shape``/``infer_type`` (the op reads its inputs on the host, so a
run on ``meta`` tensors cannot give them).  A custom op is never deferred
by ``mx.engine.bulk``.
"""
from __future__ import annotations

import torch

from . import autograd
from .base import MXNetError, numpy_dtype, torch_dtype
from .ops.registry import Operator, _REGISTRY

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators", "custom_nd", "custom_sym"]

_CUSTOM_PROPS = {}


class CustomOp:
    """Base class for the runtime part of a custom operator
    (ref: operator.py CustomOp:422)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute outputs: write into ``out_data`` via :meth:`assign`."""
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute input gradients into ``in_grad`` via :meth:`assign`."""
        raise NotImplementedError

    def assign(self, dst, req, src):
        """ref: operator.py CustomOp.assign — honors req null/write/add."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise ValueError("unknown req %r" % req)


class CustomOpProp:
    """Static properties of a custom operator (ref: CustomOpProp:468)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        """Default: all outputs and aux states take the first input's shape."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), \
            [in_shape[0]] * len(self.list_auxiliary_states())

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


class _CustomFunction(torch.autograd.Function):
    """One call of a custom op under torch's autograd."""

    @staticmethod
    def forward(ctx, prop, is_train, *inputs):
        from .ndarray.ndarray import NDArray
        in_shapes = [list(x.shape) for x in inputs]
        in_dtypes = [numpy_dtype(x.dtype) for x in inputs]
        _, out_shapes, _ = prop.infer_shape(in_shapes)
        _, out_types, _ = prop.infer_type(in_dtypes)
        in_nd = [NDArray(x) for x in inputs]
        op = prop.create_operator(in_nd[0].context if in_nd else None,
                                  in_shapes, in_dtypes)
        device = inputs[0].device
        out_nd = [NDArray(torch.zeros(tuple(s), dtype=torch_dtype(t),
                                      device=device))
                  for s, t in zip(out_shapes, out_types)]
        with autograd.pause(train_mode=is_train):
            op.forward(is_train=is_train, req=["write"] * len(out_nd),
                       in_data=in_nd, out_data=out_nd, aux=[])
        outs = tuple(o._data for o in out_nd)
        ctx.op = op
        ctx.n_in = len(inputs)
        ctx.save_for_backward(*inputs, *outs)
        return outs

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        needs = ctx.needs_input_grad[2:]
        in_grad = [NDArray(torch.zeros_like(x)) for x in ins]
        with autograd.pause(train_mode=autograd.is_training()):
            ctx.op.backward(req=["write" if n else "null" for n in needs],
                            out_grad=[NDArray(g) for g in out_grads],
                            in_data=[NDArray(x) for x in ins],
                            out_data=[NDArray(o) for o in outs],
                            in_grad=in_grad, aux=[])
        return (None, None) + tuple(g._data if n else None
                                    for g, n in zip(in_grad, needs))


def _make_custom_operator(op_type, prop_cls):
    """A registry op for one registered CustomOpProp.  The prop is made per
    call from the call's params, as strings (MXNet's convention)."""

    def make_prop(params):
        return prop_cls(**{k: str(v) for k, v in params.items()
                           if k not in ("is_train", "device")})

    def finfer(input_shapes_dtypes, params, is_train=False):
        prop = make_prop(params)
        _, out_shapes, _ = prop.infer_shape(
            [list(s) for s, _ in input_shapes_dtypes])
        _, out_types, _ = prop.infer_type(
            [numpy_dtype(d) for _, d in input_shapes_dtypes])
        return [(tuple(s), numpy_dtype(t))
                for s, t in zip(out_shapes, out_types)]

    def fcompute(*inputs, **params):
        prop = make_prop(params)
        if len(inputs) != len(prop.list_arguments()):
            raise MXNetError("Custom op %r takes %d inputs (%s), got %d" % (
                op_type, len(prop.list_arguments()), prop.list_arguments(),
                len(inputs)))
        return _CustomFunction.apply(prop, autograd.is_training(), *inputs)

    # the user's code may read its inputs on the host: never deferred
    return Operator("_custom_" + op_type, fcompute, num_inputs=None,
                    deferrable=False, finfer=finfer,
                    fargnames=lambda p: make_prop(p).list_arguments(),
                    fnum_outputs=lambda p: len(make_prop(p).list_outputs()),
                    doc="Custom op %r (prop %s; ref: operator.py register)"
                        % (op_type, prop_cls.__name__))


def register(reg_name):
    """Decorator registering a CustomOpProp under ``op_type=reg_name``
    (ref: operator.py register / MXCustomOpRegister)."""

    def dec(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise TypeError("register must wrap a CustomOpProp subclass")
        _CUSTOM_PROPS[reg_name] = prop_cls
        op = _make_custom_operator(reg_name, prop_cls)
        _REGISTRY[op.name] = op
        return prop_cls

    return dec


def get_all_registered_operators():
    return sorted(_CUSTOM_PROPS)


def custom_nd(*args, op_type=None, **kwargs):
    """``nd.Custom(*data, op_type='name', **params)`` (ref: custom.cc)."""
    from .ndarray.ndarray import invoke
    if op_type is None:
        raise TypeError("Custom requires op_type=")
    op = _REGISTRY.get("_custom_" + op_type)
    if op is None:
        raise MXNetError("Custom op type %r is not registered (have: %s)"
                         % (op_type, get_all_registered_operators()))
    out = kwargs.pop("out", None)
    kwargs.pop("name", None)
    return invoke(op, list(args), kwargs, out=out)


def custom_sym(*args, op_type=None, name=None, **kwargs):
    """``sym.Custom(*data, op_type='name', **params)``: a node of the
    registered custom op (ref: the JAX build's operator.py:227)."""
    from .symbol.symbol import _make_node
    if op_type is None:
        raise TypeError("Custom requires op_type=")
    op = _REGISTRY.get("_custom_" + op_type)
    if op is None:
        raise MXNetError("Custom op type %r is not registered (have: %s)"
                         % (op_type, get_all_registered_operators()))
    return _make_node(op, list(args), kwargs, name=name)
