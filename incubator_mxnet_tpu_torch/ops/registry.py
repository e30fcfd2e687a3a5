"""Operator registry for eager calls.

Counterpart of ``incubator_mxnet_tpu/ops/registry.py`` (``register`` :245,
``get_op`` :268).  One registration per operator feeds the eager NDArray
front end (``ndarray.invoke``) and the generated ``mx.nd.<op>`` surface.
Each ``fcompute`` is a plain function on ``torch.Tensor``s; it may return a
view of an input, and ``invoke`` copies such an output so that op results
never alias their inputs (MXNet's semantics).  Creation ops
(``num_inputs=0``) take a ``device`` keyword, which ``invoke`` supplies
from the context.  Gradients come from torch's autograd through the
fcompute itself; the metadata below tells ``invoke`` what torch cannot
see (which inputs an op mutates, which take no gradient), whether it
computes otherwise in training (``takes_is_train``), whether it draws
random numbers (``needs_rng``), and how many of its outputs a call shows
(``fvisible``).  The symbolic executor is not in this slice.
"""
from __future__ import annotations

from typing import Callable, Optional

__all__ = ["Operator", "register", "get_op"]

_REGISTRY: dict[str, "Operator"] = {}


class Operator:
    """One registered operator.

    Parameters
    ----------
    name : canonical op name (e.g. ``FullyConnected``, ``broadcast_add``).
    fcompute : function ``(*tensors, **params) -> tensor | tuple``.
    num_inputs : fixed arity, or ``None`` for optional trailing inputs.
    input_names : names of the array inputs that may be passed by keyword.
    num_outputs : outputs the fcompute returns; the first
        ``num_visible_outputs`` (default all) are returned to the caller.
    fvisible : ``(params, n_outputs) -> int``, the visible outputs when they
        depend on the call's parameters (BatchNorm: 1, or 3 with
        ``output_mean_var``); overrides ``num_visible_outputs``.
    takes_is_train : the fcompute takes a keyword ``is_train``, which
        ``invoke`` sets from ``autograd.is_training()``.
    needs_rng : the fcompute takes a keyword ``generator``, which ``invoke``
        sets to the framework generator of the output's device
        (``random_state.generator``): every draw goes through it, never
        through torch's default generator.  A function ``(params,
        is_train) -> bool`` instead says which calls draw (Dropout's in
        training); the others get ``generator=None``, so an inference
        forward makes no generator (none may be made while a CUDA graph
        captures).
    mutate_inputs : for an update op, ``(0, i, j, ...)``: output 0 is the
        result (``out=`` takes it), and outputs 1, 2, ... are written back
        into inputs i, j, ... in place (optimizer state, as the reference's
        FMutateInputs).
    nograd_inputs : input positions that never receive a gradient (indices,
        labels); under ``record()`` they enter the op detached.
    differentiable : False for ops that are never recorded (updates).
    """

    def __init__(self, name: str, fcompute: Callable, *,
                 num_inputs: Optional[int] = 1, input_names=None,
                 num_outputs: int = 1, num_visible_outputs=None,
                 mutate_inputs=(), nograd_inputs=(), differentiable=True,
                 takes_is_train=False, needs_rng=False, fvisible=None,
                 doc: str = ""):
        self.name = name
        self.fcompute = fcompute
        self.num_inputs = num_inputs
        self.input_names = input_names
        self.num_outputs = num_outputs
        self.num_visible_outputs = (num_outputs if num_visible_outputs is None
                                    else num_visible_outputs)
        self.mutate_inputs = tuple(mutate_inputs)
        self.nograd_inputs = tuple(nograd_inputs)
        self.differentiable = differentiable
        self.takes_is_train = takes_is_train
        self.needs_rng = needs_rng
        self.fvisible = fvisible
        self.doc = doc

    def draws(self, params, is_train):
        """Whether a call with ``params`` draws random numbers."""
        if callable(self.needs_rng):
            return self.needs_rng(params, is_train)
        return self.needs_rng

    def visible_outputs(self, params, n_outputs):
        """How many of ``n_outputs`` a call with ``params`` shows (the rest
        are auxiliary, as BatchNorm's batch statistics)."""
        if self.fvisible is not None:
            return self.fvisible(params, n_outputs)
        return n_outputs - (self.num_outputs - self.num_visible_outputs)

    def __repr__(self):
        return "Operator(%s)" % self.name


def register(name, **kwargs):
    """Decorator: register ``fcompute`` under ``name`` (+ optional aliases)."""
    aliases = kwargs.pop("aliases", ())

    def dec(fcompute):
        op = Operator(name, fcompute, doc=fcompute.__doc__ or "", **kwargs)
        _REGISTRY[name] = op
        for a in aliases:
            _REGISTRY[a] = op
        return fcompute

    return dec


def get_op(name: str) -> Operator:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError("Operator %r is not registered (have %d ops)"
                       % (name, len(_REGISTRY))) from None
