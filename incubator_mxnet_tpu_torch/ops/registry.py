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
(``fvisible``).  The same registration serves the symbolic path
(``symbol``): the names of an op's array inputs (``input_names``,
``aux_input_names``, ``fargnames``), the parameter shapes it can infer from
its data's (``finfer_params``), its output count where the parameters set
it (``fnum_outputs``), and its output shapes and dtypes, from a run of the
fcompute on ``meta`` tensors (:meth:`Operator.infer`, the counterpart of
``jax.eval_shape``), memoised per call signature (:func:`infer_cached`).
An op that cannot live inside a captured CUDA graph (it reads a value on
the host, its output shape depends on the data, or it synchronizes) is
registered ``deferrable=False``: ``mx.engine.bulk`` then runs it eagerly,
after its pending inputs flush (the JAX build's ``no_jit``), and a
hybridized block's CUDA graph splits around it.
"""
from __future__ import annotations

import inspect
import os
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

import torch

from ..base import MXNetError, numpy_dtype, torch_dtype

__all__ = ["Operator", "register", "get_op", "BoundedCache", "infer_cached",
           "hashable"]

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
    aux_input_names : the inputs that are auxiliary states (BatchNorm's
        moving statistics): a symbol's variables for them are marked
        ``__aux__``.
    fargnames : ``params -> names``, the input names when the parameters
        decide them (LeakyReLU's gamma only for ``prelu``).
    finfer_params : ``(data_shape, params) -> {input name: shape}``, the
        parameter shapes the op's data shape gives (FInferShape's backward
        half, ref: convolution.cc).
    fnum_outputs : ``params -> int``, the output count when the parameters
        set it (split's ``num_outputs``).
    fupdate_aux : ``(params, aux, outputs) -> None``, the update of the
        auxiliary input tensors ``aux`` (in ``aux_input_names`` order), in
        place, from every output of a training call (BatchNorm's moving
        statistics); the symbolic executor calls it, as MXNet's operator
        does in its forward.
    finfer : ``(input_shapes_dtypes, params, is_train) -> [(shape,
        dtype)]``, the outputs where a run on ``meta`` tensors cannot give
        them (a custom op's ``infer_shape``/``infer_type``).
    deferrable : False for an op that cannot be recorded into a bulk
        segment, which replays as one captured CUDA graph on the card: it
        reads a value on the host, its output shape depends on the data, or
        it synchronizes with the card.  A hybridized block's CUDA graph
        splits around such an op, which runs eagerly between the pieces.
    """

    def __init__(self, name: str, fcompute: Callable, *,
                 num_inputs: Optional[int] = 1, input_names=None,
                 num_outputs: int = 1, num_visible_outputs=None,
                 mutate_inputs=(), nograd_inputs=(), differentiable=True,
                 takes_is_train=False, needs_rng=False, fvisible=None,
                 aux_input_names=(), fargnames=None, finfer_params=None,
                 fnum_outputs=None, fupdate_aux=None, finfer=None,
                 deferrable=True, doc: str = ""):
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
        self.aux_input_names = tuple(aux_input_names)
        self.fargnames = fargnames
        self.finfer_params = finfer_params
        self.fnum_outputs = fnum_outputs
        self.fupdate_aux = fupdate_aux
        self.finfer = finfer
        self.deferrable = bool(deferrable)
        self.doc = doc
        try:
            sig = inspect.signature(fcompute)
            self._defaults = {k: v.default for k, v in sig.parameters.items()
                              if v.default is not inspect.Parameter.empty}
        except (TypeError, ValueError):
            self._defaults = {}

    def arg_names(self, params):
        """The names of the inputs a call with ``params`` takes, or None
        for an op with unnamed inputs (FListInputNames: ``bias`` goes with
        ``no_bias``, whose default is the fcompute's)."""
        if self.fargnames is not None:
            return list(self.fargnames(params))
        if self.input_names is None:
            return None
        names = list(self.input_names)
        if "bias" in names and params.get("no_bias",
                                          self._defaults.get("no_bias")):
            names.remove("bias")
        return names

    def infer(self, input_shapes_dtypes, params, is_train=False):
        """[(shape, dtype)] of the outputs of a call on inputs of
        ``input_shapes_dtypes`` [(shape, dtype)]: the fcompute run on
        ``meta`` tensors, which compute nothing (a creation op gets
        ``device="meta"``, an op that draws ``generator=None``).  An op that
        reads values on the host cannot run so and raises ``MXNetError``;
        ``finfer`` answers for such an op where it is given."""
        if self.finfer is not None:
            return self.finfer(input_shapes_dtypes, params, is_train)
        metas = [torch.empty(tuple(s), dtype=torch_dtype(d), device="meta")
                 for s, d in input_shapes_dtypes]
        kw = {k: v for k, v in params.items()
              if v is not None or k == "axis"}
        kw.pop("ctx", None)
        kw.pop("name", None)
        if self.num_inputs == 0:
            kw["device"] = torch.device("meta")
        if self.takes_is_train:
            kw["is_train"] = bool(is_train)
        if self.needs_rng:
            kw["generator"] = None
        try:
            with torch.no_grad():
                out = self.fcompute(*metas, **kw)
        except MXNetError:
            raise
        except Exception as e:
            raise MXNetError("cannot infer the outputs of %s on meta tensors "
                             "(%s: %s)" % (self.name, type(e).__name__,
                                           e)) from e
        out = out if isinstance(out, (tuple, list)) else (out,)
        return [(tuple(o.shape), numpy_dtype(o.dtype)) for o in out]

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


class BoundedCache(object):
    """Recency-ordered dict with least-recently-used eviction (the JAX
    build's ``engine.BoundedCache``).  The bound is the environment
    variable ``env`` (``GRAFT_REPLAY_CACHE_SIZE``, default 1024; 0 or less
    is unbounded), read at every insertion.  ``on_evict(value)`` runs for
    each evicted value (the engine frees a captured graph there)."""

    DEFAULT_SIZE = 1024

    def __init__(self, env="GRAFT_REPLAY_CACHE_SIZE", on_evict=None):
        self._env = env
        self._d = OrderedDict()
        self._on_evict = on_evict

    def _bound(self):
        try:
            return int(os.environ.get(self._env, str(self.DEFAULT_SIZE)))
        except ValueError:
            return self.DEFAULT_SIZE

    def get(self, key, default=None):
        try:
            self._d.move_to_end(key)
        except KeyError:
            return default
        return self._d[key]

    def __getitem__(self, key):
        self._d.move_to_end(key)
        return self._d[key]

    def __setitem__(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        bound = self._bound()
        if bound > 0:
            while len(self._d) > bound:
                _, old = self._d.popitem(last=False)
                if self._on_evict is not None:
                    self._on_evict(old)

    def __contains__(self, key):
        return key in self._d

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def items(self):
        """A list of the (key, value) pairs, least recent first."""
        return list(self._d.items())

    def pop(self, key, default=None):
        return self._d.pop(key, default)

    def clear(self):
        self._d.clear()


def hashable(value):
    """A hashable form of an op's parameter value that tells apart what
    computes differently (``2`` and ``2.0``, ``True`` and ``1``); raises
    ``TypeError`` for a value that has none (a tensor)."""
    if isinstance(value, dict):
        return ("dict",) + tuple(sorted((k, hashable(v))
                                        for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return (type(value).__name__,) + tuple(hashable(v) for v in value)
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, torch.Tensor):
        raise TypeError("a tensor parameter has no hashable form")
    if isinstance(value, (bool, int, float, complex, np.generic)):
        return (type(value).__name__, value)
    hash(value)
    return value


# (op name, input (shape, dtype)s, hashable params, is_train) -> the
# inferred [(shape, dtype)]: the first meta inference in a process costs
# seconds (torch loads its meta kernels) and every one costs about a
# dispatch, so a recorded op would otherwise be slower than a run one
_infer_cache = BoundedCache()


def infer_cached(op, input_shapes_dtypes, params, is_train=False):
    """:meth:`Operator.infer`, memoised per call signature (a call whose
    parameters have no hashable form is inferred every time)."""
    try:
        key = (op.name, tuple((tuple(s), str(d))
                              for s, d in input_shapes_dtypes),
               hashable({k: v for k, v in params.items()
                         if k not in ("ctx", "name")}), bool(is_train))
    except TypeError:
        return op.infer(input_shapes_dtypes, params, is_train)
    out = _infer_cache.get(key)
    if out is None:
        out = op.infer(input_shapes_dtypes, params, is_train)
        _infer_cache[key] = out
    return out


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
