"""Autograd: MXNet's recording scopes and gradient API on torch's engine.

Counterpart of ``incubator_mxnet_tpu/autograd/__init__.py``.  There each
recorded eager op appends a ``jax.vjp`` closure to a tape that
``backward`` walks.  Here the tape is torch's own graph: ``ndarray.invoke``
runs an op with torch's grad mode on only inside :func:`record`, so a
recorded op's output carries its ``grad_fn`` and an op outside ``record()``
builds no graph.  What stays MXNet's:

- ``attach_grad``/:func:`mark_variables` give an array a persistent grad
  buffer with a ``grad_req`` of ``write``, ``add`` or ``null``, filled by
  :func:`backward` (not torch's accumulating ``.grad``);
- a head with no head gradient is seeded with ones (:func:`head_seed`);
- :class:`Function` is a custom differentiable function on NDArrays, run as
  one ``torch.autograd.Function``;
- ``grad(create_graph=True)`` returns gradients that are themselves on the
  tape, so a second (third, ...) derivative follows, as the reference's
  higher-order backward;
- :func:`backward` and :func:`grad` first flush the open ``mx.engine.bulk``
  segment (cause ``autograd``), whose recorded ops become one tape node;
- :func:`get_symbol` turns a recorded history into a Symbol, each node with
  its parameters (ref: MXAutogradGetSymbol).
"""
from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager

import torch

from ..base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "head_seed", "Function", "get_symbol"]

_state = threading.local()
# every array with a grad buffer, by id; backward delivers into those its
# heads reach (weak: dropping an array unmarks it).  Keyed by id, not a
# WeakSet: NDArray's ``==`` is elementwise, and a set would call it
_variables = weakref.WeakValueDictionary()
_variables_lock = threading.Lock()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_recording):  # noqa: A002 - parity signature
    s = _st()
    prev = s.recording
    s.recording = bool(is_recording)
    return prev


def set_training(train_mode):
    s = _st()
    prev = s.training
    s.training = bool(train_mode)
    return prev


@contextmanager
def _scope(recording=None, training=None):
    s = _st()
    prev_r, prev_t = s.recording, s.training
    if recording is not None:
        s.recording = recording
    if training is not None:
        s.training = training
    try:
        yield
    finally:
        s.recording, s.training = prev_r, prev_t


def record(train_mode=True):
    """ref: autograd.py:93 record scope."""
    return _scope(recording=True, training=train_mode)


def pause(train_mode=False):
    return _scope(recording=False, training=train_mode)


def train_mode():
    return _scope(training=True)


def predict_mode():
    return _scope(training=False)


def head_seed(value: torch.Tensor) -> torch.Tensor:
    """The head gradient of a head given none: ones of its shape and dtype
    (``d(sum)/d``, as the reference's ``backward()``)."""
    return torch.ones_like(value)


def mark_variables(variables, gradients, grad_reqs="write"):
    """ref: imperative.cc:112 MarkVariables — attach grad buffers.

    The array's tensor becomes a torch leaf that requires grad (its
    recorded history, if any, is cut, as MXNet's ``attach_grad`` does), so
    ops on it are recorded; ``grad_req='null'`` keeps its buffer as it is."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        t = v._data
        if t.grad_fn is not None:
            t = v._data = t.detach()
        t.requires_grad_(True)
        v._grad = g
        v._grad_req = req
        with _variables_lock:
            _variables[id(v)] = v


def _flush_heads(heads):
    """Land the open bulk segment, and any other segment a head waits on,
    with the flush cause ``autograd``."""
    from .. import engine
    engine.flush(cause="autograd")
    for h in heads:
        if type(h._slot) is engine._Pending:
            engine.resolve_nd(h, "autograd")


def _head_tensors(heads, head_grads):
    _flush_heads(heads)
    outs, seeds = [], []
    for i, h in enumerate(heads):
        if not h._data.requires_grad:
            raise MXNetError(
                "cannot differentiate head %d: it was not computed under "
                "autograd.record() from an array with attach_grad()" % i)
        hg = None if head_grads is None else head_grads[i]
        outs.append(h._data)
        seeds.append(head_seed(h._data) if hg is None else
                     hg._data.to(h._data.dtype))
    return outs, seeds


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """ref: autograd.py:243 / MXAutogradBackwardEx.  Fills the grad buffer
    of every marked array the heads depend on, by its ``grad_req``."""
    from ..ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        head_grads = None if head_grads is None else (
            [head_grads] if isinstance(head_grads, NDArray) else head_grads)
    with _variables_lock:
        variables = [v for v in _variables.values()
                     if v._grad_req != "null" and v._data.requires_grad]
    outs, seeds = _head_tensors(heads, head_grads)
    if not variables:
        return
    with _scope(recording=False, training=train_mode):
        grads = torch.autograd.grad(outs, [v._data for v in variables], seeds,
                                    retain_graph=retain_graph,
                                    allow_unused=True)
    with torch.no_grad():
        for v, g in zip(variables, grads):
            if g is None:
                continue            # not reached from the heads
            if v._grad_req == "add":
                v._grad._data.add_(g)
            else:
                v._grad._data.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """ref: autograd.py:270 — the gradients of ``heads`` with respect to
    ``variables``, as new arrays (zeros for a variable the heads do not
    reach); grad buffers are left alone.  With ``create_graph`` the
    gradients are recorded too (``retain_graph`` then defaults to True), so
    they can be differentiated again."""
    from ..ndarray.ndarray import NDArray
    if retain_graph is None:
        retain_graph = create_graph
    if isinstance(heads, NDArray):
        heads = [heads]
        head_grads = None if head_grads is None else (
            [head_grads] if isinstance(head_grads, NDArray) else head_grads)
    for i, v in enumerate(variables):
        if not v._data.requires_grad:
            raise MXNetError("variable %d has no attached gradient: call "
                             "attach_grad() before recording" % i)
    outs, seeds = _head_tensors(heads, head_grads)
    with _scope(recording=False, training=train_mode):
        grads = torch.autograd.grad(outs, [v._data for v in variables], seeds,
                                    retain_graph=bool(retain_graph),
                                    create_graph=bool(create_graph),
                                    allow_unused=True)
    return [NDArray(torch.zeros_like(v._data) if g is None else g,
                    ctx=v.context) for g, v in zip(grads, variables)]


def _trace(x):
    """(Symbol, {variable name: array}) of ``x``'s recorded history: each
    recorded call becomes a node with its op and parameters, every array
    no recorded call made a variable ``data<i>`` (numbered as the JAX
    build's ``trace_to_symbol`` numbers them: one number per array met)."""
    from ..symbol.symbol import _make_node, var
    node_of, nodes, arrays = {}, {}, {}

    def build(ref):
        # ref: an output's ``_rec`` (call, output index), or an array
        if id(ref) in node_of:
            return node_of[id(ref)]
        if not isinstance(ref, tuple):
            name = "data%d" % len(node_of)
            node_of[id(ref)] = var(name)
            arrays[name] = ref
            return node_of[id(ref)]
        call, idx = ref
        node = nodes.get(id(call))
        if node is None:
            op, params, inputs = call
            node = nodes[id(call)] = _make_node(
                op, [build(a) for a in inputs], dict(params))
        out = node if node.num_outputs == 1 else node[idx]
        node_of[id(ref)] = out
        return out

    return build(x._rec or x), arrays


def get_symbol(x):
    """The Symbol of ``x``'s recorded history (ref: autograd.py get_symbol,
    MXAutogradGetSymbol): bound with the arrays the history started from,
    it computes ``x`` again."""
    return _trace(x)[0]


class _FunctionBridge(torch.autograd.Function):
    """Runs one :class:`Function`'s forward and backward on NDArrays."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from ..ndarray.ndarray import NDArray
        ctx.fn = fn
        with pause(train_mode=is_training()):
            outs = fn.forward(*[NDArray(t) for t in tensors])
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        return tuple(o._data for o in outs)

    @staticmethod
    def backward(ctx, *out_grads):
        from ..ndarray.ndarray import NDArray
        with pause(train_mode=is_training()):
            in_grads = ctx.fn.backward(*[NDArray(g) for g in out_grads])
        if not isinstance(in_grads, (list, tuple)):
            in_grads = [in_grads]
        return (None,) + tuple(None if g is None else g._data
                               for g in in_grads)


class Function:
    """Custom differentiable function (ref: autograd.py:364).

    Subclass and implement ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays; both run with recording
    paused.  Under ``record()`` a call is one ``torch.autograd.Function``
    node, whose backward calls this ``backward``."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        from ..ndarray.ndarray import NDArray
        if not is_recording():
            with pause(train_mode=is_training()):
                return self.forward(*inputs)
        outs = _FunctionBridge.apply(self, *[x._data for x in inputs])
        arrays = [NDArray(t) for t in outs]
        return arrays[0] if len(arrays) == 1 else arrays

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError
