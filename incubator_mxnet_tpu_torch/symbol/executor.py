"""Executor: eager execution of a bound Symbol graph on torch's autograd.

Counterpart of ``incubator_mxnet_tpu/symbol/executor.py`` (ref:
src/executor/graph_executor.cc, include/mxnet/executor.h).  The JAX build
jits one program per (shapes, is_train) and recomputes the forward inside
``jax.vjp`` for the backward.  Here:

* ``forward`` walks ``symbol._topo()`` through ``ndarray.invoke``: the same
  registry and the same kernels as ``nd``, so an executor's outputs are
  bit-equal to the same ops called eagerly;
* ``forward(is_train=True)`` records torch's graph when an argument's
  ``grad_req`` is not ``null`` (those arguments enter as leaves that
  require grad), and updates BatchNorm's moving statistics as MXNet's
  operator does (``Operator.fupdate_aux``);
* ``backward(out_grads)`` is ``torch.autograd.grad`` of the outputs (heads
  without ``out_grads`` get ones) into the bound grad arrays by
  ``grad_req`` (``write``, ``add``, ``null``).  A backward with no recorded
  graph (after an inference forward, or a second backward) runs the last
  forward again under recording, with the generator state that forward
  drew from and without touching the auxiliary states;
* ``set_monitor_callback`` sees every node output, as
  ``<node>_output<i>`` (graph_executor.cc:121);
* while the profiler runs, ``forward`` and ``backward`` are the spans
  ``Executor.forward(<name>)`` and ``Executor.backward(<name>)``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd, profiler as _profiler, random_state
from ..base import MXNetError, dtype_name
from ..context import current_context
from ..ndarray import NDArray
from .. import ndarray as nd
from ..ndarray.ndarray import invoke

__all__ = ["Executor"]


class Executor(object):
    """ref: include/mxnet/executor.h Executor."""

    def __init__(self, symbol, ctx, args, args_grad, grad_req, aux_states):
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self.arg_dict = dict(args)
        self.grad_dict = dict(args_grad) if args_grad else {}
        self.aux_dict = dict(aux_states) if aux_states else {}
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self._arg_names}
        else:
            self.grad_req = dict(grad_req)
        self.arg_arrays = [self.arg_dict[n] for n in self._arg_names]
        self.grad_arrays = [self.grad_dict.get(n) for n in self._arg_names]
        self.aux_arrays = [self.aux_dict[n] for n in self._aux_names]
        self.outputs = []
        self._monitor_callback = None
        self._last = None          # (is_train, generator state) of a forward
        self._graph = None         # (output tensors, leaves) to differentiate

    # -- the graph walk ----------------------------------------------------
    def _draws(self, is_train):
        return any(node._op.draws(node._params, is_train)
                   for node in self._symbol._topo()
                   if not node.is_variable() and node._op.needs_rng)

    def _run(self, is_train, record, update_aux):
        """Run the graph once: (output tensors, {name: leaf tensor})."""
        values, leaves = {}, {}
        for n in self._arg_names:
            arr = self.arg_dict[n]
            if record and self.grad_req.get(n, "null") != "null":
                leaves[n] = arr._data.detach().requires_grad_(True)
                arr = NDArray(leaves[n], ctx=self._ctx)
            values[n] = arr
        values.update(self.aux_dict)
        # a replay for a late backward taps nothing a second time
        monitor = self._monitor_callback if update_aux else None
        cache = {}
        with self._ctx, autograd._scope(recording=record, training=is_train):
            for node in self._symbol._topo():
                if node.is_variable():
                    if node.name not in values:
                        raise MXNetError("executor: input %s not bound"
                                         % node.name)
                    cache[id(node)] = [values[node.name]]
                    continue
                ins = []
                for i in node._inputs:
                    vals = cache[id(i._base())]
                    ins.append(vals[min(i._out_index or 0, len(vals) - 1)])
                op, params = node._op, dict(node._params)
                if update_aux and is_train and op.fupdate_aux is not None:
                    outs = invoke(op, ins, params, hidden=True)
                    names = op.arg_names(params) or []
                    op.fupdate_aux(params, [a._data for a, n in zip(ins, names)
                                            if n in op.aux_input_names],
                                   [o._data for o in outs])
                    outs = outs[:op.visible_outputs(params, len(outs))]
                else:
                    out = invoke(op, ins, params)
                    outs = out if isinstance(out, list) else [out]
                cache[id(node)] = outs
                if monitor is not None:
                    for oi, o in enumerate(outs):
                        monitor("%s_output%d" % (node._name, oi), o)
        results = []
        for r in self._symbol._roots():
            vals = cache[id(r._base())]
            results.append(vals[min(r._out_index or 0, len(vals) - 1)]._data)
        return results, leaves

    def forward(self, is_train=False, **kwargs):
        """ref: executor.h Forward / graph_executor.cc:81.  Keyword arrays
        (NDArray or numpy) are copied into the bound arguments first."""
        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise TypeError("Unknown argument %s" % name)
            src = val._data if isinstance(val, NDArray) else \
                torch.from_numpy(np.ascontiguousarray(np.asarray(val)))
            with torch.no_grad():
                self.arg_dict[name]._data.copy_(src)
        record = bool(is_train) and any(
            self.grad_req.get(n, "null") != "null" for n in self._arg_names)
        state = None
        if self._draws(is_train):
            state = random_state.generator(
                self._ctx.torch_device()).get_state()
        with _profiler.op_span("Executor.forward(%s)" % (
                self._symbol.name or "sym"), "symbolic") or _profiler.NO_SPAN:
            outs, leaves = self._run(is_train, record, update_aux=True)
        self._last = (bool(is_train), state)
        self._graph = (outs, leaves) if record else None
        self.outputs = [NDArray(o.detach(), ctx=self._ctx) for o in outs]
        return self.outputs

    def _replay(self):
        """The last forward again, recorded, from the generator state it
        drew from; the auxiliary states are left as they are."""
        is_train, state = self._last
        if state is None:
            return self._run(is_train, True, update_aux=False)
        gen = torch.Generator(device=self._ctx.torch_device())
        gen.set_state(state)
        with random_state.use_generator(gen):
            return self._run(is_train, True, update_aux=False)

    def backward(self, out_grads=None, is_train=True):
        """ref: executor.h Backward: the gradients of the outputs (seeded by
        ``out_grads``, ones where none is given) into the bound grad
        arrays, written or added by ``grad_req``."""
        if self._last is None:
            raise MXNetError("backward called before forward")
        outs, leaves = self._graph if self._graph is not None \
            else self._replay()
        self._graph = None
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        heads, seeds = [], []
        for i, o in enumerate(outs):
            if not o.requires_grad:
                continue
            g = None if out_grads is None or i >= len(out_grads) \
                else out_grads[i]
            heads.append(o)
            seeds.append(autograd.head_seed(o) if g is None else
                         (g._data if isinstance(g, NDArray) else
                          torch.as_tensor(np.asarray(g))).to(o.device,
                                                             o.dtype))
        with _profiler.op_span("Executor.backward(%s)" % (
                self._symbol.name or "sym"), "symbolic") or _profiler.NO_SPAN:
            self._write_grads(heads, seeds, leaves, is_train)

    def _write_grads(self, heads, seeds, leaves, is_train):
        names = list(leaves)
        grads = [None] * len(names)
        if heads and names:
            with autograd._scope(recording=False, training=is_train):
                grads = torch.autograd.grad(heads, [leaves[n] for n in names],
                                            seeds, allow_unused=True)
        with torch.no_grad():
            for name, g in zip(names, grads):
                req = self.grad_req.get(name, "null")
                tgt = self.grad_dict.get(name)
                if req == "null" or tgt is None:
                    continue
                if req == "add":
                    if g is not None:
                        tgt._data.add_(g)
                elif g is None:
                    tgt._data.zero_()
                else:
                    tgt._data.copy_(g)

    # -- the rest of the surface -----------------------------------------
    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """Re-bind with new shapes (ref: executor.h Reshape): arrays whose
        shape holds are kept, the others are new zeros."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)

        def keep_or_new(cur, shape):
            if tuple(cur.shape) == tuple(shape):
                return cur
            return nd.zeros(shape, ctx=self._ctx, dtype=dtype_name(cur.dtype))
        new_args = {n: keep_or_new(self.arg_dict[n], s)
                    for n, s in zip(self._arg_names, arg_shapes)}
        new_aux = {n: keep_or_new(self.aux_dict[n], s)
                   for n, s in zip(self._aux_names, aux_shapes)}
        grads = None
        if self.grad_dict:
            grads = {n: nd.zeros(s, ctx=self._ctx,
                                 dtype=dtype_name(new_args[n].dtype))
                     for n, s in zip(self._arg_names, arg_shapes)
                     if self.grad_req.get(n, "null") != "null"}
        return Executor(self._symbol, self._ctx, new_args, grads,
                        self.grad_req, new_aux)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """ref: executor.py copy_params_from (NDArray or numpy values)."""
        for params, dst_of, what in ((arg_params, self.arg_dict, "arguments"),
                                     (aux_params or {}, self.aux_dict,
                                      "auxiliary states")):
            for name, array in params.items():
                if name in dst_of:
                    src = array._data if isinstance(array, NDArray) else \
                        torch.from_numpy(np.ascontiguousarray(array))
                    with torch.no_grad():
                        dst_of[name]._data.copy_(src)
                elif not allow_extra_params:
                    raise ValueError("Find name \"%s\" that is not in the %s"
                                     % (name, what))

    def set_monitor_callback(self, callback):
        """ref: MXExecutorSetMonitorCallback (graph_executor.cc:121):
        ``callback(name, array)`` for every node output."""
        self._monitor_callback = callback

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def debug_str(self):
        lines = ["Symbol outputs: %s" % ", ".join(self._symbol.list_outputs())]
        for node in self._symbol._topo():
            kind = "var" if node.is_variable() else node._op.name
            lines.append("%s %s <- %s" % (kind, node._name,
                                          [i._base()._name
                                           for i in node._inputs]))
        return "\n".join(lines)
