"""Serving model loaders: where model weights become a pure forward.

Counterpart of ``incubator_mxnet_tpu/serving/loader.py``.  Every serving
source funnels to the same ``(fn, param_vals, input_names)`` triple:

* ``fn(param_vals, *input_tensors)`` — a pure function of tensors, run by
  the registry as one program per (model, weight version, batch bucket):
  a CUDA graph on the card, the eager function on the CPU;
* ``param_vals`` — name → tensor, the weight-residency unit the registry
  budgets, evicts and hot-swaps;
* ``input_names`` — positional input order of ``fn``.

This slice ports the HybridBlock source (``block_model``, through
``HybridBlock.serving_fn``) and ``load_params_bytes``, which parses
``.params`` bytes in memory (``nd.load_buffer``) for a block to load.  The
``module=``, ``symbol=`` and ``symbol_json=`` sources need the symbolic
executor (ROADMAP item 5) and raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ndarray.ndarray import narrow_dtype

__all__ = ["split_arg_aux", "load_params_bytes", "symbol_model",
           "block_model", "module_model", "bytes_model", "model_device"]


def split_arg_aux(loaded):
    """Split an ``nd.load``/``nd.load_buffer`` dict into (arg_params,
    aux_params), honoring the optional ``arg:``/``aux:`` name prefixes
    (ref: python/mxnet/model.py load_checkpoint)."""
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def load_params_bytes(param_bytes):
    """``.params`` bytes -> (arg_params, aux_params) name -> NDArray dicts,
    parsed in memory (``nd.load_buffer``, no temporary file), on the
    current context."""
    from ..ndarray import load_buffer
    loaded = load_buffer(param_bytes)
    if not isinstance(loaded, dict):
        raise ValueError("serving params must be a named .params payload "
                         "(got an unnamed array list)")
    return split_arg_aux(loaded)


def _raw(v):
    """NDArray / tensor / numpy value → tensor (numpy 64-bit narrowed, as
    the JAX build's ``jnp.asarray``; a host copy, never a view of ``v``)."""
    from ..ndarray import NDArray
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    return torch.from_numpy(np.array(a, dtype=narrow_dtype(a.dtype)))


def _block_context(block):
    """The context of the block's first initialized (or deferred)
    parameter, else the current one."""
    from ..context import current_context
    for p in block.collect_params().values():
        if p._data is not None or p._deferred_init:
            return p.list_ctx()[0]
    return current_context()


def model_device(block, example):
    """Where a block is served: its first parameter's device, else (a block
    without parameters) its example's."""
    from ..ndarray import NDArray
    for p in block.collect_params().values():
        if p._data is not None:
            return p.data()._data.device
    ex = example[0] if isinstance(example, (list, tuple)) else example
    if isinstance(ex, NDArray):
        return ex._data.device
    return _block_context(block).torch_device()


def block_model(block, example, train=False):
    """A HybridBlock: its functionalized forward
    (``HybridBlock.serving_fn``).  ``example`` is one example input (or a
    tuple of inputs) with its batch axis, used to resolve deferred shapes;
    a host value goes to the block's context.  Returns ``(fn, param_vals,
    input_names)`` — fn takes the inputs positionally."""
    from ..ndarray import NDArray
    if not isinstance(example, (list, tuple)):
        example = (example,)
    ctx = _block_context(block)
    example = [e if isinstance(e, NDArray) else NDArray(_raw(e).to(
        ctx.torch_device()), ctx=ctx) for e in example]
    fn, param_vals = block.serving_fn(*example, train=train)
    input_names = ["input%d" % i for i in range(len(example))]
    return fn, param_vals, input_names


def _not_ported(source, item):
    raise NotImplementedError(
        "serving from %s needs %s, which the PyTorch port does not have yet "
        "(ROADMAP item 5); serve a HybridBlock with block= instead"
        % (source, item))


def symbol_model(sym, params, input_shapes=None, input_names=None):
    _not_ported("a Symbol", "the symbolic executor")


def bytes_model(symbol_json, param_bytes, input_shapes):
    _not_ported("symbol JSON and .params bytes", "the symbolic executor")


def module_model(module):
    _not_ported("a Module", "Module.serving_fn")
