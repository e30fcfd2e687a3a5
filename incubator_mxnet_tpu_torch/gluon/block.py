"""Gluon Block / HybridBlock (counterpart of ``incubator_mxnet_tpu/gluon/block.py``).

Same prefix scoping (``_BlockScope``), child and parameter registration,
``collect_params``, ``initialize`` and ``cast`` as the JAX build, so a
model's parameter names match it one to one.  ``HybridBlock`` runs
``hybrid_forward(F, x, **params)`` eagerly with ``F`` the port's
``ndarray`` module and its parameters passed by name; ``hybridize()`` is
accepted and changes nothing yet (a general CachedOp is a later slice).
:func:`functionalize` (``HybridBlock.serving_fn``) gives the pure forward
``fn(param_vals, *inputs)`` the serving runtime captures per batch bucket.
Deferred parameter shapes are resolved layer by layer from the first
input, as in the JAX build (``_pre_infer``).  ``_trace_params`` installs
shadow arrays for a subtree's parameters (by name, thread-local), so a
trainer can run the forward on values it owns, such as bf16 casts of its
f32 master weights, without touching the Block's own arrays.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

from .. import autograd, random_state
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "functionalize"]


class _BlockScope(object):
    """Name/prefix scope for Blocks (ref: block.py class _BlockScope)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """Create prefix+params pair for the new Block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from ..name import NameManager
                prefix = NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        from ..name import Prefix
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


class Block(object):
    """Base class for all neural network layers (ref: block.py:123)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") else self._prefix
        self._scope = _BlockScope(self)
        self._children = []
        self._reg_params = {}

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join("  ({key}): {block}".format(key=key, block=block)
                           for key, block in self.__dict__.items()
                           if isinstance(block, Block))
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __setattr__(self, name, value):
        """Auto-register children and params (ref: block.py __setattr__)."""
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and not isinstance(value, type(existing)):
                raise TypeError("Changing attribute type for {name} from {type1} to {type2}"
                                "is not allowed.".format(name=name,
                                                         type1=type(existing),
                                                         type2=type(value)))
            if isinstance(existing, Block):
                for i, c in enumerate(self._children):
                    if c is existing:
                        self._children[i] = value
            elif isinstance(value, Block):
                self.register_child(value)
        elif isinstance(value, Block):
            self.register_child(value)
        if isinstance(value, Parameter):
            if name in self._reg_params and self._reg_params[name] is not value:
                raise ValueError(
                    "Overriding Parameter attribute %s is not allowed. If you "
                    "want to share parameters between blocks, please set "
                    "'params' at Block construction instead." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """ref: block.py name_scope."""
        return self._scope

    @property
    def params(self):
        """ParameterDict of this Block only (not children)."""
        return self._params

    def collect_params(self, select=None):
        """Recursively collect Parameters (ref: block.py collect_params)."""
        import re
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children:
            ret.update(cld.collect_params(select=select))
        return ret

    def save_params(self, filename):
        """Write the parameters as a ``.params`` file, names without this
        block's prefix (ref: block.py:295 save_params)."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Load a file :meth:`save_params` wrote into this block, whatever
        its prefix (ref: block.py:303 load_params)."""
        self.collect_params().load(filename, ctx, allow_missing, ignore_extra,
                                   self.prefix)

    def register_child(self, block):
        """ref: block.py register_child."""
        self._children.append(block)

    def initialize(self, init=None, ctx=None, force_reinit=False):
        """ref: block.py initialize."""
        self.collect_params().initialize(init, ctx, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Accepted for parity: the forward stays eager in this slice."""

    def cast(self, dtype):
        """ref: block.py cast."""
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block written as ``hybrid_forward(F, x, *, weight=..., ...)``
    (ref: block.py:376 HybridBlock), run eagerly."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._shadow_tls = threading.local()

    # shadows are per thread: another thread's forward on this block must
    # not see a trainer's values (ref: block.py:440-452)
    @property
    def _trace_shadows(self):
        return getattr(self._shadow_tls, "shadows", None)

    @_trace_shadows.setter
    def _trace_shadows(self, value):
        self._shadow_tls.shadows = value

    @contextmanager
    def _trace_params(self, shadows):
        """Run the subtree's forward on ``shadows`` ({parameter name:
        NDArray}) in place of the parameters' own arrays (ref: block.py:543
        _trace_params)."""
        stack, blocks = [self], []
        while stack:
            b = stack.pop()
            blocks.append(b)
            stack.extend(b._children)
        prev = [b._trace_shadows for b in blocks]
        for b in blocks:
            b._trace_shadows = shadows
        try:
            yield
        finally:
            for b, p in zip(blocks, prev):
                b._trace_shadows = p

    def _run_deferred_init(self, *args):
        """First-call shape resolution: one pass, nothing recorded, lets
        every layer of the subtree fill its deferred parameter shapes
        (ref: block.py:583)."""
        with autograd.pause():
            self.hybrid_forward_dispatch(*args)

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, "
                "but %s has type %s. If you are using Sequential, "
                "please try HybridSequential instead." % (
                    str(block), str(type(block))))
        super().register_child(block)

    def hybrid_forward_dispatch(self, *args):
        shadows = self._trace_shadows
        deferred = [p for p in self._reg_params.values()
                    if p._data is None and p._deferred_init]
        if deferred and (shadows is None or
                         any(p.name not in shadows for p in deferred)):
            # layer-local shape inference from the live input (the reference
            # resolves deferred shapes via symbolic infer_shape); a shape it
            # cannot fill makes _finish_deferred_init raise
            self._pre_infer(*args)
            for p in deferred:
                p._finish_deferred_init()
        params = {name: shadows[p.name] if shadows is not None
                  and p.name in shadows else p.data()
                  for name, p in self._reg_params.items()}
        from .. import ndarray as F
        return self.hybrid_forward(F, *args, **params)

    def _pre_infer(self, *args):
        """Fill deferred parameter shapes from the first input. Layers with
        in_units/in_channels==0 override this."""
        return

    def forward(self, x, *args):
        """Defines the forward computation (ref: block.py:561 forward)."""
        return self.hybrid_forward_dispatch(x, *args)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """Override to define the computation (ref: block.py hybrid_forward)."""
        raise NotImplementedError

    def serving_fn(self, *example_args, train=False):
        """The serving runtime's forward entry point (ref: block.py:593):
        ``(fn, param_vals)`` where ``fn(param_vals, *input_tensors)`` is the
        pure inference forward and ``param_vals`` the name → tensor weight
        snapshot the serving registry treats as its residency unit."""
        return functionalize(self, *example_args, train=train)


def _flatten_outputs(out):
    if isinstance(out, (list, tuple)):
        flat = []
        for o in out:
            flat.extend(_flatten_outputs(o))
        return flat
    return [out]


def functionalize(block, *example_args, train=False):
    """The pure forward of a HybridBlock (ref: block.py:646-700).

    Returns ``(fn, param_vals)``: ``fn(param_vals, *input_tensors, rng=None)``
    maps tensors to a tensor (or a tuple of tensors when the block returns
    several) by running ``hybrid_forward_dispatch`` with the block's
    parameters shadowed by ``param_vals`` ({full name: tensor}, the
    thread-local ``_trace_params``), recording off and ``train`` picking the
    training or inference mode.  ``param_vals`` holds the block's own
    tensors now.  ``example_args`` resolve deferred shapes with one pass.

    Random ops draw from ``rng``, a ``torch.Generator`` on the inputs'
    device; by default from generators seeded 0 afresh in every call (the
    JAX build's default key is fixed too), so a stochastic block must pass
    its own ``rng`` per call.
    """
    from ..ndarray import NDArray

    block(*[a if isinstance(a, NDArray) else NDArray(torch.as_tensor(a))
            for a in example_args])        # resolve deferred init
    param_vals = {name: p.data()._data
                  for name, p in block.collect_params().items()}

    def fn(param_vals, *input_vals, rng=None):
        shadows = {name: NDArray(v) for name, v in param_vals.items()}
        nd_in = [NDArray(v) for v in input_vals]
        with random_state.use_generator(0 if rng is None else rng), \
                autograd._scope(recording=False, training=train), \
                block._trace_params(shadows):
            out = block.hybrid_forward_dispatch(*nd_in)
        vals = tuple(o._data for o in _flatten_outputs(out))
        return vals[0] if len(vals) == 1 else vals

    return fn, param_vals
