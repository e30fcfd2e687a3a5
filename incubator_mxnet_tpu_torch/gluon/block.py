"""Gluon Block / HybridBlock (counterpart of ``incubator_mxnet_tpu/gluon/block.py``).

Same prefix scoping (``_BlockScope``), child and parameter registration,
``collect_params``, ``initialize`` and ``cast`` as the JAX build, so a
model's parameter names match it one to one.  ``HybridBlock`` runs
``hybrid_forward(F, x, **params)`` with ``F`` the port's ``ndarray``
module and its parameters passed by name.  After ``hybridize()`` a call
goes through the block's :class:`CachedOp`: one program per input
signature, captured as CUDA graphs on the card (forward, and under
``autograd.record()`` a backward that recomputes the forward), run op by
op on the CPU.  :func:`functionalize` (``HybridBlock.serving_fn``) gives
the same pure forward ``fn(param_vals, *inputs)``, which the serving
runtime captures per batch bucket.  Deferred parameter shapes are resolved
layer by layer from the first input, as in the JAX build (``_pre_infer``).
``_trace_params`` installs shadow arrays for a subtree's parameters (by
name, thread-local), so a trainer or a CachedOp runs the forward on values
it owns, such as bf16 casts of a trainer's f32 master weights, without
touching the Block's own arrays; a hybridized child under shadows is
inlined into the caller's program.
"""
from __future__ import annotations

import functools
import threading
import weakref
from contextlib import contextmanager

import numpy as np
import torch

from .. import autograd, engine as _engine, profiler as _profiler
from .. import random_state
from ..context import current_context
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp", "functionalize",
           "cached_op_stats", "reset_cached_op_stats"]


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


def _flatten(args, inout_str):
    """Flatten a nested list/tuple of NDArrays (ref: block.py _flatten):
    (the arrays, None for a None, and the nesting format)."""
    if isinstance(args, NDArray):
        return [args], int(0)
    if args is None:
        return [None], int(-1)
    if not isinstance(args, (list, tuple)):
        raise AssertionError(
            "HybridBlock %s must be (nested) list of NDArray, but got %s of "
            "type %s" % (inout_str, str(args), str(type(args))))
    flat = []
    fmts = []
    for i in args:
        arg, fmt = _flatten(i, inout_str)
        flat.extend(arg)
        fmts.append(fmt)
    return flat, fmts


def _regroup(args, fmt):
    """Inverse of :func:`_flatten` (ref: block.py _regroup)."""
    if isinstance(fmt, int):
        if fmt == -1:
            return None, args[1:]
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    ret = []
    for i in fmt:
        res, args = _regroup(args, i)
        ret.append(res)
    return ret, args


def _fmt_key(fmt):
    if isinstance(fmt, list):
        return tuple(_fmt_key(f) for f in fmt)
    return fmt


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
        """Activate (or, ``active=False``, deactivate) hybridization on
        every HybridBlock of the subtree (ref: block.py hybridize)."""
        for cld in self._children:
            cld.hybridize(active, **kwargs)

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


_STAT_KEYS = ("calls", "captures", "replays", "pieces", "split_ops",
              "backward_captures", "backward_replays", "eager_backwards")
_stats = dict.fromkeys(_STAT_KEYS, 0)


def cached_op_stats():
    """The CachedOps' counters since the last reset: ``calls``; on the
    card forward ``captures`` and ``replays``, the graph ``pieces``
    captured, the ``split_ops`` run eagerly between pieces,
    ``backward_captures`` and ``backward_replays``, and
    ``eager_backwards`` (on the CPU, under ``create_graph``, or of a
    program that splits)."""
    return dict(_stats)


def reset_cached_op_stats():
    for k in _STAT_KEYS:
        _stats[k] = 0


def _run_block(block, param_vals, args, rng, train, recording=False):
    """One functionalized forward: ``block.hybrid_forward_dispatch(*args)``
    with the subtree's parameters shadowed by ``param_vals`` ({full name:
    tensor}), drawing from ``rng`` (a generator or a seed,
    ``random_state.use_generator``), in training mode or not, recorded by
    autograd or not, and outside any open bulk segment.  Returns
    ``_flatten`` of its outputs."""
    shadows = {name: NDArray(v) for name, v in param_vals.items()}
    with random_state.use_generator(rng), \
            autograd._scope(recording=recording, training=train), \
            block._trace_params(shadows), _engine.offband():
        out = block.hybrid_forward_dispatch(*args)
    return _flatten(out, "output")


class _Entry(object):
    """One input signature of a CachedOp: its program over ``xs`` (the
    parameter tensors in name order, then the inputs that are not None),
    the output format, and what the first run showed: the parameters the
    forward writes in place (BatchNorm's moving statistics) and whether
    it draws random numbers."""

    def __init__(self, cop, in_fmt, template, real_idx, train):
        self.cop = cop
        self.in_fmt = in_fmt
        self.template = template        # the flat inputs, None where None
        self.real_idx = real_idx
        self.train = train
        self.out_fmt = None
        self.out_none = None
        self.mutated = None             # parameter slots written in place
        self.draws = None

    def run(self, xs, rng, recording=False):
        cop = self.cop
        n = len(cop._param_names)
        inputs = list(self.template)
        for j, i in enumerate(self.real_idx):
            inputs[i] = NDArray(xs[n + j])
        args, _ = _regroup(inputs, self.in_fmt)
        if not isinstance(args, list):
            args = [args]
        flat, fmt = _run_block(cop.block, dict(zip(cop._param_names, xs[:n])),
                               args, rng, self.train, recording)
        self.out_fmt = fmt
        self.out_none = [o is None for o in flat]
        return [o._data for o in flat if o is not None]

    def forward(self, rng, xs):
        with torch.no_grad():
            return self.run(xs, rng)


def _vjp(entry, xs, grad_slots, tied, grads, rng, create_graph=False):
    """The gradients with respect to ``xs[grad_slots]`` of the outputs
    ``tied`` seeded with ``grads``: the forward run again, recorded.  With
    ``create_graph`` the inputs are ``xs`` themselves and the gradients
    are recorded too."""
    xs = list(xs)
    if create_graph:
        leaves = [xs[s] for s in grad_slots]
    else:
        leaves = []
        for s in grad_slots:
            leaf = xs[s].detach().requires_grad_(True)
            xs[s] = leaf
            leaves.append(leaf)
    with torch.enable_grad():
        outs = entry.run(xs, rng, recording=True)
        pairs = [(outs[i], g) for i, g in zip(tied, grads)
                 if outs[i].requires_grad]
        got = [None] * len(leaves)
        if pairs:
            got = torch.autograd.grad([o for o, _ in pairs], leaves,
                                      [g for _, g in pairs],
                                      allow_unused=True,
                                      create_graph=create_graph)
    return [torch.zeros_like(leaf) if g is None else g
            for g, leaf in zip(got, leaves)]


def _vjp_program(entry, grad_slots, tied, n, rng, xs):
    return _vjp(entry, xs[:n], grad_slots, tied, xs[n:], rng)


class _Node(object):
    """What one recorded call's backward needs: the tensors it read (with
    their versions), copies of the parameters the forward wrote in place,
    the generator state it drew from."""

    def __init__(self, cop, entry, key, xs, versions, saved, grad_slots,
                 tied, gen_state, device):
        self.cop = cop
        self.entry = entry
        self.key = key
        self.xs = xs
        self.versions = versions
        self.saved = saved              # {slot: copy before the forward}
        self.grad_slots = grad_slots
        self.tied = tied
        self.gen_state = gen_state
        self.device = device
        self.values = None

    def backward(self, grads):
        for i, (t, ver) in enumerate(zip(self.xs, self.versions)):
            if i not in self.saved and t._version != ver:
                raise RuntimeError(
                    "one of the arrays the hybridized block %s read was "
                    "modified by an in-place operation after its forward "
                    "(version %d, recorded %d): its backward would read the "
                    "new values" % (self.cop.block.name, t._version, ver))
        xs = [self.saved.get(i, t) for i, t in enumerate(self.xs)]
        grads = [g.contiguous() for g in grads]
        entry, cop = self.entry, self.cop
        graph = cop._graphs.get(self.key)
        if self.device.type != "cuda" or torch.is_grad_enabled() or \
                graph is None or graph.split_ops:
            # the CPU, create_graph, or a program with ops that cannot be
            # captured
            _stats["eager_backwards"] += 1
            return _vjp(entry, xs, self.grad_slots, self.tied, grads,
                        self._generator(), torch.is_grad_enabled())
        key = (self.key, tuple(self.grad_slots), tuple(self.tied))
        with _engine.pool_order(self.device):
            gen = cop._bwd_gens.get(key)
            if gen is None and self.gen_state is not None:
                gen = cop._bwd_gens[key] = torch.Generator(device=self.device)
            if gen is not None:
                gen.set_state(self.gen_state)
            n = len(xs)
            owned = sorted(self.saved) + list(range(len(cop._param_names), n))
            results, captured = _engine._run_cuda(
                cop._bwd_graphs, key,
                functools.partial(_vjp_program, entry, self.grad_slots,
                                  self.tied, n, 0 if gen is None else gen),
                [t.detach() for t in xs] + grads, [gen], self.device,
                owned=owned + list(range(n, n + len(grads))),
                what="the backward of CachedOp(%s)" % cop.block.name)
        _stats["backward_captures" if captured else "backward_replays"] += 1
        return results

    def _generator(self):
        if self.gen_state is None:
            return 0
        gen = torch.Generator(device=self.device)
        gen.set_state(self.gen_state)
        return gen


class _CachedOpFunction(torch.autograd.Function):
    """The tape node of one recorded call: its forward hands out the run's
    values, its backward is :meth:`_Node.backward`."""

    @staticmethod
    def forward(ctx, node, *inputs):
        ctx.node = node
        values, node.values = node.values, None
        return tuple(values)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(ctx.node.backward(grads))


_CACHED_OPS = weakref.WeakSet()


@_engine.on_dropped_generators
def _forget_generators(dead):
    for cop in list(_CACHED_OPS):
        cop._forget(dead)


class CachedOp(object):
    """The program of a hybridized block (ref: src/imperative/cached_op.cc;
    the JAX build's ``CachedOp``, block.py:265-399, a jit of the same
    forward).

    The cache key is the input shapes, dtypes and strides, the parameters'
    likewise, the input nesting, the training flag, the device, the
    generator drawn from and the engine's math flags (deterministic
    algorithms, TF32).  On the card a key's first call runs the forward
    eagerly on the engine's side stream and captures it
    (``engine._run_cuda``: the parameters are borrowed slots, read where
    they lie, so an optimizer's in-place update is seen; the inputs are
    owned slots; the outputs are cloned out of the pool; the framework
    generator is registered with the graph, so a replay draws fresh
    numbers exactly as an eager call would).  Later calls replay.  An op
    registered ``deferrable=False`` splits the capture: the graphs before
    and after it replay, the op runs eagerly between them.  On the CPU a
    call runs the same program op by op.

    Under ``autograd.record()`` a call is one tape node
    (:class:`_CachedOpFunction`) whose backward runs the forward again
    under grad and takes the gradients: on the card a second graph per
    key, drawing from a generator set to the state the forward drew from,
    with the parameters the forward wrote in place (BatchNorm's moving
    statistics) replaced by copies taken before it, so nothing is blended
    twice.  A ``create_graph`` backward, and the backward of a program
    that splits, recompute eagerly.  Every capture and replay, of any
    CachedOp or bulk segment, is ordered by the engine's
    :func:`~incubator_mxnet_tpu_torch.engine.pool_order`, since their
    graphs share one memory pool."""

    def __init__(self, block):
        self.block = block
        # the parameter set changes only by a structural change, which
        # makes a fresh CachedOp (_clear_cached_op)
        self._params = block._active_params
        self._param_names = sorted(self._params)
        self._entries = {}
        self._graphs = {}
        self._bwd_graphs = {}
        self._bwd_gens = {}
        _CACHED_OPS.add(self)

    def _forget(self, dead):
        """Drop every entry, graph and backward generator that holds a
        generator of ``dead`` (ids of generators a failed capture left
        unusable): the next call keys on the fresh generator and captures
        anew."""
        # a key's sixth field is its generator's id (__call__)
        for key in [k for k in self._entries if k[5] in dead]:
            del self._entries[key]
        for graphs in (self._graphs, self._bwd_graphs):
            for key, graph in list(graphs.items()):
                if not dead.isdisjoint(map(id, graph.gens)):
                    graphs.pop(key).release()
        for key, gen in list(self._bwd_gens.items()):
            if id(gen) in dead:
                del self._bwd_gens[key]

    def _param_tensors(self):
        vals = []
        for name in self._param_names:
            p = self._params[name]
            if p._data is None:
                if not p._deferred_init or not p.shape or \
                        np.prod(p.shape) <= 0:
                    # unresolved deferred shape (or not initialized):
                    # p.data() raises the right error, and forward() runs
                    # the eager shape pass on DeferredInitializationError
                    p.data()
                p._finish_deferred_init()
            vals.append(p.data()._data)
        return vals

    def __call__(self, *args):
        block = self.block
        flat_args, in_fmt = _flatten(args, "input")
        if _engine.in_bulk():
            _engine.flush(cause="read")
        params = self._param_tensors()
        inputs = [None if a is None else a._data for a in flat_args]
        real_idx = [i for i, v in enumerate(inputs) if v is not None]
        train = autograd.is_training()
        recording = autograd.is_recording()
        ref = inputs[real_idx[0]] if real_idx else (
            params[0] if params else None)
        device = ref.device if ref is not None else \
            current_context().torch_device()
        ctx = flat_args[real_idx[0]].context if real_idx else (
            self._params[self._param_names[0]].data().context if params
            else current_context())
        gen = random_state.generator(device)
        key = (tuple(None if v is None else (tuple(v.shape), v.dtype,
                                              v.stride()) for v in inputs),
               tuple((tuple(v.shape), v.dtype, v.stride()) for v in params),
               _fmt_key(in_fmt), train, device, id(gen), _engine._math_flags())
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(
                self, in_fmt, [None] * len(inputs), real_idx, train)
        xs = params + [inputs[i] for i in real_idx]
        n = len(params)
        grad_slots = [i for i, t in enumerate(xs) if t.requires_grad
                      and t.is_floating_point()] if recording else []
        saved = {}
        if grad_slots:
            # copies of what the forward writes in place: the recompute
            # reads them as the forward did and writes only them
            slots = entry.mutated if entry.mutated is not None else [
                i for i in range(n) if not xs[i].requires_grad]
            saved = {i: xs[i].detach().clone() for i in slots}
            versions = [t._version for t in xs]
        first = entry.mutated is None
        if first:
            before = [t._version for t in params]
            state0 = gen.get_state()
        gen_state = gen.get_state() if grad_slots and entry.draws is not False \
            else None
        _stats["calls"] += 1
        with _profiler.op_span("CachedOp(%s)" % block.name) or \
                _profiler.NO_SPAN:
            if device.type == "cuda":
                # the generator joins the graph only if the first run drew
                # from it; a failed capture replaces a registered generator
                # (engine.drop_generators, then _forget below)
                results, captured = _engine._run_cuda(
                    self._graphs, key, functools.partial(entry.forward, gen),
                    [t.detach() for t in xs],
                    lambda: [] if torch.equal(state0, gen.get_state())
                    else [gen], device, owned=range(n, len(xs)),
                    what="CachedOp(%s)" % block.name)
                graph = self._graphs[key]
                if captured:
                    _stats["captures"] += 1
                    _stats["pieces"] += graph.pieces
                else:
                    _stats["replays"] += 1
                _stats["split_ops"] += graph.split_ops
            else:
                results = entry.forward(gen, [t.detach() for t in xs])
        if first:
            entry.mutated = [i for i, (t, v) in enumerate(zip(params, before))
                             if t._version != v]
            entry.draws = not torch.equal(state0, gen.get_state())
            if not entry.draws:
                gen_state = None
            saved = {i: c for i, c in saved.items() if i in entry.mutated}
        if grad_slots:
            tied = [i for i, t in enumerate(results) if t.is_floating_point()]
            if tied:
                node = _Node(self, entry, key, xs, versions, saved,
                             grad_slots, tied, gen_state, device)
                node.values = [results[i] for i in tied]
                with torch.enable_grad():
                    got = _CachedOpFunction.apply(
                        node, *[xs[s] for s in grad_slots])
                results = list(results)
                for i, t in zip(tied, got):
                    results[i] = t
        outs = iter(results)
        flat = [None if none else NDArray(next(outs), ctx=ctx)
                for none in entry.out_none]
        out, _ = _regroup(flat, entry.out_fmt)
        return out


class HybridBlock(Block):
    """Block written as ``hybrid_forward(F, x, *, weight=..., ...)``
    (ref: block.py:376 HybridBlock): eager until ``hybridize()``, then
    through its :class:`CachedOp`."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._shadow_tls = threading.local()

    # shadows are per thread: another thread's forward on this block must
    # not see a trainer's values (ref: block.py:440-452)
    @property
    def _trace_shadows(self):
        return getattr(self._shadow_tls, "shadows", None)

    @_trace_shadows.setter
    def _trace_shadows(self, value):
        self._shadow_tls.shadows = value

    @property
    def _active_params(self):
        """name → Parameter used by this block subtree's forward."""
        return dict(self.collect_params().items())

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, (HybridBlock, Parameter)):
            # a new child or Parameter changes the program
            self._clear_cached_op()

    def _clear_cached_op(self):
        self._cached_op = None

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
        """First-call shape resolution: one eager pass, nothing recorded,
        lets every layer of the subtree fill its deferred parameter shapes
        (ref: block.py:583); empty shadows keep hybridized children out of
        their CachedOps."""
        with autograd.pause(), self._trace_params({}):
            self.hybrid_forward_dispatch(*args)

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, "
                "but %s has type %s. If you are using Sequential, "
                "please try HybridSequential instead." % (
                    str(block), str(type(block))))
        super().register_child(block)
        self._clear_cached_op()

    def hybridize(self, active=True, **kwargs):
        """ref: block.py hybridize: later calls run through a fresh
        :class:`CachedOp`."""
        self._active = active
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def infer_shape(self, *args):
        """Resolve the deferred parameter shapes from ``args``: one eager
        pass, nothing recorded (ref: block.py infer_shape)."""
        self._run_deferred_init(*args)

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
        """Defines the forward computation (ref: block.py:561 forward):
        inlined into the caller's program under shadows, through the
        CachedOp once hybridized, else eager."""
        if self._trace_shadows is not None:
            return self.hybrid_forward_dispatch(x, *args)
        if self._active:
            if self._cached_op is None:
                self._cached_op = CachedOp(self)
            try:
                return self._cached_op(x, *args)
            except DeferredInitializationError:
                self._run_deferred_init(x, *args)
                return self._cached_op(x, *args)
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


class SymbolBlock(HybridBlock):
    """A HybridBlock from a Symbol (ref: block.py:599 SymbolBlock; the JAX
    build's block.py:605-645): the symbol's arguments other than
    ``inputs`` become the block's parameters (its auxiliary states with
    ``grad_req='null'``), and the forward evaluates the graph through the
    same fcomputes as ``nd`` (``Symbol.eval_dict``).  Parameter shapes the
    initializer left open are inferred from the first input's
    (``Symbol.infer_shape``)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        from ..symbol import Symbol
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if not isinstance(outputs, Symbol):
            raise TypeError("outputs must be a Symbol")
        syms = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self._in_names = [s.name for s in syms]
        self._sym = outputs
        for n in outputs.list_arguments():
            if n not in self._in_names:
                self.params.get(self._short(n), allow_deferred_init=True,
                                grad_req="write")
        for n in outputs.list_auxiliary_states():
            self.params.get(self._short(n), allow_deferred_init=True,
                            grad_req="null")

    def _short(self, name):
        prefix = self.params.prefix
        return name[len(prefix):] if name.startswith(prefix) else name

    def hybrid_forward_dispatch(self, *args):
        shadows = self._trace_shadows
        deferred = [p for p in self.params.values()
                    if p._data is None and p._deferred_init]
        if deferred:
            arg_shapes, _, aux_shapes = self._sym.infer_shape(
                **{n: a.shape for n, a in zip(self._in_names, args)})
            shapes = dict(zip(self._sym.list_arguments(), arg_shapes))
            shapes.update(zip(self._sym.list_auxiliary_states(), aux_shapes))
            for p in deferred:
                p.shape = tuple(shapes[self._short(p.name)])
                p._finish_deferred_init()
        values = {self._short(name): shadows[name]
                  if shadows is not None and name in shadows else p.data()
                  for name, p in self.params.items()}
        values.update(zip(self._in_names, args))
        return self._sym.eval_dict(values)

    def forward(self, *args):
        """The graph evaluated eagerly, hybridized or not (the JAX build's
        SymbolBlock.forward)."""
        return self.hybrid_forward_dispatch(*args)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError


def functionalize(block, *example_args, train=False):
    """The pure forward of a HybridBlock (ref: block.py:646-700).

    Returns ``(fn, param_vals)``: ``fn(param_vals, *input_tensors, rng=None)``
    maps tensors to a tensor (or a tuple of tensors when the block returns
    several) by running ``hybrid_forward_dispatch`` with the block's
    parameters shadowed by ``param_vals`` ({full name: tensor}, the
    thread-local ``_trace_params``), recording off and ``train`` picking the
    training or inference mode.  ``param_vals`` holds the block's own
    tensors now.  ``example_args`` resolve deferred shapes with one
    eager pass in predict mode (never through the block's CachedOp).
    The CachedOp runs this same functionalization (``_run_block``).

    Random ops draw from ``rng``, a ``torch.Generator`` on the inputs'
    device; by default from generators seeded 0 afresh in every call (the
    JAX build's default key is fixed too), so a stochastic block must pass
    its own ``rng`` per call.
    """
    block._run_deferred_init(*[
        a if isinstance(a, NDArray) else NDArray(torch.as_tensor(a))
        for a in example_args])
    param_vals = {name: p.data()._data
                  for name, p in block.collect_params().items()}

    def fn(param_vals, *input_vals, rng=None):
        flat, _ = _run_block(block, param_vals,
                             [NDArray(v) for v in input_vals],
                             0 if rng is None else rng, train)
        vals = tuple(o._data for o in flat)
        return vals[0] if len(vals) == 1 else vals

    return fn, param_vals
