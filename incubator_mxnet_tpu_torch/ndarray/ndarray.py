"""NDArray: MXNet's mutable n-dimensional array over a ``torch.Tensor``.

Counterpart of ``incubator_mxnet_tpu/ndarray/ndarray.py``.  There the
array is an immutable XLA buffer plus a version counter, and views are
(base, offset, shape) triples that write through by scatter.  Here the
tensor is mutable, so a view is a torch view: basic indexing and
``reshape`` share storage with the base and write through to it.  Op
results never alias their inputs (``invoke`` copies a view an op returns).

Work is asynchronous on a CUDA context as on the TPU: ``asnumpy`` is the
sync point, and ``waitall`` maps to ``torch.cuda.synchronize``.  The JAX
build's engine bulking and its tsan, lens and compile-safety hooks are not
part of this slice.

Autograd is torch's (see ``autograd``): ``invoke`` runs an op with torch's
grad mode on only under ``autograd.record()``, and every in-place write
into an array runs outside it where torch would refuse it, that is into
an array with an attached gradient (``x[:] = ...``, ``out=``, ``copyto``,
the update ops' ``out=W``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd, random_state
from ..base import MXNetError, numpy_dtype, torch_dtype
from ..context import Context, current_context
from ..ops.registry import Operator, get_op
from ..ops.tensor import checked_reshape

__all__ = ["NDArray", "array", "empty", "invoke", "waitall", "concatenate",
           "moveaxis"]

_SCALARS = (int, float, bool, np.generic)


def _write_mode(dst: torch.Tensor):
    """Grad mode for an in-place write into ``dst``: recorded under
    ``record()``, except into a tensor autograd tracks as a leaf (or a view
    of one), which torch refuses to write in grad mode."""
    base = dst if dst._base is None else dst._base
    tracked_leaf = base.requires_grad and base.grad_fn is None
    return torch.set_grad_enabled(autograd.is_recording() and not tracked_leaf)


def _write(dst: torch.Tensor, src):
    with _write_mode(dst):
        if isinstance(src, torch.Tensor):
            dst.copy_(src)
        else:
            dst.fill_(src)


class NDArray:
    """Mutable array handle (parity: python/mxnet/ndarray/ndarray.py NDArray)."""

    __array_priority__ = 1000.0  # beat numpy in mixed expressions

    _grad = None
    _grad_req = "null"

    def __init__(self, data: torch.Tensor, ctx=None):
        self._data = data
        self._ctx = ctx if ctx is not None else Context.from_torch_device(
            data.device)

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        """numpy dtype of the array; ``torch.bfloat16`` for bfloat16."""
        return numpy_dtype(self._data.dtype)

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def stype(self):
        """Storage type: always ``'default'`` (dense); sparse storage is
        ROADMAP item 10."""
        return "default"

    @property
    def T(self):
        """The transpose (every axis reversed), a new array."""
        return invoke(get_op("transpose"), [self], {})

    # -- conversion --------------------------------------------------------
    def asnumpy(self):
        """Host copy; blocks.  bfloat16 arrays come back as float32, which
        holds every bfloat16 value exactly (numpy has no bfloat16)."""
        t = self._data.detach()
        if t.dtype is torch.bfloat16:
            t = t.to(torch.float32)
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def astype(self, dtype, copy=True):
        return invoke(get_op("Cast"), [self], {"dtype": dtype})

    def copy(self):
        """A new array with the same values (ref: ndarray.py copy)."""
        return invoke(get_op("_copy"), [self], {})

    def as_in_context(self, context):
        """This array if it lives on ``context``, else a copy there."""
        return self if context == self._ctx else self.copyto(context)

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        """``'default'`` gives this array; sparse storage types raise until
        ROADMAP item 10 ports them."""
        if stype == "default":
            return self
        raise MXNetError("storage type %r is not ported yet: sparse arrays "
                         "come with ROADMAP item 10" % (stype,))

    def copyto(self, other):
        """ref: ndarray.py copyto / CopyFromTo (src/ndarray/ndarray.cc)."""
        if isinstance(other, NDArray):
            _write(other._data, self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device(), copy=True),
                           ctx=other)
        raise TypeError("copyto does not support type %s" % type(other))

    def detach(self):
        """The same values, cut from the recorded graph (ref: ndarray.h:523
        Detach)."""
        return NDArray(self._data.detach(), ctx=self._ctx)

    # -- autograd ----------------------------------------------------------
    @property
    def grad(self):
        """The grad buffer ``attach_grad`` made, or ``None``."""
        return self._grad

    def attach_grad(self, grad_req="write", stype=None):
        """A zero grad buffer, filled by ``backward`` by ``grad_req``
        (``write``, ``add`` or ``null``) (ref: ndarray.py attach_grad →
        MarkVariables)."""
        grad = NDArray(torch.zeros_like(self._data.detach()), ctx=self._ctx)
        autograd.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Backpropagate from this array; ``out_grad`` defaults to ones
        (ref: ndarray.py backward)."""
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- sync --------------------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    def wait_to_write(self):
        self.wait_to_read()

    # -- shape manipulation (views) ---------------------------------------
    def reshape(self, *shape, **kwargs):
        """A view sharing storage where the layout allows one (every array
        an op returns is contiguous), else a copy (ref: ndarray.h Reshape)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        new_shape = checked_reshape(self.shape, shape,
                                    kwargs.get("reverse", False))
        return NDArray(self._tracked().reshape(new_shape), ctx=self._ctx)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        """A view with a new axis of size 1 at ``axis``."""
        shape = list(self.shape)
        shape.insert(axis if axis >= 0 else axis + self.ndim + 1, 1)
        return self.reshape(tuple(shape))

    def flatten(self):
        return invoke(get_op("Flatten"), [self], {})

    def slice(self, start, stop):
        """A view of rows [start, stop) of axis 0 (ref: NDArray::Slice)."""
        n = self.shape[0]
        b = 0 if start is None else (start + n if start < 0 else start)
        e = n if stop is None else (stop + n if stop < 0 else min(stop, n))
        if not 0 <= b <= e <= n:
            raise IndexError("slice [%s:%s) out of range for axis size %d"
                             % (start, stop, n))
        return NDArray(self._tracked()[b:e], ctx=self._ctx)

    def at(self, idx):
        """A view of row ``idx`` of axis 0, the axis dropped (a 1-d array
        gives shape (1,)) (ref: NDArray::At)."""
        n = self.shape[0]
        j = idx + n if idx < 0 else idx
        if not 0 <= j < n:
            raise IndexError("index %d is out of bounds for axis 0 with size "
                             "%d" % (idx, n))
        t = self._tracked()
        return NDArray(t[j] if self.ndim > 1 else t[j:j + 1], ctx=self._ctx)

    def _tracked(self):
        """The tensor to view: with its autograd history under ``record()``,
        else detached (same storage and version counter, no graph)."""
        return self._data if autograd.is_recording() else self._data.detach()

    # -- indexing ----------------------------------------------------------
    def _key(self, key):
        if isinstance(key, NDArray):
            return key._data.to(torch.int64)
        if isinstance(key, (list, np.ndarray)):
            return torch.as_tensor(np.asarray(key, np.int64),
                                   device=self._data.device)
        if isinstance(key, tuple):
            return tuple(self._key(k) for k in key)
        return key

    def __getitem__(self, key):
        """Basic indexing (ints, slices, ``None``, ``...``) returns a view
        that writes through to this array; indexing by arrays copies."""
        return NDArray(self._tracked()[self._key(key)], ctx=self._ctx)

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, _SCALARS):
            value = torch.as_tensor(np.asarray(value), device=self._data.device)
        if isinstance(key, slice) and key == slice(None):
            _write(self._data, value.expand(self._data.shape)
                   if isinstance(value, torch.Tensor) else value)
            return
        with _write_mode(self._data):
            self._data[self._key(key)] = value

    # -- python protocol ---------------------------------------------------
    def __len__(self):
        return self._data.shape[0]

    def __repr__(self):
        shape_info = "x".join(str(s) for s in self.shape)
        return "\n%s\n<%s %s @%s>" % (self.asnumpy(), type(self).__name__,
                                      shape_info, self._ctx)

    # -- arithmetic --------------------------------------------------------
    def _binop(self, other, op_name, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(get_op(op_name), [a, b], {})
        if isinstance(other, _SCALARS):
            return invoke(get_op(scalar_op), [self], {"scalar": other})
        if isinstance(other, np.ndarray):
            o = array(other, ctx=self._ctx)
            a, b = (o, self) if reverse else (self, o)
            return invoke(get_op(op_name), [a, b], {})
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        if isinstance(o, _SCALARS):
            return invoke(get_op("_rminus_scalar"), [self], {"scalar": o})
        return self._binop(o, "broadcast_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        if isinstance(o, _SCALARS):
            return invoke(get_op("_rdiv_scalar"), [self], {"scalar": o})
        return self._binop(o, "broadcast_div", "_div_scalar", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        if isinstance(o, _SCALARS):
            return invoke(get_op("_rmod_scalar"), [self], {"scalar": o})
        return self._binop(o, "broadcast_mod", "_mod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        if isinstance(o, _SCALARS):
            return invoke(get_op("_rpower_scalar"), [self], {"scalar": o})
        return self._binop(o, "broadcast_power", "_power_scalar",
                           reverse=True)

    def __neg__(self):
        return invoke(get_op("negative"), [self], {})

    def __abs__(self):
        return invoke(get_op("abs"), [self], {})

    # comparisons give 0/1 arrays in this array's dtype, as the JAX build's
    # (ndarray.py:569-591); ``== None`` is False and ``!= None`` True
    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __bool__(self):
        """The value of a one-element array; more elements raise, so a
        comparison's result in an ``if`` is never silently true."""
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    # the identity hash, as the JAX build keeps beside its __eq__
    __hash__ = object.__hash__

    def _inplace(self, other, op_name, scalar_op):
        res = self._binop(other, op_name, scalar_op)
        if res is NotImplemented:
            return NotImplemented
        _write(self._data, res._data)
        return self

    def __iadd__(self, o):
        return self._inplace(o, "broadcast_add", "_plus_scalar")

    def __isub__(self, o):
        return self._inplace(o, "broadcast_sub", "_minus_scalar")

    def __imul__(self, o):
        return self._inplace(o, "broadcast_mul", "_mul_scalar")

    def __itruediv__(self, o):
        return self._inplace(o, "broadcast_div", "_div_scalar")

    # the reference's method surface over the registered ops
    def _reduction(self, name, axis, keepdims, **params):
        return invoke(get_op(name), [self],
                      dict(params, axis=axis, keepdims=keepdims))

    def sum(self, axis=None, keepdims=False, exclude=False):
        return self._reduction("sum", axis, keepdims, exclude=exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return self._reduction("mean", axis, keepdims, exclude=exclude)

    def max(self, axis=None, keepdims=False, exclude=False):
        return self._reduction("max", axis, keepdims, exclude=exclude)

    def min(self, axis=None, keepdims=False, exclude=False):
        return self._reduction("min", axis, keepdims, exclude=exclude)

    def argmax(self, axis=None, keepdims=False):
        return self._reduction("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduction("argmin", axis, keepdims)

    def abs(self):
        return invoke(get_op("abs"), [self], {})

    def square(self):
        return invoke(get_op("square"), [self], {})

    def sqrt(self):
        return invoke(get_op("sqrt"), [self], {})

    def exp(self):
        return invoke(get_op("exp"), [self], {})

    def log(self):
        return invoke(get_op("log"), [self], {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke(get_op("transpose"), [self], {"axes": axes})

    def clip(self, a_min, a_max):
        return invoke(get_op("clip"), [self], {"a_min": a_min,
                                               "a_max": a_max})



# ---------------------------------------------------------------------------
# eager op invocation (the imperative runtime; ref: src/imperative/imperative.cc)
# ---------------------------------------------------------------------------

def _aliases(t, inputs):
    ptr = t.untyped_storage().data_ptr()
    return any(ptr == x.untyped_storage().data_ptr() for x in inputs)


def invoke(op: Operator, inputs, params, out=None):
    """Eager dispatch of one operator — Imperative::Invoke reborn.

    inputs: list[NDArray]; params: dict of static attributes (``ctx`` picks
    the device of a creation op).  Torch's grad mode is on only under
    ``autograd.record()``, so only a recorded call builds a graph.  Outputs
    that alias an input are copied; an update op writes its state outputs
    back into the inputs it mutates; ``out=`` stores the visible result
    into the given array(s).  An op that ``takes_is_train`` gets
    ``is_train = autograd.is_training()``; the op's ``visible_outputs``
    decides how many outputs the call returns; an op that ``needs_rng``
    gets ``generator``, the framework generator of its output's device (the
    inputs', or ``ctx``'s for an op without inputs)."""
    params = {k: v for k, v in params.items() if v is not None or k == "axis"}
    ctx = params.pop("ctx", None)
    params.pop("name", None)
    recording = autograd.is_recording() and op.differentiable
    vals = [a._data.detach() if recording and i in op.nograd_inputs
            else a._data for i, a in enumerate(inputs)]
    if op.num_inputs == 0:
        ctx = Context(ctx) if ctx is not None else current_context()
        params["device"] = ctx.torch_device()
    is_train = autograd.is_training()
    kw = dict(params)
    if op.takes_is_train:
        kw["is_train"] = is_train
    if op.needs_rng:
        kw["generator"] = random_state.generator(
            vals[0].device if vals else params["device"]) \
            if op.draws(params, is_train) else None
    with torch.set_grad_enabled(recording):
        res = op.fcompute(*vals, **kw)
        res = res if isinstance(res, tuple) else (res,)
        res = tuple(r.clone(memory_format=torch.contiguous_format)
                    if _aliases(r, vals) else r for r in res)
    for j, idx in enumerate(op.mutate_inputs[1:]):
        _write(inputs[idx]._data, res[j + 1])
    res = res[:op.visible_outputs(params, len(res))]
    if out is not None:
        targets = [out] if isinstance(out, NDArray) else list(out)
        for t, r in zip(targets, res):
            _write(t._data, r)
        return targets[0] if len(targets) == 1 else targets
    outs = [NDArray(r) for r in res]
    return outs[0] if len(outs) == 1 else outs


def imperative_invoke(op_name, *inputs, out=None, **params):
    """String-name invoke (parity with MXImperativeInvoke, c_api_ndarray.cc:117)."""
    return invoke(get_op(op_name), list(inputs), params, out=out)


# ---------------------------------------------------------------------------
# creation & utilities (parity: python/mxnet/ndarray/utils.py + ndarray.py)
# ---------------------------------------------------------------------------

# the JAX build runs without x64: 64-bit numpy input narrows to 32 bits
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def narrow_dtype(dtype):
    """The dtype a host array of ``dtype`` takes on a device (float64,
    int64 and uint64 become their 32-bit kinds, as ``jnp.asarray`` stores
    them)."""
    dtype = np.dtype(dtype)
    return np.dtype(_NARROW.get(dtype, dtype))


def array(source_array, ctx=None, dtype=None):
    """ref: python/mxnet/ndarray/utils.py array.  float64, int64 and uint64
    numpy input become float32, int32 and uint32, as in the JAX build
    without x64 (an explicit ``dtype`` is kept)."""
    if isinstance(source_array, NDArray):
        src = source_array.asnumpy()
        if dtype is None:
            dtype = source_array.dtype
    elif isinstance(source_array, np.ndarray):
        src = source_array
        if dtype is None:
            dtype = narrow_dtype(src.dtype)
    else:
        # python lists/scalars default to float32, like the reference
        src = np.asarray(source_array)
        if dtype is None:
            dtype = np.float32 if src.dtype.kind in "fiub" else src.dtype
    ctx = ctx if ctx is not None else current_context()
    device = ctx.torch_device()
    src = np.ascontiguousarray(src)
    if not src.flags.writeable:     # torch.from_numpy warns on read-only
        src = src.copy()
    t = torch.from_numpy(src)
    return NDArray(t.to(device=device, dtype=torch_dtype(dtype), copy=True),
                   ctx=ctx)


def empty(shape, ctx=None, dtype="float32"):
    """A new array; zero-filled, as in the JAX build."""
    ctx = ctx if ctx is not None else current_context()
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype),
                               device=ctx.torch_device()), ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    """ref: ndarray.py concatenate (the Concat op along ``axis``)."""
    return invoke(get_op("Concat"), list(arrays), {"dim": axis})


def moveaxis(tensor, source, destination):
    """ref: ndarray.py moveaxis (a transpose)."""
    axes = list(range(tensor.ndim))
    axes.remove(source % tensor.ndim)
    axes.insert(destination % tensor.ndim, source % tensor.ndim)
    return invoke(get_op("transpose"), [tensor], {"axes": tuple(axes)})


def waitall():
    """Block until all outstanding work has executed
    (ref: mx.nd.waitall → Engine::WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
