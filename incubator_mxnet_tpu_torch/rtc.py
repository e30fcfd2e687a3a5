"""Runtime-compiled CUDA kernels over NDArrays (ref: python/mxnet/rtc.py,
src/common/rtc.cc).

Counterpart of ``incubator_mxnet_tpu/rtc.py``, with the roles swapped.  The
JAX build's runtime kernels are Pallas functions (``PallasModule``, launched
by ``pl.pallas_call`` at rtc.py:86) and its ``CudaModule`` raises; here
``CudaModule`` is MXNet's own API again:

    mod = mx.rtc.CudaModule(source, exports=["axpy"])
    k = mod.get_kernel("axpy", "const float *x, const float *y, float *o, int n")
    k.launch([x, y, o, n], mx.gpu(0), grid_dims=(blocks,), block_dims=(256,))

The source is compiled once, at construction, by NVRTC for ``sm_90a`` into
a CUBIN (``_cuda_driver``).  The CUBIN is loaded into a device's primary
context the first time a kernel launches there, and each ``CUfunction`` is
kept per device.  The driver is called through a compiled launcher
(``csrc/rtc_launch.c``, built at first use), not through ctypes.  There is no cache per shape, as the JAX build keeps per
(shapes, dtypes, grid) at rtc.py:81-90: a CUDA C kernel takes its shapes as
arguments.  A launch writes through the signature's mutable pointers and
returns ``None``; it runs on the device's current torch stream.  There is no
interpreter for CUDA C, so a launch on a CPU context raises.
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import threading

import numpy as np
import torch

from . import _cuda_driver as _cu
from .base import MXNetError, dtype_name
from .context import Context
from .ndarray import NDArray

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel",
           "parse_signature"]

ARCH_OPTION = "--gpu-architecture=sm_90a"
_MAX_THREADS_PER_BLOCK = 1024
_DEFAULT_SHARED = 48 * 1024

# C type -> (dtype name of a pointed-to array, ctypes type of a scalar)
_TYPES = {
    "float": ("float32", ctypes.c_float),
    "double": ("float64", ctypes.c_double),
    "__half": ("float16", ctypes.c_uint16),
    "uint8_t": ("uint8", ctypes.c_uint8),
    "int8_t": ("int8", ctypes.c_int8),
    "int32_t": ("int32", ctypes.c_int32),
    "int": ("int32", ctypes.c_int32),
    "int64_t": ("int64", ctypes.c_int64),
}
_PARAM = re.compile(r"^(const\s+)?([A-Za-z_]\w*)\s*(\*)?\s*([A-Za-z_]\w*)?$")


class _Param:
    __slots__ = ("ctype", "dtype", "is_pointer", "is_const", "name")

    def __init__(self, ctype, is_pointer, is_const, name):
        self.ctype = ctype
        self.dtype, _ = _TYPES[ctype]
        self.is_pointer = is_pointer
        self.is_const = is_const
        self.name = name

    def __repr__(self):
        return "%s%s %s%s" % ("const " if self.is_const else "", self.ctype,
                              "*" if self.is_pointer else "", self.name or "")


def parse_signature(signature: str):
    """A C parameter list (``"const float *x, float *y, int n"``) as a list of
    parameters.  Pointers and scalars take ``float``, ``double``, ``__half``,
    ``uint8_t``, ``int8_t``, ``int32_t``/``int`` and ``int64_t``; a pointer is
    read-only when ``const``, else the kernel writes it.  Anything else
    raises ``MXNetError``."""
    params = []
    text = signature.strip()
    if not text or text == "void":
        return params
    for i, raw in enumerate(text.split(",")):
        m = _PARAM.match(" ".join(raw.split()))
        if m is None:
            raise MXNetError("signature %r: cannot parse parameter %d, %r"
                             % (signature, i, raw.strip()))
        const, ctype, star, name = m.groups()
        if ctype not in _TYPES:
            raise MXNetError("signature %r: unsupported type %r in parameter "
                             "%d (supported: %s)" % (signature, ctype, i,
                                                     ", ".join(_TYPES)))
        params.append(_Param(ctype, bool(star), bool(const), name))
    return params


class CudaModule:
    """CUDA C source compiled at run time (ref: rtc.py CudaModule:42).

    ``options`` go to NVRTC after ``--gpu-architecture=sm_90a`` and, when it
    exists, ``-I$CUDA_HOME/include``.  Each name in ``exports`` becomes an
    NVRTC name expression, so its ``__global__`` function needs no
    ``extern "C"``.  A compile error raises ``MXNetError`` with NVRTC's log."""

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.source = source
        self.exports = tuple(exports)
        opts = [ARCH_OPTION]
        include = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                               "include")
        if os.path.isdir(include):
            opts.append("-I" + include)
        self.options = tuple(opts) + tuple(options)
        self._cubin, self._lowered, self.log = _cu.compile_to_cubin(
            source, self.options, self.exports)
        self._lock = threading.Lock()
        self._modules = {}      # device index -> CUmodule
        self._kernels = {}      # (name, signature) -> CudaKernel

    def get_kernel(self, name, signature):
        """The exported kernel ``name`` with the C parameter list
        ``signature`` (ref: rtc.py get_kernel:112).  The same (name,
        signature) returns the same ``CudaKernel``."""
        if name not in self.exports:
            raise MXNetError("kernel %r is not exported (exports: %s)"
                             % (name, sorted(self.exports)))
        key = (name, " ".join(signature.split()))
        kernel = self._kernels.get(key)
        if kernel is None:
            kernel = self._kernels[key] = CudaKernel(
                self, name, parse_signature(signature))
        return kernel

    def _function(self, device_index, name):
        """The ``CUfunction`` of ``name`` on a device, loading the module
        into the device's primary context the first time."""
        with self._lock:
            _cu.use_primary_context(device_index)
            module = self._modules.get(device_index)
            if module is None:
                handle = ctypes.c_void_p()
                _cu.check(_cu.driver().cuModuleLoadData(ctypes.byref(handle),
                                                        self._cubin),
                          "cuModuleLoadData")
                module = self._modules[device_index] = handle.value
            func = ctypes.c_void_p()
            _cu.check(_cu.driver().cuModuleGetFunction(
                ctypes.byref(func), module, self._lowered[name].encode()),
                "cuModuleGetFunction(%s)" % name)
            return func.value


_PAD = {1: (1, 1), 2: (1,), 3: ()}


def _dims(dims, what):
    """``dims`` as a 3-tuple of ints >= 1; a tuple of 1-3 ints takes the
    fast path."""
    pad = _PAD.get(len(dims)) if dims.__class__ is tuple else None
    if pad is not None:
        x, y, z = full = dims + pad
        if x.__class__ is int and y.__class__ is int and \
                z.__class__ is int and x >= 1 and y >= 1 and z >= 1:
            return full
    dims = (int(dims),) if isinstance(dims, (int, np.integer)) else \
        tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise MXNetError("%s must be 1 to 3 dimensions, each >= 1, got %r"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


# what a kernel's first launch on a device loads: the compiled launcher's
# launch and driver table, the CUfunction, the primary CUcontext and torch's
# raw current-stream getter
_Site = collections.namedtuple("_Site", "launch table func ctx stream")


def _raw_stream():
    """torch's getter of a device's current stream as a raw ``cudaStream_t``
    (it honours ``torch.cuda.stream(s)`` and builds no ``Stream`` object);
    looked up at a kernel's first launch on a device, since a CPU build of
    torch lacks it."""
    return torch._C._cuda_getCurrentRawStream


_increment_version = torch.autograd.graph.increment_version


class CudaKernel:
    """One launchable kernel of a :class:`CudaModule` (ref: rtc.py
    CudaKernel:173).  ``launches`` counts the launches made.

    What the signature fixes is worked out once, here: one packer for each
    parameter (a pointer's expected ``torch.dtype``, a scalar's ctypes type
    and integer range) and the mutable pointers' indices.  Each launch then
    checks and writes the values into a parameter buffer of the calling
    thread (two threads may launch one kernel at once; ``cuLaunchKernel``
    copies the values before it returns, so a buffer is refilled by the
    next launch), and the compiled launcher (``csrc/rtc_launch.c``) makes
    the device's primary context current where it is not and calls
    ``cuLaunchKernel``.  The first launch on a device resolves the device
    (raising as ``Context.torch_device`` does), loads the function and the
    launcher; later ones reuse them."""

    def __init__(self, module, name, params):
        self.module = module
        self.name = name
        self.params = params
        self.launches = 0
        self._packers = [self._packer(i, p) for i, p in enumerate(params)]
        self._mutable = [i for i, p in enumerate(params)
                         if p.is_pointer and not p.is_const]
        self._local = threading.local()  # .buffer: this thread's arguments
        self._devices = {}      # device index -> (tensor device index, device)
        self._sites = {}        # device index -> _Site
        self._shared_set = {}   # device index -> dynamic shared bytes allowed

    # -- what the signature fixes ------------------------------------------
    def _packer(self, i, param):
        """``pack(arg, holder, device)`` for parameter ``i``: checks ``arg``
        and writes it into ``holder`` (its ctypes slot), else raises
        through the checks of :meth:`_pointer` / :meth:`_number`."""
        ctype = _TYPES[param.ctype][1]
        if param.is_pointer:
            dtype = getattr(torch, param.dtype)

            def pack(arg, holder, device):
                if isinstance(arg, NDArray):
                    t = arg._data
                    if t.dtype is dtype and t.get_device() == device[0] and \
                            t.is_contiguous():
                        holder.value = t.data_ptr()
                        return
                self._pointer(i, param, arg, device[1])
            return pack, ctypes.c_uint64
        if param.ctype == "__half":
            def pack(arg, holder, device):
                holder.value = int(np.float16(self._number(i, param, arg))
                                   .view(np.uint16))
        elif param.dtype.startswith(("int", "uint")):
            info = np.iinfo(param.dtype)
            lo, hi = int(info.min), int(info.max)

            def pack(arg, holder, device):
                if arg.__class__ is not int or not lo <= arg <= hi:
                    arg = self._integer(i, param, arg, lo, hi)
                holder.value = arg
        else:
            def pack(arg, holder, device):
                if arg.__class__ is not float:
                    arg = float(self._number(i, param, arg))
                holder.value = arg
        return pack, ctype

    # -- the checks, with their errors -------------------------------------
    def _pointer(self, i, param, arg, device):
        """Raise for a pointer argument the packer refused."""
        if not isinstance(arg, NDArray):
            raise MXNetError("%s: argument %d (%r) must be an NDArray, got %s"
                             % (self.name, i, param, type(arg)))
        t = arg._data
        if dtype_name(t.dtype) != param.dtype:
            raise MXNetError("%s: argument %d (%r) must be %s, got %s"
                             % (self.name, i, param, param.dtype,
                                dtype_name(t.dtype)))
        if t.device != device:
            raise MXNetError("%s: argument %d (%r) lives on %s, not on the "
                             "launch context's %s"
                             % (self.name, i, param, t.device, device))
        raise MXNetError("%s: argument %d (%r) is not contiguous"
                         % (self.name, i, param))

    def _number(self, i, param, arg):
        if isinstance(arg, (NDArray, torch.Tensor)) or \
                not isinstance(arg, (int, float, np.integer, np.floating)):
            raise MXNetError("%s: argument %d (%r) must be a number, got %s"
                             % (self.name, i, param, type(arg)))
        return arg

    def _integer(self, i, param, arg, lo, hi):
        if int(self._number(i, param, arg)) != arg:
            raise MXNetError("%s: argument %d (%r) must be an integer, got %r"
                             % (self.name, i, param, arg))
        if not lo <= int(arg) <= hi:
            # ctypes would wrap it without a word
            raise MXNetError("%s: argument %d (%r) = %d is out of range for "
                             "%s [%d, %d]" % (self.name, i, param, int(arg),
                                              param.ctype, lo, hi))
        return int(arg)

    # -- once per thread, once per device ----------------------------------
    def _buffer(self):
        """This thread's parameter buffer: a ctypes slot per parameter and
        the ``void *[]`` of their addresses (kept alive with them)."""
        holders = [ctype() for _, ctype in self._packers]
        array = (ctypes.c_void_p * max(len(holders), 1))(
            *[ctypes.addressof(h) for h in holders])
        self._local.buffer = buffer = (holders, array, ctypes.addressof(array))
        return buffer

    def _resolve(self, ctx):
        device = ctx.torch_device()
        where = self._devices[ctx.device_id] = (
            device.index if device.type == "cuda" else -1, device)
        return where

    def _site(self, index):
        func = self.module._function(index, self.name)
        module, table = _cu.launcher()
        site = self._sites[index] = _Site(module.launch, table, func,
                                          _cu.primary_context(index),
                                          _raw_stream())
        return site

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU context) with ``args`` matching the
        signature: NDArrays on ``ctx`` for pointers, numbers for scalars.
        Writes through the mutable pointers and returns ``None``
        (ref: rtc.py CudaKernel.launch:185).  Every check raises before the
        driver is called."""
        if ctx.__class__ is not Context:
            ctx = Context(ctx)
        if ctx.device_type != "gpu":
            raise MXNetError("rtc kernel %s launched on %s: runtime CUDA "
                             "kernels run only on a GPU context (there is no "
                             "interpreter for CUDA C)" % (self.name, ctx))
        if len(args) != len(self._packers):
            raise MXNetError("%s takes %d arguments (%s), got %d" % (
                self.name, len(self.params),
                ", ".join(map(repr, self.params)), len(args)))
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        if block[0] * block[1] * block[2] > _MAX_THREADS_PER_BLOCK:
            raise MXNetError("block_dims %r: more than %d threads in a block"
                             % (block, _MAX_THREADS_PER_BLOCK))
        if shared_mem.__class__ is not int:
            shared_mem = int(shared_mem)
        if shared_mem < 0:
            raise MXNetError("shared_mem must be >= 0, got %d" % shared_mem)
        index = ctx.device_id
        device = self._devices.get(index) or self._resolve(ctx)
        try:
            holders, _, params = self._local.buffer
        except AttributeError:
            holders, _, params = self._buffer()
        for (pack, _), arg, holder in zip(self._packers, args, holders):
            pack(arg, holder, device)
        launch, table, func, pctx, stream = \
            self._sites.get(index) or self._site(index)
        if shared_mem > _DEFAULT_SHARED and \
                shared_mem > self._shared_set.get(index, 0):
            _cu.use_primary_context(index)
            _cu.check(_cu.driver().cuFuncSetAttribute(
                func, _cu.CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED, shared_mem),
                "cuFuncSetAttribute(%s, %d bytes)" % (self.name, shared_mem))
            self._shared_set[index] = shared_mem
        failed = launch(table, func, pctx, grid[0], grid[1], grid[2],
                        block[0], block[1], block[2], shared_mem,
                        stream(index), params)
        if failed is not None:
            _cu.check(failed[1], "%s(%s)" % (failed[0], self.name))
        self.launches += 1
        for i in self._mutable:
            # autograd cannot see a write through a raw pointer; bump the
            # version counter so a tensor saved for backward is checked
            _increment_version(args[i]._data)


def PallasModule(*args, **kwargs):  # noqa: N802 - reference name
    """The JAX build's runtime kernels are Pallas functions, which have no
    CUDA target.  Raises with a pointer at :class:`CudaModule`."""
    raise MXNetError(
        "PallasModule compiles Pallas kernels for a TPU, which this build "
        "does not target. Use mx.rtc.CudaModule(source, exports=[...]) with "
        "CUDA C source: the runtime kernel-compilation path on this backend.")


PallasKernel = PallasModule
