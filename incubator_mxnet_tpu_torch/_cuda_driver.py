"""ctypes bindings to NVRTC and to the CUDA driver, for the runtime kernels of
:mod:`incubator_mxnet_tpu_torch.rtc`.

No counterpart in the JAX build, whose runtime kernels are Pallas functions
(``incubator_mxnet_tpu/rtc.py``).  Here a kernel is CUDA C source that NVRTC
compiles to a CUBIN at run time and the driver loads and launches, as
MXNet's ``src/common/rtc.cc`` does.  ``restype`` and ``argtypes`` are set on
every function.  Nothing is loaded when the module is imported: the first
call to :func:`nvrtc` or :func:`driver` finds and loads the library, and a
missing library raises ``MXNetError`` naming what was looked for.

Where the libraries are looked for:

- ``libnvrtc.so*`` under ``$CUDA_HOME/lib64`` (default ``/usr/local/cuda``),
  then in the ``nvidia/*/lib`` directories of the installed NVIDIA wheels
  (where torch's CUDA wheels put it), then ``ctypes.util.find_library``;
- ``libcuda.so.1``, the driver, from the loader's search path.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import site
import threading

from .base import MXNetError

__all__ = ["nvrtc", "driver", "compile_to_cubin", "check",
           "primary_context", "use_primary_context", "launcher",
           "launch_floor_ns", "CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED"]

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_S = ctypes.c_char_p
_SZ = ctypes.c_size_t
_I = ctypes.c_int
_U = ctypes.c_uint

CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED = 8   # CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES

# name -> (restype, argtypes); nvrtcResult and CUresult are C enums (int)
_NVRTC_FUNCS = {
    "nvrtcGetErrorString": (_S, [_I]),
    # prog*, src, name, numHeaders, headers, includeNames
    "nvrtcCreateProgram": (_I, [_PP, _S, _S, _I, ctypes.POINTER(_S),
                                ctypes.POINTER(_S)]),
    "nvrtcAddNameExpression": (_I, [_P, _S]),
    "nvrtcCompileProgram": (_I, [_P, _I, ctypes.POINTER(_S)]),
    "nvrtcGetProgramLogSize": (_I, [_P, ctypes.POINTER(_SZ)]),
    "nvrtcGetProgramLog": (_I, [_P, _S]),
    "nvrtcGetCUBINSize": (_I, [_P, ctypes.POINTER(_SZ)]),
    "nvrtcGetCUBIN": (_I, [_P, _S]),
    "nvrtcGetLoweredName": (_I, [_P, _S, ctypes.POINTER(_S)]),
    "nvrtcDestroyProgram": (_I, [_PP]),
}
_DRIVER_FUNCS = {
    "cuInit": (_I, [_U]),
    "cuGetErrorString": (_I, [_I, ctypes.POINTER(_S)]),
    "cuDeviceGet": (_I, [ctypes.POINTER(_I), _I]),
    "cuDevicePrimaryCtxRetain": (_I, [_PP, _I]),
    "cuCtxSetCurrent": (_I, [_P]),
    "cuCtxGetCurrent": (_I, [_PP]),
    "cuModuleLoadData": (_I, [_PP, _P]),
    "cuModuleGetFunction": (_I, [_PP, _P, _S]),
    "cuFuncSetAttribute": (_I, [_P, _I, _I]),
    # f, grid x/y/z, block x/y/z, shared bytes, stream, params, extra
    "cuLaunchKernel": (_I, [_P, _U, _U, _U, _U, _U, _U, _U, _P, _PP, _PP]),
}

_LOCK = threading.RLock()   # check() inside a held lock reaches driver()
_LIBS: dict = {}
_PRIMARY: dict = {}     # device index -> retained primary CUcontext


def _nvrtc_candidates():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = sorted(glob.glob(os.path.join(cuda_home, "lib64", "libnvrtc.so*")))
    for root in site.getsitepackages():
        found += sorted(glob.glob(os.path.join(root, "nvidia", "*", "lib",
                                               "libnvrtc.so*")))
    lib = ctypes.util.find_library("nvrtc")
    if lib:
        found.append(lib)
    return cuda_home, found


def _bind(lib, funcs):
    for name, (restype, argtypes) in funcs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def nvrtc() -> ctypes.CDLL:
    """The NVRTC library, loaded and bound on first use."""
    with _LOCK:
        lib = _LIBS.get("nvrtc")
        if lib is not None:
            return lib
        cuda_home, candidates = _nvrtc_candidates()
        errors = []
        for path in candidates:
            try:
                lib = ctypes.CDLL(path)
            except OSError as exc:
                errors.append("%s: %s" % (path, exc))
                continue
            _LIBS["nvrtc"] = _bind(lib, _NVRTC_FUNCS)
            return lib
        raise MXNetError(
            "NVRTC (libnvrtc.so) not found: looked under %s/lib64, in the "
            "nvidia/*/lib directories of the installed wheels and by "
            "ctypes.util.find_library('nvrtc')%s; runtime CUDA kernels need "
            "the CUDA toolkit's NVRTC" % (
                cuda_home, "" if not errors else " (" + "; ".join(errors) + ")"))


def driver() -> ctypes.CDLL:
    """The CUDA driver library (``libcuda.so.1``), loaded, bound and
    initialised on first use."""
    with _LOCK:
        lib = _LIBS.get("driver")
        if lib is not None:
            return lib
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as exc:
            raise MXNetError("the CUDA driver (libcuda.so.1) is not loadable: "
                             "%s" % exc) from None
        _bind(lib, _DRIVER_FUNCS)
        _LIBS["driver"] = lib
    check(lib.cuInit(0), "cuInit")
    return lib


def check(result: int, what: str):
    """Raise ``MXNetError`` unless a driver call returned CUDA_SUCCESS."""
    if result != 0:
        msg = ctypes.c_char_p()
        driver().cuGetErrorString(result, ctypes.byref(msg))
        raise MXNetError("%s failed: CUDA error %d (%s)" % (
            what, result, msg.value.decode() if msg.value else "unknown"))


def _check_nvrtc(lib, result: int, what: str):
    if result != 0:
        raise MXNetError("%s failed: %s" % (
            what, lib.nvrtcGetErrorString(result).decode()))


def compile_to_cubin(source: str, options, names):
    """Compile CUDA C ``source`` with NVRTC.  ``names`` are added as name
    expressions, so a ``__global__`` function need not be ``extern "C"``.
    Returns ``(cubin bytes, {name: lowered name}, log)``; a failed compile
    raises ``MXNetError`` carrying NVRTC's log."""
    lib = nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc_module.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        encoded = [n.encode() for n in names]
        for n in encoded:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(prog, n),
                         "nvrtcAddNameExpression")
        opts = [o.encode() for o in options]
        res = lib.nvrtcCompileProgram(prog, len(opts), (_S * len(opts))(*opts))
        size = ctypes.c_size_t()
        _check_nvrtc(lib, lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size)),
                     "nvrtcGetProgramLogSize")
        buf = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetProgramLog(prog, buf),
                     "nvrtcGetProgramLog")
        log = buf.value.decode(errors="replace")
        if res != 0:
            raise MXNetError("NVRTC could not compile the module (%s):\n%s" % (
                lib.nvrtcGetErrorString(res).decode(), log))
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name, n in zip(names, encoded):
            out = ctypes.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(prog, n,
                                                      ctypes.byref(out)),
                         "nvrtcGetLoweredName(%s)" % name)
            lowered[name] = out.value.decode()
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def primary_context(device_index: int) -> int:
    """The handle of CUDA device ``device_index``'s primary context (the one
    the CUDA runtime, and so torch, works in), retained once per device and
    process."""
    lib = driver()
    with _LOCK:
        ctx = _PRIMARY.get(device_index)
        if ctx is None:
            dev = ctypes.c_int()
            check(lib.cuDeviceGet(ctypes.byref(dev), device_index),
                  "cuDeviceGet")
            handle = ctypes.c_void_p()
            check(lib.cuDevicePrimaryCtxRetain(ctypes.byref(handle), dev),
                  "cuDevicePrimaryCtxRetain")
            ctx = _PRIMARY[device_index] = handle.value
    return ctx


def use_primary_context(device_index: int) -> int:
    """Make the primary context of CUDA device ``device_index`` current on
    the calling thread, and return its handle."""
    ctx = primary_context(device_index)
    check(driver().cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return ctx


def launcher():
    """``(module, table)``: the compiled launcher ``_rtc_launch``
    (``csrc/rtc_launch.c``, built at first use by ``cuda_build``) and a
    table of the loaded driver's ``cuLaunchKernel``, ``cuCtxGetCurrent`` and
    ``cuCtxSetCurrent`` for its calls.  A launcher that does not build or
    load raises ``MXNetError``: there is no other launch path."""
    from . import cuda_build
    module = cuda_build.load_extension("_rtc_launch")
    lib = driver()
    return module, module.driver_table(*(
        ctypes.cast(getattr(lib, name), ctypes.c_void_p).value
        for name in ("cuLaunchKernel", "cuCtxGetCurrent", "cuCtxSetCurrent")))


def launch_floor_ns(func: int, ctx: int, count: int, stream: int) -> float:
    """The mean host ns of one ``cuLaunchKernel`` of ``func`` (a kernel with
    no parameters, launched as one thread) in ``ctx`` on ``stream``, over
    ``count`` launches issued back to back from C (``rtc_launch_floor_ns``
    in ``csrc/rtc_launch.c``): the least a launch costs through this driver.
    Keep ``count`` below the device's launch-queue depth."""
    module, table = launcher()
    return module.floor_ns(table, func, ctx, count, stream)
