"""Build and load the port's hand-written CUDA kernels.

Each kernel's sources under ``csrc/`` (``SOURCES``) expose a plain C
interface.  Every source is compiled for Hopper (``sm_90a``) by an
``nvcc`` of its own, all of them started together, and each kernel's
objects are linked into its own shared library, which Python loads with
``ctypes``.  Nothing here runs at import: the first CUDA tensor that
reaches a kernel's wrapper calls :func:`load`, which builds the library if
it is missing.  Libraries land in ``build/torch_kernels/`` at the root of
the checkout, named by a hash of their sources, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused.  ``nvcc``'s resource report (``-Xptxas -v``:
registers, shared memory, spills) is kept beside each library as ``.log``.

``EXTENSIONS`` are host-only CPython extension modules in plain C (no CUDA
and no PyTorch header), built the same way at first use by the host C
compiler (``$CC``, else ``cc``) against this interpreter's ``Python.h`` and
imported by :func:`load_extension`: ``_rtc_launch``, the host side of a
runtime kernel's launch (``csrc/rtc_launch.c``).

``HOST_LIBS`` are host-only C++ libraries with a plain C interface, built
at first use by the host C++ compiler (``$CXX``, else ``c++`` or ``g++``)
and loaded by :func:`load_host_lib` with ``ctypes``: ``recordio``, the
RecordIO reader, writer and prefetching reader of ``src/io/recordio.cc``
(the repository's own source, compiled alone; its Makefile also builds
libraries against libpython, which the port does not use).
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path

from .base import MXNetError

__all__ = ["KERNELS", "SOURCES", "EXTENSIONS", "BUILD_DIR", "build_all",
           "load", "load_extension", "build_log", "lib_path", "extension_path",
           "HOST_LIBS", "load_host_lib", "host_lib_path"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
# flags of each source's compile; the link adds -shared
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> its C entry points as (restype, argtypes)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
KERNELS = {
    "flash_attention": {
        # q, k, v, o, batch_heads, sq, sk, d, scale, causal, stats (null
        # when serving), stream
        "flash_attention_bf16": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                      _P, _P]),
        "flash_attention_f16": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                     _P, _P]),
        # x, its 4 strides, planes, b, h, s, d, mul, x's dtype code, stream
        "flash_attention_f32_split": (_I, [_P, _L, _L, _L, _L, _P, _I, _I,
                                           _I, _I, _F, _I, _P]),
        # q, k, v planes, o, batch_heads, sq, sk, d, causal, stream
        "flash_attention_f32": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _P]),
        # head dims above 256, route A: q, k, v, o, batch_heads, sq, sk, d,
        # scale, causal, stream
        "flash_attention_wide_bf16": (_I, [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _F, _I, _P]),
        "flash_attention_wide_f16": (_I, [_P, _P, _P, _P, _I, _I, _I, _I,
                                          _F, _I, _P]),
        # route B: q, k, v planes, o, batch_heads, sq, sk, d, causal, stream
        "flash_attention_wide_f32": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _P]),
        # q, k, v, out, g, dq, dk, dv, stats, batch_heads, sq, sk, d, scale,
        # causal, stream
        "flash_attention_bwd_bf16": (_I, [_P] * 9 + [_I, _I, _I, _I, _F, _I,
                                                      _P]),
        "flash_attention_bwd_f16": (_I, [_P] * 9 + [_I, _I, _I, _I, _F, _I,
                                                     _P]),
        "flash_attention_error_string": (ctypes.c_char_p, [_I]),
    },
}
# kernel name -> its sources under csrc/: flash attention's C entry points,
# its 16-bit routes (bf16, f16), its f32 route, its two routes for head dims
# above 256 and the 16-bit routes' backward (all wgmma and TMA), one library
SOURCES = {
    "flash_attention": ("flash_attention.cu", "flash_attention_sm90.cu",
                        "flash_attention_f32_sm90.cu",
                        "flash_attention_wide_sm90.cu",
                        "flash_attention_bwd_sm90.cu"),
}

# module name -> its host-only C source under csrc/
EXTENSIONS = {"_rtc_launch": "rtc_launch.c"}
CC_FLAGS = ("-O2", "-shared", "-fPIC", "-Wall")

# library name -> its host-only C++ source (src/Makefile's flags)
HOST_LIBS = {"recordio": _PKG.parent / "src" / "io" / "recordio.cc"}
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")

_LOCK = threading.Lock()
_LIBS: dict = {}     # kernel or extension name -> CDLL or module


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found on PATH or under %s; the CUDA toolkit is "
                     "needed to build the port's kernels" % cuda_home)


def _sources(name: str) -> list:
    return [CSRC / f for f in SOURCES[name]]


def lib_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built."""
    digest = hashlib.sha256()
    for src in _sources(name) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def build_log(name: str) -> str:
    """nvcc's output from building kernel ``name`` (empty if never built)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=None) -> dict:
    """Build the missing libraries of ``names`` (default: every kernel): one
    ``nvcc`` per source, all started together, then one link per library.
    Returns ``{name: seconds}`` of the builds that ran; raises ``MXNetError``
    with nvcc's output if one fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    compiles = {}
    t0 = time.perf_counter()
    for name in names:
        target = lib_path(name)
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        tag = "%s.tmp-%d" % (target.stem, os.getpid())
        compiles[name] = []
        for src in _sources(name):
            obj = target.with_name("%s-%s.o" % (tag, src.stem))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            compiles[name].append((subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), obj))
    seconds, failures = {}, []
    for name, procs in compiles.items():
        target = lib_path(name)
        tmp = target.with_name("%s.tmp-%d" % (target.name, os.getpid()))
        log, ok = [], True
        for proc, _ in procs:
            out, _ = proc.communicate()
            log.append(out)
            ok = ok and proc.returncode == 0
        if ok:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *(str(obj) for _, obj in procs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(link.stdout)
            ok = link.returncode == 0
        for _, obj in procs:
            obj.unlink(missing_ok=True)
        seconds[name] = time.perf_counter() - t0
        if not ok:
            failures.append("%s:\n%s" % (name, "".join(log)))
            tmp.unlink(missing_ok=True)
            continue
        target.with_suffix(".log").write_text("".join(log))
        os.replace(tmp, target)
    if failures:
        raise MXNetError("nvcc failed for " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    ``restype``/``argtypes`` set on every entry point."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, (restype, argtypes) in KERNELS[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _LIBS[name] = lib
        return lib


def _cc():
    for cand in (os.environ.get("CC"), "cc", "gcc"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise MXNetError("no C compiler ($CC, cc or gcc) on PATH; the launcher "
                     "of runtime kernels is built by one")


def extension_path(name: str) -> Path:
    """Where extension ``name`` is (or will be) built: named by a hash of its
    source, the flags and the interpreter it is built for."""
    digest = hashlib.sha256((CSRC / EXTENSIONS[name]).read_bytes())
    digest.update(" ".join(CC_FLAGS).encode() + sys.version.encode() +
                  sysconfig.get_config_var("EXT_SUFFIX").encode())
    return BUILD_DIR / ("%s-%s.so" % (name, digest.hexdigest()[:16]))


def _compile(command, source: Path, target: Path, what: str):
    """Run ``command + [-o tmp, source]`` and move the result to ``target``
    (its output kept beside it as ``.log``); ``MXNetError`` with the
    compiler's output if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name("%s.tmp-%d" % (target.name, os.getpid()))
    out = subprocess.run([*command, "-o", str(tmp), str(source)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError("building %s failed:\n%s" % (what, out.stdout))
    target.with_suffix(".log").write_text(out.stdout)
    os.replace(tmp, target)


def _build_extension(name: str, target: Path):
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise MXNetError("Python.h not found under %s: building %s needs "
                         "the interpreter's C headers" % (include, name))
    _compile([_cc(), *CC_FLAGS, "-I", include], CSRC / EXTENSIONS[name],
             target, name)


def load_extension(name: str):
    """The imported extension module ``name`` of ``EXTENSIONS``, built first
    if needed; a failed build raises ``MXNetError``."""
    with _LOCK:
        module = _LIBS.get(name)
        if module is None:
            target = extension_path(name)
            if not target.exists():
                _build_extension(name, target)
            spec = importlib.util.spec_from_file_location(name, target)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            _LIBS[name] = module
        return module


def _cxx():
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise MXNetError("no C++ compiler ($CXX, c++ or g++) on PATH; the native "
                     "RecordIO library is built by one")


def host_lib_path(name: str) -> Path:
    """Where host library ``name`` is (or will be) built: named by a hash
    of its source and the flags."""
    digest = hashlib.sha256(HOST_LIBS[name].read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def load_host_lib(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` of ``HOST_LIBS``, built first if
    needed; a failed build raises ``MXNetError`` with the compiler's
    output.  The caller sets ``restype``/``argtypes``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target = host_lib_path(name)
            if not target.exists():
                _compile([_cxx(), *CXX_FLAGS], HOST_LIBS[name], target,
                         "%s from %s" % (name, HOST_LIBS[name]))
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
        return lib
