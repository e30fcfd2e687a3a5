"""Build and load the port's hand-written CUDA kernels.

Each kernel's sources under ``csrc/`` (``SOURCES``) expose a plain C
interface and are compiled by one ``nvcc`` for Hopper (``sm_90a``) into
the kernel's own shared library, which Python loads with ``ctypes``.
Nothing here runs at import: the first CUDA tensor that reaches a
kernel's wrapper calls :func:`load`, which builds the library if it is
missing.  Libraries land in ``build/torch_kernels/`` at the root of the
checkout, named by a hash of their sources and flags, so an edited source
is rebuilt and an unchanged one is reused.  ``nvcc``'s
resource report (``-Xptxas -v``: registers, shared memory, spills) is kept
beside each library as ``.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .base import MXNetError

__all__ = ["KERNELS", "SOURCES", "BUILD_DIR", "build_all", "load",
           "build_log", "lib_path"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> its C entry points as (restype, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "flash_attention": {
        # q, k, v, o, batch_heads, sq, sk, d, scale, causal, dtype, stream
        "flash_attention_fwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                     _I, _P]),
        "flash_attention_error_string": (ctypes.c_char_p, [_I]),
    },
}
# kernel name -> its sources under csrc/: flash attention's f32 route and
# its bf16 route (wgmma, TMA), one library
SOURCES = {
    "flash_attention": ("flash_attention.cu", "flash_attention_sm90.cu"),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


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
    for src in _sources(name):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def build_log(name: str) -> str:
    """nvcc's output from building kernel ``name`` (empty if never built)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=None) -> dict:
    """Build the missing libraries of ``names`` (default: every kernel), one
    ``nvcc`` per source, all started together.  Returns ``{name: seconds}``
    of the builds that ran; raises ``MXNetError`` with nvcc's output if one
    fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    t0 = time.perf_counter()
    for name in names:
        target = lib_path(name)
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_name("%s.tmp-%d" % (target.name, os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources(name))]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, target)
    seconds, failures = {}, []
    for name, (proc, tmp, target) in running.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append("%s (exit %d):\n%s" % (name, proc.returncode, out))
            continue
        target.with_suffix(".log").write_text(out)
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
