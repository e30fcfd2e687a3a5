"""The native RecordIO library, bound with ``ctypes``.

Counterpart of ``incubator_mxnet_tpu/_native.py``: the same C entry points
of ``src/io/recordio.cc`` (``MXTPURecordIO*`` and ``MXTPUPrefetchReader*``:
the dmlc RecordIO framing read and written in C++, and a reader that frames
records on a thread of its own ahead of the caller).  Here the library is
built alone, at first use, by ``cuda_build.load_host_lib`` into
``build/torch_kernels/``; a failed build raises ``MXNetError`` with the
compiler's output instead of falling back to Python.  The Python framing
is chosen explicitly with ``MXTPU_NATIVE_IO=0`` (``recordio.py``).
"""
from __future__ import annotations

import ctypes
import threading

from . import cuda_build

__all__ = ["io_lib", "NativeRecordReader", "NativeRecordWriter",
           "NativePrefetchReader"]

_P, _U64 = ctypes.c_void_p, ctypes.c_uint64
_OUT = [_P, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(_U64)]
# entry point -> (restype, argtypes)
_SIGNATURES = {
    "MXTPURecordIOReaderCreate": (_P, [ctypes.c_char_p]),
    "MXTPURecordIOReaderNext": (ctypes.c_int, _OUT),
    "MXTPURecordIOReaderSeek": (None, [_P, _U64]),
    "MXTPURecordIOReaderTell": (_U64, [_P]),
    "MXTPURecordIOReaderFree": (None, [_P]),
    "MXTPURecordIOWriterCreate": (_P, [ctypes.c_char_p]),
    "MXTPURecordIOWriterWrite": (ctypes.c_int, [_P, ctypes.c_char_p, _U64]),
    "MXTPURecordIOWriterTell": (_U64, [_P]),
    "MXTPURecordIOWriterFree": (None, [_P]),
    "MXTPUPrefetchReaderCreate": (_P, [ctypes.c_char_p, _U64]),
    "MXTPUPrefetchReaderNext": (ctypes.c_int, _OUT),
    "MXTPUPrefetchReaderFree": (None, [_P]),
}
_LOCK = threading.Lock()
_LIB = []


def io_lib() -> ctypes.CDLL:
    """The RecordIO library with every entry point's types set, built first
    if needed (``MXNetError`` if the build fails)."""
    with _LOCK:
        if not _LIB:
            lib = cuda_build.load_host_lib("recordio")
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB.append(lib)
        return _LIB[0]


def _open(create, path, *args):
    lib = io_lib()
    handle = getattr(lib, create)(path.encode(), *args)
    if not handle:
        raise IOError("cannot open %s" % path)
    return lib, handle


def _next(fn, handle):
    out, size = ctypes.c_char_p(), _U64()
    if not fn(handle, ctypes.byref(out), ctypes.byref(size)):
        return None
    return ctypes.string_at(out, size.value)


class _Handle(object):
    """A native handle freed by ``close`` (idempotent) or at collection; a
    call on a closed one raises instead of passing C a null handle."""

    _free = None
    _h = None

    @property
    def h(self):
        if not self._h:
            raise IOError("the native RecordIO handle is closed")
        return self._h

    def close(self):
        if self._h:
            getattr(self._lib, self._free)(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeRecordReader(_Handle):
    """Sequential reader: ``read()`` returns one record's payload (split
    records joined), or None at the end of the file."""

    _free = "MXTPURecordIOReaderFree"

    def __init__(self, path):
        self._lib, self._h = _open("MXTPURecordIOReaderCreate", path)

    def read(self):
        return _next(self._lib.MXTPURecordIOReaderNext, self.h)

    def seek(self, pos):
        self._lib.MXTPURecordIOReaderSeek(self.h, pos)

    def tell(self):
        return self._lib.MXTPURecordIOReaderTell(self.h)


class NativeRecordWriter(_Handle):
    """Sequential writer: ``write(data)`` frames one record (split above
    the 29-bit length field, as the Python writer does)."""

    _free = "MXTPURecordIOWriterFree"

    def __init__(self, path):
        self._lib, self._h = _open("MXTPURecordIOWriterCreate", path)

    def write(self, data):
        data = bytes(data)
        if self._lib.MXTPURecordIOWriterWrite(self.h, data, len(data)) != 0:
            raise IOError("native RecordIO write failed")

    def tell(self):
        return self._lib.MXTPURecordIOWriterTell(self.h)


class NativePrefetchReader(_Handle):
    """Forward-only reader whose C++ thread frames up to ``capacity``
    records ahead of ``read()`` (the role of dmlc's ThreadedIter)."""

    _free = "MXTPUPrefetchReaderFree"

    def __init__(self, path, capacity=16):
        self._lib, self._h = _open("MXTPUPrefetchReaderCreate", path,
                                   capacity)

    def read(self):
        return _next(self._lib.MXTPUPrefetchReaderNext, self.h)
