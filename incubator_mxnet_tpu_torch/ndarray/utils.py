"""NDArray save and load in MXNet's binary ``.params`` container.

Counterpart of ``incubator_mxnet_tpu/ndarray/utils.py``, with its own
copy of the format (the reference's ``NDArray::Save``/``Load`` and the
list container of ``MXNDArraySave``, src/c_api/c_api.cc), so a file either
package writes loads in the other and in stock MXNet.

Layout (little-endian):
  uint64 0x112 (kMXAPINDArrayListMagic), uint64 reserved
  uint64 n_arrays, then per array NDArray::Save:
      uint32 0xF993fac9 (V2 magic), int32 stype (0: dense),
      shape, int32 dev_type, int32 dev_id, int32 dtype flag, raw data
  uint64 n_names, then per name: uint64 len + bytes
Shapes are uint32 ndim + int64[ndim] (nnvm::Tuple::Save).

The context written is kCPU, device 0 (dev_type 1, dev_id 0) for every
array, a card tensor's too: the JAX build writes the same for its device
arrays, so for the same values and names both packages write the same
bytes wherever the arrays lived, and stock MXNet loads the file on the
CPU.  On load the written context is read and ignored: arrays land on the
port's current context (the card unless the caller is inside ``with
mx.cpu():``).  A 0-d array is written as shape (1,), as MXNet 1.x has no
0-d arrays; a dtype without a flag (bfloat16, bool, ...) is widened to
float32 with a warning.  Sparse records (row_sparse, csr) raise until
ROADMAP item 10 ports sparse arrays.  The V1 and pre-V1 dense records of
older MXNet files and the JAX build's earlier ``.npz`` container load too.
"""
from __future__ import annotations

import os
import struct
import warnings

import numpy as np
import torch

from ..base import MXNetError, dtype_name

__all__ = ["save", "load", "load_buffer"]

_LIST_MAGIC = 0x112
_NDARRAY_V2_MAGIC = 0xF993FAC9
_NDARRAY_V1_MAGIC = 0xF993FAC8

# mshadow type flags (mshadow/base.h)
_FLAG_OF = {np.dtype("float32"): 0, np.dtype("float64"): 1,
            np.dtype("float16"): 2, np.dtype("uint8"): 3,
            np.dtype("int32"): 4, np.dtype("int8"): 5,
            np.dtype("int64"): 6}
_DTYPE_OF = {v: k for k, v in _FLAG_OF.items()}
_STYPE_DEFAULT = 0
_SPARSE = {1: "row_sparse", 2: "csr"}


def _write_shape(out, shape):
    out.append(struct.pack("<I", len(shape)))
    out.append(struct.pack("<%dq" % len(shape), *shape))


def _host(arr):
    """An NDArray's values as a contiguous numpy array in a dtype the
    format can name: 0-d becomes (1,), and a dtype without a flag is
    widened to float32 with a warning (never silently altered)."""
    t = arr._data.detach()
    name = dtype_name(t.dtype)
    if name == "bfloat16" or np.dtype(name) not in _FLAG_OF:
        warnings.warn("dtype %s has no MXNet 1.x .params representation; "
                      "saving as float32 (loads back as float32)" % name,
                      stacklevel=4)
        t = t.to(torch.float32)
    a = t.cpu().numpy()
    return np.ascontiguousarray(a.reshape(1) if a.ndim == 0 else a)


def _save_one(out, arr):
    a = _host(arr)
    out.append(struct.pack("<Ii", _NDARRAY_V2_MAGIC, _STYPE_DEFAULT))
    _write_shape(out, a.shape)
    out.append(struct.pack("<ii", 1, 0))       # Context: kCPU, dev_id 0
    out.append(struct.pack("<i", _FLAG_OF[a.dtype]))
    out.append(a.tobytes())


def save(fname, data):
    """Write arrays (an NDArray, a list, or a name -> array dict) as a
    ``.params`` file (ref: python/mxnet/ndarray/utils.py save).

    The file is published atomically: the bytes go to a temporary file
    beside ``fname``, are flushed and fsync'd, then renamed over it, so a
    crash or a concurrent reader never sees a truncated file; the name maps
    to the old bytes or the new."""
    from .ndarray import NDArray
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    out = [struct.pack("<QQ", _LIST_MAGIC, 0), struct.pack("<Q", len(arrays))]
    for arr in arrays:
        _save_one(out, arr)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode()
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    tmp = "%s.tmp.%d" % (fname, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(b"".join(out))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt):
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_bytes(self, n):
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated .params payload: %d bytes wanted at "
                             "offset %d, %d there" % (n, self.pos, len(b)))
        self.pos += n
        return b

    def read_shape(self):
        ndim = self.read("<I")
        return tuple(self.read("<%dq" % ndim)) if ndim > 1 else (
            (self.read("<q"),) if ndim else ())

    def read_values(self, shape, flag):
        dtype = _DTYPE_OF[flag]
        n = int(np.prod(shape))
        return np.frombuffer(self.read_bytes(n * dtype.itemsize),
                             dtype=dtype).reshape(shape)


def _load_one(r):
    """One record as a numpy array (a copy-free view of the buffer)."""
    magic = r.read("<I")
    if magic != _NDARRAY_V2_MAGIC:
        # V1 / pre-V1 dense records (ref: NDArray::LegacyLoad)
        if magic == _NDARRAY_V1_MAGIC:
            shape = r.read_shape()
        else:                      # pre-V1: the magic is ndim, dims uint32
            ndim = magic
            shape = tuple(r.read("<%dI" % ndim)) if ndim > 1 else (
                (r.read("<I"),) if ndim else ())
        if not shape:
            return np.zeros((0,), np.float32)
        r.read("<ii")                          # context
        return r.read_values(shape, r.read("<i"))
    stype = r.read("<i")
    if stype != _STYPE_DEFAULT:
        raise MXNetError(
            "the .params payload holds a %s array: sparse storage is not "
            "ported yet (ROADMAP item 10)" % _SPARSE.get(stype, stype))
    shape = r.read_shape()
    if not shape:
        # ndim 0 = empty NDArray: nothing else on the stream
        return np.zeros((0,), np.float32)
    r.read("<ii")                              # context
    return r.read_values(shape, r.read("<i"))


def _load_legacy_npz(fileobj):
    """The JAX build's earlier ``.npz`` container (dense entries)."""
    import json
    with np.load(fileobj) as z:
        manifest = json.loads(bytes(z["__manifest__"].tobytes()).decode())
        named = any(e["name"] for e in manifest["entries"])
        pairs = []
        for e in manifest["entries"]:
            if e["stype"] != "default":
                raise MXNetError(
                    "the .npz container holds a %s array: sparse storage is "
                    "not ported yet (ROADMAP item 10)" % e["stype"])
            pairs.append((e["name"], np.array(z["a%d_data" % e["idx"]])))
    return dict(pairs) if named else [a for _, a in pairs]


def load_host(buf):
    """A ``.params`` payload (bytes) parsed to numpy arrays: a name ->
    array dict when the payload names its arrays, else a list."""
    if bytes(buf[:2]) == b"PK":                # zip: the legacy npz container
        import io
        return _load_legacy_npz(io.BytesIO(bytes(buf)))
    r = _Reader(buf)
    magic, _reserved = r.read("<QQ")
    if magic != _LIST_MAGIC:
        raise ValueError("not an MXNet NDArray buffer (bad magic 0x%x)"
                         % magic)
    arrays = [_load_one(r) for _ in range(r.read("<Q"))]
    names = [r.read_bytes(r.read("<Q")).decode()
             for _ in range(r.read("<Q"))]
    return dict(zip(names, arrays)) if names else arrays


def load_buffer(buf):
    """Load a ``.params`` payload straight from bytes, the in-memory twin
    of :func:`load` (ref: MXNDArrayLoadFromBuffer, src/c_api/c_api.cc).
    Arrays land on the current context; 64-bit ints and floats narrow to
    32 bits, as ``nd.array`` and the JAX build do."""
    from .ndarray import array
    host = load_host(buf)
    if isinstance(host, dict):
        return {k: array(v) for k, v in host.items()}
    return [array(v) for v in host]


def load(fname):
    """Load a ``.params`` file (ref: python/mxnet/ndarray/utils.py load)."""
    with open(fname, "rb") as f:
        return load_buffer(f.read())
