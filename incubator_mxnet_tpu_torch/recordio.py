"""RecordIO: record-packed binary dataset files.

Counterpart of ``incubator_mxnet_tpu/recordio.py`` (ref:
python/mxnet/recordio.py over dmlc-core's RecordIO framing):

  [kMagic:4B][cflag:3bits|length:29bits:4B][payload][pad to 4B]

Files are byte-identical with the JAX build's, ``.rec`` and ``.idx``.  With
``MXTPU_NATIVE_IO`` on (the default) records are framed by the C++ library
of ``src/io/recordio.cc`` (``_native.py``), which is built at first use; a
failed build raises.  ``MXTPU_NATIVE_IO=0`` frames them in Python.
"""
from __future__ import annotations

import numbers
import os
import struct
import threading
from collections import namedtuple

import numpy as np

from . import _native
from . import config as _config
from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_kMagic = 0xced7230a
_MAX_REC_LEN = (1 << 29) - 1   # 29-bit length field (dmlc recordio)


def _encode_lrec(cflag, length):
    return (cflag << 29) | length


def _decode_lrec(lrec):
    return lrec >> 29, lrec & ((1 << 29) - 1)


def cv2_module(what):
    """OpenCV, imported when a path needs it; ``MXNetError`` naming OpenCV
    (and ``what`` needed it) when it is not installed."""
    try:
        import cv2
    except ImportError as exc:
        raise MXNetError(
            "%s needs OpenCV (the cv2 module), which is not installed (%s); "
            "raw uint8 records (decode='raw') need no decoder" % (what, exc))
    return cv2


class MXRecordIO(object):
    """Sequential record reader/writer (ref: recordio.py class MXRecordIO →
    dmlc::RecordIOWriter/Reader)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        use_native = _config.get_bool("NATIVE_IO", True)
        if self.flag == "w":
            self.writable = True
            self.handle = (_native.NativeRecordWriter(self.uri) if use_native
                           else open(self.uri, "wb"))
        elif self.flag == "r":
            self.writable = False
            self.handle = (_native.NativeRecordReader(self.uri) if use_native
                           else open(self.uri, "rb"))
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self._native_handle = use_native
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        """Override pickling behavior (ref: recordio.py __getstate__)."""
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("handle", None)
        d.pop("_lock", None)
        d.pop("fidx", None)
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        self.handle = None
        if "idx_path" in d:
            self._lock = threading.Lock()
            self.fidx = None
        is_open = d.get("is_open", False)
        self.is_open = False
        if is_open:
            self.open()

    def close(self):
        if not self.is_open:
            return
        self.handle.close()
        self.is_open = False

    def reset(self):
        """ref: recordio.py reset."""
        self.close()
        self.open()

    def write(self, buf):
        """Write one record (ref: MXRecordIOWriterWriteRecord); payloads
        above the 29-bit length field split into begin (1), middle (2) and
        end (3) parts, the dmlc convention both readers join."""
        assert self.writable
        data = bytes(buf)
        if self._native_handle:
            self.handle.write(data)     # framing done in C++
            return

        def emit(cflag, view):
            self.handle.write(struct.pack("<II", _kMagic,
                                          _encode_lrec(cflag, len(view))))
            self.handle.write(view)
            pad = (4 - len(view) % 4) % 4
            if pad:
                self.handle.write(b"\x00" * pad)

        if len(data) <= _MAX_REC_LEN:
            emit(0, data)
            return
        mv = memoryview(data)
        off = 0
        while off < len(data):
            n = min(_MAX_REC_LEN, len(data) - off)
            cflag = 1 if off == 0 else (3 if off + n >= len(data) else 2)
            emit(cflag, mv[off:off + n])
            off += n

    def _read_part(self):
        head = self.handle.read(8)
        if len(head) < 8:
            return None, None
        magic, lrec = struct.unpack("<II", head)
        if magic != _kMagic:
            raise IOError("Invalid RecordIO magic in %s" % self.uri)
        cflag, length = _decode_lrec(lrec)
        data = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return cflag, data

    def read(self):
        """Read one record, or None at EOF (ref: MXRecordIOReaderReadRecord);
        the parts of a split record are joined."""
        assert not self.writable
        if self._native_handle:
            return self.handle.read()
        cflag, data = self._read_part()
        if cflag is None:
            return None
        while cflag in (1, 2):          # begin or middle of a split record
            cflag, part = self._read_part()
            if cflag is None:
                raise IOError("RecordIO file %s ends inside a split record"
                              % self.uri)
            data += part
        return data

    def tell(self):
        return self.handle.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records through an index file (ref: recordio.py
    MXIndexedRecordIO; idx lines "key\\tposition\\n").  ``read_idx`` is
    safe under threads: one handle, its seek and read under a lock."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        self._lock = threading.Lock()
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    key = self.key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)
        if self.writable:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None and not self.fidx.closed:
            self.fidx.close()

    def seek(self, idx):
        """ref: recordio.py seek."""
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        """ref: recordio.py read_idx."""
        with self._lock:
            self.seek(idx)
            return self.read()

    def write_idx(self, idx, buf):
        """ref: recordio.py write_idx."""
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# the header in front of each record's payload (ref: recordio.py IRHeader:
# struct IRHeader {flag, label, id, id2})
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """A header and raw bytes as one record payload (ref: recordio.py pack;
    a label that is not a number is appended as ``flag`` float32s)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        packed = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                             header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        packed = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                             header.id2) + label.tobytes()
    return packed + s


def unpack(s):
    """Inverse of pack (ref: recordio.py unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an image and its header into a record with OpenCV (ref:
    recordio.py pack_img)."""
    cv2 = cv2_module("recordio.pack_img")
    if img_fmt in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    else:
        encode_params = None
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    assert ret, "failed to encode image"
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """Decode a packed image record with OpenCV (ref: recordio.py
    unpack_img)."""
    cv2 = cv2_module("recordio.unpack_img")
    header, s = unpack(s)
    img = np.frombuffer(s, dtype=np.uint8)
    img = cv2.imdecode(img, iscolor)
    return header, img
