"""Gluon utilities (counterpart of ``incubator_mxnet_tpu/gluon/utils.py``;
ref: python/mxnet/gluon/utils.py): ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1`` and ``download``, which copies a
``file://`` URL and raises for any other, since nothing is downloaded."""
from __future__ import annotations

import hashlib
import os
import shutil
import warnings

import numpy as np
import torch

from .. import ndarray as _nd
from ..base import MXNetError
from ..ndarray import NDArray, invoke
from ..ops.registry import get_op

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` in ``num_slice`` pieces along ``batch_axis``, the last one
    taking the remainder (ref: utils.py split_data)."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d."
            % (str(data.shape), num_slice, batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    bounds = [(i * step, (i + 1) * step if i < num_slice - 1 else size)
              for i in range(num_slice)]
    if batch_axis == 0:
        return [data[b:e] for b, e in bounds]
    return [invoke(get_op("slice_axis"), [data],
                   {"axis": batch_axis, "begin": b, "end": e})
            for b, e in bounds]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` (an NDArray or a host array) and put each piece on one
    context of ``ctx_list`` (ref: utils.py split_and_load)."""
    if not isinstance(data, NDArray):
        data = _nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``, and return the norm before scaling (ref: utils.py
    clip_global_norm).  Each array's sum of squares is taken in f32 on its
    device, the total and its root on the host in float64.  A NaN or an
    infinity warns and leaves the arrays as they are."""
    assert len(arrays) > 0
    total = 0.0
    with torch.no_grad():
        for arr in arrays:
            total += float((arr._data.float() ** 2).sum())
    total_norm = np.sqrt(total)
    if not np.isfinite(total_norm):
        warnings.warn(UserWarning("nan or inf is detected. Clipping results "
                                  "will be undefined."), stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for arr in arrays:
                arr._data.mul_(float(scale))
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 is ``sha1_hash`` (ref: utils.py
    check_sha1)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """The local file for ``url`` (ref: utils.py download): an existing
    file (with the right SHA-1, when given) is kept, a ``file://`` URL is
    copied, and any other URL raises ``MXNetError``: nothing is
    downloaded."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if overwrite or not os.path.exists(fname) or (
            sha1_hash and not check_sha1(fname, sha1_hash)):
        if not url.startswith("file://"):
            raise MXNetError("download(%r): nothing is downloaded; place the "
                             "file at %r" % (url, fname))
        shutil.copyfile(url[len("file://"):], fname)
    return fname
