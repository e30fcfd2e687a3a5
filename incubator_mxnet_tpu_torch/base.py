"""Shared base utilities for the PyTorch port.

Counterpart of ``incubator_mxnet_tpu/base.py``: the framework's error
type, plus the dtype vocabulary the port needs because numpy (without
``ml_dtypes``) has no ``bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "torch_dtype", "dtype_name", "numpy_dtype"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


_TORCH_DTYPES = {
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(dtype) -> torch.dtype:
    """Any dtype spelling the framework accepts (name, numpy dtype or type,
    ``torch.dtype``) as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError("unsupported dtype %r" % (dtype,)) from None


def dtype_name(dtype) -> str:
    """Canonical name (``"float32"``, ``"bfloat16"``, ...) of a dtype."""
    return _NAMES[torch_dtype(dtype)]


def numpy_dtype(dtype):
    """The numpy dtype of ``dtype``; ``torch.bfloat16`` for bfloat16, which
    numpy cannot represent."""
    t = torch_dtype(dtype)
    if t is torch.bfloat16:
        return t
    return np.dtype(_NAMES[t])
