"""Device/Context model (counterpart of ``incubator_mxnet_tpu/context.py``).

``gpu(i)`` is a real CUDA device again (devtype 2, as in the reference) and
maps to ``torch.device("cuda", i)``; ``tpu(i)`` is kept as an alias of
``gpu(i)`` so JAX-era scripts still read.  The default context is
``gpu(0)``, with no silent fallback to the CPU: asking a GPU context for its
device when CUDA is absent raises ``MXNetError`` naming the device, so a
caller that wants the CPU says ``mx.cpu()``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_devices"]


class Context:
    """Execution device. devtype: 'cpu' (1) or 'gpu' (2); 'tpu' aliases 'gpu'."""

    _local = threading.local()
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_type, self.device_id = device_type.device_type, device_type.device_id
        else:
            if device_type == "tpu":
                device_type = "gpu"
            if device_type not in self.devstr2type:
                raise ValueError("unknown device type %r" % (device_type,))
            self.device_type = device_type
            self.device_id = int(device_id)

    @property
    def device_typeid(self):
        return self.devstr2type[self.device_type]

    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names; raises ``MXNetError``
        for a GPU context the process cannot reach."""
        if self.device_type != "gpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "context %s needs a CUDA device, but CUDA is not available "
                "in this process; pass ctx=mx.cpu() (or use `with mx.cpu():`) "
                "to run on the CPU" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("context %s: only %d CUDA devices available"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    @staticmethod
    def from_torch_device(device: torch.device) -> "Context":
        if device.type == "cuda":
            return Context("gpu", 0 if device.index is None else device.index)
        return Context("cpu", 0)

    def __eq__(self, other):
        return (
            isinstance(other, Context)
            and self.device_type == other.device_type
            and self.device_id == other.device_id
        )

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    def __str__(self):
        return self.__repr__()

    def __enter__(self):
        if not hasattr(Context._local, "stack"):
            Context._local.stack = []
        Context._local.stack.append(self)
        return self

    def __exit__(self, *args):
        Context._local.stack.pop()

    @staticmethod
    def default_ctx():
        """The card: ``gpu(0)``, whether or not CUDA is present."""
        return Context("gpu", 0)


def current_context():
    if getattr(Context._local, "stack", None):
        return Context._local.stack[-1]
    return Context.default_ctx()


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Alias of :func:`gpu`, so scripts written for the JAX build still run."""
    return Context("gpu", device_id)


def num_devices(device_type="gpu"):
    """Devices of ``device_type`` this process can address: the CUDA
    devices for ``"gpu"`` (and its alias ``"tpu"``), one for the CPU."""
    if device_type in ("cpu", "cpu_pinned", "cpu_shared"):
        return 1
    if device_type not in ("gpu", "tpu"):
        raise ValueError("unknown device type %r" % (device_type,))
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
