"""Scoped precision guards for process-wide torch flags.

torch keeps its TF32 switches (``torch.backends.cudnn.allow_tf32`` for
cuDNN's convolutions, ``torch.backends.cuda.matmul.allow_tf32`` for
cuBLAS's products) as process-wide flags.  The port runs some f32 work in
full f32 whatever the caller chose (the JAX build's f32 convolutions and
its ``Precision.HIGHEST`` products), so it turns a flag off around that
work.  A guard that saved and restored the flag per call would let two
threads interleave: one would run in TF32, or leave the flag off for its
caller.  :class:`FlagOff` counts the calls inside it under a lock instead:
the first to enter saves the flag and turns it off, and the last to leave
puts back what the first found.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["FlagOff", "f32_convolutions", "f32_products"]


class FlagOff(object):
    """Turns ``getattr(owner, attr)`` off while any caller of any thread is
    inside ``with guard():``, and restores the value found by the first
    caller once the last one leaves."""

    def __init__(self, owner, attr):
        self._owner = owner
        self._attr = attr
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextmanager
    def __call__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = getattr(self._owner, self._attr)
                setattr(self._owner, self._attr, False)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    setattr(self._owner, self._attr, self._saved)


# cuDNN convolutions in full f32 inside, whatever the caller's TF32 setting
# (torch's default lets cuDNN run an f32 convolution in TF32, a 10-bit
# mantissa; the JAX build's f32 convolution is f32)
f32_convolutions = FlagOff(torch.backends.cudnn, "allow_tf32")

# cuBLAS products in full f32 inside (the JAX build's Precision.HIGHEST)
f32_products = FlagOff(torch.backends.cuda.matmul, "allow_tf32")
