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

import numpy as np
import torch

__all__ = ["FlagOff", "f32_convolutions", "f32_products", "fma_f32",
           "f32_scalar", "f32_reciprocal"]


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


def _fma_value(a, b, c):
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bp = s - cd
    err = (p - bp) + (cd - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full((), float("inf"), dtype=torch.float64, device=s.device)
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, inf, -inf)), s)
    return s.to(torch.float32)


class _FmaFunction(torch.autograd.Function):
    """The fused multiply-add's value with the gradient of a·b + c."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.shapes = (a.shape, b.shape, c.shape)
        return _fma_value(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors

        def fit(t, shape):
            # sum a broadcast gradient back to its input's shape
            while t.dim() > len(shape):
                t = t.sum(0)
            return t.sum(dim=[i for i, n in enumerate(shape) if n == 1],
                         keepdim=True) if t.shape != shape else t

        sa, sb, sc = ctx.shapes
        return (fit(g * b, sa) if ctx.needs_input_grad[0] else None,
                fit(g * a, sb) if ctx.needs_input_grad[1] else None,
                fit(g, sc) if ctx.needs_input_grad[2] else None)


def fma_f32(a, b, c):
    """a·b + c of f32 tensors rounded once to f32, as a fused multiply-add
    (XLA's CPU code, the JAX build's, fuses a multiply into the add that
    reads it; torch rounds the product first).  The product is exact in
    f64; the f64 sum is rounded to odd (an inexact even result moves one
    ulp toward its error, found by TwoSum), and rounding that to f32 is the
    single rounding of the exact value, f64 carrying more than 2·24 + 2
    bits.  Differentiable as a·b + c."""
    return _FmaFunction.apply(a, b, c)


def f32_scalar(value, device):
    """``value`` rounded to f32, a 0-dim tensor made on ``device``.  A
    division by it stays a true division: CUDA multiplies by the
    reciprocal of a host scalar, and torch computes ``scalar / tensor`` as
    ``reciprocal(tensor) * scalar``."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=device)


def f32_reciprocal(value, device):
    """The f32 reciprocal of a constant, for a division by it as the JAX
    build's XLA CPU code computes one (a multiply by the reciprocal rounded
    to f32), where that rounding decides an integer (a bin edge, an int8
    code)."""
    return f32_scalar(np.float32(1) / np.float32(value), device)
