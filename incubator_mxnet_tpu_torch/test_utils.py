"""Test helpers (counterpart of ``incubator_mxnet_tpu/test_utils.py``; ref:
python/mxnet/test_utils.py).

``default_context`` (``MXTPU_TEST_CTX``/``MXNET_TEST_CTX`` and
``MXTPU_TEST_DEVICE_ID``, else the current context), ``assert_almost_equal``
with tolerances by dtype, ``rand_ndarray`` (dense, row-sparse or CSR),
``check_numeric_gradient`` (central differences against
the autograd tape) and ``check_consistency`` (the CPU against the card when
there is one).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import autograd
from .context import Context, cpu, current_context, gpu
from .ndarray import NDArray, array, sparse

__all__ = ["default_context", "default_dtype", "assert_almost_equal", "same",
           "rand_shape_nd", "rand_ndarray", "numeric_grad",
           "check_numeric_gradient", "check_consistency", "simple_forward"]


def default_context():
    """The context tests run on: ``MXTPU_TEST_CTX`` (or ``MXNET_TEST_CTX``)
    with ``MXTPU_TEST_DEVICE_ID`` when set, else the current context."""
    name = os.environ.get("MXTPU_TEST_CTX", os.environ.get("MXNET_TEST_CTX"))
    if name is None:
        return current_context()
    return Context(name, int(os.environ.get("MXTPU_TEST_DEVICE_ID", "0")))


def default_dtype():
    return np.float32


_DTYPE_TOL = {
    np.dtype(np.float16): (1e-1, 1e-1),
    np.dtype(np.float32): (1e-3, 1e-4),
    np.dtype(np.float64): (1e-5, 1e-7),
}


def _tols(a, b, rtol, atol):
    if rtol is None or atol is None:
        r, t = _DTYPE_TOL.get(np.promote_types(a.dtype, b.dtype), (1e-3, 1e-4))
        return rtol or r, atol or t
    return rtol, atol


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    """ref: test_utils.py assert_almost_equal; tolerances by dtype when not
    given."""
    if isinstance(a, NDArray):
        a = a.asnumpy()
    if isinstance(b, NDArray):
        b = b.asnumpy()
    a = np.asarray(a)
    b = np.asarray(b)
    rtol, atol = _tols(a, b, rtol, atol)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                               err_msg="%s vs %s mismatch" % names)


def same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, stype="default", density=None, dtype=np.float32,
                 ctx=None, scale=1.0):
    """An array of uniform draws in [-scale, scale) from numpy's global
    generator (ref: test_utils.py rand_ndarray).  ``'row_sparse'`` or
    ``'csr'``: each element kept with probability ``density`` (default
    0.3; a second draw of the same shape decides), then cast to that
    storage type."""
    ctx = ctx or default_context()
    a = np.random.uniform(-scale, scale, shape).astype(dtype)
    if stype == "default":
        return array(a, ctx=ctx)
    if stype not in ("row_sparse", "csr"):
        raise ValueError(stype)
    density = 0.3 if density is None else density
    a = a * (np.random.rand(*shape) < density)
    return sparse.cast_storage(array(a, ctx=ctx), stype)


def numeric_grad(f, inputs, eps=1e-2):
    """Central finite differences of ``f(*inputs).sum()`` with respect to
    each input, each point evaluated in f32 on the inputs' context."""
    grads = []
    ctx = inputs[0].context
    base_inputs = [x.asnumpy().astype(np.float64) for x in inputs]
    for x0 in base_inputs:
        g = np.zeros_like(x0)
        flat = x0.reshape(-1)
        gflat = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = _eval_scalar(f, base_inputs, ctx)
            flat[j] = orig - eps
            fm = _eval_scalar(f, base_inputs, ctx)
            flat[j] = orig
            gflat[j] = (fp - fm) / (2 * eps)
        grads.append(g)
    return grads


def _eval_scalar(f, np_inputs, ctx):
    nds = [array(x.astype(np.float32), ctx=ctx) for x in np_inputs]
    return float(f(*nds).asnumpy().sum())


def check_numeric_gradient(f, inputs, rtol=5e-2, atol=5e-2, eps=1e-2):
    """ref: test_utils.py check_numeric_gradient: the tape's gradients of
    ``f(*inputs).sum()`` against central differences."""
    for x in inputs:
        x.attach_grad()
    with autograd.record():
        s = f(*inputs).sum()
    s.backward()
    analytic = [x.grad.asnumpy() for x in inputs]
    numeric = numeric_grad(f, inputs, eps=eps)
    for i, (a, n) in enumerate(zip(analytic, numeric)):
        np.testing.assert_allclose(a, n, rtol=rtol, atol=atol,
                                   err_msg="gradient mismatch for input %d" % i)


def check_consistency(f, inputs_np, ctxs=None, rtol=None, atol=None):
    """ref: test_utils.py check_consistency: ``f`` on the same inputs on
    every context of ``ctxs`` (the CPU, and the card when there is one)
    agrees with its result on the first.  Returns the outputs."""
    if ctxs is None:
        ctxs = [cpu(0)] + ([gpu(0)] if torch.cuda.is_available() else [])
    outs = []
    for ctx in ctxs:
        nds = [array(x, ctx=ctx) for x in inputs_np]
        outs.append(f(*nds).asnumpy())
    for o in outs[1:]:
        assert_almost_equal(outs[0], o, rtol, atol)
    return outs


def simple_forward(op_fn, *np_inputs, **params):
    """``op_fn`` on f32 copies of ``np_inputs`` on the default context, as
    numpy."""
    nds = [array(np.asarray(x, np.float32), ctx=default_context())
           for x in np_inputs]
    return op_fn(*nds, **params).asnumpy()
