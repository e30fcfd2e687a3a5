"""Sparse NDArrays: RowSparse and CSR.

Counterpart of ``incubator_mxnet_tpu/ndarray/sparse.py`` (the reference's
python/mxnet/ndarray/sparse.py, src/operator/tensor/cast_storage*,
sparse_retain.cc and dot-inl.h's sparse products).  A sparse array is a
struct of dense NDArrays on its context's device: ``RowSparseNDArray``
holds ``data`` (K, *shape[1:]) and ``indices`` (K,) int64, the occupied
rows; ``CSRNDArray`` holds ``data`` (nnz,), ``indices`` (nnz,) int64
column ids and ``indptr`` (rows + 1,) int64.  No dense buffer of the full
shape is made except where the JAX build densifies: ``todense``, any read
of the array as one tensor (``_data``: an op of the dense registry given a
sparse array, ``asnumpy``), a transposed row-sparse product, and the casts
out of dense storage, which scan the dense operand in bands of rows.

Every result whose shape depends on the data costs one host sync on the
card (``torch.nonzero``, ``torch.unique``): the casts to row-sparse or
CSR, ``retain``, ``elemwise_add`` and the store's ``row_sparse_pull``.
None of them is a registry op, so none is recorded into a bulk segment or
captured into a graph; reading a component of a deferred array flushes
the open segment first (cause ``read``).  Indices come out sorted
ascending, as the JAX build's ``np.where``/``np.nonzero``/``np.unique``
give them.

Products sum through ``torch.segment_reduce`` over sorted segments: CSR ·
dense over the rows (``indptr`` is the offsets), CSRᵀ · dense over the
columns after a stable sort by column (kept on the array).  Each output
element is the sum of its terms in index order, so a card run repeats
exactly.  ``dot`` is differentiable in its dense operand only, as in the
JAX build (``_dense_operand_op``): a sparse array takes no gradient, and
``attach_grad`` on one raises.

Indices given by the caller may repeat or come unsorted.  They are kept
as given (``.indices`` reads them back), and a scatter over them keeps the
last value of a repeated row or (row, column), as the JAX build's scatter
does on the CPU: ``todense``, the casts and the lazy update resolve a
repeat so (``canonical``), never by a scatter whose winner is unspecified.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from ..base import MXNetError, torch_dtype
from ..context import Context, current_context
from ..ops.math import _matmul
from ..ops.registry import get_op
from .ndarray import NDArray, array as _array, invoke

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "cast_storage", "zeros",
           "retain", "dot", "elemwise_add", "add_n"]

# elements of a dense operand a cast scans at once: its mask stays small,
# and torch.nonzero never sees more than 2^31 elements
_BAND = 1 << 28


def _ids(x, device):
    """Row or column ids (an NDArray, numpy or a list) as int64 on
    ``device``."""
    t = x._data if isinstance(x, NDArray) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=torch.int64)


def _host_canonical(keys):
    """Whether host ids are strictly increasing (sorted, no repeat)."""
    keys = np.asarray(keys)
    return bool(np.all(keys[1:] > keys[:-1]))


def check_range(ids, n, what):
    """Raise ``IndexError`` unless every id lies in [0, n): on the card an
    id out of range would fail a device assertion in the gather or scatter
    that uses it.  ``ids`` is numpy or a tensor (a tensor's extremes are
    read on the host: one sync)."""
    if isinstance(ids, torch.Tensor):
        lo, hi = torch.stack([ids.min(), ids.max()]).tolist() \
            if ids.numel() else (0, 0)
    else:
        lo, hi = (int(ids.min()), int(ids.max())) if ids.size else (0, 0)
    if lo < 0 or hi >= n:
        raise IndexError("%s id out of range: [%d, %d] not in [0, %d)"
                         % (what, lo, hi, n))


def _last_of_each(keys):
    """(each key once, ascending; the position of its last occurrence)."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    pos = torch.arange(keys.numel(), device=keys.device)
    last = torch.full((uniq.numel(),), -1, dtype=torch.int64,
                      device=keys.device)
    return uniq, last.scatter_reduce_(0, inv, pos, "amax")


def _bands(n_rows, row_elems):
    """[start, stop) row bands of at most ``_BAND`` elements."""
    step = max(1, _BAND // max(1, row_elems))
    return [(b, min(b + step, n_rows)) for b in range(0, n_rows, step)]


def _nonzero_rows(t):
    """Ids (ascending) of the rows of ``t`` holding a nonzero value."""
    n = t.shape[0]
    flat = t.reshape(n, -1)
    if flat.shape[1] == 0:
        return torch.zeros(0, dtype=torch.int64, device=t.device)
    masks = [(flat[a:b] != 0).any(1) for a, b in _bands(n, flat.shape[1])]
    mask = torch.cat(masks) if masks else torch.zeros(0, dtype=torch.bool,
                                                      device=t.device)
    return torch.nonzero(mask).reshape(-1)


def _nonzero_2d(t):
    """(rows, cols) of the nonzeros of a 2-D ``t``, row-major order."""
    rows, cols = [], []
    for a, b in _bands(t.shape[0], t.shape[1]):
        nz = torch.nonzero(t[a:b])
        rows.append(nz[:, 0] + a)
        cols.append(nz[:, 1])
    if not rows:
        empty = torch.zeros(0, dtype=torch.int64, device=t.device)
        return empty, empty
    return torch.cat(rows), torch.cat(cols)


def _indptr(rows, n_rows):
    """CSR row offsets of sorted row ids ``rows``."""
    counts = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    counts.index_add_(0, rows + 1, torch.ones_like(rows))
    return torch.cumsum(counts, 0)


class BaseSparseNDArray(NDArray):
    """What RowSparseNDArray and CSRNDArray share (ref: sparse.py
    BaseSparseNDArray): shape, dtype and context come from the
    components; any read of the values as one tensor densifies; writes
    raise ``TypeError``, as in the JAX build."""

    def __init__(self, shape, ctx=None):
        self._shape = tuple(int(s) for s in shape)
        self._ctx = ctx if ctx is not None else current_context()

    # the dense view every NDArray code path reads (ndarray.invoke, the
    # engine, asnumpy): the full tensor, made on each read
    @property
    def _slot(self):
        return self._dense()

    @_slot.setter
    def _slot(self, value):
        raise TypeError("in-place writes on sparse NDArray are not supported")

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def size(self):
        return int(np.prod(self._shape))

    @property
    def dtype(self):
        return self.data.dtype

    def _components(self):
        raise NotImplementedError

    def _dense(self):
        raise NotImplementedError

    def todense(self):
        """The values as a dense NDArray on this array's context."""
        return NDArray(self._dense(), ctx=self._ctx)

    def asnumpy(self):
        return self.todense().asnumpy()

    def tostype(self, stype):
        """``'default'`` densifies, this array's own type returns it, the
        other sparse type casts (``cast_storage``)."""
        if stype == "default":
            return self.todense()
        if stype == self.stype:
            return self
        return cast_storage(self, stype)

    def attach_grad(self, grad_req="write", stype=None):
        raise MXNetError(
            "a %s array takes no gradient: sparse products differentiate "
            "their dense operand only (dot-inl.h); attach the gradient to a "
            "dense array (tostype('default'))" % self.stype)

    def wait_to_read(self):
        for c in self._components():
            c.wait_to_read()

    def __setitem__(self, key, value):
        raise TypeError("in-place writes on sparse NDArray are not supported")

    def _inplace(self, other, op_name, scalar_op):
        raise TypeError("in-place writes on sparse NDArray are not supported")

    def copyto(self, other):
        """Into a dense NDArray: its values densified; to a Context: a copy
        of the components there."""
        if isinstance(other, Context):
            return self._rebuild([c.copyto(other) for c in
                                  self._components()], other)
        if isinstance(other, BaseSparseNDArray):
            raise TypeError("in-place writes on sparse NDArray are not "
                            "supported")
        return self.todense().copyto(other)

    def _rebuild(self, comps, ctx):
        raise NotImplementedError

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(str(s) for s in self._shape),
                                  self._ctx)


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse storage: ``indices`` (K,) the occupied rows, ``data``
    (K, *shape[1:]) their values (ref: sparse.py RowSparseNDArray; the
    sparse gradient of a weight and the value of ``row_sparse_pull``).
    ``canonical``: the indices are known sorted and unique (True for every
    array this module makes)."""

    def __init__(self, data, indices, shape, ctx=None, canonical=None):
        super().__init__(shape, ctx=ctx)
        self.data = data
        self.indices = indices
        self.canonical = canonical

    @property
    def stype(self):
        return "row_sparse"

    def _components(self):
        return [self.data, self.indices]

    def _rebuild(self, comps, ctx):
        return RowSparseNDArray(comps[0], comps[1], self._shape, ctx,
                                self.canonical)

    def _canonical_parts(self):
        """(indices sorted unique, their rows): a repeated row keeps its
        last value."""
        data, idx = self.data._data, self.indices._data.to(torch.int64)
        if self.canonical or idx.numel() == 0:
            return idx, data
        uniq, last = _last_of_each(idx)
        return uniq, data[last]

    def _dense(self):
        idx, data = self._canonical_parts()
        out = torch.zeros(self._shape, dtype=data.dtype, device=data.device)
        if idx.numel():
            out.index_copy_(0, idx.to(data.device), data)
        return out

    def retain(self, row_ids):
        return retain(self, row_ids)


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows (ref: sparse.py CSRNDArray): row ``i``'s
    column ids are ``indices[indptr[i]:indptr[i+1]]`` and its values the
    same slice of ``data``.  ``canonical``: each row's column ids are known
    strictly increasing."""

    def __init__(self, data, indices, indptr, shape, ctx=None,
                 canonical=None):
        super().__init__(shape, ctx=ctx)
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.canonical = canonical
        self._rows = None       # row id per stored value
        self._csc = None        # (stable sort by column, column offsets)

    @property
    def stype(self):
        return "csr"

    def _components(self):
        return [self.data, self.indices, self.indptr]

    def _rebuild(self, comps, ctx):
        return CSRNDArray(comps[0], comps[1], comps[2], self._shape, ctx,
                          self.canonical)

    def row_ids(self):
        """The row of every stored value, from ``indptr`` (no host sync)."""
        if self._rows is None:
            ptr = self.indptr._data.to(torch.int64)
            self._rows = torch.repeat_interleave(
                torch.arange(self._shape[0], device=ptr.device),
                torch.diff(ptr), output_size=self.data.shape[0])
        return self._rows

    def by_column(self):
        """(the stable order of the stored values by column, the column
        offsets into it): the transposed product's segments."""
        if self._csc is None:
            col = self.indices._data.to(torch.int64)
            self._csc = (torch.argsort(col, stable=True),
                         _indptr(col, self._shape[1]))
        return self._csc

    def _canonical_parts(self):
        """(rows, cols, values) with each (row, column) once, row-major: a
        repeated pair keeps its last value."""
        data = self.data._data
        row, col = self.row_ids(), self.indices._data.to(torch.int64)
        if self.canonical or col.numel() == 0:
            return row, col, data
        n = self._shape[1]
        uniq, last = _last_of_each(row * n + col)
        return uniq // n, uniq % n, data[last]

    def _dense(self):
        row, col, data = self._canonical_parts()
        out = torch.zeros(self._shape, dtype=data.dtype, device=data.device)
        if data.numel():
            out[row, col] = data
        return out

    def __getitem__(self, key):
        """Contiguous row slices stay CSR (ref: sparse.py
        CSRNDArray.__getitem__; reads ``indptr`` on the host)."""
        if isinstance(key, int):
            if key < 0:
                key += self._shape[0]
            if not 0 <= key < self._shape[0]:
                raise IndexError(
                    "index %r is out of bounds for axis 0 with size %d"
                    % (key, self._shape[0]))
            key = slice(key, key + 1)
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise ValueError("CSRNDArray only supports contiguous row "
                             "slicing, got %r" % (key,))
        start, stop, _ = key.indices(self._shape[0])
        stop = max(start, stop)
        ptr = self.indptr._data
        lo, hi = (int(v) for v in ptr[[start, stop]].tolist())
        return CSRNDArray(
            NDArray(self.data._data[lo:hi].clone(), ctx=self._ctx),
            NDArray(self.indices._data[lo:hi].clone(), ctx=self._ctx),
            NDArray(ptr[start:stop + 1] - lo, ctx=self._ctx),
            (stop - start, self._shape[1]), self._ctx, self.canonical)


def _component(x, ctx, dtype):
    if isinstance(x, NDArray):
        return x if dtype is None else x.astype(dtype)
    return _array(np.asarray(x), ctx=ctx, dtype=dtype)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """ref: sparse.py row_sparse_array: from ``(data, indices)`` (``shape``
    required; ids are kept as given) or from a dense source."""
    ctx = ctx or current_context()
    if isinstance(arg1, tuple) and len(arg1) == 2:
        if shape is None:
            raise ValueError("shape required when building from (data, "
                             "indices)")
        data, indices = arg1
        host = None if isinstance(indices, NDArray) else np.asarray(indices)
        check_range(indices._data if host is None else host, shape[0], "row")
        return RowSparseNDArray(
            _component(data, ctx, dtype),
            _component(indices if host is None else host, ctx, np.int64),
            tuple(shape), ctx,
            None if host is None else _host_canonical(host))
    src = arg1.asnumpy() if isinstance(arg1, NDArray) else np.asarray(arg1)
    return cast_storage(_array(src, ctx=ctx, dtype=dtype), "row_sparse")


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """ref: sparse.py csr_matrix: from ``(data, indices, indptr)``
    (``shape`` required) or from a dense source."""
    ctx = ctx or current_context()
    if isinstance(arg1, tuple) and len(arg1) == 3:
        if shape is None:
            raise ValueError("shape required")
        data, indices, indptr = arg1
        canonical = None
        check_range(indices._data if isinstance(indices, NDArray) else
                    np.asarray(indices), shape[1], "column")
        if not isinstance(indices, NDArray) and \
                not isinstance(indptr, NDArray):
            indices, indptr = np.asarray(indices), np.asarray(indptr)
            # strictly increasing within each row: a decrease is allowed
            # only where a row starts
            step = np.diff(indices) > 0
            starts = np.asarray(indptr[1:-1], np.int64) - 1
            starts = starts[(starts >= 0) & (starts < step.size)]
            step[starts] = True
            canonical = bool(step.all())
        return CSRNDArray(_component(data, ctx, dtype),
                          _component(indices, ctx, np.int64),
                          _component(indptr, ctx, np.int64),
                          tuple(shape), ctx, canonical)
    src = arg1.asnumpy() if isinstance(arg1, NDArray) else np.asarray(arg1)
    return cast_storage(_array(src, ctx=ctx, dtype=dtype), "csr")


def _rsp_of_rows(values, rows, shape, ctx):
    return RowSparseNDArray(NDArray(values, ctx=ctx), NDArray(rows, ctx=ctx),
                            shape, ctx, True)


def _csr_of(rows, cols, values, shape, ctx):
    return CSRNDArray(NDArray(values, ctx=ctx), NDArray(cols, ctx=ctx),
                      NDArray(_indptr(rows, shape[0]), ctx=ctx), shape, ctx,
                      True)


def cast_storage(arr, stype):
    """ref: src/operator/tensor/cast_storage.cc: between ``'default'``,
    ``'row_sparse'`` and ``'csr'``.  A cast to a sparse type keeps the rows
    (or elements) holding a nonzero value, in ascending order, as the JAX
    build's does through a dense copy; here a sparse source converts
    without one."""
    if stype == "default":
        return arr.todense() if isinstance(arr, BaseSparseNDArray) else arr
    if stype not in ("row_sparse", "csr"):
        raise ValueError("unknown stype %r" % (stype,))
    shape, ctx = tuple(arr.shape), arr.context
    if stype == "csr" and len(shape) != 2:
        raise ValueError("csr requires 2-D")
    if isinstance(arr, CSRNDArray):
        row, col, val = arr._canonical_parts()
        keep = torch.nonzero(val != 0).reshape(-1)
        row, col, val = row[keep], col[keep], val[keep]
        if stype == "csr":
            return _csr_of(row, col, val, shape, ctx)
        rows = torch.unique(row)
        out = torch.zeros((rows.numel(), shape[1]), dtype=val.dtype,
                          device=val.device)
        out[torch.searchsorted(rows, row), col] = val
        return _rsp_of_rows(out, rows, shape, ctx)
    if isinstance(arr, RowSparseNDArray):
        idx, data = arr._canonical_parts()
        keep = _nonzero_rows(data)
        idx, data = idx[keep], data[keep]
        if stype == "row_sparse":
            return _rsp_of_rows(data, idx, shape, ctx)
        local, col = _nonzero_2d(data)
        return _csr_of(idx[local], col, data[local, col], shape, ctx)
    t = arr._data.detach()
    if stype == "row_sparse":
        rows = _nonzero_rows(t)
        return _rsp_of_rows(t.index_select(0, rows), rows, shape, ctx)
    row, col = _nonzero_2d(t)
    return _csr_of(row, col, t[row, col], shape, ctx)


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An empty sparse array (ref: sparse.py zeros)."""
    ctx = ctx or current_context()
    dev, dt = ctx.torch_device(), torch_dtype(dtype)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    shape = tuple(shape)
    if stype == "row_sparse":
        return _rsp_of_rows(torch.zeros((0,) + shape[1:], dtype=dt,
                                        device=dev), none, shape, ctx)
    if stype == "csr":
        return _csr_of(none, none, torch.zeros(0, dtype=dt, device=dev),
                       shape, ctx)
    raise ValueError("unknown stype %r" % (stype,))


def retain(arr, row_ids):
    """The rows of ``arr`` whose ids are in ``row_ids``, in ``arr``'s order
    (ref: src/operator/tensor/sparse_retain.cc)."""
    if not isinstance(arr, RowSparseNDArray):
        raise TypeError("retain expects RowSparseNDArray")
    have = arr.indices._data.to(torch.int64)
    keep = torch.nonzero(torch.isin(have, _ids(row_ids, have.device)))
    keep = keep.reshape(-1)
    return RowSparseNDArray(NDArray(arr.data._data[keep], ctx=arr._ctx),
                            NDArray(have[keep], ctx=arr._ctx), arr.shape,
                            arr._ctx, arr.canonical)


# ---------------------------------------------------------------------------
# products (ref: dot-inl.h's csr and row-sparse kernels)
# ---------------------------------------------------------------------------

def csr_mm(csr, rhs, transpose=False):
    """``csr · rhs`` ((m, k) · (k, n) -> (m, n)), or ``csrᵀ · rhs`` ((m, k)ᵀ
    · (m, n) -> (k, n)) with ``transpose``: each output row the sum, in
    index order, of its terms ``value · rhs[row]``."""
    data = csr.data._data
    if not transpose:
        terms = data[:, None] * rhs[csr.indices._data.to(torch.int64)]
        offsets = csr.indptr._data.to(torch.int64)
    else:
        perm, offsets = csr.by_column()
        terms = data[perm, None] * rhs[csr.row_ids()[perm]]
    return torch.segment_reduce(terms, "sum", offsets=offsets, axis=0)


class _CsrDot(torch.autograd.Function):
    """``csr_mm`` differentiable in its dense operand (the JAX build's
    ``_csr_matmul`` and ``_csr_matmul_bwd``): the gradient of ``csr · r``
    is ``csrᵀ · g``, and the other way round."""

    @staticmethod
    def forward(ctx, rhs, csr, transpose):
        ctx.csr, ctx.transpose = csr, transpose
        return csr_mm(csr, rhs, transpose)

    @staticmethod
    def backward(ctx, g):
        return csr_mm(ctx.csr, g.contiguous(), not ctx.transpose), None, None


def _csr_dot(csr, r, transpose):
    vector = r.ndim == 1
    out = _CsrDot.apply(r[:, None] if vector else r, csr, transpose)
    return out[:, 0] if vector else out


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (ref: dot-inl.h; ``mx.nd.sparse.dot``): CSR · dense,
    CSRᵀ · dense, row-sparse · dense, dense · CSR (as the transpose of
    CSRᵀ · denseᵀ); a transposed row-sparse operand and a row-sparse right
    operand densify, as in the JAX build; dense · dense is the ``dot`` op.
    Under ``autograd.record()`` the dense operand gets its gradient."""
    if not isinstance(lhs, BaseSparseNDArray) and \
            not isinstance(rhs, BaseSparseNDArray):
        return invoke(get_op("dot"), [lhs, rhs],
                      {"transpose_a": transpose_a,
                       "transpose_b": transpose_b})
    if isinstance(rhs, RowSparseNDArray) or (
            isinstance(lhs, RowSparseNDArray) and
            (transpose_a or transpose_b or isinstance(rhs, CSRNDArray))):
        lhs = lhs.todense() if isinstance(lhs, RowSparseNDArray) else lhs
        rhs = rhs.todense() if isinstance(rhs, RowSparseNDArray) else rhs
        return dot(lhs, rhs, transpose_a, transpose_b)
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        return dot(lhs, rhs.todense(), transpose_a, transpose_b)
    ctx = lhs.context
    with torch.set_grad_enabled(autograd.is_recording()):
        if isinstance(lhs, CSRNDArray):
            r = rhs._data.t() if transpose_b else rhs._data
            out = _csr_dot(lhs, r, transpose_a)
        elif isinstance(lhs, RowSparseNDArray):
            idx, ldata = lhs._canonical_parts()
            r = rhs._data
            prod = _matmul(ldata.reshape(ldata.shape[0], -1), r)
            out = torch.zeros((lhs.shape[0],) + tuple(prod.shape[1:]),
                              dtype=prod.dtype, device=prod.device)
            out = out.index_copy(0, idx.to(prod.device), prod)
        else:
            # op(dense) · op(csr) = (op(csr)ᵀ · op(dense)ᵀ)ᵀ
            lt = lhs._data if transpose_a else lhs._data.t()
            out = _csr_dot(rhs, lt, not transpose_b).t()
            ctx = lhs.context
    return NDArray(out.contiguous(), ctx=ctx)


def elemwise_add(lhs, rhs):
    """row-sparse + row-sparse stays row-sparse: the union of the rows, a
    repeated row summed in index order (ref: elemwise_binary_op's
    FComputeEx); any other pair adds densely."""
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        idx = torch.cat([lhs.indices._data, rhs.indices._data.to(
            lhs.indices._data.device)]).to(torch.int64)
        vals = torch.cat([lhs.data._data, rhs.data._data.to(
            lhs.data._data.device)])
        uniq, inv, counts = torch.unique(idx, return_inverse=True,
                                         return_counts=True)
        order = torch.argsort(inv, stable=True)
        offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        summed = torch.segment_reduce(vals[order], "sum", offsets=offsets,
                                      axis=0)
        return _rsp_of_rows(summed, uniq, lhs.shape, lhs.context)
    a = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return a + b


def add_n(*arrays):
    """The sum of ``arrays`` in order, row-sparse while every operand is
    (ref: elemwise_sum's FComputeEx)."""
    acc = arrays[0]
    for a in arrays[1:]:
        acc = elemwise_add(acc, a)
    return acc
