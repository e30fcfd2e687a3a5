"""Shape-manipulation, indexing, ordering and sequence operators.

Counterpart of ``incubator_mxnet_tpu/ops/tensor.py``: every op it
registers except the engine's ``_bulk_view_*`` (:108, :120; ROADMAP item
5) and the sparse storage twins ``_cast_storage_dense``/
``_sparse_retain_dense`` (:454, :465; item 10); the creation ops are in
``init_ops.py``.  Many ops return
torch views; ``ndarray.invoke`` copies them so results never alias
inputs.  Indices follow the JAX build: a float index truncates
(NaN as 0), and an index out of range clips, wraps or fills as the JAX
op's mode does, elementwise on the device, so no op here waits for the
card.  The ordering ops are stable, with ties in the JAX build's order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .math import _norm_axis, _sum, weak_scalar
from .registry import register


def infer_reshape(src_shape, target, reverse=False):
    """MXNet Reshape special codes (ref: matrix_op-inl.h ReshapeParam docs):

    0 = copy this dim; -1 = infer; -2 = copy all remaining dims;
    -3 = merge next two dims; -4 = split next dim by the following two values.
    """
    src = list(src_shape)
    tgt = list(target)
    if reverse:
        src = src[::-1]
        tgt = [t for t in tgt[::-1]]
        # -4's two split factors travel with it; reversing swaps them
        out = infer_reshape(src, tgt, reverse=False)
        return tuple(out[::-1])
    out = []
    i = 0  # index into src
    j = 0
    while j < len(tgt):
        t = tgt[j]
        if t == 0:
            out.append(src[i]); i += 1
        elif t == -1:
            out.append(-1); i += 1  # placeholder; src cursor advance is heuristic
        elif t == -2:
            out.extend(src[i:]); i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif t == -4:
            a, b = tgt[j + 1], tgt[j + 2]
            d = src[i]
            if a == -1:
                a = d // b
            if b == -1:
                b = d // a
            out.extend([a, b]); i += 1; j += 2
        else:
            out.append(t)
            # advance src cursor heuristically (only matters for 0/-1 codes)
            if i < len(src):
                i += 1
        j += 1
    known = 1
    for d in out:
        if d != -1:
            known *= d
    total = int(np.prod(src_shape)) if src_shape else 1
    return tuple(d if d != -1 else total // max(known, 1) for d in out)


def checked_reshape(src_shape, target, reverse=False):
    """:func:`infer_reshape`, raising ``ValueError`` when the element count
    changes."""
    new_shape = infer_reshape(src_shape, target, reverse)
    size = int(np.prod(src_shape)) if src_shape else 1
    if int(np.prod(new_shape)) != size:
        raise ValueError("cannot reshape %s into %s" % (tuple(src_shape),
                                                        new_shape))
    return new_shape


@register("Reshape", num_inputs=1, aliases=("reshape",))
def _reshape(data, shape=(), reverse=False):
    """ref: src/operator/tensor/matrix_op.cc Reshape"""
    return data.reshape(checked_reshape(data.shape, shape, reverse))


@register("Flatten", num_inputs=1, aliases=("flatten",))
def _flatten(data):
    """ref: matrix_op.cc Flatten: every axis after the first into one."""
    return data.reshape(data.shape[0], -1)


@register("transpose", num_inputs=1)
def _transpose(data, axes=()):
    """ref: matrix_op.cc transpose (no axes: reverse them all)"""
    return data.permute(*(axes if axes else range(data.ndim - 1, -1, -1)))


@register("expand_dims", num_inputs=1)
def _expand_dims(data, axis=0):
    return data.unsqueeze(axis)


@register("squeeze", num_inputs=1)
def _squeeze(data, axis=None):
    """ref: matrix_op.cc squeeze (``jnp.squeeze``: a named axis must have
    size 1)."""
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if data.shape[a] != 1:
            raise ValueError("cannot select an axis to squeeze out which has "
                             "size not equal to one, got shape=%s and "
                             "dimensions=%s" % (tuple(data.shape), axes))
    return data.squeeze(axes)


@register("swapaxes", num_inputs=1, aliases=("SwapAxis",))
def _swapaxes(data, dim1=0, dim2=0):
    """ref: swapaxis.cc"""
    return data.transpose(dim1, dim2)


@register("slice", num_inputs=1, aliases=("crop",))
def _slice(data, begin=(), end=(), step=()):
    """ref: matrix_op.cc slice: Python slicing per axis, ``None`` for an
    open end; a negative step gathers the rows in reverse."""
    step = step or (None,) * len(begin)
    out = data
    for axis, (b, e, st) in enumerate(zip(begin, end, step)):
        sl = slice(b, e, st)
        if st is not None and st < 0:
            idx = torch.arange(*sl.indices(out.shape[axis]),
                               device=data.device)
            out = out.index_select(axis, idx)
        else:
            out = out[(slice(None),) * axis + (sl,)]
    return out


@register("slice_axis", num_inputs=1)
def _slice_axis(data, axis=0, begin=0, end=None):
    """ref: matrix_op.cc slice_axis"""
    axis = axis % data.ndim
    n = data.shape[axis]
    b = begin if begin >= 0 else begin + n
    e = n if end is None else (end if end >= 0 else end + n)
    return data.narrow(axis, b, e - b)


@register("slice_like", num_inputs=2, nograd_inputs=(1,))
def _slice_like(data, shape_like, axes=()):
    """ref: matrix_op.cc slice_like: the leading part of ``data`` the size
    of ``shape_like`` on ``axes`` (all of them by default)."""
    axes = axes or tuple(range(shape_like.ndim))
    out = data
    for a in axes:
        out = out.narrow(a, 0, shape_like.shape[a])
    return out


@register("Concat", num_inputs=None, aliases=("concat",))
def _concat(*args, dim=1, num_args=None):
    """ref: src/operator/nn/concat.cc"""
    return torch.cat(args, dim=dim)


@register("stack", num_inputs=None)
def _stack(*args, axis=0, num_args=None):
    """ref: matrix_op.cc stack"""
    return torch.stack(args, dim=axis)


@register("SliceChannel", num_inputs=1, aliases=("split",))
def _split(data, num_outputs=1, axis=1, squeeze_axis=False):
    """ref: src/operator/slice_channel.cc: ``num_outputs`` equal parts
    along ``axis``, each without the axis if ``squeeze_axis``."""
    n = data.shape[axis]
    if n % num_outputs:
        raise ValueError("array split does not result in an equal division: "
                         "%d into %d" % (n, num_outputs))
    parts = torch.split(data, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("repeat", num_inputs=1)
def _repeat(data, repeats=1, axis=None):
    """ref: matrix_op.cc repeat (no axis: over the flattened array)."""
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("tile", num_inputs=1)
def _tile(data, reps=()):
    """ref: matrix_op.cc tile"""
    return torch.tile(data, tuple(reps))


@register("reverse", num_inputs=1, aliases=("flip",))
def _reverse(data, axis=()):
    """ref: matrix_op.cc reverse"""
    return torch.flip(data, (axis,) if isinstance(axis, int) else tuple(axis))


def _pad_index(n, before, after, mode, device):
    """The source index of each padded position along an axis of size
    ``n``: ``edge`` repeats the end, ``reflect`` mirrors about it without
    repeating it (numpy's modes, any pad width)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i > n - 1, period - i, i)


@register("Pad", num_inputs=1, aliases=("pad",))
def _pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """ref: src/operator/pad.cc.  ``pad_width`` is MXNet's flat
    (before, after) pair per axis.  ``constant`` pads with the value;
    ``edge`` and ``reflect`` gather along each padded axis, at any rank
    (``F.pad`` covers those modes only on the last axes of some ranks)."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = [v for b, a in reversed(pw) for v in (b, a)]
        return F.pad(data, flat, mode="constant", value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("Pad: unknown mode %r" % (mode,))
    out = data
    for axis, (b, a) in enumerate(pw):
        if b or a:
            out = out.index_select(axis, _pad_index(out.shape[axis], b, a,
                                                    mode, data.device))
    return out


@register("space_to_depth", num_inputs=1)
def _space_to_depth(data, block_size=1):
    """ref: matrix_op.cc space_to_depth (NCHW)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space", num_inputs=1)
def _depth_to_space(data, block_size=1):
    """ref: matrix_op.cc depth_to_space (NCHW)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


def _as_index(index):
    """Indices as int64, as the JAX build's int32 cast takes them: a float
    truncates toward zero, NaN is 0, and a value beyond int32 saturates."""
    if index.is_floating_point():
        index = torch.nan_to_num(index, nan=0.0).clamp(-2.0 ** 31,
                                                       2.0 ** 31 - 1)
    return index.to(torch.int64)


@register("take", num_inputs=2, nograd_inputs=(1,))
def _take(a, indices, axis=0, mode="clip"):
    """ref: indexing_op.cc Take.  ``clip`` clamps an index to [0, n - 1]
    (so -1 takes row 0), ``wrap`` takes it modulo n; the result is
    a.shape[:axis] + indices.shape + a.shape[axis + 1:]."""
    axis = axis % a.ndim
    n = a.shape[axis]
    idx = _as_index(indices)
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(indices.shape)
                       + tuple(a.shape[axis + 1:]))


@register("Embedding", num_inputs=2, nograd_inputs=(0,),
          input_names=("data", "weight"))
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False):
    """ref: indexing_op.cc Embedding — gather rows of weight.

    Out-of-range ids are clamped to the table, as in the reference and the
    JAX build (ops/tensor.py:258-261); ``F.embedding`` would raise."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return weight[idx]


def _fill_value(dtype):
    """What ``jnp.take_along_axis`` (mode "fill") returns for an index out
    of range: NaN for floats, the lowest value of a signed integer type, the
    highest of an unsigned one, True for bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register("batch_take", num_inputs=2, nograd_inputs=(1,), aliases=("pick",))
def _pick(data, index, axis=1, keepdims=False):
    """ref: indexing_op.cc pick/batch_take — ``data`` at ``index`` along
    ``axis``, as the JAX build's ``take_along_axis`` (ops/tensor.py:238-245):
    ``index`` holds floats (truncated, NaN as 0) or ints, one per position of
    the other axes; an index in [-n, -1] counts from the end, and one outside
    [-n, n) gives :func:`_fill_value` (NaN for floats).  The range check is
    elementwise on the device, so it never waits for the card."""
    axis = axis % data.ndim
    n = data.shape[axis]
    idx = _as_index(index).unsqueeze(axis)
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, torch.where(idx < 0, idx + n, idx), 0)
    out = torch.take_along_dim(data, safe, dim=axis)
    out = torch.where(valid, out, torch.full((), _fill_value(data.dtype),
                                             dtype=data.dtype,
                                             device=data.device))
    return out if keepdims else out.squeeze(axis)


@register("Cast", num_inputs=1, aliases=("cast",))
def _cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


@register("one_hot", num_inputs=1, differentiable=False)
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    """ref: indexing_op.cc one_hot.  As the JAX build: oh·on + (1 - oh)·off
    with Python-float values, so an integer ``dtype`` gives float32 and an
    index outside [0, depth) a row of ``off_value``."""
    idx = _as_index(indices).unsqueeze(-1)
    classes = torch.arange(depth, device=indices.device)
    oh = (idx == classes).to(torch_dtype(dtype))
    on = torch.full((), float(on_value), device=indices.device,
                    dtype=oh.dtype if oh.is_floating_point()
                    else torch.float32)
    off = torch.full((), float(off_value), device=indices.device,
                     dtype=on.dtype)
    return oh * on + (1.0 - oh) * off


def _nd_index(indices, shape):
    """The rows of ``gather_nd``'s and ``scatter_nd``'s ``indices`` (one per
    leading axis) as int64, negatives counted from the end, and whether
    each position lies inside ``shape``."""
    rows, inside = [], None
    for i, row in enumerate(_as_index(indices)):
        row = torch.where(row < 0, row + shape[i], row)
        ok = (row >= 0) & (row < shape[i])
        rows.append(row)
        inside = ok if inside is None else inside & ok
    return rows, inside


@register("gather_nd", num_inputs=2, nograd_inputs=(1,))
def _gather_nd(data, indices):
    """ref: indexing_op.cc gather_nd: ``indices`` (M, ...) addresses the
    first M axes; a negative index counts from the end and one out of range
    clamps, as jnp's gather."""
    rows, _ = _nd_index(indices, data.shape)
    return data[tuple(r.clamp(0, n - 1) for r, n in zip(rows, data.shape))]


@register("scatter_nd", num_inputs=2, nograd_inputs=(1,))
def _scatter_nd(data, indices, shape=()):
    """ref: indexing_op.cc scatter_nd, as the JAX build's
    ``zeros(shape).at[idx].add(data)``: repeated positions add up, and a
    position out of range is dropped."""
    rows, inside = _nd_index(indices, tuple(shape))
    vals = torch.where(inside.reshape(inside.shape + (1,) * (
        data.ndim - inside.ndim)), data, torch.zeros((), dtype=data.dtype,
                                                     device=data.device))
    rows = [torch.where(inside, r, torch.zeros_like(r)) for r in rows]
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(rows), vals, accumulate=True)


@register("where", num_inputs=3)
def _where(condition, x, y):
    """ref: src/operator/tensor/control_flow_op.cc where: x where the
    condition is nonzero, else y.  A 1-d condition over an array of more
    axes picks whole rows, as MXNet's (the JAX build broadcasts it against
    the last axis instead)."""
    cond = condition != 0
    if cond.ndim == 1 and x.ndim > 1:
        cond = cond.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(cond, x, y)


def _stable_sort(x, dim, ascending):
    """Values and indices of a stable sort along ``dim``: equal values keep
    their order; the descending order is the ascending one reversed (the
    JAX build's ``flip(sort)``)."""
    vals, idx = torch.sort(x, dim=dim, stable=True)
    if not ascending:
        vals, idx = torch.flip(vals, (dim,)), torch.flip(idx, (dim,))
    return vals, idx


@register("topk", num_inputs=1, differentiable=False)
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    """ref: ordering_op.cc topk, as ``lax.top_k``: the k largest (or, with
    ``is_ascend``, smallest) along ``axis``, a tie taken lower index first;
    ``ret_typ`` value, indices (as ``dtype``), both, or mask (1 at the k
    positions, in the data's dtype)."""
    axis = axis % data.ndim
    _, idx = torch.sort(data, dim=axis, descending=not is_ascend,
                        stable=True)
    idx = idx.narrow(axis, 0, k)
    vals = torch.gather(data, axis, idx)
    if ret_typ == "value":
        return vals
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(
            axis, idx, torch.ones((), dtype=data.dtype,
                                  device=data.device).expand(idx.shape))
    out = idx.to(torch_dtype(dtype))
    return (vals, out) if ret_typ == "both" else out


@register("sort", num_inputs=1, differentiable=False)
def _sort(data, axis=-1, is_ascend=True):
    """ref: ordering_op.cc sort"""
    return _stable_sort(data, axis, is_ascend)[0]


@register("argsort", num_inputs=1, differentiable=False)
def _argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    """ref: ordering_op.cc argsort: the stable ascending order, reversed
    when descending (so ties come last index first), as ``dtype``."""
    return _stable_sort(data, axis, is_ascend)[1].to(torch_dtype(dtype))


@register("shuffle", num_inputs=1, differentiable=False, needs_rng=True,
          aliases=("_shuffle",))
def _shuffle(data, generator=None):
    """ref: src/operator/random/shuffle_op.cc — the rows (first axis) in a
    random order, from the framework generator of the data's device."""
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data.index_select(0, perm)


@register("_copy", num_inputs=1, aliases=("identity",))
def _copy(data):
    """ref: elemwise_unary_op_basic.cc _copy"""
    return data.clone()


@register("BlockGrad", num_inputs=1, differentiable=False,
          aliases=("stop_gradient",))
def _blockgrad(data):
    """ref: elemwise_unary_op_basic.cc BlockGrad: no gradient flows back."""
    return data.detach()


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward is ``grad_scale`` everywhere, whatever
    the head gradient (ref: src/operator/make_loss.cc)."""

    @staticmethod
    def forward(ctx, data, grad_scale):
        ctx.grad_scale = grad_scale
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.grad_scale), None


@register("make_loss", num_inputs=1, aliases=("MakeLoss",))
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """ref: src/operator/make_loss.cc"""
    return _MakeLoss.apply(data, grad_scale)


@register("_grad_add", num_inputs=2)
def _grad_add(lhs, rhs):
    return lhs + rhs


@register("SequenceLast", num_inputs=None)
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    """ref: sequence_last.cc: each sequence's last valid step of (T, N,
    ...) data (``axis`` names T), its length clamped to [1, T]."""
    x = data.movedim(axis, 0)
    t, n = x.shape[0], x.shape[1]
    if use_sequence_length and sequence_length is not None:
        idx = (_as_index(sequence_length) - 1).clamp(0, t - 1)
    else:
        idx = torch.full((n,), t - 1, dtype=torch.int64, device=data.device)
    return x[idx, torch.arange(n, device=data.device)]


@register("SequenceMask", num_inputs=None)
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    """ref: sequence_mask.cc: steps at or beyond each sequence's length
    set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    x = data.movedim(axis, 0)
    t, n = x.shape[0], x.shape[1]
    mask = (torch.arange(t, device=data.device)[:, None]
            < _as_index(sequence_length)[None, :])
    mask = mask.reshape((t, n) + (1,) * (x.ndim - 2))
    out = torch.where(mask, x, torch.full((), value, dtype=x.dtype,
                                          device=x.device))
    return out.movedim(0, axis)


@register("SequenceReverse", num_inputs=None)
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    """ref: sequence_reverse.cc: each sequence reversed up to its length,
    the steps beyond it left in place."""
    x = data.movedim(axis, 0)
    t = x.shape[0]
    if not use_sequence_length or sequence_length is None:
        return torch.flip(x, (0,)).movedim(0, axis)
    lengths = _as_index(sequence_length)[None, :]
    step = torch.arange(t, device=data.device)[:, None]
    src = torch.where(step < lengths, lengths - 1 - step, step)
    src = src.reshape((t, x.shape[1]) + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 0, src).movedim(0, axis)


@register("hard_sigmoid", num_inputs=1)
def _hard_sigmoid(data, alpha=0.2, beta=0.5):
    """clip(alpha·x + beta, 0, 1) (ref: src/operator/mshadow_op.h
    hard_sigmoid), each constant in the data's dtype as jnp's weak floats."""
    return torch.clamp(data * weak_scalar(data, alpha)
                       + weak_scalar(data, beta), 0.0, 1.0)


@register("square_sum", num_inputs=1)
def _square_sum(data, axis=None, keepdims=False, exclude=False):
    """sum(x²) over ``axis`` (ref: src/operator/tensor/square_sum.cc, the
    dense registered op; row-sparse storage is ROADMAP item 10)."""
    ax = _norm_axis(axis, data.ndim, exclude and axis is not None)
    return _sum(data * data, ax, keepdims)
