"""The INT8 quantization operators (counterpart of
``incubator_mxnet_tpu/ops/quantization.py``; ref:
src/operator/quantization/).

* ``_contrib_quantize`` / ``_contrib_dequantize`` / ``_contrib_requantize``
  (quantize-inl.h, dequantize-inl.h, requantize-inl.h): zero-centred int8
  and affine uint8 in f32 arithmetic.
* ``_contrib_quantized_conv`` / ``_contrib_quantized_fully_connected``
  (quantized_conv.cc, quantized_fully_connected.cc): int8 x int8 products
  accumulated exactly in int32.  torch has no int8 convolution on CUDA, so
  the convolution is an im2col of the int8 data and one s8 x s8 -> s32
  product (``torch._int_mm``, cuBLASLt's int8 GEMM on the card), its
  operands padded with zeros to the shapes that call takes (more than 16
  rows, inner and outer sizes multiples of 8): padding adds exact zeros.
  No float type computes the int32 accumulator, so no TF32 and no 2^24
  limit applies.
* ``_contrib_quantized_pooling`` / ``_flatten`` / ``_act`` /
  ``_elemwise_add`` (quantized_pooling.cc, quantized_flatten.cc): int8
  windows, the (min, max) range carried through.

Every tensor of the int8 chain travels with its real range (min, max), f32
scalars; int8 is zero-centred, range [-r, r] with r = max(|min|, |max|).
The f32 arithmetic keeps the JAX build's order of operations, so every
int8 and int32 code equals the JAX build's:

* a Python float scalar rounds to f32 in both packages (so the int32 range
  2^31 - 1 enters as 2^31), and every division by a scalar is a true
  division by an f32 tensor (CUDA multiplies by the reciprocal of a host
  scalar, and torch computes ``scalar / tensor`` as ``reciprocal(tensor) *
  scalar``);
* rounding is to nearest even (``jnp.rint``, ``torch.round``);
* f32 to int32 saturates, as XLA's conversion does (torch's conversion of
  an out-of-range value is undefined);
* XLA fuses ``lhs·ka + rhs·kb`` of the residual add into one multiply-add;
  :func:`_fma` computes that rounding exactly.

All ops are inference only (not differentiable), as in the JAX build.
"""
from __future__ import annotations

import numpy as np
import torch

from ._precision import f32_reciprocal, f32_scalar, fma_f32 as _fma
from .nn import _pooling, _conv_param_shapes, _fc_param_shapes, _tuple
from .registry import register

__all__ = ["QUANTIZED_OP_MAP", "NEED_REQUANTIZE", "quantizable"]

_RANGE_NAMES = ("min_data", "max_data", "min_weight", "max_weight",
                "min_bias", "max_bias")

INT8_MAX = 127.0
UINT8_MAX = 255.0
# float(np.iinfo(np.int32).max) as the JAX build writes it: a Python float
# that rounds to f32 (2^31) where it meets an f32 operand
_INT32_MAX = float(np.iinfo(np.int32).max)


def _qconv_param_shapes(data_shape, params):
    d = _conv_param_shapes(data_shape, params)
    d.update({n: () for n in _RANGE_NAMES})
    return d


def _qfc_param_shapes(data_shape, params):
    d = _fc_param_shapes(data_shape, params)
    d.update({n: () for n in _RANGE_NAMES})
    return d


def _c(value, like):
    """``value`` rounded to f32, a 0-dim tensor on ``like``'s device."""
    return f32_scalar(value, like.device)


def _recip(value, like):
    """The f32 reciprocal of a constant (the int8 codes depend on XLA's
    multiply by it in place of a division)."""
    return f32_reciprocal(value, like.device)


def _scalar(x):
    """A range input (any 1-element array) as an f32 scalar."""
    return x.to(torch.float32).reshape(())


def _real_range(min_r, max_r):
    """The zero-centred range r whose int8 grid covers [-r, r], floored
    at 1e-30 so that an all-zero tensor quantizes to 0."""
    return torch.maximum(torch.maximum(min_r.abs(), max_r.abs()),
                         _c(1e-30, min_r))


def _to_int32(x):
    """f32 to int32 as XLA converts: rounded values beyond the int32 range
    saturate, NaN gives 0."""
    lo, hi = _c(-2.0 ** 31, x), _c(2.0 ** 31, x)
    v = torch.where(torch.isnan(x), _c(0.0, x), x)
    out = v.clamp(min=lo).to(torch.int32)
    big = torch.full((), np.iinfo(np.int32).max, dtype=torch.int32,
                     device=x.device)
    return torch.where(v >= hi, big, out)


def _quantize_int8(x, min_r, max_r):
    r = _real_range(min_r, max_r)
    scale = _c(INT8_MAX, r) / r
    q = torch.round(x.to(torch.float32) * scale).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), -r, r


@register("_contrib_quantize", num_inputs=3, num_outputs=3,
          input_names=("data", "min_range", "max_range"),
          differentiable=False)
def _quantize(data, min_range, max_range, out_type="uint8"):
    """float -> int8 (zero-centred) or uint8 (affine) over the given real
    range (ref: quantize-inl.h): (quantized, out_min, out_max)."""
    min_r, max_r = _scalar(min_range), _scalar(max_range)
    if out_type == "int8":
        return _quantize_int8(data, min_r, max_r)
    if out_type == "uint8":
        scale = _c(UINT8_MAX, min_r) / torch.maximum(max_r - min_r,
                                                     _c(1e-30, min_r))
        q = torch.round((data.to(torch.float32) - min_r) * scale)
        return q.clamp(0.0, UINT8_MAX).to(torch.uint8), min_r, max_r
    raise ValueError("out_type must be int8 or uint8, got %r" % out_type)


@register("_contrib_dequantize", num_inputs=3, num_outputs=1,
          input_names=("data", "min_range", "max_range"),
          differentiable=False)
def _dequantize(data, min_range, max_range, out_type="float32"):
    """int8, uint8 or an int32 accumulator -> f32 (ref: dequantize-inl.h)."""
    min_r, max_r = _scalar(min_range), _scalar(max_range)
    x = data.to(torch.float32)
    if data.dtype == torch.int8:
        return x * (_real_range(min_r, max_r) * _recip(INT8_MAX, x))
    if data.dtype == torch.uint8:
        return _fma(x, (max_r - min_r) * _recip(UINT8_MAX, x), min_r)
    return x * (_real_range(min_r, max_r) / _c(_INT32_MAX, x))


@register("_contrib_requantize", num_inputs=3, num_outputs=3,
          input_names=("data", "min_range", "max_range"),
          differentiable=False)
def _requantize(data, min_range, max_range,
                min_calib_range=None, max_calib_range=None):
    """int32 accumulator -> int8 over a narrower range (ref:
    requantize-inl.h): the calibrated range where the graph pass set one,
    else the largest magnitude of the data (MXNet's calib_mode="none")."""
    min_r, max_r = _scalar(min_range), _scalar(max_range)
    real = data.to(torch.float32) * (_real_range(min_r, max_r) /
                                     _c(_INT32_MAX, min_r))
    if min_calib_range is not None and max_calib_range is not None:
        out_r = max(abs(float(min_calib_range)), abs(float(max_calib_range)))
        q = torch.round(real * _c(INT8_MAX / out_r, real))
        return (q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), _c(-out_r, real),
                _c(out_r, real))
    out_r = torch.maximum(real.abs().amax(), _c(1e-30, real))
    q = torch.round(real * (_c(INT8_MAX, real) / out_r))
    return q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8), -out_r, out_r


def _int32_range(range_a, range_b):
    """(min, max) of an int8 x int8 -> int32 contraction (ref:
    quantization_utils.h QuantizationRangeForMultiplication)."""
    r = range_a * range_b * _c(_INT32_MAX / (INT8_MAX * INT8_MAX), range_a)
    return -r, r


def _q_argnames(params):
    """Data inputs, then the range scalars (ref: quantized_conv.cc
    FListInputNames)."""
    if params.get("no_bias", True):
        return ("data", "weight", "min_data", "max_data",
                "min_weight", "max_weight")
    return ("data", "weight", "bias", "min_data", "max_data",
            "min_weight", "max_weight", "min_bias", "max_bias")


def _rescale_bias_to_acc(bias, min_b, max_b, acc_max):
    """An int8 bias on the int32 accumulator's grid, one unit of which is
    acc_max / (2^31 - 1) (ref: quantized_conv.cc)."""
    rb = _real_range(_scalar(min_b), _scalar(max_b))
    acc_step = acc_max / _c(_INT32_MAX, acc_max)
    bias_real = bias.to(torch.float32) * (rb * _recip(INT8_MAX, rb))
    return _to_int32(torch.round(bias_real / acc_step))


def _int8_matmul(a, b):
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact: one
    ``torch._int_mm`` with the operands padded by zeros to M > 16 and K, N
    multiples of 8, which that call needs on the card."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n]


def _im2col(data, kernel, stride, dilate, pad):
    """int8 (N, C, *S) -> (N, *O, C·prod(kernel)) windows, zero-padded,
    columns ordered (C, *kernel) as the weight's (F, C, *kernel)."""
    nd = len(kernel)
    if any(pad):
        data = torch.nn.functional.pad(
            data, [p for q in reversed(pad) for p in (q, q)])
    x = data
    for i in range(nd):
        span = dilate[i] * (kernel[i] - 1) + 1
        x = x.unfold(2 + i, span, stride[i])
    # x: (N, C, *O, *span) -> keep every dilate-th element of each span
    if any(d > 1 for d in dilate):
        x = x[(Ellipsis,) + tuple(slice(None, None, d) for d in dilate)]
    n, c = x.shape[:2]
    out_sp = x.shape[2:2 + nd]
    perm = [0] + list(range(2, 2 + nd)) + [1] + list(range(2 + nd, 2 + 2 * nd))
    return x.permute(perm).reshape((n,) + tuple(out_sp) + (-1,))


@register("_contrib_quantized_conv", num_inputs=None, num_outputs=3,
          fargnames=_q_argnames, finfer_params=_qconv_param_shapes,
          differentiable=False)
def _quantized_conv(*args, kernel=(), stride=(), dilate=(), pad=(),
                    num_filter=0, num_group=1, no_bias=True, workspace=1024,
                    cudnn_tune=None, cudnn_off=False, layout=None):
    """int8 convolution, int32 accumulation (ref: quantized_conv.cc): per
    group an im2col of the data and one exact int8 product with the
    weight's (F/G, C/G·prod(kernel)) matrix; the int8 bias rescaled onto the
    accumulator's grid is added in int32."""
    if no_bias:
        data, weight, min_d, max_d, min_w, max_w = args
        bias = None
    else:
        data, weight, bias, min_d, max_d, min_w, max_w, min_b, max_b = args
    nd = len(kernel) if kernel else data.ndim - 2
    kernel = tuple(weight.shape[2:])
    stride, dilate, pad = (_tuple(stride, nd, 1), _tuple(dilate, nd, 1),
                           _tuple(pad, nd, 0))
    n, c = data.shape[:2]
    f, g = weight.shape[0], num_group
    cg, fg = c // g, f // g
    outs = []
    for i in range(g):
        col = _im2col(data[:, i * cg:(i + 1) * cg], kernel, stride, dilate,
                      pad)                                  # (N, *O, K)
        out_sp = col.shape[1:-1]
        w = weight[i * fg:(i + 1) * fg].reshape(fg, -1)
        prod = _int8_matmul(col.reshape(-1, col.shape[-1]), w.t())
        outs.append(prod.reshape((n,) + tuple(out_sp) + (fg,)))
    out = torch.cat(outs, dim=-1) if g > 1 else outs[0]
    out = out.permute([0, nd + 1] + list(range(1, nd + 1))).contiguous()
    rd = _real_range(_scalar(min_d), _scalar(max_d))
    rw = _real_range(_scalar(min_w), _scalar(max_w))
    omin, omax = _int32_range(rd, rw)
    if bias is not None:
        bias32 = _rescale_bias_to_acc(bias, min_b, max_b, omax)
        out = out + bias32.reshape((1, -1) + (1,) * nd)
    return out, omin, omax


@register("_contrib_quantized_fully_connected", num_inputs=None,
          num_outputs=3, fargnames=_q_argnames,
          finfer_params=_qfc_param_shapes, differentiable=False)
def _quantized_fc(*args, num_hidden=0, no_bias=True, flatten=True):
    """int8 x·Wᵀ, int32 accumulation (ref: quantized_fully_connected.cc)."""
    if no_bias:
        data, weight, min_d, max_d, min_w, max_w = args
        bias = None
    else:
        data, weight, bias, min_d, max_d, min_w, max_w, min_b, max_b = args
    x = data.reshape(data.shape[0], -1) if flatten else data
    lead = x.shape[:-1]
    out = _int8_matmul(x.reshape(-1, x.shape[-1]), weight.t()) \
        .reshape(tuple(lead) + (weight.shape[0],))
    rd = _real_range(_scalar(min_d), _scalar(max_d))
    rw = _real_range(_scalar(min_w), _scalar(max_w))
    omin, omax = _int32_range(rd, rw)
    if bias is not None:
        out = out + _rescale_bias_to_acc(bias, min_b, max_b, omax)
    return out, omin, omax


@register("_contrib_quantized_pooling", num_inputs=3, num_outputs=3,
          input_names=("data", "min_data", "max_data"),
          differentiable=False)
def _quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                       global_pool=False, stride=(), pad=(),
                       pooling_convention="valid", cudnn_off=False, p_value=2,
                       count_include_pad=True):
    """Pooling on the int8 grid (ref: quantized_pooling.cc): max in int8
    (integer windows, exact); avg sums in int32 and rounds the f32 mean
    back to int8.  The range passes through."""
    min_d, max_d = _scalar(min_data), _scalar(max_data)
    conf = dict(kernel=kernel, global_pool=global_pool, stride=stride,
                pad=pad, pooling_convention=pooling_convention)
    if pool_type == "max":
        out = _pooling(data, pool_type="max", **conf)
    elif pool_type == "avg":
        s = _pooling(data.to(torch.int32), pool_type="sum", **conf)
        if count_include_pad:
            k = data.shape[2:] if global_pool else tuple(kernel)
            inv = _recip(float(np.prod(k)), s)
        else:
            # each window's count of input elements, as the float op's
            cnt = _pooling(torch.ones(data.shape, dtype=torch.int32,
                                      device=data.device), pool_type="sum",
                           **conf).to(torch.float32)
            inv = 1 / cnt
        q = torch.round(s.to(torch.float32) * inv)
        out = q.clamp(-INT8_MAX, INT8_MAX).to(data.dtype)
    else:
        raise ValueError("quantized_pooling supports max/avg, got %r"
                         % pool_type)
    return out, min_d, max_d


@register("_contrib_quantized_flatten", num_inputs=3, num_outputs=3,
          input_names=("data", "min_data", "max_data"),
          differentiable=False)
def _quantized_flatten(data, min_data, max_data):
    """ref: quantized_flatten.cc: a reshape; the range passes through."""
    return (data.reshape(data.shape[0], -1), _scalar(min_data),
            _scalar(max_data))


@register("_contrib_quantized_act", num_inputs=3, num_outputs=3,
          input_names=("data", "min_data", "max_data"),
          differentiable=False)
def _quantized_act(data, min_data, max_data, act_type="relu"):
    """relu on the int8 grid: zero-centred codes make it max(code, 0), and
    the range is unchanged (the negative half of the grid goes unused)."""
    return (torch.clamp(data, min=0), _scalar(min_data) * 1,
            _scalar(max_data) * 1)


@register("_contrib_quantized_elemwise_add", num_inputs=6, num_outputs=3,
          input_names=("lhs", "rhs", "min_lhs", "max_lhs",
                       "min_rhs", "max_rhs"),
          differentiable=False)
def _quantized_elemwise_add(lhs, rhs, min_lhs, max_lhs, min_rhs, max_rhs):
    """A residual add in the quantized domain: both int8 operands rescaled
    onto an int32 grid whose extremes are ±(r_lhs + r_rhs), the exact bound
    of the sum; a requantize narrows it back to int8."""
    ra = _real_range(_scalar(min_lhs), _scalar(max_lhs))
    rb = _real_range(_scalar(min_rhs), _scalar(max_rhs))
    r_out = ra + rb
    unit = _c(_INT32_MAX, ra) / (_c(INT8_MAX, ra) * r_out)
    ka, kb = ra * unit, rb * unit
    out = _fma(lhs.to(torch.float32), ka, rhs.to(torch.float32) * kb)
    return _to_int32(torch.round(out)), -r_out, r_out * 1


# ---------------------------------------------------------------------------
# Graph-pass metadata: which float ops have an int8 twin, and which int8
# ops give int32 that a requantize must narrow (ref: FQuantizedOp and
# FNeedRequantize, read by quantize_graph_pass.cc)
# ---------------------------------------------------------------------------

QUANTIZED_OP_MAP = {
    "Convolution": "_contrib_quantized_conv",
    "FullyConnected": "_contrib_quantized_fully_connected",
    "Pooling": "_contrib_quantized_pooling",
    "Flatten": "_contrib_quantized_flatten",
    "Activation": "_contrib_quantized_act",
    # elemwise_add is an alias of broadcast_add in the registry
    "elemwise_add": "_contrib_quantized_elemwise_add",
    "broadcast_add": "_contrib_quantized_elemwise_add",
}

NEED_REQUANTIZE = {"_contrib_quantized_conv",
                   "_contrib_quantized_fully_connected",
                   "_contrib_quantized_elemwise_add"}


def quantizable(op_name, params):
    """Whether a node can become its int8 twin under ``params``: Pooling
    only for max and avg, Activation only for relu (the int8 grid is
    closed under relu, not under the other activations)."""
    if op_name not in QUANTIZED_OP_MAP:
        return False
    if op_name == "Pooling" and params.get("pool_type", "max") not in (
            "max", "avg"):
        return False
    if op_name == "Activation" and params.get("act_type") != "relu":
        return False
    return True
