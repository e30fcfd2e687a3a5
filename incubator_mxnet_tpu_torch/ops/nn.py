"""Core neural-network operators of the decoder-LM and ResNet paths.

Counterpart of ``incubator_mxnet_tpu/ops/nn.py``: ``FullyConnected`` (:70),
``Convolution`` (:86), ``Deconvolution`` (:115), ``Pooling`` (:161),
``BatchNorm`` (:326), ``LayerNorm`` (:356), ``Activation`` (:394),
``softmax`` (:432), ``log_softmax`` (:439) and ``SoftmaxOutput`` (:490),
and the rest of the file: ``UpSampling`` (:214), ``InstanceNorm`` (:368),
``LRN`` (:380), ``LeakyReLU`` (:410), ``SoftmaxActivation`` (:445),
``Dropout`` (:453), the regression outputs (:523-546) and ``SVMOutput``
(:548).  Dropout and rrelu draw from the generator ``invoke`` passes them
(the framework generator of the data's device), and only in a call that
draws: training, or Dropout's ``mode="always"``.
The products go to ``torch.matmul`` and to cuDNN's convolutions through
``aten.convolution``, as the JAX build left them to XLA; f32 convolutions
run in full f32 on the card, TF32 off (:func:`_f32_convolutions`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ._precision import f32_convolutions as _f32_convolutions
from .math import scalar_like
from .random_ops import uniform_in
from .registry import register


def _fc_param_shapes(data_shape, params):
    """ref: fully_connected.cc FInferShape fills weight/bias from data."""
    nh = params.get("num_hidden", 0)
    in_units = int(np.prod(data_shape[1:])) if params.get("flatten", True) \
        else data_shape[-1]
    return {"weight": (nh, in_units), "bias": (nh,)}


def _conv_param_shapes(data_shape, params):
    """ref: convolution.cc FInferShape."""
    nf = params.get("num_filter", 0)
    ng = params.get("num_group", 1)
    kernel = tuple(params.get("kernel", ()))
    return {"weight": (nf, data_shape[1] // ng) + kernel, "bias": (nf,)}


def _deconv_param_shapes(data_shape, params):
    """ref: deconvolution-inl.h: weight (in, out / groups, *kernel)."""
    nf = params.get("num_filter", 0)
    ng = params.get("num_group", 1)
    kernel = tuple(params.get("kernel", ()))
    return {"weight": (data_shape[1], nf // ng) + kernel, "bias": (nf,)}


def _channel_param_shapes(data_shape, params):
    c = data_shape[params.get("axis", 1) % len(data_shape)]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _layernorm_param_shapes(data_shape, params):
    c = data_shape[params.get("axis", -1) % len(data_shape)]
    return {"gamma": (c,), "beta": (c,)}


@register("FullyConnected", num_inputs=None,
          input_names=("data", "weight", "bias"),
          finfer_params=_fc_param_shapes)
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True):
    """y = x·Wᵀ + b (ref: fully_connected.cc:1).  The product runs in the
    promoted dtype of x and W, as ``preferred_element_type`` does at
    ops/nn.py:76."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt).t())
    if not no_bias and bias is not None:
        out = out + bias
    return out


def _tuple(v, n, default):
    """A spatial parameter as an ``n``-tuple: empty gives ``default``, a
    scalar repeats."""
    if isinstance(v, (tuple, list)):
        return tuple(v) if len(v) else (default,) * n
    return (v,) * n


class _ConvolutionFunction(torch.autograd.Function):
    """``aten.convolution`` (cuDNN on the card) without bias, forward and
    backward both under :func:`_f32_convolutions`: the backward's
    ``convolution_backward`` reads the TF32 setting when it runs, outside
    the forward's scope.  The backward is itself differentiable
    (``create_graph``)."""

    @staticmethod
    def forward(ctx, data, weight, conf):
        ctx.save_for_backward(data, weight)
        ctx.conf = conf
        with _f32_convolutions():
            return torch.ops.aten.convolution(data, weight, None, *conf)

    @staticmethod
    def backward(ctx, grad):
        data, weight = ctx.saved_tensors
        with _f32_convolutions():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                grad, data, weight, None, *ctx.conf,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None


def _conv(data, weight, bias, no_bias, conf):
    """The convolution in the promoted dtype of data and weight (the JAX
    build's ``preferred_element_type``), then the bias added after it."""
    dt = torch.promote_types(data.dtype, weight.dtype)
    out = _ConvolutionFunction.apply(data.to(dt), weight.to(dt), conf)
    if not no_bias and bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * (data.ndim - 2))
    return out


@register("Convolution", num_inputs=None,
          input_names=("data", "weight", "bias"),
          finfer_params=_conv_param_shapes, aliases=("Convolution_v1",))
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False,
                 workspace=1024, cudnn_tune=None, cudnn_off=False,
                 layout=None):
    """N-d convolution (1-3 spatial axes), NC + spatial data and OI +
    spatial weight (ref: convolution.cc; the JAX build's
    ``lax.conv_general_dilated``, ops/nn.py:86-111)."""
    nd = len(kernel) if kernel else data.ndim - 2
    conf = (_tuple(stride, nd, 1), _tuple(pad, nd, 0), _tuple(dilate, nd, 1),
            False, (0,) * nd, num_group)
    return _conv(data, weight, bias, no_bias, conf)


@register("Deconvolution", num_inputs=None,
          input_names=("data", "weight", "bias"),
          finfer_params=_deconv_param_shapes)
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), target_shape=(), num_filter=0,
                   num_group=1, no_bias=True, workspace=512, cudnn_tune=None,
                   cudnn_off=False, layout=None):
    """Transposed convolution (ref: deconvolution.cc; ops/nn.py:115-158),
    weight (in, out / groups, *kernel): the output extent is
    ``(x - 1)·stride - 2·pad + dilate·(kernel - 1) + adj + 1``, the JAX
    build's lhs-dilated convolution.  ``target_shape`` is not honoured, as
    in the JAX build."""
    nd = len(kernel)
    conf = (_tuple(stride, nd, 1), _tuple(pad, nd, 0), _tuple(dilate, nd, 1),
            True, _tuple(adj, nd, 0), num_group)
    return _conv(data, weight, bias, no_bias, conf)


# torch's pooling kernels by spatial rank (1-d runs as 2-d over a unit axis)
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_reduce(x, kernel, stride, how):
    """``how`` ("max" or "sum") over every window of the last
    ``len(kernel)`` axes, no padding: torch's pooling kernels for floating
    types (max pooling's gradient goes to each window's first maximum, as
    XLA's select-and-scatter sends it; 16-bit sums accumulate in f32 and
    round once); integers over ``unfold`` windows, in their own dtype."""
    nd = len(kernel)
    if x.is_floating_point():
        if nd == 1:
            return _window_reduce(x.unsqueeze(-2), (1,) + tuple(kernel),
                                  (1,) + tuple(stride), how).squeeze(-2)
        if how == "max":
            return _MAX_POOL[nd](x, kernel, stride)
        return _AVG_POOL[nd](x.float(), kernel, stride,
                             divisor_override=1).to(x.dtype)
    for i, (k, s) in enumerate(zip(kernel, stride)):
        x = x.unfold(2 + i, k, s)
    window = tuple(range(-nd, 0))
    if how == "max":
        return x.amax(dim=window)
    return x.sum(dim=window, dtype=x.dtype)


@register("Pooling", num_inputs=1, aliases=("Pooling_v1",))
def _pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
             pad=(), pooling_convention="valid", cudnn_off=False, p_value=2,
             count_include_pad=True):
    """max / avg / sum / lp pooling over 1-3 spatial axes (ref: pooling.cc;
    ops/nn.py:161-211).  The input is padded explicitly, then pooled with
    no padding: ``pooling_convention="full"`` pads the high edge by
    ``(out - 1)·s + k - x - p`` so that ceil((x + 2p - k) / s) + 1 windows
    fit, which is not torch's ``ceil_mode`` (that drops a last window
    starting in the padding, and divides avg by another count).  Max pads
    with -inf (``iinfo.min`` for integers), the sums with 0; avg divides by
    ``prod(kernel)``, or with ``count_include_pad=False`` by each window's
    count of input elements."""
    nd = data.ndim - 2
    if global_pool:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * nd, (0,) * nd
    kernel = _tuple(kernel, nd, 1)
    stride = _tuple(stride, nd, 1)
    pad = _tuple(pad, nd, 0)
    pads = []
    for i in range(nd):
        lo = hi = pad[i]
        if pooling_convention == "full":
            x = data.shape[2 + i]
            out = int(np.ceil((x + 2 * pad[i] - kernel[i]) / stride[i])) + 1
            hi = max((out - 1) * stride[i] + kernel[i] - x - pad[i], pad[i])
        pads.append((lo, hi))
    flat_pads = [p for lo_hi in reversed(pads) for p in lo_hi]

    def window(x, how, fill):
        if any(flat_pads):
            x = F.pad(x, flat_pads, value=fill)
        return _window_reduce(x, kernel, stride, how)

    if pool_type == "max":
        fill = (float("-inf") if data.is_floating_point()
                else torch.iinfo(data.dtype).min)
        return window(data, "max", fill)
    if pool_type in ("avg", "sum"):
        s = window(data, "sum", 0)
        if pool_type == "sum":
            return s
        if count_include_pad:
            count = float(np.prod(kernel))
        else:
            ones = torch.ones((1, 1) + tuple(data.shape[2:]),
                              dtype=data.dtype, device=data.device)
            count = window(ones, "sum", 0)
        return s / (scalar_like(s, count) if s.is_floating_point()
                    and isinstance(count, float) else count)
    if pool_type == "lp":
        s = window(data.abs() ** p_value, "sum", 0)
        return s ** (1.0 / p_value)
    raise ValueError("unknown pool_type %r" % pool_type)


def _bn_layout(data, axis):
    """(reduced axes, the per-channel vectors' broadcast shape, the count of
    elements a channel reduces over)."""
    axis = axis % data.ndim
    red = tuple(i for i in range(data.ndim) if i != axis)
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]
    return red, bshape, int(np.prod([data.shape[i] for i in red]))


class _BatchNormTrainFunction(torch.autograd.Function):
    """Training-mode BatchNorm with the JAX build's closed-form backward
    (``_bn_train_stats``, ``_bn_train_core_fwd``,
    ``_bn_train_core_bwd_rule``, ops/nn.py:238-320).

    The statistics are two f32 passes over the input in its own dtype: the
    mean, then the mean of the squared shifted values (never
    E[x²] - E[x]², which loses channels with |mean| >> std).  The output
    is (x - mean)·(gamma·rsqrt(var + eps)) + beta in f32, rounded once to
    the input's dtype.  Saved: the input in its own dtype and the f32
    per-channel mean, 1/std and scale; no f32 copy of the activation
    outlives a call.  The backward is dx = dy·scale + xc·b + c with
    per-channel b = -scale·inv·Σ(dy·xc)·inv/m and c = -scale·Σdy/m, the
    JAX rule's scale·(dy - (Σdy + x̂·Σ(dy·x̂))/m) regrouped; cotangents of
    the mean and var outputs fold into c (+ct_mean/m) and b
    (+2·ct_var/m).  dgamma is 0 under ``fix_gamma``."""

    @staticmethod
    def forward(ctx, data, gamma, beta, axis, eps, fix_gamma):
        ctx.set_materialize_grads(False)
        red, bshape, _ = _bn_layout(data, axis)
        mean = data.mean(dim=red, dtype=torch.float32)
        xc = data - mean.reshape(bshape)            # f32
        var = xc.square().mean(dim=red)
        inv = torch.rsqrt(var + eps)
        scale = inv if fix_gamma else gamma.float() * inv
        out = torch.empty_like(data)
        # f32 arithmetic, rounded once into the input's dtype
        torch.addcmul(beta.float().reshape(bshape), xc, scale.reshape(bshape),
                      out=out)
        ctx.save_for_backward(data, mean, inv, scale)
        ctx.conf = (axis, fix_gamma, gamma.dtype, beta.dtype)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, ct_mean, ct_var):
        data, mean, inv, scale = ctx.saved_tensors
        axis, fix_gamma, gamma_dtype, beta_dtype = ctx.conf
        red, bshape, m = _bn_layout(data, axis)
        xc = data - mean.reshape(bshape)
        dgamma = dbeta = None
        b = torch.zeros_like(mean)
        c = torch.zeros_like(mean)
        if dy is not None:
            dbeta = dy.sum(dim=red, dtype=torch.float32)
            dgamma_raw = (dy * xc).sum(dim=red) * inv
            b = b - scale * inv * dgamma_raw / m
            c = c - scale * dbeta / m
            dgamma = (torch.zeros(mean.shape, dtype=gamma_dtype,
                                  device=mean.device) if fix_gamma
                      else dgamma_raw.to(gamma_dtype))
            dbeta = dbeta.to(beta_dtype)
        if ct_mean is not None:
            c = c + ct_mean.float() / m
        if ct_var is not None:
            b = b + 2.0 * ct_var.float() / m
        dx = torch.addcmul(c.reshape(bshape), xc, b.reshape(bshape))
        if dy is not None:
            dx = torch.addcmul(dx, dy, scale.reshape(bshape))
        return dx.to(data.dtype), dgamma, dbeta, None, None, None


@register("BatchNorm", num_inputs=5, num_outputs=3, num_visible_outputs=1,
          takes_is_train=True, nograd_inputs=(3, 4), aliases=("BatchNorm_v1",),
          input_names=("data", "gamma", "beta", "moving_mean", "moving_var"),
          aux_input_names=("moving_mean", "moving_var"),
          finfer_params=_channel_param_shapes,
          fupdate_aux=lambda params, aux, outs: update_moving_stats(
              params, aux, outs[1:3]),
          fvisible=lambda params, n: n if params.get("output_mean_var")
          else 1)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                is_train=False):
    """ref: batch_norm.cc:89 (ops/nn.py:326-353).  Outputs (out, mean,
    var): the batch's f32 statistics in training, the moving ones
    otherwise.  The moving statistics are updated by the caller with
    ``momentum`` (the Gluon layer, the symbolic executor:
    :func:`update_moving_stats`), not here.  Not ``F.batch_norm``: that
    updates running stats with the unbiased variance at momentum 0.1."""
    if is_train and not use_global_stats:
        return _BatchNormTrainFunction.apply(data, gamma, beta, axis, eps,
                                             bool(fix_gamma))
    _, bshape, _ = _bn_layout(data, axis)
    mean = moving_mean.float()
    var = moving_var.float()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = g.float() * torch.rsqrt(var + eps)
    # (x - mean) first, in f32, then one rounding: x·s + (beta - mean·s)
    # folded in bf16 would lose the large-mean channels
    out = torch.addcmul(beta.float().reshape(bshape),
                        data - mean.reshape(bshape), scale.reshape(bshape))
    return out.to(data.dtype), mean, var


def update_moving_stats(params, moving, batch):
    """MXNet's update of BatchNorm's moving statistics after a training
    forward, in place: ``m·moving + (1 - m)·batch`` for the mean and the
    (biased) variance, ``m`` the op's ``momentum`` (batch_norm.cc; the
    Gluon layer's formula); nothing with ``use_global_stats``."""
    if params.get("use_global_stats", False):
        return
    m = params.get("momentum", 0.9)
    with torch.no_grad():
        for r, b in zip(moving, batch):
            r.copy_(_moving_average(r, b, m))


def _moving_average(moving, batch, momentum):
    return momentum * moving + (1 - momentum) * batch


@register("_moving_stats_update", num_inputs=4, num_outputs=2,
          differentiable=False)
def _moving_stats_update(moving_mean, moving_var, batch_mean, batch_var,
                         momentum=0.9):
    """:func:`update_moving_stats`'s formula as one op for the mean and the
    variance, which the Gluon BatchNorm stores with ``out=`` the moving
    statistics (so ``mx.engine.bulk`` records it); not in the JAX build's
    registry."""
    return (_moving_average(moving_mean, batch_mean, momentum),
            _moving_average(moving_var, batch_var, momentum))


def _rsqrt(x):
    """``lax.rsqrt`` as XLA's CPU code rounds it: in f32, once, for bf16
    (ATen's CPU bf16 rsqrt rounds twice); 1 / sqrt with the sqrt rounded
    to f16 for f16."""
    if x.dtype == torch.float16:
        return 1.0 / torch.sqrt(x)
    return torch.rsqrt(x.float()).to(x.dtype)


@register("LayerNorm", num_inputs=3, input_names=("data", "gamma", "beta"),
          finfer_params=_layernorm_param_shapes)
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """ref: src/operator/nn/layer_norm.cc — biased variance.  Op by op in
    the data's dtype, as the JAX build (ops/nn.py:358-365): mean and var
    accumulate in f32 and round once to that dtype (``var_mean`` of a bf16
    or f16 tensor does so, as ``jnp.mean``/``jnp.var`` do), then
    ``(x - mean)·rsqrt(var + eps)`` with eps in that dtype, then
    ``·gamma + beta``, each step rounded; gamma and beta of another dtype
    promote the last two steps, as in jnp; rsqrt rounds as XLA's
    (:func:`_rsqrt`)."""
    var, mean = torch.var_mean(data, dim=axis, keepdim=True, correction=0)
    out = (data - mean) * _rsqrt(var + scalar_like(data, eps))
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("Activation", num_inputs=1)
def _activation(data, act_type="relu"):
    """ref: activation.cc.  sigmoid and softrelu follow ``jax.nn.sigmoid``
    (1 / (1 + exp(-x))) and ``jax.nn.softplus`` (max(x, 0) +
    log1p(exp(-|x|))) op by op, so bf16 and f16 round where the JAX build
    does."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return 1.0 / (torch.exp(-data) + 1.0)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        out = torch.clamp_min(data, 0) + torch.log1p(torch.exp(-data.abs()))
        return torch.where(torch.isnan(data), data, out)
    if act_type == "softsign":
        return torch.nn.functional.softsign(data)
    raise ValueError("unknown act_type %r" % act_type)


def _softmax_of(x, axis):
    """``jax.nn.softmax``: exp(x - max) in x's dtype, its sum accumulated in
    f32 and rounded once to that dtype, then the division."""
    e = torch.exp(x - x.amax(dim=axis, keepdim=True))
    return e / e.sum(dim=axis, keepdim=True, dtype=torch.float32).to(e.dtype)


@register("softmax", num_inputs=1)
def _softmax(data, axis=-1, temperature=None):
    """ref: src/operator/nn/softmax.cc, as ``jax.nn.softmax``."""
    x = data / scalar_like(data, temperature) if temperature else data
    return _softmax_of(x, axis)


@register("log_softmax", num_inputs=1)
def _log_softmax(data, axis=-1, temperature=None):
    """As ``jax.nn.log_softmax``: shifted = x - max (the max a constant of
    the gradient), then shifted - log(sum(exp(shifted))), each step in the
    data's dtype, the sum accumulated in f32 and rounded once."""
    x = data / scalar_like(data, temperature) if temperature else data
    shifted = x - x.amax(dim=axis, keepdim=True).detach()
    total = torch.exp(shifted).sum(dim=axis, keepdim=True,
                                   dtype=torch.float32).to(x.dtype)
    return shifted - torch.log(total)


def _one_hot(label, k, axis, dtype):
    """``jax.nn.one_hot(label, k, axis=axis)``: a label outside [0, k) (an
    ignored one) is a row of zeros."""
    lab = label.to(torch.int64).unsqueeze(axis)
    shape = [1] * lab.ndim
    shape[axis] = k
    classes = torch.arange(k, device=label.device).reshape(shape)
    return (lab == classes).to(dtype)


class _OutputFunction(torch.autograd.Function):
    """An ``*Output`` op: ``fwd_fn(data, label)`` forward and the integrated
    gradient ``grad_fn(data, label)``, which ignores the head gradient, as
    the reference's output layers do (trap A3; the JAX build's
    ``_custom_loss_fwd_bwd``, ops/nn.py:471)."""

    @staticmethod
    def forward(ctx, data, label, fwd_fn, grad_fn):
        ctx.save_for_backward(data, label)
        ctx.grad_fn = grad_fn
        return fwd_fn(data, label)

    @staticmethod
    def backward(ctx, grad_out):
        data, label = ctx.saved_tensors
        return ctx.grad_fn(data, label), None, None, None


@register("SoftmaxOutput", num_inputs=2, nograd_inputs=(1,),
          input_names=("data", "label"), aliases=("Softmax",))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """ref: src/operator/softmax_output.cc (the JAX build's ops/nn.py:490-520):
    the forward is softmax(data); the backward is softmax - onehot(label),
    label-smoothed by ``smooth_alpha``, zero where ``use_ignore`` finds
    ``ignore_label``, times ``grad_scale`` (over the batch for
    ``normalization='batch'``, over the valid labels for ``'valid'``), and
    the head gradient is ignored.  Scalars round to the data's dtype."""
    axis = 1 if (multi_output or preserve_shape or data.ndim > 2) else -1

    def grad_fn(d, lab):
        def c(x):
            return scalar_like(d, x)
        p = _softmax_of(d, axis)
        k = d.shape[axis]
        oh = _one_hot(lab, k, axis % d.ndim, d.dtype)
        if smooth_alpha:
            oh = oh * c(1 - smooth_alpha) + c(smooth_alpha / (k - 1)) * \
                (c(1) - oh)
        g = p - oh
        if use_ignore:
            valid = (lab != ignore_label).to(d.dtype)
            g = g * valid.unsqueeze(axis % d.ndim)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / d.shape[0]
        elif normalization == "valid" and use_ignore:
            nvalid = (lab != ignore_label).sum().clamp_min(1).to(d.dtype)
            return g * (c(grad_scale) / nvalid)
        return g * c(scale)

    return _OutputFunction.apply(data, label,
                                 lambda d, lab: _softmax_of(d, axis), grad_fn)


# ---------------------------------------------------------------------------
# the rest of the JAX build's ops/nn.py
# ---------------------------------------------------------------------------

def _upsample_nearest(x, out_hw):
    """Each pixel repeated to ``out_hw``, whose sides are multiples of x's."""
    sh, sw = out_hw[0] // x.shape[2], out_hw[1] // x.shape[3]
    return x.repeat_interleave(sh, dim=2).repeat_interleave(sw, dim=3)


@register("UpSampling", num_inputs=None)
def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    """ref: src/operator/upsampling.cc.  ``nearest``: every input repeated
    to the first's size times ``scale``, then concatenated on channels (or
    summed, ``multi_input_mode="sum"``).  ``bilinear``: MXNet's
    Deconvolution of the data with the weight input (args[1], shape
    (num_filter, 1, k, k)): kernel 2·scale - scale % 2, stride scale, pad
    ceil((scale - 1) / 2), ``num_group = num_filter``, no bias.  The JAX
    build resizes with ``jax.image.resize`` and ignores the weight, and
    its nearest mode reads only the first input (ROADMAP, reference-side
    faults)."""
    data = args[0]
    scale = int(scale)
    if sample_type == "nearest":
        out_hw = (data.shape[2] * scale, data.shape[3] * scale)
        ups = [_upsample_nearest(x, out_hw) for x in args]
        if len(ups) == 1:
            return ups[0]
        if multi_input_mode == "sum":
            out = ups[0]
            for u in ups[1:]:
                out = out + u
            return out
        return torch.cat(ups, dim=1)
    if sample_type != "bilinear":
        raise ValueError("unknown sample_type %r" % (sample_type,))
    if len(args) < 2:
        raise ValueError("bilinear UpSampling takes (data, weight)")
    k = 2 * scale - scale % 2
    pad = -(-(scale - 1) // 2)
    return _deconvolution(data, args[1], kernel=(k, k), stride=(scale, scale),
                          pad=(pad, pad), num_filter=num_filter,
                          num_group=num_filter or data.shape[1],
                          no_bias=True)


@register("InstanceNorm", num_inputs=3,
          input_names=("data", "gamma", "beta"),
          finfer_params=lambda ds, p: {"gamma": (ds[1],), "beta": (ds[1],)})
def _instance_norm(data, gamma, beta, eps=1e-3):
    """ref: src/operator/instance_norm.cc: each (sample, channel) over its
    spatial axes, biased variance, then ·gamma + beta by channel, op by op
    as the JAX build (rsqrt rounded as XLA's)."""
    red = tuple(range(2, data.ndim))
    var, mean = torch.var_mean(data, dim=red, keepdim=True, correction=0)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    out = (data - mean) * _rsqrt(var + scalar_like(data, eps))
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("LRN", num_inputs=1)
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels (ref: lrn.cc):
    data·(knorm + alpha / nsize · Σ x²)^-beta, the sum over the ``nsize``
    channels centred on each (zero-padded)."""
    sq = data * data
    half = nsize // 2
    pad = [0, 0] * (data.ndim - 2) + [half, half]
    padded = F.pad(sq, pad)
    c = data.shape[1]
    summed = padded[:, 0:c]
    for i in range(1, nsize):
        summed = summed + padded[:, i:i + c]
    base = scalar_like(data, knorm) + scalar_like(data, alpha / nsize) * summed
    return data * torch.pow(base, scalar_like(data, -beta))


def _leaky_draws(params, is_train):
    return params.get("act_type", "leaky") == "rrelu" and is_train


@register("LeakyReLU", num_inputs=None, needs_rng=_leaky_draws,
          takes_is_train=True, input_names=("data", "gamma"),
          fargnames=lambda p: ("data", "gamma")
          if p.get("act_type") == "prelu" else ("data",))
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, generator=None,
                is_train=False):
    """ref: src/operator/leaky_relu.cc.  ``leaky``: slope·x below 0;
    ``elu``: slope·(eˣ - 1); ``prelu``: gamma·x, gamma by channel (1-d) or
    broadcast; ``rrelu``: in training a slope per element drawn from
    U[lower_bound, upper_bound), otherwise their midpoint."""
    pos = data > 0
    if act_type == "leaky":
        return torch.where(pos, data, scalar_like(data, slope) * data)
    if act_type == "elu":
        return torch.where(pos, data,
                           scalar_like(data, slope) * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 else gamma
        return torch.where(pos, data, g * data)
    if act_type == "rrelu":
        if is_train:
            s = uniform_in(torch.empty(data.shape, dtype=data.dtype,
                                       device=data.device),
                           lower_bound, upper_bound, generator)
        else:
            s = scalar_like(data, (lower_bound + upper_bound) / 2.0)
        return torch.where(pos, data, s * data)
    raise ValueError("unknown act_type %r" % (act_type,))


@register("SoftmaxActivation", num_inputs=1)
def _softmax_activation(data, mode="instance"):
    """ref: softmax_activation.cc: over the channels (``mode="channel"``,
    axis 1) or over everything but the batch axis (``instance``)."""
    if mode == "channel":
        return _softmax_of(data, 1)
    return _softmax_of(data.reshape(data.shape[0], -1), -1).reshape(
        data.shape)


def _dropout_draws(params, is_train):
    return (is_train or params.get("mode", "training") == "always") and \
        params.get("p", 0.5) != 0.0


@register("Dropout", num_inputs=1, needs_rng=_dropout_draws,
          takes_is_train=True)
def _dropout(data, p=0.5, mode="training", axes=(), generator=None,
             is_train=False):
    """Inverted dropout (ref: src/operator/nn/dropout.cc): in training (or
    ``mode="always"``) each element is kept with probability 1 - p and
    divided by 1 - p, else zeroed; ``axes`` share one draw along them.
    The kept value is ``data / keep`` with ``keep`` in the data's dtype, as
    the JAX build divides (ops/nn.py:463), not ``data·(1/keep)``, which
    differs by an ulp in bf16 and f16.  The gradient is mask / keep."""
    if not _dropout_draws(dict(p=p, mode=mode), is_train):
        return data
    shape = tuple(1 if i in axes else n for i, n in enumerate(data.shape)) \
        if axes else tuple(data.shape)
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=data.device) < keep
    return torch.where(mask, data / scalar_like(data, keep),
                       torch.zeros((), dtype=data.dtype, device=data.device))


def _identity(d, lab):
    return d


def _regression(data, label, grad_fn):
    return _OutputFunction.apply(data, label, _identity, grad_fn)


@register("LinearRegressionOutput", num_inputs=2, nograd_inputs=(1,),
          input_names=("data", "label"))
def _linear_regression_output(data, label, grad_scale=1.0):
    """ref: regression_output.cc: the forward is the data; the gradient
    (data - label)·grad_scale, whatever the head gradient."""
    return _regression(data, label, lambda d, lab: (
        d - lab.reshape(d.shape)) * scalar_like(d, grad_scale))


@register("MAERegressionOutput", num_inputs=2, nograd_inputs=(1,),
          input_names=("data", "label"))
def _mae_regression_output(data, label, grad_scale=1.0):
    """Gradient sign(data - label)·grad_scale."""
    return _regression(data, label, lambda d, lab: torch.sign(
        d - lab.reshape(d.shape)) * scalar_like(d, grad_scale))


def _sigmoid(x):
    return 1.0 / (torch.exp(-x) + 1.0)


@register("LogisticRegressionOutput", num_inputs=2, nograd_inputs=(1,),
          input_names=("data", "label"))
def _logistic_regression_output(data, label, grad_scale=1.0):
    """The forward is sigmoid(data); the gradient (sigmoid(data) -
    label)·grad_scale."""
    return _OutputFunction.apply(
        data, label, lambda d, lab: _sigmoid(d),
        lambda d, lab: (_sigmoid(d) - lab.reshape(d.shape)) *
        scalar_like(d, grad_scale))


@register("SVMOutput", num_inputs=2, nograd_inputs=(1,),
          input_names=("data", "label"))
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    """ref: src/operator/svm_output.cc, as the JAX build computes it: the
    forward is the data; the gradient of the L1 hinge (``use_linear``) or
    of the squared hinge against the label's score, times
    ``regularization_coefficient``."""
    def grad_fn(d, lab):
        oh = _one_hot(lab, d.shape[1], 1, d.dtype)
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        m = scalar_like(d, margin)
        if use_linear:
            viol = ((m - d) * oh + (m + d) * (1 - oh)) > 0
            g = torch.where(viol, (1 - oh) - oh, zero)
        else:
            score_y = (d * oh).sum(dim=1, keepdim=True)
            viol = (d - score_y + m) > 0
            g_other = torch.where(viol & (oh == 0),
                                  2.0 * (d - score_y + m), zero)
            g = g_other - oh * g_other.sum(dim=1, keepdim=True)
        return (g * scalar_like(d, regularization_coefficient)).to(d.dtype)

    return _OutputFunction.apply(data, label, _identity, grad_fn)
