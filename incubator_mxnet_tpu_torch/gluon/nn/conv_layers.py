"""Convolution and pooling Gluon layers (counterpart of
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``; ref:
python/mxnet/gluon/nn/conv_layers.py).

Conv1D/2D/3D, Conv1D/2D/3DTranspose, Max/Avg pooling and their global
forms, with the JAX build's parameter names, deferred ``in_channels`` and
``__repr__``; compute goes to the ``Convolution``, ``Deconvolution`` and
``Pooling`` ops (cuDNN convolutions on the card).  ``ceil_mode`` maps to
``pooling_convention="full"``.
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation, _init

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _to_tuple(v, n):
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise ValueError("expected %d values, got %r" % (n, v))
        return tuple(v)
    return (v,) * n


def _check_layout(layout, want):
    if layout != want:
        raise ValueError("Only supports %s layout for now" % want)


class _Conv(HybridBlock):
    """Base conv layer (ref: conv_layers.py class _Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="Convolution", adj=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides, "dilate": dilation,
                "pad": padding, "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj

            # weight shape: OIHW for conv, IOHW for deconv (ref:
            # deconvolution-inl.h stores (in, out/groups, *k))
            if op_name == "Deconvolution":
                wshapes = [in_channels, channels // groups] + list(kernel_size)
            else:
                wshapes = [channels, in_channels // groups] + list(kernel_size)
            self.weight = self.params.get("weight", shape=tuple(wshapes),
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,),
                    init=_init(bias_initializer),
                    allow_deferred_init=True)
            else:
                self.bias = None

            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _alias(self):
        return "conv"

    def _pre_infer(self, x):
        in_channels = x.shape[1]
        if self._op_name == "Deconvolution":
            if self.weight.shape and self.weight.shape[0] == 0:
                self.weight.shape = tuple(
                    [in_channels, self._channels // self._kwargs["num_group"]]
                    + list(self._kwargs["kernel"]))
        elif self.weight.shape and self.weight.shape[1] == 0:
            w = list(self.weight.shape)
            w[1] = in_channels // self._kwargs["num_group"]
            self.weight.shape = tuple(w)

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            act = op(x, weight, **self._kwargs)
        else:
            act = op(x, weight, bias, **self._kwargs)
        if self.act is not None:
            act = self.act(act)
        return act

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        len_kernel_size = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * len_kernel_size:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * len_kernel_size:
            s += ", dilation={dilate}"
        if self._kwargs["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        s += ")"
        shape = self.weight.shape
        return s.format(name=self.__class__.__name__,
                        mapping="{0} -> {1}".format(shape[1] if shape[1] else None,
                                                    shape[0]),
                        **self._kwargs)


class Conv1D(_Conv):
    """ref: conv_layers.py class Conv1D (NCW)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0, dilation=1,
                 groups=1, layout="NCW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 1)
        super().__init__(channels, kernel_size, _to_tuple(strides, 1),
                         _to_tuple(padding, 1), _to_tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    """ref: conv_layers.py class Conv2D (NCHW)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 2)
        super().__init__(channels, kernel_size, _to_tuple(strides, 2),
                         _to_tuple(padding, 2), _to_tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    """ref: conv_layers.py class Conv3D (NCDHW)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 3)
        super().__init__(channels, kernel_size, _to_tuple(strides, 3),
                         _to_tuple(padding, 3), _to_tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    """ref: conv_layers.py class Conv1DTranspose."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 1)
        super().__init__(channels, kernel_size, _to_tuple(strides, 1),
                         _to_tuple(padding, 1), _to_tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_to_tuple(output_padding, 1), **kwargs)
        self.outpad = _to_tuple(output_padding, 1)


class Conv2DTranspose(_Conv):
    """ref: conv_layers.py class Conv2DTranspose."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 2)
        super().__init__(channels, kernel_size, _to_tuple(strides, 2),
                         _to_tuple(padding, 2), _to_tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_to_tuple(output_padding, 2), **kwargs)
        self.outpad = _to_tuple(output_padding, 2)


class Conv3DTranspose(_Conv):
    """ref: conv_layers.py class Conv3DTranspose."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0), dilation=(1, 1, 1),
                 groups=1, layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        kernel_size = _to_tuple(kernel_size, 3)
        super().__init__(channels, kernel_size, _to_tuple(strides, 3),
                         _to_tuple(padding, 3), _to_tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name="Deconvolution",
                         adj=_to_tuple(output_padding, 3), **kwargs)
        self.outpad = _to_tuple(output_padding, 3)


class _Pooling(HybridBlock):
    """Base pooling (ref: conv_layers.py class _Pooling → Pooling op)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        if isinstance(strides, int):
            strides = (strides,) * len(pool_size)
        if isinstance(padding, int):
            padding = (padding,) * len(pool_size)
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "{name}(size={kernel}, stride={stride}, padding={pad}, " \
            "ceil_mode={ceil_mode})".format(
                name=self.__class__.__name__,
                ceil_mode=self._kwargs["pooling_convention"] == "full",
                **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        _check_layout(layout, "NCW")
        super().__init__(_to_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, layout="NCHW",
                 ceil_mode=False, **kwargs):
        _check_layout(layout, "NCHW")
        super().__init__(_to_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        _check_layout(layout, "NCDHW")
        super().__init__(_to_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        _check_layout(layout, "NCW")
        super().__init__(_to_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0, layout="NCHW",
                 ceil_mode=False, **kwargs):
        _check_layout(layout, "NCHW")
        super().__init__(_to_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        _check_layout(layout, "NCDHW")
        super().__init__(_to_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "max", **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "avg", **kwargs)
