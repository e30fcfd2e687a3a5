"""MobileNet V1 of the model zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``; ref:
python/mxnet/gluon/model_zoo/vision/mobilenet.py).

Depthwise-separable convolutions: the depthwise stage is a Convolution
with ``num_group`` equal to its channels (cuDNN's grouped kernels on the
card).
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, BatchNorm, Activation, Dense,
                   GlobalAvgPool2D, Flatten)
from ._factories import load_pretrained

__all__ = ["MobileNet", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "get_mobilenet"]


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False))
    out.add(BatchNorm(scale=True))
    out.add(Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels)
    _add_conv(out, channels)


class MobileNet(HybridBlock):
    """ref: mobilenet.py class MobileNet (width ``multiplier``)."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1)
                dw_channels = [int(x * multiplier)
                               for x in [32, 64] + [128] * 2 + [256] * 2
                               + [512] * 6 + [1024]]
                channels = [int(x * multiplier)
                            for x in [64] + [128] * 2 + [256] * 2
                            + [512] * 6 + [1024] * 2]
                strides = [1, 2] * 3 + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dwc, c, s)
                self.features.add(GlobalAvgPool2D())
                self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=None,
                  **kwargs):
    """A MobileNet by width multiplier; ``pretrained=True`` loads its file
    from the model store."""
    return load_pretrained(MobileNet(multiplier, **kwargs), pretrained,
                           "mobilenet%s" % multiplier, ctx, root)


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)
