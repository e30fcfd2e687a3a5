"""SqueezeNet 1.0 and 1.1 of the model zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``; ref:
python/mxnet/gluon/model_zoo/vision/squeezenet.py)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, MaxPool2D, Dropout, AvgPool2D,
                   Flatten, Activation)
from ._factories import load_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "get_squeezenet"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    out.add(_FireExpand(expand1x1_channels, expand3x3_channels))
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = HybridSequential(prefix="")
    out.add(Conv2D(channels, kernel_size, padding=padding))
    out.add(Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    """The fire module's 1x1 and 3x3 expand paths, concatenated on
    channels."""

    def __init__(self, expand1x1_channels, expand3x3_channels, **kwargs):
        super().__init__(**kwargs)
        self.p1 = _make_fire_conv(expand1x1_channels, 1)
        self.p3 = _make_fire_conv(expand3x3_channels, 3, 1)

    def hybrid_forward(self, F, x):
        return F.Concat(self.p1(x), self.p3(x), dim=1)


# (squeeze, expand) of each fire module, "pool" for a 3x3/2 ceil max-pool
_PLANS = {
    "1.0": ((96, 7), ["pool", (16, 64), (16, 64), (32, 128), "pool",
                      (32, 128), (48, 192), (48, 192), (64, 256), "pool",
                      (64, 256)]),
    "1.1": ((64, 3), ["pool", (16, 64), (16, 64), "pool", (32, 128),
                      (32, 128), "pool", (48, 192), (48, 192), (64, 256),
                      (64, 256)]),
}


class SqueezeNet(HybridBlock):
    """ref: squeezenet.py class SqueezeNet (versions "1.0" and "1.1")."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _PLANS:
            raise ValueError("Unsupported SqueezeNet version %s: 1.0 or 1.1 "
                             "expected" % version)
        (stem, kernel), plan = _PLANS[version]
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(stem, kernel_size=kernel, strides=2))
            self.features.add(Activation("relu"))
            for step in plan:
                if step == "pool":
                    self.features.add(MaxPool2D(pool_size=3, strides=2,
                                                ceil_mode=True))
                else:
                    squeeze, expand = step
                    self.features.add(_make_fire(squeeze, expand, expand))
            self.features.add(Dropout(0.5))

            self.output = HybridSequential(prefix="")
            self.output.add(Conv2D(classes, kernel_size=1))
            self.output.add(Activation("relu"))
            self.output.add(AvgPool2D(13))
            self.output.add(Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, root=None,
                   **kwargs):
    """A SqueezeNet by version; ``pretrained=True`` loads its file from the
    model store."""
    return load_pretrained(SqueezeNet(version, **kwargs), pretrained,
                           "squeezenet%s" % version, ctx, root)


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
