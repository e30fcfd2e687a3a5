"""VGG 11/13/16/19, plain and with BatchNorm, of the model zoo
(counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/vgg.py``;
ref: python/mxnet/gluon/model_zoo/vision/vgg.py).

Stage layout of Simonyan & Zisserman (1409.1556, configs A/B/D/E); the
features, the head and the eight factories are stamped from ``vgg_spec``.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, Dense, Dropout, MaxPool2D,
                   BatchNorm, Activation)
from .... import initializer
from ._factories import no_pretrained, stamp_factory

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]

# depth -> (conv repeats per stage, stage widths)
vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(HybridBlock):
    """Per stage, ``reps`` 3x3 convolutions (each with BatchNorm when
    ``batch_norm``) then a 2x max-pool; two dropout-regularised 4096-wide
    Dense layers feed the classifier."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("VGG: %d stages of repeats, %d widths"
                             % (len(layers), len(filters)))
        with self.name_scope():
            feats = HybridSequential(prefix="")
            for reps, width in zip(layers, filters):
                for _ in range(reps):
                    feats.add(Conv2D(
                        width, kernel_size=3, padding=1,
                        weight_initializer=initializer.Xavier(
                            rnd_type="gaussian", factor_type="out",
                            magnitude=2),
                        bias_initializer="zeros"))
                    if batch_norm:
                        feats.add(BatchNorm())
                    feats.add(Activation("relu"))
                feats.add(MaxPool2D(strides=2))
            for _ in range(2):
                feats.add(Dense(4096, activation="relu",
                                weight_initializer="normal",
                                bias_initializer="zeros"))
                feats.add(Dropout(rate=0.5))
            self.features = feats
            self.output = Dense(classes, weight_initializer="normal",
                                bias_initializer="zeros")

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """A VGG by depth; ``pretrained=True`` raises ``MXNetError``."""
    if num_layers not in vgg_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, str(sorted(vgg_spec))))
    if pretrained:
        raise no_pretrained("vgg%d%s" % (
            num_layers, "_bn" if kwargs.get("batch_norm") else ""))
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


for _depth in sorted(vgg_spec):
    stamp_factory(globals(), "vgg%d" % _depth,
                  "VGG-%d from vgg_spec." % _depth, get_vgg, _depth)
    stamp_factory(globals(), "vgg%d_bn" % _depth,
                  "VGG-%d with batch normalisation." % _depth,
                  get_vgg, _depth, batch_norm=True)
del _depth
