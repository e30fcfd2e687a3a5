"""ResNet V1 and V2 of the model zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py``; ref:
python/mxnet/gluon/model_zoo/vision/resnet.py).

Depths 18/34/50/101/152 with the published block counts and stage widths:
He et al., "Deep Residual Learning" (V1, post-activation) and "Identity
Mappings in Deep Residual Networks" (V2, pre-activation).  Every block
flavour comes from one ``_ResidualUnit`` built from a declarative conv
plan, and the ten ``resnetNN_vM`` factories are stamped from
``resnet_spec``; parameter names match the JAX build's one to one
(``tests/data/zoo_param_names.json``).  ``pretrained=True`` raises: the
zoo's weight files are not in the repository and nothing is downloaded.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, BatchNorm, Activation, Dense,
                   MaxPool2D, GlobalAvgPool2D, Flatten)
from ._factories import no_pretrained

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _conv(width, kernel, stride, pad, bias, in_channels=0):
    return Conv2D(width, kernel_size=kernel, strides=stride, padding=pad,
                  use_bias=bias, in_channels=in_channels)


class _ResidualUnit(HybridBlock):
    """One residual unit, built from the subclass's declarative conv plan.

    ``_plan(channels, stride)`` yields ``(width, kernel, stride, pad,
    use_bias)`` rows for the trunk convolutions.  ``preact=False`` gives the
    V1 layout (conv→BN→relu trunk, projection shortcut with BN, relu after
    the add); ``preact=True`` gives the V2 layout (BN→relu→conv trunk, bare
    projection conv fed the first pre-activation, no post-add relu).
    """

    preact = False

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        rows = self._plan(channels, stride)
        self._n_convs = len(rows)
        if self.preact:
            for i, row in enumerate(rows):
                setattr(self, "bn%d" % i, BatchNorm())
                setattr(self, "conv%d" % i, _conv(*row))
            self.downsample = (_conv(channels, 1, stride, 0, False,
                                     in_channels)
                               if downsample else None)
        else:
            self.body = HybridSequential(prefix="")
            for i, row in enumerate(rows):
                self.body.add(_conv(*row))
                self.body.add(BatchNorm())
                if i + 1 < len(rows):
                    self.body.add(Activation("relu"))
            if downsample:
                self.downsample = HybridSequential(prefix="")
                self.downsample.add(_conv(channels, 1, stride, 0, False,
                                          in_channels))
                self.downsample.add(BatchNorm())
            else:
                self.downsample = None

    def hybrid_forward(self, F, x):
        shortcut = x
        if self.preact:
            for i in range(self._n_convs):
                x = getattr(self, "bn%d" % i)(x)
                x = F.Activation(x, act_type="relu")
                if i == 0 and self.downsample is not None:
                    shortcut = self.downsample(x)
                x = getattr(self, "conv%d" % i)(x)
            return x + shortcut
        x = self.body(x)
        if self.downsample is not None:
            shortcut = self.downsample(shortcut)
        return F.Activation(x + shortcut, act_type="relu")


class BasicBlockV1(_ResidualUnit):
    """Two 3×3 convs, post-activation (ResNet-18/34 V1)."""

    @staticmethod
    def _plan(channels, stride):
        return [(channels, 3, stride, 1, False),
                (channels, 3, 1, 1, False)]


class BottleneckV1(_ResidualUnit):
    """1×1 → 3×3 → 1×1 bottleneck, post-activation (ResNet-50/101/152 V1).

    Stride sits on the leading 1×1 and the 1×1 convs keep their bias —
    quirks of the MXNet-1.x zoo retained for checkpoint compatibility.
    """

    @staticmethod
    def _plan(channels, stride):
        return [(channels // 4, 1, stride, 0, True),
                (channels // 4, 3, 1, 1, False),
                (channels, 1, 1, 0, True)]


class BasicBlockV2(_ResidualUnit):
    """Two 3×3 convs, pre-activation (ResNet-18/34 V2)."""

    preact = True

    @staticmethod
    def _plan(channels, stride):
        return [(channels, 3, stride, 1, False),
                (channels, 3, 1, 1, False)]


class BottleneckV2(_ResidualUnit):
    """1×1 → 3×3 → 1×1 bottleneck, pre-activation; stride on the 3×3."""

    preact = True

    @staticmethod
    def _plan(channels, stride):
        return [(channels // 4, 1, 1, 0, False),
                (channels // 4, 3, stride, 1, False),
                (channels, 1, 1, 0, False)]


class _ResNet(HybridBlock):
    """Stage-driven trunk shared by both ResNet versions.

    ``version`` selects the V1/V2 framing: V2 normalises the input with a
    parameter-free BatchNorm before the stem and finishes with BN→relu
    before pooling (pre-activation nets keep their trunk un-normalised at
    the seams).
    """

    version = 1

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("need one more channel count than stages, got "
                             "%r and %r" % (layers, channels))
        v2 = self.version == 2
        with self.name_scope():
            feats = HybridSequential(prefix="")
            if v2:
                feats.add(BatchNorm(scale=False, center=False))
            if thumbnail:
                feats.add(_conv(channels[0], 3, 1, 1, False))
            else:
                feats.add(Conv2D(channels[0], 7, 2, 3, use_bias=False))
                feats.add(BatchNorm())
                feats.add(Activation("relu"))
                feats.add(MaxPool2D(3, 2, 1))
            for i, reps in enumerate(layers):
                stage = HybridSequential(prefix="stage%d_" % (i + 1))
                width, prev = channels[i + 1], channels[i]
                with stage.name_scope():
                    stage.add(block(width, 1 if i == 0 else 2, width != prev,
                                    in_channels=prev, prefix=""))
                    for _ in range(reps - 1):
                        stage.add(block(width, 1, False, in_channels=width,
                                        prefix=""))
                feats.add(stage)
            if v2:
                feats.add(BatchNorm())
                feats.add(Activation("relu"))
            feats.add(GlobalAvgPool2D())
            if v2:
                feats.add(Flatten())
            self.features = feats
            self.output = Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    version = 1


class ResNetV2(_ResNet):
    version = 2


# depth -> (block kind, per-stage block counts, stage widths incl. stem)
resnet_spec = {18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
               34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
               50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
               101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
               152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [{"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1},
                         {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """Build a ResNet by (version, depth).  ``pretrained=True`` raises
    ``MXNetError``: the zoo's weight files are not in the repository."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, str(sorted(resnet_spec))))
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    if pretrained:
        raise no_pretrained("resnet%d_v%d" % (num_layers, version))
    kind, layers, channels = resnet_spec[num_layers]
    return resnet_net_versions[version - 1](
        resnet_block_versions[version - 1][kind], layers, channels, **kwargs)


from ._factories import stamp_factory  # noqa: E402

for _version in (1, 2):
    for _depth in sorted(resnet_spec):
        stamp_factory(globals(), "resnet%d_v%d" % (_depth, _version),
                      "ResNet-%d V%d from resnet_spec." % (_depth, _version),
                      get_resnet, _version, _depth)
del _version, _depth
