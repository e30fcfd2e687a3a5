"""Inception V3 of the model zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/inception.py``; ref:
python/mxnet/gluon/model_zoo/vision/inception.py).  Its blocks run
parallel branches concatenated on channels (``_Concurrent``, the JAX
build's inlined ``HybridConcurrent``)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, BatchNorm, Activation, Dense,
                   MaxPool2D, AvgPool2D, Dropout)
from ._factories import no_pretrained

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = HybridSequential(prefix="")
    out.add(Conv2D(use_bias=False, **kwargs))
    out.add(BatchNorm(epsilon=0.001))
    out.add(Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    """An optional pool (``"avg"`` 3x3/1 padded, ``"max"`` 3x3/2), then a
    basic conv per (channels, kernel_size, strides, padding) row, None for
    a default."""
    out = HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {setting_names[i]: value for i, value in enumerate(setting)
                  if value is not None}
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches on one input, concatenated on ``axis``."""

    def __init__(self, axis=1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.Concat(*[blk(x) for blk in self._children], dim=self._axis)


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)), (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _SplitConcat(HybridBlock):
    """``head``, then its output through each of ``tails``, concatenated on
    channels."""

    def __init__(self, head, tails, **kwargs):
        super().__init__(**kwargs)
        self.head = head
        for t in tails:
            self.register_child(t)
        self._tails = tails

    def hybrid_forward(self, F, x):
        x = self.head(x)
        return F.Concat(*[t(x) for t in self._tails], dim=1)


def _sequential_of(*blocks):
    seq = HybridSequential(prefix="")
    for b in blocks:
        seq.add(b)
    return seq


def _make_E(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (320, 1, None, None)))
        out.add(_SplitConcat(
            _make_basic_conv(channels=384, kernel_size=1),
            [_make_basic_conv(channels=384, kernel_size=(1, 3),
                              padding=(0, 1)),
             _make_basic_conv(channels=384, kernel_size=(3, 1),
                              padding=(1, 0))]))
        out.add(_SplitConcat(
            _sequential_of(
                _make_basic_conv(channels=448, kernel_size=1),
                _make_basic_conv(channels=384, kernel_size=3, padding=1)),
            [_make_basic_conv(channels=384, kernel_size=(1, 3),
                              padding=(0, 1)),
             _make_basic_conv(channels=384, kernel_size=(3, 1),
                              padding=(1, 0))]))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    """ref: inception.py class Inception3 (299x299 input)."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(AvgPool2D(pool_size=8))
            self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    """Inception V3; ``pretrained=True`` raises ``MXNetError``."""
    if pretrained:
        raise no_pretrained("inceptionv3")
    return Inception3(**kwargs)
