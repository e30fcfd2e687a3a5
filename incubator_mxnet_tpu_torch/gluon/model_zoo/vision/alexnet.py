"""AlexNet of the model zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/alexnet.py``; ref:
python/mxnet/gluon/model_zoo/vision/alexnet.py).

The one-tower variant of Krizhevsky et al. the MXNet zoo ships, stamped
from a spec table; parameter names match the JAX build's
(``tests/data/zoo_param_names.json``).
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, Dense, Dropout, MaxPool2D,
                   Flatten)
from ._factories import load_pretrained

__all__ = ["AlexNet", "alexnet"]

# (width, kernel, stride, pad, max-pool after?)
_STEM = [(64, 11, 4, 2, True),
         (192, 5, 1, 2, True),
         (384, 3, 1, 1, False),
         (256, 3, 1, 1, False),
         (256, 3, 1, 1, True)]
_HEAD_WIDTH, _HEAD_DROP = 4096, 0.5


class AlexNet(HybridBlock):
    """Five-conv stem driven by ``_STEM``, two dropout-regularised Dense
    layers, and a linear classifier."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            feats = HybridSequential(prefix="")
            for width, kernel, stride, pad, pool in _STEM:
                feats.add(Conv2D(width, kernel_size=kernel, strides=stride,
                                 padding=pad, activation="relu"))
                if pool:
                    feats.add(MaxPool2D(pool_size=3, strides=2))
            feats.add(Flatten())
            for _ in range(2):
                feats.add(Dense(_HEAD_WIDTH, activation="relu"))
                feats.add(Dropout(_HEAD_DROP))
            self.features = feats
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    """AlexNet; ``pretrained=True`` loads ``alexnet.params`` from the
    model store."""
    return load_pretrained(AlexNet(**kwargs), pretrained, "alexnet", ctx,
                           root)
