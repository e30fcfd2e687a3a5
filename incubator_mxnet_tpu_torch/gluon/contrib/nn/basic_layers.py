"""Contrib layers: parallel composition and identity (counterpart of
``incubator_mxnet_tpu/gluon/contrib/nn/basic_layers.py``; ref:
python/mxnet/gluon/contrib/nn/basic_layers.py)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn.basic_layers import HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity"]


class Concurrent(Sequential):
    """Feeds the input to every child and concatenates their outputs on
    ``axis`` (ref: basic_layers.py Concurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as nd
        return nd.concat(*[block(x) for block in self._children],
                         dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable :class:`Concurrent` (ref: basic_layers.py
    HybridConcurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children],
                        dim=self.axis)


class Identity(HybridBlock):
    """Returns its input, e.g. the skip branch of a HybridConcurrent (ref:
    basic_layers.py Identity)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x
