"""Vision transforms as Blocks (counterpart of
``incubator_mxnet_tpu/gluon/data/vision/transforms.py``): ToTensor,
Normalize, Resize, crops and flips on HWC images, on whichever device the
image lies.

``Resize`` and ``RandomResizedCrop`` compute ``jax.image.resize(...,
"bilinear")``'s function with torch's ``interpolate``: a triangle filter
widened by the scale where the image shrinks (``antialias=True``), the
plain bilinear sample where it grows.  The two agree to f32 rounding, not bit for
bit; an integer image is truncated back to its dtype after, as in the JAX
build.  The random transforms draw from ``np.random`` with the JAX build's
calls in its order; flips use ``torch.flip``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn.functional import interpolate

from ...block import Block, HybridBlock
from ...nn import Sequential
from .... import ndarray as _nd
from ....ndarray import NDArray

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom"]


def _bilinear(t, h, w):
    """An HWC tensor resized to (h, w) in f32, as ``jax.image.resize(t,
    (h, w, c), "bilinear")`` resizes it, then cast back to its dtype."""
    x = t.to(torch.float32).permute(2, 0, 1).unsqueeze(0)
    shrinks = h < x.shape[2] or w < x.shape[3]
    out = interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=shrinks)
    return out[0].permute(1, 2, 0).to(t.dtype).contiguous()


class Compose(Sequential):
    """Sequential transform composition (ref: transforms.py Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for i in transforms:
            if isinstance(i, Block):
                self.add(i)
            else:
                self.add(Lambda_(i))


class Lambda_(Block):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, x):
        return self._fn(x)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return x.astype(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 -> CHW float32 / 255 (ref: image/to_tensor op)."""

    def hybrid_forward(self, F, x):
        out = x.astype("float32") / 255.0
        return F.transpose(out, axes=(2, 0, 1))


class Normalize(HybridBlock):
    """(x - mean) / std per channel on CHW input."""

    def __init__(self, mean, std):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def hybrid_forward(self, F, x):
        mean = _nd.array(self._mean, ctx=x.context)
        std = _nd.array(self._std, ctx=x.context)
        return (x - mean) / std


class Resize(Block):
    """Resize an HWC image to ``size`` (w, h), bilinear."""

    def __init__(self, size, keep_ratio=False):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        return NDArray(_bilinear(x._data, self._size[1], self._size[0]),
                       ctx=x.context)


class CenterCrop(Block):
    def __init__(self, size):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return NDArray(x._data[y0:y0 + h, x0:x0 + w].clone(), ctx=x.context)


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = np.random.uniform(*self._scale) * area
            aspect = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target_area * aspect)))
            h = int(round(np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                crop = x._data[y0:y0 + h, x0:x0 + w]
                return NDArray(_bilinear(crop, self._size[1], self._size[0]),
                               ctx=x.context)
        return CenterCrop(self._size).forward(x)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return NDArray(torch.flip(x._data, [1]), ctx=x.context)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return NDArray(torch.flip(x._data, [0]), ctx=x.context)
        return x
