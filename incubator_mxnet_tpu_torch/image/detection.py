"""Detection data pipeline: augmenters and ImageDetIter.

Counterpart of ``incubator_mxnet_tpu/image/detection.py`` (ref:
python/mxnet/image/detection.py and src/io/image_det_aug_default.cc):
box-aware augmentation (constrained random crop, random expansion, flips)
and ``ImageDetIter``, whose labels are padded (batch, max_objects, 5+)
blocks for SSD training (BASELINE config 4).

Labels flow as numpy (n_objects, 5+) rows ``[cls, xmin, ymin, xmax, ymax,
...]`` with corner coordinates normalized to [0, 1]; batches pad with -1
rows (the convention MultiBoxTarget consumes).  Samples are decoded and
augmented on ``cpu(0)``; batches land on ``ctx`` as in ``ImageIter``.
"""
from __future__ import annotations

import json
import logging
import random as pyrandom

import numpy as np
import torch

from .. import io as io_mod
from .. import ndarray as nd
from ..context import cpu
from ..ndarray import NDArray
from .image import (Augmenter, ImageIter, fixed_crop, imdecode, imresize)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


def _box_areas(boxes):
    """Areas of (n, 4) corner boxes, clipped at zero."""
    return (np.maximum(0, boxes[:, 2] - boxes[:, 0])
            * np.maximum(0, boxes[:, 3] - boxes[:, 1]))


class DetAugmenter(object):
    """Base detection augmenter: __call__(src, label) → (src, label)
    (ref: detection.py DetAugmenter:39)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline; the label
    passes through (ref: detection.py DetBorrowAug:65)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("DetBorrowAug requires an image Augmenter")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Apply one randomly chosen augmenter (or none, with ``skip_prob``)
    (ref: detection.py DetRandomSelectAug:90)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or pyrandom.random() < self.skip_prob:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and x-coordinates together with probability p
    (ref: detection.py DetHorizontalFlipAug:126)."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = NDArray(torch.flip(src._data, [1]), ctx=src.context) \
                if isinstance(src, NDArray) else src[:, ::-1]
            out = label.copy()
            out[:, 1] = 1.0 - label[:, 3]
            out[:, 3] = 1.0 - label[:, 1]
            label = out
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Constrained random crop: sampled windows must cover at least
    ``min_object_covered`` of some object; surviving boxes are re-mapped
    into the crop and dropped below ``min_eject_coverage``
    (ref: detection.py DetRandomCropAug:152)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.enabled = (0 < area_range[0] <= area_range[1]
                        and 0 < aspect_ratio_range[0] <= aspect_ratio_range[1])

    def _remap_labels(self, label, x, y, w, h, H, W):
        """Re-express labels inside crop (x, y, w, h) pixels; None if no
        box survives the eject threshold."""
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] - x / W) * (W / w)
        out[:, (2, 4)] = (out[:, (2, 4)] - y / H) * (H / h)
        clipped = out.copy()
        clipped[:, 1:5] = np.clip(out[:, 1:5], 0.0, 1.0)
        orig_areas = _box_areas(label[:, 1:5])
        new_areas = _box_areas(clipped[:, 1:5]) * (w * h) / (W * H)
        with np.errstate(divide="ignore", invalid="ignore"):
            coverage = np.where(orig_areas > 0, new_areas / orig_areas, 0.0)
        valid = ((clipped[:, 3] > clipped[:, 1])
                 & (clipped[:, 4] > clipped[:, 2])
                 & (coverage > self.min_eject_coverage))
        if not valid.any():
            return None
        return clipped[valid]

    def __call__(self, src, label):
        H, W = src.shape[0], src.shape[1]
        if not self.enabled or H <= 0 or W <= 0:
            return src, label
        boxes = label[:, 1:5]
        areas = _box_areas(boxes)
        for _ in range(self.max_attempts):
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            area = pyrandom.uniform(*self.area_range) * H * W
            h = int(round(np.sqrt(area / ratio)))
            w = int(round(h * ratio))
            if h <= 0 or w <= 0 or h > H or w > W:
                continue
            y = pyrandom.randint(0, H - h)
            x = pyrandom.randint(0, W - w)
            # min_object_covered: some valid object keeps enough area
            ix1 = np.maximum(boxes[:, 0], x / W)
            iy1 = np.maximum(boxes[:, 1], y / H)
            ix2 = np.minimum(boxes[:, 2], (x + w) / W)
            iy2 = np.minimum(boxes[:, 3], (y + h) / H)
            inter = (np.maximum(0, ix2 - ix1) * np.maximum(0, iy2 - iy1))
            with np.errstate(divide="ignore", invalid="ignore"):
                cover = np.where(areas > 0, inter / areas, 0.0)
            cover = cover[cover > 0]
            if cover.size == 0 or cover.min() <= self.min_object_covered:
                continue
            new_label = self._remap_labels(label, x, y, w, h, H, W)
            if new_label is not None:
                return fixed_crop(src, x, y, w, h, None), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expansion: place the image inside a larger canvas filled
    with ``pad_val`` and shrink the labels accordingly
    (ref: detection.py DetRandomPadAug:324)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val
        self.enabled = (area_range[1] >= 1.0
                        and 0 < aspect_ratio_range[0] <= aspect_ratio_range[1])

    def __call__(self, src, label):
        H, W = src.shape[0], src.shape[1]
        if not self.enabled or H <= 0 or W <= 0:
            return src, label
        arr = src.asnumpy() if hasattr(src, "asnumpy") else np.asarray(src)
        for _ in range(self.max_attempts):
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            area = pyrandom.uniform(*self.area_range) * H * W
            nh = int(round(np.sqrt(area / ratio)))
            nw = int(round(nh * ratio))
            if nh < H or nw < W:
                continue
            y = pyrandom.randint(0, nh - H)
            x = pyrandom.randint(0, nw - W)
            canvas = np.empty((nh, nw, arr.shape[2]), arr.dtype)
            canvas[:] = np.asarray(self.pad_val, arr.dtype)
            canvas[y:y + H, x:x + W] = arr
            out = label.copy()
            out[:, (1, 3)] = (out[:, (1, 3)] * W + x) / nw
            out[:, (2, 4)] = (out[:, (2, 4)] * H + y) / nh
            ctx = src.context if isinstance(src, NDArray) else None
            return nd.array(canvas, dtype=arr.dtype, ctx=ctx), out
        return src, label


class _DetResizeAug(DetAugmenter):
    """Force resize to (w, h); normalized labels are untouched."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        return imresize(src, self.size[0], self.size[1],
                        self.interp), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmenter pipeline
    (ref: detection.py CreateDetAugmenter:483).  ``rand_crop``/``rand_pad``
    are probabilities of applying the constrained crop / expansion."""
    auglist = []
    if resize > 0:
        auglist.append(_DetResizeAug((resize, resize), inter_method))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(1.0, area_range[0]), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    # photometric augs borrowed from the classification pipeline
    from .image import (ColorJitterAug, HueJitterAug, LightingAug,
                        RandomGrayAug)
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    auglist.append(_DetResizeAug((data_shape[2], data_shape[1]),
                                 inter_method))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        from .image import ColorNormalizeAug
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: ImageIter + object labels padded to a fixed
    (max_objects, label_width) block per image
    (ref: detection.py ImageDetIter:625)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 ctx=None, **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, path_imgidx=path_imgidx,
                         shuffle=shuffle, part_index=part_index,
                         num_parts=num_parts, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name, ctx=ctx)
        if aug_list is None:
            self.auglist = CreateDetAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.label_shape = self._estimate_label_shape()
        self._provide_label = [io_mod.DataDesc(
            label_name, (self.batch_size,) + self.label_shape, "float32")]

    @staticmethod
    def _parse_label(label):
        """Raw .lst/.rec label → (n_objects, obj_width) array.  Format:
        [header_width, obj_width, <header...>, obj0..., obj1...]
        (ref: detection.py _parse_label)."""
        raw = np.asarray(label, np.float32).ravel()
        if raw.size < 7:
            raise RuntimeError("Label is too short for detection: %s"
                               % (raw,))
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if obj_width < 5 or (raw.size - header_width) % obj_width != 0:
            raise RuntimeError("Label shape %s inconsistent with object "
                               "width %d" % (raw.shape, obj_width))
        out = raw[header_width:].reshape(-1, obj_width)
        valid = (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
        if not valid.any():
            raise RuntimeError("Sample with no valid label")
        return out[valid]

    def _estimate_label_shape(self):
        """Max object count over the dataset (one cheap pass)."""
        max_count, width = 0, 5
        self.reset()
        try:
            while True:
                label, _ = self.next_sample()
                obj = self._parse_label(label)
                max_count = max(max_count, obj.shape[0])
                width = obj.shape[1]
        except StopIteration:
            pass
        self.reset()
        return (max_count, width)

    def reshape(self, data_shape=None, label_shape=None):
        """ref: detection.py ImageDetIter.reshape."""
        if data_shape is not None:
            self._provide_data = [io_mod.DataDesc(
                self.provide_data[0][0],
                (self.batch_size,) + tuple(data_shape), "float32")]
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            self._provide_label = [io_mod.DataDesc(
                self.provide_label[0][0],
                (self.batch_size,) + tuple(label_shape), "float32")]
            self.label_shape = tuple(label_shape)

    def next(self):
        bs = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((bs, h, w, c), np.float32)
        batch_label = np.full((bs,) + self.label_shape, -1.0, np.float32)
        i = 0
        try:
            while i < bs:
                label, s = self.next_sample()
                try:
                    with cpu(0):
                        arr = imdecode(s)
                        obj = self._parse_label(label)
                        for aug in self.auglist:
                            arr, obj = aug(arr, obj)
                except RuntimeError as e:
                    logging.debug("Invalid sample, skipping: %s", e)
                    continue
                batch_data[i] = (arr.asnumpy()
                                 if hasattr(arr, "asnumpy") else arr)
                n = min(obj.shape[0], self.label_shape[0])
                batch_label[i, :n, :obj.shape[1]] = obj[:n]
                i += 1
        except StopIteration:
            if not i:
                raise
        data = nd.array(batch_data.transpose(0, 3, 1, 2), ctx=self._out_ctx)
        return io_mod.DataBatch(
            [data], [nd.array(batch_label, ctx=self._out_ctx)], bs - i)
