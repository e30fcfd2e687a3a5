"""Image loading and augmentation (counterpart of
``incubator_mxnet_tpu/image/image.py``; ref: python/mxnet/image/image.py).

The host side of the data plane: decode (OpenCV, imported when a path
needs it; without it those paths raise ``MXNetError`` naming OpenCV), the
crop helpers, the augmenters over NDArrays pinned to ``cpu(0)``, and
``ImageIter``, the Python twin of the C++ ImageRecordIter
(src/io/iter_image_recordio_2.cc).  The augmenters draw from Python's
``random`` and from ``np.random`` with the JAX build's calls in its order,
so a seeded pipeline gives the same batches in both packages.  Batches land
on ``ctx``, or on the context current when the iterator is made (the card
unless the caller says ``mx.cpu()``).
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch

from .. import _native
from .. import config as _config
from .. import io as io_mod
from .. import ndarray as nd
from .. import recordio
from ..base import MXNetError, torch_dtype
from ..context import cpu, current_context
from ..ndarray import NDArray

__all__ = ["imdecode", "imread", "imresize", "scale_down", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "RandomOrderAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "RandomGrayAug", "HorizontalFlipAug", "CastAug", "CreateAugmenter",
           "Augmenter", "ImageIter"]


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode image bytes to an HWC uint8 NDArray with OpenCV (ref:
    image.py imdecode)."""
    cv2 = recordio.cv2_module("image.imdecode")
    img = cv2.imdecode(np.frombuffer(bytes(buf), np.uint8),
                       cv2.IMREAD_COLOR if flag else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError("Decoding image failed")
    if flag == 0:
        img = img[:, :, None]
    elif to_rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return nd.array(img, dtype=np.uint8)


def imread(filename, flag=1, to_rgb=True):
    """ref: image.py imread."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    """Resize to ``(w, h)`` with OpenCV (ref: image.py imresize; interp is
    cv2's 0..4)."""
    cv2 = recordio.cv2_module("image.imresize")
    return nd.array(cv2.resize(src.asnumpy(), (w, h), interpolation=interp),
                    dtype=src.dtype, ctx=src.context)


def scale_down(src_size, size):
    """Scale crop size if bigger than image (ref: image.py scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize the shorter edge to ``size`` (ref: image.py resize_short)."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """ref: image.py fixed_crop (a new array, not a view)."""
    out = NDArray(src._data[y0:y0 + h, x0:x0 + w].clone(), ctx=src.context)
    if size is not None and (w, h) != size:
        out = imresize(out, *size, interp=interp)
    return out


def random_crop(src, size, interp=2):
    """ref: image.py random_crop."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """ref: image.py center_crop."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    """ref: image.py color_normalize."""
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


def random_size_crop(src, size, area, ratio, interp=2):
    """Random area and aspect crop (ref: image.py random_size_crop)."""
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = random.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(random.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


class Augmenter(object):
    """Image augmenter base (ref: image.py class Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                v = v.asnumpy()
            if isinstance(v, np.ndarray):
                v = v.tolist()
            self._kwargs[k] = v

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    """ref: image.py ResizeAug (resize shorter edge)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """ref: image.py ForceResizeAug."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomOrderAug(Augmenter):
    """Apply augmenters in random order (ref: image.py RandomOrderAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        gray = src.asnumpy() * self._coef
        gray = (3.0 * (1.0 - alpha) / gray.size) * np.sum(gray)
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        gray = (src.asnumpy() * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + nd.array(gray * (1.0 - alpha), ctx=src.context)


class HueJitterAug(Augmenter):
    """ref: image.py HueJitterAug (rotation in YIQ)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = np.array([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]])
        self.ityiq = np.array([[1.0, 0.956, 0.621],
                               [1.0, -0.272, -0.647],
                               [1.0, -1.107, 1.705]])

    def __call__(self, src):
        alpha = random.uniform(-self.hue, self.hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
        t = np.dot(np.dot(self.ityiq, bt), self.tyiq).T
        return nd.array(np.dot(src.asnumpy(), np.array(t, np.float32)),
                        ctx=src.context)


class ColorJitterAug(RandomOrderAug):
    """ref: image.py ColorJitterAug."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """PCA lighting jitter (ref: image.py LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd, eigval=eigval, eigvec=eigvec)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval)
        self.eigvec = np.asarray(eigvec)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return src + nd.array(rgb.astype(np.float32), ctx=src.context)


class ColorNormalizeAug(Augmenter):
    """ref: image.py ColorNormalizeAug; ``mean`` and ``std`` are kept on
    the host and follow the image to its context."""

    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean if mean is None or isinstance(mean, NDArray) \
            else nd.array(np.asarray(mean, np.float32), ctx=cpu(0))
        self.std = std if std is None or isinstance(std, NDArray) \
            else nd.array(np.asarray(std, np.float32), ctx=cpu(0))

    def __call__(self, src):
        ctx = src.context
        return color_normalize(
            src, None if self.mean is None else self.mean.as_in_context(ctx),
            None if self.std is None else self.std.as_in_context(ctx))


class RandomGrayAug(Augmenter):
    _mat = np.array([[0.21, 0.21, 0.21],
                     [0.72, 0.72, 0.72],
                     [0.07, 0.07, 0.07]], np.float32)

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            src = nd.array(np.dot(src.asnumpy(), self._mat), ctx=src.context)
        return src


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            src = NDArray(torch.flip(src._data, [1]), ctx=src.context)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """Standard augmenter pipeline factory (ref: image.py CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and np.any(np.asarray(mean) > 0):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# the augmenters whose float output leaves 0..255 (it would wrap in a
# uint8 batch); geometric ones and the cast are safe
_UINT8_UNSAFE = (ColorNormalizeAug, LightingAug, ColorJitterAug, HueJitterAug,
                 BrightnessJitterAug, ContrastJitterAug, SaturationJitterAug)


class _NativeSeqReader(object):
    """``MXRecordIO``-shaped reader over the C++ prefetch reader
    (src/io/recordio.cc ``MXTPUPrefetchReader*``): ``read()`` returns
    payloads its thread framed ahead; ``reset()`` reopens (the reader is
    forward-only, like dmlc::ThreadedIter)."""

    def __init__(self, path, capacity=64):
        self._path = path
        self._capacity = capacity
        self._reads = 0
        self._reader = _native.NativePrefetchReader(path, capacity)

    def read(self):
        self._reads += 1
        return self._reader.read()

    def reset(self):
        if not self._reads:
            return      # a fresh reader (the reset() in __init__): keep it
        self._reader.close()
        self._reader = _native.NativePrefetchReader(self._path,
                                                    self._capacity)
        self._reads = 0

    def close(self):
        self._reader.close()


def _flatten_augs(augs):
    """Every augmenter, and those a composite (``.ts``) holds."""
    for a in augs:
        yield a
        yield from _flatten_augs(getattr(a, "ts", []))


class ImageIter(io_mod.DataIter):
    """Image iterator over .rec files or .lst lists and image folders, with
    augmenters (ref: image.py class ImageIter, the Python twin of
    ImageRecordIter).

    ``preprocess_threads`` > 1 decodes and augments a batch on a thread pool
    (cv2, numpy and torch's CPU ops release the GIL); each task also writes
    its image into the NCHW batch.  A sequential .rec is read through the
    C++ prefetch reader unless ``MXTPU_NATIVE_IO=0``.

    ``decode='raw'`` takes each payload as a raw uint8 HWC tensor of
    ``raw_shape`` (CHW, default ``data_shape``), as ``tools/im2rec.py
    --pack-raw`` writes, with no decoder; ``'auto'`` takes a payload of
    exactly that many bytes that starts with no image signature as raw;
    ``'jpeg'`` always decodes with cv2.  ``raw_shape`` is the port's
    addition: raw records larger than ``data_shape`` (256² for a 224² crop)
    feed the crop augmenters.

    ``dtype='uint8'`` keeps the batch in uint8 (labels stay float32) and
    refuses the augmenters whose float output would wrap in it.
    """

    def __init__(self, batch_size, data_shape, label_width=1, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 dtype="float32", preprocess_threads=1, decode="auto",
                 ctx=None, raw_shape=None, **kwargs):
        super().__init__()
        self._out_ctx = ctx if ctx is not None else current_context()
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.seq = None
        self.imgrec = None
        self.imglist = None
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(path_imgidx,
                                                         path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                assert not shuffle and num_parts <= 1, \
                    "path_imgidx is required when shuffle or num_parts > 1 " \
                    "is used with a .rec file (ref: image.py:1115)"
                self.imgrec = self._open_sequential(path_imgrec)
        if path_imglist:
            with open(path_imglist) as fin:
                imglist = {}
                imgkeys = []
                for line in fin:
                    line = line.strip().split("\t")
                    label = np.array(line[1:-1], dtype=np.float32)
                    key = int(line[0])
                    imglist[key] = (label, line[-1])
                    imgkeys.append(key)
                self.imglist = imglist
                self.seq = imgkeys
        elif isinstance(imglist, list):
            result = {}
            imgkeys = []
            index = 1
            for img in imglist:
                key = index
                index += 1
                if isinstance(img[0], (int, float)):
                    label = np.array([img[0]], np.float32)
                else:
                    label = np.array(img[0], np.float32)
                result[key] = (label, img[-1])
                imgkeys.append(key)
            self.imglist = result
            self.seq = imgkeys

        self.path_root = path_root
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.raw_shape = tuple(raw_shape or data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        if num_parts > 1 and self.seq is not None:
            assert part_index < num_parts
            N = len(self.seq)
            C = N // num_parts
            self.seq = self.seq[part_index * C:(part_index + 1) * C]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self.dtype = dtype
        if np.dtype(dtype) == np.uint8:
            bad = [a for a in _flatten_augs(self.auglist)
                   if isinstance(a, _UINT8_UNSAFE)]
            if bad:
                raise ValueError(
                    "dtype='uint8' cannot be combined with range-shifting "
                    "augmenters %r: their float output would wrap in the "
                    "uint8 batch buffer" % ([type(a).__name__ for a in bad]))
        self.preprocess_threads = max(int(preprocess_threads), 1)
        self._decode_mode = decode
        self._pool = None
        if self.preprocess_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(self.preprocess_threads,
                                            thread_name_prefix="imgdec")
        self._provide_data = [io_mod.DataDesc(data_name,
                                              (batch_size,) + data_shape, dtype)]
        self._provide_label = [io_mod.DataDesc(label_name,
                                               (batch_size, label_width)
                                               if label_width > 1
                                               else (batch_size,),
                                               "float32")]
        self.reset()

    def _open_sequential(self, path):
        """A sequential .rec reader: the C++ prefetch reader, or
        ``MXRecordIO`` under ``MXTPU_NATIVE_IO=0``."""
        if _config.get_bool("NATIVE_IO", True):
            return _NativeSeqReader(path)
        return recordio.MXRecordIO(path, "r")

    @property
    def provide_data(self):
        return self._provide_data

    @property
    def provide_label(self):
        return self._provide_label

    def reset(self):
        if self.shuffle and self.seq is not None:
            random.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def close(self):
        """Shut the decode pool and the record reader down."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self.imgrec is not None and hasattr(self.imgrec, "close"):
            self.imgrec.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass                # interpreter teardown

    def __exit__(self, et, ev, tb):
        self.close()
        return False

    def __enter__(self):
        return self

    def _decode_np(self, s):
        """Payload -> HWC uint8 numpy image, raw when configured."""
        c, h, w = self.raw_shape
        head = bytes(s[:4])
        looks_encoded = (head.startswith(b"\xff\xd8\xff")      # JPEG SOI
                         or head.startswith(b"\x89PNG")
                         or head.startswith(b"GIF8")
                         or head.startswith(b"BM"))
        if self._decode_mode == "raw" or (
                self._decode_mode == "auto" and len(s) == c * h * w
                and not looks_encoded):
            return np.frombuffer(s, np.uint8).reshape(h, w, c)
        cv2 = recordio.cv2_module("decoding an encoded image record")
        img = cv2.imdecode(np.frombuffer(bytes(s), np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise MXNetError("Decoding image failed")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def next_sample(self):
        """Return (label, payload) (ref: image.py next_sample)."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root, fname), "rb") as f:
                img = f.read()
            return label, img
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def _process_one(self, s):
        """Decode and augment one payload on ``cpu(0)``; with no augmenter
        the sample never leaves numpy."""
        img = self._decode_np(s)
        if not self.auglist:
            return img
        with cpu(0):
            # one copy: np.frombuffer's array is read-only
            data = NDArray(torch.from_numpy(np.array(img)), ctx=cpu(0))
            for aug in self.auglist:
                data = aug(data)
            return data.asnumpy()

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        # a uint8 batch keeps the host path cast-free (the reference's
        # ImageRecordUInt8Iter); the consumer casts on the device
        buf_dtype = (np.uint8 if np.dtype(self.dtype) == np.uint8
                     else np.float32)
        batch_data = np.zeros((batch_size, c, h, w), buf_dtype)
        batch_label = np.zeros((batch_size, self.label_width), np.float32)
        raws = []
        try:
            while len(raws) < batch_size:
                raws.append(self.next_sample())
        except StopIteration:
            if not raws:
                raise
        i = len(raws)

        def fill(j):
            label, s = raws[j]
            batch_data[j] = self._process_one(s).transpose(2, 0, 1)
            batch_label[j] = label

        if self._pool is not None:
            for _ in self._pool.map(fill, range(i)):
                pass
        else:
            for j in range(i):
                fill(j)
        data = torch.from_numpy(batch_data).to(torch_dtype(self.dtype))
        data = NDArray(data.to(self._out_ctx.torch_device()),
                       ctx=self._out_ctx)
        # labels stay float32 whatever the image dtype: a uint8 label would
        # wrap class ids >= 256
        label = torch.from_numpy(batch_label.reshape(-1)
                                 if self.label_width == 1 else batch_label)
        label = NDArray(label.to(self._out_ctx.torch_device()),
                        ctx=self._out_ctx)
        return io_mod.DataBatch([data], [label], batch_size - i)
