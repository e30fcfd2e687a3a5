"""The port's ``mx.image`` and ``ImageRecordIter`` against the JAX build's,
on the CPU.  The same numpy images and the same ``random``/``np.random``
seeds go to both packages:
- every augmenter and crop helper, and ``CreateAugmenter``'s list, bit-equal
  (the resizes go through OpenCV in both, so they are bit-equal too);
- ``ImageIter`` and ``ImageRecordIter`` batches over raw and PNG records,
  indexed and sequential, on the native and the Python reader, bit-equal;
- the detection augmenters, ``CreateDetAugmenter`` and ``ImageDetIter``;
- the contracts of ``tests/test_io_pipeline.py`` and the two
  ``ImageDetIter`` contracts of ``tests/test_detection.py``, on the port;
- the paths that need OpenCV raise ``MXNetError`` without it.
With more than one decode thread the order of random draws is not fixed in
either package, so pools are compared only where the augmenters draw
nothing.  The ``cuda`` test runs phase 12a's card contracts of
``chip_smoke.py`` at a small size."""
import random
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _seed(seed):
    random.seed(seed)
    np.random.seed(seed)


def _image(h=20, w=24, dtype=np.float32, seed=0):
    img = np.random.RandomState(seed).rand(h, w, 3) * 255
    return img.astype(dtype)


def _write_rec(tmp_path, n=12, h=8, w=8, raw=True, name=None, label=None):
    """Records of seeded images, raw (HWC uint8 bytes) or PNG, with an
    index; returns the prefix and the images."""
    rs = np.random.RandomState(7)
    prefix = str(tmp_path / (name or ("raw" if raw else "png")))
    rec = tmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    imgs = []
    for i in range(n):
        img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
        hdr = tmx.recordio.IRHeader(
            0, float(i % 3) if label is None else label(i), i, 0)
        if raw:
            s = tmx.recordio.pack(hdr, img.tobytes())
        else:
            cv2 = pytest.importorskip("cv2")
            ok, buf = cv2.imencode(".png", cv2.cvtColor(img,
                                                        cv2.COLOR_RGB2BGR))
            assert ok
            s = tmx.recordio.pack(hdr, buf.tobytes())
        rec.write_idx(i, s)
        imgs.append(img)
    rec.close()
    return prefix, np.stack(imgs)


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
        it.reset()
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we) > 0
        for (gd, gl, gp), (wd, wl, wp) in zip(ge, we):
            assert gp == wp and gd.dtype == wd.dtype
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)


def _both(make, seed=3):
    """``make(mod)`` run for each package after the same seeds."""
    out = []
    for mod in (jmx, tmx):
        _seed(seed)
        out.append(make(mod))
    return out


# --------------------------------------------------------------------------
# augmenters and crop helpers
# --------------------------------------------------------------------------

EIGVAL = np.array([55.46, 4.794, 1.148])
EIGVEC = np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                   [-0.5836, -0.6948, 0.4203]])
AUGMENTERS = {
    "RandomCropAug": lambda I: I.RandomCropAug((12, 10)),
    "CenterCropAug": lambda I: I.CenterCropAug((12, 10)),
    "BrightnessJitterAug": lambda I: I.BrightnessJitterAug(0.4),
    "ContrastJitterAug": lambda I: I.ContrastJitterAug(0.4),
    "SaturationJitterAug": lambda I: I.SaturationJitterAug(0.4),
    "HueJitterAug": lambda I: I.HueJitterAug(0.3),
    "ColorJitterAug": lambda I: I.ColorJitterAug(0.4, 0.4, 0.4),
    "LightingAug": lambda I: I.LightingAug(0.1, EIGVAL, EIGVEC),
    "ColorNormalizeAug": lambda I: I.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.395, 57.12, 57.375])),
    "ColorNormalizeAug_mean_only": lambda I: I.ColorNormalizeAug(
        np.array([1.0, 2.0, 3.0]), None),
    "RandomGrayAug": lambda I: I.RandomGrayAug(0.5),
    "HorizontalFlipAug": lambda I: I.HorizontalFlipAug(0.5),
    "CastAug": lambda I: I.CastAug("float16"),
    "RandomOrderAug": lambda I: I.RandomOrderAug(
        [I.HorizontalFlipAug(0.5), I.BrightnessJitterAug(0.2),
         I.CenterCropAug((9, 9))]),
}
CV2_AUGMENTERS = {
    "ResizeAug": lambda I: I.ResizeAug(14),
    "ForceResizeAug": lambda I: I.ForceResizeAug((15, 11)),
    "RandomSizedCropAug": lambda I: I.RandomSizedCropAug(
        (10, 10), (0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0)),
    "RandomCropAug_resized": lambda I: I.RandomCropAug((30, 28)),
}


def _run_aug(mod, factory, img, reps=6):
    aug = factory(mod.image)
    outs = []
    for _ in range(reps):
        outs.append(aug(mod.nd.array(img, dtype=img.dtype)).asnumpy())
    return outs, aug.dumps()


# the augmenters that see uint8 images (the photometric ones run after
# CastAug, on float32)
UINT8_AUGMENTERS = ("RandomCropAug", "CenterCropAug", "HorizontalFlipAug",
                    "CastAug", "RandomOrderAug", "ColorNormalizeAug")


@pytest.mark.parametrize("name,dtype", [
    (n, np.float32) for n in sorted(AUGMENTERS)] + [
    (n, np.uint8) for n in UINT8_AUGMENTERS])
def test_augmenters_match_jax(name, dtype):
    img = _image(dtype=dtype)
    (want, wdump), (got, gdump) = _both(
        lambda m: _run_aug(m, AUGMENTERS[name], img))
    assert gdump == wdump
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(CV2_AUGMENTERS))
def test_opencv_augmenters_match_jax(name):
    pytest.importorskip("cv2")
    img = _image(dtype=np.uint8)
    (want, _), (got, _) = _both(
        lambda m: _run_aug(m, CV2_AUGMENTERS[name], img))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_crop_helpers_match_jax():
    img = _image(dtype=np.uint8)

    def run(mod):
        I, x = mod.image, mod.nd.array(img, dtype=np.uint8)
        out = [I.fixed_crop(x, 3, 2, 9, 7).asnumpy(),
               I.center_crop(x, (10, 12))[0].asnumpy(),
               I.center_crop(x, (10, 12))[1]]
        for _ in range(4):
            crop, box = I.random_crop(x, (11, 9))
            out += [crop.asnumpy(), box]
        out.append(I.scale_down((24, 20), (30, 25)))
        out.append(I.color_normalize(x.astype("float32"), 3.0, 2.0).asnumpy())
        return out
    want, got = _both(run)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_opencv_helpers_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = _image(dtype=np.uint8)
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    with open(path, "rb") as f:
        buf = f.read()

    def run(mod):
        I, x = mod.image, mod.nd.array(img, dtype=np.uint8)
        out = [I.imresize(x, 13, 9).asnumpy(), I.resize_short(x, 11).asnumpy(),
               I.imdecode(buf).asnumpy(), I.imdecode(buf, flag=0).asnumpy(),
               I.imdecode(buf, to_rgb=False).asnumpy(),
               I.imread(path).asnumpy()]
        for _ in range(4):
            crop, box = I.random_size_crop(x, (8, 8), 0.3, (0.75, 1.33))
            out += [crop.asnumpy(), box]
        return out
    want, got = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(MXNetError, match="Decoding image failed"):
        tmx.image.imdecode(b"not an image at all")


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(resize=10, rand_crop=True, rand_mirror=True),
    dict(rand_crop=True, rand_resize=True, mean=True, std=True),
    dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1,
         pca_noise=0.1, rand_gray=0.2, mean=np.array([1.0, 2.0, 3.0]),
         inter_method=1),
    dict(mean=np.zeros(3))])
def test_create_augmenter_list_matches_jax(kwargs):
    want = [a.dumps() for a in jmx.image.CreateAugmenter((3, 8, 8), **kwargs)]
    got = [a.dumps() for a in tmx.image.CreateAugmenter((3, 8, 8), **kwargs)]
    assert got == want


def test_opencv_paths_raise_without_cv2(tmp_path, monkeypatch):
    prefix, _ = _write_rec(tmp_path, n=2, raw=False)
    monkeypatch.setitem(sys.modules, "cv2", None)
    x = tmx.nd.array(_image(dtype=np.uint8), dtype=np.uint8)
    for call in (lambda: tmx.image.imdecode(b"\x89PNG...."),
                 lambda: tmx.image.imresize(x, 4, 4),
                 lambda: tmx.image.ResizeAug(8)(x),
                 lambda: tmx.image.RandomSizedCropAug(
                     (4, 4), 0.5, (0.75, 1.33))(x)):
        with pytest.raises(MXNetError, match="OpenCV"):
            call()
    it = tmx.image.ImageIter(batch_size=2, data_shape=(3, 8, 8),
                             path_imgrec=prefix + ".rec",
                             path_imgidx=prefix + ".idx", aug_list=[])
    with pytest.raises(MXNetError, match="OpenCV"):
        it.next()


# --------------------------------------------------------------------------
# ImageIter and ImageRecordIter
# --------------------------------------------------------------------------

AUG = dict(rand_crop=True, rand_mirror=True, brightness=0.4, contrast=0.4,
           saturation=0.4, pca_noise=0.1, mean=True, std=True)


@pytest.mark.parametrize("kind", ["plain", "augmented", "uint8",
                                  "label_width", "reference_names"])
def test_image_record_iter_batches_match_jax(tmp_path, kind):
    """Raw records, shuffled by key, two epochs."""
    label = (lambda i: [float(i), i / 2.0]) if kind == "label_width" else None
    prefix, _ = _write_rec(tmp_path, n=10, label=label)
    kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              data_shape=(3, 8, 8), batch_size=4, shuffle=True,
              preprocess_threads=1, prefetch_buffer=2)
    if kind == "augmented":
        kw.update(AUG)
    elif kind == "uint8":
        kw.update(dtype="uint8", aug_list=[], rand_mirror=True)
    elif kind == "label_width":
        kw.update(label_width=2, rand_mirror=True)
    elif kind == "reference_names":
        kw.update(mean_r=123.0, mean_g=117.0, mean_b=104.0, std_r=58.0,
                  std_b=57.0, rand_mirror_prob=0.5, rand_crop=True)
    want, got = _both(lambda m: _epochs(m.io.ImageRecordIter(**kw)))
    _same_batches(got, want)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("threads", [1, 3])
def test_sequential_rec_matches_jax(tmp_path, monkeypatch, native, threads):
    """A .rec without an index reads in file order on the native prefetch
    reader and the Python one; a pool gives the same batches."""
    prefix, imgs = _write_rec(tmp_path, n=7)
    monkeypatch.setenv("MXTPU_NATIVE_IO", "1" if native else "0")
    want, got = _both(lambda m: _epochs(m.image.ImageIter(
        batch_size=3, data_shape=(3, 8, 8), path_imgrec=prefix + ".rec",
        preprocess_threads=threads)))
    _same_batches(got, want)
    it = tmx.image.ImageIter(batch_size=3, data_shape=(3, 8, 8),
                             path_imgrec=prefix + ".rec")
    assert isinstance(it.imgrec, tmx.image.image._NativeSeqReader) is native
    assert got[0][-1][2] == 2
    np.testing.assert_array_equal(
        np.concatenate([b[0] for b in got[0]])[:7],
        imgs.transpose(0, 3, 1, 2).astype(np.float32))


def test_png_records_match_jax(tmp_path):
    """PNG records decoded by OpenCV, cropped 10x12 -> 8x8 and flipped."""
    pytest.importorskip("cv2")
    prefix, _ = _write_rec(tmp_path, n=9, h=10, w=12, raw=False)
    kw = dict(batch_size=4, data_shape=(3, 8, 8), path_imgrec=prefix + ".rec",
              path_imgidx=prefix + ".idx", shuffle=True, rand_crop=True,
              rand_mirror=True, mean=True)
    want, got = _both(lambda m: _epochs(m.image.ImageIter(**kw)))
    _same_batches(got, want)


def test_raw_shape_crops_larger_raw_records(tmp_path):
    """``raw_shape``: raw 10x12 records cropped to 8x8 give the batches the
    JAX build gives from the same images stored as PNG."""
    pytest.importorskip("cv2")
    raw, imgs = _write_rec(tmp_path, n=9, h=10, w=12, raw=True)
    png, imgs2 = _write_rec(tmp_path, n=9, h=10, w=12, raw=False)
    np.testing.assert_array_equal(imgs, imgs2)
    kw = dict(batch_size=4, data_shape=(3, 8, 8), shuffle=True,
              rand_crop=True, rand_mirror=True)
    _seed(5)
    want = _epochs(jmx.image.ImageIter(path_imgrec=png + ".rec",
                                       path_imgidx=png + ".idx", **kw))
    _seed(5)
    got = _epochs(tmx.io.ImageRecordIter(
        path_imgrec=raw + ".rec", path_imgidx=raw + ".idx", decode="raw",
        raw_shape=(3, 10, 12), preprocess_threads=1, prefetch_buffer=0,
        **kw))
    _same_batches(got, want)


def test_imglist_and_lst_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rs = np.random.RandomState(2)
    lines, imglist = [], []
    for i in range(5):
        img = (rs.rand(8, 8, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(tmp_path / ("%d.png" % i)), img)
        lines.append("%d\t%f\t%f\t%d.png" % (i, i % 2, i / 4.0, i))
        imglist.append(([float(i % 2), i / 4.0], "%d.png" % i))
    (tmp_path / "x.lst").write_text("\n".join(lines) + "\n")
    for kw in (dict(path_imglist=str(tmp_path / "x.lst")),
               dict(imglist=imglist)):
        want, got = _both(lambda m: _epochs(m.image.ImageIter(
            batch_size=2, data_shape=(3, 8, 8), label_width=2,
            path_root=str(tmp_path), shuffle=True, rand_mirror=True, **kw)))
        _same_batches(got, want)


def test_batches_land_on_the_iterators_context(tmp_path):
    prefix, _ = _write_rec(tmp_path, n=4)
    kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              data_shape=(3, 8, 8), batch_size=2, aug_list=[])
    b = tmx.io.ImageRecordIter(**kw).next()
    assert b.data[0].context == b.label[0].context == tmx.cpu()
    with tmx.gpu(0):
        it = tmx.io.ImageRecordIter(ctx=tmx.cpu(0), **kw)
        assert it.next().data[0].context == tmx.cpu()
        it = tmx.io.ImageRecordIter(prefetch_buffer=0, **kw)
    with pytest.raises(MXNetError, match="CUDA"):
        it.next()


# the contracts of tests/test_io_pipeline.py, on the port

def test_image_record_iter_honors_knobs(tmp_path):
    pytest.importorskip("cv2")
    prefix, _ = _write_rec(tmp_path, n=12, raw=False)
    kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              data_shape=(3, 8, 8), batch_size=4, label_width=1)
    it_plain = tmx.io.ImageRecordIter(preprocess_threads=1, prefetch_buffer=0,
                                      **kw)
    it_fast = tmx.io.ImageRecordIter(preprocess_threads=3, prefetch_buffer=3,
                                     **kw)
    assert isinstance(it_fast, tmx.io.PrefetchingIter)
    assert not isinstance(it_plain, tmx.io.PrefetchingIter)
    assert it_fast.iters[0]._pool is not None and it_plain._pool is None
    for _ in range(2):
        got_plain = [b.data[0].asnumpy() for b in it_plain]
        got_fast = [b.data[0].asnumpy() for b in it_fast]
        assert len(got_plain) == len(got_fast) == 3
        for a, b in zip(got_plain, got_fast):
            np.testing.assert_array_equal(a, b)
        it_plain.reset()
        it_fast.reset()


def test_raw_record_decode(tmp_path):
    prefix, imgs = _write_rec(tmp_path, n=8)
    it = tmx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                path_imgidx=prefix + ".idx",
                                data_shape=(3, 8, 8), batch_size=8,
                                preprocess_threads=2, prefetch_buffer=2)
    batch = it.next()
    np.testing.assert_array_equal(
        batch.data[0].asnumpy(), imgs.transpose(0, 3, 1, 2).astype(np.float32))
    np.testing.assert_array_equal(batch.label[0].asnumpy(), np.arange(8) % 3)


def test_prefetching_iter_depth_and_reset():
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    label = np.arange(20, dtype=np.float32)
    base = tmx.io.NDArrayIter(data.copy(), label.copy(), batch_size=5)
    pf = tmx.io.PrefetchingIter(
        tmx.io.NDArrayIter(data.copy(), label.copy(), batch_size=5),
        prefetch_buffer=3)
    for _ in range(3):
        want = [b.data[0].asnumpy() for b in base]
        got = [b.data[0].asnumpy() for b in pf]
        assert len(want) == len(got) == 4
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
        base.reset()
        pf.reset()


def test_sequential_rec_reset_reopens(tmp_path):
    prefix, imgs = _write_rec(tmp_path, n=6)
    it = tmx.image.ImageIter(batch_size=3, data_shape=(3, 8, 8),
                             path_imgrec=prefix + ".rec")
    seen = [b.data[0].asnumpy() for b in it]
    assert len(seen) == 2
    np.testing.assert_array_equal(
        np.concatenate(seen), imgs.transpose(0, 3, 1, 2).astype(np.float32))
    it.reset()
    again = [b.data[0].asnumpy() for b in it]
    np.testing.assert_array_equal(np.concatenate(again), np.concatenate(seen))
    it.close()


def test_prefetching_iter_repolls_after_exhaustion():
    data = np.arange(8, dtype=np.float32).reshape(4, 2)
    pf = tmx.io.PrefetchingIter(
        tmx.io.NDArrayIter(data, np.zeros(4), batch_size=2), prefetch_buffer=2)
    assert pf.iter_next() and pf.iter_next()
    for _ in range(3):
        assert not pf.iter_next()
    pf.reset()
    assert pf.iter_next()


def test_uint8_pipeline_keeps_float_labels(tmp_path):
    prefix, _ = _write_rec(tmp_path, n=4, name="biglabel",
                           label=lambda i: float(700 + i))
    it = tmx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                                path_imgidx=prefix + ".idx",
                                data_shape=(3, 8, 8), batch_size=4,
                                dtype="uint8", aug_list=[],
                                preprocess_threads=1, prefetch_buffer=0)
    b = it.next()
    assert b.data[0].dtype == np.uint8 and b.label[0].dtype == np.float32
    np.testing.assert_array_equal(b.label[0].asnumpy(),
                                  [700.0, 701.0, 702.0, 703.0])


def test_prefetch_propagates_producer_errors():
    class Boom(tmx.io.DataIter):
        def __init__(self):
            super().__init__(2)
            self.n = 0

        @property
        def provide_data(self):
            return [tmx.io.DataDesc("data", (2, 2), "float32")]

        @property
        def provide_label(self):
            return [tmx.io.DataDesc("l", (2,), "float32")]

        def reset(self):
            self.n = 0

        def next(self):
            self.n += 1
            if self.n == 2:
                raise ValueError("corrupt record")
            # built on the prefetch thread: the context is given
            cpu = tmx.cpu()
            return tmx.io.DataBatch([tmx.nd.zeros((2, 2), ctx=cpu)],
                                    [tmx.nd.zeros(2, ctx=cpu)], 0)
    pf = tmx.io.PrefetchingIter(Boom(), prefetch_buffer=2)
    assert pf.iter_next()
    with pytest.raises(ValueError, match="corrupt record"):
        pf.iter_next()
    pf.close()


@pytest.mark.parametrize("aug", [dict(mean_r=123.0), dict(brightness=0.2),
                                 dict(pca_noise=0.1)])
def test_uint8_with_augmenters_rejected(tmp_path, aug):
    prefix, _ = _write_rec(tmp_path, n=4)
    with pytest.raises(ValueError, match="uint8"):
        tmx.io.ImageRecordIter(path_imgrec=prefix + ".rec",
                               path_imgidx=prefix + ".idx",
                               data_shape=(3, 8, 8), batch_size=4,
                               dtype="uint8", preprocess_threads=1,
                               prefetch_buffer=0, **aug)
    # a normalizer wrapped in a composite is found too
    with pytest.raises(ValueError, match="uint8"):
        tmx.image.ImageIter(batch_size=2, data_shape=(3, 8, 8),
                            path_imgrec=prefix + ".rec",
                            path_imgidx=prefix + ".idx", dtype="uint8",
                            aug_list=[tmx.image.RandomOrderAug(
                                [tmx.image.ColorNormalizeAug(1.0, None)])])


def test_multipart_record_through_image_iter(tmp_path, monkeypatch):
    """A record split into parts (the Python writer's small limit) reads
    back whole through ImageIter's sequential path."""
    monkeypatch.setattr(tmx.recordio, "_MAX_REC_LEN", 64)
    monkeypatch.setenv("MXTPU_NATIVE_IO", "0")
    prefix, imgs = _write_rec(tmp_path, n=3)
    monkeypatch.setenv("MXTPU_NATIVE_IO", "1")
    it = tmx.image.ImageIter(batch_size=3, data_shape=(3, 8, 8),
                             path_imgrec=prefix + ".rec")
    np.testing.assert_array_equal(
        it.next().data[0].asnumpy(),
        imgs.transpose(0, 3, 1, 2).astype(np.float32))


# --------------------------------------------------------------------------
# detection
# --------------------------------------------------------------------------

def _make_det_samples(tmp_path, n=6, size=32, boxes=1):
    pytest.importorskip("cv2")
    prefix = str(tmp_path / "det")
    rec = tmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
        objs = [[float((i + k) % 3), 0.1 + 0.05 * k, 0.2, 0.6, 0.7 - 0.1 * k]
                for k in range(1 + (i % boxes))]
        label = np.concatenate([[2, 5], np.ravel(objs)]).astype(np.float32)
        rec.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, label, i, 0), img, quality=90,
            img_fmt=".png"))
    rec.close()
    return prefix


def test_image_det_iter(tmp_path):
    prefix = _make_det_samples(tmp_path)
    it = tmx.image.ImageDetIter(batch_size=3, data_shape=(3, 16, 16),
                                path_imgrec=prefix + ".rec",
                                path_imgidx=prefix + ".idx")
    assert it.provide_label[0][1] == (3, 1, 5)
    batch = it.next()
    assert batch.data[0].shape == (3, 3, 16, 16)
    lab = batch.label[0].asnumpy()
    assert lab.shape == (3, 1, 5)
    assert (lab[:, 0, 0] >= 0).all()
    assert (lab[:, 0, 3] > lab[:, 0, 1]).all()


def test_det_augmenters_preserve_box_validity(tmp_path):
    prefix = _make_det_samples(tmp_path)
    it = tmx.image.ImageDetIter(batch_size=2, data_shape=(3, 24, 24),
                                path_imgrec=prefix + ".rec",
                                path_imgidx=prefix + ".idx",
                                rand_crop=0.8, rand_pad=0.8,
                                rand_mirror=True, min_object_covered=0.5)
    for _ in range(3):
        it.reset()
        lab = it.next().label[0].asnumpy()
        valid = lab[lab[:, :, 0] >= 0]
        assert valid.size > 0
        assert (valid[:, 1:5] >= -1e-6).all() and \
            (valid[:, 1:5] <= 1 + 1e-6).all()
        assert (valid[:, 3] > valid[:, 1]).all()


def test_image_det_iter_matches_jax(tmp_path):
    prefix = _make_det_samples(tmp_path, n=7, boxes=3)
    kw = dict(batch_size=3, data_shape=(3, 20, 20),
              path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              shuffle=True, rand_crop=0.7, rand_pad=0.7, rand_mirror=True,
              brightness=0.3, pca_noise=0.1, mean=True, std=True)

    def run(mod):
        it = mod.image.ImageDetIter(**kw)
        return it.provide_label[0][1], _epochs(it)
    (wshape, want), (gshape, got) = _both(run)
    assert gshape == wshape == (3, 3, 5)
    _same_batches(got, want)


@pytest.mark.parametrize("name", ["crop", "pad", "flip", "select", "borrow"])
def test_det_augmenters_match_jax(name):
    img = _image(dtype=np.float32, h=30, w=26)
    label = np.array([[0, 0.1, 0.2, 0.6, 0.7], [1, 0.3, 0.1, 0.9, 0.5],
                      [2, 0.0, 0.0, 0.2, 0.3]], np.float32)

    def make(I):
        return {"crop": lambda: I.DetRandomCropAug(0.3),
                "pad": lambda: I.DetRandomPadAug(),
                "flip": lambda: I.DetHorizontalFlipAug(0.5),
                "select": lambda: I.DetRandomSelectAug(
                    [I.DetHorizontalFlipAug(1.0), I.DetRandomCropAug()], 0.3),
                "borrow": lambda: I.DetBorrowAug(I.BrightnessJitterAug(0.5)),
                }[name]()

    def run(mod):
        aug = make(mod.image)
        out = []
        for _ in range(6):
            src, lab = aug(mod.nd.array(img), label)
            out += [src.asnumpy() if hasattr(src, "asnumpy")
                    else np.asarray(src), lab]
        return out, aug.dumps()
    (want, wdump), (got, gdump) = _both(run)
    assert gdump == wdump
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_create_det_augmenter_list_matches_jax():
    kw = dict(resize=30, rand_crop=0.5, rand_pad=0.5, rand_gray=0.1,
              rand_mirror=True, mean=True, std=True, brightness=0.2,
              contrast=0.2, saturation=0.2, pca_noise=0.1, hue=0.1)
    want = [a.dumps() for a in jmx.image.CreateDetAugmenter((3, 16, 16), **kw)]
    got = [a.dumps() for a in tmx.image.CreateDetAugmenter((3, 16, 16), **kw)]
    assert got == want


# --------------------------------------------------------------------------
# on the card (skipped here): phase 12a of chip_smoke.py at a small size
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_data_plane_contracts(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    with tmx.gpu(0):
        chip_smoke.data_card_contracts(tmx, chip_smoke.card_line(),
                                       str(tmp_path), n=24, batch=8)
