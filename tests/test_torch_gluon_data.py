"""The port's ``gluon.data`` against the JAX build's, on the CPU: datasets,
samplers and ``DataLoader`` batches (0 and 2 workers, each ``last_batch``
policy, shuffled from the same ``np.random`` seed) bit-equal; the vision
transforms (bit-equal, except ``Resize`` and ``RandomResizedCrop``: torch's
``interpolate`` against ``jax.image.resize``, within the f32 bounds stated
below, and after the cast back to uint8 at most 1 apart); MNIST,
FashionMNIST, CIFAR-10 and CIFAR-100 read from files written here in their
published formats; a ``DataLoader`` with two workers feeding steps inside
``mx.engine.bulk``; and the card's contracts of phase 12d."""
import gzip
import os
import random
import struct
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


def _both(make, seed=11):
    out = []
    for mod in (jmx, tmx):
        random.seed(seed)
        np.random.seed(seed)
        out.append(make(mod))
    return out


def _host(value):
    if isinstance(value, (list, tuple)):
        return [_host(v) for v in value]
    return value.asnumpy() if hasattr(value, "asnumpy") else np.asarray(value)


def _same(got, want):
    assert type(got) is type(want) or isinstance(got, (list, tuple))
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = _host(got), _host(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _data(n=10, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((n, 3)).astype(np.float32),
            np.arange(n).astype(np.float32),
            rs.randint(0, 50, (n, 4)))


# --------------------------------------------------------------------------
# datasets and samplers
# --------------------------------------------------------------------------

def test_datasets_match_jax():
    x, y, ids = _data()

    def run(mod):
        D = mod.gluon.data
        arr = D.ArrayDataset(x, y, ids)
        nd1 = D.ArrayDataset(mod.nd.array(y))
        simple = D.SimpleDataset(list(range(5)))
        lazy = arr.transform(lambda a, b, c: (a * 2, b + 1, c))
        eager = arr.transform_first(lambda a: a - 1, lazy=False)
        return [len(arr), arr[3], nd1[4], type(nd1._data[0]).__name__,
                len(simple), simple[2], lazy[5], eager[6], len(eager),
                D.ArrayDataset(x)[1]]
    want, got = _both(run)
    assert got[0] == want[0] and got[4:6] == want[4:6] == [5, 2]
    assert got[3] == want[3] == "ndarray"
    for i in (1, 2, 6, 7, 9):
        _same(list(got[i]) if isinstance(got[i], tuple) else got[i],
              list(want[i]) if isinstance(want[i], tuple) else want[i])
    assert got[8] == want[8] == 10
    with pytest.raises(AssertionError, match="same length"):
        tmx.gluon.data.ArrayDataset(x, y[:3])


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("batch_size", [3, 4, 5])
def test_samplers_match_jax(last_batch, batch_size):
    def run(mod):
        D = mod.gluon.data
        seq = list(D.SequentialSampler(7))
        rnd = [list(D.RandomSampler(9)) for _ in range(2)]
        bs = D.BatchSampler(D.RandomSampler(11), batch_size, last_batch)
        epochs = [(len(bs), list(bs)) for _ in range(3)]
        return seq, rnd, epochs
    want, got = _both(run)
    assert got == want
    with pytest.raises(ValueError, match="last_batch"):
        list(tmx.gluon.data.BatchSampler(range(5), 2, "pad"))


# --------------------------------------------------------------------------
# DataLoader
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("prefetch", [True, False])
def test_dataloader_matches_jax(num_workers, last_batch, prefetch):
    x, y, ids = _data(11)

    def run(mod):
        loader = mod.gluon.data.DataLoader(
            mod.gluon.data.ArrayDataset(x, y, ids), batch_size=4,
            shuffle=True, last_batch=last_batch, num_workers=num_workers,
            prefetch_device=prefetch)
        return [len(loader)] + [[_host(b) for b in loader] for _ in range(2)]
    want, got = _both(run)
    assert got[0] == want[0]
    for ge, we in zip(got[1:], want[1:]):
        assert len(ge) == len(we) > 0
        for gb, wb in zip(ge, we):
            _same(gb, wb)
            assert gb[2].dtype == np.int32       # int64 ids narrow


def test_dataloader_ndarray_samples_and_batchify():
    x, _, _ = _data(6)

    def run(mod):
        ds = mod.gluon.data.SimpleDataset([mod.nd.array(r) for r in x])
        out = [_host(b) for b in mod.gluon.data.DataLoader(ds, batch_size=4)]
        fn = [_host(b) for b in mod.gluon.data.DataLoader(
            ds, batch_size=3, batchify_fn=lambda s: s[0] + s[1])]
        return out + fn
    want, got = _both(run)
    _same(got, want)


def test_dataloader_arguments_and_knobs(monkeypatch):
    D = tmx.gluon.data
    ds = D.ArrayDataset(np.arange(10, dtype=np.float32))
    with pytest.raises(ValueError, match="batch_size"):
        D.DataLoader(ds)
    with pytest.raises(ValueError, match="shuffle"):
        D.DataLoader(ds, 2, shuffle=True, sampler=D.SequentialSampler(10))
    with pytest.raises(ValueError, match="batch_sampler"):
        D.DataLoader(ds, 2, batch_sampler=D.BatchSampler(
            D.SequentialSampler(10), 2))
    monkeypatch.delenv("GRAFT_PREFETCH_DEPTH", raising=False)
    loader = D.DataLoader(ds, batch_size=3, prefetch_device=False)
    assert loader.prefetch_depth() == 2 == \
        D.dataloader.prefetch_depth_default() == \
        jmx.gluon.data.dataloader.prefetch_depth_default()
    loader.set_prefetch_depth(0)
    assert loader.prefetch_depth() == 1
    loader.set_prefetch_depth(6)
    assert loader.prefetch_depth() == 6
    # growing the workers mid-epoch deepens the open epoch's lookahead;
    # the pool takes the new thread count at the next epoch
    loader = D.DataLoader(ds, batch_size=2)
    it = iter(loader)
    first = next(it)
    old = loader._pool
    assert old._max_workers == 1
    loader.set_num_workers(3)
    rest = list(it)
    np.testing.assert_array_equal(
        np.concatenate([first.asnumpy()] + [b.asnumpy() for b in rest]),
        np.arange(10, dtype=np.float32))
    assert loader._pool is old
    assert len(list(loader)) == 5
    assert loader._pool is not old and loader._pool._max_workers == 3
    loader.close()
    loader.close()
    assert loader._pool is None and len(list(loader)) == 5


def test_dataloader_numpy_batches_land_on_the_current_context():
    ds = tmx.gluon.data.ArrayDataset(np.ones((4, 2), np.float32))
    for workers in (0, 2):
        loader = tmx.gluon.data.DataLoader(ds, batch_size=2,
                                           num_workers=workers)
        assert all(b.context == tmx.cpu() for b in loader)
        with tmx.gpu(0):
            with pytest.raises(MXNetError, match="CUDA"):
                list(loader)


def test_dataset_dataloader():
    """tests/test_gluon.py:264-284 on the port."""
    X = np.random.randn(10, 3).astype(np.float32)
    Y = np.arange(10).astype(np.float32)
    dataset = tmx.gluon.data.ArrayDataset(X, Y)
    loader = tmx.gluon.data.DataLoader(dataset, batch_size=4, shuffle=False)
    batches = list(loader)
    assert len(batches) == 3
    xb, yb = batches[0]
    assert xb.shape == (4, 3)
    np.testing.assert_allclose(yb.asnumpy(), [0, 1, 2, 3])
    loader2 = tmx.gluon.data.DataLoader(dataset, batch_size=4, num_workers=2)
    assert len(list(loader2)) == 3
    ds = tmx.gluon.data.ArrayDataset(np.ones((4, 2), np.float32),
                                     np.zeros(4, np.float32))
    x, y = ds.transform_first(lambda v: v * 3)[0]
    np.testing.assert_allclose(np.asarray(x), [3, 3])


def test_record_file_datasets_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    prefix = str(tmp_path / "r")
    rec = tmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    rs = np.random.RandomState(3)
    for i in range(5):
        img = (rs.rand(6, 7, 3) * 255).astype(np.uint8)
        rec.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i), i, 0), img, quality=3,
            img_fmt=".png"))
        folder = tmp_path / "folder" / ("c%d" % (i % 2))
        folder.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(folder / ("%d.png" % i)), img)
    rec.close()
    (tmp_path / "folder" / "c0" / "notes.txt").write_text("skipped")

    def run(mod):
        V = mod.gluon.data.vision
        raw = mod.gluon.data.RecordFileDataset(prefix + ".rec")
        imgs = V.ImageRecordDataset(prefix + ".rec")
        gray = V.ImageRecordDataset(prefix + ".rec", flag=0,
                                    transform=lambda d, l: (d, l + 1))
        folder = V.ImageFolderDataset(str(tmp_path / "folder"))
        return ([len(raw), raw[2]] + [_host(list(imgs[i])) for i in range(5)]
                + [_host(list(gray[1])), folder.synsets, len(folder),
                   _host(list(folder[3]))])
    want, got = _both(run)
    assert got[:2] == want[:2] and got[-3:-1] == want[-3:-1]
    for g, w in zip(got[2:8] + got[-1:], want[2:8] + want[-1:]):
        _same(g, w)


@pytest.mark.parametrize("native", [True, False])
def test_record_reads_under_many_loader_threads(tmp_path, monkeypatch,
                                                native):
    """16 loader threads share one indexed reader (its seek and read under
    a lock) with a short switch interval: every record read is the one its
    key names."""
    monkeypatch.setenv("MXTPU_NATIVE_IO", "1" if native else "0")
    prefix = str(tmp_path / "s")
    rec = tmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    want = [("%d:" % i).encode() * (1 + i % 7) for i in range(400)]
    for i, body in enumerate(want):
        rec.write_idx(i, body)
    rec.close()
    ds = tmx.gluon.data.RecordFileDataset(prefix + ".rec")
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = tmx.gluon.data.DataLoader(ds, batch_size=3, shuffle=True,
                                           num_workers=16,
                                           batchify_fn=list)
        got = [r for batch in loader for r in batch]
        loader.close()
    finally:
        sys.setswitchinterval(before)
    assert sorted(got) == sorted(want) and len(got) == 400


# --------------------------------------------------------------------------
# vision transforms
# --------------------------------------------------------------------------
# ToTensor divides by 255, and the JAX build's XLA computes that as a
# product with 1/255: the two are one ulp apart where that rounds otherwise

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.mark.parametrize("name", ["ToTensor", "Normalize", "Cast",
                                  "CenterCrop", "CenterCrop_larger",
                                  "RandomFlipLeftRight", "RandomFlipTopBottom",
                                  "Compose"])
def test_exact_transforms_match_jax(name):
    img = (np.random.RandomState(1).rand(21, 17, 3) * 255).astype(np.uint8)
    chw = np.random.RandomState(2).rand(3, 9, 8).astype(np.float32)

    def run(mod):
        T = mod.gluon.data.vision.transforms
        x = mod.nd.array(img, dtype=np.uint8)
        t, arg = {
            "ToTensor": (T.ToTensor(), x),
            "Normalize": (T.Normalize(MEAN, STD), mod.nd.array(chw)),
            "Cast": (T.Cast("float16"), x),
            "CenterCrop": (T.CenterCrop((10, 12)), x),
            "CenterCrop_larger": (T.CenterCrop(30), x),
            "RandomFlipLeftRight": (T.RandomFlipLeftRight(), x),
            "RandomFlipTopBottom": (T.RandomFlipTopBottom(), x),
            "Compose": (T.Compose([T.RandomFlipLeftRight(), T.ToTensor(),
                                   lambda v: v * 2,
                                   T.Normalize(MEAN, STD)]), x),
        }[name]
        return [t(arg).asnumpy() for _ in range(5)]
    want, got = _both(run)
    if name in ("ToTensor", "Compose"):
        # the JAX build's XLA computes x / 255 as x * (1 / 255): one ulp of
        # a value below 1 (2^-24); through Compose's x2 (2^-23), the
        # subtraction (its result rounds to either side: 2^-23 more) and
        # the division by std >= 0.224, plus an ulp of a result below 8
        # (2^-21): 2^-22 / 0.224 + 2^-21 < 1.6e-6
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if name == "ToTensor":
                np.testing.assert_array_max_ulp(g, w, maxulp=1)
            else:
                assert np.abs(g - w).max() <= 1.6e-6
    else:
        _same(got, want)


# (from, to) and the bound on the f32 difference from jax.image.resize for
# images in [0, 255), in ulps at 255 (2^-16): the largest over 8 seeds on
# this CPU plus one.  The antialiased triangle filter and jax's
# scale_and_translate add the same taps in another order, so the gap grows
# with the taps a sample sums: 27 ulps at a 4.7x shrink, 2 when growing
ULP_255 = 2.0 ** -16
RESIZE_CASES = [((256, 256), (224, 224), 6 * ULP_255),
                ((300, 200), (64, 96), 28 * ULP_255),
                ((37, 53), (224, 224), 3 * ULP_255),
                ((64, 300), (128, 96), 5 * ULP_255)]


@pytest.mark.parametrize("src,dst,bound", RESIZE_CASES)
def test_resize_matches_jax(src, dst, bound):
    rs = np.random.RandomState(4)
    img = rs.rand(*src, 3) * 255

    def run(mod, dtype):
        T = mod.gluon.data.vision.transforms
        x = mod.nd.array(img.astype(dtype), dtype=dtype)
        return T.Resize((dst[1], dst[0]))(x).asnumpy()
    f32 = _both(lambda m: run(m, np.float32))
    err = np.abs(f32[1] - f32[0]).max()
    assert f32[1].shape == dst + (3,) and err <= bound, err
    u8 = _both(lambda m: run(m, np.uint8))
    diff = np.abs(u8[1].astype(int) - u8[0].astype(int))
    # a value within f32 rounding of an integer truncates to either side:
    # at most 1 apart, at most 1e-3 of the values (4.9e-4 over 8 seeds)
    assert u8[1].dtype == np.uint8 and diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("src,dst,bound", RESIZE_CASES)
def test_random_resized_crop_matches_jax(src, dst, bound):
    img = np.random.RandomState(5).rand(*src, 3).astype(np.float32) * 255

    def run(mod):
        T = mod.gluon.data.vision.transforms
        t = T.RandomResizedCrop((dst[1], dst[0]))
        x = mod.nd.array(img)
        return [t(x).asnumpy() for _ in range(4)]
    want, got = _both(run)
    for g, w in zip(got, want):
        assert g.shape == w.shape       # (64, 96) falls back to the crop
        assert np.abs(g - w).max() <= bound


def test_random_resized_crop_falls_back_to_center_crop():
    img = np.arange(4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)

    def run(mod):
        T = mod.gluon.data.vision.transforms
        t = T.RandomResizedCrop(3, scale=(5.0, 6.0))    # never fits
        return t(mod.nd.array(img)).asnumpy()
    want, got = _both(run)
    _same(got, want)


def test_transform_pipeline_through_dataloader_matches_jax():
    """12d's pipeline at a small size: transform_first(Compose([...]))
    through a DataLoader with num_workers=0, batches within the resize
    bound of the JAX build's."""
    imgs = (np.random.RandomState(6).rand(6, 40, 36, 3) * 255).astype(
        np.float32)

    def run(mod):
        T = mod.gluon.data.vision.transforms
        ds = mod.gluon.data.ArrayDataset(mod.nd.array(imgs),
                                         np.arange(6).astype(np.float32))
        ds = ds.transform_first(T.Compose([
            T.RandomResizedCrop(24), T.RandomFlipLeftRight(), T.ToTensor(),
            T.Normalize(MEAN, STD)]))
        return [_host(b) for b in mod.gluon.data.DataLoader(
            ds, batch_size=4, shuffle=True)]
    want, got = _both(run)
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        assert gx.shape == wx.shape and np.abs(gx - wx).max() <= 1e-5


# --------------------------------------------------------------------------
# MNIST, FashionMNIST, CIFAR-10 and CIFAR-100 from files in their formats
# --------------------------------------------------------------------------

def _write_mnist(root, n, gz, seed):
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    opener = gzip.open if gz else open
    for split, count in (("train", n), ("t10k", n - 2)):
        imgs = rs.randint(0, 256, (count, 28, 28)).astype(np.uint8)
        labels = rs.randint(0, 10, count).astype(np.uint8)
        ext = ".gz" if gz else ""
        with opener(os.path.join(root, "%s-images-idx3-ubyte%s"
                                 % (split, ext)), "wb") as f:
            f.write(struct.pack(">IIII", 2051, count, 28, 28) + imgs.tobytes())
        with opener(os.path.join(root, "%s-labels-idx1-ubyte%s"
                                 % (split, ext)), "wb") as f:
            f.write(struct.pack(">II", 2049, count) + labels.tobytes())


def _write_cifar(root, names, rec, n, seed):
    rs = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for name in names:
        head = rs.randint(0, 10, (n, rec - 3072)).astype(np.uint8)
        body = rs.randint(0, 256, (n, 3072)).astype(np.uint8)
        with open(os.path.join(root, name), "wb") as f:
            f.write(np.concatenate([head, body], 1).tobytes())


@pytest.mark.parametrize("case", ["mnist", "mnist_gz", "fashion", "cifar10",
                                  "cifar10_subdir", "cifar100",
                                  "cifar100_fine"])
@pytest.mark.parametrize("train", [True, False])
def test_vision_datasets_match_jax(tmp_path, case, train):
    root = str(tmp_path / case)
    kw = {}
    if case.startswith(("mnist", "fashion")):
        _write_mnist(root, 6, case != "mnist", 1)
        cls = "FashionMNIST" if case == "fashion" else "MNIST"
    elif case.startswith("cifar10") and not case.startswith("cifar100"):
        sub = os.path.join(root, "cifar-10-batches-bin") \
            if case.endswith("subdir") else root
        _write_cifar(sub, ["data_batch_%d.bin" % i for i in range(1, 6)]
                     + ["test_batch.bin"], 3073, 3, 2)
        cls = "CIFAR10"
    else:
        _write_cifar(root, ["train.bin", "test.bin"], 3074, 4, 3)
        cls = "CIFAR100"
        kw["fine_label"] = case.endswith("fine")

    def run(mod):
        ds = getattr(mod.gluon.data.vision, cls)(
            root=root, train=train,
            transform=lambda d, l: (d.astype("float32") * 2 + 1, l), **kw)
        plain = getattr(mod.gluon.data.vision, cls)(root=root, train=train,
                                                    **kw)
        return [len(ds)] + [_host(list(ds[i])) for i in range(len(ds))] + \
            [_host(plain._data), plain._label]
    want, got = _both(run)
    assert got[0] == want[0] > 0
    _same(got[1:], want[1:])


def test_vision_datasets_need_local_files(tmp_path):
    for cls in ("MNIST", "CIFAR10"):
        with pytest.raises(IOError, match="Nothing is downloaded"):
            getattr(tmx.gluon.data.vision, cls)(root=str(tmp_path / cls))


# --------------------------------------------------------------------------
# a DataLoader feeding steps inside mx.engine.bulk
# --------------------------------------------------------------------------

def _bulk_steps(mod, x, y, bulk, workers):
    net = mod.gluon.nn.Dense(3, in_units=5)
    net.initialize(mod.init.Constant(0.1))
    trainer = mod.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = mod.gluon.loss.SoftmaxCrossEntropyLoss()
    loader = mod.gluon.data.DataLoader(mod.gluon.data.ArrayDataset(x, y),
                                       batch_size=4, num_workers=workers)
    losses = []
    for _ in range(2):
        for xb, yb in loader:
            scope = mod.engine.bulk(64) if bulk else _null()
            with scope:
                with mod.autograd.record():
                    loss = loss_fn(net(xb), yb)
                loss.backward()
                trainer.step(4)
            losses.append(loss.asnumpy())
    return losses, net.weight.data().asnumpy()


class _null(object):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_dataloader_feeds_bulked_steps():
    """Two loader threads make batches while the consumer records and
    flushes bulk segments; the losses and weights equal the eager steps'
    and the JAX build's."""
    rs = np.random.RandomState(8)
    x = rs.standard_normal((16, 5)).astype(np.float32)
    y = rs.randint(0, 3, 16).astype(np.float32)
    eager = _bulk_steps(tmx, x, y, False, 0)
    tmx.engine.reset_flush_stats()
    bulked = _bulk_steps(tmx, x, y, True, 2)
    assert sum(tmx.engine.flush_stats()["segment_lengths"].values()) > 0
    jax_eager = _bulk_steps(jmx, x, y, False, 0)
    for got in (bulked, jax_eager):
        for g, w in zip(got[0], eager[0]):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[1], eager[1], rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# on the card (skipped here): phase 12d's card contracts at a small size
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_transforms_and_loader():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke
    with tmx.gpu(0):
        chip_smoke.gluon_data_card_contracts(tmx, chip_smoke.card_line(),
                                             n=16, size=64, crop=48)
