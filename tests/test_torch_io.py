"""The port's data iterators against the JAX build's, on the CPU: every
batch (data, label, pad) of NDArrayIter under pad, discard and roll_over
over two epochs, with shuffle and with several named inputs, CSVIter and
MNISTIter over files under ``tmp_path``, ResizeIter and PrefetchingIter.
Batches are bit-equal."""
import gzip
import struct

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ndarray import NDArray


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _epochs(it, n=2):
    out = []
    for _ in range(n):
        out.append([([d.asnumpy() for d in b.data],
                     [lab.asnumpy() for lab in (b.label or [])], b.pad)
                    for b in it])
        it.reset()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for (gd, gl, gp), (wd, wl, wp) in zip(ge, we):
            assert gp == wp
            for a, b in zip(gd + gl, wd + wl):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _data(n=10, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((n, 3, 2)).astype(np.float32),
            rs.randint(0, 4, n).astype(np.float32))


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("batch", [3, 4, 5])
def test_ndarray_iter_matches_jax(handle, batch):
    x, y = _data()
    its = [m.io.NDArrayIter(x, y, batch_size=batch, last_batch_handle=handle)
           for m in (jmx, tmx)]
    assert its[1].provide_data[0].shape == its[0].provide_data[0].shape
    assert [d.name for d in its[1].provide_label] == \
        [d.name for d in its[0].provide_label]
    _same(_epochs(its[1], 3), _epochs(its[0], 3))


def test_ndarray_iter_shuffle_and_named_inputs_match_jax():
    x, y = _data(12, 1)
    z = np.arange(24, dtype=np.float32).reshape(12, 2)
    its = []
    for m in (jmx, tmx):
        np.random.seed(7)
        its.append(m.io.NDArrayIter({"a": x, "b": z}, {"lab": y},
                                    batch_size=5, shuffle=True))
    assert [d.name for d in its[1].provide_data] == ["a", "b"]
    _same(_epochs(its[1]), _epochs(its[0]))
    with tmx.cpu():
        lst = tmx.io.NDArrayIter([x, z], y, batch_size=4)
    assert [d.name for d in lst.provide_data] == ["_0_data", "_1_data"]


def test_resize_and_prefetching_iters_match_jax():
    x, y = _data(10, 2)
    res = []
    for m in (jmx, tmx):
        base = m.io.NDArrayIter(x, y, batch_size=4)
        res.append(_epochs(m.io.ResizeIter(base, 5)))
    _same(res[1], res[0])
    res = []
    for m in (jmx, tmx):
        pf = m.io.PrefetchingIter(m.io.NDArrayIter(x, y, batch_size=3),
                                  prefetch_buffer=2)
        res.append(_epochs(pf))
        pf.close()
    _same(res[1], res[0])


def test_csv_iter_matches_jax(tmp_path):
    rs = np.random.RandomState(3)
    data = rs.standard_normal((7, 6)).astype(np.float32)
    label = rs.randint(0, 3, (7, 1)).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    for round_batch in (True, False):
        its = [m.io.CSVIter(data_csv=str(tmp_path / "d.csv"),
                            data_shape=(2, 3),
                            label_csv=str(tmp_path / "l.csv"),
                            label_shape=(1,), batch_size=3,
                            round_batch=round_batch) for m in (jmx, tmx)]
        assert its[1].provide_data == its[0].provide_data
        _same(_epochs(its[1]), _epochs(its[0]))


def _write_idx(path, images, labels):
    with gzip.open(str(path) + "-images.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, len(images), 28, 28))
        f.write(images.tobytes())
    with gzip.open(str(path) + "-labels.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.tobytes())


@pytest.mark.parametrize("flat,shuffle", [(False, True), (True, False)])
def test_mnist_iter_matches_jax(tmp_path, flat, shuffle):
    rs = np.random.RandomState(4)
    images = rs.randint(0, 256, (11, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 11).astype(np.uint8)
    _write_idx(tmp_path / "t", images, labels)
    its = [m.io.MNISTIter(image=str(tmp_path / "t-images.gz"),
                          label=str(tmp_path / "t-labels.gz"),
                          batch_size=4, flat=flat, shuffle=shuffle, seed=5)
           for m in (jmx, tmx)]
    got = _epochs(its[1])
    _same(got, _epochs(its[0]))
    assert len(got[0]) == 2                    # the tail is discarded
    assert got[0][0][0][0].shape == ((4, 784) if flat else (4, 1, 28, 28))


def test_data_desc_batch_and_device_prefetch():
    d = tmx.io.DataDesc("data", (4, 3), np.float32, "NC")
    assert d.name == "data" and d.shape == (4, 3) and d.layout == "NC"
    assert tmx.io.DataDesc.get_batch_axis("TNC") == 1
    assert repr(d) == repr(jmx.io.DataDesc("data", (4, 3), np.float32, "NC"))
    a = tmx.nd.ones((2,))
    b = tmx.io.DataBatch([a], [a], pad=0)
    assert tmx.io.issue_device_prefetch(b) is b and b.data[0] is a
    assert str(b).startswith("DataBatch: data shapes: [(2,)]")


@pytest.mark.cuda
def test_device_prefetch_copies_a_host_tensor_to_its_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = NDArray(torch.arange(4.0), ctx=tmx.gpu(0))
    assert not a._data.is_cuda
    tmx.io.issue_device_prefetch(tmx.io.DataBatch([a], None))
    assert a._data.is_cuda and a.asnumpy().tolist() == [0.0, 1.0, 2.0, 3.0]


def test_iterators_of_later_items_raise():
    # LibSVMIter came with item 10 (tests/test_torch_sparse.py): it now
    # reads its file
    with pytest.raises(IOError):
        tmx.io.LibSVMIter("/nonexistent/x.libsvm", (4,))
    # ImageRecordIter came with item 6: it now reaches the record reader
    with pytest.raises(IOError, match="cannot open"):
        tmx.io.ImageRecordIter(path_imgrec="/nonexistent/x.rec",
                               data_shape=(3, 8, 8))


def test_iter_arrays_live_on_the_current_context():
    x, y = _data(4, 5)
    it = tmx.io.NDArrayIter(x, y, batch_size=2)
    assert next(iter(it)).data[0].context == tmx.cpu()
    with tmx.gpu(0):
        with pytest.raises(MXNetError, match="CUDA"):
            tmx.io.NDArrayIter(x, y, batch_size=2)
