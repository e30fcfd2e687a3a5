"""Data iterators (counterpart of ``incubator_mxnet_tpu/io.py``; ref:
python/mxnet/io.py and src/io/).

The ``DataIter`` protocol (provide_data/provide_label/reset/next with a
DataBatch of NDArrays and its pad) is kept, so Module.fit and training
scripts port unchanged.  The in-memory iterators (``NDArrayIter``, and
``CSVIter`` and ``MNISTIter`` over it) make their arrays on the current
context, the card unless the caller says ``mx.cpu()``; the prefetcher is a
thread (the reference's dmlc ThreadedIter, iter_prefetcher.h).
``ImageRecordIter`` is ``image.ImageIter`` (decode and augmentation on a
thread pool, on the host) under a ``PrefetchingIter``.  ``LibSVMIter``
parses a LibSVM file once into a CSR triple on the host and slices each
batch from it, a ``CSRNDArray`` on the current context.
"""
from __future__ import annotations

import gzip
import struct
import threading
from collections import namedtuple

import numpy as np

from .base import MXNetError
from .ndarray import NDArray, sparse
from . import ndarray as nd

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "MNISTIter", "ImageRecordIter", "PrefetchingIter",
           "ResizeIter", "issue_device_prefetch"]


def issue_device_prefetch(obj):
    """Start a non-blocking copy of every NDArray under ``obj`` (an NDArray,
    a list or tuple, or a DataBatch) whose tensor is not on its context's
    device to that device, so the consumer's first read finds it there or
    on its way.  Arrays already on their device are left alone."""
    if isinstance(obj, DataBatch):
        issue_device_prefetch(obj.data)
        issue_device_prefetch(obj.label)
        return obj
    if isinstance(obj, (list, tuple)):
        for item in obj:
            issue_device_prefetch(item)
        return obj
    if isinstance(obj, NDArray):
        device = obj.context.torch_device()
        if obj._data.device != device:
            obj._data = obj._data.to(device, non_blocking=True)
    return obj


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data description (ref: io.py class DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        """ref: io.py DataDesc.get_batch_axis."""
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch(object):
    """One mini-batch (ref: io.py class DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), \
                "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), \
                "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter(object):
    """Base iterator (ref: io.py class DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """Resize another iterator to `size` batches per epoch
    (ref: io.py class ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _PrefetchError(object):
    """Producer-side exception carrier: re-raised at the consumer's next
    iter_next() so a corrupt record fails the training loop instead of
    dying silently on a daemon thread."""

    def __init__(self, exc):
        self.exc = exc


class PrefetchingIter(DataIter):
    """Threaded prefetch over base iterator(s), ``prefetch_buffer`` batches
    deep (ref: io.py class PrefetchingIter / src/io/iter_prefetcher.h —
    the dmlc ThreadedIter double buffer, generalized to a bounded queue
    so a bursty consumer can drain several batches without stalling)."""

    _STOP = object()

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_buffer=1):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.prefetch_buffer = max(int(prefetch_buffer), 1)
        self.current_batch = None
        self.started = True
        self._start_threads()

    def _start_threads(self):
        import queue
        self._queues = [queue.Queue(maxsize=self.prefetch_buffer)
                        for _ in range(self.n_iter)]
        self._stop_flags = [False] * self.n_iter
        self._exhausted = False

        # the closure must NOT capture self: the producer thread would
        # otherwise keep the iterator alive forever and __del__ cleanup
        # could never run
        def prefetch_func(it, q, flags, i):
            while not flags[i]:
                try:
                    # H2D for the lookahead batch issues on THIS
                    # thread, riding under the consumer's compute
                    batch = issue_device_prefetch(it.next())
                except StopIteration:
                    batch = None
                except Exception as exc:   # surface errors at the consumer
                    batch = _PrefetchError(exc)
                while not flags[i]:
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if batch is None or isinstance(batch, _PrefetchError):
                    return  # epoch exhausted / failed; restarted by reset()
        self.prefetch_threads = [
            threading.Thread(target=prefetch_func,
                             args=(self.iters[i], self._queues[i],
                                   self._stop_flags, i), daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def _stop_threads(self):
        for i in range(self.n_iter):
            self._stop_flags[i] = True
        for i, t in enumerate(self.prefetch_threads):
            # drain so a producer blocked on a full queue can observe stop
            while t.is_alive():
                try:
                    self._queues[i].get_nowait()
                except Exception:
                    pass
                t.join(timeout=0.05)

    def __del__(self):
        try:
            self._stop_threads()
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        self._stop_threads()
        for i in self.iters:
            i.reset()
        self._start_threads()

    def close(self):
        """Stop the producer threads and drop buffered batches.  Call when
        abandoning the iterator mid-epoch; reset() restarts after it."""
        self._stop_threads()
        self._exhausted = True  # iter_next() answers False, never blocks

    def iter_next(self):
        if self._exhausted:
            # the producer put ONE end-of-epoch sentinel and parked;
            # keep answering False (Event-era behavior) until reset()
            return False
        batches = [q.get() for q in self._queues]
        for b in batches:
            if isinstance(b, _PrefetchError):
                self._exhausted = True
                raise b.exc
        if batches[0] is None:
            self._exhausted = True
            for b in batches:
                assert b is None, "Number of entry mismatches between iterators"
            return False
        for batch in batches:
            assert batch.pad == batches[0].pad, \
                "Number of entry mismatches between iterators"
        self.current_batch = DataBatch(
            sum([batch.data for batch in batches], []),
            sum([batch.label for batch in batches], []),
            batches[0].pad, batches[0].index,
            provide_data=self.provide_data, provide_label=self.provide_label)
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Convert data into a canonical [(name, array)] list (ref: io.py
    _init_data)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    ret = []
    for k, v in data.items():
        if not isinstance(v, NDArray):
            try:
                v = nd.array(v)
            except MXNetError:
                raise
            except Exception:
                raise TypeError("Invalid type '%s' for %s, should be NDArray "
                                "or numpy.ndarray" % (type(v), k))
        ret.append((k, v))
    return list(sorted(ret))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (ref: io.py:546 class NDArrayIter):
    shuffle, pad/discard/roll_over last-batch handling, multi-input dicts."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)

        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, nd.array(v.asnumpy()[self.idx], ctx=v.context,
                                      dtype=v.dtype)) for k, v in self.data]
            self.label = [(k, nd.array(v.asnumpy()[self.idx], ctx=v.context,
                                       dtype=v.dtype)) for k, v in self.label]

        if last_batch_handle == "discard":
            new_n = self.data[0][1].shape[0] - \
                self.data[0][1].shape[0] % batch_size
            self.idx = self.idx[:new_n]

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size."
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % \
                self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            return [x[1][self.cursor:self.cursor + self.batch_size]
                    for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [nd.ndarray.concatenate([x[1][self.cursor:], x[1][:pad]])
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class CSVIter(DataIter):
    """CSV file iterator (ref: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.dtype(dtype),
                          ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0],) + tuple(label_shape), np.float32)
        self._inner = NDArrayIter(data, label, batch_size,
                                  last_batch_handle="roll_over" if round_batch
                                  else "pad")
        # csv iter names (ref: iter_csv.cc uses data/label)
        self._inner.data = [("data", self._inner.data[0][1])]
        self._inner.label = [("label", self._inner.label[0][1])]

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """LibSVM sparse-format iterator (ref: src/io/iter_libsvm.cc; the JAX
    build's io.py:541-614).  Each line ``label id:value id:value ...`` is
    parsed once into one CSR triple on the host (ids and values in file
    order; the rows are never made dense); a batch is the slice of
    ``batch_size`` rows from the cursor, a ``CSRNDArray`` of shape
    (batch_size, prod(data_shape)) on the current context, with its labels
    (float32) as the batch's label.  The last batch wraps to the first
    rows, and ``pad`` counts the rows wrapped.  ``label_libsvm`` is
    accepted and, as in the JAX build, not read."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 batch_size=1, **kwargs):
        super().__init__(batch_size)
        labels, ids, values, counts = [], [], [], []
        with open(data_libsvm) as f:
            for line in f:
                toks = line.replace(":", " ").split()
                if not toks:
                    continue
                labels.append(toks[0])
                ids.extend(toks[1::2])
                values.extend(toks[2::2])
                counts.append((len(toks) - 1) // 2)
        self._labels = np.array(labels, dtype=np.float64).astype(np.float32)
        self._indices = np.array(ids, dtype=np.int64)
        self._values = np.array(values, dtype=np.float64).astype(np.float32)
        self._indptr = np.concatenate(
            [[0], np.cumsum(np.array(counts, np.int64))]).astype(np.int64)
        self._dim = int(np.prod(data_shape))
        self._n = len(labels)
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._dim), "float32")]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,), "float32")]

    def reset(self):
        self._cursor = 0

    def next(self):
        if self._cursor >= self._n:
            raise StopIteration
        rows = (self._cursor + np.arange(self.batch_size)) % self._n
        pad = max(self._cursor + self.batch_size - self._n, 0)
        self._cursor += self.batch_size
        ptr = self._indptr
        # the rows are one run from the cursor, or two when they wrap
        runs = np.split(rows, np.nonzero(np.diff(rows) != 1)[0] + 1)
        spans = [(ptr[r[0]], ptr[r[-1] + 1]) for r in runs]
        sizes = np.diff(ptr)[rows]
        csr = sparse.csr_matrix(
            (np.concatenate([self._values[a:b] for a, b in spans]),
             np.concatenate([self._indices[a:b] for a, b in spans]),
             np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)),
            shape=(self.batch_size, self._dim))
        return DataBatch([csr], [nd.array(self._labels[rows])], pad)


class MNISTIter(DataIter):
    """MNIST idx-file iterator (ref: src/io/iter_mnist.cc)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=0, input_shape=None, **kwargs):
        super().__init__(batch_size)

        def _open(path):
            if path.endswith(".gz"):
                return gzip.open(path, "rb")
            return open(path, "rb")
        with _open(label) as fin:
            struct.unpack(">II", fin.read(8))
            lab = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.float32)
        with _open(image) as fin:
            struct.unpack(">IIII", fin.read(16))
            img = np.frombuffer(fin.read(), dtype=np.uint8)
            img = img.reshape(len(lab), 28, 28).astype(np.float32) / 255.0
        if flat:
            img = img.reshape(len(lab), 784)
        else:
            img = img.reshape(len(lab), 1, 28, 28)
        if input_shape is not None:
            img = img.reshape((len(lab),) + tuple(input_shape))
        if shuffle:
            rng = np.random.RandomState(seed)
            order = rng.permutation(len(lab))
            img, lab = img[order], lab[order]
        self._inner = NDArrayIter(img, lab, batch_size,
                                  last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def ImageRecordIter(path_imgrec=None, data_shape=None, batch_size=1,
                    label_width=1, shuffle=False, part_index=0, num_parts=1,
                    preprocess_threads=4, prefetch_buffer=4, **kwargs):
    """ImageRecordIter factory (ref: src/io/iter_image_recordio_2.cc:727
    registration): an ``image.ImageIter`` whose decode and augmentation run
    on a ``preprocess_threads``-wide pool, under a ``PrefetchingIter``
    ``prefetch_buffer`` batches deep (reader, parser pool, prefetcher, as
    iter_image_recordio_2.cc:663-762 layers them).  MXNet's argument names
    are translated: ``mean_r/g/b``, ``std_r/g/b``, ``rand_mirror_prob``."""
    from .image import image as img_mod
    known = {}
    aug_keys = ("resize", "rand_crop", "rand_resize", "rand_mirror", "mean",
                "std", "brightness", "contrast", "saturation", "hue",
                "pca_noise", "rand_gray", "inter_method")
    if kwargs.pop("rand_mirror_prob", None):
        known["rand_mirror"] = True
    mean = None
    if any(k in kwargs for k in ("mean_r", "mean_g", "mean_b")):
        mean = np.array([kwargs.pop("mean_r", 0), kwargs.pop("mean_g", 0),
                         kwargs.pop("mean_b", 0)])
    std = None
    if any(k in kwargs for k in ("std_r", "std_g", "std_b")):
        std = np.array([kwargs.pop("std_r", 1), kwargs.pop("std_g", 1),
                        kwargs.pop("std_b", 1)])
    for k in aug_keys:
        if k in kwargs:
            known[k] = kwargs.pop(k)
    if mean is not None:
        known["mean"] = mean
    if std is not None:
        known["std"] = std
    it = img_mod.ImageIter(batch_size=batch_size, data_shape=data_shape,
                           label_width=label_width, path_imgrec=path_imgrec,
                           shuffle=shuffle, part_index=part_index,
                           num_parts=num_parts,
                           path_imgidx=kwargs.pop("path_imgidx", None),
                           preprocess_threads=preprocess_threads,
                           decode=kwargs.pop("decode", "auto"),
                           raw_shape=kwargs.pop("raw_shape", None),
                           dtype=kwargs.pop("dtype", "float32"),
                           aug_list=kwargs.pop("aug_list", None),
                           ctx=kwargs.pop("ctx", None),
                           **known)
    if prefetch_buffer and int(prefetch_buffer) > 0:
        return PrefetchingIter(it, prefetch_buffer=prefetch_buffer)
    return it
