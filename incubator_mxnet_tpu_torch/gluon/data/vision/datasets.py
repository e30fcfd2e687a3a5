"""Vision datasets (counterpart of
``incubator_mxnet_tpu/gluon/data/vision/datasets.py``; ref:
python/mxnet/gluon/data/vision/datasets.py).

MNIST and FashionMNIST read the idx files (gzip or not), CIFAR10/100 the
binary batches, from files already under ``root``: nothing is downloaded.
The images become one NDArray on the current context.  ImageRecordDataset
and ImageFolderDataset decode with OpenCV (``image.imdecode``).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .... import ndarray as _nd
from .... import config as _config
from ..dataset import Dataset, RecordFileDataset


def _default_root(name):
    """Dataset directory under MXTPU_HOME (default ~/.mxnet/datasets)."""
    return os.path.join(_config.data_home(), "datasets", name)

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    """ref: datasets.py _DownloadedDataset."""

    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        root = os.path.expanduser(root)
        self._root = root
        if not os.path.isdir(root):
            os.makedirs(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from idx files (ref: datasets.py class MNIST)."""

    _train_data = "train-images-idx3-ubyte.gz"
    _train_label = "train-labels-idx1-ubyte.gz"
    _test_data = "t10k-images-idx3-ubyte.gz"
    _test_label = "t10k-labels-idx1-ubyte.gz"

    def __init__(self, root=None, train=True, transform=None):
        self._train = train
        super().__init__(root or _default_root("mnist"), transform)

    def _get_data(self):
        if self._train:
            data_file = os.path.join(self._root, self._train_data)
            label_file = os.path.join(self._root, self._train_label)
        else:
            data_file = os.path.join(self._root, self._test_data)
            label_file = os.path.join(self._root, self._test_label)
        for f in (data_file, label_file):
            alt = f[:-3]  # allow non-gz
            if not os.path.exists(f) and not os.path.exists(alt):
                raise IOError(
                    "%s not found. Nothing is downloaded; place the MNIST idx "
                    "files under %s." % (f, self._root))

        def _open(path):
            if os.path.exists(path):
                return gzip.open(path, "rb")
            return open(path[:-3], "rb")

        with _open(label_file) as fin:
            struct.unpack(">II", fin.read(8))
            label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
        with _open(data_file) as fin:
            struct.unpack(">IIII", fin.read(16))
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(len(label), 28, 28, 1)
        self._data = _nd.array(data, dtype=data.dtype)
        self._label = label


class FashionMNIST(MNIST):
    """ref: datasets.py class FashionMNIST (same idx format)."""

    def __init__(self, root=None, train=True, transform=None):
        super().__init__(root or _default_root("fashion-mnist"),
                         train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 binary batches (ref: datasets.py class CIFAR10)."""

    _archive_members = ["data_batch_1.bin", "data_batch_2.bin",
                        "data_batch_3.bin", "data_batch_4.bin",
                        "data_batch_5.bin"]
    _test_member = "test_batch.bin"
    _rec_size = 3073

    def __init__(self, root=None, train=True, transform=None):
        self._train = train
        super().__init__(root or _default_root("cifar10"), transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        data = raw.reshape(-1, self._rec_size)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        files = self._archive_members if self._train else [self._test_member]
        paths = [os.path.join(self._root, f) for f in files]
        # also allow the cifar-10-batches-bin subdir layout
        alt = os.path.join(self._root, "cifar-10-batches-bin")
        if not os.path.exists(paths[0]) and os.path.isdir(alt):
            paths = [os.path.join(alt, f) for f in files]
        for p in paths:
            if not os.path.exists(p):
                raise IOError(
                    "%s not found. Nothing is downloaded; place the CIFAR "
                    "binary batches under %s." % (p, self._root))
        data, label = zip(*[self._read_batch(p) for p in paths])
        data = np.concatenate(data)
        label = np.concatenate(label)
        self._data = _nd.array(data, dtype=data.dtype)
        self._label = label


class CIFAR100(CIFAR10):
    """ref: datasets.py class CIFAR100."""

    _rec_size = 3074

    def __init__(self, root=None, fine_label=False, train=True,
                 transform=None):
        self._fine_label = fine_label
        self._archive_members = ["train.bin"]
        self._test_member = "test.bin"
        super().__init__(root=root or _default_root("cifar100"),
                         train=train, transform=transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        data = raw.reshape(-1, self._rec_size)
        return data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0 if not self._fine_label else 1].astype(np.int32)


class ImageRecordDataset(RecordFileDataset):
    """Images + labels from a RecordIO file (ref: datasets.py
    ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import recordio, image
        record = super().__getitem__(idx)
        header, img = recordio.unpack(record)
        img = image.imdecode(img, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """folder/label/img.jpg layout (ref: datasets.py ImageFolderDataset)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from .... import image
        with open(self.items[idx][0], "rb") as f:
            img = image.imdecode(f.read(), self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
