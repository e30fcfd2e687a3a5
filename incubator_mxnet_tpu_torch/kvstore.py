"""KVStore: the key-value store that Trainer and Module keep weights in.

Counterpart of ``incubator_mxnet_tpu/kvstore.py`` (``KVStore`` :257,
``create`` :741, ``create_kvstore`` :754-782).  ``create("local")`` and
``create("device")`` (``"nccl"`` is ``"device"``) hold one copy of every
value on the device of the value given to ``init`` (a sparse value is
stored dense, as in the JAX build).  ``push`` sums a list of values, one
per context, in its order on the first value's device and keeps the
store's dtype (row-sparse values sum row-sparse, ``sparse.add_n``); with
an updater (``set_optimizer``) the update runs on the store's copy, as
MXNet's server-side optimizer does, so a row-sparse gradient takes SGD's
lazy update.  ``pull`` writes the store's value into every out array, on
its own device; ``row_sparse_pull`` only the rows a batch asks for.

``create("dist_sync")``, ``"dist_device_sync"`` and ``"dist_async"`` make
the stores of several processes (``parallel/dist.py``): a push's sum
there runs over every worker's values too, and ``rank``/``num_workers``
are the process group's.  Gradient compression raises with its ROADMAP
item (11); the JAX build's asynchronous handles, bucket and quantized
wires and its recorder hooks wait for item 12.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from . import optimizer as opt
from .base import MXNetError
from .ndarray import NDArray, sparse
from .ndarray import ndarray as _nd_mod

__all__ = ["KVStore", "create", "create_kvstore"]

_LOCAL_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device", "nccl")


def _int_key(k):
    try:
        return int(k)
    except ValueError:
        return k


class KVStore(object):
    """The store of one process (ref: include/mxnet/kvstore.h)."""

    def __init__(self, type_="local"):
        self._type = type_
        self._store = {}           # key (str) -> NDArray, the store's copy
        self._updater = None

    # -- identity ----------------------------------------------------------
    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        """This worker's rank (ref: kvstore.h get_rank): 0 without a
        launcher."""
        from .parallel import dist
        return dist.rank()

    @property
    def num_workers(self):
        from .parallel import dist
        return dist.num_workers()

    # -- data path ---------------------------------------------------------
    def init(self, key, value):
        """Register each key once with a copy of its value (the first of a
        list); a key given twice raises."""
        keys, values = self._normalize(key, value)
        for k, vlist in zip(keys, values):
            if k in self._store:
                raise ValueError("duplicate init of key %s" % k)
            self._store[k] = vlist[0].copy()

    def push(self, key, value, priority=0):
        """Sum each key's values (in list order) into the store: through the
        updater when one is set, else as the store's new value in the
        store's dtype."""
        keys, values = self._normalize(key, value)
        reds = []
        for k, vlist in zip(keys, values):
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
            reds.append(self._reduce(vlist))
        # the sum over workers: one collective per dtype for the whole push
        # on the dist stores, nothing here
        reds = self._cross_worker_reduce_many(reds)
        for k, red in zip(keys, reds):
            if self._updater is not None:
                self._updater(_int_key(k), red, self._store[k])
            else:
                _nd_mod._write(self._store[k]._data, red._data)

    def _cross_worker_reduce_many(self, reds):
        """The sums over every worker of a push's values (one process:
        the values; ``DistKVStore`` overrides)."""
        return reds

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Write each key's store value into every array of ``out``."""
        if out is None:
            raise ValueError("pull needs out arrays")
        keys, outs = self._normalize(key, out)
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
            val = self._store[k]._data
            for o in olist:
                _nd_mod._writable(o)
                _nd_mod._write(o._data, val)

    def push_many(self, keys, values, priority=0):
        """Push a list of keys in one call."""
        return self.push(list(keys), list(values), priority=priority)

    def pull_many(self, keys, outs, priority=0):
        """Pull a list of keys in one call."""
        return self.pull(list(keys), outs, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` of each key (ref:
        KVStore::PullRowSparse, kvstore_local.h PullRowSparseImpl): the ids
        deduplicated and sorted (one host sync on the card); a row-sparse
        out receives just those rows, a dense out is zeros but for them.
        ``row_ids`` is one NDArray for every out, or a list, one an out."""
        if out is None or row_ids is None:
            raise ValueError("row_sparse_pull needs out and row_ids")
        keys, outs = self._normalize(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(outs[0])
        for k, olist in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
            src = self._store[k]._data
            for o, rid in zip(olist, row_ids):
                idx = torch.unique(sparse._ids(rid, src.device))
                sparse.check_range(idx, src.shape[0], "row")
                rows = src.index_select(0, idx)
                if isinstance(o, sparse.RowSparseNDArray):
                    dev = o.context.torch_device()
                    o.data = NDArray(rows.to(dev, o.data._data.dtype),
                                     ctx=o.context)
                    o.indices = NDArray(idx.to(dev), ctx=o.context)
                    o.canonical = True
                else:
                    dense = torch.zeros_like(src).index_copy_(0, idx, rows)
                    _nd_mod._write(o._data, dense)

    @staticmethod
    def _reduce(vlist):
        if len(vlist) == 1:
            return vlist[0]
        if all(isinstance(v, sparse.CSRNDArray) for v in vlist):
            return KVStore._sum_csr(vlist)
        if any(isinstance(v, sparse.BaseSparseNDArray) for v in vlist):
            # the sparse-aware sum (ref: comm.h ReduceRowSparse)
            return sparse.add_n(*vlist)
        with torch.no_grad():
            acc = vlist[0]._data
            for v in vlist[1:]:
                acc = acc + v._data.to(acc.device)
        # the first value's context, as the JAX build (a CPU tensor alone
        # would name cpu(0) for every cpu(i))
        return NDArray(acc, ctx=vlist[0].context)

    @staticmethod
    def _sum_csr(vlist):
        """The sum of CSR values, as CSR, band by band of rows
        (:func:`_csr_band_rows`), each band densified, summed and compressed
        alone."""
        nrows, ncols = vlist[0].shape
        data = vlist[0].data._data
        band = _csr_band_rows((nrows, ncols), data.element_size())
        rows, cols, vals = [], [], []
        for r0 in range(0, nrows, band):
            r1 = min(r0 + band, nrows)
            acc = torch.zeros((r1 - r0, ncols), dtype=data.dtype,
                              device=data.device)
            for v in vlist:
                acc += v[r0:r1]._dense().to(data.device)
            r, c = sparse._nonzero_2d(acc)
            rows.append(r + r0)
            cols.append(c)
            vals.append(acc[r, c])
        return sparse._csr_of(torch.cat(rows), torch.cat(cols),
                              torch.cat(vals), (nrows, ncols),
                              vlist[0].context)

    @staticmethod
    def _normalize(key, value):
        single = not isinstance(key, (list, tuple))
        keys = [key] if single else list(key)
        if single:
            values = [value if isinstance(value, (list, tuple)) else [value]]
        else:
            values = [v if isinstance(v, (list, tuple)) else [v]
                      for v in value]
        if len(values) != len(keys):
            raise ValueError("%d keys but %d values" % (len(keys),
                                                        len(values)))
        return [str(k) for k in keys], values

    # -- optimizer / updater ----------------------------------------------
    def set_updater(self, updater):
        """``updater(key, merged_value, stored_value)`` runs on every push."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on the store: its updater shares the live
        optimizer object, so a Trainer's per-step ``rescale_grad`` and
        learning rate reach it."""
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        raise MXNetError("gradient compression is not ported yet (ROADMAP "
                         "item 12: parallel/compression.py and the "
                         "compressed wires)")

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the store's updater states (with the optimizer when
        ``dump_optimizer``) to ``fname``."""
        if self._updater is None:
            raise MXNetError("the store has no optimizer: call "
                             "set_optimizer first")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Read what :meth:`save_optimizer_states` wrote.  Only a file this
        program (or one you trust) wrote: unpickling can run code."""
        if self._updater is None:
            raise MXNetError("the store has no optimizer: call "
                             "set_optimizer first")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # -- the calls of distributed training --------------------------------
    def barrier(self):
        """Every worker arrives before any leaves (one process: at once)."""
        from .parallel import dist
        dist.barrier()

    def send_command_to_servers(self, head, body):
        return None

    def quiesce(self, timeout=None):
        """Nothing is in flight in one process: drains 0 operations."""
        return 0


def _csr_band_rows(shape, element_size):
    """Rows of a CSR value densified at once when it is summed: all of
    them while the dense matrix fits ``MXTPU_CSR_DENSIFY_BOUND`` bytes
    (default 256 MB); above, a warning and bands that fit (the JAX build's
    densify guard, ``parallel/dist.py:655-700``).  The band comes from the
    shape only, so every worker sums the same bands."""
    nrows, ncols = shape
    bound = int(os.environ.get("MXTPU_CSR_DENSIFY_BOUND", str(1 << 28)))
    row_bytes = ncols * element_size
    if nrows * row_bytes <= bound:
        return nrows
    warnings.warn(
        "CSR reduce of %s (%d bytes dense) exceeds MXTPU_CSR_DENSIFY_BOUND="
        "%d; using the chunked row-band path (slower, bounded memory)"
        % ((nrows, ncols), nrows * row_bytes, bound))
    return max(1, bound // max(row_bytes, 1))


def create(name="local"):
    """A store by type name (ref: kvstore.cc KVStore::Create)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _LOCAL_TYPES:
        return KVStore("device" if name in ("device", "nccl") else "local")
    if name in ("dist_sync", "dist_async", "dist_device_sync"):
        from .parallel import dist
        return dist.DistKVStore(name)
    raise ValueError("Unknown KVStore type %s" % name)


def create_kvstore(kvstore, num_device, arg_params):
    """``(store or None, update_on_kvstore)`` for a kvstore spec (ref:
    model.py _create_kvstore).  A ``KVStore`` object is used as given; a
    type name on one device needs no store; ``MXNET_UPDATE_ON_KVSTORE=0``
    keeps the update local, and so does a ``"local"`` store over several
    devices once a parameter exceeds 16M elements."""
    try:
        update_on_kvstore = bool(int(
            os.environ.get("MXNET_UPDATE_ON_KVSTORE", "1")))
    except ValueError:
        update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = create(kvstore)
            if kvstore == "local":
                max_size = max(int(np.prod(p.shape))
                               for p in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore
