"""DataLoader (counterpart of ``incubator_mxnet_tpu/gluon/data/dataloader.py``;
ref: python/mxnet/gluon/data/dataloader.py).

The reference forks worker processes and ships batches through shared
memory.  Here, as in the JAX build, batches are built on a pool of
``max(1, num_workers)`` threads (numpy and torch's CPU ops release the
GIL) with a lookahead of ``max(prefetch_depth(), num_workers)`` batches;
with ``num_workers=0`` the one thread keeps batches sequential and in
order.  Samples that are numpy arrays become batches on the context
current when iteration starts (the card unless the caller says
``mx.cpu()``), on the thread that builds them; NDArray samples are
stacked where they lie.  The JAX build's ``prefetch_device`` argument is
accepted and ignored: a batch is built on its device, so there is no
later copy to start early.

The JAX build's autotuner registration, its step-attribution spans and
its fault-injection point are not ported (ROADMAP item 12).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ... import ndarray as _nd
from ...context import current_context
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (ref: dataloader.py default_batchify_fn).
    Numpy input narrows 64-bit types to 32 bits, as the JAX build stores
    them."""
    if isinstance(data[0], NDArray):
        return _nd.ndarray.concatenate([d.expand_dims(0) for d in data], axis=0)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    return _nd.array(np.asarray(data))


def prefetch_depth_default():
    """How many lookahead batches the pipeline keeps in flight beyond what
    the worker count implies: 2, the JAX build's default.  Its
    ``GRAFT_PREFETCH_DEPTH`` serves the autotuner, which the port has not
    yet (ROADMAP item 12); ``DataLoader.set_prefetch_depth`` overrides it
    for one loader."""
    return 2


class DataLoader(object):
    """Loads batches from a Dataset (ref: dataloader.py class DataLoader).
    ``prefetch_device`` is accepted for the JAX build's signature and
    ignored (see the module doc)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, prefetch_device=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler is "
                                 "specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch must "
                             "not be specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers
        self._prefetch_depth = None     # None: prefetch_depth_default()
        self._pool = None               # made at first use, kept across epochs
        self._pool_threads = 0
        if batchify_fn is None:
            self._batchify_fn = default_batchify_fn
        else:
            self._batchify_fn = batchify_fn

    def set_num_workers(self, n):
        """Change the worker count: an open epoch deepens its lookahead on
        its next batch, and the pool takes the new thread count when the
        next epoch starts."""
        self._num_workers = max(0, int(n))

    def prefetch_depth(self):
        """The lookahead depth: the override of ``set_prefetch_depth``, else
        :func:`prefetch_depth_default`."""
        d = self._prefetch_depth
        return prefetch_depth_default() if d is None else d

    def set_prefetch_depth(self, n):
        """Change the lookahead depth while iterating; an open epoch reads
        it again on its next batch."""
        self._prefetch_depth = max(1, int(n))

    def _worker_pool(self):
        threads = max(1, self._num_workers)
        if self._pool_threads != threads:
            # an open epoch keeps the old pool; its threads end with it
            self._pool = None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=threads,
                                            thread_name_prefix="dataloader")
            self._pool_threads = threads
        return self._pool

    def close(self):
        """Shut the worker pool down (a later epoch makes a new one).  Not
        while an epoch is being iterated: its next submit would raise."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass                # interpreter teardown

    def __iter__(self):
        ctx = current_context()
        it = iter(self._batch_sampler)
        pool = self._worker_pool()

        def make(batch):
            with ctx:
                return self._batchify_fn([self._dataset[idx] for idx in batch])
        futures = []

        def top_up():
            want = max(self.prefetch_depth(), self._num_workers)
            try:
                while len(futures) < want:
                    futures.append(pool.submit(make, next(it)))
            except StopIteration:
                pass
        try:
            top_up()
            while futures:
                out = futures.pop(0).result()
                top_up()
                yield out
        finally:
            # an abandoned epoch leaves no queued work for the next one
            for f in futures:
                f.cancel()

    def __len__(self):
        return len(self._batch_sampler)
