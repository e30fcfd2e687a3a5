"""Several processes: the bootstrap, the collectives and the ``dist_*`` stores.

Counterpart of ``incubator_mxnet_tpu/parallel/dist.py`` (its synchronous
core, :42-146, :184-906).  Processes meet through
``torch.distributed.init_process_group`` at the address ``tools/launch.py``
hands them (``MX_COORDINATOR``, ``MX_NUM_PROCESSES``, ``MX_PROCESS_ID``);
a process started without a launcher is rank 0 of 1 and runs no
collective.  The KVStore API stays MXNet's: ``init`` broadcasts rank 0's
values, ``push`` sums every rank's values and ``pull`` reads the sum.

The wire is chosen by the store's type, as MXNet chooses where to
aggregate:

* ``dist_sync`` over gloo, a host-side wire (MXNet's ``dist_sync``
  aggregates on the CPU too).  Gloo takes card tensors, copying them
  through the host, so several ranks may share one card;
* ``dist_device_sync`` over ``"cpu:gloo,cuda:nccl"``: NCCL for card
  tensors, MXNet's aggregation on the device.  NCCL takes one rank a card:
  ranks that share one raise ``MXNetError`` naming them and the card, and
  the store never falls back to gloo;
* ``dist_async`` on the host parameter service of ``parallel/ps.py``:
  rank 0 hosts it, every push is applied as it arrives.

A push packs the values of its keys per dtype, in the caller's key order,
into one flat buffer each and sums each with one ``all_reduce`` (integers
in their own dtype, so their sums stay exact); every rank derives the key
order from the same ``enumerate`` over parameters, so every rank issues the
same collectives in the same order.  A row-sparse value travels as its ids
and rows, padded to the largest count, and is summed over the union of the
ids.  The JAX build's lockstep auditor, elastic membership, flight
recorder, heartbeat skew, knob mailbox and compressed wires wait for
ROADMAP item 12.

A mesh of ranks may name its axes (``worker_mesh(axes={"dp": 1, "sp":
2})``, rank r at flat position r, row-major).  :class:`RankAxis` is this
rank's shard of one axis: its collectives run on the subgroup of the ranks
along that axis through this rank (one subgroup for each slice along each
named axis, made once per mesh layout, in the same order on every rank):
``batch_isend_irecv`` for the ring shift, ``all_to_all_single``,
``all_reduce``, ``all_gather_into_tensor``, ``send``/``recv``.  Over gloo
the point-to-point calls (the ring shift, ``send``, ``recv``) stage a card
tensor through a host tensor: gloo's point-to-point path reads host memory
only.  Its ``all_to_all_single``, ``all_gather_into_tensor`` and
``all_reduce`` take card tensors (copying them through the host
themselves).  The staged calls are counted in ``axis_stats``.
"""
from __future__ import annotations

import os
import pickle
import socket

import numpy as np
import torch
import torch.distributed as tdist

from ..base import MXNetError
from ..context import cpu as _cpu, gpu
from ..kvstore import KVStore, _csr_band_rows
from ..ndarray import NDArray, sparse
from ..ndarray import ndarray as _nd_mod
from .mesh import Mesh

__all__ = ["init_process", "rank", "num_workers", "barrier",
           "num_dead_nodes", "local_context", "worker_mesh", "RankAxis",
           "rank_dispatch", "DistKVStore"]

_initialized = False
_groups = {}        # "dist_sync" / "dist_device_sync" -> process group


def _active():
    return tdist.is_available() and tdist.is_initialized()


def init_process(coordinator_address=None, num_processes=None,
                 process_id=None):
    """Join the job ``tools/launch.py`` started (ref: the DMLC_ROLE
    bootstrap of tools/launch.py): ``torch.distributed`` over
    ``tcp://<MX_COORDINATOR>``, gloo as its default wire.  Arguments
    override the environment; without a coordinator the process is rank 0
    of 1.  Runs once."""
    global _initialized
    if _initialized:
        return
    addr = coordinator_address or os.environ.get("MX_COORDINATOR")
    n = num_processes or int(os.environ.get("MX_NUM_PROCESSES", "0")) or 1
    pid = process_id if process_id is not None else int(
        os.environ.get("MX_PROCESS_ID", "0"))
    if addr and not _active():
        tdist.init_process_group("gloo", init_method="tcp://" + addr,
                                 world_size=n, rank=pid)
    _initialized = True


def rank():
    """This worker's rank (ref: KVStore::get_rank)."""
    return tdist.get_rank() if _active() else 0


def num_workers():
    """The number of workers (ref: KVStore::get_group_size)."""
    return tdist.get_world_size() if _active() else 1


def barrier():
    """Every worker arrives before any leaves (ref: KVStore::Barrier)."""
    if num_workers() > 1:
        tdist.barrier(group=_group("dist_sync"))


def num_dead_nodes():
    """ref: MXKVStoreGetNumDeadNode.  A collective wire fails the job when
    a member dies, so a live process sees 0."""
    return 0


def local_context():
    """This rank's card: ``gpu(rank % cards)``."""
    return gpu(rank() % max(torch.cuda.device_count(), 1))


def worker_mesh(cpu=False, kvstore="dist_sync", axes=None):
    """The process group as a ``Mesh`` with one device per rank (rank r's
    entry is :func:`local_context` of rank r, at flat position r): 1-D with
    axis ``"worker"`` by default, else the named ``axes`` ({"dp": 1, "sp":
    2}, row-major, their product the number of ranks).  A
    ``DataParallelTrainer`` over it keeps one replica a rank.  ``kvstore``
    names its wire as the stores do: ``"dist_sync"`` gloo,
    ``"dist_device_sync"`` NCCL for card tensors."""
    if kvstore not in ("dist_sync", "dist_device_sync"):
        raise ValueError("worker_mesh: kvstore must be 'dist_sync' or "
                         "'dist_device_sync', got %r" % (kvstore,))
    init_process()
    n = num_workers()
    if axes is None:
        names, sizes = ("worker",), (n,)
    else:
        names = tuple(axes.keys())
        sizes = tuple(int(v) for v in axes.values())
        if int(np.prod(sizes)) != n:
            raise ValueError("worker_mesh: axes %s make %d positions for %d "
                             "ranks" % (dict(axes), int(np.prod(sizes)), n))
    cards = max(torch.cuda.device_count(), 1)
    devs = np.empty(n, dtype=object)
    devs[:] = [_cpu(0) if cpu else gpu(r % cards) for r in range(n)]
    return Mesh(devs.reshape(sizes), names, kvstore=kvstore)


def _group(kind, ranks=None):
    """The process group of a wire, made once (a collective call: every
    rank asks for the same wires in the same order); with ``ranks``, the
    subgroup of those ranks on that wire (every rank makes every
    subgroup, members or not)."""
    if not _active():
        return None                         # one process: no collective
    key = kind if ranks is None else (kind, tuple(ranks))
    if key not in _groups:
        if kind == "dist_device_sync" and torch.cuda.is_available():
            if ranks is None:
                _check_private_cards()
            else:
                _group(kind)                # the cards checked once
            _groups[key] = tdist.new_group(ranks,
                                           backend="cpu:gloo,cuda:nccl")
        elif ranks is None and tdist.get_backend() == "gloo":
            _groups[key] = None             # the default group
        else:
            _groups[key] = tdist.new_group(ranks, backend="gloo")
    return _groups[key]


def _axis_groups(mesh):
    """{(axis, position on the other axes): (subgroup, its ranks in axis
    order)} of a mesh of ranks, every subgroup made once, in the order of
    the axes and, along each, of the other axes' positions (row-major):
    the same order on every rank."""
    key = ("axes", mesh.kvstore, mesh.devices.shape, mesh.axis_names)
    if key not in _groups:
        shape = mesh.devices.shape
        flat = np.arange(mesh.size).reshape(shape)
        table = {}
        for a, name in enumerate(mesh.axis_names):
            other = [s for j, s in enumerate(shape) if j != a]
            for coords in np.ndindex(*other):
                idx = list(coords)
                idx.insert(a, slice(None))
                ranks = [int(r) for r in flat[tuple(idx)]]
                group = _group(mesh.kvstore, ranks) if len(ranks) > 1 \
                    else None
                table[(name, tuple(coords))] = (group, ranks)
        _groups[key] = table
    return _groups[key]


def _check_private_cards():
    """NCCL takes one rank a card: raise ``MXNetError`` naming the ranks
    that share one (every rank sees the same table, so every rank
    raises)."""
    dev = local_context().torch_device()
    props = torch.cuda.get_device_properties(dev)
    card = "%s %s" % (getattr(props, "uuid", "cuda:%d" % dev.index),
                      props.name)
    mine = (socket.gethostname(), card, dev.index)
    table = [None] * num_workers()
    tdist.all_gather_object(table, mine)
    by_card = {}
    for r, (host, name, index) in enumerate(table):
        by_card.setdefault((host, name), []).append((r, index))
    shared = {k: v for k, v in by_card.items() if len(v) > 1}
    if shared:
        (host, name), ranks = sorted(shared.items())[0]
        raise MXNetError(
            "dist_device_sync: ranks %s share the card cuda:%d (%s) on %s, "
            "and NCCL takes one rank a card; give each rank a card of its "
            "own, or use dist_sync (gloo), which several ranks on one card "
            "can share" % ([r for r, _ in ranks], ranks[0][1], name, host))


def _global_sum(flat, group=None):
    """Sum ``flat`` over every rank in place with one ``all_reduce`` and
    return it (ref: kvstore_dist.h's ZPush/ZPull pair as one reduce)."""
    with torch.profiler.record_function("kvstore.all_reduce"):
        tdist.all_reduce(flat, group=group)
    return flat


def allreduce_tensors(tensors, group=None):
    """The sums over every rank of ``tensors``: packed per dtype (in order
    of first appearance) into one flat buffer on the first tensor's device
    of that dtype, each buffer summed by one ``all_reduce``; returns new
    tensors, each on its input's device."""
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idxs in by_dtype.values():
        dev = tensors[idxs[0]].device
        flat = torch.cat([tensors[i].detach().reshape(-1).to(dev)
                          for i in idxs])
        _global_sum(flat, group)
        for i, piece in zip(idxs, flat.split([tensors[i].numel()
                                              for i in idxs])):
            out[i] = piece.view(tensors[i].shape).to(tensors[i].device)
    return out


def broadcast_tensors(tensors, group=None, src=0):
    """Rank ``src``'s values of ``tensors``, in one ``broadcast`` of their
    bytes; returns new tensors, each on its input's device."""
    if not tensors:
        return []
    dev = tensors[0].device
    parts, starts, start = [], [], 0
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8).to(dev)
        pad = -b.numel() % 16       # each piece aligned for its dtype's view
        parts += [b, torch.zeros(pad, dtype=torch.uint8, device=dev)]
        starts.append(start)
        start += b.numel() + pad
    flat = torch.cat(parts)
    with torch.profiler.record_function("kvstore.broadcast"):
        tdist.broadcast(flat, src, group=group)
    return [flat[s:s + t.numel() * t.element_size()].view(t.dtype)
            .view(t.shape).to(t.device) for s, t in zip(starts, tensors)]


# calls of the axis collectives by kind: calls, bytes sent, and calls that
# staged a card tensor through the host (gloo)
axis_stats = {}


def _count(kind, nbytes, staged):
    st = axis_stats.setdefault(kind, {"calls": 0, "bytes": 0, "staged": 0})
    st["calls"] += 1
    st["bytes"] += int(nbytes)
    st["staged"] += int(staged)


class RankAxis(object):
    """This rank's shard of ``axis`` of a mesh of ranks: ``index`` and
    ``size`` along the axis, its Context, and the collectives of
    :mod:`.mesh` on the axis's subgroup through this rank.  A body run by
    :func:`rank_dispatch` calls them; ``all_to_all``, ``psum`` and
    ``all_gather`` are differentiable (their backward is the matching
    collective, every rank of the axis holding the same gradient downstream
    of a sum or a gather), ``ring_shift`` and ``send``/``recv`` move
    values only."""

    def __init__(self, mesh, axis):
        if axis not in mesh.axis_names:
            raise ValueError("mesh %s has no axis %r"
                             % (mesh.axis_names, axis))
        a = mesh.axis_names.index(axis)
        shape = mesh.devices.shape
        coords = np.unravel_index(rank(), shape)
        self.index, self.size = int(coords[a]), int(shape[a])
        other = tuple(int(c) for j, c in enumerate(coords) if j != a)
        self.group, self.ranks = _axis_groups(mesh)[(axis, other)]
        self.ctx = mesh.devices.flat[rank()]
        self.device = self.ctx.torch_device()
        # gloo's point-to-point calls read host memory: card tensors go
        # through a host tensor (NCCL, on dist_device_sync, takes them)
        self._stage = not (mesh.kvstore == "dist_device_sync" and
                           torch.cuda.is_available())

    def _wire(self, t, kind, p2p=False):
        t = t.detach().contiguous()
        staged = p2p and self._stage and t.is_cuda
        _count(kind, t.numel() * t.element_size(), staged)
        return t.cpu() if staged else t

    def _wire_device(self):
        return torch.device("cpu") if self._stage else self.device

    def ring_shift(self, tensors):
        """Each rank's ``tensors`` (one tensor or a sequence) to the next
        rank of the axis (mod size), in one ``batch_isend_irecv``: returns
        what the previous rank held."""
        one = isinstance(tensors, torch.Tensor)
        ts = [tensors] if one else list(tensors)
        if self.size == 1:
            return tensors
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        ops, bufs = [], []
        for t in ts:
            w = self._wire(t, "ring_shift", p2p=True)
            b = torch.empty_like(w)
            ops.append(tdist.P2POp(tdist.isend, w, nxt, self.group))
            ops.append(tdist.P2POp(tdist.irecv, b, prv, self.group))
            bufs.append(b)
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        got = [b.to(t.device) for b, t in zip(bufs, ts)]
        return got[0] if one else got

    def _all_to_all(self, t, split_axis, concat_axis):
        if self.size == 1:
            return t
        n = self.size
        w = self._wire(t.movedim(split_axis, 0), "all_to_all")
        if w.shape[0] % n:
            raise ValueError("dimension %d of %s does not split over %d "
                             "ranks" % (split_axis, tuple(t.shape), n))
        out = torch.empty_like(w)
        tdist.all_to_all_single(out, w, group=self.group)
        pieces = [p.movedim(0, split_axis) for p in out.chunk(n, 0)]
        return torch.cat(pieces, concat_axis)

    def _psum(self, t):
        if self.size == 1:
            return t
        flat = t.detach().clone(memory_format=torch.contiguous_format)
        _count("psum", flat.numel() * flat.element_size(), False)
        tdist.all_reduce(flat, group=self.group)
        return flat

    def _all_gather(self, t, axis):
        if self.size == 1:
            return t
        w = self._wire(t.movedim(axis, 0), "all_gather")
        out = torch.empty((self.size * w.shape[0],) + tuple(w.shape[1:]),
                          dtype=w.dtype, device=w.device)
        tdist.all_gather_into_tensor(out, w, group=self.group)
        return torch.cat([p.movedim(0, axis) for p in out.chunk(self.size)],
                         axis)

    def _own(self, t, axis):
        return t.chunk(self.size, axis)[self.index].contiguous()

    def all_to_all(self, t, split_axis, concat_axis):
        """Tiled all-to-all (``all_to_all_single``): ``t`` split evenly
        along ``split_axis``, piece j to rank j, the pieces received
        concatenated along ``concat_axis`` in rank order."""
        if self.size == 1:
            return t
        return _AllToAll.apply(self, t, split_axis, concat_axis)

    def psum(self, t):
        """The sum over the axis (``all_reduce``)."""
        if self.size == 1:
            return t
        return _Psum.apply(self, t)

    def all_gather(self, t, axis=0):
        """Every rank's ``t`` concatenated along ``axis`` in rank order."""
        if self.size == 1:
            return t
        return _AllGather.apply(self, t, axis)

    def send(self, t, dst):
        """``t`` to the rank at position ``dst`` of the axis."""
        tdist.send(self._wire(t, "send", p2p=True), self.ranks[dst],
                   group=self.group)

    def recv(self, src, shape, dtype):
        """A tensor of ``shape`` and ``dtype`` from the rank at position
        ``src`` of the axis, on this rank's device."""
        buf = torch.empty(shape, dtype=dtype, device=self._wire_device())
        _count("recv", buf.numel() * buf.element_size(), buf.device !=
               self.device)
        tdist.recv(buf, self.ranks[src], group=self.group)
        return buf.to(self.device)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, t, split_axis, concat_axis):
        ctx.ax, ctx.axes = ax, (split_axis, concat_axis)
        return ax._all_to_all(t, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return None, ctx.ax._all_to_all(g, concat_axis, split_axis), None, \
            None


class _Psum(torch.autograd.Function):
    # the sum is replicated: each rank's gradient of it is the whole one
    @staticmethod
    def forward(ctx, ax, t):
        return ax._psum(t)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _AllGather(torch.autograd.Function):
    # the gathered value is replicated: this rank's part of its gradient
    @staticmethod
    def forward(ctx, ax, t, axis):
        ctx.ax, ctx.axis = ax, axis
        return ax._all_gather(t, axis)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ax._own(g, ctx.axis), None


class _Replicated(torch.autograd.Function):
    # a replicated operand enters a body: each rank's gradient is its part
    @staticmethod
    def forward(ctx, ax, t):
        ctx.ax = ax
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ax._psum(g)


class _Scatter(torch.autograd.Function):
    # a replicated operand enters split: the gradients' parts gathered
    @staticmethod
    def forward(ctx, ax, t, axis):
        ctx.ax, ctx.axis = ax, axis
        if t.shape[axis] % ax.size:
            raise ValueError("dimension %d of %s does not split over %d "
                             "ranks" % (axis, tuple(t.shape), ax.size))
        return ax._own(t, axis)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ax._all_gather(g, ctx.axis), None


class _GatherShards(torch.autograd.Function):
    """A parameter kept sharded over an axis, gathered whole for a forward
    every rank of the axis computes alike; its gradient is then the same
    on every rank of the axis, and each keeps its own part."""

    @staticmethod
    def forward(ctx, ax, shard, axis):
        ctx.ax, ctx.axis = ax, axis
        return ax._all_gather(shard, axis)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ax._own(g, ctx.axis), None


def gather_shards(mesh, axis, shard, dim):
    """The whole parameter from this rank's ``shard`` (split along ``dim``
    over ``axis``), differentiably: see :class:`_GatherShards`."""
    return _GatherShards.apply(RankAxis(mesh, axis), shard, dim)


def rank_dispatch(body, mesh, axis, in_specs, out_specs, *arrays):
    """``body(ax, *shards)`` on this rank's shard of ``axis``
    (:func:`.mesh.dispatch_on_mesh` over a mesh of ranks): a replicated
    operand enters whole (its gradient summed over the axis), a sharded
    one as this rank's part (its gradient gathered), a ``"local"`` one as
    given; a result with an int spec is gathered along it, with ``"sum"``
    summed over the axis."""
    ax = RankAxis(mesh, axis)
    args = []
    for a, spec in zip(arrays, in_specs):
        if a is None or spec == "local":
            args.append(a)
        elif spec is None:
            args.append(_Replicated.apply(ax, a) if a.requires_grad and
                        torch.is_grad_enabled() and ax.size > 1 else a)
        else:
            args.append(_Scatter.apply(ax, a, spec))
    outs = body(ax, *args)

    def leave(o, spec):
        if spec is None or spec == "local":
            return o
        if spec == "sum":
            return ax.psum(o)
        return ax.all_gather(o, spec)

    if not isinstance(out_specs, (tuple, list)):
        return leave(outs, out_specs)
    return tuple(leave(o, s) for o, s in zip(outs, out_specs))


_ps_counter = [0]   # the n-th dist_async store of every rank meets the n-th


class DistKVStore(KVStore):
    """``dist_sync``, ``dist_device_sync`` and ``dist_async`` (ref:
    kvstore_dist.h): the sync types over collectives, ``dist_async`` over
    the host parameter service of ``parallel/ps.py``."""

    def __init__(self, type_):
        super().__init__(type_)
        init_process()
        self._group = _group("dist_device_sync" if type_ == "dist_device_sync"
                             else "dist_sync")
        # gloo gathers host tensors only (its all_gather of card tensors is
        # not to be relied on); NCCL gathers card tensors
        self._gather_on_card = type_ == "dist_device_sync" and \
            torch.cuda.is_available()
        self._ps_server = None
        self._ps = None
        if type_ == "dist_async":
            from . import ps
            idx = _ps_counter[0]
            _ps_counter[0] += 1
            n_srv = int(os.environ.get("MXTPU_PS_NUM_SERVERS", "1"))
            if num_workers() <= 1 or rank() == 0:
                self._ps_server = ps.ServerGroup(n_srv)
                if num_workers() > 1:
                    ps.publish_address(self._ps_server.address, idx)
                self._ps = ps.GroupClient(self._ps_server.address, rank=0)
            else:
                self._ps = ps.GroupClient(ps.lookup_address(idx),
                                          rank=rank())

    # -- the synchronous wire ---------------------------------------------
    def init(self, key, value):
        """Rank 0's values define the keys (ref: kvstore_dist.h Init: the
        first value wins on the server), in one broadcast for all of them:
        workers that initialized from other seeds start equal."""
        if self._ps is not None:
            return self._async_init(key, value)
        super().init(key, value)
        if num_workers() > 1:
            keys, _ = self._normalize(key, value)
            vals = broadcast_tensors([self._store[k]._data for k in keys],
                                     self._group)
            for k, v in zip(keys, vals):
                _nd_mod._write(self._store[k]._data, v)

    def _cross_worker_reduce_many(self, reds):
        """The sums over every worker of one push's values, in as few
        collectives as the dtypes allow (one flat buffer each, the
        batching of kvstore_dist.h's big-array sharding); sparse values
        take the union path, in key order."""
        if num_workers() <= 1 or not reds:
            return reds
        out = list(reds)
        dense = []
        for i, r in enumerate(reds):
            if isinstance(r, sparse.BaseSparseNDArray):
                out[i] = self._cross_worker_reduce_sparse(r)
            else:
                dense.append(i)
        sums = allreduce_tensors([reds[i]._data for i in dense], self._group)
        for i, s in zip(dense, sums):
            out[i] = NDArray(s, ctx=reds[i].context)
        return out

    def _cross_worker_reduce_sparse(self, red):
        """A sparse value summed over every worker.  Row-sparse: the ids and
        rows of every rank, padded to the largest count so every rank
        issues collectives of one shape, summed over the union of the ids
        in rank order (ref: kvstore_dist.h PushRowSparse, comm.h
        ReduceRowSparse).  CSR: densified band by band of rows
        (``kvstore._csr_band_rows``), each band summed and compressed
        again."""
        W = num_workers()
        if isinstance(red, sparse.RowSparseNDArray):
            idx, dat = red._canonical_parts()
            home = dat.device
            wire = home if self._gather_on_card else torch.device("cpu")
            count = torch.tensor([idx.numel()], dtype=torch.int64)
            counts = [torch.zeros_like(count) for _ in range(W)]
            tdist.all_gather(counts, count, group=self._group)
            counts = [int(c.item()) for c in counts]
            maxn = max(max(counts), 1)
            row_shape = tuple(dat.shape[1:])
            idx_p = torch.full((maxn,), -1, dtype=torch.int64, device=wire)
            idx_p[:idx.numel()] = idx.to(wire)
            dat_p = torch.zeros((maxn,) + row_shape, dtype=dat.dtype,
                                device=wire)
            dat_p[:idx.numel()] = dat.to(wire)
            all_i = [torch.empty_like(idx_p) for _ in range(W)]
            all_d = [torch.empty_like(dat_p) for _ in range(W)]
            tdist.all_gather(all_i, idx_p, group=self._group)
            tdist.all_gather(all_d, dat_p, group=self._group)
            uniq = torch.unique(torch.cat([i[:n] for i, n in
                                           zip(all_i, counts)]))
            summed = torch.zeros((uniq.numel(),) + row_shape, dtype=dat.dtype,
                                 device=wire)
            for ids, rows, n in zip(all_i, all_d, counts):
                summed.index_add_(0, torch.searchsorted(uniq, ids[:n]),
                                  rows[:n])
            return sparse._rsp_of_rows(
                summed.to(home), uniq.to(red.indices._data.dtype).to(home),
                red.shape, red.context)
        nrows, ncols = red.shape
        band = _csr_band_rows(red.shape, red.data._data.element_size())
        rows, cols, vals = [], [], []
        for r0 in range(0, nrows, band):
            r1 = min(r0 + band, nrows)
            dense = red[r0:r1]._dense().contiguous()
            _global_sum(dense.view(-1), self._group)
            r, c = sparse._nonzero_2d(dense)
            rows.append(r + r0)
            cols.append(c)
            vals.append(dense[r, c])
        return sparse._csr_of(torch.cat(rows), torch.cat(cols),
                              torch.cat(vals), (nrows, ncols), red.context)

    def _sync_set_optimizer(self, optimizer):
        """A copy of the optimizer, through a pickle round-trip, as the
        reference ships it to its servers (kvstore.py set_optimizer); the
        update runs on this rank's copy of the store."""
        from .. import optimizer as opt
        self._updater = opt.get_updater(pickle.loads(pickle.dumps(optimizer)))

    def set_optimizer(self, optimizer):
        if self._ps is None:
            return self._sync_set_optimizer(optimizer)
        self._ps.set_optimizer(optimizer)   # pickled to the server

    def num_dead_nodes(self, node_id=0, timeout_sec=5):
        """Workers whose heartbeats stopped (ref: kvstore_dist.h:109-115):
        kept by the parameter service; the collective wire fails the job
        on a death, so 0 there."""
        if self._ps is None:
            return 0
        return len(self._ps.dead_nodes(window=float(timeout_sec)))

    # -- dist_async: the host parameter service ---------------------------
    def _async_init(self, key, value):
        super().init(key, value)            # the local mirror
        keys, values = self._normalize(key, value)
        self._ps.init({k: v[0].asnumpy() for k, v in zip(keys, values)})
        barrier()   # every rank sees the keys before the first push

    def push(self, key, value, priority=0):
        if self._ps is None:
            return super().push(key, value, priority)
        keys, values = self._normalize(key, value)
        batch = {}
        for k, vlist in zip(keys, values):
            if k not in self._store:
                raise MXNetError("key %s has not been initialized" % k)
            batch[k] = self._reduce(vlist).asnumpy()
        self._ps.push(batch)                # applied on the server at once

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if self._ps is None:
            return super().pull(key, out=out, priority=priority,
                                ignore_sparse=ignore_sparse)
        if out is None:
            raise ValueError("pull needs out arrays")
        keys, outs = self._normalize(key, out)
        fetched = self._ps.pull(keys)
        for k, olist in zip(keys, outs):
            self._refresh(k, fetched[k])
            val = self._store[k]._data
            for o in olist:
                _nd_mod._writable(o)
                _nd_mod._write(o._data, val)

    def _refresh(self, k, value):
        """The local mirror takes the server's value (row_sparse_pull reads
        the mirror)."""
        dst = self._store[k]._data
        _nd_mod._write(dst, torch.from_numpy(np.ascontiguousarray(value)))

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        if self._ps is None:
            return super().row_sparse_pull(key, out=out, priority=priority,
                                           row_ids=row_ids)
        keys, _ = self._normalize(key, out)
        if row_ids is not None:
            # ship only the rows asked for (kvstore_dist_server.h:223) and
            # scatter them into the mirror
            id_list = row_ids if isinstance(row_ids, (list, tuple)) \
                else [row_ids] * len(keys)
            for k, ids_nd in zip(keys, id_list):
                ids = np.unique(np.asarray(
                    ids_nd.asnumpy() if isinstance(ids_nd, NDArray)
                    else ids_nd).astype(np.int64).ravel())
                if not ids.size:
                    continue
                rows = self._ps.pull_rows({k: ids})[k]
                dst = self._store[k]._data
                with torch.no_grad():
                    dst.index_copy_(0, torch.from_numpy(ids).to(dst.device),
                                    torch.from_numpy(np.ascontiguousarray(
                                        rows)).to(dst.device, dst.dtype))
        return super().row_sparse_pull(key, out=out, priority=priority,
                                       row_ids=row_ids)

    def close(self):
        """Close the parameter service's client and, on the rank that hosts
        it, its servers."""
        if self._ps is not None:
            self._ps.close()
            self._ps = None
        if self._ps_server is not None:
            self._ps_server.shutdown()
            self._ps_server = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass                # interpreter teardown
