"""Device meshes (counterpart of ``incubator_mxnet_tpu/parallel/mesh.py``).

A mesh names the axes of a grid of devices ({"dp": 2, "sp": 4}); here its
devices are the port's Contexts.  Axis names follow the JAX build's:
``"dp"`` data, ``"tp"`` tensor, ``"pp"`` pipeline, ``"sp"`` sequence and
``"ep"`` expert parallelism.  A mesh is one of two kinds:

* a mesh of this process's Contexts (``make_mesh``): the counterpart of the
  JAX tests' virtual mesh (``cpu(0..7)`` share torch's one CPU device);
* a mesh of ranks (``dist.worker_mesh``), one device a rank, over
  ``torch.distributed``; its ``kvstore`` names the wire.

``use_mesh`` scopes a mesh as the default of the code inside it.  The JAX
build writes its parallel modules as one SPMD body under ``shard_map``; the
port writes each body once, per shard, over an *axis handle* whose
collectives are the counterparts of ``lax.ppermute`` (``ring_shift``, the
ring ``i -> i+1``), ``lax.all_to_all`` (tiled), ``lax.psum`` and
``all_gather``, plus ``send``/``recv`` for pipeline hops.
:func:`dispatch_on_mesh` runs a body over one axis of either kind of mesh:

* over this process's Contexts each shard runs in a thread of its own
  (:class:`LocalAxis`), and a collective moves each shard to its
  neighbour's Context (``.to(ctx)``), plain differentiable torch ops: the
  shards build one autograd graph, differentiated once by the caller;
* over ranks this rank runs its own shard (``dist.RankAxis``), and a
  collective is a ``torch.distributed`` call on the subgroup of that axis,
  inside autograd Functions whose backward is the matching collective.

Specs say how an operand enters a body and how a result leaves it:
``None`` replicated, an int sharded (split evenly) along that dimension,
``"local"`` already split (a sequence of one tensor a shard over Contexts,
this rank's shard over ranks); a result with ``"sum"`` is summed over the
axis.  Over ranks every rank of the axis computes the same thing outside a
body, so a replicated operand's gradient is summed over the axis, a sharded
one's gathered, and a gathered or summed result's gradient is taken as it
comes (each rank holds the same).
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..context import Context, current_context, gpu

__all__ = ["Mesh", "make_mesh", "data_parallel_mesh", "use_mesh",
           "current_mesh", "axis_devices", "LocalAxis", "dispatch_on_mesh",
           "gather_home"]


class Mesh(object):
    """Named axes over an array of Contexts (the role of jax's Mesh).
    ``kvstore`` marks a mesh of processes (``dist.worker_mesh``, rank r at
    flat position r) and names its wire; a mesh of one process's devices
    has none."""

    def __init__(self, devices, axis_names, kvstore=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        self.kvstore = kvstore
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("mesh of shape %s needs %d axis names, got %s"
                             % (self.devices.shape, self.devices.ndim,
                                self.axis_names))

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def axis_size(self, axis):
        """The size of ``axis`` (1 for an axis the mesh does not have)."""
        return self.shape.get(axis, 1)

    def __repr__(self):
        return "Mesh(%s, %s%s)" % (self.shape, list(self.devices.flat),
                                   ", kvstore=%r" % self.kvstore
                                   if self.kvstore else "")


_mesh_tls = threading.local()


def _stack():
    # per thread: concurrent trainers must not see each other's scope
    if not hasattr(_mesh_tls, "stack"):
        _mesh_tls.stack = []
    return _mesh_tls.stack


class use_mesh(object):
    """Scope ``mesh`` as the default mesh of the code inside (a context
    manager), or for the rest of the thread (``activate()``)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _stack().append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _stack().pop()

    def activate(self):
        _stack().append(self.mesh)
        return self.mesh


def current_mesh(required=False):
    """The innermost scoped mesh, or None (raise when ``required``)."""
    if _stack():
        return _stack()[-1]
    if required:
        raise RuntimeError(
            "no device mesh in scope: wrap the call in "
            "`with parallel.use_mesh(make_mesh({...})):` or pass mesh=")
    return None


def _all_devices():
    """Every device of the current context's type: each card for a card
    context (``gpu(0)`` when none is visible, which raises where used), the
    current context for the CPU, whose contexts are one torch device."""
    ctx = current_context()
    if ctx.device_type != "gpu":
        return [ctx]
    return [gpu(i) for i in range(max(torch.cuda.device_count(), 1))]


def make_mesh(axis_sizes, devices=None):
    """A Mesh from {"dp": 4, ...}, row-major over ``devices`` (default:
    every device of the current context's type)."""
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(v) for v in axis_sizes.values())
    devices = _all_devices() if devices is None else list(devices)
    for dev in devices:
        if not isinstance(dev, Context):
            raise TypeError("mesh devices are Contexts, got %r" % (dev,))
    n = int(np.prod(sizes))
    if len(devices) < n:
        raise ValueError("mesh needs %d devices, have %d" % (n, len(devices)))
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(sizes), names)


def data_parallel_mesh(num_devices=None, devices=None):
    """A 1-D ``"dp"`` mesh over ``devices`` (default: every device of the
    current context's type), or their first ``num_devices``."""
    devices = _all_devices() if devices is None else list(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    return make_mesh({"dp": len(devices)}, devices)


def _axis_of(mesh, axis):
    if axis not in mesh.axis_names:
        raise ValueError("mesh %s has no axis %r" % (mesh.axis_names, axis))
    return mesh.axis_names.index(axis)


def axis_devices(mesh, axis, where=None):
    """The Contexts along ``axis`` of a mesh of this process's devices, in
    the row through the first position whose device is ``where`` (a
    Context or a torch device; default, and when none matches: the first
    row)."""
    a = _axis_of(mesh, axis)
    coords = (0,) * mesh.devices.ndim
    if where is not None:
        match = (lambda c: c == where) if isinstance(where, Context) else \
            (lambda c: c.torch_device() == torch.device(where))
        for pos in np.ndindex(mesh.devices.shape):
            if match(mesh.devices[pos]):
                coords = pos
                break
    index = list(coords)
    index[a] = slice(None)
    return list(mesh.devices[tuple(index)])


class _LocalGroup(object):
    """The meeting point of one axis's shards in this process, one thread
    a shard: a collective leaves each shard's value in its slot, waits for
    every shard, reads the slots and waits again before the slots are
    reused; ``send``/``recv`` go through one queue per ordered pair."""

    def __init__(self, n):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)
        self.mail = {}
        self.lock = threading.Lock()
        self.failed = False

    def exchange(self, i, value):
        self.slots[i] = value
        self.barrier.wait()
        vals = list(self.slots)
        self.barrier.wait()
        return vals

    def box(self, src, dst):
        with self.lock:
            return self.mail.setdefault((src, dst), queue.Queue())

    def abort(self):
        self.failed = True
        self.barrier.abort()


class LocalAxis(object):
    """Shard ``index`` of an axis of this process's devices (the body runs
    in one thread a shard).  Collectives are torch ops between the shards'
    Contexts, differentiable, in shard order."""

    def __init__(self, group, index, devices):
        self._group = group
        self.index = index
        self.size = group.n
        self.devices = devices
        self.ctx = devices[index]
        self.device = self.ctx.torch_device()

    def _here(self, t):
        return t.to(self.device)

    def ring_shift(self, tensors):
        """Each shard's ``tensors`` (one tensor or a sequence) to shard
        ``index + 1`` (mod size): returns what shard ``index - 1`` held."""
        one = isinstance(tensors, torch.Tensor)
        vals = self._group.exchange(self.index, [tensors] if one
                                    else list(tensors))
        got = [self._here(t) for t in vals[(self.index - 1) % self.size]]
        return got[0] if one else got

    def all_to_all(self, t, split_axis, concat_axis):
        """Tiled all-to-all: every shard splits ``t`` evenly along
        ``split_axis`` and sends piece j to shard j; the pieces received
        are concatenated along ``concat_axis`` in shard order."""
        vals = self._group.exchange(self.index, t)
        return torch.cat([self._here(v.chunk(self.size, split_axis)[
            self.index]) for v in vals], concat_axis)

    def psum(self, t):
        """The sum over the axis, added in shard order (every shard gets
        the same bits)."""
        vals = self._group.exchange(self.index, t)
        total = self._here(vals[0])
        for v in vals[1:]:
            total = total + self._here(v)
        return total

    def all_gather(self, t, axis=0):
        """Every shard's ``t`` concatenated along ``axis`` in shard
        order."""
        vals = self._group.exchange(self.index, t)
        return torch.cat([self._here(v) for v in vals], axis)

    def send(self, t, dst):
        """``t`` to shard ``dst`` (its :meth:`recv` from this shard)."""
        self._group.box(self.index, dst).put(t)

    def recv(self, src, shape=None, dtype=None):
        """The next tensor shard ``src`` sent here (``shape`` and
        ``dtype`` are what a rank needs to receive into)."""
        box = self._group.box(src, self.index)
        while True:
            try:
                return self._here(box.get(timeout=0.05))
            except queue.Empty:
                if self._group.failed:
                    raise RuntimeError("a shard of the axis failed")


def _run_local(body, devices):
    """``body(ax)`` for every shard of ``devices``, one thread each (a
    single shard in the caller's thread), with the caller's grad mode,
    recording and training flags and mesh scope; returns the results in
    shard order, or raises the first shard's error."""
    from .. import autograd
    n = len(devices)
    group = _LocalGroup(n)
    grad = torch.is_grad_enabled()
    recording, training = autograd.is_recording(), autograd.is_training()
    meshes = list(_stack())
    results, errors = [None] * n, [None] * n

    def run(i):
        try:
            torch.set_grad_enabled(grad)
            _stack()[:] = meshes
            with autograd._scope(recording=recording, training=training), \
                    devices[i]:
                results[i] = body(LocalAxis(group, i, devices))
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors[i] = e
            group.abort()

    if n == 1:
        with devices[0]:
            return [body(LocalAxis(group, 0, devices))]
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None and
                  not isinstance(e, threading.BrokenBarrierError)), None)
    first = first or next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results


def _enter_local(x, spec, i, n, device):
    if spec is None:
        return x.to(device)
    if spec == "local":
        return x[i].to(device)
    if x.shape[spec] % n:
        raise ValueError("dimension %d of %s does not split over %d shards"
                         % (spec, tuple(x.shape), n))
    return x.chunk(n, spec)[i].to(device)


def _leave_local(outs, spec, home):
    if spec == "local":
        return list(outs)
    if spec is None:
        return outs[0].to(home)
    if spec == "sum":
        total = outs[0].to(home)
        for o in outs[1:]:
            total = total + o.to(home)
        return total
    return torch.cat([o.to(home) for o in outs], spec)


def dispatch_on_mesh(body, mesh, axis, in_specs, out_specs, *arrays,
                     home=None):
    """``body(ax, *shards)`` over ``axis`` of ``mesh``, the counterpart of
    ``shard_map`` with the JAX build's ``dispatch_on_mesh`` placement and
    ``gather_home``: each array enters by its spec (``in_specs``), each
    result leaves by its (``out_specs``; a single spec for a body that
    returns one tensor).  Over this process's Contexts the shards run on
    the axis's devices in the row of ``home`` (default: the first array's
    device), and results come back to ``home``; over ranks this rank runs
    its shard."""
    if mesh.kvstore is not None:
        from . import dist
        return dist.rank_dispatch(body, mesh, axis, in_specs, out_specs,
                                  *arrays)
    first = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    home = torch.device(home) if home is not None else (
        first.device if first is not None else
        mesh.devices.flat[0].torch_device())
    devices = axis_devices(mesh, axis, home)
    n = len(devices)

    def shard(ax):
        args = [_enter_local(a, s, ax.index, n, ax.device)
                if a is not None else None
                for a, s in zip(arrays, in_specs)]
        return body(ax, *args)

    outs = _run_local(shard, devices)
    if not isinstance(out_specs, (tuple, list)):
        return _leave_local(outs, out_specs, home)
    return tuple(_leave_local([o[j] for o in outs], s, home)
                 for j, s in enumerate(out_specs))


def gather_home(x, where):
    """``x`` on ``where`` (a Context, a torch device, or a mesh: its first
    device), differentiably."""
    if isinstance(where, Mesh):
        where = where.devices.flat[0]
    dev = where.torch_device() if isinstance(where, Context) else where
    return x.to(dev)
