"""DataParallelTrainer: the whole training step of a Gluon HybridBlock.

Counterpart of ``incubator_mxnet_tpu/parallel/data_parallel.py``
(``pure_optimizer`` :55, ``DataParallelTrainer`` :110).  The JAX build jits
forward, loss, backward and optimizer update into one XLA program over a
mesh; the port runs the same step eagerly in torch:

* the trainer keeps its own f32 master copy of every parameter and the
  optimizer state beside it, on the device, and updates both in place
  (the role of the JAX build's donated buffers); ``sync_params()`` writes
  the weights back into the Block;
* with ``dtype`` (``"bfloat16"``) trainable f32 weights are cast to it
  inside the recorded graph, so their gradients arrive in f32; frozen
  values are never cast; f32 and narrow-integer inputs are cast, int32 and
  int64 inputs (token ids) never are; the output is cast to f32 before the
  loss (the rules of :210-234);
* the loss is the mean of the loss block's per-sample values;
* layer state that the forward writes (BatchNorm's running statistics,
  parameters with ``grad_req='null'``) lands in the f32 master copies once
  a step and is never cast: the forward runs on the master tensors
  themselves, and a shadow the forward rebound is copied back (the JAX
  step's ``aux``, :244, :261-263); ``sync_params()`` writes it into the
  Block with the weights.

Over several devices (the JAX build's ``"dp"`` mesh, :110-409):

* a ``"dp"`` mesh of this process's contexts keeps one replica (master
  weights and optimizer state) per device of the axis; the batch splits along its
  first axis into equal shards, one a replica, each replica's loss is its
  shard's mean over the number of shards, and the gradients are summed
  in device order on the first device (the JAX build's ``psum``), so
  every replica takes the same update from the same sum;
* ``dist.worker_mesh()`` (or no mesh, in a job of several processes)
  keeps one replica a rank: rank 0's weights are broadcast at the first
  step, each rank feeds its own shard of the global batch (all of one
  size), and the gradients and the loss travel as one flat buffer per
  dtype through one ``all_reduce`` a step, on the mesh's wire;
* layer state the forward writes (BatchNorm's running statistics) stays
  per replica, as MXNet keeps it per device (the JAX build's one program
  computes it over the global batch); ``sync_params()`` writes the mean
  of the replicas' into the Block.

Meshes of ``"dp"`` and other axes (the JAX build's :158-200, :268-290):

* the batch splits over ``"dp"`` only (one replica a ``"dp"`` position;
  a mesh without the axis keeps one replica), and the gradients are summed
  over ``"dp"`` only: over the other axes every shard already holds the
  same (replicated) or its own (sharded) gradient;
* a parameter whose ``Parameter.sharding`` names an axis of the mesh keeps
  its master weights and optimizer state split along that dimension: over
  this process's Contexts one shard on each device along the axis in the
  replica's row, over ranks this rank's shard only;
* a parameter a layer computes shard-wise (``Parameter.shardwise``:
  ``ExpertParallelMoE``'s experts) reaches the forward as this rank's shard
  over ranks; any other split parameter (``"tp"``) is gathered whole for the
  forward and each shard keeps its part of the gradient (every rank of
  the axis computes the same whole gradient).  Eager
  torch has no GSPMD to partition arbitrary ops over ``"tp"``: the forward
  computes the whole product on every shard, the same numbers as the JAX
  build's partitioned step;
* mesh-aware layers (``MultiHeadAttention(seq_axis=...)``, capacity MoE)
  run their collectives on their own axis of the trainer's mesh, which the
  step scopes;
* over a mesh of ranks with such an axis, the ranks along it hold
  replicated weights that no all-reduce brings back into line (the JAX
  build keeps one logical copy): the step runs under torch's deterministic
  algorithms, so every rank computes the same bits from the same inputs,
  and an op without a deterministic form raises.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..ndarray import NDArray
from ..ops.registry import get_op
from .. import autograd
from . import dist
from .mesh import use_mesh, axis_devices

__all__ = ["DataParallelTrainer", "pure_optimizer"]

# inputs the compute dtype casts besides float32 (image pipelines); wider
# integers are indices and stay exact
_NARROW_INTS = tuple(getattr(torch, n) for n in ("uint8", "int8", "uint16",
                                                 "int16") if hasattr(torch, n))


def pure_optimizer(name, **hyper):
    """(init_state, update) built from the update operators of
    ``ops/optimizer_ops.py`` (the same formulas the eager Optimizer uses):
    ``init(w)`` returns a tuple of state tensors, ``update(w, g, state,
    lr)`` the new weight and the new state tuple."""
    name = name.lower()
    common = dict(wd=hyper.get("wd", 0.0),
                  rescale_grad=hyper.get("rescale_grad", 1.0),
                  clip_gradient=hyper.get("clip_gradient", -1.0))
    if name == "sgd":
        momentum = hyper.get("momentum", 0.0)
        if momentum:
            op = get_op("sgd_mom_update").fcompute

            def init(w):
                return (torch.zeros_like(w),)

            def update(w, g, state, lr):
                new_w, new_mom = op(w, g, state[0], lr=lr, momentum=momentum,
                                    **common)
                return new_w, (new_mom,)
        else:
            op = get_op("sgd_update").fcompute

            def init(w):
                return ()

            def update(w, g, state, lr):
                return op(w, g, lr=lr, **common), ()
        return init, update
    if name == "adam":
        op = get_op("adam_update").fcompute
        b1 = hyper.get("beta1", 0.9)
        b2 = hyper.get("beta2", 0.999)

        def init(w):
            return (torch.zeros_like(w), torch.zeros_like(w),
                    torch.zeros((), dtype=torch.int32, device=w.device))

        def update(w, g, state, lr):
            mean, var, t = state
            t = t + 1
            tf = t.to(torch.float32)
            # the bias correction in f32 on the device, as the JAX step
            lr_t = lr * torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
            new_w, new_mean, new_var = op(
                w, g, mean, var, lr=lr_t, beta1=b1, beta2=b2,
                epsilon=hyper.get("epsilon", 1e-8), **common)
            return new_w, (new_mean, new_var, t)
        return init, update
    raise ValueError("pure_optimizer: unsupported optimizer %r (sgd and adam "
                     "cover the trainer's step; others run through the "
                     "eager Trainer)" % name)


@contextlib.contextmanager
def _deterministic(on):
    """torch's deterministic algorithms (cuBLAS's and cuDNN's among them)
    inside, when ``on``."""
    if not on:
        yield
        return
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic,
              os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic = before[2]
        if before[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


class _Replica(object):
    """One device's copy: its context, master weights and optimizer
    state."""

    __slots__ = ("ctx", "params", "opt_state")

    def __init__(self, ctx, params, opt_state):
        self.ctx, self.params, self.opt_state = ctx, params, opt_state


class DataParallelTrainer(object):
    """The data-parallel trainer of a Gluon HybridBlock."""

    def __init__(self, block, loss, optimizer="sgd", optimizer_params=None,
                 mesh=None, donate=True, dtype=None):
        """``dtype='bfloat16'`` is mixed precision: the master weights and
        the optimizer stay in f32; weights and inputs are cast to bf16
        inside the recorded step and the loss is computed in f32.
        ``donate`` is accepted for parity: the port always updates its
        copies in place."""
        self.block = block
        self.loss = loss
        self.mesh = mesh
        optimizer_params = dict(optimizer_params or {})
        self._lr = optimizer_params.pop("learning_rate", 0.01)
        self._opt_init, self._opt_update = pure_optimizer(optimizer,
                                                          **optimizer_params)
        self._compute_dtype = torch_dtype(dtype) if dtype is not None \
            else None
        self._replicas = None     # one _Replica per local device
        self._group = None        # the process group of a mesh of ranks
        self._world = 1           # ranks that feed shards of the batch
        self._trainable = None
        self._split = {}          # name -> (mesh axis, dimension)
        self._same_bits = False   # ranks replicate weights over an axis

    # -- parameter plumbing ------------------------------------------------
    @property
    def _params(self):
        """name -> the first replica's master tensor."""
        return self._replicas[0].params if self._replicas else None

    @property
    def _opt_state(self):
        return self._replicas[0].opt_state if self._replicas else None

    def _replica_contexts(self):
        """(contexts of the replicas, the wire of a mesh of ranks or
        None): one replica a ``"dp"`` position of a mesh of Contexts (the
        first position of every other axis), this rank's device over
        ranks."""
        mesh = self.mesh
        first = next(iter(self.block.collect_params().values()))
        if mesh is None and dist.num_workers() > 1:
            # a job of several processes: one replica a rank, on the
            # block's own device (the JAX build's default mesh spans them)
            return [first.list_ctx()[0]], "dist_sync"
        if mesh is not None and mesh.kvstore is not None:
            return [mesh.devices.flat[dist.rank()]], mesh.kvstore
        if mesh is None:
            return [first.list_ctx()[0]], None
        if "dp" not in mesh.axis_names:
            return [mesh.devices.flat[0]], None
        a = mesh.axis_names.index("dp")
        idx = [0] * mesh.devices.ndim
        ctxs = []
        for i in range(mesh.devices.shape[a]):
            idx[a] = i
            ctxs.append(mesh.devices[tuple(idx)])
        return ctxs, None

    def _splits(self, blk_params):
        """name -> (axis, dimension) of every parameter split over an axis
        of the mesh of size > 1."""
        split = {}
        for name, p in blk_params.items():
            sharding = getattr(p, "sharding", None) or ()
            axes = [(a, d) for d, a in enumerate(sharding)
                    if a is not None and self.mesh is not None and
                    self.mesh.axis_size(a) > 1 and a in self.mesh.axis_names]
            if len(axes) > 1:
                raise MXNetError("parameter %s splits over several axes %s; "
                                 "the trainer splits a parameter over one"
                                 % (name, axes))
            if axes:
                split[name] = axes[0]
        return split

    def _shards(self, name, v, ctx):
        """A split parameter's master copy for the replica on ``ctx``: a
        tuple of shards, one on each device along its axis in the
        replica's row (a mesh of Contexts), or this rank's shard."""
        axis, dim = self._split[name]
        n = self.mesh.axis_size(axis)
        if self.mesh.kvstore is not None:
            me = dist.RankAxis(self.mesh, axis).index
            return v.chunk(n, dim)[me].to(ctx.torch_device(), copy=True)
        devs = axis_devices(self.mesh, axis, ctx)
        return tuple(piece.to(d.torch_device(), copy=True)
                     for piece, d in zip(v.chunk(n, dim), devs))

    def _gather_params(self, example_x):
        blk_params = self.block.collect_params()
        first = next(iter(blk_params.values()))
        ctxs, kind = self._replica_contexts()
        if any(p._data is None and p._deferred_init
               for p in blk_params.values()):
            # resolve deferred shapes with one pass over the example, on the
            # parameters' own device; ids enter that pass as floats
            ex = example_x if example_x.is_floating_point() \
                else example_x.to(torch.float32)
            ex = ex.to(first.list_ctx()[0].torch_device())
            self.block._run_deferred_init(NDArray(ex))
        names = list(blk_params.keys())
        vals = [blk_params[n].data()._data.detach() for n in names]
        if kind is not None:
            mesh = self.mesh
            if mesh is None or mesh.axis_names == ("worker",):
                self._group = dist._group(kind)
                self._world = dist.num_workers()
            else:
                self._world = mesh.axis_size("dp")
                if self._world > 1:
                    self._group = dist.RankAxis(mesh, "dp").group
            if dist.num_workers() > 1:
                # rank 0's initialization wins (kvstore_dist.h Init), in
                # one broadcast for every parameter
                vals = dist.broadcast_tensors(
                    [v.to(ctxs[0].torch_device()) for v in vals],
                    dist._group(kind))
        self._split = self._splits(blk_params)
        self._same_bits = kind is not None and self.mesh is not None and any(
            a != "dp" and self.mesh.axis_size(a) > 1
            for a in self.mesh.axis_names)
        self._trainable = [n for n, p in blk_params.items()
                           if p.grad_req != "null"]
        self._replicas = []
        for ctx in ctxs:
            dev = ctx.torch_device()
            params = {n: self._shards(n, v, ctx) if n in self._split else
                      v.to(dev, copy=True) for n, v in zip(names, vals)}
            opt = {}
            for n in self._trainable:
                w = params[n]
                opt[n] = tuple(self._opt_init(s) for s in w) \
                    if isinstance(w, tuple) else self._opt_init(w)
            self._replicas.append(_Replica(ctx, params, opt))

    def _whole(self, name, v):
        """A parameter's whole value from a replica's master copy (a
        collective over ranks)."""
        if name not in self._split:
            return v
        axis, dim = self._split[name]
        if isinstance(v, tuple):
            return torch.cat([s.to(v[0].device) for s in v], dim)
        return dist.RankAxis(self.mesh, axis).all_gather(v, dim)

    def sync_params(self):
        """Write the trainer's weights back into the Block: the first
        replica's trainable weights (every replica holds the same; split
        ones gathered whole, a collective over ranks), the mean over the
        replicas of the layer state the forward writes."""
        blk_params = self.block.collect_params()
        with torch.no_grad():
            for name, v in self._params.items():
                v = self._whole(name, v)
                if name not in self._trainable and len(self._replicas) > 1 \
                        and v.is_floating_point() and name not in self._split:
                    acc = v.to(torch.float64)
                    for rep in self._replicas[1:]:
                        acc = acc + rep.params[name].to(acc.device,
                                                        torch.float64)
                    v = (acc / len(self._replicas)).to(v.dtype)
                for arr in blk_params[name].list_data():
                    arr._data.copy_(v)

    # -- the step ----------------------------------------------------------
    def _slots(self):
        """(name, shard index or None) of every trainable tensor the
        optimizer updates, in order."""
        rep = self._replicas[0]
        return [(n, j) for n in self._trainable
                for j in (range(len(rep.params[n]))
                          if isinstance(rep.params[n], tuple) else [None])]

    def _forward_value(self, name, w, ctx):
        """The value a parameter enters the forward with, from the
        replica's master copy ``w`` (leaves when trainable)."""
        if name not in self._split:
            return w
        axis, dim = self._split[name]
        if isinstance(w, tuple):
            dev = ctx.torch_device()
            return torch.cat([s.to(dev) for s in w], dim)
        if self.block.collect_params()[name].shardwise:
            return w
        return dist.gather_shards(self.mesh, axis, w, dim)

    def _loss_and_grads(self, rep, x, y, share):
        """The replica's loss on its shard (the mean of its per-sample
        values times ``share``, its part of the global batch) and its
        gradients, in :meth:`_slots` order."""
        cdt = self._compute_dtype
        ctx = rep.ctx
        leaves = {}
        for n in self._trainable:
            w = rep.params[n]
            leaves[n] = tuple(s.detach().requires_grad_() for s in w) \
                if isinstance(w, tuple) else w.detach().requires_grad_()
        with torch.enable_grad():
            # frozen values enter as the master tensors, uncast, so a layer's
            # in-place write (BatchNorm's running stats) is their update
            vals = {n: self._forward_value(n, v, ctx)
                    for n, v in rep.params.items() if n not in leaves}
            whole = {n: self._forward_value(n, w, ctx)
                     for n, w in leaves.items()}
            if cdt is not None:
                # only trainable f32 weights are cast, inside the graph, so
                # their gradients come back in f32
                vals.update({n: w.to(cdt) if w.dtype == torch.float32 else w
                             for n, w in whole.items()})
                if x.dtype == torch.float32 or x.dtype in _NARROW_INTS:
                    x = x.to(cdt)
            else:
                vals.update(whole)
                if not x.is_floating_point():
                    x = x.to(torch.float32)
            shadows = {n: NDArray(v, ctx=ctx) for n, v in vals.items()}
            with autograd._scope(recording=True, training=True):
                with self.block._trace_params(shadows):
                    out = self.block.hybrid_forward_dispatch(
                        NDArray(x, ctx=ctx))
                if cdt is not None:
                    out = out.astype("float32")
                per_sample = self.loss(out, NDArray(y, ctx=ctx))
            loss = per_sample._data.mean()
            if share != 1:
                loss = loss * share
        with torch.no_grad():
            for n, v in vals.items():
                if n not in leaves and n not in self._split and \
                        shadows[n]._data is not v:
                    v.copy_(shadows[n]._data)
        flat = [leaves[n] if j is None else leaves[n][j]
                for n, j in self._slots()]
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(flat, grads)]

    def step(self, data, label):
        """One training step on (``data``, ``label``), this process's part
        of the global batch; returns the loss over the global batch, an
        f32 scalar NDArray on the first replica's device."""
        x = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(np.asarray(data))
        y = label._data if isinstance(label, NDArray) else \
            torch.as_tensor(np.asarray(label))
        if self.mesh is None:
            return self._step(x, y)
        # the trainer's mesh is the scoped one (parallel.current_mesh) while
        # the step runs, as in the JAX build
        with use_mesh(self.mesh):
            return self._step(x, y)

    def _step(self, x, y):
        if self._replicas is None:
            self._gather_params(x)
        with _deterministic(self._same_bits):
            return self._step_replicas(x, y)

    def _step_replicas(self, x, y):
        reps = self._replicas
        if x.shape[0] % len(reps):
            raise ValueError("a batch of %d does not split evenly over %d "
                             "devices" % (x.shape[0], len(reps)))
        share = 1.0 / (len(reps) * self._world)
        xs, ys = x.chunk(len(reps)), y.chunk(len(reps))
        # named spans, so a profile can attribute the step's kernels
        with torch.profiler.record_function("DataParallelTrainer.forward_"
                                            "backward"):
            loss, grads = None, None
            for rep, xr, yr in zip(reps, xs, ys):
                dev = rep.ctx.torch_device()
                lr_, gr = self._loss_and_grads(rep, xr.to(dev), yr.to(dev),
                                               share)
                if grads is None:
                    loss, grads = lr_, gr
                else:
                    # the psum over local devices, in device order
                    loss = loss + lr_.to(loss.device)
                    grads = [a + b.to(a.device) for a, b in zip(grads, gr)]
        if self._world > 1:
            with torch.profiler.record_function("DataParallelTrainer."
                                                "all_reduce"):
                sums = dist.allreduce_tensors(grads + [loss.reshape(1)],
                                              self._group)
                grads = None
                loss, grads = sums[-1][0], sums[:-1]
        with torch.profiler.record_function("DataParallelTrainer.update"), \
                torch.no_grad():
            for i, (n, j) in enumerate(self._slots()):
                g, grads[i] = grads[i], None   # freed once it is applied
                for rep in reps:
                    w, state = rep.params[n], rep.opt_state[n]
                    if j is not None:
                        w, state = w[j], state[j]
                    new_w, new_state = self._opt_update(
                        w, g.to(w.device), state, self._lr)
                    w.copy_(new_w)
                    for s, ns in zip(state, new_state):
                        s.copy_(ns)
        return NDArray(loss, ctx=reps[0].ctx)

    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = lr
