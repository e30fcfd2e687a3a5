"""Pipeline parallelism: a GPipe schedule over a mesh's ``"pp"`` axis.

Counterpart of ``incubator_mxnet_tpu/parallel/pipeline.py``.  Each shard
of the axis holds one stage's parameters.  The batch splits into
microbatches; activations hop stage to stage by ``send``/``recv`` (over
ranks: point-to-point calls on the axis's subgroup), the last stage
computes the loss on the whole batch's outputs, and the backward replays
the microbatches in reverse, each stage sending its input's gradient back.
``pre`` runs on the first stage and ``post`` with the loss on the last;
the loss reaches every shard by a sum over the axis (the JAX build's
``psum``, :68).  A stage waits for its input rather than computing on
zeros: the JAX loop computes the bubble steps and discards them, so the
answers are the same.

Constraints, as in the JAX build: every stage maps an activation to one of
the same shape, stages are structurally identical (``PipelineTrainer``
probes that they also compute alike), and the optimizer is plain SGD in
f32 with the learning rate read at each step.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from ..ndarray import NDArray
from .mesh import current_mesh, dispatch_on_mesh, axis_devices

__all__ = ["pipeline_apply", "pipeline_train_step", "make_pipeline_trainer",
           "PipelineTrainer"]

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
_HEADER = 10        # dtype code, ndim, then the dims


def _microbatch_header(ax, h, n_micro):
    """The microbatch shape and dtype stage 0 sends, on every stage (one
    sum over the axis of a small int tensor)."""
    head = torch.zeros(_HEADER, dtype=torch.int64, device=ax.device)
    if ax.index == 0:
        if h.shape[0] % n_micro:
            raise ValueError("batch %d not divisible into %d microbatches"
                             % (h.shape[0], n_micro))
        shape = (h.shape[0] // n_micro,) + tuple(h.shape[1:])
        head[0] = _DTYPES.index(h.dtype)
        head[1] = len(shape)
        head[2:2 + len(shape)] = torch.tensor(shape)
    head = ax.psum(head).tolist()
    return tuple(head[2:2 + head[1]]), _DTYPES[head[0]]


def _pp_forward(ax, params, h, stage_fn, n_micro, grad):
    """This stage's forward over the microbatches: stage 0 reads its
    microbatches from ``h``, the others receive them; every stage but the
    last sends its outputs on.  Returns ([(input, output)] a microbatch,
    the microbatch shape, dtype)."""
    n, idx = ax.size, ax.index
    shape, dtype = _microbatch_header(ax, h, n_micro)
    xs = h.chunk(n_micro) if idx == 0 else None
    saved = []
    for i in range(n_micro):
        a = xs[i] if idx == 0 else ax.recv(idx - 1, shape, dtype)
        if grad and idx > 0:
            a = a.detach().requires_grad_()
        with torch.set_grad_enabled(grad):
            y = stage_fn(params, a)
        if idx < n - 1:
            ax.send(y.detach(), idx + 1)
        saved.append((a, y))
    return saved, shape, dtype


def _pp_backward(ax, saved, g_last):
    """This stage's backward, microbatches in reverse: the last stage's
    output gradients are ``g_last``, the others' arrive from the next
    stage; every stage but the first sends its inputs' gradients back."""
    n, idx = ax.size, ax.index
    for i in reversed(range(len(saved))):
        a, y = saved[i]
        g = g_last[i] if idx == n - 1 else ax.recv(idx + 1, y.shape, y.dtype)
        torch.autograd.backward(y, g)
        if idx > 0:
            ax.send(a.grad, idx - 1)


def _pp_train(ax, params, x, y, stage_fn, loss_fn, n_micro, pre=None,
              post=None):
    """One training pass of this stage: ``params`` are leaves that require
    grad (their ``.grad`` is the step's gradient); ``pre`` and ``post``
    are ``(fn, leaves)`` pairs run on the first and the last stage.
    Returns the mean loss, on every stage."""
    n, idx = ax.size, ax.index
    h = h_leaf = None
    if idx == 0:
        h = pre[0](pre[1], x) if pre is not None else x
        h_leaf = h.detach().requires_grad_(pre is not None)
    saved, _, _ = _pp_forward(ax, params, h_leaf, stage_fn, n_micro, True)
    loss = torch.zeros((), dtype=torch.float32, device=ax.device)
    g_last = None
    if idx == n - 1:
        outs = [o.detach().requires_grad_() for _, o in saved]
        out = torch.cat(outs)
        if post is not None:
            out = post[0](post[1], out)
        total = loss_fn(out, y).to(torch.float32).mean()
        total.backward()
        g_last = [o.grad for o in outs]
        loss = total.detach()
    _pp_backward(ax, saved, g_last)
    if idx == 0 and pre is not None:
        torch.autograd.backward(h, h_leaf.grad)
    with torch.no_grad():
        return ax.psum(loss)


def _flat(stacked):
    names = list(stacked)
    return names, [stacked[k] for k in names]


def pipeline_apply(stage_fn, stacked_params, x, mesh, axis="pp",
                   num_microbatches=None):
    """x through the stages, stage i with ``stacked_params[...][i]``:
    ``stacked_params`` is a dict of tensors with a leading axis of one slice
    a stage, ``stage_fn(params, act)`` one stage.  Returns the last stage's
    (batch, ...) output (on every rank of a mesh of ranks)."""
    n_micro = num_microbatches or mesh.axis_size(axis)
    names, leaves = _flat(stacked_params)

    def body(ax, xv, *ps):
        params = {k: p[0] for k, p in zip(names, ps)}
        h = xv if ax.index == 0 else None
        saved, shape, dtype = _pp_forward(ax, params, h, stage_fn, n_micro,
                                          False)
        if ax.index == ax.size - 1:
            out = torch.cat([o for _, o in saved])
        else:
            out = torch.zeros((shape[0] * n_micro,) + shape[1:],
                              dtype=dtype, device=ax.device)
        return ax.psum(out)

    with torch.no_grad():
        return dispatch_on_mesh(body, mesh, axis,
                                (None,) + (0,) * len(leaves), None,
                                x, *leaves)


def pipeline_train_step(stage_fn, stacked_params, x, y, loss_fn, mesh,
                        axis="pp", num_microbatches=None):
    """One GPipe training pass: returns ``(loss, grads)``, the mean of
    ``loss_fn(out, y)`` over the batch and the gradients shaped like
    ``stacked_params``."""
    n_micro = num_microbatches or mesh.axis_size(axis)
    names, leaves = _flat(stacked_params)

    def body(ax, xv, yv, *ps):
        params = {k: p[0].detach().requires_grad_() for k, p in
                  zip(names, ps)}
        loss = _pp_train(ax, params, xv, yv, stage_fn, loss_fn, n_micro)
        return (loss,) + tuple(params[k].grad[None] if params[k].grad
                               is not None else torch.zeros_like(ps[j])
                               for j, k in enumerate(names))

    outs = dispatch_on_mesh(body, mesh, axis,
                            (None, None) + (0,) * len(leaves),
                            (None,) + (0,) * len(leaves), x, y, *leaves)
    return outs[0], dict(zip(names, outs[1:]))


def make_pipeline_trainer(stage_fn, loss_fn, mesh, axis="pp",
                          num_microbatches=None, learning_rate=0.01):
    """``train(params, x, y) -> (params, loss)``: one GPipe SGD step."""

    def train(params, x, y):
        loss, grads = pipeline_train_step(stage_fn, params, x, y, loss_fn,
                                          mesh, axis=axis,
                                          num_microbatches=num_microbatches)
        return {k: p - learning_rate * grads[k]
                for k, p in params.items()}, loss

    return train


def _run_block(block, vals_by_name, x, train=True, ctx=None):
    """One Gluon block as a function: its forward on the tensor ``x`` with
    its parameters' values taken from ``vals_by_name`` (tensors by full
    name), recorded when grad mode is on; returns a tensor."""
    shadows = {n: NDArray(v, ctx=ctx) for n, v in vals_by_name.items()}
    with autograd._scope(recording=torch.is_grad_enabled(), training=train):
        with block._trace_params(shadows):
            out = block.hybrid_forward_dispatch(NDArray(x, ctx=ctx))
    return out._data


class PipelineTrainer(object):
    """GPipe training of a Gluon ``HybridSequential`` of identical stages:

        body = nn.HybridSequential()
        for _ in range(n_stages):
            body.add(Stage(...))                   # identical structure
        trainer = PipelineTrainer(body, loss, mesh, pre=embed, post=head)
        loss = trainer.step(x, y)

    Each shard of the mesh axis holds one stage's f32 parameters: over a
    mesh of this process's Contexts every stage on its device (a thread
    each), over ranks this rank's stage only; ``pre`` lives on the first
    stage, ``post`` on the last.  ``sync_params()`` writes every trained
    value back into the blocks (over ranks, on every rank).  Stochastic
    layers are not supported inside the stages, and a BatchNorm's running
    statistics inside them are not kept.  SGD, ``learning_rate`` read at
    each step."""

    def __init__(self, net, loss, mesh=None, axis="pp", num_microbatches=None,
                 learning_rate=0.01, pre=None, post=None):
        self.net = net
        self.loss = loss
        self.mesh = mesh if mesh is not None else current_mesh(required=True)
        self.axis = axis
        self.num_microbatches = num_microbatches
        self.learning_rate = learning_rate
        self.pre = pre
        self.post = post
        self._stages = list(net._children)
        n = self.mesh.axis_size(axis)
        if axis not in self.mesh.axis_names or len(self._stages) != n:
            raise ValueError(
                "net has %d stage blocks but mesh axis %r has %d devices"
                % (len(self._stages), axis,
                   n if axis in self.mesh.axis_names else 0))
        self._vals = None

    # -- parameter plumbing ------------------------------------------------
    def _names(self, blk):
        return [] if blk is None else list(blk.collect_params().keys())

    def _gather(self, x):
        ctx = NDArray(x).context
        with autograd.pause():
            h = NDArray(x, ctx=ctx)
            if self.pre is not None:
                h = self.pre(h)
            for blk in self._stages:
                h = blk(h)          # resolves deferred shapes stage by stage
            if self.post is not None:
                self.post(h)
        template = self._stages[0]
        stage_vals = []
        for blk in self._stages:
            if type(blk) is not type(template):
                raise ValueError(
                    "pipeline stages must be the same block type: %s vs %s"
                    % (type(template).__name__, type(blk).__name__))
            vals = [p.data()._data for p in blk.collect_params().values()]
            if stage_vals and [v.shape for v in vals] != \
                    [v.shape for v in stage_vals[0]]:
                raise ValueError(
                    "pipeline stages are not structurally identical: %s vs "
                    "%s" % ([tuple(v.shape) for v in stage_vals[0]],
                            [tuple(v.shape) for v in vals]))
            stage_vals.append(vals)
        # the stages must compute alike, not only match in shapes (a
        # Dense(tanh) against a Dense(relu)): each stage's own forward
        # against the first stage's driven by its values, both in training
        # mode
        with torch.no_grad():
            probe = x
            if self.pre is not None:
                probe = _run_block(self.pre, self._block_vals(self.pre),
                                   probe, ctx=ctx)
            names0 = self._names(template)
            for blk, vals in zip(self._stages[1:], stage_vals[1:]):
                own = _run_block(blk, dict(zip(self._names(blk), vals)),
                                 probe, ctx=ctx)
                via = _run_block(template, dict(zip(names0, vals)), probe,
                                 ctx=ctx)
                if not torch.allclose(own, via, rtol=1e-5, atol=1e-6):
                    raise ValueError(
                        "pipeline stage %r computes differently from stage "
                        "0 despite identical param shapes (e.g. a different "
                        "activation/config): the GPipe schedule requires "
                        "functionally identical stages" % (blk.name,))
        n = len(self._stages)
        if self.mesh.kvstore is not None:
            from .dist import RankAxis
            ax = RankAxis(self.mesh, self.axis)
            devices = [ax.ctx] * n
            keep = [i == ax.index for i in range(n)]
        else:
            devices = axis_devices(self.mesh, self.axis, ctx)
            keep = [True] * n
        self._vals = [[v.detach().to(devices[i].torch_device(), torch.float32,
                                     copy=True) for v in stage_vals[i]]
                      if keep[i] else None for i in range(n)]
        self._pre_vals = [v.detach().to(devices[0].torch_device(),
                                        torch.float32, copy=True)
                          for v in self._block_vals(self.pre).values()] \
            if self.pre is not None and keep[0] else None
        self._post_vals = [v.detach().to(devices[-1].torch_device(),
                                         torch.float32, copy=True)
                           for v in self._block_vals(self.post).values()] \
            if self.post is not None and keep[-1] else None

    @staticmethod
    def _block_vals(blk):
        return {n: p.data()._data for n, p in blk.collect_params().items()}

    # -- the step ----------------------------------------------------------
    def _body(self, ax, x, y):
        i, n = ax.index, ax.size
        stage, names = self._stages[i], self._names(self._stages[i])
        ctx = ax.ctx
        vals = [v.detach().requires_grad_() for v in self._vals[i]]
        pre = post = None
        if i == 0 and self.pre is not None:
            pre_names = self._names(self.pre)
            pre = (lambda p, a: _run_block(self.pre, dict(zip(pre_names, p)),
                                           a, ctx=ctx),
                   [v.detach().requires_grad_() for v in self._pre_vals])
        if i == n - 1 and self.post is not None:
            post_names = self._names(self.post)
            post = (lambda p, a: _run_block(self.post,
                                            dict(zip(post_names, p)), a,
                                            ctx=ctx),
                    [v.detach().requires_grad_() for v in self._post_vals])

        def stage_fn(p, a):
            return _run_block(stage, dict(zip(names, p)), a, ctx=ctx)

        def loss_fn(out, label):
            with autograd._scope(recording=True, training=True):
                return self.loss(NDArray(out, ctx=ctx),
                                 NDArray(label, ctx=ctx))._data

        n_micro = self.num_microbatches or n
        with torch.profiler.record_function("PipelineTrainer.stage%d" % i):
            loss = _pp_train(ax, vals, x, y, stage_fn, loss_fn, n_micro,
                             pre, post)
        lr = float(self.learning_rate)
        updates = [(self._vals[i], vals)]
        if pre is not None:
            updates.append((self._pre_vals, pre[1]))
        if post is not None:
            updates.append((self._post_vals, post[1]))
        with torch.no_grad():
            for dst, leaves in updates:
                for w, leaf in zip(dst, leaves):
                    if leaf.grad is not None:
                        w.sub_(lr * leaf.grad)
        return loss

    def step(self, data, label):
        """One pipeline-parallel training step; returns the mean loss, an
        f32 scalar tensor (on every rank of a mesh of ranks)."""
        x = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(np.asarray(data))
        y = label._data if isinstance(label, NDArray) else \
            torch.as_tensor(np.asarray(label))
        if self._vals is None:
            self._gather(x)
        return dispatch_on_mesh(self._body, self.mesh, self.axis,
                                (None, None), None, x, y)

    def sync_params(self):
        """Write the trained values back into the Gluon blocks (over ranks:
        every stage's into every rank's blocks)."""
        if self.mesh.kvstore is not None:
            return self._sync_ranks()
        with torch.no_grad():
            for blk, vals in zip(self._stages, self._vals):
                for p, v in zip(blk.collect_params().values(), vals):
                    p.data()._data.copy_(v)
            for blk, vals in ((self.pre, self._pre_vals),
                              (self.post, self._post_vals)):
                for p, v in zip(blk.collect_params().values()
                                if blk is not None else (), vals or ()):
                    p.data()._data.copy_(v)

    def _sync_ranks(self):
        from .dist import RankAxis
        ax = RankAxis(self.mesh, self.axis)
        i, n = ax.index, ax.size
        with torch.no_grad():
            per_stage = [list(b.collect_params().values())
                         for b in self._stages]
            for j, v in enumerate(self._vals[i]):
                every = ax.all_gather(v[None], 0)
                for s in range(n):
                    per_stage[s][j].data()._data.copy_(every[s])
            for blk, vals, owner in ((self.pre, self._pre_vals, 0),
                                     (self.post, self._post_vals, n - 1)):
                if blk is None:
                    continue
                for j, p in enumerate(blk.collect_params().values()):
                    d = p.data()._data
                    mine = vals[j] if i == owner else torch.zeros(
                        d.shape, dtype=torch.float32, device=ax.device)
                    d.copy_(ax.psum(mine))
