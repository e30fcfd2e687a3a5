"""DataParallelTrainer: the whole training step of a Gluon HybridBlock.

Counterpart of ``incubator_mxnet_tpu/parallel/data_parallel.py``
(``pure_optimizer`` :55, ``DataParallelTrainer`` :110).  The JAX build jits
forward, loss, backward and optimizer update into one XLA program over a
mesh; the port runs the same step eagerly in torch on one device:

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

A mesh of more than one device raises until multi-GPU (ROADMAP Queue A
item 6).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..ndarray import NDArray
from ..ops.registry import get_op
from .. import autograd

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


class DataParallelTrainer(object):
    """The data-parallel trainer of a Gluon HybridBlock, on one device."""

    def __init__(self, block, loss, optimizer="sgd", optimizer_params=None,
                 mesh=None, donate=True, dtype=None):
        """``dtype='bfloat16'`` is mixed precision: the master weights and
        the optimizer stay in f32; weights and inputs are cast to bf16
        inside the recorded step and the loss is computed in f32.
        ``donate`` is accepted for parity: the port always updates its
        copies in place."""
        if mesh is not None and mesh.size != 1:
            raise MXNetError(
                "DataParallelTrainer over a mesh of %d devices is not ported "
                "yet: it comes with multi-GPU (ROADMAP Queue A item 6)"
                % mesh.size)
        self.block = block
        self.loss = loss
        self.mesh = mesh
        optimizer_params = dict(optimizer_params or {})
        self._lr = optimizer_params.pop("learning_rate", 0.01)
        self._opt_init, self._opt_update = pure_optimizer(optimizer,
                                                          **optimizer_params)
        self._compute_dtype = torch_dtype(dtype) if dtype is not None \
            else None
        self._ctx = None
        self._params = None       # name -> master tensor on the device
        self._opt_state = None    # name -> tuple of state tensors
        self._trainable = None

    # -- parameter plumbing ------------------------------------------------
    def _gather_params(self, example_x):
        blk_params = self.block.collect_params()
        first = next(iter(blk_params.values()))
        self._ctx = self.mesh.devices.flat[0] if self.mesh is not None \
            else first.list_ctx()[0]
        if any(p._data is None and p._deferred_init
               for p in blk_params.values()):
            # resolve deferred shapes with one pass over the example, on the
            # parameters' own device; ids enter that pass as floats
            ex = example_x if example_x.is_floating_point() \
                else example_x.to(torch.float32)
            ex = ex.to(first.list_ctx()[0].torch_device())
            self.block._run_deferred_init(NDArray(ex))
        dev = self._ctx.torch_device()
        self._params = {n: p.data()._data.detach().to(dev, copy=True)
                        for n, p in blk_params.items()}
        self._trainable = [n for n, p in blk_params.items()
                           if p.grad_req != "null"]
        self._opt_state = {n: self._opt_init(self._params[n])
                           for n in self._trainable}

    def sync_params(self):
        """Write the trainer's weights back into the Block."""
        blk_params = self.block.collect_params()
        with torch.no_grad():
            for name, v in self._params.items():
                for arr in blk_params[name].list_data():
                    arr._data.copy_(v)

    # -- the step ----------------------------------------------------------
    def _loss_and_grads(self, x, y):
        cdt = self._compute_dtype
        leaves = {n: self._params[n].detach().requires_grad_()
                  for n in self._trainable}
        with torch.enable_grad():
            # frozen values enter as the master tensors, uncast, so a layer's
            # in-place write (BatchNorm's running stats) is their update
            vals = {n: v for n, v in self._params.items() if n not in leaves}
            if cdt is not None:
                # only trainable f32 weights are cast, inside the graph, so
                # their gradients come back in f32
                vals.update({n: w.to(cdt) if w.dtype == torch.float32 else w
                             for n, w in leaves.items()})
                if x.dtype == torch.float32 or x.dtype in _NARROW_INTS:
                    x = x.to(cdt)
            else:
                vals.update(leaves)
                if not x.is_floating_point():
                    x = x.to(torch.float32)
            shadows = {n: NDArray(v, ctx=self._ctx) for n, v in vals.items()}
            with autograd._scope(recording=True, training=True):
                with self.block._trace_params(shadows):
                    out = self.block.hybrid_forward_dispatch(
                        NDArray(x, ctx=self._ctx))
                if cdt is not None:
                    out = out.astype("float32")
                per_sample = self.loss(out, NDArray(y, ctx=self._ctx))
            loss = per_sample._data.mean()
        with torch.no_grad():
            for n, v in vals.items():
                if n not in leaves and shadows[n]._data is not v:
                    v.copy_(shadows[n]._data)
        grads = torch.autograd.grad(loss, [leaves[n] for n in self._trainable],
                                    allow_unused=True)
        return loss.detach(), list(grads)

    def step(self, data, label):
        """One training step on (``data``, ``label``); returns the loss, an
        f32 scalar NDArray on the device."""
        x = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(np.asarray(data))
        y = label._data if isinstance(label, NDArray) else \
            torch.as_tensor(np.asarray(label))
        if self._params is None:
            self._gather_params(x)
        dev = self._ctx.torch_device()
        # named spans, so a profile can attribute the step's kernels
        with torch.profiler.record_function("DataParallelTrainer.forward_"
                                            "backward"):
            loss, grads = self._loss_and_grads(x.to(dev), y.to(dev))
        with torch.profiler.record_function("DataParallelTrainer.update"), \
                torch.no_grad():
            for i, n in enumerate(self._trainable):
                w, g = self._params[n], grads[i]
                grads[i] = None     # frees each gradient once it is applied
                if g is None:       # a weight the loss does not reach
                    g = torch.zeros_like(w)
                new_w, new_state = self._opt_update(w, g, self._opt_state[n],
                                                    self._lr)
                w.copy_(new_w)
                for s, ns in zip(self._opt_state[n], new_state):
                    s.copy_(ns)
        return NDArray(loss, ctx=self._ctx)

    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = lr
