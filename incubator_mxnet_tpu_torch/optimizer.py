"""Optimizer registry and weight-update machinery.

Counterpart of ``incubator_mxnet_tpu/optimizer.py``: ``Optimizer`` (:36-162)
with ``register`` and ``create``, ``SGD`` (:176-242, with
``multi_precision``), ``NAG``, ``Adam``, ``AdaGrad``, ``AdaDelta``,
``RMSProp``, ``Ftrl``, ``FTML``, ``Signum``, ``SGLD``, ``DCASGD``,
``LBSGD`` and ``Test`` (:246-571), ``Updater`` (:576) and ``get_updater``
(:661).  Each ``update(index, weight, grad, state)`` dispatches to the
update operators of ``ops/optimizer_ops.py`` (the registry's formulas,
never ``torch.optim``), or, where the reference's optimizer is Python
(AdaGrad, AdaDelta, SGLD, DCASGD, Test), computes the same formulas in
torch ops; SGLD's noise comes from the framework generator of the
weight's device.  A 16-bit weight with ``multi_precision`` updates an f32
master copy.  ``SGD`` with ``lazy_update`` takes a row-sparse gradient
through the lazy updates ``_sparse_sgd_update``/``_sparse_sgd_mom_update``
(:199-230), which touch only its rows (a repeated row keeps its last
value, as the JAX build's scatter does).  The JAX build's fused bucket
updates (:693-) wait for ROADMAP item 12.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from . import random_state
from .base import dtype_name
from .ndarray import NDArray, invoke
from .ndarray import ndarray as _nd_mod
from .ndarray.sparse import RowSparseNDArray
from .ops.registry import get_op

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "FTML", "Signum", "SGLD", "DCASGD", "LBSGD",
           "Test", "create", "register", "get_updater", "Updater"]


def _is_half(weight):
    return dtype_name(weight.dtype) in ("float16", "bfloat16")


class Optimizer(object):
    """Base optimizer (ref: python/mxnet/optimizer.py class Optimizer).

    Tracks per-parameter learning-rate/wd multipliers, update counts and
    the rescale/clip policy shared by every optimizer.
    """

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- registry ----------------------------------------------------------
    @staticmethod
    def register(klass):
        """ref: optimizer.py Optimizer.register."""
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        """ref: optimizer.py create_optimizer."""
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    # -- state -------------------------------------------------------------
    def create_state(self, index, weight):
        """Return optimizer state for one parameter (momentum etc.)."""
        return None

    def create_state_multi_precision(self, index, weight):
        """ref: optimizer.py — fp16/bf16 weights get an f32 master copy."""
        if self.multi_precision and _is_half(weight):
            weight_master_copy = weight.astype("float32")
            return (self.create_state(index, weight_master_copy),
                    weight_master_copy)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """The update on the f32 master copy of a 16-bit weight, which then
        takes its rounding (ref: optimizer.py update_multi_precision)."""
        if self.multi_precision and _is_half(weight):
            inner_state, weight32 = state
            self.update(index, weight32, grad.astype("float32"), inner_state)
            _nd_mod._write(weight._data, weight32._data.to(weight._data.dtype))
        else:
            self.update(index, weight, grad, state)

    # -- lr / wd policy ----------------------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def _sym_mults(self, key):
        """``key`` (``__lr_mult__`` or ``__wd_mult__``) of every argument
        of the symbol the optimizer was made for that carries it."""
        if not self.sym_info:
            return {}
        attr, arg_names = self.sym_info
        return {n: float(attr[n][key]) for n in arg_names
                if key in attr.get(n, {})}

    def set_lr_mult(self, args_lr_mult):
        """ref: optimizer.py set_lr_mult: the symbol's ``__lr_mult__``
        attributes, then ``args_lr_mult``."""
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """ref: optimizer.py set_wd_mult: a named parameter whose name ends
        in neither ``_weight`` nor ``_gamma`` (biases, BatchNorm's beta)
        gets wd 0, then the symbol's ``__wd_mult__`` attributes, then
        ``args_wd_mult``."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def __getstate__(self):
        d = dict(self.__dict__)
        d["param_dict"] = {}    # Parameters are not pickled with the state
        return d


register = Optimizer.register
create = Optimizer.create_optimizer


def _common_kwargs(opt, index):
    kw = {"lr": opt._get_lr(index), "wd": opt._get_wd(index),
          "rescale_grad": opt.rescale_grad}
    if opt.clip_gradient is not None:
        kw["clip_gradient"] = opt.clip_gradient
    return kw


def _zeros_like(weight):
    return _nd_mod.invoke(get_op("zeros_like"), [weight], {})


@register
class SGD(Optimizer):
    """SGD with momentum and optional multi-precision (ref: optimizer.py
    class SGD → sgd_update / sgd_mom_update / mp_* ops)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _common_kwargs(self, index)
        if isinstance(grad, RowSparseNDArray) and self.lazy_update:
            # the lazy update: only the gradient's rows (ref:
            # optimizer_op.cc SGDUpdateRspRspImpl); a registered op, so
            # mx.engine.bulk defers it
            kw["clip_gradient"] = kw.get("clip_gradient", -1.0)
            idx, data = grad._canonical_parts()
            gnd = [NDArray(data, ctx=grad.context),
                   NDArray(idx, ctx=grad.context)]
            if state is not None:
                kw["momentum"] = self.momentum
                invoke(get_op("_sparse_sgd_mom_update"),
                       [weight] + gnd + [state], kw, out=weight)
            else:
                invoke(get_op("_sparse_sgd_update"), [weight] + gnd, kw,
                       out=weight)
            return
        kw["lazy_update"] = self.lazy_update
        if state is not None:
            kw["momentum"] = self.momentum
            invoke(get_op("sgd_mom_update"), [weight, grad, state], kw,
                   out=weight)
        else:
            invoke(get_op("sgd_update"), [weight, grad], kw, out=weight)

    def update_multi_precision(self, index, weight, grad, state):
        if not (self.multi_precision and _is_half(weight)):
            return self.update(index, weight, grad, state)
        self._update_count(index)
        kw = _common_kwargs(self, index)
        mom, weight32 = state
        if mom is not None:
            kw["momentum"] = self.momentum
            invoke(get_op("mp_sgd_mom_update"), [weight, grad, mom, weight32],
                   kw, out=weight)
        else:
            invoke(get_op("mp_sgd_update"), [weight, grad, weight32], kw,
                   out=weight)


@register
class Adam(Optimizer):
    """Adam (ref: optimizer.py class Adam → adam_update op; the bias
    correction folded into lr, as in the reference)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        kw = {"lr": lr, "wd": self._get_wd(index),
              "rescale_grad": self.rescale_grad, "beta1": self.beta1,
              "beta2": self.beta2, "epsilon": self.epsilon,
              "lazy_update": self.lazy_update}
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        mean, var = state
        invoke(get_op("adam_update"), [weight, grad, mean, var], kw,
               out=weight)


def _prepped(opt, index, weight, grad, with_wd=True):
    """The gradient as the reference's Python optimizers take it:
    rescaled, clipped, plus wd·w (``with_wd``); torch tensors."""
    g = grad._data * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    if with_wd:
        g = g + opt._get_wd(index) * weight._data
    return g


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (ref: optimizer.py class NAG →
    nag_mom_update, or sgd_update without momentum)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _common_kwargs(self, index)
        if state is not None:
            kw["momentum"] = self.momentum
            invoke(get_op("nag_mom_update"), [weight, grad, state], kw,
                   out=weight)
        else:
            invoke(get_op("sgd_update"), [weight, grad], kw, out=weight)


@register
class AdaGrad(Optimizer):
    """ref: optimizer.py class AdaGrad: hist += g²; w -= lr·g /
    (sqrt(hist) + eps)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        with torch.no_grad():
            g = _prepped(self, index, weight, grad)
            hist = state._data + g * g
            _nd_mod._write(state._data, hist)
            _nd_mod._write(weight._data, weight._data - lr * g / (
                torch.sqrt(hist) + self.float_stable_eps))


@register
class AdaDelta(Optimizer):
    """ref: optimizer.py class AdaDelta (no learning rate): running means
    of g² and of the step²."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        acc_g, acc_delta = state
        rho, eps = self.rho, self.epsilon
        with torch.no_grad():
            g = _prepped(self, index, weight, grad)
            ag = rho * acc_g._data + (1 - rho) * (g * g)
            delta = torch.sqrt(acc_delta._data + eps) / \
                torch.sqrt(ag + eps) * g
            ad = rho * acc_delta._data + (1 - rho) * (delta * delta)
            _nd_mod._write(acc_g._data, ag)
            _nd_mod._write(acc_delta._data, ad)
            _nd_mod._write(weight._data, weight._data - delta)


@register
class RMSProp(Optimizer):
    """ref: optimizer.py class RMSProp: rmsprop_update, or the centred
    rmspropalex_update (``centered=True``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _common_kwargs(self, index)
        kw["gamma1"] = self.gamma1
        kw["epsilon"] = self.epsilon
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        if self.centered:
            n, g, delta = state
            kw["gamma2"] = self.gamma2
            invoke(get_op("rmspropalex_update"), [weight, grad, n, g, delta],
                   kw, out=weight)
        else:
            invoke(get_op("rmsprop_update"), [weight, grad, state], kw,
                   out=weight)


@register
class Ftrl(Optimizer):
    """ref: optimizer.py class Ftrl → ftrl_update."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _common_kwargs(self, index)
        kw["lamda1"] = self.lamda1
        kw["beta"] = self.beta
        z, n = state
        invoke(get_op("ftrl_update"), [weight, grad, z, n], kw, out=weight)


@register
class FTML(Optimizer):
    """ref: optimizer.py class FTML → ftml_update at the index's step."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _common_kwargs(self, index)
        kw.update(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                  t=self._index_update_count[index])
        d, v, z = state
        invoke(get_op("ftml_update"), [weight, grad, d, v, z], kw,
               out=weight)


@register
class Signum(Optimizer):
    """ref: optimizer.py class Signum → signum_update, or signsgd_update
    without momentum."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _common_kwargs(self, index)
        if state is not None:
            kw["momentum"] = self.momentum
            kw["wd_lh"] = self.wd_lh
            invoke(get_op("signum_update"), [weight, grad, state], kw,
                   out=weight)
        else:
            invoke(get_op("signsgd_update"), [weight, grad], kw, out=weight)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (ref: optimizer.py class
    SGLD): w -= lr/2·g, plus N(0, lr) noise from the framework generator
    of the weight's device."""

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        w = weight._data
        with torch.no_grad():
            g = _prepped(self, index, weight, grad)
            noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                                generator=random_state.generator(w.device))
            _nd_mod._write(w, w - lr / 2 * g + noise * math.sqrt(lr))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (ref: optimizer.py class
    DCASGD): the gradient plus lamda·g²·(w - w_previous)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        mon, previous_weight = state
        w = weight._data
        with torch.no_grad():
            g = _prepped(self, index, weight, grad, with_wd=False)
            comp = g + self._get_wd(index) * w + \
                self.lamda * g * g * (w - previous_weight._data)
            if mon is not None:
                m = self.momentum * mon._data - lr * comp
                _nd_mod._write(mon._data, m)
            else:
                m = -lr * comp
            _nd_mod._write(previous_weight._data, w)
            _nd_mod._write(w, w + m)


@register
class LBSGD(Optimizer):
    """Large-batch SGD (ref: optimizer.py class LBSGD, the JAX build's
    form): the rate scaled by a multiplier that warms up linearly to
    ``batch_scale`` over ``warmup_epochs``, then sgd(_mom)_update."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def _get_lbmult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        if self.warmup_strategy == "linear" and nwup > 0 and nup < nwup:
            return 1.0 + (self.batch_scale - 1.0) * nup / nwup
        return float(self.batch_scale)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self.lbmult = self._get_lbmult(self.num_update + self.init_updates)
        kw = _common_kwargs(self, index)
        kw["lr"] = kw["lr"] * self.lbmult
        if state is not None:
            kw["momentum"] = self.momentum
            invoke(get_op("sgd_mom_update"), [weight, grad, state], kw,
                   out=weight)
        else:
            invoke(get_op("sgd_update"), [weight, grad], kw, out=weight)


@register
class Test(Optimizer):
    """ref: optimizer.py class Test: w += rescale_grad·g; the state keeps
    the new weight."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            _nd_mod._write(weight._data,
                           weight._data + self.rescale_grad * grad._data)
            _nd_mod._write(state._data, weight._data)


class Updater(object):
    """Per-index stateful updater (ref: optimizer.py class Updater /
    get_updater): state is made on first use of an index, on the weight's
    context."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def ensure_state(self, index, weight):
        """The state of ``index``: created on first use, moved to the
        weight's context after ``set_states``."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = self.sync_state_context(self.states[index],
                                                         weight.context)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        state = self.ensure_state(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad, state)

    def sync_state_context(self, state, context):
        if isinstance(state, NDArray):
            return state if state.context == context else \
                state.copyto(context)
        if isinstance(state, np.ndarray):
            return _nd_mod.array(state, ctx=context)
        if isinstance(state, (tuple, list)):
            return type(state)(self.sync_state_context(i, context)
                               for i in state)
        return state

    def set_states(self, states):
        """ref: optimizer.py Updater.set_states (pickle format); loaded
        arrays become NDArrays on the weight's context at first use."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        self.states = dict(states)
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        """The states as pickled host arrays (ref: Updater.get_states)."""
        def to_np(s):
            if isinstance(s, NDArray):
                return s.asnumpy()
            if isinstance(s, (tuple, list)):
                return type(s)(to_np(i) for i in s)
            return s
        states = {k: to_np(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)


def get_updater(optimizer):
    """ref: optimizer.py get_updater."""
    return Updater(optimizer)
