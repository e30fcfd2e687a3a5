"""Module: a Symbol and its executor, the intermediate-level training API.

Counterpart of ``incubator_mxnet_tpu/module/module.py`` (ref:
python/mxnet/module/module.py): bind, init_params, init_optimizer,
forward, backward and update over a ``DataParallelExecutorGroup`` on one
context, the checkpoint files (``prefix-symbol.json``, ``prefix-%04d.params``,
``.states``) and ``install_monitor``.  The kvstore spec resolves through
``kvstore.create_kvstore`` (MXNet's ``model._create_kvstore``): None or a
type name on one context needs no store, and the update runs here through
``optimizer.get_updater``; a ``KVStore`` object takes the weights, and
with ``update_on_kvstore`` the optimizer too (``update`` pushes the
gradients and pulls the weights, MXNet's ``_update_params_on_kvstore``).
A ``dist`` type waits for ROADMAP item 7 and raises.  The default context
is the current one, the card (MXNet's is ``cpu()``).
"""
from __future__ import annotations

import logging
import warnings

import numpy as np

from .. import context as ctx_mod
from .. import ndarray as nd
from .. import optimizer as opt
from ..initializer import Uniform, InitDesc
from ..io import DataDesc
from ..kvstore import create_kvstore
from ..ndarray import NDArray
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class Module(BaseModule):
    """ref: module.py class Module."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if context is None:
            context = ctx_mod.current_context()
        if isinstance(context, ctx_mod.Context):
            context = [context]
        self._context = context
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        self._work_load_list = work_load_list

        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []

        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = list(state_names or [])
        self._output_names = symbol.list_outputs()

        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._compression_params = compression_params
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._updater = None
        self._preload_opt_states = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """ref: module.py Module.load."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """ref: module.py save_checkpoint: ``prefix-symbol.json`` and
        ``prefix-%04d.params`` (``nd.save`` writes a temporary file and
        renames it), and ``prefix-%04d.states`` with the optimizer's."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        self.logger.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            self.logger.info('Saved optimizer state to "%s"', state_name)

    # -- properties --------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        """Inferred from the bound shapes, valid before any forward."""
        assert self.binded
        known = {n: tuple(s) for n, s in self._data_shapes}
        for n, s in (self._label_shapes or []):
            known[n] = tuple(s)
        _, out_shapes, _ = self._symbol.infer_shape(**known)
        return list(zip(self._output_names, out_shapes))

    # -- params ------------------------------------------------------------
    def get_params(self):
        """ref: module.py get_params."""
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """ref: module.py init_params.  ``arg_params``/``aux_params`` values
        may be NDArrays or numpy arrays."""
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "init_params call ignored.", stacklevel=2)
            return
        assert self.binded, "call bind before initializing the parameters"
        if initializer is None:
            initializer = Uniform(0.01)
        ctx = self._context[0]

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    cache_arr = cache[name]
                    if cache_arr is not arr:
                        if not isinstance(cache_arr, NDArray):
                            cache_arr = nd.array(np.asarray(cache_arr),
                                                 ctx=ctx)
                        cache_arr.copyto(arr)
                else:
                    if not allow_missing:
                        raise RuntimeError("%s is not presented" % name)
                    if initializer is not None:
                        initializer(InitDesc(name, attrs), arr)
            else:
                initializer(InitDesc(name, attrs), arr)

        attr_dict = self._symbol.attr_dict()
        if self._arg_params is None:
            self._arg_params = {}
        if self._aux_params is None:
            self._aux_params = {}
        exe0 = self._exec_group.execs[0]
        for names, params, bound, given in (
                (self._param_names, self._arg_params, exe0.arg_dict,
                 arg_params),
                (self._aux_names, self._aux_params, exe0.aux_dict,
                 aux_params)):
            for name in names:
                if name not in params or params[name] is None or \
                        force_init or (given is not None and name in given):
                    arr = nd.zeros(bound[name].shape, ctx=ctx,
                                   dtype=bound[name]._data.dtype)
                    attrs = attr_dict.get(name, {})
                    _impl(name, arr, given)
                    params[name] = arr

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """ref: module.py set_params (no re-init with ``allow_missing``)."""
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and force_init=False. "
                          "set_params call ignored.", stacklevel=2)
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    # -- bind --------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """ref: module.py bind → DataParallelExecutorGroup."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        self._data_shapes = [ds if isinstance(ds, DataDesc) else DataDesc(*ds)
                             for ds in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [ls if isinstance(ls, DataDesc)
                                  else DataDesc(*ls) for ls in label_shapes]
        else:
            self._label_shapes = None

        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group, self.logger,
            self._fixed_param_names, grad_req, self._state_names)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    def reshape(self, data_shapes, label_shapes=None):
        """ref: module.py reshape."""
        assert self.binded
        if self._params_dirty:
            self._sync_params_from_devices()
        self._data_shapes = [ds if isinstance(ds, DataDesc) else DataDesc(*ds)
                             for ds in data_shapes]
        if label_shapes is not None:
            self._label_shapes = [ls if isinstance(ls, DataDesc)
                                  else DataDesc(*ls) for ls in label_shapes]
        self._exec_group.reshape(self._data_shapes, self._label_shapes)
        self._exec_group.set_params(self._arg_params, self._aux_params)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """ref: module.py init_optimizer: the store (if any) takes every
        parameter and the devices pull it back; with the update on the
        store it takes the optimizer too."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        kvstore, update_on_kvstore = create_kvstore(
            kvstore, len(self._context),
            {n: self._arg_params[n] for n in self._param_names})

        rescale_grad = 1.0 / self._exec_group.batch_size
        idx2name = dict(enumerate(self._param_names))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = rescale_grad
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name, **optimizer_params)
        else:
            assert isinstance(optimizer, opt.Optimizer)
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn(
                    "Optimizer created manually outside Module but rescale_grad "
                    "is not normalized to 1.0/batch_size/num_workers (%s vs. %s). "
                    "Is this intended?" % (optimizer.rescale_grad, rescale_grad),
                    stacklevel=2)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()

        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore is not None:
            keys = list(range(len(self._param_names)))
            kvstore.init(keys, [self._arg_params[n]
                                for n in self._param_names])
            kvstore.pull_many(keys, [self._exec_group.param_arrays[i]
                                     for i in keys])
            if update_on_kvstore:
                kvstore.set_optimizer(optimizer)
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # -- execution ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """ref: module.py forward (re-binds for a batch of new shapes)."""
        assert self.binded and self.params_initialized
        curr_data_shapes = tuple(i.shape for i in self._data_shapes)
        if isinstance(data_batch, list):
            assert data_batch
            new_data_shapes = tuple(d.shape for d in data_batch[0].data)
        else:
            new_data_shapes = tuple(d.shape for d in data_batch.data)
        if curr_data_shapes != new_data_shapes:
            new_dshape = [DataDesc(i.name, shape, i.dtype, i.layout)
                          for i, shape in zip(self._data_shapes,
                                              new_data_shapes)]
            if getattr(data_batch, "provide_label", None):
                new_lshape = data_batch.provide_label
            elif getattr(data_batch, "label", None) and self._label_shapes:
                new_lshape = [DataDesc(i.name, j.shape, i.dtype, i.layout)
                              for i, j in zip(self._label_shapes,
                                              data_batch.label)]
            else:
                new_lshape = None
            self.reshape(new_dshape, new_lshape)
        self._exec_group.forward(data_batch, is_train)
        if self._aux_names and (is_train or (is_train is None and
                                             self.for_training)):
            # a training forward moved the auxiliary states (BatchNorm's
            # moving statistics): the host copies are stale
            self._params_dirty = True

    def backward(self, out_grads=None):
        """ref: module.py backward."""
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to every parameter with a gradient (ref:
        module.py update → model._update_params_on_kvstore, or
        model._update_params with the store's sum of the gradients when a
        store keeps the update here)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        params = self._exec_group.param_arrays
        grads = self._exec_group.grad_arrays
        keys = [i for i in range(len(self._param_names))
                if grads[i][0] is not None]
        if self._kvstore is not None and keys:
            self._kvstore.push_many(keys, [grads[i] for i in keys])
            if self._update_on_kvstore:
                self._kvstore.pull_many(keys, [params[i] for i in keys])
                return
            self._kvstore.pull_many(keys, [grads[i] for i in keys])
        for idx in keys:
            for dev_i, (w, g) in enumerate(zip(params[idx], grads[idx])):
                self._updater(idx * len(self._context) + dev_i, g, w)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        """ref: module.py _sync_params_from_devices."""
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        """ref: module.py save_optimizer_states (the updater's pickle, the
        store's when the update runs there)."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """ref: module.py load_optimizer_states."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def install_monitor(self, mon):
        assert self.binded
        for exe in self._exec_group.execs:
            mon.install(exe)
