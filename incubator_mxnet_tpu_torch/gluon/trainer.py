"""Gluon Trainer (counterpart of ``incubator_mxnet_tpu/gluon/trainer.py``).

Applies an Optimizer to a set of Parameters after a recorded forward and
``backward()``: ``step(batch_size)`` scales the gradients by
``1 / batch_size`` and runs the optimizer's update on every parameter whose
``grad_req`` is not ``null``.  The kvstore follows MXNet's
``_init_kvstore`` (the JAX build's :144-185, ``kvstore.create_kvstore``):
a type name on one context needs no store, so the update runs here; a
``KVStore`` object is used, with the update on the store unless
``update_on_kvstore=False`` (``step`` pushes the gradients and pulls the
weights, or pulls the reduced gradients and updates here).  Parameters on
several contexts are ``init`` in the store from the first context and
pulled to all; ``step`` pushes every context's gradient (the store sums
them) and every context's updater takes the same sum (the JAX build's
:143-185, :232-395).  Over a ``dist`` store ``dist_sync`` (and
``dist_device_sync``) reduce the gradients over the workers and update
here, ``step`` taking the global batch; ``dist_async`` runs the update on
the parameter server, and ``update_on_kvstore=False`` there raises.  The
JAX build's bucketed, overlapped, quantized and elastic machinery is not
ported.  ``save_states`` and
``load_states`` checkpoint the optimizer (through the store when the
update runs there): its pickled state per parameter (momentum, ...), with
the optimizer itself, its ``num_update`` and its ``lr_scheduler``.  A
parameter made with a sparse ``stype`` or ``grad_stype`` keeps dense data
and gradients, and every pull is the plain ``pull`` (the JAX build keeps
such a parameter out of its overlapped and bucketed paths, trainer.py:397,
:654; the port has only the plain one).
"""
from __future__ import annotations

from ..base import MXNetError
from .. import kvstore as kvs_mod
from .. import optimizer as opt
from .parameter import ParameterDict, Parameter

__all__ = ["Trainer"]


class Trainer(object):
    """ref: gluon/trainer.py class Trainer."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                "got %s." % (type(params)))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(
                    "First argument must be a list or dict of Parameters, "
                    "got list of %s." % (type(param)))
            self._params.append(param)
        if compression_params is not None:
            raise MXNetError("gradient compression is not ported yet "
                             "(ROADMAP item 12)")
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore = kvstore
        self._update_on_kvstore_arg = update_on_kvstore
        self._kvstore_obj = None
        self._update_on_kvstore = False
        self._kv_initialized = False

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise ValueError(
                    "All Parameters must be initialized on the same set of "
                    "contexts, but Parameter %s is initialized on %s while "
                    "previous Parameters are initialized on %s."
                    % (param.name, str(ctx), str(contexts)))
            contexts = ctx
        return contexts

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]

    def _init_kvstore(self):
        """ref: trainer.py _init_kvstore: make or take the store, ``init``
        every parameter's value in it (from the first context; on a dist
        store rank 0's) and ``pull`` it to every context, and give the
        store the optimizer when the update runs there."""
        arg_arrays = {param.name: param.data(self._contexts[0])
                      for param in self._params}
        kvstore, update_on_kvstore = kvs_mod.create_kvstore(
            self._kvstore, len(self._contexts), arg_arrays)
        if kvstore is not None:
            if "dist" in kvstore.type:
                # dist_sync: the store sums the gradients and the update
                # runs here; dist_async: the weights live on the parameter
                # server, which runs the update
                update_on_kvstore = "async" in kvstore.type
            if self._update_on_kvstore_arg is not None:
                if "async" in kvstore.type and \
                        not self._update_on_kvstore_arg:
                    raise ValueError(
                        "Cannot set update_on_kvstore=False on dist_async")
                update_on_kvstore = bool(self._update_on_kvstore_arg)
            kvstore.init(list(range(len(self._params))),
                         [p.list_data()[0] for p in self._params])
            # every parameter, frozen ones too: on a dist store the init
            # took rank 0's values, and a frozen layer left at this rank's
            # own would differ forever
            for i, param in enumerate(self._params):
                kvstore.pull(i, param.list_data(), priority=-i)
            if update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
        self._kvstore_obj = kvstore
        self._update_on_kvstore = kvstore is not None and update_on_kvstore
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        """ref: trainer.py set_learning_rate."""
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step with gradients scaled by 1/batch_size (ref:
        trainer.py:232 step)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum the gradients over contexts and workers into every
        context's gradient, without an update (ref: trainer.py
        allreduce_grads, for gradient accumulation)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One ``push_many``/``pull_many`` of every context's gradient,
        keys in parameter order (the same collectives on every rank)."""
        if self._kvstore_obj is None:
            return
        keys = [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]
        if not keys:
            return
        grads = [self._params[i].list_grad() for i in keys]
        self._kvstore_obj.push_many(keys, grads)
        if not self._update_on_kvstore:
            self._kvstore_obj.pull_many(keys, grads)

    def update(self, batch_size, ignore_stale_grad=False):
        """ref: trainer.py update (the update without the reduce)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("update with the update on the store: create "
                             "the Trainer with update_on_kvstore=False")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._update_on_kvstore:
            # the push ran the update on the store's copy: fetch it
            keys = [i for i, p in enumerate(self._params)
                    if p.grad_req != "null"]
            if keys:
                self._kvstore_obj.pull_many(
                    keys, [self._params[i].list_data() for i in keys])
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                upd(i, grad, arr)

    def _states_updater(self):
        """The updater that holds the optimizer's states: the store's when
        the update runs there."""
        return self._kvstore_obj._updater if self._update_on_kvstore \
            else self._updaters[0]

    def save_states(self, fname):
        """Write the optimizer's states and the optimizer (with its update
        count and learning-rate schedule) to ``fname``, from the store when
        the update runs there (ref: trainer.py:202 save_states).  The states
        are pickled objects of this package."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "wb") as fout:
            fout.write(self._states_updater().get_states(
                dump_optimizer=True))

    def load_states(self, fname):
        """Read what :meth:`save_states` wrote and resume from it (ref:
        trainer.py:218 load_states): every updater takes the states, which
        move to each weight's context at its next update, and the unpickled
        optimizer, rebound to this trainer's parameters.  Only a file this
        program (or one you trust) wrote: unpickling can run code."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            states = f.read()
        if self._update_on_kvstore:
            self._kvstore_obj._updater.set_states(states)
            self._optimizer = self._kvstore_obj._updater.optimizer
        else:
            for updater in self._updaters:
                updater.set_states(states)
            self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param
                                      in enumerate(self._params)}
