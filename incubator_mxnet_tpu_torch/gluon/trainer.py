"""Gluon Trainer (counterpart of ``incubator_mxnet_tpu/gluon/trainer.py``).

Applies an Optimizer to a set of Parameters after a recorded forward and
``backward()``: ``step(batch_size)`` scales the gradients by
``1 / batch_size`` and runs the optimizer's update on every parameter whose
``grad_req`` is not ``null`` (``_update``, :375).  The kvstore follows the
JAX build's rule (``kvstore.create_kvstore``, :754-782): one context and a
store that is not ``dist`` means no store, so there is nothing to reduce
(``_allreduce_grads``, :353, and ``update_on_kvstore`` have no work).
Stores across several devices or processes come with multi-GPU (ROADMAP
Queue A item 6) and raise until then; the JAX build's bucketed, overlapped,
quantized and elastic machinery is not ported.  ``save_states`` and
``load_states`` checkpoint the optimizer: its pickled state per parameter
(momentum, ...), with the optimizer itself, its ``num_update`` and its
``lr_scheduler``.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import optimizer as opt
from .parameter import ParameterDict, Parameter

__all__ = ["Trainer"]


def _check_no_kvstore(kvstore, num_device):
    """The JAX build's rule (kvstore.py create_kvstore) where it makes no
    store: ``None``, or a store that is not ``dist`` on one device.  Any
    other store raises until multi-GPU."""
    if kvstore is None:
        return
    if not isinstance(kvstore, str):
        raise TypeError("kvstore must be a str or None in the PyTorch port, "
                        "got %r" % (kvstore,))
    if num_device == 1 and "dist" not in kvstore:
        return
    raise MXNetError(
        "kvstore %r over %d devices is not ported yet: stores across devices "
        "and processes come with multi-GPU (ROADMAP Queue A item 6)"
        % (kvstore, num_device))


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
            raise MXNetError("gradient compression is not ported yet")
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore = kvstore
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
        """ref: trainer.py _init_kvstore."""
        _check_no_kvstore(self._kvstore, len(self._contexts))
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
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """ref: trainer.py update (the update without the reduce)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                upd(i, grad, arr)

    def save_states(self, fname):
        """Write the optimizer's states and the optimizer (with its update
        count and learning-rate schedule) to ``fname`` (ref: trainer.py:202
        save_states).  The states are pickled objects of this package."""
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

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
        for updater in self._updaters:
            updater.set_states(states)
        self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param
                                      in enumerate(self._params)}
