"""SequentialModule: modules chained so that each takes the outputs of the
one before (counterpart of
``incubator_mxnet_tpu/module/sequential_module.py``; ref:
python/mxnet/module/sequential_module.py).
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """A chain of modules; data shapes propagate through it.  Add the
    module that takes the labels with ``take_labels=True``, and one whose
    data names differ from its predecessor's output names with
    ``auto_wiring=True`` (ref: sequential_module.py class
    SequentialModule)."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self.params_initialized = False
        self.optimizer_initialized = False

    def add(self, module, **kwargs):
        """Append ``module``; returns self, so calls chain."""
        for key in kwargs:
            if key not in (self.META_TAKE_LABELS, self.META_AUTO_WIRING):
                raise ValueError("unknown meta %r" % key)
        self._modules.append(module)
        self._metas.append(dict(kwargs))
        self.binded = False
        self.params_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind each module on its predecessor's output shapes; every
        module after the first computes its input gradients."""
        if self.binded and not force_rebind:
            return
        if not self._modules:
            raise MXNetError("SequentialModule has no modules")
        self._label_shapes = label_shapes
        shapes = data_shapes
        takes_labels = False
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            if i > 0 and meta.get(self.META_AUTO_WIRING, False):
                shapes = [(name, tuple(shape)) for name, (_, shape)
                          in zip(module.data_names, shapes)]
            else:
                shapes = [(n, tuple(s)) for n, s in shapes]
            labels = meta.get(self.META_TAKE_LABELS, False)
            module.bind(data_shapes=shapes,
                        label_shapes=label_shapes if labels else None,
                        for_training=for_training,
                        inputs_need_grad=inputs_need_grad or i > 0,
                        force_rebind=force_rebind)
            takes_labels |= bool(labels)
            shapes = module.output_shapes
        if not takes_labels:
            self._label_shapes = None
        self.binded = True
        self.for_training = for_training

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing
                               or arg_params is not None,
                               force_init=force_init)
        self.params_initialized = True

    def get_params(self):
        arg, aux = {}, {}
        for module in self._modules:
            a, x = module.get_params()
            arg.update(a)
            aux.update(x)
        return arg, aux

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        for module in self._modules:
            module.set_params(arg_params, aux_params, allow_missing=True,
                              force_init=force_init, allow_extra=True)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        """Run the chain: each module's outputs are the next one's data."""
        assert self.binded
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            label = data_batch.label if self._metas[i + 1].get(
                self.META_TAKE_LABELS, False) else None
            batch = DataBatch(data=module.get_outputs(), label=label)

    def backward(self, out_grads=None):
        """Back through the chain, each module's input gradients the out
        gradients of the one before."""
        assert self.binded
        grads = out_grads
        for i in range(len(self._modules) - 1, -1, -1):
            self._modules[i].backward(out_grads=grads)
            if i == 0:
                break
            grads = self._modules[i].get_input_grads()

    def update(self):
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for module in self._modules:
            module.install_monitor(mon)
