"""PythonModule and PythonLossModule: modules computed in plain Python
(counterpart of ``incubator_mxnet_tpu/module/python_module.py``; ref:
python/mxnet/module/python_module.py).

They let host code (a loss written in numpy, glue between networks) take a
place in a Module pipeline, typically inside a ``SequentialModule``,
without parameters or executors of their own.
"""
from __future__ import annotations

import logging

import numpy as np

from .. import ndarray as nd
from ..ndarray import NDArray
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A module without parameters whose forward is written in Python
    (ref: python_module.py class PythonModule)."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None
        self.params_initialized = False

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        pass

    def update(self):
        pass

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes = [(n, tuple(s)) for n, s in data_shapes]
        self._label_shapes = ([(n, tuple(s)) for n, s in label_shapes]
                              if label_shapes else None)
        self._output_shapes = self._compute_output_shapes()
        self.binded = True
        self.for_training = for_training

    def _compute_output_shapes(self):
        """One output of the first data shape; override for others (ref:
        python_module.py _compute_output_shapes)."""
        return [(self._output_names[0], tuple(self._data_shapes[0][1]))]

    def update_metric(self, eval_metric, labels):
        pass

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss head computed in Python: forward passes the scores through,
    backward gives the scores' gradient, by default that of softmax
    cross-entropy with integer labels (ref: python_module.py class
    PythonLossModule)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        assert out_grads is None, "PythonLossModule is a loss head"
        assert self.for_training
        ctx = self._scores.context
        if self._grad_func is not None:
            g = self._grad_func(self._scores, self._labels)
            if not isinstance(g, NDArray):
                g = nd.array(np.asarray(g), ctx=ctx)
            self._scores_grad = g
            return
        s = self._scores.asnumpy()
        e = np.exp(s - s.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        y = self._labels.asnumpy().astype(np.int64)
        p[np.arange(len(y)), y] -= 1.0
        self._scores_grad = nd.array(p, ctx=ctx)

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
