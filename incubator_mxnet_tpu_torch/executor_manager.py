"""The executor manager of the old model API (counterpart of
``incubator_mxnet_tpu/executor_manager.py``; ref:
python/mxnet/executor_manager.py).

``DataParallelExecutorManager`` predates the Module API; here it is a thin
front over ``module.executor_group.DataParallelExecutorGroup`` on one
context, with the helpers old scripts import.
"""
from __future__ import annotations

import logging

from .base import MXNetError
from .module.executor_group import DataParallelExecutorGroup

__all__ = ["_split_input_slice", "_check_arguments",
           "DataParallelExecutorManager"]


def _split_input_slice(batch_size, work_load_list):
    """Slices of a batch by workload (ref: executor_manager.py
    _split_input_slice); an empty slice raises."""
    total = sum(work_load_list)
    if total <= 0:
        raise ValueError("Invalid work_load_list")
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        end = batch_size if i == len(work_load_list) - 1 else \
            start + int(round(batch_size * w / total))
        if end > batch_size or end <= start:
            raise ValueError("Too many slices. Some splits are empty.")
        slices.append(slice(start, end))
        start = end
    return slices


def _check_arguments(symbol):
    """Reject duplicate argument or auxiliary names (ref:
    executor_manager.py _check_arguments)."""
    arg_names = symbol.list_arguments()
    if len(arg_names) != len(set(arg_names)):
        raise MXNetError("Find duplicated argument name: %s" % arg_names)
    aux_names = symbol.list_auxiliary_states()
    if len(aux_names) != len(set(aux_names)):
        raise MXNetError("Find duplicated auxiliary name: %s" % aux_names)


class DataParallelExecutorManager(object):
    """ref: executor_manager.py class DataParallelExecutorManager."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=logging, sym_gen=None):
        _check_arguments(symbol)
        self.symbol = symbol
        self.ctx = ctx if isinstance(ctx, list) else [ctx]
        self.logger = logger
        data_shapes = list(train_data.provide_data)
        label_shapes = list(train_data.provide_label or [])
        inputs = [d[0] for d in data_shapes] + [d[0] for d in label_shapes]
        self._param_names = param_names or [
            n for n in symbol.list_arguments() if n not in inputs]
        self._batch = None
        self.execgrp = DataParallelExecutorGroup(
            symbol, self.ctx, work_load_list, data_shapes, label_shapes,
            self._param_names, for_training=True, inputs_need_grad=False,
            logger=logger)

    @property
    def param_names(self):
        return self._param_names

    @property
    def aux_names(self):
        return self.symbol.list_auxiliary_states()

    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def load_data_batch(self, data_batch):
        self._batch = data_batch

    def forward(self, is_train=False):
        self.execgrp.forward(self._batch, is_train=is_train)

    def backward(self):
        self.execgrp.backward()

    def update_metric(self, metric, labels):
        self.execgrp.update_metric(metric, labels)
