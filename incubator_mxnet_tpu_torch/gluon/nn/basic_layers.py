"""Basic Gluon layers (counterpart of ``incubator_mxnet_tpu/gluon/nn/basic_layers.py``).

``Sequential`` :21, ``HybridSequential`` :53, ``Dense`` :82,
``Activation`` :137, ``Dropout`` :155, ``BatchNorm`` :171,
``InstanceNorm`` :255, ``LayerNorm`` :287, ``Embedding`` :320, ``Flatten``
:343, ``Lambda`` :353 and ``HybridLambda`` :379, with the same parameter
naming.
"""
from __future__ import annotations

import numpy as np
import torch

from ..block import Block, HybridBlock
from ... import autograd, initializer
from ...base import dtype_name

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "InstanceNorm", "LayerNorm", "Embedding",
           "Flatten", "Lambda", "HybridLambda"]


def _init(spec):
    return initializer.create(spec) if isinstance(spec, str) else spec


class Sequential(Block):
    """Stack of Blocks run in order (ref: basic_layers.py class
    Sequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join("  ({key}): {block}".format(key=key, block=block)
                           for key, block in enumerate(self._children))
        return s.format(name=self.__class__.__name__, modstr=modstr)

    def __getitem__(self, key):
        return self._children[key]

    def __len__(self):
        return len(self._children)


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks (ref: basic_layers.py class HybridSequential)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children:
            x = block(x)
        return x


class Dense(HybridBlock):
    """Fully-connected layer y = act(x·Wᵀ + b)
    (ref: basic_layers.py class Dense → FullyConnected op)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None, bias_initializer="zeros",
                 in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get("weight", shape=(units, in_units),
                                          dtype=dtype,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(units,), dtype=dtype,
                                            init=_init(bias_initializer),
                                            allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _pre_infer(self, x):
        if self.weight.shape and self.weight.shape[1] == 0:
            in_units = int(np.prod(x.shape[1:])) if self._flatten else x.shape[-1]
            self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            act = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        else:
            act = F.FullyConnected(x, weight, bias, no_bias=False,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        if self.act is not None:
            act = self.act(act)
        return act


class Activation(HybridBlock):
    """ref: basic_layers.py class Activation → Activation op."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Dropout(HybridBlock):
    """Inverted dropout in training (ref: basic_layers.py class Dropout →
    Dropout op): each element kept with probability 1 - rate and scaled by
    1 / (1 - rate); ``axes`` share one draw along them.  In predict mode
    the input passes unchanged and nothing is drawn."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return "{name}(p = {_rate}, axes={_axes})".format(
            name=self.__class__.__name__, _rate=self._rate, _axes=self._axes)


class BatchNorm(HybridBlock):
    """Batch normalization with moving statistics (ref: basic_layers.py
    class BatchNorm).  The layer's defaults (``epsilon=1e-5``,
    ``momentum=0.9``, ``scale=True``, i.e. ``fix_gamma=False``) differ from
    the op's.  In training (``autograd.is_training()``, not
    ``use_global_stats``) each call blends the batch's f32 statistics into
    ``running_mean`` and ``running_var`` in place, ``m·running + (1 -
    m)·batch``, with recording paused; in predict mode they stay.  A
    trainer that shadows the parameters (``_trace_params``) gets the write
    in its own tensors."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self._momentum = momentum
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=_init(gamma_initializer),
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=_init(beta_initializer),
                                    allow_deferred_init=True,
                                    differentiable=center)
        self.running_mean = self.params.get(
            "running_mean", grad_req="null", shape=(in_channels,),
            init=_init(running_mean_initializer), allow_deferred_init=True,
            differentiable=False)
        self.running_var = self.params.get(
            "running_var", grad_req="null", shape=(in_channels,),
            init=_init(running_variance_initializer),
            allow_deferred_init=True, differentiable=False)

    def _pre_infer(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            if p.shape == (0,):
                p.shape = (c,)

    def cast(self, dtype):
        """float16 keeps the layer in f32 (ref: basic_layers.py:224-227)."""
        if dtype_name(dtype) == "float16":
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        y, batch_mean, batch_var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, output_mean_var=True,
            **self._kwargs)
        if autograd.is_training() and not self._kwargs["use_global_stats"]:
            m = self._momentum
            with autograd.pause(), torch.no_grad():
                for run, batch in ((running_mean, batch_mean),
                                   (running_var, batch_var)):
                    r = run._data
                    r.copy_(m * r + (1 - m) * batch._data)
        return y

    def __repr__(self):
        in_channels = self.gamma.shape[0]
        return "{name}({content}, in_channels={in_channels})".format(
            name=self.__class__.__name__, in_channels=in_channels,
            content=", ".join("=".join([k, v.__repr__()])
                              for k, v in self._kwargs.items()))


class InstanceNorm(HybridBlock):
    """ref: basic_layers.py class InstanceNorm → InstanceNorm op (each
    sample and channel over its spatial axes); gamma is trained only with
    ``scale=True``, beta with ``center=True``."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"eps": epsilon}
        self._axis = axis
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=_init(gamma_initializer),
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=_init(beta_initializer),
                                    allow_deferred_init=True)

    def _pre_infer(self, x):
        c = x.shape[1]
        for p in (self.gamma, self.beta):
            if p.shape == (0,):
                p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, **self._kwargs)


class LayerNorm(HybridBlock):
    """Layer normalization (ref: src/operator/nn/layer_norm.cc)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon}
        self._axis = axis
        self.gamma = self.params.get("gamma",
                                     grad_req="write" if scale else "null",
                                     shape=(in_channels,),
                                     init=_init(gamma_initializer),
                                     allow_deferred_init=True)
        self.beta = self.params.get("beta",
                                    grad_req="write" if center else "null",
                                    shape=(in_channels,),
                                    init=_init(beta_initializer),
                                    allow_deferred_init=True)

    def _pre_infer(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta):
            if p.shape == (0,):
                p.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, **self._kwargs)


class Embedding(HybridBlock):
    """Index → vector lookup (ref: basic_layers.py class Embedding →
    Embedding op, which clamps out-of-range ids)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        self.weight = self.params.get("weight", shape=(input_dim, output_dim),
                                      init=weight_initializer, dtype=dtype,
                                      allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)


class Flatten(HybridBlock):
    """ref: basic_layers.py class Flatten → Flatten op."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return self.__class__.__name__


def _named_function(function, where):
    """(callable, name) for a ``Lambda``'s function: a name in ``nd`` or a
    callable."""
    if isinstance(function, str):
        from ... import ndarray as nd
        if not hasattr(nd, function):
            raise ValueError("Function name %s is not found in ndarray."
                             % function)
        return getattr(nd, function), function
    if callable(function):
        return function, function.__name__
    raise ValueError("Unrecognized function in %s: %r of type %s"
                     % (where, function, type(function)))


class Lambda(Block):
    """A function as a Block (ref: basic_layers.py class Lambda):
    ``forward(*args)`` calls it; a string names an ``nd`` function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl, self._func_name = _named_function(function,
                                                           "lambda")

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "{name}({function})".format(name=self.__class__.__name__,
                                           function=self._func_name)


class HybridLambda(HybridBlock):
    """A function as a HybridBlock (ref: basic_layers.py class
    HybridLambda): a callable is called as ``function(F, x, *args)``; a
    string names an ``nd`` function, called on the arrays alone."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        func, self._func_name = _named_function(function, "hybrid lambda")
        if isinstance(function, str):
            self._func = lambda F, *args: func(*args)
        else:
            self._func = func

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "{name}({function})".format(name=self.__class__.__name__,
                                           function=self._func_name)
