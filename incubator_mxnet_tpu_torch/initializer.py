"""Weight initializers (counterpart of ``incubator_mxnet_tpu/initializer.py``).

Same registry and ``InitDesc``-driven suffix dispatch as the reference,
and every initializer of the JAX build: ``Zero``, ``One``, ``Constant``,
``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``, ``MSRAPrelu``,
``Bilinear``, ``LSTMBias``, ``Load`` and ``Mixed``.  Random draws come
from the framework's per-device ``torch.Generator`` (``random_state``), so
they are reproducible per ``mx.random.seed`` but are not the JAX build's
numbers (ROADMAP trap A4).
"""
from __future__ import annotations

import json
import logging
import re

import numpy as np
import torch

from . import random_state

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "Load", "register", "create"]

_INIT_REGISTRY = {}


def register(klass):
    """ref: initializer.py register decorator (mx.init.register)."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _INIT_REGISTRY[name.lower()](**kwargs)


class InitDesc(str):
    """Name + attrs descriptor (ref: initializer.py class InitDesc)."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


def _randn(arr):
    g = random_state.generator(arr._data.device)
    return torch.randn(arr.shape, generator=g, device=arr._data.device)


def _rand_uniform(arr, low, high):
    g = random_state.generator(arr._data.device)
    u = torch.rand(arr.shape, generator=g, device=arr._data.device)
    return u * (high - low) + low


class Initializer(object):
    """Base initializer with suffix dispatch (ref: initializer.py:95)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """ref: initializer.py dumps — json [name, kwargs]."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        # an ``__init__`` attr (an Initializer, or a registered name) fills
        # the array directly, as in the reference; the instance itself is
        # used, so a seeded initializer's stream runs on across parameters
        init = desc.attrs.get("__init__")
        if init:
            create(init)._init_weight(desc, arr)
            return
        # suffix dispatch, parity with initializer.py __call__
        if desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias"):
            self._init_bias(desc, arr)
        elif desc.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif desc.endswith("beta"):
            self._init_beta(desc, arr)
        elif desc.endswith("min"):
            self._init_zero(desc, arr)
        elif desc.endswith("max"):
            self._init_one(desc, arr)
        elif desc.endswith("running_mean") or desc.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif desc.endswith("running_var") or desc.endswith("moving_var"):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_bias(self, _, arr):
        self._fill(arr, 0.0)

    def _init_gamma(self, _, arr):
        self._fill(arr, 1.0)

    def _init_beta(self, _, arr):
        self._fill(arr, 0.0)

    def _init_zero(self, _, arr):
        self._fill(arr, 0.0)

    def _init_one(self, _, arr):
        self._fill(arr, 1.0)

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_default(self, name, arr):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization is now "
            "limited to \"weight\", \"bias\", \"gamma\" (1.0), and \"beta\" (0.0). "
            "Please use mx.sym.Variable(init=mx.init.*) to set initialization "
            "pattern" % name)

    @staticmethod
    def _fill(arr, value):
        """Write ``value`` (a scalar, numpy array or tensor) into ``arr``,
        cast to its dtype."""
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if isinstance(value, torch.Tensor):
            arr._data.copy_(value)
        else:
            arr._data.fill_(value)


@register
class Zero(Initializer):
    """ref: initializer.py class Zero (alias 'zeros')."""

    def _init_weight(self, _, arr):
        self._fill(arr, 0.0)


@register
class One(Initializer):
    """ref: initializer.py class One (alias 'ones')."""

    def _init_weight(self, _, arr):
        self._fill(arr, 1.0)


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._fill(arr, self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale) (ref: initializer.py class Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._fill(arr, _rand_uniform(arr, -self.scale, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma) (ref: initializer.py class Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._fill(arr, _randn(arr) * self.sigma)


@register
class Orthogonal(Initializer):
    """A scaled matrix with orthonormal rows or columns (ref:
    initializer.py class Orthogonal): the SVD factor of a (out, in) draw,
    uniform in [-1, 1) or normal (``rand_type``), of the draw's shape."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        dev = arr._data.device
        g = random_state.generator(dev)
        if self.rand_type == "uniform":
            tmp = torch.empty((nout, nin), device=dev).uniform_(
                -1.0, 1.0, generator=g)
        else:
            tmp = torch.randn((nout, nin), generator=g, device=dev)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        self._fill(arr, (self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Xavier/Glorot (ref: initializer.py class Xavier — rnd_type
    uniform|gaussian, factor_type avg|in|out)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _scale(self, name, shape):
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to vector %s. "
                             "It requires at least 2D." % name)
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        return float(np.sqrt(self.magnitude / factor))

    def _init_weight(self, name, arr):
        scale = self._scale(name, arr.shape)
        if self.rnd_type == "uniform":
            self._fill(arr, _rand_uniform(arr, -scale, scale))
        elif self.rnd_type == "gaussian":
            self._fill(arr, _randn(arr) * scale)
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU nets (ref: initializer.py class
    MSRAPrelu): Gaussian Xavier with magnitude 2 / (1 + slope²)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__(rnd_type="gaussian", factor_type=factor_type,
                         magnitude=magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a (…, kh, kw) weight (ref:
    initializer.py class Bilinear), for UpSampling's bilinear mode."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        self._fill(arr, weight.astype(np.float32).reshape(shape))


@register
class LSTMBias(Initializer):
    """Zero bias but the forget gate's quarter, ``forget_bias`` (ref:
    initializer.py class LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype="float32")
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._fill(arr, b)

    # names end in "_bias": the same fill (the reference reaches this class
    # through the __init__ attribute, which calls _init_weight)
    _init_bias = _init_weight


class Load(object):
    """Values from a dict of arrays by name (``arg:``/``aux:`` prefixes
    dropped), ``default_init`` for the rest (ref: initializer.py Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        qualified_param_name = re.compile("^(arg:|aux:)")
        self.param = {qualified_param_name.sub("", name): arr
                      for name, arr in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            src = src.asnumpy() if hasattr(src, "asnumpy") else np.asarray(src)
            if tuple(arr.shape) != tuple(src.shape):
                raise ValueError(
                    "Parameter %s cannot be initialized from loading. Shape "
                    "mismatch, target %s vs loaded %s"
                    % (name, str(arr.shape), str(src.shape)))
            Initializer._fill(arr, np.ascontiguousarray(src))
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise ValueError(
                    "Cannot Initialize %s. Not found in loaded param and no "
                    "default Initializer is provided." % name)
            self.default_init(name, arr)


class Mixed(object):
    """The first initializer whose pattern matches the name (ref:
    initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("Mixed: %d patterns, %d initializers"
                             % (len(patterns), len(initializers)))
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            'Parameter name %s did not match any pattern. Consider adding a '
            '".*" pattern at the and with default Initializer.' % name)
