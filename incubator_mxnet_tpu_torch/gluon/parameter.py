"""Gluon Parameter / ParameterDict (counterpart of
``incubator_mxnet_tpu/gluon/parameter.py``).

Same public surface for the inference and training slices: deferred shape
init, one array per context, ``cast``, loading from host arrays, and a
gradient buffer per array with ``grad_req`` ``write``, ``add`` or ``null``
over the autograd tape (``autograd.mark_variables``), ``lr_mult`` and
``wd_mult``, and ``ParameterDict.save``/``load`` in MXNet's ``.params``
format (``ndarray/utils.py``).  ``Constant`` is not ported yet.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError, dtype_name
from ..context import Context, current_context, cpu
from ..ndarray import NDArray
from .. import ndarray as _nd
from .. import autograd
from .. import initializer

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization (ref: parameter.py:36)."""


class Parameter(object):
    """A trainable parameter (ref: gluon/parameter.py class Parameter).

    Holds one NDArray per context.  ``shape`` entries of 0 are inferred on
    first forward (deferred init), matching the reference contract.
    """

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True, stype="default", grad_stype="default",
                 sharding=None):
        self._data = None   # OrderedDict[Context, NDArray]
        self._grad = None   # OrderedDict[Context, NDArray] or None
        self._ctx_list = None
        self._deferred_init = ()
        self.name = name
        # per dimension, the mesh axis it splits over, e.g. ("tp", None):
        # a DataParallelTrainer keeps such a parameter's master weights and
        # optimizer state split over that axis (the JAX build's
        # parameter.py:46-50)
        self.sharding = tuple(sharding) if sharding is not None else None
        # set by a layer that computes on its own shard of the parameter
        # (ExpertParallelMoE's experts): a trainer over ranks hands it this
        # rank's shard, not the gathered whole
        self.shardwise = False
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self._grad_req = None
        self.grad_req = grad_req
        self.init = init
        # kept as the JAX build keeps them (its parameter.py:62-63): the
        # data and gradient stay dense, and the Trainer pulls such a
        # parameter plainly
        self._stype = stype
        self._grad_stype = grad_stype

    def __repr__(self):
        s = "Parameter {name} (shape={shape}, dtype={dtype})"
        return s.format(name=self.name, shape=self.shape, dtype=self.dtype)

    # -- grad_req ----------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        """ref: parameter.py grad_req — ``null`` drops the grad buffers;
        ``write`` or ``add`` (re)makes them once the data exists."""
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be one of 'write', 'add', or "
                             "'null', but got '%s'" % req)
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null" and self._grad is not None:
            self._grad = None
            for d in self._data.values():
                d._grad = None
                d._grad_req = "null"
                if d._data.grad_fn is None:
                    d._data.requires_grad_(False)   # ops on it record nothing
        elif self._data is not None:
            self._init_grad()

    # -- helpers -----------------------------------------------------------
    def _check_and_get(self, arr_dict, ctx):
        if arr_dict is not None:
            if ctx is None:
                if len(arr_dict) == 1:
                    return list(arr_dict.values())[0]
                ctx = current_context()
            if ctx in arr_dict:
                return arr_dict[ctx]
            raise RuntimeError(
                "Parameter %s was not initialized on context %s. "
                "It was only initialized on %s." % (
                    self.name, str(ctx), str(self._ctx_list)))
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter %s has not been initialized yet because initialization "
                "was deferred. Actual initialization happens during the first "
                "forward pass. Please pass one batch of data through the network "
                "before accessing Parameters." % self.name)
        raise RuntimeError(
            "Parameter %s has not been initialized. Note that you should initialize "
            "parameters and create Trainer with Block.collect_params() instead of "
            "Block.params because the later does not include Parameters of "
            "nested child Blocks" % self.name)

    def _load_init(self, data: np.ndarray, ctx):
        """(Re-)initialize from a host array (ref: parameter.py _load_init):
        in place when the parameter already has data on ``ctx`` (or ``ctx``
        is None), else on ``ctx``.  Raises ``ValueError`` on a shape or dtype
        the parameter cannot take."""
        if self.shape:
            if len(self.shape) != data.ndim or any(
                    s not in (0, d) for s, d in zip(self.shape, data.shape)):
                raise ValueError(
                    "Failed loading Parameter '%s': shape incompatible, "
                    "expected %s vs given %s" % (self.name, str(self.shape),
                                                  str(data.shape)))
        if dtype_name(self.dtype) != dtype_name(data.dtype):
            raise ValueError(
                "Failed loading Parameter '%s': dtype incompatible, expected "
                "%s vs given %s" % (self.name, dtype_name(self.dtype),
                                    dtype_name(data.dtype)))
        self.shape = tuple(data.shape)
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is not None and (ctx is None
                                       or list(ctx) == self._ctx_list):
            # overwrite in place: the arrays keep their identity, grad
            # buffers and tape marks, and what holds them sees the values
            src = torch.from_numpy(np.array(data))
            for arr in self._data.values():
                with torch.no_grad():
                    arr._data.copy_(src)
            return
        if ctx is None:
            ctx = (self._deferred_init[1] if self._deferred_init
                   else self._ctx_list or [current_context()])
        self._deferred_init = ()
        self._init_impl(data, ctx)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        self._deferred_init = ()
        if isinstance(init, str):
            init = initializer.create(init)
        if not self.shape or np.prod(self.shape) <= 0:
            raise ValueError(
                "Cannot initialize Parameter '%s' because it has invalid shape: "
                "%s. Please specify in_units, in_channels, etc for `Block`s."
                % (self.name, str(self.shape)))
        data = _nd.empty(self.shape, dtype=self.dtype, ctx=cpu())
        # the __init__ attr routes straight to the param's own initializer;
        # otherwise default_init's suffix dispatch runs
        attrs = {"__init__": init} \
            if isinstance(init, initializer.Initializer) else {}
        initializer.create(default_init)(
            initializer.InitDesc(self.name, attrs), data)
        self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        self._ctx_list = list(ctx_list)
        self._data = OrderedDict()
        for ctx in self._ctx_list:
            self._data[ctx] = data.copyto(ctx) if isinstance(data, NDArray) \
                else _nd.array(data, ctx=ctx, dtype=self.dtype)
        self._init_grad()

    def _init_grad(self):
        """A zero grad buffer per array, of its dtype, marked on the tape by
        ``grad_req`` (ref: parameter.py:189 _init_grad)."""
        if self.grad_req == "null":
            self._grad = None
            return
        self._grad = OrderedDict()
        for ctx, d in self._data.items():
            g = NDArray(torch.zeros_like(d._data.detach()), ctx=ctx)
            self._grad[ctx] = g
            autograd.mark_variables([d], [g], self.grad_req)

    # -- public API --------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """ref: gluon/parameter.py Parameter.initialize."""
        if default_init is None:
            default_init = initializer.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if init is None:
            init = default_init if self.init is None else self.init
        self._deferred_init = (init, ctx, default_init)
        if self.shape is None or np.prod(self.shape) <= 0:
            if self._allow_deferred_init:
                return
            self._deferred_init = ()
            raise ValueError("Cannot initialize Parameter '%s' because it has "
                             "invalid shape: %s." % (self.name, str(self.shape)))
        self._finish_deferred_init()

    def set_data(self, data):
        """Write ``data`` (an NDArray or a host array) into every copy
        (ref: parameter.py set_data)."""
        if self._data is None:
            raise RuntimeError("Parameter '%s' has not been initialized"
                               % self.name)
        src = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(np.asarray(data))
        self.shape = tuple(src.shape)
        for arr in self._data.values():
            with torch.no_grad():
                arr._data.copy_(src)

    def data(self, ctx=None):
        """Returns this parameter on one context (ref: parameter.py data)."""
        return self._check_and_get(self._data, ctx)

    def list_data(self):
        """Every copy, by context (ref: parameter.py list_data)."""
        if self._data is None:
            self._check_and_get(None, None)   # raises why there is no data
        return list(self._data.values())

    def _grads(self):
        """The grad buffers by context; raises where there are none."""
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' "
                "because grad_req='null'" % self.name)
        if self._grad is None:
            self._check_and_get(None, None)   # raises why there is no data
        return self._grad

    def grad(self, ctx=None):
        """The grad buffer on one context (ref: parameter.py:271 grad)."""
        return self._check_and_get(self._grads(), ctx)

    def list_grad(self):
        """Every grad buffer, by context (ref: parameter.py:278 list_grad)."""
        return list(self._grads().values())

    def zero_grad(self):
        """Fill every grad buffer with zeros (ref: parameter.py:292)."""
        if self._grad is None:
            return
        with torch.no_grad():
            for g in self._grad.values():
                g._data.zero_()

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise RuntimeError("Parameter '%s' has not been initialized" % self.name)
        return self._ctx_list

    def cast(self, dtype):
        """ref: parameter.py cast."""
        self.dtype = dtype
        if self._data is None:
            return
        self._data = OrderedDict(
            (ctx, d.astype(dtype)) for ctx, d in self._data.items())
        self._init_grad()


class Constant(Parameter):
    """A non-trainable constant (ref: gluon/parameter.py class Constant):
    ``grad_req`` ``null``, filled from ``value`` by an initializer
    registered as ``Constant_<name>``, so that its ``dumps()`` round-trips
    through ``initializer.create``."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = _nd.array(value, ctx=cpu())
        self.value = value

        class Init(initializer.Initializer):
            def _init_weight(self, _, arr):
                arr._data.copy_(value._data)
        Init.__name__ = "Constant_" + name
        initializer._INIT_REGISTRY[Init.__name__.lower()] = Init

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=Init())


def _attr_equal(a, b):
    """Attribute equivalence for Parameter reconciliation: initializer
    instances compare by configuration (dumps), not identity."""
    if a == b:
        return True
    if isinstance(a, initializer.Initializer) and \
            isinstance(b, initializer.Initializer):
        return a.dumps() == b.dumps()
    return False


class ParameterDict(object):
    """Prefix-scoped dict of Parameters (ref: gluon/parameter.py:560)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __getitem__(self, key):
        return self._params[key]

    def __repr__(self):
        s = "{name}(\n{content}\n)"
        name = self._prefix + " " if self._prefix else ""
        return s.format(name=name, content="\n".join(
            "  " + repr(v) for v in self.values()))

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._shared._params[name]
        return None

    def get(self, name, **kwargs):
        """Get-or-create (ref: parameter.py get); an existing parameter's
        zero (unknown) shape dims are filled from a given ``shape``."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        shape = kwargs.pop("shape", None)
        if shape is not None and param.shape is not None:
            if len(shape) != len(param.shape) or any(
                    a != b and a * b != 0 for a, b in zip(shape, param.shape)):
                raise ValueError("Cannot retrieve Parameter '%s': shape %s "
                                 "does not match stored %s"
                                 % (name, shape, param.shape))
            param.shape = tuple(max(a, b) for a, b in zip(shape, param.shape))
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif v is not None and not _attr_equal(v, existing):
                raise ValueError(
                    "Cannot retrieve Parameter '%s' because desired attribute "
                    "does not match with stored for attribute '%s': desired "
                    "'%s' vs stored '%s'." % (name, k, str(v), str(existing)))
        return param

    def update(self, other):
        """ref: parameter.py ParameterDict.update."""
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    "Cannot update self with other because they have different "
                    "Parameters with the same name '%s'" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, force_reinit=False):
        """ref: parameter.py ParameterDict.initialize."""
        if init is None:
            init = initializer.Uniform()
        for _, v in self.items():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        """ref: parameter.py:460 ParameterDict.zero_grad."""
        for v in self.values():
            v.zero_grad()

    def setattr(self, name, value):
        """Set an attribute (``grad_req``, ``lr_mult``, ...) on every
        parameter (ref: parameter.py ParameterDict.setattr)."""
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every parameter's data (its first context's) as a
        ``.params`` file, each name without ``strip_prefix`` (ref:
        parameter.py ParameterDict.save)."""
        from ..ndarray import save as nd_save
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with '%s'."
                    % (strip_prefix, param.name, strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = param.list_data()[0]
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load a ``.params`` file into these parameters (ref: parameter.py
        ParameterDict.load): a name's ``arg:``/``aux:`` prefix is dropped and
        ``restore_prefix`` put in front.  An initialized parameter is
        overwritten in place on its context (BatchNorm's running statistics
        too); one not yet initialized is initialized on ``ctx``."""
        from ..ndarray.utils import HostSparse, load_host
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise ValueError(
                        "restore_prefix is '%s' but Parameters name '%s' "
                        "does not start with '%s'"
                        % (restore_prefix, name, restore_prefix))
        lprefix = len(restore_prefix)
        with open(filename, "rb") as f:
            loaded = load_host(f.read())
        if not isinstance(loaded, dict):
            raise ValueError("'%s' holds unnamed arrays; ParameterDict.load "
                             "needs a named .params file" % filename)
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise ValueError("Parameter '%s' is missing in file '%s'"
                                     % (name[lprefix:], filename))
        for name, value in arg_dict.items():
            if isinstance(value, HostSparse):
                value = value.todense()
            if name not in self._params:
                if not ignore_extra:
                    raise ValueError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in ParameterDict" % (name[lprefix:], filename))
                continue
            self[name]._load_init(value, ctx)
