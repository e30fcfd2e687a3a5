"""Shared helpers of the zoo's factories: stamping spec-driven factories
into a module (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/_factories.py``), and the
error every factory raises for ``pretrained=True``."""
from __future__ import annotations

from ....base import MXNetError


def stamp_factory(module_globals, name, doc, builder, *args, **forced_kwargs):
    """Define ``module_globals[name]`` as a factory calling ``builder``.

    ``args`` are bound positionally (e.g. version/depth picked from a spec
    table); ``forced_kwargs`` override anything the caller passes, matching
    the historical behaviour of the ``_bn`` variants.
    """
    def ctor(**kwargs):
        kwargs.update(forced_kwargs)
        return builder(*args, **kwargs)
    ctor.__name__ = name
    ctor.__qualname__ = name
    ctor.__module__ = module_globals.get("__name__", __name__)
    ctor.__doc__ = doc
    module_globals[name] = ctor
    return ctor


def no_pretrained(name):
    """The error ``pretrained=True`` raises: the zoo's weight files are not
    in the repository and nothing is downloaded."""
    return MXNetError(
        "pretrained %s: the model zoo's weight files are not in the "
        "repository and nothing is downloaded; load weights with "
        "convert.load_numpy_params" % name)
