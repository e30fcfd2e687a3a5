"""mx.random namespace (counterpart of ``incubator_mxnet_tpu/random.py``;
ref: python/mxnet/random.py): ``seed`` and the samplers of
``nd.random``."""
from __future__ import annotations

from .random_state import seed  # noqa: F401
from .ndarray.random import (uniform, normal, gamma, exponential,  # noqa: F401
                             poisson, negative_binomial,
                             generalized_negative_binomial, multinomial,
                             shuffle)

__all__ = ["seed", "uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]
