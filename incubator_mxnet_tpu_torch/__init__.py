"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of incubator_mxnet_tpu.

A second package beside the JAX build, with the same public surface for
the slices ported so far.  Tensors are ``torch.Tensor``s, every device is
an explicit ``torch.device``, every random draw comes from an explicit
``torch.Generator``, and each TPU kernel of the JAX build is a kernel
written by hand for Hopper (``csrc/``).  User kernels in CUDA C compile at
run time through NVRTC (``mx.rtc.CudaModule``).  The default context is the card,
``gpu(0)``; the CPU is used only when asked for with ``mx.cpu()``.

    import incubator_mxnet_tpu_torch as mx
    x = mx.nd.zeros((2, 3), ctx=mx.gpu(0))

The package imports neither JAX nor anything of ``incubator_mxnet_tpu``.
"""
__version__ = "0.1.0"

from .base import MXNetError  # noqa: F401
from . import config  # noqa: F401
from . import context  # noqa: F401
from .context import (Context, cpu, gpu, tpu, current_context,  # noqa: F401
                      num_devices)

from . import ops  # noqa: F401
from . import engine  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401  canonical alias, as in mxnet
from .ndarray import NDArray  # noqa: F401

from . import autograd  # noqa: F401
from . import operator  # noqa: F401
from . import rtc  # noqa: F401
from . import random  # noqa: F401
from . import random_state  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401  alias, as in mxnet
from .initializer import Xavier  # noqa: F401
from . import name  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import optimizer  # noqa: F401
from . import optimizer as opt  # noqa: F401  alias, as in mxnet
from . import kvstore  # noqa: F401
from . import kvstore as kv  # noqa: F401  alias, as in mxnet
from . import gluon  # noqa: F401
from . import parallel  # noqa: F401
from . import models  # noqa: F401
from . import convert  # noqa: F401
from . import telemetry  # noqa: F401
from . import serving  # noqa: F401
from . import attribute  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import io  # noqa: F401
from . import recordio  # noqa: F401
from . import image  # noqa: F401
from . import metric  # noqa: F401
from . import callback  # noqa: F401
from . import monitor  # noqa: F401
from .symbol import Symbol  # noqa: F401
from . import model  # noqa: F401
from . import module  # noqa: F401
from . import module as mod  # noqa: F401
from . import executor_manager  # noqa: F401
from . import rnn  # noqa: F401
from . import visualization  # noqa: F401
from . import visualization as viz  # noqa: F401  alias, as in mxnet
from . import profiler  # noqa: F401
from . import test_utils  # noqa: F401
from . import contrib  # noqa: F401

# settings read at import (MXTPU_PROFILER_AUTOSTART, MXTPU_SEED)
if config.get_bool("PROFILER_AUTOSTART"):
    import atexit as _atexit
    profiler.set_config(continuous_dump=True)
    profiler.set_state("run")
    _atexit.register(lambda: profiler.set_state("stop"))
if config.get_int("SEED") is not None:
    random.seed(config.get_int("SEED"))
