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
from . import context  # noqa: F401
from .context import Context, cpu, gpu, tpu, current_context  # noqa: F401

from . import ops  # noqa: F401
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
from . import gluon  # noqa: F401
from . import parallel  # noqa: F401
from . import models  # noqa: F401
from . import convert  # noqa: F401
from . import telemetry  # noqa: F401
from . import serving  # noqa: F401
