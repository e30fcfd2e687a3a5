"""Module API (counterpart of ``incubator_mxnet_tpu/module/__init__.py``;
ref: python/mxnet/module/__init__.py)."""
from .base_module import BaseModule, BatchEndParam  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .sequential_module import SequentialModule  # noqa: F401
from .python_module import PythonModule, PythonLossModule  # noqa: F401
from .executor_group import DataParallelExecutorGroup  # noqa: F401
