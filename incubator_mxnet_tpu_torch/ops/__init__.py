"""Operator library of the port: importing it registers every op."""
from . import registry  # noqa: F401
from . import init_ops  # noqa: F401
from . import tensor  # noqa: F401
from . import math  # noqa: F401
from . import nn  # noqa: F401
from . import attention  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import random_ops  # noqa: F401
from . import linalg  # noqa: F401
