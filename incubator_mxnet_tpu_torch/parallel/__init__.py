"""Parallel training (counterpart of ``incubator_mxnet_tpu/parallel``).

This slice ports the one-device half: ``make_mesh`` over contexts and
``DataParallelTrainer``.  Meshes of several devices, collectives and the
sharded paths come with multi-GPU (ROADMAP Queue A item 7).
"""
from .mesh import Mesh, make_mesh  # noqa: F401
from .data_parallel import DataParallelTrainer, pure_optimizer  # noqa: F401
