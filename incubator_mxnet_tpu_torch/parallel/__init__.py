"""Parallel training (counterpart of ``incubator_mxnet_tpu/parallel``).

Meshes over contexts or over the ranks of a job (``make_mesh``,
``dist.worker_mesh``; axes ``"dp"``, ``"tp"``, ``"pp"``, ``"sp"``,
``"ep"``), their axis collectives (``mesh.dispatch_on_mesh``),
``DataParallelTrainer`` over meshes of ``"dp"`` and the other axes,
``ring_attention`` (sequence parallelism), ``PipelineTrainer`` (a GPipe
schedule), ``ExpertParallelMoE`` (expert parallelism), and ``dist``: the
bootstrap of a job ``tools/launch.py`` starts, its collectives and the
``dist_*`` KVStores, with ``ps``, the host parameter service of
``dist_async``.  Gradient compression waits for ROADMAP item 12.
"""
from .mesh import (Mesh, make_mesh, data_parallel_mesh, use_mesh,  # noqa: F401
                   current_mesh)
from .data_parallel import DataParallelTrainer, pure_optimizer  # noqa: F401
from . import mesh, dist  # noqa: F401
from .moe import ExpertParallelMoE  # noqa: F401
from .pipeline import PipelineTrainer  # noqa: F401
from .ring_attention import ring_attention, ring_attention_sharded  # noqa: F401
