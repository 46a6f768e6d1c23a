"""The lanes over several devices and processes.

Counterpart of ``libzling_tpu/parallel``: ``mesh_encode`` (blocks sharded
over devices, the MTF state carried device to device), ``mesh_decode``
(chunks sharded over devices, the resolve on the first) and, over
``torch.distributed``, ``init_distributed``, ``distributed_encode`` and
``distributed_decode``.
"""

from .decode_mesh import mesh_decode  # noqa: F401
from .distributed import (  # noqa: F401
    distributed_decode,
    distributed_encode,
    init_distributed,
)
from .mesh import make_mesh, mesh_encode  # noqa: F401

__all__ = ["make_mesh", "mesh_encode", "mesh_decode", "init_distributed",
           "distributed_encode", "distributed_decode"]
