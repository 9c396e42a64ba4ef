"""Multi-device direct stepping over ``torch.distributed``.

One process a device (NCCL on cards, gloo on the CPU); bodies sharded over
the ranks of a :class:`Mesh`; the ring, gather, ringsym and 2-D grid
exchange schedules of the JAX package's ``nbody3d_tpu/parallel`` around the
single device's kernels (``sharded.py``); ranks started by
:func:`launch.spawn` or ``torchrun``.
"""

from nbody3d_tpu_torch.parallel.mesh import Mesh, default_mesh, grid_mesh, mesh_info  # noqa: F401
from nbody3d_tpu_torch.parallel.sharded import (  # noqa: F401
    gather_state,
    make_sharded_diagnostics,
    make_sharded_step,
    shard_state,
)
