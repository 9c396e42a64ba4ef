"""nbody3d_tpu_torch: the direct-sum N-body simulator on PyTorch and CUDA.

The port of ``nbody3d_tpu`` (JAX/Pallas) to one NVIDIA H100: the same
presets, config JSON, integrators and diagnostics, with the main path's
Pallas kernels rewritten as hand-written CUDA C++ for ``sm_90a``
(``csrc/``, built with nvcc on first launch).  It imports torch and numpy,
never jax and never ``nbody3d_tpu``.

    from nbody3d_tpu_torch import SimConfig, Simulation
    sim = Simulation.from_preset("two-galaxy", SimConfig(), device="cuda")
    sim.run(200, chunk=50)
"""

from nbody3d_tpu_torch.config import GalaxyConfig, SimConfig  # noqa: F401
from nbody3d_tpu_torch.engine import Simulation  # noqa: F401
from nbody3d_tpu_torch.state import SimState, init_state, pad_count, state_from_numpy, unpad  # noqa: F401

__version__ = "0.1.0"
