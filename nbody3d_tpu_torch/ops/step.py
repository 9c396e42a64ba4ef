"""One-device step construction: backend dispatch and the chunk loop.

``make_step_fn`` builds ``step(state, dt, G) -> state``; ``run_chunk``
runs k of them in a Python loop, which stands in for the JAX package's
jitted, state-donating ``lax.scan``: PyTorch runs eagerly, the state stays
on the device for the whole chunk, and the fused sym step updates it in
place.  ``dt`` and ``G`` are runtime scalars: changing them rebuilds
nothing.

Dispatch (``config.backend``, mirroring ``nbody3d_tpu/ops/step.py``):

- ``"jnp"``: the plain oracle (``ops/force_torch.py``) and the
  integrator, on any device.  The only way plain code runs on the card.
- ``"auto"`` (any device) and ``"pallas"`` (CUDA only): the kernel path.
  ``force_mode="exact"`` runs ``force_exact`` and the integrator;
  ``force_mode="sym"`` with ``integrator="verlet"``, ``fuse_epilogue`` and
  ``nt >= 2`` tiles runs the fused sym step.  On a CPU device the kernel
  wrappers run their plain twins, because the tensors lie on the CPU.
  Every other combination raises ``NotImplementedError`` naming its
  ROADMAP.md item; nothing falls back to plain code.
"""

from __future__ import annotations

from typing import Callable

import torch

from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.ops.cuda_force import force_exact, sym_step_
from nbody3d_tpu_torch.ops.force_torch import accel_direct
from nbody3d_tpu_torch.ops.integrate import integrate_state
from nbody3d_tpu_torch.state import SimState

StepFn = Callable[[SimState, float, float], SimState]

# Largest sym tile: one thread a body in a CUDA block.  block_target is
# read as a cap below this (its default 2048 is the JAX package's).
GPU_TILE = 256
# Padding granule of the kernel path: n_pad is a multiple of the tile, so
# the sym tiles always fit whole.
PAD_GRANULE = GPU_TILE

# Configurations of the JAX package that the port does not run yet.
_TODO_MESH = "ROADMAP.md queue 1 item 9 (mesh solvers)"
_TODO_FAST = "ROADMAP.md queue 2 item 8 (fast-mode kernels)"
_TODO_FUSED = "ROADMAP.md queue 2 item 8 (_fused_kernel_exact/_fused_kernel_fast)"
_TODO_UNFUSED_SYM = "ROADMAP.md queue 2 item 7 (unfused sym: _combine16_kernel)"


def fit_block(n: int, want: int, floor: int = 8) -> int:
    """Largest power-of-two-ish block <= want that divides n."""
    if n <= 0:
        raise ValueError(f"cannot fit a block into n={n}")
    b = min(want, n)
    while b > floor and n % b != 0:
        b //= 2
    if n % b != 0:
        raise ValueError(f"cannot fit a block into n={n} (want {want})")
    return b


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to run on; raises when it is CUDA and no card is there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested, but torch.cuda is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise NotImplementedError(f"device type {dev.type!r}: the port runs on 'cuda' or 'cpu'")
    return dev


def resolve_backend(config: SimConfig, device: torch.device | str) -> str:
    """``"kernels"`` (the hand-written kernels' wrappers) or ``"plain"``
    (the oracle), from ``config.backend`` and the device."""
    dev = torch.device(device)
    backend = config.backend
    if backend == "jnp":
        return "plain"
    if backend == "pallas" and dev.type != "cuda":
        raise ValueError("backend='pallas' runs the CUDA kernels and needs a CUDA device")
    if backend not in ("auto", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    return "kernels"


def pad_multiple(config: SimConfig, device: torch.device | str) -> int:
    """Padding granule: the GPU tile on the kernel path, 8 on the oracle."""
    return PAD_GRANULE if resolve_backend(config, device) == "kernels" else 8


def _check_supported(config: SimConfig) -> None:
    if config.method != "direct":
        raise NotImplementedError(f"method={config.method!r}: {_TODO_MESH}")
    if config.boundary != "isolated":
        raise NotImplementedError(f"boundary={config.boundary!r}: {_TODO_MESH}")
    if config.cosmology != "none":
        raise NotImplementedError(f"cosmology={config.cosmology!r}: {_TODO_MESH}")


def make_step_fn(
    config: SimConfig, n_pad: int, n_real: int, device: torch.device | str
) -> StepFn:
    """Build ``step(state, dt, G) -> state`` for one device."""
    _check_supported(config)
    route = resolve_backend(config, device)
    eps2 = config.eps2

    if route == "plain":
        chunk = fit_block(n_pad, 256) if n_pad > 4096 else None

        def step(state: SimState, dt: float, G: float) -> SimState:
            return integrate_state(
                config.integrator,
                lambda pm: accel_direct(pm, G, eps2=eps2, chunk=chunk),
                state, dt, n_real=n_real,
            )

        return step

    if config.fuse_integrate:
        raise NotImplementedError(f"fuse_integrate=True: {_TODO_FUSED}")
    mode = config.force_mode
    if mode == "exact":

        def step(state: SimState, dt: float, G: float) -> SimState:
            return integrate_state(
                config.integrator,
                lambda pm: force_exact(pm, pm, G, eps2),
                state, dt, n_real=n_real,
            )

        return step

    if mode == "sym":
        b = fit_block(n_pad, min(config.block_target, GPU_TILE))
        if not (config.integrator == "verlet" and config.fuse_epilogue and n_pad // b >= 2):
            raise NotImplementedError(
                f"sym with integrator={config.integrator!r}, "
                f"fuse_epilogue={config.fuse_epilogue}, nt={n_pad // b}: "
                f"only the fused verlet step with nt >= 2 is ported; {_TODO_UNFUSED_SYM}"
            )

        def step(state: SimState, dt: float, G: float) -> SimState:
            sym_step_(
                state.pos_mass, state.vel, state.accel, dt, G,
                eps2=eps2, b=b, n_real=n_real,
            )
            return SimState(state.pos_mass, state.vel, state.accel, state.step + 1)

        return step

    if mode == "fast":
        raise NotImplementedError(f"force_mode='fast': {_TODO_FAST}")
    raise ValueError(f"unknown force_mode {mode!r}")


def run_chunk(step_fn: StepFn, state: SimState, dt: float, G: float, k: int) -> SimState:
    """k steps in a row; the replacement for ``make_scan_fn``'s scan."""
    for _ in range(k):
        state = step_fn(state, dt, G)
    return state
