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

Gradients (``torch.autograd`` through a rollout, as ``jax.grad`` through
the JAX package's step) flow on both kernel routes, through the force VJP
kernels of ``ops/force_vjp.py`` with the Newton-3 schedule:

- exact: ``force_exact`` is wrapped in ``make_diff_accel`` and autograd
  differentiates the plain-torch integrators (``yoshida4`` included);
- sym: :class:`_SymStep` mirrors the JAX ``make_fused_sym_step``: its
  forward runs the fused kernels on copies, its backward differentiates
  the Verlet update with autograd and sends the force cotangent through
  ``force_vjp_sym``.  When nothing needs a gradient the step updates the
  state in place, as before.

``dt`` and ``G`` are Python floats or 0-d float32 tensors.  A tensor that
requires grad gets its gradient as in the JAX fused step's VJP: ``dt``'s
from autograd through the integrator, ``G``'s from the force VJP's Ḡ.  The
kernels always see ``float(dt)`` and ``float(G)`` (a CUDA tensor costs a
device sync there; a CPU tensor does not).
"""

from __future__ import annotations

from typing import Callable

import torch

from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.ops.cuda_force import force_exact, sym_step_
from nbody3d_tpu_torch.ops.force_torch import accel_direct
from nbody3d_tpu_torch.ops.force_vjp import force_vjp_sym, make_diff_accel, requires_grad
from nbody3d_tpu_torch.ops.integrate import apply_integrator, integrate_state, valid_mask
from nbody3d_tpu_torch.state import SimState

Scalar = float | torch.Tensor
StepFn = Callable[[SimState, Scalar, Scalar], SimState]

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
    if config.grad_precision not in ("precise", "fast"):
        # Both values run the same f32 VJP kernels (config.py).
        raise ValueError(f"unknown grad_precision {config.grad_precision!r}")


class _SymStep(torch.autograd.Function):
    """The fused sym step with a backward (``make_fused_sym_step``'s
    ``custom_vjp``).  ``opts = (eps2, b, n_real)``; ``dt`` and ``G`` are
    floats or 0-d tensors."""

    @staticmethod
    def forward(ctx, pos_mass, vel, accel, dt, G, opts):
        eps2, b, n_real = opts
        p, v, a = (t.detach().clone() for t in (pos_mass, vel, accel))
        sym_step_(p, v, a, float(dt), float(G), eps2=eps2, b=b, n_real=n_real)
        # The stored acceleration is the force at pos_mass, valid-masked:
        # what the backward needs.
        ctx.save_for_backward(pos_mass, vel, accel, a)
        ctx.dt, ctx.G, ctx.opts = dt, float(G), opts
        return p, v, a

    @staticmethod
    def backward(ctx, gp, gv, ga):
        pos_mass, vel, a_old, a_new = ctx.saved_tensors
        eps2, b, n_real = ctx.opts
        need_pm, need_dt, need_G = (ctx.needs_input_grad[i] for i in (0, 3, 4))
        ins = [t.detach().requires_grad_() for t in (pos_mass, vel, a_old, a_new)]
        dt = ctx.dt.detach().requires_grad_() if need_dt else ctx.dt
        with torch.enable_grad():
            outs = apply_integrator(
                "verlet", *ins, dt, valid_mask(pos_mass.shape[0], n_real, pos_mass.device)
            )
            # Autograd hands zeros for unused outputs (materialized grads).
            grads = torch.autograd.grad(outs, ins + [dt] if need_dt else ins, (gp, gv, ga))
        g_pm, g_v, g_aold, g_force = grads[:4]
        gdt = grads[4] if need_dt else None
        if not (need_pm or need_G):
            # The force cotangent reaches only pos_mass and G: a rollout's
            # first step, whose positions need no gradient, skips the force
            # VJP (as autograd skips it on the exact route).
            return None, g_v, g_aold, gdt, None, None
        pm_bar, g_bar = force_vjp_sym(
            pos_mass.detach(), ctx.G, g_force.contiguous(), eps2=eps2, b=b
        )
        return (g_pm + pm_bar if need_pm else None), g_v, g_aold, gdt, (g_bar if need_G else None), None


def make_step_fn(
    config: SimConfig, n_pad: int, n_real: int, device: torch.device | str
) -> StepFn:
    """Build ``step(state, dt, G) -> state`` for one device."""
    _check_supported(config)
    route = resolve_backend(config, device)
    eps2 = config.eps2

    if route == "plain":
        chunk = fit_block(n_pad, 256) if n_pad > 4096 else None

        def step(state: SimState, dt: Scalar, G: Scalar) -> SimState:
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
        # The VJP's tile: any divisor of n_pad serves (nt = 1 included).
        b_vjp = fit_block(n_pad, min(config.block_target, GPU_TILE), floor=1)
        accel = make_diff_accel(lambda pm, G: force_exact(pm, pm, G, eps2), eps2=eps2, b=b_vjp)

        def step(state: SimState, dt: Scalar, G: Scalar) -> SimState:
            return integrate_state(
                config.integrator, lambda pm: accel(pm, G), state, dt, n_real=n_real,
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

        opts = (eps2, b, n_real)

        def step(state: SimState, dt: Scalar, G: Scalar) -> SimState:
            p, v, a = state.pos_mass, state.vel, state.accel
            if torch.is_grad_enabled() and any(map(requires_grad, (p, v, a, dt, G))):
                return SimState(*_SymStep.apply(p, v, a, dt, G, opts), state.step + 1)
            sym_step_(p, v, a, float(dt), float(G), eps2=eps2, b=b, n_real=n_real)
            return SimState(p, v, a, state.step + 1)

        return step

    if mode == "fast":
        raise NotImplementedError(f"force_mode='fast': {_TODO_FAST}")
    raise ValueError(f"unknown force_mode {mode!r}")


def run_chunk(step_fn: StepFn, state: SimState, dt: Scalar, G: Scalar, k: int) -> SimState:
    """k steps in a row; the replacement for ``make_scan_fn``'s scan."""
    for _ in range(k):
        state = step_fn(state, dt, G)
    return state
