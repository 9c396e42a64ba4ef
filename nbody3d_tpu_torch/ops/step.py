"""One-device step construction: backend dispatch and the chunk loop.

``make_step_fn`` builds ``step(state, dt, G) -> state``; ``run_chunk``
runs k of them in a Python loop, which stands in for the JAX package's
jitted, state-donating ``lax.scan``: PyTorch runs eagerly, the state stays
on the device for the whole chunk, and the fused sym step updates it in
place.  ``dt`` and ``G`` are runtime scalars: changing them rebuilds
nothing.

Dispatch (``config.backend``, mirroring ``nbody3d_tpu/ops/step.py``):

- ``method="pm"`` and ``"p3m"`` (isolated or periodic): the mesh solvers
  of ``ops/pm.py`` and ``ops/p3m.py`` and the integrator.  On the kernel
  route they run ``mesh_deposit``, ``mesh_gather`` and (P3M)
  ``short_range`` (a backward also ``short_range_bwd``), in their
  periodic forms on the periodic box; on
  ``"jnp"`` their plain twins.  ``boundary="periodic"`` with
  ``method="direct"`` raises ``ValueError``, as in the JAX package.
- ``cosmology="eds"|"lcdm"``: the comoving kick-drift step of
  ``ops/expansion.py`` on the periodic mesh force of either route; an
  isolated boundary, ``method="direct"`` or an integrator other than
  Verlet raises the JAX package's ``ValueError``.

For ``method="direct"``:

- ``"jnp"``: the plain oracle (``ops/force_torch.py``) and the
  integrator, on any device.  The only way plain code runs on the card.
- ``"auto"`` (any device) and ``"pallas"`` (CUDA only): the kernel path,
  in the JAX package's order:

  1. ``force_mode="sym"`` with ``integrator="verlet"``, ``fuse_epilogue``,
     ``nt >= 2`` tiles and ``n_pad <= MACRO_MIN_N``: the fused sym step
     (``sym_step_``);
  2. any other ``"sym"`` (euler, yoshida4, ``fuse_epilogue=False``, one
     tile, or more than ``MACRO_MIN_N`` bodies; ``fuse_integrate`` is not
     read, as in JAX): the sym force of :func:`make_sym_accel_fn` and the
     integrator.  Up to ``MACRO_MIN_N`` that is ``accel_sym``
     (``sym_diag_prep`` -> ``sym_hops`` -> ``sym_combine``); above it the
     macro-tiled schedule ``accel_sym_macro``: ``accel_sym`` on each of
     ``m_chunks`` equal chunks and ``pair_sym`` on every unordered chunk
     pair, with the JAX package's chunk count;
  3. ``"exact"`` or ``"fast"`` with ``verlet``, a step that needs no
     gradient (grad mode off, or no input requiring grad): the one-launch
     ``fused_step_exact`` or ``fused_step_fast``, bit for bit item 4's
     force and the torch Verlet.  A step that needs one takes item 4's
     route, or raises under ``fuse_integrate=True``, as the JAX package's
     fused step has no gradient.  Without ``fuse_integrate`` a CUDA
     tensor ``dt`` takes item 4's route too (see below);
  4. ``"exact"`` or ``"fast"`` otherwise (euler, yoshida4, and the Verlet
     steps item 3 hands on): ``force_exact`` or ``force_fast`` (bf16
     weights on the tensor cores) and the integrator.

  On a CPU device the kernel wrappers run their plain twins, because the
  tensors lie on the CPU; nothing falls back to plain code.

Gradients (``torch.autograd`` through a rollout, as ``jax.grad`` through
the JAX package's step) flow on every route.  The mesh steps are plain
autograd over ``accel_p3m``/``accel_pm``, whose kernels sit in
``torch.autograd.Function``s (P3M's short range with the
``short_range_bwd`` kernel as its backward), in their periodic forms on
the periodic box.  The direct kernel routes go
through the force VJP kernels of ``ops/force_vjp.py`` with the Newton-3
schedule:

- exact, fast and the unfused sym force: ``force_exact``, ``force_fast``
  (also under item 3's Verlet steps when one needs a gradient) and the sym
  force (``accel_sym`` or ``accel_sym_macro``, whose
  ``pair_sym`` has no backward kernel in the JAX package either) are
  wrapped in ``make_diff_accel`` (the sym VJP
  kernels: the VJP of the ideal f32 pair math, as the JAX package pairs
  fast mode with it) and autograd differentiates the plain-torch
  integrators (``yoshida4`` included);
- the fused sym step: :class:`_SymStep` mirrors the JAX
  ``make_fused_sym_step``: its forward runs the fused kernels on copies,
  its backward differentiates the Verlet update with autograd and sends
  the force cotangent through ``force_vjp_sym``.  When nothing needs a
  gradient the step updates the state in place, as before;
- the fused exact and fast kernels have none, as the JAX
  ``fused_step_pallas`` has no VJP: such a step runs the composed route
  above, or raises under ``fuse_integrate=True``.

``dt`` and ``G`` are Python floats or 0-d float32 tensors.  A tensor that
requires grad gets its gradient as in the JAX fused step's VJP: ``dt``'s
from autograd through the integrator, ``G``'s from the force VJP's Ḡ.  The
kernels always see ``float(G)``, and the fused kernels ``float(dt)`` (a
CUDA tensor costs a device sync there; a CPU tensor does not), so a CUDA
tensor ``dt`` keeps item 3's steps on the composed route.
"""

from __future__ import annotations

from typing import Callable

import torch

from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.ops.cuda_force import (
    accel_sym, accel_sym_macro, force_exact, force_fast, fused_step_exact, fused_step_fast, sym_step_,
)
from nbody3d_tpu_torch.ops.force_torch import accel_direct
from nbody3d_tpu_torch.ops.force_vjp import force_vjp_sym, make_diff_accel, requires_grad
from nbody3d_tpu_torch.ops.integrate import apply_integrator, integrate_state, valid_mask
from nbody3d_tpu_torch.ops.p3m import accel_p3m
from nbody3d_tpu_torch.ops.pm import accel_pm
from nbody3d_tpu_torch.state import SimState
from nbody3d_tpu_torch.utils.profiling import span

Scalar = float | torch.Tensor
StepFn = Callable[[SimState, Scalar, Scalar], SimState]

# Largest sym tile: one thread a body in a CUDA block.  block_target is
# read as a cap below this (its default 2048 is the JAX package's).
GPU_TILE = 256
# Padding granule of the kernel path: n_pad is a multiple of the tile, so
# the sym tiles always fit whole.
PAD_GRANULE = GPU_TILE
# The JAX package's sym cap (its (nt, 16, B) accumulator and the (B, B)
# temporaries outgrow a TPU's VMEM above it): larger sym runs take the
# macro-tiled schedule.  The card has no such cap; the port keeps the
# threshold so that it runs the schedule the JAX package runs.
SYM_MAX_N = 768 * 1024
MACRO_MIN_N = SYM_MAX_N


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
    if config.method not in ("direct", "pm", "p3m"):
        raise ValueError(f"unknown method {config.method!r}")
    if config.boundary not in ("isolated", "periodic"):
        raise ValueError(f"unknown boundary {config.boundary!r}")
    if config.boundary == "periodic" and config.method not in ("pm", "p3m"):
        raise ValueError(
            "boundary='periodic' needs a mesh solver (method='pm'|'p3m'): the direct kernels sum bare "
            "pairs, which is ill-defined on the torus without an Ewald sum (ops/ewald.py has the O(N^2) "
            "oracle for validation only)"
        )
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
        with span("nbody3d.vjp"):
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


def macro_chunks(n_pad: int) -> int:
    """The macro schedule's chunk count: as few chunks of at most
    ``SYM_MAX_N`` bodies as divide ``n_pad`` evenly (the JAX loop)."""
    m_chunks = -(-n_pad // SYM_MAX_N)
    while n_pad % m_chunks != 0:
        m_chunks += 1
    return m_chunks


def make_sym_accel_fn(config: SimConfig, n_pad: int) -> Callable:
    """The Newton-3 force ``accel(pos_mass, G) -> (N, 4)`` on the kernel
    route (``make_sym_accel_fn`` of the JAX package): ``accel_sym`` up to
    ``MACRO_MIN_N`` bodies, above it ``accel_sym_macro`` over
    :func:`macro_chunks` chunks, each with the largest tile that fits it."""
    eps2, want = config.eps2, min(config.block_target, GPU_TILE)
    if n_pad <= MACRO_MIN_N:
        b = fit_block(n_pad, want)
        return lambda pm, G: accel_sym(pm, G, eps2=eps2, b=b)
    m_chunks = macro_chunks(n_pad)
    b = fit_block(n_pad // m_chunks, want)
    return lambda pm, G: accel_sym_macro(pm, G, eps2=eps2, b=b, m_chunks=m_chunks)


def make_mesh_accel_fn(config: SimConfig, n_real: int, route: str) -> Callable:
    """``accel(pos_mass, G) -> (N, 4)`` of ``config.method`` in {"pm",
    "p3m"}: the kernel wrappers on the ``"kernels"`` route, the plain twins
    on ``"plain"``.  Unlike the JAX package, PM follows the route too: on
    the card its CIC deposit and gather are the two mesh kernels at order
    2, and no plain code runs there."""
    backend = "jnp" if route == "plain" else "auto"
    box = dict(boundary=config.boundary, box_size=config.box_size, interlace=config.mesh_interlace)
    if config.method == "pm":

        def accel(pos_mass, G):
            return accel_pm(pos_mass, G, grid=config.pm_grid, eps2=config.eps2, n_real=n_real,
                            mesh_backend=backend, **box)

        return accel
    if config.method == "p3m":

        def accel(pos_mass, G):
            return accel_p3m(
                pos_mass, G, grid=config.pm_grid, eps2=config.eps2, n_real=n_real,
                sigma_cells=config.p3m_sigma_cells, rcut_sigmas=config.p3m_rcut_sigmas,
                block=config.p3m_block, nbr_k=config.p3m_nbr_k, heavy_k=config.p3m_heavy_k,
                backend=backend, **box,
            )

        return accel
    raise ValueError(f"make_mesh_accel_fn needs method='pm'|'p3m', got {config.method!r}")


def make_step_fn(
    config: SimConfig, n_pad: int, n_real: int, device: torch.device | str
) -> StepFn:
    """Build ``step(state, dt, G) -> state`` for one device; each step is
    one ``nbody3d.step`` span."""
    route_step = _route_step_fn(config, n_pad, n_real, device)

    def step(state: SimState, dt: Scalar, G: Scalar) -> SimState:
        with span("nbody3d.step"):
            return route_step(state, dt, G)

    return step


def _route_step_fn(config: SimConfig, n_pad: int, n_real: int, device: torch.device | str) -> StepFn:
    """The step of the route that ``config`` and ``device`` select."""
    _check_supported(config)
    route = resolve_backend(config, device)
    eps2 = config.eps2

    if config.cosmology != "none":
        # Comoving coordinates on an expanding background: the staggered
        # kick-drift of ops/expansion.py on the periodic mesh force.
        from nbody3d_tpu_torch.ops.expansion import make_cosmo_step_fn

        return make_cosmo_step_fn(config, n_pad, n_real, route)

    if config.method != "direct":
        return _integrated_step(config.integrator, make_mesh_accel_fn(config, n_real, route), n_real)

    if route == "plain":
        chunk = fit_block(n_pad, 256) if n_pad > 4096 else None
        return _integrated_step(
            config.integrator, lambda pm, G: accel_direct(pm, G, eps2=eps2, chunk=chunk), n_real
        )

    mode = config.force_mode
    if mode == "sym":
        b = fit_block(n_pad, min(config.block_target, GPU_TILE))
        if config.integrator == "verlet" and config.fuse_epilogue and n_pad <= MACRO_MIN_N and n_pad // b >= 2:
            return _fused_sym_step(eps2, b, n_real)
        accel = make_diff_accel(make_sym_accel_fn(config, n_pad), eps2=eps2, b=b)
        return _integrated_step(config.integrator, accel, n_real)

    if mode in ("exact", "fast"):
        force = force_exact if mode == "exact" else force_fast
        # The VJP's tile: any divisor of n_pad serves (nt = 1 included).
        b_vjp = fit_block(n_pad, min(config.block_target, GPU_TILE), floor=1)
        accel = make_diff_accel(lambda pm, G: force(pm, pm, G, eps2), eps2=eps2, b=b_vjp)
        composed = _integrated_step(config.integrator, accel, n_real)
        if config.integrator != "verlet":
            return composed
        fused = fused_step_exact if mode == "exact" else fused_step_fast
        return _fused_step(fused, eps2, n_real, None if config.fuse_integrate else composed)
    raise ValueError(f"unknown force_mode {mode!r}")


def _integrated_step(integrator: str, accel: Callable, n_real: int) -> StepFn:
    """``integrate_state`` over the force ``accel(pm, G)``."""

    def step(state: SimState, dt: Scalar, G: Scalar) -> SimState:
        return integrate_state(integrator, lambda pm: accel(pm, G), state, dt, n_real=n_real)

    return step


def _fused_sym_step(eps2: float, b: int, n_real: int) -> StepFn:
    """The fused sym Verlet step: in place without grad, :class:`_SymStep`
    with it."""
    opts = (eps2, b, n_real)

    def step(state: SimState, dt: Scalar, G: Scalar) -> SimState:
        p, v, a = state.pos_mass, state.vel, state.accel
        if torch.is_grad_enabled() and any(map(requires_grad, (p, v, a, dt, G))):
            return SimState(*_SymStep.apply(p, v, a, dt, G, opts), state.step + 1)
        sym_step_(p, v, a, float(dt), float(G), eps2=eps2, b=b, n_real=n_real)
        return SimState(p, v, a, state.step + 1)

    return step


def _fused_step(fused: Callable, eps2: float, n_real: int, composed: StepFn | None) -> StepFn:
    """``fused_step_exact`` or ``fused_step_fast`` into fresh state tensors:
    the same bits as ``composed``, the force wrapper and the torch Verlet,
    in one launch.  A step that needs a gradient, or whose ``dt`` is a
    CUDA tensor (the kernel takes a host float, and reading a device
    scalar waits for the card), runs ``composed``; without it
    (``fuse_integrate=True``) a gradient raises."""

    def step(state: SimState, dt: Scalar, G: Scalar) -> SimState:
        p, v, a = state.pos_mass, state.vel, state.accel
        if torch.is_grad_enabled() and any(map(requires_grad, (p, v, a, dt, G))):
            if composed is None:
                raise RuntimeError(
                    "fuse_integrate=True: the fused force+Verlet kernel has no gradient (nor has "
                    "the JAX package's fused_step_pallas); differentiate with fuse_integrate=False"
                )
            return composed(state, dt, G)
        if composed is not None and isinstance(dt, torch.Tensor) and dt.is_cuda:
            return composed(state, dt, G)
        out = fused(p, v, a, float(dt), float(G), eps2=eps2, n_real=n_real)
        return SimState(*out, state.step + 1)

    return step


def run_chunk(step_fn: StepFn, state: SimState, dt: Scalar, G: Scalar, k: int) -> SimState:
    """k steps in a row; the replacement for ``make_scan_fn``'s scan."""
    for _ in range(k):
        state = step_fn(state, dt, G)
    return state
