"""Comoving coordinates on an expanding background (EdS and flat ΛCDM):
``nbody3d_tpu/ops/expansion.py``.

Positions ``x`` are comoving on the torus and ``SimState.vel`` holds the
canonical momentum ``w = a² dx/dt``.  The periodic mesh force is the
comoving ``g`` (its FFT solve drops the DC mode, which is the background
subtraction), so the motion is ``dx/dt = w / a²`` and ``dw/dt = g / a``:
a staggered kick-drift with the window integrals ``∫ dt/a`` (kick) and
``∫ dt/a²`` (drift) for factors.  A cosmological constant is homogeneous,
so ΛCDM changes the background ``a(t)`` alone, never the force.

- EdS: ``H_i = sqrt(8πGρ̄/3)`` at ``a = 1``, ``t_i = 2/(3 H_i)``,
  ``a(t) = (t/t_i)^(2/3)``; the window integrals in closed form, through
  ``expm1``/``log1p`` so that a window much shorter than ``t`` loses no
  precision.
- ΛCDM (``omega_lambda`` = Ω_Λ at ``a = 1``, Ω_m = 1 - Ω_Λ):
  ``a(t) = (Ω_m/Ω_Λ)^(1/3) sinh^(2/3)(s t)`` with ``s = 1.5 sqrt(Ω_Λ) H_i``
  and ``H_i² = 8πGρ̄/(3Ω_m)``; the window integrals by 8-point
  Gauss-Legendre quadrature of that closed form.

Momentum lives at half steps: step ``n`` kicks over ``[t_n - dt/2, t_n +
dt/2]`` (step 0 over ``[t_i, t_i + dt/2]``, the opening half-kick) and
drifts over ``[t_n, t_n + dt]``, ``t_n = t_i + n·dt``.  One force
evaluation a step; ``state.accel`` keeps the last ``g``.

The background scalars are computed as the JAX package computes them in
its trace: in float32, in its order of operations, each window passed as
(start, length), and ``ρ̄`` from the live state's masses every step.  On
a card they stay on the device: the kick's and the drift's windows go
through one length-2 vector (ΛCDM: one ``(2, 8)`` array of quadrature
nodes), about twenty small launches a step and no host sync.  ``dt``,
``G`` and the step count enter as host floats, so the step has no
gradient by ``dt`` or ``G`` (a request raises); autograd flows by the
state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.state import SimState

__all__ = [
    "eds_hubble_init",
    "eds_scale_factor",
    "kick_factor",
    "drift_factor",
    "lcdm_scale_factor",
    "make_background",
    "comoving_update",
    "cosmic_time_and_scale",
    "validate_cosmo_config",
    "make_cosmo_step_fn",
]

_C_HUBBLE = 8.0 * math.pi / 3.0


def _f32(x) -> torch.Tensor:
    """``x`` as a float32 tensor (a tensor passes through)."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.float32(x))


def _times(c: float, x):
    """``c * x`` as the JAX trace computes a Python constant times a traced
    float32: ``f32(c) * x``, one rounding.  A host ``x`` stays on the host
    (a NumPy float32 product, the same rounding)."""
    if isinstance(x, torch.Tensor):
        return c * x
    return float(np.float32(c) * np.float32(x))


def eds_hubble_init(G, rho_bar) -> torch.Tensor:
    """Friedmann: ``H_i = sqrt(8πGρ̄/3)`` at ``a = 1``."""
    return torch.sqrt(_times(_C_HUBBLE, G) * _f32(rho_bar))


def eds_scale_factor(t, t_i):
    """``a(t) = (t/t_i)^(2/3)`` (EdS, ``a(t_i) = 1``)."""
    return (t / t_i) ** (2.0 / 3.0)


def _eds_window(t1, dtw, t_i, expo, sign, denom):
    """``∫_{t1}^{t1+dtw} dt / a^p`` for EdS, the JAX package's
    ``kick_factor`` (p = 1: ``expo = -2/3``, ``sign = 1``, ``denom = 3``)
    and ``drift_factor`` (p = 2: ``-4/3``, ``-1``, ``-3``) term for term:
    ``3 t1 · (t1/t_i)^expo · sign·expm1(log1p(dtw/t1) / denom)``.  Tensors
    of the constants evaluate both windows in one pass."""
    return (3.0 * t1) * (t1 / t_i) ** expo * (sign * torch.expm1(torch.log1p(dtw / t1) / denom))


_KICK, _DRIFT = (-2.0 / 3.0, 1, 3), (-4.0 / 3.0, -1, -3)


def kick_factor(t1, dtw, t_i) -> torch.Tensor:
    """``∫_{t1}^{t1+dtw} dt/a = 3 t_i^(2/3) ((t1+dtw)^(1/3) - t1^(1/3))``,
    as ``3 t1 (t1/t_i)^(-2/3) ((1 + dtw/t1)^(1/3) - 1)`` from the window's
    length, which keeps full f32 precision at ``dtw << t1``."""
    return _eds_window(_f32(t1), _f32(dtw), _f32(t_i), *_KICK)


def drift_factor(t1, dtw, t_i) -> torch.Tensor:
    """``∫_{t1}^{t1+dtw} dt/a² = 3 t_i^(4/3) (t1^(-1/3) - (t1+dtw)^(-1/3))``,
    through ``-expm1(-log1p(dtw/t1)/3)``."""
    return _eds_window(_f32(t1), _f32(dtw), _f32(t_i), *_DRIFT)


def lcdm_scale_factor(t, t_i, omega_lambda: float):
    """Flat ΛCDM: ``a(t) = (Ω_m/Ω_Λ)^(1/3) sinh^(2/3)(s t)`` with
    ``s t_i = asinh(sqrt(Ω_Λ/Ω_m))``."""
    om = 1.0 - omega_lambda
    s_ti = math.asinh(math.sqrt(omega_lambda / om))
    pref = (om / omega_lambda) ** (1.0 / 3.0)
    return pref * torch.sinh(s_ti * (_f32(t) / _f32(t_i))) ** (2.0 / 3.0)


# 8-point Gauss-Legendre nodes and weights on [0, 1] (exact to degree 15)
# for the ΛCDM window integrals: a positive-weighted sum, so the f32 values
# of the closed-form a(t) at the nodes are the only error (~1e-7).
_GL8_X = (
    0.019855071751231856, 0.10166676129318664, 0.2372337950418355,
    0.40828267875217505, 0.5917173212478249, 0.7627662049581645,
    0.8983332387068134, 0.9801449282487681,
)
_GL8_W = (
    0.05061426814518813, 0.11119051722668723, 0.15685332293894364,
    0.18134189168918097, 0.18134189168918097, 0.15685332293894364,
    0.11119051722668723, 0.05061426814518813,
)


class _Background:
    """The background of ``config.cosmology``: ``init(G, ρ̄) -> bg`` (a
    dict of 0-d float32 tensors, at least ``"t_i"``) and, for ΛCDM,
    :meth:`gl8`, the window integrals by quadrature."""

    def __init__(self, config: SimConfig):
        self.kind = config.cosmology
        if self.kind == "eds":
            return
        if self.kind != "lcdm":
            raise ValueError(f"unknown cosmology {config.cosmology!r} (supported: 'eds', 'lcdm')")
        ol = float(config.omega_lambda)
        if not 0.0 < ol < 1.0:
            raise ValueError(
                f"cosmology='lcdm' needs 0 < omega_lambda < 1, got {ol} "
                "(omega_lambda=0 IS EdS: use cosmology='eds')"
            )
        om = 1.0 - ol
        self.ol, self.om = ol, om
        self.s_ti = math.asinh(math.sqrt(ol / om))
        self.inv_pref = (ol / om) ** (1.0 / 3.0)  # 1 / a's prefactor

    def init(self, G, rho_bar) -> dict:
        h = eds_hubble_init(G, rho_bar)
        if self.kind == "eds":
            return {"t_i": torch.div(2.0, 3.0 * h)}
        # rho_bar is the matter density the particles carry; flatness
        # fixes the total: H_i² = (8πG/3) ρ̄ / Ω_m.
        s = 1.5 * math.sqrt(self.ol) * (h * (1.0 / math.sqrt(self.om)))
        return {"t_i": torch.div(self.s_ti, s), "s": s}

    def gl8(self, bg: dict, t1, dtw, x_dtw, w, square) -> torch.Tensor:
        """``dtw · Σ_j w_j / a(t1 + x_j·dtw)^p`` over the last axis of the
        node offsets ``x_dtw = x·dtw`` (``t1``, ``dtw`` of its leading
        shape), ``p = 2`` where ``square`` (a bool or a mask of ``t1``'s
        shape)."""
        sh = torch.sinh(bg["s"] * (t1[..., None] + x_dtw))
        inv_a = self.inv_pref * sh ** (-2.0 / 3.0)
        if isinstance(square, bool):  # x**1 = x, x**2 = x·x, as JAX lowers integer powers
            terms = inv_a * inv_a if square else inv_a
        else:
            terms = torch.where(square[..., None], inv_a * inv_a, inv_a)
        return dtw * torch.sum(w * terms, dim=-1)

    def window(self, bg: dict, t1, dtw, power: int) -> torch.Tensor:
        """``∫_{t1}^{t1+dtw} dt / a^power``, ``power`` 1 (kick) or 2 (drift)."""
        t1, dtw = _f32(t1), _f32(dtw)
        if self.kind == "eds":
            return _eds_window(t1, dtw, bg["t_i"], *(_KICK if power == 1 else _DRIFT))
        x, w = (torch.tensor(c, dtype=torch.float32, device=t1.device) for c in (_GL8_X, _GL8_W))
        return self.gl8(bg, t1, dtw, x * dtw[..., None], w, power == 2)


def make_background(config: SimConfig):
    """``(bg_init, kick_fn, drift_fn)`` of ``config.cosmology``, as in the
    JAX package: ``bg_init(G, rho_bar) -> bg``, ``kick_fn(bg, t1, dtw) =
    ∫_{t1}^{t1+dtw} dt/a`` and ``drift_fn(bg, t1, dtw) = ∫ dt/a²``, each
    window as (start, length)."""
    b = _Background(config)
    return b.init, (lambda bg, t1, dtw: b.window(bg, t1, dtw, 1)), (lambda bg, t1, dtw: b.window(bg, t1, dtw, 2))


def validate_cosmo_config(config: SimConfig) -> None:
    """The comoving step's configuration checks, with the JAX package's
    ``ValueError`` messages."""
    if config.boundary != "periodic" or config.method not in ("pm", "p3m"):
        raise ValueError(
            f"cosmology={config.cosmology!r} needs boundary='periodic' and "
            "a mesh solver (method='pm'|'p3m'): comoving coordinates "
            "expand a homogeneous background, which only the torus has"
        )
    if config.integrator != "verlet":
        raise ValueError(
            "cosmology uses its own staggered kick-drift scheme; set "
            "integrator='verlet' (the default) — yoshida4/euler do not "
            "compose with time-dependent drift factors"
        )
    _Background(config)  # raises on an unknown name or a bad omega_lambda


class _Windows:
    """What the comoving step reuses from one step to the next on one
    device: the background, the two windows' constants as length-2 tensors
    (element 0 the kick, 1 the drift: the kick's start selector ``[1, 0]``,
    EdS's exponents, signs and divisors, ΛCDM's squared-term mask and GL8
    weights), and for each ``(dt, first step)`` the window lengths ``[dt/2
    or dt, dt]`` (ΛCDM: with the node offsets ``x · length``).  Each is
    copied to the device once; a step adds no copy and no sync."""

    def __init__(self, config: SimConfig):
        self.b = _Background(config)
        self.dev: torch.device | None = None
        self.lengths: dict = {}

    def _tensor(self, values, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(values, dtype=dtype, device=self.dev)

    def setup(self, dev: torch.device) -> None:
        if dev == self.dev:
            return
        self.dev, self.lengths = dev, {}
        self.kick_sel = self._tensor([1.0, 0.0])
        self.eds = tuple(self._tensor([k, d]) for k, d in zip(_KICK, _DRIFT))
        self.square = self._tensor([False, True], torch.bool)
        self.x, self.w = self._tensor(_GL8_X), self._tensor(_GL8_W)

    def window_lengths(self, dt32: np.float32, first: bool):
        key = (float(dt32), first)
        if key not in self.lengths:
            if len(self.lengths) > 8:  # a run keeps one dt (pause skips steps)
                self.lengths.clear()
            dtw = self._tensor([float(np.float32(0.5) * dt32) if first else float(dt32), float(dt32)])
            self.lengths[key] = dtw, self.x * dtw[:, None]
        return self.lengths[key]


def comoving_update(config: SimConfig, g, pos_mass, vel, step: int, dt, G, rho_bar, valid, windows=None):
    """One staggered kick-drift given the comoving force ``g`` at the
    current positions: ``(new_pos_mass, new_w, g_masked)``.  ``step`` is
    the host step count, ``dt`` and ``G`` host floats, ``rho_bar`` a 0-d
    tensor; ``windows`` (a :class:`_Windows`) carries the constants from
    one call to the next."""
    windows = windows or _Windows(config)
    b = windows.b
    dt32 = np.float32(dt)
    bg = b.init(G, rho_bar)
    t_i = bg["t_i"]
    windows.setup(t_i.device)
    first = step == 0
    dtw, x_dtw = windows.window_lengths(dt32, first)
    # [t_n, t_n] less the kick's half step on its element: t1 = [t_n - dt/2
    # (t_i at step 0, where t_n = t_i), t_n].  Window lengths go in exactly.
    t_n = t_i.reshape(1).expand(2) + float(np.float32(step) * dt32)
    t1 = torch.sub(t_n, windows.kick_sel, alpha=0.0 if first else float(np.float32(0.5) * dt32))
    if b.kind == "eds":
        f = _eds_window(t1, dtw, t_i, *windows.eds)
    else:
        f = b.gl8(bg, t1, dtw, x_dtw, windows.w, windows.square)
    new_w = torch.addcmul(vel, g, f[0])
    new_p = torch.addcmul(pos_mass, new_w, f[1])
    if valid is not None:
        new_p = torch.where(valid, new_p, pos_mass)
        new_w = torch.where(valid, new_w, vel)
        g = torch.where(valid, g, 0.0)
    return new_p, new_w, g


def cosmic_time_and_scale(config: SimConfig, G: float, rho_bar: float, step: int, dt: float) -> tuple[float, float]:
    """Host (float64) mirror of the step's background: ``t = t_i +
    step·dt`` and ``a(t)``, for the engine's log lines and metrics."""
    if config.cosmology == "eds":
        h_i = math.sqrt(8.0 * math.pi / 3.0 * G * rho_bar)
        t_i = 2.0 / (3.0 * h_i)
        t = t_i + step * dt
        return t, (t / t_i) ** (2.0 / 3.0)
    if config.cosmology == "lcdm":
        ol = float(config.omega_lambda)
        om = 1.0 - ol
        h_i = math.sqrt(8.0 * math.pi / 3.0 * G * rho_bar / om)
        s = 1.5 * math.sqrt(ol) * h_i
        t_i = math.asinh(math.sqrt(ol / om)) / s
        t = t_i + step * dt
        return t, (om / ol) ** (1.0 / 3.0) * math.sinh(s * t) ** (2.0 / 3.0)
    raise ValueError(f"no background for cosmology={config.cosmology!r}")


def make_cosmo_step_fn(config: SimConfig, n_pad: int, n_real: int, route: str):
    """The comoving ``step(state, dt, G) -> state`` on the periodic mesh
    force of ``route`` (``"kernels"``: ``short_range``, ``mesh_deposit`` and
    ``mesh_gather`` on a card; ``"plain"``: their twins).  ``dt`` is cosmic
    time; ``t_i`` comes from ``G`` and the state's total mass each step."""
    validate_cosmo_config(config)
    from nbody3d_tpu_torch.ops.force_vjp import requires_grad
    from nbody3d_tpu_torch.ops.integrate import valid_mask
    from nbody3d_tpu_torch.ops.step import make_mesh_accel_fn

    accel_fn = make_mesh_accel_fn(config, n_real, route)
    inv_vol = 1.0 / float(config.box_size) ** 3
    windows = _Windows(config)

    def step(state: SimState, dt, G) -> SimState:
        if torch.is_grad_enabled() and (requires_grad(dt) or requires_grad(G)):
            raise RuntimeError(
                f"cosmology={config.cosmology!r}: the comoving step takes dt and G as host floats, so it has "
                "no gradient by them (the JAX package's tests take none); differentiate by the state"
            )
        dt, G = float(dt), float(G)
        # Padding rows carry mass 0, so the padded sum is the real total.
        rho_bar = torch.sum(state.pos_mass[:, 3]) * inv_vol
        g = accel_fn(state.pos_mass, G)
        new_p, new_w, g = comoving_update(
            config, g, state.pos_mass, state.vel, state.step, dt, G, rho_bar,
            valid_mask(state.n_pad, n_real, state.device), windows,
        )
        return SimState(new_p, new_w, g, state.step + 1)

    return step
