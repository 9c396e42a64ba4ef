"""Ewald summation on the periodic box: ``nbody3d_tpu/ops/ewald.py``.

``boundary="periodic"`` simulates the torus ``[0, L)^3``.  Gaussian charge
shaping of width ``sigma`` splits the Plummer-softened pair force into a
short-range real-space scalar (:func:`k_short_periodic`, summed over the
minimum image within a cutoff by P3M's ``short_range`` kernel) and a
smooth long range whose reciprocal-space form is
``-4 pi / k^2 exp(-k^2 sigma^2 / 2)``, solved on the mesh by one FFT
(:func:`spectral_accel_grids`).  The mean (k = 0) mass mode is dropped:
the neutralising background that makes a periodic potential finite.

:func:`ewald_accel_reference` is the brute-force oracle (real-space sum
over image boxes plus a direct sum over reciprocal modes, independent of
``sigma``).  :func:`ewald_potential_energy` is the conserved energy of the
periodic motion in torch, on the input's device and in its dtype, and
differentiable: autograd through it gives ``-m a``, the Ewald force.
:func:`ewald_potential_energy_f64` is the same energy in float64 numpy on
the host, the form the engine's periodic diagnostics use.  Accelerations
are per unit G, mass in the ``w`` lane of ``pos_mass``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SQRT2 = 1.4142135623730951
_TWO_OVER_SQRT_PI = 1.1283791670955126


# k_long's Maclaurin series in u² (the bracket of (2/√π) a³ (...)): the
# coefficients (-1)^(n+1) 2n / ((2n+1) n!), n = 1..9, of
# (erf(u) - (2/√π) u e^{-u²}) / u³.  Taken below u = 0.5, where the closed
# form's two terms cancel; the next term truncates at 2e-12 relative.
_K_LONG_SERIES = (2 / 3, -2 / 5, 1 / 7, -1 / 27, 1 / 132, -1 / 780, 1 / 5400, -1 / 42840, 1 / 383040)
_SERIES_BELOW_U2 = 0.25


def k_long_terms(inv_r, erf_u, e, c2, a2, u2):
    """``k_long = erf(u)/r³ - c2 e/r²`` from ``inv_r = 1/r``, ``erf(u)``,
    ``e = exp(-u²)``, ``c2 = (2/√π) a``, ``a2 = a²`` and ``u2 = u²``
    (``a = 1/(√2 σ)``), ``csrc/periodic.cuh::k_long_periodic`` operation
    for operation: below u = 0.5 the series ``c2 a2 Σ c_n u^(2n-2)``,
    because the closed form's two terms agree to O(u²) and their f32
    difference is rounding noise of size 1/(σ r²) at r << σ.  Both branches
    are evaluated and one selected (``torch.where``), so autograd flows
    through the one taken."""
    closed = erf_u * (inv_r * inv_r * inv_r) - (c2 * e) * (inv_r * inv_r)
    return torch.where(u2 < _SERIES_BELOW_U2, k_long_series(c2, a2, u2), closed)


def k_long_series(c2, a2, u2: torch.Tensor) -> torch.Tensor:
    """``c2 a2 Σ c_n u^(2n-2)``: k_long's series, by Horner in ``u2``."""
    poly = torch.full_like(u2, _K_LONG_SERIES[-1])
    for c in reversed(_K_LONG_SERIES[:-1]):
        poly = c + u2 * poly
    return (c2 * a2) * poly


def k_long_gauss(r2: torch.Tensor, sigma) -> torch.Tensor:
    """Long-range pair scalar of the Gaussian split, unsoftened:
    ``(erf(u) - (2/sqrt(pi)) u exp(-u^2)) / r^3``, ``u = r / (sqrt2
    sigma)`` (:func:`k_long_terms`: its series below u = 0.5); 0 at r = 0."""
    mask = r2 > 0
    r2s = torch.where(mask, r2, 1.0)
    inv_r = torch.rsqrt(r2s)
    a = 1.0 / (_SQRT2 * sigma)
    a2 = 0.5 / (sigma * sigma)  # not a * a, as the kernels take it (scal[3])
    u2 = r2s * a2
    g = k_long_terms(inv_r, torch.special.erf(r2s * inv_r * a), torch.exp(-u2), _TWO_OVER_SQRT_PI * a, a2, u2)
    return torch.where(mask, g, 0.0)


def k_short_periodic(r2: torch.Tensor, eps2: float, sigma) -> torch.Tensor:
    """Short-range pair scalar of the periodic split: the softened exact
    ``1/s^3`` less :func:`k_long_gauss`; 0 at r = 0.  Within a few ulp of
    ``1/s^3 + k_long`` at any r (the series)."""
    mask = r2 > 0
    r2s = torch.where(mask, r2, 1.0)
    inv_s = torch.rsqrt(r2s + eps2)
    k = inv_s * inv_s * inv_s - k_long_gauss(r2s, sigma)
    return torch.where(mask, k, 0.0)


def spectral_accel_grids(rho: torch.Tensor, L, sigma, order: int = 3) -> torch.Tensor:
    """The reciprocal-space term on the mesh: ``(M, M, M)`` deposited mass
    → ``(3, M³)`` long-range acceleration grids per unit G.

    One periodic FFT solve: ``phi_hat = rho_hat · sinc^(-2·order) ·
    (-4 pi / k²) e^{-k² sigma² / 2} / h³`` with the k = 0 mode zeroed, then
    ``a_hat = -i k_a phi_hat`` with the Nyquist plane of the differentiated
    axis zeroed (its +k/-k alias cannot carry an odd derivative)."""
    m = rho.shape[0]
    dt, dev = rho.dtype, rho.device
    L = torch.as_tensor(L, dtype=dt, device=dev)
    sigma = torch.as_tensor(sigma, dtype=dt, device=dev)
    h = L / m
    f1 = torch.fft.fftfreq(m, dtype=dt, device=dev)  # cycles a sample
    fr = torch.fft.rfftfreq(m, dtype=dt, device=dev)
    two_pi_h = 2.0 * math.pi / h
    kx, kz = two_pi_h * f1, two_pi_h * fr
    k2 = kx[:, None, None] ** 2 + kx[None, :, None] ** 2 + kz[None, None, :] ** 2
    deconv = (torch.sinc(f1)[:, None, None] * torch.sinc(f1)[None, :, None] * torch.sinc(fr)[None, None, :]) ** (
        -2 * order
    )
    nz = k2 > 0
    k2s = torch.where(nz, k2, 1.0)
    green = torch.where(nz, -4.0 * math.pi * torch.exp(-0.5 * k2 * sigma * sigma) / k2s, 0.0) / (h * h * h)
    phi_hat = torch.fft.rfftn(rho) * (deconv * green)
    gx = torch.where(f1.abs() >= 0.5, 0.0, kx)
    gz = torch.where(fr.abs() >= 0.5, 0.0, kz)
    out = []
    for g in (gx[:, None, None], gx[None, :, None], gz[None, None, :]):
        out.append(torch.fft.irfftn(-1j * g * phi_hat, s=(m, m, m)).reshape(-1))
    return torch.stack(out, dim=0)


def wrap_box(pos: torch.Tensor, L) -> torch.Tensor:
    """Positions wrapped into ``[0, L)`` per component."""
    L = torch.as_tensor(L, dtype=pos.dtype, device=pos.device)
    return pos - L * torch.floor(pos / L)


def k_modes(kmax: int) -> np.ndarray:
    """Integer reciprocal modes with ``0 < |n|_inf <= kmax``, one of each
    ``±n`` pair (the first nonzero component positive): ``(K, 3)``."""
    r = np.arange(-kmax, kmax + 1)
    n = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    n = n[np.any(n != 0, axis=1)]
    pos = (n[:, 0] > 0) | ((n[:, 0] == 0) & ((n[:, 1] > 0) | ((n[:, 1] == 0) & (n[:, 2] > 0))))
    return n[pos].astype(np.float64)


_DEFAULT_KMAX = 16
_SIGMA_PER_BOX = 16.0  # sigma defaults to L / 16


def _self_and_background(m2sum, msum, sigma, L3):
    """The Gaussian self-energy removal ``½ Σm² sqrt(2/π) / σ`` and the
    neutralising background ``π σ² (Σm)² / L³`` from ``Σm²``, ``Σm``, σ and
    ``L³`` (floats or tensors)."""
    return 0.5 * m2sum * math.sqrt(2.0 / math.pi) / sigma, math.pi * sigma * sigma * msum * msum / L3


def ewald_potential_energy(
    pos_mass: torch.Tensor,
    L,
    *,
    eps2: float = 1e-4,
    sigma=None,
    kmax: int | None = None,
    chunk: int | None = None,
) -> torch.Tensor:
    """Potential energy per unit G of the periodised softened interaction,
    a 0-d tensor in ``pos_mass``'s dtype on its device: the terms of
    :func:`ewald_potential_energy_f64` (``nbody3d_tpu/ops/ewald.py::
    ewald_potential_energy``'s), in plain torch ops, so autograd by
    ``pos_mass`` gives ``-m a`` (:func:`ewald_accel_reference` times the
    masses; the constants drop out).  ``sigma`` defaults to ``L / 16``,
    ``kmax`` to 16.  ``chunk`` (which must divide N) bounds the pair
    temporaries to ``(chunk, N)`` and the structure factors' to ``(chunk,
    K)`` for the ``K`` modes of :func:`k_modes`: the sums then go chunk by
    chunk.

    In float32 the terms, each ~1e7-1e8 on a uniform box, cancel to a total
    ~1e2, so the result carries rounding noise of ~1e-7 of the largest term
    (float64 resolves a 1e-5 position change)."""
    x, m = pos_mass[:, :3], pos_mass[:, 3]
    dt, dev = x.dtype, x.device
    L = torch.as_tensor(L, dtype=dt, device=dev)
    sigma = L / _SIGMA_PER_BOX if sigma is None else torch.as_tensor(sigma, dtype=dt, device=dev)
    kmax = _DEFAULT_KMAX if kmax is None else kmax
    n = x.shape[0]
    if chunk is None or chunk >= n:
        chunk = n
    elif n % chunk != 0:
        raise ValueError(f"chunk {chunk} must divide N {n}")
    eps2_t = torch.as_tensor(eps2, dtype=dt, device=dev)

    def chunk_real(xt, mt):
        # the minimum image, i != j; half of it is the sum over i < j
        d = x[None, :, :] - xt[:, None, :]
        d = d - L * torch.round(d / L)
        r2 = torch.sum(d * d, dim=-1)
        mask = r2 > 0
        r2s = torch.where(mask, r2, 1.0)
        inv_r = torch.rsqrt(r2s)
        u = (r2s * inv_r) / (_SQRT2 * sigma)
        psi_s = -torch.rsqrt(r2s + eps2_t) + torch.special.erf(u) * inv_r
        return torch.sum(torch.where(mask, psi_s, 0.0) * m[None, :] * mt[:, None])

    kvec = (2.0 * math.pi / L) * torch.from_numpy(k_modes(kmax)).to(dtype=dt, device=dev)
    k2 = torch.sum(kvec * kvec, dim=1)
    damp = torch.exp(-0.5 * k2 * sigma * sigma) / k2
    u_real = 0.0
    sc = ss = 0.0
    for s0 in range(0, n, chunk):
        xt, mt = x[s0 : s0 + chunk], m[s0 : s0 + chunk]
        u_real = u_real + chunk_real(xt, mt)
        phase = xt @ kvec.T
        sc = sc + mt @ torch.cos(phase)
        ss = ss + mt @ torch.sin(phase)
    u_real = 0.5 * u_real
    u_k = -(4.0 * math.pi / (L * L * L)) * torch.sum(damp * (sc * sc + ss * ss))

    u_self, u_bg = _self_and_background(torch.sum(m * m), torch.sum(m), sigma, L * L * L)
    return u_real + u_k + u_self + u_bg


def energy_f32_bound(pos_mass, L: float, *, sigma: float | None = None, kmax: int | None = None) -> float:
    """The rounding bound of :func:`ewald_potential_energy` in float32 (the
    CPU tests' and the card's): ``2 (6π kmax) 2^-24 (u_self + u_bg)``.  A
    phase ``k·x = 2π n·x / L`` reaches ``6π kmax`` rad in the box, so its
    float32 rounding moves each structure factor by up to that many units
    of 2^-24 of its terms and ``|S(k)|²`` by twice that; the reciprocal sum
    is of the size of the self and background terms it cancels against
    (3.6e-5 of them at the default kmax = 16)."""
    m = np.asarray(pos_mass[:, 3], np.float64)
    L = float(L)
    sigma = L / _SIGMA_PER_BOX if sigma is None else float(sigma)
    kmax = _DEFAULT_KMAX if kmax is None else kmax
    u_self, u_bg = _self_and_background(float(np.sum(m * m)), float(np.sum(m)), sigma, L**3)
    return 2.0 * (6.0 * math.pi * kmax) * 2.0**-24 * (u_self + u_bg)


def ewald_potential_energy_f64(
    pos_mass, L: float, *, eps2: float = 1e-4, sigma: float | None = None, kmax: int | None = None
) -> float:
    """Potential energy per unit G of the periodised softened interaction,
    in float64 numpy on the host: real-space ``Σ_{i<j} m_i m_j ψ_s(r)``
    over the minimum image with ``ψ_s = -1/sqrt(r²+eps2) + erf(u)/r``,
    reciprocal ``-(4π/L³) Σ_half e^{-k²σ²/2}/k² |S(k)|²``, the Gaussian
    self-energy ``+½ Σ m² sqrt(2/π)/σ`` and the background ``+π σ² (Σm)²
    / L³``.

    The value is a cancellation of terms ~1e7-1e8 against a total of
    ~1e2 on the uniform box, so float32 would carry ~1e2 of rounding
    noise; float64 resolves a 1e-5 position change."""
    from scipy.special import erf

    x = np.asarray(pos_mass[:, :3], np.float64)
    m = np.asarray(pos_mass[:, 3], np.float64)
    L = float(L)
    sigma = L / _SIGMA_PER_BOX if sigma is None else float(sigma)
    kmax = _DEFAULT_KMAX if kmax is None else kmax
    n = x.shape[0]

    chunk = max(1, (1 << 25) // max(n, 1))
    u_real = 0.0
    for s0 in range(0, n, chunk):
        xt, mt = x[s0 : s0 + chunk], m[s0 : s0 + chunk]
        d = x[None, :, :] - xt[:, None, :]
        d -= L * np.round(d / L)
        r2 = np.einsum("ijk,ijk->ij", d, d)
        mask = r2 > 0
        r2s = np.where(mask, r2, 1.0)
        r = np.sqrt(r2s)
        psi_s = -1.0 / np.sqrt(r2s + eps2) + erf(r / (np.sqrt(2.0) * sigma)) / r
        u_real += 0.5 * float(np.sum(np.where(mask, psi_s, 0.0) * m[None, :] * mt[:, None]))

    modes = k_modes(kmax)
    kvec = (2.0 * np.pi / L) * modes
    k2 = np.sum(kvec * kvec, axis=1)
    damp = np.exp(-0.5 * k2 * sigma * sigma) / k2
    nk = modes.shape[0]
    pchunk = max(1, (1 << 24) // max(nk, 1))
    sc, ss = np.zeros(nk), np.zeros(nk)
    for s0 in range(0, n, pchunk):
        phase = x[s0 : s0 + pchunk] @ kvec.T
        sc += m[s0 : s0 + pchunk] @ np.cos(phase)
        ss += m[s0 : s0 + pchunk] @ np.sin(phase)
    u_k = -(4.0 * np.pi / L**3) * float(np.sum(damp * (sc * sc + ss * ss)))

    u_self, u_bg = _self_and_background(float(np.sum(m * m)), float(np.sum(m)), sigma, L**3)
    return u_real + u_k + u_self + u_bg


def ewald_accel_reference(
    pos_mass: torch.Tensor,
    L: float,
    sigma: float,
    *,
    eps2: float = 1e-4,
    n_images: int = 2,
    kmax: int = 8,
    rows: torch.Tensor | None = None,
    pair_batch: int = 1 << 24,
) -> torch.Tensor:
    """Exact periodic accelerations per unit G, ``(R, 3)`` in the dtype of
    ``pos_mass`` (the oracle: pass float64), at the bodies ``rows`` (all
    when None).

    Real space: every image offset ``n`` in ``[-n_images, n_images]³`` of
    the minimum-image separation, ``k_short_periodic(|d + nL|) (d + nL)``
    (a body meets its own images).  Reciprocal space: ``a_i = (8π / L³)
    Σ_half (k / k²) e^{-k²σ²/2} [cos(k·x_i) S_s(k) - sin(k·x_i) S_c(k)]``
    with ``S_c = Σ_j m_j cos(k·x_j)``, ``S_s = Σ_j m_j sin(k·x_j)``.
    Converges like ``erfc(n_images L / (sqrt2 σ))`` and ``exp(-(2π kmax σ
    / L)² / 2)``; the result does not depend on ``σ``.  Target rows and
    bodies go in batches of about ``pair_batch`` pairs (modes)."""
    x, m = pos_mass[:, :3], pos_mass[:, 3]
    dt, dev = x.dtype, x.device
    xt = x if rows is None else x[rows]
    r = torch.arange(-n_images, n_images + 1, dtype=dt, device=dev) * L
    shifts = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    a_real = torch.zeros_like(xt)
    step = max(1, pair_batch // x.shape[0])
    for t0 in range(0, xt.shape[0], step):
        d0 = x[None, :, :] - xt[t0 : t0 + step, None, :]
        d0 = d0 - L * torch.round(d0 / L)
        for s in shifts:
            d = d0 + s
            w = k_short_periodic(torch.sum(d * d, dim=-1), eps2, sigma) * m
            a_real[t0 : t0 + step] += torch.einsum("ij,ijc->ic", w, d)

    kvec = torch.from_numpy((2.0 * np.pi / L) * k_modes(kmax)).to(dtype=dt, device=dev)
    k2 = torch.sum(kvec * kvec, dim=1)
    damp = torch.exp(-0.5 * k2 * sigma * sigma) / k2
    sc = torch.zeros_like(k2)
    ss = torch.zeros_like(k2)
    step = max(1, pair_batch // kvec.shape[0])
    for s0 in range(0, x.shape[0], step):
        phase = x[s0 : s0 + step] @ kvec.T
        sc += m[s0 : s0 + step] @ torch.cos(phase)
        ss += m[s0 : s0 + step] @ torch.sin(phase)
    a_recip = torch.empty_like(xt)
    coef = 2.0 * (4.0 * np.pi) / (L * L * L)
    for t0 in range(0, xt.shape[0], step):
        phase = xt[t0 : t0 + step] @ kvec.T
        proj = damp * (torch.cos(phase) * ss - torch.sin(phase) * sc)
        a_recip[t0 : t0 + step] = coef * (proj @ kvec)
    return a_real + a_recip
