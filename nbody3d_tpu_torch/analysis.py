"""Structural analysis of a particle state: ``nbody3d_tpu/analysis.py``.

Torch functions on the state's device, each mass-0-padding-invariant:

- the centre-of-mass frame, Lagrangian radii, the spherically averaged
  density and velocity-dispersion profiles, the virial ratio 2T/|U|
  (``ops/diagnostics.py``'s softened potential), and :func:`summary`, one
  report of them brought to the host in one device-to-host copy;
- the mass power spectrum :func:`power_spectrum`: the CIC deposit of the
  mesh solvers (``mesh_cuda.deposit`` at order 2: the ``mesh_deposit``
  kernel on a card, its plain twin on the CPU), ``torch.fft.fftn`` and
  shell sums over ``|k|``, binned in the JAX package's float32 order so
  that the mode counts per bin are its counts (at power-of-two grids);
- friends-of-friends groups on the host: :func:`fof_groups` through the
  port's C core (``native/_fof.c``, built at first use; a failed build
  raises), :func:`_fof_python` its plain twin, the streamed form
  (:func:`quantize_for_fof`: 10 bytes a body to the host) and
  :func:`group_catalog`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from nbody3d_tpu_torch.ops import diagnostics as diag_mod

DEFAULT_FRACTIONS = (0.1, 0.25, 0.5, 0.75, 0.9)


def _rows(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, np.float32))


def com_frame(pos_mass: torch.Tensor, vel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mass-weighted centre of mass and bulk velocity: ``((3,), (3,))``."""
    m = pos_mass[:, 3:4]
    tot = torch.clamp(torch.sum(m), min=1e-30)
    return torch.sum(m * pos_mass[:, :3], dim=0) / tot, torch.sum(m * vel[:, :3], dim=0) / tot


def _radii_and_mass(pos_mass: torch.Tensor, center: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    if center is None:
        center = com_frame(pos_mass, pos_mass)[0]
    d = pos_mass[:, :3] - center[None, :]
    return torch.sqrt(torch.sum(d * d, dim=1)), pos_mass[:, 3]


def lagrangian_radii(pos_mass: torch.Tensor, fractions: tuple[float, ...] = DEFAULT_FRACTIONS,
                     center: torch.Tensor | None = None) -> torch.Tensor:
    """Radii about ``center`` (default: the COM) enclosing each mass
    fraction: the first sorted radius whose enclosed mass reaches it."""
    r, m = _radii_and_mass(pos_mass, center)
    order = torch.argsort(r)
    cum = torch.cumsum(m[order], dim=0)
    targets = torch.tensor(fractions, dtype=torch.float32, device=r.device) * cum[-1]
    idx = torch.searchsorted(cum, targets, side="left")
    return r[order][torch.clamp(idx, 0, r.shape[0] - 1)]


def _recip(c: int | float) -> float:
    """``f32(1/c)``: the compiled JAX reference divides by a constant as a
    product with its float32 reciprocal, and so does the port, where the
    bits decide a bin."""
    return float(np.float32(1.0 / c))


def _edges(rmax: torch.Tensor, nbins: int) -> torch.Tensor:
    """``jnp.linspace(0, rmax, nbins + 1)`` as compiled: ``rmax · (i ·
    f32(1/nbins))``."""
    return rmax * (torch.arange(nbins + 1, dtype=torch.float32, device=rmax.device) * _recip(nbins))


def _shell_index(r: torch.Tensor, rmax, nbins: int, center, pos_mass) -> tuple[torch.Tensor, torch.Tensor]:
    if rmax is None:
        rmax = lagrangian_radii(pos_mass, (0.99,), center)[0]
    rmax = torch.clamp(torch.as_tensor(rmax, dtype=torch.float32, device=r.device), min=1e-30)
    return rmax, torch.clamp((r / rmax * nbins).to(torch.int64), 0, nbins)  # nbins: past rmax


def _bin_sum(values: torch.Tensor, b: torch.Tensor, nbins: int) -> torch.Tensor:
    """``segment_sum(values, b, nbins + 1)[:nbins]``: the last bin drops."""
    out = torch.zeros((nbins + 1,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, b, values)[:nbins]


def density_profile(pos_mass: torch.Tensor, nbins: int = 64, rmax=None, center: torch.Tensor | None = None):
    """Spherically averaged mass density about ``center`` (default COM) in
    ``nbins`` linear shells to ``rmax`` (default the 99% Lagrangian
    radius): ``(edges (nbins+1,), rho (nbins,), count (nbins,))``."""
    r, m = _radii_and_mass(pos_mass, center)
    rmax, b = _shell_index(r, rmax, nbins, center, pos_mass)
    edges = _edges(rmax, nbins)
    mass_in, count = _bin_sum(m, b, nbins), _bin_sum(torch.ones_like(m), b, nbins)
    vol = 4.0 / 3.0 * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    return edges, mass_in / torch.clamp(vol, min=1e-30), count


def velocity_dispersion_profile(pos_mass: torch.Tensor, vel: torch.Tensor, nbins: int = 64, rmax=None):
    """Mass-weighted 3-D velocity dispersion a radial shell about the COM,
    each shell's bulk velocity taken out: ``(edges, sigma)``; empty shells
    give 0."""
    com, _ = com_frame(pos_mass, vel)
    r, m = _radii_and_mass(pos_mass, com)
    rmax, b = _shell_index(r, rmax, nbins, com, pos_mass)
    v = vel[:, :3]
    msum = _bin_sum(m, b, nbins)
    safe = torch.clamp(msum, min=1e-30)
    mv = _bin_sum(m[:, None] * v, b, nbins)
    mv2 = _bin_sum(m * torch.sum(v * v, dim=1), b, nbins)
    var = mv2 / safe - torch.sum((mv / safe[:, None]) ** 2, dim=1)
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    return _edges(rmax, nbins), torch.where(msum > 0, sigma, 0.0)


def kinetic_energy_com(pos_mass: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    """Kinetic energy in the centre-of-momentum frame."""
    _, vcom = com_frame(pos_mass, vel)
    dv = vel[:, :3] - vcom[None, :]
    return 0.5 * torch.sum(pos_mass[:, 3] * torch.sum(dv * dv, dim=1))


def virial_ratio(pos_mass: torch.Tensor, vel: torch.Tensor, G: float, *, eps2: float = 1e-4,
                 chunk: int | None = 1024) -> torch.Tensor:
    """``2T/|U|``, T in the COM frame, U the softened pair potential: 1 in
    virial equilibrium.  O(N²)."""
    t = kinetic_energy_com(pos_mass, vel)
    u = diag_mod.potential_energy(pos_mass, G, eps2=eps2, chunk=chunk)
    return 2.0 * t / torch.clamp(torch.abs(u), min=1e-30)


def summary(pos_mass, vel, G: float, *, eps2: float = 1e-4, fractions: tuple[float, ...] = DEFAULT_FRACTIONS,
            nbins: int = 64, potential: bool = True, pe_chunk: int | None = 1024) -> dict:
    """One report (a host dict of floats and lists).  Every statistic is
    computed on the state's device and the lot comes to the host in one
    copy.  ``potential=False`` skips the O(N²) terms (PE, total E, virial)."""
    pos_mass, vel = _rows(pos_mass), _rows(vel)
    com, vcom = com_frame(pos_mass, vel)
    parts = {
        "n_massive": torch.sum(pos_mass[:, 3] > 0),
        "total_mass": torch.sum(pos_mass[:, 3]),
        "com": com,
        "com_velocity": vcom,
        "momentum": diag_mod.momentum(pos_mass, vel),
        "angular_momentum": diag_mod.angular_momentum(pos_mass, vel),
        "kinetic": diag_mod.kinetic_energy(pos_mass, vel),
        "kinetic_com": kinetic_energy_com(pos_mass, vel),
        "lagrangian_radii": lagrangian_radii(pos_mass, fractions, com),
    }
    parts["edges"], parts["rho"], parts["count"] = density_profile(pos_mass, nbins, center=com)
    parts["velocity_dispersion"] = velocity_dispersion_profile(pos_mass, vel, nbins)[1]
    if potential:
        n = pos_mass.shape[0]
        chunk = pe_chunk if pe_chunk and n % pe_chunk == 0 else None
        parts["potential"] = diag_mod.potential_energy(pos_mass, G, eps2=eps2, chunk=chunk)
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in parts.values()])
    values = flat.tolist()  # the one device-to-host copy
    host, at = {}, 0
    for name, t in parts.items():
        host[name], at = values[at: at + t.numel()], at + t.numel()
    out = {
        "n_massive": int(host["n_massive"][0]),
        "total_mass": host["total_mass"][0],
        "com": host["com"],
        "com_velocity": host["com_velocity"],
        "momentum": host["momentum"],
        "angular_momentum": host["angular_momentum"],
        "kinetic": host["kinetic"][0],
        "kinetic_com": host["kinetic_com"][0],
        "lagrangian_radii": {f"r{round(f * 100):02d}": v for f, v in zip(fractions, host["lagrangian_radii"])},
        "density_profile": {"edges": host["edges"], "rho": host["rho"], "count": host["count"]},
        "velocity_dispersion": host["velocity_dispersion"],
    }
    if potential:
        pe = host["potential"][0]
        out["potential"] = pe
        # ke + pe in float32, as the JAX package adds its device scalars.
        out["total_energy"] = float(np.float32(out["kinetic"]) + np.float32(pe))
        out["virial_ratio"] = 2.0 * out["kinetic_com"] / max(abs(pe), 1e-30)
    return out


def power_spectrum(pos_mass: torch.Tensor, grid: int = 128, *, box_size: float | None = None,
                   nbins: int | None = None, deconvolve: bool = True):
    """Spherically averaged mass density power spectrum ``P(k)``:
    ``(k_centers (nbins,), P (nbins,), n_modes (nbins,))`` on the state's
    device.

    ``delta = rho/rho_bar - 1`` is CIC-deposited on a ``grid**3`` mesh
    (``mesh_cuda.deposit`` at order 2, periodic on the torus) and
    transformed; ``P(k) = V <|delta_k|²>`` over linear shells of ``|k|`` from
    0 to the mesh Nyquist ``π·grid/L`` (``nbins`` defaults to ``grid // 2``;
    DC and the corner modes past Nyquist are left out), with ``delta_k`` the
    volume-normalized DFT, so a Poisson sample of N equal masses reads
    ``V/N`` (:func:`shot_noise`).  ``deconvolve`` divides out the CIC window
    ``Π sinc²(k_i h / 2π)``.  ``box_size``: the periodic box, positions
    wrapped onto ``[0, L)``; None: the massive bodies' bounding cube."""
    from nbody3d_tpu_torch.ops import mesh_cuda
    from nbody3d_tpu_torch.ops import pm as pm_mod

    if nbins is None:
        nbins = grid // 2
    pos_mass = _rows(pos_mass)
    pos, m = pos_mass[:, :3], pos_mass[:, 3]
    dev = pos.device
    # The box and the wavenumbers in the compiled JAX reference's float32
    # steps on the CPU (a division by a constant is a product with its
    # reciprocal, :func:`_recip`; its sums fused multiply-adds): a mode that
    # lies on a shell edge falls in its bin.  At a grid that is not a power
    # of two, such modes may still split otherwise.
    if box_size is None:
        big = (m > 0)[:, None]
        lo_w = torch.amin(torch.where(big, pos, math.inf), dim=0)
        hi_w = torch.amax(torch.where(big, pos, -math.inf), dim=0)
        half = torch.clamp(torch.max(hi_w - lo_w) * 0.5, min=1e-6)
        h = (2.0 * half) * _recip(grid - 2 * pm_mod._EDGE_CELLS - 1)  # pm.box_from_bounds
        lo = 0.5 * (lo_w + hi_w) - h * float(grid) * 0.5
        periodic = False
    else:
        L_box = torch.tensor(np.float32(box_size), device=dev)
        h = L_box * _recip(grid)
        lo = torch.zeros(3, device=dev)
        pos = pos - L_box * torch.floor(pos / L_box)  # wrap onto [0, L)
        periodic = True
    volume = (h * grid) ** 3

    i0, f = pm_mod._cic_cells(pos, lo, h, grid, periodic)
    rho = mesh_cuda.deposit(*mesh_cuda.mesh_operands(i0, f, m), grid, 2, periodic)
    mean = torch.sum(m) * _recip(grid**3)
    dk = torch.fft.fftn(rho / torch.clamp(mean, min=1e-30) - 1.0)

    freq = torch.cat([torch.arange(0, (grid - 1) // 2 + 1), torch.arange(-(grid // 2), 0)]).to(dev)
    k1 = float(np.float32(2.0 * np.pi)) * (freq.to(torch.float32) / grid) / h  # jnp.fft.fftfreq
    if deconvolve:
        w1 = torch.sinc(k1 * h * _recip(2.0 * math.pi)) ** 2
        dk = dk / (w1[:, None, None] * w1[None, :, None] * w1[None, None, :])
    p_mode = torch.abs(dk) ** 2 * (volume * _recip(float(grid**3) ** 2))

    # k_x² + k_y² + k_z² as the compiled reference rounds it on the CPU, two
    # fused multiply-adds: fma(k_z, k_z, fma(k_y, k_y, f32(k_x²))), each one
    # rounding (products exact in float64).
    kx, ky, kz = k1[:, None, None], k1[None, :, None].double(), k1[None, None, :].double()
    k2 = (kz * kz + (ky * ky + (kx * kx).double()).float().double()).float()
    kk = torch.sqrt(k2.double()).float()  # correctly rounded (torch's f32 sqrt on the CPU is not)
    k_nyq = torch.div(math.pi, h)
    b = torch.floor(kk / k_nyq * nbins).to(torch.int64)
    valid = (k2 > 0) & (kk <= k_nyq)
    b = torch.where(valid, torch.clamp(b, 0, nbins - 1), nbins).reshape(-1)  # nbins: dropped
    psum = _bin_sum(p_mode.reshape(-1), b, nbins)
    count = _bin_sum(torch.ones(grid**3, device=dev), b, nbins)
    k_centers = (torch.arange(nbins, dtype=torch.float32, device=dev) + 0.5) * (k_nyq * _recip(nbins))
    return k_centers, psum / torch.clamp(count, min=1.0), count


def shot_noise(pos_mass: torch.Tensor, volume: float) -> torch.Tensor:
    """The Poisson shot-noise plateau of the mass-weighted spectrum:
    ``V Σm² / (Σm)²`` (``V/N`` for N equal masses)."""
    m = _rows(pos_mass)[:, 3]
    tot = torch.clamp(torch.sum(m), min=1e-30)
    return float(np.float32(volume)) * torch.sum(m * m) / (tot * tot)


# ------------------------------------------------------- friends-of-friends


def _fof_python(pos, cell, dims, ll2, box):
    """Plain twin of the C core (``native/_fof.c``): the same cell grid
    and union-find in Python, ~100x slower."""
    n = len(pos)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    chains: dict[tuple, list] = {}
    for i in range(n):
        chains.setdefault(tuple(cell[i]), []).append(i)
    nx, ny, nz = (int(d) for d in dims)
    periodic = box > 0
    for i in range(n):
        cx, cy, cz = (int(c) for c in cell[i])
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    ax, ay, az = cx + dx, cy + dy, cz + dz
                    if periodic:
                        ax, ay, az = ax % nx, ay % ny, az % nz
                    elif not (0 <= ax < nx and 0 <= ay < ny and 0 <= az < nz):
                        continue
                    for j in chains.get((ax, ay, az), ()):
                        if j >= i:
                            continue
                        d = pos[i].astype(np.float64) - pos[j]
                        if periodic:
                            d -= box * np.floor(d / box + 0.5)
                        if float(d @ d) <= ll2:
                            ri, rj = find(i), find(j)
                            if ri != rj:
                                parent[min(ri, rj)] = max(ri, rj)
    return np.asarray([find(i) for i in range(n)], np.int32)


def _fof_c(pos: np.ndarray, cell: np.ndarray, dims, ll2: float, box: float) -> np.ndarray:
    """The C core's labels (built at first use; a failed build raises)."""
    from nbody3d_tpu_torch._build import load_host_library

    fn = load_host_library("_fof").nb_fof_labels
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 4 + [ctypes.c_double] * 4 + [ctypes.c_void_p]
    pos = np.ascontiguousarray(pos, np.float32)
    cell = np.ascontiguousarray(cell, np.int32)
    n = len(pos)
    if pos.shape != (n, 3) or cell.shape != (n, 3) or n >= 2**31:
        raise ValueError(f"fof: pos {pos.shape} and cell {cell.shape} must be (n, 3), n < 2^31")
    labels = np.empty(n, np.int32)
    rc = fn(pos.ctypes.data, cell.ctypes.data, n, int(dims[0]), int(dims[1]), int(dims[2]), ll2, box, box, box,
            labels.ctypes.data)
    if rc != 0:
        raise MemoryError(f"fof: the C core could not allocate its tables for {n} bodies")
    return labels


def fof_groups(pos_mass, linking_length: float | None = None, *, box_size: float | None = None,
               mean_sep_fraction: float = 0.2) -> tuple[np.ndarray, float]:
    """Friends-of-friends group labels, on the host: the connected components
    of the "separation <= linking length" graph (Davis et al. 1985).

    ``linking_length`` defaults to ``mean_sep_fraction`` (b = 0.2) times the
    mean separation ``(V/N)^(1/3)`` over the massive bodies' bounding volume
    (the torus's with ``box_size``; separations then by minimum image).
    Returns ``(labels (N,) int32, linking_length)``: equal labels mean one
    group; mass-0 rows get -1 and link nothing."""
    pm = np.asarray(pos_mass.detach().cpu() if isinstance(pos_mass, torch.Tensor) else pos_mass, np.float32)
    sel = pm[:, 3] > 0
    pos = np.ascontiguousarray(pm[sel, :3], np.float32)
    nm = len(pos)
    out = np.full(pm.shape[0], -1, np.int32)
    if nm == 0:
        return out, 0.0
    if box_size is not None:
        box = float(box_size)
        pos = pos - box * np.floor(pos / box)
    else:
        box = 0.0
    if linking_length is None:
        if box > 0:
            vol = box**3
        else:
            ext = np.maximum(pos.max(0) - pos.min(0), 1e-12)
            vol = float(np.prod(ext.astype(np.float64)))
        linking_length = mean_sep_fraction * (vol / nm) ** (1.0 / 3.0)
    ll = float(linking_length)
    if ll <= 0:
        raise ValueError("linking_length must be > 0")
    if box > 0:
        ncell = max(int(box / ll), 1)  # cell size box/ncell >= ll
        cell = np.minimum((pos / (box / ncell)).astype(np.int32), ncell - 1)
        dims = (ncell, ncell, ncell)
    else:
        cell = ((pos - pos.min(0)) / np.float32(ll)).astype(np.int32)
        dims = tuple(int(d) + 1 for d in cell.max(0))
    out[sel] = _fof_c(pos, cell, dims, ll * ll, box)
    return out, ll


def quantize_for_fof(pos_mass: torch.Tensor, *, box_size: float | None = None, bits: int = 21):
    """Quantized massive-body positions for the streamed FoF, on the state's
    device: three ``bits``-bit fixed-point coordinates in two 32-bit words
    and a log-quantized 16-bit mass.  Returns ``(w0, w1, mq, scal)``: the
    words as int64 tensors holding the JAX package's uint32 and uint16
    values bit for bit (torch's unsigned types lack shifts on CUDA), and
    ``scal = [lo_xyz, step_xyz, mmin, dlog_m]`` (float32).  A coordinate
    moves by at most extent / 2^(bits+1)."""
    pm = _rows(pos_mass)
    pos, m = pm[:, :3], pm[:, 3]
    if box_size is not None:
        L = torch.tensor(np.float32(box_size), device=pm.device)
        pos = pos - L * torch.floor(pos / L)
        lo = torch.zeros(3, device=pm.device)
        extent = torch.full((3,), float(np.float32(box_size)), device=pm.device)
    else:
        lo = torch.amin(pos, dim=0)
        extent = torch.clamp(torch.amax(pos, dim=0) - lo, min=1e-30)
    q = torch.clamp(((pos - lo[None, :]) / extent[None, :] * float(1 << bits)).to(torch.int64), 0, (1 << bits) - 1)
    qx, qy, qz = q[:, 0], q[:, 1], q[:, 2]
    w0 = qx | ((qy & 0x7FF) << 21)
    w1 = (qy >> 11) | (qz << 10)
    # log-u16 mass: 0.0003 dex over the observed range
    mmin = torch.clamp(torch.amin(m), min=1e-30)
    mmax = torch.maximum(torch.amax(m), mmin)
    lmin = torch.log(mmin)
    dl = torch.clamp(torch.log(mmax) - lmin, min=1e-30)
    mq = torch.clamp((torch.log(torch.clamp(m, min=1e-30)) - lmin) / dl * 65535.0, 0.0, 65535.0).to(torch.int64)
    step = extent / float(1 << bits)
    return w0, w1, mq, torch.cat([lo, step, mmin[None], dl[None]])


def dequantize_for_fof(w0, w1, mq, scal, *, bits: int = 21) -> np.ndarray:
    """Host inverse of :func:`quantize_for_fof`: a numpy ``(N, 4)`` float32
    pos_mass of the quantization cells' centres and the decoded masses
    (exact when all masses are equal)."""
    w0 = np.asarray(w0).astype(np.uint32)
    w1 = np.asarray(w1).astype(np.uint32)
    scal = np.asarray(scal, np.float64)
    mask = np.uint32((1 << bits) - 1)
    qx = w0 & mask
    qy = (w0 >> 21) | ((w1 & np.uint32(0x3FF)) << 11)
    qz = w1 >> 10
    lo, step = scal[:3], scal[3:6]
    pos = (np.stack([qx, qy, qz], axis=1).astype(np.float64) + 0.5) * step[None, :] + lo[None, :]
    mmin, dl = scal[6], scal[7]
    # mmin * exp(...), so that equal masses (dl = eps, mq = 0) decode mmin exactly
    mass = mmin * np.exp(np.asarray(mq, np.float64) / 65535.0 * dl)
    return np.concatenate([pos, mass[:, None]], axis=1).astype(np.float32)


def _fetch_words(w0, w1, mq, scal):
    """The quantized words on the host in one device-to-host copy of 10
    bytes a body (and the 32 bytes of ``scal``): numpy uint32, uint32,
    uint16 and float32."""
    n = w0.shape[0]
    buf = torch.cat([
        w0.to(torch.int32).view(torch.uint8), w1.to(torch.int32).view(torch.uint8),
        mq.to(torch.int16).view(torch.uint8), scal.to(torch.float32).view(torch.uint8),
    ]).cpu().numpy()
    return (buf[: 4 * n].view(np.uint32), buf[4 * n: 8 * n].view(np.uint32), buf[8 * n: 10 * n].view(np.uint16),
            buf[10 * n:].view(np.float32))


def fof_groups_streamed(pos_mass_device: torch.Tensor, linking_length: float | None = None, *,
                        box_size: float | None = None, mean_sep_fraction: float = 0.2, bits: int = 21):
    """:func:`fof_groups` of a device-resident state through
    :func:`quantize_for_fof`: 10 bytes a body come to the host instead of
    16.  Pass the massive rows only (``state.pos_mass[:n_real]``).
    Returns ``(labels, linking_length, pos_mass_q)``, ``pos_mass_q`` the
    dequantized host rows (the catalog's input, consistent with the
    labels)."""
    pm_q = dequantize_for_fof(*_fetch_words(*quantize_for_fof(pos_mass_device, box_size=box_size, bits=bits)),
                              bits=bits)
    labels, ll = fof_groups(pm_q, linking_length, box_size=box_size, mean_sep_fraction=mean_sep_fraction)
    return labels, ll, pm_q


def group_catalog(pos_mass, vel, labels, *, min_size: int = 20, box_size: float | None = None) -> list[dict]:
    """A record a group of :func:`fof_groups`' labels, by mass, largest
    first: ``{"label", "n", "mass", "com", "vcom", "rmax"}``; groups under
    ``min_size`` members are dropped.  On a periodic box the COM is the
    mass-weighted circular mean an axis (right for groups across the seam)
    and the radii are minimum images.  ``vel=None`` (the streamed path)
    leaves out ``vcom``.  Host numpy in float64."""
    pm = np.asarray(pos_mass, np.float64)
    v = np.zeros((pm.shape[0], 4)) if vel is None else np.asarray(vel, np.float64)
    labels = np.asarray(labels)
    sel = labels >= 0
    uniq, inv, counts = np.unique(labels[sel], return_inverse=True, return_counts=True)
    pos, m, vv = pm[sel, :3], pm[sel, 3], v[sel, :3]
    ngroup = len(uniq)
    msum = np.bincount(inv, weights=m, minlength=ngroup)
    com = np.empty((ngroup, 3))
    if box_size is not None:
        box = float(box_size)
        theta = 2.0 * np.pi * (pos / box)
        for c in range(3):
            cs = np.bincount(inv, weights=m * np.cos(theta[:, c]), minlength=ngroup)
            sn = np.bincount(inv, weights=m * np.sin(theta[:, c]), minlength=ngroup)
            com[:, c] = np.arctan2(sn, cs) % (2.0 * np.pi) / (2.0 * np.pi) * box
    else:
        for c in range(3):
            com[:, c] = np.bincount(inv, weights=m * pos[:, c], minlength=ngroup)
        com /= np.maximum(msum, 1e-30)[:, None]
    vcom = np.stack([np.bincount(inv, weights=m * vv[:, c], minlength=ngroup) for c in range(3)], axis=1)
    vcom /= np.maximum(msum, 1e-30)[:, None]
    d = pos - com[inv]
    if box_size is not None:
        d -= float(box_size) * np.floor(d / float(box_size) + 0.5)
    r = np.sqrt(np.sum(d * d, axis=1))
    rmax = np.zeros(ngroup)
    np.maximum.at(rmax, inv, r)
    keep = np.nonzero(counts >= min_size)[0]
    out = []
    for g in keep[np.argsort(-msum[keep])]:
        rec = {"label": int(uniq[g]), "n": int(counts[g]), "mass": float(msum[g]),
               "com": [float(x) for x in com[g]], "rmax": float(rmax[g])}
        if vel is not None:
            rec["vcom"] = [float(x) for x in vcom[g]]
        out.append(rec)
    return out


def format_report(s: dict) -> str:
    """:func:`summary` for a reader (``cli analyze``'s default output)."""
    lines = [
        f"bodies (massive)   {s['n_massive']:,}",
        f"total mass         {s['total_mass']:.6e}",
        "com                [" + " ".join(f"{x:.4g}" for x in s["com"]) + "]",
        "com velocity       [" + " ".join(f"{x:.4g}" for x in s["com_velocity"]) + "]",
        f"|momentum|         {sum(x * x for x in s['momentum']) ** 0.5:.6e}",
        f"|angular momentum| {sum(x * x for x in s['angular_momentum']) ** 0.5:.6e}",
        f"kinetic energy     {s['kinetic']:.6e}  (com frame {s['kinetic_com']:.6e})",
    ]
    if "potential" in s:
        lines += [
            f"potential energy   {s['potential']:.6e}",
            f"total energy       {s['total_energy']:.6e}",
            f"virial ratio 2T/|U| {s['virial_ratio']:.4f}  (1 = equilibrium)",
        ]
    lag = "  ".join(f"{k}={v:.4g}" for k, v in s["lagrangian_radii"].items())
    lines.append(f"lagrangian radii   {lag}")
    sig = s["velocity_dispersion"]
    nz = [x for x in sig if x > 0]
    if nz:
        lines.append(f"velocity dispersion  central {sig[0]:.4g}  median shell {sorted(nz)[len(nz) // 2]:.4g}")
    return "\n".join(lines)
