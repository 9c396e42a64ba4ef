"""The forward kernels' wrappers and plain twins.

Ten kernels (sources in ``nbody3d_tpu_torch/csrc/``, built by ``_build``):

====================  =======================================================
``force_exact``       all-pairs f32 force, targets x sources (exact mode)
``fused_step_exact``  ``force_exact``'s sum and the Verlet update, one launch
``force_fast``        fast mode: bf16 weights x 3-limb sources, tensor cores
``fused_step_fast``   ``force_fast``'s sum and the Verlet update, one launch
``sym_diag_prep``     sym 1: G-folded source rows + in-tile partials
``sym_diag``          sym 1, uncentred route: in-tile partials of given rows
``sym_hops``          sym 2: off-diagonal tile pairs, both directions
``sym_epilogue_``     fused sym step 3: sum the partials, mask padding, Verlet
``sym_combine``       sym force 3: sum the partials
``pair_sym``          Newton-3 pairs of two disjoint sets, both directions
====================  =======================================================

Each wrapper checks its tensors (``ops/launch.py``: float32, ``(N, 4)``,
contiguous, one device, no autograd) and then takes its plain PyTorch twin
(``*_plain``) only because the tensors lie on the CPU; on a CUDA tensor it
launches the kernel on the current stream or raises.  The kernels allocate
nothing and do not synchronise.  Each launch adds one to the kernel's count
(``ops.launch.launch_counts``, shared with the VJP kernels of ``force_vjp``), so a
run can show that it went through the kernels.

The sym passes keep f32 vector accumulators in global memory:
``acc_diag`` (written by ``sym_diag_prep`` or ``sym_diag``) and ``acc_hop``
(zeroed by the wrapper, summed into with atomics by ``sym_hops``).  Tile
size ``b`` is the CUDA block size (one thread a body, ``b <= 1024``);
``nt = N / b`` tiles.  Any ``nt >= 1`` works: odd ``nt`` has no half hop,
``nt = 2`` only the half hop, ``nt = 1`` no hop launch at all.  Two
routes use them: the fused sym step :func:`sym_step_` (diag_prep -> hops
-> epilogue, in place) and the sym force :func:`accel_sym` (-> combine),
which the unfused sym step differentiates and integrates.  Above
``ops.step.MACRO_MIN_N`` bodies the sym force is :func:`accel_sym_macro`:
``accel_sym`` on each of a few equal chunks and ``pair_sym`` on every
unordered chunk pair.

Fast mode (``force_fast``, ``fused_step_fast``) keeps the JAX package's
operands: the sources as the ``(N, 16)`` limb matrix of :func:`src_limbs`
(three bf16 limbs each of ``G*m*x``, ``G*m*y``, ``G*m*z`` and ``G*m``),
converted to bf16 once a call (the l limb rounds there, as the MXU rounds
its inputs), and the weights ``rsqrt(d2^3)`` rounded to bf16.  The kernel
and its twin read the same bf16 matrix; the kernel in the MMA B-fragment
order of :func:`fragment_order`.
"""

from __future__ import annotations

import torch

from nbody3d_tpu_torch.ops.integrate import apply_integrator, valid_mask
from nbody3d_tpu_torch.ops.launch import check_rows, check_tile, hop_blocks, launch, lib, split_hops, sym_runs


# ------------------------------------------------------------ force_exact
def force_exact_plain(
    tgt: torch.Tensor, src: torch.Tensor, G: float, eps2: float, *, chunk: int = 1024
) -> torch.Tensor:
    """Plain twin of the ``force_exact`` kernel, chunked over targets.
    Pair terms are f32 as in the kernel; each row's sum is taken in f64
    and rounded once, so the twin carries no summation-order error of its
    own and a comparison measures the other side's."""
    gm = src[:, 3] * float(G)
    sx, sy, sz = src[:, 0], src[:, 1], src[:, 2]
    out = torch.zeros_like(tgt)
    for s in range(0, tgt.shape[0], chunk):
        t = tgt[s : s + chunk]
        dx = sx[None, :] - t[:, 0:1]
        dy = sy[None, :] - t[:, 1:2]
        dz = sz[None, :] - t[:, 2:3]
        d2 = dx * dx + (dy * dy + (dz * dz + eps2))
        w = gm[None, :] * torch.rsqrt(d2 * (d2 * d2))
        for c, d in enumerate((dx, dy, dz)):
            out[s : s + chunk, c] = torch.sum(w * d, dim=1, dtype=torch.float64).to(out.dtype)
    return out


def force_exact(tgt: torch.Tensor, src: torch.Tensor, G: float, eps2: float) -> torch.Tensor:
    """Softened accelerations of ``tgt`` rows against every ``src`` row
    (both ``(N, 4)`` pos_mass; G folds into the source masses in the
    kernel).  No self mask: a zero separation adds zero.  Returns
    ``(N_t, 4)``, w lane 0."""
    dev = check_rows("force_exact", tgt, src)
    if eps2 <= 0:
        raise ValueError("eps2 must be > 0 (softening keeps the self pair finite)")
    if dev.type == "cpu":
        return force_exact_plain(tgt, src, G, eps2)
    out = torch.empty_like(tgt)
    launch(
        "force_exact", dev, lib().nb_force_exact,
        tgt, src, out, tgt.shape[0], src.shape[0], float(G), float(eps2),
    )
    return out


# ------------------------------------------------------- fused_step_exact
def _check_step(name: str, pos_mass, vel, accel, eps2: float) -> torch.device:
    """A fused step's inputs: ``check_rows``, one shape, ``eps2 > 0``."""
    dev = check_rows(name, pos_mass, vel, accel)
    if len({t.shape for t in (pos_mass, vel, accel)}) != 1:
        raise ValueError(f"{name}: pos_mass, vel and accel must have one shape")
    if eps2 <= 0:
        raise ValueError("eps2 must be > 0 (softening keeps the self pair finite)")
    return dev


def fused_step_exact_plain(
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    G: float,
    eps2: float,
    n_real: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of ``fused_step_exact``: :func:`force_exact_plain`, then
    the Verlet update of ``ops/integrate.py`` with the valid mask."""
    a = force_exact_plain(pos_mass, pos_mass, G, eps2)
    valid = valid_mask(pos_mass.shape[0], n_real, pos_mass.device)
    return apply_integrator("verlet", pos_mass, vel, accel, a, dt, valid)


def fused_step_exact(
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    G: float,
    *,
    eps2: float,
    n_real: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One exact force + Verlet step in one launch
    (``fused_step_pallas(mode="exact")``'s counterpart).  Returns new
    ``(pos_mass, vel, accel)``, each ``(N, 4)``: rows ``>= n_real`` keep
    their position and velocity and store a zero acceleration.  On the
    card it equals :func:`force_exact` followed by the torch Verlet bit for
    bit.  No gradient: the inputs may not require grad (nor does the JAX
    fused step have a VJP)."""
    dev = _check_step("fused_step_exact", pos_mass, vel, accel, eps2)
    if dev.type == "cpu":
        return fused_step_exact_plain(pos_mass, vel, accel, dt, G, eps2, n_real)
    n = pos_mass.shape[0]
    out = tuple(torch.empty_like(pos_mass) for _ in range(3))
    launch(
        "fused_step_exact", dev, lib().nb_fused_step_exact,
        pos_mass, vel, accel, *out, n, min(int(n_real), n), float(dt), float(G), float(eps2),
    )
    return out


# ------------------------------------------------------- fast-mode operands
# The diagonal sentinel: targets and sources share no global index.
NO_DIAG = 1 << 30
# The single-device diagonal: targets == sources.
SELF_DIAG = (0, 0, NO_DIAG)


def round_to_bf16(v: torch.Tensor) -> torch.Tensor:
    """f32 rounded to the nearest bf16 value (ties to even), kept in f32, by
    ``_round_to_bf16_f32``'s bit rule on the int32 view.  Bit patterns above
    +inf's (positive NaNs) are clamped first, so no add can overflow; every
    NaN is put back at the end, so NaN stays NaN."""
    u = v.contiguous().view(torch.int32).clamp(max=0x7F800000)
    r = ((u + ((u >> 16) & 1)) + 0x7FFF) & -0x10000  # & 0xFFFF0000
    return torch.where(torch.isnan(v), v, r.view(torch.float32))


def src_limbs(pos_mass: torch.Tensor, G: float) -> torch.Tensor:
    """``(N, 16)`` f32 fast-mode source matrix, bit for bit the JAX
    package's ``src_limbs``: three bf16-valued limbs (h = bf16(v), m =
    bf16(v - h), l = v - h - m) each of ``G*m*x``, ``G*m*y``, ``G*m*z`` and
    ``G*m``, then four zero columns.  Every column is limb-split, gm too
    (``csrc/mma.cuh`` says why).  The four quantities go through the limb
    split together: a few ops a call, not one set per column."""
    gm = pos_mass[:, 3:4] * float(G)
    q = torch.cat([gm * pos_mass[:, :3], gm], dim=1)  # (N, 4)
    h = round_to_bf16(q)
    rem = q - h
    m = round_to_bf16(rem)
    limbs = torch.stack([h, m, rem - m], dim=2).reshape(q.shape[0], 12)  # [q0 h m l, q1 h m l, ...]
    return torch.nn.functional.pad(limbs, (0, 4))


def limbs_bf16(pos_mass: torch.Tensor, G: float) -> torch.Tensor:
    """:func:`src_limbs` in bf16, the one matrix the kernel and its twin
    read (h and m are bf16 values already; l rounds once, to nearest even)."""
    return src_limbs(pos_mass, G).to(torch.bfloat16)


def fragment_order(limbs: torch.Tensor) -> torch.Tensor:
    """The ``(N, 16)`` bf16 limb matrix in the B-fragment order of
    ``mma.sync.m16n8k16`` (``csrc/mma.cuh``): ``(ceil(N/16) * 32, 8)``, one
    row of 8 bf16 (16 bytes) a chunk of 16 sources and a lane.  Lane ``4g +
    t`` holds ``B[k][n]`` for ``n = 8nb + g`` and ``k = 8h + 2t + e`` at
    position ``4nb + 2h + e``: b0, b1 of the MMA of columns 0-7, then of
    columns 8-15.  Rows past N are zero."""
    n = limbs.shape[0]
    chunks = -(-n // 16)
    if chunks * 16 != n:
        limbs = torch.cat([limbs, limbs.new_zeros((chunks * 16 - n, 16))])
    # (chunk, h, t, e, nb, g) -> (chunk, g, t, nb, h, e)
    b = limbs.reshape(chunks, 2, 4, 2, 2, 8).permute(0, 5, 2, 4, 1, 3)
    return b.contiguous().view(chunks * 32, 8)


def _check_diag(name: str, diag) -> tuple[int, int, int]:
    off, lo, hi = (int(x) for x in diag)
    if not all(-(1 << 31) <= x < 1 << 31 for x in (off, lo, hi)):
        raise ValueError(f"{name}: diag {diag} must be three int32 values (off, lo, hi)")
    return off, lo, hi


def _fast_epilogue(a: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``(n, 16)`` limb sums -> ``(n, 4)`` accelerations, w lane 0, in
    ``_fast_epilogue``'s order (the kernel's, operation for operation)."""
    s = (a[:, 9] + a[:, 10]) + a[:, 11]
    out = torch.zeros((a.shape[0], 4), dtype=tgt.dtype, device=tgt.device)
    for c in range(3):
        out[:, c] = ((a[:, 3 * c] + a[:, 3 * c + 1]) + a[:, 3 * c + 2]) - tgt[:, c] * s
    return out


# ------------------------------------------------------------- force_fast
def force_fast_plain(
    tgt: torch.Tensor,
    src: torch.Tensor,
    G: float,
    eps2: float,
    diag=SELF_DIAG,
    *,
    chunk: int = 1024,
) -> torch.Tensor:
    """Plain twin of ``force_fast``, chunked over targets.  The weights are
    the kernel's: f32 ``rsqrt(d2^3)``, self pairs (``col == row + off``,
    ``lo <= row < hi``) set to 0, rounded to bf16.  They multiply the same
    bf16 limb matrix; each row's sums are taken in f64 (the products of two
    bf16 values are exact there) and rounded once, so the twin carries no
    summation-order error of its own, then the f32 epilogue."""
    off, lo, hi = diag
    limbs = limbs_bf16(src, G).double()
    sx, sy, sz = src[:, 0], src[:, 1], src[:, 2]
    cols = torch.arange(src.shape[0], device=src.device)[None, :]
    out = torch.zeros_like(tgt)
    for s in range(0, tgt.shape[0], chunk):
        t = tgt[s : s + chunk]
        dx = sx[None, :] - t[:, 0:1]
        dy = sy[None, :] - t[:, 1:2]
        dz = sz[None, :] - t[:, 2:3]
        d2 = dx * dx + (dy * dy + (dz * dz + eps2))
        inv3 = torch.rsqrt(d2 * (d2 * d2))
        rows = torch.arange(s, s + t.shape[0], device=src.device)[:, None]
        self_pair = (cols - rows == off) & (rows >= lo) & (rows < hi)
        w = round_to_bf16(torch.where(self_pair, 0.0, inv3))
        out[s : s + chunk] = _fast_epilogue((w.double() @ limbs).to(tgt.dtype), t)
    return out


def force_fast(
    tgt: torch.Tensor, src: torch.Tensor, G: float, eps2: float, diag=SELF_DIAG
) -> torch.Tensor:
    """Fast-mode accelerations of ``tgt`` rows against ``src`` rows (both
    ``(N, 4)`` pos_mass), ``accel_pallas(mode="fast")``'s counterpart:
    bf16 weights on the tensor cores against the sources' bf16 limbs.
    ``diag = (off, lo, hi)`` names the self pairs (source ``row + off`` for
    target rows in ``[lo, hi)``), whose weights are 0: ``SELF_DIAG`` when
    the targets are the sources, ``(NO_DIAG, 0, NO_DIAG)`` for disjoint
    sets.  Returns ``(N_t, 4)``, w lane 0."""
    dev = check_rows("force_fast", tgt, src)
    if eps2 <= 0:
        raise ValueError("eps2 must be > 0 (softening keeps the weights finite)")
    diag = _check_diag("force_fast", diag)
    if dev.type == "cpu":
        return force_fast_plain(tgt, src, G, eps2, diag)
    out = torch.empty_like(tgt)
    frag = fragment_order(limbs_bf16(src, G))
    launch(
        "force_fast", dev, lib().nb_force_fast,
        tgt, src, frag, out, tgt.shape[0], src.shape[0], float(eps2), *diag,
    )
    return out


# -------------------------------------------------------- fused_step_fast
def fused_step_fast_plain(
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    G: float,
    eps2: float,
    n_real: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of ``fused_step_fast``: :func:`force_fast_plain` with the
    self diagonal, then the Verlet update of ``ops/integrate.py``."""
    a = force_fast_plain(pos_mass, pos_mass, G, eps2)
    valid = valid_mask(pos_mass.shape[0], n_real, pos_mass.device)
    return apply_integrator("verlet", pos_mass, vel, accel, a, dt, valid)


def fused_step_fast(
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    G: float,
    *,
    eps2: float,
    n_real: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fast force + Verlet step in one launch
    (``fused_step_pallas(mode="fast")``'s counterpart), with
    :func:`fused_step_exact`'s contract: new ``(pos_mass, vel, accel)``,
    rows ``>= n_real`` frozen with a zero acceleration, no gradient.  On
    the card it equals :func:`force_fast` followed by the torch Verlet bit
    for bit."""
    dev = _check_step("fused_step_fast", pos_mass, vel, accel, eps2)
    if dev.type == "cpu":
        return fused_step_fast_plain(pos_mass, vel, accel, dt, G, eps2, n_real)
    n = pos_mass.shape[0]
    frag = fragment_order(limbs_bf16(pos_mass, G))
    out = tuple(torch.empty_like(pos_mass) for _ in range(3))
    launch(
        "fused_step_fast", dev, lib().nb_fused_step_fast,
        pos_mass, frag, vel, accel, *out, n, min(int(n_real), n), float(dt), float(eps2),
    )
    return out


# ---------------------------------------------------------- sym_diag_prep
def sym_diag_prep_plain(
    pos_mass: torch.Tensor, G: float, eps2: float, b: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``sym_diag_prep``: ``(src, acc_diag)``."""
    src = sym_source_rows(pos_mass, G)
    return src, sym_diag_plain(src, eps2, b)


def sym_diag_prep(
    pos_mass: torch.Tensor, G: float, eps2: float, b: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sym step 1.  Returns ``(src, acc_diag)``: the G-folded source rows
    ``[x, y, z, G*m]`` and each tile's in-tile partial accelerations (all
    ordered pairs of the tile, self pair skipped), both ``(N, 4)``."""
    dev = check_rows("sym_diag_prep", pos_mass)
    nt = check_tile("sym_diag_prep", pos_mass.shape[0], b, min_tiles=1)
    if dev.type == "cpu":
        return sym_diag_prep_plain(pos_mass, G, eps2, b)
    src = torch.empty_like(pos_mass)
    acc = torch.empty_like(pos_mass)
    launch(
        "sym_diag_prep", dev, lib().nb_sym_diag_prep,
        pos_mass, src, acc, nt, b, float(G), float(eps2),
    )
    return src, acc


# --------------------------------------------------------------- sym_diag
def sym_source_rows(pos_mass: torch.Tensor, G: float) -> torch.Tensor:
    """The G-folded source rows ``[x, y, z, G*m]`` that the sym passes read
    (what ``sym_diag_prep`` writes, the same f32 product)."""
    return torch.cat([pos_mass[:, :3], pos_mass[:, 3:4] * float(G)], dim=1)


def sym_diag_plain(src: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """Plain twin of ``sym_diag``: ``sym_diag_prep_plain``'s in-tile sum on
    the given source rows."""
    n = src.shape[0]
    nt = n // b
    tiles = src.view(nt, b, 4)
    d = tiles[:, None, :, :3] - tiles[:, :, None, :3]  # (nt, t, s, 3): x_s - x_t
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    d2 = dx * dx + (dy * dy + (dz * dz + eps2))
    w = tiles[:, None, :, 3] * torch.rsqrt(d2 * (d2 * d2))
    w = w * (1.0 - torch.eye(b, dtype=w.dtype, device=w.device))
    return torch.stack(
        [torch.sum(w * dx, dim=2), torch.sum(w * dy, dim=2), torch.sum(w * dz, dim=2),
         torch.zeros_like(dx[..., 0])],
        dim=2,
    ).reshape(n, 4)


def sym_diag(src: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """The uncentred route's first pass.  ``src`` are the prepared source
    rows ``[x, y, z, G*m]`` (:func:`sym_source_rows`); returns ``acc_diag
    (N, 4)``: each tile's in-tile partial accelerations, self pair skipped."""
    dev = check_rows("sym_diag", src)
    nt = check_tile("sym_diag", src.shape[0], b, min_tiles=1)
    if dev.type == "cpu":
        return sym_diag_plain(src, eps2, b)
    acc = torch.empty_like(src)
    launch("sym_diag", dev, lib().nb_sym_diag, src, acc, nt, b, float(eps2))
    return acc


# --------------------------------------------------------------- sym_hops
def sym_hops_plain(src: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """Plain twin of ``sym_hops``: ``acc_hop`` over the same pair sets."""
    n = src.shape[0]
    nt = n // b
    tiles = src.view(nt, b, 4)
    acc = torch.zeros((nt, b, 4), dtype=src.dtype, device=src.device)
    for k0, nk, grid_i in split_hops(nt):
        ii = torch.arange(grid_i, device=src.device)
        for k in range(k0, k0 + nk):
            jj = (ii + k) % nt
            ti, tj = tiles[ii], tiles[jj]  # (g, b, 4)
            d = tj[:, None, :, :3] - ti[:, :, None, :3]  # (g, t, s, 3)
            dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
            d2 = dx * dx + (dy * dy + (dz * dz + eps2))
            inv3 = torch.rsqrt(d2 * (d2 * d2))
            wf = tj[:, None, :, 3] * inv3
            wr = ti[:, :, None, 3] * inv3
            fwd = torch.stack(
                [torch.sum(wf * dx, 2), torch.sum(wf * dy, 2), torch.sum(wf * dz, 2)], dim=2
            )
            rev = -torch.stack(
                [torch.sum(wr * dx, 1), torch.sum(wr * dy, 1), torch.sum(wr * dz, 1)], dim=2
            )
            acc[:, :, :3].index_add_(0, ii, fwd)
            acc[:, :, :3].index_add_(0, jj, rev)
    return acc.view(n, 4)


def sym_hops(src: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """Sym step 2.  Returns ``acc_hop (N, 4)``: for every unordered tile
    pair, the forward partial on the target tile and the reverse (Newton-3)
    partial on the source tile, each pair's weight computed once.  One tile
    has no pair: zeros, and no launch (the JAX package skips its hop calls
    there)."""
    dev = check_rows("sym_hops", src)
    nt = check_tile("sym_hops", src.shape[0], b, min_tiles=1)
    if dev.type == "cpu":
        return sym_hops_plain(src, eps2, b)
    acc = torch.zeros_like(src)
    fn = lib().nb_sym_hops
    for k0, nk, grid_i, runs in hop_blocks(nt):
        launch("sym_hops", dev, fn, src, acc, nt, b, k0, nk, grid_i, runs, float(eps2))
    return acc


# ----------------------------------------------------------- sym_epilogue
def sym_epilogue_plain_(
    acc_diag: torch.Tensor,
    acc_hop: torch.Tensor,
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    n_real: int,
) -> None:
    """Plain twin of ``sym_epilogue_`` (same op order, in place)."""
    n = pos_mass.shape[0]
    valid = valid_mask(n, n_real, pos_mass.device)
    p, v, a = apply_integrator(
        "verlet", pos_mass, vel, accel, acc_diag + acc_hop, dt, valid
    )
    pos_mass.copy_(p)
    vel.copy_(v)
    accel.copy_(a)


def sym_epilogue_(
    acc_diag: torch.Tensor,
    acc_hop: torch.Tensor,
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    n_real: int,
) -> None:
    """Sym step 3, in place: ``a = acc_diag + acc_hop``; rows ``>= n_real``
    stay frozen with zero stored acceleration; the rest take the
    frame-shifted Verlet update, written into ``pos_mass``/``vel``/``accel``."""
    dev = check_rows("sym_epilogue", acc_diag, acc_hop, pos_mass, vel, accel)
    if len({t.shape for t in (acc_diag, acc_hop, pos_mass, vel, accel)}) != 1:
        raise ValueError("sym_epilogue: all five tensors must have one shape")
    if dev.type == "cpu":
        sym_epilogue_plain_(acc_diag, acc_hop, pos_mass, vel, accel, dt, n_real)
        return
    n = pos_mass.shape[0]
    launch(
        "sym_epilogue", dev, lib().nb_sym_epilogue,
        acc_diag, acc_hop, pos_mass, vel, accel, n, min(int(n_real), n),
        float(dt),
    )


def sym_step_(
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    dt: float,
    G: float,
    *,
    eps2: float,
    b: int,
    n_real: int,
) -> None:
    """The fused Newton-3 Verlet step (``sym_verlet_step_pallas``'s
    counterpart): diag_prep -> hops -> epilogue, updating the state in
    place."""
    src, acc_diag = sym_diag_prep(pos_mass, G, eps2, b)
    acc_hop = sym_hops(src, eps2, b)
    sym_epilogue_(acc_diag, acc_hop, pos_mass, vel, accel, dt, n_real)


# ------------------------------------------------------------ sym_combine
def sym_combine_plain(acc_diag: torch.Tensor, acc_hop: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``sym_combine``: the same adds, w lane 0."""
    a = acc_diag + acc_hop
    a[:, 3] = 0.0
    return a


def sym_combine(acc_diag: torch.Tensor, acc_hop: torch.Tensor) -> torch.Tensor:
    """Sym force 3: ``a = acc_diag + acc_hop``, w lane 0, on every row
    (``combine16_pallas``'s counterpart: no ``n_real``; padded rows carry
    the pull of the real bodies, and the integrator's mask freezes them)."""
    dev = check_rows("sym_combine", acc_diag, acc_hop)
    if acc_diag.shape != acc_hop.shape:
        raise ValueError("sym_combine: acc_diag and acc_hop must have one shape")
    if dev.type == "cpu":
        return sym_combine_plain(acc_diag, acc_hop)
    out = torch.empty_like(acc_diag)
    launch("sym_combine", dev, lib().nb_sym_combine, acc_diag, acc_hop, out, acc_diag.shape[0])
    return out


def accel_sym(
    pos_mass: torch.Tensor, G: float, *, eps2: float, b: int, center: bool = True
) -> torch.Tensor:
    """All-pairs accelerations ``(N, 4)`` through the Newton-3 schedule with
    tile ``b`` (``accel_sym_pallas``'s counterpart), any ``nt = N / b >= 1``.
    ``center=True``: ``sym_diag_prep`` -> ``sym_hops`` -> ``sym_combine``;
    ``center=False`` (the JAX package's ablation route, operands built
    outside the kernels): torch builds the source rows, then ``sym_diag`` ->
    ``sym_hops`` -> ``sym_combine``.  With no limbs to centre, both routes
    compute the same sums: on one device they give the same bits."""
    if eps2 <= 0:
        raise ValueError("eps2 must be > 0 (softening keeps the self pair finite)")
    if center:
        src, acc_diag = sym_diag_prep(pos_mass, G, eps2, b)
    else:
        src = sym_source_rows(pos_mass, G)
        acc_diag = sym_diag(src, eps2, b)
    return sym_combine(acc_diag, sym_hops(src, eps2, b))


# --------------------------------------------------------------- pair_sym
def accel_pair_sym_plain(
    tgt: torch.Tensor, src: torch.Tensor, G: float, *, eps2: float, b: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``pair_sym``, target tile by target tile: each pair's
    f32 weight ``inv3 = rsqrt(d2^3)`` once, ``G*m_j*inv3*d`` summed onto
    the target and ``-G*m_i*inv3*d`` onto the source.  Each row's sums are
    taken in f64 and rounded once, so the twin carries no summation-order
    error of its own."""
    gm_s = src[:, 3] * float(G)
    sx, sy, sz = src[:, 0], src[:, 1], src[:, 2]
    acc_t = torch.zeros_like(tgt)
    rev = torch.zeros((src.shape[0], 3), dtype=torch.float64, device=src.device)
    for s in range(0, tgt.shape[0], b):
        t = tgt[s : s + b]
        dx = sx[None, :] - t[:, 0:1]
        dy = sy[None, :] - t[:, 1:2]
        dz = sz[None, :] - t[:, 2:3]
        d2 = dx * dx + (dy * dy + (dz * dz + eps2))
        inv3 = torch.rsqrt(d2 * (d2 * d2))
        wf = gm_s[None, :] * inv3
        wr = (t[:, 3:4] * float(G)) * inv3
        for c, d in enumerate((dx, dy, dz)):
            acc_t[s : s + b, c] = torch.sum(wf * d, dim=1, dtype=torch.float64).to(tgt.dtype)
            rev[:, c] -= torch.sum(wr * d, dim=0, dtype=torch.float64)
    acc_s = torch.zeros_like(src)
    acc_s[:, :3] = rev.to(src.dtype)
    return acc_t, acc_s


def accel_pair_sym(
    tgt: torch.Tensor, src: torch.Tensor, G: float, *, eps2: float, b: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forces between two disjoint body sets, both directions from one
    weight a pair (``accel_pair_sym_pallas``'s counterpart): returns
    ``(acc_t (Nt, 4), acc_s (Ns, 4))``, w lanes 0, for pos_mass rows ``tgt``
    and ``src`` whose counts are multiples of the tile ``b`` (they may
    differ).  No self-pair mask: the sets are disjoint by precondition."""
    dev = check_rows("pair_sym", tgt, src)
    if eps2 <= 0:
        raise ValueError("eps2 must be > 0 (softening keeps the pair weights finite)")
    nt = check_tile("pair_sym", tgt.shape[0], b, min_tiles=1)
    ns = check_tile("pair_sym", src.shape[0], b, min_tiles=1)
    if ns > 65535:
        raise ValueError(f"pair_sym: {ns} source tiles exceed the launch grid's 65,535 (tile {b})")
    if dev.type == "cpu":
        return accel_pair_sym_plain(tgt, src, G, eps2=eps2, b=b)
    acc_t = torch.zeros_like(tgt)
    acc_s = torch.zeros_like(src)
    launch(
        "pair_sym", dev, lib().nb_pair_sym, tgt, src, acc_t, acc_s, nt, ns, sym_runs(ns), b, float(G), float(eps2)
    )
    return acc_t, acc_s


def accel_sym_macro(pos_mass: torch.Tensor, G: float, *, eps2: float, b: int, m_chunks: int) -> torch.Tensor:
    """All-pairs accelerations ``(N, 4)`` through the macro-tiled Newton-3
    schedule (``make_sym_accel_fn``'s composition above ``SYM_MAX_N`` in
    the JAX package): ``m_chunks`` equal chunks, :func:`accel_sym` on each,
    :func:`accel_pair_sym` on every unordered chunk pair ``a < c``, its
    target part added to chunk a and its source part to chunk c."""
    n = pos_mass.shape[0]
    if m_chunks < 1 or n % m_chunks:
        raise ValueError(f"accel_sym_macro: {m_chunks} chunks do not divide N={n}")
    size = n // m_chunks
    chunks = [pos_mass[a * size : (a + 1) * size] for a in range(m_chunks)]
    accs = [accel_sym(c, G, eps2=eps2, b=b) for c in chunks]
    for a in range(m_chunks):
        for c in range(a + 1, m_chunks):
            at, ac = accel_pair_sym(chunks[a], chunks[c], G, eps2=eps2, b=b)
            accs[a] += at
            accs[c] += ac
    return torch.cat(accs, dim=0)
