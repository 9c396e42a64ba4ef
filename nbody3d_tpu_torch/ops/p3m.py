"""P3M gravity, isolated and periodic boundary: ``nbody3d_tpu/ops/p3m.py``.

The Plummer-softened pair force splits into a long range, smooth on the
scale ``sigma`` (a few cells), that the mesh carries (TSC deposit,
zero-padded FFT convolution with the sampled gradient kernels, TSC
gather, in :func:`accel_p3m`), and a short-range residual with pair
scalar

    k_short(r) = erfc(u)/s³ + (2/sqrt(pi)) e^{-u²} / (sqrt2 sigma s r),
    u = r / (sqrt2 sigma),  s = sqrt(r² + eps2),

cut at ``rcut = rcut_sigmas · sigma``.  The short range is block-sparse
direct: bodies are Morton-sorted, cut into tiles of ``block`` rows, each
target tile takes its ``nbr_k`` nearest source tiles by bounding-box
distance (:func:`_select_neighbors`, a mutual relation through
:func:`mutual_neighbor_mask`), and the ``short_range`` kernel sums the
pairs (:func:`short_range_tiles`).  The ``heavy_k`` most massive bodies
leave the mesh and the short range and take exact pairs with everyone
(:func:`heavy_split`, :func:`heavy_direct`).

The neighbour selection is integer and gate arithmetic that must pick
the JAX package's tiles: the same f32 distances, the same int32 jitter
hash, and top-k by a stable descending sort, which like ``lax.top_k``
puts the lower index first among equal values.  Where the JAX package
maps over row chunks and super-tiles with ``lax.map``, the port runs
batched tensor ops.

Gradients flow through :func:`accel_p3m` as ``jax.grad`` flows through the
JAX function: the short range is :class:`_ShortRange`, whose backward is
the ``short_range_bwd`` kernel (:func:`short_range_tiles_bwd`), the mesh
legs ``mesh_cuda.deposit_diff``/``gather_diff``, and autograd takes the
FFT solve, the box (``lo``, ``h``: ``sigma = sigma_cells·h`` carries the
short range's σ cotangent into the positions), the net-force projection
and the heavy pairs.  The selection runs on detached rows.

``boundary="periodic"`` (:func:`_accel_p3m_periodic`) is Ewald's method on
the torus ``[0, L)³``: the mesh is the reciprocal-space sum
(``ewald.spectral_accel_grids``, TSC cells wrapped mod grid, optionally
two half-cell-shifted legs averaged: ``interlace``), and the short range
is ``ewald.k_short_periodic`` over minimum-image pairs, the tiles chosen
by the periodic AABB gap.  The box is fixed (``h = L/grid``) and the
heavy split is off.  Gradients flow through it as through the isolated
form: :class:`_ShortRange` with the box runs the periodic form of
``short_range_bwd`` (:func:`_k_short_periodic_grads` is its pair
arithmetic), the mesh legs the periodic VJPs of ``mesh_cuda``, and
autograd takes the wrap (its floor has derivative 0), the Morton
permutation, the spectral solve and the net-force projection.
"""

from __future__ import annotations

import functools
import math

import torch

from nbody3d_tpu_torch.ops import mesh_cuda
from nbody3d_tpu_torch.ops.blocks import divisor_block
from nbody3d_tpu_torch.ops.ewald import k_long_terms, k_short_periodic, spectral_accel_grids, wrap_box
from nbody3d_tpu_torch.ops.launch import check_rows, launch, lib
from nbody3d_tpu_torch.ops.morton import morton_keys
from nbody3d_tpu_torch.ops.pm import _box, _cic_cells, _offset_axis, _pad, clip
from nbody3d_tpu_torch.utils.profiling import span

_SQRT2 = 1.4142135623730951
_TWO_OVER_SQRT_PI = 1.1283791670955126

DEFAULT_HEAVY_K = 16
DEFAULT_SIGMA_CELLS = 1.5
DEFAULT_RCUT_SIGMAS = 4.5
DEFAULT_NBR_K = 32
DEFAULT_BLOCK = 256

# Rows of the flat (rows, nb) tile-distance matrix made at once.
_NBR_ROW_CHUNK = 2048
# Past this many tiles the selection is two-level (super-tiles of _SUPER
# consecutive tiles), as in the JAX package.
_FLAT_MAX_TILES = 8192
_SUPER = 32
DEFAULT_SUP_K = 12
# The hierarchy's distance for a tile whose super-tile pair was not
# admitted: it never wins a top-k slot it can avoid, and its slots are dead.
_NOT_ADMITTED = 1e30
# Candidate distances made at once by the hierarchy's fine level, and pairs
# at once by the short-range twin.
_FINE_BATCH = 1 << 24
_PAIR_BATCH = 1 << 23


def heavy_split(pos_mass: torch.Tensor, heavy_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hidx (K,), mass with those rows zeroed)``: the ``heavy_k`` most
    massive bodies, by a stable descending sort (the lower index first
    among equal masses, as ``lax.top_k``; ``torch.topk`` promises no order
    among ties, and the two-galaxy preset picks 14 of its 16 by the tie)."""
    m = pos_mass[:, 3]
    hidx = torch.sort(m, descending=True, stable=True).indices[:heavy_k]
    return hidx, m.index_fill(0, hidx, 0.0)


def heavy_direct(pos_mass: torch.Tensor, hidx: torch.Tensor, eps2: float):
    """Exact softened pairs between the heavy set and every body, per unit
    G: ``(a_from_heavy (N, 3), a_on_heavy (K, 3))`` from the same pair
    terms, so the block is antisymmetric (momentum)."""
    return heavy_pairs(pos_mass, pos_mass[hidx], eps2)


def heavy_pairs(pos_mass: torch.Tensor, hp: torch.Tensor, eps2: float):
    """:func:`heavy_direct` against the heavy rows ``hp (K, 4)`` themselves:
    a shard's rows against the whole heavy set, whose ``a_on_heavy`` parts
    the sharded step sums over the ranks."""
    d = hp[None, :, :3] - pos_mass[:, None, :3]  # (N, K, 3), toward heavy
    r2 = torch.sum(d * d, dim=-1)
    inv_s = torch.rsqrt(r2 + eps2)
    w = inv_s * inv_s * inv_s * (r2 > 0)
    a_from = torch.sum((w * hp[None, :, 3])[:, :, None] * d, dim=1)
    a_on = -torch.sum((w * pos_mass[:, 3:4])[:, :, None] * d, dim=0)
    return a_from, a_on


def p3m_block(n: int, block: int = 0) -> int:
    """The short-range tile: ``block`` if > 0, else ``DEFAULT_BLOCK``,
    shrunk to a divisor of ``n``."""
    want = min(block, n) if block else min(DEFAULT_BLOCK, n)
    return divisor_block(n, want, floor=1)


# ---------------------------------------------------------------- the mesh
def _tsc_cells(pos: torch.Tensor, lo: torch.Tensor, h: torch.Tensor, grid: int, periodic: bool = False):
    """TSC nearest cell ``c (N, 3) int32`` in [1, grid-2] and offset
    ``f = s - c`` in [-1/2, 1/2]; the weights come from ``f`` alone
    (``mesh_cuda.axis_weights``).  ``periodic``: ``c`` is the nearest cell
    mod ``grid`` (its neighbours wrap in the kernels), ``f`` is taken
    against the unwrapped cell."""
    s = (pos - lo) / h - 0.5
    if periodic:
        raw = torch.floor(s + 0.5)
        return torch.remainder(raw.to(torch.int32), grid), clip(s - raw, -0.5, 0.5)
    c = torch.clamp(torch.floor(s + 0.5).to(torch.int32), 1, grid - 2)
    f = clip(s - c.to(s.dtype), -0.5, 0.5)
    return c, f


def tsc_deposit(pos: torch.Tensor, mass: torch.Tensor, lo: torch.Tensor, h: torch.Tensor, grid: int) -> torch.Tensor:
    """Order-3 mass deposit → ``(grid, grid, grid)`` (the twin of
    ``mesh_deposit`` at order 3)."""
    c, f = _tsc_cells(pos, lo, h, grid)
    return mesh_cuda.deposit_plain(*mesh_cuda.mesh_operands(c, f, mass), grid, 3)


def tsc_gather(grids: torch.Tensor, c: torch.Tensor, f: torch.Tensor, grid: int) -> torch.Tensor:
    """Order-3 interpolation of ``(3, M³)`` grids at the cells and offsets
    of :func:`_tsc_cells` → ``(N, 3)`` (the twin of ``mesh_gather`` at order
    3; the JAX function takes the weight stack in place of ``f``)."""
    return mesh_cuda.gather_plain(grids, *mesh_cuda.mesh_operands(c, f), grid, 3)[:, :3]


def solve_accel_long(
    rho: torch.Tensor, h: torch.Tensor, eps2: float, sigma: torch.Tensor, order: int = 3
) -> torch.Tensor:
    """Acceleration grids of the erf-smoothed kernel per unit G → ``(3, M³)``:
    the deposited mass convolved on the zero-padded ``(2M)³`` grid with the
    three sampled gradient kernels ``-d_a · k_long(|d|)`` (antipode plane
    zeroed, so each circulant kernel is odd), after dividing the mass
    spectrum by the assignment window ``sinc^(2·order)`` per axis."""
    m = rho.shape[0]
    m2 = 2 * m
    idx, d = _offset_axis(m2, h)
    r2 = d[:, None, None] ** 2 + d[None, :, None] ** 2 + d[None, None, :] ** 2
    mask0 = r2 > 0
    r2s = torch.where(mask0, r2, 1.0)
    r = torch.sqrt(r2s)
    u = r / (_SQRT2 * sigma)
    inv_s = torch.rsqrt(r2s + eps2)
    gauss = _TWO_OVER_SQRT_PI * torch.exp(-u * u) / (_SQRT2 * sigma)
    klong = torch.special.erf(u) * inv_s * inv_s * inv_s - gauss * inv_s * torch.rsqrt(r2s)
    klong = torch.where(mask0, klong, 0.0)
    del r2, r2s, r, u, inv_s, gauss

    fx = torch.fft.fftfreq(m2, device=rho.device, dtype=torch.float32)
    fr = torch.fft.rfftfreq(m2, device=rho.device, dtype=torch.float32)
    deconv = (torch.sinc(fx)[:, None, None] * torch.sinc(fx)[None, :, None] * torch.sinc(fr)[None, None, :]) ** (
        -2 * order
    )
    rho_hat = torch.fft.rfftn(_pad(rho)) * deconv
    keep = idx != m  # the antipode plane stands for both +m·h and -m·h
    out = []
    for axis in range(3):
        shape = [1, 1, 1]
        shape[axis] = m2
        da = d.view(shape)
        kern = torch.where(keep.view(shape), -da * klong, 0.0)
        a = torch.fft.irfftn(rho_hat * torch.fft.rfftn(kern), s=(m2, m2, m2))
        out.append(a[:m, :m, :m].reshape(-1))
    return torch.stack(out, dim=0)


def k_short(r2: torch.Tensor, eps2: float, sigma: torch.Tensor) -> torch.Tensor:
    """The short-range pair scalar ``k_exact - k_long``; 0 at r = 0."""
    mask = r2 > 0
    r2s = torch.where(mask, r2, 1.0)
    r = torch.sqrt(r2s)
    inv_s = torch.rsqrt(r2s + eps2)
    u = r / (_SQRT2 * sigma)
    gauss = _TWO_OVER_SQRT_PI * torch.exp(-u * u) / (_SQRT2 * sigma)
    k = torch.special.erfc(u) * inv_s * inv_s * inv_s + gauss * inv_s * torch.rsqrt(r2s)
    return torch.where(mask, k, 0.0)


# ------------------------------------------------------ neighbour selection
def _sorted_aabbs(ps: torch.Tensor, n_real: int, block: int, row0: int = 0):
    """Per-tile bounding boxes ``(lo (nb, 3), hi (nb, 3))`` over the real
    rows; after the stable Morton sort the padding rows are the tail, and
    an all-padding tile has lo = +inf, hi = -inf.  ``row0``: the global
    sorted row of ``ps``' first (a rank's slice of the sorted layout)."""
    n = ps.shape[0]
    nb = n // block
    xyz = ps[:, :3].reshape(nb, block, 3)
    valid = (torch.arange(row0, row0 + n, device=ps.device) < n_real).reshape(nb, block, 1)
    lo = torch.amin(torch.where(valid, xyz, math.inf), dim=1)
    hi = torch.amax(torch.where(valid, xyz, -math.inf), dim=1)
    return lo, hi


def _gap_dist2(lo_t, hi_t, lo_s, hi_s, L=None) -> torch.Tensor:
    """Squared AABB gap distance of broadcastable ``(..., 3)`` boxes (a
    lower bound on any pair distance between them), rounded as the JAX
    package's compiled selection rounds it: XLA contracts the sum of
    squares into ``fma(g2, g2, fma(g1, g1, g0·g0))``, and the f64 sums
    below round once each, as an FMA does.

    ``L`` (the periodic box): the gap per axis on the circle of
    circumference ``L``, the minimum-image centre distance less the two
    half-extents, so tiles facing each other across the seam are near; a
    padding tile (lo = +inf, hi = -inf) is at 1e30 from everything."""
    if L is None:
        gap = torch.maximum(lo_s - hi_t, lo_t - hi_s)
    else:
        bad_t, bad_s = ~(hi_t[..., :1] >= lo_t[..., :1]), ~(hi_s[..., :1] >= lo_s[..., :1])
        lo_t, hi_t = torch.where(bad_t, 0.0, lo_t), torch.where(bad_t, 0.0, hi_t)
        lo_s, hi_s = torch.where(bad_s, 0.0, lo_s), torch.where(bad_s, 0.0, hi_s)
        dc = torch.abs(0.5 * (lo_s + hi_s) - 0.5 * (lo_t + hi_t))
        dc = torch.minimum(dc, L - dc)
        gap = dc - (0.5 * (hi_t - lo_t) + 0.5 * (hi_s - lo_s))
    gap = torch.clamp(gap, 0.0, 1e18).double()  # padding tiles' infs stay finite when squared
    acc = (gap[..., 0] * gap[..., 0]).float().double()
    acc = (gap[..., 1] * gap[..., 1] + acc).float().double()
    d2 = (gap[..., 2] * gap[..., 2] + acc).float()
    return d2 if L is None else torch.where((bad_t | bad_s)[..., 0], 1e30, d2)


def _aabb_dist2(lo_t, hi_t, lo_s, hi_s, L=None) -> torch.Tensor:
    """``(nt, ns)`` squared gap distances, target tiles x source tiles."""
    return _gap_dist2(lo_t[:, None], hi_t[:, None], lo_s[None], hi_s[None], L)


def _sym_jitter_ids(i_ids: torch.Tensor, j_ids: torch.Tensor, h: torch.Tensor):
    """The symmetric tie-break ``u(i, j) · scale`` of the JAX package, as its
    two factors: ``u = u(j, i)`` in [0, 1) from the int32 hash (only the
    low 16 bits are kept, so int64 arithmetic gives the same bits as int32
    wrap-around) and ``scale = 1e-6 h²``, far below any separation that
    matters and far above f32 noise in the symmetric AABB distances."""
    a = torch.minimum(i_ids, j_ids).long()
    b = torch.maximum(i_ids, j_ids).long()
    u = ((a * 1540483477 + b * 40503) & 0xFFFF).to(torch.float32) / 65536.0
    return u, 1e-6 * h * h


def _add_jitter(d2: torch.Tensor, i_ids: torch.Tensor, j_ids: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``d2 + u · scale`` (:func:`_sym_jitter_ids`) rounded once, as XLA's
    ``fma(u, scale, d2)`` in the JAX package's compiled selection."""
    u, scale = _sym_jitter_ids(i_ids, j_ids, h)
    return (d2.double() + u.double() * scale.double()).float()


def _prefer_self(d2: torch.Tensor, i_ids: torch.Tensor, j_ids: torch.Tensor) -> torch.Tensor:
    """Pin the self entry to -1e30 so that it is never dropped from top-k."""
    return torch.where(i_ids == j_ids, -1e30, d2)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last dim: the k largest, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _select_flat(lo_b, hi_b, h, k, L=None, row0=0, nrows=None):
    """Top-``k`` nearest tiles for the rows ``row0 .. row0 + nrows`` (all
    ``nb`` by default) over all ``nb`` candidates, in row chunks.  ``(kth
    (nrows,), neg (nrows, k), idx (nrows, k))``."""
    nb = lo_b.shape[0]
    nrows = nb - row0 if nrows is None else nrows
    cols = torch.arange(nb, device=lo_b.device)
    negs, idxs = [], []
    for r0 in range(row0, row0 + nrows, _NBR_ROW_CHUNK):
        rows = cols[r0 : min(r0 + _NBR_ROW_CHUNK, row0 + nrows)]
        d2 = _add_jitter(_aabb_dist2(lo_b[rows], hi_b[rows], lo_b, hi_b, L), rows[:, None], cols[None, :], h)
        d2 = _prefer_self(d2, rows[:, None], cols[None, :])
        neg, idx = _top_k(-d2, k)
        negs.append(neg)
        idxs.append(idx)
    neg, idx = torch.cat(negs), torch.cat(idxs)
    return -neg[:, -1], neg, idx


def _select_neighbors(lo_b, hi_b, h, nbr_k, L=None, *, row0=0, nrows=None):
    """Top-``nbr_k`` nearest source tiles of the target tiles ``row0 ..
    row0 + nrows`` (every tile by default; a rank's own tiles in the
    sharded step), by jittered AABB distance over all ``nb`` tiles:
    ``(kth (nrows,), neg (nrows, k), nbr_idx (nrows, k))`` with ``neg`` the
    negated distances (descending), ``kth`` each row's k-th smallest and
    global tile ids.  Flat up to ``_FLAT_MAX_TILES`` tiles, two-level past
    it.  ``L``: the periodic box's gap (:func:`_gap_dist2`)."""
    if lo_b.shape[0] > _FLAT_MAX_TILES:
        return _select_neighbors_hier(lo_b, hi_b, h, nbr_k, L=L, row0=row0, nrows=nrows)
    return _select_flat(lo_b, hi_b, h, nbr_k, L, row0, nrows)


def _select_neighbors_hier(lo_b, hi_b, h, nbr_k, sup_k=DEFAULT_SUP_K, L=None, *, row0=0, nrows=None):
    """The two-level selection of ``nbody3d_tpu``'s ``_select_neighbors_hier``:
    super-tiles of ``sup`` consecutive tiles take their ``k_s`` nearest
    supers, a super pair is admitted only mutually, and each target tile
    takes its top-``nbr_k`` among the admitted supers' tiles (others at
    +1e30).  ``sup`` divides ``nb`` and the row count (at odd ``nb``, 2M
    bodies: 8,193 tiles, it is 1), and ``row0`` is a multiple of it."""
    nb = lo_b.shape[0]
    nrows = nb - row0 if nrows is None else nrows
    sup = _SUPER
    while sup > 1 and (nb % sup != 0 or nrows % sup != 0):
        sup //= 2
    if row0 % sup:
        raise ValueError(f"target rows from {row0} do not start a super-tile of {sup}")
    nsup = nb // sup
    k_s = min(max(sup_k, -(-nbr_k // sup) + 2), nsup)
    nbr_k = min(nbr_k, k_s * sup)

    lo_s = torch.amin(lo_b.view(nsup, sup, 3), dim=1)
    hi_s = torch.amax(hi_b.view(nsup, sup, 3), dim=1)
    kth_s, neg_s, sup_idx = _select_flat(lo_s, hi_s, h, k_s, L)
    sup_ok = (-neg_s) <= kth_s[sup_idx]  # mutual admission: symmetric

    lane = torch.arange(sup, device=lo_b.device)
    lo_t3, hi_t3 = lo_b.view(nsup, sup, 3), hi_b.view(nsup, sup, 3)
    step = max(1, _FINE_BATCH // (sup * k_s * sup))
    kths, negs, idxs = [], [], []
    sup0, sup1 = row0 // sup, (row0 + nrows) // sup
    for a0 in range(sup0, sup1, step):
        sups = torch.arange(a0, min(a0 + step, sup1), device=lo_b.device)
        cand = (sup_idx[sups][:, :, None] * sup + lane).reshape(len(sups), k_s * sup)  # (S, C)
        cmask = sup_ok[sups].repeat_interleave(sup, dim=1)
        d2 = _gap_dist2(lo_t3[sups][:, :, None], hi_t3[sups][:, :, None],
                        lo_b[cand][:, None], hi_b[cand][:, None], L)  # (S, sup, C)
        i_ids = (sups[:, None] * sup + lane)[:, :, None]
        d2 = _add_jitter(d2, i_ids, cand[:, None, :], h)
        d2 = torch.where(cmask[:, None, :], d2, _NOT_ADMITTED)
        d2 = _prefer_self(d2, i_ids, cand[:, None, :])
        neg, li = _top_k(-d2, nbr_k)
        kths.append(-neg[..., -1])
        negs.append(neg)
        idxs.append(torch.gather(cand[:, None, :].expand(-1, sup, -1), 2, li))
    return (torch.cat(kths).reshape(nrows), torch.cat(negs).reshape(nrows, nbr_k),
            torch.cat(idxs).reshape(nrows, nbr_k))


def mutual_neighbor_mask(neg_d2s: torch.Tensor, nbr_idx: torch.Tensor, kth_all: torch.Tensor) -> torch.Tensor:
    """``(nt, k)`` float mask keeping pair (i, j) iff ``d2s(i, j) <=
    min(kth(i), kth(j))``: "j in i's top-k and i in j's", so the pair set
    is symmetric and the short-range sum antisymmetric (momentum).

    Unlike the JAX package's mask, a slot of the two-level selection that
    holds a non-admitted tile (distance ``_NOT_ADMITTED``) is dead too.  A
    row with fewer admitted candidates than k has ``kth = 1e30``, and the
    JAX mask then keeps its non-admitted slots against any other such row,
    though the other row does not list it: a one-sided pair.  With supers
    of one tile (an odd tile count: 8,193 tiles at 2M bodies) most rows are
    such rows, and the leak cost 5e-5 of sum |m v| in momentum over 30
    steps of a 2M-body two-galaxy run.  Everywhere else the two masks
    agree."""
    vals = -neg_d2s
    return ((vals <= kth_all[nbr_idx]) & (vals != _NOT_ADMITTED)).to(torch.float32)


# --------------------------------------------------------- the short range
def min_image(d: torch.Tensor, box: float) -> torch.Tensor:
    """The minimum image of separations ``|d| < box``: one conditional
    shift by ``box`` an axis, as the Pallas kernel shifts (p3m.py:730-735
    of the JAX package)."""
    half = 0.5 * box
    return d - torch.where(d > half, box, 0.0) + torch.where(d < -half, box, 0.0)


def _short_range_tiles(ps, nbr_idx, eps2, sigma, rcut, block, nbr_mask, box=None) -> torch.Tensor:
    """Plain twin of ``short_range``: for each target tile (the first
    ``nt`` tiles of ``ps``, one a row of ``nbr_idx (nt, k)``; sources are
    any tiles of ``ps``) a dense pair sum over its neighbour tiles, with the
    exact ``erfc``.  ``(nt·block, 4)``, w lane 0, in sorted order.  Slots
    that add exactly nothing (mask 0, or a source tile of zero mass) are
    left out, as are pairs outside the cut; tiles go in batches of about
    ``_PAIR_BATCH`` pairs, which bounds the temporaries.  ``box``: the
    periodic box, minimum-image pairs with ``ewald.k_short_periodic``."""
    nt, k = nbr_idx.shape
    blocks = ps.view(-1, block, 4)
    rcut2 = rcut * rcut
    nbr_idx = nbr_idx.long()
    live_slot = (blocks[:, :, 3].sum(dim=1)[nbr_idx] != 0) & (nbr_mask != 0)
    # Live slots first in each row (stable), and only as many columns as
    # the fullest row has.
    order = torch.argsort((~live_slot).to(torch.int8), dim=1, stable=True)
    k_eff = max(int(live_slot.sum(dim=1).max()), 1)
    slots = torch.gather(nbr_idx, 1, order[:, :k_eff])
    scale = torch.gather(nbr_mask * live_slot, 1, order[:, :k_eff])
    out = ps.new_zeros((nt * block, 4))
    batch = max(1, _PAIR_BATCH // (block * k_eff * block))
    for t0 in range(0, nt, batch):
        tiles = slice(t0, min(t0 + batch, nt))
        tgt = blocks[tiles]  # (T, B, 4)
        src = blocks[slots[tiles]].reshape(tgt.shape[0], k_eff * block, 4)
        m_src = src[:, :, 3] * scale[tiles].repeat_interleave(block, dim=1)
        d = src[:, None, :, :3] - tgt[:, :, None, :3]  # (T, B, kB, 3)
        if box is not None:
            d = min_image(d, box)
        r2 = torch.sum(d * d, dim=-1)
        live = (r2 > 0) & (r2 < rcut2) & (m_src != 0)[:, None, :]
        w = torch.zeros_like(r2)
        kern = k_short if box is None else k_short_periodic
        w[live] = kern(r2[live], eps2, sigma) * m_src[:, None, :].expand_as(r2)[live]
        out[tiles.start * block : tiles.stop * block, :3] = torch.sum(w[..., None] * d, dim=2).reshape(-1, 3)
    return out


def _check_tiles(name: str, block: int, nbr_idx: torch.Tensor, ps: torch.Tensor, *rows: torch.Tensor,
                 nt: int | None = None):
    """The rows' device, once ``nbr_idx``'s tiles of ``block`` rows make
    ``ps`` (and each of ``rows``, as :func:`check_rows` holds them), or with
    ``nt`` once ``nbr_idx`` has ``nt`` rows and ``ps`` holds at least ``nt``
    whole tiles (the first ``nt`` the targets)."""
    dev = check_rows(name, ps, *rows)
    if not 1 <= block <= 1024:
        raise ValueError(f"{name}: tile {block} out of [1, 1024]")
    if nt is None and nbr_idx.shape[0] * block != ps.shape[0]:
        raise ValueError(f"{name}: {nbr_idx.shape[0]} tiles of {block} rows do not make N={ps.shape[0]}")
    if nt is not None and (nbr_idx.shape[0] != nt or ps.shape[0] % block or nt * block > ps.shape[0]):
        raise ValueError(f"{name}: {nt} target tiles of {block} rows with {nbr_idx.shape[0]} neighbour rows "
                         f"over N={ps.shape[0]}")
    return dev


def _kernel_operands(name, dev, nbr_idx, nbr_mask, sigma, rcut):
    """``(nbr_idx int32, nbr_mask f32, scal)`` as both short-range kernels
    take them.  ``sigma`` and ``rcut`` are device scalars and reach the
    kernels as a device ``f32[5] = [rcut², 1/(√2σ), (2/√π)/(√2σ),
    1/(2σ²), 1/σ]`` (the forward reads the first three, the isolated
    backward all but the fourth, the periodic backward all), so no host
    sync happens."""
    ids = nbr_idx.to(torch.int32).contiguous()
    msk = nbr_mask.to(torch.float32).contiguous()
    if ids.device != dev or msk.device != dev or msk.shape != ids.shape:
        raise ValueError(f"{name}: nbr_idx and nbr_mask must be (nb, k) on the device of ps")
    a = 1.0 / (_SQRT2 * sigma)
    scal = torch.stack([rcut * rcut, a, _TWO_OVER_SQRT_PI * a, 0.5 / (sigma * sigma), 1.0 / sigma])
    return ids, msk, scal.to(torch.float32)


def _dense_slots(ps: torch.Tensor, nbr_idx: torch.Tensor, block: int, rcut: torch.Tensor) -> torch.Tensor:
    """``(nb, k)`` uint8 for the isolated ``short_range`` and
    ``short_range_bwd`` kernels: 1 where the farthest corners of a slot's
    two tile boxes (every row of each tile) lie within rcut, so every pair
    of the slot but a coincident one is within rcut and the kernels sweep it
    without their warp votes.  The flag only picks one of two loops that
    give the same bits: a wrong one costs time, not results.  ``|fl(x_s -
    x_t)| <= max(fl(hi_s - lo_t), fl(hi_t - lo_s))`` as rounding is
    monotone; the 0.9999 covers the rounding of the sums of squares.  The
    targets are the first ``nt`` tiles of ``ps`` (one a row of ``nbr_idx``)."""
    xyz = ps[:, :3].reshape(-1, block, 3)
    lo, hi = torch.amin(xyz, dim=1), torch.amax(xyz, dim=1)
    ids = nbr_idx.long()
    nt = ids.shape[0]
    far = torch.maximum(hi[ids] - lo[:nt, None], hi[:nt, None] - lo[ids])
    return ((far * far).sum(-1) < 0.9999 * (rcut * rcut)).to(torch.uint8)


def _slot_flags(name, ps, ids, block, rcut, box, dense):
    """The isolated kernels' ``dense`` operand: ``None`` on the periodic box
    (the kernel reads none), the caller's flags if given, else
    :func:`_dense_slots`."""
    if box is not None:
        return None
    if dense is None:
        return _dense_slots(ps, ids, block, rcut)
    if dense.dtype != torch.uint8 or dense.shape != ids.shape or dense.device != ids.device:
        raise ValueError(f"{name}: dense must be (nb, k) uint8 on the device of ps")
    return dense.contiguous()


def short_range_tiles(
    ps: torch.Tensor,
    nbr_idx: torch.Tensor,
    eps2: float,
    sigma: torch.Tensor,
    rcut: torch.Tensor,
    block: int,
    nbr_mask: torch.Tensor | None = None,
    backend: str = "auto",
    box: float | None = None,
    dense: torch.Tensor | None = None,
    nt: int | None = None,
) -> torch.Tensor:
    """Masked block-sparse short-range accelerations per unit G of the
    sorted ``ps (N, 4)``: ``(N, 4)``, w lane 0.  ``nbr_idx (nb, k)`` are
    tile ids of ``ps``, ``nbr_mask (nb, k)`` the mutual mask.  ``nt``: only
    the first ``nt`` tiles of ``ps`` are targets (``nbr_idx`` and the mask
    have ``nt`` rows, the result ``nt·block``), the rest sources alone (the
    sharded step's halo).  ``box``: the periodic box size ``L`` (positions
    in ``[0, L)``): minimum-image pairs with the periodic split's scalar.
    ``backend="jnp"`` runs the twin on any device; otherwise the
    ``short_range`` kernel runs on a CUDA tensor, the twin on a CPU one.
    ``dense``: the isolated kernel's slot flags (:func:`_dense_slots`) where
    the caller has them, else made here."""
    nb, k = nbr_idx.shape
    if nbr_mask is None:
        nbr_mask = torch.ones((nb, k), dtype=torch.float32, device=ps.device)
    if box is not None and not box > 0:
        raise ValueError(f"short_range: box must be > 0, got {box}")
    dev = _check_tiles("short_range", block, nbr_idx, ps, nt=nt)
    if backend == "jnp" or dev.type == "cpu":
        return _short_range_tiles(ps, nbr_idx, eps2, sigma, rcut, block, nbr_mask, box)
    ids, msk, scal = _kernel_operands("short_range", dev, nbr_idx, nbr_mask, sigma, rcut)
    dense = _slot_flags("short_range", ps, ids, block, rcut, box, dense)
    out = ps.new_empty((nb * block, 4))
    launch("short_range", dev, lib().nb_short_range, ps, ids, msk, dense, scal, out, nb, k, block, float(eps2),
           float(box or 0.0))
    return out


def _k_short_grads(r2: torch.Tensor, eps2: float, sigma: torch.Tensor):
    """``(k, dk/dr², dk/dσ)`` of :func:`k_short` with the exact ``erfc``, at
    ``r2 > 0`` (a pair at r = 0 gets finite values that the caller gates
    out)."""
    r2s = torch.where(r2 > 0, r2, 1.0)
    inv_r = torch.rsqrt(r2s)
    inv_s = torch.rsqrt(r2s + eps2)
    a = 1.0 / (_SQRT2 * sigma)
    c2 = _TWO_OVER_SQRT_PI * a
    u = r2s * inv_r * a
    e = torch.exp(-u * u)
    erfc_u = torch.special.erfc(u)
    inv_s3 = inv_s * inv_s * inv_s
    sr = inv_s * inv_r
    k = erfc_u * inv_s3 + c2 * e * sr
    kp = -1.5 * erfc_u * inv_s3 * inv_s * inv_s - c2 * e * (inv_r * inv_s3 + sr * (a * a + 0.5 * inv_r * inv_r))
    ks = e * (_SQRT2 * c2 * u * inv_s3 + c2 / sigma * (2.0 * u * u - 1.0) * sr)
    return k, kp, ks


def _k_short_periodic_grads(r2: torch.Tensor, eps2: float, sigma: torch.Tensor):
    """``(k, dk/dr², dk/dσ)`` of ``ewald.k_short_periodic`` at ``r2 > 0`` (a
    pair at r = 0 gets finite values that the caller gates out), as the
    periodic ``short_range_bwd`` computes them (``csrc/short_range_bwd.cu``
    derives them).  With ``a = 1/(√2σ)``, ``c2 = (2/√π)a``, ``u = ra``
    and ``e = exp(-r²a²)``:

        k   = 1/s³ - k_long                            (the forward's: ``ewald.k_long_terms``)
        k'  = -1.5/s⁵ - (2/√π)a⁵(-2/5 + u²(2/7 + u²(-1/9 + u²/33)))   (u < 0.2)
            = 1.5(1/r⁵ - 1/s⁵) - 1.5 erfc(u)/r⁵ - 1.5 c2 e/r⁴ - c2 a² e/r²   (u >= 0.2)
        k_σ = 2 c2 a² e / σ

    with ``1/r⁵ - 1/s⁵ = eps2/(r s (r + s)) · Σ_{p+q=4} r⁻ᵖ s⁻ᑫ``, a sum of
    positive terms.  The JAX Pallas kernel's k' (``p3m.py:938-953`` of the
    JAX package) cancels terms of size c2/r⁴ and takes an A-S erfc whose
    1.5e-7 error is multiplied by 1/r⁵, so it fails at pairs far closer
    than σ.  From r = 1e-5 to rcut these hold k_σ within
    1e-6 of f64 relative, and k' within 1e-6 of the larger of |k'| and half
    its two parts (relative wherever the parts do not cancel; near rcut k'
    nears its zero)."""
    r2s = torch.where(r2 > 0, r2, 1.0)
    inv_r = torch.rsqrt(r2s)
    inv_s = torch.rsqrt(r2s + eps2)
    a = 1.0 / (_SQRT2 * sigma)
    c2 = _TWO_OVER_SQRT_PI * a
    a2 = 0.5 / (sigma * sigma)  # not a * a: e's relative error is u² times u²'s
    r = r2s * inv_r
    u = r * a
    u2 = r2s * a2
    e = torch.exp(-u2)
    inv_r2, inv_s2 = inv_r * inv_r, inv_s * inv_s
    k = inv_s2 * inv_s - k_long_terms(inv_r, torch.special.erf(u), e, c2, a2, u2)
    series = (c2 * (a2 * a2)) * (-0.4 + u2 * (2.0 / 7.0 + u2 * (-1.0 / 9.0 + u2 * (1.0 / 33.0))))
    s = (r2s + eps2) * inv_s
    powers = inv_r2 * inv_r2 + inv_s * (inv_r2 * inv_r + inv_s * (inv_r2 + inv_s * (inv_r + inv_s)))
    d5 = (eps2 * inv_r * inv_s) / (r + s) * powers
    closed = 1.5 * d5 - (1.5 * torch.special.erfc(u) * (inv_r2 * inv_r2 * inv_r)
                         + (c2 * e) * inv_r2 * (1.5 * inv_r2 + a2))
    kp = torch.where(u2 < 0.04, -1.5 * (inv_s2 * inv_s2 * inv_s) - series, closed)
    return k, kp, 2.0 * c2 * a2 * e / sigma


def _short_range_tiles_bwd(ps, g, nbr_idx, eps2, sigma, rcut, block, nbr_mask, box=None):
    """Plain twin of ``short_range_bwd``: the VJP of :func:`_short_range_tiles`
    for the cotangent ``g`` (its first 3 lanes) as a gather over each row's
    own neighbour list, exact for a mutual mask (``p3m.py:899-903`` of the
    JAX package): per pair ``d = x_j - x_i``, ``k``, ``k' = dk/dr²``,
    ``k_σ = dk/dσ``,

        x̄_i = Σ_j 2k'(m_i (d·g_j) - m_j (d·g_i)) d + k (m_i g_j - m_j g_i)
        m̄_i = -Σ_j k (d·g_j),   σ̄ = Σ_ij m_j (d·g_i) k_σ.

    ``(dps (N, 4) = [x̄, m̄], σ̄ ())``, σ̄ summed in float64.  Only mask-0
    slots are left out: unlike the forward, a source tile of zero mass
    counts (its rows' m̄ and the m_i g_j terms are not 0).  Tiles go in
    batches of about ``_PAIR_BATCH`` pairs.  ``box``: the periodic box,
    minimum-image pairs with :func:`_k_short_periodic_grads`."""
    nb, k = nbr_idx.shape
    blocks = ps.view(nb, block, 4)
    gb = g[:, :3].reshape(nb, block, 3)
    rcut2 = rcut * rcut
    live_slot = nbr_mask != 0
    order = torch.argsort((~live_slot).to(torch.int8), dim=1, stable=True)
    k_eff = max(int(live_slot.sum(dim=1).max()), 1)
    slots = torch.gather(nbr_idx.long(), 1, order[:, :k_eff])
    scale = torch.gather(nbr_mask * live_slot, 1, order[:, :k_eff])
    dps = torch.zeros_like(ps)
    dsig = torch.zeros((), dtype=torch.float64, device=ps.device)
    batch = max(1, _PAIR_BATCH // (block * k_eff * block))
    for t0 in range(0, nb, batch):
        tiles = slice(t0, min(t0 + batch, nb))
        tgt, g_t = blocks[tiles], gb[tiles]  # (T, B, 4), (T, B, 3)
        src = blocks[slots[tiles]].reshape(tgt.shape[0], k_eff * block, 4)
        g_s = gb[slots[tiles]].reshape(tgt.shape[0], k_eff * block, 3)
        d = src[:, None, :, :3] - tgt[:, :, None, :3]  # (T, B, kB, 3)
        if box is not None:
            d = min_image(d, box)
        r2 = torch.sum(d * d, dim=-1)
        k0, k1, k2 = (_k_short_grads if box is None else _k_short_periodic_grads)(r2, eps2, sigma)
        gate = (r2 > 0) & (r2 < rcut2)
        scl = scale[tiles].repeat_interleave(block, dim=1)[:, None, :]
        k0, k1, k2 = (torch.where(gate, kk, 0.0) * scl for kk in (k0, k1, k2))
        m_i, m_j = tgt[:, :, 3:4], src[:, None, :, 3]
        dgi = torch.einsum("tbjc,tbc->tbj", d, g_t)
        dgj = torch.einsum("tbjc,tjc->tbj", d, g_s)
        coef = 2.0 * k1 * (m_i * dgj - m_j * dgi)
        xbar = (torch.einsum("tbj,tbjc->tbc", coef, d) + m_i * torch.einsum("tbj,tjc->tbc", k0, g_s)
                - g_t * torch.sum(k0 * m_j, dim=2, keepdim=True))
        rows = slice(tiles.start * block, tiles.stop * block)
        dps[rows, :3] = xbar.reshape(-1, 3)
        dps[rows, 3] = -torch.sum(k0 * dgj, dim=2).reshape(-1)
        dsig += torch.sum(m_j * dgi * k2, dtype=torch.float64)
    return dps, dsig.to(ps.dtype)


def short_range_tiles_bwd(
    ps: torch.Tensor,
    g: torch.Tensor,
    nbr_idx: torch.Tensor,
    eps2: float,
    sigma: torch.Tensor,
    rcut: torch.Tensor,
    block: int,
    nbr_mask: torch.Tensor,
    backend: str = "auto",
    box: float | None = None,
    dense: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The VJP of :func:`short_range_tiles` for its output's cotangent ``g
    (N, 4)`` (w lane not read): ``(dps (N, 4) = [x̄, m̄], σ̄ ())``; rcut's
    cotangent is 0.  ``box``: the periodic box size ``L``, as the forward
    takes it.  ``backend="jnp"`` runs the twin on any device; otherwise the
    ``short_range_bwd`` kernel runs on a CUDA tensor, the twin on a CPU
    one.  The kernel writes σ̄ per row, summed here with ``torch.sum``
    (deterministic).  ``dense``: as :func:`short_range_tiles` takes it."""
    nb, k = nbr_idx.shape
    if box is not None and not box > 0:
        raise ValueError(f"short_range_bwd: box must be > 0, got {box}")
    dev = _check_tiles("short_range_bwd", block, nbr_idx, ps, g)
    if backend == "jnp" or dev.type == "cpu":
        return _short_range_tiles_bwd(ps, g, nbr_idx, eps2, sigma, rcut, block, nbr_mask, box)
    ids, msk, scal = _kernel_operands("short_range_bwd", dev, nbr_idx, nbr_mask, sigma, rcut)
    dense = _slot_flags("short_range_bwd", ps, ids, block, rcut, box, dense)
    dps = torch.empty_like(ps)
    dsig = torch.empty(ps.shape[0], dtype=torch.float32, device=dev)
    launch("short_range_bwd", dev, lib().nb_short_range_bwd, ps, g, ids, msk, dense, scal, dps, dsig, nb, k, block,
           float(eps2), float(box or 0.0))
    return dps, torch.sum(dsig)


class _ShortRange(torch.autograd.Function):
    """:func:`short_range_tiles` with :func:`short_range_tiles_bwd` as its
    backward: the JAX ``_make_sr_pallas_diff`` in its full-range form
    (every tile a target, the only form one device has).  Cotangents reach
    ``ps`` and ``sigma``; ``rcut`` only gates (its cotangent is 0), the
    lists and the mask have none.  Both passes hand their wrappers detached
    tensors.  ``box`` (the periodic box) reaches both wrappers: the
    JAX function's ``periodic=True`` form.  The isolated kernels' slot
    flags (:func:`_dense_slots`) are made once, in the forward, and kept
    for the backward."""

    @staticmethod
    def forward(ctx, ps, sigma, rcut, nbr_idx, nbr_mask, eps2, block, backend, box=None):
        dense = None
        if box is None and backend != "jnp" and ps.is_cuda:
            dense = _dense_slots(ps.detach(), nbr_idx, block, rcut.detach())
        ctx.save_for_backward(ps, sigma, rcut, nbr_idx, nbr_mask, dense)
        ctx.opts = (eps2, block, backend)
        ctx.box = box
        return short_range_tiles(ps.detach(), nbr_idx, eps2, sigma.detach(), rcut.detach(), block, nbr_mask,
                                 backend=backend, box=box, dense=dense)

    @staticmethod
    def backward(ctx, g):
        ps, sigma, rcut, nbr_idx, nbr_mask, dense = ctx.saved_tensors
        eps2, block, backend = ctx.opts
        with span("nbody3d.vjp"):
            dps, dsig = short_range_tiles_bwd(ps.detach(), g.contiguous(), nbr_idx, eps2, sigma.detach(),
                                              rcut.detach(), block, nbr_mask, backend=backend, box=ctx.box,
                                              dense=dense)
        return dps, dsig, None, None, None, None, None, None, None


# ------------------------------------------------------------------ solver
def accel_p3m(
    pos_mass: torch.Tensor,
    G: float | torch.Tensor,
    *,
    grid: int = 64,
    eps2: float = 1e-4,
    n_real: int | None = None,
    sigma_cells: float = DEFAULT_SIGMA_CELLS,
    rcut_sigmas: float = DEFAULT_RCUT_SIGMAS,
    block: int = 0,
    nbr_k: int = DEFAULT_NBR_K,
    order: int = 3,
    heavy_k: int = DEFAULT_HEAVY_K,
    backend: str = "auto",
    boundary: str = "isolated",
    box_size: float = 0.0,
    interlace: bool = False,
) -> torch.Tensor:
    """P3M accelerations ``(N, 4)`` (w lane 0), isolated boundary: mesh
    long range + short-range correction + exact pairs of the ``heavy_k``
    most massive bodies.  ``boundary="periodic"`` (``box_size > 0``) is
    :func:`_accel_p3m_periodic`, which ignores ``heavy_k``.
    ``backend="jnp"`` runs every plain twin; any other value the kernel
    wrappers (``short_range``, ``mesh_deposit``,
    ``mesh_gather``), which on a CPU tensor take their twins.  Differentiable
    in ``pos_mass`` and ``G``: the short range's backward is
    ``short_range_bwd`` (its twin on ``"jnp"`` or a CPU tensor), the mesh
    legs' are ``mesh_cuda.deposit_vjp``/``gather_vjp`` (``"jnp"``: autograd
    through the twins), on the periodic box in their periodic forms."""
    n = pos_mass.shape[0]
    n_real = n if n_real is None else n_real
    block = p3m_block(n, block)
    nbr_k = min(nbr_k, n // block)
    heavy_k = min(heavy_k, n)
    if boundary == "periodic":
        return _accel_p3m_periodic(
            pos_mass, G, grid=grid, eps2=eps2, n_real=n_real, sigma_cells=sigma_cells, rcut_sigmas=rcut_sigmas,
            block=block, nbr_k=nbr_k, order=order, backend=backend, box_size=box_size, interlace=interlace,
        )
    if boundary != "isolated":
        raise ValueError(f"unknown boundary {boundary!r}")

    pos = pos_mass[:, :3]
    lo, h = _box(pos[:n_real], grid)
    sigma = sigma_cells * h
    rcut = rcut_sigmas * sigma

    hidx, mass_mesh = heavy_split(pos_mass, heavy_k)
    perm = torch.argsort(morton_keys(pos_mass.detach(), n_real), stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    ps = torch.cat([pos, mass_mesh[:, None]], dim=1)[perm]

    # The long range: deposit, FFT solve, gather.
    c, f = _tsc_cells(ps[:, :3], lo, h, grid) if order == 3 else _cic_cells(ps[:, :3], lo, h, grid)
    c4, fm = mesh_cuda.mesh_operands(c, f, ps[:, 3])
    plain = backend == "jnp"
    dep, gat = ((mesh_cuda.deposit_plain, mesh_cuda.gather_plain) if plain
                else (mesh_cuda.deposit_diff, mesh_cuda.gather_diff))
    acc = gat(solve_accel_long(dep(c4, fm, grid, order), h, eps2, sigma, order=order), c4, fm, grid, order)
    # Project out the mesh's net force (f32 FFT noise): heavy and padding
    # rows carry zero mesh mass, so they do not enter the mean.
    mass_s = ps[:, 3]
    msum = torch.clamp(torch.sum(mass_s), min=1e-30)
    acc = acc - torch.sum(mass_s[:, None] * acc, dim=0)[None, :] / msum

    # The selection is integer and gate arithmetic: no gradient.
    lo_b, hi_b = _sorted_aabbs(ps.detach(), n_real, block)
    kth, neg, nbr_idx = _select_neighbors(lo_b, hi_b, h.detach(), nbr_k)
    nbr_mask = mutual_neighbor_mask(neg, nbr_idx, kth)
    acc = acc + _ShortRange.apply(ps, sigma, rcut, nbr_idx, nbr_mask, eps2, block, backend)
    acc = acc[inv]

    a_from, a_on = heavy_direct(pos_mass, hidx, eps2)
    acc[:, :3] += a_from
    acc[hidx, :3] = a_on
    return acc * G


def periodic_scales(grid: int, box_size: float, sigma_cells: float, rcut_sigmas: float):
    """``(L, h, sigma, rcut)`` of the periodic box as f32 0-d tensors on the
    host (the JAX package's f32 rounding), after the checks: ``box_size >
    0`` and ``rcut < L/2`` (the minimum image holds one image a pair)."""
    if box_size <= 0:
        raise ValueError("boundary='periodic' requires box_size > 0")
    rcut_static = rcut_sigmas * sigma_cells * box_size / grid
    if rcut_static >= 0.5 * box_size:
        raise ValueError(
            f"P3M periodic: rcut {rcut_static:.3g} >= L/2 {0.5 * box_size:.3g}: the minimum image needs "
            "rcut < L/2; raise grid or lower sigma_cells/rcut_sigmas"
        )
    L = torch.tensor(box_size, dtype=torch.float32)
    h = L / grid
    sigma = sigma_cells * h
    return L, h, sigma, rcut_sigmas * sigma


def periodic_mesh_leg(pos: torch.Tensor, mass: torch.Tensor, L: torch.Tensor, sigma: torch.Tensor, grid: int,
                      order: int, plain: bool, sorted_rows: bool = True) -> torch.Tensor:
    """One mesh leg on the torus: ``(N, 4)`` long-range accelerations per
    unit G of wrapped positions ``pos`` (TSC at order 3, CIC at 2): the
    periodic deposit, ``ewald.spectral_accel_grids`` and the periodic
    gather, through ``mesh_cuda``'s autograd Functions (their backwards
    wrap the stencil as the forwards do; the grids' cotangent is the
    periodic ``mesh_deposit`` of the gather's).  ``plain``: the twins, with
    autograd through them, as the isolated ``backend="jnp"``.
    ``sorted_rows``: the rows are in Morton order (P3M's; PM's are not),
    which picks the gather kernel's path."""
    h = L / grid
    lo = torch.zeros(3, dtype=pos.dtype, device=pos.device)
    cells = _tsc_cells if order == 3 else _cic_cells
    c4, fm = mesh_cuda.mesh_operands(*cells(pos, lo, h, grid, periodic=True), mass)
    dep, gat = ((mesh_cuda.deposit_plain, mesh_cuda.gather_plain) if plain
                else (mesh_cuda.deposit_diff, functools.partial(mesh_cuda.gather_diff, sorted_rows=sorted_rows)))
    grids = spectral_accel_grids(dep(c4, fm, grid, order, periodic=True), L, sigma, order=order)
    return gat(grids, c4, fm, grid, order, periodic=True)


def _accel_p3m_periodic(pos_mass, G, *, grid, eps2, n_real, sigma_cells, rcut_sigmas, block, nbr_k, order,
                        backend, box_size, interlace):
    """Periodic P3M (``nbody3d_tpu/ops/p3m.py::_accel_p3m_periodic``): wrap
    into ``[0, L)``, Morton-sort, one mesh leg (or, ``interlace``, the mean
    of two legs on grids offset by half a cell: the grid-locked alias
    errors flip sign and cancel), project out the net mesh force, then the
    periodic short range over tiles chosen by the periodic AABB gap."""
    n = pos_mass.shape[0]
    dev = pos_mass.device
    L, h, sigma, rcut = (t.to(dev) for t in periodic_scales(grid, box_size, sigma_cells, rcut_sigmas))
    plain = backend == "jnp"

    pm_w = torch.cat([wrap_box(pos_mass[:, :3], L), pos_mass[:, 3:4]], dim=1)
    perm = torch.argsort(morton_keys(pm_w.detach(), n_real), stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    ps = pm_w[perm]

    acc = periodic_mesh_leg(ps[:, :3], ps[:, 3], L, sigma, grid, order, plain)
    if interlace:
        shifted = wrap_box(ps[:, :3] + 0.5 * h, L)
        acc = 0.5 * (acc + periodic_mesh_leg(shifted, ps[:, 3], L, sigma, grid, order, plain))
    mass_s = ps[:, 3]
    msum = torch.clamp(torch.sum(mass_s), min=1e-30)
    acc = acc - torch.sum(mass_s[:, None] * acc, dim=0)[None, :] / msum

    lo_b, hi_b = _sorted_aabbs(ps.detach(), n_real, block)
    kth, neg, nbr_idx = _select_neighbors(lo_b, hi_b, h, nbr_k, L=L)
    nbr_mask = mutual_neighbor_mask(neg, nbr_idx, kth)
    acc = acc + _ShortRange.apply(ps, sigma, rcut, nbr_idx, nbr_mask, eps2, block, backend, box_size)
    return acc[inv] * G


def p3m_neighbor_overflow(
    pos_mass: torch.Tensor,
    *,
    grid: int = 64,
    n_real: int | None = None,
    sigma_cells: float = DEFAULT_SIGMA_CELLS,
    rcut_sigmas: float = DEFAULT_RCUT_SIGMAS,
    block: int = 0,
    nbr_k: int = DEFAULT_NBR_K,
    box_size: float = 0.0,
) -> int:
    """Tiles that dropped a source tile within ``rcut`` in the selection (0
    means the short range is the split identity up to the erfc cut).  Flat:
    rows with more within-rcut tiles than ``nbr_k``; two-level: rows whose
    kept within-rcut count is below the true one.  ``box_size > 0``: the
    periodic box's tiles and gaps (the JAX function has no periodic
    form)."""
    n = pos_mass.shape[0]
    n_real = n if n_real is None else n_real
    block = p3m_block(n, block)
    nbr_k = min(nbr_k, n // block)
    h, lo_b, hi_b, within, L = _tiles_within_rcut(pos_mass, grid, n_real, sigma_cells, rcut_sigmas, block,
                                                 box_size)
    if lo_b.shape[0] <= _FLAT_MAX_TILES:
        return int(torch.sum(within > nbr_k))
    rcut = rcut_sigmas * sigma_cells * h
    _, neg, _ = _select_neighbors(lo_b, hi_b, h, nbr_k, L=L)
    kept = torch.sum(-neg < rcut * rcut, dim=1)
    return int(torch.sum(kept < within))


def _tiles_within_rcut(pos_mass, grid, n_real, sigma_cells, rcut_sigmas, block, box_size):
    """``(h, lo_b, hi_b, within (nb,), L)``: each tile's count
    of tiles (itself included) whose AABB gap is below ``rcut``, on the
    isolated box or (``box_size > 0``) the periodic one."""
    if box_size > 0:
        L, h, _, _ = (t.to(pos_mass.device) for t in periodic_scales(grid, box_size, sigma_cells, rcut_sigmas))
        pos_mass = torch.cat([wrap_box(pos_mass[:, :3], L), pos_mass[:, 3:]], dim=1)
    else:
        L = None
        _, h = _box(pos_mass[:n_real, :3], grid)
    rcut = rcut_sigmas * sigma_cells * h
    ps = pos_mass[torch.argsort(morton_keys(pos_mass, n_real), stable=True)]
    lo_b, hi_b = _sorted_aabbs(ps, n_real, block)
    nb = lo_b.shape[0]
    within = torch.cat([
        torch.sum(_aabb_dist2(lo_b[r0 : r0 + _NBR_ROW_CHUNK], hi_b[r0 : r0 + _NBR_ROW_CHUNK], lo_b, hi_b, L)
                  < rcut * rcut, dim=1)
        for r0 in range(0, nb, _NBR_ROW_CHUNK)
    ])
    return h, lo_b, hi_b, within, L


def tiles_within_rcut(pos_mass: torch.Tensor, *, grid: int = 64, n_real: int | None = None,
                      sigma_cells: float = DEFAULT_SIGMA_CELLS, rcut_sigmas: float = DEFAULT_RCUT_SIGMAS,
                      block: int = 0, box_size: float = 0.0) -> torch.Tensor:
    """``(nb,)``: each tile's count of tiles within ``rcut`` (the ``nbr_k``
    a tile needs for the selection to drop none of them)."""
    n = pos_mass.shape[0]
    n_real = n if n_real is None else n_real
    return _tiles_within_rcut(pos_mass, grid, n_real, sigma_cells, rcut_sigmas, p3m_block(n, block), box_size)[3]
