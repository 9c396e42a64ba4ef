"""The force VJP: hand-written CUDA kernels, their plain twins, autograd.

The port's counterpart of ``nbody3d_tpu/ops/force_vjp.py``.  The forward
(per unit G) is ``F_k = sum_j w_kj m_j d_kj`` with ``d_kj = x_j - x_k``,
``w = (|d|^2 + eps2)^-3/2`` and the self pair excluded by index; ``a = G F``.
For the cotangent ``A`` of ``a`` (its w lane is ignored: the forward's w
lane is identically 0) the VJP is

    x̄_k = G sum_{j != k} [w g - 3 w5 (d.g) d],   g = m_k A_j - m_j A_k
    m̄_k = -G sum_{j != k} w (d.A_j)
    Ḡ   = sum_k A_k . F_k

with ``w5 = w / (|d|^2 + eps2)``.  The self pair must be masked, not left
to cancel: ``w_kk = eps2^-3/2`` (1e6 at the default) times a ``g`` that
cancels only to f32 rounding leaves garbage on heavy bodies.

Four kernels (``csrc/``; the per-pair terms in ``csrc/pair.cuh``):

==================  ====================================================
``vjp_full``        every target against every source, no atomics on rows
``vjp_sym_diag``    Newton-3 schedule 1: the pairs inside each tile
``vjp_sym_hops``    2: off-diagonal tile pairs, each pair once, both rows
``vjp_combine``     3: sum the two, scale by G, reduce Ḡ in double
==================  ====================================================

Both schedules compute the same pair algebra.  The TPU kernels' bf16 limb
planes and row-sum folds (MXU rounding workarounds) are not copied: an f32
CUDA-core kernel forms ``d`` per pair and adds the pair's x̄ term directly.
The JAX package's ``precise`` flag selects between two MXU roundings; the
CUDA kernels have one f32 path, so the port has no such flag.

Wrappers check their tensors as the forward kernels' do (``ops/launch.py``)
and run the plain twins only for CPU tensors; on a CUDA tensor they launch
the kernels or raise.  :func:`make_diff_accel` makes a forward force
differentiable: its backward runs :func:`force_vjp_sym` (default) or
:func:`force_vjp`.
"""

from __future__ import annotations

import torch

from nbody3d_tpu_torch.ops.launch import (
    check_rows, check_tile, exact_split, hop_blocks, launch, lib, sm_count, split_hops,
)

Tensors2 = tuple[torch.Tensor, torch.Tensor]


# --------------------------------------------------------------- reference
def force_vjp_reference(
    pos_mass: torch.Tensor, G: float, abar: torch.Tensor, eps2: float = 1e-4
) -> Tensors2:
    """Dense closed form of the VJP (O(N^2) memory; an oracle for tests).
    Returns ``(pm_bar (N, 4) = G [x̄, m̄], Ḡ ())``."""
    x = pos_mass[:, :3]
    m = pos_mass[:, 3]
    A = abar[:, :3]
    d = x[None, :, :] - x[:, None, :]  # d[k, j] = x_j - x_k
    r2 = torch.sum(d * d, dim=-1) + eps2
    mask = 1.0 - torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    w = mask * r2**-1.5
    w5 = mask * r2**-2.5
    g = m[:, None, None] * A[None, :, :] - m[None, :, None] * A[:, None, :]
    dg = torch.sum(d * g, dim=-1)
    xbar = torch.sum(w[:, :, None] * g, dim=1) - 3.0 * torch.sum((w5 * dg)[:, :, None] * d, dim=1)
    mbar = -torch.einsum("kj,kjc,jc->k", w, d, A)
    F = torch.einsum("kj,j,kjc->kc", w, m, d)
    gbar = torch.sum(A * F)
    return torch.cat([G * xbar, G * mbar[:, None]], dim=1), gbar


# ------------------------------------------------------------ pair terms
def _pair_terms(xk: torch.Tensor, ak: torch.Tensor, xj: torch.Tensor, aj: torch.Tensor, eps2: float):
    """``vjp_pair`` of ``csrc/pair.cuh`` on broadcast shapes: targets
    ``xk (..., T, 1, 4)``, ``ak (..., T, 1, 3)``; sources ``xj (..., 1, S, 4)``,
    ``aj (..., 1, S, 3)``.  Returns ``(t (..., T, S, 3), mbar_t, mbar_s,
    phi_t, phi_s)``, each scalar term ``(..., T, S)``."""
    d = xj[..., :3] - xk[..., :3]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    d2 = dx * dx + (dy * dy + (dz * dz + eps2))
    r = torch.rsqrt(d2)
    inv = r * r
    w = inv * r
    w5 = w * inv
    p = torch.sum(d * aj, dim=-1)  # d.A_j
    q = torch.sum(d * ak, dim=-1)  # d.A_k
    mk, mj = xk[..., 3], xj[..., 3]
    dg = mk * p - mj * q
    c = 3.0 * w5 * dg
    g = mk[..., None] * aj - mj[..., None] * ak
    t = w[..., None] * g - c[..., None] * d
    return t, -(w * p), w * q, w * mj * q, -(w * mk * p)


def _f64_rows(t: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.sum(t, dim=dim, dtype=torch.float64)


# --------------------------------------------------------------- vjp_full
def vjp_full_plain(
    pos_mass: torch.Tensor, G: float, abar: torch.Tensor, eps2: float, *, chunk: int = 256
) -> Tensors2:
    """Plain twin of ``vjp_full``: ``(pm_bar (N, 4), gbar (1,) float64)``.
    Pair terms are f32 as in the kernel; each row's sums are taken in f64
    and rounded once, so the twin adds no summation-order error."""
    n = pos_mass.shape[0]
    xj, aj = pos_mass[None, :, :], abar[None, :, :3]
    pm_bar = torch.empty_like(pos_mass)
    gbar = torch.zeros(1, dtype=torch.float64, device=pos_mass.device)
    cols = torch.arange(n, device=pos_mass.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        t, mbar_t, _, phi_t, _ = _pair_terms(
            pos_mass[s:e, None, :], abar[s:e, None, :3], xj, aj, eps2
        )
        keep = (cols[None, :] != torch.arange(s, e, device=cols.device)[:, None]).to(t.dtype)
        xbar = _f64_rows(t * keep[..., None], 1).to(torch.float32)
        mbar = _f64_rows(mbar_t * keep, 1).to(torch.float32)
        pm_bar[s:e] = torch.cat([xbar, mbar[:, None]], dim=1) * G
        gbar += _f64_rows(phi_t * keep, 1).sum()
    return pm_bar, gbar


def vjp_full(pos_mass: torch.Tensor, G: float, abar: torch.Tensor, eps2: float) -> Tensors2:
    """The full-grid VJP kernel: ``(pm_bar (N, 4), gbar (1,) float64)``."""
    dev = check_rows("vjp_full", pos_mass, abar)
    if pos_mass.shape != abar.shape:
        raise ValueError("vjp_full: pos_mass and abar must have one shape")
    if eps2 <= 0:
        raise ValueError("eps2 must be > 0")
    if dev.type == "cpu":
        return vjp_full_plain(pos_mass, G, abar, eps2)
    n = pos_mass.shape[0]
    pm_bar = torch.empty_like(pos_mass)
    gbar = torch.zeros(1, dtype=torch.float64, device=dev)
    launch(
        "vjp_full", dev, lib().nb_vjp_full,
        pos_mass, abar, pm_bar, gbar, n, float(G), float(eps2), exact_split(n, n, sm_count(dev.index)),
    )
    return pm_bar, gbar


# ----------------------------------------------------------- vjp_sym_diag
def vjp_sym_diag_plain(pos_mass: torch.Tensor, abar: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """Plain twin of ``vjp_sym_diag``: ``acc_diag (N, 8)`` per unit G, rows
    ``[x̄(3), m̄, φ, 0, 0, 0]`` over each tile's ordered pairs."""
    n = pos_mass.shape[0]
    nt = n // b
    xt = pos_mass.view(nt, b, 4)
    at = abar[:, :3].reshape(nt, b, 3)
    t, mbar_t, _, phi_t, _ = _pair_terms(xt[:, :, None], at[:, :, None], xt[:, None], at[:, None], eps2)
    keep = 1.0 - torch.eye(b, dtype=t.dtype, device=t.device)
    acc = torch.zeros((nt, b, 8), dtype=torch.float64, device=pos_mass.device)
    acc[..., :3] = _f64_rows(t * keep[..., None], 2)
    acc[..., 3] = _f64_rows(mbar_t * keep, 2)
    acc[..., 4] = _f64_rows(phi_t * keep, 2)
    return acc.view(n, 8).to(torch.float32)


def vjp_sym_diag(pos_mass: torch.Tensor, abar: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """Sym VJP 1: the in-tile pairs, ``acc_diag (N, 8)``."""
    dev = check_rows("vjp_sym_diag", pos_mass, abar)
    nt = check_tile("vjp_sym_diag", pos_mass.shape[0], b, min_tiles=1)
    if dev.type == "cpu":
        return vjp_sym_diag_plain(pos_mass, abar, eps2, b)
    acc = torch.empty((pos_mass.shape[0], 8), dtype=torch.float32, device=dev)
    launch("vjp_sym_diag", dev, lib().nb_vjp_sym_diag, pos_mass, abar, acc, nt, b, float(eps2))
    return acc


# ----------------------------------------------------------- vjp_sym_hops
def vjp_sym_hops_plain(pos_mass: torch.Tensor, abar: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """Plain twin of ``vjp_sym_hops``: ``acc_hop (N, 8)`` over the same
    pair sets, the source side's φ kept on the target row as the kernel
    keeps it."""
    n = pos_mass.shape[0]
    nt = n // b
    xt = pos_mass.view(nt, b, 4)
    at = abar[:, :3].reshape(nt, b, 3)
    acc = torch.zeros((nt, b, 8), dtype=torch.float64, device=pos_mass.device)
    for k0, nk, grid_i in split_hops(nt):
        ii = torch.arange(grid_i, device=pos_mass.device)
        for k in range(k0, k0 + nk):
            jj = (ii + k) % nt
            t, mbar_t, mbar_s, phi_t, phi_s = _pair_terms(
                xt[ii][:, :, None], at[ii][:, :, None], xt[jj][:, None], at[jj][:, None], eps2
            )
            fwd = torch.cat(
                [_f64_rows(t, 2), _f64_rows(mbar_t, 2)[..., None], _f64_rows(phi_t + phi_s, 2)[..., None]],
                dim=2,
            )
            rev = torch.cat([-_f64_rows(t, 1), _f64_rows(mbar_s, 1)[..., None]], dim=2)
            acc[:, :, :5].index_add_(0, ii, fwd)
            acc[:, :, :4].index_add_(0, jj, rev)
    return acc.view(n, 8).to(torch.float32)


def vjp_sym_hops(pos_mass: torch.Tensor, abar: torch.Tensor, eps2: float, b: int) -> torch.Tensor:
    """Sym VJP 2: every unordered pair of distinct tiles once, both rows
    served, ``acc_hop (N, 8)`` (zeros when ``nt = 1``)."""
    dev = check_rows("vjp_sym_hops", pos_mass, abar)
    nt = check_tile("vjp_sym_hops", pos_mass.shape[0], b, min_tiles=1)
    if dev.type == "cpu":
        return vjp_sym_hops_plain(pos_mass, abar, eps2, b)
    acc = torch.zeros((pos_mass.shape[0], 8), dtype=torch.float32, device=dev)
    fn = lib().nb_vjp_sym_hops
    for k0, nk, grid_i, runs in hop_blocks(nt):
        launch("vjp_sym_hops", dev, fn, pos_mass, abar, acc, nt, b, k0, nk, grid_i, runs, float(eps2))
    return acc


# ------------------------------------------------------------ vjp_combine
def vjp_combine_plain(acc_diag: torch.Tensor, acc_hop: torch.Tensor, G: float) -> Tensors2:
    """Plain twin of ``vjp_combine``: ``(pm_bar (N, 4), gbar (1,) float64)``."""
    pm_bar = (acc_diag[:, :4] + acc_hop[:, :4]) * G
    gbar = (acc_diag[:, 4].double() + acc_hop[:, 4].double()).sum().reshape(1)
    return pm_bar, gbar


def vjp_combine(acc_diag: torch.Tensor, acc_hop: torch.Tensor, G: float) -> Tensors2:
    """Sym VJP 3: ``pm_bar = G (acc_diag + acc_hop)[:, :4]`` and
    ``gbar = sum of both φ columns`` in double."""
    dev = check_rows("vjp_combine", acc_diag, acc_hop, width=8)
    if acc_diag.shape != acc_hop.shape:
        raise ValueError("vjp_combine: acc_diag and acc_hop must have one shape")
    if dev.type == "cpu":
        return vjp_combine_plain(acc_diag, acc_hop, G)
    n = acc_diag.shape[0]
    pm_bar = torch.empty((n, 4), dtype=torch.float32, device=dev)
    gbar = torch.zeros(1, dtype=torch.float64, device=dev)
    launch("vjp_combine", dev, lib().nb_vjp_combine, acc_diag, acc_hop, pm_bar, gbar, n, float(G))
    return pm_bar, gbar


# ----------------------------------------------------------------- entries
def force_vjp(pos_mass: torch.Tensor, G: float, abar: torch.Tensor, *, eps2: float) -> Tensors2:
    """All-pairs VJP over the full grid (``force_vjp_pallas``'s
    counterpart): ``(pm_bar (N, 4), Ḡ ())``."""
    pm_bar, gbar = vjp_full(pos_mass, G, abar, eps2)
    return pm_bar, gbar.to(torch.float32).reshape(())


def force_vjp_sym(
    pos_mass: torch.Tensor, G: float, abar: torch.Tensor, *, eps2: float, b: int
) -> Tensors2:
    """All-pairs VJP through the Newton-3 schedule with tile ``b``
    (``force_vjp_sym_pallas``'s counterpart): ``(pm_bar (N, 4), Ḡ ())``.
    Any ``nt = N / b >= 1``; ``nt = 1`` is the diagonal tile alone."""
    if pos_mass.shape != abar.shape:
        raise ValueError("force_vjp_sym: pos_mass and abar must have one shape")
    if eps2 <= 0:
        raise ValueError("eps2 must be > 0")
    acc_diag = vjp_sym_diag(pos_mass, abar, eps2, b)
    acc_hop = vjp_sym_hops(pos_mass, abar, eps2, b)
    pm_bar, gbar = vjp_combine(acc_diag, acc_hop, G)
    return pm_bar, gbar.to(torch.float32).reshape(())


def requires_grad(x) -> bool:
    """Whether ``x`` (a tensor or a Python float) takes part in autograd."""
    return isinstance(x, torch.Tensor) and x.requires_grad


class _DiffAccel(torch.autograd.Function):
    """``accel = forward_fn(pos_mass, G)`` with the hand-written VJP as its
    backward.  ``G`` is a Python float (no gradient) or a 0-d tensor, whose
    gradient is the VJP's Ḡ.  The kernels see ``float(G)``."""

    @staticmethod
    def forward(ctx, pos_mass, G, forward_fn, backward_fn):
        ctx.save_for_backward(pos_mass)
        ctx.G = float(G)
        ctx.backward_fn = backward_fn
        return forward_fn(pos_mass.detach(), ctx.G)

    @staticmethod
    def backward(ctx, abar):
        (pos_mass,) = ctx.saved_tensors
        pm_bar, gbar = ctx.backward_fn(pos_mass.detach(), ctx.G, abar.detach().contiguous())
        return (
            pm_bar if ctx.needs_input_grad[0] else None,
            gbar if ctx.needs_input_grad[1] else None,
            None,
            None,
        )


def make_diff_accel(forward_fn, *, eps2: float, b: int, sym: bool = True):
    """Wrap ``forward_fn(pos_mass, G) -> (N, 4)`` so that autograd flows
    through it: the backward is :func:`force_vjp_sym` with tile ``b``
    (``sym=True``, the JAX default) or :func:`force_vjp`.  The backward is
    the VJP of the ideal pair math, as in the JAX package.  ``G`` is a
    float or a 0-d tensor; a tensor that requires grad gets Ḡ.  When grad
    mode is off or neither ``pos_mass`` nor ``G`` needs a gradient, the
    wrapper calls ``forward_fn`` directly, so the forward path pays
    nothing."""

    def backward_fn(pos_mass, G, abar):
        if sym:
            return force_vjp_sym(pos_mass, G, abar, eps2=eps2, b=b)
        return force_vjp(pos_mass, G, abar, eps2=eps2)

    def accel(pos_mass: torch.Tensor, G: float | torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (pos_mass.requires_grad or requires_grad(G)):
            return _DiffAccel.apply(pos_mass, G, forward_fn, backward_fn)
        return forward_fn(pos_mass, float(G))

    return accel
