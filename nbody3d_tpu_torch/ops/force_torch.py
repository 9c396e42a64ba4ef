"""Plain PyTorch direct-sum softened gravity: the port's in-package oracle.

The pair function of the reference shader::

    r        = x_j - x_i
    distSqr  = |r|^2 + eps2
    a_i     += G * m_j * rsqrt(distSqr^3) * r

with the self pair excluded by index, and every acceleration taken from
the pre-step positions.  Padding bodies carry mass 0 and so exert no
force.  Runs on any device; ``chunk`` bounds the temporaries to
``O(chunk * N)``.
"""

from __future__ import annotations

import torch


def _chunk_accel(
    tgt_pos: torch.Tensor,  # (B, 3)
    tgt_idx: torch.Tensor,  # (B,) global target indices
    src_pos: torch.Tensor,  # (N, 3)
    src_gm: torch.Tensor,  # (N,) G*m
    eps2: float,
) -> torch.Tensor:
    diff = src_pos[None, :, :] - tgt_pos[:, None, :]  # (B, N, 3)
    d2 = torch.sum(diff * diff, dim=-1) + eps2
    w = src_gm[None, :] * torch.rsqrt(d2 * d2 * d2)
    src_idx = torch.arange(src_pos.shape[0], device=w.device)
    w = torch.where(src_idx[None, :] == tgt_idx[:, None], 0.0, w)
    return torch.einsum("bn,bnc->bc", w, diff)


def accel_direct(
    pos_mass: torch.Tensor,
    G: float | torch.Tensor,
    *,
    eps2: float = 1e-4,
    chunk: int | None = None,
) -> torch.Tensor:
    """Direct-sum O(N^2) accelerations. Returns (N, 4) with zero w lane.
    ``G`` is a float or a 0-d tensor (then autograd reaches it)."""
    n = pos_mass.shape[0]
    pos = pos_mass[:, :3]
    gm = pos_mass[:, 3] * (G if isinstance(G, torch.Tensor) else float(G))
    idx = torch.arange(n, device=pos_mass.device)
    if chunk is None or chunk >= n:
        acc = _chunk_accel(pos, idx, pos, gm, eps2)
    else:
        if n % chunk != 0:
            raise ValueError(f"chunk {chunk} must divide N {n}")
        acc = torch.cat(
            [
                _chunk_accel(pos[s : s + chunk], idx[s : s + chunk], pos, gm, eps2)
                for s in range(0, n, chunk)
            ]
        )
    return torch.cat([acc, torch.zeros((n, 1), dtype=acc.dtype, device=acc.device)], dim=1)


def accel_partial(
    tgt_pos_mass: torch.Tensor,
    srcT: torch.Tensor,
    diag_offset: int,
    *,
    eps2: float = 1e-4,
    diag_lo: int = 0,
    diag_hi: int | None = None,
) -> torch.Tensor:
    """Accelerations of targets against one source set given as ``(4,
    N_src)`` rows ``[x, y, z, G*m]``.  A pair is a self pair iff
    ``target_row + diag_offset == source_col`` and the target row lies in
    ``[diag_lo, diag_hi)``.  Returns ``(N_tgt, 4)`` with zero w lane."""
    pos = tgt_pos_mass[:, :3]
    src_pos = srcT[:3, :].T
    gm = srcT[3, :]
    diff = src_pos[None, :, :] - pos[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1) + eps2
    w = gm[None, :] * torch.rsqrt(d2 * d2 * d2)
    trows = torch.arange(w.shape[0], device=w.device)[:, None]
    cols = torch.arange(w.shape[1], device=w.device)[None, :]
    is_self = (trows + diag_offset == cols) & (trows >= diag_lo)
    if diag_hi is not None:
        is_self &= trows < diag_hi
    w = torch.where(is_self, 0.0, w)
    acc = torch.einsum("ts,tsc->tc", w, diff)
    return torch.cat([acc, torch.zeros((acc.shape[0], 1), dtype=acc.dtype, device=acc.device)], dim=1)
