"""Morton (Z-order) ordering of the body arrays.

Physics is permutation invariant (all-pairs force), so a re-sort between
chunks changes only the order of float sums.  It keeps each GPU tile of
the sym step spatially compact.  Keys are int32 (10 bits a dimension),
computed exactly as in ``nbody3d_tpu/ops/morton.py``; padding rows get the
maximum key ``0x7FFFFFFF`` and stay at the tail of a stable sort.
"""

from __future__ import annotations

import torch

_BITS = 10
_CELLS = 1 << _BITS
PAD_KEY = 0x7FFFFFFF


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    """Interleave two zero bits after each of the low 10 bits of ``v``."""
    v = v & (_CELLS - 1)
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_keys_box(
    xyz: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N, 3) positions -> (N,) int32 keys against an explicit box."""
    span = torch.clamp(hi - lo, min=1e-30)
    # Clamping before the cast equals the JAX package's cast-then-clip for
    # every in-box value and keeps out-of-box rows defined.
    scaled = torch.clamp((xyz - lo) / span * _CELLS, 0, _CELLS - 1)
    cell = scaled.to(torch.int32)
    key = (
        _spread_bits(cell[:, 0])
        | (_spread_bits(cell[:, 1]) << 1)
        | (_spread_bits(cell[:, 2]) << 2)
    )
    if valid is not None:
        key = torch.where(valid, key, torch.full_like(key, PAD_KEY))
    return key


def morton_keys(pos: torch.Tensor, n_real: int | None = None) -> torch.Tensor:
    """(N, >=3) positions -> (N,) int32 keys over the bounding box of the
    first ``n_real`` rows; the rest get the maximum key."""
    n = pos.shape[0]
    xyz = pos[:, :3]
    valid = None
    if n_real is not None and n_real < n:
        valid = torch.arange(n, device=pos.device) < n_real
        lo = torch.amin(xyz[:n_real], dim=0)
        hi = torch.amax(xyz[:n_real], dim=0)
    else:
        lo = torch.amin(xyz, dim=0)
        hi = torch.amax(xyz, dim=0)
    return morton_keys_box(xyz, lo, hi, valid)


def morton_order(pos: torch.Tensor, n_real: int | None = None) -> torch.Tensor:
    """Stable permutation that sorts the rows along the Z-order curve."""
    return torch.argsort(morton_keys(pos, n_real), stable=True)


def morton_reorder(
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    accel: torch.Tensor,
    *,
    n_real: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The state arrays reordered along the Z-order curve of the current
    positions; padding rows stay at the tail."""
    order = morton_order(pos_mass, n_real)
    return pos_mass[order], vel[order], accel[order]
