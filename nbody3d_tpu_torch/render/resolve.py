"""The renderer's depth resolve: the ``splat_resolve`` kernel and its twin.

The port's counterpart of ``nbody3d_tpu/render/pallas_resolve.py``
(``resolve_all_pallas`` and its ``_resolve_kernel``), and of the host
resolves it is held against (``native/_raster.c`` and
``rasterize._resolve_numpy``).  Each visible splat ``i`` carries the key
``(depth_bits_i << 32) | rgb24_i``; the key is min-reduced into every
pixel ``(cx_i + dx, cy_i + dy)`` with ``dx^2 + dy^2 <= r_i^2``, the
predicate taken in float64 with ``r`` widened.  Non-negative IEEE floats
order like their bit patterns, so the minimum is the depth test, and ties
go to the smaller colour: the result does not depend on the splats' order.

The framebuffer is an ``(H * W,)`` int64 tensor holding the uint64 words
bit for bit; :data:`MISS` (all ones, -1 as int64) marks a pixel no splat
reached.  Every real key is below 2^62 (depth bits <= 0x3F800000).

- :func:`splat_resolve` checks its tensors and, on a CUDA device, launches
  the kernel (``csrc/splat_resolve.cu``); on CPU tensors it runs
  :func:`splat_resolve_plain`.  A CUDA tensor never goes to the twin.
- :func:`splat_resolve_plain` is the same function on tensors: int64 keys,
  splats sorted by radius, the large ones (``r > 6`` px) stamped one by one
  as a 2-D slice minimum, the rest by an offset loop of
  ``scatter_reduce_(..., "amin")`` that visits, for each offset, only the
  splats large enough to cover it.
- :func:`buffer_image` and :func:`buffer_planes` turn the words into the
  ``(H, W, 3)`` uint8 image and the rgb24 / depth planes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nbody3d_tpu_torch.ops.launch import launch, lib

MISS = -1  # the all-ones word: no splat reached the pixel
# The twin reduces ``key ^ _FLIP``: flipping the top bit makes int64 order
# the words' uint64 order, and MISS flips to the largest int64.
_FLIP = torch.iinfo(torch.int64).min
SMALL_MAX = 6  # radius (px) above which the twin stamps a splat on its own


def _check_splats(cx, cy, depth_bits, rgb24, r, visible, width, height) -> torch.device:
    """Six 1-D contiguous tensors of one length on one device: cx, cy,
    depth_bits, rgb24 int32, r float32, visible bool."""
    want = ((cx, torch.int32, "cx"), (cy, torch.int32, "cy"), (depth_bits, torch.int32, "depth_bits"),
            (rgb24, torch.int32, "rgb24"), (r, torch.float32, "r"), (visible, torch.bool, "visible"))
    dev, n = cx.device, cx.shape[0]
    for t, dtype, name in want:
        if t.dtype != dtype:
            raise TypeError(f"splat_resolve: {name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"splat_resolve: {name} must be 1-D of length {n}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"splat_resolve: {name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"splat_resolve: tensors on {t.device} and {dev}")
        if t.requires_grad:
            raise RuntimeError(f"splat_resolve: {name} requires grad; the resolve has no gradient")
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"splat_resolve: no kernel for device {dev}")
    if width <= 0 or height <= 0 or width * height >= 2**31:
        raise ValueError(f"splat_resolve: frame {width}x{height} out of range")
    return dev


def make_keys(depth_bits: torch.Tensor, rgb24: torch.Tensor) -> torch.Tensor:
    """The uint64 words ``(depth_bits << 32) | rgb24`` of uint32 bit
    patterns given as int32 or int64, as int64 (bit for bit)."""
    return (depth_bits.to(torch.int64) << 32) | (rgb24.to(torch.int64) & 0xFFFFFFFF)


def resolve_keys_plain(
    cx: torch.Tensor, cy: torch.Tensor, key: torch.Tensor, r: torch.Tensor, *, width: int, height: int
) -> torch.Tensor:
    """The twin's core on the splats to draw: integer centres, int64 keys
    and float radii (float32 or float64; the predicate widens to float64).
    Returns the ``(H * W,)`` int64 framebuffer."""
    buf = torch.full((height * width,), MISS ^ _FLIP, dtype=torch.int64, device=key.device)
    if key.numel():
        rd = r.to(torch.float64)
        order = torch.argsort(-rd, stable=True)  # radius descending
        cx, cy, key = (t[order].to(torch.int64) for t in (cx, cy, key ^ _FLIP))
        rs = rd[order].cpu().numpy()
        n_large = int(np.searchsorted(-rs, -float(SMALL_MAX), side="left"))
        _stamp_large(buf.view(height, width), cx[:n_large], cy[:n_large], key[:n_large], rs[:n_large])
        _offset_loop(buf, cx[n_large:], cy[n_large:], key[n_large:], rs[n_large:], width, height)
    return buf ^ _FLIP


# As native/_raster.c: a splat covers rows |dy| <= floor(r) and, in each,
# the pixels with dx^2 + dy^2 <= r*r (float64).  The two differ only where
# r*r rounds up to a square above floor(r)^2: then the row dy = 0 reaches
# one pixel further than the rows do.


def _stamp_large(buf2d, cx, cy, key, rs) -> None:
    """One 2-D slice minimum per splat, under its disc's mask."""
    h, w = buf2d.shape
    for x, y, k, rf in zip(cx.tolist(), cy.tolist(), key.tolist(), rs.tolist()):
        ri, rr = int(math.floor(rf)), rf * rf
        y0, y1, x0, x1 = max(0, y - ri), min(h, y + ri + 1), max(0, x - ri - 1), min(w, x + ri + 2)
        if y0 >= y1 or x0 >= x1:
            continue
        dy = torch.arange(y0 - y, y1 - y, dtype=torch.float64, device=buf2d.device)
        dx = torch.arange(x0 - x, x1 - x, dtype=torch.float64, device=buf2d.device)
        inside = dy[:, None] ** 2 + dx[None, :] ** 2 <= rr
        sub = buf2d[y0:y1, x0:x1]
        buf2d[y0:y1, x0:x1] = torch.where(inside, torch.minimum(sub, torch.tensor(k, device=sub.device)), sub)


def offset_pairs(cx, cy, key, rs, width, height):
    """For each offset (dx, dy), the flat pixels and keys of the splats that
    cover it, a prefix of the splats sorted by radius descending (``rs``:
    their radii, a float64 numpy array)."""
    if not len(rs):
        return
    rmax = int(math.floor(rs[0])) + 1
    neg_r, neg_r2 = -rs, -(rs * rs)
    for dy in range(-rmax, rmax + 1):
        rows = int(np.searchsorted(neg_r, -float(abs(dy)), side="right"))  # floor(r) >= |dy|
        for dx in range(-rmax, rmax + 1):
            k = min(rows, int(np.searchsorted(neg_r2, -float(dx * dx + dy * dy), side="right")))
            if k == 0:
                continue
            x, y = cx[:k] + dx, cy[:k] + dy
            ok = (x >= 0) & (x < width) & (y >= 0) & (y < height)
            yield (y * width + x)[ok], key[:k][ok]


def _offset_loop(buf, cx, cy, key, rs, width, height) -> None:
    """The covering splats of each offset scatter-min their keys."""
    for pix, k in offset_pairs(cx, cy, key, rs, width, height):
        buf.scatter_reduce_(0, pix, k, "amin")


def splat_resolve_plain(
    cx: torch.Tensor, cy: torch.Tensor, depth_bits: torch.Tensor, rgb24: torch.Tensor,
    r: torch.Tensor, visible: torch.Tensor, *, width: int, height: int,
) -> torch.Tensor:
    """Plain twin of ``splat_resolve``: the same framebuffer on any device."""
    keep = visible.to(torch.bool)
    return resolve_keys_plain(
        cx[keep], cy[keep], make_keys(depth_bits[keep], rgb24[keep]), r[keep], width=width, height=height
    )


def splat_resolve(
    cx: torch.Tensor, cy: torch.Tensor, depth_bits: torch.Tensor, rgb24: torch.Tensor,
    r: torch.Tensor, visible: torch.Tensor, *, width: int, height: int,
) -> torch.Tensor:
    """Depth-min resolve of the splats into an ``(H * W,)`` int64 framebuffer
    (uint64 words; :data:`MISS` where nothing landed).  Inputs in any order:
    ``cx``/``cy`` int32 centre pixels, ``depth_bits`` int32 (the bit pattern
    of the clipped [0, 1] float32 depth), ``rgb24`` int32, ``r`` float32
    radius in pixels, ``visible`` bool."""
    dev = _check_splats(cx, cy, depth_bits, rgb24, r, visible, width, height)
    if dev.type == "cpu":
        return splat_resolve_plain(cx, cy, depth_bits, rgb24, r, visible, width=width, height=height)
    buf = torch.full((height * width,), MISS, dtype=torch.int64, device=dev)
    if cx.shape[0]:
        launch("splat_resolve", dev, lib().nb_splat_resolve,
               cx, cy, depth_bits, rgb24, r, visible, buf, cx.shape[0], width, height)
    return buf


# ------------------------------------------------------------- the frame
def buffer_planes(buf: torch.Tensor, *, width: int, height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rgb24 (H, W) int64, 0xFFFFFFFF where missed; depth (H, W)
    float32, +inf where missed)`` — the planes ``resolve_all_pallas``
    returns."""
    hit = buf != MISS
    rgb = torch.where(hit, buf & 0xFFFFFF, 0xFFFFFFFF)
    depth = (buf >> 32).to(torch.int32).view(torch.float32)
    depth = torch.where(hit, depth, torch.tensor(float("inf"), device=buf.device))
    return rgb.view(height, width), depth.view(height, width)


def buffer_image(
    buf: torch.Tensor, *, width: int, height: int, background: tuple[int, int, int] = (0, 0, 0)
) -> torch.Tensor:
    """The ``(H, W, 3)`` uint8 image of a framebuffer, on its device."""
    hit = (buf != MISS)[:, None]
    shifts = torch.tensor([16, 8, 0], dtype=torch.int64, device=buf.device)
    rgb = ((buf[:, None] >> shifts) & 0xFF).to(torch.uint8)
    bg = torch.tensor(background, dtype=torch.uint8, device=buf.device)
    return torch.where(hit, rgb, bg).view(height, width, 3)
