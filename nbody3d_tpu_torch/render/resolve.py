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

The quantized resolve (the JAX package's ``resolve="device"``,
``nbody3d_tpu/render/rasterize.py:328-463``, an XLA scatter-min there) is
a second framebuffer: 32-bit words ``depth16 << 16 | rgb565``, where
``depth16`` is the top half of the depth bits.  :func:`quantized_scatter`
min-reduces the small splats (``r < 2`` px) on their device, one
``scatter_reduce_(..., "amin")`` for each of :data:`DEVICE_OFFSETS` that
the radius reaches; :func:`quantized_large` fetches the large ones to the
host, and :func:`quantized_frame` stamps them there with the same words
in C (``native/_raster.c``; :func:`_stamp_large` is its twin).  Only the
``(H * W,)`` int32 buffer and the large splats leave the device.
:func:`quantized_image` decodes the colour by bit replication.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from nbody3d_tpu_torch import native
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
    depth = torch.where(hit, depth, float("inf"))
    return rgb.view(height, width), depth.view(height, width)


def buffer_image(
    buf: torch.Tensor, *, width: int, height: int, background: tuple[int, int, int] = (0, 0, 0)
) -> torch.Tensor:
    """The ``(H, W, 3)`` uint8 image of a framebuffer, on its device."""
    r, g, b = (int(c) for c in background)
    # The background's rgb24 word where missed, then each word's low three
    # bytes (little-endian: b, g, r) reversed.  Three launches, and no small
    # tensor copied to the device, which would make the host wait for the
    # device's stream.
    words = torch.where(buf != MISS, buf, (r << 16) | (g << 8) | b)
    return words.view(torch.uint8).view(-1, 8)[:, :3].flip(1).view(height, width, 3)


# ------------------------------------------------------ the quantized resolve
# The stamp offsets of a splat with r < 2 px (|offset| <= r; the farthest is
# |(1, 1)| = 1.415) and the radius from which the host stamps a splat.
DEVICE_OFFSETS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1))
DEVICE_RMAX = 2.0
EMPTY32 = 0xFFFFFFFF  # no splat reached the pixel; real words are below 0x3F810000
# The device buffer is int32 holding each uint32 word less 2^31, so int32
# order is the words' order.
_BIAS32 = 1 << 31
# Rows the scatter sends nowhere (masked or off the frame) spread over this
# many spill slots past the frame, not one contended address.
_SPILL = 1024


def quantized_keys(depth_bits: torch.Tensor, rgb24: torch.Tensor) -> torch.Tensor:
    """The int64 words ``(depth_bits >> 16) << 16 | rgb565``: the uint32 bit
    patterns (given as int32) shifted as unsigned, the colour's top 5, 6
    and 5 bits."""
    depth = depth_bits.to(torch.int64) & 0xFFFFFFFF
    c = rgb24.to(torch.int64)
    rgb565 = (((c >> 19) & 0x1F) << 11) | (((c >> 10) & 0x3F) << 5) | ((c >> 3) & 0x1F)
    return ((depth >> 16) << 16) | rgb565


def quantized_scatter(
    cx: torch.Tensor, cy: torch.Tensor, depth_bits: torch.Tensor, rgb24: torch.Tensor,
    r: torch.Tensor, visible: torch.Tensor, *, width: int, height: int,
) -> torch.Tensor:
    """The small splats' ``(H * W,)`` int32 buffer (each word less 2^31) on
    the splats' device, enqueued without a host sync.  Each visible splat
    with ``r < 2`` min-reduces its word into every pixel ``(cx + dx, cy +
    dy)`` in the frame with ``r >= |(dx, dy)|`` (float32 compare)."""
    dev = _check_splats(cx, cy, depth_bits, rgb24, r, visible, width, height)
    n, hw = cx.shape[0], height * width
    words = (quantized_keys(depth_bits, rgb24) - _BIAS32).to(torch.int32)
    small = visible & (r < DEVICE_RMAX)
    buf = torch.full((hw + _SPILL,), EMPTY32 - _BIAS32, dtype=torch.int32, device=dev)
    spill = hw + (torch.arange(n, device=dev) & (_SPILL - 1))
    x0, y0 = cx.to(torch.int64), cy.to(torch.int64)
    for dx, dy in DEVICE_OFFSETS:
        need = float(np.float32(math.hypot(dx, dy)))
        m = small if need == 0.0 else small & (r >= need)
        x, y = x0 + dx, y0 + dy
        m = m & (x >= 0) & (x < width) & (y >= 0) & (y < height)
        buf.scatter_reduce_(0, torch.where(m, y * width + x, spill), words, "amin")
    return buf[:hw]


def quantized_large(
    cx: torch.Tensor, cy: torch.Tensor, depth_bits: torch.Tensor, rgb24: torch.Tensor,
    r: torch.Tensor, visible: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, np.ndarray]:
    """The visible splats with ``r >= 2`` on the host: int64 centres and
    words, float64 radii (a host sync on the current stream).  Their order
    does not matter: a minimum does not depend on it."""
    sel = torch.nonzero(visible & (r >= DEVICE_RMAX)).squeeze(1)
    rows = torch.stack([cx[sel].to(torch.int64), cy[sel].to(torch.int64), quantized_keys(depth_bits[sel], rgb24[sel]),
                        r[sel].to(torch.float64).view(torch.int64)]).cpu()
    return rows[0], rows[1], rows[2], rows[3].view(torch.float64).numpy()


def quantized_frame(words: torch.Tensor, large, *, width: int, height: int) -> torch.Tensor:
    """The ``(H * W,)`` int64 framebuffer of uint32 words on the host: the
    device buffer ``words`` (int32, less 2^31, on the CPU) with the large
    splats stamped in by ``native/_raster.c`` (the words are below 2^32, so
    int64 order is theirs; :func:`quantized_frame_plain` is its twin)."""
    buf = words.to(torch.int64) + _BIAS32
    cx, cy, key, rs = large
    native.stamp_discs(buf, height, width, cx, cy, rs, key)
    return buf


def quantized_frame_plain(words: torch.Tensor, large, *, width: int, height: int) -> torch.Tensor:
    """Plain twin of :func:`quantized_frame`: the large splats stamped one by
    one by :func:`_stamp_large`."""
    buf = words.to(torch.int64) + _BIAS32
    _stamp_large(buf.view(height, width), *large)
    return buf


def resolve_quantized(
    cx: torch.Tensor, cy: torch.Tensor, depth_bits: torch.Tensor, rgb24: torch.Tensor,
    r: torch.Tensor, visible: torch.Tensor, *, width: int, height: int,
) -> torch.Tensor:
    """The quantized framebuffer of the splats, on the host."""
    prep = (cx, cy, depth_bits, rgb24, r, visible)
    words = quantized_scatter(*prep, width=width, height=height).cpu()
    return quantized_frame(words, quantized_large(*prep), width=width, height=height)


@functools.cache
def _decode565() -> np.ndarray:
    """Every rgb565 word's 8-bit colour by bit replication, (65536, 3) uint8."""
    v = np.arange(65536)
    r5, g6, b5 = (v >> 11) & 0x1F, (v >> 5) & 0x3F, v & 0x1F
    return np.stack([(r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)], axis=-1).astype(np.uint8)


def quantized_image(
    buf: torch.Tensor, *, width: int, height: int, background: tuple[int, int, int] = (0, 0, 0)
) -> np.ndarray:
    """The ``(H, W, 3)`` uint8 image of a quantized framebuffer: rgb565 to
    8 bits a channel by bit replication (a table lookup), the background
    where no splat landed."""
    lut = np.concatenate([_decode565(), np.asarray(background, np.uint8)[None]])
    b = buf.numpy()
    return np.take(lut, np.where(b == EMPTY32, 65536, b & 0xFFFF), axis=0).reshape(height, width, 3)
