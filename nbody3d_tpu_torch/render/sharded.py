"""Sharded rendering: each rank rasterizes the rows it holds, and the frames merge by one minimum.

The port of ``nbody3d_tpu/render/sharded.py``.  A sharded state never
gathers for a frame: each rank runs the device prep
(``rasterize.prep_device``, elementwise, so a shard's values are those of
the whole array's rows) on its rows, clears ``visible`` on the padding rows
(global row ``rank * shard + i >= n_real``: mass-0 padding still splats
through the 0.5 px clamp), and resolves them with ``splat_resolve`` into its
``(H * W,)`` int64 words ``depth_bits << 32 | rgb24``.

The frames merge with **one** ``amin`` over the ranks of a
:class:`~nbody3d_tpu_torch.parallel.exchange.RankGroup`.  The JAX package
takes two ``pmin``s, the depth plane and then the rgb among the ranks at the
winning depth; that pair is exactly the unsigned minimum of the words, which
moves the same 8 B/px in one collective.  A minimum is associative and
order-free, so the merged frame is bit for bit one resolve of the gathered
state.  The words are uint64 held in int64 and :data:`~resolve.MISS` (all
ones) is -1 there, so a signed ``MIN`` of the raw words would let a miss win
every pixel: the top bit is flipped before the reduction and back after it
(``resolve._FLIP``), which makes int64 order the words' order.

With a ``DistGroup`` the merge is an ``all_reduce`` over the process group;
with a ``ReplayGroup`` D ranks run in one process (``chip_smoke.py`` phase
19a replays D = 2, 4 and 8 on one card so).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody3d_tpu_torch.parallel.exchange import RankGroup
from nbody3d_tpu_torch.render.rasterize import prep_device
from nbody3d_tpu_torch.render.resolve import _FLIP, buffer_image, buffer_planes, splat_resolve


def shard_words(prep, rank: int, n_real: int, *, width: int, height: int) -> torch.Tensor:
    """One rank's ``(H * W,)`` int64 words: its rows' prep ``(cx, cy,
    depth_bits, rgb24, r, visible)`` with ``visible`` cleared from global row
    ``n_real`` on, through ``splat_resolve``."""
    cx, cy, depth_bits, rgb24, r, visible = prep
    shard = cx.shape[0]
    rows = torch.arange(shard, device=cx.device) + rank * shard
    return splat_resolve(cx, cy, depth_bits, rgb24, r, visible & (rows < n_real), width=width, height=height)


def merge_words(group: RankGroup, words) -> torch.Tensor:
    """The held ranks' words merged over every rank of ``group``: their
    unsigned minimum, one ``group.amin`` of the words with the top bit
    flipped."""
    return group.amin([w ^ _FLIP for w in words]) ^ _FLIP


def sharded_resolve(group: RankGroup, preps, n_real: int, *, width: int, height: int) -> torch.Tensor:
    """The merged ``(H * W,)`` int64 framebuffer of the held ranks' preps
    (one a held rank, in ``group.ranks``' order)."""
    words = [shard_words(p, r, n_real, width=width, height=height) for r, p in zip(group.ranks, preps)]
    return merge_words(group, words)


class ShardedRender:
    """The sharded frame of a state of ``n_pad`` rows (``n_real`` real)
    over ``group``: call it with the held ranks' ``pos_mass`` and ``vel``
    rows (lists, in ``group.ranks``' order) and a camera.  Every rank gets
    the same frame."""

    def __init__(self, group: RankGroup, n_pad: int, n_real: int, *, width: int, height: int,
                 size_factor: float = 1000.0, max_radius_px: float = 64, color_mode: str = "magnitude"):
        if n_pad % group.d:
            raise ValueError(f"n_pad={n_pad} not divisible by mesh size {group.d}")
        self.group, self.n_real = group, n_real
        self.width, self.height = width, height
        self.prep_args = (width, height, size_factor, max_radius_px, color_mode)

    def words(self, pms, vels, camera) -> torch.Tensor:
        """The merged ``(H * W,)`` int64 framebuffer (``render/resolve.py``)."""
        preps = [prep_device(pm, v, camera, *self.prep_args) for pm, v in zip(pms, vels)]
        return sharded_resolve(self.group, preps, self.n_real, width=self.width, height=self.height)

    def image(self, pms, vels, camera, background=(0, 0, 0)) -> torch.Tensor:
        """The ``(H, W, 3)`` uint8 image on the ranks' device."""
        return buffer_image(self.words(pms, vels, camera), width=self.width, height=self.height,
                            background=background)

    def __call__(self, pms, vels, camera):
        """``(rgb (H, W) int64, 0xFFFFFFFF where missed; depth (H, W)
        float32, +inf where missed; n_uncovered)``, the JAX render's three
        outputs.  ``n_uncovered`` is always 0: ``splat_resolve`` has no
        tiers and draws every radius, where the JAX sharded path skips the
        splats above 64 px (only once ``max_radius_px`` is raised past 64)
        and counts them."""
        rgb, depth = buffer_planes(self.words(pms, vels, camera), width=self.width, height=self.height)
        return rgb, depth, 0


def make_sharded_render(group: RankGroup, n_pad: int, n_real: int, *, width: int, height: int,
                        size_factor: float = 1000.0, max_radius_px: float = 64,
                        color_mode: str = "magnitude") -> ShardedRender:
    """The JAX ``make_sharded_render`` over a ``RankGroup``: a
    :class:`ShardedRender`, ``render(pms, vels, camera) -> (rgb, depth,
    n_uncovered)``."""
    return ShardedRender(group, n_pad, n_real, width=width, height=height, size_factor=size_factor,
                         max_radius_px=max_radius_px, color_mode=color_mode)


def sharded_frame_image(rgb, background=(0, 0, 0)) -> np.ndarray:
    """Host assembly of a sharded render's rgb plane into ``(H, W, 3)`` uint8."""
    rgb = rgb.cpu().numpy() if isinstance(rgb, torch.Tensor) else np.asarray(rgb)
    h, w = rgb.shape
    img = np.empty((h, w, 3), np.uint8)
    img[:] = np.asarray(background, np.uint8)
    hit = rgb != 0xFFFFFFFF
    v = rgb[hit].astype(np.int64)
    img[hit, 0] = (v >> 16) & 0xFF
    img[hit, 1] = (v >> 8) & 0xFF
    img[hit, 2] = v & 0xFF
    return img
