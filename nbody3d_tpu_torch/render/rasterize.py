"""Point-splat rasterizer: circles with depth test, one per body.

The port's counterpart of ``nbody3d_tpu/render/rasterize.py``; the
reference semantics are the same (``nbody3d.js:313-415``): world radius
``(m / 4.189)^(1/3)`` with the minimum apparent-size clamp
``max(radius, 2 |viewVec| / f)``, scaled by ``1 / size_factor``; a
screen-space disc of the projected billboard radius; colour by velocity;
depth test 'less' on a black clear colour; the GL-style projection's
effective near plane (see ``utils/mathlib.perspective``).

A frame is a prep and a resolve:

- **prep** projects the bodies and gives each visible one its centre pixel,
  radius, depth bits and colour.  The host prep (:func:`_prep_host`) is
  the JAX package's f64 numpy prep, copied; the device prep
  (:func:`prep_device`) is its f32 ``_project_f32`` in torch on the
  state's device, in input order with no radius sort.
- **resolve** min-reduces the packed keys per pixel
  (``render/resolve.py``): the ``splat_resolve`` kernel on a CUDA device,
  its plain twin on the CPU; or the quantized words of the JAX package's
  ``"device"`` resolve.

:func:`render_points` picks them with ``resolve=``:

- ``"auto"``: the device prep and ``splat_resolve`` on the state's device
  (the kernel on a CUDA state, the twin on a CPU state);
- ``"host"``: the f64 host prep and one disc stamp in C over every splat
  (``native/_raster.c``, :func:`resolve_host`), bit for bit the JAX
  package's default frame (its ``auto``/``native``/``numpy`` resolves);
- ``"device"``: the device prep and the quantized resolve
  (``resolve.quantized_scatter``: ``scatter_reduce_`` on the state's
  device for the splats below 2 px, the rest stamped on the host by
  ``native/_raster.c``), the JAX package's ``"device"`` contract: 16-bit
  depth test, rgb565 colour.

Nothing falls back: a failed build or launch raises.

Two details keep the device prep close to the JAX one: the 4x4
projection is written out as float32 multiply-adds (no matmul, so no
TF32), and the cube root, which torch lacks, is taken in float64 and
rounded once.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody3d_tpu_torch import native
from nbody3d_tpu_torch.render.colormap import direction_colormap, velocity_colormap
from nbody3d_tpu_torch.render.resolve import (
    MISS,
    buffer_image,
    quantized_image,
    resolve_quantized,
    splat_resolve,
)
from nbody3d_tpu_torch.utils.camera import Camera

RESOLVES = ("auto", "host", "device")


def project_points(
    pos: np.ndarray,
    camera: Camera,
    width: int,
    height: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Project world positions. Returns (px, py, depth01, view_depth).

    ``depth01`` is the WebGPU depth-buffer value z_clip/w in [0, 1];
    ``view_depth`` is the positive view-space distance along the camera
    axis (used for apparent-size math).
    """
    aspect = width / height
    vp, _f = camera.view_proj(aspect)
    n = pos.shape[0]
    homo = np.concatenate([pos, np.ones((n, 1), dtype=pos.dtype)], axis=1)
    clip = homo @ vp.T  # (N, 4)
    w = clip[:, 3]
    safe_w = np.where(np.abs(w) < 1e-30, 1e-30, w)
    ndc = clip[:, :3] / safe_w[:, None]
    px = (ndc[:, 0] + 1.0) * 0.5 * width
    py = (1.0 - ndc[:, 1]) * 0.5 * height
    depth01 = clip[:, 2] / safe_w  # WebGPU z in [0,1] visible range
    return px, py, depth01, w  # w_clip == view-space distance for this proj


def _prep_host(pos_mass, vel, camera, width, height, size_factor,
               max_radius_px, color_mode):
    """Host (numpy, f64) projection/radius/color prep.  Returns
    ``(cx, cy, keys, r)`` sorted by radius descending, visible bodies
    only — the resolve inputs."""
    pos = np.asarray(pos_mass, dtype=np.float64)[:, :3]
    mass = np.asarray(pos_mass, dtype=np.float64)[:, 3]
    vel3 = np.asarray(vel, dtype=np.float64)[:, :3]

    aspect = width / height
    _vp, f = camera.view_proj(aspect)
    px, py, depth01, view_w = project_points(pos, camera, width, height)

    # World-space billboard half-extent (nbody3d.js:346,358; camera.js:61).
    view_vec_len = np.linalg.norm(pos - camera.position[None, :], axis=1)
    radius_world = np.cbrt(mass / 4.189)
    half_extent = np.maximum(radius_world, 2.0 * view_vec_len / f) / size_factor

    # Projected pixel radius: perpendicular world length L at view depth d
    # spans L * f / d in NDC y, i.e. L * f / d * H/2 pixels.
    safe_d = np.maximum(view_w, 1e-30)
    r_px = half_extent * f / safe_d * (height * 0.5)

    visible = (view_w > 0) & (depth01 >= 0.0) & (depth01 <= 1.0)
    r_px = np.clip(r_px, 0.5, max_radius_px)
    visible &= (px + r_px >= 0) & (px - r_px < width)
    visible &= (py + r_px >= 0) & (py - r_px < height)

    idx = np.nonzero(visible)[0]
    if idx.size == 0:
        return (np.empty(0, np.int64),) * 2 + (
            np.empty(0, np.uint64), np.empty(0, np.float64),
        )

    if color_mode == "direction":
        rgb = (direction_colormap(vel3[idx]) * 255.0).astype(np.uint32)
    else:
        speed = np.linalg.norm(vel3[idx], axis=1)
        rgb = (velocity_colormap(speed) * 255.0).astype(np.uint32)
    rgb24 = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]

    cx = np.round(px[idx]).astype(np.int64)
    cy = np.round(py[idx]).astype(np.int64)
    depth = depth01[idx].astype(np.float32)
    keys = (np.ascontiguousarray(depth).view(np.uint32).astype(np.uint64) << 32) | rgb24

    # Sort by radius (desc) so stamp offset (dx,dy) only visits the first k
    # bodies with r >= |offset|.
    r = r_px[idx]
    order = np.argsort(-r, kind="stable")
    return cx[order], cy[order], keys[order], r[order]


def prep_device(
    pos_mass: torch.Tensor,
    vel: torch.Tensor,
    camera: Camera,
    width: int,
    height: int,
    size_factor: float = 1000.0,
    max_radius_px: float = 64,
    color_mode: str = "magnitude",
):
    """The f32 prep on ``pos_mass``'s device (the JAX ``_project_f32``).
    Returns per-body ``(cx, cy, depth_bits, rgb24, r, visible)`` in input
    order: int32 centre pixels, the int32 bit pattern of the clipped [0, 1]
    depth, int32 rgb24, float32 radius in pixels and a bool mask."""
    vp, f = camera.view_proj(width / height)
    vp = [[float(v) for v in row] for row in vp]  # float32 values, exact as floats
    campos = torch.from_numpy(np.asarray(camera.position, dtype=np.float32))
    if pos_mass.is_cuda:
        # From pinned memory, non-blocking: a pageable copy would make the
        # host wait for the device's stream.
        campos = campos.pin_memory().to(pos_mass.device, non_blocking=True)
    x, y, z, m = (pos_mass[:, c] for c in range(4))
    # clip = [x, y, z, 1] @ vp.T, as float32 multiply-adds in the matmul's order.
    clip = [x * row[0] + y * row[1] + z * row[2] + row[3] for row in vp]
    w = clip[3]
    safe_w = torch.where(w.abs() < 1e-30, 1e-30, w)
    ndc_x, ndc_y, depth01 = clip[0] / safe_w, clip[1] / safe_w, clip[2] / safe_w
    px = (ndc_x + 1.0) * 0.5 * width
    py = (1.0 - ndc_y) * 0.5 * height
    view_vec_len = torch.linalg.vector_norm(pos_mass[:, :3] - campos, dim=1)
    radius_world = torch.pow((m / 4.189).double(), 1.0 / 3.0).float()  # cbrt, rounded once
    half_extent = torch.maximum(radius_world, 2.0 * view_vec_len / f) / size_factor
    r_px = half_extent * f / torch.clamp(w, min=1e-30) * (height * 0.5)
    r_px = torch.clamp(r_px, 0.5, float(max_radius_px))
    visible = (w > 0) & (depth01 >= 0.0) & (depth01 <= 1.0)
    visible &= (px + r_px >= 0) & (px - r_px < width)
    visible &= (py + r_px >= 0) & (py - r_px < height)

    v3 = vel[:, :3]
    if color_mode == "direction":
        norm = torch.linalg.vector_norm(v3, dim=1, keepdim=True)
        unit = torch.where(norm > 0, v3 / torch.clamp(norm, min=1e-30), 0.0)
        rgbf = torch.clamp(unit * 0.5 + 0.5, 0.0, 1.0)
    elif color_mode == "magnitude":
        v = torch.linalg.vector_norm(v3, dim=1) / 40.0  # nbody3d.js:380
        rgbf = torch.clamp(torch.stack([v, 1.0 - (v - 0.5).abs(), 1.0 - v], dim=1), 0.0, 1.0)
    else:
        raise ValueError(f"unknown color_mode {color_mode!r}")
    rgb = (rgbf * 255.0).to(torch.int32)
    rgb24 = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    depth_bits = torch.clamp(depth01, 0.0, 1.0).view(torch.int32)
    # Off-screen bodies may project to inf/nan; their centres are masked out.
    cx = torch.where(visible, torch.round(px), 0.0).to(torch.int32)
    cy = torch.where(visible, torch.round(py), 0.0).to(torch.int32)
    return cx, cy, depth_bits, rgb24, r_px.contiguous(), visible


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def render_buffer(
    pos_mass,
    vel,
    camera: Camera,
    *,
    width: int = 1024,
    height: int = 768,
    size_factor: float = 1000.0,
    max_radius_px: float = 64,
    color_mode: str = "magnitude",
    resolve: str = "auto",
) -> torch.Tensor:
    """The ``(H * W,)`` framebuffer of one frame (``render/resolve.py``), on
    the state's device for ``resolve="auto"``, on the CPU for ``"host"``
    and (the uint32 words of the quantized resolve) ``"device"``.  See
    :func:`render_points` for the arguments."""
    if resolve not in RESOLVES:
        raise ValueError(f"unknown resolve {resolve!r} ({', '.join(RESOLVES)})")
    args = (camera, width, height, size_factor, max_radius_px, color_mode)
    if resolve != "host":
        pm, v = _as_tensor(pos_mass), _as_tensor(vel)
        fn = splat_resolve if resolve == "auto" else resolve_quantized
        return fn(*prep_device(pm, v, *args), width=width, height=height)
    if isinstance(pos_mass, torch.Tensor):
        pos_mass, vel = pos_mass.detach().cpu().numpy(), vel.detach().cpu().numpy()
    return resolve_host(*_prep_host(pos_mass, vel, *args), width=width, height=height)


def resolve_host(cx: np.ndarray, cy: np.ndarray, keys: np.ndarray, r: np.ndarray, *, width: int,
                 height: int) -> torch.Tensor:
    """The ``host`` resolve of the host prep's splats: one pass of
    ``native/_raster.c`` over every splat into an all-ones buffer, as the
    JAX package's ``native`` resolve.  The ``(H * W,)`` int64 framebuffer,
    bit for bit :func:`resolve.resolve_keys_plain`'s (its twin)."""
    buf = torch.full((height * width,), MISS, dtype=torch.int64)
    native.stamp_discs(buf, height, width, cx, cy, r, keys)
    return buf


def render_points(
    pos_mass,
    vel,
    camera: Camera,
    *,
    width: int = 1024,
    height: int = 768,
    size_factor: float = 1000.0,
    max_radius_px: float = 64,
    background: tuple[int, int, int] = (0, 0, 0),
    color_mode: str = "magnitude",
    resolve: str = "auto",
) -> np.ndarray:
    """Render one frame. Returns (H, W, 3) uint8 on the host.

    ``pos_mass``/``vel``: (N, 4) float32 tensors (the real rows: mass-0
    padding would still splat through the minimum-size clamp) or numpy
    arrays.  ``color_mode``: "magnitude" (``nbody3d.js:380``) or
    "direction" (``nbody3d.js:381``).  ``resolve``: "auto" (the device prep
    and the ``splat_resolve`` kernel on the state's device; its twin for a
    CPU state), "host" (the f64 host prep and the C disc stamp: the JAX
    package's default frame), or "device" (the device prep and the
    quantized resolve: 16-bit depth, rgb565 colour).
    """
    buf = render_buffer(
        pos_mass, vel, camera, width=width, height=height, size_factor=size_factor,
        max_radius_px=max_radius_px, color_mode=color_mode, resolve=resolve,
    )
    if resolve == "device":
        return quantized_image(buf, width=width, height=height, background=background)
    return buffer_image(buf, width=width, height=height, background=background).cpu().numpy()
