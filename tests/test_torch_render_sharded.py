"""The sharded render (``nbody3d_tpu_torch/render/sharded.py``) on the CPU
against the JAX package's ``render/sharded.py``.

D ranks are replayed in one process (``ReplayGroup``): each rank resolves
its rows with ``splat_resolve``'s twin and the frames merge with one
``amin`` of the flipped words.  Fed the JAX device prep's rows, the merged
rgb and depth planes and ``n_uncovered`` are bit-equal to JAX's
``make_sharded_render`` on the conftest's virtual mesh and its image to
JAX's single-chip ``render_points(resolve="pallas")`` (interpret mode), at
D = 2, 4 and 8 on ``tests/test_render_sharded.py``'s scene (the last shard
holds the padding rows, at the origin in front of the camera), on the 2 x 4
grid flattened row-major and in the ``direction`` colour mode.  The port's
own path (its prep on each shard) is bit-equal to its one-device frame.
Each JAX interpret-mode resolve takes ~20-30 s here, so the JAX frames are
made once a module.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from nbody3d_tpu.parallel.mesh import default_mesh as jax_default_mesh  # noqa: E402
from nbody3d_tpu.parallel.mesh import grid_mesh as jax_grid_mesh  # noqa: E402
from nbody3d_tpu.parallel.sharded import shard_state as jax_shard_state  # noqa: E402
from nbody3d_tpu.render import rasterize as jax_raster  # noqa: E402
from nbody3d_tpu.render import sharded as jax_sharded  # noqa: E402
from nbody3d_tpu.state import init_state as jax_init_state  # noqa: E402
from nbody3d_tpu.utils.camera import Camera as JaxCamera  # noqa: E402
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts  # noqa: E402
from nbody3d_tpu_torch.parallel.exchange import ReplayGroup  # noqa: E402
from nbody3d_tpu_torch.render import rasterize, resolve  # noqa: E402
from nbody3d_tpu_torch.render import sharded  # noqa: E402
from nbody3d_tpu_torch.state import init_state  # noqa: E402
from nbody3d_tpu_torch.utils.camera import Camera  # noqa: E402

N, N_PAD, FRAME = 1000, 1024, dict(width=320, height=240)


def scene(n, seed=5):
    """``tests/test_render_sharded.py``'s scene: N(0, 2.5) positions, masses
    U(10, 50) with two at 1e7 (large splats), N(0, 5) velocities."""
    rng = np.random.default_rng(seed)
    pm = np.concatenate([rng.normal(scale=2.5, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)
    pm[:2, 3] = 1e7
    return pm, rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)


def padded(pm, vel, n_pad):
    """The JAX package's padded rows (zeros: mass-0 bodies at the origin)."""
    st = jax_init_state(pm, vel, n_pad=n_pad)
    return np.asarray(st.pos_mass), np.asarray(st.vel)


def jax_prep_shards(pm_pad, vel_pad, cam, d, width, height, color_mode="magnitude"):
    """The JAX device prep of the padded rows (elementwise: a shard's values
    are the whole array's rows), cut into ``d`` shards of torch tensors."""
    out = jax_raster._prep_device_unsorted_raw(pm_pad, vel_pad, JaxCamera.from_dict(cam.to_dict()), width, height,
                                               1000.0, 64, color_mode)
    cols = [np.asarray(jax.device_get(a)) for a in out]
    cols[2], cols[3] = cols[2].view(np.int32), cols[3].view(np.int32)
    shard = pm_pad.shape[0] // d
    return [[torch.from_numpy(np.array(c[r * shard:(r + 1) * shard])) for c in cols] for r in range(d)]


def jax_sharded_frame(mesh, pm, vel, n_pad, cam, width, height, color_mode="magnitude", axis=None):
    """JAX ``make_sharded_render``'s (rgb, depth, n_uncovered) as numpy."""
    st = jax_shard_state(jax_init_state(pm, vel, n_pad=n_pad), mesh, *((axis,) if axis else ()))
    render = jax_sharded.make_sharded_render(mesh, n_pad, pm.shape[0], width=width, height=height,
                                             color_mode=color_mode, axis=axis)
    jcam = JaxCamera.from_dict(cam.to_dict())
    vp, f = jcam.view_proj(width / height)
    rgb, depth, n_unc = render(st.pos_mass, st.vel, vp, f, jcam.position)
    return np.asarray(rgb), np.asarray(depth), int(n_unc)


def assert_planes(buf, want, width, height):
    rgb, depth = resolve.buffer_planes(buf, width=width, height=height)
    np.testing.assert_array_equal(rgb.numpy(), want[0].astype(np.int64))
    np.testing.assert_array_equal(depth.numpy().view(np.int32), want[1].view(np.int32))


@pytest.fixture(scope="module")
def base():
    """The scene, the camera, and the JAX package's single-chip "pallas"
    frame of the real rows."""
    pm, vel = scene(N)
    cam = Camera(target=np.zeros(3), radius=5.0)
    ref = jax_raster.render_points(pm, vel, JaxCamera.from_dict(cam.to_dict()), resolve="pallas", **FRAME)
    return pm, vel, cam, ref


@pytest.mark.parametrize("d", [2, 4, 8])
def test_merge_matches_jax_sharded_and_single_chip(base, d):
    """D replayed ranks on the JAX prep's shards: the merged planes bit-equal
    to JAX ``make_sharded_render`` on ``default_mesh(D)`` (n_uncovered 0 on
    both), the image to JAX's single-chip "pallas" frame; the padding rows,
    in the last shard and in front of the camera, masked."""
    pm, vel, cam, ref = base
    pm_pad, vel_pad = padded(pm, vel, N_PAD)
    preps = jax_prep_shards(pm_pad, vel_pad, cam, d, **FRAME)
    assert bool(preps[-1][5][-(N_PAD - N):].any())  # the padding would splat
    buf = sharded.sharded_resolve(ReplayGroup(d), preps, N, **FRAME)
    want = jax_sharded_frame(jax_default_mesh(d), pm, vel, N_PAD, cam, **FRAME, axis="x")
    assert want[2] == 0
    assert_planes(buf, want, **FRAME)
    img = resolve.buffer_image(buf, **FRAME).numpy()
    np.testing.assert_array_equal(img, ref)
    np.testing.assert_array_equal(sharded.sharded_frame_image(want[0]), ref)
    assert (img.sum(axis=2) > 0).sum() > 500


@pytest.mark.parametrize("d", [2, 4, 8])
def test_port_path_matches_one_device_frame(base, d):
    """The port's own prep on each rank's shard of the padded state (its
    ``init_state``), through ``make_sharded_render``, against its one-device
    ``render_points`` and ``render_buffer`` of the real rows: bit for bit;
    the CPU twin, no kernel launched."""
    pm, vel, cam, _ = base
    st = init_state(pm, vel, n_pad=N_PAD, device="cpu")
    render = sharded.make_sharded_render(ReplayGroup(d), N_PAD, N, **FRAME)
    reset_launch_counts()
    pms, vels = list(st.pos_mass.view(d, -1, 4)), list(st.vel.view(d, -1, 4))
    rgb, depth, n_unc = render(pms, vels, cam)
    one = rasterize.render_buffer(st.pos_mass[:N], st.vel[:N], cam, **FRAME)
    want_rgb, want_depth = resolve.buffer_planes(one, **FRAME)
    assert n_unc == 0 and torch.equal(rgb, want_rgb) and torch.equal(depth.view(torch.int32), want_depth.view(torch.int32))
    img = render.image(pms, vels, cam).numpy()
    np.testing.assert_array_equal(img, rasterize.render_points(st.pos_mass[:N], st.vel[:N], cam, **FRAME))
    np.testing.assert_array_equal(sharded.sharded_frame_image(rgb), img)
    assert all(c == 0 for c in launch_counts().values())


def test_grid_mesh_flattened_row_major():
    """``tests/test_render_sharded.py``'s 2-D case at its own size (512
    bodies, 256x160, n_pad 512): JAX's render on ``grid_mesh(n_devices=8)``
    (2 x 4, axes flattened row-major) against 8 replayed ranks in row-major
    order, and both against the single-chip "pallas" frame."""
    n, frame = 512, dict(width=256, height=160)
    pm, vel = scene(n, seed=6)
    cam = Camera(target=np.zeros(3), radius=4.0)
    mesh = jax_grid_mesh(n_devices=8)
    assert tuple(mesh.shape.values()) == (2, 4)
    want = jax_sharded_frame(mesh, pm, vel, n, cam, **frame)
    buf = sharded.sharded_resolve(ReplayGroup(8), jax_prep_shards(pm, vel, cam, 8, **frame), n, **frame)
    assert_planes(buf, want, **frame)
    ref = jax_raster.render_points(pm, vel, JaxCamera.from_dict(cam.to_dict()), resolve="pallas", **frame)
    np.testing.assert_array_equal(resolve.buffer_image(buf, **frame).numpy(), ref)


def test_direction_colour_mode():
    """``color_mode="direction"`` (``nbody3d.js:381``): 4 replayed ranks on
    the JAX prep's shards against JAX ``make_sharded_render(color_mode=
    "direction")`` on ``default_mesh(4)``, bit for bit, at 160x120; the
    port's own path against its one-device frame."""
    frame = dict(width=160, height=120)
    pm, vel = scene(N)
    cam = Camera(target=np.zeros(3), radius=5.0)
    pm_pad, vel_pad = padded(pm, vel, N_PAD)
    preps = jax_prep_shards(pm_pad, vel_pad, cam, 4, **frame, color_mode="direction")
    buf = sharded.sharded_resolve(ReplayGroup(4), preps, N, **frame)
    want = jax_sharded_frame(jax_default_mesh(4), pm, vel, N_PAD, cam, **frame, color_mode="direction", axis="x")
    assert_planes(buf, want, **frame)
    magnitude = sharded.sharded_resolve(ReplayGroup(4), jax_prep_shards(pm_pad, vel_pad, cam, 4, **frame), N, **frame)
    assert not torch.equal(buf, magnitude)
    st = init_state(pm, vel, n_pad=N_PAD, device="cpu")
    render = sharded.make_sharded_render(ReplayGroup(4), N_PAD, N, **frame, color_mode="direction")
    np.testing.assert_array_equal(
        render.image(list(st.pos_mass.view(4, -1, 4)), list(st.vel.view(4, -1, 4)), cam).numpy(),
        rasterize.render_points(st.pos_mass[:N], st.vel[:N], cam, color_mode="direction", **frame))


def test_a_pixel_one_rank_reaches_keeps_its_word():
    """The trap in the merge: MISS is all ones, -1 as an int64, so a signed
    minimum of the raw words (what ``ReduceOp.MIN`` and ``torch.minimum``
    take) lets a miss win every pixel.  With the top bit flipped the merge
    is the words' unsigned minimum: a pixel only one rank reaches keeps that
    rank's word, a pixel two reach the smaller word (nearer, then the
    smaller colour), a pixel none reaches stays MISS."""
    hw = 12
    near, far = resolve.make_keys(torch.tensor([0x3E000000, 0x3F000000]), torch.tensor([0x00FF00, 0x0000FF]))
    words = [torch.full((hw,), resolve.MISS, dtype=torch.int64) for _ in range(3)]
    words[1][3] = far  # only rank 1 reaches pixel 3
    words[0][5], words[2][5] = far, near  # ranks 0 and 2 reach pixel 5
    merged = sharded.merge_words(ReplayGroup(3), words)
    assert int(merged[3]) == int(far) and int(merged[5]) == int(near)
    assert int((merged == resolve.MISS).sum()) == hw - 2
    raw = torch.minimum(torch.minimum(words[0], words[1]), words[2])
    assert int(raw[3]) == resolve.MISS  # the signed minimum loses rank 1's word


def test_padding_rows_are_masked_by_global_row():
    """``shard_words`` clears ``visible`` from global row ``n_real`` on: a
    rank whose shard straddles ``n_real`` draws its real rows alone, and a
    rank past it draws nothing, whatever its prep says."""
    w, h = 32, 32
    n = 4
    prep = [torch.full((n,), 16, dtype=torch.int32), torch.full((n,), 16, dtype=torch.int32),
            torch.tensor([0x3E000000 + i for i in range(n)], dtype=torch.int32),
            torch.arange(n, dtype=torch.int32), torch.full((n,), 0.5, dtype=torch.float32),
            torch.ones(n, dtype=torch.bool)]
    words = sharded.shard_words(prep, 1, 6, width=w, height=h)  # global rows 4..7, two real
    assert int(words[16 * w + 16]) == int(resolve.make_keys(prep[2][:1], prep[3][:1])[0])
    assert bool((sharded.shard_words(prep, 2, 6, width=w, height=h) == resolve.MISS).all())
    with pytest.raises(ValueError, match="not divisible"):
        sharded.make_sharded_render(ReplayGroup(3), 1024, 1000, width=w, height=h)
