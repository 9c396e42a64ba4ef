"""The gather's run boxes (``csrc/mesh_gather.cu``) on the CPU: the
periodic gather twin (what ``mesh_gather`` runs on CPU tensors) on
``gather_checks.seam_scenes()`` against the JAX package's periodic XLA
gathers at both orders (1e-5 of the max, as
``test_torch_periodic.py::test_periodic_gather_twin_matches_jax``), and the
torch mirror of the kernel's run boxes: every stencil point of a boxed run
inside its run's box, and the gather read through the boxes bit-equal to
the twin, on the seam scenes and on the deposit's isolated adversarial
scenes.  The mirror is port code, so the tests through it check the
scenes' geometry and the mirror's decisions (each run's box, each path),
not the kernel's own indexing: the kernel runs only on a card, where
``chip_smoke.py`` holds it bit for bit to the twin, to the parent's kernel
and to its other form on every one of these scenes (grid 1,290 too), and
its block paths to the mirror's."""

import pathlib
import re

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import nbody3d_tpu.ops.p3m as jp3m  # noqa: E402
import nbody3d_tpu.ops.pm as jpm  # noqa: E402
from nbody3d_tpu_torch import gather_checks, scatter_checks  # noqa: E402
from nbody3d_tpu_torch.ops import mesh_cuda as mc  # noqa: E402
from nbody3d_tpu_torch.ops import p3m  # noqa: E402

SCENES = gather_checks.seam_scenes()
ISOLATED = {k: v for k, v in scatter_checks.deposit_adversarial().items() if not v[2]}
GRIDS = (32, 16)


def sorted_rows(name):
    """A scene's rows as :func:`scatter_checks.deposit_operands` orders them."""
    pm_np, n_real, sort = SCENES[name]
    rows = torch.from_numpy(pm_np)
    if sort:
        rows = rows[torch.argsort(p3m.morton_keys(rows, n_real), stable=True)].contiguous()
    return rows


def operands(name, grid, order):
    pm_np, n_real, sort = SCENES[name]
    return scatter_checks.deposit_operands(pm_np, n_real, True, grid, order, torch.device("cpu"), sort=sort)


def jax_gather(rows, grids, c4, fm, grid, order):
    """The JAX package's periodic XLA gather at its own cells of ``rows``
    (held bit-equal to the port's, ``c4`` and ``fm``)."""
    pos, lo, h = jnp.asarray(rows[:, :3].numpy()), jnp.zeros(3, jnp.float32), jnp.float32(1.0) / grid
    g = jnp.asarray(grids.numpy())
    if order == 3:
        c, w, f = jp3m._tsc_cells(pos, lo, h, grid, periodic=True)
        out = jp3m.tsc_gather(g, c, w, grid)
    else:
        c, f = jpm._cic_cells(pos, lo, h, grid, periodic=True)
        out = jpm.cic_gather(g, c, f, grid)
    np.testing.assert_array_equal(c4[:, :3].numpy(), np.asarray(c))
    np.testing.assert_array_equal(fm[:, :3].numpy(), np.asarray(f))
    return np.asarray(out)


@pytest.mark.parametrize("order", [3, 2])
@pytest.mark.parametrize("name", list(SCENES))
def test_seam_scene_twin_matches_jax(name, order):
    grid = 32
    c4, fm = operands(name, grid, order)
    grids = torch.from_numpy(np.random.default_rng(order).normal(size=(3, grid**3)).astype(np.float32))
    got = mc.gather(grids, c4, fm, grid, order, periodic=True).numpy()
    want = jax_gather(sorted_rows(name), grids, c4, fm, grid, order)
    assert not got[:, 3].any()
    assert np.abs(got[:, :3] - want).max() <= 1e-5 * np.abs(want).max()


def straddles(boxes, grid, order):
    """``(runs, 3)``: whether a run's unwrapped base cells cross a seam in
    each axis (some below 0 or some at or past ``grid``)."""
    least = boxes["first"] + (1 if order == 3 else 0)
    most = least + boxes["extent"] - order
    return (least < 0) | (most >= grid)


def test_seam_scenes_reach_both_paths_and_the_faces():
    """The scenes make the edge cases they are named for: a corner run
    straddles the seams in x, y and z at once, and every corner run is
    boxed; the far corner's stencils wrap onto the first and the last cell,
    and (grid 16) the run of its first padding row holds padding rows at
    the origin with the far corner's cells in one box across all three
    seams; every spread
    run exceeds the cap; the uniform box (grid 32) takes both paths."""
    order = 3
    boxes = {(name, grid): gather_checks.run_boxes(operands(name, grid, order)[0], grid, order, True)
             for name in SCENES for grid in GRIDS}
    corner = boxes["corner", 32]
    assert bool(corner["boxed"].all()) and bool(straddles(corner, 32, order).all(dim=1).any())
    c_far = operands("far corner and padding", 32, order)[0][:, :3]
    assert bool((c_far == 31).all(dim=1).any()) and bool((c_far == 0).all(dim=1).any())
    far, mixed = boxes["far corner and padding", 16], SCENES["far corner and padding"][1] // gather_checks.RUN
    assert bool(far["boxed"][mixed]) and bool(straddles(far, 16, order)[mixed].all())
    assert not any(bool(boxes["spread", g]["boxed"].any()) for g in GRIDS)
    assert 0 < int(boxes["uniform", 32]["boxed"].sum()) < boxes["uniform", 32]["boxed"].numel()


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("order", [3, 2])
@pytest.mark.parametrize("name", list(SCENES))
def test_gather_through_run_boxes_is_the_twin(name, order, grid):
    """The mirror's geometry: every stencil point of a boxed run lies in its
    run's box after the unwrap (``gather_through_boxes`` raises otherwise),
    and the values read through the boxes, wrapped back mod grid, give the
    twin's bits."""
    pm_np, n_real, sort = SCENES[name]
    c4, fm = scatter_checks.deposit_operands(pm_np, n_real, True, grid, order, torch.device("cpu"), sort=sort)
    grids = torch.from_numpy(np.random.default_rng(grid).normal(size=(3, grid**3)).astype(np.float32))
    got = gather_checks.gather_through_boxes(grids, c4, fm, grid, order, periodic=True)
    assert torch.equal(got, mc.gather_plain(grids, c4, fm, grid, order, periodic=True))


@pytest.mark.parametrize("order", [3, 2])
@pytest.mark.parametrize("name", list(ISOLATED))
def test_isolated_run_boxes_cover_every_stencil(name, order):
    grid = 32
    pm_np, n_real, _ = ISOLATED[name]
    c4, fm = scatter_checks.deposit_operands(pm_np, n_real, False, grid, order, torch.device("cpu"),
                                             sort=name != "shuffled")
    grids = torch.from_numpy(np.random.default_rng(3).normal(size=(3, grid**3)).astype(np.float32))
    got = gather_checks.gather_through_boxes(grids, c4, fm, grid, order, periodic=False)
    assert torch.equal(got, mc.gather_plain(grids, c4, fm, grid, order))
    boxes = gather_checks.run_boxes(c4, grid, order, False)
    first, last = boxes["first"], boxes["first"] + boxes["extent"] - 1
    assert bool((first >= 0).all() and (last < grid).all())  # isolated boxes lie in the grid


def test_mirror_constants_are_the_kernels():
    src = (pathlib.Path(mc.__file__).resolve().parents[1] / "csrc" / "mesh_gather.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    cap = int(re.search(r"#define NB_GATHER_BOX_CAP (\d+)", src).group(1))
    assert (threads, cap) == (gather_checks.RUN, gather_checks.BOX_CAP)


@pytest.mark.parametrize("periodic", [True, False])
def test_tight_corner_boxes_runs_at_the_largest_grid(periodic):
    """At grid 1,290 (``mesh_cuda``'s largest, where the kernel's second and
    third grids start past 2^31 floats) the tight corner's runs take the box,
    across the seams on the torus and within 4 cells of the grid's end on
    the isolated box, and the mirror's boxes cover their stencils; ``chip_smoke``
    gathers this scene there on the card."""
    grid, order = 1290, 3
    pm_np, n_real, sort = SCENES["tight corner"]
    c4, fm = scatter_checks.deposit_operands(pm_np, n_real, periodic, grid, order, torch.device("cpu"), sort=sort)
    boxes = gather_checks.run_boxes(c4, grid, order, periodic)
    boxed = boxes["boxed"]
    assert bool(boxed.any())
    if periodic:
        assert bool(straddles(boxes, grid, order)[boxed].all(dim=1).any())
    else:
        assert int((boxes["first"] + boxes["extent"] - 1)[boxed].max()) >= grid - 4
    run = torch.arange(c4.shape[0]) // gather_checks.RUN
    local = boxes["cells"] - (1 if order == 3 else 0) - boxes["first"][run]
    inside = (local >= 0) & (local + order <= boxes["extent"][run])
    assert bool(inside[boxed[run]].all())


def test_unsorted_rows_count_every_run_global():
    c4 = operands("spread", 32, 2)[0]
    assert gather_checks.block_paths(c4, 32, 2, True, sorted_rows=False) == [0, 32]
