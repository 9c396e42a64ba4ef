"""The device mesh over ``torch.distributed``: one process a device.

The JAX package builds a ``jax.sharding.Mesh`` over the devices of one
program (``nbody3d_tpu/parallel/mesh.py``).  Here every rank of an
initialized process group owns one device (``cuda:<local rank>`` over
NCCL, the CPU over gloo), and a :class:`Mesh` names how the ranks are laid
out: ``("x",)`` for the 1-D ring and gather steps, ``("row", "col")`` for
the 2-D grid step, ranks row-major over the axes.  Along each axis the
mesh keeps the process group of the ranks that differ only in that axis'
coordinate, so a collective "over an axis" is a collective over that
group (``lax.all_gather(x, "col")`` becomes an all-gather over
``mesh.groups["col"]``).

The process group comes first: ``parallel/launch.py`` spawns local ranks,
or ``torchrun`` and ``init_process_group("nccl", init_method="env://")``
start them.  Neither constructor makes a group of its own.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# The single-tensor collectives: torch 2.13 names them ``*_single`` and
# warns on the older names, which earlier releases have alone.
all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axes, this rank and its device,
    and along each axis the group of ranks that share every other
    coordinate (``groups[axis]``; in a 1-D mesh the whole world)."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    rank: int
    device: torch.device
    groups: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def coords(self) -> tuple[int, ...]:
        """This rank's coordinate along each axis (row-major ranks)."""
        out, r = [], self.rank
        for s in reversed(self.shape):
            out.append(r % s)
            r //= s
        return tuple(reversed(out))

    def axis_size(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not an axis of the mesh {self.axis_names}")
        return self.shape[self.axis_names.index(axis)]


def _world(n_devices: int | None) -> int:
    """The world size, checked against the requested device count."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "the mesh needs an initialized torch.distributed process group (one process a device): "
            "start the ranks with nbody3d_tpu_torch.parallel.launch.spawn, or torchrun and "
            "init_process_group"
        )
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, the process group has {world} ranks")
    return world


def rank_device() -> torch.device:
    """This rank's device: ``cuda:<current device>`` over NCCL, the CPU
    over gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def default_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    """1-D mesh over every rank of the process group; ``n_devices``, where
    given, must be its size."""
    world = _world(n_devices)
    return Mesh((world,), (axis,), dist.get_rank(), rank_device(), {axis: dist.group.WORLD})


def grid_mesh(
    rows: int | None = None,
    cols: int | None = None,
    axes: tuple[str, str] = ("row", "col"),
    n_devices: int | None = None,
) -> Mesh:
    """2-D ``rows x cols`` mesh for the grid force decomposition (strategy
    ``"2d"``).  With no shape given, the most square factorization of the
    rank count, as the JAX package picks it: per-step traffic scales with
    N/rows + N/cols.  Every rank creates every row and column group, in
    one order (``dist.new_group`` is collective)."""
    d = _world(n_devices)
    if rows is None and cols is None:
        rows = int(d**0.5)
        while d % rows != 0:
            rows -= 1
        cols = d // rows
    elif rows is None:
        if d % cols != 0:
            raise ValueError(f"cols={cols} does not divide {d} devices")
        rows = d // cols
    elif cols is None:
        if d % rows != 0:
            raise ValueError(f"rows={rows} does not divide {d} devices")
        cols = d // rows
    if rows * cols != d:
        raise ValueError(f"mesh {rows}x{cols} != {d} devices")
    rank = dist.get_rank()
    r, c = divmod(rank, cols)
    ax_r, ax_c = axes
    groups = {}
    # Along "col": the ranks of one row (c varies); along "row": one column.
    for i in range(rows):
        g = dist.new_group([i * cols + j for j in range(cols)])
        if i == r:
            groups[ax_c] = g
    for j in range(cols):
        g = dist.new_group([i * cols + j for i in range(rows)])
        if j == c:
            groups[ax_r] = g
    return Mesh((rows, cols), tuple(axes), rank, rank_device(), groups)


def mesh_info() -> dict:
    """Platform and device report (``info``).  In an initialized process
    group: its backend's platform, its ranks as the devices, this rank;
    otherwise the visible cards (or the one CPU) and one process."""
    if dist.is_available() and dist.is_initialized():
        dev = rank_device()
        n, index, count = dist.get_world_size(), dist.get_rank(), dist.get_world_size()
    else:
        dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
        n, index, count = (torch.cuda.device_count() if dev.type == "cuda" else 1), 0, 1
    return {
        "platform": dev.type,
        "n_devices": n,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "process_index": index,
        "process_count": count,
    }
