"""One sharded step of every mesh configuration, and the sharded render, on D ranks.

The port's counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``): :func:`dryrun_multichip` spawns ``n_devices``
ranks (``launch.spawn``: gloo on ``"cpu"``, NCCL on ``"cuda"``, one card a
rank) that each run one sharded step of the seven configurations at
``n_pad = 64 * D`` rows, ``n_real = n_pad - 16`` (the padding mask too):

- the ring, exact;
- the 2-D grid, fast (when D >= 4 and even);
- ringsym, sym;
- PM, grid 16;
- P3M, grid 16, yoshida4;
- periodic P3M, box 4;
- comoving EdS PM, box 4, dt 1.

Then the ring step's state is rendered at 96x64 by the sharded render
(``render/sharded.py``).  Every step must reach ``step == 1`` with finite
rows, and the frame must have its shape and ``n_uncovered == 0``.  The
steps take the kernel route (``backend="auto"``: the kernels on a card,
their plain twins on CPU tensors).  Returns rank 0's report: each run's
step, the frame's shape and lit pixels, and the kernels each rank launched.

    python -m nbody3d_tpu_torch.parallel.dryrun 4 --device cpu
    python -m nbody3d_tpu_torch.parallel.dryrun 1 --device cuda
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from nbody3d_tpu_torch.config import SimConfig
from nbody3d_tpu_torch.models.sphere import uniform_sphere
from nbody3d_tpu_torch.ops.launch import launch_counts, reset_launch_counts
from nbody3d_tpu_torch.parallel.launch import spawn
from nbody3d_tpu_torch.parallel.mesh import default_mesh, grid_mesh
from nbody3d_tpu_torch.parallel.sharded import make_sharded_step, shard_state
from nbody3d_tpu_torch.state import init_state

FRAME = (96, 64)


def configs(d: int) -> dict[str, SimConfig]:
    """The JAX dryrun's seven configurations (the 2-D one where D >= 4 and even)."""
    base = SimConfig(block_target=32, block_source=32, strategy="ring", backend="auto")
    box = dict(method="p3m", pm_grid=16, boundary="periodic", box_size=4.0)
    out = {"ring exact": base}
    if d >= 4 and d % 2 == 0:
        out["2d fast"] = base.replace(strategy="2d", force_mode="fast")
    out.update({
        "ringsym sym": base.replace(strategy="ringsym", force_mode="sym"),
        "pm grid 16": base.replace(method="pm", pm_grid=16),
        "p3m grid 16 yoshida4": base.replace(method="p3m", pm_grid=16, integrator="yoshida4"),
        "periodic p3m box 4": base.replace(**box),
        "comoving eds pm": base.replace(**{**box, "method": "pm"}, cosmology="eds", dt=1.0),
    })
    return out


def _rank(rank: int, world: int) -> dict:
    """One rank of the dryrun: the seven steps and the render."""
    from nbody3d_tpu_torch.parallel.exchange import DistGroup
    from nbody3d_tpu_torch.render.sharded import make_sharded_render
    from nbody3d_tpu_torch.utils.camera import Camera

    reset_launch_counts()
    n_pad = world * 64
    n_real = n_pad - 16
    pos_mass, vel, _ = uniform_sphere(n_real, rng=np.random.default_rng(0))
    report: dict = {"steps": {}}
    ring = None
    for name, config in configs(world).items():
        mesh = grid_mesh(n_devices=world) if config.strategy == "2d" else default_mesh(world)
        state = shard_state(init_state(pos_mass, vel, n_pad=n_pad, device="cpu"), mesh)
        out = make_sharded_step(config, n_pad, n_real, mesh)(state, config.dt, config.G)
        finite = all(bool(torch.isfinite(t).all()) for t in (out.pos_mass, out.vel, out.accel))
        if out.step != 1 or not finite:
            raise AssertionError(f"dryrun {name}: step {out.step}, finite rows {finite}")
        report["steps"][name] = out.step
        if name == "ring exact":
            ring = out
    w, h = FRAME
    render = make_sharded_render(DistGroup(rank, world), n_pad, n_real, width=w, height=h)
    rgb, _depth, n_unc = render([ring.pos_mass], [ring.vel], Camera(target=np.zeros(3), radius=5.0))
    if tuple(rgb.shape) != (h, w) or n_unc != 0:
        raise AssertionError(f"dryrun render: shape {tuple(rgb.shape)}, n_uncovered {n_unc}")
    report["frame"] = {"shape": [h, w], "n_uncovered": n_unc, "lit": int((rgb != 0xFFFFFFFF).sum())}
    report["launches"] = {k: c for k, c in launch_counts().items() if c}
    return report


def dryrun_multichip(n_devices: int, device: str) -> dict:
    """Run the dryrun on ``n_devices`` spawned ranks of ``device`` (``"cpu"``
    or ``"cuda"``); rank 0's report.  A failed rank raises (``spawn``)."""
    reports = spawn(_rank, n_devices, device=device, timeout=600)
    report = reports[0]
    report["launches_by_rank"] = [r["launches"] for r in reports]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", type=int, nargs="?", default=4, help="ranks (default 4)")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
