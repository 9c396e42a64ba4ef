"""Command-line interface of the PyTorch port.

- ``info``   torch, CUDA and device report.
- ``run``    simulate a preset with periodic logging and diagnostics.
- ``bench``  throughput benchmark printing one JSON line.

Flags follow ``nbody3d_tpu.cli`` where they apply; ``--device`` names the
device (default ``cuda``, which raises where there is no card).  dt and G
take linear values (``--dt 1e-4``) or log-slider values (``--log-dt -4``).

    python -m nbody3d_tpu_torch.cli run --device cuda --preset two-galaxy --steps 200
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    p.add_argument("--dt", type=float, default=None, help="timestep (default 1e-4)")
    p.add_argument("--log-dt", type=float, default=None, help="dt = 10**value")
    p.add_argument("--G", type=float, default=None, help="gravitational constant (default 1e-4)")
    p.add_argument("--log-G", type=float, default=None, help="G = 10**value")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--backend", default=None, choices=["auto", "pallas", "jnp"],
                   help="auto/pallas = the CUDA kernels, jnp = the plain oracle")
    p.add_argument("--force-mode", default=None, choices=["exact", "sym"])
    p.add_argument("--morton-every", type=int, default=None,
                   help="re-sort bodies along the Z-order curve every N steps (0 = never)")
    p.add_argument("--integrator", default=None, choices=["verlet", "euler", "yoshida4"])
    p.add_argument("--block-target", type=int, default=None,
                   help="sym tile cap (the tile is at most 256 bodies)")


def _build_config(args):
    from nbody3d_tpu_torch.config import SimConfig, log_slider_dt, log_slider_G

    ov = {}
    if args.dt is not None:
        ov["dt"] = args.dt
    elif args.log_dt is not None:
        ov["dt"] = log_slider_dt(args.log_dt)
    if args.G is not None:
        ov["G"] = args.G
    elif args.log_G is not None:
        ov["G"] = log_slider_G(args.log_G)
    for field, arg in [
        ("seed", args.seed),
        ("backend", args.backend),
        ("force_mode", args.force_mode),
        ("morton_every", args.morton_every),
        ("integrator", args.integrator),
        ("block_target", args.block_target),
    ]:
        if arg is not None:
            ov[field] = arg
    return SimConfig().replace(**ov)


def cmd_run(args) -> int:
    from nbody3d_tpu_torch.engine import Simulation

    sim = Simulation.from_preset(args.preset, _build_config(args), n=args.n, device=args.device)
    if args.metrics:
        sim.metrics_path = args.metrics
    done = 0
    while done < args.steps:
        k = min(args.log_every, args.steps - done)
        sim.run(k, chunk=k)
        done += k
        for line in sim.log_lines():
            print(line, flush=True)
        if args.diagnostics:
            d = sim.diagnostics()
            print(
                f"  E={float(d.total_energy):.6e} KE={float(d.kinetic):.6e} "
                f"PE={float(d.potential):.6e} |P|={float(np.linalg.norm(d.momentum)):.3e}",
                flush=True,
            )
    return 0


def cmd_bench(args) -> int:
    from nbody3d_tpu_torch.engine import Simulation

    if args.steps % args.chunk != 0:
        raise SystemExit(
            f"bench: --steps ({args.steps}) must be a multiple of --chunk ({args.chunk})"
        )
    config = _build_config(args)
    sim = Simulation.from_preset(args.preset, config, n=args.n, device=args.device)
    sim.run(max(args.warmup_steps, args.chunk), chunk=args.chunk)
    t0 = time.perf_counter()
    sim.run(args.steps, chunk=args.chunk)
    elapsed = time.perf_counter() - t0
    steps_per_s = args.steps / elapsed
    out = {
        "n_bodies": sim.n_real,
        "n_pad": sim.n_pad,
        "steps": args.steps,
        "elapsed_s": elapsed,
        "steps_per_s": steps_per_s,
        "gints_per_s": sim.pair_interactions_per_step * steps_per_s / 1e9,
        "backend": config.backend,
        "force_mode": config.force_mode,
        "device": str(sim.device),
        "device_name": _device_name(sim.device),
    }
    print(json.dumps(out))
    return 0


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def cmd_info(args) -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
    }
    print(json.dumps(info, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nbody3d-tpu-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a simulation")
    p.add_argument("--preset", default="two-galaxy")
    p.add_argument("--n", type=int, default=None, help="body count override")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--diagnostics", action="store_true")
    p.add_argument("--metrics", default=None, help="append JSONL metrics to this file")
    _add_common(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("bench", help="throughput benchmark (one JSON line)")
    p.add_argument("--preset", default="uniform-sphere")
    p.add_argument("--n", type=int, default=262144)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup-steps", type=int, default=3)
    p.add_argument("--chunk", type=int, default=10)
    _add_common(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("info", help="torch / CUDA device report")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
