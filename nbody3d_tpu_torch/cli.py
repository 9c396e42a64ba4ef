"""Command-line interface of the PyTorch port.

- ``info``     torch, CUDA and device report.
- ``run``      simulate a preset or a checkpoint with periodic logging,
               diagnostics, checkpoints and frame dumps.
- ``bench``    throughput benchmark printing one JSON line.
- ``render``   render a checkpoint to PNG.
- ``convert``  convert checkpoints between reference JSON and native npz.

Flags follow ``nbody3d_tpu.cli`` where they apply; ``--device`` names the
device (default ``cuda``, which raises where there is no card).  dt and G
take linear values (``--dt 1e-4``) or log-slider values (``--log-dt -4``).
Resuming a checkpoint keeps its saved config except for the flags given.

    python -m nbody3d_tpu_torch.cli run --preset two-galaxy --steps 2000 --diagnostics \
        --checkpoint-every 500 --render-every 500 --outdir out
    python -m nbody3d_tpu_torch.cli render out/final.npz -o frame.png
    python -m nbody3d_tpu_torch.cli convert out/final.npz final.json
"""

from __future__ import annotations

import argparse
import json
import os
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


def _config_overrides(args) -> dict:
    """The config fields the user set on the command line."""
    from nbody3d_tpu_torch.config import log_slider_dt, log_slider_G

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
    return ov


def _build_config(args, base=None):
    """Fresh runs: defaults + explicit flags.  Resume: the checkpoint's
    saved config + explicit flags only (pass ``base``)."""
    from nbody3d_tpu_torch.config import SimConfig

    return (base or SimConfig()).replace(**_config_overrides(args))


def _load_sim(path, args):
    """Resume semantics: the checkpoint's saved config wins except for
    flags the user set (dt/G stored in a reference-JSON file included,
    set again below when given on the command line)."""
    from nbody3d_tpu_torch.engine import Simulation
    from nbody3d_tpu_torch.utils.checkpoint import peek_config

    sim = Simulation.load(path, _build_config(args, base=peek_config(path)), device=args.device)
    ov = _config_overrides(args)
    if "dt" in ov:
        sim.dt = ov["dt"]
    if "G" in ov:
        sim.G = ov["G"]
    return sim


def cmd_run(args) -> int:
    from nbody3d_tpu_torch.engine import Simulation

    if args.checkpoint:
        sim = _load_sim(args.checkpoint, args)
    else:
        sim = Simulation.from_preset(args.preset, _build_config(args), n=args.n, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    if args.metrics:
        sim.metrics_path = args.metrics
    return _run_loop(args, sim)


def _save_frame(args, sim, frame_idx: int) -> str:
    from nbody3d_tpu_torch.render.image import save_png

    path = os.path.join(args.outdir, f"frame_{frame_idx:06d}.png")
    save_png(path, sim.render_frame())
    return path


def _run_loop(args, sim) -> int:
    """Chunks of ``--log-every`` steps; after each, the log lines, the
    diagnostics, a checkpoint and a frame when their cadence is due, as
    ``nbody3d_tpu.cli`` does; ``final.npz`` at the end."""
    done = 0
    next_ckpt = args.checkpoint_every or 0
    next_frame = args.render_every or 0
    frame_idx = 0
    if args.render_every:
        _save_frame(args, sim, frame_idx)
        frame_idx += 1
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
        if args.checkpoint_every and done >= next_ckpt:
            path = os.path.join(args.outdir, f"ckpt_{sim.step_count:08d}.npz")
            sim.save(path)
            print(f"  checkpoint -> {path}", flush=True)
            next_ckpt += args.checkpoint_every
        if args.render_every and done >= next_frame:
            path = _save_frame(args, sim, frame_idx)
            print(f"  frame -> {path}", flush=True)
            frame_idx += 1
            next_frame += args.render_every
    sim.save(os.path.join(args.outdir, "final.npz"))
    return 0


def cmd_render(args) -> int:
    from nbody3d_tpu_torch.render.image import save_png

    sim = _load_sim(args.checkpoint, args)
    img = sim.render_frame(width=args.width, height=args.height,
                           color_mode=args.color_mode, resolve=args.resolve)
    save_png(args.output, img)
    print(f"wrote {args.output}")
    return 0


def cmd_convert(args) -> int:
    from nbody3d_tpu_torch.utils.checkpoint import check_format

    check_format(args.output)  # before any work
    sim = _load_sim(args.input, args)
    sim.save(args.output)
    print(f"{args.input} -> {args.output} (N={sim.n_real}, step={sim.step_count})")
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
    p.add_argument("--checkpoint", default=None, help="resume from a .npz/.json checkpoint instead of a preset")
    p.add_argument("--n", type=int, default=None, help="body count override")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="write <outdir>/ckpt_<step>.npz every K steps (0 = never)")
    p.add_argument("--render-every", type=int, default=0,
                   help="write <outdir>/frame_<i>.png at the start and every K steps (0 = never)")
    p.add_argument("--diagnostics", action="store_true")
    p.add_argument("--outdir", default="out", help="frames, checkpoints and final.npz go here")
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

    p = sub.add_parser("render", help="render a checkpoint to PNG")
    p.add_argument("checkpoint")
    p.add_argument("-o", "--output", default="frame.png")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--color-mode", default="magnitude", choices=["magnitude", "direction"],
                   help="velocity magnitude colormap (nbody3d.js:380) or direction (:381)")
    p.add_argument("--resolve", default="auto", choices=["auto", "host", "device"],
                   help="auto = on the device (the splat_resolve kernel on a card); host = the "
                        "f64 host frame of the JAX package's default; device = the quantized "
                        "resolve, not ported")
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("convert", help="convert checkpoint formats (.json <-> .npz)")
    p.add_argument("input")
    p.add_argument("output")
    _add_common(p)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("info", help="torch / CUDA device report")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
