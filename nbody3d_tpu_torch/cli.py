"""Command-line interface of the PyTorch port.

- ``info``     torch, CUDA and device report.
- ``run``      simulate a preset or a checkpoint with periodic logging,
               diagnostics, checkpoints and frame dumps.
- ``bench``    throughput benchmark printing one JSON line.
- ``render``   render a checkpoint to PNG.
- ``animate``  an orbiting-camera frame sequence of a checkpoint, and an
               APNG/GIF (or, with ffmpeg, MP4/WebM) of it.
- ``serve``    the live interactive viewer over HTTP (MJPEG + controls).
- ``convert``  convert checkpoints between reference JSON, native npz and
               a checkpoint directory (any path with neither suffix).
- ``analyze``  physics report of a checkpoint: COM frame, conservation
               norms, Lagrangian radii, profiles, virial ratio, and with
               ``--fof`` the friends-of-friends catalog, with
               ``--power-spectrum GRID`` the mass P(k).

Flags follow ``nbody3d_tpu.cli`` where they apply; ``--device`` names the
device (default ``cuda``, which raises where there is no card).  dt and G
take linear values (``--dt 1e-4``) or log-slider values (``--log-dt -4``).
Resuming a checkpoint keeps its saved config except for the flags given.

Several devices (``run``, ``bench``, ``serve``): ``--devices N``
starts N local ranks, one process a device (NCCL on ``--device cuda``, one
card a rank; gloo on ``--device cpu``), and shards the bodies over them:
the direct force with ``--strategy ring|ringsym|gather|2d``, ``--method
pm`` (one grid sum a step) and ``--method p3m`` (the splitter exchange into
the Morton order and the halo ring) whatever the strategy, isolated or
``--boundary periodic`` (``--interlace``, ``--cosmology eds|lcdm``), on
the 2-D mesh of ``--strategy 2d`` flattened row-major (``parallel/``).
``--distributed`` joins a process group that ``torchrun`` started
(``init_method="env://"``, device ``cuda:$LOCAL_RANK``) and shards over all
of its ranks.  Only rank 0 prints and writes files.  A sharded run's
frames render where the rows live (``render/sharded.py``: each rank's
resolve, one ``amin`` of the frames), so ``run --render-every`` writes rank
0's frames and ``serve`` serves the mesh: rank 0 owns the HTTP server and
the loop, the other ranks follow its op records (``viewer.py``).
``animate`` loads its checkpoint on one device, as the JAX package's does,
so ``--devices`` leaves it there and ``--distributed`` is refused.

    python -m nbody3d_tpu_torch.cli run --preset two-galaxy --steps 2000 --diagnostics \
        --checkpoint-every 500 --render-every 500 --outdir out
    python -m nbody3d_tpu_torch.cli run --method p3m --preset two-galaxy --steps 200 --diagnostics
    python -m nbody3d_tpu_torch.cli run --preset uniform-box --method p3m --boundary periodic \
        --box-size 10 --interlace --steps 100 --diagnostics
    python -m nbody3d_tpu_torch.cli run --preset cosmo --n 262144 --cosmology eds --method p3m \
        --boundary periodic --box-size 10 --steps 100 --analyze-every 50
    python -m nbody3d_tpu_torch.cli analyze out/final.npz --fof --power-spectrum 64 --json
    python -m nbody3d_tpu_torch.cli render out/final.npz -o frame.png
    python -m nbody3d_tpu_torch.cli animate out/final.npz --frames 120 --video orbit.gif
    python -m nbody3d_tpu_torch.cli serve --preset two-galaxy --port 8000
    python -m nbody3d_tpu_torch.cli run --steps 200 --trace trace_dir
    python -m nbody3d_tpu_torch.cli convert out/final.npz final.json
    python -m nbody3d_tpu_torch.cli convert out/final.npz ckpt_dir
    python -m nbody3d_tpu_torch.cli run --devices 4 --device cpu --backend jnp --n 2048 --steps 20
    python -m nbody3d_tpu_torch.cli run --devices 4 --device cpu --method p3m --pm-grid 32 --n 4096 --steps 10
    python -m nbody3d_tpu_torch.cli run --devices 4 --device cpu --preset cosmo --n 4096 --cosmology eds \
        --method pm --boundary periodic --box-size 10 --pm-grid 16 --steps 10
    python -m nbody3d_tpu_torch.cli serve --devices 2 --device cpu --preset plummer --n 4096 --port 8000
    torchrun --nproc-per-node 4 -m nbody3d_tpu_torch.cli serve --distributed --preset two-galaxy --port 8000
    torchrun --nproc-per-node 8 -m nbody3d_tpu_torch.cli run --distributed --method p3m --boundary periodic \
        --preset uniform-box --n 2097152 --box-size 10 --interlace --steps 100
    torchrun --nproc-per-node 8 -m nbody3d_tpu_torch.cli run --distributed --strategy ringsym \
        --force-mode sym --preset uniform-sphere --n 262144 --steps 100
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
    p.add_argument("--force-mode", default=None, choices=["exact", "fast", "sym"],
                   help="exact = f32 all pairs; fast = bf16 weights on the tensor cores; "
                        "sym = Newton-3 pairs")
    p.add_argument("--method", default=None, choices=["direct", "pm", "p3m"],
                   help="force algorithm: direct = all pairs; pm = particle mesh (CIC + FFT); "
                        "p3m = PM + exact short-range correction (~1e-3 of direct)")
    p.add_argument("--pm-grid", type=int, default=None, help="PM/P3M mesh cells per axis (default 128)")
    p.add_argument("--p3m-nbr-k", type=int, default=None,
                   help="P3M short-range neighbour-tile budget (default 32)")
    p.add_argument("--boundary", default=None, choices=["isolated", "periodic"],
                   help="isolated = open space; periodic = the box [0, box-size)^3 with Ewald-class "
                        "gravity through the mesh solvers (needs --method pm|p3m and --box-size)")
    p.add_argument("--box-size", type=float, default=None, help="periodic box edge L (with --boundary periodic)")
    p.add_argument("--interlace", dest="mesh_interlace", default=None, action="store_true",
                   help="periodic box: average two mesh legs on grids offset by half a cell")
    p.add_argument("--no-interlace", dest="mesh_interlace", action="store_false", help="disable --interlace")
    p.add_argument("--cosmology", default=None, choices=["none", "eds", "lcdm"],
                   help="expanding background: eds = comoving coordinates on an Einstein-de Sitter universe, "
                        "lcdm = flat ΛCDM (needs --boundary periodic and --method pm|p3m; vel stores "
                        "w = a^2 dx/dt, dt is cosmic time: ops/expansion.py)")
    p.add_argument("--omega-lambda", type=float, default=None,
                   help="Ω_Λ at the start epoch a=1 for --cosmology lcdm (flat: Ω_m = 1 - Ω_Λ; default 0.7)")
    p.add_argument("--morton-every", type=int, default=None,
                   help="re-sort bodies along the Z-order curve every N steps (0 = never)")
    p.add_argument("--integrator", default=None, choices=["verlet", "euler", "yoshida4"])
    p.add_argument("--block-target", type=int, default=None,
                   help="sym tile cap (the tile is at most 256 bodies)")
    p.add_argument("--block-source", type=int, default=None,
                   help="accepted for interchange with nbody3d_tpu.cli and kept in the saved config; "
                        "it has no effect on the port's kernels")
    p.add_argument("--devices", type=int, default=1,
                   help=">1 shards the bodies over this many local ranks, one process a device "
                        "(run, bench, serve; animate loads on one device)")
    p.add_argument("--strategy", default=None, choices=["ring", "ringsym", "gather", "2d"],
                   help="the sharded force's exchange: ring (sources round the ring), ringsym (Newton-3 "
                        "half ring), gather (all-gather the sources), 2d (the grid decomposition)")
    p.add_argument("--distributed", action="store_true",
                   help="join the process group torchrun started (env://, cuda:$LOCAL_RANK) and shard "
                        "over all of its ranks")


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
        ("method", args.method),
        ("pm_grid", args.pm_grid),
        ("p3m_nbr_k", args.p3m_nbr_k),
        ("boundary", args.boundary),
        ("box_size", args.box_size),
        ("mesh_interlace", args.mesh_interlace),
        ("cosmology", args.cosmology),
        ("omega_lambda", args.omega_lambda),
        ("morton_every", args.morton_every),
        ("integrator", args.integrator),
        ("block_target", args.block_target),
        ("block_source", args.block_source),
        ("strategy", args.strategy),
    ]:
        if arg is not None:
            ov[field] = arg
    return ov


def _build_config(args, base=None):
    """Fresh runs: defaults + explicit flags.  Resume: the checkpoint's
    saved config + explicit flags only (pass ``base``)."""
    from nbody3d_tpu_torch.config import SimConfig

    config = (base or SimConfig()).replace(**_config_overrides(args))
    if args.omega_lambda is not None and config.cosmology != "lcdm":
        # Ω_Λ parameterizes the flat ΛCDM background alone.
        raise SystemExit(
            f"--omega-lambda only applies to --cosmology lcdm (resolved cosmology is {config.cosmology!r})"
        )
    return config


def _resolved_strategy(args) -> str:
    """The strategy in effect: the flag, else a resumed checkpoint's saved
    config, else the default.  The mesh's shape follows it (2d needs two
    axes)."""
    if args.strategy is not None:
        return args.strategy
    if getattr(args, "checkpoint", None):
        from nbody3d_tpu_torch.utils.checkpoint import peek_config

        saved = peek_config(args.checkpoint)
        if saved is not None:
            return saved.strategy
    from nbody3d_tpu_torch.config import SimConfig

    return SimConfig().strategy


def _build_mesh(args):
    """The mesh of this rank, or None on one device: with
    ``--distributed`` over the ranks torchrun started, in a rank that
    :func:`main` spawned for ``--devices N`` over those.  Ranks other than
    0 print nothing."""
    import torch.distributed as dist

    if args.distributed:
        import torch

        if torch.device(args.device).type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group("nccl", init_method="env://")
        else:
            dist.init_process_group("gloo", init_method="env://")
    elif not dist.is_initialized():
        return None
    from nbody3d_tpu_torch.parallel.mesh import default_mesh, grid_mesh

    n = args.devices if args.devices > 1 else None
    mesh = grid_mesh(n_devices=n) if _resolved_strategy(args) == "2d" else default_mesh(n)
    if mesh.rank != 0:
        sys.stdout = open(os.devnull, "w")
    return mesh


def _primary(sim) -> bool:
    """Whether this process writes files: one device, or rank 0."""
    return sim.mesh is None or sim.mesh.rank == 0


def _load_sim(path, args, mesh=None):
    """Resume semantics: the checkpoint's saved config wins except for
    flags the user set (dt/G stored in a reference-JSON file included,
    set again below when given on the command line)."""
    from nbody3d_tpu_torch.engine import Simulation
    from nbody3d_tpu_torch.utils.checkpoint import peek_config

    config = _build_config(args, base=peek_config(path))
    sim = Simulation.load(path, config, device=None if mesh else args.device, mesh=mesh)
    ov = _config_overrides(args)
    if "dt" in ov:
        sim.dt = ov["dt"]
    if "G" in ov:
        sim.G = ov["G"]
    return sim


def cmd_run(args) -> int:
    from nbody3d_tpu_torch.engine import Simulation

    mesh = _build_mesh(args)
    if args.checkpoint:
        sim = _load_sim(args.checkpoint, args, mesh)
    else:
        config = _build_config(args)
        kw = {}
        if args.preset == "reference-random":
            # The reference's run-config controls (index.html:68-75).
            kw = dict(num_galaxies=args.num_galaxies, min_bodies=args.min_bodies,
                      max_bodies=args.max_bodies)
        elif args.preset in ("uniform-box", "cosmo") and config.box_size > 0:
            kw = dict(box_size=config.box_size)
        if args.preset == "cosmo" and config.cosmology in ("eds", "lcdm"):
            # The expanding box's growing mode (w = f_i H_i psi), not the
            # static Jeans mode: the preset follows the configured physics.
            kw["velocity"] = config.cosmology
            if config.cosmology == "lcdm":
                kw["omega_lambda"] = config.omega_lambda
        if args.preset == "cosmo" and args.spectrum:
            kw["spectrum"] = args.spectrum
            if args.box_mpc is not None:
                kw["box_mpc"] = args.box_mpc
        sim = Simulation.from_preset(args.preset, config, n=args.n, device=None if mesh else args.device,
                                     mesh=mesh, **kw)
    if _primary(sim):
        os.makedirs(args.outdir, exist_ok=True)
        sim.metrics_path = args.metrics
    return _run_loop(args, sim)


def _save_frame(args, sim, frame_idx: int) -> str:
    """A frame of the state, on every rank of a mesh (collective); one
    device or rank 0 writes it."""
    from nbody3d_tpu_torch.render.image import save_png

    path = os.path.join(args.outdir, f"frame_{frame_idx:06d}.png")
    img = sim.render_frame()
    if _primary(sim):
        save_png(path, img)
    return path


def _run_loop(args, sim) -> int:
    """The run, inside a ``torch.profiler`` trace with ``--trace DIR``."""
    from nbody3d_tpu_torch.utils.profiling import device_trace

    trace = args.trace if _primary(sim) else None
    with device_trace(trace):
        _run_chunks(args, sim)
    if trace:
        print(f"  trace -> {os.path.join(trace, 'trace.json')}", flush=True)
    sim.save(os.path.join(args.outdir, "final.npz"))
    return 0


def _run_chunks(args, sim) -> None:
    """Chunks of ``--log-every`` steps; after each, the log lines, the
    diagnostics, a checkpoint, an analysis record and a frame when their
    cadence is due, as ``nbody3d_tpu.cli`` does."""
    done = 0
    next_ckpt = args.checkpoint_every or 0
    next_analysis = args.analyze_every or 0
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
        if args.analyze_every and done >= next_analysis:
            _append_analysis(args, sim)
            next_analysis += args.analyze_every
        if args.render_every and done >= next_frame:
            path = _save_frame(args, sim, frame_idx)
            print(f"  frame -> {path}", flush=True)
            frame_idx += 1
            next_frame += args.render_every


def _append_analysis(args, sim) -> None:
    """``--analyze-every``: the O(N log N) report (no potential) of the real
    rows, on their device, appended to ``<outdir>/analysis.jsonl`` (a
    sharded state gathered first, on every rank)."""
    from nbody3d_tpu_torch import analysis

    n = sim.n_real
    state = sim.global_state()
    if not _primary(sim):
        return
    s = analysis.summary(state.pos_mass[:n].detach(), state.vel[:n].detach(), sim.G,
                         eps2=sim.config.eps2, nbins=16, potential=False)
    s["step"] = sim.step_count
    with open(os.path.join(args.outdir, "analysis.jsonl"), "a") as f:
        f.write(json.dumps(s) + "\n")
    lr = s["lagrangian_radii"]
    print(f"  r10={lr['r10']:.4g} r50={lr['r50']:.4g} r90={lr['r90']:.4g} "
          f"sigma_c={s['velocity_dispersion'][0]:.4g}", flush=True)


def cmd_render(args) -> int:
    from nbody3d_tpu_torch.render.image import save_png

    sim = _load_sim(args.checkpoint, args)
    img = sim.render_frame(width=args.width, height=args.height,
                           color_mode=args.color_mode, resolve=args.resolve)
    save_png(args.output, img)
    print(f"wrote {args.output}")
    return 0


def cmd_animate(args) -> int:
    """Frames of a checkpoint under a scripted orbiting camera (the headless
    stand-in for the reference's orbit, camera.js:143-168), the physics
    advancing between frames with ``--steps-per-frame``; with ``--video`` an
    APNG, GIF or (through ffmpeg) MP4/WebM of them."""
    import math

    from nbody3d_tpu_torch.render.image import save_animation, save_png
    from nbody3d_tpu_torch.utils.camera import ROT_SPEED, Camera

    if args.distributed:
        raise ValueError("animate loads its checkpoint on one device, as the JAX package's does: --distributed "
                         "would join a process group that no rank of it uses")
    sim = _load_sim(args.checkpoint, args)
    cam = Camera(target=sim.camera_target)
    os.makedirs(args.outdir, exist_ok=True)
    step_px = math.radians(args.orbit_degrees) / max(args.frames, 1) / ROT_SPEED
    paths = []
    for i in range(args.frames):
        path = os.path.join(args.outdir, f"frame_{i:06d}.png")
        save_png(path, sim.render_frame(camera=cam, width=args.width, height=args.height))
        paths.append(path)
        cam.orbit(step_px, 0.0)
        if args.steps_per_frame:
            sim.run(args.steps_per_frame, chunk=args.steps_per_frame)
    print(f"wrote {args.frames} frames to {args.outdir}")
    if args.video:
        save_animation(paths, args.video, fps=args.fps)
        print(f"wrote {args.video}")
    return 0


# serve --resolve: the JAX package's names map to the port's resolves.
SERVE_RESOLVES = {"auto": "auto", "host": "host", "device": "device", "pallas": "auto", "native": "host",
                  "numpy": "host"}


def cmd_serve(args) -> int:
    """The live interactive viewer (``viewer.py``): the simulation advances
    on the device while the server streams frames and takes the controls.
    On a mesh rank 0 serves and the other ranks follow its op records; a
    Ctrl-C reaches every rank of the terminal's process group, and only
    rank 0 acts on it: its stop ends the followers, so every rank exits 0."""
    import signal

    from nbody3d_tpu_torch.engine import Simulation
    from nbody3d_tpu_torch.viewer import LiveViewer, control_group, follow

    mesh = _build_mesh(args)
    if args.checkpoint:
        sim = _load_sim(args.checkpoint, args, mesh)
    else:
        sim = Simulation.from_preset(args.preset, _build_config(args), n=args.n,
                                     device=None if mesh else args.device, mesh=mesh)
    side = None
    if mesh is not None:
        side = control_group()
        if mesh.rank != 0:
            signal.signal(signal.SIGINT, signal.SIG_IGN)
            follow(sim, side)
            return 0
        # The spawning parent ignores SIGINT, and its ranks inherit that.
        signal.signal(signal.SIGINT, signal.default_int_handler)
    viewer = LiveViewer(sim, width=args.width, height=args.height, steps_per_frame=args.steps_per_frame,
                        diagnostics_every=args.diagnostics_every, resolve=SERVE_RESOLVES[args.resolve], side=side)
    viewer.serve_forever(args.host, args.port)
    return 0


def cmd_convert(args) -> int:
    sim = _load_sim(args.input, args)
    sim.save(args.output)
    print(f"{args.input} -> {args.output} (N={sim.n_real}, step={sim.step_count})")
    return 0


def cmd_analyze(args) -> int:
    """Physics report of a checkpoint (``nbody3d_tpu_torch.analysis``): the
    statistics and P(k) on the state's device, FoF on the host (streamed:
    10 bytes a body from the device)."""
    from nbody3d_tpu_torch import analysis

    sim = _load_sim(args.checkpoint, args)
    n = sim.n_real
    pos_mass, vel = sim.state.pos_mass[:n].detach(), sim.state.vel[:n].detach()
    stream = args.fof_stream == "always" or (args.fof_stream == "auto" and n >= (1 << 22))
    pe = args.pe == "exact" or (args.pe == "auto" and n <= 131072)
    s = analysis.summary(pos_mass, vel, sim.config.G, eps2=sim.config.eps2, nbins=args.bins, potential=pe,
                         pe_chunk=args.pe_chunk)
    s["step"] = sim.step_count
    box = sim.config.box_size if sim.config.boundary == "periodic" else None
    if args.fof:
        if stream:
            labels, ll, pm_cat = analysis.fof_groups_streamed(pos_mass, args.linking_length or None, box_size=box)
            vel_cat = None  # vcom left out: the velocities stay on the device
        else:
            pm_cat, vel_cat = pos_mass.cpu().numpy(), vel.cpu().numpy()
            labels, ll = analysis.fof_groups(pm_cat, args.linking_length or None, box_size=box)
        cat = analysis.group_catalog(pm_cat, vel_cat, labels, min_size=args.fof_min_size, box_size=box)
        s["fof"] = {
            "linking_length": ll,
            "min_size": args.fof_min_size,
            "streamed": bool(stream),
            "n_groups": len(cat),
            "grouped_fraction": float(sum(g["n"] for g in cat) / max(n, 1)),
            "groups": cat[:50],
        }
    if args.power_spectrum:
        k, p, cnt = analysis.power_spectrum(pos_mass, grid=args.power_spectrum, box_size=box)
        k, p, cnt = (t.tolist() for t in _to_host(k, p, cnt))
        if box is not None:
            vol = float(box) ** 3
        else:
            # the autobox's measurement box: Nyquist pins grid/L
            vol = (args.power_spectrum * 3.14159265 / float(k[-1] + k[0])) ** 3
        s["power_spectrum"] = {"k": k, "P": p, "n_modes": cnt,
                               "shot_noise": float(analysis.shot_noise(pos_mass, vol))}
    if args.ps_out:
        if "power_spectrum" not in s:
            print("--ps-out requires --power-spectrum GRID", file=sys.stderr)
            return 2
        ps = s["power_spectrum"]
        with open(args.ps_out, "w") as f:
            f.write("k,P,n_modes\n")
            for k_i, p_i, c_i in zip(ps["k"], ps["P"], ps["n_modes"]):
                f.write(f"{k_i:.8g},{p_i:.8g},{c_i:.0f}\n")
        print(f"wrote {args.ps_out}")
    if args.profile:
        edges = s["density_profile"]["edges"]
        with open(args.profile, "w") as f:
            f.write("r_lo,r_hi,rho,count,sigma_v\n")
            for i in range(args.bins):
                f.write(f"{edges[i]:.8g},{edges[i + 1]:.8g},{s['density_profile']['rho'][i]:.8g},"
                        f"{s['density_profile']['count'][i]:.0f},{s['velocity_dispersion'][i]:.8g}\n")
        print(f"wrote {args.profile}")
    if args.json:
        print(json.dumps(s))
        return 0
    print(f"step               {sim.step_count}")
    print(analysis.format_report(s))
    if "fof" in s:
        f = s["fof"]
        print(f"fof groups         {f['n_groups']} (>= {f['min_size']} bodies, b={f['linking_length']:.4g}, "
              f"{100 * f['grouped_fraction']:.1f}% of mass-carrying bodies)")
        for g in f["groups"][:5]:
            com = " ".join(f"{x:.4g}" for x in g["com"])
            print(f"  n={g['n']:<8,} mass={g['mass']:.4g}  com=[{com}]  rmax={g['rmax']:.4g}")
    if "power_spectrum" in s:
        ps = s["power_spectrum"]
        occupied = [(k_i, p_i) for k_i, p_i, c_i in zip(ps["k"], ps["P"], ps["n_modes"]) if c_i > 0]
        (lo_k, lo_p), (hi_k, hi_p) = occupied[0], occupied[-1]
        print(f"power spectrum     P({lo_k:.4g})={lo_p:.4g}  P({hi_k:.4g})={hi_p:.4g}  "
              f"shot noise {ps['shot_noise']:.4g}")
    if not pe:
        print("(potential/virial skipped at this N; --pe exact to force)")
    return 0


def _to_host(*tensors):
    """Host copies of device tensors, in one device-to-host copy."""
    import torch

    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu()
    return torch.split(flat, [t.numel() for t in tensors])


def cmd_bench(args) -> int:
    from nbody3d_tpu_torch.engine import Simulation

    if args.steps % args.chunk != 0:
        raise SystemExit(
            f"bench: --steps ({args.steps}) must be a multiple of --chunk ({args.chunk})"
        )
    config = _build_config(args)
    mesh = _build_mesh(args)
    sim = Simulation.from_preset(args.preset, config, n=args.n, device=None if mesh else args.device, mesh=mesh)
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
        "method": config.method,
        "device": str(sim.device),
        "device_name": _device_name(sim.device),
        "devices": sim.mesh.size if sim.mesh is not None else 1,
        "strategy": config.strategy if sim.mesh is not None else None,
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

    from nbody3d_tpu_torch.parallel.mesh import mesh_info

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info = {
        **mesh_info(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
        # What --devices/--distributed shards: direct by strategy, the mesh methods whatever it is, and
        # the frames of run --render-every and serve by resolve.
        "sharded": {"direct": ["ring", "ringsym", "gather", "2d"], "pm": "any mesh", "p3m": "any mesh",
                    "render": {"auto": "each rank's rows, one amin of the frames", "host": "gathered rows",
                               "device": "gathered rows"}},
    }
    print(json.dumps(info, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="nbody3d-tpu-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a simulation")
    p.add_argument("--preset", default="two-galaxy")
    p.add_argument("--checkpoint", default=None, help="resume from a .npz/.json checkpoint or a checkpoint directory instead of a preset")
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
    p.add_argument("--num-galaxies", type=int, default=2, help="reference-random: galaxies")
    p.add_argument("--min-bodies", type=int, default=20000, help="reference-random: least bodies a galaxy")
    p.add_argument("--max-bodies", type=int, default=20000, help="reference-random: most bodies a galaxy")
    p.add_argument("--analyze-every", type=int, default=0,
                   help="append a structural-analysis record (Lagrangian radii, central dispersion: O(N log N) "
                        "terms only) to <outdir>/analysis.jsonl every K steps")
    p.add_argument("--spectrum", default=None, choices=["power-law", "eh98"],
                   help="cosmo preset P(k): power-law (default) or the Eisenstein-Hu 1998 flat-ΛCDM transfer "
                        "function (Ωm = 1 - omega_lambda; box mapped to --box-mpc h⁻¹Mpc of comoving space)")
    p.add_argument("--box-mpc", type=float, default=None,
                   help="physical size the cosmo box represents for --spectrum eh98 (default 100 h⁻¹Mpc)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run (host ops and CUDA kernels) to DIR/trace.json")
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
                        "resolve (16-bit depth, rgb565; only the framebuffer and the splats of 2 px "
                        "and more leave the device)")
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("animate", help="orbiting-camera frame sequence from a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--orbit-degrees", type=float, default=360.0)
    p.add_argument("--steps-per-frame", type=int, default=0,
                   help="advance the simulation between frames (0 = camera only)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--outdir", default="frames")
    p.add_argument("--video", default=None,
                   help="also assemble the frames into this file: .png/.apng (APNG) and .gif are written "
                        "by the port; .mp4/.webm need ffmpeg on PATH")
    p.add_argument("--fps", type=float, default=30.0)
    _add_common(p)
    p.set_defaults(fn=cmd_animate)

    p = sub.add_parser("serve", help="live interactive viewer over HTTP (MJPEG + controls)")
    p.add_argument("--checkpoint", default=None, help="resume from a checkpoint")
    p.add_argument("--preset", default="two-galaxy")
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000, help="0 = any free port (printed at start)")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--steps-per-frame", type=int, default=20)
    p.add_argument("--diagnostics-every", type=int, default=0,
                   help="compute total energy every this many frames (0 = off)")
    p.add_argument("--resolve", default="auto", choices=list(SERVE_RESOLVES),
                   help="the frame's resolve, as render's: auto (the splat_resolve kernel), host (the f64 "
                        "host frame) or device (the quantized scatter); the JAX package's names map as "
                        "pallas -> auto, native -> host, numpy -> host")
    _add_common(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("analyze", help="physics analysis report of a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("--bins", type=int, default=64, help="radial bins for the density/dispersion profiles")
    p.add_argument("--pe", default="auto", choices=["auto", "exact", "skip"],
                   help="O(N^2) potential/virial terms: auto skips above 128k bodies")
    p.add_argument("--pe-chunk", type=int, default=1024)
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--profile", default="", help="also write the radial profiles as CSV to this path")
    p.add_argument("--fof", action="store_true",
                   help="friends-of-friends group catalog (C union-find core on the host; periodic runs link "
                        "across the torus seam)")
    p.add_argument("--linking-length", type=float, default=0.0,
                   help="FOF linking length (default 0 = 0.2x the mean interparticle separation)")
    p.add_argument("--fof-min-size", type=int, default=20, help="drop FOF groups below this many members")
    p.add_argument("--fof-stream", default="auto", choices=["auto", "always", "never"],
                   help="stream device-quantized positions to the host FOF (10 B/body instead of 16; pair "
                        "decisions within ~0.1%% of the linking length may flip: analysis.quantize_for_fof); "
                        "auto = on from 4M bodies; vcom is left out of the catalog")
    p.add_argument("--power-spectrum", type=int, default=0, metavar="GRID",
                   help="measure the mass density power spectrum P(k) on a GRID^3 CIC mesh (periodic runs use "
                        "the torus box; isolated runs the massive bodies' bounding cube)")
    p.add_argument("--ps-out", default="", help="write the P(k) table as CSV to this path")
    _add_common(p)
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("convert", help="convert checkpoint formats (.json, .npz, a directory)")
    p.add_argument("input")
    p.add_argument("output")
    _add_common(p)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("info", help="torch / CUDA device report")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    if args.fn in MESH_COMMANDS and args.devices > 1 and not args.distributed:
        import signal

        import torch
        import torch.distributed as dist

        if not dist.is_initialized():
            from nbody3d_tpu_torch.parallel.launch import spawn

            kind = torch.device(args.device).type
            threads = max(1, torch.get_num_threads() // args.devices)
            # A served mesh stops from its rank 0 (cmd_serve), not by the
            # parent stopping the ranks.
            old = signal.signal(signal.SIGINT, signal.SIG_IGN) if args.fn is cmd_serve else None
            try:
                spawn(_rank_main, args.devices, args, device=kind, timeout=None, threads=threads)
            finally:
                if old is not None:
                    signal.signal(signal.SIGINT, old)
            return 0
    return args.fn(args)


# The subcommands that run a simulation on a mesh with --devices/--distributed.
MESH_COMMANDS = (cmd_run, cmd_bench, cmd_serve)


def _rank_main(rank: int, world: int, args) -> int:
    """One of the ``--devices N`` ranks: the subcommand on the mesh."""
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
