#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nbody3d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                 # everything below, one card
    python3 chip_smoke.py --kernels-only  # build + small-shape checks (1-3, 7a)
    python3 chip_smoke.py --outdir DIR    # keep phase 7b's frames and checkpoints

Phases, one line each (a failed check prints FAIL and the run exits 1):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: nvcc builds the nine kernels from ``nbody3d_tpu_torch/csrc``,
   one nvcc process per source, all started together.
3. kernels: each kernel against its plain PyTorch twin on the card at
   N = 8,192 (nt even), 7,936 (nt odd) and 512 (nt = 2), padded rows
   included (forward: accelerations and the step; VJP: x̄, m̄ and Ḡ); the
   VJP accuracy gate of ``benchmarks/grad_bench.py`` (median x̄ relative
   error <= 1e-4 against an f64 numpy oracle, uniform-sphere N = 4,096,
   both schedules); then each kernel's time beside its twin's at the
   main-path shapes (exact: two-galaxy N = 40,002; sym and the VJPs:
   uniform-sphere N = 262,144, tile 256), ``sym_epilogue`` and
   ``vjp_combine`` with L2 warm and with L2 flushed, at full width the
   sym VJP against the full-grid VJP and both against f64 on 256 rows, and
   the VJP stages at the exact gradient path's shape and data (two-galaxy,
   nt = 157) against their twins, the full grid and f64.
4. exact main path: ``Simulation.from_preset("two-galaxy", SimConfig())``,
   200 steps in chunks of 50, energy drift <= 1e-3 and momentum error
   <= 1e-5 of sum |m v|.
5. sym main path: uniform-sphere N = 262,144, ``force_mode="sym"``,
   ``morton_every=64``; 1 warm and 2 timed chunks of 50 steps; energy
   drift <= 1e-4 * max(steps, 140) / 140, momentum error <= 1e-5.
6. gradients, ``torch.autograd`` through a rollout, forward and gradient
   ms/step: (a) the sym gradient path, ``make_step_fn`` at uniform-sphere
   N = 262,144 (5 steps, loss sum |x|^2 / n, gradient by v0, as
   grad_bench); (b) the exact gradient path at two-galaxy N = 40,002
   (3 steps); (c) the full-grid VJP route (``make_diff_accel(sym=False)``,
   on no main path) on (b)'s rollout, against (b)'s gradient; (d) at
   N = 4,096 the kernel routes' rollout gradient (sym, exact, exact with
   the full-grid VJP) against the ``backend="jnp"`` route's, rtol 2e-3,
   by v0 and by dt and G.
7. the render + checkpoint path: (a, after phase 3) ``splat_resolve``
   against its plain twin, bit for bit, on the scenes of
   tests/test_render.py and the two-galaxy frame; (b) the reference's
   default run through ``cli.main``: two-galaxy, 200 steps, a frame every
   50 and a checkpoint every 100, energy drift <= 1e-3 and momentum error
   <= 1e-5, then ``render`` of ``final.npz`` equal to the run's last frame
   and ``convert`` npz -> JSON -> npz bit-equal; (c, last) the kernel, its
   twin and ``scatter_reduce_`` over the expanded pairs (the library
   yardstick) at the run's frame and at N = 500,010 1920x1080
   (benchmarks/render_bench.py's scene), frame, PNG and checkpoint times.

Phases 4, 5, 6a, 6b and 7b (the main paths) and 6c and 6d each run with
the launch counts set to 0 just before and read just after; each must
launch every kernel it runs and no other, and the SM clock, power draw and
temperature are printed after each.  One profiled rollout of 6a and 6b
each and one profiled frame of 7b (device busy time, idle share, largest
kernels) follow their windows.  The line before the last is
``{"kernels": [...]}`` (launches summed over the main paths, ``vjp_full``'s
from 6c; ``bound_ms`` from this run's shapes and the operation counts in
each kernel's source note); the last is the ``{"ok": true, "device": ...}``
line.  Without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nbody3d_tpu_torch import SimConfig, Simulation, _build, cli
from nbody3d_tpu_torch.models.registry import make_preset
from nbody3d_tpu_torch.ops import cuda_force as cf
from nbody3d_tpu_torch.ops import force_vjp as fv
from nbody3d_tpu_torch.ops.integrate import integrate_state
from nbody3d_tpu_torch.ops.launch import KERNELS, launch, launch_counts, reset_launch_counts
from nbody3d_tpu_torch.ops.morton import morton_reorder
from nbody3d_tpu_torch.ops.step import GPU_TILE, PAD_GRANULE, make_step_fn
from nbody3d_tpu_torch.render import rasterize, resolve
from nbody3d_tpu_torch.render.image import read_png, save_png
from nbody3d_tpu_torch.state import SimState, init_state, pad_count
from nbody3d_tpu_torch.utils.camera import Camera

G, EPS2, DT = 1e-4, 1e-4, 1e-3
DT_MAIN = SimConfig().dt  # the main path's step, as grad_bench uses
SRC = "nbody3d_tpu_torch/csrc/"
PALLAS = "nbody3d_tpu/ops/pallas_force.py:"
VJP = "nbody3d_tpu/ops/force_vjp.py:"
REPLACES = {
    "force_exact": (SRC + "force_exact.cu", PALLAS + "263"),
    "sym_diag_prep": (SRC + "sym_diag_prep.cu", PALLAS + "770"),
    "sym_hops": (SRC + "sym_hops.cu", PALLAS + "582"),
    "sym_epilogue": (SRC + "sym_epilogue.cu", PALLAS + "1122"),
    "vjp_full": (SRC + "vjp_full.cu", VJP + "205"),
    "vjp_sym_diag": (SRC + "vjp_sym_diag.cu", VJP + "434"),
    "vjp_sym_hops": (SRC + "vjp_sym_hops.cu", VJP + "450"),
    "vjp_combine": (SRC + "vjp_combine.cu", VJP + "490"),
    "splat_resolve": (SRC + "splat_resolve.cu", "nbody3d_tpu/render/pallas_resolve.py:105"),
}

# Least time for a kernel's work (PERF.md "bound"): the larger of its FP32
# operations over the FP32 rate, its rsqrt count over the MUFU rate and its
# bytes (each input read once, each output written once) over HBM.  Rates
# of an H100 SXM at its 1.98 GHz boost clock: 132 SMs x 128 FP32 lanes x 2
# (an FMA is 2 FLOP) = 66.9 TFLOP/s (the published 67), 132 x 16 MUFU
# results a clock, 3.35 TB/s HBM3.  FP32 FLOP per pair (or per row for the
# O(N) kernels) are counted from each kernel's inner loop in csrc/ (source
# notes there); each pair kernel does one rsqrt a pair.
FP32_FLOPS = 132 * 128 * 2 * 1.98e9
MUFU_RATE = 132 * 16 * 1.98e9
HBM_BYTES = 3.35e12
FLOP = {
    "force_exact": 18, "sym_diag_prep": 18, "sym_hops": 25, "sym_epilogue": 33,
    "vjp_full": 53, "vjp_sym_diag": 53, "vjp_sym_hops": 61, "vjp_combine": 8,
}

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def bound(name: str, units: float, nbytes: float, rsqrts: float = 0.0) -> dict:
    """``bound_ms`` and ``bound_by`` of ``units`` pairs (rows for the O(N)
    kernels) of kernel ``name`` moving ``nbytes``."""
    ops_s = max(units * FLOP[name] / FP32_FLOPS, rsqrts / MUFU_RATE)
    bytes_s = nbytes / HBM_BYTES
    return {"bound_ms": max(ops_s, bytes_s) * 1e3, "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def hop_pairs(n: int, b: int) -> int:
    nt = n // b
    return nt * (nt - 1) // 2 * b * b


def _queue_ahead(reps: int) -> None:
    """Hold the stream in a spin kernel while the host enqueues ``reps``
    launches, so that the events time the device and not the host's
    launch rate (a wrapper call costs some 20-40 us of Python)."""
    torch.cuda._sleep(max(20_000_000, reps * 400_000))  # cycles, ~10 ms at 1.98 GHz


def cuda_ms_cold(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn()`` in ms with the L2 flushed before each
    launch (``flush``, larger than the L2, is written in full outside the
    timed events; its dirty lines are in L2 when ``fn`` starts)."""
    fn()
    torch.cuda.synchronize()
    _queue_ahead(reps)
    events = []
    for _ in range(reps):
        flush.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def host_ms(fn) -> float:
    """One call of ``fn()`` on the host clock, synchronised, in ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``
    back-to-back launches (L2 warm: the launches reuse one set of tensors)."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _queue_ahead(reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phases
def nvidia_smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` of card 0, one CSV line."""
    return subprocess.run(
        ["nvidia-smi", "--id=0", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def print_clocks(after: str) -> None:
    print(f"  clocks after {after}: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')} "
          "(SM MHz, W, C)", flush=True)


def phase_device() -> torch.device:
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"python {sys.version.split()[0]} | count {torch.cuda.device_count()}",
        flush=True,
    )
    return torch.device("cuda", 0)


def phase_build() -> None:
    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    _build.load_library()
    print(
        f"[2 build] nvcc {nvcc_s:.1f} s, build+load {time.perf_counter() - t0:.1f} s -> "
        f"{path.relative_to(_build.BUILD_ROOT.parent.parent)}",
        flush=True,
    )
    for line in _build.build_log().splitlines():
        if "Used" in line or "Function properties" in line:
            print(f"  ptxas: {line.strip()}")


def _inputs(rng, n_pad: int, n_real: int, dev):
    pm = np.concatenate(
        [rng.normal(scale=2.0, size=(n_pad, 3)), rng.uniform(10, 50, (n_pad, 1))], axis=1
    ).astype(np.float32)
    pm[n_real:] = 0.0
    vel = np.concatenate([rng.normal(size=(n_pad, 3)) * 0.1, np.zeros((n_pad, 1))], axis=1)
    aold = np.concatenate([rng.normal(size=(n_pad, 3)), np.zeros((n_pad, 1))], axis=1)
    vel[n_real:] = 0.0
    aold[n_real:] = 0.0
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (pm, vel, aold))


def phase_kernel_checks(dev) -> None:
    """Kernels vs their plain twins on the same inputs, all rows."""
    print("[3 kernels] kernel vs plain twin, small shapes", flush=True)
    rng = np.random.default_rng(0)
    for n_pad, b, n_real in [(8192, 256, 8000), (7936, 256, 7900), (512, 256, 500)]:
        nt = n_pad // b
        pm, vel, aold = _inputs(rng, n_pad, n_real, dev)
        ex = cf.force_exact(pm, pm, G, EPS2)
        ex_p = cf.force_exact_plain(pm, pm, G, EPS2)
        torch.cuda.synchronize()
        check(rel_err(ex, ex_p) < 1e-5,
              f"N={n_pad} nt={nt}: force_exact vs plain max-abs/scale {rel_err(ex, ex_p):.3e} < 1e-5")

        p1, v1, a1 = pm.clone(), vel.clone(), aold.clone()
        cf.sym_step_(p1, v1, a1, DT, G, eps2=EPS2, b=b, n_real=n_real)
        torch.cuda.synchronize()
        p0, v0, a0 = pm.clone(), vel.clone(), aold.clone()
        src, acc_d = cf.sym_diag_prep_plain(p0, G, EPS2, b)
        acc_h = cf.sym_hops_plain(src, EPS2, b)
        cf.sym_epilogue_plain_(acc_d, acc_h, p0, v0, a0, DT, n_real)
        torch.cuda.synchronize()
        ea, ep, ev = rel_err(a1, a0), max_abs(p1, p0), max_abs(v1, v0)
        check(ea < 5e-5 and ep <= 1e-6 and ev <= 1e-6,
              f"N={n_pad} nt={nt}: sym step vs plain stages accel {ea:.3e} < 5e-5, "
              f"|dp| {ep:.3e} <= 1e-6, |dv| {ev:.3e} <= 1e-6")
        frozen = (torch.equal(p1[n_real:], pm[n_real:]) and torch.equal(v1[n_real:], vel[n_real:])
                  and bool((a1[n_real:] == 0).all()))
        check(frozen, f"N={n_pad} nt={nt}: padded rows frozen, stored accel zero")
        es = rel_err(a1[:n_real], ex[:n_real])
        check(es < 2e-5, f"N={n_pad} nt={nt}: sym accel vs exact accel {es:.3e} < 2e-5")
        torch.cuda.synchronize()


def phase_kernel_times(dev) -> dict[str, dict]:
    """Each kernel beside its twin at the main-path shapes, same inputs."""
    out: dict[str, dict] = {}
    print("[3 kernels] times at main-path shapes (CUDA events)", flush=True)

    pm_np, vel_np, _ = make_preset("two-galaxy", seed=0, G=G)
    n_pad = pad_count(pm_np.shape[0], PAD_GRANULE)
    pm = init_state(pm_np, vel_np, n_pad=n_pad, device=dev).pos_mass
    ex = cf.force_exact(pm, pm, G, EPS2)
    ex_p = cf.force_exact_plain(pm, pm, G, EPS2)
    torch.cuda.synchronize()
    check(rel_err(ex, ex_p) < 1e-5, f"two-galaxy N={n_pad}: force_exact vs plain {rel_err(ex, ex_p):.3e} < 1e-5")
    out["force_exact"] = {
        "max_abs_err": max_abs(ex, ex_p),
        "ms": cuda_ms(lambda: cf.force_exact(pm, pm, G, EPS2), reps=20),
        "plain_ms": cuda_ms(lambda: cf.force_exact_plain(pm, pm, G, EPS2), reps=3),
        "shape": f"({n_pad}, 4) x ({n_pad}, 4)",
        **bound("force_exact", n_pad * n_pad, 48 * n_pad, rsqrts=n_pad * n_pad),
    }
    phase_vjp_two_galaxy(dev, pm, pm_np.shape[0])

    n = 262144
    b = GPU_TILE
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    pm, vel, acc = morton_reorder(st.pos_mass, st.vel, st.accel, n_real=n)
    src, acc_d = cf.sym_diag_prep(pm, G, EPS2, b)
    src_p, acc_d_p = cf.sym_diag_prep_plain(pm, G, EPS2, b)
    torch.cuda.synchronize()
    check(torch.equal(src, src_p) and rel_err(acc_d, acc_d_p) < 1e-5,
          f"uniform-sphere N={n}: sym_diag_prep src equal, acc {rel_err(acc_d, acc_d_p):.3e} < 1e-5")
    out["sym_diag_prep"] = {
        "max_abs_err": max_abs(acc_d, acc_d_p),
        "ms": cuda_ms(lambda: cf.sym_diag_prep(pm, G, EPS2, b), reps=20),
        "plain_ms": cuda_ms(lambda: cf.sym_diag_prep_plain(pm, G, EPS2, b), reps=2),
        "shape": f"({n}, 4), tile {b}",
        **bound("sym_diag_prep", n * (b - 1), 48 * n, rsqrts=n * (b - 1)),
    }
    del src_p, acc_d_p

    t0 = time.perf_counter()
    acc_h_p = cf.sym_hops_plain(src, EPS2, b)
    torch.cuda.synchronize()
    plain_hops_ms = (time.perf_counter() - t0) * 1e3
    acc_h = cf.sym_hops(src, EPS2, b)
    torch.cuda.synchronize()
    total_p = acc_d + acc_h_p
    check(rel_err(acc_d + acc_h, total_p) < 2e-5,
          f"uniform-sphere N={n}: sym_hops vs plain (summed accel) {rel_err(acc_d + acc_h, total_p):.3e} < 2e-5")
    out["sym_hops"] = {
        "max_abs_err": max_abs(acc_h, acc_h_p),
        "ms": cuda_ms(lambda: cf.sym_hops(src, EPS2, b), reps=3),
        "plain_ms": plain_hops_ms,
        "shape": f"({n}, 4), tile {b}, nt {n // b}",
        **bound("sym_hops", hop_pairs(n, b), 32 * n, rsqrts=hop_pairs(n, b)),
    }
    del acc_h_p, total_p

    state_k = [t.clone() for t in (pm, vel, acc)]
    state_p = [t.clone() for t in (pm, vel, acc)]
    cf.sym_epilogue_(acc_d, acc_h, *state_k, DT, n - 5)
    cf.sym_epilogue_plain_(acc_d, acc_h, *state_p, DT, n - 5)
    torch.cuda.synchronize()
    err = max(max_abs(k, p) for k, p in zip(state_k, state_p))
    check(err == 0.0, f"uniform-sphere N={n}: sym_epilogue vs plain bit-equal (max-abs {err:.3e})")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)  # 128 MB > the 50 MB L2
    epi = lambda: cf.sym_epilogue_(acc_d, acc_h, *state_k, DT, n)  # noqa: E731
    epi_plain = lambda: cf.sym_epilogue_plain_(acc_d, acc_h, *state_p, DT, n)  # noqa: E731
    warm_ms = cuda_ms(epi, reps=50)
    out["sym_epilogue"] = {
        "max_abs_err": err,
        "ms": cuda_ms_cold(epi, 50, flush),
        "plain_ms": cuda_ms_cold(epi_plain, 20, flush),
        "shape": f"5 x ({n}, 4) in, 3 x ({n}, 4) out",
        "note": f"L2 flushed; L2 warm {warm_ms:.4f} ms, plain {cuda_ms(epi_plain, reps=20):.4f} ms",
        **bound("sym_epilogue", n, 128 * n),
    }
    del flush
    out.update(phase_vjp_times(dev, pm, b))
    for name, r in out.items():
        print(f"  {name:14s} {r['shape']:34s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  max-abs err {r['max_abs_err']:.3e}"
              + (f"  [{r['note']}]" if "note" in r else ""), flush=True)
    return out


# ------------------------------------------------------------- VJP kernels
def _cotangent(rng, n_pad: int, n_real: int, dev) -> torch.Tensor:
    abar = np.concatenate([rng.standard_normal((n_pad, 3)), np.zeros((n_pad, 1))], axis=1)
    abar[n_real:] = 0.0
    return torch.from_numpy(abar.astype(np.float32)).to(dev)


def _parts_err(got: tuple, want: tuple) -> tuple[float, float, float]:
    """(x̄, m̄, Ḡ) errors of ``(pm_bar, gbar)`` pairs: max-abs over scale
    for x̄ and m̄, relative for Ḡ."""
    (p, g), (pw, gw) = got, want
    return (rel_err(p[:, :3], pw[:, :3]), rel_err(p[:, 3], pw[:, 3]),
            abs(float(g) - float(gw)) / abs(float(gw)))


def phase_vjp_checks(dev) -> None:
    """The four VJP kernels vs their plain twins, padded rows included."""
    print("[3 kernels] VJP kernel vs plain twin, small shapes (heavy body 1e5)", flush=True)
    rng = np.random.default_rng(1)
    for n_pad, b, n_real in [(8192, 256, 8000), (7936, 256, 7900), (512, 256, 500)]:
        nt = n_pad // b
        pm, _, _ = _inputs(rng, n_pad, n_real, dev)
        pm[0, 3] = 1e5
        abar = _cotangent(rng, n_pad, n_real, dev)
        tag = f"N={n_pad} nt={nt}"
        acc_d, acc_d_p = fv.vjp_sym_diag(pm, abar, EPS2, b), fv.vjp_sym_diag_plain(pm, abar, EPS2, b)
        acc_h, acc_h_p = fv.vjp_sym_hops(pm, abar, EPS2, b), fv.vjp_sym_hops_plain(pm, abar, EPS2, b)
        torch.cuda.synchronize()
        e_d = max(rel_err(acc_d[:, c], acc_d_p[:, c]) for c in range(5))
        check(e_d < 1e-5 and not acc_d[:, 5:].any(), f"{tag}: vjp_sym_diag vs plain, worst column {e_d:.3e} < 1e-5")
        sym_k = fv.vjp_combine(acc_d, acc_h, G)
        sym_p = fv.vjp_combine_plain(acc_d_p, acc_h_p, G)
        ex, em, eg = _parts_err(sym_k, sym_p)
        check(ex < 2e-5 and em < 2e-5 and eg < 1e-5,
              f"{tag}: diag+hops+combine vs plain stages x̄ {ex:.3e}, m̄ {em:.3e} < 2e-5, Ḡ {eg:.3e} < 1e-5")
        comb_p = fv.vjp_combine_plain(acc_d, acc_h, G)
        eq = torch.equal(sym_k[0], comb_p[0])
        eg = abs(float(sym_k[1]) - float(comb_p[1])) / abs(float(comb_p[1]))
        check(eq and eg < 1e-12, f"{tag}: vjp_combine vs plain pm_bar bit-equal, Ḡ {eg:.3e} < 1e-12")
        full_k = fv.vjp_full(pm, G, abar, EPS2)
        full_p = fv.vjp_full_plain(pm, G, abar, EPS2)
        torch.cuda.synchronize()
        ex, em, eg = _parts_err(full_k, full_p)
        check(ex < 1e-5 and em < 1e-5 and eg < 1e-5,
              f"{tag}: vjp_full vs plain x̄ {ex:.3e}, m̄ {em:.3e}, Ḡ {eg:.3e} < 1e-5")
        ex, em, eg = _parts_err(sym_k, full_k)
        check(ex < 2e-5 and em < 2e-5 and eg < 1e-5,
              f"{tag}: sym schedule vs full grid x̄ {ex:.3e}, m̄ {em:.3e} < 2e-5, Ḡ {eg:.3e} < 1e-5")
        pad0 = bool((sym_k[0][n_real:, :3] == 0).all() and (full_k[0][n_real:, :3] == 0).all())
        check(pad0 and bool(torch.isfinite(sym_k[0]).all()), f"{tag}: padded rows' x̄ exactly 0, all finite")


def _vjp_oracle_f64(pm: np.ndarray, abar: np.ndarray, rows: np.ndarray, chunk: int = 64):
    """float64 numpy closed form of the VJP for the target ``rows``, each
    summed over every source (grad_bench.py's oracle).  Returns (x̄ (R, 3),
    m̄ (R,), the rows' φ (R,)), x̄ and m̄ scaled by G."""
    x = pm[:, :3].astype(np.float64)
    m = pm[:, 3].astype(np.float64)
    A = abar[:, :3].astype(np.float64)
    xbar, mbar, phi = np.empty((len(rows), 3)), np.empty(len(rows)), np.empty(len(rows))
    for c0 in range(0, len(rows), chunk):
        k = rows[c0 : c0 + chunk]
        d = x[None, :, :] - x[k, None, :]
        r2 = np.sum(d * d, axis=-1) + EPS2
        mask = np.ones(r2.shape)
        mask[np.arange(len(k)), k] = 0.0
        w = mask * r2**-1.5
        w5 = mask * r2**-2.5
        g = m[k, None, None] * A[None, :, :] - m[None, :, None] * A[k, None, :]
        dg = np.sum(d * g, axis=-1)
        xbar[c0 : c0 + len(k)] = np.sum(w[:, :, None] * g, axis=1) - 3.0 * np.einsum("kj,kjc->kc", w5 * dg, d)
        mbar[c0 : c0 + len(k)] = -np.einsum("kj,kjc,jc->k", w, d, A)
        phi[c0 : c0 + len(k)] = np.einsum("kc,kj,j,kjc->k", A[k], w, m, d)
    return G * xbar, G * mbar, phi


def _oracle_errs(pm_bar: np.ndarray, xbar_o, mbar_o, rows) -> tuple[float, float, float]:
    """Median and p99 relative x̄ error per body, median relative m̄ error."""
    scale = np.linalg.norm(xbar_o, axis=1)
    floor = 1e-12 * np.median(scale)
    rel = np.linalg.norm(pm_bar[rows, :3] - xbar_o, axis=1) / (scale + floor)
    rel_m = np.abs(pm_bar[rows, 3] - mbar_o) / (np.abs(mbar_o) + floor)
    return float(np.median(rel)), float(np.quantile(rel, 0.99)), float(np.median(rel_m))


def phase_vjp_gate(dev) -> None:
    """grad_bench.py's accuracy gate: both schedules against f64 at N = 4,096."""
    n = 4096
    pm_np, _, _ = make_preset("uniform-sphere", seed=0, G=G, n=n)
    pm_np = np.asarray(pm_np, np.float32)
    abar_np = np.concatenate(
        [np.random.default_rng(3).standard_normal((n, 3)), np.zeros((n, 1))], axis=1
    ).astype(np.float32)
    rows = np.arange(n)
    xbar_o, mbar_o, phi_o = _vjp_oracle_f64(pm_np, abar_np, rows)
    gbar_o = float(phi_o.sum())
    pm, abar = torch.from_numpy(pm_np).to(dev), torch.from_numpy(abar_np).to(dev)
    for name, (pm_bar, gbar) in (
        ("full", fv.force_vjp(pm, G, abar, eps2=EPS2)),
        ("sym", fv.force_vjp_sym(pm, G, abar, eps2=EPS2, b=GPU_TILE)),
    ):
        med, p99, med_m = _oracle_errs(pm_bar.cpu().numpy(), xbar_o, mbar_o, rows)
        rel_g = abs(float(gbar) - gbar_o) / abs(gbar_o)
        check(med <= 1e-4 and med_m <= 1e-4,
              f"[3 vjp gate] uniform-sphere N={n} {name}: x̄ median rel err {med:.3e} (p99 {p99:.3e}), "
              f"m̄ median {med_m:.3e} <= 1e-4 vs f64; Ḡ rel err {rel_g:.3e}")


def phase_vjp_two_galaxy(dev, pm: torch.Tensor, n_real: int) -> None:
    """The sym VJP at the exact gradient path's shape and data (two-galaxy,
    n_pad 40,192, tile 256, nt = 157 odd; two 1e7-mass centres beside
    bodies of mass 10-50) on a random cotangent: each stage against its
    plain twin, the whole against the plain stages and the full-grid VJP
    (the limits of the N = 262,144 checks), and both schedules against f64
    on 256 rows (the two centres among them)."""
    n, b = pm.shape[0], GPU_TILE
    tag = f"two-galaxy N={n} nt={n // b}"
    abar = _cotangent(np.random.default_rng(8), n, n_real, dev)
    acc_d, acc_d_p = fv.vjp_sym_diag(pm, abar, EPS2, b), fv.vjp_sym_diag_plain(pm, abar, EPS2, b)
    acc_h, acc_h_p = fv.vjp_sym_hops(pm, abar, EPS2, b), fv.vjp_sym_hops_plain(pm, abar, EPS2, b)
    torch.cuda.synchronize()
    e_d = max(rel_err(acc_d[:, c], acc_d_p[:, c]) for c in range(5))
    check(e_d < 1e-5, f"{tag}: vjp_sym_diag vs plain, worst column {e_d:.3e} < 1e-5")
    e_h = max(rel_err(acc_d[:, c] + acc_h[:, c], acc_d[:, c] + acc_h_p[:, c]) for c in range(5))
    check(e_h < 2e-5, f"{tag}: vjp_sym_hops vs plain (summed with diag), worst column {e_h:.3e} < 2e-5")
    sym = fv.force_vjp_sym(pm, G, abar, eps2=EPS2, b=b)
    full = fv.force_vjp(pm, G, abar, eps2=EPS2)
    for what, want in (("plain stages", fv.vjp_combine_plain(acc_d_p, acc_h_p, G)), ("full-grid VJP", full)):
        ex, em, eg = _parts_err(sym, want)
        check(ex < 2e-5 and em < 2e-5 and eg < 1e-5,
              f"{tag}: sym VJP vs {what} x̄ {ex:.3e}, m̄ {em:.3e} < 2e-5, Ḡ {eg:.3e} < 1e-5")
    heavy = torch.topk(pm[:, 3], 2).indices.cpu().numpy()
    rng = np.random.default_rng(9)
    rows = np.union1d(heavy, rng.choice(np.setdiff1d(np.arange(n_real), heavy), 254, replace=False))
    xbar_o, mbar_o, _ = _vjp_oracle_f64(pm.cpu().numpy(), abar.cpu().numpy(), rows)
    for name, (pm_bar, _) in (("sym", sym), ("full", full)):
        med, p99, med_m = _oracle_errs(pm_bar.cpu().numpy(), xbar_o, mbar_o, rows)
        check(med <= 1e-4 and med_m <= 1e-4,
              f"{tag} {name} VJP vs f64 on 256 rows: x̄ median rel err {med:.3e} "
              f"(p99 {p99:.3e}), m̄ median {med_m:.3e} <= 1e-4")


def phase_vjp_times(dev, pm: torch.Tensor, b: int) -> dict[str, dict]:
    """The VJP kernels at the sym main-path shape (N = 262,144, tile 256)
    on a random cotangent: times beside the twins', and the full-width
    checks (sym vs full grid, both vs f64 on 256 sampled rows)."""
    n = pm.shape[0]
    out: dict[str, dict] = {}
    abar = _cotangent(np.random.default_rng(5), n, n, dev)
    acc_d = fv.vjp_sym_diag(pm, abar, EPS2, b)
    acc_d_p = fv.vjp_sym_diag_plain(pm, abar, EPS2, b)
    torch.cuda.synchronize()
    e_d = max(rel_err(acc_d[:, c], acc_d_p[:, c]) for c in range(5))
    check(e_d < 1e-5, f"uniform-sphere N={n}: vjp_sym_diag vs plain, worst column {e_d:.3e} < 1e-5")
    out["vjp_sym_diag"] = {
        "max_abs_err": max_abs(acc_d, acc_d_p),
        "note": f"worst column max-abs/scale {e_d:.3e}",
        "ms": cuda_ms(lambda: fv.vjp_sym_diag(pm, abar, EPS2, b), reps=20),
        "plain_ms": cuda_ms(lambda: fv.vjp_sym_diag_plain(pm, abar, EPS2, b), reps=2),
        "shape": f"2 x ({n}, 4) -> ({n}, 8), tile {b}",
        **bound("vjp_sym_diag", n * (b - 1), 64 * n, rsqrts=n * (b - 1)),
    }
    del acc_d_p

    acc_h_p = None

    def run_plain_hops():
        nonlocal acc_h_p
        acc_h_p = fv.vjp_sym_hops_plain(pm, abar, EPS2, b)

    plain_hops_ms = host_ms(run_plain_hops)
    acc_h = fv.vjp_sym_hops(pm, abar, EPS2, b)
    torch.cuda.synchronize()
    e_h = max(rel_err(acc_d[:, c] + acc_h[:, c], acc_d[:, c] + acc_h_p[:, c]) for c in range(5))
    check(e_h < 2e-5, f"uniform-sphere N={n}: vjp_sym_hops vs plain (summed with diag), worst column {e_h:.3e} < 2e-5")
    out["vjp_sym_hops"] = {
        "max_abs_err": max_abs(acc_h, acc_h_p),
        "ms": cuda_ms(lambda: fv.vjp_sym_hops(pm, abar, EPS2, b), reps=3),
        "plain_ms": plain_hops_ms,
        "shape": f"2 x ({n}, 4) -> ({n}, 8), tile {b}, nt {n // b}",
        "note": f"plain: one run, host clock; worst column max-abs/scale {e_h:.3e}",
        **bound("vjp_sym_hops", hop_pairs(n, b), 64 * n, rsqrts=hop_pairs(n, b)),
    }
    del acc_h_p

    sym = fv.vjp_combine(acc_d, acc_h, G)
    comb_p = fv.vjp_combine_plain(acc_d, acc_h, G)
    torch.cuda.synchronize()
    check(torch.equal(sym[0], comb_p[0]), f"uniform-sphere N={n}: vjp_combine vs plain pm_bar bit-equal")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    pm_bar, gbar = torch.empty((n, 4), device=dev), torch.zeros(1, dtype=torch.float64, device=dev)
    lib = _build.load_library()
    # The launch alone: the wrapper's zeroing of gbar is a kernel of its own.
    comb = lambda: launch("vjp_combine", dev, lib.nb_vjp_combine, acc_d, acc_h, pm_bar, gbar, n, G)  # noqa: E731
    comb_plain = lambda: fv.vjp_combine_plain(acc_d, acc_h, G)  # noqa: E731
    warm_ms = cuda_ms(comb, reps=50)
    out["vjp_combine"] = {
        "max_abs_err": max_abs(sym[0], comb_p[0]),
        "ms": cuda_ms_cold(comb, 50, flush),
        "plain_ms": cuda_ms_cold(comb_plain, 20, flush),
        "shape": f"2 x ({n}, 8) -> ({n}, 4) + Ḡ",
        "note": f"L2 flushed; L2 warm {warm_ms:.4f} ms, plain {cuda_ms(comb_plain, reps=20):.4f} ms",
        **bound("vjp_combine", n, 80 * n + 8),
    }
    del flush

    full = fv.vjp_full(pm, G, abar, EPS2)
    full_p = None

    def run_plain_full():
        nonlocal full_p
        full_p = fv.vjp_full_plain(pm, G, abar, EPS2)

    plain_full_ms = host_ms(run_plain_full)
    ex, em, eg = _parts_err(full, full_p)
    check(ex < 1e-5 and em < 1e-5 and eg < 1e-5,
          f"uniform-sphere N={n}: vjp_full vs plain x̄ {ex:.3e}, m̄ {em:.3e}, Ḡ {eg:.3e} < 1e-5")
    out["vjp_full"] = {
        "max_abs_err": max_abs(full[0], full_p[0]),
        "ms": cuda_ms(lambda: fv.vjp_full(pm, G, abar, EPS2), reps=2),
        "plain_ms": plain_full_ms,
        "shape": f"2 x ({n}, 4) -> ({n}, 4) + Ḡ",
        "note": "plain: one run, host clock",
        **bound("vjp_full", n * (n - 1), 48 * n + 8, rsqrts=n * (n - 1)),
    }
    del full_p

    ex, em, eg = _parts_err(sym, full)
    check(ex < 2e-5 and em < 2e-5 and eg < 1e-5,
          f"uniform-sphere N={n}: sym VJP vs full-grid VJP x̄ {ex:.3e}, m̄ {em:.3e} < 2e-5, Ḡ {eg:.3e} < 1e-5")
    rows = np.sort(np.random.default_rng(6).choice(n, 256, replace=False))
    xbar_o, mbar_o, _ = _vjp_oracle_f64(pm.cpu().numpy(), abar.cpu().numpy(), rows)
    for name, (pm_bar, _) in (("sym", sym), ("full", full)):
        med, p99, med_m = _oracle_errs(pm_bar.cpu().numpy(), xbar_o, mbar_o, rows)
        check(med <= 1e-4 and med_m <= 1e-4,
              f"uniform-sphere N={n} {name} VJP vs f64 on 256 rows: x̄ median rel err {med:.3e} "
              f"(p99 {p99:.3e}), m̄ median {med_m:.3e} <= 1e-4")
    return out


# --------------------------------------------------------------- gradients
def _rollout_times(step, pm: torch.Tensor, v0: torch.Tensor, k: int, loss_of, reps: int = 2):
    """Forward and gradient (by v0) of a k-step rollout loss: median host
    ms per step of each, the gradient, and the two rollouts as
    ``[(label, fn)]`` for :func:`profile_window`."""

    def forward():
        s = SimState(pm.clone(), v0.clone(), torch.zeros_like(pm), 0)
        for _ in range(k):
            s = step(s, DT_MAIN, G)
        return loss_of(s)

    def gradient():
        v = v0.clone().requires_grad_()
        s = SimState(pm.clone(), v, torch.zeros_like(pm), 0)
        for _ in range(k):
            s = step(s, DT_MAIN, G)
        return torch.autograd.grad(loss_of(s), v)[0]

    forward(), gradient()  # warm
    t_f = statistics.median(host_ms(forward) for _ in range(reps)) / k
    out = {}
    t_g = statistics.median(host_ms(lambda: out.update(g=gradient())) for _ in range(reps)) / k
    return t_f, t_g, out["g"], [(f"forward, {k} steps", forward), (f"gradient, {k} steps", gradient)]


def _kernel_label(name: str) -> str:
    m = re.search(r"(\w+)[<(]", name)
    return m.group(1) if m else name[:40]


def _profiled(fn):
    """One call of ``fn()`` under ``torch.profiler`` (CPU + CUDA): host wall
    time in us, the device events as ``(label, start, end)``, and whether
    the trace holds one event for every launch of the port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    before = launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launched = {f"{k}_kernel": c - before[k] for k, c in launch_counts().items() if c > before[k]}
    events = [(_kernel_label(e.name), e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {k: sum(1 for name, _, _ in events if name == k) for k in launched}
    return wall_us, events, seen == launched


def profile_window(label: str, fn, tries: int = 3) -> None:
    """Host wall time, device busy time (the union of the intervals of the
    device's kernels and copies), the idle share 1 - busy / wall and the
    three largest kernels of one call of ``fn()``.  A trace that misses a
    launch of the port's kernels (the profiler has dropped device events
    on the card) is taken again, up to ``tries`` times."""
    for attempt in range(1, tries + 1):
        wall_us, events, complete = _profiled(fn)
        if complete and events:
            break
    else:
        print(f"  profile {label}: no trace in {tries} held every kernel launch; "
              "device busy time not measured", flush=True)
        return
    spans = sorted((s, e) for _, s, e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    per_kernel: dict[str, float] = {}
    for name, s, e in events:
        per_kernel[name] = per_kernel.get(name, 0.0) + e - s
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:3]
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / wall_us:.4f} (trace {attempt} of {tries}); top: "
          + ", ".join(f"{n} {t / 1e3:.3f} ms" for n, t in top), flush=True)


def _grad_agrees(g: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    """``|g - ref| <= 2e-3 |ref| + 1e-6 max|ref|`` elementwise."""
    atol = 1e-6 * float(ref.abs().max())
    excess = float(((g - ref).abs() - 2e-3 * ref.abs()).max())
    check(excess <= atol, f"{what}: rtol 2e-3, atol 1e-6 of scale "
          f"(worst |diff| - rtol|ref| = {excess:.3e} <= {atol:.3e}; max |diff| / max |ref| "
          f"{max_abs(g, ref) / float(ref.abs().max()):.3e})")


def _two_galaxy(dev):
    pm_np, vel_np, _ = make_preset("two-galaxy", seed=0, G=G)
    n_real = pm_np.shape[0]
    return init_state(pm_np, vel_np, n_pad=pad_count(n_real, PAD_GRANULE), device=dev), n_real


GRADS: dict[str, torch.Tensor] = {}  # phase 6b's gradient, for phase 6c


def _print_grad(tag: str, n_pair: int, t_f: float, t_g: float) -> None:
    print(f"{tag}: forward {t_f:.4f} ms/step, gradient {t_g:.4f} ms/step, ratio {t_g / t_f:.3f}, "
          f"gradient pair rate 2N^2/t {2 * n_pair * n_pair / t_g / 1e6:.2f} G-pair/s", flush=True)


def phase_grad_sym(dev):
    """grad_bench's rollout: uniform-sphere N = 262,144, k = 5, by v0."""
    n, k = 262144, 5
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    step = make_step_fn(SimConfig(force_mode="sym"), n, n, dev)
    t_f, t_g, g, prof = _rollout_times(step, st.pos_mass, st.vel, k, lambda s: (s.pos_mass[:, :3] ** 2).sum() / n)
    _print_grad(f"[6a grad sym] uniform-sphere N={n} k={k}", n, t_f, t_g)
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, "sym gradient finite and nonzero")
    return [(f"sym {label}", fn) for label, fn in prof]


def phase_grad_exact(dev):
    """The exact route's rollout gradient at two-galaxy N = 40,002, k = 3."""
    st, n_real = _two_galaxy(dev)
    k = 3
    step = make_step_fn(SimConfig(), st.n_pad, n_real, dev)
    t_f, t_g, g, prof = _rollout_times(
        step, st.pos_mass, st.vel, k, lambda s: (s.pos_mass[:, :3] ** 2).sum() / n_real)
    _print_grad(f"[6b grad exact] two-galaxy N={n_real} (n_pad {st.n_pad}) k={k}", st.n_pad, t_f, t_g)
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, "exact gradient finite and nonzero")
    GRADS["exact"] = g
    return [(f"exact {label}", fn) for label, fn in prof]


def phase_grad_full(dev):
    """Phase 6b's rollout through ``make_diff_accel(sym=False)``, the
    full-grid VJP route (on no main path), against phase 6b's gradient."""
    st, n_real = _two_galaxy(dev)
    k = 3
    accel = fv.make_diff_accel(lambda p, g: cf.force_exact(p, p, g, EPS2), eps2=EPS2, b=GPU_TILE, sym=False)

    def step(s, dt, g):
        return integrate_state("verlet", lambda p: accel(p, g), s, dt, n_real=n_real)

    t_f, t_g, g, _ = _rollout_times(step, st.pos_mass, st.vel, k, lambda s: (s.pos_mass[:, :3] ** 2).sum() / n_real)
    _print_grad(f"[6c grad full-grid VJP] two-galaxy N={n_real} (n_pad {st.n_pad}) k={k}", st.n_pad, t_f, t_g)
    _grad_agrees(g, GRADS["exact"], "full-grid VJP route vs phase 6b's gradient")


def phase_grad_crosscheck(dev, n: int = 4096) -> None:
    """tests/test_grad.py's rollout (10 steps, dt 1e-2, loss |x_0|^2) at
    N = 4,096 on the card: kernel routes vs the backend="jnp" route, the
    gradient by v0 and by dt and G (0-d tensors)."""
    rng = np.random.default_rng(7)
    pm = torch.from_numpy(np.concatenate(
        [rng.standard_normal((n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)).to(dev)
    full_accel = fv.make_diff_accel(lambda p, g: cf.force_exact(p, p, g, EPS2), eps2=EPS2, b=GPU_TILE, sym=False)
    steps = {
        "jnp": make_step_fn(SimConfig(backend="jnp"), n, n, dev),
        "sym": make_step_fn(SimConfig(force_mode="sym"), n, n, dev),
        "exact": make_step_fn(SimConfig(), n, n, dev),
        "exact, full-grid VJP": lambda s, dt_, g: integrate_state("verlet", lambda p: full_accel(p, g), s, dt_),
    }
    grads = {}
    for name, step in steps.items():
        v = torch.zeros((n, 4), device=dev, requires_grad=True)
        dt, g = (torch.tensor(x, device=dev, requires_grad=True) for x in (1e-2, G))
        s = SimState(pm.clone(), v, torch.zeros_like(pm), 0)
        for _ in range(10):
            s = step(s, dt, g)
        grads[name] = torch.autograd.grad((s.pos_mass[0, :3] ** 2).sum(), (v, dt, g))
    ref_v, ref_dt, ref_g = grads.pop("jnp")
    for name, (gv, gdt, gg) in grads.items():
        _grad_agrees(gv, ref_v, f"[6d grad check] N={n} {name} route vs jnp route")
        e_dt, e_g = (abs(float(a) - float(b)) / abs(float(b)) for a, b in ((gdt, ref_dt), (gg, ref_g)))
        check(e_dt <= 2e-3 and e_g <= 2e-3,
              f"[6d grad check] N={n} {name} route: d/d dt {float(gdt):.6e} (rel err {e_dt:.3e}), "
              f"d/dG {float(gg):.6e} (rel err {e_g:.3e}) vs jnp route, rtol 2e-3")


def _conservation(sim: Simulation, d0, d1):
    e0, e1 = float(d0.total_energy), float(d1.total_energy)
    drift = abs(e1 - e0) / max(abs(e0), 1e-30)
    pm, vel, _ = sim.arrays()
    pscale = float(np.abs(pm[:, 3:4] * vel[:, :3]).sum())
    mom = float(np.max(np.abs(np.asarray(d1.momentum) - np.asarray(d0.momentum)))) / max(pscale, 1e-30)
    finite = all(np.isfinite(a).all() for a in sim.arrays())
    return drift, mom, finite


def _timed_chunks(sim: Simulation, chunks: int, chunk: int) -> list[float]:
    times = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        sim.run(chunk, chunk=chunk)
        times.append(time.perf_counter() - t0)
    return times


def phase_exact(dev) -> None:
    sim = Simulation.from_preset("two-galaxy", SimConfig(), device=dev)
    d0 = sim.diagnostics()
    times = _timed_chunks(sim, 4, 50)
    d1 = sim.diagnostics()
    drift, mom, finite = _conservation(sim, d0, d1)
    med = statistics.median(times)
    gints = sim.pair_interactions_per_step * 50 / med / 1e9
    print(
        f"[4 exact] two-galaxy N={sim.n_real} (n_pad {sim.n_pad}) 200 steps: "
        f"median chunk {med:.4f} s = {med / 50 * 1e3:.4f} ms/step, {gints:.2f} G-int/s; "
        f"chunks {[round(t, 4) for t in times]}; energy drift {drift:.3e}, momentum err {mom:.3e}",
        flush=True,
    )
    check(finite and sim.state.pos_mass.shape == (sim.n_pad, 4), "exact: finite state of shape (n_pad, 4)")
    check(drift <= 1e-3, f"exact: energy drift {drift:.3e} <= 1e-3")
    check(mom <= 1e-5, f"exact: momentum error {mom:.3e} <= 1e-5")


def phase_sym(dev) -> None:
    sim = Simulation.from_preset(
        "uniform-sphere", SimConfig(force_mode="sym", morton_every=64), n=262144, device=dev
    )
    d0 = sim.diagnostics()
    warm = _timed_chunks(sim, 1, 50)
    times = _timed_chunks(sim, 2, 50)
    d1 = sim.diagnostics()
    nsteps = 150
    drift, mom, finite = _conservation(sim, d0, d1)
    med = statistics.median(times)
    gints = sim.pair_interactions_per_step * 50 / med / 1e9
    bound = 1e-4 * max(nsteps, 140) / 140.0
    print(
        f"[5 sym] uniform-sphere N={sim.n_real} morton_every=64 {nsteps} steps: "
        f"median chunk {med:.4f} s = {med / 50 * 1e3:.4f} ms/step, {gints:.2f} G-int/s; "
        f"warm {warm[0]:.4f} s, timed {[round(t, 4) for t in times]}; energy drift {drift:.3e} "
        f"({drift / nsteps:.3e}/step), momentum err {mom:.3e}",
        flush=True,
    )
    check(finite and sim.state.pos_mass.shape == (sim.n_pad, 4), "sym: finite state of shape (n_pad, 4)")
    check(drift <= bound, f"sym: energy drift {drift:.3e} <= {bound:.3e}")
    check(mom <= 1e-5, f"sym: momentum error {mom:.3e} <= 1e-5")


# ------------------------------------------------------- the render path
def render_scene(n: int, seed: int, *, scale: float = 2.5, heavy: int = 2, masses=None):
    """tests/test_render.py's scene (benchmarks/render_bench.py's at
    N = 500,010): bodies N(0, scale), masses U(10, 50), the first ``heavy``
    at 1e7 (or ``masses``), velocities N(0, 5)."""
    rng = np.random.default_rng(seed)
    pos_mass = np.concatenate(
        [rng.normal(scale=scale, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1
    ).astype(np.float32)
    if masses is not None:
        pos_mass[: len(masses), 3] = masses
    elif heavy:
        pos_mass[:heavy, 3] = 1e7
    vel = rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)
    return pos_mass, vel


def _two_galaxy_frame():
    """The run's frame: the two-galaxy preset, its camera, 1024x768."""
    cfg = SimConfig()
    pm, vel, target = make_preset("two-galaxy", seed=cfg.seed, G=cfg.G, size_factor=cfg.size_factor)
    return pm, vel, Camera(target=target), dict(width=1024, height=768, size_factor=cfg.size_factor)


def render_scenes() -> dict:
    """name: (pos_mass, vel, camera, frame kwargs).  The scenes of
    tests/test_render.py:312-430 and the two-galaxy frame."""
    scenes = {
        "20k dense, 320x240": (*render_scene(20_000, 13), 4.0, dict(width=320, height=240)),
        "6k bin edges, 640x100": (*render_scene(6_000, 7, heavy=0), 2.0, dict(width=640, height=100)),
        "3k radii 16-64, 320x240": (*render_scene(3_000, 11, scale=2.0, masses=np.geomspace(1e5, 5e9, 64)), 2.0,
                                    dict(width=320, height=240)),
        "1.5k max_radius_px 96, 256x160": (*render_scene(1_500, 12, scale=2.0, masses=[5e10] * 4), 2.0,
                                           dict(width=256, height=160, max_radius_px=96)),
    }
    # tests/test_render.py's size factors clamp every radius to 0.5 px at
    # this frame height; about 160 / sf is the least radius, so 160.2, 113.3
    # and 80.2 spread radii from just below r = 1, sqrt 2 and 2 upwards.
    for sf in (400.0, 700.0, 1000.0, 1800.0, 160.2, 113.3, 80.2):
        scenes[f"r = 1, sqrt 2, 2 sweep, size_factor {sf:g}"] = (
            *render_scene(512, 3, scale=1.0, heavy=0), 5.0, dict(width=200, height=160, size_factor=sf))
    out = {k: (pm, vel, Camera(target=np.zeros(3), radius=rad), fr) for k, (pm, vel, rad, fr) in scenes.items()}
    out["two-galaxy N=40,002, 1024x768"] = _two_galaxy_frame()
    return out


def _prep(pm, vel, cam, frame, dev):
    """The device prep's resolve inputs on the card."""
    pm, vel = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pm, vel))
    return rasterize.prep_device(pm, vel, cam, frame["width"], frame["height"],
                                 frame.get("size_factor", 1000.0), frame.get("max_radius_px", 64))


def phase_render_checks(dev) -> None:
    """7a: ``splat_resolve`` against its twin on the same prep, bit for bit."""
    print("[7a render] splat_resolve vs plain twin on the card (uint64 framebuffer, torch.equal)", flush=True)
    for name, (pm, vel, cam, frame) in render_scenes().items():
        w, h = frame["width"], frame["height"]
        prep = _prep(pm, vel, cam, frame, dev)
        got = resolve.splat_resolve(*prep, width=w, height=h)
        want = resolve.splat_resolve_plain(*prep, width=w, height=h)
        torch.cuda.synchronize()
        vis, r = prep[5], prep[4][prep[5]]
        lit = int((got != resolve.MISS).sum())
        check(torch.equal(got, want) and lit > 0,
              f"{name}: kernel == twin ({int(vis.sum())} visible splats, r {float(r.min()):.3f}-"
              f"{float(r.max()):.3f} px, {lit} pixels lit)")


def stamp_pairs(prep, width: int, height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every (flat pixel, key) pair of the visible splats' discs: the input
    of one ``scatter_reduce_(..., "amin")`` (the library yardstick); its
    length is the stamp area."""
    cx, cy, depth_bits, rgb24, r, visible = prep
    rd = r[visible].double()
    order = torch.argsort(-rd, stable=True)
    cx, cy = (t[visible][order].long() for t in (cx, cy))
    key = resolve.make_keys(depth_bits[visible], rgb24[visible])[order]
    pairs = list(resolve.offset_pairs(cx, cy, key, rd[order].cpu().numpy(), width, height))
    return torch.cat([p for p, _ in pairs]), torch.cat([k for _, k in pairs])


def splat_bound(n: int, n_visible: int, width: int, height: int) -> dict:
    """The least bytes the resolve must move, over HBM: every splat's 1-byte
    ``visible`` flag, the visible splats' other 20 bytes (cx, cy, depth, rgb,
    r: 4 each), and each 8-byte framebuffer word written once (the frame
    fits in L2, so the atomics' read-modify-write need not reach HBM)."""
    return {"bound_ms": (n + 20 * n_visible + 8 * width * height) / HBM_BYTES * 1e3, "bound_by": "bytes"}


def _render_times(name, pm, vel, cam, frame, dev, tmp: pathlib.Path) -> dict:
    w, h = frame["width"], frame["height"]
    prep = _prep(pm, vel, cam, frame, dev)
    got = resolve.splat_resolve(*prep, width=w, height=h)
    want = None

    def run_plain():
        nonlocal want
        want = resolve.splat_resolve_plain(*prep, width=w, height=h)

    plain_ms = host_ms(run_plain)
    check(torch.equal(got, want), f"{name}: kernel == twin")
    pix, key = stamp_pairs(prep, w, h)
    top = torch.iinfo(torch.int64).max
    lib_call = lambda: torch.full((h * w,), top, dtype=torch.int64, device=dev).scatter_reduce_(  # noqa: E731
        0, pix, key, "amin")
    lib_buf = lib_call()
    check(torch.equal(torch.where(lib_buf == top, resolve.MISS, lib_buf), got), f"{name}: scatter_reduce_ == kernel")
    ms = cuda_ms(lambda: resolve.splat_resolve(*prep, width=w, height=h), reps=20)
    library_ms = cuda_ms(lib_call, reps=20)
    pm_d, vel_d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pm, vel))
    rasterize.render_points(pm_d, vel_d, cam, **frame)  # warm
    frame_ms = statistics.median(host_ms(lambda: rasterize.render_points(pm_d, vel_d, cam, **frame)) for _ in range(3))
    img = rasterize.render_points(pm_d, vel_d, cam, **frame)
    t0 = time.perf_counter()
    save_png(str(tmp / "frame.png"), img)
    png_ms = (time.perf_counter() - t0) * 1e3
    n_vis = int(prep[5].sum())
    r = {
        "max_abs_err": float((got - want).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "shape": f"{pm.shape[0]} splats ({n_vis} visible) -> {w}x{h}",
        "note": (f"stamp area {pix.numel()} pixels ({pix.numel() / max(n_vis, 1):.2f} a splat), "
                 f"{int((got != resolve.MISS).sum())} lit; frame end to end {frame_ms:.3f} ms; "
                 f"PNG write {png_ms:.3f} ms; ms includes the framebuffer fill; plain: one run, host clock"),
        **splat_bound(pm.shape[0], n_vis, w, h),
    }
    print(f"  {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library {library_ms:.4f} ms  "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  [{r['shape']}; {r['note']}]", flush=True)
    return r


def phase_render_times(dev) -> dict[str, dict]:
    """7c: the kernel, its twin and the library call at the run's frame
    (two-galaxy, 1024x768) and at benchmarks/render_bench.py's N = 500,010
    at 1920x1080 (camera radius 5 and 1); frame, PNG and checkpoint times."""
    print("[7c render] times (CUDA events; frame, PNG, checkpoint: host clock, synced)", flush=True)
    pm, vel = render_scene(500_010, 0)
    big = dict(width=1920, height=1080)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        main = _render_times("two-galaxy N=40,002 1024x768", *_two_galaxy_frame(), dev, tmp)
        scenes = {
            label: _render_times(f"N=500,010 1920x1080 {label}", pm, vel, Camera(target=np.zeros(3), radius=rad),
                                 big, dev, tmp)
            for rad, label in ((5.0, "default distance"), (1.0, "close-up"))
        }
        sim = Simulation.from_preset("two-galaxy", SimConfig(), device=dev)
        ck = {}
        for fmt in ("npz", "json"):
            path = str(tmp / f"c.{fmt}")
            ck[f"{fmt} save"] = host_ms(lambda: sim.save(path))
            ck[f"{fmt} load"] = host_ms(lambda: Simulation.load(path, device=dev))
        print(f"  checkpoint two-galaxy N={sim.n_real}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ck.items()),
              flush=True)
    main["scenes"] = {k: {x: v[x] for x in ("ms", "plain_ms", "library_ms", "bound_ms", "note")}
                      for k, v in scenes.items()}
    return {"splat_resolve": main}


def phase_render_path(dev, out: pathlib.Path):
    """7b: the reference-default run through the CLI on the card, then
    ``render`` and ``convert`` of its final checkpoint, all into ``out``."""
    argv = ["run", "--device", dev.type, "--preset", "two-galaxy", "--steps", "200", "--log-every", "50",
            "--diagnostics", "--render-every", "50", "--checkpoint-every", "100", "--outdir", str(out)]
    print(f"[7b render path] cli {' '.join(argv)}", flush=True)
    sim0 = Simulation.from_preset("two-galaxy", SimConfig(), device=dev)
    d0 = sim0.diagnostics()
    del sim0
    t0 = time.perf_counter()
    rc = cli.main(argv)
    run_s = time.perf_counter() - t0
    names = sorted(p.name for p in out.iterdir())
    want = [f"frame_{i:06d}.png" for i in range(5)] + ["ckpt_00000100.npz", "ckpt_00000200.npz", "final.npz"]
    check(rc == 0 and all(n in names for n in want), f"run rc {rc} in {run_s:.3f} s wrote {names}")
    final = str(out / "final.npz")
    sim = Simulation.load(final, device=dev)
    drift, mom, finite = _conservation(sim, d0, sim.diagnostics())
    check(finite and sim.step_count == 200, f"final.npz: step {sim.step_count}, finite state")
    check(drift <= 1e-3 and mom <= 1e-5, f"run: energy drift {drift:.3e} <= 1e-3, momentum error {mom:.3e} <= 1e-5")
    t0 = time.perf_counter()
    rc = cli.main(["render", final, "-o", str(out / "render.png"), "--device", dev.type])
    render_s = time.perf_counter() - t0
    last, again = read_png(str(out / "frame_000004.png")), read_png(str(out / "render.png"))
    check(rc == 0 and np.array_equal(last, again) and last.any(),
          f"render final.npz ({render_s:.3f} s) == the run's last frame {last.shape}, "
          f"{int(last.any(axis=2).sum())} pixels lit")
    rc_a = cli.main(["convert", final, str(out / "x.json"), "--device", dev.type])
    rc_b = cli.main(["convert", str(out / "x.json"), str(out / "y.npz"), "--device", dev.type])
    with np.load(final) as a, np.load(out / "y.npz") as b:
        same = all(np.array_equal(a[k], b[k]) for k in ("pos_mass", "vel", "accel", "step"))
    check(rc_a == rc_b == 0 and same, "convert final.npz -> x.json -> y.npz: pos_mass, vel, accel, step bit-equal")
    return [("two-galaxy frame 1024x768", lambda: sim.render_frame())]


SYM = ("sym_diag_prep", "sym_hops", "sym_epilogue")
VJP_SYM = ("vjp_sym_diag", "vjp_sym_hops", "vjp_combine")
# The main paths, each with the kernels it runs; a kernel's "launches" is
# its sum over these windows and phase 7b's (its entry is made in main,
# which knows the output directory).
PATHS = (
    ("phase 4 (exact path)", phase_exact, ("force_exact",)),
    ("phase 5 (sym path)", phase_sym, SYM),
    ("phase 6a (sym gradient path)", phase_grad_sym, SYM + VJP_SYM),
    ("phase 6b (exact gradient path)", phase_grad_exact, ("force_exact",) + VJP_SYM),
)
RENDER_PATH = "phase 7b (render + checkpoint path)", ("force_exact", "splat_resolve")
# Runs off the main paths, each in a window of its own: the full-grid VJP
# route (vjp_full's launches are read here) and the N = 4,096 cross-check.
SIDE = (
    ("phase 6c (full-grid VJP route)", phase_grad_full, ("force_exact", "vjp_full")),
    ("phase 6d (cross-check)", phase_grad_crosscheck, tuple(k for k in KERNELS if k != "splat_resolve")),
)
FULL_ROUTE = SIDE[0][0]


def run_window(path: str, run, kernels_of_path, dev) -> dict[str, int]:
    """``run(dev)`` with the counts set to 0 just before and read just
    after; it must launch every kernel of ``kernels_of_path`` and no other.
    Profiles ``run`` hands back are taken after the counts are read."""
    reset_launch_counts()
    profiles = run(dev) or ()
    got = launch_counts()
    print_clocks(path)
    print(f"  launches in {path}: {json.dumps({k: c for k, c in got.items() if c})}", flush=True)
    for name in KERNELS:
        if name in kernels_of_path:
            check(got[name] > 0, f"{path} launched {name} {got[name]} times")
        elif got[name]:
            check(False, f"{path} launched {name}, which is not of this path, {got[name]} times")
    for label, fn in profiles:
        profile_window(label, fn)
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernels-only", action="store_true", help="stop after the small-shape kernel checks")
    ap.add_argument("--outdir", default=None,
                    help="keep phase 7b's frames and checkpoints here (default: a temporary directory)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: chip_smoke needs a CUDA card", file=sys.stderr)
        return 1
    dev = phase_device()
    phase_build()
    phase_kernel_checks(dev)
    phase_vjp_checks(dev)
    phase_vjp_gate(dev)
    phase_render_checks(dev)
    if args.kernels_only:
        print(f"kernels-only: {len(FAILURES)} failures", flush=True)
        return 1 if FAILURES else 0
    times = phase_kernel_times(dev)

    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(args.outdir or tmp)
        out.mkdir(parents=True, exist_ok=True)
        render_path = (RENDER_PATH[0], functools.partial(phase_render_path, out=out), RENDER_PATH[1])
        by_path = {path: run_window(path, run, ks, dev) for path, run, ks in PATHS + (render_path,)}
    side = {path: run_window(path, run, ks, dev) for path, run, ks in SIDE}
    times.update(phase_render_times(dev))

    kernels = []
    for name in KERNELS:
        if name == "vjp_full":
            launches = {"launches": side[FULL_ROUTE][name], "launches_from": FULL_ROUTE}
        else:
            launches = {
                "launches": sum(c[name] for c in by_path.values()),
                "launches_by_path": {p: c[name] for p, c in by_path.items() if c[name]},
            }
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": REPLACES[name][0],
            "replaces": REPLACES[name][1],
            **launches,
            "max_abs_err": times[name]["max_abs_err"],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"],
            "bound_by": times[name]["bound_by"],
            # Only the resolve has one PyTorch call of the same function
            # (scatter_reduce_ "amin" over its pre-expanded pairs).
            "library_ms": times[name].get("library_ms"),
            **({"scenes": times[name]["scenes"]} if "scenes" in times[name] else {}),
        })
    if FAILURES:
        print(f"FAILED {len(FAILURES)} checks: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
