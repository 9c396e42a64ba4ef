#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nbody3d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                 # everything below, one card
    python3 chip_smoke.py --kernels-only  # phases 1-3 only (build + checks)

Phases, one line each (a failed check prints FAIL and the run exits 1):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: nvcc builds the four kernels from ``nbody3d_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch twin on the card at
   N = 8,192 (nt even), 7,936 (nt odd) and 512 (nt = 2), padded rows
   included; then each kernel's time beside its twin's at the main-path
   shapes (exact: two-galaxy N = 40,002; sym: uniform-sphere N = 262,144).
4. exact main path: ``Simulation.from_preset("two-galaxy", SimConfig())``,
   200 steps in chunks of 50, energy drift <= 1e-3 and momentum error
   <= 1e-5 of sum |m v|.
5. sym main path: uniform-sphere N = 262,144, ``force_mode="sym"``,
   ``morton_every=64``; 1 warm and 2 timed chunks of 50 steps; energy
   drift <= 1e-4 * max(steps, 140) / 140, momentum error <= 1e-5.

The line before the last is ``{"kernels": [...]}`` (launches counted over
phases 4-5 only); the last is the ``{"ok": true, "device": ...}`` line.
Without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from nbody3d_tpu_torch import SimConfig, Simulation, _build
from nbody3d_tpu_torch.models.registry import make_preset
from nbody3d_tpu_torch.ops import cuda_force as cf
from nbody3d_tpu_torch.ops.morton import morton_reorder
from nbody3d_tpu_torch.ops.step import GPU_TILE, PAD_GRANULE
from nbody3d_tpu_torch.state import init_state, pad_count

G, EPS2, DT = 1e-4, 1e-4, 1e-3
SRC = "nbody3d_tpu_torch/csrc/"
PALLAS = "nbody3d_tpu/ops/pallas_force.py:"
REPLACES = {
    "force_exact": (SRC + "force_exact.cu", PALLAS + "263"),
    "sym_diag_prep": (SRC + "sym_diag_prep.cu", PALLAS + "770"),
    "sym_hops": (SRC + "sym_hops.cu", PALLAS + "582"),
    "sym_epilogue": (SRC + "sym_epilogue.cu", PALLAS + "1122"),
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


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phases
def phase_device() -> torch.device:
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
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
    }

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
    }
    del acc_h_p, total_p

    state_k = [t.clone() for t in (pm, vel, acc)]
    state_p = [t.clone() for t in (pm, vel, acc)]
    cf.sym_epilogue_(acc_d, acc_h, *state_k, DT, n - 5)
    cf.sym_epilogue_plain_(acc_d, acc_h, *state_p, DT, n - 5)
    torch.cuda.synchronize()
    err = max(max_abs(k, p) for k, p in zip(state_k, state_p))
    check(err == 0.0, f"uniform-sphere N={n}: sym_epilogue vs plain bit-equal (max-abs {err:.3e})")
    out["sym_epilogue"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: cf.sym_epilogue_(acc_d, acc_h, *state_k, DT, n), reps=50),
        "plain_ms": cuda_ms(lambda: cf.sym_epilogue_plain_(acc_d, acc_h, *state_p, DT, n), reps=20),
        "shape": f"5 x ({n}, 4) in, 3 x ({n}, 4) out",
    }
    for name, r in out.items():
        print(f"  {name:14s} {r['shape']:32s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"max-abs err {r['max_abs_err']:.3e}", flush=True)
    return out


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernels-only", action="store_true", help="stop after the small-shape kernel checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: chip_smoke needs a CUDA card", file=sys.stderr)
        return 1
    dev = phase_device()
    phase_build()
    phase_kernel_checks(dev)
    if args.kernels_only:
        print(f"kernels-only: {len(FAILURES)} failures", flush=True)
        return 1 if FAILURES else 0
    times = phase_kernel_times(dev)

    cf.reset_launch_counts()
    phase_exact(dev)
    after_exact = cf.launch_counts()
    check(after_exact["force_exact"] > 0, f"exact path launched force_exact {after_exact['force_exact']} times")
    phase_sym(dev)
    counts = cf.launch_counts()
    for name in ("sym_diag_prep", "sym_hops", "sym_epilogue"):
        check(counts[name] > 0, f"sym path launched {name} {counts[name]} times")

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": REPLACES[name][0],
            "replaces": REPLACES[name][1],
            "launches": counts[name],
            "max_abs_err": times[name]["max_abs_err"],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
        }
        for name in cf.KERNELS
    ]
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
