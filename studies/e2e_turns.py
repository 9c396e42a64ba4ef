"""End to end in turns: the paths that run the two redesigned kernels most,
timed on one card with the parent commit's package and this tree's, in
turns (pairs of runs alternating which tree goes first: parent, this,
this, parent, ...), each run in a process of its own with that tree first
on ``sys.path`` (each tree builds its own kernels once).
Paths (``chip_smoke.py``'s configurations): 12b periodic P3M at
p3m_bench's box (uniform box N = 2,097,152, box 10, grid 128, k = 32),
plain and interlaced, 10 warm steps and 3 chunks of 10; 12d periodic PM
there (CIC), 30 warm steps and 5 chunks of 50; 10b the unfused sym force
with yoshida4 (uniform sphere N = 262,144, ``morton_every=64``), one warm
chunk and 3 of 20 steps.  Prints each run's median chunk in ms/step and
its chunks; then one more chunk under ``torch.profiler``: its wall time
and device busy time (the union of the device's kernel and copy
intervals) a step, and the summed kernel time a step of each stage
(gather, deposit, short range, FFT, the rest).  The summary gives, for
each, the median over pairs of this tree's figure less the parent's.

With ``--swap`` it runs instead one process of this tree that rotates
12b's chunks among gathers called in place of ``mesh_cuda.gather``: this
tree's (``box``), this tree's kernel on its loop alone (``loop``, the same
wrapper), the parent's kernel (built from the parent checkout) and this
tree's kernel built at other box caps (``-DNB_GATHER_BOX_CAP``); a round
runs each gather for a timed chunk of 10 steps and a profiled one, the
order rotated and reversed from round to round: the gather alone in
turns, in one process.  Against ``loop`` it prints the wall time's
difference paired by round (median, a 90% bootstrap interval, the rounds
it was higher), the busy time's, and the device's idle time before the
kernels whose idle moved most.

    python3 studies/e2e_turns.py [PARENT_CHECKOUT] [PAIRS] [PATH ...]   # PATH: 12b 12b-il 12d 10b (default all)
    python3 studies/e2e_turns.py --swap [PARENT_CHECKOUT] [ROUNDS] [CAP ...]   # default 8 rounds
"""
import json
import pathlib
import statistics
import subprocess
import sys

COMMON = r"""
import json, statistics, sys, time
sys.path.insert(0, TREE)
import torch
import nbody3d_tpu_torch
from nbody3d_tpu_torch import SimConfig, Simulation
assert nbody3d_tpu_torch.__file__.startswith(TREE), nbody3d_tpu_torch.__file__
dev = torch.device("cuda", 0)
STAGES = (("mesh_gather", "gather"), ("mesh_deposit", "deposit"), ("short_range", "short range"), ("fft", "fft"))
def profiled(sim, chunk):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(chunk, chunk=chunk)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [(e.name.lower(), e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((s, e) for _, s, e in ev)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    stage, gaps, end = {}, {}, spans[0][0]
    for name, s, e in sorted(ev, key=lambda x: x[1]):
        key = next((v for k, v in STAGES if k in name), "rest")
        stage[key] = stage.get(key, 0.0) + (e - s) / 1e3 / chunk
        label = name.split("(")[0].split("<")[0][-60:]
        gaps[label] = gaps.get(label, 0.0) + max(0.0, s - end) / 1e3 / chunk  # the device idle before it
        end = max(end, e)
    return {"wall": wall / chunk, "busy": busy / 1e3 / chunk, "stages": stage, "gaps": gaps,
            "kernels": len(ev) / chunk}
def periodic(method, il):
    cfg = SimConfig(method=method, pm_grid=128, p3m_nbr_k=32, boundary="periodic", box_size=10.0, mesh_interlace=il)
    return Simulation.from_preset("uniform-box", cfg, n=2097152, box_size=10.0, device=dev)
"""

RUN = COMMON + r"""
out = {}
def chunks(sim, warm, n, chunk):
    sim.run(warm, chunk=warm)
    torch.cuda.synchronize()
    t = []
    for _ in range(n):
        t0 = time.perf_counter()
        sim.run(chunk, chunk=chunk)
        torch.cuda.synchronize()
        t.append((time.perf_counter() - t0) / chunk * 1e3)
    return {"median": statistics.median(t), "chunks": t, "profile": profiled(sim, chunk)}
PLAN = {"12b": ("12b periodic p3m", lambda: periodic("p3m", False), 10, 3, 10),
        "12b-il": ("12b periodic p3m interlaced", lambda: periodic("p3m", True), 10, 3, 10),
        "12d": ("12d periodic pm", lambda: periodic("pm", False), 30, 5, 50),
        "10b": ("10b unfused sym yoshida4", lambda: Simulation.from_preset("uniform-sphere", SimConfig(
            force_mode="sym", morton_every=64, integrator="yoshida4"), n=262144, device=dev), 20, 3, 20)}
for key, (name, make, warm, n, chunk) in PLAN.items():
    if PATHS and key not in PATHS:
        continue
    sim = make()
    out[name] = chunks(sim, warm, n, chunk)
    del sim
print("RESULT " + json.dumps(out))
"""

SWAP = COMMON + r"""
import ctypes, pathlib, subprocess
import chip_smoke as cs
from nbody3d_tpu_torch import _build
from nbody3d_tpu_torch.ops import mesh_cuda as mc
cs.load_parent(PARENT)
mine = mc.gather
libs = {}
for cap in CAPS:  # this tree's kernel built alone at another box cap
    so = pathlib.Path(f"_chipcheck/studies/swap/box{cap}.so")
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-DNB_GATHER_BOX_CAP={cap}", "-shared", "-o", str(so),
                    "nbody3d_tpu_torch/csrc/mesh_gather.cu"], check=True)
    libs[cap] = ctypes.CDLL(str(so))
    libs[cap].nb_mesh_gather.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
def capped(cap):
    def gather(grids, c4, fm, grid, order, periodic=False, sorted_rows=True, block_paths=None):
        out = torch.empty_like(fm)
        cs._parent_call(libs[cap].nb_mesh_gather, grids, c4, fm, out, c4.shape[0], grid, order, int(periodic),
                        int(sorted_rows), None)
        return out
    return gather
variants = {"box": mine,
            "loop": lambda g, c4, fm, grid, order, periodic=False, sorted_rows=True, block_paths=None:
                mine(g, c4, fm, grid, order, periodic, False),
            "parent": lambda g, c4, fm, grid, order, periodic=False, sorted_rows=True, block_paths=None:
                cs.parent_gather(g, c4, fm, grid, order, periodic),
            **{f"box{cap}": capped(cap) for cap in CAPS}}
import random
sim = periodic("p3m", False)
sim.run(10, chunk=10)
got = {t: [] for t in variants}  # a round's (wall of an unprofiled chunk, the profiled chunk's figures)
tags = list(variants)
for r in range(ROUNDS):
    k = r % len(tags)
    for tag in (tags[k:] + tags[:k])[:: 1 if r % 2 == 0 else -1]:
        mc.gather = variants[tag]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(10, chunk=10)
        torch.cuda.synchronize()
        got[tag].append(((time.perf_counter() - t0) * 1e2, profiled(sim, 10)))
mc.gather = mine
med = statistics.median
for tag, runs in got.items():
    w, pw, b = [x[0] for x in runs], [x[1]["wall"] for x in runs], [x[1]["busy"] for x in runs]
    g = [x[1]["stages"].get("gather", 0.0) for x in runs]
    print(f"[swap] {tag}: wall {[round(x, 4) for x in w]} ms/step, profiled wall {[round(x, 4) for x in pw]}, "
          f"busy {[round(x, 4) for x in b]}; medians wall {med(w):.4f}, profiled wall {med(pw):.4f}, busy "
          f"{med(b):.4f}, idle {med(x - y for x, y in zip(pw, b)):.4f}, gather {med(g):.4f}; kernels a step "
          f"{med(x[1]['kernels'] for x in runs):.1f}", flush=True)
names = sorted({n for runs in got.values() for x in runs for n in x[1]["gaps"]})
gap = {t: {n: med(x[1]["gaps"].get(n, 0.0) for x in runs) for n in names} for t, runs in got.items()}
rng = random.Random(0)
for tag in [t for t in tags if t != "loop"]:
    diff = [a[0] - b[0] for a, b in zip(got[tag], got["loop"])]  # paired by round
    busy = [a[1]["busy"] - b[1]["busy"] for a, b in zip(got[tag], got["loop"])]
    boot = sorted(med(rng.choices(diff, k=len(diff))) for _ in range(2000))
    moved = sorted(names, key=lambda n: -abs(gap[tag][n] - gap["loop"][n]))[:4]
    print(f"[swap] {tag} - loop, paired by round: wall median {med(diff):+.4f} ms/step (90% bootstrap "
          f"{boot[100]:+.4f} .. {boot[1899]:+.4f}; higher in {sum(d > 0 for d in diff)} of {len(diff)} rounds), "
          f"busy median {med(busy):+.4f} (higher in {sum(d > 0 for d in busy)}); the device's idle before "
          f"each kernel, the largest moves: " + ", ".join(f"{n} {gap[tag][n] - gap['loop'][n]:+.4f}"
                                                           for n in moved), flush=True)
"""


def swap(argv) -> int:
    parent = str(pathlib.Path(argv[0] if argv else "_chipcheck/parent").resolve())
    n = int(argv[1]) if len(argv) > 1 else 8
    caps = [int(c) for c in argv[2:]]
    here = str(pathlib.Path(".").resolve())
    code = f"TREE = {here!r}\nPARENT = {parent!r}\nROUNDS = {n}\nCAPS = {caps!r}\n" + SWAP
    return subprocess.run([sys.executable, "-c", code], cwd=here, timeout=1200).returncode


def main():
    if sys.argv[1:2] == ["--swap"]:
        return swap(sys.argv[2:])
    parent = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else "_chipcheck/parent").resolve()
    pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    paths = sys.argv[3:]
    here = pathlib.Path(".").resolve()
    results = []  # a pair's {tag: {path: {"median", "chunks", "profile"}}}
    for i in range(pairs):
        got = {}
        for tag, tree in (("parent", parent), ("this", here))[:: 1 if i % 2 == 0 else -1]:
            proc = subprocess.run([sys.executable, "-c", f"TREE = {str(tree)!r}\nPATHS = {paths!r}\n" + RUN],
                                  capture_output=True, text=True, cwd=tree, timeout=900)
            line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
            if proc.returncode or not line:
                print(f"[{tag}] rc {proc.returncode}\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}", flush=True)
                return 1
            got[tag] = json.loads(line[0][7:])
            for name, r in got[tag].items():
                p = r["profile"]
                print(f"[{tag}] {name}: median {r['median']:.4f} ms/step, chunks {[round(x, 4) for x in r['chunks']]}; "
                      f"profiled chunk wall {p['wall']:.4f}, busy {p['busy']:.4f}, stages "
                      + ", ".join(f"{k} {v:.4f}" for k, v in sorted(p["stages"].items())), flush=True)
        results.append(got)
    med = statistics.median
    for name in results[0]["parent"]:
        par, this = ([g[tag][name] for g in results] for tag in ("parent", "this"))
        pw, tw = [r["median"] for r in par], [r["median"] for r in this]
        diff = {k: med([t["profile"][k] for t in this]) - med([p["profile"][k] for p in par]) for k in ("wall", "busy")}
        stages = sorted({k for r in par + this for k in r["profile"]["stages"]})
        sdiff = {k: med([t["profile"]["stages"].get(k, 0.0) for t in this])
                 - med([p["profile"]["stages"].get(k, 0.0) for p in par]) for k in stages}
        print(f"{name}: parent {[round(x, 4) for x in pw]}, this {[round(x, 4) for x in tw]} ms/step by pair; "
              f"median this - parent {med(tw) - med(pw):+.4f}; the parent's own range {max(pw) - min(pw):.4f}; "
              f"this faster in {sum(t < q for q, t in zip(pw, tw))} of {pairs} pairs; profiled chunks, this - parent: "
              f"wall {diff['wall']:+.4f}, busy {diff['busy']:+.4f}, idle {diff['wall'] - diff['busy']:+.4f} ms/step; "
              f"stages " + ", ".join(f"{k} {v:+.4f}" for k, v in sdiff.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
