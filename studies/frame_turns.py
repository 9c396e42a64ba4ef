"""The one-device ``auto`` frame in turns: the parent commit's package and
this tree's, on one card, in pairs of runs alternating which tree goes
first (parent, this, this, parent, ...), each run in a process of its own
with that tree first on ``sys.path``.
Frames: serve's two-galaxy N = 40,002 at 960x720 (the preset's camera) and
``chip_smoke.py`` 7c's N = 500,010 at 1920x1080 (``render_scene(500_010,
0)``, camera radius 5).  Each run warms up, then takes
``Simulation.render_frame`` (prep, ``splat_resolve``, image, copy to the
host; host clock, synced by the copy) 30 times and the pipelined begin
alone (host clock, not synced: the host's enqueue) 30 times; it prints the
medians, the frame's device launches and copies in one profiled frame,
and the frame's CRC (the trees' frames must agree).  The summary gives
each tree's medians over its runs and this tree's less the parent's,
paired by pair.

    python3 studies/frame_turns.py PARENT_CHECKOUT [PAIRS]   # default 3 pairs
"""
import json
import pathlib
import statistics
import subprocess
import sys

RUN = r"""
import json, statistics, sys, time, zlib
sys.path.insert(0, TREE)
import numpy as np
import torch
import nbody3d_tpu_torch
from nbody3d_tpu_torch import SimConfig, Simulation
from nbody3d_tpu_torch.models.registry import make_preset
from nbody3d_tpu_torch.utils.camera import Camera
assert nbody3d_tpu_torch.__file__.startswith(TREE), nbody3d_tpu_torch.__file__
dev = torch.device("cuda", 0)

def scene(n, seed):
    rng = np.random.default_rng(seed)
    pm = np.concatenate([rng.normal(scale=2.5, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)
    pm[:2, 3] = 1e7
    return pm, rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)

cfg = SimConfig()
pm, vel, target = make_preset("two-galaxy", seed=cfg.seed, G=cfg.G, size_factor=cfg.size_factor)
frames = {"two-galaxy 960x720": (Simulation(cfg, pm, vel, device=dev), Camera(target=target), 960, 720),
          "500,010 1920x1080": (Simulation(cfg, *scene(500_010, 0), device=dev),
                                Camera(target=np.zeros(3), radius=5.0), 1920, 1080)}
out = {}
for name, (sim, cam, w, h) in frames.items():
    frame = dict(camera=cam, width=w, height=h)
    for _ in range(5):
        img = sim.render_frame(**frame)
    t = []
    for _ in range(30):
        t0 = time.perf_counter()
        sim.render_frame(**frame)
        t.append((time.perf_counter() - t0) * 1e3)
    enq = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = sim.render_frame_begin(cam, width=w, height=h)
        enq.append((time.perf_counter() - t0) * 1e3)
        sim.render_frame_finish(handle)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.render_frame(**frame)
        torch.cuda.synchronize()
    ev = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum("memcpy" in e.lower() for e in ev)
    out[name] = {"frame_ms": statistics.median(t), "begin_ms": statistics.median(enq),
                 "kernels": len(ev) - copies, "copies": copies, "crc": zlib.crc32(img.tobytes())}
print("RESULT " + json.dumps(out), flush=True)
"""


def run(tree: pathlib.Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", f"TREE = {str(tree)!r}\n" + RUN], capture_output=True, text=True,
                          timeout=600)
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    if proc.returncode or not line:
        sys.exit(f"run of {tree} failed (rc {proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(line[0][len("RESULT "):])


def main() -> None:
    parent = pathlib.Path(sys.argv[1]).resolve()
    pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    this = pathlib.Path(__file__).resolve().parents[1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    got = {"parent": [], "this": []}
    for p in range(pairs):
        order = ("parent", "this") if p % 2 == 0 else ("this", "parent")
        for who in order:
            r = run(parent if who == "parent" else this)
            got[who].append(r)
            print(f"pair {p} {who}: {json.dumps(r)}", flush=True)
    print(f"card: {card}")
    for name in got["this"][0]:
        crcs = {r[name]["crc"] for rs in got.values() for r in rs}
        for key in ("frame_ms", "begin_ms"):
            med = {who: statistics.median(r[name][key] for r in rs) for who, rs in got.items()}
            diff = [t[name][key] - q[name][key] for t, q in zip(got["this"], got["parent"])]
            print(f"{name} {key}: parent {med['parent']:.4f}, this {med['this']:.4f}, this - parent by pair "
                  f"{[round(d, 4) for d in diff]} (median {statistics.median(diff):+.4f})")
        launches = {who: (rs[0][name]["kernels"], rs[0][name]["copies"]) for who, rs in got.items()}
        print(f"{name}: a frame's (kernels, copies) parent {launches['parent']}, this {launches['this']}; "
              f"frames {'equal' if len(crcs) == 1 else 'DIFFER'} across trees")


if __name__ == "__main__":
    main()
