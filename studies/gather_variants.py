"""Where the periodic gather's time goes, and the candidate designs, on one
card.  Data: 12b's rows (p3m_bench's periodic box, uniform N = 2,097,152,
box 10, grid 128, Morton-sorted, TSC), 12d's (the same bodies in the
engine's unsorted order, CIC), 8b's (two-galaxy, 2^20 disk bodies a galaxy,
Morton-sorted, isolated TSC) and 8d's (two-galaxy unsorted, isolated CIC),
and 12b's and 12d's rows clipped off the seams with the wrap off; random
grids.  Kernels, each built alone with ``_build.NVCC_FLAGS`` and timed in
turns (three rounds of the list, then the list reversed; CUDA events; the
median of the six):

- ``parent``: the parent commit's ``csrc/mesh_gather.cu`` (the first
  design: a thread a particle, 81 or 24 scalar loads);
- ``loop``: this tree's ``csrc/mesh_gather.cu`` with ``boxes`` = 0 (the
  first design's kernel, which the callers take for unsorted rows);
- ``box1024`` ... ``box3072``: the same file built with
  ``-DNB_GATHER_BOX_CAP`` = 1,024 to 3,072 cells, ``boxes`` = 1 (the run's
  box in shared memory, the loop for a larger box) on every data set: is
  one kernel enough for sorted and unsorted rows alike?  (4,096 cells need
  more than 48 KB of static shared memory.)
- ``static`` and ``float4`` (``studies/gather_variants.cu``): the first
  design with the wrap a compile-time flag, and with one 16-byte load a
  stencil point from an interleaved copy of the grids (the copy timed
  apart, and the cost of stacking the solves' grids that way at M = 128).

Each kernel's output is compared bit for bit with the parent's; the box
kernels' blocks a path are printed, and for each data set the mean count of
128-byte lines a warp's load of one stencil point touches (one grid).

    python3 studies/gather_variants.py [PARENT_CHECKOUT]   # default _chipcheck/parent
"""
import ctypes
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nbody3d_tpu_torch import _build  # noqa: E402
from nbody3d_tpu_torch.models.registry import make_preset  # noqa: E402
from nbody3d_tpu_torch.ops import ewald  # noqa: E402
from nbody3d_tpu_torch.ops import mesh_cuda as mc  # noqa: E402
from nbody3d_tpu_torch.ops import p3m, pm  # noqa: E402
from nbody3d_tpu_torch.state import init_state, pad_count  # noqa: E402

ROOT = pathlib.Path("_chipcheck/studies/gather")
P, I = ctypes.c_void_p, ctypes.c_int
CAPS = (1024, 1536, 2048, 3072)
SRC = pathlib.Path("nbody3d_tpu_torch/csrc/mesh_gather.cu")


def nvcc(src, so, *defines):
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o", str(so), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(parent: str):
    shutil.rmtree(ROOT, ignore_errors=True)
    ROOT.mkdir(parents=True)
    procs = {f"box{cap}": nvcc(SRC, ROOT / f"box{cap}.so", f"-DNB_GATHER_BOX_CAP={cap}") for cap in CAPS}
    procs["parent"] = nvcc(pathlib.Path(parent) / SRC, ROOT / "parent.so")
    procs["study"] = nvcc("studies/gather_variants.cu", ROOT / "study.so")
    libs = {}
    for tag, p in procs.items():
        log = p.communicate()[0]
        regs = re.findall(r"Function properties for (\S+)[\s\S]*?Used (\d+) registers", log)
        print(f"[build] {tag}: rc {p.returncode}, registers {[(n[-40:], r) for n, r in regs]}", flush=True)
        if p.returncode:
            print(log[-3000:], flush=True)
            continue
        lib = ctypes.CDLL(str(ROOT / f"{tag}.so"))
        if tag == "study":
            lib.gather_study.argtypes = [I, P, P, P, P, P, I, I, I, I, P]
        elif tag == "parent":
            lib.nb_mesh_gather.argtypes = [P, P, P, P, I, I, I, I, P]
        else:
            lib.nb_mesh_gather.argtypes = [P, P, P, P, I, I, I, I, I, P, P]
        libs[tag] = lib
    return libs


def data(dev):
    """name: (c4, fm, grid, order, periodic)."""
    grid = 128
    out = {}
    box_np, _, _ = make_preset("uniform-box", seed=0, G=cs.G, n=cs.BOX_N, box_size=cs.BOX_L)
    rows = torch.from_numpy(box_np.astype(np.float32)).to(dev)
    h = torch.tensor(cs.BOX_L / grid, device=dev)
    srt = rows[torch.argsort(p3m.morton_keys(rows, rows.shape[0]), stable=True)].contiguous()
    out["12b TSC"] = (*cs._periodic_cells(srt, h, grid, 3), grid, 3, True)
    out["12d CIC"] = (*cs._periodic_cells(rows, h, grid, 2), grid, 2, True)
    for name, lo, hi in (("12b TSC", 1, grid - 2), ("12d CIC", 0, grid - 2)):
        c4, fm = out[name][:2]
        clipped = c4.clone()
        clipped[:, :3] = clipped[:, :3].clamp(lo, hi)
        out[name + ", wrap off"] = (clipped, fm, grid, out[name][3], False)
    for tag, n, order, sort in (("8b TSC", cs.P3M_N, 3, True), ("8d CIC", cs.PM_N, 2, False)):
        pm_np, vel_np, _ = make_preset("two-galaxy", seed=0, G=cs.G, n=n)
        st = init_state(pm_np, vel_np, n_pad=pad_count(pm_np.shape[0], 256), device=dev)
        ps, n_real = st.pos_mass, pm_np.shape[0]
        if sort:
            ps = ps[torch.argsort(p3m.morton_keys(ps, n_real), stable=True)].contiguous()
        lo, hh = pm._box(ps[:n_real, :3] if sort else st.pos_mass[:n_real, :3], grid)
        cells = p3m._tsc_cells if order == 3 else pm._cic_cells
        out[tag] = (*mc.mesh_operands(*cells(ps[:, :3], lo, hh, grid), ps[:, 3]), grid, order, False)
    return out


def lines_a_load(c4: torch.Tensor, grid: int) -> float:
    """Mean distinct 128-byte lines among a warp's 32 addresses of one
    stencil point of one grid (the base cell)."""
    n = c4.shape[0] // 32 * 32
    c = c4[:n, :3].long()
    line = ((c[:, 0] * grid + c[:, 1]) * grid + c[:, 2]) // 32
    s, _ = torch.sort(line.view(-1, 32), dim=1)
    return float(((s[:, 1:] != s[:, :-1]).sum(1) + 1).double().mean())


def turns(fns: dict, rounds: int = 3) -> dict:
    """Each tag's median device time over ``rounds`` passes of the list and
    as many of the list reversed, and its times."""
    times = {t: [] for t in fns}
    order = list(fns)
    for r in range(2 * rounds):
        for t in (order if r % 2 == 0 else order[::-1]):
            times[t].append(cs.cuda_ms(fns[t], reps=20))
    return {t: (statistics.median(v), v) for t, v in times.items()}


def main():
    parent = sys.argv[1] if len(sys.argv) > 1 else "_chipcheck/parent"
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    libs = build(parent)
    dev = torch.device("cuda", 0)
    strm = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for name, (c4, fm, grid, order, periodic) in data(dev).items():
        n = c4.shape[0]
        grids = torch.randn(3, grid**3, device=dev)
        g4 = torch.zeros(grid**3, 4, device=dev)
        g4[:, :3] = grids.T
        outs, paths = {}, {}

        def call(tag):
            o = outs.setdefault(tag, torch.empty_like(fm))
            args = (grids.data_ptr(), c4.data_ptr(), fm.data_ptr(), o.data_ptr(), n, grid, order, int(periodic))
            if tag == "parent":
                return lambda: libs["parent"].nb_mesh_gather(*args, strm())
            if tag in ("static", "float4"):
                return lambda: libs["study"].gather_study(int(tag == "float4"), grids.data_ptr(), g4.data_ptr(),
                                                          *args[1:], strm())
            p = paths.setdefault(tag, torch.zeros(2, dtype=torch.int32, device=dev))
            lib, boxes = (libs["box2048"], 0) if tag == "loop" else (libs[tag], 1)
            return lambda: lib.nb_mesh_gather(*args, boxes, p.data_ptr(), strm())

        tags = [t for t in ("parent", "loop", *(f"box{c}" for c in CAPS), "static", "float4")
                if t in libs or t == "loop" or (t in ("static", "float4") and "study" in libs)]
        for t in tags:
            call(t)()
        torch.cuda.synchronize()
        same = {t: torch.equal(outs[t], outs["parent"]) for t in tags}
        shares = {t: p.tolist() for t, p in paths.items()}
        got = turns({t: call(t) for t in tags})
        copy_ms = cs.cuda_ms(lambda: g4[:, :3].copy_(grids.T), reps=20)
        print(f"[{name}] n {n}, grid {grid}, order {order}, periodic {periodic}; lines a warp's load "
              f"{lines_a_load(c4, grid):.2f}; the interleaved copy {copy_ms:.4f} ms", flush=True)
        for t in tags:
            med, v = got[t]
            print(f"  {t:8s} {med:.4f} ms (in turns {[round(x, 4) for x in v]}); bit-equal to the parent {same[t]}"
                  + (f"; blocks box/global {shares[t]}" if t in shares else ""), flush=True)
    m = 128
    comps = [torch.randn(m**3, device=dev) for _ in range(3)]
    zero = torch.zeros(m**3, device=dev)
    rho = torch.rand(m, m, m, device=dev)
    t = {
        "stack (3, M^3)": cs.cuda_ms(lambda: torch.stack(comps, dim=0), reps=20),
        "stack (M^3, 4)": cs.cuda_ms(lambda: torch.stack(comps + [zero], dim=1), reps=20),
        "stack (3, M^3) again": cs.cuda_ms(lambda: torch.stack(comps, dim=0), reps=20),
        "spectral_accel_grids": cs.cuda_ms(lambda: ewald.spectral_accel_grids(rho, 10.0, 0.117, order=3), reps=10),
    }
    print("[interleave at M = 128] " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()), flush=True)
    print(cs.nvidia_smi("name,power.limit,clocks.sm,power.draw"), flush=True)


if __name__ == "__main__":
    main()
