"""``sym_diag_prep`` variants on one card, at the sym path's shape
(uniform-sphere N = 262,144, Morton order, tile 256, eps2 1e-4): the parent
commit's kernel (the first design), this tree's (``csrc/sym_diag_prep.cu``:
float4 rows of a doubled tile, the loop unrolled by 8, the ftz rsqrt) and
copies of it with another unroll, the guarded ``rsqrtf``, the runtime-width
instance or no occupancy bound, and the Newton-3 form of
``studies/sym_diag_n3.cu``; each built alone with ``_build.NVCC_FLAGS`` and
timed in turns (the list, then the list reversed; CUDA events).  Each
output is compared bit for bit with the parent's at eps2 1e-4 and 1e-14
(the Newton-3 form: max-abs over the twin's scale), and each kernel's pair
loop is counted in its SASS (``chip_smoke.pair_loops``): instructions a
pair.

    python3 studies/sym_diag_variants.py [PARENT_CHECKOUT]   # default _chipcheck/parent
"""
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from nbody3d_tpu_torch import _build  # noqa: E402
from nbody3d_tpu_torch.models.registry import make_preset  # noqa: E402
from nbody3d_tpu_torch.ops import cuda_force as cf  # noqa: E402
from nbody3d_tpu_torch.ops.morton import morton_reorder  # noqa: E402
from nbody3d_tpu_torch.state import init_state  # noqa: E402

ROOT = pathlib.Path("_chipcheck/studies/sym_diag")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LOOP = "#pragma unroll 8\n    for (int r = 1; r < b; ++r) {"
BOUND = "__launch_bounds__(threads_for(B), 2048 / threads_for(B))"
VARIANTS = {
    "cur": {},
    "unroll1": {"pair.cuh": [(LOOP, LOOP.replace("unroll 8", "unroll 1"))]},
    "unroll2": {"pair.cuh": [(LOOP, LOOP.replace("unroll 8", "unroll 2"))]},
    "unroll4": {"pair.cuh": [(LOOP, LOOP.replace("unroll 8", "unroll 4"))]},
    "guarded": {"sym_diag_prep.cu": [("sym_pairs::normal_cubes(eps2)", "false")]},
    "runtime": {"sym_diag_prep.cu": [("if (b == kTile)", "if (false)")]},
    "nobound": {"sym_diag_prep.cu": [(BOUND, "__launch_bounds__(threads_for(B))")]},
}


def build(parent: str):
    shutil.rmtree(ROOT, ignore_errors=True)
    ROOT.mkdir(parents=True)
    srcs = {}
    for tag, edits in VARIANTS.items():
        d = ROOT / tag
        shutil.copytree("nbody3d_tpu_torch/csrc", d)
        for name, pairs in edits.items():
            text = (d / name).read_text()
            for old, new in pairs:
                assert old in text, (tag, old)
                text = text.replace(old, new)
            (d / name).write_text(text)
        srcs[tag] = d / "sym_diag_prep.cu"
    srcs["parent"] = pathlib.Path(parent) / "nbody3d_tpu_torch/csrc/sym_diag_prep.cu"
    srcs["n3"] = pathlib.Path("studies/sym_diag_n3.cu")
    procs = {t: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(ROOT / f"{t}.so"),
                                  str(s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for t, s in srcs.items()}
    libs = {}
    for t, p in procs.items():
        log = p.communicate()[0]
        regs = re.findall(r"Function properties for (\S+)[\s\S]*?Used (\d+) registers[^\n]*", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {t}: rc {p.returncode}, registers {[(n[-48:], r) for n, r in regs]}, spill stores {spills}",
              flush=True)
        if p.returncode:
            print(log[-3000:], flush=True)
            continue
        lib = ctypes.CDLL(str(ROOT / f"{t}.so"))
        lib.nb_sym_diag_prep.argtypes = [P, P, P, I, I, F, F, P]
        libs[t] = lib
        for name, listing in cs.sass_listing(ROOT / f"{t}.so").items():
            for raw in cs.pair_loops(listing):
                ops = cs._op_counts(raw)
                n, pairs = sum(ops.values()), ops.get("MUFU", 0)
                print(f"  [sass] {t} {name[-60:]}: pair loop {n} instructions, {pairs} MUFU ({n / max(pairs, 1):.2f} "
                      "a MUFU): " + ", ".join(f"{o} {c}" for o, c in sorted(ops.items(), key=lambda kv: -kv[1])),
                      flush=True)
    return libs


def main():
    parent = sys.argv[1] if len(sys.argv) > 1 else "_chipcheck/parent"
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    libs = build(parent)
    dev = torch.device("cuda", 0)
    n, b = 262144, 256
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=cs.G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    pm = morton_reorder(st.pos_mass, st.vel, st.accel, n_real=n)[0]
    pm[n // 3, 3] = 1e7  # a heavy body among light ones
    strm = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    outs = {t: (torch.empty_like(pm), torch.empty_like(pm)) for t in libs}

    def call(t, eps2):
        s, a = outs[t]
        return lambda: libs[t].nb_sym_diag_prep(pm.data_ptr(), s.data_ptr(), a.data_ptr(), n // b, b, cs.G, eps2,
                                                strm())

    for eps2 in (1e-4, 1e-14):
        want = {}
        for t in libs:
            call(t, eps2)()
            torch.cuda.synchronize()
            want[t] = outs[t][1].clone()
        twin = cf.sym_diag_prep_plain(pm, cs.G, eps2, b)[1]
        for t in libs:
            print(f"  eps2 {eps2:g} {t}: bit-equal to the parent {torch.equal(want[t], want['parent'])}, "
                  f"max-abs/scale against the twin {cs.rel_err(want[t], twin):.3e}", flush=True)
    tags = list(libs)
    first = {t: cs.cuda_ms(call(t, 1e-4), reps=20) for t in tags}
    second = {t: cs.cuda_ms(call(t, 1e-4), reps=20) for t in reversed(tags)}
    for t in tags:
        print(f"  {t:8s} {(first[t] + second[t]) / 2:.4f} ms (in turns {first[t]:.4f} / {second[t]:.4f})", flush=True)
    print(cs.nvidia_smi("name,power.limit,clocks.sm,power.draw"), flush=True)


if __name__ == "__main__":
    main()
