"""Layouts of ``force_exact``'s loop: ``csrc/exact.cuh`` copied with other
rows a thread (kRows) and unrolls of the source loop, ``force_exact.cu``
built alone for each, timed in turns with a parent checkout's kernel (its
C signature has no split) at two-galaxy n_pad 40,192 (every S from 1 to 8)
and uniform-sphere 262,144 (the S values given), with nvidia-smi's clock
and power sampled through the sphere's timings.  Each variant at S = 1 is
checked bit for bit against the parent, and at 40,192 against the twin.

    python3 studies/exact_rows.py [SPHERE_SPLITS, e.g. 1,2,4] [PARENT_DIR]
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

G, EPS2 = 1e-4, 1e-4
ROOT = pathlib.Path("_chipcheck/studies/rows")
# rows a thread, unroll
VARIANTS = {"r4u4": (4, 4), "r4u8": (4, 8), "r4u2": (4, 2), "r2u8": (2, 8), "r2u4": (2, 4), "r2u2": (2, 2),
            "r1u8": (1, 8), "r1u4": (1, 4), "r8u2": (8, 2), "r8u1": (8, 1)}
SPHERE_SPLITS = tuple(int(x) for x in (sys.argv[1] if len(sys.argv) > 1 else "1").split(","))
PARENT = pathlib.Path(sys.argv[2] if len(sys.argv) > 2 else "_chipcheck/parent")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def sources(tag, rows, unroll):
    d = ROOT / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree("nbody3d_tpu_torch/csrc", d)
    h = (d / "exact.cuh").read_text()
    h, k1 = re.subn(r"constexpr int kRows = \d+;", f"constexpr int kRows = {rows};", h)
    h, k2 = re.subn(r"#pragma unroll 4\n(\s+for \(int j = 0)", rf"#pragma unroll {unroll}\n\1", h)
    assert k1 == 1 and k2 == 1, (k1, k2)
    (d / "exact.cuh").write_text(h)
    return d


def main():
    procs = {}
    nvcc = _build._nvcc()
    dirs = {tag: sources(tag, *v) for tag, v in VARIANTS.items()}
    dirs["parent"] = PARENT / "nbody3d_tpu_torch" / "csrc"
    for tag, d in dirs.items():
        out = ROOT / f"{tag}.so"
        procs[tag] = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(out), str(d / "force_exact.cu")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tag, p in procs.items():
        log = p.communicate()[0]
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{tag}: rc {p.returncode} registers {regs} spill stores {spills}", flush=True)
        if p.returncode:
            print(log[-3000:])
            continue
        lib = ctypes.CDLL(str(ROOT / f"{tag}.so"))
        lib.nb_force_exact.argtypes = [P, P, P, I, I, F, F, P] if tag == "parent" else [P, P, P, I, I, F, F, I, P]
        lib.nb_force_exact.restype = I
        libs[tag] = lib
    dev = torch.device("cuda", 0)
    st, _ = cs._two_galaxy(dev)
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=262144)
    sph = init_state(pm_np, vel_np, n_pad=262144, device=dev)
    big = morton_reorder(sph.pos_mass, sph.vel, sph.accel, n_real=262144)[0]
    for name, pm, splits, reps in (("two-galaxy", st.pos_mass, range(1, 9), 20), ("sphere", big, SPHERE_SPLITS, 3)):
        n = pm.shape[0]
        out = torch.empty_like(pm)
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        def call(tag, s, eps2=EPS2):
            if tag == "parent":
                return lambda: libs[tag].nb_force_exact(pm.data_ptr(), pm.data_ptr(), out.data_ptr(), n, n, G, eps2,
                                                        stream())
            return lambda: libs[tag].nb_force_exact(pm.data_ptr(), pm.data_ptr(), out.data_ptr(), n, n, G, eps2, s,
                                                    stream())

        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader", "-lms",
                                "500"], stdout=subprocess.PIPE, text=True) if n > 100000 else None
        call("parent", 1)()
        ref = out.clone()
        twin = cf.force_exact_plain(pm, pm, G, EPS2) if n < 100000 else None
        tags = [t for t in libs if t != "parent"]
        for s in splits:
            for t in tags:
                assert call(t, s)() == 0
                torch.cuda.synchronize()
                eq = torch.equal(out, ref)
                err = cs.rel_err(out, twin) if twin is not None else float("nan")
                if s == 1 and not eq:
                    print(f"  {name} {t} S={s}: NOT bit-equal to the parent (err vs twin {err:.3e})")
                if twin is not None and err >= 1e-5:
                    print(f"  {name} {t} S={s}: err vs twin {err:.3e} >= 1e-5")
            order = ["parent"] + tags + tags[::-1] + ["parent"]
            ms = {}
            for t in order:
                ms.setdefault(t, []).append(cs.cuda_ms(call(t, s), reps=reps))
            print(f"{name} n {n} S={s}: " + ", ".join(f"{t} {sum(v) / len(v):.4f}" for t, v in ms.items()), flush=True)
        if smi:
            smi.terminate()
            samples = smi.communicate()[0].split("\n")
            print(f"  nvidia-smi during the sphere timings: {samples[::4]}", flush=True)
        # The guarded rsqrtf (eps2 = 1e-14) beside the ftz one, 4 rows and the parent.
        for t in ("parent", "r4u4"):
            g = [cs.cuda_ms(call(t, splits[0] if t == "parent" else (1 if n > 100000 else 5), e), reps=reps)
                 for e in (1e-14, EPS2, EPS2, 1e-14)]
            print(f"  {name} {t}: eps2 1e-14 {g[0]:.4f}/{g[3]:.4f}, eps2 1e-4 {g[1]:.4f}/{g[2]:.4f}", flush=True)


if __name__ == "__main__":
    main()
