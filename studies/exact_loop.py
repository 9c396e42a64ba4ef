"""Schedules of the exact loop: ``csrc/exact.cuh``'s source loop as it is
("cur"), in phases of 4 or 8 sources (d2 and the rsqrts first, then the
sums) and with the next source read a step ahead, both kernels built alone
for each, timed in turns at two-galaxy n_pad 40,192 and uniform-sphere
262,144 (exact_split's S), bits compared with "cur"; each variant's
``force_exact`` SASS goes to ``chiprun_out/sass_<variant>_force_exact.txt``.

    python3 studies/exact_loop.py
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
from nbody3d_tpu_torch.ops.launch import exact_split  # noqa: E402
from nbody3d_tpu_torch.ops.morton import morton_reorder  # noqa: E402
from nbody3d_tpu_torch.state import init_state  # noqa: E402

ROOT = pathlib.Path("_chipcheck/studies/loop")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
CUR = """#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
            const float4 p = tile[j];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const float dx = p.x - me[r].x;
                const float dy = p.y - me[r].y;
                const float dz = p.z - me[r].z;
                const float w = p.w * (kNormal ? pair_inv3_normal(dx, dy, dz, eps2) : pair_inv3(dx, dy, dz, eps2));
                tx[r] = fmaf(w, dx, tx[r]);
                ty[r] = fmaf(w, dy, ty[r]);
                tz[r] = fmaf(w, dz, tz[r]);
            }
        }"""
PHASES = """#pragma unroll 1
        for (int j = 0; j < kTile; j += 4) {
            float4 p[4];
            float dx[4][kRows], dy[4][kRows], dz[4][kRows], iv[4][kRows];
#pragma unroll
            for (int q = 0; q < 4; ++q) p[q] = tile[j + q];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    dx[q][r] = p[q].x - me[r].x;
                    dy[q][r] = p[q].y - me[r].y;
                    dz[q][r] = p[q].z - me[r].z;
                    iv[q][r] = kNormal ? pair_inv3_normal(dx[q][r], dy[q][r], dz[q][r], eps2)
                                       : pair_inv3(dx[q][r], dy[q][r], dz[q][r], eps2);
                }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    const float w = p[q].w * iv[q][r];
                    tx[r] = fmaf(w, dx[q][r], tx[r]);
                    ty[r] = fmaf(w, dy[q][r], ty[r]);
                    tz[r] = fmaf(w, dz[q][r], tz[r]);
                }
        }"""
PREFETCH = """        float4 p = tile[0];
#pragma unroll 4
        for (int j = 0; j < kTile; ++j) {
            const float4 pn = tile[(j + 1) & (kTile - 1)];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const float dx = p.x - me[r].x;
                const float dy = p.y - me[r].y;
                const float dz = p.z - me[r].z;
                const float w = p.w * (kNormal ? pair_inv3_normal(dx, dy, dz, eps2) : pair_inv3(dx, dy, dz, eps2));
                tx[r] = fmaf(w, dx, tx[r]);
                ty[r] = fmaf(w, dy, ty[r]);
                tz[r] = fmaf(w, dz, tz[r]);
            }
            p = pn;
        }"""
VARIANTS = {"cur": CUR, "phases": PHASES, "prefetch": PREFETCH, "phases8": PHASES.replace("j += 4", "j += 8")
            .replace("[4]", "[8]").replace("q < 4", "q < 8")}


def build(tag, body):
    d = ROOT / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree("nbody3d_tpu_torch/csrc", d)
    h = (d / "exact.cuh").read_text()
    assert CUR in h
    (d / "exact.cuh").write_text(h.replace(CUR, body))
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(ROOT / f"{tag}_{k}.so"),
                               str(d / f"{k}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k in ("force_exact", "fused_exact")]
    return procs


def main():
    procs = {t: build(t, b) for t, b in VARIANTS.items()}
    libs = {}
    for t, ps in procs.items():
        logs = [p.communicate()[0] for p in ps]
        print(t, [p.returncode for p in ps], [re.findall(r"Used (\d+) registers", lg) for lg in logs], flush=True)
        if any(p.returncode for p in ps):
            print(logs[0][-2000:], logs[1][-2000:])
            continue
        f = ctypes.CDLL(str(ROOT / f"{t}_force_exact.so"))
        f.nb_force_exact.argtypes = [P, P, P, I, I, F, F, I, P]
        u = ctypes.CDLL(str(ROOT / f"{t}_fused_exact.so"))
        u.nb_fused_step_exact.argtypes = [P, P, P, P, P, P, I, I, F, F, F, I, P]
        libs[t] = (f, u)
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(ROOT / f"{t}_force_exact.so")],
                              capture_output=True, text=True).stdout
        pathlib.Path("chiprun_out").mkdir(exist_ok=True)
        pathlib.Path(f"chiprun_out/sass_{t}_force_exact.txt").write_text(sass)
    dev = torch.device("cuda", 0)
    st, n_real = cs._two_galaxy(dev)
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=1e-4, n=262144)
    sph = init_state(pm_np, vel_np, n_pad=262144, device=dev)
    big = morton_reorder(sph.pos_mass, sph.vel, sph.accel, n_real=262144)
    for name, pm, vel, nr, reps in (("two-galaxy", st.pos_mass, st.vel, n_real, 20),
                                    ("sphere", big[0], big[1], 262144, 3)):
        n = pm.shape[0]
        s = exact_split(n, n)
        aold = torch.zeros_like(pm)
        outs = {t: tuple(torch.empty_like(pm) for _ in range(4)) for t in libs}
        strm = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        def force(t):
            o = outs[t]
            return lambda: libs[t][0].nb_force_exact(pm.data_ptr(), pm.data_ptr(), o[3].data_ptr(), n, n, 1e-4, 1e-4,
                                                     s, strm())

        def fused(t):
            o = outs[t]
            return lambda: libs[t][1].nb_fused_step_exact(pm.data_ptr(), vel.data_ptr(), aold.data_ptr(),
                                                          o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(), n, nr,
                                                          1e-3, 1e-4, 1e-4, s, strm())
        for t in libs:
            force(t)()
            fused(t)()
        torch.cuda.synchronize()
        for t in libs:
            eq = torch.equal(outs[t][3], outs["cur"][3]) and all(torch.equal(a, b) for a, b in
                                                                 zip(outs[t][:3], outs["cur"][:3]))
            print(f"  {name} {t}: bit-equal to cur {eq}", flush=True)
        tags = list(libs)
        for kind, fn in (("force", force), ("fused", fused)):
            ms = {t: [] for t in tags}
            for _ in range(2):
                for t in tags + tags[::-1]:
                    ms[t].append(cs.cuda_ms(fn(t), reps=reps))
            print(f"{name} n {n} S {s} {kind}: " + ", ".join(
                f"{t} {sum(v) / len(v):.4f} ({min(v):.4f}-{max(v):.4f})" for t, v in ms.items()), flush=True)


if __name__ == "__main__":
    main()
