"""``fused_step_exact``'s epilogue: the ``__ldcv`` reload of the row
against a plain load (``csrc/fused_exact.cu`` copied and edited), each
built alone, timed in turns at two-galaxy n_pad 40,192 and uniform-sphere
262,144 (exact_split's S), bits compared, ptxas's registers printed.

    python3 studies/exact_reload.py
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

ROOT = pathlib.Path("_chipcheck/studies/reload")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(tag, edit):
    d = ROOT / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree("nbody3d_tpu_torch/csrc", d)
    src = (d / "fused_exact.cu").read_text()
    new = edit(src)
    (d / "fused_exact.cu").write_text(new)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(ROOT / f"{tag}.so"),
                        str(d / "fused_exact.cu")], capture_output=True, text=True)
    print(tag, r.returncode, re.findall(r"Used (\d+) registers", r.stdout + r.stderr), flush=True)
    lib = ctypes.CDLL(str(ROOT / f"{tag}.so"))
    lib.nb_fused_step_exact.argtypes = [P, P, P, P, P, P, I, I, F, F, F, I, P]
    return lib


def main():
    libs = {"ldcv": build("ldcv", lambda s: s),
            "plain": build("plain", lambda s: s.replace("__ldcv(pm + row)", "pm[row]"))}
    assert "__ldcv(pm + row)" in (ROOT / "ldcv" / "fused_exact.cu").read_text()
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
        outs = {t: tuple(torch.empty_like(pm) for _ in range(3)) for t in libs}

        def call(t):
            o = outs[t]
            return lambda: libs[t].nb_fused_step_exact(pm.data_ptr(), vel.data_ptr(), aold.data_ptr(), o[0].data_ptr(),
                                                       o[1].data_ptr(), o[2].data_ptr(), n, nr, 1e-3, 1e-4, 1e-4, s,
                                                       torch.cuda.current_stream().cuda_stream)
        for t in libs:
            call(t)()
        torch.cuda.synchronize()
        eq = all(torch.equal(a, b) for a, b in zip(outs["ldcv"], outs["plain"]))
        ms = {t: [] for t in libs}
        for _ in range(3):
            for t in ("ldcv", "plain", "plain", "ldcv"):
                ms[t].append(cs.cuda_ms(call(t), reps=reps))
        print(f"{name} n {n} S {s}: bit-equal {eq}; " + ", ".join(
            f"{t} {sum(v) / len(v):.4f} ({min(v):.4f}-{max(v):.4f})" for t, v in ms.items()), flush=True)


if __name__ == "__main__":
    main()
