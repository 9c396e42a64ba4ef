"""Throughput of the exact kernels' instruction mix on one card: MUFU.RSQ
alone, FFMA alone, and 12 FFMA + 1 MUFU.RSQ a step (``exact_micro.cu``),
every SM full of warps, timed by CUDA events.  Prints each rate a second and
an SM a clock at the H100's 1,980 MHz (the clock nvidia-smi reads under
the exact kernels' load).

    python3 studies/exact_micro.py      # from the repo root, on the card
"""
import ctypes
import pathlib
import subprocess
import sys

sys.path.insert(0, ".")
from nbody3d_tpu_torch import _build  # noqa: E402

OUT = pathlib.Path("_chipcheck/studies")
SMS, CLOCK = 132, 1.98e9


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "exact_micro.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), "studies/exact_micro.cu"],
                       capture_output=True, text=True)
    print(r.returncode, r.stdout[-1500:], r.stderr[-1500:], flush=True)
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)]
    for which, name in ((0, "MUFU.RSQ"), (1, "FFMA"), (2, "12 FFMA + 1 MUFU")):
        for blocks_per_sm, threads in ((8, 256), (4, 128), (16, 128)):
            iters = 20000 if which != 2 else 2000
            ms, cyc = ctypes.c_float(), ctypes.c_double()
            rc = lib.run(which, SMS * blocks_per_sm, threads, iters, ctypes.byref(ms), ctypes.byref(cyc))
            rate = SMS * blocks_per_sm * threads * iters * 8 / (ms.value * 1e-3)  # 8 chains a thread
            print(f"{name} {blocks_per_sm} blocks x {threads} an SM: rc {rc} {ms.value:.3f} ms, {rate:.4e} a second, "
                  f"{rate / SMS / CLOCK:.2f} an SM a clock at 1980 MHz", flush=True)


if __name__ == "__main__":
    main()
