"""Build and load the port's CUDA kernels.

``load_library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, links
the objects into one shared library with a plain C interface and loads it
with ``ctypes``.  The library lands in ``nbody3d_tpu_torch/_build/<key>/``
where ``key`` hashes the sources and the flags, so an edited source builds
anew and an unchanged one is reused.  Nothing is built at import time: the
first kernel launch builds.  A missing ``nvcc`` or a failed build raises
with the compiler's output; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LIB_NAME = "libnbody3d_kernels.so"

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types; each returns cudaGetLastError() as int.
SIGNATURES = {
    "nb_force_exact": [P, P, P, I, I, F, F, I, P],
    "nb_sym_diag_prep": [P, P, P, I, I, F, F, P],
    "nb_sym_hops": [P, P, I, I, I, I, I, I, F, P],
    "nb_sym_epilogue": [P, P, P, P, P, I, I, F, P],
    "nb_sym_diag": [P, P, I, I, F, P],
    "nb_sym_combine": [P, P, P, I, P],
    "nb_pair_sym": [P, P, P, P, I, I, I, I, F, F, P],
    "nb_fused_step_exact": [P, P, P, P, P, P, I, I, F, F, F, I, P],
    "nb_force_fast": [P, P, P, P, I, I, F, I, I, I, P],
    "nb_fused_step_fast": [P, P, P, P, P, P, P, I, I, F, F, P],
    "nb_vjp_full": [P, P, P, P, I, F, F, I, P],
    "nb_vjp_sym_diag": [P, P, P, I, I, F, P],
    "nb_vjp_sym_hops": [P, P, P, I, I, I, I, I, I, F, P],
    "nb_vjp_combine": [P, P, P, P, I, F, P],
    "nb_splat_resolve": [P, P, P, P, P, P, P, I, I, I, P],
    "nb_short_range": [P, P, P, P, P, P, I, I, I, F, F, P],
    "nb_short_range_bwd": [P, P, P, P, P, P, P, P, I, I, I, F, F, P],
    "nb_mesh_deposit": [P, P, P, I, I, I, I, P, P],
    "nb_mesh_gather": [P, P, P, P, I, I, I, I, I, P, P],
}


def _sources() -> list[pathlib.Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "nbody3d_tpu_torch cannot be built"
    )


def _run(cmds: list[list[str]]) -> tuple[bool, str]:
    """Run the commands in parallel; ``(all succeeded, their output)``."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=CSRC)
        for c in cmds
    ]
    log, ok = [], True
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        ok &= proc.returncode == 0
        log.append(f"$ {' '.join(cmd)}\n{out}" + ("" if proc.returncode == 0 else f"(exit {proc.returncode})\n"))
    return ok, "".join(log)


def build() -> tuple[pathlib.Path, float]:
    """Compile the library unless a build of these sources exists.
    Returns ``(path, seconds spent compiling)``."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    sources = [p for p in _sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in sources]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    t0 = time.perf_counter()
    ok, log = _run([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)])
    if ok:
        ok, link_log = _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]])
        log += link_log
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if not ok:
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, lib)
    return lib, seconds


def build_log() -> str:
    """The compiler output of the current build (ptxas register and
    shared-memory lines), or '' before the first build."""
    p = BUILD_ROOT / _key() / "build.log"
    return p.read_text() if p.exists() else ""


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
