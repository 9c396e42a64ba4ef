"""Build and load the port's CUDA kernels.

``load_library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface and loads
it with ``ctypes``.  The library lands in ``nbody3d_tpu_torch/_build/<key>/``
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LIB_NAME = "libnbody3d_kernels.so"

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types; each returns cudaGetLastError() as int.
SIGNATURES = {
    "nb_force_exact": [P, P, P, I, I, F, F, P],
    "nb_sym_diag_prep": [P, P, P, I, I, F, F, P],
    "nb_sym_hops": [P, P, I, I, I, I, I, F, P],
    "nb_sym_epilogue": [P, P, P, P, P, I, I, F, P],
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


def build() -> tuple[pathlib.Path, float]:
    """Compile the library unless a build of these sources exists.
    Returns ``(path, seconds spent compiling)``."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, (p for p in _sources() if p.suffix == ".cu"))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=CSRC)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (out_dir / "build.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
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
