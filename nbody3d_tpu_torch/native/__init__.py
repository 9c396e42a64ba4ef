"""The port's host C code and its ctypes wrappers.

Each ``native/<name>.c`` is plain C with no Python headers, built with the
host C compiler (``$CC``, default ``cc``) at first use into
``nbody3d_tpu_torch/_build/`` by :func:`nbody3d_tpu_torch._build.load_host_library`.
Nothing is built at import time, and a failed build raises with the
compiler's output: no caller falls back to a Python loop.

- ``_raster.c``: :func:`stamp_discs`, the disc stamp of the ``host`` frame
  and of the quantized frame's large splats (``render/``).
- ``_fastjson.c``: :func:`dumps_f32` and :func:`scan_f32`, the float32 JSON
  codec of reference-schema checkpoints (``utils/checkpoint.py``).
- ``_fof.c`` (``analysis.py``) and ``_image.c`` (``render/jpeg.py``,
  ``render/image.py``) are wrapped where they are used.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def _fn(lib: str, name: str, argtypes: tuple, restype):
    from nbody3d_tpu_torch._build import load_host_library

    fn = getattr(load_host_library(lib), name)
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def _pointer(a, dtypes: tuple, name: str, n: int | None = None) -> tuple[int, int]:
    """``(address, length)`` of a 1-D contiguous CPU tensor or numpy array
    of one of ``dtypes`` (numpy dtype names), of length ``n`` if given."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name} must lie on the CPU, got {a.device}")
        dtype, contiguous, addr = str(a.dtype).removeprefix("torch."), a.is_contiguous(), a.data_ptr()
    elif isinstance(a, np.ndarray):
        dtype, contiguous, addr = a.dtype.name, a.flags.c_contiguous, a.ctypes.data
    else:
        raise TypeError(f"{name} must be a torch tensor or a numpy array, got {type(a).__name__}")
    if dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(dtypes)}, got {dtype}")
    if a.ndim != 1 or not contiguous:
        raise ValueError(f"{name} must be 1-D and contiguous, got shape {tuple(a.shape)}")
    if n is not None and a.shape[0] != n:
        raise ValueError(f"{name} must have length {n}, got {a.shape[0]}")
    return addr, a.shape[0]


# ------------------------------------------------------------- _raster.c
def stamp_discs(buf, height: int, width: int, cx, cy, r, keys) -> None:
    """Min-reduce each splat's word into the pixels of its disc, in place:
    ``buf`` the ``(H * W,)`` framebuffer of uint64 words (uint64, or int64
    holding them bit for bit: where every word is below 2^63, as the
    quantized frame's are, int64 order is their order); ``cx``/``cy`` int64
    centre pixels, ``r`` float64 radii, ``keys`` the splats' words (uint64
    or int64).  All on the CPU.  The disc is the pixels ``(cx + dx, cy + dy)``
    in the frame with ``|dy| <= floor(r)`` and ``dx^2 + dy^2 <= r^2`` in
    float64 (``native/_raster.c``)."""
    if height <= 0 or width <= 0:
        raise ValueError(f"stamp_discs: frame {width}x{height} out of range")
    if isinstance(buf, torch.Tensor) and buf.requires_grad:
        raise RuntimeError("stamp_discs: buf requires grad")
    if isinstance(buf, np.ndarray) and not buf.flags.writeable:
        raise ValueError("stamp_discs: buf is read-only")
    pb, _ = _pointer(buf, ("uint64", "int64"), "stamp_discs: buf", height * width)
    pcx, n = _pointer(cx, ("int64",), "stamp_discs: cx")
    pcy, _ = _pointer(cy, ("int64",), "stamp_discs: cy", n)
    pr, _ = _pointer(r, ("float64",), "stamp_discs: r", n)
    pk, _ = _pointer(keys, ("uint64", "int64"), "stamp_discs: keys", n)
    finite = torch.isfinite(r).all() if isinstance(r, torch.Tensor) else np.isfinite(r).all()
    if not finite:
        raise ValueError("stamp_discs: every radius must be finite")
    if n:
        _fn("_raster", "nb_stamp_discs", (_P, _I64, _I64, _P, _P, _P, _P, _I64), None)(
            pb, height, width, pcx, pcy, pr, pk, n)


# ----------------------------------------------------------- _fastjson.c
_LOCALE = "the float32 JSON codec needs a '.'-decimal LC_NUMERIC locale (%.9g and strtod read it)"


def dumps_f32(arr) -> bytes:
    """The JSON array ``[a, b, ...]`` of a finite float32 array's values in
    C order, each ``%.9g`` (nine significant digits give every float32 back
    exactly), with ``json.dump``'s ``", "`` separators: the JAX package's
    ``native.dumps_f32`` bytes.  Raises for a non-finite value, whose JSON
    spelling is ``json.dump``'s (``NaN``, ``Infinity``)."""
    a = np.ascontiguousarray(arr, dtype="<f4").reshape(-1)
    if not np.isfinite(a).all():
        raise ValueError("dumps_f32: the array holds a value that is not finite")
    cap = 17 * a.size + 2  # "%.9g" of a float32 is at most 15 bytes, then ", "
    out = np.empty(cap, np.uint8)
    got = _fn("_fastjson", "nb_dumps_f32", (_P, _I64, _P, _I64), _I64)(a.ctypes.data, a.size, out.ctypes.data, cap)
    if got == -2:
        raise RuntimeError(_LOCALE)
    if got < 0:
        raise RuntimeError(f"dumps_f32: the C codec failed ({got}) on {a.size} values in {cap} bytes")
    return out[:got].tobytes()


def scan_f32(raw: bytes, start: int) -> tuple[np.ndarray, int] | None:
    """Parse the JSON number array at ``raw[start] == '['`` (whitespace
    before it skipped): ``(float32 array, index one past its ']')``, each
    number read by ``strtod`` and rounded once to float32 as the JAX
    package's scanner does, or None where that scanner rejects the array."""
    if not isinstance(raw, bytes):
        raw = bytes(raw)  # the C scanner relies on the NUL after a bytes object's data
    fn = _fn("_fastjson", "nb_scan_f32", (ctypes.c_char_p, _I64, _I64, _P, _I64, _P), _I64)
    close = raw.find(b"]", start)
    cap = raw.count(b",", start, close) + 1 if close >= 0 else 0
    end = ctypes.c_int64(0)
    while True:
        out = np.empty(cap, np.float32)
        got = fn(raw, len(raw), start, out.ctypes.data, cap, ctypes.byref(end))
        if got == -2:
            raise RuntimeError(_LOCALE)
        if got < 0:
            return None
        if got <= cap:
            return out[:got], end.value
        cap = got  # numbers not separated by commas: scan again with room for all
