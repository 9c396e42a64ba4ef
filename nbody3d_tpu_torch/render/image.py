"""Frame output: PNG written with the standard library, and raw NPY dumps.

The port's counterpart of ``nbody3d_tpu/render/image.py``, which writes
PNG through PIL.  The port needs no PIL: :func:`save_png` builds the file
from ``zlib`` and ``struct`` (8-bit RGB, one filter byte 0 a row), and
:func:`read_png` decodes the files it writes.  ``save_animation`` (GIF
through PIL) waits for the port's ``animate`` command.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def save_png(path: str, img: np.ndarray, *, level: int = 6) -> None:
    """Write an (H, W, 3) uint8 array as PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"save_png: expected an (H, W, 3) array, got {img.shape}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), dtype=np.uint8)  # filter byte 0 (None) per row
    rows[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolour
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Decode a PNG that :func:`save_png` wrote (8-bit RGB, non-interlaced,
    filter 0 on every row) to (H, W, 3) uint8; raises on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"read_png: {path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"read_png: {path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"read_png: only 8-bit RGB, non-interlaced (got depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"read_png: {path} uses row filters other than 0")
    return raw[:, 1:].reshape(h, w, 3).copy()


def save_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img))
