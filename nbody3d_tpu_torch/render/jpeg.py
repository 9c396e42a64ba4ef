"""Baseline JPEG encoder of the port's own: the viewer's frames without PIL.

The JAX package's viewer encodes its frames with PIL (``viewer.py``);
the card's machine has no image library, so the port writes the file
itself (ITU T.81, baseline sequential, JFIF):

- colour: RGB to JFIF YCbCr, then 4:2:0 (each chroma sample the mean of
  a 2x2 block), the frame padded to whole 16x16 MCUs by repeating its
  last row and column;
- the 8x8 DCT (the orthonormal DCT-II, which is T.81's FDCT) and the
  quantisation (rounded half away from zero) in numpy, as float32 matrix
  products;
- the tables of Annex K: K.1/K.2 quantisation scaled by quality as
  libjpeg scales them (``jpeg_quality_scaling``, clamped to 1-255) and the
  K.3 Huffman tables;
- zig-zag, run lengths and the Huffman bit packing in a C core,
  ``native/_image.c`` (``nb_jpeg_scan``), built by
  ``_build.load_host_library`` at first use; a failed build raises.
  :func:`scan_python` is its plain twin: the same bytes.

:func:`encode_jpeg` returns the file's bytes, SOI to EOI.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

# Annex K.1 / K.2 quantisation tables, natural (row-major) order.
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32),
], np.int64)

# ZIGZAG[k] is the natural index of the k-th coefficient in zig-zag order.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# Annex K.3 Huffman tables: (code counts by length 1-16, symbols).
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a"
    "3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a929394"
    "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8"
    "e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728"
    "292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92"
    "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7"
    "e8e9eaf2f3f4f5f6f7f8f9fa"))
HUFFMAN = (_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA)  # the C core's table order


def quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """The luma and chroma tables at ``quality`` (1-100), natural order:
    libjpeg's scaling (5000 / q below 50, else 200 - 2q, in percent),
    rounded, clamped to the baseline's 1-255."""
    if not 1 <= quality <= 100:
        raise ValueError(f"encode_jpeg: quality must be 1-100, got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (LUMA_Q, CHROMA_Q))


@functools.cache
def huffman_codes() -> tuple[np.ndarray, np.ndarray]:
    """Each table's canonical codes (T.81 C.2): ``(4, 256)`` uint16 codes
    and uint8 lengths by symbol, length 0 where a symbol is absent."""
    codes, sizes = np.zeros((4, 256), np.uint16), np.zeros((4, 256), np.uint8)
    for t, (counts, symbols) in enumerate(HUFFMAN):
        code, k = 0, 0
        for length, count in enumerate(counts, start=1):
            for _ in range(count):
                codes[t, symbols[k]], sizes[t, symbols[k]] = code, length
                code += 1
                k += 1
            code <<= 1
    return codes, sizes


def _dct_matrix() -> np.ndarray:
    k, n = np.arange(8)[:, None], np.arange(8)[None, :]
    m = np.sqrt(2.0 / 8.0) * np.cos((2 * n + 1) * k * np.pi / 16.0)
    m[0] /= np.sqrt(2.0)
    return m


# The 2-D DCT of a row-major 8x8 block as one (64, 64) product:
# (D B D^T)[u, v] = sum_ij D[u, i] D[v, j] B[i, j], i.e. kron(D, D).
_DCT2 = np.kron(_dct_matrix(), _dct_matrix())
# JFIF's RGB -> YCbCr (Cb and Cr offset by 128 after the product).
_YCC = np.array([[0.299, 0.587, 0.114],
                 [-0.168735892, -0.331264108, 0.5],
                 [0.5, -0.418687589, -0.081312411]])


def _quantize(blocks: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``(n, 64)`` row-major blocks of samples: the DCT of the level-shifted
    samples over the table, rounded half away from zero, as int16 (float32
    products).  From 8-bit samples the DC lies in [-1024, 1016] and every AC
    within +-842, so DC differences take categories up to 11 and AC values
    up to 10: the K.3 tables' range."""
    q = (blocks - np.float32(128.0)) @ (_DCT2.T / table[None, :]).astype(np.float32)
    return np.trunc(q + np.copysign(np.float32(0.5), q)).astype(np.int16)


def mcu_blocks(img: np.ndarray, quality: int) -> tuple[np.ndarray, np.ndarray]:
    """The quantised blocks of an (H, W, 3) uint8 frame in scan order (each
    16x16 MCU: its four Y blocks row by row, then Cb and Cr) and each
    block's component: ``(nblocks, 64)`` int16 and ``(nblocks,)`` int32."""
    h, w, _ = img.shape
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    if (hp, wp) != (h, w):
        img = np.pad(img, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    ycc = img.reshape(-1, 3).astype(np.float32) @ _YCC.T.astype(np.float32)
    ycc = ycc.reshape(hp, wp, 3)
    my, mx = hp // 16, wp // 16
    # Y in MCU order: rows (my, by, i), columns (mx, bx, j) -> (my, mx, by, bx, i, j).
    y = ycc[..., 0].reshape(my, 2, 8, mx, 2, 8).transpose(0, 3, 1, 4, 2, 5).reshape(-1, 64)
    c = ycc[..., 1:].reshape(hp // 2, 2, wp // 2, 2, 2)
    c = (c[:, 0, :, 0] + c[:, 0, :, 1] + c[:, 1, :, 0] + c[:, 1, :, 1]) * np.float32(0.25) + np.float32(128.0)
    c = c.reshape(my, 8, mx, 8, 2).transpose(4, 0, 2, 1, 3).reshape(2, -1, 64)
    qy, qc = quant_tables(quality)
    coef = np.empty((my * mx, 6, 64), np.int16)
    coef[:, :4] = _quantize(y, qy).reshape(my * mx, 4, 64)
    coef[:, 4] = _quantize(c[0], qc)
    coef[:, 5] = _quantize(c[1], qc)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.int32), my * mx)
    return coef.reshape(-1, 64), comp


def _scan_c(coef: np.ndarray, comp: np.ndarray) -> bytes:
    from nbody3d_tpu_torch._build import load_host_library

    fn = load_host_library("_image").nb_jpeg_scan
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64]
    codes, sizes = huffman_codes()
    coef = np.ascontiguousarray(coef, np.int16)
    comp = np.ascontiguousarray(comp, np.int32)
    n = len(coef)
    if coef.shape != (n, 64) or comp.shape != (n,):
        raise ValueError(f"jpeg scan: coef {coef.shape} and comp {comp.shape} must be (n, 64) and (n,)")
    cap = n * 64 * 8 + 64  # every code at most 27 bits, doubled by stuffing
    out = np.empty(cap, np.uint8)
    got = fn(coef.ctypes.data, n, comp.ctypes.data, codes.ctypes.data, sizes.ctypes.data, out.ctypes.data, cap)
    if got < 0:
        raise RuntimeError(f"jpeg scan: the C core's output passed its {cap} bytes")
    return out[:got].tobytes()


def scan_python(coef: np.ndarray, comp: np.ndarray) -> bytes:
    """Plain twin of ``nb_jpeg_scan``: the same entropy-coded bytes."""
    codes, sizes = huffman_codes()
    bits: list[str] = []

    def put(value: int, n: int) -> None:
        if n:
            bits.append(format(value & ((1 << n) - 1), f"0{n}b"))

    def value(v: int) -> None:
        put(v - 1 if v < 0 else v, abs(v).bit_length())

    pred = [0, 0, 0]
    for blk, c in zip(coef.astype(np.int64), comp.tolist()):
        dc, ac = (0, 1) if c == 0 else (2, 3)
        diff = int(blk[0]) - pred[c]
        pred[c] = int(blk[0])
        cat = abs(diff).bit_length()
        put(int(codes[dc, cat]), int(sizes[dc, cat]))
        value(diff)
        run = 0
        for v in blk[ZIGZAG[1:]].tolist():
            if v == 0:
                run += 1
                continue
            while run > 15:
                put(int(codes[ac, 0xF0]), int(sizes[ac, 0xF0]))
                run -= 16
            sym = (run << 4) | abs(v).bit_length()
            put(int(codes[ac, sym]), int(sizes[ac, sym]))
            value(v)
            run = 0
        if run:
            put(int(codes[ac, 0]), int(sizes[ac, 0]))
    s = "".join(bits)
    s += "1" * (-len(s) % 8)
    raw = int(s, 2).to_bytes(len(s) // 8, "big") if s else b""
    return raw.replace(b"\xff", b"\xff\x00")


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _headers(width: int, height: int, quality: int) -> bytes:
    qy, qc = quant_tables(quality)
    out = b"\xff\xd8" + _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xFFDB, bytes([0]) + bytes(qy[ZIGZAG].tolist()) + bytes([1]) + bytes(qc[ZIGZAG].tolist()))
    out += _segment(0xFFC0, struct.pack(">BHHB", 8, height, width, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    dht = b""
    for cls_id, (counts, symbols) in zip((0x00, 0x10, 0x01, 0x11), HUFFMAN):
        dht += bytes([cls_id]) + bytes(counts) + bytes(symbols)
    out += _segment(0xFFC4, dht)
    out += _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out


def encode_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    """The baseline JFIF file (4:2:0) of an (H, W, 3) uint8 frame."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg: expected an (H, W, 3) uint8 array, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"encode_jpeg: frame {w}x{h} out of JPEG's range")
    coef, comp = mcu_blocks(img, quality)
    return _headers(w, h, quality) + _scan_c(coef, comp) + b"\xff\xd9"
