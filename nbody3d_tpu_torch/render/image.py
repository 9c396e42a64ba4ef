"""Frame output: PNG, APNG and GIF written without an image library.

The port's counterpart of ``nbody3d_tpu/render/image.py``, which writes
through PIL; the card's machine has none, so the files are built here:

- :func:`save_png` from ``zlib`` and ``struct`` (8-bit RGB, one filter
  byte 0 a row); :func:`read_png` and :func:`read_apng` decode what the
  port writes;
- :func:`save_animation`: APNG (lossless; its first frame is a plain PNG
  image), GIF89a (a palette of at most 256 colours a frame by median cut,
  each pixel mapped to its nearest palette colour, LZW-coded by the C core
  ``native/_image.c``'s ``nb_gif_lzw`` or its twin :func:`lzw_python`), or
  MP4/WebM through ``ffmpeg`` where it is on ``PATH``.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _rgb(img) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) array, got {img.shape}")
    return img


def _idat(img: np.ndarray, level: int) -> bytes:
    """The zlib stream of an image's rows, each behind filter byte 0."""
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + 3 * w), dtype=np.uint8)
    rows[:, 1:] = img.reshape(h, 3 * w)
    return zlib.compress(rows.tobytes(), level)


def _ihdr(w: int, h: int) -> bytes:
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))  # 8-bit truecolour


def save_png(path: str, img: np.ndarray, *, level: int = 6) -> None:
    """Write an (H, W, 3) uint8 array as PNG."""
    img = _rgb(img)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _ihdr(w, h) + _chunk(b"IDAT", _idat(img, level)) + _chunk(b"IEND", b""))


def _read_chunks(path: str) -> list[tuple[bytes, bytes]]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, chunks = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        chunks.append((data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]))
        pos += 12 + length
        if chunks[-1][0] == b"IEND":
            break
    return chunks


def _decode(path: str, header, streams: list[bytes]) -> np.ndarray:
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", header)
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB, non-interlaced (got depth {depth}, "
                         f"colour type {color}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(streams)), dtype=np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path} uses row filters other than 0")
    return raw[:, 1:].reshape(h, w, 3).copy()


def read_png(path: str) -> np.ndarray:
    """Decode a PNG that :func:`save_png` wrote (8-bit RGB, non-interlaced,
    filter 0 on every row) to (H, W, 3) uint8; raises on anything else.  Of
    an APNG, the default image (its first frame)."""
    chunks = _read_chunks(path)
    header = next((body for kind, body in chunks if kind == b"IHDR"), None)
    return _decode(path, header, [body for kind, body in chunks if kind == b"IDAT"])


def read_apng(path: str) -> list[np.ndarray]:
    """Every frame of an APNG that :func:`save_animation` wrote (full frames
    at the image's size), or the one image of a PNG."""
    chunks = _read_chunks(path)
    header = next((body for kind, body in chunks if kind == b"IHDR"), None)
    frames: list[list[bytes]] = []
    for kind, body in chunks:
        if kind == b"fcTL":
            frames.append([])
        elif kind == b"IDAT" and frames:
            frames[-1].append(body)
        elif kind == b"fdAT":
            frames[-1].append(body[4:])  # after the sequence number
    if not frames:
        return [read_png(path)]
    return [_decode(path, header, streams) for streams in frames]


def save_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img))


# ------------------------------------------------------------------ animation
def _frames(frames) -> list[np.ndarray]:
    out = [read_png(os.fspath(f)) if isinstance(f, (str, os.PathLike)) else _rgb(f) for f in frames]
    if not out:
        raise ValueError("no frames to assemble")
    if any(f.shape != out[0].shape for f in out):
        raise ValueError(f"frames differ in size: {sorted({f.shape for f in out})}")
    return out


def save_apng(path: str, frames, *, duration_ms: int) -> None:
    """APNG: ``acTL`` with the frame count (looping forever), then each frame
    a ``fcTL`` (full frame, ``duration_ms``, no disposal, source blend) and
    its data, the first as ``IDAT`` (the default image), the rest
    ``fdAT``."""
    frames = _frames(frames)
    h, w, _ = frames[0].shape
    out = [_SIGNATURE, _ihdr(w, h), _chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0
    for i, img in enumerate(frames):
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, duration_ms, 1000, 0, 0)))
        seq += 1
        data = _idat(img, 6)
        if i == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def median_cut(img: np.ndarray, colours: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """A palette of at most ``colours`` for an (H, W, 3) uint8 frame and
    each pixel's index into it.  A frame of fewer colours keeps them
    exactly; otherwise median cut over its distinct colours weighted by
    their counts (split the box of most pixels along its widest channel at
    the weighted median, until there are ``colours`` boxes), each box's
    colour its pixels' mean, and every pixel mapped to its nearest
    palette colour.  Returns ``(palette (K, 3) uint8, index (H, W) uint8)``."""
    flat = img.reshape(-1, 3)
    key = (flat[:, 0].astype(np.int32) << 16) | (flat[:, 1].astype(np.int32) << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    rgb = np.stack([(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1)
    if len(uniq) <= colours:
        return rgb.astype(np.uint8), inverse.reshape(img.shape[:2]).astype(np.uint8)
    boxes, weight = [np.arange(len(uniq))], [int(counts.sum())]  # weight 0: a box of one colour
    while len(boxes) < colours and max(weight) > 0:
        box = boxes.pop(i := int(np.argmax(weight)))
        weight.pop(i)
        ch = int(np.argmax(rgb[box].max(axis=0) - rgb[box].min(axis=0)))
        box = box[np.argsort(rgb[box, ch], kind="stable")]
        cum = np.cumsum(counts[box])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2.0), 0, len(box) - 2)) + 1
        for part in (box[:cut], box[cut:]):
            boxes.append(part)
            weight.append(int(counts[part].sum()) if len(part) > 1 else 0)
    palette = np.stack([(rgb[b] * counts[b, None]).sum(axis=0) / counts[b].sum() for b in boxes])
    palette = np.clip(np.rint(palette), 0, 255)
    # |c - p|^2 less |c|^2 as one float32 product: integers below 2^24, so exact.
    pal = palette.astype(np.float32)
    nearest = ((pal * pal).sum(axis=1)[None, :] - 2.0 * (rgb.astype(np.float32) @ pal.T)).argmin(axis=1)
    return palette.astype(np.uint8), nearest[inverse].reshape(img.shape[:2]).astype(np.uint8)


def _lzw_c(idx: np.ndarray) -> bytes:
    from nbody3d_tpu_torch._build import load_host_library

    fn = load_host_library("_image").nb_gif_lzw
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    idx = np.ascontiguousarray(idx, np.uint8).reshape(-1)
    cap = 2 * len(idx) + 64  # a code of at most 12 bits a pixel, clear codes and the end
    out = np.empty(cap, np.uint8)
    got = fn(idx.ctypes.data, len(idx), out.ctypes.data, cap)
    if got < 0:
        raise RuntimeError(f"gif lzw: the C core failed ({'out of memory' if got == -2 else 'output past its cap'})")
    return out[:got].tobytes()


def lzw_python(idx: np.ndarray) -> bytes:
    """Plain twin of ``nb_gif_lzw``: the same code stream."""
    clear, end, first, max_codes = 256, 257, 258, 4096
    acc, nbits, out = 0, 0, bytearray()

    def put(code: int, width: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    data = np.asarray(idx, np.uint8).reshape(-1).tolist()
    width, nxt, table = 9, first, {}
    put(clear, width)
    if data:
        prefix = data[0]
        for k in data[1:]:
            code = table.get((prefix, k))
            if code is not None:
                prefix = code
                continue
            put(prefix, width)
            if nxt >= (1 << width) and width < 12:
                width += 1
            table[(prefix, k)] = nxt
            nxt += 1
            if nxt == max_codes:
                put(clear, width)
                width, nxt, table = 9, first, {}
            prefix = k
        put(prefix, width)
        if nxt >= (1 << width) and width < 12:
            width += 1
    put(end, width)
    if nbits:
        put(0, 8 - nbits)
    return bytes(out)


def save_gif(path: str, frames, *, duration_ms: int) -> None:
    """GIF89a looping forever (the NETSCAPE2.0 extension): each frame a
    graphic control block (its delay in hundredths of a second), an image
    descriptor with a local colour table of 256 entries (:func:`median_cut`)
    and its LZW data (minimum code size 8) in sub-blocks of at most 255
    bytes."""
    frames = _frames(frames)
    h, w, _ = frames[0].shape
    if w >= 65536 or h >= 65536:
        raise ValueError(f"save_gif: frame {w}x{h} out of GIF's range")
    delay = max(1, round(duration_ms / 10))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),  # no global table, 8 bits a channel
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for img in frames:
        palette, idx = median_cut(img)
        table = np.zeros((256, 3), np.uint8)
        table[: len(palette)] = palette
        out.append(b"\x21\xf9\x04" + struct.pack("<BHB", 0x04, delay, 0) + b"\x00")  # keep the frame
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87) + table.tobytes() + b"\x08")
        code = _lzw_c(idx)
        out += [bytes([len(code[i:i + 255])]) + code[i:i + 255] for i in range(0, len(code), 255)]
        out.append(b"\x00")
    out.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(out))


def save_animation(frames, path: str, *, fps: float = 30.0) -> None:
    """Assemble frames into a watchable file: ``frames`` are (H, W, 3) uint8
    arrays or PNG paths; the format is the suffix's.  ``.png``/``.apng``
    (APNG) and ``.gif`` are written here; ``.mp4``/``.webm`` go through
    ``ffmpeg`` when it is on ``PATH`` and raise otherwise.  The headless
    counterpart of watching the reference's canvas (``nbody3d.js:439-514``)."""
    import shutil
    import subprocess
    import tempfile

    frames = list(frames)
    if not frames:
        raise ValueError("no frames to assemble")
    suffix = os.path.splitext(str(path))[1].lower()
    duration_ms = max(1, round(1000.0 / fps))
    if suffix in (".png", ".apng"):
        save_apng(path, frames, duration_ms=duration_ms)
        return
    if suffix == ".gif":
        save_gif(path, frames, duration_ms=duration_ms)
        return
    if suffix in (".mp4", ".webm"):
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is None:
            raise RuntimeError(f"ffmpeg not found on PATH (needed for {suffix}); use a .gif output instead")
        with tempfile.TemporaryDirectory() as td:
            for i, f in enumerate(_frames(frames)):
                save_png(os.path.join(td, f"f_{i:06d}.png"), f)
            subprocess.run([ffmpeg, "-y", "-framerate", str(fps), "-i", os.path.join(td, "f_%06d.png"),
                            "-pix_fmt", "yuv420p", str(path)], check=True, capture_output=True)
        return
    raise ValueError(f"unsupported animation format {suffix!r} (gif/png/mp4/webm)")
