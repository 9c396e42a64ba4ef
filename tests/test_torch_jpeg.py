"""The port's JPEG encoder (``render/jpeg.py``) against PIL, on the CPU.

- The DQT tables, read back by PIL, equal PIL's own at qualities 50, 85
  and 95 (libjpeg's quality scaling of the Annex K tables).
- The decoded frame's PSNR against the source is within 0.5 dB of PIL's
  own encode at the same quality: on the two-galaxy frame and on a
  gradient.
- The C core (``native/_image.c``'s ``nb_jpeg_scan``) gives its Python
  twin's bytes; the file is baseline JFIF 4:2:0, SOI to EOI; a compiler
  that fails raises.
"""

import io

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nbody3d_tpu_torch import _build  # noqa: E402
from nbody3d_tpu_torch.models.registry import make_preset  # noqa: E402
from nbody3d_tpu_torch.render import jpeg, rasterize  # noqa: E402
from nbody3d_tpu_torch.utils.camera import Camera  # noqa: E402

QUALITIES = (50, 85, 95)


def two_galaxy_frame(width=96, height=80):
    pm, vel, target = make_preset("two-galaxy", seed=0, G=1e-4, n=512, size_factor=1000.0)
    return rasterize.render_points(torch.from_numpy(pm), torch.from_numpy(vel), Camera(target=target),
                                   width=width, height=height)


def gradient(width=101, height=77):
    yy, xx = np.mgrid[0:height, 0:width]
    return np.stack([xx * 2.5, yy * 3.3, (xx + yy) * 1.4], -1).clip(0, 255).astype(np.uint8)


def noise(width=70, height=50, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (height, width, 3), dtype=np.uint8)


SCENES = {"two-galaxy": two_galaxy_frame, "gradient": gradient, "noise": noise}


def decode(data: bytes):
    img = PIL_Image.open(io.BytesIO(data))
    img.load()
    return img


def pil_jpeg(img: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    PIL_Image.fromarray(img).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / mse)) if mse else float("inf")


@pytest.mark.parametrize("quality", QUALITIES)
def test_dqt_equals_pil(quality):
    img = gradient()
    got, want = decode(jpeg.encode_jpeg(img, quality)), decode(pil_jpeg(img, quality))
    assert got.quantization == want.quantization
    assert {k: list(v) for k, v in got.quantization.items()} == {
        i: t.tolist() for i, t in enumerate(jpeg.quant_tables(quality))}


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("scene", ["two-galaxy", "gradient"])
def test_psnr_within_half_a_db_of_pil(scene, quality):
    img = SCENES[scene]()
    ours = np.asarray(decode(jpeg.encode_jpeg(img, quality)).convert("RGB"))
    pil = np.asarray(decode(pil_jpeg(img, quality)).convert("RGB"))
    assert ours.shape == img.shape
    assert psnr(ours, img) >= psnr(pil, img) - 0.5, (psnr(ours, img), psnr(pil, img))


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("scene", list(SCENES))
def test_c_core_equals_python_twin(scene, quality):
    img = SCENES[scene]()
    coef, comp = jpeg.mcu_blocks(img, quality)
    scan = jpeg.scan_python(coef, comp)
    assert jpeg._scan_c(coef, comp) == scan
    assert jpeg.encode_jpeg(img, quality).endswith(scan + b"\xff\xd9")


def test_file_layout():
    img = two_galaxy_frame(width=50, height=33)  # not a whole number of MCUs
    data = jpeg.encode_jpeg(img)
    assert data[:4] == b"\xff\xd8\xff\xe0" and data[6:11] == b"JFIF\x00" and data[-2:] == b"\xff\xd9"
    got = decode(data)
    assert got.format == "JPEG" and got.mode == "RGB" and got.size == (50, 33)
    assert got.layer == [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]  # 4:2:0: Y 2x2, Cb and Cr 1x1
    assert "progressive" not in got.info
    # The K.3 tables: complete prefix codes over the baseline's symbols.
    codes, sizes = jpeg.huffman_codes()
    for t, (counts, symbols) in enumerate(jpeg.HUFFMAN):
        assert sum(counts) == len(symbols) == len(set(symbols)) == int((sizes[t] > 0).sum())


def test_black_frame_and_bad_input():
    black = np.zeros((48, 64, 3), np.uint8)
    assert np.asarray(decode(jpeg.encode_jpeg(black)).convert("RGB")).max() == 0
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg(black.astype(np.float32))
    with pytest.raises(ValueError, match="quality"):
        jpeg.encode_jpeg(black, 0)


def test_failing_compiler_raises(monkeypatch, tmp_path):
    """No fallback to the Python twin: a compiler that fails raises."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CC", "false")
    _build.load_host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed to build _image.c"):
            jpeg.encode_jpeg(np.zeros((16, 16, 3), np.uint8))
    finally:
        _build.load_host_library.cache_clear()
