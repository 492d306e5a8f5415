"""The port's PNG codec (``tpuslam_torch/io/png.py``) against ``cv2.imread``:
files written by ``cv2.imwrite`` (gray8, gray16, BGR, BGRA) and files written
by hand with ``zlib`` with each row filter forced (None, Sub, Up, Avg,
Paeth, and all five mixed), decoded by the plain version and by the compiled
helper; the colour-to-gray rule; the encoder read back by ``cv2``."""

import os
import struct
import zlib

import numpy as np
import pytest

from tpuslam_torch.io import png

cv2 = pytest.importorskip("cv2")

RNG = np.random.default_rng(11)
H, W = 37, 53


def _smooth(shape, dtype, rng):
    """Random texture with local structure, so each filter's predictions matter."""
    hi = 65536 if dtype == np.uint16 else 256
    base = rng.integers(0, hi, shape).astype(np.int64)
    return ((base + np.roll(base, 1, axis=1) + np.roll(base, 1, axis=0)) // 3).astype(dtype)


def _filter_row(row, prev, ftype, bpp):
    """PNG filter ``ftype`` of one row (uint8 bytes) given the row above."""
    out = np.zeros_like(row)
    for x in range(len(row)):
        a = int(row[x - bpp]) if x >= bpp else 0
        b = int(prev[x])
        c = int(prev[x - bpp]) if x >= bpp else 0
        pred = [0, a, b, (a + b) // 2, png._paeth(a, b, c)][ftype]
        out[x] = (int(row[x]) - pred) & 0xFF
    return out


def _write_png(path, img, filters, ctype, depth):
    """A PNG written by hand: row y filtered with ``filters[y % len]``."""
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    h, w = img.shape[:2]
    data = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8).reshape(h, -1)
    bpp = ch * depth // 8
    raw = bytearray()
    prev = np.zeros(data.shape[1], np.uint8)
    for y in range(h):
        ft = filters[y % len(filters)]
        raw.append(ft)
        raw += _filter_row(data[y], prev, ft, bpp).tobytes()
        prev = data[y]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _decoders():
    return [("plain", False), ("native", True)]


@pytest.mark.parametrize("kind", ["gray8", "gray16", "bgr", "bgra"])
def test_cv2_written_files_decode_bit_exact(tmp_path, kind):
    rng = np.random.default_rng(hash(kind) % 1000)
    img = {"gray8": lambda: _smooth((H, W), np.uint8, rng),
           "gray16": lambda: _smooth((H, W), np.uint16, rng),
           "bgr": lambda: _smooth((H, W, 3), np.uint8, rng),
           "bgra": lambda: _smooth((H, W, 4), np.uint8, rng)}[kind]()
    path = str(tmp_path / f"{kind}.png")
    cv2.imwrite(path, img)
    for name, native in _decoders():
        np.testing.assert_array_equal(png.imread_unchanged(path, native), cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                      err_msg=f"{kind} {name} unchanged")
        np.testing.assert_array_equal(png.imread_gray(path, native), cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                                      err_msg=f"{kind} {name} gray")
    np.testing.assert_array_equal(png.imread_unchanged(path), img)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4], [4, 3, 2, 1, 0, 4, 4]],
                         ids=["none", "sub", "up", "avg", "paeth", "mixed", "mixed_paeth"])
@pytest.mark.parametrize("ctype,depth", [(0, 8), (0, 16), (2, 8), (6, 8)], ids=["gray8", "gray16", "rgb", "rgba"])
def test_forced_filters_decode_bit_exact(tmp_path, filters, ctype, depth):
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    shape = (H, W) if ch == 1 else (H, W, ch)
    img = _smooth(shape, np.uint16 if depth == 16 else np.uint8, RNG)
    path = str(tmp_path / "f.png")
    _write_png(path, img, filters, ctype, depth)
    ref_u = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    ref_g = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    for name, native in _decoders():
        np.testing.assert_array_equal(png.imread_unchanged(path, native), ref_u, err_msg=name)
        np.testing.assert_array_equal(png.imread_gray(path, native), ref_g, err_msg=name)
    np.testing.assert_array_equal(png.decode(path), img)


def test_gray_rule_is_libpng_fixed_point_not_cvtcolor(tmp_path):
    """Every 8-bit colour to gray equals (9797 R + 19234 G + 3737 B) >> 15,
    as cv2.imread gives; cvtColor's rounded 14-bit rule differs on many pixels."""
    rng = np.random.default_rng(5)
    bgr = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    bgr[0, :, 0] = bgr[0, :, 1] = bgr[0, :, 2] = np.arange(256)  # gray pixels stay as they are
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, bgr)
    got = png.imread_gray(path)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(got[0], np.arange(256))
    assert (got != cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)).mean() > 0.2


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_encoder_reads_back_in_cv2(tmp_path, dtype):
    img = _smooth((H, W), dtype, RNG)
    path = str(tmp_path / "w.png")
    png.imwrite(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.imread_unchanged(path), img)


def test_unsupported_files_raise_with_the_path(tmp_path):
    img = _smooth((H, W), np.uint8, RNG)
    pal = str(tmp_path / "palette.png")
    _write_png(pal, img, [0], 0, 8)
    data = bytearray(open(pal, "rb").read())
    data[8 + 8 + 9] = 3  # colour type 3 (palette) in IHDR
    crc = zlib.crc32(bytes(data[12:29]))
    data[29:33] = struct.pack(">I", crc)
    open(pal, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="palette.png"):
        png.imread_gray(pal)
    inter = str(tmp_path / "interlaced.png")
    data[8 + 8 + 9] = 0
    data[8 + 8 + 12] = 1  # interlace method 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(inter, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced.png"):
        png.imread_gray(inter)
    ga = str(tmp_path / "gray_alpha.png")
    _write_png(ga, np.stack([img, img], -1), [1], 4, 8)
    assert cv2.imread(ga, cv2.IMREAD_UNCHANGED) is not None  # a valid PNG
    with pytest.raises(ValueError, match="gray_alpha.png"):
        png.imread_gray(ga)
    with pytest.raises(ValueError):
        png.imwrite(str(tmp_path / "x.png"), np.zeros((4, 4, 2), np.uint8))
    assert not os.path.exists(tmp_path / "x.png")
