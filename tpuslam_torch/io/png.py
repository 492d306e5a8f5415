"""PNG reading and writing on the standard library's ``zlib`` (stands in for
``cv2.imread`` / ``cv2.imwrite`` of ``tpuslam/io/datasets.py:33-52`` and
``tpuslam/io/synth.py:411-414``: the card host has neither OpenCV nor PIL).

Decoded: 8-bit and 16-bit gray, 8-bit RGB and RGBA, non-interlaced.  An
interlaced, palette, gray+alpha or other PNG raises ``ValueError`` naming the
file.  The five row filters of the PNG specification are undone row by row:
None, Sub (a cumulative sum mod 256 in each byte lane) and Up (a sum with the
row above) in numpy; Avg and Paeth depend on the reconstructed left
neighbour, so the plain version runs them one byte at a time in Python and
``native=True`` hands the whole image to the compiled helper
``csrc/png_unfilter.c`` (built at first use by ``kernels/build.load_host``).

:func:`imread_gray` follows ``cv2.imread(path, IMREAD_GRAYSCALE)`` bit for
bit: 16-bit gray is shifted right by 8, and colour goes through libpng's
rgb-to-gray, which OpenCV asks for with the weights 0.299 and 0.587
(``png_set_rgb_to_gray``); libpng holds them as 15-bit fixed point
(9797, 19234 and 32768 - 9797 - 19234 = 3737) and truncates:
``gray = (9797 R + 19234 G + 3737 B) >> 15``.  OpenCV's own ``cvtColor``
rounds 14-bit weights instead and differs by 1 on about half of random
pixels.  Alpha is dropped.  :func:`imread_unchanged` follows
``IMREAD_UNCHANGED``: gray keeps its depth, colour comes back in BGR(A)
order.  :func:`imwrite` encodes 8-bit or 16-bit gray with the Sub filter.

This is host code: the frames stay uint8 (or uint16) on the host and the
``Tracker`` casts them on its device.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
UNFILTER_SRC = Path(__file__).resolve().parent / "csrc" / "png_unfilter.c"
# libpng's fixed-point rgb-to-gray weights for OpenCV's (0.299, 0.587)
GRAY_R, GRAY_G, GRAY_B = 9797, 19234, 3737
# colour type -> channels, for the types this decoder reads
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes, path):
    """(IHDR fields, concatenated IDAT bytes), each chunk's CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    return ihdr, b"".join(idat)


@functools.lru_cache(maxsize=None)
def _native_unfilter():
    from ..kernels import build

    fn = build.load_host(UNFILTER_SRC).png_unfilter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def unfilter_plain(raw: np.ndarray, h: int, stride: int, bpp: int, path="") -> np.ndarray:
    """(h, 1 + stride) filtered rows -> (h, stride) uint8 samples."""
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, row = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            out[y] = row
        elif ftype == 1:
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            out[y] = row + prev
        elif ftype in (3, 4):
            cur = bytearray(stride)
            r, b = row.tolist(), prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + b[x]) >> 1
                else:
                    pred = _paeth(a, b[x], b[x - bpp] if x >= bpp else 0)
                cur[x] = (r[x] + pred) & 0xFF
            out[y] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown filter type {ftype} in row {y}")
        prev = out[y]
    return out


def unfilter_native(raw: np.ndarray, h: int, stride: int, bpp: int, path="") -> np.ndarray:
    """:func:`unfilter_plain` in the compiled helper."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (stride + 1) or bpp < 1:
        raise ValueError(f"{path}: {raw.size} filtered bytes for {h} rows of {stride} + 1")
    out = np.empty((h, stride), np.uint8)
    err = _native_unfilter()(raw.ctypes.data, out.ctypes.data, h, stride, bpp)
    if err:
        raise ValueError(f"{path}: unknown filter type {int(raw[(err - 1) * (stride + 1)])} in row {err - 1}")
    return out


def decode(path, native: bool = False) -> np.ndarray:
    """The file's samples as stored: (H, W) uint8 or big-endian-decoded
    uint16 gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8.  ``native``: undo the
    filters in the compiled helper."""
    with open(path, "rb") as f:
        data = f.read()
    (w, h, depth, ctype, comp, filt, interlace), idat = _chunks(data, path)
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS or (ctype == 0 and depth not in (8, 16)) or (ctype != 0 and depth != 8):
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported "
                         "(8/16-bit gray, 8-bit RGB or RGBA)")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: unknown compression {comp} or filter method {filt}")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, expected {h * (stride + 1)}")
    img = (unfilter_native if native else unfilter_plain)(raw, h, stride, bpp, path)
    if depth == 16:
        return img.view(">u2").astype(np.uint16).reshape(h, w)
    return img.reshape(h, w, ch) if ch > 1 else img.reshape(h, w)


def to_gray(img: np.ndarray) -> np.ndarray:
    """``IMREAD_GRAYSCALE`` of decoded samples: 16-bit >> 8, colour through
    libpng's truncated fixed-point weights, alpha dropped."""
    if img.ndim == 2:
        return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img
    rgb = img[..., :3].astype(np.uint32)
    return ((GRAY_R * rgb[..., 0] + GRAY_G * rgb[..., 1] + GRAY_B * rgb[..., 2]) >> 15).astype(np.uint8)


def imread_gray(path, native: bool = False) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: (H, W) uint8."""
    return to_gray(decode(path, native))


def imread_unchanged(path, native: bool = False) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: gray as stored (uint8 or
    uint16), colour in BGR or BGRA order."""
    img = decode(path, native)
    if img.ndim == 3:
        img = np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])
    return img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode(img: np.ndarray, level: int = 1) -> bytes:
    """PNG bytes of (H, W) uint8 or uint16 gray, every row Sub-filtered."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"imwrite: needs (H, W) uint8 or uint16 gray, got {img.shape} {img.dtype}")
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">")).view(np.uint8).reshape(h, -1)
    bpp = img.dtype.itemsize
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 1  # Sub
    filtered[:, 1:bpp + 1] = rows[:, :bpp]
    filtered[:, bpp + 1:] = rows[:, bpp:] - rows[:, :-bpp]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + _chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray) -> None:
    """``cv2.imwrite`` of a gray image (8 or 16 bits)."""
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
