"""PNG reading and writing on zlib and numpy, so that loading needs no OpenCV.

``imread`` returns what ``cv2.imread`` returns for the PNGs the datasets hold:
8-bit gray, gray + alpha, RGB or RGBA, not interlaced, any of the five row
filters. With ``IMREAD_COLOR`` (the default) it gives (H, W, 3) uint8 in BGR
order: gray is repeated into the three channels, alpha is dropped. With
``IMREAD_GRAYSCALE`` it gives (H, W) uint8: a color PNG is reduced as libpng
reduces it for OpenCV (``png_set_rgb_to_gray`` with 0.299 and 0.587: the
15-bit fixed-point weights 9797, 19234 and 3737 over R, G and B, truncated,
and a pixel whose three values are equal kept as it is). A file that is
missing raises ``FileNotFoundError`` (``cv2.imread`` returns None); a PNG of
another kind (palette, 16-bit, interlaced) raises ``ValueError``.

``imwrite`` writes uint8 (H, W) gray, or (H, W, C) with C 1, 3 (BGR) or 4
(BGRA), as ``cv2.imwrite`` does; every row takes the same filter
(``filter_type``, default Up).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

IMREAD_COLOR = 1
IMREAD_GRAYSCALE = 0

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel
_GRAY_WEIGHTS = (9797, 19234, 3737)  # R, G, B in 1/32768


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(filters, rows, bpp):
    """Rows whose filters are None, Sub or Up only: one vector pass per row."""
    h, stride = rows.shape
    out = np.empty_like(rows)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        f, x = filters[r], rows[r]
        if f == 1:
            x = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:
            x = x + prev  # uint8 arithmetic wraps mod 256, as the filter does
        out[r] = x
        prev = out[r]
    return out


def _unfilter_wavefront(filters, rows, bpp):
    """Any filters: pixel (r, x) needs its left, upper and upper-left
    neighbours only, so the pixels of one anti-diagonal r + x = t are
    reconstructed together, t = 0, 1, ..."""
    h, stride = rows.shape
    w = stride // bpp
    w1 = w + 1
    # a zero row above and a zero column left of the image, flattened
    full = np.zeros(((h + 1) * w1, bpp), np.int32)
    raw = rows.reshape(h, w, bpp).astype(np.int32)
    for t in range(h + w - 1):
        rs = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        xs = t - rs
        i = (rs + 1) * w1 + xs + 1
        a, b, c = full[i - 1], full[i - w1], full[i - w1 - 1]
        f = filters[rs][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        full[i] = (raw[rs, xs] + pred) & 255
    return full.reshape(h + 1, w1, bpp)[1:, 1:].astype(np.uint8).reshape(h, stride)


def _decode(path: str):
    """(H, W, samples) uint8 and the PNG color type."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit gray, gray+alpha, RGB and RGBA PNGs without "
                         f"interlacing are read (bit depth {depth}, color type {color}, "
                         f"interlace {interlace})")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {w}x{h}x{bpp}")
    raw = raw.reshape(h, w * bpp + 1)
    filters, rows = raw[:, 0], raw[:, 1:]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(filters.max())}")
    unfilter = _unfilter_rows if filters.max(initial=0) <= 2 else _unfilter_wavefront
    return unfilter(filters, rows, bpp).reshape(h, w, bpp), color


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """BGR (H, W, 3) uint8, or gray (H, W) uint8 with ``IMREAD_GRAYSCALE``."""
    img, color = _decode(path)
    gray = color in (0, 4)
    if flags == IMREAD_GRAYSCALE:
        if gray:
            return np.ascontiguousarray(img[:, :, 0])
        r, g, b = (img[:, :, i].astype(np.int64) for i in range(3))
        wr, wg, wb = _GRAY_WEIGHTS
        y = (wr * r + wg * g + wb * b) >> 15
        return np.where((r == g) & (r == b), r, y).astype(np.uint8)
    if flags != IMREAD_COLOR:
        raise ValueError(f"imread flags must be IMREAD_COLOR or IMREAD_GRAYSCALE, got {flags}")
    if gray:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, 2::-1])


def _filter(img: np.ndarray, filter_type: int) -> np.ndarray:
    """Rows of (H, W, C) uint8 filtered by one filter type, each led by it."""
    h, w, c = img.shape
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, 1:] = x[:-1, :-1]
    pred = (np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, cc))[filter_type]
    rows = ((x - pred) & 255).astype(np.uint8).reshape(h, w * c)
    return np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)


def imwrite(path: str, img: np.ndarray, filter_type: int = 2, level: int = 6) -> None:
    """Writes uint8 gray (H, W) or (H, W, 1), BGR (H, W, 3) or BGRA (H, W, 4)
    as an 8-bit PNG, every row with ``filter_type`` (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth), compressed at zlib ``level``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"imwrite takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"imwrite takes (H, W), (H, W, 1), (H, W, 3) or (H, W, 4), got {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG row filters are 0-4, got {filter_type}")
    h, w, c = img.shape
    if c >= 3:  # BGR(A) -> RGB(A)
        img = np.concatenate([img[:, :, 2::-1], img[:, :, 3:]], axis=2)
    color = {1: 0, 3: 2, 4: 6}[c]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = zlib.compress(_filter(img, filter_type).tobytes(), level)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", data) + chunk(b"IEND", b""))
