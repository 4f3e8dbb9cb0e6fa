"""Image reading and PNG writing without OpenCV: every format whose decoder
OpenCV has in its own code or in libjpeg-turbo and libpng.

``imread`` returns what ``cv2.imread`` returns, bit for bit, for JPEG, PNG,
BMP, PBM/PGM/PPM, PAM, PFM, Sun raster, Radiance HDR and GIF files, damaged
ones included; the JAX package reads them with OpenCV. OpenCV picks its
decoder by the file's content, not its name, and so does ``imread``. With
``IMREAD_COLOR`` (the default) it gives (H, W, 3) uint8 in BGR order, with
``IMREAD_GRAYSCALE`` (H, W) uint8.

* JPEG goes to the port's native decoder (``frn_tpu_torch/native/jpeg.cpp``,
  built by g++ at first use; see that file for what it reproduces):
  Huffman-coded baseline, extended and progressive files with 1, 3 or 4
  components (gray, YCbCr, RGB, CMYK, YCCK), any sampling factors libjpeg
  takes, restart intervals; and what libjpeg-turbo makes of a damaged one
  under ``cv2.imread``: a truncated or corrupted file decodes to the
  partial image OpenCV returns (the rest of a cut scan grey in a sequential
  file, smoothed from the earlier scans in a progressive one), or raises
  ``UnreadableImage`` where OpenCV returns None. Arithmetic-coded and
  lossless files, and a file of more than 2^26 pixels too short for its
  first scan, raise ``ValueError`` naming the kind. Without the library (no
  g++, or ``FRN_DISABLE_NATIVE``) a JPEG raises ``RuntimeError`` naming the
  cause: no other path gives the same pixels.
* PNG is decoded on zlib and numpy: gray at bit depths 1, 2, 4, 8 and 16 (a
  sample of 1, 2 or 4 bits scaled to 8 as libpng expands it, so 1-bit gives
  0 and 255), gray + alpha, RGB and RGBA at 8 and 16 bits, palette at 1-8
  bits with or without ``tRNS``, Adam7 interlace, the five row filters. As
  OpenCV asks libpng: alpha is dropped, 16-bit samples keep their high byte,
  gray is repeated into the three channels, and a palette is expanded to its
  colours. Under ``IMREAD_GRAYSCALE`` a colour pixel is reduced as
  ``png_set_rgb_to_gray`` with 0.299 and 0.587 reduces it: the 15-bit
  weights 9797, 19234 and 3737 over R, G and B, truncated at 8 bits (a pixel
  whose three values are equal kept as it is) and rounded at 16 bits before
  the high byte; where a ``gAMA`` or ``sRGB`` chunk gives the file a gamma,
  the 8-bit reduction runs through libpng's gamma tables as it does in
  libpng (the 16-bit one raises ``ValueError``). Damage is met as libpng
  meets it under OpenCV's reader: an ancillary chunk with a bad CRC is
  dropped (a ``gAMA`` so dropped gives no gamma), data after IEND is not
  read, and a cut file, a critical chunk with a bad CRC, a broken zlib
  stream or a header libpng refuses raise ``UnreadableImage`` (see ``_png``).
* BMP, PBM/PGM/PPM, PAM, PFM, Sun raster, Radiance HDR and GIF follow OpenCV
  5's own decoders, their faults included (each decoder's docstring says
  what it reproduces): plain rows decode in numpy, and BMP's RLE4/RLE8,
  HDR's run-length scanlines and GIF's LZW in the port's native library
  (``frn_tpu_torch/native/codecs.cpp``, built by g++ at first use; without
  it such a file raises ``RuntimeError`` naming the cause). Where OpenCV's
  PAM reader leaves part of the image uninitialized (the alpha tuple types
  under some flags) this reader raises ``ValueError``: no reader can give
  those pixels.
* The EXIF orientation (a JPEG's first APP1 segment, a PNG's ``eXIf`` chunk)
  turns the image as ``cv2.imread`` turns it.

Errors: a missing file raises ``FileNotFoundError``; an existing file that
``cv2.imread`` returns None for raises ``UnreadableImage`` (a ``ValueError``;
also for bytes no OpenCV decoder recognizes, as a file cut before its
signature); where ``cv2.imread`` raises ``cv2.error`` (a frame over 2^30
pixels or 2^20 a side) this reader raises a plain ``ValueError``, as it does
for a file that OpenCV reads and this reader does not (TIFF, WebP, JPEG
2000, AVIF/HEIF, and the JPEG kinds above), naming it. The datasets turn
``UnreadableImage`` into the JAX package's answer to the None.

``imwrite`` writes uint8 (H, W) gray, or (H, W, C) with C 1, 3 (BGR) or 4
(BGRA), as ``cv2.imwrite`` does; every row takes the same filter
(``filter_type``, default Up).
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import struct
import zlib

import numpy as np

from frn_tpu_torch.utils import native

IMREAD_COLOR = 1
IMREAD_GRAYSCALE = 0

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_GRAY_WEIGHTS = (9797, 19234, 3737)  # R, G, B in 1/32768
_PNG_MAX_SIDE = 1_000_000  # libpng's default user limit on width and height
_CV2_MAX_PIXELS = 1 << 30  # cv2's CV_IO_MAX_IMAGE_PIXELS
# Adam7 passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# the formats that cv2.imread reads and this reader does not, by their
# leading bytes, so that the error names them
_OTHER_FORMATS = ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"\xffO\xffQ", "JPEG 2000"),
                  (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"))


class UnreadableImage(ValueError):
    """An existing file that ``cv2.imread`` returns None for: a damaged or
    refused file that libjpeg-turbo, libpng or OpenCV's own decoders give up
    on, or bytes no OpenCV decoder recognizes. The JAX package's datasets act on that None
    (DSEC-Det reads zeros, the CSV dataset raises ``FileNotFoundError``)."""


def _format_name(data: bytes):
    """The name of a format that cv2.imread reads and this reader refuses,
    or None (OpenCV has no decoder for the bytes either: JPEG XL, OpenEXR
    and MNG in the OpenCV the tests hold this reader to, or no format)."""
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis", b"heic", b"heix", b"mif1"):
        return "AVIF/HEIF"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return None


# ------------------------------------------------------------ EXIF orientation


def _exif_orientation(tiff: bytes) -> int:
    """IFD0's Orientation (tag 0x0112) of a TIFF-structured EXIF block, as
    OpenCV's ExifReader reads it: 1 where it is absent; where the block
    breaks off, the entries read before it stand."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack_from(e + "H", tiff, 2)[0] != 0x2A:
        return 1
    ifd = struct.unpack_from(e + "I", tiff, 4)[0]
    if ifd + 2 > len(tiff):
        return 1
    found = 1
    for i in range(struct.unpack_from(e + "H", tiff, ifd)[0]):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            break
        if struct.unpack_from(e + "H", tiff, at)[0] == 0x0112:
            found = struct.unpack_from(e + "H", tiff, at + 8)[0]
    return found


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: 2-4 flips, 5-8 a transpose and then a flip."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


# ------------------------------------------------------------ JPEG


def _jpeg(data: bytes, path: str, gray: bool):
    """(the decoded image, its EXIF orientation) by the native decoder."""
    lib = native.jpeg_lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(512)
    rc = lib.frn_jpeg_info(buf.ctypes.data, buf.size, info.ctypes.data, err, len(err))
    if rc == 0:
        w, h = int(info[0]), int(info[1])
        out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
        rc = lib.frn_jpeg_decode(buf.ctypes.data, buf.size, int(gray), out.ctypes.data, err,
                                 len(err))
    if rc != 0:
        error = UnreadableImage if rc == 2 else ValueError
        raise error(f"{path}: {err.value.decode(errors='replace')}")
    return out, int(info[3])


# ------------------------------------------------------------ PNG


def _letters(kind: bytes) -> bool:
    return all(65 <= c <= 90 or 97 <= c <= 122 for c in kind)


def _chunks(data: bytes, path: str):
    """(kind, body) of each chunk before IEND as OpenCV's PNG reader and
    libpng take them, body None for an ancillary chunk with a bad CRC (libpng
    warns and drops it). A chunk that the file cuts, a name that is not four
    letters with the third upper-case (libpng's reserved bit), and a critical
    chunk of an unknown kind or with a bad CRC raise ``UnreadableImage``.
    IEND ends the stream whatever its length and CRC (OpenCV hands libpng a
    well-formed one of its own), and nothing after it is read."""
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise UnreadableImage(f"{path}: truncated PNG (the file ends before IEND)")
        length, kind = struct.unpack_from(">I4s", data, pos)
        end = pos + 12 + length
        if end > len(data):
            raise UnreadableImage(f"{path}: truncated PNG (chunk {kind!r} runs past the end)")
        if not _letters(kind) or not 65 <= kind[2] <= 90:
            raise UnreadableImage(f"{path}: corrupt PNG (invalid chunk name {kind!r})")
        if kind == b"IEND":
            return
        body = data[pos + 8:pos + 8 + length]
        crc_ok = zlib.crc32(kind + body) == struct.unpack_from(">I", data, end - 4)[0]
        if 65 <= kind[0] <= 90:  # critical
            if kind not in (b"IHDR", b"PLTE", b"IDAT"):
                raise UnreadableImage(f"{path}: corrupt PNG (unknown critical chunk {kind!r})")
            if not crc_ok:
                raise UnreadableImage(f"{path}: corrupt PNG (bad CRC in chunk {kind!r})")
        yield kind, body if crc_ok else None
        pos = end


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


def _image_rows(raw: np.ndarray, w: int, h: int, depth: int, channels: int, path: str):
    """One (sub-)image's filtered rows from ``raw`` -> (samples (h, w,
    channels): uint8, or uint16 at depth 16; the bytes it took)."""
    bits = depth * channels
    stride = (w * bits + 7) // 8
    size = h * (stride + 1)
    if raw.size < size:
        raise UnreadableImage(f"{path}: {raw.size} bytes of image data for {w}x{h} at {bits} bits")
    rows = raw[:size].reshape(h, stride + 1)
    filters, rows = rows[:, 0], rows[:, 1:]
    if filters.max(initial=0) > 4:
        raise UnreadableImage(f"{path}: unknown row filter {int(filters.max())}")
    bpp = max(1, bits // 8)
    unfilter = _unfilter_rows if filters.max(initial=0) <= 2 else _unfilter_wavefront
    rows = unfilter(filters, rows, bpp)
    if depth == 16:
        v = rows.reshape(h, w * channels, 2).astype(np.uint16)
        samples = (v[:, :, 0] << 8) | v[:, :, 1]
    elif depth < 8:
        shifts = (8 - depth) - depth * np.arange(8 // depth)  # first sample in the high bits
        samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    else:
        samples = rows
    return samples.reshape(h, w, channels), size


def _gamma_table(gamma: int) -> np.ndarray:
    """libpng's png_build_8bit_table for a gamma in 1/100000: floor(255
    (v / 255)^g + .5) between 0 and 255, identity where g is within 5% of 1."""
    if 95000 <= gamma <= 105000:
        return np.arange(256, dtype=np.int64)
    v = np.arange(256)
    t = np.array([math.floor(255 * math.pow(i / 255.0, gamma * 0.00001) + 0.5) for i in v])
    t[0], t[255] = 0, 255
    return t.astype(np.int64)


def _reciprocal(g: int) -> int:  # png_reciprocal in 1/100000 fixed point
    return int(math.floor(1e10 / g + 0.5))


def _png(data: bytes, path: str, gray: bool):
    """(the decoded image, its EXIF orientation), as OpenCV's PNG decoder
    asks libpng for it. Where cv2.imread returns None it raises
    ``UnreadableImage``: a header libpng refuses, a palette image without a
    single well-formed PLTE before its data, IDAT chunks that are missing,
    split by another chunk or whose zlib stream is broken, cut or too short
    for the image, a row filter above 4. A PLTE in a non-palette image, an
    invalid ``gAMA`` or ``sRGB``, an ancillary chunk with a bad CRC and data
    after the zlib stream are ignored, as libpng ignores them; a palette
    index past the PLTE entries reads black, as libpng's zeroed palette
    gives it."""
    header, palette, idat, orientation, file_gamma = None, None, [], 1, None
    idat_state = 0  # 0: before IDAT, 1: in the IDAT run, 2: after it
    for i, (kind, body) in enumerate(_chunks(data, path)):
        if (i == 0) != (kind == b"IHDR"):
            raise UnreadableImage(f"{path}: corrupt PNG (IHDR is not the first chunk and the only one)")
        if idat_state == 1 and kind != b"IDAT":
            idat_state = 2
        if kind == b"IHDR":
            if len(body) != 13:
                raise UnreadableImage(f"{path}: corrupt PNG (IHDR of {len(body)} bytes)")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            if idat_state == 2:
                raise UnreadableImage(f"{path}: corrupt PNG (IDAT chunks split by another chunk)")
            idat_state = 1
            idat.append(body)
        elif body is None:
            continue  # an ancillary chunk with a bad CRC
        elif kind == b"PLTE":
            if header[3] == 3:
                if palette is not None or idat_state or len(body) % 3 or not 3 <= len(body) <= 768:
                    raise UnreadableImage(f"{path}: corrupt PNG (bad PLTE)")
                palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"eXIf":
            orientation = _exif_orientation(body)
        elif idat_state or palette is not None:
            continue  # libpng takes gAMA and sRGB before PLTE and IDAT only
        elif kind == b"gAMA" and len(body) == 4 and file_gamma is None:
            file_gamma = struct.unpack(">I", body)[0] or None
        elif kind == b"sRGB" and len(body) == 1 and body[0] <= 3:
            file_gamma = 45455  # libpng's PNG_GAMMA_sRGB_INVERSE
    w, h, depth, color, compression, filter_method, interlace = header
    if (color not in _DEPTHS or depth not in _DEPTHS[color] or interlace > 1 or compression
            or filter_method or not 1 <= w <= _PNG_MAX_SIDE or not 1 <= h <= _PNG_MAX_SIDE):
        raise UnreadableImage(f"{path}: not a valid PNG header ({w}x{h}, bit depth {depth}, "
                              f"color type {color}, interlace {interlace})")
    if w * h > _CV2_MAX_PIXELS:
        raise ValueError(f"{path}: PNG of {w}x{h} pixels (more than 2^30, which cv2.imread "
                         "refuses too)")
    if color == 3 and palette is None:
        raise UnreadableImage(f"{path}: a palette PNG without PLTE before its image data")
    if not idat:
        raise UnreadableImage(f"{path}: a PNG without image data (no IDAT)")
    channels = _CHANNELS[color]
    stream = zlib.decompressobj()
    try:
        raw = stream.decompress(b"".join(idat))
    except zlib.error as e:
        raise UnreadableImage(f"{path}: corrupt PNG image data ({e})") from None
    if not stream.eof:
        raise UnreadableImage(f"{path}: truncated PNG image data (the zlib stream does not end)")
    raw = np.frombuffer(raw, np.uint8)
    if interlace == 0:
        img, _ = _image_rows(raw, w, h, depth, channels, path)
    else:
        img = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
            if pw and ph:
                sub, used = _image_rows(raw[at:], pw, ph, depth, channels, path)
                img[y0::dy, x0::dx] = sub
                at += used
    if color == 3:  # tRNS would only add the alpha that is dropped
        img = np.concatenate([palette, np.zeros((256 - len(palette), 3), np.uint8)])[img[:, :, 0]]
    elif depth < 8:
        img = (img * (255 // ((1 << depth) - 1))).astype(np.uint8)
    is_gray = color in (0, 4)
    if not is_gray:
        img = img[:, :, :3]
    if gray and not is_gray:
        rgb = img.astype(np.int64)
        r, g, b = rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]
        wr, wg, wb = _GRAY_WEIGHTS
        equal = (r == g) & (r == b)
        gamma = file_gamma if file_gamma is not None and not 95000 <= file_gamma <= 105000 else None
        if depth == 16:
            if gamma is not None:
                raise ValueError(f"{path}: a 16-bit colour PNG with a gamma is not read as gray")
            img = ((wr * r + wg * g + wb * b + 16384) >> 15) >> 8
        elif gamma is None:
            img = np.where(equal, r, (wr * r + wg * g + wb * b) >> 15)
        else:  # png_do_rgb_to_gray through gamma_to_1 and gamma_from_1
            screen = _reciprocal(gamma)
            to1, from1 = _gamma_table(_reciprocal(gamma)), _gamma_table(_reciprocal(screen))
            lin = (wr * to1[r] + wg * to1[g] + wb * to1[b] + 16384) >> 15
            img = np.where(equal, r, from1[lin])
        return img.astype(np.uint8), orientation
    if depth == 16:
        img = img >> 8
    img = img.astype(np.uint8)
    if gray:
        return np.ascontiguousarray(img[:, :, 0]), orientation
    if is_gray:
        return np.repeat(img[:, :, :1], 3, axis=2), orientation
    return np.ascontiguousarray(img[:, :, 2::-1]), orientation


# ------------------------------------------------------------ OpenCV's own decoders
#
# BMP, PBM/PGM/PPM, PAM, PFM, Sun raster, Radiance HDR and GIF: OpenCV's own
# code (grfmt_bmp, grfmt_pxm, grfmt_pam, grfmt_pfm, grfmt_sunras, grfmt_hdr
# with rgbe, grfmt_gif), whose rules, faults included, are reproduced here as
# cv2.imread 5.0 shows them. Plain rows decode in numpy; the run-length and
# LZW codings go to ``frn_tpu_torch/native/codecs.cpp``.

_CV2_MAX_SIDE = 1 << 20  # cv2's CV_IO_MAX_IMAGE_WIDTH and CV_IO_MAX_IMAGE_HEIGHT
_INT_MAX = (1 << 31) - 1
_SPACE = b" \t\n\v\f\r"  # C's isspace
_NEWLINE = b"\n\r"
_GRAY14 = (1868, 9617, 4899)  # B, G, R in 1/16384: OpenCV's icvCvt_BGR2Gray_8u_C3C1R
_GRAY15 = (3735, 19235, 9798)  # B, G, R in 1/32768: cv2.cvtColor's COLOR_BGR2GRAY on uint8


class _Stream:
    """OpenCV's RBaseStream over the file: a read past its end raises
    ``UnreadableImage`` (OpenCV's decoder throws there, and cv2.imread
    returns None). ``order`` '<' reads words as RLByteStream, '>' as
    RMByteStream."""

    def __init__(self, data: bytes, path: str, pos: int = 0, order: str = "<"):
        self.data, self.path, self.pos, self.order = data, path, pos, order

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise UnreadableImage(f"{self.path}: the file ends inside its header or image data")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def byte(self) -> int:
        return self.take(1)[0]

    def word(self) -> int:
        return struct.unpack(self.order + "H", self.take(2))[0]

    def int32(self) -> int:
        return struct.unpack(self.order + "i", self.take(4))[0]

    def rows(self, h: int, pitch: int) -> np.ndarray:
        """(h, pitch) bytes from here; short of them, UnreadableImage before
        anything is allocated."""
        if self.pos + h * pitch > len(self.data):
            raise UnreadableImage(f"{self.path}: {len(self.data) - self.pos} bytes of image data "
                                  f"for {h} rows of {pitch}")
        rows = np.frombuffer(self.data, np.uint8, h * pitch, self.pos).reshape(h, pitch)
        self.pos += h * pitch
        return rows


def _check_size(w: int, h: int, path: str, kind: str) -> None:
    """cv2.imread's validateInputImageSize, which raises cv2.error."""
    if not (0 < w <= _CV2_MAX_SIDE and 0 < h <= _CV2_MAX_SIDE and w * h <= _CV2_MAX_PIXELS):
        raise ValueError(f"{path}: {kind} of {w}x{h} pixels, which cv2.imread refuses with an error")


def _gray(bgr: np.ndarray, weights=_GRAY14) -> np.ndarray:
    """(H, W, 3) BGR -> gray by fixed-point weights over B, G, R, rounded."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    shift = sum(weights).bit_length() - 1
    return ((b * weights[0] + g * weights[1] + r * weights[2] + (1 << (shift - 1))) >> shift
            ).astype(np.uint8)


def _swap_rb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB <-> BGR into a new contiguous array (a copy and two
    channel assignments take a fifth of the time of a reversed view's
    copy)."""
    out = np.array(img, order="C")
    out[:, :, 0], out[:, :, 2] = img[:, :, 2], img[:, :, 0]
    return out


def _float_to_u8(v: np.ndarray, scale: np.float32) -> np.ndarray:
    """v * scale in float32 (overflowing to inf as it does in OpenCV), then
    Mat::convertTo to uint8: round half to even, saturate; a value that the
    conversion to int32 cannot hold (NaN, |x| >= 2^31) reads 0."""
    with np.errstate(over="ignore", invalid="ignore"):
        x = v * scale
        bad = ~(np.abs(x) < 2.0 ** 31)
        return np.where(bad, 0, np.clip(np.rint(np.where(bad, 0, x)), 0, 255)).astype(np.uint8)


def _native_error(rc: int, err, path: str, kind: str):
    if rc != 0:
        raise UnreadableImage(f"{path}: {kind}: {err.value.decode(errors='replace')}")


# .................................................................. BMP


def _bmp(data: bytes, path: str, gray: bool) -> np.ndarray:
    """grfmt_bmp: BITMAPCOREHEADER (12 bytes) and BITMAPINFOHEADER and
    larger (V4, V5: the fields past 40 bytes are skipped); 1, 4 and 8 bits
    with a palette (``biClrUsed`` entries, else 2^bits; unset entries black),
    BI_RLE4 and BI_RLE8; 16 bits as 5-5-5 (BI_RGB, or BI_BITFIELDS with
    those masks) or 5-6-5 (BI_BITFIELDS), each sample shifted to the top of
    its byte; 24 bits; 32 bits as B, G, R and a dropped fourth byte, or
    (BI_BITFIELDS in a header of 56 bytes or more, none of the R, G, B masks
    0) by its masks, scaled and reduced to gray in float as OpenCV does.
    Rows bottom-up, or top-down where the height is negative.
    Gray: each colour reduced by OpenCV's 14-bit weights."""
    s = _Stream(data, path, 10)
    offset, size = s.int32(), s.int32()
    if size <= 0:
        raise UnreadableImage(f"{path}: BMP header size {size}")
    palette = np.zeros((256, 3), np.uint8)  # BGR
    masks = None
    if size >= 36:
        w, h, bpp, compression = s.int32(), s.int32(), s.int32() >> 16, s.int32()
        if not 0 <= compression <= 3:
            raise UnreadableImage(f"{path}: BMP compression {compression}")
        s.pos += 12
        used = s.int32()
        if bpp == 32 and compression == 3 and size >= 56:
            s.pos += 4
            masks = [s.int32() & 0xFFFFFFFF for _ in range(4)]  # R, G, B, A
            s.pos += size - 56
        else:
            s.pos += size - 36
        if bpp <= 8:
            if not 0 <= used <= 256:
                raise UnreadableImage(f"{path}: BMP with {used} palette entries")
            n = used or 1 << (bpp & 31)
            palette[:n] = np.frombuffer(s.take(4 * n), np.uint8).reshape(n, 4)[:256, :3]
        elif bpp == 16 and compression == 3:  # R, G, B masks after the header
            rgb = (s.int32(), s.int32(), s.int32())
            bpp = {(0x7C00, 0x3E0, 0x1F): 15, (0xF800, 0x7E0, 0x1F): 16}.get(rgb, 0)
        elif bpp == 16 and compression == 0:
            bpp = 15
    elif size == 12:
        w, h, bpp, compression = s.word(), s.word(), s.int32() >> 16, 0
        if bpp <= 8:
            n = 1 << (bpp & 31)
            palette[:n] = np.frombuffer(s.take(3 * n), np.uint8).reshape(n, 3)[:256]
    else:
        raise UnreadableImage(f"{path}: unknown BMP header size {size}")
    if not (w > 0 and h != 0 and ((bpp in (1, 4, 8, 24, 32) and compression == 0)
                                  or (bpp in (15, 16, 32) and compression in (0, 3))
                                  or (bpp, compression) in ((4, 2), (8, 1)))):
        raise UnreadableImage(f"{path}: BMP of {bpp} bits with compression {compression}")
    bottom_up, h = h > 0, abs(h)
    _check_size(w, h, path, "BMP")
    if h * w * (1 if gray else 3) >= 1 << 30 or offset < 0:
        raise UnreadableImage(f"{path}: BMP of {w}x{h} pixels at offset {offset}")
    s.pos = offset
    if compression in (1, 2):
        lib = native.codecs_lib()
        index = np.empty((h, w), np.uint8)
        err = ctypes.create_string_buffer(256)
        _native_error(lib.frn_bmp_rle(data, len(data), offset, w, h, 8 if compression == 1 else 4,
                                      index.ctypes.data, err, len(err)), err, path, "BMP RLE")
    else:
        rows = s.rows(h, ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4)
        if bpp <= 8:
            if bpp == 8:
                index = rows[:, :w]
            else:
                per = 8 // bpp
                shifts = (8 - bpp) - bpp * np.arange(per)  # the first pixel in the high bits
                index = ((rows[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(h, -1)[:, :w]
        elif bpp in (15, 16):
            t = rows[:, :2 * w].view("<u2").astype(np.int32)
            fields = (((t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8) if bpp == 15 else
                      ((t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8))
            img = np.stack(fields, axis=-1).astype(np.uint8)
        elif bpp == 32 and masks is not None and all(masks[:3]):
            img = _bmp_masked(rows[:, :4 * w].view("<u4"), masks)
            if gray:  # OpenCV reduces these in float: (0.299 R + 0.587 G) + 0.114 B, truncated
                b, g, r = (img[..., i].astype(np.float32) for i in range(3))
                f = np.float32
                img = ((f(0.299) * r + f(0.587) * g) + f(0.114) * b).astype(np.uint8)
                return np.ascontiguousarray(img[::-1] if bottom_up else img)
        else:
            img = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)[:, :, :3]
    if bpp <= 8:
        img = (_gray(palette[None]).reshape(256) if gray else palette)[index]
    elif gray:
        img = _gray(img)
    return np.ascontiguousarray(img[::-1] if bottom_up else img)


def _bmp_masked(pixels: np.ndarray, masks) -> np.ndarray:
    """grfmt_bmp's masks for 32-bit BI_BITFIELDS: each channel's bits
    shifted down and scaled to 8 bits in float, v * (255.0f / (mask >>
    shift)), truncated."""
    out = []
    for mask in (masks[2], masks[1], masks[0]):  # B, G, R
        shift = (mask & -mask).bit_length() - 1
        v = ((pixels.astype(np.uint64) & mask) >> shift).astype(np.float32)
        out.append((v * (np.float32(255) / np.float32(mask >> shift))).astype(np.uint8))
    return np.stack(out, axis=-1)


# .................................................................. Sun raster


def _sunras(data: bytes, path: str, gray: bool) -> np.ndarray:
    """grfmt_sunras: depths 1, 8 (with or without an RGB colour map), 24 and
    32 (a dropped pad byte, then B, G, R), types old (0) and standard (1);
    rows padded to 16 bits. OpenCV's decoder tests the byte-encoded (2) and
    RGB (3) types against a field that never holds them, so it refuses both
    (None), and reads a map-less 1- or 8-bit file as zeros under
    IMREAD_GRAYSCALE (its gray palette is built from a colour map only)."""
    s = _Stream(data, path, 4, ">")
    w, h, bpp = s.int32(), s.int32(), s.int32()
    s.pos += 4
    kind, map_type, map_length = s.int32(), s.int32(), s.int32()
    pal_size = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    if not (w > 0 and h > 0 and bpp in (1, 8, 24, 32) and kind in (0, 1)
            and ((map_type == 0 and map_length == 0)
                 or (map_type == 1 and 0 < map_length <= pal_size and bpp <= 8))):
        raise UnreadableImage(f"{path}: Sun raster of type {kind}, depth {bpp}, map type {map_type} "
                              f"of {map_length} bytes")
    palette = np.zeros((256, 3), np.uint8)  # BGR
    if map_length:
        m = np.frombuffer(s.take(map_length), np.uint8)
        n = map_length // 3
        palette[:n] = np.stack([m[2 * n:3 * n], m[n:2 * n], m[:n]], axis=1)
    elif bpp <= 8:
        palette[:1 << bpp] = (np.arange(1 << bpp) * 255 // ((1 << bpp) - 1))[:, None]
    _check_size(w, h, path, "Sun raster")
    rows = s.rows(h, ((w * bpp + 7) // 8 + 1) & -2)
    if bpp == 1:
        index = np.unpackbits(rows, axis=1)[:, :w]
    elif bpp == 8:
        index = rows[:, :w]
    else:  # 32 bits: a pad byte, then B, G, R
        img = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)[:, :, bpp // 8 - 3:]
        return _gray(img) if gray else np.ascontiguousarray(img)
    if gray:
        return (_gray(palette[None]).reshape(256) if map_type == 1 else
                np.zeros(256, np.uint8))[index]
    return palette[index]


# .................................................................. PBM, PGM, PPM

_PXM_NUMBER = re.compile(rb"(?:[ \t\n\v\f\r]+|#[^\n\r]*[\n\r])*([0-9]+)")
_PXM_BIT = re.compile(rb"(?:[ \t\n\v\f\r]+|#[^\n\r]*[\n\r])*([0-9])")


def _pxm_number(s: _Stream, one_digit: bool = False) -> int:
    """grfmt_pxm's ReadNumber: whitespace and '#' comments (to a CR or LF)
    skipped, then the digits and the one byte that ends them (P1's samples:
    one digit, nothing after it); any other byte, the file's end or a value
    past INT_MAX raises UnreadableImage."""
    m = (_PXM_BIT if one_digit else _PXM_NUMBER).match(s.data, s.pos)
    digits = m.group(1).lstrip(b"0") if m else b""
    end = m.end() + (not one_digit) if m else 0
    if m is None or end > len(s.data) or len(digits) > 10 or int(digits or 0) > _INT_MAX:
        raise UnreadableImage(f"{s.path}: bad PNM header or sample at byte {s.pos}")
    s.pos = end
    return int(digits or 0)


def _pxm(data: bytes, path: str, gray: bool) -> np.ndarray:
    """grfmt_pxm, P1-P6. ASCII samples above maxval read as maxval and are
    scaled to 8 bits by i * 255 // maxval; binary samples are taken as they
    are, the high byte of a 16-bit one (maxval above 255); P1/P4 1 is black.
    A PPM under IMREAD_GRAYSCALE is reduced by OpenCV's 14-bit weights."""
    kind = data[1] - 48
    s = _Stream(data, path, 2)
    w, h = _pxm_number(s), _pxm_number(s)
    maxval = _pxm_number(s) if kind not in (1, 4) else 1
    if not (w > 0 and h > 0 and 0 < maxval < 65536):
        raise UnreadableImage(f"{path}: PNM of {w}x{h} pixels, maxval {maxval}")
    _check_size(w, h, path, "PNM")
    channels = 3 if kind in (3, 6) else 1
    if kind == 4:
        img = np.unpackbits(s.rows(h, (w + 7) // 8), axis=1)[:, :w]
    elif kind == 1:
        img = np.array([_pxm_number(s, True) != 0 for _ in range(w * h)], np.uint8)
    elif kind in (2, 3):
        values = np.array([_pxm_number(s) for _ in range(w * h * channels)], np.int64)
        img = np.minimum(values, maxval)
        if maxval < 256:
            img = img * 255 // maxval
        else:
            img = img >> 8
    elif maxval < 256:
        img = s.rows(h, w * channels)
    else:
        img = s.rows(h, 2 * w * channels)[:, 0::2]
    if kind in (1, 4):  # 1 is black
        img = (1 - img) * 255
    img = img.astype(np.uint8).reshape(h, w, channels)
    if channels == 3:
        return _gray(img[:, :, ::-1]) if gray else _swap_rb(img)
    return np.ascontiguousarray(img[:, :, 0]) if gray else np.repeat(img, 3, axis=2)


# .................................................................. PAM

_PAM_FIELDS = (b"ENDHDR", b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE")
_PAM_TUPLES = (b"", b"BLACKANDWHITE", b"GRAYSCALE", b"GRAYSCALE_ALPHA", b"RGB", b"RGB_ALPHA")


def _pam_line(s: _Stream):
    """grfmt_pam's ReadPAMHeaderLine -> (field, value) or ('#', None) for a
    comment; UnreadableImage where OpenCV's reader fails. An identifier is
    at most 8 bytes; the value is what follows it after any whitespace,
    line breaks included, to a CR or LF (at most 255 bytes), trailing
    whitespace cut."""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    if code == 35:  # '#'
        while s.byte() not in _NEWLINE:
            pass
        return "#", None
    ident = bytearray()
    while len(ident) < 8 and code not in _SPACE:
        ident.append(code)
        code = s.byte()
    field = bytes(ident).split(b"\0")[0]
    if code not in _SPACE or field not in _PAM_FIELDS:
        raise UnreadableImage(f"{s.path}: bad PAM header line {bytes(ident)!r}")
    if code in _NEWLINE:
        return field, b""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    value = bytearray()
    while len(value) < 255 and code not in _NEWLINE:
        value.append(code)
        code = s.byte()
    if code not in _NEWLINE:
        raise UnreadableImage(f"{s.path}: PAM header value of more than 255 bytes")
    while value and value[-1] in _SPACE:
        value.pop()
    return field, bytes(value).split(b"\0")[0]


def _pam_int(value: bytes, path: str) -> int:
    """grfmt_pam's ParseInt: an optional '-', digits below INT_MAX, nothing
    after them."""
    m = re.fullmatch(rb"(-?)([0-9]*)", value)
    if m is None or (m.group(1) and not m.group(2)) or int(m.group(2) or 0) >= _INT_MAX:
        raise UnreadableImage(f"{path}: PAM header number {value!r}")
    return -int(m.group(2)) if m.group(1) else int(m.group(2) or 0)


def _pam(data: bytes, path: str, gray: bool) -> np.ndarray:
    """grfmt_pam, as OpenCV 5 reads it. The tuple type fixes the depth
    (BLACKANDWHITE and GRAYSCALE 1, GRAYSCALE_ALPHA 2, RGB 3, RGB_ALPHA 4;
    none given: depth 1, or 3 below maxval 256). Maxval 1 reads each row's
    first bytes as packed bits, 1 white; 16-bit samples keep their high
    byte. A depth equal to the flag's channel count is copied as it is (an
    RGB file's R lands in the blue channel); RGB under IMREAD_GRAYSCALE is
    reduced as if its first sample were red; gray under IMREAD_COLOR is
    repeated. The alpha types go through OpenCV's basic_conversion, which
    walks only the first 1/DEPTH of each row and, for gray, writes three
    bytes a sample: where that leaves pixels unwritten (their values are
    whatever the allocation held), this reader raises ValueError."""
    if data[2] not in _NEWLINE:
        raise UnreadableImage(f"{path}: PAM signature not followed by a line break")
    s = _Stream(data, path, 3)
    fields: dict = {}
    while True:
        field, value = _pam_line(s)
        if field == b"ENDHDR":
            break
        if field == b"TUPLTYPE":
            if value not in _PAM_TUPLES:
                raise UnreadableImage(f"{path}: PAM tuple type {value!r}")
            fields[field] = _PAM_TUPLES.index(value)
        elif field != "#":
            if field in fields:
                raise UnreadableImage(f"{path}: PAM header repeats {field.decode()}")
            fields[field] = _pam_int(value, path)
            if field == b"MAXVAL" and fields[field] > 65535:
                raise UnreadableImage(f"{path}: PAM maxval {fields[field]}")
    if not {b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"} <= fields.keys():
        raise UnreadableImage(f"{path}: PAM header without WIDTH, HEIGHT, DEPTH and MAXVAL")
    w, h, ch, maxval = (fields[k] for k in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    tuple_type = fields.get(b"TUPLTYPE", 0) or (1 if ch == 1 and maxval == 1 else
                                                2 if ch == 1 and maxval < 256 else
                                                4 if ch == 3 and maxval < 256 else 0)
    if tuple_type == 0 or (None, 1, 1, 2, 3, 4)[tuple_type] != ch:
        raise UnreadableImage(f"{path}: PAM of depth {ch} and tuple type "
                              f"{_PAM_TUPLES[tuple_type].decode() or 'none'}")
    _check_size(w, h, path, "PAM")
    depth = 2 if maxval > 255 else 1
    rows = s.rows(h, w * ch * depth)
    if maxval == 1:  # packed bits, 1 white
        img = np.unpackbits(rows[:, :(w + 7) // 8], axis=1)[:, :w] * np.uint8(255)
        return img if gray else np.repeat(img[:, :, None], 3, axis=2)
    samples = (rows[:, 0::2] if depth == 2 else rows).reshape(h, w, ch)
    if ch == (1 if gray else 3):
        return np.ascontiguousarray(samples[:, :, 0] if gray else samples)
    if ch == 1:
        return np.repeat(samples, 3, axis=2)
    if ch == 3:  # rgb_convert: the first sample taken as red
        return _gray(samples, (_GRAY14[2], _GRAY14[1], _GRAY14[0]))
    # basic_conversion over the first ceil(w / ch) samples of each row
    m = -(-w // ch)
    if (3 * m < w) if gray else (m < w):
        raise ValueError(f"{path}: PAM of tuple type {_PAM_TUPLES[tuple_type].decode()} under "
                         f"{'IMREAD_GRAYSCALE' if gray else 'IMREAD_COLOR'}: OpenCV's reader leaves "
                         "part of it uninitialized, so no reader can give its pixels")
    first = samples.reshape(h, -1)[:, :m * ch].reshape(h, m, ch)
    if gray:  # three bytes a sample; what runs past a row is overwritten by the next
        return np.ascontiguousarray(np.repeat(first[:, :, 0], 3, axis=1)[:, :w])
    return np.ascontiguousarray(first[:, :, [2, 1, 0]] if ch == 4 else np.repeat(first[:, :, :1], 3, 2))


# .................................................................. PFM

_ATOI = re.compile(rb"[+-]?[0-9]+")
_ATOF = re.compile(
    rb"[+-]?(?:(0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?[0-9]+)?)"
    rb"|((?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?)|([iI][nN][fF](?:[iI][nN][iI][tT][yY])?)"
    rb"|([nN][aA][nN](?:\([0-9A-Za-z_]*\))?))")


def _pfm_token(s: _Stream) -> bytes:
    """grfmt_pfm's read_number: the bytes up to the next whitespace (at most
    2048, none of them above 127), as a C string."""
    token = bytearray()
    while len(token) < 2048:
        c = s.byte()
        if c >= 128:
            raise UnreadableImage(f"{s.path}: byte {c} in the PFM header")
        if c in _SPACE:
            break
        token.append(c)
    return bytes(token).split(b"\0")[0]


def _atoi(token: bytes) -> int:
    """C's atoi through strtol: long saturation, then the low 32 bits."""
    m = _ATOI.match(token)
    v = max(-(1 << 63), min((1 << 63) - 1, int(m.group()))) if m else 0
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _atof(token: bytes) -> float:
    """C's atof (strtod on its longest valid prefix)."""
    m = _ATOF.match(token)
    if m is None:
        return 0.0
    text, sign = m.group().decode(), -1.0 if m.group().startswith(b"-") else 1.0
    if m.group(1):
        try:
            return float.fromhex(text)
        except OverflowError:
            return sign * math.inf
    if m.group(3) or m.group(4):
        return sign * (math.inf if m.group(3) else math.nan)
    return float(text)


def _pfm(data: bytes, path: str, gray: bool) -> np.ndarray:
    """grfmt_pfm: 'PF' colour (RGB on disk), 'Pf' gray; rows bottom to
    top; a scale of 0 or above is big-endian, below it little-endian; the
    floats times (float) 1/|scale|, then Mat::convertTo to uint8. OpenCV 5
    returns None where the flag asks for the other channel count (it
    converts into a new array and then fails its own check)."""
    if data[2] != 10:
        raise UnreadableImage(f"{path}: PFM signature not followed by a line feed")
    channels = 3 if data[1] == 70 else 1  # 'F'
    s = _Stream(data, path, 3)
    w, h, scale = _atoi(_pfm_token(s)), _atoi(_pfm_token(s)), _atof(_pfm_token(s))
    _check_size(w, h, path, "PFM")
    if channels != (1 if gray else 3):
        raise UnreadableImage(f"{path}: a {'colour' if channels == 3 else 'gray'} PFM under "
                              f"{'IMREAD_GRAYSCALE' if gray else 'IMREAD_COLOR'}, which cv2.imread "
                              "returns None for")
    rows = s.rows(h, 4 * w * channels)
    if not abs(scale) > 0:
        raise UnreadableImage(f"{path}: PFM scale {scale}")
    v = rows[::-1].view(">f4" if scale >= 0 else "<f4").astype(np.float32).reshape(h, w, channels)
    img = _float_to_u8(v, np.float32(1.0 / abs(scale)))
    return np.ascontiguousarray(img[:, :, 0] if gray else img[:, :, ::-1])


# .................................................................. Radiance HDR

_HDR_SIZE = re.compile(rb"-Y[ \t\n\v\f\r]*([ \t\n\v\f\r]*[+-]?[0-9]+)[ \t\n\v\f\r]*\+X"
                       rb"[ \t\n\v\f\r]*([ \t\n\v\f\r]*[+-]?[0-9]+)")


def _fgets(data: bytes, pos: int):
    """C's fgets with a 128-byte buffer -> (the line as a C string, the
    position after it), or None at the end of the file."""
    if pos >= len(data):
        return None
    end = data.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end].split(b"\0")[0], end


def _hdr(data: bytes, path: str, gray: bool) -> np.ndarray:
    """grfmt_hdr and rgbe's RGBE_ReadHeader: header lines (none a bare line
    feed) up to exactly 'FORMAT=32-bit_rle_rgbe', an empty line, then '-Y
    <h> +X <w>' (the only orientation read); the pixels by ``codecs.cpp``; each float
    times 255 to uint8 as Mat::convertTo rounds it; gray from that BGR as
    cv2.cvtColor reduces it."""
    line = _fgets(data, 0)
    while True:
        if line is None:
            raise UnreadableImage(f"{path}: Radiance HDR header cut")
        text, pos = line
        if text == b"\n":
            raise UnreadableImage(f"{path}: Radiance HDR header without a FORMAT line")
        if text == b"FORMAT=32-bit_rle_rgbe\n":
            break
        line = _fgets(data, pos)
    line = _fgets(data, pos)
    if line is None or line[0] != b"\n":
        raise UnreadableImage(f"{path}: Radiance HDR FORMAT line not followed by an empty line")
    line = _fgets(data, line[1])
    m = _HDR_SIZE.match(line[0]) if line else None
    if m is None:
        raise UnreadableImage(f"{path}: Radiance HDR without a '-Y <height> +X <width>' line")
    h, w = (_atoi(g.strip(_SPACE)) for g in m.groups())
    if w <= 0 or h <= 0:
        raise UnreadableImage(f"{path}: Radiance HDR of {w}x{h} pixels")
    _check_size(w, h, path, "Radiance HDR")
    pos = line[1]
    # the fewest bytes such a frame takes (run-length scanlines of one run a
    # channel each 127 pixels), so that a short file allocates nothing
    least = h * (4 + 8 * -(-w // 127)) if 8 <= w <= 0x7FFF else 4 * w * h
    if len(data) - pos < least:
        raise UnreadableImage(f"{path}: {len(data) - pos} bytes of pixels for a {w}x{h} HDR")
    lib = native.codecs_lib()
    v = np.empty((h, w, 3), np.float32)
    err = ctypes.create_string_buffer(256)
    _native_error(lib.frn_hdr_pixels(data, len(data), pos, w, h, v.ctypes.data, err, len(err)),
                  err, path, "Radiance HDR")
    img = _float_to_u8(v, np.float32(255))
    return _gray(img, _GRAY15) if gray else img


# .................................................................. GIF


def _gif_blocks(s: _Stream) -> list:
    """The data sub-blocks from here to their terminator."""
    blocks = []
    while (n := s.byte()) != 0:
        blocks.append(s.take(n))
    return blocks


def _gif(data: bytes, path: str, gray: bool) -> np.ndarray:
    """grfmt_gif, the first frame: the logical screen filled with the
    global table's background colour (black without a global table), the
    frame's pixels drawn on it except where a Graphic Control Extension
    marks them transparent; a frame without any colour table takes a gray
    ramp (index 1 white). None where OpenCV's reader gives up: a background
    index past the global table, a Graphic Control Extension of another
    length than 4 or with a disposal method above 3, an application
    extension other than NETSCAPE2.0 with a block of 3 bytes, a frame outside the
    screen, an index past its table, LZW data that does not end the frame
    exactly (``codecs.cpp``), a block structure broken anywhere in the file.
    Gray as cv2.cvtColor reduces the BGR."""
    s = _Stream(data, path, 6)
    sw, sh = s.word(), s.word()
    flags, background = s.byte(), s.byte()
    s.byte()
    if sw == 0 or sh == 0:
        raise UnreadableImage(f"{path}: GIF screen of {sw}x{sh}")
    table = None
    if flags & 0x80:
        n = 1 << ((flags & 7) + 1)
        table = np.frombuffer(s.take(3 * n), np.uint8).reshape(n, 3)
        if background >= n:
            raise UnreadableImage(f"{path}: GIF background index {background} past its table")
    start = s.pos
    while (kind := s.byte()) != 0x3B:  # the whole file's blocks, as OpenCV counts frames
        if kind == 0x21:
            label, blocks = s.byte(), _gif_blocks(s)
            # OpenCV reads a block of 3 bytes in an application extension as
            # NETSCAPE2.0's loop count, and refuses it under another name
            if label == 0xFF and blocks and blocks[0] != b"NETSCAPE2.0" and any(
                    len(b) == 3 for b in blocks):
                raise UnreadableImage(f"{path}: GIF application extension {blocks[0]!r} with a "
                                      "block of 3 bytes")
        elif kind == 0x2C:
            s.take(8)
            f = s.byte()
            s.take(3 << ((f & 7) + 1) if f & 0x80 else 0)
            s.byte()
            _gif_blocks(s)
        else:
            raise UnreadableImage(f"{path}: GIF block {kind:#x}")
    _check_size(sw, sh, path, "GIF")
    s.pos, transparent = start, None
    while (kind := s.byte()) == 0x21:
        if s.byte() == 0xF9:
            if s.byte() != 4:
                raise UnreadableImage(f"{path}: GIF Graphic Control Extension not of 4 bytes")
            packed, _, index = s.byte(), s.word(), s.byte()
            if (packed >> 2) & 7 > 3:
                raise UnreadableImage(f"{path}: GIF disposal method {(packed >> 2) & 7}")
            transparent = index if packed & 1 else None
        _gif_blocks(s)
    if kind != 0x2C:
        raise UnreadableImage(f"{path}: GIF without a frame")
    left, top, w, h = s.word(), s.word(), s.word(), s.word()
    frame_flags = s.byte()
    if not (w > 0 and h > 0 and left + w <= sw and top + h <= sh):
        raise UnreadableImage(f"{path}: GIF frame {w}x{h} at ({left}, {top}) off its {sw}x{sh} screen")
    if frame_flags & 0x80:
        n = 1 << ((frame_flags & 7) + 1)
        colours = np.frombuffer(s.take(3 * n), np.uint8).reshape(n, 3)
    elif table is not None:
        colours = table
    else:
        colours = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        colours[1] = 255
    # the most pixels LZW codes of 3 or more bits in the rest of the file can
    # give, so that a short file allocates nothing
    codes = 8 * (len(data) - s.pos) // 3
    if w * h > codes * (codes + 3) // 2:
        raise UnreadableImage(f"{path}: a {w}x{h} GIF frame from {len(data) - s.pos} bytes")
    lib = native.codecs_lib()
    index = np.empty((h, w), np.uint8)
    err = ctypes.create_string_buffer(256)
    _native_error(lib.frn_gif_lzw(data, len(data), s.pos, w * h, index.ctypes.data, err, len(err)),
                  err, path, "GIF")
    if frame_flags & 0x40:  # interlaced: rows stored in four passes
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        index[order] = index.copy()
    drawn = np.ones_like(index, bool) if transparent is None else index != transparent
    if int(index[drawn].max(initial=0)) >= len(colours):
        raise UnreadableImage(f"{path}: GIF colour index past its table of {len(colours)}")
    canvas = np.empty((sh, sw, 3), np.uint8)
    canvas[:] = 0 if table is None else table[background]
    frame = canvas[top:top + h, left:left + w]
    frame[drawn] = colours[index[drawn]]
    return _gray(canvas[:, :, ::-1], _GRAY15) if gray else _swap_rb(canvas)


def _opencv_decoder(data: bytes):
    """The decoder of the formats above that OpenCV would pick by content
    (its decoders' checkSignature), or None."""
    if data[:2] == b"BM":
        return _bmp
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return _gif
    if data[:6] == b"#?RGBE" or data[:10] == b"#?RADIANCE":
        return _hdr
    if data[:4] == b"\x59\xa6\x6a\x95":
        return _sunras
    if len(data) >= 3 and data[:1] == b"P" and data[2] in _SPACE:
        return {**dict.fromkeys(b"123456", _pxm), ord("7"): _pam,
                ord("F"): _pfm, ord("f"): _pfm}.get(data[1])
    return None


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """BGR (H, W, 3) uint8, or gray (H, W) uint8 with ``IMREAD_GRAYSCALE``."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"imread flags must be IMREAD_COLOR or IMREAD_GRAYSCALE, got {flags}")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    gray = flags == IMREAD_GRAYSCALE
    if data[:3] == _JPEG_SIGNATURE:
        img, orientation = _jpeg(data, path, gray)
    elif data[:8] == _SIGNATURE:
        img, orientation = _png(data, path, gray)
    elif (decoder := _opencv_decoder(data)) is not None:
        img, orientation = decoder(data, path, gray), 1
    else:
        name = _format_name(data)
        if name is None:
            raise UnreadableImage(f"{path}: bytes that no OpenCV decoder recognizes")
        raise ValueError(f"{path}: {name} file; this reader decodes JPEG, PNG, BMP, PBM/PGM/PPM, "
                         "PAM, PFM, Sun raster, Radiance HDR and GIF only (the JAX package reads "
                         f"{name} through OpenCV)")
    return _orient(img, orientation)


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
