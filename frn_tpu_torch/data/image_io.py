"""Image reading and PNG writing without OpenCV: every format whose decoder
OpenCV has in its own code or in libjpeg-turbo, libpng and libtiff.

``imread`` returns what ``cv2.imread`` returns, bit for bit, for JPEG, PNG,
BMP, PBM/PGM/PPM, PAM, PFM, Sun raster, Radiance HDR, GIF and TIFF files,
damaged ones included; the JAX package reads them with OpenCV. OpenCV picks its
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
* TIFF follows OpenCV's reader over libtiff 4.7.1 (see ``_tiff``): the
  first directory of a classic or BigTIFF file, strips or tiles, planar 1
  or 2, uncompressed, LZW (old-style codes too), Deflate, PackBits or JPEG
  with the predictor, gray, palette, RGB(A), CMYK and YCbCr at the depths
  libtiff's RGBA reader takes, orientations 1-4 (5-8 give None in OpenCV
  5.0); LZW, Deflate and PackBits decode in ``frn_tpu_torch/native/tiff.cpp``
  and JPEG strips in ``native/jpeg.cpp`` (without the library such a file
  raises ``RuntimeError``). CCITT RLE, Group 3 and Group 4, old-style JPEG,
  NeXT, ThunderScan, PixarLog, SGILog and CIELab, LogL and LogLuv images
  raise ``ValueError`` naming the kind; compressions OpenCV's libtiff is
  built without (ZSTD, LZMA, WebP, JBIG, JPEG XL, LERC), float samples and
  the other kinds libtiff refuses raise ``UnreadableImage``.
* The EXIF orientation (a JPEG's first APP1 segment, a PNG's ``eXIf`` chunk)
  turns the image as ``cv2.imread`` turns it.

Errors: a missing file raises ``FileNotFoundError``; an existing file that
``cv2.imread`` returns None for raises ``UnreadableImage`` (a ``ValueError``;
also for bytes no OpenCV decoder recognizes, as a file cut before its
signature); where ``cv2.imread`` raises ``cv2.error`` (a frame over 2^30
pixels or 2^20 a side) this reader raises a plain ``ValueError``, as it does
for a file that OpenCV reads and this reader does not (WebP, JPEG 2000,
AVIF/HEIF, and the JPEG and TIFF kinds above), naming it. The datasets turn
``UnreadableImage`` into the JAX package's answer to the None.

``imwrite`` writes uint8 (H, W) gray, or (H, W, C) with C 1, 3 (BGR) or 4
(BGRA), as ``cv2.imwrite`` does; every row takes the same filter
(``filter_type``, default Up).
"""

from __future__ import annotations

import ctypes
import functools
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
_OTHER_FORMATS = ((b"\xffO\xffQ", "JPEG 2000"), (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"))
_TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")  # classic and BigTIFF


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
    info = np.zeros(12, np.int32)
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
    """(H, W, 3) BGR -> gray by fixed-point weights over B, G, R, rounded;
    a band of rows at a time, so that the int32 sums stay small."""
    shift = sum(weights).bit_length() - 1
    out = np.empty(bgr.shape[:-1], np.uint8)
    step = max(1, (1 << 18) // max(1, int(np.prod(bgr.shape[1:-1]))))
    for y in range(0, bgr.shape[0], step):
        b, g, r = (bgr[y:y + step, ..., i].astype(np.int32) for i in range(3))
        out[y:y + step] = (b * weights[0] + g * weights[1] + r * weights[2] + (1 << (shift - 1))) >> shift
    return out


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


# .................................................................. TIFF
#
# grfmt_tiff over libtiff 4.7.1, as cv2.imread 5.0 shows them. OpenCV reads
# every 8-bit output through libtiff's TIFFRGBAImage (TIFFReadRGBAStrip and
# TIFFReadRGBATile, a call a strip or a tile) and converts the RGBA it gets
# to BGR or gray; libtiff's RGBA reader does not stop on a decoding error,
# so a damaged strip gives what its decoder wrote into a zeroed buffer. The
# strip and tile codings decode in ``frn_tpu_torch/native/tiff.cpp`` (LZW,
# Deflate, PackBits) and ``native/jpeg.cpp`` (JPEG); the directory, the
# predictor and the photometric conversions here.

_TIFF_WIDTH = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8,
               17: 8, 18: 8}
_TIFF_FORMAT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 13: "I", 16: "Q", 17: "q", 18: "Q"}
# the entry types libtiff's TIFFReadDirEntry{Short,Long,Long8}[Array] take,
# and the range each keeps
_TIFF_READS = {"short": ((1, 3, 4, 6, 8, 9, 16, 17), 0xFFFF), "long": ((1, 3, 4, 6, 8, 9, 13, 16, 17, 18),
                                                                      0xFFFFFFFF),
               "long8": ((1, 3, 4, 6, 8, 9, 16, 17), (1 << 64) - 1)}
_TIFF_NONE, _TIFF_LZW, _TIFF_JPEG, _TIFF_DEFLATE, _TIFF_PACKBITS = 1, 5, 7, (8, 32946), 32773
# the compressions libtiff knows that this reader leaves out, by name (those
# that OpenCV's libtiff has no code for are refused as not configured)
_TIFF_LEFT_OUT = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old-style JPEG",
                  32771: "CCITT RLEW", 32766: "NeXT", 32809: "ThunderScan", 32909: "PixarLog",
                  34676: "SGILog", 34677: "SGILog24"}
_TIFF_NOT_CONFIGURED = (34661, 34925, 50000, 50001, 50002, 34887)  # JBIG, LZMA, ZSTD, WebP, JPEG XL, LERC
_TIFF_MAX_COUNT = (1 << 32) - 1


class _TiffEntryError(Exception):
    """A directory entry that libtiff's TIFFReadDirEntry* functions refuse."""


class _Tiff:
    """The first directory of a TIFF as libtiff 4.7's TIFFReadDirectory
    reads it (the fields the RGBA reader uses), or UnreadableImage where it
    fails and TIFFOpen returns NULL."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path, self.upsampled = data, path, False
        self.e = "<" if data[:2] == b"II" else ">"
        self.big = data[2:4] in (b"+\0", b"\0+")
        if len(data) < (16 if self.big else 8):
            self.fail("the file ends inside its header")
        if self.big:
            size, unused, off = struct.unpack_from(self.e + "HHQ", data, 4)
            if size != 8 or unused != 0:
                self.fail("a BigTIFF header with a bad offset size")
        else:
            off = struct.unpack_from(self.e + "I", data, 4)[0]
        self.entries = self.directory(off)
        self.read_fields()

    def fail(self, why: str):
        raise UnreadableImage(f"{self.path}: TIFF: {why}")

    def directory(self, off: int) -> dict:
        """TIFFFetchDirectory: {tag: (type, count, value field)}, the first
        entry of a tag kept (libtiff ignores the later ones)."""
        head, size, count_fmt = (8, 20, "Q") if self.big else (2, 12, "H")
        if off + head > len(self.data):
            self.fail("the directory is past the end of the file")
        n = struct.unpack_from(self.e + count_fmt, self.data, off)[0]
        if n > 4096:
            self.fail(f"a directory of {n} entries")
        if off + head + n * size > len(self.data):
            self.fail("the directory runs past the end of the file")
        entries = {}
        fmt = self.e + ("HHQ8s" if self.big else "HHI4s")
        for i in range(n):
            tag, typ, count, value = struct.unpack_from(fmt, self.data, off + head + i * size)
            entries.setdefault(tag, (typ, count, value))
        return entries

    def values(self, tag: int, kind: str, limit: int = None) -> list:
        """An entry's values as TIFFReadDirEntry{Short,Long,Long8}Array
        reads them (at most ``limit``); _TiffEntryError where it fails."""
        typ, count, value = self.entries[tag]
        types, top = _TIFF_READS[kind]
        if typ not in types:
            raise _TiffEntryError("type")
        n = count if limit is None else min(count, limit)
        width = _TIFF_WIDTH[typ]
        if n == 0:
            return []
        if n * width > 0x7FFFFFFF:
            raise _TiffEntryError("size")
        inline = 8 if self.big else 4
        if min(count, 10) * width <= inline and n * width <= inline:
            buf, at = value, 0
        else:
            buf, at = self.data, struct.unpack(self.e + ("Q" if self.big else "I"), value)[0]
            if at + n * width > len(self.data):
                raise _TiffEntryError("io")
        vals = struct.unpack_from(f"{self.e}{n}{_TIFF_FORMAT[typ]}", buf, at)
        if any(v < 0 or v > top for v in vals):
            raise _TiffEntryError("range")
        return list(vals)

    def value(self, tag: int, kind: str) -> int:
        if self.entries[tag][1] != 1:
            raise _TiffEntryError("count")
        return self.values(tag, kind)[0]

    def persample(self, tag: int) -> int:
        """TIFFReadDirEntryShort, else TIFFReadDirEntryPersampleShort (a
        value a sample, all equal) where the count is not 1."""
        try:
            return self.value(tag, "short")
        except _TiffEntryError as err:
            if str(err) != "count":
                raise
        if self.entries[tag][1] < self.spp:
            raise _TiffEntryError("count")
        vals = self.values(tag, "short")
        if len(set(vals[:self.spp])) != 1:
            raise _TiffEntryError("per-sample values differ")
        return vals[0]

    def floats(self, tag: int, count: int):
        """A float array tag of a fixed count (RATIONAL, FLOAT or DOUBLE, as
        float32), or None where it is absent or libtiff ignores it."""
        if tag not in self.entries:
            return None
        typ, n, value = self.entries[tag]
        if n != count or typ not in (5, 11, 12):
            return None
        width = _TIFF_WIDTH[typ] * n
        at = struct.unpack(self.e + ("Q" if self.big else "I"), value)[0] if width > len(value) else None
        if at is not None and at + width > len(self.data):
            return None
        buf = value if at is None else self.data[at:at + width]
        if typ == 5:
            pairs = struct.unpack(f"{self.e}{2 * n}I", buf)
            vals = [0.0 if d == 0 else m / d for m, d in zip(pairs[0::2], pairs[1::2])]
        else:
            vals = struct.unpack(f"{self.e}{n}{'f' if typ == 11 else 'd'}", buf)
        return [float(np.float32(v)) for v in vals]

    def required(self, tag: int, kind: str, what: str) -> int:
        try:
            return self.value(tag, kind)
        except _TiffEntryError as err:
            self.fail(f"{what}: {err}")

    def optional(self, tag: int, kind: str):
        """A tag of TIFFReadDirectory's second pass: None where it is absent
        or libtiff ignores it for an error."""
        if tag not in self.entries:
            return None
        try:
            return self.value(tag, kind)
        except _TiffEntryError:
            return None

    def read_fields(self):
        ent = self.entries
        self.spp = self.required(277, "short", "SamplesPerPixel") if 277 in ent else 1
        if self.spp == 0:
            self.fail("SamplesPerPixel 0")
        self.compression = 1
        if 259 in ent:
            try:
                self.compression = self.persample(259)
            except _TiffEntryError as err:
                self.fail(f"Compression: {err}")
        # the first pass
        if 256 not in ent and 257 not in ent:
            self.fail("no ImageWidth or ImageLength")
        self.width = self.required(256, "long", "ImageWidth") if 256 in ent else 0
        self.length = self.required(257, "long", "ImageLength") if 257 in ent else 0
        self.tiled = 322 in ent or 323 in ent
        self.tile_width = self.required(322, "long", "TileWidth") if 322 in ent else 0
        self.tile_length = self.required(323, "long", "TileLength") if 323 in ent else 0
        self.planar = self.required(284, "short", "PlanarConfiguration") if 284 in ent else 1
        if self.planar not in (1, 2):
            self.fail(f"PlanarConfiguration {self.planar}")
        self.rows_set = 278 in ent
        self.rows = self.required(278, "long", "RowsPerStrip") if self.rows_set else _TIFF_MAX_COUNT
        if self.rows == 0:
            self.fail("RowsPerStrip 0")
        self.extras = []
        if 338 in ent:
            try:
                if ent[338][1] > 0xFFFF:
                    raise _TiffEntryError("count")
                extras = self.values(338, "short")
            except _TiffEntryError as err:
                self.fail(f"ExtraSamples: {err}")
            extras = [2 if v == 999 else v for v in extras]  # libtiff mends Corel Draw's 999
            if len(extras) > self.spp or any(v > 2 for v in extras):
                self.fail(f"ExtraSamples {extras}")
            self.extras = extras
        self.nstrips = self.count_strips()
        if self.nstrips == 0:
            self.fail(f"zero {'tiles' if self.tiled else 'strips'}")
        self.per_plane = self.nstrips // self.spp if self.planar == 2 else self.nstrips
        offsets_tags = [t for t in (273, 324) if t in ent]
        if not offsets_tags:
            self.fail("no StripOffsets or TileOffsets")
        # the second pass, in directory order
        self.bps, self.sample_format, self.colormap, bps_read = 1, 1, None, False
        counts_tag = None
        for tag in ent:
            if tag in (258, 339, 280, 281):
                try:
                    v = self.persample(tag)
                except _TiffEntryError as err:
                    self.fail(f"tag {tag}: {err}")
                if tag == 258:
                    self.bps, bps_read = v, True
                elif tag == 339:
                    if not 1 <= v <= 6:
                        self.fail(f"SampleFormat {v}")
                    self.sample_format = v
            elif tag in (273, 324):
                offsets_tag = tag
            elif tag in (279, 325):
                counts_tag = tag
            elif tag == 320 and bps_read and self.bps <= 24 and ent[tag][1] == 3 << self.bps:
                try:
                    self.colormap = np.array(self.values(320, "short"), np.int64).reshape(3, -1)
                except _TiffEntryError:
                    pass
        self.photometric = self.optional(262, "short")
        orientation = self.optional(274, "short")
        self.orientation = orientation if orientation is not None and 1 <= orientation <= 8 else 1
        fill = self.optional(266, "short")
        self.fill_order = fill if fill in (1, 2) else 1
        ink = self.optional(332, "short")
        self.inkset = 1 if ink is None else ink
        self.predictor = 1
        if self.compression in (_TIFF_LZW, *_TIFF_DEFLATE):
            predictor = self.optional(317, "short")
            self.predictor = 1 if predictor is None else predictor
        self.luma = self.floats(529, 3) or [0.299, 0.587, 0.114]
        self.reference = self.floats(532, 6) or [0.0, 255.0, 128.0, 255.0, 128.0, 255.0]
        self.ycbcr_subsampling = None
        if 530 in ent and ent[530][1] == 2:
            try:
                self.ycbcr_subsampling = tuple(self.values(530, "short"))
            except _TiffEntryError:
                pass
        # the strile arrays (TIFFFetchStripThing: a short one padded with 0)
        self.offsets = self.strile_array(offsets_tag)
        self.counts = None if counts_tag is None else self.strile_array(counts_tag)
        # after the passes
        cc = {0: 1, 1: 1, 3: 1, 4: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 32845: 3, 5: 4,
              32844: 1}.get(self.photometric if self.photometric is not None else 0, 0)
        if cc and self.spp - len(self.extras) > cc:
            self.extras = self.extras + [0] * (self.spp - cc - len(self.extras))
        if self.photometric == 3 and self.colormap is None:
            if self.bps >= 8:
                self.photometric = 2 if self.spp == 3 else 1
            else:
                self.fail("a palette image without a ColorMap")
        self.mend_byte_counts()
        if self.scanline_size() == 0:
            self.fail("a zero scanline size")
        if (self.tile_size() if self.tiled else self.strip_size()) == 0:
            self.fail("a zero strip or tile size")

    def strile_array(self, tag: int) -> list:
        """TIFFFetchStripThing: a strip a value, a short array padded with
        zeros (up to a million strips), a long one cut."""
        try:
            vals = self.values(tag, "long8", self.nstrips)
        except _TiffEntryError as err:
            self.fail(f"tag {tag}: {err}")
        if len(vals) < self.nstrips and self.nstrips > 1000000:
            self.fail(f"{len(vals)} values of tag {tag} for {self.nstrips} strips")
        return vals + [0] * (self.nstrips - len(vals))

    def count_strips(self) -> int:
        def howmany(x, y):
            return (x + y - 1) // y if x < 0xFFFFFFFF - (y - 1) else 0
        if self.tiled:
            dx, dy = self.tile_width, self.tile_length
            n = 0 if dx == 0 or dy == 0 else howmany(self.width, dx) * howmany(self.length, dy)
        else:
            n = 1 if self.rows == _TIFF_MAX_COUNT else howmany(self.length, self.rows)
        if self.planar == 2:
            n *= self.spp
        return n if n <= 0x7FFFFFFF else 0

    def samples_per_row(self) -> int:
        return self.spp if self.planar == 1 else 1

    def ycbcr_blocks(self):
        """(h, v) where libtiff sizes the data as packed YCbCr blocks (h x v
        Y samples, then Cb and Cr): contiguous YCbCr not read through JPEG's
        colour conversion; (0, 0) where the subsampling is not 1, 2 or 4
        (libtiff's sizes are then 0); None otherwise."""
        if self.photometric != 6 or self.planar != 1 or self.upsampled:
            return None
        sub = self.ycbcr_subsampling or (2, 2)
        return sub if sub[0] in (1, 2, 4) and sub[1] in (1, 2, 4) else (0, 0)

    def block_size(self, width: int, rows: int) -> int:
        """TIFFVStripSize64 / TIFFVTileSize64 of packed YCbCr."""
        h, v = self.ycbcr_blocks()
        if h == 0 or self.spp != 3:
            return 0
        return (-(-width // h) * (h * v + 2) * self.bps + 7) // 8 * -(-rows // v)

    def scanline_size(self) -> int:
        if self.ycbcr_blocks() is not None and self.spp == 3:
            h, v = self.ycbcr_blocks()
            return 0 if h == 0 else (-(-self.width // h) * (h * v + 2) * self.bps + 7) // 8 // v
        return (self.width * self.samples_per_row() * self.bps + 7) // 8

    def tile_row_size(self) -> int:
        return (self.tile_width * self.samples_per_row() * self.bps + 7) // 8

    def tile_size(self) -> int:
        if self.ycbcr_blocks() is not None and self.spp == 3:
            return self.block_size(self.tile_width, self.tile_length)
        return self.tile_row_size() * self.tile_length

    def strip_rows(self) -> int:
        return min(self.rows, self.length)

    def strip_size(self, rows: int = None) -> int:
        rows = self.strip_rows() if rows is None else rows
        if self.ycbcr_blocks() is not None:
            return self.block_size(self.width, rows)
        return rows * self.scanline_size()

    def mend_byte_counts(self):
        """TIFFReadDirectory's repairs of StripByteCounts: estimated where it
        is missing (one strip or one a plane only), bogus for a lone strip,
        or, uncompressed, unequal in its first two strips."""
        if self.counts is None:
            if self.nstrips > (1 if self.planar == 1 else self.spp) or (
                    self.planar == 2 and self.nstrips != self.spp):
                self.fail("no StripByteCounts for more than one strip")
            self.estimate_byte_counts()
        elif self.nstrips == 1 and not self.tiled and self.count_looks_bad():
            self.estimate_byte_counts()
        elif (self.planar == 1 and self.nstrips > 2 and self.compression == 1
              and self.counts[0] != self.counts[1] and self.counts[0] and self.counts[1]):
            self.estimate_byte_counts()

    def count_looks_bad(self) -> bool:
        count, offset, size = self.counts[0], self.offsets[0], len(self.data)
        if offset == 0:
            return False
        if count == 0:
            return True
        if self.compression != 1:
            return False
        if offset <= size and count > size - offset:
            return True
        return count < self.scanline_size() * self.length

    def estimate_byte_counts(self):
        """EstimateStripByteCounts."""
        size = len(self.data)
        if self.compression != 1:
            space = (16 + 8 + 20 * len(self.entries) + 8) if self.big else (8 + 2 + 12 * len(self.entries) + 4)
            for typ, count, _ in self.entries.values():
                width = _TIFF_WIDTH.get(typ, 0)
                if width == 0:
                    self.fail(f"an entry of unknown type {typ}")
                datasize = width * count
                space += 0 if datasize <= (8 if self.big else 4) else datasize
            space = size if size < space else size - space
            if self.planar == 2:
                space //= self.spp
            self.counts = [space] * self.nstrips
            last = self.nstrips - 1
            if self.offsets[last] + self.counts[last] > size:
                self.counts[last] = 0 if self.offsets[last] >= size else size - self.offsets[last]
        elif self.tiled:
            self.counts = [self.tile_size()] * self.nstrips
        else:
            rows = self.length // self.per_plane
            self.counts = [self.scanline_size() * rows] * self.nstrips
        if not self.rows_set:
            self.rows = self.length

    def raw(self, strip: int):
        """TIFFFillStrip / TIFFFillTile: a strip's bytes (a view of the
        file's), or None where libtiff cannot read them (a zero count, or
        past the file's end)."""
        count, offset = self.counts[strip], self.offsets[strip]
        if count == 0:
            return None
        unit = self.tile_size() if self.tiled else self.strip_size()
        if count > 1024 * 1024 and unit and (count - 4096) // 10 > unit:
            count = unit * 10 + 4096  # libtiff's cap on a count far past the strip's size
        if count > len(self.data) or offset > len(self.data) - count:
            return None
        raw = memoryview(self.data)[offset:offset + count]
        if self.fill_order == 2:
            raw = bytes(_BIT_REVERSE[np.frombuffer(raw, np.uint8)])
        return raw


_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _tiff_kind_check(t: _Tiff):
    """OpenCV's readHeader and readData checks and libtiff's
    TIFFRGBAImageOK and TIFFRGBAImageBegin, in their order: UnreadableImage
    where cv2.imread returns None, ValueError where it raises or where the
    kind is left out."""
    if t.photometric is None:
        t.fail("no PhotometricInterpretation")
    bps = t.bps
    if bps == 1:
        if t.sample_format not in (1, 2):
            t.fail(f"SampleFormat {t.sample_format}")
    elif bps == 4:
        if t.photometric != 3:
            t.fail("4-bit samples in a non-palette image")
        if t.sample_format not in (1, 2):
            t.fail(f"SampleFormat {t.sample_format}")
    elif bps in (8, 10, 12, 14, 16):
        if t.sample_format not in (1, 2):
            t.fail(f"SampleFormat {t.sample_format}")
    elif bps == 32:
        if t.sample_format not in (1, 2, 3):
            t.fail(f"SampleFormat {t.sample_format}")
    elif bps == 64:
        if t.sample_format != 3:
            t.fail(f"SampleFormat {t.sample_format}")
    else:
        t.fail(f"{bps} bits a sample")
    if not 1 <= t.spp <= 4:
        t.fail(f"{t.spp} samples a pixel")
    _check_size(t.width, t.length, t.path, "TIFF")
    tw, th = (t.tile_width, t.tile_length) if t.tiled else (t.width, t.rows if t.rows_set else 0)
    tw = tw or t.width
    if th == 0 or (not t.tiled and th == _TIFF_MAX_COUNT):
        th = t.length
    if not (0 < tw <= 1 << 24 and 0 < th <= 1 << 24):
        t.fail(f"tiles of {tw}x{th}")
    if tw * th * 4 >= (1 << 30) * 95 // 100 and not t.tiled and t.spp in (1, 3, 4) and t.bps in (8, 16) \
            and th == t.length and t.photometric in (0, 1, 2) and t.planar != 2 \
            and (t.spp != 4 or t.extras == [1]):
        raise ValueError(f"{t.path}: a TIFF strip of {tw}x{th} pixels, which OpenCV reads otherwise "
                         "(TIFFReadScanline); this reader leaves it out")
    # TIFFRGBAImageOK
    if t.compression in _TIFF_NOT_CONFIGURED:
        t.fail(f"compression {t.compression}, which OpenCV's libtiff is built without")
    if bps not in (1, 2, 4, 8, 16):
        t.fail(f"{bps} bits a sample (libtiff's RGBA reader takes 1, 2, 4, 8 and 16)")
    if t.sample_format == 3:
        t.fail("floating-point samples")
    colours = t.spp - len(t.extras)
    ph = t.photometric
    if ph in (0, 1, 3):
        if t.planar == 1 and t.spp != 1 and bps < 8:
            t.fail(f"{t.spp} contiguous samples of {bps} bits")
    elif ph == 2:
        if colours < 3:
            t.fail(f"RGB with {colours} colour channels")
    elif ph == 5:
        if t.inkset != 1:
            t.fail(f"InkSet {t.inkset}")
        if t.spp < 4:
            t.fail(f"separated with {t.spp} samples")
    elif ph == 6:
        pass
    elif ph in (8, 32844, 32845):
        raise ValueError(f"{t.path}: TIFF of photometric {({8: 'CIELab', 32844: 'LogL', 32845: 'LogLuv'})[ph]}"
                         ", which this reader leaves out")
    else:
        t.fail(f"photometric {ph}")
    if t.compression in (2, 3, 4, 32771) and bps != 1:
        t.fail(f"CCITT compression {t.compression} of {bps}-bit samples")
    if t.compression == 6:  # old-style JPEG reads a JPEG stream, at JPEGInterchangeFormat or in the strip
        start = t.optional(513, "long")
        start = t.offsets[0] if start is None else start
        if t.data[start:start + 2] != b"\xff\xd8":
            t.fail("old-style JPEG without a JPEG stream")
    if t.compression in _TIFF_LEFT_OUT:
        raise ValueError(f"{t.path}: TIFF of compression {t.compression} ({_TIFF_LEFT_OUT[t.compression]}), "
                         "which this reader leaves out")
    if t.orientation > 4:
        t.fail(f"orientation {t.orientation} (cv2.imread 5.0 returns None for 5-8)")
    if tw * th * 4 >= 1 << 30:
        t.fail(f"strips or tiles of {tw}x{th} pixels (OpenCV's RGBA buffer of 1 GiB or more)")
    # TIFFRGBAImageBegin and PickContigCase / PickSeparateCase
    alpha = 0
    if t.extras:
        alpha = {0: 1 if t.spp > 3 else 0, 1: 1, 2: 2}[t.extras[0]]
    if not t.extras and t.spp == 4 and ph == 2:
        alpha = 1  # DEFAULT_EXTRASAMPLE_AS_ALPHA
    if ph == 3:
        if t.colormap is None or t.colormap.shape[1] < 1 << bps:
            t.fail("a palette image without a ColorMap")
    contig = not (t.planar == 2 and t.spp > 1)
    if ph == 6 and t.compression == _TIFF_JPEG and contig:
        ph = 2  # JPEG-compressed YCbCr is asked for as RGB (JPEGCOLORMODE_RGB)
    if ph == 6:  # initYCbCrConversion and the subsamplings PickContigCase has
        luma, ref = t.luma, t.reference
        sub = t.ycbcr_subsampling or (2, 2)
        if (bps != 8 or t.spp != 3 or luma[1] == 0 or any(math.isnan(v) for v in luma)
                or any(not abs(v) < 2 ** 31 for v in ref)
                or (sub[0] << 4 | sub[1]) not in ((0x44, 0x42, 0x41, 0x22, 0x21, 0x12, 0x11) if contig else (0x11,))):
            t.fail(f"YCbCr of {bps} bits, {t.spp} samples, subsampling {sub}")
        return alpha, contig, tw, th
    if contig:
        ok = ((ph == 2 and bps in (8, 16) and t.spp >= 3) or (ph == 5 and bps == 8)
              or (ph == 3 and bps in (1, 2, 4, 8)) or (ph in (0, 1) and bps in (1, 2, 4, 8, 16)))
    else:
        ok = (ph in (0, 1, 2) and bps in (8, 16)) or (ph == 5 and bps == 8 and t.spp == 4)
    if not ok:
        t.fail(f"photometric {t.photometric} at {bps} bits, {t.spp} samples, planar {t.planar}")
    return alpha, contig, tw, th


def _tiff_decode(t: _Tiff, raw: bytes, size: int, state: dict):
    """One strip or tile decoded into ``size`` bytes: (the bytes, whether the
    decoder succeeded)."""
    c = t.compression
    if c == _TIFF_NONE:
        if len(raw) < size:
            return np.zeros(size, np.uint8), False
        return np.frombuffer(raw, np.uint8, size), True
    out = np.zeros(size, np.uint8)
    src = np.frombuffer(raw, np.uint8)
    if c in _TIFF_DEFLATE:
        ok = native.tiff_lib().frn_tiff_inflate(src.ctypes.data, src.size, out.ctypes.data, size)
    elif c == _TIFF_PACKBITS:
        ok = native.tiff_lib().frn_tiff_packbits(src.ctypes.data, src.size, out.ctypes.data, size)
    elif c == _TIFF_LZW:
        # libtiff picks the old-style decoder where the first strip it
        # decodes begins 0, odd, and keeps the first strip's choice
        if "compat" not in state:
            state["compat"] = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
        ok = native.tiff_lib().frn_tiff_lzw(src.ctypes.data, src.size, int(bool(state["compat"])),
                                             out.ctypes.data, size)
    else:  # libtiff's default state: no decoder, the zeroed buffer stands
        return out, False
    return out, bool(ok)


def _tiff_samples(t: _Tiff, buf: np.ndarray, ok: bool, rows: int, width: int, per_row: int,
                  cols: int) -> np.ndarray:
    """A decoded strip or tile (``rows`` rows of ``width`` pixels) -> the
    (rows, cols, samples) uint8 or uint16 that libtiff's put routine reads
    from it: the predictor undone and 16-bit samples in host order where
    the decoder succeeded (a failed decode skips both, as libtiff's
    postdecode is skipped), bit-packed samples split. A tile clipped at the
    image's right edge is walked as the put routine walks it: the gray and
    palette ones step to the next row by a byte count that misses the
    sample size."""
    bps = t.bps
    row_bytes = (width * per_row * bps + 7) // 8
    host = buf[:rows * row_bytes]
    if bps == 16 and ok:
        v = host.view(t.e + "u2").reshape(rows, width * per_row)
        if t.predictor == 2:
            v = np.cumsum(v.reshape(rows, width, per_row), axis=1, dtype=np.uint16).reshape(rows, -1)
        host = v.astype("<u2").view(np.uint8).reshape(-1)
    elif bps == 8 and ok and t.predictor == 2:
        host = np.cumsum(host.reshape(rows, width, per_row), axis=1, dtype=np.uint8).reshape(-1)
    advance = row_bytes
    if cols < width and t.photometric in (0, 1, 3):
        if bps >= 8:
            advance = cols * per_row * bps // 8 + (width - cols)
        else:
            advance = (cols * bps + 7) // 8 + (width - cols) // (8 // bps)
    need = (cols * per_row * bps + 7) // 8
    if advance == need == row_bytes:
        rb = host.reshape(rows, row_bytes)
    else:
        rb = host[np.arange(rows)[:, None] * advance + np.arange(need)[None, :]]
    if bps == 16:
        return rb.view("<u2").reshape(rows, cols, per_row)
    if bps == 8:
        return rb.reshape(rows, cols, per_row)
    per = 8 // bps
    shifts = ((8 - bps) - bps * np.arange(per)).astype(np.uint8)
    v = ((rb[:, :, None] >> shifts) & ((1 << bps) - 1)).reshape(rows, -1)[:, :cols * per_row]
    return v.reshape(rows, cols, per_row)


def _tiff_predictor_ok(t: _Tiff) -> bool:
    """PredictorSetup: the predictor must fit the samples, or the strip is
    not read at all."""
    if t.predictor == 1:
        return True
    return t.predictor == 2 and t.bps in (8, 16, 32, 64)


def _tiff_to_8bit(v: np.ndarray) -> np.ndarray:
    """16-bit RGB or alpha samples as libtiff's put routines take them to 8
    bits: (v + 128) / 257, in uint32."""
    v = v.astype(np.uint32)
    v += 128
    v //= 257
    return v


def _tiff_rgb_contig(t: _Tiff, s: np.ndarray, alpha: int, photometric: int = None) -> np.ndarray:
    """PickContigCase's put routines: samples -> (rows, w, 3) RGB uint8
    (a view of ``s`` where it already is that). The arithmetic is in uint16
    (at most 255 x 255 + 127), 16-bit samples' scaling in uint32."""
    ph, bps = photometric or t.photometric, t.bps
    if ph in (0, 1):
        v = s[:, :, 0]
        if bps == 16:
            v = (v >> 8).astype(np.uint8)
        if ph == 0 or bps < 8:
            top = min((1 << bps) - 1, 255)
            v = v.astype(np.uint16)
            v = ((top - v if ph == 0 else v) * 255 // top).astype(np.uint8)
        return np.broadcast_to(v[:, :, None], v.shape + (3,))
    if ph == 3:
        cmap = t.colormap[:, :1 << bps]
        if (cmap >= 256).any():
            cmap = cmap >> 8
        cmap = (cmap & 0xFF).astype(np.uint8).T
        return cmap[s[:, :, 0]]
    if ph == 5:
        k = 255 - s[:, :, 3:4].astype(np.uint16)
        return (k * (255 - s[:, :, :3]) // 255).astype(np.uint8)
    rgb = s[:, :, :3]
    if bps == 8 and alpha != 2:
        return rgb
    if bps == 16:
        rgb = _tiff_to_8bit(rgb)
    if alpha == 2:
        a = s[:, :, 3:4]
        a = _tiff_to_8bit(a) if bps == 16 else a.astype(np.uint16)
        rgb = (rgb.astype(np.uint16) * a + 127) // 255
    return rgb.astype(np.uint8)


def _tiff_rgb_separate(t: _Tiff, planes: list, alpha: int) -> np.ndarray:
    """PickSeparateCase's put routines: planes (rows, w) -> RGB uint8."""
    if t.photometric == 5:
        k = 255 - planes[3].astype(np.uint16)
        return np.stack([(k * (255 - p) // 255) for p in planes[:3]], -1).astype(np.uint8)
    rgb = np.stack(planes[:3], -1)
    if t.bps == 16:
        rgb = _tiff_to_8bit(rgb)
    if alpha == 2:
        a = planes[3][:, :, None]
        a = _tiff_to_8bit(a) if t.bps == 16 else a.astype(np.uint16)
        rgb = (rgb.astype(np.uint16) * a + 127) // 255
    return rgb.astype(np.uint8)


def _tiff(data: bytes, path: str, gray: bool) -> np.ndarray:
    """grfmt_tiff over libtiff 4.7.1: the first directory of a classic or
    BigTIFF file in either byte order; strips or tiles, contiguous or planar,
    uncompressed, LZW (with libtiff's old-style codes), Deflate, PackBits
    or JPEG, with or without the horizontal predictor; gray and min-is-white
    at 1, 8 and 16 bits (16 keeps its high byte), palette at 1, 4 and 8 bits
    (a colour map whose entries all fit in 8 bits taken as 8-bit), RGB at 8
    and 16 bits (16 scaled by (v + 128) / 257) with its extra samples
    (unassociated alpha premultiplied as libtiff does it), CMYK at 8 bits;
    the orientations 2-4 as libtiff and OpenCV apply them (a mirror inside
    each tile); gray from the BGR by OpenCV's 14-bit weights. Where libtiff
    or OpenCV refuse a file, UnreadableImage; where a decoder fails part way,
    what libtiff's RGBA reader makes of the strip (see ``native/tiff.cpp``).
    Orientations 5-8 read as None (OpenCV 5's own failure)."""
    t = _Tiff(data, path)
    alpha, contig, tw, th = _tiff_kind_check(t)
    w, h = t.width, t.length
    img = np.zeros((h, w, 3), np.uint8)  # BGR
    state = {}
    for y in range(0, h, th):
        rows = min(th, h - y)
        for x in range(0, w, tw):
            cols = min(tw, w - x)
            if t.tiled:
                index = (y // t.tile_length) * -(-w // t.tile_width) + x // t.tile_width
                size, rows_in, width_in = t.tile_size(), t.tile_length, t.tile_width
            else:
                index = y // t.rows
                rows_in = min(t.rows, h - y)
                size, width_in = t.strip_size(rows_in), w
                if t.ycbcr_blocks() is not None:  # gtStripContig reads whole rows of blocks' worth
                    v = t.ycbcr_blocks()[1]
                    size = min(size, -(-rows_in // v) * v * t.scanline_size())
            mirror = -1 if t.orientation in (2, 3) else 1
            _tiff_place(img[y:y + rows, x:x + cols],
                        _tiff_block(t, index, size, rows_in, width_in, cols, contig, alpha, state)[:rows, ::mirror])
    if t.orientation in (3, 4):
        img = np.ascontiguousarray(img[::-1])
    return _gray(img) if gray else img


def _tiff_place(dst: np.ndarray, rgb: np.ndarray) -> None:
    """An RGB strip or tile into its place in the BGR image, a channel at a
    time (a copy through a reversed channel axis takes several times as
    long)."""
    for c in range(3):
        dst[:, :, c] = rgb[:, :, 2 - c]


def _tiff_block(t: _Tiff, index: int, size: int, rows: int, width: int, cols: int, contig: bool,
                alpha: int, state: dict) -> np.ndarray:
    """One strip or tile (all its planes) -> (rows, cols, 3) RGB, as
    gtStripContig / gtTileContig / their separate kin read it with
    stop-on-error off; UnreadableImage where its first plane cannot be
    read."""
    if not _tiff_predictor_ok(t):
        t.fail(f"predictor {t.predictor} with {t.bps}-bit samples")
    if t.compression == _TIFF_JPEG:
        samples = _tiff_jpeg_block(t, index, rows, width, state)[:, :cols]
        return _tiff_rgb_contig(t, samples, alpha, photometric=2 if t.photometric == 6 else None)
    if contig:
        raw = t.raw(index)
        if raw is None or not _tiff_tile_plausible(t, raw, size, size):
            t.fail(f"strip or tile {index} cannot be read")
        buf, ok = _tiff_decode(t, raw, size, state)
        if t.photometric == 6:
            return _tiff_ycbcr(t, buf, rows, width, cols)
        return _tiff_rgb_contig(t, _tiff_samples(t, buf, ok, rows, width, t.spp, cols), alpha)
    # gtStripSeparate / gtTileSeparate: one colour plane for gray (read as
    # R, G and B), three otherwise, then the alpha plane (CMYK's K)
    colours = 1 if t.photometric in (0, 1) else 3
    if t.photometric == 5:
        alpha = 1
    planes = []
    for sample in range(colours + (alpha > 0)):
        strip = sample * t.per_plane + index
        raw = t.raw(strip)
        if sample == 0 and (raw is None or not _tiff_tile_plausible(t, raw, size,
                                                                   size * (4 if alpha else 3))):
            t.fail(f"strip or tile {strip} cannot be read")
        buf, ok = (np.zeros(size, np.uint8), False) if raw is None else _tiff_decode(t, raw, size, state)
        planes.append(_tiff_samples(t, buf, ok, rows, width, 1, cols)[:, :, 0])
    if colours == 1:
        planes = planes[:1] * 3 + planes[1:]
    if t.photometric == 6:  # putseparate8bitYCbCr11tile
        y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(tuple(t.luma), tuple(t.reference))
        yy, cb, cr = y_tab[planes[0]], planes[1], planes[2]
        out = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]], -1)
        return np.clip(out, 0, 255).astype(np.uint8)
    return _tiff_rgb_separate(t, planes, alpha)


def _tiff_ycbcr(t: _Tiff, buf: np.ndarray, rows: int, width: int, cols: int) -> np.ndarray:
    """putcontig8bitYCbCr{11,12,21,22,41,42,44}tile: packed blocks of h x v
    Y samples, then Cb and Cr, each pixel through TIFFYCbCrtoRGB's tables
    (TIFFYCbCrToRGBInit: the luma coefficients and ReferenceBlackWhite in
    float, 16-bit fixed point)."""
    h, v = t.ycbcr_blocks()
    size = h * v + 2
    # the step to the next row of blocks; in a tile clipped at the image's
    # edge, putcontig8bitYCbCr44tile skips the rest of the row in blocks of
    # 10 bytes instead of 18
    advance = -(-cols // h) * size + (width - cols) // h * (10 if (h, v) == (4, 4) else size)
    data = np.zeros(-(-rows // v) * advance + size, np.uint8)
    data[:min(data.size, buf.size)] = buf[:data.size]
    r, c = np.arange(rows)[:, None], np.arange(cols)[None, :]
    at = (r // v) * advance + (c // h) * size
    y = data[at + (r % v) * h + c % h]
    cb, cr = data[at + h * v], data[at + h * v + 1]
    y_tab, cr_r, cb_b, cr_g, cb_g = _ycbcr_tables(tuple(t.luma), tuple(t.reference))
    yy = y_tab[y]
    out = np.stack([yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb]], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=8)
def _ycbcr_tables(luma: tuple, ref: tuple):
    """TIFFYCbCrToRGBInit's tables (Y, Cr->R, Cb->B, Cr->G, Cb->G), its
    float arithmetic in float32."""
    f32 = np.float32

    def fix(x):
        return int(float(f32(x) * f32(65536)) + 0.5)

    def clamp(x, lo, hi):
        return lo if x < lo else hi if x > hi else x

    def code2v(c, rb, rw, cr):
        rb, rw = f32(rb), f32(rw)
        den = rw - rb if rw - rb != 0 else f32(1)
        return f32(f32(f32(c - int(rb)) * f32(cr)) / den)

    lr, lg, lb = (f32(v) for v in luma)
    f1 = f32(2) - f32(2) * lr
    d1 = fix(clamp(f1, 0.0, 2.0))
    d2 = -fix(clamp(f32(f32(lr * f1) / lg), 0.0, 2.0))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clamp(f3, 0.0, 2.0))
    d4 = -fix(clamp(f32(f32(lb * f3) / lg), 0.0, 2.0))
    tabs = [np.zeros(256, np.int32) for _ in range(5)]
    for i, x in enumerate(range(-128, 128)):
        cr = int(clamp(code2v(x, f32(ref[4]) - f32(128), f32(ref[5]) - f32(128), 127), -128.0 * 32, 128.0 * 32))
        cb = int(clamp(code2v(x, f32(ref[2]) - f32(128), f32(ref[3]) - f32(128), 127), -128.0 * 32, 128.0 * 32))
        tabs[1][i] = (d1 * cr + 32768) >> 16
        tabs[2][i] = (d3 * cb + 32768) >> 16
        tabs[3][i] = d2 * cr
        tabs[4][i] = d4 * cb + 32768
        tabs[0][i] = int(clamp(code2v(x + 128, ref[0], ref[1], 255), -128.0 * 32, 128.0 * 32))
    return tabs


def _tiff_tile_plausible(t: _Tiff, raw: bytes, size: int, buffer: int) -> bool:
    """_TIFFReadEncodedTileAndAllocBuffer's checks on a tile before its
    buffer is allocated: an uncompressed tile of exactly its size, a
    compressed one at most 1000 times smaller where the buffer passes 100
    MB."""
    if not t.tiled:
        return True
    if t.compression == _TIFF_NONE:
        return len(raw) == size
    return not (buffer > 100 * 1000 * 1000 and len(raw) < size // 1000)


def _jpeg_fixup_sampling(t: _Tiff):
    """libtiff's JPEGFixupTagsSubsampling: the subsampling read from the
    first strip's frame header where the TIFF has no YCbCrSubsampling tag,
    (2, 2) where that header cannot be found or has no TIFF equivalent."""
    offset, count = t.offsets[0], t.counts[0]
    data = t.data[offset:offset + count] if offset < len(t.data) else b""
    pos = 0
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            return 2, 2
        marker = data[pos]
        pos += 1
        if marker == 0xD8:
            continue
        if marker in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= marker <= 0xEF:
            if pos + 2 > len(data) or struct.unpack_from(">H", data, pos)[0] < 2:
                return 2, 2
            pos += struct.unpack_from(">H", data, pos)[0]
            continue
        if marker not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            return 2, 2
        if pos + 2 > len(data) or struct.unpack_from(">H", data, pos)[0] != 8 + 3 * t.spp:
            return 2, 2
        body = data[pos + 2:pos + 8 + 3 * t.spp]
        if len(body) < 6 + 3 * t.spp:
            return 2, 2
        h, v = body[7] >> 4, body[7] & 15
        if any(body[7 + 3 * i] != 0x11 for i in range(1, t.spp)) or h not in (1, 2, 4) or v not in (1, 2, 4):
            return 2, 2
        return h, v


_JPEG_TABLES_BYTES = 2748  # frn_jpeg_tables' most: 4 DQT and 8 DHT segments


def _jpeg_tables(stream: bytes):
    """The quantization and Huffman tables libjpeg holds after reading a
    JPEG stream's markers up to its first SOS or EOI, as DQT and DHT
    segments, each table slot once (``native/jpeg.cpp``'s marker reader):
    (the segments, the marker that ended the read), or None where libjpeg
    stops with an error."""
    buf = np.frombuffer(stream, np.uint8)
    out = np.zeros(_JPEG_TABLES_BYTES, np.uint8)
    info = np.zeros(2, np.int32)
    err = ctypes.create_string_buffer(512)
    if native.jpeg_lib().frn_jpeg_tables(buf.ctypes.data, buf.size, out.ctypes.data, info.ctypes.data, err,
                                         len(err)) != 0:
        return None
    return out[:info[0]].tobytes(), int(info[1])


def _tiff_jpeg_tables(t: _Tiff):
    """The tables of the JPEGTables tag as DQT and DHT segments (b"" without
    one), or None where libjpeg would not read it as tables only ("Bogus
    JPEGTables")."""
    entry = t.entries.get(347)
    if entry is None or entry[0] not in (1, 2, 6, 7) or entry[1] == 0:
        return b""
    typ, count, value = entry
    inline = 8 if t.big else 4
    if count <= inline:
        tables = value[:count]
    else:
        at = struct.unpack(t.e + ("Q" if t.big else "I"), value)[0]
        if at + count > len(t.data):
            return b""
        tables = t.data[at:at + count]
    read = _jpeg_tables(tables)
    return None if read is None or read[1] != 0xD9 else read[0]


def _tiff_jpeg_block(t: _Tiff, index: int, rows: int, width: int, state: dict) -> np.ndarray:
    """A strip or tile of a JPEG-compressed TIFF, as libtiff's JPEGPreDecode
    checks it and JPEGDecode reads it: (rows, width, samples) where the
    JPEG's rows and columns are copied into a zeroed buffer. YCbCr comes out
    as RGB. UnreadableImage where JPEGPreDecode fails."""
    if "tables" not in state:
        state["tables"] = _tiff_jpeg_tables(t)  # then the tables the strips read so far define
        state["sampling"] = (1, 1)
        if t.photometric == 6:
            if t.ycbcr_subsampling is not None:
                state["sampling"] = t.ycbcr_subsampling
            elif t.planar == 1 and t.spp == 3:
                state["sampling"] = _jpeg_fixup_sampling(t)
            else:
                state["sampling"] = (2, 2)
    if t.planar == 2:
        raise ValueError(f"{t.path}: a JPEG-compressed TIFF with separate planes, which this reader leaves "
                         "out")
    tables = state["tables"]
    raw = t.raw(index)
    if tables is None or raw is None or raw[:2] != b"\xff\xd8":
        t.fail(f"JPEG strip or tile {index} cannot be read")
    # libjpeg keeps its quantization and Huffman tables from one strip to
    # the next (libtiff reuses one decompressor): the tables it holds go in
    # front of this strip's own, which replace them slot by slot
    stream = b"\xff\xd8" + tables + raw[2:]
    lib = native.jpeg_lib()
    buf = np.frombuffer(stream, np.uint8)
    info = np.zeros(12, np.int32)
    err = ctypes.create_string_buffer(512)
    rc = lib.frn_jpeg_info(buf.ctypes.data, buf.size, info.ctypes.data, err, len(err))
    if rc == 0:
        state["tables"] = _jpeg_tables(stream)[0]
    if rc == 1:
        raise ValueError(f"{t.path}: JPEG strip or tile {index}: {err.value.decode(errors='replace')}")
    if rc != 0:
        t.fail(f"JPEG strip or tile {index}: {err.value.decode(errors='replace')}")
    jw, jh, nc = int(info[0]), int(info[1]), int(info[2])
    sampling = [(int(info[4 + 2 * i]), int(info[5 + 2 * i])) for i in range(min(nc, 4))]
    last_strip = not t.tiled and index == t.per_plane - 1
    if jw > width or (jh > rows and not (jw == width and last_strip)) or nc != t.spp or t.bps != 8:
        t.fail(f"a JPEG strip or tile of {jw}x{jh} with {nc} components for {width}x{rows} with {t.spp}")
    if sampling[0] != tuple(state["sampling"]) or any(f != (1, 1) for f in sampling[1:]):
        t.fail(f"JPEG sampling factors {sampling}")
    ycbcr = t.photometric == 6
    out = np.empty((jh, jw, nc), np.uint8)
    rc = lib.frn_jpeg_decode_tiff(buf.ctypes.data, buf.size, int(ycbcr), out.ctypes.data, err, len(err))
    if rc == 1:
        raise ValueError(f"{t.path}: JPEG strip or tile {index}: {err.value.decode(errors='replace')}")
    if rc != 0:
        t.fail(f"JPEG strip or tile {index}: {err.value.decode(errors='replace')}")
    block = np.zeros((rows, width, nc), np.uint8)
    n = min(rows, jh)
    block[:n, :jw] = out[:n]
    return block


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
    if data[:4] in _TIFF_SIGNATURES:
        return _tiff
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
                         "PAM, PFM, Sun raster, Radiance HDR, GIF and TIFF only (the JAX package reads "
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
