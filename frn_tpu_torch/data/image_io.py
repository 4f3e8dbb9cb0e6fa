"""Image reading (JPEG and PNG) and PNG writing without OpenCV.

``imread`` returns what ``cv2.imread`` returns, bit for bit, for every JPEG
and PNG the datasets hold, damaged ones included; the JAX package reads them
with OpenCV, whose codecs are libjpeg-turbo and libpng. With
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
* The EXIF orientation (a JPEG's first APP1 segment, a PNG's ``eXIf`` chunk)
  turns the image as ``cv2.imread`` turns it.

Errors: a missing file raises ``FileNotFoundError``; an existing file that
``cv2.imread`` returns None for raises ``UnreadableImage`` (a ``ValueError``;
also for bytes no OpenCV decoder recognizes, as a file cut before its
signature); a file that OpenCV reads and this reader does not (BMP, TIFF,
WebP, GIF, ..., and the JPEG kinds above) raises a plain ``ValueError``
naming it. The datasets turn ``UnreadableImage`` into the JAX package's
answer to the None.

``imwrite`` writes uint8 (H, W) gray, or (H, W, C) with C 1, 3 (BGR) or 4
(BGRA), as ``cv2.imwrite`` does; every row takes the same filter
(``filter_type``, default Up).
"""

from __future__ import annotations

import ctypes
import math
import os
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
# other formats by their leading bytes, so that the error names them
_OTHER_FORMATS = ((b"BM", "BMP"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"\xffO\xffQ", "JPEG 2000"),
                  (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"), (b"\xff\x0a", "JPEG XL"),
                  (b"\x00\x00\x00\x0cJXL ", "JPEG XL"), (b"v/1\x01", "OpenEXR"),
                  (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"),
                  (b"\x59\xa6\x6a\x95", "Sun raster"), (b"\x8aMNG", "MNG"))
# the formats among them that OpenCV has no decoder for (cv2.imread returns None)
_NO_CV2_DECODER = ("JPEG XL", "OpenEXR", "MNG", "an unknown format")


class UnreadableImage(ValueError):
    """An existing file that ``cv2.imread`` returns None for: a damaged JPEG
    or PNG that libjpeg-turbo, libpng or OpenCV gives up on, or bytes no
    OpenCV decoder recognizes. The JAX package's datasets act on that None
    (DSEC-Det reads zeros, the CSV dataset raises ``FileNotFoundError``)."""


def _format_name(data: bytes) -> str:
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis", b"heic", b"heix", b"mif1"):
        return "AVIF/HEIF"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    if len(data) >= 2 and data[:1] == b"P" and data[1:2] in b"123456fF":
        return "PNM/PFM"
    return "an unknown format"


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
    else:
        name = _format_name(data)
        if name in _NO_CV2_DECODER:
            raise UnreadableImage(f"{path}: {name} file, which no OpenCV decoder reads")
        raise ValueError(f"{path}: {name} file; this reader decodes JPEG and PNG "
                         "only (the JAX package reads other formats through OpenCV)")
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
