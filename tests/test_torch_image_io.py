"""The port's image reader against ``cv2.imread``, bit for bit, on the CPU.

``frn_tpu`` reads every image through ``cv2.imread``; the port reads JPEG
with its own decoder (``frn_tpu_torch/native/jpeg.cpp``, built by g++ from
the port's source) and PNG on zlib and numpy (``data/image_io.py``). Every
comparison is exact, under ``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE``:

* JPEGs written here by ``cv2.imencode`` at qualities 5-100, sampling 4:2:0,
  4:2:2, 4:4:4, 4:4:0 and 4:1:1, sequential and progressive, with restart
  intervals, gray, at sizes that do not fill an MCU (1x1 up to 64x96, and
  one 480x640); by PIL with EXIF orientations 1-8 and in CMYK; and byte-level
  variants of those for the other colour spaces (YCCK, RGB) and for a frame
  without Huffman tables;
* PNGs written here for every kind OpenCV reads: gray at 1, 2, 4, 8 and 16
  bits, palette with and without tRNS, 16-bit colour, Adam7 interlace, a
  gamma, an eXIf orientation;
* the CSV dataset over JPEG frames, equal to ``frn_tpu``'s.

The kinds left out raise ``ValueError`` naming themselves.
"""

import dataclasses
import io
import itertools
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from frn_tpu import config as jconfig
from frn_tpu.data import csv_dataset as jcsv
from frn_tpu.data import synthetic as jsynthetic
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.data import csv_dataset as tcsv
from frn_tpu_torch.data import image_io
from frn_tpu_torch.utils import native

FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
# sizes that fill no MCU, fill one, and cut every sampling's edge cases
SIZES = ((1, 1), (2, 3), (5, 2), (7, 1), (9, 17), (16, 16), (31, 45), (64, 96))


def _scene(h, w, seed):
    """A smooth pattern with noise: edges, gradients and texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([(x * 3 + y) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


def _assert_reads_as_cv2(path):
    for flag in FLAGS:
        want = cv2.imread(str(path), flag)
        got = image_io.imread(str(path), flag)
        assert want is not None and got.dtype == np.uint8 and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want, err_msg=f"flag {flag}")


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return path


def _encode(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _segments(data):
    """(marker, start, end) of a JPEG's marker segments up to its first SOS."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((marker, pos, pos + 2 + length))
        if marker == 0xDA:
            return out
        pos += 2 + length


# ------------------------------------------------------------ JPEG


@pytest.mark.parametrize("progressive", [0, 1], ids=["sequential", "progressive"])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [5, 50, 95, 100])
def test_cv2_jpeg_reads_as_cv2(tmp_path, quality, sampling, progressive):
    for h, w in SIZES:
        data = _encode(_scene(h, w, h * w + quality), cv2.IMWRITE_JPEG_QUALITY, quality,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                       cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
        _assert_reads_as_cv2(_write(tmp_path, f"{h}x{w}.jpg", data))


@pytest.mark.parametrize("progressive", [0, 1], ids=["sequential", "progressive"])
@pytest.mark.parametrize("interval", [1, 2, 7])
def test_restart_intervals_read_as_cv2(tmp_path, interval, progressive):
    data = _encode(_scene(64, 96, interval), cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                   cv2.IMWRITE_JPEG_PROGRESSIVE, progressive, cv2.IMWRITE_JPEG_OPTIMIZE, 1)
    _assert_reads_as_cv2(_write(tmp_path, "rst.jpg", data))


@pytest.mark.parametrize("progressive", [0, 1], ids=["sequential", "progressive"])
def test_gray_jpeg_reads_as_cv2(tmp_path, progressive):
    for h, w in ((1, 1), (9, 17), (64, 96)):
        data = _encode(_scene(h, w, 3)[:, :, 0], cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
        _assert_reads_as_cv2(_write(tmp_path, f"g{h}x{w}.jpg", data))


@pytest.mark.parametrize("image", ["noise", "checkerboard"])
@pytest.mark.parametrize("quality", [1, 100])
def test_extreme_coefficients_read_as_cv2(tmp_path, image, quality):
    """Noise and one-pixel checkerboards push the IDCT's outputs past 0..255."""
    if image == "noise":
        img = np.random.default_rng(1).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    else:
        cb = ((np.indices((64, 96)).sum(0) % 2) * 255).astype(np.uint8)
        img = np.stack([cb, 255 - cb, cb], -1)
    for sampling in ("420", "444"):
        for progressive in (0, 1):
            data = _encode(img, cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           SAMPLING[sampling], cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
            _assert_reads_as_cv2(_write(tmp_path, "x.jpg", data))


def test_a_dsec_sized_jpeg_reads_as_cv2(tmp_path):
    img = np.random.default_rng(3).normal(0, 1, (480, 640, 3)).cumsum(1) * 4 + 128
    img = np.clip(img, 0, 255).astype(np.uint8)
    for progressive in (0, 1):
        data = _encode(img, cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
        _assert_reads_as_cv2(_write(tmp_path, "dsec.jpg", data))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_turns_the_image_as_cv2(tmp_path, orientation):
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = orientation
    buf = io.BytesIO()
    Image.fromarray(_scene(96, 130, orientation)).save(buf, "JPEG", quality=90, exif=exif.tobytes())
    path = _write(tmp_path, "o.jpg", buf.getvalue())
    _assert_reads_as_cv2(path)
    want = (130, 96) if orientation >= 5 else (96, 130)
    assert image_io.imread(str(path)).shape[:2] == want


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "4:1:1"])
def test_pil_jpeg_reads_as_cv2(tmp_path, subsampling):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_scene(37, 53, 11)).save(buf, "JPEG", quality=80, subsampling=subsampling)
    _assert_reads_as_cv2(_write(tmp_path, "pil.jpg", buf.getvalue()))


def _pil_cmyk(quality=90):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_scene(37, 53, 2)).convert("CMYK").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.mark.parametrize("transform", ["cmyk", "ycck", "unknown", "no_adobe"])
def test_four_component_jpeg_reads_as_cv2(tmp_path, transform):
    """PIL writes Adobe CMYK (transform 0); setting the transform byte to 2
    makes libjpeg read the same bytes as YCCK, 1 as an unknown one (YCCK
    too), and without the APP14 segment the file is plain CMYK."""
    data = bytearray(_pil_cmyk())
    (_, start, end), = [s for s in _segments(bytes(data)) if s[0] == 0xEE]
    if transform == "no_adobe":
        data = data[:start] + data[end:]
    else:
        data[start + 4 + 11] = {"cmyk": 0, "ycck": 2, "unknown": 1}[transform]
    _assert_reads_as_cv2(_write(tmp_path, "cmyk.jpg", bytes(data)))


@pytest.mark.parametrize("marking", ["adobe_rgb", "adobe_ycc", "rgb_ids", "no_marker"])
def test_three_component_colour_space_as_libjpeg_guesses(tmp_path, marking):
    data = _encode(_scene(37, 53, 5), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"])
    (_, start, end), = [s for s in _segments(data) if s[0] == 0xE0]
    data = bytearray(data[:start] + data[end:])  # no JFIF APP0
    if marking.startswith("adobe"):
        transform = 0 if marking == "adobe_rgb" else 1
        app14 = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
        data = data[:2] + app14 + data[2:]
    elif marking == "rgb_ids":  # component ids 'R', 'G', 'B' in SOF0 and SOS
        segs = _segments(bytes(data))
        (_, sof, _), = [s for s in segs if s[0] == 0xC0]
        (_, sos, _), = [s for s in segs if s[0] == 0xDA]
        for i, cid in enumerate(b"RGB"):
            data[sof + 10 + 3 * i] = cid
            data[sos + 5 + 2 * i] = cid
    _assert_reads_as_cv2(_write(tmp_path, "rgb.jpg", bytes(data)))


def test_a_frame_without_huffman_tables_takes_the_standard_ones(tmp_path):
    """Motion-JPEG frames carry no DHT; libjpeg-turbo decodes them with the
    tables of ITU T.81 K.3, which cv2.imencode writes when not optimizing."""
    data = _encode(_scene(37, 53, 6), cv2.IMWRITE_JPEG_QUALITY, 75)
    for marker, start, end in reversed(_segments(data)):
        if marker == 0xC4:
            data = data[:start] + data[end:]
    _assert_reads_as_cv2(_write(tmp_path, "mjpeg.jpg", data))


@pytest.mark.parametrize("marker,kind", [
    (0xC9, "arithmetic-coded JPEG \\(SOF9\\)"), (0xCA, "arithmetic-coded progressive"),
    (0xC3, "lossless JPEG \\(SOF3\\)"), (0xC5, "hierarchical JPEG \\(SOF5"),
    (0xC7, "hierarchical lossless")])
def test_unsupported_jpeg_kinds_raise_naming_them(tmp_path, marker, kind):
    data = bytearray(_encode(_scene(16, 16, 0)))
    (_, sof, _), = [s for s in _segments(bytes(data)) if s[0] == 0xC0]
    data[sof + 1] = marker
    with pytest.raises(ValueError, match=kind):
        image_io.imread(str(_write(tmp_path, "x.jpg", bytes(data))))


def test_twelve_bit_jpegs_raise(tmp_path):
    """cv2.imread reads 8-bit samples only: None for a 12-bit frame, and the
    None error here."""
    data = _encode(_scene(64, 96, 0))
    (_, sof, _), = [s for s in _segments(data) if s[0] == 0xC0]
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    path = str(_write(tmp_path, "p12.jpg", bytes(twelve)))
    for flag in FLAGS:
        assert cv2.imread(path, flag) is None
        with pytest.raises(image_io.UnreadableImage, match="12-bit JPEG"):
            image_io.imread(path, flag)


@pytest.mark.parametrize("cut", ["no_eoi", "half", "in_a_marker_segment"])
def test_truncated_jpegs_read_as_cv2(tmp_path, cut):
    """A file cut before its EOI or in its scan reads as OpenCV reads it (the
    rest of the scan grey); one cut before its scan raises the None error,
    where cv2.imread returns None."""
    data = _encode(_scene(64, 96, 0))
    size = {"no_eoi": len(data) - 2, "half": len(data) // 2, "in_a_marker_segment": 100}[cut]
    path = _write(tmp_path, "cut.jpg", data[:size])
    if cut == "in_a_marker_segment":
        for flag in FLAGS:
            assert cv2.imread(str(path), flag) is None
            with pytest.raises(image_io.UnreadableImage, match="no frame header"):
                image_io.imread(str(path), flag)
    else:
        _assert_reads_as_cv2(path)
        if cut == "half":
            assert (image_io.imread(str(path))[-8:] == 128).all()  # the undecoded rest: grey


@pytest.mark.parametrize("width,height,gray,progressive,what", [
    (40000, 40000, False, 0, r"40000x40000 pixels \(more than 2\^30"),
    (65535, 65535, False, 0, r"65535x65535 pixels \(a side over libjpeg's 65500"),
    (32768, 32767, True, 0, "too short for the blocks of a scan"),
    (32768, 32767, True, 1, "too short for the blocks of a scan"),
], ids=["over_cv2_limit", "over_libjpeg_side", "sequential_bomb", "progressive_bomb"])
def test_a_small_file_declaring_a_huge_frame_raises_without_allocating_it(
        tmp_path, width, height, gray, progressive, what):
    import resource

    img = _scene(16, 16, 0)
    data = bytearray(_encode(img[:, :, 0] if gray else img, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive))
    (_, sof, _), = [s for s in _segments(bytes(data)) if s[0] in (0xC0, 0xC2)]
    data[sof + 5:sof + 9] = struct.pack(">HH", height, width)
    path = str(_write(tmp_path, "bomb.jpg", bytes(data)))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for flag in FLAGS:
        with pytest.raises(ValueError, match=what):
            image_io.imread(path, flag)
    # the frame's coefficients alone would be over a GiB
    assert resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - peak < 256 * 1024


def test_a_jpeg_without_the_native_library_raises_naming_the_cause(tmp_path, monkeypatch):
    path = str(_write(tmp_path, "x.jpg", _encode(_scene(8, 8, 0))))
    monkeypatch.setattr(native, "_jpeg_lib", None)
    monkeypatch.setenv("FRN_DISABLE_NATIVE", "1")
    with pytest.raises(RuntimeError, match="FRN_DISABLE_NATIVE"):
        image_io.imread(path)
    monkeypatch.delenv("FRN_DISABLE_NATIVE")
    monkeypatch.setattr(native, "_jpeg_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ could not build jpeg.cpp"):
        image_io.imread(path)
    # and a PNG needs no library
    image_io.imwrite(str(tmp_path / "x.png"), _scene(8, 8, 0))
    assert image_io.imread(str(tmp_path / "x.png")).shape == (8, 8, 3)


# ------------------------------------------------------------ PNG

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack(samples, depth):
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    flat = samples.reshape(h, w * c).astype(np.uint8)
    if depth == 8:
        return flat
    per = 8 // depth
    flat = np.concatenate([flat, np.zeros((h, -flat.shape[1] % per), np.uint8)], 1).reshape(h, -1, per)
    return (flat << ((8 - depth) - depth * np.arange(per))).sum(2).astype(np.uint8)


def _filtered(rows, bpp):
    """Rows filtered with the five filters in turn, each led by its type."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for r, x in enumerate(rows.astype(np.int32)):
        f = r % 5
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (0, a, b, (a + b) >> 1, paeth)[f]
        out.append(bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


def _png(samples, depth, color, palette=None, trns=None, interlace=False, extra=b""):
    samples = np.asarray(samples)
    samples = samples[:, :, None] if samples.ndim == 2 else samples
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    if interlace:
        subs = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
        raw = b"".join(_filtered(_pack(s, depth), bpp) for s in subs if s.size)
    else:
        raw = _filtered(_pack(samples, depth), bpp)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                               int(interlace))) + extra
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


PNG_SIZES = ((1, 1), (3, 5), (9, 17), (23, 37))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16])
def test_gray_png_reads_as_cv2(tmp_path, depth, interlace):
    rng = np.random.default_rng(depth)
    for h, w in PNG_SIZES:
        data = _png(rng.integers(0, 1 << depth, (h, w)), depth, 0, interlace=interlace)
        _assert_reads_as_cv2(_write(tmp_path, "g.png", data))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("trns", [False, True], ids=["opaque", "trns"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_png_reads_as_cv2(tmp_path, depth, trns, interlace):
    rng = np.random.default_rng(depth)
    entries = min(1 << depth, 2 if depth == 1 else 7 + depth)
    for h, w in PNG_SIZES:
        palette = rng.integers(0, 256, (entries, 3))
        palette[0] = palette[0, 0]  # a gray entry
        alpha = bytes(rng.integers(0, 256, entries - 1).astype(np.uint8)) if trns else None
        data = _png(rng.integers(0, entries, (h, w)), depth, 3, palette=palette, trns=alpha,
                    interlace=interlace)
        _assert_reads_as_cv2(_write(tmp_path, "p.png", data))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("color", [2, 4, 6], ids=["rgb", "gray_alpha", "rgba"])
def test_colour_png_reads_as_cv2(tmp_path, color, depth, interlace):
    rng = np.random.default_rng(color * depth)
    channels = {2: 3, 4: 2, 6: 4}[color]
    for h, w in PNG_SIZES:
        img = rng.integers(0, 1 << depth, (h, w, channels))
        if channels >= 3:
            img[: h // 2, :, 1:3] = img[: h // 2, :, :1]  # gray pixels in a colour image
        _assert_reads_as_cv2(_write(tmp_path, "c.png", _png(img, depth, color, interlace=interlace)))


@pytest.mark.parametrize("chunk", ["gAMA 45455", "gAMA 100000", "gAMA 22000", "gAMA 96000",
                                   "gAMA 250000", "sRGB"])
def test_png_gamma_reads_as_cv2(tmp_path, chunk):
    """A file gamma sends libpng's 8-bit RGB -> gray through its gamma
    tables (a gamma within 5% of 1 does not)."""
    kind, _, value = chunk.partition(" ")
    body = struct.pack(">I", int(value)) if value else b"\x00"
    extra = _chunk(kind.encode(), body)
    rng = np.random.default_rng(len(chunk))
    img = rng.integers(0, 256, (23, 37, 3))
    img[:4] = img[:4, :, :1]
    _assert_reads_as_cv2(_write(tmp_path, "rgb.png", _png(img, 8, 2, extra=extra)))
    palette = rng.integers(0, 256, (16, 3))
    data = _png(rng.integers(0, 16, (23, 37)), 4, 3, palette=palette, extra=extra)
    _assert_reads_as_cv2(_write(tmp_path, "pal.png", data))


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_turns_the_image_as_cv2(tmp_path, orientation, order):
    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HIH", 0x2A, 8, 2)
            + struct.pack(e + "HHIH", 0x0100, 3, 1, 5) + b"\0\0"
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0" + struct.pack(e + "I", 0))
    img = np.random.default_rng(orientation).integers(0, 256, (5, 7, 3))
    _assert_reads_as_cv2(_write(tmp_path, "e.png", _png(img, 8, 2, extra=_chunk(b"eXIf", tiff))))


@pytest.mark.parametrize("fmt,name", [(".tiff", "TIFF"), (".webp", "WebP"), (".jp2", "JPEG 2000"),
                                      (".avif", "AVIF/HEIF")])
def test_other_formats_raise_naming_them(tmp_path, fmt, name):
    path = str(tmp_path / f"x{fmt}")
    if fmt == ".tiff":  # TIFF is read; CCITT Group 4, written by PIL, is a kind left out
        Image = pytest.importorskip("PIL.Image")
        Image.fromarray(_scene(48, 64, 0)).convert("1").save(path, compression="group4")
        match = "TIFF of compression 4 \\(CCITT Group 4\\), which this reader leaves out"
    else:
        assert cv2.imwrite(path, _scene(48, 64, 0))
        match = f"{name} file; this reader decodes JPEG, PNG, BMP"
    with pytest.raises(ValueError, match=match):
        image_io.imread(path)


# ------------------------------------------------------------ the CSV dataset over JPEG frames

TINY_DSEC = (dataclasses.replace(jconfig.DSEC, height=48, width=80),
             dataclasses.replace(tconfig.DSEC, height=48, width=80))
TINY_DDD17 = (dataclasses.replace(jconfig.DDD17, height=52, width=70),
              dataclasses.replace(tconfig.DDD17, height=52, width=70))


@pytest.mark.parametrize("case", ["dsec_gray", "ddd17_voxel"])
def test_csv_dataset_over_jpeg_frames_equals_jax(tmp_path, case):
    """The fixture's frames re-encoded as JPEG (in place: both readers go by
    content, not by name), RGB and, for 'gray', the gray event frames too."""
    geos = TINY_DDD17 if case.startswith("ddd17") else TINY_DSEC
    event_type = case.split("_")[1]
    fix = jsynthetic.make_csv_fixture(str(tmp_path), geometry=geos[0], num_images=4, seed=5)
    rng = np.random.default_rng(0)
    for dirpath, _, files in itertools.chain(os.walk(fix["img_dir"]), os.walk(fix["event_dir"])):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            if f.endswith(".png"):
                progressive = int(rng.integers(0, 2))
                data = _encode(cv2.imread(path), cv2.IMWRITE_JPEG_QUALITY, 90,
                               cv2.IMWRITE_JPEG_PROGRESSIVE, progressive)
                open(path, "wb").write(data)
            elif f.endswith(".npz") and event_type == "gray":
                h, w = np.load(path)["arr_0"].shape[1:]
                gray = rng.integers(0, 255, (h, w), np.uint8)
                open(path.replace(".npz", ".png"), "wb").write(_encode(gray))
    args = (fix["annotations_csv"], fix["class_map_csv"], fix["event_dir"], fix["img_dir"])
    jds = jcsv.CSVDetectionDataset(geos[0], *args, event_type=event_type)
    tds = tcsv.CSVDetectionDataset(geos[1], *args, event_type=event_type)
    assert len(tds) == len(jds) == 4
    for i in range(len(jds)):
        assert open(tds.rgb_path(i), "rb").read(3) == b"\xff\xd8\xff"
        got, want = tds[i], jds[i]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
