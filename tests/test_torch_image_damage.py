"""Damaged images: the port's reader against ``cv2.imread``, and the
datasets' answers against ``frn_tpu``'s, on the CPU.

``frn_tpu`` reads every image through ``cv2.imread``, which returns part of
a damaged JPEG (libjpeg-turbo decodes what it can), forgives some PNG damage
(libpng drops an ancillary chunk with a bad CRC) and returns None for the
rest. The port reads the same pixels, bit for bit, and raises
``image_io.UnreadableImage`` exactly where OpenCV returns None; each dataset
then gives ``frn_tpu``'s answer to the None. Every comparison is exact, under
``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE``:

* small JPEGs written by ``cv2.imencode`` (24x40: baseline 4:2:0 and 4:4:4,
  progressive, restart interval 2, gray) and small PNGs (13x21: 8-bit RGB,
  palette, Adam7, 16-bit) cut at every length from 2 bytes to the whole
  file, and with 200 seeded single-byte changes each, half of them in the
  headers and half in the coded data;
* PNG CRC cases: a bad CRC in an ancillary chunk (the file reads whole, a
  ``gAMA`` so damaged is as if absent under ``IMREAD_GRAYSCALE``), in a
  critical one (None), in IEND (OpenCV does not check it);
* the datasets over damaged frames: DSEC-Det reads zeros where OpenCV gives
  None and ``frn_tpu``'s partial frame where it gives one; the CSV dataset's
  ``load_rgb`` raises ``FileNotFoundError`` on the None and reads the partial
  frame; its gray events, COCO and OID raise on the None (``frn_tpu`` fails
  with ``TypeError`` or ``AttributeError`` on it, so only the raise is
  compared) and read a partial JPEG as ``frn_tpu`` does;
* an EXIF block that breaks off after its Orientation turns the image, as
  OpenCV's reader keeps the entries read before the break;
* other formats keep raising a plain ``ValueError``, never the None error.
"""

import dataclasses
import json
import struct
import zlib

import cv2
import numpy as np
import pytest

from frn_tpu import config as jconfig
from frn_tpu.data import csv_dataset as jcsv
from frn_tpu.data import dsec_det as jdsec
from frn_tpu.data import extra_datasets as jextra
from frn_tpu.data import synthetic as jsynthetic
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.data import csv_dataset as tcsv
from frn_tpu_torch.data import dsec_det as tdsec
from frn_tpu_torch.data import extra_datasets as textra
from frn_tpu_torch.data import image_io

FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([(x * 3 + y) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


def _jpeg(img, *params):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90, *params])
    assert ok
    return buf.tobytes()


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _bad_crc(chunk):
    return chunk[:-1] + bytes([chunk[-1] ^ 0x5A])


def _png(samples, depth, color, palette=None, interlace=False, extra=b""):
    """A PNG of (h, w, c) samples, every row with the Paeth filter."""
    samples = samples[:, :, None] if samples.ndim == 2 else samples
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)

    def rows(s):
        if depth == 16:
            raw = s.astype(">u2").reshape(len(s), -1).view(np.uint8)
        elif depth == 8:
            raw = s.reshape(len(s), -1).astype(np.uint8)
        else:
            per = 8 // depth
            flat = s.reshape(len(s), -1).astype(np.uint8)
            flat = np.concatenate([flat, np.zeros((len(s), -flat.shape[1] % per), np.uint8)], 1)
            raw = (flat.reshape(len(s), -1, per) << ((8 - depth) - depth * np.arange(per))).sum(2)
            raw = raw.astype(np.uint8)
        out, prev = [], np.zeros(raw.shape[1], np.int32)
        for x in raw.astype(np.int32):
            a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
            cc = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            pa, pb, pc = np.abs(prev - cc), np.abs(a - cc), np.abs(a + prev - 2 * cc)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, cc))
            out.append(b"\x04" + ((x - pred) & 255).astype(np.uint8).tobytes())
            prev = x
        return b"".join(out)

    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                  (0, 1, 1, 2))
        raw = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = rows(samples)
    data = _PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                         int(interlace))) + extra
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _jpeg_fixtures():
    img = _scene(24, 40, 1)
    return {
        "baseline_420": _jpeg(img),
        "baseline_444": _jpeg(img, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "progressive": _jpeg(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "restart_2": _jpeg(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "gray": _jpeg(img[:, :, 1]),
    }


def _png_fixtures():
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (13, 21, 3))
    index = rng.integers(0, 16, (13, 21))
    return {
        "rgb8": _png(rgb, 8, 2),
        "palette": _png(index, 4, 3, palette=rng.integers(0, 256, (16, 3))),
        "adam7": _png(rgb, 8, 2, interlace=True),
        "rgb16": _png(rng.integers(0, 65536, (13, 21, 3)), 16, 2),
    }


JPEGS = _jpeg_fixtures()
PNGS = _png_fixtures()
FILES = {**{f"jpeg_{k}": v for k, v in JPEGS.items()}, **{f"png_{k}": v for k, v in PNGS.items()}}


def _read_as_cv2(path):
    """image_io.imread against cv2.imread under both flags; 'image' or
    'none' for what cv2 gave under IMREAD_COLOR."""
    outcome = None
    for flag in FLAGS:
        want = cv2.imread(str(path), flag)
        if want is None:
            with pytest.raises(image_io.UnreadableImage):
                image_io.imread(str(path), flag)
        else:
            got = image_io.imread(str(path), flag)
            assert got.dtype == np.uint8 and got.shape == want.shape, (path, flag)
            np.testing.assert_array_equal(got, want, err_msg=f"{path} flag {flag}")
        outcome = outcome or ("none" if want is None else "image")
    return outcome


def _coded_data_start(data):
    """Where a file's coded data starts: a JPEG's first scan, a PNG's IDAT."""
    if data.startswith(_PNG_SIGNATURE):
        return data.index(b"IDAT") + 4
    return data.index(b"\xff\xda") + 2 + struct.unpack(">H", data[data.index(b"\xff\xda") + 2:][:2])[0]


@pytest.mark.parametrize("name", sorted(FILES))
def test_every_cut_reads_as_cv2(tmp_path, name):
    data = FILES[name]
    # the fixtures are the kinds named, so that the sweeps cover those paths
    assert b"\xff\xc2" in JPEGS["progressive"] and b"\xff\xdd" in JPEGS["restart_2"]
    assert PNGS["adam7"][28] == 1 and PNGS["rgb16"][24] == 16 and PNGS["palette"][25] == 3
    path = tmp_path / name
    outcomes = []
    for size in range(2, len(data) + 1):
        path.write_bytes(data[:size])
        outcomes.append(_read_as_cv2(path))
    assert outcomes[-1] == "image" and "none" in outcomes
    if name.startswith("jpeg"):
        # cut anywhere in its scan, a JPEG still reads (in part) as OpenCV reads it
        assert outcomes.count("image") > (len(data) - _coded_data_start(data)) // 2


def _length_tops(data):
    """The top byte of each PNG chunk's length: changed, it declares a chunk
    of up to 4 GiB, which OpenCV allocates before it finds the file short."""
    tops, pos = set(), 8
    while data.startswith(_PNG_SIGNATURE) and pos + 8 <= len(data):
        tops.add(pos)
        pos += 12 + struct.unpack(">I", data[pos:pos + 4])[0]
    return tops


@pytest.mark.parametrize("name", sorted(FILES))
def test_seeded_byte_changes_read_as_cv2(tmp_path, name):
    data = FILES[name]
    rng = np.random.default_rng(sorted(FILES).index(name))
    start, tops = _coded_data_start(data), _length_tops(data)
    path = tmp_path / name
    outcomes = []
    for i in range(200):
        pos = None
        while pos is None or pos in tops:  # the other three bytes of a length are changed as any byte
            pos = int(rng.integers(0, start)) if i % 2 else int(rng.integers(start, len(data)))
        value = int(rng.integers(0, 256))
        changed = bytearray(data)
        changed[pos] = value if value != data[pos] else value ^ 0xFF
        path.write_bytes(bytes(changed))
        outcomes.append(_read_as_cv2(path))
    assert "none" in outcomes
    if name.startswith("jpeg"):
        assert "image" in outcomes


def _with_chunk(data, chunk, before=b"IDAT"):
    at = data.index(before) - 4
    return data[:at] + chunk + data[at:]


@pytest.mark.parametrize("case", ["text", "unknown_ancillary", "iend", "idat", "ihdr", "plte"])
def test_png_crc_cases_read_as_cv2(tmp_path, case):
    """libpng drops an ancillary chunk with a bad CRC and stops at a critical
    one; OpenCV hands libpng an IEND of its own, so IEND's CRC is not read."""
    base = PNGS["palette"]
    path = tmp_path / "crc.png"
    if case in ("text", "unknown_ancillary"):
        kind = b"tEXt" if case == "text" else b"zzZz"
        data = _with_chunk(base, _bad_crc(_chunk(kind, b"Comment\0damaged")))
    else:
        kind = case.upper().encode()
        at = base.index(kind) - 4
        length = struct.unpack(">I", base[at:at + 4])[0]
        end = at + 12 + length
        data = base[:end - 4] + _bad_crc(base[end - 4:end]) + base[end:]
    path.write_bytes(data)
    readable = case in ("text", "unknown_ancillary", "iend")
    assert _read_as_cv2(path) == ("image" if readable else "none")
    if readable:
        (tmp_path / "base.png").write_bytes(base)
        for flag in FLAGS:
            np.testing.assert_array_equal(image_io.imread(str(path), flag),
                                          image_io.imread(str(tmp_path / "base.png"), flag))


def test_png_gama_with_a_bad_crc_is_dropped_under_grayscale(tmp_path):
    rgb = np.random.default_rng(3).integers(0, 256, (13, 21, 3))
    gama = _chunk(b"gAMA", struct.pack(">I", 45455))
    files = {"none": _png(rgb, 8, 2), "good": _png(rgb, 8, 2, extra=gama),
             "bad_crc": _png(rgb, 8, 2, extra=_bad_crc(gama))}
    gray = {}
    for name, data in files.items():
        (tmp_path / f"{name}.png").write_bytes(data)
        assert _read_as_cv2(tmp_path / f"{name}.png") == "image"
        gray[name] = image_io.imread(str(tmp_path / f"{name}.png"), image_io.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(gray["bad_crc"], gray["none"])
    assert (gray["good"] != gray["none"]).any()  # the gamma matters where it is read


@pytest.mark.parametrize("ext", [".tiff", ".webp", ".jp2", ".avif"])
def test_other_formats_raise_a_plain_value_error(tmp_path, ext):
    path = str(tmp_path / f"x{ext}")
    if ext == ".tiff":  # TIFF is read; CCITT Group 4, written by PIL, is a kind left out
        Image = pytest.importorskip("PIL.Image")
        Image.fromarray(_scene(48, 64, 0)).convert("1").save(path, compression="group4")
        match = "which this reader leaves out"
    else:
        assert cv2.imwrite(path, _scene(48, 64, 0))
        match = "this reader decodes JPEG, PNG, BMP"
    assert cv2.imread(path) is not None
    with pytest.raises(ValueError, match=match) as info:
        image_io.imread(path)
    assert not isinstance(info.value, image_io.UnreadableImage)


def test_bytes_no_decoder_knows_raise_the_none_error(tmp_path):
    for name, data in (("empty", b""), ("text", b"not an image\n"), ("cut_jpeg", JPEGS["gray"][:2])):
        path = tmp_path / name
        path.write_bytes(data)
        for flag in FLAGS:
            assert cv2.imread(str(path), flag) is None
            with pytest.raises(image_io.UnreadableImage):
                image_io.imread(str(path), flag)


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
@pytest.mark.parametrize("block", ["whole", "broken_off"])
def test_a_damaged_exif_orientation_turns_the_image_as_cv2(tmp_path, fmt, block):
    """OpenCV's EXIF reader keeps the entries it read before a block breaks
    off: Orientation 6 first, then an entry cut short."""
    tiff = (b"MM\0*" + struct.pack(">IH", 8, 2) + struct.pack(">HHIHH", 0x0112, 3, 1, 6, 0)
            + b"\x01\x0f\0\x02" + (bytes(12) if block == "whole" else b""))
    img = _scene(16, 24, 4)
    if fmt == "jpeg":
        data, body = _jpeg(img), b"Exif\0\0" + tiff
        data = data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]
    else:
        data = _with_chunk(cv2.imencode(".png", img)[1].tobytes(), _chunk(b"eXIf", tiff))
    (tmp_path / "x").write_bytes(data)
    assert _read_as_cv2(tmp_path / "x") == "image"
    assert image_io.imread(str(tmp_path / "x")).shape == (24, 16, 3)  # turned


# ------------------------------------------------------------ the datasets

def _partial_jpeg(img):
    """img as a JPEG cut in the middle of its scan: OpenCV reads a partial frame."""
    data = _jpeg(img)
    return data[:(_coded_data_start(data) + len(data)) // 2]


def _none_png(img):
    """img as a PNG cut before its IEND: OpenCV returns None."""
    data = cv2.imencode(".png", img)[1].tobytes()
    return data[:len(data) - 20]


def _forgiven_png(img):
    """img as a PNG with a bad CRC in a tEXt chunk: OpenCV reads it whole."""
    return _with_chunk(cv2.imencode(".png", img)[1].tobytes(),
                       _bad_crc(_chunk(b"tEXt", b"Comment\0damaged")))


DAMAGE = {"partial_jpeg": _partial_jpeg, "none_png": _none_png, "forgiven_png": _forgiven_png}


def test_dsec_det_reads_damaged_frames_as_jax(tmp_path):
    """Frames 1-3 of a raw DSEC-Det sequence damaged in place (both readers
    go by content, not by name): frn_tpu's zeros where cv2.imread gives None,
    its partial frame, its forgiven PNG; every frame equal."""
    geo = dataclasses.replace(jconfig.DSEC_DET, height=48, width=64)
    root = jsynthetic.make_dsec_det_fixture(str(tmp_path / "raw"), num_sequences=1,
                                            frames_per_sequence=5, geometry=geo)
    jds = jdsec.DSECDetDataset(root, geometry=geo)
    tds = tdsec.DSECDetDataset(root, geometry=dataclasses.replace(tconfig.DSEC_DET, height=48, width=64))
    jseq, tseq = jds.sequences[0], tds.sequences[0]
    for k, damage in enumerate(DAMAGE.values(), start=1):
        path = jseq.image_paths[k]
        path.write_bytes(damage(cv2.imread(str(path))))
    for i in range(len(jseq.image_paths)):
        got, want = tds.load_image_u8(tseq, i), jds.load_image_u8(jseq, i)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
    assert not tds.load_image_u8(tseq, 2).any()  # the None: zeros
    assert tds.load_image_u8(tseq, 1).any() and (tds.load_image_u8(tseq, 1)[-8:] == 128).all()
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_csv_dataset_answers_damaged_frames_as_jax(tmp_path):
    geos = (dataclasses.replace(jconfig.DSEC, height=48, width=80),
            dataclasses.replace(tconfig.DSEC, height=48, width=80))
    fix = jsynthetic.make_csv_fixture(str(tmp_path), geometry=geos[0], num_images=4, seed=5)
    args = (fix["annotations_csv"], fix["class_map_csv"], fix["event_dir"], fix["img_dir"])
    jds = jcsv.CSVDetectionDataset(geos[0], *args, event_type="gray")
    tds = tcsv.CSVDetectionDataset(geos[1], *args, event_type="gray")
    for i, damage in enumerate(DAMAGE.values()):
        data = damage(cv2.imread(tds.rgb_path(i)))
        open(tds.rgb_path(i), "wb").write(data)
    # gray event frames: a partial one, one that OpenCV returns None for, two sound
    gray = np.random.default_rng(0).integers(0, 256, (4, 48, 80), np.uint8)
    for i, make in enumerate((_partial_jpeg, _none_png, _forgiven_png, lambda g: _png(g, 8, 0))):
        open(tds.event_path(i), "wb").write(make(gray[i]))
    for i in (0, 2, 3):
        np.testing.assert_array_equal(tds.load_rgb(i), jds.load_rgb(i), err_msg=f"image {i}")
        np.testing.assert_array_equal(tds.load_event(i), jds.load_event(i), err_msg=f"event {i}")
    for ds in (tds, jds):
        with pytest.raises(FileNotFoundError, match="000001"):
            ds.load_rgb(1)
    with pytest.raises(image_io.UnreadableImage):
        tds.load_event(1)
    with pytest.raises((TypeError, AttributeError)):  # frn_tpu indexes the None
        jds.load_event(1)


def test_coco_and_oid_read_damaged_jpegs_as_jax(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    (img_dir / "p1.jpg").write_bytes(_partial_jpeg(_scene(45, 61, 2)))
    (img_dir / "p2.jpg").write_bytes(_none_png(_scene(30, 50, 3)))
    coco = {"images": [{"id": 1, "file_name": "p1.jpg", "width": 61, "height": 45},
                       {"id": 2, "file_name": "p2.jpg", "width": 50, "height": 30}],
            "categories": [{"id": 4, "name": "car"}],
            "annotations": [{"image_id": 1, "bbox": [3, 4, 20, 12], "category_id": 4},
                            {"image_id": 2, "bbox": [1.5, 2, 9, 17], "category_id": 4}]}
    (tmp_path / "instances.json").write_text(json.dumps(coco))
    meta = tmp_path / "meta"
    meta.mkdir()
    (meta / "class-descriptions-boxable.csv").write_text("/m/01,Person\n")
    (tmp_path / "ann.csv").write_text("ImageID,LabelName,XMin,XMax,YMin,YMax\n"
                                      "p1,/m/01,0.1,0.5,0.2,0.8\np2,/m/01,0.25,0.75,0.1,0.35\n")
    for make in (lambda m: m.CocoJsonDataset(str(img_dir), str(tmp_path / "instances.json")),
                 lambda m: m.OidDataset(str(img_dir), str(meta), str(tmp_path / "ann.csv"))):
        got, want = make(textra), make(jextra)
        assert (img_dir / "p1.jpg").stat().st_size and got[0].keys() == want[0].keys()
        for key in want[0]:
            np.testing.assert_array_equal(got[0][key], want[0][key], err_msg=key)
        assert (got[0]["rgb"] == 128 / 255).any()  # the undecoded rest of the scan
        with pytest.raises(image_io.UnreadableImage):
            got[1]
        with pytest.raises((TypeError, AttributeError)):  # frn_tpu fails on the None
            want[1]
