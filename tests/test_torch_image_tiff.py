"""TIFF: the port's reader against ``cv2.imread`` (libtiff 4.7.1 under
OpenCV 5.0), bit for bit, on the CPU.

``frn_tpu`` reads every image through ``cv2.imread``, which hands a TIFF to
libtiff's RGBA reader. The port decodes TIFF with its own code
(``data/image_io.py`` for the directory, the predictor and the photometric
conversions; ``native/tiff.cpp`` for LZW, Deflate and PackBits;
``native/jpeg.cpp`` for JPEG strips). Every comparison is exact, under
``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE``; where ``cv2.imread`` returns
None the port raises ``image_io.UnreadableImage``, where it raises
``cv2.error`` a plain ``ValueError``:

* every variant of ``tests/torch_image_variants.tiff_variants()``: built
  byte by byte (every compression the port reads, the predictor, strips
  and tiles, planar 1 and 2, both byte orders and BigTIFF, the photometric
  kinds at their depths, extra samples, orientations 1-8, the directory's
  odd cases) and written by ``cv2.imencode`` and PIL;
* every cut and 200 seeded byte changes of six small damaged files;
* a forged huge TIFF, refused before anything is allocated; a large
  single-strip frame read within a few copies of its pixels; a JPEG TIFF of
  thousands of strips, each with its own tables, read in linear time;
* the kinds left out, refused with a plain ``ValueError`` naming them;
* the CSV dataset (RGB and gray event frames) and DSEC-Det over TIFF
  frames, equal to ``frn_tpu``'s.
"""

import dataclasses
import itertools
import os
import struct
import time
import tracemalloc

import cv2
import numpy as np
import pytest

from frn_tpu import config as jconfig
from frn_tpu.data import csv_dataset as jcsv
from frn_tpu.data import dsec_det as jdsec
from frn_tpu.data import synthetic as jsynthetic
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.data import csv_dataset as tcsv
from frn_tpu_torch.data import dsec_det as tdsec
from frn_tpu_torch.data import image_io
from torch_image_variants import (LONG, SHORT, TIFF_DAMAGED, read_outcome, tiff, tiff_damaged, tiff_jpeg_strips,
                                  tiff_left_out, tiff_variants)

FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)
VARIANTS = tiff_variants()
DAMAGED = tiff_damaged()
LEFT_OUT = tiff_left_out()


def _read_as_cv2(path):
    """image_io.imread against cv2.imread under both flags; returns what
    cv2 gave under each."""
    kinds = []
    for flag in FLAGS:
        want, got = read_outcome(cv2.imread, path, flag), read_outcome(image_io.imread, path, flag)
        assert got[0] == want[0], (path, flag, want[0], got)
        if want[0] == "image":
            assert got[1].dtype == np.uint8 and got[1].shape == want[1].shape, (path, flag)
            np.testing.assert_array_equal(got[1], want[1], err_msg=f"{path} flag {flag}")
        kinds.append(want[0])
    return kinds


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_reads_as_cv2(tmp_path, name):
    path = tmp_path / name
    path.write_bytes(VARIANTS[name])
    _read_as_cv2(path)


def test_the_variants_cover_what_they_name(tmp_path):
    """The byte-built variants are the kinds their names say, and OpenCV
    reads some of each family and refuses others."""
    outcomes = {}
    for name, data in VARIANTS.items():
        path = tmp_path / name
        path.write_bytes(data)
        outcomes[name] = read_outcome(cv2.imread, path, cv2.IMREAD_COLOR)[0]
    for family in ("tiff_gray", "tiff_palette", "tiff_orientation", "tiff_compression", "tiff_jpeg"):
        assert {"image", "none"} <= {k for n, k in outcomes.items() if n.startswith(family)}, family
    assert {outcomes[f"tiff_orientation_{o}"] for o in range(1, 5)} == {"image"}
    assert {outcomes[f"tiff_orientation_{o}"] for o in range(5, 9)} == {"none"}
    assert VARIANTS["tiff_bigtiff_mm"][:4] == b"MM\0+" and VARIANTS["tiff_bigtiff_ii"][:4] == b"II+\0"
    assert VARIANTS["tiff_lzw_one_strip_mm"][:4] == b"MM\0*"
    old = VARIANTS["tiff_lzw_old_style"]
    assert old[8] == 0 and old[9] & 1  # the old-style codes libtiff recognizes
    for name in ("tiff_lzw_predictor_ii", "tiff_deflate_predictor_16bit_mm"):
        assert struct.pack("<HHI" if "_ii" in name else ">HHI", 317, SHORT, 1) in VARIANTS[name]
    assert all(d[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+") for d in DAMAGED.values())


# ------------------------------------------------------------ damaged files


@pytest.mark.parametrize("name", TIFF_DAMAGED)
def test_every_cut_reads_as_cv2(tmp_path, name):
    data = DAMAGED[name]
    path = tmp_path / name
    kinds = []
    for n in range(len(data)):
        path.write_bytes(data[:n])
        kinds += _read_as_cv2(path)
    path.write_bytes(data)
    assert _read_as_cv2(path) == ["image", "image"] and "none" in kinds


@pytest.mark.parametrize("name", TIFF_DAMAGED)
def test_seeded_byte_changes_read_as_cv2(tmp_path, name):
    data = DAMAGED[name]
    rng = np.random.default_rng(TIFF_DAMAGED.index(name))
    path = tmp_path / name
    kinds = []
    for _ in range(200):
        changed = bytearray(data)
        pos = int(rng.integers(0, len(data)))
        changed[pos] = (changed[pos] + int(rng.integers(1, 256))) % 256
        path.write_bytes(bytes(changed))
        kinds += _read_as_cv2(path)
    assert "none" in kinds and "image" in kinds


# ------------------------------------------------------------ refusals


def test_a_forged_huge_tiff_raises_without_allocating(tmp_path):
    """Directories declaring frames, strips or tiles far larger than their
    files: refused (the None, or the error cv2.imread raises for a frame
    past its limits) before any pixel is allocated."""
    import resource

    small = np.zeros((2, 2), np.int64)
    cases = {
        "frame": tiff(small, 1, compression=5, tags={256: (LONG, [30000]), 257: (LONG, [30000])}),
        "past_limits": tiff(small, 1, tags={256: (LONG, [1 << 21]), 257: (LONG, [1 << 21])}),
        "strip": tiff(small, 1, tags={256: (LONG, [16000]), 257: (LONG, [16000]), 278: (LONG, [16000])}),
        "tile": tiff(small, 2, compression=8, tile=(16, 16),
                     tags={256: (LONG, [20000]), 257: (LONG, [20000]), 322: (LONG, [1 << 14]),
                           323: (LONG, [1 << 14])}),
    }
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for name, data in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        for flag in FLAGS:
            with pytest.raises(ValueError):
                image_io.imread(str(path), flag)
    assert resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - peak < 256 * 1024


@pytest.mark.parametrize("compression", [1, 8], ids=["uncompressed", "deflate"])
def test_a_large_single_strip_tiff_reads_within_a_few_copies_of_its_pixels(tmp_path, compression):
    """A 1,500 x 2,000 RGB frame in one strip: samples stay 8-bit from the
    file's bytes to the image, so the peak of the reader's traced
    allocations (numpy's buffers and the file's bytes included) stays under
    four times the image's bytes under both flags."""
    img = np.random.default_rng(5).integers(0, 256, (1500, 2000, 3), np.uint8)
    path = tmp_path / "large.tiff"
    path.write_bytes(tiff(img, 2, compression=compression))
    for flag in FLAGS:
        tracemalloc.start()
        try:
            got = image_io.imread(str(path), flag)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        np.testing.assert_array_equal(got, cv2.imread(str(path), flag))
        assert peak < 4 * img.nbytes, (flag, peak / img.nbytes)


def test_a_jpeg_tiff_of_many_strips_with_their_own_tables_reads_in_linear_time(tmp_path, monkeypatch):
    """3,000 one-row JPEG strips, each a whole JPEG file with its own
    tables. libjpeg holds at most 4 quantization and 8 Huffman tables from
    one strip to the next; so do the tables carried in front of each strip,
    so that no strip's stream grows with the strips before it, and the file
    reads as cv2.imread reads it, within seconds."""
    bgr = np.random.default_rng(6).integers(0, 256, (3000, 16, 3), np.uint8)
    data = tiff_jpeg_strips(bgr, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    path = tmp_path / "strips.tiff"
    path.write_bytes(data)
    streams, tables = [], image_io._jpeg_tables
    monkeypatch.setattr(image_io, "_jpeg_tables", lambda stream: streams.append(len(stream)) or tables(stream))
    start = time.perf_counter()
    image_io.imread(str(path))
    assert time.perf_counter() - start < 3
    assert len(streams) == 3000 and max(streams) < 2 + image_io._JPEG_TABLES_BYTES + len(data) // 3000 * 2
    _read_as_cv2(path)


@pytest.mark.parametrize("name", sorted(LEFT_OUT))
def test_left_out_kinds_raise_a_plain_value_error_naming_them(tmp_path, name):
    data, words = LEFT_OUT[name]
    path = tmp_path / name
    path.write_bytes(data)
    for flag in FLAGS:
        assert cv2.imread(str(path), flag) is not None
        with pytest.raises(ValueError, match=f"{words}.*which this reader leaves out") as info:
            image_io.imread(str(path), flag)
        assert not isinstance(info.value, image_io.UnreadableImage)


# ------------------------------------------------------------ the datasets over TIFF frames

TINY_DSEC = (dataclasses.replace(jconfig.DSEC, height=48, width=80),
             dataclasses.replace(tconfig.DSEC, height=48, width=80))


def _as_tiff(img, i):
    """A frame as TIFF in turn: LZW strips with the predictor, Deflate tiles,
    PackBits, big-endian JPEG strips... (both readers go by content)."""
    if img.ndim == 2:
        return tiff(img, 1, compression=(5, 8, 32773)[i % 3], rows=7, predictor=2 if i % 3 == 0 else None)
    rgb = img[:, :, ::-1]
    kind = i % 4
    if kind == 0:
        return tiff(rgb, 2, compression=5, rows=8, predictor=2)
    if kind == 1:
        return tiff(rgb, 2, compression=8, tile=(16, 32), order=">")
    if kind == 2:
        return tiff(rgb, 2, compression=32773, planar=2, rows=16)
    return tiff(rgb, 2, big=True, rows=5)


def test_csv_dataset_over_tiff_frames_equals_jax(tmp_path):
    fix = jsynthetic.make_csv_fixture(str(tmp_path), geometry=TINY_DSEC[0], num_images=4, seed=11)
    rng = np.random.default_rng(3)
    for dirpath, _, files in itertools.chain(os.walk(fix["img_dir"]), os.walk(fix["event_dir"])):
        for i, f in enumerate(sorted(files)):
            path = os.path.join(dirpath, f)
            if f.endswith(".png"):
                data = _as_tiff(cv2.imread(path), i)
                open(path, "wb").write(data)
            elif f.endswith(".npz"):
                h, w = np.load(path)["arr_0"].shape[1:]
                gray = rng.integers(0, 255, (h, w), np.uint8)
                open(path.replace(".npz", ".png"), "wb").write(_as_tiff(gray, i))
    args = (fix["annotations_csv"], fix["class_map_csv"], fix["event_dir"], fix["img_dir"])
    jds = jcsv.CSVDetectionDataset(TINY_DSEC[0], *args, event_type="gray")
    tds = tcsv.CSVDetectionDataset(TINY_DSEC[1], *args, event_type="gray")
    assert len(tds) == len(jds) == 4
    for i in range(len(jds)):
        assert open(tds.rgb_path(i), "rb").read(2) in (b"II", b"MM")
        got, want = tds[i], jds[i]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_dsec_det_over_tiff_frames_equals_jax(tmp_path):
    geo = dataclasses.replace(jconfig.DSEC_DET, height=48, width=64)
    root = jsynthetic.make_dsec_det_fixture(str(tmp_path / "raw"), num_sequences=1,
                                            frames_per_sequence=4, geometry=geo)
    jds = jdsec.DSECDetDataset(root, geometry=geo)
    tds = tdsec.DSECDetDataset(root, geometry=dataclasses.replace(tconfig.DSEC_DET, height=48, width=64))
    jseq, tseq = jds.sequences[0], tds.sequences[0]
    for i, path in enumerate(jseq.image_paths):
        data = _as_tiff(cv2.imread(str(path)), i)
        open(path, "wb").write(data)
    for i in range(len(jseq.image_paths)):
        got, want = tds.load_image_u8(tseq, i), jds.load_image_u8(jseq, i)
        assert got.dtype == want.dtype == np.uint8 and got.any()
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
