"""BMP, PBM/PGM/PPM, PAM, PFM, Sun raster, Radiance HDR and GIF: the port's
reader against ``cv2.imread``, bit for bit, on the CPU.

``frn_tpu`` reads every image through ``cv2.imread``, which picks its
decoder by the file's content; for these seven formats the decoders are
OpenCV's own code. The port reproduces them (``data/image_io.py``, and
``native/codecs.cpp`` for the run-length and LZW codings). Every comparison
is exact, under ``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE``, and where
``cv2.imread`` returns None the port raises ``image_io.UnreadableImage``
(where cv2 raises ``cv2.error``, a plain ``ValueError``):

* every variant below, from ``cv2.imwrite`` and PIL where they write the
  kind and built byte by byte here otherwise (BMP RLE4/RLE8 with their
  escapes, core and V4/V5 headers, top-down rows, 16-bit BITFIELDS; ASCII
  PNM, maxvals other than 255; every PAM tuple type; Sun raster maps and
  types; interlaced, transparent, multi-frame GIF at every LZW code size;
  little- and big-endian PFM; flat and run-length HDR);
* 32 cuts and 100 seeded byte changes of files of each format;
* the CSV dataset and DSEC-Det over BMP and PPM frames, equal to
  ``frn_tpu``'s;
* without the native library, run-length BMP, HDR and GIF (and a TIFF's
  LZW strips) raise ``RuntimeError``.
"""

import dataclasses
import itertools
import os
import struct

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
from frn_tpu_torch.utils import native
from torch_image_variants import (DAMAGED, PAM_UNDEFINED, cv2_write, bmp, read_outcome, rle8, sub_blocks,
                                  tiff, variants)

FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)
VARIANTS = variants()


def _read_as_cv2(path):
    """image_io.imread against cv2.imread under both flags: the same image,
    or UnreadableImage where cv2 returns None, or ValueError where cv2
    raises. Returns what cv2 gave under each flag."""
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
    if name in PAM_UNDEFINED:
        # OpenCV writes only part of each row of such a file under this flag:
        # the rest is whatever its allocation held, so the port refuses it
        flag = PAM_UNDEFINED[name]
        assert cv2.imread(str(path), flag) is not None
        with pytest.raises(ValueError, match="uninitialized") as info:
            image_io.imread(str(path), flag)
        assert not isinstance(info.value, image_io.UnreadableImage)
        other = cv2.IMREAD_GRAYSCALE if flag == cv2.IMREAD_COLOR else cv2.IMREAD_COLOR
        np.testing.assert_array_equal(image_io.imread(str(path), other), cv2.imread(str(path), other))
        return
    _read_as_cv2(path)


def test_the_variants_cover_what_they_name(tmp_path):
    """The byte-built variants are the kinds their names say, and each
    format has variants that OpenCV reads and variants it refuses."""
    read = {}
    for name, data in VARIANTS.items():
        path = tmp_path / name
        path.write_bytes(data)
        read.setdefault(name.split("_")[0], set()).add(read_outcome(cv2.imread, path, cv2.IMREAD_COLOR)[0])
    assert all({"image", "none"} <= read[fmt] for fmt in ("bmp", "pnm", "pam", "ras", "pfm", "hdr", "gif"))
    assert struct.unpack_from("<I", VARIANTS["bmp_rle8"], 30)[0] == 1
    assert struct.unpack_from("<I", VARIANTS["bmp_rle4"], 30)[0] == 2
    assert struct.unpack_from("<I", VARIANTS["bmp_8bit_v5"], 14)[0] == 124
    assert VARIANTS["gif_interlaced_9_rows"][VARIANTS["gif_interlaced_9_rows"].index(b"\x2c") + 9] & 0x40
    assert VARIANTS["hdr_rle"][VARIANTS["hdr_rle"].index(b"+X 40\n") + 6:][:2] == b"\2\2"


# ------------------------------------------------------------ damaged files

@pytest.mark.parametrize("name", DAMAGED)
def test_cuts_and_byte_changes_read_as_cv2(tmp_path, name):
    data = VARIANTS[name]
    rng = np.random.default_rng(DAMAGED.index(name))
    cases = [data[:n] for n in np.linspace(0, len(data) - 1, 32).astype(int)]
    for _ in range(100):
        changed = bytearray(data)
        pos = int(rng.integers(0, len(data)))
        changed[pos] = (changed[pos] + int(rng.integers(1, 256))) % 256
        cases.append(bytes(changed))
    path = tmp_path / name
    kinds = []
    for case in cases:
        path.write_bytes(case)
        kinds += _read_as_cv2(path)
    assert "none" in kinds and "image" in kinds


# ------------------------------------------------------------ refusals


def test_a_huge_frame_raises_without_allocating_it(tmp_path):
    """Headers declaring frames far larger than their files: the None (or
    cv2's error) before any pixel is allocated."""
    import resource

    cases = {"hdr": VARIANTS["hdr_huge_frame"],
             "bmp": bmp(30000, 30000, 24, bytes(64)),
             "ppm": b"P6\n30000 30000\n255\n" + bytes(64),
             "pfm": b"PF\n30000 30000\n-1\n" + bytes(64),
             "gif": (b"GIF89a" + struct.pack("<HHBBB", 30000, 30000, 0xF1, 0, 0) + bytes(12) + b"\x2c"
                     + struct.pack("<HHHHB", 0, 0, 30000, 30000, 0) + b"\x02" + sub_blocks(b"\x04\x01")
                     + b"\x3b")}
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for name, data in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        for flag in FLAGS:
            with pytest.raises(ValueError):
                image_io.imread(str(path), flag)
    assert resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - peak < 256 * 1024


@pytest.mark.parametrize("name", ["bmp_rle8", "bmp_rle4", "hdr_rle", "gif_code_size_4", "tiff_lzw"])
def test_without_the_native_library_raises_naming_the_cause(tmp_path, monkeypatch, name):
    path = tmp_path / name
    # a TIFF's LZW strips decode in native/tiff.cpp, the others in codecs.cpp
    lib = "tiff" if name.startswith("tiff") else "codecs"
    path.write_bytes(tiff(np.arange(60).reshape(6, 10), 1, compression=5) if lib == "tiff" else VARIANTS[name])
    monkeypatch.setattr(native, f"_{lib}_lib", None)
    monkeypatch.setenv("FRN_DISABLE_NATIVE", "1")
    with pytest.raises(RuntimeError, match="FRN_DISABLE_NATIVE"):
        image_io.imread(str(path))
    monkeypatch.delenv("FRN_DISABLE_NATIVE")
    monkeypatch.setattr(native, f"_{lib}_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match=f"g\\+\\+ could not build {lib}.cpp"):
        image_io.imread(str(path))
    # the plain-row formats need no library
    for plain in ("bmp_8bit", "pnm_cv2_ppm", "pam_cv2_rgb", "ras_8bit_map", "pfm_cv2_colour"):
        (tmp_path / plain).write_bytes(VARIANTS[plain])
        np.testing.assert_array_equal(image_io.imread(str(tmp_path / plain)), cv2.imread(str(tmp_path / plain)))


# ------------------------------------------------------------ the datasets over BMP and PPM frames

TINY_DSEC = (dataclasses.replace(jconfig.DSEC, height=48, width=80),
             dataclasses.replace(tconfig.DSEC, height=48, width=80))


def _reencode(path, fmt, i):
    """A frame rewritten in place (both readers go by content, not by name)
    as BMP (24-bit, or 8-bit RLE over a quantized palette) or PPM."""
    img = cv2.imread(path)
    if fmt == "ppm":
        data = cv2_write(".ppm", img)
    elif i % 2:
        data = cv2_write(".bmp", img)
    else:
        pal = (np.arange(64)[:, None] * np.array([[4, 3, 2]])) % 256
        index = (img[:, :, 1] // 4).astype(np.uint8)
        ops = [op for row in index[::-1] for op in (("abs", row.tolist()), ("eol",))] + [("eob",)]
        data = bmp(img.shape[1], img.shape[0], 8, rle8(ops), compression=1, palette=pal)
    open(path, "wb").write(data)


@pytest.mark.parametrize("fmt", ["bmp", "ppm"])
def test_csv_dataset_over_bmp_and_ppm_frames_equals_jax(tmp_path, fmt):
    fix = jsynthetic.make_csv_fixture(str(tmp_path), geometry=TINY_DSEC[0], num_images=4, seed=7)
    rng = np.random.default_rng(1)
    for dirpath, _, files in itertools.chain(os.walk(fix["img_dir"]), os.walk(fix["event_dir"])):
        for i, f in enumerate(sorted(files)):
            path = os.path.join(dirpath, f)
            if f.endswith(".png"):
                _reencode(path, fmt, i)
            elif f.endswith(".npz"):
                h, w = np.load(path)["arr_0"].shape[1:]
                gray = rng.integers(0, 255, (h, w), np.uint8)
                open(path.replace(".npz", ".png"), "wb").write(
                    cv2_write(".pgm" if fmt == "ppm" else ".bmp", gray))
    args = (fix["annotations_csv"], fix["class_map_csv"], fix["event_dir"], fix["img_dir"])
    jds = jcsv.CSVDetectionDataset(TINY_DSEC[0], *args, event_type="gray")
    tds = tcsv.CSVDetectionDataset(TINY_DSEC[1], *args, event_type="gray")
    assert len(tds) == len(jds) == 4
    for i in range(len(jds)):
        assert open(tds.rgb_path(i), "rb").read(2) == (b"BM" if fmt == "bmp" else b"P6")
        got, want = tds[i], jds[i]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("fmt", ["bmp", "ppm"])
def test_dsec_det_over_bmp_and_ppm_frames_equals_jax(tmp_path, fmt):
    geo = dataclasses.replace(jconfig.DSEC_DET, height=48, width=64)
    root = jsynthetic.make_dsec_det_fixture(str(tmp_path / "raw"), num_sequences=1,
                                            frames_per_sequence=4, geometry=geo)
    jds = jdsec.DSECDetDataset(root, geometry=geo)
    tds = tdsec.DSECDetDataset(root, geometry=dataclasses.replace(tconfig.DSEC_DET, height=48, width=64))
    jseq, tseq = jds.sequences[0], tds.sequences[0]
    for i, path in enumerate(jseq.image_paths):
        _reencode(str(path), fmt, i)
    for i in range(len(jseq.image_paths)):
        got, want = tds.load_image_u8(tseq, i), jds.load_image_u8(jseq, i)
        assert got.dtype == want.dtype == np.uint8 and got.any()
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
