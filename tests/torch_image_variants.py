"""Image files of every kind that ``cv2.imread`` reads with OpenCV's own
decoders (BMP, PBM/PGM/PPM, PAM, PFM, Sun raster, Radiance HDR, GIF) and
with libtiff (TIFF), built byte by byte or written by ``cv2.imencode`` and
PIL, for ``tests/test_torch_image_formats.py`` and
``tests/test_torch_image_tiff.py`` on the CPU and ``chip_smoke.py``'s
format sweep on the card's machine. Imports numpy, OpenCV and, where it is
installed, PIL, and the port's ``image_io``; nothing of JAX.

``variants()`` -> {name: bytes}; ``PAM_UNDEFINED`` names the PAM files that
OpenCV reads with part of the image left uninitialized under the flag
given; ``DAMAGED`` names the files cut and changed byte by byte;
``tiff_variants()``, ``tiff_damaged()`` (the files of ``TIFF_DAMAGED``) and
``tiff_left_out()`` are the same for TIFF (the last: kinds the port
refuses by name); ``read_outcome`` puts what ``cv2.imread`` and the port's
``imread`` give in common terms.
"""

import io
import itertools
import struct
import zlib

import cv2
import numpy as np

from frn_tpu_torch.data import image_io

try:
    from PIL import Image
except ImportError:  # the PIL-written variants are left out
    Image = None


def read_outcome(read, path, flag):
    """('image', array) or ('none', None) for what cv2.imread or
    image_io.imread gives (UnreadableImage is the None); ('error', message)
    for cv2.error or another ValueError, except the port's refusal of a PAM
    that OpenCV reads into uninitialized memory, ('undefined', None)."""
    try:
        img = read(str(path), flag)
    except image_io.UnreadableImage:
        return "none", None
    except cv2.error as e:
        return "error", str(e)
    except ValueError as e:
        return ("undefined", None) if "uninitialized" in str(e) else ("error", str(e))
    return ("none", None) if img is None else ("image", img)


def _rng(name):
    return np.random.default_rng(sum(name.encode()))


def cv2_write(ext, img, *params):
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


def pil_write(img, fmt, mode=None, **kw):
    im = Image.fromarray(img)
    out = io.BytesIO()
    (im.convert(mode) if mode else im).save(out, fmt, **kw)
    return out.getvalue()


# ------------------------------------------------------------ BMP


def bmp_rows(values, bpp):
    """(h, w) indices at 1, 4, 8 bits, (h, w) uint16 at 16, (h, w, 3 or 4)
    bytes at 24 or 32 -> rows padded to 4 bytes, in the order given."""
    values = np.asarray(values)
    h, w = values.shape[:2]
    if bpp < 8:
        per = 8 // bpp
        v = np.concatenate([values, np.zeros((h, -w % per), values.dtype)], 1).astype(np.int64)
        rows = (v.reshape(h, -1, per) << ((8 - bpp) - bpp * np.arange(per))).sum(2).astype(np.uint8)
    elif bpp == 16:
        rows = values.astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        rows = values.astype(np.uint8).reshape(h, -1)
    pad = -rows.shape[1] % 4
    return np.concatenate([rows, np.zeros((h, pad), np.uint8)], 1).tobytes()


def bmp(w, h, bpp, body, compression=0, palette=None, header=40, masks=(), used=0, offset=None):
    """A BMP: ``body`` the pixel data, ``palette`` (n, 3) RGB written as
    BGR0 (BGR for the 12-byte core header), ``masks`` DWORDs after the
    header (or inside a V4/V5 header)."""
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        pal = (p if header == 12 else np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)).tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
        extra = b""
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, h, 1, bpp, compression, len(body), 2835, 2835,
                           used, 0)
        inside = struct.pack(f"<{len(masks)}I", *masks)
        if header > 40:
            info += (inside + bytes(header - 40))[:header - 40]
            extra = b""
        else:
            extra = inside
    start = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", start + len(body), 0, 0, start if offset is None else offset)
            + info + extra + pal + body)


def rle8(rows):
    """Rows of (kind, ...) operations -> an RLE8 stream."""
    out = bytearray()
    for op in rows:
        if op[0] == "run":
            out += bytes([op[1], op[2]])
        elif op[0] == "abs":
            vals = bytes(op[1])
            out += bytes([0, len(vals)]) + vals + b"\0" * (len(vals) % 2)
        elif op[0] == "eol":
            out += b"\0\0"
        elif op[0] == "eob":
            out += b"\0\1"
        elif op[0] == "delta":
            out += bytes([0, 2, op[1], op[2]])
    return bytes(out)


def rle4(rows):
    out = bytearray()
    for op in rows:
        if op[0] == "run":  # count, two indices in turn
            out += bytes([op[1], op[2] << 4 | op[3]])
        elif op[0] == "abs":
            vals = list(op[1]) + [0] * (len(op[1]) % 2)
            packed = bytes(a << 4 | b for a, b in zip(vals[0::2], vals[1::2]))
            out += bytes([0, len(op[1])]) + packed + b"\0" * (len(packed) % 2)
        else:
            out += rle8([op])
    return bytes(out)


def _bmp_variants():
    v = {}
    rng = _rng("bmp")
    pal = rng.integers(0, 256, (256, 3))
    h, w = 11, 13
    for bpp in (1, 4, 8):
        idx = rng.integers(0, 1 << bpp, (h, w))
        v[f"bmp_{bpp}bit"] = bmp(w, h, bpp, bmp_rows(idx[::-1], bpp), palette=pal[:1 << bpp])
        v[f"bmp_{bpp}bit_top_down"] = bmp(w, -h, bpp, bmp_rows(idx, bpp), palette=pal[:1 << bpp])
        v[f"bmp_{bpp}bit_core"] = bmp(w, h, bpp, bmp_rows(idx[::-1], bpp), palette=pal[:1 << bpp],
                                       header=12)
    idx = rng.integers(0, 256, (h, w))
    v["bmp_8bit_20_used"] = bmp(w, h, 8, bmp_rows(idx, 8), palette=pal[:20], used=20)
    v["bmp_8bit_gray_palette"] = bmp(w, h, 8, bmp_rows(idx, 8), palette=np.repeat(np.arange(256)[:, None], 3, 1))
    v["bmp_8bit_300_used"] = bmp(w, h, 8, bmp_rows(idx, 8), palette=pal, used=300)
    v["bmp_8bit_v5"] = bmp(w, h, 8, bmp_rows(idx, 8), palette=pal, header=124)
    rgb = rng.integers(0, 256, (h, w, 3))
    v["bmp_24bit_top_down"] = bmp(w, -h, 24, bmp_rows(rgb, 24))
    v["bmp_24bit_core"] = bmp(w, h, 24, bmp_rows(rgb, 24), header=12)
    v["bmp_24bit_v4"] = bmp(w, h, 24, bmp_rows(rgb, 24), header=108)
    v["bmp_24bit_offset_in_header"] = bmp(w, h, 24, bmp_rows(rgb, 24), offset=30)
    rgba = rng.integers(0, 256, (h, w, 4))
    v["bmp_32bit"] = bmp(w, h, 32, bmp_rows(rgba, 32))
    v["bmp_32bit_bitfields"] = bmp(w, h, 32, bmp_rows(rgba, 32), compression=3,
                                    masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000), header=56)
    v["bmp_32bit_v5_bitfields"] = bmp(w, h, 32, bmp_rows(rgba, 32), compression=3, header=124,
                                       masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    t = rng.integers(0, 1 << 16, (h, w))
    v["bmp_16bit_555"] = bmp(w, h, 16, bmp_rows(t, 16))
    v["bmp_16bit_555_bitfields"] = bmp(w, h, 16, bmp_rows(t, 16), compression=3,
                                        masks=(0x7C00, 0x3E0, 0x1F))
    v["bmp_16bit_565_bitfields"] = bmp(w, -h, 16, bmp_rows(t, 16), compression=3,
                                        masks=(0xF800, 0x7E0, 0x1F))
    v["bmp_16bit_other_masks"] = bmp(w, h, 16, bmp_rows(t, 16), compression=3,
                                      masks=(0xF00, 0xF0, 0xF))
    v["bmp_16bit_565_v5"] = bmp(w, h, 16, bmp_rows(t, 16), compression=3, header=124,
                                 masks=(0xF800, 0x7E0, 0x1F))
    v["bmp_cv2_24bit"] = cv2_write(".bmp", rgb.astype(np.uint8))
    v["bmp_cv2_gray"] = cv2_write(".bmp", rgb[:, :, 0].astype(np.uint8))
    for mode in ("1", "L", "P", "RGB", "RGBA") if Image else ():
        v[f"bmp_pil_{mode}"] = pil_write(rgb.astype(np.uint8), "BMP", mode)
    # run-length: 8-bit
    h, w = 7, 10
    ops = [("run", 4, 3), ("abs", [9, 200, 17]), ("run", 3, 250), ("eol",),  # row 0 full: eol ignored
           ("run", 2, 5), ("eol",),  # row 1: the rest index 0
           ("abs", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]), ("eol",),  # row 2 full by an absolute run
           ("delta", 3, 1), ("run", 5, 77),  # skip to row 4, x 3
           ("run", 2, 78), ("eol",),
           ("run", 10, 99),  # row 5 full: the run moves to row 6
           ("abs", [11, 12, 13]), ("eob",)]
    v["bmp_rle8"] = bmp(w, h, 8, rle8(ops), compression=1, palette=pal)
    v["bmp_rle8_top_down"] = bmp(w, -h, 8, rle8(ops), compression=1, palette=pal)
    v["bmp_rle8_no_eob"] = bmp(w, h, 8, rle8([("run", 10, 1 + y) for y in range(h)]), compression=1,
                                palette=pal)
    v["bmp_rle8_delta_past_rows"] = bmp(w, h, 8, rle8([("run", 2, 9), ("delta", 4, 9), ("run", 3, 8)]),
                                         compression=1, palette=pal)
    v["bmp_rle8_run_past_row"] = bmp(w, h, 8, rle8([("run", 6, 9), ("run", 6, 8), ("eob",)]),
                                      compression=1, palette=pal)
    v["bmp_rle8_ends_early"] = bmp(w, h, 8, rle8([("run", 6, 9), ("eol",)]), compression=1, palette=pal)
    v["bmp_rle8_20_used"] = bmp(w, h, 8, rle8(ops), compression=1, palette=pal[:20], used=20)
    # run-length: 4-bit. OpenCV 5 moves by the rest of the row on an
    # end-of-line and an end-of-bitmap alike, and by a delta's dx alone
    ops4 = [("run", 5, 3, 12), ("abs", [1, 2, 3]), ("run", 2, 7, 7), ("eol",),  # row 0 full, then eol
            ("run", 3, 1, 2), ("eol",),
            ("abs", [15, 14, 13, 12, 11, 10, 9, 8, 7, 6]), ("eol",),
            ("delta", 2, 2), ("run", 4, 5, 6), ("eol",),
            ("abs", [4, 4, 4, 4, 4]), ("eol",),
            ("run", 10, 8, 9), ("eol",),
            ("run", 3, 1, 1), ("eob",)]
    v["bmp_rle4"] = bmp(w, h, 4, rle4(ops4), compression=2, palette=pal[:16])
    v["bmp_rle4_early_eob"] = bmp(w, h, 4, rle4(ops4[:6] + [("eob",)]), compression=2, palette=pal[:16])
    v["bmp_rle4_run_at_row_end"] = bmp(w, h, 4, rle4([("run", 10, 1, 2), ("run", 2, 3, 4), ("eob",)]),
                                        compression=2, palette=pal[:16])
    v["bmp_rle4_no_eob"] = bmp(w, h, 4, rle4([op for y in range(h) for op in (("run", 10, y, 15 - y),
                                                                                  ("eol",))]),
                                compression=2, palette=pal[:16])
    v["bmp_rle8_with_4_bits"] = bmp(w, h, 4, rle8(ops), compression=1, palette=pal[:16])
    return v


# ------------------------------------------------------------ PBM, PGM, PPM


def _pnm_variants():
    v = {}
    rng = _rng("pnm")
    h, w = 9, 12
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    v["pnm_cv2_ppm"] = cv2_write(".ppm", rgb)
    v["pnm_cv2_pgm"] = cv2_write(".pgm", rgb[:, :, 1])
    v["pnm_cv2_pbm"] = cv2_write(".pbm", rgb[:, :, 1])
    v["pnm_cv2_ppm_ascii"] = cv2_write(".ppm", rgb, cv2.IMWRITE_PXM_BINARY, 0)
    v["pnm_cv2_pgm_ascii"] = cv2_write(".pgm", rgb[:, :, 1], cv2.IMWRITE_PXM_BINARY, 0)
    v["pnm_cv2_pgm_16bit"] = cv2_write(".pgm", rng.integers(0, 65536, (h, w)).astype(np.uint16))
    v["pnm_cv2_ppm_16bit"] = cv2_write(".ppm", rng.integers(0, 65536, (h, w, 3)).astype(np.uint16))
    for mode in ("1", "L", "RGB") if Image else ():
        v[f"pnm_pil_{mode}"] = pil_write(rgb, "PPM", mode)
    bits = rng.integers(0, 2, (h, w))
    v["pnm_p1_comments"] = (b"P1\n# a comment\n12 # width\r9\n"
                            + b"\n".join(b"".join(b"%d" % x for x in row) for row in bits) + b"\n")
    v["pnm_p1_spaced"] = (b"P1 12 9 " + b" ".join(b"%d" % x for x in bits.ravel()))
    for maxval in (1, 7, 100, 255, 256, 1000, 65535):
        vals = rng.integers(0, maxval + 1, (h, w, 3))
        vals[0, :3] = maxval + 5  # above maxval: read as maxval in ASCII
        text = b"\n".join(b" ".join(b"%d" % x for x in row.ravel()) for row in vals)
        v[f"pnm_p3_maxval_{maxval}"] = b"P3\n12 9\n%d\n" % maxval + text + b"\n"
        text = b"\t".join(b"%d" % x for x in vals[:, :, 0].ravel())
        v[f"pnm_p2_maxval_{maxval}"] = b"P2 #c\n12 9 %d\n" % maxval + text + b" "
        if maxval < 256:
            raw = np.minimum(vals, 255).astype(np.uint8)
            v[f"pnm_p6_maxval_{maxval}"] = b"P6\n12 9\n%d\n" % maxval + raw.tobytes()
            v[f"pnm_p5_maxval_{maxval}"] = b"P5 12 9 %d\t" % maxval + raw[:, :, 0].tobytes()
        else:
            raw = np.minimum(vals, 65535).astype(">u2")
            v[f"pnm_p6_maxval_{maxval}"] = b"P6\n12 9\n%d\n" % maxval + raw.tobytes()
            v[f"pnm_p5_maxval_{maxval}"] = b"P5 12 9 %d\n" % maxval + raw[:, :, 0].tobytes()
    v["pnm_p2_no_byte_after_last"] = b"P2 2 1 255 7 9"
    v["pnm_p6_comment_after_maxval"] = b"P6 12 9 255#" + rgb.tobytes()
    v["pnm_p5_maxval_0"] = b"P5 12 9 0\n" + rgb[:, :, 0].tobytes()
    v["pnm_p5_maxval_65536"] = b"P5 12 9 65536\n" + rgb.tobytes()
    v["pnm_p4_odd_width"] = b"P4\n13 9\n" + rng.integers(0, 256, 18).astype(np.uint8).tobytes()
    v["pnm_p3_letter"] = b"P3\n1 1\n255\n1 2 x\n"
    v["pnm_signature_without_space"] = b"P6#\n12 9\n255\n" + rgb.tobytes()
    v["pnm_huge_width"] = b"P5\n2000000 1\n255\n" + bytes(64)
    v["pnm_zero_width"] = b"P5\n0 1\n255\n" + bytes(64)
    return v


# ------------------------------------------------------------ PAM


def pam(w, h, depth, maxval, tuple_type, samples, lines=None):
    head = lines or [f"WIDTH {w}", f"HEIGHT {h}", f"DEPTH {depth}", f"MAXVAL {maxval}"]
    if tuple_type is not None:
        head = head + [f"TUPLTYPE {tuple_type}"]
    dtype = ">u2" if maxval > 255 else np.uint8
    return ("P7\n" + "\n".join(head) + "\nENDHDR\n").encode() + np.asarray(samples).astype(dtype).tobytes()


# name -> the flag under which OpenCV leaves part of the image uninitialized
PAM_UNDEFINED = {f"pam_{kind}_maxval_{maxval}": cv2.IMREAD_COLOR
                 for kind in ("grayscale_alpha", "rgb_alpha") for maxval in (200, 255, 4000)}


def _pam_variants():
    v = {}
    rng = _rng("pam")
    h, w = 7, 9
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    v["pam_cv2_rgb"] = cv2_write(".pam", rgb)
    v["pam_cv2_gray"] = cv2_write(".pam", rgb[:, :, 0])
    v["pam_cv2_16bit"] = cv2_write(".pam", rng.integers(0, 65536, (h, w, 3)).astype(np.uint16))
    kinds = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2, "RGB": 3, "RGB_ALPHA": 4}
    for (name, depth), maxval in itertools.product(kinds.items(), (1, 200, 255, 4000)):
        samples = rng.integers(0, maxval + 1, (h, w, depth))
        v[f"pam_{name.lower()}_maxval_{maxval}"] = pam(w, h, depth, maxval, name, samples)
    v["pam_no_tuple_type_gray"] = pam(w, h, 1, 255, None, rng.integers(0, 256, (h, w)))
    v["pam_no_tuple_type_rgb"] = pam(w, h, 3, 255, None, rgb)
    v["pam_no_tuple_type_bits"] = pam(w, h, 1, 1, None, rng.integers(0, 2, (h, w)))
    v["pam_no_tuple_type_depth_2"] = pam(w, h, 2, 255, None, rng.integers(0, 256, (h, w, 2)))
    v["pam_rgb_depth_4"] = pam(w, h, 4, 255, "RGB", rng.integers(0, 256, (h, w, 4)))
    v["pam_grayscale_depth_3"] = pam(w, h, 3, 255, "GRAYSCALE", rgb)
    v["pam_depth_0"] = pam(w, h, 0, 1, None, rng.integers(0, 2, (h, w)))
    v["pam_depth_5"] = pam(w, h, 5, 255, "RGB", rng.integers(0, 256, (h, w, 5)))
    v["pam_unknown_tuple_type"] = pam(w, h, 3, 255, "CMYK", rgb)
    v["pam_comments_and_spacing"] = pam(w, h, 3, 255, "RGB", rgb, lines=[
        "# made by hand", f"WIDTH\t {w}  ", "#x", f"HEIGHT {h}", "DEPTH 3", "MAXVAL 255"])
    v["pam_value_on_next_line"] = pam(w, h, 3, 255, "RGB", rgb, lines=[
        f"WIDTH \n{w}", f"HEIGHT {h}", "DEPTH 3", "MAXVAL 255"])
    v["pam_repeated_width"] = pam(w, h, 3, 255, "RGB", rgb, lines=[
        f"WIDTH {w}", f"WIDTH {w}", f"HEIGHT {h}", "DEPTH 3", "MAXVAL 255"])
    v["pam_no_maxval"] = pam(w, h, 3, 255, "RGB", rgb, lines=[f"WIDTH {w}", f"HEIGHT {h}", "DEPTH 3"])
    v["pam_negative_height"] = pam(w, h, 3, 255, "RGB", rgb, lines=[
        f"WIDTH {w}", f"HEIGHT -{h}", "DEPTH 3", "MAXVAL 255"])
    v["pam_number_with_letters"] = pam(w, h, 3, 255, "RGB", rgb, lines=[
        f"WIDTH {w}px", f"HEIGHT {h}", "DEPTH 3", "MAXVAL 255"])
    v["pam_cr_after_signature"] = b"P7\r" + pam(w, h, 3, 255, "RGB", rgb)[3:]
    v["pam_space_after_signature"] = b"P7 " + pam(w, h, 3, 255, "RGB", rgb)[3:]
    return v


# ------------------------------------------------------------ Sun raster


def ras(w, h, bpp, body, kind=1, colour_map=None, map_type=None):
    m = b"" if colour_map is None else np.asarray(colour_map, np.uint8).T.tobytes()  # R..., G..., B...
    mt = (0 if colour_map is None else 1) if map_type is None else map_type
    return struct.pack(">8I", 0x59A66A95, w, h, bpp, len(body), kind, mt, len(m)) + m + body


def ras_rows(values, bpp):
    values = np.asarray(values)
    h = values.shape[0]
    if bpp == 1:
        rows = np.packbits(values.astype(np.uint8), axis=1)
    else:
        rows = values.astype(np.uint8).reshape(h, -1)
    return np.concatenate([rows, np.zeros((h, rows.shape[1] % 2), np.uint8)], 1).tobytes()


def _ras_variants():
    v = {}
    rng = _rng("ras")
    h, w = 8, 11
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    v["ras_cv2_24bit"] = cv2_write(".ras", rgb)
    v["ras_cv2_gray"] = cv2_write(".ras", rgb[:, :, 0])
    bits = rng.integers(0, 2, (h, w))
    idx = rng.integers(0, 256, (h, w))
    cmap = rng.integers(0, 256, (256, 3))
    v["ras_1bit"] = ras(w, h, 1, ras_rows(bits, 1))
    v["ras_1bit_map"] = ras(w, h, 1, ras_rows(bits, 1), colour_map=cmap[:2])
    v["ras_8bit"] = ras(w, h, 8, ras_rows(idx, 8))
    v["ras_8bit_map"] = ras(w, h, 8, ras_rows(idx, 8), colour_map=cmap)
    v["ras_8bit_map_of_100"] = ras(w, h, 8, ras_rows(idx, 8), colour_map=cmap[:100])
    v["ras_8bit_gray_map"] = ras(w, h, 8, ras_rows(idx, 8), colour_map=np.repeat(np.arange(256)[:, None], 3, 1))
    v["ras_8bit_old_type"] = ras(w, h, 8, ras_rows(idx, 8), kind=0, colour_map=cmap)
    v["ras_24bit_old_type"] = ras(w, h, 24, ras_rows(rgb, 24), kind=0)
    v["ras_32bit"] = ras(w, h, 32, ras_rows(rng.integers(0, 256, (h, w, 4)), 32))
    v["ras_24bit_rgb_type"] = ras(w, h, 24, ras_rows(rgb, 24), kind=3)
    encoded = bytes([0x80, 20, 9, 0x80, 0, 7]) + bytes(range(66))
    v["ras_8bit_byte_encoded"] = ras(w, h, 8, encoded, kind=2, colour_map=cmap)
    v["ras_24bit_with_map"] = ras(w, h, 24, ras_rows(rgb, 24), colour_map=cmap[:4])
    v["ras_8bit_map_too_long"] = ras(w, h, 1, ras_rows(bits, 1), colour_map=cmap[:3])
    v["ras_4bit"] = ras(w, h, 4, ras_rows(idx, 8))
    return v


# ------------------------------------------------------------ PFM


def pfm(values, scale=-1.0, header=None):
    values = np.asarray(values, np.float32)
    kind = b"PF" if values.ndim == 3 else b"Pf"
    h, w = values.shape[:2]
    order = "<f4" if scale < 0 else ">f4"
    head = header or kind + b"\n%d %d\n%r\n" % (w, h, scale)
    return head + values[::-1].astype(order).tobytes()


def _pfm_variants():
    v = {}
    rng = _rng("pfm")
    h, w = 6, 7
    x = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    v["pfm_cv2_colour"] = cv2_write(".pfm", x)
    v["pfm_cv2_gray"] = cv2_write(".pfm", x[:, :, 0])
    halves = (np.arange(h * w * 3).reshape(h, w, 3) % 9 + 0.5).astype(np.float32)  # ties to even
    v["pfm_halves"] = pfm(halves)
    odd = np.array([-3.0, -0.5, 0.49999997, 254.5, 255.49998, 255.5, 1e9, 2.0 ** 31, 1e10, np.inf,
                    -np.inf, np.nan, 300.0, 127.5], np.float32)
    v["pfm_out_of_range"] = pfm(np.resize(odd, (h, w, 3)))
    v["pfm_big_endian"] = pfm(x, scale=1.0)
    v["pfm_scale_3"] = pfm(x * 3, scale=-3.0)
    v["pfm_scale_0_1"] = pfm(x / 10, scale=0.1)
    v["pfm_scale_third"] = pfm(rng.random((h, w)).astype(np.float32) * 90, scale=-1 / 3)
    v["pfm_gray_big_endian"] = pfm(x[:, :, 0], scale=2.5)
    v["pfm_scale_0"] = pfm(x, scale=0.0, header=b"PF\n7 6\n0\n")
    v["pfm_scale_nan"] = pfm(x, scale=-1.0, header=b"PF\n7 6\nnan\n")
    v["pfm_scale_hex"] = pfm(x * 2, scale=1.0, header=b"PF\n7 6\n0x1p-1\n")
    v["pfm_scale_exponent"] = pfm(x, scale=-1.0, header=b"PF\n7 6\n-1e0\n")
    v["pfm_scale_inf"] = pfm(x, scale=1.0, header=b"PF\n7 6\ninf\n")
    v["pfm_width_with_letters"] = pfm(x, header=b"PF\n7px 6\n-1\n")
    v["pfm_two_spaces"] = pfm(x, header=b"PF\n7  6\n-1\n")
    v["pfm_cr_after_signature"] = pfm(x, header=b"PF\r7 6\n-1\n")
    return v


# ------------------------------------------------------------ Radiance HDR


def hdr(w, h, body, head=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", size=None):
    return head + (size or b"-Y %d +X %d\n" % (h, w)) + body


def hdr_rle(rgbe):
    """(h, w, 4) bytes -> new-style run-length scanlines: runs where a value
    repeats, literals between."""
    out = bytearray()
    h, w, _ = rgbe.shape
    for row in rgbe:
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            vals = row[:, c].tolist()
            i = 0
            while i < w:
                j = i
                while j < w and j - i < 127 and vals[j] == vals[i]:
                    j += 1
                if j - i >= 3:
                    out += bytes([128 + j - i, vals[i]])
                    i = j
                    continue
                j = i
                while j < w and j - i < 128 and not (j + 2 < w and vals[j] == vals[j + 1] == vals[j + 2]):
                    j += 1
                out += bytes([j - i]) + bytes(vals[i:j])
                i = j
    return bytes(out)


def _hdr_variants():
    v = {}
    rng = _rng("hdr")
    h, w = 6, 40
    v["hdr_cv2"] = cv2_write(".hdr", (rng.random((h, w, 3)) * 2).astype(np.float32))
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[:, :, 3] = rng.integers(120, 140, (h, w))
    rgbe[:, ::5, 3] = 0
    rgbe[2, 10:30] = rgbe[2, 10]  # runs
    v["hdr_rle"] = hdr(w, h, hdr_rle(rgbe))
    v["hdr_flat_narrow"] = hdr(5, h, rgbe[:, :5].tobytes())
    v["hdr_flat_wide"] = hdr(w, h, rgbe.tobytes())
    v["hdr_rle_then_flat"] = hdr(w, h, hdr_rle(rgbe[:2]) + rgbe[2:].tobytes())
    wide = rgbe.copy()
    wide[:, :, 3] = rng.integers(0, 256, (h, w))
    v["hdr_every_exponent"] = hdr(w, h, hdr_rle(wide))
    v["hdr_rgbe_signature"] = hdr(w, h, hdr_rle(rgbe), head=b"#?RGBE\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe\n\n")
    v["hdr_other_lines"] = hdr(w, h, hdr_rle(rgbe),
                                head=b"#?RADIANCE\n# made by hand\nGAMMA=2.2\nFORMAT=32-bit_rle_rgbe\n\n")
    v["hdr_spaced_size"] = hdr(w, h, hdr_rle(rgbe), size=b"-Y   %d    +X%d\n" % (h, w))
    v["hdr_plus_y"] = hdr(w, h, hdr_rle(rgbe), size=b"+Y %d +X %d\n" % (h, w))
    v["hdr_xyze"] = hdr(w, h, hdr_rle(rgbe), head=b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n")
    v["hdr_no_blank_line"] = hdr(w, h, hdr_rle(rgbe), head=b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n")
    v["hdr_line_of_a_nul"] = hdr(w, h, hdr_rle(rgbe), head=b"#?RADIANCE\n\0abc\nFORMAT=32-bit_rle_rgbe\n\n")
    v["hdr_empty_line_first"] = hdr(w, h, hdr_rle(rgbe), head=b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n")
    v["hdr_wrong_scanline_width"] = hdr(w, h, bytes([2, 2, 0, w + 1]) + hdr_rle(rgbe)[4:])
    v["hdr_huge_frame"] = hdr(30000, 30000, hdr_rle(rgbe))
    return v


# ------------------------------------------------------------ GIF


def _lzw(indices, min_size):
    """GIF LZW: a clear code first, a clear code when the table is full,
    the end code last."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    size, table, nxt = min_size + 1, {}, end + 1
    emit(clear, size)
    cur = None
    for k in map(int, indices):
        if cur is None:
            cur = (k,)
            continue
        if cur + (k,) in table:
            cur += (k,)
            continue
        emit(table[cur] if len(cur) > 1 else cur[0], size)
        if nxt < 4096:
            table[cur + (k,)] = nxt
            nxt += 1
            if nxt - 1 == 1 << size and size < 12:
                size += 1
        else:
            emit(clear, size)
            size, table, nxt = min_size + 1, {}, end + 1
        cur = (k,)
    emit(table[cur] if len(cur) > 1 else cur[0], size)
    emit(end, size)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data, size=255):
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def _table(colours):
    n = max(2, 1 << (len(colours) - 1).bit_length())
    t = np.zeros((n, 3), np.uint8)
    t[:len(colours)] = colours
    return n.bit_length() - 2, t.tobytes()


def gif(screen, frames, colours=None, background=0, version=b"89a", block=255, extensions=b""):
    """frames: dicts of index (h, w), left, top, min_size, colours (local),
    interlace, transparent, disposal, codes (raw LZW bytes); ``extensions``
    go before the first frame."""
    flags, gct = 0x70, b""
    if colours is not None:
        bits, gct = _table(colours)
        flags |= 0x80 | bits
    out = (b"GIF" + version + struct.pack("<HHBBB", screen[1], screen[0], flags, background, 0) + gct
           + extensions)
    for f in frames:
        if f.get("transparent") is not None or f.get("disposal"):
            packed = f.get("disposal", 0) << 2 | (f.get("transparent") is not None)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, 0, f.get("transparent") or 0) + b"\0"
        index = np.asarray(f["index"])
        h, w = index.shape
        frame_flags, lct = 0, b""
        if f.get("colours") is not None:
            bits, lct = _table(f["colours"])
            frame_flags |= 0x80 | bits
        rows = index
        if f.get("interlace"):
            frame_flags |= 0x40
            rows = index[np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                         np.arange(1, h, 2)])]
        size = f.get("min_size", 8)
        codes = f.get("codes") or _lzw(rows.reshape(-1), size)
        out += (b"\x2c" + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0), w, h, frame_flags)
                + lct + bytes([size]) + sub_blocks(codes, block))
    return out + b"\x3b"


def _gif_variants():
    v = {}
    rng = _rng("gif")
    h, w = 10, 13
    colours = rng.integers(0, 256, (256, 3))
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    v["gif_cv2"] = cv2_write(".gif", rgb)
    if Image:
        v["gif_pil_interlaced"] = pil_write(rgb, "GIF", interlace=True)
        v["gif_pil_gray"] = pil_write(rgb[:, :, 0], "GIF")
    for size in range(2, 9):
        v[f"gif_code_size_{size}"] = gif((h, w), [dict(index=rng.integers(0, 1 << size, (h, w)),
                                                        min_size=size)], colours[:1 << size])
    v["gif_87a_local_table"] = gif((h, w), [dict(index=rng.integers(0, 8, (h, w)), min_size=3,
                                                  colours=colours[100:108])], version=b"87a")
    v["gif_no_global_table"] = gif((h, w), [dict(index=rng.integers(0, 8, (h, w - 3)), min_size=3, left=2,
                                                  colours=colours[:8])])
    v["gif_no_table"] = gif((h, w), [dict(index=rng.integers(0, 256, (h, w)), min_size=8)])
    for height in (1, 2, 3, 5, 9, 17):
        v[f"gif_interlaced_{height}_rows"] = gif((height, w), [dict(index=rng.integers(0, 16, (height, w)),
                                                                     min_size=4, interlace=True)],
                                                  colours[:16])
    v["gif_transparent_frame_in_screen"] = gif((h + 5, w + 4), [dict(
        index=rng.integers(0, 16, (h, w)), min_size=4, left=3, top=2, transparent=5, colours=colours[16:32])],
        colours[:16], background=9)
    v["gif_transparent_past_table"] = gif((h, w), [dict(index=rng.integers(0, 4, (h, w)), min_size=3,
                                                         transparent=7)], colours[:4])
    v["gif_index_past_table"] = gif((h, w), [dict(index=rng.integers(0, 8, (h, w)), min_size=3)], colours[:4])
    v["gif_background_past_table"] = gif((h, w), [dict(index=rng.integers(0, 4, (h, w)), min_size=2)],
                                          colours[:4], background=4)
    v["gif_two_frames"] = gif((h, w), [dict(index=rng.integers(0, 16, (h, w)), min_size=4, disposal=2),
                                        dict(index=rng.integers(0, 16, (3, 4)), min_size=4, transparent=1)],
                               colours[:16])
    v["gif_disposal_4"] = gif((h, w), [dict(index=rng.integers(0, 16, (h, w)), min_size=4, disposal=4)],
                               colours[:16])
    v["gif_frame_off_screen"] = gif((h, w), [dict(index=rng.integers(0, 16, (h, w)), min_size=4, left=1)],
                                     colours[:16])
    v["gif_one_byte_blocks"] = gif((h, w), [dict(index=rng.integers(0, 16, (h, w)), min_size=4)],
                                    colours[:16], block=1)
    apps = (b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00" + b"\x21\xff\x0bXMP DataXMP\x05<xmp>\x00"
            + b"\x21\xfe\x03abc\x00")
    v["gif_application_extensions"] = gif((h, w), [dict(index=rng.integers(0, 16, (h, w)), min_size=4)],
                                          colours[:16], extensions=apps)
    v["gif_application_block_of_3"] = gif((h, w), [dict(index=rng.integers(0, 16, (h, w)), min_size=4)],
                                          colours[:16], extensions=b"\x21\xff\x0bABCDEFGHIJK\x03abc\x00")
    v["gif_table_full"] = gif((60, 90), [dict(index=rng.integers(0, 256, (60, 90)), min_size=8)], colours)
    big = rng.integers(0, 256, (2, 3000))
    v["gif_deferred_clear"] = gif((2, 3000), [dict(index=big, min_size=8, codes=literal_codes(big.ravel()))],
                                   colours)
    return v


def literal_codes(indices):
    """Every index as a literal 8-bit-size code, no clear code after the
    first: the table fills and the width stays at 12 bits."""
    out, acc, nbits, size, tsize = bytearray(), 256, 9, 9, 257
    for k in map(int, indices):
        acc |= k << nbits
        nbits += size
        tsize += 1
        if tsize == 1 << size and size < 12:
            size += 1
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    acc |= 257 << nbits
    nbits += size
    while nbits > 0:
        out.append(acc & 255)
        acc >>= 8
        nbits -= 8
    return bytes(out)


def variants() -> dict:
    """{name: file bytes} of every variant, deterministic."""
    return {**_bmp_variants(), **_pnm_variants(), **_pam_variants(), **_ras_variants(),
            **_pfm_variants(), **_hdr_variants(), **_gif_variants()}


# the files whose every cut and seeded byte change is read against cv2.imread
DAMAGED = ("bmp_rle8", "bmp_rle4", "bmp_8bit", "bmp_16bit_565_bitfields", "bmp_cv2_24bit",
           "pnm_cv2_ppm", "pnm_p3_maxval_1000", "pnm_cv2_pbm", "pam_cv2_rgb", "pam_rgb_maxval_4000",
           "ras_8bit_map", "ras_cv2_24bit", "pfm_cv2_colour", "pfm_gray_big_endian", "hdr_rle",
           "hdr_flat_narrow", "gif_transparent_frame_in_screen", "gif_interlaced_17_rows",
           "gif_code_size_2", "gif_application_extensions")


# ------------------------------------------------------------ TIFF

_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q",
               17: "q"}
BYTE, ASCII, SHORT, LONG, RATIONAL, UNDEFINED, LONG8 = 1, 2, 3, 4, 5, 7, 16


def packbits(data):
    """PackBits: runs of 2-128 equal bytes, literal runs of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        out += bytes([j - i - 1]) + bytes(data[i:j])
        i = j
    return bytes(out)


def tiff_lzw(data, old_style=False):
    """TIFF LZW as libtiff writes it: a clear code first, codes MSB first
    whose width grows one code early, a clear code when the table reaches
    4094, the end code last. ``old_style``: the LSB-first codes without the
    early change that libtiff still reads (LZWDecodeCompat)."""
    out, acc, nbits = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nbits
        if old_style:
            acc |= code << nbits
            nbits += size
            while nbits >= 8:
                out.append(acc & 255)
                acc >>= 8
                nbits -= 8
        else:
            acc = (acc << size) | code
            nbits += size
            while nbits >= 8:
                out.append((acc >> (nbits - 8)) & 255)
                nbits -= 8
            acc &= (1 << nbits) - 1

    def grow(size, nxt):
        return size + 1 if (nxt if old_style else nxt + 1) > (1 << size) and size < 12 else size

    size, table, nxt, cur = 9, {}, 258, None
    emit(256, size)
    for k in data:
        if cur is None:
            cur = bytes([k])
        elif cur + bytes([k]) in table:
            cur += bytes([k])
        else:
            emit(table[cur] if len(cur) > 1 else cur[0], size)
            table[cur + bytes([k])] = nxt
            nxt += 1
            size = grow(size, nxt)
            if nxt >= 4094:
                emit(256, size)
                size, table, nxt = 9, {}, 258
            cur = bytes([k])
    if cur is not None:
        emit(table[cur] if len(cur) > 1 else cur[0], size)
        size = grow(size, nxt + 1)
    emit(257, size)
    if nbits:
        out.append(acc & 255 if old_style else (acc << (8 - nbits)) & 255)
    return bytes(out)


def _tiff_rows(samples, bits, order):
    """(h, w, c) samples -> rows of bytes (h, row bytes), each row padded to
    a byte."""
    h, w, c = samples.shape
    if bits in (16, 32):
        return samples.astype(f"{order}u{bits // 8}").view(np.uint8).reshape(h, -1)
    if bits == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    per = 8 // bits
    v = samples.reshape(h, w * c).astype(np.int64)
    v = np.concatenate([v, np.zeros((h, -v.shape[1] % per), np.int64)], 1).reshape(h, -1, per)
    return (v << ((8 - bits) - bits * np.arange(per))).sum(2).astype(np.uint8)


def _tiff_code(raw, compression):
    if compression == 5:
        return tiff_lzw(raw)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return packbits(raw)
    return raw


def tiff(samples, photometric, bits=8, compression=1, predictor=None, planar=1, tile=None, rows=None,
         order="<", big=False, tags=None, drop=(), offsets_type=None, counts_type=None, encode=None,
         ifd_first=False, second_page=False):
    """A TIFF of ``samples`` ((h, w) or (h, w, c) integers): strips of
    ``rows`` rows (one strip by default) or ``tile`` (height, width) tiles,
    planar 1 or 2, in byte order ``order``, classic or BigTIFF, the IFD after
    the data or (``ifd_first``) before it. ``encode`` codes each strip's
    bytes (the compression's coder by default); ``tags`` {tag: (type,
    values)} are added or replace the writer's, ``drop`` removes tags;
    ``second_page`` adds a second directory (a different image) after the
    first."""
    s = np.asarray(samples)
    s = s[:, :, None] if s.ndim == 2 else s
    h, w, c = s.shape
    if predictor == 2:
        d = s.astype(np.int64)
        d[:, 1:] = s[:, 1:].astype(np.int64) - s[:, :-1].astype(np.int64)
        s = d & ((1 << bits) - 1)
    chunks = []
    for p in [s] if planar == 1 else [s[:, :, i:i + 1] for i in range(c)]:
        if tile:
            th, tw = tile
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, p.shape[2]), p.dtype)
                    part = p[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(_tiff_rows(t, bits, order).tobytes())
        else:
            for y in range(0, h, rows or h):
                chunks.append(_tiff_rows(p[y:y + (rows or h)], bits, order).tobytes())
    chunks = [(encode or (lambda raw: _tiff_code(raw, compression)))(ch) for ch in chunks]
    ot, ct = offsets_type or (LONG8 if big else LONG), counts_type or (LONG8 if big else LONG)
    entries = {256: (LONG, [w]), 257: (LONG, [h]), 258: (SHORT, [bits] * c), 259: (SHORT, [compression]),
               262: (SHORT, [photometric]), 277: (SHORT, [c])}
    if planar != 1:
        entries[284] = (SHORT, [planar])
    if predictor:
        entries[317] = (SHORT, [predictor])
    keys = (324, 325) if tile else (273, 279)
    if tile:
        entries[322], entries[323] = (LONG, [tile[1]]), (LONG, [tile[0]])
    elif rows:
        entries[278] = (LONG, [rows])
    entries[keys[0]] = (ot, [0] * len(chunks))
    entries[keys[1]] = (ct, [len(x) for x in chunks])
    entries.update(tags or {})
    for tag in drop:
        entries.pop(tag, None)
    return tiff_layout(entries, chunks, keys[0] if keys[0] in entries else None, order, big, ifd_first,
                       second_page)


def tiff_layout(entries, chunks, offsets_tag, order="<", big=False, ifd_first=False, second_page=False):
    """The file: header, the strips (2-byte aligned) and one IFD (sorted
    entries, values past 4 or 8 bytes after it); the strips' offsets are
    written into ``offsets_tag``'s entry."""
    e, head, inline = order, 16 if big else 8, 8 if big else 4

    def ifd_bytes(at, entries):
        size = (8 if big else 2) + len(entries) * (20 if big else 12) + inline
        ifd, extra = bytearray(struct.pack(e + ("Q" if big else "H"), len(entries))), bytearray()
        for tag in sorted(entries):
            typ, vals = entries[tag]
            if typ in (ASCII, UNDEFINED) and not isinstance(vals, list):
                raw = bytes(vals)
            elif typ == RATIONAL:
                raw = b"".join(struct.pack(e + "II", *pair) for pair in vals)
            else:
                raw = struct.pack(f"{e}{len(vals)}{_TIFF_TYPES[typ]}", *vals)
            count = len(vals)
            if len(raw) <= inline:
                value = raw + bytes(inline - len(raw))
            else:
                value = struct.pack(e + ("Q" if big else "I"), at + size + len(extra))
                extra += raw + bytes(len(raw) % 2)
            ifd += struct.pack(e + ("HHQ" if big else "HHI"), tag, typ, count) + value
        return ifd + bytes(inline), extra

    def place(at):
        blob, offs = bytearray(), []
        for ch in chunks:
            offs.append(at + len(blob))
            blob += ch + bytes(len(ch) % 2)
        return blob, offs

    if ifd_first:
        ifd, extra = ifd_bytes(head, entries)
        blob, offs = place(head + len(ifd) + len(extra))
    else:
        blob, offs = place(head)
    if offsets_tag is not None:
        typ, _ = entries[offsets_tag]
        entries = {**entries, offsets_tag: (typ, offs)}
    ifd_at = head if ifd_first else head + len(blob)
    ifd, extra = ifd_bytes(ifd_at, entries)
    if second_page:  # a second directory after the first: another width, the same strips
        page2_at = ifd_at + len(ifd) + len(extra)
        ifd[-inline:] = struct.pack(e + ("Q" if big else "I"), page2_at)
        other = {**entries, 256: (LONG, [entries[256][1][0] // 2 or 1])}
        extra += b"".join(ifd_bytes(page2_at, other))
    sig = (b"II" if e == "<" else b"MM")
    header = sig + (struct.pack(e + "HHHQ", 43, 8, 0, ifd_at) if big else struct.pack(e + "HI", 42, ifd_at))
    body = ifd + extra + blob if ifd_first else blob + ifd + extra
    return header + bytes(body)


def tiff_jpeg_strips(bgr, rows, sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, quality=85,
                     photometric=6):
    """A JPEG-compressed TIFF whose strips are whole JPEG files written by
    cv2.imencode (no JPEGTables): YCbCr with its subsampling tag, or RGB
    (``photometric`` 2, read without colour conversion)."""
    sub = {cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420: (2, 2), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422: (2, 1),
           cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444: (1, 1)}[sampling]

    def encode(raw):
        strip = np.frombuffer(raw, np.uint8).reshape(-1, bgr.shape[1], 3)
        return cv2_write(".jpg", strip[:, :, ::-1], cv2.IMWRITE_JPEG_QUALITY, quality,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling)

    tags = {530: (SHORT, list(sub))} if photometric == 6 else {}
    return tiff(bgr[:, :, ::-1], photometric, compression=7, rows=rows, encode=encode, tags=tags)


def _scene(h, w, rng):
    """Gradients, edges and noise, (h, w, 3) in 0..255."""
    y, x = np.mgrid[:h, :w]
    img = np.stack([(x * 9 + y * 3) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.int64)


def _tiff_variants_built():
    v = {}
    rng = _rng("tiff")
    h, w = 13, 21
    rgb = _scene(h, w, rng)
    gray = rgb[:, :, 1]
    alpha = rng.integers(0, 256, (h, w, 1))
    wide = rgb.astype(np.int64) * 257 + rng.integers(0, 257, rgb.shape)  # 16-bit
    names = {1: "none", 5: "lzw", 8: "deflate", 32946: "adobe_deflate", 32773: "packbits"}
    for comp, name in names.items():
        v[f"tiff_{name}_strips"] = tiff(rgb, 2, compression=comp, rows=5)
        v[f"tiff_{name}_one_strip_mm"] = tiff(rgb, 2, compression=comp, order=">")
        v[f"tiff_{name}_tiles"] = tiff(rgb, 2, compression=comp, tile=(16, 16))
        v[f"tiff_{name}_tiles_mm_gray16"] = tiff(wide[:, :, 0], 1, bits=16, compression=comp, tile=(16, 16),
                                                 order=">")
        v[f"tiff_{name}_planar"] = tiff(rgb, 2, compression=comp, planar=2, rows=6)
    for comp in (5, 8):
        for order in "<>":
            v[f"tiff_{names[comp]}_predictor_{order == '<' and 'ii' or 'mm'}"] = tiff(
                rgb, 2, compression=comp, predictor=2, rows=4, order=order)
            v[f"tiff_{names[comp]}_predictor_16bit_{order == '<' and 'ii' or 'mm'}"] = tiff(
                wide, 2, bits=16, compression=comp, predictor=2, tile=(16, 16), order=order)
        v[f"tiff_{names[comp]}_predictor_planar"] = tiff(rgb, 2, compression=comp, predictor=2, planar=2)
        v[f"tiff_{names[comp]}_predictor_4bit"] = tiff(gray >> 4, 3, bits=4, compression=comp, predictor=2,
                                                        tags={320: (SHORT, list(range(0, 65536, 1366))[:48])})
        v[f"tiff_{names[comp]}_predictor_3"] = tiff(rgb, 2, compression=comp, predictor=3)
    v["tiff_lzw_old_style"] = tiff(rgb, 2, compression=5, rows=7, encode=lambda raw: tiff_lzw(raw, True))
    v["tiff_lzw_old_style_gray_predictor"] = tiff(gray, 1, compression=5, predictor=2,
                                                  encode=lambda raw: tiff_lzw(raw, True))
    v["tiff_lzw_long_strip"] = tiff(np.tile(rgb, (8, 10, 1)), 2, compression=5)  # the table fills
    # the photometric kinds
    for bits in (1, 2, 4, 8, 16):
        top = (1 << bits) - 1
        v[f"tiff_gray_{bits}bit"] = tiff(gray * top // 255 if bits < 16 else wide[:, :, 1], 1, bits=bits,
                                         compression=5, rows=6)
        v[f"tiff_min_is_white_{bits}bit"] = tiff(gray * top // 255 if bits < 16 else wide[:, :, 2], 0,
                                                 bits=bits, compression=32773)
    for bits in (1, 2, 4, 8, 16):
        n = 1 << bits
        cmap16 = rng.integers(0, 65536, 3 * n)
        cmap8 = rng.integers(0, 256, 3 * n)
        index = rng.integers(0, n, (h, w))
        v[f"tiff_palette_{bits}bit"] = tiff(index, 3, bits=bits, compression=5, tags={320: (SHORT, list(cmap16))})
        if bits <= 8:
            v[f"tiff_palette_{bits}bit_8bit_map"] = tiff(index, 3, bits=bits, compression=8,
                                                         tags={320: (SHORT, list(cmap8))})
    v["tiff_palette_no_map"] = tiff(gray, 3, compression=5)
    v["tiff_palette_1bit_no_map"] = tiff(gray & 1, 3, bits=1)
    v["tiff_rgb_16bit"] = tiff(wide, 2, bits=16, compression=8, rows=4)
    v["tiff_rgb_16bit_mm"] = tiff(wide, 2, bits=16, order=">")
    for extra, name in ((None, "no_extra_samples"), (0, "unspecified"), (1, "associated"), (2, "unassociated")):
        tags = None if extra is None else {338: (SHORT, [extra])}
        v[f"tiff_rgba_{name}"] = tiff(np.concatenate([rgb, alpha], 2), 2, compression=5, tags=tags)
        v[f"tiff_rgba_16bit_{name}"] = tiff(np.concatenate([wide, alpha * 257], 2), 2, bits=16, tags=tags)
        v[f"tiff_rgba_planar_{name}"] = tiff(np.concatenate([rgb, alpha], 2), 2, planar=2, tags=tags)
    v["tiff_gray_alpha"] = tiff(np.concatenate([gray[:, :, None], alpha], 2), 1, tags={338: (SHORT, [2])})
    v["tiff_gray_alpha_planar"] = tiff(np.concatenate([gray[:, :, None], alpha], 2), 1, planar=2,
                                       tags={338: (SHORT, [2])})
    v["tiff_gray_alpha_16bit_tiles"] = tiff(np.concatenate([wide[:, :, :1], alpha * 257], 2), 1, bits=16,
                                            tile=(16, 16), tags={338: (SHORT, [1])})
    v["tiff_gray_16bit_planar_alpha"] = tiff(np.concatenate([wide[:, :, :1], alpha * 257], 2), 1, bits=16,
                                             planar=2, tags={338: (SHORT, [2])})
    v["tiff_rgb_extra_sample_count_5"] = tiff(np.concatenate([rgb, alpha, alpha], 2), 2,
                                              tags={338: (SHORT, [2, 0])})
    v["tiff_rgb_two_samples"] = tiff(rgb[:, :, :2], 2)
    cmyk = np.concatenate([rgb, alpha], 2)
    v["tiff_cmyk"] = tiff(cmyk, 5, compression=5, rows=5)
    v["tiff_cmyk_planar"] = tiff(cmyk, 5, planar=2)
    v["tiff_cmyk_inkset_2"] = tiff(cmyk, 5, tags={332: (SHORT, [2])})
    v["tiff_cmyk_three_samples"] = tiff(rgb, 5)
    v["tiff_cmyk_16bit"] = tiff(cmyk * 257, 5, bits=16)
    # sample formats and depths libtiff's RGBA reader refuses
    v["tiff_float32"] = tiff(rgb.astype(np.float32).view(np.uint32), 2, bits=32, tags={339: (SHORT, [3] * 3)})
    v["tiff_uint32"] = tiff(rgb, 2, bits=32)
    v["tiff_int8"] = tiff(gray, 1, tags={339: (SHORT, [2])})
    v["tiff_void8"] = tiff(gray, 1, tags={339: (SHORT, [4])})
    v["tiff_sample_format_7"] = tiff(gray, 1, tags={339: (SHORT, [7])})
    v["tiff_12bit"] = tiff(gray, 1, tags={258: (SHORT, [12])})
    v["tiff_bits_per_sample_differ"] = tiff(rgb, 2, tags={258: (SHORT, [8, 8, 16])})
    v["tiff_photometric_4"] = tiff(gray, 4)
    v["tiff_no_photometric"] = tiff(rgb, 2, drop=(262,))
    v["tiff_no_bits_per_sample"] = tiff(gray & 1, 1, bits=1, drop=(258,))
    # YCbCr without JPEG: packed blocks of h x v Y samples, then Cb and Cr
    ycc = rng.integers(0, 256, 4096)
    for h_, v_ in ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (1, 2), (4, 1), (1, 4), (3, 2)):
        v[f"tiff_ycbcr_{h_}{v_}"] = tiff(rgb, 6, rows=8 if v_ != 3 else None, tags={530: (SHORT, [h_, v_])},
                                        encode=lambda raw: bytes(ycc[:len(raw)].astype(np.uint8)))
    v["tiff_ycbcr_44_tiles_lzw"] = tiff(rgb, 6, compression=5, tile=(16, 16), tags={530: (SHORT, [4, 4])})
    v["tiff_ycbcr_22_tiles"] = tiff(rgb, 6, tile=(16, 16), tags={530: (SHORT, [2, 2])})
    v["tiff_ycbcr_coefficients"] = tiff(rgb, 6, compression=8, tags={
        530: (SHORT, [1, 1]), 529: (RATIONAL, [(2126, 10000), (7152, 10000), (722, 10000)]),
        532: (RATIONAL, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])})
    v["tiff_ycbcr_planar"] = tiff(rgb, 6, planar=2, tags={530: (SHORT, [1, 1])})
    # the orientations, strips and tiles (libtiff mirrors inside each tile)
    for o in range(1, 9):
        v[f"tiff_orientation_{o}"] = tiff(rgb, 2, rows=4, tags={274: (SHORT, [o])})
        v[f"tiff_orientation_{o}_tiles"] = tiff(rgb, 2, compression=5, tile=(16, 16), tags={274: (SHORT, [o])})
    v["tiff_orientation_9"] = tiff(rgb, 2, tags={274: (SHORT, [9])})
    # the container
    for order in "<>":
        o = "ii" if order == "<" else "mm"
        v[f"tiff_bigtiff_{o}"] = tiff(rgb, 2, compression=5, big=True, order=order, rows=5)
        v[f"tiff_bigtiff_{o}_tiles_16bit"] = tiff(wide, 2, bits=16, compression=8, big=True, order=order,
                                                  tile=(16, 32), predictor=2)
    v["tiff_bigtiff_long_offsets"] = tiff(rgb, 2, big=True, offsets_type=LONG, counts_type=SHORT)
    v["tiff_offsets_short"] = tiff(rgb, 2, rows=5, offsets_type=SHORT, counts_type=SHORT)
    v["tiff_offsets_ascii"] = tiff(rgb, 2, offsets_type=ASCII)
    v["tiff_rows_per_strip_past_height"] = tiff(rgb, 2, compression=5, tags={278: (LONG, [1000])})
    v["tiff_rows_per_strip_zero"] = tiff(rgb, 2, tags={278: (LONG, [0])})
    v["tiff_no_byte_counts"] = tiff(rgb, 2, drop=(279,))
    v["tiff_no_byte_counts_lzw"] = tiff(rgb, 2, compression=5, drop=(279,))
    v["tiff_no_byte_counts_strips"] = tiff(rgb, 2, rows=5, drop=(279,))
    v["tiff_byte_count_short"] = tiff(rgb, 2, tags={279: (LONG, [100])})
    v["tiff_byte_count_zero_lzw"] = tiff(rgb, 2, compression=5, tags={279: (LONG, [0])})
    v["tiff_byte_counts_unequal"] = tiff(rgb, 2, rows=3, tags={279: (LONG, [189, 100, 189, 189, 63])})
    v["tiff_big_uncompressed_strip"] = tiff(np.tile(rgb, (12, 8, 1)), 2)
    v["tiff_big_uncompressed_strip_rows_past_limit"] = tiff(rgb, 2, tags={278: (LONG, [14417924])})
    v["tiff_no_offsets"] = tiff(rgb, 2, drop=(273,))
    v["tiff_no_width"] = tiff(rgb, 2, drop=(256,))
    v["tiff_planar_3"] = tiff(rgb, 2, tags={284: (SHORT, [3])})
    v["tiff_ifd_first"] = tiff(rgb, 2, compression=5, rows=4, ifd_first=True)
    v["tiff_two_pages"] = tiff(rgb, 2, compression=8, second_page=True)
    v["tiff_fill_order_2"] = tiff(rgb, 2, compression=5, encode=lambda raw: bytes(
        int(f"{b:08b}"[::-1], 2) for b in tiff_lzw(raw)), tags={266: (SHORT, [2])})
    v["tiff_tile_width_8"] = tiff(gray, 1, tile=(16, 8))
    v["tiff_tiles_gray_alpha_clipped"] = tiff(np.concatenate([gray[:, :, None], alpha], 2), 1, tile=(16, 16),
                                              compression=32773)
    v["tiff_tiles_palette_1bit"] = tiff(gray & 1, 3, bits=1, tile=(16, 16), tags={320: (SHORT, [0, 65535] * 3)})
    # compressions: not configured in OpenCV's libtiff, and unknown
    for comp, name in ((50000, "zstd"), (34925, "lzma"), (50001, "webp"), (12345, "unknown")):
        v[f"tiff_compression_{name}"] = tiff(gray, 1, compression=comp)
    v["tiff_compression_unknown_min_is_white"] = tiff(gray, 0, compression=12345)
    # JPEG strips (whole JPEG files, no JPEGTables)
    bgr = rgb[:, :, ::-1].astype(np.uint8)
    big = np.tile(bgr, (3, 2, 1))
    v["tiff_jpeg_ycbcr_420"] = tiff_jpeg_strips(big, 16)
    v["tiff_jpeg_ycbcr_422"] = tiff_jpeg_strips(big, 8, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    v["tiff_jpeg_ycbcr_444_one_strip"] = tiff_jpeg_strips(big, None, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    v["tiff_jpeg_rgb_444"] = tiff_jpeg_strips(big, 8, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, photometric=2)
    v["tiff_jpeg_subsampling_tag_wrong"] = tiff_jpeg_strips(big, 16).replace(
        struct.pack("<HHIHH", 530, SHORT, 2, 2, 2), struct.pack("<HHIHH", 530, SHORT, 2, 2, 1))
    v["tiff_jpeg_no_subsampling_tag"] = tiff(big[:, :, ::-1], 6, compression=7, rows=16, encode=lambda raw: cv2_write(
        ".jpg", np.frombuffer(raw, np.uint8).reshape(-1, big.shape[1], 3)[:, :, ::-1]))
    v["tiff_jpeg_gray"] = tiff(big[:, :, 1], 1, compression=7, rows=8, encode=lambda raw: cv2_write(
        ".jpg", np.frombuffer(raw, np.uint8).reshape(-1, big.shape[1])))
    v["tiff_jpeg_min_is_white"] = tiff(big[:, :, 1], 0, compression=7, encode=lambda raw: cv2_write(
        ".jpg", np.frombuffer(raw, np.uint8).reshape(-1, big.shape[1])))
    return v


def _tiff_variants_written():
    v = {}
    rng = _rng("tiff written")
    rgb = _scene(37, 53, rng).astype(np.uint8)
    for comp, name in ((1, "none"), (5, "lzw"), (8, "deflate"), (32773, "packbits"), (32946, "adobe_deflate"),
                       (7, "jpeg")):
        v[f"tiff_cv2_{name}"] = cv2_write(".tiff", rgb, cv2.IMWRITE_TIFF_COMPRESSION, comp)
        v[f"tiff_cv2_{name}_gray"] = cv2_write(".tiff", rgb[:, :, 0], cv2.IMWRITE_TIFF_COMPRESSION, comp)
    v["tiff_cv2_default"] = cv2_write(".tiff", rgb)
    v["tiff_cv2_16bit"] = cv2_write(".tiff", rgb.astype(np.uint16) * 257)
    v["tiff_cv2_bgra"] = cv2_write(".tiff", np.concatenate([rgb, rgb[:, :, :1]], 2))
    v["tiff_ccitt_8bit"] = tiff(rgb[:, :, 0], 1, compression=4, encode=bytes)
    if Image:
        for comp in ("raw", "tiff_lzw", "tiff_deflate", "packbits", "tiff_adobe_deflate"):
            for mode in ("RGB", "L", "1", "P", "RGBA", "CMYK", "I;16", "LA", "YCbCr"):
                v[f"tiff_pil_{comp}_{mode.replace(';', '_')}"] = pil_write(rgb, "TIFF", mode, compression=comp)
        for quality, sampling in ((50, 0), (95, 1), (75, 2)):
            v[f"tiff_pil_jpeg_q{quality}_ss{sampling}"] = pil_write(rgb, "TIFF", compression="jpeg",
                                                                     quality=quality, subsampling=sampling)
        v["tiff_pil_jpeg_gray"] = pil_write(rgb, "TIFF", "L", compression="jpeg")
        v["tiff_pil_lzw_predictor"] = pil_write(rgb, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
        v["tiff_pil_orientation_3"] = pil_write(rgb, "TIFF", compression="tiff_lzw", tiffinfo={274: 3})
    return v


def tiff_variants() -> dict:
    """{name: TIFF file bytes} of every TIFF variant, deterministic."""
    return {**_tiff_variants_built(), **_tiff_variants_written()}


def tiff_damaged() -> dict:
    """Small files of the kinds the damage tests cut and change (a few
    hundred bytes each, so that every cut is read): LZW strips, Deflate
    tiles with the predictor, PackBits, JPEG strips, a palette, BigTIFF; the
    directory first in some, so that cuts fall in the strips."""
    rng = _rng("tiff damaged")
    rgb = _scene(10, 14, rng)
    cmap = rng.integers(0, 65536, 48)
    bgr = _scene(16, 16, rng)[:, :, ::-1].astype(np.uint8)
    return {
        "tiff_damaged_lzw_strips": tiff(rgb, 2, compression=5, rows=4, ifd_first=True),
        "tiff_damaged_deflate_tiles_predictor": tiff(rgb, 2, compression=8, tile=(16, 16), predictor=2),
        "tiff_damaged_packbits_gray": tiff(rgb[:, :, 1], 1, compression=32773, rows=3, ifd_first=True),
        "tiff_damaged_jpeg": tiff_jpeg_strips(bgr, 8, quality=60),
        "tiff_damaged_palette": tiff(rgb[:, :, 0] >> 4, 3, bits=4, compression=5, tags={320: (SHORT, list(cmap))}),
        "tiff_damaged_bigtiff": tiff(rgb, 2, compression=32946, big=True, order=">", rows=5, ifd_first=True),
    }


TIFF_DAMAGED = ("tiff_damaged_lzw_strips", "tiff_damaged_deflate_tiles_predictor",
                "tiff_damaged_packbits_gray", "tiff_damaged_jpeg", "tiff_damaged_palette",
                "tiff_damaged_bigtiff")


def tiff_left_out() -> dict:
    """{name: (file bytes, the words the port's refusal names it by)}: TIFF
    kinds that cv2.imread reads and the port leaves out (CIELab built here;
    PIL writes the CCITT ones, left out without PIL)."""
    rgb = _scene(24, 40, _rng("tiff left out")).astype(np.uint8)
    out = {"tiff_cielab": (tiff(rgb, 8), "CIELab")}
    if Image is None:
        return out
    for comp, words in (("group4", "CCITT Group 4"), ("group3", "CCITT Group 3"), ("tiff_ccitt", "CCITT RLE")):
        out[f"tiff_{comp}"] = (pil_write(rgb, "TIFF", "1", compression=comp), words)
    return out
