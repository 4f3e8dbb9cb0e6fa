"""ctypes loaders for the native host kernels: the event kernels
(``frn_tpu_torch/native/voxelize.cpp``), the JPEG decoder
(``frn_tpu_torch/native/jpeg.cpp``), the run-length and LZW decoders of
BMP, Radiance HDR and GIF (``frn_tpu_torch/native/codecs.cpp``) and TIFF's
LZW, Deflate and PackBits decoders (``frn_tpu_torch/native/tiff.cpp``).

The event kernels are the counterpart of ``frn_tpu/utils/native.py``, over the
port's own copy of the C++ source; the image decoders stand in for the OpenCV
that the JAX package reads images with. Each shared library is built on first
use with g++ (a plain C ABI bound by ctypes, no binding library) into
``frn_tpu_torch/_build/lib<name>-<hash>.so``, where the hash covers the
source and the flags, so an edited source is rebuilt and a stale library
never loads. Each build writes a temporary file and renames it into place,
so processes that reach the first use at once never load a half-written
library. The event entry points return None where the library is
unavailable (no g++, or ``FRN_DISABLE_NATIVE`` set), and callers take their
numpy path; ``jpeg_lib``, ``codecs_lib`` and ``tiff_lib`` raise RuntimeError naming the
cause instead, since no other path gives the same pixels. These are host
kernels: they run on the CPU beside the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "voxelize.cpp"
JPEG_SOURCE = Path(__file__).resolve().parents[1] / "native" / "jpeg.cpp"
CODECS_SOURCE = Path(__file__).resolve().parents[1] / "native" / "codecs.cpp"
TIFF_SOURCE = Path(__file__).resolve().parents[1] / "native" / "tiff.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False
_jpeg_lib = None
_jpeg_error = None  # why the JPEG library is unavailable, once a load failed
_codecs_lib = None
_codecs_error = None  # the same for the run-length and LZW decoders
_tiff_lib = None
_tiff_error = None  # the same for TIFF's strip decoders


def _path(source: Path, name: str) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(source: Path, name: str) -> Path:
    lib = _path(source, name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {source.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exit {proc.returncode} building {source.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def library_path() -> Path:
    return _path(SOURCE, "frn_native")


def build() -> Path:
    """Compile the event library if it is missing; returns its path. Raises
    RuntimeError with g++'s own message if the build fails."""
    return _build(SOURCE, "frn_native")


def jpeg_library_path() -> Path:
    return _path(JPEG_SOURCE, "frn_jpeg")


def build_jpeg() -> Path:
    """The same for the JPEG decoder."""
    return _build(JPEG_SOURCE, "frn_jpeg")


def build_codecs() -> Path:
    """The same for the run-length and LZW decoders."""
    return _build(CODECS_SOURCE, "frn_codecs")


def build_tiff() -> Path:
    """The same for TIFF's strip decoders."""
    return _build(TIFF_SOURCE, "frn_tiff")


def _image_lib(key: str, source: Path, build_fn, what: str, bind) -> ctypes.CDLL:
    """An image decoder's library (module globals ``_<key>_lib`` and
    ``_<key>_error``), built at first use and bound by ``bind``. Raises
    RuntimeError naming the cause where it is unavailable:
    ``FRN_DISABLE_NATIVE`` set, or g++ missing or failing (its message)."""
    lib_name, error_name = f"_{key}_lib", f"_{key}_error"
    with _lock:
        if globals()[lib_name] is not None:
            return globals()[lib_name]
        need = f"{what} need the port's native decoder (frn_tpu_torch/native/{source.name})"
        if os.environ.get("FRN_DISABLE_NATIVE"):
            raise RuntimeError(f"{need}, and FRN_DISABLE_NATIVE is set")
        if globals()[error_name] is None:
            try:
                lib = ctypes.CDLL(str(build_fn()))
            except (RuntimeError, OSError) as e:
                globals()[error_name] = str(e)
            else:
                bind(lib)
                globals()[lib_name] = lib
                return lib
        raise RuntimeError(f"{need}, which g++ could not build: {globals()[error_name]}")


def _bind_jpeg(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.frn_jpeg_info.argtypes = [p, i64, p, p, i32]
    lib.frn_jpeg_decode.argtypes = [p, i64, i32, p, p, i32]
    lib.frn_jpeg_decode_tiff.argtypes = [p, i64, i32, p, p, i32]
    lib.frn_jpeg_tables.argtypes = [p, i64, p, p, p, i32]
    lib.frn_jpeg_info.restype = lib.frn_jpeg_decode.restype = i32
    lib.frn_jpeg_decode_tiff.restype = lib.frn_jpeg_tables.restype = i32


def _bind_codecs(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.frn_bmp_rle.argtypes = [p, i64, i64, i32, i32, i32, p, p, i32]
    lib.frn_hdr_pixels.argtypes = [p, i64, i64, i32, i32, p, p, i32]
    lib.frn_gif_lzw.argtypes = [p, i64, i64, i64, p, p, i32]
    lib.frn_bmp_rle.restype = lib.frn_hdr_pixels.restype = lib.frn_gif_lzw.restype = i32


def _bind_tiff(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.frn_tiff_lzw.argtypes = [p, i64, i32, p, i64]
    lib.frn_tiff_inflate.argtypes = [p, i64, p, i64]
    lib.frn_tiff_packbits.argtypes = [p, i64, p, i64]
    lib.frn_tiff_lzw.restype = lib.frn_tiff_inflate.restype = lib.frn_tiff_packbits.restype = i32


def jpeg_lib() -> ctypes.CDLL:
    """The JPEG decoder's library, built at first use; RuntimeError naming
    the cause where it is unavailable."""
    return _image_lib("jpeg", JPEG_SOURCE, build_jpeg, "JPEG images", _bind_jpeg)


def codecs_lib() -> ctypes.CDLL:
    """The run-length and LZW decoders' library (RLE BMP, Radiance HDR, GIF),
    built at first use; RuntimeError naming the cause where it is
    unavailable."""
    return _image_lib("codecs", CODECS_SOURCE, build_codecs,
                      "Run-length BMP, Radiance HDR and GIF images", _bind_codecs)


def tiff_lib() -> ctypes.CDLL:
    """TIFF's LZW, Deflate and PackBits decoders' library, built at first
    use; RuntimeError naming the cause where it is unavailable."""
    return _image_lib("tiff", TIFF_SOURCE, build_tiff, "LZW, Deflate and PackBits TIFF images", _bind_tiff)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("FRN_DISABLE_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError):
            return None
        lib.frn_voxelize.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.frn_voxelize_raw.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.frn_tanh_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ]
        lib.frn_event_subsample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_voxelize(
    x: np.ndarray, y: np.ndarray, t_bin: np.ndarray, pol: np.ndarray,
    num_bins: int, height: int, width: int,
) -> Optional[np.ndarray]:
    """Scatter pre-binned events; returns None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.int32)
    y = np.ascontiguousarray(y, np.int32)
    t_bin = np.ascontiguousarray(t_bin, np.int32)
    pol = np.ascontiguousarray(pol, np.float32)
    out = np.zeros(num_bins * height * width, dtype=np.float32)
    lib.frn_voxelize(
        _ptr(x, ctypes.c_int32), _ptr(y, ctypes.c_int32), _ptr(t_bin, ctypes.c_int32),
        _ptr(pol, ctypes.c_float), len(x), num_bins, height, width,
        _ptr(out, ctypes.c_float),
    )
    return out.reshape(num_bins, height, width)


def native_voxelize_raw(
    x: np.ndarray, y: np.ndarray, t: np.ndarray, p: np.ndarray,
    num_bins: int, height: int, width: int,
) -> Optional[np.ndarray]:
    """Full raw-event pipeline (normalize + bin + scatter) in one native pass."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.int32)
    y = np.ascontiguousarray(y, np.int32)
    t = np.ascontiguousarray(t, np.int64)
    p = np.ascontiguousarray(p, np.int8)
    out = np.zeros(num_bins * height * width, dtype=np.float32)
    lib.frn_voxelize_raw(
        _ptr(x, ctypes.c_int32), _ptr(y, ctypes.c_int32), _ptr(t, ctypes.c_int64),
        _ptr(p, ctypes.c_int8), len(x), num_bins, height, width,
        _ptr(out, ctypes.c_float),
    )
    return out.reshape(num_bins, height, width)


def native_event_subsample(
    pos: np.ndarray, polarity: np.ndarray, height: int, width: int,
    threshold: float = 1.0,
) -> Optional[tuple]:
    """Bilinear event subsampling (zoom augmentation). Returns (pos, mask) or None."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, np.float32).copy()
    polarity = np.ascontiguousarray(polarity, np.float32)
    mask = np.zeros(len(pos), np.uint8)
    count = np.zeros(height * width, np.float32)
    lib.frn_event_subsample(
        _ptr(pos, ctypes.c_float), _ptr(polarity, ctypes.c_float),
        _ptr(mask, ctypes.c_uint8), _ptr(count, ctypes.c_float),
        len(pos), height, width, threshold,
    )
    return pos, mask.astype(bool)


def native_tanh_normalize(v: np.ndarray, threshold: float = 5.0) -> Optional[np.ndarray]:
    """In place tanh(v / threshold) where max|v| > threshold (on a contiguous
    f32 copy if ``v`` is not one); None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(v, np.float32)
    lib.frn_tanh_normalize(_ptr(v, ctypes.c_float), v.size, threshold)
    return v
