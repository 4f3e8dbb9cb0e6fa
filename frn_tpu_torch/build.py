"""Build of the port's CUDA kernels, at first use, from the sources in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library with a plain C
interface, ``_build/<name>-<hash>.so``, where the hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source is rebuilt
and a stale library never loads.
Several sources build in parallel, one nvcc each. Nothing is built when the
package is imported. Builds are serialized by a lock: two threads that reach
a kernel's first use at once (a serving engine's warm-up in the caller's
thread and its dispatcher thread) run one nvcc, and the second loads what
the first built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "flash_attention_int8", "stem",
           "flash_attention_f32", "flash_attention_bwd_f32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_LOCK = threading.Lock()


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[Path, float, str]]:
    """Compile every named source whose library is missing, all at once.

    Returns {name: (library path, seconds, compiler log)}; a library that was
    already built reports 0 seconds and an empty log. Raises on a failed build.
    One build runs at a time in a process.
    """
    with _BUILD_LOCK:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, Tuple[Path, float, str]]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Tuple[Path, float, str]] = {}
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = (lib, 0.0, "")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (lib, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    lib, _, _ = build([name])[name]
    return ctypes.CDLL(str(lib))
