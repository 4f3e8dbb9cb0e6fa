"""DSEC h5 event-stream reading and writing.

Counterpart of ``frn_tpu/data/events.py``: chunked h5 files with datasets
events/{x,y,t,p}, a scalar t_offset, and an ms_to_idx lookup table mapping
relative milliseconds to the first event index at or after that millisecond
(the reference's dsec_utils.py:80-120 and the dsec-det library's layout).

``h5py`` is imported here if it is installed; a reader or a writer built
without it raises ``ImportError``, so that the module itself imports anywhere.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import numpy as np

try:
    import h5py
except ImportError:  # the reader and writer raise when built
    h5py = None


def _require_h5py() -> None:
    if h5py is None:
        raise ImportError("h5py is required to read or write DSEC event files")


class H5EventReader:
    """Random-access window reads over a DSEC event h5 file.

    Timestamps given to ``window`` are absolute microseconds (the clock of the
    image timestamps); they are offset by t_offset and resolved through
    ms_to_idx. File handles are thread-local: h5py serializes all access to
    one File object through a lock, so loader threads sharing one handle
    would read one after another.
    """

    def __init__(self, path: str):
        _require_h5py()
        self.path = path
        self._local = threading.local()
        self._t_offset: Optional[int] = None

    @property
    def file(self):
        f = getattr(self._local, "file", None)
        if f is None:
            f = h5py.File(self.path, "r")
            self._local.file = f
        return f

    def close(self):
        f = getattr(self._local, "file", None)
        if f is not None:
            f.close()
            self._local.file = None

    @property
    def t_offset(self) -> int:
        if self._t_offset is None:
            self._t_offset = int(self.file["t_offset"][()])
        return self._t_offset

    def _ms_index(self, t_abs_us: int) -> int:
        ms_to_idx = self.file["ms_to_idx"]
        ms = int((t_abs_us - self.t_offset) / 1e3)
        ms = max(0, min(ms, len(ms_to_idx) - 1))
        return int(ms_to_idx[ms])

    def window(self, t0_us: int, t1_us: int) -> Dict[str, np.ndarray]:
        """Events with t in about [t0_us, t1_us) (ms_to_idx granularity):
        dict x, y, t (int64 absolute us) and p (raw polarity)."""
        i0 = self._ms_index(t0_us)
        i1 = self._ms_index(t1_us)
        i0, i1 = sorted((max(i0, 0), max(i1, 0)))
        ev = self.file["events"]
        out = {k: np.asarray(ev[k][i0:i1]) for k in "xytp"}
        out["t"] = out["t"].astype(np.int64) + self.t_offset
        return out


def write_event_h5(
    path: str,
    x: np.ndarray,
    y: np.ndarray,
    t_abs_us: np.ndarray,
    p: np.ndarray,
    t_offset: Optional[int] = None,
) -> None:
    """Write a DSEC-format event h5 file (fixtures and tools)."""
    _require_h5py()
    order = np.argsort(t_abs_us, kind="stable")
    x, y, t_abs_us, p = x[order], y[order], t_abs_us[order], p[order]
    if t_offset is None:
        t_offset = int(t_abs_us[0]) if len(t_abs_us) else 0
    t_rel = t_abs_us.astype(np.int64) - t_offset
    num_ms = int(t_rel[-1] / 1e3) + 2 if len(t_rel) else 1
    # ms_to_idx[m] = the first index with t_rel >= m * 1000
    ms_to_idx = np.searchsorted(t_rel, np.arange(num_ms, dtype=np.int64) * 1000, side="left")

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        g = f.create_group("events")
        g.create_dataset("x", data=x.astype(np.uint16))
        g.create_dataset("y", data=y.astype(np.uint16))
        g.create_dataset("t", data=t_rel)
        g.create_dataset("p", data=p.astype(np.uint8))
        f.create_dataset("t_offset", data=np.int64(t_offset))
        f.create_dataset("ms_to_idx", data=ms_to_idx.astype(np.int64))
