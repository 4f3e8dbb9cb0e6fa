"""Event-stream rasterization on the host and on the device, and the voxel-grid
normalization.

Counterpart of ``frn_tpu/ops/voxelize.py``: ``voxelize_events_np`` (numpy
bincount; the JAX package may take a native C++ scatter instead, whose f32
sums of +-1 are the same values), the other host encodings
(``event_representation_np``, the sparse-cell wire), the device voxelizers
over padded static-shape streams (``voxelize_events``,
``voxelize_events_batched``, ``voxel_from_sparse``), and the conditional tanh
squash in numpy and in torch, per grid or per sample of a batch. Semantics of
the reference's preprocess_events (dsec_data.py):

  * events filtered to x < W, y < H
  * time normalized over the window: (t - t_first) / (t_last - t_first + 1e-6)
  * nearest temporal bin: clip(floor(t_norm * (C - 1)), 0, C - 1)
  * polarity contribution: +1 if p > 0 else -1, accumulated
  * post-norm (dsec_data.py:461-462): if max|v| > 5 -> tanh(v / 5)

The device voxelizers are plain torch, as the JAX package's are plain jnp:
a scatter-add has no matrix work for a hand-written kernel to do, and XLA's
``segment_sum`` becomes ``index_add_`` (atomic adds on the card). Sums of +-1
and of int8 counts in f32 are exact below 2^24 whatever the order of the
adds, so every order gives the same grid. The linear index is int64 from its
first operation on (x and y arrive as int16), and time stays integer: window
time in int32 microseconds does not survive f32.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch


def voxelize_events_np(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    num_bins: int = 5,
    height: int = 480,
    width: int = 640,
) -> np.ndarray:
    """Host-side voxelization -> (num_bins, height, width) float32.

    ``p`` may be {0,1} or {-1,1}; anything > 0 counts +1, else -1
    (dsec_data.py:356).
    """
    mask = (y < height) & (x < width)
    if not mask.all():
        x, y, t, p = x[mask], y[mask], t[mask], p[mask]
    if len(t) == 0:
        return np.zeros((num_bins, height, width), dtype=np.float32)
    t = t.astype(np.float64)
    t_norm = (t - t[0]) / (t[-1] - t[0] + 1e-6)
    t_bin = np.clip((t_norm * (num_bins - 1)).astype(np.int64), 0, num_bins - 1)
    pol = (p > 0).astype(np.float32) * 2.0 - 1.0
    lin = (t_bin * height + y.astype(np.int64)) * width + x.astype(np.int64)
    flat = np.bincount(lin, weights=pol, minlength=num_bins * height * width)
    return flat.astype(np.float32).reshape(num_bins, height, width)


def _time_bins(t: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Exact integer binning of the reference's floor((C - 1) (t - t0) /
    (span + 1e-6)) (dsec_data.py:359-368): the +1e-6 only moves an event
    whose scaled time lands exactly on an integer down one bin (the window's
    last event included), so: floor division, minus 1 on exact multiples,
    clipped. Floor division and a remainder with the divisor's sign, as
    Python's (and jnp's) // and %: a padded slot can have t < t0."""
    t_rel = t - t0
    span = (t1 - t0).clamp(min=1)
    num = t_rel * (num_bins - 1)
    t_bin = torch.div(num, span, rounding_mode="floor")
    t_bin = t_bin - ((torch.remainder(num, span) == 0) & (t_rel > 0)).long()
    return t_bin.clamp(0, num_bins - 1)


def voxelize_events(
    x: torch.Tensor,  # (N,) integer, padded
    y: torch.Tensor,  # (N,)
    t: torch.Tensor,  # (N,) integer time, ascending over the valid prefix
    p: torch.Tensor,  # (N,) polarity, > 0 counts +1
    num_valid: Union[int, torch.Tensor],  # the valid prefix's length
    num_bins: int = 5,
    height: int = 480,
    width: int = 640,
) -> torch.Tensor:
    """Device-side static-shape voxelization of a padded event stream ->
    (num_bins, height, width) float32 on the stream's device.

    Events at index >= num_valid, and events outside the grid, contribute
    nothing. t0 and t1 are the raw stream's first and last valid events
    (the host voxelizer drops out-of-bounds events first: the two agree on
    in-bounds streams)."""
    n = x.shape[0]
    x, y, t = x.long(), y.long(), t.long()
    num_valid = torch.as_tensor(num_valid, device=x.device).long()
    valid = ((torch.arange(n, device=x.device) < num_valid) & (x < width) & (y < height)
             & (x >= 0) & (y >= 0))
    # the last valid event; an index out of range is clamped, as XLA clamps it
    t1 = t[(num_valid - 1).clamp(0, n - 1)]
    t_bin = _time_bins(t, t[0], t1, num_bins)
    size = num_bins * height * width
    lin = torch.where(valid, (t_bin * height + y) * width + x, size)  # dump slot past the grid
    pol = torch.where(valid & (p > 0), 1.0, torch.where(valid, -1.0, 0.0))
    flat = torch.zeros(size + 1, dtype=torch.float32, device=x.device)
    flat.index_add_(0, lin, pol)
    return flat[:size].view(num_bins, height, width)


def voxelize_events_batched(
    x: torch.Tensor,  # (B, N) integer, padded
    y: torch.Tensor,
    t: torch.Tensor,
    p: torch.Tensor,
    num_valid: torch.Tensor,  # (B,)
    num_bins: int = 5,
    height: int = 480,
    width: int = 640,
) -> torch.Tensor:
    """``voxelize_events`` of every row -> (B, H, W, C) NHWC float32, ready
    for the detector: the fully on-device ingestion path, where the host
    ships raw padded streams and does no voxelization.

    One ``index_add_`` over all B rows: each row's linear index is offset by
    its own base, NHWC order directly (no transpose), and padded or invalid
    events of every row go to one dump slot past the end. t0 and t1 are
    gathered per row, t1 at max(num_valid - 1, 0)."""
    b, n = x.shape
    x, y, t = x.long(), y.long(), t.long()
    num_valid = num_valid.to(x.device).long()
    valid = ((torch.arange(n, device=x.device) < num_valid[:, None]) & (x < width)
             & (y < height) & (x >= 0) & (y >= 0))
    t1 = t.gather(1, (num_valid - 1).clamp(0, n - 1)[:, None])
    t_bin = _time_bins(t, t[:, :1], t1, num_bins)
    size = num_bins * height * width
    base = torch.arange(b, device=x.device)[:, None] * height
    lin = (((base + y) * width + x) * num_bins + t_bin)
    lin = torch.where(valid, lin, b * size)
    pol = torch.where(valid & (p > 0), 1.0, torch.where(valid, -1.0, 0.0))
    flat = torch.zeros(b * size + 1, dtype=torch.float32, device=x.device)
    flat.index_add_(0, lin.reshape(-1), pol.reshape(-1))
    return flat[:b * size].view(b, height, width, num_bins)


def event_representation_np(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    kind: str = "voxel",
    num_bins: int = 5,
    height: int = 480,
    width: int = 640,
) -> np.ndarray:
    """Alternative event encodings (reference test_dsec_det.py:65
    --event_representation {voxel, time_surface, event_count, binary}), each
    (num_bins, height, width) float32 so that the 5-channel event stem takes
    any of them:

      * voxel:        signed temporal binning (the training representation)
      * time_surface: per-pixel normalized timestamp of the most recent event,
                      signed by polarity, replicated across bins weighted by
                      bin recency
      * event_count:  per-bin unsigned event counts
      * binary:       per-bin event occupancy in {0, 1}
    """
    if kind == "voxel":
        return voxelize_events_np(x, y, t, p, num_bins, height, width)

    mask = (y < height) & (x < width)
    x, y, t, p = x[mask], y[mask], t[mask], p[mask]
    out = np.zeros((num_bins, height, width), np.float32)
    if len(t) == 0:
        return out

    t = t.astype(np.float64)
    t_norm = (t - t[0]) / (t[-1] - t[0] + 1e-6)
    if kind == "time_surface":
        pol = (p > 0).astype(np.float32) * 2.0 - 1.0
        surface = np.zeros((height, width), np.float32)
        # events are time-sorted: later writes win, the most recent timestamp
        surface[y, x] = (t_norm * pol).astype(np.float32)
        scale = (np.arange(num_bins, dtype=np.float32) + 1.0) / num_bins
        return surface[None] * scale[:, None, None]

    t_bin = np.clip((t_norm * (num_bins - 1)).astype(np.int64), 0, num_bins - 1)
    lin = (t_bin * height + y.astype(np.int64)) * width + x.astype(np.int64)
    counts = np.bincount(lin, minlength=num_bins * height * width)
    counts = counts.astype(np.float32).reshape(num_bins, height, width)
    if kind == "event_count":
        return counts
    if kind == "binary":
        return (counts > 0).astype(np.float32)
    raise ValueError(f"unknown event representation {kind!r}")


def sparse_cells_from_voxel_np(
    voxel: np.ndarray,  # (num_bins, height, width) signed counts
    capacity: int,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Encode a count voxel as delta-coded sparse cells (the 'sparse' wire),
    3 B a cell:

      * cells = nonzero entries of the flattened voxel, ascending linear index
      * deltas: uint16 index gaps (the first cell's delta is its absolute
        index); gaps > 65535 are bridged by zero-count cells of delta 65535
      * counts: int8; |count| > 127 splits across repeated delta-0 cells, so
        the encoding is exact for any count magnitude (unlike the compact
        wire's +-127 clip)
      * padding to ``capacity`` uses (delta 0, count 0) cells, which decode
        to nothing

    Decode is cumsum(deltas) -> scatter-add(counts) (``voxel_from_sparse``).
    Returns (deltas, counts, n_cells, n_dropped_cells); an encoding longer
    than ``capacity`` drops its trailing cells (counted).
    """
    flat = np.rint(np.asarray(voxel, np.float64)).astype(np.int64).ravel()
    idx = np.flatnonzero(flat)
    vals = flat[idx]
    m = len(idx)
    if m == 0:
        return (np.zeros(capacity, np.uint16), np.zeros(capacity, np.int8), 0, 0)

    delta = np.empty(m, np.int64)
    delta[0] = idx[0]
    delta[1:] = np.diff(idx)
    k_bridge = np.maximum(delta - 1, 0) // 65535
    rem = delta - k_bridge * 65535  # in [0, 65535]
    n_split = np.maximum((np.abs(vals) + 126) // 127, 1)
    per_cell = k_bridge + n_split
    offsets = np.concatenate([[0], np.cumsum(per_cell)])
    total = int(offsets[-1])

    seg = np.repeat(np.arange(m), per_cell)
    pos = np.arange(total) - np.repeat(offsets[:-1], per_cell)
    is_bridge = pos < k_bridge[seg]
    is_first_real = pos == k_bridge[seg]
    deltas = np.where(is_bridge, 65535, np.where(is_first_real, rem[seg], 0))
    j = np.maximum(pos - k_bridge[seg], 0)  # 0-based split slot
    chunk = np.clip(np.abs(vals)[seg] - 127 * j, 0, 127)
    counts = np.where(is_bridge, 0, np.sign(vals)[seg] * chunk)

    dropped = max(total - capacity, 0)
    n = min(total, capacity)
    d_out = np.zeros(capacity, np.uint16)
    c_out = np.zeros(capacity, np.int8)
    d_out[:n] = deltas[:n]
    c_out[:n] = counts[:n]
    return d_out, c_out, n, dropped


def sparse_cells_np(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    num_bins: int = 5,
    height: int = 480,
    width: int = 640,
    capacity: int = 24576,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Voxelize an event window (reference binning) then sparse-encode it."""
    voxel = voxelize_events_np(x, y, t, p, num_bins, height, width)
    return sparse_cells_from_voxel_np(voxel, capacity)


def voxel_from_sparse(
    deltas: torch.Tensor,  # (K,) uint16 index gaps
    counts: torch.Tensor,  # (K,) int8 signed counts
    num_bins: int = 5,
    height: int = 480,
    width: int = 640,
) -> torch.Tensor:
    """Device-side decode of the sparse-cell wire -> (num_bins, H, W) float32
    on the cells' device. Padding cells (delta 0, count 0) add nothing;
    indices past the grid land in a dump slot instead of wrapping. The deltas
    become int32 before the running sum (torch's uint16 takes few
    operations), which runs in int64."""
    size = num_bins * height * width
    idx = torch.cumsum(deltas.to(torch.int32), 0, dtype=torch.int64).clamp(0, size)
    flat = torch.zeros(size + 1, dtype=torch.float32, device=counts.device)
    flat.index_add_(0, idx, counts.float())
    return flat[:size].view(num_bins, height, width)


def host_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded as numpy's division: on CUDA torch divides by
    a Python scalar as a multiply by its rounded reciprocal (one ulp off), by
    a tensor it divides. The divisor is filled on the device (a copy from
    the host would wait for the stream)."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def normalize_event_voxel(voxel: torch.Tensor, threshold: float = 5.0) -> torch.Tensor:
    """tanh(v / 5) applied only when max|v| > 5 (dsec_data.py:461-462)."""
    big = voxel.abs().max() > threshold
    return torch.where(big, torch.tanh(host_div(voxel, threshold)), voxel)


def normalize_event_voxel_batched(voxel: torch.Tensor, threshold: float = 5.0) -> torch.Tensor:
    """The same per sample of a (B, H, W, C) batch: the reference applies the
    max|v| > 5 condition per sample (in ``__getitem__``), so one busy sample
    must not squash its batchmates."""
    m = voxel.abs().amax(dim=(1, 2, 3), keepdim=True)
    return torch.where(m > threshold, torch.tanh(host_div(voxel, threshold)), voxel)


def normalize_event_voxel_np(voxel: np.ndarray, threshold: float = 5.0) -> np.ndarray:
    if np.abs(voxel).max() > threshold:
        return np.tanh(voxel / threshold).astype(np.float32)
    return voxel
