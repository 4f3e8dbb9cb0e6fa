"""Event-stream rasterization on the host, and the voxel-grid normalization.

Counterpart of part of ``frn_tpu/ops/voxelize.py``: ``voxelize_events_np``
(numpy bincount; the JAX package may take a native C++ scatter instead, whose
f32 sums of +-1 are the same values), and the conditional tanh squash in numpy
and in torch, per grid or per sample of a batch. Semantics of the reference's
preprocess_events (dsec_data.py):

  * events filtered to x < W, y < H
  * time normalized over the window: (t - t_first) / (t_last - t_first + 1e-6)
  * nearest temporal bin: clip(floor(t_norm * (C - 1)), 0, C - 1)
  * polarity contribution: +1 if p > 0 else -1, accumulated
  * post-norm (dsec_data.py:461-462): if max|v| > 5 -> tanh(v / 5)

The device voxelizers (``voxelize_events``, ``voxel_from_sparse``) are not
ported yet.
"""

from __future__ import annotations

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


def normalize_event_voxel(voxel: torch.Tensor, threshold: float = 5.0) -> torch.Tensor:
    """tanh(v / 5) applied only when max|v| > 5 (dsec_data.py:461-462)."""
    big = voxel.abs().max() > threshold
    return torch.where(big, torch.tanh(voxel / threshold), voxel)


def normalize_event_voxel_batched(voxel: torch.Tensor, threshold: float = 5.0) -> torch.Tensor:
    """The same per sample of a (B, H, W, C) batch: the reference applies the
    max|v| > 5 condition per sample (in ``__getitem__``), so one busy sample
    must not squash its batchmates."""
    m = voxel.abs().amax(dim=(1, 2, 3), keepdim=True)
    return torch.where(m > threshold, torch.tanh(voxel / threshold), voxel)


def normalize_event_voxel_np(voxel: np.ndarray, threshold: float = 5.0) -> np.ndarray:
    if np.abs(voxel).max() > threshold:
        return np.tanh(voxel / threshold).astype(np.float32)
    return voxel
