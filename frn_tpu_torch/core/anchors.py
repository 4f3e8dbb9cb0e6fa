"""Static anchor generation (numpy), a copy of ``frn_tpu/core/anchors.py``.

Levels 2..6 -> strides 4..64, base sizes 16..256, 3 ratios x 3 scales = 9
anchors per cell in corner format. Per-level grids are ceil(image / stride);
cells are row-major and the 9 base anchors cycle fastest. Totals: 230,220
anchors at 480x640 (DSEC), 68,490 at 260x346 (DDD17).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from frn_tpu_torch.config import AnchorConfig


def generate_base_anchors(
    base_size: float,
    ratios: Sequence[float] = (0.5, 1.0, 2.0),
    scales: Sequence[float] = (1.0, 2.0 ** (1.0 / 3.0), 2.0 ** (2.0 / 3.0)),
) -> np.ndarray:
    """(len(ratios)*len(scales), 4) anchors centred at the origin, ratio-major."""
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    side = base_size * np.tile(scales, len(ratios))
    ratio_rep = np.repeat(ratios, len(scales))
    w = np.sqrt(side * side / ratio_rep)
    h = w * ratio_rep
    return np.stack([-0.5 * w, -0.5 * h, 0.5 * w, 0.5 * h], axis=1)


def level_shapes(image_shape: Tuple[int, int], levels: Sequence[int]) -> list:
    h, w = image_shape
    return [(math.ceil(h / 2 ** lvl), math.ceil(w / 2 ** lvl)) for lvl in levels]


def _shift_anchors(grid_shape: Tuple[int, int], stride: int, base: np.ndarray) -> np.ndarray:
    gh, gw = grid_shape
    cx = (np.arange(gw, dtype=np.float64) + 0.5) * stride
    cy = (np.arange(gh, dtype=np.float64) + 0.5) * stride
    sx, sy = np.meshgrid(cx, cy)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


@functools.lru_cache(maxsize=32)
def anchors_for_shape(
    image_shape: Tuple[int, int], cfg: AnchorConfig = AnchorConfig()
) -> np.ndarray:
    """All anchors for an image shape, (A_total, 4) float32, level-major."""
    shapes = level_shapes(image_shape, cfg.pyramid_levels)
    per_level = [
        _shift_anchors(gshape, stride, generate_base_anchors(size, cfg.ratios, cfg.scales))
        for gshape, stride, size in zip(shapes, cfg.strides, cfg.sizes)
    ]
    out = np.concatenate(per_level, axis=0).astype(np.float32)
    out.setflags(write=False)  # shared by every caller of the cache
    return out


def num_anchors_for_shape(image_shape: Tuple[int, int], cfg: AnchorConfig = AnchorConfig()) -> int:
    shapes = level_shapes(image_shape, cfg.pyramid_levels)
    return cfg.num_anchors_per_cell * sum(h * w for h, w in shapes)


def anchors_tensor(
    image_shape: Tuple[int, int], cfg: AnchorConfig, device: torch.device
) -> torch.Tensor:
    return torch.tensor(anchors_for_shape(tuple(image_shape), cfg), device=device)
