"""FPN upsampling on NCHW tensors (counterpart of ``frn_tpu/ops/upsample.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def nearest_upsample_2x(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest x2, cropped to the finer level's ceil-division shape."""
    y = F.interpolate(x, scale_factor=2, mode="nearest")
    return y[:, :, : target_hw[0], : target_hw[1]]


def bilinear_resize(x: torch.Tensor, out_shape: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize to a fixed size, ``align_corners=False`` (DDD17 FPN)."""
    if tuple(x.shape[2:]) == tuple(out_shape):
        return x
    return F.interpolate(x, size=tuple(out_shape), mode="bilinear", align_corners=False)
