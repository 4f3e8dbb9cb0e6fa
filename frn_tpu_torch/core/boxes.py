"""Box geometry: pairwise IoU, delta encode and decode, image clipping.

Counterpart of ``frn_tpu/core/boxes.py``. The arithmetic is written in the
same order as the JAX functions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

DEFAULT_STD = (0.1, 0.1, 0.2, 0.2)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between (..., N, 4) and (..., M, 4) corner boxes -> (..., N, M).

    The union is clamped to >= 1e-8, which keeps zero-area boxes finite.
    """
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    iw = torch.minimum(a[..., :, None, 2], b[..., None, :, 2]) - torch.maximum(
        a[..., :, None, 0], b[..., None, :, 0]
    )
    ih = torch.minimum(a[..., :, None, 3], b[..., None, :, 3]) - torch.maximum(
        a[..., :, None, 1], b[..., None, :, 1]
    )
    inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    union = (area_a[..., :, None] + area_b[..., None, :] - inter).clamp_min(1e-8)
    return inter / union


def _to_center(boxes: torch.Tensor):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w, h


def encode_boxes(
    anchors: torch.Tensor, gt: torch.Tensor, std: Sequence[float] = DEFAULT_STD,
    min_size: float = 1.0,
) -> torch.Tensor:
    """Regression targets (dx, dy, log dw, log dh) / std of gt boxes against
    anchors, both (..., 4) and broadcastable; gt widths and heights are clamped
    to >= ``min_size`` before the log."""
    acx, acy, aw, ah = _to_center(anchors)
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(min_size)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(min_size)
    gcx = gt[..., 0] + 0.5 * (gt[..., 2] - gt[..., 0])
    gcy = gt[..., 1] + 0.5 * (gt[..., 3] - gt[..., 1])
    dx = (gcx - acx) / aw / std[0]
    dy = (gcy - acy) / ah / std[1]
    dw = torch.log(gw / aw) / std[2]
    dh = torch.log(gh / ah) / std[3]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(
    anchors: torch.Tensor, deltas: torch.Tensor, std: Sequence[float] = DEFAULT_STD
) -> torch.Tensor:
    """Deltas (dx, dy, log dw, log dh), scaled by ``std``, applied to anchors."""
    acx, acy, aw, ah = _to_center(anchors)
    dx = deltas[..., 0] * std[0]
    dy = deltas[..., 1] * std[1]
    dw = deltas[..., 2] * std[2]
    dh = deltas[..., 3] * std[3]
    pcx = acx + dx * aw
    pcy = acy + dy * ah
    pw = torch.exp(dw) * aw
    ph = torch.exp(dh) * ah
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1
    )


def clip_boxes(boxes: torch.Tensor, image_shape: Tuple[int, int]) -> torch.Tensor:
    """Clamp x1, y1 >= 0 and x2 <= W, y2 <= H."""
    h, w = image_shape
    return torch.stack(
        [
            boxes[..., 0].clamp_min(0.0),
            boxes[..., 1].clamp_min(0.0),
            boxes[..., 2].clamp_max(float(w)),
            boxes[..., 3].clamp_max(float(h)),
        ],
        dim=-1,
    )
