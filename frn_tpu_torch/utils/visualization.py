"""Detection + event visualization (host-side, OpenCV).

Counterpart of ``frn_tpu/utils/visualization.py``, the reference's
visualizer surface (visulize_fusion.py:47-131,
retinanet/data/visualization/{event_viz,bbox_viz}.py): event overlays on RGB
frames, per-class colored detection boxes, side-by-side RGB/event panels.
OpenCV is imported when a box is drawn; without it, drawing raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

_COLORS = [
    (60, 76, 231), (113, 204, 46), (219, 152, 52), (34, 126, 230), (182, 89, 155),
    (15, 196, 241), (94, 73, 52), (140, 153, 160),
]


def _cv2():
    try:
        import cv2
    except ImportError:
        raise RuntimeError("cv2 required") from None
    return cv2


def events_to_image(voxel_hwc: np.ndarray) -> np.ndarray:
    """Voxel grid -> white-background image with red/blue polarity dots
    (visulize_fusion.py's binary event view)."""
    acc = voxel_hwc.sum(axis=-1)
    img = np.full((*acc.shape, 3), 255, np.uint8)
    img[acc > 0] = (255, 0, 0)  # positive: blue (BGR)
    img[acc < 0] = (0, 0, 255)  # negative: red
    return img


def draw_events_on_image(
    img: np.ndarray, x: np.ndarray, y: np.ndarray, p: np.ndarray, alpha: float = 0.5
) -> np.ndarray:
    """Overlay raw events on an image (event_viz.py:3-9 semantics)."""
    out = img.copy()
    pos = p > 0
    out[y[pos], x[pos]] = (1 - alpha) * out[y[pos], x[pos]] + alpha * np.array([255, 0, 0])
    neg = ~pos
    out[y[neg], x[neg]] = (1 - alpha) * out[y[neg], x[neg]] + alpha * np.array([0, 0, 255])
    return out.astype(img.dtype)


def draw_detections(
    img_u8: np.ndarray,
    boxes: np.ndarray,  # (N,4) x1,y1,x2,y2
    labels: np.ndarray,
    scores: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    score_threshold: float = 0.5,
) -> np.ndarray:
    cv2 = _cv2()
    out = np.ascontiguousarray(img_u8)
    for i in range(len(boxes)):
        if scores is not None and scores[i] < score_threshold:
            continue
        x1, y1, x2, y2 = (int(v) for v in boxes[i])
        c = _COLORS[int(labels[i]) % len(_COLORS)]
        cv2.rectangle(out, (x1, y1), (x2, y2), c, 2)
        name = class_names[int(labels[i])] if class_names else str(int(labels[i]))
        caption = f"{name}" + (f" {scores[i]:.2f}" if scores is not None else "")
        cv2.putText(out, caption, (x1, max(y1 - 4, 10)), cv2.FONT_HERSHEY_SIMPLEX, 0.5, c, 1)
    return out


def save_detection_panel(
    path: str,
    rgb01: np.ndarray,
    event_voxel_hwc: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    scores: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    score_threshold: float = 0.5,
) -> None:
    """Write a side-by-side RGB/event panel with detections (visulize_fusion.py)."""
    rgb_u8 = (np.clip(rgb01, 0, 1) * 255).astype(np.uint8)
    ev_u8 = events_to_image(event_voxel_hwc)
    rgb_d = draw_detections(rgb_u8, boxes, labels, scores, class_names, score_threshold)
    ev_d = draw_detections(ev_u8, boxes, labels, scores, class_names, score_threshold)
    panel = np.concatenate([rgb_d, ev_d], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _cv2().imwrite(path, panel)
