"""Host-side sample transforms (numpy; run in loader workers).

A copy of ``frn_tpu/data/transforms.py``. The reference's Resizer computes
scale = min_side / smallest_side, which is 1 for native-geometry images (480x640
DSEC, 260x346 DDD17), and forces scale 1 for the boxes regardless: so it is a
float conversion and, for an off-geometry image only, a resize with OpenCV
(imported there, so that loading native-geometry data needs no OpenCV).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from frn_tpu_torch.config import DatasetGeometry


def normalize_rgb(img: np.ndarray, geometry: DatasetGeometry) -> np.ndarray:
    """(img in [0,1], HWC) -> standardized float32 (dataloader.py:522-534)."""
    mean = np.asarray(geometry.rgb_mean, dtype=np.float32)
    std = np.asarray(geometry.rgb_std, dtype=np.float32)
    return ((img.astype(np.float32) - mean) / std).astype(np.float32)


def resize_to_geometry(
    img: np.ndarray, geometry: DatasetGeometry
) -> Tuple[np.ndarray, float]:
    """Resize an HWC image to the dataset geometry if needed. Returns (img, scale=1).

    The reference's Resizer never rescales annotations (scale hard-set to 1,
    dataloader.py:490); boxes stay in native coordinates.
    """
    h, w = img.shape[:2]
    if (h, w) == (geometry.height, geometry.width):
        return img.astype(np.float32), 1.0
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        raise RuntimeError("cv2 required to resize off-geometry images")
    out = cv2.resize(img, (geometry.width, geometry.height), interpolation=cv2.INTER_LINEAR)
    if out.ndim == 2:
        out = out[:, :, None]
    return out.astype(np.float32), 1.0


def horizontal_flip(sample: Dict[str, np.ndarray], p: float = 0.5,
                    rng: np.random.Generator | None = None) -> Dict[str, np.ndarray]:
    """Random horizontal flip of the event image, the RGB image and the boxes
    (the reference's Augmenter; defined there but not wired into its trainers)."""
    rng = rng or np.random.default_rng()
    if rng.random() >= p:
        return sample
    out = dict(sample)
    for key in ("event", "rgb"):
        if key in out and out[key] is not None:
            out[key] = np.ascontiguousarray(out[key][:, ::-1, :])
    annot = out.get("annot")
    if annot is not None and len(annot):
        w = sample["rgb"].shape[1] if sample.get("rgb") is not None else sample["event"].shape[1]
        annot = annot.copy()
        x1 = annot[:, 0].copy()
        annot[:, 0] = w - annot[:, 2]
        annot[:, 2] = w - x1
        out["annot"] = annot
    return out
