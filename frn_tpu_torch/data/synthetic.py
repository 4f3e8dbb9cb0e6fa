"""Seeded in-memory detection samples (NHWC f32 images with 1-3 boxes each).

For the training entry point and its checks: every sample is made from
``(seed, index)`` with numpy, so a run and its tests see the same data.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from frn_tpu_torch.config import DatasetGeometry


def box_samples(num: int, geometry: DatasetGeometry, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """``num`` samples {'rgb' (H, W, 3), 'event' (H, W, C), 'annot' (k, 5)}:
    normal(0, 1) noise, k in 1..3 boxes of 1/6 to 1/2 of the image side with
    classes in range, brightened in both modalities."""
    h, w, c = geometry.height, geometry.width, geometry.event_channels
    out = []
    for i in range(num):
        rng = np.random.default_rng([seed, i])
        rgb = rng.standard_normal((h, w, 3), dtype=np.float32)
        event = rng.standard_normal((h, w, c), dtype=np.float32)
        k = int(rng.integers(1, 4))
        annot = np.zeros((k, 5), np.float32)
        for j in range(k):
            bw = int(rng.integers(w // 6, w // 2 + 1))
            bh = int(rng.integers(h // 6, h // 2 + 1))
            x1 = int(rng.integers(0, w - bw))
            y1 = int(rng.integers(0, h - bh))
            annot[j] = [x1, y1, x1 + bw, y1 + bh, rng.integers(0, geometry.num_classes)]
            rgb[y1:y1 + bh, x1:x1 + bw] += 1.0
            event[y1:y1 + bh, x1:x1 + bw] += 1.0
        out.append({"rgb": rgb, "event": event, "annot": annot})
    return out
