"""Fixed-shape batching (counterpart of ``frn_tpu/data/collate.py``, f32 wire).

Every batch is padded to the static dataset geometry and a fixed annotation
capacity, as the JAX package does for its compiled step; the port keeps the
same batch layout so the loss and the tests see the same arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from frn_tpu_torch.config import NOT_PORTED, DatasetGeometry


def collate_fixed(
    samples: Sequence[Dict[str, np.ndarray]],
    geometry: DatasetGeometry,
    max_annots: int = 64,
    batch_size: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Stack samples into fixed-shape arrays.

    Images are zero-padded bottom/right to (H, W); annotations are padded with
    -1 rows and truncated at ``max_annots``; a short batch is zero-padded to
    ``batch_size`` and flagged in 'sample_mask'.
    """
    h, w = geometry.height, geometry.width
    bsz = batch_size or len(samples)
    n = len(samples)
    if n > bsz:
        raise ValueError(f"{n} samples do not fit a batch of {bsz}")
    if "event_x" in samples[0]:
        raise NotImplementedError(f"collate_fixed for the 'events' wire: {NOT_PORTED}")
    for s in samples[1:]:
        if s["event"].dtype != samples[0]["event"].dtype or s["rgb"].dtype != samples[0]["rgb"].dtype:
            raise TypeError(
                "collate_fixed: heterogeneous sample dtypes (event "
                f"{s['event'].dtype} vs {samples[0]['event'].dtype}, rgb "
                f"{s['rgb'].dtype} vs {samples[0]['rgb'].dtype})"
            )
    ev_c = samples[0]["event"].shape[-1]
    events = np.zeros((bsz, h, w, ev_c), dtype=samples[0]["event"].dtype)
    rgbs = np.zeros((bsz, h, w, 3), dtype=samples[0]["rgb"].dtype)
    annots = np.full((bsz, max_annots, 5), -1.0, dtype=np.float32)
    mask = np.zeros((bsz,), dtype=bool)
    for i, s in enumerate(samples):
        e, r = s["event"], s["rgb"]
        events[i, : e.shape[0], : e.shape[1], :] = e[:h, :w]
        rgbs[i, : r.shape[0], : r.shape[1], :] = r[:h, :w]
        a = s["annot"]
        k = min(len(a), max_annots)
        if k:
            annots[i, :k] = a[:k]
        mask[i] = True
    return {"event": events, "rgb": rgbs, "annot": annots, "sample_mask": mask}
