"""Fixed-shape batching (counterpart of ``frn_tpu/data/collate.py``).

Every batch is padded to the static dataset geometry and a fixed annotation
capacity, as the JAX package does for its compiled step; the port keeps the
same batch layout so the loss and the tests see the same arrays. Sample
dtypes are kept: a compact-wire batch stays uint8 RGB + int8 voxels, an
events-wire batch raw padded event streams.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from frn_tpu_torch.config import DatasetGeometry


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
        return _collate_events(samples, h, w, bsz, max_annots)
    for s in samples[1:]:
        if s["event"].dtype != samples[0]["event"].dtype or s["rgb"].dtype != samples[0]["rgb"].dtype:
            raise TypeError(
                "collate_fixed: heterogeneous sample dtypes (event "
                f"{s['event'].dtype} vs {samples[0]['event'].dtype}, rgb "
                f"{s['rgb'].dtype} vs {samples[0]['rgb'].dtype})"
            )
    ev_c = samples[0]["event"].shape[-1]
    events = np.zeros((bsz, h, w, ev_c), dtype=samples[0]["event"].dtype)
    for i, s in enumerate(samples):
        e = s["event"]
        events[i, : e.shape[0], : e.shape[1], :] = e[:h, :w]
    return {"event": events, **_rgb_annots(samples, h, w, bsz, max_annots)}


def _rgb_annots(samples, h: int, w: int, bsz: int, max_annots: int) -> Dict[str, np.ndarray]:
    rgbs = np.zeros((bsz, h, w, 3), dtype=samples[0]["rgb"].dtype)
    annots = np.full((bsz, max_annots, 5), -1.0, dtype=np.float32)
    mask = np.zeros((bsz,), dtype=bool)
    for i, s in enumerate(samples):
        r = s["rgb"]
        rgbs[i, : r.shape[0], : r.shape[1], :] = r[:h, :w]
        a = s["annot"]
        k = min(len(a), max_annots)
        if k:
            annots[i, :k] = a[:k]
        mask[i] = True
    return {"rgb": rgbs, "annot": annots, "sample_mask": mask}


def _collate_events(samples, h: int, w: int, bsz: int, max_annots: int) -> Dict[str, np.ndarray]:
    """The 'events' wire (``DSECDetDataset(events_wire=True)``): each sample's
    streams are already padded to the capacity, so they are stacked; pad rows
    carry zero valid events. The batch has no 'event' key: the train step
    voxelizes on the device (``ops/voxelize.voxelize_events_batched``)."""
    cap = samples[0]["event_x"].shape[0]
    out = {"event_x": np.zeros((bsz, cap), np.int16),
           "event_y": np.zeros((bsz, cap), np.int16),
           "event_t": np.zeros((bsz, cap), np.int32),
           "event_p": np.zeros((bsz, cap), np.int8),
           "event_n": np.zeros((bsz,), np.int32)}
    for i, s in enumerate(samples):
        for key in ("event_x", "event_y", "event_t", "event_p"):
            out[key][i] = s[key]
        out["event_n"][i] = s["event_n"]
    out.update(_rgb_annots(samples, h, w, bsz, max_annots))
    return out
