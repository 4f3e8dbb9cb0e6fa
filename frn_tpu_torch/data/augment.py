"""Raw-event-set augmentations (counterpart of ``frn_tpu/data/augment.py``).

Re-implements the reference's torch_geometric transforms (retinanet/data/
augment.py: RandomHFlip, Crop, RandomCrop, RandomTranslate, RandomZoom with
numba-JIT bilinear event subsampling) as numpy functions over an event sample:

  sample = {x, y, t, p: (N,) event arrays,
            rgb: (H,W,3) float image or None,
            annot: (M,5) [x1,y1,x2,y2,class]}

The bilinear zoom subsampling (augment.py:13-36) runs through the native C++
kernel (``utils/native.py``, frn_event_subsample) with a literal python
fallback. Each random transform draws from its own ``np.random.default_rng``
seed, as the JAX package's does, so one seed draws the same transforms in
both. ``RandomZoom`` warps the RGB image in numpy (``zoom_image``), where the
JAX package calls OpenCV's ``warpAffine``: no OpenCV is needed. Like the
reference, these operate BEFORE voxelization; they are exposed as an
optional ``BatchLoader`` transform.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from frn_tpu_torch.utils.native import native_event_subsample


def _subsample_python(pos: np.ndarray, polarity: np.ndarray, height: int, width: int,
                      threshold: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Literal replica of the numba kernels (augment.py:13-36)."""
    pos = pos.astype(np.float32).copy()
    count = np.zeros((height, width), np.float32)
    mask = np.zeros(len(pos), bool)

    def add_event(x, y, xl, yl, p, i):
        if xl < 0 or xl >= width or yl < 0 or yl >= height:
            return
        count[yl, xl] += p * (1 - abs(x - xl)) * (1 - abs(y - yl))
        pol = 1.0 if count[yl, xl] > 0 else -1.0
        if pol * count[yl, xl] > threshold:
            count[yl, xl] -= pol * threshold
            mask[i] = True
            pos[i, 0] = xl
            pos[i, 1] = yl

    for i in range(len(pos)):
        x, y = pos[i]
        x0, y0 = int(x), int(y)
        p = polarity[i]
        add_event(x, y, x0, y0, p, i)
        add_event(x, y, x0 + 1, y0, p, i)
        add_event(x, y, x0, y0 + 1, p, i)
        add_event(x, y, x0 + 1, y0 + 1, p, i)
    return pos, mask


def bilinear_event_subsample(pos, polarity, height, width, threshold=1.0):
    out = native_event_subsample(pos, polarity, height, width, threshold)
    if out is not None:
        return out
    return _subsample_python(pos, polarity, height, width, threshold)


def zoom_image(img: np.ndarray, z: float, cx: float, cy: float) -> np.ndarray:
    """``img`` scaled by ``z`` about (cx, cy), as OpenCV's
    ``warpAffine(img, getRotationMatrix2D((cx, cy), 0, z), (w, h))`` computes
    it: each output pixel bilinear at its inverse map's coordinates
    (cx + (x - cx) / z, cy + (y - cy) / z), in float64 and not rounded to a
    grid, with zeros outside the frame; the input's dtype (an integer image
    rounded and saturated)."""
    h, w = img.shape[:2]
    sx = cx + (np.arange(w, dtype=np.float64) - cx) / z
    sy = cy + (np.arange(h, dtype=np.float64) - cy) / z
    x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    fx, fy = sx - x0, sy - y0
    src = img.astype(np.float64)
    out = np.zeros(img.shape, np.float64)
    for yi, wy in ((y0, 1.0 - fy), (y0 + 1, fy)):
        wy = wy * ((yi >= 0) & (yi < h))
        yi = np.clip(yi, 0, h - 1)
        for xi, wx in ((x0, 1.0 - fx), (x0 + 1, fx)):
            wx = wx * ((xi >= 0) & (xi < w))
            weight = wy[:, None] * wx[None, :]
            if img.ndim == 3:
                weight = weight[..., None]
            out += weight * src[yi][:, np.clip(xi, 0, w - 1)]
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(img.dtype)


def _filter(sample: Dict, keep: np.ndarray) -> Dict:
    out = dict(sample)
    for k in ("x", "y", "t", "p"):
        out[k] = sample[k][keep]
    return out


class RandomHFlip:
    """Mirror events, image, and boxes horizontally with probability p."""

    def __init__(self, width: int, p: float = 0.5, seed: int = 0):
        self.width = width
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample: Dict) -> Dict:
        if self.rng.random() >= self.p:
            return sample
        out = dict(sample)
        out["x"] = self.width - 1 - sample["x"]
        if sample.get("rgb") is not None:
            out["rgb"] = np.ascontiguousarray(sample["rgb"][:, ::-1])
        annot = sample.get("annot")
        if annot is not None and len(annot):
            annot = annot.copy()
            x1 = annot[:, 0].copy()
            annot[:, 0] = self.width - annot[:, 2]
            annot[:, 2] = self.width - x1
            out["annot"] = annot
        return out


class Crop:
    """Keep only events/boxes inside a fixed window; blank the image outside."""

    def __init__(self, left: Tuple[int, int], right: Tuple[int, int]):
        self.left = np.asarray(left)
        self.right = np.asarray(right)

    def __call__(self, sample: Dict) -> Dict:
        x, y = sample["x"], sample["y"]
        keep = (
            (x >= self.left[0]) & (x <= self.right[0])
            & (y >= self.left[1]) & (y <= self.right[1])
        )
        out = _filter(sample, keep)
        if sample.get("rgb") is not None:
            img = sample["rgb"].copy()
            img[: self.left[1]] = 0
            img[self.right[1] :] = 0
            img[:, : self.left[0]] = 0
            img[:, self.right[0] :] = 0
            out["rgb"] = img
        annot = sample.get("annot")
        if annot is not None and len(annot):
            annot = annot.copy()
            annot[:, 0] = np.clip(annot[:, 0], self.left[0], self.right[0])
            annot[:, 2] = np.clip(annot[:, 2], self.left[0], self.right[0])
            annot[:, 1] = np.clip(annot[:, 1], self.left[1], self.right[1])
            annot[:, 3] = np.clip(annot[:, 3], self.left[1], self.right[1])
            keep_b = (annot[:, 2] - annot[:, 0] >= 1) & (annot[:, 3] - annot[:, 1] >= 1)
            out["annot"] = annot[keep_b]
        return out


class RandomCrop:
    """Random window crop of a fixed output size."""

    def __init__(self, height: int, width: int, out_height: int, out_width: int, seed: int = 0):
        self.hw = (height, width)
        self.out = (out_height, out_width)
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample: Dict) -> Dict:
        h, w = self.hw
        oh, ow = self.out
        x0 = int(self.rng.integers(0, max(w - ow, 0) + 1))
        y0 = int(self.rng.integers(0, max(h - oh, 0) + 1))
        cropped = Crop((x0, y0), (x0 + ow - 1, y0 + oh - 1))(sample)
        out = dict(cropped)
        out["x"] = cropped["x"] - x0
        out["y"] = cropped["y"] - y0
        annot = cropped.get("annot")
        if annot is not None and len(annot):
            annot = annot.copy()
            annot[:, [0, 2]] -= x0
            annot[:, [1, 3]] -= y0
            out["annot"] = annot
        if cropped.get("rgb") is not None:
            out["rgb"] = np.ascontiguousarray(
                cropped["rgb"][y0 : y0 + oh, x0 : x0 + ow]
            )
        return out


class RandomTranslate:
    """Shift events/boxes/image by a random offset, dropping what leaves the frame."""

    def __init__(self, height: int, width: int, max_shift: int = 20, seed: int = 0):
        self.hw = (height, width)
        self.max_shift = max_shift
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample: Dict) -> Dict:
        h, w = self.hw
        dx = int(self.rng.integers(-self.max_shift, self.max_shift + 1))
        dy = int(self.rng.integers(-self.max_shift, self.max_shift + 1))
        x = sample["x"] + dx
        y = sample["y"] + dy
        keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        out = _filter(sample, keep)
        out["x"], out["y"] = x[keep], y[keep]
        if sample.get("rgb") is not None:
            img = np.zeros_like(sample["rgb"])
            src = sample["rgb"]
            ys0, ys1 = max(0, dy), min(h, h + dy)
            xs0, xs1 = max(0, dx), min(w, w + dx)
            img[ys0:ys1, xs0:xs1] = src[ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx]
            out["rgb"] = img
        annot = sample.get("annot")
        if annot is not None and len(annot):
            annot = annot.copy()
            annot[:, [0, 2]] = np.clip(annot[:, [0, 2]] + dx, 0, w - 1)
            annot[:, [1, 3]] = np.clip(annot[:, [1, 3]] + dy, 0, h - 1)
            keep_b = (annot[:, 2] - annot[:, 0] >= 1) & (annot[:, 3] - annot[:, 1] >= 1)
            out["annot"] = annot[keep_b]
        return out


class RandomZoom:
    """Scale events/boxes/image about the frame center; zoom-in events outside the
    frame are dropped, zoom-out events are bilinear-subsampled (augment.py RandomZoom)."""

    def __init__(self, height: int, width: int, zoom_range=(0.8, 1.2), seed: int = 0):
        self.hw = (height, width)
        self.zoom_range = zoom_range
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample: Dict) -> Dict:
        h, w = self.hw
        z = float(self.rng.uniform(*self.zoom_range))
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        fx = (sample["x"] - cx) * z + cx
        fy = (sample["y"] - cy) * z + cy
        inside = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)

        pos = np.stack([fx[inside], fy[inside]], axis=1)
        pol = np.where(sample["p"][inside] > 0, 1.0, -1.0).astype(np.float32)
        out = _filter(sample, inside)
        if z < 1.0:  # zooming out densifies: subsample with charge threshold
            pos2, keep = bilinear_event_subsample(pos, pol, h, w)
            out = _filter(out, keep)
            out["x"] = pos2[keep, 0].astype(sample["x"].dtype)
            out["y"] = pos2[keep, 1].astype(sample["y"].dtype)
        else:
            out["x"] = np.round(pos[:, 0]).astype(sample["x"].dtype)
            out["y"] = np.round(pos[:, 1]).astype(sample["y"].dtype)

        if sample.get("rgb") is not None:
            out["rgb"] = zoom_image(sample["rgb"], z, cx, cy)
        annot = sample.get("annot")
        if annot is not None and len(annot):
            annot = annot.copy()
            annot[:, [0, 2]] = np.clip((annot[:, [0, 2]] - cx) * z + cx, 0, w - 1)
            annot[:, [1, 3]] = np.clip((annot[:, [1, 3]] - cy) * z + cy, 0, h - 1)
            keep_b = (annot[:, 2] - annot[:, 0] >= 1) & (annot[:, 3] - annot[:, 1] >= 1)
            out["annot"] = annot[keep_b]
        return out


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict) -> Dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


def default_augmentations(height: int, width: int, seed: int = 0) -> Compose:
    """Preset mirroring the reference's Augmentations list (augment.py:282-294)."""
    return Compose([
        RandomHFlip(width, p=0.5, seed=seed),
        RandomZoom(height, width, seed=seed + 1),
        RandomTranslate(height, width, max_shift=15, seed=seed + 2),
    ])
