"""Batched detection extraction for evaluation.

Counterpart of ``frn_tpu/eval/detections.py``: one call per batch runs the
forward, the decode, the clip and the class-wise NMS on the device and
returns fixed-size top-k detections; the host only slices the valid rows and
buckets them per class, in place of the reference's per-image host loop
(_get_detections, csv_eval.py:66-131).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from frn_tpu_torch.config import FrameworkConfig
from frn_tpu_torch.data.loader import BatchLoader, to_device
from frn_tpu_torch.entry import InferenceFn
from frn_tpu_torch.ops.voxelize import host_div, normalize_event_voxel_batched

WIRES = ("f32", "compact")


class EvalInferenceFn(InferenceFn):
    """(rgb, event) -> (scores (B, M), labels (B, M), boxes (B, M, 4)) on the
    model's device, with the input wire's dtype guards and, on the 'compact'
    wire, the input normalization on the device."""

    def __init__(self, model, config: FrameworkConfig, wire: str = "f32",
                 rgb_standardize: bool = False):
        super().__init__(model, config)
        self.wire = wire
        self.rgb_standardize = rgb_standardize
        self.device = self.anchors.device
        geo = config.geometry
        self.rgb_mean = torch.tensor(geo.rgb_mean, dtype=torch.float32, device=self.device)
        self.rgb_std = torch.tensor(geo.rgb_std, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def __call__(self, rgb: torch.Tensor, event: torch.Tensor):
        # a compact-wire batch fed to the f32 wire (or the reverse) would run
        # raw [0, 255] uint8 through the model, or divide [0, 1] floats by 255
        # again: both raise
        if self.wire == "compact":
            if rgb.dtype != torch.uint8 or event.dtype != torch.int8:
                raise TypeError(
                    f"wire='compact' expects uint8 RGB + int8 event voxels, got "
                    f"rgb={rgb.dtype} event={event.dtype}: pass a compact-wire "
                    "dataset or use wire='f32'")
            rgb = host_div(rgb.float(), 255.0)  # rounded as the host divides
            if self.rgb_standardize:
                rgb = (rgb - self.rgb_mean) / self.rgb_std
            event = normalize_event_voxel_batched(event.float())
        elif not (rgb.is_floating_point() and event.is_floating_point()):
            raise TypeError(
                f"wire='f32' got integer inputs (rgb={rgb.dtype}, event={event.dtype}): "
                "this looks like a compact-wire dataset; pass wire='compact' to "
                "make_inference_fn")
        return super().__call__(rgb, event)


def make_inference_fn(
    model,
    config: FrameworkConfig,
    mesh=None,
    wire: str = "f32",
    rgb_standardize: bool = False,
    input_format: str = "default",
) -> EvalInferenceFn:
    """(rgb, event) -> (scores (B, M), labels (B, M) int32, boxes (B, M, 4)),
    on the device of ``model`` (built by ``init_detector``, its weights loaded).

    ``wire='compact'`` moves the input normalization onto the device: batches
    arrive as uint8 RGB [0..255] + int8 raw polarity-count voxels, and the
    device applies /255 (and the dataset standardization iff
    ``rgb_standardize``) and the per-sample conditional tanh voxel squash
    (dsec_data.py:461-462 semantics); int8 clipping at +-127 is exact through
    the tanh saturation. ``wire='f32'`` takes the dataset's normalized floats.

    Not ported: ``mesh`` (data-parallel inference over several devices, A14)
    raises NotImplementedError; ``input_format='auto'`` raises too: it lets
    XLA choose the arguments' memory layouts, a compiler feature with no
    PyTorch counterpart.
    """
    if wire not in WIRES:
        raise ValueError(f"unknown wire {wire!r}")
    if input_format not in ("default", "auto"):
        raise ValueError(f"unknown input_format {input_format!r}")
    if input_format == "auto":
        raise NotImplementedError(
            "input_format='auto' is an XLA argument-layout feature with no PyTorch counterpart")
    if mesh is not None:
        raise NotImplementedError(
            "make_inference_fn(mesh=...): data-parallel evaluation over several devices "
            "is not ported yet (ROADMAP A14)")
    return EvalInferenceFn(model, config, wire, rgb_standardize)


def _rows_to_host(scores, labels, boxes) -> np.ndarray:
    """(B, M, 6) f32 [x1, y1, x2, y2, score, label] in one device -> host copy
    (the labels, small ints, are exact in f32)."""
    rows = torch.cat([boxes.float(), scores.float()[..., None], labels.float()[..., None]], dim=2)
    return rows.cpu().numpy()


def collect_detections(
    dataset,
    infer_fn: Callable,
    config: FrameworkConfig,
    batch_size: int = 8,
    num_threads: int = 8,
    max_detections: Optional[int] = None,
    verbose: bool = False,
) -> Tuple[List[List[np.ndarray]], float]:
    """Run the detector over a dataset.

    Returns (all_detections[image][class] -> (n,5) [x1,y1,x2,y2,score], elapsed_s).
    Detections are score-sorted (the device top-k emits descending order),
    matching the reference's per-image sort + top-100 (csv_eval.py:109-119).
    Batches are loaded by ``BatchLoader``'s threads and copied to
    ``infer_fn.device`` (the CPU if it has none) by ``to_device``; each
    batch's detections come back in one host copy.
    """
    num_classes = dataset.num_classes()
    cap = max_detections or config.eval.max_detections
    thr = config.eval.score_threshold
    device = getattr(infer_fn, "device", torch.device("cpu"))

    loader = BatchLoader(
        dataset, config.geometry, batch_size=batch_size, shuffle=False,
        num_threads=num_threads, max_annots=1,
    )

    all_detections: List[List[np.ndarray]] = [
        [np.zeros((0, 5), np.float32) for _ in range(num_classes)]
        for _ in range(len(dataset))
    ]

    t0 = time.perf_counter()
    index = 0
    for batch in loader:
        n_valid = int(batch["sample_mask"].sum())
        batch = to_device({"rgb": batch["rgb"], "event": batch["event"]}, device)
        rows = _rows_to_host(*infer_fn(batch["rgb"], batch["event"]))
        for b in range(n_valid):
            keep = rows[b, :, 4] > thr
            r = rows[b][keep][:cap]
            dets, labels = r[:, :5], r[:, 5]
            for c in range(num_classes):
                all_detections[index][c] = np.ascontiguousarray(dets[labels == c])
            index += 1
            if verbose and index % 100 == 0:
                print(f"{index}/{len(dataset)}", end="\r")
    elapsed = time.perf_counter() - t0
    return all_detections, elapsed


def collect_annotations(dataset) -> List[List[np.ndarray]]:
    """Ground truth per image per class (csv_eval.py _get_annotations)."""
    num_classes = dataset.num_classes()
    out = []
    for i in range(len(dataset)):
        ann = dataset.load_annotations(i)
        out.append([ann[ann[:, 4] == c, :4].copy() for c in range(num_classes)])
    return out
