"""High-level evaluation drivers: clean eval, fps measurement, corruption sweeps.

Counterpart of ``frn_tpu/eval/evaluator.py``, over the port's modules. It
mirrors the reference test drivers (test_dsec.py / test_ddd17.py): clean
COCO/VOC mAP with detection caching, end-to-end fps over the eval set, and the
corruption protocol (groups of types x severities 1..5). Corrupted images come
either from pre-generated folders (reference behavior) or on-the-fly via
frn_tpu_torch.ops.corruption.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from frn_tpu_torch.config import FrameworkConfig
from frn_tpu_torch.data.transforms import normalize_rgb, resize_to_geometry
from frn_tpu_torch.eval.ap import (
    evaluate_coco_map,
    load_detections,
    save_detections,
    summarize_coco,
)
from frn_tpu_torch.eval.detections import collect_annotations, collect_detections
from frn_tpu_torch.ops.corruption import ALL_CORRUPTIONS, CORRUPTION_GROUPS, SEVERITIES, corrupt


@dataclasses.dataclass
class EvalResult:
    per_class_aps: Dict[int, List[float]]  # label -> APs over IoU 0.50:0.05:0.95
    summary: Dict[str, float]
    fps: float
    elapsed_s: float


def evaluate_dataset(
    dataset,
    infer_fn: Callable,
    config: FrameworkConfig,
    batch_size: int = 8,
    save_folder: Optional[str] = None,
    load_cached: bool = False,
    verbose: bool = False,
) -> EvalResult:
    """COCO-style mAP over a dataset with the reference's caching protocol."""
    if load_cached and save_folder:
        all_detections, all_annotations = load_detections(save_folder)
        elapsed = 0.0
    else:
        all_detections, elapsed = collect_detections(
            dataset, infer_fn, config, batch_size=batch_size, verbose=verbose
        )
        all_annotations = collect_annotations(dataset)
        if save_folder:
            save_detections(save_folder, all_detections, all_annotations)

    aps = evaluate_coco_map(all_detections, all_annotations, dataset.num_classes())
    names = [dataset.label_to_name(i) for i in range(dataset.num_classes())]
    summary = summarize_coco(aps, names)
    fps = len(dataset) / elapsed if elapsed > 0 else 0.0
    return EvalResult(aps, summary, fps, elapsed)


class CorruptedDataset:
    """Wrap a CSV dataset, corrupting RGB on the fly (pre-normalization).

    The reference evaluates corruption folders written to disk; this wrapper
    reproduces that protocol without the pre-generated data. Corruption operates on
    the raw [0,1] image, then dataset normalization statistics are applied.
    """

    def __init__(self, dataset, corruption: str, severity: int):
        self.dataset = dataset
        self.corruption = corruption
        self.severity = severity

    def __len__(self):
        return len(self.dataset)

    def num_classes(self):
        return self.dataset.num_classes()

    def label_to_name(self, label):
        return self.dataset.label_to_name(label)

    def load_annotations(self, i):
        return self.dataset.load_annotations(i)

    def __getitem__(self, idx):
        ds = self.dataset
        event = ds.load_event(idx)
        rgb = ds.load_rgb(idx)
        rgb = corrupt(rgb, self.corruption, self.severity)
        rgb, _ = resize_to_geometry(rgb, ds.geometry)
        if ds.normalize:
            rgb = normalize_rgb(rgb, ds.geometry)
        return {
            "event": event.astype(np.float32),
            "rgb": rgb.astype(np.float32),
            "annot": ds.load_annotations(idx),
        }


def corrupted_folder_dataset(dataset, corruption_root: str, corruption: str,
                             severity: int):
    """Reference-compatible folder input: the pre-generated corrupted image tree
    replaces the dataset's RGB root (test_dsec.py:133-139 swaps args.root_img to
    <corruptions>/<type>/severity_<s>), keeping labels/events untouched."""
    import copy

    folder = os.path.join(corruption_root, corruption, f"severity_{severity}")
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"corruption folder missing: {folder}")
    ds = copy.copy(dataset)
    ds.img_dir = folder
    return ds


def corruption_sweep(
    dataset,
    infer_fn: Callable,
    config: FrameworkConfig,
    corruption_group: Optional[int] = None,
    corruptions: Optional[List[str]] = None,
    severities=SEVERITIES,
    batch_size: int = 8,
    save_root: Optional[str] = None,
    corruption_root: Optional[str] = None,
    verbose: bool = False,
) -> Dict[str, Dict[int, List[float]]]:
    """Run the corruption protocol.

    Corrupted inputs come from `corruption_root` (pre-generated folders, the
    reference's input path — directly comparable to published robustness tables)
    when given, else are synthesized on the fly by ops/corruption.py (procedural
    ImageNet-C re-implementation; severity trends match but absolute mAP is not
    guaranteed comparable to folders generated with the original `imagecorruptions`
    package — see PARITY.md).

    Returns {corruption: {severity: per-class mean APs}} — per-class AP averaged
    over the 10 IoU thresholds, like the reference's printed summaries
    (test_dsec.py:176-183).
    """
    if corruptions is None:
        corruptions = (
            CORRUPTION_GROUPS[corruption_group]
            if corruption_group is not None
            else ALL_CORRUPTIONS
        )
    results: Dict[str, Dict[int, List[float]]] = {}
    for corruption in corruptions:
        per_sev: Dict[int, List[float]] = {}
        for severity in severities:
            if corruption_root:
                ds = corrupted_folder_dataset(
                    dataset, corruption_root, corruption, severity
                )
            else:
                ds = CorruptedDataset(dataset, corruption, severity)
            folder = (
                os.path.join(save_root, corruption, f"severity_{severity}")
                if save_root
                else None
            )
            res = evaluate_dataset(
                ds, infer_fn, config, batch_size=batch_size, save_folder=folder,
                verbose=verbose,
            )
            per_sev[severity] = [
                float(np.mean(res.per_class_aps[c]))
                for c in range(dataset.num_classes())
            ]
            if verbose:
                print(f"{corruption} s{severity}: mAP={res.summary['mAP']:.4f}")
        results[corruption] = per_sev
    return results
