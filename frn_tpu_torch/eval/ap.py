"""Average-precision computation (host numpy).

A copy of ``frn_tpu/eval/ap.py`` (the port imports nothing of the JAX
package), which re-implements the reference evaluators (csv_eval.py):
PASCAL-VOC AP@0.5 (`evaluate`) and the COCO-style mean over IoU 0.50:0.05:0.95
(`evaluate_coco_map`), preserving their exact matching rules:

  * detections are processed per image in stored (score-sorted) order; a detection
    is a TP at threshold tau if its best-overlap annotation has IoU >= tau and that
    annotation is not already matched at tau, else FP (csv_eval.py:240-258)
  * PR curve built over dataset-wide score-descending order; AP = area under the
    precision envelope at recall change points (csv_eval.py:39-63)
  * classes without annotations score AP 0 (csv_eval.py:261)

Inputs are `all_detections[image][class] -> (n, 5) [x1,y1,x2,y2,score]` and
`all_annotations[image][class] -> (m, 4)`, same structure as the reference.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np


def compute_overlap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (K,4) -> (N,K) IoU; eps-clamped union (csv_eval.py:12-37)."""
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = np.minimum(np.expand_dims(a[:, 2], 1), b[:, 2]) - np.maximum(
        np.expand_dims(a[:, 0], 1), b[:, 0]
    )
    ih = np.minimum(np.expand_dims(a[:, 3], 1), b[:, 3]) - np.maximum(
        np.expand_dims(a[:, 1], 1), b[:, 1]
    )
    iw = np.maximum(iw, 0)
    ih = np.maximum(ih, 0)
    ua = np.expand_dims((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]), 1) + area - iw * ih
    ua = np.maximum(ua, np.finfo(np.float64).eps)
    return (iw * ih) / ua


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Area under the precision envelope (csv_eval.py:39-63)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _match_detections(
    all_detections, all_annotations, label: int, iou_thresholds: Sequence[float]
):
    """Greedy TP/FP matching for one class (csv_eval.py:240-258 rules).

    Returns (scores, fps, tps, num_annotations) where fps/tps are per-threshold
    0/1 lists aligned with scores (stored detection order, per image).
    """
    num_images = len(all_detections)
    num_t = len(iou_thresholds)
    fps = [[] for _ in range(num_t)]
    tps = [[] for _ in range(num_t)]
    scores: List[float] = []
    num_annotations = 0.0

    for i in range(num_images):
        detections = all_detections[i][label]
        annotations = all_annotations[i][label]
        num_annotations += annotations.shape[0]
        detected = [set() for _ in range(num_t)]

        for d in detections:
            scores.append(d[4])
            if annotations.shape[0] == 0:
                for k in range(num_t):
                    fps[k].append(1)
                    tps[k].append(0)
                continue
            overlaps = compute_overlap(np.expand_dims(d, 0), annotations)
            assigned = int(np.argmax(overlaps, axis=1)[0])
            max_overlap = overlaps[0, assigned]
            for k, tau in enumerate(iou_thresholds):
                if max_overlap >= tau and assigned not in detected[k]:
                    fps[k].append(0)
                    tps[k].append(1)
                    detected[k].add(assigned)
                else:
                    fps[k].append(1)
                    tps[k].append(0)

    return scores, fps, tps, num_annotations


def precision_recall_curve(
    all_detections, all_annotations, label: int, iou_threshold: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """Dataset-wide PR curve for one class at one IoU threshold."""
    scores, fps, tps, num_annotations = _match_detections(
        all_detections, all_annotations, label, [iou_threshold]
    )
    if num_annotations == 0 or not scores:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(-np.asarray(scores))
    fp = np.cumsum(np.asarray(fps[0], dtype=np.float64)[order])
    tp = np.cumsum(np.asarray(tps[0], dtype=np.float64)[order])
    recall = tp / num_annotations
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision


def average_precisions(
    all_detections: List[List[np.ndarray]],
    all_annotations: List[List[np.ndarray]],
    num_classes: int,
    iou_thresholds: Sequence[float],
) -> Dict[int, List[float]]:
    """Per-class AP at each IoU threshold. Core of both reference evaluators."""
    out: Dict[int, List[float]] = {}

    for label in range(num_classes):
        num_t = len(iou_thresholds)
        scores, fps, tps, num_annotations = _match_detections(
            all_detections, all_annotations, label, iou_thresholds
        )

        if num_annotations == 0:
            out[label] = [0.0] * num_t
            continue

        order = np.argsort(-np.asarray(scores))
        aps = []
        for k in range(num_t):
            fp = np.cumsum(np.asarray(fps[k], dtype=np.float64)[order])
            tp = np.cumsum(np.asarray(tps[k], dtype=np.float64)[order])
            recall = tp / num_annotations
            precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
            aps.append(compute_ap(recall, precision))
        out[label] = aps

    return out


def plot_pr_curves(
    all_detections,
    all_annotations,
    num_classes: int,
    save_path: str,
    label_to_name=None,
    iou_threshold: float = 0.5,
) -> List[str]:
    """Write per-class precision-recall jpgs, reference naming
    `{label_name}_precision_recall.jpg` (csv_eval.py:418-429). Returns paths.
    Needs matplotlib, imported here: without it this raises ImportError."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_pr_curves needs matplotlib, which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_path, exist_ok=True)
    paths = []
    for label in range(num_classes):
        recall, precision = precision_recall_curve(
            all_detections, all_annotations, label, iou_threshold
        )
        name = label_to_name(label) if label_to_name else str(label)
        fig, ax = plt.subplots()
        ax.plot(recall, precision)
        ax.set_xlabel("Recall")
        ax.set_ylabel("Precision")
        ax.set_title("Precision Recall curve")
        out = os.path.join(save_path, f"{name}_precision_recall.jpg")
        fig.savefig(out)
        plt.close(fig)
        paths.append(out)
    return paths


def evaluate_voc(
    all_detections, all_annotations, num_classes: int, iou_threshold: float = 0.5
) -> Dict[int, Tuple[float, float]]:
    """PASCAL-VOC AP@tau: {label: (ap, num_annotations)} (csv_eval.py evaluate)."""
    aps = average_precisions(all_detections, all_annotations, num_classes, [iou_threshold])
    counts = {
        label: float(sum(all_annotations[i][label].shape[0] for i in range(len(all_annotations))))
        for label in range(num_classes)
    }
    return {label: (aps[label][0], counts[label]) for label in range(num_classes)}


def evaluate_coco_map(
    all_detections, all_annotations, num_classes: int
) -> Dict[int, List[float]]:
    """{label: [AP@0.50, AP@0.55, ..., AP@0.95]} (csv_eval.py evaluate_coco_map)."""
    taus = np.arange(0.5, 1.0, 0.05).tolist()
    return average_precisions(all_detections, all_annotations, num_classes, taus)


def summarize_coco(aps: Dict[int, List[float]], class_names=None) -> Dict[str, float]:
    """mAP@[.5:.95], mAP@.5, mAP@.75 + per-class means."""
    per_class = {k: float(np.mean(v)) for k, v in aps.items()}
    out = {
        "mAP": float(np.mean(list(per_class.values()))) if per_class else 0.0,
        "mAP50": float(np.mean([v[0] for v in aps.values()])) if aps else 0.0,
        "mAP75": float(np.mean([v[5] for v in aps.values()])) if aps and len(next(iter(aps.values()))) > 5 else 0.0,
    }
    for k, v in per_class.items():
        name = class_names[k] if class_names else str(k)
        out[f"AP_{name}"] = v
    return out


def save_detections(folder: str, all_detections, all_annotations) -> None:
    """Pickle cache, reference-compatible filenames (csv_eval.py:187-202)."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "detections.txt"), "wb") as f:
        pickle.dump(all_detections, f)
    with open(os.path.join(folder, "annotations.txt"), "wb") as f:
        pickle.dump(all_annotations, f)


def load_detections(folder: str):
    with open(os.path.join(folder, "detections.txt"), "rb") as f:
        all_detections = pickle.load(f)
    with open(os.path.join(folder, "annotations.txt"), "rb") as f:
        all_annotations = pickle.load(f)
    return all_detections, all_annotations
