"""Native COCOeval-protocol evaluator (pycocotools matching semantics).

A copy of ``frn_tpu/eval/coco_protocol.py``, with ``evaluate_coco`` over the
port's ``collect_detections``. It re-implements the bbox evaluation protocol
the reference reaches through pycocotools (coco_eval.py:6-84): per-category x
IoU-threshold (0.50:0.05:0.95) x area-range (all/small/medium/large) x maxDets
(1/10/100) greedy matching, 101-point interpolated precision, and the 12-number summary (AP, AP50, AP75, APs/m/l,
AR@1/10/100, ARs/m/l). No pycocotools dependency: pure numpy over the same
detection lists the VOC/csv_eval evaluators consume.

Semantics mirrored from pycocotools.cocoeval.COCOeval (bbox iouType):
  * detections sorted by score (stable), truncated to maxDets per image;
  * ground truths sorted ignored-last; a detection greedily takes the best-IoU
    not-yet-matched gt at or above the threshold, allowed to *switch to* an
    ignored gt only if no valid one reached the threshold;
  * crowd gts may match many detections (IoU uses dt-area denominator);
  * unmatched detections outside the area range are ignored (not FPs);
  * precision envelope evaluated at 101 recall points, AP = mean;
    categories with no ground truth are excluded (-1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xyxy(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU (D, G); crowd gt uses the detection area as the denominator
    (pycocotools maskUtils.iou semantics for iscrowd=1)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), np.float64)
    d = dt[:, None, :]
    g = gt[None, :, :]
    iw = np.clip(np.minimum(d[..., 2], g[..., 2]) - np.maximum(d[..., 0], g[..., 0]), 0, None)
    ih = np.clip(np.minimum(d[..., 3], g[..., 3]) - np.maximum(d[..., 1], g[..., 1]), 0, None)
    inter = iw * ih
    area_d = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :], area_d[:, None], union)
    return inter / np.maximum(union, 1e-12)


def _evaluate_img(dt_boxes, dt_scores, gt_boxes, gt_crowd, area_rng, max_det):
    """One (image, category, areaRng, maxDet) cell -> match/ignore arrays.

    Returns dict with dtMatches/dtIgnore (T, D), gtIgnore (G,), dtScores (D,).
    """
    T = len(IOU_THRS)
    gt_area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
    gt_ig = gt_crowd | (gt_area < area_rng[0]) | (gt_area > area_rng[1])
    # gts sorted: not-ignored first (stable)
    gt_order = np.argsort(gt_ig, kind="stable")
    gt_boxes = gt_boxes[gt_order]
    gt_crowd = gt_crowd[gt_order]
    gt_ig = gt_ig[gt_order]

    dt_order = np.argsort(-dt_scores, kind="stable")[:max_det]
    dt_boxes = dt_boxes[dt_order]
    dt_scores = dt_scores[dt_order]

    ious = _iou_xyxy(dt_boxes, gt_boxes, gt_crowd)
    D, G = len(dt_boxes), len(gt_boxes)
    dtm = np.zeros((T, D), np.int64)  # 1 + matched gt index, 0 = unmatched
    gtm = np.zeros((T, G), np.int64)
    dt_ig = np.zeros((T, D), bool)
    for t, thr in enumerate(IOU_THRS):
        thr = min(thr, 1 - 1e-10)
        for d in range(D):
            best_iou = thr
            m = -1
            for g in range(G):
                if gtm[t, g] > 0 and not gt_crowd[g]:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[g]:
                    break  # remaining gts are all ignored; keep the valid match
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                m = g
            if m == -1:
                continue
            dt_ig[t, d] = gt_ig[m]
            dtm[t, d] = m + 1
            gtm[t, m] = d + 1
    dt_area = (dt_boxes[:, 2] - dt_boxes[:, 0]) * (dt_boxes[:, 3] - dt_boxes[:, 1])
    dt_out = (dt_area < area_rng[0]) | (dt_area > area_rng[1])
    dt_ig |= (dtm == 0) & dt_out[None, :]
    return {
        "dtMatches": dtm,
        "dtIgnore": dt_ig,
        "dtScores": dt_scores,
        "gtIgnore": gt_ig,
    }


@dataclasses.dataclass
class CocoEvalResult:
    # precision[t, r, k, a, m] / recall[t, k, a, m]; -1 where no ground truth
    precision: np.ndarray
    recall: np.ndarray
    stats: Dict[str, float]

    def summary_lines(self) -> List[str]:
        fmt = " Average {:9s} (AP) @[ IoU={:9s} | area={:6s} | maxDets={:3d} ] = {:0.3f}"
        names = [
            ("AP", "Precision", "0.50:0.95", "all", 100),
            ("AP50", "Precision", "0.50", "all", 100),
            ("AP75", "Precision", "0.75", "all", 100),
            ("APs", "Precision", "0.50:0.95", "small", 100),
            ("APm", "Precision", "0.50:0.95", "medium", 100),
            ("APl", "Precision", "0.50:0.95", "large", 100),
            ("AR1", "Recall", "0.50:0.95", "all", 1),
            ("AR10", "Recall", "0.50:0.95", "all", 10),
            ("AR100", "Recall", "0.50:0.95", "all", 100),
            ("ARs", "Recall", "0.50:0.95", "small", 100),
            ("ARm", "Recall", "0.50:0.95", "medium", 100),
            ("ARl", "Recall", "0.50:0.95", "large", 100),
        ]
        return [
            fmt.format(kind, iou, area, md, self.stats[key])
            for key, kind, iou, area, md in names
        ]


def evaluate_coco_protocol(
    detections: Sequence[Sequence[np.ndarray]],
    annotations: Sequence[Sequence[np.ndarray]],
    num_classes: Optional[int] = None,
    crowd: Optional[Sequence[Sequence[np.ndarray]]] = None,
) -> CocoEvalResult:
    """Full COCOeval protocol over per-image, per-class detection arrays.

    detections[i][k]: (D, 5) [x1, y1, x2, y2, score] for image i, class k
    annotations[i][k]: (G, 4) gt boxes; crowd[i][k]: optional (G,) bool flags.
    """
    num_images = len(detections)
    if num_classes is None:
        num_classes = len(detections[0]) if num_images else 0
    T, R = len(IOU_THRS), len(REC_THRS)
    K, A, M = num_classes, len(AREA_RNG), len(MAX_DETS)
    precision = -np.ones((T, R, K, A, M))
    recall = -np.ones((T, K, A, M))

    for k in range(K):
        per_img = []
        for i in range(num_images):
            dt = np.asarray(detections[i][k], np.float64).reshape(-1, 5)
            gt = np.asarray(annotations[i][k], np.float64).reshape(-1, 4)
            cr = (
                np.asarray(crowd[i][k], bool).reshape(-1)
                if crowd is not None
                else np.zeros(len(gt), bool)
            )
            per_img.append((dt[:, :4], dt[:, 4], gt, cr))

        for a, rng in enumerate(AREA_RNG.values()):
            for m, max_det in enumerate(MAX_DETS):
                cells = [
                    _evaluate_img(db, ds, gb, cr, rng, max_det)
                    for (db, ds, gb, cr) in per_img
                ]
                scores = np.concatenate([c["dtScores"] for c in cells])
                order = np.argsort(-scores, kind="stable")
                dtm = np.concatenate([c["dtMatches"] for c in cells], axis=1)[:, order]
                dt_ig = np.concatenate([c["dtIgnore"] for c in cells], axis=1)[:, order]
                gt_ig = np.concatenate([c["gtIgnore"] for c in cells])
                npig = int(np.sum(~gt_ig))
                if npig == 0:
                    continue
                tps = (dtm > 0) & ~dt_ig
                fps = (dtm == 0) & ~dt_ig
                tp_sum = np.cumsum(tps, axis=1, dtype=np.float64)
                fp_sum = np.cumsum(fps, axis=1, dtype=np.float64)
                for t in range(T):
                    tp, fp = tp_sum[t], fp_sum[t]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[t, k, a, m] = rc[-1] if nd else 0.0
                    q = np.zeros(R)
                    # precision envelope (monotone from the right)
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    for ri, pi in enumerate(inds):
                        if pi < nd:
                            q[ri] = pr[pi]
                    precision[t, :, k, a, m] = q

    def _mean(x):
        x = x[x > -1]
        return float(np.mean(x)) if x.size else -1.0

    a_all = list(AREA_RNG).index("all")
    m100 = MAX_DETS.index(100)
    stats = {
        "AP": _mean(precision[:, :, :, a_all, m100]),
        "AP50": _mean(precision[0, :, :, a_all, m100]),
        "AP75": _mean(precision[5, :, :, a_all, m100]),
        "APs": _mean(precision[:, :, :, list(AREA_RNG).index("small"), m100]),
        "APm": _mean(precision[:, :, :, list(AREA_RNG).index("medium"), m100]),
        "APl": _mean(precision[:, :, :, list(AREA_RNG).index("large"), m100]),
        "AR1": _mean(recall[:, :, a_all, MAX_DETS.index(1)]),
        "AR10": _mean(recall[:, :, a_all, MAX_DETS.index(10)]),
        "AR100": _mean(recall[:, :, a_all, m100]),
        "ARs": _mean(recall[:, :, list(AREA_RNG).index("small"), m100]),
        "ARm": _mean(recall[:, :, list(AREA_RNG).index("medium"), m100]),
        "ARl": _mean(recall[:, :, list(AREA_RNG).index("large"), m100]),
    }
    return CocoEvalResult(precision=precision, recall=recall, stats=stats)


def evaluate_coco(dataset, infer_fn, config, batch_size: int = 8,
                  verbose: bool = False) -> CocoEvalResult:
    """Reference-equivalent entry (coco_eval.py:6): run the detector over the
    dataset and score with the COCOeval protocol."""
    from frn_tpu_torch.eval.detections import collect_annotations, collect_detections

    dets, _ = collect_detections(
        dataset, infer_fn, config, batch_size=batch_size, verbose=verbose
    )
    annots = collect_annotations(dataset)
    res = evaluate_coco_protocol(dets, annots, num_classes=dataset.num_classes())
    for line in res.summary_lines():
        print(line)
    return res
