"""Fixed-size class-aware NMS with a pooled decode (counterpart of ``frn_tpu/core/nms.py``).

Only the exact candidate pool is ported: torch has no ``approx_max_k``. The
exact top-k is a stable descending sort, so equal values keep ascending index
order, as ``jax.lax.top_k`` does (``torch.topk`` makes no promise on ties).
The whole batch runs at once, with batch and class as leading axes, where the
JAX package vmaps over them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from frn_tpu_torch.core.boxes import DEFAULT_STD, clip_boxes, decode_boxes, pairwise_iou

LOGIT_LO, LOGIT_HI = -3.4e38, 3.4e38  # finite sentinels of the logit-space pool


def exact_topk(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with jax.lax.top_k's order: descending, ties by
    ascending index."""
    if k > s.shape[-1]:
        raise ValueError(f"top-{k} of {s.shape[-1]} elements")
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def greedy_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep-mask over boxes sorted by descending score.

    boxes (..., T, 4), scores (..., T); scores <= 0 are padding and never kept.
    The same Gauss-Jacobi fixpoint as the JAX package,
        keep <- valid & !any_i(i < j & keep[i] & iou[i, j] > t),
    iterated until no row changes; it equals torchvision's sequential greedy NMS.
    """
    t = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    later = torch.ones(t, t, dtype=torch.bool, device=boxes.device).triu(diagonal=1)
    suppress_if_kept = (iou > iou_threshold) & later
    valid = scores > 0.0
    keep = valid
    for _ in range(t):
        new = valid & ~(keep.unsqueeze(-1) & suppress_if_kept).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def pooled_detection_postprocess(
    anchors: torch.Tensor,  # (A, 4)
    deltas: torch.Tensor,  # (B, A, 4) rows, or (B, HW, A_cell*4) flat36 maps
    scores: torch.Tensor,  # (B, A, K), or (B, K, A) with class_major
    image_shape: Tuple[int, int],
    std=DEFAULT_STD,
    score_threshold: float = 0.05,
    iou_threshold: float = 0.5,
    per_class_topk: int = 400,
    max_detections: int = 100,
    logits: bool = False,
    class_major: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class score pool, decode of the pool only, greedy NMS, global top-k.

    Returns (scores (B, M) f32, labels (B, M) int32, boxes (B, M, 4) f32),
    M = max_detections; empty slots have score 0 and label -1. With
    ``logits`` the threshold applies in logit space and the sigmoid runs on the
    pooled winners only, in f32.
    """
    s_all = scores if class_major else scores.transpose(1, 2)  # (B, K, A)
    b, num_classes, _ = s_all.shape
    t = per_class_topk
    dev = s_all.device
    if logits:
        if score_threshold <= 0.0:
            thr = LOGIT_LO
        elif score_threshold >= 1.0:
            thr = LOGIT_HI
        else:
            thr = math.log(score_threshold / (1.0 - score_threshold))
        lo = torch.tensor(LOGIT_LO, dtype=s_all.dtype, device=dev)
        thr = torch.tensor(thr, dtype=s_all.dtype, device=dev)
        vals, idx = exact_topk(torch.where(s_all > thr, s_all, lo), t)
        pool = torch.where(vals > lo, torch.sigmoid(vals.float()), 0.0)
    else:
        thr = torch.tensor(score_threshold, dtype=s_all.dtype, device=dev)
        vals, idx = exact_topk(torch.where(s_all > thr, s_all, torch.zeros_like(s_all)), t)
        pool = vals.float()

    flat_idx = idx.reshape(b, -1, 1)  # (B, K*T, 1)
    if deltas.shape[-1] != 4:
        # flat36: the candidate's cell row, then its anchor's 4-delta slot
        a_cell = deltas.shape[-1] // 4
        rows = torch.gather(deltas, 1, (flat_idx // a_cell).expand(-1, -1, deltas.shape[-1]))
        slot = (flat_idx % a_cell) * 4 + torch.arange(4, device=dev)
        d = torch.gather(rows, 2, slot)
    else:
        d = torch.gather(deltas, 1, flat_idx.expand(-1, -1, 4))
    d = d.reshape(b, num_classes, t, 4).float()
    boxes = clip_boxes(decode_boxes(anchors[idx], d, std=std), image_shape)  # (B, K, T, 4)
    keep = greedy_nms_mask(boxes, pool, iou_threshold)
    cls_scores = torch.where(keep, pool, 0.0)

    flat_scores = cls_scores.reshape(b, -1)
    flat_boxes = boxes.reshape(b, -1, 4)
    flat_labels = torch.arange(num_classes, dtype=torch.int32, device=dev).repeat_interleave(t)
    k = min(max_detections, flat_scores.shape[1])
    top_vals, top_idx = exact_topk(flat_scores, k)
    out_boxes = torch.gather(flat_boxes, 1, top_idx.unsqueeze(-1).expand(-1, -1, 4))
    out_labels = torch.where(top_vals > 0.0, flat_labels[top_idx], -1).to(torch.int32)
    if k < max_detections:
        pad = max_detections - k
        top_vals = torch.nn.functional.pad(top_vals, (0, pad))
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_labels = torch.nn.functional.pad(out_labels, (0, pad), value=-1)
    return top_vals, out_labels, out_boxes
