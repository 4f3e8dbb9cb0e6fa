"""Fixed-size class-aware NMS, dense or with a pooled decode (counterpart of
``frn_tpu/core/nms.py``).

Per class a top-k candidate pool, greedy NMS over it, then the global top-k
across classes; the whole batch at once, with batch and class as leading
axes where the JAX package vmaps over them.

The per-class candidate pool is ``jax.lax.top_k``'s result: descending in
the total order of the floats (-0.0 below +0.0), ties by ascending index
(``torch.topk`` makes no promise on ties). ``exact_topk`` is a stable sort of
an order-isomorphic integer key; ``exact_topk_two_stage``, the pool, takes
the top-k of each of 64 blocks, then the top-k of the block winners, the
same result in less time on long rows.

The JAX package's three pools of ``EvalConfig`` (``approx_topk``, and
``exact_pool`` 'two_stage' or 'radix') are that one pool here:

* ``approx_max_k`` off a TPU is that result. The JAX source says "This
  package only optimizes the TPU backend. For other device types it
  fallbacks to sort and slice" (``jax/_src/lax/ann.py``); on the CPU its f32
  result equals ``lax.top_k``'s, values and indices, ties included.
* the radix select is a TPU algorithm of the same top-k, not ported. The
  JAX package's ranks -0.0 and +0.0 as equal, so where the two straddle the
  k-th value (a logit pool can hold both) its tie order differs from
  ``lax.top_k``'s, which the port keeps.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from frn_tpu_torch.core.boxes import DEFAULT_STD, clip_boxes, decode_boxes, pairwise_iou

LOGIT_LO, LOGIT_HI = -3.4e38, 3.4e38  # finite sentinels of the logit-space pool
_INT_OF = {torch.float32: (torch.int32, 0x7FFFFFFF), torch.bfloat16: (torch.int16, 0x7FFF)}


def _order_key(s: torch.Tensor) -> torch.Tensor:
    """An integer key of f32 or bf16 whose order is the floats' total order
    (-0.0 < +0.0): the bits as a signed integer, the magnitude bits flipped
    where the sign bit is set. Integers are their own key."""
    if s.dtype not in _INT_OF:
        return s
    idtype, low = _INT_OF[s.dtype]
    bits = s.contiguous().view(idtype)
    return torch.where(bits < 0, bits ^ low, bits)


def exact_topk(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k along the last axis: descending in the total order of the
    floats, ties by ascending index."""
    if k > s.shape[-1]:
        raise ValueError(f"top-{k} of {s.shape[-1]} elements")
    _, idx = torch.sort(_order_key(s), dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(s, -1, idx), idx


def exact_topk_two_stage(s: torch.Tensor, k: int, num_blocks: int = 64,
                         nonnegative: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis by per-block top-k, then the top-k of
    the ``num_blocks * k`` block winners.

    An element of the global top-k is in the top-k of its own block, so this
    is ``exact_topk``, ties included: blocks are contiguous index ranges taken
    block-major, so the second stage sees equal values in ascending index
    order. Both stages sort one integer key of the row (``_order_key``;
    ``nonnegative``, every element >= +0.0 and no -0.0, takes the int32 bits
    of f32 values as it is, as the JAX package does), and the values are
    gathered once at the end.
    """
    a = s.shape[-1]
    if num_blocks <= 1 or num_blocks * k >= a:
        return exact_topk(s, k)
    key = (s.contiguous().view(torch.int32) if nonnegative and s.dtype == torch.float32
           else _order_key(s))
    block_len = -(-a // num_blocks)
    pad = num_blocks * block_len - a
    if pad:
        fill = -math.inf if key.dtype.is_floating_point else torch.iinfo(key.dtype).min
        key = torch.nn.functional.pad(key, (0, pad), value=fill)
    lead = s.shape[:-1]
    blocks = key.reshape(*lead, num_blocks, block_len)
    _, idx = torch.sort(blocks, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]  # (..., nb, k)
    winners = torch.gather(blocks, -1, idx).reshape(*lead, -1)
    flat_idx = (idx + torch.arange(num_blocks, device=s.device)[:, None] * block_len)
    _, pos = torch.sort(winners, dim=-1, descending=True, stable=True)
    idx = torch.gather(flat_idx.reshape(*lead, -1), -1, pos[..., :k])
    return torch.gather(s, -1, idx), idx


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


def _select(cls_scores: torch.Tensor, cls_boxes: torch.Tensor, max_detections: int):
    """The global top-k over classes of NMS-kept pool scores (B, K, T) and
    their boxes (B, K, T, 4): fixed-size (scores (B, M), labels (B, M) int32,
    boxes (B, M, 4)); empty slots have score 0 and label -1."""
    b, num_classes, t = cls_scores.shape
    flat_scores = cls_scores.reshape(b, -1)
    flat_boxes = cls_boxes.reshape(b, -1, 4)
    flat_labels = torch.arange(num_classes, dtype=torch.int32,
                               device=cls_scores.device).repeat_interleave(t)
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
        vals, idx = exact_topk_two_stage(torch.where(s_all > thr, s_all, lo), t)
        pool = torch.where(vals > lo, torch.sigmoid(vals.float()), 0.0)
    else:
        thr = torch.tensor(score_threshold, dtype=s_all.dtype, device=dev)
        # where(> thr, s, +0.0) is nonnegative with no -0.0
        vals, idx = exact_topk_two_stage(torch.where(s_all > thr, s_all, torch.zeros_like(s_all)),
                                         t, nonnegative=True)
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
    return _select(torch.where(keep, pool, 0.0), boxes, max_detections)


def batched_detection_postprocess(
    boxes: torch.Tensor,  # (B, A, 4) decoded and clipped
    scores: torch.Tensor,  # (B, A, K) per-class sigmoid scores
    score_threshold: float = 0.05,
    iou_threshold: float = 0.5,
    per_class_topk: int = 400,
    max_detections: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense postprocess: per class the scores above ``score_threshold``
    (strict), a top-``per_class_topk`` pool of them, greedy NMS over its
    boxes, then the global top-``max_detections`` across classes. Returns
    (scores (B, M), labels (B, M) int32, boxes (B, M, 4)); empty slots have
    score 0 and label -1."""
    s_all = scores.transpose(1, 2)  # (B, K, A)
    b, num_classes, _ = s_all.shape
    t = per_class_topk
    # where(> thr, s, +0.0) is nonnegative with no -0.0
    s = torch.where(s_all > score_threshold, s_all, torch.zeros_like(s_all))
    vals, idx = exact_topk_two_stage(s, t, nonnegative=True)
    cls_boxes = torch.gather(boxes, 1, idx.reshape(b, -1, 1).expand(-1, -1, 4))
    cls_boxes = cls_boxes.reshape(b, num_classes, t, 4)
    keep = greedy_nms_mask(cls_boxes, vals, iou_threshold)
    return _select(torch.where(keep, vals, 0.0), cls_boxes, max_detections)


def class_aware_nms(
    boxes: torch.Tensor,  # (A, 4) decoded and clipped, shared across classes
    scores: torch.Tensor,  # (A, K) per-class sigmoid scores
    score_threshold: float = 0.05,
    iou_threshold: float = 0.5,
    per_class_topk: int = 400,
    max_detections: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``batched_detection_postprocess`` of one image: (scores (M,), labels
    (M,) int32, boxes (M, 4))."""
    out = batched_detection_postprocess(boxes[None], scores[None], score_threshold,
                                        iou_threshold, per_class_topk, max_detections)
    return tuple(x[0] for x in out)
