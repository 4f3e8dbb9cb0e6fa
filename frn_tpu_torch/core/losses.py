"""Focal + smooth-L1 detection loss (counterpart of ``frn_tpu/core/losses.py``).

Annotations arrive padded to a fixed N with class -1; assignment and both
loss terms are masked tensors, with the batch dimension written out where the
JAX package vmaps. The numerics are the reference's:

  * IoU assignment: < 0.4 background, >= 0.5 positive, in between ignored;
    an image with no valid annotation takes the all-background branch
    (masked IoU max = -1 < 0.4 and num_pos = 0);
  * the assigned annotation is the first of the maximal IoUs (``jnp.argmax``);
  * focal: alpha 0.25, gamma 2, probabilities clamped to [1e-4, 1 - 1e-4];
    classification loss = sum / max(num_pos, 1);
  * regression: smooth-L1 with beta 1/9 on the box coder's targets, summed
    over the positives and divided by num_pos * 4 (0 without positives);
  * both are averaged over the batch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from frn_tpu_torch.core.boxes import DEFAULT_STD, encode_boxes, pairwise_iou

ALPHA = 0.25
GAMMA = 2.0
BETA = 1.0 / 9.0


def focal_detection_loss(
    classification: torch.Tensor,  # (B, A, K) sigmoid probabilities
    regression: torch.Tensor,  # (B, A, 4) raw deltas
    anchors: torch.Tensor,  # (A, 4)
    annotations: torch.Tensor,  # (B, N, 5) [x1, y1, x2, y2, class], padded rows class -1
    std: Sequence[float] = DEFAULT_STD,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-mean (classification_loss, regression_loss) scalars, f32."""
    num_classes = classification.shape[-1]
    cls = classification.float().clamp(1e-4, 1.0 - 1e-4)
    reg = regression.float()
    annotations = annotations.float()

    valid = annotations[..., 4] >= 0.0  # (B, N)
    iou = pairwise_iou(anchors[None], annotations[..., :4])  # (B, A, N)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    iou_max, iou_arg = iou.max(dim=2)  # first index of the max, as jnp.argmax

    positive = iou_max >= 0.5  # (B, A)
    ignore = (iou_max >= 0.4) & ~positive
    num_pos = positive.float().sum(dim=1)  # (B,)

    assigned = torch.gather(annotations, 1, iou_arg[..., None].expand(-1, -1, 5))  # (B, A, 5)
    assigned_cls = assigned[..., 4].to(torch.int64).clamp(0, num_classes - 1)
    one_hot = F.one_hot(assigned_cls, num_classes).float()
    targets = torch.where(positive[..., None], one_hot, torch.zeros_like(one_hot))  # (B, A, K)

    # focal classification loss
    is_pos_target = targets == 1.0
    alpha_factor = torch.where(is_pos_target, ALPHA, 1.0 - ALPHA)
    focal_weight = torch.where(is_pos_target, 1.0 - cls, cls)
    focal_weight = alpha_factor * focal_weight ** GAMMA
    bce = -(targets * torch.log(cls) + (1.0 - targets) * torch.log(1.0 - cls))
    cls_loss = focal_weight * bce
    cls_loss = torch.where(ignore[..., None], torch.zeros_like(cls_loss), cls_loss)
    cls_loss = cls_loss.sum(dim=(1, 2)) / num_pos.clamp_min(1.0)

    # smooth-L1 regression loss over the positives
    reg_targets = encode_boxes(anchors[None], assigned[..., :4], std=std)  # (B, A, 4)
    diff = (reg_targets - reg).abs()
    smooth = torch.where(diff <= BETA, 0.5 / BETA * diff ** 2, diff - 0.5 * BETA)
    smooth = smooth * positive[..., None]
    reg_loss = smooth.sum(dim=(1, 2)) / (num_pos * 4.0).clamp_min(1.0)
    reg_loss = torch.where(num_pos > 0, reg_loss, torch.zeros_like(reg_loss))
    return cls_loss.mean(), reg_loss.mean()
