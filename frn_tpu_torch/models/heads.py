"""Shared RetinaNet heads (counterpart of ``frn_tpu/models/heads.py``), NCHW in.

Four 3x3 conv + ReLU layers and an output conv, shared across pyramid levels.
The classification output conv starts at zero with the prior bias
-log((1-p)/p); the regression output conv at zero. Anchor order matches the
JAX package: cells row-major, the 9 anchors of a cell fastest.

Emission modes, from the output map (B, A*X, H, W):
  classification 'probs'  (B, HWA, K) f32 sigmoid; 'logits' (B, HWA, K);
                 'logits_chanlast' class-major (B, K, HWA)
  regression     'rows'   (B, HWA, 4); 'flat36' (B, HW, A*4)
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from frn_tpu_torch.models.layers import Conv, conv_init_


class _Tower(nn.Module):
    def __init__(self, feature_size: int, out_channels: int):
        super().__init__()
        fs = feature_size
        self.conv1 = Conv(fs, fs, 3, 1, 1)
        self.conv2 = Conv(fs, fs, 3, 1, 1)
        self.conv3 = Conv(fs, fs, 3, 1, 1)
        self.conv4 = Conv(fs, fs, 3, 1, 1)
        self.output = Conv(fs, out_channels, 3, 1, 1)

    def init_weights(self, gen: torch.Generator, output_bias: float = 0.0) -> None:
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            conv_init_(conv, gen)
        self.output.weight.data.zero_()
        self.output.bias.data.fill_(output_bias)

    def _map(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = torch.relu(conv(x))
        return self.output(x)  # (B, A*X, H, W)


class RegressionHead(_Tower):
    def __init__(self, num_anchors: int = 9, feature_size: int = 256):
        super().__init__(feature_size, num_anchors * 4)
        self.num_anchors = num_anchors

    def forward(self, x: torch.Tensor, mode: str = "rows") -> torch.Tensor:
        out = self._map(x).permute(0, 2, 3, 1)  # (B, H, W, A*4)
        b, h, w, _ = out.shape
        if mode == "flat36":
            return out.reshape(b, h * w, self.num_anchors * 4)
        if mode == "rows":
            return out.reshape(b, -1, 4)
        raise ValueError(f"Unknown regression mode {mode!r}")


class ClassificationHead(_Tower):
    def __init__(self, num_classes: int, num_anchors: int = 9, feature_size: int = 256,
                 prior: float = 0.01):
        super().__init__(feature_size, num_anchors * num_classes)
        self.num_classes, self.num_anchors, self.prior = num_classes, num_anchors, prior

    def init_weights(self, gen: torch.Generator, output_bias: float = 0.0) -> None:
        super().init_weights(gen, -math.log((1.0 - self.prior) / self.prior))

    def forward(self, x: torch.Tensor, mode: str = "probs") -> torch.Tensor:
        out = self._map(x)
        b, _, h, w = out.shape
        if mode == "logits_chanlast":
            out = out.reshape(b, self.num_anchors, self.num_classes, h, w)
            return out.permute(0, 2, 3, 4, 1).reshape(b, self.num_classes, -1)
        out = out.permute(0, 2, 3, 1).reshape(b, -1, self.num_classes)
        if mode == "probs":
            return torch.sigmoid(out.float())
        if mode == "logits":
            return out
        raise ValueError(f"Unknown classification mode {mode!r}")


def apply_heads(
    cls_head: ClassificationHead, reg_head: RegressionHead, features: Sequence[torch.Tensor],
    cls_mode: str = "probs", reg_mode: str = "rows",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both heads over every pyramid level, concatenated along the anchor axis."""
    regression = torch.cat([reg_head(f, mode=reg_mode) for f in features], dim=1)
    axis = 2 if cls_mode == "logits_chanlast" else 1
    classification = torch.cat([cls_head(f, mode=cls_mode) for f in features], dim=axis)
    return classification, regression
