"""Shared RetinaNet heads (counterpart of ``frn_tpu/models/heads.py``), NCHW in.

Four 3x3 conv + ReLU layers and an output conv, shared across pyramid levels.
The classification output conv starts at zero with the prior bias
-log((1-p)/p); the regression output conv at zero. Anchor order matches the
JAX package: cells row-major, the 9 anchors of a cell fastest.

Emission modes, from the output map (B, A*X, H, W):
  classification 'probs'  (B, HWA, K) f32 sigmoid; 'logits' (B, HWA, K);
                 'logits_chanlast' class-major (B, K, HWA)
  regression     'rows'   (B, HWA, 4); 'flat36' (B, HW, A*4)

The fused dual heads (``fused_dual_heads``, ``ModelConfig.fused_heads``) run
the 'probs' emission on the same parameters as one conv chain: layer 1 one
conv to the two towers' channels, layers 2-4 and the output layer convs of 2
groups whose weights are the two towers' concatenated, each output slot
padded to the wider of A*K and A*4.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

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


def fused_dual_heads(
    cls_head: ClassificationHead, reg_head: RegressionHead, features: Sequence[torch.Tensor],
    num_classes: int, num_anchors: int = 9, dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both heads' towers in one conv chain per level: ((B, A, K) f32 sigmoid,
    (B, A, 4)).

    Reads the two heads' own weights on every call (the state_dict is
    unchanged, and autograd reaches them). Layer 1 concatenates the two
    conv1 weights along the output axis (one conv); layers 2-4 are convs of
    2 groups whose weight is the two towers' concatenated; the output layer
    pads the cls (A*K) and reg (A*4) slots to max(A*K, A*4) each and runs as
    one conv of 2 groups, the padding sliced off. Weights and biases are cast
    to ``dtype`` (None: the features' dtype).
    """
    a, k = num_anchors, num_classes
    tower = ("conv1", "conv2", "conv3", "conv4")
    layers = []
    for i, name in enumerate(tower):
        c, r = getattr(cls_head, name), getattr(reg_head, name)
        layers.append((torch.cat([c.weight, r.weight], 0), torch.cat([c.bias, r.bias], 0),
                       1 if i == 0 else 2))
    co, ro = a * k, a * 4
    pad = max(co, ro)
    cw = F.pad(cls_head.output.weight, (0, 0, 0, 0, 0, 0, 0, pad - co))
    rw = F.pad(reg_head.output.weight, (0, 0, 0, 0, 0, 0, 0, pad - ro))
    cb = F.pad(cls_head.output.bias, (0, pad - co))
    rb = F.pad(reg_head.output.bias, (0, pad - ro))
    layers.append((torch.cat([cw, rw], 0), torch.cat([cb, rb], 0), 2))
    dtype = features[0].dtype if dtype is None else dtype
    layers = [(w.to(dtype), b.to(dtype), g) for w, b, g in layers]

    cls_rows, reg_rows = [], []
    for f in features:
        x = f.to(dtype)
        for i, (w, b, g) in enumerate(layers):
            x = F.conv2d(x, w, b, 1, 1, groups=g)
            if i < len(layers) - 1:
                x = torch.relu(x)
        out = x.permute(0, 2, 3, 1)  # (B, H, W, 2*pad)
        n = out.shape[0]
        cls_rows.append(torch.sigmoid(out[..., :co].float()).reshape(n, -1, k))
        reg_rows.append(out[..., pad:pad + ro].reshape(n, -1, 4))
    return torch.cat(cls_rows, dim=1), torch.cat(reg_rows, dim=1)


def apply_heads(
    cls_head: ClassificationHead, reg_head: RegressionHead, features: Sequence[torch.Tensor],
    cls_mode: str = "probs", reg_mode: str = "rows",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both heads over every pyramid level, concatenated along the anchor axis."""
    regression = torch.cat([reg_head(f, mode=reg_mode) for f in features], dim=1)
    axis = 2 if cls_mode == "logits_chanlast" else 1
    classification = torch.cat([cls_head(f, mode=cls_mode) for f in features], dim=axis)
    return classification, regression
