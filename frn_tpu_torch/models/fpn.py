"""Five-level FPN, P2..P6 (counterpart of ``frn_tpu/models/fpn.py``), NCHW.

Lateral 1x1 convs on C2..C5, top-down adds (nearest x2 for DSEC, fixed-size
bilinear for DDD17), 3x3 output convs, and P6 = a stride-2 3x3 conv on C5.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from frn_tpu_torch.models.layers import Conv, conv_init_
from frn_tpu_torch.ops.upsample import bilinear_resize, nearest_upsample_2x


class PyramidFeatures(nn.Module):
    def __init__(self, in_channels: Sequence[int], feature_size: int = 256,
                 upsample: str = "nearest2x"):
        super().__init__()
        if upsample not in ("nearest2x", "bilinear_fixed"):
            raise ValueError(f"Unknown FPN upsample mode {upsample!r}")
        self.upsample = upsample
        c2, c3, c4, c5 = in_channels
        fs = feature_size
        self.P5_1 = Conv(c5, fs, 1)
        self.P5_2 = Conv(fs, fs, 3, 1, 1)
        self.P4_1 = Conv(c4, fs, 1)
        self.P4_2 = Conv(fs, fs, 3, 1, 1)
        self.P3_1 = Conv(c3, fs, 1)
        self.P3_2 = Conv(fs, fs, 3, 1, 1)
        self.P2_1 = Conv(c2, fs, 1)
        self.P2_2 = Conv(fs, fs, 3, 1, 1)
        self.P6 = Conv(c5, fs, 3, 2, 1)

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.children():
            conv_init_(m, gen)

    def _up(self, x: torch.Tensor, target_hw) -> torch.Tensor:
        if self.upsample == "nearest2x":
            return nearest_upsample_2x(x, target_hw)
        return bilinear_resize(x, target_hw)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        c2, c3, c4, c5 = feats
        p5 = self.P5_1(c5)
        p4 = self.P4_1(c4) + self._up(p5, c4.shape[2:])
        p3 = self.P3_1(c3) + self._up(p4, c3.shape[2:])
        p2 = self.P2_1(c2) + self._up(p3, c2.shape[2:])
        return (self.P2_2(p2), self.P3_2(p3), self.P4_2(p4), self.P5_2(p5), self.P6(c5))
