"""ResNet backbone with frozen batch norm (counterpart of ``frn_tpu/models/resnet.py``).

Child names are the reference's torch names: ``conv1``, ``bn1``,
``layer{1..4}.{i}.conv1``, ``...downsample.0`` (conv) and ``...downsample.1``
(BN). ``suffix`` names the event stream's copy (``conv1_event``,
``layer1_event.0...``), as the reference does. With ``stem_kernel`` (the
inference path of ``ModelConfig.stem_kernel``) and even H and W, the stem runs
as one fused conv + frozen BN + ReLU (``ops/stem.py``), the BN folded into a
per-channel affine in f32 as the JAX package folds it; elsewhere it takes the
conv path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from frn_tpu_torch.models.layers import Conv, FrozenBatchNorm, conv_init_, max_pool_3x3_s2
from frn_tpu_torch.ops.stem import stem_conv_bn_relu


def _downsample(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    return nn.Sequential(Conv(in_ch, out_ch, 1, stride, 0, bias=False), FrozenBatchNorm(out_ch))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(in_ch, planes, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = _downsample(in_ch, planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(in_ch, planes, 1, 1, 0, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, 1, 0, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = _downsample(in_ch, planes * 4, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNetBackbone(nn.Module):
    """Stem + 4 stages; returns (C2, C3, C4, C5), NCHW.

    Stage planes (64, 128, 256, 512) at strides (1, 2, 2, 2); with Bottleneck
    blocks the C sizes are (256, 512, 1024, 2048) at strides (4, 8, 16, 32).
    """

    def __init__(self, in_channels: int, layers: Sequence[int] = (3, 4, 6, 3),
                 bottleneck: bool = True, suffix: str = ""):
        super().__init__()
        self.suffix = suffix
        block = Bottleneck if bottleneck else BasicBlock
        self.add_module(f"conv1{suffix}", Conv(in_channels, 64, 7, 2, 3, bias=False))
        self.add_module(f"bn1{suffix}", FrozenBatchNorm(64))
        in_planes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            mods = []
            for i in range(blocks):
                need_down = i == 0 and (stride != 1 or in_planes != planes * block.expansion)
                mods.append(block(in_planes, planes, stride if i == 0 else 1, need_down))
                in_planes = planes * block.expansion
            self.add_module(f"layer{stage + 1}{suffix}", nn.Sequential(*mods))
        self.stage_channels = tuple(p * block.expansion for p in (64, 128, 256, 512))

    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's conv init; BN keeps (1, 0) affine and (0, 1) stats."""
        for m in self.modules():
            if isinstance(m, Conv):
                conv_init_(m, gen)

    def forward(self, x: torch.Tensor, stem_kernel: bool = False) -> Tuple[torch.Tensor, ...]:
        s = self.suffix
        conv1, bn1 = getattr(self, f"conv1{s}"), getattr(self, f"bn1{s}")
        if stem_kernel and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            inv = torch.rsqrt(bn1.running_var + bn1.eps) * bn1.weight
            x = stem_conv_bn_relu(x, conv1.weight.to(x.dtype), inv,
                                  bn1.bias - bn1.running_mean * inv)
        else:
            x = torch.relu(bn1(conv1(x)))
        x = max_pool_3x3_s2(x)
        feats = []
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}{s}")(x)
            feats.append(x)
        return tuple(feats)
