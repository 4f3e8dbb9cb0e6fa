"""Cross-modal fusion: AdaIN, non-local cross-attention, REFusion (NCHW).

Counterpart of ``frn_tpu/models/fusion.py``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from frn_tpu_torch.models.layers import Conv, conv_init_
from frn_tpu_torch.ops.attention import nonlocal_attention, reference_view_to_nchw


def adain(content: torch.Tensor, style: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Adaptive instance norm: per-(batch, channel) statistics over H, W in f32,
    unbiased variance (ddof 1), eps added before the sqrt."""

    def mean_std(feat):
        b, c, h, w = feat.shape
        flat = feat.float().reshape(b, c, h * w)
        mean = flat.mean(dim=2, keepdim=True)
        var = ((flat - mean) ** 2).sum(dim=2, keepdim=True) / max(h * w - 1, 1)
        return mean.reshape(b, c, 1, 1), torch.sqrt(var + eps).reshape(b, c, 1, 1)

    s_mean, s_std = mean_std(style)
    c_mean, c_std = mean_std(content)
    normalized = (content.float() - c_mean) / c_std
    return (normalized * s_std + s_mean).to(content.dtype)


class CrossAttentionBlock(nn.Module):
    """Non-local block: values g from x0, keys theta and queries phi from x1, a
    C/8 bottleneck, softmax attention, 1x1 W back to C, then AdaIN(x0, W y)."""

    def __init__(self, in_channels: int, chunk: int = 1024):
        super().__init__()
        c8 = in_channels // 8
        self.chunk = chunk
        self.g = Conv(in_channels, c8, 1)
        self.theta = Conv(in_channels, c8, 1)
        self.phi = Conv(in_channels, c8, 1)
        self.W = Conv(c8, in_channels, 1)

    def init_weights(self, gen: torch.Generator) -> None:
        for conv in (self.g, self.theta, self.phi, self.W):
            conv_init_(conv, gen, "c2_xavier")

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x0.shape

        def tokens(t):  # (B, C8, H, W) -> (B, HW, C8)
            return t.flatten(2).transpose(1, 2)

        y = nonlocal_attention(
            tokens(self.g(x0)), tokens(self.theta(x1)), tokens(self.phi(x1)), chunk=self.chunk
        )
        return adain(x0, self.W(reference_view_to_nchw(y, h, w)))


class REFusion(nn.Module):
    """Per-stage fusion: 1x1 convs on both streams, the product added back to
    each, two cross-attention directions, channel concat.

    Called as fus(event, rgb), like the reference: stream a is the event
    stream, b the RGB stream, with the reference's parameter names.
    """

    def __init__(self, channels: int, chunk: int = 1024):
        super().__init__()
        self.channels = channels
        self.conv0_rgb = Conv(channels, channels, 1)
        self.conv0_evt = Conv(channels, channels, 1)
        self.rgb_cross_attention = CrossAttentionBlock(channels, chunk)
        self.event_cross_attention = CrossAttentionBlock(channels, chunk)

    def init_weights(self, gen: torch.Generator) -> None:
        # torch defaults: the reference registers these after its re-init loop
        for conv in (self.conv0_rgb, self.conv0_evt):
            conv_init_(conv, gen, "torch_default", bias_fan_in=self.channels)
        self.rgb_cross_attention.init_weights(gen)
        self.event_cross_attention.init_weights(gen)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a0 = self.conv0_rgb(a)
        b0 = self.conv0_evt(b)
        mul = a0 * b0
        a1 = a0 + mul
        b1 = b0 + mul
        y_a = self.rgb_cross_attention(a1, b1)
        y_b = self.event_cross_attention(b1, a1)
        return torch.cat([y_a, y_b], dim=1)
