"""Cross-modal fusion: AdaIN, non-local cross-attention, REFusion (NCHW).

Counterpart of ``frn_tpu/models/fusion.py``. ``exp_bf16`` and ``quant`` select
the inference-only attention kernels (``ops/attention.py``); ``fused_attention``
runs both directions of a stage in one attention call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

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

    def forward(self, x0: torch.Tensor, x1: torch.Tensor, exp_bf16: bool = False,
                quant: Optional[str] = None) -> torch.Tensor:
        b, c, h, w = x0.shape
        y = nonlocal_attention(
            _tokens(self.g(x0)), _tokens(self.theta(x1)), _tokens(self.phi(x1)), chunk=self.chunk,
            exp_bf16=exp_bf16, quant=quant,
        )
        return adain(x0, self.W(reference_view_to_nchw(y, h, w)))


def _tokens(t: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, HW, C); a view for channels_last memory."""
    return t.flatten(2).transpose(1, 2)


def _conv1x1(x: torch.Tensor, convs, groups: int = 1) -> torch.Tensor:
    """The 1x1 ``convs`` as one conv: their weights and biases side by side."""
    w = torch.cat([m.weight for m in convs]).to(x.dtype)
    b = torch.cat([m.bias for m in convs]).to(x.dtype)
    return F.conv2d(x, w, b, groups=groups)


class REFusion(nn.Module):
    """Per-stage fusion: 1x1 convs on both streams, the product added back to
    each, two cross-attention directions, channel concat.

    Called as fus(event, rgb), like the reference: stream a is the event
    stream, b the RGB stream, with the reference's parameter names.
    """

    def __init__(self, channels: int, chunk: int = 1024, fused_attention: bool = False):
        super().__init__()
        self.channels = channels
        self.fused_attention = fused_attention
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

    def forward(self, a: torch.Tensor, b: torch.Tensor, exp_bf16: bool = False,
                quant: Optional[str] = None) -> torch.Tensor:
        a0 = self.conv0_rgb(a)
        b0 = self.conv0_evt(b)
        mul = a0 * b0
        a1 = a0 + mul
        b1 = b0 + mul
        if self.fused_attention:
            return self._fused_dual_attention(a1, b1, exp_bf16, quant)
        y_a = self.rgb_cross_attention(a1, b1, exp_bf16, quant)
        y_b = self.event_cross_attention(b1, a1, exp_bf16, quant)
        return torch.cat([y_a, y_b], dim=1)

    def _fused_dual_attention(self, a1: torch.Tensor, b1: torch.Tensor, exp_bf16: bool,
                              quant: Optional[str]) -> torch.Tensor:
        """Both directions in one pass over the same parameters: direction A
        (rgb_cross_attention) is attn(x0=a1, x1=b1), B (event_cross_attention)
        attn(x0=b1, x1=a1). Each stream feeds one C -> 3C/8 conv (g of its own
        direction, theta and phi of the other), the attention runs once over
        2B (A's batch first), and both W projections run as one grouped conv.
        Quantization scales stay per batch slice, so per direction."""
        att_a, att_b = self.rgb_cross_attention, self.event_cross_attention
        b, c, h, w = a1.shape
        c8 = c // 8
        pa = _tokens(_conv1x1(a1, (att_a.g, att_b.theta, att_b.phi)))  # g_A, theta_B, phi_B
        pb = _tokens(_conv1x1(b1, (att_b.g, att_a.theta, att_a.phi)))  # g_B, theta_A, phi_A
        g = torch.cat([pa[..., :c8], pb[..., :c8]])
        theta = torch.cat([pb[..., c8:2 * c8], pa[..., c8:2 * c8]])
        phi = torch.cat([pb[..., 2 * c8:], pa[..., 2 * c8:]])
        y = nonlocal_attention(g, theta, phi, chunk=att_a.chunk, exp_bf16=exp_bf16, quant=quant)
        y = reference_view_to_nchw(y, h, w)  # (2B, C8, H, W)
        w_y = _conv1x1(torch.cat([y[:b], y[b:]], dim=1), (att_a.W, att_b.W), groups=2)
        return torch.cat([adain(a1, w_y[:, :c]), adain(b1, w_y[:, c:])], dim=1)
