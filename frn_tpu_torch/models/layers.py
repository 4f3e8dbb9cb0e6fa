"""Primitive layers with the JAX package's numerics, NCHW.

Counterpart of ``frn_tpu/models/layers.py``: convs with symmetric torch
padding, frozen batch norm folded into one multiply-add, the 3x3/2 max pool,
and the reference's init functions (drawn from an explicit ``torch.Generator``).
Parameters stay f32; a layer computes in the dtype of its input.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def torch_conv_init(weight: torch.Tensor, gen: torch.Generator) -> None:
    """normal(0, sqrt(2 / (k*k*out_channels))), the reference's conv init."""
    out_ch, _, kh, kw = weight.shape
    std = math.sqrt(2.0 / (kh * kw * out_ch))
    weight.copy_(torch.randn(weight.shape, generator=gen) * std)


def _uniform(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound)


def torch_default_conv_init(weight: torch.Tensor, gen: torch.Generator) -> None:
    """nn.Conv2d's default: uniform(+-1/sqrt(fan_in))."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    _uniform(weight, 1.0 / math.sqrt(fan_in), gen)


def torch_default_bias_init(bias: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    _uniform(bias, 1.0 / math.sqrt(fan_in), gen)


def c2_xavier_init(weight: torch.Tensor, gen: torch.Generator) -> None:
    """fvcore c2_xavier_fill: uniform(+-sqrt(3 / fan_in)); its bias is zero."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    _uniform(weight, math.sqrt(3.0 / fan_in), gen)


class Conv(nn.Module):
    """2D conv with symmetric padding; weight (out, in, k, k), f32."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class FrozenBatchNorm(nn.Module):
    """Batch norm with frozen statistics: x*inv + (beta - mean*inv), eps 1e-5.

    inv = rsqrt(var + eps) * gamma in f32, then both terms in x's dtype.
    """

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=3, stride=2, padding=1)."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def conv_init_(conv: Conv, gen: torch.Generator, kind: str = "torch_conv",
               bias_fan_in: Optional[int] = None) -> None:
    """Initialise a Conv as the JAX package does: ``kind`` is the kernel init
    ('torch_conv', 'torch_default' or 'c2_xavier'); the bias is zero unless
    ``bias_fan_in`` asks for torch's default uniform bias."""
    init = {"torch_conv": torch_conv_init, "torch_default": torch_default_conv_init,
            "c2_xavier": c2_xavier_init}[kind]
    init(conv.weight.data, gen)
    if conv.bias is not None:
        if bias_fan_in is None:
            conv.bias.data.zero_()
        else:
            torch_default_bias_init(conv.bias.data, bias_fan_in, gen)
