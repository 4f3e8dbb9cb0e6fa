"""The ResNet stem as one fused op: conv 7x7 / 2 (padding 3), frozen BN, ReLU.

Counterpart of ``frn_tpu/ops/stem.py::stem_conv_bn_relu``, selected by
``ModelConfig.stem_kernel`` on the inference path:

    relu(conv7x7_s2_p3(x, w) * scale + bias)

with f32 accumulation and one rounding to x's dtype. Layouts are the port's
(NCHW, torch's (F, C, 7, 7) weights); the kernel reads x as the NHWC memory of
a channels_last tensor, which is what the detector's input permute gives, and
returns a channels_last (B, 64, H/2, W/2) tensor, the layout the max pool
takes next. The kernel (``csrc/stem.cu``, Hopper CUDA C++: an implicit GEMM on
the tensor cores, bf16, C in {3, 5}, 64 filters, even H and W; each block
packs torch's weights into its K order, which
``tests/test_torch_optin_kernels.py`` models in torch) runs for a CUDA
tensor, the plain version for a CPU tensor; on a CUDA tensor the wrapper
launches the kernel or raises. Inference only: it defines no gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from frn_tpu_torch import build
from frn_tpu_torch.ops.flash_attention import _launch, _on_kernel_device

STEM_CHANNELS = (3, 5)
STEM_FILTERS = 64
stem_launches = 0
_lib = None  # csrc/stem.cu


def bind_stem(lib):
    """Declares the C signature of ``csrc/stem.cu``'s entry point on a loaded
    library; returns it."""
    lib.frn_stem_conv_bn_relu.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.frn_stem_conv_bn_relu.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind_stem(build.load("stem"))
    return _lib


def stem_conv_bn_relu_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """relu(conv2d(x, w, stride 2, padding 3) * scale + bias) in f32, rounded
    once to x's dtype. x (B, C, H, W), w (F, C, 7, 7), scale and bias (F,)."""
    y = F.conv2d(x.float(), w.float(), stride=2, padding=3)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    return torch.relu(y).to(x.dtype)


def _check(x, w, scale, bias) -> None:
    if x.dim() != 4 or w.dim() != 4 or w.shape[1:] != (x.shape[1], 7, 7):
        raise ValueError(f"stem takes x (B, C, H, W) and w (F, C, 7, 7), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if scale.shape != (w.shape[0],) or bias.shape != (w.shape[0],):
        raise ValueError(f"scale and bias must be ({w.shape[0]},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"stem needs even H and W, got {tuple(x.shape[2:])}")


def stem_conv_bn_relu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The fused stem, (B, C, H, W) -> (B, F, H/2, W/2) in x's dtype: the
    kernel on CUDA, ``stem_conv_bn_relu_plain`` on CPU.

    The kernel takes bf16 x with channels_last memory, C in STEM_CHANNELS,
    bf16 w with STEM_FILTERS filters, f32 scale and bias, all on one device;
    anything else on CUDA raises, as does an input that requires grad (with
    grad mode on).
    """
    global stem_launches
    _check(x, w, scale, bias)
    if not _on_kernel_device(x):
        return stem_conv_bn_relu_plain(x, w, scale, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, scale, bias)):
        raise RuntimeError("the stem kernel is inference only: it defines no gradient")
    b, c, h, wd = x.shape
    if c not in STEM_CHANNELS or w.shape[0] != STEM_FILTERS:
        raise ValueError(f"stem kernel takes C in {STEM_CHANNELS} and {STEM_FILTERS} filters, "
                         f"got C {c} and {w.shape[0]}")
    x_nhwc = x.permute(0, 2, 3, 1)
    w = w.contiguous()  # a channels_last model's weights are not (one small copy)
    for name, t, dtype in (("x", x_nhwc, torch.bfloat16), ("w", w, torch.bfloat16),
                           ("scale", scale, torch.float32), ("bias", bias, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"stem kernel takes {dtype} {name}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned and contiguous"
                             + (" in channels_last memory" if name == "x" else ""))
    out = torch.empty((b, h // 2, wd // 2, STEM_FILTERS), dtype=x.dtype, device=x.device)
    if out.numel():
        _launch(_library().frn_stem_conv_bn_relu, x, x_nhwc.data_ptr(), w.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, wd, c)
        stem_launches += 1
    return out.permute(0, 3, 1, 2)
