"""Non-local cross-attention core (counterpart of ``frn_tpu/ops/attention.py``).

softmax(phi . theta^T) . g with no 1/sqrt(d) scale. On a CUDA tensor, long
sequences (HW >= FLASH_MIN_TOKENS) with a head dim under 128 go to the flash
kernels (``ops/flash_attention.py``), as the JAX package routes them to its
Pallas kernels on a TPU: through ``FlashAttentionFn`` (forward with lse, then
the two backward kernels) when grad mode is on and an input requires grad,
else the forward kernel alone. On that route the inference-only options pick
another kernel, with the JAX package's precedence: ``quant`` ('int8_qk' or
'int8') the int8 kernel, else ``exp_bf16`` the bf16-exp forward; both raise
for an input that requires grad. The kernels take bf16 or f32 with a head
dim in ``HEAD_DIMS``: at f32 an input that requires grad takes
``FlashAttentionFn`` too (the f32 forward with lse, then the f32 backward
kernels), while the inference-only options at f32 raise; any other CUDA
input on that route raises. The rest, and every CPU tensor, take the
exact dense route under autograd whatever the options: f32 scores, softmax, p
cast to g's dtype, PV with f32 accumulation, over query blocks of ``chunk``
rows to bound memory.
"""

from __future__ import annotations

from typing import Optional

import torch

from frn_tpu_torch.ops.flash_attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_bf16exp,
    flash_attention_int8,
)

FLASH_MIN_TOKENS = 4096


def _dense(g: torch.Tensor, theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    scores = torch.bmm(phi.float(), theta.float().transpose(1, 2))
    attn = torch.softmax(scores, dim=-1).to(g.dtype)
    return torch.bmm(attn.float(), g.float()).to(g.dtype)


def _kernel_route(g: torch.Tensor) -> bool:
    """A CUDA tensor with HW >= FLASH_MIN_TOKENS and a head dim under 128."""
    return g.is_cuda and g.shape[1] >= FLASH_MIN_TOKENS and g.shape[2] < 128


def nonlocal_attention(
    g: torch.Tensor,  # (B, HW, C8) values, from the content stream x0
    theta: torch.Tensor,  # (B, HW, C8) keys, from the style stream x1
    phi: torch.Tensor,  # (B, HW, C8) queries, from the style stream x1
    chunk: int = 1024,
    exp_bf16: bool = False,  # inference-only bf16-exp softmax weights
    quant: Optional[str] = None,  # inference-only int8 mode ('int8_qk' | 'int8')
) -> torch.Tensor:
    """softmax(phi . theta^T) . g -> (B, HW, C8)."""
    hw = g.shape[1]
    if _kernel_route(g):
        q, k, v = phi.contiguous(), theta.contiguous(), g.contiguous()
        if quant:
            return flash_attention_int8(q, k, v, quant)
        if exp_bf16:
            return flash_attention_bf16exp(q, k, v)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v)
        return flash_attention(q, k, v)
    if hw <= chunk:
        return _dense(g, theta, phi)
    return torch.cat(
        [_dense(g, theta, phi[:, s:s + chunk]) for s in range(0, hw, chunk)], dim=1
    )


def reference_view_to_nchw(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The reference's layout quirk: (B, HW, C8) viewed as (B, C8, H, W), no permute.

    Counterpart of ``reference_view_to_nhwc`` in the JAX package, which does the
    same reinterpretation and then moves channels last for its NHWC convs.
    """
    b, hw, c8 = y.shape
    return y.contiguous().reshape(b, c8, h, w)
