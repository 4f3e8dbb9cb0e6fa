"""Non-local cross-attention core (counterpart of ``frn_tpu/ops/attention.py``).

softmax(phi . theta^T) . g with no 1/sqrt(d) scale. On a CUDA tensor, long
sequences (HW >= FLASH_MIN_TOKENS) with a head dim under 128 go to the flash
kernels (``ops/flash_attention.py``), as the JAX package routes them to its
Pallas kernels on a TPU: through ``FlashAttentionFn`` (forward with lse, then
the two backward kernels) when grad mode is on and an input requires grad,
else the forward kernel alone. The kernels take bf16 with a head dim in
``HEAD_DIMS``; any other CUDA input on that route raises. The rest, and every
CPU tensor, take the dense route under autograd: f32 scores, softmax, p cast
to g's dtype, PV with f32 accumulation, over query blocks of ``chunk`` rows to
bound memory.
"""

from __future__ import annotations

import torch

from frn_tpu_torch.ops.flash_attention import FlashAttentionFn, flash_attention

FLASH_MIN_TOKENS = 4096


def _dense(g: torch.Tensor, theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    scores = torch.bmm(phi.float(), theta.float().transpose(1, 2))
    attn = torch.softmax(scores, dim=-1).to(g.dtype)
    return torch.bmm(attn.float(), g.float()).to(g.dtype)


def nonlocal_attention(
    g: torch.Tensor,  # (B, HW, C8) values, from the content stream x0
    theta: torch.Tensor,  # (B, HW, C8) keys, from the style stream x1
    phi: torch.Tensor,  # (B, HW, C8) queries, from the style stream x1
    chunk: int = 1024,
) -> torch.Tensor:
    """softmax(phi . theta^T) . g -> (B, HW, C8)."""
    hw, c8 = g.shape[1], g.shape[2]
    if g.is_cuda and hw >= FLASH_MIN_TOKENS and c8 < 128:
        q, k, v = phi.contiguous(), theta.contiguous(), g.contiguous()
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
