"""Flash-attention forward for the non-local fusion attention.

Counterpart of ``frn_tpu/ops/flash_attention.py`` (``_flash_forward``): the
kernel ``csrc/flash_attention.cu`` computes O = softmax(Q K^T) V per batch with
no 1/sqrt(d) scale, Q = phi, K = theta, V = g, all (B, N, d). It is a Hopper
CUDA C++ kernel for bf16 and d in {32, 64}, built at first use and bound with
ctypes (``frn_tpu_torch/build.py``).

``flash_attention`` launches it for a CUDA tensor, and for a CPU tensor runs
``flash_attention_plain``, the same online-softmax recurrence over key tiles in
PyTorch. On a CUDA tensor it launches the kernel or raises; it never falls back.
``flash_fwd_launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from frn_tpu_torch import build

HEAD_DIMS = (32, 64)
flash_fwd_launches = 0
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        fn = lib.frn_flash_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_k: int = 512
) -> torch.Tensor:
    """softmax(q k^T) v by the kernel's recurrence: f32 scores, running max and
    denominator, p rounded to v's dtype before the PV product, f32 accumulator
    divided by the denominator at the end. (B, N, d) in, (B, N, d) out."""
    b, n, d = q.shape
    qf = q.float()
    m = torch.full((b, n, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, v.shape[2]), dtype=torch.float32, device=q.device)
    for start in range(0, n, block_k):
        kb = k[:, start:start + block_k].float()
        vb = v[:, start:start + block_k]
        s = torch.bmm(qf, kb.transpose(1, 2))
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=2, keepdim=True)
        acc = acc * alpha + torch.bmm(p.to(v.dtype).float(), vb.float())
        m = m_new
    return (acc / l).to(v.dtype)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, N, d) shape: {q.shape} {k.shape} {v.shape}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of {HEAD_DIMS}, got {q.shape[2]}")


def _check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bfloat16, {name} is {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """O = softmax(q k^T) v, (B, N, d). The kernel on CUDA, the plain version on CPU.

    The shape rules (one (B, N, d) shape, d in HEAD_DIMS) hold on both; the
    kernel further takes only contiguous, 16-byte aligned bf16 on one device.
    """
    global flash_fwd_launches
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_kernel_args(q, k, v)
    b, n, d = q.shape
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    fn = _library().frn_flash_fwd_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, n, d, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")
    flash_fwd_launches += 1
    return o
