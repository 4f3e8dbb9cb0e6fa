"""Flash attention for the non-local fusion attention: forward, logsumexp, backward.

Counterpart of ``frn_tpu/ops/flash_attention.py`` (``_flash_forward`` with
``return_lse`` and ``_flash_backward``). All tensors are (B, N, d) with
Q = phi, K = theta, V = g, and there is no 1/sqrt(d) scale:

* ``csrc/flash_attention.cu``: O = softmax(Q K^T) V and, on request, the
  per-row logsumexp lse (B, N) f32, natural log;
* ``csrc/flash_attention_bwd.cu``: with P = exp(Q K^T - lse) and
  D = rowsum(dO * O) in f32, the dQ kernel computes dS = P * (dO V^T - D) and
  dQ = dS K, the dK/dV kernel dK = dS^T Q and dV = P^T dO.

The kernels are Hopper CUDA C++ for bf16 and d in HEAD_DIMS, built at first use
and bound with ctypes (``frn_tpu_torch/build.py``). Each wrapper launches its
kernel for a CUDA tensor and, for a CPU tensor, runs its plain version, which
follows the kernel's tile loop in PyTorch; on a CUDA tensor it launches the
kernel or raises, and never falls back. ``FlashAttentionFn`` is the
differentiable route (forward with lse, then both backward kernels); the
module-level counters count each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from frn_tpu_torch import build

HEAD_DIMS = (8, 16, 32, 64)
flash_fwd_launches = 0  # forward without lse (inference)
flash_fwd_lse_launches = 0  # forward with lse (the forward of training)
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
_lib = None  # csrc/flash_attention.cu
_bwd_lib = None  # csrc/flash_attention_bwd.cu

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        lib.frn_flash_fwd_bf16.argtypes = [_P] * 5 + [_I] * 3 + [_P]
        lib.frn_flash_fwd_bf16.restype = _I
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.load("flash_attention_bwd")
        lib.frn_flash_bwd_dq_bf16.argtypes = [_P] * 7 + [_I] * 3 + [_P]
        lib.frn_flash_bwd_dkv_bf16.argtypes = [_P] * 8 + [_I] * 3 + [_P]
        lib.frn_flash_bwd_dq_bf16.restype = lib.frn_flash_bwd_dkv_bf16.restype = _I
        _bwd_lib = lib
    return _bwd_lib


# ------------------------------------------------------------ plain versions


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_k: int = 512,
    return_lse: bool = False,
):
    """softmax(q k^T) v by the kernel's recurrence: f32 scores, running max and
    denominator, p rounded to v's dtype before the PV product, f32 accumulator
    divided by the denominator at the end. (B, N, d) in, (B, N, d) out; with
    ``return_lse`` also lse = m + log(l), (B, N) f32."""
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
    o = (acc / l).to(v.dtype)
    if return_lse:
        return o, (m + torch.log(l)).squeeze(2)
    return o


def flash_bwd_dq_plain(q, k, v, do, lse, delta, block_k: int = 512) -> torch.Tensor:
    """dQ by the dQ kernel's loop over key tiles: P = exp(q k^T - lse),
    dS = P * (do v^T - delta) rounded to k's dtype, dQ += dS k in f32."""
    qf, dof = q.float(), do.float()
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for start in range(0, q.shape[1], block_k):
        kb = k[:, start:start + block_k].float()
        vb = v[:, start:start + block_k].float()
        p = torch.exp(torch.bmm(qf, kb.transpose(1, 2)) - lse[:, :, None])
        dp = torch.bmm(dof, vb.transpose(1, 2))
        ds = (p * (dp - delta[:, :, None])).to(k.dtype)
        acc += torch.bmm(ds.float(), kb)
    return acc.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, block_q: int = 512):
    """(dK, dV) by the dK/dV kernel's loop over query tiles, on the transposed
    tiles: P^T = exp(k q^T - lse[col]), dV += P^T (rounded to do's dtype) do,
    dS^T = P^T * (v do^T - delta[col]) rounded to q's dtype, dK += dS^T q."""
    kf, vf = k.float(), v.float()
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for start in range(0, q.shape[1], block_q):
        qb = q[:, start:start + block_q].float()
        dob = do[:, start:start + block_q].float()
        pt = torch.exp(torch.bmm(kf, qb.transpose(1, 2)) - lse[:, None, start:start + block_q])
        dv += torch.bmm(pt.to(do.dtype).float(), dob)
        dpt = torch.bmm(vf, dob.transpose(1, 2))
        dst = (pt * (dpt - delta[:, None, start:start + block_q])).to(q.dtype)
        dk += torch.bmm(dst.float(), qb)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in f32, (B, N): a plain op outside the kernels, as in
    the JAX package."""
    return (do.float() * o.float()).sum(dim=2)


def flash_attention_backward_plain(q, k, v, o, lse, do, block: int = 512):
    """(dQ, dK, dV): the plain versions of both backward kernels."""
    delta = attention_delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, block_k=block)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, block_q=block)
    return dq, dk, dv


# ------------------------------------------------------------ argument checks


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> None:
    if q.dim() != 3 or any(x.shape != q.shape for x in (k, v, *more)):
        shapes = " ".join(str(tuple(x.shape)) for x in (q, k, v, *more))
        raise ValueError(f"q, k, v (and do) must share one (B, N, d) shape: {shapes}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of {HEAD_DIMS}, got {q.shape[2]}")


def _check_rows(q: torch.Tensor, **rows: torch.Tensor) -> None:
    for name, x in rows.items():
        if x.shape != q.shape[:2]:
            raise ValueError(f"{name} must be (B, N) = {tuple(q.shape[:2])}, got {tuple(x.shape)}")


def _check_kernel_args(q: torch.Tensor, *args: Tuple[str, torch.Tensor, torch.dtype]) -> None:
    for name, x, dtype in args:
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != dtype:
            raise TypeError(f"flash kernel takes {dtype} {name}, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _on_kernel_device(q: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for CUDA; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    return True


def _launch(fn, q: torch.Tensor, *args) -> None:
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")


# ------------------------------------------------------------ kernel wrappers

_BF16 = torch.bfloat16
_F32 = torch.float32


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False):
    """O = softmax(q k^T) v, (B, N, d), and with ``return_lse`` also the (B, N)
    f32 logsumexp. The kernel on CUDA, the plain version on CPU.

    The shape rules (one (B, N, d) shape, d in HEAD_DIMS) hold on both; the
    kernel further takes only contiguous, 16-byte aligned bf16 on one device.
    Its output carries no gradient, so on CUDA an input that requires grad
    (with grad mode on) raises: ``FlashAttentionFn.apply`` is the
    differentiable route.
    """
    global flash_fwd_launches, flash_fwd_lse_launches
    _check_shapes(q, k, v)
    if not _on_kernel_device(q):
        return flash_attention_plain(q, k, v, return_lse=return_lse)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "flash_attention's kernel output carries no gradient; use "
            "FlashAttentionFn.apply(q, k, v) where a gradient is needed")
    _check_kernel_args(q, ("q", q, _BF16), ("k", k, _BF16), ("v", v, _BF16))
    b, n, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=_F32, device=q.device) if return_lse else None
    if o.numel():
        _launch(_library().frn_flash_fwd_bf16, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), None if lse is None else lse.data_ptr(), b, n, d)
        if return_lse:
            flash_fwd_lse_launches += 1
        else:
            flash_fwd_launches += 1
    return (o, lse) if return_lse else o


def _check_bwd(q, k, v, do, lse, delta) -> bool:
    _check_shapes(q, k, v, do)
    _check_rows(q, lse=lse, delta=delta)
    if not _on_kernel_device(q):
        return False
    _check_kernel_args(q, ("q", q, _BF16), ("k", k, _BF16), ("v", v, _BF16), ("do", do, _BF16),
                       ("lse", lse, _F32), ("delta", delta, _F32))
    return True


def flash_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dQ (B, N, d): the dQ kernel on CUDA, ``flash_bwd_dq_plain`` on CPU."""
    global flash_bwd_dq_launches
    if not _check_bwd(q, k, v, do, lse, delta):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta)
    b, n, d = q.shape
    dq = torch.empty_like(q)
    if dq.numel():
        _launch(_bwd_library().frn_flash_bwd_dq_bf16, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, n, d)
        flash_bwd_dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each (B, N, d): the dK/dV kernel on CUDA, the plain version on CPU."""
    global flash_bwd_dkv_launches
    if not _check_bwd(q, k, v, do, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    b, n, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _launch(_bwd_library().frn_flash_bwd_dkv_bf16, q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, n, d)
        flash_bwd_dkv_launches += 1
    return dk, dv


def flash_attention_backward(q, k, v, o, lse, do):
    """(dQ, dK, dV) from the forward's inputs, output and lse and the upstream
    gradient ``do``: D = rowsum(do * o) in f32, then both backward kernels."""
    delta = attention_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """softmax(q k^T) v with its gradient: the forward kernel with lse, then the
    dQ and dK/dV kernels (the plain versions on CPU). Counterpart of the JAX
    package's ``custom_vjp`` ``_fwd``/``_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_backward(q, k, v, o, lse, do.contiguous())
