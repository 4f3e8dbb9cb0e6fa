"""Flash attention for the non-local fusion attention: forward, logsumexp,
backward, and the inference-only bf16-exp and int8 forwards.

Counterpart of ``frn_tpu/ops/flash_attention.py`` (``_flash_forward`` with
``return_lse`` and ``exp_bf16``, ``_flash_backward``, ``_flash_forward_int8``).
All tensors are (B, N, d) with Q = phi, K = theta, V = g, and there is no
1/sqrt(d) scale:

* ``csrc/flash_attention.cu``: O = softmax(Q K^T) V and, on request, the
  per-row logsumexp lse (B, N) f32, natural log; with the bf16-exp flag the
  softmax weights are p = bf16(exp(bf16(s - m))), m the running row max;
* ``csrc/flash_attention_f32.cu``: O = softmax(Q K^T) V on f32 inputs, p kept
  in f32, and on request the f32 lse (inference and training);
* ``csrc/flash_attention_bwd.cu`` (bf16) and ``csrc/flash_attention_bwd_f32.cu``
  (f32): with P = exp(Q K^T - lse) and D = rowsum(dO * O) in f32, the dQ
  kernel computes dS = P * (dO V^T - D) and dQ = dS K, the dK/dV kernel
  dK = dS^T Q and dV = P^T dO;
* ``csrc/flash_attention_int8.cu``: per-slice dynamic int8 quantization (a
  pre-pass kernel before the launch, ``int8_prepass``; its plain version is
  ``int8_kernel_inputs``), S = int32(Qi Ki^T) * sq * sk / 127^2, and PV in
  bf16 (mode 'int8_qk') or, on p_q = round(127 p) and int8 V, in int8 (mode
  'int8').

The kernels are Hopper CUDA C++ for bf16 (the forward with and without lse
and both backward kernels for f32 too) and d in HEAD_DIMS, built at first use
and bound with ctypes (``frn_tpu_torch/build.py``).
Each wrapper launches its kernel for a CUDA tensor and, for a CPU tensor, runs
its plain version, which follows the kernel's tile loop in PyTorch; on a CUDA
tensor it launches the kernel or raises, and never falls back. ``FlashAttentionFn`` is the
differentiable route (forward with lse, then both backward kernels); the
bf16-exp and int8 forwards define no gradient. The module-level counters count
each kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from frn_tpu_torch import build

HEAD_DIMS = (8, 16, 32, 64)
INT8_MODES = ("int8_qk", "int8")
KERNEL_TILE = 64  # keys per tile of the forward kernels (B1, B3, B4)
_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)  # the kernels' kLog2e
flash_fwd_launches = 0  # forward without lse (inference)
flash_fwd_lse_launches = 0  # forward with lse (the forward of training)
flash_fwd_f32_launches = 0  # forward on f32 inputs (inference)
flash_fwd_lse_f32_launches = 0  # forward with lse on f32 inputs (training at f32)
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
flash_bwd_dq_f32_launches = 0
flash_bwd_dkv_f32_launches = 0
flash_fwd_bf16exp_launches = 0
flash_int8_qk_launches = 0
flash_int8_launches = 0
int8_qk_prepass_launches = 0  # the int8 kernel's quantization pre-pass, by mode
int8_prepass_launches = 0
INT8_PARTIALS = 32  # the pre-pass's partial maxima per batch slice (kPartials in the source)
_lib = None  # csrc/flash_attention.cu
_bwd_lib = None  # csrc/flash_attention_bwd.cu
_int8_lib = None  # csrc/flash_attention_int8.cu
_f32_lib = None  # csrc/flash_attention_f32.cu
_bwd_f32_lib = None  # csrc/flash_attention_bwd_f32.cu

_P = ctypes.c_void_p
_I = ctypes.c_int


def bind_forward(lib):
    """Declares the C signatures of ``csrc/flash_attention.cu``'s entry points
    on a loaded library; returns it."""
    lib.frn_flash_fwd_bf16.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.frn_flash_fwd_bf16exp_bf16.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.frn_flash_fwd_bf16.restype = lib.frn_flash_fwd_bf16exp_bf16.restype = _I
    return lib


def bind_backward(lib, dtype: str = "bf16"):
    """The same for ``csrc/flash_attention_bwd.cu`` (``dtype`` 'bf16') or
    ``csrc/flash_attention_bwd_f32.cu`` ('f32'): one signature for both."""
    dq, dkv = getattr(lib, f"frn_flash_bwd_dq_{dtype}"), getattr(lib, f"frn_flash_bwd_dkv_{dtype}")
    dq.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    dkv.argtypes = [_P] * 8 + [_I] * 3 + [_P]
    dq.restype = dkv.restype = _I
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind_forward(build.load("flash_attention"))
    return _lib


def bind_f32(lib):
    """The same for ``csrc/flash_attention_f32.cu``."""
    lib.frn_flash_fwd_f32.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.frn_flash_fwd_f32.restype = _I
    return lib


def _f32_library() -> ctypes.CDLL:
    global _f32_lib
    if _f32_lib is None:
        _f32_lib = bind_f32(build.load("flash_attention_f32"))
    return _f32_lib


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        _bwd_lib = bind_backward(build.load("flash_attention_bwd"))
    return _bwd_lib


def _bwd_f32_library() -> ctypes.CDLL:
    global _bwd_f32_lib
    if _bwd_f32_lib is None:
        _bwd_f32_lib = bind_backward(build.load("flash_attention_bwd_f32"), "f32")
    return _bwd_f32_lib


def bind_int8(lib):
    """The same for ``csrc/flash_attention_int8.cu``: the kernel and its
    quantization pre-pass (an earlier revision without the pre-pass binds the
    kernel alone)."""
    lib.frn_flash_int8.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    lib.frn_flash_int8.restype = _I
    if hasattr(lib, "frn_flash_int8_prepass"):
        lib.frn_flash_int8_prepass.argtypes = [_P] * 9 + [_I] * 5 + [_P]
        lib.frn_flash_int8_prepass.restype = _I
    return lib


def _int8_library() -> ctypes.CDLL:
    global _int8_lib
    if _int8_lib is None:
        _int8_lib = bind_int8(build.load("flash_attention_int8"))
    return _int8_lib


# ------------------------------------------------------------ plain versions


def _online_softmax(q, k, v, block_k: int, weights, scale=None):
    """The kernels' recurrence over key tiles of ``block_k``: f32 scores s
    (times the (B,) ``scale`` if given), running row max m and denominator l,
    f32 accumulator. Scores of bf16 or f16 inputs on the card are summed by
    the tensor cores (``torch.bmm`` with ``out_dtype=float32``), which
    truncate what they add, as the kernels' products do; elsewhere in f32.
    ``weights(s, m_new)`` gives (the weights of the PV product, those of the
    denominator), both f32. Returns (acc / l, m, l)."""
    b, n, _ = q.shape
    qf = q.float()
    tensor_core = q.is_cuda and q.dtype in (torch.bfloat16, torch.float16)
    m = torch.full((b, n, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n, v.shape[2]), dtype=torch.float32, device=q.device)
    for start in range(0, n, block_k):
        kb = k[:, start:start + block_k]
        vb = v[:, start:start + block_k].float()
        if tensor_core:
            s = torch.bmm(q, kb.transpose(1, 2).contiguous(), out_dtype=torch.float32)
        else:
            s = torch.bmm(qf, kb.float().transpose(1, 2))
        if scale is not None:
            s = s * scale[:, None, None]
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        alpha = torch.exp(m - m_new)
        p_pv, p_sum = weights(s, m_new)
        l = l * alpha + p_sum.sum(dim=2, keepdim=True)
        acc = acc * alpha + torch.bmm(p_pv, vb)
        m = m_new
    return acc / l, m, l


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_k: int = KERNEL_TILE,
    return_lse: bool = False,
):
    """softmax(q k^T) v by the kernel's recurrence: f32 scores, running max and
    denominator, p rounded to v's dtype before the PV product and summed so
    rounded into the denominator (as the JAX kernel's ones lane sums it), f32
    accumulator divided by the denominator at the end. (B, N, d) in,
    (B, N, d) out; with ``return_lse`` also lse = m + log(l), (B, N) f32.
    Below f32, p is rounded against the running max of the key tiles seen so
    far, so the result depends on ``block_k`` (by up to about 1e-3 in lse at
    bf16): the default is the kernels' KERNEL_TILE. p is the kernel's
    ex2(fma(s, log2 e, -m log2 e)), its argument rounded once as the FMA
    rounds it (the f64 product of two f32 is exact), so that p rounds to the
    kernel's bf16 p wherever the two exps agree to the bf16 rounding."""

    def weights(s, m_new):
        mb = (m_new * _LOG2E).double()
        p = torch.exp2((s.double() * _LOG2E.double() - mb).float()).to(v.dtype).float()
        return p, p

    o, m, l = _online_softmax(q, k, v, block_k, weights)
    o = o.to(v.dtype)
    if return_lse:
        return o, (m + torch.log(l)).squeeze(2)
    return o


def flash_attention_bf16exp_plain(q, k, v, block_k: int = KERNEL_TILE) -> torch.Tensor:
    """softmax(q k^T) v by the bf16-exp kernel's recurrence: as
    ``flash_attention_plain``, but p = exp(bf16(s - m_new)) rounded to v's
    dtype (for the kernel's bf16 v: bf16(exp(bf16(s - m_new)))), m_new the
    running max over the key tiles seen so far (so the result depends on
    ``block_k``, the kernel's KERNEL_TILE), and the denominator sums those
    rounded p, as the JAX kernel's ones lane does."""

    def weights(s, m_new):
        p = torch.exp((s - m_new).to(torch.bfloat16).float()).to(v.dtype).float()
        return p, p

    return _online_softmax(q, k, v, block_k, weights)[0].to(v.dtype)


def quantize_int8(x: torch.Tensor):
    """Dynamic symmetric int8 quantization per batch slice, as the JAX
    package's pre-pass: s = max|x| over (N, d), at least 1e-30, and
    xi = round(x * (127 / s)) (ties to even), 127 / s an IEEE f32 division
    (torch computes ``127.0 / s`` as 127 * (1 / s), which is one ulp off a
    quarter of the time). Returns (xi int8, s (B,) f32)."""
    xf = x.float()
    s = xf.abs().amax(dim=(1, 2), keepdim=True).clamp_min(1e-30)
    return torch.round(xf * (torch.full_like(s, 127.0) / s)).to(torch.int8), s[:, 0, 0]


def quantize_qk(q: torch.Tensor, k: torch.Tensor):
    """(qi, ki int8, the (B,) score scale c = sq * sk / 127^2)."""
    qi, sq = quantize_int8(q)
    ki, sk = quantize_int8(k)
    return qi, ki, sq * sk * (1.0 / (127.0 * 127.0))


def flash_attention_int8_plain(q, k, v, mode: str = "int8",
                               block_k: int = KERNEL_TILE) -> torch.Tensor:
    """The int8 kernel's function by its recurrence over key tiles of
    ``block_k``: S = (Qi Ki^T) * c in f32, online softmax in f32. 'int8_qk':
    p rounded to v's dtype feeds the PV product and the denominator. 'int8':
    p_q = round(127 p) against the running max (so the result depends on
    ``block_k``), PV on p_q and the int8 V, denominator 127 * sum(p_q); the
    output is rounded to q's dtype, multiplied by sv and rounded again. The
    int8 dot products over d <= 64 stay below 2^24: f32 holds them exactly."""
    _check_mode(mode)
    qi, ki, c = quantize_qk(q, k)
    qi, ki = qi.float(), ki.float()
    if mode == "int8_qk":

        def weights(s, m_new):
            p = torch.exp(s - m_new).to(v.dtype).float()
            return p, p

        return _online_softmax(qi, ki, v, block_k, weights, c)[0].to(v.dtype)

    vi, sv = quantize_int8(v)

    def weights(s, m_new):
        p_q = torch.round(torch.exp(s - m_new) * 127.0)
        return p_q, p_q * 127.0

    o = _online_softmax(qi, ki, vi.float(), block_k, weights, c)[0].to(q.dtype)
    return (o.float() * sv[:, None, None]).to(q.dtype)


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


def quantized_attention_reference(g, theta, phi, mode: str = "int8") -> torch.Tensor:
    """Dense simulation of the int8 kernel's quantization algebra (the JAX
    package's ``quantized_attention_reference``): with one key tile covering
    all keys the kernel's running max is the row max, and the two agree up to
    f32 summation order."""
    _check_mode(mode)
    qi, ki, c = quantize_qk(phi, theta)
    s = torch.bmm(qi.float(), ki.float().transpose(1, 2)) * c[:, None, None]
    if mode == "int8_qk":
        attn = torch.softmax(s, dim=-1).to(g.dtype)
        return torch.bmm(attn.float(), g.float()).to(g.dtype)
    p_q = torch.round(torch.exp(s - s.amax(dim=-1, keepdim=True)) * 127.0)
    vi, sv = quantize_int8(g)
    num = torch.bmm(p_q, vi.float())
    den = p_q.sum(dim=-1, keepdim=True)
    return ((num / den) * (sv / 127.0)[:, None, None]).to(g.dtype)


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


def _check_mode(mode: str) -> None:
    if mode not in INT8_MODES:
        raise ValueError(f"int8 attention mode must be one of {INT8_MODES}, got {mode!r}")


def _refuse_grad(what: str, *xs: torch.Tensor) -> None:
    """A kernel output carries no gradient: on the card an input that requires
    grad (with grad mode on) raises instead of returning a detached tensor."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(what)


def _on_kernel_device(q: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for CUDA; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"the port's kernels run on cuda or cpu, not {q.device}")
    return True


def _launch(fn, q: torch.Tensor, *args) -> None:
    """Calls the C entry point ``fn(*args, stream)`` on q's device and current
    stream; raises on the CUDA error code it returns."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


# ------------------------------------------------------------ kernel wrappers

_BF16 = torch.bfloat16
_F32 = torch.float32


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool = False):
    """O = softmax(q k^T) v, (B, N, d), and with ``return_lse`` also the (B, N)
    f32 logsumexp. The kernel on CUDA, the plain version on CPU.

    The shape rules (one (B, N, d) shape, d in HEAD_DIMS) hold on both; the
    kernel further takes only contiguous, 16-byte aligned inputs on one
    device, all bf16 (``csrc/flash_attention.cu``) or all f32
    (``csrc/flash_attention_f32.cu``). Its output carries no gradient, so on
    CUDA an input that requires grad (with grad mode on) raises:
    ``FlashAttentionFn.apply`` is the differentiable route.
    """
    global flash_fwd_launches, flash_fwd_lse_launches, flash_fwd_f32_launches
    global flash_fwd_lse_f32_launches
    _check_shapes(q, k, v)
    if not _on_kernel_device(q):
        return flash_attention_plain(q, k, v, return_lse=return_lse)
    _refuse_grad("flash_attention's kernel output carries no gradient; use "
                 "FlashAttentionFn.apply(q, k, v) where a gradient is needed", q, k, v)
    b, n, d = q.shape
    f32 = q.dtype == _F32
    dtype = _F32 if f32 else _BF16
    _check_kernel_args(q, ("q", q, dtype), ("k", k, dtype), ("v", v, dtype))
    o = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=_F32, device=q.device) if return_lse else None
    if o.numel():
        fn = _f32_library().frn_flash_fwd_f32 if f32 else _library().frn_flash_fwd_bf16
        _launch(fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), b, n, d)
        if f32 and return_lse:
            flash_fwd_lse_f32_launches += 1
        elif f32:
            flash_fwd_f32_launches += 1
        elif return_lse:
            flash_fwd_lse_launches += 1
        else:
            flash_fwd_launches += 1
    return (o, lse) if return_lse else o


def flash_attention_bf16exp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """O = softmax(q k^T) v with bf16 softmax weights, (B, N, d): the forward
    kernel with its bf16-exp flag on CUDA, ``flash_attention_bf16exp_plain``
    on CPU. Inference only: on CUDA an input that requires grad raises."""
    global flash_fwd_bf16exp_launches
    _check_shapes(q, k, v)
    if not _on_kernel_device(q):
        return flash_attention_bf16exp_plain(q, k, v)
    _refuse_grad("the bf16-exp flash forward is inference only: it defines no gradient", q, k, v)
    _check_kernel_args(q, ("q", q, _BF16), ("k", k, _BF16), ("v", v, _BF16))
    b, n, d = q.shape
    o = torch.empty_like(q)
    if o.numel():
        _launch(_library().frn_flash_fwd_bf16exp_bf16, q, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), b, n, d)
        flash_fwd_bf16exp_launches += 1
    return o


# slot s of each 32-key group of the int8 PV product holds key _PV_KEY_ORDER[s]:
# the order in which a thread's QK^T C fragments (keys 2t, 2t+1 of each 8-key
# tile) sit in the m16n8k32 A fragment (slots 4t..4t+3, 16+4t..16+4t+3)
_PV_KEY_ORDER = [16 * (s // 16) + 2 * (s % 16 // 4) + (s % 2) + 8 * (s % 4 // 2) for s in range(32)]


def int8_v_layout(vi: torch.Tensor) -> torch.Tensor:
    """int8 V (B, N, d) -> (B, d, N_pad), the 'int8' kernel's B operand: keys
    padded with zeros to a multiple of KERNEL_TILE and put in _PV_KEY_ORDER
    within each group of 32, so each fragment register is one 32-bit load."""
    b, n, d = vi.shape
    n_pad = -(-n // KERNEL_TILE) * KERNEL_TILE
    vp = torch.nn.functional.pad(vi, (0, 0, 0, n_pad - n)).view(b, n_pad // 32, 32, d)
    order = torch.tensor(_PV_KEY_ORDER, device=vi.device)
    return vp.index_select(2, order).permute(0, 3, 1, 2).contiguous().view(b, d, n_pad)


def int8_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: str):
    """The int8 kernel's inputs from bf16 (B, N, d) q, k, v: (qi, ki, V as the
    kernel takes it, the (B,) score scale sq * sk / 127^2, the (B,) V scale or
    None). Mode 'int8_qk' keeps v; 'int8' quantizes it into ``int8_v_layout``."""
    qi, ki, scale = quantize_qk(q, k)
    if mode == "int8_qk":
        return qi, ki, v, scale, None
    vi, sv = quantize_int8(v)
    return qi, ki, int8_v_layout(vi), scale, sv


def int8_prepass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mode: str):
    """The int8 kernel's inputs, as ``int8_kernel_inputs`` returns them: on
    CUDA the pre-pass kernel (two launches: partial maxima per batch slice,
    then the quantization into the kernel's layouts), bitwise equal to
    ``int8_kernel_inputs``, which is its plain version and runs on CPU."""
    global int8_qk_prepass_launches, int8_prepass_launches
    _check_mode(mode)
    _check_shapes(q, k, v)
    if not _on_kernel_device(q):
        return int8_kernel_inputs(q, k, v, mode)
    _check_kernel_args(q, ("q", q, _BF16), ("k", k, _BF16), ("v", v, _BF16))
    b, n, d = q.shape
    full = mode == "int8"
    n_pad = -(-n // KERNEL_TILE) * KERNEL_TILE
    dev = q.device
    qi = torch.empty((b, n, d), dtype=torch.int8, device=dev)
    ki = torch.empty_like(qi)
    vk = torch.empty((b, d, n_pad), dtype=torch.int8, device=dev) if full else v
    scale = torch.empty((b,), dtype=_F32, device=dev)
    v_scale = torch.empty((b,), dtype=_F32, device=dev) if full else None
    if not qi.numel():
        return qi, ki, vk, scale, v_scale
    partial = torch.empty((3 if full else 2, b, INT8_PARTIALS), dtype=torch.int32, device=dev)
    _launch(_int8_library().frn_flash_int8_prepass, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            partial.data_ptr(), qi.data_ptr(), ki.data_ptr(), vk.data_ptr() if full else None,
            scale.data_ptr(), v_scale.data_ptr() if full else None, b, n, n_pad, d, int(full))
    if full:
        int8_prepass_launches += 1
    else:
        int8_qk_prepass_launches += 1
    return qi, ki, vk, scale, v_scale


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mode: str = "int8") -> torch.Tensor:
    """softmax(q k^T) v with int8 quantization, mode 'int8_qk' or 'int8', (B,
    N, d) bf16 in and out: on CUDA the pre-pass kernel (``int8_prepass``),
    then the int8 kernel; ``flash_attention_int8_plain`` on CPU. Inference
    only: on CUDA an input that requires grad raises."""
    global flash_int8_qk_launches, flash_int8_launches
    _check_mode(mode)
    _check_shapes(q, k, v)
    if not _on_kernel_device(q):
        return flash_attention_int8_plain(q, k, v, mode)
    _refuse_grad("the int8 flash forward is inference only: it defines no gradient", q, k, v)
    _check_kernel_args(q, ("q", q, _BF16), ("k", k, _BF16), ("v", v, _BF16))
    b, n, d = q.shape
    o = torch.empty_like(q)
    if not o.numel():
        return o
    qi, ki, vk, scale, v_scale = int8_prepass(q, k, v, mode)
    full = mode == "int8"
    _launch(_int8_library().frn_flash_int8, q, qi.data_ptr(), ki.data_ptr(), vk.data_ptr(),
            scale.data_ptr(), None if v_scale is None else v_scale.data_ptr(), o.data_ptr(),
            b, n, vk.shape[2] if full else n, d, int(full))
    if full:
        flash_int8_launches += 1
    else:
        flash_int8_qk_launches += 1
    return o


def _check_bwd(q, k, v, do, lse, delta):
    """None for CPU tensors (the plain versions run); on CUDA the kernels'
    input dtype, bf16 or f32 (q's), after every argument is checked against
    it: q, k, v and do all of it, lse and delta f32. Any mix raises."""
    _check_shapes(q, k, v, do)
    _check_rows(q, lse=lse, delta=delta)
    if not _on_kernel_device(q):
        return None
    dtype = _F32 if q.dtype == _F32 else _BF16
    _check_kernel_args(q, ("q", q, dtype), ("k", k, dtype), ("v", v, dtype), ("do", do, dtype),
                       ("lse", lse, _F32), ("delta", delta, _F32))
    return dtype


def flash_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dQ (B, N, d): the dQ kernel on CUDA (bf16 or f32 inputs),
    ``flash_bwd_dq_plain`` on CPU."""
    global flash_bwd_dq_launches, flash_bwd_dq_f32_launches
    dtype = _check_bwd(q, k, v, do, lse, delta)
    if dtype is None:
        return flash_bwd_dq_plain(q, k, v, do, lse, delta)
    b, n, d = q.shape
    dq = torch.empty_like(q)
    if dq.numel():
        fn = (_bwd_f32_library().frn_flash_bwd_dq_f32 if dtype == _F32
              else _bwd_library().frn_flash_bwd_dq_bf16)
        _launch(fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), b, n, d)
        if dtype == _F32:
            flash_bwd_dq_f32_launches += 1
        else:
            flash_bwd_dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each (B, N, d): the dK/dV kernel on CUDA (bf16 or f32
    inputs), the plain version on CPU."""
    global flash_bwd_dkv_launches, flash_bwd_dkv_f32_launches
    dtype = _check_bwd(q, k, v, do, lse, delta)
    if dtype is None:
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    b, n, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        fn = (_bwd_f32_library().frn_flash_bwd_dkv_f32 if dtype == _F32
              else _bwd_library().frn_flash_bwd_dkv_bf16)
        _launch(fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n, d)
        if dtype == _F32:
            flash_bwd_dkv_f32_launches += 1
        else:
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
    dQ and dK/dV kernels, at bf16 or at f32 as the inputs are (the plain
    versions on CPU). Counterpart of the JAX package's ``custom_vjp``
    ``_fwd``/``_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_backward(q, k, v, o, lse, do.contiguous())
