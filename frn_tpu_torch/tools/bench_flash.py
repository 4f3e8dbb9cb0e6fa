"""The flash forward's time split into products and exponentials, on the card.

Counterpart of ``tools/bench_flash.py``'s ``main``: the flash forward (B1,
``flash_attention``) beside the exponential-free forward
(``flash_attention_noexp``: the same data flow with p = s * 1e-4 in place of
the exponential), so that their difference bounds what the exponentials
cost: the exponential-free kernel also drops B1's per-tile rescale of acc
and l and the ones-lane product that sums l. Beside them the materialized
Q K^T by ``torch.matmul`` (the tool's "MXU ceiling").

    python -m frn_tpu_torch.tools.bench_flash

At DSEC stages 1 and 2, (B, N, d) bf16 = (8, 19,200, 32) and (16, 4,800, 64),
it prints B1's ms, the exponential-free
kernel's ms, their difference (``exp_ms``) and its share of B1, the
exponentials per second it would imply if it were all theirs (B N^2 over
it), and Q K^T's
ms, each beside its bound: products (4 B N^2 d flops; 2 B N^2 d for Q K^T)
at the tensor cores' bf16 rate, bytes (Q, K, V in and O out once; Q K^T's
(B, N, N) bf16 output) at the memory rate, and B1's B N^2 exponentials at
the special-function units' rate (the exponential-free kernel has none).
Times are CUDA events over ``REPS`` launches after two warm-up launches;
then one JSON line per shape. The TPU tool's block sweep (``q_splits``,
``k_splits``) and its lane padding are TPU machinery and have no
counterpart here. Needs one CUDA card; the kernels are built at first use.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from frn_tpu_torch.ops import flash_attention as fa

# H100 SXM peaks (NVIDIA data sheet) and the special-function units' exp rate
# (FlashAttention-3 paper, H100 SXM5)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
EXP_PER_S = 3.9e12
SHAPES = ((8, 19200, 32), (16, 4800, 64))  # DSEC stages 1 and 2 at the inference batch
REPS = 20  # timed launches per kernel


def cuda_ms(fn, reps: int = REPS, warmup: int = 2):
    """(mean ms of ``fn`` over ``reps`` calls by CUDA events, its last output)."""
    for _ in range(warmup):
        out = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bounds(b: int, n: int, d: int) -> dict:
    """Least times (ms) of the work at (B, N, d): the two kernels' bytes and
    products, B1's exponentials, and Q K^T's bytes and products."""
    return {"bytes_bound_ms": 8 * b * n * d / HBM_BYTES_PER_S * 1e3,
            "products_bound_ms": 4 * b * n * n * d / BF16_FLOP_PER_S * 1e3,
            "exp_bound_ms": b * n * n / EXP_PER_S * 1e3,
            "qk_bytes_bound_ms": (4 * b * n * d + 2 * b * n * n) / HBM_BYTES_PER_S * 1e3,
            "qk_products_bound_ms": 2 * b * n * n * d / BF16_FLOP_PER_S * 1e3}


def measure(b: int, n: int, d: int) -> dict:
    """B1, the exponential-free kernel and Q K^T timed at (B, N, d) on seeded
    bf16 inputs, with their bounds (``bounds``) and the split."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    b1_ms, _ = cuda_ms(lambda: fa.flash_attention(q, k, v))
    noexp_ms, _ = cuda_ms(lambda: fa.flash_attention_noexp(q, k, v))
    kt = k.transpose(1, 2)
    qk_ms, s = cuda_ms(lambda: torch.matmul(q, kt), REPS // 4, warmup=1)
    del s
    torch.cuda.empty_cache()
    exp_ms = b1_ms - noexp_ms
    return {"B": b, "N": n, "d": d, "b1_ms": b1_ms, "noexp_ms": noexp_ms, "qk_ms": qk_ms,
            "exp_ms": exp_ms, "exp_share": exp_ms / b1_ms,
            "exp_per_s": b * n * n / (exp_ms * 1e-3) if exp_ms > 0 else None, **bounds(b, n, d)}


def report(r: dict) -> str:
    """The printout of one ``measure`` result."""
    by, pr, ex = r["bytes_bound_ms"], r["products_bound_ms"], r["exp_bound_ms"]
    b1_bound, noexp_bound = max(by, pr, ex), max(by, pr)
    qk_bound = max(r["qk_bytes_bound_ms"], r["qk_products_bound_ms"])
    rate = "n/a (not faster)" if r["exp_per_s"] is None else f"{r['exp_per_s'] / 1e12:.3f}e12/s"
    return "\n".join([
        f"shape B={r['B']} N={r['N']} d={r['d']} bf16",
        f"  flash forward (B1)          {r['b1_ms']:9.4f} ms, bound {b1_bound:.4f} ms (products "
        f"{pr:.4f}, exponentials {ex:.4f}, bytes {by:.4f}): {b1_bound / r['b1_ms']:.1%} of it",
        f"  exponential-free forward    {r['noexp_ms']:9.4f} ms, bound {noexp_bound:.4f} ms "
        f"(products {pr:.4f}, bytes {by:.4f}): {noexp_bound / r['noexp_ms']:.1%} of it",
        f"  B1 less the exponential-free {r['exp_ms']:8.4f} ms = {r['exp_share']:.1%} of B1 "
        f"(exponentials, rescale, ones lane): {r['B'] * r['N'] ** 2 / 1e9:.3f} G exponentials "
        f"at {rate} if all theirs (special-function units {EXP_PER_S / 1e12:.1f}e12/s)",
        f"  Q K^T materialized (matmul) {r['qk_ms']:9.4f} ms, bound {qk_bound:.4f} ms (products "
        f"{r['qk_products_bound_ms']:.4f}, bytes {r['qk_bytes_bound_ms']:.4f}: the (B, N, N) bf16 "
        f"scores, {2 * r['B'] * r['N'] ** 2 / 1e9:.2f} GB)",
    ])


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    for b, n, d in SHAPES:
        r = measure(b, n, d)
        print(report(r), flush=True)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
