"""The exponential-free forward (``flash_attention_noexp``) against
``tools/bench_flash.py``'s Pallas kernel ``_kernel_noexp``, on the CPU.

The tool calls ``pl.pallas_call`` for a TPU; here its module's ``pl`` is a
shim whose ``pallas_call`` runs in interpret mode (the tool itself is not
changed). Its blocks pad N to a multiple of ``block_k`` and every padded key
adds -1e30 * 1e-4 to the row's l, so the two are compared only where N is a
multiple of both blocks (the port computes the unpadded function).

Inputs are bf16 from a numpy seed. Tolerance: the two sum the same f32 p in
another order (the tool per 128-key block, the port per 64-key tile), and the
output is rounded to bf16, so an output may land one bf16 step apart: atol
is one bf16 step (2^-8) of the largest |output| (outputs are below 0.07
here; the largest gap seen was 1.2e-4, in 28 of 49,152 outputs), rtol 2^-8;
each row's m + l agrees to f32 summation order (rtol 1e-5).
"""

import functools
import types

import numpy as np
import pytest
import torch

from frn_tpu_torch.ops import flash_attention as fa

OUT_STEP = 2.0 ** -8  # one bf16 step, relative
ML_RTOL, ML_ATOL = 1e-5, 1e-4


def _qkv(b, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, n, d)).astype(np.float32) for _ in range(3)]


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.fixture
def tool(monkeypatch):
    """tools/bench_flash with pallas_call in interpret mode, and a call that
    also returns the kernel's (B, N) m + l (its second output, lane 0)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from tools import bench_flash

    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(bench_flash, "pl", shim)

    def run(q, k, v, block_q, block_k):
        qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        out = bench_flash.flash_noexp(qj, kj, vj, block_q=block_q, block_k=block_k)
        return np.asarray(jax.device_get(out.astype(jnp.float32)))

    return bench_flash, run


@pytest.mark.parametrize("blocks", [(128, 128), (64, 128)], ids=lambda b: f"bq{b[0]}_bk{b[1]}")
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [256, 384])
def test_plain_matches_the_tools_pallas_kernel(tool, n, d, blocks):
    _, run = tool
    q, k, v = _qkv(2, n, d, seed=n + d)
    want = run(q, k, v, *blocks)
    got = fa.flash_attention_noexp_plain(_bf16(q), _bf16(k), _bf16(v))
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=OUT_STEP * np.abs(want).max(),
                               rtol=OUT_STEP)


def test_row_m_plus_l_matches_the_tools_second_output(tool, monkeypatch):
    """The tool drops its (m + l) output; rebuild its call to keep it."""
    import jax.numpy as jnp

    bench_flash, _ = tool
    b, n, d = 2, 256, 32
    q, k, v = _qkv(b, n, d, seed=3)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    captured = {}
    real = bench_flash.pl.pallas_call

    def keep(*a, **kw):
        call = real(*a, **kw)

        def wrapped(*args):
            out, ml = call(*args)
            captured["ml"] = ml
            return out, ml
        return wrapped

    monkeypatch.setattr(bench_flash.pl, "pallas_call", keep)
    bench_flash.flash_noexp.__wrapped__(qj, kj, vj, block_q=128, block_k=128)
    want = np.asarray(captured["ml"])[:, :n, 0]
    _, got = fa.flash_attention_noexp_plain(_bf16(q), _bf16(k), _bf16(v), return_ml=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=ML_RTOL, atol=ML_ATOL)


def test_a_ragged_n_is_the_unpadded_function():
    """At N 200 (not a multiple of 64) the port's plain version is the
    function on the 200 keys alone: a dense computation of it, in f32."""
    q, k, v = (_bf16(x) for x in _qkv(1, 200, 32, seed=7))
    s = q.float() @ k.float().transpose(1, 2)
    p = s * fa.NOEXP_SCALE
    want = (p.to(torch.bfloat16).float() @ v.float()) / (p.sum(2, keepdim=True) + 1)
    got, ml = fa.flash_attention_noexp_plain(q, k, v, return_ml=True)
    want = want.to(torch.bfloat16).float()
    torch.testing.assert_close(got.float(), want, atol=OUT_STEP * want.abs().max().item(),
                               rtol=OUT_STEP)
    torch.testing.assert_close(ml, s.amax(2) + p.sum(2), rtol=ML_RTOL, atol=ML_ATOL)


def test_the_wrapper_runs_the_plain_version_on_the_cpu_and_counts_no_launch():
    q, k, v = (_bf16(x) for x in _qkv(2, 128, 64, seed=1))
    before = fa.flash_fwd_noexp_launches
    got = fa.flash_attention_noexp(q, k, v)
    assert fa.flash_fwd_noexp_launches == before
    torch.testing.assert_close(got, fa.flash_attention_noexp_plain(q, k, v), atol=0, rtol=0)


@pytest.mark.parametrize("case", ["f32", "f16", "d8", "d16", "mixed", "shape"])
def test_the_wrapper_refuses_other_dtypes_dims_and_shapes(case):
    d = {"d8": 8, "d16": 16}.get(case, 32)
    q, k, v = (_bf16(x) for x in _qkv(2, 64, d, seed=2))
    if case in ("f32", "f16"):
        q, k, v = (x.to(torch.float32 if case == "f32" else torch.float16) for x in (q, k, v))
    elif case == "mixed":
        v = v.float()
    elif case == "shape":
        k = k[:, :32]
    error = TypeError if case in ("f32", "f16", "mixed") else ValueError
    with pytest.raises(error):
        fa.flash_attention_noexp(q, k, v)


def test_the_library_binds_the_kernels_entry_point():
    """bind_forward declares the C signature where the source has it (an
    earlier revision's library, without it, binds as before)."""

    class Lib:
        def __init__(self, names):
            for name in names:
                setattr(self, name, types.SimpleNamespace())

    full = fa.bind_forward(Lib(["frn_flash_fwd_bf16", "frn_flash_fwd_bf16exp_bf16",
                                "frn_flash_fwd_noexp_bf16"]))
    assert len(full.frn_flash_fwd_noexp_bf16.argtypes) == 9
    older = fa.bind_forward(Lib(["frn_flash_fwd_bf16", "frn_flash_fwd_bf16exp_bf16"]))
    assert not hasattr(older, "frn_flash_fwd_noexp_bf16")


# ------------------------------------------------------------ the kernel, phase 1 and the tool


ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def test_the_source_holds_the_mode_at_d_32_and_64_only():
    src = (ROOT / "frn_tpu_torch" / "csrc" / "flash_attention.cu").read_text()
    assert "constexpr float kNoExpScale = 1e-4f;" in src
    assert float(fa.NOEXP_SCALE) == np.float32(1e-4)
    assert 'extern "C" int frn_flash_fwd_noexp_bf16(' in src
    assert "return launch_d<kModeNoExp>(d, make_args(q, k, v, o, ml, batch, n, stream));" in src
    # the mma.sync kernel (d 8 and 16) has no such mode
    launch = src[src.index("int launch_d(int d, const Args& a) {"):]
    assert "if constexpr (kMode != kModeNoExp) {" in launch.split("switch (d)")[0]
    assert fa.NOEXP_HEAD_DIMS == (32, 64)


def _ptxas_log(instances: dict) -> str:
    return "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_fwd_wgmmaILi{d}ELi"
        f"{mode}ELi{1 if d == 32 else 2}EEEv14CUtensorMap_stS1_PK13__nv_bfloat16PS2_Pfi' for "
        "'sm_90a'\nptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for (_, d, mode), (regs, spill) in instances.items())


@pytest.mark.parametrize("d", [32, 64])
def test_phase_1_requires_the_instance_unspilled(capsys, d):
    import chip_smoke

    every = {key: (154, 0) for key in chip_smoke.PATH_INSTANCES["flash_attention"]}
    assert ("flash_fwd_wgmma", d, 2) in every and len(every) == 6
    chip_smoke.check_path_instances("flash_attention", _ptxas_log(every))
    assert f"flash_fwd_wgmma<{d}, 2, {1 if d == 32 else 2}>: 154 registers" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention",
                                        _ptxas_log({**every, ("flash_fwd_wgmma", d, 2): (168, 8)}))
    missing = {k: v for k, v in every.items() if k != ("flash_fwd_wgmma", d, 2)}
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention", _ptxas_log(missing))


def test_the_kernels_line_names_b6_and_its_counter():
    import chip_smoke

    source, replaces = chip_smoke.KERNEL_SOURCES["flash_fwd_noexp"]
    assert (ROOT / source).is_file()
    path, line = replaces.split(":")
    assert (ROOT / path).read_text().splitlines()[int(line) - 1].startswith("def _kernel_noexp(")
    module, attr = chip_smoke._COUNTERS["flash_fwd_noexp"]
    assert module == "flash_attention" and hasattr(fa, attr)


def test_the_tools_bounds_and_report():
    from frn_tpu_torch.tools import bench_flash

    b = bench_flash.bounds(8, 19200, 32)
    assert b["products_bound_ms"] == pytest.approx(4 * 8 * 19200 ** 2 * 32 / 989e12 * 1e3)
    assert b["exp_bound_ms"] == pytest.approx(8 * 19200 ** 2 / 3.9e12 * 1e3)
    assert b["bytes_bound_ms"] == pytest.approx(8 * 8 * 19200 * 32 / 3.35e12 * 1e3)
    assert b["qk_bytes_bound_ms"] == pytest.approx((4 * 8 * 19200 * 32 + 2 * 8 * 19200 ** 2)
                                                   / 3.35e12 * 1e3)
    assert bench_flash.SHAPES == ((8, 19200, 32), (16, 4800, 64))
    r = {"B": 8, "N": 19200, "d": 32, "b1_ms": 1.3, "noexp_ms": 0.6, "qk_ms": 2.0,
         "exp_ms": 0.7, "exp_share": 0.7 / 1.3, "exp_per_s": 8 * 19200 ** 2 / 0.7e-3, **b}
    text = bench_flash.report(r)
    assert "B1 less the exponential-free   0.7000 ms = 53.8% of B1 (exponentials, rescale" in text
    assert "5.90 GB" in text


def test_the_tool_needs_a_card(monkeypatch, capsys):
    from frn_tpu_torch.tools import bench_flash

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_flash.main() == 1
    assert "no CUDA card" in capsys.readouterr().err
