"""The f32 forward (B1 and B1-lse at f32): its launch plan against the CUDA
source's constants, its routing on the kernel path, and its plain version
against the JAX package's Pallas kernel at f32.

The kernel itself (``csrc/flash_attention_f32.cu``) runs only on the card;
``chip_smoke.py`` holds it against ``flash_attention_plain`` there. Bounds of
the JAX comparison are the f32 tolerances of ``chip_smoke.py``: o atol 2e-5
rtol 1e-4, lse atol 1e-4.
"""

import re
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from frn_tpu.ops.flash_attention import _flash_forward
from frn_tpu_torch import build
from frn_tpu_torch.ops import flash_attention as fa

RNG = np.random.default_rng(23)
SOURCE = (build.CSRC / "flash_attention_f32.cu").read_text()
H100_SMS = 132

# every launch of the f32 forward on the paths: (B, N, d) -> blocks of 64 rows
PATH_BLOCKS = {
    (8, 19200, 32): 2400,  # eval, DSEC stage 1
    (8, 4800, 64): 600,  # eval, DSEC stage 2
    (8, 5655, 32): 712,  # eval, DDD17 stage 1
    (2, 19200, 32): 600,  # train, DSEC stage 1 (lse)
    (2, 4800, 64): 150,  # train, DSEC stage 2 (lse)
    (4, 5655, 32): 356,  # train, DDD17 stage 1 (lse)
}


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


@pytest.mark.parametrize("shape", sorted(PATH_BLOCKS))
def test_launch_plan_at_the_path_shapes(shape):
    # each launch of the paths takes the tiled kernel, and gives more blocks
    # than the H100 has SMs
    plan = fa.f32_launch_plan(*shape)
    assert plan["kernel"] == "flash_fwd_f32_tiled" and plan["bm"] == 64
    assert plan["key_tile"] == {32: 64, 64: 32}[shape[2]]
    assert plan["blocks"] == PATH_BLOCKS[shape] >= H100_SMS


@pytest.mark.parametrize("d", [8, 16])
def test_launch_plan_keeps_the_first_design_at_d_8_and_16(d):
    assert fa.f32_launch_plan(2, 5655, d) == {"kernel": "flash_fwd_f32", "bm": 128, "key_tile": 64,
                                              "blocks": 2 * 45}


@pytest.mark.parametrize("n", [1, 64, 65, 5655])
def test_launch_plan_rounds_ragged_rows_up_to_a_block(n):
    assert fa.f32_launch_plan(3, n, 32)["blocks"] == 3 * -(-n // 64)


def test_launch_plan_constants_match_the_source():
    # the rows a block owns, the threads and the key tile of each head dim,
    # as the CUDA source has them (it is compiled only on the card)
    assert _constant("kTiledRows") == fa.F32_TILED_ROWS
    assert _constant("kRowsF32") == 128 and _constant("kTileF32") == fa.KERNEL_TILE
    rule = re.search(r"constexpr int tiled_keys\(\) \{\s*return ([^;]+);", SOURCE).group(1)
    assert rule == "D == 32 ? 64 : 32"
    assert {d: 64 if d == 32 else 32 for d in (32, 64)} == fa.F32_TILED_KEYS
    # 16 row groups of 8 lanes a block: 4 rows a thread, keys kg + 8 j
    assert _constant("kTiledThreads") // _constant("kKeyGroups") * 4 == fa.F32_TILED_ROWS


def test_source_dispatch_matches_the_plan_and_phase_1_instances():
    # the C entry point launches the first design at d 8 and 16 and the tiled
    # kernel at d 32 and 64: the instances phase 1 of chip_smoke.py requires,
    # once each
    entry = SOURCE[SOURCE.index('extern "C" int frn_flash_fwd_f32'):]
    first = {int(d) for d in re.findall(r"case (\d+): return launch_f32<\1>", entry)}
    tiled = {int(d) for d in re.findall(r"case (\d+): return launch_tiled<\1>", entry)}
    assert first == {8, 16} and tiled == set(fa.F32_TILED_KEYS) == {32, 64}
    assert {fa.f32_launch_plan(1, 1, d)["kernel"] for d in tiled} == {"flash_fwd_f32_tiled"}
    want = [("flash_fwd_f32", d) for d in sorted(first)]
    want += [("flash_fwd_f32_tiled", d) for d in sorted(tiled)]
    assert sorted(chip_smoke.PATH_INSTANCES["flash_attention_f32"]) == sorted(want)


@pytest.mark.parametrize("name,want", [
    ("_ZN12_GLOBAL__N_119flash_fwd_f32_tiledILi32EEEvPKfS2_S2_PfS3_i",
     ("flash_fwd_f32_tiled", 32)),
    ("_ZN12_GLOBAL__N_119flash_fwd_f32_tiledILi64EEEvPKfS2_S2_PfS3_i",
     ("flash_fwd_f32_tiled", 64)),
    ("_ZN12_GLOBAL__N_113flash_fwd_f32ILi16EEEvPKfS2_S2_PfS3_i", ("flash_fwd_f32", 16)),
])
def test_phase_1_reads_the_instances_from_the_compiler_log(name, want):
    log = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 96 registers, used 0 barriers\n")
    assert chip_smoke.kernel_instances(log) == {want: (96, 0, 0)}


def _mock_f32_kernel(monkeypatch):
    """The kernel route with the f32 library's entry point recorded, not run."""
    calls = []
    monkeypatch.setattr(fa, "_on_kernel_device", lambda q: True)
    monkeypatch.setattr(fa, "_f32_library", lambda: types.SimpleNamespace(frn_flash_fwd_f32="f32"))
    monkeypatch.setattr(fa, "_launch", lambda fn, q, *args: calls.append(
        (fn, args[4] is None, args[-3:])))
    return calls


COUNTERS = ("flash_fwd_f32_launches", "flash_fwd_lse_f32_launches", "flash_fwd_launches",
            "flash_fwd_lse_launches", "flash_bwd_dq_f32_launches", "flash_bwd_dkv_f32_launches",
            "flash_bwd_dq_launches", "flash_bwd_dkv_launches", "flash_fwd_bf16exp_launches")


@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_f32_forward_reaches_its_entry_point_at_every_head_dim(monkeypatch, d, return_lse):
    # one C entry point for every head dim (it picks the kernel by d inside):
    # one launch, one counter moved, the lse pointer null without lse
    calls = _mock_f32_kernel(monkeypatch)
    q = torch.zeros((2, 40, d))
    before = {name: getattr(fa, name) for name in COUNTERS}
    out = fa.flash_attention(q, q, q, return_lse=return_lse)
    assert calls == [("f32", not return_lse, (2, 40, d))]
    counter = "flash_fwd_lse_f32_launches" if return_lse else "flash_fwd_f32_launches"
    moved = {name: getattr(fa, name) - n for name, n in before.items() if getattr(fa, name) != n}
    assert moved == {counter: 1}
    o = out[0] if return_lse else out
    assert o.shape == q.shape and o.dtype == torch.float32


@pytest.mark.parametrize("b,n,d", [(2, 131, 32), (1, 517, 64), (2, 40, 32), (1, 200, 64)])
def test_plain_with_lse_matches_pallas_kernel_at_f32(b, n, d):
    # the plain version the card holds the kernel to, at ragged N and the
    # tiled kernel's head dims, against the Pallas kernel with lse at f32
    q, k, v = (RNG.normal(0, 1, (b, n, d)).astype(np.float32) for _ in range(3))
    want_o, want_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                                      block_k=128, interpret=True, return_lse=True)
    got_o, got_lse = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                              return_lse=True)
    assert got_o.dtype == got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse).reshape(b, n), atol=1e-4,
                               rtol=0)
