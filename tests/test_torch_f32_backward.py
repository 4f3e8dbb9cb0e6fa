"""The f32 backward kernels' register-blocked tiles (B2a and B2b at f32, d
32 and 64): their launch plans against the CUDA source's constants, the
dispatch and phase 1's instances, the routing on the kernel path, the A/B
tooling of ``chip_smoke.py``, and models of both thread-to-tile maps against
the JAX package's Pallas backward at f32.

The kernels themselves (``csrc/flash_attention_bwd_f32.cu``) run only on the
card; ``chip_smoke.py`` holds them against ``flash_bwd_dq_plain`` and
``flash_bwd_dkv_plain`` there. Bounds of the JAX comparison are the f32
backward tolerances of ``chip_smoke.py``: atol 1e-4 of each output's max
|value|, rtol 1e-3.
"""

import ctypes
import math
import re
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from frn_tpu.ops.flash_attention import _flash_backward, _flash_forward
from frn_tpu_torch import build
from frn_tpu_torch.ops import flash_attention as fa

RNG = np.random.default_rng(29)
SOURCE = (build.CSRC / "flash_attention_bwd_f32.cu").read_text()
H100_SMS = 132

# every launch of the f32 dK/dV kernel on the f32 train path: (B, N, d) ->
# its blocks (64 key rows each at d 32, 48 at d 64)
PATH_BLOCKS = {
    (2, 19200, 32): 600,  # DSEC stage 1
    (2, 4800, 64): 200,  # DSEC stage 2
    (4, 5655, 32): 356,  # DDD17 stage 1
}
# and of the f32 dQ kernel (64 query rows each at d 32, 48 at d 64)
DQ_PATH_BLOCKS = {
    (2, 19200, 32): 600,
    (2, 4800, 64): 200,
    (4, 5655, 32): 356,
}


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _rule(name: str) -> dict:
    """{head dim: value} of a ``constexpr int name<D>()`` of the source, for d
    32 and 64: its body is a constant or ``D == 32 ? a : b``."""
    body = re.search(rf"constexpr int {name}\(\) \{{\s*return ([^;]+);", SOURCE).group(1)
    m = re.fullmatch(r"D == 32 \? (\d+) : (\d+)", body)
    if m:
        return {32: int(m.group(1)), 64: int(m.group(2))}
    return {32: int(body), 64: int(body)}


def _tiles(d: int) -> dict:
    """The tiled kernel's shapes at head dim d, from the source's constants."""
    threads, groups = _constant("kTiledThreads"), _constant("kQueryGroups")
    bk, bq = _rule("tiled_key_rows")[d], _rule("tiled_queries")[d]
    r = threads // groups
    return {"threads": threads, "groups": groups, "bk": bk, "bq": bq, "r": r, "tm": bk // r,
            "tn": bq // groups, "cw": d // groups, "blocks_per_sm": _constant("kTiledBlocksPerSM")}


def _dq_tiles(d: int) -> dict:
    """The tiled dQ kernel's shapes at head dim d, from the source's constants:
    BQ query rows a block owns, BK keys a tile."""
    threads, groups = _constant("kTiledThreads"), _constant("kKeyGroups")
    bq, bk = _rule("dq_tiled_rows")[d], _rule("dq_tiled_keys")[d]
    r = threads // groups
    return {"threads": threads, "groups": groups, "bq": bq, "bk": bk, "r": r, "tm": bq // r,
            "tn": bk // groups, "cw": d // groups, "blocks_per_sm": _constant("kDqBlocksPerSM")}


def _thread_map(d: int, tiles=_tiles):
    """Per thread of a block: (its rows of the block, its rows of a tile, its
    accumulator columns of d), as the kernel assigns them: row group
    rg = t / G owns the block's rows rg + R i, lane group g = t % G the
    tile's rows g + G j and the float4 columns 4 (g + G u) .. + 3. The dK/dV
    kernel (``_tiles``) owns key rows and walks query tiles; the dQ kernel
    (``_dq_tiles``) owns query rows and walks key tiles."""
    s = tiles(d)
    g, r = s["groups"], s["r"]
    for t in range(s["threads"]):
        rg, lg = t // g, t % g
        yield ([rg + r * i for i in range(s["tm"])], [lg + g * j for j in range(s["tn"])],
               [4 * (lg + g * u) + e for u in range(s["cw"] // 4) for e in range(4)])


# ------------------------------------------------------------ launch plan


@pytest.mark.parametrize("shape", sorted(PATH_BLOCKS))
def test_launch_plan_at_the_path_shapes(shape):
    # each launch of the f32 train path takes the tiled kernel, and gives at
    # least as many blocks as the H100 has SMs
    plan = fa.f32_bwd_launch_plan(*shape, "dkv")
    d = shape[2]
    assert plan == {"kernel": "flash_bwd_dkv_f32_tiled", "rows": fa.F32_BWD_TILED_KEY_ROWS[d],
                    "tile": fa.F32_BWD_TILED_QUERIES[d], "blocks": PATH_BLOCKS[shape]}
    assert plan["blocks"] >= H100_SMS


@pytest.mark.parametrize("d", [8, 16])
def test_launch_plan_keeps_the_first_design_of_dq_at_every_head_dim(d):
    # B2a at d 8 and 16 takes its small kernel, the first design's successor
    # (the d 32 and 64 cases are
    # test_launch_plan_takes_the_tiled_dq_kernel_at_d_32_and_64): 64 query
    # rows a block at d 8, 32 at d 16 (test_torch_f32_dq_small.py holds them
    # against the source), 64-key tiles
    rows = {8: 64, 16: 32}[d]
    assert fa.f32_bwd_launch_plan(2, 4800, d, "dq") == {
        "kernel": "flash_bwd_dq_f32_small", "rows": rows, "tile": 64,
        "blocks": 2 * -(-4800 // rows)}


@pytest.mark.parametrize("d", [32, 64])
def test_launch_plan_takes_the_tiled_dq_kernel_at_d_32_and_64(d):
    rows = {32: 64, 64: 48}[d]
    assert fa.f32_bwd_launch_plan(2, 4800, d, "dq") == {
        "kernel": "flash_bwd_dq_f32_tiled", "rows": rows, "tile": {32: 64, 64: 32}[d],
        "blocks": 2 * -(-4800 // rows)}


@pytest.mark.parametrize("shape", sorted(DQ_PATH_BLOCKS))
def test_dq_launch_plan_at_the_path_shapes(shape):
    # each launch of the f32 train path takes the tiled dQ kernel, and gives
    # at least as many blocks as the H100 has SMs
    plan = fa.f32_bwd_launch_plan(*shape, "dq")
    d = shape[2]
    assert plan == {"kernel": "flash_bwd_dq_f32_tiled", "rows": fa.F32_BWD_DQ_TILED_ROWS[d],
                    "tile": fa.F32_BWD_DQ_TILED_KEYS[d], "blocks": DQ_PATH_BLOCKS[shape]}
    assert plan["blocks"] >= H100_SMS


@pytest.mark.parametrize("d", [8, 16])
def test_launch_plan_takes_the_small_dkv_kernel_at_d_8_and_16(d):
    # 64 key rows a block at d 8, 32 at d 16 (test_torch_f32_backward_small.py
    # holds them against the source), 64-query tiles
    rows = {8: 64, 16: 32}[d]
    assert fa.f32_bwd_launch_plan(2, 5655, d, "dkv") == {
        "kernel": "flash_bwd_dkv_f32_small", "rows": rows, "tile": 64,
        "blocks": 2 * -(-5655 // rows)}


@pytest.mark.parametrize("n", [1, 64, 65, 5655])
@pytest.mark.parametrize("d", [32, 64])
def test_launch_plan_rounds_ragged_rows_up_to_a_block(n, d):
    rows = fa.F32_BWD_TILED_KEY_ROWS[d]
    assert fa.f32_bwd_launch_plan(3, n, d, "dkv")["blocks"] == 3 * -(-n // rows)


@pytest.mark.parametrize("n", [1, 48, 49, 5655])
@pytest.mark.parametrize("d", [32, 64])
def test_dq_launch_plan_rounds_ragged_rows_up_to_a_block(n, d):
    rows = fa.F32_BWD_DQ_TILED_ROWS[d]
    assert fa.f32_bwd_launch_plan(3, n, d, "dq")["blocks"] == 3 * -(-n // rows)


def test_launch_plan_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        fa.f32_bwd_launch_plan(1, 64, 32, "dk")


def test_launch_plan_constants_match_the_source():
    # key rows a block owns and query rows per tile, by head dim, as the CUDA
    # source has them (it is compiled only on the card), and the d 8/16
    # kernels' tile and threads beside them
    assert {d: _tiles(d)["bk"] for d in (32, 64)} == fa.F32_BWD_TILED_KEY_ROWS
    assert {d: _tiles(d)["bq"] for d in (32, 64)} == fa.F32_BWD_TILED_QUERIES
    assert _constant("kTileBwd") == fa.KERNEL_TILE and _constant("kThreadsBwd") == 128


@pytest.mark.parametrize("d", [32, 64])
def test_tiles_fit_the_blocks_an_sm_in_shared_memory(d):
    # the source's DkvTiled layout: K and V staged once with 16-byte padded
    # rows, two ring slots of a Q and a dO tile with their lse and D, and
    # P^T's buffer with 32-byte padded rows; the blocks an SM fit in the
    # H100's 228 KB with 1 KB reserved a block, and the 64 K registers of an
    # SM leave each of their threads at least 128
    s = _tiles(d)
    floats = (2 * s["bk"] * (d + 4) + 2 * (2 * s["bq"] * (d + 4) + 2 * s["bq"])
              + s["bk"] * (s["bq"] + 8))
    assert s["blocks_per_sm"] * (4 * floats + 1024) <= 228 * 1024
    assert 65536 // (s["blocks_per_sm"] * s["threads"]) >= 128
    assert 2 * s["bq"] <= s["threads"]  # a thread copies each lse and each D


def test_dq_launch_plan_constants_match_the_source():
    # query rows a block owns and keys per tile, by head dim, as the CUDA
    # source has them
    assert {d: _dq_tiles(d)["bq"] for d in (32, 64)} == fa.F32_BWD_DQ_TILED_ROWS
    assert {d: _dq_tiles(d)["bk"] for d in (32, 64)} == fa.F32_BWD_DQ_TILED_KEYS


@pytest.mark.parametrize("d", [32, 64])
def test_dq_tiles_fit_the_blocks_an_sm_in_shared_memory(d):
    # the source's DqTiled layout: Q and dO staged once with 16-byte padded
    # rows, two ring slots of a K and a V tile padded the same way, and dS's
    # buffer with 32-byte padded rows (73.7 KB at d 32, 68.6 KB at d 64); the
    # blocks an SM fit in the H100's 228 KB with 1 KB reserved a block, and
    # the 64 K registers of an SM leave each of their threads at least 168
    s = _dq_tiles(d)
    floats = 2 * s["bq"] * (d + 4) + 2 * 2 * s["bk"] * (d + 4) + s["bq"] * (s["bk"] + 8)
    assert 4 * floats == {32: 73728, 64: 68608}[d]
    assert s["blocks_per_sm"] * (4 * floats + 1024) <= 228 * 1024
    assert 65536 // (s["blocks_per_sm"] * s["threads"]) >= 168
    # whole tiles a thread, and whole 16-byte chunks for the stager's threads
    assert s["tm"] * s["r"] == s["bq"] and s["tn"] * s["groups"] == s["bk"] and s["cw"] % 4 == 0
    assert (s["bq"] * d // 4) % s["threads"] == 0 and (s["bk"] * d // 4) % s["threads"] == 0


# ------------------------------------------------------------ dispatch and phase 1


def _entry(name: str) -> str:
    start = SOURCE.index(f'extern "C" int {name}')
    end = SOURCE.find('extern "C"', start + 1)
    return SOURCE[start:end if end > 0 else None]


def test_source_dispatch_matches_the_plan_and_phase_1_instances():
    # both entry points launch the tiled kernel at d 32 and 64 and their
    # small kernel at d 8 and 16: the instances phase 1 of chip_smoke.py
    # requires
    want = []
    for part, tiled_dims in (("dq", fa.F32_BWD_DQ_TILED_KEYS),
                             ("dkv", fa.F32_BWD_TILED_QUERIES)):
        entry = _entry(f"frn_flash_bwd_{part}_f32")
        first = {int(d) for d in re.findall(rf"case (\d+): return launch_{part}_small<\1>",
                                            entry)}
        tiled = {int(d) for d in re.findall(rf"case (\d+): return launch_{part}_tiled<\1>",
                                            entry)}
        assert first == {8, 16} and tiled == set(tiled_dims) == {32, 64}
        for d in first | tiled:
            kernel = f"flash_bwd_{part}_f32" + ("_tiled" if d in tiled else "_small")
            assert fa.f32_bwd_launch_plan(1, 1, d, part)["kernel"] == kernel
            want.append((kernel, d))
    assert sorted(chip_smoke.PATH_INSTANCES["flash_attention_bwd_f32"]) == sorted(want)


def test_the_tiled_kernel_bounds_its_launch_by_its_blocks_an_sm():
    # __launch_bounds__ caps the registers at the blocks an SM the source
    # names, so that those blocks fit an SM
    assert re.search(r"__launch_bounds__\(kTiledThreads, kTiledBlocksPerSM\)\s*"
                     r"flash_bwd_dkv_f32_tiled", SOURCE)


def test_the_tiled_dq_kernel_bounds_its_launch_by_its_blocks_an_sm():
    assert re.search(r"__launch_bounds__\(kTiledThreads, kDqBlocksPerSM\)\s*"
                     r"flash_bwd_dq_f32_tiled", SOURCE)


def _ptxas_log(instances: dict) -> str:
    mangled = {"flash_bwd_dq_f32_small":
                   "_ZN12_GLOBAL__N_122flash_bwd_dq_f32_smallILi{}EEEvPKfS2_S2_S2_S2_S2_Pfi",
               "flash_bwd_dq_f32_tiled":
                   "_ZN12_GLOBAL__N_122flash_bwd_dq_f32_tiledILi{}EEEvPKfS2_S2_S2_S2_S2_Pfi",
               "flash_bwd_dkv_f32_small":
                   "_ZN12_GLOBAL__N_123flash_bwd_dkv_f32_smallILi{}EEEvPKfS2_S2_S2_S2_S2_PfS3_i",
               "flash_bwd_dkv_f32_tiled":
                   "_ZN12_GLOBAL__N_123flash_bwd_dkv_f32_tiledILi{}EEEvPKfS2_S2_S2_S2_S2_PfS3_i"}
    return "".join(
        f"ptxas info    : Compiling entry function '{mangled[kernel].format(d)}' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for (kernel, d), (regs, spill) in instances.items())


@pytest.mark.parametrize("kernel,d", [("flash_bwd_dkv_f32_tiled", 32), ("flash_bwd_dkv_f32_tiled", 64),
                                      ("flash_bwd_dkv_f32_small", 16), ("flash_bwd_dq_f32_small", 8),
                                      ("flash_bwd_dq_f32_tiled", 32), ("flash_bwd_dq_f32_tiled", 64)])
def test_phase_1_reads_the_instances_from_the_compiler_log(kernel, d):
    log = _ptxas_log({(kernel, d): (168, 0)})
    assert chip_smoke.kernel_instances(log) == {(kernel, d): (168, 0, 0)}


def test_phase_1_takes_the_path_instances_and_refuses_a_spill_or_a_gap(capsys):
    every = {key: (160, 0) for key in chip_smoke.PATH_INSTANCES["flash_attention_bwd_f32"]}
    chip_smoke.check_path_instances("flash_attention_bwd_f32", _ptxas_log(every))
    out = capsys.readouterr().out
    assert "flash_bwd_dkv_f32_tiled<64>: 160 registers" in out
    assert "flash_bwd_dq_f32_tiled<32>: 160 registers" in out
    spilled = {**every, ("flash_bwd_dkv_f32_tiled", 32): (255, 8)}
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention_bwd_f32", _ptxas_log(spilled))
    missing = {k: v for k, v in every.items() if k != ("flash_bwd_dkv_f32_tiled", 64)}
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention_bwd_f32", _ptxas_log(missing))


# ------------------------------------------------------------ the kernel route


def _mock_bwd_f32(monkeypatch):
    """The kernel route with the f32 backward library's entry points recorded,
    not run."""
    calls = []
    monkeypatch.setattr(fa, "_on_kernel_device", lambda q: True)
    monkeypatch.setattr(fa, "_bwd_f32_library", lambda: types.SimpleNamespace(
        frn_flash_bwd_dq_f32="dq_f32", frn_flash_bwd_dkv_f32="dkv_f32"))
    monkeypatch.setattr(fa, "_launch", lambda fn, q, *args: calls.append((fn, args[-3:])))
    return calls


COUNTERS = ("flash_bwd_dq_f32_launches", "flash_bwd_dkv_f32_launches", "flash_bwd_dq_launches",
            "flash_bwd_dkv_launches", "flash_fwd_lse_f32_launches")


@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_dkv_reaches_its_f32_entry_point_at_every_head_dim(monkeypatch, d):
    # one C entry point for every head dim (it picks the kernel by d inside):
    # one launch, one counter moved
    calls = _mock_bwd_f32(monkeypatch)
    q, rows = torch.zeros((2, 131, d)), torch.zeros((2, 131))
    before = {name: getattr(fa, name) for name in COUNTERS}
    dk, dv = fa.flash_bwd_dkv(q, q, q, q, rows, rows)
    assert calls == [("dkv_f32", (2, 131, d))]
    moved = {name: getattr(fa, name) - n for name, n in before.items() if getattr(fa, name) != n}
    assert moved == {"flash_bwd_dkv_f32_launches": 1}
    assert dk.shape == dv.shape == q.shape and dk.dtype == dv.dtype == torch.float32


# ------------------------------------------------------------ the A/B tooling


class _FakePopen:
    """nvcc as build_others starts it, recorded, with a ptxas log."""

    def __init__(self, cmd, **kwargs):
        self.cmd, self.returncode = cmd, 0

    def communicate(self, timeout=None):
        every = {key: (160, 0) for key in chip_smoke.PATH_INSTANCES["flash_attention_bwd_f32"]}
        return _ptxas_log(every), None


def test_build_others_binds_an_f32_backward_source(monkeypatch, tmp_path, capsys):
    names = ("frn_flash_bwd_dq_f32", "frn_flash_bwd_dkv_f32")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "Popen", _FakePopen)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: types.SimpleNamespace(
        path=path, **{n: types.SimpleNamespace() for n in names}))
    src = "parent/csrc/flash_attention_bwd_f32.cu"
    lib = chip_smoke.build_others([src])[src]
    assert lib.path == str(tmp_path / "other0_flash_attention_bwd_f32.so")
    assert lib.frn_flash_bwd_dkv_f32.argtypes == [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    assert lib.frn_flash_bwd_dq_f32.argtypes == [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    assert "flash_bwd_dkv_f32_tiled<32>: 160 registers" in capsys.readouterr().out


@pytest.mark.parametrize("kind,dtype,want", [
    ("flash_bwd_dq_f32", torch.float32, "frn_flash_bwd_dq_f32"),
    ("flash_bwd_dkv_f32", torch.float32, "frn_flash_bwd_dkv_f32"),
    ("flash_bwd_dq", torch.bfloat16, "frn_flash_bwd_dq_bf16"),
    ("flash_bwd_dkv", torch.bfloat16, "frn_flash_bwd_dkv_bf16"),
])
def test_other_backward_calls_the_entry_point_of_its_dtype(monkeypatch, kind, dtype, want):
    calls = []
    monkeypatch.setattr(fa, "_launch", lambda fn, q, *args: calls.append((fn, args[-3:])))
    lib = types.SimpleNamespace(**{n: n for n in (
        "frn_flash_bwd_dq_f32", "frn_flash_bwd_dkv_f32", "frn_flash_bwd_dq_bf16",
        "frn_flash_bwd_dkv_bf16")})
    q, rows = torch.zeros((2, 40, 32), dtype=dtype), torch.zeros((2, 40))
    out = chip_smoke.other_backward(lib, kind, q, q, q, q, rows, rows)
    assert calls == [(want, (2, 40, 32))]
    assert len(out) == 2 if "dkv" in kind else out.shape == q.shape


def _as_tensor(ptr: int, shape) -> torch.Tensor:
    return torch.from_numpy(np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), shape=shape))


def _plain_revision():
    """Another revision's f32 backward entry points, standing in on the CPU:
    the plain versions, written through the pointers the entry points get."""

    def dq(*args):
        *ins, out, b, n, d = args
        t = [_as_tensor(p, (b, n, d)) for p in ins[:4]] + [_as_tensor(p, (b, n)) for p in ins[4:]]
        _as_tensor(out, (b, n, d)).copy_(fa.flash_bwd_dq_plain(*t))

    def dkv(*args):
        *ins, dk, dv, b, n, d = args
        t = [_as_tensor(p, (b, n, d)) for p in ins[:4]] + [_as_tensor(p, (b, n)) for p in ins[4:]]
        got = fa.flash_bwd_dkv_plain(*t)
        _as_tensor(dk, (b, n, d)).copy_(got[0])
        _as_tensor(dv, (b, n, d)).copy_(got[1])

    return types.SimpleNamespace(frn_flash_bwd_dq_f32=dq, frn_flash_bwd_dkv_f32=dkv)


def test_phase_other_f32_backward_runs_every_launch_in_turns(monkeypatch, capsys):
    # the phase on the CPU at tiny shapes: this revision's wrappers (their
    # plain versions here) and another revision's entry points, held against
    # the plain versions at the ragged check shapes, then timed in turns at
    # each launch of the f32 train paths, depth 50's and depth 18's (rows
    # " R18"), with this revision's block counts, and summed per micro-step
    _gen, _randn = torch.Generator, torch.randn
    monkeypatch.setattr(torch, "Generator", lambda device=None: _gen())
    monkeypatch.setattr(torch, "randn", lambda *a, device=None, **k: _randn(*a, **k))
    monkeypatch.setattr(fa, "_launch", lambda fn, q, *args: fn(*args))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps, warmup=2, windows=1: (1.0, fn()))
    monkeypatch.setattr(chip_smoke, "FLASH_SHAPES", ((131, 32), (70, 64)))
    monkeypatch.setattr(chip_smoke, "DDD17_FLASH_SHAPE", (77, 32))
    monkeypatch.setattr(chip_smoke, "DEPTH18_FLASH_SHAPES", ((131, 8), (70, 16)))
    monkeypatch.setattr(chip_smoke, "DEPTH18_DDD17_SHAPE", (77, 8))
    monkeypatch.setattr(chip_smoke, "F32_BWD_AB_CHECKS", ((2, 77, 8), (1, 37, 16)))
    checked = []
    check_close = chip_smoke.check_close
    monkeypatch.setattr(chip_smoke, "check_close", lambda label, name, got, want, atol, rtol, shape,
                        errs: checked.append((label, name, tuple(shape)))
                        or check_close(label, name, got, want, atol, rtol, shape, errs))
    chip_smoke.phase_other_f32_backward({"parent/flash_attention_bwd_f32.cu": _plain_revision()})
    out = capsys.readouterr().out
    rows = [json_row for json_row in out.splitlines() if json_row.startswith("revisions timing")]
    kinds = [re.search(r'"kind": "([^"]+)"', r).group(1) for r in rows]
    assert kinds == ["flash_bwd_dq_f32", "flash_bwd_dkv_f32"] * 2 + [
        "flash_bwd_dq_f32 DDD17", "flash_bwd_dkv_f32 DDD17"] + [
        "flash_bwd_dq_f32 R18", "flash_bwd_dkv_f32 R18"] * 2 + [
        "flash_bwd_dq_f32 R18 DDD17", "flash_bwd_dkv_f32 R18 DDD17"]
    assert '"N": 70, "d": 64, "blocks": 4' in rows[3]  # 2 x 70 key rows in 48-row blocks
    assert '"B": 2, "N": 70, "d": 16, "blocks": 6' in rows[9]  # 2 x 70 key rows in 32-row blocks
    assert '"B": 4, "N": 77, "d": 8, "blocks": 8' in rows[11]  # 4 x 77 key rows in 64-row blocks
    assert "flash_bwd_dkv_f32 parent/flash_attention_bwd_f32.cu: 4.000 ms per micro-step " \
           "(4 launches)" in out
    assert "flash_bwd_dkv_f32 DDD17 this revision: 2.000 ms per micro-step (2 launches)" in out
    assert "flash_bwd_dkv_f32 R18 this revision: 4.000 ms per micro-step (4 launches)" in out
    assert "flash_bwd_dkv_f32 R18 DDD17 parent/flash_attention_bwd_f32.cu: 2.000 ms per " \
           "micro-step (2 launches)" in out
    # both revisions' dQ, dK and dV at both ragged check shapes, before any timing
    for shape in ((2, 77, 8), (1, 37, 16)):
        for label in ("this revision", "parent/flash_attention_bwd_f32.cu"):
            got = {name for lab, name, s in checked[:12] if s == shape and lab.endswith(label)}
            assert got == {"dq", "dk", "dv"}
    assert " 0 outside " in out and " outside " not in out.replace(" 0 outside ", "")


# ------------------------------------------------------------ the thread-to-tile map


@pytest.mark.parametrize("d", [32, 64])
def test_thread_map_covers_each_cell_of_a_tile_and_the_accumulators_once(d):
    s = _tiles(d)
    scores = np.zeros((s["bk"], s["bq"]), dtype=int)
    acc = np.zeros((s["bk"], d), dtype=int)
    for rows, cols, acc_cols in _thread_map(d):
        scores[np.ix_(rows, cols)] += 1
        acc[np.ix_(rows, acc_cols)] += 1
    assert (scores == 1).all() and (acc == 1).all()



@pytest.mark.parametrize("d", [32, 64])
def test_each_row_of_pt_is_written_and_read_in_one_warp(d):
    # the kernel orders P^T and dS^T by warp barriers alone: the lanes that
    # write a row of the shared buffer (score rows) and those that read it
    # (accumulator rows) are the same 8 lanes, in one warp of 32
    writers, readers = {}, {}
    for t, (rows, cols, acc_cols) in enumerate(_thread_map(d)):
        for r in rows:
            writers.setdefault(r, set()).update(t for _ in cols)
            readers.setdefault(r, set()).update(t for _ in acc_cols)
    assert writers == readers
    assert all(len({t // 32 for t in lanes}) == 1 and len(lanes) == _tiles(d)["groups"]
               for lanes in writers.values())


@pytest.mark.parametrize("d", [32, 64])
def test_dq_thread_map_covers_each_cell_of_a_tile_and_the_accumulator_once(d):
    # each cell of S and dP (one map for both products) and of dQ is owned by
    # one thread
    s = _dq_tiles(d)
    scores = np.zeros((s["bq"], s["bk"]), dtype=int)
    acc = np.zeros((s["bq"], d), dtype=int)
    for rows, cols, acc_cols in _thread_map(d, _dq_tiles):
        scores[np.ix_(rows, cols)] += 1
        acc[np.ix_(rows, acc_cols)] += 1
    assert (scores == 1).all() and (acc == 1).all()


@pytest.mark.parametrize("d", [32, 64])
def test_each_row_of_ds_is_written_and_read_in_one_warp(d):
    # the dQ kernel orders dS by a warp barrier alone: the lanes that write a
    # row of the shared buffer and those that read it are the same 8 lanes
    writers, readers = {}, {}
    for t, (rows, cols, acc_cols) in enumerate(_thread_map(d, _dq_tiles)):
        for r in rows:
            writers.setdefault(r, set()).add(t)
            readers.setdefault(r, set()).add(t)
    assert writers == readers
    assert all(len({t // 32 for t in lanes}) == 1 and len(lanes) == _dq_tiles(d)["groups"]
               for lanes in writers.values())

def _model_dkv(q, k, v, do, lse, delta):
    """dK and dV by the tiled kernel's decomposition, in f32 numpy: blocks of
    BK key rows, tiles of BQ query rows zero-filled past n, each thread's
    part of S^T and dP^T from its rows and columns, P = 2^(s log2 e - lse
    log2 e) set to 0 past n by a select, dS^T = P^T (dP^T - D), both through
    one shared buffer into the accumulators by the thread's columns; key rows
    past n stored nowhere (NaN left in an output shows a value stored
    nowhere). Returns (dK, dV, the count of stores of each output value)."""
    b, n, d = q.shape
    s = _tiles(d)
    bk, bq = s["bk"], s["bq"]
    log2e = np.float32(1.4426950408889634)
    dk, dv = np.full_like(k, np.nan), np.full_like(v, np.nan)
    stores = np.zeros((b, n, d), dtype=int)
    thread_map = list(_thread_map(d))

    def rows_of(x, r0, count):
        out = np.zeros((count,) + x.shape[1:], dtype=np.float32)
        got = x[r0:r0 + count]
        out[:len(got)] = got
        return out

    for bi in range(b):
        for key0 in range(0, n, bk):
            ks, vs = rows_of(k[bi], key0, bk), rows_of(v[bi], key0, bk)
            dka, dva = np.zeros((bk, d), np.float32), np.zeros((bk, d), np.float32)
            for q0 in range(0, n, bq):
                qt, dot = rows_of(q[bi], q0, bq), rows_of(do[bi], q0, bq)
                lt, dt = rows_of(lse[bi], q0, bq), rows_of(delta[bi], q0, bq)
                pt, dst = np.full((bk, bq), np.nan, np.float32), np.full((bk, bq), np.nan,
                                                                           np.float32)
                for rows, cols, _ in thread_map:
                    st = ks[rows] @ qt[cols].T
                    dpt = vs[rows] @ dot[cols].T
                    with np.errstate(over="ignore"):
                        e = np.exp2(st * log2e - lt[cols] * log2e)
                    p = np.where(q0 + np.asarray(cols) >= n, np.float32(0), e)
                    pt[np.ix_(rows, cols)] = p
                    dst[np.ix_(rows, cols)] = p * (dpt - dt[cols])
                for rows, _, acc_cols in thread_map:
                    dva[np.ix_(rows, acc_cols)] += pt[rows] @ dot[:, acc_cols]
                    dka[np.ix_(rows, acc_cols)] += dst[rows] @ qt[:, acc_cols]
            for rows, _, acc_cols in thread_map:
                for r in rows:
                    if key0 + r < n:
                        dk[bi, key0 + r, acc_cols] = dka[r, acc_cols]
                        dv[bi, key0 + r, acc_cols] = dva[r, acc_cols]
                        stores[bi, key0 + r, acc_cols] += 1
    return dk, dv, stores


def _model_dq(q, k, v, do, lse, delta):
    """dQ by the tiled dQ kernel's decomposition, in f32 numpy: blocks of BQ
    query rows (lse and D zeros past n, never read there), tiles of BK keys
    zero-filled past n, each thread's part of S and dP from its rows and key
    columns, dS = P (dP - D) with P = 2^(s log2 e - lse log2 e), set to 0 for
    a key past n by a select, through the shared buffer into dQ by the
    thread's columns; query rows past n stored nowhere (NaN left in the
    output shows a value stored nowhere). Returns (dQ, the count of stores
    of each output value)."""
    b, n, d = q.shape
    s = _dq_tiles(d)
    bq, bk = s["bq"], s["bk"]
    log2e = np.float32(1.4426950408889634)
    dq = np.full_like(q, np.nan)
    stores = np.zeros((b, n, d), dtype=int)
    thread_map = list(_thread_map(d, _dq_tiles))

    def rows_of(x, r0, count):
        out = np.zeros((count,) + x.shape[1:], dtype=np.float32)
        got = x[r0:r0 + count]
        out[:len(got)] = got
        return out

    for bi in range(b):
        for row0 in range(0, n, bq):
            qs, dos = rows_of(q[bi], row0, bq), rows_of(do[bi], row0, bq)
            nlb = -rows_of(lse[bi], row0, bq) * log2e
            dl = rows_of(delta[bi], row0, bq)
            acc = np.zeros((bq, d), np.float32)
            for key0 in range(0, n, bk):
                kt, vt = rows_of(k[bi], key0, bk), rows_of(v[bi], key0, bk)
                ds = np.full((bq, bk), np.nan, np.float32)
                for rows, cols, _ in thread_map:
                    st = qs[rows] @ kt[cols].T
                    dpt = dos[rows] @ vt[cols].T
                    with np.errstate(over="ignore", invalid="ignore"):
                        x = np.exp2(st * log2e + nlb[rows, None]) * (dpt - dl[rows, None])
                    ds[np.ix_(rows, cols)] = np.where(key0 + np.asarray(cols) >= n,
                                                      np.float32(0), x)
                for rows, _, acc_cols in thread_map:
                    acc[np.ix_(rows, acc_cols)] += ds[rows] @ kt[:, acc_cols]
            for rows, _, acc_cols in thread_map:
                for r in rows:
                    if row0 + r < n:
                        dq[bi, row0 + r, acc_cols] = acc[r, acc_cols]
                        stores[bi, row0 + r, acc_cols] += 1
    return dq, stores


def _jax_backward(q, k, v, do, block: int = 128):
    """(O, lse, dQ, dK, dV) of the JAX package's Pallas kernels at f32, in
    interpret mode, with blocks of ``block`` rows (N padded to a whole
    block)."""
    o, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block,
                            block_k=block, interpret=True, return_lse=True)
    dq, dk, dv = _flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                                 jnp.asarray(do), block_q=block, block_k=block, interpret=True)
    return tuple(np.asarray(x) for x in (o, lse, dq, dk, dv))


def _inputs(b, n, d, shift):
    """Seeded q, k, v, dO; with ``shift``, scores near -121, so that every
    lse is below -88."""
    q, k, v, do = (RNG.normal(0, 0.5 if shift else 1.0, (b, n, d)).astype(np.float32)
                   for _ in range(4))
    if shift:
        q[..., 0], k[..., 0] = 11.0, -11.0  # s = -121 + O(1)
    return q, k, v, do


@pytest.mark.parametrize("b,n,d,shift", [
    (2, 131, 32, False),  # a ragged third block and a ragged last 64-query tile
    (1, 97, 64, False),  # a ragged third block and a ragged fourth 32-query tile
    (1, 40, 64, False),  # one partial block and tile
    (2, 131, 32, True),  # lse < -88: a zero-filled lse past N gives inf
    (1, 97, 64, True),
])
def test_thread_map_model_matches_the_pallas_backward_at_f32(b, n, d, shift):
    # the tiled kernel's decomposition, ragged tail and select included,
    # against the JAX package's Pallas backward at f32 (interpret mode), and
    # the port's plain version against the same
    q, k, v, do = _inputs(b, n, d, shift)
    o, lse, _, want_dk, want_dv = _jax_backward(q, k, v, do)
    lse = lse.reshape(b, n)
    if shift:
        assert lse.max() < -88
    delta = (do * o).sum(axis=2, dtype=np.float32)
    dk, dv, stores = _model_dkv(q, k, v, do, lse, delta)
    assert (stores == 1).all()
    plain = fa.flash_bwd_dkv_plain(*(torch.tensor(x) for x in (q, k, v, do, lse, delta)))
    atol = chip_smoke.F32_TRAP_ATOL if shift else chip_smoke.BWD_F32_ATOL
    for got, want in ((dk, want_dk), (dv, want_dv), (plain[0].numpy(), want_dk),
                      (plain[1].numpy(), want_dv)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=atol * np.abs(want).max(),
                                   rtol=chip_smoke.BWD_F32_RTOL)


@pytest.mark.parametrize("b,n,d,shift", [
    (2, 131, 32, False),  # a ragged third block and a ragged third 64-key tile
    (1, 97, 64, False),  # a ragged third 48-row block and a ragged fourth 32-key tile
    (1, 40, 64, False),  # one partial block and tile
    (2, 131, 32, True),  # lse < -88: a zero-filled key past N gives P = inf
    (1, 97, 64, True),
])
def test_dq_thread_map_model_matches_the_pallas_backward_at_f32(b, n, d, shift):
    # the tiled dQ kernel's decomposition, ragged tail and select included,
    # against the JAX package's Pallas backward at f32 (interpret mode), and
    # the port's plain version against the same. Where lse < -88 the Pallas
    # dQ runs in one block of N rows: padded to a whole block it is NaN there
    # (test_pallas_dq_is_nan_where_lse_is_below_minus_88_at_a_padded_n)
    q, k, v, do = _inputs(b, n, d, shift)
    o, lse, want, _, _ = _jax_backward(q, k, v, do, block=n if shift else 128)
    lse = lse.reshape(b, n)
    if shift:
        assert lse.max() < -88
    delta = (do * o).sum(axis=2, dtype=np.float32)
    dq, stores = _model_dq(q, k, v, do, lse, delta)
    assert (stores == 1).all()
    plain = fa.flash_bwd_dq_plain(*(torch.tensor(x) for x in (q, k, v, do, lse, delta)))
    atol = chip_smoke.F32_TRAP_ATOL if shift else chip_smoke.BWD_F32_ATOL
    for got in (dq, plain.numpy()):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=atol * np.abs(want).max(),
                                   rtol=chip_smoke.BWD_F32_RTOL)


def test_pallas_dq_is_nan_where_lse_is_below_minus_88_at_a_padded_n():
    # a divergence of the JAX package, not of the port: its dQ kernel's
    # padded key rows give P = exp(-lse) = inf, and inf times their zero K
    # row is NaN; the port's tiles select dS = 0 there
    q, k, v, do = _inputs(1, 131, 32, True)
    _, lse, dq, _, _ = _jax_backward(q, k, v, do)
    assert lse.max() < -88 and np.isnan(dq).all()


def test_model_needs_the_select_where_lse_is_below_minus_88():
    # the witness: past N the zero-filled lse leaves 2^(s log2 e) = inf, so
    # a multiply by a 0/1 mask would give inf * 0 = NaN
    with np.errstate(over="ignore", invalid="ignore"):
        e = np.exp2(np.float32(121.0) * np.float32(1.4426950408889634))
        assert math.isinf(e) and math.isnan(e * np.float32(0))
