"""The bf16 backward kernels at head dims 8 and 16 (B2a, ``flash_bwd_dq_ring``,
and B2b, ``flash_bwd_dkv_ring``, in ``csrc/flash_attention_bwd.cu``): their
blocks against the CUDA source's constants, the dispatch and phase 1's
instances, phase 2's check where lse < -88, the A/B tooling of
``chip_smoke.py`` at the depth-18 launches, and numpy models of the kernels'
loops at the level of their mma.sync fragments against the JAX package's
Pallas backward.

The kernels run only on the card, where ``chip_smoke.py`` holds them against
``flash_bwd_dq_plain`` and ``flash_bwd_dkv_plain``. The models follow the
source: the ring of 64-row tiles of the other side (which slot each tile
lands in and when), the dK/dV kernel's statistics' slots as ``put_stat``
writes them and the dQ kernel's statistics in registers, the 16-row tiles of
each warp, the lanes' fragments of the scores and dP (C), of the rows'
operands, P and dS (A), and the ldmatrix and ldmatrix.trans B fragments read
from the swizzled row-major tiles. Bounds of the JAX comparison: with bf16
inputs phase 2's gate (BWD_ATOL of each output's max |value|, BWD_RTOL);
with f32 inputs and the bf16 rounding of P and dS off, the JAX tests' atol
2e-4, rtol 1e-3.
"""

import ctypes
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

RNG = np.random.default_rng(41)
SOURCE = (build.CSRC / "flash_attention_bwd.cu").read_text()
COMMON = (build.CSRC / "flash_common.cuh").read_text()
SM90 = (build.CSRC / "flash_sm90.cuh").read_text()
LOG2E = np.float32(1.4426950408889634)
H100_SMS = 132


def _constant(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _rule(name: str) -> dict:
    """{head dim: value} of the source's ``constexpr int name()`` for d 8 and
    16: its body is a constant or ``D == 8 ? a : b``."""
    body = re.search(rf"constexpr int {name}\(\) \{{ return ([^;]+); \}}", SOURCE).group(1)
    m = re.fullmatch(r"D == 8 \? (\d+) : (\d+)", body)
    return {8: int(m.group(1)), 16: int(m.group(2))} if m else {8: int(body), 16: int(body)}


TILE = _constant(COMMON, "kTile")
STAGES, AHEAD = _constant(SM90, "kStages"), _constant(SM90, "kAhead")


def _block(d: int) -> dict:
    """The dK/dV kernel's block at head dim d, from the source."""
    warps, tiles = _rule("dkv_warps")[d], _rule("dkv_key_tiles")[d]
    return {"warps": warps, "key_tiles": tiles, "rows": warps * 16 * tiles,
            "blocks_per_sm": _rule("dkv_blocks_per_sm")[d]}


def _dq_block(d: int) -> dict:
    """The dQ kernel's block at head dim d, from the source."""
    warps, tiles = _rule("dq_warps")[d], _rule("dq_row_tiles")[d]
    return {"warps": warps, "row_tiles": tiles, "rows": warps * 16 * tiles,
            "blocks_per_sm": _rule("dq_blocks_per_sm")[d]}


# ------------------------------------------------------------ the block and the dispatch


def test_launch_plan_constants_match_the_source():
    # rows a block owns (phase 15's blocks), the query tile, the ring and the
    # blocks an SM, as the CUDA source has them (it is compiled only on the
    # card)
    for d in (8, 16):
        assert _block(d)["rows"] == chip_smoke.MMA_ROWS["flash_bwd_dkv"]
    assert TILE == fa.KERNEL_TILE == 64 and (STAGES, AHEAD) == (4, 2)
    assert re.search(r"constexpr int dkv_rows\(\) \{ return dkv_warps<D>\(\) \* 16 \* "
                     r"dkv_key_tiles<D>\(\); \}", SOURCE)


@pytest.mark.parametrize("d", [8, 16])
def test_blocks_fit_an_sm(d):
    # the ring (kStages slots of a Q and a dO tile, 1 KB for its alignment)
    # and two statistics slots of 48 float4, 1 KB reserved a block, in the
    # H100's 228 KB; 64 K registers leave each thread at least 64; a thread
    # for each statistic of a tile
    s = _block(d)
    smem = STAGES * 2 * TILE * d * 2 + 1024 + 2 * 48 * 16
    assert s["blocks_per_sm"] * (smem + 1024) <= 228 * 1024
    assert 65536 // (s["blocks_per_sm"] * s["warps"] * 32) >= 64
    assert s["warps"] * 32 >= 2 * TILE


def test_the_kernel_bounds_its_launch_by_its_blocks_an_sm():
    assert re.search(r"__launch_bounds__\(dkv_warps<D>\(\) \* 32, dkv_blocks_per_sm<D>\(\)\)\s*"
                     r"flash_bwd_dkv_ring", SOURCE)


def _entry(name: str) -> str:
    start = SOURCE.index(f'extern "C" int {name}')
    end = SOURCE.find('extern "C"', start + 1)
    return SOURCE[start:end if end > 0 else None]


def test_dispatch_takes_the_ring_kernel_at_d_8_and_16_and_phase_1_wants_it():
    entry = _entry("frn_flash_bwd_dkv_bf16")
    assert {int(d) for d in re.findall(r"case (\d+): return launch_dkv_ring<\1>", entry)} == {8, 16}
    assert {int(d) for d in re.findall(r"case (\d+): return launch_dkv_wgmma<\1>", entry)} == {
        32, 64}
    assert "flash_bwd_dkv_mma" not in SOURCE  # the first design is gone
    want = [("flash_bwd_dkv_ring", 8), ("flash_bwd_dkv_ring", 16)]
    assert set(want) <= set(chip_smoke.PATH_INSTANCES["flash_attention_bwd"])


def _ptxas_log(instances: dict) -> str:
    mangled = {
        "flash_bwd_dq_ring": "_ZN12_GLOBAL__N_117flash_bwd_dq_ringILi{}EEEvPK13__nv_bfloat16S3_S3_"
                             "S3_PKfS5_PS1_i",
        "flash_bwd_dkv_ring": "_ZN12_GLOBAL__N_118flash_bwd_dkv_ringILi{}EEEvPK13__nv_bfloat16S3_S3_"
                              "S3_PKfS5_PS1_S6_i",
        "flash_bwd_dq_wgmma": "_ZN12_GLOBAL__N_118flash_bwd_dq_wgmmaILi{}EEEv14CUtensorMap_stS1_PK13__"
                              "nv_bfloat16S4_PKfS6_PS2_i",
        "flash_bwd_dkv_wgmma": "_ZN12_GLOBAL__N_119flash_bwd_dkv_wgmmaILi{}EEEv14CUtensorMap_stS1_"
                               "PKfS3_PK13__nv_bfloat16S6_PS4_S7_i"}
    return "".join(
        f"ptxas info    : Compiling entry function '{mangled[kernel].format(d)}' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for (kernel, d), (regs, spill) in instances.items())


@pytest.mark.parametrize("d", [8, 16])
def test_phase_1_reads_the_ring_instance_from_the_compiler_log(d):
    log = _ptxas_log({("flash_bwd_dkv_ring", d): (96, 0)})
    assert chip_smoke.kernel_instances(log) == {("flash_bwd_dkv_ring", d): (96, 0, 0)}


def test_phase_1_takes_the_ring_instances_and_refuses_a_spill_or_a_gap(capsys):
    every = {key: (120, 0) for key in chip_smoke.PATH_INSTANCES["flash_attention_bwd"]}
    chip_smoke.check_path_instances("flash_attention_bwd", _ptxas_log(every))
    assert "flash_bwd_dkv_ring<16>: 120 registers" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances(
            "flash_attention_bwd", _ptxas_log({**every, ("flash_bwd_dkv_ring", 8): (128, 16)}))
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention_bwd", _ptxas_log(
            {k: v for k, v in every.items() if k != ("flash_bwd_dkv_ring", 16)}))


@pytest.mark.parametrize("shape,blocks", [((8, 19200, 8), 1200), ((8, 4800, 16), 304),
                                          ((2, 5655, 8), 90)])
def test_phase_15_counts_the_ring_kernels_blocks(shape, blocks):
    # the depth-18 micro-step's launches and the ragged check shape, in
    # blocks of the source's rows
    rows = _block(shape[2])["rows"]
    assert chip_smoke.depth18_blocks("flash_bwd_dkv", *shape) == blocks == shape[0] * -(
        -shape[1] // rows)
    assert blocks >= H100_SMS or shape[0] == 2


# ------------------------------------------------------------ the dQ kernel's block and dispatch


def test_dq_launch_plan_constants_match_the_source():
    # rows a block owns (phase 15's blocks) as the CUDA source has them (it
    # is compiled only on the card); each block constant is a function of
    # the head dim that device code and the host's launch both read
    for d in (8, 16):
        assert _dq_block(d)["rows"] == chip_smoke.MMA_ROWS["flash_bwd_dq"]
    assert re.search(r"constexpr int dq_rows\(\) \{ return dq_warps<D>\(\) \* 16 \* "
                     r"dq_row_tiles<D>\(\); \}", SOURCE)
    for name in ("dq_warps", "dq_row_tiles", "dq_blocks_per_sm", "dq_rows"):
        assert re.search(rf"template <int D>\n__host__ __device__ constexpr int {name}\(\)", SOURCE)


@pytest.mark.parametrize("d", [8, 16])
def test_dq_blocks_fit_an_sm(d):
    # the ring (kStages slots of a K and a V tile, 1 KB for its alignment),
    # 1 KB reserved a block, in the H100's 228 KB; 64 K registers leave each
    # thread at least 64
    s = _dq_block(d)
    smem = STAGES * 2 * TILE * d * 2 + 1024
    assert s["blocks_per_sm"] * (smem + 1024) <= 228 * 1024
    assert 65536 // (s["blocks_per_sm"] * s["warps"] * 32) >= 64


def test_the_dq_kernel_bounds_its_launch_by_its_blocks_an_sm():
    assert re.search(r"__launch_bounds__\(dq_warps<D>\(\) \* 32, dq_blocks_per_sm<D>\(\)\)\s*"
                     r"flash_bwd_dq_ring", SOURCE)
    launch = SOURCE[SOURCE.index("int launch_dq_ring"):SOURCE.index("int launch_dkv_ring")]
    assert "allow_smem(flash_bwd_dq_ring<D>, ring_bytes<D>()" in launch
    assert "dq_warps<D>() * 32, ring_bytes<D>()" in launch


def test_dispatch_takes_the_ring_dq_kernel_at_d_8_and_16_and_phase_1_wants_it():
    entry = _entry("frn_flash_bwd_dq_bf16")
    assert {int(d) for d in re.findall(r"case (\d+): return launch_dq_ring<\1>", entry)} == {8, 16}
    assert {int(d) for d in re.findall(r"case (\d+): return launch_dq_wgmma<\1>", entry)} == {
        32, 64}
    assert "flash_bwd_dq_mma" not in SOURCE and "launch_dq_mma" not in SOURCE  # the first design
    for name in ("stage_tiles", "stage_chunk", "b_from_rows", "b_from_cols", "to_a_frag", "kRows",
                 "kWarps", "kPad"):  # what only the first design used
        assert name not in COMMON and name not in SOURCE
    want = [("flash_bwd_dq_ring", 8), ("flash_bwd_dq_ring", 16)]
    assert set(want) <= set(chip_smoke.PATH_INSTANCES["flash_attention_bwd"])


@pytest.mark.parametrize("d", [8, 16])
def test_phase_1_reads_the_ring_dq_instance_and_refuses_its_spill_or_gap(d):
    log = _ptxas_log({("flash_bwd_dq_ring", d): (104, 0)})
    assert chip_smoke.kernel_instances(log) == {("flash_bwd_dq_ring", d): (104, 0, 0)}
    every = {key: (120, 0) for key in chip_smoke.PATH_INSTANCES["flash_attention_bwd"]}
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances(
            "flash_attention_bwd", _ptxas_log({**every, ("flash_bwd_dq_ring", d): (128, 8)}))
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention_bwd", _ptxas_log(
            {k: v for k, v in every.items() if k != ("flash_bwd_dq_ring", d)}))


@pytest.mark.parametrize("shape,blocks", [((8, 19200, 8), 2400), ((8, 4800, 16), 600),
                                          ((2, 5655, 8), 178)])
def test_phase_15_counts_the_ring_dq_kernels_blocks(shape, blocks):
    # the depth-18 micro-step's launches and the ragged check shape, in
    # blocks of the source's rows
    rows = _dq_block(shape[2])["rows"]
    assert chip_smoke.depth18_blocks("flash_bwd_dq", *shape) == blocks == shape[0] * -(
        -shape[1] // rows)


# ------------------------------------------------------------ the A/B tooling


def _as_tensor(ptr: int, shape, dtype) -> torch.Tensor:
    ctype = ctypes.c_float if dtype == torch.float32 else ctypes.c_int16
    x = torch.from_numpy(np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=shape))
    return x if dtype == torch.float32 else x.view(dtype)


def _plain_revision():
    """Another revision's bf16 backward entry points, standing in on the CPU:
    the plain versions, written through the pointers the entry points get."""

    def inputs(ins, b, n, d):
        return ([_as_tensor(p, (b, n, d), torch.bfloat16) for p in ins[:4]]
                + [_as_tensor(p, (b, n), torch.float32) for p in ins[4:]])

    def dq(*args):
        *ins, out, b, n, d = args
        _as_tensor(out, (b, n, d), torch.bfloat16).copy_(fa.flash_bwd_dq_plain(*inputs(ins, b, n, d)))

    def dkv(*args):
        *ins, dk, dv, b, n, d = args
        got = fa.flash_bwd_dkv_plain(*inputs(ins, b, n, d))
        _as_tensor(dk, (b, n, d), torch.bfloat16).copy_(got[0])
        _as_tensor(dv, (b, n, d), torch.bfloat16).copy_(got[1])

    return types.SimpleNamespace(frn_flash_bwd_dq_bf16=dq, frn_flash_bwd_dkv_bf16=dkv)


def test_phase_other_backwards_runs_the_depth_18_launches_in_turns(monkeypatch, capsys):
    # the phase on the CPU at tiny shapes: this revision's wrappers (their
    # plain versions here) and another revision's entry points, first held
    # against the plain versions at the ragged check shape, then timed in
    # turns at depth 50's and depth 18's launches, the d 8/16 rows with
    # this revision's blocks, and summed per micro-step
    _cpu_phase(monkeypatch)
    monkeypatch.setattr(fa, "_launch", lambda fn, q, *args: fn(*args))
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "FLASH_SHAPES", ((131, 32), (70, 64)))
    monkeypatch.setattr(chip_smoke, "DEPTH18_FLASH_SHAPES", ((200, 8), (70, 16)))
    monkeypatch.setattr(chip_smoke, "DEPTH18_DDD17_SHAPE", (77, 8))
    chip_smoke.phase_other_backwards({"parent/flash_attention_bwd.cu": _plain_revision()})
    out = capsys.readouterr().out
    checks = [line for line in out.splitlines() if "vs plain B=2 N=77 d=8:" in line]
    assert len(checks) == 6  # dQ, dK and dV of both revisions
    assert any("flash_bwd_dkv parent/flash_attention_bwd.cu dv vs plain" in c for c in checks)
    rows = [line for line in out.splitlines() if line.startswith("revisions timing")]
    kinds = [re.search(r'"kind": "([^"]+)"', r).group(1) for r in rows]
    assert kinds == ["flash_bwd_dq", "flash_bwd_dkv"] * 2 + ["flash_bwd_dq R18", "flash_bwd_dkv R18"] * 2
    assert '"N": 200, "d": 8, "blocks": 4' in rows[5]  # 2 x 200 key rows in 128-row blocks
    assert '"N": 70, "d": 16, "blocks": 4' in rows[6]  # the dQ kernel's 64-row blocks
    assert "blocks" not in rows[0]
    assert "flash_bwd_dkv R18 parent/flash_attention_bwd.cu: 4.000 ms per micro-step " \
           "(4 launches)" in out
    assert "flash_bwd_dkv R18 this revision: 4.000 ms per micro-step (4 launches)" in out
    assert " 0 outside " in out and " outside " not in out.replace(" 0 outside ", "")


def _cpu_phase(monkeypatch):
    """chip_smoke's phases on the CPU: cuda generators and tensors made on
    the CPU, each timing one call of its function."""
    _gen, _randn = torch.Generator, torch.randn
    monkeypatch.setattr(torch, "Generator", lambda device=None: _gen())
    monkeypatch.setattr(torch, "randn", lambda *a, device=None, **k: _randn(*a, **k))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps, warmup=2, windows=1: (1.0, fn()))


def test_phase_2_holds_the_backward_where_lse_is_below_minus_88_rehearsed_on_the_cpu(
        monkeypatch, capsys):
    # phase 2 at tiny shapes (this revision's wrappers run their plain
    # versions here): after the check shapes, dQ, dK and dV at the shifted
    # scores of each BWD_LSE_TRAP_SHAPES shape against the plain versions,
    # then the timed rows; a NaN in dQ there fails the phase
    _cpu_phase(monkeypatch)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "BWD_CHECK_SHAPES", ((2, 40, 8),))
    monkeypatch.setattr(chip_smoke, "BWD_LSE_TRAP_SHAPES", ((2, 131, 16), (1, 200, 8)))
    monkeypatch.setattr(chip_smoke, "FLASH_SHAPES", ((70, 32),))
    assert {s[2] for s in chip_smoke.BWD_LSE_TRAP_SHAPES} == {8, 16}
    rows = chip_smoke.phase_flash_backward()
    assert set(rows) == set(chip_smoke.TRAIN_KERNELS)
    lines = capsys.readouterr().out.splitlines()
    for shape in ("B=2 N=131 d=16", "B=1 N=200 d=8"):
        at = lines.index(f"lse < -88 at {shape}:")
        assert [line.split(" vs plain")[0] for line in lines[at + 1:at + 4]] == [
            "flash_bwd_dq dq", "flash_bwd_dkv dk", "flash_bwd_dkv dv"]
        assert all(f"{shape}: max_abs_err" in line for line in lines[at + 1:at + 4])
    plain = fa.flash_bwd_dq_plain

    def nan_at_the_trap(q, *args):
        out = plain(q, *args)
        if q.shape[1] == 131:
            out[0, -1, 0] = float("nan")
        return out

    monkeypatch.setattr(fa, "flash_bwd_dq", nan_at_the_trap)
    with pytest.raises(SystemExit):
        chip_smoke.phase_flash_backward()


# ------------------------------------------------------------ the fragments


def _bf16(x):
    """x rounded to bf16 (to nearest even), as f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


LANES = np.arange(32)
G, T = LANES // 4, LANES % 4  # a lane's group (row) and thread in its group (column pair)


def _a_matrix(a):
    """The 16 x 16 (a: (32, 4, 2)) or 16 x 8 (a: (32, 2, 2)) row-major A of
    m16n8k16 or m16n8k8 from the lanes' registers, each register a pair:
    a[0] row g, a[1] row g + 8 at columns 2t, 2t + 1; a[2], a[3] the same at
    2t + 8. Also returns how often each cell was set."""
    k = 8 * a.shape[1] // 2
    out, hits = np.zeros((16, k), np.float32), np.zeros((16, k), int)
    for r, (row, col) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))[:a.shape[1]]):
        for h in range(2):
            out[G + row, 2 * T + col + h] = a[:, r, h]
            np.add.at(hits, (G + row, 2 * T + col + h), 1)
    return out, hits


def _b_matrix(b):
    """The 16 x 8 (b: (32, 2, 2)) or 8 x 8 (b: (32, 1, 2)) column-major B:
    b[0] rows 2t, 2t + 1 of column g, b[1] rows 2t + 8, 2t + 9."""
    k = 8 * b.shape[1]
    out, hits = np.zeros((k, 8), np.float32), np.zeros((k, 8), int)
    for r in range(b.shape[1]):
        for h in range(2):
            out[2 * T + 8 * r + h, G] = b[:, r, h]
            np.add.at(hits, (2 * T + 8 * r + h, G), 1)
    return out, hits


def _c_cells():
    """(rows, cols) of the C fragment's four registers per lane: c[0], c[1]
    row g, c[2], c[3] row g + 8, columns 2t, 2t + 1."""
    return (np.stack([G, G, G + 8, G + 8], 1), np.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], 1))


def _mma(c, a, b):
    """c (32, 4) + a b, m16n8k16 (a (32, 4, 2), b (32, 2, 2)) or m16n8k8
    (a (32, 2, 2), b (32, 1, 2)), f32 sums."""
    rows, cols = _c_cells()
    return c + (_a_matrix(a)[0] @ _b_matrix(b)[0])[rows, cols]


def _swz_offsets(d: int) -> np.ndarray:
    """The element offset of each (row, column) of a [TILE][d] tile in the
    swizzled layout (``swz``: chunk c of row r at chunk c ^ ((r / (8 / C)) %
    C), C = d / 8)."""
    chunks = d // 8
    r, col = np.meshgrid(np.arange(TILE), np.arange(d), indexing="ij")
    return r * d + ((col // 8) ^ ((r // (8 // chunks)) % chunks)) * 8 + col % 8


def _swz(d: int, row, chunk):
    chunks = d // 8
    return row * d + ((chunk ^ ((row // (8 // chunks)) % chunks)) * 8)


def _ldmatrix_x4(mem, addr, trans: bool):
    """Four 8x8 b16 matrices from ``mem`` (flat), lane l giving row l % 8 of
    matrix l / 8 at element offset addr[l]: register m of lane l holds row
    g, columns 2t, 2t + 1 of matrix m (with ``trans``, rows 2t, 2t + 1 of
    column g). Returns (32, 4, 2)."""
    rows = mem[addr[:, None] + np.arange(8)]  # (32, 8): lane l's row
    out = np.empty((32, 4, 2), np.float32)
    for m in range(4):
        mat = rows[8 * m:8 * m + 8]
        for h in range(2):
            out[:, m, h] = mat[2 * T + h, G] if trans else mat[G, 2 * T + h]
    return out


def _load_a_rows(x, r0, n, d):
    """load_a_rows<d>: rows r0 and r0 + 8 (zeros past n) as A fragments,
    (kSteps, 32, 4, 2)."""
    steps = (d + 15) // 16
    out = np.zeros((steps, 32, 4, 2), np.float32)
    for kk in range(steps):
        for r, (row, col) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            rr, cc = r0 + G + row, kk * 16 + 2 * T + col
            ok = (rr < n) & (cc < d)
            for h in range(2):
                out[kk, :, r, h] = np.where(ok, x[np.minimum(rr, n - 1), np.minimum(cc + h, d - 1)], 0)
    return out


def _stat_slots(lse, delta, tile, n, stale=None, write_past_n=True):
    """load_stat + put_stat of every thread for query tile ``tile``: (lb, nd)
    flat as the source lays them out (lb[kk][t][4], nd[nt][t][4]), written
    over ``stale`` (the slot's earlier contents), and how often each float
    was written. Without ``write_past_n`` queries past n leave the slot as it
    was (a witness only: the kernel writes their zeros)."""
    lb, nd = ((np.zeros(TILE, np.float32), np.zeros(2 * TILE, np.float32)) if stale is None
              else (stale[0].copy(), stale[1].copy()))
    hits_lb, hits_nd = np.zeros(TILE, int), np.zeros(2 * TILE, int)
    for i in range(2 * TILE):
        query = tile * TILE + i % TILE
        if query >= n and not write_past_n:
            continue
        x = np.float32(0) if query >= n else (lse if i < TILE else delta)[query]
        if i < TILE:
            at = ((i // 16) * 4 + (i % 8) // 2) * 4 + ((i // 8) % 2) * 2 + i % 2
            lb[at] = np.float32(x * LOG2E)
            hits_lb[at] += 1
        else:
            c = i - TILE
            at = ((c // 8) * 4 + (c % 8) // 2) * 4 + c % 2
            nd[at] = nd[at + 2] = -x
            hits_nd[[at, at + 2]] += 1
    return (lb, nd), (hits_lb, hits_nd)


def _model_dkv(q, k, v, do, lse, delta, rounding=True, select=True, stale_past_n=False):
    """dK and dV by flash_bwd_dkv_ring's loop, fragment by fragment, in f32
    numpy (``rounding``: P^T and dS^T to bf16 before their products, as at
    bf16; off for f32 inputs). Returns (dK, dV, stores of each output value);
    values stored nowhere stay NaN."""
    b, n, d = q.shape
    blk = _block(d)
    tiles = -(-n // TILE)
    offsets = _swz_offsets(d)
    r8, mat = LANES % 8, LANES // 8
    dk, dv = np.full_like(k, np.nan), np.full_like(v, np.nan)
    stores = np.zeros((b, n, d), int)
    for bi in range(b):
        def tile_rows(x, tile):
            rows = np.zeros((TILE, d), np.float32)
            got = x[bi, tile * TILE:(tile + 1) * TILE]
            rows[:len(got)] = got
            return rows

        for key_block in range(-(-n // blk["rows"])):
            # the ring (each slot a Q tile then a dO tile, swizzled) and which
            # tile each slot and each statistics slot holds
            ring = np.zeros((STAGES, 2, TILE * d), np.float32)
            ring_tile, stat_tile = [-1] * STAGES, [-1, -1]
            stats = [None, None]

            def stage(tile):
                slot = tile % STAGES
                for part, x in enumerate((q, do)):
                    ring[slot, part][offsets] = tile_rows(x, tile)
                ring_tile[slot] = tile

            def put(tile):
                stats[tile & 1] = _stat_slots(lse[bi], delta[bi], tile, n, stats[tile & 1],
                                              not stale_past_n)[0]
                stat_tile[tile & 1] = tile

            for j in range(min(AHEAD, tiles)):
                stage(j)
            put(0)
            warps = []
            for w in range(blk["warps"]):
                key0 = key_block * blk["rows"] + w * 16 * blk["key_tiles"]
                warps.append([{"r0": key0 + m * 16, "ka": _load_a_rows(k[bi], key0 + m * 16, n, d),
                               "va": _load_a_rows(v[bi], key0 + m * 16, n, d),
                               "dk": np.zeros((d // 8, 32, 4), np.float32),
                               "dv": np.zeros((d // 8, 32, 4), np.float32)}
                              for m in range(blk["key_tiles"])])
            for j in range(tiles):
                if j + AHEAD < tiles:
                    stage(j + AHEAD)
                if j + 1 < tiles:
                    put(j + 1)
                slot = j % STAGES
                assert ring_tile[slot] == j and stat_tile[j & 1] == j  # not yet overwritten
                qt, ot = ring[slot, 0], ring[slot, 1]
                lb_s = stats[j & 1][0].reshape(TILE // 16, 4, 4)
                nd_s = stats[j & 1][1].reshape(TILE // 8, 4, 4)
                mask = select and n % TILE != 0 and j == tiles - 1
                for warp in warps:
                    for kk in range(TILE // 16):
                        if d == 8:
                            addr = _swz(d, kk * 16 + (mat & 1) * 8 + r8, 0)
                            both = np.concatenate([qt, ot])
                            bnt = _ldmatrix_x4(both, addr + (mat >= 2) * TILE * d, False)
                            btr = _ldmatrix_x4(both, addr + (mat >= 2) * TILE * d, True)
                            bs = [bnt[:, [0]], bnt[:, [1]]]
                            bd = [bnt[:, [2]], bnt[:, [3]]]
                            bk, bv = [btr[:, [0, 1]]], [btr[:, [2, 3]]]
                        else:
                            off = _swz(d, kk * 16 + (mat >> 1) * 8 + r8, mat & 1)
                            bq, bo = _ldmatrix_x4(qt, off, False), _ldmatrix_x4(ot, off, False)
                            bs, bd = [bq[:, [0, 1]], bq[:, [2, 3]]], [bo[:, [0, 1]], bo[:, [2, 3]]]
                            off = _swz(d, kk * 16 + (mat & 1) * 8 + r8, mat >> 1)
                            ro, rq = _ldmatrix_x4(ot, off, True), _ldmatrix_x4(qt, off, True)
                            bv, bk = [ro[:, [0, 1]], ro[:, [2, 3]]], [rq[:, [0, 1]], rq[:, [2, 3]]]
                        lb = lb_s[kk, T]  # (32, 4)
                        for mt in warp:
                            ka = mt["ka"][0][:, :2] if d == 8 else mt["ka"][0]
                            va = mt["va"][0][:, :2] if d == 8 else mt["va"][0]
                            pa, dsa = np.zeros((32, 4, 2), np.float32), np.zeros((32, 4, 2), np.float32)
                            for i in range(2):
                                s = _mma(np.zeros((32, 4), np.float32), ka, bs[i])
                                dp = _mma(nd_s[2 * kk + i, T], va, bd[i])
                                lbs = lb[:, [2 * i, 2 * i + 1, 2 * i, 2 * i + 1]]
                                with np.errstate(over="ignore"):
                                    p = np.exp2((s.astype(np.float64) * LOG2E - lbs).astype(np.float32))
                                if mask:
                                    col = j * TILE + kk * 16 + i * 8 + 2 * T
                                    past = np.stack([col, col + 1, col, col + 1], 1) >= n
                                    p = np.where(past, np.float32(0), p)
                                with np.errstate(invalid="ignore"):
                                    ds = (p * dp).astype(np.float32)
                                rnd = _bf16 if rounding else (lambda x: x)
                                pa[:, 2 * i], pa[:, 2 * i + 1] = rnd(p[:, :2]), rnd(p[:, 2:])
                                dsa[:, 2 * i], dsa[:, 2 * i + 1] = rnd(ds[:, :2]), rnd(ds[:, 2:])
                            with np.errstate(invalid="ignore", over="ignore"):
                                for jd in range(d // 8):
                                    mt["dv"][jd] = _mma(mt["dv"][jd], pa, bv[jd])
                                    mt["dk"][jd] = _mma(mt["dk"][jd], dsa, bk[jd])
            rows, cols = _c_cells()
            for warp in warps:
                for mt in warp:
                    for jd in range(d // 8):
                        r, c = mt["r0"] + rows, jd * 8 + cols
                        ok = r < n
                        dk[bi, r[ok], c[ok]] = mt["dk"][jd][ok]
                        dv[bi, r[ok], c[ok]] = mt["dv"][jd][ok]
                        np.add.at(stores, (bi, r[ok], c[ok]), 1)
    return dk, dv, stores


def test_fragment_maps_cover_each_cell_once():
    # A (m16n8k16 and m16n8k8), B (both) and C of the lanes' registers each
    # cover their matrix once; the four ldmatrix matrices of a lane's rows
    # read each element of a tile's 16 x 8 chunk pair once, plain and
    # transposed
    assert (_a_matrix(np.zeros((32, 4, 2)))[1] == 1).all()
    assert (_a_matrix(np.zeros((32, 2, 2)))[1] == 1).all()
    assert (_b_matrix(np.zeros((32, 2, 2)))[1] == 1).all()
    assert (_b_matrix(np.zeros((32, 1, 2)))[1] == 1).all()
    rows, cols = _c_cells()
    hits = np.zeros((16, 8), int)
    np.add.at(hits, (rows, cols), 1)
    assert (hits == 1).all()
    mem = np.arange(32 * 8, dtype=np.float32)
    for trans in (False, True):
        got = _ldmatrix_x4(mem, np.arange(32) * 8, trans)
        assert sorted(got.ravel().tolist()) == mem.tolist()


@pytest.mark.parametrize("d", [8, 16])
def test_swizzle_and_ldmatrix_rows_cover_a_tile_once(d):
    # the swizzled tile is a permutation of its elements, and the chunks of
    # 16 queries the kernel's ldmatrix addresses name (plain and transposed)
    # cover those queries' rows and chunks once
    offsets = _swz_offsets(d)
    assert sorted(offsets.ravel().tolist()) == list(range(TILE * d))
    r8, mat = LANES % 8, LANES // 8
    for kk in range(TILE // 16):
        if d == 8:
            starts = [_swz(d, kk * 16 + (mat & 1) * 8 + r8, 0)]
        else:
            starts = [_swz(d, kk * 16 + (mat >> 1) * 8 + r8, mat & 1),
                      _swz(d, kk * 16 + (mat & 1) * 8 + r8, mat >> 1)]
        want = sorted(offsets[kk * 16:kk * 16 + 16].ravel().tolist())
        for start in starts:
            read = (start[:, None] + np.arange(8)).ravel()
            if d == 8:  # Q's two matrices, then dO's at the same offsets
                read = read[:16 * 8]
            assert sorted(read.tolist()) == want


@pytest.mark.parametrize("d", [8, 16])
def test_block_rows_cover_each_key_once(d):
    # warps x 16-row key tiles x (g, g + 8) over a block's rows
    s = _block(d)
    rows, _ = _c_cells()
    hits = np.zeros(s["rows"], int)
    for w in range(s["warps"]):
        for m in range(s["key_tiles"]):
            np.add.at(hits, (w * 16 * s["key_tiles"] + m * 16 + rows[:, [0, 2]]).ravel(), 1)
    assert (hits == 4).all()  # each row in the 4 lanes of its group


@pytest.mark.parametrize("tile", [1, 3])
def test_statistics_slots_are_each_written_once_where_the_fragments_read_them(tile):
    # put_stat's layout: every float of a slot written once a tile, and the
    # lane (g, t) of score tile 2 kk + i reads lb and -D of its own columns,
    # 0 past n (tile 3 of n 200 holds 8 queries)
    n = 200
    lse = RNG.normal(0, 1, n).astype(np.float32)
    delta = RNG.normal(0, 1, n).astype(np.float32)
    (lb, nd), (hits_lb, hits_nd) = _stat_slots(lse, delta, tile, n)
    assert (hits_lb == 1).all() and (hits_nd == 1).all()
    lb, nd = lb.reshape(TILE // 16, 4, 4), nd.reshape(TILE // 8, 4, 4)
    pad = np.zeros(TILE, np.float32)
    lse_t = (np.concatenate([lse, pad]) * LOG2E).astype(np.float32)
    delta_t = np.concatenate([delta, pad])
    for kk in range(TILE // 16):
        for i in range(2):
            for t in range(4):
                c = tile * TILE + kk * 16 + i * 8 + 2 * t
                np.testing.assert_array_equal(lb[kk, t, 2 * i:2 * i + 2], lse_t[c:c + 2])
                np.testing.assert_array_equal(nd[2 * kk + i, t], -delta_t[[c, c + 1, c, c + 1]])


def _jax_backward(q, k, v, do, dtype, block: int = 128):
    """(O, lse, dQ, dK, dV) of the JAX package's Pallas kernels in interpret
    mode at ``dtype``, with blocks of ``block`` rows (N padded to a whole
    block), as f32 numpy."""
    qj, kj, vj, doj = (jnp.asarray(x, dtype=dtype) for x in (q, k, v, do))
    o, lse = _flash_forward(qj, kj, vj, block_q=block, block_k=block, interpret=True,
                            return_lse=True)
    dq, dk, dv = _flash_backward(qj, kj, vj, o, lse, doj, block_q=block, block_k=block,
                                 interpret=True)
    return tuple(np.asarray(x.astype(jnp.float32)) for x in (o, lse, dq, dk, dv))


def _inputs(b, n, d, shift=False, bf16=False):
    """Seeded q, k, v, dO (bf16-representable with ``bf16``); with
    ``shift``, scores near -121, so that every lse is below -88."""
    q, k, v, do = (RNG.normal(0, 0.5 if shift else 1.0, (b, n, d)).astype(np.float32)
                   for _ in range(4))
    if shift:
        q[..., 0], k[..., 0] = 11.0, -11.0  # s = -121 + O(1)
    return tuple(_bf16(x) if bf16 else x for x in (q, k, v, do))


SHAPES = [(1, 64, 8), (1, 64, 16),  # one whole tile
          (2, 131, 8), (2, 131, 16),  # a ragged third tile, 3 queries
          (1, 200, 8), (1, 200, 16),  # a ragged fourth tile, 8 queries; two key blocks
          (1, 325, 8), (1, 325, 16)]  # ragged over six tiles; a third, partial key block


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_model_matches_the_pallas_backward_at_bf16(b, n, d):
    # the kernel's loop at bf16 (P and dS rounded before their products, f32
    # sums, bf16 outputs) against the Pallas backward on the same bf16
    # inputs, at phase 2's gate; the plain version beside it
    q, k, v, do = _inputs(b, n, d, bf16=True)
    o, lse, _, want_dk, want_dv = _jax_backward(q, k, v, do, jnp.bfloat16)
    lse = lse.reshape(b, n)
    delta = (do * o).sum(axis=2, dtype=np.float32)
    dk, dv, stores = _model_dkv(q, k, v, do, lse, delta)
    assert (stores == 1).all()
    t = [torch.tensor(x).to(torch.bfloat16) for x in (q, k, v, do)]
    plain = fa.flash_bwd_dkv_plain(*t, torch.tensor(lse), torch.tensor(delta))
    for got, want in ((_bf16(dk), want_dk), (_bf16(dv), want_dv),
                      (plain[0].float().numpy(), want_dk), (plain[1].float().numpy(), want_dv)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=chip_smoke.BWD_ATOL * np.abs(want).max(),
                                   rtol=chip_smoke.BWD_RTOL)


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_model_matches_the_pallas_backward_at_f32(b, n, d):
    # the same loop with f32 inputs and no rounding of P and dS, against the
    # Pallas backward at f32 (the JAX tests' bounds)
    q, k, v, do = _inputs(b, n, d)
    o, lse, _, want_dk, want_dv = _jax_backward(q, k, v, do, jnp.float32)
    lse = lse.reshape(b, n)
    delta = (do * o).sum(axis=2, dtype=np.float32)
    dk, dv, stores = _model_dkv(q, k, v, do, lse, delta, rounding=False)
    assert (stores == 1).all()
    for got, want in ((dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("d", [8, 16])
def test_model_is_finite_where_lse_is_below_minus_88_and_needs_the_select(d):
    # scores near -121 at a ragged N (the last tile holds 3 queries): the
    # model matches the Pallas backward and is finite. Past N its statistics
    # slot may hold an earlier tile's lse (below -88): there the select alone
    # keeps P = 0, where s = 0 would give P = 2^(-lb) = inf and inf * 0 = NaN
    b, n = 2, 131
    q, k, v, do = _inputs(b, n, d, shift=True)
    o, lse, _, want_dk, want_dv = _jax_backward(q, k, v, do, jnp.float32)
    lse = lse.reshape(b, n)
    assert lse.max() < -88
    delta = (do * o).sum(axis=2, dtype=np.float32)
    for stale in (False, True):
        dk, dv, _ = _model_dkv(q, k, v, do, lse, delta, rounding=False, stale_past_n=stale)
        for got, want in ((dk, want_dk), (dv, want_dv)):
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, atol=chip_smoke.F32_TRAP_ATOL * np.abs(want).max(),
                                       rtol=chip_smoke.BWD_F32_RTOL)
    dk, dv, _ = _model_dkv(q, k, v, do, lse, delta, rounding=False, select=False, stale_past_n=True)
    assert np.isnan(dv).any()


# ------------------------------------------------------------ the dQ kernel's loop


def _dq_b_fragments(kt, vt, kk, d, bt):
    """The B fragments ``dq_tile`` reads for keys 16 kk.. of the swizzled K
    and V tiles kt, vt (flat): of S's two score tiles, of dP's, and of dQ +=
    dS K per 8 columns of d. At d 8 the transposed x4 (K rows +0, +8, +16,
    +24) is read on even steps and serves the next one too: ``bt`` carries
    it ([None] before the first read)."""
    r8, mat = LANES % 8, LANES // 8
    if d == 8:
        b = _ldmatrix_x4(np.concatenate([kt, vt]),
                         _swz(d, kk * 16 + (mat & 1) * 8 + r8, 0) + (mat >= 2) * TILE * d, False)
        if kk % 2 == 0:
            bt[0] = _ldmatrix_x4(kt, _swz(d, kk * 16 + mat * 8 + r8, 0), True)
        h = 2 * (kk % 2)
        return [b[:, [0]], b[:, [1]]], [b[:, [2]], b[:, [3]]], [bt[0][:, [h, h + 1]]]
    off = _swz(d, kk * 16 + (mat >> 1) * 8 + r8, mat & 1)
    bk, bv = _ldmatrix_x4(kt, off, False), _ldmatrix_x4(vt, off, False)
    bt[0] = _ldmatrix_x4(kt, _swz(d, kk * 16 + (mat & 1) * 8 + r8, mat >> 1), True)
    return ([bk[:, [0, 1]], bk[:, [2, 3]]], [bv[:, [0, 1]], bv[:, [2, 3]]],
            [bt[0][:, [0, 1]], bt[0][:, [2, 3]]])


def _model_dq(q, k, v, do, lse, delta, rounding=True, select=True):
    """dQ by flash_bwd_dq_ring's loop, fragment by fragment, in f32 numpy
    (``rounding``: dS to bf16 before its product, as at bf16; off for f32
    inputs). Returns (dQ, stores of each output value); values stored
    nowhere stay NaN."""
    b, n, d = q.shape
    blk = _dq_block(d)
    tiles = -(-n // TILE)
    offsets = _swz_offsets(d)
    rows, cols = _c_cells()
    dq = np.full_like(q, np.nan)
    stores = np.zeros((b, n, d), int)
    for bi in range(b):
        def tile_rows(x, tile):
            out = np.zeros((TILE, d), np.float32)
            got = x[bi, tile * TILE:(tile + 1) * TILE]
            out[:len(got)] = got
            return out

        def stat(x, r):  # a row's statistic, 0 past n
            return np.where(r < n, x[bi, np.minimum(r, n - 1)], np.float32(0))

        for row_block in range(-(-n // blk["rows"])):
            # the ring (each slot a K tile then a V tile, swizzled) and which
            # tile each slot holds
            ring = np.zeros((STAGES, 2, TILE * d), np.float32)
            ring_tile = [-1] * STAGES

            def stage(tile):
                slot = tile % STAGES
                for part, x in enumerate((k, v)):
                    ring[slot, part][offsets] = tile_rows(x, tile)
                ring_tile[slot] = tile

            for j in range(min(AHEAD, tiles)):
                stage(j)
            warps = []
            for w in range(blk["warps"]):
                row0 = row_block * blk["rows"] + w * 16 * blk["row_tiles"]
                warps.append([])
                for m in range(blk["row_tiles"]):
                    r0 = row0 + m * 16
                    lb = [(stat(lse, r0 + G + h * 8) * LOG2E).astype(np.float32) for h in range(2)]
                    nd = [-stat(delta, r0 + G + h * 8) for h in range(2)]
                    warps[-1].append({
                        "r0": r0, "qa": _load_a_rows(q[bi], r0, n, d),
                        "da": _load_a_rows(do[bi], r0, n, d),
                        "lb": np.stack([lb[0], lb[0], lb[1], lb[1]], 1),
                        "nd": np.stack([nd[0], nd[0], nd[1], nd[1]], 1).astype(np.float32),
                        "acc": np.zeros((d // 8, 32, 4), np.float32)})
            for j in range(tiles):
                if j + AHEAD < tiles:
                    stage(j + AHEAD)
                slot = j % STAGES
                assert ring_tile[slot] == j  # not yet overwritten
                kt, vt = ring[slot, 0], ring[slot, 1]
                mask = select and n % TILE != 0 and j == tiles - 1
                for warp in warps:
                    bt = [None]
                    for kk in range(TILE // 16):
                        bs, bd, bq = _dq_b_fragments(kt, vt, kk, d, bt)
                        for mt in warp:
                            qa = mt["qa"][0][:, :2] if d == 8 else mt["qa"][0]
                            da = mt["da"][0][:, :2] if d == 8 else mt["da"][0]
                            dsa = np.zeros((32, 4, 2), np.float32)
                            for i in range(2):
                                s = _mma(np.zeros((32, 4), np.float32), qa, bs[i])
                                dp = _mma(mt["nd"], da, bd[i])
                                with np.errstate(over="ignore"):
                                    p = np.exp2((s.astype(np.float64) * LOG2E - mt["lb"])
                                                .astype(np.float32))
                                if mask:
                                    key = j * TILE + kk * 16 + i * 8 + 2 * T
                                    past = np.stack([key, key + 1, key, key + 1], 1) >= n
                                    p = np.where(past, np.float32(0), p)
                                with np.errstate(invalid="ignore"):
                                    ds = (p * dp).astype(np.float32)
                                if rounding:
                                    ds = _bf16(ds)
                                dsa[:, 2 * i], dsa[:, 2 * i + 1] = ds[:, :2], ds[:, 2:]
                            with np.errstate(invalid="ignore", over="ignore"):
                                for jd in range(d // 8):
                                    mt["acc"][jd] = _mma(mt["acc"][jd], dsa, bq[jd])
            for warp in warps:
                for mt in warp:
                    for jd in range(d // 8):
                        r, c = mt["r0"] + rows, jd * 8 + cols
                        ok = r < n
                        dq[bi, r[ok], c[ok]] = mt["acc"][jd][ok]
                        np.add.at(stores, (bi, r[ok], c[ok]), 1)
    return dq, stores


@pytest.mark.parametrize("d", [8, 16])
def test_dq_ldmatrix_addresses_cover_a_tile_once(d):
    # over a 64-key tile the B fragments dq_tile reads name each element of
    # the K tile once for S, of the V tile once for dP and of the K tile
    # once, transposed, for dQ: the K and V tiles written from known values
    # come back as the B matrices of their own keys
    kt = np.zeros(TILE * d, np.float32)
    kt[_swz_offsets(d).ravel()] = np.arange(TILE * d, dtype=np.float32)
    vt = kt + TILE * d
    keys = np.arange(TILE * d).reshape(TILE, d)
    bt = [None]
    for kk in range(TILE // 16):
        bs, bd, bq = _dq_b_fragments(kt, vt, kk, d, bt)
        for i in range(2):  # score tile 2 kk + i: B[dd][key] = K[key][dd]
            want = keys[kk * 16 + i * 8:kk * 16 + i * 8 + 8].T
            np.testing.assert_array_equal(_b_matrix(bs[i])[0], want[:8 * bs[i].shape[1]])
            np.testing.assert_array_equal(_b_matrix(bd[i])[0], want[:8 * bd[i].shape[1]] + TILE * d)
        for jd in range(d // 8):  # dQ's B[key][dd] = K[key][dd] over 16 keys, 8 columns
            np.testing.assert_array_equal(_b_matrix(bq[jd])[0],
                                          keys[kk * 16:kk * 16 + 16, jd * 8:jd * 8 + 8])


@pytest.mark.parametrize("d", [8, 16])
def test_dq_block_rows_cover_each_query_once(d):
    # warps x 16-row query tiles x (g, g + 8) over a block's rows
    s = _dq_block(d)
    rows, _ = _c_cells()
    hits = np.zeros(s["rows"], int)
    for w in range(s["warps"]):
        for m in range(s["row_tiles"]):
            np.add.at(hits, (w * 16 * s["row_tiles"] + m * 16 + rows[:, [0, 2]]).ravel(), 1)
    assert (hits == 4).all()  # each row in the 4 lanes of its group


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_dq_model_matches_the_pallas_backward_at_bf16(b, n, d):
    # the dQ kernel's loop at bf16 (dS rounded before its product, f32 sums,
    # a bf16 output) against the Pallas backward on the same bf16 inputs, at
    # phase 2's gate; the plain version beside it
    q, k, v, do = _inputs(b, n, d, bf16=True)
    o, lse, want, _, _ = _jax_backward(q, k, v, do, jnp.bfloat16)
    lse = lse.reshape(b, n)
    delta = (do * o).sum(axis=2, dtype=np.float32)
    dq, stores = _model_dq(q, k, v, do, lse, delta)
    assert (stores == 1).all()
    t = [torch.tensor(x).to(torch.bfloat16) for x in (q, k, v, do)]
    plain = fa.flash_bwd_dq_plain(*t, torch.tensor(lse), torch.tensor(delta))
    for got in (_bf16(dq), plain.float().numpy()):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=chip_smoke.BWD_ATOL * np.abs(want).max(),
                                   rtol=chip_smoke.BWD_RTOL)


@pytest.mark.parametrize("b,n,d", SHAPES)
def test_dq_model_matches_the_pallas_backward_at_f32(b, n, d):
    # the same loop with f32 inputs and no rounding of dS, against the
    # Pallas backward at f32 (the JAX tests' bounds)
    q, k, v, do = _inputs(b, n, d)
    o, lse, want, _, _ = _jax_backward(q, k, v, do, jnp.float32)
    lse = lse.reshape(b, n)
    delta = (do * o).sum(axis=2, dtype=np.float32)
    dq, stores = _model_dq(q, k, v, do, lse, delta, rounding=False)
    assert (stores == 1).all()
    np.testing.assert_allclose(dq, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("d", [8, 16])
def test_dq_model_is_finite_where_lse_is_below_minus_88_and_needs_the_select(d):
    # scores near -121 at a ragged N (the last tile holds 3 keys): the model
    # matches the Pallas backward and is finite. The Pallas dQ runs in one
    # block of N rows here: padded to a whole block it is NaN, as its padded
    # keys give P = exp(-lse) = inf times their zero K rows. Without the
    # select the model's zero-filled keys do the same
    b, n = 2, 131
    q, k, v, do = _inputs(b, n, d, shift=True)
    o, lse, want, _, _ = _jax_backward(q, k, v, do, jnp.float32, block=n)
    lse = lse.reshape(b, n)
    assert lse.max() < -88
    delta = (do * o).sum(axis=2, dtype=np.float32)
    dq, _ = _model_dq(q, k, v, do, lse, delta, rounding=False)
    assert np.isfinite(dq).all()
    np.testing.assert_allclose(dq, want, atol=chip_smoke.F32_TRAP_ATOL * np.abs(want).max(),
                               rtol=chip_smoke.BWD_F32_RTOL)
    dq, _ = _model_dq(q, k, v, do, lse, delta, rounding=False, select=False)
    assert np.isnan(dq).any()
