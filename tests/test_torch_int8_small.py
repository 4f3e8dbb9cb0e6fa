"""The int8 forward at head dims 8 and 16 (B4 in both modes, ``flash_int8_ring``
in ``csrc/flash_attention_int8.cu``): its block against the CUDA source's
constants, the dispatch and phase 1's instances, the blocks phase 15 counts,
the A/B tooling of ``chip_smoke.py`` at the depth-18 launches, and a numpy
model of the kernel's loop at the level of its mma.sync fragments against the
JAX package's Pallas int8 forward.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
``flash_attention_int8_plain``. The model follows the source lane by lane:
the ring of 64-key tiles (which slot each tile lands in and when, keys past N
zero-filled), the K rows padded to 16 bytes at d 8, the ldmatrix B fragments
of K and of the swizzled V and V^T tiles, the s8 m16n8k16 scores with their
accumulator started at the magic constant, the row max on those int32
scores, float(s) by one subtraction and the exponent by one FMA, p_q by the
magic add packed in the PV key order, the int32 PV and row sums and their
flush into f32, and the tensor-core row sums of the bf16 p.

Bounds of the JAX comparison: at bf16 inputs (the card's) phase 5's gate,
FLASH_ATOL and FLASH_RTOL (ex2 of the FMA'd exponent against exp, and a p or
p_q one rounding step apart, carried into a bf16 output). With f32 inputs and
the model's p taken as the plain version takes it (exp of the rounded f32
product minus the running max, the same rounding of p_q, no bf16 rounding of
p or of the output), the JAX tests' atol 2e-5, rtol 1e-4: what is left is
summation order.
"""

import ctypes
import re
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from frn_tpu.ops.flash_attention import _flash_forward_int8
from frn_tpu_torch import build
from frn_tpu_torch.ops import flash_attention as fa

RNG = np.random.default_rng(43)
SOURCE = (build.CSRC / "flash_attention_int8.cu").read_text()
COMMON = (build.CSRC / "flash_common.cuh").read_text()
SM90 = (build.CSRC / "flash_sm90.cuh").read_text()
H100_SMS = 132
H100_SMEM_PER_SM = 228 * 1024
MAGIC = 0x4B400000  # the bits of 1.5 * 2^23
MAGIC_F = np.float32(12582912.0)
LOG2E = np.float32(1.4426950408889634)
LOG2_127 = np.float32(6.988684686772166)
FLUSH_TILES = 1024


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several processes at once; torch's default of one
    intra-op thread per core in each of them oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _constant(text: str, name: str):
    """The value of ``constexpr int|float name = ...;`` in a source."""
    value = re.search(rf"constexpr (?:int|float) {name} = ([\w.]+);", text).group(1)
    return float(value.rstrip("f")) if "." in value else int(value, 0)


def _rule(name: str) -> dict:
    """{head dim: value} of the source's ``constexpr int name()`` for d 8 and
    16: its body is a constant or ``D == 8 ? a : b``."""
    body = re.search(rf"constexpr int {name}\(\) \{{ return ([^;]+); \}}", SOURCE).group(1)
    m = re.fullmatch(r"D == 8 \? (\d+) : (\d+)", body)
    return {8: int(m.group(1)), 16: int(m.group(2))} if m else {8: int(body), 16: int(body)}


TILE = _constant(COMMON, "kTile")
STAGES, AHEAD = _constant(SM90, "kStages"), _constant(SM90, "kAhead")


def _block(d: int) -> dict:
    """The ring kernel's block at head dim d, from the source."""
    warps, tiles = _rule("ring_warps")[d], _rule("ring_row_tiles")[d]
    return {"warps": warps, "row_tiles": tiles, "rows": warps * 16 * tiles,
            "blocks_per_sm": _rule("ring_blocks_per_sm")[d]}


def _k_row_bytes(d: int) -> int:
    return max(d, 16)


def _slot_bytes(d: int, full: bool) -> int:
    return TILE * _k_row_bytes(d) + (1 if full else 2) * TILE * d


# ------------------------------------------------------------ the block and the dispatch


def test_block_constants_match_the_source_and_phase_15():
    # rows a block owns (phase 15's blocks), the key tile, the ring, the
    # magic constants and the flush period, as the CUDA source has them (it
    # is compiled only on the card)
    for d in (8, 16):
        assert _block(d)["rows"] == chip_smoke.MMA_ROWS["flash_int8_qk"] == chip_smoke.MMA_ROWS[
            "flash_int8"]
    assert TILE == fa.KERNEL_TILE == 64 and (STAGES, AHEAD) == (4, 2)
    assert re.search(r"constexpr int ring_rows\(\) \{ return ring_warps<D>\(\) \* 16 \* "
                     r"ring_row_tiles<D>\(\); \}", SOURCE)
    assert _constant(SOURCE, "kMagic") == MAGIC and _constant(SOURCE, "kFlushTiles") == FLUSH_TILES
    assert np.float32(_constant(SOURCE, "kMagicF")) == MAGIC_F
    assert np.uint32(MAGIC).view(np.float32) == MAGIC_F
    # the flush keeps the int32 sums in range: kFlushTiles - 1 tiles of 64
    # keys, p_q and |v_q| at most 127
    assert (FLUSH_TILES - 1) * TILE * 127 * 127 < 2 ** 31


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("full", [False, True])
def test_blocks_fit_an_sm(d, full):
    # static shared memory (the ring, under the 48 KB a static array may
    # take) and 1 KB reserved a block within the H100's 228 KB; the block's
    # registers at the blocks an SM that __launch_bounds__ asks for leave
    # each thread at least 64 of the SM's 64 K; the copies of a tile fit the
    # block's threads in whole rounds
    s = _block(d)
    smem = STAGES * _slot_bytes(d, full)
    assert smem <= 48 * 1024 and s["blocks_per_sm"] * (smem + 1024) <= H100_SMEM_PER_SM
    assert 65536 // (s["blocks_per_sm"] * s["warps"] * 32) >= 64
    assert _slot_bytes(d, full) % 128 == 0  # every slot starts as aligned as the ring
    copies = TILE + (d * TILE // 16 if full else TILE * d // 8)
    assert copies <= 2 * s["warps"] * 32


def test_the_kernel_bounds_its_launch_by_its_blocks_an_sm():
    assert re.search(r"__launch_bounds__\(ring_warps<D>\(\) \* 32, ring_blocks_per_sm<D>\(\)\)\s*"
                     r"flash_int8_ring", SOURCE)
    assert re.search(r"flash_int8_ring<D, kFull><<<grid, ring_warps<D>\(\) \* 32, 0,", SOURCE)


def test_dispatch_takes_the_ring_kernel_at_d_8_and_16_and_phase_1_wants_it():
    launch_d = SOURCE[SOURCE.index("int launch_d(int d"):]
    launch_d = launch_d[:launch_d.index("\n}\n")]
    assert {int(d) for d in re.findall(r"case (\d+): return launch_ring<\1, kFull>", launch_d)} == {
        8, 16}
    assert {int(d) for d in re.findall(r"case (\d+): return launch_wgmma<\1, kFull", launch_d)} == {
        32, 64}
    assert "flash_int8_mma" not in SOURCE  # the first design is gone
    want = [("flash_int8_ring", d, f) for d in (8, 16) for f in (0, 1)]
    assert set(want) <= set(chip_smoke.PATH_INSTANCES["flash_attention_int8"])


def test_no_score_takes_a_second_special_function_instruction():
    # the ring kernel's loop converts by the magic add and rounds by an FADD:
    # no float conversion of an int, no float-to-int, no __expf
    ring = SOURCE[SOURCE.index("ring kernel (d 8, 16)"):SOURCE.index("// ---------------------"
                                                                       "--------------------------"
                                                                       "------------- launch")]
    helpers = SOURCE[SOURCE.index("a score tile's softmax"):SOURCE.index("wgmma kernel (d 32, 64)")]
    for text in (ring, helpers):
        assert "__expf" not in text and "__float2int" not in text
    assert "static_cast<float>(quad_max_i" not in helpers  # the unbiased max converts once a row
    assert "kBiased ? score_float<true>(top) : static_cast<float>(top)" in helpers


_MANGLED = ("_ZN12_GLOBAL__N_115flash_int8_ringILi{}ELb{}EEEvPKaS2_PKvPKfS6_P13__nv_bfloat16ii",
            "_ZN12_GLOBAL__N_116flash_int8_wgmmaILi{}ELb{}ELi{}EEEv14CUtensorMap_stS1_PKaPKfS5_P13"
            "__nv_bfloat16i")


def _ptxas_log(instances: dict) -> str:
    """A compiler log of the int8 source's instances {(kernel, d, full):
    (registers, spill bytes)} as nvcc -Xptxas -v prints it."""
    lines = []
    for (kernel, d, full), (regs, spill) in instances.items():
        name = (_MANGLED[0].format(d, full) if kernel == "flash_int8_ring"
                else _MANGLED[1].format(d, full, 4 if d == 32 else 3))
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  "ptxas info    : Function properties for x",
                  f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("d", [8, 16])
@pytest.mark.parametrize("full", [0, 1])
def test_phase_1_reads_the_ring_instance_from_the_compiler_log(d, full):
    log = _ptxas_log({("flash_int8_ring", d, full): (96, 0)})
    assert chip_smoke.kernel_instances(log) == {("flash_int8_ring", d, full): (96, 0, 0)}


def test_phase_1_takes_the_ring_instances_and_refuses_a_spill_or_a_gap(capsys):
    every = {key: (120, 0) for key in chip_smoke.PATH_INSTANCES["flash_attention_int8"]}
    chip_smoke.check_path_instances("flash_attention_int8", _ptxas_log(every))
    out = capsys.readouterr().out
    assert "flash_int8_ring<16, 1>: 120 registers" in out and "flash_int8_wgmma<64, 0, 3>" in out
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances(
            "flash_attention_int8", _ptxas_log({**every, ("flash_int8_ring", 8, 1): (128, 16)}))
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention_int8", _ptxas_log(
            {k: v for k, v in every.items() if k != ("flash_int8_ring", 16, 0)}))


@pytest.mark.parametrize("kind,shape,blocks", [
    ("flash_int8_qk", (16, 19200, 8), 4800), ("flash_int8_qk", (16, 4800, 16), 1200),
    ("flash_int8", (32, 19200, 8), 9600), ("flash_int8", (32, 4800, 16), 2400),
    ("flash_int8", (2, 5655, 8), 178)])
def test_phase_15_counts_the_ring_kernels_blocks(kind, shape, blocks):
    # the depth-18 opt-in launches (int8_qk at batch 16, int8 over 2B under
    # fused attention) and DDD17's ragged check shape, in blocks of the
    # source's rows
    rows = _block(shape[2])["rows"]
    assert chip_smoke.depth18_blocks(kind, *shape) == blocks == shape[0] * -(-shape[1] // rows)
    if shape[0] != 2:  # a timed launch of phase 15, and it fills the card
        count = 2 if kind == "flash_int8_qk" else 1
        assert (*shape, count) in chip_smoke.depth18_launch_shapes()[kind]
        assert blocks >= H100_SMS


def test_phase_5_checks_the_int8_modes_past_a_block_and_at_an_odd_n():
    # the int8 checks: every shape the other flash kernels are held at, and
    # a ragged row past a 128-row block at d 16 and an odd N at d 8
    assert chip_smoke.INT8_CHECK_SHAPES[:len(chip_smoke.BWD_CHECK_SHAPES)] == (
        chip_smoke.BWD_CHECK_SHAPES)
    extra = set(chip_smoke.INT8_CHECK_SHAPES) - set(chip_smoke.BWD_CHECK_SHAPES)
    assert extra == {(2, 129, 16), (2, 131, 8)}
    assert {(2, 40, 8), (2, 40, 16), (2, 4800, 16), (2, 5655, 8)} <= set(chip_smoke.INT8_CHECK_SHAPES)


# ------------------------------------------------------------ the A/B tooling


def _bf16_at(ptr: int, shape) -> torch.Tensor:
    """The bf16 tensor of ``shape`` at ``ptr`` (a CPU tensor's data here)."""
    x = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int16)), shape=shape)
    return torch.from_numpy(x).view(torch.bfloat16)


def _plain_revision(calls: list):
    """Another revision's int8 entry point, standing in on the CPU: the
    plain version on the bf16 inputs the caller's quantized inputs came from
    (the test keeps them), written through the output pointer."""

    def frn_flash_int8(qi, ki, vk, scale, v_scale, o, b, n, n_pad, d, full):
        calls.append((b, n, n_pad, d, full))
        q, k, v = calls.inputs
        _bf16_at(o, (b, n, d)).copy_(
            fa.flash_attention_int8_plain(q, k, v, "int8" if full else "int8_qk"))

    return types.SimpleNamespace(frn_flash_int8=frn_flash_int8)


class _Calls(list):
    inputs = None


def test_phase_other_int8_runs_the_depth_18_launches_in_turns(monkeypatch, capsys):
    # the phase on the CPU at tiny shapes: this revision's wrapper (its plain
    # version here) and another revision's entry point in turns, whole and
    # kernel alone, at depth 50's and depth 18's launches, each output held
    # against the plain version; the depth-18 rows with this revision's
    # blocks, and each mode summed per batch
    _gen, _randn = torch.Generator, torch.randn
    made = _Calls()
    real_plain = fa.flash_attention_int8_plain

    def plain(q, k, v, mode="int8", block_k=fa.KERNEL_TILE):
        made.inputs = (q, k, v)
        return real_plain(q, k, v, mode, block_k)

    monkeypatch.setattr(torch, "Generator", lambda device=None: _gen())
    monkeypatch.setattr(torch, "randn", lambda *a, device=None, **k: _randn(*a, **k))
    monkeypatch.setattr(fa, "flash_attention_int8_plain", plain)
    monkeypatch.setattr(fa, "_int8_library", lambda: _plain_revision(made))
    monkeypatch.setattr(fa, "_launch", lambda fn, q, *args: fn(*args))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps, warmup=2, windows=1: (1.0, fn()))
    monkeypatch.setattr(chip_smoke, "MAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "FLASH_SHAPES", ((131, 32), (70, 64)))
    monkeypatch.setattr(chip_smoke, "DEPTH18_FLASH_SHAPES", ((200, 8), (70, 16)))
    chip_smoke.phase_other_int8({"parent/flash_attention_int8.cu": _plain_revision(made)})
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines() if line.startswith("revisions timing")]
    kinds = [re.search(r'"kind": "([^"]+)"', r).group(1) for r in rows]
    want = []
    for mode in ("int8_qk", "int8"):
        for suffix in ("", "", " R18", " R18"):
            want += [f"flash_{mode}{suffix}", f"flash_{mode}{suffix} kernel alone"]
    assert kinds == want
    # int8_qk at MAIN_BATCH 2: 2 x 200 rows in 64-row blocks; int8 at 2B
    assert '"kind": "flash_int8_qk R18", "B": 2, "N": 200, "d": 8, "blocks": 8' in rows[4]
    assert '"kind": "flash_int8 R18", "B": 4, "N": 70, "d": 16, "blocks": 8' in rows[14]
    assert "blocks" not in rows[0]
    assert "flash_int8_qk R18 parent/flash_attention_int8.cu: 4.000 ms per batch (4 launches)" in out
    assert "flash_int8 R18 kernel alone this revision: 2.000 ms per batch (2 launches)" in out
    assert " 0 outside " in out and " outside " not in out.replace(" 0 outside ", "")
    # the other revision got the int8 layout's padded N in mode int8
    assert (4, 200, 256, 8, 1) in made and (2, 200, 200, 8, 0) in made


# ------------------------------------------------------------ the model's fragments


def _bf16(x):
    """x rounded to bf16 (to nearest even), as f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


LANES = np.arange(32)
G, T = LANES // 4, LANES % 4  # a lane's group (row) and thread in its group
R8, MAT = LANES % 8, LANES // 8  # the row and matrix of a lane's ldmatrix address


def _s8_cells(regs: int, a_side: bool):
    """(rows, cols) of each lane's bytes, (32, regs, 4) each: of the
    row-major A of s8 m16n8k16 (2 registers) or m16n8k32 (4): register 0 row
    g, 1 row g + 8, at bytes 4t..4t+3, registers 2, 3 the same at 16 + 4t; of
    the column-major B (1 or 2 registers): register r bytes 16 r + 4t..+3 of
    column g."""
    byte = 4 * T[:, None, None] + np.arange(4)[None, None, :]
    if a_side:
        offs = np.array([(0, 0), (8, 0), (0, 16), (8, 16)][:regs])
        rows = G[:, None, None] + offs[None, :, 0, None] + 0 * byte
        return rows, offs[None, :, 1, None] + byte
    return 16 * np.arange(regs)[None, :, None] + byte, G[:, None, None] + 0 * byte


def _bf_cells(a_side: bool):
    """(rows, cols) of each lane's two bf16 values, (32, regs, 2): the A of
    bf16 m16n8k16 (a[0] row g, a[1] row g + 8 at columns 2t, 2t + 1; a[2],
    a[3] the same at 2t + 8), or its B (b[0] rows 2t, 2t + 1 of column g,
    b[1] rows 2t + 8, 2t + 9)."""
    pair = 2 * T[:, None, None] + np.arange(2)[None, None, :]
    if a_side:
        offs = np.array([(0, 0), (8, 0), (0, 8), (8, 8)])
        return G[:, None, None] + offs[None, :, 0, None] + 0 * pair, offs[None, :, 1, None] + pair
    return 8 * np.arange(2)[None, :, None] + pair, G[:, None, None] + 0 * pair


def _matrix(x, cells, shape, dtype):
    out = np.zeros(shape, dtype)
    out[cells] = x
    return out


def _c_cells():
    """(rows, cols) of the C fragment's four registers per lane: c[0], c[1]
    row g, c[2], c[3] row g + 8, columns 2t, 2t + 1."""
    return (np.stack([G, G, G + 8, G + 8], 1), np.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], 1))


S8_A = {regs: _s8_cells(regs, True) for regs in (2, 4)}
S8_B = {regs: _s8_cells(regs, False) for regs in (1, 2)}
BF_A, BF_B = _bf_cells(True), _bf_cells(False)
C_CELLS = _c_cells()


def _mma_s8(c, a, b):
    """c (32, 4) int + a b for s8 m16n8k16 (a (32, 2, 4), b (32, 1, 4)) or
    m16n8k32 (a (32, 4, 4), b (32, 2, 4)), exact."""
    k = 8 * a.shape[1]
    am = _matrix(a, S8_A[a.shape[1]], (16, k), np.int64)
    bm = _matrix(b, S8_B[b.shape[1]], (k, 8), np.int64)
    return c + (am @ bm)[C_CELLS]


def _mma_bf(c, a, b):
    """c (32, 4) f32 + a b for bf16 m16n8k16 (a (32, 4, 2), b (32, 2, 2)),
    f32 sums."""
    am = _matrix(a, BF_A, (16, 16), np.float32)
    bm = _matrix(b, BF_B, (16, 8), np.float32)
    return (c + (am @ bm)[C_CELLS]).astype(np.float32)


def _ldsm_bytes(mem, addr):
    """ldmatrix.x4 (b16) on byte memory, lane l giving the byte offset of row
    l % 8 of matrix l / 8: lane (g, t) gets bytes 4t..4t+3 of row g of each
    matrix. Returns (32, 4, 4)."""
    rows = mem[addr[:, None] + np.arange(16)]  # (32, 16): lane l's row
    out = np.empty((32, 4, 4), mem.dtype)
    for m in range(4):
        out[:, m] = rows[8 * m + G][np.arange(32)[:, None], 4 * T[:, None] + np.arange(4)]
    return out


def _ldsm_b16(mem, addr, trans: bool):
    """ldmatrix.x4 on bf16 memory (element offsets), as the bf16 kernels
    read it: register m of lane l holds row g, columns 2t, 2t + 1 of matrix
    m (with ``trans``, rows 2t, 2t + 1 of column g). Returns (32, 4, 2)."""
    rows = mem[addr[:, None] + np.arange(8)]
    out = np.empty((32, 4, 2), np.float32)
    for m in range(4):
        mat = rows[8 * m:8 * m + 8]
        for h in range(2):
            out[:, m, h] = mat[2 * T + h, G] if trans else mat[G, 2 * T + h]
    return out


def _swz(d: int, row, chunk):
    """``swz<d>``: the bf16 element offset of 16-byte chunk ``chunk`` of row
    ``row`` of a swizzled [rows][d] bf16 tile."""
    chunks = d // 8
    return row * d + ((chunk ^ ((row // (8 // chunks)) % chunks)) * 8)


def test_fragment_maps_cover_each_cell_once():
    # the s8 A (k16 and k32), B (both) and C fragments of the lanes' registers
    # each cover their matrix once, as do the bf16 ones; an ldmatrix.x4 on
    # bytes hands each lane the 4 bytes of its fragment
    for cells, shape in [(S8_A[2], (16, 16)), (S8_A[4], (16, 32)), (S8_B[1], (16, 8)),
                         (S8_B[2], (32, 8)), (BF_A, (16, 16)), (BF_B, (16, 8)), (C_CELLS, (16, 8))]:
        hits = np.zeros(shape, int)
        np.add.at(hits, cells, 1)
        assert (hits == 1).all()
    mem = np.arange(32 * 16, dtype=np.int64)
    got = _ldsm_bytes(mem, np.arange(32) * 16)
    assert sorted(got.ravel().tolist()) == mem.tolist()
    assert (got[:, 1, 0] == (8 + G) * 16 + 4 * T).all()


@pytest.mark.parametrize("d", [8, 16])
def test_tiles_in_shared_memory_are_permutations_read_without_bank_conflicts(d):
    # K rows of k_row_bytes, the V tile (swz<d>) and the V^T tile (swz<32> on
    # 64-byte rows): each a permutation of its bytes; the 8 rows of every
    # ldmatrix matrix the kernel reads fall in 8 distinct 16-byte bank groups
    # of 128 bytes
    vt = np.array([_swz(32, r, c) * 2 for r in range(d) for c in range(4)])
    assert sorted(vt.tolist()) == list(range(0, d * TILE, 16))
    v = np.array([_swz(d, r, c) for r in range(TILE) for c in range(d // 8)])
    assert sorted(v.tolist()) == list(range(0, TILE * d, 8))
    for jd in range(d // 8):
        addr = 2 * _swz(32, jd * 8 + R8, MAT)
        for m in range(4):
            assert len({(a // 16) % 8 for a in addr[8 * m:8 * m + 8]}) == 8
    for h in range(TILE // 32):
        addr = ((4 * h + MAT) * 8 + R8) * _k_row_bytes(d)
        for m in range(4):
            assert len({(a // 16) % 8 for a in addr[8 * m:8 * m + 8]}) == 8


def _ring_slots(ki, vk, n, d, full, n_pad):
    """What load_ring_tile puts into a slot for tile j: (K bytes, V tile),
    the K rows of k_row_bytes (keys past n zero, a d 8 row's pad zero), V as
    bf16 values in the swizzled [kTile][d] tile or the V^T slice's bytes in
    its swizzled rows. Also how often each byte or value was written."""

    def stage(j):
        kb = np.zeros(TILE * _k_row_bytes(d), np.int64)
        k_hits = np.zeros_like(kb)
        for i in range(TILE):
            key = j * TILE + i
            at = i * _k_row_bytes(d) + np.arange(d)
            if key < n:
                kb[at] = ki[key]
            k_hits[at] += 1
        if full:
            vt = np.zeros(d * TILE, np.int64)
            v_hits = np.zeros_like(vt)
            for r in range(d):
                for ch in range(4):
                    at = 2 * _swz(32, r, ch) + np.arange(16)
                    vt[at] = vk[r, j * TILE + ch * 16 + np.arange(16)]
                    v_hits[at] += 1
        else:
            vt = np.zeros(TILE * d, np.float32)
            v_hits = np.zeros(TILE * d, int)
            for r in range(TILE):
                for ch in range(d // 8):
                    at = _swz(d, r, ch) + np.arange(8)
                    if j * TILE + r < n:
                        vt[at] = vk[j * TILE + r, ch * 8:ch * 8 + 8]
                    v_hits[at] += 1
        return kb, vt, k_hits, v_hits

    return stage


def _model_int8(q, k, v, mode, plain_exp=False):
    """The int8 forward by flash_int8_ring's loop, fragment by fragment, on
    the kernel's inputs (``int8_kernel_inputs``: qi, ki, V as the kernel takes
    it, c, sv). ``plain_exp``: p (and alpha) as the plain version takes them,
    exp of the rounded f32 s c minus the running max, in place of ex2 of the
    FMA'd exponent; bf16 inputs round p ('int8_qk') and the output to bf16.
    Returns (O f32, stores of each output value); values stored nowhere stay
    NaN."""
    full = mode == "int8"
    b, n, d = q.shape
    bf16_in = q.dtype == torch.bfloat16
    qi, ki, vk, scale, v_scale = fa.int8_kernel_inputs(q, k, v, mode)
    qi, ki = qi.numpy().astype(np.int64), ki.numpy().astype(np.int64)
    vk = vk.numpy().astype(np.int64) if full else vk.float().numpy()
    scale = scale.numpy()
    n_pad = vk.shape[2] if full else n
    blk = _block(d)
    tiles = -(-n // TILE)
    rows_c, cols_c = C_CELLS
    o = np.full((b, n, d), np.nan, np.float32)
    stores = np.zeros((b, n, d), int)

    def expf(x):
        return torch.exp(torch.tensor(x, dtype=torch.float32)).numpy()

    for bi in range(b):
        c = np.float32(scale[bi])
        cl2 = np.float32(c * LOG2E)
        stage = _ring_slots(ki[bi], vk[bi], n, d, full, n_pad)
        for blk_i in range(-(-n // blk["rows"])):
            ring, ring_tile = [None] * STAGES, [-1] * STAGES

            def put(j):
                kb, vt, k_hits, v_hits = stage(j)
                assert (k_hits <= 1).all() and (v_hits == 1).all()
                ring[j % STAGES], ring_tile[j % STAGES] = (kb, vt), j

            for j in range(min(AHEAD, tiles)):
                put(j)
            warps = []
            for w in range(blk["warps"]):
                for mt in range(blk["row_tiles"]):
                    r0 = blk_i * blk["rows"] + (w * blk["row_tiles"] + mt) * 16
                    qa = np.zeros((32, 2, 4), np.int64)
                    for reg, row in enumerate((r0 + G, r0 + 8 + G)):
                        for i in range(4):
                            col = 4 * T + i
                            ok = (row < n) & (col < d)
                            qa[:, reg, i] = np.where(ok, qi[bi, np.minimum(row, n - 1),
                                                            np.minimum(col, d - 1)], 0)
                    warps.append({"r0": r0, "qa": qa, "m": np.full((32, 2), -np.inf, np.float32),
                                  "l": np.zeros((32, 2), np.float32),
                                  "acc": np.zeros((d // 8, 32, 4), np.float32),
                                  "acc_i": np.zeros((d // 8, 32, 4), np.int64),
                                  "l_i": np.zeros((32, 2), np.int64)})
            for j in range(tiles):
                if j + AHEAD < tiles:
                    put(j + AHEAD)
                assert ring_tile[j % STAGES] == j  # not yet overwritten
                kb_mem, vt_mem = ring[j % STAGES]
                # K's B fragments: matrix i of ldmatrix h holds score tile 4h + i
                kfrag = np.concatenate([_ldsm_bytes(kb_mem, ((4 * h + MAT) * 8 + R8) * _k_row_bytes(d))
                                        for h in range(TILE // 32)], axis=1)  # (32, 8, 4)
                mask = n % TILE != 0 and j == tiles - 1
                for wt in warps:
                    s = np.stack([_mma_s8(np.full((32, 4), MAGIC, np.int64), wt["qa"],
                                          kfrag[:, [nt]]) for nt in range(TILE // 8)], 1)
                    key = j * TILE + np.arange(TILE // 8)[None, :, None] * 8 + cols_c[:, None, :]
                    assert (np.abs(s - MAGIC) < 2 ** 22).all()
                    if mask:
                        s = np.where(key >= n, np.int64(-2 ** 31), s)
                    # tile_max: the int max of each row, then c times its float
                    top = np.stack([s[:, :, 0:2].max(axis=(1, 2)), s[:, :, 2:4].max(axis=(1, 2))], 1)
                    top = top.reshape(8, 4, 2).max(axis=1).repeat(4, axis=0)  # the quad's max
                    topf = (top.astype(np.uint32).view(np.float32) - MAGIC_F).astype(np.float32)
                    assert (topf == top - MAGIC).all()  # the magic conversion is exact
                    mx = np.maximum(wt["m"], (c * topf).astype(np.float32))
                    with np.errstate(invalid="ignore"):
                        if plain_exp:
                            alpha = expf(wt["m"] - mx)
                        else:
                            alpha = np.exp2(((wt["m"] - mx) * LOG2E).astype(np.float32))
                    wt["m"] = mx
                    mb = (mx * LOG2E).astype(np.float32)
                    sf = (np.where(s < 0, 0, s).astype(np.uint32).view(np.float32) - MAGIC_F).astype(
                        np.float32)
                    row_of = np.array([0, 0, 1, 1])
                    lane_m = wt["m"][:, row_of][:, None, :]
                    if plain_exp:
                        p = expf((sf * c).astype(np.float32) - lane_m)
                        p = np.where(s < 0, np.float32(0), p)
                        if full:
                            p = (p * np.float32(127)).astype(np.float32)
                    else:
                        off = mb[:, row_of][:, None, :]
                        if full:
                            off = (off - LOG2_127).astype(np.float32)
                        x = (sf.astype(np.float64) * cl2 - off).astype(np.float32)
                        p = np.exp2(np.where(s < 0, -np.inf, x)).astype(np.float32)
                    if full:
                        bits = ((p + MAGIC_F).astype(np.float32)).view(np.uint32)
                        pq = (bits & 0xFF).astype(np.int64)
                        assert (bits >> 8 == MAGIC >> 8).all() and (pq <= 127).all()
                        # pa[kk][0..3]: tiles 4kk, 4kk + 1 (rows g, g + 8), then 4kk + 2, 4kk + 3
                        pa = [np.stack([np.concatenate([pq[:, 4 * kk + 2 * half, 2 * h:2 * h + 2],
                                                        pq[:, 4 * kk + 2 * half + 1, 2 * h:2 * h + 2]],
                                                       1) for half in range(2) for h in range(2)], 1)
                              for kk in range(TILE // 32)]
                        if np.any(alpha != 1) or j % FLUSH_TILES == FLUSH_TILES - 1:
                            _flush(wt, alpha)
                        sums = np.zeros((32, 4), np.int64)
                        for kk in range(TILE // 32):
                            sums = _mma_s8(sums, pa[kk], np.ones((32, 2, 4), np.int64))
                        assert (sums[:, 0] == sums[:, 1]).all()
                        wt["l_i"] += sums[:, [0, 2]]
                        for jd in range(d // 8):
                            vb = _ldsm_bytes(vt_mem, 2 * _swz(32, jd * 8 + R8, MAT))
                            for kk in range(TILE // 32):
                                wt["acc_i"][jd] = _mma_s8(wt["acc_i"][jd], pa[kk], vb[:, 2 * kk:2 * kk + 2])
                    else:
                        if bf16_in:
                            p = _bf16(p)
                        pa = [np.stack([p[:, 2 * kk, 0:2], p[:, 2 * kk, 2:4], p[:, 2 * kk + 1, 0:2],
                                        p[:, 2 * kk + 1, 2:4]], 1) for kk in range(TILE // 16)]
                        sums = np.zeros((32, 4), np.float32)
                        for kk in range(TILE // 16):  # the tensor core's row sums, in f32
                            sums = _mma_bf(sums, pa[kk], np.ones((32, 2, 2), np.float32))
                        wt["l"] = ((wt["l"] * alpha).astype(np.float32) + sums[:, [0, 2]]).astype(
                            np.float32)
                        if np.any(alpha != 1):
                            wt["acc"] = (wt["acc"] * alpha[None, :, row_of]).astype(np.float32)
                        for jd in range(d // 8):
                            wt["acc"][jd] = _pv_bf16(wt["acc"][jd], pa, vt_mem, d, jd)
            for wt in warps:
                if full:
                    _flush(wt, np.ones((32, 2), np.float32))
                lane_l = wt["l"][:, [0, 0, 1, 1]]
                for jd in range(d // 8):
                    y = (wt["acc"][jd] / lane_l).astype(np.float32)
                    if bf16_in:
                        y = _bf16(y)
                    if full:
                        y = (y * np.float32(v_scale[bi])).astype(np.float32)
                        if bf16_in:
                            y = _bf16(y)
                    r, col = wt["r0"] + rows_c, jd * 8 + cols_c
                    ok = r < n
                    o[bi, r[ok], col[ok]] = y[ok]
                    np.add.at(stores, (bi, r[ok], col[ok]), 1)
    return o, stores


def _flush(wt, alpha):
    """flush: acc = (acc + acc_i) alpha, l = (l + 127 l_i) alpha, in f32;
    the int32 sums restart at 0."""
    row_of = np.array([0, 0, 1, 1])
    assert (np.abs(wt["acc_i"]) < 2 ** 31).all() and (wt["l_i"] < 2 ** 32).all()
    wt["acc"] = ((wt["acc"] + wt["acc_i"].astype(np.float32)).astype(np.float32)
                 * alpha[None, :, row_of]).astype(np.float32)
    li = (np.float32(127) * wt["l_i"].astype(np.float32)).astype(np.float32)
    wt["l"] = ((wt["l"] + li).astype(np.float32) * alpha).astype(np.float32)
    wt["acc_i"][:] = 0
    wt["l_i"][:] = 0


def _pv_bf16(acc, pa, vt_mem, d, jd):
    """pv_mma's products for output columns 8 jd..8 jd + 7: V's B fragments
    by ldmatrix.trans from the swizzled bf16 tile."""
    if d == 16:
        for kk in range(TILE // 16):
            r = _ldsm_b16(vt_mem, _swz(d, kk * 16 + (MAT & 1) * 8 + R8, MAT >> 1), True)
            acc = _mma_bf(acc, pa[kk], r[:, [2 * jd, 2 * jd + 1]])
        return acc
    for kk in range(0, TILE // 16, 2):
        r = _ldsm_b16(vt_mem, _swz(d, kk * 16 + MAT * 8 + R8, 0), True)
        acc = _mma_bf(acc, pa[kk], r[:, [0, 1]])
        acc = _mma_bf(acc, pa[kk + 1], r[:, [2, 3]])
    return acc


def _jax_int8(q, k, v, mode, dtype):
    """The Pallas int8 forward in interpret mode at ``dtype``, key tile 64
    (the kernels' KERNEL_TILE), as f32 numpy."""
    qj, kj, vj = (jnp.asarray(x, dtype=dtype) for x in (q, k, v))
    out = _flash_forward_int8(qj, kj, vj, mode=mode, block_q=128, block_k=TILE, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _inputs(b, n, d, bf16=False):
    q, k, v = (RNG.normal(0, 1, (b, n, d)).astype(np.float32) for _ in range(3))
    return tuple(_bf16(x) if bf16 else x for x in (q, k, v))


# N 64: one whole tile; 131: a ragged third tile, 3 keys, a second row
# block; 200: a ragged fourth tile; 325: ragged over six tiles and three row
# blocks; 77: odd N, so that odd batches' K start 8-byte aligned at d 8
SHAPES = [(1, 64, 8), (1, 64, 16), (2, 131, 8), (2, 131, 16), (1, 200, 8), (1, 200, 16),
          (1, 325, 8), (1, 325, 16), (3, 77, 8), (3, 77, 16)]


@pytest.mark.parametrize("mode", fa.INT8_MODES)
@pytest.mark.parametrize("b,n,d", SHAPES)
def test_model_matches_the_pallas_int8_forward_at_bf16(mode, b, n, d):
    # the kernel's arithmetic (ex2 of the FMA'd exponent, bf16 p in int8_qk,
    # bf16 outputs) on the card's bf16 inputs against the Pallas kernel on
    # the same inputs, at phase 5's gate, and the plain version (the card's
    # oracle) beside it
    q, k, v = _inputs(b, n, d, bf16=True)
    want = _jax_int8(q, k, v, mode, jnp.bfloat16)
    t = [torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)]
    got, stores = _model_int8(*t, mode)
    assert (stores == 1).all() and np.isfinite(got).all()
    plain = fa.flash_attention_int8_plain(*t, mode).float().numpy()
    for x in (got, plain):
        np.testing.assert_allclose(x, want, atol=chip_smoke.FLASH_ATOL, rtol=chip_smoke.FLASH_RTOL)


@pytest.mark.parametrize("mode", fa.INT8_MODES)
@pytest.mark.parametrize("b,n,d", SHAPES)
def test_model_matches_the_pallas_int8_forward_at_f32_with_the_plain_exp(mode, b, n, d):
    # the same loop with f32 inputs and p taken as the plain version takes
    # it (the JAX tests' bounds): the fragments, ring, mask, magic
    # conversion, PV key order and flushes are all the kernel's
    q, k, v = _inputs(b, n, d)
    want = _jax_int8(q, k, v, mode, jnp.float32)
    got, stores = _model_int8(*(torch.tensor(x) for x in (q, k, v)), mode, plain_exp=True)
    assert (stores == 1).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
