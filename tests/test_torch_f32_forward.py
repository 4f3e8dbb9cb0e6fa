"""The f32 forward (B1 and B1-lse at f32): its launch plan against the CUDA
source's constants, its routing on the kernel path, its plain version
against the JAX package's Pallas kernel at f32, and a model of the d 8 and 16
kernel's thread map (``flash_fwd_f32_small``) against the same.

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
    # depths 18 and 34: the same stages at head dims 8 and 16
    (8, 19200, 8): 2400,
    (8, 4800, 16): 600,
    (8, 5655, 8): 712,
    (2, 19200, 8): 600,
    (2, 4800, 16): 150,
    (4, 5655, 8): 356,
}


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _rule(name: str) -> dict:
    """{head dim: value} of the source's ``constexpr int name<D>()`` for d 8
    and 16: its body is ``D == 8 ? a : b``."""
    body = re.search(rf"constexpr int {name}\(\) \{{\s*return ([^;]+);", SOURCE).group(1)
    a, b = re.fullmatch(r"D == 8 \? (\d+) : (\d+)", body).groups()
    return {8: int(a), 16: int(b)}


@pytest.mark.parametrize("shape", sorted(PATH_BLOCKS))
def test_launch_plan_at_the_path_shapes(shape):
    # each launch of the paths takes a register-blocked kernel of 64-row
    # blocks, and gives more blocks than the H100 has SMs
    plan = fa.f32_launch_plan(*shape)
    small = shape[2] in (8, 16)
    assert plan["kernel"] == ("flash_fwd_f32_small" if small else "flash_fwd_f32_tiled")
    assert plan["bm"] == 64
    assert plan["key_tile"] == {**fa.F32_SMALL_KEYS, 32: 64, 64: 32}[shape[2]]
    assert plan["blocks"] == PATH_BLOCKS[shape] >= H100_SMS


@pytest.mark.parametrize("d", [8, 16])
def test_launch_plan_takes_the_small_kernel_at_d_8_and_16(d):
    assert fa.f32_launch_plan(2, 5655, d) == {"kernel": "flash_fwd_f32_small", "bm": 64,
                                              "key_tile": _rule("small_keys")[d], "blocks": 2 * 89}


@pytest.mark.parametrize("n", [1, 64, 65, 5655])
def test_launch_plan_rounds_ragged_rows_up_to_a_block(n):
    assert fa.f32_launch_plan(3, n, 32)["blocks"] == 3 * -(-n // 64)


def test_launch_plan_constants_match_the_source():
    # the rows a block owns, the threads and the key tile of each head dim,
    # as the CUDA source has them (it is compiled only on the card)
    assert _constant("kTiledRows") == _constant("kSmallRows") == fa.F32_TILED_ROWS
    assert _rule("small_keys") == fa.F32_SMALL_KEYS
    rule = re.search(r"constexpr int tiled_keys\(\) \{\s*return ([^;]+);", SOURCE).group(1)
    assert rule == "D == 32 ? 64 : 32"
    assert {d: 64 if d == 32 else 32 for d in (32, 64)} == fa.F32_TILED_KEYS
    # 16 row groups of 8 lanes a block: 4 rows a thread, keys kg + 8 j
    assert _constant("kTiledThreads") // _constant("kKeyGroups") * 4 == fa.F32_TILED_ROWS
    assert _constant("kSmallThreads") == _constant("kTiledThreads")


@pytest.mark.parametrize("d", [8, 16])
def test_small_kernel_fits_its_blocks_an_sm(d):
    # two slots of K and V tiles of padded rows in shared memory, and the
    # registers __launch_bounds__ leaves at that many blocks an SM
    keys, blocks = _rule("small_keys")[d], _rule("small_blocks_per_sm")[d]
    assert keys % 8 == 0 and keys * d // 4 % _constant("kSmallThreads") == 0
    assert blocks * (4 * 2 * 2 * keys * (d + 4) + 1024) <= 228 * 1024
    assert 65536 // (blocks * _constant("kSmallThreads")) >= 128
    assert "__launch_bounds__(kSmallThreads, small_blocks_per_sm<D>())" in SOURCE


def test_source_dispatch_matches_the_plan_and_phase_1_instances():
    # the C entry point launches the small kernel at d 8 and 16 and the tiled
    # kernel at d 32 and 64: the instances phase 1 of chip_smoke.py requires,
    # once each
    entry = SOURCE[SOURCE.index('extern "C" int frn_flash_fwd_f32'):]
    small = {int(d) for d in re.findall(r"case (\d+): return launch_small<\1>", entry)}
    tiled = {int(d) for d in re.findall(r"case (\d+): return launch_tiled<\1>", entry)}
    assert small == set(fa.F32_SMALL_KEYS) == {8, 16}
    assert tiled == set(fa.F32_TILED_KEYS) == {32, 64}
    assert {fa.f32_launch_plan(1, 1, d)["kernel"] for d in small} == {"flash_fwd_f32_small"}
    assert {fa.f32_launch_plan(1, 1, d)["kernel"] for d in tiled} == {"flash_fwd_f32_tiled"}
    want = [("flash_fwd_f32_small", d) for d in sorted(small)]
    want += [("flash_fwd_f32_tiled", d) for d in sorted(tiled)]
    assert sorted(chip_smoke.PATH_INSTANCES["flash_attention_f32"]) == sorted(want)


@pytest.mark.parametrize("name,want", [
    ("_ZN12_GLOBAL__N_119flash_fwd_f32_tiledILi32EEEvPKfS2_S2_PfS3_i",
     ("flash_fwd_f32_tiled", 32)),
    ("_ZN12_GLOBAL__N_119flash_fwd_f32_tiledILi64EEEvPKfS2_S2_PfS3_i",
     ("flash_fwd_f32_tiled", 64)),
    ("_ZN12_GLOBAL__N_113flash_fwd_f32ILi16EEEvPKfS2_S2_PfS3_i", ("flash_fwd_f32", 16)),
    ("_ZN12_GLOBAL__N_119flash_fwd_f32_smallILi8EEEvPKfS2_S2_PfS3_i", ("flash_fwd_f32_small", 8)),
    ("_ZN12_GLOBAL__N_119flash_fwd_f32_smallILi16EEEvPKfS2_S2_PfS3_i",
     ("flash_fwd_f32_small", 16)),
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


# ------------------------------------------------------------ the d 8 and 16 kernel's thread map


def _small_map(d: int):
    """The small kernel's map, as ``flash_fwd_f32_small`` computes it from
    threadIdx.x: (rows of the block, keys of a tile) of each thread, (128,
    4) and (128, BN / 8), and each thread's row group and key group."""
    threads, groups = _constant("kSmallThreads"), _constant("kKeyGroups")
    bm, bn = _constant("kSmallRows"), _rule("small_keys")[d]
    t = np.arange(threads)
    kg, rg = t % groups, t // groups
    r = threads // groups
    rows = rg[:, None] + r * np.arange(bm // r)[None, :]
    keys = kg[:, None] + groups * np.arange(bn // groups)[None, :]
    return rows, keys, rg, kg


@pytest.mark.parametrize("d", [8, 16])
def test_small_thread_map_covers_each_score_of_a_tile_once(d):
    # every (row, key) cell of a 64-row block and a key tile belongs to one
    # thread; the 8 lanes of a row group (whose max, l and O are combined
    # by __shfl_xor_sync over offsets 1, 2, 4) are 8 neighbouring lanes of
    # one warp, and hold the same rows
    rows, keys, rg, kg = _small_map(d)
    cells = np.zeros((_constant("kSmallRows"), _rule("small_keys")[d]), int)
    for t in range(len(rows)):
        cells[np.ix_(rows[t], keys[t])] += 1
    assert (cells == 1).all()
    lanes = np.arange(len(rows))
    for off in (1, 2, 4):
        partner = lanes ^ off
        assert (partner // 32 == lanes // 32).all() and (rg[partner] == rg).all()
        assert (rows[partner] == rows).all()
    assert sorted(set(kg)) == list(range(8))


@pytest.mark.parametrize("d", [8, 16])
def test_small_kernel_warp_reads_distinct_banks(d):
    # a warp's float4 reads of K or V (4 row groups x 8 key groups) touch 8
    # distinct padded rows at once; with a row stride of d + 4 floats their
    # 16-byte words fall on 8 disjoint groups of 4 banks
    stride = d + 4
    for j in range(_rule("small_keys")[d] // 8):
        starts = {((kg + 8 * j) * stride) % 32 for kg in range(8)}
        banks = {(s + w) % 32 for s in starts for w in range(4)}
        assert len(starts) == 8 and len(banks) == 32


def _model_small(q, k, v, d):
    """``flash_fwd_f32_small``'s computation in numpy f32, tile by tile:
    each thread's scores of its 4 rows and BN / 8 keys, the row group's max
    over its 8 lanes, each lane's partial l and O over its own keys rescaled
    by the shared alpha, keys past N masked on the last tile, the lanes'
    partials summed at the end; rows past N stored nowhere."""
    b, n, _ = q.shape
    rows, keys, rg, kg = _small_map(d)
    bm, bn = _constant("kSmallRows"), _rule("small_keys")[d]
    log2e = np.float32(1.4426950408889634)
    o, lse = np.full(q.shape, np.nan, np.float32), np.full((b, n), np.nan, np.float32)
    for bi in range(b):
        kpad = np.zeros((-(-n // bn) * bn, d), np.float32)
        vpad = kpad.copy()
        kpad[:n], vpad[:n] = k[bi], v[bi]
        for row0 in range(0, n, bm):
            r = row0 + rows  # (threads, 4)
            qr = np.where((r < n)[..., None], q[bi, np.minimum(r, n - 1)], 0).astype(np.float32)
            m = np.full(r.shape, -np.inf, np.float32)
            l = np.zeros(r.shape, np.float32)
            acc = np.zeros(r.shape + (d,), np.float32)
            for key0 in range(0, n, bn):
                kt, vt = kpad[key0 + keys], vpad[key0 + keys]  # (threads, TN, d)
                s = np.einsum("tid,tjd->tij", qr, kt).astype(np.float32)
                s = np.where((key0 + keys < n)[:, None, :], s, -np.inf)
                mx = np.maximum(m, s.max(axis=2))
                for t in range(len(r)):  # the row group's 8 lanes share the max
                    mx[t] = np.max(mx[rg == rg[t]], axis=0)
                alpha = np.exp2((m - mx) * log2e).astype(np.float32)
                p = np.exp2(s * log2e - (mx * log2e)[..., None]).astype(np.float32)
                m = mx
                l = l * alpha + p.sum(axis=2)
                acc = acc * alpha[..., None] + np.einsum("tij,tjd->tid", p, vt)
            for group in range(rg.max() + 1):
                lanes = rg == group
                lt, at = l[lanes].sum(axis=0), acc[lanes].sum(axis=0)
                rr = r[lanes][0]
                live = rr < n
                o[bi, rr[live]] = (at / lt[:, None])[live]
                lse[bi, rr[live]] = (m[lanes][0] + np.log(lt))[live]
    return o, lse


@pytest.mark.parametrize("b,n,d", [(2, 131, 8), (1, 200, 16), (2, 40, 8), (1, 517, 16)])
def test_small_thread_map_model_matches_the_pallas_kernel_at_f32(b, n, d):
    # ragged N (a partial last key tile and a partly idle last block), a
    # block with no second key tile, and several tiles at each head dim
    q, k, v = (RNG.normal(0, 1, (b, n, d)).astype(np.float32) for _ in range(3))
    want_o, want_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                                      block_k=128, interpret=True, return_lse=True)
    got_o, got_lse = _model_small(q, k, v, d)
    np.testing.assert_allclose(got_o, np.asarray(want_o), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got_lse, np.asarray(want_lse).reshape(b, n), atol=1e-4, rtol=0)


# ------------------------------------------------------------ the A/B of chip_smoke.py


def _plain_forward_revision():
    """Another revision's f32 forward entry point, standing in on the CPU:
    the plain version, written through the pointers the entry point gets."""
    import ctypes

    def as_tensor(ptr, shape):
        return torch.from_numpy(np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), shape=shape))

    def fwd(q, k, v, o, lse, b, n, d):
        o_ref, lse_ref = fa.flash_attention_plain(*(as_tensor(p, (b, n, d)) for p in (q, k, v)),
                                                  return_lse=True)
        as_tensor(o, (b, n, d)).copy_(o_ref)
        if lse is not None:
            as_tensor(lse, (b, n)).copy_(lse_ref)

    return types.SimpleNamespace(frn_flash_fwd_f32=fwd)


def test_phase_other_f32_forward_runs_every_launch_in_turns(monkeypatch, capsys):
    # the phase on the CPU at tiny shapes: this revision's wrapper (its plain
    # version here) and another revision's entry point in turns at every
    # launch of the f32 paths, depth 50's and depth 18's, each row with this
    # revision's block count, summed per batch or micro-step
    _gen, _randn = torch.Generator, torch.randn
    monkeypatch.setattr(torch, "Generator", lambda device=None: _gen())
    monkeypatch.setattr(torch, "randn", lambda *a, device=None, **k: _randn(*a, **k))
    monkeypatch.setattr(fa, "_launch", lambda fn, q, *args: fn(*args))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps, warmup=2, windows=1: (1.0, fn()))
    monkeypatch.setattr(chip_smoke, "FLASH_SHAPES", ((131, 32), (70, 64)))
    monkeypatch.setattr(chip_smoke, "DDD17_FLASH_SHAPE", (77, 32))
    monkeypatch.setattr(chip_smoke, "DEPTH18_FLASH_SHAPES", ((131, 8), (70, 16)))
    monkeypatch.setattr(chip_smoke, "DEPTH18_DDD17_SHAPE", (77, 8))
    chip_smoke.phase_other_f32_forward({"parent/flash_attention_f32.cu": _plain_forward_revision()})
    out = capsys.readouterr().out
    rows = [row for row in out.splitlines() if row.startswith("revisions timing")]
    kinds = [re.search(r'"kind": "([^"]+)"', r).group(1) for r in rows]
    assert kinds == [f"{kind}{depth}{stage}" for depth in ("", " R18")
                     for kind, stage in (("flash_fwd_f32", ""), ("flash_fwd_f32", ""),
                                         ("flash_fwd_f32", " DDD17"), ("flash_fwd_lse_f32", ""),
                                         ("flash_fwd_lse_f32", ""),
                                         ("flash_fwd_lse_f32", " DDD17"))]
    assert '"N": 131, "d": 8, "blocks": 24' in rows[6]  # 8 x 131 rows in 64-row blocks
    assert "flash_fwd_lse_f32 R18 parent/flash_attention_f32.cu: 4.000 ms per micro-step " \
           "(4 launches)" in out
    assert "flash_fwd_f32 R18 DDD17 this revision: 2.000 ms per batch (2 launches)" in out
    assert " 0 outside " in out and " outside " not in out.replace(" 0 outside ", "")
