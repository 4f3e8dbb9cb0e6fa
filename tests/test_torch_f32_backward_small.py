"""The f32 dK/dV kernel at head dims 8 and 16 (B2b at f32,
``flash_bwd_dkv_f32_small`` in ``csrc/flash_attention_bwd_f32.cu``): its
block against the CUDA source's constants, the dispatch and phase 1's
instances, its thread map, the banks of a warp's shared reads, and a numpy
model of its loop, lane by lane, against the JAX package's Pallas backward at
f32.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
``flash_bwd_dkv_plain``. The model follows the source: the two-slot ring of
64-query tiles (which slot each tile lands in and when, rows and statistics
past N zero-filled), each thread's key rows and queries, each lane's partial
dK and dV over its own queries in the kernel's order, the exponent as one
FFMA into ``ex2``, the select on the ragged last tile, the xor-shuffle
butterfly over the row group's 8 lanes, and the lanes' split of the stores.
Bounds of the JAX comparison: atol 2e-4 of each output's max |value|, rtol
1e-3 (the f32 models' of the bf16 d 8/16 kernels).
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import chip_smoke
from frn_tpu.ops.flash_attention import _flash_backward, _flash_forward
from frn_tpu_torch import build
from frn_tpu_torch.ops import flash_attention as fa

RNG = np.random.default_rng(43)
SOURCE = (build.CSRC / "flash_attention_bwd_f32.cu").read_text()
LOG2E = np.float32(1.4426950408889634)
ATOL, RTOL = 2e-4, 1e-3


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _rule(name: str) -> dict:
    """{head dim: value} of the source's ``constexpr int name<D>()`` for d 8
    and 16: its body is a constant or ``D == 8 ? a : b``."""
    body = re.search(rf"constexpr int {name}\(\) \{{\s*return ([^;]+);", SOURCE).group(1)
    m = re.fullmatch(r"D == 8 \? (\d+) : (\d+)", body)
    return {8: int(m.group(1)), 16: int(m.group(2))} if m else {8: int(body), 16: int(body)}


def _block(d: int) -> dict:
    """The kernel's block at head dim d, from the source: BK key rows, TM a
    thread, 64-query tiles, TN queries of a tile a thread."""
    threads, groups = _constant("kThreadsBwd"), _constant("kQueryGroups")
    bk, bq = _rule("dkv_small_rows")[d], _constant("kTileBwd")
    r = threads // groups
    return {"threads": threads, "groups": groups, "r": r, "bk": bk, "tm": bk // r, "bq": bq,
            "tn": bq // groups, "blocks_per_sm": _constant("kDkvBlocksPerSM")}


# ------------------------------------------------------------ the block and the dispatch


def test_block_constants_match_the_plan_and_the_source():
    # BK and TM by head dim (64 and 4 at d 8, 32 and 2 at d 16), 128 threads
    # in row groups of 8 lanes, 64-query tiles, as the CUDA source has them
    # (it is compiled only on the card) and the launch plan reads them
    assert {d: _block(d)["bk"] for d in (8, 16)} == fa.F32_BWD_SMALL_KEY_ROWS == {8: 64, 16: 32}
    assert {d: _block(d)["tm"] for d in (8, 16)} == {8: 4, 16: 2}
    assert _constant("kThreadsBwd") == 128 and _constant("kQueryGroups") == 8
    assert _constant("kTileBwd") == fa.KERNEL_TILE == 64
    assert {d: _block(d)["tn"] for d in (8, 16)} == {8: 8, 16: 8}


@pytest.mark.parametrize("d", [8, 16])
def test_blocks_fit_an_sm(d):
    # two ring slots of a Q and a dO tile (rows padded by 16 bytes) and their
    # lse and D, 1 KB reserved a block, within the H100's 228 KB; the 64 K
    # registers of an SM leave each thread its k, v, dK and dV rows (4 TM d
    # floats, 128) and at least 32 more
    s = _block(d)
    smem = 4 * 2 * (2 * s["bq"] * (d + 4) + 2 * s["bq"])
    assert smem == {8: 13312, 16: 21504}[d]
    assert s["blocks_per_sm"] * (smem + 1024) <= 228 * 1024
    state = 4 * s["tm"] * d
    assert state == 128 and 65536 // (s["blocks_per_sm"] * s["threads"]) >= state + 32
    # whole 16-byte chunks of a tile for the stager's threads, a thread for
    # each lse and each D of a tile (load_stats)
    assert (s["bq"] * d // 4) % s["threads"] == 0 and s["threads"] == 2 * s["bq"]


def test_the_kernel_bounds_its_launch_by_its_blocks_an_sm():
    assert re.search(r"__launch_bounds__\(kThreadsBwd, kDkvBlocksPerSM\)\s*"
                     r"flash_bwd_dkv_f32_small", SOURCE)
    assert re.search(r"allow_smem\(flash_bwd_dkv_f32_small<D>, T::kBytes", SOURCE)


def _entry(name: str) -> str:
    start = SOURCE.index(f'extern "C" int {name}')
    end = SOURCE.find('extern "C"', start + 1)
    return SOURCE[start:end if end > 0 else None]


def test_dispatch_takes_the_small_kernel_at_d_8_and_16_and_phase_1_wants_it():
    entry = _entry("frn_flash_bwd_dkv_f32")
    assert {int(d) for d in re.findall(r"case (\d+): return launch_dkv_small<\1>", entry)} == {
        8, 16}
    assert {int(d) for d in re.findall(r"case (\d+): return launch_dkv_tiled<\1>", entry)} == {
        32, 64}
    for d in (8, 16):
        plan = fa.f32_bwd_launch_plan(2, 19200, d, "dkv")
        assert plan["kernel"] == "flash_bwd_dkv_f32_small" and plan["tile"] == _block(d)["bq"]
        assert ("flash_bwd_dkv_f32_small", d) in chip_smoke.PATH_INSTANCES["flash_attention_bwd_f32"]
        assert ("flash_bwd_dkv_f32", d) not in chip_smoke.PATH_INSTANCES["flash_attention_bwd_f32"]
    # the first design is gone with what only it used, and so is the dQ
    # kernel's first design with its helpers (test_torch_f32_dq_small.py);
    # the small kernels share axpy4, and this one takes over load_stats
    for gone in (r"flash_bwd_dkv_f32[<(]", r"dkv_tile<", r"dkv_slot_floats", r"launch_dkv<",
                 r"load_row<D>", r"store_row<D>", r"tile_chunk<D>", r"dot4\(", r"kGroup\b"):
        assert not re.search(rf"\b{gone}", SOURCE)
    assert "axpy4(" in SOURCE
    assert SOURCE.count("load_stats(") == 2  # its definition and the small kernel's call


@pytest.mark.parametrize("d", [8, 16])
def test_the_launch_plan_blocks_at_the_path_shapes(d):
    # the depth-18 f32 train path's launches of the small kernel: 600 blocks
    # at stage 1 (2, 19,200, 8), 300 at stage 2 (2, 4,800, 16), 356 at DDD17
    # (4, 5,655, 8)
    shapes = {8: [((2, 19200, 8), 600), ((4, 5655, 8), 356)], 16: [((2, 4800, 16), 300)]}[d]
    for shape, blocks in shapes:
        assert fa.f32_bwd_launch_plan(*shape, "dkv") == {
            "kernel": "flash_bwd_dkv_f32_small", "rows": _block(d)["bk"], "tile": 64,
            "blocks": blocks}
    bk = _block(d)["bk"]
    for n in (1, bk, bk + 1, 2 * bk + 1):
        assert fa.f32_bwd_launch_plan(3, n, d, "dkv")["blocks"] == 3 * -(-n // bk)


_MANGLED = {
    "flash_bwd_dq_f32_small": "_ZN12_GLOBAL__N_122flash_bwd_dq_f32_smallILi{}EEEvPKfS2_S2_S2_S2_S2_Pfi",
    "flash_bwd_dq_f32_tiled": "_ZN12_GLOBAL__N_122flash_bwd_dq_f32_tiledILi{}EEEvPKfS2_S2_S2_S2_S2_Pfi",
    "flash_bwd_dkv_f32_small":
        "_ZN12_GLOBAL__N_123flash_bwd_dkv_f32_smallILi{}EEEvPKfS2_S2_S2_S2_S2_PfS3_i",
    "flash_bwd_dkv_f32_tiled":
        "_ZN12_GLOBAL__N_123flash_bwd_dkv_f32_tiledILi{}EEEvPKfS2_S2_S2_S2_S2_PfS3_i"}


def _ptxas_log(instances: dict) -> str:
    return "".join(
        f"ptxas info    : Compiling entry function '{_MANGLED[kernel].format(d)}' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers\n"
        for (kernel, d), (regs, spill) in instances.items())


@pytest.mark.parametrize("d", [8, 16])
def test_phase_1_reads_the_small_instance_and_refuses_a_spill_or_a_gap(capsys, d):
    every = {key: (160, 0) for key in chip_smoke.PATH_INSTANCES["flash_attention_bwd_f32"]}
    assert chip_smoke.kernel_instances(_ptxas_log(every))[("flash_bwd_dkv_f32_small", d)] == (
        160, 0, 0)
    chip_smoke.check_path_instances("flash_attention_bwd_f32", _ptxas_log(every))
    assert f"flash_bwd_dkv_f32_small<{d}>: 160 registers" in capsys.readouterr().out
    spilled = {**every, ("flash_bwd_dkv_f32_small", d): (168, 8)}
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention_bwd_f32", _ptxas_log(spilled))
    missing = {k: v for k, v in every.items() if k != ("flash_bwd_dkv_f32_small", d)}
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention_bwd_f32", _ptxas_log(missing))


# ------------------------------------------------------------ the thread map


def _small_map(d: int):
    """The kernel's map, as ``flash_bwd_dkv_f32_small`` computes it from
    threadIdx.x: (key rows of the block, queries of a tile) of each thread,
    (128, TM) and (128, TN), and each thread's row group and lane qg."""
    s = _block(d)
    t = np.arange(s["threads"])
    qg, rg = t % s["groups"], t // s["groups"]
    rows = rg[:, None] + s["r"] * np.arange(s["tm"])[None, :]
    queries = qg[:, None] + s["groups"] * np.arange(s["tn"])[None, :]
    return rows, queries, rg, qg


def _stores(d: int):
    """(thread, key row of the block, output, float4 column) of every store:
    float4 u of row i (dK's C first, then dV's) by lane (i 2C + u) % 8."""
    s = _block(d)
    rows, _, _, qg = _small_map(d)
    c = d // 4
    return [(t, rows[t, i], "dk" if u < c else "dv", u % c)
            for t in range(s["threads"]) for i in range(s["tm"]) for u in range(2 * c)
            if (i * 2 * c + u) % s["groups"] == qg[t]]


@pytest.mark.parametrize("d", [8, 16])
def test_thread_map_covers_each_pair_of_a_tile_once_and_sums_a_row_over_its_8_lanes(d):
    # every (key row, query) pair of a block and a query tile belongs to one
    # thread; the lanes that hold partial dK and dV of a key row are the 8 of
    # one row group, neighbours in one warp, and the xor butterfly (offsets
    # 1, 2, 4) pairs each lane only with lanes of the same rows, so that after
    # its three rounds every lane holds the sum over exactly those 8
    s = _block(d)
    rows, queries, rg, qg = _small_map(d)
    cells = np.zeros((s["bk"], s["bq"]), int)
    for t in range(s["threads"]):
        cells[np.ix_(rows[t], queries[t])] += 1
    assert (cells == 1).all()
    lanes = np.arange(s["threads"])
    reach = [{t} for t in lanes]
    for off in (1, 2, 4):
        partner = lanes ^ off
        assert (partner // 32 == lanes // 32).all() and (rows[partner] == rows).all()
        reach = [reach[t] | reach[partner[t]] for t in lanes]
    for r in range(s["bk"]):
        holders = {t for t in lanes if r in rows[t]}
        assert len(holders) == 8 and len({t // 32 for t in holders}) == 1
        assert all(reach[t] == holders for t in holders)
    # each float4 of a row's dK and dV is stored once, by a lane of its group
    stored = {}
    for t, row, out, col in _stores(d):
        assert row in rows[t]
        stored[row, out, col] = stored.get((row, out, col), 0) + 1
    assert stored == {(r, o, c): 1 for r in range(s["bk"]) for o in ("dk", "dv")
                      for c in range(d // 4)}


@pytest.mark.parametrize("d", [8, 16])
def test_warp_reads_of_a_query_tile_fall_on_distinct_banks(d):
    # at each step the 32 lanes of a warp (4 row groups x 8 lanes) read the
    # float4s of 8 distinct query rows of Q and dO (qg + 8 j); with rows
    # padded to d + 4 floats their 16-byte words fall on 8 disjoint groups of
    # 4 banks (unpadded, rows 0 and 4 collide at d 8), and the 8 lanes' lse
    # and D are 8 neighbouring floats
    _, queries, _, _ = _small_map(d)
    for j in range(queries.shape[1]):
        cols = sorted(set(queries[:32, j]))
        assert len(cols) == 8
        for stride in (d + 4, d):
            starts = {(col * stride) % 32 for col in cols}
            banks = {(st + w) % 32 for st in starts for w in range(4)}
            assert (len(banks) == 32) == (stride == d + 4)
        assert {col % 32 for col in cols} == set(range(8 * j % 32, 8 * j % 32 + 8))


# ------------------------------------------------------------ the model of the loop


def _model_dkv_small(q, k, v, do, lse, delta, mask: bool = True, tail: float = 0.0):
    """dK and dV by ``flash_bwd_dkv_f32_small``'s loop in numpy f32, every
    thread of every block at once: k and v rows in registers (zeros past N),
    the two-slot ring of 64-query tiles (tile t + 1 staged into slot
    (t + 1) % 2 after the barrier of tile t, rows, lse and D past N
    zero-filled), each lane's queries qg + 8 j in order, s and dP summed over
    d in column order, P = 2^(s log2 e + (-lse log2 e)) set to 0 by a select
    for a query at or past N on the last, ragged tile (``mask``), dV += P dO,
    dS = P (dP - D), dK += dS q into the lane's partials; then the butterfly
    over the row group's lanes (xor 1, 2, 4) and each float4 stored by its
    lane, key rows past N nowhere. ``tail``: the value of the ring's Q and
    dO rows past N (the kernel zero-fills them). Returns (dK, dV, the count
    of stores of each value of dK and of dV; NaN left in an output shows a
    value stored nowhere)."""
    b, n, d = q.shape
    s = _block(d)
    bk, bq, tn, g = s["bk"], s["bq"], s["tn"], s["groups"]
    rows, queries, _, qg = _small_map(d)
    blocks, tiles = -(-n // bk), -(-n // bq)
    krow = np.arange(blocks)[:, None, None] * bk + rows[None]  # (blocks, threads, TM)
    live = krow < n
    lanes = np.arange(s["threads"])
    dk, dv = np.full(q.shape, np.nan, np.float32), np.full(q.shape, np.nan, np.float32)
    stores = np.zeros((2,) + q.shape, int)  # dK's, dV's
    zero = np.float32(0)
    for bi in range(b):
        kr = np.where(live[..., None], k[bi][np.minimum(krow, n - 1)], zero)
        vr = np.where(live[..., None], v[bi][np.minimum(krow, n - 1)], zero)
        dka, dva = np.zeros_like(kr), np.zeros_like(vr)
        ring = np.full((2, 2, bq, d), np.nan, np.float32)  # slot, (Q, dO), row, column
        stats = np.full((2, 2, bq), np.nan, np.float32)  # slot, (lse, D), row

        def stage(t):
            r = t * bq + np.arange(bq)
            ok = r < n
            rc = np.minimum(r, n - 1)
            ring[t % 2, 0] = np.where(ok[:, None], q[bi, rc], np.float32(tail))
            ring[t % 2, 1] = np.where(ok[:, None], do[bi, rc], np.float32(tail))
            stats[t % 2, 0] = np.where(ok, lse[bi, rc], zero)
            stats[t % 2, 1] = np.where(ok, delta[bi, rc], zero)

        stage(0)
        for t in range(tiles):
            slot = t % 2
            if t + 1 < tiles:
                stage(t + 1)
            valid = n - t * bq
            ragged = n % bq != 0 and t == tiles - 1
            qt, ot = ring[slot, 0], ring[slot, 1]
            lt, dt = stats[slot, 0], stats[slot, 1]
            for j in range(tn):
                col = queries[:, j]  # (threads,)
                qj, oj = qt[col][None, :, None, :], ot[col][None, :, None, :]
                sc = np.zeros(kr.shape[:3], np.float32)
                dp = np.zeros(kr.shape[:3], np.float32)
                for c in range(d):
                    sc = sc + kr[..., c] * qj[..., c]
                nlb = -(lt[col] * LOG2E)
                with np.errstate(over="ignore"):
                    p = np.exp2(sc * LOG2E + nlb[None, :, None]).astype(np.float32)
                if mask and ragged:
                    p = np.where((col >= valid)[None, :, None], zero, p)
                with np.errstate(invalid="ignore", over="ignore"):
                    dva = dva + p[..., None] * oj
                    for c in range(d):
                        dp = dp + vr[..., c] * oj[..., c]
                    ds = p * (dp - dt[col][None, :, None])
                    dka = dka + ds[..., None] * qj
        with np.errstate(over="ignore", invalid="ignore"):
            for off in (1, 2, 4):  # dka[i] += shfl_xor(dka[i], off)
                dka, dva = dka + dka[:, lanes ^ off], dva + dva[:, lanes ^ off]
        c4 = d // 4
        for th, row, out, col in _stores(d):
            i = list(rows[th]).index(row)
            acc, dst = (dka, dk) if out == "dk" else (dva, dv)
            r = krow[:, th, i]
            ok = r < n
            dst[bi, r[ok], 4 * col:4 * col + 4] = acc[ok, th, i, 4 * col:4 * col + 4]
            stores[int(out == "dv"), bi, r[ok], 4 * col:4 * col + 4] += 1
        assert c4 * 4 == d
    return dk, dv, stores


def _jax_dkv(q, k, v, do, block: int = 128):
    """(lse, D, dK, dV) of the JAX package's Pallas kernels at f32, in
    interpret mode, with blocks of ``block`` rows (N padded to a whole
    block)."""
    o, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block,
                            block_k=block, interpret=True, return_lse=True)
    _, dk, dv = _flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                                jnp.asarray(do), block_q=block, block_k=block, interpret=True)
    o, lse = np.asarray(o), np.asarray(lse).reshape(q.shape[:2])
    delta = (do * o).sum(axis=2, dtype=np.float32)
    return lse, delta, np.asarray(dk), np.asarray(dv)


def _inputs(b, n, d, shift=False):
    """Seeded q, k, v, dO; with ``shift``, scores near -121 (column 0 of q
    and k 11 and -11), so that every lse is below -88."""
    q, k, v, do = (RNG.normal(0, 0.5 if shift else 1.0, (b, n, d)).astype(np.float32)
                   for _ in range(4))
    if shift:
        q[..., 0], k[..., 0] = 11.0, -11.0
    return q, k, v, do


@pytest.mark.parametrize("b,n,d", [
    (1, 64, 8),  # one whole block and one whole query tile
    (2, 131, 8),  # a ragged third block and a ragged third tile
    (1, 200, 8),
    (1, 325, 8),  # 6 tiles through the ring, the last ragged
    (1, 65, 8),  # one key row past a whole block (BK 64) and a query past a tile
    (1, 129, 8),  # one key row past two whole blocks
    (1, 64, 16),  # two whole blocks (BK 32)
    (2, 131, 16),
    (1, 200, 16),
    (1, 325, 16),
    (1, 33, 16),  # one key row past a whole block
    (1, 65, 16),  # one key row past two whole blocks, a query past a whole tile
])
def test_model_matches_the_pallas_backward_at_f32(b, n, d):
    # the kernel's loop, lane by lane, ragged tails and select included,
    # against the JAX package's Pallas dK/dV at f32 (interpret mode), every
    # output value stored once; and the port's plain version, which the card
    # holds the kernel against, against the same
    q, k, v, do = _inputs(b, n, d)
    lse, delta, want_dk, want_dv = _jax_dkv(q, k, v, do)
    dk, dv, stores = _model_dkv_small(q, k, v, do, lse, delta)
    assert (stores == 1).all()
    plain = fa.flash_bwd_dkv_plain(*(torch.tensor(x) for x in (q, k, v, do, lse, delta)))
    for got, want in ((dk, want_dk), (dv, want_dv), (plain[0].numpy(), want_dk),
                      (plain[1].numpy(), want_dv)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max(), rtol=RTOL)


@pytest.mark.parametrize("b,n,d", [(1, 131, 8), (1, 97, 16)])
def test_model_stays_finite_where_lse_is_below_minus_88_at_a_padded_n(b, n, d):
    # the last tile's zero-filled queries have lse 0 and P = 2^0 = 1 there,
    # and the select sets it to 0; a live query's exponent, one FFMA of s
    # and -lse log2 e, stays finite where exp(-lse) alone would overflow
    q, k, v, do = _inputs(b, n, d, shift=True)
    lse, delta, want_dk, want_dv = _jax_dkv(q, k, v, do)
    assert lse.max() < -88
    dk, dv, stores = _model_dkv_small(q, k, v, do, lse, delta)
    assert (stores == 1).all()
    for got, want in ((dk, want_dk), (dv, want_dv)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=ATOL * np.abs(want).max(), rtol=RTOL)


@pytest.mark.parametrize("d", [8, 16])
def test_queries_past_n_add_nothing_by_the_zero_fill_and_by_the_select(d):
    # two guards keep a query past N out of dK and dV: the ring's zero-filled
    # Q and dO rows (P = 2^0 = 1 there, times a zero dO and a zero q) and the
    # select of P = 0 on the ragged tile. Either alone gives the same dK and
    # dV; with garbage in the tail only the select does (its P overflows)
    q, k, v, do = _inputs(1, 131, d)
    lse, delta, want_dk, want_dv = _jax_dkv(q, k, v, do)
    dk, dv, _ = _model_dkv_small(q, k, v, do, lse, delta)
    for mask, tail in ((False, 0.0), (True, 300.0)):
        got_dk, got_dv, _ = _model_dkv_small(q, k, v, do, lse, delta, mask=mask, tail=tail)
        np.testing.assert_array_equal(got_dk, dk)
        np.testing.assert_array_equal(got_dv, dv)
    got_dk, got_dv, _ = _model_dkv_small(q, k, v, do, lse, delta, mask=False, tail=300.0)
    assert not (np.isfinite(got_dk).all() and np.allclose(
        got_dk, want_dk, atol=ATOL * np.abs(want_dk).max(), rtol=RTOL))
