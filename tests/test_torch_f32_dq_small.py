"""The f32 dQ kernel at head dims 8 and 16 (B2a at f32,
``flash_bwd_dq_f32_small`` in ``csrc/flash_attention_bwd_f32.cu``): its block
against the CUDA source's constants, the dispatch and phase 1's instances,
its thread map, the banks of a warp's shared reads, and a numpy model of its
loop, lane by lane, against the JAX package's Pallas backward at f32.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
``flash_bwd_dq_plain``. The model follows the source: each thread's query
rows (q, dO, -lse log2 e and D in registers, zeros past N), the two-slot ring
of 64-key tiles (which slot each tile lands in and when, K and V rows past N
zero-filled), each lane's keys kg + 8 j and its partial dQ over them in the
kernel's order, the exponent as one FFMA into ``ex2``, the select on the
ragged last tile, the xor-shuffle butterfly over the row group's 8 lanes, and
the lanes' split of the stores. Bounds of the JAX comparison: atol 2e-4 of
dQ's max |value|, rtol 1e-3 (the f32 models' of the other d 8/16 kernels).
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

RNG = np.random.default_rng(47)
SOURCE = (build.CSRC / "flash_attention_bwd_f32.cu").read_text()
LOG2E = np.float32(1.4426950408889634)
ATOL, RTOL = 2e-4, 1e-3


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _rule(name: str) -> dict:
    """{head dim: value} of the source's ``constexpr int name<D>()`` for d 8
    and 16: its body is ``D == 8 ? a : b``."""
    body = re.search(rf"constexpr int {name}\(\) \{{\s*return ([^;]+);", SOURCE).group(1)
    m = re.fullmatch(r"D == 8 \? (\d+) : (\d+)", body)
    return {8: int(m.group(1)), 16: int(m.group(2))}


def _block(d: int) -> dict:
    """The kernel's block at head dim d, from the source: BQ query rows, TM a
    thread, 64-key tiles, TN keys of a tile a thread."""
    threads, groups = _constant("kThreadsBwd"), _constant("kKeyGroups")
    bq, bk = _rule("dq_small_rows")[d], _constant("kTileBwd")
    r = threads // groups
    return {"threads": threads, "groups": groups, "r": r, "bq": bq, "tm": bq // r, "bk": bk,
            "tn": bk // groups, "blocks_per_sm": _constant("kDqSmallBlocksPerSM")}


# ------------------------------------------------------------ the block and the dispatch


def test_block_constants_match_the_plan_and_the_source():
    # BQ and TM by head dim (64 and 4 at d 8, 32 and 2 at d 16), 128 threads
    # in row groups of 8 lanes, 64-key tiles, as the CUDA source has them (it
    # is compiled only on the card) and the launch plan reads them
    assert {d: _block(d)["bq"] for d in (8, 16)} == fa.F32_BWD_SMALL_QUERY_ROWS == {8: 64, 16: 32}
    assert {d: _block(d)["tm"] for d in (8, 16)} == {8: 4, 16: 2}
    assert _constant("kThreadsBwd") == 128 and _constant("kKeyGroups") == 8
    assert _constant("kTileBwd") == fa.KERNEL_TILE == 64
    assert {d: _block(d)["tn"] for d in (8, 16)} == {8: 8, 16: 8}
    for d in (8, 16):
        assert fa.f32_bwd_launch_plan(1, 1, d, "dq")["tile"] == _block(d)["bk"]


@pytest.mark.parametrize("d", [8, 16])
def test_blocks_fit_an_sm(d):
    # two ring slots of a K and a V tile (rows padded by 16 bytes), 1 KB
    # reserved a block, within the H100's 228 KB; the 64 K registers of an SM
    # leave each thread its q and dO rows and dQ accumulator (3 TM d floats,
    # 96) and at least 64 more
    s = _block(d)
    smem = 4 * 2 * 2 * s["bk"] * (d + 4)
    assert smem == {8: 12288, 16: 20480}[d]
    assert s["blocks_per_sm"] == 3 and s["blocks_per_sm"] * (smem + 1024) <= 228 * 1024
    state = 3 * s["tm"] * d
    assert state == 96 and 65536 // (s["blocks_per_sm"] * s["threads"]) >= state + 64
    # whole 16-byte chunks of a tile for the stager's threads
    assert (s["bk"] * d // 4) % s["threads"] == 0


def test_the_kernel_bounds_its_launch_by_its_blocks_an_sm():
    assert re.search(r"__launch_bounds__\(kThreadsBwd, kDqSmallBlocksPerSM\)\s*"
                     r"flash_bwd_dq_f32_small", SOURCE)
    assert re.search(r"allow_smem\(flash_bwd_dq_f32_small<D>, T::kBytes", SOURCE)
    assert re.search(r"static_assert\(kDqSmallBlocksPerSM \* \(kBytes \+ 1024\) <= 228 \* 1024",
                     SOURCE)


def _entry(name: str) -> str:
    start = SOURCE.index(f'extern "C" int {name}')
    end = SOURCE.find('extern "C"', start + 1)
    return SOURCE[start:end if end > 0 else None]


def test_dispatch_takes_the_small_kernel_at_d_8_and_16_and_the_first_design_is_gone():
    entry = _entry("frn_flash_bwd_dq_f32")
    assert {int(d) for d in re.findall(r"case (\d+): return launch_dq_small<\1>", entry)} == {
        8, 16}
    assert {int(d) for d in re.findall(r"case (\d+): return launch_dq_tiled<\1>", entry)} == {
        32, 64}
    for d in (8, 16):
        assert fa.f32_bwd_launch_plan(2, 19200, d, "dq")["kernel"] == "flash_bwd_dq_f32_small"
        assert ("flash_bwd_dq_f32_small", d) in chip_smoke.PATH_INSTANCES["flash_attention_bwd_f32"]
        assert ("flash_bwd_dq_f32", d) not in chip_smoke.PATH_INSTANCES["flash_attention_bwd_f32"]
    # the first design and what only it used are gone, from the source and
    # from the shared header (load_rows_f32 copied its unpadded tiles)
    header = (build.CSRC / "flash_sm90.cuh").read_text()
    for gone in (r"flash_bwd_dq_f32[<(]", r"dq_tile<", r"launch_dq<", r"load_row<",
                 r"store_row<", r"tile_chunk<", r"dot4\(", r"kGroup\b", r"load_rows_f32"):
        assert not re.search(rf"\b{gone}", SOURCE) and not re.search(rf"\b{gone}", header)


@pytest.mark.parametrize("d", [8, 16])
def test_the_launch_plan_blocks_at_the_path_shapes(d):
    # the depth-18 f32 train path's launches of the small kernel: 600 blocks
    # at stage 1 (2, 19,200, 8), 300 at stage 2 (2, 4,800, 16), 356 at DDD17
    # (4, 5,655, 8), where the first design's 128-row blocks gave 300, 76, 180
    shapes = {8: [((2, 19200, 8), 600), ((4, 5655, 8), 356)], 16: [((2, 4800, 16), 300)]}[d]
    for shape, blocks in shapes:
        assert fa.f32_bwd_launch_plan(*shape, "dq") == {
            "kernel": "flash_bwd_dq_f32_small", "rows": _block(d)["bq"], "tile": 64,
            "blocks": blocks}
        assert chip_smoke.depth18_blocks("flash_bwd_dq_f32", *shape) == blocks
    bq = _block(d)["bq"]
    for n in (1, bq, bq + 1, 2 * bq + 1):
        assert fa.f32_bwd_launch_plan(3, n, d, "dq")["blocks"] == 3 * -(-n // bq)


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
    assert chip_smoke.kernel_instances(_ptxas_log(every))[("flash_bwd_dq_f32_small", d)] == (
        160, 0, 0)
    chip_smoke.check_path_instances("flash_attention_bwd_f32", _ptxas_log(every))
    assert f"flash_bwd_dq_f32_small<{d}>: 160 registers" in capsys.readouterr().out
    spilled = {**every, ("flash_bwd_dq_f32_small", d): (168, 8)}
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention_bwd_f32", _ptxas_log(spilled))
    missing = {k: v for k, v in every.items() if k != ("flash_bwd_dq_f32_small", d)}
    with pytest.raises(SystemExit):
        chip_smoke.check_path_instances("flash_attention_bwd_f32", _ptxas_log(missing))


# ------------------------------------------------------------ the thread map


def _small_map(d: int):
    """The kernel's map, as ``flash_bwd_dq_f32_small`` computes it from
    threadIdx.x: (query rows of the block, keys of a tile) of each thread,
    (128, TM) and (128, TN), and each thread's row group and lane kg."""
    s = _block(d)
    t = np.arange(s["threads"])
    kg, rg = t % s["groups"], t // s["groups"]
    rows = rg[:, None] + s["r"] * np.arange(s["tm"])[None, :]
    keys = kg[:, None] + s["groups"] * np.arange(s["tn"])[None, :]
    return rows, keys, rg, kg


def _stores(d: int):
    """(thread, query row of the block, float4 column) of every store: float4
    u of row i by lane (i C + u) % 8."""
    s = _block(d)
    rows, _, _, kg = _small_map(d)
    c = d // 4
    return [(t, rows[t, i], u) for t in range(s["threads"]) for i in range(s["tm"])
            for u in range(c) if (i * c + u) % s["groups"] == kg[t]]


@pytest.mark.parametrize("d", [8, 16])
def test_thread_map_covers_each_pair_of_a_tile_once_and_sums_a_row_over_its_8_lanes(d):
    # every (query row, key) pair of a block and a key tile belongs to one
    # thread; the lanes that hold partial dQ of a query row are the 8 of one
    # row group, neighbours in one warp, and the xor butterfly (offsets 1, 2,
    # 4) pairs each lane only with lanes of the same rows, so that after its
    # three rounds every lane holds the sum over exactly those 8
    s = _block(d)
    rows, keys, _, _ = _small_map(d)
    cells = np.zeros((s["bq"], s["bk"]), int)
    for t in range(s["threads"]):
        cells[np.ix_(rows[t], keys[t])] += 1
    assert (cells == 1).all()
    lanes = np.arange(s["threads"])
    reach = [{t} for t in lanes]
    for off in (1, 2, 4):
        partner = lanes ^ off
        assert (partner // 32 == lanes // 32).all() and (rows[partner] == rows).all()
        reach = [reach[t] | reach[partner[t]] for t in lanes]
    for r in range(s["bq"]):
        holders = {t for t in lanes if r in rows[t]}
        assert len(holders) == 8 and len({t // 32 for t in holders}) == 1
        assert all(reach[t] == holders for t in holders)
    # each float4 of a row's dQ is stored once, by a lane of its group; the 8
    # lanes of a group share the stores of its rows evenly
    stored = {}
    for t, row, col in _stores(d):
        assert row in rows[t]
        stored[row, col] = stored.get((row, col), 0) + 1
    assert stored == {(r, c): 1 for r in range(s["bq"]) for c in range(d // 4)}
    per_lane = np.bincount([t for t, _, _ in _stores(d)], minlength=s["threads"])
    assert (per_lane == s["tm"] * d // 4 // 8).all()


@pytest.mark.parametrize("d", [8, 16])
def test_warp_reads_of_a_key_tile_fall_on_distinct_banks(d):
    # at each step the 32 lanes of a warp (4 row groups x 8 lanes) read the
    # float4s of 8 distinct key rows of K and V (kg + 8 j); with rows padded
    # to d + 4 floats their 16-byte words fall on 8 disjoint groups of 4 banks
    # (unpadded, rows 0 and 4 collide at d 8): at d 8 lane kg starts on bank
    # 12 kg mod 32
    _, keys, _, kg = _small_map(d)
    for j in range(keys.shape[1]):
        cols = sorted(set(keys[:32, j]))
        assert len(cols) == 8
        for stride in (d + 4, d):
            starts = {(col * stride) % 32 for col in cols}
            banks = {(st + w) % 32 for st in starts for w in range(4)}
            assert (len(banks) == 32) == (stride == d + 4)
        if d == 8:
            assert [(keys[t, j] * 12) % 32 for t in range(8)] == [(12 * k) % 32 for k in kg[:8]]


# ------------------------------------------------------------ the model of the loop


def _model_dq_small(q, k, v, do, lse, delta, mask: bool = True, tail: float = 0.0):
    """dQ by ``flash_bwd_dq_f32_small``'s loop in numpy f32, every thread of
    every block at once: q and dO rows, -lse log2 e and D in registers (zeros
    past N), the two-slot ring of 64-key tiles (tile t + 1 staged into slot
    (t + 1) % 2 after the barrier of tile t, K and V rows past N zero-filled),
    each lane's keys kg + 8 j in order, s and dP summed over d in column
    order, P = 2^(s log2 e + (-lse log2 e)), dS = P (dP - D) set to 0 by a
    select for a key at or past N on the last, ragged tile (``mask``),
    dQ += dS k into the lane's partials; then the butterfly over the row
    group's lanes (xor 1, 2, 4) and each float4 stored by its lane, query rows
    past N nowhere. ``tail``: the value of the ring's K and V rows past N (the
    kernel zero-fills them). Returns (dQ over the blocks' rows, (B, blocks x
    BQ, d): NaN where nothing was stored; the count of stores of each
    value)."""
    b, n, d = q.shape
    s = _block(d)
    bq, bk, tn = s["bq"], s["bk"], s["tn"]
    rows, keys, _, _ = _small_map(d)
    blocks, tiles = -(-n // bq), -(-n // bk)
    qrow = np.arange(blocks)[:, None, None] * bq + rows[None]  # (blocks, threads, TM)
    live = qrow < n
    lanes = np.arange(s["threads"])
    out = np.full((b, blocks * bq, d), np.nan, np.float32)
    stores = np.zeros(out.shape, int)
    zero = np.float32(0)
    for bi in range(b):
        rc = np.minimum(qrow, n - 1)
        qr = np.where(live[..., None], q[bi][rc], zero)
        dor = np.where(live[..., None], do[bi][rc], zero)
        nlb = np.where(live, -(lse[bi][rc] * LOG2E), zero)
        dl = np.where(live, delta[bi][rc], zero)
        acc = np.zeros_like(qr)
        ring = np.full((2, 2, bk, d), np.nan, np.float32)  # slot, (K, V), row, column

        def stage(t):
            r = t * bk + np.arange(bk)
            ok = r < n
            kc = np.minimum(r, n - 1)
            ring[t % 2, 0] = np.where(ok[:, None], k[bi, kc], np.float32(tail))
            ring[t % 2, 1] = np.where(ok[:, None], v[bi, kc], np.float32(tail))

        stage(0)
        for t in range(tiles):
            slot = t % 2
            if t + 1 < tiles:
                stage(t + 1)
            valid = n - t * bk
            ragged = n % bk != 0 and t == tiles - 1
            kt, vt = ring[slot, 0], ring[slot, 1]
            for j in range(tn):
                col = keys[:, j]  # (threads,)
                kj, vj = kt[col][None, :, None, :], vt[col][None, :, None, :]
                sc = np.zeros(qr.shape[:3], np.float32)
                dp = np.zeros(qr.shape[:3], np.float32)
                with np.errstate(over="ignore", invalid="ignore"):
                    for c in range(d):
                        sc = sc + qr[..., c] * kj[..., c]
                        dp = dp + dor[..., c] * vj[..., c]
                    p = np.exp2(sc * LOG2E + nlb).astype(np.float32)
                    ds = p * (dp - dl)
                if mask and ragged:
                    ds = np.where((col >= valid)[None, :, None], zero, ds)
                with np.errstate(invalid="ignore", over="ignore"):
                    acc = acc + ds[..., None] * kj
        with np.errstate(over="ignore", invalid="ignore"):
            for off in (1, 2, 4):  # acc[i] += shfl_xor(acc[i], off)
                acc = acc + acc[:, lanes ^ off]
        for th, row, col in _stores(d):
            i = list(rows[th]).index(row)
            r = qrow[:, th, i]
            ok = r < n
            out[bi, r[ok], 4 * col:4 * col + 4] = acc[ok, th, i, 4 * col:4 * col + 4]
            stores[bi, r[ok], 4 * col:4 * col + 4] += 1
    return out, stores


def _jax_dq(q, k, v, do, block: int = 128):
    """(lse, D, dQ) of the JAX package's Pallas kernels at f32, in interpret
    mode, with blocks of ``block`` rows (N padded to a whole block)."""
    o, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block,
                            block_k=block, interpret=True, return_lse=True)
    dq, _, _ = _flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                               jnp.asarray(do), block_q=block, block_k=block, interpret=True)
    o, lse = np.asarray(o), np.asarray(lse).reshape(q.shape[:2])
    delta = (do * o).sum(axis=2, dtype=np.float32)
    return lse, delta, np.asarray(dq)


def _inputs(b, n, d, shift=False):
    """Seeded q, k, v, dO; with ``shift``, scores near -121 (column 0 of q
    and k 11 and -11), so that every lse is below -88."""
    q, k, v, do = (RNG.normal(0, 0.5 if shift else 1.0, (b, n, d)).astype(np.float32)
                   for _ in range(4))
    if shift:
        q[..., 0], k[..., 0] = 11.0, -11.0
    return q, k, v, do


@pytest.mark.parametrize("b,n,d", [
    (1, 64, 8),  # one whole block and one whole key tile
    (1, 131, 8),  # a ragged third block and a ragged third tile (3 keys)
    (1, 65, 8),  # one query row past a whole block (BQ 64) and a key past a tile
    (1, 200, 8),  # 4 tiles through the ring, the last ragged
    (2, 97, 16),  # a ragged fourth block (BQ 32) and a ragged second tile
    (1, 33, 16),  # one query row past a whole block
    (1, 160, 16),  # five whole blocks, a ragged third tile
])
def test_model_matches_the_pallas_backward_at_f32(b, n, d):
    # the kernel's loop, lane by lane, ragged tails and select included,
    # against the JAX package's Pallas dQ at f32 (interpret mode), every
    # output value stored once; and the port's plain version, which the card
    # holds the kernel against, against the same
    q, k, v, do = _inputs(b, n, d)
    lse, delta, want = _jax_dq(q, k, v, do)
    got, stores = _model_dq_small(q, k, v, do, lse, delta)
    assert (stores[:, :n] == 1).all()
    plain = fa.flash_bwd_dq_plain(*(torch.tensor(x) for x in (q, k, v, do, lse, delta)))
    for x in (got[:, :n], plain.numpy()):
        assert np.isfinite(x).all()
        np.testing.assert_allclose(x, want, atol=ATOL * np.abs(want).max(), rtol=RTOL)


def _dense_dq(q, k, v, do, lse, delta):
    """dQ = (P * (dO V^T - D)) K in float64, P = exp(Q K^T - lse), from the
    same lse and D: the dense VJP of the function."""
    q, k, v, do = (x.astype(np.float64) for x in (q, k, v, do))
    p = np.exp(q @ k.transpose(0, 2, 1) - lse[..., None].astype(np.float64))
    return (p * (do @ v.transpose(0, 2, 1) - delta[..., None].astype(np.float64))) @ k


@pytest.mark.parametrize("b,n,d", [(1, 131, 8), (1, 97, 16)])
def test_model_stays_finite_where_lse_is_below_minus_88_at_a_padded_n(b, n, d):
    # a key past N (zero-filled k and v) gives s = 0 and P = 2^(-lse log2 e),
    # inf where lse < -88: the select on the ragged tile sets its dS to 0, so
    # dQ stays finite; without it inf * 0 reaches the accumulator as NaN. A
    # live key's exponent, one FFMA of s and -lse log2 e, stays finite. The
    # JAX package's Pallas dQ has that NaN here (its padded keys are not
    # masked), so the model is held against the dense VJP in float64, at
    # chip_smoke's F32_TRAP_ATOL of dQ's max: column 0 of dQ sums terms of
    # size 11 |dS| that cancel
    q, k, v, do = _inputs(b, n, d, shift=True)
    lse, delta, _ = _jax_dq(q, k, v, do)
    assert lse.max() < -88
    want = _dense_dq(q, k, v, do, lse, delta)
    got, stores = _model_dq_small(q, k, v, do, lse, delta)
    assert (stores[:, :n] == 1).all() and np.isfinite(got[:, :n]).all()
    np.testing.assert_allclose(got[:, :n], want, atol=chip_smoke.F32_TRAP_ATOL * np.abs(want).max(),
                               rtol=RTOL)
    unmasked, _ = _model_dq_small(q, k, v, do, lse, delta, mask=False)
    assert np.isnan(unmasked[:, :n]).any()


@pytest.mark.parametrize("d", [8, 16])
def test_query_rows_past_n_store_nothing_and_keys_past_n_add_nothing(d):
    # the last block's rows past N are computed (zeros in, finite) and stored
    # nowhere: dQ's rows past N keep the NaN they started with; and with the
    # select a key past N adds nothing to dQ whatever the ring holds there
    # (garbage, 300, in its K and V rows), where without it the same garbage
    # shows in dQ
    n = {8: 70, 16: 45}[d]  # 58 and 19 rows past N in the last block
    q, k, v, do = _inputs(1, n, d)
    lse, delta, want = _jax_dq(q, k, v, do)
    got, stores = _model_dq_small(q, k, v, do, lse, delta)
    assert (stores[:, n:] == 0).all() and np.isnan(got[:, n:]).all()
    assert got.shape[1] - n == {8: 58, 16: 19}[d]
    garbage, _ = _model_dq_small(q, k, v, do, lse, delta, tail=300.0)
    np.testing.assert_array_equal(garbage[:, :n], got[:, :n])
    unmasked, _ = _model_dq_small(q, k, v, do, lse, delta, mask=False, tail=300.0)
    assert not (np.isfinite(unmasked[:, :n]).all() and np.allclose(
        unmasked[:, :n], want, atol=ATOL * np.abs(want).max(), rtol=RTOL))
