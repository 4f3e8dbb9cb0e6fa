"""The port's opt-in inference kernels' plain versions and wrappers vs the JAX package.

The bf16-exp forward (B3), the int8 forward in both modes (B4) and the fused
stem (B5): each plain version against the Pallas kernel in interpret mode on
the CPU, at f32 unless stated, with the JAX kernel's key tile where the result
depends on it. Tolerances: the flash forwards atol 2e-5 rtol 1e-4 (the JAX
forward tests'); the bf16-exp forward against the f32-exp one 2e-2 (JAX's
``test_flash_exp_bf16_close_to_f32``); int8_qk on the int8 grid against exact
attention atol 5e-5 rtol 1e-4 (JAX's); the stem at f32 1e-5 (JAX's stem test),
at bf16 1e-2 (both sum in f32 and round once, so at most a bf16 ulp apart).
"""

import importlib
import re
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from frn_tpu.ops.flash_attention import (
    _flash_forward,
    _flash_forward_int8,
    _reference_attention,
    quantized_attention_reference as j_quantized_reference,
)
from frn_tpu.ops.stem import pack_stem_weights as j_pack_stem_weights
from frn_tpu.ops.stem import stem_conv_bn_relu as j_stem
from frn_tpu_torch import build
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.ops import attention
from frn_tpu_torch.ops import flash_attention as fa
from frn_tpu_torch.ops import stem

RNG = np.random.default_rng(31)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several processes at once; torch's default of one
    intra-op thread per core in each of them oversubscribes the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, n, d)).astype(np.float32) for _ in range(3)]


def _t(*xs):
    return [torch.tensor(x) for x in xs]


# ------------------------------------------------------------ B3: bf16-exp forward


# block 64 is KERNEL_TILE, the Hopper kernel's running-max step, at the
# kernel's block edges: one partial key tile, an exact fit, one ragged row
@pytest.mark.parametrize("b,n,d,block", [(1, 100, 32, 128), (2, 330, 32, 128), (1, 260, 64, 256),
                                         (2, 131, 16, 64), (1, 200, 8, 64), (2, 40, 8, 64),
                                         (2, 40, 16, 64), (2, 40, 32, 64), (2, 40, 64, 64),
                                         (2, 128, 32, 64), (2, 129, 32, 64)])
def test_bf16exp_plain_matches_pallas_kernel(b, n, d, block):
    q, k, v = _inputs(b, n, d, seed=n + d)
    want = np.asarray(_flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                                     block_k=block, interpret=True, exp_bf16=True))
    got = fa.flash_attention_bf16exp_plain(*_t(q, k, v), block_k=block).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_bf16exp_plain_close_to_f32_exp():
    q, k, v = _t(*_inputs(2, 300, 32, seed=44))
    np.testing.assert_allclose(fa.flash_attention_bf16exp_plain(q, k, v).numpy(),
                               fa.flash_attention_plain(q, k, v).numpy(), atol=2e-2, rtol=2e-2)


def test_bf16exp_plain_rounds_the_weights_to_bf16_for_bf16_values():
    # with bf16 v (the kernel's input) the weights are bf16(exp(bf16(s - m))):
    # a one-tile plain run equals the dense formula with those weights
    q, k, v = _t(*_inputs(1, 64, 16, seed=3))
    vb = v.to(torch.bfloat16)
    s = q @ k.transpose(1, 2)
    x = (s - s.amax(dim=2, keepdim=True)).to(torch.bfloat16).float()
    p = torch.exp(x).to(torch.bfloat16).float()
    want = ((p @ vb.float()) / p.sum(dim=2, keepdim=True)).to(torch.bfloat16)
    got = fa.flash_attention_bf16exp_plain(q, k, vb, block_k=64)
    torch.testing.assert_close(got.float(), want.float(), atol=0, rtol=2 ** -7)  # one bf16 ulp


# ------------------------------------------------------------ B4: int8 forward


@pytest.mark.parametrize("mode", fa.INT8_MODES)
@pytest.mark.parametrize("b,n,d,block", [
    pytest.param(2, 330, 32, 128, id="2-330-32"), pytest.param(1, 300, 16, 128, id="1-300-16"),
    pytest.param(2, 131, 64, 128, id="2-131-64"),
    # the kernels' key tile (KERNEL_TILE), on which mode 'int8' depends through
    # its running max: ragged last tiles at d 32 and 64, one partial tile, an
    # exact fit; at d 8 (the depth-18 paths' stage 1, where the plain version
    # is the card's oracle) a ragged odd N and an exact fit
    (2, 131, 32, 64), (1, 200, 64, 64), (2, 40, 32, 64), (1, 128, 64, 64), (2, 131, 8, 64),
    (1, 128, 8, 64)])
def test_int8_plain_matches_pallas_kernel(mode, b, n, d, block):
    q, k, v = _inputs(b, n, d, seed=56)
    want = np.asarray(_flash_forward_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mode=mode,
                                          block_q=128, block_k=block, interpret=True))
    got = fa.flash_attention_int8_plain(*_t(q, k, v), mode, block_k=block).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("mode", fa.INT8_MODES)
def test_int8_one_tile_matches_dense_simulations(mode):
    # one key tile covers all keys: the running max is the row max, and the
    # kernel's recurrence, the ported dense simulation and JAX's agree
    g, th, ph = _inputs(2, 200, 32, seed=55)
    want = np.asarray(j_quantized_reference(jnp.asarray(g), jnp.asarray(th), jnp.asarray(ph),
                                            mode=mode))
    ref = fa.quantized_attention_reference(*_t(g, th, ph), mode).numpy()
    got = fa.flash_attention_int8_plain(*_t(ph, th, g), mode, block_k=256).numpy()
    np.testing.assert_allclose(ref, want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_int8_qk_exact_when_inputs_representable():
    rng = np.random.default_rng(57)
    qi = rng.integers(-127, 128, (1, 260, 32)).astype(np.float32)
    ki = rng.integers(-127, 128, (1, 260, 32)).astype(np.float32)
    qi[0, 0, 0], ki[0, 0, 0] = 127.0, -127.0  # the dynamic scale reproduces the grid
    q, k = qi * 0.031, ki * 0.017
    v = rng.normal(0, 1, (1, 260, 32)).astype(np.float32)
    want = np.asarray(_reference_attention(jnp.asarray(v), jnp.asarray(k), jnp.asarray(q)))
    got = fa.flash_attention_int8_plain(*_t(q, k, v), "int8_qk").numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_quantize_int8_matches_the_jax_pre_pass():
    # 64 slices of 16,000 values: enough that a 127 / s one ulp off JAX's
    # division (torch's 127.0 / s is 127 * (1 / s)) moves some x * (127 / s)
    # across a rounding boundary
    x = np.random.default_rng(5).normal(0, 3, (64, 500, 32)).astype(np.float32)
    x[1] = 0.0  # an all-zero slice keeps the 1e-30 floor
    xf = jnp.asarray(x)
    s = jnp.maximum(jnp.max(jnp.abs(xf), axis=(1, 2), keepdims=True), 1e-30)
    want = np.asarray(jnp.round(xf * (127.0 / s)).astype(jnp.int8))
    got, scale = fa.quantize_int8(torch.tensor(x))
    assert got.dtype == torch.int8 and scale.shape == (64,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(s)[:, 0, 0])
    # the test's data does tell the two divisions apart
    st = torch.tensor(np.asarray(s))
    assert not torch.equal(torch.round(torch.tensor(x) * (127.0 / st)).to(torch.int8), got)


def test_int8_pv_key_order_follows_the_fragment_layouts():
    # the QK^T accumulator (mma.sync m16n8k32 C, and wgmma m64nNk32 s32 per
    # warp: the same layout) gives thread t keys 2t, 2t+1 of each 8-key tile;
    # the 8-bit A register a0 (a2) of mma.sync m16n8k32 and of wgmma
    # m64nNk32 (per warp, the same figure in the PTX ISA) holds slots 4t..4t+3
    # (16+4t..16+4t+3), byte j = slot + j; the kernel packs a0 from tiles 0 and
    # 1, a2 from tiles 2 and 3
    order = [None] * 32
    for t in range(4):
        for half in range(2):
            tiles = (2 * half, 2 * half + 1)
            keys = [8 * tile + 2 * t + e for tile in tiles for e in range(2)]
            for j, key in enumerate(keys):
                order[16 * half + 4 * t + j] = key
    assert order == fa._PV_KEY_ORDER
    assert sorted(order) == list(range(32))
    # the pre-pass kernel's inverse (csrc/flash_attention_int8.cu,
    # int8_quantize): the slot of key r of a 64-key tile
    for r in range(64):
        slot = 32 * (r >> 5) + 16 * ((r >> 4) & 1) + 4 * ((r >> 1) & 3) + 2 * ((r >> 3) & 1) + (r & 1)
        assert 32 * (slot // 32) + fa._PV_KEY_ORDER[slot % 32] == r
    src = (build.CSRC / "flash_attention_int8.cu").read_text()
    assert ("32 * (r >> 5) + 16 * ((r >> 4) & 1) + 4 * ((r >> 1) & 3) + 2 * ((r >> 3) & 1) + "
            "(r & 1)") in " ".join(src.split())


def test_int8_prepass_scratch_matches_the_source():
    # the wrapper allocates INT8_PARTIALS partial maxima per slice; the
    # pre-pass kernel writes and reads kPartials of them
    src = (build.CSRC / "flash_attention_int8.cu").read_text()
    assert re.search(r"constexpr int kPartials = (\d+);", src).group(1) == str(fa.INT8_PARTIALS)


# the kernel's integer and float bit tricks, emulated in torch through the
# same bit patterns (int32 <-> f32 views), over the whole range the kernel
# feeds them
_MAGIC = 0x4B400000  # the bits of 1.5 * 2^23
_MAGIC_F = 12582912.0


def test_int8_small_int_to_float_is_exact_below_2_22():
    # float(s) = bits(s + 0x4B400000) - 1.5 * 2^23 for every |s| < 2^22; the
    # scores are at most 64 * 127^2 = 1,032,256 in magnitude
    s = torch.arange(-(2 ** 22) + 1, 2 ** 22, dtype=torch.int32)
    got = (s + _MAGIC).view(torch.float32) - torch.tensor(_MAGIC_F, dtype=torch.float32)
    assert torch.equal(got, s.float())
    assert 64 * 127 ** 2 < 2 ** 22


def _round_by_magic(x: torch.Tensor) -> torch.Tensor:
    """fadd_rn(x, 1.5 * 2^23)'s bits less 0x4B400000: round(x), ties to even."""
    return (x + torch.tensor(_MAGIC_F, dtype=torch.float32)).view(torch.int32) - _MAGIC


def test_int8_round_by_magic_matches_torch_round_ties_included():
    # every f32 x in [1/4, 128) (the binades where the fraction bits round),
    # one bit pattern in 64 below 1/4, every tie k + 1/2 of [0, 127] and its
    # neighbours: round(x) ties to even, as torch.round
    lo, hi = int(np.float32(0.25).view(np.int32)), int(np.float32(128.0).view(np.int32))
    for start in range(lo, hi, 1 << 23):
        x = torch.arange(start, min(start + (1 << 23), hi), dtype=torch.int32).view(torch.float32)
        assert torch.equal(_round_by_magic(x), torch.round(x).to(torch.int32))
    x = torch.arange(0, lo, 64, dtype=torch.int32).view(torch.float32)
    assert torch.equal(_round_by_magic(x), torch.round(x).to(torch.int32))
    ties = torch.arange(0, 128, dtype=torch.float32) + 0.5
    near = torch.cat([ties, torch.nextafter(ties, torch.tensor(0.0)),
                      torch.nextafter(ties, torch.tensor(200.0))])
    assert torch.equal(_round_by_magic(near), torch.round(near).to(torch.int32))
    assert torch.equal(_round_by_magic(ties[:4]), torch.tensor([0, 2, 2, 4], dtype=torch.int32))


def test_int8_p_q_by_magic_matches_the_plain_rounding():
    # the kernel's p_q = bits(fadd_rn(127 p, 1.5 * 2^23)) less 0x4B400000
    # against the plain torch.round(p * 127.0), for p in [0, 1] and the few
    # ulps above 1 that an ex2 of a rounded exponent can give (the kernel
    # takes 127 p from its ex2, log2(127) added to the exponent); the low
    # byte of the bits is p_q, and a row's p_q sum is the sum of the bits
    # modulo 2^32 less 16 * 0x4B400000 (a thread's 16 keys of a row per tile)
    rng = np.random.default_rng(61)
    p = np.concatenate([rng.random(1 << 20, dtype=np.float32),
                        np.arange(128, dtype=np.float32) / 127.0,
                        (np.arange(127, dtype=np.float32) + 0.5) / 127.0,
                        1.0 + np.arange(16, dtype=np.float32) * np.float32(2 ** -23)])
    p = torch.tensor(p)
    x = p * 127.0
    bits = _round_by_magic(x) + _MAGIC
    want = torch.round(x)
    assert torch.equal((bits - _MAGIC).float(), want) and int(want.max()) == 127
    assert torch.equal(bits & 0xFF, want.to(torch.int32))
    rows = bits[: (bits.numel() // 16) * 16].view(-1, 16).to(torch.int64)
    sums = (rows.sum(dim=1) - 16 * _MAGIC) & 0xFFFFFFFF
    assert torch.equal(sums, want[: rows.numel()].view(-1, 16).to(torch.int64).sum(dim=1))


def test_int8_row_max_on_integer_scores():
    # c > 0 and rounding is monotone: c * float(max(s)) is max(c * float(s))
    # bitwise, so the kernel converts one integer max per row
    rng = np.random.default_rng(62)
    s = torch.tensor(rng.integers(-64 * 127 ** 2, 64 * 127 ** 2 + 1, (4096, 64)), dtype=torch.int32)
    c = torch.tensor(np.exp(rng.uniform(-60, 10, (4096, 1))).astype(np.float32))
    want = (s.float() * c).amax(dim=1)
    got = c[:, 0] * s.amax(dim=1).float()
    assert torch.equal(got, want)


def test_int8_v_layout_transposes_orders_and_pads():
    vi = torch.tensor(RNG.integers(-127, 128, (2, 100, 16)), dtype=torch.int8)
    vt = fa.int8_v_layout(vi)
    assert vt.shape == (2, 16, 128) and vt.is_contiguous()
    for slot in range(128):
        key = 32 * (slot // 32) + fa._PV_KEY_ORDER[slot % 32]
        want = vi[:, key, :] if key < 100 else torch.zeros((2, 16), dtype=torch.int8)
        torch.testing.assert_close(vt[:, :, slot], want, atol=0, rtol=0)
    # PV contracts over keys, so the reordered product equals the plain one
    p = torch.tensor(RNG.integers(0, 128, (2, 7, 100)), dtype=torch.float32)
    p_slots = torch.nn.functional.pad(p, (0, 28))[..., [32 * (s // 32) + fa._PV_KEY_ORDER[s % 32]
                                                        for s in range(128)]]
    torch.testing.assert_close(p_slots @ vt.float().transpose(1, 2), p @ vi.float(), atol=0, rtol=0)


def test_int8_mode_is_checked():
    q = torch.zeros((1, 64, 32))
    with pytest.raises(ValueError, match="mode"):
        fa.flash_attention_int8(q, q, q, "int4")
    with pytest.raises(ValueError, match="mode"):
        fa.flash_attention_int8_plain(q, q, q, "fp8")


# ------------------------------------------------------------ B5: stem


def _oracle_inputs(shape, f, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, 0.1, (7, 7, shape[-1], f)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, f).astype(np.float32)
    bias = rng.normal(0, 0.2, f).astype(np.float32)
    return x, w, scale, bias


def _port_stem(x, w, scale, bias, dtype=torch.float32):
    """The port's layouts: x NHWC -> channels_last NCHW, w HWIO -> (F, C, 7, 7)."""
    xt = torch.tensor(x).to(dtype).permute(0, 3, 1, 2)
    wt = torch.tensor(w).permute(3, 2, 0, 1).to(dtype)
    out = stem.stem_conv_bn_relu(xt, wt, torch.tensor(scale), torch.tensor(bias))
    return out.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("shape,f", [((2, 32, 48, 3), 64), ((1, 26, 34, 5), 32), ((1, 64, 96, 3), 8)])
def test_stem_plain_matches_pallas_kernel(shape, f):
    x, w, scale, bias = _oracle_inputs(shape, f)
    want = np.asarray(j_stem(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
                             interpret=True))
    got = _port_stem(x, w, scale, bias)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_stem_plain_bf16_matches_pallas_kernel():
    x, w, scale, bias = _oracle_inputs((1, 16, 24, 3), 16, seed=1)
    xb, wb = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (x, w))
    want = np.asarray(j_stem(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(wb, jnp.bfloat16),
                             jnp.asarray(scale), jnp.asarray(bias), interpret=True)).astype(np.float32)
    got = _port_stem(xb, wb, scale, bias, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def stem_weight_rows(c: int) -> int:
    """Rows of the stem kernel's K order at C input channels: the 7 runs of 8C
    slots, padded to whole 16-row steps of its products (176 at C 3, 288 at
    C 5; ``weight_rows`` in csrc/stem.cu)."""
    return -(-56 * c // 16) * 16


def pack_stem_weights(w: torch.Tensor) -> torch.Tensor:
    """(F, C, 7, 7) conv weights -> (KP, F) in the stem kernel's K order, as
    each of its blocks packs them in shared memory (csrc/stem.cu).

    Row kh * 8C + i holds tap o = i - 1 = kw * C + c of row tap kh: the JAX
    kernel's slot order (``frn_tpu/ops/stem.py::pack_stem_weights``) with each
    run of 8C slots moved one slot on, so that slot 0 and slots past 7C carry
    zero weight (the kernel's A pairs then sit on aligned words); rows past
    56C are zero. Contiguous, in w's dtype."""
    f, c = w.shape[:2]
    runs = w.permute(2, 3, 1, 0).reshape(7, 7 * c, f)  # [kh][kw * C + c][f]
    runs = F.pad(runs, (0, 0, 1, c - 1))  # one zero slot before the taps, C - 1 after
    return F.pad(runs.reshape(56 * c, f), (0, 0, 0, stem_weight_rows(c) - 56 * c)).contiguous()


@pytest.mark.parametrize("c", stem.STEM_CHANNELS)
def test_pack_stem_weights_is_the_tpu_slot_order_moved_one_slot(c):
    # the JAX kernel's runs of 8C slots (tap kw * C + c at slot kw * C + c,
    # zeros at 7C..8C-1), each moved one slot on: zero at slot 0, the taps at
    # 1..7C; the K padding past 56C zero in both
    _, w, _, _ = _oracle_inputs((1, 8, 8, c), 64, seed=c)
    w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(j_pack_stem_weights(jnp.asarray(w, jnp.bfloat16)).astype(jnp.float32))
    got = pack_stem_weights(torch.tensor(w).permute(3, 2, 0, 1).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    got = got.float().numpy()
    kp = stem_weight_rows(c)
    assert got.shape == want.shape == (kp, 64) and kp % 16 == 0 and kp >= 56 * c
    runs, want_runs = got[:56 * c].reshape(7, 8 * c, 64), want[:56 * c].reshape(7, 8 * c, 64)
    np.testing.assert_array_equal(runs[:, 1:], want_runs[:, :-1])
    assert not runs[:, 0].any() and not want_runs[:, -1].any()
    assert not got[56 * c:].any() and not want[56 * c:].any()


def _k_order_model(x, w, scale, bias):
    """The kernel's product in torch: each output pixel's A row is, for each
    row tap kh, the run of 8C elements of the padded input row (3 zero pixels
    each side, shifted one element right) from element 2 ow C on; A times the
    packed weights, then the affine and the ReLU."""
    b, c, h, wd = x.shape
    rows = F.pad(x.permute(0, 2, 3, 1), (0, 0, 3, 3, 3, 3)).reshape(b, h + 6, (wd + 6) * c)
    rows = F.pad(rows, (1, 0))  # the one-element shift
    oh, ow = h // 2, wd // 2
    runs = [rows[:, kh:kh + 2 * oh:2].unfold(2, 8 * c, 2 * c)[:, :, :ow] for kh in range(7)]
    a = torch.cat(runs, dim=3)  # (B, OH, OW, 56C)
    wp = pack_stem_weights(w)
    y = a @ wp[:56 * c] * scale + bias
    assert not wp[56 * c:].any()
    return torch.relu(y).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", [(2, 10, 26, 3), (1, 14, 18, 5), (1, 6, 10, 3), (2, 8, 6, 5)])
def test_stem_k_order_model_matches_plain(shape):
    # odd W/2 (13, 9, 5, 3) included: the kernel's K order, gathered as it
    # gathers it, is the plain conv's function at f32
    x, w, scale, bias = (torch.tensor(a) for a in _oracle_inputs(shape, 64, seed=shape[1]))
    x, w = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    want = stem.stem_conv_bn_relu_plain(x, w, scale, bias)
    got = _k_order_model(x, w, scale, bias)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_stem_checks_shapes():
    x = torch.zeros((1, 3, 32, 48))
    w, s = torch.zeros((64, 3, 7, 7)), torch.ones(64)
    with pytest.raises(ValueError, match="even"):
        stem.stem_conv_bn_relu(torch.zeros((1, 3, 31, 48)), w, s, s)
    with pytest.raises(ValueError, match=r"\(F, C, 7, 7\)"):
        stem.stem_conv_bn_relu(x, torch.zeros((64, 5, 7, 7)), s, s)
    with pytest.raises(ValueError, match="scale"):
        stem.stem_conv_bn_relu(x, w, torch.ones(63), s)


# ------------------------------------------------------------ wrappers on the CPU and the card


def test_cpu_wrappers_run_plain_versions_without_launch_or_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel build was started")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    mod_fa, mod_stem = importlib.reload(fa), importlib.reload(stem)
    q, k, v = _t(*_inputs(2, 150, 16, seed=8))
    counts = (mod_fa.flash_fwd_bf16exp_launches, mod_fa.flash_int8_qk_launches,
              mod_fa.flash_int8_launches, mod_fa.int8_qk_prepass_launches,
              mod_fa.int8_prepass_launches, mod_stem.stem_launches)
    torch.testing.assert_close(mod_fa.flash_attention_bf16exp(q, k, v),
                               mod_fa.flash_attention_bf16exp_plain(q, k, v), atol=0, rtol=0)
    for mode in mod_fa.INT8_MODES:
        torch.testing.assert_close(mod_fa.flash_attention_int8(q, k, v, mode),
                                   mod_fa.flash_attention_int8_plain(q, k, v, mode), atol=0, rtol=0)
        for got, want in zip(mod_fa.int8_prepass(q, k, v, mode),
                             mod_fa.int8_kernel_inputs(q, k, v, mode)):
            assert (got is None and want is None) or torch.equal(got, want)
    args = [torch.tensor(a) for a in _oracle_inputs((1, 16, 24, 5), 64)]
    x, w = args[0].permute(0, 3, 1, 2), args[1].permute(3, 2, 0, 1)
    torch.testing.assert_close(mod_stem.stem_conv_bn_relu(x, w, *args[2:]),
                               mod_stem.stem_conv_bn_relu_plain(x, w, *args[2:]), atol=0, rtol=0)
    assert counts == (mod_fa.flash_fwd_bf16exp_launches, mod_fa.flash_int8_qk_launches,
                      mod_fa.flash_int8_launches, mod_fa.int8_qk_prepass_launches,
                      mod_fa.int8_prepass_launches, mod_stem.stem_launches)
    assert mod_fa._lib is None and mod_fa._int8_lib is None and mod_stem._lib is None


@pytest.mark.parametrize("route", ["bf16exp", "int8_qk", "int8", "stem"])
def test_kernel_routes_refuse_inputs_that_need_a_gradient(monkeypatch, route):
    # on the card these kernels define no gradient: an input that requires
    # grad raises before any build or launch
    monkeypatch.setattr(fa, "_on_kernel_device", lambda x: True)
    monkeypatch.setattr(stem, "_on_kernel_device", lambda x: True)
    q = torch.zeros((1, 64, 32), dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros((1, 64, 32), dtype=torch.bfloat16)
    call = {"bf16exp": lambda: fa.flash_attention_bf16exp(q, k, k),
            "int8_qk": lambda: fa.flash_attention_int8(k, q, k, "int8_qk"),
            "int8": lambda: fa.flash_attention_int8(k, k, q, "int8"),
            "stem": lambda: stem.stem_conv_bn_relu(
                torch.zeros((1, 3, 16, 16), dtype=torch.bfloat16),
                torch.zeros((64, 3, 7, 7), dtype=torch.bfloat16, requires_grad=True),
                torch.ones(64), torch.zeros(64))}[route]
    with pytest.raises(RuntimeError, match="inference only"):
        call()


def test_stem_kernel_route_takes_channels_last_weights(monkeypatch):
    # the detector's conv1 weight is channels_last; the kernel reads torch's
    # (F, C, 7, 7) layout, so the wrapper hands it a contiguous copy
    launched = []
    monkeypatch.setattr(stem, "_on_kernel_device", lambda x: True)
    monkeypatch.setattr(stem, "_library", lambda: types.SimpleNamespace(frn_stem_conv_bn_relu=None))
    monkeypatch.setattr(stem, "_launch", lambda fn, x, *args: launched.append(args))
    x = torch.zeros((1, 3, 16, 16), dtype=torch.bfloat16).to(memory_format=torch.channels_last)
    w = torch.randn((64, 3, 7, 7)).to(torch.bfloat16).to(memory_format=torch.channels_last)
    out = stem.stem_conv_bn_relu(x, w, torch.ones(64), torch.zeros(64))
    assert out.shape == (1, 64, 8, 8) and len(launched) == 1


def test_kernel_route_precedence(monkeypatch):
    # on the kernels' route: quant, else exp_bf16, else the B1 forward (the
    # JAX package's order); below it, the exact dense route whatever the flags
    calls = []
    monkeypatch.setattr(attention, "flash_attention_int8",
                        lambda q, k, v, mode: calls.append(("int8", mode)) or v)
    monkeypatch.setattr(attention, "flash_attention_bf16exp",
                        lambda q, k, v: calls.append(("bf16exp",)) or v)
    monkeypatch.setattr(attention, "flash_attention", lambda q, k, v: calls.append(("b1",)) or v)
    g, th, ph = _t(*_inputs(1, 80, 16, seed=9))
    dense = attention.nonlocal_attention(g, th, ph, chunk=32)
    for quant, exp_bf16 in (("int8", True), ("int8_qk", False), (None, True), (None, False)):
        torch.testing.assert_close(
            attention.nonlocal_attention(g, th, ph, chunk=32, exp_bf16=exp_bf16, quant=quant),
            dense, atol=0, rtol=0)
    assert calls == []
    monkeypatch.setattr(attention, "_kernel_route", lambda x: True)
    for quant, exp_bf16 in (("int8", True), ("int8_qk", False), (None, True), (None, False)):
        attention.nonlocal_attention(g, th, ph, exp_bf16=exp_bf16, quant=quant)
    assert calls == [("int8", "int8"), ("int8", "int8_qk"), ("bf16exp",), ("b1",)]


def test_config_accepts_the_opt_in_flags():
    mc = tconfig.ModelConfig(stem_kernel=True, flash_exp_bf16=True, attention_quant="int8_qk",
                             fused_attention=True)
    assert (mc.stem_kernel, mc.flash_exp_bf16, mc.attention_quant, mc.fused_attention) == (
        True, True, "int8_qk", True)
    with pytest.raises(ValueError, match="attention_quant"):
        tconfig.ModelConfig(attention_quant="int4")
    assert tconfig.ModelConfig(fused_heads=True).fused_heads  # ported: no longer raises


def test_build_lists_the_new_sources():
    for name in ("flash_attention_int8", "stem"):
        assert name in build.SOURCES and (build.CSRC / f"{name}.cu").is_file()
